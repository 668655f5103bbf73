"""Drive the PyTorch/CUDA port's online grasp-detection frame on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the build time;
3. K1 (GPG panel-count scan) against its plain version on the three scans of
   one frame of the 18k-point synthetic tabletop (the benchmark scene of
   bench.py, rebuilt here), bucketed at cloud_pad_to=4096: exact equality
   on the active frames;
4. K2 (fused PointNet trunk) against its plain version at the detector's
   (B, N) = (64, 500) and the scorer benchmark's (512, 750), to
   |err| <= 1e-4 * (1 + |ref|); the golden checkpoint's frozen outputs are
   reproduced on the card through K2 to 1e-4;
5. the main path: GraspDetector.process_frame on a few frames with the
   golden 3-class checkpoint, DetectorConfig() defaults and
   cloud_pad_to=4096. The launch counters are zeroed just before and read
   just after: K1 must launch 3 times and K2 twice per frame. Scores must be
   finite, in [0, 1] and in descending ranked order, with n_valid > 0. The
   first frame is run again with both kernels swapped for their plain
   versions (same seed, so the same draws): candidates, counts and
   predictions must be equal and scores within 1e-4;
6. timings with CUDA events (warm, many launches) of each kernel alone (K1:
   the bare C launch on prepared arguments; its wrapper is timed apart), its
   plain version and, for K2, one PyTorch yardstick (three torch.matmul +
   max, TF32 off) that the port never calls; warm ms per frame. With
   ``--profile``, also a torch.profiler breakdown of a few warm frames.

TF32 is switched off for matmuls and cuDNN: the port keeps fp32 throughout.
The line before the last is a JSON object with one entry per kernel; the
last line is the contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense, no sparsity; NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K2_TOL = 1e-4


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def tabletop_scene():
    """bench.py's segmented tabletop: three boxes over ~0.6 m, 18k points."""
    rs = np.random.RandomState(0)
    objs = []
    for cx, cy in ((-0.25, -0.15), (0.2, 0.25), (0.05, -0.3)):
        n = 2000
        top = rs.rand(n, 3) * [0.06, 0.06, 0] + [cx, cy, 0.08]
        front = rs.rand(n, 3) * [0.06, 0, 0.06] + [cx, cy, 0.02]
        side = rs.rand(n, 3) * [0, 0.06, 0.06] + [cx + 0.06, cy, 0.02]
        objs.append(np.concatenate([top, front, side]).astype(np.float32))
    return np.concatenate(objs), np.array([1.0, 1.0, 1.2], np.float32)


def cuda_ms(torch, fn, iters, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_frames(torch, det, pts, cam, card, n=3):
    """torch.profiler over ``n`` warm frames: device time by kernel and by
    frame stage (the record_function labels of robot/node.py), and the
    device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(n):
            det.process_frame(pts, cam, seed=300 + s)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    # device activity = the events that ran on the card (kernels, copies,
    # memsets), not the host ops that launched them and not the frame.*
    # labels, which also appear as device-side ranges
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("frame.")]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy = total = 0.0
    end = -float("inf")
    for a, b in spans:                    # union of the device intervals
        total += b - a
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"profile ({n} frames, {card}): wall {wall_us / n / 1e3:.2f} ms "
          f"per frame, device busy {busy / n / 1e3:.3f} ms per frame "
          f"({100 * busy / wall_us:.1f}% busy; {len(spans) // n} device "
          f"events and {total / n / 1e3:.3f} ms of their summed time per "
          f"frame)")
    for e in sorted(prof.key_averages(), key=lambda e: e.key):
        if e.key.startswith("frame.") and e.cpu_time_total > 0:
            print(f"  stage {e.key}: host {e.cpu_time_total / n / 1e3:.2f} "
                  f"ms per frame")
    by_name = {}
    for e in dev_events:
        t, c = by_name.get(e.key, (0.0, 0))
        by_name[e.key] = (t + e.time_range.elapsed_us(), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for key, (t, c) in top[:15]:
        print(f"  device {t / n / 1e3:8.3f} ms/frame x{c // n:4d}  "
              f"{key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)", flush=True)

    # 1. device line
    card = device_line()
    print(f"card: {card}", flush=True)
    kind = torch.cuda.get_device_name(0)

    # 2. kernel build
    from pointnetgpd_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s)", flush=True)
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  ptxas {line.strip()}")

    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.robot.node import DetectorConfig, GraspDetector

    dev = torch.device("cuda")
    ckpt = os.path.join(HERE, "tests", "fixtures", "golden_pointnet_3class.npz")
    golden_io = np.load(os.path.join(HERE, "tests", "fixtures",
                                     "golden_io.npz"))
    scorer = GraspScorer.from_checkpoint(ckpt, device=dev, k=3)
    det = GraspDetector(scorer, config=DetectorConfig(cloud_pad_to=4096))
    pts, cam = tabletop_scene()

    # 3. K1 vs plain: record the three scans of one frame at main-path shapes
    rec = {"k1": [], "k2": []}
    launch1, launch2 = k1.GpgScanContext._launch, k2._launch

    def rec1(ctx, fx, sc, is_y):
        rec["k1"].append((ctx, fx.clone(), sc.clone(), is_y))
        return launch1(ctx, fx, sc, is_y)

    def rec2(x, folded):
        rec["k2"].append((x.clone(), tuple(t.detach().clone()
                                           for t in folded)))
        return launch2(x, folded)

    k1.GpgScanContext._launch, k2._launch = rec1, rec2
    try:
        det.process_frame(pts, cam, seed=0)
    finally:
        k1.GpgScanContext._launch, k2._launch = launch1, launch2
    if len(rec["k1"]) != 3 or len(rec["k2"]) != 2:
        fail(f"expected 3 K1 and 2 K2 launches per frame, recorded "
             f"{len(rec['k1'])} and {len(rec['k2'])}")
    ctx = rec["k1"][0][0]
    act = ctx.active
    n_act = int(act.sum())
    p_cloud = ctx.points.shape[0]
    p_real = int((ctx.points[:, 0] > -9.9e5).sum())   # sentinels excluded
    print(f"K1 inputs: F={ctx.f} frames ({n_act} active), P={p_cloud} "
          f"(bucket; {p_real} real points), shifts "
          f"{[r[2].shape[1] for r in rec['k1']]}",
          flush=True)
    k1_err = 0
    for _, fx, sc, is_y in rec["k1"]:
        got = launch1(ctx, fx, sc, is_y)
        want = k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)
        torch.cuda.synchronize()
        diff = (got[act] - want[act]).abs()
        err = int(diff.max()) if diff.numel() else 0
        k1_err = max(k1_err, err)
        print(f"K1 scan ns={sc.shape[1]} scan_is_y={is_y}: active-frame "
              f"counts {int(want[act].sum())}, max |kernel - plain| = {err}",
              flush=True)
        if err != 0:
            fail("K1 disagrees with its plain version on active frames")

    # 4. K2 vs plain
    torch.manual_seed(0)
    x_det, folded = rec["k2"][1]               # PointNetfeat trunk, (64, 500)
    x_big = torch.randn(512, 750, 3, device=dev) * 0.02
    k2_err = {}
    for name, x in (("64x500", x_det), ("512x750", x_big)):
        got = launch2(x, folded)
        want = k2.trunk_reference(x, folded)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bad = ((got - want).abs() > K2_TOL * (1 + want.abs())).sum()
        k2_err[name] = err
        print(f"K2 B,N={tuple(x.shape[:2])}: max |kernel - plain| = {err:.3e}"
              f" (tolerance 1e-4 * (1 + |plain|))", flush=True)
        if int(bad) or not torch.isfinite(got).all():
            fail(f"K2 disagrees with its plain version at {name}")
    with torch.no_grad():
        x_io = torch.from_numpy(golden_io["x"]).to(dev).transpose(1, 2)
        logp, trans = scorer.model(x_io.contiguous())
    e_logp = float(np.abs(logp.cpu().numpy() - golden_io["logp"]).max())
    e_trans = float(np.abs(trans.cpu().numpy() - golden_io["trans"]).max())
    print(f"golden checkpoint on the card: max |logp err| = {e_logp:.2e}, "
          f"max |trans err| = {e_trans:.2e} (atol 1e-4)", flush=True)
    if e_logp > 1e-4 or e_trans > 1e-4:
        fail("golden checkpoint outputs differ on the card")

    # 5. main path
    n_frames = 3
    k1.launches = 0
    k2.launches = 0
    outs = [det.process_frame(pts, cam, seed=s) for s in range(n_frames)]
    launches = {"gpg_counts": k1.launches, "pointnet_trunk": k2.launches}
    print(f"main path: {n_frames} frames, launches {launches}", flush=True)
    if launches["gpg_counts"] != 3 * n_frames:
        fail("K1 did not launch 3 times per frame")
    if launches["pointnet_trunk"] != 2 * n_frames:
        fail("K2 did not launch twice per frame")
    for s, out in enumerate(outs):
        sc_all = np.asarray(out["all_scores"])
        sc_rank = np.asarray(out["scores"])
        print(f"frame seed={s}: voxels {out['points'].shape[0]}, n_valid "
              f"{out['n_valid']}, ranked good {len(sc_rank)}, score range "
              f"[{sc_all.min() if sc_all.size else 'n/a'}, "
              f"{sc_all.max() if sc_all.size else 'n/a'}]", flush=True)
        if out["n_valid"] <= 0:
            fail("no valid candidate")
        if not (np.isfinite(sc_all).all() and (sc_all >= 0).all()
                and (sc_all <= 1).all()):
            fail("scores not finite in [0, 1]")
        if len(sc_rank) > 1 and not (np.diff(sc_rank) <= 0).all():
            fail("ranked scores not descending")

    # the first frame again through the plain versions of both kernels
    def plain1(ctx, fx, sc, is_y):
        return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)

    k1.GpgScanContext._launch, k2._launch = plain1, k2.trunk_reference
    try:
        plain = det.process_frame(pts, cam, seed=0)
    finally:
        k1.GpgScanContext._launch, k2._launch = launch1, launch2
    got = outs[0]
    if got["n_valid"] != plain["n_valid"]:
        fail(f"n_valid {got['n_valid']} on the main path, "
             f"{plain['n_valid']} on the plain route")
    e_frames = float(np.abs(got["all_frames"] - plain["all_frames"]).max())
    e_scores = float(np.abs(got["all_scores"] - plain["all_scores"]).max())
    print(f"main path vs plain route (seed=0): n_valid {got['n_valid']} vs "
          f"{plain['n_valid']}, pred equal "
          f"{np.array_equal(got['pred'], plain['pred'])}, counts equal "
          f"{np.array_equal(got['counts'], plain['counts'])}, max |frame "
          f"err| {e_frames:.2e} (1e-5), max |score err| {e_scores:.2e} "
          f"(1e-4), ranked {len(got['scores'])} vs {len(plain['scores'])}",
          flush=True)
    if (not np.array_equal(got["pred"], plain["pred"])
            or not np.array_equal(got["counts"], plain["counts"])
            or e_frames > 1e-5 or e_scores > 1e-4
            or len(got["scores"]) != len(plain["scores"])):
        fail("the main path disagrees with its plain route")

    # 6. timings
    timing = {}
    lib = _build.library()
    for idx, (_, fx, sc, is_y) in enumerate(rec["k1"]):
        # keep the output and the prepared tensors alive while timing
        out_k, args, keep = ctx.kernel_args(fx, sc, is_y)
        timing[f"k1_{idx}"] = cuda_ms(torch, lambda: _build.check(
            lib.gpg_counts_launch(*args), "gpg_counts_launch"), iters=50)
        timing[f"k1_wrap_{idx}"] = cuda_ms(torch, lambda: launch1(
            ctx, fx, sc, is_y), iters=50)
        timing[f"k1_plain_{idx}"] = cuda_ms(torch, lambda: (
            k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows, fx,
                                     sc, ctx.boxes, scan_is_y=is_y)),
            iters=2, warm=1)
    k1_ms = sum(timing[f"k1_{i}"] for i in range(3))
    k1_wrap = sum(timing[f"k1_wrap_{i}"] for i in range(3))
    k1_plain = sum(timing[f"k1_plain_{i}"] for i in range(3))
    # K1 bound: per scan, every (active frame, real cloud point) pair needs
    # three 3-term coordinate chains (18 flops) and the 16 slab compares of
    # the 4 boxes; bytes = real cloud + frames + counts. The sentinel tail
    # of the bucket is skipped by the kernel and needs no work.
    k1_ops = k1_bytes = 0
    for _, fx, sc, _ in rec["k1"]:
        ns = sc.shape[1]
        k1_ops += n_act * p_real * 34
        k1_bytes += p_real * 12 + ctx.f * (13 + ns) * 4 + ctx.f * ns * 16
    k1_bound = max(k1_ops / PEAK_FP32_FLOPS, k1_bytes / PEAK_BYTES) * 1e3
    k1_by = "operations" if k1_ops / PEAK_FP32_FLOPS > k1_bytes / PEAK_BYTES \
        else "bytes"

    w1, b1, w2, b2, w3, b3 = folded

    def library(x):
        h = torch.relu(torch.matmul(x, w1) + b1)
        h = torch.relu(torch.matmul(h, w2) + b2)
        return torch.amax(torch.matmul(h, w3) + b3, dim=1)

    for name, x in (("64x500", x_det), ("512x750", x_big)):
        timing[f"k2_{name}"] = cuda_ms(torch, lambda: launch2(x, folded),
                                       iters=50)
        timing[f"k2_plain_{name}"] = cuda_ms(
            torch, lambda: k2.trunk_reference(x, folded), iters=20)
        timing[f"k2_library_{name}"] = cuda_ms(torch, lambda: library(x),
                                               iters=20)
    b, n = x_det.shape[:2]
    k2_ops = 2.0 * b * n * (3 * 64 + 64 * 128 + 128 * 1024)
    k2_bytes = (b * n * 3 + 3 * 64 + 64 + 64 * 128 + 128 + 128 * 1024 + 1024
                + b * 1024) * 4
    k2_bound = max(k2_ops / PEAK_FP32_FLOPS, k2_bytes / PEAK_BYTES) * 1e3

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 5
    for s in range(n_timed):
        det.process_frame(pts, cam, seed=100 + s)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_timed * 1e3

    print(f"timings on {card}:", flush=True)
    for i, (_, _, sc, is_y) in enumerate(rec["k1"]):
        print(f"  K1 scan ns={sc.shape[1]}: kernel {timing[f'k1_{i}']:.4f} ms,"
              f" with wrapper {timing[f'k1_wrap_{i}']:.4f} ms, plain "
              f"{timing[f'k1_plain_{i}']:.3f} ms ({card})")
    print(f"  K1 per frame (3 scans): kernel {k1_ms:.4f} ms, wrapper "
          f"overhead {k1_wrap - k1_ms:.4f} ms, plain {k1_plain:.3f} ms, "
          f"bound {k1_bound:.5f} ms ({k1_by}; {k1_ops:.3e} ops, {k1_bytes} "
          f"bytes) ({card})")
    for name in ("64x500", "512x750"):
        print(f"  K2 {name}: kernel {timing[f'k2_{name}']:.4f} ms, plain "
              f"{timing[f'k2_plain_{name}']:.4f} ms, library (3 matmul + "
              f"max) {timing[f'k2_library_{name}']:.4f} ms ({card})")
    print(f"  K2 64x500 bound {k2_bound:.5f} ms (operations; "
          f"{k2_ops:.3e} flops) ({card})")
    print(f"  frame: {frame_ms:.2f} ms warm per process_frame "
          f"(host clock, {n_timed} frames) ({card})", flush=True)

    if "--profile" in sys.argv:
        profile_frames(torch, det, pts, cam, card)

    kernels = [
        {"name": "gpg_counts", "route": "cuda",
         "source": "pointnetgpd_tpu_torch/csrc/gpg_counts.cu",
         "replaces": "pointnetgpd_tpu/ops/gpg_counts_pallas.py:156",
         "launches": launches["gpg_counts"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "pointnet_trunk", "route": "cuda",
         "source": "pointnetgpd_tpu_torch/csrc/pointnet_trunk.cu",
         "replaces": "pointnetgpd_tpu/ops/pointnet_trunk_pallas.py:106",
         "launches": launches["pointnet_trunk"],
         "max_abs_err": k2_err["64x500"], "ms": timing["k2_64x500"],
         "plain_ms": timing["k2_plain_64x500"], "bound_ms": k2_bound,
         "bound_by": "operations",
         "library_ms": timing["k2_library_64x500"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
