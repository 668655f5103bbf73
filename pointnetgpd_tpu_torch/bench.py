"""Benchmark of the port: grasp candidates scored per second (750-point
clouds) on the GPU, with train samples/s, labeled grasps/s, the voxelizer's
distance pass and the online frame beside it.

Run:  python -m pointnetgpd_tpu_torch.bench                 (the GPU)
      BENCH_ALLOW_CPU=1 python -m pointnetgpd_tpu_torch.bench   (the CPU
      where no GPU answers; slow at these sizes)
      python -m pointnetgpd_tpu_torch.bench --device cpu    (the CPU always)

The counterpart of the repository's ``bench.py`` (the JAX package on a TPU):
the same families, sizes, scenes and key names, so that the two programs'
lines read side by side. Families, in order, each staged as it finishes:

1. the reference baseline (``bench_reference_torch``): per-candidate
   batch-size-1 torch CPU calls through the reference's own PointNetCls with
   host numpy cropping, where a reference checkout is present
   ($POINTNETGPD_REFERENCE, else ./reference); ``vs_baseline`` stays null
   unless this run measured it;
2. ``bench_device``: an 8192^3 fp32 ``torch.matmul`` (TF32 off) as the
   card's health anchor beside its fp32 bound; the headline,
   ``score_candidates_fused`` on 512 candidates x 750 points over a
   20,000-point scene (K2 twice a scene), and the same scene through
   ``GraspScorer.as_dtype(torch.bfloat16)``; the fused 1v train step at
   batch 128 in fp32 and bf16; the antipodal labeling round on a dim-48
   sphere SDF with the friction ladder (3-D) and the 6-D epsilon;
3. ``bench_voxelizer_extra``: K3 against the dense route on a 100^3 grid and
   an 8,192-triangle UV sphere (GPU only, as the JAX package's Pallas route
   is TPU only), with K3's launches and its largest difference from the
   dense route;
4. ``bench_frame_pipeline``: ``GraspDetector.process_frame`` on the
   18k-point tabletop, serially and through ``process_frames``, with K1's
   and K2's launches per frame.

Timing (``_timed``): one warm call, then the best of ``reps`` of (n calls +
one ``torch.cuda.synchronize()``) / n; each rep's ms per call is staged
under ``extras["rep_ms"]``, so that the spread shows. Each call that draws
takes its own seed. The frame is timed on the host clock per
``process_frame``, which copies its results to the host.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extras"},
on every exit path: normal completion, any exception, SIGTERM or SIGINT,
and a watchdog deadline (BENCH_DEADLINE_S, default 1500 s). Families are
staged into the line as they finish, so a late failure still publishes
those that finished (``extras["partial"]`` names the failure); a run that
never reached the headline publishes {"value": null, "error": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

NUM_POINTS = 750
N_CANDIDATES = 512
SCENE_POINTS = 20000
BASELINE_THREADS = 8       # as the JAX bench pins them
BASELINE_REPEATS = 3       # median-of-k repetitions
ANCHOR_N = 8192
TRAIN_BATCH = 128
LABEL_ATTEMPTS = 256
LABEL_SPHERE = (48, 0.0025, 0.045)       # dim, resolution, radius
VOX_SPHERE = (64, 64, 0.05)              # nu, nv, radius: 8,192 triangles
VOX_DIM = 100
FRAME_FACE_POINTS = 2000                 # 3 boxes x 3 faces: 18,000 points
FRAME_PAD_TO = 4096
FRAME_NUM_POINTS = 500
PEAK_FP32_FLOPS = 67e12    # one H100 SXM outside the tensor cores
# K3 against the dense route: |k3 - dense^2| / max(dense^2, (1 mm)^2)
VOX_FLOOR_M2 = 1e-6

# ---------------------------------------------------------------------------
# Staged single emit: RESULT is filled in place as families finish;
# _emit_once prints it exactly once, whichever exit path gets there first.
# ---------------------------------------------------------------------------

RESULT = {
    "metric": "grasp_candidates_scored_per_sec_750pt",
    "value": None,
    "unit": "candidates/s",
    "vs_baseline": None,
    "extras": {
        "timing": "best of reps of (n calls + one torch.cuda.synchronize()) "
                  "/ n after one warm call; rep_ms: each rep's ms per call; "
                  "the frame on the host clock per process_frame",
        "rep_ms": {},
    },
}
# reentrant: the signal handler runs on the main thread, possibly inside
# _emit_once
_EMIT_LOCK = threading.RLock()
_EMITTED = False           # a line is out, or being printed
_PRINTED = False           # the line is out


def _emit_once(error: str | None = None) -> None:
    global _EMITTED, _PRINTED
    with _EMIT_LOCK:
        if _EMITTED:
            return
        _EMITTED = True
        if error and RESULT["value"] is None:
            RESULT["error"] = error
        elif error:
            RESULT["extras"]["partial"] = error
        print(json.dumps(RESULT), flush=True)
        _PRINTED = True


def _install_emit_guards(deadline_s: float):
    """Emit the staged result on SIGTERM/SIGINT and at a hard deadline, then
    exit 0. Returns a function that cancels the watchdog and puts the
    previous signal handlers back."""
    previous = {}

    def _on_signal(signum, frame):
        _emit_once(error=f"killed by signal {signum} mid-run")
        if _PRINTED:       # else this thread is printing it: let it finish
            os._exit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass  # non-main thread / restricted env

    def _on_deadline():
        _emit_once(error=f"watchdog deadline {deadline_s:.0f}s hit mid-run")
        os._exit(0)

    timer = threading.Timer(deadline_s, _on_deadline)
    timer.daemon = True
    timer.start()

    def release():
        timer.cancel()
        for sig, handler in previous.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    return release


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(make_fn, n, device, name, reps=3):
    """Best of ``reps`` of (n calls + one synchronize) / n, in seconds,
    after one warm call; stages each rep's ms per call under
    ``rep_ms[name]``. ``make_fn(i)`` runs call i."""
    make_fn(0)
    _sync(device)
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for i in range(n):
            make_fn(i)
        _sync(device)
        per_call.append((time.perf_counter() - t0) / n)
    RESULT["extras"]["rep_ms"][name] = [s * 1e3 for s in per_call]
    return min(per_call)


def _card_line() -> str | None:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def _wait_for_backend(device: str = "cuda", max_tries: int = 3,
                      sleep_s: float = 30.0, probe_timeout_s: float = 60.0):
    """The device to run on. ``device="cpu"`` is the CPU. Otherwise a fresh
    subprocess probes for a GPU (``torch.cuda.is_available()`` and the
    device's name), up to ``max_tries`` times: worst case 3 x 60 s probes
    + 2 x 30 s sleeps = 4 min, so a card that never answers surfaces as an
    error line inside any external kill budget. The probe initializes CUDA
    in its own process, never in this one before it answers. A probe that
    finds no GPU is an error unless BENCH_ALLOW_CPU is set: the CPU runs
    only when asked for."""
    extras = RESULT["extras"]
    if device == "cpu":
        extras["backend"] = "cpu"
        extras["device"] = f"{platform.processor() or platform.machine()} " \
                           f"(CPU, {torch.get_num_threads()} threads)"
        return torch.device("cpu")
    probe = ("import torch; ok = torch.cuda.is_available(); "
             "print('BACKEND=' + ('cuda' if ok else 'cpu')); "
             "print('DEVICE=' + (torch.cuda.get_device_name(0) if ok "
             "else 'none'))")
    for attempt in range(max_tries):
        try:
            out = subprocess.run(
                [sys.executable, "-c", probe], capture_output=True,
                text=True, timeout=probe_timeout_s).stdout
        except subprocess.TimeoutExpired:
            out = ""
        found = dict(line.split("=", 1) for line in out.splitlines()
                     if line.startswith(("BACKEND=", "DEVICE=")))
        backend = found.get("BACKEND")
        if backend == "cuda" and torch.cuda.is_available():
            extras["backend"] = "cuda"
            extras["device"] = _card_line() or (
                f"{found.get('DEVICE')}, power limit not read")
            return torch.device("cuda", 0)
        if backend == "cpu" and os.environ.get("BENCH_ALLOW_CPU"):
            return _wait_for_backend("cpu")
        if attempt == max_tries - 1:
            raise RuntimeError(
                f"accelerator backend never initialized (last probe: "
                f"{backend or 'init failed/hung'}); set BENCH_ALLOW_CPU=1 "
                f"or pass --device cpu to benchmark on the CPU anyway")
        print(f"# backend probe got {backend or 'failure'}; retry "
              f"{attempt + 1}/{max_tries - 1} in {sleep_s:.0f}s",
              file=sys.stderr, flush=True)
        time.sleep(sleep_s)


# ---------------------------------------------------------------------------
# The families' inputs, as the JAX bench builds them
# ---------------------------------------------------------------------------

def headline_scene(scene_points: int = SCENE_POINTS,
                   n_candidates: int = N_CANDIDATES):
    """(pc (P, 3), cands (G, 5, 3)) float32: bench.py's scorer scene."""
    rs = np.random.RandomState(0)
    pc = (rs.rand(scene_points, 3) * [0.08, 0.06, 0.05]).astype(np.float32)
    centers = (rs.rand(n_candidates, 3) * [0.08, 0.06, 0.05]).astype(
        np.float32)
    centers[:, 0] -= 0.03
    cands = np.zeros((n_candidates, 5, 3), np.float32)
    cands[:, 0] = centers
    cands[:, 1] = [1, 0, 0]
    cands[:, 2] = [0, 1, 0]
    cands[:, 3] = [0, 0, 1]
    return pc, cands


def score_scene(model, pc, cands, valid, draws, *,
                num_points: int = NUM_POINTS):
    """One headline scene: crop + resample + forward + vote + rank."""
    from pointnetgpd_tpu_torch.inference.scorer import score_candidates_fused

    return score_candidates_fused(model, pc, cands, valid, 0.06, 0.08, draws,
                                  num_points=num_points, repeat=1,
                                  min_points=10)


def seeded_model(k: int, seed: int, device, num_points: int = NUM_POINTS):
    """A PointNetCls with random weights from torch's generator seeded with
    ``seed`` (the global generator's state is put back)."""
    from pointnetgpd_tpu_torch.models.pointnet import PointNetCls

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = PointNetCls(num_points=num_points, input_chann=3, k=k)
    return model.to(device)


def sphere_sdf_data(dim: int, res: float, r: float):
    """(data (dim, dim, dim), origin): a sphere's SDF on a centred grid."""
    origin = -res * (dim - 1) / 2 * np.ones(3)
    ii, jj, kk = np.meshgrid(*(np.arange(dim),) * 3, indexing="ij")
    grid_pts = origin + res * np.stack([ii, jj, kk], axis=-1)
    return np.linalg.norm(grid_pts, axis=-1) - r, origin


def uv_sphere(nu: int, nv: int, r: float):
    """(2 nu nv, 3, 3) float32 triangles of a UV sphere."""
    th = np.linspace(0.0, np.pi, nv + 1)
    ph = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([r * np.sin(tt) * np.cos(pp),
                      r * np.sin(tt) * np.sin(pp),
                      r * np.cos(tt)], axis=-1).reshape(-1, 3)
    tris = []
    for i in range(nv):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = a + nu, b + nu
            tris += [[a, c, b], [b, c, d]]
    return verts[np.asarray(tris)].astype(np.float32)


def voxel_grid(dim: int, r: float):
    """(origin, res) of the voxelizer family's grid: SDFGen's padding of 5
    cells around the sphere's box (res = 2.2 r / 89 at dim 100)."""
    res = 2.2 * r / (dim - 11)
    return -res * (dim - 1) / 2 * np.ones(3), res


def tabletop(face_points: int = FRAME_FACE_POINTS):
    """(points, cam): bench.py's segmented tabletop, three boxes over
    ~0.6 m."""
    rs = np.random.RandomState(0)
    objs = []
    for cx, cy in ((-0.25, -0.15), (0.2, 0.25), (0.05, -0.3)):
        n = face_points
        top = rs.rand(n, 3) * [0.06, 0.06, 0] + [cx, cy, 0.08]
        front = rs.rand(n, 3) * [0.06, 0, 0.06] + [cx, cy, 0.02]
        side = rs.rand(n, 3) * [0, 0.06, 0.06] + [cx + 0.06, cy, 0.02]
        objs.append(np.concatenate([top, front, side]).astype(np.float32))
    return np.concatenate(objs), np.array([1.0, 1.0, 1.2], np.float32)


def _launches():
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import point_triangle as k3
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2

    return {"gpg_counts": k1.launches, "pointnet_trunk": k2.launches,
            "pointnet_trunk_512": k2.launches_by_width[512],
            "point_triangle": k3.launches}


def _since(before):
    now = _launches()
    return {k: now[k] - before[k] for k in now}


# ---------------------------------------------------------------------------
# The families
# ---------------------------------------------------------------------------

def bench_device(baseline, *, device: str = "cuda",
                 num_points: int = NUM_POINTS,
                 n_candidates: int = N_CANDIDATES,
                 scene_points: int = SCENE_POINTS, anchor_n: int = ANCHOR_N,
                 train_batch: int = TRAIN_BATCH,
                 label_attempts: int = LABEL_ATTEMPTS,
                 label_sphere=LABEL_SPHERE, reps: int = 3):
    """The matmul anchor, the headline and bf16 scenes, train samples/s and
    labeled grasps/s on the device ``_wait_for_backend`` gives. Returns that
    device."""
    dev = _wait_for_backend(device)
    ex = RESULT["extras"]
    ex.setdefault("sizes", {}).update(
        num_points=num_points, n_candidates=n_candidates,
        scene_points=scene_points, anchor_n=anchor_n,
        train_batch=train_batch, label_attempts=label_attempts,
        label_sphere=list(label_sphere))

    # the card's health anchor, recorded first: fp32 outside the tensor
    # cores, so TF32 must be off (no global flag is set here)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is set: "
                           "the anchor measures fp32")
    gen = torch.Generator(device=dev).manual_seed(0)
    mm_a = torch.randn((anchor_n, anchor_n), generator=gen, device=dev)
    mm_b = torch.randn((anchor_n, anchor_n), generator=gen, device=dev)
    anchor_s = _timed(lambda i: torch.matmul(mm_a, mm_b), 4, dev,
                      "matmul_anchor", reps)
    del mm_a, mm_b
    flops = 2.0 * anchor_n ** 3
    ex["matmul_anchor_8192_ms"] = anchor_s * 1e3
    ex["matmul_anchor_tflops"] = flops / anchor_s / 1e12
    ex["matmul_anchor_fp32_bound_ms"] = flops / PEAK_FP32_FLOPS * 1e3

    from pointnetgpd_tpu_torch.draws import Draws
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer

    # the headline: one scene is one call of the fused scorer
    model = seeded_model(3, 0, dev, num_points).eval()
    pc_np, cands_np = headline_scene(scene_points, n_candidates)
    pc = torch.from_numpy(pc_np).to(dev)
    cands = torch.from_numpy(cands_np).to(dev)
    valid_in = torch.ones((n_candidates,), dtype=torch.bool, device=dev)

    def scene_with(m):
        def scene(seed):
            return score_scene(m, pc, cands, valid_in, Draws(seed, dev),
                               num_points=num_points)
        return scene

    scene = scene_with(model)
    dt = _timed(scene, 20, dev, "scene", reps)
    before = _launches()
    scene(0)
    _sync(dev)
    ex["k2_launches_per_scene"] = _since(before)["pointnet_trunk"]
    cand_per_sec = n_candidates / dt
    RESULT["value"] = cand_per_sec
    ex["scene_latency_ms_512_candidates"] = dt * 1e3
    if baseline:
        RESULT["vs_baseline"] = cand_per_sec / baseline

    # bf16 (GraspScorer.as_dtype): the parameters and activations in bf16,
    # K2 still in float32
    scorer16 = GraspScorer(model=model, k=3, num_points=num_points,
                           device=dev).as_dtype(torch.bfloat16)
    scene16 = scene_with(scorer16.model)
    ex["bf16_candidates_per_sec"] = n_candidates / _timed(
        scene16, 20, dev, "scene_bf16", reps)
    before = _launches()
    scene16(0)
    _sync(dev)
    ex["k2_launches_per_scene_bf16"] = _since(before)["pointnet_trunk"]
    del model, scorer16

    # train samples/s per device: the fused crop + forward + backward + Adam
    from pointnetgpd_tpu_torch.parallel.mesh import make_mesh
    from pointnetgpd_tpu_torch.training.data import SyntheticGraspData
    from pointnetgpd_tpu_torch.training.train import (
        init_train_state, make_fused_train_step, make_optimizer)

    # one shard on this device: the fused step runs on one device (several
    # cards train as ranks, cli/train.py --n-devices)
    n_chips = make_mesh(device=dev).size
    tx = make_optimizer(0.005)
    batch = train_batch * n_chips
    grasps, clouds, transforms, labels, weights = SyntheticGraspData(
        batch_size=batch, cloud_points=scene_points).next_batch()
    args = [torch.as_tensor(a).to(dev)
            for a in (grasps, clouds, transforms)] + [
        torch.as_tensor(labels).to(dev).long(),
        torch.as_tensor(weights).to(dev).float()]

    def train_rate(compute_dtype, name):
        state = init_train_state(seeded_model(2, 1, dev, num_points), tx)
        step_fn = make_fused_train_step(num_points=num_points,
                                        min_point_limit=50,
                                        compute_dtype=compute_dtype)

        def train_iter(i):
            return step_fn(state, *args, Draws(i, dev))[1]["loss"]

        return batch / _timed(train_iter, 10, dev, name, reps) / n_chips

    ex["train_samples_per_sec_per_chip_750pt_b128"] = train_rate(
        None, "train_fp32")
    ex["train_bf16_samples_per_sec_per_chip"] = train_rate(
        torch.bfloat16, "train_bf16")

    # labeled grasps/s: antipodal sampling + the friction ladder, and the
    # 6-D Ferrari-Canny epsilon, on the device
    from pointnetgpd_tpu_torch.geometry.sdf import make_sdf
    from pointnetgpd_tpu_torch.grasping.evaluation import (
        FC_LIST_LESS_CLASS, evaluate_ferrari_canny_6d,
        friction_boundary_labels)
    from pointnetgpd_tpu_torch.grasping.samplers import (
        antipodal_sample_grasps)

    data, origin = sphere_sdf_data(*label_sphere)
    sphere = make_sdf(data, origin, label_sphere[1], device=dev)
    mu = float(FC_LIST_LESS_CLASS[0])
    fc = torch.as_tensor(FC_LIST_LESS_CLASS.astype(np.float32), device=dev)
    com = np.zeros(3, np.float32)

    def sample(seed):
        return antipodal_sample_grasps(
            sphere, seed=seed, max_width=0.10, friction_coef=mu,
            num_attempts=label_attempts, num_samples_loa=48)

    def label_round(seed):
        s = sample(seed)
        _, _, lok = friction_boundary_labels(sphere, s.configs, fc)
        return lok & s.valid

    dt_label = _timed(label_round, 5, dev, "label_3d", reps)
    # the count of one round, after the timing
    ex["labeled_grasps_per_sec"] = float(label_round(0).sum()) / dt_label

    def label6_round(seed):
        quals, _ = evaluate_ferrari_canny_6d(
            sphere, sample(seed).configs, com, mu, num_samples=48,
            torque_scaling=10.0)
        return quals

    dt6 = _timed(label6_round, 3, dev, "label_6d", reps)
    ex["labeled_grasps_per_sec_6d"] = float(
        (label6_round(0) > 0).sum()) / dt6
    return dev


def bench_voxelizer_extra(device, *, sphere=VOX_SPHERE, dim: int = VOX_DIM):
    """The voxelizer's distance pass: K3 against the dense route on a
    ``dim``^3 grid and a UV sphere (the bounding-sphere pruning's worst
    case). Returns (k3_ms, speedup, dense_ms, K3 launches per call, largest
    |k3 - dense^2| / max(dense^2, VOX_FLOOR_M2)), or None off the GPU."""
    if device.type != "cuda":
        return None
    from pointnetgpd_tpu_torch.ops import point_triangle as k3

    RESULT["extras"].setdefault("sizes", {})["voxelizer"] = [*sphere, dim]

    tri_v = uv_sphere(*sphere)
    origin, res = voxel_grid(dim, sphere[2])
    pts_blocked, _ = k3.blocked_grid(dim, dim, dim, origin, res)
    tri_data, sup_data = k3.pack_triangles(tri_v)
    pts = torch.from_numpy(pts_blocked).to(device)
    td = torch.from_numpy(tri_data).to(device)
    sd = torch.from_numpy(sup_data).to(device)
    tri_dev = torch.from_numpy(tri_v).to(device)
    out = {}

    def kernel(i):
        out["k3"] = k3.min_point_triangle_dist2(pts, td, sd)

    def dense(i):
        out["dense"] = k3.unsigned_distance_torch(pts, tri_dev)

    dt_k3 = _timed(kernel, 2, device, "voxelizer_k3", reps=2)
    before = _launches()
    kernel(0)
    _sync(device)
    per_call = _since(before)["point_triangle"]
    dt_dense = _timed(dense, 2, device, "voxelizer_dense", reps=2)
    want = out["dense"].double() ** 2
    rel = float(((out["k3"].double() - want).abs()
                 / want.clamp(min=VOX_FLOOR_M2)).max())
    return dt_k3 * 1e3, dt_dense / dt_k3, dt_dense * 1e3, per_call, rel


def bench_frame_pipeline(device, *, face_points: int = FRAME_FACE_POINTS,
                         cloud_pad_to: int = FRAME_PAD_TO,
                         num_points: int = FRAME_NUM_POINTS, n_it: int = 5):
    """The online frame (kinect2grasp's loop): downsample + normals + GPG
    sampling + crop and score on the segmented tabletop. Returns
    (serial ms per frame, pipelined ms per frame, K1 and K2 launches of one
    more frame), warm."""
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.robot.node import DetectorConfig, GraspDetector

    RESULT["extras"].setdefault("sizes", {})["frame"] = [
        face_points, cloud_pad_to, num_points, n_it]
    scorer = GraspScorer(model=seeded_model(3, 0, device), k=3,
                         num_points=num_points, device=device)
    det = GraspDetector(scorer, config=DetectorConfig(
        cloud_pad_to=cloud_pad_to))
    pts, cam = tabletop(face_points)

    det.process_frame(pts, cam, seed=0)     # warm
    serial = []
    for i in range(n_it):
        t0 = time.perf_counter()
        det.process_frame(pts, cam, seed=i)  # copies its results to the host
        serial.append(time.perf_counter() - t0)
    RESULT["extras"]["rep_ms"]["frame"] = [s * 1e3 for s in serial]

    # one frame in flight: frame i + 1 is dispatched before frame i is
    # collected
    t0 = time.perf_counter()
    n_done = sum(1 for _ in det.process_frames(
        (pts for _ in range(n_it)), cam, start_seed=100))
    piped_ms = (time.perf_counter() - t0) / n_done * 1e3
    before = _launches()
    det.process_frame(pts, cam, seed=n_it)
    counts = _since(before)
    return (sum(serial) / n_it * 1e3, piped_ms, counts["gpg_counts"],
            counts["pointnet_trunk"])


def bench_reference_torch(*, num_points: int = NUM_POINTS,
                          n_candidates: int = N_CANDIDATES,
                          scene_points: int = SCENE_POINTS):
    """The reference path: host numpy crop + per-candidate batch-1 torch CPU
    calls (kinect2grasp.py:454-497, main_test.py:59-69) through the
    reference's own model code. None without a reference checkout. Pinned
    to BASELINE_THREADS torch threads, the median of BASELINE_REPEATS
    repetitions, with the host's 1-minute load average beside it; the
    thread count is put back afterwards."""
    from pointnetgpd_tpu_torch.pipelines.parity import _reference_root

    root = os.path.join(_reference_root(), "PointNetGPD")
    if not os.path.isdir(root):
        return None
    sys.path.insert(0, root)
    from model.pointnet import PointNetCls  # reference definition (oracle)

    threads = torch.get_num_threads()
    torch.set_num_threads(BASELINE_THREADS)
    try:
        model = PointNetCls(num_points=num_points, input_chann=3, k=3)
        model.eval()
        pc, cands = headline_scene(scene_points, n_candidates)
        centers = cands[:, 0]
        n_measured = min(48, n_candidates)  # batch-1 calls are slow

        def one_rep():
            t0 = time.perf_counter()
            with torch.no_grad():
                for i in range(n_measured):
                    # crop (kinect2grasp.py:178-235 semantics)
                    rot = np.eye(3, dtype=np.float32)
                    pc_t = (pc - centers[i]) @ rot.T
                    w = 0.08
                    mask = ((pc_t[:, 0] > 0) & (pc_t[:, 0] < 0.06)
                            & (np.abs(pc_t[:, 1]) < w / 2)
                            & (np.abs(pc_t[:, 2]) < w / 4))
                    crop = pc_t[mask]
                    if len(crop) < 10:
                        continue
                    idx = np.random.choice(len(crop), num_points,
                                           replace=len(crop) < num_points)
                    # batch-1 scoring (main_test.py:59-69)
                    logp, _ = model(torch.from_numpy(crop[idx].T[None]))
                    logp.softmax(1).numpy()
            return (time.perf_counter() - t0) / n_measured

        dts = sorted(one_rep() for _ in range(BASELINE_REPEATS))
    finally:
        torch.set_num_threads(threads)
    dt = dts[len(dts) // 2]  # median
    try:
        RESULT["extras"]["baseline_host_load_1min"] = os.getloadavg()[0]
    except OSError:
        pass
    RESULT["extras"]["baseline_method"] = (
        f"median-of-{BASELINE_REPEATS}, {BASELINE_THREADS} torch threads")
    return 1.0 / dt


def _family_failed(name: str, exc: Exception) -> None:
    traceback.print_exc(file=sys.stderr)
    RESULT["extras"].setdefault("family_errors", {})[name] = (
        f"{type(exc).__name__}: {exc}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; the CPU only with "
                             "BENCH_ALLOW_CPU=1 where no GPU answers) or cpu")
    args = parser.parse_args(argv)
    release = _install_emit_guards(
        float(os.environ.get("BENCH_DEADLINE_S", "1500")))
    err = None
    ex = RESULT["extras"]
    try:
        # the reference baseline first: CPU only, independent of the card,
        # so even a run without one publishes it
        try:
            baseline = bench_reference_torch()
        except Exception as e:
            _family_failed("reference_baseline", e)
            baseline = None
        if baseline:
            ex["reference_torch_cpu_candidates_per_sec"] = baseline
        dev = bench_device(baseline, device=args.device)
        try:
            vox = bench_voxelizer_extra(dev)
        except Exception as e:
            _family_failed("voxelizer", e)
            vox = None
        if vox:
            (ex["voxelizer_pallas_ms_100cube_8192tri"],
             ex["voxelizer_pallas_speedup_vs_xla"],
             ex["voxelizer_dense_ms"], ex["voxelizer_k3_launches_per_call"],
             ex["voxelizer_k3_max_rel_diff"]) = vox
        try:
            frame = bench_frame_pipeline(dev)
        except Exception as e:
            _family_failed("frame", e)
            frame = None
        if frame:
            (ex["online_frame_ms_18k_tabletop_150_seeds"],
             ex["online_frame_pipelined_ms"],
             ex["online_frame_k1_launches_per_frame"],
             ex["online_frame_k2_launches_per_frame"]) = frame
        ex["launches"] = _launches()
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        err = f"{type(e).__name__}: {e}"
    finally:
        _emit_once(error=err)
        release()


if __name__ == "__main__":
    main()
