"""Drive the PyTorch/CUDA port's paths on one GPU: the online
grasp-detection frame and its entry points, the mesh -> SDF voxelizer
(object preparation), the trainer, dataset labeling, the RGB-D -> cloud
path, data and tensor parallelism, the object database with its users, the
last modules (contact surface windows, the normal-approximation study, the
training-parity experiment, the profiler) and the drivers of
``pointnetgpd_tpu_torch/examples/``.

Run from the repository root:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the build time;
   from the built library's SASS (cuobjdump; the PTX where the toolkit has
   no cuobjdump), show that K2 runs wgmma (HGMMA), K1 no tensor-core
   instruction and K3 no division: no div in its PTX (built with the
   library's flags), no FCHK in its SASS, and no slow-path CALL inside its
   pair loops (each CALL's target is printed with what it holds); print
   K3's registers, shared memory, stack and spills from ptxas and fail on
   any local memory;
3. K1 (GPG panel-count scan) against its plain version on the three scans of
   one frame of the 18k-point synthetic tabletop (the benchmark scene of
   bench.py, rebuilt here), bucketed at cloud_pad_to=4096: exact equality
   on the active frames; then on that frame's cloud and first 256 frames
   with 32 unsorted and 1 shift, all frames active, and an empty cloud;
4. K2 (fused PointNet trunk, tensor cores in 3xTF32) against its plain
   version at the detector's (B, N) = (64, 500), the scorer benchmark's
   (512, 750) and the edges (1, 300), (4, 1), (3, 129), to
   |err| <= 1e-4 * (1 + |ref|); the golden checkpoint's frozen outputs are
   reproduced on the card through K2 to 1e-4; DualPointNetCls (6-channel
   trunks) and PointNetDenseCls in eval mode through K2 and through its
   plain version, to the same tolerance;
5. the main path: GraspDetector.process_frame on a few frames with the
   golden 3-class checkpoint, DetectorConfig() defaults and
   cloud_pad_to=4096. The launch counters are zeroed just before and read
   just after: K1 must launch 3 times and K2 twice per frame. Scores must be
   finite, in [0, 1] and in descending ranked order, with n_valid > 0. The
   first frame is run again with both kernels swapped for their plain
   versions (same seed, so the same draws): candidates, counts and
   predictions must be equal and scores within 1e-4;
6. timings with CUDA events (warm, many launches) of each kernel alone (K1:
   the bare C launch on prepared arguments, per scan; its wrapper is timed
   apart; an empty kernel on the same stream is the launch-latency floor),
   its plain version and, for K2, one PyTorch yardstick (three torch.matmul
   + max, TF32 off) that the port never calls; each kernel's bound and its
   share of it; warm ms per frame. With ``--profile``, also a
   torch.profiler breakdown of a few warm frames;
7. the voxelizer path (``voxelizer_phases``): prepare_object_dir on a
   60,000-triangle torus at sdf_dim 100 (1 K3 launch, K1 and K2 none), the
   SDF within 0.02 res of the analytic one; K3 against its plain version on
   256 blocks and on its edge cases (one supertile, all-padding
   supertiles, a far block, degenerate triangles); mesh_to_sdf at dim 48,
   the convex decomposition and MeshProcessor against their plain routes;
   timings; the supertiles K3 visits per block and the pairs it evaluates
   (its own counts, from a separate launch), beside what the TPU kernel's
   walk (index order) visits
   on the same inputs (``kernel_walk`` in plain torch) and what each
   design needs;
7f. K3 above the 16,384 supertiles it sorts at a time: a torus of 2,160,000
   triangles (16,875 supertiles), 16 point blocks (8 with near supertiles
   in both chunks) against the brute force, its counts beside the
   plain-torch chunked walk's, its time;
8. the training path (``training_phases``) at the 1v variant's full width:
   ``Trainer.fit`` with TrainConfig's defaults (k=2, 750 points, batch 128,
   lr 0.005) on learnable synthetic data of 20,000-point clouds, 2 epochs x
   5 steps and 2 eval batches each. Counters zeroed just before: K2 must
   launch twice per eval batch, K1 and K3 never; losses and parameters
   finite, every parameter and running statistic moved. K2 at the eval
   shape (128, 750) against its plain version; the checkpoint fit wrote
   loaded by ``GraspScorer.from_checkpoint`` predicts as the trained model;
   one step on the card against the same step on the CPU (same weights,
   the same draws replayed) and the ``fused_maxpool`` step against the
   unfused one, all against the same step in float64 on the CPU: losses
   within 1e-5 relative, the card's (the fused step's) largest gradient
   error against float64 at most twice the CPU's (the unfused step's) plus
   1e-4 x max|g| (float32 gradients of the STN's layers are ill-conditioned
   at this width on either device: a few percent of max|g| off float64),
   the biases that BatchNorm absorbs within 1e-3 x max|g| of noise,
   running statistics within 1e-5;
   the 1v_mc and 1v_gpd variants through ``cli.train.main`` (the card by
   default); timings (CUDA events) of the fp32, bf16 and fused_maxpool steps
   with samples/s and peak memory, and of a GPD step. With ``--profile``,
   host time per ``record_function`` span (``train.*``, ``eval.*``) and the
   device's busy share of one train step and one eval batch.
9. the labeling path (``labeling_phases``), each card result held to the
   same computation on the CPU under one replayed draw tape (``Tape``): a
   lane that differs must lie within 1e-5 relative of its threshold
   (float64 on the CPU) or be decided by rounding, i.e. move on the CPU
   route under a one-ulp change of the SDF's values, origin or resolution
   or of the draws (``nudged_sdfs``); at most 10% of the lanes. Each
   Ferrari-Canny metric is also held on equal rows (``hold_metric``), and
   the force-only one to a float64 qhull witness (``qhull_eps``);
   a. ``bench.py``'s labeling cell: a sphere SDF of dim 48, 256 antipodal
      attempts with 48 line samples at mu 2.0, the friction ladder and
      the 6-D epsilon; labeled grasps/s for each (CUDA events, 5 and 3
      warm rounds);
   b. ``generate_for_object_dir`` on phase 7's torus, prepared again
      (sdf_dim 100; robotiq_85, the less ladder, 20 per class), cold and
      warm: rows per class, rounds, quota status, seconds; its first
      round's sampler and labels against the CPU route; the rows' format;
   c. ``gpg_sample_grasps_sdf`` (covariance and curvature frames) and
      ``point_sample_grasps_sdf`` on the torus resting on the table: K1
      must launch 3 times per call, each launch must equal the plain
      version on its active frames, and the candidates with K1 swapped for
      its plain version must be equal; K1's time there;
   d. ``ground_truth_quality`` of 9c's valid candidates with the torus at
      a pose, card against the CPU route.
10. the online path's entry points (``entry_phases``), each K2 (and K1)
   launch site counted and held to its plain version (kernels swapped by
   their ``_launch``):
   a. ``cli.infer.main`` on the golden checkpoint, a 500-point cloud in a
      temporary .npy, ``--repeat 10``: K2 twice; prediction and votes equal
      to the plain route's, probabilities within 1e-4; then
      ``--load-model`` on phase 8's model path, resolved to its newest
      step, predicting as the trained model;
   b. ``score_clouds`` of a DualPointNetCls on (40, 500, 6) clouds (K2
      once, probabilities within 1e-4 of the plain route) and of the golden
      scorer's ``as_dtype(torch.bfloat16)`` (K2 twice in float32, classes
      equal to the plain route; its class agreement with fp32 printed);
   c. ``GraspDetector.warmup(max_points=20000)`` at cloud_pad_to=4096 and
      the first live tabletop frames, each in a fresh process
      (``--warmup-child``), with and without the warmup: buckets, seconds,
      K1 3 and K2 2 launches per bucket and per frame, the first frame
      equal to its plain route;
   d. ``run_ros_node`` through in-process stand-ins for the ROS modules,
      fed the tabletop as a PointCloud2, 3 frames serially and with
      ``pipeline=True``: K1 3 and K2 2 launches per frame, the published
      best grasp and score equal to ``process_frame``'s first ranked grasp
      (and the score within 1e-4 of the plain route's);
11. the RGB-D -> cloud path (``cloud_phases``), card against the CPU route:
   a. a 640x480 depth frame (a sloping table with a box on it) registered
      into a 1280x1024 colour frame through a non-identity transform: the
      filtered and registered depth equal pixel for pixel, the cloud
      within 1e-6 x (1 + |ref|); each function and ``frame_cloud`` timed
      with CUDA events;
   b. the writers: the .npy equal to the .pcd's xyz, the .ply's vertex
      count;
   c. ``render_object_clouds`` on phase 7's torus, 6 views: equal files
      from the card and the CPU route, every point within 4 x the 3e-4
      noise plus a pixel's footprint of the analytic torus, the rasterizer
      built under ``pointnetgpd_tpu_torch/_build/``, ``native/renderer/``
      unchanged.
12. data and tensor parallelism on the one card (``mesh_phases``): a mesh
   of 2 shards on cuda:0 and ranks on cuda:0 show that the split, the
   per-shard launches, the collectives and the gather give the
   single-device answer (one-card numbers, not scaling):
   a. ``process_frame`` on the tabletop with ``GraspScorer(mesh=make_mesh(
      2, device="cuda:0"))`` against the single-device frame (the golden
      model with its best-class bias raised by 3, so that the ranking has
      grasps), with lazy and with whole-cloud window normals: n_valid, the
      predictions and the ranked order equal, frames and scores within
      1e-6; K1 3 and K2 2 launches per shard, each recorded K1 launch equal
      to the plain version on its active frames; ms per frame of both;
   b. ``score_clouds`` of 100 clouds (not a multiple of pad_to) on the mesh
      against the single device: predictions equal, probabilities within
      1e-6, K2 2 launches per shard;
   c. the tensor-parallel eval forward (``parallel/tp.py``, mp = 2 on
      cuda:0) of the golden model at (64, 500) against the replicated
      forward to 2e-5: 4 launches, every one of K2's 512-row instance; that
      instance against its plain version at (64, 500) and (128, 750) to
      1e-4 x (1 + |ref|), its time and bound beside the 1024-row
      instance's;
   d. the 1v train step at full width (batch 128, 750 points, 20,000-point
      clouds, a quarter of the batch masked, all on the second half) on 1
      rank over NCCL and 2 ranks over gloo on cuda:0 (NCCL refuses two
      ranks on one card), each against the 1-process step on the same
      global batch and draws, in float32 and computed in float64
      (``compute_dtype``), both cases in one start of the ranks: loss
      within 1e-6 relative, BN running statistics within 1e-5 x
      (1 + |ref|); the float64 step's every gradient within 1e-4 x max|g|;
      the float32 step's classifier head within 1e-4 x max|g| and its
      trunks (the STN's and the feature trunk's) against the float64 step
      as in phase 8, since at this width the float32 step moves by more
      than 1e-4 x max|g| outside the STN when the batch's rows are only
      reordered (printed). One process and a group of any size share one
      BatchNorm arithmetic (``models/layers.py``), so only the sums' order
      differs. An eval pass of the model before the step, its sums
      against the 1-process eval and its K2 launches (2 per rank); ms per
      float32 step of each.
13. the device work of the object database's path (``database_phases``),
   at the reference's settings on phase 7's torus written as OBJ (sdf_dim
   100, padding 5, a fresh mesh cache), each step's time and the host's
   share against K3's:
   a. ``MeshProcessor.generate_graspable``, which ``DexNet.add_object``
      runs: K3 once, counted around it alone; its SDF equal bit for bit to
      K3's ``mesh_to_sdf`` of the processed mesh (a launch counted apart)
      and within 0.02 res of the analytic torus;
   b. ``label_grasps_for_object`` at 5 grasps per class, whose rows
      ``compute_simulation_data`` stores: equal bit for bit run to run, the
      device's busy time from a profiled rerun;
   c. ``UrdfWriter.write`` on an L shape with no pieces given: K3 once, the
      URDF and piece files equal to the plain K3 route's;
   d. ``compare_normals``' normals on the object's SDF: the SDF plane-fit
      normals held to the CPU route as phase 9 holds the labeling path, the
      KNN normals up to sign within 1 - |cos| <= 1e-4.
   The card's machine has neither h5py nor matplotlib, so the database's
   file (``DexNet``, the scripted ``DexNetCli`` session,
   ``generate_gqcnn_dataset``) and the figures are held on the CPU by
   tests/test_torch_api.py and tests/test_torch_database.py, against the
   JAX package; the phase prints whether they are installed. K3's launches
   at its sites go into ``launches_by_path`` of its entry in the kernels
   line (a and phase 7's cube under ``mesh_processor``, c under ``urdf``).
14. the last modules (``last_modules_phases``, sizes are parameters):
   a. contact surface windows on phase 9b's torus SDF (sdf_dim 100) at the
      ``close_fingers`` contacts of phase 9b's labeled rows, both jaws:
      ``surface_window_sdf`` and ``surface_window_projection`` (width 1e-2,
      21 x 21 cells, 32 samples, 7x7 bilateral) over all contacts and
      ``grasp_surface_information`` (width 2e-2) over 8 grasps, card
      against the CPU route on the same SDF and contacts: windows,
      gradients and Hessian rows within 1e-6 x (1 + |ref|), the raw
      projection depths within 1e-7 m except cells that the CPU route
      itself moves under a one-ulp change of the SDF (at most 1%); CUDA-event
      ms of each call;
   b. ``run_study`` at 84,000 raw points, cloud_pad_to 8192, 500-point
      crops, over 3 scenes (cut from 50) for its 4 configs, after one
      warm-up scene: K1 exactly 3 and K2 exactly 2 launches per frame and
      config (36 and 24); warm ms per frame per config by ``StageTimer``;
      the summary; the exact-KNN config's peak memory on scene 0; scene 0
      again under each config with K1 and K2 swapped for their plain
      versions: predictions and counts equal, frames within 1e-5, scores
      within 1e-4; ``run_pinned`` on the same 3 scenes (16,384 voxels);
   c. ``build_parity_dataset`` at its defaults (sdf_dim 56, 12 per class,
      12 rounds, 6 views x 12,000 points) on ``parity_box`` and
      ``parity_torus_mesh`` (cut from 10 objects): K3 exactly once, K1 and
      K2 never, the torus's SDF through K3 against its plain route (K3's
      tolerance, equal signs), the layout of tests/test_training_parity.py;
      then ``train_ours`` at full width (batch 64, 750 points, 12,000-point
      clouds, 3 classes, eval batch 64, the reset quirk) for 3 epochs at
      its own steps_per_epoch: finite losses, K2 exactly 2 launches per eval
      batch, the last epoch's eval rerun through K2's plain version on the
      same state and crops giving the same correct counts; CUDA-event ms
      per train step, s per epoch;
   d. ``utils.profiling.device_trace`` around one study frame: one trace
      file naming CUDA kernels, K1's and K2's among them.
   The kernels line gains ``launches_by_path`` entries ``study`` (K1, K2),
   ``parity_eval`` (K2) and ``parity_dataset`` (K3).
15. the drivers of ``pointnetgpd_tpu_torch/examples/`` (``examples_phases``,
   sizes are parameters):
   a. ``integrated_workflow`` at the 1v variant's widths (batch 64, 750
      points, sdf_dim 100, the detect stage's 8192 bucket), its depth cut to
      6 objects, 2 epochs x 5 steps, 4 grasps per class and 150 GPG seeds
      (printed): its stages in fresh processes, each exiting 0, the detect
      stage in this one (K1 3 and K2 2 launches per preset); each stage's
      wall seconds, the eval accuracy against the majority prior, each
      preset's candidates, funnel and ground truth. The prepare stage's
      first SDF against ``mesh_to_sdf`` through K3's plain route (phase 7's
      tolerance) and prepared again here (1 K3 launch, equal bit for bit);
      the eval stage's test split again here, through K2 (40 launches,
      each held against ``trunk_reference`` at K2's tolerance) and its
      plain version, each giving the stage's accuracy; the
      ``reference_parity`` frame again through both kernels and both plain
      versions (as phase 5);
   b. ``gt_robustness`` on a's tree (K1 3 and K2 2 per preset, two arms);
   c. ``end_to_end_demo`` in this process: K3 1, K1 3 and K2 2 launches,
      each recorded launch against its plain version;
   d. ``execute_grasp_registration`` where h5py is installed (else the
      phase says why it did not run);
   e. ``train_parity_experiment --skip-reference`` on two objects at 2 per
      class, 2 rounds and 2 epochs (its widths otherwise): K3 once, K2 in
      pairs, finite losses.
   The kernels line gains ``launches_by_path`` entries ``workflow_prepare``
   (K3, one object counted here), ``workflow_eval`` (K2),
   ``workflow_detect``, ``gt_robustness`` and ``demo`` (K1, K2; K3 for the
   demo), and ``registration`` (K3) where it ran.

Bounds. K1: the (active frame, real point) pairs inside both fixed-axis
slabs of the boxes (``slab_pair_mask``, the plain arithmetic, counted from
the recorded scans) at 34 operations each, or the bytes of the real cloud,
the active frames and the counts, whichever takes longer. K2: three TF32
passes of layers 2-3 at 495 TFLOP/s plus layer 1 at the fp32 67 TFLOP/s
(printed beside the all-fp32 CUDA-core bound). K3: the (warp, triangle)
pairs whose sphere lies nearer the warp's slab box than the warp's final
max distance, x 32 points x 77 operations, plus a 17-operation reject test
per (warp, triangle) of each supertile the block needs, or the bytes of its inputs and
output (printed beside the supertile-granular bound: the needed (block,
supertile) pairs x
128 x 136).

TF32 is switched off for torch's matmuls and cuDNN: only K2's own 3xTF32
products use the tensor cores.
The line before the last is a JSON object with one entry per kernel; the
last line is the contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense, no sparsity; NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
K1_OPS_PER_PAIR = 34       # 3 coordinate chains (18 flops) + 16 compares
K2_TOL = 1e-4
# K3's fp32 operations per (point, triangle) pair, counted from pair_d2 in
# csrc/point_triangle.cu as written (a fused multiply-add counts as the
# multiply and the add it replaces; compares and selects count one each):
# ap (3) + d1, d2, v, w as dot products (20) + x, vb, vc (3) + vb + vc (1)
# + 15 compares for the region masks + t_ab, t_ac (2) + t_bc as one FMA (2)
# + 1 - t_bc (1) + 12 selects of (s, t) + the residual a + s ab + t ac - p
# (12) + the squared distance (5) + the running min (1)
K3_OPS_PER_PAIR = 77
# ... and per (warp, triangle) reject test: the sphere's offset from the
# slab centre (3), less the slab's half-extents in magnitude (3), clamped at
# 0 (3), its squared length (5), the reach and its square (2), the compare
# (1)
K3_OPS_PER_TEST = 17
K3_OPS_PER_PAIR_TPU = 136  # the Pallas body: five divisions, six dot products
K3_TOL = (1e-4, 1e-7)      # rtol, atol on distances (kernel vs plain)
TORUS = (300, 100, 0.05, 0.02)   # nu, nv, R, r: 60,000 triangles
LABEL_TOL = 1e-5           # contact points, configs: 1e-5 x (1 + |ref|)
EPS_RTOL, EPS_ATOL = 1e-4, 1e-6   # epsilons


def k2_bounds(b, n, h3=1024):
    """K2's (3xTF32 tensor-core bound, all-fp32 CUDA-core bound) in ms at
    (B, N) and output width ``h3``: the larger of operations and bytes
    (inputs and weights read once, the (B, h3) output written once)."""
    l1 = 2.0 * b * n * 3 * 64
    l23 = 2.0 * b * n * (64 * 128 + 128 * h3)
    nbytes = (b * n * 3 + 3 * 64 + 64 + 64 * 128 + 128 + 128 * h3
              + h3 + b * h3) * 4
    mem = nbytes / PEAK_BYTES
    return (max(3 * l23 / PEAK_TF32_FLOPS + l1 / PEAK_FP32_FLOPS, mem)
            * 1e3, max((l1 + l23) / PEAK_FP32_FLOPS, mem) * 1e3)


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
    busy, total, dev_events = device_busy(torch, prof, skip=("frame.",))
    print(f"profile ({n} frames, {card}): wall {wall_us / n / 1e3:.2f} ms "
          f"per frame, device busy {busy / n / 1e3:.3f} ms per frame "
          f"({100 * busy / wall_us:.1f}% busy; {len(dev_events) // n} device "
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


def sass_check(lib_path):
    """Count tensor-core instructions per kernel in the built library:
    wgmma (SASS HGMMA) must appear in K2's kernel and no HMMA/HGMMA in K1's.
    K3's kernel must hold no division: no div instruction in its PTX and,
    from the SASS, none in its pair loops (``k3_sass_loops``). Reads
    cuobjdump's SASS, or the PTX of the sources where the toolkit has no
    cuobjdump."""
    import shutil
    import tempfile

    from pointnetgpd_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        sections, kind = text.split("Function : "), "SASS"
        pat_k2, pat_k1 = ("HGMMA",), ("HGMMA", "HMMA")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            parts = []
            for name in ("pointnet_trunk.cu", "gpg_counts.cu"):
                out = os.path.join(tmp, name + ".ptx")
                subprocess.run([_build._nvcc(), "-arch=sm_90a", "-std=c++17",
                                *_build.SOURCES[name], "-ptx",
                                str(_build.CSRC / name), "-o", out],
                               check=True, timeout=300)
                parts += open(out).read().split(".entry ")
        sections, kind = parts, "PTX"
        pat_k2, pat_k1 = ("wgmma.mma_async",), ("wgmma.mma_async", "mma.sync")

    def body(fn):
        return "".join(sec for sec in sections
                       if sec.split("\n", 1)[0].find(fn) >= 0)

    def count(fn, pats):
        return sum(body(fn).count(p) for p in pats)

    # K2's two template instances (mangled names): the whole trunk's, whose
    # wgmma count is the tuned design's 96 (2 x 8 layer-2 k-steps and 16
    # layer-3 k-steps of the chunk loop, 3 passes each), and a 512-row
    # shard's
    n_k2 = count("pointnet_trunk_kernelILi1024", pat_k2)
    n_k2_512 = count("pointnet_trunk_kernelILi512", pat_k2)
    n_k1 = count("gpg_counts_kernel", pat_k1)
    print(f"{kind} of the built kernels: pointnet_trunk_kernel<1024> "
          f"{n_k2} x {pat_k2[0]}, pointnet_trunk_kernel<512> {n_k2_512} x "
          f"{pat_k2[0]}; gpg_counts_kernel {n_k1} tensor-core "
          f"instructions; K1 built with {_build.SOURCES['gpg_counts.cu']}",
          flush=True)
    if n_k2 != 96 or n_k2_512 == 0:
        fail("K2 does not reach the tensor cores through wgmma as built "
             "(96 per instance)")
    if n_k1 != 0:
        fail("K1 uses the tensor cores")
    # K3: no division. Its PTX, compiled with the library's own flags,
    # holds no div instruction; in the SASS there is no FCHK (the range
    # check of an IEEE division), and no CALL to a slow path lies inside a
    # pair loop, the backward-branch loops over the triangles that a warp
    # keeps (the innermost ones with a FLO, the __ffs of the kept-triangle
    # mask)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "point_triangle.ptx")
        subprocess.run([_build._nvcc(), *_build.ARCH, *_build.COMMON,
                        *_build.SOURCES["point_triangle.cu"], "-ptx",
                        str(_build.CSRC / "point_triangle.cu"), "-o", out],
                       check=True, timeout=300, capture_output=True)
        ptx = "".join(sec for sec in open(out).read().split(".entry ")
                      if "point_triangle_kernel" in sec.split("(", 1)[0])
    if not ptx:
        fail("point_triangle_kernel not found in its PTX")
    divs = [ln.strip() for ln in ptx.splitlines() if "div." in ln]
    print(f"point_triangle_kernel PTX (library flags): "
          f"{ptx.count('rcp.approx')} x rcp.approx, {ptx.count('sqrt.rn')} x "
          f"sqrt.rn, {len(divs)} div instructions", flush=True)
    if divs:
        fail(f"K3 holds a division: {divs[:3]}")
    if kind == "SASS":      # each instance (single sorted walk, chunked)
        for sec in sections:
            name = sec.split("\n", 1)[0].strip()
            if "point_triangle_kernel" in name:
                k3_sass_loops(sec, name)


def sass_instructions(text):
    """(address, opcode, operands) of each instruction in cuobjdump's SASS
    listing ``text``."""
    import re

    pat = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P(?:T|\d+)\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);")
    return [(int(m.group(1), 16), m.group(2), m.group(3).strip())
            for m in pat.finditer(text)]


def k3_sass_loops(sass, name):
    """Fail unless the SASS of K3's instance ``name`` holds no FCHK and no
    slow-path CALL inside a pair loop; print where the CALLs go and what
    their target holds."""
    import re

    ins = sass_instructions(sass)
    if not ins:
        fail("cannot read point_triangle_kernel's SASS")
    target = {}
    for addr, op, args in ins:
        m = re.search(r"0x([0-9a-f]+)", args)
        if m and (op.startswith("BRA") or op.startswith("CALL")):
            target[addr] = int(m.group(1), 16)
    loops = [(target[a], a) for a, op, _ in ins
             if op.startswith("BRA") and a in target and target[a] < a]
    flo = [a for a, op, _ in ins if op.startswith("FLO")]
    with_flo = [(lo, hi) for lo, hi in loops
                if any(lo <= a <= hi for a in flo)]
    # the innermost of them: the supertile loop around them holds a FLO too
    pair_loops = [(lo, hi) for lo, hi in with_flo
                  if not any((l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi
                             for l2, h2 in with_flo)]
    calls = [a for a, op, _ in ins if op.startswith("CALL")]
    inside = [a for a in calls
              if any(lo <= a <= hi for lo, hi in pair_loops)]
    fchk = [a for a, op, _ in ins if op.startswith("FCHK")]
    subs = sorted({target[a] for a in calls if a in target})
    held = []
    for t in subs:                     # the subroutine: target .. first RET
        ops = []
        for a, op, _ in ins:
            if a >= t:
                ops.append(op)
                if op.startswith("RET"):
                    break
        held.append(f"0x{t:x}: {len(ops)} instructions, "
                    f"{sum(o.startswith('MUFU.RSQ') for o in ops)} MUFU.RSQ, "
                    f"{sum(o.startswith('MUFU.RCP') for o in ops)} MUFU.RCP")
    print(f"{name} SASS: {len(ins)} instructions, "
          f"{sum(op.startswith('MUFU.RCP') for _, op, _ in ins)} x MUFU.RCP, "
          f"{sum(op.startswith('MUFU.RSQ') for _, op, _ in ins)} x MUFU.RSQ, "
          f"{len(fchk)} x FCHK; {len(calls)} slow-path CALLs to {held}; "
          f"pair loops "
          f"{[f'0x{lo:x}-0x{hi:x}' for lo, hi in pair_loops]} hold "
          f"{len(inside)} of them", flush=True)
    if not pair_loops:
        fail("no pair loop found in K3's SASS")
    if fchk or inside:
        fail("K3's SASS holds a division check or a slow-path call in its "
             "pair loop")


def k3_ptxas():
    """Registers, shared memory, stack and spills of each of K3's instances
    from the build's ptxas -v output; fails on any stack frame or spill
    (local memory)."""
    import re

    from pointnetgpd_tpu_torch import _build

    log = _build.ptxas_log or (_build.BUILD_DIR / "ptxas.log").read_text()
    lines = log.splitlines()
    starts = [i for i, ln in enumerate(lines) if "Compiling entry" in ln
              and "point_triangle_kernel" in ln]
    if not starts:
        fail("no ptxas report for point_triangle_kernel")
    for start in starts:
        part = []
        for ln in lines[start + 1:]:
            if "Compiling entry" in ln or ln.startswith("=="):
                break
            part.append(ln)
        text = " ".join(part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", text)
        regs = re.search(r"Used (\d+) registers", text)
        smem = re.search(r"(\d+) bytes smem", text)
        entry = re.search(r"entry function '([^']+)'", lines[start])
        if not (frame and regs):
            fail(f"cannot read K3's ptxas report: {text}")
        stack, st, ld = (int(g) for g in frame.groups())
        print(f"K3 ptxas, {entry.group(1) if entry else lines[start]}: "
              f"{regs.group(1)} registers, "
              f"{smem.group(1) if smem else 0} bytes static shared memory "
              f"(+ 8 bytes per supertile up to 16,384, dynamic), stack frame "
              f"{stack} bytes, spill stores {st} bytes, spill loads {ld} "
              f"bytes", flush=True)
        if stack or st or ld:
            fail("K3 uses local memory")


def _kernel_modules():
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import point_triangle as k3
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2

    return {"gpg_counts": k1, "pointnet_trunk": k2, "point_triangle": k3}


def zero_counts():
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_counts():
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def with_plain_k3(fn):
    """fn() with K3 swapped for its plain version (on any device)."""
    from pointnetgpd_tpu_torch.ops import point_triangle as k3

    launch3 = k3._launch
    k3._launch = k3.min_point_triangle_dist2_torch
    try:
        return fn()
    finally:
        k3._launch = launch3


def torus_mesh(nu, nv, big_r, small_r):
    """Watertight, non-convex torus of 2 * nu * nv triangles, outward
    winding, vertices on the analytic surface."""
    u = 2 * np.pi * np.arange(nu) / nu
    w = 2 * np.pi * np.arange(nv) / nv
    uu, ww = np.meshgrid(u, w, indexing="ij")
    ring = big_r + small_r * np.cos(ww)
    v = np.stack([ring * np.cos(uu), ring * np.sin(uu),
                  small_r * np.sin(ww)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a, b = i * nv + j, (i + 1) % nu * nv + j
    c, d = (i + 1) % nu * nv + (j + 1) % nv, i * nv + (j + 1) % nv
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([a, c, d], -1).reshape(-1, 3)])
    return v, f.astype(np.int32)


def box_mesh(lo, hi):
    v = np.array([[x, y, z] for x in (lo[0], hi[0])
                  for y in (lo[1], hi[1]) for z in (lo[2], hi[2])], float)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def torus_sdf(points, big_r, small_r):
    q = np.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2) - big_r
    return np.sqrt(q ** 2 + points[..., 2] ** 2) - small_r


def grid_world(sdf):
    """(nx, ny, nz, 3) float64 world coordinates of an SdfGrid's cells."""
    o = sdf.origin.cpu().numpy().astype(np.float64)
    res = float(sdf.resolution)
    idx = [np.arange(n) for n in sdf.dims]
    return o + res * np.stack(np.meshgrid(*idx, indexing="ij"), axis=-1)


def close_distances(got, want):
    """(all within K3_TOL, max |got - want|) for two distance tensors."""
    rtol, atol = K3_TOL
    diff = (got - want).abs()
    return bool((diff <= atol + rtol * want.abs()).all()), float(diff.max())


def exact_distance_f64(torch, pts, tv):
    """(P,) float64 distance from points (P, 3) to triangles (F, 3, 3),
    robust to degenerate ones and independent of the port's arithmetic: the
    nearest of the three edges, or of the plane where the projection falls
    inside a triangle of non-zero area."""
    p = pts.double()[:, None]
    a, b, c = (tv.double()[None, :, k] for k in range(3))

    def segment(u, w):
        uw = w - u
        ll = (uw * uw).sum(-1)
        t = (((p - u) * uw).sum(-1) / torch.where(ll > 0, ll, 1.0)).clamp(0, 1)
        return torch.linalg.norm(p - (u + t[..., None] * uw), dim=-1)

    d = torch.minimum(torch.minimum(segment(a, b), segment(b, c)),
                      segment(c, a))
    n = torch.linalg.cross(b - a, c - a)
    nn = (n * n).sum(-1)
    ok = nn > 1e-30
    h = ((p - a) * n).sum(-1) / torch.where(ok, nn, 1.0)
    q = p - h[..., None] * n
    inside = ok
    for u, w in ((a, b), (b, c), (c, a)):
        inside = inside & ((torch.linalg.cross((w - u).expand_as(q), q - u)
                            * n).sum(-1) >= 0)
    face = torch.minimum(d, h.abs() * nn.sqrt())
    return torch.where(inside, face, d).amin(dim=1)


def k3_edge_cases(torch, k3, launch3, dev):
    """K3 where its walk and body have edges, to K3_TOL: one supertile;
    all-padding supertiles before and after the real ones; a block 10 m
    from the mesh (each against its plain version); degenerate triangles
    (a == b, b == c, points, collinear) against a float64 distance
    (``exact_distance_f64``), since the plain version, the JAX oracle's
    closest point, puts a segment with b == c at vertex b (ROADMAP Queue
    C); its gap to the float64 distance is printed beside."""
    rs = np.random.RandomState(7)
    grid, _ = k3.blocked_grid(8, 8, 16, [-0.02, -0.02, -0.04], 0.005)
    tv0 = ((rs.rand(1000, 3, 3) - 0.5) * 0.1).astype(np.float32)
    for case in ("one supertile", "all-padding supertiles", "far block",
                 "degenerate triangles"):
        pts, tv = grid, tv0.copy()
        if case == "one supertile":
            tv = tv[:100]
        elif case == "far block":
            pts = grid + np.float32(10.0)
        elif case == "degenerate triangles":
            tv[0::4, 1] = tv[0::4, 0]
            tv[1::4, 2] = tv[1::4, 1]
            tv[2::4] = tv[2::4, :1]
            tv[3::4, 2] = 0.3 * tv[3::4, 0] + 0.7 * tv[3::4, 1]
        tri_data, sup_data = k3.pack_triangles(tv)
        if case == "all-padding supertiles":
            pad_t = np.zeros((k3.SUPER, 16), np.float32)
            pad_t[:, 0:9] = k3._FAR
            pad_s = np.zeros((1, 8), np.float32)
            pad_s[:, 0:3] = k3._FAR
            tri_data = np.concatenate([pad_t, tri_data, pad_t, pad_t])
            sup_data = np.concatenate([pad_s, sup_data, pad_s, pad_s])
        args = [torch.from_numpy(a).to(dev) for a in (pts, tri_data, sup_data)]
        got = launch3(*args).sqrt()
        plain = k3.min_point_triangle_dist2_torch(*args).sqrt()
        if case == "degenerate triangles":
            want = exact_distance_f64(torch, args[0],
                                      torch.from_numpy(tv).to(dev))
            against = "float64 distance"
        else:
            want, against = plain, "plain"
        torch.cuda.synchronize()
        ok, err = close_distances(got, want)
        extra = ""
        if case == "degenerate triangles":
            extra = (f"; |plain - float64| = "
                     f"{float((plain - want).abs().max()):.3e} m")
        print(f"K3 edge case, {case} ({tri_data.shape[0]} rows, "
              f"{sup_data.shape[0]} supertiles, {pts.shape[0]} points): max "
              f"|kernel - {against}| = {err:.3e} m{extra}", flush=True)
        if not ok or not torch.isfinite(got).all():
            fail(f"K3 disagrees with its {against}: {case}")


def voxelizer_phases(torch, card):
    """Phase 7: the voxelizer path (see the module docstring). Returns the
    ``point_triangle`` entry of the kernels line."""
    import tempfile

    from pointnetgpd_tpu_torch.database.mesh_processor import MeshProcessor
    from pointnetgpd_tpu_torch.geometry.decomposition import (
        approximate_convex_decomposition)
    from pointnetgpd_tpu_torch.geometry.io import (read_sdf, write_obj,
                                                   write_sdf)
    from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
    vox = importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")
    from pointnetgpd_tpu_torch.ops import point_triangle as k3
    from pointnetgpd_tpu_torch.pipelines.prepare_objects import (
        prepare_object_dir)

    dev = torch.device("cuda")
    launch3, parity = k3._launch, vox._inside_parity
    plain3 = k3.min_point_triangle_dist2_torch

    with tempfile.TemporaryDirectory() as tmp:
        # a. the entry point at the reference's settings
        v, f = torus_mesh(*TORUS)
        mesh = Mesh3D(v, f)
        obj_dir = os.path.join(tmp, "torus")
        os.makedirs(os.path.join(obj_dir, "google_512k"))
        write_obj(os.path.join(obj_dir, "google_512k", "nontextured.obj"),
                  v, f)
        rec = {}

        def rec3(points, tri_data, sup_data):
            out = launch3(points, tri_data, sup_data)
            rec["k3"] = (points, tri_data, sup_data, out)
            return out

        def rec_parity(cols, z0, res, tri_v, *, nz, **kw):
            rec["parity"] = (cols, z0, res, tri_v, nz)
            return parity(cols, z0, res, tri_v, nz=nz, **kw)

        k3._launch, vox._inside_parity = rec3, rec_parity
        try:
            zero_counts()
            t0 = time.perf_counter()
            sdf_path = prepare_object_dir(obj_dir, sdf_dim=100, sdf_padding=5)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            launches = read_counts()
        finally:
            k3._launch, vox._inside_parity = launch3, parity
        print(f"voxelizer path: prepare_object_dir(torus, 60,000 triangles, "
              f"sdf_dim=100, sdf_padding=5) {cold_s:.2f} s cold, launches "
              f"{launches}", flush=True)
        if launches != {"gpg_counts": 0, "pointnet_trunk": 0,
                        "point_triangle": 1}:
            fail("the voxelizer path must launch K3 once and K1, K2 never")
        sdf = read_sdf(sdf_path)
        res = float(sdf.resolution)
        data = sdf.data.cpu().numpy()
        analytic = torus_sdf(grid_world(sdf), *TORUS[2:])
        err = float(np.abs(data - analytic).max())
        far = np.abs(analytic) > 0.02 * res
        flips = int((np.sign(data[far]) != np.sign(analytic[far])).sum())
        print(f"torus SDF: dims {sdf.dims}, res {res:.6e} m, max |sdf - "
              f"analytic| = {err:.3e} m = {err / res:.4f} res (limit 0.02 "
              f"res), sign disagreements where |analytic| > 0.02 res: "
              f"{flips}, inside cells {int((data < 0).sum())}", flush=True)
        if sdf.dims != (100, 100, 100) or err > 0.02 * res or flips:
            fail("the torus SDF disagrees with the analytic SDF")

        # b. K3 against its plain version on 256 point blocks
        pts_b, tri_data, sup_data, d2 = rec["k3"]
        n_blocks = pts_b.shape[0] // k3.BLOCK_POINTS
        block_min = d2.reshape(n_blocks, -1).amin(dim=1)
        near = torch.argsort(block_min)[:128]
        rest = torch.ones(n_blocks, dtype=torch.bool, device=dev)
        rest[near] = False
        rest_idx = torch.nonzero(rest)[:, 0]
        spread = rest_idx[torch.linspace(0, len(rest_idx) - 1, 128,
                                         device=dev).long()]
        blocks = torch.cat([near, spread])
        sub = (blocks[:, None] * k3.BLOCK_POINTS
               + torch.arange(k3.BLOCK_POINTS, device=dev)).reshape(-1)
        pts_sub = pts_b[sub].contiguous()
        want = plain3(pts_sub, tri_data, sup_data)
        torch.cuda.synchronize()
        ok, k3_err = close_distances(d2[sub].sqrt(), want.sqrt())
        n_real = int((tri_data[:, 0].abs() < k3._FAR / 2).sum())
        print(f"K3 inputs: P={pts_b.shape[0]} grid points ({n_blocks} "
              f"blocks), {n_real} triangles in {sup_data.shape[0]} "
              f"supertiles; vs plain on 256 blocks (128 nearest the "
              f"surface, 128 spread): max |kernel - plain| = {k3_err:.3e} m "
              f"(rtol 1e-4, atol 1e-7)", flush=True)
        if not ok:
            fail("K3 disagrees with its plain version")
        k3_edge_cases(torch, k3, launch3, dev)

        # c. the whole route at dim 48 against its plain route
        got48 = vox.mesh_to_sdf(mesh, dim=48, padding=5, device=dev)
        plain48 = with_plain_k3(
            lambda: vox.mesh_to_sdf(mesh, dim=48, padding=5, device=dev))
        signs = bool(torch.equal(torch.signbit(got48.data),
                                 torch.signbit(plain48.data)))
        ok, e48 = close_distances(got48.data, plain48.data)
        print(f"mesh_to_sdf dim=48 vs its plain route: signs equal {signs}, "
              f"max |err| {e48:.3e} m", flush=True)
        if not (signs and ok):
            fail("mesh_to_sdf disagrees with its plain route at dim 48")

        # d. the other entry points
        lv = Mesh3D(*box_mesh([0, 0, 0], [2, 1, 1])).merge(
            Mesh3D(*box_mesh([0, 0, 1], [1, 1, 2])))
        zero_counts()
        t0 = time.perf_counter()
        pieces = approximate_convex_decomposition(lv)
        acd_s = time.perf_counter() - t0
        n_acd = read_counts()["point_triangle"]
        t0 = time.perf_counter()
        plain_pieces = with_plain_k3(
            lambda: approximate_convex_decomposition(lv))
        plain_acd_s = time.perf_counter() - t0
        same = len(pieces) == len(plain_pieces) and all(
            a.vertices.shape == b.vertices.shape
            and np.allclose(a.vertices, b.vertices, atol=1e-6)
            for a, b in zip(pieces, plain_pieces))
        print(f"approximate_convex_decomposition(L): {len(pieces)} pieces, "
              f"K3 launches {n_acd}, same as the plain route {same}; "
              f"{acd_s:.3f} s, the plain route's {plain_acd_s:.3f} s (host "
              f"clock) ({card})", flush=True)
        if n_acd != 1 or not same or len(pieces) < 2:
            fail("convex decomposition: K3 not launched once, or pieces "
                 "differ from the plain route")
        src = os.path.join(tmp, "cube.obj")
        write_obj(src, *box_mesh([0, 0, 0], [0.08, 0.08, 0.08]))
        config = {"obj_target_scale": 0.1, "obj_rescaling_type": "max"}
        zero_counts()
        _, psdf, poses = MeshProcessor(
            src, cache_dir=os.path.join(tmp, "c1")).generate_graspable(config)
        n_mp = read_counts()["point_triangle"]
        _, qsdf, qposes = with_plain_k3(lambda: MeshProcessor(
            src, cache_dir=os.path.join(tmp, "c2")).generate_graspable(
                config))
        ok, emp = close_distances(psdf.data, qsdf.data)
        same = (ok and torch.equal(torch.signbit(psdf.data),
                                   torch.signbit(qsdf.data))
                and len(poses) == len(qposes) == 6 and all(
                    a["p"] == b["p"] and np.array_equal(a["r"], b["r"])
                    for a, b in zip(poses, qposes)))
        print(f"MeshProcessor.generate_graspable(cube): sdf {psdf.dims}, "
              f"{len(poses)} stable poses, K3 launches {n_mp}, same as the "
              f"plain route {same} (max |sdf err| {emp:.3e} m)", flush=True)
        if n_mp != 1 or not same:
            fail("MeshProcessor: K3 not launched once, or results differ "
                 "from the plain route")

        # e. timings
        ms = cuda_ms(torch, lambda: launch3(pts_b, tri_data, sup_data),
                     iters=5, warm=1)
        plain_ms = cuda_ms(torch, lambda: plain3(pts_sub, tri_data,
                                                 sup_data), iters=2, warm=1)
        cols, z0, pres, tri_v, nz = rec["parity"]
        parity_ms = cuda_ms(torch, lambda: parity(cols, z0, pres, tri_v,
                                                  nz=nz), iters=5, warm=1)
        n_m2s = 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_m2s):
            warm = vox.mesh_to_sdf(mesh, dim=100, padding=5, device=dev)
        torch.cuda.synchronize()
        m2s_ms = (time.perf_counter() - t0) / n_m2s * 1e3
        tri_v_np = tri_v.cpu().numpy()
        host = {}
        t0 = time.perf_counter()
        k3.pack_triangles(tri_v_np)
        host["pack_triangles"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, unblock = k3.blocked_grid(100, 100, 100, warm.origin.cpu().numpy(),
                                     float(warm.resolution))
        unblock(d2).contiguous()
        torch.cuda.synchronize()
        host["blocked_grid + unblock"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        write_sdf(os.path.join(tmp, "timed.sdf"), warm)
        host["write_sdf (1M values)"] = (time.perf_counter() - t0) * 1e3

    # what each design needs under the final output. Supertile granular
    # (the TPU kernel's): the supertiles whose lower bound is below
    # sqrt(max d^2 of the block), plus the nearest, x 128 points x their
    # real triangles. This design: the (warp, triangle) pairs whose sphere
    # lies nearer the warp's slab box than the warp's final max distance,
    # x 32 points, plus one reject test per (warp, triangle) of each needed
    # supertile.
    db = k3.supertile_bounds(pts_b, sup_data)
    need = db < d2.reshape(n_blocks, -1).amax(dim=1).sqrt()[:, None]
    need[torch.arange(n_blocks, device=dev), db.argmin(dim=1)] = True
    n_sup = sup_data.shape[0]
    real = torch.clamp(n_real - k3.SUPER * torch.arange(n_sup, device=dev),
                       0, k3.SUPER).double()
    pairs_tile = float(k3.BLOCK_POINTS * (need.double() @ real).sum())
    ops_tile = pairs_tile * K3_OPS_PER_PAIR_TPU
    pairs = float(k3.warp_pairs_needed(pts_b, tri_data, d2).sum())
    tests = float(need.sum()) * (k3.BLOCK_POINTS // k3.WARP) * k3.SUPER
    ops = pairs * K3_OPS_PER_PAIR + tests * K3_OPS_PER_TEST
    nbytes = (pts_b.numel() + tri_data.numel() + sup_data.numel()
              + d2.numel()) * 4
    bound = max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_tile = max(ops_tile / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    by = "operations" if ops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES \
        else "bytes"
    per_block = need.sum(dim=1).double()

    # what each design does: this kernel counts its own walk in a separate
    # launch; the TPU kernel's walk (index order, every row of a visited
    # supertile) is counted in plain torch from the same inputs
    stats = torch.zeros((n_blocks, 2), dtype=torch.int32, device=dev)
    same = torch.equal(launch3(pts_b, tri_data, sup_data, stats=stats), d2)
    if not same or int(stats[:, 1].min()) < k3.WARP:
        fail("K3's counting launch differs from the main path's output")
    visited = stats[:, 0].double()
    evaluated = float(stats[:, 1].double().sum())
    t0 = time.perf_counter()
    _, tpu_visited, tpu_evaluated = k3.kernel_walk(
        pts_b, tri_data, sup_data, sorted_walk=False, warp_reject=False)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    tpu_visited = tpu_visited.double()
    print(f"K3 walk, supertiles per block (mean, max): visited "
          f"{float(visited.mean()):.2f}, {int(visited.max())}; needed "
          f"{float(per_block.mean()):.2f}, {int(per_block.max())}; the TPU "
          f"kernel's index-order walk would visit "
          f"{float(tpu_visited.mean()):.2f}, {int(tpu_visited.max())} (plain "
          f"torch, {walk_s:.1f} s)", flush=True)
    print(f"K3 point-triangle pairs: evaluated {evaluated:.4e} against "
          f"{pairs:.4e} needed by the per-warp reject (+ {tests:.4e} reject "
          f"tests); the TPU kernel's walk evaluates "
          f"{float(tpu_evaluated.sum()):.4e} "
          f"against {pairs_tile:.4e} needed by whole supertiles; "
          f"{pts_b.shape[0] * n_real:.4e} unpruned", flush=True)
    print(f"timings on {card}:", flush=True)
    print(f"  K3 alone, full size (P={pts_b.shape[0]}, {n_real} triangles): "
          f"{ms:.4f} ms per launch ({card})")
    print(f"  K3 plain version on the 256-block subset (32,768 points x "
          f"{n_real} triangles): {plain_ms:.3f} ms ({card})")
    print(f"  K3 bound {bound:.4f} ms ({by}; {pairs:.4e} pairs x "
          f"{K3_OPS_PER_PAIR} + {tests:.4e} tests x {K3_OPS_PER_TEST} = "
          f"{ops:.4e} ops; {nbytes} bytes), {100 * bound / ms:.1f}% of it; "
          f"the supertile-granular bound {bound_tile:.4f} ms "
          f"({pairs_tile:.4e} pairs x "
          f"{K3_OPS_PER_PAIR_TPU} ops), {100 * bound_tile / ms:.1f}% of it "
          f"({card})")
    print(f"  _inside_parity, full size (10,000 columns x 100 z): "
          f"{parity_ms:.3f} ms ({card})")
    print(f"  mesh_to_sdf, full size: {m2s_ms:.2f} ms warm per call (host "
          f"clock, {n_m2s} calls) ({card})")
    for name, t in host.items():
        print(f"  host {name}: {t:.2f} ms ({card})")
    print(flush=True)
    return {"name": "point_triangle", "route": "cuda",
            "source": "pointnetgpd_tpu_torch/csrc/point_triangle.cu",
            "replaces": "pointnetgpd_tpu/ops/point_triangle_pallas.py:225",
            "launches": launches["point_triangle"],
            "launches_by_path": {"voxelizer": launches["point_triangle"],
                                 "decomposition": n_acd,
                                 "mesh_processor": n_mp},
            "max_abs_err": k3_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def k3_above_cap(torch, card, dev="cuda", nu=1500, nv=720):
    """Phase 7f: K3 on a torus of 2 nu nv = 2,160,000 triangles (16,875
    supertiles, above the 16,384 it sorts at a time): the chunked walk on
    16 point blocks against the brute force, its counts and time."""
    from pointnetgpd_tpu_torch.ops import point_triangle as k3

    dev = torch.device(dev)
    launch3 = k3._launch
    v, f = torus_mesh(nu, nv, *TORUS[2:])
    t0 = time.perf_counter()
    tri_data, sup_data = k3.pack_triangles(v[f].astype(np.float32))
    pack_s = time.perf_counter() - t0
    n_sup = sup_data.shape[0]
    if n_sup <= k3.SORT_CHUNK:
        fail("the torus does not exceed the sort chunk")
    # candidate blocks near the surface; keep the 8 nearest the boundary
    # between the two chunks (both chunks hold a near supertile) and 8
    # spread over the rest
    res = 0.15 / 96
    grid, _ = k3.blocked_grid(96, 96, 24, [-0.075, -0.075, -0.025], res)
    blocks = grid.reshape(-1, k3.BLOCK_POINTS, 3)
    near = np.abs(torus_sdf(blocks.mean(axis=1).astype(np.float64),
                            *TORUS[2:])) < 4 * res
    cand = torch.from_numpy(np.ascontiguousarray(blocks[near])).to(dev)
    tri_d = torch.from_numpy(tri_data).to(dev)
    sup_d = torch.from_numpy(sup_data).to(dev)
    db = k3.supertile_bounds(cand.reshape(-1, 3), sup_d)
    lo0 = db[:, :k3.SORT_CHUNK].amin(dim=1)
    lo1 = db[:, k3.SORT_CHUNK:].amin(dim=1)
    straddle = torch.argsort(torch.maximum(lo0, lo1))[:8]
    rest = torch.ones(cand.shape[0], dtype=torch.bool, device=dev)
    rest[straddle] = False
    rest_idx = torch.nonzero(rest)[:, 0]
    spread = rest_idx[torch.linspace(0, len(rest_idx) - 1, 8,
                                     device=dev).long()]
    pts = cand[torch.cat([straddle, spread])].reshape(-1, 3).contiguous()
    got = launch3(pts, tri_d, sup_d)
    want = k3.min_point_triangle_dist2_torch(pts, tri_d, sup_d)
    torch.cuda.synchronize()
    ok, err = close_distances(got.sqrt(), want.sqrt())
    stats = torch.zeros((16, 2), dtype=torch.int32, device=dev)
    same = torch.equal(launch3(pts, tri_d, sup_d, stats=stats), got)
    ms = cuda_ms(torch, lambda: launch3(pts, tri_d, sup_d), iters=5, warm=1)
    # what each block needs under its final distance, per chunk
    dbp = k3.supertile_bounds(pts, sup_d)
    need = dbp < got.reshape(16, -1).amax(dim=1).sqrt()[:, None]
    both = int((need[:, :k3.SORT_CHUNK].any(dim=1)
                & need[:, k3.SORT_CHUNK:].any(dim=1)).sum())
    _, walk_visited, _ = k3.kernel_walk(pts, tri_d, sup_d,
                                        sort_chunk=k3.SORT_CHUNK)
    print(f"K3 above the old cap: {f.shape[0]} triangles in {n_sup} "
          f"supertiles (chunks of {k3.SORT_CHUNK}; pack_triangles "
          f"{pack_s:.2f} s on the host), 16 blocks ({both} need supertiles "
          f"of both chunks): max |kernel - brute force| = {err:.3e} m "
          f"(rtol 1e-4, atol 1e-7); supertiles visited per block "
          f"{stats[:, 0].tolist()} (the plain-torch chunked walk "
          f"{walk_visited.tolist()}), pairs evaluated "
          f"{int(stats[:, 1].sum())}; {ms:.4f} ms per launch ({card})",
          flush=True)
    if not ok or not same or not torch.isfinite(got).all():
        fail("K3 disagrees with the brute force above the old cap")


class ReplayDraws:
    """The training crop's draws (``crop_perm``, ``crop_windows``) made
    once by a seeded ``draws.Draws`` on the CPU and replayed in the same
    order after ``rewind()``: a step on the card and one on the CPU, or two
    variants of a step, take the same numbers."""

    def __init__(self, seed):
        from pointnetgpd_tpu_torch.draws import Draws

        self.src, self.log, self.pos = Draws(seed), [], None

    def rewind(self):
        self.pos = 0
        return self

    def _get(self, make):
        if self.pos is None:
            self.log.append(make())
            return self.log[-1]
        self.pos += 1
        return self.log[self.pos - 1]

    def crop_perm(self, p):
        return self._get(lambda: self.src.crop_perm(p))

    def crop_windows(self, count, num_out):
        return self._get(lambda: self.src.crop_windows(count.cpu(), num_out))


def float64_step(torch, model, batch, draws, num_points):
    """The step's loss and gradients in float64 on the CPU, on the same crop
    (``draws`` replayed): the reference both float32 steps are held to."""
    import copy

    from pointnetgpd_tpu_torch.ops.crop import collect_grasp_clouds_batched
    from pointnetgpd_tpu_torch.training.train import masked_nll_loss

    g, c, t, labels, weights = batch
    cropped, _, valid = collect_grasp_clouds_batched(g, c, t, draws,
                                                     num_out=num_points)
    m64 = copy.deepcopy(model).cpu().double().train()
    logp = m64(cropped.double())[0]
    loss = masked_nll_loss(logp, labels, weights.double() * valid)
    loss.backward()
    return float(loss), {n: p.grad for n, p in m64.named_parameters()}


def compare_steps(torch, name, a, b, ref64):
    """Two float32 TrainStates after the same step, each against the
    float64 step ``ref64`` = (loss, grads): the losses within 1e-5 relative
    of each other; a's largest gradient error (over max|g| of the float64
    step) at most twice b's plus 1e-4, so a is as exact as b; the biases
    that a train-mode BatchNorm absorbs (zero in float64) within 1e-3 x
    max|g| of noise on both; running statistics within 1e-5. Returns the
    errors (a vs float64, b vs float64, a vs b)."""
    (sa, ma), (sb, mb) = a, b
    la, lb = float(ma["loss"]), float(mb["loss"])
    loss64, g64 = ref64
    g_max = max(float(g.abs().max()) for g in g64.values())
    absorbed = {n for n, g in g64.items()
                if float(g.abs().max()) < 1e-10 * g_max}
    pa = dict(sa.model.named_parameters())
    pb = dict(sb.model.named_parameters())
    err = {"a": (0.0, ""), "b": (0.0, ""), "ab": (0.0, "")}
    noisy = []
    for n, g in g64.items():
        ga, gb = pa[n].grad.double().cpu(), pb[n].grad.double().cpu()
        if n in absorbed:
            if max(float(ga.abs().max()), float(gb.abs().max())) > \
                    1e-3 * g_max:
                noisy.append(n)
            continue
        for k, d in (("a", ga - g), ("b", gb - g), ("ab", ga - gb)):
            e = float(d.abs().max()) / g_max
            if e > err[k][0]:
                err[k] = (e, n)
    ba = {k: v for k, v in sa.model.state_dict().items() if "running" in k}
    bb = {k: v for k, v in sb.model.state_dict().items() if "running" in k}
    e_bn = max(float((ba[k].cpu() - bb[k].cpu()).abs().max()) for k in bb)
    print(f"{name}: loss {la:.7f} vs {lb:.7f} (rel {abs(la - lb) / lb:.2e}, "
          f"limit 1e-5; float64 {loss64:.7f}); largest gradient error over "
          f"max|g| against float64: {err['a'][0]:.2e} ({err['a'][1]}) vs "
          f"{err['b'][0]:.2e} ({err['b'][1]}), between them "
          f"{err['ab'][0]:.2e} ({err['ab'][1]}); {len(absorbed)} absorbed "
          f"biases at noise; BN statistics {e_bn:.2e} (1e-5)", flush=True)
    if (abs(la - lb) > 1e-5 * abs(lb) or noisy or e_bn > 1e-5
            or err["a"][0] > 2 * err["b"][0] + 1e-4):
        fail(f"{name}: steps disagree (noisy {noisy[:4]})")
    return err["a"][0], err["b"][0], err["ab"][0]


def device_busy(torch, prof, skip=()):
    """(busy us, summed us, the events) of the device activity in a
    profile: the events that ran on the card (kernels, copies, memsets),
    not the host ops that launched them and not the ``skip`` labels, which
    also appear as device-side ranges; busy is the union of their
    intervals."""
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith(skip)]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
    busy = total = 0.0
    end = -float("inf")
    for a, b in spans:
        total += b - a
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, total, dev_events


def training_phases(torch, card, profile, dev="cuda", batch=128,
                    cloud=20000, keep_dir=None):
    """Phase 8: the trainer at the 1v variant's full width (see the module
    docstring): TrainConfig's defaults, ``batch`` samples of ``cloud``-point
    clouds. Returns the K2 numbers at the trainer's eval shape, the
    directory ``fit`` wrote its checkpoints to (under ``keep_dir``, which
    outlives the phase, where given) and the trained model."""
    import copy
    import tempfile

    from pointnetgpd_tpu_torch.cli import train as cli
    from pointnetgpd_tpu_torch.draws import Draws
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.ops.crop import collect_grasp_clouds_batched
    from pointnetgpd_tpu_torch.training import train as ttrain
    from pointnetgpd_tpu_torch.training.data import SyntheticGraspData
    from pointnetgpd_tpu_torch.training.loop import TrainConfig, Trainer

    dev = torch.device(dev)
    launch2 = k2._launch
    with tempfile.TemporaryDirectory() as tmp:
        # a. fit: 2 epochs x 5 steps, 2 eval batches per epoch
        cfg = TrainConfig(epochs=2, steps_per_epoch=5, eval_steps=2,
                          log_interval=5, batch_size=batch, device=dev.type,
                          model_path=os.path.join(keep_dir or tmp, "m"),
                          log_dir=os.path.join(tmp, "l"), tag="smoke")
        n_pts = cfg.grasp_points_num
        data = SyntheticGraspData(batch, cloud_points=cloud, learnable=True,
                                  seed=0)
        held = SyntheticGraspData(batch, cloud_points=cloud, learnable=True,
                                  seed=1)
        tr = Trainer(cfg, data, held)
        before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
        rec = []

        def rec2(x, folded):
            rec.append((x, folded))
            return launch2(x, folded)

        k2._launch = rec2
        try:
            zero_counts()
            t0 = time.perf_counter()
            tr.fit()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = read_counts()
        finally:
            k2._launch = launch2
        losses = [json.loads(ln)["value"] for ln in open(os.path.join(
            tr.logger.dir, "metrics.jsonl")) if '"train_loss"' in ln]
        after = tr.state.model.state_dict()
        finite = all(torch.isfinite(v.float()).all() for v in after.values())
        moved = [k for k in after if not torch.equal(before[k], after[k])]
        n_params = sum(1 for k in after if "running" not in k
                       and "num_batches" not in k)
        moved_p = sum(1 for k in moved if "running" not in k
                      and "num_batches" not in k)
        moved_bn = sum(1 for k in moved if "running" in k)
        n_eval = cfg.eval_steps * cfg.epochs
        print(f"training path: Trainer.fit (1v: k={cfg.num_classes}, "
              f"{n_pts} points, batch {batch}, lr {cfg.lr}, {cloud}-point "
              f"clouds), {cfg.epochs} epochs x "
              f"{cfg.steps_per_epoch} steps + {cfg.eval_steps} eval batches "
              f"each: {fit_s:.2f} s cold, launches {launches}; train losses "
              f"{[round(v, 4) for v in losses]}; {moved_p} of {n_params} "
              f"parameters and {moved_bn} running statistics changed; "
              f"finite {finite}", flush=True)
        if launches != {"gpg_counts": 0, "pointnet_trunk": 2 * n_eval,
                        "point_triangle": 0}:
            fail("the eval pass must launch K2 twice per batch, and the "
                 "training path K1 and K3 never")
        if not (finite and np.isfinite(losses).all() and moved_p == n_params
                and moved_bn > 0):
            fail("training left non-finite or unchanged parameters")
        if any(tuple(x.shape) != (batch, n_pts, 3) for x, _ in rec):
            fail("K2 ran at another shape than the eval batch's")

        # b. K2 at the eval pass's shape against its plain version
        x_eval, folded = rec[-1]
        got = launch2(x_eval, folded)
        want = k2.trunk_reference(x_eval, folded)
        torch.cuda.synchronize()
        k2_err = float((got - want).abs().max())
        if bool(((got - want).abs() > K2_TOL * (1 + want.abs())).any()):
            fail(f"K2 disagrees with its plain version at {batch}x{n_pts}")
        w1, b1, w2, b2, w3, b3 = folded

        def library():
            h = torch.relu(torch.matmul(x_eval, w1) + b1)
            h = torch.relu(torch.matmul(h, w2) + b2)
            return torch.amax(torch.matmul(h, w3) + b3, dim=1)

        k2_ms = cuda_ms(torch, lambda: launch2(x_eval, folded), iters=50)
        k2_plain = cuda_ms(torch, lambda: k2.trunk_reference(x_eval, folded),
                           iters=20)
        k2_lib = cuda_ms(torch, library, iters=20)
        k2_bound = k2_bounds(batch, n_pts)[0]
        print(f"K2 at the eval pass's ({batch}, {n_pts}), on the last eval "
              f"batch's "
              f"feature trunk: max |kernel - plain| = {k2_err:.3e} "
              f"(1e-4 * (1 + |plain|)); {k2_ms:.4f} ms, plain "
              f"{k2_plain:.4f} ms, library {k2_lib:.4f} ms, bound "
              f"{k2_bound:.5f} ms (3xTF32, operations), "
              f"{100 * k2_bound / k2_ms:.1f}% of it ({card})", flush=True)

        # c. the checkpoint fit wrote loads into the scorer, which then
        # predicts as evaluate does
        path = os.path.join(cfg.model_path,
                            f"step_{cfg.epochs * cfg.steps_per_epoch}")
        scorer = GraspScorer.from_checkpoint(path, device=dev)
        g, c, t, lab, w = tr._to_device(held.next_batch())
        cropped, _, _ = collect_grasp_clouds_batched(
            g, c, t, Draws(7, dev), num_out=n_pts)
        with torch.no_grad():
            want = tr.state.model.eval()(cropped)[0]
            got = scorer.model(cropped)[0]
        same = torch.equal(got.argmax(-1), want.argmax(-1))
        e_ck = float((got - want).abs().max())
        print(f"checkpoint {os.path.basename(path)} -> GraspScorer."
              f"from_checkpoint: predictions equal {same}, max |logp err| "
              f"{e_ck:.2e}", flush=True)
        if not same or e_ck > 1e-6:
            fail("the scorer does not reproduce the trained model")
        trained = copy.deepcopy(tr.state.model).eval()
        tr.close()

        # d. one step on the card against the same step on the CPU
        torch.manual_seed(0)
        base = PointNetCls(k=2)
        batch_np = SyntheticGraspData(batch, cloud_points=cloud,
                                      learnable=True, seed=5).next_batch()
        step = ttrain.make_fused_train_step(num_points=n_pts)
        draws = ReplayDraws(11)
        out = {}
        for where in ("cpu", dev.type):
            model = copy.deepcopy(base).to(where)
            st = ttrain.init_train_state(model, ttrain.make_optimizer(0.005))
            args = [torch.as_tensor(a).to(where) for a in batch_np]
            args[3], args[4] = args[3].long(), args[4].float()
            out[where] = step(st, *args, draws)
            draws.rewind()
            if where == "cpu":
                ref64 = float64_step(torch, base, args, draws, n_pts)
                draws.rewind()
        compare_steps(torch, "train step, card vs CPU (same weights and "
                      "draws)", out[dev.type], out["cpu"], ref64)
        batch_d = [torch.as_tensor(a).to(dev) for a in batch_np]
        batch_d[3], batch_d[4] = batch_d[3].long(), batch_d[4].float()
        st_f = ttrain.init_train_state(copy.deepcopy(base).to(dev),
                                       ttrain.make_optimizer(0.005))
        fused = ttrain.make_fused_train_step(num_points=n_pts,
                                             fused_maxpool=True)
        compare_steps(torch, "fused_maxpool step vs the unfused one on the "
                      "card", fused(st_f, *batch_d, draws.rewind()),
                      out[dev.type], ref64)

        # e. the other variants through the CLI, on the card by default
        for variant in ("1v_mc", "1v_gpd"):
            t0 = time.perf_counter()
            argv = ["--variant", variant, "--mode", "train", "--synthetic",
                    "--epoch", "1", "--steps-per-epoch", "1",
                    "--eval-steps", "1", "--batch-size", str(batch),
                    "--cloud-points", str(cloud),
                    "--model-path", os.path.join(tmp, variant),
                    "--log-dir", os.path.join(tmp, "l")]
            # on the card by default: --device only where it is not
            rc = cli.main(argv if dev.type == "cuda" else
                          argv + ["--device", dev.type])
            torch.cuda.synchronize()
            sd = torch.load(os.path.join(tmp, variant, "step_1", "model.pt"))
            k = (sd["fc3.weight"] if "fc3.weight" in sd
                 else sd["fc2.weight"]).shape[0]
            ok = rc == 0 and all(torch.isfinite(v.float()).all()
                                 for v in sd.values())
            print(f"cli.train --variant {variant} --mode train --synthetic "
                  f"(1 step + 1 eval batch, batch {batch}): rc {rc}, {k} "
                  f"classes, finite {ok}, {time.perf_counter() - t0:.2f} s "
                  f"cold", flush=True)
            if not ok:
                fail(f"the {variant} variant did not train")

        # f. timings: warm steps, CUDA events over 10 steps each
        timing = {}
        for name, kw in (("fp32", {}),
                         ("bf16", {"compute_dtype": torch.bfloat16}),
                         ("fused_maxpool", {"fused_maxpool": True})):
            st = ttrain.init_train_state(copy.deepcopy(base).to(dev),
                                         ttrain.make_optimizer(0.005))
            fn = ttrain.make_fused_train_step(num_points=n_pts, **kw)
            d = Draws(3, dev)
            torch.cuda.reset_peak_memory_stats()
            timing[name] = cuda_ms(torch, lambda: fn(st, *batch_d, d),
                                   iters=10, warm=2)
            timing[name + "_mem"] = torch.cuda.max_memory_allocated()
        gcfg = cli.VARIANTS["1v_gpd"]
        gtr = Trainer(TrainConfig(gpd=True, lr=gcfg["lr"], batch_size=batch,
                                  device=dev.type,
                                  log_dir=os.path.join(tmp, "l"),
                                  model_path=os.path.join(tmp, "g")), data)
        d = Draws(4, dev)
        timing["gpd"] = cuda_ms(torch, lambda: gtr.train_step(
            gtr.state, *batch_d, d), iters=3, warm=1)
        gtr.close()
        print(f"timings on {card}:", flush=True)
        for name in ("fp32", "bf16", "fused_maxpool"):
            print(f"  train step, {name}: {timing[name]:.2f} ms warm per "
                  f"step (CUDA events, 10 steps, crop + forward + backward "
                  f"+ Adam), {batch * 1e3 / timing[name]:.0f} samples/s, peak "
                  f"{timing[name + '_mem'] / 2**30:.2f} GiB allocated "
                  f"({card})")
        print(f"  GPD train step (1v_gpd, batch {batch}, {n_pts} points, "
              f"3 channels): {timing['gpd']:.2f} ms warm per step (CUDA "
              f"events, 3 steps) ({card})", flush=True)

        if profile:
            from torch.autograd.profiler import record_function
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            st = ttrain.init_train_state(copy.deepcopy(base).to(dev),
                                         ttrain.make_optimizer(0.005))
            fn = ttrain.make_fused_train_step(num_points=n_pts)
            ev = ttrain.make_eval_step()
            d = Draws(5, dev)
            fn(st, *batch_d, d)
            torch.cuda.synchronize()
            with prof_ctx(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(st, *batch_d, d)
                with record_function("eval.crop"):
                    cropped, _, valid = collect_grasp_clouds_batched(
                        *batch_d[:3], d, num_out=n_pts)
                ev(st.model, cropped, batch_d[3], batch_d[4] * valid)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e6
            busy, total, evs = device_busy(torch, prof, skip=("train.",
                                                              "eval."))
            print(f"profile (one train step + one eval batch, {card}): "
                  f"wall {wall / 1e3:.2f} ms, device busy {busy / 1e3:.3f} "
                  f"ms ({100 * busy / wall:.1f}%; {len(evs)} device events, "
                  f"{total / 1e3:.3f} ms summed)")
            for e in sorted(prof.key_averages(), key=lambda e: e.key):
                if e.key.split(".")[0] in ("train", "eval") \
                        and e.cpu_time_total > 0:
                    print(f"  span {e.key}: host {e.cpu_time_total / 1e3:.2f}"
                          f" ms")
    print(flush=True)
    return {"eval_launches": launches["pointnet_trunk"], "ms": k2_ms,
            "plain_ms": k2_plain, "library_ms": k2_lib, "bound_ms": k2_bound,
            "err": k2_err, "model_path": cfg.model_path, "model": trained}


class Tape:
    """One generator's draws, recorded on the first route that asks and
    replayed, call for call, to every later route (``rewind``), so the card
    route and the CPU route see the same numbers; ``rewind(1)`` and
    ``rewind(-1)`` replay every float draw moved by one ulp up or down.
    Each sampling round takes the same tape (``next_round``), as the
    default ``Draws`` does."""

    def __init__(self, seed):
        from pointnetgpd_tpu_torch.draws import Draws

        self.src = Draws(seed, "cpu")
        self.log, self.replay, self.step = [], None, 0

    def rewind(self, step=0):
        self.replay, self.step = list(self.log), step
        return self

    def next_round(self):
        return self

    def _moved(self, out):
        import torch

        if isinstance(out, tuple):
            return tuple(self._moved(o) for o in out)
        if self.step == 0 or not out.is_floating_point():
            return out
        return torch.nextafter(out, torch.full_like(
            out, math.copysign(math.inf, self.step)))

    def __getattr__(self, name):
        def call(*args):
            if self.replay is None:
                out = getattr(self.src, name)(*args)
                self.log.append((name, args, out))
                return out
            if not self.replay or self.replay[0][:2] != (name, args):
                fail(f"draw {name}{args} out of order on replay")
            return self._moved(self.replay.pop(0)[2])
        return call


def nudged_sdfs(sdf, device):
    """The SDF with its values, its origin or its resolution moved by one
    ulp either way, on ``device``: a lane whose result moves under these is decided by
    float32 rounding (an ill-conditioned zero crossing, an axis between two
    nearly equal contacts, coplanar friction-cone edges)."""
    from pointnetgpd_tpu_torch.geometry.sdf import make_sdf

    data = sdf.data.cpu().numpy()
    o = sdf.origin.cpu().numpy()
    res = float(sdf.resolution)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    r32 = np.float32(res)
    return ([make_sdf(np.nextafter(data, s), o, res, device=device)
             for s in (up, down)]
            + [make_sdf(data, np.nextafter(o, s), res, device=device)
               for s in (up, down)]
            + [make_sdf(data, o, np.nextafter(r32, s), device=device)
               for s in (up, down)])


def masked(d, base, mask_key):
    """``d`` with the continuous fields of lanes ``base[mask_key]`` rejects
    set to 0 (a rejected attempt's geometry is not compared)."""
    if mask_key is None:
        return d
    keep = base[mask_key]
    o = dict(d)
    for k in ("configs", "contacts"):
        if k in o:
            o[k] = np.where(keep.reshape((-1,) + (1,) * (o[k].ndim - 1)),
                            o[k], 0)
    return o


def lane_diff(a, b, discrete):
    """(G,) lanes where two results differ: any field of ``discrete`` not
    equal, or a continuous field beyond LABEL_TOL x (1 + |b|)."""
    g = len(next(iter(a.values())))
    out = np.zeros(g, bool)
    if g == 0:
        return out
    for k in a:
        x = np.asarray(a[k]).reshape(g, -1)
        y = np.asarray(b[k]).reshape(g, -1)
        if k in discrete:
            out |= (x != y).any(axis=1)
        else:
            tol = (LABEL_TOL if k in ("configs", "contacts", "center_sdf")
                   else EPS_RTOL) * (1 + np.abs(y)) + (
                0 if k in ("configs", "contacts", "center_sdf") else EPS_ATOL)
            bad = np.abs(x - y) > tol
            bad &= ~(np.isnan(x) & np.isnan(y))
            out |= bad.any(axis=1)
    return out


def fc_margin(contacts, normals, mus):
    """(G,) least relative distance, in float64, of the closure angle of
    either contact to arctan(mu) over the ladder ``mus``: the deciding
    quantity of a force-closure flag (quality.py:129-149)."""
    p = np.asarray(contacts, np.float64)
    n = np.asarray(normals, np.float64)
    d = p[:, 1] - p[:, 0]
    dist = np.maximum(np.linalg.norm(d, axis=1), 1e-16)
    out = np.full(len(p), np.inf)
    for k, diff in ((0, d), (1, -d)):
        proj = np.abs(np.sum(-n[:, k] * diff, axis=1)) / np.maximum(
            np.linalg.norm(n[:, k], axis=1), 1e-16)
        ang = np.arccos(np.clip(proj / dist, -1, 1))
        for mu in mus:
            out = np.minimum(out, np.abs(ang - np.arctan(mu)) / np.arctan(mu))
    return out


def hold_routes(problems, name, card, cpu, unstable, discrete, margin=None):
    """Hold a card result to the CPU route's lane by lane (dicts of (G, ...)
    arrays). A lane that differs passes only when its deciding quantity
    lies within 1e-5 relative of its threshold (``margin``, float64 on the
    CPU) or the CPU route itself moves on it under a one-ulp change of the
    SDF or of the draws (``unstable``, from the CPU route's runs only); at
    most 10% of the lanes may need either. A failed hold is added to
    ``problems``, which fails the phase at its end. Returns (lanes
    differing, by margin, by rounding)."""
    diff = lane_diff(card, cpu, discrete)
    near = diff & (margin <= 1e-5) if margin is not None else diff & False
    rounding = diff & ~near & unstable
    left = diff & ~near & ~rounding
    g = len(diff)
    print(f"{name}: {g} lanes, {int(diff.sum())} differ card vs CPU route: "
          f"{int(near.sum())} within 1e-5 relative of a threshold (float64 "
          f"margin on the CPU), {int(rounding.sum())} decided by rounding "
          f"(the CPU route moves on them under a one-ulp change of the SDF "
          f"or of the draws; {int(unstable.sum())} such lanes in all), "
          f"{int(left.sum())} unexplained", flush=True)
    for i in np.where(left)[0][:3]:
        fields = {k: (np.asarray(card[k])[i], np.asarray(cpu[k])[i])
                  for k in card if lane_diff({k: card[k][i:i + 1]},
                                             {k: cpu[k][i:i + 1]},
                                             discrete)[0]}
        print(f"  lane {i}: card / CPU {fields}; margin "
              f"{None if margin is None else float(margin[i]):}", flush=True)
    if left.any():
        problems.append(f"{name}: the card route disagrees with the CPU "
                        f"route on lanes {np.where(left)[0][:10].tolist()}")
    if (near | rounding).sum() > 0.1 * g:
        problems.append(f"{name}: more than 10% of the lanes differ")
    return int(diff.sum()), int(near.sum()), int(rounding.sum())


def qhull_eps(rows):
    """Float64 witness of the force-only Ferrari-Canny epsilon of (G, M, 3)
    rows: scipy's qhull hull of each row set; epsilon is the least distance
    from the origin to a facet plane, 0 unless the origin lies inside by
    more than 1e-10 (a flat row set has no hull: 0)."""
    from scipy.spatial import ConvexHull, QhullError

    rows = np.asarray(rows, np.float64)
    out = np.zeros(len(rows))
    for i, r in enumerate(rows):
        try:
            margin = -ConvexHull(r).equations[:, 3].max()
        except (QhullError, ValueError):     # flat, empty or not finite
            continue
        out[i] = margin if margin > 1e-10 else 0.0
    return out


def record_metric(module, name, calls):
    """Context: every call of ``module.name`` appends (its first argument,
    its output), both copied to the CPU, to ``calls``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = getattr(module, name)

        def rec(x, *a, **k):
            out = orig(x, *a, **k)
            calls.append(((x,) + a, out.detach().cpu().clone()))
            return out

        setattr(module, name, rec)
        try:
            yield orig
        finally:
            setattr(module, name, orig)
    return ctx()


def hold_metric(problems, name, fn, card_calls, cpu_calls, dev, witness=True):
    """The metric stage of a labeling call, card against CPU: ``fn`` on the
    card, given the CPU route's own input rows, returns the CPU route's
    epsilons (rtol 1e-4, atol 1e-6), except on lanes where the CPU's own
    epsilon moves under a one-ulp change of its rows, at most 10% of them.
    With ``witness``, each route's epsilons also agree, on every lane, with
    the float64 qhull witness of its own rows, and the means of the two
    routes agree within 2%."""
    import torch

    for j, ((a_card, e_card), (a_cpu, e_cpu)) in enumerate(
            zip(card_calls, cpu_calls)):
        e_card, e_cpu = e_card.numpy(), e_cpu.numpy()
        same = fn(*(x.to(dev) for x in a_cpu)).cpu().numpy()
        tol = EPS_RTOL * np.abs(e_cpu) + EPS_ATOL
        off = np.abs(same - e_cpu) > tol
        moved = np.zeros(len(e_cpu), bool)
        for sign in (1, -1):
            rows = a_cpu[0]
            rows = torch.nextafter(rows, torch.full_like(rows, sign * math.inf))
            moved |= np.abs(fn(rows, *a_cpu[1:]).numpy() - e_cpu) > tol
        left = off & ~moved
        msg = (f"{name} call {j}: {len(e_cpu)} lanes; the card's metric on "
               f"the CPU route's rows: {int(off.sum())} lanes off the CPU's "
               f"epsilons, {int((off & moved).sum())} of them where the "
               f"CPU's own moves under a one-ulp change of its rows "
               f"({int(moved.sum())} such lanes), {int(left.sum())} "
               f"unexplained")
        if left.any() or (off & moved).sum() > 0.1 * len(e_cpu):
            problems.append(f"{name}: the card's metric disagrees with the "
                            f"CPU's on equal rows")
        if witness:
            w_card = qhull_eps(a_card[0].cpu().numpy())
            w_cpu = qhull_eps(a_cpu[0].numpy())
            bad_card = np.abs(e_card - w_card) > EPS_RTOL * w_card + EPS_ATOL
            bad_cpu = np.abs(e_cpu - w_cpu) > EPS_RTOL * w_cpu + EPS_ATOL
            msg += (f"; off the float64 qhull witness of their own rows: "
                    f"card {int(bad_card.sum())}, CPU {int(bad_cpu.sum())} "
                    f"lanes; means card {e_card.mean():.6f}, CPU "
                    f"{e_cpu.mean():.6f}, witness {w_card.mean():.6f} (card "
                    f"rows), {w_cpu.mean():.6f} (CPU rows)")
            if bad_card.any() or bad_cpu.any():
                problems.append(f"{name}: epsilons off the float64 witness")
            if abs(e_card.mean() - e_cpu.mean()) > 0.02 * abs(
                    e_cpu.mean()) + EPS_ATOL:
                problems.append(f"{name}: epsilon means differ by more "
                                f"than 2%")
        print(msg, flush=True)


def k2_channel_models(torch, dev):
    """Satellite of phase 4: DualPointNetCls (6-channel trunks) and
    PointNetDenseCls (per-point trunk) in eval mode on the card, through K2
    and through its plain version."""
    from pointnetgpd_tpu_torch.models.pointnet import (DualPointNetCls,
                                                       PointNetDenseCls)
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2

    torch.manual_seed(5)
    launch2 = k2._launch
    for name, model, c in (("DualPointNetCls", DualPointNetCls(k=3), 6),
                           ("PointNetDenseCls", PointNetDenseCls(k=3), 3)):
        model = model.to(dev).eval()
        for m in model.modules():          # non-trivial running statistics
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
        x = torch.randn(16, 500, c, device=dev) * 0.05
        with torch.no_grad():
            n0 = k2.launches
            got = model(x)
            used = k2.launches - n0
            k2._launch = k2.trunk_reference
            try:
                want = model(x)
            finally:
                k2._launch = launch2
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        bad = sum(int(((g - w).abs() > K2_TOL * (1 + w.abs())).sum())
                  for g, w in zip(got, want))
        print(f"K2 in {name} ({c} input channels, eval, 16x500): {used} "
              f"launches, max |K2 route - plain route| = {err:.3e} "
              f"(tolerance 1e-4 * (1 + |plain|))", flush=True)
        if bad or (used == 0 and torch.device(dev).type == "cuda"):
            fail(f"K2 in {name} disagrees with the plain route")


def labeling_phases(torch, card, dev="cuda", attempts=256, torus=TORUS,
                    sdf_dim=100, per_class=20, max_rounds=None):
    """Phase 9: the labeling path (see the module docstring) on ``dev``,
    held to the CPU route. Returns its numbers for the kernels line and the
    summary. The sizes are parameters so that a CPU rehearsal can run it
    small."""
    import pickle
    import tempfile

    from pointnetgpd_tpu_torch.geometry.io import read_obj, read_sdf, write_obj
    from pointnetgpd_tpu_torch.geometry.mesh import center_of_mass
    from pointnetgpd_tpu_torch.geometry.sdf import make_sdf
    from pointnetgpd_tpu_torch.grasping import evaluation as ev
    from pointnetgpd_tpu_torch.grasping import quality as qm
    from pointnetgpd_tpu_torch.grasping import samplers as sm
    from pointnetgpd_tpu_torch.grasping.grasp import adaptive_num_samples
    from pointnetgpd_tpu_torch.grasping.gripper import Gripper
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.pipelines import generate_dataset as gen
    from pointnetgpd_tpu_torch.pipelines.ground_truth import (
        ground_truth_quality)
    from pointnetgpd_tpu_torch.pipelines.prepare_objects import (
        prepare_object_dir)

    fc = ev.FC_LIST_LESS_CLASS.astype(np.float32)
    out, problems = {}, []

    def np_(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else t

    def both(data, origin, res):
        return (make_sdf(data, origin, res, device=dev),
                make_sdf(data, origin, res, device="cpu"))

    # a. bench.py's labeling cell at its own sizes
    dim, res, r = 48, 0.0025, 0.045
    origin = -res * (dim - 1) / 2 * np.ones(3)
    ii, jj, kk = np.meshgrid(*(np.arange(dim),) * 3, indexing="ij")
    data = (np.linalg.norm(origin + res * np.stack([ii, jj, kk], -1),
                           axis=-1) - r).astype(np.float32)
    sph_card, sph_cpu = both(data, origin, res)
    com = np.zeros(3, np.float32)
    tape = Tape(9)

    def cell(sdf, step=0):
        s = sm.antipodal_sample_grasps(
            sdf, tape.rewind(step) if tape.log else tape, max_width=0.10,
            friction_coef=float(fc[0]), num_attempts=attempts,
            num_samples_loa=48)
        _, idx, lok = ev.friction_boundary_labels(
            sdf, s.configs, torch.as_tensor(fc, device=s.configs.device))
        eps6, _ = ev.evaluate_ferrari_canny_6d(
            sdf, s.configs, com, float(fc[0]), num_samples=48,
            torque_scaling=10.0)
        return {k: np_(v) for k, v in dict(
            valid=s.valid, configs=s.configs, contacts=s.contacts,
            normals=s.normals, label_idx=idx, label_ok=lok,
            eps6=eps6).items()}

    c6_card, c6_cpu = [], []
    t0 = time.perf_counter()
    with record_metric(qm, "ferrari_canny_l1_device_batch",
                       c6_card) as metric6:
        got = cell(sph_card)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with record_metric(qm, "ferrari_canny_l1_device_batch", c6_cpu):
        want = cell(sph_cpu)
    cpu_s = time.perf_counter() - t0
    keys3 = ("valid", "configs", "contacts", "label_idx", "label_ok")
    disc3 = ("valid", "label_idx", "label_ok")

    def sub(d, keys):
        return {k: d[k] for k in keys}

    def rounding(want, runs, keys, discrete, mask_key=None):
        """Lanes where the CPU route's own runs under one-ulp changes
        (``runs``) leave its result ``want``."""
        lanes = np.zeros(len(want[keys[0]]), bool)
        for other in runs:
            lanes |= lane_diff(masked(sub(other, keys), want, mask_key),
                               masked(sub(want, keys), want, mask_key),
                               discrete)
        return lanes

    # the CPU route under one-ulp changes of the SDF and of the draws
    nudged = ([cell(s) for s in nudged_sdfs(sph_cpu, "cpu")]
              + [cell(sph_cpu, step) for step in (1, -1)])

    print(f"9a labeling cell (sphere dim 48, res 0.0025, r 0.045; "
          f"{attempts} attempts, 48 line samples, mu 2.0): card "
          f"{cold_s:.2f} s cold, CPU route {cpu_s:.2f} s; valid "
          f"{int(got['valid'].sum())} card, {int(want['valid'].sum())} CPU; "
          f"labeled (3-D) {int((got['label_ok'] & got['valid']).sum())} "
          f"card, {int((want['label_ok'] & want['valid']).sum())} CPU",
          flush=True)
    out["9a"] = hold_routes(
        problems, "9a sampler + friction ladder",
        masked(sub(got, keys3), want, "valid"),
        masked(sub(want, keys3), want, "valid"),
        rounding(want, nudged, keys3, disc3, "valid"), disc3,
        fc_margin(want["contacts"], want["normals"], list(fc)))
    out["9a_6d"] = hold_routes(
        problems, "9a 6-D epsilon", sub(got, ("eps6",)),
        sub(want, ("eps6",)),
        rounding(want, nudged, ("eps6",), ())
        | rounding(want, nudged, keys3, disc3, "valid"), ())
    hold_metric(problems, "9a 6-D metric", metric6, c6_card, c6_cpu, dev,
                witness=False)

    def timed_rounds(fn, n):
        counts = [fn(100)]                              # warm
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        counts = [fn(200 + i) for i in range(n)]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / n
        return ms, float(np.mean([int(c) for c in counts]))

    def sample(seed):
        return sm.antipodal_sample_grasps(
            sph_card, seed=seed, max_width=0.10, friction_coef=float(fc[0]),
            num_attempts=attempts, num_samples_loa=48)

    def round3(seed):
        s = sample(seed)
        _, _, lok = ev.friction_boundary_labels(
            sph_card, s.configs, torch.as_tensor(fc, device=dev))
        return (lok & s.valid).sum()

    def round6(seed):
        s = sample(seed)
        q, _ = ev.evaluate_ferrari_canny_6d(sph_card, s.configs, com,
                                            float(fc[0]), num_samples=48,
                                            torque_scaling=10.0)
        return (q > 0).sum()

    ms3, n3 = timed_rounds(round3, 5)
    ms6, n6 = timed_rounds(round6, 3)
    out.update(ms3=ms3, gps3=n3 / ms3 * 1e3, ms6=ms6, gps6=n6 / ms6 * 1e3)
    print(f"9a timings ({card}): 3-D label {ms3:.2f} ms per round of "
          f"{attempts} attempts, {n3:.1f} labeled grasps per round, "
          f"{out['gps3']:.1f} labeled grasps/s; 6-D label {ms6:.2f} ms per "
          f"round, {n6:.1f} nonzero epsilons per round, {out['gps6']:.1f} "
          f"labeled grasps/s (CUDA events, warm, 5 and 3 rounds)",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # b. one object at the real size: phase 7's torus, prepared again
        v, f = torus_mesh(*torus)
        obj_dir = os.path.join(tmp, "torus")
        os.makedirs(os.path.join(obj_dir, "google_512k"))
        write_obj(os.path.join(obj_dir, "google_512k", "nontextured.obj"),
                  v, f)
        sdf_path = prepare_object_dir(obj_dir, sdf_dim=sdf_dim,
                                      sdf_padding=5, device=dev)
        gripper = Gripper.named("robotiq_85")
        secs = []
        for run in ("cold", "warm"):
            zero_counts()
            t0 = time.perf_counter()
            path, stats = gen.generate_for_object_dir(
                obj_dir, os.path.join(tmp, "out"), gripper, seed=0,
                less_class=True, grasps_per_class=per_class, device=dev,
                max_rounds=max_rounds)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches = read_counts()
            status = ("quota met" if stats["quota_met"] else
                      "exhausted" if stats["exhausted"] else "budget spent")
            print(f"9b generate_for_object_dir(torus, {len(f):,} triangles, "
                  f"sdf_dim {sdf_dim}, robotiq_85, less ladder, {per_class} "
                  f"per class) {run}: {secs[-1]:.2f} s, rows per class "
                  f"{stats['per_class']} ({stats['n_rows']} rows), "
                  f"{stats['rounds']} rounds, {status}, launches {launches} "
                  f"({card})", flush=True)
            if any(launches.values()):
                fail("generate_for_object_dir launched a kernel")
        rows = np.load(path)
        with open(path.replace(".npy", ".pickle"), "rb") as fh:
            rows_pickled = pickle.load(fh)
        if (rows.shape[1] != 12 or rows.dtype != np.float32
                or len(rows_pickled) != len(rows)
                or not np.isfinite(rows).all()):
            fail("generate_for_object_dir wrote malformed rows")
        out["9b"] = dict(cold_s=secs[0], warm_s=secs[1], rows=len(rows),
                         rounds=stats["rounds"],
                         per_class=stats["per_class"], status=status)

        # the first round against the CPU route under shared draws
        t_card = read_sdf(sdf_path, device=dev)
        t_cpu = read_sdf(sdf_path, device="cpu")
        out["torus_sdf"], out["9b_rows"] = t_cpu, rows    # for phase 14a
        ns = adaptive_num_samples(t_card, gripper.max_width)
        verts, faces = read_obj(os.path.join(obj_dir, "google_512k",
                                             "nontextured.obj"))
        com_t = center_of_mass(verts, faces).astype(np.float32)
        tape = Tape(0)
        keys = ("valid", "configs", "contacts")

        def first_round(sdf, step=0):
            s = sm.antipodal_sample_grasps(
                sdf, tape.rewind(step) if tape.log else tape,
                max_width=gripper.max_width, min_width=gripper.min_width,
                friction_coef=2.0, num_attempts=attempts,
                num_samples_loa=ns)
            return {k: np_(v) for k, v in s._asdict().items()}

        got, want = first_round(t_card), first_round(t_cpu)
        nudged = ([first_round(s) for s in nudged_sdfs(t_cpu, "cpu")]
                  + [first_round(t_cpu, step) for step in (1, -1)])
        out["9b_first"] = hold_routes(
            problems, "9b first round: antipodal sampler",
            masked(sub(got, keys), want, "valid"),
            masked(sub(want, keys), want, "valid"),
            rounding(want, nudged, keys, ("valid",), "valid"), ("valid",),
            fc_margin(want["contacts"], want["normals"], [2.0]))

        # the labels of the card's accepted grasps, on both routes
        cfg = sm.dedupe_grasps(got["configs"][got["valid"]])

        def labels(sdf):
            c = torch.as_tensor(cfg, device=sdf.data.device)
            lfc, idx, ok = ev.friction_boundary_labels(
                sdf, c, torch.as_tensor(fc, device=c.device), num_samples=ns)
            q, cts = ev.evaluate_ferrari_canny(sdf, c, com_t, lfc,
                                               num_samples=ns)
            return {"label_idx": np_(idx), "label_ok": np_(ok),
                    "canny": np_(q), "contacts": np_(cts.points),
                    "normals": np_(cts.normals)}

        lkeys = ("label_idx", "label_ok")
        fo_card, fo_cpu = [], []
        with record_metric(qm, "ferrari_canny_l1_force_only",
                           fo_card) as metric3:
            lg = labels(t_card)
        with record_metric(qm, "ferrari_canny_l1_force_only", fo_cpu):
            lw = labels(t_cpu)
        nudged = [labels(s) for s in nudged_sdfs(t_cpu, "cpu")]
        out["9b_labels"] = hold_routes(
            problems,
            "9b first round: friction labels of the card's accepted grasps",
            sub(lg, lkeys), sub(lw, lkeys),
            rounding(lw, nudged, lkeys, lkeys), lkeys,
            fc_margin(lw["contacts"], lw["normals"], fc))
        out["9b_canny"] = hold_routes(
            problems, "9b first round: their Ferrari-Canny labels",
            sub(lg, ("canny",)), sub(lw, ("canny",)),
            rounding(lw, nudged, ("canny",) + lkeys, lkeys), ())
        hold_metric(problems, "9b first round: the Ferrari-Canny metric",
                    metric3, fo_card, fo_cpu, dev)

        # c. SDF GPG on the torus resting on the table (z = 0)
        grid = t_card.data.cpu().numpy()
        lift = t_card.origin.cpu().numpy() + [0, 0, torus[3]]
        up_card, up_cpu = both(grid, lift, float(t_card.resolution))
        launch1 = k1.GpgScanContext._launch
        rec = []

        def rec1(ctx, fx, sc, is_y):
            rec.append((ctx, fx.clone(), sc.clone(), is_y))
            return launch1(ctx, fx, sc, is_y)

        def plain1(ctx, fx, sc, is_y):
            return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds,
                                            ctx.rot_rows, fx, sc, ctx.boxes,
                                            scan_is_y=is_y)

        kw = dict(seed=1, num_seeds=128)
        samplers = {
            "gpg_sample_grasps_sdf": lambda: sm.gpg_sample_grasps_sdf(
                up_card, gripper, **kw),
            "gpg_sample_grasps_sdf(curvature_frames)":
                lambda: sm.gpg_sample_grasps_sdf(
                    up_card, gripper, curvature_frames=True, **kw),
            "point_sample_grasps_sdf": lambda: sm.point_sample_grasps_sdf(
                up_card, gripper, **kw)}
        cands = {}
        zero_counts()
        k1.GpgScanContext._launch = rec1
        try:
            for name, fn in samplers.items():
                cands[name] = fn()
        finally:
            k1.GpgScanContext._launch = launch1
        launches = read_counts()
        print(f"9c SDF GPG on the torus: launches {launches} over "
              f"{len(samplers)} sampler calls", flush=True)
        if launches != {"gpg_counts": 3 * len(samplers) * (dev != "cpu"),
                        "pointnet_trunk": 0, "point_triangle": 0}:
            problems.append("9c: the SDF GPG samplers must launch K1 3 "
                            "times each")
        out["k1_launches"] = launches["gpg_counts"]
        k1.GpgScanContext._launch = plain1
        try:
            for name, fn in samplers.items():
                p, c = fn(), cands[name]
                same = (torch.equal(p.valid, c.valid)
                        and torch.equal(p.frames[p.valid],
                                        c.frames[c.valid]))
                print(f"9c {name}: {int(c.valid.sum())} valid of "
                      f"{len(c.valid)} candidates; K1 route equal to the "
                      f"plain route: {same}", flush=True)
                if not same:
                    problems.append(f"9c {name}: K1 disagrees with its "
                                    f"plain version")
        finally:
            k1.GpgScanContext._launch = launch1
        # each recorded launch against the plain version on its inputs
        for j, (ctx, fx, sc, iy) in enumerate(rec):
            act = ctx.active
            got1, want1 = launch1(ctx, fx, sc, iy), plain1(ctx, fx, sc, iy)
            torch.cuda.synchronize()
            print(f"9c K1 launch {j} (scan_is_y={iy}, {sc.shape[1]} shifts): "
                  f"{int(act.sum())} active frames of {ctx.f}, counts "
                  f"{int(want1[act].sum())}, equal to the plain version on "
                  f"the active frames: {torch.equal(got1[act], want1[act])}",
                  flush=True)
            if not torch.equal(got1[act], want1[act]):
                problems.append(f"9c: K1 launch {j} disagrees with its "
                                f"plain version")
        out["k1_ms"] = sum(cuda_ms(torch, lambda: launch1(ctx, fx, sc, iy),
                                   iters=20) for ctx, fx, sc, iy in rec)
        out["k1_plain_ms"] = sum(cuda_ms(torch, lambda: plain1(
            ctx, fx, sc, iy), iters=2, warm=1) for ctx, fx, sc, iy in rec)
        print(f"9c K1 on the labeling path ({card}): {len(rec)} launches, "
              f"{out['k1_ms']:.4f} ms in all with the wrapper (frames per "
              f"call {[c[0].f for c in rec[::3]]}), plain version "
              f"{out['k1_plain_ms']:.3f} ms", flush=True)

        # d. ground truth of 9c's candidates, the torus at a pose
        frames = np.concatenate([c.frames[c.valid].cpu().numpy()
                                 for c in cands.values()])[:64]
        ang = 0.4
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[1, 0, 0], [0, np.cos(ang), -np.sin(ang)],
                        [0, np.sin(ang), np.cos(ang)]]
        pose[:3, 3] = [0.3, -0.1, 0.2]
        rot, tr = pose[:3, :3], pose[:3, 3]
        fw = frames @ rot.T
        fw[:, [0, 4]] += tr
        pts = (up_cpu.origin + up_cpu.resolution
               * up_cpu.surface_points).numpy()
        pts_w = (pts @ rot.T + tr).astype(np.float32)
        disc = ("obj_idx", "label_valid", "fc_label", "fc_good")

        def gt(sdf):
            return ground_truth_quality(fw, [(sdf, pose)], gripper, pts_w,
                                        fc_list=fc)

        fo_card, fo_cpu = [], []
        with record_metric(qm, "ferrari_canny_l1_force_only",
                           fo_card) as metric3:
            g_card = gt(up_card)
        with record_metric(qm, "ferrari_canny_l1_force_only", fo_cpu):
            g_cpu = gt(up_cpu)
        nudged = [gt(s) for s in nudged_sdfs(up_cpu, "cpu")]
        gkeys = disc + ("center_sdf",)
        out["9d"] = hold_routes(problems, "9d ground_truth_quality",
                                sub(g_card, gkeys), sub(g_cpu, gkeys),
                                rounding(g_cpu, nudged, gkeys, disc), disc)
        ekeys = ("eps_label", "eps_good")
        out["9d_eps"] = hold_routes(
            problems, "9d ground_truth_quality epsilons", sub(g_card, ekeys),
            sub(g_cpu, ekeys), rounding(g_cpu, nudged, ekeys + disc, disc),
            ())
        hold_metric(problems, "9d (eps_label, eps_good) Ferrari-Canny metric",
                    metric3, fo_card, fo_cpu, dev)
        print(f"9d: {len(fw)} candidates (9c's valid ones) at the pose; "
              f"label_valid "
              f"{int(g_card['label_valid'].sum())}, fc_good "
              f"{int(g_card['fc_good'].sum())}, centers inside "
              f"{int((g_card['center_sdf'] < 0).sum())}", flush=True)
    if problems:
        fail("phase 9: " + "; ".join(problems))
    return out


# --------------------------------------------------------------------------
# Phase 10: the online path's entry points


class _RosMsg:
    """Attribute-auto-vivifying stand-in for a ROS message struct."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        v = _RosMsg()
        setattr(self, name, v)
        return v


def fake_ros(cloud_msg):
    """In-process stand-ins for rospy, sensor_msgs.msg, visualization_msgs.msg
    and gpd_grasp_msgs.msg (the card's machine has no ROS), installed into
    ``sys.modules``. Returns (published messages by topic, the modules'
    names). ``rospy.wait_for_message`` returns ``cloud_msg`` (or, before
    one is set, raises)."""
    import types

    published = {}
    params = {}

    class Publisher:
        def __init__(self, topic, data_class, queue_size=0):
            if not isinstance(data_class, type):
                raise TypeError(f"invalid message class: {data_class!r}")
            self.topic = topic
            published.setdefault(topic, [])

        def publish(self, msg):
            published[self.topic].append(msg)

    class Rate:
        def __init__(self, hz):
            pass

        def sleep(self):
            pass

    class Marker(_RosMsg):
        CUBE, ADD = 1, 0

    class MarkerArray:
        def __init__(self):
            self.markers = []

    class GraspConfigList(_RosMsg):
        def __init__(self):
            self.grasps = []

    class PointCloud2(_RosMsg):
        pass

    class PointField:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    rospy = types.ModuleType("rospy")
    rospy.init_node = lambda name, anonymous=False: None
    rospy.Publisher, rospy.Rate = Publisher, Rate
    rospy.set_param = params.__setitem__
    rospy.get_param = lambda name, *d: params.get(name, d[0] if d else None)
    rospy.is_shutdown = lambda: False
    rospy.loginfo = lambda *a: None
    rospy.wait_for_message = lambda topic, cls: cloud_msg[0]
    rospy.Duration = type("Duration", (),
                          {"from_sec": staticmethod(lambda s: s)})
    rospy.Time = type("Time", (), {"now": staticmethod(lambda: 0.0)})
    mods = {"rospy": rospy}
    for pkg, names in (("sensor_msgs", {"PointCloud2": PointCloud2,
                                        "PointField": PointField}),
                       ("visualization_msgs", {"Marker": Marker,
                                               "MarkerArray": MarkerArray}),
                       ("gpd_grasp_msgs", {"GraspConfig": _RosMsg,
                                           "GraspConfigList":
                                               GraspConfigList})):
        mods[pkg] = types.ModuleType(pkg)
        mods[pkg + ".msg"] = msg = types.ModuleType(pkg + ".msg")
        for k, v in names.items():
            setattr(msg, k, v)
    sys.modules.update(mods)
    return published, list(mods)


def warmup_child(mode, dev, pad, max_points):
    """One fresh process (``--warmup-child``): the golden scorer's detector
    at ``cloud_pad_to=pad``; with mode ``warm``, ``warmup(max_points)``
    first. Times the first two live frames on the tabletop, holds the first
    against the same frame with both kernels swapped for their plain
    versions, and prints one JSON line."""
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.robot.node import DetectorConfig, GraspDetector

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    t_start = time.perf_counter()
    scorer = GraspScorer.from_checkpoint(os.path.join(
        HERE, "tests", "fixtures", "golden_pointnet_3class.npz"), device=dev,
        k=3)
    det = GraspDetector(scorer, config=DetectorConfig(cloud_pad_to=pad))
    pts, cam = tabletop_scene()
    out = {"mode": mode}
    if mode == "warm":
        zero_counts()
        t0 = time.perf_counter()
        out["buckets"] = det.warmup(max_points=max_points)
        sync()
        out["warmup_s"] = time.perf_counter() - t0
        out["warmup_launches"] = read_counts()
    frames = []
    for s in range(2):
        zero_counts()
        t0 = time.perf_counter()
        res = det.process_frame(pts, cam, seed=s)
        sync()
        frames.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            first, out["frame_launches"] = res, read_counts()
    out["first_ms"], out["second_ms"] = frames
    out["since_start_s"] = time.perf_counter() - t_start

    def plain1(ctx, fx, sc, is_y):
        return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)

    launch1, launch2 = k1.GpgScanContext._launch, k2._launch
    k1.GpgScanContext._launch, k2._launch = plain1, k2.trunk_reference
    try:
        plain = det.process_frame(pts, cam, seed=0)
    finally:
        k1.GpgScanContext._launch, k2._launch = launch1, launch2
    out["plain_equal"] = bool(
        first["n_valid"] == plain["n_valid"]
        and np.array_equal(first["pred"], plain["pred"])
        and np.array_equal(first["counts"], plain["counts"])
        and np.abs(first["all_scores"] - plain["all_scores"]).max() <= 1e-4)
    print("WARMUP_CHILD " + json.dumps(out), flush=True)


def entry_phases(torch, card, dev="cuda", ckpt_dir=None, trained=None,
                 frame_ms=None, pad=4096, max_points=20000, n_points=500,
                 g=40, scene=None):
    """Phase 10: the online path's entry points on ``dev``, each launch site
    of K2 (and K1) held to its plain version. ``ckpt_dir``/``trained``:
    the directory phase 8's ``fit`` wrote and the model it trained (10a
    loads the one through ``cli.infer`` and compares with the other).
    Returns the launch counts by entry point. Sizes (and 10d's ``scene``,
    default the tabletop) are parameters so that a CPU rehearsal can run it
    small."""
    import contextlib
    import copy
    import io
    import tempfile

    from pointnetgpd_tpu_torch.cli import infer
    from pointnetgpd_tpu_torch.draws import Draws
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.models.pointnet import DualPointNetCls
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.robot import node
    from pointnetgpd_tpu_torch.robot.pointclouds import (
        xyz_array_to_pointcloud2)

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    launch1, launch2 = k1.GpgScanContext._launch, k2._launch
    ckpt = os.path.join(HERE, "tests", "fixtures",
                        "golden_pointnet_3class.npz")
    problems, launches = [], {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def plain_kernels():
        def plain1(ctx, fx, sc, is_y):
            return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds,
                                            ctx.rot_rows, fx, sc, ctx.boxes,
                                            scan_is_y=is_y)

        k1.GpgScanContext._launch, k2._launch = plain1, k2.trunk_reference
        try:
            yield
        finally:
            k1.GpgScanContext._launch, k2._launch = launch1, launch2

    def expect(name, want):
        # the counters count launches on the card; a CPU rehearsal has none
        got = read_counts()
        launches[name] = got
        if any(got[k] != (v if on_card else 0) for k, v in want.items()):
            problems.append(f"{name}: launches {got}, expected {want}")
        return got

    # a. cli.infer on the golden checkpoint, then on phase 8's directory
    calls = []
    real_score = GraspScorer.score_clouds

    def recorded(self, *a, **kw):
        out = real_score(self, *a, **kw)
        calls.append(out)
        return out

    def run_cli(argv):
        buf = io.StringIO()
        GraspScorer.score_clouds = recorded
        try:
            with contextlib.redirect_stdout(buf):
                rc = infer.main(argv if on_card
                                else argv + ["--device", dev.type])
        finally:
            GraspScorer.score_clouds = real_score
        sync()
        if rc != 0:
            problems.append(f"cli.infer {argv} returned {rc}")
        return buf.getvalue().splitlines(), calls[-1]

    with tempfile.TemporaryDirectory() as tmp:
        cloud = np.random.RandomState(0).uniform(
            -0.04, 0.04, (n_points, 3)).astype(np.float32)
        cloud_path = os.path.join(tmp, "cloud.npy")
        np.save(cloud_path, cloud)
        argv = ["--load-model", ckpt, "--input", cloud_path, "--repeat",
                "10", "--seed", "3"]
        zero_counts()
        t0 = time.perf_counter()
        lines, got = run_cli(argv)
        cold_s = time.perf_counter() - t0
        expect("10a cli.infer", {"pointnet_trunk": 2, "gpg_counts": 0})
        t0 = time.perf_counter()
        run_cli(argv)
        warm_s = time.perf_counter() - t0
        with plain_kernels():
            _, want = run_cli(argv)
        e_prob = float(np.abs(got[1] - want[1]).max())
        same = (np.array_equal(got[0], want[0])
                and np.array_equal(got[2], want[2]))
        print(f"10a cli.infer --load-model golden_pointnet_3class.npz "
              f"--repeat 10 ({n_points}-point cloud): "
              f"{' | '.join(lines)}; K2 launches "
              f"{launches['10a cli.infer']['pointnet_trunk']}; vs the plain "
              f"route: prediction and votes equal {same}, max |prob err| "
              f"{e_prob:.2e} (1e-4); {cold_s:.3f} s cold, {warm_s:.4f} s "
              f"warm per call, host clock, model load included ({card})",
              flush=True)
        if not same or e_prob > 1e-4:
            problems.append("10a: cli.infer differs from its plain route")
        if ckpt_dir is not None:
            lines, got = run_cli(["--load-model", ckpt_dir, "--k", "2",
                                  "--num-point", "750", "--input",
                                  cloud_path, "--repeat", "10", "--seed",
                                  "4"])
            ref = GraspScorer(model=trained, k=2, num_points=750, repeat=10,
                              device=dev).score_clouds(
                cloud[None], draws=Draws(4, dev))
            same = all(np.array_equal(a, b) for a, b in zip(got, ref))
            print(f"10a cli.infer --load-model <phase 8's model path>: "
                  f"{lines[0]}; {' | '.join(lines[1:])}; predicts as the "
                  f"trained model: {same}", flush=True)
            if not same or not lines[0].startswith("resolved "):
                problems.append("10a: the trained directory does not "
                                "predict as the trained model")

    # b. a dual scorer on (G, P, 6) clouds, and the bf16 scorer
    torch.manual_seed(0)
    dual = DualPointNetCls(k=2)
    with torch.no_grad():
        for name, buf in dual.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    gen = np.random.RandomState(1)
    clouds6 = (gen.randn(g, n_points, 6) * 0.02).astype(np.float32)
    clouds3 = gen.uniform(-0.04, 0.04, (g, n_points, 3)).astype(np.float32)
    ds = GraspScorer(model=dual, k=2, device=dev)
    zero_counts()
    got = ds.score_clouds(clouds6, seed=5)
    sync()
    expect("10b dual", {"pointnet_trunk": 1})
    with plain_kernels():
        want = ds.score_clouds(clouds6, seed=5)
    e_dual = float(np.abs(got[1] - want[1]).max())
    scorer = GraspScorer.from_checkpoint(ckpt, device=dev, k=3)
    s16 = scorer.as_dtype(torch.bfloat16)
    zero_counts()
    got16 = s16.score_clouds(clouds3, seed=6)
    sync()
    expect("10b bf16", {"pointnet_trunk": 2})
    with plain_kernels():
        want16 = s16.score_clouds(clouds3, seed=6)
    p32 = scorer.score_clouds(clouds3, seed=6)[0]
    agree = float((got16[0] == p32).mean())
    print(f"10b dual scorer (DualPointNetCls, k=2) on ({g}, {n_points}, 6): "
          f"K2 launches {launches['10b dual']['pointnet_trunk']}, max |prob "
          f"err| vs plain {e_dual:.2e} (1e-4), classes equal "
          f"{np.array_equal(got[0], want[0])}; bf16 scorer on ({g}, "
          f"{n_points}, 3): K2 launches "
          f"{launches['10b bf16']['pointnet_trunk']}, classes equal to the "
          f"plain route {np.array_equal(got16[0], want16[0])}, class "
          f"agreement with fp32 {agree:.3f}", flush=True)
    if e_dual > 1e-4 or not np.array_equal(got[0], want[0]):
        problems.append("10b: the dual scorer differs from its plain route")
    if not np.array_equal(got16[0], want16[0]):
        problems.append("10b: the bf16 scorer differs from its plain route")

    # c. warmup, each mode in a fresh process: what warmup takes away from
    # the first live frame shows only in a process that has not run it yet
    child = {}
    for mode in ("cold", "warm"):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warmup-child",
             mode, dev.type, str(pad), str(max_points)],
            capture_output=True, text=True, timeout=600)
        tagged = [ln for ln in res.stdout.splitlines()
                  if ln.startswith("WARMUP_CHILD ")]
        if res.returncode != 0 or not tagged:
            fail(f"10c warmup child ({mode}) failed: "
                 f"{(res.stdout + res.stderr)[-3000:]}")
        child[mode] = json.loads(tagged[0].split(" ", 1)[1])
        child[mode]["process_s"] = time.perf_counter() - t0
    w, c = child["warm"], child["cold"]
    n_b = len(w["buckets"])
    print(f"10c GraspDetector.warmup(max_points={max_points}) at "
          f"cloud_pad_to={pad}, fresh process: buckets {w['buckets']} in "
          f"{w['warmup_s']:.3f} s, launches {w['warmup_launches']}; first "
          f"live frame after it {w['first_ms']:.2f} ms, second "
          f"{w['second_ms']:.2f} ms; without warmup (fresh process) first "
          f"frame {c['first_ms']:.2f} ms, second {c['second_ms']:.2f} ms; "
          f"phase 6's warm frame "
          f"{'n/a' if frame_ms is None else f'{frame_ms:.2f}'} ms (host "
          f"clock) ({card})", flush=True)
    if w["buckets"] != list(range(pad, max_points + pad, pad)):
        problems.append(f"10c: buckets {w['buckets']}")
    for name, want_n in (("warmup_launches", n_b), ("frame_launches", 1)):
        for mode in ("warm",) if name == "warmup_launches" else ("warm",
                                                                 "cold"):
            got_l = child[mode][name]
            if on_card and (got_l["gpg_counts"] != 3 * want_n
                            or got_l["pointnet_trunk"] != 2 * want_n):
                problems.append(f"10c {mode} {name}: {got_l}")
    if not (w["plain_equal"] and c["plain_equal"]):
        problems.append("10c: a live frame differs from its plain route")
    launches["10c warmup"] = w["warmup_launches"]

    # d. run_ros_node on the tabletop through stand-in ROS modules. The
    # golden checkpoint calls no tabletop candidate good (class 2), and the
    # node publishes only ranked good grasps: its best class's bias is
    # raised by 3 so that every frame has some
    ros_model = copy.deepcopy(scorer.model)
    with torch.no_grad():
        ros_model.fc3.bias[2] += 3.0
    det = node.GraspDetector(GraspScorer(model=ros_model, k=3, device=dev),
                             config=node.DetectorConfig(cloud_pad_to=pad))
    pts, cam = tabletop_scene() if scene is None else scene
    holder = [None]
    published, names = fake_ros(holder)
    try:
        holder[0] = xyz_array_to_pointcloud2(pts, frame_id="/table_top")
        n_frames = 3
        for pipeline in (False, True):
            published.clear()
            zero_counts()
            t0 = time.perf_counter()
            node.run_ros_node(det, cam, max_frames=n_frames,
                              pipeline=pipeline)
            sync()
            ros_s = time.perf_counter() - t0
            name = f"10d run_ros_node pipeline={pipeline}"
            expect(name, {"gpg_counts": 3 * n_frames,
                          "pointnet_trunk": 2 * n_frames})
            glist = published.get("/detect_grasps/clustered_grasps", [])
            match = []
            for seed, msg in enumerate(glist):
                want = det.process_frame(pts, cam, seed=seed)
                g0 = msg.grasps[0]
                match.append(bool(
                    np.array_equal([g0.bottom.x, g0.bottom.y, g0.bottom.z],
                                   want["grasps"][0, 4])
                    and np.array_equal([g0.approach.x, g0.approach.y,
                                        g0.approach.z], want["grasps"][0, 1])
                    and g0.score.data == float(want["scores"][0])))
            with plain_kernels():
                plain = det.process_frame(pts, cam, seed=0)
            near = (len(glist) > 0 and len(plain["scores"]) > 0 and abs(
                glist[0].grasps[0].score.data - float(plain["scores"][0]))
                <= 1e-4)
            print(f"{name}: {n_frames} frames in {ros_s:.3f} s "
                  f"({ros_s / n_frames * 1e3:.2f} ms per frame, host clock), "
                  f"{len(glist)} grasp lists published, launches "
                  f"{launches[name]}; best grasp equal to process_frame's "
                  f"first ranked grasp: {match}; best score vs the plain "
                  f"route within 1e-4: {near} ({card})", flush=True)
            if len(glist) != n_frames or not all(match) or not near:
                problems.append(f"{name}: published grasps differ")
    finally:
        for name in names:
            sys.modules.pop(name, None)
    if problems:
        fail("phase 10: " + "; ".join(problems))
    print(flush=True)
    return launches


# --------------------------------------------------------------------------
# Phase 11: the RGB-D -> cloud path


def synthetic_rgbd(h=480, w=640, rgb_hw=(1024, 1280)):
    """A YCB-like frame: a table plane sloping from 0.9 to 1.3 m with a box
    0.25 m nearer on it (real depth discontinuities), 1e-4 m depth units, a
    non-identity IR -> RGB transform into a larger colour frame, a mask and
    a rotated table pose. Returns ``frame_cloud``'s keyword arguments."""
    rs = np.random.RandomState(0)
    rows = np.linspace(9000, 13000, h)[:, None] * np.ones((1, w))
    depth = rows.astype(np.uint16)
    depth[h // 3:2 * h // 3, w // 3:w // 2] -= 2500
    depth[rs.rand(h, w) < 0.002] = 0                      # dropouts

    def rot(a):
        c, s = np.cos(a), np.sin(a)
        return (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
                @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
                @ np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]]))

    rgb_from_ref, ir_from_ref, obj_from_ref = np.eye(4), np.eye(4), np.eye(4)
    rgb_from_ref[:3, :3] = rot([0.3, -0.2, 0.1])
    rgb_from_ref[:3, 3] = [0.1, -0.05, 0.02]
    ir_from_ref[:3, :3] = rot([0.3, -0.19, 0.105])
    ir_from_ref[:3, 3] = [0.075, -0.05, 0.021]
    obj_from_ref[:3, :3] = rot([2.2, 0.1, -0.4])
    obj_from_ref[:3, 3] = [0.05, 0.4, 0.8]
    mask = np.zeros(rgb_hw, np.uint8)
    mask[:, : rgb_hw[1] // 5] = 255
    return dict(
        depth=depth, depth_k=np.array([[571.0, 0, 319.5], [0, 571.0, 239.5],
                                       [0, 0, 1]]),
        rgb_k=np.array([[1050.0, 0, 639.5], [0, 1050.0, 511.5], [0, 0, 1]]),
        depth_scale=np.array(1.0) * 1e-4,
        h_rgb_from_depth=rgb_from_ref @ np.linalg.inv(ir_from_ref),
        ref_from_rgb=np.linalg.inv(rgb_from_ref), obj_from_ref=obj_from_ref,
        rgb_image=rs.randint(0, 255, rgb_hw + (3,)).astype(np.uint8),
        mask=mask)


def cloud_phases(torch, card, dev="cuda", frame=None, torus=TORUS,
                 n_views=6, iters=20):
    """Phase 11: the RGB-D -> cloud path on ``dev`` against the CPU route
    (see the module docstring). ``frame``: ``synthetic_rgbd``'s keyword
    arguments (default: the full-size frame)."""
    import tempfile

    from pointnetgpd_tpu_torch.geometry.io import write_obj
    from pointnetgpd_tpu_torch.pipelines import render_clouds as rc
    from pointnetgpd_tpu_torch.pipelines import ycb_clouds as yc
    from pointnetgpd_tpu_torch.render import native

    dev = torch.device(dev)
    frame = synthetic_rgbd() if frame is None else frame
    problems = []
    renderer_dir = os.path.join(HERE, "native", "renderer")

    def listing():
        return sorted((n, os.stat(os.path.join(renderer_dir, n)).st_mtime_ns)
                      for n in os.listdir(renderer_dir))

    before = listing()

    # a. the three per-pixel functions and the whole array-level frame
    def stages(where):
        t = {k: torch.as_tensor(np.asarray(v, np.float64).astype(np.float32),
                                device=where)
             for k, v in frame.items() if k in ("depth_k", "rgb_k",
                                                "h_rgb_from_depth",
                                                "ref_from_rgb",
                                                "obj_from_ref")}
        raw = torch.as_tensor(frame["depth"].astype(np.float32), device=where)
        rgb = torch.as_tensor(frame["rgb_image"], device=where)
        hw = frame["rgb_image"].shape[:2]
        filt = yc.filter_discontinuities(raw)
        depth = (filt.double() * float(frame["depth_scale"])).float()
        reg = yc.register_depth_map(depth, t["depth_k"], t["rgb_k"],
                                    t["h_rgb_from_depth"], out_height=hw[0],
                                    out_width=hw[1])
        cloud, valid = yc.depth_map_to_cloud(reg, rgb, t["rgb_k"],
                                             t["ref_from_rgb"],
                                             t["obj_from_ref"])
        fns = {"filter_discontinuities": lambda: yc.filter_discontinuities(
                   raw),
               "register_depth_map": lambda: yc.register_depth_map(
                   depth, t["depth_k"], t["rgb_k"], t["h_rgb_from_depth"],
                   out_height=hw[0], out_width=hw[1]),
               "depth_map_to_cloud": lambda: yc.depth_map_to_cloud(
                   reg, rgb, t["rgb_k"], t["ref_from_rgb"],
                   t["obj_from_ref"])}
        return filt, reg, cloud, valid, fns

    f_d, r_d, c_d, v_d, fns = stages(dev)
    f_c, r_c, c_c, v_c, _ = stages("cpu")
    filt_eq = torch.equal(f_d.cpu(), f_c)
    reg_eq = torch.equal(r_d.cpu(), r_c)
    c_d, c_c = c_d.cpu().numpy(), c_c.numpy()
    cloud_ok = bool(torch.equal(v_d.cpu(), v_c)) and bool(np.all(
        np.abs(c_d - c_c) <= 1e-6 * (1 + np.abs(c_c))))
    times = {k: cuda_ms(torch, fn, iters=iters) for k, fn in fns.items()}
    times["frame_cloud"] = cuda_ms(
        torch, lambda: yc.frame_cloud(**frame, device=dev), iters=iters)
    cloud = yc.frame_cloud(**frame, device=dev)
    cloud_cpu = yc.frame_cloud(**frame, device="cpu")
    n_reg = int((r_c > 0).sum())
    print(f"11a ycb_clouds on a {frame['depth'].shape[1]}x"
          f"{frame['depth'].shape[0]} depth frame -> "
          f"{frame['rgb_image'].shape[1]}x{frame['rgb_image'].shape[0]} "
          f"colour frame: {int((f_c == 0).sum())} zero pixels after the "
          f"filter, {n_reg} registered pixels, cloud {len(cloud)} points; "
          f"card vs CPU: filtered equal {filt_eq}, registered equal "
          f"{reg_eq}, cloud within 1e-6 (1 + |ref|) {cloud_ok}, frame_cloud "
          f"equal {np.array_equal(cloud, cloud_cpu)}", flush=True)
    print("11a timings (CUDA events, warm, " + str(iters) + " calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
          + f" (frame_cloud: host arrays in, host cloud out) ({card})",
          flush=True)
    if not (filt_eq and reg_eq and cloud_ok and n_reg > 0 and len(cloud)):
        problems.append("11a: the card route differs from the CPU route")

    with tempfile.TemporaryDirectory() as tmp:
        # b. the writers
        stem = os.path.join(tmp, "pc_NP1_NP5_0")
        yc.write_ply(stem + ".ply", cloud)
        yc.write_pcd(stem + ".pcd", cloud[:, :3])
        np.save(stem + ".npy", cloud[:, :3])
        raw = open(stem + ".pcd", "rb").read()
        pcd = np.frombuffer(raw.split(b"DATA binary\n", 1)[1], np.float32)
        ply = open(stem + ".ply").read().splitlines()
        n_ply = int(ply[2].split()[-1])
        ok_b = (np.array_equal(np.load(stem + ".npy"), pcd.reshape(-1, 3))
                and n_ply == len(cloud) == len(ply) - 10)
        print(f"11b writers: .npy equal to the .pcd's xyz and .ply vertex "
              f"count {n_ply} = {len(cloud)}: {ok_b}", flush=True)
        if not ok_b:
            problems.append("11b: the written files disagree")

        # c. render_object_clouds on the torus, card against the CPU; the
        # rasterizer's g++ build is timed apart
        t0 = time.perf_counter()
        native.render_mesh(np.eye(3, 4), np.zeros(3), 2, 2, np.zeros((3, 3)),
                           np.zeros((1, 3), np.int32))
        build_s = time.perf_counter() - t0
        v, f = torus_mesh(*torus)
        paths = {}
        secs = {}
        for where, sub in ((dev.type, "route"), ("cpu", "cpu_route")):
            obj = os.path.join(tmp, sub, "torus")
            os.makedirs(os.path.join(obj, "google_512k"))
            write_obj(os.path.join(obj, "google_512k", "nontextured.obj"),
                      v, f)
            t0 = time.perf_counter()
            paths[where] = rc.render_object_clouds(obj, n_views=n_views,
                                                   device=where)
            secs[where] = time.perf_counter() - t0
        same = [open(a, "rb").read() == open(b, "rb").read()
                for a, b in zip(paths[dev.type], paths["cpu"])]
        pts = np.concatenate([np.load(p) for p in paths[dev.type]])
        dist = np.abs(torus_sdf(pts.astype(np.float64), *torus[2:]))
        # one pixel's footprint at the point's range from its camera
        rng_ = np.concatenate([np.linalg.norm(
            np.load(p) - c, axis=1) for p, (_, c) in zip(
                paths[dev.type], rc.view_ring(n_views=n_views))])
        bound = 4 * 3e-4 + rng_ / rc.DEFAULT_INTR.fx
        lib = native.library_path()
        built = lib.exists() and os.path.samefile(
            lib.parent, os.path.join(HERE, "pointnetgpd_tpu_torch", "_build"))
        print(f"11c render_object_clouds on the {len(f)}-triangle torus, "
              f"{n_views} views: {len(pts)} points, files equal card vs "
              f"CPU {same}, max |torus distance| {dist.max():.3e} m, "
              f"largest share of its bound {np.max(dist / bound):.3f}; "
              f"{secs[dev.type]:.3f} s per object ({dev.type}), "
              f"{secs['cpu']:.3f} s (cpu); binding {lib.name} under "
              f"_build/: {built}, its first load (g++ build where it was "
              f"not built) {build_s:.3f} s ({card})", flush=True)
        if (len(same) != n_views or not all(same) or not np.all(dist < bound)
                or not built):
            problems.append("11c: rendered clouds wrong or differ")
    if listing() != before:
        problems.append("11: native/renderer/ changed during the run")
    if problems:
        fail("phase 11: " + "; ".join(problems))
    print(flush=True)
    return {"frame_ms": times["frame_cloud"], **times}


# --------------------------------------------------------------------------
# Phase 12: data and tensor parallelism on the one card

def mesh_phases(torch, card, dev="cuda", ckpt=None, k2_1024_ms=None,
                batch=128, cloud=20000, n_pts=750, n_clouds=100,
                scene=None):
    """Phase 12 (see the module docstring). Sizes are parameters, so that
    the phase rehearses on the CPU at a small size. Returns the launches by
    path and the 512-row instance's entry of the kernels line."""
    import copy

    from pointnetgpd_tpu_torch.draws import Draws
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.ops.crop import collect_grasp_clouds_batched
    from pointnetgpd_tpu_torch.parallel.mesh import make_mesh
    from pointnetgpd_tpu_torch.parallel.ranks import run_step_ranks
    from pointnetgpd_tpu_torch.parallel.tp import (make_2d_mesh,
                                                   shard_params_tp)
    from pointnetgpd_tpu_torch.robot.node import DetectorConfig, GraspDetector
    from pointnetgpd_tpu_torch.training import train as ttrain
    from pointnetgpd_tpu_torch.training.data import SyntheticGraspData

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    named = "cuda:0" if on_card else "cpu"
    mesh = make_mesh(2, device=named)
    pts, cam = scene or tabletop_scene()
    out = {"by_path": {}}
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    single = GraspScorer.from_checkpoint(ckpt, device=dev, k=3)
    with torch.no_grad():          # grasps to rank (as phase 10d does)
        single.model.fc3.bias[-1] += 3.0
    sharded = GraspScorer(model=copy.deepcopy(single.model), k=3,
                          mesh=mesh)
    if sharded.pad_to != single.pad_to or sharded.device != mesh.first:
        fail("12: a 2-shard mesh changed the scorer's padding or device")
    launch1, launch2 = k1.GpgScanContext._launch, k2._launch

    def plain1(ctx, fx, sc, is_y):
        return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)

    # a. the frame on the mesh
    for lazy in (True, False):
        cfg = DetectorConfig(cloud_pad_to=4096, lazy_normals=lazy)
        det_s = GraspDetector(single, config=cfg)
        det_m = GraspDetector(sharded, config=cfg)
        a = det_s.process_frame(pts, cam, seed=0)
        rec = []

        def rec1(ctx, fx, sc, is_y):
            rec.append((ctx, fx.clone(), sc.clone(), is_y))
            return launch1(ctx, fx, sc, is_y)

        zero_counts()
        k1.GpgScanContext._launch = rec1
        try:
            b = det_m.process_frame(pts, cam, seed=0)
        finally:
            k1.GpgScanContext._launch = launch1
        n = read_counts()
        k1_equal = True
        for ctx, fx, sc, is_y in rec:
            got, want = launch1(ctx, fx, sc, is_y), plain1(ctx, fx, sc, is_y)
            k1_equal &= torch.equal(got[ctx.active], want[ctx.active])
        e_fr = float(np.abs(a["all_frames"] - b["all_frames"]).max())
        e_sc = float(np.abs(a["all_scores"] - b["all_scores"]).max())
        e_rk = (float(np.abs(a["scores"] - b["scores"]).max())
                if len(a["scores"]) else 0.0)
        same = (a["n_valid"] == b["n_valid"]
                and np.array_equal(a["pred"], b["pred"])
                and np.array_equal(a["counts"], b["counts"])
                and len(a["scores"]) == len(b["scores"])
                and np.array_equal(a["grasps"], b["grasps"]))
        ms = {}
        for name, det in (("single", det_s), ("mesh", det_m)):
            det.process_frame(pts, cam, seed=1)
            sync()
            t0 = time.perf_counter()
            for s_ in range(3):
                det.process_frame(pts, cam, seed=2 + s_)
            sync()
            ms[name] = (time.perf_counter() - t0) / 3 * 1e3
        print(f"12a frame on a mesh of 2 shards on {named} (lazy_normals="
              f"{lazy}): launches {n} (K1 3 and K2 2 per shard), n_valid "
              f"{b['n_valid']} vs {a['n_valid']}, ranked {len(b['scores'])} "
              f"vs {len(a['scores'])}, predictions, counts and ranked grasps "
              f"equal {same}; max |frame err| {e_fr:.2e}, max |score err| "
              f"{e_sc:.2e}, ranked scores {e_rk:.2e} (1e-6); each of the "
              f"{len(rec)} recorded K1 launches equal to the plain version "
              f"on its active frames: {k1_equal}; ms per frame (host clock, "
              f"3 frames) single {ms['single']:.2f}, mesh {ms['mesh']:.2f} "
              f"({card}; one card, not scaling)", flush=True)
        want_n = {"gpg_counts": 3 * mesh.size * on_card,
                  "pointnet_trunk": 2 * mesh.size * on_card,
                  "point_triangle": 0}
        if (n != want_n or not same or not k1_equal or e_fr > 1e-6
                or e_sc > 1e-6 or e_rk > 1e-6 or len(b["scores"]) < 2
                or len(rec) != want_n["gpg_counts"]):
            fail(f"12a: the frame on the mesh (lazy_normals={lazy}) "
                 f"disagrees with the single-device frame")
        if lazy:
            out["by_path"]["mesh_frame"] = n
            out["frame_ms"] = ms

    # b. score_clouds on the mesh, a count that is not a multiple of pad_to
    rs = np.random.RandomState(12)
    clouds = (rs.rand(n_clouds, 500, 3) * 0.04 - 0.02).astype(np.float32)
    zero_counts()
    pm, qm, vm = sharded.score_clouds(clouds, seed=1)
    n = read_counts()
    ps, qs, vs = single.score_clouds(clouds, seed=1)
    e_q = float(np.abs(qm - qs).max())
    print(f"12b score_clouds of {n_clouds} clouds (pad_to {sharded.pad_to})"
          f" on the mesh: predictions equal {np.array_equal(pm, ps)}, votes "
          f"equal {np.array_equal(vm, vs)}, max |prob err| {e_q:.2e} (1e-6),"
          f" K2 launches {n['pointnet_trunk']} (2 per shard)", flush=True)
    if (not np.array_equal(pm, ps) or not np.array_equal(vm, vs)
            or e_q > 1e-6
            or n["pointnet_trunk"] != 2 * mesh.size * on_card):
        fail("12b: score_clouds on the mesh disagrees with the single device")

    # c. tensor parallelism: the eval forward, K2's 512-row instance
    model = single.model
    tp = shard_params_tp(model, make_2d_mesh(2, mp=2, device=named))
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((64, 500, 3), generator=g, device=dev) * 0.02
    widths = []

    def rec2(x_, folded):
        widths.append(int(folded[5].shape[0]))
        return launch2(x_, folded)

    with torch.no_grad():
        ref = model(x)
        zero_counts()
        k2._launch = rec2
        try:
            got = tp(x)
        finally:
            k2._launch = launch2
        n = read_counts()
    e_tp = max(float((got[0] - ref[0]).abs().max()),
               float((got[1] - ref[1]).abs().max()))
    print(f"12c TP eval forward, mp=2 on {named}, (64, 500): max |err| "
          f"against the replicated forward {e_tp:.2e} (2e-5); K2 launches "
          f"{n['pointnet_trunk']}, widths {widths}", flush=True)
    if e_tp > 2e-5 or (on_card and (n["pointnet_trunk"] != 4
                                    or widths != [512] * 4)):
        fail("12c: the TP forward disagrees or did not run K2's 512-row "
             "instance on every shard")
    out["by_path"]["tp_eval"] = n["pointnet_trunk"]
    feat = tp.rows[0].feat
    shard = feat.tp_shards.folded(feat, 0)
    k512 = {}
    for b_, n_ in ((64, 500), (128, 750)):
        xs = torch.randn((b_, n_, 3), generator=g, device=dev) * 0.02
        with torch.no_grad():
            got = k2.fused_trunk(xs, shard)
            want = k2.trunk_reference(xs, shard)
        sync()
        err = float((got - want).abs().max())
        bad = int(((got - want).abs() > K2_TOL * (1 + want.abs())).sum())
        k512[(b_, n_)] = (xs, err)
        print(f"12c K2<512> B,N=({b_}, {n_}): max |kernel - plain| = "
              f"{err:.3e} (tolerance 1e-4 * (1 + |plain|))", flush=True)
        if bad or not torch.isfinite(got).all() or got.shape != (b_, 512):
            fail(f"12c: K2's 512-row instance disagrees at ({b_}, {n_})")
    xs = k512[(64, 500)][0]
    w1, b1, w2, b2, w3, b3 = shard

    def library():
        h = torch.relu(torch.matmul(xs, w1) + b1)
        h = torch.relu(torch.matmul(h, w2) + b2)
        return torch.amax(torch.matmul(h, w3) + b3, dim=1)

    if on_card:
        ms512 = cuda_ms(torch, lambda: launch2(xs, shard), iters=50)
        plain512 = cuda_ms(torch, lambda: k2.trunk_reference(xs, shard),
                           iters=20)
        lib512 = cuda_ms(torch, library, iters=20)
    else:
        ms512 = plain512 = lib512 = float("nan")
    bound512 = k2_bounds(64, 500, 512)[0]
    print(f"12c K2<512> at (64, 500): kernel {ms512:.4f} ms, plain "
          f"{plain512:.4f} ms, library (3 matmul + max) {lib512:.4f} ms; "
          f"bound {bound512:.5f} ms (3xTF32, operations), "
          f"{100 * bound512 / ms512:.1f}% of it; K2<1024> in this run "
          f"{k2_1024_ms} ms against its bound {k2_bounds(64, 500)[0]:.5f} "
          f"ms ({card})", flush=True)
    out["k512"] = {
        "name": "pointnet_trunk_512", "route": "cuda",
        "source": "pointnetgpd_tpu_torch/csrc/pointnet_trunk.cu",
        "replaces": "pointnetgpd_tpu/ops/pointnet_trunk_pallas.py:106",
        "launches": out["by_path"]["tp_eval"],
        "launches_by_path": {"tp_eval": out["by_path"]["tp_eval"]},
        "max_abs_err": max(e for _, e in k512.values()),
        "ms": ms512, "plain_ms": plain512, "bound_ms": bound512,
        "bound_by": "operations", "library_ms": lib512}

    # d. the trainer over a process group on the one card
    torch.manual_seed(0)
    base = PointNetCls(k=2)
    batch_np = list(SyntheticGraspData(batch, cloud_points=cloud,
                                       learnable=True, seed=5).next_batch())
    batch_np[4] = np.asarray(batch_np[4], np.float32).copy()
    batch_np[4][batch // 2:batch // 2 + batch // 4] = 0.0   # second half
    args = [torch.as_tensor(a).to(dev) for a in batch_np]
    args[3], args[4] = args[3].long(), args[4].float()
    c_ev, _, v_ev = collect_grasp_clouds_batched(*args[:3], Draws(12, dev),
                                                 num_out=n_pts)
    ev1 = ttrain.make_eval_step()(copy.deepcopy(base).to(dev), c_ev, args[3],
                                  args[4] * v_ev.float())
    one = {}            # the 1-process steps: (metrics, grads, BN stats)
    for dt in (None, torch.float64):
        st, m = ttrain.make_fused_train_step(num_points=n_pts,
                                             compute_dtype=dt)(
            ttrain.init_train_state(copy.deepcopy(base).to(dev),
                                    ttrain.make_optimizer(0.005)),
            *args, Draws(11, dev))
        one[dt] = (m, {k_: p.grad.double().cpu()
                       for k_, p in st.model.named_parameters()},
                   {k_: v.double().cpu() for k_, v in
                    st.model.named_buffers() if "running" in k_})
    cropped, _, valid = collect_grasp_clouds_batched(
        *args[:3], Draws(11, dev), num_out=n_pts)
    m64 = copy.deepcopy(base).double().train()
    ttrain.masked_nll_loss(m64(cropped.cpu().double())[0], args[3].cpu(),
                           (args[4] * valid).cpu().double()).backward()
    g64 = {k_: p.grad for k_, p in m64.named_parameters()}
    # the float32 1-process step on the batch's rows in another order: the
    # same sum in another order, i.e. the step's own rounding
    perm = torch.randperm(batch, generator=torch.Generator().manual_seed(1))
    perm = perm.to(dev)
    mp_ = copy.deepcopy(base).to(dev).train()
    ttrain.masked_nll_loss(mp_(cropped[perm])[0], args[3][perm],
                           (args[4] * valid)[perm]).backward()
    g_perm = {k_: p.grad.double().cpu() for k_, p in mp_.named_parameters()}
    step = ttrain.make_fused_train_step(num_points=n_pts)
    st = ttrain.init_train_state(copy.deepcopy(base).to(dev),
                                 ttrain.make_optimizer(0.005))
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        st, _ = step(st, *args, Draws(13, dev))
    sync()
    ms1 = (time.perf_counter() - t0) / 3 * 1e3
    g_max = max(float(v.abs().max()) for v in g64.values())

    def err_of(grads, ref, keys):
        """(largest |grads - ref| over max|g|, its parameter) over keys."""
        return max(((float((grads[k_].double() - ref[k_].double()).abs()
                           .max()) / g_max, k_) for k_ in keys),
                   default=(0.0, ""))

    # the float64 step (``compute_dtype``) on the ranks is held to the
    # 1-process float64 step on every gradient, to 1e-4 x max|g|. In the
    # float32 step the trunks' gradients are ill-conditioned at this width
    # (ROADMAP Queue C items 2 and 15): reordering the batch's rows moves
    # the 1-process step by more than 1e-4 x max|g| outside the STN too. So
    # the float32 step on the ranks is held to it on the loss, the BN
    # statistics and the head's gradients, and on the trunks' (the STN's
    # and the feature trunk's) to the float64 step, at most twice the
    # 1-process step's error plus 1e-4, as in phase 8
    real = [k_ for k_ in g64 if float(g64[k_].abs().max()) >= 1e-10 * g_max]
    head = [k_ for k_ in real if not k_.startswith("feat.")]
    trunk = [k_ for k_ in real if k_.startswith("feat.")]
    rest = [k_ for k_ in real if not k_.startswith("feat.stn.")]
    g1 = one[None][1]
    e_trunk1 = err_of(g1, g64, trunk)[0]
    e_perm = err_of(g_perm, g1, rest)
    print(f"12d the float32 1-process step on {named} against itself on the "
          f"batch's rows in another order: gradients outside the STN "
          f"{e_perm[0]:.2e} x max|g| ({e_perm[1]}); its trunks' against "
          f"float64 {e_trunk1:.2e}", flush=True)
    case = dict(name="1v", gpd=False, model=base, batch=batch_np,
                num_points=n_pts, min_point_limit=50, seed=11, eval_seed=12,
                time_steps=3)
    case64 = dict(name="1v float64", gpd=False, model=base, batch=batch_np,
                  num_points=n_pts, min_point_limit=50, seed=11,
                  compute_dtype=torch.float64)
    runs = {}
    for world, backend in ((1, "nccl" if on_card else "gloo"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = run_step_ranks({"device": named, "cases": [case, case64]},
                               world, backend, timeout=300)
        wall = time.perf_counter() - t0
        bad = []
        for i, dt in enumerate((None, torch.float64)):
            m1, g1, bn1 = one[dt]
            r = [rk[i] for rk in ranks]
            rel = abs(r[0]["metrics"]["loss"] - float(m1["loss"])) / abs(
                float(m1["loss"]))
            e_bn = max(float(((r[0]["buffers"][k_].double() - v).abs()
                              / (1 + v.abs())).max())
                       for k_, v in bn1.items())
            ranks_equal = all(torch.equal(r[0]["grads"][k_], x_["grads"][k_])
                              for x_ in r[1:] for k_ in g1)
            if dt is None:
                e_head = err_of(r[0]["grads"], g1, head)
                e_rest = err_of(r[0]["grads"], g1, rest)
                e_trunk = err_of(r[0]["grads"], g64, trunk)
                grads_ok = (e_head[0] <= 1e-4
                            and e_trunk[0] <= 2 * e_trunk1 + 1e-4)
                said = (f"the head's gradients {e_head[0]:.2e} x max|g| "
                        f"from the 1-process step's (1e-4), all outside the "
                        f"STN {e_rest[0]:.2e} ({e_rest[1]}); the trunks' "
                        f"against float64 {e_trunk[0]:.2e} ({e_trunk[1]}) "
                        f"vs the 1-process step's {e_trunk1:.2e} (at most "
                        f"twice plus 1e-4)")
            else:
                e_all = err_of(r[0]["grads"], g1, real)
                grads_ok = e_all[0] <= 1e-4
                said = (f"every gradient {e_all[0]:.2e} x max|g| "
                        f"({e_all[1]}) from the 1-process step's (1e-4)")
            ok = (rel <= 1e-6 and e_bn <= 1e-5 and grads_ok and ranks_equal)
            line = (f"12d {r[0]['name']} train step on {world} rank(s) over "
                    f"{backend} on {named} (global batch {batch}, "
                    f"{int(batch_np[4].sum())} weighted): loss "
                    f"{r[0]['metrics']['loss']:.7f} vs 1-process "
                    f"{float(m1['loss']):.7f} (rel {rel:.2e}, 1e-6); BN "
                    f"running statistics {e_bn:.2e} x (1 + |ref|) (1e-5); "
                    f"{said}; ranks' gradients equal {ranks_equal}")
            if dt is None:
                ev = r[0]["eval"][0]
                ev_ok = (ev["count"] == float(ev1["count"])
                         and ev["correct"] == float(ev1["correct"])
                         and abs(ev["loss_sum"] - float(ev1["loss_sum"]))
                         <= 1e-5 * abs(float(ev1["loss_sum"])))
                ev_launches = sum(x_["eval"][1] for x_ in r)
                runs[world] = ev_launches
                ok = ok and ev_ok and (not on_card
                                       or ev_launches == 2 * world)
                line += (f"; eval sums {ev} vs 1-process "
                         f"{ {k_: float(v) for k_, v in ev1.items()} } equal "
                         f"{ev_ok}, K2 launches in the eval pass "
                         f"{[x_['eval'][1] for x_ in r]}; ms per step "
                         f"{[round(x_['ms'], 2) for x_ in r]} against "
                         f"{ms1:.2f} in one process; {wall:.1f} s with the "
                         f"ranks' start ({card}; one card, not scaling)")
            print(line, flush=True)
            if not ok:
                bad.append(r[0]["name"])
        if bad:
            fail(f"12d: the step ({bad}) on {world} rank(s) disagrees with "
                 f"the 1-process step")
    out["by_path"]["ddp_eval"] = runs[2]
    print(f"12 done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 13: the object database and its users


def icosphere_mesh(radius, subdivisions=2):
    """The octahedral sphere of tests/test_api.py (8 * 4^s triangles), for a
    small CPU rehearsal of phase 13."""
    from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D

    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], float)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    m = Mesh3D(v, f)
    for _ in range(subdivisions):
        m = m.subdivide()
    return (radius * m.vertices / np.linalg.norm(m.vertices, axis=1,
                                                 keepdims=True), m.triangles)


def database_phases(torch, card, dev="cuda", solid=("torus", TORUS),
                    sdf_dim=100, per_class=5):
    """Phase 13: the device work of the object database's path on ``dev``
    (see the module docstring). ``solid``: ("torus", (nu, nv, R, r)) or
    ("sphere", radius); sizes are parameters, so that the phase rehearses
    on the CPU at a small size. The database's own steps need h5py and its
    figures matplotlib; they are held on the CPU by the tests, and the
    phase says whether this machine has them. Returns K3's launches by path
    and the steps' times."""
    import importlib.util
    import tempfile

    from pointnetgpd_tpu_torch.api import DEFAULT_CONFIG
    from pointnetgpd_tpu_torch.database.mesh_processor import MeshProcessor
    from pointnetgpd_tpu_torch.draws import Draws
    from pointnetgpd_tpu_torch.geometry.io import read_sdf, write_obj
    from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
    from pointnetgpd_tpu_torch.geometry.sdf import surface_normal
    from pointnetgpd_tpu_torch.geometry.urdf_writer import UrdfWriter
    from pointnetgpd_tpu_torch.cli import tools
    from pointnetgpd_tpu_torch.grasping.gripper import Gripper
    vox = importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")
    from pointnetgpd_tpu_torch.ops import point_triangle as k3
    from pointnetgpd_tpu_torch.pipelines.generate_dataset import (
        label_grasps_for_object)

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    if on_card:                  # built before any launch is timed
        from pointnetgpd_tpu_torch import _build

        _build.library()
    t_phase = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("h5py", "matplotlib")}
    print(f"13: installed here {found}; the database's file (DexNet, the "
          f"scripted DexNetCli session, generate_gqcnn_dataset) and the "
          f"figures are held on the CPU by tests/test_torch_api.py and "
          f"tests/test_torch_database.py; this phase runs the path's device "
          f"work: generate_graspable (add_object's K3 launch), the labeling "
          f"loop that compute_simulation_data stores, UrdfWriter.write and "
          f"compare_normals' normals", flush=True)
    out = {"by_path": {}, "times": {}}
    problems = []
    launch3 = k3._launch
    events = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed3(points, tri_data, sup_data, stats=None):
        if not on_card:
            return launch3(points, tri_data, sup_data, stats)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        d2 = launch3(points, tri_data, sup_data, stats)
        end.record()
        events.append((start, end))
        return d2

    def k3_ms():
        sync()
        ms = sum(s.elapsed_time(e) for s, e in events)
        events.clear()
        return ms

    def counted(fn):
        """fn() with K3 timed; (result, K3 launches, wall s, K3 ms)."""
        events.clear()
        zero_counts()
        k3._launch = timed3
        try:
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            wall = time.perf_counter() - t0
        finally:
            k3._launch = launch3
        n = read_counts()
        if n["gpg_counts"] or n["pointnet_trunk"]:
            problems.append(f"K1 or K2 launched on the database path: {n}")
        return res, n["point_triangle"], wall, k3_ms()

    def host_line(name, wall, kms, n):
        print(f"13{name}: {wall * 1e3:.2f} ms wall (host clock), K3 "
              f"{kms:.4f} ms over {n} launch(es) (CUDA events), host share "
              f"{100 * (1 - kms / (wall * 1e3)):.2f}% ({card})", flush=True)
        out["times"][name] = {"wall_ms": wall * 1e3, "k3_ms": kms}

    kind, size = solid
    if kind == "torus":
        v, f = torus_mesh(*size)
    else:
        v, f = icosphere_mesh(size)
    config = {**DEFAULT_CONFIG, "grasps_per_class": per_class,
              "sdf_dim": sdf_dim}
    want_k3 = 1 if on_card else 0

    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, f"{kind}.obj")
        write_obj(obj, v, f)
        cache = os.path.join(tmp, "cache")

        # a. the object's SDF through K3 at the reference's settings
        proc = MeshProcessor(obj, cache_dir=cache, device=dev)
        (mesh, sdf, _), n_add, wall, kms = counted(
            lambda: proc.generate_graspable(config))
        host_line("a MeshProcessor.generate_graspable", wall, kms, n_add)
        key = proc.key
        out["by_path"]["mesh_processor"] = n_add
        print(f"13a generate_graspable({kind}, {len(f):,} triangles, sdf_dim "
              f"{sdf_dim}, padding {config['sdf_padding']}): K3 launches "
              f"{n_add}, sdf {sdf.dims} on {sdf.data.device}", flush=True)
        if n_add != want_k3:
            fail(f"13a: generate_graspable launched K3 {n_add} times, not "
                 f"{want_k3}")
        # its SDF is K3's mesh_to_sdf of the processed mesh (a launch
        # counted apart)
        direct = vox.mesh_to_sdf(mesh, dim=sdf_dim,
                                 padding=config["sdf_padding"], device=dev)
        same = (torch.equal(direct.data, sdf.data)
                and torch.equal(direct.origin, sdf.origin)
                and float(direct.resolution) == float(sdf.resolution))
        res = float(sdf.resolution)
        data = sdf.data.cpu().numpy()
        line = (f"13a SDF equal bit for bit to a direct mesh_to_sdf of the "
                f"processed mesh: {same}")
        if kind == "torus":
            err = float(np.abs(data - torus_sdf(grid_world(sdf),
                                                *size[2:])).max())
            line += (f"; max |sdf - analytic torus| {err:.3e} m = "
                     f"{err / res:.4f} res (limit 0.02 res)")
            if err > 0.02 * res:
                problems.append("13a: the SDF is off the analytic torus")
        print(line, flush=True)
        if not same:
            problems.append("13a: the SDF differs from mesh_to_sdf")

        # b. the labeling loop that compute_simulation_data stores
        gripper = Gripper()
        com = mesh.center_of_mass()
        first, _, wall, _ = counted(lambda: label_grasps_for_object(
            sdf, com, gripper, Draws(0, dev), grasps_per_class=per_class))
        rows, counts = first.rows, first.counts
        out["times"]["label_s"] = wall
        again = label_grasps_for_object(sdf, com, gripper, Draws(0, dev),
                                        grasps_per_class=per_class)
        same = (np.array_equal(rows, again.rows)
                and np.array_equal(counts, again.counts))
        busy = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                label_grasps_for_object(sdf, com, gripper, Draws(0, dev),
                                        grasps_per_class=per_class)
                sync()
            busy = device_busy(torch, prof)[0] / 1e3
        share = ("not measured" if busy is None else
                 f"{100 * (1 - busy / (wall * 1e3)):.2f}%")
        print(f"13b label_grasps_for_object({per_class} per class): "
              f"{wall:.3f} s wall, {len(rows)} rows, per class "
              f"{counts.tolist()}; equal bit for bit under the same draws "
              f"run to run: {same}; device busy "
              f"{'not measured' if busy is None else f'{busy:.2f} ms'} (a "
              f"profiled rerun), host share {share} of the wall ({card})",
              flush=True)
        out["times"]["label_device_busy_ms"] = busy
        if (not same or rows.shape[1] != 12 or rows.dtype != np.float32
                or not np.isfinite(rows).all() or len(rows) == 0):
            problems.append("13b: the labeled rows are malformed or differ "
                            "run to run")

        # c. the URDF writer: its decomposition voxelizes through K3
        lv = Mesh3D(*box_mesh([0, 0, 0], [2, 1, 1])).merge(
            Mesh3D(*box_mesh([0, 0, 1], [1, 1, 2])))
        path, n_urdf, wall, kms = counted(lambda: UrdfWriter(
            os.path.join(tmp, "urdf"), device=dev).write(lv, name="l"))
        host_line("c UrdfWriter.write", wall, kms, n_urdf)
        out["by_path"]["urdf"] = n_urdf
        with_plain_k3(lambda: UrdfWriter(os.path.join(tmp, "urdf_plain"),
                                         device=dev).write(lv, name="l"))
        names = sorted(os.listdir(os.path.join(tmp, "urdf")))
        same = names == sorted(os.listdir(os.path.join(tmp, "urdf_plain")))
        for n in names if same else ():
            with open(os.path.join(tmp, "urdf", n), "rb") as a, \
                    open(os.path.join(tmp, "urdf_plain", n), "rb") as b:
                same = same and a.read() == b.read()
        n_pieces = sum(n.endswith(".obj") for n in names)
        print(f"13c UrdfWriter.write(L shape, no pieces given): {n_pieces} "
              f"pieces, K3 launches {n_urdf}, URDF and piece files equal to "
              f"the plain K3 route's {same}", flush=True)
        if (n_urdf != want_k3 or not same or n_pieces < 2
                or os.path.basename(path) not in names):
            fail(f"13c: UrdfWriter launched K3 {n_urdf} times or its files "
                 f"differ from the plain route's")

        # d. compare_normals' device part on the object's SDF (the mesh
        # cache's .sdf)
        sdf_path = os.path.join(cache, f"{key}.sdf")
        t0 = time.perf_counter()
        idx, pts, n_dev, v_dev, knn_dev = tools.sdf_and_knn_normals(
            sdf_path, n_points=300, seed=0, device=dev)
        wall = time.perf_counter() - t0
        _, pts_c, n_cpu, v_cpu, knn_cpu = tools.sdf_and_knn_normals(
            sdf_path, n_points=300, seed=0, device="cpu")
        cpu_sdf = read_sdf(sdf_path, device="cpu")
        grid = cpu_sdf.surface_points[torch.as_tensor(idx)]
        got = {"normals": n_dev, "valid": v_dev}
        want = {"normals": n_cpu, "valid": v_cpu}
        unstable = np.zeros(len(idx), bool)
        for s in nudged_sdfs(cpu_sdf, "cpu"):
            nn, vv = surface_normal(s, grid)
            unstable |= lane_diff({"normals": nn.numpy(),
                                   "valid": vv.numpy()}, want, ("valid",))
        hold_routes(problems, "13d SDF plane-fit normals", got, want,
                    unstable, ("valid",))
        cos = np.abs(np.sum(knn_dev * knn_cpu, axis=1))
        agree = np.abs(np.sum(n_dev * knn_dev, axis=1))
        print(f"13d compare_normals({len(idx)} surface points): points "
              f"equal {np.array_equal(pts, pts_c)}, KNN normals up to sign "
              f"min |cos| card vs CPU {cos.min():.7f} (limit 1 - 1e-4), SDF "
              f"vs KNN |cos| mean {agree.mean():.3f}, {wall * 1e3:.1f} ms "
              f"({card})", flush=True)
        if not np.array_equal(pts, pts_c) or cos.min() < 1 - 1e-4:
            problems.append("13d: the KNN normals differ card vs CPU")

    if problems:
        fail("phase 13: " + "; ".join(problems))
    print(f"13 done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 14: the last modules

def rel_err(got, want):
    """max |got - want| / (1 + |want|) of two arrays or tensors."""
    got, want = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
                 for x in (got, want))
    return float((np.abs(got - want) / (1 + np.abs(want))).max()) \
        if want.size else 0.0


def window_err(a, b):
    """rel_err over two SurfaceWindows' windows, gradients, Hessian rows."""
    return max(rel_err(x, y) for x, y in zip(
        (a.proj_win, *a.grad, *a.hess_x, *a.hess_y),
        (b.proj_win, *b.grad, *b.hess_x, *b.hess_y)))


def last_modules_phases(torch, card, dev="cuda", torus_sdf=None, rows=None,
                        study=(3, 84000, 8192, 500),
                        parity_objects=("parity_box", "parity_torus_mesh"),
                        parity_kw=None, train_kw=None, epochs=3, n_info=8):
    """Phase 14 (see the module docstring) on ``dev``: surface windows on
    ``torus_sdf`` (a CPU SdfGrid) at the contacts of ``rows`` (labeled grasp
    rows), the normal-approximation study (``study``: scenes, raw points,
    cloud_pad_to, crop points), the training-parity experiment and a
    profiler trace of one frame. Sizes are parameters, so that the phase
    rehearses on the CPU at a small size (launch counts are checked on the
    card only). Returns the launches by path and the phase's numbers."""
    import tempfile

    from pointnetgpd_tpu_torch.geometry.sdf import SdfGrid
    from pointnetgpd_tpu_torch.grasping import surface_window as sw
    from pointnetgpd_tpu_torch.grasping.grasp import Contacts, close_fingers
    from pointnetgpd_tpu_torch.inference.scorer import GraspScorer
    from pointnetgpd_tpu_torch.models.pointnet import PointNetCls
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.pipelines import normal_approx_study as nas
    from pointnetgpd_tpu_torch.pipelines import parity
    from pointnetgpd_tpu_torch.robot.node import GraspDetector
    from pointnetgpd_tpu_torch.training import train as ttrain
    from pointnetgpd_tpu_torch.utils.profiling import StageTimer, device_trace

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    out = {"by_path": {}}
    problems = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def event_ms(fn):
        """(fn(), its CUDA-event ms; host ms off the card)."""
        if not on_card:
            t0 = time.perf_counter()
            return fn(), (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    def counts_ok(name, got, want):
        print(f"14{name}: launches {got} (want {want} on the card)",
              flush=True)
        if on_card and got != want:
            problems.append(f"{name}: launches {got}, want {want}")

    # a. contact surface windows on the torus at phase 9b's contacts
    sdf_cpu = torus_sdf
    sdf_dev = SdfGrid(*(t.to(dev) for t in sdf_cpu))
    closed = close_fingers(sdf_dev, torch.as_tensor(
        np.asarray(rows)[:, :10], device=dev))
    found = closed.found
    pts = closed.points[found].reshape(-1, 3)
    dirs = closed.in_directions[found].reshape(-1, 3)
    n_c = pts.shape[0]
    pts_c, dirs_c = pts.cpu(), dirs.cpu()
    zero_counts()
    win, ms_sdf = event_ms(lambda: sw.surface_window_sdf(sdf_dev, pts, dirs))
    e_sdf = rel_err(win, sw.surface_window_sdf(sdf_cpu, pts_c, dirs_c))
    raw_kw = dict(width=1e-2, num_steps=21, max_depth=1e-2, num_samples=32)
    raw = sw._projection_windows_raw(sdf_dev, pts, dirs, **raw_kw).cpu()
    raw_c = sw._projection_windows_raw(sdf_cpu, pts_c, dirs_c, **raw_kw)
    bad = (raw - raw_c).abs() > 1e-7
    excused = torch.zeros_like(bad)
    if bad.any():          # cells the CPU route itself moves under an ulp
        for s in nudged_sdfs(sdf_cpu, "cpu"):
            excused |= (sw._projection_windows_raw(
                s, pts_c, dirs_c, **raw_kw) - raw_c).abs() > 1e-7
    proj, ms_proj = event_ms(lambda: sw.surface_window_projection(
        sdf_dev, pts, dirs))
    e_proj = rel_err(proj, sw.surface_window_projection(sdf_cpu, pts_c,
                                                        dirs_c))
    sub = Contacts(*(f[found][:n_info] for f in closed))
    sub_c = Contacts(*(f.cpu() for f in sub))
    t0 = time.perf_counter()
    info = sw.grasp_surface_information(sdf_dev, sub)
    ms_info = (time.perf_counter() - t0) * 1e3
    info_c = sw.grasp_surface_information(sdf_cpu, sub_c)
    e_info = max(window_err(a, b) for pa, pb in zip(info, info_c)
                 for a, b in zip(pa, pb))
    n = read_counts()
    print(f"14a surface windows on the torus (sdf_dim "
          f"{sdf_cpu.dims[0]}) at {n_c} contacts of {len(rows)} labeled "
          f"rows ({int(found.sum())} closed): surface_window_sdf "
          f"{ms_sdf:.3f} ms, card vs CPU max rel err {e_sdf:.2e} (1e-6); "
          f"raw projection windows: {int(bad.sum())} of {bad.numel()} cells "
          f"off the CPU route by more than 1e-7 m, {int(excused.sum())} "
          f"cells that the CPU route moves under a one-ulp change (cap 1%); "
          f"surface_window_projection (21 x 21, 32 samples, 7x7 bilateral) "
          f"{ms_proj:.3f} ms, max rel err {e_proj:.2e} (1e-6); "
          f"grasp_surface_information ({len(info)} grasps, width 2e-2) "
          f"{ms_info:.2f} ms wall, windows, gradients and Hessian rows max "
          f"rel err {e_info:.2e} (1e-6); launches {n} ({card})", flush=True)
    if (e_sdf > 1e-6 or e_proj > 1e-6 or e_info > 1e-6
            or (bad & ~excused).any() or float(excused.float().mean()) > 0.01
            or n_c == 0 or len(info) != min(n_info, int(found.sum()))
            or any(n.values())):
        problems.append("14a: the surface windows differ card vs CPU")
    out["14a"] = dict(contacts=n_c, sdf_ms=ms_sdf, proj_ms=ms_proj,
                      info_ms=ms_info)

    # b. the normal-approximation study at full width, 3 scenes
    n_scenes, raw_points, pad, n_pts = study
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = PointNetCls(input_chann=3, k=3)
    cam = np.asarray([1.0, 1.0, 1.2], np.float32)
    t0 = time.perf_counter()
    nas.run_study(1, raw_points, 1000, pad, n_pts, model=model, device=dev)
    sync()
    warm_s = time.perf_counter() - t0
    timer = StageTimer()
    zero_counts()
    t0 = time.perf_counter()
    rows_s, yields = nas.run_study(n_scenes, raw_points, 0, pad, n_pts,
                                   model=model, device=dev, timer=timer)
    sync()
    study_s = time.perf_counter() - t0
    n = read_counts()
    n_frames = n_scenes * len(yields)
    counts_ok(f"b run_study ({n_scenes} scenes x {len(yields)} configs)",
              (n["gpg_counts"], n["pointnet_trunk"], n["point_triangle"]),
              (3 * n_frames, 2 * n_frames, 0))
    out["by_path"]["study"] = {"gpg_counts": n["gpg_counts"],
                               "pointnet_trunk": n["pointnet_trunk"]}
    summary = nas.summarize(rows_s, yields)
    print(f"14b run_study: {n_scenes} scenes of {raw_points:,} raw points, "
          f"cloud_pad_to {pad}, {n_pts}-point crops, {study_s:.2f} s (a "
          f"warm-up scene first: {warm_s:.2f} s); warm ms per frame by "
          f"StageTimer ({card}):\n{timer.report()}", flush=True)
    print(f"14b summary: {json.dumps(summary)}", flush=True)
    scorer = GraspScorer(model=model, k=3, num_points=n_pts, device=dev)
    dets = {name: GraspDetector(scorer, config=cfg)
            for name, cfg in nas.study_configs(pad).items()}
    scene0 = nas.make_scene(np.random.RandomState(0), raw_points)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    ex = dets["exact"].process_frame(scene0, cam, seed=0)
    sync()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20 \
        if on_card else None
    print(f"14b exact-KNN config (reference_parity) on scene 0: "
          f"{ex['points'].shape[0]:,} voxels, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, peak memory above "
          f"the frame's start "
          f"{'not measured' if peak is None else f'{peak:.1f} MiB'} "
          f"({card})", flush=True)
    out["14b"] = dict(ms=timer.summary(), summary=summary, exact_peak_mib=peak)

    def plain1(ctx, fx, sc, is_y):
        return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)

    launch1, launch2 = k1.GpgScanContext._launch, k2._launch
    for name, det in dets.items():
        got = det.process_frame(scene0, cam, seed=0)
        k1.GpgScanContext._launch, k2._launch = plain1, k2.trunk_reference
        try:
            want = det.process_frame(scene0, cam, seed=0)
        finally:
            k1.GpgScanContext._launch, k2._launch = launch1, launch2
        same = (got["n_valid"] == want["n_valid"]
                and np.array_equal(got["pred"], want["pred"])
                and np.array_equal(got["counts"], want["counts"])
                and len(got["scores"]) == len(want["scores"]))
        e_f = float(np.abs(got["all_frames"] - want["all_frames"]).max()) \
            if same and len(want["all_frames"]) else 0.0
        e_s = float(np.abs(got["all_scores"] - want["all_scores"]).max()) \
            if same and len(want["all_scores"]) else 0.0
        print(f"14b scene 0, {name}: n_valid {got['n_valid']} vs "
              f"{want['n_valid']} on the plain route, predictions and counts "
              f"equal {same}, max |frame err| {e_f:.2e} (1e-5), max |score "
              f"err| {e_s:.2e} (1e-4)", flush=True)
        if not same or e_f > 1e-5 or e_s > 1e-4:
            problems.append(f"14b {name}: the frame differs from its plain "
                            f"route")
    t0 = time.perf_counter()
    pinned = nas.run_pinned(n_scenes, raw_points, 0, device=dev)
    print(f"14b run_pinned ({n_scenes} scenes, 16,384 voxels each at most): "
          f"{json.dumps(pinned)}, {time.perf_counter() - t0:.2f} s",
          flush=True)
    out["14b"]["pinned"] = pinned
    if not (0.5 < pinned["window_cos_median"] <= 1.0
            and 0.5 < pinned["lazy_cos_median"] <= 1.0):
        problems.append("14b: pinned normals far off the exact ones")

    # c. the training-parity experiment: its dataset, then train_ours
    n_mesh = sum(o.endswith("_mesh") for o in parity_objects)
    root = tempfile.mkdtemp()
    try:
        zero_counts()
        t0 = time.perf_counter()
        meta = parity.build_parity_dataset(root, objects=list(parity_objects),
                                           device=dev, **(parity_kw or {}))
        sync()
        build_s = time.perf_counter() - t0
        n = read_counts()
        counts_ok("c build_parity_dataset",
                  (n["point_triangle"], n["gpg_counts"], n["pointnet_trunk"]),
                  (n_mesh, 0, 0))
        out["by_path"]["parity_dataset"] = n["point_triangle"]
        kw = dict(dict(sdf_dim=56), **(parity_kw or {}))
        for name in parity_objects:
            if not name.endswith("_mesh"):
                continue
            build = parity.PARITY_OBJECTS[name][0]
            got = build(kw["sdf_dim"], None, dev)
            want = with_plain_k3(lambda: build(kw["sdf_dim"], None, dev))
            ok, err = close_distances(got.data.abs(), want.data.abs())
            signs = torch.equal(got.data < 0, want.data < 0)
            print(f"14c {name}: sdf {got.dims}, K3 vs its plain route max "
                  f"|err| {err:.3e} (rtol, atol {K3_TOL}), signs equal "
                  f"{signs}", flush=True)
            if not (ok and signs):
                problems.append(f"14c: {name}'s SDF differs from the plain "
                                f"K3 route")
        views = meta["points_per_view"]
        n_views = (parity_kw or {}).get("views_per_object", 6)
        labels = []
        for obj in meta["objects"]:
            tr = np.load(f"{root}/PointNetGPD/data/ycb_grasp/train/{obj}.npy")
            te = np.load(f"{root}/PointNetGPD/data/ycb_grasp/test/{obj}.npy")
            clouds = sorted(os.listdir(
                f"{root}/data/ycb-tools/models/ycb/{obj}/rgbd/clouds"))
            pc = np.load(f"{root}/data/ycb-tools/models/ycb/{obj}/rgbd/"
                         f"clouds/{clouds[0]}")
            if (tr.shape != (meta["n_train"], 12)
                    or te.shape != (meta["n_test"], 12)
                    or len(clouds) != n_views or pc.shape != (views, 3)
                    or pc.dtype != np.float32):
                problems.append(f"14c: {obj}'s files are malformed")
            score = tr[:, -2] + 0.01 * tr[:, -1]
            labels.append(np.where(score >= 1.2, 0,
                                   np.where(score <= 0.5, 2, 1)))
        n_classes = len(np.unique(np.concatenate(labels)))
        print(f"14c build_parity_dataset({list(parity_objects)}, "
              f"{parity_kw or 'defaults'}): {build_s:.2f} s, n_train "
              f"{meta['n_train']}, n_test {meta['n_test']} per object, "
              f"{n_views} views of {views} points, {n_classes} classes in "
              f"the train rows ({card})", flush=True)
        if n_classes < 2:
            problems.append("14c: fewer than 2 classes in the train rows")

        make_step, make_eval = (ttrain.make_fused_train_step,
                                ttrain.make_eval_step)
        step_ms, evals = [], []

        def timed_step(*a, **k):
            step = make_step(*a, **k)

            def run(state, *batch):
                res, ms = event_ms(lambda: step(state, *batch))
                step_ms.append(ms)
                return res

            return run

        def recorded_eval(*a, **k):
            ev = make_eval(*a, **k)

            def run(model, clouds, labels, weights):
                res = ev(model, clouds, labels, weights)
                evals.append((model, clouds, labels, weights,
                              float(res["correct"])))
                return res

            return run

        ttrain.make_fused_train_step = timed_step
        ttrain.make_eval_step = recorded_eval
        zero_counts()
        t0 = time.perf_counter()
        try:
            hist = parity.train_ours(root, epochs=epochs, device=dev,
                                     **(train_kw or {}))
            sync()
        finally:
            ttrain.make_fused_train_step = make_step
            ttrain.make_eval_step = make_eval
        train_s = time.perf_counter() - t0
        n = read_counts()
        counts_ok("c train_ours eval (K2, 2 per eval batch)",
                  (n["pointnet_trunk"], n["gpg_counts"], n["point_triangle"]),
                  (2 * len(evals), 0, 0))
        out["by_path"]["parity_eval"] = n["pointnet_trunk"]
        per_epoch = len(evals) // epochs
        last = evals[-per_epoch:]
        eval_step = make_eval()
        k2._launch = k2.trunk_reference
        try:
            plain = [float(eval_step(m, c, lab, w)["correct"])
                     for m, c, lab, w, _ in last]
        finally:
            k2._launch = launch2
        kern = [e[-1] for e in last]
        print(f"14c train_ours ({epochs} epochs x {len(step_ms) // epochs} "
              f"steps, {train_kw or 'defaults: batch 64, 750 points, 12,000'
              '-point clouds, 3 classes, eval batch 64, reset quirk on'}): "
              f"losses {[round(x, 5) for x in hist['train_loss']]}, test "
              f"accuracy {hist['test_acc']}; {per_epoch} eval batches per "
              f"epoch; the last epoch's eval correct counts {kern} through "
              f"K2, {plain} through its plain version; train step "
              f"{np.mean(step_ms):.2f} ms mean (CUDA events, first "
              f"{step_ms[0]:.2f} ms), {train_s / epochs:.2f} s per epoch "
              f"(host clock) ({card})", flush=True)
        if (not np.isfinite(hist["train_loss"]).all() or kern != plain
                or len(hist["test_acc"]) != epochs or per_epoch < 1):
            problems.append("14c: train_ours' losses or its eval differ")
        out["14c"] = dict(build_s=build_s, step_ms=float(np.mean(step_ms)),
                          epoch_s=train_s / epochs, hist=hist)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    # d. a profiler trace of one study frame
    with tempfile.TemporaryDirectory() as tdir:
        with device_trace(tdir):
            dets["lazy"].process_frame(scene0, cam, seed=0)
        files = [f for f in os.listdir(tdir) if f.endswith(".pt.trace.json")]
        events = []
        for f in files[:1]:
            with open(os.path.join(tdir, f)) as fh:
                events = json.load(fh)["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    named = {k: any(k in n for n in kernels)
             for k in ("gpg_counts_kernel", "pointnet_trunk_kernel")}
    print(f"14d device_trace around one study frame: trace files "
          f"{files}, {len(events)} events, {len(kernels)} distinct CUDA "
          f"kernels, K1 and K2 named {named}", flush=True)
    if len(files) != 1 or (on_card and not (kernels and all(named.values()))):
        problems.append("14d: the trace names no CUDA kernel or misses K1 "
                        "or K2")

    if problems:
        fail("phase 14: " + "; ".join(problems))
    print(f"14 done in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


WF_SIZES = dict(objects=6, epochs=2, steps=5, per_class=4, seeds=150)


def examples_phases(torch, card, dev="cuda", wf=None, demo_steps=30,
                    wf_extra=(), parity_extra=()):
    """Phase 15 (see the module docstring) on ``dev``: the drivers of
    ``pointnetgpd_tpu_torch/examples/``. ``wf``: the workflow's depth
    (objects, epochs, steps per epoch, grasps per class, GPG seeds);
    ``wf_extra`` and ``parity_extra``: more driver flags (a CPU rehearsal
    passes its small sizes there). Launch counts are checked on the card
    only. Returns the launches by path and the phase's seconds."""
    import argparse
    import contextlib
    import io
    import shutil
    import tempfile

    from pointnetgpd_tpu_torch.examples import end_to_end_demo as demo
    from pointnetgpd_tpu_torch.examples import gt_robustness as gtr
    from pointnetgpd_tpu_torch.examples import integrated_workflow as iwf
    from pointnetgpd_tpu_torch.examples import train_parity_experiment as tpe
    from pointnetgpd_tpu_torch.geometry.io import read_sdf
    from pointnetgpd_tpu_torch.geometry.mesh import Mesh3D
    from pointnetgpd_tpu_torch.ops import gpg_counts as k1
    from pointnetgpd_tpu_torch.ops import point_triangle as k3
    from pointnetgpd_tpu_torch.ops import pointnet_trunk as k2
    from pointnetgpd_tpu_torch.pipelines import prepare_objects as prep

    vox = importlib.import_module("pointnetgpd_tpu_torch.ops.mesh_to_sdf")
    wf = dict(WF_SIZES, **(wf or {}))
    dev = torch.device(dev)
    dev_s = str(dev)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    out = {"by_path": {}}
    problems = []
    tmp = tempfile.mkdtemp()

    def passed(flag):
        """``flag`` and its value where ``wf_extra`` sets them, else []."""
        ex = list(wf_extra)
        return ex[ex.index(flag):ex.index(flag) + 2] if flag in ex else []

    def test_acc(text):
        accs = [float(ln.split("acc=")[1].split(",")[0])
                for ln in text.splitlines() if "Test done, acc=" in ln]
        return accs[-1] if accs else None

    def counts_ok(name, got, want):
        print(f"15{name}: launches {got} (want {want} on the card)",
              flush=True)
        if on_card and got != want:
            problems.append(f"{name}: launches {got}, want {want}")

    def plain1(ctx, fx, sc, is_y):
        return k1.gpg_scan_counts_torch(ctx.points, ctx.seeds, ctx.rot_rows,
                                        fx, sc, ctx.boxes, scan_is_y=is_y)

    @contextlib.contextmanager
    def plain_kernels():
        saved = (k1.GpgScanContext._launch, k2._launch, k3._launch)
        k1.GpgScanContext._launch = plain1
        k2._launch = k2.trunk_reference
        k3._launch = k3.min_point_triangle_dist2_torch
        try:
            yield
        finally:
            (k1.GpgScanContext._launch, k2._launch, k3._launch) = saved

    try:
        # a. the workflow: its stages in fresh processes, the detect stage
        # in this one
        root = os.path.join(tmp, "wf")
        md = os.path.join(tmp, "WORKFLOW.md")
        argv = ["--root", root, "--objects", str(wf["objects"]), "--epochs",
                str(wf["epochs"]), "--steps-per-epoch", str(wf["steps"]),
                "--grasps-per-class", str(wf["per_class"]), "--num-seeds",
                str(wf["seeds"]), "--out-md", md, "--device", dev_s,
                *wf_extra]
        print(f"15a: integrated_workflow {' '.join(argv[2:])} (variant 1v, "
              f"its widths: batch 64, 750 points, sdf_dim 100 and the "
              f"8192 bucket unless set above; depth cut from 20 objects, "
              f"20 epochs x 60 steps, 20 per class, 400 GPG seeds)",
              flush=True)
        zero_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            iwf.main(argv)
        wf_s = time.perf_counter() - t0
        detect_counts = read_counts()
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        times = summary["times_s"]
        det = summary["detect"]
        hist = summary["test_hist"]
        prior = max(hist) / max(sum(hist), 1)
        print(f"15a: every stage exited 0; {wf_s:.1f} s; stage wall s "
              f"({card}): {json.dumps(times)}", flush=True)
        print(f"15a: {summary['total_rows']} labeled rows; eval accuracy "
              f"{summary['eval_acc']} against the majority prior "
              f"{prior:.4f} (test labels {hist})", flush=True)
        for preset in iwf.PRESETS:
            d = det[preset]
            print(f"15a: {preset}: candidates {d['candidates']}, n_valid "
                  f"{d['n_valid']}, classes {d['pred_hist']}, approved "
                  f"{d['good_grasps']}, funnel {json.dumps(d['funnel'])}, "
                  f"ground truth {json.dumps(d['ground_truth'])}",
                  flush=True)
        n_pre = len(iwf.PRESETS)
        counts_ok("a workflow_detect", detect_counts,
                  {"gpg_counts": 3 * n_pre, "pointnet_trunk": 2 * n_pre,
                   "point_triangle": 0})
        out["by_path"]["workflow_detect"] = detect_counts

        # K3 at the prepare stage: one object again in this process (a
        # counted launch, the stage's file bit for bit) and through K3's
        # plain route (phase 7's tolerance)
        base = os.path.join(root, "PointNetGPD/data/ycb-tools/models/ycb")
        name = sorted(os.listdir(base))[0]
        gdir = os.path.join(base, name, "google_512k")
        copy = os.path.join(tmp, "prep", name)
        os.makedirs(os.path.join(copy, "google_512k"))
        shutil.copy(os.path.join(gdir, "nontextured.ply"),
                    os.path.join(copy, "google_512k"))
        sdf_dim = int((passed("--sdf-dim") or [None, 100])[1])
        zero_counts()
        prep.prepare_object_dir(copy, sdf_dim=sdf_dim, device=dev)
        prep_counts = read_counts()
        stage_sdf = read_sdf(os.path.join(gdir, "nontextured.sdf"),
                             device=dev)
        again = read_sdf(os.path.join(copy, "google_512k",
                                      "nontextured.sdf"), device=dev)
        mesh = Mesh3D(*prep.read_ply_mesh(os.path.join(
            gdir, "nontextured.ply"))).remove_bad_tris() \
            .remove_unreferenced_vertices()
        plain_sdf = with_plain_k3(lambda: vox.mesh_to_sdf(
            mesh, dim=sdf_dim, padding=5, device=dev))
        signs = bool(torch.equal(torch.signbit(stage_sdf.data),
                                 torch.signbit(plain_sdf.data)))
        ok, e_sdf = close_distances(stage_sdf.data, plain_sdf.data)
        same = bool(torch.equal(again.data, stage_sdf.data))
        print(f"15a: prepare stage's {name} SDF {tuple(stage_sdf.dims)}: "
              f"against K3's plain route signs equal {signs}, max |err| "
              f"{e_sdf:.3e} m (rtol 1e-4, atol 1e-7); rerun in this process "
              f"equal bit for bit {same}", flush=True)
        if not (signs and ok and same):
            problems.append("the prepare stage's SDF disagrees with K3's "
                            "plain route")
        counts_ok("a workflow_prepare (one object)", prep_counts,
                  {"gpg_counts": 0, "pointnet_trunk": 0,
                   "point_triangle": 1})
        out["by_path"]["workflow_prepare"] = prep_counts["point_triangle"]

        # K2 at the eval stage: the test split again in this process
        # through K2 and through its plain version
        ns = argparse.Namespace(variant="1v", epochs=wf["epochs"],
                                batch_size=int((passed("--batch-size")
                                                or [None, 64])[1]))
        cmd = iwf.eval_command(ns, root, os.path.join(
            root, "learned_models"))[1:] + passed("--cloud-points") + [
            "--device", dev_s]
        from pointnetgpd_tpu_torch.cli import train as cli_train

        def eval_acc():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_train.main(cmd)
            return test_acc(buf.getvalue())

        l2 = k2._launch
        rec_eval = []

        def rec_eval2(x, folded):
            rec_eval.append((x.clone(), folded))
            return l2(x, folded)

        zero_counts()
        k2._launch = rec_eval2
        try:
            acc_k2 = eval_acc()
        finally:
            k2._launch = l2
        eval_counts = read_counts()
        with plain_kernels():
            acc_plain = eval_acc()
        # each of the eval pass's K2 launches against its plain version
        e_k2, bad_k2 = 0.0, 0
        for x, folded in rec_eval:
            got, want = l2(x, folded), k2.trunk_reference(x, folded)
            bad_k2 += int(((got - want).abs()
                           > K2_TOL * (1 + want.abs())).sum())
            e_k2 = max(e_k2, float((got - want).abs().max()))
        shapes = sorted({tuple(x.shape) for x, _ in rec_eval})
        print(f"15a: the eval stage's accuracy {summary['eval_acc']}; in "
              f"this process through K2 {acc_k2}, through its plain "
              f"version {acc_plain}; the {len(rec_eval)} recorded K2 "
              f"launches {shapes} against trunk_reference: max |err| "
              f"{e_k2:.3e}, {bad_k2} entries past {K2_TOL} x (1 + |want|)",
              flush=True)
        if not (acc_k2 == acc_plain == summary["eval_acc"]):
            problems.append("the eval stage's accuracy differs in process "
                            "or through K2's plain version")
        if bad_k2:
            problems.append("the eval stage's K2 launches disagree with "
                            "trunk_reference")
        counts_ok("a workflow_eval", eval_counts,
                  {"gpg_counts": 0, "pointnet_trunk": 40,
                   "point_triangle": 0})
        out["by_path"]["workflow_eval"] = eval_counts["pointnet_trunk"]

        # the detect stage's reference_parity frame through both kernels
        # and through both plain versions
        names = sorted(os.listdir(base))
        kw = dict(seed=0, num_classes=2, num_seeds=wf["seeds"],
                  num_point=750, device=dev_s, presets=("reference_parity",))
        if passed("--cloud-pad-to"):
            kw["cloud_pad_to"] = int(passed("--cloud-pad-to")[1])
        ckpt = os.path.join(root, "learned_models")
        raw_k, raw_p = {}, {}
        with contextlib.redirect_stdout(io.StringIO()):
            iwf.detect_stage(root, ckpt, names, raw=raw_k, **kw)
            with plain_kernels():
                iwf.detect_stage(root, ckpt, names, raw=raw_p, **kw)
        a, b = raw_k["reference_parity"][0], raw_p["reference_parity"][0]
        e_fr = (float(np.abs(a["all_frames"] - b["all_frames"]).max())
                if len(a["all_frames"]) and a["n_valid"] == b["n_valid"]
                else 0.0)
        e_sc = (float(np.abs(a["all_scores"] - b["all_scores"]).max())
                if len(a["all_scores"]) and a["n_valid"] == b["n_valid"]
                else 0.0)
        same = (a["n_valid"] == b["n_valid"]
                and np.array_equal(a["pred"], b["pred"])
                and np.array_equal(a["counts"], b["counts"])
                and e_fr <= 1e-5 and e_sc <= 1e-4)
        print(f"15a: reference_parity frame against both plain versions: "
              f"n_valid {a['n_valid']} vs {b['n_valid']}, predictions and "
              f"counts equal {same}, max |frame err| {e_fr:.2e} (1e-5), "
              f"max |score err| {e_sc:.2e} (1e-4)", flush=True)
        if not same:
            problems.append("the detect stage disagrees with its plain "
                            "route")

        # b. gt_robustness on a's tree
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = gtr.main(["--root", root, "--num-seeds", str(wf["seeds"]),
                            "--device", dev_s] + passed("--cloud-pad-to"))
        gt_s = time.perf_counter() - t0
        gt_counts = read_counts()
        for arm, d in res.items():
            print(f"15b: {arm}: objects {d['scene_objects']}; production "
                  f"ground truth {json.dumps(d['production']['ground_truth'])}",
                  flush=True)
        print(f"15b: gt_robustness {gt_s:.1f} s ({card})", flush=True)
        counts_ok("b gt_robustness", gt_counts,
                  {"gpg_counts": 6 * n_pre, "pointnet_trunk": 4 * n_pre,
                   "point_triangle": 0})
        out["by_path"]["gt_robustness"] = gt_counts

        # c. the demo in this process, each launch held to its plain version
        rec = {"k1": [], "k2": [], "k3": []}
        l1, l2, l3 = k1.GpgScanContext._launch, k2._launch, k3._launch

        def rec1(ctx, fx, sc, is_y):
            rec["k1"].append((ctx, fx.clone(), sc.clone(), is_y))
            return l1(ctx, fx, sc, is_y)

        def rec2(x, folded):
            rec["k2"].append((x.clone(), folded))
            return l2(x, folded)

        def rec3(points, tri, sup, *rest):
            rec["k3"].append((points.clone(), tri.clone(), sup.clone()))
            return l3(points, tri, sup, *rest)

        zero_counts()
        k1.GpgScanContext._launch, k2._launch, k3._launch = rec1, rec2, rec3
        t0 = time.perf_counter()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                demo.main(["--steps", str(demo_steps), "--device", dev_s])
        finally:
            k1.GpgScanContext._launch, k2._launch, k3._launch = l1, l2, l3
        demo_s = time.perf_counter() - t0
        demo_counts = read_counts()
        for line in buf.getvalue().splitlines():
            print(f"15c: {line}", flush=True)
        errs = {"k1": 0, "k2": 0.0, "k3": 0.0}
        for ctx, fx, sc, is_y in rec["k1"]:
            got, want = l1(ctx, fx, sc, is_y), plain1(ctx, fx, sc, is_y)
            act = ctx.active
            errs["k1"] = max(errs["k1"], int((got[act] - want[act]).abs()
                                             .max()) if act.any() else 0)
        for x, folded in rec["k2"]:
            got, want = l2(x, folded), k2.trunk_reference(x, folded)
            if ((got - want).abs() > K2_TOL * (1 + want.abs())).any():
                problems.append("demo: K2 disagrees with its plain version")
            errs["k2"] = max(errs["k2"], float((got - want).abs().max()))
        for pts, tri, sup in rec["k3"]:
            ok, e = close_distances(l3(pts, tri, sup),
                                    k3.min_point_triangle_dist2_torch(
                                        pts, tri, sup))
            errs["k3"] = max(errs["k3"], e)
            if not ok:
                problems.append("demo: K3 disagrees with its plain version")
        if errs["k1"]:
            problems.append("demo: K1 disagrees with its plain version")
        print(f"15c: demo {demo_s:.1f} s ({card}); recorded launches K1 "
              f"{len(rec['k1'])}, K2 {len(rec['k2'])}, K3 {len(rec['k3'])},"
              f" each against its plain version: max |err| K1 {errs['k1']},"
              f" K2 {errs['k2']:.3e}, K3 {errs['k3']:.3e}", flush=True)
        if "demo complete" not in buf.getvalue():
            problems.append("the demo did not complete")
        counts_ok("c demo", demo_counts,
                  {"gpg_counts": 3, "pointnet_trunk": 2, "point_triangle": 1})
        out["by_path"]["demo"] = demo_counts

        # d. the registration driver needs h5py for its database
        try:
            import h5py  # noqa: F401
        except ImportError as e:
            print(f"15d: execute_grasp_registration not run: h5py is not "
                  f"installed on this machine ({e}); "
                  f"tests/test_torch_examples_drivers.py holds it against "
                  f"the JAX package on the CPU", flush=True)
        else:
            from pointnetgpd_tpu_torch.examples import \
                execute_grasp_registration as reg

            os.makedirs(os.path.join(tmp, "reg"))
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                r = reg.run(os.path.join(tmp, "reg"), device=dev_s)
            reg_counts = read_counts()
            print(f"15d: execute_grasp_registration {time.perf_counter() - t0:.1f}"
                  f" s ({card}): {len(r['configs'])} stored grasps, "
                  f"{int(r['collides'].sum())} in collision, best #{r['best']}",
                  flush=True)
            counts_ok("d registration", reg_counts["point_triangle"], 1)
            out["by_path"]["registration"] = reg_counts["point_triangle"]

        # e. the parity experiment's port half at its smallest size
        pargs = ["--root", os.path.join(tmp, "parity"), "--skip-reference",
                 "--objects", "parity_box", "parity_torus_mesh",
                 "--grasps-per-class", "2", "--max-rounds", "2", "--epochs",
                 "2", "--seeds", "1", "--device", dev_s, "--out-json",
                 os.path.join(tmp, "parity.json"), "--out-md",
                 os.path.join(tmp, "PARITY.md"), *parity_extra]
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tpe.main(pargs)
        par_s = time.perf_counter() - t0
        par_counts = read_counts()
        curves = json.load(open(os.path.join(tmp, "parity.json")))
        ours = curves["ours"][0]
        print(f"15e: train_parity_experiment --skip-reference "
              f"{' '.join(pargs[3:])}: {par_s:.1f} s ({card}); rows "
              f"{curves['meta']['n_train']} train / {curves['meta']['n_test']}"
              f" test per object, test accuracy {ours['test_acc']}, losses "
              f"{ours['train_loss']}, prior {curves['meta']['test_prior']}",
              flush=True)
        if not np.isfinite(ours["train_loss"]).all():
            problems.append("parity: a loss is not finite")
        print(f"15e: launches {par_counts}", flush=True)
        if on_card and (par_counts["point_triangle"] != 1
                        or par_counts["pointnet_trunk"] == 0
                        or par_counts["pointnet_trunk"] % 2):
            problems.append(f"parity: launches {par_counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        fail("phase 15: " + "; ".join(problems))
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15: {out['seconds']:.1f} s ({card})", flush=True)
    return out


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
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "wgmma" in line:
            print(f"  ptxas {line.strip()}")
    sass_check(_build.build())
    k3_ptxas()

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

    def rec2(x, folded):    # the model's cached FoldedTrunk, kept as is
        rec["k2"].append((x.clone(), folded))
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
    # edges, on this frame's cloud and its first 256 frames
    gen = torch.Generator(device=dev).manual_seed(1)
    sub = slice(0, min(256, ctx.f))
    n_sub = sub.stop
    fx0 = rec["k1"][0][1][sub]
    cases = [("32 unsorted shifts", ctx.points, act[sub], 32),
             ("1 shift", ctx.points, act[sub], 1),
             ("all frames active", ctx.points, None, 21),
             ("empty cloud", ctx.points[:0], act[sub], 21)]
    for label, cloud, active, ns in cases:
        cctx = k1.GpgScanContext(cloud, ctx.seeds[sub], ctx.rot_rows[sub],
                                 ctx.boxes, active=active)
        sc = (torch.rand((n_sub, ns), generator=gen, device=dev) - 0.5) * 0.1
        keep = cctx.active
        for is_y in (True, False):
            got = launch1(cctx, fx0, sc, is_y)
            want = k1.gpg_scan_counts_torch(cctx.points, cctx.seeds,
                                            cctx.rot_rows, fx0, sc,
                                            cctx.boxes, scan_is_y=is_y)
            torch.cuda.synchronize()
            if not (torch.equal(got[keep], want[keep])
                    and not got[~keep].any()):
                fail(f"K1 disagrees with its plain version: {label}, "
                     f"scan_is_y={is_y}")
        print(f"K1 {label} ({n_sub} frames, {int(keep.sum())} active, "
              f"P={cloud.shape[0]}): equal to the plain version on both "
              f"scan axes", flush=True)

    # 4. K2 vs plain
    torch.manual_seed(0)
    x_det, folded = rec["k2"][1]               # PointNetfeat trunk, (64, 500)
    x_big = torch.randn(512, 750, 3, device=dev) * 0.02
    k2_err = {}
    edges = [(f"{b}x{n}", torch.randn(b, n, 3, device=dev) * 0.02)
             for b, n in ((1, 300), (4, 1), (3, 129))]
    for name, x in (("64x500", x_det), ("512x750", x_big), *edges):
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
    k2_channel_models(torch, dev)

    # 5. main path
    n_frames = 3
    zero_counts()
    outs = [det.process_frame(pts, cam, seed=s) for s in range(n_frames)]
    launches = read_counts()
    print(f"main path: {n_frames} frames, launches {launches}", flush=True)
    if launches["gpg_counts"] != 3 * n_frames:
        fail("K1 did not launch 3 times per frame")
    if launches["pointnet_trunk"] != 2 * n_frames:
        fail("K2 did not launch twice per frame")
    if launches["point_triangle"] != 0:
        fail("K3 launched on the frame path")
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
    stream = torch.cuda.current_stream().cuda_stream
    timing["empty"] = cuda_ms(torch, lambda: _build.check(
        lib.empty_launch(stream), "empty_launch"), iters=200)
    k1_ms = sum(timing[f"k1_{i}"] for i in range(3))
    k1_wrap = sum(timing[f"k1_wrap_{i}"] for i in range(3))
    k1_plain = sum(timing[f"k1_plain_{i}"] for i in range(3))
    # K1 bound over the work these inputs need: only (active frame, real
    # point) pairs inside both fixed-axis slabs can count, each needing
    # three coordinate chains and the 16 box compares; bytes = the real
    # cloud + the active frames + the flags + the counts written
    k1_ops = k1_bytes = 0
    k1_pairs = []
    real_pts = ctx.points[:p_real]
    for _, fx, sc, is_y in rec["k1"]:
        ns = sc.shape[1]
        pairs = sum(int(k1.slab_pair_mask(
            real_pts, ctx.seeds[act][c0:c0 + 64],
            ctx.rot_rows[act][c0:c0 + 64], fx[act][c0:c0 + 64], ctx.boxes,
            scan_is_y=is_y).sum()) for c0 in range(0, n_act, 64))
        k1_pairs.append(pairs)
        k1_ops += pairs * K1_OPS_PER_PAIR
        k1_bytes += (p_real * 12 + n_act * (13 + ns) * 4 + ctx.f
                     + ctx.f * ns * 16)
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
    k2_bound = k2_bounds(*x_det.shape[:2])[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_timed = 5
    for s in range(n_timed):
        det.process_frame(pts, cam, seed=100 + s)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / n_timed * 1e3

    print(f"timings on {card}:", flush=True)
    print(f"  empty kernel on the same stream (launch-latency floor): "
          f"{timing['empty']:.4f} ms ({card})")
    for i, (_, _, sc, is_y) in enumerate(rec["k1"]):
        print(f"  K1 scan ns={sc.shape[1]} scan_is_y={is_y}: kernel "
              f"{timing[f'k1_{i}']:.4f} ms, with wrapper "
              f"{timing[f'k1_wrap_{i}']:.4f} ms, plain "
              f"{timing[f'k1_plain_{i}']:.3f} ms; {n_act} active frames, "
              f"{k1_pairs[i]} (frame, point) pairs inside both fixed slabs "
              f"of {n_act * p_real} ({card})")
    print(f"  K1 per frame (3 scans): kernel {k1_ms:.4f} ms, wrapper "
          f"overhead {k1_wrap - k1_ms:.4f} ms, plain {k1_plain:.3f} ms, "
          f"bound {k1_bound:.6f} ms ({k1_by}; {k1_ops:.3e} ops, {k1_bytes} "
          f"bytes), {100 * k1_bound / k1_ms:.2f}% of the bound ({card})")
    for name, x in (("64x500", x_det), ("512x750", x_big)):
        tc, fp32 = k2_bounds(*x.shape[:2])
        print(f"  K2 {name}: kernel {timing[f'k2_{name}']:.4f} ms, plain "
              f"{timing[f'k2_plain_{name}']:.4f} ms, library (3 matmul + "
              f"max) {timing[f'k2_library_{name}']:.4f} ms; bound "
              f"{tc:.5f} ms (3xTF32 tensor cores, operations), "
              f"{100 * tc / timing[f'k2_{name}']:.1f}% of it; all-fp32 "
              f"CUDA-core bound {fp32:.5f} ms ({card})")
    print(f"  frame: {frame_ms:.2f} ms warm per process_frame "
          f"(host clock, {n_timed} frames) ({card})", flush=True)

    if "--profile" in sys.argv:
        profile_frames(torch, det, pts, cam, card)

    # 7. the voxelizer path; 7f. K3 above the old cap
    k3_entry = voxelizer_phases(torch, card)
    k3_above_cap(torch, card)

    import shutil
    import tempfile

    keep = tempfile.mkdtemp()
    try:
        # 8. the training path
        train = training_phases(torch, card, "--profile" in sys.argv,
                                keep_dir=keep)
        # 9. the labeling path
        label = labeling_phases(torch, card)
        # 10. the online path's entry points
        entry = entry_phases(torch, card, ckpt_dir=train["model_path"],
                             trained=train["model"], frame_ms=frame_ms)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    # 11. the RGB-D -> cloud path
    clouds = cloud_phases(torch, card)
    # 12. data and tensor parallelism on the one card
    par = mesh_phases(torch, card, ckpt=ckpt,
                      k2_1024_ms=round(timing["k2_64x500"], 4))
    # 13. the object database and its users
    db = database_phases(torch, card)
    for site, n in db["by_path"].items():
        k3_entry["launches_by_path"][site] = (
            k3_entry["launches_by_path"].get(site, 0) + n)
    # 14. the last modules: surface windows, the study, the parity
    # experiment, a profiler trace
    last = last_modules_phases(torch, card, torus_sdf=label["torus_sdf"],
                               rows=label["9b_rows"])
    k3_entry["launches_by_path"]["parity_dataset"] = (
        last["by_path"]["parity_dataset"])
    # 15. the drivers of pointnetgpd_tpu_torch/examples/
    ex = examples_phases(torch, card)
    ex_by = ex["by_path"]
    k3_entry["launches_by_path"]["workflow_prepare"] = (
        ex_by["workflow_prepare"])
    k3_entry["launches_by_path"]["demo"] = ex_by["demo"]["point_triangle"]
    if "registration" in ex_by:
        k3_entry["launches_by_path"]["registration"] = ex_by["registration"]
    study = last["by_path"]["study"]
    mesh_frame = par["by_path"]["mesh_frame"]
    ros = entry["10d run_ros_node pipeline=False"]
    print(f"kernel launches by path: frame {launches['gpg_counts']} K1 and "
          f"{launches['pointnet_trunk']} K2 (3 frames), training eval "
          f"{train['eval_launches']} K2 (4 eval batches), labeling "
          f"{label['k1_launches']} K1 (3 SDF GPG sampler calls), cli.infer "
          f"{entry['10a cli.infer']['pointnet_trunk']} K2, dual scorer "
          f"{entry['10b dual']['pointnet_trunk']} K2, bf16 scorer "
          f"{entry['10b bf16']['pointnet_trunk']} K2, warmup "
          f"{entry['10c warmup']['gpg_counts']} K1 and "
          f"{entry['10c warmup']['pointnet_trunk']} K2 (its buckets), ROS "
          f"node {ros['gpg_counts']} K1 and {ros['pointnet_trunk']} K2 "
          f"(3 frames); the cloud path none (11a frame "
          f"{clouds['frame_ms']:.3f} ms); the mesh frame "
          f"{mesh_frame['gpg_counts']} K1 and {mesh_frame['pointnet_trunk']} "
          f"K2 (1 frame, 2 shards), the TP eval forward "
          f"{par['by_path']['tp_eval']} K2<512> (2 shards), the DDP eval "
          f"pass {par['by_path']['ddp_eval']} K2 (2 ranks); the study "
          f"{study['gpg_counts']} K1 and {study['pointnet_trunk']} K2 (3 "
          f"scenes x 4 configs), the parity eval "
          f"{last['by_path']['parity_eval']} K2; the workflow's detect "
          f"stage {ex_by['workflow_detect']['gpg_counts']} K1 and "
          f"{ex_by['workflow_detect']['pointnet_trunk']} K2 (3 presets), "
          f"its eval stage {ex_by['workflow_eval']} K2 (20 batches), "
          f"gt_robustness {ex_by['gt_robustness']['gpg_counts']} K1 and "
          f"{ex_by['gt_robustness']['pointnet_trunk']} K2, the demo "
          f"{ex_by['demo']['gpg_counts']} K1 and "
          f"{ex_by['demo']['pointnet_trunk']} K2; K3 "
          f"{k3_entry['launches_by_path']}", flush=True)
    print(f"labeling summary ({card}): {label['gps3']:.1f} labeled grasps/s "
          f"(3-D), {label['gps6']:.1f} (6-D); one torus object "
          f"{label['9b']['cold_s']:.2f} s cold, {label['9b']['warm_s']:.2f} s "
          f"warm, {label['9b']['rows']} rows in {label['9b']['rounds']} "
          f"rounds ({label['9b']['status']}); K1 on the SDF GPG samplers "
          f"{label['k1_ms']:.4f} ms over {label['k1_launches']} launches",
          flush=True)

    kernels = [
        {"name": "gpg_counts", "route": "cuda",
         "source": "pointnetgpd_tpu_torch/csrc/gpg_counts.cu",
         "replaces": "pointnetgpd_tpu/ops/gpg_counts_pallas.py:156",
         "launches": launches["gpg_counts"],
         "launches_by_path": {"frame": launches["gpg_counts"],
                              "labeling": label["k1_launches"],
                              "warmup": entry["10c warmup"]["gpg_counts"],
                              "ros_node": ros["gpg_counts"],
                              "mesh_frame": mesh_frame["gpg_counts"],
                              "study": study["gpg_counts"],
                              "workflow_detect":
                                  ex_by["workflow_detect"]["gpg_counts"],
                              "gt_robustness":
                                  ex_by["gt_robustness"]["gpg_counts"],
                              "demo": ex_by["demo"]["gpg_counts"]},
         "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "pointnet_trunk", "route": "cuda",
         "source": "pointnetgpd_tpu_torch/csrc/pointnet_trunk.cu",
         "replaces": "pointnetgpd_tpu/ops/pointnet_trunk_pallas.py:106",
         "launches": launches["pointnet_trunk"],
         "launches_by_path": {
             "frame": launches["pointnet_trunk"],
             "training_eval": train["eval_launches"],
             "cli_infer": entry["10a cli.infer"]["pointnet_trunk"],
             "dual_scorer": entry["10b dual"]["pointnet_trunk"],
             "bf16_scorer": entry["10b bf16"]["pointnet_trunk"],
             "warmup": entry["10c warmup"]["pointnet_trunk"],
             "ros_node": ros["pointnet_trunk"],
             "mesh_frame": mesh_frame["pointnet_trunk"],
             "tp_eval": par["by_path"]["tp_eval"],
             "ddp_eval": par["by_path"]["ddp_eval"],
             "study": study["pointnet_trunk"],
             "parity_eval": last["by_path"]["parity_eval"],
             "workflow_eval": ex_by["workflow_eval"],
             "workflow_detect": ex_by["workflow_detect"]["pointnet_trunk"],
             "gt_robustness": ex_by["gt_robustness"]["pointnet_trunk"],
             "demo": ex_by["demo"]["pointnet_trunk"]},
         "max_abs_err": k2_err["64x500"], "ms": timing["k2_64x500"],
         "plain_ms": timing["k2_plain_64x500"], "bound_ms": k2_bound,
         "bound_by": "operations",
         "library_ms": timing["k2_library_64x500"]},
        k3_entry,
        par["k512"],
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--warmup-child"]:
        warmup_child(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                     int(sys.argv[5]))
    else:
        main()
