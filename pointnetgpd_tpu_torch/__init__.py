"""PyTorch/CUDA port of ``pointnetgpd_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``grasping/``, ``inference/``, ``robot/``, ``geometry/``, ``pipelines/``,
``database/``) so every module's counterpart is easy to find. It imports
``torch`` and never ``jax``. The three TPU kernels (the GPG panel-count scan
and the PointNet trunk of the online frame, the min point-triangle distance
of the voxelizer) are hand-written CUDA C++ for ``sm_90a`` (``csrc/``),
built at first use by ``_build.py``; each has a plain PyTorch version beside
it that CPU tensors take.

Entry points (``GraspScorer``, ``GraspDetector``, ``gpg_sample_candidates``,
``prepare_object_dir``, ``MeshProcessor``, ``mesh_to_sdf``,
``approximate_convex_decomposition``, ``generate_for_object_dir`` and the
labeling CLI) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; the labeling functions run on their SDF's device.
"""

import torch as _torch

# MKL detects the CPU on its first vector-math call in a process, and
# threads that enter that call together can run the wrong kernel on their
# share of the tensor: one call on one element detects it on this thread
# first (ops/fp.py, ROADMAP Queue C item 24)
_torch.sqrt(_torch.ones(1))
