"""PyTorch/CUDA port of ``pointnetgpd_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``grasping/``, ``inference/``, ``robot/``) so every module's counterpart is
easy to find. It imports ``torch`` and never ``jax``. The two TPU kernels of
the online grasp-detection frame are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built at first use by ``_build.py``; each has a plain PyTorch
version beside it that CPU tensors take.

Entry points (``GraspScorer``, ``GraspDetector``, ``gpg_sample_candidates``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
