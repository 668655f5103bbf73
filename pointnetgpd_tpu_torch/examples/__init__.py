"""The JAX package's drivers in ``examples/``, ported: each module has the
JAX file's name and runs as ``python -m pointnetgpd_tpu_torch.examples.<name>``
on the card unless ``--device cpu`` is given.

- ``integrated_workflow``: the offline flow through the stage CLIs (synthetic
  meshes -> SDFs -> labels -> split -> clouds -> train -> test -> infer),
  then the detector on a rendered tabletop with every candidate held to
  the scene objects' exact SDFs;
- ``gt_robustness``: that detect stage under a new sampler seed and on the
  next-largest objects;
- ``end_to_end_demo``: mesh -> SDF -> labels -> train -> score in one
  process;
- ``execute_grasp_registration``: stored grasps into the robot frame,
  collision-filtered, the best one;
- ``train_parity_experiment``: the training-parity experiment.
"""

from __future__ import annotations

import subprocess


def card_label(device) -> str:
    """What a timing is measured on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the device's name where nvidia-smi is missing), or
    ``cpu``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index < len(out):
        return out[index].strip()
    return torch.cuda.get_device_name(index)
