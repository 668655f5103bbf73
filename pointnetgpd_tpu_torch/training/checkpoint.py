"""Checkpoints of the whole training state, as torch files.

Port of ``pointnetgpd_tpu/training/checkpoint.py``. ``save_checkpoint``
writes ``ckpt_dir/step_{N}/`` holding

- ``model.pt``: the model's state_dict under the reference's names (a
  trained model loads with the reference's ``load_state_dict``, and with
  ``GraspScorer.from_checkpoint`` given the directory), and
- ``train_state.pt``: the optimizer's state_dict, its class and the step.

The reference checkpoints no optimizer (main_1v.py:60,176-179); here Adam's
moments round-trip. ``restore_checkpoint`` restores into a template state:
where the saved optimizer state's layout (its class, its parameter groups,
the shapes of its per-parameter tensors) differs from the template's, the
model and step are restored and the template's fresh optimizer is kept,
with a warning; where the layout matches, any damage fails loudly, as does
any damage to the model file.
"""

from __future__ import annotations

import os
import warnings

import torch

from ..models.convert import MODEL_FILE
from .train import TrainState

STATE_FILE = "train_state.pt"


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int | None = None):
    """Write ``state`` under ``ckpt_dir/step_{step}`` (default: its step)."""
    step = int(state.step) if step is None else int(step)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    files = {MODEL_FILE: state.model.state_dict(),
             STATE_FILE: {"optimizer": state.optimizer.state_dict(),
                          "optimizer_class": type(state.optimizer).__name__,
                          "step": int(state.step)}}
    for name, obj in files.items():
        tmp = os.path.join(path, f".{name}.{os.getpid()}.tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(path, name))
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{max(steps)}")


def _layout_matches(saved: dict, optimizer) -> bool:
    """Whether a saved optimizer state fits ``optimizer``: the same class,
    the same parameter groups, and per-parameter tensors that are scalars or
    of their parameter's shape."""
    if saved.get("optimizer_class") != type(optimizer).__name__:
        return False
    sd = saved["optimizer"]
    groups = [g["params"] for g in optimizer.param_groups]
    if [len(g["params"]) for g in sd["param_groups"]] != [len(g)
                                                          for g in groups]:
        return False
    ids = [i for g in sd["param_groups"] for i in g["params"]]
    params = dict(zip(ids, (p for g in groups for p in g)))
    for i, st in sd["state"].items():
        if i not in params:
            return False
        for v in st.values():
            if torch.is_tensor(v) and v.dim() and v.shape != params[i].shape:
                return False
    return True


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore the checkpoint at ``path`` into ``template`` (in place, on
    the template model's device) and return it."""
    dev = next(template.model.parameters()).device
    model_sd = torch.load(os.path.join(path, MODEL_FILE), map_location=dev,
                          weights_only=True)
    saved = torch.load(os.path.join(path, STATE_FILE), map_location=dev,
                       weights_only=True)
    template.model.load_state_dict(model_sd)
    if _layout_matches(saved, template.optimizer):
        template.optimizer.load_state_dict(saved["optimizer"])
    else:
        warnings.warn(
            "checkpoint optimizer state does not match the current "
            "optimizer layout; resuming with freshly initialized optimizer "
            "state", stacklevel=2)
    step = int(saved["step"])
    sched = template.scheduler
    sched.last_epoch = step
    for group, base in zip(template.optimizer.param_groups, sched.base_lrs):
        group["lr"] = base * sched.lr_lambdas[0](step)
    sched._last_lr = [g["lr"] for g in template.optimizer.param_groups]
    template.step = step
    return template


def params_to_numpy(model):
    """The model's state_dict as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
