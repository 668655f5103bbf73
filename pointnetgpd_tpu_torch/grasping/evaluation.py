"""Batched grasp-quality evaluation: close fingers -> contact wrenches ->
metric.

Port of ``pointnetgpd_tpu/grasping/evaluation.py`` (reference: the
per-grasp quality dispatch, dex-net/src/dexnet/grasping/quality.py:69-189,
and the friction-ladder labeling of generate-dataset-canny.py:109-133):
one ``close_fingers`` call, one cone construction and one metric
evaluation for G grasps at once. Each grasp of the ladder gets the
smallest friction at which it stays force closure, provided closure holds
contiguously from the top.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sdf as sdf_lib
from ..ops.fp import dot3v, sqrt
from . import quality
from .grasp import Contacts, close_fingers


class ContactWrenches(NamedTuple):
    forces: torch.Tensor   # (G, 2*F, 3) cone edges scaled by normal force
    torques: torch.Tensor  # (G, 2*F, 3)
    normals: torch.Tensor  # (G, 2, 3) inward normals scaled by normal force
    valid: torch.Tensor    # (G,) found, and both contacts hold (no slip)


def _per_grasp(friction_coef, configs):
    return torch.as_tensor(friction_coef, dtype=configs.dtype,
                           device=configs.device).expand(configs.shape[:1])


def contact_wrenches(contacts: Contacts, center_of_mass, friction_coef,
                     num_cone_faces: int = 8) -> ContactWrenches:
    """Friction cones, torques and normal-force scaling of each contact
    (quality.py:117-158, contacts.py:210-310). ``friction_coef``: a scalar
    or one value per grasp (G,)."""
    pts, in_normal, in_dir = (contacts.points, -contacts.normals,
                              contacts.in_directions)
    g = pts.shape[0]
    mu = torch.as_tensor(friction_coef, dtype=pts.dtype,
                         device=pts.device).expand(g)[:, None]   # (G, 1)
    # slip check (contacts.py:254-266)
    in_dir_hat = in_dir / quality.norm3(in_dir)[..., None]
    n_mag = torch.clamp(dot3v(in_dir_hat, in_normal), min=0.0)
    _, t1, t2 = quality.tangents_from_direction(in_normal)
    tan_mag = sqrt(dot3v(in_dir_hat, t1) ** 2 + dot3v(in_dir_hat, t2) ** 2)
    no_slip = mu * n_mag >= tan_mag                                # (G, 2)
    cone = quality.friction_cone(in_normal, mu, num_cone_faces)   # (G,2,F,3)
    arm = torch.as_tensor(center_of_mass, dtype=pts.dtype, device=pts.device)
    torq = quality.torques_from_forces((pts - arm)[..., None, :], cone)
    scale = n_mag[..., None, None]
    return ContactWrenches((scale * cone).reshape(g, -1, 3),
                           (scale * torq).reshape(g, -1, 3),
                           n_mag[..., None] * in_normal,
                           contacts.found & no_slip.all(dim=1))


def evaluate_force_closure(sdf: sdf_lib.SdfGrid, configs, friction_coef, *,
                           num_samples: int = 40,
                           check_approach: bool = False,
                           num_cone_faces: int = 8):
    """Force-closure labels (G,) int of (G, 10) configs: close the fingers,
    then the two-contact antipodality test (quality.py:108-112, 245-283).
    Returns (labels, contacts)."""
    contacts = close_fingers(sdf, configs, num_samples=num_samples,
                             check_approach=check_approach)
    p, n = contacts.points, contacts.normals
    fc = quality.force_closure(p[:, 0], n[:, 0], p[:, 1], n[:, 1],
                               _per_grasp(friction_coef, configs))
    return torch.where(contacts.found, fc, 0), contacts


def evaluate_ferrari_canny(sdf: sdf_lib.SdfGrid, configs, center_of_mass,
                           friction_coef, *, num_samples: int = 40,
                           check_approach: bool = False,
                           num_cone_faces: int = 8,
                           torque_scaling: float = 1.0):
    """Ferrari-Canny force-only labels (G,), the dataset metric
    (quality.py:626-723, config.yaml's ferrari_canny_L1_force_only).
    Returns (qualities, contacts)."""
    contacts = close_fingers(sdf, configs, num_samples=num_samples,
                             check_approach=check_approach)
    cw = contact_wrenches(contacts, center_of_mass,
                          _per_grasp(friction_coef, configs), num_cone_faces)
    eps = quality.ferrari_canny_l1_force_only(cw.forces)
    return torch.where(cw.valid, eps, 0.0), contacts


def evaluate_ferrari_canny_6d(sdf: sdf_lib.SdfGrid, configs, center_of_mass,
                              friction_coef, *, num_samples: int = 40,
                              check_approach: bool = False,
                              num_cone_faces: int = 8,
                              torque_scaling: float = 1.0):
    """Full 6-D Ferrari-Canny labels (G,): force and scaled torque rows
    (quality.py:527-623 with grasp_matrix :191-243) through
    ``ferrari_canny_l1_device_batch``, whose facet enumeration runs only for
    the grasps its hull guards accept. Returns (qualities, contacts)."""
    contacts = close_fingers(sdf, configs, num_samples=num_samples,
                             check_approach=check_approach)
    cw = contact_wrenches(contacts, center_of_mass,
                          _per_grasp(friction_coef, configs), num_cone_faces)
    g6 = torch.cat([cw.forces, torque_scaling * cw.torques], dim=2)
    return quality.ferrari_canny_l1_device_batch(g6, cw.valid), contacts


def friction_boundary_labels(sdf: sdf_lib.SdfGrid, configs, fc_list, *,
                             num_samples: int = 40, n_fc: int = 3):
    """The dataset friction ladder (generate-dataset-canny.py:109-133).

    fc_list: (n_fc,) DESCENDING frictions. A grasp is labeled fc_list[k],
    k the last index of the run of force-closure successes from index 0;
    grasps not force closure at fc_list[0] are invalid.
    Returns (label_fc (G,), label_idx (G,) int32, valid (G,))."""
    contacts = close_fingers(sdf, configs, num_samples=num_samples,
                             check_approach=False)
    fc_list = torch.as_tensor(fc_list, dtype=configs.dtype,
                              device=configs.device)
    p, n = contacts.points[:, None], contacts.normals[:, None]
    flags = quality.force_closure(p[..., 0, :], n[..., 0, :], p[..., 1, :],
                                  n[..., 1, :], fc_list[None, :])  # (G, n_fc)
    flags = flags * contacts.found[:, None].to(flags.dtype)
    label_idx = torch.cumprod(flags, dim=1).sum(dim=1).to(torch.int32) - 1
    valid = label_idx >= 0
    label_fc = fc_list[torch.clamp(label_idx, 0, n_fc - 1).long()]
    return torch.where(valid, label_fc, 0.0), label_idx, valid


# reference ladders (generate-dataset-canny.py:88-95)
FC_LIST_LESS_CLASS = np.round(np.array([2.0, 1.6, 0.6]), 2)
FC_LIST_FULL = np.round(
    np.concatenate([np.arange(2.0, 0.75, -0.4), np.arange(0.5, 0.36, -0.05)]), 2)
