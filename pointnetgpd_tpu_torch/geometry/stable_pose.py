"""StablePose container + .stp file IO.

The port's own copy of ``pointnetgpd_tpu/geometry/stable_pose.py`` (numpy
only).

(reference: meshpy/meshpy/stable_pose.py:12-85 and stp_file.py — probability,
rotation, support point; T_obj_table builds the object-on-table transform.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class StablePose:
    p: float                      # probability of the pose
    r: np.ndarray                 # (3, 3) rotation, world rows in obj coords
    x0: np.ndarray                # support point on the face
    face: np.ndarray | None = None
    stp_id: str = ""

    @property
    def T_obj_table(self) -> np.ndarray:
        """4x4 transform placing the object resting on the z=0 table
        (stable_pose.py:45-85): rotate by r, then lift so the support point
        sits on the plane."""
        t = np.eye(4)
        t[:3, :3] = self.r
        lifted = self.r @ self.x0
        t[2, 3] = -lifted[2]
        return t

    @classmethod
    def from_dict(cls, d: dict, stp_id: str = "") -> "StablePose":
        return cls(p=float(d["p"]), r=np.asarray(d["r"]),
                   x0=np.asarray(d["x0"]), face=d.get("face"), stp_id=stp_id)


def write_stp(path: str, poses) -> None:
    """Text .stp format: p line, then 3 rotation rows, per pose
    (meshpy/meshpy/stp_file.py layout)."""
    with open(path, "w") as f:
        f.write(f"#{len(poses)} stable poses\n")
        for i, pose in enumerate(poses):
            p = pose["p"] if isinstance(pose, dict) else pose.p
            r = np.asarray(pose["r"] if isinstance(pose, dict) else pose.r)
            f.write(f"p {p}\n")
            for row in r:
                f.write("r " + " ".join(str(v) for v in row) + "\n")


def read_stp(path: str):
    poses = []
    p, rows = None, []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            tok = line.split()
            if tok[0] == "p":
                p = float(tok[1])
                rows = []
            elif tok[0] == "r":
                rows.append([float(v) for v in tok[1:4]])
                if len(rows) == 3:
                    poses.append(StablePose(p=p, r=np.asarray(rows),
                                            x0=np.zeros(3),
                                            stp_id=f"pose_{len(poses)}"))
    return poses
