"""Bytes the GPG panel-count scan (K1) has to move for one frame, counted
from its shapes: the cloud read once per scan, each frame's seed and axes
read once per scan, its shifts read and its four counts per shift written.
The three scans of a frame shift along y (the dy scan), along x (the
approach scan) and once at the final pose."""

from __future__ import annotations


def frame_bytes(n_points: int, n_frames: int, n_dy: int,
                approach_steps: int) -> int:
    per_scan_in = n_points * 3 * 4 + n_frames * (3 + 9 + 1) * 4
    shifts = n_dy + approach_steps + 1
    return 3 * per_scan_in + n_frames * shifts * (4 + 4 * 4)
