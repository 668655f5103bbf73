"""Host time per unit in the program's ``gpg.local_frames``: the sampler's
local frames (the covariance eigenframes, with the lazy window normals inside)
(traced window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "gpg.local_frames")
