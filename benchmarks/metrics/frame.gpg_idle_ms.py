"""Device-idle time per frame inside the sampler's ``frame.gpg``: the part
of its intervals with no kernel, copy or fill on the card (traced window).
Near ``frame.gpg_ms``, the sampler waits on the host's dispatch."""

from benchmarks.metrics._idle_in import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "frame.gpg")
