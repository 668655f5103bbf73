"""Host time per unit in the program's ``gpg.seeds``: the sampler's seed stage
(above-table mask, seed draw and sort, Morton order, thetas and dys) (traced
window)."""

from benchmarks.metrics._span import per_unit_ms


def read(ctx):
    return per_unit_ms(ctx, "gpg.seeds")
