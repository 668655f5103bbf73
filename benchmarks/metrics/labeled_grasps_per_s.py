"""Grasps labeled (valid in the sampler and on the ladder) over the whole
window (which ends in a synchronize), summed over its units."""


def read(ctx):
    return sum(ctx.cell.labeled[:ctx.units]) / ctx.window_s
