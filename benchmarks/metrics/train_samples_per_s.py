"""Training samples stepped over the whole window (which ends in a
synchronize)."""


def read(ctx):
    return ctx.units * ctx.cell.items_per_unit / ctx.window_s
