"""Labeled grasps per attempt over the traced window's units, read from
their outputs on the host."""


def read(ctx):
    if ctx.trace is None or not ctx.units:
        return None
    return sum(ctx.cell.labeled[:ctx.units]) / (ctx.units
                                                * ctx.cell.attempts)
