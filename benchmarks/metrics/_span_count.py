"""Intervals of one ``record_function`` range of the program per unit, from
the traced window."""


def per_unit(ctx, name):
    if ctx.trace is None or not ctx.units:
        return None
    got = ctx.trace.spans.get(name)
    return len(got) / ctx.units if got else None
