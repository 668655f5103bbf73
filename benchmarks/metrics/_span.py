"""Mean host time per unit of one ``record_function`` range of the
program, from the traced window, in ms."""


def per_unit_ms(ctx, name):
    if ctx.trace is None or not ctx.units:
        return None
    s = ctx.trace.span_s(name)
    return None if s is None else s / ctx.units * 1e3
