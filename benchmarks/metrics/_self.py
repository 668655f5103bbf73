"""Self time of one ``record_function`` range of the program: each of its
intervals less the union of the other ranges that lie inside it, mean per
unit in ms, from the traced window."""


def union_ns(intervals) -> int:
    out, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            out += e - s
            end = e
        elif e > end:
            out += e - end
            end = e
    return out


def per_unit_ms(ctx, name):
    if ctx.trace is None or not ctx.units:
        return None
    got = ctx.trace.spans.get(name)
    if not got:
        return None
    others = [(s, e) for s, e, n in ctx.trace.annotations
              if n != name]
    total = 0
    for a, b in got:
        inside = [(s, e) for s, e in others if a <= s and e <= b]
        total += (b - a) - union_ns(inside)
    return total * 1e-6 / ctx.units
