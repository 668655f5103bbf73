"""Device-idle time inside one ``record_function`` range of the program:
the part of its intervals in which no kernel, copy or fill ran on the
card, mean per unit in ms, from the traced window."""

from bisect import bisect_right


def covered_ns(a, b, merged) -> int:
    """How much of [a, b] the sorted, disjoint intervals ``merged`` cover."""
    i = max(bisect_right(merged, a, key=lambda iv: iv[0]) - 1, 0)
    out = 0
    for s, e in merged[i:]:
        if s >= b:
            break
        out += max(0, min(b, e) - max(a, s))
    return out


def per_unit_ms(ctx, name):
    if ctx.trace is None or not ctx.units:
        return None
    got = ctx.trace.spans.get(name)
    if not got:
        return None
    busy = ctx.trace.busy
    idle = sum((b - a) - covered_ns(a, b, busy) for a, b in got)
    return idle * 1e-6 / ctx.units
