"""Host time per unit in the sampler's scans: ``gpg.tiles`` (the Morton
tiles) and the three K1 scans with the glue that reads their counts,
``gpg.dy``, ``gpg.approach`` and ``gpg.final`` (traced window)."""

from benchmarks.metrics._span import per_unit_ms

SPANS = ("gpg.tiles", "gpg.dy", "gpg.approach", "gpg.final")


def read(ctx):
    got = [per_unit_ms(ctx, s) for s in SPANS]
    return None if None in got else sum(got)
