"""K5 per round, from its launch to the host matrix (the upload of the
slots, ``migration_cost`` and the ``.cpu()`` read-back of the f64 (U, V)
matrix): the wall time of the window's ``migrate.cost`` spans, per round."""

from tesserae_bench import spans


def read(ctx):
    found = spans.named(ctx, "migrate.cost")
    return spans.per_round_ms(ctx, sum(s.dur_s for s in found)) if found else None
