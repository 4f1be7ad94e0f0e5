"""Packing's graph build per round (``build_packing_graph``: the benefit
matrix of placed by pending jobs, its edge count, the job identities): the
wall time of the window's ``pack.graph`` spans, per round."""

from tesserae_bench import spans


def read(ctx):
    found = spans.named(ctx, "pack.graph")
    return spans.per_round_ms(ctx, sum(s.dur_s for s in found)) if found else None
