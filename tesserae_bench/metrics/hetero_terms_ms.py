"""The typed cluster's own terms per round: the wall time of the window's
``migrate.penalties`` spans (the type and rack penalties added to the node
match's costs) and ``pack.types`` spans (the placed jobs' node types for
packing's per-type weights), summed, per round.  A program or a cluster
without either span gives ``None``."""

from tesserae_bench import spans


def read(ctx):
    found = spans.named(ctx, "migrate.penalties", "pack.types")
    return spans.per_round_ms(ctx, sum(s.dur_s for s in found)) if found else None
