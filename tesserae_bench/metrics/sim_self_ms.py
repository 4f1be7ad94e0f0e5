"""The simulator's own work per round, from its spans: ``apply_events``,
the active-set scan (``sim.scan``), ``advance_round``, the plan's hand-over
(``sim.handover``) and the contention bookkeeping (``sim.contention``).
Needs ``sim.scan``; without it, ``None``."""

from tesserae_bench import spans

NAMES = ("apply_events", "sim.scan", "advance_round", "sim.handover", "sim.contention")


def read(ctx):
    found = spans.named(ctx, *NAMES)
    if not any(s.name == "sim.scan" for s in found):
        return None
    return spans.per_round_ms(ctx, sum(s.dur_s for s in found))
