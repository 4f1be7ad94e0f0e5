"""The matching engine's host time per round: the window's ``lap.solve``
spans, less the device time of their ``lap.run`` stages (the auction's
upload, launch and readout on the card), per round.  Needs the engine's
stage spans (``lap.prepare`` and the rest); without them, ``None``."""

from tesserae_bench import spans


def read(ctx):
    solves = spans.named(ctx, "lap.solve")
    if not any(c.name == "lap.prepare" for s in solves for c in s.children):
        return None
    device = sum(
        c.device_s or 0.0 for s in solves for c in s.children if c.name == "lap.run"
    )
    return spans.per_round_ms(ctx, sum(s.dur_s for s in solves) - device)
