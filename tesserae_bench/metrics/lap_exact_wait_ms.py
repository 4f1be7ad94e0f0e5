"""How long the matching engine's exact re-solves held up the round: the
``wait_ms`` of the window's ``lap.fallback`` spans (the join on the answer a
host worker solved while the auction ran), per round.  A program whose
``lap.fallback`` carries no ``wait_ms`` gives ``None``."""

from tesserae_bench import spans


def read(ctx):
    waits = [
        s.attrs["wait_ms"] for s in spans.named(ctx, "lap.fallback") if "wait_ms" in s.attrs
    ]
    if not waits:
        return None
    return spans.per_round_ms(ctx, sum(waits) * 1e-3)
