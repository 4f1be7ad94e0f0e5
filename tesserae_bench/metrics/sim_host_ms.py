"""Host time per round outside ``decide()``: the simulator's bookkeeping
(``apply_events``, ``advance_round``, the active-set scan, the hand-over of
the plan), read as the traced window's wall time less the Tracer's
``decide`` spans, per round."""


def read(ctx):
    rounds = len(ctx["rounds"])
    decide = [s.dur_s for s in _walk(ctx["spans"]) if s.name == "decide"]
    if not rounds or not decide:
        return None
    return (ctx["window_s"] - sum(decide)) / rounds * 1e3


def _walk(spans):
    for s in spans:
        yield s
        yield from _walk(s.children)
