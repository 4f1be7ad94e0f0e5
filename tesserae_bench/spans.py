"""What the per-layer readers share over the Tracer's spans of the traced
window (``ctx["spans"]``, its root spans): a walk over the tree and the
per-round mean.  A program without the spans a reader looks for gives
``None``, never an error."""


def walk(spans):
    """Every span of the forest, parents before children."""
    for s in spans:
        yield s
        yield from walk(s.children)


def named(ctx, *names):
    """The window's spans with one of ``names``."""
    return [s for s in walk(ctx["spans"]) if s.name in names]


def per_round_ms(ctx, seconds):
    """``seconds`` over the window's rounds, in ms; ``None`` without rounds
    or without a value."""
    rounds = len(ctx["rounds"])
    if not rounds or seconds is None:
        return None
    return seconds / rounds * 1e3


def lap_device_s(ctx, families):
    """The device time of the ``lap.run`` stages of the ``lap.solve`` spans
    of ``families``, summed; ``None`` where none carries one (no stage
    spans, or no device timer: the CPU, an exact host backend)."""
    timed = [
        c.device_s
        for s in named(ctx, "lap.solve")
        if s.attrs.get("family") in families
        for c in s.children
        if c.name == "lap.run" and c.device_s is not None
    ]
    return sum(timed) if timed else None
