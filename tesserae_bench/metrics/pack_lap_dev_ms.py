"""Device time per round of packing's LAP (the rectangle of placed by
pending jobs on ``lap_auction``): the ``device_s`` of the ``lap.run``
stages under the ``lap.solve`` spans of family ``packing``."""

from tesserae_bench import spans


def read(ctx):
    return spans.per_round_ms(ctx, spans.lap_device_s(ctx, ("packing",)))
