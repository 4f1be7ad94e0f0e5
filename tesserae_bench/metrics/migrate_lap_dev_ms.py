"""Device time per round of the relabel's LAPs (the node-pair fan-out and
the node match, or the flat GPU match): the ``device_s`` of the ``lap.run``
stages under the ``lap.solve`` spans of the migration families."""

from tesserae_bench import spans

FAMILIES = ("migration_pairs", "migration_node", "migration_flat")


def read(ctx):
    return spans.per_round_ms(ctx, spans.lap_device_s(ctx, FAMILIES))
