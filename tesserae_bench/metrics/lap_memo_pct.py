"""Share of the window's LAP instances that the matching context served
from memory (``memo_instances``) among all instances it was asked for
(``warm_instances`` + ``cold_instances``; warm counts memo hits too), from
each round's ``match_stats``."""


def read(ctx):
    memo = total = 0
    for r in ctx["rounds"]:
        s = r["match_stats"]
        memo += s.get("memo_instances", 0)
        total += s.get("warm_instances", 0) + s.get("cold_instances", 0)
    if not total:
        return None
    return 100.0 * memo / total
