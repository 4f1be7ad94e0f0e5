"""Device-to-host readouts of the matching engine per round: the window's
``match_stats["host_syncs"]`` summed, over its rounds."""


def read(ctx):
    rounds = ctx["rounds"]
    if not rounds:
        return None
    return sum(r["match_stats"].get("host_syncs", 0) for r in rounds) / len(rounds)
