"""Migration relabelling (Algorithms 2+3: K5, its read-back, the fan-out
and the node match) per round: the mean of ``decide()``'s ``migrate_s``
stage timing over the window's rounds."""


def read(ctx):
    rounds = ctx["rounds"]
    if not rounds:
        return None
    return sum(r["timings"]["migrate_s"] for r in rounds) / len(rounds) * 1e3
