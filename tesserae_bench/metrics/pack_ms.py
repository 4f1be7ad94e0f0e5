"""Packing (Algorithm 4) per round: the mean of ``decide()``'s ``pack_s``
stage timing over the window's rounds."""


def read(ctx):
    rounds = ctx["rounds"]
    if not rounds:
        return None
    return sum(r["timings"]["pack_s"] for r in rounds) / len(rounds) * 1e3
