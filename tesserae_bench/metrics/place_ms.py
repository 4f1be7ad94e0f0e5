"""Policy sort and placement per round: the mean of ``decide()``'s
``schedule_s + place_s`` stage timings over the window's rounds."""


def read(ctx):
    rounds = ctx["rounds"]
    if not rounds:
        return None
    return sum(r["timings"]["schedule_s"] + r["timings"]["place_s"] for r in rounds) / len(rounds) * 1e3
