"""Share of the traced window in which no operation ran on the card: one
less the union of the profiler's CUDA kernel, copy and set intervals over
the window's length."""


def read(ctx):
    dev = ctx["device"]
    if dev is None or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
