"""``lap_auction``'s share of its roofline: the least time of the window's
solves (each benefit matrix read once and each assignment written once, at
the HBM's 3.35 TB/s; ``yardstick.lap_auction_bytes``) over the device time
of the auction kernels in the profiler's trace."""

from tesserae_bench import yardstick

KERNELS = ("auction_warp_kernel", "auction_cluster_kernel", "auction_wide_kernel")


def read(ctx):
    dev = ctx["device"]
    if dev is None:
        return None
    t = sum(s for name, s in dev["kernel_s"].items() if name.startswith(KERNELS))
    shapes = ctx["launches"]["lap_auction"]
    if t <= 0 or not shapes:
        return None
    least = sum(yardstick.lap_auction_bytes(*shape) for shape in shapes) / yardstick.HBM_BW
    return 100.0 * least / t
