"""K5 (``migration_cost``)'s share of its roofline: the least time of the
window's launches (both sides' slot job ids and weights read once, the f64
(U, V) matrix written once, at the HBM's 3.35 TB/s;
``yardstick.migration_cost_bytes``) over the device time of
``migration_cost_kernel`` in the profiler's trace."""

from tesserae_bench import yardstick


def read(ctx):
    dev = ctx["device"]
    if dev is None:
        return None
    t = sum(s for name, s in dev["kernel_s"].items() if name.startswith("migration_cost_kernel"))
    shapes = ctx["launches"]["migration_cost"]
    if t <= 0 or not shapes:
        return None
    least = sum(yardstick.migration_cost_bytes(*shape) for shape in shapes) / yardstick.HBM_BW
    return 100.0 * least / t
