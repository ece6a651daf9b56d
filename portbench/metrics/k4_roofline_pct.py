"""K4's share of its roofline: the least time of the 12 calls of each
UnivNet forward of the traced requests (``kernels/k4.py``, float32) over
the device time of the ``K4`` family."""
from portbench import counts


def read(ctx):
    device_s = ctx.trace["by_family"].get("K4", 0.0)
    bound = sum(counts.k4_bound_s(s) for s in ctx.served)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
