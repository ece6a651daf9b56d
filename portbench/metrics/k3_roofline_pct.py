"""K3's share of its roofline: the least time of its calls in the traced
requests' diffusion steps (``kernels/k3.py``, 13 calls a step at the step's
batch and valid frames) over the device time of the ``K3`` family."""
from portbench import counts


def read(ctx):
    device_s = ctx.trace["by_family"].get("K3", 0.0)
    bound = sum(counts.k3_bound_s(s, ctx.config) for s in ctx.served)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
