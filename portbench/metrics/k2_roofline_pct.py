"""K2's share of its roofline: the least time of every decode step the
traced requests took (``kernels/k2.py`` at the step's batch and position)
over the device time of K2's kernels (the ``K2 gemm`` and ``K2 attention``
families) in the trace."""
from portbench import counts


def read(ctx):
    device_s = ctx.trace["by_family"].get("K2 gemm", 0.0) \
        + ctx.trace["by_family"].get("K2 attention", 0.0)
    bound = sum(counts.k2_bound_s(s, ctx.mix, ctx.config) for s in ctx.served)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
