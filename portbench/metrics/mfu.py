"""The whole request's share of the card's bf16 peak: the model operations
the traced requests needed (``counts.request_ops``, from their shapes) over
the traced window's seconds times 989 TFLOP/s."""
from portbench import counts
from portbench.peaks import BF16_FLOPS


def read(ctx):
    ops = sum(counts.request_ops(s, ctx.mix, ctx.config) for s in ctx.served)
    if ops <= 0 or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * ops / (ctx.trace["window_s"] * BF16_FLOPS)
