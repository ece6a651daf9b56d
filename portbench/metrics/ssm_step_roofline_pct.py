"""The Mamba-2 decode-step kernel's share of its roofline: the least time
of its calls in the traced requests (``kernels/ssm_step.py`` at the
request's decode batch, one call a Mamba layer a decode step:
``Served.ar_steps`` x the Mamba layers) over the device time of the traced
window's device operations whose name holds ``ssm_decode_step`` (the
trace's ten longest; the kernel is among them where it does the step's
most work). None where the trace holds no such kernel."""
from portbench.kernels import ssm_step

KERNEL = "ssm_decode_step"


def read(ctx):
    device_s = sum(s for name, s in ctx.trace["device_ops"] if KERNEL in name)
    ar = ctx.config["autoregressive"]
    layers = ar["layers"] - len(ar["attention_layers"])
    bound = sum(s.ar_steps * layers * ssm_step.bound(
        s.batch, ar["mamba_n_heads"], ar["mamba_d_head"], ar["mamba_d_state"],
        ar["mamba_d_conv"]) for s in ctx.served)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s
