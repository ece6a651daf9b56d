"""The Mamba-2 decode step of one layer (``ops/ssm_step.py``,
``csrc/ssm_step.cu``), all batch rows and heads: operations and bytes at
batch ``b``. Each element of the bf16 state is read once and written once;
the step's x, B, C and dt inputs (bf16 slices of the in-projection's
output) are read once, the conv state (bf16, K - 1 inputs a channel) read
once and its shift written once, the conv's weights and bias (bf16) and
dt_bias, A_log and D (float32) read once, and y (float32) written once. z
is not the kernel's: the gated norm after it reads z. Operations: 6 a state
element (its decay, the input's outer product added in, the output's
product and sum) and the conv's 2 K a channel, in float32."""
from portbench.peaks import F32_FLOPS, bound_s


def step(b: int, heads: int = 64, head_dim: int = 64, d_state: int = 128,
         d_conv: int = 4) -> tuple[float, float]:
    inner = heads * head_dim
    conv_dim = inner + 2 * d_state
    state = b * heads * head_dim * d_state
    nbytes = (2 * 2 * state                          # state read and written
              + 2 * b * (conv_dim + heads)           # x, B, C, dt
              + 2 * 2 * b * conv_dim * (d_conv - 1)  # conv state read and written
              + 2 * conv_dim * (d_conv + 1)          # conv weights and bias
              + 4 * 3 * heads                        # dt_bias, A_log, D
              + 4 * b * inner)                       # y
    ops = 6 * state + 2 * b * conv_dim * d_conv
    return ops, nbytes


def bound(b: int, heads: int = 64, head_dim: int = 64, d_state: int = 128,
          d_conv: int = 4) -> float:
    ops, nbytes = step(b, heads, head_dim, d_state, d_conv)
    return bound_s(ops, nbytes, F32_FLOPS)
