"""K2, the whole GPT-2 decode step over all layers (``ops/decode_step.py``,
``csrc/decode_step.cu``), bf16 weights and cache: operations and bytes of
one step at batch ``b`` whose new token sits at cache row ``pos`` (``pos``
rows of prefix). Every weight, bias and norm parameter and every prefix
row of the cache is read once; the new k and v rows and the hidden state
are written once; the embedding is read once."""
from portbench.peaks import BF16_FLOPS, bound_s

BYTES = 2   # bf16


def step(layers: int, c: int, b: int, pos: int) -> tuple[float, float]:
    weights = layers * (12 * c * c + 9 * c + 4 * c)            # denses, biases, two norms
    kv_read = 2 * layers * b * pos * c
    kv_write = 2 * layers * b * c
    io = 2 * b * c
    ops = layers * (2 * b * 12 * c * c + 4 * b * (pos + 1) * c)
    return ops, BYTES * (weights + kv_read + kv_write + io)


def bound(layers: int, c: int, b: int, pos: int) -> float:
    ops, nbytes = step(layers, c, b, pos)
    return bound_s(ops, nbytes, BF16_FLOPS)
