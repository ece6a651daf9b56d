"""K4, UnivNet's location-variable convolution (``ops/lvc.py``,
``csrc/lvc.cu``), float32: operations and bytes of the 12 calls of one
UnivNet forward over ``frames`` mel frames (three blocks of hop 8, 64 and
256, four layers each; 32 input and 64 output channels, 3 taps). The
input, the per-frame kernels and biases are read once, the output written
once."""
from portbench.peaks import F32_FLOPS, bound_s

CI, CO, TAPS, LAYERS = 32, 64, 3, 4
HOPS = (8, 64, 256)


def forward(frames: int) -> tuple[float, float]:
    ops = nbytes = 0
    for hop in HOPS:
        t = frames * hop
        ops += LAYERS * 2 * t * CI * CO * TAPS
        nbytes += LAYERS * 4 * (t * CI + frames * CI * CO * TAPS + frames * CO + t * CO)
    return ops, nbytes


def bound(frames: int) -> float:
    ops, nbytes = forward(frames)
    return bound_s(ops, nbytes, F32_FLOPS)
