"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at its 700 W limit): the yardstick of every roofline and ``mfu``."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(ops: float, nbytes: float, flops_peak: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(ops / flops_peak, nbytes / HBM_BYTES_PER_S)
