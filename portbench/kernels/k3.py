"""K3, the diffusion decoder's attention with a relative-position bias
(``ops/attn.py flash_rel_attention``, ``csrc/flash_rel_attn.cu``), bf16:
operations and bytes of one call. A row with ``t`` valid frames needs its
t x t scores and weighted sum (4 t^2 d a head); q, k, v of the valid frames
are read once, the output written once, the bias vector (H, 2T-1) float32
read once."""
from portbench.peaks import BF16_FLOPS, bound_s

COND_LAYERS = 3   # the conditioning DiffusionLayers before the main stack


def calls_per_forward(num_layers: int) -> int:
    return COND_LAYERS + num_layers


def call(heads: int, head_dim: int, frames: int, valid: list[int]) -> tuple[float, float]:
    ops = sum(4 * heads * t * t * head_dim for t in valid)
    nbytes = sum(4 * heads * t * head_dim * 2 for t in valid) + heads * (2 * frames - 1) * 4
    return ops, nbytes


def bound(heads: int, head_dim: int, frames: int, valid: list[int]) -> float:
    ops, nbytes = call(heads, head_dim, frames, valid)
    return bound_s(ops, nbytes, BF16_FLOPS)
