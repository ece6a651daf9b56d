"""The hybrid prior's decode on the card: kernel ``ssm_decode_step`` against
its plain version at the published widths. The decode step's CUDA graph is
held to the eager step in tests/test_torch_graphs_gpu.py.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax (tests/conftest.py imports jax; skip it there):

    python3 -m pytest --noconftest -m gpu tests/test_torch_granite_gpu.py

Without a CUDA device the cases skip.
"""
import pytest
import torch

from tortoise_tpu_torch.ops.ssm_step import (D_CONV, D_STATE, HEAD_DIM, ssm_decode_step,
                                             ssm_decode_step_plain)
from tortoise_tpu_torch.weights import float32_device

pytestmark = pytest.mark.gpu
HEADS = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs on the card")
    return float32_device("cuda")


def _step_inputs(batch: int, gen: torch.Generator):
    inner = HEADS * HEAD_DIM
    conv_dim = inner + 2 * D_STATE
    rand = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device="cuda") * scale
    zxbcdt = rand(batch, inner + conv_dim + HEADS).to(torch.bfloat16)
    return [zxbcdt[:, inner:inner + conv_dim], zxbcdt[:, inner + conv_dim:],
            rand(batch, conv_dim, D_CONV - 1).to(torch.bfloat16),
            rand(conv_dim, 1, D_CONV, scale=0.5).to(torch.bfloat16),
            rand(conv_dim, scale=0.1).to(torch.bfloat16),
            rand(HEADS, scale=0.5), rand(HEADS, scale=0.5), rand(HEADS),
            rand(batch, HEADS, HEAD_DIM, D_STATE, scale=0.3).to(torch.bfloat16),
            torch.zeros(batch, dtype=torch.int32, device="cuda")]


def test_kernel_matches_its_plain_version_at_b96(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = _step_inputs(96, gen)
    plain = [a.clone() for a in args]
    launches = ssm_decode_step.launches
    for step in range(3):       # the conv state shifts and the counters reset each step
        if step:
            fresh = torch.randn(args[0].shape, generator=gen, device="cuda").to(torch.bfloat16)
            for a in (args, plain):
                a[0].copy_(fresh)
        y = ssm_decode_step(*args)
        want = ssm_decode_step_plain(*plain[:9])
        torch.cuda.synchronize()
        # float32 sums over the 128 state values in another order, fused
        # multiply-adds: a few float32 roundings of y's largest values
        assert (y - want).abs().max() <= 1e-5 * want.abs().max()
        # the state is stored in bf16: a float32 value that lies by a hair on
        # the other side of a rounding boundary stores one bf16 step away;
        # where the update's terms cancel, the float32 roundings of the terms
        # (a few 2^-24 of the largest state) stand beside that step
        want_state = plain[8].float()
        step_size = want_state.abs() * 2.0 ** -7 + want_state.abs().max() * 2.0 ** -20
        assert ((args[8].float() - want_state).abs() <= step_size).all()
        assert (args[8] != plain[8]).float().mean() < 1e-3
        plain[8].copy_(args[8])
        assert torch.equal(args[2], plain[2])       # shifts of bf16 values: exact
        assert int(args[9].abs().sum()) == 0
    assert ssm_decode_step.launches == launches + 3
