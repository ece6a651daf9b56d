"""The hybrid prior's decode on the card: kernel ``ssm_decode_step`` against
its plain version at the published widths, and the decode step's CUDA graph
against the eager step.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax (tests/conftest.py imports jax; skip it there):

    python3 -m pytest --noconftest -m gpu tests/test_torch_granite_gpu.py

Without a CUDA device the cases skip.
"""
import pytest
import torch

from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
from tortoise_tpu_torch.models.granite_hybrid import GraniteVoice, GraniteVoiceConfig
from tortoise_tpu_torch.ops.ssm_step import (D_CONV, D_STATE, HEAD_DIM, ssm_decode_step,
                                             ssm_decode_step_plain)
from tortoise_tpu_torch.weights import cast_for_inference, float32_device, init_random

pytestmark = pytest.mark.gpu
HEADS = 64
# a period of both layer kinds at the published widths
SMALL = GraniteVoiceConfig(layers=4, attention_layers=(2,))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel and the graph run on the card")
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


def _small_model(seed: int = 3) -> GraniteVoice:
    with torch.device("cuda"):
        model = GraniteVoice(SMALL)
    init_random(model, seed)
    return cast_for_inference(model, torch.bfloat16).eval()


@torch.inference_mode()
def test_graph_replay_equals_the_eager_step_over_50_steps(cuda):
    model = _small_model()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = 8
    prompt = torch.randn((1, 30, SMALL.model_dim), generator=gen, device="cuda") \
        .to(torch.bfloat16) * 0.05
    graphed = model.decode_cache(b, cuda)
    model.prefill(prompt, graphed)
    eager = {k: v.clone() for k, v in graphed.items() if torch.is_tensor(v)}
    captures, replays = GraniteVoice.graph_captures, GraniteVoice.graph_replays
    for step in range(50):
        x = (torch.randn((b, SMALL.model_dim), generator=gen, device="cuda") * 0.05) \
            .to(torch.bfloat16)
        got = model.decode_step(x, graphed)
        want = model._decode_layers(x, eager)
        assert torch.equal(got, want), (step, (got - want).abs().max().item())
    for name in ("ssm", "conv", "k", "v", "pos"):
        assert torch.equal(graphed[name], eager[name]), name
    assert GraniteVoice.graph_captures == captures + 1
    assert GraniteVoice.graph_replays == replays + 49


@torch.inference_mode()
def test_the_graph_is_captured_once_and_replayed_every_later_step(cuda):
    model = _small_model()
    cond = torch.randn((1, SMALL.model_dim), device="cuda").to(torch.bfloat16) * 0.1
    text = torch.tensor([[5, 6, 7, 8, 0, 0]], device="cuda")
    settings = SamplerSettings(max_generate=20, emit_latents=False)
    mamba_layers = len(SMALL.mamba_layers)
    for call in range(2):
        captures, replays = GraniteVoice.graph_captures, GraniteVoice.graph_replays
        launches = ssm_decode_step.launches
        codes, _ = sample_speech(model, cond, text, torch.Generator(device="cuda").manual_seed(4),
                                 4, settings)
        steps = settings.max_generate - 1
        assert codes.shape == (4, settings.max_generate)
        assert GraniteVoice.graph_captures == captures + (call == 0)
        assert GraniteVoice.graph_replays == replays + steps - (call == 0)
        assert ssm_decode_step.launches == launches + steps * mamba_layers
