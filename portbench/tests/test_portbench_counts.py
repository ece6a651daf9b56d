"""Each kernel's operations and bytes, and each stage's operation count
held to ``FlopCounterMode`` over the frozen reference at a small width."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops
from portbench import weights as bench_weights
from portbench.kernels import k2, k3, k4
from portbench.reference import diffusion, hifigan, unified_voice, univnet


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode, torch.no_grad():
        fn()
    return mode.get_total_flops()


def made(model, name="m"):
    bench_weights.fill(model, name, 3)
    return model.eval()


def test_k2_step_at_full_width():
    # bytes-bound at every batch the cells run: the weights once a step
    ops, nbytes = k2.step(30, 1024, 1, 500)
    assert nbytes == 2 * (30 * (12 * 1024 ** 2 + 13 * 1024) + 2 * 30 * 500 * 1024
                          + 2 * 30 * 1024 + 2 * 1024)
    assert ops == 30 * (2 * 12 * 1024 ** 2 + 4 * 501 * 1024)
    assert k2.bound(30, 1024, 1, 500) == pytest.approx(nbytes / 3.35e12)
    assert k2.bound(30, 1024, 96, 566) == pytest.approx(2.2223e-3, rel=1e-3)


def test_k3_call_and_k4_forward():
    ops, nbytes = k3.call(16, 64, 100, [100, 60])
    assert ops == 4 * 16 * 64 * (100 ** 2 + 60 ** 2)
    assert nbytes == 4 * 16 * 64 * 2 * 160 + 16 * 199 * 4
    assert k3.calls_per_forward(10) == 13
    ops, nbytes = k4.forward(10)
    assert ops == sum(4 * 2 * 10 * h * 32 * 64 * 3 for h in (8, 64, 256))
    assert k4.bound(2186) == pytest.approx(0.526e-3, rel=1e-3)   # operation-bound in f32


def test_gpt_and_conditioning_encoder():
    g = made(unified_voice.GPT2(2, 64, 4))
    assert counted(lambda: g(torch.randn(3, 17, 64))) == flops.gpt(2, 64, 3, 17, causal=False)
    enc = made(unified_voice.ConditioningEncoder(80, 64, 6, 4))
    assert counted(lambda: enc(torch.randn(2, 30, 80))) == flops.conditioning_encoder(64, 30, 2)


def test_causal_gpt_counts_the_keys_a_query_sees():
    assert flops.gpt(1, 8, 1, 3) == 2 * 3 * 12 * 64 + 4 * 6 * 8
    assert flops.gpt(1, 8, 2, 1, 10) == 2 * 2 * 12 * 64 + 4 * 2 * 11 * 8


def test_diffusion_step():
    d = made(diffusion.DiffusionTts(64, 2, 4, 32))
    x, t = torch.randn(2, 20, 100), torch.tensor([5, 5])
    got = counted(lambda: d.step(x, t, torch.randn(2, 20, 64), torch.tensor([20, 20])))
    assert got == flops.diffusion_step(64, 2, [20, 20])


def test_univnet_and_hifigan():
    u = made(univnet.UnivNet())
    assert counted(lambda: u(torch.randn(1, 12, 100), torch.randn(1, 12, 64))) \
        == flops.univnet(12)
    h = made(hifigan.Hifigan(64, 512))
    frames = int(int(7 * 4) * 24000 / 22050)
    assert counted(lambda: h(torch.randn(1, 7, 64), torch.randn(1, 64))) \
        == flops.hifigan(frames, 64, 512)


def test_clvp_against_the_program_module():
    # CLVP has no reference model here: its count is held to the program's
    from tortoise_tpu_torch import weights as program_weights
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig
    c = CLVP(CLVPConfig(dim_text=64, dim_speech=64, dim_latent=64, text_enc_depth=2,
                        speech_enc_depth=3, text_heads=1, speech_heads=1))
    program_weights.init_random(c, 0)
    got = counted(lambda: c.score_candidates(torch.randint(0, 200, (1, 11)),
                                             torch.randint(0, 8000, (5, 13))))
    assert got == flops.clvp(64, 2, 3, 11, 13, 5)
