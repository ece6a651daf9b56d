"""The hybrid prior (``models/granite_hybrid.py``, Granite-4.0-H's trunk under
Tortoise's heads) against the benchmark's plain reference
(``portbench/reference/granite_hybrid.py``, float32, the SSM as its per-token
recurrence) on the CPU at a tiny size that keeps both layer kinds, with the
benchmark's seeded weights on both sides.

Tolerances: both sides compute in float32 and differ only in the order of
their sums (the chunked scan against the recurrence, the conv, the
attention's products), a few float32 roundings of the largest values.
"""
import dataclasses
import json
import os

import pytest
import torch

from portbench import check, system, traffic
from portbench import weights as bench_weights
from portbench.reference import granite_hybrid as ref
from tortoise_tpu_torch.models import ar_sampler
from tortoise_tpu_torch.models.granite_hybrid import (GraniteVoice, GraniteVoiceConfig,
                                                      ssd_chunked)
from tortoise_tpu_torch.ops.ssm_step import ssm_decode_step

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SEED = 2 ** 31 + 2222
# four layers (three Mamba, one attention), 4 SSM heads of 32 with a
# 16-wide state, chunks of 4 tokens, so a prompt spans several
AR = dict(layers=4, model_dim=64, attention_layers=[2], num_attention_heads=2,
          num_key_value_heads=1, mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16,
          mamba_chunk_size=4, shared_intermediate_size=96, conditioning_heads=2,
          max_text_tokens=40, max_mel_tokens=40)
# float32 on both sides, other summation orders (see the module's text)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    program, reference = GraniteVoice(GraniteVoiceConfig(**AR)).eval(), ref.build(AR).eval()
    spec = bench_weights.fill(program, ref.NAME, SEED, ref.SUPPRESSED)
    assert spec == bench_weights.fill(reference, ref.NAME, SEED, ref.SUPPRESSED)
    return program, reference


def _inputs(seed: int = 0, codes: int = 11):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((1, AR["model_dim"]), generator=g) * 0.3,
            torch.randint(1, 255, (1, 9), generator=g),
            torch.randint(0, 8192, (1, codes), generator=g))


@torch.no_grad()
def test_prefill_then_decode_through_the_cache_gives_the_references_logits(models):
    program, reference = models
    cond, text, codes = _inputs()
    want, _ = reference.teacher_forced(cond, text, codes, True)
    cache = program.decode_cache(3, "cpu")
    prompt = program.compute_prompt(cond, text)
    assert prompt.shape[1] > 2 * AR["mamba_chunk_size"]
    h = program.prefill(prompt, cache).expand(3, -1)
    got = [program.hidden_to_mel_logits(h)]
    for i in range(codes.shape[1] - 1):
        h = program.decode_step(program.decode_embed(codes[:, i:i + 1].expand(3, 1), i)[:, 0],
                                cache)
        got.append(program.hidden_to_mel_logits(h))
    got = torch.stack(got, 1)
    assert int(cache["pos"]) == prompt.shape[1] + codes.shape[1] - 1
    for row in got:
        torch.testing.assert_close(row, want[0], **TOL)


def _recurrence(x, dt, a, bm, cm):
    b, t, h, p = x.shape
    state = torch.zeros(b, h, p, bm.shape[-1])
    ys = []
    for i in range(t):
        state = state * torch.exp(dt[:, i] * a)[..., None, None] \
            + (dt[:, i, :, None] * x[:, i])[..., None] * bm[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, i]))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("t", [1, 4, 11, 16])
def test_the_chunked_scan_is_the_recurrence(t):
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, 3, 8), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((2, t, 3), generator=g))
    a = -torch.exp(torch.randn(3, generator=g))
    bm, cm = torch.randn((2, t, 5), generator=g), torch.randn((2, t, 5), generator=g)
    y, state = ssd_chunked(x, dt, a, bm, cm, chunk=4)
    want_y, want_state = _recurrence(x, dt, a, bm, cm)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(state, want_state, **TOL)


@torch.no_grad()
def test_the_kernels_plain_step_continues_the_references_recurrence(models):
    """A Mamba mixer's chunked prefill of t - 1 tokens, then one decode step
    through ``ssm_decode_step``'s plain version, against the reference
    mixer's output at token t."""
    program, reference = models
    mixer, want_mixer = program.layers[0].mamba, reference.layers[0].mamba
    u = torch.randn((2, 10, AR["model_dim"]), generator=torch.Generator().manual_seed(5))
    want = want_mixer(u)
    _, state, conv = mixer(u[:, :-1])
    counters = torch.zeros(2, dtype=torch.int32)
    launches = ssm_decode_step.launches
    got = mixer.decode(u[:, -1], conv.contiguous(), state, counters)
    torch.testing.assert_close(got, want[:, -1], **TOL)
    torch.testing.assert_close(mixer(u)[0], want, **TOL)
    assert ssm_decode_step.launches == launches     # the CPU runs the plain version


@torch.no_grad()
def test_the_fan_out_equals_a_prefill_of_every_row(models):
    program, _ = models
    cond, text, _ = _inputs(1)
    prompt = program.compute_prompt(cond, text)
    cache = program.decode_cache(3, "cpu")
    last = program.prefill(prompt, cache)
    h, mamba, attn = program._trunk(prompt.expand(3, -1, -1))
    p = prompt.shape[1]
    # a batch of three rounds its products otherwise than one row (TOL)
    torch.testing.assert_close(last.expand(3, -1), h[:, -1], **TOL)
    for m, (state, conv) in enumerate(mamba):
        torch.testing.assert_close(cache["ssm"][m], state, **TOL)
        torch.testing.assert_close(cache["conv"][m], conv, **TOL)
    for a, (k, v) in enumerate(attn):
        torch.testing.assert_close(cache["k"][a, :, :, :p], k, **TOL)
        torch.testing.assert_close(cache["v"][a, :, :, :p], v, **TOL)
    assert int(cache["pos"]) == p


@torch.no_grad()
def test_the_reextracted_latents_match(models):
    program, reference = models
    cond, text, codes = _inputs(2, codes=17)
    got = program(cond, text, codes, wav_lengths=torch.tensor([17 * 1024]), return_latent=True)
    _, want = reference.teacher_forced(cond, text, codes, False)
    torch.testing.assert_close(got, want, **TOL)


def test_the_model_keeps_the_decode_cache_of_the_last_batch_size_only():
    program = GraniteVoice(GraniteVoiceConfig(**AR))
    first = program.decode_cache(3, "cpu")
    assert program.decode_cache(3, torch.device("cpu")) is first
    second = program.decode_cache(5, "cpu")
    assert second["ssm"].shape[1] == 5 and list(program._caches) == [(5, torch.device("cpu"))]
    assert program.decode_cache(3, "cpu") is not first


def test_ar_steps_counts_the_hybrids_decode_steps():
    with open(os.path.join(ROOT, "portbench", "tests", "tiny-granite.json")) as f:
        config = json.load(f)
    mix = traffic.load_mix(os.path.join(ROOT, "portbench", "tests", "tiny-preset.json"))
    driver = system.Driver(config, mix, SEED, "cpu", {"autoregressive_batch_size": 1})
    try:
        assert isinstance(driver.tts.autoregressive, GraniteVoice)
        gen = traffic.requests(mix, SEED)
        served = [driver.serve(next(gen)) for _ in range(2)]
    finally:
        driver.close()
    for s in served:
        assert s.batches == 2 and s.k2_steps == 0
        assert s.ar_steps == s.batches * (s.request.mel_tokens - 1)
    assert check.structure(served, mix, config) == (0, [])
    off, lines = check.structure([dataclasses.replace(served[0], ar_steps=served[0].ar_steps - 1)],
                                 mix, config)
    assert off == 1 and "AR decode steps" in lines[0]


def _quality(**kwargs):
    from tortoise_tpu_torch.api import TextToSpeech
    return TextToSpeech(device="cpu", enable_redaction=False, autoregressive_batch_size=2,
                        ar_config=GraniteVoiceConfig(**AR), **kwargs)


@pytest.mark.parametrize("make,option", [
    (lambda: GraniteVoiceConfig(**AR, heads=2), "heads"),
    (lambda: ref.build(dict(AR, heads=2)), "heads"),
    (lambda: _quality(gpt_weights="int8"), "gpt_weights"),
    (lambda: _quality(gpt_weights="int8_decode"), "gpt_weights"),
    (lambda: _quality(kv_cache_dtype="int8"), "kv_cache_dtype"),
    (lambda: _quality(gpt_fused_step=True), "gpt_fused_step"),
    (lambda: __import__("tortoise_tpu_torch.api", fromlist=["x"]).load_autoregressive(
        GraniteVoiceConfig(**AR), "bf16", "cpu", torch.float32, None, True, False,
        mesh=object()), "mesh"),
    (lambda: ar_sampler._prefill(GraniteVoice(GraniteVoiceConfig(**AR)),
                                 torch.zeros(1, AR["model_dim"]),
                                 torch.zeros(1, 4, dtype=torch.long),
                                 torch.Generator(), 2, ar_sampler.SamplerSettings(),
                                 torch.float32, batch_sharding=object()), "mesh"),
])
def test_an_unsupported_option_raises_naming_it(make, option):
    with pytest.raises((TypeError, ValueError), match=option):
        make()


def test_the_fast_api_refuses_the_hybrid():
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    with pytest.raises(ValueError, match="ar_config"):
        TextToSpeechFast(device="cpu", ar_config=GraniteVoiceConfig(**AR))
