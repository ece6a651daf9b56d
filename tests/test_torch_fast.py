"""The fast/streaming path of the port against the JAX package at tiny
configs: interpolation, HiFi-GAN, the random-latent generator, streaming
decode, and TextToSpeechFast's tts / tts_stream / tts_batch on shared
weights (float32, the fast path's bf16 KV cache on both sides).

RNG streams differ between torch and JAX, so the end-to-end comparisons
sample with top_k=1 (the single most likely token after the repetition
penalty: both frameworks emit the same codes) or start from injected codes;
the stop token's logit is pushed down so that no request stops by chance
(a test that needs a stop plants one)."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import api_fast as jfast
from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxConfig
from tortoise_tpu.models.hifigan import HifiganConfig as JaxHifiConfig
from tortoise_tpu.models.hifigan import HifiganGenerator as JaxHifi
from tortoise_tpu_torch import api_fast as pfast
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
from tortoise_tpu_torch.models.hifigan import HifiganConfig, HifiganGenerator

torch.set_num_threads(2)

AR = dict(layers=2, model_dim=128, heads=4, max_text_tokens=60, max_mel_tokens=80)
STOP = 8193
TEXT = "Hello there, a short test."


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# --- interpolation ------------------------------------------------------------

@pytest.mark.parametrize("case", ["linear_x4", "linear_160_147", "nearest", "windowed"])
def test_interpolation_matches_jax(case):
    """Same index math as the JAX package (f32, 1e-6)."""
    from tortoise_tpu.ops import interpolate as ji
    from tortoise_tpu_torch.ops import interpolate as pi

    x = np.random.default_rng(0).standard_normal((2, 37, 8)).astype(np.float32)
    if case.startswith("linear"):
        scale = 4.0 if case == "linear_x4" else 24000 / 22050
        pairs = [(pi.linear_interpolate(_t(x), scale), ji.linear_interpolate(jnp.asarray(x), scale))]
    elif case == "nearest":
        pairs = [(pi.nearest_interpolate(_t(x), n), ji.nearest_interpolate(jnp.asarray(x), n))
                 for n in (7, 29, 52, 111)]
    else:
        # windows of the global x4 and x160/147 interpolations of x[:, :n]
        pairs = []
        for off, n, start, length, num, den in ((0, 37, 0, 40, 1024, 256),
                                                (5, 30, 21, 60, 1024, 256),
                                                (9, 37, 40, 50, 24000, 22050),
                                                (20, 33, 100, 44, 24000, 22050)):
            win = x[:, off:off + 16]
            pairs.append((pi.windowed_linear_gather(_t(win), off, n, start, length, num, den),
                          ji.windowed_linear_gather(jnp.asarray(win), off, n, start, length,
                                                    num, den)))
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_windowed_gather_index_math_is_int64():
    """Sample offsets of a long stream overflow int32 in (2j + 1) * 22050;
    the port's window indices stay exact (a wrong index would be off by a
    whole frame; the f32 weights round at 1e-7 of a frame)."""
    from tortoise_tpu_torch.ops.interpolate import windowed_linear_gather

    n, start = 100000, 100000                     # (2 * 100000 + 1) * 22050 > 2^31
    x = torch.arange(n, dtype=torch.float64)[None, :, None]
    got = windowed_linear_gather(x[:, 91800:91900], 91800, n, start, 4, 24000, 22050)[0, :, 0]
    src = ((2 * np.arange(start, start + 4) + 1) * 22050 - 24000) / 48000
    np.testing.assert_allclose(got.numpy(), src, rtol=0, atol=1e-4)


# --- HiFi-GAN -------------------------------------------------------------------

SMALL_HIFI = dict(in_channels=32, upsample_initial_channel=64, cond_channels=32)


@pytest.fixture(scope="module")
def hifi_pair():
    jm = JaxHifi(JaxHifiConfig(**SMALL_HIFI))
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32)), jnp.zeros((1, 32)))["params"])
    port = HifiganGenerator(HifiganConfig(**SMALL_HIFI))
    port.load_state_dict(from_jax(port, params))
    return jm, params, port.eval()


@pytest.mark.parametrize("method", ["forward", "forward_masked", "inference", "inference_window"])
def test_hifigan_matches_jax(hifi_pair, method):
    """HiFi-GAN at a small config of the shipping topology, float32: every
    entry point within 1e-4 of the JAX module (the transposed convs' kernels
    un-flipped by from_jax)."""
    jm, params, port = hifi_pair
    v = {"params": params}
    rng = np.random.default_rng(2)
    g = rng.standard_normal((2, 32)).astype(np.float32)
    if method.startswith("forward"):
        x = rng.standard_normal((2, 20, 32)).astype(np.float32)
        valid = 13 if method == "forward_masked" else None
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(g), valid)
        got = port(_t(x), _t(g), valid_frames=valid)
    elif method == "inference":
        x = rng.standard_normal((2, 9, 32)).astype(np.float32)
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(g), method=JaxHifi.inference)
        got = port.inference(_t(x), _t(g))
    else:
        x = rng.standard_normal((2, 24, 32)).astype(np.float32)
        args = (20, 70, 31, 40, 25)                # lat_offset, n_valid, u_start, u_len, valid_u
        want = jm.apply(v, jnp.asarray(x), jnp.asarray(g), *args[:3], args[3], args[4],
                        method=JaxHifi.inference_window)
        got = port.inference_window(_t(x), _t(g), *args)
    with torch.no_grad():
        got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_inference_window_slices_equal_full_decode(hifi_pair):
    """A window decode equals the same u-frame slice of the full decode away
    from the halo (start, interior and end windows), float32 1e-5."""
    from tortoise_tpu_torch.api_fast import _HALO_U, _U_LEN, _W_LAT, _u_frames

    _, _, port = hifi_pair
    rng = np.random.default_rng(9)
    n = 90
    lat = _t(rng.standard_normal((1, n, 32)))
    cond = _t(rng.standard_normal((1, 32)))
    u_total = _u_frames(n)
    with torch.no_grad():
        full = port.inference(lat, cond)[0, :, 0]
        for u_start in (0, 37, u_total - _U_LEN):
            lat_hi = min(n, (u_start + _U_LEN) * 147 // 640 + 3)
            lat_off = max(0, lat_hi - _W_LAT)
            win = torch.nn.functional.pad(lat[:, lat_off:lat_off + _W_LAT],
                                          (0, 0, 0, max(0, _W_LAT - (n - lat_off))))
            valid_u = min(_U_LEN, max(0, u_total - u_start))
            wav = port.inference_window(win, cond, lat_off, n, u_start, _U_LEN, valid_u)[0, :, 0]
            lo = 0 if u_start == 0 else _HALO_U
            hi = valid_u if u_start + _U_LEN >= u_total else valid_u - _HALO_U
            np.testing.assert_allclose(wav[lo * 256:hi * 256].numpy(),
                                       full[(u_start + lo) * 256:(u_start + hi) * 256].numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"u_start={u_start}")


# --- the random-latent generator ------------------------------------------------

def test_random_latent_converter_matches_jax():
    """Same noise in, same latent out (float32, 1e-4); the port draws its
    noise from a torch.Generator."""
    from tortoise_tpu.models.random_latent import RandomLatentConverter as J
    from tortoise_tpu_torch.models.random_latent import (RandomLatentConverter,
                                                         sample_random_latent)

    jm = J(64)
    params = _np(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64)))["params"])
    port = RandomLatentConverter(64)
    port.load_state_dict(from_jax(port, params))
    noise = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32)
    with torch.no_grad():
        got = port(_t(noise)).numpy()
        draw = lambda: sample_random_latent(port, torch.Generator().manual_seed(7))
        a, b = draw(), draw()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(noise)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert a.shape == (1, 64) and torch.equal(a, b)


# --- streaming decode -------------------------------------------------------------

def test_greedy_stream_speech_equals_sample_speech():
    """Greedy, f32: the port's stream_speech yields sample_speech's tokens
    and latents (1e-5) in cumulative segments, and the JAX stream's tokens."""
    from tortoise_tpu.models.ar_sampler import SamplerSettings as JaxSettings
    from tortoise_tpu.models.ar_sampler import stream_speech as jax_stream
    from tortoise_tpu.models.autoregressive import UnifiedVoice as JaxVoice
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu_torch.models.ar_sampler import (SamplerSettings, sample_speech,
                                                      stream_speech)
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice

    kw = dict(layers=2, model_dim=128, heads=4, max_text_tokens=30, max_mel_tokens=64)
    jm = JaxVoice(JaxConfig(**kw))
    params = init_unified_voice(jm, jax.random.PRNGKey(0))
    port = UnifiedVoice(UnifiedVoiceConfig(**kw))
    port.load_state_dict(from_jax(port, params["params"]))
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((1, 128)).astype(np.float32)
    text = np.pad(rng.integers(3, 250, (1, 9)), ((0, 0), (0, 1)))
    settings = SamplerSettings(max_generate=32, do_sample=False)
    with torch.no_grad():
        codes, lats = sample_speech(port, _t(cond), _t(text, torch.long),
                                    torch.Generator().manual_seed(5), 1, settings,
                                    cache_dtype=torch.float32)
        yields = list(stream_speech(port, _t(cond), _t(text, torch.long),
                                    torch.Generator().manual_seed(5), settings, seg_len=7,
                                    cache_dtype=torch.float32))
    s_codes, s_lats = yields[-1]
    assert [y[0].shape[1] for y in yields] == [8, 15, 22, 29, 32][:len(yields)]
    n = s_codes.shape[1]
    np.testing.assert_array_equal(s_codes[0].numpy(), codes[0, :n].numpy())
    np.testing.assert_allclose(s_lats[0].numpy(), lats[0, :n].numpy(), rtol=1e-5, atol=1e-5)
    for j_codes, _ in jax_stream(jm, params, jnp.asarray(cond), jnp.asarray(text),
                                 jax.random.PRNGKey(5),
                                 settings=JaxSettings(max_generate=32, do_sample=False),
                                 seg_len=7, cache_dtype=jnp.float32):
        pass
    np.testing.assert_array_equal(s_codes.numpy(), np.asarray(j_codes))


# --- TextToSpeechFast end to end --------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """A JAX and a port TextToSpeechFast (float32) holding the same AR and
    HiFi-GAN weights, the stop token's logit pushed down in both."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtts = jfast.TextToSpeechFast(dtype=jnp.float32, ar_config=JaxConfig(**AR),
                                      latent_bucket=16)
        ptts = pfast.TextToSpeechFast(device="cpu", dtype=torch.float32,
                                      ar_config=UnifiedVoiceConfig(**AR))
    # the jitted stages hold these dicts: edit them in place
    head = jtts.ar_vars["params"]["mel_head"]
    head["bias"] = jnp.asarray(head["bias"]).at[STOP].set(-1e4)
    ptts.autoregressive.load_state_dict(from_jax(ptts.autoregressive,
                                                 _np(jtts.ar_vars["params"])))
    ptts.hifi_decoder.load_state_dict(from_jax(ptts.hifi_decoder, _np(jtts.hifi_vars["params"])))
    cond = np.random.default_rng(1).standard_normal((1, 128)).astype(np.float32)
    return jtts, ptts, cond


def test_finish_from_injected_codes_matches_jax(pair):
    """tts's finish: teacher-forced latents of codes with a planted stop
    token, trimmed after it and decoded at _expected_samples(n); against the
    JAX package's fused finish (bucketed decode, equal to the exact one to
    2e-4 by its own test)."""
    jtts, ptts, cond = pair
    _, text, _ = ptts._prepare(TEXT, None, cond, 0)
    codes = np.random.default_rng(2).integers(0, 8192, (1, 24))
    codes[0, 9:] = STOP
    wav, n, out = jtts._finish_wav(jnp.asarray(cond), jnp.asarray(text.numpy()),
                                   jnp.asarray(codes))
    want = np.asarray(wav)[:, :int(out), 0][:, None, :]
    with torch.no_grad():
        got = ptts._finish_wav(_t(cond), text, _t(codes, torch.long))
    assert int(n) == 10 == len(ptts.last_codes) and got.shape == want.shape
    assert int(out) == pfast._expected_samples(10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("regime", ["fused_head", "staged", "stop_at_first_token"])
def test_tts_stream_chunks_match_jax(pair, regime):
    """tts_stream's chunk lengths equal the JAX package's in both of its
    regimes (the first chunk from one window over the first segment, or
    segments from the start) and when the very first token stops; with
    top_k=1 both emit the same codes, and in the fused-head regime (under
    256 u-frames, where the JAX windows are exact) the same audio to 1e-3."""
    jtts, ptts, cond = pair
    kw = {"fused_head": dict(max_mel_tokens=48, stream_chunk_size=8),
          "staged": dict(max_mel_tokens=80, first_chunk_size=70, stream_chunk_size=70),
          "stop_at_first_token": dict(max_mel_tokens=48, stream_chunk_size=8)}[regime]
    kw.update(use_deterministic_seed=3, top_k=1, verbose=False, conditioning_latents=cond)
    head = jtts.ar_vars["params"]["mel_head"]
    saved = head["bias"]
    if regime == "stop_at_first_token":
        head["bias"] = saved.at[STOP].set(1e4)
        ptts.autoregressive.mel_head.bias.data[STOP] = 1e4
    try:
        want = [np.asarray(c) for c in jtts.tts_stream(TEXT, **kw)]
        got = [c.numpy() for c in ptts.tts_stream(TEXT, **kw)]
    finally:
        head["bias"] = saved
        ptts.autoregressive.mel_head.bias.data[STOP] = -1e4
    assert [len(c) for c in got] == [len(c) for c in want]
    if regime == "stop_at_first_token":
        assert [len(c) for c in got] == [pfast._expected_samples(1)]
        assert list(ptts.last_codes) == [STOP]
    if regime != "staged":
        np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=1e-3)


def test_stream_chunks_are_slices_of_the_full_decode(pair):
    """Past 256 u-frames too (where the JAX package's windows end at the
    chunk's end): the concatenated chunks equal one full decode of the
    stream's latents (float32, 1e-5)."""
    from tortoise_tpu_torch.models import ar_sampler

    _, ptts, cond = pair
    chunks = list(ptts.tts_stream(TEXT, conditioning_latents=cond, use_deterministic_seed=4,
                                  max_mel_tokens=78, first_chunk_size=16,
                                  stream_chunk_size=20))
    with torch.no_grad():
        _, text, c = ptts._prepare(TEXT, None, cond, 4)
        for codes, latents in ar_sampler.stream_speech(
                ptts.autoregressive, c, text, torch.Generator().manual_seed(4),
                ptts._settings(78, False, True), seg_len=20, first_seg_len=16):
            pass
        full = ptts._decode(latents, ptts._trim_codes(codes[0].numpy()), c)[0, 0]
    stream = torch.cat(chunks)
    assert len(chunks) > 3 and stream.shape == full.shape and pfast._u_frames(78) > 256
    np.testing.assert_allclose(stream.numpy(), full.numpy(), rtol=0, atol=1e-5)
    assert np.array_equal(ptts.last_codes, codes[0].numpy())


@pytest.mark.parametrize("entry", ["tts", "tts_with_preset", "tts_batch"])
def test_tts_entry_points_match_jax(pair, entry):
    """With top_k=1 the codes are the JAX package's, so the wavs match it:
    teacher-forced latents and exact-length decodes against the bucketed
    ones (2e-4)."""
    jtts, ptts, cond = pair
    kw = dict(use_deterministic_seed=5, top_k=1, max_mel_tokens=32, verbose=False)
    if entry == "tts_batch":
        texts = ["One short one.", "A second, somewhat longer sentence.", "Third."]
        want = jtts.tts_batch(texts, conditioning_latents=np.repeat(cond, 3, 0), text_bucket=16,
                              **kw)
        got = ptts.tts_batch(texts, conditioning_latents=cond, text_bucket=16, **kw)
    else:
        call = lambda t: (t.tts(TEXT, conditioning_latents=cond, **kw) if entry == "tts" else
                          t.tts_with_preset(TEXT, preset="ultra_fast",
                                            conditioning_latents=cond, **kw))
        want, got = [call(jtts)], [call(ptts)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert tuple(g.shape) == w.shape and g.shape[2] == pfast._expected_samples(32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-4)


def test_expected_samples_and_handle_chunks_match_jax():
    for n in (1, 7, 40, 147, 500):
        assert pfast._expected_samples(n) == jfast._expected_samples(n)
        assert pfast._u_frames(n) == jfast._u_frames(n)
    rng = np.random.default_rng(0)
    state_p = state_j = (None, None)
    for size in (4096, 8192, 600):
        wav = rng.standard_normal(size).astype(np.float32)
        cp, *state_p = pfast.handle_chunks(wav, *state_p, 1024)
        cj, *state_j = jfast.handle_chunks(wav, *state_j, 1024)
        np.testing.assert_array_equal(cp, cj)


def test_fast_api_options(pair):
    """CUDA without a GPU raises; the CPU takes K2 only when asked; an int8
    instance's K2 stack is int8 (int8 and int8_decode); the random voice is
    seeded; a per-call gpt_fused_step=True on an instance without a K2
    stack decodes as the default does (JAX semantics)."""
    _, ptts, cond = pair
    cfg = UnifiedVoiceConfig(**AR)
    orig = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pfast.TextToSpeechFast(device="cuda", ar_config=cfg)
    finally:
        torch.cuda.is_available = orig
    assert ptts.gpt_fused_step is False and ptts._ar_stacked is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for gw in ("int8", "int8_decode"):
            q = pfast.TextToSpeechFast(device="cpu", ar_config=cfg, gpt_weights=gw,
                                       gpt_fused_step=True)
            assert q._ar_stacked["wqkv"].dtype == torch.int8 and "sqkv" in q._ar_stacked
            assert q.autoregressive.config.quant_weights == (gw == "int8")
    a, b = (ptts.get_random_conditioning_latents(9) for _ in range(2))
    assert a.shape == (1, 128) and torch.equal(a, b)
    kw = dict(conditioning_latents=cond, use_deterministic_seed=3, max_mel_tokens=16,
              verbose=False)
    assert torch.equal(ptts.tts(TEXT, gpt_fused_step=True, **kw), ptts.tts(TEXT, **kw))


# --- the program's spans ------------------------------------------------------------

STEP_SPANS = ("tts.ar.prefill", "tts.ar.step", "tts.ar.finish_check", "tts.diffusion.step")


@pytest.fixture(scope="module")
def quality_tts():
    """A tiny port TextToSpeech (float32, random weights) for the quality
    pipeline's spans."""
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.models.clvp import CLVPConfig
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TextToSpeech(
            device="cpu", autoregressive_batch_size=2, half=False, kv_cache_dtype="f32",
            enable_redaction=False, ar_config=UnifiedVoiceConfig(**AR),
            diffusion_config=DiffusionTtsConfig(model_channels=128, num_layers=2,
                                                in_latent_channels=128, num_heads=4),
            clvp_config=CLVPConfig(dim_text=128, dim_speech=128, dim_latent=128,
                                   text_enc_depth=2, text_heads=4, speech_enc_depth=2,
                                   speech_heads=4))


def _counted(monkeypatch, owner, name):
    calls = []
    original = getattr(owner, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("entry", ["tts_with_preset", "tts", "tts_batch", "tts_stream"])
def test_span_tree_of_each_entry_point(pair, quality_tts, entry, monkeypatch):
    """Under the profiler each entry point is one request whose spans are
    request -> stages -> steps, one ``tts.ar.step`` a decode step taken,
    one ``tts.diffusion.step`` a diffusion iteration and one ``tts.hifigan``
    a HiFi-GAN decode or stream chunk; its wavs are bitwise those of the
    same call with no profiler."""
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.models import ar_sampler
    from tortoise_tpu_torch.utils import profiling

    _, ptts, cond = pair
    kw = dict(use_deterministic_seed=6, max_mel_tokens=16, verbose=False)
    iterations = 0
    if entry == "tts_with_preset":
        iterations = 4
        rng = np.random.default_rng(2)
        latents = (rng.standard_normal((1, 128)), rng.standard_normal((1, 256)))
        call = lambda: [quality_tts.tts_with_preset(
            TEXT, preset="ultra_fast", conditioning_latents=latents,
            num_autoregressive_samples=2, diffusion_iterations=iterations, **kw)]
    elif entry == "tts":
        call = lambda: [ptts.tts(TEXT, conditioning_latents=cond, **kw)]
    elif entry == "tts_batch":
        call = lambda: ptts.tts_batch(["One short one.", "Two."], conditioning_latents=cond,
                                      text_bucket=16, **kw)
    else:
        call = lambda: list(ptts.tts_stream(TEXT, conditioning_latents=cond, first_chunk_size=6,
                                            stream_chunk_size=8, **kw))
    off = call()
    steps = _counted(monkeypatch, ar_sampler, "_step")
    decodes = _counted(monkeypatch, ptts, "_decode")
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.spans().clear()
        on = call()
    spans = profiling.spans()
    assert len(on) == len(off) and all(
        a.numpy().tobytes() == b.numpy().tobytes() for a, b in zip(on, off))

    requests = [s for s in spans if s.name == "tts.request"]
    assert len(requests) == 1 and requests[0].parent is None
    for s in spans:
        assert s.request == requests[0].request and s.end_ns is not None
        if s.name in STEP_SPANS:
            assert s.parent.name not in STEP_SPANS and s.parent.parent is requests[0], s.name
        elif s is not requests[0]:
            assert s.parent is requests[0], s.name
    count = lambda name: sum(s.name == name for s in spans)
    assert count("tts.ar.step") == len(steps) > 0
    assert {s.attrs["rows"] for s in spans if s.name == "tts.ar.step"} == \
        {len(on) if entry == "tts_batch" else 2 if entry == "tts_with_preset" else 1}
    assert count("tts.diffusion.step") == iterations
    hifigan = len(on) if entry == "tts_stream" else len(decodes)
    assert count("tts.hifigan") == hifigan == (0 if entry == "tts_with_preset" else hifigan)
    stages = {s.name for s in spans if s.parent is requests[0]}
    assert stages >= ({"tts.conditioning", "tts.autoregressive", "tts.clvp_rerank",
                       "tts.latent_reextraction", "tts.diffusion", "tts.vocoder"}
                      if entry == "tts_with_preset" else
                      {"tts.prepare", "tts.autoregressive", "tts.hifigan"})
