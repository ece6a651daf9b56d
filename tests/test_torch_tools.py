"""The port's tools (tortoise_tpu_torch/tools) against the JAX tools (tools/,
loaded by file path: it is no package): K5-K8's plain versions against the
Pallas kernels in interpret mode, the per-head and merged decode attention
forms and the three LVC forms against the JAX ones, each tool's flags
against its JAX tool's, and each tool's main() on the CPU at a tiny size
(check_fused_exactness at agreement 1.0). Same numpy inputs on both
sides."""
import importlib
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tortoise_tpu_torch.tools import bench_attn_body, bench_decode_attn_merged, probe_ops
from tortoise_tpu_torch.tools.decode_attn_kv128 import (decode_attention_kv128,
                                                        decode_attention_kv128_plain)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
TOOLS = ["probe_ops", "decode_attn_kv128", "bench_attn_body", "profile_ar_step",
         "bench_decode_attn_merged", "bench_lvc", "bench_fused_decode_step",
         "check_fused_exactness", "bench_fused_ab", "measure_first_audio",
         "profile_diffusion_step"]
# the tools that time the card and print "not measured" on the CPU
TIMING_TOOLS = set(TOOLS) - {"check_fused_exactness", "bench_fused_ab", "measure_first_audio"}


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(rng, *shape):
    """Seeded normal values, rounded to bf16, as float32 numpy."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16), np.float32)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a, np.float32)).to(dtype)


# --- K5 ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_valid", [0, 1, 40, 64])
@pytest.mark.parametrize("bh", [16, 24])
def test_kv128_plain_matches_pallas_interpret(bh, n_valid):
    """K5's CPU dispatch against the Pallas kernel, which runs in interpret
    mode on the CPU by itself: n_valid=0 is a uniform softmax over all rows."""
    jtool = _jax_tool("pallas_decode_attn")
    rng = np.random.default_rng(bh + n_valid)
    kv, q = _bf16(rng, bh, 64, 128), _bf16(rng, bh, 64)
    want = np.asarray(jtool.decode_attention_kv128(jnp.asarray(kv, jnp.bfloat16),
                                                   jnp.asarray(q, jnp.bfloat16), n_valid))
    got = decode_attention_kv128(_t(kv, torch.bfloat16), _t(q, torch.bfloat16), n_valid)
    assert got.dtype == torch.float32 and got.shape == (bh, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if n_valid == 0:   # the mean of the v lanes
        np.testing.assert_allclose(got.numpy(), kv[:, :, 64:].mean(1), rtol=0, atol=1e-5)


# --- K6 ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k6_inputs():
    rng = np.random.default_rng(6)
    return _bf16(rng, 2, 1024), _bf16(rng, 2, 128, 1024), _bf16(rng, 2, 128, 1024)


def _k6_jax(inputs, pos, variant):
    jtool = _jax_tool("bench_attn_body_pallas")
    with pltpu.force_tpu_interpret_mode():
        out = jtool.attn_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in inputs), pos, heads=16,
                                ck=32, variant=variant)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("pos", [0, 37, 127])
@pytest.mark.parametrize("variant", ["a", "b"])
def test_attn_body_plain_matches_pallas_interpret(k6_inputs, variant, pos):
    """K6's plain version (its CPU dispatch) against the Pallas kernel under
    the TPU interpret mode at B=2, T=128, C=1024, H=16, ck=32: every row
    within 1e-2 of its max|JAX| (a bf16 output, one ulp, and f32 sums in
    another order)."""
    want = _k6_jax(k6_inputs, pos, variant)
    got = bench_attn_body.attn_body(*(_t(a, torch.bfloat16) for a in k6_inputs), pos, ck=32,
                                    variant=variant).float().numpy()
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 1e-2


def test_attn_body_variants_round_differently(k6_inputs):
    """Variant b rounds each product k * q to bf16 before the head sum, a
    does not: the outputs differ, in the port as in the JAX kernel, and
    each port variant equals its own JAX variant bit for bit on more
    outputs than it equals the other one."""
    args = [_t(a, torch.bfloat16) for a in k6_inputs]
    port = {v: bench_attn_body.attn_body_plain(*args, 127, ck=32, variant=v).float().numpy()
            for v in "ab"}
    jax_out = {v: _k6_jax(k6_inputs, 127, v) for v in "ab"}
    assert not np.array_equal(port["a"], port["b"])
    assert not np.array_equal(jax_out["a"], jax_out["b"])
    same = lambda p, j: (port[p] == jax_out[j]).mean()
    assert same("a", "a") > same("a", "b") and same("b", "b") > same("b", "a")


def test_attn_body_refuses_a_chunk_that_does_not_divide_t():
    q = torch.zeros((1, 1024), dtype=torch.bfloat16)
    k = torch.zeros((1, 100, 1024), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must divide"):
        bench_attn_body.attn_body(q, k, k, 10, ck=64)


def test_attn_body_refuses_int8():
    """The JAX tool parses --dtype int8 and builds bf16 k/v all the same;
    the port raises rather than time bf16 under that name."""
    with pytest.raises(NotImplementedError, match="int8"):
        bench_attn_body.main(["--device", "cpu", "--dtype", "int8"])


# --- K7 ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_probes():
    """probe_mosaic_ops.main() under the TPU interpret mode, each probe's
    pallas_call wrapped to keep its inputs and output, in probe order."""
    jtool = _jax_tool("probe_mosaic_ops")
    calls = []
    orig = pl.pallas_call

    def keeping(kernel, **kwargs):
        call = orig(kernel, **kwargs)

        def run(*args):
            out = call(*args)
            calls.append(([np.asarray(a) for a in args], np.asarray(out)))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool.pl, "pallas_call", keeping)
        with pltpu.force_tpu_interpret_mode():
            jtool.main()
    return calls


@pytest.mark.parametrize("i", range(1, 8))
def test_probe_plain_matches_pallas_interpret(jax_probes, i):
    """Each of K7's seven probes on the JAX tool's own inputs (arange / 100,
    the same as the port's): bit for bit; the contraction (probe 6) within
    1e-6 of max|JAX|."""
    assert len(jax_probes) == 7
    args, want = jax_probes[i - 1]
    ours = probe_ops.probe_inputs(i, "cpu")
    assert all(np.array_equal(a, o.numpy()) for a, o in zip(args, ours))
    got = probe_ops.probe(i, *ours).numpy()
    assert got.shape == want.shape == probe_ops.PROBES[i - 1][2]
    if i == 6:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        assert np.array_equal(got, want)


# --- K8 ---------------------------------------------------------------------------

def _o1(k_ref, q_ref, o_ref):
    o_ref[...] = jax.lax.dot_general(k_ref[...], q_ref[...], (((2,), (1,)), ((0,), (0,))),
                                     preferred_element_type=jnp.float32)


def _o2(q_ref, k_ref, o_ref):
    o_ref[...] = jax.lax.dot_general(q_ref[...], k_ref[...], (((2,), (2,)), ((0,), (0,))),
                                     preferred_element_type=jnp.float32)


def _pe(p_ref, m_ref, o_ref):
    b, ck, h = p_ref.shape
    o_ref[...] = jax.lax.dot_general(p_ref[...].reshape(b * ck, h), m_ref[...],
                                     (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.float32).reshape(o_ref.shape)


def _pv(p_ref, v_ref, o_ref):
    o_ref[...] = jax.lax.dot_general(p_ref[...], v_ref[...], (((2,), (1,)), ((0,), (0,))),
                                     preferred_element_type=jnp.float32)


# the bodies of tools/probe_mosaic_ops.py:119-150, restated: there they are
# closures inside timed_probes
K8_BODIES = {"logits o1 (B,ck,C)x(B,C,H)": _o1, "logits o2 (B,H,C)x(B,ck,C)": _o2,
             "p_exp collapse (B*ck,H)x(H,C)": _pe, "pv batched (B,H,ck)x(B,ck,C)": _pv}


@pytest.mark.parametrize("name", list(K8_BODIES))
def test_contraction_plain_matches_pallas_interpret(name):
    """K8's four orientations at B=4, ck=32, C=256, H=4 on seeded random
    bf16 operands: the plain version against the restated Pallas body in
    interpret mode, within 1e-5 of max|JAX|."""
    g = torch.Generator().manual_seed(8)
    operands, a, b, shape = probe_ops.orientation_operands(g, "cpu", b=4, ck=32, c=256,
                                                           h=4)[name]
    want = np.asarray(pl.pallas_call(K8_BODIES[name],
                                     out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                                     interpret=True)(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in operands)))
    got = probe_ops.contraction(a, b).reshape(shape).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# --- the per-head and merged decode attention forms ---------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("form", ["merged", "per_head"])
def test_decode_attention_forms_match_jax(form, cache, chunk):
    """merged_chunked (the merged (L, B, T, C) cache, (L, B, T, H) int8
    scales) and chunked_decode_attention_layered (the per-head cache,
    (L, B, H, T, 1) scales) against the JAX functions at L=2, B=2, T=64,
    C=256, H=4: several chunks with a ragged last one (chunk 16) and one
    whole-cache chunk (64); f32 math in both, 1e-5."""
    from tortoise_tpu.ops.attention import chunked_decode_attention_layered as jax_layered
    from tortoise_tpu_torch.ops.attention import chunked_decode_attention_layered

    L, B, T, H, DH, layer, idx = 2, 2, 64, 4, 64, 1, 37
    C = H * DH
    rng = np.random.default_rng(chunk)
    ck, cv = (_t(_bf16(rng, L, B, T, C), torch.bfloat16) for _ in range(2))
    q = _t(_bf16(rng, B, C))
    ks = vs = None
    if form == "per_head":
        ck, cv = (x.reshape(L, B, T, H, DH).permute(0, 1, 3, 2, 4).contiguous() for x in (ck, cv))
        if cache == "int8":
            (ck, ks), (cv, vs) = (bench_decode_attn_merged.quant_per_head(x) for x in (ck, cv))
        got = chunked_decode_attention_layered(q.reshape(B, H, 1, DH), ck, cv, layer, idx,
                                               chunk=chunk, k_scale=ks, v_scale=vs).reshape(B, C)
        jfn = lambda *a, k_scale, v_scale: jax_layered(a[0].reshape(B, H, 1, DH), *a[1:], layer,
                                                       idx, chunk=chunk, k_scale=k_scale,
                                                       v_scale=v_scale).reshape(B, C)
    else:
        if cache == "int8":
            (ck, ks), (cv, vs) = (bench_decode_attn_merged.quant_merged(x, H) for x in (ck, cv))
        got = bench_decode_attn_merged.merged_chunked(q, ck, cv, layer, idx, heads=H, chunk=chunk,
                                                      k_scale=ks, v_scale=vs)
        jtool = _jax_tool("bench_decode_attn_merged")
        jfn = lambda *a, k_scale, v_scale: jtool.merged_chunked(
            *a, layer, idx, heads=H, chunk=chunk, k_scale=k_scale, v_scale=v_scale)
    j = lambda x: None if x is None else jnp.asarray(x.float().numpy(),
                                                     jnp.int8 if x.dtype == torch.int8
                                                     else jnp.bfloat16 if x.dtype == torch.bfloat16
                                                     else jnp.float32)
    want = jfn(j(q), j(ck), j(cv), k_scale=j(ks), v_scale=j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-5, atol=1e-5)


# --- each tool's main() -----------------------------------------------------------

TINY_ARGS = {
    "probe_ops": [],
    "decode_attn_kv128": ["--batch", "2", "--tmax", "64", "--layers", "2", "--steps", "2"],
    "bench_attn_body": ["--batch", "2", "--t", "128", "--fill", "37", "--ck", "32"],
    "profile_ar_step": ["--batch", "2", "--tokens", "2"],
    "bench_decode_attn_merged": ["--batch", "2", "--tmax", "64", "--layers", "3", "--steps",
                                 "2", "--nvalid", "40"],
    "bench_lvc": ["--frames", "20", "--steps", "1"],
    "bench_fused_decode_step": ["--batch", "2", "--t", "64", "--fill", "20", "--steps", "3",
                                "--cache", "bf16"],
    "check_fused_exactness": ["--tiny", "--steps", "10"],
    "bench_fused_ab": ["--runs", "1", "--quality-runs", "1", "--tokens", "6", "--batch", "2"],
    "measure_first_audio": ["--runs", "1", "--first", "4", "--chunk", "8"],
    "profile_diffusion_step": ["--tout", "48", "--steps", "2"],
}
# tiny configs for the tools that build full-width models
TINY_AR = dict(layers=2, model_dim=128, heads=4, max_text_tokens=160, max_mel_tokens=24)


def _tiny_unified_voice(monkeypatch):
    """profile_ar_step at a 2-layer, 128-wide UnifiedVoice."""
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
    from tortoise_tpu_torch.tools import profile_ar_step

    tiny = UnifiedVoiceConfig(layers=2, model_dim=128, heads=2, max_text_tokens=60,
                              max_mel_tokens=80)
    monkeypatch.setattr(profile_ar_step, "UnifiedVoiceConfig", lambda: tiny)


def _tiny(name, monkeypatch):
    """Shrink what tool ``name`` builds at full width to a tiny config."""
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig

    if name == "profile_ar_step":
        _tiny_unified_voice(monkeypatch)
    elif name == "bench_fused_decode_step":
        from tortoise_tpu_torch.models.gpt2 import GPT2Config
        from tortoise_tpu_torch.tools import bench_fused_decode_step as tool

        monkeypatch.setattr(tool, "GPT2Config", lambda **kw: GPT2Config(
            n_layer=2, n_embd=256, n_head=4, **kw))
    elif name == "profile_diffusion_step":
        from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig
        from tortoise_tpu_torch.tools import profile_diffusion_step as tool

        monkeypatch.setattr(tool, "DiffusionTtsConfig", lambda: DiffusionTtsConfig(
            model_channels=64, num_layers=2, in_latent_channels=64, num_heads=1))
    elif name in ("bench_fused_ab", "measure_first_audio"):
        from tortoise_tpu_torch.api_fast import TextToSpeechFast

        tool = importlib.import_module(f"tortoise_tpu_torch.tools.{name}")
        monkeypatch.setattr(tool, "TextToSpeechFast", lambda **kw: TextToSpeechFast(
            ar_config=UnifiedVoiceConfig(**TINY_AR), **kw))
        if name == "bench_fused_ab":
            monkeypatch.setattr(tool, "TextToSpeech", _tiny_quality)


def _tiny_quality(**kwargs):
    """The quality TextToSpeech at the tiny configs of the GPU tests (its
    AR text table widened for the tool's sentence); any preset's request is
    2 candidates and 2 diffusion steps."""
    import dataclasses

    from test_torch_kernels_gpu import TINY
    from tortoise_tpu_torch.api import TextToSpeech

    tiny = dict(TINY, ar_config=dataclasses.replace(TINY["ar_config"], max_text_tokens=160))
    tts = TextToSpeech(enable_redaction=False, autoregressive_batch_size=2, **kwargs, **tiny)
    quick = tts.tts_with_preset
    tts.tts_with_preset = lambda text, **kw: quick(
        text, **{**kw, "num_autoregressive_samples": 2, "diffusion_iterations": 2})
    return tts


@pytest.mark.parametrize("name", TOOLS)
def test_tool_main_on_the_cpu(name, monkeypatch, capsys):
    """--device cpu at a tiny size (profile_ar_step with a 2-layer, 128-wide
    UnifiedVoice): the result dict, every device time "not measured"."""
    tool = importlib.import_module(f"tortoise_tpu_torch.tools.{name}")
    _tiny(name, monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = tool.main(["--device", "cpu", *TINY_ARGS[name]])
    assert res["device"] == "cpu"
    out = capsys.readouterr().out
    assert ("not measured" in out) == (name in TIMING_TOOLS)
    if name == "probe_ops":
        assert res["ok"] and out.count("OK ") == 7 and len(res["orientations"]) == 4
    elif name == "decode_attn_kv128":
        assert res["call"]["rel_err"] <= 1e-5 and res["kernel_steps"]["device_ms"] is None
    elif name == "bench_attn_body":
        assert set(res["variants"]) == {"a", "b"}
    elif name == "profile_ar_step":
        assert set(res["sections"]) == {"a", "b", "b2", "c", "d"}
        assert set(res["sections"]["d"]["pos=512"]) == {"chunk256", "chunk512", "chunk1024",
                                                        "k1", "full"}
        assert all(r["host_ms"] > 0 and r["device_ms"] is None
                   for r in res["sections"]["d"]["pos=1000"].values())
    elif name == "bench_decode_attn_merged":
        assert set(res["variants"]) == {"chunked-bf16", "chunked-int8", "merged-bf16",
                                        "merged-int8", "k1-merged"}
    elif name == "bench_lvc":
        assert set(res["hops"]) == {8, 64, 256}
        assert all(r["rel_err"] <= 1e-5 and r["ms"] is None
                   for h in res["hops"].values() for r in h["forms"].values())
    elif name == "bench_fused_decode_step":
        # K2's plain version against the layer stack, one bf16 step of 2
        # layers: one-ulp flips of their roundings (K2's bound at full
        # width, chip_smoke's K2_REL_BOUND)
        assert len(res["rel_err_by_step"]) == 3 and res["rel_err_by_step"][0] <= 0.05
        assert all(r["host_ms"] > 0 and r["event_ms"] is None and r["device_ms"] is None
                   for r in res["paths"].values())
    elif name == "check_fused_exactness":
        assert res["ok"] and set(res["rows"]) == {"bf16_cache", "int8_cache"}
        assert all(r["decisive_agreement"] == 1.0 and r["decisive_steps"] > 0
                   for r in res["rows"].values())
    elif name == "bench_fused_ab":
        assert set(res) == {"device", "ar_tokens", "fast_b1", "fast_b1_int8w", "fast_batch2",
                            "quality_standard", "quality_standard_int8kv"}
        rows = [r for k, v in res.items() if isinstance(v, dict) for r in v.values()]
        assert len(rows) == 10 and all(r["finite"] and r["p50_s"] > 0 for r in rows)
    elif name == "measure_first_audio":
        assert res["finite"] and 0 < res["first_audio_s_min"] <= res["first_audio_s_median"]
        assert 0 < res["first_chunk_audio_s"] <= res["stream_audio_s"]
    else:
        assert set(res["rows"]) == {f"{f} B={b} T=48" for f in ("k3", "dense") for b in (1, 2)}
        assert all(r["host_ms"] > 0 and r["busy_ms"] is None for r in res["rows"].values())


def test_profile_ar_step_profiles_after_every_timing(monkeypatch, capsys):
    """A torch.profiler session slows every launch after it in the process,
    so profile_ar_step takes every host and event time first and the busy
    passes of [a], [b], [b2] (two caches) and [c] last, each on the state
    its section was timed on. The profiled pass (skipped on the CPU) is
    stood in for by a recorder that runs the section's steps."""
    from tortoise_tpu_torch.tools import profile_ar_step
    from tortoise_tpu_torch.utils import measure

    _tiny_unified_voice(monkeypatch)
    calls = []
    time_steps = measure.time_steps

    def timing(run, steps, dev):
        calls.append("time")
        return time_steps(run, steps, dev)

    def profiled(run, steps, dev):
        calls.append("busy")
        run(steps)
        return {"busy_ms": 1.0, "ms_by_family": {}}

    monkeypatch.setattr(measure, "time_steps", timing)
    monkeypatch.setattr(profile_ar_step, "_busy", profiled)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = profile_ar_step.main(["--device", "cpu", *TINY_ARGS["profile_ar_step"]])
    n_time = 5 + 3 * 5   # [a], [b], [b2] x 2, [c]; [d] at 3 positions x 5 forms
    assert calls == ["time"] * n_time + ["busy"] * 5
    sec = res["sections"]
    assert all(r["busy_ms"] == 1.0 for r in (sec["a"], sec["b"], sec["c"], *sec["b2"].values()))


@pytest.mark.parametrize("name", TOOLS)
def test_tool_main_without_cuda_raises(name, monkeypatch):
    """The tools measure the card: asked for cuda (the default) where torch
    sees none, they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = importlib.import_module(f"tortoise_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


# --- the measurement tools of tools/ that time whole paths ---------------------------

# flags of a port tool that differ from its JAX tool's, each for a reason
# its docstring gives: every tool adds --device; profile_diffusion_step
# takes several lengths and batches in one process, so that its profiler
# passes come after all of its timings (B=1 and 2 by default: the quality
# path's two batches)
FLAG_CHANGES = {"profile_diffusion_step": {"tout", "batch"}}


@pytest.mark.parametrize("name", ["bench_lvc", "bench_fused_decode_step",
                                  "check_fused_exactness", "bench_fused_ab",
                                  "measure_first_audio", "profile_diffusion_step",
                                  "convert_checkpoints"])
def test_tool_keeps_the_jax_tools_flags(name, monkeypatch):
    """Every option of the JAX tool, with its option strings, default,
    choices, type and action, and no other but --device."""
    from test_torch_apps import _options

    jtool = _jax_tool(name)

    class Parsed(Exception):
        pass

    captured = {}

    def capture(self, *args, **kwargs):
        captured["parser"] = self
        raise Parsed

    with monkeypatch.context() as m:
        m.setattr(__import__("argparse").ArgumentParser, "parse_args", capture)
        with pytest.raises(Parsed):
            jtool.main()
    want = _options(captured["parser"])
    got = _options(importlib.import_module(f"tortoise_tpu_torch.tools.{name}").build_parser())
    if name != "convert_checkpoints":
        assert got.pop("device")["default"] == "cuda"
    assert set(got) == set(want)
    for dest in set(want) - FLAG_CHANGES.get(name, set()):
        assert got[dest] == want[dest], dest
    for dest in FLAG_CHANGES.get(name, set()):
        assert got[dest]["option_strings"] == want[dest]["option_strings"]
        assert want[dest]["default"] in got[dest]["default"]


@pytest.mark.parametrize("hop", [8, 64, 256])
def test_lvc_forms_match_jax(hop):
    """bench_lvc's three forms (K4 by its plain version on the CPU) on the
    kernel predictor's frames-innermost layout against the JAX package's
    location_variable_convolution and the JAX tool's gather form, at F=12,
    Ci=32, Co=64, K=3: 1e-5 of max|JAX| (float32 sums in other orders)."""
    from tortoise_tpu.models.vocoder import location_variable_convolution as jax_lvc
    from tortoise_tpu_torch.models.vocoder import predictor_layout
    from tortoise_tpu_torch.tools import bench_lvc

    f, ci, co, k = 12, 32, 64, 3
    rng = np.random.default_rng(hop)
    x = rng.standard_normal((1, f * hop, ci)).astype(np.float32)
    kern = (rng.standard_normal((1, f, ci, co, k)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((1, f, co)) * 0.1).astype(np.float32)
    want = np.asarray(jax_lvc(jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias), hop))
    jax_gather = np.asarray(_jax_tool("bench_lvc").lvc_gather(
        jnp.asarray(x), jnp.asarray(kern), jnp.asarray(bias), hop))
    # the predictor's layout: the same values, frames innermost
    kp, bp = predictor_layout(_t(kern).reshape(1, f, -1).transpose(1, 2).contiguous()
                              .transpose(1, 2), _t(bias).transpose(1, 2).contiguous()
                              .transpose(1, 2), 1, ci, co, k)
    assert kp[:, 0].stride(1) == 1
    scale = np.abs(want).max()
    for name, form in bench_lvc.FORMS.items():
        got = form(_t(x), kp[:, 0], bp[:, 0], hop).numpy()
        assert np.abs(got - want).max() <= 1e-5 * scale, name
    assert np.abs(bench_lvc.lvc_gather(_t(x), _t(kern), _t(bias), hop).numpy()
                  - jax_gather).max() <= 1e-5 * scale


def test_fused_decode_step_refuses_another_chunk():
    """--ck is the Pallas kernel's TPU tiling: K2 has none, so only the
    JAX tool's default is accepted, never silently ignored."""
    from tortoise_tpu_torch.tools import bench_fused_decode_step

    with pytest.raises(NotImplementedError, match="--ck 64"):
        bench_fused_decode_step.main(["--device", "cpu", "--ck", "64"])


def test_fused_ab_runs_k2_only_when_on(monkeypatch):
    """bench_fused_ab's "on" rows decode with K2 and its "off" rows never
    do: on the CPU K2's plain version stands in for the kernel, counted as
    its launch."""
    from tortoise_tpu_torch.ops import decode_step
    from tortoise_tpu_torch.tools import bench_fused_ab

    plain = decode_step.fused_decode_step_plain

    def counted(*args, **kwargs):
        decode_step.fused_decode_step.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(decode_step, "fused_decode_step_plain", counted)
    _tiny("bench_fused_ab", monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = bench_fused_ab.main(["--device", "cpu", *TINY_ARGS["bench_fused_ab"],
                                   "--skip-batch", "--skip-quality"])
    for row in ("fast_b1", "fast_b1_int8w"):
        assert res[row]["fused_off"]["k2_launches"] == 0
        assert res[row]["fused_on"]["k2_launches"] > 0


def test_profile_diffusion_step_profiles_after_every_timing(monkeypatch):
    """The busy passes (a torch.profiler session each, stood in for by a
    recorder) come after every timing of the process, one per row, each
    on the run its row was timed with."""
    from tortoise_tpu_torch.tools import profile_diffusion_step
    from tortoise_tpu_torch.utils import measure

    _tiny("profile_diffusion_step", monkeypatch)
    calls = []
    time_steps = measure.time_steps

    def timing(run, steps, dev):
        calls.append("time")
        return time_steps(run, steps, dev)

    def profiled(run, steps, dev):
        calls.append("busy")
        run(steps)
        return 2.0

    monkeypatch.setattr(measure, "time_steps", timing)
    monkeypatch.setattr(profile_diffusion_step, "_busy", profiled)
    res = profile_diffusion_step.main(["--device", "cpu", "--tout", "32", "48", "--steps", "1",
                                       "--batch", "1"])
    assert calls == ["time"] * 4 + ["busy"] * 4
    assert all(r["busy_ms"] == 2.0 for r in res["rows"].values())
