"""The CUDA kernels K1, K2 (every weight x cache variant), K3-K8 against
their plain PyTorch versions, on the GPU.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax (tests/conftest.py imports jax; skip it there):

    python3 -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device the gpu cases skip; the others run anywhere.
"""
import shutil
import subprocess
import warnings

import pytest
import torch

from tortoise_tpu_torch.api import TextToSpeech
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
from tortoise_tpu_torch.models.clvp import CLVPConfig
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig
from tortoise_tpu_torch.ops import _build
from tortoise_tpu_torch.ops.attn import flash_rel_attention, flash_rel_attention_plain
from tortoise_tpu_torch.ops.decode_step import (fused_decode_step, fused_decode_step_plain,
                                                quantize_cache, quantize_stack, variant)

torch.set_num_threads(2)

# tiny models whose attention heads are 64 wide, the kernels' head dim
TINY = dict(
    ar_config=UnifiedVoiceConfig(layers=2, model_dim=128, heads=2, max_text_tokens=60,
                                 max_mel_tokens=80),
    diffusion_config=DiffusionTtsConfig(model_channels=128, num_layers=2,
                                        in_latent_channels=128, num_heads=2),
    clvp_config=CLVPConfig(dim_text=128, dim_speech=128, dim_latent=128, text_enc_depth=2,
                           text_heads=2, speech_enc_depth=2, speech_heads=2))


def _tiny_tts(device, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TextToSpeech(device=device, enable_redaction=False, autoregressive_batch_size=2,
                            **TINY, **kwargs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only run on the GPU")
    return torch.device("cuda")


def _stack(g, dev, L, C, std=0.03):
    r = lambda *s: (torch.randn(s, generator=g, device=dev) * std).to(torch.bfloat16)
    return {"ln1": torch.stack([1 + r(L, C), r(L, C)], 1).contiguous(),
            "ln2": torch.stack([1 + r(L, C), r(L, C)], 1).contiguous(),
            "wqkv": r(L, 3 * C, C), "bqkv": r(L, 3 * C), "wproj": r(L, C, C),
            "bproj": r(L, C), "wfc": r(L, 4 * C, C), "bfc": r(L, 4 * C),
            "wfc2": r(L, C, 4 * C), "bfc2": r(L, C)}


@pytest.mark.gpu
@pytest.mark.parametrize("b,pos", [(1, 0), (3, 37), (16, 100), (20, 255)])
def test_decode_step_kernel_matches_plain(cuda, b, pos):
    L, C, H, T = 2, 1024, 16, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    stacked = _stack(g, cuda, L, C)
    cache = {k: torch.randn((L, b, T, C), generator=g, device=cuda).to(torch.bfloat16)
             for k in ("k", "v")}
    x = torch.randn((b, C), generator=g, device=cuda).to(torch.bfloat16)
    before = fused_decode_step.launches
    got = fused_decode_step(stacked, x, cache, pos, H)
    assert fused_decode_step.launches == before + 1
    want = fused_decode_step_plain(stacked, x, cache, pos, H)
    for a, w in zip(got, want):
        w = w.float()
        assert (a.float() - w).abs().max().item() <= 0.03 * w.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8_weights", "int8_cache", "int8_weights_int8_cache"])
@pytest.mark.parametrize("b,pos", [(1, 0), (3, 37), (16, 200)])
def test_decode_step_int8_kernels_match_plain(cuda, kind, b, pos):
    L, C, H, T = 2, 1024, 16, 256
    g = torch.Generator(device=cuda).manual_seed(1)
    stacked = _stack(g, cuda, L, C)
    cache = {k: torch.randn((L, b, T, C), generator=g, device=cuda).to(torch.bfloat16)
             for k in ("k", "v")}
    if "weights" in kind:
        stacked = quantize_stack(stacked)
    if "cache" in kind:
        cache = quantize_cache(cache, H)
    assert variant(stacked, cache) == kind
    x = torch.randn((b, C), generator=g, device=cuda).to(torch.bfloat16)
    before = fused_decode_step.launches_by_variant[kind]
    got = fused_decode_step(stacked, x, cache, pos, H)
    assert fused_decode_step.launches_by_variant[kind] == before + 1
    want = fused_decode_step_plain(stacked, x, cache, pos, H)
    for a, w in zip(got, want):
        w = w.float()
        assert (a.float() - w).abs().max().item() <= 0.03 * w.abs().max().item()


@pytest.mark.gpu
def test_decode_step_int8_kernels_reject_bad_scales(cuda):
    L, C, H, T = 1, 1024, 16, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    stacked = quantize_stack(_stack(g, cuda, L, C))
    cache = quantize_cache({k: torch.zeros((L, 2, T, C), dtype=torch.bfloat16, device=cuda)
                         for k in "kv"}, H)
    x = torch.zeros((2, C), dtype=torch.bfloat16, device=cuda)
    bad = dict(cache, k_scale=cache["k_scale"].transpose(2, 3).contiguous())  # (L, B, T, H)
    with pytest.raises(ValueError, match="k_scale"):
        fused_decode_step(stacked, x, bad, 0, H)
    with pytest.raises(ValueError, match="v_scale"):
        fused_decode_step(stacked, x, {n: t for n, t in cache.items() if n != "v_scale"}, 0, H)
    with pytest.raises(ValueError, match="sfc"):
        fused_decode_step(dict(stacked, sfc=stacked["sfc"][:, :C].contiguous()), x, cache, 0, H)
    with pytest.raises(ValueError, match="bqkv"):
        fused_decode_step(dict(stacked, bqkv=stacked["bqkv"].bfloat16()), x, cache, 0, H)


@pytest.mark.gpu
def test_decode_step_kernel_rejects_bad_input(cuda):
    L, C, T = 1, 1024, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    stacked = _stack(g, cuda, L, C)
    cache = {k: torch.zeros((L, 2, T, C), dtype=torch.bfloat16, device=cuda) for k in "kv"}
    x = torch.zeros((2, C), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="pos"):
        fused_decode_step(stacked, x, cache, T, 16)
    with pytest.raises(ValueError, match="head dim"):
        fused_decode_step(stacked, x, cache, 0, 8)
    bad = dict(stacked, wqkv=stacked["wqkv"].float())
    with pytest.raises(ValueError, match="wqkv"):
        fused_decode_step(bad, x, cache, 0, 16)


K2_EDGE_T = 320  # pos T - 1 = 319 beside 255


def _k2_inputs(g, dev, kind, L, b, C, H, T):
    stacked = _stack(g, dev, L, C)
    cache = {k: torch.randn((L, b, T, C), generator=g, device=dev).to(torch.bfloat16)
             for k in ("k", "v")}
    if "weights" in kind:
        stacked = quantize_stack(stacked)
    if "cache" in kind:
        cache = quantize_cache(cache, H)
    x = torch.randn((b, C), generator=g, device=dev).to(torch.bfloat16)
    return stacked, cache, x


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8_weights", "int8_cache",
                                  "int8_weights_int8_cache"])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 16, 17, 96, 128, 129, 256])
def test_decode_step_kernel_edges(cuda, kind, b):
    """The batch tail of the products' n side and the block's batch tile
    (128 rows; 129 and 256 loop over two tiles, 256 being the int8 cache's
    quality batch, b x heads = 4096 attention blocks), and prefixes of 0,
    1, 63, 64, 65, 255 and T-1 rows: shorter than one 64-row stage, at its
    edge, ending inside a split and at a split boundary of the plan."""
    from tortoise_tpu_torch.ops.decode_step import plan_step

    L, C, H, T = 2, 1024, 16, K2_EDGE_T
    g = torch.Generator(device=cuda).manual_seed(b)
    stacked, cache, x = _k2_inputs(g, cuda, kind, L, b, C, H, T)
    assert variant(stacked, cache) == kind
    for pos in (0, 1, 63, 64, 65, 255, T - 1):
        plan = plan_step(b, C, pos, H)
        got = fused_decode_step(stacked, x, cache, pos, H)
        want = fused_decode_step_plain(stacked, x, cache, pos, H)
        for a, w in zip(got, want):
            w = w.float()
            err = (a.float() - w).abs().max().item()
            assert err <= 0.03 * w.abs().max().item(), (pos, plan, err)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8_weights", "int8_cache",
                                  "int8_weights_int8_cache"])
@pytest.mark.parametrize("b,pos", [(1, 255), (16, 200), (96, 100)])
def test_decode_step_kernel_is_deterministic(cuda, kind, b, pos):
    """Split K and split prefixes sum in a fixed order: two calls on the same
    inputs give bit-equal outputs."""
    L, C, H, T = 2, 1024, 16, K2_EDGE_T
    g = torch.Generator(device=cuda).manual_seed(7)
    stacked, cache, x = _k2_inputs(g, cuda, kind, L, b, C, H, T)
    first = fused_decode_step(stacked, x, cache, pos, H, with_attention=True)
    second = fused_decode_step(stacked, x, cache, pos, H, with_attention=True)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 96, 128])
def test_decode_step_is_one_kernel_launch(cuda, b):
    """A step of up to 128 rows is one persistent launch: the step counter
    and the device-launch counter each rise by one."""
    L, C, H, T = 2, 1024, 16, K2_EDGE_T
    g = torch.Generator(device=cuda).manual_seed(3)
    stacked, cache, x = _k2_inputs(g, cuda, "bf16", L, b, C, H, T)
    steps, launches = fused_decode_step.launches, fused_decode_step.device_launches
    fused_decode_step(stacked, x, cache, 100, H)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == steps + 1
    assert fused_decode_step.device_launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind,family", [("bf16", "K2 gemm"), ("int8_cache", "K2 gemm"),
                                         ("int8_weights", "K2 gemm int8"),
                                         ("int8_weights_int8_cache", "K2 gemm int8")])
def test_decode_step_profiles_as_one_k2_op(cuda, kind, family):
    """Under the profiler a step shows one device op of K2's families, in the
    family the benchmark's frozen table (portbench.trace) gives its weights;
    nothing of it falls into "other"."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    L, C, H, T = 2, 1024, 16, K2_EDGE_T
    g = torch.Generator(device=cuda).manual_seed(4)
    stacked, cache, x = _k2_inputs(g, cuda, kind, L, 96, C, H, T)
    fused_decode_step(stacked, x, cache, 100, H)  # the build and the sync words
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_decode_step(stacked, x, cache, 100, H)
        torch.cuda.synchronize()
    device, _ = trace.events(prof)
    k2 = [name for name, _, _ in device if trace.family(name).startswith("K2")]
    assert len(k2) == 1 and trace.family(k2[0]) == family, k2
    assert "tc_gemm_kernel" in k2[0]


@pytest.mark.gpu
def test_decode_step_phase_stamps_split_the_step(cuda):
    """The kernel's own stamps (profiling.k2_phases): every phase of every
    layer took time, and the phases' critical paths and barriers add up to
    no more than the step."""
    from tortoise_tpu_torch.utils.profiling import K2_PHASES, k2_phases

    L, C, H, T = 2, 1024, 16, K2_EDGE_T
    g = torch.Generator(device=cuda).manual_seed(5)
    stacked, cache, x = _k2_inputs(g, cuda, "bf16", L, 16, C, H, T)
    run = lambda: fused_decode_step(stacked, x, cache, 100, H)
    run()
    split = k2_phases(run, L)
    assert set(split["by_phase"]) == set(K2_PHASES)
    assert all(p["critical_us"] > 0 and p["mean_block_us"] > 0 for p in split["by_phase"].values())
    total = sum(p["critical_us"] + p["barrier_us"] for p in split["by_phase"].values()) * L
    assert 0 < total <= split["step_us"] * 1.01
    assert fused_decode_step.trace is None


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t", [(1, 2, 100), (2, 16, 333), (2, 16, 64)])
def test_flash_rel_attention_kernel_matches_plain(cuda, b, h, t):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, h, t, 64), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    vec = torch.randn((h, 2 * t - 1), generator=g, device=cuda)
    lens = torch.tensor([t - 3, t // 2][:b], dtype=torch.int32, device=cuda)
    before = flash_rel_attention.launches
    got = flash_rel_attention(q, k, v, vec, lens)
    assert flash_rel_attention.launches == before + 1
    want = flash_rel_attention_plain(q, k, v, vec, lens)
    for i, n in enumerate(lens.tolist()):
        assert (got[i, :, :n].float() - want[i, :, :n].float()).abs().max().item() <= 0.02


# (B, H, T, valid lengths): T=2229 (the quality path's longest diffusion
# length) with the last key tile 1, 63, 64 or 65 keys long or full, at B=1
# (ultra_fast's batch); T not a multiple of 8; a valid length that ends
# mid-tile in one batch row and on a tile edge in the other
K3_TILING_CASES = [(1, 16, 2229, [1]), (1, 16, 2229, [63]), (1, 16, 2229, [64]),
                   (1, 16, 2229, [65]), (1, 16, 2229, [2229]), (1, 16, 2229, [2224]),
                   (2, 4, 97, [97, 50]), (2, 4, 333, [100, 128]), (2, 4, 333, [192, 333])]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,lens", K3_TILING_CASES)
def test_flash_rel_attention_kernel_tiling_edges(cuda, b, h, t, lens):
    """K3's 64-row q tiles and 64-key k/v tiles at their edges: every valid
    row within 0.02 of the plain version (a bf16 output of O(1) values)."""
    g = torch.Generator(device=cuda).manual_seed(t + sum(lens))
    q, k, v = (torch.randn((b, h, t, 64), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    vec = torch.randn((h, 2 * t - 1), generator=g, device=cuda)
    valid = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = flash_rel_attention(q, k, v, vec, valid)
    torch.cuda.synchronize()
    want = flash_rel_attention_plain(q, k, v, vec, valid)
    for i, n in enumerate(lens):
        assert (got[i, :, :n].float() - want[i, :, :n].float()).abs().max().item() <= 0.02


@pytest.mark.gpu
def test_flash_rel_attention_kernel_zero_valid_len_gives_zeros(cuda):
    """valid_len = 0 runs no key tile: the output is zeros (rows past
    valid_len carry no meaning; this pins the kernel's behaviour)."""
    q = torch.ones((2, 2, 70, 64), dtype=torch.bfloat16, device=cuda)
    valid = torch.tensor([0, 70], dtype=torch.int32, device=cuda)
    got = flash_rel_attention(q, q, q, torch.zeros((2, 139), device=cuda), valid)
    assert torch.equal(got[0], torch.zeros_like(got[0])) and torch.equal(got[1], q[1])


@pytest.mark.gpu
def test_flash_rel_attention_kernel_rejects_bad_input(cuda):
    q = torch.zeros((1, 2, 10, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D=64"):
        flash_rel_attention(q, q, q, torch.zeros((2, 19), device=cuda),
                            torch.tensor([10], dtype=torch.int32, device=cuda))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_failed_compile_raises_and_leaves_no_library(monkeypatch, tmp_path):
    """A kernel whose source does not compile raises at its first launch,
    with the compiler's output, and leaves nothing in the build directory
    for a later call to load."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **_: subprocess.CompletedProcess(
        cmd, 2, "", "probe_ops.cu(1): error: bad kernel"))
    with pytest.raises(RuntimeError, match=r"nvcc failed on probe_ops.cu \(exit 2\)"
                                           r"[\s\S]*error: bad kernel"):
        _build.Kernel("probe_ops", "tt_null", [])(0)
    assert list(tmp_path.iterdir()) == []


def test_library_name_follows_the_sources_and_flags(monkeypatch, tmp_path):
    """A library is named by a hash of every source under csrc and the
    compiler flags: an unchanged tree names the same one, an edit to any
    source (a shared header too) or to the flags a new one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    first = _build.library_path("probe_ops")
    assert _build.library_path("probe_ops") == first
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text() + "\n// edited\n")
    edited = _build.library_path("probe_ops")
    assert edited != first and edited.parent == first.parent
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.library_path("probe_ops") not in (first, edited)


def test_unchanged_sources_reuse_the_last_build(monkeypatch, tmp_path):
    """A library built from the current sources is taken as it is: no
    compiler runs."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    built = _build.library_path("lvc")
    built.write_bytes(b"")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("the compiler ran"))
    assert _build.build("lvc") == built


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextToSpeech(device="cuda", enable_redaction=False)


def test_cpu_defaults_to_plain_versions():
    tts = _tiny_tts("cpu")
    assert not tts.gpt_fused_step and not tts.flash_attn


@pytest.mark.gpu
def test_float32_model_on_cuda_still_runs_both_kernels(cuda):
    """half=False keeps the kernels: they cast their inputs to bf16."""
    from tortoise_tpu_torch.utils.audio import load_voice

    tts = _tiny_tts(cuda, half=False)
    assert tts.gpt_fused_step and tts.flash_attn
    clips, _ = load_voice("train_dotrice")
    before = (fused_decode_step.launches, flash_rel_attention.launches)
    wav = tts.tts_with_preset("A short test.", preset="ultra_fast", voice_samples=clips,
                              num_autoregressive_samples=2, diffusion_iterations=3,
                              max_mel_tokens=24, use_deterministic_seed=3, verbose=False)
    assert fused_decode_step.launches > before[0] and flash_rel_attention.launches > before[1]
    assert wav.dtype == torch.float32 and torch.isfinite(wav).all()


@pytest.mark.gpu
def test_float32_cache_on_cuda_needs_the_plain_decode_asked_for(cuda):
    with pytest.raises(ValueError, match="gpt_fused_step=False"):
        _tiny_tts(cuda, kv_cache_dtype="f32")
    tts = _tiny_tts(cuda, kv_cache_dtype="f32", gpt_fused_step=False)
    assert not tts.gpt_fused_step and tts.flash_attn


@pytest.mark.gpu
@pytest.mark.parametrize("gpt_weights,kind", [("bf16", "bf16"), ("int8", "int8_weights"),
                                              ("int8_decode", "int8_weights")])
def test_fast_path_on_cuda_runs_its_k2_variant(cuda, gpt_weights, kind):
    """TextToSpeechFast on CUDA decodes with K2 by default, the variant its
    gpt_weights select, in tts and in tts_stream (same codes both ways)."""
    from tortoise_tpu_torch.api_fast import TextToSpeechFast

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TextToSpeechFast(device=cuda, ar_config=TINY["ar_config"], gpt_weights=gpt_weights)
    assert tts.gpt_fused_step
    before = fused_decode_step.launches_by_variant[kind]
    wav = tts.tts("A short test.", use_deterministic_seed=3, max_mel_tokens=24, verbose=False)
    codes = tts.last_codes
    assert fused_decode_step.launches_by_variant[kind] > before
    chunks = list(tts.tts_stream("A short test.", use_deterministic_seed=3, max_mel_tokens=24,
                                 verbose=False))
    assert (tts.last_codes == codes).all() and sum(len(c) for c in chunks) == wav.shape[2]
    assert wav.dtype == torch.float32 and torch.isfinite(wav).all()


def _k4_inputs(g, dev, b, f, hop, ci=32, co=64, k=3, layers=4, channels_first=True):
    """x (B, F*hop, Ci), by default the transposed view of a channels-first
    conv output, and kernels/bias as UnivNet's predictor hands them over:
    slices [:, l] of (B, L, F, ...) tensors, strided over frames."""
    x = torch.randn((b, ci, f * hop), generator=g, device=dev).transpose(1, 2) \
        if channels_first else torch.randn((b, f * hop, ci), generator=g, device=dev)
    kernels = torch.randn((b, f, layers, ci, co, k), generator=g, device=dev).transpose(1, 2)
    bias = torch.randn((b, f, layers, co), generator=g, device=dev).transpose(1, 2)
    return x, kernels[:, 1], bias[:, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("hop", [8, 64, 256])
@pytest.mark.parametrize("b,f,channels_first", [(1, 2186, True), (2, 37, True),
                                                (2, 37, False)])
def test_lvc_kernel_matches_plain(cuda, hop, b, f, channels_first):
    from tortoise_tpu_torch.ops.lvc import (location_variable_convolution_lvc,
                                            location_variable_convolution_lvc_plain)

    g = torch.Generator(device=cuda).manual_seed(hop)
    x, kernels, bias = _k4_inputs(g, cuda, b, f, hop, channels_first=channels_first)
    before = location_variable_convolution_lvc.launches
    got = location_variable_convolution_lvc(x, kernels, bias, hop)
    torch.cuda.synchronize()
    assert location_variable_convolution_lvc.launches == before + 1
    want = location_variable_convolution_lvc_plain(x, kernels, bias, hop)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_lvc_kernel_rejects_bad_input(cuda):
    from tortoise_tpu_torch.ops.lvc import location_variable_convolution_lvc

    g = torch.Generator(device=cuda).manual_seed(0)
    x, kernels, bias = _k4_inputs(g, cuda, 1, 4, 8)
    with pytest.raises(ValueError, match="float32"):
        location_variable_convolution_lvc(x.double(), kernels, bias, 8)
    with pytest.raises(ValueError, match="contiguous"):
        location_variable_convolution_lvc(x, kernels.transpose(3, 4).contiguous().transpose(3, 4),
                                          bias, 8)
    with pytest.raises(ValueError, match="unit stride"):
        location_variable_convolution_lvc(torch.cat([x, x], -1)[..., ::2], kernels, bias, 8)
    with pytest.raises(ValueError, match="hop"):
        location_variable_convolution_lvc(x, kernels, bias, 16)


def _k4_predictor_inputs(g, dev, b, f, hop, ci=32, co=64, k=3, layers=4, channels_first=True):
    """x as _k4_inputs; kernels and bias as KernelPredictor.forward leaves
    them: slices [:, l] of views of channels-first conv outputs, frames
    innermost."""
    from tortoise_tpu_torch.models.vocoder import random_predictor_output

    x = torch.randn((b, ci, f * hop), generator=g, device=dev).transpose(1, 2) \
        if channels_first else torch.randn((b, f * hop, ci), generator=g, device=dev)
    kern, bias = random_predictor_output(g, b, layers, f, ci, co, k)
    return x, kern[:, 1], bias[:, 1]


@pytest.mark.gpu
@pytest.mark.parametrize("hop", [1, 4, 8, 16, 64, 128, 250, 256])
@pytest.mark.parametrize("b,f", [(1, 1), (2, 37)])
@pytest.mark.parametrize("channels_first", [True, False], ids=["x_cf", "x_cl"])
@pytest.mark.parametrize("layout", ["predictor", "blocks"])
def test_lvc_kernel_edges(cuda, hop, b, f, channels_first, layout):
    """K4 within 1e-5 of max|plain| at every hop's launch plan (hop=250: a
    thread's rows run past the frame), one frame and a tile of frames left
    part empty (F=37), both batch rows (the clip's first and last frames
    take zeros), x channels-first and channels-last, kernels in the
    predictor's frames-innermost view and with each frame's block
    contiguous; two calls bit-equal."""
    from tortoise_tpu_torch.ops.lvc import (location_variable_convolution_lvc,
                                            location_variable_convolution_lvc_plain)

    g = torch.Generator(device=cuda).manual_seed(hop + f)
    x, kernels, bias = _k4_predictor_inputs(g, cuda, b, f, hop, channels_first=channels_first)
    if layout == "blocks":
        kernels = kernels.contiguous()
    got = location_variable_convolution_lvc(x, kernels, bias, hop)
    again = location_variable_convolution_lvc(x, kernels, bias, hop)
    torch.cuda.synchronize()
    want = location_variable_convolution_lvc_plain(x, kernels, bias, hop)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_lvc_kernel_refuses_what_the_wrapper_refuses(cuda):
    """tt_lvc returns an error, and launches nothing, for a plan the wrapper
    would not make: too many frames a tile, R not dividing hop with two
    frames a tile, Co not a multiple of 8, R not in (1, 2, 4, 8), a stage
    layout too small for a frame's weights or for the last thread's x
    loads, or not of whole 16-byte pieces, and shared memory that is not
    four stages."""
    from tortoise_tpu_torch.ops import lvc

    g = torch.Generator(device=cuda).manual_seed(0)
    x, kernels, bias = _k4_predictor_inputs(g, cuda, 1, 4, 8)
    out = torch.empty((1, 32, 64), device=cuda)

    def call(co=64, hop=8, rows=8, frames=4, channels=4, **layout):
        w_frame, x_row = lvc.stage_layout(frames, hop, rows, channels, co, 3)
        w_frame, x_row = layout.get("w_frame", w_frame), layout.get("x_row", x_row)
        smem = layout.get("smem", lvc.STAGES * 4 * (frames * w_frame + channels * x_row))
        lvc._KERNEL(0, x.data_ptr(), kernels.data_ptr(), bias.data_ptr(), out.data_ptr(), 1, 4,
                    hop, 32, co, 3, *x.stride(), *lvc._kernel_strides(kernels), *bias.stride(),
                    rows, frames, channels, w_frame, x_row, smem)

    call()
    w_frame, x_row = lvc.stage_layout(4, 8, 8, 4, 64, 3)
    for bad in (dict(frames=33), dict(hop=6, rows=4, frames=2), dict(co=60), dict(rows=3),
                dict(w_frame=4 * 64 * 3 - 4), dict(x_row=x_row - 4), dict(w_frame=w_frame + 2),
                dict(smem=lvc.STAGES * 4 * (4 * w_frame + 4 * x_row) - 16)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            call(**bad)


# (q dtype, cache dtype, bound per head relative to its max|plain|): the
# bf16 output rounds once (one bf16 ulp, 2^-8), the f32 one only differs
# in summation order; a bf16 model over an f32 cache is the quality path's
# per-layer decode with kv_cache_dtype="f32"
K1_CASES = [(torch.bfloat16, torch.bfloat16, 1e-2), (torch.float32, torch.float32, 1e-5),
            (torch.bfloat16, torch.float32, 1e-2)]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,cache_dtype,bound", K1_CASES)
@pytest.mark.parametrize("b,C", [(1, 1024), (16, 1024), (64, 1024), (96, 1024), (8, 512),
                                 (16, 512)])
@pytest.mark.parametrize("pos", [0, 37, 500, 767])
def test_decode_attention_merged_kernel_matches_plain(cuda, q_dtype, cache_dtype, bound, b, C,
                                                      pos):
    """At the smoke's shapes (L=30, T=768; C=1024, H=16, and a tp=2 rank's
    C=512, H=8): every head within its bound; the row write bit-exact,
    every other row of the cache untouched."""
    from tortoise_tpu_torch.ops.attn import decode_attention_merged, decode_attention_merged_plain

    L, H, T, layer = 30, C // 64, 768, 7
    g = torch.Generator(device=cuda).manual_seed(pos)
    cache = {n: torch.randn((L, b, T, C), generator=g, device=cuda).to(cache_dtype) for n in "kv"}
    qkv = torch.randn((b, 3 * C), generator=g, device=cuda).to(q_dtype)
    q, k_new, v_new = qkv.split(C, dim=-1)
    plain = {n: t.clone() for n, t in cache.items()}
    before = decode_attention_merged.launches
    got = decode_attention_merged(q, k_new, v_new, cache["k"], cache["v"], layer, pos, heads=H)
    torch.cuda.synchronize()
    assert decode_attention_merged.launches == before + 1
    want = decode_attention_merged_plain(q, k_new, v_new, plain["k"], plain["v"], layer, pos,
                                         heads=H)
    assert torch.equal(cache["k"], plain["k"]) and torch.equal(cache["v"], plain["v"])
    w = want.float().reshape(b, H, -1)
    err = (got.float().reshape(b, H, -1) - w).abs().amax(-1) / w.abs().amax(-1)
    assert err.max().item() <= bound


@pytest.mark.gpu
def test_decode_attention_merged_kernel_rejects_bad_input(cuda):
    from tortoise_tpu_torch.ops.attn import decode_attention_merged

    cache = {n: torch.zeros((2, 3, 256, 1024), dtype=torch.bfloat16, device=cuda) for n in "kv"}
    q = torch.zeros((3, 1024), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention_merged(q, q, q, cache["k"], cache["v"], 0, 0, heads=8)
    with pytest.raises(ValueError, match="outside the cache"):
        decode_attention_merged(q, q, q, cache["k"], cache["v"], 0, 256, heads=16)
    int8 = cache["k"].to(torch.int8)
    with pytest.raises(ValueError, match="k_cache"):
        decode_attention_merged(q, q, q, int8, int8, 0, 0, heads=16)


# --- the tools' kernels: K5-K8 -----------------------------------------------------

# (BH, T, n_valid): the CPU tests' sizes and the tool's (BH=256, T=256,
# n=200); T=1; n_valid past T; BH=1; T=2229, 35 stages of 64 rows through
# the ring of four, with n_valid ending mid-stage and at T
K5_CASES = [(16, 64, 0), (16, 64, 1), (24, 64, 40), (24, 64, 64), (256, 256, 200),
            (5, 300, 999), (3, 1, 1), (3, 1, 0), (4, 100, 250), (1, 256, 200), (1, 2229, 0),
            (2, 2229, 1000), (2, 2229, 2229)]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,t,n_valid", K5_CASES)
def test_decode_attention_kv128_kernel_matches_plain(cuda, bh, t, n_valid, q_dtype):
    """K5, q in bf16 or f32 (the kernel casts it), one launch a call: f32
    output within 1e-5 of max|plain|; n_valid=0 is the uniform mean."""
    from tortoise_tpu_torch.tools.decode_attn_kv128 import (decode_attention_kv128,
                                                            decode_attention_kv128_plain)

    g = torch.Generator(device=cuda).manual_seed(bh + t + n_valid)
    kv = torch.randn((bh, t, 128), generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randn((bh, 64), generator=g, device=cuda).to(q_dtype)
    before = decode_attention_kv128.launches
    got = decode_attention_kv128(kv, q, n_valid)
    torch.cuda.synchronize()
    assert decode_attention_kv128.launches == before + 1
    want = decode_attention_kv128_plain(kv, q, n_valid)
    assert got.shape == (bh, 64) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def _after_a_sleep_on(stream, make):
    """``make()``'s tensors, written on ``stream`` behind ~25 ms of sleep: a
    kernel launched on any other stream would read them unwritten."""
    with torch.cuda.stream(stream):
        torch.cuda._sleep(50_000_000)
        return make()


@pytest.mark.gpu
def test_decode_attention_kv128_kernel_on_a_side_stream(cuda):
    """K5's wrapper launches on the current stream, not the one of its first
    call: called on the default stream, then on a side stream whose inputs
    land behind a sleep, it still matches the plain version."""
    from tortoise_tpu_torch.tools.decode_attn_kv128 import (decode_attention_kv128,
                                                            decode_attention_kv128_plain)

    g = torch.Generator(device=cuda).manual_seed(9)
    make = lambda: (torch.randn((64, 256, 128), generator=g, device=cuda).to(torch.bfloat16),
                    torch.randn((64, 64), generator=g, device=cuda))
    decode_attention_kv128(*make(), 200)
    side = torch.cuda.Stream()
    kv, q = _after_a_sleep_on(side, make)
    with torch.cuda.stream(side):
        got = decode_attention_kv128(kv, q, 200)
    side.synchronize()
    want = decode_attention_kv128_plain(kv, q, 200)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_decode_attention_kv128_kernel_rejects_bad_input(cuda):
    from tortoise_tpu_torch.tools.decode_attn_kv128 import decode_attention_kv128

    kv = torch.zeros((4, 16, 128), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="kv:"):
        decode_attention_kv128(kv.float(), q, 8)
    with pytest.raises(ValueError, match="q:"):
        decode_attention_kv128(kv, q.half(), 8)
    with pytest.raises(ValueError, match="q:"):
        decode_attention_kv128(kv, q[:3], 8)
    with pytest.raises(RuntimeError, match="CUDA error"):   # q not 16-byte aligned
        decode_attention_kv128(kv, torch.zeros(4 * 64 + 1, dtype=torch.bfloat16,
                                               device=cuda)[1:].view(4, 64), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("b,t,pos,ck", [(2, 128, 0, 32), (2, 128, 37, 32), (2, 128, 127, 32),
                                        (128, 768, 300, 64), (3, 96, 95, 96)])
def test_attn_body_kernel_matches_plain(cuda, variant, b, t, pos, ck):
    """K6 per (batch row, head) within 1e-2 of its max|plain| (a bf16
    output), at the CPU tests' sizes and the tool's."""
    from tortoise_tpu_torch.tools.bench_attn_body import attn_body, attn_body_plain, head_rel_err

    g = torch.Generator(device=cuda).manual_seed(pos + ck)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((b, 1024), (b, t, 1024), (b, t, 1024)))
    before = attn_body.launches_by_variant[variant]
    got = attn_body(q, k, v, pos, ck=ck, variant=variant)
    torch.cuda.synchronize()
    assert attn_body.launches_by_variant[variant] == before + 1
    want = attn_body_plain(q, k, v, pos, ck=ck, variant=variant)
    assert got.dtype == torch.bfloat16 and head_rel_err(got, want) <= 1e-2


@pytest.mark.gpu
def test_attn_body_kernel_rejects_bad_input(cuda):
    from tortoise_tpu_torch.tools.bench_attn_body import attn_body

    q = torch.zeros((2, 1024), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((2, 100, 1024), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="must divide"):
        attn_body(q, k, k, 10, ck=64)
    with pytest.raises(ValueError, match="variant"):
        attn_body(q, k, k, 10, ck=50, variant="c")
    with pytest.raises(ValueError, match="k:"):
        attn_body(q, k.float(), k, 10, ck=50)



@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("b,t,pos,ck", [
    (1, 128, 0, 32),        # one row
    (1, 768, 63, 64),       # pos at a chunk's and a 32-row stage's last row
    (2, 192, 47, 48),       # ck not a multiple of a 32-row stage; pos its chunk's last row
    (2, 192, 95, 96),       # ck not a multiple of a 32-row stage; pos its chunk's last row
    (2, 96, 15, 24),        # ck under a stage; pos a stage's middle row
    (2, 256, 255, 256),     # ck = T, every row
    (128, 768, 300, 64),    # the tool's shape
    (128, 768, 767, 768)])  # ck = T at the tool's batch
def test_attn_body_kernel_edges(cuda, variant, b, t, pos, ck):
    """K6 per (batch row, head) within 1e-2 of max|plain| over chunk and
    ring-stage edges; two calls bit-equal."""
    from tortoise_tpu_torch.tools.bench_attn_body import attn_body, attn_body_plain, head_rel_err

    g = torch.Generator(device=cuda).manual_seed(pos + ck)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((b, 1024), (b, t, 1024), (b, t, 1024)))
    before = attn_body.launches_by_variant[variant]
    got = attn_body(q, k, v, pos, ck=ck, variant=variant)
    again = attn_body(q, k, v, pos, ck=ck, variant=variant)
    torch.cuda.synchronize()
    assert attn_body.launches_by_variant[variant] == before + 2
    want = attn_body_plain(q, k, v, pos, ck=ck, variant=variant)
    assert head_rel_err(got, want) <= 1e-2
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(1, 8))
def test_probe_kernels_match_plain(cuda, i):
    """K7: each probe on the JAX tool's arange/100 inputs and shapes, bit
    for bit (the contraction, probe 6: within 1e-6 of max|plain|)."""
    from tortoise_tpu_torch.tools.probe_ops import PROBES, probe, probe_inputs, probe_plain

    args = probe_inputs(i, cuda)
    before = probe.launches
    got = probe(i, *args)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    want = probe_plain(i, *args)
    assert got.shape == PROBES[i - 1][2]
    if i == 6:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_probe_kernels_on_a_side_stream(cuda):
    """K7's wrapper takes the current stream: the seven probes, twice each on
    a side stream whose inputs land behind a sleep, still bit for bit (the
    contraction within 1e-6 of max|plain|)."""
    from tortoise_tpu_torch.tools.probe_ops import PROBES, probe, probe_inputs, probe_plain

    side = torch.cuda.Stream()
    for i in range(1, len(PROBES) + 1):
        args = _after_a_sleep_on(side, lambda: probe_inputs(i, cuda))
        with torch.cuda.stream(side):
            got = [probe(i, *args) for _ in range(2)]
        side.synchronize()
        want = probe_plain(i, *args)
        for out in got:
            if i == 6:
                assert (out - want).abs().max().item() <= 1e-6 * want.abs().max().item()
            else:
                assert torch.equal(out, want), i


@pytest.mark.gpu
def test_probe_kernels_reject_bad_input(cuda):
    from tortoise_tpu_torch.tools.probe_ops import probe, probe_inputs

    x, y = probe_inputs(7, cuda)
    with pytest.raises(ValueError, match="probe 7"):
        probe(7, x)
    with pytest.raises(ValueError, match="probe 7"):
        probe(7, x, y.double())
    with pytest.raises(ValueError, match="probe 7"):
        probe(7, x.transpose(1, 2).contiguous().transpose(1, 2), y)
    with pytest.raises(ValueError, match="probe 1"):
        probe(1, x)
    with pytest.raises(RuntimeError, match="CUDA error"):   # x not 16-byte aligned
        probe(7, torch.zeros(x.numel() + 1, device=cuda)[1:].view(x.shape), y)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [1, 33, 64, 66, 735])
def test_probe_dynamic_slice_at_any_start(cuda, start):
    """Probe 4's kernel at columns the tool does not use: a start that is a
    multiple of 4 takes the float4 reads, any other the scalar ones. Bit for
    bit against x[..., start:start+32]."""
    from tortoise_tpu_torch.tools.probe_ops import _PROBE, B, C, CK, H, T, probe_inputs

    x = probe_inputs(4, cuda)[0]
    out = torch.empty((B, H, 32), device=cuda)
    _PROBE(torch.cuda.current_device(), 4, x.data_ptr(), None, out.data_ptr(), B, CK, H, T, C,
           start)
    torch.cuda.synchronize()
    assert torch.equal(out, x[..., start:start + 32])


@pytest.mark.gpu
def test_kernel_helper_launches_the_null_kernel(cuda):
    """_build.Kernel looks its function up at the first call only and
    launches on the current stream, default or side; the null kernel's
    device time (measure.device_ms) is below its event time, which holds
    the host's path to the launch. A nonzero return raises."""
    from tortoise_tpu_torch.tools.probe_ops import _NULL, _PROBE
    from tortoise_tpu_torch.utils import measure

    index = torch.cuda.current_device()
    _NULL(index)
    f = _NULL._f
    with torch.cuda.stream(torch.cuda.Stream()):
        _NULL(index)
    torch.cuda.synchronize()
    assert f is not None and _NULL._f is f
    call = lambda: _NULL(index)
    assert 0 < measure.device_ms(call, 20) < measure.time_ms(call, 20)
    x = torch.zeros(64 * 16 * 768, device=cuda)
    with pytest.raises(RuntimeError, match="tt_probe failed with CUDA error"):
        _PROBE(index, 0, x.data_ptr(), None, x.data_ptr(), 64, 32, 16, 768, 1024, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [dict(b=4, ck=32, c=256, h=4), {}], ids=["small", "probe"])
def test_contraction_kernels_match_plain(cuda, sizes):
    """K8: the four orientations on seeded random bf16 operands, within
    1e-5 of max|plain| (f32 sums of exact bf16 products)."""
    from tortoise_tpu_torch.tools.probe_ops import (contraction, contraction_plain,
                                                    orientation_operands)

    g = torch.Generator(device=cuda).manual_seed(3)
    for name, (_, a, b, shape) in orientation_operands(g, cuda, **sizes).items():
        before = contraction.launches
        got = contraction(a, b).reshape(shape)
        torch.cuda.synchronize()
        assert contraction.launches == before + 1
        want = contraction_plain(a, b).reshape(shape)
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item(), name


def _padded(x: torch.Tensor) -> torch.Tensor:
    """x as a view into storage whose rows are padded to a multiple of 8
    values: unit inner stride and 16-byte aligned rows, so K8 takes it
    through its 16-byte copies, with a partial chunk at each row's end."""
    n = x.shape[-1]
    out = x.new_zeros(*x.shape[:-1], -(-n // 8) * 8)
    out[..., :n] = x
    return out[..., :n]


def _odd_orientations(g, dev, lay, b=3, ck=13, c=50, h=77):
    """The four orientations as ``orientation_operands`` builds them, at
    odd sizes, each raw operand passed through ``lay`` first: {name: (A, B)}."""
    r = lambda *s: lay(torch.randn(s, generator=g, device=dev).to(torch.bfloat16))
    k, q, qh, kk, p, m, pt, v = (r(b, ck, c), r(b, c, h), r(b, h, c), r(b, ck, c), r(b, ck, h),
                                 r(h, c), r(b, h, ck), r(b, ck, c))
    return {"o1": (k, q), "o2": (qh, kk.transpose(1, 2)),
            "p_exp": (p.reshape(1, b * ck, h), m[None]), "pv": (pt, v)}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["contiguous", "padded"])
@pytest.mark.parametrize("name", ["o1", "o2", "p_exp", "pv"])
def test_contraction_kernel_odd_sizes(cuda, layout, name):
    """K8 at BT=3 and odd I, J, R (13, 77, 50 in each orientation's places):
    contiguous operands take the element loads, padded ones the 16-byte
    copies with partial chunks; every edge tile predicated. Within 1e-5 of
    max|plain|."""
    from tortoise_tpu_torch.tools.probe_ops import contraction, contraction_plain

    g = torch.Generator(device=cuda).manual_seed(11)
    lay = _padded if layout == "padded" else (lambda x: x)
    a, b = _odd_orientations(g, cuda, lay)[name]
    got = contraction(a, b)
    torch.cuda.synchronize()
    want = contraction_plain(a, b)
    assert got.shape == want.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shared", ["a", "b"])
@pytest.mark.parametrize("r", [40, 50])
def test_contraction_kernel_shared_operand(cuda, shared, r):
    """A batch stride of 0 (one operand expanded over the batch, as p_exp's
    m[None] is at BT=1) at I=37, J=72: within 1e-5 of max|plain|."""
    from tortoise_tpu_torch.tools.probe_ops import contraction, contraction_plain

    g = torch.Generator(device=cuda).manual_seed(r)
    bt, i, j = 5, 37, 72
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    a = rnd(i, r)[None].expand(bt, i, r) if shared == "a" else rnd(bt, i, r)
    b = rnd(r, j)[None].expand(bt, r, j) if shared == "b" else rnd(bt, r, j)
    assert (a.stride(0) if shared == "a" else b.stride(0)) == 0
    got = contraction(a, b)
    torch.cuda.synchronize()
    want = contraction_plain(a, b)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_device_ms_leaves_out_launch_time(cuda):
    """measure.device_ms times the device alone (runs queued behind a
    sleeping kernel): for a call of a few microseconds it reads below
    time_ms, which includes the host's time to reach the launch."""
    from tortoise_tpu_torch.tools.probe_ops import contraction
    from tortoise_tpu_torch.utils import measure

    a = torch.ones((2, 16, 32), dtype=torch.bfloat16, device=cuda)
    call = lambda: contraction(a, a.transpose(1, 2))
    dev, event = measure.device_ms(call, 10), measure.time_ms(call, 10)
    assert 0 < dev < event


# --- group_norm_act: the diffusion decoder's masked GroupNorm chain ----------

# the decoder's site forms: (film, silu, out dtype); frames: a row as short
# as 1, the quality path's buckets, and an odd length
GN_FORMS = {"affine": (False, False, torch.bfloat16), "silu": (False, True, torch.bfloat16),
            "film_silu_mask": (True, True, torch.bfloat16),
            "f32_out": (False, True, torch.float32)}
GN_FRAMES = (1, 557, 835, 1114, 777)


def _gn_inputs(dev, t, valid, c=1024, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + t)
    b = len(valid)
    x = (torch.randn((b, t, c), generator=g, device=dev) * 1.5 + 0.3).to(torch.bfloat16)
    mask = torch.arange(t, device=dev)[None, :] < torch.tensor(valid, device=dev)[:, None]
    weight = 1 + 0.3 * torch.randn((c,), generator=g, device=dev)
    bias = 0.2 * torch.randn((c,), generator=g, device=dev)
    film = (0.5 * torch.randn((b, 2 * c), generator=g, device=dev)).to(torch.bfloat16)
    return x, mask, weight, bias, film


def _bf16_ulp(v):
    """One bf16 ulp at |v| (the smallest normal's below it)."""
    e = torch.floor(torch.log2(v.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("form", GN_FORMS)
@pytest.mark.parametrize("t", GN_FRAMES)
def test_group_norm_kernel_matches_plain(cuda, t, form):
    """B=2, C=1024 (32 groups of 32), one row full and one ragged. The
    normalised value (the affine form) within one bf16 ulp of the plain
    version's (float32 rounding where the affine cancels to near zero):
    only the float32 statistics' summation order differs, so bf16 values
    rarely differ at all. Every
    later op rounds as PyTorch's: the kernel's FiLM, SiLU and mask of its
    own normalised value equal those ops applied to it bit for bit. Padded
    frames are zero."""
    from tortoise_tpu_torch.ops.group_norm import group_norm_act, group_norm_act_plain

    use_film, silu, out_dtype = GN_FORMS[form]
    x, mask, weight, bias, film = _gn_inputs(cuda, t, [t, max(t - 61, 1)])
    film = film if use_film else None
    before = group_norm_act.launches
    got = group_norm_act(x, mask, weight, bias, 32, 1e-5, film, silu, out_dtype)
    assert group_norm_act.launches == before + 1 and got.dtype == out_dtype
    norm = group_norm_act(x, mask, weight, bias, 32, 1e-5, out_dtype=out_dtype)
    plain_norm = group_norm_act_plain(x, mask, weight, bias, 32, 1e-5, out_dtype=out_dtype)
    diff = (norm.float() - plain_norm.float()).abs()
    # one bf16 ulp, or float32 rounding (2^-16 of the call's largest value)
    # where the affine cancels to a value near zero
    tol = torch.maximum(_bf16_ulp(plain_norm), 2.0 ** -16 * plain_norm.float().abs().max())
    assert (diff <= tol).all(), diff.max().item()
    if out_dtype == torch.bfloat16:     # a flip needs a value at a rounding tie's edge
        assert (diff == 0).float().mean().item() > 0.99
    # the rest of the chain on the kernel's normalised value, op by op
    want = norm
    if film is not None:
        scale, shift = film[:, None, :].chunk(2, dim=-1)
        want = want * (1 + scale) + shift
    if silu:
        want = torch.nn.functional.silu(want)
    if film is not None or silu:
        want = want * mask[:, :, None].to(want.dtype)
    assert torch.equal(got, want)
    assert (got[~mask] == 0).all()


@pytest.mark.gpu
def test_group_norm_kernel_empty_row_gives_zeros(cuda):
    from tortoise_tpu_torch.ops.group_norm import group_norm_act, group_norm_act_plain

    x, mask, weight, bias, film = _gn_inputs(cuda, 835, [0, 300])
    for use_film, silu, out_dtype in GN_FORMS.values():
        f = film if use_film else None
        got = group_norm_act(x, mask, weight, bias, 32, 1e-5, f, silu, out_dtype)
        assert (got[0] == 0).all() and torch.isfinite(got).all()
        plain = group_norm_act_plain(x, mask, weight, bias, 32, 1e-5, f, silu, out_dtype)
        assert (plain[0] == 0).all()


@pytest.mark.gpu
def test_group_norm_kernel_is_deterministic(cuda):
    from tortoise_tpu_torch.ops.group_norm import group_norm_act

    x, mask, weight, bias, film = _gn_inputs(cuda, 1114, [1114, 1000])
    first = group_norm_act(x, mask, weight, bias, 32, 1e-5, film, True)
    for _ in range(5):
        assert torch.equal(group_norm_act(x, mask, weight, bias, 32, 1e-5, film, True), first)


@pytest.mark.gpu
def test_group_norm_kernel_rejects_bad_input(cuda):
    from tortoise_tpu_torch.ops.group_norm import MAX_FRAMES, group_norm_act

    x, mask, weight, bias, film = _gn_inputs(cuda, 64, [64, 30])
    good = dict(x=x, mask=mask, weight=weight, bias=bias, groups=32, eps=1e-5, film=film)
    bad = [dict(x=x.float()),                                       # dtype
           dict(x=x.transpose(1, 2).contiguous().transpose(1, 2)),  # contiguity
           dict(groups=64), dict(groups=8),                         # groups of 16, 128
           dict(mask=mask.float()),
           dict(mask=mask[:1]),
           dict(weight=weight.to(torch.bfloat16)),
           dict(bias=bias[:512]),
           dict(film=film[:, :1024].contiguous()),
           dict(film=film.float()),
           dict(mask=None)]
    for change in bad:
        with pytest.raises(ValueError):
            group_norm_act(**{**good, **change})
    with pytest.raises(ValueError):
        group_norm_act(**good, out_dtype=torch.float16)
    long_x = torch.zeros((1, MAX_FRAMES + 1, 1024), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        group_norm_act(long_x, torch.ones((1, MAX_FRAMES + 1), dtype=torch.bool, device=cuda),
                       weight, bias, 32, 1e-5)


def _served_diffusion(dev):
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts
    from tortoise_tpu_torch.weights import cast_for_inference, init_random

    with torch.device(dev):
        model = DiffusionTts(DiffusionTtsConfig())
    init_random(model, 0)
    return cast_for_inference(model, torch.bfloat16).eval()


def _diffusion_step_inputs(model, dev, b=2, t=835):
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn((b, t, 100), generator=g, device=dev)
    ts = torch.tensor([1200, 37][:b], device=dev)
    pre = torch.randn((b, t, 1024), generator=g, device=dev).to(model.dtype)
    valid = torch.tensor([t - 40, t - 101][:b], device=dev)
    return x, ts, pre, valid, model.rel_bias_vectors(t)


@pytest.mark.gpu
def test_group_norm_kernel_in_the_served_diffusion_forward(cuda, monkeypatch):
    """The full-width served forward (10 layers, 1024 channels, bf16): a
    captured and replayed forward equals its eager forward bit for bit; each
    forward launches the kernel 46 times (3 + 10 layers x 3 norms, 3 tails x
    2, out_norm), a replay counting what its capture recorded; and the
    forward with the kernel is within the benchmark's diffusion_err limit
    (0.04, relative L2 over a row's valid frames) of the one with every
    chain op by op."""
    from tortoise_tpu_torch.ops import group_norm

    model = _served_diffusion(cuda)
    x, ts, pre, valid, biases = _diffusion_step_inputs(model, cuda)
    with torch.inference_mode():
        run = lambda: model(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
        counts = []
        for _ in range(3):          # eager and capture, then two replays
            before = group_norm.group_norm_act.launches
            out = run()
            counts.append(group_norm.group_norm_act.launches - before)
        assert counts == [46, 46, 46], counts
        assert model.graphs.captures == 1 and model.graphs.replays == 2
        eager = model._forward_eager(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
        assert torch.equal(out, eager)
        monkeypatch.setattr(group_norm, "engages", lambda *a, **k: False)
        before = group_norm.group_norm_act.launches
        plain = model._forward_eager(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
        assert group_norm.group_norm_act.launches == before
    for row, n in enumerate(valid.tolist()):
        err = ((out[row, :n] - plain[row, :n]).norm() / plain[row, :n].norm()).item()
        assert err < 0.04, (row, err)
