"""Checkpoints where and as the JAX package keeps them (tortoise_tpu/weights.py):
the flat .npz param trees either package writes, the search order of
get_params (the .npz in models_dir or $TORTOISE_TPU_MODELS_DIR, the
reference .pth in models_dir, then in $TORTOISE_MODELS_DIR, converted and
cached), the API front ends with models_dir=None, and the port's
convert_checkpoints tool. Both directories are pointed at tmp_path: no test
reads or writes under ~/.cache."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from test_torch_weights import _ref_clvp, _ref_vocoder
from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch import weights

torch.set_num_threads(2)
TOL = 1e-5
AR_KW = dict(layers=2, model_dim=64, heads=2, max_text_tokens=20, max_mel_tokens=30)
CLVP_KW = dict(dim_text=128, dim_speech=128, dim_latent=128, text_enc_depth=2, text_heads=2,
               speech_enc_depth=2, speech_heads=2)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """MODELS_DIR and TORCH_MODELS_DIR of both packages in tmp_path."""
    native, ref = tmp_path / "native", tmp_path / "reference"
    native.mkdir()
    ref.mkdir()
    for mod in (weights, jax_weights):
        monkeypatch.setattr(mod, "MODELS_DIR", str(native))
        monkeypatch.setattr(mod, "TORCH_MODELS_DIR", str(ref))
    return native, ref


def _jax_ar_tree():
    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)
    return jax.tree_util.tree_map(np.asarray, init_unified_voice(
        UnifiedVoice(UnifiedVoiceConfig(**AR_KW)), 0)["params"])


def _jax_clvp(**extra):
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig

    jm = CLVP(CLVPConfig(**CLVP_KW, **extra))
    tree = jax_weights.host_init(lambda: jm.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 4), jnp.int32),
                                                 jnp.zeros((1, 4), jnp.int32)), seed=3)["params"]
    return jm, tree


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_defaults_are_the_jax_packages():
    """The same environment variables and defaults as the JAX package."""
    assert weights.MODELS_DIR == jax_weights.MODELS_DIR
    assert weights.TORCH_MODELS_DIR == jax_weights.TORCH_MODELS_DIR
    assert weights.REFERENCE_CHECKPOINTS == jax_weights.TORCH_CHECKPOINTS


@pytest.mark.parametrize("root", [False, True])
def test_jax_npz_loads_as_native(dirs, root):
    """A tree the JAX package's save_params wrote (bare, or under a
    "params" root) loads through load_weights as "native", and the tiny
    CLVP it fills scores as the JAX model does from the same tree."""
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig

    native, _ = dirs
    jm, tree = _jax_clvp()
    jax_weights.save_params(str(native / "clvp.npz"), {"params": tree} if root else tree)
    port = CLVP(CLVPConfig(**CLVP_KW))
    assert weights.load_weights("clvp", port, None, False, 0) == "native"
    rng = np.random.default_rng(0)
    text, cands = rng.integers(0, 256, (1, 12)), rng.integers(0, 8192, (3, 20))
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(text), jnp.asarray(cands),
                               method=type(jm).score_candidates))
    with torch.no_grad():
        got = port.eval().score_candidates(torch.as_tensor(text), torch.as_tensor(cands))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_port_npz_loads_in_the_jax_package(tmp_path):
    """The port's save_params writes what the JAX package's load_params
    reads: the same keys and arrays (int8, float32, scalars)."""
    tree = jax_weights.quantize_gpt_weights(_jax_ar_tree())
    tree["temperature"] = np.float32(1.5)
    weights.save_params(str(tmp_path / "ar.npz"), tree)
    _same_trees(jax_weights.load_params(str(tmp_path / "ar.npz")), tree)
    _same_trees(weights.load_params(str(tmp_path / "ar.npz")), tree)


def test_reference_pth_is_converted_and_cached_as_the_jax_package_does(dirs, tmp_path,
                                                                      monkeypatch):
    """models_dir=None, the reference .pth in TORCH_MODELS_DIR: the first
    load converts it and writes MODELS_DIR/vocoder.npz, the next reads that
    (the JAX package's get_params: "torch", then "native"), and both
    packages' caches hold the same tree."""
    from tortoise_tpu_torch.models.vocoder import UnivNetGenerator

    native, ref = dirs
    torch.manual_seed(0)
    sd, _ = _ref_vocoder()
    torch.save({"model_g": sd}, ref / "vocoder.pth")
    port = UnivNetGenerator()
    assert weights.load_weights("vocoder", port, None, False, 0) == "reference"
    assert (native / "vocoder.npz").exists()
    first = {k: v.clone() for k, v in port.state_dict().items()}
    assert weights.load_weights("vocoder", UnivNetGenerator(), None, False, 0) == "native"
    port_cache = weights.load_params(str(native / "vocoder.npz"))

    jax_native = tmp_path / "jax_native"
    monkeypatch.setattr(jax_weights, "MODELS_DIR", str(jax_native))
    sources = [jax_weights.get_params("vocoder", None, None, allow_random=False)[1]
               for _ in range(2)]
    assert sources == ["torch", "native"]
    _same_trees(jax_weights.load_params(str(jax_native / "vocoder.npz")), port_cache)
    again = UnivNetGenerator()
    weights.load_weights("vocoder", again, None, False, 0)
    for k, v in again.state_dict().items():
        assert torch.equal(v, first[k]), k


def test_search_order(dirs, tmp_path):
    """The .npz wins over a .pth in models_dir, which wins over one in
    TORCH_MODELS_DIR; models_dir replaces MODELS_DIR for the .npz; with
    nothing anywhere, random weights or FileNotFoundError."""
    native, ref = dirs
    models = tmp_path / "models"
    models.mkdir()
    torch.manual_seed(0)
    sd, convert = _ref_clvp()
    torch.save(sd, ref / "clvp2.pth")
    assert weights.find_params("clvp", str(models))[1] == "reference"
    assert (models / "clvp.npz").exists()           # cached into models_dir, as get_params
    (models / "clvp.npz").unlink()
    torch.save(sd, models / "clvp2.pth")
    assert weights.find_params("clvp", str(models))[1] == "reference"
    assert not (models / "clvp.npz").exists()       # a .pth in models_dir is not cached
    weights.save_params(str(models / "clvp.npz"), convert(sd))
    tree, source = weights.find_params("clvp", str(models))
    assert source == "native"
    _same_trees(tree, convert(sd))
    assert weights.find_params("cvvp", str(models)) == (None, "random")
    with pytest.raises(FileNotFoundError, match="cvvp"):
        weights.load_weights("cvvp", torch.nn.Linear(1, 1), str(models), False, 0)


def test_a_cache_write_that_fails_is_ignored(dirs, monkeypatch):
    native, ref = dirs
    torch.manual_seed(0)
    sd, _ = _ref_clvp()
    torch.save(sd, ref / "clvp2.pth")

    def refuse(path, tree):
        raise PermissionError(path)

    monkeypatch.setattr(weights, "save_params", refuse)
    tree, source = weights.find_params("clvp", None)
    assert source == "reference" and tree is not None


@pytest.mark.parametrize("via", ["npz", "pth"])
def test_int8_weights_quantize_either_source_alike(dirs, via):
    """gpt_weights="int8" quantizes a tree read from an .npz exactly as one
    converted from a .pth: the JAX package's quantize_gpt_weights."""
    from test_torch_weights import _ref_autoregressive
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig

    native, ref = dirs
    torch.manual_seed(0)
    sd, convert = _ref_autoregressive()
    if via == "npz":
        jax_weights.save_params(str(native / "autoregressive.npz"), convert(sd))
    else:
        torch.save(sd, ref / "autoregressive.pth")
    from test_torch_weights import D, HEADS, LAYERS

    port = UnifiedVoice(UnifiedVoiceConfig(layers=LAYERS, model_dim=D, heads=HEADS,
                                           max_text_tokens=20, max_mel_tokens=30,
                                           quant_weights=True))
    assert weights.load_weights("autoregressive", port, None, False, 0) == \
        ("native" if via == "npz" else "reference")
    want = jax_weights.quantize_gpt_weights(convert(sd))["gpt"]["h_scan"]["block"]["mlp_fc"]
    got = port.gpt.h_scan.block.mlp_fc
    np.testing.assert_array_equal(got.weight.numpy(), np.swapaxes(want["kernel"], -1, -2))
    np.testing.assert_array_equal(got.qscale.detach().numpy(), want["qscale"])


def test_text_to_speech_reads_the_default_directories(dirs):
    """TextToSpeech(models_dir=None) reads the JAX package's .npz trees from
    MODELS_DIR: CLVP's plain-Transformer variant (the model it builds is
    the variant the tree holds) and UnifiedVoice, each "native"."""
    from test_torch_kernels_gpu import TINY
    from tortoise_tpu.models.autoregressive import UnifiedVoice as JaxUV
    from tortoise_tpu.models.autoregressive import UnifiedVoiceConfig as JaxUVC
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu_torch.api import TextToSpeech

    native, _ = dirs
    jm, tree = _jax_clvp(use_xformers=False)
    jax_weights.save_params(str(native / "clvp.npz"), tree)
    ar_cfg = TINY["ar_config"]
    ar_tree = init_unified_voice(JaxUV(JaxUVC(
        layers=ar_cfg.layers, model_dim=ar_cfg.model_dim, heads=ar_cfg.heads,
        max_text_tokens=ar_cfg.max_text_tokens, max_mel_tokens=ar_cfg.max_mel_tokens)), 0)
    jax_weights.save_params(str(native / "autoregressive.npz"), ar_tree)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TextToSpeech(device="cpu", half=False, enable_redaction=False,
                           autoregressive_batch_size=2, **TINY)
    assert (tts.clvp_source, tts.ar_source, tts.diffusion_source) == \
        ("native", "native", "random")
    assert not tts.clvp.config.use_xformers
    rng = np.random.default_rng(1)
    text, cands = rng.integers(0, 256, (1, 12)), rng.integers(0, 8192, (3, 20))
    want = np.asarray(jm.apply({"params": tree}, jnp.asarray(text), jnp.asarray(cands),
                               method=type(jm).score_candidates))
    with torch.no_grad():
        got = tts.clvp.score_candidates(torch.as_tensor(text), torch.as_tensor(cands))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())
    want_w = np.swapaxes(np.asarray(ar_tree["params"]["mel_head"]["kernel"]), 0, 1)
    np.testing.assert_array_equal(tts.autoregressive.mel_head.weight.detach().numpy(), want_w)


def test_text_to_speech_fast_reads_the_default_directories(dirs):
    """TextToSpeechFast(models_dir=None), gpt_weights="int8": UnifiedVoice
    from MODELS_DIR's .npz ("native"), quantized as the JAX package's fast
    API quantizes the tree it loads."""
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig

    native, _ = dirs
    tree = _jax_ar_tree()
    jax_weights.save_params(str(native / "autoregressive.npz"), tree)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TextToSpeechFast(device="cpu", dtype=torch.float32, gpt_weights="int8",
                               ar_config=UnifiedVoiceConfig(**AR_KW))
    assert (tts.ar_source, tts.hifi_source) == ("native", "random")
    want = jax_weights.quantize_gpt_weights(tree)["gpt"]["h_scan"]["block"]["attn"]["c_attn"]
    got = tts.autoregressive.gpt.h_scan.block.attn.c_attn
    np.testing.assert_array_equal(got.weight.numpy(), np.swapaxes(want["kernel"], -1, -2))


def test_convert_checkpoints_writes_what_the_jax_package_reads(tmp_path):
    """The port's tools/convert_checkpoints: every reference checkpoint
    found in --src becomes --dst/<name>.npz, the tree the JAX package's
    converter gives; the others are reported skipped."""
    from tortoise_tpu_torch.tools import convert_checkpoints

    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    torch.manual_seed(0)
    voc, _ = _ref_vocoder()
    torch.save({"model_g": voc}, src / "vocoder.pth")
    clvp, _ = _ref_clvp()
    torch.save(clvp, src / "clvp2.pth")
    res = convert_checkpoints.main(["--src", str(src), "--dst", str(dst)])
    assert res["vocoder"] == str(dst / "vocoder.npz") and res["clvp"] == str(dst / "clvp.npz")
    assert all(v.startswith("skip") for k, v in res.items() if k not in ("vocoder", "clvp"))
    for name, file in (("vocoder", "vocoder.pth"), ("clvp", "clvp2.pth")):
        _same_trees(jax_weights.load_params(str(dst / f"{name}.npz")),
                    jax_weights.convert_from_torch(name, str(src / file)))
    assert convert_checkpoints.main(["--src", str(src), "--dst", str(dst), "clvp"]) == \
        {"clvp": str(dst / "clvp.npz")}


def test_convert_checkpoints_defaults():
    from tortoise_tpu_torch.tools import convert_checkpoints

    args = convert_checkpoints.build_parser().parse_args([])
    assert (args.src, args.dst, args.names) == \
        (jax_weights.TORCH_MODELS_DIR, jax_weights.MODELS_DIR, [])


@pytest.mark.parametrize("name", ["autoregressive", "autoregressive_int8", "diffusion_decoder",
                                  "clvp", "clvp_plain", "vocoder", "hifidecoder", "cvvp",
                                  "classifier", "wav2vec2", "rlg_auto"])
def test_to_jax_inverts_from_jax(name):
    """to_jax(model) gives back the JAX tree the model was filled from, bit
    for bit, for every model family (so a port model saves as the JAX
    package's .npz)."""
    from test_torch_weights import MODELS
    from tortoise_tpu_torch.convert.from_jax import from_jax, to_jax

    params, port = MODELS[name]()
    params = jax.tree_util.tree_map(np.asarray, params)
    port.load_state_dict(from_jax(port, params))
    got = to_jax(port)
    want = _flat(params)
    assert set(_flat(got)) == set(want)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[k].astype(v.dtype), err_msg=k)
        assert v.shape == want[k].shape, k
