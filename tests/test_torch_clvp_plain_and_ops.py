"""The last model and op paths of the port against the JAX package: CLVP's
plain-Transformer variant (models/simple_transformer.py, CLVP with
use_xformers=False), the complex STFT pair (ops/mel.stft, istft) and the
native crossfade binding. Same numpy inputs and weights on both sides,
float32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)
# float32 on both sides (jax_default_matmul_precision=highest): sums in
# other orders, one rounding each
TOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _random_tree(init_fn, seed):
    """Every parameter random (host_init: kernels N(0, 1/fan_in), LayerScale
    gains too), so no branch hides behind a zero or a 1e-5 gain."""
    return jax_weights.host_init(init_fn, seed=seed)["params"]


# --- SimpleTransformer -------------------------------------------------------------

@pytest.mark.parametrize("i,eps", [(1, 0.1), (18, 0.1), (19, 1e-5), (24, 1e-5), (25, 1e-6),
                                   (40, 1e-6)])
def test_layerscale_tiers(i, eps):
    """CaiT's tiers at depth 18 and 24, as the JAX function gives them, and
    the port's random init starts each gain there."""
    from tortoise_tpu.models.simple_transformer import layerscale_init as jax_init
    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.models.simple_transformer import (SimpleTransformerBlock,
                                                              layerscale_init)

    assert layerscale_init(i) == jax_init(i) == eps
    block = SimpleTransformerBlock(32, 2, i, dim_head=16)
    weights.init_random(block, 0)
    assert torch.all(block.attn_scale == torch.tensor(eps))
    assert torch.all(block.ff_scale == torch.tensor(eps))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_simple_transformer_matches_jax(causal, masked):
    """Three layers, 64 wide, 4 heads of 16, with and without a key-padding
    mask and the causal mask."""
    from tortoise_tpu.models.simple_transformer import SimpleTransformer as JaxST
    from tortoise_tpu_torch.models.simple_transformer import SimpleTransformer

    kw = dict(dim=64, depth=3, heads=4, dim_head=16, causal=causal)
    jm = JaxST(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    if masked:
        mask[1, 6:] = False
    tree = _random_tree(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = SimpleTransformer(**kw)
    port.load_state_dict(from_jax(port, tree))
    want = jm.apply({"params": tree}, jnp.asarray(x), mask=jnp.asarray(mask) if masked else None)
    with torch.no_grad():
        got = port(_t(x), mask=_t(mask, torch.bool) if masked else None)
    assert _rel(got, want) <= TOL


# --- CLVP, use_xformers=False --------------------------------------------------------

CLVP_KW = dict(dim_text=64, dim_speech=64, dim_latent=64, text_enc_depth=2, text_heads=2,
               speech_enc_depth=3, speech_heads=2, num_speech_tokens=512, use_xformers=False,
               text_seq_len=40)


@pytest.fixture(scope="module")
def clvp_plain():
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.clvp import CLVP as PClvp
    from tortoise_tpu_torch.models.clvp import CLVPConfig as PConfig

    jm = CLVP(CLVPConfig(**CLVP_KW))
    tree = _random_tree(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                        jnp.zeros((1, 4), jnp.int32)), 2)
    port = PClvp(PConfig(**CLVP_KW))
    port.load_state_dict(from_jax(port, tree))
    return jm, tree, port.eval()


def test_clvp_plain_variant_has_the_jax_tree(clvp_plain):
    """The variant's modules sit at the JAX tree's paths: position tables
    (the speech one sized by the speech vocabulary), block_{i} layers."""
    _, tree, port = clvp_plain
    assert port.speech_pos_emb.weight.shape == (512, 64)
    assert port.text_pos_emb.weight.shape == (40, 64)
    assert set(tree["speech_transformer"]) == {"block_0", "block_1", "block_2"}


@pytest.mark.parametrize("masks", [False, True])
def test_clvp_plain_similarity_matches_jax(clvp_plain, masks):
    """Per-pair similarity, with and without token-dropout masks."""
    jm, tree, port = clvp_plain
    rng = np.random.default_rng(4)
    text = rng.integers(0, 256, (3, 14))
    speech = rng.integers(0, 512, (3, 28))
    tm = rng.random((3, 14)) > 0.2 if masks else None
    sm = rng.random((3, 28)) > 0.2 if masks else None
    j = lambda m: None if m is None else jnp.asarray(m)
    p = lambda m: None if m is None else _t(m, torch.bool)
    want = jm.apply({"params": tree}, jnp.asarray(text), jnp.asarray(speech),
                    text_mask=j(tm), voice_mask=j(sm))
    with torch.no_grad():
        got = port(_t(text, torch.long), _t(speech, torch.long), text_mask=p(tm),
                   voice_mask=p(sm))
    assert _rel(got, want) <= TOL


def test_clvp_plain_loss_and_gradient_match_jax(clvp_plain):
    """The contrastive loss and its gradient w.r.t. the position tables
    (which only this variant has), against jax.grad: 1e-5 of the largest."""
    jm, tree, port = clvp_plain
    rng = np.random.default_rng(5)
    text = rng.integers(0, 256, (4, 10))
    speech = rng.integers(0, 512, (4, 20))
    loss_fn = lambda t: jm.apply({"params": t}, jnp.asarray(text), jnp.asarray(speech),
                                 return_loss=True)
    want, grads = jax.value_and_grad(loss_fn)(tree)
    port.zero_grad()
    got = port(_t(text, torch.long), _t(speech, torch.long), return_loss=True)
    got.backward()
    assert abs(got.item() - float(want)) <= TOL * abs(float(want))
    for name in ("text_pos_emb", "speech_pos_emb"):
        assert _rel(getattr(port, name).weight.grad, grads[name]["embedding"]) <= TOL


def test_clvp_plain_scores_candidates(clvp_plain):
    from tortoise_tpu.models.clvp import CLVP

    jm, tree, port = clvp_plain
    rng = np.random.default_rng(6)
    text = rng.integers(0, 256, (1, 12))
    cands = rng.integers(0, 512, (3, 20))
    want = jm.apply({"params": tree}, jnp.asarray(text), jnp.asarray(cands),
                    method=CLVP.score_candidates)
    with torch.no_grad():
        got = port.score_candidates(_t(text, torch.long), _t(cands, torch.long))
    assert _rel(got, want) <= TOL


def test_config_for_tree_picks_the_variant(clvp_plain):
    """The API builds the variant a checkpoint holds, with its depths and
    text table's length."""
    from tortoise_tpu_torch.models.clvp import CLVPConfig, config_for_tree

    _, tree, _ = clvp_plain
    cfg = config_for_tree(CLVPConfig(dim_text=64, dim_speech=64, dim_latent=64,
                                     num_speech_tokens=512), tree)
    assert (cfg.use_xformers, cfg.text_enc_depth, cfg.speech_enc_depth, cfg.text_seq_len) == \
        (False, 2, 3, 40)
    assert config_for_tree(cfg, {"text_emb": {}}).use_xformers


# --- stft / istft --------------------------------------------------------------------

@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (64, 16, 48)])
def test_stft_matches_jax(n_fft, hop, win, center):
    """Complex spectra within 1e-5 of the largest |JAX| bin (a window
    shorter than n_fft is centred in zeros)."""
    from tortoise_tpu.ops import mel as jmel
    from tortoise_tpu_torch.ops import mel

    x = np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32)
    want = np.asarray(jmel.stft(jnp.asarray(x), n_fft, hop, win, center=center))
    got = mel.stft(_t(x), n_fft, hop, win, center=center)
    assert got.is_complex() and got.shape == want.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (64, 16, 48)])
def test_istft_matches_jax_and_inverts_stft(n_fft, hop, win):
    """istft of one spectrum against the JAX function, and istft(stft(x))
    against x (the window-sumsquare division undoes the overlap-add):
    within 1e-5 of max|x|."""
    from tortoise_tpu.ops import mel as jmel
    from tortoise_tpu_torch.ops import mel

    x = np.random.default_rng(1).standard_normal((2, 3000)).astype(np.float32)
    spec = np.asarray(jmel.stft(jnp.asarray(x), n_fft, hop, win))
    want = np.asarray(jmel.istft(jnp.asarray(spec), n_fft, hop, win, length=2500))
    got = mel.istft(_t(spec, torch.complex64), n_fft, hop, win, length=2500)
    assert got.shape == want.shape == (2, 2500)
    assert _rel(got, want) <= TOL
    back = mel.istft(mel.stft(_t(x), n_fft, hop, win), n_fft, hop, win)
    assert _rel(back, x[:, :back.shape[-1]]) <= TOL


# --- native crossfade ----------------------------------------------------------------

@pytest.mark.parametrize("n_chunk,n_overlap", [(100, 40), (30, 30), (10, 50), (5, 1)])
def test_crossfade_matches_jax_binding(n_chunk, n_overlap):
    """The port's binding against the JAX package's, bit for bit, and
    against the formula (1e-6: float32 t); the chunk passed in is not
    changed."""
    from tortoise_tpu import native as jax_native
    from tortoise_tpu_torch import native

    rng = np.random.default_rng(n_chunk)
    chunk = rng.standard_normal(n_chunk).astype(np.float32)
    overlap = rng.standard_normal(n_overlap).astype(np.float32)
    keep = chunk.copy()
    got = native.crossfade(chunk, overlap)
    if got is None:
        pytest.fail("the native library did not build: make and a C++ compiler are needed")
    np.testing.assert_array_equal(chunk, keep)
    np.testing.assert_array_equal(got, jax_native.crossfade(chunk, overlap))
    n = min(n_chunk, n_overlap)
    t = np.arange(n, dtype=np.float32) / max(n - 1, 1) if n > 1 else np.zeros(1, np.float32)
    want = chunk.copy()
    want[:n] = overlap[:n] * (1 - t) + chunk[:n] * t
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_crossfade_without_the_library_is_none(monkeypatch):
    from tortoise_tpu_torch import native

    monkeypatch.setattr(native, "_load", lambda: False)
    assert native.crossfade(np.ones(4, np.float32), np.zeros(4, np.float32)) is None
