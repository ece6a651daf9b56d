"""K1 (per-layer decode attention over the merged KV cache) and K4 (UnivNet's
location-variable convolution): their plain versions against the JAX
package's Pallas kernels in interpret mode and its XLA twins, and the
modules that call them (UnivNet with use_kernel, the GPT-2 stack's decode)
against the JAX modules. Same numpy inputs on both sides, float32 unless a
case says otherwise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.ops.attn import K1_MAX_SPLITS, decode_attention_merged, k1_plan
from tortoise_tpu_torch.ops.lvc import location_variable_convolution_lvc

torch.set_num_threads(2)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a, np.float32)).to(dtype)


# --- K4 --------------------------------------------------------------------------

@pytest.mark.parametrize("hop", [8, 64])
def test_lvc_plain_matches_pallas_interpret(hop):
    """The CPU dispatch of K4 (its plain version) against the Pallas kernel
    run in interpret mode, as tests/test_vocoder_parity.py runs it; the
    kernels and bias are slices [:, l] of the predictor's (B, L, F, ...)
    layout, as UnivNet hands them over."""
    from tortoise_tpu.ops.lvc_pallas import location_variable_convolution_pallas

    rng = np.random.default_rng(hop)
    b, f, ci, co, k = 2, 5, 8, 16, 3
    x = rng.standard_normal((b, f * hop, ci)).astype(np.float32)
    kern = rng.standard_normal((b, 4, f, ci, co, k)).astype(np.float32)
    bias = rng.standard_normal((b, 4, f, co)).astype(np.float32)
    want = location_variable_convolution_pallas(jnp.asarray(x), jnp.asarray(kern[:, 2]),
                                                jnp.asarray(bias[:, 2]), hop, interpret=True)
    got = location_variable_convolution_lvc(_t(x), _t(kern)[:, 2], _t(bias)[:, 2], hop)
    assert got.shape == (b, f * hop, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_univnet_with_the_kernel_matches_jax():
    """UnivNet at a narrow width with use_kernel=True (K4's plain version on
    the CPU) against the JAX generator with use_pallas=False, the same
    numpy weights through from_jax; the existing vocoder test's tolerance."""
    from tortoise_tpu.models.vocoder import UnivNetConfig as JConfig
    from tortoise_tpu.models.vocoder import UnivNetGenerator as JU
    from tortoise_tpu_torch.models.vocoder import UnivNetConfig, UnivNetGenerator

    kw = dict(noise_dim=16, channel_size=8)
    jm = JU(JConfig(**kw))
    params = jax_weights.host_init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12, 100)),
                                                   jnp.zeros((1, 12, 16))), seed=4)["params"]
    params = jax.tree_util.tree_map(lambda a: a * 0.15, params)  # contractive, as in
    port = UnivNetGenerator(UnivNetConfig(use_kernel=True, **kw))  # test_torch_modules
    port.load_state_dict(from_jax(port, params))
    calls = location_variable_convolution_lvc.launches
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, 6, 100)).astype(np.float32)
    z = rng.standard_normal((1, 16, 16)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(z),
                    method=JU.inference)
    with torch.no_grad():
        got = port.eval().inference(_t(mel), _t(z))
    assert got.shape == (1, 6 * 256, 1)
    assert location_variable_convolution_lvc.launches == calls   # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --- K1 --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layer,pos", [(0, 0), (1, 100), (1, 255)])
def test_decode_attention_merged_plain_matches_jax(dtype, tol, layer, pos):
    """K1's CPU dispatch (its plain version) against the Pallas kernel in
    interpret mode and against its XLA twin, as
    tests/test_flash_attention.py:150 holds them to each other: the cache
    row writes identical, the outputs within the JAX test's own 1e-2 for
    bf16 and 1e-5 for f32."""
    from tortoise_tpu.ops.attn_pallas import decode_attention_merged as jax_k1
    from tortoise_tpu.ops.attn_pallas import decode_attention_merged_xla

    L, B, T, H, DH = 2, 2, 256, 4, 64
    C = H * DH
    rng = np.random.default_rng(pos)
    q, kn, vn = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.standard_normal((L, B, T, C)).astype(np.float32) for _ in range(2))
    j = [jnp.asarray(a, dtype) for a in (q, kn, vn, kc, vc)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    pq, pkn, pvn, pkc, pvc = (_t(a, tdt) for a in (q, kn, vn, kc, vc))
    got = decode_attention_merged(pq, pkn, pvn, pkc, pvc, layer, pos, heads=H)
    assert got.dtype == tdt
    for o, k_, v_ in (jax_k1(*j, layer, pos, heads=H, interpret=True),
                      decode_attention_merged_xla(*j, layer, pos, heads=H)):
        np.testing.assert_array_equal(pkc.float().numpy(), np.asarray(k_, np.float32))
        np.testing.assert_array_equal(pvc.float().numpy(), np.asarray(v_, np.float32))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(o, np.float32),
                                   rtol=tol, atol=tol)


def test_decode_splits_cover_the_prefix():
    """K1's split of the prefix (k1_plan): one split at pos 0 and where
    B x H / G blocks fill the card, the cluster's 8 at B=1 (16 heads), none
    empty, each at least 32 rows."""
    assert k1_plan(1, 16, 0) == (4, 1) and k1_plan(96, 16, 500) == (4, 1)
    assert k1_plan(1, 16, 600) == (4, K1_MAX_SPLITS) and k1_plan(16, 16, 500) == (4, 2)
    for batch, heads in ((1, 1), (1, 16), (16, 16)):
        for pos in (1, 31, 37, 500, 767):
            _, s = k1_plan(batch, heads, pos)
            chunk = -(-pos // s)
            assert (s - 1) * chunk < pos and (s == 1 or chunk >= 32)


# (B, C, pos=500) -> (G, S): four heads a block at both widths; as many
# splits as keep one block an SM of the 132, up to a cluster of 8
K1_PLANS = [(1, 1024, (4, 8)), (8, 1024, (4, 4)), (16, 1024, (4, 2)), (64, 1024, (4, 1)),
            (96, 1024, (4, 1)), (1, 512, (4, 8)), (8, 512, (4, 8)), (16, 512, (4, 4)),
            (64, 512, (4, 1)), (96, 512, (4, 1))]


@pytest.mark.parametrize("b,c,plan", K1_PLANS)
def test_k1_plan_groups_and_cluster_size(b, c, plan):
    """G and the cluster size at the decode's batches and both widths
    (a tp=2 rank's C=512): a split grid within one block an SM, every
    split non-empty and at least 32 rows, one split at pos 0."""
    heads = c // 64
    g, s = k1_plan(b, heads, 500)
    assert (g, s) == plan
    assert heads % g == 0 and 1 <= s <= K1_MAX_SPLITS
    assert s == 1 or b * heads // g * s <= 132
    chunk = -(-500 // s)
    assert (s - 1) * chunk < 500 and (s == 1 or chunk >= 32)
    assert k1_plan(b, heads, 0) == (g, 1)


@pytest.fixture(scope="module")
def stacks():
    from tortoise_tpu.models.gpt2 import GPT2Config as JConfig
    from tortoise_tpu.models.gpt2 import GPT2Stack as JStack
    from tortoise_tpu_torch.models import gpt2 as port_gpt2

    cfg = JConfig(n_layer=2, n_embd=128, n_head=2)
    jm = JStack(cfg, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 3, 128)))["params"])
    port = port_gpt2.GPT2Stack(port_gpt2.GPT2Config(n_layer=2, n_embd=128, n_head=2))
    port.load_state_dict(from_jax(port, params))
    return cfg, jm, params, port.eval()


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_gpt2_decode_through_k1_matches_jax(stacks, cache):
    """The f32 stack over an f32 or bf16 cache: a 7-row prefill, then three
    one-row decode steps, each through K1 (its plain version on the CPU),
    against the JAX stack; hidden states to 1e-4 as the existing stack
    tests hold them, the caches to 1e-4 (f32) or one bf16 step (2^-7
    relative: an f32 difference can cross a rounding boundary)."""
    from tortoise_tpu.models.gpt2 import init_kv_cache as jax_cache
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache

    cfg, jm, params, port = stacks
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[cache]
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((2, 7, 128)).astype(np.float32)
    steps = rng.standard_normal((3, 2, 1, 128)).astype(np.float32)
    jc = jax_cache(cfg, 2, 256, dtype=jdt)
    pc = init_kv_cache(port.config, 2, 256, dtype=tdt)
    jy, jc = jm.apply({"params": params}, jnp.asarray(emb), cache=jc, cache_index=0)
    launches = decode_attention_merged.launches
    with torch.no_grad():
        py, _ = port(_t(emb), cache=pc, cache_index=0)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
        for i in range(3):
            jy, jc = jm.apply({"params": params}, jnp.asarray(steps[i]), cache=jc,
                              cache_index=7 + i)
            py, _ = port(_t(steps[i]), cache=pc, cache_index=7 + i)
            np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    assert decode_attention_merged.launches == launches       # CPU: no kernel launch
    rtol, atol = (1e-4, 1e-4) if cache == "f32" else (2 ** -7, 0)
    for k in ("k", "v"):
        np.testing.assert_allclose(pc[k].float().numpy(), np.asarray(jc[k], np.float32),
                                   rtol=rtol, atol=atol)
    assert not pc["k"][:, :, 10:].any()
