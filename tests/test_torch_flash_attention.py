"""K3 (ops/attn.py) against the JAX Pallas flash attention (interpret mode)
and the port's AttentionBlock against the JAX block."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu.models.blocks import AttentionBlock as JaxAttentionBlock
from tortoise_tpu.ops.attn_pallas import flash_rel_attention as jax_flash
from tortoise_tpu.ops.attn_pallas import rel_bias_blocks
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models.blocks import AttentionBlock
from tortoise_tpu_torch.ops.attn import (flash_rel_attention, flash_rel_attention_plain,
                                         rel_bias_vector)

torch.set_num_threads(2)


@pytest.mark.parametrize("t,lens", [(160, (150, 97)), (300, (300, 1))])
def test_plain_matches_jax_kernel(t, lens):
    b, h, d = 2, 2, 64
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    table = (rng.standard_normal((32, h)) * 0.1).astype(np.float32)
    scale = 8.0
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                rel_bias_blocks(table, t, scale, dtype=jnp.float32),
                                jnp.asarray(lens, jnp.int32), interpret=True))
    vec = rel_bias_vector(torch.from_numpy(table), t, scale)
    got = flash_rel_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              vec, torch.tensor(lens, dtype=torch.int32)).numpy()
    for i, n in enumerate(lens):
        # tolerance of tests/test_flash_attention.py (f32)
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=2e-5, atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 2, 40, 64)).astype(np.float32))
    vec = torch.from_numpy(rng.standard_normal((2, 79)).astype(np.float32))
    lens = torch.tensor([33], dtype=torch.int32)
    before = flash_rel_attention.launches
    assert torch.equal(flash_rel_attention(q, q, q, vec, lens),
                       flash_rel_attention_plain(q, q, q, vec, lens))
    assert flash_rel_attention.launches == before


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "einsum"])
def test_attention_block_matches_jax_flash_block(flash):
    """Same params and inputs: the port block (K3's plain version, or the
    einsum path) against the JAX block on its Pallas flash path."""
    c, h, t, b = 128, 2, 90, 2
    block = JaxAttentionBlock(c, h, relative_pos_embeddings=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # make the (zero-initialized) output projection and the bias table count
    params["proj_out"]["kernel"] = rng.standard_normal((c, c)).astype(np.float32) * 0.1
    params["rel_pos"]["embedding"] = rng.standard_normal((32, h)).astype(np.float32) * 0.5
    valid = np.zeros((b, t), bool)
    valid[0, :t] = True
    valid[1, :61] = True
    scale = (c // h) ** 0.5
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x),
                                  valid_mask=jnp.asarray(valid),
                                  precomputed_bias=rel_bias_blocks(
                                      params["rel_pos"]["embedding"], t, scale,
                                      dtype=jnp.float32)))

    port = AttentionBlock(c, h, relative_pos_embeddings=True)
    port.load_state_dict(from_jax(port, params))
    with torch.no_grad():
        vec = rel_bias_vector(port.rel_pos.weight, t, scale)
        got = port(torch.from_numpy(x), valid_mask=torch.from_numpy(valid), rel_bias=vec,
                   flash=flash).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.all(got[1, 61:] == 0)

