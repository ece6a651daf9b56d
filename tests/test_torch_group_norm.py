"""The GroupNorm chain of ``ops/group_norm.py`` on the CPU: its plain
version against the module chain it replaced, op for op; the zeros at
padded frames; the dispatch that routes a chain to kernel
``group_norm_act`` only for the serving model's masked chain on the card;
and DiffusionTts's forward, unchanged bit for bit. The kernel itself runs
on a card only: tests/test_torch_kernels_gpu.py."""
import pytest
import torch
import torch.nn.functional as F

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.models import blocks
from tortoise_tpu_torch.models import diffusion_decoder as dd
from tortoise_tpu_torch.models.layers import silu as layers_silu
from tortoise_tpu_torch.ops import group_norm

torch.set_num_threads(2)

DIFF = dict(model_channels=128, num_layers=2, in_latent_channels=128, num_heads=2)
# the four site forms of the diffusion decoder: (film, silu, out_dtype)
FORMS = {"affine": (False, False, None),         # AttentionBlock's norm
         "silu": (False, True, None),            # TimestepResBlock's first
         "film_silu_mask": (True, True, None),   # TimestepResBlock's second
         "f32_out": (False, True, torch.float32)}  # out_norm
VALID = [0, 1, 17, 32]          # ragged rows over T = 32, an empty one and a full one


def _seed_norm(x, mask, weight, bias, groups, eps):
    """``GroupNorm32.forward`` as it was before the kernel."""
    b, t, c = x.shape
    if mask is None:
        y = F.group_norm(x.float().transpose(1, 2), groups, weight, bias, eps)
        return y.transpose(1, 2).to(x.dtype)
    g = groups
    m = mask.float()[:, :, None]
    xg = (x.float() * m).reshape(b, t, g, c // g)
    count = m.sum(dim=1, keepdim=True) * (c // g)
    mean = xg.sum(dim=(1, 3)) / count[:, 0]
    dev = xg - mean[:, None, :, None]
    var = (dev ** 2 * m[..., None]).sum(dim=(1, 3)) / count[:, 0]
    xn = (dev * torch.rsqrt(var[:, None, :, None] + eps)).reshape(b, t, c)
    return ((xn * weight + bias) * m).to(x.dtype)


def _masked(x, mask):
    return x if mask is None else x * mask[:, :, None].to(x.dtype)


def _seed_chain(x, mask, weight, bias, groups, eps, film=None, silu=False, out_dtype=None,
                dtype=None):
    """Each site's chain as the decoder composed it before the kernel:
    out_norm read ``h.float()`` and masked after SiLU; TimestepResBlock's
    second norm took the FiLM of a chunked (B, 1, 2C) projection and masked
    after SiLU; its first applied SiLU alone."""
    if out_dtype == torch.float32:
        x = x.float()
    y = _seed_norm(x, mask, weight, bias, groups, eps)
    if film is not None:
        scale, shift = film[:, None, :].chunk(2, dim=-1)
        y = y * (1 + scale) + shift
    if silu:
        y = layers_silu(y, dtype)
    if film is not None or out_dtype == torch.float32:
        y = _masked(y, mask)
    return y


def _inputs(dtype, c=128, groups=32, t=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = len(VALID)
    x = (torch.randn((b, t, c), generator=g) * 2 + 0.5).to(dtype)
    mask = torch.arange(t)[None, :] < torch.tensor(VALID)[:, None]
    weight = 1 + 0.3 * torch.randn((c,), generator=g)
    bias = 0.2 * torch.randn((c,), generator=g)
    film = (0.5 * torch.randn((b, 2 * c), generator=g)).to(dtype)
    return x, mask, weight, bias, groups, film


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_equals_the_module_chain_it_replaced(form, dtype):
    """Bit for bit on every row with a valid frame; the empty row, which
    the old chain divided by a zero count (NaN), now comes out zero."""
    use_film, silu, out_dtype = FORMS[form]
    x, mask, weight, bias, groups, film = _inputs(dtype)
    film = film if use_film else None
    got = group_norm.group_norm_act_plain(x, mask, weight, bias, groups, 1e-5, film, silu,
                                          out_dtype)
    want = _seed_chain(x, mask, weight, bias, groups, 1e-5, film, silu, out_dtype)
    assert got.dtype == want.dtype == (out_dtype or dtype)
    for row, n in enumerate(VALID):
        if n:
            assert torch.equal(got[row], want[row]), (form, row)
        else:
            assert torch.isnan(want[row]).all() and torch.equal(got[row], torch.zeros_like(got[row]))


@pytest.mark.parametrize("form", FORMS)
def test_plain_without_a_mask_equals_the_module_chain(form):
    use_film, silu, out_dtype = FORMS[form]
    x, _, weight, bias, groups, film = _inputs(torch.bfloat16)
    film = film if use_film else None
    got = group_norm.group_norm_act_plain(x, None, weight, bias, groups, 1e-5, film, silu,
                                          out_dtype)
    assert torch.equal(got, _seed_chain(x, None, weight, bias, groups, 1e-5, film, silu,
                                        out_dtype))


@pytest.mark.parametrize("form", FORMS)
def test_padded_frames_come_out_exactly_zero(form):
    use_film, silu, out_dtype = FORMS[form]
    x, mask, weight, bias, groups, film = _inputs(torch.bfloat16, seed=3)
    # padding that is not zero must not reach the statistics or the output
    x = torch.where(mask[:, :, None], x, torch.full_like(x, 7.0))
    got = group_norm.group_norm_act_plain(x, mask, weight, bias, groups, 1e-5,
                                          film if use_film else None, silu, out_dtype)
    assert (got[~mask] == 0).all()
    assert (got[mask] != 0).any()
    # the statistics of a row cover its valid frames only: a row cut to them agrees
    n = VALID[2]
    alone = group_norm.group_norm_act_plain(x[2:3, :n], None, weight, bias, groups, 1e-5,
                                            film[2:3] if use_film else None, silu, out_dtype)
    assert torch.allclose(got[2, :n].float(), alone[0].float(), atol=0.02)


def _pretend_cuda(monkeypatch):
    """Every tensor reads as a CUDA one and the wrapper records its calls
    (and computes the plain chain), so the dispatch can be held here."""
    calls = []

    def wrapper(x, mask, weight, bias, groups, eps, film=None, silu=False, out_dtype=None):
        calls.append((tuple(x.shape), film is not None, silu, out_dtype))
        return group_norm.group_norm_act_plain(x, mask, weight, bias, groups, eps, film, silu,
                                               out_dtype)

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(group_norm, "group_norm_act", wrapper)
    return calls


# (case, module compute dtype, x dtype, channels, with a mask, grad wanted, film) ->
# whether the chain goes to the kernel
DISPATCH = [("serving", None, torch.bfloat16, 1024, True, False, True, True),
            ("serving, no film", None, torch.bfloat16, 1024, True, False, False, True),
            ("no mask", None, torch.bfloat16, 1024, False, False, True, False),
            ("under grad", None, torch.bfloat16, 1024, True, True, True, False),
            ("explicit compute dtype", torch.bfloat16, torch.bfloat16, 1024, True, False,
             True, False),
            ("float32 x", None, torch.float32, 1024, True, False, False, False),
            ("groups of 4 channels", None, torch.bfloat16, 128, True, False, True, False)]


@pytest.mark.parametrize("case,dtype,x_dtype,c,masked,grad,use_film,routed", DISPATCH,
                         ids=[d[0] for d in DISPATCH])
def test_dispatch_routes_only_the_serving_masked_chain(monkeypatch, case, dtype, x_dtype, c,
                                                       masked, grad, use_film, routed):
    norm = blocks.GroupNorm32(c, dtype=dtype)
    x, mask, _, _, _, film = _inputs(x_dtype, c=c, groups=norm.groups, t=8)
    want = norm(x, mask if masked else None, film=film if use_film else None, silu=True)
    calls = _pretend_cuda(monkeypatch)
    x.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = norm(x, mask if masked else None, film=film if use_film else None, silu=True)
    assert len(calls) == int(routed), case
    assert torch.equal(got.detach(), want)


def test_dispatch_keeps_the_plain_ops_on_the_cpu():
    norm = blocks.GroupNorm32(1024)
    x, mask, _, _, _, film = _inputs(torch.bfloat16, c=1024, t=8)
    before = group_norm.group_norm_act.launches
    with torch.inference_mode():
        norm(x, mask, film=film, silu=True)
    assert not group_norm.engages(x, mask, *norm.GroupNorm_0.params(), norm.groups, film)
    assert group_norm.group_norm_act.launches == before


def test_engages_refuses_what_the_kernel_cannot_take(monkeypatch):
    """Too many frames, a film of another batch or dtype, a strided x."""
    x, mask, weight, bias, groups, film = _inputs(torch.bfloat16, c=1024, t=8)
    _pretend_cuda(monkeypatch)
    with torch.no_grad():
        assert group_norm.engages(x, mask, weight, bias, groups, film)
        long_x = torch.zeros((1, group_norm.MAX_FRAMES + 1, 1024), dtype=torch.bfloat16)
        assert not group_norm.engages(long_x, mask, weight, bias, groups)
        assert not group_norm.engages(x, mask, weight, bias, groups, film[:1])
        assert not group_norm.engages(x, mask, weight, bias, groups, film.float())
        assert not group_norm.engages(x.transpose(0, 1), mask, weight, bias, groups)


def _seed_group_norm_forward(self, x, mask=None, l=None, film=None, silu=False,
                             out_dtype=None):
    scale, bias = self.GroupNorm_0.params(l)
    return _seed_chain(x, mask, scale, bias, self.groups, self.eps, film, silu, out_dtype,
                       self.dtype)


def _tiny_diffusion(dtype, compute_dtype):
    with torch.device("cpu"):
        model = dd.DiffusionTts(dd.DiffusionTtsConfig(**DIFF), dtype=compute_dtype)
    weights_lib.init_random(model, 0)
    if dtype != torch.float32:
        weights_lib.cast_for_inference(model, dtype)
    return model.eval()


@pytest.mark.parametrize("valid", [True, False], ids=["valid_len", "unmasked"])
@pytest.mark.parametrize("weights,compute", [(torch.bfloat16, None), (torch.float32, None),
                                             (torch.float32, torch.bfloat16)],
                         ids=["serving_bf16", "f32", "compute_bf16"])
def test_diffusion_forward_is_unchanged_bit_for_bit(monkeypatch, weights, compute, valid):
    """The served forward (precomputed conditioning, bias vectors) and the
    bucketed conditioning path, against the same model with every norm
    chain computed as the decoder composed it before the kernel."""
    model = _tiny_diffusion(weights, compute)
    b, t = 2, 24
    g = torch.Generator().manual_seed(1)
    x = torch.randn((b, t, 100), generator=g)
    ts = torch.tensor([1200, 37])
    valid_len = torch.tensor([t, t - 7]) if valid else None
    pre = torch.randn((b, t, DIFF["model_channels"]), generator=g).to(model.dtype)
    latents = torch.randn((b, 10, DIFF["in_latent_channels"]), generator=g).to(model.dtype)
    cond = torch.randn((b, 2 * DIFF["model_channels"]), generator=g).to(model.dtype)

    def run():
        with torch.inference_mode():
            out = model(x, ts, pre, valid_len=valid_len, rel_biases=model.rel_bias_vectors(t))
            free = model(x, ts, pre, conditioning_free=True, valid_len=valid_len)
            emb = model.timestep_independent_bucketed(latents, torch.tensor([10, 6]), cond,
                                                      torch.tensor([t, t - 7]), t)
            codes = model.timestep_independent(latents, cond, t)
        return out, free, emb, codes

    got = run()
    monkeypatch.setattr(blocks.GroupNorm32, "forward", _seed_group_norm_forward)
    want = run()
    for a, w in zip(got, want):
        assert torch.equal(a, w)
