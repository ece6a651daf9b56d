"""The port's CUDA-graph helper (``tortoise_tpu_torch/utils/graphs.py``) on
the CPU, over both callers (DiffusionTts's forward, the hybrid prior's
decode step): a CPU call that would take a graph on the card runs eagerly
and captures nothing; a model holding the helper pickles; ``clear`` drops
the graphs and their pool; and ``Module._apply`` (``.to()``, ``.float()``)
and ``weights.cast_for_inference`` clear a model's graphs (the hybrid's
decode caches with them), the cast keeping every parameter the same
object, cast by the name rule. The graphs themselves run on a card only:
tests/test_torch_graphs_gpu.py."""
import io

import pytest
import torch

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
from tortoise_tpu_torch.models.granite_hybrid import GraniteVoice, GraniteVoiceConfig
from tortoise_tpu_torch.utils.graphs import Graphs

torch.set_num_threads(2)

DIFF = dict(model_channels=128, num_layers=2, in_latent_channels=128, num_heads=2)
AR = dict(layers=4, model_dim=64, attention_layers=[2], num_attention_heads=2,
          num_key_value_heads=1, mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16,
          mamba_chunk_size=4, shared_intermediate_size=96, conditioning_heads=2,
          max_text_tokens=40, max_mel_tokens=40)


def _build(name: str):
    model = DiffusionTts(DiffusionTtsConfig(**DIFF)) if name == "diffusion" \
        else GraniteVoice(GraniteVoiceConfig(**AR))
    weights_lib.init_random(model, 0)
    return model.eval()


def _graph_call(name: str, model, gen: torch.Generator):
    """The call that takes a graph on the card, and the eager call on the
    same inputs (and, for the hybrid, a copy of its cache)."""
    if name == "diffusion":
        t = 24
        x = torch.randn((2, t, 100), generator=gen)
        ts = torch.tensor([10, 3000])
        pre = torch.randn((2, t, DIFF["model_channels"]), generator=gen)
        kw = dict(valid_len=torch.tensor([t, t - 5]), rel_biases=model.rel_bias_vectors(t))
        return x, model(x, ts, pre, **kw), model._forward_eager(x, ts, pre, **kw)
    cache = model.decode_cache(2, "cpu")
    model.prefill(torch.randn((1, 5, AR["model_dim"]), generator=gen) * 0.1, cache)
    eager_cache = {k: v.clone() for k, v in cache.items()}
    x = torch.randn((2, AR["model_dim"]), generator=gen) * 0.1
    return x, model.decode_step(x, cache), model._decode_layers(x, eager_cache)


@pytest.mark.parametrize("name", ["diffusion", "granite"])
def test_a_cpu_call_runs_eagerly_and_captures_nothing(name):
    model = _build(name)
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for _ in range(3):
            x, got, want = _graph_call(name, model, gen)
            assert torch.equal(got, want)
            assert not Graphs.eligible(model, x)
    assert (model.graphs.captures, model.graphs.replays) == (0, 0)
    assert not model.graphs._graphs and model.graphs._pool is None


@pytest.mark.parametrize("name", ["diffusion", "granite"])
def test_a_model_holding_the_helper_pickles(name):
    """``torch.save(model)`` pickles the whole module, its helper too."""
    model = _build(name)
    buf = io.BytesIO()
    torch.save(model, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=False)
    assert loaded.graphs.span == model.graphs.span and loaded.graphs.captures == 0


def test_clear_drops_the_graphs_and_their_pool():
    graphs = Graphs("test.capture", ("rows",))
    graphs._graphs[("key", True)] = object()
    graphs._pool = object()
    graphs.clear()
    assert not graphs._graphs and graphs._pool is None


@pytest.mark.parametrize("how", ["float", "to", "cast"])
@pytest.mark.parametrize("name", ["diffusion", "granite"])
def test_moving_the_parameters_clears_the_graphs(name, how):
    """A graph reads the parameters where they lay at its capture: whatever
    moves them goes through ``Module._apply``, which drops the graphs."""
    model = _build(name)
    if name == "granite":
        model.decode_cache(2, "cpu")
    model.graphs._graphs[("stale", True)] = object()
    model.graphs._pool = object()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    params = dict(model.named_parameters())
    if how == "cast":
        weights_lib.cast_for_inference(model, torch.bfloat16)
    elif how == "to":
        model.to("cpu")
    else:
        model.float()
    assert not model.graphs._graphs and model.graphs._pool is None
    assert name == "diffusion" or not model._caches
    for n, p in model.named_parameters():
        assert p is params[n], n
        if how != "cast":
            continue
        keep = any(k in n for k in weights_lib._KEEP_F32)
        assert p.dtype == (torch.float32 if keep else torch.bfloat16), n
        assert torch.equal(p, before[n].to(p.dtype)), n
