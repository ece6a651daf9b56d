"""DiffusionTts's graph path on the CPU: the frequency table that
``timestep_embedding`` keeps on the device equals the one it built from
numpy at every call, and a CPU sampling loop, whose calls are those of the
quality API's, runs every forward eagerly. The graph path itself runs on a
card only: tests/test_torch_graphs_gpu.py."""
import numpy as np
import pytest
import torch

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.diffusion.sampler import SamplerConfig, p_sample_loop
from tortoise_tpu_torch.diffusion.schedule import spaced_schedule
from tortoise_tpu_torch.models import diffusion_decoder as dd
from tortoise_tpu_torch.ops.attn import flash_rel_attention

torch.set_num_threads(2)

DIFF = dict(model_channels=128, num_layers=2, in_latent_channels=128, num_heads=2)


def _numpy_embedding(timesteps, dim, max_period=10000):
    """The embedding as built before the table was kept: the table from
    numpy at every call."""
    half = dim // 2
    freqs = torch.as_tensor(
        np.exp(-np.log(max_period) * np.arange(half, dtype=np.float64) / half)
        .astype(np.float32), device=timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([args.cos(), args.sin()], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


@pytest.mark.parametrize("dim", [7, 8, 129, 1024])
def test_kept_frequency_table_gives_the_numpy_embedding(dim):
    ts = torch.tensor([0, 1, 7, 1200, 3999, 4000])
    for _ in range(2):
        assert torch.equal(dd.timestep_embedding(ts, dim), _numpy_embedding(ts, dim))
    with torch.inference_mode():
        assert torch.equal(dd.timestep_embedding(ts, dim, 500), _numpy_embedding(ts, dim, 500))
    assert dd._frequencies(dim // 2, 10000, ts.device) is \
        dd._frequencies(dim // 2, 10000, ts.device)


def test_cpu_sampling_loop_runs_every_forward_eagerly():
    """A guided sampling loop as ``TextToSpeech.do_spectrogram_diffusion``
    runs it (eval mode, inference mode, precomputed conditioning, bias
    vectors, valid lengths): on the CPU no graph is captured or replayed,
    and each step is one forward."""
    with torch.device("cpu"):
        model = dd.DiffusionTts(dd.DiffusionTtsConfig(**DIFF))
    weights_lib.init_random(model, 0)
    model.eval()
    b, t = 1, 24
    gen = torch.Generator().manual_seed(0)
    before = (model.graphs.captures, model.graphs.replays, flash_rel_attention.launches)
    calls = []
    with torch.inference_mode():
        pre = torch.randn((2 * b, t, DIFF["model_channels"]), generator=gen)
        biases = model.rel_bias_vectors(t)
        out_len = torch.tensor([t - 5])

        def model_fn(x, ts):
            calls.append(ts[0].item())
            return model(x, ts, pre, valid_len=out_len.repeat(x.shape[0] // b),
                          rel_biases=biases, flash=False)

        mel = p_sample_loop(model_fn, spaced_schedule("linear", 4000, 4),
                            torch.randn((b, t, 100), generator=gen), gen, SamplerConfig())
    assert mel.shape == (b, t, 100) and torch.isfinite(mel).all()
    assert len(calls) == 4 and len(set(calls)) == 4
    assert not model.graphs._graphs
    assert (model.graphs.captures, model.graphs.replays, flash_rel_attention.launches) == before
