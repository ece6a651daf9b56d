"""DiffusionTts's graph path on the GPU at full width (10 layers, 1024
channels, 16 heads; seeded random weights cast to bf16, as served): a
replayed forward equals the eager one bit for bit, each input signature
captures once, a returned tensor is the caller's, the calls that must stay
eager capture nothing, and a replay counts its K3 launches.

This file imports neither jax nor the JAX package, so it also runs on a
machine with a GPU and no jax (tests/conftest.py imports jax; skip it there):

    python3 -m pytest --noconftest -m gpu tests/test_torch_diffusion_graph_gpu.py

Without a CUDA device the cases skip.
"""
import pytest
import torch

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
from tortoise_tpu_torch.ops.attn import flash_rel_attention

# the quality API's frames for 128 and 192 bucketed latents
BUCKETS = (557, 835)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forward is captured as a CUDA graph")
    with torch.device("cuda"):
        m = DiffusionTts(DiffusionTtsConfig())
    weights_lib.init_random(m, 0)
    return weights_lib.cast_for_inference(m, torch.bfloat16).eval()


def _inputs(model, b: int, t: int, seed: int):
    """A step's inputs: noisy mel, timesteps, aligned embeddings, valid
    lengths (each row its own, some frames padding) and bias vectors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, 100), generator=g, device="cuda")
    ts = torch.randint(0, 4000, (b,), generator=g, device="cuda")
    pre = torch.randn((b, t, 1024), generator=g, device="cuda").to(model.dtype)
    valid = torch.tensor([t - 40 - 61 * i for i in range(b)], device="cuda")
    return x, ts, pre, valid


def _counters():
    return DiffusionTts.graph_captures, DiffusionTts.graph_replays, flash_rel_attention.launches


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
def test_replay_equals_the_eager_forward_bit_for_bit(model, b):
    with torch.inference_mode():
        for t in BUCKETS:
            biases = model.rel_bias_vectors(t)
            captures, replays, _ = _counters()
            for step in range(4):
                x, ts, pre, valid = _inputs(model, b, t, 10 * t + step)
                got = model(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
                want = model._forward_eager(x, ts, pre, valid_len=valid, rel_biases=biases,
                                            flash=True)
                assert torch.equal(got, want), (t, step)
                # padded frames come out as the eager forward leaves them
                assert torch.isfinite(got).all()
            # a new shape captures anew; its later steps replay
            assert _counters()[:2] == (captures + 1, replays + 3)


@pytest.mark.gpu
def test_a_returned_output_is_not_overwritten_by_the_next_call(model):
    t = BUCKETS[0]
    with torch.inference_mode():
        biases = model.rel_bias_vectors(t)
        outs = []
        for step in range(3):
            x, ts, pre, valid = _inputs(model, 2, t, step)
            out = model(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
            outs.append((out, out.clone()))
        for out, kept in outs:
            assert torch.equal(out, kept)
        assert not torch.equal(outs[1][0], outs[2][0])


@pytest.mark.gpu
def test_a_replay_counts_its_13_k3_launches(model):
    t = BUCKETS[1]
    with torch.inference_mode():
        biases = model.rel_bias_vectors(t)
        x, ts, pre, valid = _inputs(model, 2, t, 0)
        model(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
        for _ in range(3):
            captures, replays, launches = _counters()
            model(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
            assert _counters() == (captures, replays + 1, launches + 13)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["grad", "train", "no_rel_biases"])
def test_calls_that_stay_eager_capture_and_replay_nothing(model, case):
    """Under grad, in train mode or without bias vectors the forward runs
    op by op: both graph counters stay, and K3 launches its 13 calls."""
    t = BUCKETS[0]
    x, ts, pre, valid = _inputs(model, 1, t, 1)
    biases = None if case == "no_rel_biases" else model.rel_bias_vectors(t)
    captures, replays, launches = _counters()
    try:
        if case == "train":
            model.train()
        with torch.set_grad_enabled(case == "grad"):
            out = model(x, ts, pre, valid_len=valid, rel_biases=biases, flash=True)
    finally:
        model.eval()
    assert out.shape == (1, t, 200)
    assert _counters() == (captures, replays, launches + 13)
