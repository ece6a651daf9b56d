"""The port's classifier blocks (ResBlock, Downsample, Upsample,
AudioMiniEncoder), the Tortoise-detect classifier and CVVP against the JAX
package's on the CPU: the same numpy inputs, every JAX parameter random
(no zero-initialised output convs) and carried by convert/from_jax.py,
float32 throughout."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)
RTOL = ATOL = 1e-4  # f32 against f32
# the classifier at base 8 and depth 2; CVVP 64 wide, depth 2 on each side
CLS = dict(embedding_dim=32, base_channels=8, depth=2, attn_blocks=2, num_attn_heads=4)
CVVP_KW = dict(model_dim=64, transformer_heads=4, conditioning_enc_depth=2, speech_enc_depth=2)


def _params(init_fn, seed):
    return jax_weights.host_init(init_fn, seed=seed)["params"]


def _load(port, params):
    port.load_state_dict(from_jax(port, params))
    return port.eval()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("out_ch,kernel,conv_skip", [
    (16, 3, False), (16, 5, False),       # identity skip
    (32, 3, True), (32, 5, True),         # k-conv skip
    (32, 3, False), (32, 5, False),       # 1x1 skip
])
def test_resblock(out_ch, kernel, conv_skip):
    from tortoise_tpu.models.blocks import ResBlock as J
    from tortoise_tpu_torch.models.blocks import ResBlock as P

    jm = J(16, out_channels=out_ch, kernel_size=kernel, use_conv_skip=conv_skip)
    x = _x(0, 2, 40, 16)
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = _load(P(16, out_channels=out_ch, kernel_size=kernel, use_conv_skip=conv_skip), params)
    assert (port.skip_conv is None) == (out_ch == 16)
    _close(port(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("block", ["Downsample", "Upsample"])
def test_downsample_and_upsample(block):
    from tortoise_tpu.models import blocks as jb
    from tortoise_tpu_torch.models import blocks as pb

    jm = getattr(jb, block)(16, out_channels=24, factor=4)
    x = _x(1, 2, 37, 16)
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    port = _load(getattr(pb, block)(16, out_channels=24, factor=4), params)
    got = port(torch.from_numpy(x))
    assert got.shape == ((2, 10, 24) if block == "Downsample" else (2, 148, 24))
    _close(got, jm.apply({"params": params}, jnp.asarray(x)))


def test_audio_mini_encoder():
    from tortoise_tpu.models.blocks import AudioMiniEncoder as J
    from tortoise_tpu_torch.models.blocks import AudioMiniEncoder as P

    kw = dict(spec_dim=1, embedding_dim=32, base_channels=8, depth=2, resnet_blocks=2,
              attn_blocks=2, num_attn_heads=4, downsample_factor=4, kernel_size=5)
    jm = J(**kw)
    x = _x(2, 2, 512, 1)
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    port = _load(P(**kw), params)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 32)
    _close(got, jm.apply({"params": params}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def classifier():
    from tortoise_tpu.models.classifier import AudioMiniEncoderWithClassifierHead as J
    from tortoise_tpu.models.classifier import ClassifierConfig as JC
    from tortoise_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead as P
    from tortoise_tpu_torch.models.classifier import ClassifierConfig as PC

    jm = J(JC(**CLS))
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1))), 4)
    return jm, params, _load(P(PC(**CLS)), params)


def test_classifier_logits(classifier):
    jm, params, port = classifier
    x = _x(3, 2, 3000, 1)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 2)
    _close(got, jm.apply({"params": params}, jnp.asarray(x)))


def test_classify_audio_clip(classifier, monkeypatch):
    """The model-level function on a (T,) and a (1, T) clip, and the api's
    module-level one (its weights loaded by seed when there is no
    checkpoint) against the JAX function on the same weights."""
    from tortoise_tpu.models.classifier import classify_audio_clip as jax_classify
    from tortoise_tpu_torch import api as papi
    from tortoise_tpu_torch.models.classifier import ClassifierConfig as PC
    from tortoise_tpu_torch.models.classifier import classify_audio_clip

    jm, params, port = classifier
    clip = 0.5 * _x(4, 2400)
    want = jax_classify(clip, {"params": params}, jm.config)
    for c in (clip, clip[None], torch.from_numpy(clip)):
        got = classify_audio_clip(c, port)
        assert isinstance(got, float) and 0.0 <= got <= 1.0
        assert abs(got - want) < 1e-5
    monkeypatch.setattr(papi, "ClassifierConfig", lambda: PC(**CLS))
    with pytest.warns(UserWarning, match="classifier"):
        prob = papi.classify_audio_clip(clip, device="cpu")
    with pytest.warns(UserWarning, match="classifier"):
        assert papi.classify_audio_clip(clip, device="cpu") == prob
    assert 0.0 <= prob <= 1.0


def test_classify_audio_clip_runs_in_float32(classifier, monkeypatch):
    """The api's classify_audio_clip resolves its device through
    weights.float32_device, so the classifier CLI on the card runs with TF32
    off even when no TextToSpeech was built in the process (here the CUDA
    device is swapped for the CPU)."""
    from tortoise_tpu_torch import api as papi
    from tortoise_tpu_torch.models.classifier import ClassifierConfig as PC

    asked = []

    def float32_device(device):
        asked.append(torch.device(device))
        return torch.device("cpu")

    monkeypatch.setattr(papi, "ClassifierConfig", lambda: PC(**CLS))
    clip = 0.5 * _x(4, 2400)
    with pytest.warns(UserWarning, match="classifier"):
        want = papi.classify_audio_clip(clip, device="cpu")
    monkeypatch.setattr(papi.weights_lib, "float32_device", float32_device)
    with pytest.warns(UserWarning, match="classifier"):
        assert papi.classify_audio_clip(clip, device="cuda") == want
    assert asked == [torch.device("cuda")]


@pytest.fixture(scope="module")
def cvvp():
    from tortoise_tpu.models.cvvp import CVVP as J
    from tortoise_tpu.models.cvvp import CVVPConfig as JC
    from tortoise_tpu_torch.models.cvvp import CVVP as P
    from tortoise_tpu_torch.models.cvvp import CVVPConfig as PC

    jm = J(JC(**CVVP_KW))
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                                     jnp.zeros((1, 8), jnp.int32)), 5)
    return jm, params, _load(P(PC(**CVVP_KW)), params)


def test_cvvp_similarity_and_latents(cvvp):
    from tortoise_tpu.models.cvvp import CVVP as J

    jm, params, port = cvvp
    v = {"params": params}
    mel = _x(5, 3, 60, 80)
    codes = np.random.default_rng(6).integers(0, 8192, (3, 40))
    got = port(torch.from_numpy(mel), torch.from_numpy(codes))
    assert got.shape == (3,) and got.dtype == torch.float32
    _close(got, jm.apply(v, jnp.asarray(mel), jnp.asarray(codes)))
    _close(port.cond_latents(torch.from_numpy(mel)),
           jm.apply(v, jnp.asarray(mel), method=J.cond_latents))
    _close(port.speech_latents(torch.from_numpy(codes)),
           jm.apply(v, jnp.asarray(codes), method=J.speech_latents))


def test_cvvp_score_candidates(cvvp):
    """One clip against B candidates equals the forward with the clip
    repeated B times (the JAX package's np.repeat); a candidate holding a
    code outside the vocabulary scores -inf."""
    jm, params, port = cvvp
    mel = _x(7, 1, 60, 80)
    codes = np.random.default_rng(8).integers(0, 8192, (4, 30))
    want = jm.apply({"params": params}, jnp.asarray(np.repeat(mel, 4, axis=0)),
                    jnp.asarray(codes))
    _close(port.score_candidates(torch.from_numpy(mel), torch.from_numpy(codes)), want)
    codes[2, 5] = 8192
    got = port.score_candidates(torch.from_numpy(mel), torch.from_numpy(codes)).detach()
    assert got[2] == -float("inf") and torch.isfinite(got[[0, 1, 3]]).all()
