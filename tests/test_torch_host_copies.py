"""The host modules the port keeps its own copies of (it imports nothing of
the JAX package) against the JAX package's modules of the same name: text
cleaners, sentence splitting, presets, diffusion schedules, the checkpoint
converters and the resampler. Equal outputs, exactly."""
import os

import numpy as np
import pytest
import torch

from test_torch_weights import CLS, LAYERS, REFERENCE
from tortoise_tpu.convert import torch_import as jax_ti
from tortoise_tpu.diffusion import schedule as jax_schedule
from tortoise_tpu.utils import audio as jax_audio
from tortoise_tpu.utils import cleaners as jax_cleaners
from tortoise_tpu.utils import text as jax_text
from tortoise_tpu_torch import native
from tortoise_tpu_torch import presets as port_presets
from tortoise_tpu_torch.convert import torch_import as port_ti
from tortoise_tpu_torch.diffusion import schedule as port_schedule
from tortoise_tpu_torch.utils import audio as port_audio
from tortoise_tpu_torch.utils import cleaners as port_cleaners
from tortoise_tpu_torch.utils import text as port_text

torch.set_num_threads(2)

CORPUS = [
    "Mr. Smith paid $3.50 for 2 apples on the 21st of March, 1999.",
    "Dr. Jekyll & Mrs. Hyde: 1,234,567 people, £12 and $0.99 each!",
    "Ünïcödé text — with “curly quotes”, naïve café façade, and ½ a cake.",
    "The 3rd, 11th, 22nd and 101st entries; Lt. Gen. Smith vs. Capt. Jones.",
    "  Whitespace\t\tand\nnewlines   collapse,   UPPER case lowers.  ",
    "Numbers: 0, 7, 13, 20, 99, 100, 1000, 2024, 10000, 1000000 and 3.14159.",
    "",
]


@pytest.mark.parametrize("text", CORPUS)
@pytest.mark.parametrize("cleaner", ["english_cleaners", "basic_cleaners",
                                     "transliteration_cleaners"])
def test_cleaners_match_jax(cleaner, text):
    assert getattr(port_cleaners, cleaner)(text) == getattr(jax_cleaners, cleaner)(text)


@pytest.mark.parametrize("args", [(), (40, 80), (20, 30)])
def test_split_and_recombine_text_matches_jax(args):
    text = " ".join(CORPUS[:5]) + ' He said "Stop. Now!" and left... Then? Yes!\n\nNew para.'
    assert port_text.split_and_recombine_text(text, *args) == \
        jax_text.split_and_recombine_text(text, *args)


def test_presets_match_jax():
    from tortoise_tpu import presets as jax_presets

    for name in ("COMMON_SETTINGS", "QUALITY_PRESETS", "FAST_PRESETS"):
        assert getattr(port_presets, name) == getattr(jax_presets, name)
    for preset in port_presets.QUALITY_PRESETS:
        assert port_presets.resolve_preset(preset, port_presets.QUALITY_PRESETS, top_p=0.5) == \
            jax_presets.resolve_preset(preset, jax_presets.QUALITY_PRESETS, top_p=0.5)


@pytest.mark.parametrize("steps", [2, 30, 80, 200, "ddim25", "10,20"])
@pytest.mark.parametrize("name", ["linear", "cosine"])
def test_spaced_schedule_matches_jax(name, steps):
    got = port_schedule.spaced_schedule(name, 4000, steps)
    want = jax_schedule.spaced_schedule(name, 4000, steps)
    assert got.original_num_steps == want.original_num_steps
    for field in ("betas", "timestep_map", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
                  "sqrt_recipm1_alphas_cumprod", "posterior_log_variance_clipped",
                  "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


PORT_CONVERTERS = {
    "autoregressive": lambda s: port_ti.unified_voice_params(s, layers=LAYERS),
    "diffusion_decoder": lambda s: port_ti.diffusion_tts_params(s, num_layers=LAYERS),
    "clvp": port_ti.clvp_params, "clvp_plain": port_ti.clvp_params,
    "vocoder": port_ti.univnet_params,
    "hifidecoder": port_ti.hifigan_params, "rlg_auto": port_ti.rlg_params,
    "rlg_diffuser": port_ti.rlg_params,
    "cvvp": lambda s: port_ti.cvvp_params(s, cond_depth=LAYERS, speech_depth=LAYERS),
    "classifier": lambda s: port_ti.classifier_params(s, depth=CLS["depth"],
                                                      attn_blocks=CLS["attn_blocks"]),
    "wav2vec2": lambda s: port_ti.wav2vec2_params(s, num_layers=LAYERS, num_convs=2),
}


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_torch_import_converters_match_jax(name):
    """A synthetic reference state dict (tests/test_torch_weights.py's
    layouts) through the port's converters and the JAX package's: the same
    tree, leaf for leaf, the per-layer stacks included."""
    torch.manual_seed(0)
    sd, jax_convert = REFERENCE[name]()
    _assert_trees_equal(PORT_CONVERTERS[name](sd), jax_convert(sd))


def test_stack_layers_is_a_tree_map_of_np_stack():
    import jax

    trees = [{"a": {"w": np.full((2, 3), i, np.float32)}, "b": np.arange(4) + i}
             for i in range(3)]
    _assert_trees_equal(port_ti.stack_layers(trees),
                        jax.tree.map(lambda *xs: np.stack(xs), *trees))


@pytest.mark.parametrize("rates", [(22050, 24000), (24000, 22050), (16000, 22050),
                                   (44100, 22050)])
def test_resample_matches_jax(rates):
    rng = np.random.default_rng(rates[0])
    t = np.arange(rates[0] // 2) / rates[0]
    clip = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)) \
        .astype(np.float32)
    for x in (clip, clip[None]):
        got = port_audio.resample(x, *rates)
        want = jax_audio.resample(x, *rates)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_native_library_builds_outside_the_package():
    """The port builds libaudioio.so at first use into build/native/, never
    into its package, where a compiler is found; without one the resampler
    is scipy's (the JAX package's fallback too)."""
    pkg = os.path.dirname(native.__file__)
    if native.available():
        assert os.path.exists(native._LIB_PATH)
        assert os.path.realpath(os.path.dirname(native._LIB_PATH)) == os.path.realpath(
            os.path.join(pkg, "..", "..", "build", "native"))
    assert not os.path.exists(os.path.join(pkg, "libaudioio.so"))


def test_resample_falls_back_to_scipy(monkeypatch):
    from scipy.signal import resample_poly

    monkeypatch.setattr(native, "_lib", False)
    x = np.random.default_rng(0).standard_normal(2205).astype(np.float32)
    np.testing.assert_array_equal(port_audio.resample(x, 22050, 24000),
                                  resample_poly(x, 160, 147).astype(np.float32))
