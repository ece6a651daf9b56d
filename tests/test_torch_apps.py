"""The port's CLIs (tortoise_tpu_torch/apps) against the JAX package's: the
same options, defaults and choices, flag for flag; --list-voices prints the
same voices; and the full-knob CLI answers a request on the CPU at a tiny
size (--device cpu), writing a 24 kHz wav."""
import argparse
import importlib
import warnings

import numpy as np
import pytest
import torch
from scipy.io.wavfile import read as wav_read

torch.set_num_threads(2)

APPS = ["main", "do_tts", "read", "read_fast", "tts_stream", "get_conditioning_latents"]


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _jax_parser(name, monkeypatch):
    """The parser a JAX CLI builds inside its main(): parse_args is made to
    hand the parser back before anything runs."""
    mod = importlib.import_module(f"tortoise_tpu.apps.{name}")
    if hasattr(mod, "build_parser"):
        return mod.build_parser()

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as got:
            mod.main([])
    return got.value.parser


def _options(parser):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        typ = a.type
        if typ is not None and typ not in (int, float, str, bool):
            typ = tuple(typ(s) for s in ("1", "true", "no"))   # --cond-free's lambda
        out[a.dest] = dict(option_strings=tuple(a.option_strings), default=a.default,
                           choices=a.choices, required=a.required, nargs=a.nargs, type=typ,
                           action=type(a).__name__, const=a.const)
    return out


@pytest.mark.parametrize("name", APPS)
def test_parser_matches_jax(name, monkeypatch):
    """Every option of the JAX CLI, with its option strings, default,
    choices, type and action, and no other; --device alone defaults to
    cuda in the port (the JAX CLI parses it and ignores it)."""
    port = importlib.import_module(f"tortoise_tpu_torch.apps.{name}").build_parser()
    got, want = _options(port), _options(_jax_parser(name, monkeypatch))
    if name == "main":
        assert got["device"].pop("default") == "cuda" and want["device"].pop("default") is None
    assert got == want


def test_list_voices_matches_jax(capsys, monkeypatch):
    from tortoise_tpu.apps import main as jax_main
    from tortoise_tpu.utils import audio as jax_audio
    from tortoise_tpu_torch.apps import main as port_main

    # the JAX CLI also lists a reference voice library where one is mounted;
    # the port ships the repository's voices only
    monkeypatch.setattr(jax_audio, "REFERENCE_VOICES_DIR", "/nonexistent")
    assert jax_main.main(["--list-voices"]) == 0
    want = capsys.readouterr().out
    assert port_main.main(["--device", "cpu", "--list-voices"]) == 0
    got = capsys.readouterr().out
    assert got == want and "train_dotrice" in got.split()


def test_mesh_and_redaction_raise(tmp_path):
    from tortoise_tpu_torch.apps import main as port_main

    with pytest.raises(NotImplementedError, match="Queue 1 item g"):
        port_main.main(["--device", "cpu", "--mesh", "4x2", "-o", str(tmp_path / "a.wav"), "Hi."])
    with pytest.raises(NotImplementedError, match="redaction"):
        port_main.main(["--device", "cpu", "-o", str(tmp_path / "a.wav"), "[sad] Hi."])


def test_main_answers_a_request_on_the_cpu(tmp_path, monkeypatch):
    """--device cpu at a tiny size (the models' widths cut as in the GPU
    tests; UnivNet at its one width): a finite 24 kHz wav in [-1, 1]."""
    from test_torch_kernels_gpu import TINY
    from tortoise_tpu_torch import api
    from tortoise_tpu_torch.apps import main as port_main

    full = api.TextToSpeech

    def tiny(**kwargs):
        kwargs["autoregressive_batch_size"] = kwargs["autoregressive_batch_size"] or 2
        assert kwargs["device"] == "cpu"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return full(**kwargs, **TINY)

    monkeypatch.setattr(api, "TextToSpeech", tiny)
    out = tmp_path / "cli.wav"
    assert port_main.main(["--device", "cpu", "--voice", "train_dotrice", "--preset",
                           "ultra_fast", "--seed", "0", "--num-autoregressive-samples", "2",
                           "--diffusion-iterations", "2", "--max-mel-tokens", "16", "-q",
                           "-o", str(out), "Hello there."]) == 0
    sr, wav = wav_read(out)
    assert sr == 24000 and wav.dtype == np.float32 and wav.ndim == 1 and wav.size > 0
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
