"""The port's CLIs (tortoise_tpu_torch/apps) against the JAX package's: the
same options, defaults and choices, flag for flag; --list-voices prints the
same voices; and the full-knob CLI answers a request on the CPU at a tiny
size (--device cpu), writing a 24 kHz wav."""
import argparse
import glob
import importlib
import warnings

import numpy as np
import pytest
import torch
from scipy.io.wavfile import read as wav_read

torch.set_num_threads(2)

APPS = ["main", "do_tts", "read", "read_fast", "tts_stream", "get_conditioning_latents", "eval",
        "is_this_from_tortoise"]


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
    """--mesh still raises: the multi-device paths are not ported. A
    bracketed request no longer does (redaction is ported; see
    test_main_bracketed_request_without_aligner_weights)."""
    from tortoise_tpu_torch.apps import main as port_main

    with pytest.raises(NotImplementedError, match="Queue 1 item g"):
        port_main.main(["--device", "cpu", "--mesh", "4x2", "-o", str(tmp_path / "a.wav"), "Hi."])


def _tiny_factory(monkeypatch, **fixed):
    """Patch the port's TextToSpeech with the tiny config on the CPU; its
    tts_with_preset keeps a request short (2 candidates, 2 diffusion steps,
    16 tokens) whatever the preset."""
    from test_torch_kernels_gpu import TINY
    from tortoise_tpu_torch import api

    full = api.TextToSpeech

    def tiny(**kwargs):
        kwargs["autoregressive_batch_size"] = kwargs.get("autoregressive_batch_size") or 2
        kwargs.update(fixed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tts = full(**kwargs, **TINY)
        quick = tts.tts_with_preset
        tts.tts_with_preset = lambda text, **kw: quick(
            text, **{**kw, "num_autoregressive_samples": 2, "diffusion_iterations": 2,
                     "max_mel_tokens": 16, "use_deterministic_seed": 0})
        return tts

    monkeypatch.setattr(api, "TextToSpeech", tiny)


def test_main_bracketed_request_without_aligner_weights(tmp_path, monkeypatch):
    """The reference's documented bracket usage through the CLI: with no
    wav2vec2 checkpoint it warns, writes the unredacted wav and succeeds."""
    from tortoise_tpu_torch.apps import main as port_main

    _tiny_factory(monkeypatch)
    out = tmp_path / "a.wav"
    with pytest.warns(UserWarning, match="redaction disabled"):
        assert port_main.main(["--device", "cpu", "--voice", "train_dotrice", "--preset",
                               "ultra_fast", "-q", "-o", str(out),
                               "[I am really sad,] Please feed me."]) == 0
    sr, wav = wav_read(out)
    assert sr == 24000 and wav.size > 0 and wav.size % 256 == 0 and np.isfinite(wav).all()


def test_eval_cer_with_stub_aligner(tmp_path, monkeypatch):
    """eval --cer on the CPU at the tiny config, its aligner a stub (as
    tests/test_alignment_and_small_models.py scores the JAX CLI's): a wav
    per line and results.tsv as index<TAB>cer<TAB>text, the scores those of
    the JAX package's evaluate_clips. The redaction's aligner does the
    scoring, so one aligner is built. With no wav2vec2 checkpoint --cer
    warns and is skipped."""
    from tortoise_tpu.apps.eval import evaluate_clips as jax_evaluate
    from tortoise_tpu_torch import api
    from tortoise_tpu_torch.apps import eval as port_eval
    from tortoise_tpu_torch.utils import wav2vec_alignment as palign
    from tortoise_tpu_torch.utils.audio import BUILTIN_VOICES_DIR

    built = []

    class Stub:
        def __init__(self, models_dir=None, device="cuda"):
            assert torch.device(device) == torch.device("cpu")
            built.append(self)

        def redact(self, audio, expected_text, audio_sample_rate=24000):
            assert "[" not in expected_text
            return audio

        def transcribe(self, wav, audio_sample_rate=24000):
            assert audio_sample_rate == 24000 and np.isfinite(wav).all()
            return "a perfect transcript" if wav.size % 512 else "a perfect transcrip"

    _tiny_factory(monkeypatch, device="cpu")
    clip = sorted(glob.glob(f"{BUILTIN_VOICES_DIR}/train_dotrice/*.wav"))[0]
    tsv = tmp_path / "lines.tsv"
    tsv.write_text(f"A perfect transcript.\t{clip}\nSomething else.\t{clip}\n")
    out = tmp_path / "out"
    with monkeypatch.context() as m:
        m.setattr(api, "Wav2VecAlignment", Stub)
        m.setattr(palign, "Wav2VecAlignment", Stub)
        rows = port_eval.main(["--eval_path", str(tsv), "--output_path", str(out),
                               "--preset", "ultra_fast", "--cer"])
    assert len(built) == 1
    wavs = [wav_read(out / f"{i}.wav")[1] for i in range(2)]
    assert all(w.size and np.isfinite(w).all() for w in wavs)
    want = jax_evaluate([(i, w, t) for i, w, t in zip(
        range(2), wavs, ["A perfect transcript.", "Something else."])], Stub(device="cpu"))
    assert [(i, t) for i, _, t in rows] == [(i, t) for i, _, t in want]
    np.testing.assert_allclose([c for _, c, _ in rows], [c for _, c, _ in want], rtol=0)
    lines = (out / "results.tsv").read_text().splitlines()
    assert lines == [f"{i}\t{c:.4f}\t{t}" for i, c, t in want]
    with pytest.warns(UserWarning, match="--cer skipped"):
        assert port_eval.main(["--eval_path", str(tsv), "--output_path", str(tmp_path / "b"),
                               "--preset", "ultra_fast", "--cer"]) is None


def test_is_this_from_tortoise_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The classifier CLI on the CPU at a tiny config (random weights, seed
    7): it prints the reference's sentence with the probability that the
    api's classify_audio_clip gives for the same clip."""
    from tortoise_tpu_torch import api
    from tortoise_tpu_torch.apps import is_this_from_tortoise as cli
    from tortoise_tpu_torch.models.classifier import ClassifierConfig
    from tortoise_tpu_torch.utils.audio import load_audio, save_wav

    monkeypatch.setattr(api, "ClassifierConfig", lambda: ClassifierConfig(
        embedding_dim=32, base_channels=8, depth=2, attn_blocks=2))
    full = api.classify_audio_clip
    monkeypatch.setattr(api, "classify_audio_clip", lambda clip, models_dir=None: full(
        clip, models_dir=models_dir, device="cpu"))
    path = str(tmp_path / "clip.wav")
    save_wav(path, 0.3 * np.sin(np.arange(4800, dtype=np.float32) / 7), 24000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prob = cli.main(["--clip", path])
        want = full(load_audio(path, 24000)[0], device="cpu")
    assert prob == want and 0.0 <= prob <= 1.0
    assert capsys.readouterr().out.strip() == (
        f"This classifier thinks there is a {prob * 100:.2f}% chance that this clip was "
        "generated from Tortoise.")


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
