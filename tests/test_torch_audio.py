"""The port's voice loading (tortoise_tpu_torch/utils/audio.py) against the
JAX package's (tortoise_tpu/utils/audio.py): mp3 clips through ffmpeg (its
subprocess stubbed, and missing), the voice registry over wav, mp3, npz and
pth with the extra-voices library, the reference's ``.pth`` latent files and
the ``<voice>.clips.npz`` cache. Every voice folder a test reads or writes is
a copy under ``tmp_path``: no test writes into the repository's voices."""
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from scipy.io.wavfile import write as wav_write

from tortoise_tpu.utils import audio as jax_audio
from tortoise_tpu_torch.utils import audio as port_audio

MP3_VOICE = "tim_reynolds"   # one of the seven built-in voices that hold only mp3 clips


def _fake_ffmpeg(cmd, check=False, **kwargs):
    """Stands in for ``ffmpeg -i IN -ar SR -ac 1 OUT``: writes a mono int16
    wav at the asked rate whose samples depend on the input file's bytes."""
    src, sr, out = cmd[cmd.index("-i") + 1], int(cmd[cmd.index("-ar") + 1]), cmd[-1]
    with open(src, "rb") as f:
        seed = sum(f.read(4096))
    t = np.arange(sr // 2) / sr
    sig = 0.3 * np.sin(2 * np.pi * (110 + seed % 300) * t) \
        + 0.05 * np.random.default_rng(seed).standard_normal(t.size)
    wav_write(out, sr, (sig * 32767).astype(np.int16))
    return subprocess.CompletedProcess(cmd, 0)


def _no_ffmpeg(cmd, check=False, **kwargs):
    raise FileNotFoundError(2, "No such file or directory", cmd[0])


@pytest.fixture
def voices(tmp_path, monkeypatch):
    """A voices folder under tmp_path with the mp3 voice copied in, and both
    packages' built-in voices directory pointed at it."""
    root = tmp_path / "voices"
    shutil.copytree(os.path.join(port_audio.BUILTIN_VOICES_DIR, MP3_VOICE), root / MP3_VOICE)
    monkeypatch.setattr(port_audio, "BUILTIN_VOICES_DIR", str(root))
    monkeypatch.setattr(jax_audio, "BUILTIN_VOICES_DIR", str(root))
    monkeypatch.setattr(port_audio, "EXTRA_VOICES_DIR", None)
    monkeypatch.setattr(jax_audio, "REFERENCE_VOICES_DIR", str(tmp_path / "none"))
    return root


def test_mp3_clip_matches_jax_with_stubbed_ffmpeg(voices, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _fake_ffmpeg)
    path = sorted((voices / MP3_VOICE).glob("*.mp3"))[0]
    for sr in (22050, 24000):
        got, want = port_audio.load_audio(str(path), sr), jax_audio.load_audio(str(path), sr)
        assert got.shape == want.shape == (1, sr // 2)
        np.testing.assert_array_equal(got, want)


def test_missing_ffmpeg_names_ffmpeg(voices, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _no_ffmpeg)
    path = str(sorted((voices / MP3_VOICE).glob("*.mp3"))[0])
    with pytest.raises(RuntimeError, match="requires ffmpeg") as got:
        port_audio.load_audio(path, 22050)
    with pytest.raises(RuntimeError, match="requires ffmpeg") as want:
        jax_audio.load_audio(path, 22050)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="requires ffmpeg"):
        port_audio.load_voices([MP3_VOICE])
    assert not list((voices / MP3_VOICE).glob("*.npz"))


def test_mp3_voice_loads_where_ffmpeg_exists(voices):
    """The real ffmpeg: clips where it is installed, else the error that
    names it. load_voices no longer returns ([], None) for an mp3 voice."""
    if shutil.which("ffmpeg") is None:
        with pytest.raises(RuntimeError, match="requires ffmpeg"):
            port_audio.load_voices([MP3_VOICE])
        return
    clips, latents = port_audio.load_voices([MP3_VOICE])
    assert latents is None and len(clips) == 4
    assert all(c.ndim == 2 and c.shape[0] == 1 and c.shape[1] > 0 for c in clips)


def test_mp3_voice_and_its_clip_cache_match_jax(voices, tmp_path, monkeypatch):
    """With ffmpeg stubbed: the mp3 voice's clips equal the JAX package's;
    the first load writes <voice>.clips.npz beside the clips, the second
    reads it back unchanged; each package reads the other's cache."""
    monkeypatch.setattr(subprocess, "run", _fake_ffmpeg)
    jax_clips, _ = jax_audio.load_voice(MP3_VOICE)
    cache = voices / MP3_VOICE / f"{MP3_VOICE}.clips.npz"
    jax_cache = cache.read_bytes()
    cache.unlink()
    clips, latents = port_audio.load_voice(MP3_VOICE)
    assert latents is None and len(clips) == len(jax_clips) == 4
    for c, j in zip(clips, jax_clips):
        np.testing.assert_array_equal(c, j)
    assert cache.exists() and not list((voices / MP3_VOICE).glob("*.part"))
    monkeypatch.setattr(subprocess, "run", _no_ffmpeg)      # the cache needs no decode
    for a, b in zip(port_audio.load_voice(MP3_VOICE)[0], jax_audio.load_voice(MP3_VOICE)[0]):
        np.testing.assert_array_equal(a, b)
    cache.write_bytes(jax_cache)
    for c, j in zip(port_audio.load_voice(MP3_VOICE)[0], jax_clips):
        np.testing.assert_array_equal(c, j)


def test_cache_is_never_written_under_the_extra_voices_library(voices, tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _fake_ffmpeg)
    extra = tmp_path / "extra"
    shutil.move(str(voices / MP3_VOICE), str(extra / MP3_VOICE))
    monkeypatch.setattr(port_audio, "EXTRA_VOICES_DIR", str(extra))
    monkeypatch.setattr(jax_audio, "REFERENCE_VOICES_DIR", str(extra))
    clips, _ = port_audio.load_voice(MP3_VOICE)
    want, _ = jax_audio.load_voice(MP3_VOICE)
    assert len(clips) == 4 and not list(extra.rglob("*.npz"))
    for c, j in zip(clips, want):
        np.testing.assert_array_equal(c, j)


def test_unwritable_voice_folder_is_ignored(voices, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _fake_ffmpeg)

    def refuse(*args, **kwargs):
        raise PermissionError("read-only")

    monkeypatch.setattr(port_audio.np, "savez", refuse)
    clips, _ = port_audio.load_voice(MP3_VOICE)
    assert len(clips) == 4
    assert not [p for p in (voices / MP3_VOICE).iterdir() if p.suffix != ".mp3"]


def _latent_voices(root):
    """Voices of latent files: a .pth (auto, diffusion) pair, a .pth tensor,
    an .npz, and a folder that mixes every kind the registry lists."""
    rng = np.random.default_rng(0)
    auto, diff = rng.standard_normal((1, 1024)), rng.standard_normal((1, 2048))
    for name in ("pth_pair", "pth_auto", "npz_pair", "mixed"):
        (root / name).mkdir()
    torch.save((torch.tensor(auto), torch.tensor(diff)), root / "pth_pair" / "v.pth")
    torch.save(torch.tensor(auto), root / "pth_auto" / "v.pth")
    np.savez(root / "npz_pair" / "v.npz", auto=auto, diffusion=diff)
    wav_write(str(root / "mixed" / "b.wav"), 22050, np.zeros(100, np.int16))
    for ext in ("mp3", "pth", "npz"):
        (root / "mixed" / f"a.{ext}").write_bytes(b"")
    return auto, diff


def test_registry_and_latent_files_match_jax(voices, tmp_path, monkeypatch):
    extra = tmp_path / "extra"
    extra.mkdir()
    auto, diff = _latent_voices(extra)
    monkeypatch.setattr(port_audio, "EXTRA_VOICES_DIR", str(extra))
    monkeypatch.setattr(jax_audio, "REFERENCE_VOICES_DIR", str(extra))
    got, want = port_audio.get_voices(), jax_audio.get_voices()
    assert got == want
    assert [os.path.basename(p) for p in got["mixed"]] == ["b.wav", "a.mp3", "a.npz", "a.pth"]
    for name in ("pth_pair", "pth_auto", "npz_pair"):
        (clips, lat), (jclips, jlat) = port_audio.load_voice(name), jax_audio.load_voice(name)
        assert clips is None and jclips is None
        np.testing.assert_array_equal(lat[0], auto)
        np.testing.assert_array_equal(lat[0], jlat[0])
        if name == "pth_auto":
            assert lat[1] is None and jlat[1] is None
        else:
            np.testing.assert_array_equal(lat[1], diff)
            np.testing.assert_array_equal(lat[1], jlat[1])
    _, merged = port_audio.load_voices(["pth_pair", "npz_pair"])
    _, jmerged = jax_audio.load_voices(["pth_pair", "npz_pair"])
    for a, b in zip(merged, jmerged):
        np.testing.assert_array_equal(a, b)
