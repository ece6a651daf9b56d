"""The port's wav2vec2 and aligner (tortoise_tpu_torch/models/wav2vec2.py,
utils/wav2vec_alignment.py) against the JAX package's on the CPU: the same
numpy inputs, the JAX weights carried by convert/from_jax.py, float32."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import native as jax_native
from tortoise_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from tortoise_tpu.models.wav2vec2 import Wav2Vec2ForCTC as JaxModel
from tortoise_tpu.utils import wav2vec_alignment as jalign
from tortoise_tpu_torch import native as port_native
from tortoise_tpu_torch.convert.from_jax import from_jax
from tortoise_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
from tortoise_tpu_torch.utils import wav2vec_alignment as palign

torch.set_num_threads(2)

# the SMALL config of tests/test_wav2vec2_parity.py
SMALL = dict(vocab_size=11, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
             conv_stride=(5, 2), num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
# float32 against float32: two layers over a few hundred frames
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    from tortoise_tpu import weights as jax_weights

    jm = JaxModel(JaxConfig(**SMALL))
    params = jax_weights.host_init(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3200))),
                                   seed=3)["params"]
    port = Wav2Vec2ForCTC(Wav2Vec2Config(**SMALL))
    port.load_state_dict(from_jax(port, params))
    return jm, {"params": params}, port.eval()


def _audio(seed, n):
    return np.random.default_rng(seed).standard_normal((1, n)).astype(np.float32)


def test_frame_count_matches_jax():
    for n in (400, 3000, 16000, 371_200):
        assert Wav2Vec2Config().frame_count(n) == JaxConfig().frame_count(n)
        assert Wav2Vec2Config(**SMALL).frame_count(n) == JaxConfig(**SMALL).frame_count(n)


@pytest.mark.parametrize("padded", [False, True])
def test_logits_match_jax(models, padded):
    """Unpadded, and zero-padded with n_samples: the valid frames of both
    equal the JAX model's, and the padded run's equal the unpadded run's."""
    jm, variables, port = models
    audio = _audio(1, 3000)
    if padded:
        x = np.zeros((1, 4000), np.float32)
        x[:, :3000] = audio
        want, jn = jm.apply(variables, jnp.asarray(x), n_samples=3000)
        with torch.no_grad():
            got, n = port(torch.from_numpy(x), n_samples=3000)
            exact, _ = port(torch.from_numpy(audio))
        assert n == int(jn) == exact.shape[1] < got.shape[1]
        np.testing.assert_allclose(got[:, :n].numpy(), exact.numpy(), atol=ATOL)
    else:
        want, jn = jm.apply(variables, jnp.asarray(audio))
        with torch.no_grad():
            got, n = port(torch.from_numpy(audio))
        assert n == int(jn) == got.shape[1]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[:, :n].numpy(), np.asarray(want)[:, :n], atol=ATOL)


def test_logits_fn_matches_the_jax_aligners_run(models):
    """wav2vec2_logits_fn (exact length) against the JAX aligner's run: the
    clip normalised over its valid samples, padded to a 1 s bucket,
    n_samples masking (tortoise_tpu/utils/wav2vec_alignment.py)."""
    jm, variables, port = models
    audio = 0.3 * _audio(2, 5000)[0] + 0.1
    n, nb = audio.shape[0], 16000
    padded = np.zeros((1, nb), np.float32)
    padded[0, :n] = audio
    mask = (np.arange(nb)[None] < n).astype(np.float32)
    mean = (padded * mask).sum() / n
    var = (((padded - mean) * mask) ** 2).sum() / (n - 1)
    norm = (padded - mean) / np.sqrt(var + 1e-7) * mask
    want, jn = jm.apply(variables, jnp.asarray(norm), n_samples=n)
    got = palign.wav2vec2_logits_fn(port, "cpu")(audio)
    assert got.shape == (int(jn), SMALL["vocab_size"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want)[0, :int(jn)], atol=ATOL)


def test_logits_fn_runs_in_float32(models, monkeypatch):
    """wav2vec2_logits_fn resolves its device through
    weights.float32_device, so the aligner on the card runs with TF32 off
    even when no TextToSpeech was built in the process (here the CUDA
    device is swapped for the CPU)."""
    from tortoise_tpu_torch import weights as port_weights

    _, _, port = models
    audio = 0.3 * _audio(2, 5000)[0]
    want = palign.wav2vec2_logits_fn(port, "cpu")(audio)
    asked = []

    def float32_device(device):
        asked.append(torch.device(device))
        return torch.device("cpu")

    monkeypatch.setattr(port_weights, "float32_device", float32_device)
    np.testing.assert_array_equal(palign.wav2vec2_logits_fn(port, "cuda")(audio), want)
    assert asked == [torch.device("cuda")]


def _random_strings(seed, count):
    rng = np.random.default_rng(seed)
    alphabet = list("abcde '")
    out = []
    for _ in range(count):
        a = "".join(rng.choice(alphabet, rng.integers(0, 40)))
        b = "".join(rng.choice(alphabet, rng.integers(0, 40)))
        out.append((a, b))
    return out + [("hello world", "helo wrld"), ("same", "same"), ("", "x"), ("abc", "")]


@pytest.mark.parametrize("dp", ["native", "python"])
def test_max_alignment_matches_jax(dp, monkeypatch):
    """Seeded random strings through the port's native DP (its library
    built at first use) or its Python DP, against the JAX package's Python
    DP."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    if dp == "python":
        monkeypatch.setattr(port_native, "available", lambda: False)
    else:
        assert port_native.available(), "the native library did not build"
        assert port_native.align_dp("abc", "abd") == "ab~"
    for s1, s2 in _random_strings(0, 60):
        assert palign.max_alignment(s1, s2) == jalign.max_alignment(s1, s2), (s1, s2)


def _fake_logits(text, tok, blanks=True):
    """Logits whose argmax spells ``text`` (a blank before each char and
    each char held two frames when ``blanks``)."""
    ids = tok.encode(text.lower())
    vocab = len(tok.symbols)
    rows = []
    for t in ids:
        for k in ([0, t, t] if blanks else [t]):
            row = np.full(vocab, -10.0, np.float32)
            row[k] = 10.0
            rows.append(row)
    return np.stack(rows)


@pytest.mark.parametrize("text,heard", [
    ("hello [noise] world", "hello noise world"),
    ("[I am really sad,] Please feed me.", "i am realy sad, please fed me."),
    ("a [b] c [d] e", "a b c d e"),
    ("keep this [drop that]", "keep this drop that"),
])
def test_align_redact_transcribe_match_jax(text, heard):
    """One fake logits_fn fed to both aligners: the same offsets, the same
    redacted audio sample for sample, the same transcript."""
    ptok, jtok = palign.TacotronCTCTokenizer(), jalign.TacotronCTCTokenizer()
    assert ptok.symbols == jtok.symbols and palign.TacotronCTCTokenizer.UNK == -100
    logits = _fake_logits(heard, ptok)
    p = palign.Wav2VecAlignment(logits_fn=lambda a: logits, device="cpu")
    j = jalign.Wav2VecAlignment(logits_fn=lambda a: logits)
    audio = np.random.default_rng(3).standard_normal((1, len(logits) * 300)).astype(np.float32)
    bare = "".join(seg for seg, _ in palign._bracket_segments(text))
    assert palign._bracket_segments(text) == jalign._bracket_segments(text)
    assert p.align(audio, bare, 16000) == j.align(audio, bare, 16000)
    got, want = p.redact(audio, text, 16000), j.redact(audio, text, 16000)
    assert got.shape == want.shape and got.shape[-1] < audio.shape[-1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(p.redact(audio[0], text, 16000), j.redact(audio[0], text, 16000))
    assert p.transcribe(audio, 16000) == j.transcribe(audio, 16000) == heard


def test_fill_gaps_and_unbracketed_text_match_jax():
    for offsets, end in (([0, -1, -1, 30], 40), ([0, 10, -1], 50), ([0, -1, -1, -1], 7)):
        assert palign._fill_gaps(list(offsets), end) == jalign._fill_gaps(list(offsets), end)
    p = palign.Wav2VecAlignment(logits_fn=lambda a: pytest.fail("no model for plain text"),
                                device="cpu")
    audio = np.ones(100, np.float32)
    assert p.redact(audio, "no brackets here") is audio


def test_alignment_failure_dumps_debug_file(tmp_path, monkeypatch):
    """Out of audio before every char is placed: the reference's assertion,
    with alignment_debug.npz written to the working directory."""
    tok = palign.TacotronCTCTokenizer()
    logits = _fake_logits("ab", tok, blanks=False)
    p = palign.Wav2VecAlignment(logits_fn=lambda a: logits, device="cpu")
    monkeypatch.setattr(palign, "max_alignment", lambda s1, s2: "abb")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(AssertionError, match="alignment_debug.npz"):
        p.align(np.zeros(600, np.float32), "abb", 16000)
    assert (tmp_path / "alignment_debug.npz").exists()


@pytest.mark.parametrize("ref,hyp", [
    ("hello world", "hello world"), ("Hello,  WORLD?", "hello, world?"),
    ("hello world", "hallo world"), ("", ""), ("abc", ""), ("", "abc"),
    ("the quick brown fox", "teh quick brwn fox jumps"),
])
def test_character_error_rate_matches_jax(ref, hyp):
    assert palign.character_error_rate(ref, hyp) == jalign.character_error_rate(ref, hyp)


def test_default_aligner_without_checkpoint_raises(tmp_path):
    """No wav2vec2.pth in models_dir (or no models_dir): FileNotFoundError at
    the first use, before the model is built; no hub fallback."""
    for models_dir in (None, str(tmp_path)):
        aligner = palign.Wav2VecAlignment(models_dir=models_dir, device="cpu")
        with pytest.raises(FileNotFoundError, match="wav2vec2"):
            aligner.transcribe(np.zeros(2400, np.float32))
