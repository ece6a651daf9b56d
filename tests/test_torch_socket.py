"""The port's socket server and client (tortoise_tpu_torch/apps/socket_*.py)
on the CPU: a tiny TextToSpeechFast (2 layers, 128 wide, float32) served on
127.0.0.1 at a port the system picks. The bytes a client reads are the
chunks the server's tts_stream yielded, in order, as float32 little-endian;
two utterances go over one connection; the JAX package's client reads the
port's server. Every socket has a timeout and every thread is joined with
one, so a hang fails in seconds."""
import socket
import threading
import warnings

import numpy as np
import pytest
import torch

from tortoise_tpu.apps import socket_client as jax_client
from tortoise_tpu_torch.api_fast import TextToSpeechFast
from tortoise_tpu_torch.apps import socket_client, socket_server
from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig

torch.set_num_threads(2)
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def served():
    """(server, port, the chunks its tts_stream yielded, a list per call)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TextToSpeechFast(device="cpu", dtype=torch.float32,
                               ar_config=UnifiedVoiceConfig(layers=2, model_dim=128, heads=4,
                                                            max_text_tokens=200,
                                                            max_mel_tokens=24))
    streams = []
    stream = tts.tts_stream

    def recording(*args, **kwargs):
        streams.append([])
        for chunk in stream(*args, **kwargs):
            streams[-1].append(chunk.clone())
            yield chunk

    tts.tts_stream = recording
    server = socket_server.TTSServer(host="127.0.0.1", port=0, tts=tts)
    port = server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, port, streams
    server.close()
    thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()


def _sent(streams) -> np.ndarray:
    return np.concatenate([c.numpy() for s in streams for c in s]).astype("<f4")


def test_client_reads_the_chunks_tts_stream_yielded(served):
    """One sentence: what the client reads is the stream's chunks, in
    order, bit for bit."""
    _, port, streams = served
    before = len(streams)
    audio = socket_client.receive_audio("127.0.0.1", port, "random", "A socket test sentence.",
                                        timeout=TIMEOUT)
    sent = streams[before:]
    assert len(sent) == 1 and len(sent[0]) >= 1
    assert audio.dtype == np.float32 and len(audio) > 0 and np.isfinite(audio).all()
    np.testing.assert_array_equal(audio, _sent(sent))


def test_two_utterances_on_one_connection(served):
    """Two utterances over one connection, each ended by END_OF_AUDIO; the
    second text of three sentences splits into two pieces
    (split_and_recombine_text joins sentences while they fit), each
    streamed in turn."""
    _, port, streams = served
    long = ("This sentence of the second request runs on for well over one hundred "
            "characters, so that the splitter cannot join it to the next one.")
    texts = ["First.", f"{long} {long} {long}"]
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as sock:
        for text, n_sentences in zip(texts, (1, 2)):
            before = len(streams)
            sock.sendall(f"random|{text}".encode("utf-8"))
            audio = socket_client.read_utterance(sock)
            assert len(streams) - before == n_sentences
            np.testing.assert_array_equal(audio, _sent(streams[before:]))


def test_jax_client_reads_the_port_server(served):
    """The JAX package's receive_audio (no timeout of its own: the default
    socket timeout bounds it here) reads the port's server."""
    _, port, streams = served
    before = len(streams)
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(TIMEOUT)
    try:
        audio = jax_client.receive_audio("127.0.0.1", port, "random", "Hello from JAX.")
    finally:
        socket.setdefaulttimeout(old)
    np.testing.assert_array_equal(audio, _sent(streams[before:]))


def test_voice_latents_are_computed_once(served, monkeypatch):
    """A clip voice's conditioning latent is computed at its first
    utterance and reused by the next one."""
    server, port, _ = served
    from tortoise_tpu_torch.utils import audio

    clips = [torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (1, 22050)),
                             dtype=torch.float32)]
    loads = []
    monkeypatch.setattr(audio, "load_voices", lambda voices: loads.append(voices) or (clips, None))
    for text in ("One.", "Two."):
        audio_out = socket_client.receive_audio("127.0.0.1", port, "clip_voice", text,
                                                timeout=TIMEOUT)
        assert len(audio_out) > 0
    assert loads == [["clip_voice"]]
    want = server.tts.get_conditioning_latents(clips, crop_rng=None)
    assert server._voice_cache["clip_voice"].shape == want.shape


def test_client_main_writes_a_wav_without_sounddevice(served, tmp_path, monkeypatch):
    """Without sounddevice the client's main writes the audio as a wav."""
    import builtins

    from scipy.io import wavfile

    _, port, _ = served
    real_import = builtins.__import__

    def no_sounddevice(name, *args, **kwargs):
        if name == "sounddevice":
            raise ImportError("no sounddevice")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sounddevice)
    monkeypatch.setattr(socket, "getdefaulttimeout", lambda: TIMEOUT)
    out = tmp_path / "out.wav"
    socket.setdefaulttimeout(TIMEOUT)
    try:
        socket_client.main(["--port", str(port), "--text", "A wav.", "--output", str(out)])
    finally:
        socket.setdefaulttimeout(None)
    sr, wav = wavfile.read(out)
    assert sr == 24000 and wav.dtype == np.float32 and len(wav) > 0


def test_bf16_pipeline_serves_a_clip_voice(monkeypatch):
    """A server over a bf16 pipeline answers a clip voice: the voice's latent
    (bf16, the pipeline's dtype) goes back into tts_stream, which must take
    it as a tensor (numpy has no bf16, as it reads no CUDA tensor)."""
    from tortoise_tpu_torch.utils import audio

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TextToSpeechFast(device="cpu", dtype=torch.bfloat16,
                               ar_config=UnifiedVoiceConfig(layers=2, model_dim=128, heads=4,
                                                            max_text_tokens=60,
                                                            max_mel_tokens=16))
    clips = [torch.as_tensor(np.random.default_rng(1).uniform(-0.5, 0.5, (1, 22050)),
                             dtype=torch.float32)]
    monkeypatch.setattr(audio, "load_voices", lambda voices: (clips, None))
    server = socket_server.TTSServer(host="127.0.0.1", port=0, tts=tts)
    port = server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        got = socket_client.receive_audio("127.0.0.1", port, "clip_voice", "Hello.",
                                          timeout=TIMEOUT)
    finally:
        server.close()
        thread.join(timeout=TIMEOUT)
    assert not thread.is_alive()
    assert server._voice_cache["clip_voice"].dtype == torch.bfloat16
    assert len(got) > 0 and np.isfinite(got).all()
