"""TCP streaming TTS server over the port's ``TextToSpeechFast``.

Port of ``tortoise_tpu/apps/socket_server.py`` (reference
tortoise/socket_server.py). Protocol: a client sends ``voice|text``; the
server splits the text into sentences (``utils.text.split_and_recombine_text``),
streams each through ``tts_stream`` as float32 little-endian 24 kHz mono PCM,
and ends the utterance with ``END_OF_AUDIO``. A connection may send several
utterances, one after the other. One lock serializes synthesis (the
reference shares one pipeline among its client threads unguarded), and each
voice's conditioning latent is computed once and cached.

    python3 -m tortoise_tpu_torch.apps.socket_server [--host 0.0.0.0] [--port 5000] \\
        [--model_dir DIR]

It serves from the GPU; ``tts=`` takes a pipeline built elsewhere (the CPU
tests pass a tiny one).
"""
from __future__ import annotations

import argparse
import socket
import threading

END_OF_AUDIO = b"END_OF_AUDIO"


class TTSServer:
    def __init__(self, host="0.0.0.0", port=5000, models_dir=None, tts=None):
        self.host = host
        self.port = port
        if tts is None:
            from tortoise_tpu_torch.api_fast import TextToSpeechFast

            tts = TextToSpeechFast(models_dir=models_dir)
        self.tts = tts
        self._lock = threading.Lock()   # one synthesis at a time
        self._voice_cache: dict[str, object] = {}
        self._server: socket.socket | None = None

    def _latents_for(self, voice: str):
        """The voice's AR conditioning latent (None: a random voice), cached."""
        if voice not in self._voice_cache:
            from tortoise_tpu_torch.utils.audio import load_voices

            voice_samples, latents = load_voices([voice])
            if voice_samples is not None:
                with self._lock:
                    latents = self.tts.get_conditioning_latents(voice_samples)
            elif isinstance(latents, tuple):
                latents = latents[0]
            self._voice_cache[voice] = latents
        return self._voice_cache[voice]

    def handle_client(self, client: socket.socket):
        """Answers one connection's utterances until the client closes it."""
        from tortoise_tpu_torch.utils.text import split_and_recombine_text

        try:
            while True:
                data = client.recv(1024).decode("utf-8")
                if not data:
                    break
                voice, text = data.split("|", 1)
                latents = self._latents_for(voice.strip())
                for chunk_text in split_and_recombine_text(text):
                    with self._lock:
                        for chunk in self.tts.tts_stream(chunk_text, conditioning_latents=latents,
                                                         verbose=False):
                            # tts_stream yields float32 CPU tensors
                            client.sendall(chunk.numpy().astype("<f4").tobytes())
                client.sendall(END_OF_AUDIO)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            client.close()

    def bind(self) -> int:
        """Open the listening socket; returns its port (``port=0``: one the
        system picked)."""
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((self.host, self.port))
        self._server.listen(5)
        self.port = self._server.getsockname()[1]
        return self.port

    def serve_forever(self):
        """Accept connections, each answered in a thread of its own, until
        ``close``."""
        if self._server is None:
            self.bind()
        print(f"Server listening on port {self.port}")
        while True:
            try:
                client, addr = self._server.accept()
            except OSError:     # closed
                return
            print(f"Accepted connection from {addr}")
            threading.Thread(target=self.handle_client, args=(client,), daemon=True).start()

    def close(self):
        """Stop serving: ``serve_forever`` returns (a shutdown wakes its
        blocking accept, which a close alone does not on Linux)."""
        if self._server is not None:
            try:
                self._server.shutdown(socket.SHUT_RDWR)
            except OSError:     # never connected
                pass
            self._server.close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--model_dir", default=None)
    args = parser.parse_args(argv)
    TTSServer(args.host, args.port, args.model_dir).serve_forever()


if __name__ == "__main__":
    main()
