"""TCP streaming client of ``apps/socket_server.py``.

Port of ``tortoise_tpu/apps/socket_client.py`` (reference
tortoise/socket_client.py): sends ``voice|text`` and reads float32 PCM until
``END_OF_AUDIO``; plays it through ``sounddevice`` where that is installed,
else writes a wav.

    python3 -m tortoise_tpu_torch.apps.socket_client [--host 127.0.0.1] [--port 5000] \\
        [--voice random] [--text "..."] [--output client_out.wav]
"""
from __future__ import annotations

import argparse
import socket

import numpy as np

END_OF_AUDIO = b"END_OF_AUDIO"


def read_utterance(sock: socket.socket) -> np.ndarray:
    """One utterance's float32 samples from a connected socket: everything
    up to ``END_OF_AUDIO`` (or the connection's end)."""
    buf = b""
    while True:
        data = sock.recv(4096)
        if not data:
            break
        buf += data
        if buf.endswith(END_OF_AUDIO):
            buf = buf[:-len(END_OF_AUDIO)]
            break
    n = len(buf) // 4 * 4
    return np.frombuffer(buf[:n], dtype="<f4")


def receive_audio(host: str, port: int, voice: str, text: str,
                  timeout: float | None = None) -> np.ndarray:
    """One utterance over a connection of its own; ``timeout`` (seconds) bounds
    each socket operation."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(f"{voice}|{text}".encode("utf-8"))
        return read_utterance(sock)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--voice", default="random")
    parser.add_argument("--text", default="Hello from the socket client.")
    parser.add_argument("--output", default="client_out.wav")
    args = parser.parse_args(argv)

    audio = receive_audio(args.host, args.port, args.voice, args.text)
    print(f"received {len(audio) / 24000:.2f}s of audio")
    try:
        import sounddevice as sd
    except ImportError:
        from tortoise_tpu_torch.utils.audio import save_wav

        save_wav(args.output, audio, 24000)
        print("wrote", args.output)
    else:
        sd.play(audio, 24000)
        sd.wait()


if __name__ == "__main__":
    main()
