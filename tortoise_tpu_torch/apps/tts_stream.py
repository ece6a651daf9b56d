"""Streaming synthesis CLI (reference: tortoise/tts_stream.py).

Port of ``tortoise_tpu/apps/tts_stream.py``, flag for flag, on the card:
streams chunks as they are produced; plays them through sounddevice when
it is installed, and writes the assembled stream to a wav file either way.

    python3 -m tortoise_tpu_torch.apps.tts_stream --text "Hello there." --voice train_dotrice
"""
from __future__ import annotations

import argparse
import queue
import threading

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--text", default="This is a streaming synthesis test.")
    parser.add_argument("--voice", default="random")
    parser.add_argument("--model_dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--output_path", default="stream_out.wav")
    parser.add_argument("--stream_chunk_size", type=int, default=40)
    parser.add_argument("--use_deepspeed", type=bool, default=False)
    parser.add_argument("--kv_cache", type=bool, default=True)
    parser.add_argument("--half", type=bool, default=True)
    parser.add_argument("--extra_voice_dir", action="append", default=[])
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.utils.audio import load_voices, save_wav

    tts = TextToSpeechFast(models_dir=args.model_dir)
    voice_samples, conditioning_latents = load_voices(args.voice.split("&"),
                                                      args.extra_voice_dir)

    def stream():
        return tts.tts_stream(args.text, voice_samples=voice_samples,
                              conditioning_latents=conditioning_latents,
                              stream_chunk_size=args.stream_chunk_size,
                              use_deterministic_seed=args.seed)

    try:
        import sounddevice as sd
    except ImportError:
        print("sounddevice not available; writing stream to", args.output_path)
        chunks = [np.asarray(c) for c in stream()]
    else:
        q: queue.Queue = queue.Queue()

        def playback():
            with sd.OutputStream(samplerate=24000, channels=1, dtype="float32") as st:
                while True:
                    chunk = q.get()
                    if chunk is None:
                        return
                    st.write(chunk.astype(np.float32))

        thread = threading.Thread(target=playback, daemon=True)
        thread.start()
        chunks = []
        try:
            for chunk in stream():
                chunks.append(np.asarray(chunk))
                q.put(chunks[-1])
        finally:
            q.put(None)
            thread.join()
    save_wav(args.output_path, np.concatenate(chunks), 24000)
    print(f"wrote {args.output_path} ({sum(len(c) for c in chunks) / 24000:.2f}s)")


if __name__ == "__main__":
    main()
