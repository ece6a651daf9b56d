"""The harness driven through a whole run at a tiny configuration on the
CPU (the look for a card skipped): a sound run comes out correct, and each
fault planted under the timed path comes out not correct."""
import json
import os

import pytest
import torch

from portbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..", "..")
SEED = 2 ** 31 + 4242
# limits of the tiny CPU runs: the sound runs read ar_gap 0-0.01, the bf16
# errors about 0.002-0.01, HiFi-GAN's and UnivNet's under 1e-5
FAST_LIMITS = {"ar_gap": 0.05, "latent_err": 0.05, "hifigan_err": 1e-4, "structure_off": 0}
QUALITY_LIMITS = {"ar_gap": 0.05, "latent_err": 0.05, "clvp_err": 0.05,
                  "conditioning_err": 0.05, "diffusion_err": 0.05, "sampler_err": 1e-4,
                  "vocoder_err": 1e-4, "structure_off": 0}


def tiny(entry: str):
    cfg = "tiny-quality" if entry == "preset" else "tiny-fast"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        e2e = [dict(m) for m in json.load(f)["end_to_end"]]
    for m in e2e:
        m.pop("workloads", None)
    bench = {"configs": [{"name": cfg, "file": os.path.join(HERE, f"{cfg}.json")}],
             "end_to_end": e2e, "per_layer": []}
    cell = {"name": "tiny", "config": cfg, "chips": 1,
            "traffic": os.path.join(HERE, f"tiny-{entry}.json")}
    options = {"gpt_fused_step": True}
    if entry == "preset":
        options["autoregressive_batch_size"] = 2
    limits = QUALITY_LIMITS if entry == "preset" else FAST_LIMITS
    return bench, cell, options, limits


def run_tiny(entry: str):
    bench, cell, options, limits = tiny(entry)
    limits = {k: v for k, v in limits.items() if k != "latent_err" or entry != "stream"}
    result, lines = run.run_cell(bench, cell, SEED, 0.5, False, device="cpu", options=options,
                                 limits=limits)
    return result


@pytest.mark.parametrize("entry", ["stream", "batch", "preset"])
def test_a_sound_run_is_correct(entry):
    result = run_tiny(entry)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    m = result["metrics"]
    assert m["audio_s_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert ("first_chunk_p95_ms" in m) == (entry == "stream")


def _alter_a_token(monkeypatch):
    from tortoise_tpu_torch.models import ar_sampler
    original = ar_sampler._warp_and_sample
    calls = {"n": 0}

    def altered(*args, **kwargs):
        tok = original(*args, **kwargs)
        calls["n"] += 1
        return (tok + 1) % 8192 if calls["n"] % 5 == 3 else tok

    monkeypatch.setattr(ar_sampler, "_warp_and_sample", altered)


def _step_returns_its_state(monkeypatch):
    from tortoise_tpu_torch.models import ar_sampler
    monkeypatch.setattr(ar_sampler, "_gpt_step",
                        lambda model, settings, stacked, emb, cache, pos: emb[:, 0])


def _hifigan_answer_altered(monkeypatch):
    from tortoise_tpu_torch.models.hifigan import HifiganGenerator
    original = HifiganGenerator.forward
    monkeypatch.setattr(HifiganGenerator, "forward",
                        lambda self, *a, **k: original(self, *a, **k) * 0.9)


def _diffusion_answer_altered(monkeypatch):
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts
    original = DiffusionTts.forward
    monkeypatch.setattr(DiffusionTts, "forward",
                        lambda self, *a, **k: original(self, *a, **k) * 0.9)


def _vocoder_answer_altered(monkeypatch):
    from tortoise_tpu_torch.models.vocoder import UnivNetGenerator
    original = UnivNetGenerator.forward
    monkeypatch.setattr(UnivNetGenerator, "forward",
                        lambda self, *a, **k: original(self, *a, **k) * 0.9)


def _guidance_dropped(monkeypatch):
    from tortoise_tpu_torch.diffusion import sampler
    original = sampler._model_out
    monkeypatch.setattr(sampler, "_model_out",
                        lambda fn, x, t, cfg, cfk: original(fn, x, t, cfg, 0.0))


def _half_the_diffusion_steps(monkeypatch):
    from tortoise_tpu_torch import api
    original = api.spaced_schedule
    monkeypatch.setattr(api, "spaced_schedule",
                        lambda kind, total, n: original(kind, total, max(2, n // 2)))


def _clvp_scores_altered(monkeypatch):
    from tortoise_tpu_torch.models.clvp import CLVP
    original = CLVP.score_candidates
    monkeypatch.setattr(CLVP, "score_candidates",
                        lambda self, *a: original(self, *a).flip(0))


def _voice_latent_altered(monkeypatch):
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts
    original = DiffusionTts.get_conditioning
    monkeypatch.setattr(DiffusionTts, "get_conditioning",
                        lambda self, *a: original(self, *a) * 0.9)


def _aligned_embeddings_altered(monkeypatch):
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts
    original = DiffusionTts.timestep_independent_bucketed
    monkeypatch.setattr(DiffusionTts, "timestep_independent_bucketed",
                        lambda self, *a: original(self, *a) * 0.9)


def _served_wav_altered(monkeypatch):
    from tortoise_tpu_torch.api import TextToSpeech
    original = TextToSpeech._vocode_clip
    monkeypatch.setattr(TextToSpeech, "_vocode_clip",
                        lambda self, *a: original(self, *a) * 0.9)


def _stream_chunk_repeated(monkeypatch):
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    original = TextToSpeechFast.tts_stream

    def repeated(self, *a, **k):
        for i, chunk in enumerate(original(self, *a, **k)):
            yield chunk
            if i == 0:
                yield chunk

    monkeypatch.setattr(TextToSpeechFast, "tts_stream", repeated)


def _stream_samples_lost(monkeypatch):
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    original = TextToSpeechFast.tts_stream

    def lost(self, *a, **k):
        for i, chunk in enumerate(original(self, *a, **k)):
            yield chunk[:-256] if i == 0 else chunk

    monkeypatch.setattr(TextToSpeechFast, "tts_stream", lost)


def _batch_wavs_swapped(monkeypatch):
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    original = TextToSpeechFast.tts_batch
    monkeypatch.setattr(TextToSpeechFast, "tts_batch",
                        lambda self, *a, **k: original(self, *a, **k)[::-1])


FAULTS = {"a token altered": _alter_a_token,
          "a step returns its state unchanged": _step_returns_its_state,
          "the HiFi-GAN answer altered": _hifigan_answer_altered,
          "the diffusion answer altered": _diffusion_answer_altered,
          "the vocoder answer altered": _vocoder_answer_altered,
          "the guidance dropped": _guidance_dropped,
          "half the diffusion steps": _half_the_diffusion_steps,
          "the CLVP scores altered": _clvp_scores_altered,
          "the served wav altered": _served_wav_altered,
          "the voice latent altered": _voice_latent_altered,
          "the aligned embeddings altered": _aligned_embeddings_altered,
          "a stream chunk repeated": _stream_chunk_repeated,
          "stream samples lost at a join": _stream_samples_lost,
          "the batch's wavs swapped": _batch_wavs_swapped}
CASES = [("stream", "a token altered"), ("batch", "a token altered"),
         ("preset", "a token altered"), ("stream", "a step returns its state unchanged"),
         ("preset", "a step returns its state unchanged"),
         ("stream", "the HiFi-GAN answer altered"), ("batch", "the HiFi-GAN answer altered"),
         ("preset", "the diffusion answer altered"), ("preset", "the vocoder answer altered"),
         ("preset", "the guidance dropped"), ("preset", "half the diffusion steps"),
         ("preset", "the CLVP scores altered"), ("preset", "the served wav altered"),
         ("preset", "the voice latent altered"), ("preset", "the aligned embeddings altered"),
         ("stream", "a stream chunk repeated"), ("stream", "stream samples lost at a join"),
         ("batch", "the batch's wavs swapped")]


@pytest.mark.parametrize("entry,fault", CASES)
def test_a_planted_fault_is_not_correct(monkeypatch, entry, fault):
    FAULTS[fault](monkeypatch)
    result = run_tiny(entry)
    assert not result["correct"], result["checks"]


def test_no_card_exits_without_a_result(tmp_path, monkeypatch, capsys):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fast-stream", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
