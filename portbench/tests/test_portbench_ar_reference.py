"""A configuration's AR reference module (``portbench.reference``): the judge
builds the one the configuration names, ``counts.request_ops`` counts the
AR prior's operations with it, and a request's decode steps are the AR
sampler's, on whichever path decodes them. Tiny pipelines on the CPU."""
import copy
import dataclasses
import json
import sys
import types

import pytest

from portbench import check, counts, flops, system, traffic
from portbench import weights as bench_weights
from portbench.reference import unified_voice
from portbench.tests.test_portbench_harness import SEED, tiny

ENTRIES = ("stream", "batch", "preset")
REQUESTS = 2


def load(entry: str) -> tuple[dict, dict]:
    """(configuration, mix) of a tiny cell. The configuration gets the mel
    vocabulary, which the benchmark's configurations state and the tiny
    ones leave at the program's default, for ``request_ops``'s mel head."""
    bench, cell, _, _ = tiny(entry)
    with open(bench["configs"][0]["file"]) as f:
        config = json.load(f)
    config["autoregressive"].setdefault("number_mel_codes", unified_voice.Config.number_mel_codes)
    return config, traffic.load_mix(cell["traffic"])


def _count_k2_calls(mp):
    """On the CPU the plain version stands in for K2 and counts no launch:
    count each of its calls, as the card's kernel counts its launches."""
    from tortoise_tpu_torch.models import ar_sampler
    from tortoise_tpu_torch.ops import decode_step
    original = ar_sampler.fused_decode_step

    def counted(*args, **kwargs):
        decode_step.fused_decode_step.launches += 1
        return original(*args, **kwargs)

    mp.setattr(ar_sampler, "fused_decode_step", counted)


def _serve(entry: str, fused: bool) -> list:
    _, _, options, _ = tiny(entry)
    options = dict(options, gpt_fused_step=fused)
    if entry == "preset":
        options["autoregressive_batch_size"] = 1     # two decode batches a request
    config, mix = load(entry)
    driver = system.Driver(config, mix, SEED, "cpu", options)
    try:
        gen = traffic.requests(mix, SEED)
        return [driver.serve(next(gen), keep=True) for _ in range(REQUESTS)]
    finally:
        driver.close()


@pytest.fixture(scope="module")
def served():
    """The first requests of each tiny mix, served with K2 and with the
    per-layer stack (``gpt_fused_step`` on and off)."""
    with pytest.MonkeyPatch.context() as mp:
        _count_k2_calls(mp)
        return {(entry, fused): _serve(entry, fused)
                for entry in ENTRIES for fused in (True, False)}


def gpt2_ops(s, mix: dict, config: dict) -> float:
    """``request_ops`` as the GPT-2 formula gave it before a configuration
    chose its AR reference: the prompt, K2's decode steps and the
    re-extraction as ``flops.gpt``, the conditioning encoder as
    ``flops.conditioning_encoder``."""
    ar = config["autoregressive"]
    layers, c, vocab = ar["layers"], ar["model_dim"], ar["number_mel_codes"]
    req, b = s.request, s.batch
    steps = s.k2_steps // s.batches
    prompts = [counts.prompt_len(t) for t in req.texts]
    p0 = sum(prompts) / len(prompts)
    ops = sum(flops.gpt(layers, c, 1, p) for p in prompts) + 2 * len(prompts) * c * vocab
    ops += s.batches * sum(flops.gpt(layers, c, b, 1, int(p0) + i) + 2 * b * c * vocab
                           for i in range(steps))
    codes = steps + 1
    if mix["entry"] == "tts_with_preset":
        clips = len(system.load_clips(req.voices[0]))
        v = config["clvp"]
        ops += flops.conditioning_encoder(c, counts.COND_FRAMES, clips)
        ops += flops.clvp(v["dim_text"], v["text_enc_depth"], v["speech_enc_depth"],
                          counts.text_tokens(req.texts[0]) + 1, codes, b * s.batches)
        ops += flops.gpt(layers, c, 1, prompts[0] + codes + 1)
        d = config["diffusion"]
        ops += sum(flops.diffusion_step(d["model_channels"], d["num_layers"],
                                        valid or [t] * bb)
                   for bb, t, valid in s.diffusion_calls)
        ops += sum(flops.univnet(f) for f in s.vocoder_frames)
    else:
        if mix["entry"] == "tts_batch":
            ops += sum(flops.gpt(layers, c, 1, p + codes + 1) for p in prompts)
        h = config["hifigan"]
        ops += sum(flops.hifigan(n // counts.HOP, c, h["upsample_initial_channel"])
                   for n in s.wav_lengths)
    return ops


@pytest.mark.parametrize("entry", ENTRIES)
def test_naming_unified_voice_is_the_default(served, entry):
    config, mix = load(entry)
    named = copy.deepcopy(config)
    named["reference"] = {"autoregressive": "unified_voice"}
    default, chosen = check.Judge(config, SEED, "cpu"), check.Judge(named, SEED, "cpu")
    assert type(chosen.model("autoregressive")) is unified_voice.UnifiedVoice
    assert chosen.specs == default.specs
    numbers = default.numbers(served[entry, True], mix)
    assert numbers and chosen.numbers(served[entry, True], mix) == numbers
    assert system.made(named) == system.made(config) == ("UnifiedVoice",) + system.MADE
    s = served[entry, True][0]
    assert counts.request_ops(s, mix, named) == counts.request_ops(s, mix, config)


@pytest.mark.parametrize("change,named", [
    (lambda c: c["autoregressive"].update(n_mamba_layers=36), "n_mamba_layers"),
    (lambda c: c.update(reference={"autoregressive": "granite_hybrid"}), "granite_hybrid"),
    (lambda c: c.update(reference={"autoregressive": "../clvp"}), "../clvp"),
])
def test_an_unknown_key_or_reference_fails_when_the_judge_is_built(change, named):
    config, _ = load("stream")
    change(config)
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        check.Judge(config, SEED, "cpu")


def test_a_key_only_the_program_reads_is_ignored_on_purpose():
    config, _ = load("stream")
    config["autoregressive"].update(quant_weights=True, mel_length_compression=1024)
    assert type(check.Judge(config, SEED, "cpu").model("autoregressive")) \
        is unified_voice.UnifiedVoice


@pytest.mark.parametrize("entry", ENTRIES)
def test_k2_launches_once_a_decode_step(served, entry):
    for s in served[entry, True]:
        assert s.ar_steps == s.k2_steps > 0


@pytest.mark.parametrize("entry", ENTRIES)
def test_the_layer_stack_counts_its_decode_steps(served, entry):
    config, mix = load(entry)
    for fused, stack in zip(served[entry, True], served[entry, False]):
        assert stack.request.index == fused.request.index
        assert stack.k2_steps == 0 and stack.ar_steps == fused.ar_steps
        assert counts.request_ops(stack, mix, config) == counts.request_ops(fused, mix, config)


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_decode_step_count_that_misses_what_was_served_is_off(served, entry):
    config, mix = load(entry)
    for fused in (True, False):
        assert check.structure(served[entry, fused], mix, config) == (0, [])
    s = served[entry, True][0]
    off, lines = check.structure([dataclasses.replace(s, ar_steps=s.ar_steps - s.batches)],
                                 mix, config)
    assert off == 1 and "AR decode steps" in lines[0]


@pytest.mark.parametrize("entry", ENTRIES)
def test_request_ops_is_gpt2s_formula(served, entry):
    config, mix = load(entry)
    for s in served[entry, True]:
        assert counts.request_ops(s, mix, config) == gpt2_ops(s, mix, config)


def test_a_new_reference_module_needs_new_files_only(monkeypatch, served):
    calls = []

    class Prior(unified_voice.UnifiedVoice):
        pass

    def trunk_ops(ar, batch, new, context):
        calls.append(("trunk", batch, new, context))
        return unified_voice.trunk_ops(ar, batch, new, context)

    def conditioning_ops(ar, frames, clips):
        calls.append(("conditioning", frames, clips))
        return unified_voice.conditioning_ops(ar, frames, clips)

    prior = _reference_module(monkeypatch, "TinyPrior")
    prior.build = lambda ar: Prior(unified_voice.config(ar))
    prior.trunk_ops, prior.conditioning_ops = trunk_ops, conditioning_ops
    config, mix = load("preset")
    config["reference"] = {"autoregressive": "tiny_prior"}

    judge = check.Judge(config, SEED, "cpu")
    ar = judge.model("autoregressive")
    assert type(ar) is Prior and "TinyPrior" in judge.specs
    # the codes it names are suppressed under its own class name
    param, indices, value = unified_voice.SUPPRESSED
    assert (ar.state_dict()[param][list(indices)] == value).all()
    assert system.made(config) == ("TinyPrior",) + system.MADE
    s = served["preset", True][0]
    assert counts.request_ops(s, mix, config) == gpt2_ops(s, mix, config)
    prompt = counts.prompt_len(s.request.texts[0])
    steps = s.ar_steps // s.batches
    assert s.batches == 2 and steps > 0
    assert calls == [("trunk", 1, prompt, 0)] \
        + [("trunk", s.batch, 1, prompt + i) for i in range(steps)] \
        + [("conditioning", counts.COND_FRAMES, len(system.load_clips(s.request.voices[0]))),
           ("trunk", 1, prompt + steps + 2, 0)]


def _reference_module(monkeypatch, name: str, **attrs):
    """A reference module that only the test provides, as
    ``portbench.reference.tiny_prior``: UnifiedVoice's interface under
    another ``NAME``, with ``attrs`` over it."""
    module = types.ModuleType("portbench.reference.tiny_prior")
    for key in ("PROGRAM_CONFIG", "SUPPRESSED", "build", "trunk_ops", "conditioning_ops"):
        setattr(module, key, getattr(unified_voice, key))
    module.NAME = name
    for key, value in attrs.items():
        setattr(module, key, value)
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return module


def test_the_driver_builds_the_program_config_the_reference_names(monkeypatch):
    from tortoise_tpu_torch.models import autoregressive

    class TinyPriorConfig(autoregressive.UnifiedVoiceConfig):
        pass

    monkeypatch.setattr(autoregressive, "TinyPriorConfig", TinyPriorConfig, raising=False)
    _reference_module(monkeypatch, "UnifiedVoice",
                      PROGRAM_CONFIG="tortoise_tpu_torch.models.autoregressive:TinyPriorConfig")
    config, mix = load("stream")
    config["reference"] = {"autoregressive": "tiny_prior"}
    assert system.program_ar_config(config) is TinyPriorConfig
    _, _, options, _ = tiny("stream")
    driver = system.Driver(config, mix, SEED, "cpu", options)
    try:
        ar = driver.tts.autoregressive
        assert type(ar.config) is TinyPriorConfig
        assert driver.specs["UnifiedVoice"] == check.Judge(config, SEED, "cpu").specs["UnifiedVoice"]
        param, indices, value = unified_voice.SUPPRESSED
        assert (ar.state_dict()[param][list(indices)].float() == value).all()
    finally:
        driver.close()


@pytest.mark.parametrize("path", ["tortoise_tpu.models.autoregressive:UnifiedVoiceConfig",
                                  "tortoise_tpu_torch.models.autoregressive"])
def test_a_program_config_outside_the_port_is_refused(monkeypatch, path):
    _reference_module(monkeypatch, "UnifiedVoice", PROGRAM_CONFIG=path)
    config, _ = load("stream")
    config["reference"] = {"autoregressive": "tiny_prior"}
    with pytest.raises(ValueError, match="PROGRAM_CONFIG"):
        system.program_ar_config(config)


def test_a_suppressed_parameter_the_prior_lacks_fails(monkeypatch):
    _reference_module(monkeypatch, "TinyPrior", SUPPRESSED=("lm_head.bias", (83, -2, -1), -30.0))
    config, _ = load("stream")
    config["reference"] = {"autoregressive": "tiny_prior"}
    with pytest.raises(ValueError, match="lm_head.bias"):
        check.Judge(config, SEED, "cpu")
    with pytest.raises(ValueError, match="lm_head.bias"):
        bench_weights.make("TinyPrior", [("mel_head.bias", (8, ), None)], SEED, "cpu",
                           ("lm_head.bias", (1, ), -30.0))
