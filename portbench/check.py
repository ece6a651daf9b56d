"""The comparison that decides ``correct``: what the timed path served,
judged by the plain reference (``portbench/reference``), which imports
nothing of the program and makes its weights from the run's seed.

The numbers compared (each with its limit in ``limits/<cell>.json``):

* ``ar_gap``: over the judged greedy requests, the widest gap by which a
  served token's logit lies below the reference's best at its position
  (the configuration's AR reference, UnifiedVoice unless it names another,
  in float32 over the request's prompt and served tokens, the conditioning
  latent worked out again from the voice's clips). Tokens after a
  candidate's stop token are forced, not chosen, and left out.
* ``latent_err``: the relative L2 error of the latent re-extraction (the
  quality pipeline's winner, ``tts_batch``'s utterances) against the
  reference's latents of the same codes.
* ``clvp_err``: over the judged sampled quality requests, the widest gap
  between the program's CLVP score of a candidate and the reference's,
  over the spread of the reference's scores of the request's candidates.
* ``conditioning_err``: the relative L2 error of the diffusion's voice
  latent (from the conditioning mels the program made of the clips), of
  its aligned embeddings (from the re-extracted latents and that voice
  latent) and of the guidance's unconditioned input.
* ``hifigan_err``, ``diffusion_err``, ``vocoder_err``: the relative L2
  error of each HiFi-GAN decode, of three diffusion steps (over the valid
  frames) and of UnivNet's stages, the reference evaluating each on the
  inputs the program gave it. These follow the program's own state: the
  sampler's noise cannot be drawn again outside it, and the decoder's
  inputs are checked by the numbers above.
* ``sampler_err``: the relative L2 error of the mel UnivNet was given
  against the reference's last sampler step (guidance, x0 clipped,
  posterior mean, denormalized) from that step's input and model output.
* ``structure_off``: an exact count of what the served requests did that
  the request did not ask for (``structure``): audio of another length
  than its mel tokens give, decode steps counted other than those tokens
  took (so that ``mfu`` counts every one), another number of diffusion
  steps or candidates, timesteps off the schedule, candidates scored other
  than the reference fixes them, a winner that is not the best scored,
  another trim, a served wav that is not the judged decoder's output,
  stream chunks that are not slices of the judged window decodes.

``numbers(..., control=True)`` computes the same numbers (all but
``structure_off``) with the reference in the precision below the
configuration's put in the program's place: the control (``BELOW``).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import reference
from portbench import weights as bench_weights
from portbench.reference import sampler as ref_sampler
from portbench.reference.clvp import CLVP
from portbench.reference.diffusion import DiffusionTts
from portbench.reference.hifigan import Hifigan
from portbench.reference.layers import fp8_round, set_precision
from portbench.reference.text import Tokenizer, conditioning_mels
from portbench.reference.univnet import UnivNet
from portbench.system import load_clips, voice_seed

# the step below each precision a configuration states (the control's); the
# sampler's elementwise float32 arithmetic has no TF32: its step is bfloat16
BELOW = {"bf16": "fp8", "f32": "tf32"}


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref||; inf where the shapes differ."""
    if a.shape != ref.shape:
        return float("inf")
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp_min(1e-30))


def natural_length(codes: np.ndarray, stop: int) -> int:
    """Tokens up to and with the first stop token (all without one)."""
    idx = np.where(codes == stop)[0]
    return int(idx[0]) + 1 if len(idx) else len(codes)


def bucketed(ids: list[list[int]], bucket: int, max_text: int) -> torch.Tensor:
    """Text rows as the API holds them: each row's ids and a stop token,
    padded with stop tokens (0) to the longest row, rounded up to
    ``bucket`` (0: not rounded) within the position table."""
    n = max(len(i) for i in ids) + 1
    tb = max(min(-(-n // bucket) * bucket, max_text), n) if bucket else n
    out = torch.zeros((len(ids), tb), dtype=torch.long)
    for r, row in enumerate(ids):
        out[r, :len(row)] = torch.as_tensor(row)
    return out


class Judge:
    """The reference models of one configuration, with the run's weights;
    the AR prior's is the one the configuration names
    (``reference.autoregressive``)."""

    def __init__(self, config: dict, seed: int, device):
        self.config, self.seed, self.device = config, int(seed), device
        ar = config["autoregressive"]
        ar_ref = reference.autoregressive(config)
        prior = ar_ref.build(ar)
        self.ar_cfg = prior.config
        self.tok = Tokenizer()
        self.models = {"autoregressive": (ar_ref.NAME, prior)}
        if config["api"] == "fast":
            self.models["hifigan"] = ("HifiganGenerator",
                                      Hifigan(ar["model_dim"],
                                              config["hifigan"]["upsample_initial_channel"]))
        else:
            d = config["diffusion"]
            self.models["diffusion"] = ("DiffusionTts", DiffusionTts(
                d["model_channels"], d["num_layers"], d["num_heads"], d["in_latent_channels"]))
            self.models["vocoder"] = ("UnivNetGenerator", UnivNet())
            c = config["clvp"]
            self.models["clvp"] = ("CLVP", CLVP(c["dim_text"], c["text_enc_depth"],
                                                c["text_heads"], c.get("num_text_tokens", 256),
                                                c.get("num_speech_tokens", 8192)))
        self.specs = {}
        for key, (name, model) in self.models.items():
            model.to(device).eval()
            self.specs[name] = bench_weights.fill(
                model, name, seed, ar_ref.SUPPRESSED if key == "autoregressive" else None)
        self._cond = {}

    def model(self, key: str):
        return self.models[key][1]

    def set_precision(self, control: bool):
        for key, (_, model) in self.models.items():
            stated = self.config["precision"][key]
            set_precision(model, BELOW[stated] if control else "f32")

    # -- inputs worked out again ---------------------------------------
    def cond(self, voice: str, crop_seed: int, control: bool = False):
        """The AR conditioning latent (1, D) of a voice's clips, cropped as
        ``crop_seed`` draws, in the reference's or the control's precision."""
        key = (voice, crop_seed, control)
        if key not in self._cond:
            mels = conditioning_mels(load_clips(voice), crop_seed, self.device)
            self.set_precision(control)
            self._cond[key] = self.model("autoregressive").conditioning(mels)
            self.set_precision(False)
        return self._cond[key]

    def conds(self, voices, crop_seeds, control: bool = False):
        return torch.cat([self.cond(v, c, control) for v, c in zip(voices, crop_seeds)])

    def texts(self, texts: list[str], bucket: int) -> torch.Tensor:
        return bucketed([self.tok.encode(t) for t in texts], bucket,
                        self.ar_cfg.max_text_tokens).to(self.device)

    def _forward(self, cond, text, codes, served_positions: bool, control: bool):
        self.set_precision(control)
        out = self.model("autoregressive").teacher_forced(
            cond, text, torch.as_tensor(codes, device=self.device).long(), served_positions)
        self.set_precision(False)
        return out

    # -- the numbers ---------------------------------------------------
    def _gap(self, logits, chosen, codes: np.ndarray) -> float:
        """Widest gap between the best logit and the chosen token's, each
        row judged to its natural length."""
        gap = logits.max(-1).values - logits.gather(-1, chosen[..., None])[..., 0]
        return max(float(gap[r, :natural_length(codes[r], self.ar_cfg.stop_mel_token)].max())
                   for r in range(codes.shape[0]))

    def _ar(self, voices, crop_seeds, text, codes, served_positions, control):
        """(ar_gap, the reference's latents, the latents in the judged
        side's precision: the program's are not known here, so the
        reference's stand in outside the control)."""
        cond = self.conds(voices, crop_seeds)
        logits, lat = self._forward(cond, text, codes, served_positions, False)
        if not control:
            chosen = torch.as_tensor(codes, device=self.device).long()
            return self._gap(logits, chosen, codes), lat, lat
        low_cond = self.conds(voices, crop_seeds, True)
        low_logits, low_lat = self._forward(low_cond, text, codes, served_positions, True)
        return self._gap(logits, low_logits.argmax(-1), codes), lat, low_lat

    @torch.no_grad()
    def numbers(self, served: list, mix: dict, control: bool = False) -> dict:
        """The numbers over the judged requests ``served``; with
        ``control`` the lower-precision reference is the judged side."""
        judge = {"tts_batch": self._judge_batch, "tts_stream": self._judge_stream,
                 "tts_with_preset": self._judge_quality}[mix["entry"]]
        out: dict[str, float] = {}
        self.mix = mix

        def worst(name, value):
            out[name] = max(out.get(name, 0.0), value)

        for s in served:
            judge(s, s.request, control, worst)
        return out

    def _judge_stream(self, s, req, control, worst):
        voices, seeds = req.voices, [voice_seed(self.seed, req.voices[0])]
        if req.greedy:
            text = self.texts(req.texts, self.config["text_bucket"])
            gap, _, _ = self._ar(voices, seeds, text, np.asarray(s.codes)[None], True, control)
            worst("ar_gap", gap)
        self._judge_hifigan(s.record["hifigan"], control, worst)

    def _judge_batch(self, s, req, control, worst):
        rec = s.record["relatent"][0]
        codes = rec["codes"]
        seeds = [voice_seed(self.seed, v) for v in req.voices]
        text = self.texts(req.texts, self.config.get("batch_text_bucket", 64))
        if req.greedy:
            gap, _, _ = self._ar(req.voices, seeds, text, codes, True, control)
            worst("ar_gap", gap)
        _, lat, low_lat = self._ar(req.voices, seeds, text, codes, False, control)
        worst("latent_err", rel_err(low_lat if control else rec["latents"].to(self.device), lat))
        self._judge_hifigan(s.record["hifigan"], control, worst)

    def _judge_hifigan(self, decodes, control, worst):
        """Each HiFi-GAN decode of the request from the frames the program
        interpolated: its valid frames decoded alone are what the program's
        masked decode gives there."""
        hifi = self.model("hifigan")
        low = BELOW[self.config["precision"]["hifigan"]]
        for d in decodes:
            n = d["x"].shape[1] if d["valid"] is None else int(d["valid"])
            if n == 0:
                continue
            x, g = d["x"][:, :n].to(self.device), d["g"].to(self.device)
            ref = hifi.decode(x, g)
            if control:
                set_precision(hifi, low)
                got = hifi.decode(x, g)
                set_precision(hifi, "f32")
            else:
                got = d["out"][:, :n * 256, 0].to(self.device)
            worst("hifigan_err", rel_err(got, ref))

    def _judge_quality(self, s, req, control, worst):
        # a request's clips condition it, cropped as its seed draws
        voices, seeds = req.voices, [req.seed]
        text = self.texts(req.texts, self.config["text_bucket"])
        if req.greedy:
            rows = np.unique(np.asarray(s.codes), axis=0)
            gap, _, _ = self._ar(voices * len(rows), seeds * len(rows),
                                 text.expand(len(rows), -1), rows, True, control)
            worst("ar_gap", gap)
        for r in s.record["relatent"]:
            _, lat, low_lat = self._ar(voices, seeds, text, r["codes"], False, control)
            got = low_lat if control else r["latents"].to(self.device)
            worst("latent_err", rel_err(got, lat))
        self._judge_clvp(s.record["clvp"], control, worst)
        self._judge_conditioning(s.record, req, control, worst)
        diff = self.model("diffusion")
        for step in s.record["diffusion"]:
            args = [step[k].to(self.device) for k in ("x", "t", "aligned", "valid_len")]
            ref = diff.step(*args)
            if control:
                set_precision(diff, BELOW[self.config["precision"]["diffusion"]])
                got = diff.step(*args)
                set_precision(diff, "f32")
            else:
                got = step["out"].to(self.device)
            worst("diffusion_err", max(
                rel_err(got[b, :v], ref[b, :v]) for b, v in enumerate(args[3].tolist())))
        self._judge_sampler(s.record, req, control, worst)
        self._judge_vocoder(s.record, control, worst)

    def _judge_clvp(self, calls, control, worst):
        """The program's CLVP scores of the candidates it scored against the
        reference's (greedy requests' candidates are all alike: no spread)."""
        clvp = self.model("clvp")
        for c in calls:
            text, cands = c["text"].to(self.device), c["candidates"].to(self.device)
            ref = clvp.scores(text, cands)
            if control:
                set_precision(clvp, BELOW[self.config["precision"]["clvp"]])
                got = clvp.scores(text, cands)
                set_precision(clvp, "f32")
            else:
                got = c["scores"].to(self.device).float()
            finite = torch.isfinite(ref)
            if not torch.equal(finite, torch.isfinite(got)):
                worst("clvp_err", float("inf"))
                continue
            spread = float(ref[finite].max() - ref[finite].min()) if finite.any() else 0.0
            if spread > 0:
                worst("clvp_err", float((got[finite] - ref[finite]).abs().max()) / spread)

    def _judge_conditioning(self, rec, req, control, worst):
        """The diffusion's voice latent from the conditioning mels the
        program made, its aligned embeddings from the re-extracted latents
        (judged by ``latent_err``) and that voice latent, and, guided, the
        unconditioned half of the model's conditioning input."""
        diff = self.model("diffusion")
        low = BELOW[self.config["precision"]["diffusion"]]

        def judged(fn, program_out):
            ref = fn()
            if not control:
                return rel_err(program_out.to(self.device), ref)
            set_precision(diff, low)
            got = fn()
            set_precision(diff, "f32")
            return rel_err(got, ref)

        d = lambda t: t.to(self.device)
        for v in rec["voice"]:
            worst("conditioning_err", judged(lambda: diff.voice_latent(d(v["mels"])),
                                             v["latent"]))
        for a in rec["aligned"]:
            worst("conditioning_err", judged(
                lambda: diff.aligned(d(a["latents"]), d(a["voice"]), a["out"].shape[1]),
                a["out"]))
        if ref_sampler.settings(req.kwargs(self.mix))["cond_free"]:
            for step in rec["diffusion"][:1]:
                rows, frames = step["x"].shape[0] // 2, int(step["valid_len"][0])
                uncond = diff.unconditioned_embedding.float().expand(rows, frames, -1)
                worst("conditioning_err", rel_err(
                    d(step["aligned"][rows:, :frames]),
                    fp8_round(uncond) if control else uncond))

    def _judge_sampler(self, rec, req, control, worst):
        """The mel UnivNet was given against the reference's last sampler
        step from that step's recorded input and model output (the control:
        the same step in bfloat16)."""
        st = ref_sampler.settings(req.kwargs(self.mix))
        last = [d for d in rec["diffusion"] if d["index"] == st["diffusion_iterations"] - 1]
        if not last or not rec["vocoder"]:
            return
        d, v = last[0], rec["vocoder"][0]
        frames = v["mel"].shape[1] - 10          # UnivNet's input holds 10 pad frames

        def mel(dtype):
            x, out = d["x"].to(self.device, dtype), d["out"].to(self.device, dtype)
            step = ref_sampler.last_step(x, out, st["cond_free"], st["cond_free_k"],
                                         st["diffusion_iterations"], 1, dtype)
            return ref_sampler.denormalize(step.float())[:, :frames]

        ref = mel(torch.float32)
        got = mel(torch.bfloat16) if control else v["mel"][:, :frames].to(self.device)
        worst("sampler_err", rel_err(got, ref))

    def _judge_vocoder(self, rec, control, worst):
        """UnivNet stage by stage from the program's own inputs: the noise's
        conv into the first block, each LVC block, and the output conv from
        the last block's output (a random UnivNet amplifies an f32 rounding
        difference ~1e5 times over its twelve layers, so the whole decode is
        no steady number)."""
        voc = self.model("vocoder")
        low = BELOW[self.config["precision"]["vocoder"]]
        blocks = {b["block"]: b for b in rec["lvc"]}
        last = len(blocks) - 1
        for v in rec["vocoder"]:
            d = lambda t: t.to(self.device)
            stages = [(lambda: voc.pre(d(v["z"])), blocks[0]["x"])]
            for i, b in blocks.items():
                stages.append((lambda b=b, i=i: getattr(voc, f"lvc_{i}")(d(b["x"]), d(b["mel"])),
                               b["out"]))
            stages.append((lambda: voc.post(d(blocks[last]["out"])), v["out"][..., 0]))
            for fn, program_out in stages:
                ref = fn()
                if control:
                    set_precision(voc, low)
                    got = fn()
                    set_precision(voc, "f32")
                else:
                    got = d(program_out)
                worst("vocoder_err", rel_err(got, ref))


def structure(served: list, mix: dict, config: dict) -> tuple[int, list[str]]:
    """What the served requests did that they did not ask for, counted
    exactly (``structure_off``), and a line for each. Every request: its wavs
    hold the samples its mel tokens give, each decode batch took a decode
    step (``ar_steps``) for each of those tokens but the one its prefill
    samples, and a quality request ran its preset's diffusion steps on the
    guided (doubled) batch. A judged request
    (its record kept): the timesteps of the spaced schedule, the candidates
    CLVP scored (as many as asked, fixed as the reference fixes the raw
    ones, against the text's tokens), the re-extracted winner among the best
    scored, the diffusion's frames from its calm trim, and a served wav that
    is the judged decoder's output, or, streamed, slices of the judged
    window decodes at their places."""
    out: list[str] = []
    stop = config["autoregressive"].get("stop_mel_token", 8193)
    tok = Tokenizer()
    for s in served:
        req = s.request
        want = ref_sampler.frames(req.mel_tokens) * 256
        if s.wav_lengths != [want] * len(req.texts):
            out.append(f"request {req.index}: wav samples {s.wav_lengths}, "
                       f"{len(req.texts)} x {want} asked")
        steps = s.batches * (req.mel_tokens - 1)
        if s.ar_steps != steps:
            out.append(f"request {req.index}: {s.ar_steps} AR decode steps counted, "
                       f"{s.batches} x {req.mel_tokens - 1} served")
        if mix["entry"] == "tts_with_preset":
            _quality_structure(s, req, mix, stop, tok, out)
        elif s.record is not None:
            _fast_structure(s, req, mix, out)
    return len(out), out


def _quality_structure(s, req, mix, stop, tok, out):
    st = ref_sampler.settings(req.kwargs(mix))
    n, rows = st["diffusion_iterations"], 2 if st["cond_free"] else 1
    calls = s.diffusion_calls
    if len(calls) != n or any(c[0] != rows for c in calls):
        out.append(f"request {req.index}: {len(calls)} diffusion calls of batches "
                   f"{sorted({c[0] for c in calls})}, {n} of {rows} asked")
    rec = s.record
    if rec is None:
        return
    if rec["t"] != ref_sampler.spaced_timesteps(n)[::-1]:
        out.append(f"request {req.index}: timesteps {rec['t'][:4]}... off the schedule")
    if len(rec["clvp"]) != 1 or len(rec["relatent"]) != 1 or not rec["vocoder"]:
        out.append(f"request {req.index}: {len(rec['clvp'])} CLVP calls, "
                   f"{len(rec['relatent'])} re-extractions, {len(rec['vocoder'])} vocoder calls")
        return
    c = rec["clvp"][0]
    raw = np.asarray(s.codes)
    fixed = np.stack([ref_sampler.fix_codes(r, stop) for r in raw])
    cands, scores = c["candidates"].numpy(), c["scores"].numpy()
    text = np.asarray([tok.encode(req.texts[0]) + [0]])
    if len(raw) != st["num_autoregressive_samples"] or not np.array_equal(cands, fixed) \
            or not np.array_equal(c["text"].numpy(), text):
        out.append(f"request {req.index}: CLVP scored {cands.shape} candidates, "
                   f"{st['num_autoregressive_samples']} fixed ones asked, or another text")
        return
    winner = rec["relatent"][0]["codes"][0]
    best = np.flatnonzero(scores == scores.max())
    if not any(np.array_equal(winner, cands[j]) for j in best):
        out.append(f"request {req.index}: the re-extracted codes are no best-scored candidate")
    frames = ref_sampler.frames(ref_sampler.calm_trim(winner))
    if any(d["valid_len"].tolist() != [frames] * rows for d in rec["diffusion"]):
        out.append(f"request {req.index}: diffusion frames off the winner's calm trim {frames}")
    v = rec["vocoder"][0]["out"]
    if not torch.equal(s.wavs[0], v[0, :-2560, 0].clamp(-1, 1)):
        out.append(f"request {req.index}: the served wav is not UnivNet's output")


def _fast_structure(s, req, mix, out):
    decodes = s.record["hifigan"]
    if mix["entry"] == "tts_batch":
        if len(decodes) != len(s.wavs) or not all(
                torch.equal(w, d["out"][0, :len(w), 0]) for w, d in zip(s.wavs, decodes)):
            out.append(f"request {req.index}: the served wavs are not the judged decodes")
        return
    wav = s.wavs[0]
    matched = torch.zeros(len(wav), dtype=torch.bool)
    for d in decodes:
        if d["u_start"] is None:
            continue
        a = d["u_start"] * 256
        valid = d["x"].shape[1] if d["valid"] is None else int(d["valid"])
        seg = d["out"][0, :valid * 256, 0][:max(0, len(wav) - a)]
        matched[a:a + len(seg)] |= wav[a:a + len(seg)] == seg
    if not decodes or not bool(matched.all()):
        out.append(f"request {req.index}: {int((~matched).sum())} of {len(wav)} streamed "
                   "samples are no judged window decode's at their place")


def decide(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """``correct`` and the lines that print each number beside its limit.
    A number with a limit and no reading (nothing to judge) fails."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value <= limit
        ok = ok and good
        lines.append(f"{name} {value!r} limit {limit!r} {'ok' if good else 'FAIL'}")
    return ok, lines
