"""Quality TTS pipeline: AR candidates -> CLVP re-rank -> diffusion -> UnivNet.

Port of ``tortoise_tpu/api.py::TextToSpeech`` (reference tortoise/api.py).
Stages of ``tts``: BPE tokens; conditioning latents from the voice clips;
batched AR candidate decode (kernel K2 per step on CUDA); stop-token repair
and CLVP re-ranking; teacher-forced latent re-extraction for the winners;
DiffusionTts sampling (kernel K3 in its 13 per-step attention blocks on
CUDA); UnivNet vocoding (kernel K4 in its 12 location-variable
convolutions on CUDA); redaction of ``[bracketed]`` text by the wav2vec2
aligner. With K2 off (``gpt_fused_step=False``, the only
decode for ``kv_cache_dtype="f32"``) each decode step runs the layer stack,
whose per-layer attention is kernel K1 on CUDA.

Options as in the JAX package: ``kv_cache_dtype="int8"`` (int8 rows plus
f32 scales, about 0.53x the bf16 cache's bytes per candidate) and
``gpt_weights`` "bf16" | "int8" (int8 block denses everywhere) |
"int8_decode" (bf16 model, int8 weights only in K2's stack); ``tts``
without a voice draws random voice latents; ``cvvp_amount`` mixes CVVP's
scores into CLVP's. Module level: ``classify_audio_clip`` (the
Tortoise-detect classifier), ``load_discrete_vocoder_diffuser`` and
``pad_or_truncate``, as in the reference's api.

``mesh`` (``parallel.mesh.make_mesh``: every rank of a torch.distributed
group constructs the pipeline and makes the same ``tts`` calls) splits the
request as the JAX package's mesh does: the weights are broadcast from the
first rank, and with tp > 1 UnifiedVoice's are split Megatron-style; each
batch of candidates decodes over dp with the GPT's heads and cache over tp
(K2 off, K1 in every layer); CLVP scores the candidates over dp; k > 1
winners diffuse over dp when k divides by it. Codes, scores and mels are
gathered, and every rank returns the same audio.

``ar_config`` chooses the AR prior: a ``UnifiedVoiceConfig`` (the default)
or a ``models.granite_hybrid.GraniteVoiceConfig``, the Granite-4.0-H hybrid
of Mamba-2 and attention layers, which decodes with its own cache and
step (K2 off), in bf16, with no mesh and no int8 option.
"""
from __future__ import annotations

import logging
import random
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.diffusion.schedule import spaced_schedule
from tortoise_tpu_torch.diffusion.sampler import (SamplerConfig, ddim_sample_loop,
                                                  p_sample_loop)
from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
from tortoise_tpu_torch.models.classifier import ClassifierConfig
from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig
from tortoise_tpu_torch.models.clvp import config_for_tree as clvp_config_for_tree
from tortoise_tpu_torch.models.cvvp import CVVP, CVVPConfig
from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
from tortoise_tpu_torch.models.random_latent import RandomLatentConverter, sample_random_latent
from tortoise_tpu_torch.models.vocoder import UnivNetConfig, UnivNetGenerator
from tortoise_tpu_torch.ops import mel as mel_ops
from tortoise_tpu_torch.ops.decode_step import prepare_stacked_params, quantize_gpt_denses
from tortoise_tpu_torch.parallel.mesh import (batch_sharding, draw_rows, replicate_tree,
                                              replicated)
from tortoise_tpu_torch.parallel.sharding import (KVCacheSharding, gather_rows,
                                                  shard_unified_voice)
from tortoise_tpu_torch.presets import QUALITY_PRESETS, resolve_preset
from tortoise_tpu_torch.utils import audio as audio_utils
from tortoise_tpu_torch.utils.audio import deterministic_state, format_conditioning
from tortoise_tpu_torch.utils import profiling
from tortoise_tpu_torch.utils.tokenizer import VoiceBpeTokenizer
from tortoise_tpu_torch.utils.wav2vec_alignment import Wav2VecAlignment

CALM_TOKEN = 83  # mel code for silence (reference api.py:409)
# T = 1024 cache rows cover the longest prompt of the shipped config plus 500
# mel tokens, padded to a multiple of 256 as the sampler pads it
_SIZING_CACHE_ROWS = 1024
KV_CACHE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}


def kv_cache_bytes_per_candidate(config: UnifiedVoiceConfig, rows: int,
                                 kv_cache_dtype: torch.dtype) -> int:
    """One candidate's KV cache: 2 (k, v) x L x rows x C values, plus with
    int8 the two f32 scale slabs, 2 x L x H x rows (about 0.53x bf16)."""
    per = 2 * config.layers * rows * config.model_dim \
        * torch.empty((), dtype=kv_cache_dtype).element_size()
    if kv_cache_dtype == torch.int8:
        per += 2 * config.layers * config.heads * rows * 4
    return per


def pick_best_batch_size_for_device(device, config: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                                    kv_cache_dtype: torch.dtype = torch.bfloat16) -> int:
    """Candidates decoded at once. CUDA: half the free device memory
    (``torch.cuda.mem_get_info``) over one candidate's cache bytes at
    T = 1024, rounded down to a power of two and kept within [1, 128], or
    [1, 256] for the int8 cache (at 80 GB: 128 and 256, the JAX package's
    tiers for 30 GB and up, which double for int8). The hybrid prior's
    candidate holds its SSM, conv and attention state
    (``GraniteVoiceConfig.cache_bytes_per_candidate``, 47.1 MB at its
    published sizes). CPU: 32, the reference's default."""
    device = torch.device(device)
    if device.type != "cuda":
        b = 32
    else:
        free, _ = torch.cuda.mem_get_info(device)
        per = kv_cache_bytes_per_candidate(config, _SIZING_CACHE_ROWS, kv_cache_dtype) \
            if isinstance(config, UnifiedVoiceConfig) else config.cache_bytes_per_candidate()
        fit = max(1, (free // 2) // per)
        cap = 256 if kv_cache_dtype == torch.int8 else 128
        b = min(cap, 1 << (int(fit).bit_length() - 1))
    logging.getLogger(__name__).info("autoregressive_batch_size=%d on %s", b, device)
    return b


def load_autoregressive(config: UnifiedVoiceConfig, gpt_weights: str, device, dtype,
                        models_dir, allow_random: bool, fused: bool, mesh=None,
                        split: bool = False):
    """UnifiedVoice with its weights (seed 0 when random), cast to ``dtype``,
    and K2's weight stack when ``fused``. Returns (model, source, stack or
    None). ``gpt_weights``: "bf16"; "int8", QuantDense block denses
    throughout and an int8 stack; "int8_decode", a full-precision model
    whose stack alone is int8, quantized from the f32 weights before the
    cast, as the JAX package's ``int8_decode`` does. With ``mesh`` the
    weights are broadcast from its first rank, and with ``split`` this
    rank's tp part of them kept (``parallel.sharding``). A
    ``GraniteVoiceConfig`` builds the hybrid prior (its module imported only
    then), with no stack: its own decode step."""
    if not isinstance(config, UnifiedVoiceConfig):
        return _load_hybrid(config, gpt_weights, device, dtype, allow_random, fused, mesh)
    cfg = weights_lib.resolve_gpt_quant(config, gpt_weights)
    with torch.device(device):
        model = UnifiedVoice(cfg)
    source = weights_lib.load_weights("autoregressive", model, models_dir, allow_random, 0)
    quantized = quantize_gpt_denses(model.gpt) if fused and gpt_weights == "int8_decode" \
        else None
    model = weights_lib.cast_for_inference(model, dtype).eval()
    if mesh is not None:
        replicate_tree(model, mesh)
        if split:
            shard_unified_voice(model, mesh)
    return model, source, (prepare_stacked_params(model.gpt, quantized) if fused else None)


def _load_hybrid(config, gpt_weights: str, device, dtype, allow_random: bool, fused: bool,
                 mesh):
    """The Granite-4.0-H hybrid prior, seeded random (no checkpoint format
    exists for it), cast to ``dtype``.
    It has no K2 stack, no tp split and no int8 denses: those options raise."""
    from tortoise_tpu_torch.models import granite_hybrid

    if mesh is not None:
        raise ValueError("mesh: the hybrid AR prior (GraniteVoiceConfig) does not run under a "
                         "mesh")
    if gpt_weights != "bf16":
        raise ValueError(f"gpt_weights={gpt_weights!r}: the hybrid AR prior "
                         "(GraniteVoiceConfig) has no int8 weights; pass 'bf16'")
    if fused:
        raise ValueError("gpt_fused_step: kernel K2 decodes GPT-2 only; the hybrid AR prior "
                         "(GraniteVoiceConfig) decodes with its own step (leave it None)")
    if not allow_random:
        raise FileNotFoundError("no checkpoint format exists for the hybrid AR prior "
                                "(GraniteVoiceConfig): it runs on random weights only")
    with torch.device(device):
        model = granite_hybrid.GraniteVoice(config)
    warnings.warn("no checkpoint for the hybrid AR prior; using random weights (seed 0): "
                  "the audio will be noise", stacklevel=3)
    weights_lib.init_random(model, 0)
    model = weights_lib.cast_for_inference(model, dtype).eval()
    return model, "random", None


def load_random_latent_converter(name: str, channels: int, device, models_dir,
                                 allow_random: bool, seed: int,
                                 mesh=None) -> RandomLatentConverter:
    with torch.device(device):
        model = RandomLatentConverter(channels)
    weights_lib.load_weights(name, model, models_dir, allow_random, seed)
    return (model if mesh is None else replicate_tree(model, mesh)).eval()


def fix_autoregressive_output(codes: np.ndarray, stop_token: int,
                              complain: bool = True) -> np.ndarray:
    """Stop tokens -> the calm token, and the DVAE tail codes 45, 45, 248
    (reference api.py:87-114; copied from tortoise_tpu/api.py, which imports jax)."""
    idx = np.where(codes == stop_token)[0]
    if len(idx) == 0:
        if complain:
            print("No stop tokens found in one of the generated voice clips. This "
                  "typically means the spoken audio is too long. In some cases, the "
                  "output will still be good, though. Listen to it and if it is "
                  "missing words, try breaking up your input text.")
        return codes
    codes = codes.copy()
    codes[idx] = CALM_TOKEN
    stm = int(idx.min())
    codes[stm:] = CALM_TOKEN
    if stm - 3 < codes.shape[0]:
        codes[-3] = 45
        codes[-2] = 45
        codes[-1] = 248
    return codes


def calm_token_trim_length(codes: np.ndarray) -> int:
    """Latent length up to where more than 8 consecutive calm tokens appear
    (reference api.py:547-556)."""
    ctokens = 0
    for k in range(codes.shape[-1]):
        ctokens = ctokens + 1 if codes[k] == CALM_TOKEN else 0
        if ctokens > 8:
            return k
    return codes.shape[-1]


class TextToSpeech:
    """Quality-path orchestrator (reference api.TextToSpeech) on an explicit
    torch device."""

    LATENT_BUCKET = 64  # diffusion latents pad to a multiple of this

    def __init__(self, autoregressive_batch_size=None, models_dir=None,
                 enable_redaction=True, kv_cache=True, half=True, device="cuda",
                 tokenizer_vocab_file=None, tokenizer_basic=False,
                 allow_random_weights=True, text_bucket: int = 32, kv_cache_dtype="bf16",
                 gpt_weights="bf16", gpt_fused_step: bool | None = None,
                 flash_attn: bool | None = None,
                 ar_config: UnifiedVoiceConfig | None = None,
                 diffusion_config: DiffusionTtsConfig | None = None,
                 clvp_config: CLVPConfig | None = None, mesh=None):
        del kv_cache  # reference API compatibility: the cache is always on
        # UnivNet runs in float32 as in the JAX package: no TF32
        self.device = weights_lib.float32_device(device)
        is_cuda = self.device.type == "cuda"
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: one of "
                             f"{tuple(KV_CACHE_DTYPES)}")
        self.kv_cache_dtype = KV_CACHE_DTYPES[kv_cache_dtype]
        self.dtype = torch.bfloat16 if half else torch.float32
        hybrid = ar_config is not None and not isinstance(ar_config, UnifiedVoiceConfig)
        if hybrid and kv_cache_dtype != "bf16":
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}: the hybrid AR prior "
                             "(GraniteVoiceConfig) keeps its cache in its weights' dtype; "
                             "pass 'bf16'")
        if hybrid and is_cuda and not half:
            raise ValueError("half=False: the hybrid AR prior's decode kernel "
                             "(ops/ssm_step.py) takes a bf16 model on CUDA")
        # On CUDA both kernels run unless the caller turns one off. They
        # compute in bf16 and cast their inputs at the call boundary, as the
        # JAX fused step does, so half=False keeps them. The CPU takes their
        # plain versions only when asked to explicitly.
        # K2 decodes one device's whole stack: off under a mesh, as in the
        # JAX package, whose fused kernel GSPMD cannot split; the hybrid
        # prior decodes with its own step
        self.gpt_fused_step = (is_cuda if gpt_fused_step is None else gpt_fused_step) \
            and mesh is None and not (hybrid and gpt_fused_step is None)
        self.flash_attn = is_cuda if flash_attn is None else flash_attn
        self.mesh = mesh
        self._batch_sharding = batch_sharding(mesh) if mesh is not None else None
        if is_cuda and self.gpt_fused_step and self.kv_cache_dtype == torch.float32:
            raise ValueError("gpt_fused_step: kernel K2 reads a bf16 or int8 KV cache; with "
                             "kv_cache_dtype='f32' pass gpt_fused_step=False to decode "
                             "with the plain layer stack")
        self.text_bucket = text_bucket
        self.tokenizer = VoiceBpeTokenizer(vocab_file=tokenizer_vocab_file,
                                           use_basic_cleaners=tokenizer_basic)
        self.mel_norms = mel_ops.load_mel_norms().to(self.device)
        self._models_dir, self._allow_random = models_dir, allow_random_weights
        self.rlg_auto = self.rlg_diffusion = None
        self.cvvp = None
        self.last_candidates = None     # the AR candidates' codes of the last tts call
        # Redaction is on by default, as in the reference (api.py:196). The
        # aligner loads its wav2vec2 at the first bracketed request; with no
        # checkpoint that request warns and returns unredacted audio.
        self.enable_redaction = enable_redaction
        self.aligner = (Wav2VecAlignment(models_dir=models_dir, device=self.device)
                        if enable_redaction else None)

        def build(name, ctor, seed, dtype, found=None):
            with torch.device(self.device):
                model = ctor()
            source = weights_lib.load_weights(name, model, models_dir, allow_random_weights,
                                              seed, found)
            model = weights_lib.cast_for_inference(model, dtype).eval()
            return (model if mesh is None else replicate_tree(model, mesh)), source

        self.autoregressive, self.ar_source, self._ar_stacked = load_autoregressive(
            ar_config or UnifiedVoiceConfig(), gpt_weights, self.device, self.dtype, models_dir,
            allow_random_weights, self.gpt_fused_step, mesh, split=True)
        # the cache splits over tp as the GPT stack did (whole when its heads
        # do not divide by tp)
        gpt = getattr(self.autoregressive, "gpt", None)
        self._cache_sharding = KVCacheSharding(mesh) \
            if gpt is not None and gpt.tp is not None else None
        self.ar_cfg = self.autoregressive.config
        self.diff_cfg = diffusion_config or DiffusionTtsConfig(
            in_latent_channels=self.ar_cfg.model_dim)
        self.diffusion, self.diffusion_source = build(
            "diffusion_decoder", lambda: DiffusionTts(self.diff_cfg), 1, self.dtype)
        # CLVP's encoder variant is the one its checkpoint holds
        clvp_found = weights_lib.find_params("clvp", models_dir)
        clvp_cfg = clvp_config or CLVPConfig()
        if clvp_found[0] is not None:
            clvp_cfg = clvp_config_for_tree(clvp_cfg, clvp_found[0])
        self.clvp, self.clvp_source = build("clvp", lambda: CLVP(clvp_cfg), 2, self.dtype,
                                            clvp_found)
        self.vocoder, self.vocoder_source = build(
            "vocoder", lambda: UnivNetGenerator(UnivNetConfig(use_kernel=is_cuda)), 3,
            torch.float32)
        self.autoregressive_batch_size = (
            autoregressive_batch_size
            or pick_best_batch_size_for_device(self.device, self.ar_cfg, self.kv_cache_dtype))

    def load_cvvp(self):
        """Load CVVP at its first use (reference api.py:252-256): seed 4 when
        random, cast to the serving dtype."""
        with torch.device(self.device):
            model = CVVP(CVVPConfig())
        weights_lib.load_weights("cvvp", model, self._models_dir, self._allow_random, 4)
        self.cvvp = weights_lib.cast_for_inference(model, self.dtype).eval()
        if self.mesh is not None:
            replicate_tree(self.cvvp, self.mesh)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def get_conditioning_latents(self, voice_samples, return_mels=False,
                                 crop_rng: random.Random | None = None):
        """Clips (1, T) at 22.05 kHz -> (AR latent (1, D), diffusion latent
        (1, 2D)). Clips longer than 6 s are cropped at offsets drawn from
        ``crop_rng`` (reference api.py:258-299)."""
        rng = crop_rng or random.Random()
        auto_conds = torch.stack([format_conditioning(np.asarray(v), self.mel_norms,
                                                      self.device, rng)
                                  for v in voice_samples], dim=1)       # (1, n, T, 80)
        auto_latent = self.autoregressive.get_conditioning(auto_conds)
        diffusion_conds = []
        for v in voice_samples:
            s = audio_utils.pad_or_truncate(
                audio_utils.resample(np.asarray(v), 22050, 24000), 102400)
            wav = torch.as_tensor(np.ascontiguousarray(s), dtype=torch.float32,
                                  device=self.device)
            diffusion_conds.append(mel_ops.univnet_mel(wav).transpose(1, 2))
        diffusion_conds = torch.stack(diffusion_conds, dim=1)           # (1, n, T, 100)
        diffusion_latent = self.diffusion.get_conditioning(diffusion_conds)
        if return_mels:
            return auto_latent, diffusion_latent, auto_conds, diffusion_conds
        return auto_latent, diffusion_latent

    @torch.inference_mode()
    def get_random_conditioning_latents(self, seed: int = 0):
        """Random voice latents (AR (1, D), diffusion (1, 2D)) from the two
        random-latent generators, one ``torch.Generator`` seeded with
        ``seed`` drawing the AR noise first (reference api.py:301-309)."""
        if self.rlg_auto is None:
            d = self.ar_cfg.model_dim
            self.rlg_auto = load_random_latent_converter(
                "rlg_auto", d, self.device, self._models_dir, self._allow_random, 5, self.mesh)
            self.rlg_diffusion = load_random_latent_converter(
                "rlg_diffuser", 2 * d, self.device, self._models_dir, self._allow_random, 6,
                self.mesh)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return (sample_random_latent(self.rlg_auto, gen),
                sample_random_latent(self.rlg_diffusion, gen))

    def do_spectrogram_diffusion(self, latents, diffusion_conditioning, *,
                                 diffusion_iterations, cond_free, cond_free_k, temperature,
                                 generator: torch.Generator, sampler="p", valid_latents=None,
                                 shard=None):
        """Latents (1, n, D) -> denormalized mel (1, 100, out_len).

        Latents pad to a multiple of LATENT_BUCKET and the masked model keeps
        the valid region equal to an exact-length run, so the noise shape, the
        bias vectors and K3's masking follow the bucket. The initial noise is
        the generator's next draw.

        ``valid_latents`` (B,): the k-winner fan-out, latents (B, n, D) of
        which row b holds valid_latents[b]; the return is then the untrimmed
        (B, 100, out_bucket) mel, row b exact up to its own out_len. With
        ``shard`` (``parallel.mesh.BatchShard``) the rows are this rank's of
        a batch split over dp: every noise is drawn at the global batch's
        shape and this rank's rows taken."""
        n = latents.shape[1]
        n_bucket = -(-n // self.LATENT_BUCKET) * self.LATENT_BUCKET
        out_bucket = n_bucket * 4 * 24000 // 22050
        b = latents.shape[0]
        dev = self.device
        n_vec = torch.tensor([n] if valid_latents is None else list(valid_latents), device=dev)
        out_len = n_vec * 4 * 24000 // 22050
        lat_padded = F.pad(latents, (0, 0, 0, n_bucket - n))
        noise = draw_rows(lambda g: torch.randn((g, out_bucket, 100), generator=generator,
                                                device=dev), b, shard) * temperature
        pre = self.diffusion.timestep_independent_bucketed(
            lat_padded, n_vec, diffusion_conditioning, out_len, out_bucket)
        if cond_free:
            uncond = self.diffusion.unconditioned_embedding.to(pre.dtype).expand(pre.shape)
            mask = torch.arange(out_bucket, device=dev)[None, :, None] < out_len[:, None, None]
            pre = torch.cat([pre, uncond * mask.to(pre.dtype)], dim=0)
        rel_biases = self.diffusion.rel_bias_vectors(out_bucket)

        def model_fn(x, t):
            valid = out_len.expand(b).repeat(x.shape[0] // b)
            return self.diffusion(x, t, pre, valid_len=valid, rel_biases=rel_biases,
                                  flash=self.flash_attn)

        loop = {"p": p_sample_loop, "ddim": ddim_sample_loop}[sampler]
        mel = loop(model_fn, spaced_schedule("linear", 4000, diffusion_iterations), noise,
                   generator, SamplerConfig(cond_free=cond_free, cond_free_k=cond_free_k),
                   shard)
        mel = mel_ops.denormalize_tacotron_mel(mel).transpose(1, 2)
        return mel if valid_latents is not None else mel[:, :, :n * 4 * 24000 // 22050]

    def _vocode_clip(self, mel_btc, generator: torch.Generator):
        """Mel (1, F, 100) -> wav (1, F*256, 1) in one exact-length decode.
        The JAX package stitches a bucketed body and a fixed tail window
        only to avoid XLA recompiles, and its docstring shows that the
        stitched wav equals this exact-length decode."""
        f = mel_btc.shape[1]
        z = torch.randn((1, f + 10, self.vocoder.config.noise_dim), generator=generator,
                        device=self.device)
        return self.vocoder.inference(mel_btc.float(), z)

    # ------------------------------------------------------------------
    def tts_with_preset(self, text, preset="fast", **kwargs):
        return self.tts(text, **resolve_preset(preset, QUALITY_PRESETS, **kwargs))

    @profiling.request
    @torch.inference_mode()
    def tts(self, text, voice_samples=None, conditioning_latents=None, k=1, verbose=True,
            use_deterministic_seed=None, return_deterministic_state=False,
            num_autoregressive_samples=512, temperature=0.8, length_penalty=1.0,
            repetition_penalty=2.0, top_p=0.8, max_mel_tokens=500, typical_sampling=False,
            typical_mass=0.9, cvvp_amount=0.0, diffusion_iterations=100, cond_free=True,
            cond_free_k=2.0, diffusion_temperature=1.0, diffusion_sampler="p",
            **unused_hf_kwargs):
        """Full quality pipeline. Returns a float32 (1, 1, S) CPU tensor at
        24 kHz, or a list of k of them. ``length_penalty`` only affects beam
        search in the reference, which never runs: a no-op here too.
        ``cvvp_amount`` in (0, 1] mixes CVVP's scores of the candidates
        against each voice clip (their mean over the clips) into CLVP's; it
        needs ``voice_samples``."""
        timer = profiling.StageTimer()
        det_seed = deterministic_state(use_deterministic_seed)
        if self.mesh is not None:   # a seed from the clock differs between ranks
            det_seed = replicated(det_seed, self.mesh)
        gen = torch.Generator(device=self.device).manual_seed(det_seed)
        dev = self.device
        cfg = self.ar_cfg

        ids = self.tokenizer.encode(text)
        text_tokens = np.pad(np.asarray(ids, np.int64)[None], ((0, 0), (0, 1)))
        limit = min(400, cfg.max_text_tokens - 2)
        if text_tokens.shape[-1] >= limit:
            raise ValueError(f"Too much text provided ({text_tokens.shape[-1]} tokens >= "
                             f"{limit}). Break the text up into separate segments.")
        text_unbucketed = torch.as_tensor(text_tokens, device=dev)
        if self.text_bucket:
            tb = -(-text_tokens.shape[1] // self.text_bucket) * self.text_bucket
            tb = min(tb, cfg.max_text_tokens)
            text_tokens = np.pad(text_tokens, ((0, 0), (0, tb - text_tokens.shape[1])))
        text_t = torch.as_tensor(text_tokens, device=dev)

        auto_conds = None
        with timer.stage("conditioning"):
            if voice_samples is not None:
                auto_latent, diff_latent, auto_conds, _ = self.get_conditioning_latents(
                    voice_samples, return_mels=True, crop_rng=random.Random(det_seed))
            elif conditioning_latents is not None:
                auto_latent, diff_latent = (torch.as_tensor(c, device=dev).to(self.dtype)
                                            for c in conditioning_latents)
            else:
                auto_latent, diff_latent = (c.to(self.dtype) for c in
                                            self.get_random_conditioning_latents(det_seed))
            self._sync()

        if verbose:
            print("Generating autoregressive samples..")
        settings = SamplerSettings(
            temperature=temperature, top_k=50, top_p=top_p,
            repetition_penalty=repetition_penalty,
            typical_mass=typical_mass if typical_sampling else None,
            max_generate=min(max_mel_tokens, cfg.mel_pos_len - 3),
            fused_step=self.gpt_fused_step, emit_latents=False)
        num_batches = max(1, num_autoregressive_samples // self.autoregressive_batch_size)
        bs = min(num_autoregressive_samples, self.autoregressive_batch_size)
        if num_batches * bs != num_autoregressive_samples:
            # reference parity quirk (tortoise/api.py:407 floors the batch count)
            warnings.warn(
                f"num_autoregressive_samples={num_autoregressive_samples} is not divisible "
                f"by autoregressive_batch_size={self.autoregressive_batch_size}; sampling "
                f"{num_batches * bs} candidates instead.", stacklevel=2)
        shard = self._batch_sharding
        with timer.stage("autoregressive"):
            samples = [sample_speech(self.autoregressive, auto_latent, text_t, gen, bs,
                                     settings, cache_dtype=self.kv_cache_dtype,
                                     stacked=self._ar_stacked, batch_sharding=shard,
                                     cache_sharding=self._cache_sharding)[0]
                       for _ in range(num_batches)]
            if shard is not None:
                samples = [gather_rows(c, shard) for c in samples]
            samples = torch.cat(samples).cpu().numpy()
        self.last_candidates = samples

        if verbose:
            print("Computing best candidates using CLVP" +
                  ("" if cvvp_amount == 0 else f" {(1 - cvvp_amount) * 100:2.0f}% and "
                                               f"CVVP {cvvp_amount * 100:2.0f}%"))
        stop = cfg.stop_mel_token
        fixed = np.stack([fix_autoregressive_output(s, stop, complain=verbose) for s in samples])
        if cvvp_amount == 1 and auto_conds is None:
            # the reference raises NameError here (tortoise/api.py:474-491
            # leaves clvp_scores unbound); the JAX package's message instead
            raise ValueError(
                "cvvp_amount=1 requires conditioning mels (pass voice_samples, "
                "not precomputed latents): CVVP scores candidates against the "
                "reference clips, and with cvvp_amount=1 there is no CLVP "
                "score to fall back on.")
        fixed_t = torch.as_tensor(fixed, device=dev)
        if cvvp_amount != 1:
            with timer.stage("clvp_rerank"):
                if shard is not None and len(fixed) % shard.size == 0:
                    scores = gather_rows(self.clvp.score_candidates(
                        text_unbucketed, fixed_t[shard.rows(len(fixed))]), shard)
                else:
                    scores = self.clvp.score_candidates(text_unbucketed, fixed_t)
                scores = scores.float().cpu().numpy()
        if auto_conds is not None and cvvp_amount > 0:
            if self.cvvp is None:
                self.load_cvvp()
            with timer.stage("cvvp_rerank"):
                n_clips = auto_conds.shape[1]
                cvvp_scores = sum(
                    self.cvvp.score_candidates(auto_conds[:, c], fixed_t).float().cpu().numpy()
                    for c in range(n_clips)) / n_clips
            scores = cvvp_scores if cvvp_amount == 1 else \
                cvvp_scores * cvvp_amount + scores * (1 - cvvp_amount)
        best = fixed[np.argsort(scores)[::-1][:k]]

        with timer.stage("latent_reextraction"):
            best_t = torch.as_tensor(best, device=dev)
            best_latents = self.autoregressive(
                auto_latent.expand(len(best), -1), text_t.expand(len(best), -1), best_t,
                wav_lengths=torch.full((len(best),), best.shape[1] * cfg.mel_length_compression,
                                       device=dev),
                return_latent=True)
            self._sync()

        if verbose:
            print("Transforming autoregressive outputs into audio..")
        diffusion = dict(diffusion_iterations=diffusion_iterations, cond_free=cond_free,
                         cond_free_k=cond_free_k, temperature=diffusion_temperature,
                         generator=gen, sampler=diffusion_sampler)
        trims = [calm_token_trim_length(c) for c in best]
        wavs = []

        def vocode(mel):
            with timer.stage("vocoder"):
                wav = self._vocode_clip(mel.transpose(1, 2), gen)
                wavs.append(wav[:, :, 0][:, None, :].float().cpu())

        if shard is not None and len(best) > 1 and len(best) % shard.size == 0:
            # the winners in one batch over dp, as the JAX package's fan-out
            rows = shard.rows(len(best))
            with timer.stage("diffusion"):
                mels = gather_rows(self.do_spectrogram_diffusion(
                    best_latents[rows, :max(trims)].float(), diff_latent,
                    valid_latents=trims[rows], shard=shard, **diffusion), shard)
            for i, n in enumerate(trims):
                vocode(mels[i:i + 1, :, :n * 4 * 24000 // 22050])
        else:
            for i, n in enumerate(trims):
                with timer.stage("diffusion"):
                    mel = self.do_spectrogram_diffusion(
                        best_latents[i:i + 1, :n].float(), diff_latent, **diffusion)
                    self._sync()
                vocode(mel)
        with timer.stage("redact_finalize"):
            wavs = [self._potentially_redact(w, text) for w in wavs]
        if verbose:
            timer.report(print_it=True)
        self.last_stage_timings = timer.report()
        res = wavs if len(wavs) > 1 else wavs[0]
        if return_deterministic_state:
            return res, (det_seed, text, voice_samples, conditioning_latents)
        return res

    def _potentially_redact(self, clip, text):
        """clip: (1, 1, S) -> the clip with its [bracketed] spans cut out.
        With no wav2vec2 weights it warns once, drops the aligner and
        returns the clip unredacted (the reference would fail on its hub
        download; the JAX package degrades the same way)."""
        if self.enable_redaction and self.aligner is not None:
            try:
                return torch.as_tensor(self.aligner.redact(clip[0].numpy(), text))[None]
            except FileNotFoundError as e:
                warnings.warn(
                    f"redaction disabled - wav2vec2 aligner weights unavailable ({e}); "
                    "returning unredacted audio. Pass enable_redaction=False to silence "
                    "this.", stacklevel=3)
                self.aligner = None
        return clip

    def deterministic_state(self, seed=None):
        return deterministic_state(seed)


# ---------------------------------------------------------------------------
# Module-level API of the reference (tortoise/api.py)
# ---------------------------------------------------------------------------

def load_discrete_vocoder_diffuser(trained_diffusion_steps=4000, desired_diffusion_steps=200,
                                   cond_free=True, cond_free_k=1):
    """The reference's helper (api.py:64-70): the spaced schedule and the
    sampler config that the port's sampling loops take."""
    return (spaced_schedule("linear", trained_diffusion_steps, desired_diffusion_steps),
            SamplerConfig(cond_free=cond_free, cond_free_k=cond_free_k))


def classify_audio_clip(clip, models_dir=None, device="cuda") -> float:
    """Probability that a 24 kHz clip came from Tortoise (reference
    api.py:133-145), through the Tortoise-detect classifier in float32 on
    ``device`` (seed 7 when no checkpoint is found)."""
    from tortoise_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead
    from tortoise_tpu_torch.models.classifier import classify_audio_clip as classify

    device = weights_lib.float32_device(device)
    with torch.device(device):
        model = AudioMiniEncoderWithClassifierHead(ClassifierConfig())
    weights_lib.load_weights("classifier", model, models_dir, True, 7)
    return classify(clip, model.eval())


def pad_or_truncate(t, length):
    """The reference's helper (api.py:52-61)."""
    return audio_utils.pad_or_truncate(np.asarray(t), length)
