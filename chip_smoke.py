#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tortoise_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing falls back):
  1. refuse to run without CUDA; print the card and its power limit;
  2. build the hand-written kernels from tortoise_tpu_torch/csrc, one nvcc
     per source, all at once, and print K1's registers, shared memory and
     spills (nvcc -Xptxas -v);
  3. K2 (whole GPT-2 decode step), each of its four variants (bf16 or int8
     weights x bf16 or int8 cache), against its plain PyTorch version at
     full width: L=30, C=1024, H=16, B in {1, 16}, pos in {0, 37, 500},
     T=768; then at the batches the bench's requests decode (200 tokens,
     their cache of T=512 rows, pos in {0, 37, the last decode step}): bf16
     at B=64 (tts_batch) and 128 (quality standard), int8_weights at B=96
     (quality fast with int8_decode weights), int8_cache and both at B=256
     (quality high_quality over the int8 cache); then the bf16 step at
     B in {1, 16, 64, 96, 128}, pos=500, T=768: its kernels put on the
     stream a step (one persistent launch, `fused_decode_step.
     device_launches`), event and device ms beside its bound;
  4. K3 (relative-position attention) against its plain version at B in
     {2, 1} (the fast preset's CFG batch, ultra_fast's), H=16, D=64, T in
     {256, 2229} with per-row valid lengths below T, and at T=1114 with 870
     valid (the bench's 200-token clip), timed beside
     scaled_dot_product_attention with the bias as a float mask;
  5. K4 (UnivNet's location-variable convolution) against its plain
     version and the shifted-reshape einsum form at F=2186 frames (a
     500-token clip), hop in {8, 64, 256}, B=1, f32, its kernels in the
     predictor's frames-innermost layout and with each frame's block
     contiguous; a line per hop with its share of its bound;
  6. K1 (one layer's decode attention with the row write) against its
     plain version at L=30, C=1024, H=16, T=768, B in {1, 8, 16, 64, 96}
     (8: a dp=2 rank's rows in phase 14; 64: the bench's tts_batch with K2
     off), pos in {0, 37, 500, 767}, over bf16 and f32 caches: the row
     write bit-exact, every other row untouched; timed at pos=500 beside
     its plain version and the row write plus scaled_dot_product_attention,
     warm (every call on one layer) and cold (each call the next of the 30
     layers, so none finds its slice in L2, as in the decode);
  7. the full-width TextToSpeech (seeded random weights, voice
     train_dotrice): K2 at the fast request's shapes (96 candidates, the
     last decode position) over a bf16 cache and over an int8 cache, and
     K1 over an f32 cache, each filled by a real prefill, layer by layer,
     with planted faults the checks must catch (cache rows read one off;
     int8 scales read one position off); one diffusion forward with and
     without K3; one UnivNet forward with and without K4; then three
     requests (ultra_fast, ultra_fast, fast with classifier-free guidance);
  8. the fast path, TextToSpeechFast with bf16 and with int8_decode GPT
     weights: a warm-up tts and short stream, a timed tts, a tts_stream of
     the same text and seed (its codes equal tts's, its chunks equal the
     full decode of its own latents, its wav is near tts's), and on the
     bf16 instance a tts_batch of three texts with a random voice;
  9. one quality ultra_fast request with the int8 KV cache for each of
     gpt_weights "int8_decode" and "bf16", with the cache's bytes beside the
     bf16 cache's, and one with the f32 cache and gpt_fused_step=False: K1
     in every layer of every decode step;
 10. the full-knob CLI (tortoise_tpu_torch.apps.main) in this process,
     writing a 24 kHz wav;
 11. the tools path: K5 (decode attention over an interleaved k|v cache,
     BH=256, T=256, n_valid=200), K6 (the decode attention body, variants a
     and b, B=128, T=768, pos=300, ck=64), K7 (seven data-movement probes)
     and K8 (four contraction orientations) against their plain versions
     at the tools' reference shapes, timed with and without the host's
     launch time; then, counted, the tools' main() in this process:
     probe_ops (with the host's launch costs), decode_attn_kv128 (B=16,
     L=30), bench_attn_body, bench_decode_attn_merged (its defaults: B=16,
     T=768, L=30, nvalid=600, 32 steps), bench_lvc (K4 against its plain
     version beside the gather and shifted forms, F=937), bench_fused_decode_step
     (K2 against the layer stack, one step and 32 chained ones at B=128,
     over the int8 and the bf16 cache), check_fused_exactness (full width, 16
     steps: decisive agreement 1.0 over both caches), bench_fused_ab (whole
     requests with K2 on and off: K2 launched in the "on" ones only),
     measure_first_audio and, last, profile_ar_step (B=16, 8 tokens a
     section; its per-layer decode runs K1), whose torch.profiler passes
     come after every timing of the process, each tool checking its
     kernels again (TOOL_RUNS lists each one's arguments and cuts); then
     one K1 call at B=1 and at B=16 under torch.profiler, which must run
     exactly one device kernel; then the trace phase in a process of its
     own (this script with --trace-worker): one K2 bf16 decode step at B=1,
     one K1 call at B=16 and one K3 call at B=2, T=2229, full width, inside
     one utils/profiling.trace block writing build/trace/*.pt.trace.json,
     whose kernel events must hold K1, K2's one kernel ("K2 gemm") and K3,
     and its host side their launches; then
     profile_diffusion_step in a process of its own (K3 and the dense
     form at B=1 and 2, T=896 and 2229: host, event and busy ms a step);
 12. the quality API's remaining paths, at full width with seeded random
     weights, on a TextToSpeech whose redaction is left on by default: a
     bracketed ultra_fast request with no wav2vec2 checkpoint (it warns,
     returns the unredacted 23.2 s clip and drops the aligner); wav2vec2
     (24 layers, 1024 wide) from a seeded checkpoint in the HF layout,
     over that clip at 16 kHz (its frame count, a zero-padded run with
     n_samples against the exact one, a 2 s clip against the module's
     float32 forward on the CPU, its event and device time); a bracketed
     ultra_fast request redacted by that model (shorter than the clip it
     was given, equal to the kept spans of align on that clip), and the
     parts of its redaction timed alone on the host (the native and scipy
     resamplers, the logits, the DP); an ultra_fast request with
     cvvp_amount=0.5 (CVVP's scores of the 16 candidates against the CPU
     float32 module); the classifier on the 23.2 s clip through
     api.classify_audio_clip with cuDNN's TF32 turned back on first (the
     call must turn it off), against the CPU; is_this_from_tortoise in a
     process of its own, held to the CPU classifier; and eval --cer in
     this process. It runs between phases 10 and 11:
     phase 11's profiler passes come after every timing of the process.
 13. the training path, at full width with seeded random weights in float32
     with TF32 off, between phases 12 and 11: five UnifiedVoice train steps
     at B=4 over the full 402 text and 604 mel tokens (the loss holds at
     the warmup's lr 0, then falls; step ms, tokens/s, TFLOP/s, peak
     memory); two steps of the same weights on the card and on the CPU over
     a short batch (loss, grad_norm and five leaves against each other);
     train steps of DiffusionTts (training_losses over 2229 frames
     from 512 AR latents, B=2), CLVP (token-dropout masks) and CVVP
     (three steps each, the later ones timed). Then
     mixed precision, the models built with dtype=torch.bfloat16 over
     float32 parameters: UnifiedVoice's gradients on the card against the
     CPU's from the same weights over the short batch; its five steps at
     B=4 x 1011 (step ms, tokens/s, TFLOP/s against bf16's dense peak, peak
     memory), and again with model.gpt.remat set; bf16 steps of
     DiffusionTts, CLVP and CVVP. It launches no kernel of the port: the
     training forward takes the plain attention, as the JAX package's does.
 14. the mesh path (tortoise_tpu_torch/parallel) on the one card, between
     phases 13 and 11: the mp3-only voice tim_reynolds loaded where the
     machine has ffmpeg (else the error that names it, checked); K1
     against its plain version at a tp=2 rank's width
     (C=512, H=8, B in {8, 16}, bf16 and f32 caches); ops.sampling.categorical
     on CUDA against torch.multinomial's draws, before any mesh request; a
     world of one over NCCL, whose TextToSpeech(mesh=make_mesh(1, 1))
     answers phase 7's first ultra_fast request (float32 model, f32 cache)
     with the codes of the same request unsplit; then a world of two
     processes over gloo on the card (this script with --mesh-worker):
     one teacher-forced decode step's logits over tp=2 held to the unsplit
     model's in float32 and in bf16, at three seeds of its inputs; each rank answering the request over
     tp=2 and over dp=2 in float32 and over dp=2 in bf16 (K1, K3 and K4
     launched on each rank; the rows of codes equal to the unsplit
     request's reported, those of phase 9 for bf16); then one UnifiedVoice
     train step at full width over tp=2 (B=2 x 1011 positions) whose loss
     and grad_norm are held to the unsplit step's, in float32 and in bf16
     (float32 parameters).
 15. between phases 14 and 11: the socket server (apps.socket_server over a
     full-width bf16 TextToSpeechFast on 127.0.0.1, one connection, two
     utterances of train_dotrice: float32 framing, END_OF_AUDIO, finite
     non-empty audio, K2 launched; time to the first bytes and total);
     CLVP with use_xformers=False at the shipped widths, the card against
     the CPU module in float32 with TF32 off; a full-width UnivNet's tree
     through weights.save_params and load_weights ("native", the same
     forward as the tree loaded directly); istft(stft(x)) against x;
     stft_magnitude(center=False) against the CPU's; the native crossfade
     against its formula; decode(encode(t)) of the request texts against
     their cleaned text; the repo tools without JAX:
     fetch_weights --offline over a seeded reference-layout rlg_auto.pth
     and make_demo_voices (its clips the repository's, byte for byte),
     both into build/.
 16. last, in a process of its own (this script with --bench-worker): the
     benchmark program tortoise_tpu_torch/bench.py at full width, its
     headline and every section through its section functions, one timed
     run after each warm-up (200 tokens a request; the long-form chunks
     500): the quality ladder (ultra_fast, fast, standard at 256
     candidates), quality fast with int8_decode weights, high_quality at
     256 candidates over the int8 cache and the long-form loop, first audio
     with both weight kinds, tts_batch of 64 with K2 on and off, the fast
     path with K2 off, tts_batch of 8. It fails on any section's error or
     skip, a headline or row that is not finite and positive, memory left
     allocated after a section beyond the headline instance's, or a kernel
     the sections use (K2 bf16, int8_weights and int8_cache, K1, K3, K4)
     launched no time; the bench's last line is printed.
 17. the hybrid AR prior (models/granite_hybrid.py, Granite-4.0-H-Micro's
     widths), in two places. Beside phases 3-6: kernel S1
     (ssm_decode_step, csrc/ssm_step.cu) against its plain version at the
     fast preset's B=96, 64 heads of 64, a 128-wide state, conv 4352 x 4,
     over 8 chained steps (y, the bf16 state and the conv state, each
     within its bound), two faults planted on the kernel's side (the
     stored state a bf16 step low, the B and C conv state unshifted) each
     outside them, then timed cold and back to back beside its bound
     (portbench/kernels/ssm_step.py's operations and bytes). In phase 11,
     after check_k1_one_kernel: the full-width TextToSpeech over the
     hybrid prior (seeded random weights) answers one fast request at 96
     candidates (S1 launched 36 times a decode step, no K2, one graph
     capture and a replay every later step), then one more decode step,
     a replay, under torch.profiler runs S1 36 times on the device, as
     many as the replay adds to S1's counter.
Before each path of phases 7-17 every launch counter is set to 0, and read
after it: the "launches" of the kernels line sum the runs of phases 7-12, of
phase 14's world of one, phase 15, phase 11's tools, phase 16 and phase
17's request, and the record keeps each path's counts apart (K1's are
printed). Every UnivNet forward of those paths launches K4
12 times, and K4's plain version never runs on the card there. A CUDA
graph's replay runs no wrapper: the decode step adds the S1 launches its
capture recorded to S1's counter at each replay (phase 17 holds that
count to the device's).

    python3 chip_smoke.py --k2

builds K2 and runs phases 1-3 alone (about a minute and a half), its record
in build/chip_smoke_k2.json.

    python3 chip_smoke.py --granite

builds S1, K3 and K4 and runs phase 17 alone (about 2 minutes), its record
in build/chip_smoke_granite.json; its kernels line holds S1's row.

    python3 chip_smoke.py --serving-walls [--root DIR]

times phases 7-10's requests alone (a warm-up request, then phase 7's three,
phase 8's fast path, phase 9's int8-cache and f32-cache requests, phase
10's CLI; each with its checks) on the package of the checkout at DIR,
this one by default, and prints one JSON line of their walls, each
request's wall beside a digest of its sampled codes and of its audio. Run
on two checkouts in one call, in the order A, B, B, A, it compares their
serving walls and outputs on one card.

    python3 chip_smoke.py --k1-ab [--root DIR]

times K1 on the package at DIR at every shape its per-layer decode runs
(C=1024 at B in {1, 8, 16, 64, 96}, a tp=2 rank's C=512 at B in {8, 16},
pos=500, T=768, three q/cache type pairs), warm and cold, beside row write
+ SDPA; its host microseconds a call by piece at B=1 and 16; and the
requests whose decode runs it (quality ultra_fast over the f32 cache, the
bench's fast path and tts_batch of 64 with gpt_fused_step=False), and
prints one JSON line. Run on two checkouts in one call (A, B, B, A).

The last lines are the card's name and power limit, one JSON object with a
row per kernel and K2 variant, and {"ok": true, "device": {...}}. The full
record also goes to build/chip_smoke.json. A row's bound_ms is the least
time the card could take for the row's timed call: the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over the peak rate for their type (bf16 989 TFLOP/s, f32
without tensor cores 67 TFLOP/s; NVIDIA's H100 SXM data sheet), reckoned
by tortoise_tpu_torch/utils/measure.py as the tools reckon theirs.
"""
from __future__ import annotations

import concurrent.futures
import gc
import hashlib
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# --serving-walls --root DIR imports the package of the checkout at DIR
PACKAGE_ROOT = os.path.abspath(sys.argv[sys.argv.index("--root") + 1]
                               if "--root" in sys.argv else ROOT)
sys.path.insert(0, PACKAGE_ROOT)
# the bounds and timings of the port's tools, one reckoning for both
from tortoise_tpu_torch.utils.measure import bound as _bound  # noqa: E402
from tortoise_tpu_torch.utils.measure import device_ms as _device_ms  # noqa: E402
from tortoise_tpu_torch.utils.measure import nbytes as _nbytes  # noqa: E402
from tortoise_tpu_torch.utils.measure import nvidia_smi as _nvidia_smi  # noqa: E402
from tortoise_tpu_torch.utils.measure import time_ms as _time_ms  # noqa: E402
from tortoise_tpu_torch.utils.measure import STEP_SLEEP_CYCLES_PER_RUN  # noqa: E402
# K2: the hidden state and rows after 30 bf16 layers, against the plain
# version with the TPU kernel's rounding order. Both round at the same
# places but sum in different orders, so one-ulp bf16 flips compound over
# the layers: 0.05 x max|plain| of each row (the JAX package bounds its
# 3-layer test of this kernel at 0.03, tests/test_fused_decode_step.py)
K2_REL_BOUND = 0.05
# K2 one layer at a time on the main path's shapes, each layer given the
# plain version's input, so nothing compounds: every (candidate, head)
# attention output relative to its own max|plain|, and every hidden row
# relative to its own max|plain|
K2_HEAD_REL_BOUND = 0.02
K2_ROW_REL_BOUND = 0.02
# K3: bf16 output of a softmax-weighted mean of O(1) values; both round the
# weights to bf16, the kernel before normalising them, the plain version after
K3_ABS_BOUND = 0.02
# (frames, valid frames) of the bench's 200-token clip: 200 latents pad to
# the 64-latent bucket (256), which is 1114 output frames, 870 of them valid
K3_BENCH_FRAMES = (256 * 4 * 24000 // 22050, 200 * 4 * 24000 // 22050)
# fused vs unfused decode step / flash vs einsum diffusion forward at full
# width, bf16 model: relative to max|unfused|. With the int8 cache the
# fused step attends to its own row unquantized and the layer stack to the
# quantized row, a difference of at most that row's quantization error
MODEL_REL_BOUND = 0.05
# tts_stream's chunks against one full-length HiFi-GAN decode of the same
# latents: float32 convolutions over other lengths, so other cuDNN
# algorithms and summation orders; the wav is in [-1, 1]
STREAM_ABS_BOUND = 1e-3
# K4: f32 sums of the same products in another order, relative to the
# call's max|plain|
K4_REL_BOUND = 1e-5
# UnivNet's wav (in [-1, 1]) with K4 against the einsum LVC, contractive
# weights: the f32 tolerance of the JAX package's vocoder tests
UNIVNET_ABS_BOUND = 1e-4
# K1, every (batch row, head) relative to its own max|plain|: a bf16 output
# rounds once (one bf16 ulp, 2^-8); an f32 one differs in summation order
K1_BF16_BOUND = 1e-2
K1_F32_BOUND = 1e-5
# tts_stream's wav against tts's, same codes: the stream decodes the
# sampler's own latents (K2's steps over a bf16 cache), tts re-extracts them
# teacher-forced (the bf16 layer stack); those differ by ~2.6% per row
# (the sampler-step check of phase 5), which the random-weight HiFi-GAN
# carries into the wav. Relative L2 over the clip
STREAM_TTS_REL_L2_BOUND = 0.25

# phase 12. wav2vec2's logits, float32 with TF32 off (api.py turns it off):
# a zero-padded run and the exact one, and the card and the CPU, sum in
# other orders over 24 layers; relative to the run's max|logit|
W2V_REL_BOUND = 1e-4
# seeds of wav2vec2's random checkpoint, tried in turn until one hears at
# least W2V_MIN_HEARD symbols in the clip; the redacted request's text is the
# first W2V_TEXT_CHARS of what it hears, a bracket around the middle third
W2V_SEEDS = (0, 1, 2, 3)
W2V_MIN_HEARD = 6
W2V_TEXT_CHARS = 60
# CVVP's scores (cosine similarity x e, within +-2.72) from the bf16 model
# against its float32 forward on the CPU, the same bf16-rounded weights: the
# activations' bf16 rounding over 8 + 8 layers
CVVP_ABS_BOUND = 0.02
# the classifier in float32 on both sides: the probability
CLASSIFIER_ABS_BOUND = 1e-4

# (preset, text, seed) of the three requests; the fast one decodes its
# preset's 96 candidates in one batch and runs classifier-free guidance
REQUESTS = [
    ("ultra_fast", "The quick brown fox jumps over the lazy dog.", 11),
    ("ultra_fast", "Tortoise is a text to speech program built with a focus on "
                   "multi-voice capabilities.", 12),
    ("fast", "This request runs classifier free guidance, so the diffusion "
             "batch holds two rows.", 13),
]
FAST_TEXT = REQUESTS[2][1]
FAST_CANDIDATES = 96
# the fast/streaming requests (text, seed) and tts_batch's texts
STREAM_REQUEST = ("The quick brown fox jumps over the lazy dog.", 21)
BATCH_TEXTS = ["One sentence of a batch.", "A second, longer sentence of the same batch.",
               "And a third."]
K2_VARIANTS = ("bf16", "int8_weights", "int8_cache", "int8_weights_int8_cache")
# phase 3 at the bench's batches (tortoise_tpu_torch/bench.py, 200 tokens a
# request): (variant, B, the request's text bucket) for tts_batch of 64
# (bucket 64), quality standard's two batches of 128, quality fast with
# int8_decode weights (96), and high_quality over the int8 cache (256, one
# batch) with either weights; the cache is the request's, pos runs to its
# last decode step (bench_k2_shapes)
BENCH_TOKENS = 200
BENCH_K2_CASES = (("bf16", 64, 64), ("bf16", 128, 32), ("int8_weights", 96, 32),
                  ("int8_cache", 256, 32), ("int8_weights_int8_cache", 256, 32))
K2_SOURCE = "tortoise_tpu_torch/csrc/decode_step.cu"
K2_REPLACES = "tortoise_tpu/ops/decode_step_pallas.py:267"
K1_NAME, K3_NAME, K4_NAME = ("decode_attention_merged", "flash_rel_attention",
                             "location_variable_convolution_lvc")
K5_NAME, K7_NAME, K8_NAME = "decode_attention_kv128", "probe_ops", "probe_orient"
# phase 11: each tool's arguments (the K5-K8 tools at their reference shapes,
# K5 at B=16 so BH=256; the profiler with few tokens a section)
TOOL_RUNS = (
    ("probe_ops", []),
    ("decode_attn_kv128", ["--batch", "16", "--tmax", "256", "--layers", "30", "--steps", "8"]),
    ("bench_attn_body", ["--batch", "128", "--t", "768", "--fill", "300", "--ck", "64",
                         "--reps", "5"]),
    ("bench_decode_attn_merged", []),
    # the path measurement tools, each cut where its defaults would not fit:
    # bench_lvc and bench_fused_decode_step at their defaults (F=937; B=128,
    # T=768, fill 256, 32 steps, int8 cache), the latter again over the
    # bf16 cache (K1 in the stack); check_fused_exactness at full width, 16
    # of its 32 steps; bench_fused_ab at 1 run (1 quality run) after its
    # warm-up, 40 of its 200 tokens, tts_batch of 8 of its 64 utterances;
    # measure_first_audio at 3 of its 5 runs
    ("bench_lvc", []),
    ("bench_fused_decode_step", []),
    ("bench_fused_decode_step", ["--cache", "bf16"]),
    ("check_fused_exactness", ["--steps", "16"]),
    ("bench_fused_ab", ["--runs", "1", "--quality-runs", "1", "--tokens", "40", "--batch", "8"]),
    ("measure_first_audio", ["--runs", "3"]),
    # last: its busy passes run torch.profiler, which slows every launch after it
    ("profile_ar_step", ["--batch", "16", "--tokens", "8"]),
)
# and profile_diffusion_step in a process of its own, after them (its
# profiler passes would slow this process's launches): B=1 and 2 at its
# default 896 frames and at 2229 (a 500-token clip), 4 of its 16 steps
DIFFUSION_PROFILE_ARGS = ["--tout", "896", "2229", "--steps", "4", "--batch", "1", "2"]
# the trace phase, a process of its own (this script with --trace-worker)
# before profile_diffusion_step's: one utils/profiling.trace block around one
# K2 bf16 decode step (B=1, the fast path's), one K1 call (B=16) and one K3
# call (B=2, the fast preset's CFG batch, T=2229), full width; its file must
# hold these kernel families and the host's launches
TRACE_DIR = os.path.join(ROOT, "build", "trace")
TRACE_FAMILIES = ("K1", "K2 gemm", "K3")
TRACE_TIMEOUT = 300
# phase 15. CLVP's plain-Transformer variant at the shipped widths (768, 20
# + 20 layers, 12 heads, text table 350), float32 with TF32 off on the card
# against the CPU module: sums in other orders over 20 layers, a similarity
# within +-e
CLVP_PLAIN_ABS_BOUND = 1e-4
CLVP_PLAIN_SHAPES = (2, 350, 604)
# the socket server: two utterances of voice train_dotrice over one
# connection to a full-width bf16 TextToSpeechFast
SOCKET_VOICE = "train_dotrice"
SOCKET_TEXTS = ("The quick brown fox jumps over the lazy dog.",
                "A second utterance on the same connection.")
SOCKET_TIMEOUT = 300
# istft(stft(x)) against x on the card: float32 FFTs, relative to max|x|
STFT_REL_BOUND = 1e-5
# phase 13, training in float32 with TF32 off. UnifiedVoice: TRAIN_STEPS
# steps at B=4 over the full 402 text and 604 mel tokens (1011 positions a
# row), the JAX package's lr and a warmup of 2 (the first step changes
# nothing: lr 0)
TRAIN_BATCH, TRAIN_TEXT, TRAIN_MEL = 4, 402, 604
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 5, 1e-4, 2
# the card against the CPU at full width over a short batch (B=2, 16 text
# and 24 mel tokens) from the same initial weights, float32 on both with
# TF32 off, sums in other orders over 30 layers: each leaf's gradient
# relative to its max |grad| (the CPU tests' bound against JAX), then two
# steps' loss and grad_norm, relative
TRAIN_CPU_GRAD_FRAC = 1e-4
TRAIN_CPU_REL_BOUND = 1e-4
TRAIN_CPU_BATCH, TRAIN_CPU_TEXT, TRAIN_CPU_MEL = 2, 16, 24
# and these leaves after the second step (lr 5e-5): every element within 2
# lr (Adam's m / sqrt(v) makes a gradient at rounding level an update of
# +-lr), all but TRAIN_FAR_SHARE of them within TRAIN_NEAR_FRAC of lr
TRAIN_NEAR_FRAC, TRAIN_FAR_SHARE = 0.01, 1e-3
TRAIN_LEAVES = ("mel_head.weight", "mel_head.bias", "text_embedding.weight",
                "gpt.h_scan.block.mlp_fc.weight", "final_norm.weight")
# the other models' steps: DiffusionTts on the quality path's 2229 frames
# from 512 AR latents (B=2), CLVP over 350 text and 604 speech tokens with
# token-dropout masks (B=4), CVVP over 500 mel frames and 604 codes (B=4)
DIFF_TRAIN = (2, 2229, 512)
CLVP_TRAIN = (4, 350, 604)
CVVP_TRAIN = (4, 500, 604)
# their steps: the first pays the shapes' first calls, the others are timed
OTHER_TRAIN_STEPS = 3
# bf16 compute over float32 parameters: the card against the CPU at full
# width over the short batch, each leaf's gradient relative to its max
# |grad|, the bound the CPU tests hold bf16 gradients to against the JAX
# model (tests/test_torch_training_bf16.py, DiffusionTts's) and phase 14
# holds bf16 logits to; the loss relative, their LOSS_RTOL. cuBLAS and the
# CPU's bf16 products round the same sums in other orders, and a flip of
# a rounding carries through 30 layers
TRAIN_CPU_BF16_GRAD_FRAC = 2.0 ** -5
TRAIN_CPU_BF16_LOSS_RTOL = 5e-3
# the tp=2 bf16 train step against the unsplit bf16 step: loss and
# grad_norm relative, the bound of bf16 logits (the CPU world of two reads
# up to 6.1e-5, tests/test_torch_parallel.py)
MESH_TRAIN_BF16_REL_BOUND = 2.0 ** -5
# phase 14, the mesh on the one card. The request is REQUESTS[0] with the
# f32 cache (K2 is off under a mesh); a world of two runs over gloo, which
# carries all_reduce and broadcast on CUDA tensors (NCCL refuses two ranks
# on one card); its ranks write build/phase14_rank{r}.{log,json}.
# One teacher-forced decode step's mel logits of the tp=2 split against the
# unsplit model's, each row relative to its max|logit|, at three seeds of
# the step's inputs: float32 partial sums in another order. In bf16 each
# rank's float32 partial product is summed, then rounded once, as the
# unsplit product is; the split's other bf16 roundings (K1 at C=512,
# products of other widths) still part by an ulp here and there, and the
# flips compound over the 30 layers and the prompt's prefill, as in K2's
# check of a whole step. Read 0.0137, 0.0172, 0.0167 at seeds 3, 4, 5 on an
# H100, 3.5-4.4 bf16 ulps (2^-8) of the row's max: the bound is 8 ulps,
# about twice the largest reading
MESH_LOGITS_F32_BOUND = 1e-4
MESH_LOGITS_BF16_BOUND = 2.0 ** -5
MESH_LOGIT_ROWS, MESH_LOGIT_PROMPT, MESH_LOGIT_SEEDS = 16, 32, (3, 4, 5)
# (name, dp, tp, half) of the world of two's requests; every one with the
# f32 cache. Over gloo each of tp=2's ~31,000 all-reduces a request takes
# 1.5-1.9 ms with two ranks on one H100, so one tp=2 request runs; the bf16
# model's split is held by its decode step's logits
MESH_REQUESTS = (("tp2_f32", 1, 2, False), ("dp2_f32", 2, 1, False), ("dp2_bf16", 2, 1, True))
MESH_TRAIN_BATCH = 2
MESH_WORLD_TIMEOUT = 900
# f32 peak of the H100 SXM without tensor cores and its dense bf16 peak (the
# data sheet), TFLOP/s
F32_PEAK_TFLOPS = 67.0
BF16_PEAK_TFLOPS = 989.0
# UnivNet c32: three LVC blocks (hop 8, 64, 256), four LVC calls each
LVC_HOPS = (8, 64, 256)
LVC_CALLS_PER_FORWARD = 12
# frames of a 500-token clip: 2176 mel frames plus UnivNet's 10 padding frames
LVC_FRAMES = 2186
# phase 17, the hybrid AR prior (models/granite_hybrid.py). Kernel S1,
# ssm_decode_step, against its plain version at the main path's shape: the
# fast preset's 96 candidates, Granite-4.0-H-Micro's 64 heads of 64, a
# 128-wide state, conv 4352 x 4; SSM_STEPS chained steps, each side carrying
# its own state and conv state, new x, B, C and dt every step
SSM_NAME = "ssm_decode_step"
SSM_SOURCE = "tortoise_tpu_torch/csrc/ssm_step.cu"
SSM_BATCH, SSM_HEADS, SSM_STEPS = 96, 64, 8
# y is float32 from the float32 update on both sides: sums over the 128
# state values in another order, and the share of the few state elements
# that have come to be stored a bf16 step apart; relative to max|plain|
SSM_Y_REL_BOUND = 1e-3
# the state is stored in bf16: where the float32 update lies by a hair on
# the other side of a rounding boundary, the two store one bf16 step apart
# (at most 2^-7 of the value), and such a pair stays apart, shrunk by the
# decay, while later inputs may cancel the value around it (one element
# read 19.7 steps of its own value apart after 8 steps, H100). Every
# element within SSM_STATE_STEPS such steps of its (row, head)'s largest
# value, at most SSM_STATE_DIFF_SHARE of them not equal; the conv state
# holds shifted bf16 values: equal
SSM_STATE_STEPS = 2.0
SSM_STATE_DIFF_SHARE = 1e-2
# faults the check must catch, planted on the kernel's side: the stored
# state one bf16 step low before each step (the decay off by that step),
# and the B and C channels' conv state left unshifted
SSM_FAULTS = ("decay_one_bf16_step", "bc_shift_skipped")
# the request: the fast preset at 96 candidates, one decode batch, the
# decode step one CUDA graph replay after the first (captured) step; in
# each step every Mamba layer launches S1 once
GRANITE_REQUEST = ("fast", FAST_TEXT, 13)
# the diffusion decoder's masked GroupNorm chain (group_norm_act): its site
# forms (film, silu, out dtype), checked at B=2, C=1024 over these frames
# (one row full, one ragged) and timed at the longest bucket; the decoder's
# step profiled with the kernel and with every chain op by op
GN_NAME = "group_norm_act"
GN_SOURCE = "tortoise_tpu_torch/csrc/group_norm.cu"
GN_FRAMES = (1, 557, 835, 1114, 777)
GN_TIMED_FRAMES = 1114
GN_STEP_FRAMES = (557, 1114)
GN_STEPS = 20
GN_SPLIT_TIMEOUT = 600


def _step_device_ms(run) -> float:
    """Device ms of a whole K2 step, queued behind a sleep that outlasts the
    host's work to enqueue it."""
    return _device_ms(run, 20, STEP_SLEEP_CYCLES_PER_RUN)


def _k2_row_name(variant: str) -> str:
    return "fused_decode_step" if variant == "bf16" else f"fused_decode_step[{variant}]"


def _k6_row_name(variant: str) -> str:
    return f"attn_body[{variant}]"


def check_decode_step(record: dict) -> dict:
    """Every K2 variant against its plain version on synthetic inputs at full
    width. Returns {variant: kernel row} with the worst abs error and, at
    pos=500, the times at B=1 (the fast path's batch)."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import quantize_cache, quantize_stack, variant

    L, C, H, T = 30, 1024, 16, 768
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, std=1.0, base=0.0):
        return (base + std * torch.randn(shape, generator=g, device="cuda")) \
            .to(torch.bfloat16).contiguous()

    bf16_stack = {
        "ln1": torch.stack([rand(L, C, std=0.1, base=1.0), rand(L, C, std=0.1)], 1).contiguous(),
        "ln2": torch.stack([rand(L, C, std=0.1, base=1.0), rand(L, C, std=0.1)], 1).contiguous(),
        "wqkv": rand(L, 3 * C, C, std=C ** -0.5), "bqkv": rand(L, 3 * C, std=0.02),
        "wproj": rand(L, C, C, std=C ** -0.5), "bproj": rand(L, C, std=0.02),
        "wfc": rand(L, 4 * C, C, std=C ** -0.5), "bfc": rand(L, 4 * C, std=0.02),
        "wfc2": rand(L, C, 4 * C, std=(4 * C) ** -0.5), "bfc2": rand(L, C, std=0.02),
    }
    stacks = {"bf16": bf16_stack, "int8": quantize_stack(bf16_stack)}
    rows = {v: {"name": _k2_row_name(v), "route": "cuda", "source": K2_SOURCE,
                "replaces": K2_REPLACES, "max_abs_err": 0.0} for v in K2_VARIANTS}
    cases = []
    for b in (1, 16):
        bf16_cache = {"k": rand(L, b, T, C), "v": rand(L, b, T, C)}
        caches = {"bf16": bf16_cache, "int8": quantize_cache(bf16_cache, H)}
        x = rand(b, C)
        for wname, stacked in stacks.items():
            for cname, cache in caches.items():
                var = variant(stacked, cache)
                for pos in (0, 37, 500):
                    case = _k2_case(stacked, x, cache, pos, H, rows, cases)
                    if pos == 500:
                        timing = _k2_timing(stacked, x, cache, pos, H, 5)
                        case.update(timing)
                        # the batches of the fast path and ultra_fast beside the
                        # row's own time (the main path's B=96 where it runs)
                        rows[var].update({f"b{b}_ms": timing["ms"],
                                          f"b{b}_device_ms": timing["device_ms"],
                                          f"b{b}_bound_ms": timing["bound_ms"]})
                        if b == 1:
                            rows[var].update(timing, timed_at="B=1 pos=500", library_ms=None,
                                             library_device_ms=None)
    check_decode_step_bench_shapes(stacks, rows, cases, rand)
    record["k2"] = cases
    record["k2_steps"] = k2_step_times(bf16_stack, rand)
    return rows


# (batch, pos) of the bf16 step's times: the paths' batches at one position
K2_STEP_BATCHES = (1, 16, 64, 96, 128)
K2_STEP_POS, K2_STEP_T = 500, 768


def k2_step_times(stacked, rand) -> list:
    """The bf16 step at each of K2_STEP_BATCHES: the kernels it puts on the
    stream a step (fused_decode_step.device_launches over the timed runs)
    and its event and device ms beside its bound."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import fused_decode_step

    L, C, H = 30, 1024, 16
    out = []
    for b in K2_STEP_BATCHES:
        cache = {"k": rand(L, b, K2_STEP_T, C), "v": rand(L, b, K2_STEP_T, C)}
        x = rand(b, C)
        run = lambda: fused_decode_step(stacked, x, cache, K2_STEP_POS, H)
        run()
        launches, steps = fused_decode_step.device_launches, fused_decode_step.launches
        ms, device_ms = _time_ms(run, 20), _step_device_ms(run)
        per_step = ((fused_decode_step.device_launches - launches)
                    / (fused_decode_step.launches - steps))
        bound_ms, bound_by = _k2_bound(stacked, x, cache, K2_STEP_POS, L, C)
        row = {"B": b, "pos": K2_STEP_POS, "device_launches_per_step": per_step, "ms": ms,
               "device_ms": device_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K2 bf16 step B={b:3d} pos={K2_STEP_POS}: {per_step:g} kernel launch(es) a step, "
              f"event {ms:.3f} ms, device {device_ms:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        out.append(row)
        del cache
        torch.cuda.empty_cache()
    return out


def k2_smoke() -> int:
    """Phases 1-3 alone: the card, K2's build, K2 against its plain version
    and its step times."""
    import torch

    from tortoise_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": _nvidia_smi()}
    print(f"device: {record['device']}; nvidia-smi: {record['nvidia_smi']}")
    t0 = time.perf_counter()
    _build.build("decode_step")
    record["build_s"] = time.perf_counter() - t0
    rows = check_decode_step(record)
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_k2.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [rows[v] for v in K2_VARIANTS], "steps": record["k2_steps"]}))
    print(json.dumps({"ok": True}))
    return 0


def bench_k2_shapes(text_bucket: int) -> tuple[int, int]:
    """(cache rows T, last decode position) of a bench request of
    BENCH_TOKENS tokens: its prompt [cond | start, text, stop pad, bucket,
    stop | start_mel] (the longest of tts_batch's texts for bucket 64), the
    cache padded to a multiple of 256 as the sampler pads it."""
    from tortoise_tpu_torch import bench
    from tortoise_tpu_torch.utils.tokenizer import VoiceBpeTokenizer

    text = bench.SENTENCE if text_bucket == 32 else \
        f"{bench.SENTENCE} Utterance number {bench.SERVE_UTTERANCES - 1}."
    ids = len(VoiceBpeTokenizer().encode(text)) + 1
    prompt = 1 + -(-ids // text_bucket) * text_bucket + 2 + 1
    return -(-(prompt + BENCH_TOKENS) // 256) * 256, prompt + BENCH_TOKENS - 2


def _bench_k2_cache(g, var: str, b: int, t: int, heads: int, layers: int, c: int) -> dict:
    """A random cache of the bench's shape, made a layer at a time (at B=256
    the whole bf16 cache would take 16 GB before quantizing): bf16, or its
    rows quantized into an int8 cache as the sampler writes them."""
    import torch

    from tortoise_tpu_torch.models.gpt2 import quantize_kv_rows

    int8 = var.endswith("int8_cache")
    cache = {n: torch.empty((layers, b, t, c), dtype=torch.int8 if int8 else torch.bfloat16,
                            device="cuda") for n in ("k", "v")}
    if int8:
        cache.update({f"{n}_scale": torch.empty((layers, b, heads, t), device="cuda")
                      for n in ("k", "v")})
    for n in ("k", "v"):
        for l_ in range(layers):
            rows = torch.randn((b, t, c), generator=g, device="cuda").to(torch.bfloat16)
            if int8:
                q, sc = quantize_kv_rows(rows, heads)
                cache[n][l_], cache[f"{n}_scale"][l_] = q, sc.transpose(1, 2)
            else:
                cache[n][l_] = rows
    return cache


def check_decode_step_bench_shapes(stacks: dict, rows: dict, cases: list, rand) -> None:
    """Phase 3 at BENCH_K2_CASES: each variant against its plain version at
    pos 0, 37 and the request's last decode position, timed there (its
    b{B}_* keys in the variant's row)."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import variant

    L, C, H = 30, 1024, 16
    g = torch.Generator(device="cuda").manual_seed(2)
    for var, b, bucket in BENCH_K2_CASES:
        t, last = bench_k2_shapes(bucket)
        stacked = stacks["int8" if var.startswith("int8_weights") else "bf16"]
        cache = _bench_k2_cache(g, var, b, t, H, L, C)
        x = rand(b, C)
        assert variant(stacked, cache) == var
        for pos in (0, 37, last):
            case = _k2_case(stacked, x, cache, pos, H, rows, cases, bench=True)
        timing = _k2_timing(stacked, x, cache, last, H, 3)
        case.update(timing)
        rows[var].update({f"b{b}_{k}": timing[k]
                          for k in ("ms", "device_ms", "plain_ms", "bound_ms")})
        del cache
        torch.cuda.empty_cache()


def _k2_case(stacked, x, cache, pos, heads, rows, cases, **extra) -> dict:
    """One K2 step against its plain version: appends and returns the case
    (each output's max abs and per-row relative error), raises past
    K2_REL_BOUND, keeps the variant row's worst abs error."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import (fused_decode_step,
                                                    fused_decode_step_plain, variant)

    var, (_, b, t, _) = variant(stacked, cache), cache["k"].shape
    got = fused_decode_step(stacked, x, cache, pos, heads)
    torch.cuda.synchronize()
    want = fused_decode_step_plain(stacked, x, cache, pos, heads)
    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
    rel = [_row_rel_err(a, w) for a, w in zip(got, want)]
    case = {"variant": var, "B": b, "T": t, "pos": pos, "abs_err_hidden_k_v": errs,
            "row_rel_err_hidden_k_v": rel, "bound": K2_REL_BOUND, **extra}
    cases.append(case)
    print(f"K2 {var:24s} B={b:3d} T={t} pos={pos:3d} max|err| hidden/k/v "
          f"{errs[0]:.4g}/{errs[1]:.4g}/{errs[2]:.4g}, per-row rel "
          f"{rel[0]:.4g}/{rel[1]:.4g}/{rel[2]:.4g} (bound {K2_REL_BOUND})")
    if max(rel) > K2_REL_BOUND:
        raise AssertionError(f"K2 disagrees with its plain version: {case}")
    rows[var]["max_abs_err"] = max(rows[var]["max_abs_err"], max(errs))
    return case


def _k2_timing(stacked, x, cache, pos, heads, plain_reps: int) -> dict:
    """K2's event and device ms of one step at ``pos``, its plain version's
    ms over ``plain_reps`` runs, and its bound."""
    from tortoise_tpu_torch.ops.decode_step import (fused_decode_step,
                                                    fused_decode_step_plain, variant)

    layers, b, _, c = cache["k"].shape
    run = lambda: fused_decode_step(stacked, x, cache, pos, heads)
    ms, device_ms = _time_ms(run, 20), _step_device_ms(run)
    plain_ms = _time_ms(lambda: fused_decode_step_plain(stacked, x, cache, pos, heads),
                        plain_reps)
    bound_ms, bound_by = _k2_bound(stacked, x, cache, pos, layers, c)
    print(f"K2 {variant(stacked, cache):24s} B={b:3d} pos={pos}: kernel {ms:.3f} ms (device "
          f"{device_ms:.3f}), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def _k2_bound(stacked, x, cache, pos, layers, c):
    """K2's least time for one step: every weight once, the cache's rows
    0..pos-1 (and their scales), x in and out, the step's k/v rows out; two
    operations per weight and row, four per cached value attended."""
    b = x.shape[0]
    read = sum(_nbytes(t_[..., :pos] if "scale" in n else t_[:, :, :pos])
               for n, t_ in cache.items())
    nbytes = _nbytes(*stacked.values()) + 2 * _nbytes(x) + read + 2 * layers * b * c * 2
    flops = 2 * b * layers * 12 * c * c + 4 * b * layers * (pos + 1) * c
    return _bound(nbytes, flops, "bf16")


def check_flash_attention(record: dict) -> dict:
    """K3 against its plain version at B in {2, 1} and T in {256, 2229},
    each timed beside its plain version and SDPA with the bias and key mask
    as one float mask. The row's numbers are B=2, T=2229 (the fast preset's
    CFG batch); B=1, T=2229 (ultra_fast's) goes beside them as b1_*."""
    import torch

    import torch.nn.functional as F

    from tortoise_tpu_torch.ops.attn import (expand_rel_bias, flash_rel_attention,
                                             flash_rel_attention_plain)

    H, D = 16, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    cases, worst, row = [], 0.0, {}
    # (B, T, valid lengths): T - 5 and 3T/4 apart, and the bench's clip,
    # whose CFG rows share its valid length
    t_bench, n_bench = K3_BENCH_FRAMES
    for B, t, lens in ((2, 256, None), (2, 2229, None), (1, 256, None), (1, 2229, None),
                       (2, t_bench, [n_bench] * 2), (1, t_bench, [n_bench])):
        q, k, v = (torch.randn((B, H, t, D), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn((H, 2 * t - 1), generator=g, device="cuda").to(torch.bfloat16).float()
        valid = torch.tensor(lens or [t - 5, (3 * t) // 4][:B], dtype=torch.int32,
                             device="cuda")
        got = flash_rel_attention(q, k, v, bias, valid)
        torch.cuda.synchronize()
        want = flash_rel_attention_plain(q, k, v, bias, valid)
        err = max((got[b, :, :n] - want[b, :, :n]).float().abs().max().item()
                  for b, n in enumerate(valid.tolist()))
        ms = _time_ms(lambda: flash_rel_attention(q, k, v, bias, valid), 20)
        plain_ms = _time_ms(lambda: flash_rel_attention_plain(q, k, v, bias, valid), 5)
        # the library call: the bias and the key mask as one float mask
        keys = torch.arange(t, device="cuda")[None, :] < valid[:, None]
        mask = (expand_rel_bias(bias, t)[None]
                + torch.where(keys, 0.0, float("-inf"))[:, None, None, :]).to(torch.bfloat16)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        sdpa_err = max((sdpa()[b, :, :n] - want[b, :, :n]).float().abs().max().item()
                       for b, n in enumerate(valid.tolist()))
        library_ms = _time_ms(sdpa, 20)
        device_ms = _device_ms(lambda: flash_rel_attention(q, k, v, bias, valid), 20)
        library_device_ms = _device_ms(sdpa, 20)
        del mask
        n_valid = sum(valid.tolist())
        bound_ms, bound_by = _bound(
            2 * H * D * 2 * (B * t + n_valid) + _nbytes(bias, valid), 4 * H * D * t * n_valid,
            "bf16")
        cases.append({"B": B, "T": t, "valid_len": valid.tolist(), "err": err,
                      "bound": K3_ABS_BOUND, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "library_max_abs_err": sdpa_err,
                      "device_ms": device_ms, "library_device_ms": library_device_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"K3 B={B} H={H} T={t} valid={valid.tolist()}: max|err| {err:.4g} "
              f"(bound {K3_ABS_BOUND}); kernel {ms:.3f} ms (device {device_ms:.3f}), plain "
              f"{plain_ms:.3f} ms, SDPA {library_ms:.3f} ms (device {library_device_ms:.3f}, "
              f"max|err| {sdpa_err:.4g}), bound {bound_ms:.4f} ms ({bound_by})")
        if err > K3_ABS_BOUND:
            raise AssertionError(f"K3 disagrees with its plain version at B={B} T={t}: {err}")
        worst = max(worst, err)
        timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "device_ms": device_ms, "library_device_ms": library_device_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by}
        if t == 2229:
            row.update(timing if B == 2 else {f"b1_{k_}": x for k_, x in timing.items()})
        elif t == t_bench:
            row.update({f"b{B}_t{t}_{k_}": x for k_, x in timing.items()})
    record["k3"] = cases
    return {"name": K3_NAME, "route": "cuda",
            "source": "tortoise_tpu_torch/csrc/flash_rel_attn.cu",
            "replaces": "tortoise_tpu/ops/attn_pallas.py:89",
            "max_abs_err": worst, "timed_at": f"B=2 T=2229 (b1_*: B=1 T=2229; b1_t{t_bench}_*, "
                                              f"b2_t{t_bench}_*: the bench's clip)", **row}


def check_lvc(record: dict) -> dict:
    """K4 against its plain version at the main path's shapes (UnivNet c32,
    F=2186, B=1, f32), x as UnivNet hands it over, the kernels and bias both
    in the predictor's frames-innermost layout (what UnivNet passes) and
    with each frame's block contiguous; timed on the predictor's layout
    beside the plain version and the shifted-reshape einsum form (the JAX
    package's production LVC), and on the contiguous blocks. Each hop's row
    prints with its share of its bound. The returned row's times are the
    sums over one UnivNet forward's 12 calls (4 per hop), its bound that of
    their bytes and operations together."""
    import torch

    from tortoise_tpu_torch.models.vocoder import (location_variable_convolution,
                                                   random_predictor_output)
    from tortoise_tpu_torch.ops.lvc import (location_variable_convolution_lvc,
                                            location_variable_convolution_lvc_plain, plan_lvc)

    b, f, ci, co, k, layers = 1, LVC_FRAMES, 32, 64, 3, 4
    g = torch.Generator(device="cuda").manual_seed(4)
    cases, worst = [], 0.0
    per_forward = dict.fromkeys(("ms", "plain_ms", "library_ms", "device_ms",
                                 "library_device_ms", "blocks_device_ms"), 0.0)
    work = [0, 0]   # bytes, operations of one forward's calls
    for hop in LVC_HOPS:
        # x as UnivNet hands it over: the (B, T, Ci) view of a channels-first conv output
        x = torch.randn((b, ci, f * hop), generator=g, device="cuda").transpose(1, 2)
        # kernels and bias as the predictor leaves them: slices [:, l] of
        # (B, L, F, ...) views, frames innermost; and each frame's block contiguous
        kern_all, bias_all = random_predictor_output(g, b, layers, f, ci, co, k)
        kern, bias = kern_all[:, 2], bias_all[:, 2]
        kern_blocks, bias_blocks = kern.contiguous(), bias.contiguous()
        got = location_variable_convolution_lvc(x, kern, bias, hop)
        got_blocks = location_variable_convolution_lvc(x, kern_blocks, bias_blocks, hop)
        torch.cuda.synchronize()
        want = location_variable_convolution_lvc_plain(x, kern_blocks, bias_blocks, hop)
        scale = want.abs().max().item()
        err = max((got - want).abs().max().item(), (got_blocks - want).abs().max().item())
        einsum_err = (location_variable_convolution(x, kern, bias, hop) - want).abs().max().item()
        kernel = lambda: location_variable_convolution_lvc(x, kern, bias, hop)
        blocks = lambda: location_variable_convolution_lvc(x, kern_blocks, bias_blocks, hop)
        library = lambda: location_variable_convolution(x, kern, bias, hop)
        ms, library_ms = _time_ms(kernel, 20), _time_ms(library, 20)
        plain_ms = _time_ms(lambda: location_variable_convolution_lvc_plain(x, kern, bias, hop), 5)
        device_ms, library_device_ms = _device_ms(kernel, 20), _device_ms(library, 20)
        blocks_device_ms = _device_ms(blocks, 20)
        nbytes, flops = _nbytes(x, kern, bias, got), 2 * b * f * hop * co * ci * k
        bound_ms, bound_by = _bound(nbytes, flops, "f32")
        case = {"hop": hop, "F": f, "plan": plan_lvc(b, f, hop, ci, co, k, True),
                "max_abs_err": err, "rel_err": err / scale, "bound": K4_REL_BOUND,
                "einsum_rel_err": einsum_err / scale,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "device_ms": device_ms,
                "library_device_ms": library_device_ms, "blocks_device_ms": blocks_device_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / device_ms}
        cases.append(case)
        print(f"K4 hop={hop:3d} F={f}: max|err| {err:.4g} = {err / scale:.3g} x max|plain| "
              f"(bound {K4_REL_BOUND}, both layouts); kernel {ms:.4f} ms (device "
              f"{device_ms:.4f}; contiguous blocks {blocks_device_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, einsum {library_ms:.4f} ms (device {library_device_ms:.4f}), "
              f"bound {bound_ms:.4f} ms ({bound_by}): {bound_ms / device_ms:.0%} of the bound "
              f"on the device")
        if err > K4_REL_BOUND * scale:
            raise AssertionError(f"K4 disagrees with its plain version: {case}")
        worst = max(worst, err)
        calls = LVC_CALLS_PER_FORWARD // len(LVC_HOPS)
        for key in per_forward:
            per_forward[key] += case[key] * calls
        work[0] += nbytes * calls
        work[1] += flops * calls
        del x, kern_all, bias_all, kern, bias, kern_blocks, bias_blocks, got, got_blocks, want
    record["k4"] = cases
    bound_ms, bound_by = _bound(*work, "f32")
    print(f"K4, one forward's 12 calls: device {per_forward['device_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}): {bound_ms / per_forward['device_ms']:.0%} of the "
          f"bound")
    return {"name": K4_NAME, "route": "cuda", "source": "tortoise_tpu_torch/csrc/lvc.cu",
            "replaces": "tortoise_tpu/ops/lvc_pallas.py:52", "max_abs_err": worst,
            "timed_at": f"one UnivNet forward's 12 calls, F={f}", **per_forward,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _k1_inputs(g, b, c, q_dtype):
    import torch

    qkv = torch.randn((b, 3 * c), generator=g, device="cuda").to(q_dtype)
    return qkv.split(c, dim=-1)   # q, k_new, v_new: views, rows 3C apart


def _cycled(fn, layers: int):
    """A callable that calls ``fn(layer)`` with the next of ``layers``
    layers each time: each call reads a layer slice no call of the last
    layers - 1 read, so it finds none of it in L2, as the decode's layer
    loop does."""
    it = itertools.cycle(range(layers))
    return lambda: fn(next(it))


def k1_times(kernel, plain, q, kn, vn, cache, plain_cache, pos: int, heads: int,
             layer: int) -> dict:
    """K1 at one shape: event and device ms warm (every call on ``layer``)
    and cold (``_cycled`` over the cache's layers), beside its plain version
    and the row write plus scaled_dot_product_attention over the strided
    prefix views (the library yardstick, warm and cold), and its bound.
    ``kernel`` and ``plain`` are the wrapper and plain version of the
    package under test. Every timed call writes the same k/v row at pos of
    the layer it takes; afterwards ``plain_cache`` gets those rows too, so
    the two caches stay equal."""
    import torch
    import torch.nn.functional as F

    L, b, _, c = cache["k"].shape
    dh = c // heads
    c_dtype = cache["k"].dtype

    def k1(l):
        return kernel(q, kn, vn, cache["k"], cache["v"], l, pos, heads=heads)

    def plain_at(l):
        return plain(q, kn, vn, plain_cache["k"], plain_cache["v"], l, pos, heads=heads)

    def sdpa(l):
        kc, vc = cache["k"][l], cache["v"][l]
        kc[:, pos], vc[:, pos] = kn.to(c_dtype), vn.to(c_dtype)
        view = lambda t_: t_[:, :pos + 1].view(b, pos + 1, heads, dh).transpose(1, 2)
        return F.scaled_dot_product_attention(q.to(c_dtype).reshape(b, heads, 1, dh), view(kc),
                                              view(vc))

    warm = lambda fn: lambda: fn(layer)
    t = {"ms_warm": _time_ms(warm(k1), 20), "device_ms_warm": _device_ms(warm(k1), 20),
         "library_ms_warm": _time_ms(warm(sdpa), 20),
         "library_device_ms_warm": _device_ms(warm(sdpa), 20),
         "ms": _time_ms(_cycled(k1, L), 2 * L), "device_ms": _device_ms(_cycled(k1, L), 2 * L),
         "library_ms": _time_ms(_cycled(sdpa, L), 2 * L),
         "library_device_ms": _device_ms(_cycled(sdpa, L), 2 * L),
         "plain_ms": _time_ms(_cycled(plain_at, L), 5)}
    for n, new in (("k", kn), ("v", vn)):
        plain_cache[n][:, :, pos] = new.to(c_dtype)
    t["bound_ms"], t["bound_by"] = _bound(
        _nbytes(q, kn, vn) + q.numel() * q.element_size()
        + 2 * b * (pos + 1) * c * cache["k"].element_size(), 4 * b * (pos + 1) * c, "f32")
    t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
    return t


def check_decode_attention_merged(record: dict, C: int = 1024, H: int = 16,
                                  batches: tuple = (1, 8, 16, 64, 96), key: str = "k1") -> dict:
    """K1 against its plain version at full width over bf16 and f32 caches:
    every (batch row, head) within its bound, the row write bit-exact and
    every other row untouched (the whole cache equals the plain version's
    after each call). Timed at pos=500 (``k1_times``), warm and with a cold
    L2; the row's numbers are the cold ones at B=16, pos=500, bf16 cache.
    ``C`` and ``H`` are one rank's channels and heads (phase 14 checks
    tp=2's half)."""
    import torch

    from tortoise_tpu_torch.ops.attn import decode_attention_merged, decode_attention_merged_plain

    L, T, layer = 30, 768, 7
    g = torch.Generator(device="cuda").manual_seed(5)
    cases, row, worst = [], None, 0.0
    for q_dtype, c_dtype, bound in ((torch.bfloat16, torch.bfloat16, K1_BF16_BOUND),
                                    (torch.float32, torch.float32, K1_F32_BOUND),
                                    (torch.bfloat16, torch.float32, K1_BF16_BOUND)):
        what = f"C={C} H={H}, q {str(q_dtype)[6:]}, cache {str(c_dtype)[6:]}"
        for b in batches:
            cache = {n: torch.randn((L, b, T, C), generator=g, device="cuda").to(c_dtype)
                     for n in "kv"}
            plain = {n: t_.clone() for n, t_ in cache.items()}
            for pos in (0, 37, 500, 767):
                q, kn, vn = _k1_inputs(g, b, C, q_dtype)
                got = decode_attention_merged(q, kn, vn, cache["k"], cache["v"], layer, pos,
                                              heads=H)
                torch.cuda.synchronize()
                want = decode_attention_merged_plain(q, kn, vn, plain["k"], plain["v"], layer,
                                                     pos, heads=H)
                exact = torch.equal(cache["k"], plain["k"]) and torch.equal(cache["v"], plain["v"])
                err = _head_rel_err(got, want, H)
                abs_err = (got.float() - want.float()).abs().max().item()
                case = {"q": str(q_dtype), "cache": str(c_dtype), "B": b, "pos": pos,
                        "head_rel_err": err, "max_abs_err": abs_err, "bound": bound,
                        "cache_equal": exact}
                if pos == 500:
                    case.update(k1_times(decode_attention_merged, decode_attention_merged_plain,
                                         q, kn, vn, cache, plain, pos, H, layer))
                    print(f"K1 {what} B={b:2d} pos=500: cold event {case['ms']:.4f} ms, device "
                          f"{case['device_ms']:.4f} ({case['share_of_bound']:.0%} of the bound "
                          f"{case['bound_ms']:.4f}, {case['bound_by']}); warm event "
                          f"{case['ms_warm']:.4f}, device {case['device_ms_warm']:.4f}; row "
                          f"write + SDPA cold {case['library_ms']:.4f} / "
                          f"{case['library_device_ms']:.4f}, warm {case['library_ms_warm']:.4f} "
                          f"/ {case['library_device_ms_warm']:.4f}; plain {case['plain_ms']:.4f}")
                    if b == 16 and c_dtype == torch.bfloat16:
                        row = {k_: case[k_] for k_ in ("ms", "plain_ms", "library_ms",
                                                        "device_ms", "library_device_ms",
                                                        "bound_ms", "bound_by")}
                cases.append(case)
                print(f"K1 {what} B={b:2d} pos={pos:3d}: max head rel err {err:.4g} (bound "
                      f"{bound}), max|err| {abs_err:.4g}, cache equal to plain's: {exact}")
                if err > bound or not exact:
                    raise AssertionError(f"K1 disagrees with its plain version: {case}")
                worst = max(worst, abs_err)
            del cache, plain
            torch.cuda.empty_cache()
    record[key] = cases
    return {"name": K1_NAME, "route": "cuda",
            "source": "tortoise_tpu_torch/csrc/decode_attn_merged.cu",
            "replaces": "tortoise_tpu/ops/attn_pallas.py:215", "max_abs_err": worst,
            "timed_at": f"B=16 pos=500 T=768 C={C} H={H} bf16 cache, cold L2", **row}


def check_k1_one_kernel(record: dict) -> None:
    """One K1 call under torch.profiler at B=1 and B=16 (full width, T=768,
    pos=500, bf16): the call must run exactly one device kernel, K1's. Runs
    after every timing of the process (a profiler session slows the
    launches after it) and before profile_diffusion_step's process: after
    that process, a window of this one recorded no device event at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops.attn import decode_attention_merged
    from tortoise_tpu_torch.utils.profiling import device_events

    g = torch.Generator(device="cuda").manual_seed(9)
    seen = {}
    for b in (1, 16):
        cache = {n: torch.randn((2, b, 768, 1024), generator=g, device="cuda").to(torch.bfloat16)
                 for n in "kv"}
        q, kn, vn = _k1_inputs(g, b, 1024, torch.bfloat16)
        call = lambda: decode_attention_merged(q, kn, vn, cache["k"], cache["v"], 1, 500,
                                               heads=16)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        seen[b] = [e["name"] for e in device_events(prof, f"one K1 call at B={b}")]
        print(f"K1 one call under the profiler, B={b}: device kernels {seen[b]}")
    record["k1_device_kernels_a_call"] = seen
    if any(len(names) != 1 or "decode_attn_merged_kernel" not in names[0]
           for names in seen.values()):
        raise AssertionError(f"a K1 call must run exactly one device kernel, K1's: {seen}")


def _ssm_inputs(g, layers: int, state_scale: float):
    """S1's inputs at B=SSM_BATCH: the in-projection's row (B, C, x and dt
    are views of it, as on the main path), the conv's and the head's
    parameters, and ``layers`` layers' (state, conv state)."""
    import torch

    from tortoise_tpu_torch.ops.ssm_step import D_CONV, D_STATE, HEAD_DIM

    rand = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device="cuda") * scale
    inner = SSM_HEADS * HEAD_DIM
    conv_dim = inner + 2 * D_STATE
    zxbcdt = rand(SSM_BATCH, inner + conv_dim + SSM_HEADS).to(torch.bfloat16)
    params = (rand(conv_dim, 1, D_CONV, scale=0.5).to(torch.bfloat16),
              rand(conv_dim, scale=0.1).to(torch.bfloat16),
              rand(SSM_HEADS, scale=0.5), rand(SSM_HEADS, scale=0.5), rand(SSM_HEADS))
    states = [(rand(SSM_BATCH, SSM_HEADS, HEAD_DIM, D_STATE, scale=state_scale)
               .to(torch.bfloat16), rand(SSM_BATCH, conv_dim, D_CONV - 1).to(torch.bfloat16))
              for _ in range(layers)]
    return zxbcdt, zxbcdt[:, inner:inner + conv_dim], zxbcdt[:, inner + conv_dim:], params, states


def _ssm_chain(seed: int, fault: str | None = None) -> dict:
    """SSM_STEPS chained steps of S1 against its plain version (see
    SSM_STEPS), ``fault`` planted on the kernel's side; the worst readings."""
    import torch

    from tortoise_tpu_torch.ops.ssm_step import ssm_decode_step, ssm_decode_step_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    zxbcdt, xbc, dt, (conv_w, conv_b, dt_bias, a_log, d), [(state, conv)] = \
        _ssm_inputs(g, 1, 0.3)
    inner = xbc.shape[1] - 2 * state.shape[-1]
    counters = torch.zeros(SSM_BATCH, dtype=torch.int32, device="cuda")
    plain_state, plain_conv = state.clone(), conv.clone()
    out = {"y_rel_err": 0.0, "y_max_abs_err": 0.0, "state_steps": 0.0, "state_diff_share": 0.0,
           "conv_state_equal": True, "counters_zero": True}
    for step in range(SSM_STEPS):
        if step:
            zxbcdt.copy_(torch.randn(zxbcdt.shape, generator=g, device="cuda"))
        if fault == "decay_one_bf16_step":
            state.mul_(1 - 2 ** -8)
        kept = conv[:, inner:].clone() if fault == "bc_shift_skipped" else None
        y = ssm_decode_step(xbc, dt, conv, conv_w, conv_b, dt_bias, a_log, d, state, counters)
        if kept is not None:
            conv[:, inner:].copy_(kept)
        want = ssm_decode_step_plain(xbc, dt, plain_conv, conv_w, conv_b, dt_bias, a_log, d,
                                     plain_state)
        ws = plain_state.float()
        step_size = ws.abs().amax((-2, -1), keepdim=True) * 2.0 ** -7
        err = (y - want).abs().max().item()
        out["y_max_abs_err"] = max(out["y_max_abs_err"], err)
        out["y_rel_err"] = max(out["y_rel_err"], err / want.abs().max().item())
        out["state_steps"] = max(out["state_steps"],
                                 ((state.float() - ws).abs() / step_size).max().item())
        out["state_diff_share"] = max(out["state_diff_share"],
                                      (state != plain_state).float().mean().item())
        out["conv_state_equal"] &= bool(torch.equal(conv, plain_conv))
        out["counters_zero"] &= int(counters.abs().sum()) == 0
    return out


def _ssm_within(r: dict) -> bool:
    return (r["y_rel_err"] <= SSM_Y_REL_BOUND and r["state_steps"] <= SSM_STATE_STEPS
            and r["state_diff_share"] <= SSM_STATE_DIFF_SHARE and r["conv_state_equal"]
            and r["counters_zero"])


def check_ssm_step(record: dict) -> dict:
    """Phase 17's first half: S1 against its plain version over SSM_STEPS
    chained steps at B=96, within its bounds, and each of SSM_FAULTS
    planted on the kernel's side outside them; then timed alone, an event
    time a call with the L2 flushed before it (a 64 MB write), a device time
    (calls back to back, alternating two layers' states of 100 MB each) and
    its plain version's event time, beside its bound (the operations and
    bytes of portbench/kernels/ssm_step.py, the benchmark's roofline).
    Returns the kernel's row."""
    import torch

    from portbench.kernels.ssm_step import step as ssm_step_count
    from tortoise_tpu_torch.ops.ssm_step import (D_CONV, D_STATE, HEAD_DIM, ssm_decode_step,
                                                 ssm_decode_step_plain)

    sound = _ssm_chain(17)
    print(f"S1 against its plain version, B={SSM_BATCH}, {SSM_STEPS} chained steps: "
          f"{json.dumps(sound)}")
    if not _ssm_within(sound):
        raise AssertionError(f"S1 disagrees with its plain version: {sound}")
    planted = {}
    for fault in SSM_FAULTS:
        planted[fault] = _ssm_chain(17, fault)
        print(f"S1 with {fault} planted: {json.dumps(planted[fault])}")
        if _ssm_within(planted[fault]):
            raise AssertionError(f"S1's check misses a planted fault, {fault}: "
                                 f"{planted[fault]}")

    # two layers' states, each 100 MB, in turn: no call finds its state in L2
    _, xbc, dt, (conv_w, conv_b, dt_bias, a_log, d), states = \
        _ssm_inputs(torch.Generator(device="cuda").manual_seed(18), 2, 0.1)
    counters = torch.zeros(SSM_BATCH, dtype=torch.int32, device="cuda")
    call = lambda i: ssm_decode_step(xbc, dt, states[i][1], conv_w, conv_b, dt_bias, a_log, d,
                                     states[i][0], counters)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(51):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call(i % 2)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    event_ms = sorted(times[1:])[len(times) // 2]
    turn = itertools.count()
    dev_ms = _device_ms(lambda: call(next(turn) % 2), 50)
    plain_ms = _time_ms(lambda: ssm_decode_step_plain(
        xbc, dt, states[0][1], conv_w, conv_b, dt_bias, a_log, d, states[0][0]), 5)
    ops, nbytes = ssm_step_count(SSM_BATCH, SSM_HEADS, HEAD_DIM, D_STATE, D_CONV)
    bound_ms, bound_by = _bound(nbytes, ops, "f32")
    row = {"name": SSM_NAME, "route": "CUDA sm_90a, port-only (no TPU kernel)",
           "source": SSM_SOURCE, "replaces": "none (port-only)",
           "max_abs_err": sound["y_max_abs_err"], "ms": event_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "device_ms": dev_ms, "library_device_ms": None,
           "share_of_bound_device": bound_ms / dev_ms, "bytes": nbytes}
    record["ssm_step"] = {"sound": sound, "planted": planted, "row": row}
    print(f"S1 at B={SSM_BATCH}: event {event_ms:.4f} ms cold, device {dev_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes} bytes): "
          f"{100 * bound_ms / dev_ms:.1f}% of it")
    return row


def run_granite(clips, record: dict, launches: Launches) -> None:
    """Phase 17's second half, after this process's last timing: the
    full-width TextToSpeech over the hybrid prior (GraniteVoiceConfig,
    seeded random weights) answers GRANITE_REQUEST, its launch counters set
    to 0 before it and read after: S1 launched 36 times a decode step
    (``ar_sampler._step`` calls), no K2, the first step captured and every
    later one a graph replay. Then one more decode step, a replay, under
    torch.profiler: its device kernels hold S1 as often as the replay adds
    to S1's counter. The prior is freed after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.models import ar_sampler
    from tortoise_tpu_torch.models.granite_hybrid import GraniteVoiceConfig
    from tortoise_tpu_torch.ops.ssm_step import ssm_decode_step
    from tortoise_tpu_torch.utils.profiling import device_events

    print("--- phase 17: the hybrid AR prior, a full-width fast request")
    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False, ar_config=GraniteVoiceConfig())
    init_s = time.perf_counter() - t0
    mamba_layers = len(tts.ar_cfg.mamba_layers)
    steps = [0]
    step = ar_sampler._step

    def counted(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    ar_sampler._step = counted
    model = tts.autoregressive
    captures, replays = model.graphs.captures, model.graphs.replays
    launches.reset()
    try:
        preset, text, seed = GRANITE_REQUEST
        res, _ = _quality_request(tts, clips, preset, text, seed, launches)
    finally:
        ar_sampler._step = step
    counts = launches.read()
    launches.add(counts, "run_granite")
    res.update(init_s=init_s, decode_steps=steps[0],
               graph_captures=model.graphs.captures - captures,
               graph_replays=model.graphs.replays - replays,
               decode_batches=[b for b, _ in model._caches])
    if (res["launches"].get(SSM_NAME) != mamba_layers * steps[0] or steps[0] <= 1
            or res["decode_batches"] != [FAST_CANDIDATES] or res["graph_captures"] != 1
            or res["graph_replays"] != steps[0] - 1
            or any(k.startswith("fused_decode_step") for k in res["launches"])):
        raise AssertionError(f"the hybrid request must launch S1 {mamba_layers} times in each "
                             f"of its decode steps, no K2, at B={FAST_CANDIDATES}, one capture "
                             f"and a replay every later step: {res}")

    cache = model.decode_cache(FAST_CANDIDATES, model.mel_head.weight.device)
    x = torch.randn((FAST_CANDIDATES, tts.ar_cfg.model_dim), device="cuda").to(torch.bfloat16)
    before, replays = ssm_decode_step.launches, model.graphs.replays
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.decode_step(x, cache)
            torch.cuda.synchronize()
    added = ssm_decode_step.launches - before
    on_device = sum(SSM_NAME in e["name"] for e in device_events(prof, "one graph replay"))
    res.update(replay_s1_counted=added, replay_s1_on_device=on_device)
    record["granite"] = res
    print(f"hybrid request: {res['decode_steps']} decode steps, {counts[SSM_NAME]} S1 launches, "
          f"one replay under the profiler: {on_device} S1 kernels on the device, {added} counted")
    if added != mamba_layers or on_device != mamba_layers \
            or model.graphs.replays != replays + 1:
        raise AssertionError(f"a graph replay must run S1 {mamba_layers} times on the device and "
                             f"count as many: {on_device} ran, {added} counted, "
                             f"{model.graphs.replays - replays} replays")
    del tts, model, cache
    gc.collect()
    torch.cuda.empty_cache()


def granite_smoke() -> int:
    """``--granite``: phases 1 and 2 for the sources the hybrid request
    runs, then phase 17 alone; the kernels line holds S1's row."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    from tortoise_tpu_torch.ops import _build
    from tortoise_tpu_torch.utils.audio import load_voice

    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {_nvidia_smi()}; torch {torch.__version__}")
    record = {"device": kind}
    t0 = time.perf_counter()
    sources = ("ssm_step", "flash_rel_attn", "lvc")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        usage = pool.submit(_build.resource_usage, "ssm_step")
        list(pool.map(_build.build, sources))
        record["ssm_ptxas"] = [ln.strip() for ln in usage.result().splitlines()
                               if "Used" in ln or "spill" in ln or "entry function" in ln]
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s; S1, nvcc -Xptxas -v:\n  "
          + "\n  ".join(record["ssm_ptxas"]))
    row = check_ssm_step(record)
    clips, _ = load_voice("train_dotrice")
    launches = Launches()
    run_granite(clips, record, launches)
    row["launches"] = launches.total[SSM_NAME]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_granite.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _gn_forms() -> dict:
    """group_norm_act's site forms in the diffusion decoder: (film, silu,
    out dtype)."""
    import torch

    return {"affine": (False, False, torch.bfloat16), "silu": (False, True, torch.bfloat16),
            "film_silu_mask": (True, True, torch.bfloat16),
            "f32_out": (False, True, torch.float32)}


def _gn_inputs(t: int):
    """B=2, C=1024 (32 groups of 32 channels): x, the mask of one full row
    and one 61 frames short, the affine and a FiLM pair."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(t)
    valid = torch.tensor([t, max(t - 61, 1)], device="cuda")
    x = (torch.randn((2, t, 1024), generator=g, device="cuda") * 1.5 + 0.3).to(torch.bfloat16)
    mask = torch.arange(t, device="cuda")[None, :] < valid[:, None]
    weight = 1 + 0.3 * torch.randn((1024,), generator=g, device="cuda")
    bias = 0.2 * torch.randn((1024,), generator=g, device="cuda")
    film = (0.5 * torch.randn((2, 2048), generator=g, device="cuda")).to(torch.bfloat16)
    return x, mask, weight, bias, film


def check_group_norm(record: dict) -> dict:
    """Phase 18's first half: group_norm_act against its plain version at
    GN_FRAMES in each site form: the normalised value within one bf16 ulp
    (the float32 statistics are summed in another order; float32 rounding
    where the affine cancels to near zero), the rest of the
    chain bit for bit PyTorch's ops on it, padded frames zero. Then each form
    timed at B=2 over GN_TIMED_FRAMES: event ms a call (warm L2, as in the
    decoder, whose previous kernel has just written x), device ms (calls
    back to back) and the plain chain's event ms, beside the byte bound (x,
    mask, parameters and film read once, y written once). Returns the
    kernel's row, at the FiLM + SiLU form (20 of a forward's 46 norms)."""
    import torch

    from tortoise_tpu_torch.ops.group_norm import group_norm_act, group_norm_act_plain

    checks = []
    for t in GN_FRAMES:
        x, mask, weight, bias, film = _gn_inputs(t)
        for form, (use_film, silu, out_dtype) in _gn_forms().items():
            f = film if use_film else None
            got = group_norm_act(x, mask, weight, bias, 32, 1e-5, f, silu, out_dtype)
            norm = group_norm_act(x, mask, weight, bias, 32, 1e-5, out_dtype=out_dtype)
            plain_norm = group_norm_act_plain(x, mask, weight, bias, 32, 1e-5,
                                              out_dtype=out_dtype)
            diff = (norm.float() - plain_norm.float()).abs()
            # one bf16 ulp, or float32 rounding (2^-16 of the call's largest
            # value) where the affine cancels to a value near zero
            ulp = torch.maximum(torch.exp2(torch.floor(torch.log2(
                plain_norm.float().abs().clamp(min=2.0 ** -126))) - 7),
                2.0 ** -16 * plain_norm.float().abs().max())
            want = norm
            if f is not None:
                scale, shift = f[:, None, :].chunk(2, dim=-1)
                want = want * (1 + scale) + shift
            if silu:
                want = torch.nn.functional.silu(want)
            if f is not None or silu:
                want = want * mask[:, :, None].to(want.dtype)
            plain = group_norm_act_plain(x, mask, weight, bias, 32, 1e-5, f, silu, out_dtype)
            case = {"T": t, "form": form, "norm_err_over_tol": (diff / ulp).max().item(),
                    "norm_equal_share": (diff == 0).float().mean().item(),
                    "chain_equal": torch.equal(got, want),
                    "padded_zero": bool((got[~mask] == 0).all()),
                    "max_abs_err": (got.float() - plain.float()).abs().max().item()}
            checks.append(case)
            if case["norm_err_over_tol"] > 1 or not case["chain_equal"] or not case["padded_zero"]:
                raise AssertionError(f"group_norm_act disagrees with its plain version: {case}")
    print(f"group_norm_act against its plain version, B=2, C=1024, T in {GN_FRAMES}, "
          f"{len(_gn_forms())} forms: normalised value off by at most "
          f"{max(c['norm_err_over_tol'] for c in checks):.2f} of its tolerance (a bf16 ulp), "
          f"{min(c['norm_equal_share'] for c in checks):.4f} or more of it equal; the chain "
          f"after it bit for bit; max |kernel - plain| "
          f"{max(c['max_abs_err'] for c in checks):.4g}")

    x, mask, weight, bias, film = _gn_inputs(GN_TIMED_FRAMES)
    timings = {}
    for form, (use_film, silu, out_dtype) in _gn_forms().items():
        f = film if use_film else None
        call = lambda: group_norm_act(x, mask, weight, bias, 32, 1e-5, f, silu, out_dtype)
        plain = lambda: group_norm_act_plain(x, mask, weight, bias, 32, 1e-5, f, silu,
                                             out_dtype)
        nbytes = _nbytes(x, mask, weight, bias, *([f] if use_film else [])) \
            + x.numel() * out_dtype.itemsize
        bound_ms, bound_by = _bound(nbytes, 12 * x.numel(), "f32")
        timings[form] = {"ms": _time_ms(call, 50), "device_ms": _device_ms(call, 50),
                         "plain_ms": _time_ms(plain, 10), "bound_ms": bound_ms,
                         "bound_by": bound_by, "bytes": nbytes}
        r = timings[form]
        print(f"group_norm_act {form:14s} B=2 T={GN_TIMED_FRAMES}: event {r['ms']:.4f} ms, "
              f"device {r['device_ms']:.4f} ms ({100 * bound_ms / r['device_ms']:.1f}% of "
              f"{bound_ms:.4f} ms, {bound_by}); plain chain {r['plain_ms']:.4f} ms", flush=True)
    main = timings["film_silu_mask"]
    row = {"name": GN_NAME, "route": "CUDA sm_90a, port-only (no TPU kernel)",
           "source": GN_SOURCE, "replaces": "none (port-only: the JAX package leaves GroupNorm "
                                            "to XLA)",
           "max_abs_err": max(c["max_abs_err"] for c in checks), "ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": None, "device_ms": main["device_ms"],
           "library_device_ms": None}
    record["group_norm"] = {"checks": checks, "timings": timings, "row": row}
    return row


def _step_family(name: str) -> str:
    """A diffusion step's device kernels by what they do."""
    low = name.lower()
    for fragment, fam in (("group_norm_act", "group_norm_act"), ("flash_rel_attn", "K3"),
                          ("nchwtonhwc", "cuDNN layout"), ("nhwctonchw", "cuDNN layout"),
                          ("conv", "convolutions"), ("gemm", "products"),
                          ("nvjet", "products"), ("xmma", "products"), ("cutlass", "products"),
                          ("reduce_kernel", "reductions"), ("elementwise", "elementwise")):
        if fragment in low:
            return fam
    return "other"


def diffusion_norm_split(record: dict) -> None:
    """Phase 18's second half: profile_diffusion_step's served step (its
    full-width model, K3, B=2) at GN_STEP_FRAMES, with the kernel and with
    every norm chain op by op (``group_norm.engages`` refusing; each side
    captures its own graph): the event ms a step over GN_STEPS replays and
    the kernel's launches a step first, then one profiler pass a side: the
    device's kernels a step and their ms a step by family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops import group_norm
    from tortoise_tpu_torch.tools import profile_diffusion_step as pds
    from tortoise_tpu_torch.utils import measure
    from tortoise_tpu_torch.utils.profiling import device_events

    dev = torch.device("cuda")
    model = pds.build_model(dev)
    engages = group_norm.engages
    sides = {"plain": lambda *a, **k: False, "kernel": engages}
    rows = {}
    try:
        with torch.inference_mode():
            for t in GN_STEP_FRAMES:
                for side, fn in sides.items():
                    group_norm.engages = fn
                    model.graphs.clear()
                    before = group_norm.group_norm_act.launches
                    r = measure.time_steps(pds.step_run(model, 2, t, True, dev), GN_STEPS, dev)
                    r["group_norm_act_a_step"] = \
                        (group_norm.group_norm_act.launches - before) / (GN_STEPS + 1)
                    rows[f"{side} T={t}"] = r
            # the profiler passes, after every timing
            for t in GN_STEP_FRAMES:
                for side, fn in sides.items():
                    group_norm.engages = fn
                    model.graphs.clear()
                    run = pds.step_run(model, 2, t, True, dev)
                    run(1)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        run(GN_STEPS)
                        torch.cuda.synchronize()
                    events = device_events(prof, f"{GN_STEPS} diffusion steps")
                    by_family: dict = {}
                    for e in events:
                        fam = _step_family(e["name"])
                        by_family[fam] = by_family.get(fam, 0.0) \
                            + (e["end_us"] - e["start_us"]) / 1e3 / GN_STEPS
                    r = rows[f"{side} T={t}"]
                    r.update(kernels_a_step=len(events) / GN_STEPS,
                             busy_ms=sum(by_family.values()), ms_by_family=by_family)
    finally:
        group_norm.engages = engages
        model.graphs.clear()
    record["diffusion_norm_split"] = rows
    for name, r in rows.items():
        fams = ", ".join(f"{k} {v:.3f}" for k, v in sorted(r["ms_by_family"].items(),
                                                            key=lambda kv: -kv[1]))
        print(f"diffusion step {name}: event {r['device_ms']:.3f} ms, host {r['host_ms']:.3f} "
              f"ms, {r['kernels_a_step']:.0f} kernels and {r['group_norm_act_a_step']:.0f} "
              f"group_norm_act a step; device ms by family: {fams}", flush=True)
    for t in GN_STEP_FRAMES:
        if rows[f"kernel T={t}"]["group_norm_act_a_step"] != 46 \
                or rows[f"plain T={t}"]["group_norm_act_a_step"] != 0:
            raise AssertionError(f"a served step must launch group_norm_act 46 times: {rows}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def group_norm_split_worker() -> int:
    """``--group-norm-split``: ``diffusion_norm_split`` alone, its rows on
    the last line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    record = {}
    diffusion_norm_split(record)
    print(json.dumps(record["diffusion_norm_split"]))
    return 0


def run_group_norm_split(record: dict) -> None:
    """Phase 18's second half in a process of its own, after this process's
    last profiler window (run in this process before run_tools, its passes
    left check_k1_one_kernel's window with no device event on the H100).
    Fails if the worker does."""
    import subprocess

    print("--- phase 18: python3 chip_smoke.py --group-norm-split")
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--group-norm-split"],
                         cwd=ROOT, capture_output=True, text=True, timeout=GN_SPLIT_TIMEOUT)
    print(run.stdout[-3000:])
    if run.returncode:
        raise AssertionError(f"the group norm split worker exited {run.returncode}: "
                             f"{run.stderr[-3000:]}")
    record["diffusion_norm_split"] = json.loads(run.stdout.strip().splitlines()[-1])


def group_norm_smoke() -> int:
    """``--group-norm``: phase 18 alone (group_norm_act against its plain
    version, timed, and the diffusion step with and without it); the
    kernels line holds its row."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    from tortoise_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; nvidia-smi: {_nvidia_smi()}; torch {torch.__version__}")
    record = {"device": kind}
    t0 = time.perf_counter()
    sources = ("group_norm", "flash_rel_attn")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        usage = pool.submit(_build.resource_usage, "group_norm")
        list(pool.map(_build.build, sources))
        record["group_norm_ptxas"] = [ln.strip() for ln in usage.result().splitlines()
                                      if "Used" in ln or "spill" in ln]
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s; group_norm_act, nvcc -Xptxas "
          "-v:\n  " + "\n  ".join(record["group_norm_ptxas"]))
    row = check_group_norm(record)
    diffusion_norm_split(record)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_group_norm.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _head_rel_err(got, want, heads: int) -> float:
    """Largest error over (batch row, head) of a (B, C) attention output,
    each relative to that head's max|want|."""
    b, c = want.shape
    g = got.float().reshape(b, heads, c // heads)
    w = want.float().reshape(b, heads, c // heads)
    err = (g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)
    return err.max().item()


def _row_rel_err(got, want) -> float:
    """Largest error over rows (the last dim) relative to that row's max|want|."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1e-6)).max().item()


def _prefilled_main_path(tts, clips, cache_dtype):
    """The fast request's last decode step: 96 candidates, a cache of
    ``cache_dtype`` filled by a real prefill of the request's prompt plus
    498 teacher-forced mel tokens through the layer stack (which quantizes
    the rows into an int8 cache), padded to a multiple of 256 as the sampler
    pads it. Returns (cache, the step's embedding (B, 1, C), pos, prompt rows)."""
    import random

    import numpy as np
    import torch

    from tortoise_tpu_torch.models.gpt2 import init_kv_cache

    ar, cfg = tts.autoregressive, tts.autoregressive.config
    max_gen = 500
    b = min(FAST_CANDIDATES, tts.autoregressive_batch_size)
    g = torch.Generator(device="cuda").manual_seed(2)
    ids = np.pad(np.asarray(tts.tokenizer.encode(FAST_TEXT))[None], ((0, 0), (0, 1)))
    tb = -(-ids.shape[1] // tts.text_bucket) * tts.text_bucket
    text = torch.as_tensor(np.pad(ids, ((0, 0), (0, tb - ids.shape[1]))), device="cuda")
    latent, _ = tts.get_conditioning_latents(clips, crop_rng=random.Random(0))
    prompt = ar.compute_prompt(latent, text).expand(b, -1, -1)
    p_len = prompt.shape[1]
    steps = max_gen - 2                      # the last step the sampler takes
    pos = p_len + steps
    t_cache = -(-(p_len + max_gen) // 256) * 256
    toks = torch.randint(0, cfg.start_mel_token, (b, steps + 1), generator=g, device="cuda")
    mel = torch.cat([ar.decode_embed(toks[:, s:s + 1], s) for s in range(steps)], dim=1)
    cache = init_kv_cache(cfg.gpt_config, b, t_cache, dtype=cache_dtype, device="cuda")
    ar.gpt(torch.cat([prompt, mel], dim=1), cache=cache, cache_index=0)
    print(f"decode main path: B={b} prompt {p_len} rows, {cache['k'].dtype} cache T={t_cache}, "
          f"pos={pos}")
    return cache, ar.decode_embed(toks[:, steps:], steps), pos, p_len


def _layerwise(stacked, cache, x, pos, heads, layers, faults):
    """K2 one layer at a time against the plain version, each layer given the
    plain version's input. ``faults``: {name: fn(layer cache, kernel output)
    -> (faulty layer cache, pos)} read by the plain version, whose attention
    must move past the bound. Returns (attention head rel err, hidden row rel
    err, {fault: head rel err})."""
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    attn_err, hidden_err = 0.0, 0.0
    planted = dict.fromkeys(faults, 0.0)
    for l in range(layers):
        st = {n: t_[l:l + 1] for n, t_ in stacked.items()}
        ca = {n: t_[l:l + 1] for n, t_ in cache.items()}
        got = fused_decode_step(st, x, ca, pos, heads, with_attention=True)
        want = fused_decode_step_plain(st, x, ca, pos, heads, with_attention=True)
        attn_err = max(attn_err, _head_rel_err(got[3], want[3], heads))
        hidden_err = max(hidden_err, _row_rel_err(got[0], want[0]))
        for name, fault in faults.items():
            bad, p = fault(ca, got)
            wrong = fused_decode_step_plain(st, x, bad, p, heads, with_attention=True)[3]
            planted[name] = max(planted[name], _head_rel_err(got[3], wrong, heads))
        x = want[0]
    return attn_err, hidden_err, planted


def _check_layerwise(what, attn_err, hidden_err, planted):
    print(f"K2 per layer ({what}), attention heads: max rel err {attn_err:.4g} (bound "
          f"{K2_HEAD_REL_BOUND}); hidden rows {hidden_err:.4g}; planted faults "
          + ", ".join(f"{k} {v:.4g}" for k, v in planted.items()))
    if attn_err > K2_HEAD_REL_BOUND:
        raise AssertionError(f"K2 attention disagrees with its plain version ({what}): "
                             f"{attn_err}")
    if hidden_err > K2_ROW_REL_BOUND:
        raise AssertionError(f"K2 layer output disagrees with its plain version ({what}): "
                             f"{hidden_err}")
    if min(planted.values()) <= K2_HEAD_REL_BOUND:
        raise AssertionError(f"the attention check cannot see a planted cache fault ({what}): "
                             f"{planted}")


def _whole_step(stacked, cache, x, pos, heads, what):
    """The whole 30-layer step against the plain version per row; both timed."""
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step, fused_decode_step_plain

    got = fused_decode_step(stacked, x, cache, pos, heads)
    want = fused_decode_step_plain(stacked, x, cache, pos, heads)
    errs = [_row_rel_err(a, w) for a, w in zip(got, want)]
    abs_err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    print(f"K2 30 layers ({what}): max per-row rel err hidden/k/v = "
          + "/".join(f"{e:.4g}" for e in errs) + f" (bound {K2_REL_BOUND})")
    if max(errs) > K2_REL_BOUND:
        raise AssertionError(f"K2 disagrees with its plain version ({what}): {errs}")
    run = lambda: fused_decode_step(stacked, x, cache, pos, heads)
    ms, device_ms = _time_ms(run, 20), _step_device_ms(run)
    plain_ms = _time_ms(lambda: fused_decode_step_plain(stacked, x, cache, pos, heads), 5)
    b, t = cache["k"].shape[1], cache["k"].shape[2]
    bound_ms, bound_by = _k2_bound(stacked, x, cache, pos, cache["k"].shape[0], x.shape[1])
    print(f"K2 ({what}) B={b} pos={pos} T={t}: kernel {ms:.3f} ms (device {device_ms:.3f}), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"row_rel_err": errs, "max_abs_err": abs_err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def _sampler_step(tts, stacked, emb, cache, pos, what):
    """The sampler's K2 step against its layer-stack step (each writes the
    step's rows into the cache)."""
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, _gpt_step

    ar = tts.autoregressive
    fused = _gpt_step(ar, SamplerSettings(fused_step=True), stacked, emb, cache, pos)
    plain = _gpt_step(ar, SamplerSettings(fused_step=False), None, emb, cache, pos)
    err = _row_rel_err(fused, plain)
    print(f"UnifiedVoice decode step ({what}), K2 vs layer stack: max per-row rel err "
          f"{err:.4g} (bound {MODEL_REL_BOUND})")
    if err > MODEL_REL_BOUND:
        raise AssertionError(f"K2 decode step disagrees with the layer stack ({what})")
    return err


def check_decode_main_path(tts, clips, record: dict) -> dict:
    """K2 over a bf16 cache at the fast request's shapes. Layer by layer,
    every head's attention output is held to K2_HEAD_REL_BOUND; the same
    comparison against the plain version reading the cache one row short or
    long (pos -/+ 1) or one prefix row wrong must exceed it. Then the whole
    30-layer step, per row, and the fused against the unfused sampler step."""
    import torch

    heads, layers = tts.autoregressive.config.heads, tts.autoregressive.config.layers
    stacked = tts._ar_stacked
    with torch.inference_mode():
        cache, emb, pos, p_len = _prefilled_main_path(tts, clips, torch.bfloat16)
        r = p_len + (pos - p_len) // 2           # the prefix row read wrongly

        def ahead(ca, got):      # one row long, that row holding the step's own k/v
            c = {n: t_.clone() for n, t_ in ca.items()}
            c["k"][0, :, pos], c["v"][0, :, pos] = got[1][0], got[2][0]
            return c, pos + 1

        def wrong_row(ca, got):  # row r read as r + 1
            c = {n: t_.clone() for n, t_ in ca.items()}
            for t_ in c.values():
                t_[0, :, r] = t_[0, :, r + 1]
            return c, pos

        faults = {"pos-1": lambda ca, got: (ca, pos - 1), "pos+1": ahead, "row": wrong_row}
        attn_err, hidden_err, planted = _layerwise(stacked, cache, emb[:, 0].to(torch.bfloat16),
                                                   pos, heads, layers, faults)
        _check_layerwise("bf16 cache", attn_err, hidden_err, planted)
        whole = _whole_step(stacked, cache, emb[:, 0].to(torch.bfloat16), pos, heads,
                            "bf16 cache")
        sampler_err = _sampler_step(tts, stacked, emb, cache, pos, "bf16 cache")
    record["k2_main_path"] = {
        "B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
        "attn_head_rel_err": attn_err, "layer_hidden_rel_err": hidden_err,
        "planted": planted, "step": whole, "sampler_row_rel_err": sampler_err}
    return {k: whole[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")} | \
        {"timed_at": "B=96 pos=566"}


def check_decode_main_path_int8(tts, clips, record: dict) -> dict:
    """K2 over an int8 cache at the fast request's shapes, the cache filled
    by a real prefill through the layer stack. Layer by layer (bf16
    weights), every head held to K2_HEAD_REL_BOUND; the plain version
    reading every k scale one position off (ks[t + 1] for ks[t]), or one
    prefix k row as its neighbour, must exceed it. Then the whole step of
    both int8-cache variants, per row, and the sampler's K2 step against
    its layer stack. Returns {variant: timing}."""
    import torch

    from tortoise_tpu_torch.ops.decode_step import quantize_stack

    heads, layers = tts.autoregressive.config.heads, tts.autoregressive.config.layers
    stacked = tts._ar_stacked
    out = {}
    with torch.inference_mode():
        cache, emb, pos, p_len = _prefilled_main_path(tts, clips, torch.int8)
        r = p_len + (pos - p_len) // 2
        x = emb[:, 0].to(torch.bfloat16)

        def scale_shift(ca, got):
            c = dict(ca)
            c["k_scale"] = torch.cat([ca["k_scale"][..., 1:], ca["k_scale"][..., -1:]], -1)
            return c, pos

        def k_row(ca, got):
            c = dict(ca)
            c["k"] = ca["k"].clone()
            c["k"][0, :, r] = ca["k"][0, :, r + 1]
            return c, pos

        attn_err, hidden_err, planted = _layerwise(
            stacked, cache, x, pos, heads, layers, {"k_scale[t+1]": scale_shift, "k row": k_row})
        _check_layerwise("int8 cache", attn_err, hidden_err, planted)
        steps = {}
        for var, st in (("int8_cache", stacked), ("int8_weights_int8_cache",
                                                  quantize_stack(stacked))):
            steps[var] = _whole_step(st, cache, x, pos, heads, var)
            out[var] = {k: steps[var][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                   "bound_by")} | {"timed_at": "B=96 pos=566"}
        sampler_err = _sampler_step(tts, stacked, emb, cache, pos, "int8 cache")
    record["k2_main_path_int8_cache"] = {
        "B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
        "attn_head_rel_err": attn_err, "layer_hidden_rel_err": hidden_err,
        "planted": planted, "steps": steps, "sampler_row_rel_err": sampler_err}
    return out


def check_k1_main_path(tts, clips, record: dict) -> None:
    """K1 over an f32 cache at the fast request's shapes (96 candidates, the
    last decode step), the cache filled by a real prefill through the layer
    stack. One decode step through the stack must launch K1 once per layer;
    then, layer by layer on that step's q/k/v, every head held to
    K1_BF16_BOUND (the bf16 model's q) against the plain version, whose row
    write must equal K1's; the plain version reading the cache one row
    short or long (pos -/+ 1) or one prefix row as its neighbour must move
    past the bound."""
    import torch

    from tortoise_tpu_torch.ops.attn import decode_attention_merged, decode_attention_merged_plain

    gpt = tts.autoregressive.gpt
    heads, layers = gpt.config.n_head, gpt.config.n_layer
    with torch.inference_mode():
        cache, emb, pos, p_len = _prefilled_main_path(tts, clips, torch.float32)
        r = p_len + (pos - p_len) // 2
        step = []
        attend = gpt._attend

        def spy(q, k, v, cache_, layer, index):
            step.append((q[:, 0], k[:, 0], v[:, 0]))
            return attend(q, k, v, cache_, layer, index)

        gpt._attend = spy
        before = decode_attention_merged.launches
        try:
            gpt(emb, cache=cache, cache_index=pos)
        finally:
            del gpt._attend
        step_launches = decode_attention_merged.launches - before
        if step_launches != layers:
            raise AssertionError(f"a decode step through the layer stack launched K1 "
                                 f"{step_launches} times, not {layers}")
        attn_err, planted, writes_equal = 0.0, {"pos-1": 0.0, "pos+1": 0.0, "row": 0.0}, True
        for l, (q, kn, vn) in enumerate(step):
            ca = {n: t_[l:l + 1] for n, t_ in cache.items()}
            copy = lambda: {n: t_.clone() for n, t_ in ca.items()}
            got = decode_attention_merged(q, kn, vn, ca["k"], ca["v"], 0, pos, heads=heads)
            plain = copy()
            want = decode_attention_merged_plain(q, kn, vn, plain["k"], plain["v"], 0, pos,
                                                 heads=heads)
            writes_equal &= torch.equal(plain["k"], ca["k"]) and torch.equal(plain["v"], ca["v"])
            attn_err = max(attn_err, _head_rel_err(got, want, heads))
            for name, p_ in (("pos-1", pos - 1), ("pos+1", pos + 1)):
                bad = copy()
                wrong = decode_attention_merged_plain(q, kn, vn, bad["k"], bad["v"], 0, p_,
                                                      heads=heads)
                planted[name] = max(planted[name], _head_rel_err(got, wrong, heads))
            bad = copy()
            for t_ in bad.values():
                t_[0, :, r] = t_[0, :, r + 1]
            wrong = decode_attention_merged_plain(q, kn, vn, bad["k"], bad["v"], 0, pos,
                                                  heads=heads)
            planted["row"] = max(planted["row"], _head_rel_err(got, wrong, heads))
    print(f"K1 per layer (f32 cache, B={cache['k'].shape[1]}, pos={pos}): attention heads max "
          f"rel err {attn_err:.4g} (bound {K1_BF16_BOUND}); row writes equal: {writes_equal}; "
          f"planted faults " + ", ".join(f"{k} {v:.4g}" for k, v in planted.items()))
    record["k1_main_path"] = {"B": cache["k"].shape[1], "pos": pos, "T": cache["k"].shape[2],
                              "step_launches": step_launches, "attn_head_rel_err": attn_err,
                              "row_writes_equal": writes_equal, "planted": planted}
    if attn_err > K1_BF16_BOUND or not writes_equal:
        raise AssertionError(f"K1 disagrees with its plain version on the main path: "
                             f"{record['k1_main_path']}")
    if min(planted.values()) <= K1_BF16_BOUND:
        raise AssertionError(f"the K1 check cannot see a planted cache fault: {planted}")
    del cache


def check_univnet(tts, record: dict) -> None:
    """One UnivNet forward at F=2186 frames (a 500-token clip) with K4 and
    with the einsum LVC in the same blocks, both timed. The seeded random
    weights make the gated stack chaotic (the last bits of one LVC flip
    samples of the wav), so the two paths are held to each other on a copy
    whose weights are scaled by 0.15, which makes it contractive (as
    tests/test_torch_modules.py does): within UNIVNET_ABS_BOUND."""
    import copy

    import torch

    voc = tts.vocoder
    blocks = [getattr(voc, f"lvc_{i}") for i in range(len(voc.config.strides))]
    g = torch.Generator(device="cuda").manual_seed(6)
    frames = LVC_FRAMES - 10
    mel = torch.randn((1, frames, voc.config.n_mel_channels), generator=g, device="cuda")
    z = torch.randn((1, LVC_FRAMES, voc.config.noise_dim), generator=g, device="cuda")
    with torch.inference_mode():
        kernel_ms = _time_ms(lambda: voc.inference(mel, z), 5)
        with_kernel = voc.inference(mel, z)
        for blk in blocks:
            blk.use_kernel = False
        try:
            einsum_ms = _time_ms(lambda: voc.inference(mel, z), 5)
            with_einsum = voc.inference(mel, z)
        finally:
            for blk in blocks:
                blk.use_kernel = True
    diff = (with_kernel - with_einsum).abs().max().item()
    calm = copy.deepcopy(voc)
    with torch.inference_mode():
        for prm in calm.parameters():
            prm.mul_(0.15)
        calm_kernel = calm.inference(mel, z)
        for blk in (getattr(calm, f"lvc_{i}") for i in range(len(calm.config.strides))):
            blk.use_kernel = False
        calm_diff = (calm_kernel - calm.inference(mel, z)).abs().max().item()
    del calm
    record["univnet_forward"] = {"frames": frames, "k4_ms": kernel_ms, "einsum_ms": einsum_ms,
                                 "max_abs_diff_random_weights": diff,
                                 "max_abs_diff_contractive": calm_diff,
                                 "bound": UNIVNET_ABS_BOUND}
    print(f"UnivNet forward, {frames} mel frames: with K4 {kernel_ms:.3f} ms, with the einsum "
          f"LVC {einsum_ms:.3f} ms; max|diff| of the wavs {diff:.4g} (random weights), "
          f"{calm_diff:.4g} (contractive weights, bound {UNIVNET_ABS_BOUND})")
    if calm_diff > UNIVNET_ABS_BOUND:
        raise AssertionError(f"UnivNet with K4 disagrees with the einsum LVC: {calm_diff}")


def check_diffusion(tts, record: dict) -> None:
    """The diffusion forward with K3 against the einsum attention, full width."""
    import torch

    dm = tts.diffusion
    g = torch.Generator(device="cuda").manual_seed(3)
    with torch.inference_mode():
        t, n = 320, 300
        x = torch.randn((2, t, 100), generator=g, device="cuda")
        pre = torch.randn((2, t, dm.config.model_channels), generator=g, device="cuda") \
            .to(tts.dtype)
        steps = torch.tensor([10, 900], device="cuda")
        valid = torch.tensor([n, n], device="cuda")
        biases = dm.rel_bias_vectors(t)
        out_flash = dm(x, steps, pre, valid_len=valid, rel_biases=biases, flash=True)
        out_plain = dm(x, steps, pre, valid_len=valid, rel_biases=biases, flash=False)
        err = (out_flash[:, :n] - out_plain[:, :n]).abs().max().item()
        bound = MODEL_REL_BOUND * out_plain[:, :n].abs().max().item()
        print(f"DiffusionTts forward, K3 vs einsum attention: max|err| {err:.4g} "
              f"(bound {bound:.4g})")
        if err > bound:
            raise AssertionError("K3 diffusion forward disagrees with the einsum path")
    record["diffusion_check"] = [err, bound]


class Launches:
    """Every kernel wrapper's launch counter: ``reset`` sets all to 0 before
    a path runs, ``read`` returns them after it, ``total`` sums the runs.
    It also counts K4's plain version called on CUDA tensors ("lvc plain on
    cuda"), which no path may do."""

    def __init__(self):
        from tortoise_tpu_torch.ops import lvc
        from tortoise_tpu_torch.ops.attn import decode_attention_merged, flash_rel_attention
        from tortoise_tpu_torch.ops.decode_step import fused_decode_step
        from tortoise_tpu_torch.ops.group_norm import group_norm_act
        from tortoise_tpu_torch.ops.ssm_step import ssm_decode_step
        from tortoise_tpu_torch.tools.bench_attn_body import attn_body
        from tortoise_tpu_torch.tools.decode_attn_kv128 import decode_attention_kv128
        from tortoise_tpu_torch.tools.probe_ops import contraction, probe

        # wrappers that count each variant apart: {wrapper: row name of a variant}
        self.by_variant = {fused_decode_step: _k2_row_name, attn_body: _k6_row_name}
        self.single = {K1_NAME: decode_attention_merged, K3_NAME: flash_rel_attention,
                       K4_NAME: lvc.location_variable_convolution_lvc,
                       K5_NAME: decode_attention_kv128, K7_NAME: probe, K8_NAME: contraction,
                       SSM_NAME: ssm_decode_step, GN_NAME: group_norm_act}
        self.total = {name(v): 0 for fn, name in self.by_variant.items()
                      for v in fn.launches_by_variant}
        self.total.update(dict.fromkeys(self.single, 0))
        self.by_path: dict[str, dict] = {}
        self.lvc_plain_on_cuda = 0
        plain = lvc.location_variable_convolution_lvc_plain

        def counted(x, *args, **kwargs):
            self.lvc_plain_on_cuda += int(x.is_cuda)
            return plain(x, *args, **kwargs)

        lvc.location_variable_convolution_lvc_plain = counted

    def reset(self):
        for fn in self.by_variant:
            fn.launches = 0
            fn.launches_by_variant.update(dict.fromkeys(fn.launches_by_variant, 0))
        for fn in self.single.values():
            fn.launches = 0
        self.lvc_plain_on_cuda = 0

    def read(self) -> dict:
        counts = {name(v): n for fn, name in self.by_variant.items()
                  for v, n in fn.launches_by_variant.items()}
        counts.update({name: fn.launches for name, fn in self.single.items()})
        if self.lvc_plain_on_cuda:
            raise AssertionError(f"K4's plain version ran on CUDA tensors "
                                 f"{self.lvc_plain_on_cuda} times on a main path")
        return counts

    def add(self, counts: dict, path: str):
        """Adds a path's counts to the totals and to ``by_path[path]``."""
        mine = self.by_path.setdefault(path, dict.fromkeys(self.total, 0))
        for k, n in counts.items():
            self.total[k] += n
            mine[k] += n


def check_tool_kernels(record: dict) -> list[dict]:
    """K5-K8 against their plain versions at the tools' reference shapes,
    each timed beside its plain version and its library yardstick: K5 at
    BH=256, T=256, n_valid=200; K6 (both variants) at B=128, T=768,
    pos=300, ck=64; K7's seven probes; K8's four orientations. K7's and
    K8's rows sum their calls' times and bound; the per-probe numbers go to
    the record."""
    import torch

    from tortoise_tpu_torch.tools import bench_attn_body, decode_attn_kv128, probe_ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    kv = torch.randn((256, 256, 128), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((256, 64), generator=g, device=dev).to(torch.bfloat16)
    k5 = decode_attn_kv128.check(kv, q, 200)
    record["k5"] = k5
    print(f"K5 BH=256 T=256 n=200: max|err| {k5['max_abs_err']:.4g} = {k5['rel_err']:.3g} x "
          f"max|plain| (bound {k5['bound']}); kernel {k5['ms']:.4f} ms (device "
          f"{k5['device_ms']:.4f}), plain {k5['plain_ms']:.4f} ms, SDPA {k5['library_ms']:.4f} ms "
          f"(device {k5['library_device_ms']:.4f}), bound {k5['bound_ms']:.4f} ms "
          f"({k5['bound_by']})")
    if k5["rel_err"] > k5["bound"]:
        raise AssertionError(f"K5 disagrees with its plain version: {k5}")
    rows.append({"name": K5_NAME, "source": "tortoise_tpu_torch/csrc/decode_attn_kv128.cu",
                 "replaces": "tools/pallas_decode_attn.py:64",
                 "timed_at": "BH=256 T=256 n_valid=200", **k5})
    del kv

    b, t, c, pos, ck = 128, 768, 1024, 300, 64
    q, k, v = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
               for s in ((b, c), (b, t, c), (b, t, c)))
    record["k6"] = {}
    for variant in bench_attn_body.VARIANTS:
        r = record["k6"][variant] = bench_attn_body.check(q, k, v, pos, ck, variant, 20)
        print(f"K6[{variant}] B={b} T={t} pos={pos} ck={ck}: max head rel err "
              f"{r['head_rel_err']:.4g} (bound {r['bound']}), max|err| vs f32 reference "
              f"{r['ref_max_abs_err']:.4g}; kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
              f"(device {r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        if r["head_rel_err"] > r["bound"]:
            raise AssertionError(f"K6[{variant}] disagrees with its plain version: {r}")
        rows.append({"name": _k6_row_name(variant), "source": "tortoise_tpu_torch/csrc/attn_body.cu",
                     "replaces": "tools/bench_attn_body_pallas.py:124",
                     "timed_at": f"B={b} T={t} pos={pos} ck={ck}", **r})
    del q, k, v

    for name, calls, dtype, replaces, timed_at in (
            (K7_NAME, probe_ops.run_probes(dev), "f32", "tools/probe_mosaic_ops.py:18",
             "the seven probes' calls, B=64 ck=32 H=16 T=768 C=1024"),
            (K8_NAME, probe_ops.timed_probes(dev), "bf16", "tools/probe_mosaic_ops.py:87",
             "the four orientations' calls, B=64 ck=128 C=1024 H=16")):
        record[name] = calls
        if not all(r["ok"] for r in calls):
            raise AssertionError(f"{name}: a probe disagrees with its plain version: {calls}")
        bound_ms, bound_by = _bound(sum(r["nbytes"] for r in calls),
                                    sum(r["flops"] for r in calls), dtype)
        row = {"name": name, "source": "tortoise_tpu_torch/csrc/probe_ops.cu",
               "replaces": replaces, "timed_at": timed_at,
               "max_abs_err": max(r["max_abs_err"] for r in calls),
               "bound_ms": bound_ms, "bound_by": bound_by}
        # K7 times no bf16 yardstick
        sums = ("ms", "plain_ms", "library_ms", "library_bf16_ms", "device_ms",
                "library_device_ms")
        row.update({k_: sum(r[k_] for r in calls) for k_ in sums if k_ in calls[0]})
        rows.append(row)
    for row in rows:
        row["route"] = "cuda"
    return rows


def run_tools(record: dict, launches: Launches) -> None:
    """Phase 11, the tools path: each tool's main() in this process, as a
    user runs it on the card, counted apart, each checked: its kernels
    against their plain versions (probe_ops returns ok=False on a
    mismatch; bench_lvc's K4), K2 against the layer stack
    (bench_fused_decode_step's first step, check_fused_exactness's
    decisive agreement 1.0 over both caches), K2
    in bench_fused_ab's "on" requests only, finite audio, every section of
    profile_ar_step timed; then one K1 call under the profiler
    (``check_k1_one_kernel``), phase 17's request (``run_granite``: after
    every timing of this process, before the first process after which a
    profiler window of this one records no device event), phase 18's step
    profile, the trace phase and profile_diffusion_step in processes of
    their own."""
    import importlib
    import math

    from tortoise_tpu_torch.utils.audio import load_voice

    record["tools"] = {}
    launches.reset()
    for name, argv in TOOL_RUNS:
        tool = importlib.import_module(f"tortoise_tpu_torch.tools.{name}")
        t0 = time.perf_counter()
        print(f"--- python3 -m tortoise_tpu_torch.tools.{name} {' '.join(argv)}")
        res = tool.main(argv)
        res["wall_s"] = time.perf_counter() - t0
        record["tools"][name if name not in record["tools"] else f"{name} {' '.join(argv)}"] = res
        print(f"{name}: {res['wall_s']:.1f} s")
        if name == "probe_ops" and not res["ok"]:
            raise AssertionError("probe_ops: a probe failed")
        if name == "bench_lvc":
            # it holds every form to K4's plain version, run on the card
            launches.lvc_plain_on_cuda = 0
            for hop, row in res["hops"].items():
                if row["forms"]["k4"]["rel_err"] > K4_REL_BOUND or not all(
                        math.isfinite(r["device_ms"]) for r in row["forms"].values()):
                    raise AssertionError(f"bench_lvc hop={hop}: {row}")
        # K2 against the layer stack after one step from the same input and
        # cache (later steps part further, whatever the kernel: the tool's
        # docstring); every time finite
        if name == "bench_fused_decode_step" and (
                res["rel_err_by_step"][0] > K2_REL_BOUND
                or not all(math.isfinite(r["device_ms"]) for r in res["paths"].values())):
            raise AssertionError(f"bench_fused_decode_step: K2 against the layer stack: {res}")
        if name == "check_fused_exactness" and not all(
                r["decisive_agreement"] == 1.0 and r["decisive_steps"] > 0
                and r["stack_replay_self_consistency"] == 1.0 for r in res["rows"].values()):
            raise AssertionError(f"check_fused_exactness: {res['rows']}")
        if name == "bench_fused_ab":
            rows = {f"{row} {key}": r for row, v in res.items() if isinstance(v, dict)
                    for key, r in v.items()}
            if not all(r["finite"] and (r["k2_launches"] > 0) == key.endswith("fused_on")
                       for key, r in rows.items()):
                raise AssertionError(f"bench_fused_ab: K2 must launch in the 'on' runs only, "
                                     f"every wav finite: {rows}")
        if name == "measure_first_audio" and not (
                res["finite"] and 0 < res["first_audio_s_median"] < res["stream_audio_s"]):
            raise AssertionError(f"measure_first_audio: {res}")
        if name == "profile_ar_step":
            secs = res["sections"]
            timed = [secs["a"], secs["b"], secs["c"], *secs["b2"].values(),
                     *(r for row in secs["d"].values() for r in row.values())]
            if not all(math.isfinite(r["device_ms"]) and r["device_ms"] > 0 for r in timed):
                raise AssertionError(f"profile_ar_step: a section was not timed: {secs}")
    counts = launches.read()
    launches.add(counts, "run_tools")
    record["tools_launches"] = counts
    print("tools path launches", json.dumps(counts))
    check_k1_one_kernel(record)
    run_granite(load_voice("train_dotrice")[0], record, launches)
    run_group_norm_split(record)
    run_trace_phase(record, launches)
    _profile_diffusion_step(record)


def trace_worker() -> int:
    """The trace phase in a process of its own (``chip_smoke.py
    --trace-worker``): one K2 bf16 decode step at B=1, one K1 call at B=16
    and one K3 call at B=2, T=2229 (full width, seeded random inputs, each
    called once untraced first), then the same three calls inside one
    ``utils.profiling.trace(build/trace)`` block. The file must parse, its
    kernel events must hold TRACE_FAMILIES and its host side the launches.
    Prints one JSON line: the file, its MB, events, kernel families and
    launch calls, the launch counts and the seconds."""
    import glob
    import shutil
    from collections import Counter

    import torch

    from tortoise_tpu_torch.ops.attn import decode_attention_merged, flash_rel_attention
    from tortoise_tpu_torch.ops.decode_step import fused_decode_step
    from tortoise_tpu_torch.utils.profiling import _k2_stack, family, trace

    t0 = time.perf_counter()
    L, C, H, T, pos = 30, 1024, 16, 768, 500
    g = torch.Generator(device="cuda").manual_seed(17)
    bf16 = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    stacked, x = _k2_stack(L, C, g), bf16(1, C)
    k2_cache = {n: bf16(L, 1, T, C) for n in "kv"}
    k1_cache = {n: bf16(L, 16, T, C) for n in "kv"}
    q, kn, vn = _k1_inputs(g, 16, C, torch.bfloat16)
    t3 = 2229
    q3, k3, v3 = (bf16(2, H, t3, 64) for _ in range(3))
    bias = bf16(H, 2 * t3 - 1).float()
    valid = torch.tensor([t3 - 5, (3 * t3) // 4], dtype=torch.int32, device="cuda")
    calls = (lambda: fused_decode_step(stacked, x, k2_cache, pos, H),
             lambda: decode_attention_merged(q, kn, vn, k1_cache["k"], k1_cache["v"], 7, pos,
                                             heads=H),
             lambda: flash_rel_attention(q3, k3, v3, bias, valid))
    for call in calls:
        call()
    torch.cuda.synchronize()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    launches = Launches()
    launches.reset()
    t1 = time.perf_counter()
    with trace(TRACE_DIR) as log_dir:
        for call in calls:
            call()
    traced_s = time.perf_counter() - t1
    counts = launches.read()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace wrote {files} into {log_dir}, not one .pt.trace.json")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if isinstance(e, dict)]
    kernels = Counter(family(e["name"]) for e in events if e.get("cat") == "kernel")
    launch_calls = Counter(e["name"] for e in events
                           if e.get("name", "").startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    res = {"file": os.path.relpath(files[0], ROOT), "mb": os.path.getsize(files[0]) / 1e6,
           "events": len(events), "kernel_events_by_family": kernels,
           "launch_calls": launch_calls, "launches": counts, "traced_s": traced_s,
           "worker_s": time.perf_counter() - t0}
    print(f"trace {res['file']}: {res['mb']:.3f} MB, {res['events']} events; kernels by "
          f"family {json.dumps(kernels)}; launch calls {json.dumps(launch_calls)}")
    missing = [fam for fam in TRACE_FAMILIES if not kernels.get(fam)]
    once = {k: counts[k] for k in (_k2_row_name("bf16"), K1_NAME, K3_NAME)}
    if missing or not launch_calls or set(once.values()) != {1}:
        raise AssertionError(f"the trace misses {missing} or the host's launches, or a kernel "
                             f"did not launch once in it: {res}")
    print(json.dumps(res))
    return 0


def run_trace_phase(record: dict, launches: Launches) -> None:
    """The trace phase: trace_worker in a process of its own, after this
    process's last timing and profiler pass and before
    profile_diffusion_step's process. Fails if the worker does. Its launches
    stay in record["trace"] and out of the totals: it runs no main path."""
    import subprocess

    print("--- trace phase: python3 chip_smoke.py --trace-worker")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-worker"],
                         cwd=ROOT, capture_output=True, text=True, timeout=TRACE_TIMEOUT)
    wall = time.perf_counter() - t0
    print(run.stdout[-3000:])
    if run.returncode:
        raise AssertionError(f"the trace worker exited {run.returncode}: {run.stderr[-3000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    res["wall_s"] = wall
    record["trace"] = res
    print(f"trace phase: {wall:.1f} s")


# profile_diffusion_step's main in a process of its own, its result on the last line
DIFFUSION_PROFILE = """import json, sys
from tortoise_tpu_torch.tools import profile_diffusion_step as tool
print(json.dumps(tool.main(sys.argv[1:])))
"""


def _profile_diffusion_step(record: dict) -> None:
    """profile_diffusion_step in a process of its own, after this process's
    last timing: every row timed, its busy share positive."""
    import math
    import subprocess

    argv = DIFFUSION_PROFILE_ARGS
    print(f"--- python3 -m tortoise_tpu_torch.tools.profile_diffusion_step {' '.join(argv)}")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", DIFFUSION_PROFILE, *argv], cwd=PACKAGE_ROOT,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(run.stdout[-4000:])
    if run.returncode:
        raise AssertionError(f"profile_diffusion_step exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    res["wall_s"] = wall
    record["tools"]["profile_diffusion_step"] = res
    print(f"profile_diffusion_step: {wall:.1f} s")
    # busy comes from a profiled pass, event from an earlier one: a
    # device-bound step may read a little over 1
    if len(res["rows"]) != 8 or not all(
            math.isfinite(r["event_ms"]) and 0 < r["busy_share"] <= 1.1
            for r in res["rows"].values()):
        raise AssertionError(f"profile_diffusion_step: {res['rows']}")


def _digest(x) -> str:
    """The first 16 hex digits of the SHA-256 of an array's (or a CPU or
    CUDA tensor's) bytes."""
    import numpy as np

    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def _wav_ok(wav, whole: bool = True) -> bool:
    """A (1, 1, S) float32 clip in [-1, 1]; ``whole`` (not redacted): S a
    multiple of UnivNet's 256 samples a frame."""
    import torch

    return (wav.dtype == torch.float32 and wav.ndim == 3 and wav.shape[:2] == (1, 1)
            and wav.shape[2] > 0 and (wav.shape[2] % 256 == 0 or not whole)
            and bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0)


def _quality_request(tts, clips, preset, text, seed, launches: Launches, whole: bool = True,
                     **kwargs) -> tuple[dict, object]:
    """One tts_with_preset request (``kwargs`` passed on): its record and
    its wav."""
    import torch

    before = launches.read()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = tts.tts_with_preset(text, preset=preset, voice_samples=clips,
                              use_deterministic_seed=seed, verbose=False, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = {k: n - before[k] for k, n in launches.read().items() if n > before[k]}
    if grew.get(K4_NAME) != LVC_CALLS_PER_FORWARD:
        raise AssertionError(f"{preset!r} request: one UnivNet forward launched K4 "
                             f"{grew.get(K4_NAME, 0)} times, not {LVC_CALLS_PER_FORWARD}")
    ok = _wav_ok(wav, whole)
    res = {"preset": preset, "text": text, "wall_s": wall, "audio_s": wav.shape[2] / 24000.0,
           "stages_s": tts.last_stage_timings, "launches": grew, "finite_wav": ok,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "batch": tts.autoregressive_batch_size,
           "codes_sha": _digest(tts.last_candidates), "wav_sha": _digest(wav)}
    print("request", json.dumps(res))
    if not ok:
        raise AssertionError(f"bad wav from {preset!r}: shape {tuple(wav.shape)}")
    return res, wav


def run_pipeline(tts, clips, record: dict, launches: Launches) -> None:
    """The three quality requests, bf16 cache and weights."""
    launches.reset()
    results = []
    for preset, text, seed in REQUESTS:
        res, _ = _quality_request(tts, clips, preset, text, seed, launches)
        if {"fused_decode_step", "flash_rel_attention"} - set(res["launches"]):
            raise AssertionError(f"{preset!r} request did not launch both kernels: "
                                 f"{res['launches']}")
        results.append(res)
    launches.add(launches.read(), "run_pipeline")
    record["requests"] = results


def _stream_against_own_latents(tts, clips, text, seed):
    """The stream's latents, reproduced with stream_speech from the same
    seed (same kernels, same draws), decoded in one full-length HiFi-GAN
    call: the wav the stream's chunks must equal."""
    import torch

    from tortoise_tpu_torch.models import ar_sampler

    with torch.inference_mode():
        _, text_t, cond = tts._prepare(text, clips, None, seed)
        settings = tts._settings(500, tts._fused(None), True)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for codes, latents in ar_sampler.stream_speech(
                tts.autoregressive, cond, text_t, gen, settings, seg_len=40, first_seg_len=16,
                stacked=tts._ar_stacked):
            pass
        n = tts._trim_codes(codes[0].cpu().numpy())
        return tts._decode(latents.float(), n, cond)[0, 0]


def run_fast_path(clips, record: dict, launches: Launches) -> dict:
    """TextToSpeechFast with bf16 and with int8_decode GPT weights: a
    warm-up tts, a timed tts, a tts_stream of the same text and seed, and
    (bf16) a tts_batch of three texts with a random voice. Each request must
    grow its K2 variant's counter."""
    import numpy as np
    import torch

    from tortoise_tpu_torch.api_fast import TextToSpeechFast

    text, seed = STREAM_REQUEST
    out = []
    for gw, var in (("bf16", "bf16"), ("int8_decode", "int8_weights")):
        name = _k2_row_name(var)
        t0 = time.perf_counter()
        tts = TextToSpeechFast(device="cuda", gpt_weights=gw)
        init_s = time.perf_counter() - t0
        res = {"gpt_weights": gw, "init_s": init_s}
        launches.reset()

        def grew_by(before):
            n = launches.read()[name] - before
            if n <= 0:
                raise AssertionError(f"fast path ({gw}): a request launched no {name}")
            return n

        before = launches.read()[name]
        tts.tts(text, voice_samples=clips, use_deterministic_seed=seed + 1, verbose=False)
        res["warmup_launches"] = grew_by(before)
        # a short stream as well: the window decode's first cuDNN calls
        # would otherwise land in the timed stream's first chunk
        before = launches.read()[name]
        list(tts.tts_stream(text, voice_samples=clips, use_deterministic_seed=seed + 1,
                            max_mel_tokens=24, verbose=False))
        res["warmup_stream_launches"] = grew_by(before)

        before = launches.read()[name]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = tts.tts(text, voice_samples=clips, use_deterministic_seed=seed, verbose=False)
        wall = time.perf_counter() - t0
        tts_codes = tts.last_codes
        if not _wav_ok(wav):
            raise AssertionError(f"fast path ({gw}): bad tts wav {tuple(wav.shape)}")
        res["tts"] = {"wall_s": wall, "audio_s": wav.shape[2] / 24000.0,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "codes": len(tts_codes), "launches": grew_by(before),
                      "codes_sha": _digest(tts_codes), "wav_sha": _digest(wav)}

        before = launches.read()[name]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        chunks, first_s = [], None
        t0 = time.perf_counter()
        for chunk in tts.tts_stream(text, voice_samples=clips, use_deterministic_seed=seed,
                                    verbose=False):
            if first_s is None:
                first_s = time.perf_counter() - t0
            chunks.append(chunk)
        total_s = time.perf_counter() - t0
        stream = torch.cat(chunks)
        same_codes = bool(np.array_equal(tts.last_codes, tts_codes))
        res["stream"] = {"first_chunk_s": first_s, "total_s": total_s, "chunks": len(chunks),
                         "audio_s": stream.shape[0] / 24000.0,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "codes_equal_tts": same_codes, "launches": grew_by(before),
                         "codes_sha": _digest(tts.last_codes), "wav_sha": _digest(stream)}
        if not same_codes or stream.shape[0] != wav.shape[2] or not torch.isfinite(stream).all():
            raise AssertionError(f"fast path ({gw}): the stream's codes or length differ from "
                                 f"tts's: {res['stream']}, tts {wav.shape[2]} samples")

        if gw == "bf16":
            before = launches.read()[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wavs = tts.tts_batch(BATCH_TEXTS, use_deterministic_seed=seed, verbose=False)
            wall_b = time.perf_counter() - t0
            if len(wavs) != len(BATCH_TEXTS) or not all(_wav_ok(w) for w in wavs):
                raise AssertionError("fast path: bad tts_batch wavs")
            res["tts_batch"] = {"wall_s": wall_b, "texts": len(wavs),
                                "audio_s": [w.shape[2] / 24000.0 for w in wavs],
                                "launches": grew_by(before),
                                "wav_sha": [_digest(w) for w in wavs]}
        counts = launches.read()
        launches.add(counts, "run_fast_path")
        res["path_launches"] = counts

        # outside the counted run: the stream's chunks against the full
        # decode of its own latents, and against tts's (teacher-forced) wav
        full = _stream_against_own_latents(tts, clips, text, seed)
        res["stream"]["max_abs_err_vs_own_full_decode"] = (stream - full).abs().max().item()
        diff = stream - wav[0, 0]
        res["stream"]["vs_tts_wav"] = {"max_abs_err": diff.abs().max().item(),
                                       "rel_l2": (diff.norm() / wav.norm()).item()}
        print("fast path", json.dumps(res))
        if res["stream"]["max_abs_err_vs_own_full_decode"] > STREAM_ABS_BOUND:
            raise AssertionError(f"fast path ({gw}): the stream's chunks are not slices of the "
                                 f"full decode: {res['stream']}")
        if res["stream"]["vs_tts_wav"]["rel_l2"] > STREAM_TTS_REL_L2_BOUND:
            raise AssertionError(f"fast path ({gw}): the stream's wav is far from tts's: "
                                 f"{res['stream']}")
        out.append(res)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    record["fast_path"] = out


def _prompt_rows(tts, text) -> int:
    """Rows of the decode prompt of ``text``: [cond | start, text, stop pad,
    bucket, stop | start_mel]."""
    ids = len(tts.tokenizer.encode(text)) + 1
    return 1 + -(-ids // tts.text_bucket) * tts.text_bucket + 2 + 1


def run_quality_int8(clips, record: dict, launches: Launches) -> None:
    """One ultra_fast request with the int8 KV cache per gpt_weights, and the
    bytes of the request's cache beside a bf16 cache of the same shape."""
    import torch

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache

    preset, text, seed = REQUESTS[0]
    out = []
    for gw, var in (("int8_decode", "int8_weights_int8_cache"), ("bf16", "int8_cache")):
        t0 = time.perf_counter()
        tts = TextToSpeech(device="cuda", enable_redaction=False, kv_cache_dtype="int8",
                           gpt_weights=gw)
        init_s = time.perf_counter() - t0
        launches.reset()
        res, _ = _quality_request(tts, clips, preset, text, seed, launches)
        counts = launches.read()
        launches.add(counts, "run_quality_int8")
        if counts[_k2_row_name(var)] <= 0 or counts["flash_rel_attention"] <= 0:
            raise AssertionError(f"int8-cache request ({gw}) did not launch {var} and K3: "
                                 f"{counts}")
        b = min(16, tts.autoregressive_batch_size)
        t_cache = -(-(_prompt_rows(tts, text) + 500) // 256) * 256
        sizes = {}
        for name, dt in (("int8", torch.int8), ("bf16", torch.bfloat16)):
            c = init_kv_cache(tts.ar_cfg.gpt_config, b, t_cache, dtype=dt, device="cuda")
            sizes[name] = sum(t_.numel() * t_.element_size() for t_ in c.values())
            del c
        res.update(gpt_weights=gw, kv_cache_dtype="int8", init_s=init_s,
                   kv_cache_bytes={"B": b, "T": t_cache, **sizes,
                                   "ratio": sizes["int8"] / sizes["bf16"]})
        print("int8-cache request", json.dumps({k: res[k] for k in (
            "gpt_weights", "wall_s", "stages_s", "peak_mem_bytes", "kv_cache_bytes")}))
        out.append(res)
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    record["quality_int8_cache"] = out


def run_quality_f32_cache(clips, record: dict, launches: Launches):
    """One ultra_fast request with the f32 KV cache and gpt_fused_step=False:
    every decode step runs the layer stack, K1 in each of its 30 layers;
    K2 never runs. Returns its candidates' codes (phase 14's reference)."""
    from tortoise_tpu_torch.api import TextToSpeech

    preset, text, seed = REQUESTS[0]
    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False, kv_cache_dtype="f32",
                       gpt_fused_step=False)
    init_s = time.perf_counter() - t0
    layers = tts.ar_cfg.layers
    launches.reset()
    res, _ = _quality_request(tts, clips, preset, text, seed, launches)
    counts = launches.read()
    launches.add(counts, "run_quality_f32_cache")
    k2 = sum(counts[_k2_row_name(v)] for v in K2_VARIANTS)
    if counts[K1_NAME] <= 0 or counts[K1_NAME] % layers or k2 or counts[K3_NAME] <= 0:
        raise AssertionError(f"f32-cache request: K1 must run in every layer of every step, K2 "
                             f"never, K3 in the diffusion: {counts}")
    res.update(kv_cache_dtype="f32", gpt_fused_step=False, init_s=init_s,
               k1_launches_per_step=layers, decode_steps=counts[K1_NAME] // layers)
    print("f32-cache request", json.dumps({k: res[k] for k in (
        "wall_s", "stages_s", "peak_mem_bytes", "launches", "decode_steps")}))
    record["quality_f32_cache"] = res
    codes = tts.last_candidates
    del tts
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    return codes


def run_cli(record: dict, launches: Launches) -> None:
    """The full-knob CLI in this process, as a user runs it on the card:
    build/cli.wav must be a 24 kHz float wav, finite, within [-1, 1]."""
    import numpy as np
    import torch
    from scipy.io.wavfile import read as wav_read

    from tortoise_tpu_torch.apps import main as cli

    out = os.path.join(ROOT, "build", "cli.wav")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.unlink(out)
    argv = ["--voice", "train_dotrice", "--preset", "ultra_fast", "--seed", "0", "-q", "-o", out,
            REQUESTS[0][1]]
    launches.reset()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = launches.read()
    launches.add(counts, "run_cli")
    sr, wav = wav_read(out)
    res = {"argv": argv, "rc": rc, "wall_s_with_init": wall, "sample_rate": sr,
           "samples": int(wav.shape[0]), "dtype": str(wav.dtype), "launches": counts,
           "max_abs": float(np.abs(wav).max()) if wav.size else None, "wav_sha": _digest(wav)}
    print("CLI", json.dumps(res))
    record["cli"] = res
    if rc != 0 or sr != 24000 or wav.dtype != np.float32 or wav.ndim != 1 or not wav.size \
            or not np.isfinite(wav).all() or np.abs(wav).max() > 1.0:
        raise AssertionError(f"the CLI wrote a bad wav: {res}")
    if min(counts[_k2_row_name("bf16")], counts[K3_NAME], counts[K4_NAME]) <= 0:
        raise AssertionError(f"the CLI's request did not launch K2, K3 and K4: {counts}")
    gc.collect()
    torch.cuda.empty_cache()


def _reference_wav2vec2(cfg, seed: int) -> dict:
    """A seeded wav2vec2 checkpoint in the HF Wav2Vec2ForCTC layout (the
    shipped aligner's) at ``cfg``'s widths: weights N(0, 1/fan_in), biases
    0, norm scales 1, the positional conv under weight norm (weight_g,
    weight_v over dim 2)."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(shape, generator=gen) * (shape[1] * (shape[2] if len(shape) > 2
                                                                  else 1)) ** -0.5

    def norm(sd, p, c):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = torch.ones(c), torch.zeros(c)

    c, ff, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    sd, in_ch = {}, 1
    for i, (o, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}"
        sd[f"{p}.conv.weight"], sd[f"{p}.conv.bias"] = w(o, in_ch, k), torch.zeros(o)
        norm(sd, f"{p}.layer_norm", o)
        in_ch = o
    norm(sd, "wav2vec2.feature_projection.layer_norm", in_ch)
    sd["wav2vec2.feature_projection.projection.weight"] = w(c, in_ch)
    sd["wav2vec2.feature_projection.projection.bias"] = torch.zeros(c)
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    v = w(c, c // cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings)
    sd[f"{pc}.weight_v"] = v
    sd[f"{pc}.weight_g"] = torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True)
    sd[f"{pc}.bias"] = torch.zeros(c)
    for i in range(cfg.num_layers):
        p = f"wav2vec2.encoder.layers.{i}"
        norm(sd, f"{p}.layer_norm", c)
        norm(sd, f"{p}.final_layer_norm", c)
        for m in ("q", "k", "v", "out"):
            sd[f"{p}.attention.{m}_proj.weight"] = w(c, c)
            sd[f"{p}.attention.{m}_proj.bias"] = torch.zeros(c)
        sd[f"{p}.feed_forward.intermediate_dense.weight"] = w(ff, c)
        sd[f"{p}.feed_forward.intermediate_dense.bias"] = torch.zeros(ff)
        sd[f"{p}.feed_forward.output_dense.weight"] = w(c, ff)
        sd[f"{p}.feed_forward.output_dense.bias"] = torch.zeros(c)
    norm(sd, "wav2vec2.encoder.layer_norm", c)
    sd["lm_head.weight"], sd["lm_head.bias"] = w(vocab, c), torch.zeros(vocab)
    return sd


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _check_wav2vec2(wav24k, models_dir: str, record: dict):
    """Phase 12b: the full-width wav2vec2, loaded through the port's
    converter from a seeded checkpoint in the HF layout (the first of
    W2V_SEEDS that hears at least W2V_MIN_HEARD symbols in the clip). Returns
    (model, logits_fn, what it hears)."""
    import numpy as np
    import torch

    from tortoise_tpu_torch import weights as weights_lib
    from tortoise_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
    from tortoise_tpu_torch.utils.audio import resample
    from tortoise_tpu_torch.utils.wav2vec_alignment import (TacotronCTCTokenizer,
                                                            wav2vec2_logits_fn)

    cfg = Wav2Vec2Config()
    audio16 = resample(wav24k, 24000, 16000)
    n = audio16.shape[0]
    os.makedirs(models_dir, exist_ok=True)
    path = os.path.join(models_dir, weights_lib.REFERENCE_CHECKPOINTS["wav2vec2"])
    tried = []
    for seed in W2V_SEEDS:
        torch.save(_reference_wav2vec2(cfg, seed), path)
        with torch.device("cuda"):
            model = Wav2Vec2ForCTC(cfg)
        if weights_lib.load_weights("wav2vec2", model, models_dir, False, 0) != "reference":
            raise AssertionError("wav2vec2: the checkpoint did not load")
        fn = wav2vec2_logits_fn(model.eval(), "cuda")
        logits = fn(audio16)
        heard = TacotronCTCTokenizer().decode(logits.argmax(-1).tolist()).strip()
        tried.append(len(heard))
        if len(heard) >= W2V_MIN_HEARD:
            break
    else:
        raise AssertionError(f"wav2vec2: no seed of {W2V_SEEDS} hears {W2V_MIN_HEARD} symbols "
                             f"({tried})")
    if logits.shape != (cfg.frame_count(n), cfg.vocab_size) or not np.isfinite(logits).all():
        raise AssertionError(f"wav2vec2: logits {logits.shape} for {n} samples, "
                             f"{cfg.frame_count(n)} frames expected, or not finite")

    with torch.inference_mode():
        x = torch.as_tensor(audio16, device="cuda")[None]
        x = (x - x.mean()) / torch.sqrt(x.var() + 1e-7)
        exact, n_frames = model(x)
        nb = -(-n // 16000) * 16000 + 16000      # at least one second of zeros
        padded, n_pad = model(torch.nn.functional.pad(x, (0, nb - n)), n_samples=n)
        pad_err = _rel_err(padded[:, :n_pad], exact)
        if n_pad != n_frames or padded.shape[1] <= n_frames or pad_err > W2V_REL_BOUND:
            raise AssertionError(f"wav2vec2: the padded run ({n_pad} of {padded.shape[1]} "
                                 f"frames) differs from the exact one: {pad_err:.3g}")
        ms = _time_ms(lambda: model(x), 5)
        dev_ms = _device_ms(lambda: model(x), 5)
        del exact, padded

    clip2 = audio16[:32000]
    cpu = Wav2Vec2ForCTC(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = wav2vec2_logits_fn(cpu.eval(), "cpu")(clip2)
    got = fn(clip2)
    cpu_err = _rel_err(torch.from_numpy(got), torch.from_numpy(want))
    del cpu
    res = {"seed": seed, "heard_per_seed": tried, "samples_16k": n, "frames": int(n_frames),
           "pad_rel_err": pad_err, "cpu_rel_err_2s": cpu_err, "bound": W2V_REL_BOUND,
           "forward_ms": ms, "forward_device_ms": dev_ms}
    print("wav2vec2", json.dumps(res))
    if cpu_err > W2V_REL_BOUND:
        raise AssertionError(f"wav2vec2: the card's logits differ from the CPU's: {cpu_err:.3g}")
    record["wav2vec2"] = res
    return model, fn, heard


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host wall of ``fn()`` in ms, after one untimed call."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[reps // 2]


def _redaction_parts_ms(wav24k, bare_text: str, fn) -> dict:
    """The parts of ``redact`` on one clip, each timed alone on this host:
    the resampler to 16 kHz (the native library's and scipy's polyphase, the
    fallback of ``utils.audio.resample``), the logits (wav2vec2's forward
    with its copies in and out) and the DP."""
    import numpy as np
    from scipy.signal import resample_poly

    from tortoise_tpu_torch import native
    from tortoise_tpu_torch.utils.wav2vec_alignment import TacotronCTCTokenizer, max_alignment

    audio16 = resample_poly(wav24k, 2, 3).astype(np.float32)
    heard = TacotronCTCTokenizer().decode(fn(audio16).argmax(-1).tolist())
    out = {"native_built": native.available(),
           "resample_scipy_ms": _wall_ms(lambda: resample_poly(wav24k, 2, 3)),
           "logits_ms": _wall_ms(lambda: fn(audio16)),
           "align_dp_ms": _wall_ms(lambda: max_alignment(bare_text.lower(), heard))}
    if out["native_built"]:
        out["resample_native_ms"] = _wall_ms(lambda: native.resample(wav24k, 24000, 16000))
        out["native_vs_scipy_max_abs"] = float(np.abs(
            native.resample(wav24k, 24000, 16000) - audio16).max())
    return out


def _check_redaction(tts, clips, fn, heard: str, launches: Launches, record: dict) -> None:
    """Phase 12c: a bracketed ultra_fast request redacted by the full-width
    wav2vec2, its text the first W2V_TEXT_CHARS of what the model heard."""
    import numpy as np

    from tortoise_tpu_torch.utils.wav2vec_alignment import Wav2VecAlignment, _bracket_segments

    preset, _, seed = REQUESTS[0]
    h = heard[:W2V_TEXT_CHARS]
    third = len(h) // 3
    text = f"{h[:third]}[{h[third:2 * third]}]{h[2 * third:]}"
    aligner = Wav2VecAlignment(logits_fn=fn, device="cuda")
    given = {}
    redact = aligner.redact

    def spy(audio, expected_text, audio_sample_rate=24000):
        given["audio"] = np.array(audio)
        return redact(audio, expected_text, audio_sample_rate)

    aligner.redact = spy
    tts.aligner = aligner
    res, wav = _quality_request(tts, clips, preset, text, seed, launches, whole=False)
    full = given["audio"].reshape(-1)
    segments = _bracket_segments(text)
    offsets = aligner.align(full, "".join(seg for seg, _ in segments))
    kept, pos = [], 0
    for seg, bracketed in segments:
        if not bracketed and seg:
            kept.append(full[offsets[pos]:offsets[max(0, pos + len(seg) - 1)]])
        pos += len(seg)
    want = np.concatenate(kept)
    got = wav[0, 0].numpy()
    res.update(unredacted_samples=full.shape[0], redacted_samples=got.shape[0],
               redact_finalize_s=res["stages_s"]["redact_finalize"],
               parts_ms=_redaction_parts_ms(full, "".join(seg for seg, _ in segments), fn))
    print("redacted request", json.dumps({k: res[k] for k in (
        "text", "wall_s", "unredacted_samples", "redacted_samples", "redact_finalize_s",
        "parts_ms")}))
    if not got.shape[0] < full.shape[0] or not np.array_equal(got, want):
        raise AssertionError(f"redaction: {got.shape[0]} samples of {full.shape[0]}, "
                             f"the kept spans of align are {want.shape[0]}")
    tts.aligner = None
    record["redacted_request"] = res


def _check_cvvp(tts, clips, launches: Launches, record: dict) -> None:
    """Phase 12d: an ultra_fast request with cvvp_amount=0.5; CVVP's scores
    of its candidates against each clip, held to the CPU float32 module on
    the same (bf16-rounded) weights."""
    import torch

    from tortoise_tpu_torch.models.cvvp import CVVP

    preset, text, seed = REQUESTS[0]
    tts.load_cvvp()
    calls = []
    score = tts.cvvp.score_candidates

    def spy(mel, codes):
        out = score(mel, codes)
        calls.append((mel.float().cpu(), codes.cpu(), out.float().cpu()))
        return out

    tts.cvvp.score_candidates = spy
    res, _ = _quality_request(tts, clips, preset, text, seed, launches, cvvp_amount=0.5)
    cpu = CVVP(tts.cvvp.config)
    cpu.load_state_dict({k: v.float().cpu() for k, v in tts.cvvp.state_dict().items()})
    cpu.eval()
    n = cpu.config.mel_codes
    codes = calls[0][1]
    bad = ((codes < 0) | (codes >= n)).any(dim=1)
    err = 0.0
    with torch.inference_mode():
        sl = cpu.speech_latents(codes.clamp(0, n - 1))
        for mel, c, got in calls:
            want = (sl @ cpu.cond_latents(mel)[0]) * cpu.temperature.exp()
            if not torch.equal(c, codes) or not torch.equal(torch.isneginf(got), bad):
                raise AssertionError("CVVP: the candidates or their -inf scores differ")
            err = max(err, float((got[~bad] - want[~bad]).abs().max()) if (~bad).any() else 0.0)
    res.update(candidates=codes.shape[0], clips=len(calls), max_abs_err=err,
               bound=CVVP_ABS_BOUND, cvvp_rerank_s=res["stages_s"]["cvvp_rerank"])
    print("CVVP request", json.dumps({k: res[k] for k in (
        "wall_s", "candidates", "clips", "max_abs_err", "bound", "cvvp_rerank_s")}))
    if len(calls) != len(clips) or err > CVVP_ABS_BOUND:
        raise AssertionError(f"CVVP: {len(calls)} calls, scores off the CPU's by {err:.3g}")
    record["cvvp_request"] = res


def _tf32_flags() -> list:
    import torch

    return [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]


def _check_classifier(wav24k, record: dict):
    """Phase 12e: the classifier at full width through
    api.classify_audio_clip (seeded random weights) on the 23.2 s clip, with
    cuDNN's TF32 first turned back on, as a fresh process has it: the call
    must turn it off itself. Held to the float32 forward on the CPU; the
    TF32 forward's distance from it is recorded beside the bound. Returns
    the CPU module, phase 12f's reference."""
    import torch

    from tortoise_tpu_torch import api
    from tortoise_tpu_torch import weights as weights_lib
    from tortoise_tpu_torch.models.classifier import (AudioMiniEncoderWithClassifierHead,
                                                      classify_audio_clip)

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    prob = api.classify_audio_clip(wav24k, device="cuda")
    flags = _tf32_flags()
    with torch.device("cuda"):
        model = AudioMiniEncoderWithClassifierHead()
    weights_lib.load_weights("classifier", model, None, True, 7)
    model.eval()
    cpu = AudioMiniEncoderWithClassifierHead()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = classify_audio_clip(wav24k, cpu.eval())
    torch.backends.cudnn.allow_tf32 = True
    tf32 = classify_audio_clip(wav24k, model)
    weights_lib.float32_device("cuda")
    with torch.inference_mode():
        x = torch.as_tensor(wav24k, device="cuda")[None, :, None]
        ms = _time_ms(lambda: model(x), 5)
        dev_ms = _device_ms(lambda: model(x), 5)
    res = {"samples": int(wav24k.shape[0]), "prob": prob, "cpu_prob": want,
           "abs_err": abs(prob - want), "bound": CLASSIFIER_ABS_BOUND,
           "tf32_after_call": flags, "tf32_prob": tf32, "tf32_abs_err": abs(tf32 - want),
           "forward_ms": ms, "forward_device_ms": dev_ms}
    print("classifier", json.dumps(res))
    if any(flags) or not 0.0 <= prob <= 1.0 or abs(prob - want) > CLASSIFIER_ABS_BOUND:
        raise AssertionError(f"classifier: {res}")
    record["classifier"] = res
    return cpu


# phase 12f: is_this_from_tortoise's main in a process of its own (so with
# PyTorch's default TF32 flags until the CLI sets them), reporting the
# probability unrounded, the flags it ran with and its own wall
DETECT_CLI = """import json, sys, time
t0 = time.perf_counter()
import torch
from tortoise_tpu_torch.apps import is_this_from_tortoise as cli
prob = cli.main(sys.argv[1:])
print(json.dumps({"prob": prob, "main_s": time.perf_counter() - t0, "tf32": [
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}))
"""


def _run_quality_clis(models_dir: str, cpu_classifier, record: dict) -> None:
    """Phase 12f: is_this_from_tortoise on phase 10's wav, in a process of
    its own and held to the CPU float32 classifier, and eval --cer over a
    one-line TSV (a text and a train_dotrice clip), its wav2vec2 the phase's
    seeded checkpoint in ``models_dir``."""
    import math
    import subprocess

    from scipy.io.wavfile import read as wav_read

    from tortoise_tpu_torch.apps import eval as eval_cli
    from tortoise_tpu_torch.models.classifier import classify_audio_clip
    from tortoise_tpu_torch.utils.audio import BUILTIN_VOICES_DIR, load_audio

    res = {}
    clip = os.path.join(ROOT, "build", "cli.wav")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", DETECT_CLI, "--clip", clip], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode:
        raise AssertionError(f"is_this_from_tortoise exited {run.returncode}: "
                             f"{run.stderr[-2000:]}")
    got = json.loads(run.stdout.strip().splitlines()[-1])
    want = classify_audio_clip(load_audio(clip, 24000)[0], cpu_classifier)
    res["is_this_from_tortoise"] = {
        "wall_s": wall, "main_s": got["main_s"], "prob": got["prob"], "cpu_prob": want,
        "abs_err": abs(got["prob"] - want), "bound": CLASSIFIER_ABS_BOUND,
        "tf32": got["tf32"],
        "said": [l for l in run.stdout.splitlines() if "classifier thinks" in l]}
    if (any(got["tf32"]) or not 0.0 <= got["prob"] <= 1.0
            or abs(got["prob"] - want) > CLASSIFIER_ABS_BOUND):
        raise AssertionError(f"is_this_from_tortoise: {res['is_this_from_tortoise']}")

    tsv = os.path.join(ROOT, "build", "eval_lines.tsv")
    out = os.path.join(ROOT, "build", "eval_out")
    real = os.path.join(BUILTIN_VOICES_DIR, "train_dotrice", "1.wav")
    with open(tsv, "w", encoding="utf-8") as f:
        f.write(f"{REQUESTS[0][1]}\t{real}\n")
    argv = ["--eval_path", tsv, "--output_path", out, "--preset", "ultra_fast", "--cer",
            "--model_dir", models_dir]
    t0 = time.perf_counter()
    rows = eval_cli.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "results.tsv"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    sr, wav = wav_read(os.path.join(out, "0.wav"))
    res["eval"] = {"argv": argv, "wall_s_with_init": wall, "results": lines,
                   "samples": int(wav.shape[0])}
    print("quality CLIs", json.dumps(res))
    if (not rows or len(lines) != 1 or not math.isfinite(rows[0][1]) or rows[0][1] < 0
            or sr != 24000 or not wav.size):
        raise AssertionError(f"eval --cer: {res['eval']}")
    record["quality_clis"] = res


def run_quality_api_rest(clips, record: dict, launches: Launches) -> None:
    """Phase 12, the quality API's remaining paths (redaction, CVVP, the
    classifier and their CLIs), counted as one path."""
    import warnings

    import torch

    from tortoise_tpu_torch.api import TextToSpeech

    preset, text, seed = REQUESTS[0]
    models_dir = os.path.join(ROOT, "build", "w2v_models")
    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda")
    record["phase12_init_s"] = time.perf_counter() - t0
    if not tts.enable_redaction or tts.aligner is None:
        raise AssertionError("TextToSpeech(): redaction is not on by default")
    launches.reset()

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, wav = _quality_request(tts, clips, preset, "[I am really sad,] " + text, seed,
                                    launches)
    said = [str(w.message) for w in caught if "redaction disabled" in str(w.message)]
    res["warned"] = said
    print("bracketed request without wav2vec2", json.dumps({k: res[k] for k in (
        "wall_s", "audio_s", "warned")}))
    if len(said) != 1 or tts.aligner is not None:
        raise AssertionError(f"bracketed request without a checkpoint: warnings {said}, "
                             f"aligner {tts.aligner!r}")
    record["unredacted_request"] = res
    wav24k = wav[0, 0].numpy()

    model, fn, heard = _check_wav2vec2(wav24k, models_dir, record)
    _check_redaction(tts, clips, fn, heard, launches, record)
    del model, fn
    _check_cvvp(tts, clips, launches, record)
    cpu_classifier = _check_classifier(wav24k, record)
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    _run_quality_clis(models_dir, cpu_classifier, record)
    counts = launches.read()
    launches.add(counts, "run_quality_api_rest")
    record["phase12_launches"] = counts
    print("quality API path launches", json.dumps(counts))
    if min(counts[_k2_row_name("bf16")], counts[K3_NAME], counts[K4_NAME]) <= 0:
        raise AssertionError(f"phase 12's requests did not launch K2, K3 and K4: {counts}")
    gc.collect()
    torch.cuda.empty_cache()


def _uv_train_flops(cfg, b: int, t_text: int, t_mel: int) -> float:
    """Operations of one UnifiedVoice train step (forward and backward, 3x
    the forward's products): the blocks' denses (24 C^2 a position and
    layer), the attention's two products over the whole (T, T) matrix the
    plain attention computes, and the two heads."""
    n = 1 + (t_text + 2) + (t_mel + 2)
    c = cfg.model_dim
    layers = cfg.layers * (24 * c * c * n + 4 * n * n * c)
    heads = 2 * c * (cfg.text_vocab * (t_text + 2) + cfg.number_mel_codes * (t_mel + 2))
    return 3.0 * b * (layers + heads)


def _train_steps(model, batch: dict, steps: int, loss_fn=None) -> tuple[list, list]:
    """``steps`` steps of make_train_step (lr TRAIN_LR, warmup TRAIN_WARMUP)
    on one batch: (each step's metrics as floats, each step's wall in ms,
    synchronised)."""
    import torch

    from tortoise_tpu_torch.training import train_step as ts

    opt = ts.make_optimizer(lr=TRAIN_LR, warmup=TRAIN_WARMUP)
    step = ts.make_train_step(model, opt, loss_fn or ts.unified_voice_loss)
    state = ts.init_train_state(model, opt)
    cuda = next(model.parameters()).is_cuda
    metrics, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        if cuda:
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, walls


def _leaf_grad_errs(model, cpu_model, batch: dict) -> dict:
    """One loss and backward on each from the same weights: every leaf's
    max |card - CPU| gradient over its max |CPU grad|, the worst leaf, and
    the losses. A leaf the loss does not reach has no gradient on either."""
    from tortoise_tpu_torch.training.train_step import unified_voice_loss

    losses = []
    for m in (model, cpu_model):
        dev = next(m.parameters()).device
        for p in m.parameters():
            p.grad = None
        loss, _ = unified_voice_loss(m, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        losses.append(float(loss.detach()))
    errs = {}
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if q.grad is not None:
            errs[name] = float((p.grad.cpu() - q.grad).abs().max() / q.grad.abs().max())
        p.grad = q.grad = None
    return {"loss": losses, "leaf_rel_err": errs,
            "worst_leaf": max(errs.items(), key=lambda kv: kv[1])}


def _leaves_close(got: dict, want: dict, lr: float) -> dict:
    """TRAIN_LEAVES of two state dicts after the same steps: the largest
    difference and the share beyond TRAIN_NEAR_FRAC of lr, per leaf."""
    out = {}
    for name in TRAIN_LEAVES:
        d = (got[name].cpu() - want[name]).abs()
        out[name] = {"max_abs": float(d.max()),
                     "far_share": float((d > TRAIN_NEAR_FRAC * lr).float().mean())}
        if out[name]["max_abs"] > 2 * lr or out[name]["far_share"] > TRAIN_FAR_SHARE:
            raise AssertionError(f"{name} after two steps, card vs CPU: {out[name]}")
    return out


def _check_uv_against_cpu(model, record: dict) -> None:
    """Phase 13a: the full-width model from the same (initial) weights on
    the card and on the CPU over a short batch: each leaf's gradient, then
    two steps (the first changes nothing, the second takes lr TRAIN_LR /
    TRAIN_WARMUP)."""
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice
    from tortoise_tpu_torch.utils.profiling import train_batch

    cpu_model = UnifiedVoice(model.config)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = train_batch(model.config, TRAIN_CPU_BATCH, TRAIN_CPU_TEXT, TRAIN_CPU_MEL, "cpu",
                        seed=7)
    t0 = time.perf_counter()
    res = _leaf_grad_errs(model, cpu_model, batch)
    got, _ = _train_steps(model, {k: v.cuda() for k, v in batch.items()}, 2)
    want, _ = _train_steps(cpu_model, batch, 2)
    res.update({"s": time.perf_counter() - t0, "card": got, "cpu": want})
    res["metrics_rel_err"] = max(abs(g[k] - w[k]) / abs(w[k])
                                 for g, w in zip(got, want) for k in ("loss", "grad_norm"))
    res["leaves"] = _leaves_close(model.state_dict(), cpu_model.state_dict(),
                                  TRAIN_LR / TRAIN_WARMUP)
    print("UnifiedVoice, card vs CPU", json.dumps(res))
    if res["worst_leaf"][1] > TRAIN_CPU_GRAD_FRAC or \
            res["metrics_rel_err"] > TRAIN_CPU_REL_BOUND:
        raise AssertionError(f"UnifiedVoice on the card vs the CPU: worst leaf "
                             f"{res['worst_leaf']} (bound {TRAIN_CPU_GRAD_FRAC}), metrics "
                             f"{res['metrics_rel_err']} (bound {TRAIN_CPU_REL_BOUND})")
    record["train_uv_vs_cpu"] = res


def _finite(metrics: list, what: str) -> None:
    import math

    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{what}: a metric is not finite: {metrics}")


def _check_uv_bf16_against_cpu(record: dict) -> None:
    """Phase 13d: the full-width UnifiedVoice built with bf16 compute over
    float32 parameters, from the same seeded weights on the card and on the
    CPU, over the short batch: each leaf's float32 gradient and the loss."""
    import torch

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.utils.profiling import train_batch

    cfg = UnifiedVoiceConfig()
    model = UnifiedVoice(cfg, dtype=torch.bfloat16).cuda()
    weights.init_random(model, 0)
    cpu_model = UnifiedVoice(cfg, dtype=torch.bfloat16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = train_batch(cfg, TRAIN_CPU_BATCH, TRAIN_CPU_TEXT, TRAIN_CPU_MEL, "cpu", seed=7)
    t0 = time.perf_counter()
    res = _leaf_grad_errs(model, cpu_model, batch)
    res["s"] = time.perf_counter() - t0
    res["loss_rel_err"] = abs(res["loss"][0] - res["loss"][1]) / abs(res["loss"][1])
    print("UnifiedVoice bf16, card vs CPU", json.dumps(res))
    record["train_uv_bf16_vs_cpu"] = res
    if res["worst_leaf"][1] > TRAIN_CPU_BF16_GRAD_FRAC or \
            res["loss_rel_err"] > TRAIN_CPU_BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 UnifiedVoice on the card vs the CPU: worst leaf "
                             f"{res['worst_leaf']} (bound {TRAIN_CPU_BF16_GRAD_FRAC}), loss "
                             f"{res['loss_rel_err']} (bound {TRAIN_CPU_BF16_LOSS_RTOL})")


def _uv_steps(cfg, batch: dict, shape, dtype, remat: bool) -> dict:
    """TRAIN_STEPS steps of a seeded full-width UnifiedVoice in ``dtype``
    (None: float32), each block recomputed in the backward with ``remat``:
    the steps' metrics and walls, the median step after the first, tokens/s,
    TFLOP/s against the peak of the compute dtype, peak memory. The loss
    must hold at the warmup's lr 0, then fall."""
    import torch

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice

    model = UnifiedVoice(cfg, dtype=dtype).cuda()
    weights.init_random(model, 0)
    model.gpt.remat = remat
    torch.cuda.reset_peak_memory_stats()
    metrics, walls = _train_steps(model, batch, TRAIN_STEPS)
    step_ms = sorted(walls[1:])[len(walls[1:]) // 2]
    flops = _uv_train_flops(cfg, *shape)
    b, t_text, t_mel = shape
    peak = BF16_PEAK_TFLOPS if dtype == torch.bfloat16 else F32_PEAK_TFLOPS
    res = {"batch": list(shape), "dtype": str(dtype or torch.float32), "remat": remat,
           "steps": metrics, "walls_ms": walls, "step_ms": step_ms,
           "tokens_per_s": b * (t_text + t_mel + 4) / step_ms * 1e3,
           "tflop_per_step": flops / 1e12, "tflops": flops / step_ms / 1e9,
           "peak_tflops": peak,
           "trained_params": sum(p.numel() for p in model.parameters() if p.requires_grad),
           "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    res["peak_share"] = res["tflops"] / peak
    del model
    gc.collect()
    torch.cuda.empty_cache()
    what = f"UnifiedVoice {res['dtype']}{' remat' if remat else ''} steps"
    print(what, json.dumps(res))
    _finite(metrics, what)
    losses = [m["loss"] for m in metrics]
    if abs(losses[1] - losses[0]) > 1e-6 * losses[0] or not losses[-1] < losses[1]:
        raise AssertionError(f"{what}: the loss did not hold at lr 0, then fall: {losses}")
    if res["param_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"{what}: parameters not float32: {res['param_dtypes']}")
    return res


def _train_uv(record: dict) -> None:
    """Phase 13a, 13b and 13d: UnifiedVoice against the CPU, then its train
    steps at full length in float32, in bf16, and in bf16 with remat."""
    import torch

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.utils.profiling import train_batch

    cfg = UnifiedVoiceConfig()
    model = UnifiedVoice(cfg).cuda()
    weights.init_random(model, 0)
    _check_uv_against_cpu(model, record)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _check_uv_bf16_against_cpu(record)
    shape = (TRAIN_BATCH, TRAIN_TEXT, TRAIN_MEL)
    batch = train_batch(cfg, *shape, "cuda", seed=5)
    for key, dtype, remat in (("train_uv", None, False), ("train_uv_bf16", torch.bfloat16, False),
                              ("train_uv_bf16_remat", torch.bfloat16, True)):
        record[key] = _uv_steps(cfg, batch, shape, dtype, remat)


def _train_one_step(name: str, model, batch: dict, loss_fn, shape, record: dict) -> None:
    """OTHER_TRAIN_STEPS steps of ``model`` on one batch: the first one's
    metrics and wall (it pays the shapes' first calls), the median later
    step's wall, peak memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    metrics, walls = _train_steps(model, batch, OTHER_TRAIN_STEPS, loss_fn=loss_fn)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    res = {"batch": list(shape), "metrics": metrics[0], "wall_ms": walls[0],
           "step_ms": sorted(walls[1:])[len(walls[1:]) // 2], "walls_ms": walls,
           "param_dtypes": dtypes, "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    print(f"{name} train step", json.dumps(res))
    _finite(metrics, name)
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"{name}: parameters not float32: {dtypes}")
    record[f"train_{name}"] = res


def _train_others(record: dict, dtype=None) -> None:
    """Phase 13c (float32) and 13e (``dtype`` bf16 over float32
    parameters): OTHER_TRAIN_STEPS steps each of DiffusionTts
    (training_losses, latent conditioning), CLVP (token-dropout masks) and
    CVVP."""
    import torch

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.diffusion.losses import training_losses
    from tortoise_tpu_torch.diffusion.schedule import spaced_schedule
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.cvvp import CVVP, CVVPConfig
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig

    g = torch.Generator(device="cuda").manual_seed(11)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    ints = lambda hi, *shape: torch.randint(0, hi, shape, generator=g, device="cuda")
    keep = lambda *shape: torch.rand(shape, generator=g, device="cuda") > 0.2

    sfx = "" if dtype is None else "_bf16"
    cfg = DiffusionTtsConfig()
    model = DiffusionTts(cfg, dtype=dtype).cuda()
    weights.init_random(model, 1)
    schedule = spaced_schedule("linear", 4000, 4000)
    b, frames, n_lat = DIFF_TRAIN
    batch = {"x": torch.tanh(rand(b, frames, cfg.in_channels)),
             "t": ints(schedule.num_timesteps, b),
             "latents": rand(b, n_lat, cfg.in_latent_channels),
             "cond": rand(b, 2 * cfg.model_channels)}

    def diffusion_loss(m, bt):
        fn = lambda x, t: m(x, t, aligned_conditioning=bt["latents"],
                            conditioning_latent=bt["cond"])
        terms = training_losses(fn, schedule, bt["x"], bt["t"], generator=g)
        return terms["loss"].mean(), {"mse": terms["mse"].mean(), "vb": terms["vb"].mean()}

    _train_one_step(f"diffusion{sfx}", model, batch, diffusion_loss, DIFF_TRAIN, record)
    del model
    cfg = CLVPConfig()
    model = CLVP(cfg, dtype=dtype).cuda()
    weights.init_random(model, 2)
    b, t_text, t_speech = CLVP_TRAIN
    batch = {"text": ints(cfg.num_text_tokens, b, t_text),
             "speech": ints(cfg.num_speech_tokens, b, t_speech),
             "text_mask": keep(b, t_text), "voice_mask": keep(b, t_speech)}
    _train_one_step(f"clvp{sfx}", model, batch, lambda m, bt: (m(
        bt["text"], bt["speech"], return_loss=True, text_mask=bt["text_mask"],
        voice_mask=bt["voice_mask"]), {}), CLVP_TRAIN, record)
    del model
    cfg = CVVPConfig()
    model = CVVP(cfg, dtype=dtype).cuda()
    weights.init_random(model, 3)
    b, frames, n_codes = CVVP_TRAIN
    batch = {"mel": rand(b, frames, cfg.mel_channels), "codes": ints(cfg.mel_codes, b, n_codes)}
    _train_one_step(f"cvvp{sfx}", model, batch,
                    lambda m, bt: (m(bt["mel"], bt["codes"], return_loss=True), {}),
                    CVVP_TRAIN, record)


def run_training(record: dict, launches: Launches) -> None:
    """Phase 13, the training path at full width with seeded random weights,
    float32 with TF32 off, then bf16 compute over float32 parameters. It
    launches no kernel of the port: the training forward takes the plain
    attention, as the JAX package's does."""
    import torch

    from tortoise_tpu_torch import weights

    weights.float32_device("cuda")
    launches.reset()
    t0 = time.perf_counter()
    _train_uv(record)
    gc.collect()
    torch.cuda.empty_cache()
    _train_others(record)
    gc.collect()
    torch.cuda.empty_cache()
    _train_others(record, torch.bfloat16)
    counts = launches.read()
    record["phase13_launches"] = counts
    record["phase13_s"] = time.perf_counter() - t0
    print("training path launches", json.dumps(counts))
    if counts[K3_NAME] or any(counts.values()):
        raise AssertionError(f"phase 13 launched a kernel of the port: {counts}")
    gc.collect()
    torch.cuda.empty_cache()


def check_categorical_cuda(record: dict) -> None:
    """Phase 14, before any mesh request: ops.sampling.categorical on the
    card draws what torch.multinomial(probs, 1) draws from the same
    generator, from float32 and from bf16 logits, and leaves the generator
    where multinomial leaves it."""
    import torch

    from tortoise_tpu_torch.ops.sampling import categorical

    cases = []
    for seed, shape, dtype in itertools.product((3, 5, 11), ((8, 50), (16, 8194), (96, 50)),
                                                (torch.float32, torch.bfloat16)):
        logits = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(seed),
                             device="cuda").mul(3).to(dtype)
        g1 = torch.Generator("cuda").manual_seed(seed + 100)
        g2 = torch.Generator("cuda").manual_seed(seed + 100)
        want = torch.multinomial(torch.softmax(logits, -1), 1, generator=g1)[:, 0]
        got = categorical(g2, logits)
        case = {"seed": seed, "shape": list(shape), "dtype": str(dtype),
                "draws_equal": torch.equal(got, want),
                "generator_equal": torch.equal(g1.get_state(), g2.get_state())}
        cases.append(case)
        if not (case["draws_equal"] and case["generator_equal"]):
            raise AssertionError(f"categorical on CUDA is not multinomial's draw: {case}")
    record["phase14_categorical"] = cases
    print(f"categorical on CUDA: {len(cases)} seeds x shapes x dtypes (float32, bf16) draw "
          f"what multinomial draws")


def check_mp3_voice(record: dict) -> None:
    """Phase 14: the mp3-only voice tim_reynolds loads through ffmpeg where
    the machine has it; without it the loader raises the error that names
    ffmpeg. Which of the two the machine showed goes into the record."""
    import shutil

    from tortoise_tpu_torch.utils.audio import load_voices

    res = {"ffmpeg": shutil.which("ffmpeg")}
    if res["ffmpeg"]:
        clips, latents = load_voices(["tim_reynolds"])
        res["clip_samples"] = [int(c.shape[-1]) for c in clips]
        if latents is not None or len(clips) != 4 or min(res["clip_samples"]) <= 0:
            raise AssertionError(f"tim_reynolds did not load its four mp3 clips: {res}")
    else:
        try:
            load_voices(["tim_reynolds"])
        except RuntimeError as e:
            res["error"] = str(e)
        if "requires ffmpeg" not in res.get("error", ""):
            raise AssertionError(f"without ffmpeg, tim_reynolds must raise the error that "
                                 f"names it: {res}")
    record["phase14_mp3_voice"] = res
    print("mp3 voice tim_reynolds", json.dumps(res))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_step_logits(mesh, dtype) -> list[float]:
    """Phase 14c: one teacher-forced decode step (a prefilled prompt, then a
    given token a row; the step's attention is K1) through UnifiedVoice
    split over the tp=2 ``mesh`` and unsplit, from the same seeded weights
    in ``dtype``: for each seed of MESH_LOGIT_SEEDS (the prompt, the
    conditioning and the tokens), the largest row-relative error of the mel
    logits."""
    import torch

    from tortoise_tpu_torch.api import load_autoregressive
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
    from tortoise_tpu_torch.models.gpt2 import init_kv_cache
    from tortoise_tpu_torch.parallel.sharding import KVCacheSharding

    cfg = UnifiedVoiceConfig()
    split, _, _ = load_autoregressive(cfg, "bf16", "cuda", dtype, None, True, False, mesh,
                                      split=True)
    whole, _, _ = load_autoregressive(cfg, "bf16", "cuda", dtype, None, True, False)
    b = MESH_LOGIT_ROWS

    @torch.inference_mode()
    def logits(model, sharding, cond, text, tokens):
        prompt = model.compute_prompt(cond, text).expand(b, -1, -1)
        cache = init_kv_cache(cfg.gpt_config, b, 768, torch.float32, "cuda", sharding)
        model.gpt(prompt, cache=cache, cache_index=0)
        h, _ = model.gpt(model.decode_embed(tokens[:, None], 0), cache=cache,
                         cache_index=prompt.shape[1])
        return model.hidden_to_mel_logits(h[:, 0]).float()

    errs = []
    for seed in MESH_LOGIT_SEEDS:
        g = torch.Generator("cuda").manual_seed(seed)
        cond = torch.randn((1, cfg.model_dim), generator=g, device="cuda")
        text = torch.randint(3, 250, (1, MESH_LOGIT_PROMPT), generator=g, device="cuda")
        tokens = torch.randint(0, 8192, (b,), generator=g, device="cuda")
        errs.append(_row_rel_err(logits(split, KVCacheSharding(mesh), cond, text, tokens),
                                 logits(whole, None, cond, text, tokens)))
    del split, whole
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def _mesh_train(mesh) -> dict:
    """Phase 14d: one UnifiedVoice train step at full width over
    MESH_TRAIN_BATCH x 1011 positions, unsplit and over the tp=2 mesh, from
    the same seeded weights and batch, in float32 and in bf16 (float32
    parameters)."""
    import torch

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.training import train_step as ts
    from tortoise_tpu_torch.utils.profiling import train_batch

    cfg = UnifiedVoiceConfig()
    batch = train_batch(cfg, MESH_TRAIN_BATCH, TRAIN_TEXT, TRAIN_MEL, "cuda", seed=5)
    out = {"batch": [MESH_TRAIN_BATCH, TRAIN_TEXT, TRAIN_MEL]}
    for key, dtype, bound in (("f32", None, TRAIN_CPU_REL_BOUND),
                              ("bf16", torch.bfloat16, MESH_TRAIN_BF16_REL_BOUND)):
        res = {}
        for name in ("whole", "tp2"):
            model = UnifiedVoice(cfg, dtype=dtype).cuda()
            weights.init_random(model, 0)
            opt = ts.make_optimizer(lr=TRAIN_LR, warmup=TRAIN_WARMUP)
            if name == "tp2":
                state = ts.init_sharded_train_state(model, opt, mesh)
                step = ts.make_train_step(model, opt, mesh=mesh)
            else:
                state, step = ts.init_train_state(model, opt), ts.make_train_step(model, opt)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            res[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "first_step_ms": (time.perf_counter() - t0) * 1e3,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "param_dtypes": sorted({str(p.dtype) for p in model.parameters()})}
            del model, state, step, opt
            gc.collect()
            torch.cuda.empty_cache()
        res["rel_err"] = max(abs(res["tp2"][k] - res["whole"][k]) / abs(res["whole"][k])
                             for k in ("loss", "grad_norm"))
        out[key] = res
        if res["rel_err"] > bound or res["tp2"]["param_dtypes"] != ["torch.float32"]:
            raise AssertionError(f"the {key} tp=2 train step's loss or grad_norm is not the "
                                 f"unsplit step's (bound {bound}): {res}")
    return out


def mesh_worker() -> int:
    """Phase 14c and 14d: one rank of the world of two over gloo on the one
    card (``chip_smoke.py --mesh-worker``; RANK and MASTER_PORT from the
    environment). Each request of MESH_REQUESTS: its init, its wall, peak
    memory and launches, K1, K3 and K4 launched; with tp=2 one decode
    step's logits against the unsplit model's; the rows of its codes equal
    to the unsplit request's, reported. Then the tp=2 train steps, float32
    and bf16."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tortoise_tpu_torch import weights
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.parallel.mesh import make_mesh, rank_device
    from tortoise_tpu_torch.utils.audio import load_voice

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(rank_device())
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            world_size=2, rank=rank)
    weights.float32_device("cuda")
    t_start = time.perf_counter()
    refs = np.load(os.path.join(ROOT, "build", "phase14_ref.npz"))
    clips, _ = load_voice("train_dotrice")
    launches = Launches()
    meshes = {(1, 2): make_mesh(1, 2), (2, 1): make_mesh(2, 1)}
    out = {"rank": rank, "device": str(rank_device()), "logits_row_rel_err": {}}
    for dtype, bound in ((torch.float32, MESH_LOGITS_F32_BOUND),
                         (torch.bfloat16, MESH_LOGITS_BF16_BOUND)):
        errs = _mesh_step_logits(meshes[(1, 2)], dtype)
        out["logits_row_rel_err"][str(dtype)] = errs
        print(f"rank {rank} tp=2 {dtype}: decode step logits row rel err at seeds "
              f"{MESH_LOGIT_SEEDS}: {errs} (bound {bound})")
        if max(errs) > bound:
            raise AssertionError(f"tp=2 {dtype}: the split step's logits are not the unsplit "
                                 f"step's: {errs} > {bound}")
    preset, text, seed = REQUESTS[0]
    for name, dp, tp, half in MESH_REQUESTS:
        t0 = time.perf_counter()
        tts = TextToSpeech(device="cuda", enable_redaction=False, half=half,
                           kv_cache_dtype="f32", mesh=meshes[(dp, tp)])
        init_s = time.perf_counter() - t0
        launches.reset()
        res, _ = _quality_request(tts, clips, preset, text, seed, launches)
        counts = launches.read()
        if min(counts[K1_NAME], counts[K3_NAME], counts[K4_NAME]) <= 0:
            raise AssertionError(f"{name}: K1, K3 and K4 must launch on every rank: {counts}")
        ref = refs["bf16" if half else "f32"]
        codes = tts.last_candidates
        differ = codes != ref
        res.update(dp=dp, tp=tp, half=half, init_s=init_s, candidate_rows=len(codes),
                   rows_equal_unsplit=int((~differ).all(axis=1).sum()),
                   first_differing_step=[int(d.argmax()) if d.any() else None for d in differ])
        out[name] = res
        print(f"rank {rank} {name}: wall {res['wall_s']:.2f} s, peak "
              f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, codes equal to the unsplit request's "
              f"in {res['rows_equal_unsplit']} of {len(codes)} rows (first differing steps "
              f"{res['first_differing_step']})")
        del tts
        gc.collect()
        torch.cuda.empty_cache()
    out["train"] = _mesh_train(meshes[(1, 2)])
    out["s"] = time.perf_counter() - t_start
    print(f"rank {rank} tp=2 train step", json.dumps(out["train"]))
    with open(os.path.join(ROOT, "build", f"phase14_rank{rank}.json"), "w") as f:
        json.dump(out, f, indent=1)
    dist.destroy_process_group()
    return 0


def _run_mesh_world() -> list[dict]:
    """The world of two: both ranks started at once, each writing its log
    to build/; the phase fails when a rank fails or outlasts
    MESH_WORLD_TIMEOUT, and then the other is killed."""
    import subprocess

    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}
    logs = [os.path.join(ROOT, "build", f"phase14_rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-worker"], cwd=ROOT,
                env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MESH_WORLD_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "a timeout"
            if rc != 0:
                with open(logs[r]) as f:
                    tail = f.read()[-6000:]
                raise AssertionError(f"phase 14: rank {r} of the world of two ended with "
                                     f"{rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(2):
        with open(logs[r]) as f:
            print(f"--- phase 14 rank {r} ---\n" + "".join(
                ln for ln in f if ln.startswith(f"rank {r}")), end="")
    ranks = []
    for r in range(2):
        with open(os.path.join(ROOT, "build", f"phase14_rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def run_mesh(clips, bf16_ref_codes, record: dict, launches: Launches) -> dict:
    """Phase 14, the mesh path on the one card, after phase 13 and before
    phase 11. The mp3 voice; (a) K1 at a tp=2 rank's width; categorical on
    CUDA. (b) A
    world of one over NCCL: TextToSpeech(mesh=make_mesh(1, 1)) answers the
    f32-cache float32 request with the codes of the same request unsplit.
    (c), (d) the world of two over gloo (``mesh_worker``). Returns K1's
    row at the tp=2 width."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.parallel import multihost
    from tortoise_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    check_mp3_voice(record)
    k1_row = check_decode_attention_merged(record, C=512, H=8, batches=(8, 16), key="k1_tp2")
    check_categorical_cuda(record)
    preset, text, seed = REQUESTS[0]
    kw = dict(device="cuda", enable_redaction=False, half=False, kv_cache_dtype="f32")
    res = {}
    for name in ("unsplit", "mesh_1x1"):
        mesh = None
        if name == "mesh_1x1":
            multihost.initialize(f"localhost:{_free_port()}", 1, 0)
            mesh = make_mesh(1, 1)
        t0 = time.perf_counter()
        tts = TextToSpeech(gpt_fused_step=False, mesh=mesh, **kw)
        init_s = time.perf_counter() - t0
        launches.reset()
        res[name], _ = _quality_request(tts, clips, preset, text, seed, launches)
        counts = launches.read()
        launches.add(counts, "run_mesh")
        res[name].update(init_s=init_s, codes=tts.last_candidates)
        if min(counts[K1_NAME], counts[K3_NAME], counts[K4_NAME]) <= 0 or \
                any(counts[_k2_row_name(v)] for v in K2_VARIANTS):
            raise AssertionError(f"phase 14 {name}: K1, K3 and K4 must launch, K2 never: "
                                 f"{counts}")
        del tts
        gc.collect()
        torch.cuda.empty_cache()
        if mesh is not None:
            dist.destroy_process_group()
    ref = res["unsplit"].pop("codes")
    if not np.array_equal(res["mesh_1x1"].pop("codes"), ref):
        raise AssertionError("phase 14: the world of one's codes are not the unsplit request's")
    np.savez(os.path.join(ROOT, "build", "phase14_ref.npz"), f32=ref, bf16=bf16_ref_codes)
    ranks = _run_mesh_world()
    record["phase14"] = {"world_of_one": res, "world_of_two": ranks,
                         "s": time.perf_counter() - t_phase}
    print(f"phase 14 in {record['phase14']['s']:.1f} s")
    return k1_row


def _check_socket_server(record: dict, launches: Launches) -> None:
    """Phase 15a: apps.socket_server over a full-width bf16 TextToSpeechFast
    on 127.0.0.1 at a port the system picks; one connection sends two
    utterances of SOCKET_VOICE. Each must come back as float32 samples (a
    whole number of them), finite, non-empty, ended by END_OF_AUDIO, and
    grow K2's bf16 count. Prints the time to the first bytes and the total."""
    import socket
    import threading

    import numpy as np

    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.apps.socket_server import END_OF_AUDIO, TTSServer

    t0 = time.perf_counter()
    server = TTSServer(host="127.0.0.1", port=0, tts=TextToSpeechFast(device="cuda"))
    port = server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    init_s = time.perf_counter() - t0
    k2 = _k2_row_name("bf16")
    rows = []
    launches.reset()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=SOCKET_TIMEOUT) as sock:
            for text in SOCKET_TEXTS:
                before = launches.read()[k2]
                t0 = time.perf_counter()
                sock.sendall(f"{SOCKET_VOICE}|{text}".encode("utf-8"))
                buf, first = b"", None
                while not buf.endswith(END_OF_AUDIO):
                    data = sock.recv(1 << 16)
                    if not data:
                        raise AssertionError(f"socket server closed the connection on {text!r}")
                    first = first or time.perf_counter() - t0
                    buf += data
                total = time.perf_counter() - t0
                pcm = buf[:-len(END_OF_AUDIO)]
                audio = np.frombuffer(pcm, dtype="<f4")
                row = {"text": text, "first_bytes_s": first, "total_s": total,
                       "audio_s": len(audio) / 24000.0, "bytes": len(pcm),
                       "k2_launches": launches.read()[k2] - before,
                       "finite": bool(np.isfinite(audio).all())}
                rows.append(row)
                print("socket utterance", json.dumps(row))
                if len(pcm) % 4 or not len(audio) or not row["finite"] or not row["k2_launches"]:
                    raise AssertionError(f"socket server: a bad utterance: {row}")
    finally:
        server.close()
        thread.join(timeout=SOCKET_TIMEOUT)
    launches.add(launches.read(), "_check_socket_server")
    if thread.is_alive():
        raise AssertionError("socket server: serve_forever did not return after close")
    record["phase15_socket"] = {"init_s": init_s, "utterances": rows}


def _check_clvp_plain(record: dict) -> None:
    """Phase 15b: CLVP with use_xformers=False at the shipped widths (768,
    20 + 20 layers, 12 heads, text table 350), seeded random weights,
    float32: its similarities on the card against the CPU module's, TF32
    off, and its forward timed on the card."""
    import torch

    from tortoise_tpu_torch import weights as weights_lib
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig

    cfg = CLVPConfig(use_xformers=False)
    cpu = CLVP(cfg)
    weights_lib.init_random(cpu, 9)
    dev = weights_lib.float32_device("cuda")
    card = CLVP(cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    b, t_text, t_speech = CLVP_PLAIN_SHAPES
    g = torch.Generator().manual_seed(9)
    text = torch.randint(0, cfg.num_text_tokens, (b, t_text), generator=g)
    speech = torch.randint(0, cfg.num_speech_tokens, (b, t_speech), generator=g)
    with torch.inference_mode():
        want = cpu.eval()(text, speech)
        text_c, speech_c = text.to(dev), speech.to(dev)
        got = card.eval()(text_c, speech_c).cpu()
        ms = _time_ms(lambda: card(text_c, speech_c), 5)
    err = (got - want).abs().max().item()
    res = {"shapes": CLVP_PLAIN_SHAPES, "max_abs_err": err, "bound": CLVP_PLAIN_ABS_BOUND,
           "similarities": got.tolist(), "forward_ms": ms}
    record["phase15_clvp_plain"] = res
    print(f"CLVP use_xformers=False, 768 x (20 + 20), B={b} x ({t_text}, {t_speech}) tokens: "
          f"card vs CPU max|err| {err:.3g} (bound {CLVP_PLAIN_ABS_BOUND}); forward {ms:.2f} ms")
    if not torch.isfinite(got).all() or err > CLVP_PLAIN_ABS_BOUND:
        raise AssertionError(f"CLVP use_xformers=False: card against CPU: {res}")


def _check_npz_round_trip(record: dict, launches: Launches) -> None:
    """Phase 15c: a full-width UnivNet's tree (convert.from_jax.to_jax)
    through weights.save_params; load_weights from that directory must
    report "native", and its forward equal the forward of the tree loaded
    directly (from_jax), sample for sample."""
    import torch

    from tortoise_tpu_torch import weights as weights_lib
    from tortoise_tpu_torch.convert.from_jax import from_jax, to_jax
    from tortoise_tpu_torch.models.vocoder import UnivNetConfig, UnivNetGenerator

    dev = weights_lib.float32_device("cuda")
    build = lambda: UnivNetGenerator(UnivNetConfig(use_kernel=True)).to(dev).eval()
    model = build()
    weights_lib.init_random(model, 3)
    tree = to_jax(model)
    models_dir = os.path.join(ROOT, "build", "npz_models")
    t0 = time.perf_counter()
    weights_lib.save_params(os.path.join(models_dir, "vocoder.npz"), tree)
    save_s = time.perf_counter() - t0
    loaded, direct = build(), build()
    t0 = time.perf_counter()
    source = weights_lib.load_weights("vocoder", loaded, models_dir, False, 0)
    load_s = time.perf_counter() - t0
    direct.load_state_dict(from_jax(direct, tree))
    g = torch.Generator(device=dev).manual_seed(15)
    mel = torch.randn((1, 200, 100), generator=g, device=dev)
    z = torch.randn((1, 210, 64), generator=g, device=dev)
    launches.reset()
    with torch.inference_mode():
        got, want = loaded.inference(mel, z), direct.inference(mel, z)
    counts = launches.read()
    launches.add(counts, "_check_npz_round_trip")
    res = {"source": source, "save_s": save_s,
           "load_s": load_s, "bytes": os.path.getsize(os.path.join(models_dir, "vocoder.npz")),
           "equal": bool(torch.equal(got, want)), "launches": counts}
    record["phase15_npz"] = res
    print("npz round trip", json.dumps(res))
    if source != "native" or not res["equal"] or counts[K4_NAME] != 2 * LVC_CALLS_PER_FORWARD:
        raise AssertionError(f"the .npz round trip: {res}")


def _check_stft_and_crossfade(record: dict) -> None:
    """Phase 15d: istft(stft(x)) on the card against x (23.2 s at 24 kHz,
    n_fft 1024, hop 256); stft_magnitude(center=False) of x on the card
    against the same call on the CPU; native.crossfade against its formula;
    the tokenizer's decode(encode(t)) of the smoke's request texts against
    their cleaned text."""
    import numpy as np
    import torch

    from tortoise_tpu_torch import native
    from tortoise_tpu_torch.ops import mel
    from tortoise_tpu_torch.utils.tokenizer import VoiceBpeTokenizer

    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((1, 557056), generator=g, device="cuda").clamp(-4, 4) / 4
    spec = mel.stft(x, 1024, 256, 1024)
    back = mel.istft(spec, 1024, 256, 1024, length=x.shape[-1])
    mag = mel.stft_magnitude(x, 1024, 256, 1024, center=False)
    torch.cuda.synchronize()
    err = (back - x[:, :back.shape[-1]]).abs().max().item() / x.abs().max().item()
    mag_cpu = mel.stft_magnitude(x.cpu(), 1024, 256, 1024, center=False)
    mag_err = ((mag.cpu() - mag_cpu).abs().max() / mag_cpu.abs().max()).item()
    tok = VoiceBpeTokenizer()
    texts = sorted({t for _, t, _ in REQUESTS} | {STREAM_REQUEST[0], *BATCH_TEXTS,
                                                   *SOCKET_TEXTS})
    decoded = {t: tok.decode(tok.encode(t)) == tok.preprocess_text(t) for t in texts}
    rng = np.random.default_rng(16)
    chunk, overlap = rng.standard_normal(4096).astype(np.float32), \
        rng.standard_normal(1024).astype(np.float32)
    faded = native.crossfade(chunk, overlap)
    if faded is None:
        raise AssertionError("native.crossfade: the native library did not build or load")
    t = np.arange(1024, dtype=np.float32) / np.float32(1023)
    want = chunk.copy()
    want[:1024] = overlap * (1 - t) + chunk[:1024] * t
    cf_err = float(np.abs(faded - want).max())
    res = {"stft_shape": list(spec.shape), "istft_rel_err": err, "bound": STFT_REL_BOUND,
           "magnitude_shape": list(mag.shape), "magnitude_rel_err_vs_cpu": mag_err,
           "crossfade_max_abs_err": cf_err, "decode_round_trips": decoded}
    record["phase15_stft_crossfade"] = res
    print("stft/istft, stft_magnitude, crossfade, decode", json.dumps(res))
    frames = 1 + (x.shape[-1] - 1024) // 256
    if back.shape != x.shape or err > STFT_REL_BOUND or cf_err > 1e-6 \
            or mag.shape != (1, 513, frames) or mag_err > STFT_REL_BOUND \
            or not all(decoded.values()):
        raise AssertionError(f"istft(stft(x)), stft_magnitude, crossfade or decode: {res}")


def _check_repo_tools(record: dict) -> None:
    """Phase 15e: two repo tools in this process, which imports no JAX:
    fetch_weights --offline over a seeded reference-layout rlg_auto.pth
    (converted, cached as its .npz and verified against the shipped model)
    and make_demo_voices (its clips the repository's, byte for byte), both
    into build/."""
    import numpy as np
    import torch

    from tortoise_tpu_torch.tools import fetch_weights, make_demo_voices
    from tortoise_tpu_torch.utils.audio import BUILTIN_VOICES_DIR

    src, dst, voices = (os.path.join(ROOT, "build", d)
                        for d in ("tools_ref", "tools_npz", "demo_voices"))
    os.makedirs(src, exist_ok=True)
    g = torch.Generator().manual_seed(13)
    torch.save({f"layers.{i}.{k}": (torch.randn(1024, 1024, generator=g) / 32 if k == "weight"
                                    else torch.zeros(1024))
                for i in range(6) for k in ("weight", "bias")},
               os.path.join(src, "rlg_auto.pth"))
    if os.path.exists(os.path.join(dst, "rlg_auto.npz")):
        os.unlink(os.path.join(dst, "rlg_auto.npz"))
    t0 = time.perf_counter()
    fetched = fetch_weights.main(["--offline", "--src", src, "--dst", dst, "rlg_auto"])
    demo = make_demo_voices.main(["--dest", voices])
    res = {"fetch_weights": fetched, "written": len(demo["written"]),
           "s": time.perf_counter() - t0, "clips_equal": {}}
    for name in ("demo_alto", "demo_bass"):
        for clip in ("1.wav", "2.wav"):
            with open(os.path.join(voices, name, clip), "rb") as a, \
                    open(os.path.join(BUILTIN_VOICES_DIR, name, clip), "rb") as b:
                res["clips_equal"][f"{name}/{clip}"] = a.read() == b.read()
    with np.load(os.path.join(voices, "demo_latents", "demo_latents.npz")) as a, \
            np.load(os.path.join(BUILTIN_VOICES_DIR, "demo_latents", "demo_latents.npz")) as b:
        res["latents_equal"] = all(np.array_equal(a[k], b[k]) for k in ("auto", "diffusion"))
    print("repo tools", json.dumps(res))
    record["repo_tools"] = res
    if fetched != {"rlg_auto": "ok"} or not all(res["clips_equal"].values()) \
            or not res["latents_equal"]:
        raise AssertionError(f"the repo tools: {res}")


def run_serving_and_rest(record: dict, launches: Launches) -> None:
    """Phase 15, after phase 14 and before phase 11: the socket server, CLVP's
    plain-Transformer variant, the .npz round trip, stft/istft and the
    crossfade, the repo tools; each part's wall printed."""
    record["phase15_s"] = {}
    for part, fn in (("socket_server", lambda: _check_socket_server(record, launches)),
                     ("clvp_plain", lambda: _check_clvp_plain(record)),
                     ("npz", lambda: _check_npz_round_trip(record, launches)),
                     ("stft_crossfade", lambda: _check_stft_and_crossfade(record)),
                     ("repo_tools", lambda: _check_repo_tools(record))):
        t0 = time.perf_counter()
        fn()
        record["phase15_s"][part] = time.perf_counter() - t0
        print(f"phase 15 {part}: {record['phase15_s'][part]:.1f} s")


# phase 16: the bench's sections with one timed run each (its Runs, every
# field 1) after each one's warm-up, at BENCH_TOKENS tokens a request.
# The kernels the sections launch: K2 in the variants they run (bf16: the
# headline, the ladder and tts_batch; int8_weights: int8_decode; int8_cache:
# high_quality over the int8 cache), K1 (fused_ab's rows with K2 off), K3
# and K4 (every quality request)
BENCH_KERNELS = (_k2_row_name("bf16"), _k2_row_name("int8_weights"),
                 _k2_row_name("int8_cache"), K1_NAME, K3_NAME, K4_NAME)
# a section's instances are dropped before the next: the memory left
# allocated after each stays within this of the headline instance's, GB
BENCH_MEMORY_SLACK_GB = 0.5
# the AR batch of each quality row: the picker's on an 80 GB card (128,
# 256 with the int8 cache), which it gets only if this process has freed
# its cached memory before the child starts
BENCH_AR_BATCHES = {"ultra_fast": 128, "fast": 128, "standard": 128, "fast_int8_decode": 128,
                    "high_quality_int8kv": 256}
BENCH_TIMEOUT = 900


def bench_worker() -> int:
    """Phase 16 in a process of its own (``chip_smoke.py --bench-worker``):
    the bench's headline and every section of tortoise_tpu_torch/bench.py
    through its section functions, one timed run each, the launch counters
    set to 0 before and read after. Prints the bench's line, then one JSON
    line {"line", "launches"}."""
    import torch

    from tortoise_tpu_torch import bench
    from tortoise_tpu_torch.api_fast import TextToSpeechFast

    launches = Launches()
    launches.reset()
    t0 = time.perf_counter()
    tts = TextToSpeechFast(dtype=torch.bfloat16, device="cuda")
    ctx = bench.Context(tts, "cuda", BENCH_TOKENS, bench.Runs(*[1] * 8))
    detail = bench.measure_headline(ctx, t0)
    bench.run_sections(detail, ctx)
    ctx.emit()
    line = {"metric": "fast_preset_rtf", "value": ctx.headline_rtf, "detail": detail}
    print(json.dumps({"line": line, "launches": launches.read()}))
    return 0


def run_bench_phase(record: dict, launches: Launches) -> None:
    """Phase 16: bench_worker in a process of its own (its memory and
    timings its own), after every other phase. Fails on a section's error
    or skip, a headline that is not finite and positive, a row without a
    finite positive rtf, memory that piles up between sections, or a kernel
    of BENCH_KERNELS that did not launch; adds its launches to the totals."""
    import math
    import subprocess

    import torch

    from tortoise_tpu_torch import bench

    print("--- phase 16: python3 -m tortoise_tpu_torch.bench's sections, one run each")
    # the child's batch picker reads the card's free memory: this process's
    # cached blocks go back to the card first
    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = {"allocated": torch.cuda.memory_allocated() / 1e9,
                 "reserved": torch.cuda.memory_reserved() / 1e9}
    print(f"this process holds {json.dumps(parent_gb)} GB")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--bench-worker"],
                         cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    print(run.stdout[-6000:])
    if run.returncode:
        raise AssertionError(f"phase 16 exited {run.returncode}: {run.stderr[-3000:]}")
    res = json.loads(run.stdout.strip().splitlines()[-1])
    line, counts = res["line"], res["launches"]
    detail = line["detail"]
    record["bench"] = {"line": line, "launches": counts, "wall_s": wall, "parent_gb": parent_gb}
    print("bench line", json.dumps(line))
    print(f"phase 16 in {wall:.1f} s; launches {json.dumps(counts)}")
    errors = {k: v for k, v in detail.items() if k.endswith("_error")}
    if errors or detail["sections_skipped"] or \
            tuple(detail["section_times_s"]) != tuple(name for name, *_ in bench.SECTIONS):
        raise AssertionError(f"phase 16: errors {errors}, skipped "
                             f"{detail['sections_skipped']}, ran {detail['section_times_s']}")
    ladder = detail["quality_ladder"]
    rtfs = [line["value"], *(r["rtf"] for r in ladder.values()),
            detail["long_form_high_quality"]["rtf"], detail["fast_int8_decode"]["rtf"],
            *(r["rtf"] for r in detail["fused_ab"]["fast_b1"].values())]
    if not all(math.isfinite(x) and x > 0 for x in rtfs) or len(ladder) != 5:
        raise AssertionError(f"phase 16: rtfs {rtfs}, ladder {sorted(ladder)}")
    batches = {k: r["ar_batch"] for k, r in ladder.items()}
    if batches != BENCH_AR_BATCHES:
        raise AssertionError(f"phase 16: AR batches {batches}, not {BENCH_AR_BATCHES}")
    mem = detail["memory_allocated_gb"]
    if max(mem.values()) > mem["headline"] + BENCH_MEMORY_SLACK_GB:
        raise AssertionError(f"phase 16: memory piles up between sections: {mem}")
    missing = [k for k in BENCH_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 16: {missing} never launched: {counts}")
    launches.add(counts, "run_bench_phase")


def serving_walls() -> int:
    """``--serving-walls [--root DIR]``: phases 7-10's requests alone, on
    the package at PACKAGE_ROOT; one JSON line of their walls."""
    import torch

    import tortoise_tpu_torch
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.ops import _build
    from tortoise_tpu_torch.utils.audio import load_voice

    package = os.path.dirname(os.path.abspath(tortoise_tpu_torch.__file__))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    if os.path.dirname(package) != PACKAGE_ROOT:
        raise AssertionError(f"imported {package}, not the package under {PACKAGE_ROOT}")
    record = {"package": package, "nvidia_smi": _nvidia_smi()}
    sources = ("decode_step", "flash_rel_attn", "lvc", "decode_attn_merged")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    launches = Launches()
    clips, _ = load_voice("train_dotrice")
    tts = TextToSpeech(device="cuda", enable_redaction=False)
    record["warmup_s"] = _quality_request(tts, clips, *REQUESTS[0], launches)[0]["wall_s"]
    run_pipeline(tts, clips, record, launches)
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    run_fast_path(clips, record, launches)
    run_quality_int8(clips, record, launches)
    tts = TextToSpeech(device="cuda", enable_redaction=False, kv_cache_dtype="f32",
                       gpt_fused_step=False)
    f32 = _quality_request(tts, clips, *REQUESTS[0], launches)[0]
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    run_cli(record, launches)
    fast = record["fast_path"]
    walls = {"package": package, "nvidia_smi": record["nvidia_smi"],
             "warmup_s": record["warmup_s"],
             "quality_s": [r["wall_s"] for r in record["requests"]],
             "fast_tts_s": [r["tts"]["wall_s"] for r in fast],
             "fast_first_chunk_s": [r["stream"]["first_chunk_s"] for r in fast],
             "fast_stream_s": [r["stream"]["total_s"] for r in fast],
             "fast_tts_batch_s": fast[0]["tts_batch"]["wall_s"],
             "int8_cache_s": [r["wall_s"] for r in record["quality_int8_cache"]],
             "f32_cache_s": f32["wall_s"], "cli_with_init_s": record["cli"]["wall_s_with_init"]}
    # each request's sampled codes and audio, in the order of the walls above
    requests = [*record["requests"], *record["quality_int8_cache"], f32]
    walls["codes_sha"] = {"quality": [r["codes_sha"] for r in requests],
                          "fast": [r[k]["codes_sha"] for r in fast for k in ("tts", "stream")]}
    walls["wav_sha"] = {"quality": [r["wav_sha"] for r in requests],
                        "fast": [r[k]["wav_sha"] for r in fast for k in ("tts", "stream")],
                        "fast_tts_batch": fast[0]["tts_batch"]["wav_sha"],
                        "cli": record["cli"]["wav_sha"]}
    print(json.dumps({"serving_walls": walls}))
    return 0


# --k1-ab: K1's shapes (C, H, batches) at pos=500, T=768, L=30 (full width
# and a tp=2 rank's), the type pairs of phase 6, the host pieces' batches
# and calls a timing, and the bench's K2-off runs after a warm one
K1_AB_SHAPES = ((1024, 16, (1, 8, 16, 64, 96)), (512, 8, (8, 16)))
K1_HOST_BATCHES, K1_HOST_CALLS = (1, 16), 2000
K1_AB_BENCH_RUNS, K1_AB_F32_REQUESTS = 3, 3


def _host_us(fn, calls: int = K1_HOST_CALLS) -> float:
    """Host microseconds a call of ``fn``, the median of five runs of
    ``calls`` calls; the device is waited on only between runs."""
    import torch

    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return sorted(runs)[2]


def k1_host_pieces(attn, b: int, pos: int = 500) -> dict:
    """K1's host microseconds a call at (B, C=1024, H=16, T=768, bf16),
    by piece: the argument checks, the allocations, the split plan and the
    kernel's launch (its arguments gathered and the ctypes call), beside the
    whole wrapper. ``attn`` is the ``ops.attn`` module of the package under
    test: a one-kernel wrapper (``k1_plan``, one output allocation) or a
    two-kernel one (``decode_splits``, the output and a split scratch)."""
    import torch

    c, heads, t, layer = 1024, 16, 768, 1
    g = torch.Generator(device="cuda").manual_seed(3)
    cache = {n: torch.randn((2, b, t, c), generator=g, device="cuda").to(torch.bfloat16)
             for n in "kv"}
    q, kn, vn = _k1_inputs(g, b, c, torch.bfloat16)
    kc, vc = cache["k"], cache["v"]
    pieces = {"checks": lambda: attn._check_k1_args(q, kn, vn, kc, vc, layer, pos, heads)}
    if hasattr(attn, "k1_plan"):
        group, splits = attn.k1_plan(b, heads, pos)
        out = q.new_empty((b, c))
        layer_bytes = layer * b * t * c * kc.element_size()
        pieces["allocations"] = lambda: q.new_empty((b, c))
        pieces["plan"] = lambda: attn.k1_plan(b, heads, pos)
        pieces["launch"] = lambda: attn._K1(
            q.get_device(), q.data_ptr(), kn.data_ptr(), vn.data_ptr(), q.stride(0),
            kc.data_ptr() + layer_bytes, vc.data_ptr() + layer_bytes, out.data_ptr(),
            attn._K1_KIND[q.dtype, kc.dtype], b, t, c, group, pos, splits)
    else:
        splits = attn.decode_splits(b * heads, pos)
        out = torch.empty((b, c), dtype=q.dtype, device=q.device)
        partial = torch.empty((b, heads, splits, 66), dtype=torch.float32, device=q.device)
        pieces["allocations"] = lambda: (
            torch.empty((b, c), dtype=q.dtype, device=q.device),
            torch.empty((b, heads, splits, 66), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
        pieces["plan"] = lambda: attn.decode_splits(b * heads, pos)
        pieces["launch"] = lambda: attn._K1(
            q.get_device(), q.data_ptr(), kn.data_ptr(), vn.data_ptr(), q.stride(0),
            kc.data_ptr(), vc.data_ptr(), out.data_ptr(), partial.data_ptr(),
            int(q.dtype == torch.float32), int(kc.dtype == torch.float32), 2, b, t, c, layer,
            pos, splits)
    res = {name: _host_us(fn) for name, fn in pieces.items()}
    res["wrapper"] = _host_us(lambda: attn.decode_attention_merged(q, kn, vn, kc, vc, layer, pos,
                                                                   heads=heads))
    res["rest"] = res["wrapper"] - sum(res[k] for k in pieces)
    res["splits"] = splits
    return res


def k1_ab() -> int:
    """``--k1-ab [--root DIR]``: K1 and the requests whose decode runs it,
    on the package at PACKAGE_ROOT; one JSON line. K1 (``k1_times``) at
    K1_AB_SHAPES over the three type pairs, warm and cold, beside row write
    + SDPA; its host microseconds by piece (``k1_host_pieces``); then the
    requests with K2 off: quality ultra_fast over the f32 cache
    (gpt_fused_step=False, K1_AB_F32_REQUESTS after a warm-up request), and
    the bench's fast path and ``tts_batch`` of 64 with gpt_fused_step=False
    (its runners, the median of K1_AB_BENCH_RUNS timed runs after a warm
    one, 200 tokens). Run on two checkouts in one call, in the order A, B,
    B, A."""
    import torch

    import tortoise_tpu_torch
    from tortoise_tpu_torch import bench
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.ops import _build
    from tortoise_tpu_torch.ops import attn
    from tortoise_tpu_torch.utils.audio import load_voice

    package = os.path.dirname(os.path.abspath(tortoise_tpu_torch.__file__))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    if os.path.dirname(package) != PACKAGE_ROOT:
        raise AssertionError(f"imported {package}, not the package under {PACKAGE_ROOT}")
    sources = ("decode_step", "flash_rel_attn", "lvc", "decode_attn_merged")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    res = {"package": package, "nvidia_smi": _nvidia_smi(), "k1": []}
    g = torch.Generator(device="cuda").manual_seed(5)
    L, T, pos, layer = 30, 768, 500, 7
    for c, heads, batches in K1_AB_SHAPES:
        for q_dtype, c_dtype in ((torch.bfloat16, torch.bfloat16),
                                 (torch.float32, torch.float32),
                                 (torch.bfloat16, torch.float32)):
            for b in batches:
                cache = {n: torch.randn((L, b, T, c), generator=g, device="cuda").to(c_dtype)
                         for n in "kv"}
                plain = {n: t_.clone() for n, t_ in cache.items()}
                q, kn, vn = _k1_inputs(g, b, c, q_dtype)
                got = attn.decode_attention_merged(q, kn, vn, cache["k"], cache["v"], layer, pos,
                                                   heads=heads)
                want = attn.decode_attention_merged_plain(q, kn, vn, plain["k"], plain["v"],
                                                          layer, pos, heads=heads)
                err = _head_rel_err(got, want, heads)
                if err > (K1_F32_BOUND if q_dtype == torch.float32 else K1_BF16_BOUND):
                    raise AssertionError(f"K1 C={c} B={b} {q_dtype}/{c_dtype}: head rel err "
                                         f"{err}")
                case = {"C": c, "B": b, "q": str(q_dtype)[6:], "cache": str(c_dtype)[6:],
                        "head_rel_err": err,
                        **k1_times(attn.decode_attention_merged,
                                   attn.decode_attention_merged_plain, q, kn, vn, cache, plain,
                                   pos, heads, layer)}
                res["k1"].append(case)
                print(f"K1 C={c} B={b:2d} q {case['q']} cache {case['cache']}: cold "
                      f"{case['ms']:.4f} / {case['device_ms']:.4f} ms "
                      f"({case['share_of_bound']:.0%} of {case['bound_ms']:.4f}), warm "
                      f"{case['ms_warm']:.4f} / {case['device_ms_warm']:.4f}; SDPA cold "
                      f"{case['library_ms']:.4f} / {case['library_device_ms']:.4f}", flush=True)
                del cache, plain
                torch.cuda.empty_cache()
    res["k1_host_us"] = {b: k1_host_pieces(attn, b) for b in K1_HOST_BATCHES}
    print("K1 host us:", json.dumps(res["k1_host_us"]), flush=True)

    launches = Launches()
    clips, _ = load_voice("train_dotrice")
    tts = TextToSpeech(device="cuda", enable_redaction=False, kv_cache_dtype="f32",
                       gpt_fused_step=False)
    _quality_request(tts, clips, *REQUESTS[0], launches)
    f32 = [_quality_request(tts, clips, *REQUESTS[0], launches)[0]
           for _ in range(K1_AB_F32_REQUESTS)]
    res["f32_cache_s"] = [r["wall_s"] for r in f32]
    res["f32_cache_ar_s"] = [r["stages_s"]["autoregressive"] for r in f32]
    res["f32_cache_codes_sha"] = sorted({r["codes_sha"] for r in f32})
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    fast = TextToSpeechFast(dtype=torch.bfloat16, device="cuda")
    launches.reset()
    for name, runner in (
            ("fast_k2_off", bench.fast_runner(fast, BENCH_TOKENS, gpt_fused_step=False)),
            ("tts_batch64_k2_off", bench.serve_runner(fast, bench.SERVE_UTTERANCES, BENCH_TOKENS,
                                                      gpt_fused_step=False))):
        rtf, p50, audio = bench._measure(runner, K1_AB_BENCH_RUNS)
        res[name] = {"rtf": rtf, "p50_wall_s": p50, "audio_s": audio}
        print(name, json.dumps(res[name]), flush=True)
    counts = launches.read()
    if counts[K1_NAME] <= 0 or any(counts[_k2_row_name(v)] for v in K2_VARIANTS):
        raise AssertionError(f"the K2-off runs must launch K1 and no K2: {counts}")
    res["bench_k1_launches"] = counts[K1_NAME]
    print(json.dumps({"k1_ab": res}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device; it runs only on the GPU")
    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.ops import _build
    from tortoise_tpu_torch.utils.audio import load_voice

    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    record = {"device": kind, "nvidia_smi": smi}
    t_start = time.perf_counter()

    sources = ("decode_step", "flash_rel_attn", "lvc", "decode_attn_merged", "decode_attn_kv128",
               "attn_body", "probe_ops", "ssm_step", "group_norm")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        usage = pool.submit(_build.resource_usage, "decode_attn_merged")
        list(pool.map(_build.build, sources))
        record["k1_ptxas"] = [ln.strip() for ln in usage.result().splitlines()
                              if "Used" in ln or "spill" in ln or "entry function" in ln]
    record["build_s"] = time.perf_counter() - t_start
    print(f"built kernels in {record['build_s']:.1f} s")
    print("K1, nvcc -Xptxas -v:\n  " + "\n  ".join(record["k1_ptxas"]))

    k2_rows = check_decode_step(record)
    k3_row = check_flash_attention(record)
    k4_row = check_lvc(record)
    k1_row = check_decode_attention_merged(record)
    ssm_row = check_ssm_step(record)
    gn_row = check_group_norm(record)

    t0 = time.perf_counter()
    tts = TextToSpeech(device="cuda", enable_redaction=False)
    record["init_s"] = time.perf_counter() - t0
    print(f"TextToSpeech (full width, random weights) ready in {record['init_s']:.1f} s; "
          f"AR batch {tts.autoregressive_batch_size}")
    clips, _ = load_voice("train_dotrice")
    k2_rows["bf16"].update(check_decode_main_path(tts, clips, record))
    for var, timing in check_decode_main_path_int8(tts, clips, record).items():
        k2_rows[var].update(timing)
    check_k1_main_path(tts, clips, record)
    check_diffusion(tts, record)
    check_univnet(tts, record)
    launches = Launches()
    run_pipeline(tts, clips, record, launches)
    # each instance's peak memory is its own
    del tts
    gc.collect()
    torch.cuda.empty_cache()
    run_fast_path(clips, record, launches)
    run_quality_int8(clips, record, launches)
    f32_cache_codes = run_quality_f32_cache(clips, record, launches)
    run_cli(record, launches)
    # phase 12 before phase 11: profile_ar_step's profiler passes come after
    # every timing of the process
    run_quality_api_rest(clips, record, launches)
    run_training(record, launches)
    record["k1_tp2_row"] = run_mesh(clips, f32_cache_codes, record, launches)
    run_serving_and_rest(record, launches)
    tool_rows = check_tool_kernels(record)
    run_tools(record, launches)
    run_bench_phase(record, launches)
    record["launches_by_path"] = launches.by_path
    print("K1 launches by path:", json.dumps({p: n[K1_NAME] for p, n in launches.by_path.items()
                                              if n[K1_NAME]}))

    rows = [k2_rows[v] for v in K2_VARIANTS] + [k3_row, k4_row, k1_row] + tool_rows \
        + [ssm_row, gn_row]
    for row in rows:
        row["launches"] = launches.total[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched by the main paths")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "tortoise_tpu")
    if jax_package:
        raise AssertionError(f"the port imported the JAX package: {jax_package}")
    record["kernels"] = rows
    record["total_s"] = time.perf_counter() - t_start

    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(f"total {record['total_s']:.1f} s")
    print(f"nvidia-smi: {_nvidia_smi()}")
    print(json.dumps({"kernels": [{k: row[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms")}
        for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--mesh-worker"]:
        sys.exit(mesh_worker())
    if sys.argv[1:] == ["--bench-worker"]:
        sys.exit(bench_worker())
    if sys.argv[1:] == ["--trace-worker"]:
        sys.exit(trace_worker())
    if "--k1-ab" in sys.argv:
        sys.exit(k1_ab())
    if sys.argv[1:] == ["--granite"]:
        sys.exit(granite_smoke())
    if sys.argv[1:] == ["--k2"]:
        sys.exit(k2_smoke())
    if sys.argv[1:] == ["--group-norm"]:
        sys.exit(group_norm_smoke())
    if sys.argv[1:] == ["--group-norm-split"]:
        sys.exit(group_norm_split_worker())
    sys.exit(serving_walls() if "--serving-walls" in sys.argv else main())
