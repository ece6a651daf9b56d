"""The port's mesh path (tortoise_tpu_torch/parallel) on the CPU, held to the
unsharded port and to the JAX package's mesh (tests/test_multichip.py,
tests/test_multihost.py).

Two worlds of torch.distributed ranks over gloo run this file's own
``__main__`` branch, which imports no jax: one of four ranks (the sampled and
greedy decodes over dp=4 and dp=2 x tp=2, CLVP scoring and a diffusion
fan-out step over dp=4, one dp=2 x tp=2 train step) and one of two (the
quality API, the fast API's ``tts_batch`` and the full-knob CLI over dp=2,
the multihost helpers in a real world, and the bf16 UnifiedVoice's train
steps over tp=2 and over dp=2). Both start once for the module,
on free localhost ports, each process with its own timeout and the world
killed on a failure, and write their results to a temporary folder; the
JAX side runs in this process on the conftest's 8 virtual devices
meanwhile. float32, tiny configs; the JAX weights reach the port through
convert/from_jax.py.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UV = dict(layers=2, model_dim=128, heads=4, max_text_tokens=30, max_mel_tokens=48)
CLVP_KW = dict(dim_text=64, dim_speech=64, dim_latent=64, text_enc_depth=2, text_heads=4,
               speech_enc_depth=2, speech_heads=4)
DIFF_KW = dict(model_channels=64, num_layers=2, in_latent_channels=64, num_heads=4)
# the quality and fast APIs' tiny configs (tests/test_multichip.py's)
API_UV = dict(layers=2, model_dim=128, heads=4, max_text_tokens=60, max_mel_tokens=80)
API_DIFF = dict(model_channels=128, num_layers=2, in_latent_channels=128, num_heads=4)
API_CLVP = dict(dim_text=128, dim_speech=128, dim_latent=128, text_enc_depth=2, text_heads=4,
                speech_enc_depth=2, speech_heads=4)
# the quality requests' diffusion steps, each within DIFF_TOL of its unsplit batch
API_DIFF_STEPS = 2
DECODE_SEED, MAX_GENERATE = 7, 16
LR, WARMUP, TRAIN_STEPS = 1e-3, 1, 2
WORKER_TIMEOUT = 120
# tests/test_multichip.py's tolerances: latents of a tp-split decode (partial
# sums reordered), the diffusion fan-out step
LATENT_TOL = 1e-4
DIFF_TOL = 5e-4
# the bf16 train step over the mesh against the unsplit bf16 step: loss and
# grad_norm relative, one bf16 ulp (2^-8; chip_smoke holds bf16 logits to
# 2^-5); read up to 6.1e-5 (tp=2's grad_norm) on the CPU
BF16_TRAIN_RTOL = 2.0 ** -8
# tests/test_torch_training.py's: losses and grad_norm, and the parameters
LOSS_RTOL = 1e-5
PARAM_NEAR_FRAC, PARAM_FAR_SHARE = 0.01, 1e-3


# ---------------------------------------------------------------------------
# the worker: one rank of a world, no jax
# ---------------------------------------------------------------------------

def _join_world() -> int:
    import torch.distributed as dist

    from tortoise_tpu_torch.parallel import multihost

    assert multihost.initialize(device_type="cpu") is True
    assert multihost.initialize(device_type="cpu") is True     # idempotent
    return dist.get_rank()


def _unsplit(name, part, shape, tp):
    """A tp-split parameter's whole tensor on every rank of the tp group."""
    import torch.distributed as dist

    from tortoise_tpu_torch.parallel.sharding import unified_voice_pspec

    full = part.new_zeros(shape)
    axis = unified_voice_pspec(name, full)
    if "c_attn" in name.split("."):
        for third, mine in zip(full.chunk(3, axis), part.chunk(3, axis)):
            third.chunk(tp.size, axis)[tp.rank].copy_(mine)
    else:
        full.chunk(tp.size, axis)[tp.rank].copy_(part)
    dist.all_reduce(full, group=tp.group)
    return full


def world_decode_train(out: str) -> None:
    """World of four: decodes, CLVP, the diffusion step, the train step."""
    from tortoise_tpu_torch.models.ar_sampler import SamplerSettings, sample_speech
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
    from tortoise_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicate_tree
    from tortoise_tpu_torch.parallel.sharding import KVCacheSharding, gather_rows
    from tortoise_tpu_torch.training import train_step as ts

    rank = _join_world()
    inp = dict(np.load(os.path.join(out, "inputs.npz")))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    uv_sd = torch.load(os.path.join(out, "uv.pt"))

    def voice():
        m = UnifiedVoice(UnifiedVoiceConfig(**UV))
        m.load_state_dict(uv_sd)
        return m.eval()

    def decode(model, n, settings, mesh=None):
        gen = torch.Generator().manual_seed(DECODE_SEED)
        bs = batch_sharding(mesh) if mesh is not None else None
        cs = KVCacheSharding(mesh) if mesh is not None and mesh["tp"].size() > 1 else None
        with torch.inference_mode():
            codes, lats = sample_speech(model, t["cond"], t["text"], gen, n, settings,
                                        cache_dtype=torch.float32, batch_sharding=bs,
                                        cache_sharding=cs)
            if bs is not None:
                codes, lats = gather_rows(codes, bs), gather_rows(lats, bs)
        return codes.numpy(), lats.numpy()

    res = {}
    sampled = SamplerSettings(do_sample=True, max_generate=MAX_GENERATE)
    greedy = SamplerSettings(do_sample=False, max_generate=MAX_GENERATE)
    base = voice()
    for n in (4, 8):
        res[f"base{n}_codes"], res[f"base{n}_lats"] = decode(base, n, sampled)
    mesh4 = make_mesh(4, 1, "cpu")
    res["dp4_codes"], res["dp4_lats"] = decode(base, 8, sampled, mesh4)

    mesh22 = make_mesh(2, 2, "cpu")
    split = voice()
    if rank:        # every rank ends with the first rank's weights
        with torch.no_grad():
            for p in split.parameters():
                p.add_(rank)
    from tortoise_tpu_torch.parallel.sharding import shard_unified_voice

    replicate_tree(split, mesh22)
    res["replicated"] = np.array(all(torch.equal(p, uv_sd[n])
                                     for n, p in split.named_parameters()))
    tp = shard_unified_voice(split, mesh22)
    res["local_heads"] = np.array(split.gpt.local_heads)
    for n in (4, 8):
        res[f"dp2tp2_{n}_codes"], res[f"dp2tp2_{n}_lats"] = decode(split, n, sampled, mesh22)
    res["greedy_codes"], res["greedy_lats"] = decode(split, 4, greedy, mesh22)

    clvp = CLVP(CLVPConfig(**CLVP_KW)).eval()
    clvp.load_state_dict(torch.load(os.path.join(out, "clvp.pt")))
    bs4 = batch_sharding(mesh4)
    with torch.inference_mode():
        rows = bs4.rows(t["cands"].shape[0])
        res["clvp_sharded"] = gather_rows(clvp.score_candidates(t["clvp_text"], t["cands"][rows]),
                                          bs4).numpy()

    diff = DiffusionTts(DiffusionTtsConfig(**DIFF_KW)).eval()
    diff.load_state_dict(torch.load(os.path.join(out, "diff.pt")))
    out_bucket = int(inp["out_bucket"])
    out_lens = t["ns"] * 4 * 24000 // 22050

    def diff_step(r):
        pre = diff.timestep_independent_bucketed(t["dlats"][r], t["ns"][r], t["dcond"],
                                                 out_lens[r], out_bucket)
        return diff(t["x"][r], t["ts"][r], pre, valid_len=out_lens[r])

    with torch.inference_mode():
        res["diff_sharded"] = gather_rows(diff_step(bs4.rows(t["x"].shape[0])), bs4).numpy()

    model = voice().train()
    opt = ts.make_optimizer(lr=LR, warmup=WARMUP)
    state = ts.init_sharded_train_state(model, opt, mesh22)
    step = ts.make_train_step(model, opt, mesh=mesh22)
    batch = {k[6:]: t[k] for k in t if k.startswith("train_")}
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            res[f"train{i}_{k}"] = v.numpy()
    assert state.step == TRAIN_STEPS and state.params["gpt.h_scan.block.attn.c_attn.weight"] \
        .shape[1] == 3 * UV["model_dim"] // 2
    for name, p in model.named_parameters():
        full = _unsplit(name, p.detach(), uv_sd[name].shape, tp) if name in tp.split else p
        res[f"param:{name}"] = full.detach().numpy()
    np.savez(os.path.join(out, f"decode_train_{rank}.npz"), **res)


def _bf16_train_steps(out: str) -> dict:
    """The bf16 UnifiedVoice's train steps over tp=2 and over dp=2 in the
    world of two: each step's loss and grad_norm, and whether every
    parameter (the split ones too), gradient and Adam moment stayed
    float32."""
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.parallel.mesh import make_mesh
    from tortoise_tpu_torch.training import train_step as ts

    inp = dict(np.load(os.path.join(out, "inputs.npz")))
    batch = {k[6:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("train_")}
    res = {}
    for name, (dp, tp) in (("tp2", (1, 2)), ("dp2", (2, 1))):
        model = UnifiedVoice(UnifiedVoiceConfig(**UV), dtype=torch.bfloat16)
        model.load_state_dict(torch.load(os.path.join(out, "uv.pt")))
        mesh = make_mesh(dp, tp, "cpu")
        opt = ts.make_optimizer(lr=LR, warmup=WARMUP)
        state = ts.init_sharded_train_state(model, opt, mesh)
        step = ts.make_train_step(model, opt, mesh=mesh)
        for i in range(TRAIN_STEPS):
            state, metrics = step(state, batch)
            for k in ("loss", "grad_norm"):
                res[f"bf16_{name}_train{i}_{k}"] = metrics[k].numpy()
        loss, _ = ts.unified_voice_loss(model, {k: v[:2] for k, v in batch.items()})
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        tensors = [*model.parameters(), *grads, *state.opt_state["mu"], *state.opt_state["nu"]]
        res[f"bf16_{name}_float32"] = np.array(all(t.dtype == torch.float32 for t in tensors))
        res[f"bf16_{name}_split"] = np.array(sorted(getattr(model.tp, "split", ())))
    return res


def _tiny_quality(cls=None, **kwargs):
    import warnings

    from tortoise_tpu_torch.api import TextToSpeech
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
    from tortoise_tpu_torch.models.clvp import CLVPConfig
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (cls or TextToSpeech)(device="cpu", half=False, enable_redaction=False,
                            kv_cache_dtype="f32", ar_config=UnifiedVoiceConfig(**API_UV),
                            diffusion_config=DiffusionTtsConfig(**API_DIFF),
                            clvp_config=CLVPConfig(**API_CLVP), **kwargs)


def world_api(out: str) -> None:
    """World of two: the quality API, tts_batch, multihost, the bf16 train
    steps, the CLI."""
    import torch.distributed as dist

    from tortoise_tpu_torch import api
    from tortoise_tpu_torch.api_fast import TextToSpeechFast
    from tortoise_tpu_torch.apps import main as cli
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig
    from tortoise_tpu_torch.parallel import multihost
    from tortoise_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from tortoise_tpu_torch.parallel.sharding import gather_rows

    rank = _join_world()
    res = {}
    mesh = make_mesh(device_type="cpu")
    plain = _tiny_quality(autoregressive_batch_size=4)
    meshed = _tiny_quality(autoregressive_batch_size=4, mesh=mesh)
    request = dict(num_autoregressive_samples=4, diffusion_iterations=API_DIFF_STEPS,
                   max_mel_tokens=16, verbose=False)
    # the mesh's k=2 fan-out: its inputs, its gathered mels and its
    # generator's state on entry and on exit
    fan_out, caught = meshed.do_spectrogram_diffusion, {}

    def catch(latents, cond, *, generator, shard=None, valid_latents=None, **kw):
        before = generator.get_state()
        mels = fan_out(latents, cond, generator=generator, shard=shard,
                       valid_latents=valid_latents, **kw)
        if shard is not None:
            caught.update(latents=gather_rows(latents, shard), cond=cond, kw=kw,
                          valid=gather_rows(torch.tensor(valid_latents), shard).tolist(),
                          before=before, after=generator.get_state(),
                          mels=gather_rows(mels, shard))
        return mels

    meshed.do_spectrogram_diffusion = catch
    for k in (1, 2):
        want = plain.tts("Split over ranks.", k=k, use_deterministic_seed=1, **request)
        res[f"k{k}_plain_codes"] = plain.last_candidates
        got = meshed.tts("Split over ranks.", k=k, use_deterministic_seed=1, **request)
        res[f"k{k}_mesh_codes"] = meshed.last_candidates
        for i, (g, w) in enumerate(zip(*(x if k > 1 else [x] for x in (got, want)))):
            res[f"k{k}_mesh_wav{i}"], res[f"k{k}_plain_wav{i}"] = g.numpy(), w.numpy()
    # the same winners as one unsplit batch from the fan-out's generator
    # state on entry; the vocoder per winner, as tts runs it, over the
    # mesh's own mels from the state on exit
    gen = torch.Generator()
    gen.set_state(caught["before"])
    with torch.inference_mode():
        res["k2_fanout_mels_plain"] = plain.do_spectrogram_diffusion(
            caught["latents"], caught["cond"], generator=gen, valid_latents=caught["valid"],
            **caught["kw"]).numpy()
        res["k2_fanout_gen_equal"] = np.array(torch.equal(gen.get_state(), caught["after"]))
        res["k2_fanout_mels_mesh"] = caught["mels"].numpy()
        gen.set_state(caught["after"])
        for i, n in enumerate(caught["valid"]):
            mel = caught["mels"][i:i + 1, :, :n * 4 * 24000 // 22050]
            wav = plain._vocode_clip(mel.transpose(1, 2), gen)
            res[f"k2_vocoded_wav{i}"] = wav[:, :, 0][:, None, :].float().numpy()
    # the fan-out over dp against the same batch unsplit, from one seed
    lat = torch.randn((2, 40, API_UV["model_dim"]), generator=torch.Generator().manual_seed(5))
    cond = torch.randn((1, 2 * API_UV["model_dim"]), generator=torch.Generator().manual_seed(6))
    fan = dict(diffusion_iterations=3, cond_free=True, cond_free_k=2.0, temperature=1.0)
    valid, bs = [40, 29], batch_sharding(mesh)
    with torch.inference_mode():
        res["fanout_plain"] = plain.do_spectrogram_diffusion(
            lat, cond, generator=torch.Generator().manual_seed(9), valid_latents=valid,
            **fan).numpy()
        res["fanout_mesh"] = gather_rows(meshed.do_spectrogram_diffusion(
            lat[bs.rows(2)], cond, generator=torch.Generator().manual_seed(9),
            valid_latents=valid[bs.rows(2)], shard=bs, **fan), bs).numpy()
    del plain, meshed

    fast_kw = dict(device="cpu", dtype=torch.float32,
                   ar_config=UnifiedVoiceConfig(**API_UV))
    texts = ["One sentence.", "A second one, longer.", "Three.", "And the fourth of them."]
    batch = dict(max_mel_tokens=16, use_deterministic_seed=3, verbose=False)
    want = TextToSpeechFast(**fast_kw).tts_batch(texts, **batch)
    got = TextToSpeechFast(**fast_kw, mesh=mesh).tts_batch(texts, **batch)
    for i, (g, w) in enumerate(zip(got, want)):
        res[f"batch_mesh{i}"], res[f"batch_plain{i}"] = g.numpy(), w.numpy()

    res["local_batch"] = np.array(multihost.process_local_batch(256))
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    res["hybrid_shapes"] = np.array([multihost.hybrid_mesh(tp=tp, device_type="cpu").mesh.shape
                                     for tp in (1, 2)])
    try:
        multihost.hybrid_mesh(tp=4, device_type="cpu")
        res["hybrid_refused"] = np.array(False)
    except AssertionError:
        res["hybrid_refused"] = np.array(True)
    res.update(_bf16_train_steps(out))
    np.savez(os.path.join(out, f"api_{rank}.npz"), **res)

    # the CLI last: it ends the world
    full = api.TextToSpeech

    def tiny(**kwargs):
        for fixed in ("kv_cache_dtype", "enable_redaction", "device", "autoregressive_batch_size"):
            kwargs.pop(fixed)
        tts = _tiny_quality(full, autoregressive_batch_size=2, **kwargs)
        assert kwargs["mesh"] is not None and tts.mesh is kwargs["mesh"]
        quick = tts.tts_with_preset
        tts.tts_with_preset = lambda text, **kw: quick(
            text, **{**kw, "num_autoregressive_samples": 2, "diffusion_iterations": 2,
                     "max_mel_tokens": 16, "use_deterministic_seed": 0})
        return tts

    api.TextToSpeech = tiny
    try:
        assert cli.main(["--device", "cpu", "--mesh", "2", "--voice", "train_dotrice", "-q",
                         "--preset", "ultra_fast", "-o", os.path.join(out, f"main_{rank}.wav"),
                         "Hello from a world of two."]) == 0
    finally:
        api.TextToSpeech = full
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the test process: spawn the worlds, run the JAX side, compare
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _World:
    """``n`` processes of this file's worker running ``task``."""

    def __init__(self, task: str, n: int, out: str):
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
        self.task, self.deadline, self.result = task, time.monotonic() + WORKER_TIMEOUT, None
        self.procs = [subprocess.Popen([sys.executable, __file__, task, out], cwd=ROOT,
                                       env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for r in range(n)]

    def wait(self) -> None:
        """Fails the calling test when a rank fails or times out; the other
        ranks are killed then."""
        if self.result is not None:
            if self.result:
                pytest.fail(self.result)
            return
        self.result = ""
        for r, p in enumerate(self.procs):
            try:
                log, _ = p.communicate(timeout=max(1.0, self.deadline - time.monotonic()))
                bad = p.returncode != 0 and f"{self.task} rank {r} exited {p.returncode}"
            except subprocess.TimeoutExpired:
                log, bad = "", f"{self.task} rank {r} timed out after {WORKER_TIMEOUT} s"
            if bad:
                for q in self.procs:
                    q.kill()
                self.result = f"{bad}:\n{log[-6000:]}"
                pytest.fail(self.result)


def _jax_params(init_fn, seed):
    from tortoise_tpu import weights as jax_weights

    return jax_weights.host_init(init_fn, seed=seed)["params"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX models and weights, the inputs, and both worlds started."""
    import jax
    import jax.numpy as jnp

    from tortoise_tpu.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu.models.autoregressive import init_unified_voice
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu.models.diffusion_decoder import (DiffusionTts, DiffusionTtsConfig,
                                                       init_diffusion_tts)
    from tortoise_tpu_torch.convert.from_jax import from_jax
    from tortoise_tpu_torch.models import autoregressive as pa
    from tortoise_tpu_torch.models import clvp as pc
    from tortoise_tpu_torch.models import diffusion_decoder as pd

    out = str(tmp_path_factory.mktemp("worlds"))
    rng = np.random.default_rng(0)
    inp = {"cond": rng.standard_normal((1, 128)).astype(np.float32),
           "text": np.pad(rng.integers(3, 250, (1, 9)), ((0, 0), (0, 1)))}
    jm = UnifiedVoice(UnifiedVoiceConfig(**UV))
    uv = _jax_params(lambda: init_unified_voice(jm, 0), 2)
    torch.save(from_jax(pa.UnifiedVoice(pa.UnifiedVoiceConfig(**UV)), uv),
               os.path.join(out, "uv.pt"))

    clvp = CLVP(CLVPConfig(**CLVP_KW))
    inp["clvp_text"] = rng.integers(0, 256, (1, 11))
    inp["cands"] = rng.integers(0, 8192, (16, 17))
    cp = _jax_params(lambda: clvp.init(jax.random.PRNGKey(3), jnp.asarray(inp["clvp_text"]),
                                       jnp.asarray(inp["cands"][:1])), 3)
    torch.save(from_jax(pc.CLVP(pc.CLVPConfig(**CLVP_KW)), cp), os.path.join(out, "clvp.pt"))

    dm = DiffusionTts(DiffusionTtsConfig(**DIFF_KW))
    dp_ = _jax_params(lambda: init_diffusion_tts(dm, jax.random.PRNGKey(4)), 4)
    torch.save(from_jax(pd.DiffusionTts(pd.DiffusionTtsConfig(**DIFF_KW)), dp_),
               os.path.join(out, "diff.pt"))
    k, s_bucket = 8, 8
    inp.update(out_bucket=np.array(8 * 4 * 24000 // 22050), ns=rng.integers(4, s_bucket + 1, (k,)),
               dlats=rng.standard_normal((k, s_bucket, 64)).astype(np.float32),
               dcond=rng.standard_normal((1, 128)).astype(np.float32),
               x=rng.standard_normal((k, 8 * 4 * 24000 // 22050, 100)).astype(np.float32),
               ts=np.full((k,), 600))
    # B=4 divides over dp=2; the last row's wav_length pads its codes past 6
    inp.update(train_cond_latent=(rng.standard_normal((4, 128)) * 3).astype(np.float32),
               train_text_tokens=rng.integers(1, 255, (4, 9)),
               train_mel_codes=rng.integers(0, 8192, (4, 14)),
               train_wav_lengths=np.array([14 * 1024] * 3 + [5 * 1024 + 100]))
    np.savez(os.path.join(out, "inputs.npz"), **inp)
    worlds = {"decode_train": _World("decode_train", 4, out), "api": _World("api", 2, out)}
    yield dict(out=out, inp=inp, jm=jm, uv=uv, clvp=clvp, clvp_params=cp, dm=dm,
               diff_params=dp_, worlds=worlds)
    for w in worlds.values():
        for p in w.procs:
            p.kill()


def _results(setup, task: str, rank: int = 0) -> dict:
    setup["worlds"][task].wait()
    return dict(np.load(os.path.join(setup["out"], f"{task}_{rank}.npz")))


# --- in this process ----------------------------------------------------

@pytest.mark.parametrize("seed", [3, 5, 11])
@pytest.mark.parametrize("shape", [(8, 50), (3, 8194), (16, 50)])
def test_categorical_draws_what_multinomial_draws(seed, shape):
    """The explicit exponential draw gives today's torch.multinomial draw
    and leaves the generator where multinomial leaves it; a dp shard's rows
    of the global draw are the unsplit draw's rows."""
    from tortoise_tpu_torch.ops.sampling import categorical
    from tortoise_tpu_torch.parallel.mesh import BatchShard

    logits = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 3
    g1, g2 = torch.Generator().manual_seed(seed + 100), torch.Generator().manual_seed(seed + 100)
    want = torch.multinomial(torch.softmax(logits, -1), 1, generator=g1)[:, 0]
    torch.testing.assert_close(categorical(g2, logits), want, rtol=0, atol=0)
    assert torch.equal(g1.get_state(), g2.get_state())
    if shape[0] % 2 == 0:
        for index in (0, 1):
            shard = BatchShard(index, 2, None)
            rows = shard.rows(shape[0])
            got = categorical(torch.Generator().manual_seed(seed + 100), logits[rows], shard)
            torch.testing.assert_close(got, want[rows], rtol=0, atol=0)


@pytest.mark.parametrize("seed", [3, 5, 11])
@pytest.mark.parametrize("shape", [(8, 50), (3, 8194)])
def test_categorical_bf16_draws_what_multinomial_draws(seed, shape):
    """bf16 logits: torch.multinomial draws its exponentials in the
    probabilities' dtype, and so does categorical."""
    from tortoise_tpu_torch.ops.sampling import categorical

    logits = (torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 3).bfloat16()
    g1, g2 = torch.Generator().manual_seed(seed + 100), torch.Generator().manual_seed(seed + 100)
    want = torch.multinomial(torch.softmax(logits, -1), 1, generator=g1)[:, 0]
    torch.testing.assert_close(categorical(g2, logits), want, rtol=0, atol=0)
    assert torch.equal(g1.get_state(), g2.get_state())


class _Mesh:
    """Stands in for a DeviceMesh where only the tp axis is read."""

    def __init__(self, tp, rank, dp=1):
        self.sizes, self.rank = {"tp": tp, "dp": dp}, rank

    def __getitem__(self, axis):
        size = self.sizes[axis]
        return type("Axis", (), {"size": lambda self: size})()

    def get_local_rank(self, axis):
        return self.rank


def _jax_axis(spec, ndim):
    """The port axis of the "tp" entry of a JAX spec for a Dense kernel
    (..., in, out), which the port holds as (..., out, in)."""
    axes = [i for i, ax in enumerate(spec) if ax == "tp"]
    if not axes:
        return None
    a = axes[0]
    return {ndim - 1: ndim - 2, ndim - 2: ndim - 1}.get(a, a)


def test_pspec_splits_every_leaf_as_the_jax_rule():
    """Every UnifiedVoice parameter splits on the axis the JAX rule splits it
    on, save the stated differences: the column-split products' biases split
    with them, and the conditioning encoder's qkv stays whole."""
    import jax

    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)
    from tortoise_tpu.parallel.sharding import unified_voice_pspec as jax_pspec
    from tortoise_tpu_torch.models import autoregressive as pa
    from tortoise_tpu_torch.parallel.sharding import unified_voice_pspec

    jm = UnifiedVoice(UnifiedVoiceConfig(**UV))
    params = _jax_params(lambda: init_unified_voice(jm, 0), 2)
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): (path, leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(params)[0]}
    leaf_of = {"weight": ("kernel", "scale", "embedding"), "bias": ("bias",)}
    differ = set()
    for name, p in pa.UnifiedVoice(pa.UnifiedVoiceConfig(**UV)).named_parameters():
        *mod, leaf = name.split(".")
        key = next(f"{'/'.join(mod)}/{j}" for j in leaf_of.get(leaf, (leaf,))
                   if f"{'/'.join(mod)}/{j}" in flat)
        path, jleaf = flat[key]
        want = _jax_axis(jax_pspec(path, jleaf), jleaf.ndim) if key.endswith("kernel") and \
            jleaf.ndim >= 2 and "conditioning_encoder" not in key else \
            (None if "tp" not in jax_pspec(path, jleaf) else "split")
        if unified_voice_pspec(name, p) != want:
            differ.add(name)
    assert differ == {"gpt.h_scan.block.attn.c_attn.bias", "gpt.h_scan.block.mlp_fc.bias",
                      "mel_head.bias", "text_head.bias"} | {
        n for n, _ in pa.UnifiedVoice(pa.UnifiedVoiceConfig(**UV)).named_parameters()
        if n.startswith("conditioning_encoder") and "qkv" in n and n.endswith("weight")}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_splits_qkv_by_heads(tp):
    """Rank r's c_attn holds its heads of each of q, k and v (not a
    contiguous third of q|k|v); the other splits are contiguous; splits
    that do not divide are dropped (mel_head's 8194 codes over tp=4)."""
    from tortoise_tpu_torch.models import autoregressive as pa
    from tortoise_tpu_torch.parallel.sharding import shard_params

    model = pa.UnifiedVoice(pa.UnifiedVoiceConfig(**UV))
    sd = {n: torch.randn(p.shape) for n, p in model.named_parameters()}
    c, dh = UV["model_dim"], UV["model_dim"] // UV["heads"]
    qkv = sd["gpt.h_scan.block.attn.c_attn.weight"]             # (L, 3C, C)
    parts = [shard_params(sd, _Mesh(tp, r), UV["heads"]) for r in range(tp)]
    for r, part in enumerate(parts):
        local = part["gpt.h_scan.block.attn.c_attn.weight"]
        heads = slice(r * c // tp, (r + 1) * c // tp)
        for j in range(3):
            torch.testing.assert_close(local[:, j * c // tp:(j + 1) * c // tp],
                                       qkv[:, j * c:(j + 1) * c][:, heads], rtol=0, atol=0)
        assert (c // tp) % dh == 0
        torch.testing.assert_close(part["gpt.h_scan.block.mlp_proj.weight"],
                                   sd["gpt.h_scan.block.mlp_proj.weight"].chunk(tp, 2)[r])
        assert part["text_head.weight"].shape[0] == 256 // tp
        assert part["mel_head.weight"].shape[0] == (8194 // 2 if tp == 2 else 8194)
        assert part["gpt.h_scan.block.attn.c_proj.bias"] is sd[
            "gpt.h_scan.block.attn.c_proj.bias"]
    # whole heads only: a GPT of 3 heads stays whole over tp=2
    three = shard_params(sd, _Mesh(2, 1), heads=3)
    assert three["gpt.h_scan.block.attn.c_attn.weight"] is qkv


def test_kv_cache_sharding_local_shape():
    from tortoise_tpu_torch.models.gpt2 import GPT2Config, init_kv_cache
    from tortoise_tpu_torch.parallel.sharding import KVCacheSharding

    sharding = KVCacheSharding(_Mesh(tp=2, rank=0, dp=4))
    assert sharding.spec("k") == sharding.spec("v") == (None, "dp", None, "tp")
    assert sharding.local_shape("k", (30, 16, 768, 1024)) == (30, 4, 768, 512)
    assert sharding.local_shape("k_scale", (30, 16, 16, 768)) == (30, 4, 8, 768)
    cache = init_kv_cache(GPT2Config(n_layer=2, n_embd=128, n_head=4), 8, 256, torch.int8,
                          sharding=sharding)
    assert cache["k"].shape == (2, 2, 256, 64) and cache["v_scale"].shape == (2, 2, 2, 256)


def test_multihost_single_process(monkeypatch):
    """tests/test_multihost.py's unit checks: nothing set, nothing to join;
    the hybrid layout keeps each tp group on one host and refuses a tp that
    does not divide a host's ranks; one process takes the whole batch."""
    import torch.distributed as dist

    from tortoise_tpu_torch.parallel import multihost

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize(device_type="cpu") is False and not dist.is_initialized()
    with pytest.raises(ValueError, match="world size"):
        multihost.initialize("localhost:1", device_type="cpu")
    layout = multihost.hybrid_layout(world=16, local=4, tp=2)      # 4 hosts x 4 ranks
    assert layout.shape == (8, 2)
    assert all(len({r // 4 for r in row}) == 1 for row in layout)
    assert {r // 4 for r in layout[:, 0]} == {0, 1, 2, 3}
    np.testing.assert_array_equal(multihost.hybrid_layout(8, 8, 2), np.arange(8).reshape(4, 2))
    with pytest.raises(AssertionError):
        multihost.hybrid_layout(world=8, local=2, tp=4)
    assert multihost.process_local_batch(256) == 256


# --- the world of four --------------------------------------------------

def test_sampled_dp4_decode_is_token_exact(setup):
    res = _results(setup, "decode_train")
    np.testing.assert_array_equal(res["dp4_codes"], res["base8_codes"])
    np.testing.assert_allclose(res["dp4_lats"], res["base8_lats"], rtol=LATENT_TOL,
                               atol=LATENT_TOL)


@pytest.mark.parametrize("n", [4, 8])
def test_sampled_dp2_tp2_decode_matches_unsharded(setup, n):
    res = _results(setup, "decode_train")
    assert res["replicated"] and int(res["local_heads"]) == UV["heads"] // 2
    np.testing.assert_array_equal(res[f"dp2tp2_{n}_codes"], res[f"base{n}_codes"])
    np.testing.assert_allclose(res[f"dp2tp2_{n}_lats"], res[f"base{n}_lats"], rtol=LATENT_TOL,
                               atol=LATENT_TOL)
    for r in (1, 2, 3):
        np.testing.assert_array_equal(_results(setup, "decode_train", r)[f"dp2tp2_{n}_codes"],
                                      res[f"dp2tp2_{n}_codes"])


def test_greedy_dp2_tp2_decode_matches_jax_dp4_tp2(setup):
    import jax
    import jax.numpy as jnp

    from tortoise_tpu.models.ar_sampler import SamplerSettings, sample_speech
    from tortoise_tpu.parallel.mesh import batch_sharding, make_mesh
    from tortoise_tpu.parallel.sharding import kv_cache_sharding, shard_params

    mesh = make_mesh(dp=4, tp=2)
    variables = {"params": shard_params(setup["uv"], mesh)}
    with mesh:
        codes, lats = sample_speech(
            setup["jm"], variables, jnp.asarray(setup["inp"]["cond"]),
            jnp.asarray(setup["inp"]["text"], jnp.int32), jax.random.PRNGKey(5), num_samples=4,
            settings=SamplerSettings(do_sample=False, max_generate=MAX_GENERATE),
            cache_dtype=jnp.float32, batch_sharding=batch_sharding(mesh),
            cache_sharding=kv_cache_sharding(mesh))
    res = _results(setup, "decode_train")
    np.testing.assert_array_equal(res["greedy_codes"], np.asarray(codes))
    np.testing.assert_allclose(res["greedy_lats"], np.asarray(lats), rtol=LATENT_TOL,
                               atol=LATENT_TOL)


def test_clvp_scores_over_dp_match_jax(setup):
    import jax
    import jax.numpy as jnp

    from tortoise_tpu.models.clvp import CLVP
    from tortoise_tpu.parallel.mesh import batch_sharding, make_mesh

    clvp, inp = setup["clvp"], setup["inp"]
    mesh = make_mesh(dp=8, tp=1)
    with mesh:
        want = np.asarray(jax.jit(lambda v, t, c: clvp.apply(v, t, c, method=CLVP.score_candidates))(
            {"params": setup["clvp_params"]}, jnp.asarray(inp["clvp_text"], jnp.int32),
            jax.device_put(jnp.asarray(inp["cands"], jnp.int32), batch_sharding(mesh))))
    np.testing.assert_allclose(_results(setup, "decode_train")["clvp_sharded"], want,
                               rtol=1e-5, atol=1e-5)


def test_diffusion_fanout_step_over_dp_matches_jax(setup):
    import jax
    import jax.numpy as jnp

    from tortoise_tpu.models.diffusion_decoder import DiffusionTts
    from tortoise_tpu.parallel.mesh import batch_sharding, make_mesh

    m, inp = setup["dm"], setup["inp"]
    ns = jnp.asarray(inp["ns"], jnp.int32)
    out_lens = ns * 4 * 24000 // 22050
    out_bucket = int(inp["out_bucket"])

    @jax.jit
    def step(v, la, xx):
        pre = m.apply(v, la, ns, jnp.asarray(inp["dcond"]), out_lens, out_bucket,
                      method=DiffusionTts.timestep_independent_bucketed)
        return m.apply(v, xx, jnp.asarray(inp["ts"], jnp.int32),
                       precomputed_aligned_embeddings=pre, valid_len=out_lens)

    mesh = make_mesh(dp=8, tp=1)
    with mesh:
        want = np.asarray(step({"params": setup["diff_params"]},
                               jax.device_put(jnp.asarray(inp["dlats"]), batch_sharding(mesh)),
                               jax.device_put(jnp.asarray(inp["x"]), batch_sharding(mesh))))
    np.testing.assert_allclose(_results(setup, "decode_train")["diff_sharded"], want,
                               rtol=DIFF_TOL, atol=DIFF_TOL)


def test_train_step_dp2_tp2_matches_jax(setup):
    """Two steps (warmup 1: the first at lr 0) of the dp=2 x tp=2 port
    against the unsharded JAX train step: loss, its terms and grad_norm at
    every step, every parameter after them, split leaves gathered."""
    import jax.numpy as jnp

    from tortoise_tpu.training import train_step as jts
    from tortoise_tpu_torch.convert.from_jax import from_jax
    from tortoise_tpu_torch.models import autoregressive as pa

    inp = setup["inp"]
    batch = {k[6:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("train_")}
    opt = jts.make_optimizer(lr=LR, warmup=WARMUP)
    step = jts.make_train_step(setup["jm"], opt)
    state = jts.TrainState(setup["uv"], opt.init(setup["uv"]), jnp.zeros((), jnp.int32))
    res = _results(setup, "decode_train")
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        assert float(metrics["grad_norm"]) > 1.0
        for k in ("loss", "loss_text", "loss_mel", "grad_norm"):
            np.testing.assert_allclose(res[f"train{i}_{k}"], np.asarray(metrics[k]),
                                       rtol=LOSS_RTOL, atol=0, err_msg=f"step {i} {k}")
    want = from_jax(pa.UnifiedVoice(pa.UnifiedVoiceConfig(**UV)), state.params)
    lr_sum = LR * (TRAIN_STEPS - 1)
    d = np.concatenate([np.abs(res[f"param:{n}"] - w.numpy()).ravel() for n, w in want.items()])
    assert d.max() <= 2 * lr_sum, d.max()
    assert (d > PARAM_NEAR_FRAC * lr_sum).mean() <= PARAM_FAR_SHARE
    moved = max(np.abs(res[f"param:{n}"] - w.numpy()).max() for n, w in
                torch.load(os.path.join(setup["out"], "uv.pt")).items())
    assert moved > 10 * d.max()


# --- the world of two ---------------------------------------------------

@pytest.mark.parametrize("split", ["tp2", "dp2"])
def test_bf16_train_step_over_the_mesh_matches_unsplit(setup, split):
    """The bf16 UnifiedVoice's train steps over tp=2 and over dp=2 against
    the unsplit bf16 steps: loss and grad_norm at every step to
    BF16_TRAIN_RTOL; the split parameters, the gradients and the moments
    stay float32."""
    from tortoise_tpu_torch.models import autoregressive as pa
    from tortoise_tpu_torch.training import train_step as ts

    model = pa.UnifiedVoice(pa.UnifiedVoiceConfig(**UV), dtype=torch.bfloat16)
    model.load_state_dict(torch.load(os.path.join(setup["out"], "uv.pt")))
    opt = ts.make_optimizer(lr=LR, warmup=WARMUP)
    state, step = ts.init_train_state(model, opt), ts.make_train_step(model, opt)
    batch = {k[6:]: torch.from_numpy(v) for k, v in setup["inp"].items()
             if k.startswith("train_")}
    res = _results(setup, "api")
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[f"bf16_{split}_train{i}_{k}"], float(metrics[k]),
                                       rtol=BF16_TRAIN_RTOL, atol=0, err_msg=f"step {i} {k}")
    assert bool(res[f"bf16_{split}_float32"])
    split_names = set(res[f"bf16_{split}_split"].tolist())
    assert ("gpt.h_scan.block.attn.c_attn.weight" in split_names) == (split == "tp2")


@pytest.mark.parametrize("k", [1, 2])
def test_tts_over_dp_matches_unsharded(setup, k):
    """The quality API over dp=2: the candidates' codes equal the unsharded
    request's and every rank returns the same audio. With k=1 the winner's
    diffusion is unsplit and the audio is the unsharded request's. With
    k=2 the winners diffuse as one batch over dp, a different draw from the
    unsharded request's loop over winners. Its mels are held to the same
    winners diffused as one unsplit batch from the same generator state,
    to the fan-out step's tolerance for each of the request's
    API_DIFF_STEPS steps; the generator leaves both in one
    state, and each wav is the vocoder's over its winner's mel from that
    state. The wav is held through its mel: the seeded random UnivNet is
    chaotic, a change of 1e-4 to a mel changes its wav at full scale."""
    from tortoise_tpu_torch.ops.mel import TACOTRON_MEL_MAX, TACOTRON_MEL_MIN

    res, other = _results(setup, "api"), _results(setup, "api", 1)
    np.testing.assert_array_equal(res[f"k{k}_mesh_codes"], res[f"k{k}_plain_codes"])
    for i in range(k):
        wav = res[f"k{k}_mesh_wav{i}"]
        assert wav.ndim == 3 and wav.shape[:2] == (1, 1) and np.isfinite(wav).all()
        assert wav.shape == res[f"k{k}_plain_wav{i}"].shape
        np.testing.assert_array_equal(wav, other[f"k{k}_mesh_wav{i}"])
        want = res[f"k1_plain_wav{i}" if k == 1 else f"k2_vocoded_wav{i}"]
        np.testing.assert_allclose(wav, want, rtol=0, atol=1e-5)
    if k == 2:
        assert bool(res["k2_fanout_gen_equal"])
        np.testing.assert_allclose(res["k2_fanout_mels_mesh"], res["k2_fanout_mels_plain"],
                                   rtol=0, atol=API_DIFF_STEPS * DIFF_TOL
                                   * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) / 2)


def test_diffusion_fanout_over_dp_matches_the_unsplit_batch(setup):
    """Two winners of unequal length, one a rank, against the two in one
    batch from the same seed: the fan-out step's tolerance (one row a model
    call against two reorders float32 sums), in the denormalised mel's
    units, (max - min) / 2 of the normalised ones."""
    from tortoise_tpu_torch.ops.mel import TACOTRON_MEL_MAX, TACOTRON_MEL_MIN

    res = _results(setup, "api")
    assert res["fanout_mesh"].shape == res["fanout_plain"].shape
    np.testing.assert_allclose(res["fanout_mesh"], res["fanout_plain"], rtol=0,
                               atol=DIFF_TOL * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) / 2)


def test_tts_batch_over_dp_matches_unsharded(setup):
    res, other = _results(setup, "api"), _results(setup, "api", 1)
    for i in range(4):
        got, want = res[f"batch_mesh{i}"], res[f"batch_plain{i}"]
        assert got.shape == want.shape and got.shape[:2] == (1, 1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got, other[f"batch_mesh{i}"])


def test_multihost_in_a_world_of_two(setup):
    res = _results(setup, "api")
    assert int(res["local_batch"]) == 128
    np.testing.assert_array_equal(res["hybrid_shapes"], [[2, 1], [1, 2]])
    assert bool(res["hybrid_refused"])


def test_main_over_a_mesh_writes_one_wav(setup):
    """apps.main --mesh 2 in the world of two: rank 0 writes the wav."""
    from scipy.io.wavfile import read as wav_read

    setup["worlds"]["api"].wait()
    sr, wav = wav_read(os.path.join(setup["out"], "main_0.wav"))
    assert sr == 24000 and wav.size > 0 and np.isfinite(wav).all()
    assert not os.path.exists(os.path.join(setup["out"], "main_1.wav"))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    {"decode_train": world_decode_train, "api": world_api}[sys.argv[1]](sys.argv[2])
