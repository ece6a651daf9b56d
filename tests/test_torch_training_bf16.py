"""The port's mixed-precision training against the JAX package's on the CPU:
UnifiedVoice, DiffusionTts, CLVP and CVVP built with ``dtype=bfloat16``
over float32 parameters, against the JAX models at ``dtype=jnp.bfloat16``
with the same parameters (carried by convert/from_jax.py): each loss and
every gradient leaf, three steps of the train step, what stays float32 and
what computes in bf16, and GPT2Stack's remat. The sizes and inputs are
tests/test_torch_training.py's.

The JAX side is compiled with XLA's ``xla_allow_excess_precision`` off, so
that it rounds to bf16 wherever the model's program says (by default XLA
may keep float32 inside a fusion, which an eager op of the port cannot do:
the x-transformer encoder's bf16 output then parts by 0.6% of its max; with
the option off the two are equal bit for bit), and with its bf16 sums in
float32, as the port's are (``_float32_sums``). Both sides then round at
the same places but sum in other orders, so a bf16 rounding differs here
and there and the differences carry through the layers: losses to
LOSS_RTOL relative, each gradient leaf to GRAD_FRAC of its max |grad|,
DIFF_GRAD_FRAC for DiffusionTts (chip_smoke's bound for bf16 logits).
Read: 0.0067 (UnifiedVoice), 0.0065 and 0.0060 (CLVP, both encoders),
0.0077 (CVVP), 0.018 (DiffusionTts). Remat is float32: bit for bit against
no remat, and against JAX to the float32 tolerances."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)
LOSS_RTOL = 5e-3
GRAD_FRAC = 2.0 ** -6
DIFF_GRAD_FRAC = 2.0 ** -5
# tests/test_torch_training.py's float32 tolerances, for remat
F32_LOSS_RTOL, F32_GRAD_FRAC = 1e-5, 1e-4
# Parameters after three steps: every element within 2 lr of the sum of the
# steps' lrs (Adam's m / sqrt(v) makes a gradient at rounding level an update
# of +-lr, tests/test_torch_training.py), all but PARAM_FAR_SHARE of them
# within PARAM_NEAR_FRAC of it. In bf16 more gradients sit at rounding level
# than in float32: 3.5e-4 of UnifiedVoice's 3.0M elements read beyond half
# the lr sum (9.5e-4 beyond 0.1 of it), the largest 0.0030 for 0.0015
PARAM_NEAR_FRAC, PARAM_FAR_SHARE = 0.5, 1e-3
UV = dict(layers=2, model_dim=128, heads=4, max_text_tokens=40, max_mel_tokens=48)
DIFF = dict(model_channels=64, num_layers=2, in_latent_channels=32, num_heads=2)
CLVP_KW = dict(dim_text=64, dim_speech=64, dim_latent=64, text_enc_depth=2, text_heads=2,
               speech_enc_depth=2, speech_heads=2)
CVVP_KW = dict(model_dim=64, transformer_heads=4, conditioning_enc_depth=2, speech_enc_depth=2)
SCHEDULE_STEPS = 50
BF16, JBF16 = torch.bfloat16, jnp.bfloat16
EXACT_BF16 = {"xla_allow_excess_precision": False}


@contextlib.contextmanager
def _float32_sums():
    """While tracing: ``lax.reduce_sum`` of a bf16 operand sums in float32
    and rounds once, as the port's sums do. Unpatched, the transposes of
    jax.grad (a bias's broadcast, for one) add bf16 terms in bf16 on the
    CPU: CVVP's post_conv bias gradient then lies 5.3% of its max from the
    float32 gradient, the port's 1.2%."""
    from jax._src.lax import lax as lax_internal

    prim = lax_internal.reduce_sum_p
    bind = prim.bind

    def f32_bind(x, **params):
        if x.dtype != jnp.bfloat16:
            return bind(x, **params)
        return bind(x.astype(jnp.float32), **params).astype(jnp.bfloat16)

    prim.bind = f32_bind
    try:
        yield
    finally:
        prim.bind = bind


def _exact(fn):
    """``fn`` jitted to round to bf16 wherever its program says and to sum
    bf16 values in float32 (``_float32_sums``), traced at its first call."""
    jitted = jax.jit(fn, compiler_options=EXACT_BF16)

    def run(*args):
        with _float32_sums():
            return jitted(*args)
    return run


def _params(init_fn, seed):
    return jax_weights.host_init(init_fn, seed=seed)["params"]


def _load(port, params):
    port.load_state_dict(from_jax(port, params))
    return port


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _loss_close(got, want, rtol=LOSS_RTOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want, np.float32),
                               rtol=rtol, atol=0)


def _grads_close(port, jgrads, frac=GRAD_FRAC):
    """Every port gradient (float32, as its parameter) against JAX's, leaf
    by leaf, to ``frac`` of the leaf's max |grad|. A parameter the loss
    does not reach has no port gradient and an all-zero JAX one."""
    want = from_jax(port, jgrads)
    for name, p in port.named_parameters():
        w = want[name].float().numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        assert p.dtype == p.grad.dtype == torch.float32, name
        err = float(np.abs(p.grad.numpy() - w).max() / np.abs(w).max())
        assert err <= frac, (name, err)


# --- UnifiedVoice --------------------------------------------------------

@pytest.fixture(scope="module")
def voice_params():
    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)

    return _params(lambda: init_unified_voice(UnifiedVoice(UnifiedVoiceConfig(**UV)), 0), 2)


def _voice_models(params, dtype, jdtype):
    from tortoise_tpu.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice as PV
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig as PC

    return (UnifiedVoice(UnifiedVoiceConfig(**UV), dtype=jdtype),
            _load(PV(PC(**UV), dtype=dtype), params))


def _voice_batch(seed):
    """B=2; the second row's wav_length pads its mel codes past position 7
    with the stop token."""
    rng = np.random.default_rng(seed)
    return {"cond_latent": (rng.standard_normal((2, 128)) * 3).astype(np.float32),
            "text_tokens": rng.integers(1, 255, (2, 9)),
            "mel_codes": rng.integers(0, 8192, (2, 14)),
            "wav_lengths": np.array([14 * 1024, 6 * 1024 + 100])}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: _t(v, torch.float32 if v.dtype == np.float32 else torch.long)
            for k, v in b.items()}


def _voice_loss_and_grads(jm, params, port, batch):
    from tortoise_tpu.training import train_step as jts
    from tortoise_tpu_torch.training import train_step as pts

    (jloss, jaux), jgrads = _exact(jax.value_and_grad(
        lambda p: jts.unified_voice_loss(jm, p, _jax_batch(batch)), has_aux=True))(params)
    for p in port.parameters():
        p.grad = None
    loss, aux = pts.unified_voice_loss(port, _port_batch(batch))
    loss.backward()
    return (loss, aux), (jloss, jaux), jgrads


def test_unified_voice_bf16_loss_and_gradients(voice_params):
    jm, port = _voice_models(voice_params, BF16, JBF16)
    (loss, aux), (jloss, jaux), jgrads = _voice_loss_and_grads(jm, voice_params, port,
                                                               _voice_batch(0))
    _loss_close(loss, jloss)
    for k in ("loss_text", "loss_mel"):
        _loss_close(aux[k], jaux[k])
    _grads_close(port, jgrads)


def test_unified_voice_bf16_computes_in_bf16(voice_params):
    """The mel logits and a GPT block's output are bf16, the embedding sum
    the stack takes is float32 (the tables are), and the conditioning
    encoder computes in bf16 as the JAX model's does."""
    from tortoise_tpu.models.autoregressive import UnifiedVoice

    jm, port = _voice_models(voice_params, BF16, JBF16)
    batch = _port_batch(_voice_batch(0))
    seen = {}

    def hook(name):     # returns None: the output stays
        return lambda m, i, o: seen.update({f"{name}_in": i[0].dtype,
                                            f"{name}_out": (o[0] if name == "gpt" else o).dtype})

    port.gpt.h_scan.block.mlp_fc.register_forward_hook(hook("mlp_fc"))
    port.gpt.register_forward_hook(hook("gpt"))
    with torch.no_grad():
        text_logits, mel_logits = port(batch["cond_latent"], batch["text_tokens"],
                                       batch["mel_codes"], batch["wav_lengths"],
                                       return_logits=True)
        *_, loss_mel_logits = port(batch["cond_latent"], batch["text_tokens"],
                                   batch["mel_codes"], batch["wav_lengths"])
    assert mel_logits.dtype == text_logits.dtype == loss_mel_logits.dtype == BF16
    assert seen == {"mlp_fc_in": BF16, "mlp_fc_out": BF16, "gpt_in": torch.float32,
                    "gpt_out": BF16}
    mels = _x(3, 2, 2, 40, 80)
    want = _exact(lambda p, m: jm.apply({"params": p}, m, method=UnifiedVoice.get_conditioning))(
        voice_params, jnp.asarray(mels))
    with torch.no_grad():
        got = port.get_conditioning(_t(mels))
    assert want.dtype == JBF16 and got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=GRAD_FRAC * float(jnp.abs(want).max()))


def test_unified_voice_bf16_train_step_matches_jax(voice_params):
    """Three steps, warmup 2 and lr 1e-3, the bf16 models: each step's loss
    and grad_norm, the parameters after them within 2 lr (the float32
    test's rule), and every parameter, gradient and Adam moment float32."""
    from tortoise_tpu.training import train_step as jts
    from tortoise_tpu_torch.training import train_step as pts

    jm, port = _voice_models(voice_params, BF16, JBF16)
    batch = _voice_batch(1)
    jopt = jts.make_optimizer(lr=1e-3, warmup=2)
    jstate = jts.TrainState(voice_params, jopt.init(voice_params), jnp.zeros((), jnp.int32))
    with _float32_sums():
        jstep = jts.make_train_step(jm, jopt).lower(jstate, _jax_batch(batch)).compile(EXACT_BF16)
    popt = pts.make_optimizer(lr=1e-3, warmup=2)
    pstep = pts.make_train_step(port, popt)
    pstate = pts.init_train_state(port, popt)
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    lr_sum = 0.0
    for i in range(3):
        lr_sum += popt.learning_rate(i)
        jstate, jmet = jstep(jstate, _jax_batch(batch))
        pstate, pmet = pstep(pstate, _port_batch(batch))
        for k in ("loss", "loss_text", "loss_mel", "grad_norm"):
            _loss_close(pmet[k], jmet[k])
    want = from_jax(port, jstate.params)
    d = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in port.named_parameters()])
    assert float(d.max()) <= 2 * lr_sum, float(d.max())
    assert float((d > PARAM_NEAR_FRAC * lr_sum).float().mean()) <= PARAM_FAR_SHARE
    # the steps moved the parameters by far more than they differ
    moved = torch.cat([(port.state_dict()[k] - v).abs().flatten() for k, v in before.items()])
    assert float(moved.mean()) > 100 * float(d.mean())
    tensors = ([p for p in port.parameters()] + pstate.opt_state["mu"]
               + pstate.opt_state["nu"])
    assert all(t.dtype == torch.float32 for t in tensors)
    # a backward leaves float32 gradients on the float32 parameters
    loss, _ = pts.unified_voice_loss(port, _port_batch(batch))
    loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in port.parameters() if p.grad is not None)


# --- DiffusionTts, CLVP and CVVP -----------------------------------------

def _schedules():
    from tortoise_tpu.diffusion.schedule import spaced_schedule as jsched
    from tortoise_tpu_torch.diffusion.schedule import spaced_schedule

    return jsched("linear", 4000, SCHEDULE_STEPS), spaced_schedule("linear", 4000,
                                                                   SCHEDULE_STEPS)


@pytest.fixture(scope="module")
def diffusion_params():
    from tortoise_tpu.models.diffusion_decoder import (DiffusionTts, DiffusionTtsConfig,
                                                       init_diffusion_tts)

    return _params(lambda: init_diffusion_tts(DiffusionTts(DiffusionTtsConfig(**DIFF)),
                                              jax.random.PRNGKey(0)), 8)


def _diffusion_models(params):
    from tortoise_tpu.models.diffusion_decoder import DiffusionTts, DiffusionTtsConfig
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts as PD
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig as PC

    return (DiffusionTts(DiffusionTtsConfig(**DIFF), dtype=JBF16),
            _load(PD(PC(**DIFF), dtype=BF16), params))


def test_diffusion_bf16_training_losses_and_gradients(diffusion_params):
    """training_losses over the bf16 DiffusionTts conditioned on AR latents
    (the unbucketed model call), mean over the batch, and every gradient;
    the model's output (out_conv) is float32."""
    from tortoise_tpu.diffusion.losses import training_losses as jlosses
    from tortoise_tpu_torch.diffusion.losses import training_losses

    jm, port = _diffusion_models(diffusion_params)
    js, ps = _schedules()
    x_start = np.tanh(_x(5, 2, 24, 100))
    noise, lat, cond = _x(6, 2, 24, 100), _x(7, 2, 6, 32), _x(8, 2, 128)
    t = np.array([0, 37])

    def jloss(p):
        fn = lambda x, tt: jm.apply({"params": p}, x, tt, aligned_conditioning=jnp.asarray(lat),
                                    conditioning_latent=jnp.asarray(cond))
        terms = jlosses(fn, js, jnp.asarray(x_start), jnp.asarray(t), noise=jnp.asarray(noise))
        return terms["loss"].mean(), terms

    (_, jterms), jgrads = _exact(jax.value_and_grad(jloss, has_aux=True))(diffusion_params)
    outs = []
    fn = lambda x, tt: outs.append(port(x, tt, aligned_conditioning=_t(lat),
                                        conditioning_latent=_t(cond))) or outs[-1]
    terms = training_losses(fn, ps, _t(x_start), _t(t, torch.long), noise=_t(noise))
    terms["loss"].mean().backward()
    assert outs[0].dtype == torch.float32
    for k in ("mse", "vb", "loss"):
        _loss_close(terms[k], jterms[k])
    _grads_close(port, jgrads, DIFF_GRAD_FRAC)


def test_diffusion_bf16_code_path(diffusion_params):
    """The discrete-code conditioning in bf16: timestep_independent's
    expansion and mel prediction, and the training loss over it. Its
    float32 stream (code_embedding, code_converter, the FiLM) sums in
    another order than JAX's, an ulp here and there, and the casts ahead of
    each product turn some into bf16 flips; JAX's own bf16 gradients of
    code_converter_{1,2}'s proj_out lie 7-11% of their max from its float32
    ones, so this path's gradients are not held leaf by leaf."""
    from tortoise_tpu.diffusion.losses import training_losses as jlosses
    from tortoise_tpu.models.diffusion_decoder import DiffusionTts
    from tortoise_tpu_torch.diffusion.losses import training_losses

    jm, port = _diffusion_models(diffusion_params)
    codes, cond = np.random.default_rng(9).integers(0, 8193, (2, 6)), _x(8, 2, 128)
    jexp, jpred = _exact(lambda p, a, c: jm.apply(
        {"params": p}, a, c, 24, return_code_pred=True,
        method=DiffusionTts.timestep_independent))(diffusion_params, jnp.asarray(codes),
                                                   jnp.asarray(cond))
    with torch.no_grad():
        exp, pred = port.timestep_independent(_t(codes, torch.long), _t(cond), 24,
                                              return_code_pred=True)
    assert exp.dtype == torch.float32 and pred.dtype == BF16 and jpred.dtype == JBF16
    for got, want in ((exp, jexp), (pred, jpred)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=DIFF_GRAD_FRAC * float(jnp.abs(want).max()))
    js, ps = _schedules()
    x_start, noise, t = np.tanh(_x(5, 2, 24, 100)), _x(6, 2, 24, 100), np.array([0, 37])
    jterms = _exact(lambda p: jlosses(
        lambda x, tt: jm.apply({"params": p}, x, tt, aligned_conditioning=jnp.asarray(codes),
                               conditioning_latent=jnp.asarray(cond)),
        js, jnp.asarray(x_start), jnp.asarray(t), noise=jnp.asarray(noise)))(diffusion_params)
    fn = lambda x, tt: port(x, tt, aligned_conditioning=_t(codes, torch.long),
                            conditioning_latent=_t(cond))
    terms = training_losses(fn, ps, _t(x_start), _t(t, torch.long), noise=_t(noise))
    terms["loss"].mean().backward()
    for k in ("mse", "vb", "loss"):
        _loss_close(terms[k], jterms[k])
    code_grads = [p.grad for n, p in port.named_parameters() if n.startswith("code_converter")]
    assert code_grads and all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                              for g in code_grads)


def test_diffusion_bf16_forward_conditioning_free(diffusion_params):
    """The unconditioned embedding rounds to bf16 as the JAX model's does."""
    jm, port = _diffusion_models(diffusion_params)
    x, steps = _x(13, 2, 20, 100), np.array([3, 2500])
    want = _exact(lambda p, xx, tt: jm.apply({"params": p}, xx, tt, conditioning_free=True))(
        diffusion_params, jnp.asarray(x), jnp.asarray(steps))
    with torch.no_grad():
        got = port(_t(x), _t(steps, torch.long), conditioning_free=True)
    assert got.dtype == torch.float32 and port.dtype == BF16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=DIFF_GRAD_FRAC * float(jnp.abs(want).max()))


def _masks(seed, b, t):
    """Random keep masks with each row's first position kept."""
    m = np.random.default_rng(seed).random((b, t)) > 0.3
    m[:, 0] = True
    return m


@pytest.mark.parametrize("use_xformers", [True, False], ids=["xformers", "plain"])
def test_clvp_bf16_loss_and_gradients(use_xformers):
    """The contrastive loss with token-dropout masks, the x-transformers
    encoders and the plain-Transformer variant."""
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.clvp import CLVP as P
    from tortoise_tpu_torch.models.clvp import CLVPConfig as PC

    kw = dict(CLVP_KW, use_xformers=use_xformers, text_seq_len=16)
    init = CLVP(CLVPConfig(**kw))
    params = _params(lambda: init.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                       jnp.zeros((1, 4), jnp.int32)), 5)
    jm, port = CLVP(CLVPConfig(**kw), dtype=JBF16), _load(P(PC(**kw), dtype=BF16), params)
    rng = np.random.default_rng(15)
    text, speech = rng.integers(0, 256, (3, 10)), rng.integers(0, 8192, (3, 14))
    tm, vm = _masks(16, 3, 10), _masks(17, 3, 14)
    jl, jg = _exact(jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(text), jnp.asarray(speech), return_loss=True,
        text_mask=jnp.asarray(tm), voice_mask=jnp.asarray(vm))))(params)
    loss = port(_t(text, torch.long), _t(speech, torch.long), return_loss=True,
                text_mask=torch.from_numpy(tm), voice_mask=torch.from_numpy(vm))
    loss.backward()
    assert loss.dtype == torch.float32
    _loss_close(loss, jl)
    _grads_close(port, jg)


def test_cvvp_bf16_loss_and_gradients():
    from tortoise_tpu.models.cvvp import CVVP, CVVPConfig
    from tortoise_tpu_torch.models.cvvp import CVVP as P
    from tortoise_tpu_torch.models.cvvp import CVVPConfig as PC

    mel_cond = _x(18, 3, 40, 80)
    codes = np.random.default_rng(19).integers(0, 8192, (3, 14))
    init = CVVP(CVVPConfig(**CVVP_KW))
    params = _params(lambda: init.init(jax.random.PRNGKey(0), jnp.asarray(mel_cond),
                                       jnp.asarray(codes)), 6)
    jm, port = CVVP(CVVPConfig(**CVVP_KW), dtype=JBF16), _load(P(PC(**CVVP_KW), dtype=BF16),
                                                                params)
    jl, jg = _exact(jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(mel_cond), jnp.asarray(codes), return_loss=True)))(params)
    loss = port(_t(mel_cond), _t(codes, torch.long), return_loss=True)
    loss.backward()
    _loss_close(loss, jl)
    _grads_close(port, jg)


# --- GPT2Stack remat -----------------------------------------------------

@pytest.mark.parametrize("dtype", [None, BF16], ids=["float32", "bf16"])
def test_remat_gradients_equal_no_remat_bit_for_bit(voice_params, dtype):
    """UnifiedVoice's loss and every gradient with ``model.gpt.remat`` set
    equal those without it, bit for bit."""
    from tortoise_tpu_torch.training.train_step import unified_voice_loss

    _, port = _voice_models(voice_params, dtype, jnp.float32)
    batch = _port_batch(_voice_batch(0))
    runs = []
    for remat in (False, True):
        port.gpt.remat = remat
        for p in port.parameters():
            p.grad = None
        loss, _ = unified_voice_loss(port, batch)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in port.named_parameters()
                                     if p.grad is not None}))
    (loss, plain), (rloss, remat) = runs
    assert torch.equal(rloss, loss)
    assert remat.keys() == plain.keys() and len(plain) > 0
    assert all(torch.equal(remat[n], plain[n]) for n in plain)


def test_remat_stack_matches_jax_remat():
    """GPT2Stack(remat=True) against the JAX GPT2Stack(remat=True), float32:
    a weighted sum of the stack's output, its gradients to every parameter
    and to the input, to the float32 tests' tolerances. A cache turns remat
    off in both (the decode path): the output equals the uncached one's."""
    from tortoise_tpu.models.gpt2 import GPT2Config as JC
    from tortoise_tpu.models.gpt2 import GPT2Stack as JS
    from tortoise_tpu_torch.models.gpt2 import GPT2Config, GPT2Stack, init_kv_cache

    cfg = dict(n_layer=2, n_embd=128, n_head=4)
    emb, r = _x(30, 2, 17, 128), _x(31, 2, 17, 128)
    jstack = JS(JC(**cfg), remat=True)
    params = _params(lambda: jstack.init(jax.random.PRNGKey(0), jnp.asarray(emb)), 4)
    jval, (jgrads, jgx) = jax.value_and_grad(
        lambda p, x: (jstack.apply({"params": p}, x)[0] * r).sum(), argnums=(0, 1))(
        params, jnp.asarray(emb))
    port = _load(GPT2Stack(GPT2Config(**cfg), remat=True), params)
    x = _t(emb).requires_grad_()
    out = port(x)[0]
    val = (out * _t(r)).sum()
    val.backward()
    _loss_close(val, jval, F32_LOSS_RTOL)
    _grads_close(port, jgrads, F32_GRAD_FRAC)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=F32_GRAD_FRAC * float(jnp.abs(jgx).max()))
    with torch.no_grad():
        cached, _ = port(_t(emb), cache=init_kv_cache(port.config, 2, 17, torch.float32))
    np.testing.assert_allclose(cached.numpy(), out.detach().numpy(), rtol=0, atol=1e-5)
