"""The port's training path against the JAX package's on the CPU: the
UnifiedVoice loss and its gradients, three steps of the train step, the
diffusion losses, CLVP's and CVVP's contrastive losses, and the diffusion's
discrete-code path. The same numpy inputs, every JAX parameter random and
carried by convert/from_jax.py, which also maps JAX's gradient trees onto
the port's parameters. float32 at jax_default_matmul_precision=highest:
losses to 1e-5 relative, each gradient leaf to 1e-4 of its max |grad|."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu import weights as jax_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)
LOSS_RTOL = 1e-5
GRAD_FRAC = 1e-4
UV = dict(layers=2, model_dim=128, heads=4, max_text_tokens=40, max_mel_tokens=48)
DIFF = dict(model_channels=64, num_layers=2, in_latent_channels=32, num_heads=2)
CLVP_KW = dict(dim_text=64, dim_speech=64, dim_latent=64, text_enc_depth=2, text_heads=2,
               speech_enc_depth=2, speech_heads=2)
CVVP_KW = dict(model_dim=64, transformer_heads=4, conditioning_enc_depth=2, speech_enc_depth=2)
SCHEDULE_STEPS = 50


def _params(init_fn, seed):
    return jax_weights.host_init(init_fn, seed=seed)["params"]


def _load(port, params):
    port.load_state_dict(from_jax(port, params))
    return port


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _loss_close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=LOSS_RTOL,
                               atol=0)


def _grads_close(port, jgrads):
    """Every port gradient against JAX's, leaf by leaf, to GRAD_FRAC of the
    leaf's max |grad|. A parameter the loss does not reach has no port
    gradient and an all-zero JAX one."""
    want = from_jax(port, jgrads)
    for name, p in port.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_FRAC * np.abs(w).max(), err_msg=name)


# --- UnifiedVoice --------------------------------------------------------

@pytest.fixture(scope="module")
def voice():
    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice as PV
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig as PC

    jm = UnifiedVoice(UnifiedVoiceConfig(**UV))
    return jm, _params(lambda: init_unified_voice(jm, 0), 2), PV(PC(**UV))


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


def test_unified_voice_loss_and_gradients(voice):
    from tortoise_tpu.training import train_step as jts
    from tortoise_tpu_torch.training import train_step as pts

    jm, params, port = voice
    port = _load(port, params)
    batch = _voice_batch(0)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jts.unified_voice_loss(jm, p, _jax_batch(batch)), has_aux=True)(params)
    loss, aux = pts.unified_voice_loss(port, _port_batch(batch))
    loss.backward()
    _loss_close(loss, jloss)
    for k in ("loss_text", "loss_mel"):
        _loss_close(aux[k], jaux[k])
    assert port.conditioning_encoder.init.weight.grad is None
    _grads_close(port, jgrads)
    # the mel logits beside the losses are return_logits' mel logits
    with torch.no_grad():
        args = [_port_batch(batch)[k] for k in ("cond_latent", "text_tokens", "mel_codes",
                                                "wav_lengths")]
        *_, mel_logits = port(*args)
        torch.testing.assert_close(mel_logits, port(*args, return_logits=True)[1])


def test_optimizer_update_matches_optax():
    """One update on the same gradients: a leaf with a zero gradient (still
    decayed), the clip firing (norm 3) and not firing (norm 0.5), the
    warmup's lr 0 at count 0."""
    import optax

    from tortoise_tpu.training.train_step import make_optimizer as jmake
    from tortoise_tpu_torch.training.train_step import make_optimizer

    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32),
              "c": rng.standard_normal(4).astype(np.float32)}
    jopt, popt = jmake(lr=1e-2, weight_decay=0.1, warmup=2), make_optimizer(1e-2, 0.1, 2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    pp = [torch.from_numpy(v.copy()) for v in params.values()]
    pstate = popt.init(pp)
    for i, norm in enumerate((3.0, 0.5, 3.0, 0.5)):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        g["c"][:] = 0
        scale = norm / np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
        g = {k: (v * scale).astype(np.float32) for k, v in g.items()}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        got_norm = popt.update([torch.from_numpy(v.copy()) for v in g.values()], pstate, pp)
        np.testing.assert_allclose(got_norm.item(), optax.global_norm(jg), rtol=1e-6)
        for (k, want), got in zip(jp.items(), pp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{k} after update {i}")
        if i == 0:
            np.testing.assert_array_equal(pp[0].numpy(), params["a"])
    assert not np.array_equal(pp[2].numpy(), params["c"])    # decayed without a gradient


def test_global_norm_of_a_large_leaf():
    """The clip's norm over a 2^25-element leaf to 1e-6 of the float64 norm
    (a float32 torch.linalg.vector_norm on the CPU reads 0.2% low there)."""
    from tortoise_tpu_torch.training.train_step import global_norm

    g = torch.randn(2 ** 25, generator=torch.Generator().manual_seed(0)) * 1e-3
    small = torch.ones(3)
    want = float(((g.double() ** 2).sum() + 3).sqrt())
    np.testing.assert_allclose(float(global_norm([g, small])), want, rtol=1e-6)


# Parameters after the steps, against the sum of the steps' lrs. Adam's
# m / sqrt(v) turns a gradient at rounding level (the attention's key bias:
# softmax ignores a constant added to every logit of a row) into an update
# of up to +-lr, so an element may differ by up to 2 lr a step however well
# the gradients agree. So every element is held to that, and all but
# PARAM_FAR_SHARE of them to PARAM_NEAR_FRAC of the lr sum. Seen: beyond
# 0.01 of it, 4.3e-6 of UnifiedVoice's 3.0M elements after three steps and
# 1.3e-4 of the diffusion's 1.4M after two; the largest, 0.022 and 0.15
# (c_attn's and latent_attn_2.qkv's bias)
PARAM_NEAR_FRAC = 0.01
PARAM_FAR_SHARE = 1e-3


def _params_close(port, jparams, lr_sum):
    want = from_jax(port, jparams)
    d = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in port.named_parameters()])
    assert float(d.max()) <= 2 * lr_sum, float(d.max())
    assert float((d > PARAM_NEAR_FRAC * lr_sum).float().mean()) <= PARAM_FAR_SHARE
    return float(d.max())


def test_train_step_matches_jax_over_three_steps(voice):
    """Three steps, warmup 2 and lr 1e-3: the first changes nothing (lr 0),
    the next two take lr 5e-4 and 1e-3. The clip fires at every step
    (grad_norm > 1)."""
    from tortoise_tpu.training import train_step as jts
    from tortoise_tpu_torch.training import train_step as pts

    jm, params, port = voice
    port = _load(port, params)
    batch = _voice_batch(1)
    jopt = jts.make_optimizer(lr=1e-3, warmup=2)
    jstep = jts.make_train_step(jm, jopt)
    jstate = jts.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    popt = pts.make_optimizer(lr=1e-3, warmup=2)
    pstep = pts.make_train_step(port, popt)
    pstate = pts.init_train_state(port, popt)
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    lr_sum = 0.0
    for i in range(3):
        lr_sum += popt.learning_rate(i)
        jstate, jmet = jstep(jstate, _jax_batch(batch))
        pstate, pmet = pstep(pstate, _port_batch(batch))
        assert pstate.step == i + 1 and int(jstate.step) == i + 1
        assert float(jmet["grad_norm"]) > 1.0
        for k in ("loss", "loss_text", "loss_mel", "grad_norm"):
            _loss_close(pmet[k], jmet[k])
        if i == 0:
            assert all(torch.equal(port.state_dict()[k], v) for k, v in before.items())
            continue
        worst = _params_close(port, jstate.params, lr_sum)
    # the steps moved the parameters by far more than they differ
    moved = max(float((port.state_dict()[k] - v).abs().max()) for k, v in before.items())
    assert moved > 10 * worst
    enc = port.conditioning_encoder.init.weight
    torch.testing.assert_close(enc, before["conditioning_encoder.init.weight"]
                               * (1 - 5e-4 * 0.01) * (1 - 1e-3 * 0.01))


# --- diffusion losses ----------------------------------------------------

def _schedules():
    from tortoise_tpu.diffusion.schedule import spaced_schedule as jsched
    from tortoise_tpu_torch.diffusion.schedule import spaced_schedule

    return jsched("linear", 4000, SCHEDULE_STEPS), spaced_schedule("linear", 4000,
                                                                   SCHEDULE_STEPS)


def test_training_losses_fake_model():
    """The JAX package's reference test's fake model
    (tests/test_diffusion_losses_parity.py), injected noise, t = 0 (the
    decoder NLL) and t > 0 (the KL)."""
    from tortoise_tpu.diffusion.losses import training_losses as jlosses
    from tortoise_tpu_torch.diffusion.losses import training_losses

    js, ps = _schedules()
    x_start = _x(0, 3, 12, 4) * 0.5
    noise = _x(1, 3, 12, 4)
    t = np.array([0, 13, SCHEDULE_STEPS - 1])

    def jfake(x, t_orig):
        tt = t_orig.astype(jnp.float32).reshape(-1, 1, 1)
        return jnp.concatenate([0.1 * x + 0.0003 * tt, jnp.tanh(x)], axis=-1)

    def pfake(x, t_orig):
        tt = t_orig.float().reshape(-1, 1, 1)
        return torch.cat([0.1 * x + 0.0003 * tt, torch.tanh(x)], dim=-1)

    want = jlosses(jfake, js, jnp.asarray(x_start), jnp.asarray(t), noise=jnp.asarray(noise))
    got = training_losses(pfake, ps, _t(x_start), _t(t, torch.long), noise=_t(noise))
    for k in ("mse", "vb", "loss"):
        _loss_close(got[k], want[k])
    resc = training_losses(pfake, ps, _t(x_start), _t(t, torch.long), noise=_t(noise),
                           rescale_vb=True)
    _loss_close(resc["vb"], want["vb"] * SCHEDULE_STEPS / 1000.0)
    # drawn noise: from the generator, so a seed repeats it
    a, b = (training_losses(pfake, ps, _t(x_start), _t(t, torch.long),
                            generator=torch.Generator().manual_seed(5)) for _ in range(2))
    torch.testing.assert_close(a["loss"], b["loss"], rtol=0, atol=0)


def test_vb_gives_eps_no_gradient():
    """The VB term reads eps detached (the frozen mean): its gradient into
    the model output's eps channels is exactly zero in both packages, and
    into the variance channels it is not."""
    from tortoise_tpu.diffusion.losses import training_losses as jlosses
    from tortoise_tpu_torch.diffusion.losses import training_losses

    js, ps = _schedules()
    x_start, noise, out = _x(2, 2, 10, 3) * 0.5, _x(3, 2, 10, 3), _x(4, 2, 10, 6)
    t = np.array([0, 30])
    jg = jax.grad(lambda o: jlosses(lambda x, tt: o, js, jnp.asarray(x_start), jnp.asarray(t),
                                    noise=jnp.asarray(noise))["vb"].sum())(jnp.asarray(out))
    pout = _t(out).requires_grad_()
    training_losses(lambda x, tt: pout, ps, _t(x_start), _t(t, torch.long),
                    noise=_t(noise))["vb"].sum().backward()
    assert not np.asarray(jg)[..., :3].any() and not pout.grad[..., :3].any()
    assert pout.grad[..., 3:].abs().min() > 0
    # the KL row (t = 30) to GRAD_FRAC of its max |grad|; the decoder NLL row
    # (t = 0) reads log(cdf(x + 1/255) - cdf(x - 1/255)), whose float32
    # cancellation leaves ~3e-4 of its max |grad| (1.2e-7 on 4.6e-4): 1e-3
    jg = np.asarray(jg)
    for row, frac in ((1, GRAD_FRAC), (0, 1e-3)):
        np.testing.assert_allclose(pout.grad[row].numpy(), jg[row], rtol=0,
                                   atol=frac * np.abs(jg[row]).max(), err_msg=f"row {row}")


@pytest.fixture(scope="module")
def diffusion():
    from tortoise_tpu.models.diffusion_decoder import (DiffusionTts, DiffusionTtsConfig,
                                                       init_diffusion_tts)
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts as PD
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig as PC

    jm = DiffusionTts(DiffusionTtsConfig(**DIFF))
    params = _params(lambda: init_diffusion_tts(jm, jax.random.PRNGKey(0)), 8)
    return jm, params, PD(PC(**DIFF))


def test_diffusion_training_losses_and_gradients(diffusion):
    """training_losses over a 2-layer DiffusionTts conditioned on latents
    (the unbucketed model call), mean over the batch, and every gradient."""
    from tortoise_tpu.diffusion.losses import training_losses as jlosses
    from tortoise_tpu_torch.diffusion.losses import training_losses

    jm, params, port = diffusion
    port = _load(port, params)
    js, ps = _schedules()
    x_start = np.tanh(_x(5, 2, 24, 100))
    noise, lat, cond = _x(6, 2, 24, 100), _x(7, 2, 6, 32), _x(8, 2, 128)
    t = np.array([0, 37])

    def jloss(p):
        fn = lambda x, tt: jm.apply({"params": p}, x, tt, aligned_conditioning=jnp.asarray(lat),
                                    conditioning_latent=jnp.asarray(cond))
        terms = jlosses(fn, js, jnp.asarray(x_start), jnp.asarray(t), noise=jnp.asarray(noise))
        return terms["loss"].mean(), terms

    (jl, jterms), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    fn = lambda x, tt: port(x, tt, aligned_conditioning=_t(lat), conditioning_latent=_t(cond))
    terms = training_losses(fn, ps, _t(x_start), _t(t, torch.long), noise=_t(noise))
    terms["loss"].mean().backward()
    for k in ("mse", "vb", "loss"):
        _loss_close(terms[k], jterms[k])
    _grads_close(port, jgrads)


# --- the diffusion's code path -------------------------------------------

@pytest.mark.parametrize("conditioning", ["codes", "latents"])
def test_timestep_independent(diffusion, conditioning):
    from tortoise_tpu.models.diffusion_decoder import DiffusionTts

    jm, params, port = diffusion
    port = _load(port, params)
    rng = np.random.default_rng(9)
    aligned = (rng.integers(0, 8193, (2, 7)) if conditioning == "codes"
               else _x(10, 2, 7, 32))
    cond = _x(11, 2, 128)
    jexp, jpred = jm.apply({"params": params}, jnp.asarray(aligned), jnp.asarray(cond), 30,
                           return_code_pred=True, method=DiffusionTts.timestep_independent)
    p_aligned = _t(aligned, torch.long if conditioning == "codes" else torch.float32)
    with torch.no_grad():
        exp, pred = port.timestep_independent(p_aligned, _t(cond), 30, return_code_pred=True)
        alone = port.timestep_independent(p_aligned, _t(cond), 30)
    assert exp.shape == (2, 30, 64) and pred.shape == (2, 30, 100)
    np.testing.assert_allclose(exp.numpy(), np.asarray(jexp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alone, exp, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["codes", "conditioning_free"])
def test_diffusion_forward_unbucketed(diffusion, mode):
    """The model call as the losses make it: from codes and the voice
    latent, or conditioning-free (the learned unconditioned embedding)."""
    jm, params, port = diffusion
    port = _load(port, params)
    rng = np.random.default_rng(12)
    x = _x(13, 2, 20, 100)
    steps = np.array([3, 2500])
    kw = ({"conditioning_free": True} if mode == "conditioning_free" else
          {"aligned_conditioning": rng.integers(0, 8193, (2, 5)),
           "conditioning_latent": _x(14, 2, 128)})
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(steps),
                    **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                       for k, v in kw.items()})
    pkw = {k: (_t(v, torch.long if v.dtype != np.float32 else torch.float32)
               if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    with torch.no_grad():
        got = port(_t(x), _t(steps, torch.long), **pkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


# --- CLVP and CVVP -------------------------------------------------------

def _masks(seed, b, t):
    """Random keep masks with each row's first position kept."""
    m = np.random.default_rng(seed).random((b, t)) > 0.3
    m[:, 0] = True
    return m


@pytest.mark.parametrize("masked", [False, True])
def test_clvp_loss_and_gradients(masked):
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.clvp import CLVP as P
    from tortoise_tpu_torch.models.clvp import CLVPConfig as PC

    jm = CLVP(CLVPConfig(**CLVP_KW))
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                                     jnp.zeros((1, 4), jnp.int32)), 5)
    port = _load(P(PC(**CLVP_KW)), params)
    rng = np.random.default_rng(15)
    text, speech = rng.integers(0, 256, (3, 10)), rng.integers(0, 8192, (3, 14))
    tm, vm = (_masks(16, 3, 10), _masks(17, 3, 14)) if masked else (None, None)
    jmask = lambda m: None if m is None else jnp.asarray(m)
    pmask = lambda m: None if m is None else torch.from_numpy(m)
    jl, jg = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(text), jnp.asarray(speech), return_loss=True,
        text_mask=jmask(tm), voice_mask=jmask(vm)))(params)
    loss = port(_t(text, torch.long), _t(speech, torch.long), return_loss=True,
                text_mask=pmask(tm), voice_mask=pmask(vm))
    loss.backward()
    _loss_close(loss, jl)
    _grads_close(port, jg)
    # the scores: each pair's similarity
    with torch.no_grad():
        got = port(_t(text, torch.long), _t(speech, torch.long), text_mask=pmask(tm),
                   voice_mask=pmask(vm))
    want = jm.apply({"params": params}, jnp.asarray(text), jnp.asarray(speech),
                    text_mask=jmask(tm), voice_mask=jmask(vm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_cvvp_loss_and_gradients():
    from tortoise_tpu.models.cvvp import CVVP, CVVPConfig
    from tortoise_tpu_torch.models.cvvp import CVVP as P
    from tortoise_tpu_torch.models.cvvp import CVVPConfig as PC

    jm = CVVP(CVVPConfig(**CVVP_KW))
    mel_cond = _x(18, 3, 40, 80)
    codes = np.random.default_rng(19).integers(0, 8192, (3, 14))
    params = _params(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(mel_cond),
                                     jnp.asarray(codes)), 6)
    port = _load(P(PC(**CVVP_KW)), params)
    jl, jg = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(mel_cond), jnp.asarray(codes), return_loss=True))(params)
    loss = port(_t(mel_cond), _t(codes, torch.long), return_loss=True)
    loss.backward()
    _loss_close(loss, jl)
    _grads_close(port, jg)


def test_diffusion_train_step_runs_losses(diffusion):
    """make_train_step with training_losses as the loss: the step the
    diffusion is trained with, held to the JAX step's loss, grad_norm and
    parameters."""
    from tortoise_tpu.diffusion.losses import training_losses as jlosses
    from tortoise_tpu.training import train_step as jts
    from tortoise_tpu_torch.diffusion.losses import training_losses
    from tortoise_tpu_torch.training import train_step as pts

    jm, params, port = diffusion
    port = _load(port, params)
    js, ps = _schedules()
    x_start, noise = np.tanh(_x(20, 2, 16, 100)), _x(21, 2, 16, 100)
    lat, cond, t = _x(22, 2, 4, 32), _x(23, 2, 128), np.array([5, 40])

    def jloss(model, p, batch):
        fn = lambda x, tt: model.apply({"params": p}, x, tt,
                                       aligned_conditioning=batch["lat"],
                                       conditioning_latent=batch["cond"])
        terms = jlosses(fn, js, batch["x"], batch["t"], noise=batch["noise"])
        return terms["loss"].mean(), {"mse": terms["mse"].mean(), "vb": terms["vb"].mean()}

    def ploss(model, batch):
        fn = lambda x, tt: model(x, tt, aligned_conditioning=batch["lat"],
                                 conditioning_latent=batch["cond"])
        terms = training_losses(fn, ps, batch["x"], batch["t"], noise=batch["noise"])
        return terms["loss"].mean(), {"mse": terms["mse"].mean(), "vb": terms["vb"].mean()}

    batch = {"x": x_start, "noise": noise, "lat": lat, "cond": cond, "t": t}
    jopt = jts.make_optimizer(lr=1e-3, warmup=1)
    jstate = jts.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    jstep = jts.make_train_step(jm, jopt, loss_fn=jloss)
    for _ in range(2):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    popt = pts.make_optimizer(lr=1e-3, warmup=1)
    pstep = pts.make_train_step(port, popt, loss_fn=ploss)
    pstate = pts.init_train_state(port, popt)
    pbatch = {k: _t(v, torch.long if k == "t" else torch.float32) for k, v in batch.items()}
    for _ in range(2):
        pstate, pmet = pstep(pstate, pbatch)
    for k in ("loss", "mse", "vb", "grad_norm"):
        _loss_close(pmet[k], jmet[k])
    _params_close(port, jstate.params, 1e-3)
