"""Torch checkpoint -> flax param pytree converters.

A copy of the converters of ``tortoise_tpu/convert/torch_import.py`` that
the port calls (UnifiedVoice, DiffusionTts, CLVP, CVVP, UnivNet, HiFi-GAN,
the random-latent generators, the Tortoise-detect classifier and the
aligner's wav2vec2), with the per-layer trees stacked by a numpy map
over nested dicts (``stack_layers``) instead of ``jax.tree.map``: the port
imports nothing of jax or the JAX package. ``convert/from_jax.py`` then
turns a tree into the port's ``state_dict``.

One-time conversion of the reference's shipped ``.pth`` checkpoints
(reference: tortoise/api.py:31-40) into this framework's parameter trees.
Handles the layout differences:

* torch ``Conv1d`` weight (out, in, k)  -> flax ``nn.Conv`` kernel (k, in, out)
* torch ``Linear`` weight (out, in)     -> flax ``nn.Dense`` kernel (in, out)
* HF GPT-2 ``Conv1D`` weight (in, out)  -> flax kernel unchanged
* weight-norm (g, v) pairs              -> folded to g·v/‖v‖ at convert time
  (inference removes weight norm anyway, reference vocoder.py:290-298)

The same converters power the parity test-suite: reference modules are
instantiated with random weights on CPU torch, converted, and outputs
compared numerically.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np


def t2n(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy())


def conv1d_kernel(w) -> np.ndarray:
    """torch Conv1d (out, in, k) -> flax (k, in, out)."""
    return t2n(w).transpose(2, 1, 0)


def dense_kernel(w) -> np.ndarray:
    """torch Linear (out, in) -> flax (in, out)."""
    return t2n(w).T


def conv1x1_as_dense(w) -> np.ndarray:
    """torch Conv1d kernel-1 (out, in, 1) -> flax Dense (in, out)."""
    return t2n(w)[:, :, 0].T


def fold_weight_norm(g, v, dim: int = 0) -> np.ndarray:
    """Fold weight-norm parametrization: w = g * v / ||v|| (norm over all dims
    except ``dim``, matching torch.nn.utils.weight_norm's default dim=0)."""
    g, v = t2n(g), t2n(v)
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g * v / norm


def stack_layers(trees: list) -> dict:
    """Per-layer param trees (nested dicts of arrays, one per layer) -> one
    tree whose leaves stack the layers' leaves along a new leading axis, as
    ``jax.tree.map(lambda *xs: np.stack(xs), *trees)`` does."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _groupnorm(sd, prefix):
    return {"GroupNorm_0": {"scale": t2n(sd[f"{prefix}.weight"]),
                            "bias": t2n(sd[f"{prefix}.bias"])}}


def _layernorm(sd, prefix):
    return {"scale": t2n(sd[f"{prefix}.weight"]), "bias": t2n(sd[f"{prefix}.bias"])}


def attention_block_params(sd, prefix: str) -> dict:
    """reference arch_util.AttentionBlock -> blocks.AttentionBlock params."""
    p = {
        "GroupNorm32_0": _groupnorm(sd, f"{prefix}.norm"),
        "qkv": {"kernel": conv1x1_as_dense(sd[f"{prefix}.qkv.weight"]),
                "bias": t2n(sd[f"{prefix}.qkv.bias"])},
        "proj_out": {"kernel": conv1x1_as_dense(sd[f"{prefix}.proj_out.weight"]),
                     "bias": t2n(sd[f"{prefix}.proj_out.bias"])},
    }
    rel = f"{prefix}.relative_pos_embeddings.relative_attention_bias.weight"
    if rel in sd:
        p["rel_pos"] = {"embedding": t2n(sd[rel])}
    return p


def resblock_params(sd, prefix: str) -> dict:
    """reference arch_util/classifier ResBlock -> blocks.ResBlock params."""
    p = {
        "GroupNorm32_0": _groupnorm(sd, f"{prefix}.in_layers.0"),
        "in_conv": {"kernel": conv1d_kernel(sd[f"{prefix}.in_layers.2.weight"]),
                    "bias": t2n(sd[f"{prefix}.in_layers.2.bias"])},
        "GroupNorm32_1": _groupnorm(sd, f"{prefix}.out_layers.0"),
        "out_conv": {"kernel": conv1d_kernel(sd[f"{prefix}.out_layers.3.weight"]),
                     "bias": t2n(sd[f"{prefix}.out_layers.3.bias"])},
    }
    if f"{prefix}.skip_connection.weight" in sd:
        p["skip_conv"] = {"kernel": conv1d_kernel(sd[f"{prefix}.skip_connection.weight"]),
                          "bias": t2n(sd[f"{prefix}.skip_connection.bias"])}
    return p


def conditioning_encoder_params(sd, prefix: str, attn_blocks: int = 6) -> dict:
    p = {"init": {"kernel": conv1x1_as_dense(sd[f"{prefix}.init.weight"]),
                  "bias": t2n(sd[f"{prefix}.init.bias"])}}
    for i in range(attn_blocks):
        p[f"attn_{i}"] = attention_block_params(sd, f"{prefix}.attn.{i}")
    return p


def gpt2_stack_params(sd, prefix: str, n_layer: int) -> dict:
    """HF GPT2Model -> gpt2.GPT2Stack params. HF Conv1D weights are already
    (in, out), so they map straight onto flax Dense kernels. Per-layer
    weights are stacked along a leading layer axis for the scan-over-layers
    stack (param path {"h_scan": {"block": ...}})."""
    def layer(i):
        hp = f"{prefix}.h.{i}"
        return {
            "ln_1": _layernorm(sd, f"{hp}.ln_1"),
            "ln_2": _layernorm(sd, f"{hp}.ln_2"),
            "attn": {
                "c_attn": {"kernel": t2n(sd[f"{hp}.attn.c_attn.weight"]),
                           "bias": t2n(sd[f"{hp}.attn.c_attn.bias"])},
                "c_proj": {"kernel": t2n(sd[f"{hp}.attn.c_proj.weight"]),
                           "bias": t2n(sd[f"{hp}.attn.c_proj.bias"])},
            },
            "mlp_fc": {"kernel": t2n(sd[f"{hp}.mlp.c_fc.weight"]),
                       "bias": t2n(sd[f"{hp}.mlp.c_fc.bias"])},
            "mlp_proj": {"kernel": t2n(sd[f"{hp}.mlp.c_proj.weight"]),
                         "bias": t2n(sd[f"{hp}.mlp.c_proj.bias"])},
        }

    stacked = stack_layers([layer(i) for i in range(n_layer)])
    return {"h_scan": {"block": stacked}, "ln_f": _layernorm(sd, f"{prefix}.ln_f")}


def unified_voice_params(sd, layers: int = 30) -> dict:
    """reference UnifiedVoice state_dict -> models.autoregressive.UnifiedVoice."""
    return {
        "conditioning_encoder": conditioning_encoder_params(sd, "conditioning_encoder"),
        "text_embedding": {"embedding": t2n(sd["text_embedding.weight"])},
        "mel_embedding": {"embedding": t2n(sd["mel_embedding.weight"])},
        "text_pos_embedding": {"embedding": t2n(sd["text_pos_embedding.emb.weight"])},
        "mel_pos_embedding": {"embedding": t2n(sd["mel_pos_embedding.emb.weight"])},
        "gpt": gpt2_stack_params(sd, "gpt", layers),
        "final_norm": _layernorm(sd, "final_norm"),
        "text_head": {"kernel": dense_kernel(sd["text_head.weight"]),
                      "bias": t2n(sd["text_head.bias"])},
        "mel_head": {"kernel": dense_kernel(sd["mel_head.weight"]),
                     "bias": t2n(sd["mel_head.bias"])},
    }


def convtranspose1d_kernel(w) -> np.ndarray:
    """torch ConvTranspose1d (in, out, k) -> input-dilated-conv kernel
    (k, in, out) with time axis flipped (see hifigan.conv_transpose_1d)."""
    return np.ascontiguousarray(t2n(w).transpose(2, 0, 1)[::-1])


def _wn_conv(sd, prefix: str, transpose: bool = False) -> dict:
    """Weight-normed torch conv -> folded flax kernel dict."""
    w = fold_weight_norm(sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"], dim=0)
    import torch

    wt = torch.from_numpy(w)
    kernel = convtranspose1d_kernel(wt) if transpose else conv1d_kernel(wt)
    return {"kernel": kernel, "bias": t2n(sd[f"{prefix}.bias"])}


def hifigan_params(sd, num_upsamples: int = 4, num_kernels: int = 3,
                   resblock_convs: int = 3) -> dict:
    """reference HifiganGenerator state_dict -> models.hifigan params."""
    p = {
        "conv_pre": _wn_conv(sd, "conv_pre"),
        "conv_post": _wn_conv(sd, "conv_post"),
    }
    if "cond_layer.weight" in sd:
        p["cond_layer"] = {"kernel": conv1x1_as_dense(sd["cond_layer.weight"]),
                           "bias": t2n(sd["cond_layer.bias"])}
    for i in range(num_upsamples):
        p[f"up_{i}"] = _wn_conv(sd, f"ups.{i}", transpose=True)
        for j in range(num_kernels):
            idx = i * num_kernels + j
            blk = {}
            if f"resblocks.{idx}.convs1.0.weight_g" in sd:  # ResBlock1
                for n in range(resblock_convs):
                    blk[f"conv1_{n}"] = _wn_conv(sd, f"resblocks.{idx}.convs1.{n}")
                    blk[f"conv2_{n}"] = _wn_conv(sd, f"resblocks.{idx}.convs2.{n}")
            else:  # ResBlock2
                for n in range(2):
                    blk[f"conv_{n}"] = _wn_conv(sd, f"resblocks.{idx}.convs.{n}")
            p[f"resblock_{i}_{j}"] = blk
    return p


def rlg_params(sd) -> dict:
    """reference RandomLatentConverter -> models.random_latent params."""
    p = {}
    for i in range(5):
        p[f"eq_{i}"] = {"weight": t2n(sd[f"layers.{i}.weight"]),
                        "bias": t2n(sd[f"layers.{i}.bias"])}
    p["final"] = {"kernel": dense_kernel(sd["layers.5.weight"]),
                  "bias": t2n(sd["layers.5.bias"])}
    return p


def xtransformer_encoder_params(sd, prefix: str, depth: int, wrapped: bool = True) -> dict:
    """reference ContinuousTransformerWrapper(Encoder) -> XTransformerEncoder.

    ``wrapped`` selects the CheckpointedLayer ('.wrap') indirection used by
    CLVP's CheckpointedXTransformerEncoder (reference arch_util.py:350-373).
    Layer list alternates [attn, ff] per depth; norms live at .0.0 (RMSNorm
    'g'), the branch module at .1.
    """
    mid = ".wrap" if wrapped else ""

    def layer(d):
        ia, iff = 2 * d, 2 * d + 1
        ap = f"{prefix}.attn_layers.layers.{ia}.1{mid}"
        fp = f"{prefix}.attn_layers.layers.{iff}.1{mid}"
        return {
            "attn_norm": {"g": t2n(sd[f"{prefix}.attn_layers.layers.{ia}.0.0.g"])},
            "attn": {
                "to_q": {"kernel": dense_kernel(sd[f"{ap}.to_q.weight"])},
                "to_k": {"kernel": dense_kernel(sd[f"{ap}.to_k.weight"])},
                "to_v": {"kernel": dense_kernel(sd[f"{ap}.to_v.weight"])},
                "to_out": {"kernel": dense_kernel(sd[f"{ap}.to_out.weight"]),
                           "bias": t2n(sd[f"{ap}.to_out.bias"])},
            },
            "ff_norm": {"g": t2n(sd[f"{prefix}.attn_layers.layers.{iff}.0.0.g"])},
            "ff": {
                "proj": {"kernel": dense_kernel(sd[f"{fp}.net.0.proj.weight"]),
                         "bias": t2n(sd[f"{fp}.net.0.proj.bias"])},
                "out": {"kernel": dense_kernel(sd[f"{fp}.net.3.weight"]),
                        "bias": t2n(sd[f"{fp}.net.3.bias"])},
            },
        }

    stacked = stack_layers([layer(d) for d in range(depth)])
    return {"layers_scan": stacked, "final_norm": _layernorm(sd, f"{prefix}.norm")}


def simple_transformer_params(sd, prefix: str, depth: int) -> dict:
    """reference fallback Transformer (transformer.py:182-219) ->
    models.simple_transformer.SimpleTransformer params. Reference layout per
    layer i: ``{prefix}.layers.layers.{i}.{0,1}`` = LayerScale(PreNorm(fn))
    for attention (0) and GEGLU feed-forward (1)."""
    out = {}
    for i in range(depth):
        a = f"{prefix}.layers.layers.{i}.0"
        f = f"{prefix}.layers.layers.{i}.1"
        out[f"block_{i}"] = {
            "attn_scale": t2n(sd[f"{a}.scale"]).reshape(-1),
            "ff_scale": t2n(sd[f"{f}.scale"]).reshape(-1),
            "attn_norm": {"scale": t2n(sd[f"{a}.fn.norm.weight"]),
                          "bias": t2n(sd[f"{a}.fn.norm.bias"])},
            "ff_norm": {"scale": t2n(sd[f"{f}.fn.norm.weight"]),
                        "bias": t2n(sd[f"{f}.fn.norm.bias"])},
            "attn": {"to_qkv": {"kernel": dense_kernel(sd[f"{a}.fn.fn.to_qkv.weight"])},
                     "to_out": {"kernel": dense_kernel(sd[f"{a}.fn.fn.to_out.0.weight"]),
                                "bias": t2n(sd[f"{a}.fn.fn.to_out.0.bias"])}},
            "ff": {"ff_in": {"kernel": dense_kernel(sd[f"{f}.fn.fn.net.0.weight"]),
                             "bias": t2n(sd[f"{f}.fn.fn.net.0.bias"])},
                   "ff_out": {"kernel": dense_kernel(sd[f"{f}.fn.fn.net.3.weight"]),
                              "bias": t2n(sd[f"{f}.fn.fn.net.3.bias"])}},
        }
    return out


def clvp_params(sd) -> dict:
    """reference CLVP -> models.clvp.CLVP params (both the shipped
    use_xformers=True layout and the plain-Transformer fallback,
    reference clvp.py:84-97)."""
    fallback = any(k.startswith("text_transformer.layers.layers.") for k in sd)
    if fallback:
        depth_t = max(int(k.split(".")[3]) for k in sd
                      if k.startswith("text_transformer.layers.layers.")) + 1
        depth_s = max(int(k.split(".")[3]) for k in sd
                      if k.startswith("speech_transformer.layers.layers.")) + 1
        enc_t = simple_transformer_params(sd, "text_transformer", depth_t)
        enc_s = simple_transformer_params(sd, "speech_transformer", depth_s)
    else:
        depth_t = max(int(k.split(".")[4]) for k in sd
                      if k.startswith("text_transformer.transformer.attn_layers.layers.")) // 2 + 1
        depth_s = max(int(k.split(".")[4]) for k in sd
                      if k.startswith("speech_transformer.transformer.attn_layers.layers.")) // 2 + 1
        enc_t = xtransformer_encoder_params(
            sd, "text_transformer.transformer", depth_t, wrapped=True)
        enc_s = xtransformer_encoder_params(
            sd, "speech_transformer.transformer", depth_s, wrapped=True)
    p = {
        "text_emb": {"embedding": t2n(sd["text_emb.weight"])},
        "speech_emb": {"embedding": t2n(sd["speech_emb.weight"])},
        "text_transformer": enc_t,
        "speech_transformer": enc_s,
        "to_text_latent": {"kernel": dense_kernel(sd["to_text_latent.weight"])},
        "to_speech_latent": {"kernel": dense_kernel(sd["to_speech_latent.weight"])},
        "temperature": t2n(sd["temperature"]).reshape(()),
    }
    if fallback:
        p["text_pos_emb"] = {"embedding": t2n(sd["text_pos_emb.weight"])}
        p["speech_pos_emb"] = {"embedding": t2n(sd["speech_pos_emb.weight"])}
    return p


def _collapsing_transformer_params(sd, prefix: str, depth: int) -> dict:
    return {
        "transformer": xtransformer_encoder_params(sd, f"{prefix}.transformer",
                                                   depth, wrapped=False),
        "pre_conv": {"kernel": conv1x1_as_dense(sd[f"{prefix}.pre_combiner.0.weight"]),
                     "bias": t2n(sd[f"{prefix}.pre_combiner.0.bias"])},
        "pre_attn": attention_block_params(sd, f"{prefix}.pre_combiner.1"),
        "post_conv": {"kernel": conv1x1_as_dense(sd[f"{prefix}.pre_combiner.2.weight"]),
                      "bias": t2n(sd[f"{prefix}.pre_combiner.2.bias"])},
    }


def cvvp_params(sd, cond_depth: int = 8, speech_depth: int = 8) -> dict:
    """reference CVVP (mel_codes=8192: the speech side embeds discrete
    codes) -> models.cvvp.CVVP params."""
    return {
        "cond_conv1": {"kernel": conv1d_kernel(sd["cond_emb.0.weight"]),
                       "bias": t2n(sd["cond_emb.0.bias"])},
        "cond_conv2": {"kernel": conv1d_kernel(sd["cond_emb.1.weight"]),
                       "bias": t2n(sd["cond_emb.1.bias"])},
        "conditioning_transformer": _collapsing_transformer_params(
            sd, "conditioning_transformer", cond_depth),
        "to_conditioning_latent": {"kernel": dense_kernel(sd["to_conditioning_latent.weight"])},
        "speech_transformer": _collapsing_transformer_params(
            sd, "speech_transformer", speech_depth),
        "to_speech_latent": {"kernel": dense_kernel(sd["to_speech_latent.weight"])},
        "speech_emb": {"embedding": t2n(sd["speech_emb.emb.weight"])},
        "temperature": t2n(sd["temperature"]).reshape(()),
    }


def _timestep_resblock_params(sd, prefix: str) -> dict:
    """reference diffusion_decoder.ResBlock (efficient, scale-shift) ->
    models.diffusion_decoder.TimestepResBlock."""
    p = {
        "GroupNorm32_0": _groupnorm(sd, f"{prefix}.in_layers.0"),
        "in_conv": {"kernel": conv1x1_as_dense(sd[f"{prefix}.in_layers.2.weight"]),
                    "bias": t2n(sd[f"{prefix}.in_layers.2.bias"])},
        "emb_proj": {"kernel": dense_kernel(sd[f"{prefix}.emb_layers.1.weight"]),
                     "bias": t2n(sd[f"{prefix}.emb_layers.1.bias"])},
        "GroupNorm32_1": _groupnorm(sd, f"{prefix}.out_layers.0"),
        "out_conv": {"kernel": conv1d_kernel(sd[f"{prefix}.out_layers.3.weight"]),
                     "bias": t2n(sd[f"{prefix}.out_layers.3.bias"])},
    }
    if f"{prefix}.skip_connection.weight" in sd:
        p["skip_conv"] = {"kernel": conv1x1_as_dense(sd[f"{prefix}.skip_connection.weight"]),
                          "bias": t2n(sd[f"{prefix}.skip_connection.bias"])}
    return p


def _diffusion_layer_params(sd, prefix: str) -> dict:
    return {"resblk": _timestep_resblock_params(sd, f"{prefix}.resblk"),
            "attn": attention_block_params(sd, f"{prefix}.attn")}


def diffusion_tts_params(sd, num_layers: int = 10) -> dict:
    """reference DiffusionTts state_dict -> models.diffusion_decoder params."""
    p = {
        "inp_block": {"kernel": conv1d_kernel(sd["inp_block.weight"]),
                      "bias": t2n(sd["inp_block.bias"])},
        "time_embed_1": {"kernel": dense_kernel(sd["time_embed.0.weight"]),
                         "bias": t2n(sd["time_embed.0.bias"])},
        "time_embed_2": {"kernel": dense_kernel(sd["time_embed.2.weight"]),
                         "bias": t2n(sd["time_embed.2.bias"])},
        "code_embedding": {"embedding": t2n(sd["code_embedding.weight"])},
        "code_norm": _groupnorm(sd, "code_norm"),
        "latent_conv": {"kernel": conv1d_kernel(sd["latent_conditioner.0.weight"]),
                        "bias": t2n(sd["latent_conditioner.0.bias"])},
        "ctx_conv1": {"kernel": conv1d_kernel(sd["contextual_embedder.0.weight"]),
                      "bias": t2n(sd["contextual_embedder.0.bias"])},
        "ctx_conv2": {"kernel": conv1d_kernel(sd["contextual_embedder.1.weight"]),
                      "bias": t2n(sd["contextual_embedder.1.bias"])},
        "unconditioned_embedding": t2n(sd["unconditioned_embedding"]).transpose(0, 2, 1),
        "integrating_conv": {"kernel": conv1x1_as_dense(sd["integrating_conv.weight"]),
                             "bias": t2n(sd["integrating_conv.bias"])},
        "mel_head": {"kernel": conv1d_kernel(sd["mel_head.weight"]),
                     "bias": t2n(sd["mel_head.bias"])},
        "out_norm": _groupnorm(sd, "out.0"),
        "out_conv": {"kernel": conv1d_kernel(sd["out.2.weight"]),
                     "bias": t2n(sd["out.2.bias"])},
    }
    for i in range(3):
        p[f"code_converter_{i}"] = attention_block_params(sd, f"code_converter.{i}")
    for i in range(4):
        p[f"latent_attn_{i}"] = attention_block_params(sd, f"latent_conditioner.{i + 1}")
    for i in range(5):
        p[f"ctx_attn_{i}"] = attention_block_params(sd, f"contextual_embedder.{i + 2}")
    p["cond_scan"] = {"layer": stack_layers([
        _diffusion_layer_params(sd, f"conditioning_timestep_integrator.{i}")
        for i in range(3)])}
    p["layers_scan"] = {"layer": stack_layers([
        _diffusion_layer_params(sd, f"layers.{i}") for i in range(num_layers)])}
    for i in range(3):
        p[f"tail_{i}"] = _timestep_resblock_params(sd, f"layers.{num_layers + i}")
    return p


def univnet_params(sd, n_blocks: int = 3, n_dilations: int = 4) -> dict:
    """reference UnivNetGenerator state_dict -> models.vocoder params."""
    p = {"conv_pre": _wn_conv(sd, "conv_pre"),
         "conv_post": _wn_conv(sd, "conv_post.1")}
    for i in range(n_blocks):
        rp = f"res_stack.{i}"
        kp = {"input_conv": _wn_conv(sd, f"{rp}.kernel_predictor.input_conv.0"),
              "kernel_conv": _wn_conv(sd, f"{rp}.kernel_predictor.kernel_conv"),
              "bias_conv": _wn_conv(sd, f"{rp}.kernel_predictor.bias_conv")}
        for j in range(3):
            kp[f"res_{j}_a"] = _wn_conv(sd, f"{rp}.kernel_predictor.residual_convs.{j}.1")
            kp[f"res_{j}_b"] = _wn_conv(sd, f"{rp}.kernel_predictor.residual_convs.{j}.3")
        blk = {"kernel_predictor": kp,
               "convt_pre": _wn_conv(sd, f"{rp}.convt_pre.1", transpose=True)}
        for j in range(n_dilations):
            blk[f"conv_{j}"] = _wn_conv(sd, f"{rp}.conv_blocks.{j}.1")
        p[f"lvc_{i}"] = blk
    return p


def classifier_params(sd, depth: int = 5, resnet_blocks: int = 2,
                      attn_blocks: int = 4) -> dict:
    """reference AudioMiniEncoderWithClassifierHead -> models.classifier params."""
    enc = {"init": {"kernel": conv1d_kernel(sd["enc.init.0.weight"]),
                    "bias": t2n(sd["enc.init.0.bias"])}}
    idx = 0
    for _ in range(depth):
        for _ in range(resnet_blocks):
            enc[f"res_{idx}"] = resblock_params(sd, f"enc.res.{idx}")
            idx += 1
        enc[f"down_{idx}"] = {"conv": {"kernel": conv1d_kernel(sd[f"enc.res.{idx}.op.weight"]),
                                       "bias": t2n(sd[f"enc.res.{idx}.op.bias"])}}
        idx += 1
    enc["GroupNorm32_0"] = _groupnorm(sd, "enc.final.0")
    enc["final"] = {"kernel": conv1d_kernel(sd["enc.final.2.weight"]),
                    "bias": t2n(sd["enc.final.2.bias"])}
    for a in range(attn_blocks):
        enc[f"attn_{a}"] = attention_block_params(sd, f"enc.attn.{a}")
    return {"enc": enc,
            "head": {"kernel": dense_kernel(sd["head.weight"]),
                     "bias": t2n(sd["head.bias"])}}


def wav2vec2_params(sd, num_layers: int = 24, num_convs: int = 7) -> dict:
    """HF Wav2Vec2ForCTC (stable-layer-norm, layer-norm-extractor variant:
    the 'large-robust' architecture of the shipped aligner checkpoint,
    reference wav2vec_alignment.py:48-57) -> models/wav2vec2 params."""
    fe = {}
    for i in range(num_convs):
        cp = f"wav2vec2.feature_extractor.conv_layers.{i}"
        fe[f"conv_{i}"] = {"kernel": conv1d_kernel(sd[f"{cp}.conv.weight"]),
                           "bias": t2n(sd[f"{cp}.conv.bias"])}
        fe[f"ln_{i}"] = _layernorm(sd, f"{cp}.layer_norm")

    def layer(i):
        lp = f"wav2vec2.encoder.layers.{i}"
        qkv_w = np.concatenate([dense_kernel(sd[f"{lp}.attention.{m}_proj.weight"])
                                for m in ("q", "k", "v")], axis=1)
        qkv_b = np.concatenate([t2n(sd[f"{lp}.attention.{m}_proj.bias"])
                                for m in ("q", "k", "v")])
        return {
            "ln_attn": _layernorm(sd, f"{lp}.layer_norm"),
            "qkv": {"kernel": qkv_w, "bias": qkv_b},
            "attn_out": {"kernel": dense_kernel(sd[f"{lp}.attention.out_proj.weight"]),
                         "bias": t2n(sd[f"{lp}.attention.out_proj.bias"])},
            "ln_ff": _layernorm(sd, f"{lp}.final_layer_norm"),
            "ff_in": {"kernel": dense_kernel(
                          sd[f"{lp}.feed_forward.intermediate_dense.weight"]),
                      "bias": t2n(sd[f"{lp}.feed_forward.intermediate_dense.bias"])},
            "ff_out": {"kernel": dense_kernel(
                           sd[f"{lp}.feed_forward.output_dense.weight"]),
                       "bias": t2n(sd[f"{lp}.feed_forward.output_dense.bias"])},
        }

    stacked = stack_layers([layer(i) for i in range(num_layers)])

    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    # HF wraps the positional conv in weight_norm with dim=2 (the kernel axis)
    if f"{pc}.weight_g" in sd:
        w = fold_weight_norm(sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"], dim=2)
    elif f"{pc}.parametrizations.weight.original0" in sd:  # torch>=2.1 naming
        w = fold_weight_norm(sd[f"{pc}.parametrizations.weight.original0"],
                             sd[f"{pc}.parametrizations.weight.original1"], dim=2)
    else:
        w = t2n(sd[f"{pc}.weight"])
    return {
        "feature_extractor": fe,
        "proj_ln": _layernorm(sd, "wav2vec2.feature_projection.layer_norm"),
        "proj": {"kernel": dense_kernel(
                     sd["wav2vec2.feature_projection.projection.weight"]),
                 "bias": t2n(sd["wav2vec2.feature_projection.projection.bias"])},
        "pos_conv": {"kernel": np.ascontiguousarray(w.transpose(2, 1, 0)),
                     "bias": t2n(sd[f"{pc}.bias"])},
        "layers": {"layer": stacked},
        "encoder_ln": _layernorm(sd, "wav2vec2.encoder.layer_norm"),
        "lm_head": {"kernel": dense_kernel(sd["lm_head.weight"]),
                    "bias": t2n(sd["lm_head.bias"])},
    }
