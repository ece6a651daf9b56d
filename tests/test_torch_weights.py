"""Weights into the port: convert/from_jax.py covers every parameter of each
slice model, and a reference-layout state dict reaches the port through the
numpy converters (the JAX package's tortoise_tpu/convert/torch_import.py
here, the port's own copy in load_weights)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_import_hygiene import run_without_jax
from tortoise_tpu.convert import torch_import as ti
from tortoise_tpu_torch import weights as port_weights
from tortoise_tpu_torch.convert.from_jax import from_jax

torch.set_num_threads(2)

D, LAYERS, HEADS = 64, 2, 2  # tiny widths; the vocoder has one fixed config


def _jax_ar():
    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice as P
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig as PC

    kw = dict(layers=LAYERS, model_dim=D, heads=HEADS, max_text_tokens=20, max_mel_tokens=30)
    return (init_unified_voice(UnifiedVoice(UnifiedVoiceConfig(**kw)), 0)["params"],
            P(PC(**kw)))


def _jax_diffusion():
    from tortoise_tpu.models.diffusion_decoder import (DiffusionTts, DiffusionTtsConfig,
                                                       init_diffusion_tts)
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTts as P
    from tortoise_tpu_torch.models.diffusion_decoder import DiffusionTtsConfig as PC

    kw = dict(model_channels=D, num_layers=LAYERS, in_latent_channels=D, num_heads=HEADS)
    return (init_diffusion_tts(DiffusionTts(DiffusionTtsConfig(**kw)),
                               jax.random.PRNGKey(0))["params"], P(PC(**kw)))


def _clvp_kw():
    return dict(dim_text=D, dim_speech=D, dim_latent=D, text_enc_depth=LAYERS,
                text_heads=HEADS, speech_enc_depth=LAYERS, speech_heads=HEADS)


def _jax_clvp():
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.clvp import CLVP as P
    from tortoise_tpu_torch.models.clvp import CLVPConfig as PC

    jm = CLVP(CLVPConfig(**_clvp_kw()))
    return (jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                    jnp.zeros((1, 4), jnp.int32))["params"], P(PC(**_clvp_kw())))


def _jax_clvp_plain():
    """CLVP's plain-Transformer variant (use_xformers=False)."""
    from tortoise_tpu.models.clvp import CLVP, CLVPConfig
    from tortoise_tpu_torch.models.clvp import CLVP as P
    from tortoise_tpu_torch.models.clvp import CLVPConfig as PC

    kw = dict(_clvp_kw(), use_xformers=False, text_seq_len=40)
    jm = CLVP(CLVPConfig(**kw))
    return (jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
                    jnp.zeros((1, 4), jnp.int32))["params"], P(PC(**kw)))


def _jax_vocoder():
    from tortoise_tpu.models.vocoder import UnivNetConfig, UnivNetGenerator
    from tortoise_tpu_torch.models.vocoder import UnivNetGenerator as P

    jm = UnivNetGenerator(UnivNetConfig())
    return (jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 12, 100)),
                    jnp.zeros((1, 12, 64)))["params"], P())


def _jax_ar_int8():
    """UnifiedVoice with QuantDense block denses: int8 kernels, qscale, bias."""
    from tortoise_tpu.models.autoregressive import (UnifiedVoice, UnifiedVoiceConfig,
                                                    init_unified_voice)
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoice as P
    from tortoise_tpu_torch.models.autoregressive import UnifiedVoiceConfig as PC

    kw = dict(layers=LAYERS, model_dim=D, heads=HEADS, max_text_tokens=20, max_mel_tokens=30,
              quant_weights=True)
    params = init_unified_voice(UnifiedVoice(UnifiedVoiceConfig(**kw)), 0)["params"]
    assert params["gpt"]["h_scan"]["block"]["attn"]["c_attn"]["kernel"].dtype == jnp.int8
    return params, P(PC(**kw))


HIFI = dict(in_channels=D, upsample_initial_channel=64, cond_channels=D)


def _jax_hifigan():
    from tortoise_tpu.models.hifigan import HifiganConfig, HifiganGenerator
    from tortoise_tpu_torch.models.hifigan import HifiganConfig as PC
    from tortoise_tpu_torch.models.hifigan import HifiganGenerator as P

    jm = HifiganGenerator(HifiganConfig(**HIFI))
    return (jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, D)), jnp.zeros((1, D)))["params"],
            P(PC(**HIFI)))


def _jax_rlg(channels):
    def make():
        from tortoise_tpu.models.random_latent import RandomLatentConverter
        from tortoise_tpu_torch.models.random_latent import RandomLatentConverter as P

        jm = RandomLatentConverter(channels)
        return jm.init(jax.random.PRNGKey(0), jnp.zeros((1, channels)))["params"], P(channels)
    return make


CVVP_KW = dict(model_dim=D, transformer_heads=HEADS, conditioning_enc_depth=LAYERS,
               speech_enc_depth=LAYERS)


def _jax_cvvp():
    from tortoise_tpu.models.cvvp import CVVP, CVVPConfig
    from tortoise_tpu_torch.models.cvvp import CVVP as P
    from tortoise_tpu_torch.models.cvvp import CVVPConfig as PC

    jm = CVVP(CVVPConfig(**CVVP_KW))
    return (jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                    jnp.zeros((1, 8), jnp.int32))["params"], P(PC(**CVVP_KW)))


CLS = dict(embedding_dim=32, base_channels=8, depth=LAYERS, attn_blocks=2)


def _jax_classifier():
    from tortoise_tpu.models.classifier import (AudioMiniEncoderWithClassifierHead,
                                                ClassifierConfig)
    from tortoise_tpu_torch.models.classifier import AudioMiniEncoderWithClassifierHead as P
    from tortoise_tpu_torch.models.classifier import ClassifierConfig as PC

    jm = AudioMiniEncoderWithClassifierHead(ClassifierConfig(**CLS))
    return jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 1)))["params"], P(PC(**CLS))


# the SMALL config of tests/test_wav2vec2_parity.py
W2V = dict(vocab_size=11, hidden_size=32, num_layers=LAYERS, num_heads=4, intermediate_size=64,
           conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _jax_wav2vec2():
    from tortoise_tpu.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC
    from tortoise_tpu_torch.models.wav2vec2 import Wav2Vec2Config as PC
    from tortoise_tpu_torch.models.wav2vec2 import Wav2Vec2ForCTC as P

    jm = Wav2Vec2ForCTC(Wav2Vec2Config(**W2V))
    return jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3200)))["params"], P(PC(**W2V))


MODELS = {"autoregressive": _jax_ar, "diffusion_decoder": _jax_diffusion, "clvp": _jax_clvp,
          "clvp_plain": _jax_clvp_plain,
          "vocoder": _jax_vocoder, "autoregressive_int8": _jax_ar_int8,
          "hifidecoder": _jax_hifigan, "rlg_auto": _jax_rlg(D), "rlg_diffuser": _jax_rlg(2 * D),
          "cvvp": _jax_cvvp, "classifier": _jax_classifier, "wav2vec2": _jax_wav2vec2}


@pytest.mark.parametrize("name", list(MODELS))
def test_from_jax_covers_every_parameter(name):
    params, port = MODELS[name]()
    sd = from_jax(port, params)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)
    # the layout change is a transpose, never a copy of something else
    some = next(k for k in sd if k.endswith("weight") and sd[k].ndim >= 2)
    assert sd[some].shape == port.state_dict()[some].shape


# --- reference (tortoise-tts) state-dict layouts, random values -----------

def _r(*shape):
    return torch.randn(shape) * 0.1


def _attn_block(sd, p, ch, heads, rel):
    sd.update({f"{p}.norm.weight": _r(ch), f"{p}.norm.bias": _r(ch),
               f"{p}.qkv.weight": _r(3 * ch, ch, 1), f"{p}.qkv.bias": _r(3 * ch),
               f"{p}.proj_out.weight": _r(ch, ch, 1), f"{p}.proj_out.bias": _r(ch)})
    if rel:
        sd[f"{p}.relative_pos_embeddings.relative_attention_bias.weight"] = _r(32, heads)


def _ref_autoregressive():
    sd = {"conditioning_encoder.init.weight": _r(D, 80, 1),
          "conditioning_encoder.init.bias": _r(D),
          "text_embedding.weight": _r(256, D), "mel_embedding.weight": _r(8194, D),
          "text_pos_embedding.emb.weight": _r(22, D), "mel_pos_embedding.emb.weight": _r(34, D),
          "gpt.ln_f.weight": _r(D), "gpt.ln_f.bias": _r(D),
          "final_norm.weight": _r(D), "final_norm.bias": _r(D),
          "text_head.weight": _r(256, D), "text_head.bias": _r(256),
          "mel_head.weight": _r(8194, D), "mel_head.bias": _r(8194)}
    for i in range(6):
        _attn_block(sd, f"conditioning_encoder.attn.{i}", D, HEADS, rel=False)
    for i in range(LAYERS):
        h = f"gpt.h.{i}"
        for n in ("ln_1", "ln_2"):
            sd.update({f"{h}.{n}.weight": _r(D), f"{h}.{n}.bias": _r(D)})
        for n, (i_, o_) in {"attn.c_attn": (D, 3 * D), "attn.c_proj": (D, D),
                            "mlp.c_fc": (D, 4 * D), "mlp.c_proj": (4 * D, D)}.items():
            sd.update({f"{h}.{n}.weight": _r(i_, o_), f"{h}.{n}.bias": _r(o_)})
    return sd, lambda s: ti.unified_voice_params(s, layers=LAYERS)


def _resblock(sd, p, ch):
    sd.update({f"{p}.in_layers.0.weight": _r(ch), f"{p}.in_layers.0.bias": _r(ch),
               f"{p}.in_layers.2.weight": _r(ch, ch, 1), f"{p}.in_layers.2.bias": _r(ch),
               f"{p}.emb_layers.1.weight": _r(2 * ch, ch), f"{p}.emb_layers.1.bias": _r(2 * ch),
               f"{p}.out_layers.0.weight": _r(ch), f"{p}.out_layers.0.bias": _r(ch),
               f"{p}.out_layers.3.weight": _r(ch, ch, 3), f"{p}.out_layers.3.bias": _r(ch)})


def _ref_diffusion():
    c = D
    sd = {}
    for name, shape in {"inp_block": (c, 100, 3), "time_embed.0": (c, c),
                        "time_embed.2": (c, c), "latent_conditioner.0": (c, c, 3),
                        "contextual_embedder.0": (c, 100, 3),
                        "contextual_embedder.1": (2 * c, c, 3),
                        "integrating_conv": (c, 2 * c, 1), "mel_head": (100, c, 3),
                        "out.2": (200, c, 3)}.items():
        sd.update({f"{name}.weight": _r(*shape), f"{name}.bias": _r(shape[0])})
    for name in ("code_norm", "out.0"):
        sd.update({f"{name}.weight": _r(c), f"{name}.bias": _r(c)})
    sd["code_embedding.weight"] = _r(8193, c)
    sd["unconditioned_embedding"] = _r(1, c, 1)
    for i in range(3):
        _attn_block(sd, f"code_converter.{i}", c, HEADS, rel=True)
        _resblock(sd, f"conditioning_timestep_integrator.{i}.resblk", c)
        _attn_block(sd, f"conditioning_timestep_integrator.{i}.attn", c, HEADS, rel=True)
        _resblock(sd, f"layers.{LAYERS + i}", c)
    for i in range(4):
        _attn_block(sd, f"latent_conditioner.{i + 1}", c, HEADS, rel=True)
    for i in range(5):
        _attn_block(sd, f"contextual_embedder.{i + 2}", 2 * c, HEADS, rel=True)
    for i in range(LAYERS):
        _resblock(sd, f"layers.{i}.resblk", c)
        _attn_block(sd, f"layers.{i}.attn", c, HEADS, rel=True)
    return sd, lambda s: ti.diffusion_tts_params(s, num_layers=LAYERS)


def _ref_clvp():
    inner, ff = HEADS * 64, 2 * D
    sd = {"text_emb.weight": _r(256, D), "speech_emb.weight": _r(8192, D),
          "to_text_latent.weight": _r(D, D), "to_speech_latent.weight": _r(D, D),
          "temperature": torch.tensor(1.0)}
    for enc in ("text_transformer", "speech_transformer"):
        p = f"{enc}.transformer"
        sd.update({f"{p}.norm.weight": _r(D), f"{p}.norm.bias": _r(D)})
        for d in range(LAYERS):
            a, f = f"{p}.attn_layers.layers.{2 * d}", f"{p}.attn_layers.layers.{2 * d + 1}"
            sd.update({f"{a}.0.0.g": _r(D), f"{f}.0.0.g": _r(D),
                       f"{a}.1.wrap.to_q.weight": _r(inner, D),
                       f"{a}.1.wrap.to_k.weight": _r(inner, D),
                       f"{a}.1.wrap.to_v.weight": _r(inner, D),
                       f"{a}.1.wrap.to_out.weight": _r(D, inner),
                       f"{a}.1.wrap.to_out.bias": _r(D),
                       f"{f}.1.wrap.net.0.proj.weight": _r(2 * ff, D),
                       f"{f}.1.wrap.net.0.proj.bias": _r(2 * ff),
                       f"{f}.1.wrap.net.3.weight": _r(D, ff), f"{f}.1.wrap.net.3.bias": _r(D)})
    return sd, ti.clvp_params


def _ref_clvp_plain():
    """The reference's use_xformers=False layout (transformer.py:182-219):
    LayerScale(PreNorm(fn)) pairs under layers.layers.{i}.{0,1}, learned
    position tables."""
    inner, ff = HEADS * 64, 4 * D
    sd = {"text_emb.weight": _r(256, D), "speech_emb.weight": _r(8192, D),
          "text_pos_emb.weight": _r(40, D), "speech_pos_emb.weight": _r(8192, D),
          "to_text_latent.weight": _r(D, D), "to_speech_latent.weight": _r(D, D),
          "temperature": torch.tensor(1.0)}
    for enc in ("text_transformer", "speech_transformer"):
        for i in range(LAYERS):
            a, f = f"{enc}.layers.layers.{i}.0", f"{enc}.layers.layers.{i}.1"
            sd.update({f"{a}.scale": _r(1, 1, D), f"{f}.scale": _r(1, 1, D),
                       f"{a}.fn.norm.weight": _r(D), f"{a}.fn.norm.bias": _r(D),
                       f"{f}.fn.norm.weight": _r(D), f"{f}.fn.norm.bias": _r(D),
                       f"{a}.fn.fn.to_qkv.weight": _r(3 * inner, D),
                       f"{a}.fn.fn.to_out.0.weight": _r(D, inner),
                       f"{a}.fn.fn.to_out.0.bias": _r(D),
                       f"{f}.fn.fn.net.0.weight": _r(2 * ff, D),
                       f"{f}.fn.fn.net.0.bias": _r(2 * ff),
                       f"{f}.fn.fn.net.3.weight": _r(D, ff), f"{f}.fn.fn.net.3.bias": _r(D)})
    return sd, ti.clvp_params


def _wn(sd, p, shape):
    sd.update({f"{p}.weight_g": _r(shape[0], 1, 1).abs() + 0.5, f"{p}.weight_v": _r(*shape),
               f"{p}.bias": _r(shape[1] if p.endswith("convt_pre.1") else shape[0])})


def _ref_vocoder():
    sd = {}
    _wn(sd, "conv_pre", (32, 64, 7))
    _wn(sd, "conv_post.1", (1, 32, 7))
    for i, s in enumerate((8, 8, 4)):
        kp = f"res_stack.{i}.kernel_predictor"
        _wn(sd, f"{kp}.input_conv.0", (64, 100, 5))
        for j in range(3):
            _wn(sd, f"{kp}.residual_convs.{j}.1", (64, 64, 3))
            _wn(sd, f"{kp}.residual_convs.{j}.3", (64, 64, 3))
        _wn(sd, f"{kp}.kernel_conv", (32 * 64 * 3 * 4, 64, 3))
        _wn(sd, f"{kp}.bias_conv", (64 * 4, 64, 3))
        _wn(sd, f"res_stack.{i}.convt_pre.1", (32, 32, 2 * s))
        for j in range(4):
            _wn(sd, f"res_stack.{i}.conv_blocks.{j}.1", (32, 32, 3))
    return sd, ti.univnet_params


def _wn_hifi(sd, p, shape, out_ch):
    sd.update({f"{p}.weight_g": _r(shape[0], 1, 1).abs() + 0.5, f"{p}.weight_v": _r(*shape),
               f"{p}.bias": _r(out_ch)})


def _ref_hifigan():
    """reference HifiganGenerator: weight-normed convs, ConvTranspose1d
    weights (in, out, K), ResBlock1 convs1/convs2."""
    sd = {"cond_layer.weight": _r(64, D, 1), "cond_layer.bias": _r(64)}
    _wn_hifi(sd, "conv_pre", (64, D, 7), 64)
    ch = 64
    for i, k in enumerate((16, 16, 4, 4)):
        _wn_hifi(sd, f"ups.{i}", (ch, ch // 2, k), ch // 2)
        ch //= 2
        for j, rk in enumerate((3, 7, 11)):
            for n in range(3):
                for conv in ("convs1", "convs2"):
                    _wn_hifi(sd, f"resblocks.{3 * i + j}.{conv}.{n}", (ch, ch, rk), ch)
    _wn_hifi(sd, "conv_post", (1, ch, 7), 1)
    return sd, ti.hifigan_params


def _ref_rlg(channels):
    def make():
        sd = {}
        for i in range(6):
            sd.update({f"layers.{i}.weight": _r(channels, channels),
                       f"layers.{i}.bias": _r(channels)})
        return sd, ti.rlg_params
    return make


def _xtransformer(sd, p, dim, heads, depth, ff_mult, wrap):
    """reference x-transformers Encoder layers under ``p`` (CheckpointedLayer
    '.wrap' indirection when ``wrap``)."""
    inner, ff = heads * 64, int(dim * ff_mult)
    sd.update({f"{p}.norm.weight": _r(dim), f"{p}.norm.bias": _r(dim)})
    for d in range(depth):
        a, f = f"{p}.attn_layers.layers.{2 * d}", f"{p}.attn_layers.layers.{2 * d + 1}"
        sd.update({f"{a}.0.0.g": _r(dim), f"{f}.0.0.g": _r(dim),
                   f"{a}.1{wrap}.to_q.weight": _r(inner, dim),
                   f"{a}.1{wrap}.to_k.weight": _r(inner, dim),
                   f"{a}.1{wrap}.to_v.weight": _r(inner, dim),
                   f"{a}.1{wrap}.to_out.weight": _r(dim, inner),
                   f"{a}.1{wrap}.to_out.bias": _r(dim),
                   f"{f}.1{wrap}.net.0.proj.weight": _r(2 * ff, dim),
                   f"{f}.1{wrap}.net.0.proj.bias": _r(2 * ff),
                   f"{f}.1{wrap}.net.3.weight": _r(dim, ff), f"{f}.1{wrap}.net.3.bias": _r(dim)})


def _ref_cvvp():
    """reference CVVP: two conditioning convs, CollapsingTransformers
    (unwrapped x-transformers, ff_mult 1, pre_combiner conv/attention/conv),
    the speech codes' embedding under speech_emb.emb."""
    sd = {"cond_emb.0.weight": _r(D // 2, 80, 5), "cond_emb.0.bias": _r(D // 2),
          "cond_emb.1.weight": _r(D, D // 2, 3), "cond_emb.1.bias": _r(D),
          "to_conditioning_latent.weight": _r(D, D), "to_speech_latent.weight": _r(D, D),
          "speech_emb.emb.weight": _r(8192, D), "temperature": torch.tensor(1.0)}
    for enc in ("conditioning_transformer", "speech_transformer"):
        _xtransformer(sd, f"{enc}.transformer", D, HEADS, LAYERS, 1.0, "")
        sd.update({f"{enc}.pre_combiner.0.weight": _r(D, D, 1),
                   f"{enc}.pre_combiner.0.bias": _r(D),
                   f"{enc}.pre_combiner.2.weight": _r(D, D, 1),
                   f"{enc}.pre_combiner.2.bias": _r(D)})
        _attn_block(sd, f"{enc}.pre_combiner.1", D, HEADS, rel=False)
    return sd, lambda s: ti.cvvp_params(s, cond_depth=LAYERS, speech_depth=LAYERS)


def _ref_classifier():
    """reference AudioMiniEncoderWithClassifierHead: init conv, a ResBlock
    pyramid with strided-conv downsamples (enc.res.{i}.op), final norm and
    1x1 conv, attention blocks, linear head."""
    k, ch = 5, CLS["base_channels"]
    emb = CLS["embedding_dim"]
    sd = {"enc.init.0.weight": _r(ch, 1, 3), "enc.init.0.bias": _r(ch),
          "head.weight": _r(2, emb), "head.bias": _r(2)}
    idx = 0
    for _ in range(CLS["depth"]):
        for _ in range(2):
            p = f"enc.res.{idx}"
            sd.update({f"{p}.in_layers.0.weight": _r(ch), f"{p}.in_layers.0.bias": _r(ch),
                       f"{p}.in_layers.2.weight": _r(ch, ch, k), f"{p}.in_layers.2.bias": _r(ch),
                       f"{p}.out_layers.0.weight": _r(ch), f"{p}.out_layers.0.bias": _r(ch),
                       f"{p}.out_layers.3.weight": _r(ch, ch, k),
                       f"{p}.out_layers.3.bias": _r(ch)})
            idx += 1
        sd.update({f"enc.res.{idx}.op.weight": _r(2 * ch, ch, 5),
                   f"enc.res.{idx}.op.bias": _r(2 * ch)})
        idx += 1
        ch *= 2
    sd.update({"enc.final.0.weight": _r(ch), "enc.final.0.bias": _r(ch),
               "enc.final.2.weight": _r(emb, ch, 1), "enc.final.2.bias": _r(emb)})
    for a in range(CLS["attn_blocks"]):
        _attn_block(sd, f"enc.attn.{a}", emb, 4, rel=False)
    return sd, lambda s: ti.classifier_params(s, depth=CLS["depth"],
                                              attn_blocks=CLS["attn_blocks"])


def _ref_wav2vec2(naming="weight_g"):
    """HF Wav2Vec2ForCTC (stable layer norm, layer-norm feature extractor) at
    W2V, built by hand: the positional conv's weight norm (dim=2) under the
    old ``weight_g``/``weight_v`` keys or torch>=2.1's parametrization keys;
    ``masked_spec_embed`` is a training parameter the converter skips."""
    c, ff, k = W2V["hidden_size"], W2V["intermediate_size"], W2V["num_conv_pos_embeddings"]
    sd = {"wav2vec2.masked_spec_embed": _r(c),
          "wav2vec2.feature_projection.layer_norm.weight": _r(16),
          "wav2vec2.feature_projection.layer_norm.bias": _r(16),
          "wav2vec2.feature_projection.projection.weight": _r(c, 16),
          "wav2vec2.feature_projection.projection.bias": _r(c),
          "wav2vec2.encoder.layer_norm.weight": _r(c), "wav2vec2.encoder.layer_norm.bias": _r(c),
          "wav2vec2.encoder.pos_conv_embed.conv.bias": _r(c),
          "lm_head.weight": _r(W2V["vocab_size"], c), "lm_head.bias": _r(W2V["vocab_size"])}
    g, v = _r(1, 1, k).abs() + 0.5, _r(c, c // W2V["num_conv_pos_embedding_groups"], k)
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    if naming == "weight_g":
        sd.update({f"{pc}.weight_g": g, f"{pc}.weight_v": v})
    else:
        sd.update({f"{pc}.parametrizations.weight.original0": g,
                   f"{pc}.parametrizations.weight.original1": v})
    in_ch = 1
    for i, (o, kk) in enumerate(zip(W2V["conv_dim"], W2V["conv_kernel"])):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}"
        sd.update({f"{p}.conv.weight": _r(o, in_ch, kk), f"{p}.conv.bias": _r(o),
                   f"{p}.layer_norm.weight": _r(o), f"{p}.layer_norm.bias": _r(o)})
        in_ch = o
    for i in range(W2V["num_layers"]):
        p = f"wav2vec2.encoder.layers.{i}"
        for n in ("layer_norm", "final_layer_norm"):
            sd.update({f"{p}.{n}.weight": _r(c), f"{p}.{n}.bias": _r(c)})
        for m in ("q", "k", "v", "out"):
            sd.update({f"{p}.attention.{m}_proj.weight": _r(c, c),
                       f"{p}.attention.{m}_proj.bias": _r(c)})
        sd.update({f"{p}.feed_forward.intermediate_dense.weight": _r(ff, c),
                   f"{p}.feed_forward.intermediate_dense.bias": _r(ff),
                   f"{p}.feed_forward.output_dense.weight": _r(c, ff),
                   f"{p}.feed_forward.output_dense.bias": _r(c)})
    return sd, lambda s: ti.wav2vec2_params(s, num_layers=W2V["num_layers"],
                                            num_convs=len(W2V["conv_dim"]))


REFERENCE = {"autoregressive": _ref_autoregressive, "diffusion_decoder": _ref_diffusion,
             "clvp": _ref_clvp, "clvp_plain": _ref_clvp_plain, "vocoder": _ref_vocoder, "hifidecoder": _ref_hifigan,
             "rlg_auto": _ref_rlg(D), "rlg_diffuser": _ref_rlg(2 * D), "cvvp": _ref_cvvp,
             "classifier": _ref_classifier, "wav2vec2": _ref_wav2vec2}


@pytest.mark.parametrize("name", list(REFERENCE))
def test_reference_layout_loads_through_torch_import(name):
    torch.manual_seed(0)
    sd, convert = REFERENCE[name]()
    _, port = MODELS[name]()
    missing, unexpected = port.load_state_dict(from_jax(port, convert(sd)), strict=False)
    assert not missing and not unexpected
    if name == "autoregressive":  # HF Conv1D (in, out) -> torch Linear (out, in)
        np.testing.assert_array_equal(port.gpt.h_scan.block.attn.c_attn.weight[1].detach(),
                                      sd["gpt.h.1.attn.c_attn.weight"].T)
    if name == "diffusion_decoder":   # the discrete-code path, carried through
        for port_w, ref_w in ((port.code_embedding.weight, sd["code_embedding.weight"]),
                              (port.code_converter_2.qkv.weight,
                               sd["code_converter.2.qkv.weight"][:, :, 0]),
                              (port.mel_head.weight, sd["mel_head.weight"])):
            np.testing.assert_array_equal(port_w.detach(), ref_w)
    if name == "hifidecoder":     # the transposed conv's kernel, un-flipped: torch's own
        np.testing.assert_allclose(port.up_1.weight.detach().numpy(), ti.fold_weight_norm(
            sd["ups.1.weight_g"], sd["ups.1.weight_v"]), rtol=1e-6)


def test_load_weights_reads_a_reference_checkpoint(tmp_path):
    torch.manual_seed(0)
    sd, _ = _ref_vocoder()
    torch.save({"model_g": sd}, tmp_path / "vocoder.pth")
    _, port = MODELS["vocoder"]()
    assert port_weights.load_weights("vocoder", port, str(tmp_path), False, 0) == "reference"
    want = ti.fold_weight_norm(sd["conv_pre.weight_g"], sd["conv_pre.weight_v"])
    np.testing.assert_allclose(port.conv_pre.weight.detach().numpy(), want, rtol=1e-6)
    with pytest.raises(FileNotFoundError):
        port_weights.load_weights("clvp", MODELS["clvp"]()[1], str(tmp_path), False, 0)


@pytest.mark.parametrize("name", ["autoregressive", "diffusion_decoder", "clvp", "hifidecoder",
                                  "rlg_auto", "cvvp", "classifier", "wav2vec2"])
def test_reference_checkpoint_loads_without_jax(name, tmp_path):
    """Where neither jax nor the JAX package can be imported (the GPU
    machine), the port's own converters (layers stacked with numpy) give
    the weights the JAX package's converters give."""
    torch.manual_seed(0)
    sd, convert = REFERENCE[name]()
    _, port = MODELS[name]()
    want = from_jax(port, convert(sd))
    torch.save(sd, tmp_path / port_weights.REFERENCE_CHECKPOINTS[name])
    torch.save(port, tmp_path / "model.pt")
    proc = run_without_jax(f"""
        import torch
        from tortoise_tpu_torch.weights import load_weights
        model = torch.load({str(tmp_path / "model.pt")!r}, weights_only=False)
        assert load_weights({name!r}, model, {str(tmp_path)!r}, False, 0) == "reference"
        assert "jax" not in sys.modules
        torch.save(model.state_dict(), {str(tmp_path / "got.pt")!r})
    """)
    assert proc.returncode == 0, proc.stderr
    got = torch.load(tmp_path / "got.pt")
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_wav2vec2_weight_norm_namings():
    """The positional conv's weight norm folds over dim 2 (the kernel axis)
    the same under both key namings, in the port's converter and the JAX
    package's, and the grouped kernel lands in the port's (out, in/groups,
    K) weight."""
    from tortoise_tpu_torch.convert import torch_import as port_ti

    torch.manual_seed(0)
    old, _ = _ref_wav2vec2("weight_g")
    torch.manual_seed(0)
    new, _ = _ref_wav2vec2("parametrizations")
    pc = "wav2vec2.encoder.pos_conv_embed.conv"
    want = ti.fold_weight_norm(old[f"{pc}.weight_g"], old[f"{pc}.weight_v"], dim=2)
    np.testing.assert_allclose(np.linalg.norm(want[:, :, 3]),
                               old[f"{pc}.weight_g"][0, 0, 3].item(), rtol=1e-5)
    _, port = MODELS["wav2vec2"]()
    for sd in (old, new):
        for conv in (port_ti.wav2vec2_params, ti.wav2vec2_params):
            params = conv(sd, num_layers=LAYERS, num_convs=2)
            got = from_jax(port, params)["pos_conv.weight"]
            assert got.shape == (32, 8, 16)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_float32_device_turns_tf32_off(monkeypatch):
    """float32_device: on CUDA, cuBLAS and cuDNN keep float32 products in
    float32 (cuDNN's default is TF32); asking for CUDA without a card
    raises; the CPU leaves the flags as they are."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert port_weights.float32_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_weights.float32_device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_weights.float32_device("cuda:0") == torch.device("cuda:0")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_random_init_is_seeded_and_full():
    from tortoise_tpu_torch.models.clvp import CLVP, CLVPConfig

    a, b = CLVP(CLVPConfig(**_clvp_kw())), CLVP(CLVPConfig(**_clvp_kw()))
    port_weights.init_random(a, 5)
    port_weights.init_random(b, 5)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
        assert torch.isfinite(x).all(), k
    w = a.text_transformer.layers_scan.attn.to_q.weight
    assert abs(w.std().item() - D ** -0.5) < 0.1 * D ** -0.5
    port_weights.cast_for_inference(a, torch.bfloat16)
    assert w.dtype == torch.bfloat16
    assert a.text_transformer.layers_scan.attn_norm.g.dtype == torch.float32


def test_int8_model_quantizes_a_float_reference_checkpoint(tmp_path):
    """gpt_weights="int8": a full-precision reference checkpoint loads into
    QuantDense layers quantized per output channel, as the JAX package's
    quantize_gpt_weights does on its converted tree."""
    from tortoise_tpu import weights as jax_weights

    torch.manual_seed(0)
    sd, convert = _ref_autoregressive()
    torch.save(sd, tmp_path / "autoregressive.pth")
    _, port = MODELS["autoregressive_int8"]()
    assert port_weights.load_weights("autoregressive", port, str(tmp_path), False, 0) == \
        "reference"
    want = jax_weights.quantize_gpt_weights(convert(sd))["gpt"]["h_scan"]["block"]["mlp_fc"]
    got = port.gpt.h_scan.block.mlp_fc
    assert got.weight.dtype == torch.int8
    np.testing.assert_array_equal(got.weight.numpy(), np.swapaxes(want["kernel"], -1, -2))
    np.testing.assert_array_equal(got.qscale.detach().numpy(), want["qscale"])


def test_random_init_of_int8_and_random_latent_layers():
    """QuantDense: int8 weights uniform in [-127, 127], qscale
    1/(127 sqrt(in)); EqualLinear: N(0, 1/lr_mul^2); and qscale stays f32
    under cast_for_inference."""
    from tortoise_tpu_torch.models.layers import QuantDense
    from tortoise_tpu_torch.models.random_latent import RandomLatentConverter

    q = QuantDense(256, 64, lead=(2,))
    port_weights.init_random(q, 3)
    w = q.weight.numpy()
    assert w.dtype == np.int8 and w.min() == -127 and w.max() == 127
    assert abs(w.astype(np.float32).std() - 254 / np.sqrt(12)) < 3
    np.testing.assert_allclose(q.qscale.detach().numpy(), 1 / (127 * 16.0), rtol=1e-6)
    port_weights.cast_for_inference(q, torch.bfloat16)
    assert q.qscale.dtype == torch.float32 and q.bias.dtype == torch.bfloat16
    r = RandomLatentConverter(64)
    port_weights.init_random(r, 3)
    assert abs(r.eq_0.weight.std().item() - 10.0) < 0.5 and not r.eq_0.bias.any()
