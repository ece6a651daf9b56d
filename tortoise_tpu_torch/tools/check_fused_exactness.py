"""K2's exactness on the card: a teacher-forced replay against the layer stack.

Counterpart of ``tools/check_fused_exactness.py``, flag for flag. A seeded
random UnifiedVoice in bf16 (the shipped 30 x 1024 x 16, or with ``--tiny``
2 layers 256 wide) first decodes greedily on the layer stack (K1 in every
layer over the bf16 cache), then re-feeds that token stream step by step
through the layer stack and through K2 (``fused_step``), so each step sees
the same history on both paths and the comparison isolates one step's
error from the cascade of a free-running decode. For the bf16 and the int8
cache it reports:

* ``forced_agreement``: the share of (step, row) whose greedy token the two
  paths agree on;
* ``decisive_agreement``: the same over the steps whose layer-stack top-1
  logit leads the second by more than 0.125, a few bf16 quanta (random
  weights give near-ties that two correct paths may break differently).
  The bar is 1.0;
* ``hidden_rel_drift_max``: the largest difference of the final-norm
  latents over the largest latent;
* ``flip_margins``: the stack's top-1 margins at the disagreeing steps;
* ``stack_replay_self_consistency``: the forced stack replay against its
  own decode on the decisive steps (must be 1.0: a check of the method);
* ``free_run_agreement``: two free-running greedy decodes, stack and K2.

The replay uses repetition_penalty 1.0, so the greedy decode is a plain
argmax. ``ok`` is every cache's decisive agreement at least 0.999, its
self-consistency 1.0 and its drift under 0.05.

    python3 -m tortoise_tpu_torch.tools.check_fused_exactness [--steps 32] [--batch 2] [--tiny]

``--device cpu`` holds K2's plain version to the layer stack (for tests).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tortoise_tpu_torch import weights as weights_lib
from tortoise_tpu_torch.models import ar_sampler
from tortoise_tpu_torch.models.autoregressive import UnifiedVoice, UnifiedVoiceConfig
from tortoise_tpu_torch.ops.decode_step import prepare_stacked_params
from tortoise_tpu_torch.utils import measure

DECISIVE_MARGIN = 0.125
CACHES = (("bf16_cache", torch.bfloat16), ("int8_cache", torch.int8))


def forced_replay(model, settings, stacked, cache_dtype, cond, text, forced, batch: int):
    """Feed ``forced`` (B, n) tokens after the prompt's prefill; returns each
    step's greedy token (n, B), its top-1 margin (n, B) and its final-norm
    latent (n, B, D), as numpy."""
    gen = torch.Generator(device=cond.device).manual_seed(0)
    state, _ = ar_sampler._prefill(model, cond, text, gen, batch, settings, cache_dtype)
    preds, margins, latents = [], [], []
    for i in range(forced.shape[1]):
        emb = model.decode_embed(forced[:, i:i + 1], i)
        h = ar_sampler._gpt_step(model, settings, stacked, emb, state.cache, state.pos + i)
        logits = model.hidden_to_mel_logits(h).float()
        top2 = logits.topk(2, dim=-1).values
        preds.append(logits.argmax(-1))
        margins.append(top2[:, 0] - top2[:, 1])
        latents.append(model.hidden_to_latent(h).float())
    return tuple(torch.stack(x).cpu().numpy() for x in (preds, margins, latents))


def check_cache(model, stacked, cache_dtype, cond, text, batch: int, steps: int) -> dict:
    cfg = model.config
    base = ar_sampler.SamplerSettings(do_sample=False, max_generate=steps,
                                      repetition_penalty=1.0)
    fused = ar_sampler.SamplerSettings(do_sample=False, max_generate=steps,
                                       repetition_penalty=1.0, fused_step=True)
    gen = lambda: torch.Generator(device=cond.device).manual_seed(5)
    codes_ref, _ = ar_sampler.sample_speech(model, cond, text, gen(), batch, base, cache_dtype)
    codes_fused, _ = ar_sampler.sample_speech(model, cond, text, gen(), batch, fused,
                                              cache_dtype, stacked=stacked)
    free = float((codes_ref == codes_fused).float().mean())
    forced, want = codes_ref[:, :-1], codes_ref[:, 1:].cpu().numpy()
    p_s, m_s, h_s = forced_replay(model, base, None, cache_dtype, cond, text, forced, batch)
    p_f, _, h_f = forced_replay(model, fused, stacked, cache_dtype, cond, text, forced, batch)
    # the sampler latches the stop token once emitted (the replay's raw
    # argmax has no latch): compare the steps before it
    live = ~(np.cumsum(want.T == cfg.stop_mel_token, axis=0) > 0)
    agree = p_s == p_f
    decisive = (m_s > DECISIVE_MARGIN) & live
    share = lambda mask, of: float(mask[of].mean()) if of.any() else 1.0
    return {"forced_agreement": share(agree, live),
            "decisive_agreement": share(agree, decisive),
            "decisive_steps": int(decisive.sum()),
            "hidden_rel_drift_max": float(np.abs(h_s - h_f).max()
                                          / max(np.abs(h_s).max(), 1e-9)),
            "flip_margins": [float(v) for v in m_s[~agree & live][:8]],
            "stack_replay_self_consistency": share(p_s == want.T, decisive),
            "free_run_agreement": free}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--tiny", action="store_true",
                        help="2-layer, 256-wide config (the shipped 30 x 1024 by default)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser


@torch.inference_mode()
def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = measure.cuda_device(args.device, "check_fused_exactness")
    if args.tiny:
        cfg = UnifiedVoiceConfig(layers=2, model_dim=256, heads=4, max_text_tokens=40,
                                 max_mel_tokens=64)
    else:
        cfg = UnifiedVoiceConfig()
    with torch.device(dev):
        model = UnifiedVoice(cfg)
    weights_lib.init_random(model, 0)
    model = weights_lib.cast_for_inference(model, torch.bfloat16).eval()
    stacked = prepare_stacked_params(model.gpt)
    g = torch.Generator(device=dev).manual_seed(2)
    cond = torch.randn((1, cfg.model_dim), generator=g, device=dev).to(torch.bfloat16)
    text = torch.tensor([[10, 20, 30, 40, 50, 0]], device=dev)
    steps = min(args.steps, cfg.max_mel_tokens - 8)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "config": {"layers": cfg.layers, "model_dim": cfg.model_dim, "heads": cfg.heads},
           "steps": steps, "batch": args.batch, "rows": {}}
    for name, cache_dtype in CACHES:
        row = out["rows"][name] = check_cache(model, stacked, cache_dtype, cond, text,
                                              args.batch, steps)
        print(f"{name}: forced={row['forced_agreement']:.4f} "
              f"decisive={row['decisive_agreement']:.4f} ({row['decisive_steps']} steps) "
              f"drift={row['hidden_rel_drift_max']:.2e} free_run={row['free_run_agreement']:.4f}")
    out["ok"] = all(r["decisive_agreement"] >= 0.999 and r["stack_replay_self_consistency"] == 1.0
                    and r["hidden_rel_drift_max"] < 0.05 for r in out["rows"].values())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
