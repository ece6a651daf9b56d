"""The hybrid (Granite-4.0-H) prior's benchmark files: a tiny cell of it runs
correct on the CPU and its control does not, its operation count is the
reference's, its kernel's bound counts what the kernel moves, and its
metrics read a traced window."""
import json
import os
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import control, run
from portbench.kernels import ssm_step
from portbench.reference import granite_hybrid as ref
from portbench.tests.test_portbench_harness import QUALITY_LIMITS, SEED, tiny

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..", "..")
OPTIONS = {"autoregressive_batch_size": 2}


def tiny_granite():
    bench, cell, _, limits = tiny("preset")
    bench["configs"] = [{"name": "tiny-granite", "file": os.path.join(HERE, "tiny-granite.json")}]
    return bench, dict(cell, config="tiny-granite"), limits


def test_a_tiny_granite_cell_is_correct():
    bench, cell, limits = tiny_granite()
    result, _ = run.run_cell(bench, cell, SEED, 0.5, False, device="cpu", options=OPTIONS,
                             limits=limits)
    assert result["correct"], result["checks"]
    assert result["metrics"]["audio_s_per_s"]["value"] > 0


def test_its_control_is_not_correct():
    bench, cell, limits = tiny_granite()
    r = control.readings(bench, cell, SEED, 0.5, device="cpu", options=OPTIONS,
                         limits=QUALITY_LIMITS)
    assert r["program_correct"] and not r["control_correct"]
    # the control's rounding of every operand and of the carried state to fp8
    assert r["control"]["latent_err"] > 5 * r["program"]["latent_err"]


def test_the_configuration_names_the_granite_reference():
    with open(os.path.join(ROOT, "portbench", "configs", "tortoise-granite-4.0-h-micro.json")) as f:
        config = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = next(c for c in json.load(f)["configs"]
                     if c["name"] == "tortoise-granite-4.0-h-micro")
    assert config["reference"] == {"autoregressive": "granite_hybrid"}
    ar = config["autoregressive"]
    cfg = ref.config(ar)
    # the published trunk, as the top-level copy of its config.json has it
    assert entry["source"] == config["source"] and entry["reduced"] == config["reduced"] == []
    assert [i for i, t in enumerate(config["layer_types"]) if t == "attention"] \
        == list(cfg.attention_layers)
    for key, published in (("layers", "num_hidden_layers"), ("model_dim", "hidden_size"),
                           ("shared_intermediate_size", "shared_intermediate_size"),
                           ("num_attention_heads", "num_attention_heads"),
                           ("num_key_value_heads", "num_key_value_heads"),
                           ("mamba_n_heads", "mamba_n_heads"), ("mamba_d_head", "mamba_d_head"),
                           ("mamba_d_state", "mamba_d_state"), ("mamba_expand", "mamba_expand"),
                           ("mamba_d_conv", "mamba_d_conv"), ("mamba_n_groups", "mamba_n_groups"),
                           ("mamba_chunk_size", "mamba_chunk_size"),
                           ("attention_multiplier", "attention_multiplier"),
                           ("embedding_multiplier", "embedding_multiplier"),
                           ("residual_multiplier", "residual_multiplier"),
                           ("logits_scaling", "logits_scaling"), ("rms_norm_eps", "rms_norm_eps")):
        assert ar[key] == config[published], key
    assert config["diffusion"]["in_latent_channels"] == ar["model_dim"]


def test_trunk_ops_is_the_reference_forwards_count():
    """``trunk_ops`` against ``FlopCounterMode`` over the reference's layers:
    the counter sees the products (projections, the conv, the state's output
    product, the attention's two products over all t x t pairs); the state's
    update is elementwise, which ``trunk_ops`` counts as 2 H P N a token, and
    the attention counts the causal half of the pairs."""
    ar = dict(layers=3, model_dim=64, attention_layers=[1], num_attention_heads=2,
              num_key_value_heads=1, mamba_n_heads=4, mamba_d_head=32, mamba_d_state=16,
              shared_intermediate_size=96, conditioning_heads=2)
    model = ref.build(ar)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    t = 7
    h = torch.randn(1, t, ar["model_dim"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        for layer in model.layers:
            h = layer(h, 0.22)
    cfg = ref.config(ar)
    mamba_layers = ar["layers"] - 1
    update = mamba_layers * t * 2 * cfg.mamba_n_heads * cfg.mamba_d_head * cfg.mamba_d_state
    all_pairs, causal = t * t, t * (t + 1) // 2
    attention = 4 * cfg.num_attention_heads * cfg.head_dim * (all_pairs - causal)
    assert counter.get_total_flops() + update - attention == ref.trunk_ops(ar, 1, t, 0)
    # a decode step after a context: its keys are the context and itself
    assert ref.trunk_ops(ar, 5, 1, 40) == 5 * (ref.trunk_ops(ar, 1, 1, 0) + 4 * 40
                                               * cfg.num_attention_heads * cfg.head_dim)


def test_the_kernel_bound_counts_the_state_once_each_way():
    ops, nbytes = ssm_step.step(96)
    state = 96 * 64 * 64 * 128
    # x, B, C and dt; the conv state read and written; its weights and bias;
    # dt_bias, A_log and D; y in float32
    rest = 2 * 96 * (4352 + 64) + 4 * 96 * 4352 * 3 + 2 * 4352 * 5 + 12 * 64 + 4 * 96 * 4096
    assert nbytes == 208_805_120 == 4 * state + rest
    assert ops == 6 * state + 2 * 96 * 4352 * 4
    assert ssm_step.bound(96) == pytest.approx(nbytes / 3.35e12)       # bytes bound it


def _ctx(device_ops, steps=(5, 7)):
    with open(os.path.join(ROOT, "portbench", "configs", "tortoise-granite-4.0-h-micro.json")) as f:
        config = json.load(f)
    served = [types.SimpleNamespace(ar_steps=n, batch=96) for n in steps]
    return types.SimpleNamespace(config=config, served=served,
                                 trace={"device_ops": device_ops, "by_family": {}})


def test_the_roofline_metric_reads_the_kernels_device_time():
    read = lambda ctx: run.read_metric("ssm_step_roofline_pct", ctx)
    bound = 12 * 36 * ssm_step.bound(96)
    ctx = _ctx([["void tt::(anonymous namespace)::ssm_decode_step_kernel(...)", 2 * bound],
                ["sm90_xmma_gemm_bf16bf16", 1.0]])
    assert read(ctx) == pytest.approx(50.0)
    assert read(_ctx([["sm90_xmma_gemm_bf16bf16", 1.0]])) is None     # a parent's trace
