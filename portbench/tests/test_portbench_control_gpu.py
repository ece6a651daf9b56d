"""The control on the card at a size a test run holds: the tiny pipelines
(head width 64, as the kernels take) served by the port with its kernels,
judged by the reference, and the reference a step lower in precision in
the program's place, each decided against the limits of the tiny runs: the
program comes out correct and the control not. The cell-size readings come
from ``python3 -m portbench.control``, which decides each seed against the
cell's own ``limits/<cell>.json`` (PERF.md gives them)."""
import os

import pytest
import torch

from portbench import control
from portbench.tests.test_portbench_harness import FAST_LIMITS, QUALITY_LIMITS

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.gpu
@pytest.mark.parametrize("config,traffic", [("tiny-fast", "tiny-stream"),
                                            ("tiny-fast", "tiny-batch"),
                                            ("tiny-quality", "tiny-preset")])
def test_the_control_reads_above_the_program(config, traffic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = {"configs": [{"name": config, "file": os.path.join(HERE, f"{config}.json")}]}
    cell = {"name": "t", "config": config, "chips": 1,
            "traffic": os.path.join(HERE, f"{traffic}.json")}
    limits = dict(QUALITY_LIMITS if config == "tiny-quality" else FAST_LIMITS)
    if traffic == "tiny-stream":
        limits.pop("latent_err")
    if config == "tiny-quality":
        # two candidates' score spread is narrow: the card's bf16 CLVP read
        # 0.016-0.069 of it, its fp8 control 0.096-0.63 (seeds 11-13, H100)
        limits["clvp_err"] = 0.2
    for seed in (11, 12, 13):
        r = control.readings(bench, cell, seed, 1.0, device="cuda", limits=limits)
        print(config, traffic, seed, r["program"], r["control"])
        assert r["judged"] >= 1
        assert r["program_correct"] and not r["control_correct"], r
