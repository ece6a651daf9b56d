"""Faults planted in the hybrid prior's decode path, served at the size of
cell ``granite-quality-fast`` and judged by its own limits: each must come
out not correct through ``ar_gap``, the one number that judges the decode
(``latent_err`` judges the teacher-forced re-extraction, which runs the
chunked scan and not the decode step). The sound program, at the same seed,
must come out correct.

The faults: the B and C channels' conv state left unshifted after each
step; the SSM state not carried from step to step (zeroed before each); one
candidate row of the fan-out left as the last request's (a stale row). The
kernel cannot be changed at run time: the faults are made around its call,
inside the decode step's CUDA graph.

Smaller faults pass the cell. With the stored state one bf16 step low
before each step (the decay off by that step) ``ar_gap`` read 0.080, and
sixteen steps low 0.206, against 0.062 for the sound program at this seed
(H100): the sound program reads up to 0.230 over 24 seeds, so no limit
parts them. On these random weights dt A is about -1.9, so the state
carries little past a token or two. Kernel S1's own check against its plain
version holds such faults (``chip_smoke.py`` phase 17).

On the card only (without CUDA the cases skip), about a minute a case:

    python3 -m pytest --noconftest -m gpu -s portbench/tests/test_portbench_granite_faults_gpu.py
"""
import os

import pytest
import torch

from portbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..", "..")
CELL = "granite-quality-fast"
SEED = 2 ** 31 + 2207


def _around_the_kernel(monkeypatch, before=None, after=None):
    from tortoise_tpu_torch.models import granite_hybrid

    kernel = granite_hybrid.ssm_decode_step

    def planted(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, counters):
        kept = before(conv_state, state) if before else None
        y = kernel(xbc, dt, conv_state, conv_w, conv_b, dt_bias, a_log, d, state, counters)
        if after:
            after(conv_state, state, kept)
        return y

    planted.launches = 0
    monkeypatch.setattr(granite_hybrid, "ssm_decode_step", planted)


def _bc_shift_skipped(monkeypatch):
    d_state = 128
    _around_the_kernel(monkeypatch,
                       before=lambda conv, state: conv[:, -2 * d_state:].clone(),
                       after=lambda conv, state, kept: conv[:, -2 * d_state:].copy_(kept))


def _state_not_carried(monkeypatch):
    _around_the_kernel(monkeypatch, before=lambda conv, state: state.zero_())


def _fanout_row_stale(monkeypatch):
    from tortoise_tpu_torch.models.granite_hybrid import GraniteVoice

    prefill = GraniteVoice.prefill

    def planted(self, prompt, cache):
        kept = cache["ssm"][:, -1].clone(), cache["conv"][:, -1].clone()
        out = prefill(self, prompt, cache)
        cache["ssm"][:, -1].copy_(kept[0])
        cache["conv"][:, -1].copy_(kept[1])
        return out

    monkeypatch.setattr(GraniteVoice, "prefill", planted)


FAULTS = {"none": None, "bc_shift_skipped": _bc_shift_skipped,
          "state_not_carried": _state_not_carried, "fanout_row_stale": _fanout_row_stale}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", list(FAULTS))
def test_the_cell_catches_a_decode_fault(fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its full size")
    bench = run.load_json(ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch)
    result, lines = run.run_cell(bench, cell, SEED, 0.0, False)
    gap = result["checks"]["ar_gap"]
    print(f"{CELL} seed {SEED}, {fault}: ar_gap {gap['value']} (limit {gap['limit']}), "
          f"correct {result['correct']}; checks {result['checks']}")
    if fault == "none":
        assert result["correct"], lines
    else:
        assert gap["value"] > gap["limit"] and not result["correct"], lines
