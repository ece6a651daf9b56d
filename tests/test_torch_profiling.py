"""tortoise_tpu_torch.utils.profiling on the CPU: the device-time breakdown
on synthetic device events (busy time is the union of the intervals, each
event's time goes to the first family its name matches), ``device_events``
on a stub profile (it raises on a window with no device event), ``trace``,
the counterpart of the JAX package's, writing a Chrome trace of a block,
and the span recorder (``span``, ``request``, ``spans``, ``StageTimer``)
with and without a profiler running."""
import glob
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tortoise_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.mark.parametrize("name,fam", [
    ("void tt::(anonymous namespace)::tc_gemm_kernel<__nv_bfloat16, 1, 0, 2>(...)", "K2 gemm"),
    ("void tt::(anonymous namespace)::tc_gemm_kernel<signed char, 0, 2, 8>(...)", "K2 gemm int8"),
    ("void tt::(anonymous namespace)::row_stats_kernel(...)", "K2 gemm"),
    ("void tt::(anonymous namespace)::split_attention_kernel<__nv_bfloat16>(...)",
     "K2 attention"),
    ("void tt::(anonymous namespace)::split_attention_kernel<signed char>(...)",
     "K2 attention int8"),
    ("flash_rel_attn_kernel", "K3"),
    ("void tt::(anonymous namespace)::decode_attn_merged_kernel<__nv_bfloat16, float>(...)",
     "K1"),
    ("void tt::(anonymous namespace)::lvc_kernel<16>(...)", "K4"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "cuBLAS/cuDNN"),
    ("nvjet_hsh_64x32_64x16_2x1_v_bz_splitK_TNN", "cuBLAS/cuDNN"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "cuBLAS/cuDNN"),
    ("void at::native::vectorized_elementwise_kernel<4>", "other"),
])
def test_kernel_families(name, fam):
    assert profiling.family(name) == fam


def test_busy_time_is_the_union_of_intervals():
    ev = lambda name, s, e: {"name": name, "start_us": s, "end_us": e}
    events = [ev("tc_gemm_kernel", 0, 1000), ev("split_attention_kernel", 500, 1500),
              ev("flash_rel_attn_kernel", 3000, 4000), ev("elementwise", 3500, 3600)]
    out = profiling.device_breakdown(events)
    assert out["device_busy_ms"] == pytest.approx(2.5)
    assert out["device_span_ms"] == pytest.approx(4.0)
    assert out["ms_by_family"] == pytest.approx(
        {"K2 gemm": 1.0, "K2 attention": 1.0, "K3": 1.0, "other": 0.1})
    assert out["n_device_events"] == 4
    assert profiling.device_breakdown([])["device_busy_ms"] == 0.0


class _StubProfile:
    """Stands in for a finished torch.profiler session: ``events()`` only."""

    def __init__(self, *events):
        self._events = events

    def events(self):
        return list(self._events)


def _event(name, device_type, start, end):
    return SimpleNamespace(name=name, device_type=device_type,
                           time_range=SimpleNamespace(start=start, end=end))


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def test_a_window_without_device_events_raises():
    prof = _StubProfile(_event("aten::mm", CPU, 0, 10), _event("cudaLaunchKernel", CPU, 2, 4))
    with pytest.raises(RuntimeError, match="no CUDA device event in 8 profiled steps"):
        profiling.device_events(prof, "8 profiled steps")


def test_device_events_are_the_cuda_events():
    prof = _StubProfile(_event("aten::mm", CPU, 0, 10),
                        _event("flash_rel_attn_kernel", CUDA, 5, 25))
    assert profiling.device_events(prof, "one K3 call") == [
        {"name": "flash_rel_attn_kernel", "start_us": 5, "end_us": 25}]


def _trace_file(log_dir) -> dict:
    files = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    log_dir = tmp_path / "new" / "trace"
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    with profiling.trace(str(log_dir)) as got:
        torch.mm(a, b)
    assert got == str(log_dir)
    names = {e.get("name") for e in _trace_file(log_dir)["traceEvents"]}
    assert "aten::mm" in names


def test_trace_writes_and_reraises_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside the block"):
        with profiling.trace(str(tmp_path)):
            torch.mm(torch.randn(8, 8), torch.randn(8, 8))
            raise ValueError("inside the block")
    names = {e.get("name") for e in _trace_file(tmp_path)["traceEvents"]}
    assert "aten::mm" in names


def test_trace_yields_log_dir_as_the_jax_trace_does(tmp_path):
    """The contract the two share: the context yields the ``log_dir`` it was
    given (their files differ: an XLA profile against a Chrome trace)."""
    from tortoise_tpu.utils import profiling as jax_profiling

    with jax_profiling.trace(str(tmp_path / "jax")) as want:
        pass
    with profiling.trace(str(tmp_path / "torch")) as got:
        pass
    assert want == str(tmp_path / "jax") and got == str(tmp_path / "torch")


# --- spans --------------------------------------------------------------------

def _boom(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler running")


@profiling.request
def _answer(steps):
    with profiling.span("tts.prepare"):
        pass
    with profiling.span("tts.autoregressive"):
        for i in range(steps):
            with profiling.span("tts.ar.step", rows=2, kind="greedy"):
                pass
    return steps


@profiling.request
def _stream(chunks):
    for i in range(chunks):
        with profiling.span("tts.hifigan"):
            pass
        yield i


def _tree():
    """(name, parent's name, request id) of every recorded span."""
    return [(s.name, s.parent.name if s.parent else None, s.request) for s in profiling.spans()]


def test_without_a_profiler_a_span_records_nothing_and_enters_no_range(monkeypatch):
    """One shared no-op: no ``record_function``, no record, and the
    stage totals of StageTimer kept all the same."""
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _boom)
    profiling.spans().clear()
    assert profiling.span("tts.a") is profiling.span("tts.b", rows=3)
    timer = profiling.StageTimer()
    with timer.stage("autoregressive"):
        assert _answer(3) == 3 and list(_stream(2)) == [0, 1]
    assert profiling.spans() == []
    assert set(timer.report()) == {"autoregressive"} and timer.report()["autoregressive"] > 0


def test_spans_nest_with_their_parents_and_request_ids():
    """Each request span opens a new request id, its children inherit it; a
    generator's request is no parent between its resumes, so the caller's
    spans stay outside it; spans outside any request have none."""
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.spans().clear()
        with profiling.span("tts.outside"):
            pass
        _answer(2)
        for _ in _stream(2):
            with profiling.span("tts.consumer"):
                pass
    got = _tree()
    first, second = got[1][2], got[6][2]
    assert first is not None and second is not None and first != second
    assert got == [("tts.outside", None, None),
                   ("tts.request", None, first), ("tts.prepare", "tts.request", first),
                   ("tts.autoregressive", "tts.request", first),
                   ("tts.ar.step", "tts.autoregressive", first),
                   ("tts.ar.step", "tts.autoregressive", first),
                   ("tts.request", None, second), ("tts.hifigan", "tts.request", second),
                   ("tts.consumer", None, None), ("tts.hifigan", "tts.request", second),
                   ("tts.consumer", None, None)]
    spans = profiling.spans()
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in spans)
    assert spans[4].attrs == {"rows": 2, "kind": "greedy"}
    # the stream's request span lasts until the generator is exhausted
    assert spans[6].end_ns >= spans[-1].end_ns


def test_a_closed_stream_ends_its_request_span():
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.spans().clear()
        chunks = _stream(5)
        next(chunks)
        chunks.close()
        with profiling.span("tts.after"):
            pass
    assert [(s.name, s.end_ns is not None) for s in profiling.spans()] == [
        ("tts.request", True), ("tts.hifigan", True), ("tts.after", True)]
    assert profiling.spans()[-1].parent is None


@pytest.mark.parametrize("value", [torch.ones(()), 1.5, np.int64(3)],
                         ids=["tensor", "float", "numpy_int"])
def test_a_span_attr_other_than_an_int_or_a_str_raises(value):
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(TypeError, match="ints and strings"):
            with profiling.span("tts.ar.step", rows=value):
                pass


def test_trace_clears_the_spans_on_entry(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        _answer(1)
    assert profiling.spans()
    with profiling.trace(str(tmp_path)):
        assert profiling.spans() == []
        _answer(2)
    assert [s.name for s in profiling.spans()].count("tts.ar.step") == 2
    names = [e.get("name") for e in _trace_file(tmp_path)["traceEvents"]]
    assert names.count("tts.ar.step") == 2 and names.count("tts.request") == 1


def test_spans_agree_with_the_profilers_ranges_within_a_millisecond():
    """Each span's start and end are on kineto's clock: within 1 ms of its
    ``record_function`` event (a range's first use in a process takes about
    a millisecond of set-up: one span before)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.spans().clear()
        with profiling.span("tts.first"):
            pass
        with profiling.span("tts.request"):
            for i in range(5):
                with profiling.span(f"tts.step{i}"):
                    time.sleep(0.002)
    spans = profiling.spans()[1:]
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()}
    for s in spans:
        start, end = events[s.name]
        assert abs(s.start_ns - start) < 1_000_000 and abs(s.end_ns - end) < 1_000_000, s.name
        assert s.end_ns - s.start_ns >= (2_000_000 if s.name != "tts.request" else 10_000_000)


def test_stage_timer_stage_is_a_span_and_keeps_its_totals():
    timer = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.spans().clear()
        for _ in range(2):
            with timer.stage("diffusion"):
                time.sleep(0.001)
        with timer.stage("vocoder"):
            pass
    assert [s.name for s in profiling.spans()] == ["tts.diffusion"] * 2 + ["tts.vocoder"]
    report = timer.report()
    assert list(report) == ["diffusion", "vocoder"] and report["diffusion"] >= 0.002
    assert len(timer.stages) == 3
