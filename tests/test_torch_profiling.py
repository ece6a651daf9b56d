"""tortoise_tpu_torch.utils.profiling on the CPU: the device-time breakdown
on synthetic device events (busy time is the union of the intervals, each
event's time goes to the first family its name matches), ``device_events``
on a stub profile (it raises on a window with no device event), and
``trace``, the counterpart of the JAX package's, writing a Chrome trace of
a block."""
import glob
import json
import os
from types import SimpleNamespace

import pytest
import torch

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
    ("void tt::(anonymous namespace)::rows_gemm_kernel<1, 0>(...)", "K2 gemm"),
    ("tt::(anonymous namespace)::decode_attention_kernel(...)", "K2 attention"),
    ("void tt::(anonymous namespace)::rows_gemm_kernel<signed char, 1, 0>(...)", "K2 gemm int8"),
    ("void tt::(anonymous namespace)::decode_attention_kernel<signed char>(...)",
     "K2 attention int8"),
    ("flash_rel_attn_kernel", "K3"),
    ("void tt::(anonymous namespace)::decode_attn_merged_kernel<__nv_bfloat16, float>(...)",
     "K1"),
    ("void tt::(anonymous namespace)::merge_splits_kernel<__nv_bfloat16>(...)", "K1"),
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
    events = [ev("rows_gemm_kernel", 0, 1000), ev("decode_attention_kernel", 500, 1500),
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
