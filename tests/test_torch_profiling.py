"""The device-time breakdown of tortoise_tpu_torch.utils.profiling on
synthetic device events: busy time is the union of the intervals, each
event's time goes to the first family its name matches."""
import pytest

from tortoise_tpu_torch.utils import profiling


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
