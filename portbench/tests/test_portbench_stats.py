"""The arithmetic of the metrics: percentiles, rates, merged busy
time and the idle gaps of a trace."""
import pytest

from portbench import stats, trace


def test_percentile_matches_inclusive_quantiles():
    values = [float(v) for v in range(1, 201)]
    assert stats.percentile(values, 95) == pytest.approx(190.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == pytest.approx(1.5)


def test_rate():
    assert stats.rate(30.0, 10.0, 25.0) == 2.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 5.0, 5.0)


def test_merged_busy_time():
    spans = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 41)]
    assert trace.merge(spans) == [[0, 15], [20, 31], [40, 41]]
    assert trace.busy(spans) == 15 + 11 + 1


def test_families_first_match_wins():
    assert trace.family("void tc_gemm_kernel<signed char, 64>") == "K2 gemm int8"
    assert trace.family("void tc_gemm_kernel<__nv_bfloat16>") == "K2 gemm"
    assert trace.family("flash_rel_attn_kernel<1>") == "K3"
    assert trace.family("lvc_kernel") == "K4"
    assert trace.family("sm90_xmma_gemm_f32") == "cuBLAS/cuDNN"
    assert trace.family("elementwise_kernel") == "other"


def test_reduce_names_gaps_by_the_innermost_host_op():
    ms = 1_000_000
    device = [("tc_gemm_kernel", 0, 2 * ms), ("split_attention_kernel", 1 * ms, 3 * ms),
              ("split_attention_kernel", 2 * ms, 3 * ms),
              ("flash_rel_attn_kernel", 10 * ms, 11 * ms)]
    host = [("portbench.window", 0, 12 * ms), ("aten::item", 4 * ms, 9 * ms),
            ("portbench.window", 5 * ms, 6 * ms),
            ("cudaStreamSynchronize", 5 * ms, 8 * ms)]
    red = trace.reduce(device, host, (0, 12 * ms))
    assert red["busy_s"] == pytest.approx(4e-3)
    assert red["window_s"] == pytest.approx(12e-3)
    assert red["by_family"]["K2 gemm"] == pytest.approx(2e-3)
    assert red["by_family"]["K2 attention"] == pytest.approx(2e-3)
    assert red["by_family"]["K3"] == pytest.approx(1e-3)
    assert red["idle_gaps"][0] == ["cudaStreamSynchronize", pytest.approx(7e-3)]
    assert red["idle_gaps"][1] == ["host outside any torch op", pytest.approx(1e-3)]
    assert red["device_ops"][0] == ["split_attention_kernel", pytest.approx(3e-3)]
