"""The launch plans of K4 (ops/lvc.py plan_lvc, which owns the stage
layout) and K6 (tools/bench_attn_body: its block and shared memory), on the
CPU: for UnivNet's three hops and every shape the GPU tests use, the shared
memory fits the H100's 227 KB and the threads divide as the kernels assume;
and the wrappers' ValueErrors fall where the C functions (csrc/lvc.cu
tt_lvc, csrc/attn_body.cu tt_attn_body) refuse, their checks transcribed
here."""
import pytest
import torch

from tortoise_tpu_torch.models.vocoder import random_predictor_output
from tortoise_tpu_torch.ops import lvc
from tortoise_tpu_torch.tools import bench_attn_body as k6

SMEM = 227 * 1024
# (b, f, hop) of UnivNet c32 (F=2186) and of tests/test_torch_kernels_gpu.py
K4_SHAPES = [(1, 2186, h) for h in (8, 64, 256)] + [
    (b, f, h) for h in (1, 4, 8, 16, 64, 128, 250, 256) for b, f in ((1, 1), (2, 37))]


def _tt_lvc_refuses(b, f, hop, ci, co, k, rows, frames, channels, w_frame=None, x_row=None,
                    smem=None) -> bool:
    """tt_lvc's argument checks (csrc/lvc.cu) of a plan with the given stage
    layout; by default the layout plan_lvc gives it (lvc.stage_layout, four
    stages)."""
    if (b < 1 or f < 1 or hop < 1 or ci < 1 or co < 8 or co % 8 or 256 % (co // 8)
            or k not in (1, 3, 5, 7) or rows not in (1, 2, 4, 8) or frames < 1 or channels < 1
            or frames * hop > 256 // (co // 8) * rows or (hop % rows and frames != 1)):
        return True
    layout = lvc.stage_layout(frames, hop, rows, channels, co, k)
    w_frame, x_row = w_frame or layout[0], x_row or layout[1]
    stage_bytes = 4 * (frames * w_frame + channels * x_row)
    smem = smem or 4 * stage_bytes
    x_reads = (rows + k - 1 + 3) // 4 * 4 if rows % 4 == 0 else rows + k - 1
    tile = frames * hop
    return (w_frame % 4 or x_row % 4 or w_frame < channels * co * k
            or x_row < ((tile + rows - 1) // rows - 1) * rows + x_reads
            or smem != 4 * stage_bytes or smem > SMEM)


@pytest.mark.parametrize("frames_innermost", [True, False], ids=["predictor", "blocks"])
@pytest.mark.parametrize("b,f,hop", K4_SHAPES)
def test_lvc_plan_fits_and_divides(b, f, hop, frames_innermost):
    ci, co, k = 32, 64, 3
    plan = lvc.plan_lvc(b, f, hop, ci, co, k, frames_innermost)
    rows, frames, channels = plan["rows_per_thread"], plan["frames"], plan["channels"]
    groups = plan["threads"] // (co // 8)
    assert plan["threads"] == 256 and 256 % (co // 8) == 0
    assert frames * hop <= groups * rows            # the tile's rows fit the block
    assert hop % rows == 0 or frames == 1           # a thread's rows stay in one frame
    assert 1 <= channels <= ci
    assert plan["smem"] <= SMEM and plan["tiles"] == b * -(-f // frames)
    assert not _tt_lvc_refuses(b, f, hop, ci, co, k, rows, frames, channels, plan["w_frame"],
                               plan["x_row"], plan["smem"])


@pytest.mark.parametrize("frames_innermost", [True, False], ids=["predictor", "blocks"])
def test_lvc_plan_of_univnet(frames_innermost):
    """hop=256: a frame a tile, 8 rows a thread; hop=8 shrinks the tile until
    the 2186 frames make two tiles an SM of the 132, all resident at once.
    hop=64: with each frame's block contiguous, 4 rows a thread, whose 1093
    tiles fill 92% of their third round's slots (8 rows: 547 tiles, 69%);
    with frames innermost, 8 rows a thread, whose 4-frame tiles use half of
    each 32-byte sector of the kernels (2 frames: a quarter)."""
    got = {hop: lvc.plan_lvc(1, 2186, hop, 32, 64, 3, frames_innermost) for hop in (8, 64, 256)}
    assert {h: (p["rows_per_thread"], p["frames"]) for h, p in got.items()} == \
        {8: (2, 8), 64: (8, 4) if frames_innermost else (4, 2), 256: (8, 1)}
    assert all(p["tiles"] >= lvc.TARGET_BLOCKS for p in got.values())
    assert got[8]["tiles"] == 274 <= lvc.SMS * lvc.BLOCKS_PER_SM[2]   # all resident at once


@pytest.mark.parametrize("co", [4, 12, 64, 96, 2048, 4096])
@pytest.mark.parametrize("k", [2, 3, 7, 9])
@pytest.mark.parametrize("hop", [1, 7, 250, 257, 1024, 4096])
def test_lvc_plan_refuses_what_the_kernel_refuses(co, k, hop):
    """plan_lvc raises ValueError exactly where no plan passes tt_lvc's
    checks; where it plans, tt_lvc takes the plan."""
    ci = 32
    any_ok = any(not _tt_lvc_refuses(2, 5, hop, ci, co, k, r, fr, 1)
                 for r in (1, 2, 4, 8) for fr in range(1, 4097) if fr * hop <= 4096 * 8)
    for frames_innermost in (False, True):
        if not any_ok:
            with pytest.raises(ValueError):
                lvc.plan_lvc(2, 5, hop, ci, co, k, frames_innermost)
            continue
        plan = lvc.plan_lvc(2, 5, hop, ci, co, k, frames_innermost)
        assert not _tt_lvc_refuses(2, 5, hop, ci, co, k, plan["rows_per_thread"], plan["frames"],
                                   plan["channels"], plan["w_frame"], plan["x_row"], plan["smem"])


@pytest.mark.parametrize("hop", [1, 8, 64, 250, 256])
@pytest.mark.parametrize("frames_innermost", [True, False], ids=["predictor", "blocks"])
def test_lvc_plan_layout_is_the_least_the_kernel_takes(hop, frames_innermost):
    """tt_lvc takes the plan's stage layout and refuses one a 16-byte piece
    shorter in a frame's weights or in a channel's x, or shared memory that
    is not four stages."""
    ci, co, k = 32, 64, 3
    plan = lvc.plan_lvc(2, 37, hop, ci, co, k, frames_innermost)
    args = (2, 37, hop, ci, co, k, plan["rows_per_thread"], plan["frames"], plan["channels"])
    w_frame, x_row = plan["w_frame"], plan["x_row"]
    ring = lambda w, xr: lvc.STAGES * 4 * (plan["frames"] * w + plan["channels"] * xr)
    assert plan["smem"] == ring(w_frame, x_row)
    assert not _tt_lvc_refuses(*args, w_frame, x_row, ring(w_frame, x_row))
    assert _tt_lvc_refuses(*args, w_frame - 8, x_row, ring(w_frame - 8, x_row))
    assert _tt_lvc_refuses(*args, w_frame, x_row - 4, ring(w_frame, x_row - 4))
    assert _tt_lvc_refuses(*args, w_frame, x_row, ring(w_frame, x_row) - 16)


def _k4_args(layout="predictor", channels_first=True, b=2, f=5, hop=8, ci=8, co=16, k=3):
    x = torch.zeros((b, ci, f * hop)).transpose(1, 2) if channels_first \
        else torch.zeros((b, f * hop, ci))
    kern, bias = random_predictor_output(torch.Generator().manual_seed(0), b, 4, f, ci, co, k)
    kern, bias = kern[:, 1], bias[:, 1]
    if layout == "blocks":
        kern = kern.contiguous()
    return x, kern, bias, hop


@pytest.mark.parametrize("layout", ["predictor", "blocks"])
@pytest.mark.parametrize("channels_first", [True, False])
def test_lvc_wrapper_takes_both_layouts(layout, channels_first):
    x, kern, bias, hop = _k4_args(layout, channels_first)
    plan, strides = lvc._check_cuda_args(x, kern, bias, hop)
    assert strides[2] == (5 if layout == "predictor" else 1)
    assert strides[1] == (1 if layout == "predictor" else 8 * 16 * 3)
    assert plan == lvc.plan_lvc(2, 5, hop, 8, 16, 3, layout == "predictor")


@pytest.mark.parametrize("bad,match", [
    (lambda x, kn, bs: (x.double(), kn, bs), "float32"),
    (lambda x, kn, bs: (torch.cat([x, x], -1)[..., ::2], kn, bs), "unit stride"),
    (lambda x, kn, bs: (x, kn.contiguous().transpose(3, 4).contiguous().transpose(3, 4), bs),
     "one run"),
    (lambda x, kn, bs: (x, kn.contiguous()[..., ::2, :], bs[..., ::2]), "one run"),
    (lambda x, kn, bs: (x, kn[..., :2].contiguous(), bs), "K in"),
    (lambda x, kn, bs: (x, kn[:, :, :, :12].contiguous(), bs[..., :12]), "Co a multiple of 8"),
])
def test_lvc_wrapper_refuses(bad, match):
    x, kern, bias, hop = _k4_args()
    with pytest.raises(ValueError, match=match):
        lvc._check_cuda_args(*bad(x, kern, bias), hop)


def test_lvc_wrapper_refuses_a_hop_past_the_block():
    x, kern, bias, _ = _k4_args(hop=1024, f=1, co=16)
    lvc._check_cuda_args(x, kern, bias, 1024)   # 256 / (16 / 8) row groups x 8 rows
    x, kern, bias, _ = _k4_args(hop=2048, f=1, co=16)
    with pytest.raises(ValueError, match="hop"):
        lvc._check_cuda_args(x, kern, bias, 2048)


# --- K6 -------------------------------------------------------------------------

# (b, t, pos, ck) of tests/test_torch_kernels_gpu.py and the tool's shape
K6_SHAPES = [(2, 128, 0, 32), (2, 128, 37, 32), (2, 128, 127, 32), (128, 768, 300, 64),
             (3, 96, 95, 96), (1, 128, 0, 32), (1, 768, 63, 64), (2, 192, 47, 48),
             (2, 192, 95, 96), (2, 96, 15, 24), (2, 256, 255, 256), (128, 768, 767, 768)]


def _tt_attn_body_refuses(b, t, c, pos, ck, variant) -> bool:
    """tt_attn_body's argument checks (csrc/attn_body.cu)."""
    if b < 1 or c < 64 or c % 64 or not 0 <= pos < t or ck < 1 or t % ck \
            or variant not in (0, 1):
        return True
    return 3 * 32 * 64 * 2 + ck * 4 > SMEM


@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("b,t,pos,ck", K6_SHAPES)
def test_attn_body_shapes_fit(variant, b, t, pos, ck):
    """K6's block at every GPU test's shape: within 227 KB, threads a whole
    number of head-row groups of eight, a ring stage of whole rows."""
    assert k6.THREADS % 8 == 0 and k6.STAGES >= 2 and k6.STAGE_ROWS % (k6.THREADS // 8) == 0
    assert k6.smem_bytes(ck) <= SMEM
    assert not _tt_attn_body_refuses(b, t, 1024, pos, ck, k6.VARIANTS.index(variant))
    q, k = torch.zeros((b, 1024), dtype=torch.bfloat16), torch.zeros((b, t, 1024),
                                                                     dtype=torch.bfloat16)
    k6.check_launch(q, k, k, pos, ck, variant)


@pytest.mark.parametrize("variant", ["a", "b", "c"])
@pytest.mark.parametrize("c,t,pos,ck", [(1024, 128, 0, 32), (1024, 128, 128, 32),
                                        (1024, 128, -1, 32), (1024, 100, 10, 64),
                                        (512, 128, 5, 128), (1000, 128, 5, 32),
                                        (1024, 16384, 5, 16384), (1024, 65536, 5, 65536)])
def test_attn_body_refuses_what_the_kernel_refuses(variant, c, t, pos, ck):
    q, k = torch.zeros((1, c), dtype=torch.bfloat16), torch.zeros((1, t, c),
                                                                  dtype=torch.bfloat16)
    code = k6.VARIANTS.index(variant) if variant in k6.VARIANTS else 2
    if _tt_attn_body_refuses(1, t, c, pos, ck, code):
        with pytest.raises(ValueError):
            k6.check_launch(q, k, k, pos, ck, variant)
    else:
        k6.check_launch(q, k, k, pos, ck, variant)
