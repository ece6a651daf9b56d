"""K4: UnivNet's location-variable convolution, as a CUDA kernel
(csrc/lvc.cu) and its plain PyTorch version.

Port of ``tortoise_tpu/ops/lvc_pallas.py::location_variable_convolution_pallas``:
x (B, F*hop, Ci), kernels (B, F, Ci, Co, K), bias (B, F, Co) -> (B, F*hop,
Co). Each hop-long frame of x is convolved with its own kernel, 'same'
padding, the halo taken from the neighbouring frames and zeros past the
ends. The kernel adds the bias in its epilogue; ``plan_lvc`` is its launch
plan (rows a thread, frames a block, input channels a stage, and the
stage's layout in shared memory), the one place that picks them.

``location_variable_convolution_lvc`` dispatches on the device of ``x``:
CPU tensors run ``location_variable_convolution_lvc_plain``, CUDA tensors
launch the kernel (or raise).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_KERNEL = _build.Kernel("lvc", "tt_lvc", [_P] * 4 + [_I] * 6 + [_L] * 9 + [_I] * 6)


def location_variable_convolution_lvc_plain(x, kernels, bias, hop: int):
    """The Pallas body's arithmetic: per frame, the (hop + K - 1, Ci) window
    with its halo; the sum over taps of a shifted (hop, Ci) @ (Ci, Co)
    product in f32; cast to x's dtype; plus the bias."""
    b, t, ci = x.shape
    _, f, _, co, k = kernels.shape
    if t != f * hop:
        raise ValueError(f"length mismatch: {t} != {f}*{hop}")
    p = (k - 1) // 2
    xw = F.pad(x, (0, 0, p, p)).unfold(1, hop + k - 1, hop)      # (B, F, Ci, hop + K - 1)
    acc = torch.zeros((b, f, hop, co), dtype=torch.float32, device=x.device)
    for tap in range(k):
        acc = acc + torch.einsum("bfis,bfio->bfso", xw[..., tap:tap + hop].float(),
                                 kernels[..., tap].float())
    out = acc.to(x.dtype) + bias[:, :, None, :].to(x.dtype)
    return out.reshape(b, f * hop, co)


# the kernel's shape (csrc/lvc.cu): 256 threads, a thread 8 output channels
# by R rows, a ring of four stages (tt_lvc refuses a plan whose shared
# memory is not four of its stages), and the blocks an SM its registers
# allow at each R (its launch bounds, kMinBlocks)
THREADS, OUT_PER_THREAD, STAGES = 256, 8, 4
BLOCKS_PER_SM = {8: 2, 4: 3, 2: 3, 1: 3}
TAPS = (1, 3, 5, 7)
# the H100: 132 SMs, 228 KB of shared memory an SM (1 KB of it reserved a
# block), 227 KB a block at most
SMS, SM_SMEM, BLOCK_SMEM_RESERVED, SMEM_LIMIT = 132, 228 * 1024, 1024, 227 * 1024
# two blocks an SM: fewer tiles leave SMs without a stream of bytes
TARGET_BLOCKS = 2 * SMS
# a stage's bytes at most
STAGE_BYTES = 28 * 1024
# the bytes of a memory sector: a block reading the predictor's
# frames-innermost kernels uses `frames` adjacent floats of each sector
SECTOR_BYTES = 32


def x_reads(rows: int, k: int) -> int:
    """Floats of x a thread with R rows loads from its first row on, as
    lvc.cu's x_reads: R + K - 1, rounded up to whole 16-byte loads when R
    is a multiple of 4."""
    return -(-(rows + k - 1) // 4) * 4 if rows % 4 == 0 else rows + k - 1


def stage_layout(frames: int, hop: int, rows: int, channels: int, co: int,
                 k: int) -> tuple[int, int]:
    """(w_frame, x_row): the floats of one frame's weights and of one
    channel's x segment in a stage. A stage is every frame's (channels, Co,
    K) weights, each padded by 4 floats so that the transposing copies of
    neighbouring frames fall on other banks, then each channel's x segment,
    long enough for the loads of the last thread with rows. tt_lvc takes
    the layout from here and refuses one its loads would overrun."""
    last = (-(-(frames * hop) // rows) - 1) * rows
    return channels * co * k + 4, -(-(last + x_reads(rows, k)) // 4) * 4


def _stage_bytes(frames: int, hop: int, rows: int, channels: int, co: int, k: int) -> int:
    w_frame, x_row = stage_layout(frames, hop, rows, channels, co, k)
    return 4 * (frames * w_frame + channels * x_row)


def plan_lvc(b: int, f: int, hop: int, ci: int, co: int, k: int,
             frames_innermost: bool = False) -> dict:
    """The launch plan of tt_lvc for x (b, f*hop, ci) and (ci, co, k) kernels,
    laid out with each frame's block contiguous or, with
    ``frames_innermost``, as the kernel predictor leaves them.

    A block's 256 threads hold 256 / (co / 8) row groups of R rows, and a
    tile is "frames" = groups x R // hop whole frames (at least one; R
    divides hop unless the tile is one frame). For each R in (8, 4, 2, 1),
    "channels" is the most input channels a stage (a power of two, at most
    ci) whose stage fits STAGE_BYTES and whose ring leaves room for the
    BLOCKS_PER_SM[R] blocks the registers allow; the slots are the blocks
    the card holds at once, and the score is the share of the last round's
    slots that the tiles fill (1 in a single round) times min(1, tiles /
    TARGET_BLOCKS), and with frames innermost times the share of each
    32-byte sector of the kernels that a tile's frames use.
    "rows_per_thread" is the R of the best score, the larger R on a tie; a
    block takes each of the "tiles"; "w_frame", "x_row" and "smem" are its
    stage_layout and the ring's bytes. Raises ValueError for what the kernel
    refuses (tt_lvc's conditions)."""
    if co % OUT_PER_THREAD or co < OUT_PER_THREAD or THREADS % (co // OUT_PER_THREAD):
        raise ValueError(f"the LVC kernel takes Co a multiple of 8 with Co / 8 dividing "
                         f"{THREADS}; got Co={co}")
    if k not in TAPS:
        raise ValueError(f"the LVC kernel takes K in {TAPS}; got K={k}")
    groups = THREADS // (co // OUT_PER_THREAD)
    max_rows = groups * max(BLOCKS_PER_SM)   # the block's rows at R = 8
    if not 1 <= hop <= max_rows:
        raise ValueError(f"the LVC kernel takes hop <= {max_rows} (16384 / Co) at Co={co}; "
                         f"got hop={hop}")
    best = None
    for rows in sorted(BLOCKS_PER_SM, reverse=True):
        frames = groups * rows // hop
        if frames < 1 or (hop % rows and frames != 1):
            continue
        # a stage within STAGE_BYTES and a ring that leaves room for the
        # blocks the registers allow
        room = min(STAGE_BYTES, (SM_SMEM // BLOCKS_PER_SM[rows] - BLOCK_SMEM_RESERVED) // STAGES)
        channels = 1
        while channels * 2 <= ci and \
                _stage_bytes(frames, hop, rows, channels * 2, co, k) <= room:
            channels *= 2
        smem = STAGES * _stage_bytes(frames, hop, rows, channels, co, k)
        if smem > SMEM_LIMIT:
            continue
        tiles = b * -(-f // frames)
        slots = SMS * min(BLOCKS_PER_SM[rows], SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
        waves = -(-tiles // slots)
        score = min(1.0, tiles / TARGET_BLOCKS) * (1.0 if waves == 1 else tiles / (waves * slots))
        if frames_innermost:
            score *= min(1.0, 4 * frames / SECTOR_BYTES)
        if best is None or score > best[0]:
            w_frame, x_row = stage_layout(frames, hop, rows, channels, co, k)
            best = (score, {"rows_per_thread": rows, "frames": frames, "channels": channels,
                            "w_frame": w_frame, "x_row": x_row, "tiles": tiles, "smem": smem,
                            "threads": THREADS})
    if best is None:
        raise ValueError(f"the LVC kernel's ring would take more than {SMEM_LIMIT} bytes of "
                         f"shared memory at Co={co}, K={k}, hop={hop}")
    return best[1]


def _kernel_strides(kernels) -> tuple[int, int, int] | None:
    """(batch, frame, weight) strides of kernels (B, F, Ci, Co, K) whose
    (Ci, Co, K) dims lie as one run of one stride, else None."""
    _, _, ci, co, k = kernels.shape
    sb, sf, si, so, sk = kernels.stride()
    km = sk if k > 1 else (so if co > 1 else 1)
    if (ci > 1 and si != co * k * km) or (co > 1 and so != k * km):
        return None
    return sb, sf, km


def _check_cuda_args(x, kernels, bias, hop):
    b, t, ci = x.shape
    if kernels.dim() != 5 or bias.dim() != 3:
        raise ValueError(f"kernels: needs (B, F, Ci, Co, K), bias (B, F, Co); got "
                         f"{tuple(kernels.shape)}, {tuple(bias.shape)}")
    _, f, _, co, k = kernels.shape
    if t != f * hop or kernels.shape[:3] != (b, f, ci) or tuple(bias.shape) != (b, f, co):
        raise ValueError(f"shapes: x {tuple(x.shape)}, kernels {tuple(kernels.shape)}, bias "
                         f"{tuple(bias.shape)} do not fit hop={hop}")
    for name, a in (("x", x), ("kernels", kernels), ("bias", bias)):
        if a.dtype != torch.float32 or a.device != x.device:
            raise ValueError(f"{name}: needs float32 on {x.device}, got {a.dtype} on {a.device}")
    if x.stride(1) != 1 and x.stride(2) != 1:
        raise ValueError("x: needs unit stride along time or along channels")
    strides = _kernel_strides(kernels)
    if strides is None:
        raise ValueError("kernels: the (Ci, Co, K) dims must lie as one run (each frame's "
                         "block contiguous, or the predictor's frames-innermost view)")
    return plan_lvc(b, f, hop, ci, co, k,
                    frames_innermost=strides[1] == 1 and strides[2] != 1), strides


def location_variable_convolution_lvc(x, kernels, bias, hop: int):
    """x (B, F*hop, Ci) float32, channels-last or the transposed view of a
    channels-first conv output; kernels (B, F, Ci, Co, K) float32 whose
    (Ci, Co, K) dims lie as one run: each frame's block contiguous, or
    frames innermost as KernelPredictor leaves them (``kernels[:, l]`` of
    its output is taken as it is); bias (B, F, Co), any strides. Returns
    (B, F*hop, Co) contiguous."""
    if not x.is_cuda:
        return location_variable_convolution_lvc_plain(x, kernels, bias, hop)
    plan, strides = _check_cuda_args(x, kernels, bias, hop)
    b, t, ci = x.shape
    _, f, _, co, k = kernels.shape
    out = torch.empty((b, t, co), dtype=torch.float32, device=x.device)
    _KERNEL(x.get_device(), x.data_ptr(), kernels.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
            f, hop, ci, co, k, *x.stride(), *strides, *bias.stride(),
            plan["rows_per_thread"], plan["frames"], plan["channels"], plan["w_frame"],
            plan["x_row"], plan["smem"])
    location_variable_convolution_lvc.launches += 1
    return out


location_variable_convolution_lvc.launches = 0
