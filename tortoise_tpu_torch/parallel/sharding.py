"""UnifiedVoice's Megatron split over the mesh's tp axis, and the
collectives that the split and the dp axis need.

Port of ``tortoise_tpu/parallel/sharding.py``. Under GSPMD the JAX package
names each parameter's split and the compiler adds the collectives; here
``shard_unified_voice`` slices the parameters and the layers call the
collectives below, written once:

* ``reduce_from_tp``: the all-reduce after a row-split product (c_proj,
  mlp_proj); identity backward;
* ``copy_to_tp``: identity forward, all-reduce backward, before a
  column-split product (c_attn, mlp_fc, the vocab-split heads). The two are
  Megatron's pair of autograd functions: replicated activations get whole
  gradients on every rank;
* ``gather_from_tp``: a vocab-split head's logits gathered over tp;
* ``gather_rows``: a dp-split batch's results gathered on every rank;
* ``all_ranks``: one decision taken together by a dp group.

Each gather is one ``all_reduce`` (sum) of a zeroed global buffer into which
each rank wrote its part: adding zeros is exact, parts of unequal length pad
to the longest, and gloo carries ``all_reduce`` on CUDA tensors where it has
no ``all_gather`` (NCCL refuses two ranks on one card, gloo does not), so
one code path serves every backend.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from tortoise_tpu_torch.parallel.mesh import BatchShard

_COLUMN = ("c_attn", "mlp_fc")      # split on the output axis
_ROW = ("c_proj", "mlp_proj")       # split on the input axis


def unified_voice_pspec(name: str, tensor: torch.Tensor) -> int | None:
    """The axis of UnifiedVoice's parameter ``name`` that tp splits, or None
    (whole on every rank).

    The port's names are the JAX tree's paths (``gpt.h_scan.block.attn.
    c_attn.weight`` is ``gpt/h_scan/block/attn/c_attn/kernel``), and a JAX
    kernel (L, in, out) is the port's weight (L, out, in). Megatron, as the
    JAX rule has it: c_attn and mlp_fc split on their output axis, c_proj and
    mlp_proj on their input axis, mel_head and text_head over the vocab.
    Where a split by hand must differ from the rule GSPMD applies:

    * c_attn's output is q|k|v, 3C wide. The JAX rule splits it into
      contiguous thirds and GSPMD moves the data so that each device attends
      with whole heads; sliced so by hand, rank 0 of tp=2 would hold all of
      q and half of k. ``shard_params`` gives each rank its heads of each of
      q, k and v instead.
    * The bias (and an int8 weight's ``qscale``) of a column-split product
      is split with its output; the JAX rule keeps it whole and GSPMD adds
      each device's part. A row-split product's bias stays whole and is
      added once, after the all-reduce.
    * The conditioning encoder's qkv stays whole on every rank, where the
      JAX rule splits it: the encoder's output is the same, and it runs once
      a request.
    """
    parts = name.split(".")
    leaf = parts[-1]
    if parts[0] == "gpt" and "h_scan" in parts:
        if any(k in parts for k in _COLUMN):
            return tensor.dim() - (2 if leaf == "weight" else 1)
        if any(k in parts for k in _ROW) and leaf == "weight":
            return tensor.dim() - 1
        return None
    if parts[0] in ("mel_head", "text_head"):
        return 0
    return None


def _split_qkv_heads(t: torch.Tensor, axis: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s heads of each of q, k and v along the fused 3C axis."""
    return torch.cat([part.chunk(tp, axis)[rank] for part in t.chunk(3, axis)], axis)


def shard_params(state_dict: dict, mesh: DeviceMesh, heads: int) -> dict:
    """This rank's part of each UnifiedVoice tensor by
    ``unified_voice_pspec``. A split that does not divide is dropped, as the
    JAX rule drops it: the vocab heads each on their own, the GPT stack as a
    whole unless its ``heads`` divide by tp (whole heads on every rank)."""
    tp, rank = mesh["tp"].size(), mesh.get_local_rank("tp")
    out = {}
    for name, t in state_dict.items():
        axis = unified_voice_pspec(name, t)
        divides = heads % tp == 0 if name.startswith("gpt.") else \
            axis is not None and t.shape[axis] % tp == 0
        if tp == 1 or axis is None or not divides:
            out[name] = t
        elif "c_attn" in name.split("."):
            out[name] = _split_qkv_heads(t, axis, tp, rank).contiguous()
        else:
            out[name] = t.chunk(tp, axis)[rank].contiguous()
    return out


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A module's tp split: the group, its size, this rank's place in it and
    the names of the parameters that hold only this rank's part."""
    group: dist.ProcessGroup
    size: int
    rank: int
    split: frozenset


@torch.no_grad()
def shard_unified_voice(model: nn.Module, mesh: DeviceMesh) -> TensorParallel | None:
    """Slice ``model``'s parameters in place to this rank's parts and attach
    the split to the model (``model.tp``) and to its GPT stack
    (``model.gpt.tp``, None if the stack stayed whole). Returns ``model.tp``,
    None when tp is 1."""
    if mesh["tp"].size() == 1:
        return None
    params = dict(model.named_parameters())
    parts = shard_params(params, mesh, model.config.heads)
    split = frozenset(n for n, t in parts.items() if t is not params[n])
    for name in split:
        params[name].data = parts[name]
    tp = TensorParallel(mesh.get_group("tp"), mesh["tp"].size(), mesh.get_local_rank("tp"),
                        split)
    model.tp = tp
    model.gpt.tp = tp if any(n.startswith("gpt.") for n in split) else None
    return tp


class KVCacheSharding:
    """The decode cache's split, port of the JAX package's: the candidate
    batch over dp and the channels over tp. k and v are (L, B, T, C), whole
    heads in each C/tp block, so attention needs no collective; the int8
    cache's scales are (L, B, H, T) in the port, heads over tp."""

    def __init__(self, mesh: DeviceMesh):
        self.sizes = {"dp": mesh["dp"].size(), "tp": mesh["tp"].size(), None: 1}

    def spec(self, key: str) -> tuple:
        if key.endswith("_scale"):
            return (None, "dp", "tp", None)
        return (None, "dp", None, "tp")

    def local_shape(self, key: str, shape: tuple) -> tuple:
        """This rank's part of the global ``shape`` of cache entry ``key``."""
        return tuple(n // self.sizes[ax] for n, ax in zip(shape, self.spec(key)))

    @property
    def tp(self) -> int:
        return self.sizes["tp"]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        n = x.shape[-1]
        ctx.cols = slice(tp.rank * n, (tp.rank + 1) * n)
        full = x.new_zeros((*x.shape[:-1], n * tp.size))
        full[..., ctx.cols] = x
        dist.all_reduce(full, group=tp.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        # every rank computes the same loss from the gathered logits
        return grad[..., ctx.cols], None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    return _ReduceFromTP.apply(x, tp.group)


def gather_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """(..., n) columns of rank r -> (..., n * tp), rank r's at [r n, (r+1) n)."""
    return _GatherFromTP.apply(x, tp)


def gather_rows(x: torch.Tensor, shard: BatchShard) -> torch.Tensor:
    """This rank's rows (n / dp, ...) -> the whole batch (n, ...) on every
    rank of the dp group."""
    full = x.new_zeros((x.shape[0] * shard.size, *x.shape[1:]))
    full[shard.rows(full.shape[0])] = x
    dist.all_reduce(full, group=shard.group)
    return full


def all_ranks(flag: torch.Tensor, shard: BatchShard) -> bool:
    """True when ``flag`` (a bool scalar) is true on every rank of the dp
    group: the decode stops for all of them at the same step."""
    t = flag.reshape(1).to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=shard.group)
    return bool(t.item())
