"""The ("dp", "tp") device mesh over ``torch.distributed`` ranks.

Port of ``tortoise_tpu/parallel/mesh.py``. The JAX package's mesh is one
process that sees every device: GSPMD places the work and adds the
collectives. Here each rank is one process (torchrun's idiom: one a GPU) of
an initialised process group, and the callers write out what GSPMD did:
each rank takes its rows of a candidate batch (``batch_sharding``,
``shard_batch``) and its heads of the GPT stack (``sharding.py``), partial
sums are all-reduced and results gathered (``sharding.py``).

Ranks lie on the mesh row-major, rank = dp_index * tp + tp_index, so a tp
group is tp consecutive ranks (``multihost.hybrid_mesh`` keeps it on one
host).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` (several
    ranks may share one card), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def make_mesh(dp: int | None = None, tp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """The (dp, tp) mesh over every rank of the initialised process group."""
    world = dist.get_world_size()
    if dp is None:
        assert world % tp == 0, f"{world} ranks not divisible by tp={tp}"
        dp = world // tp
    assert dp * tp == world, f"mesh {dp}x{tp} != {world} ranks"
    if device_type == "cuda":
        torch.cuda.set_device(rank_device())
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's part of a batch split over the mesh's dp axis: block
    ``index`` of ``size`` equal blocks; ``group`` gathers them back."""
    index: int
    size: int
    group: dist.ProcessGroup

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over dp={self.size}")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


def draw_rows(draw: Callable[[int], torch.Tensor], rows: int,
              shard: BatchShard | None) -> torch.Tensor:
    """``rows`` rows of a random draw: ``draw(n)`` makes n rows from the
    generator every rank holds alike. With ``shard`` the rows are this
    rank's of a batch split over dp: the draw is made at the global batch's
    shape and this rank's rows taken, so each row gets what it gets unsplit."""
    n = rows * (shard.size if shard is not None else 1)
    x = draw(n)
    return x if shard is None else x[shard.rows(n)]


def batch_sharding(mesh: DeviceMesh) -> BatchShard:
    """The leading (batch, candidate) axis over dp."""
    return BatchShard(mesh.get_local_rank("dp"), mesh["dp"].size(), mesh.get_group("dp"))


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of ``x``; raises when the batch does not divide by dp."""
    return x[batch_sharding(mesh).rows(x.shape[0])]


def _first_rank(mesh: DeviceMesh) -> int:
    return int(mesh.mesh.flatten()[0])


def replicated(obj, mesh: DeviceMesh):
    """A picklable value as the mesh's first rank holds it (a seed drawn
    from each rank's clock, say)."""
    box = [obj]
    dist.broadcast_object_list(box, src=_first_rank(mesh))
    return box[0]


@torch.no_grad()
def replicate_tree(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` (a module's parameters and buffers, or a
    dict or list of tensors) broadcast in place from the mesh's first rank,
    so every rank holds the same weights whatever seeded them. One
    broadcast per dtype. Returns ``tree``."""
    if isinstance(tree, nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = list(tree.values() if isinstance(tree, dict) else tree)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    src = _first_rank(mesh)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
    return tree
