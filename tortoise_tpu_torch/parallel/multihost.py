"""Bring-up across processes and hosts.

Port of ``tortoise_tpu/parallel/multihost.py``. A JAX process is a host
that sees its local chips; a torch process is one GPU (``torchrun
--nproc-per-node N`` starts one a GPU on each node). ``initialize`` joins the
processes into one ``torch.distributed`` group, after which ``make_mesh``
and ``hybrid_mesh`` lay the ranks out as ("dp", "tp").

Layout policy, as in the JAX package: tp (an all-reduce per product) stays
inside a host, on NVLink; dp (a gather of scores and codes per batch) may
span hosts.

Unlike the JAX package, ``initialize`` raises when the group cannot be
formed: the JAX package warns and serves from one host.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tortoise_tpu_torch.parallel.mesh import make_mesh, rank_device


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device_type: str = "cuda") -> bool:
    """Initialise the process group (idempotent): nccl on CUDA, gloo for
    ``device_type="cpu"``. Each of the address (``host:port``), the world
    size and the rank comes from the argument, else the JAX package's
    variables (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``),
    else torchrun's (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). Returns True when the world has more than one process; False,
    with nothing initialised, when nothing names a world. Raises when the
    group cannot be formed."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    n = num_processes if num_processes is not None else \
        int(env.get("NUM_PROCESSES", "0")) or None
    pid = process_id if process_id is not None else \
        (int(env["PROCESS_ID"]) if "PROCESS_ID" in env else None)
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if n is None and "WORLD_SIZE" in env:
        n = int(env["WORLD_SIZE"])
    if pid is None and "RANK" in env:
        pid = int(env["RANK"])
    if addr is None and n is None and pid is None:
        return False
    if addr is None or n is None or pid is None:
        raise ValueError(f"initialize needs an address, a world size and a rank; got "
                         f"{addr!r}, {n!r}, {pid!r}")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device())
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}", world_size=n, rank=pid)
    return n > 1


def hybrid_layout(world: int, local: int, tp: int = 1,
                  dp_per_host: int | None = None) -> np.ndarray:
    """The (dp, tp) array of ranks for ``world`` ranks, ``local`` a host,
    numbered host by host as torchrun numbers them: each tp group is tp
    consecutive local ranks of one host, and dp runs over the hosts."""
    assert world % local == 0, f"{world} ranks do not fill hosts of {local}"
    assert local % tp == 0, f"tp={tp} must divide {local} local ranks"
    if dp_per_host is None:
        dp_per_host = local // tp
    assert dp_per_host * tp == local, \
        f"dp_per_host={dp_per_host} x tp={tp} != {local} local ranks"
    return np.arange(world).reshape(world // tp, tp)


def hybrid_mesh(tp: int = 1, dp_per_host: int | None = None,
                device_type: str = "cuda") -> DeviceMesh:
    """The ("dp", "tp") mesh of a (possibly) multi-host run, laid out by
    ``hybrid_layout`` with torchrun's ``LOCAL_WORLD_SIZE`` ranks a host (the
    whole world when unset). On one host it is ``make_mesh(tp=tp)``."""
    world = dist.get_world_size()
    layout = hybrid_layout(world, int(os.environ.get("LOCAL_WORLD_SIZE", world)), tp,
                           dp_per_host)
    return make_mesh(layout.shape[0], tp, device_type)


def process_local_batch(global_batch: int) -> int:
    """This process's share of a batch split over every process. A JAX
    process is a host and its share covers the host's chips; a torch process
    is one GPU, so this is one GPU's share."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    assert global_batch % world == 0, \
        f"global batch {global_batch} not divisible by {world} processes"
    return global_batch // world
