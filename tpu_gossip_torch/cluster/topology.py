"""Cluster axis model: the (hosts, devices) mesh the sharded engines run on.

Ports ``tpu_gossip/cluster/topology.py``. The flat mesh of S shards folds
row-major into (H, D) with ``D = S / H``: shard ``s`` is host row
``s // D``, device ``s % D``, so the folded mesh holds the same shards in
the same order and a round on it is the flat round. The host axis is the
slow one (DCN), the device axis the fast one (ICI); the hierarchical
transport (``cluster/hier.py``) splits each exchange by axis.

One process with ``hosts = H`` is the **fold**: the S shards stacked in
the process as on the flat mesh, with the host axis written out by the
hier transport's stages. Under ``torch.distributed`` each process is one
host row and holds only its D shards, ``[rank * D, (rank + 1) * D)``; the
exchanges between rows go through the process group
(``dist/mesh.py::all_to_all``) and the whole-swarm reductions through
:func:`reduce_sum` and :func:`reduce_max`.

``TPU_GOSSIP_TORCH_LOCAL_SHARDS`` is the number of shards each process
holds when the caller names no mesh size (the launcher's
``--devices-per-host``); without it a process holds one shard.

This module imports nothing else of the package but that variable's name
from its torch-free ``__init__``, so ``dist/`` depends on it without
cycles.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from tpu_gossip_torch.cluster import LOCAL_SHARDS_ENV

__all__ = [
    "HOST_AXIS",
    "DEVICE_AXIS",
    "LOCAL_SHARDS_ENV",
    "Mesh",
    "make_cluster_mesh",
    "mesh_hosts",
    "world",
    "rank",
    "local_shards",
    "reduce_sum",
    "reduce_max",
    "gather_rows",
    "exchange_blocks",
]

HOST_AXIS = "hosts"
DEVICE_AXIS = "peers"


def world() -> int:
    """The process group's size (1 without ``torch.distributed``)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without ``torch.distributed``)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_shards() -> int:
    """Shards a process holds by default: ``TPU_GOSSIP_TORCH_LOCAL_SHARDS``,
    else 1."""
    n = int(os.environ.get(LOCAL_SHARDS_ENV, "1") or 1)
    if n < 1:
        raise ValueError(f"{LOCAL_SHARDS_ENV}={n} must be >= 1")
    return n


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shards of the peer axis folded into ``hosts`` rows. ``world``
    processes hold them, ``S / world`` shards each: this process (``rank``)
    holds ``[lo, lo + local)``. One process holds all S, stacked on
    ``device``."""

    n_shards: int
    device: torch.device
    hosts: int = 1
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return self.n_shards

    @property
    def local(self) -> int:
        """Shards this process holds."""
        return self.n_shards // self.world

    @property
    def lo(self) -> int:
        """This process's first shard."""
        return self.rank * self.local


def make_cluster_mesh(n_shards: int, hosts: int = 1, device: str | torch.device = "cuda") -> Mesh:
    """The (hosts, devices) fold of an ``n_shards`` mesh on ``device``.
    Under ``torch.distributed`` the host rows are the processes: ``hosts``
    must equal the world size and each process holds its row's shards."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n_shards < 1:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if n_shards % hosts:
        raise ValueError(f"--hosts {hosts} does not divide the device count {n_shards} — the (hosts, devices) "
                         "mesh needs equal rows")
    w = world()
    if w > 1 and hosts != w:
        raise ValueError(f"hosts={hosts} but the process group has {w} processes: the mesh's host axis is one row "
                         "per process")
    return Mesh(n_shards=n_shards, device=dev, hosts=hosts, rank=rank(), world=w)


def mesh_hosts(mesh: Mesh) -> tuple[int, int]:
    """(H, D) of a mesh; the flat mesh is (1, S)."""
    return mesh.hosts, mesh.n_shards // mesh.hosts


def _reduce(x, op) -> torch.Tensor:
    t = torch.as_tensor(x)
    if world() == 1:
        return t
    out = t.detach().to(torch.int64).reshape(-1).clone()
    torch.distributed.all_reduce(out, op=op)
    return out.reshape(t.shape)


def reduce_sum(x) -> torch.Tensor:
    """The sum of ``x`` (a tensor or ints) over every process, as int64 on
    ``x``'s device in ``x``'s shape; ``x`` itself in one process."""
    return _reduce(x, torch.distributed.ReduceOp.SUM if world() > 1 else None)


def reduce_max(x) -> torch.Tensor:
    """:func:`reduce_sum` with the maximum."""
    return _reduce(x, torch.distributed.ReduceOp.MAX if world() > 1 else None)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes, flat, where it lies: gloo and NCCL move a card's
    tensors as they are (gloo stages them through host memory itself)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def exchange_blocks(send: torch.Tensor) -> torch.Tensor:
    """The all-to-all of the process group over ``send``'s leading axis of
    ``world()`` blocks: block ``i`` goes to rank ``i``, and block ``i`` of
    the result came from rank ``i``. The bytes travel, so any dtype does."""
    w = world()
    if send.shape[0] != w:
        raise ValueError(f"exchange_blocks takes {w} blocks, one a process, got {send.shape[0]}")
    wire = _wire(send)
    out = torch.empty_like(wire)
    torch.distributed.all_to_all_single(out, wire)
    return out.view(send.dtype).reshape(send.shape)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``x`` joined in rank order (the global
    plane from each process's row block), on ``x``'s device; ``x`` in one
    process. The bytes travel, so any dtype does."""
    w = world()
    if w == 1:
        return x
    wire = _wire(x)
    parts = [torch.empty_like(wire) for _ in range(w)]
    torch.distributed.all_gather(parts, wire)
    return torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts])
