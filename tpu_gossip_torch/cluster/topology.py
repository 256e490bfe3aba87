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

A process of a mesh over several processes holds one block of the swarm's
rows: :func:`row_block` gives it as a :class:`ProcessRows`, the
``core.rows.Rows`` whose helpers cross the process group (one process
holds ``core.rows.ALL_ROWS``, where they are the identity). Its gather
moves bool planes as bits and every other dtype as its own bytes, never
widened; its reduce ships each owner its rows' block of the contributions
(one all-to-all) and combines them with the one-process scatter's own OR,
integer SUM or MAX. Both count the bytes a process sends and their calls
under a label (:data:`SIDE_PATHS`), and with :func:`time_side_paths` on,
the seconds.

This module imports nothing else of the package but that variable's name
from its torch-free ``__init__`` and ``core.rows`` (torch alone), so
``dist/`` depends on it without cycles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import torch

from tpu_gossip_torch.cluster import LOCAL_SHARDS_ENV
from tpu_gossip_torch.core.rows import ALL_ROWS, Rows, check_combine

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
    "gather_joined",
    "exchange_blocks",
    "ProcessRows",
    "row_block",
    "SIDE_PATHS",
    "time_side_paths",
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
    process. The bytes travel (a bool plane's as bits), so any dtype
    does."""
    return x if world() == 1 else _all_gather_planes((x,))[0]


def gather_joined(x: torch.Tensor, label: str | None = None) -> torch.Tensor:
    """Every process's ``x`` (the same shape on each) joined along its
    first axis in rank order, gathered straight into the joined tensor (no
    staging copy), its bytes counted under ``label`` when one is given;
    ``x`` itself in one process."""
    w = world()
    if w == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((w * x.shape[0],) + tuple(x.shape[1:]))
    with (_side_path(label, x.numel() * x.element_size() * (w - 1), x.device) if label
          else contextlib.nullcontext()):
        torch.distributed.all_gather(list(out.chunk(w)), x)
    return out


# -------------------------------------------- the row planes' side paths

_TIMED = [False]
# label -> [calls, bytes this process sent, seconds (with time_side_paths)]
SIDE_PATHS: dict[str, list] = {}


@dataclasses.dataclass(frozen=True)
class ProcessRows(Rows):
    """Rows ``[lo, lo + n)`` of ``world * n``, the block a process of a
    mesh over several processes holds (every process an equal block, in
    rank order): the row helpers of ``core.rows`` over the process
    group."""

    world: int
    lo: int

    def total(self, n: int) -> int:
        return n * self.world

    def sum(self, x: torch.Tensor, label: str | None = None) -> torch.Tensor:
        """``x`` summed over every process (one all-reduce of int64),
        counted under ``label`` when one is given."""
        with (_side_path(label, x.numel() * 8 * (self.world - 1), x.device) if label else contextlib.nullcontext()):
            return reduce_sum(x).to(x.dtype)

    def stack(self, x: torch.Tensor, label: str = "stack") -> torch.Tensor:
        """Every process's ``x`` stacked in rank order (one all-gather of its
        bytes; a bool tensor as bits)."""
        return _all_gather_planes((x[None],), label)[0]

    def fsum(self, x: torch.Tensor, label: str = "fsum") -> torch.Tensor:
        """Every process's float partial ``x`` added in rank order, one after
        another, so every process gets the same bits (gathered, not
        all-reduced: a reduction's order is the backend's)."""
        parts = self.stack(x, label)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    def lookup(self, idx: torch.Tensor, plane: torch.Tensor, label: str = "lookup") -> torch.Tensor:
        """``plane`` (bool, this process's rows) at the swarm's rows ``idx``
        (every process the same ids, each in range): each process answers
        for the ids it holds, False elsewhere, and the answers are ORed over
        the processes (one all-gather of ``len(idx)`` bits a process)."""
        n = plane.shape[0]
        held = (idx >= self.lo) & (idx < self.lo + n)
        mine = plane[torch.clamp(idx - self.lo, 0, n - 1)] & held
        return self.stack(mine, label).any(dim=0)

    def gather(self, *planes: torch.Tensor, label: str = "gather") -> tuple[torch.Tensor, ...]:
        """Every process's rows of each plane joined in rank order, in one
        all-gather: a bool plane travels as bits, any other as its own
        bytes."""
        return _all_gather_planes(planes, label)

    def reduce(self, contrib: torch.Tensor, op: str, label: str = "reduce") -> torch.Tensor:
        """This process's rows of ``contrib`` (a plane over the swarm's rows
        holding this process's contributions) combined over every process
        with ``op``: each process ships every other its rows' block (one
        all-to-all; bool blocks as bits)."""
        check_combine(contrib, op)
        w = self.world
        blocks = contrib.reshape((w, contrib.shape[0] // w) + tuple(contrib.shape[1:]))
        like = blocks[0]
        send = torch.stack([_plane_wire(b) for b in blocks]) if op == "or" else blocks
        with _side_path(label, send[0].numel() * send.element_size() * (w - 1), send.device):
            recv = exchange_blocks(send.contiguous())
        if op == "or":
            return torch.stack([_from_plane_wire(r, like) for r in recv]).any(dim=0)
        if op == "sum":
            return recv.sum(dim=0, dtype=contrib.dtype)
        return recv.max(dim=0).values


def row_block(mesh: Mesh, n_local: int) -> Rows:
    """The rows this process's ``n_local`` state rows are: its first shard's
    first row on, ``n_local / mesh.local`` rows a shard. One process holds
    them all (``ALL_ROWS``)."""
    if mesh.world == 1:
        return ALL_ROWS
    return ProcessRows(lo=mesh.lo * (n_local // mesh.local), world=mesh.world)


@contextlib.contextmanager
def time_side_paths(on: bool = True):
    """Time each side-path collective into :data:`SIDE_PATHS` (a card's
    queue is drained before and after each, so the timing changes the
    overlap it measures: time the rounds with it off)."""
    prev = _TIMED[0]
    _TIMED[0] = on
    try:
        yield
    finally:
        _TIMED[0] = prev


@contextlib.contextmanager
def _side_path(label: str, nbytes: int, device):
    rec = SIDE_PATHS.setdefault(label, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += int(nbytes)
    if not _TIMED[0]:
        yield
        return
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    rec[2] += time.perf_counter() - t0


def _bit_wire(x: torch.Tensor) -> torch.Tensor:
    """A bool plane's elements, flat, eight to a byte (LSB first)."""
    flat = x.reshape(-1).to(torch.uint8)
    pad = (-flat.numel()) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return torch.sum(flat.view(-1, 8) << shifts, dim=-1, dtype=torch.uint8)


def _from_bit_wire(wire: torch.Tensor, shape) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=wire.device)
    return (((wire[:, None] >> shifts) & 1) != 0).reshape(-1)[:math.prod(shape)].reshape(shape)


def _plane_wire(x: torch.Tensor) -> torch.Tensor:
    return _bit_wire(x) if x.dtype == torch.bool else _wire(x)


def _from_plane_wire(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        return _from_bit_wire(wire, like.shape)
    return wire.view(like.dtype).reshape(like.shape)


def _all_gather_planes(planes, label: str | None = None) -> tuple[torch.Tensor, ...]:
    """Every process's rows of each plane joined in rank order, in one
    all-gather (bool planes as bits), counted under ``label`` when one is
    given."""
    wires = [_plane_wire(x) for x in planes]
    sizes = [int(w.numel()) for w in wires]
    flat = torch.cat(wires)
    parts = [torch.empty_like(flat) for _ in range(world())]
    with (_side_path(label, flat.numel() * (world() - 1), flat.device) if label else contextlib.nullcontext()):
        torch.distributed.all_gather(parts, flat)
    out = []
    start = 0
    for x, size in zip(planes, sizes):
        out.append(torch.cat([_from_plane_wire(p[start:start + size], x) for p in parts]))
        start += size
    return tuple(out)


