"""Structured-permutation passes: lane shuffles (K1), transposes, plane folds (K2).

Ports ``tpu_gossip/kernels/permute.py``. A matching plan's pairing is a
composition of per-row 128-lane shuffles (:func:`lane_shuffle`, a CUDA
kernel, ``csrc/lane_shuffle.cu``) and full-array transposes
(:func:`transpose_pass`, plain torch, as XLA did them outside Pallas), so a
gossip round moves its words to their partner slots without a general
gather. :func:`apply_pipeline` runs each shuffle next to a transpose as one
K1 launch that does both (:func:`lane_shuffle_t`,
:func:`tinv_lane_shuffle`; :func:`fuse_stages` pairs them), so a matching
plan's pass launches K1 2K+1 times and transposes nothing.
:func:`fold_classes` (a CUDA kernel, ``csrc/fold_planes.cu``) is the class
reduction: one launch folds every class of a plan, position-major and
node-major, and writes zeros on its node gaps; :func:`fold_planes`, the
counterpart of the JAX function, is the same kernel on one class.

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises.

On a mesh (``apply_pipeline(..., n_shards=S)``) the (R, 128) slot data is
the stacked (per, 128) blocks of the shards the process holds (all S in
one process, its D under ``torch.distributed``): a lane stage stays one K1
launch over the held rows (the lane tables are row blocks of the global
table), and each transpose stage is :func:`transpose_pass_sharded` or
:func:`untranspose_pass_sharded`, built on the mesh's one exchange
(``dist/mesh.py::all_to_all``), or on a (hosts, devices) mesh under the
hier transport their two-level twins (``cluster/hier.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gossip_torch.kernels import native

__all__ = [
    "lane_shuffle",
    "lane_shuffle_plain",
    "lane_shuffle_t",
    "lane_shuffle_t_plain",
    "tinv_lane_shuffle",
    "tinv_lane_shuffle_plain",
    "transpose_pass",
    "untranspose_pass",
    "transpose_pass_sharded",
    "untranspose_pass_sharded",
    "fuse_stages",
    "apply_pipeline",
    "inverse_tables",
    "fold_planes",
    "fold_planes_plain",
    "fold_classes",
    "fold_classes_plain",
    "fold_kind",
    "fold_work",
]


def _check_shuffle(x: torch.Tensor, idx: torch.Tensor) -> None:
    r = x.shape[0]
    if x.dim() != 2 or x.shape[1] != 128 or idx.shape != x.shape:
        raise ValueError(f"lane_shuffle needs (R, 128) operands, got {tuple(x.shape)}, {tuple(idx.shape)}")
    if x.dtype != torch.int32 or idx.dtype not in (torch.int8, torch.int32):
        raise ValueError(f"lane_shuffle takes int32 data and int8/int32 tables, got {x.dtype}, {idx.dtype}")
    if r % 8 != 0:
        raise ValueError(f"rows {r} not a multiple of 8")
    if idx.dtype == torch.int8 and r % 32 != 0:
        raise ValueError(f"int8 index tables need rows % 32 == 0, got {r}")


def lane_shuffle_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``out[r, l] = x[r, idx[r, l]]``."""
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    return torch.gather(x, 1, idx.to(torch.int64))


def _shuffle(entry: str, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K1's ``entry`` on CUDA operands; counted as one K1 launch."""
    native.require_cuda(entry, x, idx)
    native.require_aligned(entry, x, idx)
    out = torch.empty_like(x)
    lib = native.library("lane_shuffle")
    fn = getattr(lib, f"{entry}_i8" if idx.dtype == torch.int8 else f"{entry}_i32")
    native.check(fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], native.stream_of(x)), entry)
    native.LAUNCHES["lane_shuffle"] += 1
    native.K1_ENTRIES[entry] += 1
    return out


def lane_shuffle(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, l] = x[r, idx[r, l]]`` over (R, 128) int32 slot data with
    int8 or int32 lane tables; R a multiple of 8 (of 32 for int8 tables)."""
    _check_shuffle(x, idx)
    if x.device.type == "cpu":
        return lane_shuffle_plain(x, idx)
    return _shuffle("lane_shuffle", x, idx)


def lane_shuffle_t_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lane_shuffle_t`."""
    return transpose_pass(lane_shuffle_plain(x, idx))


def lane_shuffle_t(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``transpose_pass(lane_shuffle(x, idx))`` in one K1 launch:
    ``out_flat[l*R + r] = x[r, idx[r, l]]``."""
    _check_shuffle(x, idx)
    if x.device.type == "cpu":
        return lane_shuffle_t_plain(x, idx)
    return _shuffle("lane_shuffle_t", x, idx)


def tinv_lane_shuffle_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tinv_lane_shuffle`."""
    return lane_shuffle_plain(untranspose_pass(x), idx)


def tinv_lane_shuffle(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``lane_shuffle(untranspose_pass(x), idx)`` in one K1 launch:
    ``out[r, l] = x_flat[idx[r, l]*R + r]``."""
    _check_shuffle(x, idx)
    if x.device.type == "cpu":
        return tinv_lane_shuffle_plain(x, idx)
    return _shuffle("tinv_lane_shuffle", x, idx)


def transpose_pass(x: torch.Tensor) -> torch.Tensor:
    """Slot bijection: flat slot r*128+l -> l*R + r, reshaped back (R, 128)."""
    r = x.shape[0]
    return x.t().contiguous().view(r, 128)


def untranspose_pass(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`transpose_pass`."""
    r = x.shape[0]
    return x.reshape(128, r).t().contiguous()


def _lane_width(n_shards: int) -> int:
    if n_shards < 1 or 128 % n_shards:
        raise ValueError(f"transpose sharding needs 128 % n_shards == 0, got {n_shards}")
    return 128 // n_shards


def _held(x: torch.Tensor, n_shards: int) -> tuple[int, int]:
    l, per, _ = x.shape
    if l < 1 or n_shards % l:
        raise ValueError(f"{l} stacked blocks for a {n_shards}-shard mesh")
    return l, per


def transpose_pass_sharded(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """:func:`transpose_pass` over the stacked (L, per, 128) blocks of the
    held shards of a global (R, 128) array: each shard splits its block's
    lanes into S pieces, the exchange hands shard d every shard's d-th
    piece (the (R, 128/S) lane slab d of the global array, source-major),
    and a local transpose-reshape orders the slab column-major. Returns
    (L, per, 128)."""
    from tpu_gossip_torch.dist.mesh import all_to_all

    l, per = _held(x, n_shards)
    s = n_shards
    w = _lane_width(s)
    slab = all_to_all(x.view(l, per, s, w).transpose(1, 2))  # (L_dst, S_src, per, w)
    return slab.view(l, s * per, w).transpose(1, 2).reshape(l, per, 128).contiguous()


def untranspose_pass_sharded(x: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Inverse of :func:`transpose_pass_sharded`: the local un-reshape to
    each shard's (R, 128/S) lane slab of the output, the exchange of its
    S row pieces, and the lanes concatenated in source order."""
    from tpu_gossip_torch.dist.mesh import all_to_all

    l, per = _held(x, n_shards)
    s = n_shards
    w = _lane_width(s)
    slab = x.view(l, w, s * per).transpose(1, 2).reshape(l, s, per, w)  # (L_src, S_dst, per, w)
    return all_to_all(slab).transpose(1, 2).reshape(l, per, 128).contiguous()


def inverse_tables(idx: torch.Tensor) -> torch.Tensor:
    """Per-row inverse permutation table, dtype-preserving (plan time)."""
    return torch.argsort(idx.to(torch.int32), dim=1, stable=True).to(idx.dtype)


def fuse_stages(stages: tuple) -> tuple:
    """Pair each ("lane", t), ("t",) into ("lane_t", t) and each ("tinv",),
    ("lane", t) into ("tinv_lane", t), left to right; other stages stay."""
    out = []
    i = 0
    while i < len(stages):
        kind = stages[i][0]
        nxt = stages[i + 1][0] if i + 1 < len(stages) else None
        if kind == "lane" and nxt == "t":
            out.append(("lane_t", stages[i][1]))
            i += 2
        elif kind == "tinv" and nxt == "lane":
            out.append(("tinv_lane", stages[i + 1][1]))
            i += 2
        else:
            out.append(stages[i])
            i += 1
    return tuple(out)


_STAGE_OPS = {"lane": lane_shuffle, "lane_t": lane_shuffle_t, "tinv_lane": tinv_lane_shuffle}
_SHARDED_T = {"t": transpose_pass_sharded, "tinv": untranspose_pass_sharded}


def apply_pipeline(x: torch.Tensor, stages: tuple, *, n_shards: int | None = None, lanes: tuple | None = None,
                   per: int | None = None) -> torch.Tensor:
    """Apply a ("lane", table) / ("t",) / ("tinv",) stage tuple to (R, 128)
    slot data, left to right, as data operations; each shuffle beside a
    transpose runs fused (:func:`fuse_stages`). With ``n_shards`` the data
    is the held shards' stacked blocks of ``per`` rows (``R / n_shards``
    by default: every shard held): each lane stage is one K1 launch over
    all rows and each transpose one sharded pass, or, where ``lanes`` (one
    entry a transpose stage, a transport's gate decision) names a compact
    lane, that lane's ``lane(kind, blocks)``."""
    if n_shards is not None:
        return _apply_pipeline_sharded(x, stages, n_shards, lanes, per)
    for stage in fuse_stages(stages):
        kind = stage[0]
        if kind in _STAGE_OPS:
            x = _STAGE_OPS[kind](x, stage[1])
        elif kind == "t":
            x = transpose_pass(x)
        elif kind == "tinv":
            x = untranspose_pass(x)
        else:
            raise ValueError(f"unknown stage kind {kind!r}")
    return x


def _apply_pipeline_sharded(x: torch.Tensor, stages: tuple, s: int, lanes: tuple | None,
                            per: int | None = None) -> torch.Tensor:
    r = x.shape[0]
    per = r // s if per is None else per
    ti = 0
    for stage in stages:
        kind = stage[0]
        if kind == "lane":
            x = lane_shuffle(x.reshape(r, 128), stage[1])
            continue
        if kind not in _SHARDED_T:
            raise ValueError(f"unknown stage kind {kind!r}")
        lane = None if lanes is None else lanes[ti]
        ti += 1
        blocks = x.view(r // per, per, 128)
        x = _SHARDED_T[kind](blocks, s) if lane is None else lane(kind, blocks)
    if lanes is not None and ti != len(lanes):
        raise ValueError(f"{len(lanes)} transpose-stage lanes but the pipeline has {ti} transposes — rebuild the "
                         "transport from this plan")
    return x.reshape(r, 128)


# K2's work table (csrc/fold_planes.cu): one entry (row, k0, k1, kind) a
# block of 256 threads, folding nodes [k0, k1) of class-table row ``row``;
# the kinds and sizes are the kernel's (its Kind, kThreads, kChunk, kHubDeg)
FOLD_ZERO, FOLD_PLANE, FOLD_STAGED, FOLD_HUB = 0, 1, 2, 3
FOLD_THREADS = 256
FOLD_CHUNK = 4096  # words of node-major slots a staged block folds
FOLD_HUB_DEG = 1024  # node-major rows at or above this pad_deg fold one node a block


def fold_kind(row: tuple) -> int:
    """The kind of K2 block that folds a class-table row ``(node_off,
    slot_off, count, pad_deg, plane_stride, node_stride)``: zeros for
    pad_deg 0, position-major for a plane stride other than 1, node-major
    (staged, or one hub node a block) otherwise."""
    pad_deg, plane_stride = row[3], row[4]
    if pad_deg == 0:
        return FOLD_ZERO
    if plane_stride != 1:
        return FOLD_PLANE
    return FOLD_HUB if pad_deg >= FOLD_HUB_DEG else FOLD_STAGED


def _check_row(row: tuple) -> None:
    node_off, slot_off, count, pad_deg, plane_stride, node_stride = row
    kind = fold_kind(row)
    if min(row) < 0 or node_off + count >= 2**31:
        raise ValueError(f"bad class-table row {row}")
    if kind == FOLD_PLANE and (slot_off % 1024 or plane_stride % 1024 or node_stride != 1 or count > plane_stride):
        raise ValueError(f"position-major row {row} needs 1024-aligned slot_off/plane_stride >= count, node_stride 1")
    if kind in (FOLD_STAGED, FOLD_HUB) and node_stride != pad_deg:
        raise ValueError(f"node-major row {row} needs plane_stride 1 and node_stride = pad_deg")


def fold_work(table: tuple) -> np.ndarray:
    """K2's work table over a class table (rows as :func:`fold_kind` reads
    them): (blocks, 4) int32 entries (row, k0, k1, kind), the hub nodes
    first (the longest blocks start in the first wave), then the staged,
    position-major and zero blocks. A staged block takes whole nodes, at
    most FOLD_CHUNK words; a position-major or zero block 1024 nodes."""
    parts = {kind: [] for kind in (FOLD_HUB, FOLD_STAGED, FOLD_PLANE, FOLD_ZERO)}
    for i, row in enumerate(table):
        _check_row(row)
        kind = fold_kind(row)
        count, pad_deg = row[2], row[3]
        if kind == FOLD_HUB:
            span = 1
        elif kind == FOLD_STAGED:
            span = FOLD_CHUNK // pad_deg
        else:
            span = 4 * FOLD_THREADS
        k0 = np.arange(0, count, span, dtype=np.int64)
        parts[kind].append(np.stack([np.full_like(k0, i), k0, np.minimum(k0 + span, count),
                                     np.full_like(k0, kind)], axis=1))
    blocks = [p for kind in parts for p in parts[kind]]
    return np.concatenate(blocks).astype(np.int32) if blocks else np.zeros((0, 4), np.int32)


def _fold_launch(slots: torch.Tensor, table: torch.Tensor, work: torch.Tensor, n_out: int,
                 op: str) -> torch.Tensor:
    """One K2 launch over a class table on the card: (n_out,) int32, each
    output written once."""
    native.require_cuda("fold_planes", slots, table, work)
    native.require_aligned("fold_planes", slots)
    out = torch.empty((n_out,), dtype=torch.int32, device=slots.device)
    if work.shape[0] == 0:
        return out
    lib = native.library("fold_planes")
    fn = lib.fold_planes_or if op == "or" else lib.fold_planes_sum
    native.check(fn(slots.data_ptr(), out.data_ptr(), table.data_ptr(), work.data_ptr(), work.shape[0],
                    native.stream_of(slots)), "fold_planes")
    native.LAUNCHES[f"fold_planes_{op}"] += 1
    return out


def _check_op(slots: torch.Tensor, op: str) -> None:
    if op not in ("or", "sum"):
        raise ValueError(f"fold op must be 'or' or 'sum', got {op!r}")
    if slots.dtype != torch.int32:
        raise ValueError(f"the fold takes int32 slots, got {slots.dtype}")


def _check_fold(slots: torch.Tensor, slot_off: int, cstride: int, count: int,
                pad_deg: int, op: str) -> None:
    if slot_off % 1024 or cstride % 1024:
        raise ValueError("fold_planes needs 1024-aligned slot_off/cstride")
    _check_op(slots, op)
    if not 0 <= count <= cstride or pad_deg < 1:
        raise ValueError(f"bad class shape count={count} cstride={cstride} pad_deg={pad_deg}")
    if slot_off + pad_deg * cstride > slots.numel():
        raise ValueError("fold_planes class runs past the slot buffer")


def fold_planes_plain(slots: torch.Tensor, slot_off: int, cstride: int,
                      count: int, pad_deg: int, op: str = "or") -> torch.Tensor:
    """Plain version of K2 on one position-major class."""
    planes = slots.reshape(-1)[slot_off : slot_off + pad_deg * cstride].view(pad_deg, cstride)
    if op == "sum":
        out = planes.sum(0, dtype=torch.int32)
    else:
        out = planes[0].clone()
        for i in range(1, pad_deg):
            out |= planes[i]
    return out[:count]


def fold_planes(slots: torch.Tensor, slot_off: int, cstride: int, count: int,
                pad_deg: int, op: str = "or") -> torch.Tensor:
    """``out[j] = fold_i slots[slot_off + i*cstride + j]`` for j < count,
    fold = OR or SUM; ``slot_off`` and ``cstride`` 1024-aligned. On the
    card: K2 over a one-row class table."""
    _check_fold(slots, slot_off, cstride, count, pad_deg, op)
    if slots.device.type == "cpu":
        return fold_planes_plain(slots, slot_off, cstride, count, pad_deg, op)
    native.require_cuda("fold_planes", slots)
    table = ((0, slot_off, count, pad_deg, cstride, 1),)
    return _fold_launch(slots, torch.tensor(table, dtype=torch.int64, device=slots.device),
                        torch.from_numpy(fold_work(table)).to(slots.device), count, op)


def fold_classes_plain(slots: torch.Tensor, layout, op: str = "or") -> torch.Tensor:
    """Plain version of :func:`fold_classes`: each position-major row by
    :func:`fold_planes_plain`, the node-major rows by one index-add (``op``
    "or" folds each bit as a count), zeros elsewhere."""
    out = torch.zeros((layout.n,), dtype=slots.dtype, device=slots.device)
    node_major = []
    for row in layout.table_rows:
        node_off, slot_off, count, pad_deg, plane_stride, _ = row
        if fold_kind(row) == FOLD_PLANE:
            out[node_off : node_off + count] = fold_planes_plain(slots, slot_off, plane_stride, count, pad_deg, op)
        elif pad_deg:
            node_major.append((node_off, slot_off, count * pad_deg, pad_deg))
    if node_major:
        # each node-major row's slots are one contiguous run, node by node
        node_off, slot_off, size, pad_deg = torch.tensor(node_major, device=slots.device).T
        start = torch.cumsum(size, 0) - size
        row = torch.repeat_interleave(torch.arange(len(size), device=slots.device), size)
        j = torch.arange(row.numel(), device=slots.device) - start[row]
        nm_owner = node_off[row] + j // pad_deg[row]
        vals = slots.reshape(-1).index_select(0, slot_off[row] + j)
        if op == "sum":
            out.index_add_(0, nm_owner, vals)
        else:
            shifts = torch.arange(32, dtype=torch.int32, device=slots.device)
            bits = (vals[:, None] >> shifts) & 1
            counts = torch.zeros((layout.n, 32), dtype=torch.int32, device=slots.device)
            counts.index_add_(0, nm_owner, bits)
            words = ((counts > 0).to(torch.int64) << shifts.to(torch.int64)).sum(1)
            words = torch.where(words >= 2**31, words - 2**32, words).to(slots.dtype)
            out |= words
    return out


def fold_classes(slots: torch.Tensor, layout, op: str = "or") -> torch.Tensor:
    """``out[node_off + k] = fold_{i < pad_deg} slots[slot_off +
    i*plane_stride + k*node_stride]`` for every row of the class table of
    ``layout`` (a ``core.matching_topology.ClassLayout``) and k < count,
    zeros on its pad_deg-0 rows: (layout.n,) int32 per-node values of
    (rows, 128) int32 slots, fold = OR or SUM. On the card: one K2 launch."""
    _check_op(slots, op)
    if slots.numel() != layout.slot_node.numel():
        raise ValueError(f"the layout folds {layout.slot_node.numel()} slots, got {slots.numel()}")
    if slots.device.type == "cpu":
        return fold_classes_plain(slots, layout, op)
    return _fold_launch(slots, layout.table, layout.work, layout.n, op)
