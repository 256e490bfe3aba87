"""Structured-permutation passes: lane shuffles (K1), transposes, plane folds (K2).

Ports ``tpu_gossip/kernels/permute.py``. A matching plan's pairing is a
composition of per-row 128-lane shuffles (:func:`lane_shuffle`, a CUDA
kernel, ``csrc/lane_shuffle.cu``) and full-array transposes
(:func:`transpose_pass`, plain torch, as XLA did them outside Pallas), so a
gossip round moves its words to their partner slots without a general
gather. :func:`fold_planes` (a CUDA kernel, ``csrc/fold_planes.cu``) is the
class reduction of the position-major degree classes.

Each kernel wrapper takes its plain PyTorch version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. The sharded transpose
variants belong to a later slice.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.kernels import native

__all__ = [
    "lane_shuffle",
    "lane_shuffle_plain",
    "transpose_pass",
    "untranspose_pass",
    "apply_pipeline",
    "inverse_tables",
    "fold_planes",
    "fold_planes_plain",
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
    return torch.gather(x, 1, idx.to(torch.int64))


def lane_shuffle(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, l] = x[r, idx[r, l]]`` over (R, 128) int32 slot data with
    int8 or int32 lane tables; R a multiple of 8 (of 32 for int8 tables)."""
    _check_shuffle(x, idx)
    if x.device.type == "cpu":
        return lane_shuffle_plain(x, idx)
    native.require_cuda("lane_shuffle", x, idx)
    out = torch.empty_like(x)
    lib = native.library("lane_shuffle")
    fn = lib.lane_shuffle_i8 if idx.dtype == torch.int8 else lib.lane_shuffle_i32
    native.check(
        fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], native.stream_of(x)),
        "lane_shuffle",
    )
    native.LAUNCHES["lane_shuffle"] += 1
    return out


def transpose_pass(x: torch.Tensor) -> torch.Tensor:
    """Slot bijection: flat slot r*128+l -> l*R + r, reshaped back (R, 128)."""
    r = x.shape[0]
    return x.t().contiguous().view(r, 128)


def untranspose_pass(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`transpose_pass`."""
    r = x.shape[0]
    return x.reshape(128, r).t().contiguous()


def inverse_tables(idx: torch.Tensor) -> torch.Tensor:
    """Per-row inverse permutation table, dtype-preserving (plan time)."""
    return torch.argsort(idx.to(torch.int32), dim=1, stable=True).to(idx.dtype)


def apply_pipeline(x: torch.Tensor, stages: tuple) -> torch.Tensor:
    """Apply a ("lane", table) / ("t",) / ("tinv",) stage tuple to (R, 128)
    slot data, left to right, as data operations."""
    for stage in stages:
        kind = stage[0]
        if kind == "lane":
            x = lane_shuffle(x, stage[1])
        elif kind == "t":
            x = transpose_pass(x)
        elif kind == "tinv":
            x = untranspose_pass(x)
        else:
            raise ValueError(f"unknown stage kind {kind!r}")
    return x


def _check_fold(slots: torch.Tensor, slot_off: int, cstride: int, count: int,
                pad_deg: int, op: str) -> None:
    if slot_off % 1024 or cstride % 1024:
        raise ValueError("fold_planes needs 1024-aligned slot_off/cstride")
    if op not in ("or", "sum"):
        raise ValueError(f"fold_planes op must be 'or' or 'sum', got {op!r}")
    if slots.dtype != torch.int32:
        raise ValueError(f"fold_planes folds int32 planes, got {slots.dtype}")
    if not 0 <= count <= cstride or pad_deg < 1:
        raise ValueError(f"bad class shape count={count} cstride={cstride} pad_deg={pad_deg}")
    if slot_off + pad_deg * cstride > slots.numel():
        raise ValueError("fold_planes class runs past the slot buffer")


def fold_planes_plain(slots: torch.Tensor, slot_off: int, cstride: int,
                      count: int, pad_deg: int, op: str = "or") -> torch.Tensor:
    """Plain version of K2."""
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
    fold = OR or SUM; ``slot_off`` and ``cstride`` 1024-aligned."""
    _check_fold(slots, slot_off, cstride, count, pad_deg, op)
    if slots.device.type == "cpu":
        return fold_planes_plain(slots, slot_off, cstride, count, pad_deg, op)
    native.require_cuda("fold_planes", slots)
    out = torch.empty((cstride,), dtype=torch.int32, device=slots.device)
    lib = native.library("fold_planes")
    fn = lib.fold_planes_or if op == "or" else lib.fold_planes_sum
    native.check(
        fn(slots.data_ptr(), out.data_ptr(), slot_off, cstride, pad_deg, native.stream_of(slots)),
        "fold_planes",
    )
    native.LAUNCHES[f"fold_planes_{op}"] += 1
    return out[:count]
