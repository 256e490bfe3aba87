"""The gather and shuffle probes' two kernels (P1-P5 of ``experiments/``).

The five Pallas probes of the JAX package ask what gather and shuffle rate
the chip reaches at the round's shapes. They compute two functions, each a
CUDA kernel here (``csrc/gather_probes.cu``):

- :func:`lane_gather`, ``out[r, w] = tab[r mod T, idx[r, w]]``: P1 at axis
  1 and P4 (``T = N``, ``W = 128``), P2 (a (S, W) table shared by every
  block of S rows);
- :func:`sublane_gather`, ``out[r, l] = tab[base(r) + idx[r, l], l]`` over
  128 lanes, ``base(r) = (r // group) * group`` (0 for ``group = 0``): P1
  at axis 0 and P3 (group 0), P5 (group 8).

Each wrapper takes its plain version (a ``torch.gather``) for CPU tensors
only; for CUDA tensors it launches its kernel on the current stream or
raises, and counts the launch in ``native.LAUNCHES``.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.kernels import native

__all__ = ["lane_gather", "lane_gather_plain", "sublane_gather", "sublane_gather_plain"]

LANES = 128
_MAX_ELEMS = 2**31 - 1  # the kernels index in 32 bits


def _check_int32(what: str, tab: torch.Tensor, idx: torch.Tensor) -> None:
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"{what} takes int32 operands, got {tab.dtype}, {idx.dtype}")
    if tab.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{what} takes 2-D operands, got {tuple(tab.shape)}, {tuple(idx.shape)}")
    if tab.shape[0] < 1 or max(tab.numel(), idx.numel()) > _MAX_ELEMS:
        raise ValueError(f"{what}: table of {tab.shape[0]} rows, or an operand past 2^31 elements")


def _launch(what: str, tab: torch.Tensor, idx: torch.Tensor, call) -> torch.Tensor:
    native.require_cuda(what, tab, idx)
    if idx.data_ptr() % 16:
        raise ValueError(f"{what}: idx must be 16-byte aligned")
    out = torch.empty_like(idx)
    native.check(call(native.library("gather_probes"), out), what)
    native.LAUNCHES[what] += 1
    return out


def _check_lane(tab: torch.Tensor, idx: torch.Tensor) -> None:
    _check_int32("lane_gather", tab, idx)
    if idx.shape[1] != tab.shape[1] or idx.shape[0] % tab.shape[0]:
        raise ValueError(f"lane_gather needs idx (N, W) over a table (T, W) with T | N, "
                         f"got {tuple(idx.shape)}, {tuple(tab.shape)}")


def lane_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lane_gather`: one ``torch.gather`` over the
    table broadcast (stride 0, no copy) to every block of T rows."""
    t, w = tab.shape
    blocks = idx.shape[0] // t
    return torch.gather(tab.unsqueeze(0).expand(blocks, t, w), 2, idx.view(blocks, t, w).long()).view(-1, w)


def lane_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, w] = tab[r mod T, idx[r, w]]`` for an int32 table (T, W) and
    int32 indices (N, W), N a multiple of T. Every index must lie in
    [0, W): one outside is out of contract (as in Mosaic), not clamped; the
    probes mask theirs into range."""
    _check_lane(tab, idx)
    if tab.device.type == "cpu":
        return lane_gather_plain(tab, idx)
    n, w = idx.shape
    return _launch("lane_gather", tab, idx, lambda lib, out: lib.lane_gather(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, tab.shape[0], w, native.stream_of(idx)))


def _check_sublane(tab: torch.Tensor, idx: torch.Tensor, group: int) -> None:
    _check_int32("sublane_gather", tab, idx)
    if tab.shape[1] != LANES or idx.shape[1] != LANES:
        raise ValueError(f"sublane_gather takes (rows, {LANES}) operands, got {tuple(tab.shape)}, {tuple(idx.shape)}")
    if group < 0 or (group > 0 and (tab.shape[0] != idx.shape[0] or idx.shape[0] % group)):
        raise ValueError(f"sublane_gather group {group} needs equal row counts that it divides, "
                         f"got {tuple(tab.shape)}, {tuple(idx.shape)}")


def sublane_gather_plain(tab: torch.Tensor, idx: torch.Tensor, group: int) -> torch.Tensor:
    """Plain version of :func:`sublane_gather`: one ``torch.gather`` down the
    rows of the table or of each group."""
    if group == 0:
        return torch.gather(tab, 0, idx.long())
    g = (-1, group, LANES)
    return torch.gather(tab.view(g), 1, idx.view(g).long()).view(-1, LANES)


def sublane_gather(tab: torch.Tensor, idx: torch.Tensor, group: int) -> torch.Tensor:
    """``out[r, l] = tab[base(r) + idx[r, l], l]`` over 128 int32 lanes, with
    ``base(r) = (r // group) * group`` for ``group > 0`` (the table as many
    rows as ``idx``, a multiple of ``group``) and 0 for ``group = 0`` (any
    table). Every index must lie in [0, group), or in [0, table rows) for
    group 0: one outside is out of contract (as in Mosaic), not clamped;
    the probes mask theirs into range."""
    _check_sublane(tab, idx, group)
    if tab.device.type == "cpu":
        return sublane_gather_plain(tab, idx, group)
    return _launch("sublane_gather", tab, idx, lambda lib, out: lib.sublane_gather(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], group, native.stream_of(idx)))
