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

Two shapes take a route that stages the table in shared memory, with the
geometry picked here (:func:`lane_plan`, :func:`sublane_plan`) and checked
again by the C entry: ``lane_gather`` with T < N and rows of at least
:data:`MIN_STAGED_WIDTH` words (P2), a table row a block
(its first :data:`STAGE_WORDS` words; the rest read through L2), and
``sublane_gather`` group 0 with at most :data:`SLAB_ROWS` table rows and at
least two idx rows a table row (P3), a 4-lane column slab a block, moved by
the tensor memory accelerator. A staged launch the card refuses raises; no
other route is taken.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.kernels import native

__all__ = ["lane_gather", "lane_gather_plain", "lane_plan", "sublane_gather", "sublane_gather_plain",
           "sublane_plan"]

LANES = 128
_MAX_ELEMS = 2**31 - 1  # the kernels index in 32 bits
# the staged routes' geometry, the constants of csrc/gather_probes.cu
STAGE_THREADS = 1024  # a staged block: one an SM
STAGE_BYTES = 229376  # a block's staged table slice: 224 KB
STAGE_WORDS = STAGE_BYTES // 4
SLAB_LANES = 4  # sublane slab: 4 lanes of every table row, 16 B a row
SLAB_ROWS = 8192  # the slab route's largest table: 128 KB a slab
STEP_ROWS = STAGE_THREADS  # idx rows a slab block takes a step (TMA boxes of 256 rows)
TARGET_BLOCKS = 128  # the staged lane route's grid: about one block an SM
MIN_STAGED_WIDTH = 8192  # lane rows staged from 32 KB (at 4 KB the L2 route measured faster)
MIN_BLOCK_ELEMS = 4096  # the least idx elements a staged lane block gathers
ROW_CHUNKS = 4  # sublane slab: blocks a slab at most
MIN_CHUNK_ROWS = 2048  # sublane slab: the least idx rows a block walks


def lane_plan(t_rows: int, width: int, n_rows: int) -> tuple[int, int] | None:
    """The staged ``lane_gather`` geometry ``(per, blocks_per_row)`` for a
    (t_rows, width) table and n_rows idx rows, or None for the L2 route (T =
    N, W not a multiple of 4, or W under MIN_STAGED_WIDTH, where staging a
    row costs more than it saves). A block stages the first min(W,
    STAGE_WORDS) words of its table row and gathers ``per`` positions of the
    row's (n_rows / t_rows) * W uses; ``blocks_per_row`` blocks cover them,
    about TARGET_BLOCKS in all."""
    if n_rows == t_rows or width % 4 or width < MIN_STAGED_WIDTH:
        return None
    per = max(MIN_BLOCK_ELEMS, -(-n_rows * width // (4 * TARGET_BLOCKS)) * 4)
    return per, -(-(n_rows // t_rows * width) // per)


def sublane_plan(t_rows: int, n_rows: int) -> int | None:
    """The staged group-0 ``sublane_gather``'s idx rows a block
    (``rows_per``, a multiple of STEP_ROWS; the grid is LANES / SLAB_LANES
    slabs times ceil(n_rows / rows_per) row chunks), or None for the L2
    route: a table of more than SLAB_ROWS rows, or fewer than two idx rows
    a table row, where staging the table costs more L2 requests than
    gathering from it."""
    if t_rows > SLAB_ROWS or n_rows < 2 * t_rows:
        return None
    chunks = min(ROW_CHUNKS, max(1, n_rows // MIN_CHUNK_ROWS))
    return -(-n_rows // (chunks * STEP_ROWS)) * STEP_ROWS


def _check_int32(what: str, tab: torch.Tensor, idx: torch.Tensor) -> None:
    if tab.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"{what} takes int32 operands, got {tab.dtype}, {idx.dtype}")
    if tab.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"{what} takes 2-D operands, got {tuple(tab.shape)}, {tuple(idx.shape)}")
    if tab.shape[0] < 1 or max(tab.numel(), idx.numel()) > _MAX_ELEMS:
        raise ValueError(f"{what}: table of {tab.shape[0]} rows, or an operand past 2^31 elements")


def _launch(what: str, tab: torch.Tensor, idx: torch.Tensor, call, staged: bool = False) -> torch.Tensor:
    native.require_cuda(what, tab, idx)
    native.require_aligned(what, *((tab, idx) if staged else (idx,)))
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
    [0, W): one outside is out of contract (as in Mosaic), not clamped (on
    the staged route it reads outside shared memory and may trap the
    kernel); the probes mask theirs into range."""
    _check_lane(tab, idx)
    if tab.device.type == "cpu":
        return lane_gather_plain(tab, idx)
    (n, w), t = idx.shape, tab.shape[0]
    plan = lane_plan(t, w, n)
    if plan is None:
        return _launch("lane_gather", tab, idx, lambda lib, out: lib.lane_gather(
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, t, w, native.stream_of(idx)))
    return _launch("lane_gather", tab, idx, lambda lib, out: lib.lane_gather_staged(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), n, t, w, *plan, native.stream_of(idx)), staged=True)


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
    group 0: one outside is out of contract (as in Mosaic), not clamped
    (on the staged route it reads outside shared memory and may trap the
    kernel); the probes mask theirs into range."""
    _check_sublane(tab, idx, group)
    if tab.device.type == "cpu":
        return sublane_gather_plain(tab, idx, group)
    rows_per = sublane_plan(tab.shape[0], idx.shape[0]) if group == 0 else None
    if rows_per is None:
        return _launch("sublane_gather", tab, idx, lambda lib, out: lib.sublane_gather(
            tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], group, native.stream_of(idx)))
    return _launch("sublane_gather", tab, idx, lambda lib, out: lib.sublane_gather_slab(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0], idx.shape[0], rows_per,
        native.stream_of(idx)), staged=True)
