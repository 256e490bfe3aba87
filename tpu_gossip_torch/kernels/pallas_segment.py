"""Staircase segment delivery over the CSR: plans, word packing and K5.

Ports ``tpu_gossip/kernels/pallas_segment.py``. Message bitmaps are packed
into int32 words per peer (one word per 32-slot group); the CSR's
destination-grouped edges are cut into 1024-edge tiles that never cross a
``rows``-row output block (:func:`build_staircase_plan` on the host,
:func:`build_staircase_plan_device` on the card, equal routing tables).
Each round gathers the senders' words along the tiles and hands them to
K5, :func:`staircase_segment` (``csrc/staircase_segment.cu``): per
destination row, the OR of the words of its in-edges and, optionally, the
SUM of an int32 bill per edge. :func:`segment_or` is flood delivery,
:func:`segment_sampled` sampled push / push-pull with one precomputed
uint32 Bernoulli threshold per edge slot and direction.

:func:`stream_segment_or` is K6 (``csrc/stream_segment.cu``), the windowed
form that the bucketed sharded engine's receive runs (``dist/mesh.py``):
tile ``t`` reads its 1024 words from window ``window_idx[t]`` of a flat
word stream (the exchange's destination-sorted result) instead of from a
gathered array.

The TPU kernels contract a one-hot "staircase" matrix on the MXU and zero
each output block on its first visit (the plan's ``first_visit`` table).
The card needs neither: K5 and K6 reduce runs of equal destination with
warp shuffles and atomics into outputs the wrapper zeroes, so the port's
plans carry no ``first_visit``. The adaptive controller's hooks of
``segment_sampled`` rescale its push thresholds and mask its pull half in
the wrapper (:func:`scaled_push_thresholds`); K5 is launched unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.device_topology import repeat_ids
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels import native

__all__ = [
    "ROWS",
    "TILE",
    "StaircasePlan",
    "build_staircase_plan",
    "build_staircase_plan_device",
    "pack_words",
    "unpack_words",
    "bernoulli_threshold_device",
    "popcount",
    "staircase_plain",
    "staircase_segment",
    "stream_segment_plain",
    "stream_segment_or",
    "segment_or",
    "segment_sampled",
    "scaled_push_thresholds",
]

ROWS = 1024  # output rows per block
TILE = 1024  # edge slots per tile, stored as (8, 128)


@dataclasses.dataclass(frozen=True)
class StaircasePlan:
    """Static routing tables for one graph. ``offs`` is each slot's row
    offset inside its tile's block, -1 on padding; ``col_gather`` the
    sender (graph ``col_idx``) per slot, 0 on padding. With a ``fanout``,
    ``push_thresh``/``pull_thresh`` hold per-slot uint32 Bernoulli
    thresholds (as int64), 0 on padding."""

    tile_block: torch.Tensor  # int32 (T,)
    offs: torch.Tensor  # int32 (T*8, 128)
    col_gather: torch.Tensor  # int32 (T*8, 128)
    n: int
    n_tiles: int
    n_blocks: int
    push_thresh: torch.Tensor | None = None  # int64 (T*8, 128)
    pull_thresh: torch.Tensor | None = None  # int64 (T*8, 128)
    fanout: int | None = None
    rows: int = ROWS


def pack_words(bitmap: torch.Tensor) -> torch.Tensor:
    """(N, M<=32) bool -> (N,) int32, bit m = slot m."""
    m = bitmap.shape[1]
    if m > 32:
        raise ValueError(f"msg_slots={m} exceeds the 32-bit packing width")
    shifts = torch.arange(m, dtype=torch.int64, device=bitmap.device)
    v = (bitmap.to(torch.int64) << shifts).sum(1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _slot_groups(m: int) -> list[tuple[int, int]]:
    """[(lo, width), ...] cutting M slots into <=32-bit word groups."""
    return [(lo, min(32, m - lo)) for lo in range(0, m, 32)]


def unpack_words(words: torch.Tensor, m: int) -> torch.Tensor:
    """(N,) int32 -> (N, m) bool."""
    shifts = torch.arange(m, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts[None, :]) & 1).to(torch.bool)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set-bit count of int32 words (SWAR), as int32:
    ``jax.lax.population_count``'s value."""
    # graftlint: disable=mem-widening-cast -- the int32 word is read unsigned in int64
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _pad_tiles(t: int) -> int:
    """A tile count rounded up to its ~0.8% bucket (the JAX package's
    compile-sharing quantization, kept so the tables stay equal)."""
    b = max(1, 1 << max(0, t.bit_length() - 7))
    return -(-t // b) * b


def _bernoulli_threshold(p: np.ndarray) -> np.ndarray:
    """Host law: P(u32 < thresh) == min(p, 1), in float64."""
    return np.minimum(np.ceil(np.clip(p, 0.0, 1.0) * 2.0**32), 2.0**32 - 1).astype(np.uint32)


def bernoulli_threshold_device(p: torch.Tensor) -> torch.Tensor:
    """uint32 firing thresholds (as int64) for float32 probabilities ``p``:
    ``min(ceil(clip(p, 0, 1) * 2^32), 4294967040)`` computed in float32,
    4294967040 being the largest float32 below 2^32."""
    t = torch.ceil(torch.clamp(p, 0.0, 1.0) * 4294967296.0)
    # graftlint: disable=mem-widening-cast -- the uint32 Bernoulli threshold compares in int64 (torch has no uint32 compare)
    return torch.minimum(t, torch.full((), 4294967040.0, dtype=torch.float32, device=p.device)).to(torch.int64)


def _check_rows(rows: int) -> None:
    if rows % 128 != 0 or rows <= 0:
        raise ValueError(f"rows must be a positive multiple of 128, got {rows}")


def build_staircase_plan(row_ptr, col_idx, fanout: int | None = None, *, rows: int = ROWS,
                         n_tiles: int | None = None, device: str | torch.device = "cuda") -> StaircasePlan:
    """Cut the CSR's destination-grouped edges into tiles on the host
    (numpy, float64 thresholds) and move the tables to ``device``.

    Every block gets at least one tile and no tile spans two blocks.
    ``n_tiles`` forces the grid to an exact size (the extra tiles ride the
    last block with every slot -1) instead of the quantized minimum."""
    _check_rows(rows)
    dev = resolve_device(device)
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)  # noqa: E731
    row_ptr = host(row_ptr).astype(np.int64)
    col_idx = host(col_idx).astype(np.int64)
    n = len(row_ptr) - 1
    n_blocks = max(1, math.ceil(n / rows))

    starts = row_ptr[np.minimum(np.arange(n_blocks) * rows, n)]
    ends = row_ptr[np.minimum((np.arange(n_blocks) + 1) * rows, n)]
    tiles_per_block = np.maximum(1, np.ceil((ends - starts) / TILE).astype(np.int64))
    t_real = int(tiles_per_block.sum())
    T = _pad_tiles(t_real) if n_tiles is None else n_tiles
    if T < t_real:
        raise ValueError(f"n_tiles={T} below the plan's minimum {t_real}")
    tiles_per_block[-1] += T - t_real

    tile_block = np.repeat(np.arange(n_blocks, dtype=np.int32), tiles_per_block)
    tile_ord = np.arange(T) - np.repeat(np.cumsum(tiles_per_block) - tiles_per_block, tiles_per_block)
    tile_start = np.repeat(starts, tiles_per_block) + tile_ord * TILE
    tile_len = np.maximum(np.minimum(np.repeat(ends, tiles_per_block) - tile_start, TILE), 0)

    deg = row_ptr[1:] - row_ptr[:-1]
    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    if dst.size == 0:
        # edgeless CSR: every slot is padding, but the safe index reads slot 0
        dst = np.zeros(1, dtype=np.int64)
        col_idx = np.zeros(1, dtype=np.int64)
    slot = np.arange(TILE, dtype=np.int64)
    eidx = tile_start[:, None] + slot[None, :]
    valid = slot[None, :] < tile_len[:, None]
    eidx_safe = np.where(valid, eidx, 0)
    edge_dst = dst[eidx_safe]
    offs = np.where(valid, edge_dst - tile_block[:, None].astype(np.int64) * rows, -1).astype(np.int32)
    cols = np.where(valid, col_idx[eidx_safe], 0).astype(np.int32)

    tab = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    push_thresh = pull_thresh = None
    if fanout is not None:
        # push: sender j fires each out-edge w.p. fanout/deg(j); pull:
        # receiver i draws each in-edge w.p. 1/deg(i)
        src_deg = np.where(valid, deg[col_idx[eidx_safe]], 0)
        dst_deg = np.where(valid, deg[edge_dst], 0)
        with np.errstate(divide="ignore"):
            push = np.where(valid & (src_deg > 0), _bernoulli_threshold(fanout / np.maximum(src_deg, 1)), 0)
            pull = np.where(valid & (dst_deg > 0), _bernoulli_threshold(1.0 / np.maximum(dst_deg, 1)), 0)
        push_thresh = tab(push.astype(np.int64).reshape(T * 8, 128))
        pull_thresh = tab(pull.astype(np.int64).reshape(T * 8, 128))
    return StaircasePlan(
        tile_block=tab(tile_block), offs=tab(offs.reshape(T * 8, 128)), col_gather=tab(cols.reshape(T * 8, 128)),
        n=n, n_tiles=T, n_blocks=n_blocks, push_thresh=push_thresh, pull_thresh=pull_thresh,
        fanout=fanout, rows=rows,
    )


def build_staircase_plan_device(row_ptr: torch.Tensor, col_idx: torch.Tensor, fanout: int | None = None, *,
                                rows: int = ROWS) -> StaircasePlan:
    """:func:`build_staircase_plan` computed where the CSR lives, with one
    host synchronisation (the tile count that sizes the tables). Routing
    tables equal the host build's; thresholds are float32
    (:func:`bernoulli_threshold_device`): within 2^-24 relative of the
    host's float64 ones before the ceil, which may then differ by one."""
    _check_rows(rows)
    dev = row_ptr.device
    row_ptr = row_ptr.to(torch.int64)
    col_idx = col_idx.to(torch.int64)
    n = int(row_ptr.shape[0]) - 1
    n_blocks = max(1, math.ceil(n / rows))
    blocks = torch.arange(n_blocks, dtype=torch.int64, device=dev)
    starts = row_ptr[torch.clamp(blocks * rows, max=n)]
    ends = row_ptr[torch.clamp((blocks + 1) * rows, max=n)]
    tpb = torch.clamp(-torch.div(starts - ends, TILE, rounding_mode="floor"), min=1)
    t_real = int(tpb.sum())  # the one host sync
    T = _pad_tiles(t_real)
    tpb[-1] += T - t_real

    tile_block = repeat_ids(tpb, T).to(torch.int64)
    tile_ord = torch.arange(T, dtype=torch.int64, device=dev) - (torch.cumsum(tpb, 0) - tpb)[tile_block]
    tile_start = starts[tile_block] + tile_ord * TILE
    tile_len = torch.clamp(ends[tile_block] - tile_start, 0, TILE)

    deg = row_ptr[1:] - row_ptr[:-1]
    if col_idx.numel() == 0:
        dst = torch.zeros(1, dtype=torch.int64, device=dev)
        col_idx = dst
    else:
        dst = repeat_ids(deg, col_idx.shape[0]).to(torch.int64)
    slot = torch.arange(TILE, dtype=torch.int64, device=dev)
    valid = slot[None, :] < tile_len[:, None]
    eidx_safe = torch.where(valid, tile_start[:, None] + slot[None, :], 0)
    edge_dst = dst[eidx_safe]
    offs = torch.where(valid, edge_dst - tile_block[:, None] * rows, -1).to(torch.int32)
    src = col_idx[eidx_safe]
    cols = torch.where(valid, src, 0).to(torch.int32)

    push_thresh = pull_thresh = None
    if fanout is not None:
        src_deg = torch.where(valid, deg[src], 0)
        dst_deg = torch.where(valid, deg[edge_dst], 0)
        p_push = fanout / torch.clamp(src_deg, min=1).to(torch.float32)
        p_pull = 1.0 / torch.clamp(dst_deg, min=1).to(torch.float32)
        push_thresh = torch.where(valid & (src_deg > 0), bernoulli_threshold_device(p_push), 0).view(T * 8, 128)
        pull_thresh = torch.where(valid & (dst_deg > 0), bernoulli_threshold_device(p_pull), 0).view(T * 8, 128)
    return StaircasePlan(
        tile_block=tile_block.to(torch.int32), offs=offs.view(T * 8, 128), col_gather=cols.view(T * 8, 128),
        n=n, n_tiles=T, n_blocks=n_blocks, push_thresh=push_thresh, pull_thresh=pull_thresh,
        fanout=fanout, rows=rows,
    )


def _check_staircase(tile_block, offs, vals, rows, n_blocks, bill) -> None:
    _check_rows(rows)
    t = tile_block.shape[0]
    shape = (t * 8, 128)
    if tile_block.dim() != 1 or tile_block.dtype != torch.int32:
        raise ValueError(f"tile_block must be int32 (T,), got {tile_block.dtype}{tuple(tile_block.shape)}")
    for name, a in (("offs", offs), ("vals", vals), ("bill", bill)):
        if a is not None and (tuple(a.shape) != shape or a.dtype != torch.int32):
            raise ValueError(f"{name} must be int32 {shape}, got {a.dtype}{tuple(a.shape)}")
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")


def staircase_plain(tile_block: torch.Tensor, offs: torch.Tensor, vals: torch.Tensor, rows: int,
                    n_blocks: int, bill: torch.Tensor | None = None):
    """Plain version of K5: ``words[b*rows + offs[e]] |= vals[e]`` and
    ``sums[b*rows + offs[e]] += bill[e]`` over slots with ``offs >= 0``,
    ``b = tile_block[e // 1024]``; one ``index_add_`` per bit. Returns
    ``(words, sums)``, int32 (n_blocks*rows,) each (``sums`` None unbilled)."""
    _check_staircase(tile_block, offs, vals, rows, n_blocks, bill)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    o = offs.reshape(-1).to(torch.int64)
    keep = o >= 0
    base = torch.repeat_interleave(tile_block.to(torch.int64) * rows, TILE)
    dest = (base + o)[keep]
    v = vals.reshape(-1)[keep]
    size = n_blocks * rows
    words = torch.zeros((size,), dtype=torch.int64, device=vals.device)
    for s in range(32):
        hits = torch.zeros((size,), dtype=torch.int32, device=vals.device)
        hits.index_add_(0, dest, (v >> s) & 1)
        words |= (hits > 0).to(torch.int64) << s
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    sums = None
    if bill is not None:
        sums = torch.zeros((size,), dtype=torch.int32, device=vals.device)
        sums.index_add_(0, dest, bill.reshape(-1)[keep])
    return words, sums


def staircase_segment(tile_block: torch.Tensor, offs: torch.Tensor, vals: torch.Tensor, rows: int,
                      n_blocks: int, bill: torch.Tensor | None = None):
    """K5: per-row OR of the words (and SUM of the bill) of each row's
    slots, as :func:`staircase_plain` defines it. Takes the plain version
    for CPU tensors only; on CUDA tensors it launches the kernel or raises."""
    _check_staircase(tile_block, offs, vals, rows, n_blocks, bill)
    if vals.device.type == "cpu":
        return staircase_plain(tile_block, offs, vals, rows, n_blocks, bill)
    ops = (tile_block, offs, vals) + ((bill,) if bill is not None else ())
    native.require_cuda("staircase_segment", *ops)
    if any(a.data_ptr() % 16 for a in ops[1:]):
        raise ValueError("staircase_segment: offs/vals/bill must be 16-byte aligned")
    size = n_blocks * rows
    words = torch.zeros((size,), dtype=torch.int32, device=vals.device)
    sums = torch.zeros((size,), dtype=torch.int32, device=vals.device) if bill is not None else None
    native.check(
        native.library("staircase_segment").staircase_segment(
            tile_block.data_ptr(), offs.data_ptr(), vals.data_ptr(),
            None if bill is None else bill.data_ptr(), words.data_ptr(),
            None if sums is None else sums.data_ptr(),
            tile_block.shape[0], rows, n_blocks, native.stream_of(vals),
        ),
        "staircase_segment",
    )
    native.LAUNCHES["staircase_segment"] += 1
    return words, sums


def _check_stream(tile_block, window_idx, offs, vals_flat, rows, n_blocks) -> None:
    _check_rows(rows)
    t = tile_block.shape[0]
    if tile_block.dim() != 1 or tile_block.dtype != torch.int32:
        raise ValueError(f"tile_block must be int32 (T,), got {tile_block.dtype}{tuple(tile_block.shape)}")
    if tuple(window_idx.shape) != (t,) or window_idx.dtype != torch.int32:
        raise ValueError(f"window_idx must be int32 ({t},), got {window_idx.dtype}{tuple(window_idx.shape)}")
    if tuple(offs.shape) != (t * 8, 128) or offs.dtype != torch.int32:
        raise ValueError(f"offs must be int32 ({t * 8}, 128), got {offs.dtype}{tuple(offs.shape)}")
    if vals_flat.dim() != 1 or vals_flat.dtype != torch.int32 or vals_flat.shape[0] % TILE:
        raise ValueError(f"vals_flat must be int32 (L,) with L a multiple of {TILE}, "
                         f"got {vals_flat.dtype}{tuple(vals_flat.shape)}")
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    if t:
        # graftlint: disable=round-host-sync -- K6's window range is checked on the host before the launch; parked perf item
        lo, hi = torch.stack(torch.aminmax(window_idx)).tolist()
        if lo < 0 or hi >= vals_flat.shape[0] // TILE:
            raise ValueError(f"window_idx must lie in [0, {vals_flat.shape[0] // TILE}), got [{lo}, {hi}]")


def stream_segment_plain(tile_block: torch.Tensor, window_idx: torch.Tensor, offs: torch.Tensor,
                         vals_flat: torch.Tensor, rows: int, n_blocks: int) -> torch.Tensor:
    """Plain version of K6: gather each tile's window, ``vals[t*1024 + j] =
    vals_flat[window_idx[t]*1024 + j]``, then :func:`staircase_plain`'s
    segment OR. Returns the int32 (n_blocks*rows,) words."""
    _check_stream(tile_block, window_idx, offs, vals_flat, rows, n_blocks)
    vals = vals_flat.reshape(-1, TILE).index_select(0, window_idx.to(torch.int64)).view(offs.shape)
    return staircase_plain(tile_block, offs, vals, rows, n_blocks)[0]


def stream_segment_or(tile_block: torch.Tensor, window_idx: torch.Tensor, offs: torch.Tensor,
                      vals_flat: torch.Tensor, rows: int, n_blocks: int) -> torch.Tensor:
    """K6: the per-row OR of a flat word stream read through per-tile
    windows, as :func:`stream_segment_plain` defines it. Takes the plain
    version for CPU tensors only; on CUDA tensors it launches the kernel or
    raises. Checking the windows against the stream reads two numbers back
    from the card."""
    _check_stream(tile_block, window_idx, offs, vals_flat, rows, n_blocks)
    if vals_flat.device.type == "cpu":
        return stream_segment_plain(tile_block, window_idx, offs, vals_flat, rows, n_blocks)
    return _stream_launch(tile_block, window_idx, offs, vals_flat, rows, n_blocks)


def _stream_launch(tile_block, window_idx, offs, vals_flat, rows: int, n_blocks: int) -> torch.Tensor:
    """K6's launch on tables :func:`_check_stream` passed."""
    native.require_cuda("stream_segment", tile_block, window_idx, offs, vals_flat)
    if offs.data_ptr() % 16 or vals_flat.data_ptr() % 16:
        raise ValueError("stream_segment: offs/vals_flat must be 16-byte aligned")
    words = torch.zeros((n_blocks * rows,), dtype=torch.int32, device=vals_flat.device)
    native.check(
        native.library("stream_segment").stream_segment(
            tile_block.data_ptr(), window_idx.data_ptr(), offs.data_ptr(), vals_flat.data_ptr(),
            words.data_ptr(), tile_block.shape[0], rows, n_blocks,
            native.stream_of(vals_flat),
        ),
        "stream_segment",
    )
    native.LAUNCHES["stream_segment"] += 1
    return words


def _launch(plan: StaircasePlan, vals: torch.Tensor, m: int, bill: torch.Tensor | None = None):
    """K5 over pre-gathered per-slot words ``vals`` (T*8, 128) int32 ->
    (plan.n, m) bool; with ``bill``, also the (plan.n,) float32 row sums."""
    words, sums = staircase_segment(plan.tile_block, plan.offs, vals, plan.rows, plan.n_blocks, bill)
    inc = unpack_words(words[: plan.n], m)
    if bill is None:
        return inc
    return inc, sums[: plan.n].to(torch.float32)


def _gather_words(plan: StaircasePlan, bitmap: torch.Tensor) -> torch.Tensor:
    """Packed (N, <=32) words of each slot's sender, (T*8, 128) int32."""
    return pack_words(bitmap).index_select(0, plan.col_gather.view(-1)).view(plan.col_gather.shape)


def segment_or(plan: StaircasePlan, transmit: torch.Tensor, m: int) -> torch.Tensor:
    """incoming[i] = OR over CSR neighbours j of transmit[j] (flood): one
    word gather and one K5 launch per 32-slot group."""
    outs = [_launch(plan, _gather_words(plan, transmit[:, lo: lo + w]), w) for lo, w in _slot_groups(m)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def segment_sampled(plan: StaircasePlan, transmit: torch.Tensor, answer: torch.Tensor | None, m: int,
                    key: torch.Tensor, *, receptive_rows: torch.Tensor | None = None, do_push: bool = True,
                    do_pull: bool = False, fanout=None, pull_gate=None, pull_needy_rows=None):
    """Sampled (push / push-pull) delivery, one K5 launch per 32-slot group;
    returns ``(incoming (N, m) bool, msgs_sent int32)``.

    ``split(key)`` gives the push and pull keys; each direction draws one
    ``bits`` plane over the slots, shared by every word group, and an edge
    fires where its draw is below the plan's threshold. Push and pull words
    are OR-combined per slot. ``answer=None`` answers pulls with
    ``transmit``. The pull bill (one request per fired pull edge plus the
    pulled bits) is summed per puller row by K5 on the last group's launch.
    ``receptive_rows`` masks whole rows after the kernel, deliveries and
    bill alike. ``msgs`` counts delivered push bits plus the billed rows.

    The controller's round decision: ``fanout`` (int32 0-d tensor) rescales
    the plan's push thresholds (:func:`scaled_push_thresholds`);
    ``pull_gate`` (bool 0-d) masks the pull activation; ``pull_needy_rows``
    ((N,) bool) masks the billed rows after K5, as the receptive mask does
    (a sated row's pulled bits still merge: it holds every live bit they
    could carry). K5 itself is launched unchanged."""
    check_control_hooks(transmit.shape[0], fanout, pull_gate, pull_needy_rows)
    if plan.push_thresh is None:
        raise ValueError("plan built without fanout — no sampling thresholds")
    if m > 2**18:
        raise ValueError(f"msg_slots={m} out of the supported range (<= 2^18)")
    shape = tuple(plan.col_gather.shape)
    k_push, k_pull = prng.split(key)
    msgs = torch.zeros((), dtype=torch.int64, device=transmit.device)
    active_p = active_q = pull_bill = bill_row = None
    if do_push:
        pt = plan.push_thresh if fanout is None else scaled_push_thresholds(plan, fanout)
        active_p = prng.bits(k_push, shape) < pt
    if do_pull:
        active_q = prng.bits(k_pull, shape) < plan.pull_thresh
        if pull_gate is not None:
            active_q = active_q & pull_gate
        pull_bill = active_q.to(torch.int32)
    groups = _slot_groups(m)
    outs = []
    for gi, (lo, w) in enumerate(groups):
        w_push = _gather_words(plan, transmit[:, lo: lo + w])
        combined = torch.zeros(shape, dtype=torch.int32, device=transmit.device)
        if do_push:
            wp = torch.where(active_p, w_push, 0)
            combined |= wp
            msgs = msgs + popcount(wp).sum()
        if do_pull:
            w_ans = w_push if answer is None else _gather_words(plan, answer[:, lo: lo + w])
            wq = torch.where(active_q, w_ans, 0)
            combined |= wq
            pull_bill = pull_bill + popcount(wq)
        if do_pull and gi == len(groups) - 1:
            inc, bill_row = _launch(plan, combined, w, bill=pull_bill)
        else:
            inc = _launch(plan, combined, w)
        outs.append(inc)
    incoming = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if receptive_rows is not None:
        incoming = incoming & receptive_rows[:, None]
    if do_pull:
        billed = torch.round(bill_row).to(torch.int32)
        if receptive_rows is not None:
            billed = torch.where(receptive_rows, billed, 0)
        if pull_needy_rows is not None:
            billed = torch.where(pull_needy_rows, billed, 0)
        msgs = msgs + billed.sum()
    return incoming, msgs.to(torch.int32)


def check_control_hooks(n: int, fanout, pull_gate, pull_needy_rows) -> None:
    """The sampled kernels' controller hooks are the round's decision: a
    0-d effective ``fanout`` and ``pull_gate`` and an (n,) bool
    ``pull_needy_rows``, or None."""
    for name, hook, shape in (("fanout", fanout, ()), ("pull_gate", pull_gate, ()),
                              ("pull_needy_rows", pull_needy_rows, (n,))):
        if hook is not None and tuple(hook.shape) != shape:
            raise ValueError(f"{name} must be a tensor of shape {shape} (the controller's round decision), "
                             f"got shape {tuple(hook.shape)}")


def scaled_push_thresholds(plan: StaircasePlan, fanout: torch.Tensor) -> torch.Tensor:
    """The plan's uint32 push thresholds (int64) at the controller's
    effective ``fanout`` (int32 0-d tensor), as XLA computes JAX's
    ``pt.astype(f32) * (fanout.astype(f32) / f32(plan.fanout))``: the
    division by the constant compiles to a multiply by the float32
    reciprocal (for ``plan.fanout = 3`` and ``fanout = 5``, ``5 *
    0.333333343`` rounds to 1.66666675 where ``5 / 3`` gives 1.66666663).
    Then the float32 product, the ``2^32 - 2^8`` cap, truncation to an
    unsigned integer, and the plan's own table where ``fanout`` is the
    plan's fanout."""
    f32 = torch.float32
    dev = plan.push_thresh.device
    recip = torch.full((), 1.0, dtype=f32, device=dev) / torch.full((), float(plan.fanout), dtype=f32, device=dev)
    scale = fanout.to(f32) * recip
    cap = torch.full((), 2.0 ** 32 - 2.0 ** 8, dtype=f32, device=dev)
    # graftlint: disable=mem-widening-cast -- the uint32 Bernoulli threshold compares in int64 (torch has no uint32 compare)
    scaled = torch.minimum(plan.push_thresh.to(f32) * scale, cap).to(torch.int64)
    return torch.where(fanout == plan.fanout, plan.push_thresh, scaled)
