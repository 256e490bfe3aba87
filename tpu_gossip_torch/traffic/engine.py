"""In-round injection and slot age-out: the streaming plane's round half.

Ports ``tpu_gossip/traffic/engine.py``. Both halves run as stages of the
shared round (``sim/stages.py``) on every engine:

- **age-out** (:func:`slot_expiry`): a slot whose lease is ``ttl`` rounds
  old is recycled: its column of every slot plane is cleared through the
  round tail (K3's and K4's ``expired`` mask on the card) and its lease
  frees, so the (N, M) bitmap is a sliding window over live messages;
- **injection** (:func:`apply_stream`): the round's arrivals each draw an
  origin by the configured law and ``k_hashes`` uniform slots, then land
  one after another on the (M,) lease table: with k = 1 a message landing
  on a live lease is conflated (counted, never suppressed), with k >= 2 a
  message whose k slots are all leased is suppressed; free slots among a
  landing message's draws take its lease. The origin's bits are set after
  the tail, so a round-r arrival first transmits in round r + 1.

Every draw comes from ``fold_in(state.rng, TRAFFIC_STREAM_SALT)`` at the
global shape, as in JAX. Two decisions depend only on the round and the
configured rate and are taken on the host: the burst multiplier and the
Poisson count (:func:`round_arrivals`, ``prng.poisson`` on a host copy of
the round's key, whose loop length depends on the draws). The landing
then runs as many steps as the round has arrivals (arrivals past the
count are not live and change nothing), each a handful of (M,)-sized
device operations, and the bits land by order-free scatter-max, so the
card's bits equal the CPU's.

The planes hold the ``rows`` (``core.rows``) each function takes. On a
process of a mesh over several processes the draws and the landing on
the whole lease table run alike on every process; each origin's gate is
answered by the origin's holder (:meth:`~tpu_gossip_torch.core.rows.
Rows.lookup`, ``J`` bits a process), and each process writes the
arrivals at the rows it holds. The telemetry is then the same on every
process.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.state import saturate_round
from tpu_gossip_torch.core.streams import TRAFFIC_STREAM_SALT

__all__ = [
    "TRAFFIC_STREAM_SALT",
    "StreamTelemetry",
    "slot_expiry",
    "round_rate",
    "round_arrivals",
    "stream_draws",
    "land_arrivals",
    "scatter_arrivals",
    "apply_stream",
]

_CSR_FREE = ("degree-weighted stream origins read the CSR endpoint "
             "list, but this graph was built without one "
             "(matching_powerlaw_graph(export_csr=False)); rebuild "
             "with export_csr=True or use origins='uniform'")


class StreamTelemetry(NamedTuple):
    """Per-round streaming counters for RoundStats (all 0-d int32)."""

    offered: torch.Tensor  # arrivals the process produced this round
    injected: torch.Tensor  # arrivals that landed (live origin, not suppressed)
    conflated: torch.Tensor  # k=1: landed on a live lease; k>=2: suppressed
    expired: torch.Tensor  # leases the age-out recycled this round


def slot_expiry(slot_lease: torch.Tensor, rnd: torch.Tensor, ttl: int) -> torch.Tensor:
    """(M,) bool: slots whose lease ages out at round ``rnd`` (a message
    injected at round r expires at r + ttl; free slots, lease -1, never)."""
    return (slot_lease >= 0) & (rnd - slot_lease >= ttl)


def round_rate(stream, host_rnd: int) -> float:
    """The round's float32 Poisson rate: ``rate``, times ``burst_mult`` on
    every ``burst_every``-th round, one float32 product as JAX forms it."""
    rate = np.float32(stream.rate_f32)
    if stream.burst_every > 0 and host_rnd % stream.burst_every == 0:
        rate = np.float32(rate * np.float32(stream.burst_mult))
    # graftlint: disable=round-host-sync -- rate is a numpy float32 on the host
    return float(rate)


def round_arrivals(stream, host_rng: torch.Tensor, host_rnd: int) -> int:
    """The round's arrival count, ``min(poisson(k_count, rate), max_inject)``,
    drawn on the host from ``host_rng``, a host copy of the round's root
    key (``state.rng``)."""
    k_count = prng.split(prng.fold_in(host_rng, TRAFFIC_STREAM_SALT), 5)[0]
    # graftlint: disable=round-host-sync -- the arrival count is drawn on a host copy of the round's key
    return min(int(prng.poisson(k_count, round_rate(stream, host_rnd))), stream.max_inject)


def stream_draws(stream, rng: torch.Tensor, *, n: int, m: int, row_ptr, col_idx, exists, rows=ALL_ROWS):
    """``(origins (J,) int32, slots (J, k) int64)``: every origin and slot
    draw of the round at the static batch shape, from the device key.
    ``n`` is the swarm's row count; ``exists`` holds the rows of
    ``rows``."""
    j, k = stream.max_inject, stream.k_hashes
    _k_count, k_origin, k_hot, k_slot, k_fb = prng.split(prng.fold_in(rng, TRAFFIC_STREAM_SALT), 5)
    n_orig = stream.origin_rows.shape[0]
    if stream.origins == "degree":
        # a uniform index into the CSR endpoint list is degree-proportional;
        # drawn over the real edge span, not a remat capacity tail
        if col_idx.shape[0] == 1 and row_ptr.shape[0] > 3:
            raise ValueError(_CSR_FREE)
        e_real = torch.clamp(row_ptr[-1], min=1)
        draw = col_idx[prng.randint(k_origin, (j,), 0, e_real).to(torch.int64)].to(torch.int32)
        # an endpoint draw on an erased entry falls back to a uniform member
        fallback = stream.origin_rows[prng.randint(k_fb, (j,), 0, n_orig).to(torch.int64)]
        member = rows.lookup(torch.clamp(draw, 0, n - 1).to(torch.int64), exists, label="stream")
        origins = torch.where(member, draw, fallback)
    elif stream.origins == "hotspot":
        k_hot_pick, k_hot_row = prng.split(k_hot)
        uni = stream.origin_rows[prng.randint(k_origin, (j,), 0, n_orig).to(torch.int64)]
        hot = stream.hot_rows[prng.randint(k_hot_row, (j,), 0, stream.hot_rows.shape[0]).to(torch.int64)]
        pick_hot = prng.uniform(k_hot_pick, (j,)) < torch.tensor(stream.hot_weight, dtype=torch.float32,
                                                                  device=rng.device)
        origins = torch.where(pick_hot, hot, uni)
    else:
        origins = stream.origin_rows[prng.randint(k_origin, (j,), 0, n_orig).to(torch.int64)]
    slots = prng.randint(k_slot, (j, k), 0, m).to(torch.int64)
    return origins, slots


def land_arrivals(slot_lease: torch.Tensor, slots: torch.Tensor, ok: torch.Tensor, rnd, k_hashes: int):
    """The sequential landing: arrival ``i`` (``slots[i]``, live when
    ``ok[i]``) sees the leases arrivals ``< i`` took. Returns ``(lease,
    landed (A,), conflated (A,))``; a free slot among a landing message's
    draws takes the round (saturated into the int16 plane), a live lease
    keeps its older round under the max."""
    lease = slot_lease.clone()
    sat = saturate_round(rnd, lease.dtype)
    neg = torch.full_like(sat, -1)
    landed, conflated = [], []
    for i in range(slots.shape[0]):
        sl = slots[i]
        leased = lease[sl] >= 0
        full = leased.all() if k_hashes > 1 else leased[0]
        land = ok[i] & ~full if k_hashes > 1 else ok[i]
        lease.scatter_reduce_(0, sl, torch.where(land & ~leased, sat, neg), "amax")
        landed.append(land)
        conflated.append(ok[i] & full)
    if not landed:
        empty = torch.zeros((0,), dtype=torch.bool, device=lease.device)
        return lease, empty, empty
    return lease, torch.stack(landed), torch.stack(conflated)


def scatter_arrivals(seen: torch.Tensor, infected_round: torch.Tensor, rows: torch.Tensor, slots: torch.Tensor,
                     landed: torch.Tensor, rnd):
    """``seen.at[rows, slots].set(True)`` and the infection latch at the
    landed arrivals' cells, out of place: a scatter-max on the flat planes
    (a repeated cell gets one value, whatever the order), with the
    arrivals that did not land writing what their cell already holds."""
    m = seen.shape[1]
    k = slots.shape[1]
    cell = (rows[:, None].to(torch.int64) * m + slots).reshape(-1)
    hit = landed[:, None].expand(-1, k).reshape(-1)
    seen_flat = seen.reshape(-1).view(torch.uint8)
    new_seen = seen_flat.scatter_reduce(0, cell, hit.to(torch.uint8), "amax").view(torch.bool)
    ir_flat = infected_round.reshape(-1)
    sat = saturate_round(rnd, infected_round.dtype)
    latch = torch.where(hit & (ir_flat[cell] < 0), sat, torch.full_like(sat, -1))
    new_ir = ir_flat.scatter_reduce(0, cell, latch, "amax")
    return new_seen.reshape(seen.shape), new_ir.reshape(infected_round.shape)


def apply_stream(stream, rng: torch.Tensor, rnd: torch.Tensor, expired_count: torch.Tensor, *, seen,
                 infected_round, slot_lease, row_ptr, col_idx, exists, alive, declared_dead,
                 host_rng: torch.Tensor | None = None, host_rnd: int | None = None, rows=ALL_ROWS):
    """Inject one round's arrivals; returns ``(seen, infected_round,
    slot_lease, telemetry)``. The row planes hold ``rows``
    (``core.rows``).

    ``rng`` is the round's root key (``state.rng``) and ``rnd`` the round
    on the device; ``host_rng`` and ``host_rnd`` are their host copies
    (read off the device when not given: one synchronisation each). Runs
    after the tail and the row stages, so origins are gated on the round's
    final liveness (an arrival at a down origin is offered, not injected)
    and a slot the age-out just recycled is leasable again."""
    n_held, m = exists.shape[0], seen.shape[1]
    n = rows.total(n_held)
    if host_rng is None:
        # graftlint: disable=round-host-sync -- a single round without the loops' host cursor copies its key once
        host_rng = rng.cpu()
    if host_rnd is None:
        # graftlint: disable=round-host-sync -- a single round without the loops' host cursor reads its round once
        host_rnd = int(rnd)
    n_arr = round_arrivals(stream, host_rng, host_rnd)
    origins, slots = stream_draws(stream, rng, n=n, m=m, row_ptr=row_ptr, col_idx=col_idx, exists=exists,
                                  rows=rows)
    safe_o = torch.clamp(origins[:n_arr], 0, n - 1).to(torch.int64)
    # each origin's gate from its holder (no arrivals: no collective on any process)
    ok = (rows.lookup(safe_o, exists & alive & ~declared_dead, label="stream") if n_arr
          else torch.zeros((0,), dtype=torch.bool, device=exists.device))
    slot_lease, landed, conflated = land_arrivals(slot_lease, slots[:n_arr], ok, rnd, stream.k_hashes)
    if n_arr:
        mine = (safe_o >= rows.lo) & (safe_o < rows.lo + n_held)
        seen, infected_round = scatter_arrivals(seen, infected_round, torch.where(mine, safe_o - rows.lo, 0),
                                                slots[:n_arr], landed & mine, rnd)
    dev = seen.device
    telem = StreamTelemetry(
        offered=torch.full((), n_arr, dtype=torch.int32, device=dev),
        injected=landed.sum(dtype=torch.int32),
        conflated=conflated.sum(dtype=torch.int32),
        expired=expired_count.to(torch.int32),
    )
    return seen, infected_round, slot_lease, telem
