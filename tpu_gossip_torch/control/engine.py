"""In-round adaptive control: the feedback engine's device half.

Ports ``tpu_gossip/control/engine.py``. Two hooks, shared by every
engine:

- :func:`control_round` runs at the top of the round: it resolves the
  state's cursor (``control_lvl``) against the :class:`ControlSpec` into
  the round's :class:`RoundControl`: the effective fanout ``m_eff``, the
  pull gate ``pull_on``, the exactly-k draw width (``hi``) and, with the
  needy-pull gate, the rows still missing a live message. Delivery
  consumes it: the exactly-k path draws at width ``hi`` and darkens the
  columns past ``m_eff``, every Bernoulli-per-edge path scales its
  activation law to ``m_eff/deg`` (same draws, only thresholds move).
- :func:`apply_control` runs as the last stage of the round: it moves the
  cursor AIMD-style from the round's duplicate rate, the fault head's
  realized loss and each stream slot's age against its TTL, and runs the
  PeerSwap refresh on the re-wiring plane from ``fold_in(rng,
  CONTROL_STREAM_SALT)``, drawn at full ``(N,)`` shape every controlled
  round and masked by the cadence.

Every decision stays a device tensor: nothing here reads a value back to
the host. The ratios are float32 and the cursor arithmetic int32, as JAX
computes them, so every threshold compare falls as JAX's does.

Both hooks take the ``rows`` (``core.rows``) the planes hold. On a
process of a mesh over several processes every count a decision reads
(the slots' live coverage, the incoming and duplicate bits, the fault
head's drops and deliveries) is summed over the processes first, in one
integer all-reduce a hook, so every process moves the whole cursor
alike; the refresh draws its rows' block of each ``(N,)`` draw, reads
``exists`` at the drawn endpoints from the gathered plane and lands the
credit on the endpoints' holders.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.streams import CONTROL_STREAM_SALT
from tpu_gossip_torch.sim.stages import _add_at

__all__ = [
    "CONTROL_STREAM_SALT",
    "RoundControl",
    "ControlTelemetry",
    "control_round",
    "apply_control",
    "peerswap_refresh",
]


class RoundControl(NamedTuple):
    """One round's resolved control decision (consumed by delivery)."""

    m_eff: torch.Tensor  # int32 (): effective fanout this round
    pull_on: torch.Tensor  # bool (): run the pull half (push_pull mode)
    lvl: torch.Tensor  # int32 (): resolved level index into the tables
    width: int  # draw width of the exactly-k paths (= spec.hi)
    needy: torch.Tensor | None  # (N,) bool: rows missing a live message, or None


class ControlTelemetry(NamedTuple):
    """Per-round controller counters for RoundStats (int32 scalars)."""

    level: torch.Tensor  # level that drove this round's fanout
    fanout: torch.Tensor  # effective fanout this round
    duplicate: torch.Tensor  # delivered bits landing on already-seen slots
    refreshed: torch.Tensor  # PeerSwap slot swaps applied this round


def _live_counts(seen: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(M + 1,) int32: each slot's live column count, then the live count."""
    return torch.cat([(seen & live[:, None]).sum(dim=0, dtype=torch.int32), live.sum(dtype=torch.int32)[None]])


def _slot_coverage(counts: torch.Tensor) -> torch.Tensor:
    """Each slot's live coverage from :func:`_live_counts` (the swarm's),
    float32: the int32 column count over the live count (at least 1),
    divided in float32."""
    return counts[:-1].to(torch.float32) / torch.clamp(counts[-1], min=1).to(torch.float32)


def control_round(spec, state, want_needy: bool = False, rows=ALL_ROWS) -> RoundControl:
    """Resolve the state's cursor into this round's decision.

    The cursor packs ``level + levels * stress_bit``; -1 starts on
    ``spec.start`` and a cursor saved under other bounds clips into the
    table. The pull gate ORs the level's table entry, the stress bit and
    the knee gate (some live lease between ``pull_knee`` and the target).
    ``want_needy`` (the mode is push_pull) computes the needy rows when the
    spec's needy-pull gate is on. ``state`` needs ``control_lvl``,
    ``alive``, ``declared_dead``, ``seen`` (bool) and ``slot_lease``, its
    row planes holding ``rows``; the needy rows are its own."""
    levels = spec.levels
    raw = state.control_lvl.to(torch.int32)
    cursor = torch.clamp(raw, 0, 2 * levels - 1)
    fresh = raw < 0
    lvl = torch.where(fresh, torch.full_like(cursor, spec.start), cursor % levels).to(torch.int32)
    stress_bit = ~fresh & (cursor >= levels)
    live = state.alive & ~state.declared_dead
    slot_cov = _slot_coverage(rows.sum(_live_counts(state.seen, live), label="control"))
    leased = state.slot_lease >= 0
    knee_gate = (leased & (slot_cov < spec.target_ratio) & (slot_cov >= spec.pull_knee)).any()
    needy = None
    if spec.pull_needy and want_needy:
        needy = (leased[None, :] & ~state.seen).any(dim=1)
    idx = lvl.to(torch.int64)
    return RoundControl(m_eff=spec.fanout_table[idx], pull_on=spec.pull_table[idx] | stress_bit | knee_gate,
                        lvl=lvl, width=spec.hi, needy=needy)


def apply_control(spec, rng, rnd, rc: RoundControl, *, incoming, seen_prev, seen, alive, declared_dead, exists,
                  rewired, rewire_targets, degree_credit, row_ptr, col_idx, slot_lease, rewire_slots: int,
                  fstats=None, rows=ALL_ROWS):
    """One AIMD level update and the PeerSwap refresh; returns
    ``(control_lvl, rewire_targets, degree_credit, ControlTelemetry)``.

    ``rng`` is the round's root key; the refresh draws from its
    ``CONTROL_STREAM_SALT`` fold. Widening (+1 level) wins over the
    multiplicative shrink; the shrink floors at the baseline while a live
    message is under target; the stress bit records a widened round. The
    refresh releases the swapped-out edge's degree credit and grants the
    new one's, so the credit book keeps tracking the stored fresh
    targets. The row planes hold ``rows``: the decision's counts are the
    swarm's (one all-reduce)."""
    levels = spec.levels
    dev = alive.device
    i32 = torch.int32
    live = alive & ~declared_dead
    inc_live = incoming & live[:, None]
    head = [inc_live.sum(dtype=i32), (inc_live & seen_prev).sum(dtype=i32)]
    if fstats is not None:
        head += [fstats.msgs_dropped.to(i32), fstats.msgs_delivered.to(i32)]
    counts = rows.sum(torch.cat([torch.stack(head), _live_counts(seen, live)]), label="control")
    total_inc, duplicate = counts[0], counts[1]
    dup_rate = duplicate.to(torch.float32) / torch.clamp(total_inc, min=1).to(torch.float32)
    saturated = (total_inc > 0) & (dup_rate >= spec.sat_dup)

    under = torch.zeros((), dtype=torch.bool, device=dev)
    if fstats is not None:
        dropped = counts[2].to(torch.float32)
        landed = counts[3].to(torch.float32)
        loss_ratio = dropped / torch.clamp(dropped + landed, min=1.0)
        under = under | (loss_ratio > (1.0 - spec.target_ratio))
    uncovered = (slot_lease >= 0) & (_slot_coverage(counts[len(head):]) < spec.target_ratio)
    floor = torch.where(uncovered.any(), spec.base_idx, 0).to(i32)
    if spec.ttl > 0:
        age = rnd.to(i32) - slot_lease.to(i32)
        under = under | (uncovered & (2 * age >= spec.ttl)).any()

    lvl = torch.where(under, torch.clamp(rc.lvl + 1, max=levels - 1),
                      torch.where(saturated, torch.div(rc.lvl, 2, rounding_mode="floor"), rc.lvl))
    lvl = torch.clamp(torch.maximum(lvl, floor), max=levels - 1).to(i32)
    cursor = (lvl + levels * under.to(i32)).to(i32)

    refreshed = torch.zeros((), dtype=i32, device=dev)
    if spec.refresh_every > 0 and rewire_slots > 0 and col_idx.shape[0] > 1:
        rewire_targets, degree_credit, refreshed = peerswap_refresh(
            spec, rng, rnd, exists=exists, rewired=rewired, alive=alive, rewire_targets=rewire_targets,
            degree_credit=degree_credit, row_ptr=row_ptr, col_idx=col_idx, rewire_slots=rewire_slots, rows=rows)

    telem = ControlTelemetry(level=rc.lvl, fanout=rc.m_eff.to(i32), duplicate=duplicate, refreshed=refreshed)
    return cursor, rewire_targets, degree_credit, telem


def peerswap_refresh(spec, rng, rnd, *, exists, rewired, alive, rewire_targets, degree_credit, row_ptr, col_idx,
                     rewire_slots: int, rows=ALL_ROWS):
    """The PeerSwap refresh of :func:`apply_control`; returns
    ``(rewire_targets, degree_credit, refreshed)``. Every row draws one
    fresh-edge slot and one endpoint (a uniform index below ``row_ptr[-1]``
    into the CSR endpoint list, the churn-join law) from ``split(fold_in(
    rng, CONTROL_STREAM_SALT))`` at full ``(N,)`` shape; live re-wired
    members swap on the rounds the cadence names. A self draw or a draw on
    a non-member becomes -1. The swapped-out target's credit is released
    and the new one's granted, each scatter-add dropping its masked
    entries. The planes hold ``rows`` (``core.rows``): their block of each
    draw, the self test on the swarm's row ids, ``exists`` at the
    endpoints from the gathered plane, the credit on the endpoints'
    holders."""
    n = exists.shape[0]
    dev = exists.device
    lo, n_all = rows.lo, rows.total(n)
    k_slot, k_tgt = prng.split(prng.fold_in(rng, CONTROL_STREAM_SALT))
    due = (rnd % spec.refresh_every) == 0
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    slot = prng.randint(k_slot, (n,), 0, rewire_slots, lo).to(torch.int64)
    e_real = torch.clamp(row_ptr[-1], min=1)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    draws = col_idx[prng.randint(k_tgt, (n,), 0, e_real, lo).to(torch.int64)].to(torch.int64)
    (exists_all,) = rows.gather(exists, label="control")
    ok = exists_all[torch.clamp(draws, 0, n_all - 1)] & (draws != torch.arange(lo, lo + n, device=dev))
    new_tgt = torch.where(ok, draws, -1).to(rewire_targets.dtype)
    act = due & rewired & alive & exists
    held = torch.arange(n, dtype=torch.int64, device=dev)
    old = rewire_targets[held, slot]
    degree_credit = _add_at(degree_credit, (old, act & (old >= 0), -1), (new_tgt, act & (new_tgt >= 0), 1),
                            rows=rows, label="control")
    rewire_targets = rewire_targets.clone()
    rewire_targets[held, slot] = torch.where(act, new_tgt, old)
    return rewire_targets, degree_credit, act.sum(dtype=torch.int32)
