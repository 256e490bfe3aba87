"""Heartbeats, the direct failure detector and the quorum detector.

Ports ``tpu_gossip/kernels/liveness.py`` whole: ``emit_heartbeats``
(:138) and ``detect_failures`` (:162), the direct stale -> probe -> dead
latch; and the hardened half, ``QuorumSpec`` (:82), ``compile_quorum``
(:120), the packed suspicion plane (``pack_suspicion``/``unpack_suspicion``
:127-136, votes in the low 8 bits, strikes above), ``forge_heartbeats``
(:193) and ``quorum_liveness`` (:236), the witness-quorum suspicion
machine with its accusation attack, strikes and quarantine.

The stored planes are int16; every staleness, window, vote and strike sum
runs at int32, as JAX promotes them, and narrows back through
``saturate_round`` or ``pack_suspicion``. Every scatter here is order-free
(set-True, an integer add, or one value written to each landed target), so
the device's scatter gives the same bits whatever order it runs in. The
forged heartbeats are JAX's ``.at[].max`` of one scalar: a bool scatter of
the landed targets, then one ``where``.

The planes hold a ``core.rows.Rows`` (every row in one process; a block on
a process of a mesh over several processes): the targets and victims are
the block of each of the swarm's draws, the reads at them go through the
gathered planes, the landed targets reach their holders by OR, the
accusation counts by integer SUM, and the witness cohort is the swarm's
count, so a block's result is its rows of the one-process round's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.state import saturate_round

__all__ = [
    "SUSPECT_VOTE_CAP",
    "SUSPECT_STRIKE_CAP",
    "QuorumSpec",
    "LivenessTelemetry",
    "compile_quorum",
    "pack_suspicion",
    "unpack_suspicion",
    "emit_heartbeats",
    "detect_failures",
    "forge_heartbeats",
    "quorum_liveness",
]


class LivenessTelemetry(NamedTuple):
    """Per-round hardened-detector counters for RoundStats (0-d int32)."""

    evictions_new: torch.Tensor  # dead declarations this round
    false_evictions: torch.Tensor  # of those, victims that were responsive
    adv_accusations: torch.Tensor  # false dead-verdicts emitted this round
    adv_forged: torch.Tensor  # forged heartbeats emitted this round


# votes in the low 8 bits (saturating), strikes in the high 7: the largest
# packed value, 255 + 256 * 127 = 32767, is int16's ceiling
SUSPECT_VOTE_CAP = 255
SUSPECT_STRIKE_CAP = 127


@dataclasses.dataclass(frozen=True)
class QuorumSpec:
    """The quorum detector's contract: ``quorum_k`` distinct witness
    confirmations (the suspicion's largest single-round cohort, never a
    sum) declare a suspect dead; a suspicion older than ``window`` rounds
    without quorum expires; ``budget`` refuted accusations latch the
    accuser into quarantine (0 disables it). ``quorum_k=1`` with no
    adversary reproduces the direct detector bit for bit."""

    quorum_k: int = 1
    window: int = 4
    budget: int = 3

    def __post_init__(self):
        if not 1 <= self.quorum_k <= SUSPECT_VOTE_CAP:
            raise ValueError(
                f"quorum_k must lie in [1, {SUSPECT_VOTE_CAP}] (the packed "
                f"vote counter saturates there); got {self.quorum_k}"
            )
        if self.window < 1:
            raise ValueError(f"suspicion window must be >= 1 round; got "
                             f"{self.window}")
        if not 0 <= self.budget <= SUSPECT_STRIKE_CAP:
            raise ValueError(
                f"accusation budget must lie in [0, {SUSPECT_STRIKE_CAP}] "
                f"(the packed strike counter saturates there); got "
                f"{self.budget}"
            )


def compile_quorum(quorum_k: int = 1, window: int = 4, budget: int = 3) -> QuorumSpec:
    """Validate and freeze a quorum-detector spec (see QuorumSpec)."""
    return QuorumSpec(quorum_k=quorum_k, window=window, budget=budget)


def pack_suspicion(votes: torch.Tensor, strikes: torch.Tensor) -> torch.Tensor:
    """votes (<= 255) and strikes (<= 127) -> the packed int16 plane."""
    return (votes + 256 * strikes).to(torch.int16)


def unpack_suspicion(mark: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed plane -> (votes, strikes), both int32 (floor division,
    as JAX's)."""
    # graftlint: disable=mem-widening-cast -- the packed witness count unpacks in int32 arithmetic
    m = mark.to(torch.int32)
    return torch.remainder(m, 256), torch.div(m, 256, rounding_mode="floor")


def emit_heartbeats(last_hb: torch.Tensor, alive: torch.Tensor, silent: torch.Tensor,
                    declared_dead: torch.Tensor, rnd: torch.Tensor,
                    hb_period_rounds: int) -> torch.Tensor:
    """Refresh ``last_hb`` for every peer emitting a heartbeat this round."""
    tick = (rnd % hb_period_rounds) == 0
    emit = alive & ~silent & ~declared_dead & tick
    return torch.where(emit, saturate_round(rnd, last_hb.dtype), last_hb)


def _stale(last_hb: torch.Tensor, rnd: torch.Tensor, timeout_rounds: int) -> torch.Tensor:
    # graftlint: disable=mem-widening-cast -- round arithmetic runs in int32: a difference of two int16 rounds can pass 2^15
    return (rnd - last_hb.to(torch.int32)) > timeout_rounds


def detect_failures(last_hb: torch.Tensor, alive: torch.Tensor, silent: torch.Tensor,
                    declared_dead: torch.Tensor, rnd: torch.Tensor, timeout_rounds: int,
                    detect_period_rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One detector sweep; returns ``(last_hb, declared_dead)``."""
    sweep = (rnd % detect_period_rounds) == 0
    stale = _stale(last_hb, rnd, timeout_rounds)
    responsive = alive & ~silent
    new_last = torch.where(sweep & stale & responsive, saturate_round(rnd, last_hb.dtype), last_hb)
    newly_dead = sweep & stale & ~responsive & ~declared_dead
    return new_last, declared_dead | newly_dead


def _hit(n: int, idx: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``zeros(n, bool).at[where(keep, idx, n)].set(True, mode="drop")``."""
    hit = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    hit[torch.where(keep, idx.to(torch.int64), n).reshape(-1)] = True
    return hit[:n]


def forge_heartbeats(last_hb: torch.Tensor, suspect_round: torch.Tensor, forger_ok: torch.Tensor,
                     rnd: torch.Tensor, k_forge: torch.Tensor, fanout_now: torch.Tensor,
                     max_fanout: int, rows=ALL_ROWS) -> tuple[torch.Tensor, torch.Tensor]:
    """Forged heartbeats: each row of ``forger_ok`` refreshes the
    ``last_hb`` of ``fanout_now`` (<= ``max_fanout``) uniformly drawn
    targets, except targets under an active suspicion, whose probe a third
    party cannot answer. The planes hold ``rows`` (``core.rows``). Returns
    ``(last_hb, n_forged)``."""
    n = last_hb.shape[0]
    n_all = rows.total(n)
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    tgt = prng.randint(k_forge, (n, max_fanout), 0, n_all, rows.lo * max_fanout).to(torch.int64)
    act = forger_ok[:, None] & (torch.arange(max_fanout, device=last_hb.device)[None, :] < fanout_now)
    (suspect_all,) = rows.gather(suspect_round, label="forge")
    landed = act & (suspect_all[tgt] < 0)
    stamp = saturate_round(rnd, last_hb.dtype)
    hit = rows.reduce(_hit(n_all, tgt, landed), "or", label="forge")
    new_last = torch.where(hit, torch.maximum(last_hb, stamp), last_hb)
    return new_last, act.sum(dtype=torch.int32)


def quorum_liveness(spec: QuorumSpec, last_hb: torch.Tensor, alive: torch.Tensor, silent: torch.Tensor,
                    declared_dead: torch.Tensor, suspect_round: torch.Tensor, suspect_mark: torch.Tensor,
                    quarantine: torch.Tensor, exists: torch.Tensor, rnd: torch.Tensor, timeout_rounds: int,
                    detect_period_rounds: int, k_accuse: torch.Tensor | None = None,
                    accuser_ok: torch.Tensor | None = None, rows=ALL_ROWS) -> dict:
    """One round of the quorum detector, in JAX's order: revive, refute,
    expire, clear; on sweeps, enter and confirm by the live witness
    cohort; the accusations (one vote each against a victim drawn from
    ``k_accuse``, when ``accuser_ok`` is given); the vote plane keeps the
    larger of its votes and this round's; declare at quorum; then strikes
    for refuted accusations and quarantine at the budget. Returns the five
    planes, ``newly_quarantined`` and the counters ``evictions_new``,
    ``false_evictions`` and ``adv_accusations``. The planes hold ``rows``
    (``core.rows``)."""
    n = last_hb.shape[0]
    votes, strikes = unpack_suspicion(suspect_mark)
    responsive = alive & ~silent
    sweep = (rnd % detect_period_rounds) == 0
    stale = _stale(last_hb, rnd, timeout_rounds)
    suspected = suspect_round >= 0

    # the sweep probes every suspect and stale peer: a responsive one
    # answers, refreshing its heartbeat and clearing its suspicion
    revive = sweep & stale & responsive
    last_hb = torch.where(revive, saturate_round(rnd, last_hb.dtype), last_hb)
    refuted = sweep & suspected & responsive
    # graftlint: disable=mem-widening-cast -- round arithmetic runs in int32: a difference of two int16 rounds can pass 2^15
    expired = suspected & ((rnd - suspect_round.to(torch.int32)) > spec.window)
    cleared = refuted | expired
    suspect_round = torch.where(cleared, -1, suspect_round).to(suspect_round.dtype)
    votes = torch.where(cleared, 0, votes)
    suspected = suspect_round >= 0

    # entry, and confirmation of every current suspect by the whole live
    # witness cohort at once
    enter = sweep & stale & ~responsive & ~declared_dead & ~suspected
    suspect_round = torch.where(enter, saturate_round(rnd, suspect_round.dtype), suspect_round)
    suspected = suspected | enter
    n_wit = rows.sum((responsive & ~declared_dead & ~quarantine).sum(dtype=torch.int32))
    confirm = sweep & suspected & stale & ~responsive & ~declared_dead
    round_votes = torch.where(confirm, torch.clamp(n_wit, max=SUSPECT_VOTE_CAP), 0).to(torch.int32)

    vic = vic_valid = responsive_all = None
    n_accusations = torch.zeros((), dtype=torch.int32, device=last_hb.device)
    if accuser_ok is not None:
        n_all, lo = rows.total(n), rows.lo
        vic = prng.randint(k_accuse, (n,), 0, n_all, lo)
        own = torch.arange(lo, lo + n, dtype=vic.dtype, device=vic.device)
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
        vi = vic.to(torch.int64)
        eligible_all, responsive_all = rows.gather(exists & alive & ~declared_dead, responsive, label="accuse")
        vic_valid = accuser_ok & eligible_all[vi] & (vic != own)
        counts = torch.zeros(n_all + 1, dtype=torch.int32, device=vic.device)
        counts.index_add_(0, torch.where(vic_valid, vi, n_all), torch.ones(n, dtype=torch.int32, device=vic.device))
        counts = rows.reduce(counts[:n_all], "sum", label="accuse")
        accused = counts > 0
        suspect_round = torch.where(accused & ~suspected, saturate_round(rnd, suspect_round.dtype), suspect_round)
        suspected = suspected | accused
        round_votes = round_votes + counts
        n_accusations = vic_valid.sum(dtype=torch.int32)
    votes = torch.clamp(torch.maximum(votes, round_votes), max=SUSPECT_VOTE_CAP)

    # declaration at quorum, every round (accusation votes land off-sweep)
    newly_dead = suspected & (votes >= spec.quorum_k) & ~declared_dead
    declared_dead = declared_dead | newly_dead
    suspect_round = torch.where(newly_dead, -1, suspect_round).to(suspect_round.dtype)
    votes = torch.where(newly_dead, 0, votes)

    # an accusation its victim survives to refute is a strike on the accuser
    newly_q = torch.zeros((n,), dtype=torch.bool, device=last_hb.device)
    if accuser_ok is not None and spec.budget > 0:
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
        vi = vic.to(torch.int64)
        (newly_dead_all,) = rows.gather(newly_dead, label="accuse")
        failed = vic_valid & responsive_all[vi] & ~newly_dead_all[vi]
        strikes = torch.clamp(strikes + failed.to(torch.int32), max=SUSPECT_STRIKE_CAP)
        newly_q = (strikes >= spec.budget) & ~quarantine
        quarantine = quarantine | newly_q

    return {
        "last_hb": last_hb,
        "declared_dead": declared_dead,
        "suspect_round": suspect_round,
        "suspect_mark": pack_suspicion(votes, strikes),
        "quarantine": quarantine,
        "newly_quarantined": newly_q,
        "evictions_new": newly_dead.sum(dtype=torch.int32),
        "false_evictions": (newly_dead & responsive).sum(dtype=torch.int32),
        "adv_accusations": n_accusations,
    }
