"""The protocol round loop.

Ports the local path of ``tpu_gossip/sim/engine.py``: ``RoundStats`` with
all 30 fields (planes the port does not run yet report zeros,
``control_level`` -1) and ``_stats``; ``compute_roles``,
``transmit_bitmap`` and ``kernel_path_masks``; ``_disseminate_local``
(:262) with every delivery family of one device: the sampled kernel
paths over a MatchingPlan or a StaircasePlan, the exactly-k XLA push and
pull halves over the CSR, and flood through ``matching_flood``,
``segment_or`` or ``flood_all``; ``advance_round`` (:821),
``gossip_round`` (:1012), ``simulate`` (:1114) and ``run_until_coverage``
(:1170).

JAX runs the horizon as one compiled ``scan`` and the coverage loop as a
``while_loop`` on the device; here both are Python loops over rounds.
``run_until_coverage`` reads its stop condition on the host once per round
(one device synchronisation per round). Rounds are functional: each returns
a new state and leaves its input's planes unchanged. Churn re-wiring
(``rewire_slots > 0``), the controller and re-materialisation belong to
later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import MatchingPlan
from tpu_gossip_torch.core.state import SwarmConfig, SwarmState
from tpu_gossip_torch.kernels.gossip import flood_all, pull_fanout, push_fanout, sample_fanout_targets
from tpu_gossip_torch.kernels.matching import matching_flood, matching_sampled
from tpu_gossip_torch.kernels.pallas_segment import StaircasePlan, segment_or, segment_sampled
from tpu_gossip_torch.sim.stages import build_round_stages, not_ported, run_protocol_round, run_stages

__all__ = [
    "RoundStats",
    "compute_roles",
    "transmit_bitmap",
    "kernel_path_masks",
    "validate_rewire_width",
    "advance_round",
    "gossip_round",
    "simulate",
    "run_until_coverage",
]


class RoundStats(NamedTuple):
    """Per-round observability, field for field the JAX RoundStats."""

    coverage: torch.Tensor  # f32 — fraction of live peers having seen slot 0
    msgs_sent: torch.Tensor  # i32 — point-to-point sends this round
    n_infected: torch.Tensor  # i32 — peers having seen slot 0
    n_alive: torch.Tensor  # i32 — alive & not declared dead
    n_declared_dead: torch.Tensor  # i32
    msgs_dropped: torch.Tensor  # i32 — fault plane (0 here)
    msgs_held: torch.Tensor
    msgs_delivered: torch.Tensor
    n_members: torch.Tensor  # i32 — slots with exists=True
    degree_gamma: torch.Tensor  # f32 — growth plane (0 here)
    stream_offered: torch.Tensor  # i32 — streaming plane (0 here)
    stream_injected: torch.Tensor
    stream_conflated: torch.Tensor
    stream_expired: torch.Tensor
    slot_infected: torch.Tensor  # i32 (M,)
    slot_age: torch.Tensor  # i32 (M,)
    control_level: torch.Tensor  # i32 — control plane (-1 here)
    control_fanout: torch.Tensor
    msgs_duplicate: torch.Tensor
    control_refreshed: torch.Tensor
    evictions_new: torch.Tensor  # i32 — quorum detector (0 here)
    false_evictions: torch.Tensor
    n_quarantined: torch.Tensor
    dead_undeclared: torch.Tensor
    adv_accusations: torch.Tensor
    adv_forged: torch.Tensor
    ingest_offered: torch.Tensor  # i32 — live ingestion (0 here)
    ingest_injected: torch.Tensor
    ingest_conflated: torch.Tensor
    ingest_overflow: torch.Tensor


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _stats(state: SwarmState, msgs_sent: torch.Tensor) -> RoundStats:
    live = state.alive & ~state.declared_dead
    dev = state.seen.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    m = state.seen.shape[1]
    zm = torch.zeros((m,), dtype=torch.int32, device=dev)
    counters = dict.fromkeys(RoundStats._fields, z)
    counters.update(
        coverage=state.coverage(0),
        msgs_sent=_i32(msgs_sent),
        n_infected=_i32((state.seen[:, 0] & live).sum()),
        n_alive=_i32(live.sum()),
        n_declared_dead=_i32(state.declared_dead.sum()),
        n_members=_i32(state.exists.sum()),
        degree_gamma=torch.zeros((), dtype=torch.float32, device=dev),
        slot_infected=zm,
        slot_age=zm,
        control_level=torch.full((), -1, dtype=torch.int32, device=dev),
    )
    return RoundStats(**counters)


def compute_roles(state: SwarmState):
    """(active (N,), transmitter (N, M), receptive (N, M)) masks."""
    active = state.alive & ~state.declared_dead
    transmitter = active[:, None] & ~state.recovered
    receptive = active[:, None] & ~state.recovered
    return active, transmitter, receptive


def transmit_bitmap(state: SwarmState, cfg: SwarmConfig, transmitter: torch.Tensor) -> torch.Tensor:
    """Slots each peer offers to push this round (forward_once budgets apply)."""
    transmit = state.seen & transmitter
    if cfg.forward_once:
        transmit = transmit & ~state.forwarded
    return transmit


def kernel_path_masks(state: SwarmState, cfg: SwarmConfig, transmit: torch.Tensor,
                      transmitter: torch.Tensor, receptive: torch.Tensor):
    """(tx, answer, rec_rows) for sampled kernel-family delivery: pull
    answers ship the responder's full seen set (``None`` = same as
    transmit); rewired rows carry nothing over their static edges."""
    answer = (state.seen & transmitter) if cfg.forward_once else None
    tx, rec_rows = transmit, receptive.any(-1)
    if cfg.rewire_slots > 0:
        tx = tx & ~state.rewired[:, None]
        if answer is not None:
            answer = answer & ~state.rewired[:, None]
        rec_rows = rec_rows & ~state.rewired
    return tx, answer, rec_rows


def validate_rewire_width(state: SwarmState, cfg: SwarmConfig) -> None:
    """Fail when the state's rewire table is narrower than the config's."""
    if cfg.rewire_slots > state.rewire_targets.shape[1]:
        raise ValueError(
            f"cfg.rewire_slots={cfg.rewire_slots} exceeds the state's "
            f"rewire_targets width {state.rewire_targets.shape[1]}"
        )


def _is_csr_free(state: SwarmState) -> bool:
    """A graph built without its CSR (``col_idx`` of one dummy entry)."""
    return state.col_idx.shape[0] == 1 and state.row_ptr.shape[0] > 3


def _require_csr(state: SwarmState, what: str) -> None:
    if _is_csr_free(state):
        raise ValueError(
            f"{what} reads the CSR neighbor list, but this graph was built without one "
            "(matching_powerlaw_graph(export_csr=False)); rebuild with export_csr=True "
            "or deliver via the matching plan"
        )


def _disseminate_local(state: SwarmState, cfg: SwarmConfig, transmit, transmitter,
                       receptive, k_push, k_pull, plan=None):
    """Single-device dissemination; returns ``(incoming, msgs_sent)``.

    A plan with sampling gates and a ``fanout`` (MatchingPlan or
    StaircasePlan) carries push / push-pull through its kernel path
    (Bernoulli per edge); without one, push and pull sample exactly
    ``fanout`` and one neighbour over the CSR. Flood goes through the plan
    when there is one, else ``flood_all``."""
    if plan is not None and not isinstance(plan, (MatchingPlan, StaircasePlan)):
        raise TypeError(f"plan must be a MatchingPlan or StaircasePlan, got {type(plan).__name__}")
    if cfg.rewire_slots > 0:
        raise not_ported("fresh-edge re-wiring traffic (rewire_slots > 0)", "churn and re-wiring")
    # the JAX engine re-splits both keys; child 0 drives delivery, child 1
    # the re-wiring side paths (k_pull's child is drawn only where it is read)
    k_push = prng.split(k_push)[0]
    sampled = cfg.mode in ("push", "push_pull")
    gates = plan is not None and (getattr(plan, "push_thresh", None) is not None
                                  or getattr(plan, "deg_other", None) is not None)
    if sampled and gates and plan.fanout is not None:
        if plan.fanout != cfg.fanout:
            raise ValueError(f"plan built for fanout={plan.fanout} but cfg.fanout={cfg.fanout}")
        tx, answer, rec_rows = kernel_path_masks(state, cfg, transmit, transmitter, receptive)
        deliver = matching_sampled if isinstance(plan, MatchingPlan) else segment_sampled
        return deliver(plan, tx, answer, cfg.msg_slots, k_push, receptive_rows=rec_rows,
                       do_push=True, do_pull=cfg.mode == "push_pull")
    msgs_sent = torch.zeros((), dtype=torch.int64, device=transmit.device)
    incoming = torch.zeros_like(state.seen)
    if sampled:
        _require_csr(state, "XLA sampled delivery")
        tgt, valid = sample_fanout_targets(k_push, state.row_ptr, state.col_idx, cfg.fanout)
        push_valid = valid & transmit.any(-1)[:, None]
        incoming = incoming | push_fanout(transmit, tgt, push_valid)
        msgs_sent = msgs_sent + (transmit.sum(-1) * push_valid.sum(-1)).sum()
    if cfg.mode == "push_pull":
        # each live peer asks one neighbour for the responder's full seen set
        answer = state.seen & transmitter
        ptgt, pvalid = sample_fanout_targets(prng.split(k_pull)[0], state.row_ptr, state.col_idx, 1)
        pull_ok = pvalid & receptive.any(-1)[:, None]
        incoming = incoming | pull_fanout(answer, ptgt, pull_ok)
        shipped = answer[ptgt[:, 0].to(torch.int64)].sum(-1) * pull_ok[:, 0]
        msgs_sent = msgs_sent + pull_ok.sum() + shipped.sum()
    if cfg.mode == "flood":
        if isinstance(plan, MatchingPlan):
            incoming = incoming | matching_flood(plan, transmit, cfg.msg_slots)
        elif plan is not None:
            incoming = incoming | segment_or(plan, transmit, cfg.msg_slots)
        else:
            _require_csr(state, "XLA flood delivery")
            incoming = incoming | flood_all(transmit, state.row_ptr, state.col_idx)
        deg = (state.row_ptr[1:] - state.row_ptr[:-1]).to(torch.int64)
        msgs_sent = msgs_sent + (transmit.sum(-1) * deg).sum()
    return incoming, _i32(msgs_sent)


def advance_round(state: SwarmState, cfg: SwarmConfig, incoming, msgs_sent, transmit,
                  rnd, key, receptive, *, tail: str = "fused"):
    """Everything after dissemination (liveness, then the one-pass slot
    tail) and the round's stats; returns ``(new_state, RoundStats)``."""
    values = {
        "seen": state.seen, "forwarded": state.forwarded,
        "infected_round": state.infected_round, "recovered": state.recovered,
        "alive": state.alive, "silent": state.silent, "last_hb": state.last_hb,
        "declared_dead": state.declared_dead, "rnd": rnd,
        "incoming": incoming, "transmit": transmit,
        "receptive": receptive, "fresh": None, "expired": None,
    }
    values = run_stages(build_round_stages(cfg, tail=tail), values)
    new_state = SwarmState(
        row_ptr=state.row_ptr, col_idx=state.col_idx,
        seen=values["seen"], forwarded=values["forwarded"],
        infected_round=values["infected_round"], recovered=values["recovered"],
        exists=state.exists, alive=values["alive"], silent=values["silent"],
        last_hb=values["last_hb"], declared_dead=values["declared_dead"],
        rewired=state.rewired, rewire_targets=state.rewire_targets,
        fault_held=state.fault_held, join_round=state.join_round,
        admitted_by=state.admitted_by, degree_credit=state.degree_credit,
        slot_lease=state.slot_lease, control_lvl=state.control_lvl,
        pipe_buf=state.pipe_buf, suspect_round=state.suspect_round,
        suspect_mark=state.suspect_mark, quarantine=state.quarantine,
        rng=key, round=rnd,
    )
    return new_state, _stats(new_state, msgs_sent)


def gossip_round(state: SwarmState, cfg: SwarmConfig, plan=None, *, tail: str = "fused",
                 **later):
    """Advance the swarm one round; returns ``(new_state, RoundStats)``."""

    def disseminate(tx, tr, rc, kp, kq):
        return _disseminate_local(state, cfg, tx, tr, rc, kp, kq, plan)

    return run_protocol_round(state, cfg, disseminate, tail=tail, **later)


def _stack(rows: list[RoundStats]) -> RoundStats:
    return RoundStats(*(torch.stack(col) for col in zip(*rows)))


def simulate(state: SwarmState, cfg: SwarmConfig, num_rounds: int, plan=None,
             tail: str = "fused", **later):
    """Run a fixed horizon; returns the final state and the per-round
    stats stacked along a leading (num_rounds,) axis."""
    rows = []
    for _ in range(num_rounds):
        state, st = gossip_round(state, cfg, plan, tail=tail, **later)
        rows.append(st)
    return state, _stack(rows)


def run_until_coverage(state: SwarmState, cfg: SwarmConfig, target: float = 0.99,
                       max_rounds: int = 1000, slot: int = 0, plan=None,
                       tail: str = "fused", **later) -> SwarmState:
    """Rounds until ``coverage(slot) >= target`` (compared in float32) or
    ``max_rounds``; rounds used = ``result.round - state.round``."""
    start = state.round
    tgt = torch.tensor(target, dtype=torch.float32, device=state.seen.device)
    s = state
    while bool((s.coverage(slot) < tgt) & (s.round - start < max_rounds)):
        s, _ = gossip_round(s, cfg, plan, tail=tail, **later)
    return s
