"""The protocol round loop.

Ports the local path of ``tpu_gossip/sim/engine.py``: ``RoundStats`` with
all 30 fields (planes the port does not run yet report zeros) and
``_stats``; ``compute_roles``,
``transmit_bitmap`` and ``kernel_path_masks``; ``_disseminate_local``
(:262) with every delivery family of one device: the sampled kernel
paths over a MatchingPlan or a StaircasePlan, the exactly-k XLA push and
pull halves over the CSR, and flood through ``matching_flood``,
``segment_or`` or ``flood_all``; the churn re-wiring delivery
(``_substitute_rewired`` :749, ``reverse_fresh_push`` :424,
``fresh_rewire_traffic`` :457 and its compact twin :529) and the CSR
fold that empties it (``remat_capacity`` :616, ``rematerialize_rewired``
:633); ``validate_rewire_width`` (:803); ``advance_round`` (:821),
``gossip_round`` (:1012), ``simulate`` (:1114) and ``run_until_coverage``
(:1170). Each entry point takes a ``PackedSwarm`` too, runs the round on
its words (``sim/packed_engine.py``) and returns a ``PackedSwarm``, a
``scenario`` (``faults/``): the round's faults wrap the delivery, the
delay buffer rides ``fault_held`` and the three fault counters land in
``RoundStats``; and ``liveness``, a ``QuorumSpec`` (``kernels/liveness.py``):
the quorum detector replaces the direct one, a scenario's adversaries
act, and the six detector columns of ``RoundStats`` are filled; and
``growth``, a ``CompiledGrowth`` (``growth/``): the round admits its join
batch after churn and ``degree_gamma`` tracks the realized degrees' tail;
and ``stream``, a ``CompiledStream`` (``traffic/``): leases past their TTL
recycle through the tail, the round's arrivals land after it, and the
four stream columns and the per-slot tracks (``slot_infected``,
``slot_age``) are filled; and ``control``, a ``ControlSpec``
(``control/``): the round's decision (effective fanout, pull gate, needy
rows) is resolved before delivery and reaches every path, the control
stage runs last, and the four control columns are filled (``control_level``
-1 without a controller); and ``pipeline``, a ``PipelineSpec``
(``sim/stages.py``): at depth 1 each round delivers the exchange the last
one issued (``pipe_buf``) and stores its own; and ``inject``, an
``InjectBatch`` (``traffic/ingest.py``): a live-serving window's arrivals
land after the tail and the stream's injection and fill the four
``ingest_*`` columns.

JAX runs the horizon as one compiled ``scan`` and the coverage loop as a
``while_loop`` on the device; here both are Python loops over rounds.
``run_until_coverage`` reads its stop condition on the host once per round
(one device synchronisation per round; a packed state's from one bit
column). Both loops read the state's round (under a scenario or a stream)
and key (under a stream) once and carry them on the host
(``sim.stages.host_cursor``). Rounds are functional: each returns
a new state and leaves its input's planes unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import MatchingPlan
from tpu_gossip_torch.core.device_topology import repeat_ids
from tpu_gossip_torch.core.packed import is_packed
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.state import SwarmConfig, SwarmState
from tpu_gossip_torch.kernels.gossip import flood_all, pull_fanout, push_fanout, sample_fanout_targets
from tpu_gossip_torch.kernels.matching import matching_flood, matching_sampled
from tpu_gossip_torch.kernels.pallas_segment import StaircasePlan, segment_or, segment_sampled
from tpu_gossip_torch.sim.stages import (build_round_stages, first_rows, host_cursor, next_host_key,
                                        run_protocol_round, run_stages)

__all__ = [
    "RoundStats",
    "compute_roles",
    "transmit_bitmap",
    "kernel_path_masks",
    "validate_rewire_width",
    "reverse_fresh_push",
    "fresh_rewire_traffic",
    "remat_capacity",
    "rematerialize_rewired",
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
    msgs_dropped: torch.Tensor  # i32 — fault plane (0 without loss/delay)
    msgs_held: torch.Tensor
    msgs_delivered: torch.Tensor
    n_members: torch.Tensor  # i32 — slots with exists=True
    degree_gamma: torch.Tensor  # f32 — growth plane (0 without a schedule)
    stream_offered: torch.Tensor  # i32 — streaming plane (0 here)
    stream_injected: torch.Tensor
    stream_conflated: torch.Tensor
    stream_expired: torch.Tensor
    slot_infected: torch.Tensor  # i32 (M,)
    slot_age: torch.Tensor  # i32 (M,)
    control_level: torch.Tensor  # i32 — control plane (-1 without a controller)
    control_fanout: torch.Tensor
    msgs_duplicate: torch.Tensor
    control_refreshed: torch.Tensor
    evictions_new: torch.Tensor  # i32 — quorum detector (0 without liveness)
    false_evictions: torch.Tensor
    n_quarantined: torch.Tensor
    dead_undeclared: torch.Tensor
    adv_accusations: torch.Tensor
    adv_forged: torch.Tensor
    ingest_offered: torch.Tensor  # i32 — live ingestion (0 without a batch)
    ingest_injected: torch.Tensor
    ingest_conflated: torch.Tensor
    ingest_overflow: torch.Tensor


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def liveness_counters(ltel, liveness, exists, alive, declared_dead, quarantine) -> dict:
    """The six quorum-detector columns of RoundStats: the round's
    counters from ``ltel``, and, on a hardened run only, the quarantined
    rows and the dead members not yet declared."""
    out = {} if ltel is None else ltel._asdict()
    if liveness is not None:
        out.update(n_quarantined=quarantine.sum(dtype=torch.int32),
                   dead_undeclared=(exists & ~alive & ~declared_dead).sum(dtype=torch.int32))
    return out


def growth_gamma(growth, row_ptr, exists, rewired, rewire_targets, degree_credit, live, rows=ALL_ROWS) -> torch.Tensor:
    """The ``degree_gamma`` column: the running Hill gamma of the realized
    degrees under a growth schedule, 0.0 without one; the swarm's whole
    when the planes hold ``rows`` (``core.rows``)."""
    if growth is None:
        return torch.zeros((), dtype=torch.float32, device=exists.device)
    from tpu_gossip_torch.growth.engine import hill_gamma_device, realized_degrees

    deg = realized_degrees(row_ptr, exists, rewired, rewire_targets, degree_credit, rows.lo)
    return hill_gamma_device(deg, live, growth.gamma_d_min, rows)


def slot_tracks(seen: torch.Tensor, live: torch.Tensor, slot_lease: torch.Tensor, rnd, stream) -> dict:
    """The ``slot_infected`` and ``slot_age`` columns: zeros without a
    stream, else each slot's live infected count (the (N, M) column sum,
    priced on streaming runs only) and its lease's age (-1 when free)."""
    if stream is None:
        zm = torch.zeros(slot_lease.shape, dtype=torch.int32, device=seen.device)
        return {"slot_infected": zm, "slot_age": zm}
    return {"slot_infected": (seen & live[:, None]).sum(dim=0, dtype=torch.int32),
            "slot_age": torch.where(slot_lease >= 0, rnd - slot_lease, -1).to(torch.int32)}


def _stats(state: SwarmState, msgs_sent: torch.Tensor, fstats=None, ltel=None, liveness=None,
           growth=None, stream=None, stel=None, ctel=None, itel=None, rows=ALL_ROWS) -> RoundStats:
    live = state.alive & ~state.declared_dead
    dev = state.seen.device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    counters = dict.fromkeys(RoundStats._fields, z)
    counters.update(
        coverage=state.coverage(0),
        msgs_sent=_i32(msgs_sent),
        n_infected=_i32((state.seen[:, 0] & live).sum()),
        n_alive=_i32(live.sum()),
        n_declared_dead=_i32(state.declared_dead.sum()),
        n_members=_i32(state.exists.sum()),
        degree_gamma=growth_gamma(growth, state.row_ptr, state.exists, state.rewired, state.rewire_targets,
                                  state.degree_credit, live, rows),
        control_level=torch.full((), -1, dtype=torch.int32, device=dev),
        **slot_tracks(state.seen, live, state.slot_lease, state.round, stream),
    )
    if fstats is not None:
        counters.update(fstats._asdict())
    counters.update(stream_counters(stel))
    counters.update(ingest_counters(itel))
    counters.update(control_counters(ctel))
    counters.update(liveness_counters(ltel, liveness, state.exists, state.alive, state.declared_dead,
                                      state.quarantine))
    return RoundStats(**counters)


def ingest_counters(itel) -> dict:
    """The four ``ingest_*`` columns from the round's ``IngestTelemetry``
    (none without a batch)."""
    if itel is None:
        return {}
    return {"ingest_offered": itel.offered, "ingest_injected": itel.injected,
            "ingest_conflated": itel.conflated, "ingest_overflow": itel.overflow}


def control_counters(ctel) -> dict:
    """The four control columns from the round's ``ControlTelemetry``
    (none without a controller: ``control_level`` stays -1)."""
    if ctel is None:
        return {}
    return {"control_level": ctel.level, "control_fanout": ctel.fanout, "msgs_duplicate": ctel.duplicate,
            "control_refreshed": ctel.refreshed}


def stream_counters(stel) -> dict:
    """The four ``stream_*`` columns from the round's ``StreamTelemetry``
    (none without a stream)."""
    if stel is None:
        return {}
    return {"stream_offered": stel.offered, "stream_injected": stel.injected,
            "stream_conflated": stel.conflated, "stream_expired": stel.expired}


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


def _is_csr_free(state: SwarmState) -> bool:
    """A graph built without its CSR (``col_idx`` of one dummy entry)."""
    return state.col_idx.shape[0] == 1 and state.row_ptr.shape[0] > 3


def _require_csr(state: SwarmState, what: str) -> None:
    if _is_csr_free(state):
        raise ValueError(
            f"{what} reads the CSR neighbor list, but this graph was built without one "
            "(matching_powerlaw_graph(export_csr=False)) — XLA would silently clamp the "
            "out-of-bounds gathers; rebuild with export_csr=True or deliver via the matching plan"
        )


def validate_rewire_width(state: SwarmState, cfg: SwarmConfig) -> None:
    """Fail when the state's rewire table is narrower than the config's,
    and when churn joins would draw re-wiring endpoints from a graph built
    without its CSR (the draws would index past its one-entry ``col_idx``)."""
    if cfg.rewire_slots > state.rewire_targets.shape[1]:
        raise ValueError(
            f"cfg.rewire_slots={cfg.rewire_slots} exceeds the state's "
            f"rewire_targets width {state.rewire_targets.shape[1]}: the "
            "checkpoint was saved with fewer slots; pad rewire_targets or "
            "lower rewire_slots"
        )
    if cfg.rewire_slots > 0 and cfg.churn_join_prob > 0 and _is_csr_free(state):
        raise ValueError(
            "churn re-wiring needs the neighbor list: this graph was built "
            "without a CSR export (matching_powerlaw_graph(export_csr="
            "False)); rebuild with export_csr=True"
        )


def _substitute_rewired(state, cfg: SwarmConfig, tgt, valid, key):
    """Rewired peers sample their targets from their fresh attachments
    instead of the departed occupant's CSR row; a -1 fresh target (a
    sentinel draw) stays invalid."""
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    soff = prng.randint(key, tuple(tgt.shape), 0, cfg.rewire_slots).to(torch.int64)
    stgt = torch.gather(state.rewire_targets[:, : cfg.rewire_slots], 1, soff)
    rw = state.rewired[:, None]
    return (torch.where(rw, torch.clamp(stgt, min=0), tgt.to(stgt.dtype)),
            torch.where(rw, stgt >= 0, valid))


def _ratio(num, deg: torch.Tensor) -> torch.Tensor:
    """``num / max(deg, 1)`` in float32, as JAX computes an int by int32
    true divide (both operands converted, then one IEEE division).
    ``num`` is a Python number or a 0-d tensor on ``deg``'s device (the
    controller's effective fanout), which stays there: no host read."""
    d = torch.clamp(deg, min=1).to(torch.float32)
    if isinstance(num, torch.Tensor):
        return num.to(torch.float32) / d
    # graftlint: disable=round-host-sync -- num is a Python number on this branch
    return torch.full_like(d, float(num)) / d


def _degrees(state) -> torch.Tensor:
    # graftlint: disable=mem-widening-cast -- message counts sum in int64; the stats narrow them to int32
    return (state.row_ptr[1:] - state.row_ptr[:-1]).to(torch.int64)


def held_degrees(row_ptr: torch.Tensor, plan, n_rows: int) -> torch.Tensor:
    """The CSR degrees of the ``n_rows`` state rows a round holds, from a
    matching plan's first held node on (``shard_lo`` shards in, 0 but on a
    process of a multi-process mesh, whose CSR is the whole swarm's)."""
    lo = plan.shard_lo * plan.n_blk if isinstance(plan, MatchingPlan) else 0
    # graftlint: disable=mem-widening-cast -- message counts sum in int64; the stats narrow them to int32
    return (row_ptr[lo + 1: lo + n_rows + 1] - row_ptr[lo: lo + n_rows]).to(torch.int64)


def reverse_fresh_push(state, cfg: SwarmConfig, transmit, key, m_eff=None, rows=ALL_ROWS, transmit_all=None):
    """Delivery to rejoiners along the reverse of their fresh edges: each
    fresh target ``t`` pushes back at its per-edge rate ``fanout/deg(t)``,
    the controller's ``m_eff`` (int32 0-d) in place of ``fanout`` when
    given. Returns ``(incoming, msgs)``. The state holds ``rows``
    (``core.rows``): the draw is their block of the swarm's, and the
    targets' transmit rows come from ``transmit_all`` (the swarm's plane,
    gathered here when None)."""
    stgt = state.rewire_targets[:, : cfg.rewire_slots]
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    tgt = torch.clamp(stgt, min=0).to(torch.int64)
    p = _ratio(cfg.fanout if m_eff is None else m_eff, _degrees(state)[tgt])
    u = prng.uniform(key, tuple(stgt.shape), offset=rows.lo * stgt.shape[1])
    fire = state.rewired[:, None] & (stgt >= 0) & (u < p)
    if transmit_all is None:
        (transmit_all,) = rows.gather(transmit, label="fresh")
    back = transmit_all[tgt]  # (N, S, M)
    msgs = (back.sum(-1) * fire).sum()
    return (back & fire[:, :, None]).any(dim=1), msgs


def _or_rows(incoming, rows, vals):
    """``incoming.at[rows].max(vals, mode="drop")`` for bool planes, rows
    equal to ``n`` dropped: an OR-add into a spare row."""
    n, m = incoming.shape
    hits = torch.zeros((n + 1, m), dtype=torch.int32, device=incoming.device)
    hits.index_add_(0, rows.reshape(-1).to(torch.int64), vals.reshape(-1, m).to(torch.int32))
    return incoming | (hits[:n] > 0)


def _width_mask(valid, rctl):
    """The exactly-k draws of a controlled round are made at width
    ``rctl.width``; the columns past the round's ``m_eff`` go dark."""
    if rctl is None:
        return valid
    return valid & (torch.arange(rctl.width, device=valid.device) < rctl.m_eff)[None, :]


def _pull_mask(pvalid, rctl, needy_rows=None):
    """A controlled round's pull half: gated by ``pull_on`` and, with the
    needy-pull gate, by the puller's need (``needy_rows``, the rows of
    ``rctl.needy`` the pulls belong to)."""
    if rctl is None:
        return pvalid
    pvalid = pvalid & rctl.pull_on
    if rctl.needy is not None:
        pvalid = pvalid & (rctl.needy if needy_rows is None else needy_rows)[:, None]
    return pvalid


def fresh_rewire_traffic(state, cfg: SwarmConfig, transmit, answer, receptive_any, k_push, k_pull,
                         do_pull: bool, rctl=None, rows=ALL_ROWS):
    """Delivery over the rejoiners' fresh degree-preferential edges, which
    no static edge table carries: push to ``fanout`` draws from the fresh
    targets, the reverse pass back (:func:`reverse_fresh_push`) and, with
    ``do_pull``, one pull from a fresh target. Dense over every row, or
    over a ``rewire_compact_cap``-row table of the rewired rows. Under a
    controller (``rctl``) the push draws are made at width ``hi`` with the
    columns past ``m_eff`` dark, the reverse pass runs at ``m_eff`` and
    the pull half is gated as on the static edges. Returns ``(incoming,
    msgs)``.

    The state holds ``rows`` (``core.rows``; on a process of a mesh over
    several processes, its block): the draws are their block of each of
    the swarm's draws, the pushes land on the targets' holders (OR), and
    the reverse pass and the pull read the targets' rows of the swarm's
    ``transmit`` and ``answer``, gathered once a round."""
    if cfg.rewire_compact_cap > 0:
        return _fresh_rewire_traffic_compact(state, cfg, transmit, answer, receptive_any, k_push, k_pull,
                                             do_pull, rctl, rows)
    n, s = state.rewired.shape[0], cfg.rewire_slots
    k_push, k_rev = prng.split(k_push)
    tx_all, *ans_all = rows.gather(transmit, *([answer] if do_pull else []), label="fresh")

    def draw(key, width):
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
        soff = prng.randint(key, (n, width), 0, s, rows.lo * width).to(torch.int64)
        stgt = torch.gather(state.rewire_targets[:, :s], 1, soff)
        return torch.clamp(stgt, min=0), state.rewired[:, None] & (stgt >= 0)

    tgt, valid = draw(k_push, cfg.fanout if rctl is None else rctl.width)
    push_valid = _width_mask(valid, rctl) & transmit.any(-1)[:, None]
    incoming = rows.reduce(push_fanout(transmit, tgt, push_valid, rows.total(n)), "or", label="fresh")
    msgs = (transmit.sum(-1) * push_valid.sum(-1)).sum()
    rev, rev_msgs = reverse_fresh_push(state, cfg, transmit, k_rev, None if rctl is None else rctl.m_eff, rows,
                                       tx_all)
    incoming, msgs = incoming | rev, msgs + rev_msgs
    if do_pull:
        ptgt, pvalid = draw(k_pull, 1)
        pvalid = _pull_mask(pvalid & receptive_any[:, None], rctl)
        incoming = incoming | pull_fanout(ans_all[0], ptgt, pvalid)
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
        msgs = msgs + pvalid.sum() + (ans_all[0][ptgt[:, 0].to(torch.int64)].sum(-1) * pvalid[:, 0]).sum()
    return incoming, msgs


def _fresh_rewire_traffic_compact(state, cfg: SwarmConfig, transmit, answer, receptive_any, k_push, k_pull,
                                  do_pull: bool, rctl=None, rows=ALL_ROWS):
    """:func:`fresh_rewire_traffic` over the first ``cap`` rewired rows
    (``first_rows``, no host sync): every gather, scatter and draw runs at
    (cap, ·); rewired rows past the cap get no fresh traffic this round.
    The table is the swarm's first ``cap`` rewired rows (the gathered
    ``rewired``): every holder of ``rows`` makes the same (cap, ·) draws
    and acts for the table's rows it holds."""
    n, s = state.rewired.shape[0], cfg.rewire_slots
    lo, n_all = rows.lo, rows.total(n)
    cap = min(cfg.rewire_compact_cap, n_all)
    w = cfg.fanout if rctl is None else rctl.width
    k_push, k_rev = prng.split(k_push)
    rw_all, tx_all, *ans_all = rows.gather(state.rewired, transmit, *([answer] if do_pull else []), label="fresh")
    idx, live = first_rows(rw_all, cap)
    mine = live & (idx >= lo) & (idx < lo + n)
    li = torch.where(mine, idx - lo, 0)  # the held row of each entry held
    tg = state.rewire_targets[li, :s]  # (cap, S)
    tx_rows = transmit[li]  # (cap, M)
    row_or_drop = torch.where(mine, li, n)

    def draw(key, width):
        soff = prng.randint(key, (cap, width), 0, s).to(torch.int64)
        stgt = torch.gather(tg, 1, soff)
        return torch.clamp(stgt, min=0), mine[:, None] & (stgt >= 0)

    tgt, valid = draw(k_push, w)
    push_valid = _width_mask(valid, rctl) & tx_rows.any(-1)[:, None]
    incoming = rows.reduce(push_fanout(tx_rows, tgt, push_valid, n_all), "or", label="fresh")
    msgs = (tx_rows.sum(-1) * push_valid.sum(-1)).sum()

    rtgt = torch.clamp(tg, min=0).to(torch.int64)
    p = _ratio(cfg.fanout if rctl is None else rctl.m_eff, _degrees(state)[rtgt])
    fire = mine[:, None] & (tg >= 0) & (prng.uniform(k_rev, tuple(tg.shape)) < p)
    back = tx_all[rtgt]  # (cap, S, M)
    incoming = _or_rows(incoming, row_or_drop, (back & fire[:, :, None]).any(dim=1))
    msgs = msgs + (back.sum(-1) * fire).sum()

    if do_pull:
        ptgt, pvalid = draw(k_pull, 1)
        pvalid = _pull_mask(pvalid & receptive_any[li][:, None], rctl,
                            None if rctl is None or rctl.needy is None else rctl.needy[li])
        incoming = _or_rows(incoming, row_or_drop, pull_fanout(ans_all[0], ptgt, pvalid))
        msgs = msgs + pvalid.sum() + (ans_all[0][ptgt[:, 0]].sum(-1) * pvalid[:, 0]).sum()
    return incoming, msgs


def remat_capacity(state, cfg: SwarmConfig) -> int:
    """The fixed ``col_idx`` capacity of a re-materialization loop, taken
    once from the pre-churn graph: one bidirectional fresh edge set per
    peer of headroom."""
    return int(state.col_idx.shape[0]) + 2 * int(state.alive.shape[0]) * max(cfg.rewire_slots, 1)


def rematerialize_rewired(state: SwarmState, cfg: SwarmConfig, capacity: int):
    """Fold the rejoiners' fresh edges into the CSR and empty ``rewired``.

    Drops every stale edge (an endpoint rewired or not a member), appends
    each rejoiner's fresh edges both ways, rebuilds the CSR by a stable
    sort of the edge list by source row and clears ``rewired``,
    ``rewire_targets`` and ``degree_credit``. The new ``col_idx`` has
    ``capacity`` entries: those past ``row_ptr[-1]`` are self-loops on the
    last row with edges. Returns ``(new_state, overflow)``, ``overflow``
    the edges dropped because the kept set exceeded ``capacity`` (0-d
    int32 tensor; the highest rows' edges go first). The input state is
    left as it was; a plan over the old CSR must be rebuilt."""
    n = state.alive.shape[0]
    dev = state.alive.device
    e_in = state.col_idx.shape[0]
    s = max(cfg.rewire_slots, 1)
    deg = state.row_ptr[1:] - state.row_ptr[:-1]
    src_old = repeat_ids(deg, e_in).to(torch.int64)
    in_range = torch.arange(e_in, device=dev) < state.row_ptr[-1]
    dst_old = state.col_idx.to(torch.int64)
    safe = torch.clamp(dst_old, 0, n - 1)
    keep = (in_range & state.exists[src_old] & state.exists[safe]
            & ~state.rewired[src_old] & ~state.rewired[safe])

    ft = state.rewire_targets[:, :s].to(torch.int64)
    r_ids = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(n, s)
    fv = state.rewired[:, None] & (ft >= 0) & (ft != r_ids)
    t_ids = torch.clamp(ft, 0, n - 1)
    srcs = torch.cat([torch.where(keep, src_old, n), torch.where(fv, r_ids, n).reshape(-1),
                      torch.where(fv, t_ids, n).reshape(-1)])
    dsts = torch.cat([dst_old, t_ids.reshape(-1), r_ids.reshape(-1)])
    total = srcs.shape[0]

    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, srcs, torch.ones_like(srcs))
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:n], 0)])
    overflow = torch.clamp(row_ptr[-1] - capacity, min=0)
    row_ptr = torch.clamp(row_ptr, max=capacity)

    # invalid entries carry src=n, so the sort moves them to the tail,
    # which becomes self-loops on the last row with edges
    r_star = torch.where(counts[:n] > 0, torch.arange(n, device=dev), 0).max()
    if total < capacity:
        srcs = torch.cat([srcs, srcs.new_full((capacity - total,), n)])
        dsts = torch.cat([dsts, dsts.new_zeros(capacity - total)])
    order = torch.argsort(srcs, stable=True)[:capacity]
    new_col = torch.where(torch.arange(capacity, device=dev) < row_ptr[-1], dsts[order], r_star)
    new_state = dataclasses.replace(
        state,
        row_ptr=row_ptr.to(state.row_ptr.dtype),
        col_idx=new_col.to(state.col_idx.dtype),
        rewired=torch.zeros_like(state.rewired),
        rewire_targets=torch.full_like(state.rewire_targets, -1),
        degree_credit=torch.zeros_like(state.degree_credit),
    )
    return new_state, overflow.to(torch.int32)


def _disseminate_local(state: SwarmState, cfg: SwarmConfig, transmit, transmitter,
                       receptive, k_push, k_pull, plan=None, rctl=None, rows=ALL_ROWS):
    """Single-device dissemination; returns ``(incoming, msgs_sent)``.

    A plan with sampling gates and a ``fanout`` (MatchingPlan or
    StaircasePlan) carries push / push-pull through its kernel path
    (Bernoulli per edge); without one, push and pull sample exactly
    ``fanout`` and one neighbour over the CSR. Flood goes through the plan
    when there is one, else ``flood_all``.

    With churn re-wiring (``cfg.rewire_slots > 0``, push and push_pull)
    the kernel paths carry the static bulk with rewired rows masked
    (:func:`kernel_path_masks`) and the rejoiners' fresh edges go through
    :func:`fresh_rewire_traffic`; the exactly-k path substitutes fresh
    targets for rewired senders and pullers, drops CSR edges pointing at
    a rewired slot, and adds the reverse pass. Flood ignores re-wiring.

    ``rctl`` (a :class:`~tpu_gossip_torch.control.RoundControl`) is an
    active controller's round decision: the kernel paths take ``m_eff``,
    ``pull_on`` and the needy rows as their gate hooks; the exactly-k path
    draws at width ``rctl.width`` and darkens the columns past ``m_eff``;
    the pull half is gated by ``pull_on`` and the needy rows. Zero-
    adjustment bounds make every mask all-true and every gate static.
    ``rows`` (``core.rows``) are the rows the state holds, which the fresh
    edges' side paths cross."""
    if plan is not None and not isinstance(plan, (MatchingPlan, StaircasePlan)):
        raise TypeError(f"plan must be a MatchingPlan or StaircasePlan, got {type(plan).__name__}")
    # the JAX engine re-splits both keys: child 0 drives delivery, child 1
    # the re-wiring side paths
    k_push, k_rw_push = prng.split(k_push)
    k_pull, k_rw_pull = prng.split(k_pull)
    rewiring = cfg.rewire_slots > 0
    sampled = cfg.mode in ("push", "push_pull")
    gates = plan is not None and (getattr(plan, "push_thresh", None) is not None
                                  or getattr(plan, "deg_other", None) is not None)
    if sampled and gates and plan.fanout is not None:
        if plan.fanout != cfg.fanout:
            raise ValueError(f"plan built for fanout={plan.fanout} but cfg.fanout={cfg.fanout}")
        tx, answer, rec_rows = kernel_path_masks(state, cfg, transmit, transmitter, receptive)
        deliver = matching_sampled if isinstance(plan, MatchingPlan) else segment_sampled
        incoming, msgs_sent = deliver(plan, tx, answer, cfg.msg_slots, k_push, receptive_rows=rec_rows,
                                      do_push=True, do_pull=cfg.mode == "push_pull",
                                      fanout=None if rctl is None else rctl.m_eff,
                                      pull_gate=None if rctl is None else rctl.pull_on,
                                      pull_needy_rows=None if rctl is None else rctl.needy)
        if rewiring:
            fresh_inc, fresh_msgs = fresh_rewire_traffic(
                state, cfg, transmit, state.seen & transmitter, receptive.any(-1), k_rw_push, k_rw_pull,
                do_pull=cfg.mode == "push_pull", rctl=rctl, rows=rows)
            incoming, msgs_sent = incoming | fresh_inc, _i32(msgs_sent.to(torch.int64) + fresh_msgs)
        return incoming, msgs_sent
    msgs_sent = torch.zeros((), dtype=torch.int64, device=transmit.device)
    incoming = torch.zeros_like(state.seen)
    if sampled:
        _require_csr(state, "XLA sampled delivery")
        tgt, valid = sample_fanout_targets(k_push, state.row_ptr, state.col_idx,
                                           cfg.fanout if rctl is None else rctl.width)
        if rewiring:
            k_rw_push, k_rw_rev = prng.split(k_rw_push)
            tgt, valid = _substitute_rewired(state, cfg, tgt, valid, k_rw_push)
            # a CSR edge pointing at a rewired slot is the departed
            # occupant's: only fresh-edge traffic reaches a rejoiner
            # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
            valid = valid & (state.rewired[:, None] | ~state.rewired[tgt.to(torch.int64)])
            rev, rev_msgs = reverse_fresh_push(state, cfg, transmit, k_rw_rev, None if rctl is None else rctl.m_eff)
            incoming, msgs_sent = incoming | rev, msgs_sent + rev_msgs
        push_valid = _width_mask(valid, rctl) & transmit.any(-1)[:, None]
        incoming = incoming | push_fanout(transmit, tgt, push_valid)
        msgs_sent = msgs_sent + (transmit.sum(-1) * push_valid.sum(-1)).sum()
    if cfg.mode == "push_pull":
        # each live peer asks one neighbour for the responder's full seen set
        answer = state.seen & transmitter
        ptgt, pvalid = sample_fanout_targets(k_pull, state.row_ptr, state.col_idx, 1)
        if rewiring:
            ptgt, pvalid = _substitute_rewired(state, cfg, ptgt, pvalid, k_rw_pull)
            # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
            pvalid = pvalid & (state.rewired[:, None] | ~state.rewired[ptgt.to(torch.int64)])
        pull_ok = _pull_mask(pvalid & receptive.any(-1)[:, None], rctl)
        incoming = incoming | pull_fanout(answer, ptgt, pull_ok)
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
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
        msgs_sent = msgs_sent + (transmit.sum(-1) * held_degrees(state.row_ptr, plan, transmit.shape[0])).sum()
    return incoming, _i32(msgs_sent)


def advance_round(state: SwarmState, cfg: SwarmConfig, incoming, msgs_sent, transmit,
                  rnd, key, k_leave, k_join, receptive, *, tail: str = "fused", faults=None,
                  churn_faults: bool = False, fault_held=None, fstats=None, liveness=None,
                  k_accuse=None, k_forge=None, growth=None, stream=None, host_rng=None,
                  host_rnd: int | None = None, control=None, rctl=None, pipe_buf=None, inject=None,
                  rows=ALL_ROWS):
    """Everything after dissemination (liveness, churn, then the one-pass
    slot tail, which resets the rejoined rows) and the round's stats;
    returns ``(new_state, RoundStats)``. ``faults`` (the round's
    ``RoundFaults``) makes blacked-out rows silent to the detector and,
    with ``churn_faults``, folds the burst into the churn draws;
    ``fault_held`` is the delay buffer to carry (the input's when None) and
    ``fstats`` the round's fault counters. ``liveness`` (a ``QuorumSpec``)
    runs the quorum detector, with the accusers (drawing from
    ``k_accuse``) and forgers (``k_forge``) the round's faults field;
    without it the suspicion planes pass through untouched. ``growth`` (a
    ``CompiledGrowth``) admits the round's join batch after churn (from
    ``fold_in(state.rng, GROWTH_STREAM_SALT)``) and fills
    ``degree_gamma``. ``stream`` (a ``CompiledStream``) recycles the
    leases past their TTL through the tail (and out of the delay buffer),
    injects the round's arrivals after it (``host_rng``/``host_rnd``: the
    round's root key and round on the host) and fills the stream
    columns. ``control`` (a ``ControlSpec``) runs the control stage last:
    the AIMD update of ``control_lvl`` from the round's feedback (against
    ``rctl``, the decision delivery realized) and the PeerSwap refresh;
    without it ``control_lvl`` passes through untouched. ``pipe_buf`` is
    the in-flight exchange a pipelined round stores (None: the state's
    buffer rides through untouched); a stream's recycled columns die in
    it, as they do in the delay buffer. ``inject`` (an ``InjectBatch``)
    lands a serving window's arrivals after the stream's injection and
    fills the ``ingest_*`` columns. ``rows`` (``core.rows``) are the rows
    the state holds, which the row stages' side paths cross."""
    values = {
        "row_ptr": state.row_ptr, "col_idx": state.col_idx, "exists": state.exists,
        "seen": state.seen, "forwarded": state.forwarded,
        "infected_round": state.infected_round, "recovered": state.recovered,
        "alive": state.alive, "silent": state.silent, "last_hb": state.last_hb,
        "declared_dead": state.declared_dead, "rewired": state.rewired,
        "rewire_targets": state.rewire_targets, "degree_credit": state.degree_credit,
        "join_round": state.join_round, "admitted_by": state.admitted_by, "rng": state.rng,
        "rnd": rnd, "k_leave": k_leave, "k_join": k_join,
        "incoming": incoming, "transmit": transmit,
        "receptive": receptive, "fresh": None, "expired": None, "faults": faults,
        "suspect_round": state.suspect_round, "suspect_mark": state.suspect_mark,
        "quarantine": state.quarantine, "k_accuse": k_accuse, "k_forge": k_forge, "ltel": None,
        "slot_lease": state.slot_lease, "held": state.fault_held if fault_held is None else fault_held,
        "stel": None, "control_lvl": state.control_lvl, "rctl": rctl, "fstats": fstats,
        "seen_prev": state.seen, "ctel": None, "inject": inject, "itel": None,
    }
    values = run_stages(build_round_stages(cfg, tail=tail, faults=faults, churn_faults=churn_faults,
                                           liveness=liveness, growth=growth, stream=stream, host_rng=host_rng,
                                           host_rnd=host_rnd, control=control, inject=inject, rows=rows), values)
    if pipe_buf is not None and values["expired"] is not None:
        # the issue read the pre-expiry seen plane: a retired message's
        # in-flight bits would otherwise deliver into the column's new lease
        pipe_buf = pipe_buf & ~values["expired"][None, :]
    new_state = SwarmState(
        row_ptr=state.row_ptr, col_idx=state.col_idx,
        seen=values["seen"], forwarded=values["forwarded"],
        infected_round=values["infected_round"], recovered=values["recovered"],
        exists=values["exists"], alive=values["alive"], silent=values["silent"],
        last_hb=values["last_hb"], declared_dead=values["declared_dead"],
        rewired=values["rewired"], rewire_targets=values["rewire_targets"],
        fault_held=values["held"], join_round=values["join_round"],
        admitted_by=values["admitted_by"], degree_credit=values["degree_credit"],
        slot_lease=values["slot_lease"], control_lvl=values["control_lvl"],
        pipe_buf=state.pipe_buf if pipe_buf is None else pipe_buf, suspect_round=values["suspect_round"],
        suspect_mark=values["suspect_mark"], quarantine=values["quarantine"],
        rng=key, round=rnd,
    )
    return new_state, _stats(new_state, msgs_sent, fstats, values["ltel"], liveness, growth, stream,
                             values["stel"], values["ctel"], values["itel"], rows)


def gossip_round(state: SwarmState, cfg: SwarmConfig, plan=None, *, tail: str = "fused", rows=ALL_ROWS,
                 **later):
    """Advance the swarm one round; returns ``(new_state, RoundStats)``. A
    ``PackedSwarm`` runs the packed-native round and stays packed.
    ``scenario`` injects the round's faults (``host_round``, the state's
    round on the host, spares a device read); ``liveness`` (a
    ``QuorumSpec``) hardens the detector; ``inject`` (an ``InjectBatch``)
    lands a serving window's arrivals. ``rows`` (``core.rows``) are the
    rows the state holds: all of them but on a process of a mesh over
    several processes."""
    if is_packed(state):
        from tpu_gossip_torch.sim.packed_engine import gossip_round_packed

        return gossip_round_packed(state, cfg, plan, tail=tail, rows=rows, **later)

    def disseminate(tx, tr, rc, kp, kq, rctl):
        return _disseminate_local(state, cfg, tx, tr, rc, kp, kq, plan, rctl, rows)

    return run_protocol_round(state, cfg, disseminate, tail=tail, rows=rows, **later)


def _stack(rows: list[RoundStats]) -> RoundStats:
    return RoundStats(*(torch.stack(col) for col in zip(*rows)))


def _concat(parts: list[RoundStats]) -> RoundStats:
    """Stats of consecutive horizons joined along the round axis."""
    return RoundStats(*(torch.cat(col) for col in zip(*parts)))


def simulate(state: SwarmState, cfg: SwarmConfig, num_rounds: int, plan=None,
             tail: str = "fused", **later):
    """Run a fixed horizon; returns the final state and the per-round
    stats stacked along a leading (num_rounds,) axis. ``scenario`` threads
    a compiled fault schedule through every round, ``stream`` a compiled
    streaming workload; the state's round is their cursor, read once on
    the host with the state's key (``host_cursor``). ``inject``, a
    sequence of ``num_rounds`` batches (JAX's stacked ``InjectBatch``),
    lands one a round: the whole-run replay of a served trace."""
    batches = later.pop("inject", None)
    if batches is not None and len(batches) != num_rounds:
        raise ValueError(f"inject holds {len(batches)} batches for {num_rounds} rounds")
    r0, hkey = host_cursor(state, later)
    rows = []
    for i in range(num_rounds):
        state, st = gossip_round(state, cfg, plan, tail=tail, host_round=None if r0 is None else r0 + i,
                                 host_rng=hkey, inject=None if batches is None else batches[i], **later)
        hkey = next_host_key(hkey)
        rows.append(st)
    return state, _stack(rows)


def run_until_coverage(state: SwarmState, cfg: SwarmConfig, target: float = 0.99,
                       max_rounds: int = 1000, slot: int = 0, plan=None,
                       tail: str = "fused", **later) -> SwarmState:
    """Rounds until ``coverage(slot) >= target`` (compared in float32) or
    ``max_rounds``; rounds used = ``result.round - state.round``. Under a
    ``scenario`` rounds past its schedule run quiescent."""
    if later.get("inject") is not None:
        raise TypeError("run_until_coverage lands no serving batches (JAX's takes no inject): serve a fixed "
                        "horizon through simulate or gossip_round")
    start = state.round
    r0, hkey = host_cursor(state, later)
    tgt = torch.tensor(target, dtype=torch.float32, device=state.seen.device)
    s, i = state, 0
    # graftlint: disable=round-host-sync -- the coverage stop condition is read on the host once a round (JAX's while_loop)
    while bool((s.coverage(slot) < tgt) & (s.round - start < max_rounds)):
        s, _ = gossip_round(s, cfg, plan, tail=tail, host_round=None if r0 is None else r0 + i, host_rng=hkey,
                            **later)
        hkey = next_host_key(hkey)
        i += 1
    return s
