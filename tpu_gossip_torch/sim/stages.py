"""The round as declared stages: the shared driver of every engine.

Ports ``Stage``, ``StageView``, ``run_stages``, ``_liveness_stage`` (:175,
the direct detector with blacked-out rows read as silent, or the quorum
detector with the accusers' and forgers' half and the quarantine's credit
release), ``_churn_stage`` (:298, Poisson churn, the scenario's burst
thresholds, the re-wiring draws and the defended rejoin of quarantined
rows), ``_tail_stage``, ``build_round_stages`` (:673),
``effective_transmit_planes`` (:724) and ``run_protocol_round`` (:739) of
``tpu_gossip/sim/stages.py``, and ``_growth_stage`` (:483, the
preferential-attachment admission of ``growth/``, reading the fault
head's ``join_burst``). Each stage names the carries it reads and
writes and :func:`run_stages` enforces the declarations.
:func:`run_protocol_round` does the 5-way key split, the role masks (with
the quarantine's send mask under the quorum detector), the adversary
stream's fold, the engine's dissemination (wrapped by the scenario head,
``faults.inject.scenario_dissemination``, under a scenario) and the
post-delivery stages (liveness, churn, growth, tail).

``_stream_ageout_stage`` and ``_stream_inject_stage``
(``tpu_gossip/sim/stages.py:526,576``) run a stream (``traffic/``): the age-out before the tail, whose ``expired``
mask clears the recycled columns, and the injection after it.
``_control_stage`` (:640) runs the adaptive controller (``control/``) last,
after the injection; ``run_protocol_round`` resolves the round's
``RoundControl`` before delivery, after the quarantine mask.

``PipelineSpec`` and ``compile_pipeline`` (:74-99) select the pipelined
schedule: at depth 1 ``run_protocol_round`` delivers the exchange the last
round issued (``state.pipe_buf``) and carries this round's in its place
(:840-846). ``_ingest_stage`` (:609) lands a live-serving window's
arrivals (``traffic/ingest.py``, an ``InjectBatch``) after the stream's
injection, on the same lease table; ``run_protocol_round`` takes the batch
as ``inject``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import ALL_ROWS

__all__ = ["Stage", "StageView", "run_stages", "PipelineSpec", "compile_pipeline", "build_round_stages",
           "stream_stages", "control_stages", "ingest_stages", "check_inject",
           "resolve_control", "run_protocol_round",
           "pipeline_swap", "not_ported", "host_cursor", "next_host_key",
           "check_later", "row_stages", "first_rows", "has_churn", "effective_transmit_planes", "fault_round", "adversary_keys",
           "require_quorum"]


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """The pipelined schedule. ``depth=0`` is the serial schedule, bit for
    bit what ``pipeline=None`` runs; ``depth=1`` double-buffers the
    exchange through ``SwarmState.pipe_buf``: round *t* delivers what round
    *t-1* issued and issues its own, one round of delivery staleness.
    Deeper pipelines would add staleness and no overlap, so the depth is
    capped at 1."""

    depth: int = 1

    def __post_init__(self):
        if self.depth not in (0, 1):
            raise ValueError(
                f"pipeline depth must be 0 (serial, bit-identical) or 1 "
                f"(double-buffered exchange); got {self.depth}"
            )


def compile_pipeline(depth: int = 1) -> PipelineSpec:
    """Validate and freeze a pipelined-execution spec (see PipelineSpec)."""
    return PipelineSpec(depth=depth)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One post-dissemination round stage with declared carries."""

    name: str
    reads: tuple[str, ...]
    writes: tuple[str, ...]
    fn: Callable[["StageView"], dict]


class StageView(Mapping):
    """Read guard over the carry dict: a stage sees only what it declared."""

    def __init__(self, values: dict, stage: Stage):
        self._values = values
        self._stage = stage

    def __getitem__(self, key: str):
        if key not in self._stage.reads:
            raise ValueError(
                f"stage {self._stage.name!r} reads carry {key!r} without "
                f"declaring it — add it to reads={self._stage.reads}"
            )
        return self._values[key]

    def __iter__(self):
        return iter(self._stage.reads)

    def __len__(self):
        return len(self._stage.reads)


def run_stages(stages: tuple[Stage, ...], values: dict) -> dict:
    """Run the stages in order over the carry dict, enforcing each stage's
    declared reads and writes. Mutates and returns ``values``."""
    for st in stages:
        missing = [k for k in st.reads if k not in values]
        if missing:
            raise ValueError(f"stage {st.name!r} declares reads {missing} that nothing provides")
        out = st.fn(StageView(values, st))
        undeclared = [k for k in out if k not in st.writes]
        if undeclared:
            raise ValueError(f"stage {st.name!r} wrote undeclared carries {undeclared}")
        values.update(out)
    return values


def _liveness_stage(cfg, faults=None, liveness=None, rows=ALL_ROWS) -> Stage:
    """Heartbeat emission and failure detection (row-level). Under a
    scenario (``faults``, the round's ``RoundFaults``) a blacked-out row is
    a silent one for the phase: it emits no heartbeat and answers no
    probe, and the dead declaration it earns stays.

    With ``liveness`` (a ``QuorumSpec``) the quorum detector
    (``kernels.liveness.quorum_liveness``) replaces the direct one: the
    forgers' heartbeats land first, the accusers' verdicts vote with the
    witnesses (when the scenario fields them: ``faults.forger`` and
    ``faults.accuser`` are set), and a newly quarantined row's fresh edges
    are released through ``degree_credit`` as it leaves the rewired set.
    Adversaries emit only while alive, undeclared, not quarantined and not
    blacked out. The stage then also writes ``ltel``, the round's
    counters. ``liveness=None`` carries the suspicion planes untouched.
    ``rows`` (``core.rows``) are the rows the planes hold, which the
    adversaries' draws, reads and writes and the release cross."""
    from tpu_gossip_torch.kernels.liveness import (LivenessTelemetry, detect_failures, emit_heartbeats,
                                                    forge_heartbeats, quorum_liveness)

    has_faults = faults is not None
    has_accusers = has_faults and faults.accuser is not None
    has_forgers = has_faults and faults.forger is not None
    reads = ("silent", "alive", "declared_dead", "last_hb", "rnd") + (("faults",) if has_faults else ())
    writes = ("last_hb", "declared_dead")
    if liveness is not None:
        reads = reads + ("exists", "suspect_round", "suspect_mark", "quarantine", "rewired", "rewire_targets",
                         "degree_credit") + (("k_accuse",) if has_accusers else ()) + (
                             ("k_forge",) if has_forgers else ())
        writes = writes + ("suspect_round", "suspect_mark", "quarantine", "rewired", "rewire_targets",
                           "degree_credit", "ltel")

    def fn(ctx):
        silent_now = ctx["silent"] | ctx["faults"].blackout if has_faults else ctx["silent"]
        last_hb = emit_heartbeats(
            ctx["last_hb"], ctx["alive"], silent_now, ctx["declared_dead"],
            ctx["rnd"], cfg.hb_period_rounds,
        )
        if liveness is None:
            last_hb, declared_dead = detect_failures(
                last_hb, ctx["alive"], silent_now, ctx["declared_dead"], ctx["rnd"],
                cfg.timeout_rounds, cfg.detect_period_rounds,
            )
            return {"last_hb": last_hb, "declared_dead": declared_dead}

        adv_forged = torch.zeros((), dtype=torch.int32, device=last_hb.device)
        if has_forgers or has_accusers:
            rf = ctx["faults"]
            can_emit = ctx["alive"] & ~ctx["declared_dead"] & ~ctx["quarantine"] & ~rf.blackout
        if has_forgers:
            last_hb, adv_forged = forge_heartbeats(last_hb, ctx["suspect_round"], rf.forger & can_emit, ctx["rnd"],
                                                   ctx["k_forge"], rf.forge_fanout, rf.forge_width, rows)
        out = quorum_liveness(
            liveness, last_hb, ctx["alive"], silent_now, ctx["declared_dead"], ctx["suspect_round"],
            ctx["suspect_mark"], ctx["quarantine"], ctx["exists"], ctx["rnd"], cfg.timeout_rounds,
            cfg.detect_period_rounds, k_accuse=ctx["k_accuse"] if has_accusers else None,
            accuser_ok=rf.accuser & can_emit if has_accusers else None, rows=rows,
        )
        # a quarantined row rejoins its CSR edges: its fresh targets'
        # credit goes back and it leaves the rewired set
        rewired, rewire_targets = ctx["rewired"], ctx["rewire_targets"]
        newly_q = out["newly_quarantined"]
        q_rw = newly_q & rewired
        degree_credit = _add_at(ctx["degree_credit"], (rewire_targets, q_rw[:, None] & (rewire_targets >= 0), -1),
                                rows=rows)
        return {
            "last_hb": out["last_hb"], "declared_dead": out["declared_dead"],
            "suspect_round": out["suspect_round"], "suspect_mark": out["suspect_mark"],
            "quarantine": out["quarantine"], "rewired": rewired & ~newly_q,
            "rewire_targets": torch.where(q_rw[:, None], -1, rewire_targets), "degree_credit": degree_credit,
            "ltel": LivenessTelemetry(evictions_new=out["evictions_new"], false_evictions=out["false_evictions"],
                                      adv_accusations=out["adv_accusations"], adv_forged=adv_forged),
        }

    return Stage("liveness", reads, writes, fn)


def first_rows(mask: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.nonzero(mask, size=cap, fill_value=0)`` without a host sync:
    the first ``cap`` set rows in order (int64, 0 past the count) and the
    (cap,) mask of the entries that hold a row."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)
    rows = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    rows.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=mask.device))
    live = torch.arange(cap, device=mask.device) < mask.sum()
    return torch.where(live, rows[:cap], 0), live


def _below(u: torch.Tensor, p: float) -> torch.Tensor:
    """``u < p`` with ``p`` rounded to float32, as JAX compares a float32
    draw with a Python float."""
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)


def _add_at(vec: torch.Tensor, *terms, rows=ALL_ROWS, label: str = "credit") -> torch.Tensor:
    """``vec.at[where(keep, idx, n)].add(delta, mode="drop")`` for each
    ``(idx, keep, delta)`` term in turn, ``idx`` rows of the swarm: the
    terms add into a plane over the swarm's rows (the dropped entries on a
    spare slot past the end), whose integer sum over the holders of
    ``rows`` (``core.rows``) lands on ``vec`` (its bytes under
    ``label``)."""
    n_all = rows.total(vec.shape[0])
    out = vec.new_zeros(n_all + 1)
    for idx, keep, delta in terms:
        # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
        tgt = torch.where(keep, idx.to(torch.int64), n_all).reshape(-1)
        out.index_add_(0, tgt, torch.full(tgt.shape, delta, dtype=vec.dtype, device=vec.device))
    return vec + rows.reduce(out[:n_all], "sum", label=label)


def _burst_threshold(p_cfg: float, burst: torch.Tensor, p_burst: torch.Tensor) -> torch.Tensor:
    """``1 - (1 - p_cfg) * (1 - where(burst, p_burst, 0))`` per row in
    float32, rounded as JAX evaluates it: ``1 - p_cfg`` in double, then
    rounded to float32 where it meets the float32 table."""
    keep_cfg = torch.tensor(1.0 - p_cfg, dtype=torch.float32, device=burst.device)
    extra = torch.where(burst, p_burst, torch.zeros((), dtype=torch.float32, device=burst.device))
    return 1.0 - keep_cfg * (1.0 - extra)


def _churn_stage(cfg, burst: bool = False, defended: bool = False, rows=ALL_ROWS) -> Stage:
    """Poisson churn, row-level half (BASELINE config 5), and the
    re-wiring draws: departures, rejoins of vacant member slots with fresh
    row state, and each rejoiner's ``rewire_slots`` degree-preferential
    endpoints (a uniform index below ``row_ptr[-1]`` into the CSR endpoint
    list), dense over every row or compacted to ``rewire_compact_cap``
    joiner rows. The fresh rows' slot planes are reset by the tail
    (``fresh``). Self draws and draws on non-member rows become -1;
    ``degree_credit`` releases an overwritten rejoiner's targets and
    grants the new ones. With ``burst`` the scenario's leave and join
    probabilities fold into the same draws as per-row thresholds
    (``P = 1 - (1 - p_cfg)(1 - p_burst)`` on burst rows): keys and shapes
    are untouched, and both draws run every round. ``defended`` (the
    quorum detector is on): a quarantined rejoiner takes no fresh edges
    and rejoins on its slot's CSR edges (``fresh_rw = fresh &
    ~quarantine``); only masks move, so with nobody quarantined the round
    is unchanged.

    The planes hold ``rows`` (``core.rows``; on a process of a mesh over
    several processes, its block): the draws are their block of each of
    the swarm's draws, the rejoiners' endpoints are checked against the
    swarm's ``exists``, their credit lands on the targets' holders, and
    the compact table is the swarm's first ``cap`` rejoiners (the gathered
    ``fresh_rw``), each holder keeping the ones it holds."""
    reads = ("alive", "silent", "exists", "last_hb", "declared_dead", "rewired", "rewire_targets",
             "degree_credit", "row_ptr", "col_idx", "rnd", "k_leave", "k_join") + (("faults",) if burst else ()) + (
                 ("quarantine",) if defended else ())
    writes = ("alive", "silent", "last_hb", "declared_dead", "rewired", "rewire_targets", "degree_credit", "fresh")

    def fn(ctx):
        from tpu_gossip_torch.core.state import saturate_round

        alive, silent, last_hb = ctx["alive"], ctx["silent"], ctx["last_hb"]
        declared_dead, rewired = ctx["declared_dead"], ctx["rewired"]
        rewire_targets, degree_credit = ctx["rewire_targets"], ctx["degree_credit"]
        fresh = None
        faults = ctx["faults"] if burst else None
        n = alive.shape[0]
        lo, n_all = rows.lo, rows.total(n)
        if cfg.churn_leave_prob > 0.0 or burst:
            u = prng.uniform(ctx["k_leave"], tuple(alive.shape), offset=lo)
            gone = (u < _burst_threshold(cfg.churn_leave_prob, faults.burst, faults.leave) if burst
                    else _below(u, cfg.churn_leave_prob))
            alive = alive & ~gone
        if cfg.churn_join_prob > 0.0 or burst:
            k_join, k_rw = prng.split(ctx["k_join"])
            u = prng.uniform(k_join, tuple(alive.shape), offset=lo)
            back = (u < _burst_threshold(cfg.churn_join_prob, faults.burst, faults.join) if burst
                    else _below(u, cfg.churn_join_prob))
            fresh = ~alive & ctx["exists"] & back
            alive = alive | fresh
            silent = silent & ~fresh
            last_hb = torch.where(fresh, saturate_round(ctx["rnd"], last_hb.dtype), last_hb)
            declared_dead = declared_dead & ~fresh
            # quarantined identities rejoin on their slot's CSR edges
            fresh_rw = fresh & ~ctx["quarantine"] if defended else fresh
            col_idx = ctx["col_idx"]
            if cfg.rewire_slots > 0 and col_idx.shape[0] > 0:
                s = rewire_targets.shape[1]
                e_real = torch.clamp(ctx["row_ptr"][-1], min=1)
                cap = min(cfg.rewire_compact_cap, n_all)
                if cap == 0:
                    (exists_all,) = rows.gather(ctx["exists"], label="churn")
                    jrows = torch.arange(lo, lo + n, dtype=torch.int64, device=alive.device)
                    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
                    draws = col_idx[prng.randint(k_rw, (n, s), 0, e_real, lo * s).to(torch.int64)]
                else:
                    exists_all, fresh_all = rows.gather(ctx["exists"], fresh_rw, label="churn")
                    # the swarm's first cap rejoiners: every holder draws
                    # the one (cap, s) block and keeps the rows it holds
                    jrows, jlive = first_rows(fresh_all, cap)
                    mine = jlive & (jrows >= lo) & (jrows < lo + n)
                    draws = col_idx[prng.randint(k_rw, (cap, s), 0, e_real).to(torch.int64)]
                # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
                ok = exists_all[draws.to(torch.int64)] & (draws.to(torch.int64) != jrows[:, None])
                draws = torch.where(ok, draws, -1)
                released = (fresh_rw & rewired)[:, None] & (rewire_targets >= 0)
                if cap == 0:
                    degree_credit = _add_at(degree_credit, (rewire_targets, released, -1),
                                            (draws, fresh_rw[:, None] & (draws >= 0), 1), rows=rows)
                    rewire_targets = torch.where(fresh_rw[:, None], draws, rewire_targets)
                    rewired = rewired | fresh_rw
                else:
                    degree_credit = _add_at(degree_credit, (rewire_targets, released, -1),
                                            (draws, mine[:, None] & (draws >= 0), 1), rows=rows)
                    sel = torch.where(mine, jrows - lo, n)
                    rewire_targets = torch.cat([rewire_targets, rewire_targets.new_zeros((1, s))])
                    rewire_targets[sel] = draws.to(rewire_targets.dtype)
                    rewire_targets = rewire_targets[:n]
                    selected = torch.zeros(n + 1, dtype=torch.bool, device=alive.device)
                    selected[sel] = True
                    selected = selected[:n]
                    # joiners past the cap rejoin on their slot's CSR edges:
                    # a previously rewired slot drops its stale targets
                    unselected = fresh & ~selected
                    rewired = (rewired & ~unselected) | (fresh & selected)
                    rewire_targets = torch.where(unselected[:, None], -1, rewire_targets)
        return {"alive": alive, "silent": silent, "last_hb": last_hb, "declared_dead": declared_dead,
                "rewired": rewired, "rewire_targets": rewire_targets, "degree_credit": degree_credit,
                "fresh": fresh}

    return Stage("churn", reads, writes, fn)


def _growth_stage(cfg, growth, has_faults: bool, rows=ALL_ROWS) -> Stage:
    """Preferential-attachment admission (``growth/engine.py``), row-level:
    this round's join batch is admitted after the churn draws, from the
    growth stream, so a zero-join or exhausted schedule reproduces the
    fixed-n run bit for bit. An admitted row's slot planes are untouched
    (a never-member row was never receptive), so the tail needs no reset
    for it. The planes hold ``rows`` (``core.rows``)."""
    if cfg.rewire_slots < growth.attach_m:
        raise ValueError(
            f"growth.attach_m={growth.attach_m} needs "
            f"cfg.rewire_slots >= {growth.attach_m} — growth edges "
            "ride the re-wiring plane's delivery paths"
        )
    fields = ("exists", "alive", "silent", "last_hb", "declared_dead", "rewired",
              "rewire_targets", "join_round", "admitted_by", "degree_credit")
    reads = ("rng", "rnd", "row_ptr") + fields + (("faults",) if has_faults else ())

    def fn(ctx):
        from tpu_gossip_torch.growth.engine import apply_growth

        jb = ctx["faults"].join_burst if has_faults else None
        if jb is None:
            jb = torch.zeros((), dtype=torch.int32, device=ctx["exists"].device)
        grown = apply_growth(growth, ctx["rng"], ctx["rnd"], jb, row_ptr=ctx["row_ptr"],
                             **{f: ctx[f] for f in fields}, held=rows)
        return {f: grown[f] for f in fields}

    return Stage("growth", reads, fields, fn)


def _tail_stage(cfg, tail: str) -> Stage:
    """One traversal of the (N, M) slot planes (kernels.round_tail)."""
    reads = (
        "seen", "forwarded", "infected_round", "recovered", "incoming",
        "receptive", "transmit", "fresh", "rnd", "expired",
    )
    writes = ("seen", "forwarded", "infected_round", "recovered")

    def fn(ctx):
        from tpu_gossip_torch.kernels.round_tail import round_tail

        seen, forwarded, infected_round, recovered = round_tail(
            ctx["seen"], ctx["forwarded"], ctx["infected_round"], ctx["recovered"],
            ctx["incoming"], ctx["receptive"], ctx["transmit"], ctx["fresh"], ctx["rnd"],
            forward_once=cfg.forward_once, sir_recover_rounds=cfg.sir_recover_rounds,
            expired=ctx["expired"], impl=tail,
        )
        return {"seen": seen, "forwarded": forwarded,
                "infected_round": infected_round, "recovered": recovered}

    return Stage("tail", reads, writes, fn)


def _stream_ageout_stage(stream, packed: bool = False) -> Stage:
    """Slot columns past their TTL recycle (``traffic/``): the expired mask
    folds into the tail like the churn fresh mask, and the delay buffer
    drops the recycled columns' held bits (they belong to the recycled
    message); on packed words that drop is a packed-column AND."""

    def fn(ctx):
        from tpu_gossip_torch.core.packed import pack_bits
        from tpu_gossip_torch.traffic.engine import slot_expiry

        expired = slot_expiry(ctx["slot_lease"], ctx["rnd"], stream.ttl)
        slot_lease = torch.where(expired, torch.full_like(ctx["slot_lease"], -1), ctx["slot_lease"])
        held = ctx["held"] & (pack_bits(~expired) if packed else ~expired)[None, :]
        return {"expired": expired, "slot_lease": slot_lease, "held": held}

    return Stage("stream_ageout", ("slot_lease", "rnd", "held"), ("expired", "slot_lease", "held"), fn)


def _stream_inject_stage(stream, host_rng=None, host_rnd: int | None = None, packed_m: int | None = None,
                         rows=ALL_ROWS) -> Stage:
    """The stream's injection (``traffic/``), after the tail: a round-r
    arrival first transmits in round r + 1 and a just-recycled slot is
    leasable again. ``host_rng`` and ``host_rnd`` are the round's root key
    and round on the host (read off the device when None). With
    ``packed_m`` the seen plane is words: the injection decodes them at
    this boundary and packs the product, as JAX's packed twin does. The
    planes hold ``rows`` (``core.rows``)."""
    reads = ("rng", "rnd", "expired", "seen", "infected_round", "slot_lease", "row_ptr", "col_idx", "exists",
             "alive", "declared_dead")
    writes = ("seen", "infected_round", "slot_lease", "stel")

    def fn(ctx):
        from tpu_gossip_torch.core.packed import pack_bits, unpack_bits
        from tpu_gossip_torch.traffic.engine import apply_stream

        seen = ctx["seen"] if packed_m is None else unpack_bits(ctx["seen"], packed_m)
        seen, infected_round, slot_lease, stel = apply_stream(
            stream, ctx["rng"], ctx["rnd"], ctx["expired"].sum(dtype=torch.int32), seen=seen,
            infected_round=ctx["infected_round"], slot_lease=ctx["slot_lease"], row_ptr=ctx["row_ptr"],
            col_idx=ctx["col_idx"], exists=ctx["exists"], alive=ctx["alive"],
            declared_dead=ctx["declared_dead"], host_rng=host_rng, host_rnd=host_rnd, rows=rows)
        return {"seen": seen if packed_m is None else pack_bits(seen), "infected_round": infected_round,
                "slot_lease": slot_lease, "stel": stel}

    return Stage("stream_inject", reads, writes, fn)


def _ingest_stage(packed_m: int | None = None) -> Stage:
    """Live-arrival injection (``traffic/ingest.py``), after the tail like
    the stream's: a round-r arrival first transmits in round r + 1, and
    origins are gated on the round's final liveness. Runs after
    ``stream_inject``, so synthetic and live traffic compose: the stream's
    draws are untouched (ingest consumes no randomness) and both share the
    one lease table. The batch rides the carry dict (``inject``). With
    ``packed_m`` the seen plane is words, decoded at this boundary and
    packed again when the window holds arrivals, as JAX's packed twin does
    (``sim/packed_engine.py:276``)."""
    reads = ("rnd", "inject", "seen", "infected_round", "slot_lease", "exists", "alive", "declared_dead")
    writes = ("seen", "infected_round", "slot_lease", "itel")

    def fn(ctx):
        from tpu_gossip_torch.core.packed import pack_bits, unpack_bits
        from tpu_gossip_torch.traffic.ingest import apply_arrivals

        batch = ctx["inject"]
        words = packed_m is not None and batch.count > 0
        seen, infected_round, slot_lease, itel = apply_arrivals(
            batch, ctx["rnd"], seen=unpack_bits(ctx["seen"], packed_m) if words else ctx["seen"],
            infected_round=ctx["infected_round"], slot_lease=ctx["slot_lease"], exists=ctx["exists"],
            alive=ctx["alive"], declared_dead=ctx["declared_dead"])
        return {"seen": pack_bits(seen) if words else seen, "infected_round": infected_round,
                "slot_lease": slot_lease, "itel": itel}

    return Stage("ingest", reads, writes, fn)


def ingest_stages(inject, packed_m: int | None = None) -> tuple[Stage, ...]:
    """The ingest stage when the round lands a batch, else none."""
    return () if inject is None else (_ingest_stage(packed_m),)


def check_inject(inject) -> None:
    """``inject`` must be None or an :class:`~tpu_gossip_torch.traffic.
    ingest.InjectBatch` on the round's device."""
    from tpu_gossip_torch.traffic.ingest import InjectBatch

    if inject is not None and not isinstance(inject, InjectBatch):
        raise TypeError(f"inject must be an InjectBatch (traffic.ingest.make_batch), got {type(inject).__name__}")


CONTROL_READS = ("rng", "rnd", "rctl", "incoming", "seen_prev", "seen", "alive", "declared_dead", "exists",
                 "rewired", "rewire_targets", "degree_credit", "row_ptr", "col_idx", "slot_lease", "fstats",
                 "control_lvl")


def _control_stage(cfg, control, packed_m: int | None = None, rows=ALL_ROWS) -> Stage:
    """Adaptive control (``control/``), last: the AIMD level update reads
    the round's final liveness and lease tables, and the PeerSwap refresh
    acts on the post-churn, post-growth re-wiring plane. With ``packed_m``
    the slot planes are words, and the three that ``apply_control`` reads
    (``incoming``, ``seen_prev``, ``seen``) decode at this boundary. The
    planes hold ``rows`` (``core.rows``)."""

    def fn(ctx):
        from tpu_gossip_torch.control.engine import apply_control
        from tpu_gossip_torch.core.packed import unpack_bits

        def plane(name):
            return ctx[name] if packed_m is None else unpack_bits(ctx[name], packed_m)

        control_lvl, rewire_targets, degree_credit, ctel = apply_control(
            control, ctx["rng"], ctx["rnd"], ctx["rctl"], incoming=plane("incoming"), seen_prev=plane("seen_prev"),
            seen=plane("seen"), alive=ctx["alive"], declared_dead=ctx["declared_dead"], exists=ctx["exists"],
            rewired=ctx["rewired"], rewire_targets=ctx["rewire_targets"], degree_credit=ctx["degree_credit"],
            row_ptr=ctx["row_ptr"], col_idx=ctx["col_idx"], slot_lease=ctx["slot_lease"],
            rewire_slots=cfg.rewire_slots, fstats=ctx["fstats"], rows=rows)
        return {"control_lvl": control_lvl, "rewire_targets": rewire_targets, "degree_credit": degree_credit,
                "ctel": ctel}

    return Stage("control", CONTROL_READS, ("control_lvl", "rewire_targets", "degree_credit", "ctel"), fn)


def control_stages(cfg, control, packed_m: int | None = None, rows=ALL_ROWS) -> tuple[Stage, ...]:
    """The control stage when a controller runs, else none."""
    return () if control is None else (_control_stage(cfg, control, packed_m, rows),)


def stream_stages(stream, tail_stage: Stage, host_rng=None, host_rnd: int | None = None,
                  packed_m: int | None = None, rows=ALL_ROWS) -> tuple[Stage, ...]:
    """The tail with the stream's age-out before it and its injection after
    it, as ``build_round_stages`` places them; the tail alone without a
    stream."""
    if stream is None:
        return (tail_stage,)
    return (_stream_ageout_stage(stream, packed_m is not None), tail_stage,
            _stream_inject_stage(stream, host_rng, host_rnd, packed_m, rows))


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error a part of a later slice raises."""
    return NotImplementedError(f"{what} is not ported yet: it comes with the {where} slice")


def has_churn(cfg) -> bool:
    """Whether the config's rounds run the churn stage."""
    return cfg.churn_leave_prob > 0.0 or cfg.churn_join_prob > 0.0


def row_stages(cfg, *, faults=None, churn_faults: bool = False, liveness=None, growth=None,
               rows=ALL_ROWS) -> tuple[Stage, ...]:
    """The row-level stages of one round, in JAX's order: liveness
    (reading the round's ``faults`` under a scenario, the quorum detector
    and the adversaries' half with ``liveness``), churn (when the config
    churns or the scenario has a churn burst, then in its burst form;
    defended with ``liveness``), then growth admission (with ``growth``, a
    ``CompiledGrowth``). ``rows`` (``core.rows``) are the rows the planes
    hold."""
    burst = faults is not None and churn_faults
    churn = (_churn_stage(cfg, burst, defended=liveness is not None, rows=rows),) if has_churn(cfg) or burst else ()
    grow = (_growth_stage(cfg, growth, faults is not None, rows),) if growth is not None else ()
    return (_liveness_stage(cfg, faults, liveness, rows), *churn, *grow)


def build_round_stages(cfg, *, tail: str = "fused", faults=None, churn_faults: bool = False,
                       liveness=None, growth=None, stream=None, host_rng=None,
                       host_rnd: int | None = None, control=None, inject=None,
                       rows=ALL_ROWS) -> tuple[Stage, ...]:
    """The post-dissemination stages of one round: :func:`row_stages`,
    then, with a ``stream``, its age-out, the tail and its injection
    (:func:`stream_stages`), else the tail; then, with ``inject`` (an
    ``InjectBatch``), the ingest stage; then, with ``control``, the control
    stage."""
    return (*row_stages(cfg, faults=faults, churn_faults=churn_faults, liveness=liveness, growth=growth, rows=rows),
            *stream_stages(stream, _tail_stage(cfg, tail), host_rng, host_rnd, rows=rows), *ingest_stages(inject),
            *control_stages(cfg, control, rows=rows))


def check_later(later: dict) -> None:
    """Refuse any unknown argument."""
    if later:
        raise TypeError(f"unexpected arguments {sorted(later)}")


def effective_transmit_planes(state, cfg, scenario=None):
    """(tx_eff, transmitter, receptive) for this round as the round
    computes them: the transmit plane after the round's blackout mask."""
    from tpu_gossip_torch.sim import engine as _engine

    _, transmitter, receptive = _engine.compute_roles(state)
    transmit = _engine.transmit_bitmap(state, cfg, transmitter)
    if scenario is not None and scenario.has_blackout:
        rf = scenario.at_round(state.round + 1)
        transmit = transmit & ~rf.blackout[:, None]
    return transmit, transmitter, receptive


def fault_round(state, host_round: int | None) -> int:
    """The round number a scenario's tables are read at: the state's next
    round as a Python int (from ``host_round``, the state's round when the
    caller knows it, else read off the device once), so the phase and the
    partition branch are picked on the host."""
    # graftlint: disable=round-host-sync -- the scenario's phase is picked on the host; the loops pass host_round and read it once
    return (int(state.round) if host_round is None else int(host_round)) + 1


def adversary_keys(scenario, rng):
    """``(k_accuse, k_forge, k_flood)``: the adversary stream's three
    children, ``split(fold_in(rng, ADVERSARY_STREAM_SALT), 3)``, folded
    once a round when the scenario fields adversaries; Nones otherwise."""
    if scenario is None or not scenario.has_adversary:
        return None, None, None
    from tpu_gossip_torch.core.streams import ADVERSARY_STREAM_SALT

    k_accuse, k_forge, k_flood = prng.split(prng.fold_in(rng, ADVERSARY_STREAM_SALT), 3)
    return k_accuse, k_forge, k_flood


def require_quorum(scenario, liveness) -> None:
    """An adversary scenario needs the quorum detector: JAX's ValueError."""
    if scenario is not None and scenario.has_adversary and liveness is None:
        raise ValueError(
            "the scenario fields Byzantine adversaries (accusers/forgers/"
            "floods) but no QuorumSpec is active — adversary rounds need "
            "the defense planes compiled in; pass liveness=compile_quorum"
            "(...) (quorum_k=1 reproduces the reference's single-report "
            "purge)"
        )


def resolve_control(control, state, cfg, rows=ALL_ROWS):
    """The round's ``RoundControl`` (None without a controller), resolved
    from ``state``'s cursor before delivery; the needy rows only where a
    pull half consumes them. The state holds ``rows`` (``core.rows``)."""
    if control is None:
        return None
    from tpu_gossip_torch.control.engine import control_round

    return control_round(control, state, want_needy=cfg.mode == "push_pull", rows=rows)


def run_protocol_round(state, cfg, disseminate: Callable, *, tail: str = "fused", scenario=None,
                       host_round: int | None = None, liveness=None, growth=None, stream=None, host_rng=None,
                       control=None, pipeline=None, inject=None, rows=ALL_ROWS, **later):
    """One whole protocol round, engine-agnostic.

    ``disseminate(tx, transmitter, receptive, k_push, k_pull, rctl) ->
    (incoming, msgs_sent)`` is the engine's delivery core, ``rctl`` the
    round's ``RoundControl`` (None without a controller). It splits the
    state's key five ways (next key, push, pull, leave, join: the last two
    drive the churn stage), computes the role masks, delivers, and runs
    the stages through
    ``sim.engine.advance_round``. Returns ``(new_state, RoundStats)``.

    ``scenario`` (a :class:`~tpu_gossip_torch.faults.CompiledScenario`)
    wraps the delivery in the round's faults; its draws come from their own
    stream, so a quiescent scenario changes no bit. ``host_round`` is
    ``state.round`` when the caller knows it on the host (the horizon
    loops do), sparing a device read a round. ``liveness`` (a
    ``QuorumSpec``) runs the quorum detector: a quarantined row's sends
    are masked, and a scenario's adversaries draw from the adversary
    stream (:func:`adversary_keys`); adversaries without it raise JAX's
    ValueError. ``growth`` (a ``CompiledGrowth``) admits the round's join
    batch after churn. ``stream`` (a ``CompiledStream``) ages leases out
    through the tail and injects the round's arrivals after it;
    ``host_rng`` is ``state.rng`` on the host when the caller mirrors it
    (the horizon loops do), sparing a device read a round. ``control`` (a
    ``ControlSpec``) resolves the round's decision from the state's cursor
    after the quarantine mask, hands it to every delivery (the scenario
    head's included) and runs the control stage last. ``pipeline`` (a
    ``PipelineSpec``) at depth 1 swaps the delivered plane for the
    exchange the last round issued (``state.pipe_buf``) and carries this
    round's issue in flight; everything on the issue side (billing, the
    ``tx_eff`` latch, fault telemetry, the held buffer) stays with the
    round that issued it. Depth 0 and None are the serial schedule.
    ``inject`` (an ``InjectBatch``) lands a live-serving window's arrivals
    after the tail and the stream's injection (:func:`_ingest_stage`); a
    zero-count batch equals ``inject=None`` bit for bit. ``rows``
    (``core.rows``) are the rows the state holds: all of them but on a
    process of a mesh over several processes.
    """
    from tpu_gossip_torch.sim import engine as _engine

    check_later(later)
    check_inject(inject)
    require_quorum(scenario, liveness)
    _engine.validate_rewire_width(state, cfg)
    rnd = state.round + 1
    key, k_push, k_pull, k_leave, k_join = prng.split(state.rng, 5)
    _, transmitter, receptive = _engine.compute_roles(state)
    transmit = _engine.transmit_bitmap(state, cfg, transmitter)
    if liveness is not None:
        # a quarantined peer still receives and stays a member; its sends
        # are masked
        transmit = transmit & ~state.quarantine[:, None]
    rctl = resolve_control(control, state, cfg, rows)
    k_accuse, k_forge, k_flood = adversary_keys(scenario, state.rng)
    if scenario is None:
        incoming, msgs_sent = disseminate(transmit, transmitter, receptive, k_push, k_pull, rctl)
        tx_eff, held, telem, rf = transmit, None, None, None
    else:
        from tpu_gossip_torch.faults.inject import scenario_dissemination

        incoming, msgs_sent, tx_eff, held, telem, rf = scenario_dissemination(
            scenario, state, fault_round(state, host_round), transmit, transmitter, receptive,
            k_push, k_pull, lambda tx, tr, rc, kp, kq: disseminate(tx, tr, rc, kp, kq, rctl), k_flood=k_flood,
            rows=rows)
    incoming, pipe_buf = pipeline_swap(pipeline, state.pipe_buf, incoming)
    return _engine.advance_round(
        state, cfg, incoming, msgs_sent, tx_eff, rnd, key, k_leave, k_join, receptive, tail=tail,
        faults=rf, churn_faults=scenario is not None and scenario.has_churn, fault_held=held, fstats=telem,
        liveness=liveness, k_accuse=k_accuse, k_forge=k_forge, growth=growth, stream=stream,
        host_rng=host_rng, host_rnd=None if host_round is None else host_round + 1, control=control, rctl=rctl,
        pipe_buf=pipe_buf, inject=inject, rows=rows,
    )


def pipeline_swap(pipeline, buffered, issued):
    """``(delivered, stored)``: under a depth-1 ``pipeline`` the buffered
    exchange delivers and the issued one is stored; otherwise the issued
    plane delivers and nothing is stored (None: the state's buffer rides
    through untouched)."""
    if pipeline is not None and pipeline.depth > 0:
        return buffered, issued
    return issued, None


def host_cursor(state, later: dict) -> tuple[int | None, torch.Tensor | None]:
    """``(round, key)``: the state's round and root key read once on the
    host for the horizon loops, which count the round on and split the key
    on from them (:func:`next_host_key`); the round under a scenario or a
    stream, the key under a stream, None otherwise."""
    stream = later.get("stream") is not None
    # graftlint: disable=round-host-sync -- the loops read the round and key once and carry them on the host
    r0 = int(state.round) if later.get("scenario") is not None or stream else None
    # graftlint: disable=round-host-sync -- the loops read the round and key once and carry them on the host
    return r0, state.rng.cpu() if stream else None


def next_host_key(host_rng: torch.Tensor | None) -> torch.Tensor | None:
    """The next round's root key on the host: child 0 of the round's
    5-way split, as the round derives it."""
    return None if host_rng is None else prng.split(host_rng, 5)[0]
