"""The round as declared stages: the shared driver of every engine.

Ports ``Stage``, ``StageView``, ``run_stages``, ``_liveness_stage`` (the
direct detector, blacked-out rows read as silent), ``_churn_stage`` (:298,
Poisson churn, the scenario's burst thresholds and the re-wiring draws),
``_tail_stage``, ``build_round_stages`` (:673),
``effective_transmit_planes`` (:724) and ``run_protocol_round`` (:739) of
``tpu_gossip/sim/stages.py``. Each stage names the carries it reads and
writes and :func:`run_stages` enforces the declarations.
:func:`run_protocol_round` does the 5-way key split, the role masks, the
engine's dissemination (wrapped by the scenario head,
``faults.inject.scenario_dissemination``, under a scenario) and the
post-delivery stages (liveness, churn, tail).

Growth, streams, control, pipelining, the quorum detector (with its
quarantined rejoin) and live ingestion are later slices; their arguments
raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from tpu_gossip_torch.core import prng

__all__ = ["Stage", "StageView", "run_stages", "build_round_stages", "run_protocol_round", "not_ported",
           "check_later", "first_rows", "has_churn", "effective_transmit_planes", "fault_round"]


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


def _liveness_stage(cfg, has_faults: bool = False) -> Stage:
    """Heartbeat emission + the direct failure detector (row-level). Under a
    scenario a blacked-out row is a silent one for the phase: it emits no
    heartbeat and answers no probe, and the dead declaration it earns
    stays."""
    from tpu_gossip_torch.kernels.liveness import detect_failures, emit_heartbeats

    def fn(ctx):
        silent_now = ctx["silent"] | ctx["faults"].blackout if has_faults else ctx["silent"]
        last_hb = emit_heartbeats(
            ctx["last_hb"], ctx["alive"], silent_now, ctx["declared_dead"],
            ctx["rnd"], cfg.hb_period_rounds,
        )
        last_hb, declared_dead = detect_failures(
            last_hb, ctx["alive"], silent_now, ctx["declared_dead"], ctx["rnd"],
            cfg.timeout_rounds, cfg.detect_period_rounds,
        )
        return {"last_hb": last_hb, "declared_dead": declared_dead}

    reads = ("silent", "alive", "declared_dead", "last_hb", "rnd") + (("faults",) if has_faults else ())
    return Stage("liveness", reads, ("last_hb", "declared_dead"), fn)


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


def _add_at(vec: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor, delta: int) -> torch.Tensor:
    """``vec.at[where(keep, idx, n)].add(delta, mode="drop")``: the dropped
    entries land on a spare slot past the end."""
    n = vec.shape[0]
    tgt = torch.where(keep, idx.to(torch.int64), n).reshape(-1)
    out = torch.cat([vec, vec.new_zeros(1)])
    out.index_add_(0, tgt, torch.full(tgt.shape, delta, dtype=vec.dtype, device=vec.device))
    return out[:n]


def _burst_threshold(p_cfg: float, burst: torch.Tensor, p_burst: torch.Tensor) -> torch.Tensor:
    """``1 - (1 - p_cfg) * (1 - where(burst, p_burst, 0))`` per row in
    float32, rounded as JAX evaluates it: ``1 - p_cfg`` in double, then
    rounded to float32 where it meets the float32 table."""
    keep_cfg = torch.tensor(1.0 - p_cfg, dtype=torch.float32, device=burst.device)
    extra = torch.where(burst, p_burst, torch.zeros((), dtype=torch.float32, device=burst.device))
    return 1.0 - keep_cfg * (1.0 - extra)


def _churn_stage(cfg, burst: bool = False) -> Stage:
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
    are untouched, and both draws run every round."""
    reads = ("alive", "silent", "exists", "last_hb", "declared_dead", "rewired", "rewire_targets",
             "degree_credit", "row_ptr", "col_idx", "rnd", "k_leave", "k_join") + (("faults",) if burst else ())
    writes = ("alive", "silent", "last_hb", "declared_dead", "rewired", "rewire_targets", "degree_credit", "fresh")

    def fn(ctx):
        from tpu_gossip_torch.core.state import saturate_round

        alive, silent, last_hb = ctx["alive"], ctx["silent"], ctx["last_hb"]
        declared_dead, rewired = ctx["declared_dead"], ctx["rewired"]
        rewire_targets, degree_credit = ctx["rewire_targets"], ctx["degree_credit"]
        fresh = None
        faults = ctx["faults"] if burst else None
        if cfg.churn_leave_prob > 0.0 or burst:
            u = prng.uniform(ctx["k_leave"], tuple(alive.shape))
            gone = (u < _burst_threshold(cfg.churn_leave_prob, faults.burst, faults.leave) if burst
                    else _below(u, cfg.churn_leave_prob))
            alive = alive & ~gone
        if cfg.churn_join_prob > 0.0 or burst:
            k_join, k_rw = prng.split(ctx["k_join"])
            u = prng.uniform(k_join, tuple(alive.shape))
            back = (u < _burst_threshold(cfg.churn_join_prob, faults.burst, faults.join) if burst
                    else _below(u, cfg.churn_join_prob))
            fresh = ~alive & ctx["exists"] & back
            alive = alive | fresh
            silent = silent & ~fresh
            last_hb = torch.where(fresh, saturate_round(ctx["rnd"], last_hb.dtype), last_hb)
            declared_dead = declared_dead & ~fresh
            col_idx = ctx["col_idx"]
            if cfg.rewire_slots > 0 and col_idx.shape[0] > 0:
                n, s = rewire_targets.shape
                e_real = torch.clamp(ctx["row_ptr"][-1], min=1)
                cap = min(cfg.rewire_compact_cap, n)
                if cap == 0:
                    jrows = torch.arange(n, dtype=torch.int64, device=alive.device)
                else:
                    jrows, jlive = first_rows(fresh, cap)
                draws = col_idx[prng.randint(k_rw, (jrows.shape[0], s), 0, e_real).to(torch.int64)]
                ok = ctx["exists"][draws.to(torch.int64)] & (draws.to(torch.int64) != jrows[:, None])
                draws = torch.where(ok, draws, -1)
                released = (fresh & rewired)[:, None] & (rewire_targets >= 0)
                degree_credit = _add_at(degree_credit, rewire_targets, released, -1)
                if cap == 0:
                    degree_credit = _add_at(degree_credit, draws, fresh[:, None] & (draws >= 0), 1)
                    rewire_targets = torch.where(fresh[:, None], draws, rewire_targets)
                    rewired = rewired | fresh
                else:
                    degree_credit = _add_at(degree_credit, draws, jlive[:, None] & (draws >= 0), 1)
                    sel = torch.where(jlive, jrows, n)
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


def not_ported(what: str, where: str) -> NotImplementedError:
    """The error a part of a later slice raises."""
    return NotImplementedError(f"{what} is not ported yet: it comes with the {where} slice")


def has_churn(cfg) -> bool:
    """Whether the config's rounds run the churn stage."""
    return cfg.churn_leave_prob > 0.0 or cfg.churn_join_prob > 0.0


def build_round_stages(cfg, *, tail: str = "fused", has_faults: bool = False,
                       churn_faults: bool = False) -> tuple[Stage, ...]:
    """The post-dissemination stages of one config: liveness (reading the
    round's faults under a scenario), churn (when the config churns or the
    scenario has a churn burst, then in its burst form), then the tail."""
    burst = has_faults and churn_faults
    churn = (_churn_stage(cfg, burst),) if has_churn(cfg) or burst else ()
    return (_liveness_stage(cfg, has_faults), *churn, _tail_stage(cfg, tail))


def check_later(later: dict) -> None:
    """Refuse the arguments of later slices (given and not None) and any
    unknown argument."""
    for name, where in (("growth", "growth"), ("stream", "traffic"),
                        ("control", "control"), ("pipeline", "multi-device"),
                        ("liveness", "composed-planes (ROADMAP item 9: the quorum detector, with the "
                                     "churn stage's quarantined rejoin)"),
                        ("inject", "serving")):
        if later.pop(name, None) is not None:
            raise not_ported(f"the {name} argument", where)
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
    return (int(state.round) if host_round is None else int(host_round)) + 1


def run_protocol_round(state, cfg, disseminate: Callable, *, tail: str = "fused", scenario=None,
                       host_round: int | None = None, **later):
    """One whole protocol round, engine-agnostic.

    ``disseminate(tx, transmitter, receptive, k_push, k_pull) -> (incoming,
    msgs_sent)`` is the engine's delivery core. The driver splits the
    state's key five ways (next key, push, pull, leave, join: the last two
    drive the churn stage), computes the role masks, delivers, and runs
    the stages through
    ``sim.engine.advance_round``. Returns ``(new_state, RoundStats)``.

    ``scenario`` (a :class:`~tpu_gossip_torch.faults.CompiledScenario`)
    wraps the delivery in the round's faults; its draws come from their own
    stream, so a quiescent scenario changes no bit. ``host_round`` is
    ``state.round`` when the caller knows it on the host (the horizon
    loops do), sparing a device read a round.
    """
    from tpu_gossip_torch.sim import engine as _engine

    check_later(later)
    _engine.validate_rewire_width(state, cfg)
    rnd = state.round + 1
    key, k_push, k_pull, k_leave, k_join = prng.split(state.rng, 5)
    _, transmitter, receptive = _engine.compute_roles(state)
    transmit = _engine.transmit_bitmap(state, cfg, transmitter)
    if scenario is None:
        incoming, msgs_sent = disseminate(transmit, transmitter, receptive, k_push, k_pull)
        tx_eff, held, telem, rf = transmit, None, None, None
    else:
        from tpu_gossip_torch.faults.inject import scenario_dissemination

        incoming, msgs_sent, tx_eff, held, telem, rf = scenario_dissemination(
            scenario, state, fault_round(state, host_round), transmit, transmitter, receptive,
            k_push, k_pull, disseminate)
    return _engine.advance_round(
        state, cfg, incoming, msgs_sent, tx_eff, rnd, key, k_leave, k_join, receptive, tail=tail,
        faults=rf, churn_faults=scenario is not None and scenario.has_churn, fault_held=held, fstats=telem,
    )
