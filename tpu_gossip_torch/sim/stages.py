"""The round as declared stages: the shared driver of every engine.

Ports ``Stage``, ``StageView``, ``run_stages``, ``_liveness_stage`` (the
direct detector), ``_churn_stage`` (:298, Poisson churn and the re-wiring
draws), ``_tail_stage``, ``build_round_stages`` (:673) and
``run_protocol_round`` (:739) of ``tpu_gossip/sim/stages.py``. Each stage
names the carries it reads and writes and :func:`run_stages` enforces the
declarations. :func:`run_protocol_round` does the 5-way key split, the
role masks, the engine's dissemination and the post-delivery stages
(liveness, churn, tail).

Scenarios (with their churn bursts), growth, streams, control,
pipelining, the quorum detector (with its quarantined rejoin) and live
ingestion are later slices; their arguments raise ``NotImplementedError``
here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from tpu_gossip_torch.core import prng

__all__ = ["Stage", "StageView", "run_stages", "build_round_stages", "run_protocol_round", "not_ported",
           "check_later", "first_rows", "has_churn"]


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


def _liveness_stage(cfg) -> Stage:
    """Heartbeat emission + the direct failure detector (row-level)."""
    from tpu_gossip_torch.kernels.liveness import detect_failures, emit_heartbeats

    def fn(ctx):
        last_hb = emit_heartbeats(
            ctx["last_hb"], ctx["alive"], ctx["silent"], ctx["declared_dead"],
            ctx["rnd"], cfg.hb_period_rounds,
        )
        last_hb, declared_dead = detect_failures(
            last_hb, ctx["alive"], ctx["silent"], ctx["declared_dead"], ctx["rnd"],
            cfg.timeout_rounds, cfg.detect_period_rounds,
        )
        return {"last_hb": last_hb, "declared_dead": declared_dead}

    return Stage(
        "liveness", ("silent", "alive", "declared_dead", "last_hb", "rnd"),
        ("last_hb", "declared_dead"), fn,
    )


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


def _churn_stage(cfg) -> Stage:
    """Poisson churn, row-level half (BASELINE config 5), and the
    re-wiring draws: departures, rejoins of vacant member slots with fresh
    row state, and each rejoiner's ``rewire_slots`` degree-preferential
    endpoints (a uniform index below ``row_ptr[-1]`` into the CSR endpoint
    list), dense over every row or compacted to ``rewire_compact_cap``
    joiner rows. The fresh rows' slot planes are reset by the tail
    (``fresh``). Self draws and draws on non-member rows become -1;
    ``degree_credit`` releases an overwritten rejoiner's targets and
    grants the new ones."""
    reads = ("alive", "silent", "exists", "last_hb", "declared_dead", "rewired", "rewire_targets",
             "degree_credit", "row_ptr", "col_idx", "rnd", "k_leave", "k_join")
    writes = ("alive", "silent", "last_hb", "declared_dead", "rewired", "rewire_targets", "degree_credit", "fresh")

    def fn(ctx):
        from tpu_gossip_torch.core.state import saturate_round

        alive, silent, last_hb = ctx["alive"], ctx["silent"], ctx["last_hb"]
        declared_dead, rewired = ctx["declared_dead"], ctx["rewired"]
        rewire_targets, degree_credit = ctx["rewire_targets"], ctx["degree_credit"]
        fresh = None
        if cfg.churn_leave_prob > 0.0:
            alive = alive & ~_below(prng.uniform(ctx["k_leave"], tuple(alive.shape)), cfg.churn_leave_prob)
        if cfg.churn_join_prob > 0.0:
            k_join, k_rw = prng.split(ctx["k_join"])
            fresh = ~alive & ctx["exists"] & _below(prng.uniform(k_join, tuple(alive.shape)), cfg.churn_join_prob)
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


def build_round_stages(cfg, *, tail: str = "fused") -> tuple[Stage, ...]:
    """The post-dissemination stages of one config: liveness, churn (when
    the config churns), then the tail."""
    churn = (_churn_stage(cfg),) if has_churn(cfg) else ()
    return (_liveness_stage(cfg), *churn, _tail_stage(cfg, tail))


def check_later(later: dict) -> None:
    """Refuse the arguments of later slices (given and not None) and any
    unknown argument."""
    for name, where in (("scenario", "faults (ROADMAP item 9, with the churn stage's burst form)"),
                        ("growth", "growth"), ("stream", "traffic"),
                        ("control", "control"), ("pipeline", "multi-device"),
                        ("liveness", "composed-planes (ROADMAP item 9: the quorum detector, with the "
                                     "churn stage's quarantined rejoin)"),
                        ("inject", "serving")):
        if later.pop(name, None) is not None:
            raise not_ported(f"the {name} argument", where)
    if later:
        raise TypeError(f"unexpected arguments {sorted(later)}")


def run_protocol_round(state, cfg, disseminate: Callable, *, tail: str = "fused", **later):
    """One whole protocol round, engine-agnostic.

    ``disseminate(tx, transmitter, receptive, k_push, k_pull) -> (incoming,
    msgs_sent)`` is the engine's delivery core. The driver splits the
    state's key five ways (next key, push, pull, leave, join: the last two
    drive the churn stage), computes the role masks, delivers, and runs
    the stages through
    ``sim.engine.advance_round``. Returns ``(new_state, RoundStats)``.
    """
    from tpu_gossip_torch.sim import engine as _engine

    check_later(later)
    _engine.validate_rewire_width(state, cfg)
    rnd = state.round + 1
    key, k_push, k_pull, k_leave, k_join = prng.split(state.rng, 5)
    _, transmitter, receptive = _engine.compute_roles(state)
    transmit = _engine.transmit_bitmap(state, cfg, transmitter)
    incoming, msgs_sent = disseminate(transmit, transmitter, receptive, k_push, k_pull)
    return _engine.advance_round(
        state, cfg, incoming, msgs_sent, transmit, rnd, key, k_leave, k_join, receptive, tail=tail,
    )
