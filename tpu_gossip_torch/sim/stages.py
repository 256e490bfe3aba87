"""The round as declared stages: the shared driver of every engine.

Ports ``Stage``, ``StageView``, ``run_stages``, ``_liveness_stage`` (the
direct detector), ``_tail_stage``, ``build_round_stages`` (:673) and
``run_protocol_round`` (:739) of ``tpu_gossip/sim/stages.py``. Each stage
names the carries it reads and writes and :func:`run_stages` enforces the
declarations. :func:`run_protocol_round` does the 5-way key split, the
role masks, the engine's dissemination and the post-delivery stages.

Scenarios, growth, streams, control, pipelining, the quorum detector,
churn and live ingestion are later slices; their arguments raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

from tpu_gossip_torch.core import prng

__all__ = ["Stage", "StageView", "run_stages", "build_round_stages", "run_protocol_round", "not_ported",
           "check_later"]


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


def build_round_stages(cfg, *, tail: str = "fused") -> tuple[Stage, ...]:
    """The post-dissemination stages of one config: liveness, then the tail."""
    if cfg.churn_leave_prob > 0.0 or cfg.churn_join_prob > 0.0:
        raise not_ported("churn (churn_leave_prob/churn_join_prob)", "churn and re-wiring")
    return (_liveness_stage(cfg), _tail_stage(cfg, tail))


def check_later(later: dict) -> None:
    """Refuse the arguments of later slices (given and not None) and any
    unknown argument."""
    for name, where in (("scenario", "faults"), ("growth", "growth"), ("stream", "traffic"),
                        ("control", "control"), ("pipeline", "multi-device"),
                        ("liveness", "composed-planes (quorum detector)"),
                        ("inject", "serving")):
        if later.pop(name, None) is not None:
            raise not_ported(f"the {name} argument", where)
    if later:
        raise TypeError(f"unexpected arguments {sorted(later)}")


def run_protocol_round(state, cfg, disseminate: Callable, *, tail: str = "fused", **later):
    """One whole protocol round, engine-agnostic.

    ``disseminate(tx, transmitter, receptive, k_push, k_pull) -> (incoming,
    msgs_sent)`` is the engine's delivery core. The driver splits the
    state's key five ways (next key, push, pull, leave, join), computes the
    role masks, delivers, and runs the stages through
    ``sim.engine.advance_round``. Returns ``(new_state, RoundStats)``.
    """
    from tpu_gossip_torch.sim import engine as _engine

    check_later(later)
    _engine.validate_rewire_width(state, cfg)
    rnd = state.round + 1
    # the leave/join children drive churn, a later slice; the split stays 5-way
    key, k_push, k_pull, _k_leave, _k_join = prng.split(state.rng, 5)
    _, transmitter, receptive = _engine.compute_roles(state)
    transmit = _engine.transmit_bitmap(state, cfg, transmitter)
    incoming, msgs_sent = disseminate(transmit, transmitter, receptive, k_push, k_pull)
    return _engine.advance_round(
        state, cfg, incoming, msgs_sent, transmit, rnd, key, receptive, tail=tail,
    )
