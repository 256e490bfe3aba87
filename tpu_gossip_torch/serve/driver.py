"""The serving round driver: live windows overlapped with the card's rounds.

Ports ``tpu_gossip/serve/driver.py``. JAX overlaps the host with the
device through its asynchronous dispatch: it dispatches round r's jitted
step, then blocks on round r-1's stats. The port overlaps the same way with
CUDA's own means. Each iteration

1. enqueues round r (the round reads nothing back from the card: the step
   carries the state's round and key on the host, and a batch's count is a
   host int);
2. copies round r's stats, packed into one int32 vector, ``non_blocking``
   into pinned host memory and records a ``torch.cuda.Event`` behind the
   copy;
3. only then waits on round r-1's event (``event.synchronize()``, never
   ``torch.cuda.synchronize()``) and absorbs its stats.

The next window's batching, the trace record and the ``QUERY`` snapshot so
ride in the device's shadow, and the snapshot is one round stale, as in
JAX.

One step a run: :func:`build_step` closes over the engine's round (the
local round, packed included, or the sharded matching mesh's with
``mesh=``); replay (``serve/trace.py``) builds its step through the same
function with the same config, which is what makes live and replay
bit-identical: the same round on the same batches.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_gossip_torch.serve.trace import ServeTrace, TraceRecorder
from tpu_gossip_torch.traffic.ingest import IngestPlan, make_batch

__all__ = ["DriverReport", "ServeDriver", "build_step", "stack_round_stats"]


class _Step:
    """``step(state, batch) -> (state, stats)``: one round of the engine
    with the batch landed. The state's round and key are read off the card
    once (at the first call, or when handed a state the step did not
    return) and then carried on the host, as the horizon loops carry them,
    so the scenario tables and the stream's Poisson count are picked on the
    host without a device read a round."""

    def __init__(self, round_fn, planes: dict):
        self._round = round_fn
        self._planes = planes
        self._last = None
        self._cursor = (None, None)

    def __call__(self, state, batch):
        from tpu_gossip_torch.sim.stages import host_cursor, next_host_key

        if state is not self._last:
            self._cursor = host_cursor(state, self._planes)
        r0, hkey = self._cursor
        state, stats = self._round(state, host_round=r0, host_rng=hkey, inject=batch, **self._planes)
        self._cursor = (None if r0 is None else r0 + 1, next_host_key(hkey))
        self._last = state
        return state, stats


def build_step(cfg, plan=None, *, mesh=None, tail: str = "fused", scenario=None, growth=None, stream=None,
               control=None, liveness=None):
    """One ``step(state, batch) -> (state, stats)`` for a run.

    ``mesh=None`` runs the local engine's round (a ``PackedSwarm`` runs the
    packed round: ``gossip_round`` dispatches on the state); a mesh runs
    the sharded matching round on ``plan`` (placed on the mesh)."""
    planes = dict(scenario=scenario, growth=growth, stream=stream, control=control, liveness=liveness)
    if mesh is not None:
        from tpu_gossip_torch.dist.matching_mesh import gossip_round_dist_matching

        def round_fn(state, **kw):
            return gossip_round_dist_matching(state, cfg, plan, mesh, **kw)
    else:
        from tpu_gossip_torch.sim.engine import gossip_round

        def round_fn(state, **kw):
            return gossip_round(state, cfg, plan, tail=tail, **kw)

    return _Step(round_fn, planes)


def stack_round_stats(per_round: list):
    """Host-stacked RoundStats: R per-round values a field -> one (R, ...)
    CPU tensor a field, the shape every metrics report consumes."""
    if not per_round:
        raise ValueError("no rounds recorded")
    cls = type(per_round[0])
    return cls(*[torch.stack([getattr(s, f).cpu() for s in per_round]) for f in cls._fields])


class _Drain:
    """One round's stats on their way to the host: every field as int32
    words (the float32 columns bit-cast) in one device vector, copied
    ``non_blocking`` into pinned memory with an event recorded behind the
    copy; on the CPU, copied at once."""

    def __init__(self, stats):
        self.cls = type(stats)
        fields = [getattr(stats, f) for f in self.cls._fields]
        self.layout = [(tuple(t.shape), t.dtype) for t in fields]
        for t in fields:
            if t.dtype not in (torch.int32, torch.float32):
                raise TypeError(f"a RoundStats column of dtype {t.dtype}: the drain packs int32 and float32")
        words = torch.cat([t.reshape(-1).view(torch.int32) for t in fields])
        self.event = None
        if words.device.type == "cuda":
            self.host = torch.empty(words.shape, dtype=torch.int32, pin_memory=True)
            self.host.copy_(words, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = words.clone()

    def wait(self):
        """The stats as CPU tensors, once the copy has landed."""
        if self.event is not None:
            self.event.synchronize()
        out, at = [], 0
        for shape, dtype in self.layout:
            size = int(np.prod(shape, dtype=np.int64))
            out.append(self.host[at:at + size].clone().view(dtype).reshape(shape))
            at += size
        return self.cls(*out)


class DriverReport(NamedTuple):
    """What a serving run hands back to the CLI."""

    state: object  # final device state
    stats: object  # host-stacked RoundStats, fields shaped (R,)
    trace: ServeTrace
    wall_seconds: float
    rounds: int
    wait_seconds: float  # the host's time blocked on the card's events


class ServeDriver:
    """Run R round windows against a frontend; record the trace."""

    def __init__(self, step, state, frontend, ingest_plan: IngestPlan, *, rounds: int, rounds_per_sec: float = 0.0,
                 coverage_target: float = 0.99):
        if rounds <= 0:
            raise ValueError("serving runs a fixed horizon: rounds >= 1")
        self.step = step
        self.state = state
        self.frontend = frontend
        self.ingest_plan = ingest_plan
        self.rounds = int(rounds)
        self.period = 1.0 / rounds_per_sec if rounds_per_sec > 0 else 0.0
        self.coverage_target = coverage_target
        self.recorder = TraceRecorder(ingest_plan)
        self._snapshot: dict = {"round": -1}
        self._per_round: list = []
        self._wait = 0.0

    def snapshot(self) -> dict:
        """The frontend's QUERY view, replaced whole at each absorb, so a
        reader thread always sees one consistent dict."""
        return self._snapshot

    def _absorb(self, drain: _Drain, rnd: int) -> None:
        t0 = time.monotonic()
        host_stats = drain.wait()
        self._wait += time.monotonic() - t0
        self._per_round.append(host_stats)
        n_alive = max(int(host_stats.n_alive), 1)
        self._snapshot = {
            "round": rnd,
            "coverage": float(host_stats.coverage),
            "n_alive": int(host_stats.n_alive),
            "n_infected": int(host_stats.n_infected),
            "n_declared_dead": int(host_stats.n_declared_dead),
            "infected_frac": float(int(host_stats.n_infected)) / n_alive,
            "ingest_offered": int(host_stats.ingest_offered),
            "ingest_injected": int(host_stats.ingest_injected),
            "ingest_overflow": int(host_stats.ingest_overflow),
            "backlog": self.frontend.backlog(),
        }

    def run(self) -> DriverReport:
        device = self.state.seen.device
        t0 = time.monotonic()
        next_deadline = t0
        in_flight: Optional[tuple] = None  # (rnd, _Drain)
        for r in range(self.rounds):
            window, overflow = self.frontend.take_window()
            batch = make_batch(self.ingest_plan, [o for o, _ in window], [h for _, h in window], overflow=overflow,
                               device=device)
            self.recorder.record_round(r, window, overflow)
            # enqueue round r and its stats' copy, THEN drain round r-1: the
            # host waits on last round's copy while the card runs this one
            self.state, stats = self.step(self.state, batch)
            drain = _Drain(stats)
            if in_flight is not None:
                self._absorb(in_flight[1], in_flight[0])
            in_flight = (r, drain)
            if self.period > 0.0:
                next_deadline += self.period
                delay = next_deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
        self._absorb(in_flight[1], in_flight[0])
        wall = time.monotonic() - t0
        return DriverReport(state=self.state, stats=stack_round_stats(self._per_round),
                            trace=self.recorder.finish(), wall_seconds=wall, rounds=self.rounds,
                            wait_seconds=self._wait)
