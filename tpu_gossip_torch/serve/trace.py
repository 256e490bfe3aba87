"""The determinism plane of the serving frontend.

Ports ``tpu_gossip/serve/trace.py``; the JSONL format is the JAX
package's byte for byte, so one trace file serves both packages.

Every arrival the frontend accepts is recorded as
``(round, origin, payload_hash)`` — origin is the state row the client
mapped to, payload_hash is :func:`~tpu_gossip_torch.serve.protocol.payload_hash64`
of the gossip line's dedup identity. That triple is the COMPLETE cause
of the arrival's effect on device state: the injection stage
(traffic/ingest.py) derives the slot draw from the hash via
``message_slots`` and everything downstream is deterministic integer
work. So a recorded trace replayed through the pure-sim injection path
reproduces the live run's state digest and integer-stat trajectory bit
for bit — the project's bit-identity discipline extended across the
socket boundary.

Overflow counts are part of the trace too: the live run bills deferred
arrivals into ``ingest_overflow`` the round they arrived, and replay
must reproduce that stat exactly, so each round record carries the
overflow the frontend reported for its window.
"""

from __future__ import annotations

import json
from typing import Callable, Iterator, NamedTuple, Sequence

import numpy as np

from tpu_gossip_torch.traffic.ingest import IngestPlan, InjectBatch, make_batch

__all__ = ["RoundRecord", "ServeTrace", "TraceRecorder", "replay_trace", "scripted_windows", "scripted_trace"]


class RoundRecord(NamedTuple):
    """One round window: the arrivals injected and the overflow billed."""

    rnd: int
    origins: tuple  # (j,) state rows, j <= plan.max_inject
    hashes: tuple  # (j,) payload_hash64 values, parallel to origins
    overflow: int  # arrivals deferred past this window (carried, counted)


class ServeTrace(NamedTuple):
    """A recorded live run: the plan that shaped it plus its windows."""

    plan: IngestPlan
    rounds: tuple  # tuple[RoundRecord, ...], rnd strictly increasing

    def batches(self, device="cuda") -> Iterator[InjectBatch]:
        """The per-round InjectBatch sequence on ``device`` — the replay
        input."""
        for rec in self.rounds:
            yield make_batch(
                self.plan,
                list(rec.origins),
                list(rec.hashes),
                overflow=rec.overflow,
                device=device,
            )

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def total_arrivals(self) -> int:
        return sum(len(rec.origins) for rec in self.rounds)

    def save(self, path) -> None:
        """JSONL: one header line, then one line per round window."""
        with open(path, "w") as fh:
            fh.write(json.dumps({
                "format": "tpu-gossip-serve-trace-v1",
                "msg_slots": self.plan.msg_slots,
                "max_inject": self.plan.max_inject,
                "k_hashes": self.plan.k_hashes,
                "rounds": len(self.rounds),
            }) + "\n")
            for rec in self.rounds:
                fh.write(json.dumps({
                    "rnd": rec.rnd,
                    "origins": list(rec.origins),
                    "hashes": list(rec.hashes),
                    "overflow": rec.overflow,
                }) + "\n")

    @staticmethod
    def load(path) -> "ServeTrace":
        with open(path) as fh:
            header = json.loads(fh.readline())
            if header.get("format") != "tpu-gossip-serve-trace-v1":
                raise ValueError(f"not a serve trace: {path}")
            plan = IngestPlan(
                msg_slots=header["msg_slots"],
                max_inject=header["max_inject"],
                k_hashes=header["k_hashes"],
            )
            rounds = []
            for line in fh:
                if not line.strip():
                    continue
                d = json.loads(line)
                rounds.append(RoundRecord(
                    rnd=d["rnd"],
                    origins=tuple(d["origins"]),
                    hashes=tuple(d["hashes"]),
                    overflow=d["overflow"],
                ))
        trace = ServeTrace(plan=plan, rounds=tuple(rounds))
        if len(trace.rounds) != header["rounds"]:
            raise ValueError(
                f"truncated trace: header says {header['rounds']} rounds, "
                f"file has {len(trace.rounds)}"
            )
        return trace


class TraceRecorder:
    """Accumulates round windows as the live driver injects them."""

    def __init__(self, plan: IngestPlan):
        self.plan = plan
        self._rounds: list[RoundRecord] = []

    def record_round(
        self,
        rnd: int,
        arrivals: Sequence,  # [(origin_row, payload_hash), ...]
        overflow: int,
    ) -> None:
        if len(arrivals) > self.plan.max_inject:
            raise ValueError(
                f"window of {len(arrivals)} exceeds max_inject="
                f"{self.plan.max_inject}; the frontend must defer, not drop"
            )
        self._rounds.append(RoundRecord(
            rnd=int(rnd),
            origins=tuple(int(o) for o, _ in arrivals),
            hashes=tuple(int(h) for _, h in arrivals),
            overflow=int(overflow),
        ))

    @property
    def num_rounds(self) -> int:
        return len(self._rounds)

    def finish(self) -> ServeTrace:
        return ServeTrace(plan=self.plan, rounds=tuple(self._rounds))


def replay_trace(
    trace: ServeTrace,
    step: Callable,  # step(state, batch) -> (state, stats)
    state,
):
    """Drive ``step`` with the trace's batches — the pure-sim replay.

    ``step`` must be built the same way the live driver built its step
    (:func:`tpu_gossip_torch.serve.driver.build_step` with the same
    config) so both runs execute the same round; then state digest and
    integer-stat trajectory are bit-identical by construction. The
    batches are built on the state's device.

    Returns ``(final_state, [stats_0, ..., stats_{R-1}])``.
    """
    stats_trail = []
    for batch in trace.batches(state.seen.device):
        state, stats = step(state, batch)
        stats_trail.append(stats)
    return state, stats_trail


def scripted_windows(seed: int, rounds: int, max_inject: int, n_origins: int) -> list:
    """A served run's round windows made from a seed with numpy, as the
    frontend takes them: a round's arrivals (none every third round, up to
    twice ``max_inject`` otherwise) join a FIFO backlog, a window takes at
    most ``max_inject`` of it and bills the rest as overflow. Each arrival
    is ``(index into the origin table, 64-bit payload hash)``; a window is
    ``[arrivals, overflow]``."""
    rng = np.random.default_rng(seed)
    backlog, out = [], []
    for r in range(rounds):
        k = 0 if r % 3 == 2 else int(rng.integers(0, 2 * max_inject + 1))
        idx = rng.integers(0, n_origins, size=k)
        hashes = rng.integers(0, 2**63, size=k, dtype=np.int64) * 2 + rng.integers(0, 2, size=k)
        backlog += [(int(i), int(h)) for i, h in zip(idx, hashes)]
        window, backlog = backlog[:max_inject], backlog[max_inject:]
        out.append([window, len(backlog)])
    return out


def scripted_trace(plan: IngestPlan, origin_rows, rounds: int, seed: int) -> ServeTrace:
    """:func:`scripted_windows` as a trace: the origins through the
    ``origin_rows`` table (the rows clients map onto)."""
    rec = TraceRecorder(plan)
    for r, (window, overflow) in enumerate(scripted_windows(seed, rounds, plan.max_inject, len(origin_rows))):
        rec.record_round(r, [(int(origin_rows[i]), h) for i, h in window], overflow)
    return rec.finish()
