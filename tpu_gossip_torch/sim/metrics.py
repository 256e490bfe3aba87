"""Per-round metrics and the run-to-coverage benchmark.

Ports ``BenchResult``, ``rounds_to_coverage``, ``bench_swarm``,
``stats_rows``, ``write_jsonl``, ``recoverage_rounds``, ``phase_report``,
``liveness_report``, the streaming plane's host reports
(``stream_episodes``, ``steady_state_report``, ``expected_conflations``,
``bloom_false_positive_rate``) and the controller's ``reliability_report``
of ``tpu_gossip/sim/metrics.py``.
``bench_swarm`` times on the host clock around work that ends in
``torch.cuda.synchronize()`` on a CUDA state.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import IO, Iterable

import numpy as np
import torch

from tpu_gossip_torch.core.state import SwarmConfig, SwarmState
from tpu_gossip_torch.sim.engine import RoundStats, run_until_coverage

__all__ = ["BenchResult", "rounds_to_coverage", "bench_swarm", "stats_rows", "write_jsonl", "recoverage_rounds",
           "phase_report", "liveness_report", "stream_episodes", "steady_state_report", "expected_conflations",
           "bloom_false_positive_rate", "reliability_report"]


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """One run-to-coverage measurement."""

    n_peers: int
    rounds: int
    target: float
    wall_seconds: float
    peers_rounds_per_sec: float
    coverage: float
    ms_per_round: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def rounds_to_coverage(stats: RoundStats, target: float = 0.99) -> int:
    """First round index (1-based) at which coverage >= target; -1 if never."""
    cov = stats.coverage.detach().cpu().numpy()
    hit = np.nonzero(cov >= np.float32(target))[0]
    return int(hit[0]) + 1 if hit.size else -1


def _sync(state: SwarmState) -> None:
    if state.seen.device.type == "cuda":
        torch.cuda.synchronize(state.seen.device)


def bench_swarm(state: SwarmState, cfg: SwarmConfig, target: float = 0.99,
                max_rounds: int = 1000, *, warmup: bool = True, reps: int = 1,
                plan=None, run=None, n_peers: int | None = None, tail: str = "fused"):
    """Time ``run_until_coverage`` (best of ``reps``, after one warm-up run
    that builds the kernels); returns ``(best BenchResult, final state)``.
    Rounds are functional, so every repetition starts from ``state``.
    ``run(state) -> final state`` swaps in another runner (a packed run)
    under the same timing; it closes over its own plan."""
    if run is not None and plan is not None:
        raise ValueError("bench_swarm: pass plan= only with the default runner; a custom run= "
                         "closes over its own plan")
    n = cfg.n_peers if n_peers is None else n_peers
    if run is None:
        def run(st):
            return run_until_coverage(st, cfg, target, max_rounds, plan=plan, tail=tail)

    if warmup:
        run(state)
    best, fin = None, state
    for _ in range(max(reps, 1)):
        _sync(state)
        t0 = time.perf_counter()
        fin = run(state)
        coverage = float(fin.coverage(0))
        _sync(fin)
        dt = time.perf_counter() - t0
        rounds = int(fin.round - state.round)
        res = BenchResult(
            n_peers=n, rounds=rounds, target=target, wall_seconds=dt,
            peers_rounds_per_sec=n * rounds / max(dt, 1e-9), coverage=coverage,
            ms_per_round=dt / max(rounds, 1) * 1000.0,
        )
        if best is None or res.wall_seconds < best.wall_seconds:
            best = res
    return best, fin


def stats_rows(stats: RoundStats) -> Iterable[dict]:
    """Stacked RoundStats -> one dict per round."""
    arrays = {k: v.detach().cpu().numpy() for k, v in stats._asdict().items()}
    for r in range(len(arrays["coverage"])):
        row = {"round": r + 1}
        for k, v in arrays.items():
            val = v[r]
            row[k] = val.item() if val.ndim == 0 else val.tolist()
        yield row


def write_jsonl(stats: RoundStats, sink: IO[str]) -> None:
    """One JSON object per round."""
    for row in stats_rows(stats):
        sink.write(json.dumps(row) + "\n")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def recoverage_rounds(stats: RoundStats, after_round: int, target: float = 0.99) -> int:
    """Rounds needed to regain ``target`` coverage after round
    ``after_round`` (1-based: a partition's heal round); -1 if the horizon
    never recovers."""
    cov = _host(stats.coverage)[after_round:]
    hit = np.nonzero(cov >= target)[0]
    return int(hit[0]) + 1 if hit.size else -1


def phase_report(stats: RoundStats, spec, *, heal_target: float = 0.99) -> list[dict]:
    """Per-phase fault telemetry of a fixed-horizon run under a scenario
    (``spec``, the ``ScenarioSpec`` it was compiled from): the realised
    delivery-loss rate (dropped / (dropped + delivered)), the held buffer's
    peak, the new dead declarations and the rounds from phase start to the
    first, the coverage at the phase's end, and for a partition the rounds
    to regain ``heal_target`` of the run's peak coverage after the heal.
    ``n_declared_dead`` is not monotone (a rejoin clears a verdict), so
    detection counts the phase's peak over its starting value."""
    cov = _host(stats.coverage)
    dropped = _host(stats.msgs_dropped)
    held = _host(stats.msgs_held)
    delivered = _host(stats.msgs_delivered)
    dead = _host(stats.n_declared_dead)
    horizon = len(cov)
    ceiling = float(cov.max()) if horizon else 0.0
    rows: list[dict] = []
    for p in spec.phases:
        lo, hi = p.start, min(p.end, horizon)
        if lo >= horizon:
            continue
        d = int(dropped[lo:hi].sum())
        dv = int(delivered[lo:hi].sum())
        dead_before = int(dead[lo - 1]) if lo > 0 else 0
        newly_dead = np.nonzero(dead[lo:hi] > dead_before)[0]
        detection_new = max(int(dead[lo:hi].max()) - dead_before, 0)
        row = {
            "phase": p.name,
            "rounds": [lo + 1, hi],
            "msgs_dropped": d,
            "delivery_loss_rate": d / max(d + dv, 1),
            "msgs_held_max": int(held[lo:hi].max()) if hi > lo else 0,
            "detection_new": detection_new,
            "detection_latency_rounds": (int(newly_dead[0]) + 1 if detection_new > 0 and newly_dead.size else -1),
            "coverage_end": float(cov[hi - 1]),
        }
        if p.partition is not None:
            row["recoverage_rounds_after_heal"] = recoverage_rounds(stats, hi, heal_target * ceiling)
        rows.append(row)
    return rows


def liveness_report(stats: RoundStats) -> dict:
    """The quorum detector's summary over a run (the CLI's ``liveness``
    block): evictions and false ones (a victim responsive when declared),
    ``eviction_precision`` (1 - false/total), ``eviction_recall`` (true
    declarations over those plus the dead still undeclared at the end),
    the quarantined rows at the end, the undeclared dead at the end, the
    rounds with any dead member undeclared (``forgery_stall_rounds``), and
    the accusations and forged heartbeats emitted. Host-side."""
    evictions = int(_host(stats.evictions_new).astype(np.int64).sum())
    false_ev = int(_host(stats.false_evictions).astype(np.int64).sum())
    true_ev = evictions - false_ev
    undeclared = _host(stats.dead_undeclared)
    undeclared_final = int(undeclared[-1]) if undeclared.size else 0
    quarantined = _host(stats.n_quarantined)
    return {
        "evictions": evictions,
        "false_evictions": false_ev,
        "eviction_precision": round(true_ev / evictions, 4) if evictions else None,
        "eviction_recall": (round(true_ev / (true_ev + undeclared_final), 4)
                            if true_ev + undeclared_final else None),
        "quarantined": int(quarantined[-1]) if quarantined.size else 0,
        "dead_undeclared_final": undeclared_final,
        "forgery_stall_rounds": int((undeclared > 0).sum()),
        "accusations": int(_host(stats.adv_accusations).astype(np.int64).sum()),
        "forged_heartbeats": int(_host(stats.adv_forged).astype(np.int64).sum()),
    }


def stream_episodes(stats, target: float = 0.99) -> list[dict]:
    """Per-message lease episodes of a streaming run, from the per-slot
    tracks (``slot_age``, ``slot_infected``): an episode starts where a
    slot's age reads 0 and ends where the age resets or reads -1; its
    message completes at the first round its live coverage reaches
    ``target`` of that round's alive count, and the age there is its
    rounds-to-coverage. Episodes open at the horizon are censored
    (``end_round`` -1). Rows: ``slot``, ``start_round`` (1-based),
    ``end_round``, ``completed_age`` (-1 never), ``peak_coverage``."""
    age = _host(stats.slot_age)
    infected = _host(stats.slot_infected)
    alive = np.maximum(_host(stats.n_alive), 1)
    horizon, m = age.shape
    cov = infected / alive[:, None]
    episodes: list[dict] = []
    for s in range(m):
        start = None
        for r in range(horizon):
            a = age[r, s]
            if a == 0 and start is not None:
                episodes.append(_close_episode(s, start, r, cov, age, target))
                start = r
            elif a == 0:
                start = r
            elif a < 0 and start is not None:
                episodes.append(_close_episode(s, start, r, cov, age, target))
                start = None
        if start is not None:
            ep = _close_episode(s, start, horizon, cov, age, target)
            ep["end_round"] = -1  # censored: the horizon cut it, not the TTL
            episodes.append(ep)
    return episodes


def _close_episode(s, start, end, cov, age, target):
    span = cov[start:end, s]
    hit = np.nonzero(span >= target)[0]
    return {
        "slot": s,
        "start_round": start + 1,
        "end_round": end,
        "completed_age": int(age[start + hit[0], s]) if hit.size else -1,
        "peak_coverage": float(span.max()) if span.size else 0.0,
    }


def steady_state_report(stats, *, target: float = 0.99, round_seconds: float = 5.0, warmup_rounds: int = 0) -> dict:
    """A streaming run's steady-state summary: delivered messages a round
    and a second, p50/p99 rounds-to-coverage per message, the conflation
    (or Bloom suppression) rate and the delivered-to-closed ratio, over
    the rounds after ``warmup_rounds`` (episodes injected inside the
    warmup are skipped)."""
    horizon = len(_host(stats.coverage))
    w = min(max(warmup_rounds, 0), horizon)
    rounds = max(horizon - w, 1)
    counters = {f: int(_host(getattr(stats, f"stream_{f}"))[w:].sum())
                for f in ("offered", "injected", "conflated", "expired")}
    eps = [e for e in stream_episodes(stats, target) if e["start_round"] > w]
    done = [e["completed_age"] for e in eps if e["completed_age"] >= 0]
    ended = [e for e in eps if e["end_round"] >= 0]
    done_ended = sum(1 for e in ended if e["completed_age"] >= 0)
    lat = np.asarray(done, dtype=np.float64)
    return {
        "rounds_measured": rounds,
        "warmup_rounds": w,
        **{f"msgs_{k}": v for k, v in counters.items()},
        "offered_per_round": round(counters["offered"] / rounds, 3),
        "injected_per_round": round(counters["injected"] / rounds, 3),
        "conflation_rate": round(counters["conflated"] / max(counters["offered"], 1), 4),
        "episodes": len(eps),
        "episodes_completed": len(done),
        "episodes_expired_uncovered": len(ended) - done_ended,
        "delivered_per_round": round(len(done) / rounds, 3),
        "delivered_msgs_per_sec": round(len(done) / (rounds * round_seconds), 4),
        # censored (still-open) episodes judge neither way
        "delivery_ratio": round(done_ended / max(len(ended), 1), 4),
        "rounds_to_coverage": {
            "p50": float(np.percentile(lat, 50)) if lat.size else None,
            "p99": float(np.percentile(lat, 99)) if lat.size else None,
            "mean": round(float(lat.mean()), 3) if lat.size else None,
        },
    }


def expected_conflations(n_rumors: int, msg_slots: int) -> float:
    """Expected rumors sharing a slot with an earlier one under k = 1 slot
    dedup: ``R - M (1 - (1 - 1/M)^R)``."""
    if n_rumors <= 0:
        return 0.0
    m = float(msg_slots)
    return n_rumors - m * (1.0 - (1.0 - 1.0 / m) ** n_rumors)


def bloom_false_positive_rate(n_rumors: int, msg_slots: int, hashes: int) -> float:
    """P(a novel rumor reads as seen) under k-hash Bloom dedup:
    ``(1 - (1 - 1/M)^(kR))^k``."""
    if n_rumors <= 0:
        return 0.0
    m = float(msg_slots)
    fill = 1.0 - (1.0 - 1.0 / m) ** (hashes * n_rumors)
    return fill ** hashes


def reliability_report(stats, *, target_ratio: float, coverage_target: float = 0.99,
                       round_seconds: float = 5.0) -> dict:
    """The reliability contract of one run at the declared delivery-ratio
    ``target_ratio`` (the CLI's ``reliability`` block under ``--control``):
    whether the run held it (``holds``), the messages paid per delivered
    infection and the p50/p99 rounds to ``coverage_target``.

    A streaming run (its per-slot tracks carry data) judges per message:
    each lease episode that closed inside the horizon covered or expired
    uncovered, and the delivery ratio is the covered share (no closed
    episode: ``delivery_ratio`` None and a vacuous ``holds``; read
    ``messages_judged``). A single-epidemic run judges its one message:
    delivered iff the coverage reached ``coverage_target``. Host-side."""
    cov = _host(stats.coverage)
    msgs = int(_host(stats.msgs_sent).astype(np.int64).sum())
    slot_inf = _host(stats.slot_infected)
    if _host(stats.stream_offered).astype(np.int64).sum() > 0 or slot_inf.any():
        # every new (peer, slot) infection: the positive increments of the
        # live-holder track (re-infections after churn or expiry count)
        d = np.diff(slot_inf.astype(np.int64), axis=0, prepend=np.zeros((1, slot_inf.shape[1]), np.int64))
        infections = int(np.clip(d, 0, None).sum())
        eps = stream_episodes(stats, coverage_target)
        done = [e["completed_age"] for e in eps if e["completed_age"] >= 0]
        ended = [e for e in eps if e["end_round"] >= 0]
        done_ended = sum(1 for e in ended if e["completed_age"] >= 0)
        delivery_ratio = done_ended / len(ended) if ended else None
        lat = np.asarray(done, dtype=np.float64)
        p50 = float(np.percentile(lat, 50)) if lat.size else None
        p99 = float(np.percentile(lat, 99)) if lat.size else None
        judged = len(ended)
    else:
        d = np.diff(_host(stats.n_infected).astype(np.int64), prepend=np.int64(0))
        infections = int(np.clip(d, 0, None).sum())
        rtc = rounds_to_coverage(stats, coverage_target)
        delivery_ratio = 1.0 if rtc > 0 else 0.0
        p50 = p99 = float(rtc) if rtc > 0 else None
        judged = 1
    return {
        "target_ratio": float(target_ratio),
        "coverage_target": float(coverage_target),
        "delivery_ratio": None if delivery_ratio is None else round(delivery_ratio, 4),
        "holds": bool(delivery_ratio is None or delivery_ratio >= target_ratio),
        "messages_judged": judged,
        "msgs_total": msgs,
        "infections_delivered": infections,
        "msgs_per_delivered_infection": round(msgs / max(infections, 1), 3),
        "rounds_to_coverage": {"p50": p50, "p99": p99},
        "seconds_to_coverage_p99": None if p99 is None else round(p99 * round_seconds, 1),
        "peak_coverage": float(cov.max()) if cov.size else 0.0,
    }
