"""Per-round metrics and the run-to-coverage benchmark.

Ports ``BenchResult``, ``rounds_to_coverage``, ``bench_swarm``,
``stats_rows`` and ``write_jsonl`` of ``tpu_gossip/sim/metrics.py``.
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

__all__ = ["BenchResult", "rounds_to_coverage", "bench_swarm", "stats_rows", "write_jsonl"]


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
