"""The bucketed sharded engine against the local engine at 1M, end to end.

Ports ``experiments/dist_profile.py``: a Chung-Lu power-law graph built on
the host, partitioned over a mesh of one shard per card (one on one card),
run to 99% coverage three ways, each the best of three runs from a clone
of the same seeded state: the sharded engine with the scatter receive,
with the streaming receive (K6), and the local XLA engine on the same
relabelled swarm.

    python -m tpu_gossip_torch.experiments.dist_profile
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_gossip_torch import dist
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.state import SwarmConfig, clone_state
from tpu_gossip_torch.core.topology import build_csr, configuration_model, powerlaw_degree_sequence
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.sim.engine import run_until_coverage

N = 1_000_000


def timed(run, state, reps: int = 3):
    """(best wall seconds, rounds, coverage) of ``run`` over clones of ``state``."""
    fin = run(clone_state(state))
    cov, rounds = float(fin.coverage(0)), int(fin.round)
    best = float("inf")
    for _ in range(reps):
        rep_state = clone_state(state)
        t0 = time.perf_counter()
        fin = run(rep_state)
        float(fin.coverage(0))
        best = min(best, time.perf_counter() - t0)
    return best, rounds, cov


def main(n: int = N, device: str | torch.device = "cuda", reps: int = 3) -> dict:
    """Print the three runs' ms a round and the overheads; returns them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    graph = build_csr(n, configuration_model(powerlaw_degree_sequence(n, gamma=2.5, rng=rng), rng=rng))
    print("host graph built", flush=True)
    mesh = dist.make_mesh(device=dev)
    sg, relabeled, position = dist.partition_graph(graph, mesh.size, seed=0, device=dev)
    plans = dist.build_shard_plans(sg)
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=16, fanout=1, mode="push_pull")
    st0 = dist.init_sharded_swarm(sg, relabeled, position, cfg, key=prng.key(0, dev), origins=[0], device=dev)
    st = dist.shard_swarm(st0, mesh)
    print(f"devices={mesh.size} bucket={sg.bucket} per={sg.per_shard}", flush=True)

    w, r, c = timed(lambda s: dist.run_until_coverage_dist(s, cfg, sg, mesh, 0.99, 300), st, reps)
    print(f"dist scatter: {w/r*1e3:.1f} ms/round ({r} rounds, cov {c:.4f})", flush=True)
    w2, r2, c2 = timed(lambda s: dist.run_until_coverage_dist(s, cfg, sg, mesh, 0.99, 300, shard_plan=plans), st,
                       reps)
    print(f"dist pallas:  {w2/r2*1e3:.1f} ms/round ({r2} rounds, cov {c2:.4f})", flush=True)
    w3, r3, c3 = timed(lambda s: run_until_coverage(s, cfg, 0.99, 300), st0, reps)
    print(f"local xla:    {w3/r3*1e3:.1f} ms/round ({r3} rounds)", flush=True)
    print(f"overhead_vs_local: scatter {w/r/(w3/r3):.2f}x  pallas {w2/r2/(w3/r3):.2f}x", flush=True)
    return {"scatter": (w, r, c), "pallas": (w2, r2, c2), "local": (w3, r3, c3)}


if __name__ == "__main__":
    main()
