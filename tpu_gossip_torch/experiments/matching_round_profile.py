"""Slope-timed stage decomposition of the 1M matching round.

Ports ``experiments/matching_round_profile.py``: the matching pipeline's
micro-stages (expand, partner, reduce: K1 and K2 on the card), then
``profile_round_stages`` with the three tails (``reference``, and K3 as
``fused`` and ``pallas``) on a state advanced 6 rounds.

    python -m tpu_gossip_torch.experiments.matching_round_profile [n]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.sim.engine import simulate
from tpu_gossip_torch.utils.profiling import format_stage_table, profile_round_stages, slope_time


def main(n: int = 1_000_000, device: str | torch.device = "cuda", loop_lengths: tuple[int, int] = (8, 88),
         reps: int = 3) -> dict:
    """Print the micro-stage lines and the stage table; returns the stages."""
    dev = resolve_device(device)
    g, plan = matching_powerlaw_graph(n, gamma=2.5, fanout=1, key=prng.key(0, dev), device=dev)
    cfg = SwarmConfig(n_peers=n + 1, msg_slots=16, mode="push_pull", fanout=1)
    state = init_swarm(g.as_padded_graph(), cfg, key=prng.key(0, dev), origins=np.arange(16),
                       origin_slots=np.arange(16), exists=g.exists, device=dev)
    state, _ = simulate(state, cfg, 6, plan)  # mid-epidemic state for realistic density

    def t_expand(i, c):
        return c ^ plan.expand(torch.full((n,), i, dtype=torch.int32, device=dev)).sum(dtype=torch.int32)

    def t_partner(i, c):
        return c ^ plan.partner(torch.full((plan.rows, 128), i, dtype=torch.int32, device=dev)).sum(
            dtype=torch.int32)

    def t_reduce(i, c):
        return c ^ plan.reduce(torch.full((plan.rows, 128), i, dtype=torch.int32, device=dev), "or").sum(
            dtype=torch.int32)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for name, body in [("expand (n->slots)", t_expand), ("partner pipeline", t_partner),
                       ("reduce (slots->n)", t_reduce)]:
        dt = slope_time(body, zero, *loop_lengths, reps)
        print(f"{name:24s} {dt*1e3:7.2f} ms", flush=True)

    stages = profile_round_stages(state, cfg, plan, reps=reps, tails=("reference", "fused", "pallas"), device=dev)
    print(format_stage_table(stages), flush=True)
    return stages


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
