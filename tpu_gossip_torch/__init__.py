"""tpu_gossip_torch: the PyTorch/CUDA port of tpu_gossip for NVIDIA Hopper.

The port runs the headline matching round (``run_sim --graph matching
--mode push_pull --fanout 1``) on the card, with the three TPU kernels of
that path written by hand in CUDA (``csrc/``): the 128-lane row shuffle
(K1), the plane fold (K2) and the round tail (K3). It is held bit for bit
against the JAX package through ``state_digest``/``stats_digest``. It
imports neither JAX nor the JAX package.

Entry points take ``device`` and default to ``"cuda"``; pass
``device="cpu"`` to run every kernel's plain PyTorch version.
"""

from tpu_gossip_torch.core.matching_topology import MatchingPlan, matching_powerlaw_graph
from tpu_gossip_torch.core.state import SwarmConfig, SwarmState, clone_state, init_swarm
from tpu_gossip_torch.sim.engine import RoundStats, gossip_round, run_until_coverage, simulate

__all__ = [
    "MatchingPlan",
    "RoundStats",
    "SwarmConfig",
    "SwarmState",
    "clone_state",
    "gossip_round",
    "init_swarm",
    "matching_powerlaw_graph",
    "run_until_coverage",
    "simulate",
]
