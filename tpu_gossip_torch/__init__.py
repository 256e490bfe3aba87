"""tpu_gossip_torch: the PyTorch/CUDA port of tpu_gossip for NVIDIA Hopper.

The port runs the local engine on the card over the matching graph (the
headline, ``run_sim --graph matching --mode push_pull --fanout 1``) and
over the CSR graphs (``--graph pa|chung-lu``, and the power-law graph
built on the device), delivered by the exactly-k XLA path or, with
``--staircase``, the staircase segment kernel, on the full-width state or
on the packed state (``pack_state``; the round then computes on the bit
words). The TPU kernels of those paths are written by hand in CUDA
(``csrc/``): the 128-lane row shuffle (K1), the plane fold (K2), the round
tail (K3), the packed word tail (K4) and the staircase segment OR (K5). It
is held bit for bit against the JAX package through
``state_digest``/``stats_digest``. It imports neither JAX nor the JAX
package.

Entry points take ``device`` and default to ``"cuda"``; pass
``device="cpu"`` to run every kernel's plain PyTorch version.
"""

from tpu_gossip_torch.core.device_topology import DeviceGraph, device_powerlaw_graph
from tpu_gossip_torch.core.matching_topology import MatchingPlan, matching_powerlaw_graph
from tpu_gossip_torch.core.packed import PackedSwarm, pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig, SwarmState, clone_state, init_swarm
from tpu_gossip_torch.kernels.pallas_segment import StaircasePlan, build_staircase_plan, build_staircase_plan_device
from tpu_gossip_torch.sim.engine import RoundStats, gossip_round, run_until_coverage, simulate

__all__ = [
    "DeviceGraph",
    "MatchingPlan",
    "PackedSwarm",
    "RoundStats",
    "StaircasePlan",
    "SwarmConfig",
    "SwarmState",
    "build_staircase_plan",
    "build_staircase_plan_device",
    "clone_state",
    "device_powerlaw_graph",
    "gossip_round",
    "init_swarm",
    "matching_powerlaw_graph",
    "pack_state",
    "run_until_coverage",
    "simulate",
    "unpack_state",
]
