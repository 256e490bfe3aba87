"""tpu_gossip_torch: the PyTorch/CUDA port of tpu_gossip for NVIDIA Hopper.

The port runs the local engine on the card over the matching graph (the
headline, ``run_sim --graph matching --mode push_pull --fanout 1``) and
over the CSR graphs (``--graph pa|chung-lu``, and the power-law graph
built on the device), delivered by the exactly-k XLA path or, with
``--staircase``, the staircase segment kernel, on the full-width state or
on the packed state (``pack_state``; the round then computes on the bit
words). ``tpu_gossip_torch.dist`` runs the CSR graphs on the bucketed
sharded engine over a mesh of shards on one card (``run_sim --shard``).
The TPU kernels of those paths are written by hand in CUDA (``csrc/``):
the 128-lane row shuffle (K1), the plane fold (K2), the round tail (K3),
the packed word tail (K4), the staircase segment OR (K5) and its
streaming form, the sharded engine's receive (K6). It
is held bit for bit against the JAX package through
``state_digest``/``stats_digest``. ``tpu_gossip_torch.ckpt`` writes and
reads the JAX package's durable checkpoints (``run_sim
--checkpoint-every``, ``run_sim resume``), so a run either package
checkpointed, the other finishes. ``tpu_gossip_torch.faults`` runs the
JAX package's fault scenarios (loss, delay, partitions, blackouts, churn
bursts; ``run_sim --scenario``) and silent peers (``--silent-frac``) on
every engine above, and ``kernels.liveness.compile_quorum`` its quorum
failure detector (``liveness=``, ``run_sim --quorum-k``), under which a
scenario's Byzantine accusers, forgers and flooders act;
``tpu_gossip_torch.growth`` grows a swarm while it gossips (``--grow``),
``tpu_gossip_torch.traffic`` runs sustained message streams
(``--stream``) and ``tpu_gossip_torch.control`` the adaptive fanout and
push/push-pull controller with its PeerSwap refresh (``control=``,
``run_sim --control``); ``sim.stages.compile_pipeline`` pipelines the
rounds (``pipeline=``, ``run_sim --shard --pipeline 1``) and
``tpu_gossip_torch.fleet`` runs Monte Carlo certification campaigns of
seeded lanes (``run_sim fleet``). It imports neither JAX nor the JAX
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
