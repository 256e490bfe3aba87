"""Sharded execution: the peer axis split over a mesh of shards.

Ports ``tpu_gossip/dist/``: the bucketed engine (``dist/mesh.py``: a graph
partitioned into per-shard buckets, one exchange a round, the receive
through K6 or the scatter OR, churn re-wiring, fault scenarios and the
epoch re-partition after a CSR fold included), the sharded matching engine
(``dist/matching_mesh.py``: the gather-free pipeline with one exchange a
transpose, bit-identical to the local matching round), the dense, sparse
and auto transports with their analytic ICI counters
(``dist/transport.py``) and the distributed matching builder
(``dist/builder.py``). The mesh (``cluster/topology.py``) is S shards
folded into (hosts, devices) rows: all S stacked in one process, or one
host row a process under ``torch.distributed``, each process holding only
its rows (:func:`shard_graph`, :func:`shard_plans`, :func:`shard_swarm`,
:func:`shard_matching_plan`; :func:`gather_swarm` joins them), with the
hierarchical transport's two-level exchange (``cluster/hier.py``).
"""

from tpu_gossip_torch.dist.builder import matching_powerlaw_graph_dist
from tpu_gossip_torch.dist.matching_mesh import gossip_round_dist_matching, shard_matching_plan
from tpu_gossip_torch.dist.mesh import (
    Mesh,
    ShardedGraph,
    ShardPlans,
    build_shard_plans,
    gather_swarm,
    gossip_round_dist,
    init_sharded_swarm,
    make_mesh,
    partition_graph,
    repartition_swarm,
    run_until_coverage_dist,
    shard_graph,
    shard_plans,
    shard_ranges,
    shard_swarm,
    simulate_dist,
    swarm_coverage,
)
from tpu_gossip_torch.dist.transport import IciRound, IciTotals, Transport, build_transport

__all__ = [
    "IciRound",
    "IciTotals",
    "Mesh",
    "ShardedGraph",
    "ShardPlans",
    "Transport",
    "build_shard_plans",
    "build_transport",
    "gather_swarm",
    "gossip_round_dist",
    "gossip_round_dist_matching",
    "init_sharded_swarm",
    "make_mesh",
    "matching_powerlaw_graph_dist",
    "partition_graph",
    "repartition_swarm",
    "run_until_coverage_dist",
    "shard_matching_plan",
    "shard_graph",
    "shard_plans",
    "shard_ranges",
    "shard_swarm",
    "simulate_dist",
    "swarm_coverage",
]
