"""Sharded execution: the peer axis split over a mesh of shards.

Ports ``tpu_gossip/dist/``: the bucketed engine (``dist/mesh.py``: a graph
partitioned into per-shard buckets, one exchange a round, the receive
through K6 or the scatter OR, churn re-wiring, fault scenarios and the
epoch re-partition after a CSR fold included), the sharded matching engine
(``dist/matching_mesh.py``: the gather-free pipeline with one exchange a
transpose, bit-identical to the local matching round), the dense, sparse
and auto transports with their analytic ICI counters
(``dist/transport.py``) and the distributed matching builder
(``dist/builder.py``). The mesh is S shards in one process on one device;
the multi-process exchange and the hierarchical transport are ROADMAP
item 11c.
"""

from tpu_gossip_torch.dist.builder import matching_powerlaw_graph_dist
from tpu_gossip_torch.dist.matching_mesh import gossip_round_dist_matching, shard_matching_plan
from tpu_gossip_torch.dist.mesh import (
    Mesh,
    ShardedGraph,
    ShardPlans,
    build_shard_plans,
    gossip_round_dist,
    init_sharded_swarm,
    make_mesh,
    partition_graph,
    repartition_swarm,
    run_until_coverage_dist,
    shard_ranges,
    shard_swarm,
    simulate_dist,
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
    "gossip_round_dist",
    "gossip_round_dist_matching",
    "init_sharded_swarm",
    "make_mesh",
    "matching_powerlaw_graph_dist",
    "partition_graph",
    "repartition_swarm",
    "run_until_coverage_dist",
    "shard_matching_plan",
    "shard_ranges",
    "shard_swarm",
    "simulate_dist",
]
