"""Sharded execution: the peer axis split over a mesh of shards.

Ports the bucketed engine of ``tpu_gossip/dist/`` (``dist/mesh.py``): a
graph partitioned into per-shard buckets, one exchange a round, and the
receive through K6 (``--shard --staircase``) or the scatter OR, churn
re-wiring, fault scenarios and the epoch re-partition after a CSR fold
included. The mesh
is S shards in one process on one device; the multi-process exchange and
the other engines and transports of ``tpu_gossip/dist/`` are a later
slice.
"""

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

__all__ = [
    "Mesh",
    "ShardedGraph",
    "ShardPlans",
    "build_shard_plans",
    "gossip_round_dist",
    "init_sharded_swarm",
    "make_mesh",
    "partition_graph",
    "repartition_swarm",
    "run_until_coverage_dist",
    "shard_ranges",
    "shard_swarm",
    "simulate_dist",
]
