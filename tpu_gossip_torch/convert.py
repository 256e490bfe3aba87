"""Carry a JAX-built plan and state across into the port, and back.

The JAX package's ``MatchingPlan``, ``StaircasePlan``, ``ShardedGraph``,
``ShardPlans``, ``SwarmState`` and ``PackedSwarm`` leaves, handed over as
numpy arrays, become the port's dataclasses on ``device``, so the port's
round can run on a plan or partition the JAX package built (and a state
it seeded, packed or not, churned or folded: a re-materialized
``col_idx`` at its capacity and live ``rewire_targets`` and
``degree_credit`` are leaves like any other).
:func:`to_numpy` goes the other way, giving each leaf the dtype and shape
the JAX package stores. This module imports neither JAX nor the JAX
package: the caller does the conversion to numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.core.matching_topology import MatchingPlan, class_layout
from tpu_gossip_torch.core.packed import PackedSwarm
from tpu_gossip_torch.core.state import SwarmState, state_from_host
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.dist.mesh import ShardedGraph, ShardPlans
from tpu_gossip_torch.kernels.pallas_segment import StaircasePlan
from tpu_gossip_torch.utils.digest import leaf_array, leaf_fields

__all__ = ["PLAN_LEAVES", "PLAN_STATIC", "STAIRCASE_LEAVES", "STAIRCASE_STATIC", "SHARDED_LEAVES",
           "SHARDED_STATIC", "SHARD_PLAN_LEAVES", "SHARD_PLAN_STATIC", "plan_from_jax",
           "staircase_plan_from_jax", "sharded_graph_from_jax", "shard_plans_from_jax", "state_from_jax",
           "packed_state_from_jax", "to_numpy"]

PLAN_LEAVES = ("lanes", "m3", "lanes_inv", "valid", "deg_other", "deg_real")
PLAN_STATIC = ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk",
               "per_rows", "local_classes")
# the JAX StaircasePlan's first_visit table has no use on the card (K5's
# wrapper zeroes its outputs), so it is not carried across
STAIRCASE_LEAVES = ("tile_block", "offs", "col_gather", "push_thresh", "pull_thresh")
STAIRCASE_STATIC = ("n", "n_tiles", "n_blocks", "fanout", "rows")
SHARDED_LEAVES = ("send_src", "recv_dst", "send_valid", "send_dst_deg", "send_src_deg", "deg")
SHARDED_STATIC = ("n", "n_pad", "n_shards", "per_shard", "bucket", "fingerprint")
# the JAX ShardPlans' first_visit is dropped for the same reason (K6)
SHARD_PLAN_LEAVES = ("tile_block", "offs", "window_idx")
SHARD_PLAN_STATIC = ("per", "n_tiles", "n_blocks", "rows", "n_shards", "bucket", "fingerprint")


def _tensor(a, dev) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(np.array(a)).to(dev)


def plan_from_jax(leaves: dict, static: dict, device: str | torch.device = "cuda") -> MatchingPlan:
    """A port MatchingPlan from the JAX plan's array leaves (numpy; ``lanes``
    and ``lanes_inv`` as sequences) and its static fields; a sharded plan
    (``mesh_shards > 1``) keeps its ``local_classes``, ``per_rows``,
    ``n_blk`` and its narrow table widths, its class layout the global
    shard-major one."""
    dev = resolve_device(device)
    kw = {name: static[name] for name in PLAN_STATIC if name in static}
    kw["classes"] = tuple(tuple(int(v) for v in c) for c in kw["classes"])
    kw["local_classes"] = tuple(tuple(int(v) for v in c) for c in kw.get("local_classes", ()))
    return MatchingPlan(
        lanes=tuple(_tensor(a, dev) for a in leaves["lanes"]),
        m3=_tensor(leaves["m3"], dev),
        lanes_inv=tuple(_tensor(a, dev) for a in leaves["lanes_inv"]),
        valid=_tensor(leaves["valid"], dev),
        deg_other=_tensor(leaves.get("deg_other"), dev),
        deg_real=_tensor(leaves.get("deg_real"), dev),
        layout=class_layout(kw["classes"], kw["rows"], kw["n"], dev),
        **kw,
    )


def staircase_plan_from_jax(leaves: dict, static: dict, device: str | torch.device = "cuda") -> StaircasePlan:
    """A port StaircasePlan from the JAX plan's array leaves (numpy; the
    uint32 thresholds become int64) and its static fields."""
    dev = resolve_device(device)
    kw = {name: leaves.get(name) for name in STAIRCASE_LEAVES}
    for name in ("push_thresh", "pull_thresh"):
        if kw[name] is not None:
            kw[name] = np.asarray(kw[name]).astype(np.int64)
    kw = {name: _tensor(a, dev) for name, a in kw.items()}
    return StaircasePlan(**kw, **{name: static[name] for name in STAIRCASE_STATIC})


def sharded_graph_from_jax(leaves: dict, static: dict, device: str | torch.device = "cuda") -> ShardedGraph:
    """A port ShardedGraph from the JAX partition's leaves (numpy) and its
    static fields."""
    dev = resolve_device(device)
    return ShardedGraph(**{name: _tensor(leaves[name], dev) for name in SHARDED_LEAVES},
                        **{name: static[name] for name in SHARDED_STATIC})


def shard_plans_from_jax(leaves: dict, static: dict, device: str | torch.device = "cuda") -> ShardPlans:
    """Port ShardPlans from the JAX plans' leaves (numpy) and static fields."""
    dev = resolve_device(device)
    return ShardPlans(**{name: _tensor(leaves[name], dev) for name in SHARD_PLAN_LEAVES},
                      **{name: static[name] for name in SHARD_PLAN_STATIC})


def _state_leaves(cls, leaves: dict, dev) -> dict:
    kw = {}
    for f in dataclasses.fields(cls):
        if f.metadata.get("static"):
            continue
        a = np.asarray(leaves[f.name])
        if f.name == "rng":
            a = a.astype(np.int64)
        kw[f.name] = _tensor(a, dev)
    return kw


def state_from_jax(leaves: dict, device: str | torch.device = "cuda") -> SwarmState:
    """A port SwarmState from the JAX state's leaves as numpy arrays (the
    key as its uint32 (2,) key data), validated against the PLANES
    registry."""
    return state_from_host(leaves, device)


def packed_state_from_jax(leaves: dict, msg_slots: int, device: str | torch.device = "cuda") -> PackedSwarm:
    """A port PackedSwarm from the JAX PackedSwarm's leaves as numpy arrays
    and its static ``msg_slots``."""
    return PackedSwarm(**_state_leaves(PackedSwarm, leaves, resolve_device(device)), msg_slots=msg_slots)


def to_numpy(obj) -> dict:
    """Every leaf of a port SwarmState, PackedSwarm or MatchingPlan as
    numpy arrays, with the dtypes and shapes the JAX package stores."""
    if isinstance(obj, (SwarmState, PackedSwarm)):
        return {name: leaf_array(name, getattr(obj, name)) for name in leaf_fields(obj)}
    if isinstance(obj, MatchingPlan):
        out = {}
        for name in PLAN_LEAVES:
            v = getattr(obj, name)
            if isinstance(v, tuple):
                out[name] = [t.cpu().numpy() for t in v]
            else:
                out[name] = None if v is None else v.cpu().numpy()
        return out
    raise TypeError(f"to_numpy takes a SwarmState, PackedSwarm or MatchingPlan, got {type(obj).__name__}")
