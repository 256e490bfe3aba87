"""Carry a JAX-built plan and state across into the port, and back.

The JAX package's ``MatchingPlan`` and ``SwarmState`` leaves, handed over
as numpy arrays, become the port's dataclasses on ``device``, so the port's
round can run on a plan the JAX package built (and a state it seeded).
:func:`to_numpy` goes the other way, giving each leaf the dtype and shape
the JAX package stores. This module imports neither JAX nor the JAX
package: the caller does the conversion to numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.core.matching_topology import MatchingPlan, class_layout
from tpu_gossip_torch.core.state import SwarmState
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.utils.digest import leaf_array

__all__ = ["PLAN_LEAVES", "PLAN_STATIC", "plan_from_jax", "state_from_jax", "to_numpy"]

PLAN_LEAVES = ("lanes", "m3", "lanes_inv", "valid", "deg_other", "deg_real")
PLAN_STATIC = ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk",
               "per_rows", "local_classes")


def _tensor(a, dev) -> torch.Tensor | None:
    return None if a is None else torch.from_numpy(np.array(a)).to(dev)


def plan_from_jax(leaves: dict, static: dict, device: str | torch.device = "cuda") -> MatchingPlan:
    """A port MatchingPlan from the JAX plan's array leaves (numpy; ``lanes``
    and ``lanes_inv`` as sequences) and its static fields."""
    dev = resolve_device(device)
    if static.get("mesh_shards", 1) != 1:
        raise NotImplementedError("sharded matching plans come with the multi-device slice")
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


def state_from_jax(leaves: dict, device: str | torch.device = "cuda") -> SwarmState:
    """A port SwarmState from the JAX state's leaves as numpy arrays (the
    key as its uint32 (2,) key data)."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(SwarmState):
        a = np.asarray(leaves[f.name])
        if f.name == "rng":
            a = a.astype(np.int64)
        kw[f.name] = _tensor(a, dev)
    return SwarmState(**kw)


def to_numpy(obj) -> dict:
    """Every leaf of a port SwarmState or MatchingPlan as numpy arrays,
    with the dtypes and shapes the JAX package stores."""
    if isinstance(obj, SwarmState):
        return {f.name: leaf_array(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, MatchingPlan):
        out = {}
        for name in PLAN_LEAVES:
            v = getattr(obj, name)
            if isinstance(v, tuple):
                out[name] = [t.cpu().numpy() for t in v]
            else:
                out[name] = None if v is None else v.cpu().numpy()
        return out
    raise TypeError(f"to_numpy takes a SwarmState or MatchingPlan, got {type(obj).__name__}")
