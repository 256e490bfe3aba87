"""sha256 fingerprints of a run, equal to the JAX package's.

Ports ``state_digest`` and ``stats_digest`` of
``tpu_gossip/fleet/engine.py`` (:130-162). Each leaf is hashed as the numpy
array the JAX package would hash: its dtype string, its shape and its
bytes, in the state's field order. The key hashes as uint32 (2,), and
``round`` and ``control_lvl`` as int32 of shape (). Static fields (a
``PackedSwarm``'s ``msg_slots``) are no leaves of the JAX pytree and are not
hashed. ``stats_digest`` hashes the integer stat tracks only, by name.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

__all__ = ["state_digest", "stats_digest", "leaf_array", "leaf_fields"]


def leaf_array(name: str, leaf: torch.Tensor) -> np.ndarray:
    """One state leaf as the numpy array the JAX digest hashes."""
    arr = leaf.detach().cpu().numpy()
    return arr.astype(np.uint32) if name == "rng" else arr


def leaf_fields(state) -> list[str]:
    """The state's leaf field names in order: its static fields left out,
    as ``jax.tree.leaves`` leaves them out."""
    return [f.name for f in dataclasses.fields(state) if not f.metadata.get("static")]


def state_digest(state) -> str:
    """sha256 over every state leaf, in field order."""
    h = hashlib.sha256()
    for name in leaf_fields(state):
        arr = leaf_array(name, getattr(state, name))
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def stats_digest(stats) -> str:
    """sha256 over the integer stat tracks (float tracks excluded)."""
    h = hashlib.sha256()
    for name in stats._fields:
        arr = getattr(stats, name).detach().cpu().numpy()
        if arr.dtype.kind not in "biu":
            continue
        h.update(name.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()
