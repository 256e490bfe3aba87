"""Growth plans: capacity layout and admission schedule, compiled on the host.

Ports ``tpu_gossip/growth/plan.py``. A growing swarm runs at a fixed
CAPACITY: the state has more rows than live peers, and the growth engine
flips reserved rows live in per-round batches. Which rows are reserved,
and in what order they are admitted, depends on the engine's slot layout:

- flat layouts (the local engines over a host CSR padded by
  :func:`pad_graph_for_growth`): capacity rows follow the initial peers and
  are admitted in row order;
- the sharded matching layout (``matching_powerlaw_graph_sharded(
  growth_rows=...)``): each shard block carries its own reserved rows and
  admission round-robins across the shards (:func:`matching_admit_rows`);
- the bucketed mesh (``partition_graph`` over a padded CSR): admission
  follows the original peer ids mapped through ``position``.

All three are one ``admit_rows`` array, the j-th admitted peer's state
row, so the engine half (``growth/engine.py``) is layout-blind.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device

__all__ = [
    "GrowthError",
    "CompiledGrowth",
    "compile_growth",
    "pad_graph_for_growth",
    "matching_admit_rows",
]


class GrowthError(ValueError):
    """A growth config that cannot mean what it says (compile time)."""


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledGrowth:
    """An admission schedule compiled to device tables.

    ``admit_rows`` lists the state row of every growth slot in admission
    order, padded with the out-of-range drop row to ``total + max_batch``
    entries, so the round's window at the cursor never runs off the end;
    ``growable`` marks exactly the rows ``admit_rows`` names, so
    ``sum(growable & exists)`` is the number of peers admitted so far: the
    cursor lives in the state, and a mid-growth checkpoint resumes where
    it stopped. The ints fix the batch shape and the attachment width.
    """

    admit_rows: torch.Tensor  # int32 (total + max_batch,), drop-row padded
    growable: torch.Tensor  # bool (N,): rows the schedule may admit
    joins_per_round: int
    max_batch: int
    attach_m: int
    total: int
    gamma_d_min: int = 4


def pad_graph_for_growth(graph, capacity: int):
    """Pad a host CSR Graph to ``capacity`` rows of growth headroom.

    Returns ``(padded_graph, exists)``: rows past ``graph.n`` have degree 0
    (an admitted peer's links are the fresh preferential-attachment edges
    the engine draws) and start non-existent. A graph whose CSR lies on a
    device (``DeviceGraph.as_padded_graph()``) is padded there; ``exists``
    is a numpy mask either way."""
    from tpu_gossip_torch.core.topology import Graph

    n = graph.n
    if capacity < n:
        raise GrowthError(f"capacity {capacity} < initial peers {n}")
    if capacity == n:
        return graph, np.ones(n, dtype=bool)
    if isinstance(graph.row_ptr, torch.Tensor):  # a device graph's view, padded where it lies
        row_ptr = torch.cat([graph.row_ptr, graph.row_ptr[-1:].expand(capacity - n)])
    else:
        row_ptr = np.concatenate([
            graph.row_ptr,
            np.full(capacity - n, graph.row_ptr[-1], dtype=graph.row_ptr.dtype),
        ])
    exists = np.zeros(capacity, dtype=bool)
    exists[:n] = True
    return Graph(n=capacity, row_ptr=row_ptr, col_idx=graph.col_idx), exists


def matching_admit_rows(plan, total: int) -> np.ndarray:
    """Admission-ordered state rows of a layout built with
    ``matching_powerlaw_graph_sharded(..., growth_rows=...)``: each shard
    block reserves the rows ``[n_per, n_per + growth_rows)``, and admission
    round-robins across the shards."""
    s, n_blk, n_per = plan.mesh_shards, plan.n_blk, plan.n_per
    per_shard = n_blk - n_per - 1  # reserved rows per block (pad row excluded)
    if total > per_shard * s:
        raise GrowthError(
            f"schedule admits {total} peers but the matching layout "
            f"reserves only {per_shard * s} growth rows — rebuild with "
            f"growth_rows >= {-(-total // s)}"
        )
    j = np.arange(total, dtype=np.int64)
    return (j % s) * n_blk + n_per + j // s


def compile_growth(
    *,
    n_initial: int,
    target: int,
    n_slots: int,
    joins_per_round: int,
    attach_m: int,
    admit_rows: np.ndarray | None = None,
    node_map=None,
    max_join_burst: int = 0,
    gamma_d_min: int = 4,
    device: str | torch.device = "cuda",
) -> CompiledGrowth:
    """Compile an admission schedule for one engine's slot layout on
    ``device``.

    ``target - n_initial`` peers will be admitted. ``admit_rows`` defaults
    to the flat layout ``[n_initial, target)``; ``node_map`` (an id-to-row
    callable) maps that default through an engine's permutation instead.
    ``max_join_burst`` sizes the per-round batch for the largest
    ``join_burst`` a scenario phase adds to ``joins_per_round``. An
    impossible schedule raises :class:`GrowthError` with the JAX words."""
    total = int(target) - int(n_initial)
    if total < 0:
        raise GrowthError(
            f"growth target {target} below initial peers {n_initial}"
        )
    if joins_per_round < 0 or max_join_burst < 0:
        raise GrowthError("joins_per_round and join bursts must be >= 0")
    if total > 0 and joins_per_round + max_join_burst <= 0:
        raise GrowthError(
            f"{total} peers to admit but joins_per_round=0 and no "
            "join_burst phase — the swarm would never grow"
        )
    if attach_m <= 0:
        raise GrowthError(f"attach_m={attach_m} must be positive")
    if attach_m >= max(n_initial, 1):
        raise GrowthError(
            f"attach_m={attach_m} needs at least that many initial peers "
            f"to attach to (got {n_initial})"
        )
    if admit_rows is None:
        admit_rows = np.arange(n_initial, target, dtype=np.int64)
        if node_map is not None and total:
            admit_rows = np.asarray(node_map(admit_rows))
    admit_rows = np.asarray(admit_rows, dtype=np.int64)
    if admit_rows.shape != (total,):
        raise GrowthError(
            f"admit_rows has {admit_rows.shape} entries; the schedule "
            f"admits {total}"
        )
    if total and (admit_rows.min() < 0 or admit_rows.max() >= n_slots):
        raise GrowthError(
            f"admit_rows outside the state's [0, {n_slots}) row space"
        )
    if len(np.unique(admit_rows)) != total:
        raise GrowthError("admit_rows admits some row twice")
    dev = resolve_device(device)
    max_batch = max(joins_per_round + max_join_burst, 1)
    growable = np.zeros(n_slots, dtype=bool)
    growable[admit_rows] = True
    padded = np.full(total + max_batch, n_slots, dtype=np.int32)  # drop row
    padded[:total] = admit_rows
    return CompiledGrowth(
        admit_rows=torch.from_numpy(padded).to(dev),
        growable=torch.from_numpy(growable).to(dev),
        joins_per_round=int(joins_per_round),
        max_batch=int(max_batch),
        attach_m=int(attach_m),
        total=int(total),
        gamma_d_min=int(gamma_d_min),
    )
