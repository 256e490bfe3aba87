"""Graph container and the shared degree law.

Ports ``Graph`` and ``pareto_icdf`` of ``tpu_gossip/core/topology.py``
(:52, :77). The host graph builders of that module belong to a later slice.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Graph", "pareto_icdf"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected graph in CSR form: ``row_ptr`` (n+1,), ``col_idx``
    (2E,), both edge directions stored (numpy arrays or tensors)."""

    n: int
    row_ptr: object
    col_idx: object

    @property
    def num_edges(self) -> int:
        return int(self.col_idx.shape[0]) // 2


def pareto_icdf(u, gamma: float, d_min: int, d_max: int):
    """Truncated-Pareto inverse CDF on [d_min, d_max+1): the degree law
    every generator shares. Pure arithmetic on numpy arrays."""
    a = gamma - 1.0
    lo, hi = float(d_min), float(d_max) + 1.0
    return (lo ** (-a) - u * (lo ** (-a) - hi ** (-a))) ** (-1.0 / a)
