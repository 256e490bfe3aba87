"""Sentinel-row CSR on the device.

Ports ``DeviceGraph`` and ``as_padded_graph`` of
``tpu_gossip/core/device_topology.py`` (:49, :73). The sort-based
generator of that module belongs to a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_gossip_torch.core.topology import Graph

__all__ = ["DeviceGraph"]


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """CSR adjacency on the device with one trailing sentinel row:
    ``row_ptr`` (n+2,), ``col_idx`` (2*S_cap,), ``exists`` (n+1,) False
    only for the sentinel row that owns every erased edge slot."""

    row_ptr: torch.Tensor  # int32 (n+2,)
    col_idx: torch.Tensor  # int32
    exists: torch.Tensor  # bool (n+1,)
    n: int

    @property
    def n_pad(self) -> int:
        return self.n + 1

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def as_padded_graph(self) -> Graph:
        """View including the sentinel row; feed to ``init_swarm`` with
        ``exists=self.exists``."""
        return Graph(n=self.n + 1, row_ptr=self.row_ptr, col_idx=self.col_idx)
