"""Sentinel-row CSR on the device, and the on-device power-law generator.

Ports ``tpu_gossip/core/device_topology.py``: ``DeviceGraph``,
``as_padded_graph`` and ``to_host_graph`` (:49, :73, :78), ``truncated_pareto_mean`` (:90) and
``device_powerlaw_graph`` (:161, the sort-based ``_build`` at :104). The
erased configuration model is built where the CSR will live: degrees from
``prng.uniform`` through the float32 Pareto law, stubs paired by one stable
argsort of ``prng.bits`` keys, self-loops and duplicates erased by a
lexsort (two stable sorts), the CSR by a stable argsort and
``searchsorted``. Every erased stub moves to the sentinel row ``n``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.topology import Graph, pareto_icdf
from tpu_gossip_torch.device import resolve_device

__all__ = ["DeviceGraph", "device_powerlaw_graph", "repeat_ids", "truncated_pareto_mean"]


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

    def to_host_graph(self) -> Graph:
        """The real rows as a host numpy ``Graph``: erased edges lose both
        endpoints, so the real CSR is the first ``row_ptr[n]`` entries."""
        row_ptr = self.row_ptr[: self.n + 1].cpu().numpy().astype(np.int32)
        col_idx = self.col_idx[: int(row_ptr[-1])].cpu().numpy().astype(np.int32)
        return Graph(n=self.n, row_ptr=row_ptr, col_idx=col_idx)


def truncated_pareto_mean(gamma: float, d_min: int, d_max: int, grid: int = 200_000) -> float:
    """E[min(floor(X), d_max)] of the degree law, a host integral that
    sizes the static stub budget."""
    u = (np.arange(grid) + 0.5) / grid
    x = pareto_icdf(u, gamma, d_min, d_max)
    return float(np.minimum(np.floor(x), d_max).mean())


def repeat_ids(counts: torch.Tensor, total: int) -> torch.Tensor:
    """``jnp.repeat(arange(len(counts)), counts, total_repeat_length=total)``
    for the positions below ``counts.sum()``, as int32 without a host sync:
    position p belongs to the first i with ``cumsum(counts)[i] > p``.
    Positions past the sum read ``len(counts) - 1``."""
    # graftlint: disable=mem-widening-cast -- the cumulative counts index the edge space in int64
    ends = torch.cumsum(counts.to(torch.int64), 0)
    pos = torch.arange(total, dtype=torch.int64, device=counts.device)
    ids = torch.searchsorted(ends, pos, right=True)
    return torch.clamp(ids, max=max(counts.shape[0] - 1, 0)).to(torch.int32)


def pareto_icdf_f32(u: torch.Tensor, gamma: float, d_min: int, d_max: int) -> torch.Tensor:
    """:func:`pareto_icdf` on float32 draws as the JAX package's compiled
    build evaluates it: float32 constants, the multiply-subtract fused into
    one rounding (an FMA), and the power rounded once to float32. The base
    is a difference of two numbers near 0.35, so the product's rounding
    would move the degrees; float64 carries both steps exactly enough."""
    a = gamma - 1.0
    lo, hi = float(d_min), float(d_max) + 1.0
    c0 = float(np.float32(lo ** (-a)))
    c1 = float(np.float32(lo ** (-a) - hi ** (-a)))
    base = (c0 - u.double() * c1).float()
    return (base.double() ** float(np.float32(-1.0 / a))).float()


def _build(key: torch.Tensor, *, n: int, gamma: float, d_min: int, d_max: int, s_cap: int):
    dev = key.device
    k_deg, k_pair = prng.split(key)

    # degree sequence: the float32 inverse CDF, floored
    x = pareto_icdf_f32(prng.uniform(k_deg, (n,)), gamma, d_min, d_max)
    deg = torch.clamp(torch.floor(x), max=float(d_max)).to(torch.int32)

    # clip the running total at an even budget <= s_cap
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    total = torch.clamp(cum[-1], max=s_cap)
    total = total - (total & 1)
    deg_eff = torch.minimum(torch.clamp(total - (cum - deg), min=0), deg)

    # stubs and random pairing; padding stubs go to the sentinel and sort last
    pos = torch.arange(s_cap, dtype=torch.int32, device=dev)
    owners = torch.where(pos < total, repeat_ids(deg_eff, s_cap), n)
    pair_keys = torch.where(owners == n, 0xFFFFFFFF, prng.bits(k_pair, (s_cap,)))
    shuffled = owners[torch.argsort(pair_keys, stable=True)]
    eu, ev = shuffled[0::2], shuffled[1::2]

    # erase self-loops, then duplicates
    elo, ehi = torch.minimum(eu, ev), torch.maximum(eu, ev)
    bad = (elo == ehi) | (ehi == n)
    elo = torch.where(bad, n, elo)
    ehi = torch.where(bad, n, ehi)
    o1 = torch.argsort(ehi, stable=True)
    order = o1[torch.argsort(elo[o1], stable=True)]
    slo, shi = elo[order], ehi[order]
    dup = torch.zeros_like(slo, dtype=torch.bool)
    dup[1:] = (slo[1:] == slo[:-1]) & (shi[1:] == shi[:-1])
    dup &= slo != n
    slo = torch.where(dup, n, slo)
    shi = torch.where(dup, n, shi)

    # CSR over n+1 rows, the sentinel last
    src = torch.cat([slo, shi])
    dst = torch.cat([shi, slo])
    csr_order = torch.argsort(src, stable=True)
    col_idx = dst[csr_order]
    row_ptr = torch.searchsorted(
        src[csr_order], torch.arange(n + 2, dtype=torch.int32, device=dev), side="left"
    ).to(torch.int32)
    exists = torch.arange(n + 1, dtype=torch.int32, device=dev) < n
    return row_ptr, col_idx, exists


def device_powerlaw_graph(n: int, gamma: float = 2.5, d_min: int = 2, d_max: int | None = None, *,
                          key: torch.Tensor | None = None, slack: float = 1.02,
                          device: str | torch.device = "cuda") -> DeviceGraph:
    """Erased-configuration-model power-law graph built on ``device``, with
    a sentinel row that owns every erased and padding stub. The draws are
    the JAX package's (threefry), so on the CPU the graph equals JAX's."""
    dev = resolve_device(device)
    if key is None:
        key = prng.key(0, dev)
    if d_max is None:
        d_max = max(d_min + 1, int(round(n ** (1.0 / (gamma - 1.0)))))
    mean = truncated_pareto_mean(gamma, d_min, d_max)
    s_cap = int(math.ceil(n * mean * slack / 2) * 2)
    row_ptr, col_idx, exists = _build(key.to(dev), n=n, gamma=gamma, d_min=d_min, d_max=d_max, s_cap=s_cap)
    return DeviceGraph(row_ptr=row_ptr, col_idx=col_idx, exists=exists, n=n)
