"""Graph container, the shared degree law and the host graph builders.

Ports ``tpu_gossip/core/topology.py``: ``Graph`` (:52), ``pareto_icdf``
(:77), ``powerlaw_degree_sequence`` (:88), ``configuration_model`` (:115),
``preferential_attachment`` (:139), ``build_csr`` (:193), ``save_graph`` /
``load_graph`` (:211, :217), ``hill_gamma`` and ``fit_powerlaw_gamma``
(:236, :246). The builders are host numpy code, copied as they are, so the
same ``np.random.default_rng`` seed gives the same graph in both packages.
``preferential_attachment(use_native=True)`` runs the port's own copy of
the C++ Barabási–Albert generator (``tpu_gossip_torch/native``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Graph",
    "pareto_icdf",
    "powerlaw_degree_sequence",
    "configuration_model",
    "preferential_attachment",
    "build_csr",
    "hill_gamma",
    "fit_powerlaw_gamma",
    "save_graph",
    "load_graph",
]


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
    every generator shares. Pure arithmetic on numpy arrays or tensors."""
    a = gamma - 1.0
    lo, hi = float(d_min), float(d_max) + 1.0
    return (lo ** (-a) - u * (lo ** (-a) - hi ** (-a))) ** (-1.0 / a)


def powerlaw_degree_sequence(n: int, gamma: float = 2.5, d_min: int = 2, d_max: int | None = None,
                             *, rng: np.random.Generator | None = None) -> np.ndarray:
    """Discrete power-law degrees P(d) ~ d^-gamma on [d_min, d_max] by
    inverse-CDF sampling rounded down; the sum is forced even."""
    if rng is None:
        rng = np.random.default_rng(0)
    if d_max is None:
        d_max = max(d_min + 1, int(round(n ** (1.0 / (gamma - 1.0)))))
    u = rng.random(n)
    x = pareto_icdf(u, gamma, d_min, d_max)
    deg = np.minimum(np.floor(x), d_max).astype(np.int64)
    if deg.sum() % 2 == 1:
        deg[int(np.argmin(deg))] += 1
    return deg


def configuration_model(degrees: np.ndarray, *, rng: np.random.Generator | None = None) -> np.ndarray:
    """Pair an endpoint multiset to realize ``degrees``; returns edges (E, 2)
    with self-loops and duplicates erased."""
    if rng is None:
        rng = np.random.default_rng(0)
    stubs = np.repeat(np.arange(len(degrees), dtype=np.int64), degrees)
    rng.shuffle(stubs)
    if len(stubs) % 2 == 1:
        stubs = stubs[:-1]
    u, v = stubs[0::2], stubs[1::2]
    keep = u != v
    u, v = u[keep], v[keep]
    edges = np.unique(np.stack([np.minimum(u, v), np.maximum(u, v)], axis=1), axis=0)
    return edges.astype(np.int64)


def preferential_attachment(n: int, m: int = 3, *, rng: np.random.Generator | None = None,
                            use_native: bool = True) -> np.ndarray:
    """Barabási–Albert growth; returns edges (E, 2). Each arriving node
    attaches ``m`` edges to distinct nodes drawn from the repeated-endpoints
    list (degree-proportional).

    ``use_native=True`` runs the C++ generator, seeded with one
    ``rng.integers(2**31 - 1)`` draw as the JAX package's native branch
    does; it raises when the library cannot be built, since the Python loop
    gives another graph. ``use_native=False`` runs the Python loop."""
    if rng is None:
        rng = np.random.default_rng(0)
    if n < m + 1:
        raise ValueError(f"need n > m, got n={n} m={m}")
    if use_native:
        from tpu_gossip_torch.native import pa_edges_native

        return pa_edges_native(n, m, seed=int(rng.integers(2**31 - 1)))

    seed_nodes = np.arange(m + 1)
    edges = [(int(a), int(b)) for i, a in enumerate(seed_nodes) for b in seed_nodes[i + 1:]]
    endpoints: list[int] = [x for e in edges for x in e]
    for v in range(m + 1, n):
        targets: set[int] = set()
        while len(targets) < m:
            targets.add(endpoints[int(rng.integers(len(endpoints)))])
        for t in targets:
            edges.append((t, v))
            endpoints.extend((t, v))
    e = np.asarray(edges, dtype=np.int64)
    return np.unique(np.stack([np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])], axis=1), axis=0)


def build_csr(n: int, edges: np.ndarray) -> Graph:
    """Symmetrize (E, 2) undirected edges into a CSR ``Graph`` (int32 numpy)."""
    if edges.size == 0:
        return Graph(n=n, row_ptr=np.zeros(n + 1, dtype=np.int32), col_idx=np.zeros(0, dtype=np.int32))
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_ptr[1:])
    return Graph(n=n, row_ptr=row_ptr.astype(np.int32), col_idx=dst.astype(np.int32))


def save_graph(path, graph: Graph) -> None:
    """Write a host graph as ``.npz`` (n, row_ptr, col_idx)."""
    np.savez(path, n=graph.n, row_ptr=graph.row_ptr, col_idx=graph.col_idx)


def load_graph(path) -> Graph:
    """Read a graph written by :func:`save_graph`."""
    data = np.load(path)
    return Graph(n=int(data["n"]), row_ptr=data["row_ptr"].astype(np.int32),
                 col_idx=data["col_idx"].astype(np.int32))


def hill_gamma(tail_count, log_moment):
    """Hill/CSN estimator ``1 + k / sum(log(d_i / (d_min - 1/2)))`` with the
    continuity-corrected log sum pre-reduced."""
    return 1.0 + tail_count / log_moment


def fit_powerlaw_gamma(degrees: np.ndarray, d_min: int = 4) -> float:
    """Discrete power-law MLE (Hill) of the tail exponent over degrees >= d_min."""
    d = np.asarray(degrees, dtype=np.float64)
    d = d[d >= d_min]
    if d.size < 10:
        raise ValueError("not enough tail samples to estimate gamma")
    return float(hill_gamma(d.size, np.sum(np.log(d / (d_min - 0.5)))))
