"""The block of the swarm's rows a round's per-peer planes hold.

The row planes' side paths (churn's endpoints and credit, the fresh edges'
traffic, the flood replay, the forged heartbeats, the accusations) draw,
read and write across rows. They take a :class:`Rows` and run one body
whatever it is:

- ``lo``: the first global row held, the counter offset of the block of a
  draw over the rows being ``lo * width``;
- ``total(n)``: the swarm's rows from the ``n`` held;
- ``block(table, n)``: the held rows' block of a table over the swarm's
  rows (``table[lo:lo + n]``);
- ``sum(x)``: a count over the held rows summed over the swarm;
- ``fsum(x)``: a float partial over the held rows summed over the swarm
  in holder order, so every holder and every run gets the same bits;
- ``stack(x)``: every holder's copy of a small tensor, stacked in holder
  order (a leading axis of one entry a holder);
- ``lookup(idx, plane)``: a bool plane at rows ``idx`` of the swarm, each
  answered by the row's holder;
- ``gather(*planes)``: the swarm's planes from the held rows of each;
- ``reduce(contrib, op)``: the held rows of a plane over the swarm's rows
  into which every holder scattered its contributions, combined with the
  one-process scatter's own order-free operation (``"or"`` on bool,
  integer ``"sum"`` or ``"max"``).

Each takes a ``label`` under which a holder of a block counts what it
sends.

A one-process round holds every row (:data:`ALL_ROWS`): each of these is
the identity. A process of a mesh over several processes holds one block
(``cluster.topology.ProcessRows``), where they cross the process group.
"""

from __future__ import annotations

import torch

__all__ = ["Rows", "ALL_ROWS", "check_combine"]

COMBINE = ("or", "sum", "max")


def check_combine(contrib: torch.Tensor, op: str) -> None:
    """Refuse a combination that is not order-free: an unknown ``op``, OR of
    a non-bool plane, or any float plane (its sum depends on the order)."""
    if op not in COMBINE:
        raise ValueError(f"rows combine with or, sum or max, got {op!r}")
    if op == "or" and contrib.dtype != torch.bool:
        raise ValueError(f"op='or' takes a bool plane, got {contrib.dtype}")
    if op != "or" and contrib.dtype.is_floating_point:
        raise ValueError("rows combine integer planes only: a float sum depends on its order")


class Rows:
    """Every row of the swarm, held in one process."""

    lo = 0

    def total(self, n: int) -> int:
        return n

    def block(self, table: torch.Tensor, n: int) -> torch.Tensor:
        return table[self.lo: self.lo + n]

    def sum(self, x: torch.Tensor, label: str | None = None) -> torch.Tensor:
        return x

    def fsum(self, x: torch.Tensor, label: str = "fsum") -> torch.Tensor:
        return x

    def stack(self, x: torch.Tensor, label: str = "stack") -> torch.Tensor:
        return x[None]

    def lookup(self, idx: torch.Tensor, plane: torch.Tensor, label: str = "lookup") -> torch.Tensor:
        return plane[idx]

    def gather(self, *planes: torch.Tensor, label: str = "gather") -> tuple[torch.Tensor, ...]:
        return planes

    def reduce(self, contrib: torch.Tensor, op: str, label: str = "reduce") -> torch.Tensor:
        check_combine(contrib, op)
        return contrib


ALL_ROWS = Rows()
