"""Word-level bit-plane algebra of the packed-native round.

Ports the 13 helpers of ``tpu_gossip/kernels/packed_ops.py``: the delivery
merge, the stale filter, the forward-once latch and every infection count
run on the ``(N, W)`` uint8 words (OR/AND/ANDN and popcounts), with no
decode to full width. They keep the codec's two invariants
(``core/packed.py``): padding bits stay zero, and a NOT is always masked
(``not_words``).

Popcounts are a byte SWAR in int32, summed in int32: the value of
``jax.lax.population_count`` summed as the JAX package sums it. torch has
no OR reduction, so ``pull_words`` and ``gather_or_words`` OR the gathered
words along the gather axis in a loop over that (small) axis.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core.packed import word_mask

__all__ = [
    "or_words",
    "and_words",
    "andnot_words",
    "not_words",
    "mask_rows",
    "mask_cols",
    "rows_any",
    "popcount_rows",
    "popcount_cols",
    "count_bits",
    "role_words",
    "pull_words",
    "gather_or_words",
]


def or_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-level delivery merge: ``a | b``."""
    return a | b


def and_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Word-level intersection: ``a & b``."""
    return a & b


def andnot_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & ~b``: padding-safe without a mask, as ``a``'s padding is zero."""
    return a & ~b


def not_words(a: torch.Tensor, m: int) -> torch.Tensor:
    """``~a`` with the ragged-tail padding bits cleared again."""
    return ~a & word_mask(m, a.device)


def mask_rows(words: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Zero whole rows where the bool row mask is False."""
    return torch.where(rows[:, None], words, 0)


def mask_cols(words: torch.Tensor, col_words: torch.Tensor) -> torch.Tensor:
    """AND a packed, conforming ``(W,)`` per-slot column mask."""
    return words & col_words[None, :]


def rows_any(words: torch.Tensor) -> torch.Tensor:
    """Bool (N,): the row has any bit set."""
    return (words != 0).any(dim=-1)


def _popcount8(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint8 word, as int32."""
    v = words.to(torch.int32)
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """int32 (...,): per-row set-bit count (exact: the padding is zero)."""
    return _popcount8(words).sum(dim=-1, dtype=torch.int32)


def popcount_cols(words: torch.Tensor) -> torch.Tensor:
    """int32 (W,): per-word-column set-bit totals."""
    return _popcount8(words).sum(dim=0, dtype=torch.int32)


def count_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 scalar: total set bits across the plane."""
    return _popcount8(words).sum(dtype=torch.int32)


def role_words(recovered_w: torch.Tensor, active: torch.Tensor, m: int) -> torch.Tensor:
    """Word twin of ``compute_roles``' masks: ``active[:, None] &
    ~recovered``, both transmitter and receptive."""
    return mask_rows(not_words(recovered_w, m), active)


def _or_along(got: torch.Tensor, dim: int) -> torch.Tensor:
    out = got.select(dim, 0)
    for k in range(1, got.shape[dim]):
        out = out | got.select(dim, k)
    return out


def pull_words(answer_w: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Word twin of ``pull_fanout``: gather each peer's K partners' answer
    words (``targets`` int32 (N, K), ``valid`` bool (N, K)) and OR them."""
    got = torch.where(valid[:, :, None], answer_w[targets.to(torch.int64)], 0)
    return _or_along(got, 1)


def gather_or_words(words: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``words[idx]`` masked by ``valid``, OR-folded over the gather axis."""
    got = torch.where(valid[..., None], words[idx.to(torch.int64)], 0)
    return _or_along(got, got.ndim - 2)
