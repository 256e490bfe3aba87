"""Word packing and the uint32 Bernoulli gate law.

Ports the plain helpers of ``tpu_gossip/kernels/pallas_segment.py``
(``pack_words``, ``unpack_words``, ``_slot_groups`` at :382-398 and
``bernoulli_threshold_device`` at :120) that the matching delivery uses.
The staircase segment kernels of that module (K5, K6) belong to a later
slice.
"""

from __future__ import annotations

import torch

__all__ = ["pack_words", "unpack_words", "_slot_groups", "bernoulli_threshold_device", "popcount"]


def pack_words(bitmap: torch.Tensor) -> torch.Tensor:
    """(N, M<=32) bool -> (N,) int32, bit m = slot m."""
    m = bitmap.shape[1]
    if m > 32:
        raise ValueError(f"msg_slots={m} exceeds the 32-bit packing width")
    shifts = torch.arange(m, dtype=torch.int64, device=bitmap.device)
    v = (bitmap.to(torch.int64) << shifts).sum(1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _slot_groups(m: int) -> list[tuple[int, int]]:
    """[(lo, width), ...] cutting M slots into <=32-bit word groups."""
    return [(lo, min(32, m - lo)) for lo in range(0, m, 32)]


def unpack_words(words: torch.Tensor, m: int) -> torch.Tensor:
    """(N,) int32 -> (N, m) bool."""
    shifts = torch.arange(m, dtype=torch.int32, device=words.device)
    return ((words[:, None] >> shifts[None, :]) & 1).to(torch.bool)


def bernoulli_threshold_device(p: torch.Tensor) -> torch.Tensor:
    """uint32 firing thresholds (as int64) for float32 probabilities ``p``:
    ``min(ceil(clip(p, 0, 1) * 2^32), 4294967040)`` computed in float32,
    4294967040 being the largest float32 below 2^32."""
    t = torch.ceil(torch.clamp(p, 0.0, 1.0) * 4294967296.0)
    return torch.minimum(t, torch.tensor(4294967040.0, dtype=torch.float32, device=p.device)).to(torch.int64)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set-bit count of int32 words (SWAR), as int32:
    ``jax.lax.population_count``'s value."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
