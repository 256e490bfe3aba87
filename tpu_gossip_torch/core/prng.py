"""Counter-based threefry2x32 keys: the port's stand-in for ``jax.random``.

Ports the parts of ``jax.random`` the main path draws from (JAX's
``jax/_src/prng.py`` threefry implementation under the default
``jax_threefry_partitionable=True`` layout), so every draw of the port
equals the JAX package's draw bit for bit:

- ``key(seed)`` holds key data ``[0, seed mod 2^32]``;
- ``bits(k, shape)[i] = x0 ^ x1`` of ``threefry2x32(k, (hi32(i), lo32(i)))``
  over the row-major flat index ``i``;
- ``split(k, n)[i] = (x0, x1)`` of the same hash at counter ``i``;
- ``fold_in(k, d) = threefry2x32(k, (0, d))``;
- ``uniform`` = ``bitcast((bits >> 9) | 0x3F800000) - 1.0`` in float32.

A key is an int64 tensor of shape (2,) holding two uint32 words. All word
arithmetic runs in int64 masked to 32 bits: ``>>`` on ``torch.uint32`` is
not implemented on the CPU. The port never touches the global torch RNG.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.device import resolve_device

__all__ = ["key", "split", "fold_in", "bits", "uniform", "key_data", "threefry2x32"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """The key ``jax.random.key(seed)`` makes: data ``[0, seed mod 2^32]``."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=dev)


def key_data(k: torch.Tensor):
    """The key's two words as a numpy uint32 (2,) array (digest leaf)."""
    return k.detach().cpu().numpy().astype("uint32")


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(
    k: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds over counter words ``(x0, x1)``
    (int64 tensors of uint32 values, broadcast together)."""
    k0, k1 = k[0], k[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _counters(k: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    return (idx >> 32) & _M32, idx & _M32


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) child keys; row ``i`` is child ``i`` (``jax.random.split``)."""
    y0, y1 = threefry2x32(k, *_counters(k, num))
    return torch.stack([y0, y1], dim=1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)`` for a 32-bit ``data``."""
    zero = torch.zeros((1,), dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k, zero, zero + (int(data) & _M32))
    return torch.cat([y0, y1])


def bits(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64 values in [0, 2^32)."""
    n = 1
    for d in shape:
        n *= int(d)
    y0, y1 = threefry2x32(k, *_counters(k, n))
    return (y0 ^ y1).reshape(shape)


def uniform(k: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 on [0, 1)."""
    b = (bits(k, shape) >> 9) | 0x3F800000
    return b.to(torch.int32).view(torch.float32) - 1.0
