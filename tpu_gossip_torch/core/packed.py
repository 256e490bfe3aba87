"""Packed state planes: the bit-true storage codec of SwarmState.

Ports ``tpu_gossip/core/packed.py``. Every (N, M) bool plane packs
LSB-first into uint8 words along the slot axis (bit k of word j holds slot
``8*j + k``): ``seen``, ``forwarded``, ``recovered``, ``fault_held`` and
``pipe_buf`` take ceil(M/8) bytes a peer instead of M. The six (N,) bool
masks share one (N,) uint8 ``flags`` word (:data:`FLAG_BITS`). Every other
plane is carried as it is. :class:`PackedSwarm` is the packed twin of
:class:`~tpu_gossip_torch.core.state.SwarmState`, in the JAX field order;
:func:`pack_state` and :func:`unpack_state` are exact inverses (integer ops
only). The numpy twins are the host codec of the checkpoint formats.

Padding bits (slots ``m..8W``) are always zero, so OR and AND of two
conforming planes conform and popcounts need no mask. Bitwise NOT is the
one operation that sets them, so a word negation is always written
``~w & word_mask(m)``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpu_gossip_torch.core.state import SwarmState

__all__ = [
    "FLAG_BITS",
    "BIT_PLANES",
    "FLAG_PLANES",
    "PackedSwarm",
    "packed_width",
    "pack_bits",
    "unpack_bits",
    "bit_column",
    "word_mask",
    "words8_to_words32",
    "words32_to_words8",
    "pack_flags",
    "unpack_flag",
    "pack_state",
    "unpack_state",
    "is_packed",
    "np_pack_bits",
    "np_unpack_bits",
    "np_pack_flags",
    "np_unpack_flag",
    "pack_host_planes",
    "decode_host_planes",
]

# the (N, M) bool planes stored as LSB-first uint8 words, in codec order
BIT_PLANES = ("seen", "forwarded", "recovered", "fault_held", "pipe_buf")

# bit assignment of the shared (N,) uint8 flags word
FLAG_BITS = {
    "exists": 0,
    "alive": 1,
    "silent": 2,
    "declared_dead": 3,
    "rewired": 4,
    "quarantine": 5,
}
FLAG_PLANES = tuple(FLAG_BITS)


def packed_width(m: int) -> int:
    """uint8 words per row for an m-slot bit plane."""
    return -(-m // 8)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """bool (..., M) -> uint8 (..., ceil(M/8)), LSB-first within a word."""
    m = x.shape[-1]
    w = packed_width(m)
    xb = x.to(torch.uint8)
    if w * 8 != m:
        xb = torch.cat([xb, xb.new_zeros(tuple(x.shape[:-1]) + (w * 8 - m,))], dim=-1)
    xb = xb.reshape(tuple(x.shape[:-1]) + (w, 8))
    # the bits are disjoint, so the uint8 sum is their OR
    return torch.sum(xb << _shifts(x.device), dim=-1, dtype=torch.uint8)


def unpack_bits(words: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: uint8 (..., W) -> bool (..., m)."""
    bits = (words[..., None] >> _shifts(words.device)) & 1
    flat = bits.reshape(tuple(words.shape[:-1]) + (words.shape[-1] * 8,))
    return flat[..., :m] != 0


def bit_column(words: torch.Tensor, slot: int) -> torch.Tensor:
    """One slot's bool column straight from the packed words."""
    return ((words[..., slot // 8] >> (slot % 8)) & 1) != 0


@functools.lru_cache(maxsize=None)
def _shifts(device) -> torch.Tensor:
    """(8,) uint8 bit positions 0..7, made once per device."""
    return torch.arange(8, dtype=torch.uint8, device=device)


@functools.lru_cache(maxsize=None)
def _word_mask(m: int, device) -> torch.Tensor:
    bits = np.arange(packed_width(m) * 8) < m
    return torch.as_tensor(np.packbits(bits, bitorder="little"), device=device)


def word_mask(m: int, device=None) -> torch.Tensor:
    """(W,) uint8 with exactly the first ``m`` bits set (the ragged-tail
    mask of a word negation). Made once per ``(m, device)`` and shared, so
    a round copies no host constant to the card (callers never write
    it)."""
    return _word_mask(m, torch.device("cpu") if device is None else torch.device(device))


def words8_to_words32(words: torch.Tensor) -> torch.Tensor:
    """uint8 (..., W) bit words -> int32 (..., ceil(W/4)) words, int32
    word g being uint8 words ``4g..4g+4`` little-endian."""
    w = words.shape[-1]
    g = -(-w // 4)
    if g * 4 != w:
        words = torch.cat([words, words.new_zeros(tuple(words.shape[:-1]) + (g * 4 - w,))], dim=-1)
    b = words.reshape(tuple(words.shape[:-1]) + (g, 4)).to(torch.int64)
    v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def words32_to_words8(words32: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse of :func:`words8_to_words32`, trimmed to ``w`` uint8 words."""
    parts = [((words32 >> (8 * k)) & 0xFF).to(torch.uint8)[..., None] for k in range(4)]
    flat = torch.cat(parts, dim=-1)
    return flat.reshape(tuple(words32.shape[:-1]) + (words32.shape[-1] * 4,))[..., :w]


def pack_flags(planes: dict) -> torch.Tensor:
    """The shared (N,) uint8 flags word from the six named bool masks."""
    word = torch.zeros(planes["exists"].shape, dtype=torch.uint8, device=planes["exists"].device)
    for name, bit in FLAG_BITS.items():
        word = word | (planes[name].to(torch.uint8) << bit)
    return word


def unpack_flag(word: torch.Tensor, name: str) -> torch.Tensor:
    """One named bool mask out of the flags word."""
    return ((word >> FLAG_BITS[name]) & 1) != 0


# ---------------------------------------------------------------- numpy twins


def np_pack_bits(x: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_bits` (same LSB-first convention)."""
    return np.packbits(np.asarray(x, dtype=bool), axis=-1, bitorder="little")


def np_unpack_bits(words: np.ndarray, m: int) -> np.ndarray:
    """Host twin of :func:`unpack_bits`."""
    flat = np.unpackbits(np.asarray(words, dtype=np.uint8), axis=-1, bitorder="little")
    return flat[..., :m].astype(bool)


def np_pack_flags(planes: dict) -> np.ndarray:
    word = np.zeros(np.asarray(planes["exists"]).shape, np.uint8)
    for name, bit in FLAG_BITS.items():
        word |= np.asarray(planes[name], dtype=np.uint8) << np.uint8(bit)
    return word


def np_unpack_flag(word: np.ndarray, name: str) -> np.ndarray:
    return (np.asarray(word) >> np.uint8(FLAG_BITS[name])) & 1 != 0


def pack_host_planes(host: dict) -> dict:
    """Unpacked host planes -> the packed storage layout: bit planes pack,
    flag planes collapse into ``flags``, everything else passes through."""
    out = {k: v for k, v in host.items() if k not in BIT_PLANES and k not in FLAG_PLANES}
    for p in BIT_PLANES:
        out[p] = np_pack_bits(host[p])
    out["flags"] = np_pack_flags({n: host[n] for n in FLAG_PLANES})
    return out


def decode_host_planes(arrays: dict, m: int, prefix: str = "field_") -> dict:
    """Inverse of :func:`pack_host_planes` over ``prefix``-keyed arrays.
    A plane that is absent, or not uint8, is left as it is for the
    loader's validation to name."""
    out = dict(arrays)
    flags = out.pop(f"{prefix}flags")
    if flags.dtype == np.uint8:
        for name in FLAG_PLANES:
            out[f"{prefix}{name}"] = np_unpack_flag(flags, name)
    for p in BIT_PLANES:
        words = out.get(f"{prefix}{p}")
        if words is not None and words.dtype == np.uint8:
            out[f"{prefix}{p}"] = np_unpack_bits(words, m)
    return out


@dataclasses.dataclass
class PackedSwarm:
    """The packed twin of :class:`~tpu_gossip_torch.core.state.SwarmState`,
    in the JAX field order. ``msg_slots`` is static (16 slots and 13 slots
    both pack to 2 words), so it is no leaf and no digest input."""

    row_ptr: torch.Tensor  # int32 (N+1,)
    col_idx: torch.Tensor  # int32 (D,)
    seen: torch.Tensor  # uint8 (N, W)
    forwarded: torch.Tensor  # uint8 (N, W)
    infected_round: torch.Tensor  # int16 (N, M), carried as it is
    recovered: torch.Tensor  # uint8 (N, W)
    flags: torch.Tensor  # uint8 (N,), FLAG_BITS
    last_hb: torch.Tensor  # int16 (N,)
    rewire_targets: torch.Tensor  # int32 (N, S)
    fault_held: torch.Tensor  # uint8 (N, W)
    join_round: torch.Tensor  # int16 (N,)
    admitted_by: torch.Tensor  # int32 (N,)
    degree_credit: torch.Tensor  # int32 (N,)
    slot_lease: torch.Tensor  # int16 (M,)
    control_lvl: torch.Tensor  # int32 ()
    pipe_buf: torch.Tensor  # uint8 (N, W)
    suspect_round: torch.Tensor  # int16 (N,)
    suspect_mark: torch.Tensor  # int16 (N,)
    rng: torch.Tensor  # int64 (2,) threefry key words
    round: torch.Tensor  # int32 ()
    msg_slots: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n_peers(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    def coverage(self, slot: int = 0) -> torch.Tensor:
        """``SwarmState.coverage`` read off the packed words (one bit
        column, no plane unpack)."""
        live = unpack_flag(self.flags, "alive") & ~unpack_flag(self.flags, "declared_dead")
        n_live = torch.clamp(live.sum(), min=1).to(torch.float32)
        return (bit_column(self.seen, slot) & live).sum().to(torch.float32) / n_live


def is_packed(state) -> bool:
    """Type dispatch for the round entry points."""
    return isinstance(state, PackedSwarm)


def pack_state(state: SwarmState) -> PackedSwarm:
    """SwarmState -> PackedSwarm, losslessly. The planes without a packing
    are the input's own tensors (the rounds never write in place)."""
    return PackedSwarm(
        row_ptr=state.row_ptr,
        col_idx=state.col_idx,
        seen=pack_bits(state.seen),
        forwarded=pack_bits(state.forwarded),
        infected_round=state.infected_round,
        recovered=pack_bits(state.recovered),
        flags=pack_flags({n: getattr(state, n) for n in FLAG_PLANES}),
        last_hb=state.last_hb,
        rewire_targets=state.rewire_targets,
        fault_held=pack_bits(state.fault_held),
        join_round=state.join_round,
        admitted_by=state.admitted_by,
        degree_credit=state.degree_credit,
        slot_lease=state.slot_lease,
        control_lvl=state.control_lvl,
        pipe_buf=pack_bits(state.pipe_buf),
        suspect_round=state.suspect_round,
        suspect_mark=state.suspect_mark,
        rng=state.rng,
        round=state.round,
        msg_slots=int(state.seen.shape[-1]),
    )


def unpack_state(packed: PackedSwarm) -> SwarmState:
    """PackedSwarm -> SwarmState (exact inverse of :func:`pack_state`)."""
    m = packed.msg_slots
    return SwarmState(
        row_ptr=packed.row_ptr,
        col_idx=packed.col_idx,
        seen=unpack_bits(packed.seen, m),
        forwarded=unpack_bits(packed.forwarded, m),
        infected_round=packed.infected_round,
        recovered=unpack_bits(packed.recovered, m),
        exists=unpack_flag(packed.flags, "exists"),
        alive=unpack_flag(packed.flags, "alive"),
        silent=unpack_flag(packed.flags, "silent"),
        last_hb=packed.last_hb,
        declared_dead=unpack_flag(packed.flags, "declared_dead"),
        rewired=unpack_flag(packed.flags, "rewired"),
        rewire_targets=packed.rewire_targets,
        fault_held=unpack_bits(packed.fault_held, m),
        join_round=packed.join_round,
        admitted_by=packed.admitted_by,
        degree_credit=packed.degree_credit,
        slot_lease=packed.slot_lease,
        control_lvl=packed.control_lvl,
        pipe_buf=unpack_bits(packed.pipe_buf, m),
        suspect_round=packed.suspect_round,
        suspect_mark=packed.suspect_mark,
        quarantine=unpack_flag(packed.flags, "quarantine"),
        rng=packed.rng,
        round=packed.round,
    )
