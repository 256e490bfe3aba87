"""The post-delivery round tail: every slot-plane pass in one traversal.

Ports ``tail_reference``, ``tail_fused``, ``round_tail_words``,
``tail_packed`` and ``round_tail`` of ``tpu_gossip/kernels/round_tail.py``,
with its two Pallas kernels written in CUDA: K3, the port of ``tail_pallas``
(:263), runs the whole tail on the bool planes as one launch
(:func:`tail_kernel`, ``csrc/round_tail.cu``), and K4, the port of
``round_tail_words(pallas=True)`` (:444), runs it on the packed uint8 words
(:func:`round_tail_words`, ``csrc/round_tail_words.cu``). The tail merges
delivery into ``seen``, latches ``infected_round`` (int16, saturated at
ROUND_CAP), applies per-slot SIR recovery, forward-once bookkeeping, and
the churn fresh-row and streaming expired-column resets: boolean algebra
and integer selects only.

The JAX package computes the SIR age two ways. Its XLA tails
(``tail_fused``, the word chain) subtract the latch from the wide int32
round; its Pallas kernels see only the round saturated to int16. The two
agree until a run passes ROUND_CAP. Each port impl equals its JAX
namesake: ``"fused"`` (and ``"reference"``, ``"packed"``) take the wide age,
``"pallas"`` (and ``"packed_pallas"``) the saturated one, the
``age_saturated`` flag of K3 and K4 and of their plain versions.

On a CUDA tensor ``"fused"`` and ``"pallas"`` launch K3, and ``"packed"``
and ``"packed_pallas"`` launch K4 (the word chain is their plain version,
for CPU tensors only); ``"reference"`` is for CPU tensors only and raises
on CUDA, so the card's main path never takes a plain version.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core.packed import pack_bits, unpack_bits
from tpu_gossip_torch.core.state import saturate_round
from tpu_gossip_torch.kernels import native

__all__ = ["TAIL_IMPLS", "round_tail", "round_tail_words", "tail_reference", "tail_fused",
           "tail_kernel", "tail_packed", "tail_words_plain"]

TAIL_IMPLS = ("fused", "reference", "pallas", "packed", "packed_pallas")


def _sir_age(rnd: torch.Tensor, age_saturated: bool) -> torch.Tensor:
    """The round the SIR age is taken from: wide (the XLA tails) or
    saturated at the int16 plane width (the Pallas kernels)."""
    rnd = rnd.to(torch.int32)
    return saturate_round(rnd, torch.int16).to(torch.int32) if age_saturated else rnd


def tail_reference(seen, forwarded, infected_round, recovered, incoming, receptive,
                   transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
                   expired=None):
    """The historical pass sequence: merge, latch and SIR, then the fresh
    and expired resets as further sweeps (the bitwise oracle)."""
    inc = incoming & receptive
    new_seen = seen | inc
    new_fwd = (forwarded | transmit) if forward_once else forwarded
    newly = inc & ~seen
    new_ir = torch.where(
        newly & (infected_round < 0), saturate_round(rnd, infected_round.dtype), infected_round
    )
    new_rec = recovered
    if sir_recover_rounds > 0:
        new_rec = recovered | (
            (new_ir >= 0) & (rnd - new_ir.to(torch.int32) >= sir_recover_rounds)
        )
    if fresh is not None:
        fc = fresh[:, None]
        new_seen = new_seen & ~fc
        new_fwd = new_fwd & ~fc
        new_ir = torch.where(fc, -1, new_ir).to(infected_round.dtype)
        new_rec = new_rec & ~fc
    if expired is not None:
        ec = expired[None, :]
        new_seen = new_seen & ~ec
        new_fwd = new_fwd & ~ec
        new_ir = torch.where(ec, -1, new_ir).to(infected_round.dtype)
        new_rec = new_rec & ~ec
    return new_seen, new_fwd, new_ir, new_rec


def tail_fused(seen, forwarded, infected_round, recovered, incoming, receptive,
               transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
               expired=None, age_saturated: bool = False):
    """Single-traversal form, each output one expression with the fresh
    row mask and expired column mask folded in; the plain version of K3.
    ``age_saturated`` takes the SIR age from the saturated round, as
    ``tail_pallas`` does (False: JAX ``tail_fused``)."""
    inc = incoming & receptive
    keep = None
    if fresh is not None:
        keep = ~fresh[:, None]
    if expired is not None:
        ec = ~expired[None, :]
        keep = ec if keep is None else keep & ec
    new_seen = (seen | inc) if keep is None else ((seen | inc) & keep)
    if forward_once:
        new_fwd = (forwarded | transmit) if keep is None else ((forwarded | transmit) & keep)
    else:
        new_fwd = forwarded if keep is None else (forwarded & keep)
    latch = (inc & ~seen) & (infected_round < 0)
    new_ir = torch.where(latch, saturate_round(rnd, infected_round.dtype), infected_round)
    if sir_recover_rounds > 0:
        age = _sir_age(rnd, age_saturated)
        new_rec = recovered | ((new_ir >= 0) & (age - new_ir.to(torch.int32) >= sir_recover_rounds))
    else:
        new_rec = recovered
    if keep is not None:
        new_ir = torch.where(keep, new_ir, -1).to(infected_round.dtype)
        new_rec = new_rec & keep
    return new_seen, new_fwd, new_ir, new_rec


def _check_tail(seen, forwarded, infected_round, recovered, incoming, receptive,
                transmit, fresh, expired) -> None:
    n, m = seen.shape
    for name, t in (("seen", seen), ("forwarded", forwarded), ("recovered", recovered),
                    ("incoming", incoming), ("receptive", receptive), ("transmit", transmit)):
        if t.dtype != torch.bool or tuple(t.shape) != (n, m):
            raise ValueError(f"tail: {name} must be ({n}, {m}) bool, got {t.dtype} {tuple(t.shape)}")
    if infected_round.dtype != torch.int16 or tuple(infected_round.shape) != (n, m):
        raise ValueError("tail: infected_round must be (N, M) int16")
    if fresh is not None and (fresh.dtype != torch.bool or tuple(fresh.shape) != (n,)):
        raise ValueError("tail: fresh must be (N,) bool")
    if expired is not None and (expired.dtype != torch.bool or tuple(expired.shape) != (m,)):
        raise ValueError("tail: expired must be (M,) bool")


def _rounds(rnd: torch.Tensor, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The round as the one-element device buffers K3 and K4 read: int16
    saturated (what the latch stores) and int32 wide."""
    rnd32 = torch.as_tensor(rnd, device=dev).to(torch.int32).reshape(1).contiguous()
    return saturate_round(rnd32, torch.int16), rnd32


def tail_kernel(seen, forwarded, infected_round, recovered, incoming, receptive,
                transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
                expired=None, age_saturated: bool = False):
    """K3: the whole tail in one launch on CUDA tensors (``tail_fused`` on
    CPU tensors). When neither forward-once nor a reset touches
    ``forwarded`` it passes through untouched."""
    _check_tail(seen, forwarded, infected_round, recovered, incoming, receptive,
                transmit, fresh, expired)
    kw = dict(forward_once=forward_once, sir_recover_rounds=sir_recover_rounds, expired=expired,
              age_saturated=age_saturated)
    if seen.device.type == "cpu":
        return tail_fused(seen, forwarded, infected_round, recovered, incoming, receptive,
                          transmit, fresh, rnd, **kw)
    rnd16, rnd32 = _rounds(rnd, seen.device)
    operands = [seen, infected_round, recovered, incoming, receptive, forwarded, transmit, rnd16, rnd32]
    operands += [t for t in (fresh, expired) if t is not None]
    native.require_cuda("round_tail", *operands)
    n, m = seen.shape
    needs_fwd = forward_once or fresh is not None or expired is not None
    o_seen = torch.empty_like(seen)
    o_ir = torch.empty_like(infected_round)
    o_rec = torch.empty_like(recovered)
    o_fwd = torch.empty_like(forwarded) if needs_fwd else forwarded
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = native.library("round_tail").round_tail(
        seen.data_ptr(), infected_round.data_ptr(), recovered.data_ptr(),
        incoming.data_ptr(), receptive.data_ptr(), forwarded.data_ptr(),
        transmit.data_ptr(), ptr(fresh), ptr(expired),
        o_seen.data_ptr(), o_ir.data_ptr(), o_rec.data_ptr(), o_fwd.data_ptr(),
        rnd16.data_ptr(), rnd32.data_ptr(), n, m, int(forward_once), int(sir_recover_rounds),
        int(needs_fwd), int(age_saturated), native.stream_of(seen),
    )
    native.check(rc, "round_tail")
    native.LAUNCHES["round_tail"] += 1
    return o_seen, o_fwd, o_ir, o_rec


def tail_words_plain(seen_w, forwarded_w, infected_round, recovered_w, incoming_w, receptive_w,
                     transmit_w, fresh, rnd, *, m: int, forward_once: bool, sir_recover_rounds: int,
                     expired=None, age_saturated: bool = False):
    """The XLA word chain of ``round_tail_words`` (:542): the plain version
    of K4. Word planes in and out; the int16 latch decodes ``inc & ~seen``
    once and SIR re-encodes its recovery bits."""
    inc_w = incoming_w & receptive_w
    keep_w = None
    if fresh is not None:
        keep_w = torch.where(fresh[:, None], 0, torch.full_like(seen_w[:1], 0xFF))
    if expired is not None:
        ec = pack_bits(~expired)[None, :]  # pack after NOT: padding stays 0
        keep_w = ec if keep_w is None else keep_w & ec
    new_seen = (seen_w | inc_w) if keep_w is None else ((seen_w | inc_w) & keep_w)
    new_fwd = (forwarded_w | transmit_w) if forward_once else forwarded_w
    if keep_w is not None:
        new_fwd = new_fwd & keep_w
    newly = unpack_bits(inc_w & ~seen_w, m)
    new_ir = torch.where(newly & (infected_round < 0), saturate_round(rnd, infected_round.dtype),
                         infected_round)
    if sir_recover_rounds > 0:
        age = _sir_age(rnd, age_saturated)
        new_rec = recovered_w | pack_bits((new_ir >= 0) & (age - new_ir.to(torch.int32) >= sir_recover_rounds))
    else:
        new_rec = recovered_w
    if fresh is not None:
        new_ir = torch.where(fresh[:, None], -1, new_ir).to(infected_round.dtype)
    if expired is not None:
        new_ir = torch.where(expired[None, :], -1, new_ir).to(infected_round.dtype)
    if keep_w is not None:
        new_rec = new_rec & keep_w
    return new_seen, new_fwd, new_ir, new_rec


def _check_tail_words(seen_w, forwarded_w, infected_round, recovered_w, incoming_w, receptive_w,
                      transmit_w, fresh, expired, m: int) -> None:
    n = seen_w.shape[0]
    w = -(-m // 8)
    for name, t in (("seen", seen_w), ("forwarded", forwarded_w), ("recovered", recovered_w),
                    ("incoming", incoming_w), ("receptive", receptive_w), ("transmit", transmit_w)):
        if t.dtype != torch.uint8 or tuple(t.shape) != (n, w):
            raise ValueError(f"tail words: {name} must be ({n}, {w}) uint8, got {t.dtype} {tuple(t.shape)}")
    if infected_round.dtype != torch.int16 or tuple(infected_round.shape) != (n, m):
        raise ValueError(f"tail words: infected_round must be ({n}, {m}) int16")
    if fresh is not None and (fresh.dtype != torch.bool or tuple(fresh.shape) != (n,)):
        raise ValueError("tail words: fresh must be (N,) bool")
    if expired is not None and (expired.dtype != torch.bool or tuple(expired.shape) != (m,)):
        raise ValueError("tail words: expired must be (M,) bool")


def round_tail_words(seen_w, forwarded_w, infected_round, recovered_w, incoming_w, receptive_w,
                     transmit_w, fresh, rnd, *, m: int, forward_once: bool, sir_recover_rounds: int,
                     expired=None, pallas: bool = False):
    """The packed-native tail on ``(N, ceil(m/8))`` uint8 words; returns
    ``(seen, forwarded, infected_round, recovered)``. On CUDA tensors K4,
    whatever ``pallas`` says; on CPU tensors the word chain. ``pallas``
    selects the SIR age as JAX's two forms compute it: False wide (the XLA
    word chain), True saturated (the Pallas kernel)."""
    _check_tail_words(seen_w, forwarded_w, infected_round, recovered_w, incoming_w, receptive_w,
                      transmit_w, fresh, expired, m)
    kw = dict(m=m, forward_once=forward_once, sir_recover_rounds=sir_recover_rounds, expired=expired,
              age_saturated=pallas)
    if seen_w.device.type == "cpu":
        return tail_words_plain(seen_w, forwarded_w, infected_round, recovered_w, incoming_w,
                                receptive_w, transmit_w, fresh, rnd, **kw)
    rnd16, rnd32 = _rounds(rnd, seen_w.device)
    operands = [seen_w, infected_round, recovered_w, incoming_w, receptive_w, forwarded_w, transmit_w,
                rnd16, rnd32]
    operands += [t for t in (fresh, expired) if t is not None]
    native.require_cuda("round_tail_words", *operands)
    n = seen_w.shape[0]
    needs_fwd = forward_once or fresh is not None or expired is not None
    o_seen = torch.empty_like(seen_w)
    o_ir = torch.empty_like(infected_round)
    o_rec = torch.empty_like(recovered_w)
    o_fwd = torch.empty_like(forwarded_w) if needs_fwd else forwarded_w
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = native.library("round_tail_words").round_tail_words(
        seen_w.data_ptr(), infected_round.data_ptr(), recovered_w.data_ptr(),
        incoming_w.data_ptr(), receptive_w.data_ptr(), forwarded_w.data_ptr(),
        transmit_w.data_ptr(), ptr(fresh), ptr(expired),
        o_seen.data_ptr(), o_ir.data_ptr(), o_rec.data_ptr(), o_fwd.data_ptr(),
        rnd16.data_ptr(), rnd32.data_ptr(), n, m, int(forward_once), int(sir_recover_rounds),
        int(needs_fwd), int(pallas), native.stream_of(seen_w),
    )
    native.check(rc, "round_tail_words")
    native.LAUNCHES["round_tail_words"] += 1
    return o_seen, o_fwd, o_ir, o_rec


def tail_packed(seen, forwarded, infected_round, recovered, incoming, receptive,
                transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
                expired=None, pallas: bool = False):
    """Bool-signature shell over :func:`round_tail_words`: packs the
    full-width operands, runs the word tail, unpacks the outputs."""
    m = seen.shape[-1]
    seen_w, fwd_w, ir, rec_w = round_tail_words(
        pack_bits(seen), pack_bits(forwarded), infected_round, pack_bits(recovered),
        pack_bits(incoming), pack_bits(receptive), pack_bits(transmit), fresh, rnd,
        m=m, forward_once=forward_once, sir_recover_rounds=sir_recover_rounds,
        expired=expired, pallas=pallas,
    )
    return unpack_bits(seen_w, m), unpack_bits(fwd_w, m), ir, unpack_bits(rec_w, m)


def round_tail(seen, forwarded, infected_round, recovered, incoming, receptive,
               transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
               expired=None, impl: str = "fused"):
    """Dispatch to a tail implementation; returns ``(seen, forwarded,
    infected_round, recovered)``."""
    if impl not in TAIL_IMPLS:
        raise ValueError(f"unknown tail impl {impl!r}; choose from {TAIL_IMPLS}")
    kw = dict(forward_once=forward_once, sir_recover_rounds=sir_recover_rounds, expired=expired)
    args = (seen, forwarded, infected_round, recovered, incoming, receptive, transmit, fresh, rnd)
    if impl == "reference":
        if seen.device.type != "cpu":
            raise ValueError("tail impl 'reference' is the CPU oracle; on CUDA use 'fused' (K3)")
        return tail_reference(*args, **kw)
    if impl in ("packed", "packed_pallas"):
        return tail_packed(*args, pallas=impl == "packed_pallas", **kw)
    return tail_kernel(*args, age_saturated=impl == "pallas", **kw)
