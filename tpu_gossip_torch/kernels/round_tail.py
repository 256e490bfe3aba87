"""The post-delivery round tail: every slot-plane pass in one traversal.

Ports ``tail_reference``, ``tail_fused`` and ``round_tail`` of
``tpu_gossip/kernels/round_tail.py``, and K3, the port of its Pallas
``tail_pallas`` (:263): :func:`tail_kernel` runs the whole tail as one CUDA
launch (``csrc/round_tail.cu``). The tail merges delivery into ``seen``,
latches ``infected_round`` (int16, saturated at ROUND_CAP), applies per-slot
SIR recovery, forward-once bookkeeping, and the churn fresh-row and
streaming expired-column resets. All forms are bit-identical: boolean
algebra and integer selects only.

On a CUDA tensor the ``"fused"`` (default) and ``"pallas"`` impls launch
K3; ``"reference"`` is for CPU tensors only and raises on CUDA, so the
card's main path never takes a plain version. The packed word tails (K4)
belong to a later slice.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.core.state import saturate_round
from tpu_gossip_torch.kernels import native

__all__ = ["TAIL_IMPLS", "round_tail", "tail_reference", "tail_fused", "tail_kernel"]

TAIL_IMPLS = ("fused", "reference", "pallas")


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
               expired=None):
    """Single-traversal form, each output one expression with the fresh
    row mask and expired column mask folded in; the plain version of K3."""
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
        new_rec = recovered | ((new_ir >= 0) & (rnd - new_ir.to(torch.int32) >= sir_recover_rounds))
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


def tail_kernel(seen, forwarded, infected_round, recovered, incoming, receptive,
                transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
                expired=None):
    """K3: the whole tail in one launch on CUDA tensors (``tail_fused`` on
    CPU tensors). When neither forward-once nor a reset touches
    ``forwarded`` it passes through untouched."""
    _check_tail(seen, forwarded, infected_round, recovered, incoming, receptive,
                transmit, fresh, expired)
    kw = dict(forward_once=forward_once, sir_recover_rounds=sir_recover_rounds, expired=expired)
    if seen.device.type == "cpu":
        return tail_fused(seen, forwarded, infected_round, recovered, incoming, receptive,
                          transmit, fresh, rnd, **kw)
    rnd16 = saturate_round(rnd.to(torch.int32), torch.int16).reshape(1).contiguous()
    operands = [seen, infected_round, recovered, incoming, receptive, forwarded, transmit, rnd16]
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
        rnd16.data_ptr(), n, m, int(forward_once), int(sir_recover_rounds),
        int(needs_fwd), native.stream_of(seen),
    )
    native.check(rc, "round_tail")
    native.LAUNCHES["round_tail"] += 1
    return o_seen, o_fwd, o_ir, o_rec


def round_tail(seen, forwarded, infected_round, recovered, incoming, receptive,
               transmit, fresh, rnd, *, forward_once: bool, sir_recover_rounds: int,
               expired=None, impl: str = "fused"):
    """Dispatch to a tail implementation; returns ``(seen, forwarded,
    infected_round, recovered)``."""
    if impl in ("packed", "packed_pallas"):
        raise NotImplementedError(
            f"tail impl {impl!r} (the packed word tail, K4) is not ported yet: "
            "it comes with the packed-state slice"
        )
    if impl not in TAIL_IMPLS:
        raise ValueError(f"unknown tail impl {impl!r}; choose from {TAIL_IMPLS}")
    kw = dict(forward_once=forward_once, sir_recover_rounds=sir_recover_rounds, expired=expired)
    args = (seen, forwarded, infected_round, recovered, incoming, receptive, transmit, fresh, rnd)
    if impl == "reference":
        if seen.device.type != "cpu":
            raise ValueError("tail impl 'reference' is the CPU oracle; on CUDA use 'fused' (K3)")
        return tail_reference(*args, **kw)
    return tail_kernel(*args, **kw)
