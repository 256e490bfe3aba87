"""Adaptive protocol control plans: a bounded fanout/mix policy, compiled
on the host.

Ports ``tpu_gossip/control/plan.py``. A :class:`ControlSpec` is the
description of the feedback policy that closes the fanout loop inside the
round:

- **fanout table**: the effective fanouts ``[lo, lo+1, .., hi]``; the state
  carries one int32 cursor (``SwarmState.control_lvl``) into it. Each round
  the AIMD update (``control/engine.py``) widens the level when the
  delivery signals fall below ``target_ratio`` and halves it when the
  duplicate rate saturates.
- **push/push-pull mix**: the pull half runs at-or-below the static
  baseline fanout, while some live message sits in ``[pull_knee,
  target)`` coverage, and after an under-delivery round (the cursor's
  stress bit); the needy-pull gate (``pull_needy``, on by default for
  active bounds) stops peers that miss nothing live from issuing their
  request. The table's one extra stress rung (the widest fanout with the
  pull half on) is reachable only by widening; a clean cursor starts on
  the widest clean level, one below it.
- **PeerSwap refresh**: every ``refresh_every`` rounds each live re-wired
  peer swaps one fresh-edge slot for a new degree-preferential endpoint
  draw, on the re-wiring plane, from the control stream.

The spec holds no per-node table, so one compile serves every engine. A
zero-adjustment spec (``lo == hi == fanout``, ``refresh_every=0``)
reproduces the uncontrolled trajectory bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device

__all__ = [
    "ControlError",
    "ControlSpec",
    "compile_control",
]


class ControlError(ValueError):
    """A control config that cannot mean what it says (compile time)."""


@dataclasses.dataclass(frozen=True)
class ControlSpec:
    """A feedback-control policy: the tables and thresholds as tensors on
    the run's device, the shape of the policy as plain values. The cursor
    is ``SwarmState.control_lvl`` (-1: the first controlled round starts
    on ``start``)."""

    fanout_table: torch.Tensor  # int32 (L,): effective fanout per level
    pull_table: torch.Tensor  # bool (L,): run the pull half at this level
    target_ratio: torch.Tensor  # float32 (): the delivery-ratio target
    sat_dup: torch.Tensor  # float32 (): duplicate-rate saturation threshold
    pull_knee: torch.Tensor  # float32 (): slot coverage where pulls pay
    lo: int
    hi: int
    base: int
    levels: int
    start: int
    refresh_every: int
    ttl: int
    pull_needy: bool = False

    @property
    def base_idx(self) -> int:
        """Level index of the static baseline fanout (the shrink floor while
        any live message is under target)."""
        return self.base - self.lo


def compile_control(*, target_ratio: float, fanout: int, lo: int | None = None, hi: int | None = None,
                    refresh_every: int = 0, ttl: int = 0, sat_dup: float = 0.8, pull_knee: float = 0.0,
                    pull_needy: bool | None = None, device: str | torch.device = "cuda") -> ControlSpec:
    """Compile a feedback-control policy onto ``device``, with JAX's
    refusals and words. ``fanout`` is the static baseline and must lie in
    ``[lo, hi]`` (default ``[1, 2 * fanout]``); ``ttl`` is a stream's slot
    TTL (0 without one), ``refresh_every`` the PeerSwap cadence (0: off);
    ``pull_needy`` defaults to on exactly when the bounds are not pinned."""
    if not (0.0 < target_ratio <= 1.0):
        raise ControlError(
            f"target_ratio {target_ratio} outside (0, 1] — it is the "
            "delivery-ratio the controller defends"
        )
    if not (0.0 < sat_dup <= 1.0):
        raise ControlError(f"sat_dup {sat_dup} outside (0, 1]")
    if not (0.0 <= pull_knee <= 1.0):
        raise ControlError(f"pull_knee {pull_knee} outside [0, 1]")
    if lo is None:
        lo = 1
    if hi is None:
        hi = max(2 * fanout, fanout)
    if lo < 1:
        raise ControlError(f"fanout bound lo={lo} must be >= 1")
    if hi < lo:
        raise ControlError(f"fanout bounds lo={lo} > hi={hi}")
    if not (lo <= fanout <= hi):
        raise ControlError(
            f"static fanout {fanout} outside the control bounds "
            f"[{lo}, {hi}] — the policy must be able to express the "
            "uncontrolled rate"
        )
    if refresh_every < 0:
        raise ControlError(f"refresh_every {refresh_every} must be >= 0")
    if ttl < 0:
        raise ControlError(f"ttl {ttl} must be >= 0")
    dev = resolve_device(device)
    clean = np.arange(lo, hi + 1, dtype=np.int32)
    # anti-entropy at-or-below the baseline; the widened clean levels are
    # pure push (lo == hi == fanout keeps the pull half on everywhere)
    pull = clean <= fanout
    table = clean
    if hi > fanout:
        # the stress rung: the widest fanout with the pull half on
        table = np.concatenate([clean, np.asarray([hi], dtype=np.int32)])
        pull = np.concatenate([pull, np.asarray([True])])
    return ControlSpec(
        fanout_table=torch.from_numpy(table).to(dev),
        pull_table=torch.from_numpy(pull).to(dev),
        target_ratio=torch.tensor(target_ratio, dtype=torch.float32, device=dev),
        sat_dup=torch.tensor(sat_dup, dtype=torch.float32, device=dev),
        pull_knee=torch.tensor(pull_knee, dtype=torch.float32, device=dev),
        lo=int(lo), hi=int(hi), base=int(fanout), levels=int(len(table)), start=int(len(clean) - 1),
        refresh_every=int(refresh_every), ttl=int(ttl),
        pull_needy=bool((lo, hi) != (fanout, fanout) if pull_needy is None else pull_needy),
    )
