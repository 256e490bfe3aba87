"""Adaptive protocol control: the coverage-feedback fanout, the
push/push-pull mix and the PeerSwap neighbour refresh.

Ports ``tpu_gossip/control/``: ``compile_control`` (``control/plan.py``)
builds the :class:`ControlSpec`; the round hooks are
``control/engine.py``'s and run inside every engine's round.
"""

from tpu_gossip_torch.control.engine import (
    CONTROL_STREAM_SALT,
    ControlTelemetry,
    RoundControl,
    apply_control,
    control_round,
)
from tpu_gossip_torch.control.plan import ControlError, ControlSpec, compile_control

__all__ = [
    "CONTROL_STREAM_SALT",
    "ControlError",
    "ControlSpec",
    "ControlTelemetry",
    "RoundControl",
    "compile_control",
    "control_round",
    "apply_control",
]
