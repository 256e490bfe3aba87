"""The PRNG stream-salt registry: the one map of parallel streams.

A copy of ``tpu_gossip/core/streams.py`` (pure host code). Every subsystem
that draws beside the protocol's 5-way round split derives its stream as
``prng.fold_in(state.rng, SALT)``, so a subsystem that is switched off
leaves the protocol's draws as they were. Salts must be unique and at or
above :data:`STREAM_SALT_FLOOR` (clear of any ``split`` child index);
:func:`register_stream` asserts both at import. The fault plane's
``FAULT_STREAM_SALT`` is the one the port uses so far; the others are
registered so their values stay reserved.
"""

from __future__ import annotations

__all__ = [
    "STREAM_SALT_FLOOR",
    "FAULT_STREAM_SALT",
    "GROWTH_STREAM_SALT",
    "TRAFFIC_STREAM_SALT",
    "CONTROL_STREAM_SALT",
    "FLEET_STREAM_SALT",
    "ADVERSARY_STREAM_SALT",
    "register_stream",
    "registered_salts",
]

# fold_in(key, d) and split(key, n) index threefry counters off the same
# parent key; salts at or above this floor can never alias a split child
# of any fan-out the codebase uses (the widest split is the protocol's
# 5-way; 2**16 leaves four orders of magnitude of margin)
STREAM_SALT_FLOOR = 0x10000

_REGISTRY: dict[str, int] = {}


def register_stream(name: str, salt: int) -> int:
    """Register a named PRNG stream salt; returns ``salt``.

    Raises at import time on a duplicate name, a colliding salt value, or
    a salt below :data:`STREAM_SALT_FLOOR` — collisions must be
    impossible to ship, not merely linted.
    """
    if not isinstance(salt, int) or not (STREAM_SALT_FLOOR <= salt < 2**63):
        raise ValueError(
            f"stream salt {name!r}={salt!r} outside "
            f"[{STREAM_SALT_FLOOR:#x}, 2**63) — small salts can alias "
            "split() children of the same parent key"
        )
    if name in _REGISTRY:
        raise ValueError(f"stream name {name!r} already registered")
    for other, s in _REGISTRY.items():
        if s == salt:
            raise ValueError(
                f"stream salt collision: {name!r} and {other!r} both use "
                f"{salt:#x} — the two subsystems would read the SAME "
                "fold_in stream and correlate their draws"
            )
    _REGISTRY[name] = salt
    return salt


def registered_salts() -> dict[int, str]:
    """salt -> stream name."""
    return {salt: name for name, salt in _REGISTRY.items()}


# the stream map:
#
#   stream     salt         consumer                         draws
#   fault      0x5CE7A510   faults/inject.py (scenarios)     loss/delay/blackout
#   growth     0x9087A110   growth/engine.py (admission)     Gumbel-top-k targets
#   traffic    0x7AFF1C00   traffic/engine.py (injection)    arrivals/origins/slots
#   control    0xC0274201   control/engine.py (PeerSwap)     neighbor-refresh swaps
#   fleet      0xF1EE7C42   fleet/plan.py (campaign lanes)   per-lane root keys
#   adversary  0xADE57A17   faults/ + sim/stages.py          accusation victims /
#                           (Byzantine attack plane)         forge + flood targets
FAULT_STREAM_SALT = register_stream("fault", 0x5CE7A510)
GROWTH_STREAM_SALT = register_stream("growth", 0x9087A110)
TRAFFIC_STREAM_SALT = register_stream("traffic", 0x7AFF1C00)
CONTROL_STREAM_SALT = register_stream("control", 0xC0274201)
# lane k of a fleet campaign runs on root key
# fold_in(fold_in(campaign_key, FLEET_STREAM_SALT), k); nothing splits the
# salted parent
FLEET_STREAM_SALT = register_stream("fleet", 0xF1EE7C42)
# the Byzantine attack plane: one fold a round, split into the
# accusation, forgery and flood children, all drawn at global shape
ADVERSARY_STREAM_SALT = register_stream("adversary", 0xADE57A17)
