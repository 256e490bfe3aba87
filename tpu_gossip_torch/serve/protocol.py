"""Serving view of the reference wire protocol (compat/wire.py).

Ports ``tpu_gossip/serve/protocol.py``: the same events, the same FNV-1a
hash and the same slot map, so a line hashed by either package lands on
the same slots and a trace written by one replays in the other.

The frontend speaks EXACTLY the reference's newline-framed messages —
the codecs live once in ``compat/wire.py`` and this module only adds
the serving semantics on top:

- :func:`parse_line` — TOTAL parse of one inbound line into a typed
  :class:`ServeEvent` (never raises; malformed lines are events too, so
  one hostile client cannot kill a reader loop — the latent reference
  bug ``wire.classify`` documents).
- :func:`payload_hash64` — the stable 64-bit FNV-1a over a gossip
  line's dedup identity (``wire.gossip_message_id``). This integer IS
  what the trace plane records (serve/trace.py): live ingestion and
  pure-sim replay both map it to slots through
  :func:`~tpu_gossip_torch.core.state.message_slots`, so the slot draw agrees
  by construction on both sides of the socket boundary.
- ``QUERY <name>`` — one serving extension: a client line asking for
  the driver's between-round metrics (liveness/coverage/reliability).
  The reference logs unknown text (Peer.py:206); a reference peer
  pointed at this frontend sees its unknown-text behavior unchanged.
"""

from __future__ import annotations

from typing import Any, NamedTuple

from tpu_gossip_torch.compat import wire
from tpu_gossip_torch.core.state import message_slots

__all__ = [
    "QUERY_PREFIX",
    "ServeEvent",
    "parse_line",
    "payload_hash64",
    "slots_for_payload",
    "encode_query",
    "encode_query_reply",
]

QUERY_PREFIX = "QUERY "

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


class ServeEvent(NamedTuple):
    """One parsed inbound line.

    ``kind`` extends ``wire.classify``'s catalog with the serving
    dispositions: ``register`` (a bare peer handshake — the
    registration line Seed.py:273-274 accepts), ``gossip`` (a payload
    to disseminate: carries ``message_id`` + ``payload_hash``) and
    ``query`` (the metrics extension). Everything else keeps the wire
    kind (heartbeat / ping / dead_node / seed_handshake /
    new_node_update / malformed / empty) with the decoded payload.
    """

    kind: str
    payload: Any  # decoded wire payload (addr, tuple, query name, ...)
    message_id: str | None = None  # gossip only: the dedup identity
    payload_hash: int | None = None  # gossip only: payload_hash64(message_id)


def payload_hash64(message_id: str) -> int:
    """64-bit FNV-1a over the dedup identity — the trace-plane integer.

    Host-side and pure-Python on purpose: the SAME function runs in the
    live frontend and in trace replay, and
    :func:`~tpu_gossip_torch.core.state.message_slots` maps the integer to
    slot draws identically on both paths (ints hash through their
    64-bit little-endian bytes there, so the full 64 bits count).
    """
    h = _FNV64_OFFSET
    for b in message_id.encode():
        h ^= b
        h = (h * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def slots_for_payload(payload_hash: int, msg_slots: int, k: int) -> tuple:
    """The k dedup slots of one payload hash — the host twin of the
    stream plane's uniform slot draws, shared with replay."""
    return message_slots(payload_hash, msg_slots, k)


def parse_line(line: str | bytes) -> ServeEvent:
    """Map one inbound line to a :class:`ServeEvent`. TOTAL: never raises."""
    kind, payload = wire.classify(line)
    if kind != "gossip_or_text":
        return ServeEvent(kind, payload)
    s = payload  # classify's gossip_or_text payload is the stripped line
    if s.startswith(QUERY_PREFIX):
        return ServeEvent("query", s[len(QUERY_PREFIX):].strip())
    # a bare "('ip', port)" line is the reference's peer-registration
    # handshake (Seed.py:273-274 reads it off the same catch-all path)
    try:
        return ServeEvent("register", wire.decode_peer_handshake(s))
    except (ValueError, SyntaxError):
        pass
    mid = wire.gossip_message_id(s)
    return ServeEvent("gossip", s, message_id=mid,
                      payload_hash=payload_hash64(mid))


def encode_query(name: str) -> bytes:
    """Client side of the metrics extension."""
    return (QUERY_PREFIX + name + "\n").encode()


def encode_query_reply(payload: str) -> bytes:
    """One newline-framed reply line (JSON by convention, driver-owned)."""
    return (payload.replace("\n", " ") + "\n").encode()
