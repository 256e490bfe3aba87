"""Wire-protocol codecs: the de-facto API between reference processes.

The port's own copy of ``tpu_gossip/compat/wire.py``, byte-compatible with
it: the port's socket nodes (``compat/peer.py``, ``compat/seed.py``) and the
serving frontend (``serve/``) frame and parse with it, and the port
imports nothing of the JAX package.

One function pair per message of SURVEY.md §2.4. Text messages are
newline-terminated ASCII with Python-literal addresses parsed via
``ast.literal_eval`` (reference Peer.py:194, Seed.py:251,274); peer subsets
are pickled lists with a trailing newline (Seed.py:286,290). Unpickling is
restricted to tuples/lists/ints/strings — the reference calls bare
``pickle.loads`` on network bytes (Peer.py:103), which we do not reproduce.

The subset framing quirk is reproduced deliberately (SURVEY.md §2.6.9): the
payload is read with a single bounded ``read()`` and ``pickle`` ignores the
trailing bytes; there is no length prefix on the wire.
"""

from __future__ import annotations

import ast
import io
import pickle
from typing import Any

Addr = tuple[str, int]

SEED_HANDSHAKE_PREFIX = "I am seed|"
HEARTBEAT_PREFIX = "Heartbeat from "
DEAD_NODE_PREFIX = "Dead Node: "
NEW_NODE_PREFIX = "NewNodeUpdate|"
PING = "PING"


def _parse_addr(text: str) -> Addr:
    val = ast.literal_eval(text.strip())
    if (
        not isinstance(val, tuple)
        or len(val) != 2
        or not isinstance(val[0], str)
        or not isinstance(val[1], int)
    ):
        raise ValueError(f"not an (ip, port) tuple: {text!r}")
    return val


# --- peer → seed registration handshake (Peer.py:95-97 → Seed.py:273-274) ---

def encode_peer_handshake(addr: Addr) -> bytes:
    return (str(addr) + "\n").encode()


def decode_peer_handshake(line: str) -> Addr:
    return _parse_addr(line)


# --- seed ↔ seed handshake (Seed.py:307-308, 261-262) -----------------------

def encode_seed_handshake(addr: Addr) -> bytes:
    return (SEED_HANDSHAKE_PREFIX + str(addr) + "\n").encode()


def decode_seed_handshake(line: str) -> Addr:
    if not line.startswith(SEED_HANDSHAKE_PREFIX):
        raise ValueError(f"not a seed handshake: {line!r}")
    return _parse_addr(line[len(SEED_HANDSHAKE_PREFIX):])


# --- peer subset: seed → registering peer (Seed.py:286,290) -----------------

class _SubsetUnpickler(pickle.Unpickler):
    """Data-only unpickling: no global lookups at all."""

    def find_class(self, module: str, name: str):
        raise pickle.UnpicklingError(f"forbidden global {module}.{name}")


def encode_subset(subset: list[Addr]) -> bytes:
    return pickle.dumps(list(subset)) + b"\n"


def decode_subset(payload: bytes) -> list[Addr]:
    """Restricted-unpickle a subset; trailing bytes ignored (§2.6.9)."""
    got = _SubsetUnpickler(io.BytesIO(payload)).load()
    if not isinstance(got, list):
        raise ValueError("subset payload is not a list")
    return [_parse_addr(str(tuple(e))) for e in got]


# --- inter-seed topology replication (Seed.py:203-206 → 432-433) ------------

def encode_new_node_update(new_peer: Addr, subset: list[Addr]) -> bytes:
    """Known framing limitation (inherited from the reference's
    '|'-separated format, Seed.py:203-206): an ip string containing '|'
    is not representable — the decoder splits on the first '|' and will
    reject such a line as malformed rather than mis-parse it."""
    return f"{NEW_NODE_PREFIX}{new_peer}|{list(subset)}\n".encode()


def decode_new_node_update(line: str) -> tuple[Addr, list[Addr]]:
    if not line.startswith(NEW_NODE_PREFIX):
        raise ValueError(f"not a NewNodeUpdate: {line!r}")
    peer_part, subset_part = line[len(NEW_NODE_PREFIX):].split("|", 1)
    subset = ast.literal_eval(subset_part.strip())
    return _parse_addr(peer_part), [_parse_addr(str(tuple(e))) for e in subset]


# --- heartbeat / liveness (Peer.py:368, Seed.py:354-355) --------------------

def encode_heartbeat(addr: Addr) -> bytes:
    return (HEARTBEAT_PREFIX + str(addr) + "\n").encode()


def decode_heartbeat(line: str) -> Addr:
    # the reference splits on "from" + literal_eval (Peer.py:194-199)
    if HEARTBEAT_PREFIX not in line:
        raise ValueError(f"not a heartbeat: {line!r}")
    return _parse_addr(line.split("from", 1)[1])


def encode_ping() -> bytes:
    return (PING + "\n").encode()


# --- dead-node report (Peer.py:311-313 → Seed.py:358-406) -------------------

def encode_dead_node(addr: Addr) -> bytes:
    return (DEAD_NODE_PREFIX + str(addr) + "\n").encode()


def decode_dead_node(line: str) -> Addr:
    if not line.startswith(DEAD_NODE_PREFIX):
        raise ValueError(f"not a dead-node report: {line!r}")
    return _parse_addr(line[len(DEAD_NODE_PREFIX):])


# --- gossip payload (Peer.py:398-404) ---------------------------------------

def encode_gossip(timestamp: str, ip: str, port: int, count: int) -> bytes:
    """Gossip line '{ts}:{ip}:{port}:{count}'.

    Deliberate divergence from the reference's '{ts}:{ip}:{count}'
    (Peer.py:398-404): with hash-based dedup (which the reference lacks) the
    line is the message identity, and the reference format collides across
    peers sharing an ip + timestamp second; the port term makes identities
    unique per origin.
    """
    return f"{timestamp}:{ip}:{port}:{count}\n".encode()


def gossip_message_id(line: str) -> str:
    """The dedup identity of a gossip line: the full text."""
    return line.strip()


# --- dispatch ---------------------------------------------------------------

def classify(line: str | bytes) -> tuple[str, Any]:
    """Map an inbound line to (kind, decoded payload). TOTAL: never raises.

    Kinds: seed_handshake | heartbeat | ping | dead_node | new_node_update |
    gossip_or_text (everything else — the reference logs unknowns,
    Peer.py:206,286, Seed.py:440-441) | malformed (a recognized prefix whose
    payload fails to parse) | empty.

    Network bytes are untrusted, and the reader loops (compat/peer.py,
    compat/seed.py, serve/frontend.py) dispatch straight off this function: if it raised, one
    malformed address (or non-UTF-8 bytes, accepted here via
    ``errors="replace"``) would kill the connection's reader and leak the
    socket — the reference has exactly that latent bug (its per-connection
    thread dies in ``ast.literal_eval``, Peer.py:194-199). ``malformed``
    lines are for logging, like unknown text.
    """
    if isinstance(line, bytes):
        line = line.decode(errors="replace")
    s = line.strip()
    if not s:
        return "empty", None
    if s == PING:
        return "ping", None
    try:
        if s.startswith(SEED_HANDSHAKE_PREFIX):
            return "seed_handshake", decode_seed_handshake(s)
        if s.startswith(HEARTBEAT_PREFIX):
            return "heartbeat", decode_heartbeat(s)
        if s.startswith(DEAD_NODE_PREFIX):
            return "dead_node", decode_dead_node(s)
        if s.startswith(NEW_NODE_PREFIX):
            return "new_node_update", decode_new_node_update(s)
    except (ValueError, TypeError, SyntaxError, RecursionError, MemoryError):
        # ValueError covers _parse_addr rejects; TypeError covers subset
        # entries that aren't tuple-able (e.g. "NewNodeUpdate|('a',1)|5");
        # SyntaxError/RecursionError/MemoryError cover ast.literal_eval on
        # hostile payloads
        return "malformed", s
    return "gossip_or_text", s
