"""Scripted multi-client load generator for the serving frontend.

Ports ``tpu_gossip/serve/loadgen.py``: the same clients write the same
lines, so a load drives either package's frontend alike.

Real sockets, real threads — one thread per simulated reference client,
each writing the reference's gossip wire lines
(``compat.wire.encode_gossip``) with optional jittered pacing. ``chip_smoke.py``
phase 15 drives the frontend with it at full width; the trace-replay
tests use it for their live leg.

Determinism note: the PAYLOADS are deterministic given (clients, msgs,
seed) — what round each lands in is real wall-clock racing, which is
exactly the point: the trace plane (serve/trace.py) must make even a
raced live run replay bit for bit.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import NamedTuple

from tpu_gossip_torch.compat import wire

__all__ = ["LoadReport", "run_load"]


class LoadReport(NamedTuple):
    sent: int  # gossip lines written
    errors: int  # clients that died on a socket error
    message_ids: tuple  # every dedup identity offered (for delivery checks)


def _client(host, port, cid, msgs, jitter_s, seed, out, register):
    rng = random.Random(seed * 1000003 + cid)
    sent = []
    try:
        with socket.create_connection((host, port), timeout=10.0) as sock:
            if register:
                # the reference peer's registration line; the frontend
                # pins this client to its advertised identity's row
                sock.sendall(wire.encode_peer_handshake((f"10.0.{cid}.1", 5000 + cid)))
                sock.settimeout(10.0)
                sock.recv(65536)  # the (empty) subset reply
            for seq in range(msgs):
                line = wire.encode_gossip(f"t{seq}", f"10.0.{cid}.1",
                                          5000 + cid, seq)
                sock.sendall(line)
                sent.append(wire.gossip_message_id(line.decode()))
                if jitter_s > 0:
                    # jittered arrivals: uniform in (0, 2*jitter) keeps
                    # the MEAN rate while racing the round windows
                    time.sleep(rng.uniform(0.0, 2.0 * jitter_s))
    except (ConnectionError, OSError):
        out.append((sent, 1))
        return
    out.append((sent, 0))


def run_load(
    host: str,
    port: int,
    *,
    clients: int = 4,
    msgs_per_client: int = 8,
    jitter_s: float = 0.0,
    seed: int = 0,
    register: bool = True,
) -> LoadReport:
    """Run ``clients`` concurrent client threads; block until all finish."""
    out: list = []
    threads = [
        threading.Thread(
            target=_client,
            args=(host, port, cid, msgs_per_client, jitter_s, seed, out,
                  register),
            daemon=True,
        )
        for cid in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    sent: list = []
    errors = 0
    for ids, err in out:
        sent.extend(ids)
        errors += err
    return LoadReport(sent=len(sent), errors=errors, message_ids=tuple(sent))
