"""Async socket frontend: many concurrent reference clients, one swarm.

Ports ``tpu_gossip/serve/frontend.py``: the same windows, the same
overflow billing and the same client-to-row map, so a live run of either
package records the trace the other replays.

The reference peer loop serves ONE socket per neighbor with a blocking
``sendall`` per line (reference Peer.py:395-408 — see PARITY.md,
"Overlapped rounds"). This frontend inverts that shape: one asyncio
server accepts any number of concurrent clients speaking the same wire
protocol, and the arrivals of each round window are batched into the
static-shape :class:`~tpu_gossip_torch.traffic.InjectBatch` the device round
consumes, so the swarm disseminates everything in O(diameter) batched
rounds instead of O(neighbors) blocking sends.

Threading model: the asyncio loop runs on a daemon background thread;
reader callbacks append accepted gossip to a lock-guarded pending
queue. The round driver (serve/driver.py, main thread) calls
:meth:`ServeFrontend.take_window` once per round — deferred arrivals
from past windows drain FIRST (FIFO), anything beyond ``max_inject``
stays deferred and is billed into that window's overflow count.
Carried, counted, never dropped silently.

Client → peer mapping: a client's peername hashes (FNV-1a 64) onto the
``origin_rows`` table the caller provides — for the local engines
that's the live state rows themselves; sharded callers pass rows
already run through their ``to_rows`` layout map. A reference client
that sends an explicit ``"('ip', port)"`` registration line is pinned
to the row its REGISTERED identity hashes to (the reference keys peers
by advertised identity, not by transport peername).
"""

from __future__ import annotations

import asyncio
import collections
import json
import threading
from typing import Optional, Sequence

from tpu_gossip_torch.compat import wire
from tpu_gossip_torch.compat.netutil import close_server_best_effort
from tpu_gossip_torch.serve.protocol import (
    encode_query_reply,
    parse_line,
    payload_hash64,
)

__all__ = ["FrontendCounters", "ServeFrontend", "origin_for_addr"]


def origin_for_addr(addr, n_origins: int) -> int:
    """Deterministic client-identity → origin-table index."""
    ip, port = addr
    return payload_hash64(f"{ip}:{port}") % n_origins


class FrontendCounters:
    """Host-side tallies, surfaced verbatim in the summary JSON."""

    def __init__(self):
        self.accepted = 0  # gossip lines queued for injection
        self.overflow_billed = 0  # window-overflow total (sum over rounds)
        self.malformed = 0  # lines wire.classify rejects
        self.heartbeats = 0
        self.pings = 0
        self.registrations = 0
        self.queries = 0
        self.clients_seen = 0

    def as_dict(self) -> dict:
        return dict(vars(self))


class ServeFrontend:
    """Accepts reference-protocol clients; hands the driver round windows."""

    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        origin_rows: Sequence[int],
        max_inject: int,
        query_snapshot=None,  # () -> dict, driver-owned, may be None
    ):
        if not len(origin_rows):
            raise ValueError("origin_rows must be non-empty")
        self.host = host
        self.port = port  # rebound to the real port once listening
        self.origin_rows = [int(r) for r in origin_rows]
        self.max_inject = int(max_inject)
        self.query_snapshot = query_snapshot
        self.counters = FrontendCounters()

        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._deferred: collections.deque = collections.deque()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()  # live per-connection handler tasks
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None

    # -- lifecycle (driver thread) --------------------------------------

    def start(self, timeout: float = 10.0) -> None:
        """Bind and serve on a daemon background thread.

        Raises the underlying ``OSError`` here, on the caller's thread,
        if the bind fails (port conflict) — the CLI maps that to exit 2.
        """
        self._thread = threading.Thread(
            target=self._thread_main, name="serve-frontend", daemon=True
        )
        self._thread.start()
        if not self._started.wait(timeout):
            raise TimeoutError("frontend failed to start listening")
        if self._start_error is not None:
            raise self._start_error

    def stop(self) -> None:
        loop = self._loop
        if loop is None or not loop.is_running():
            return
        fut = asyncio.run_coroutine_threadsafe(self._shutdown(), loop)
        try:
            fut.result(timeout=10.0)
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _thread_main(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._serve_forever())
        finally:
            loop.close()

    async def _serve_forever(self) -> None:
        self._stop_ev = asyncio.Event()
        try:
            self._server = await asyncio.start_server(
                self._on_connection, self.host, self.port
            )
            self.port = self._server.sockets[0].getsockname()[1]
        except BaseException as exc:  # surface bind failures to start()
            self._start_error = exc
            self._started.set()
            return
        self._started.set()
        try:
            await self._stop_ev.wait()
        finally:
            server, self._server = self._server, None
            await close_server_best_effort(server)
            for task in list(self._conns):
                task.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)

    async def _shutdown(self) -> None:
        self._stop_ev.set()

    # -- connection handling (frontend thread) --------------------------

    async def _on_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
        peername = writer.get_extra_info("peername") or ("?", 0)
        origin = self.origin_rows[origin_for_addr(peername, len(self.origin_rows))]
        self.counters.clients_seen += 1
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                origin = await self._handle_line(line, origin, writer)
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass
        finally:
            if task is not None:
                self._conns.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_line(self, line: bytes, origin: int, writer) -> int:
        """Dispatch one inbound line; returns the (possibly re-pinned)
        origin row for this connection."""
        ev = parse_line(line)
        if ev.kind == "gossip":
            with self._lock:
                self._pending.append((origin, ev.payload_hash))
            self.counters.accepted += 1
        elif ev.kind == "register":
            # pin to the ADVERTISED identity's row and reply with an
            # (empty) subset, the seed's registration contract
            # (reference Seed.py:286-289)
            origin = self.origin_rows[
                origin_for_addr(ev.payload, len(self.origin_rows))
            ]
            self.counters.registrations += 1
            writer.write(wire.encode_subset([]))
            await writer.drain()
        elif ev.kind == "ping":
            self.counters.pings += 1
            writer.write(wire.encode_heartbeat((self.host, self.port)))
            await writer.drain()
        elif ev.kind == "heartbeat":
            self.counters.heartbeats += 1
        elif ev.kind == "query":
            self.counters.queries += 1
            snap = self.query_snapshot() if self.query_snapshot else {}
            writer.write(encode_query_reply(json.dumps(
                snap.get(ev.payload, snap) if ev.payload else snap
            )))
            await writer.drain()
        elif ev.kind in ("malformed",):
            self.counters.malformed += 1
        # seed_handshake / dead_node / new_node_update / empty: liveness
        # chatter with no injection effect — accepted and dropped, as the
        # reference's catch-all text path does.
        return origin

    # -- round windows (driver thread) ----------------------------------

    def take_window(self) -> tuple[list, int]:
        """Pop this round's arrivals: ``([(origin, hash), ...], overflow)``.

        Deferred arrivals from earlier windows drain first; at most
        ``max_inject`` are returned. The excess stays deferred for the
        NEXT window and is billed as this window's overflow count.
        """
        with self._lock:
            self._deferred.extend(self._pending)
            self._pending.clear()
            window = [
                self._deferred.popleft()
                for _ in range(min(self.max_inject, len(self._deferred)))
            ]
            overflow = len(self._deferred)
        self.counters.overflow_billed += overflow
        return window, overflow

    def backlog(self) -> int:
        with self._lock:
            return len(self._pending) + len(self._deferred)
