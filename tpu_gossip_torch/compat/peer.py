"""Peer node: bootstrap, push gossip with epidemic relay, liveness detector
(the port's own copy of ``tpu_gossip/compat/peer.py``, wire-compatible
with it).

Asyncio re-design of the reference's peer (reference Peer.py:12-465).
Same protocol surface — quorum registration against ⌊n/2⌋+1 seeds
(Peer.py:74-84), first-subset latch with settle delay (Peer.py:104-110),
heartbeat broadcast (Peer.py:365-393), stale→PING→grace→dead detector
(Peer.py:298-363), silent-mode fault injection (Peer.py:437-439) — with the
north-star generalization the reference lacks: received gossip is
deduplicated by message id and RELAYED to the peer's other neighbors
(epidemic flooding), where the reference only logs it (Peer.py:286,206).
``gossip_relay=False`` reproduces the reference's one-hop behavior for
conformance runs.

``transport="tpu-sim"`` keeps the same constructor but registers the peer
into a :class:`~tpu_gossip_torch.compat.simnet.SimCluster`, which runs the
whole swarm as batched device rounds (BASELINE.json north star).
"""

from __future__ import annotations

import asyncio
import datetime
import os
import time
from typing import Callable

from tpu_gossip_torch.compat import wire
from tpu_gossip_torch.compat.netutil import close_server_best_effort
from tpu_gossip_torch.compat.seed import load_config
from tpu_gossip_torch.compat.timing import ProtocolTiming
from tpu_gossip_torch.compat.wire import Addr

__all__ = ["PeerNode"]


# the longest a bootstrapping peer waits for its seeds' registration replies
# past the settle delay (a seed that accepted the link but never replies)
REPLY_WAIT_S = 10.0


class _Conn:
    """One live peer link (either direction)."""

    __slots__ = ("writer", "last_hb", "identity")

    def __init__(self, writer: asyncio.StreamWriter, identity: Addr | None):
        self.writer = writer
        self.last_hb = time.monotonic()
        # listening address claimed in heartbeats — an incoming connection's
        # ephemeral port is not the peer's listening port (Peer.py:33-35)
        self.identity = identity


class PeerNode:
    def __init__(
        self,
        ip: str,
        port: int,
        config_path: str = "config.txt",
        *,
        timing: ProtocolTiming | None = None,
        transport: str = "socket",
        cluster=None,  # SimCluster, required for transport="tpu-sim"
        gossip_relay: bool = True,
        relay_mode: str = "immediate",  # "immediate" | "rounds" | "manual" (external push_tick)
        fanout: int = 3,  # neighbors per push tick (relay_mode="rounds")
        log_dir: str = ".",
        log_stdout: bool = False,
        on_gossip: Callable[[str], None] | None = None,
    ) -> None:
        self.addr: Addr = (ip, port)
        self.config_path = config_path
        self.timing = timing or ProtocolTiming()
        self.transport = transport
        self.gossip_relay = gossip_relay
        if relay_mode not in ("immediate", "rounds", "manual"):
            raise ValueError(f"unknown relay_mode {relay_mode!r}")
        self.relay_mode = relay_mode
        self._tick_rng = None  # lazy per-peer RNG for push_tick
        self.fanout = fanout
        self.silent = False
        self.running = False
        self.on_gossip = on_gossip

        if transport == "tpu-sim":
            if cluster is None:
                raise ValueError("transport='tpu-sim' requires cluster=SimCluster(...)")
            self.cluster = cluster
            cluster.register_peer(self.addr)
            return
        if transport != "socket":
            raise ValueError(f"unknown transport {transport!r}")

        # outgoing/incoming links, keyed by connection address
        self.out_conns: dict[Addr, _Conn] = {}
        self.in_conns: dict[Addr, _Conn] = {}
        self.seed_writers: dict[Addr, asyncio.StreamWriter] = {}
        # hash-based gossip dedup (north star; absent in reference)
        self.seen_messages: set[str] = set()
        self.gossip_log: list[str] = []

        self._first_subset: list[Addr] | None = None
        self._subset_received = False
        # contacted seed -> set once its registration reply is applied
        self._replied: dict[Addr, asyncio.Event] = {}
        self._server: asyncio.Server | None = None
        self._tasks: list[asyncio.Task] = []
        self._log_path = os.path.join(log_dir, f"peer_log_{port}.txt")
        self._log_stdout = log_stdout

    # --- logging (Peer.py:40-49) -------------------------------------------

    def log(self, msg: str) -> None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        if self._log_stdout:
            print(f"peer{self.addr}: {line}")
        with open(self._log_path, "a") as f:
            f.write(line + "\n")

    # --- fault injection (Peer.py:437-439) ---------------------------------

    def set_silent(self, value: bool = True) -> None:
        """Silent mode: stop heartbeats and PING replies, keep gossiping and
        keep sockets open — a crash-like fault for the failure detector."""
        self.silent = value
        if self.transport == "tpu-sim":
            self.cluster.set_silent(self.addr, value)

    # --- bootstrap (Peer.py:74-118) ----------------------------------------

    async def _bootstrap(self) -> None:
        seeds = [a for a in load_config(self.config_path) if a != self.addr]
        if not seeds:
            raise RuntimeError(f"no seeds in {self.config_path}")
        quorum = len(seeds) // 2 + 1  # ⌊n/2⌋+1, first in file order (Peer.py:80-81)
        for seed_addr in seeds[:quorum]:
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*seed_addr),
                    timeout=self.timing.connect_timeout,
                )
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self.log(f"Seed {seed_addr} unreachable")
                continue
            try:
                writer.write(wire.encode_peer_handshake(self.addr))
                await writer.drain()
            except (ConnectionError, OSError):
                # a seed that resets mid-handshake must not abort bootstrap:
                # the remaining quorum seeds still get contacted and gossip
                # still starts (same guard as the seed-mesh handshake)
                self.log(f"Seed {seed_addr} reset during handshake")
                writer.close()
                continue
            self.seed_writers[seed_addr] = writer
            self._replied[seed_addr] = asyncio.Event()
            self._tasks.append(
                asyncio.ensure_future(self._seed_reply_loop(reader, seed_addr))
            )
        # first-subset latch applies after a settle delay so other seeds'
        # replies land first (Peer.py:104-110); a reply still in flight
        # then (a loaded host) is waited for, so the node comes up only
        # with the subsets it was handed applied: a line gossiped as it
        # comes up has its neighbors to go to
        await asyncio.sleep(self.timing.subset_apply_delay)
        await self._await_replies()
        if self._first_subset:
            await self._connect_to_peers(self._first_subset)
        self._subset_received = True
        self._tasks.append(asyncio.ensure_future(self._gossip_generator()))

    async def _await_replies(self) -> None:
        """Wait, at most :data:`REPLY_WAIT_S`, until every contacted seed's
        registration reply has been applied (or its link closed)."""
        waits = [asyncio.ensure_future(e.wait()) for e in self._replied.values() if not e.is_set()]
        if waits:
            _, pending = await asyncio.wait(waits, timeout=REPLY_WAIT_S)
            for w in pending:
                w.cancel()

    async def _seed_reply_loop(self, reader: asyncio.StreamReader, seed_addr: Addr) -> None:
        """Registration reply (pickled subset, bounded read — §2.6.9), then
        pushed topology updates (Peer.py:153-171)."""
        first = True
        try:
            while self.running:
                try:
                    raw = await reader.read(4096)
                except (ConnectionError, OSError):
                    break
                if not raw:
                    break
                try:
                    subset = wire.decode_subset(raw)
                except Exception:
                    self.log(f"Seed {seed_addr} says: {raw[:120]!r}")
                    continue
                if first and not self._subset_received and self._first_subset is None:
                    self._first_subset = subset  # only the first subset is latched
                    self.log(f"First subset from {seed_addr}: {subset}")
                elif subset:
                    await self._connect_to_peers(subset)  # later pushed updates
                first = False
                self._replied[seed_addr].set()
        finally:
            self._replied[seed_addr].set()

    # --- peer links (Peer.py:173-296) --------------------------------------

    async def _connect_to_peers(self, subset: list[Addr]) -> None:
        for peer in subset:
            if peer == self.addr or peer in self.out_conns:
                continue
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*peer),
                    timeout=self.timing.connect_timeout,
                )
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self.log(f"Peer {peer} unreachable")
                continue
            conn = _Conn(writer, identity=peer)
            self.out_conns[peer] = conn
            if not self.silent:
                writer.write(wire.encode_heartbeat(self.addr))
                await writer.drain()
            self._tasks.append(
                asyncio.ensure_future(self._peer_line_loop(reader, conn, peer, outgoing=True))
            )

    async def _on_peer_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn_addr: Addr = writer.get_extra_info("peername")
        conn = _Conn(writer, identity=None)
        self.in_conns[conn_addr] = conn
        await self._peer_line_loop(reader, conn, conn_addr, outgoing=False)

    async def _peer_line_loop(
        self, reader: asyncio.StreamReader, conn: _Conn, key: Addr, *, outgoing: bool
    ) -> None:
        while self.running:
            try:
                raw = await reader.readline()
            except (ConnectionError, OSError):
                break
            if not raw:
                break
            kind, payload = wire.classify(raw)
            if kind == "heartbeat":
                conn.identity = payload  # reported identity (Peer.py:194-199)
                conn.last_hb = time.monotonic()
            elif kind == "ping":
                if not self.silent:  # Peer.py:201-205
                    conn.writer.write(wire.encode_heartbeat(self.addr))
                    try:
                        await conn.writer.drain()
                    except (ConnectionError, OSError):
                        break
            elif kind == "gossip_or_text":
                await self._on_gossip_line(payload, from_conn=conn)
            elif kind == "malformed":
                self.log(f"Malformed line: {payload!r}")
            elif kind == "empty":
                continue
        (self.out_conns if outgoing else self.in_conns).pop(key, None)
        conn.writer.close()

    # --- gossip (Peer.py:395-408, generalized) ------------------------------

    async def _on_gossip_line(self, line: str, from_conn: _Conn | None) -> None:
        msg_id = wire.gossip_message_id(line)
        if msg_id in self.seen_messages:
            return  # hash-based dedup: re-receipt is a no-op
        self.seen_messages.add(msg_id)
        self.gossip_log.append(msg_id)
        self.log(f"Gossip: {msg_id}")
        if self.on_gossip is not None:
            self.on_gossip(msg_id)
        if self.gossip_relay and self.relay_mode == "immediate":
            await self._broadcast_gossip(msg_id, exclude=from_conn)
        # relay_mode="rounds": _push_tick_loop handles dissemination;
        # relay_mode="manual": the harness drives push_tick() itself

    async def _broadcast_gossip(self, line: str, exclude: _Conn | None = None) -> None:
        data = (line + "\n").encode()
        conns = list(self.out_conns.items()) + list(self.in_conns.items())
        for key, conn in conns:
            if conn is exclude:
                continue
            try:
                conn.writer.write(data)
                await conn.writer.drain()
            except (ConnectionError, OSError):
                self.out_conns.pop(key, None)
                self.in_conns.pop(key, None)

    async def _gossip_generator(self) -> None:
        """Generate gossip_count messages, one per gossip_period
        (Peer.py:396-408: 10 messages / 5 s; identity format per
        wire.encode_gossip — port term added for dedup uniqueness)."""
        for count in range(1, self.timing.gossip_count + 1):
            if not self.running:
                return
            stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            line = wire.encode_gossip(stamp, self.addr[0], self.addr[1], count).decode().strip()
            self.seen_messages.add(line)
            self.gossip_log.append(line)
            await self._broadcast_gossip(line)
            await asyncio.sleep(self.timing.gossip_period)

    def send_to_seeds(self, text: str) -> int:
        """Forward a raw operator line to every connected seed — the
        reference's stdin passthrough (Peer.py:441-442), which the seed
        consumes as an "Unrecognized" line (Seed.py:440-441). Returns the
        number of seeds written to."""
        sent = 0
        # frame with a newline: our seed parses its streams line-wise
        # (readline), unlike the reference's raw recv() chunks — an
        # unframed write would sit in the buffer and merge with the next
        # protocol line into one garbage message
        data = text.encode() if text.endswith("\n") else text.encode() + b"\n"
        for seed_addr, writer in list(self.seed_writers.items()):
            try:
                writer.write(data)
                sent += 1
            except (ConnectionError, OSError):
                self.log(f"Seed {seed_addr} unreachable for passthrough")
        return sent

    def gossip(self, text: str) -> None:
        """Inject an application message into the swarm."""
        if self.transport == "tpu-sim":
            self.cluster.gossip(self.addr, text)
            return
        self.seen_messages.add(text)
        self.gossip_log.append(text)
        if self.relay_mode == "immediate":
            asyncio.ensure_future(self._broadcast_gossip(text))
        # rounds mode: the next push tick disseminates it

    async def push_tick(self, messages: list[str] | None = None) -> None:
        """ONE round of round-gated push gossip: push everything seen to
        ``fanout`` uniformly sampled neighbors — the socket-side twin of the
        engine's push round (sim/engine.py). Driven by :meth:`_push_tick_loop`
        on a wall-clock cadence (relay_mode="rounds"), or externally by a
        barrier-stepping harness (relay_mode="manual") so a "round" is an
        exact barrier rather than a wall-clock bin (conformance tests).

        ``messages`` lets the harness pass a seen-set snapshot taken at the
        barrier start, so messages received DURING the barrier are not
        relayed until the next round (simultaneous-round semantics, matching
        the engine where all peers push state as of round start)."""
        if self._tick_rng is None:
            import random as _random

            self._tick_rng = _random.Random(self.addr[1])
        rng = self._tick_rng
        conns = list(self.out_conns.values()) + list(self.in_conns.values())
        if messages is None:
            messages = list(self.seen_messages)
        if not conns or not messages:
            return
        for msg in messages:
            data = (msg + "\n").encode()
            for conn in rng.choices(conns, k=min(self.fanout, len(conns))):
                try:
                    conn.writer.write(data)
                    await conn.writer.drain()
                except (ConnectionError, OSError):
                    pass

    async def _push_tick_loop(self) -> None:
        while self.running:
            await asyncio.sleep(self.timing.gossip_period)
            await self.push_tick()

    # --- liveness (Peer.py:298-393) ----------------------------------------

    async def _heartbeat_loop(self) -> None:
        while self.running:
            if not self.silent:
                data = wire.encode_heartbeat(self.addr)
                for key, conn in list(self.out_conns.items()) + list(self.in_conns.items()):
                    try:
                        conn.writer.write(data)
                        await conn.writer.drain()
                    except (ConnectionError, OSError):
                        self.out_conns.pop(key, None)
                        self.in_conns.pop(key, None)
            await asyncio.sleep(self.timing.heartbeat_period)

    async def _detector_loop(self) -> None:
        """Stale → PING → grace → declare dead (Peer.py:298-363).

        The sweep is batched: every stale connection is PINGed up front and
        ONE grace period covers them all, so sweep time is O(1) in the stale
        count. (The reference serializes the grace per stale peer —
        Peer.py:298-363 — making k simultaneous failures take k grace
        periods to clear; that is a bug band this build fixes on purpose,
        like the rendezvous and re-broadcast quirks.)"""
        while self.running:
            await asyncio.sleep(self.timing.detect_period)
            now = time.monotonic()
            suspects: list[tuple[Addr, _Conn, dict[Addr, _Conn]]] = []
            for conns in (self.out_conns, self.in_conns):
                for key, conn in list(conns.items()):
                    if now - conn.last_hb <= self.timing.heartbeat_timeout:
                        continue
                    try:
                        conn.writer.write(wire.encode_ping())
                        await conn.writer.drain()
                    except (ConnectionError, OSError):
                        await self._declare_dead(key, conn, conns)
                        continue
                    suspects.append((key, conn, conns))
            if not suspects:
                continue
            await asyncio.sleep(self.timing.ping_grace)
            for key, conn, conns in suspects:
                # the key may have been re-bound (reconnect) or removed
                # (heartbeat-loop error path) during the shared grace — only
                # the exact suspected connection may be declared dead
                if conns.get(key) is not conn:
                    continue
                # a heartbeat during the grace advances last_hb (Peer.py:309)
                if time.monotonic() - conn.last_hb > self.timing.heartbeat_timeout:
                    await self._declare_dead(key, conn, conns)

    async def _declare_dead(self, key: Addr, conn: _Conn, conns: dict[Addr, _Conn]) -> None:
        identity = conn.identity or key
        self.log(f"Declared dead: {identity}")
        data = wire.encode_dead_node(identity)
        for seed_addr, w in list(self.seed_writers.items()):
            try:
                w.write(data)
                await w.drain()
            except (ConnectionError, OSError):
                self.seed_writers.pop(seed_addr, None)
        conns.pop(key, None)
        conn.writer.close()

    # --- lifecycle ----------------------------------------------------------

    async def start_detached(self) -> None:
        """Start server + protocol loops WITHOUT seed bootstrap — for
        harnesses that wire an explicit topology via :meth:`connect_to`
        (e.g. the socket-vs-tpu-sim conformance runs on a fixed graph)."""
        self.running = True
        self._server = await asyncio.start_server(self._on_peer_connection, *self.addr)
        self._subset_received = True
        self._tasks += [
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._detector_loop()),
        ]
        if self.gossip_relay and self.relay_mode == "rounds":
            self._tasks.append(asyncio.ensure_future(self._push_tick_loop()))

    async def connect_to(self, peers: list[Addr]) -> None:
        """Dial the given peers directly (harness/topology-injection path)."""
        await self._connect_to_peers(peers)

    async def start(self) -> None:
        if self.transport == "tpu-sim":
            self.running = True
            return
        self.running = True
        self._server = await asyncio.start_server(self._on_peer_connection, *self.addr)
        await self._bootstrap()
        self._tasks += [
            asyncio.ensure_future(self._heartbeat_loop()),
            asyncio.ensure_future(self._detector_loop()),
        ]
        if self.gossip_relay and self.relay_mode == "rounds":
            self._tasks.append(asyncio.ensure_future(self._push_tick_loop()))
        self.log(f"Peer up on {self.addr}")

    async def stop(self) -> None:
        self.running = False
        if self.transport == "tpu-sim":
            return
        for t in self._tasks:
            t.cancel()
        for conn in list(self.out_conns.values()) + list(self.in_conns.values()):
            conn.writer.close()
        for w in self.seed_writers.values():
            w.close()
        await close_server_best_effort(self._server)

    # --- introspection -----------------------------------------------------

    @property
    def neighbors(self) -> list[Addr]:
        if self.transport == "tpu-sim":
            return self.cluster.neighbors(self.addr)
        out = list(self.out_conns.keys())
        out += [c.identity for c in self.in_conns.values() if c.identity]
        return sorted(set(out))

    def has_seen(self, msg_id: str) -> bool:
        if self.transport == "tpu-sim":
            return self.cluster.has_seen(self.addr, msg_id)
        return msg_id in self.seen_messages
