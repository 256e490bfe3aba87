"""Seed node: membership registry, seed mesh, topology, dead-node purge
(the port's own copy of ``tpu_gossip/compat/seed.py``, wire-compatible
with it: a port seed serves the JAX package's peers and the reverse).

Asyncio re-design of the reference's thread-per-connection seed
(reference Seed.py:56-492): one event loop, one coroutine per connection,
explicit state instead of GIL-protected shared dicts. Deliberate fixes of
documented reference quirks (SURVEY.md §2.6):

- rendezvous turn-taking uses a stable hash (zlib.crc32) over the *seed*
  set, so distinct processes agree on the coordinator; the reference used
  the salted builtin ``hash`` over a peer-derived candidate set
  (Seed.py:187-201) which only agrees across processes by luck.
- ``remove_dead_node`` broadcasts the removal once (the reference's
  duplicated tail double-broadcast, Seed.py:393-406); re-broadcast storms
  still terminate via the absent-node early return.
- ``known_peers`` is deduplicated on merge (the reference appends before its
  dedup check, Seed.py:215,227-228).
- subset handout supports the *intended* degree-preferential power-law
  policy (``subset_policy="powerlaw"``, the capability of the dead
  ``powerlaw_connect`` Seed.py:151-185 and demonstrate_powerlaw.py:5-39)
  as well as the reference's literal first-k behavior (``"first"``,
  Seed.py:127-129) for conformance runs.
"""

from __future__ import annotations

import asyncio
import datetime
import os
import random
import zlib

from tpu_gossip_torch.compat import wire
from tpu_gossip_torch.compat.netutil import close_server_best_effort
from tpu_gossip_torch.compat.timing import ProtocolTiming
from tpu_gossip_torch.compat.wire import Addr

__all__ = ["SeedNode"]


def load_config(path: str) -> list[Addr]:
    """Parse ``ip:port`` lines (reference Seed.py:89-108 / Peer.py:51-72)."""
    out: list[Addr] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ip, port = line.rsplit(":", 1)
            out.append((ip, int(port)))
    return out


class ConfigCache:
    """``load_config`` memoized on (mtime_ns, size): registration-path reads
    (``is_my_turn`` runs once per registering peer) cost a stat, not a parse
    — the file only changes when a seed self-registers."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._stamp: tuple[int, int] | None = None
        self._entries: list[Addr] = []

    def entries(self) -> list[Addr]:
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            stamp = None
        if stamp != self._stamp:
            self._entries = load_config(self.path)
            self._stamp = stamp
        return self._entries


class SeedNode:
    """Registry node. ``transport="socket"`` only — in tpu-sim mode the seed
    role (bootstrap + topology) is played by :class:`compat.simnet.SimCluster`
    host-side, so a SeedNode is not constructed at all."""

    def __init__(
        self,
        ip: str,
        port: int,
        config_path: str = "config.txt",
        *,
        timing: ProtocolTiming | None = None,
        subset_policy: str = "powerlaw",  # "powerlaw" | "first"
        subset_size: int = 3,
        transport: str = "socket",
        log_dir: str = ".",
        log_stdout: bool = False,
        rng_seed: int | None = None,
    ) -> None:
        if transport != "socket":
            raise ValueError(
                "SeedNode only runs transport='socket'; tpu-sim swarms are "
                "bootstrapped host-side by compat.simnet.SimCluster"
            )
        if subset_policy not in ("powerlaw", "first"):
            raise ValueError(f"unknown subset_policy {subset_policy!r}")
        self.addr: Addr = (ip, port)
        self.config_path = config_path
        self._config_cache = ConfigCache(config_path)
        self.timing = timing or ProtocolTiming()
        self.subset_policy = subset_policy
        self.subset_size = subset_size
        self._rng = random.Random(rng_seed)

        # registry: peers registered at this seed (Seed.py:29-54)
        self.peer_writers: dict[Addr, asyncio.StreamWriter] = {}
        # seed mesh (Seed.py:60): addr -> writer
        self.seed_writers: dict[Addr, asyncio.StreamWriter] = {}
        self.known_seeds: list[Addr] = []
        self.known_peers: list[Addr] = []
        # replicated global topology {peer: set(peers)} (Seed.py:71)
        self.network_topology: dict[Addr, set[Addr]] = {}

        self._server: asyncio.Server | None = None
        self._tasks: list[asyncio.Task] = []
        # every writer ever opened/accepted — duplicate seed-mesh links are
        # not in seed_writers, but must still be closed on stop or the
        # server's wait_closed() deadlocks on their blocked readers
        self._all_writers: list[asyncio.StreamWriter] = []
        self._log_path = os.path.join(log_dir, f"seed_log_{port}.txt")
        self._log_stdout = log_stdout
        self.running = False

    # --- logging (Seed.py:78-87) -------------------------------------------

    def log(self, msg: str) -> None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        if self._log_stdout:
            print(f"seed{self.addr}: {line}")
        with open(self._log_path, "a") as f:
            f.write(line + "\n")

    # --- config bootstrap (Seed.py:89-125) ---------------------------------

    def load_and_register_config(self) -> None:
        entries = self._config_cache.entries()
        self.known_seeds = [a for a in entries if a != self.addr]
        # self-registration: append own ip:port if absent (Seed.py:110-125);
        # the cache re-reads on next use (the append changes mtime/size)
        if self.addr not in entries:
            with open(self.config_path, "a") as f:
                f.write(f"{self.addr[0]}:{self.addr[1]}\n")

    # --- subset handout ----------------------------------------------------

    def get_peer_subset(self, exclude: Addr) -> list[Addr]:
        """Neighbors for a newly registering peer.

        "powerlaw": degree-preferential sample (degree from the replicated
        topology, +1 smoothing so degree-0 peers remain reachable) — the
        intended preferential-attachment semantics. "first": the reference's
        insertion-order prefix (Seed.py:127-129).
        """
        candidates = [a for a in self.known_peers if a != exclude]
        k = min(self.subset_size, len(candidates))
        if k == 0:
            return []
        if self.subset_policy == "first":
            return candidates[:k]
        weights = [len(self.network_topology.get(a, ())) + 1 for a in candidates]
        picked: list[Addr] = []
        pool = list(zip(candidates, weights))
        for _ in range(k):
            total = sum(w for _, w in pool)
            r = self._rng.random() * total
            acc = 0.0
            for i, (a, w) in enumerate(pool):
                acc += w
                if r <= acc:
                    picked.append(a)
                    pool.pop(i)
                    break
        return picked

    def is_my_turn(self, new_peer: Addr) -> bool:
        """Rendezvous coordinator election: exactly one of the seeds the peer
        registers with hands out a non-empty subset (intent of
        Seed.py:194-201). Peers contact the first ⌊n/2⌋+1 seeds in config
        file order (Peer.py:80-81), so the electorate is that deterministic
        prefix — electing a seed outside it would drop the handout."""
        entries = self._config_cache.entries()
        quorum = entries[: len(entries) // 2 + 1]
        if self.addr not in quorum:
            return False
        digest = zlib.crc32(str(new_peer).encode())
        return quorum[digest % len(quorum)] == self.addr

    # --- topology maintenance (Seed.py:131-149, 208-232) -------------------

    def merge_topology(self, peer: Addr, subset: list[Addr]) -> None:
        self.network_topology.setdefault(peer, set()).update(subset)
        for other in subset:
            self.network_topology.setdefault(other, set()).add(peer)
        if peer not in self.known_peers:
            self.known_peers.append(peer)
        for other in subset:
            if other not in self.known_peers:
                self.known_peers.append(other)

    def remove_dead_node(self, addr: Addr) -> bool:
        """Purge a dead peer everywhere; returns True if it was present
        (the re-broadcast guard, Seed.py:373-375)."""
        present = addr in self.network_topology or addr in self.known_peers
        if not present:
            return False
        self.network_topology.pop(addr, None)
        for nbrs in self.network_topology.values():
            nbrs.discard(addr)
        if addr in self.known_peers:
            self.known_peers.remove(addr)
        w = self.peer_writers.pop(addr, None)
        if w is not None:
            w.close()
        self.log(f"Removed dead node {addr}")
        return True

    # --- seed mesh ---------------------------------------------------------

    async def _broadcast_to_seeds(self, data: bytes) -> None:
        for addr, w in list(self.seed_writers.items()):
            try:
                w.write(data)
                await w.drain()
            except (ConnectionError, OSError):
                self.seed_writers.pop(addr, None)

    async def _seed_reconnect_loop(self) -> None:
        """Retry lost seed-mesh links forever (Seed.py:336-341)."""
        while self.running:
            self.known_seeds = [
                a for a in self._config_cache.entries() if a != self.addr
            ]
            for addr in self.known_seeds:
                if addr in self.seed_writers:
                    continue
                try:
                    reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(*addr),
                        timeout=self.timing.connect_timeout,
                    )
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    continue
                # the whole handshake exchange is guarded + timed out: a peer
                # that resets mid-handshake, or accepts and never replies,
                # must cost one sweep iteration — not kill the reconnect loop
                # for the process lifetime or stall the other seeds' retries.
                # The writer joins _all_writers only on success: a bad config
                # entry retried every sweep must not grow the cleanup list
                # unboundedly.
                try:
                    writer.write(wire.encode_seed_handshake(self.addr))
                    await writer.drain()
                    line = (
                        await asyncio.wait_for(
                            reader.readline(), timeout=self.timing.connect_timeout
                        )
                    ).decode(errors="replace")
                    got = wire.decode_seed_handshake(line)
                except (
                    ConnectionError, OSError, asyncio.TimeoutError,
                    # the literal_eval family, same set wire.classify guards
                    ValueError, TypeError, SyntaxError, RecursionError, MemoryError,
                ):
                    writer.close()
                    continue
                except asyncio.CancelledError:
                    writer.close()  # stop() mid-handshake: don't leak the socket
                    raise
                self._all_writers.append(writer)
                self.seed_writers[got] = writer
                self.log(f"Connected to seed {got}")
                t = asyncio.ensure_future(self._line_loop(reader, writer, got, is_seed=True))
                self._tasks.append(t)
            await asyncio.sleep(self.timing.seed_reconnect_period)

    async def _heartbeat_loop(self) -> None:
        """Seed-mesh heartbeat every heartbeat_period (Seed.py:352-356)."""
        while self.running:
            await self._broadcast_to_seeds(wire.encode_heartbeat(self.addr))
            await asyncio.sleep(self.timing.heartbeat_period)

    # --- connection handling ------------------------------------------------

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """First-line dispatch: seed handshake vs peer registration
        (Seed.py:240-299)."""
        self._all_writers.append(writer)
        try:
            line = (await reader.readline()).decode(errors="replace")
        except (ConnectionError, OSError):
            writer.close()
            return
        kind, payload = wire.classify(line)
        if kind == "seed_handshake":
            peer_seed: Addr = payload
            if peer_seed not in self.seed_writers:
                self.seed_writers[peer_seed] = writer
            writer.write(wire.encode_seed_handshake(self.addr))
            writer.write(wire.encode_heartbeat(self.addr))
            await writer.drain()
            self.log(f"Accepted seed {peer_seed}")
            await self._line_loop(reader, writer, peer_seed, is_seed=True)
            return
        # otherwise: peer registration handshake str((ip, port))
        try:
            peer = wire.decode_peer_handshake(line)
        except (ValueError, SyntaxError):
            self.log(f"Unrecognized handshake: {line!r}")
            writer.close()
            return
        await self._register_peer(peer, reader, writer)

    async def _register_peer(
        self, peer: Addr, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if peer in self.peer_writers:
            self.log(f"Duplicate registration from {peer}")
        self.peer_writers[peer] = writer
        self.log(f"Registered peer {peer}")
        # settle so sibling seeds see the registration first (Seed.py:282)
        await asyncio.sleep(self.timing.registration_settle)
        if self.is_my_turn(peer):
            subset = self.get_peer_subset(exclude=peer)
            writer.write(wire.encode_subset(subset))
            await writer.drain()
            self.log(f"Handed subset {subset} to {peer}")
            self.merge_topology(peer, subset)
            await self._broadcast_to_seeds(wire.encode_new_node_update(peer, subset))
        else:
            writer.write(wire.encode_subset([]))
            await writer.drain()
            if peer not in self.known_peers:
                self.known_peers.append(peer)
        await self._line_loop(reader, writer, peer, is_seed=False)

    async def _line_loop(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        who: Addr,
        *,
        is_seed: bool,
    ) -> None:
        """Steady-state reader (Seed.py:415-444) — EOF closes the connection
        (the reference slept forever on EOF, §2.6.6)."""
        while self.running:
            try:
                raw = await reader.readline()
            except (ConnectionError, OSError):
                break
            if not raw:
                break
            kind, payload = wire.classify(raw)
            if kind == "heartbeat":
                pass  # seeds don't track peer liveness timers; peers report deaths
            elif kind == "new_node_update":
                new_peer, subset = payload
                self.merge_topology(new_peer, subset)
            elif kind == "dead_node":
                if self.remove_dead_node(payload):
                    # single re-broadcast (reference double-broadcasts, §2.6.4)
                    await self._broadcast_to_seeds(wire.encode_dead_node(payload))
            elif kind == "empty":
                continue
            else:
                self.log(f"Unrecognized from {who}: {payload!r}")
        if is_seed:
            if self.seed_writers.get(who) is writer:  # duplicates don't evict
                self.seed_writers.pop(who, None)
        else:
            if self.peer_writers.get(who) is writer:
                self.peer_writers.pop(who, None)
        writer.close()

    # --- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        self.running = True
        self.load_and_register_config()
        self._server = await asyncio.start_server(self._on_connection, *self.addr)
        self._tasks += [
            asyncio.ensure_future(self._seed_reconnect_loop()),
            asyncio.ensure_future(self._heartbeat_loop()),
        ]
        self.log(f"Seed listening on {self.addr}")

    async def stop(self) -> None:
        self.running = False
        for t in self._tasks:
            t.cancel()
        for w in self._all_writers:
            w.close()
        await close_server_best_effort(self._server)

    def topology_snapshot(self) -> dict[Addr, set[Addr]]:
        return {k: set(v) for k, v in self.network_topology.items()}
