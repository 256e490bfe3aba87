"""The port's socket nodes (``tpu_gossip_torch/compat/``) as a real
localhost swarm, timers scaled 50x: each case of
``tests/compat/test_socket_cluster.py`` on the port's ``SeedNode`` and
``PeerNode``, and two mixed swarms in one event loop (the JAX package's
seeds with the port's peers, the port's seeds with the JAX package's
peers), each bootstrapping, relaying one message to every peer and purging
a silent peer: the two packages speak one wire protocol. Pure asyncio; no
tensor and no JAX program."""

import asyncio
import functools

import pytest

from chip_smoke import free_ports
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip.compat.peer import PeerNode as JaxPeerNode
from tpu_gossip.compat.seed import SeedNode as JaxSeedNode
from tpu_gossip_torch.compat import PeerNode, ProtocolTiming, SeedNode


def asyncio_test(fn):
    """pytest-asyncio is not in the image; run coroutine tests directly."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        return asyncio.run(fn(*a, **kw))

    return wrapper


SCALE = 0.02  # 50x faster than the reference contract
TIMING = ProtocolTiming().scaled(SCALE)


async def start_cluster(tmp_path, n_seeds=2, n_peers=5, seed_cls=None, peer_cls=None, **peer_kw):
    config = tmp_path / "config.txt"
    config.write_text("")
    ports = free_ports(n_seeds + n_peers)
    seeds = []
    for p in ports[:n_seeds]:
        s = (seed_cls or SeedNode)("127.0.0.1", p, str(config), timing=TIMING,
                                   log_dir=str(tmp_path), rng_seed=0)
        await s.start()
        seeds.append(s)
    await asyncio.sleep(TIMING.seed_reconnect_period * 1.5)  # mesh forms
    peers = []
    for p in ports[n_seeds:]:
        node = (peer_cls or PeerNode)("127.0.0.1", p, str(config), timing=TIMING,
                                      log_dir=str(tmp_path), **peer_kw)
        await node.start()
        peers.append(node)
        await asyncio.sleep(TIMING.registration_settle * 2.5)
    return seeds, peers


async def stop_all(seeds, peers):
    for n in peers + seeds:
        await n.stop()


@asyncio_test
async def test_bootstrap_and_seed_mesh(tmp_path):
    seeds, peers = await start_cluster(tmp_path, n_seeds=3, n_peers=4)
    try:
        # config.txt self-registration: every seed appended itself
        lines = (tmp_path / "config.txt").read_text().splitlines()
        assert len(lines) == 3
        # seed mesh is fully connected
        for s in seeds:
            assert len(s.seed_writers) == 2
        # every peer got registered at its quorum of seeds and learned
        # neighbors (except the very first peer, who had nobody to meet)
        connected = [p for p in peers if p.neighbors]
        assert len(connected) >= len(peers) - 1
        # replicated topology: all seeds eventually know all peers
        await asyncio.sleep(TIMING.heartbeat_period)
        peer_addrs = {p.addr for p in peers}
        for s in seeds:
            assert peer_addrs <= set(s.known_peers)
    finally:
        await stop_all(seeds, peers)


@asyncio_test
async def test_gossip_epidemic_relay(tmp_path):
    """A message injected at one peer floods the whole swarm through relay +
    dedup (the north-star generalization; reference gossip is one-hop)."""
    seeds, peers = await start_cluster(tmp_path, n_seeds=2, n_peers=6)
    try:
        peers[0].gossip("hello-swarm")
        await asyncio.sleep(TIMING.gossip_period * 6)
        got = [p for p in peers if p.has_seen("hello-swarm")]
        assert len(got) == len(peers)
        # dedup: each peer recorded it exactly once
        for p in peers:
            assert p.gossip_log.count("hello-swarm") == 1
    finally:
        await stop_all(seeds, peers)


@asyncio_test
async def test_silent_peer_detected_and_purged(tmp_path):
    """Silent-mode fault: neighbors PING, declare dead, report to seeds,
    seeds purge the node from the replicated topology (Peer.py:298-363 →
    Seed.py:358-406)."""
    seeds, peers = await start_cluster(tmp_path, n_seeds=2, n_peers=5)
    try:
        victim = next(p for p in peers if p.neighbors)
        victim.set_silent(True)
        # worst case ≈ timeout + sweep + grace (SURVEY §6: 30-42 s real time)
        await asyncio.sleep(
            TIMING.heartbeat_timeout + 3 * TIMING.detect_period + 3 * TIMING.ping_grace
        )
        assert all(victim.addr not in s.network_topology for s in seeds)
        assert all(victim.addr not in s.known_peers for s in seeds)
    finally:
        await stop_all(seeds, peers)


@asyncio_test
async def test_simultaneous_failures_detected_in_one_sweep(tmp_path):
    """The detector batches its PING grace: k simultaneously-silent peers
    are declared dead in ONE grace period, not k (the reference serializes
    the grace per stale peer, Peer.py:298-363 — a deliberate divergence).

    Timing is chosen so the batched and serial behaviors are far apart:
    grace is the dominant term, so 4 victims under a serial sweep need
    ~sweep + 4*grace = ~2.45 s while the batched sweep finishes in
    ~sweep + grace = ~0.95 s. The deadline sits between them."""
    timing = ProtocolTiming(
        heartbeat_period=0.1, detect_period=0.15, heartbeat_timeout=0.3,
        ping_grace=0.5, gossip_period=10.0, seed_reconnect_period=10.0,
        registration_settle=0.1, subset_apply_delay=0.1, connect_timeout=2.0,
        topology_dump_period=60.0,
    )
    config = tmp_path / "config.txt"
    config.write_text("")
    ports = free_ports(5)
    nodes = [
        PeerNode("127.0.0.1", p, str(config), timing=timing, log_dir=str(tmp_path))
        for p in ports
    ]
    observer, victims = nodes[0], nodes[1:]
    for n in nodes:
        await n.start_detached()
    try:
        await observer.connect_to([v.addr for v in victims])
        assert len(observer.out_conns) == 4
        await asyncio.sleep(timing.heartbeat_period * 1.5)  # heartbeats flow
        for v in victims:
            v.set_silent(True)
        t0 = asyncio.get_event_loop().time()
        # stale by t=timeout, swept within detect_period, ONE shared grace
        deadline = t0 + timing.heartbeat_timeout + timing.detect_period \
            + timing.ping_grace + 0.85
        while asyncio.get_event_loop().time() < deadline:
            if not observer.out_conns:
                break
            await asyncio.sleep(0.05)
        assert not observer.out_conns, (
            f"still connected after one batched sweep window: "
            f"{list(observer.out_conns)}"
        )
    finally:
        for n in nodes:
            await n.stop()


@asyncio_test
async def test_healthy_swarm_no_false_positives(tmp_path):
    seeds, peers = await start_cluster(tmp_path, n_seeds=2, n_peers=4)
    try:
        await asyncio.sleep(TIMING.heartbeat_timeout * 1.5)
        peer_addrs = {p.addr for p in peers}
        for s in seeds:
            assert peer_addrs <= set(s.known_peers)  # nobody purged
    finally:
        await stop_all(seeds, peers)


@asyncio_test
async def test_reference_conformant_one_hop(tmp_path):
    """gossip_relay=False reproduces the reference's log-only receive
    (Peer.py:286,206): messages reach direct neighbors only."""
    seeds, peers = await start_cluster(tmp_path, n_seeds=2, n_peers=6,
                                       gossip_relay=False)
    try:
        origin = max(peers, key=lambda p: len(p.neighbors))
        origin.gossip("one-hop")
        await asyncio.sleep(TIMING.gossip_period * 4)
        nbrs = set(origin.neighbors)
        for p in peers:
            if p is origin:
                continue
            if p.addr in nbrs:
                assert p.has_seen("one-hop")
            else:
                assert not p.has_seen("one-hop")
    finally:
        await stop_all(seeds, peers)


@asyncio_test
async def test_seed_mesh_survives_hung_and_hostile_config_entries(tmp_path):
    """A config.txt entry that accepts-and-never-replies (hung service) or
    replies with garbage must cost one sweep iteration, not kill or stall
    the reconnect loop: the two real seeds still form their mesh."""
    config = tmp_path / "config.txt"
    hung_port, garbage_port, s1, s2 = free_ports(4)
    hung_tasks = []

    async def hung_handler(reader, writer):
        hung_tasks.append(asyncio.current_task())
        try:
            await asyncio.sleep(30)  # accept, never reply (cancelled at teardown)
        finally:
            writer.close()

    async def garbage_handler(reader, writer):
        # writer must be closed, else 3.12's Server.wait_closed() waits
        # forever on the lingering connection
        try:
            await reader.readline()
            writer.write(b"I am seed|((((\n")
            await writer.drain()
        finally:
            writer.close()

    hung = await asyncio.start_server(hung_handler, "127.0.0.1", hung_port)
    garbage = await asyncio.start_server(garbage_handler, "127.0.0.1", garbage_port)
    # pre-seed the config with the two bad entries; real seeds self-append
    config.write_text(f"127.0.0.1:{hung_port}\n127.0.0.1:{garbage_port}\n")

    seeds = []
    for p in (s1, s2):
        s = SeedNode("127.0.0.1", p, str(config), timing=TIMING,
                     log_dir=str(tmp_path), rng_seed=0)
        await s.start()
        seeds.append(s)
    try:
        # two sweeps: the first pays the bad-entry timeouts, the second must
        # still run (loop alive) and link the real seeds
        deadline = asyncio.get_event_loop().time() + 30 * TIMING.connect_timeout
        while asyncio.get_event_loop().time() < deadline:
            if (seeds[1].addr in seeds[0].seed_writers
                    or seeds[0].addr in seeds[1].seed_writers):
                break
            await asyncio.sleep(TIMING.seed_reconnect_period / 2)
        else:
            raise AssertionError(
                f"seed mesh never formed past the bad entries: "
                f"{[list(s.seed_writers) for s in seeds]}"
            )
    finally:
        for s in seeds:
            await s.stop()
        for t in hung_tasks:
            t.cancel()
        hung.close()
        garbage.close()
        for srv in (hung, garbage):
            try:
                await asyncio.wait_for(srv.wait_closed(), timeout=5)
            except (asyncio.TimeoutError, TimeoutError):
                pass  # teardown is best-effort; never hang the suite


@asyncio_test
async def test_stdin_passthrough_reaches_seeds(tmp_path):
    """The reference forwards unrecognized stdin lines to every seed
    (Peer.py:441-442); the seed logs them as unrecognized traffic
    (Seed.py:440-441 counterpart: our seed logs the raw line)."""
    seeds, peers = await start_cluster(tmp_path, n_seeds=2, n_peers=1)
    try:
        n = peers[0].send_to_seeds("operator note: hello")
        assert n == len(peers[0].seed_writers) >= 1
        await asyncio.sleep(TIMING.seed_reconnect_period)
    finally:
        await stop_all(seeds, peers)
    # the line reached at least one seed's log as unrecognized/raw traffic
    logged = ""
    for f in tmp_path.glob("seed_log_*"):
        logged += f.read_text()
    assert "operator note: hello" in logged


@asyncio_test
async def test_peer_connection_dump_lists_neighbors(tmp_path):
    seeds, peers = await start_cluster(tmp_path, n_seeds=1, n_peers=3)
    try:
        dumps = [p.neighbors for p in peers]
        assert any(len(d) > 0 for d in dumps)
        for d in dumps:
            for addr in d:
                assert isinstance(addr, tuple) and len(addr) == 2
    finally:
        await stop_all(seeds, peers)


@pytest.mark.parametrize("mix", ["jax_seeds_port_peers", "port_seeds_jax_peers"])
@asyncio_test
async def test_mixed_swarm_bootstraps_relays_and_purges(tmp_path, mix):
    """One package's seeds with the other's peers: every peer registers and
    learns neighbours, every seed learns every peer, one message reaches
    every peer through relay, and a silent peer is declared dead by its
    neighbours and purged from every seed's topology."""
    seed_cls, peer_cls = (JaxSeedNode, PeerNode) if mix == "jax_seeds_port_peers" else (SeedNode, JaxPeerNode)
    seeds, peers = await start_cluster(tmp_path, n_seeds=2, n_peers=5, seed_cls=seed_cls, peer_cls=peer_cls)
    try:
        assert all(isinstance(s, seed_cls) for s in seeds) and all(isinstance(p, peer_cls) for p in peers)
        assert len([p for p in peers if p.neighbors]) >= len(peers) - 1
        for s in seeds:
            assert len(s.seed_writers) == 1
        await asyncio.sleep(TIMING.heartbeat_period)
        peer_addrs = {p.addr for p in peers}
        for s in seeds:
            assert peer_addrs <= set(s.known_peers)
        peers[-1].gossip("mixed-swarm")
        await asyncio.sleep(TIMING.gossip_period * 6)
        assert all(p.has_seen("mixed-swarm") for p in peers)
        for p in peers:
            assert p.gossip_log.count("mixed-swarm") == 1
        victim = next(p for p in peers[:-1] if p.neighbors)
        victim.set_silent(True)
        await asyncio.sleep(
            TIMING.heartbeat_timeout + 3 * TIMING.detect_period + 3 * TIMING.ping_grace
        )
        assert all(victim.addr not in s.network_topology for s in seeds)
        assert all(victim.addr not in s.known_peers for s in seeds)
        others = peer_addrs - {victim.addr}
        for s in seeds:
            assert others <= set(s.known_peers)
    finally:
        await stop_all(seeds, peers)
