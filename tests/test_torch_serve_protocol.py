"""The serving plane's host half in the port against the JAX package's, on
the CPU: ``parse_line`` on the literal reference lines and on random bytes
(``tests/serve/test_protocol.py``), ``payload_hash64`` and
``slots_for_payload`` on seeded inputs, the wire copies, the trace format
across the packages (a trace either package saves loads in the other with
equal records, and the files are byte-equal), and the frontend's windows,
reference replies and port conflict. Everything compared here is pure
Python on both sides: no JAX program is compiled."""

import asyncio
import json
import random
import socket

import pytest

from tpu_gossip.compat import wire as jwire
from tpu_gossip.serve import protocol as jproto
from tpu_gossip.serve import trace as jtrace
from tpu_gossip.traffic import ingest as jingest
from tpu_gossip_torch.compat import wire
from tpu_gossip_torch.serve import ServeFrontend, ServeTrace, TraceRecorder, origin_for_addr, protocol
from tpu_gossip_torch.traffic.ingest import IngestPlan

LITERAL = [
    "PING", "I am seed|('127.0.0.1', 5000)", "Heartbeat from ('127.0.0.1', 5000)", "Dead Node: ('127.0.0.1', 5000)",
    "NewNodeUpdate|('a', 1)|[('b', 2)]", "('127.0.0.1', 5000)", "QUERY coverage", "QUERY ",
    "2025-01-01 00:00:00:127.0.0.1:5000:3", "hello world", "", "Heartbeat from not-an-addr", "Dead Node: 42",
    "NewNodeUpdate|('a',1)|5", b"\xff\xfe garbage", b"Heartbeat from ('x',", b"I am seed|[[[", b"\x00" * 64,
    b"Dead Node: ", "  \n", "('10.0.0.1', 70000)\n",
]


def _event(ev) -> tuple:
    return ev.kind, ev.payload, ev.message_id, ev.payload_hash


@pytest.mark.parametrize("line", LITERAL, ids=range(len(LITERAL)))
def test_parse_line_literal_equals_jax(line):
    assert _event(protocol.parse_line(line)) == _event(jproto.parse_line(line))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_line_random_bytes_and_wire_records_equal_jax(seed):
    """Total parse on random bytes, and every wire record the reference
    frames, equal to JAX's event for event (seeded, as JAX's property
    tests)."""
    rng = random.Random(seed)
    for _ in range(300):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(64)))
        assert _event(protocol.parse_line(blob)) == _event(jproto.parse_line(blob))
    for _ in range(100):
        addr = (f"10.{rng.randrange(256)}.{rng.randrange(256)}.1", rng.randrange(1, 65536))
        ts = f"2025-01-01 00:00:{rng.randrange(60):02d}"
        for enc in ("encode_heartbeat", "encode_dead_node", "encode_seed_handshake", "encode_peer_handshake"):
            assert getattr(wire, enc)(addr) == getattr(jwire, enc)(addr)
            line = getattr(wire, enc)(addr)
            assert _event(protocol.parse_line(line)) == _event(jproto.parse_line(line))
        raw = wire.encode_gossip(ts, addr[0], addr[1], rng.randrange(10**6))
        assert raw == jwire.encode_gossip(ts, addr[0], addr[1], int(raw.split(b":")[-1]))
        assert _event(protocol.parse_line(raw)) == _event(jproto.parse_line(raw))
        subset = [addr, (addr[0], addr[1] % 60000 + 1)]
        assert wire.decode_subset(wire.encode_subset(subset)) == jwire.decode_subset(jwire.encode_subset(subset))


def test_payload_hash_and_slots_equal_jax():
    """FNV-1a 64 pinned, and the hash-to-slot map equal to JAX's on seeded
    hashes, slot counts and k."""
    assert protocol.payload_hash64("") == 0xCBF29CE484222325
    assert protocol.payload_hash64("a") == 0xAF63DC4C8601EC8C
    rng = random.Random(3)
    for _ in range(300):
        s = "".join(chr(rng.randrange(32, 0x2FF)) for _ in range(rng.randrange(40)))
        assert protocol.payload_hash64(s) == jproto.payload_hash64(s)
        h = rng.getrandbits(64)
        m = rng.choice([4, 8, 16, 32])
        k = rng.randrange(1, min(m, 4) + 1)
        assert protocol.slots_for_payload(h, m, k) == jproto.slots_for_payload(h, m, k)
    assert protocol.encode_query("liveness") == jproto.encode_query("liveness")
    assert protocol.encode_query_reply('{"a": 1,\n "b": 2}') == jproto.encode_query_reply('{"a": 1,\n "b": 2}')
    assert origin_for_addr(("10.0.0.9", 6000), 97) == jproto.payload_hash64("10.0.0.9:6000") % 97


def _records(trace) -> list:
    return [tuple(r) for r in trace.rounds]


def test_trace_format_is_one_format(tmp_path):
    """A trace the port saves loads in JAX's ``ServeTrace.load`` with equal
    records and the file JAX would write, byte for byte; and the reverse.
    A truncated or foreign file is refused with JAX's words."""
    rng = random.Random(5)
    rec, jrec = TraceRecorder(IngestPlan(8, 4, 2)), jtrace.TraceRecorder(jingest.IngestPlan(8, 4, 2))
    for r in range(6):
        window = [(rng.randrange(500), rng.getrandbits(64)) for _ in range(rng.randrange(5))]
        overflow = rng.randrange(3) * (r % 2)
        rec.record_round(r, window, overflow)
        jrec.record_round(r, window, overflow)
    ours, theirs = rec.finish(), jrec.finish()
    ours.save(tmp_path / "port.jsonl")
    theirs.save(tmp_path / "jax.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    loaded = jtrace.ServeTrace.load(tmp_path / "port.jsonl")
    assert _records(loaded) == _records(ours) and loaded.plan.k_hashes == 2
    back = ServeTrace.load(tmp_path / "jax.jsonl")
    assert _records(back) == _records(theirs) and back == ours
    assert (back.num_rounds, back.total_arrivals) == (theirs.num_rounds, theirs.total_arrivals)
    batches = list(back.batches("cpu"))
    assert [b.count for b in batches] == [len(r.origins) for r in back.rounds]
    assert [b.overflow for b in batches] == [r.overflow for r in back.rounds]
    lines = (tmp_path / "port.jsonl").read_text().splitlines()
    (tmp_path / "cut.jsonl").write_text("\n".join(lines[:-1]) + "\n")
    (tmp_path / "foreign.jsonl").write_text(json.dumps({"format": "other"}) + "\n")
    for name in ("cut.jsonl", "foreign.jsonl"):
        with pytest.raises(ValueError) as want:
            jtrace.ServeTrace.load(tmp_path / name)
        with pytest.raises(ValueError) as got:
            ServeTrace.load(tmp_path / name)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must defer, not drop"):
        rec.record_round(7, [(0, 1)] * 5, 0)


def test_frontend_window_defers_fifo_and_bills_overflow():
    fe = ServeFrontend(origin_rows=[0, 1, 2], max_inject=2, port=0)
    arrivals = [(i, 100 + i) for i in range(5)]
    with fe._lock:
        fe._pending.extend(arrivals)
    assert fe.take_window() == (arrivals[:2], 3)
    assert fe.take_window() == (arrivals[2:4], 1)  # FIFO carry, billed again
    assert fe.take_window() == (arrivals[4:], 0)
    assert fe.backlog() == 0 and fe.counters.overflow_billed == 4
    with pytest.raises(ValueError, match="non-empty"):
        ServeFrontend(origin_rows=[], max_inject=1)


def test_frontend_speaks_the_reference_wire_protocol():
    async def talk(port):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(wire.encode_peer_handshake(("10.0.0.9", 6000)))
        await writer.drain()
        assert wire.decode_subset(await asyncio.wait_for(reader.readline(), 10.0)) == []
        writer.write(wire.encode_ping())
        await writer.drain()
        assert wire.classify(await asyncio.wait_for(reader.readline(), 10.0))[0] == "heartbeat"
        writer.write(b"QUERY status\n")
        await writer.drain()
        assert json.loads(await asyncio.wait_for(reader.readline(), 10.0)) == {"round": 3, "coverage": 0.5}
        writer.write(b"QUERY coverage\n")
        await writer.drain()
        assert json.loads(await asyncio.wait_for(reader.readline(), 10.0)) == 0.5
        writer.write(wire.encode_gossip("t0", "10.0.0.9", 6000, 1))
        writer.write(b"Heartbeat from not-an-addr\n")
        writer.write(wire.encode_heartbeat(("10.0.0.9", 6000)))
        await writer.drain()
        writer.close()

    fe = ServeFrontend(origin_rows=list(range(8)), max_inject=4, port=0,
                       query_snapshot=lambda: {"round": 3, "coverage": 0.5})
    fe.start()
    try:
        asyncio.run(talk(fe.port))
        for _ in range(200):  # the reader loop may still hold the last lines
            if fe.counters.heartbeats:
                break
            asyncio.run(asyncio.sleep(0.01))
    finally:
        fe.stop()
    window, overflow = fe.take_window()
    # the registered identity pins the connection's row
    assert window == [(origin_for_addr(("10.0.0.9", 6000), 8),
                       protocol.payload_hash64(wire.gossip_message_id("t0:10.0.0.9:6000:1")))] and overflow == 0
    c = fe.counters.as_dict()
    assert (c["registrations"], c["pings"], c["queries"], c["malformed"], c["heartbeats"], c["accepted"]) == \
        (1, 1, 2, 1, 1, 1)


def test_frontend_port_conflict_raises():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    try:
        fe = ServeFrontend(origin_rows=[0], max_inject=1, port=blocker.getsockname()[1])
        with pytest.raises(OSError):
            fe.start()
    finally:
        blocker.close()
