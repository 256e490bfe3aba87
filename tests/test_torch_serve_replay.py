"""Served runs of the port against the JAX package on the CPU, on every
engine JAX serves from: the local engine over ``--graph pa``, the
configuration model and the matching graph, its packed twin, the sharded
matching mesh at S = 2, and a Bloom (k = 2) run under a background stream.

- A numpy-seeded trace (``tests/jax_pins.py::scripted_windows``, overflow
  in some windows) replayed through the port's ``replay_trace`` lands on
  the JAX CLI's replay digests, pinned in ``tests/jax_pins.json`` (group
  ``serve``).
- The port's ``run_sim serve`` fed the same windows prints the JAX CLI's
  summary: every key and digest, the replay's ``bit_identical`` included,
  with the timing and port keys aside.
- The golden run: a live loopback ``run_sim serve`` of the port, real
  client threads racing the round windows, equals its own replay, and the
  JAX CLI fed its trace file (in a child process) lands on the same
  digests.

No JAX program is compiled in this process."""

import contextlib
import io
import json
import socket
import threading
import time

import pytest

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.cli import run_sim as tcli
from tpu_gossip_torch.serve import ServeTrace, build_step, replay_trace, run_load, stack_round_stats
from tpu_gossip_torch.serve.frontend import ServeFrontend
from tpu_gossip_torch.serve.protocol import encode_query
from tpu_gossip_torch.serve.trace import scripted_trace
from tpu_gossip_torch.traffic.ingest import IngestPlan
from tpu_gossip_torch.utils.digest import state_digest, stats_digest

ENGINES = list(jax_pins.SERVE_ENGINES)


@pytest.fixture
def shards(monkeypatch):
    """``set(S)`` pins the port's mesh to S shards on the CPU."""
    make = tdist.make_mesh

    def pin(s):
        monkeypatch.setattr(tdist, "make_mesh", lambda n_shards=None, device="cuda": make(s, device=device))

    return pin


def port_serve(argv, monkeypatch=None, windows=None, rows=False):
    """The port's ``run_sim serve`` on ``argv`` (on the CPU), with the
    frontend's windows replaced by ``windows`` when given: ``(exit code,
    summary or None, stderr)``."""
    if windows is not None:
        monkeypatch.setattr(ServeFrontend, "take_window", jax_pins.windows_take(windows, rows))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(["serve", *argv, "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc in (0, 1) and lines else None), err.getvalue()


def _args(argv):
    p = tcli.build_parser()
    tcli._add_serve_args(p)
    args = p.parse_args([*argv, "--device", "cpu"])
    assert tcli._validate_serve(args) is None
    return args


@pytest.mark.parametrize("name", ENGINES)
def test_scripted_trace_replays_onto_jax(name, shards):
    """The seeded trace through the port's ``replay_trace`` on the engine
    the CLI builds equals the JAX CLI's replay of it, digest for digest."""
    s, argv = jax_pins.SERVE_ENGINES[name]
    shards(s)
    args = _args(argv)
    cfg, plan, mesh, origin_rows, make_state = tcli._serve_swarm(args, "cpu")
    trace = scripted_trace(IngestPlan(msg_slots=args.slots, max_inject=args.max_inject, k_hashes=args.stream_hashes),
                           origin_rows, args.rounds, jax_pins.SERVE_SEED)
    assert trace.num_rounds == args.rounds and sum(rr.overflow for rr in trace.rounds) > 0
    if args.stream > 0:
        strm = tcli._compile_cli_stream(args, origin_rows, "cpu")
    else:
        from tpu_gossip_torch.traffic import compile_stream

        strm = compile_stream(rate=0.0, msg_slots=args.slots, ttl=args.slot_ttl, origin_rows=origin_rows,
                              k_hashes=args.stream_hashes, device="cpu")
    state = make_state()
    if args.packed:
        from tpu_gossip_torch.core.packed import pack_state

        state = pack_state(state)
    fin, trail = replay_trace(trace, build_step(cfg, plan, mesh=mesh, stream=strm), state)
    want = jax_pins.pinned("serve", name)["replay"]
    assert state_digest(fin) == want["state_digest"]
    assert stats_digest(stack_round_stats(trail)) == want["stats_digest"]


@pytest.mark.parametrize("name", ENGINES)
def test_serve_cli_on_scripted_windows_equals_jax(name, shards, monkeypatch):
    """``run_sim serve`` fed the seeded windows prints the JAX CLI's summary
    (every block, the digests and the replay check), timing and port
    aside."""
    s, argv = jax_pins.SERVE_ENGINES[name]
    shards(s)
    rc, got, err = port_serve(argv, monkeypatch, jax_pins.argv_windows(jax_pins.SERVE_SEED, argv))
    assert rc == 0, err
    announce = json.loads(err.strip().splitlines()[0])
    assert announce["serving"] is True and announce["rounds"] == 10 and announce["max_inject"] == 6
    want = jax_pins.pinned("serve", name)
    assert jax_pins.serve_summary(got) == want
    assert got["replay"]["bit_identical"] is True and got["serve"]["ingest_overflow"] > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
            return
        except OSError:
            time.sleep(0.01)
    raise TimeoutError(f"nothing listens on {port}")


def test_live_loopback_run_equals_its_replay_and_jax(tmp_path):
    """The golden contract across the socket and the packages: a live run
    of the port's CLI (client threads racing paced windows, one QUERY)
    replays bit for bit in the port, and the JAX CLI fed its trace file
    lands on the same state and stats digests."""
    argv = ["--peers", "600", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--slots", "8",
            "--slot-ttl", "20", "--rounds", "20", "--max-inject", "4", "--quiet", "--seed", "5"]
    port, trace = _free_port(), str(tmp_path / "live.jsonl")
    box = {}

    def clients():
        _wait_listening(port)
        with socket.create_connection(("127.0.0.1", port), timeout=10.0) as sock:
            sock.sendall(encode_query("status"))
            box["query"] = sock.makefile().readline()
        box["load"] = run_load("127.0.0.1", port, clients=3, msgs_per_client=5, seed=7)

    t = threading.Thread(target=clients, daemon=True)
    t.start()
    rc, got, err = port_serve([*argv, "--port", str(port), "--rounds-per-sec", "25", "--trace-out", trace,
                               "--replay-check"])
    t.join(timeout=60.0)
    assert rc == 0, err
    assert box["load"].errors == 0 and box["load"].sent == 15
    assert isinstance(json.loads(box["query"]), dict)  # the snapshot (empty before the driver exists)
    serve = got["serve"]
    assert serve["trace_rounds"] == 20 and serve["ingest_offered"] == serve["trace_arrivals"] > 0
    assert serve["trace_arrivals"] <= serve["counters"]["accepted"] <= 15 and serve["counters"]["queries"] == 1
    assert got["replay"]["bit_identical"] is True
    assert ServeTrace.load(trace).total_arrivals == serve["trace_arrivals"]
    want = jax_in_child("tests.jax_pins", "serve_cli", 1, jax_pins.trace_windows(trace), True, *argv)
    assert (want["state_digest"], want["stats_digest"]) == (got["state_digest"], got["stats_digest"])
    assert want["serve"]["ingest_offered"] == serve["ingest_offered"]
