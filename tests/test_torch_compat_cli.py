"""The port's seed and peer CLIs (``tpu_gossip_torch/cli/run_seed.py``,
``run_peer.py``) and ``ConfigCache``/``is_my_turn`` on the CPU: the cases
of ``tests/unit/test_cli_config.py`` on the port, the parsers' flags held
to the JAX CLIs' (no flag the JAX package lacks), and a run of the port's
``run_seed`` and two ``run_peer`` processes on a temporary ``config.txt``:
registration, one stdin line gossiped to the other peer, ``exit`` on stdin
and ``--run-seconds``, every process exiting 0."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip.cli import run_peer as jax_run_peer
from tpu_gossip.cli import run_seed as jax_run_seed
from tpu_gossip_torch.cli import prompt_port
from tpu_gossip_torch.compat.seed import ConfigCache, SeedNode, load_config

ROOT = Path(__file__).resolve().parent.parent


# --- tests/unit/test_cli_config.py on the port -------------------------------


def test_config_cache_invalidates_on_append(tmp_path):
    p = tmp_path / "config.txt"
    p.write_text("127.0.0.1:121\n")
    cache = ConfigCache(str(p))
    assert cache.entries() == [("127.0.0.1", 121)]
    with open(p, "a") as f:
        f.write("127.0.0.1:122\n")
    assert cache.entries() == [("127.0.0.1", 121), ("127.0.0.1", 122)]


def test_config_cache_skips_reparse_when_unchanged(tmp_path, monkeypatch):
    p = tmp_path / "config.txt"
    p.write_text("127.0.0.1:121\n127.0.0.1:122\n")
    cache = ConfigCache(str(p))
    first = cache.entries()
    # a second read with the same (mtime, size) must not touch the parser
    import tpu_gossip_torch.compat.seed as seed_mod

    def boom(path):
        raise AssertionError("load_config called on unchanged file")

    monkeypatch.setattr(seed_mod, "load_config", boom)
    assert cache.entries() is first


def test_is_my_turn_elects_exactly_one_quorum_seed(tmp_path):
    p = tmp_path / "config.txt"
    addrs = [("127.0.0.1", 121 + i) for i in range(5)]
    p.write_text("".join(f"{ip}:{port}\n" for ip, port in addrs))
    seeds = [SeedNode(ip, port, config_path=str(p), log_dir=str(tmp_path)) for ip, port in addrs]
    quorum = addrs[: len(addrs) // 2 + 1]
    for peer in [("10.0.0.9", 5000 + i) for i in range(20)]:
        winners = [s.addr for s in seeds if s.is_my_turn(peer)]
        assert len(winners) == 1
        assert winners[0] in quorum


def test_prompt_port_retries_until_valid(monkeypatch):
    answers = iter(["nope", "99999", " 5001 "])
    monkeypatch.setattr("builtins.input", lambda _: next(answers))
    assert prompt_port("peer") == 5001


def test_prompt_port_eof_exits(monkeypatch):
    def eof(_):
        raise EOFError

    monkeypatch.setattr("builtins.input", eof)
    with pytest.raises(SystemExit):
        prompt_port("seed")


def test_bare_cli_parsers_accept_missing_port():
    from tpu_gossip_torch.cli.run_peer import build_parser as peer_parser
    from tpu_gossip_torch.cli.run_seed import build_parser as seed_parser

    assert peer_parser().parse_args([]).port is None
    assert seed_parser().parse_args([]).port is None


# --- against the JAX package -------------------------------------------------


def _flags(parser) -> list:
    return [(tuple(a.option_strings), a.dest, a.default, a.type, tuple(a.choices or ()), a.nargs)
            for a in parser._actions]


@pytest.mark.parametrize("role", ["seed", "peer"])
def test_parser_flags_are_the_jax_clis(role):
    """Each CLI takes exactly the JAX CLI's flags, defaults and choices."""
    from tpu_gossip_torch.cli import run_peer, run_seed

    port, jax = (run_seed, jax_run_seed) if role == "seed" else (run_peer, jax_run_peer)
    assert _flags(port.build_parser()) == _flags(jax.build_parser())


def test_is_my_turn_and_subset_equal_jax(tmp_path):
    """The rendezvous election and the seeded power-law handout equal the
    JAX seed's on the same registry."""
    p = tmp_path / "config.txt"
    addrs = [("127.0.0.1", 121 + i) for i in range(3)]
    p.write_text("".join(f"{ip}:{port}\n" for ip, port in addrs))
    from tpu_gossip.compat.seed import SeedNode as JaxSeedNode

    port = SeedNode(*addrs[0], config_path=str(p), log_dir=str(tmp_path), rng_seed=3)
    jax = JaxSeedNode(*addrs[0], config_path=str(p), log_dir=str(tmp_path), rng_seed=3)
    for node in (port, jax):
        for i in range(12):
            node.merge_topology(("10.0.0.1", 7000 + i), [("10.0.0.1", 7000 + j) for j in range(i % 4)])
    peers = [("10.0.0.9", 5000 + i) for i in range(30)]
    assert [port.is_my_turn(a) for a in peers] == [jax.is_my_turn(a) for a in peers]
    assert [port.get_peer_subset(a) for a in peers] == [jax.get_peer_subset(a) for a in peers]
    assert load_config(str(p)) == addrs


# --- the CLIs as processes ---------------------------------------------------


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _log(path: Path) -> str:
    return path.read_text() if path.exists() else ""


def test_seed_and_peer_processes(tmp_path):
    """``run_seed`` with ``--run-seconds``; peer A with ``--run-seconds``;
    peer B gossips a stdin line, which reaches A's log, then takes ``exit``.
    Every process exits 0 and the seed logged both registrations."""
    seed_port, a_port, b_port = _free_ports(3)
    config = tmp_path / "config.txt"
    config.write_text("")
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def start(module, port, *extra):
        return subprocess.Popen([sys.executable, "-m", f"tpu_gossip_torch.cli.{module}", "--port", str(port),
                                 "--config", str(config), "--time-scale", "0.01", "--quiet", *extra],
                                cwd=tmp_path, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    procs = [start("run_seed", seed_port, "--run-seconds", "20")]
    try:
        _wait(lambda: f"127.0.0.1:{seed_port}" in config.read_text(), "the seed's self-registration")
        procs.append(start("run_peer", a_port, "--run-seconds", "15"))
        _wait(lambda: "Peer up" in _log(tmp_path / f"peer_log_{a_port}.txt"), "peer A")
        procs.append(start("run_peer", b_port))
        _wait(lambda: "Peer up" in _log(tmp_path / f"peer_log_{b_port}.txt"), "peer B")
        b = procs[-1]
        b.stdin.write("hello-from-the-cli\n")
        b.stdin.flush()
        _wait(lambda: "Gossip: hello-from-the-cli" in _log(tmp_path / f"peer_log_{a_port}.txt"), "the line at A")
        b.stdin.write("exit\n")
        b.stdin.flush()
        assert b.wait(timeout=30) == 0, b.stderr.read()
        for p in procs[:2]:
            p.stdin.close()
            assert p.wait(timeout=60) == 0, p.stderr.read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seed_log = _log(tmp_path / f"seed_log_{seed_port}.txt")
    assert f"Registered peer ('127.0.0.1', {a_port})" in seed_log
    assert f"Registered peer ('127.0.0.1', {b_port})" in seed_log
