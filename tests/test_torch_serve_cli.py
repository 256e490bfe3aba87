"""``run_sim serve``'s refusals and exits in the port against the JAX CLI on
the CPU: every ``_validate_serve`` rejection with the JAX CLI's words and
exit 2 (pinned in ``tests/jax_pins.json``, group ``serve``), a port
conflict and a missing card exit 2, ``--checkpoint`` saves the final state;
and the serve group's pins recomputed by the JAX package in a child
process."""

import socket

import numpy as np
import pytest
import torch

from tests import jax_pins
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_serve_replay import port_serve
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("i", range(len(jax_pins.SERVE_REFUSED)))
def test_refusal_equals_jax(i):
    rc, _, err = port_serve(jax_pins.SERVE_REFUSED[i])
    assert [rc, err.strip().splitlines()[-1]] == jax_pins.pinned("serve", "refusals")[i]


def test_port_conflict_and_missing_card_exit_2(monkeypatch):
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    try:
        rc, _, err = port_serve(["--peers", "48", "--slots", "4", "--fanout", "2", "--quiet", "--rounds", "6",
                                 "--slot-ttl", "10", "--port", str(blocker.getsockname()[1])])
    finally:
        blocker.close()
    assert rc == 2 and "serve: cannot listen on 127.0.0.1:" in err
    from tpu_gossip_torch.cli import run_sim as tcli

    # --hosts (ROADMAP item 11c, ported since) rides along as the JAX CLI's
    # serve lets it: the served run is JAX's, digests included
    import contextlib
    import io
    import json

    from tpu_gossip.cli import run_sim as jcli

    argv = ["--peers", "48", "--rounds", "6", "--slot-ttl", "10", "--quiet", "--hosts", "2"]
    rc, got, _ = port_serve(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert jcli.main(["serve", *argv]) == rc == 0
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {k: got[k] for k in ("state_digest", "stats_digest")} == {k: want[k] for k in ("state_digest",
                                                                                          "stats_digest")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["serve", "--peers", "48", "--rounds", "6", "--slot-ttl", "10"]) == 2
    assert tcli.main(["serve", "--peers", "48", "--rounds", "6", "--slot-ttl", "10", "--hosts", "2"]) == 2


def test_checkpoint_and_trace_out(tmp_path, monkeypatch):
    """``--checkpoint F`` saves the final (unpacked) state and
    ``--trace-out`` the trace, as the JAX CLI does."""
    from tpu_gossip_torch.core.state import load_swarm
    from tpu_gossip_torch.serve import ServeTrace
    from tpu_gossip_torch.utils.digest import state_digest

    argv = [*jax_pins.SERVE_ENGINES["matching_packed"][1], "--checkpoint", str(tmp_path / "fin.npz"),
            "--trace-out", str(tmp_path / "t.jsonl")]
    rc, got, err = port_serve(argv, monkeypatch, jax_pins.argv_windows(jax_pins.SERVE_SEED, argv))
    assert rc == 0, err
    fin = load_swarm(str(tmp_path / "fin.npz"), device="cpu")
    from tpu_gossip_torch.core.packed import pack_state

    assert state_digest(pack_state(fin)) == got["state_digest"]
    trace = ServeTrace.load(tmp_path / "t.jsonl")
    assert trace.num_rounds == 10 and trace.total_arrivals == got["serve"]["trace_arrivals"]
    assert np.sum([r.overflow for r in trace.rounds]) == got["serve"]["ingest_overflow"]


def test_jax_pins_are_current():
    """The serve group's pins recomputed by the JAX package in a child
    process: the ingest rules and the refusals."""
    names = ["ingest_rules", "refusals"]
    got = jax_in_child("tests.jax_pins", "compute", "serve", names)
    assert got == {name: jax_pins.pinned("serve", name) for name in names}
