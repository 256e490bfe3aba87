"""``run_sim --profile-round`` and ``--profile`` of the port against the
JAX CLI: the same summary keys and stage names in the same order (the
values are timings and are not compared), the same refusals."""

import json

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tpu_gossip_torch.utils.profiling import TRACE_FILE
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ARGV = ["--peers", "500", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--profile-round", "2"]


def _summary(capsys, main, argv):
    assert main(argv) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_profile_round_summary_keys_equal_jax(capsys):
    # the JAX CLI's timing-free shape pinned (tests/jax_pins.json, group
    # profile: its in-process compiles can lose a test worker to XLA's CPU
    # compiler under the suite's load)
    from tests.jax_pins import CASES, pinned

    assert CASES["profile"]["cli_500"][1] == ARGV
    want = pinned("profile", "cli_500")
    got, got_err = _summary(capsys, tcli.main, ARGV + ["--device", "cpu"])
    assert list(got) == want["keys"]
    assert list(got["stages_ms"]) == want["stages"]
    for k in ("summary", "profile_round", "mode", "n_peers", "warm_rounds"):
        assert got[k] == want["fields"][k], k
    assert all(v is None or v > 0 for v in got["stages_ms"].values())
    # the stage table goes to stderr, row for row the stages
    rows = [ln.split("|")[1].strip() for ln in got_err.splitlines() if ln.startswith("| ")][1:]
    assert rows == want["stages"]
    assert want["table_rows"] == got_err.count("\n| ")


@pytest.mark.parametrize("extra", [["--shard"], ["--packed"]])
def test_profile_round_refusals_equal_jax(capsys, extra):
    argv = ["--peers", "500", "--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--profile-round", "2",
            *extra]
    assert jcli.main(argv) == 2
    capsys.readouterr()
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    assert "--profile-round" in capsys.readouterr().err


def test_profile_writes_a_trace(capsys, tmp_path):
    argv = ["--peers", "300", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--rounds", "2",
            "--quiet", "--device", "cpu", "--profile", str(tmp_path / "t")]
    summary, _ = _summary(capsys, tcli.main, argv)
    assert summary["rounds_run"] == 2
    assert "traceEvents" in json.loads((tmp_path / "t" / TRACE_FILE).read_text())


def test_profile_round_writes_a_trace(capsys, tmp_path):
    argv = ["--peers", "300", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--profile-round", "1",
            "--device", "cpu", "--profile", str(tmp_path / "t")]
    _summary(capsys, tcli.main, argv)
    assert (tmp_path / "t" / TRACE_FILE).exists()
