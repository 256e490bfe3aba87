"""The port's CLI against the JAX CLI, and the JAX-pinned reference digests
that chip_smoke.py reproduces on the card."""

import json
from pathlib import Path

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

REF = Path(__file__).resolve().parent.parent / "tpu_gossip_torch" / "reference_digests.json"


def _summary(capsys, main, argv):
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1]


@pytest.mark.parametrize("extra", [[], ["--forward-once", "--sir-recover", "3"]])
def test_cli_digest_summary_equals_jax(capsys, extra):
    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "matching",
            "--rounds", "20", "--digest", *extra]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]


def test_cli_run_to_target_rounds_equal_jax(capsys):
    argv = ["--peers", "2000", "--mode", "push", "--fanout", "3", "--graph", "matching", "--seed", "5"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in ("summary", "mode", "n_peers", "rounds", "target", "coverage", "packed"):
        assert got[k] == want[k], k
    assert set(got) == set(want)


def test_reference_digests_are_what_jax_produces(capsys):
    ref = json.loads(REF.read_text())
    want, _ = _summary(capsys, jcli.main, ref["argv"])
    for k, v in ref["summary"].items():
        assert want[k] == v, k
    got, _ = _summary(capsys, tcli.main, ref["argv"] + ["--device", "cpu"])
    for k, v in ref["summary"].items():
        assert got[k] == v, k


@pytest.mark.parametrize("argv", [
    ["--graph", "pa", "--device", "cpu"],
    ["--graph", "matching", "--shard", "--device", "cpu"],
    ["--graph", "matching", "--churn-leave", "0.1", "--device", "cpu"],
])
def test_cli_flags_of_later_slices_exit_2(capsys, argv):
    assert tcli.main(["--peers", "100", *argv]) == 2
    assert "not ported yet" in capsys.readouterr().err
