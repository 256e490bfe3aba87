"""``run_sim --shard --pipeline`` and the composed ``--profile-round`` rows
against the JAX CLI on the CPU: the ``--pipeline`` refusals in JAX's
words; the pipelined sharded run's summary and rows equal to the JAX
CLI's, key for key, unpacked and packed, with and without a stream (its
age-out guard live); depth 0's summary the serial one's; a pipelined run
checkpointed mid-flight by one package and finished by the other. The JAX
CLI's runs go to a child process (``jax_cli_child``); the composed profile
rows are ``test_torch_pipeline_profile.py``'s."""

import json
import shutil

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests.test_torch_growth_cli_engines import jax_cli_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SHARD = ["--peers", "2000", "--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--shard"]
RUNS = {
    "staircase": SHARD + ["--staircase", "--pipeline", "1", "--rounds", "16"],
    "packed": SHARD + ["--packed", "--pipeline", "1", "--rounds", "16"],
    "stream": SHARD + ["--staircase", "--pipeline", "1", "--stream", "2", "--slot-ttl", "16", "--rounds", "30"],
    "stream_packed": SHARD + ["--packed", "--pipeline", "1", "--stream", "2", "--slot-ttl", "16", "--rounds", "30"],
}


@pytest.mark.parametrize("argv", [
    ["--pipeline", "1"],
    ["--pipeline", "1", "--stream", "2", "--rounds", "20"],
    ["--pipeline", "0", "--control", "0.9", "--rounds", "8"],
    ["--pipeline", "2", "--shard"],
], ids=["local", "stream", "control", "depth_2"])
def test_pipeline_refusals_in_jax_words(capsys, argv):
    """Exit 2 with the JAX CLI's last stderr line (an invalid depth is the
    parser's, whose program name differs)."""
    base = ["--peers", "96", "--rounds", "5", "--quiet"]
    assert exit_code(jcli.main, base + argv) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert exit_code(tcli.main, base + argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split(": error: ")[-1] == want.split(": error: ")[-1]


def exit_code(main, argv) -> int:
    try:
        return main(argv)
    except SystemExit as e:
        return e.code


@pytest.mark.parametrize("name", list(RUNS))
def test_pipelined_shard_run_equals_jax_cli(capsys, one_shard, name):
    argv = RUNS[name] + ["--digest"]
    want, want_rows = jax_cli_child(argv, one_shard=True)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want and got["pipeline"] == 1
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]


def test_depth0_summary_is_the_serial_one(capsys, one_shard):
    """JAX's CLI cell: a pipelined run reports its depth, and depth 0
    prints the serial run's summary with ``pipeline: 0`` added."""
    base = ["--peers", "200", "--rounds", "6", "--slots", "4", "--fanout", "2", "--quiet", "--shard", "--digest"]
    depth1, _ = _summary(capsys, tcli.main, base + ["--pipeline", "1", "--device", "cpu"])
    assert depth1 == jax_cli_child(base + ["--pipeline", "1"], one_shard=True)[0] and depth1["pipeline"] == 1
    serial, _ = _summary(capsys, tcli.main, base + ["--device", "cpu"])
    depth0, _ = _summary(capsys, tcli.main, base + ["--pipeline", "0", "--device", "cpu"])
    assert "pipeline" not in serial and depth0.pop("pipeline") == 0
    assert depth0 == serial


@pytest.mark.parametrize("write_with", ["port", "jax"])
def test_pipelined_checkpoint_resumes_across_packages(capsys, one_shard, tmp_path, write_with):
    """A pipelined sharded run checkpointed every 4 rounds (the in-flight
    buffer in each checkpoint), its ckpt-8 removed, finished by the other
    package from round 4: the uninterrupted run's digests."""
    argv = RUNS["staircase"][:-2] + ["--rounds", "12", "--quiet", "--checkpoint-every", "4"]
    full, _ = _summary(capsys, tcli.main, argv + ["--checkpoint-dir", str(tmp_path / "full"), "--device", "cpu"])
    d = str(tmp_path / "run")
    if write_with == "port":
        _summary(capsys, tcli.main, argv + ["--checkpoint-dir", d, "--device", "cpu"])
    else:
        jax_cli_child(argv + ["--checkpoint-dir", d], one_shard=True)
    shutil.rmtree(tmp_path / "run" / "ckpt-00000008")
    if write_with == "port":
        got = jax_cli_child(["resume", d], one_shard=True)[0]
    else:
        got, _ = _summary(capsys, tcli.main, ["resume", d, "--device", "cpu"])
    for k in ("state_digest", "stats_digest", "pipeline", "total_msgs", "final_coverage"):
        assert got[k] == full[k], k
