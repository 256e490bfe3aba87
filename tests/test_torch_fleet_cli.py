"""``run_sim fleet`` against the JAX CLI on the CPU: the summary (lane
digests, family blocks) and the full ``--report`` of a small loaded,
controlled campaign under a loss sweep and a partition; ``--lane K
--solo`` equal to its batched lane; every refusal's exit code and words.
The checkpointed runs are ``test_torch_fleet_ckpt_cli.py``'s. The JAX CLI
runs in a child process (``jax_cli_child``, ``jax_in_child``)."""

import json

import pytest

from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_cli import _summary
from tests.test_torch_growth_cli_engines import jax_cli_child, jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

CAMPAIGN = """[campaign]
name = "cli-small"
seed = 1

[base]
peers         = 64
rounds        = 12
slots         = 4
fanout        = 2
mode          = "push_pull"
stream_rate   = 1.0
slot_ttl      = 10
control       = 0.9
control_hi    = 3
rewire_slots  = 3
churn_join    = 0.02
target_ratio  = 0.8

[[family]]
name     = "lossy"
scenario = "lossy.toml"
seeds    = 2

[[family.sweep]]
axis = "phase.loss"
dist = "uniform"
lo   = 0.05
hi   = 0.3

[[family]]
name     = "split"
scenario = "split.toml"
seeds    = 2
"""
LOSSY = """[scenario]
name = "lossy"
[[phase]]
name = "lossy"
start = 0
end = 6
loss = 0.2
delay = 0.1
"""
SPLIT = """[scenario]
name = "split"
[[phase]]
name = "split"
start = 2
end = 8
partition = "half"
"""
TIMING = ("wall_seconds", "swarm_rounds_per_sec")


@pytest.fixture
def campaign(tmp_path):
    """The campaign file, its scenarios beside it (resolved against the
    campaign's directory)."""
    (tmp_path / "lossy.toml").write_text(LOSSY)
    (tmp_path / "split.toml").write_text(SPLIT)
    path = tmp_path / "campaign.toml"
    path.write_text(CAMPAIGN)
    return str(path)


def port(capsys, argv):
    return _summary(capsys, tcli.main, argv + ["--device", "cpu"])[0]


def untimed(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in TIMING}


def test_fleet_summary_report_and_solo_equal_jax_cli(capsys, campaign, tmp_path):
    got = port(capsys, ["fleet", campaign, "--report", str(tmp_path / "port.json")])
    want, _ = jax_cli_child(["fleet", campaign, "--report", str(tmp_path / "jax.json")])
    assert untimed(got) == untimed(want)
    assert got["lanes"] == 4 and set(got) >= {"lane_digests", "stats_digests", "families"}
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    solo = port(capsys, ["fleet", campaign, "--lane", "2", "--solo"])
    assert solo["state_digest"] == got["lane_digests"]["2"] and solo["stats_digest"] == got["stats_digests"]["2"]
    assert solo == jax_cli_child(["fleet", campaign, "--lane", "2", "--solo"])[0]


def refusal(argv: list[str], capsys) -> list:
    rc = tcli.main(argv + ["--device", "cpu"])
    return [rc, capsys.readouterr().err.strip().splitlines()[-1]]


def test_fleet_refusals_in_jax_words(capsys, campaign, tmp_path):
    bad = tmp_path / "bad.toml"
    bad.write_text("[campaign]\nname = \"bad\"\n[base]\npeers = 16\nrounds = 4\n[[family]]\nname = \"f\"\n"
                   "seeds = 4\n[[family.sweep]]\naxis = \"peers\"\ndist = \"uniform\"\nlo = 16\nhi = 64\n")
    argvs = [["fleet", str(bad)], ["fleet", "/nonexistent/campaign.toml"], ["fleet", campaign, "--solo"],
             ["fleet", campaign, "--lane", "1"], ["fleet", campaign, "--lane", "9", "--solo"],
             ["fleet", campaign, "--checkpoint-every", "-1"], ["fleet", campaign, "--checkpoint-every", "4"],
             ["fleet", campaign, "--checkpoint-dir", str(tmp_path / "d")],
             ["fleet", campaign, "--checkpoint-every", "12", "--checkpoint-dir", str(tmp_path / "d")]]
    want = [[rc, err.strip().splitlines()[-1]] for rc, err in jax_in_child("tests.jax_pins", "cli_exits", argvs)]
    got = [refusal(argv, capsys) for argv in argvs]
    assert got == want
    assert all(rc == 2 for rc, _ in got) and "unknown sampled axis" in got[0][1]
