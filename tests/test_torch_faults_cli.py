"""The port's CLI under ``--silent-frac`` and ``--scenario`` against the JAX
CLI's: the summaries (the ``phases`` report and the digests included) and
the per-round rows on every engine the port runs at n=2000, the
refusals (invalid scenarios, the phase keys of later slices, the flag
combinations the JAX CLI refuses) with the JAX CLI's words and exit 2,
and a checkpoint written mid-scenario by either package finished by the
other onto the uninterrupted digests."""

import json
import shutil

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import TIMING, one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

BASE = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--digest", "--seed", "3"]


def _sc(name):
    return ["--scenario", f"scenarios/{name}.toml"]


PATHS = {  # name: extra argv
    "split_brain_matching": ["--graph", "matching", *_sc("split_brain"), "--rounds", "26"],
    "lossy_links_matching_packed": ["--graph", "matching", "--packed", *_sc("lossy_links"), "--rounds", "26"],
    "rack_failure_staircase": ["--graph", "chung-lu", "--staircase", *_sc("rack_failure"), "--rounds", "22"],
    "churn_storm_exactly_k_churn": ["--graph", "chung-lu", *_sc("churn_storm"), "--churn-leave", "0.01",
                                    "--churn-join", "0.1", "--rewire-slots", "2", "--rounds", "24"],
    "split_brain_shard_k6_silent": ["--graph", "chung-lu", "--shard", "--staircase", *_sc("split_brain"),
                                    "--silent-frac", "0.05", "--rounds", "24"],
    "lossy_links_shard_remat": ["--graph", "chung-lu", "--shard", *_sc("lossy_links"), "--churn-leave", "0.01",
                                "--churn-join", "0.1", "--rewire-slots", "2", "--remat-every", "8", "--rounds", "26",
                                "--quiet"],
    "rack_failure_to_target": ["--graph", "matching", *_sc("rack_failure"), "--max-rounds", "40", "--quiet"],
}


@pytest.mark.parametrize("name", list(PATHS))
def test_fault_cli_summary_and_rows_equal_jax(capsys, one_shard, name):
    argv = BASE + PATHS[name]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in TIMING:
        assert (k in got) == (k in want), k
        got.pop(k, None), want.pop(k, None)
    assert got == want
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]
    assert got["scenario"]
    if "--rounds" in argv and "--remat-every" not in argv:
        assert got["phases"] and got["phases"] == want["phases"]


def _bad(tmp_path, text):
    p = tmp_path / "bad.toml"
    p.write_text(text)
    return str(p)


REFUSALS = {  # name: (argv after the base, scenario file text or None)
    "beyond_horizon": (["--rounds", "10"], "[scenario]\n[[phase]]\nstart = 0\nend = 50\n"),
    "overlap": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 9\n[[phase]]\nstart = 5\nend = 12\n"),
    "unknown_key": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 5\nlos = 0.1\n"),
    "bad_value": (["--rounds", "20"], "[scenario]\nname = @@@\n"),
    "missing_file": (["--rounds", "20", "--scenario", "no/such/scenario.toml"], None),
    "max_rounds_horizon": (["--max-rounds", "8"], "[[phase]]\nstart = 0\nend = 9\nloss = 0.1\n"),
    "profile_round": (["--profile-round", "2"], "[[phase]]\nstart = 0\nend = 5\nloss = 0.1\n"),
    "node_sets_shard_remat": (["--rounds", "20", "--shard", "--churn-join", "0.1", "--rewire-slots", "2",
                               "--remat-every", "4"], "[[phase]]\nstart = 0\nend = 5\nblackout = \"half\"\n"),
    "shards_unsharded": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 5\nblackout = {shards = [0]}\n"),
    "join_burst": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 5\njoin_burst = 4\n"),
    "accusers": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 5\naccusers = {ids = [1, 2]}\n"),
    "forgers": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 5\nforgers = {frac = 0.1}\n"),
    "floods": (["--rounds", "20"], "[[phase]]\nstart = 0\nend = 5\nfloods = {span = [0.0, 0.1]}\n"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_fault_cli_refusals_exit_2_with_jax_words(capsys, tmp_path, one_shard, name):
    """Invalid scenarios, and the phase keys the JAX CLI refuses without
    their flags: adversaries without --quorum-k, admission waves without
    --grow."""
    extra, text = REFUSALS[name]
    argv = ["--peers", "300", "--graph", "chung-lu", *extra]
    if text is not None:
        argv += ["--scenario", _bad(tmp_path, text)]
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err.strip().splitlines()
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()
    assert got and got[0] == want[0]


SLOW_NET = """[scenario]
name = "slow-net"

[[phase]]
name  = "slow"
start = 2
end   = 14
loss  = 0.2
delay = 0.6
"""


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mid_scenario_checkpoint_resumes_across_packages(capsys, tmp_path, writer):
    """A run under a loss-and-delay phase checkpointed every 4 rounds; the
    newest checkpoints are dropped, so the other package resumes from round
    8, mid-phase with its delay buffer live, and ends on the writer's
    uninterrupted digests and phase report."""
    from tpu_gossip_torch.ckpt import load_checkpoint

    argv = BASE + ["--graph", "matching", "--scenario", _bad(tmp_path, SLOW_NET), "--rounds", "20", "--quiet",
                   "--checkpoint-every", "4", "--checkpoint-dir", str(tmp_path / "ck")]
    write, finish = (jcli.main, tcli.main) if writer == "jax" else (tcli.main, jcli.main)
    full, _ = _summary(capsys, write, argv + ([] if writer == "jax" else ["--device", "cpu"]))
    for late in (12, 16):
        shutil.rmtree(tmp_path / "ck" / f"ckpt-{late:08d}")
    assert bool(load_checkpoint(tmp_path / "ck" / "ckpt-00000008", device="cpu")[0].fault_held.any())
    assert finish(["resume", str(tmp_path / "ck")] + (["--device", "cpu"] if writer == "jax" else [])) == 0
    out = capsys.readouterr()
    assert "resume: ckpt-00000008 at round 8" in out.err
    resumed = json.loads(out.out.strip().splitlines()[-1])
    for k in ("state_digest", "stats_digest", "scenario", "phases", "total_msgs", "final_coverage"):
        assert resumed[k] == full[k], k
    assert full["phases"][0]["msgs_held_max"] > 0 and full["phases"][0]["msgs_dropped"] > 0
