"""``run_sim --grow`` in the port against the JAX CLI on the CPU: the
refusals of ``tests/sim/test_growth.py::test_cli_grow_rejections`` (exit 2,
the JAX CLI's first stderr line), the flags of later slices, the growth
summary keys, and a mid-growth checkpoint resumed across the packages.
Each engine's growing run is ``test_torch_growth_cli_engines.py``'s."""

import json
import shutil

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

BASE = ["--peers", "64", "--rounds", "8", "--slots", "2", "--quiet"]
WAVE = "[scenario]\nname = 'w'\n[[phase]]\nname = 'w'\nstart = 0\nend = 4\njoin_burst = 4\n"
OUTSIDE = "[scenario]\nname = 'b'\n[[phase]]\nname = 'b'\nstart = 0\nend = 4\nblackout = {ids = [100]}\n"
REFUSALS = {
    "target_not_above_peers": ["--grow", "32"],
    "capacity_below_target": ["--grow", "128", "--grow-capacity", "100"],
    "shard_remat": ["--grow", "128", "--shard", "--remat-every", "4"],
    "attach_too_wide": ["--grow", "128", "--m", "64"],
    "negative_rate": ["--grow", "128", "--grow-rate", "-1"],
    "join_burst_without_grow": ["--scenario", WAVE],
    "node_set_outside_initial_peers": ["--grow", "128", "--scenario", OUTSIDE],
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_grow_refusals_exit_2_with_jax_words(capsys, tmp_path, one_shard, name):
    argv = BASE + REFUSALS[name]
    if "--scenario" in argv:
        i = argv.index("--scenario") + 1
        path = tmp_path / "s.toml"
        path.write_text(argv[i])
        argv[i] = str(path)
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err.strip().splitlines()
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()
    assert got and got[0] == want[0]
    if name == "node_set_outside_initial_peers":
        assert got == want and "INITIAL --peers" in got[-1]


@pytest.mark.parametrize("argv,says", [
    (["--graph", "matching", "--shard", "--grow", "128", "--max-rounds", "40"], "(11b)"),
    (["--graph", "pa", "--grow", "128", "--rounds", "8", "--transport", "sparse"], "(11b)"),
])
def test_grow_flags_of_later_slices_exit_2(capsys, monkeypatch, argv, says):
    """The sharded matching engine and the transports (ROADMAP item 11b,
    ported since): a growing run to target on the 2-shard matching mesh
    equals the JAX CLI's on a 2-device mesh; ``--transport`` without
    ``--shard`` exits 2 in JAX's words (the composed profile rows came with
    9f: ``test_torch_pipeline_cli.py``)."""
    from tests.test_torch_mesh_cli import equals_jax_mesh_cli

    got = equals_jax_mesh_cli(capsys, monkeypatch, ["--peers", "64", *argv])
    assert ("grow_target" in got) == ("--shard" in argv) and says == "(11b)"


def test_grow_summary_keys_equal_jax(capsys):
    argv = ["--peers", "64", "--grow", "96", "--grow-rate", "8", "--rounds", "10", "--slots", "2", "--m", "2",
            "--quiet"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    grown = ("grow_target", "grow_rate", "grow_capacity", "n_members", "degree_gamma")
    assert {k: got[k] for k in grown} == {k: want[k] for k in grown}
    assert got["n_members"] == 96 and got["grow_target"] == 96
    assert set(got) == set(want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mid_growth_checkpoint_resumes_across_packages(capsys, tmp_path, writer):
    """A growing matching run checkpointed every 4 rounds; the newest
    checkpoints are dropped, so the other package resumes mid-growth from
    round 4 and ends on the writer's uninterrupted digests and membership."""
    from tpu_gossip_torch.ckpt import load_checkpoint

    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "matching", "--grow", "2600",
            "--rounds", "12", "--quiet", "--checkpoint-every", "4", "--checkpoint-dir",
                                  str(tmp_path / "ck")]
    write, finish = (jcli.main, tcli.main) if writer == "jax" else (tcli.main, jcli.main)
    full, _ = _summary(capsys, write, argv + ([] if writer == "jax" else ["--device", "cpu"]))
    shutil.rmtree(tmp_path / "ck" / "ckpt-00000008")
    assert 2000 < int(load_checkpoint(tmp_path / "ck" / "ckpt-00000004", device="cpu")[0].exists.sum()) < 2600
    assert finish(["resume", str(tmp_path / "ck")] + (["--device", "cpu"] if writer == "jax" else [])) == 0
    out = capsys.readouterr()
    assert "resume: ckpt-00000004 at round 4" in out.err
    resumed = json.loads(out.out.strip().splitlines()[-1])
    for k in ("state_digest", "stats_digest", "n_members", "grow_rate", "grow_capacity", "degree_gamma"):
        assert resumed[k] == full[k], k
