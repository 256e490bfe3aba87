"""The port's CLI under churn against the JAX CLI's: every churned path
chip_smoke.py drives at 1M (matching with a compact side-path table, its
packed twin, the staircase and exactly-k paths with dense side paths, the
staircase remat loop, the sharded K6 path and its scatter twin, the
sharded remat loop) prints the JAX summary, digests and remat counts
included, at n=2000, the refusals exit 2 where the JAX CLI's do, and the
checkpointed remat loops resume across the packages."""

import pytest

from tpu_gossip import dist as jdist
from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_cli import _summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

BASE = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--churn-leave", "0.01", "--churn-join", "0.1",
        "--rewire-slots", "2", "--digest", "--quiet", "--seed", "2"]
TIMING = ("epoch_rebuild_seconds_total", "wall_seconds", "peers_rounds_per_sec", "ms_per_round",
          "ms_per_round_amortized")

PATHS = {  # the chip_smoke phase each path shrinks: extra argv
    "4i_matching_compact": ["--graph", "matching", "--rewire-compact-cap", "96", "--rounds", "12"],
    "4j_matching_packed": ["--graph", "matching", "--rewire-compact-cap", "96", "--rounds", "12", "--packed"],
    "4k_staircase_dense": ["--graph", "chung-lu", "--staircase", "--rounds", "12"],
    "4l_exactly_k_dense": ["--graph", "chung-lu", "--rounds", "12"],
    "4m_staircase_remat": ["--graph", "chung-lu", "--staircase", "--rewire-compact-cap", "64", "--remat-every", "5",
                           "--rounds", "14"],
    "4n_shard_k6": ["--graph", "chung-lu", "--shard", "--staircase", "--rounds", "12"],
    "4n_shard_scatter": ["--graph", "chung-lu", "--shard", "--rounds", "12"],
    "4o_shard_remat": ["--graph", "chung-lu", "--shard", "--staircase", "--remat-every", "6", "--rounds", "14"],
}


@pytest.fixture
def one_shard(monkeypatch):
    """Both CLIs' meshes pinned to one shard."""
    j_make, t_make = jdist.make_mesh, tdist.make_mesh
    monkeypatch.setattr(jdist, "make_mesh", lambda *a, **k: j_make(1))
    monkeypatch.setattr(tdist, "make_mesh", lambda device="cuda": t_make(1, device=device))


@pytest.mark.parametrize("name", list(PATHS))
def test_churn_cli_summary_equals_jax(capsys, one_shard, name):
    argv = BASE + PATHS[name]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in TIMING:
        assert (k in got) == (k in want), k
        got.pop(k, None), want.pop(k, None)
    assert got == want
    if "--remat-every" in argv:
        assert got["remats"] > 0 and got["remat_overflow_edges"] == 0


def test_churn_cli_twins_are_digest_equal(capsys, one_shard):
    """4j's packed run equals 4i's, 4n's scatter receive equals K6's."""
    runs = {}
    for name in ("4i_matching_compact", "4j_matching_packed", "4n_shard_k6", "4n_shard_scatter"):
        runs[name], _ = _summary(capsys, tcli.main, BASE + PATHS[name] + ["--device", "cpu"])
    assert dict(runs["4i_matching_compact"], packed=True) == runs["4j_matching_packed"]
    assert runs["4n_shard_k6"] == runs["4n_shard_scatter"]


@pytest.mark.parametrize("argv,says", [
    (["--graph", "matching", "--remat-every", "4"], "--graph matching cannot re-materialize locally"),
    (["--graph", "chung-lu", "--packed", "--remat-every", "4"], "--packed cannot compose with --remat-every"),
])
def test_churn_cli_refusals_exit_2_like_jax(capsys, argv, says):
    full = ["--peers", "300", "--rounds", "4", "--churn-join", "0.1", "--rewire-slots", "2", *argv]
    assert jcli.main(full) == 2
    assert says in capsys.readouterr().err
    assert tcli.main(full + ["--device", "cpu"]) == 2
    assert says in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--checkpoint-every", "4", "--checkpoint-dir", "ck", "--remat-every", "4"],
    ["--shard", "--checkpoint-every", "4", "--checkpoint-dir", "ck", "--remat-every", "4"],
])
def test_checkpointed_remat_is_not_ported(capsys, tmp_path, one_shard, argv):
    """The checkpointed remat loops, local and sharded: each runs with the
    JAX CLI's summary, and its epoch-boundary checkpoint (round 4, before
    the fold) resumes in either package onto the same digests."""
    full = ["--peers", "300", "--graph", "chung-lu", "--rounds", "8", "--churn-join", "0.1", "--rewire-slots", "2",
            "--digest", *argv]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want, _ = _summary(capsys, jcli.main, [jdir if a == "ck" else a for a in full])
    got, _ = _summary(capsys, tcli.main, [tdir if a == "ck" else a for a in full] + ["--device", "cpu"])
    for k in TIMING:
        got.pop(k, None), want.pop(k, None)
    assert got == want and got["remats"] == 1
    for main, d, extra in ((tcli.main, jdir, ["--device", "cpu"]), (jcli.main, tdir, [])):
        res, _ = _summary(capsys, main, ["resume", d, *extra])
        assert (res["state_digest"], res["stats_digest"]) == (want["state_digest"], want["stats_digest"])
