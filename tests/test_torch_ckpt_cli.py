"""Checkpoints and resume through the port's CLI against the JAX CLI's, at
n=2000 on every fixed-horizon local path the port runs (the sharded ones
are in ``test_torch_ckpt_shard_cli.py``): the port's checkpointed
summary equals JAX's, a directory the JAX CLI wrote (its newest checkpoint
deleted, as if the crash hit mid-save) finishes under the port's
``resume`` on the uninterrupted run's digests, and a directory the port
wrote finishes under JAX's ``resume`` on the same digests. Also the
refusals: JAX's checkpoint validator, the resume options of later slices,
and a recorded flag the port has not ported."""

import argparse
import json
import shutil

import numpy as np
import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.ckpt import list_checkpoint_steps
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

BASE = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--quiet", "--seed", "2"]
CHURN = ["--churn-leave", "0.01", "--churn-join", "0.1", "--rewire-slots", "2"]
TIMING = ("wall_seconds", "epoch_rebuild_seconds_total")

PATHS = {  # each fixed-horizon local path: its argv, checkpointed every 4 rounds of 12 (14 for the remat loop)
    "matching": ["--graph", "matching", "--rounds", "12"],
    "pa": ["--graph", "pa", "--m", "2", "--rounds", "12"],
    "chung_lu": ["--graph", "chung-lu", "--rounds", "12"],
    "staircase": ["--graph", "chung-lu", "--staircase", "--rounds", "12"],
    "matching_packed": ["--graph", "matching", "--packed", "--rounds", "12"],
    "pa_packed": ["--graph", "pa", "--m", "2", "--packed", "--rounds", "12"],
    "chung_lu_packed": ["--graph", "chung-lu", "--packed", "--rounds", "12"],
    "staircase_packed": ["--graph", "chung-lu", "--staircase", "--packed", "--rounds", "12"],
    "churn_dense": ["--graph", "chung-lu", "--staircase", *CHURN, "--rounds", "12"],
    "churn_compact": ["--graph", "matching", *CHURN, "--rewire-compact-cap", "96", "--rounds", "12"],
    "staircase_remat": ["--graph", "chung-lu", "--staircase", *CHURN, "--rewire-compact-cap", "64",
                        "--remat-every", "5", "--rounds", "14"],
}


def _run(capsys, main, argv):
    """(exit code, summary or None, stderr) of one CLI call."""
    rc = main(argv)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), out.err


def _digests(summary: dict) -> tuple:
    return summary["state_digest"], summary["stats_digest"]


def crosses_packages(capsys, tmp_path, argv):
    """The three checks of one checkpointed path (``argv`` with
    ``--checkpoint-every``)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    rc, want, err = _run(capsys, jcli.main, argv + ["--checkpoint-dir", str(jdir)])
    assert rc == 0, err
    rc, got, err = _run(capsys, tcli.main, argv + ["--checkpoint-dir", str(tdir), "--device", "cpu"])
    assert rc == 0, err
    for k in TIMING:
        assert (k in got) == (k in want), k
        got.pop(k, None), want.pop(k, None)
    assert got == want
    # the newest checkpoint torn away in both directories: each package
    # finishes the other's run from the one before
    newest = list_checkpoint_steps(jdir)[0][1].name
    assert [p.name for _s, p in list_checkpoint_steps(tdir)][0] == newest
    shutil.rmtree(jdir / newest), shutil.rmtree(tdir / newest)
    rc, res, err = _run(capsys, tcli.main, ["resume", str(jdir), "--device", "cpu"])
    assert rc == 0, err
    assert _digests(res) == _digests(want)
    assert "unknown args" not in err
    rc, res, err = _run(capsys, jcli.main, ["resume", str(tdir)])
    assert rc == 0, err
    assert _digests(res) == _digests(want)
    assert "unknown args" not in err
    return want


@pytest.mark.parametrize("name", list(PATHS))
def test_checkpointed_path_crosses_packages(capsys, tmp_path, name):
    crosses_packages(capsys, tmp_path, BASE + PATHS[name] + ["--checkpoint-every", "4"])


@pytest.mark.parametrize("argv,needle", [
    (["--rounds", "10", "--checkpoint-every", "3"], "--checkpoint-dir"),
    (["--checkpoint-every", "3", "--checkpoint-dir", "d"], "FIXED horizon"),
    (["--rounds", "10", "--keep", "2"], "--checkpoint-every"),
    (["--rounds", "10", "--checkpoint-shards", "2"], "--checkpoint-every"),
    (["--rounds", "10", "--checkpoint-every", "12", "--checkpoint-dir", "d"], "below --rounds"),
    (["--rounds", "12", "--checkpoint-every", "4", "--checkpoint-dir", "d", "--shard", "--remat-every", "3"],
     "MULTIPLE of --remat-every"),
])
def test_checkpoint_rejections_exit_2_like_jax(capsys, argv, needle):
    full = ["--peers", "64", "--slots", "4", "--quiet"] + argv
    assert jcli.main(full) == 2
    want = capsys.readouterr().err
    assert tcli.main(full + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert needle in got and got == want


def test_resume_of_an_empty_directory_exits_2(capsys, tmp_path):
    assert tcli.main(["resume", str(tmp_path), "--device", "cpu"]) == 2
    assert "no checkpoints" in capsys.readouterr().err


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX checkpoint directory of a small local run."""
    d = tmp_path_factory.mktemp("jax") / "ck"
    assert jcli.main(["--peers", "200", "--rounds", "8", "--checkpoint-every", "4", "--checkpoint-dir", str(d),
                      "--quiet"]) == 0
    return d


@pytest.mark.parametrize("extra,names", [
    (["--local"], "restores a --shard --graph matching checkpoint"),
    (["--hosts", "2"], "item 11c"),
    (["--lane", "1", "--solo"], "single-run checkpoint"),
    (["--lane", "0"], "single-run checkpoint"),
])
def test_resume_options_of_later_slices_exit_2(capsys, jax_dir, extra, names):
    """``--local`` on a local run's checkpoint (11b, ported since), the
    fleet's lane options (ROADMAP item 10) on a run checkpoint and
    ``--hosts`` on a local run's checkpoint (11c, ported since: only a
    sharded run's mesh re-folds) exit 2 in JAX's words."""
    capsys.readouterr()
    assert tcli.main(["resume", str(jax_dir), "--device", "cpu", *extra]) == 2
    err = capsys.readouterr().err
    assert ("re-folds a SHARDED checkpoint's mesh" if "--hosts" in extra else names) in err
    assert jcli.main(["resume", str(jax_dir), *extra]) == 2
    assert err.strip().splitlines()[-1] == capsys.readouterr().err.strip().splitlines()[-1]


def _rewrite_run(src, dst, **run):
    """A copy of checkpoint directory ``src`` whose manifests' run sections
    carry ``run`` (and, with ``kind``, another kind)."""
    shutil.copytree(src, dst)
    kind = run.pop("kind", None)
    for _step, path in list_checkpoint_steps(dst):
        m = json.loads((path / "MANIFEST.json").read_text())
        m["kind"] = kind or m["kind"]
        m["run"].update(run)
        (path / "MANIFEST.json").write_text(json.dumps(m))
    return dst


def test_resume_of_a_fleet_manifest_exits_2(capsys, tmp_path, jax_dir):
    """A fleet manifest whose run section names no campaign exits 2 in the
    JAX CLI's words (fleet checkpoints resume since ROADMAP item 10:
    ``test_torch_fleet_ckpt_cli.py``)."""
    d = _rewrite_run(jax_dir, tmp_path / "ck", kind="fleet")
    capsys.readouterr()
    assert jcli.main(["resume", str(d)]) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tcli.main(["resume", str(d), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.strip().splitlines()[-1] == want and "cannot rebuild campaign" in want


@pytest.mark.parametrize("key,value,flag,item", [
    ("scenario", "s.toml", "--scenario", "item 9"),
    ("silent_frac", 0.1, "--silent-frac", "item 9"),
    ("transport", "sparse", "--transport", "item 11b"),
    ("hosts", 2, "--hosts", "item 11c"),
])
def test_resume_of_an_unported_recorded_flag_exits_2(capsys, tmp_path, jax_dir, key, value, flag, item):
    """A JAX manifest holding a flag the port has not ported, at another
    value than JAX's default, names the flag and the slice; at the default
    it resumes. A flag ported since (``--scenario`` and ``--silent-frac``,
    ROADMAP item 9a; ``--transport``, 11b; ``--hosts``, 11c) resumes as the
    JAX CLI's resume does: the same exit code, error line or summary (a
    recorded scenario file that is not there, or a recorded ``--hosts 2`` on
    a local run, exits 2 with the JAX CLI's words)."""
    d = _rewrite_run(jax_dir, tmp_path / "ck", **{key: value})
    capsys.readouterr()
    if key not in tcli.JAX_FLAG_DEFAULTS:
        rc = jcli.main(["resume", str(d)])
        want = capsys.readouterr()
        assert tcli.main(["resume", str(d), "--device", "cpu"]) == rc
        got = capsys.readouterr()
        if rc:
            assert got.err.strip().splitlines()[-1] == want.err.strip().splitlines()[-1]
            assert flag in got.err
        else:
            assert got.out.strip().splitlines()[-1] == want.out.strip().splitlines()[-1]
        return
    assert tcli.main(["resume", str(d), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and flag in err and item in err
    assert tcli.main(["resume", str(jax_dir), "--device", "cpu", "--quiet"]) == 0


def test_unported_flag_defaults_equal_jax_parser():
    """The port's table of the JAX CLI's flags it has not ported holds
    JAX's parser defaults, and covers every JAX flag the port's parser
    lacks (none since ROADMAP item 11c); the port's own flags are
    ``--device`` and ``--dist-backend``."""
    jax_base = vars(jcli.build_parser().parse_args([]))
    port_base = vars(tcli.build_parser().parse_args([]))
    assert set(tcli.JAX_FLAG_DEFAULTS) == set(jax_base) - set(port_base)
    for key, (default, _item) in tcli.JAX_FLAG_DEFAULTS.items():
        assert jax_base[key] == default and type(jax_base[key]) is type(default), key
    assert set(port_base) - set(jax_base) == {"device", "dist_backend"}
    assert {k: port_base[k] for k in ("hosts", "coordinator", "num_processes", "process_id")} == {
        k: jax_base[k] for k in ("hosts", "coordinator", "num_processes", "process_id")}


def test_recorded_run_section_round_trips_floats_and_omits_port_flags():
    args = tcli.build_parser().parse_args(["--churn-leave", "0.002", "--churn-join", "0.02", "--gamma", "2.3",
                                           "--profile", "tr", "--device", "cpu"])
    run = json.loads(json.dumps(tcli._manifest_run_config(args)))
    assert run["churn_leave"] == 0.002 and run["churn_join"] == 0.02 and run["gamma"] == 2.3
    assert "device" not in run and "profile" not in run
    jax_args = argparse.Namespace(**{**vars(jcli.build_parser().parse_args([])), **run})
    assert set(run) <= set(vars(jax_args)) and np.float64(run["churn_leave"]) == np.float64(0.002)


def test_final_checkpoint_npz_loads_in_jax(capsys, tmp_path):
    """``--checkpoint F`` saves the final state as the JAX CLI's does: the
    JAX loader reads the port's file onto the JAX run's final state."""
    from tpu_gossip.core.state import load_swarm
    from tpu_gossip.fleet.engine import state_digest

    argv = BASE + PATHS["churn_compact"] + ["--digest"]
    rc, want, err = _run(capsys, jcli.main, argv + ["--checkpoint", str(tmp_path / "jax.npz")])
    assert rc == 0, err
    rc, got, err = _run(capsys, tcli.main, argv + ["--checkpoint", str(tmp_path / "port.npz"), "--device", "cpu"])
    assert rc == 0, err
    assert got == want
    assert state_digest(load_swarm(tmp_path / "port.npz")) == want["state_digest"]
    assert state_digest(load_swarm(tmp_path / "jax.npz")) == want["state_digest"]
