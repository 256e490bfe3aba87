"""Checkpoints of the sharded matching engine across the packages on a
2-shard mesh: a ``--shard --graph matching --transport sparse`` run
checkpointed every 4 of 12 rounds by one package, its newest checkpoint
torn away, finished by the other (the JAX CLI in a child process on a
2-device mesh) onto the uninterrupted run's pinned digests; and ``run_sim
resume D --local``, the checkpoint's S-shard layout rebuilt and finished on
the local engine, in both packages."""

import json
import shutil

from tpu_gossip_torch.ckpt import list_checkpoint_steps
from tpu_gossip_torch.cli import run_sim as tcli
from tests.jax_pins import MESH_CLI, pinned
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_mesh_cli import two_shard_mesh
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ARGV = MESH_CLI["ckpt12"] + ["--checkpoint-every", "4"]
KEYS = ("state_digest", "stats_digest", "rounds_run", "total_msgs", "final_coverage")


def torn(d):
    """``d`` with its newest checkpoint removed (the crash)."""
    newest = list_checkpoint_steps(d)[0][1]
    shutil.rmtree(newest)
    return d


def port(capsys, argv) -> dict:
    capsys.readouterr()
    rc = tcli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1])


def test_mesh_checkpoints_resume_across_packages(capsys, monkeypatch, tmp_path):
    two_shard_mesh(monkeypatch)
    want = {k: pinned("mesh_cli", "ckpt12")[k] for k in KEYS}
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    got = port(capsys, ARGV + ["--checkpoint-dir", str(tdir)])
    assert {k: got[k] for k in KEYS} == want and got["ici_bytes_per_round"] == pinned("mesh_cli", "ckpt12")[
        "ici_bytes_per_round"]
    torn(tdir)
    local_dir = tmp_path / "port_local"
    shutil.copytree(tdir, local_dir)
    jax_side = jax_in_child("tests.jax_pins", "cli_mesh_runs", 2, [
        ARGV + ["--checkpoint-dir", str(jdir)], ["resume", str(tdir)], ["resume", str(local_dir), "--local"]])
    wrote, resumed, local = jax_side
    assert {k: wrote[k] for k in KEYS} == want
    assert {k: resumed[k] for k in KEYS} == want and resumed["devices"] == 2
    assert {k: local[k] for k in KEYS} == want
    torn(jdir)
    jlocal = tmp_path / "jax_local"
    shutil.copytree(jdir, jlocal)
    got = port(capsys, ["resume", str(jdir)])
    assert {k: got[k] for k in KEYS} == want and got["transport"] == "sparse"
    for d in (jlocal, tmp_path / "port_local2"):
        if not d.exists():
            shutil.copytree(local_dir, d)
        got = port(capsys, ["resume", str(d), "--local"])
        # the local restore ships no ICI bytes: no counters in its summary
        assert {k: v for k, v in got.items() if k != "wall_seconds"} == local
