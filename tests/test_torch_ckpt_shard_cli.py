"""Checkpoints and resume through the port's CLI against the JAX CLI's on
the one-process bucketed engine (``--shard [--staircase] [--packed]`` and
its remat loop, both CLIs' meshes pinned to one shard), the JAX-pinned
n=20000 matching run checkpointed at round 8 and resumed in each
direction, and a port process SIGKILLed mid-horizon and resumed."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_gossip import dist as jdist
from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.ckpt import list_checkpoint_steps
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_ckpt_cli import BASE, CHURN, _run, crosses_packages
from tests.test_torch_cli import REF
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

PATHS = {
    "shard": ["--graph", "chung-lu", "--shard", "--rounds", "12"],
    "shard_staircase": ["--graph", "chung-lu", "--shard", "--staircase", "--rounds", "12"],
    "shard_packed": ["--graph", "chung-lu", "--shard", "--packed", "--rounds", "12"],
    "shard_staircase_packed": ["--graph", "chung-lu", "--shard", "--staircase", "--packed", "--rounds", "12"],
    "shard_remat": ["--graph", "chung-lu", "--shard", "--staircase", *CHURN, "--remat-every", "4", "--rounds", "14"],
}


@pytest.fixture
def one_shard(monkeypatch):
    """Both CLIs' meshes pinned to one shard."""
    j_make, t_make = jdist.make_mesh, tdist.make_mesh
    monkeypatch.setattr(jdist, "make_mesh", lambda *a, **k: j_make(1))
    monkeypatch.setattr(tdist, "make_mesh", lambda device="cuda": t_make(1, device=device))


@pytest.mark.parametrize("name", list(PATHS))
def test_checkpointed_shard_path_crosses_packages(capsys, tmp_path, one_shard, name):
    want = crosses_packages(capsys, tmp_path, BASE + PATHS[name] + ["--checkpoint-every", "4"])
    assert want["devices"] == 1


def test_resume_on_another_mesh_size_exits_2(capsys, tmp_path, one_shard):
    d = tmp_path / "ck"
    argv = BASE + PATHS["shard"] + ["--checkpoint-every", "4", "--checkpoint-dir", str(d), "--device", "cpu"]
    assert tcli.main(argv) == 0
    for _step, path in list_checkpoint_steps(d):
        m = json.loads((path / "MANIFEST.json").read_text())
        m["run"]["devices"] = 8
        (path / "MANIFEST.json").write_text(json.dumps(m))
    capsys.readouterr()
    assert tcli.main(["resume", str(d), "--device", "cpu"]) == 2
    assert "8-device mesh" in capsys.readouterr().err


@pytest.fixture(scope="module")
def pin():
    """reference_digests.json's n=20000 matching pin (20 rounds)."""
    return json.loads(REF.read_text())[0]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_the_n20000_pin_resumes_from_round_8_in_the_other_package(capsys, tmp_path, pin, writer):
    """The pin's run checkpointed at round 8 by one package (round 16 torn
    away) and finished by the other prints the pinned digests."""
    d = tmp_path / "ck"
    argv = pin["argv"] + ["--checkpoint-every", "8", "--checkpoint-dir", str(d)]
    if writer == "jax":
        rc, _, err = _run(capsys, jcli.main, argv)
        assert rc == 0, err
    else:
        rc, full, err = _run(capsys, tcli.main, argv + ["--device", "cpu"])
        assert rc == 0, err
        assert {k: full[k] for k in pin["summary"]} == pin["summary"]
    shutil.rmtree(d / "ckpt-00000016")
    if writer == "jax":
        rc, got, err = _run(capsys, tcli.main, ["resume", str(d), "--device", "cpu"])
    else:
        rc, got, err = _run(capsys, jcli.main, ["resume", str(d)])
    assert rc == 0, err
    assert "resume: ckpt-00000008 at round 8 of 20" in err
    assert {k: got[k] for k in pin["summary"]} == pin["summary"]


def test_sigkill_mid_horizon_then_resume(tmp_path):
    """A checkpointing port process SIGKILLed mid-horizon, resumed in a
    fresh process, ends on the uninterrupted run's digests."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    d = tmp_path / "ck"
    base = [sys.executable, "-m", "tpu_gossip_torch.cli.run_sim", "--peers", "3000", "--graph", "chung-lu",
            "--rounds", "120", "--slots", "4", "--fanout", "2", "--quiet", "--digest", "--device", "cpu"]
    ref = subprocess.run(base, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert ref.returncode == 0, ref.stderr
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    proc = subprocess.Popen(base + ["--checkpoint-every", "10", "--checkpoint-dir", str(d)], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 240
    while time.time() < deadline and proc.poll() is None and not list(d.glob("ckpt-*/MANIFEST.json")):
        time.sleep(0.01)
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL, "the run ended before the kill"
    assert list(d.glob("ckpt-*/MANIFEST.json")), "no checkpoint landed before the kill"
    res = subprocess.run([sys.executable, "-m", "tpu_gossip_torch.cli.run_sim", "resume", str(d), "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert (got["state_digest"], got["stats_digest"]) == (want["state_digest"], want["stats_digest"])
