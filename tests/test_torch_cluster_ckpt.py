"""Two gloo ranks on this CPU, continued: the bucketed mesh a shard a rank
(K6's plan, its plain version here, and the scatter receive under the
sparse transport), and checkpoints across process counts. Rank 0 writes
the same format-3 directory a one-process run writes, from every rank's
rows: a two-rank checkpoint resumes in one process at ``--hosts 1`` and
``4``, and a one-process checkpoint resumes as two ranks, each onto the
uninterrupted run's digests (the JAX CLI's, pinned in
``tests/jax_pins.json``, group ``cluster``)."""

import json

import pytest

from tests.jax_pins import CLUSTER_CLI, pinned
from tests.test_torch_cluster_procs import TIMING, launch, rank0_summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch import dist
from tpu_gossip_torch.cli import run_sim as tcli

DIGESTS = ("state_digest", "stats_digest")


def _want(name: str) -> dict:
    want = dict(pinned("cluster", f"cli_{name}"))
    for k in TIMING:
        want.pop(k, None)
    return want


@pytest.mark.parametrize("name", ["bucketed_k6", "bucketed_scatter"])
def test_bucketed_mesh_a_shard_a_rank_equals_the_jax_fold(name):
    """The bucketed mesh at S = 2, one shard a rank: rank 0 prints the JAX
    CLI's summary on the (2, 1) fold, through K6's plan and through the
    scatter receive with the compact lane."""
    shards, argv = CLUSTER_CLI[name]
    assert rank0_summary(argv, shards // 2) == _want(name)


@pytest.fixture
def eight_shards(monkeypatch):
    make = dist.make_mesh
    monkeypatch.setattr(dist, "make_mesh", lambda n_shards=None, device="cuda": make(8, device=device))


def _resume_in_one_process(capsys, directory, hosts: int) -> dict:
    capsys.readouterr()
    assert tcli.main(["resume", str(directory), "--hosts", str(hosts), "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_two_rank_checkpoint_resumes_in_one_process(capsys, eight_shards, tmp_path):
    """A two-rank run checkpointing every 6 rounds ends on the pin; its
    round-6 checkpoint resumes in one process on the flat mesh (the hier
    transport becomes sparse, as JAX's resume makes it) and on the (4, 2)
    fold, each onto the same digests."""
    _, argv = CLUSTER_CLI["ckpt_hier"]
    d = tmp_path / "ck"
    want = {k: _want("ckpt_hier")[k] for k in DIGESTS}
    got = rank0_summary(argv + ["--checkpoint-every", "6", "--checkpoint-dir", str(d)], 4)
    assert {k: got[k] for k in DIGESTS} == want
    steps = sorted(p.name for p in d.iterdir())
    assert steps == ["ckpt-00000006"], steps
    for hosts in (1, 4):
        got = _resume_in_one_process(capsys, d, hosts)
        assert {k: got[k] for k in DIGESTS} == want, hosts


def test_one_process_checkpoint_resumes_as_two_ranks(capsys, eight_shards, tmp_path):
    """The reverse: the one-process fold's checkpoint resumes as two ranks
    (the launcher's flags after ``resume D``) onto the same digests."""
    _, argv = CLUSTER_CLI["ckpt_hier"]
    d = tmp_path / "ck"
    capsys.readouterr()
    assert tcli.main(argv + ["--checkpoint-every", "6", "--checkpoint-dir", str(d), "--device", "cpu"]) == 0
    want = {k: _want("ckpt_hier")[k] for k in DIGESTS}
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: got[k] for k in DIGESTS} == want
    rc, lines = launch(["resume", str(d)], 4)
    assert rc == 0, "\n".join(lines[-30:])
    assert {k: json.loads(lines[-1])[k] for k in DIGESTS} == want
