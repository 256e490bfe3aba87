"""The port's ``--shard`` CLI against the JAX CLI's at an equal shard
count: the JAX side's mesh is pinned by patching ``tpu_gossip.dist.make_mesh``
(its ``--shard`` path reads it at call time), the port's to match."""

import json

import pytest

from tpu_gossip import dist as jdist
from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.cli import run_sim as tcli
from tests.jax_pins import pinned
from tests.test_torch_cli import REF, _check_reference, _summary, control_pin, fault_pin, growth_pin, stream_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


@pytest.fixture
def shards(monkeypatch):
    """Pin both CLIs' meshes to ``s`` shards."""
    j_make, t_make = jdist.make_mesh, tdist.make_mesh

    def pin(s):
        monkeypatch.setattr(jdist, "make_mesh", lambda *a, **k: j_make(s))
        monkeypatch.setattr(tdist, "make_mesh", lambda device="cuda": t_make(s, device=device))

    return pin


RUNS = [  # (shards, extra argv)
    (1, ["--mode", "push_pull", "--fanout", "1"]),
    (1, ["--mode", "push_pull", "--fanout", "1", "--staircase"]),
    (1, ["--mode", "push_pull", "--fanout", "1", "--staircase", "--packed"]),
    (8, ["--mode", "push_pull", "--fanout", "1", "--staircase"]),
    (8, ["--mode", "flood", "--staircase", "--slots", "40"]),
]


@pytest.mark.parametrize("s,extra", RUNS, ids=lambda v: v if isinstance(v, int) else "_".join(a.strip("-") for a in v))
def test_cli_shard_digest_summary_equals_jax(capsys, shards, s, extra):
    shards(s)
    argv = ["--peers", "2000", "--graph", "chung-lu", "--shard", "--rounds", "20", "--digest", "--seed", "3", *extra]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want
    assert got["devices"] == s and got["transport"] == "dense" and got["total_msgs"] > 0
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]


def test_cli_shard_packed_equals_unpacked_and_k6_equals_scatter(capsys, shards):
    shards(1)
    argv = ["--peers", "2000", "--graph", "pa", "--m", "2", "--mode", "push", "--fanout", "2", "--shard",
            "--rounds", "12", "--digest", "--quiet", "--device", "cpu"]
    scatter, _ = _summary(capsys, tcli.main, argv)
    k6, _ = _summary(capsys, tcli.main, argv + ["--staircase"])
    packed, _ = _summary(capsys, tcli.main, argv + ["--staircase", "--packed"])
    assert k6 == scatter
    assert dict(k6, packed=True) == packed


def test_cli_shard_run_to_target_equals_jax(capsys, shards):
    shards(1)
    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "chung-lu", "--shard",
            "--staircase"]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in ("summary", "mode", "n_peers", "rounds", "target", "coverage", "packed", "devices", "transport"):
        assert got[k] == want[k], k
    assert set(got) == set(want)


@pytest.mark.parametrize("argv,says", [
    (["--graph", "matching", "--shard"], "not ported yet"),
    (["--graph", "chung-lu", "--shard", "--transport", "sparse"], "not ported yet"),
    (["--graph", "chung-lu", "--shard", "--hosts", "2"], "not ported yet"),
    (["--graph", "chung-lu", "--shard", "--tail", "pallas"], "fused tail"),
    (["--graph", "chung-lu", "--transport", "sparse"], "not ported yet"),
])
def test_cli_shard_refusals_exit_2(capsys, monkeypatch, argv, says):
    """A non-fused tail exits 2; the sharded matching engine and the
    transports (11b, ported since) equal the JAX CLI on a 2-device mesh,
    ``--transport`` without ``--shard`` exiting 2 in JAX's words; ``--hosts
    2`` (11c, ported since) folds the 2-shard mesh into (2, 1) and prints
    the JAX CLI's summary on its (2, 1) fold (pinned in
    ``tests/jax_pins.json``, group ``cluster``)."""
    full = ["--peers", "100", "--rounds", "2", *argv]
    if "--hosts" in argv:
        from tests.test_torch_mesh_cli import port_summary, two_shard_mesh

        two_shard_mesh(monkeypatch)
        assert port_summary(capsys, full) == pinned("cluster", "cli_fold_chung_lu")
        return
    if "--tail" in argv:
        assert tcli.main(full + ["--device", "cpu"]) == 2
        assert says in capsys.readouterr().err
        return
    from tests.test_torch_mesh_cli import equals_jax_mesh_cli

    got = equals_jax_mesh_cli(capsys, monkeypatch, full)
    assert ("devices" in got) == ("--shard" in argv) and says == "not ported yet"


@pytest.mark.parametrize("packed", [False, True])
def test_shard_reference_digests_are_what_jax_produces(capsys, shards, packed):
    """The pinned n=20000 ``--shard --staircase`` entries are the JAX CLI's
    on a one-device mesh, and the port's CLI prints them on the CPU."""
    shards(1)
    (ref,) = [r for r in json.loads(REF.read_text())
              if "--shard" in r["argv"] and ("--packed" in r["argv"]) == packed and "--churn-join" not in r["argv"]
              and not fault_pin(r) and not growth_pin(r) and not stream_pin(r) and not control_pin(r)]
    assert ref["source"].startswith("python -m tpu_gossip.cli.run_sim") and "one-device mesh" in ref["source"]
    _check_reference(capsys, ref)


def test_cli_shard_on_several_cards_exits_2(capsys, monkeypatch):
    """``--shard`` takes the mesh ``dist.make_mesh`` gives (one shard a
    process; several cards run a process a card through ``cluster.launch``,
    ROADMAP item 11c); a mesh a later slice brings, refused where it is
    built, exits 2 naming it."""
    def several_cards(device="cuda"):
        raise tdist.mesh.not_ported("a mesh over several cards in one process", "several processes (ROADMAP item 11d)")

    monkeypatch.setattr(tdist, "make_mesh", several_cards)
    assert tcli.main(["--peers", "300", "--graph", "chung-lu", "--shard", "--rounds", "2", "--device", "cpu"]) == 2
    assert "not ported yet" in capsys.readouterr().err
