"""The port's CLI on the sharded matching engine and the transports
(``--shard --graph matching``, ``--transport sparse|auto``, ``--builder
dist``, the remat fallback onto the bucketed route, the bucketed engine's
transports) on a 2-shard mesh, against the JAX CLI's summaries on a
2-device mesh pinned in ``tests/jax_pins.json`` (``test_torch_mesh_pins``
recomputes them), the transport block included and the timing fields
aside; and the refusals in JAX's words, ``--transport hier`` naming ROADMAP
item 11c."""

import json

import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.cli import run_sim as tcli
from tests.jax_pins import MESH_CLI, MESH_CLI_BASE, pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

TIMING = ("wall_seconds", "swarm_rounds_per_sec", "peers_rounds_per_sec", "ms_per_round",
          "epoch_rebuild_seconds_total", "ms_per_round_amortized")


@pytest.fixture
def two_shards(monkeypatch):
    """The port CLI's mesh pinned to two shards."""
    two_shard_mesh(monkeypatch)


def two_shard_mesh(monkeypatch) -> None:
    make = tdist.make_mesh
    monkeypatch.setattr(tdist, "make_mesh", lambda n_shards=None, device="cuda": make(2, device=device))


def port_summary(capsys, argv) -> dict:
    """The port CLI's summary without the timing fields, or a refused run's
    exit code and last stderr line (the pins' form)."""
    capsys.readouterr()
    rc = tcli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr()
    if rc != 0:
        return {"exit": rc, "stderr": out.err.strip().splitlines()[-1]}
    summary = json.loads(out.out.strip().splitlines()[-1])
    return {k: v for k, v in summary.items() if k not in TIMING}


def equals_jax_mesh_cli(capsys, monkeypatch, argv) -> dict:
    """The port CLI on ``argv`` equals the JAX CLI: a pinned ``mesh_cli``
    case on a 2-shard mesh, else (a run the JAX CLI refuses before it
    builds anything) the in-process JAX CLI's exit code and stderr."""
    names = [k for k, v in MESH_CLI.items() if v == list(argv)]
    if names:
        two_shard_mesh(monkeypatch)
        got = port_summary(capsys, list(argv))
        assert got == pinned("mesh_cli", names[0])
        return got
    capsys.readouterr()
    rc = jcli.main(list(argv))
    want = capsys.readouterr().err
    assert rc == 2
    assert tcli.main(list(argv) + ["--device", "cpu"]) == rc
    assert capsys.readouterr().err == want
    return {"exit": rc}


# the cases the converted refusal tests of the earlier slices' files run
CONVERTED = ("control_pipeline", "control", "stream_pipeline", "stream", "grow_target", "small_target",
             "small_chung_lu_sparse", "matching_target", "matching_control_pipeline")


@pytest.mark.parametrize("name", sorted(set(MESH_CLI) - set(CONVERTED)))
def test_sharded_cli_equals_jax_cli(capsys, two_shards, name):
    got = port_summary(capsys, MESH_CLI[name])
    want = pinned("mesh_cli", name)
    assert got == want
    assert got["devices"] == 2 and got["transport"] == ("dense" if "--transport" not in MESH_CLI[name]
                                                        else MESH_CLI[name][MESH_CLI[name].index("--transport") + 1])


def test_transports_share_the_trajectory(capsys, two_shards):
    """dense, sparse, auto-packed and the dist builder's run print one
    trajectory (the transport never draws; the dist builder differs only
    by its block-keyed layout)."""
    runs = {n: pinned("mesh_cli", n) for n in ("dense", "sparse", "auto_packed")}
    keys = ("state_digest", "stats_digest", "total_msgs", "final_coverage")
    assert len({tuple(r[k] for k in keys) for r in runs.values()}) == 1
    assert runs["sparse"]["ici_bytes_per_round"]["shipped"] < runs["sparse"]["ici_bytes_per_round"]["dense"]


HIER = [*MESH_CLI_BASE, "--graph", "matching", "--shard", "--rounds", "8", "--transport", "hier"]


def test_hier_transport_names_item_11c(capsys):
    """``--transport hier`` (ROADMAP item 11c, ported since) without
    ``--hosts`` exits 2 with the JAX CLI's words: it needs a host axis."""
    capsys.readouterr()
    assert jcli.main(HIER) == 2
    want = capsys.readouterr().err
    assert tcli.main(HIER + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err == want and "--transport hier" in err and "add --hosts H > 1" in err


@pytest.mark.parametrize("argv", [
    ["--graph", "pa", "--rounds", "8", "--transport", "sparse"],
    ["--graph", "matching", "--rounds", "8", "--transport", "auto"],
    ["--graph", "matching", "--rounds", "8", "--builder", "dist"],
    ["--graph", "pa", "--shard", "--rounds", "8", "--builder", "dist"],
    ["--graph", "matching", "--shard", "--rounds", "8", "--builder", "dist", "--churn-join", "0.1",
     "--rewire-slots", "2", "--remat-every", "4"],
], ids=["transport-local", "transport-matching-local", "builder-local", "builder-bucketed", "builder-remat"])
def test_transport_and_builder_refusals_in_jax_words(capsys, argv):
    full = MESH_CLI_BASE + argv
    capsys.readouterr()
    assert jcli.main(full) == 2
    want = capsys.readouterr().err
    assert tcli.main(full + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == want
