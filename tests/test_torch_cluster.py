"""The (hosts, devices) fold and the two-level transport (``cluster/``) in
one process: the cells of ``tests/sim/test_cluster.py`` on the port, at
JAX's sizes (a 250-peer PA graph on the bucketed engine, the 256-peer
matching layout, 8 shards), against the JAX package's results pinned in
``tests/jax_pins.json`` (group ``cluster``, ``python -m tests.jax_pins
write cluster`` on 8 forced host devices): a fold and a hier round equal
the flat round in state and every integer stat, the ICI/DCN counters
equal JAX's, and the hier transport ships fewer DCN words than the dense
exchange it replaces. The CLI's cluster refusals equal the JAX CLI's."""

import numpy as np
import pytest

from tests import jax_pins
from tests.jax_pins import N_BUCKETED, N_MATCHING, pinned
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch import dist
from tpu_gossip_torch.cli import run_sim as tcli
from tpu_gossip_torch.cluster import make_cluster_mesh, mesh_hosts
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
from tpu_gossip_torch.utils.digest import state_digest, stats_digest

DEV = "cpu"


def _digests(fin, stats) -> dict:
    return {"state_digest": state_digest(fin), "stats_digest": stats_digest(stats)}


def _ici(ici) -> dict:
    return {f: int(getattr(ici, f).sum()) for f in ici._fields}


@pytest.fixture(scope="module")
def bucketed():
    from tpu_gossip_torch.core.topology import build_csr

    g = build_csr(N_BUCKETED, jax_pins.cluster_bucketed_graph())
    sg, rel, pos = dist.partition_graph(g, 8, seed=1, device=DEV)
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=8, fanout=2, mode="push_pull", churn_leave_prob=0.02,
                      churn_join_prob=0.2)
    return sg, cfg, dist.init_sharded_swarm(sg, rel, pos, cfg, key=prng.key(0, DEV), origins=[0], device=DEV)


def bucketed_run(bucketed, hosts: int, transport: str = "dense") -> dict:
    sg, cfg, st = bucketed
    mesh = make_cluster_mesh(8, hosts, DEV)
    assert mesh_hosts(mesh) == (hosts, 8 // hosts)
    tp = None if transport == "dense" else dist.build_transport(sg, mode=transport, hosts=hosts)
    fin, (stats, ici) = dist.simulate_dist(dist.shard_swarm(st, mesh), cfg, sg, mesh, 6, transport=tp,
                                           collect_ici=True)
    return {**_digests(fin, stats), "ici": _ici(ici)}


@pytest.mark.parametrize("hosts", [2, 4])
def test_bucketed_2d_fold_bit_identical_to_flat(bucketed, hosts):
    """The (H, D) fold holds the same shards in the same order: its run is
    the flat run, state (key included) and every stat, and both are JAX's."""
    flat = bucketed_run(bucketed, 1)
    want = pinned("cluster", "bucketed_flat")
    assert flat == want
    fold = bucketed_run(bucketed, hosts)
    digests = {k: fold[k] for k in ("state_digest", "stats_digest")}
    assert digests == {k: want[k] for k in digests}
    # on two host rows JAX prices the flat exchange whole on the host axis
    assert (fold["ici"]["dcn_dense_words"], fold["ici"]["dcn_shipped_words"]) == (
        want["ici"]["dense_words"], want["ici"]["shipped_words"])


def test_bucketed_hier_bit_identical_and_saves_dcn(bucketed):
    """The two-level transport on (2, 4) delivers the flat bits, its
    counters are JAX's, and its compacted host stage ships fewer DCN words
    than the dense cross-host exchange."""
    got = bucketed_run(bucketed, 2, "hier")
    assert got == pinned("cluster", "bucketed_hier")
    flat = pinned("cluster", "bucketed_flat")
    assert {k: got[k] for k in ("state_digest", "stats_digest")} == {k: flat[k] for k in ("state_digest",
                                                                                          "stats_digest")}
    ici = got["ici"]
    assert 0 < ici["dcn_shipped_words"] < ici["dcn_dense_words"]
    assert ici["dcn_shipped_words"] <= ici["shipped_words"]


@pytest.fixture(scope="module")
def matching():
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded

    dg, plan = matching_powerlaw_graph_sharded(N_MATCHING, 8, gamma=2.5, fanout=1, key=prng.key(0, DEV),
                                               export_csr=False, device=DEV)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull")
    st = init_swarm(dg.as_padded_graph(), cfg, origins=[0], exists=dg.exists, key=prng.key(0, DEV), device=DEV)
    return plan, cfg, st


def matching_hier_run(matching, rounds: int, packed: bool = False, **planes) -> dict:
    plan, cfg, st = matching
    mesh = make_cluster_mesh(8, 2, DEV)
    tp = dist.build_transport(plan, mode="hier", hosts=2)
    sharded = dist.shard_swarm(st, mesh)
    fin, (stats, ici) = dist.simulate_dist(pack_state(sharded) if packed else sharded, cfg,
                                           dist.shard_matching_plan(plan, mesh), mesh, rounds, transport=tp,
                                           collect_ici=True, **planes)
    return {**_digests(unpack_state(fin) if packed else fin, stats), "ici": _ici(ici)}


def test_matching_2d_hier_bit_identical_to_local(matching):
    """The (2, 4) fold under the hier transport equals the local engine,
    state and stats, and both equal JAX's; the counters are JAX's and the
    host stage saves DCN words."""
    from tpu_gossip_torch.sim.engine import simulate

    plan, cfg, st = matching
    local = _digests(*simulate(st, cfg, 5, plan))
    assert local == pinned("cluster", "matching_local")
    got = matching_hier_run(matching, 5)
    assert got == pinned("cluster", "matching_hier")
    assert {k: got[k] for k in local} == local
    assert got["ici"]["dcn_shipped_words"] < got["ici"]["dcn_dense_words"]


def composed_planes(plan, st):
    """The audit's chaos scenario, stream and control plan (JAX's
    ``analysis/entrypoints.py``), compiled by the port."""
    from tpu_gossip_torch.control import compile_control
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict
    from tpu_gossip_torch.traffic import compile_stream

    spec = scenario_from_dict({"name": "audit-chaos", "phases": [
        {"name": "lossy", "start": 0, "end": 2, "loss": 0.2, "delay": 0.2},
        {"name": "split", "start": 2, "end": 4, "partition": "half"},
        {"name": "storm", "start": 4, "end": 6, "churn_leave": 0.05, "churn_join": 0.2,
         "blackout": {"frac": 0.1, "seed": 1}}]})
    return dict(
        scenario=compile_scenario(spec, n_peers=N_MATCHING, n_slots=plan.n, total_rounds=8, device=DEV),
        stream=compile_stream(rate=2.0, msg_slots=16, ttl=8, origin_rows=np.flatnonzero(st.exists.numpy()),
                              k_hashes=2, burst_every=4, device=DEV),
        control=compile_control(target_ratio=0.9, fanout=1, lo=1, hi=3, refresh_every=2, ttl=8, device=DEV))


def test_matching_2d_composed_scenario_stream_control(matching):
    """A composed scenario x stream x control cell on the (2, 4) fold under
    the hier transport: the planes draw at global shape, so the fold moves
    no draw and equals JAX's local run."""
    from tpu_gossip_torch.sim.engine import simulate

    plan, cfg, st = matching
    want = pinned("cluster", "composed_local")
    assert _digests(*simulate(st, cfg, 6, plan, **composed_planes(plan, st))) == want
    got = matching_hier_run(matching, 6, **composed_planes(plan, st))
    assert {k: got[k] for k in want} == want


def test_matching_2d_hier_packed_bit_identical(matching):
    """The packed carry rides the fold and the hier transport: packed equals
    unpacked and JAX's packed run, state, stats and counters."""
    want = pinned("cluster", "matching_packed_hier")
    assert matching_hier_run(matching, 6, packed=True) == want
    assert matching_hier_run(matching, 6) == want


@pytest.mark.parametrize("argv", [
    ["--shard", "--hosts", "3"],
    ["--hosts", "2"],
    ["--transport", "hier"],
    ["--shard", "--hosts", "2", "--remat-every", "3"],
], ids=["indivisible", "hosts_without_shard", "hier_without_mesh", "hosts_with_remat"])
def test_cli_cluster_rejections(capsys, monkeypatch, argv):
    """Impossible cluster configs exit 2 with the JAX CLI's error (the mesh
    has 8 shards, as JAX's 8 forced host devices)."""
    make = dist.make_mesh
    monkeypatch.setattr(dist, "make_mesh", lambda n_shards=None, device="cuda": make(8, device=device))
    full = ["--peers", "64", "--slots", "4", "--quiet", *argv]
    capsys.readouterr()
    assert jcli.main(full) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tcli.main(full + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err.strip().splitlines()[-1] == want


def test_fold_cli_equals_jax_cli_fold(capsys, monkeypatch):
    """``run_sim --shard --hosts 2 --transport hier`` in one process on an
    8-shard mesh prints the JAX CLI's summary on its 8-device fold, the
    per-axis bytes included."""
    import json

    make = dist.make_mesh
    monkeypatch.setattr(dist, "make_mesh", lambda n_shards=None, device="cuda": make(8, device=device))
    _, argv = jax_pins.CLUSTER_CLI["acceptance_hier"]
    capsys.readouterr()
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got.pop("wall_seconds", None)
    assert got == pinned("cluster", "cli_acceptance_hier")
    assert got["dcn_bytes"]["shipped"] < got["dcn_bytes"]["dense"]


def test_cluster_pins_are_current():
    """One batch of the group, recomputed by the JAX package in a child
    process on its forced host devices, equals the file."""
    names = ["bucketed_hier"]
    assert jax_in_child("tests.jax_pins", "compute", "cluster", names) == {
        name: pinned("cluster", name) for name in names}
