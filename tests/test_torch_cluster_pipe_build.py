"""Pipelined rounds and the distributed builder on two gloo ranks on this
CPU (ROADMAP item 11d parts 4 and 5), against the JAX CLI's one-process run
on the same (2, 2) fold pinned in ``tests/jax_pins.json`` (group
``cluster``, ``CLUSTER_PLANES``): the pipelined matching mesh dense and on
the hier transport under churn, the lossy links and the quorum detector,
the pipelined bucketed mesh under churn, and ``--builder dist`` dense,
sparse and pipelined, pipelined under the controller, and growing under
the flash crowd; the packed runs land on their unpacked pins.

With ``--builder dist`` each rank builds only the shards it holds: in a
spawned two-rank group the held build equals the held rows of the whole
block-keyed build leaf for leaf, its CSR the whole CSR, a rank draws only
its shards' stage keys and makes no slot table of more than its own rows,
and the transport from the held plan equals the whole plan's. A two-rank
``--builder dist`` checkpoint resumes in one process, on the local engine
and on the mesh, onto the uninterrupted run's pin."""

import json
import queue

import pytest
import torch

from tests.jax_pins import CLUSTER_PLANES, CLUSTER_PIPE_BUILD, pinned
from tests.test_torch_cluster_planes import equals_the_fold_pin
from tests.test_torch_cluster_procs import free_port, rank0_summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch import dist
from tpu_gossip_torch.cli import run_sim as tcli
from tpu_gossip_torch.core import prng

DIGESTS = ("state_digest", "stats_digest")
N, S = 2000, 4


@pytest.mark.parametrize("name,packed", [(name, False) for name in CLUSTER_PIPE_BUILD]
                         + [("pipe_dense", True), ("dist_sparse_pipe", True)])
def test_pipelines_and_the_dist_builder_on_two_ranks_equal_the_jax_fold(name, packed):
    """Each witness as two ranks of two shards: rank 0's summary is the JAX
    fold's, digests, integer columns, plane blocks and ICI/DCN totals, the
    floats within their tolerances."""
    equals_the_fold_pin(name, packed)


class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The shape and dtype of every tensor an op makes while installed."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append((tuple(t.shape), str(t.dtype)))
        return out


def _plan_leaves(plan) -> dict:
    """A plan's tensors and layout facts, as lists."""
    out = {f: [t.tolist() for t in getattr(plan, f)] for f in ("lanes", "lanes_inv")}
    out.update({f: getattr(plan, f).tolist() for f in ("m3", "valid", "deg_other", "deg_real")})
    out.update({f: getattr(plan, f) for f in ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk",
                                               "per_rows", "local_classes", "shard_lo")})
    out["slot_node"] = plan.layout.slot_node.tolist()
    return out


def _transport_leaves(tr) -> dict:
    return {"leaf_slots": tr.leaf_slots.tolist(), "hub_tables": [t.tolist() for t in tr.hub_tables],
            **{f: getattr(tr, f) for f in ("mode", "active", "budget", "stage_mode", "hub_degree_min", "n_shards",
                                           "fingerprint", "shard_lo")}}


def _build_worker(rank: int, port: int, out):
    """One rank of :func:`two_rank_build` (spawned): its held build under a
    recorder of the stage keys it folds in and of every tensor it makes,
    and its transport."""
    from tpu_gossip_torch.cluster import topology as topo
    from tpu_gossip_torch.cluster.launch import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, rank, "gloo", "cpu")
    mesh = topo.make_cluster_mesh(S, 2, "cpu")
    folds, fold_in = [], prng.fold_in

    def recording_fold_in(k, data):
        folds.append(int(data))
        return fold_in(k, data)

    prng.fold_in = recording_fold_in
    try:
        with _Recorder() as rec:
            g, plan = dist.matching_powerlaw_graph_dist(N, mesh, fanout=1, key=prng.key(4, "cpu"))
    finally:
        prng.fold_in = fold_in
    tr = dist.build_transport(plan, "sparse", mesh=mesh)
    out.put({"rank": rank, "plan": _plan_leaves(plan), "row_ptr": g.row_ptr.tolist(), "col_idx": g.col_idx.tolist(),
             "exists": g.exists.tolist(), "folds": folds, "shapes": rec.shapes, "transport": _transport_leaves(tr)})
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank_build():
    """Both ranks' builds (:func:`_build_worker`), and the whole block-keyed
    build with its transport in this process."""
    import torch.multiprocessing as mp

    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded

    ctx = mp.get_context("spawn")
    out, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_build_worker, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    while len(got) < 2:
        try:
            r = out.get(timeout=5)
            got[r["rank"]] = r
        except queue.Empty:
            assert all(p.exitcode in (None, 0) for p in procs), [p.exitcode for p in procs]
    for p in procs:
        p.join(60)
    g, plan = matching_powerlaw_graph_sharded(N, S, fanout=1, key=prng.key(4, "cpu"), block_keys=True, device="cpu")
    return got, g, plan, dist.build_transport(plan, "sparse")


def test_held_build_is_the_whole_builds_held_rows(two_rank_build):
    """Each rank's held plan equals ``shard_matching_plan`` of the whole
    block-keyed build on that rank's mesh, leaf for leaf; its CSR, joined
    from both ranks' segments, is the whole CSR, and its ``exists`` the
    held rows'."""
    got, g, plan, _ = two_rank_build
    for rank, res in got.items():
        mesh = dist.Mesh(n_shards=S, device=torch.device("cpu"), hosts=2, rank=rank, world=2)
        assert res["plan"] == _plan_leaves(dist.shard_matching_plan(plan, mesh)), rank
        assert (res["row_ptr"], res["col_idx"]) == (g.row_ptr.tolist(), g.col_idx.tolist())
        lo = rank * plan.n // 2
        assert res["exists"] == g.exists[lo: lo + plan.n // 2].tolist()


def test_a_rank_draws_and_holds_only_its_shards(two_rank_build):
    """A rank folds only its own shards' indices into the stage keys, every
    stage once, and no tensor it makes is a slot table of more than its own
    rows; the one array of the whole slot space is the CSR's column index,
    from the gather (whose byte buffers carry the ranks' segments)."""
    got, _, plan, _ = two_rank_build
    held = S // 2
    for rank, res in got.items():
        mine = list(range(rank * held, (rank + 1) * held))
        stages = len(plan.lanes) + 1
        assert sorted(res["folds"]) == sorted(mine * stages)
        tables = [s for s, _ in res["shapes"] if len(s) == 2 and s[1] == 128]
        assert tables and max(s[0] for s in tables) == held * plan.per_rows
        whole = plan.rows * 128
        big = [(s, dt) for s, dt in res["shapes"] if torch.Size(s).numel() >= whole and dt != "torch.uint8"]
        assert big == [((whole,), "torch.int32")], big


def test_transport_from_the_held_plan_is_the_whole_plans(two_rank_build):
    """The sparse transport each rank builds from its held plan equals the
    one built from the whole plan: its leaf rows, every hub table, the
    budget, the auto gate and the stage modes."""
    got, _, plan, whole = two_rank_build
    w = _transport_leaves(whole)
    rows = plan.rows // 2
    for rank, res in got.items():
        t = res["transport"]
        assert t["leaf_slots"] == w["leaf_slots"][rank * rows: (rank + 1) * rows]
        assert t["shard_lo"] == rank * S // 2
        assert {k: v for k, v in t.items() if k not in ("leaf_slots", "shard_lo")} == \
            {k: v for k, v in w.items() if k not in ("leaf_slots", "shard_lo")}


@pytest.fixture
def four_shards(monkeypatch):
    make = dist.make_mesh
    monkeypatch.setattr(dist, "make_mesh", lambda n_shards=None, device="cuda": make(S, device=device))


def test_dist_checkpoint_resumes_in_one_process(capsys, four_shards, tmp_path):
    """A two-rank ``--builder dist`` run checkpointing every 4 rounds ends on
    its pin; its round-8 checkpoint resumes in one process on the local
    engine (``--local``) and on the one-process mesh, each onto the same
    digests."""
    _, argv = CLUSTER_PLANES["dist_dense"]
    want = {k: pinned("cluster", "planes_dist_dense")[k] for k in DIGESTS}
    d = tmp_path / "ck"
    got = rank0_summary(argv + ["--checkpoint-every", "4", "--checkpoint-dir", str(d)], S // 2)
    assert {k: got[k] for k in DIGESTS} == want
    for extra in (["--local"], ["--hosts", "1"]):
        capsys.readouterr()
        assert tcli.main(["resume", str(d), *extra, "--device", "cpu"]) == 0
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert {k: res[k] for k in DIGESTS} == want, extra


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_state_plane_pricing_equals_jax(packed, lanes):
    """``state_plane_bytes`` and ``state_bytes_per_peer`` equal the JAX
    package's on a grid of swarm sizes, slot counts, re-wiring widths and
    edge counts (host arithmetic over ``PLANES``, no array built)."""
    from tpu_gossip.core import state as jstate
    from tpu_gossip_torch.core import state as tstate

    for n in (1, 2000, 500_004, 100_000_000):
        for m in (1, 8, 13, 16, 64):
            for rewire, d in ((0, None), (2, 5_570_560), (4, 0)):
                kw = dict(rewire_slots=rewire, d=d, lanes=lanes, packed=packed)
                assert tstate.state_plane_bytes(n, m, **kw) == jstate.state_plane_bytes(n, m, **kw), (n, m, kw)
                assert tstate.state_bytes_per_peer(n, m, **kw) == jstate.state_bytes_per_peer(n, m, **kw)
