"""Two gloo ranks on this CPU (``cluster/launch.py``): the multi-process
mesh rounds of ROADMAP item 11c, each rank holding only its rows.

Each run goes through the port's launcher (``python -m
tpu_gossip_torch.cluster.launch --nprocs 2``) and rank 0's summary equals
the JAX CLI's one-process run on the same (hosts, devices) fold (pinned in
``tests/jax_pins.json``, group ``cluster``), digests, rounds and the
ICI/DCN totals included: the sharded matching mesh on the dense, sparse,
auto and hier transports, packed and not, to a fixed horizon and to
coverage. A rank's planes and tables hold ``1 / H`` of the rows, the
draws of its rows are the block of the global draw, and every plane of
ROADMAP item 11d passes the config's checks under ``--coordinator``; the
refusals of what cannot run keep the JAX CLI's words, serving ignores the
cluster flags as the JAX CLI's serve does, and fleets refuse them in
argparse's words. The bucketed mesh and the checkpoints across process
counts are ``test_torch_cluster_ckpt.py``'s; the row planes (item 11d part
1) are ``test_torch_cluster_planes*.py``'s."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.jax_pins import CLUSTER_CLI, pinned
from tests.test_torch_fleet_cli import campaign  # noqa: F401
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.cli import run_sim as tcli
from tpu_gossip_torch.core import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = ("wall_seconds", "ms_per_round", "peers_rounds_per_sec", "swarm_rounds_per_sec")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list[str], per: int, nprocs: int = 2) -> tuple[int, list[str]]:
    """The launcher on ``argv`` (``--device cpu`` appended): its exit code
    and rank 0's output lines, prefix stripped."""
    cmd = [sys.executable, "-m", "tpu_gossip_torch.cluster.launch", "--nprocs", str(nprocs), "--devices-per-host",
           str(per), "--port", str(free_port()), "--timeout", "240", "--", *argv, "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    return p.returncode, [ln[4:] for ln in p.stdout.splitlines() if ln.startswith("[0] ")]


def rank0_summary(argv: list[str], per: int) -> dict:
    rc, lines = launch(argv, per)
    assert rc == 0, "\n".join(lines[-30:])
    assert lines[0].startswith("cluster: rank 0 of 2, backend gloo, device cpu"), lines[0]
    got = json.loads(lines[-1])
    for k in TIMING:
        got.pop(k, None)
    return got


@pytest.mark.parametrize("name,packed", [("acceptance_hier", False), ("matching_dense", True),
                                         ("matching_hier", True), ("matching_target", False),
                                         ("matching_sparse", False), ("matching_auto", True)])
def test_two_ranks_equal_the_jax_fold(name, packed):
    """Rank 0 prints the JAX CLI's one-process summary on the same fold:
    digests (or rounds to the target), totals and the per-axis ICI/DCN
    bytes; the packed run's digests are the unpacked run's."""
    shards, argv = CLUSTER_CLI[name]
    got = rank0_summary(argv + (["--packed"] if packed else []), shards // 2)
    want = dict(pinned("cluster", f"cli_{name}"))
    for k in TIMING:
        want.pop(k, None)
    if packed:
        assert got.pop("packed") is True
        want.pop("packed")
    assert got == want


def _rank_worker(rank: int, port: int, out):
    """One rank of :func:`test_a_rank_holds_only_its_rows` (spawned)."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.cluster import make_cluster_mesh
    from tpu_gossip_torch.cluster.launch import init_distributed
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.core.topology import build_csr, preferential_attachment
    from tpu_gossip_torch.utils.digest import state_digest

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, rank, "gloo", "cpu")
    mesh = make_cluster_mesh(4, 2, "cpu")
    dg, plan = matching_powerlaw_graph_sharded(600, 4, fanout=1, key=prng.key(1, "cpu"), device="cpu")
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=1, mode="push_pull")
    st = init_swarm(dg.as_padded_graph(), cfg, origins=[0, 5], exists=dg.exists, key=prng.key(3, "cpu"), device="cpu")
    held, hst = dist.shard_matching_plan(plan, mesh), dist.shard_swarm(st, mesh)
    g = build_csr(400, preferential_attachment(400, m=3, rng=np.random.default_rng(0), use_native=False))
    sg, rel, pos = dist.partition_graph(g, 4, device="cpu")
    bcfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=8, fanout=2, mode="push_pull")
    bst = dist.init_sharded_swarm(sg, rel, pos, bcfg, key=prng.key(2, "cpu"), origins=[0], device="cpu")
    hsg, hplans = dist.shard_graph(sg, mesh), dist.shard_plans(dist.build_shard_plans(sg), mesh)
    fin, _ = dist.simulate_dist(hst, cfg, held, mesh, 4)
    bfin, _ = dist.simulate_dist(dist.shard_swarm(bst, mesh), bcfg, hsg, mesh, 4, hplans)
    out.put({"rank": rank, "state_rows": {f: int(getattr(hst, f).shape[0]) for f in ("seen", "alive", "exists")},
             "n": plan.n, "n_pad": sg.n_pad, "plan_rows": int(held.rows), "plan_n": int(held.n),
             "lane_rows": int(held.lanes[0].shape[0]), "valid_rows": int(held.valid.shape[0]),
             "deg_real": int(held.deg_real.shape[0]), "class_nodes": int(held.layout.n),
             "sg": [list(t.shape) for t in (hsg.send_src, hsg.recv_dst, hsg.send_valid)], "deg": int(hsg.deg.shape[0]),
             "k6": int(hplans.tile_block.shape[0]), "bucketed_rows": int(dist.shard_swarm(bst, mesh).seen.shape[0]),
             "digest": state_digest(dist.gather_swarm(fin, mesh)),
             "bucketed": state_digest(dist.gather_swarm(bfin, mesh))})
    torch.distributed.destroy_process_group()


def test_a_rank_holds_only_its_rows():
    """Under two ranks each rank's state planes, plan tables, class layout,
    bucket tables and K6 plans hold half the rows, and the gathered run
    equals the one-process run."""
    import queue

    import torch.multiprocessing as mp

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.core.topology import build_csr, preferential_attachment
    from tpu_gossip_torch.utils.digest import state_digest

    ctx = mp.get_context("spawn")
    out, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_rank_worker, args=(r, port, out)) for r in range(2)]
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
    mesh = dist.make_mesh(4, device="cpu")
    dg, plan = matching_powerlaw_graph_sharded(600, 4, fanout=1, key=prng.key(1, "cpu"), device="cpu")
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=1, mode="push_pull")
    st = init_swarm(dg.as_padded_graph(), cfg, origins=[0, 5], exists=dg.exists, key=prng.key(3, "cpu"), device="cpu")
    fin, _ = dist.simulate_dist(st, cfg, dist.shard_matching_plan(plan, mesh), mesh, 4)
    g = build_csr(400, preferential_attachment(400, m=3, rng=np.random.default_rng(0), use_native=False))
    sg, rel, pos = dist.partition_graph(g, 4, device="cpu")
    bcfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=8, fanout=2, mode="push_pull")
    bst = dist.init_sharded_swarm(sg, rel, pos, bcfg, key=prng.key(2, "cpu"), origins=[0], device="cpu")
    bfin, _ = dist.simulate_dist(bst, bcfg, sg, mesh, 4, dist.build_shard_plans(sg))
    for r in got.values():
        assert r["state_rows"] == dict.fromkeys(("seen", "alive", "exists"), plan.n // 2)
        assert (r["plan_rows"], r["lane_rows"], r["valid_rows"]) == (plan.rows // 2,) * 3
        assert (r["plan_n"], r["deg_real"], r["class_nodes"]) == (plan.n // 2,) * 3
        assert r["sg"] == [[2, 4, sg.bucket]] * 3 and r["deg"] == sg.n_pad // 2 and r["k6"] == 2
        assert r["bucketed_rows"] == sg.n_pad // 2
        assert r["digest"] == state_digest(fin) and r["bucketed"] == state_digest(bfin)


@pytest.mark.parametrize("offset,rows", [(0, 3), (128 * 5, 7), (128 * 7 + 3, 2)])
def test_bits_with_offset_is_the_global_draws_block(offset, rows):
    """A process's gate draw at its rows' counter offset is the block of the
    one global draw."""
    k = prng.split(prng.key(11, "cpu"))[1]
    whole = prng.bits(k, (16, 128)).reshape(-1)
    assert torch.equal(prng.bits(k, (rows, 128), offset), whole[offset: offset + rows * 128].view(rows, 128))


@pytest.mark.parametrize("flag", [["--grow", "400"], ["--stream", "2", "--rounds", "8"],
                                  ["--control", "0.9"], ["--pipeline", "1"], ["--builder", "dist"]])
def test_planes_of_item_11d_pass_under_coordinator(flag):
    """Under --coordinator every plane of ROADMAP item 11d passes every
    check of the run's config: growth, streams and control (parts 2 and 3),
    pipelined rounds and the distributed builder (parts 4 and 5)."""
    argv = ["--peers", "200", "--graph", "matching", "--shard", "--hosts", "2", "--coordinator", "127.0.0.1:1",
            "--num-processes", "2", "--process-id", "0", *flag, "--device", "cpu"]
    assert tcli.validate(tcli.build_parser().parse_args(argv)) is None


COORDINATOR = ["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"]


@pytest.mark.parametrize("flag", [["--shard", "--remat-every", "4"], ["--shard", "--profile-round", "2"], []],
                         ids=["remat_every", "profile_round", "no_shard"])
def test_refusals_shadowing_item_11d_keep_the_jax_words(capsys, flag):
    """Under --coordinator a remat loop, ``--profile-round`` and a run
    without ``--shard`` exit 2 with the JAX CLI's refusal of the same run
    (its ``--hosts`` checks and ``--profile-round``'s "decomposes the
    LOCAL round"; the port's line names its own profile script)."""
    from tpu_gossip.cli import run_sim as jcli

    argv = ["--peers", "200", "--graph", "matching", "--hosts", "2", "--quiet", *flag]
    capsys.readouterr()
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert tcli.main(argv + COORDINATOR + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.split(" (use ")[0] == want.split(" (use ")[0] and "item 11d" not in got


def test_serve_under_coordinator_equals_the_jax_cli(monkeypatch):
    """``run_sim serve`` ignores --coordinator, --num-processes and
    --process-id, as the JAX CLI's serve does (it dispatches before the
    cluster checks): ROADMAP §3's smallest config lands on the JAX CLI's
    summary, pinned (group ``cluster``; no arrivals)."""
    from tests.jax_pins import SERVE_COORDINATOR, serve_summary
    from tests.test_torch_serve_replay import port_serve

    rc, got, err = port_serve(SERVE_COORDINATOR, monkeypatch, [])
    assert rc == 0, err
    assert serve_summary(got) == pinned("cluster", "serve_coordinator")


def test_fleet_under_coordinator_gives_argparse_words(capsys):
    """``run_sim fleet --coordinator`` exits 2 with argparse's words, as the
    JAX CLI's fleet parser (which has no cluster flags) gives them."""
    from tpu_gossip.cli import run_sim as jcli

    argv = ["fleet", "scenarios/campaigns/catalogue_smoke.toml", "--coordinator", "127.0.0.1:1"]
    lines = []
    for main in (jcli.main, tcli.main):
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        assert e.value.code == 2
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert lines[0] == lines[1] == "run_sim fleet: error: unrecognized arguments: --coordinator 127.0.0.1:1"


def test_fleet_resume_under_coordinator_gives_argparse_words(capsys, campaign, tmp_path):  # noqa: F811
    """``run_sim resume D --coordinator ...`` on a fleet checkpoint exits 2
    with the words the JAX CLI's resume parser (which has no cluster flags)
    gives for any directory."""
    import contextlib
    import io

    from tpu_gossip.cli import run_sim as jcli

    d = tmp_path / "fleet"
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["fleet", campaign, "--checkpoint-every", "8", "--checkpoint-dir", str(d), "--quiet",
                          "--device", "cpu"]) == 0
    lines = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            main(["resume", str(d), *COORDINATOR, *extra])
        assert e.value.code == 2
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert lines[0] == lines[1] == "run_sim resume: error: unrecognized arguments: " + " ".join(COORDINATOR)
