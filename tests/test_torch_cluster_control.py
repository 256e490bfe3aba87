"""Streams and adaptive control on two gloo ranks on this CPU (ROADMAP item
11d part 3), each rank holding only its rows, against the JAX CLI's
one-process run on the same (2, 2) fold pinned in ``tests/jax_pins.json``
(group ``cluster``, ``CLUSTER_PLANES``): a degraded scenario with churn
joins, a stream at rate 2 and the controller with its PeerSwap refresh,
packed and not, and on the hier transport with hotspot origins; and, in two
ranks of one process group, the row helpers the planes cross the ranks
with (``fsum``, ``stack``, ``lookup``) and the hooks on seeded planes: the
controller's two hooks (every rank moves the whole cursor alike), the
admission draw, the degree gamma and the stream's origin gate, each equal
to the one-process result."""

import queue

import numpy as np
import pytest
import torch

from tests.test_torch_cluster_planes import equals_the_fold_pin
from tests.test_torch_cluster_procs import free_port
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name,packed", [("control_degraded", False), ("control_degraded", True),
                                         ("control_hier_hotspot", False)])
def test_control_planes_on_two_ranks_equal_the_jax_fold(name, packed):
    """``--control 0.85 --refresh-every 5`` with ``--stream 2``, churn joins
    on four re-wiring slots and ``degraded_under_control.toml``'s loss,
    delay and churn burst on the dense transport (the packed run onto the
    unpacked pin), and the same on the hier transport with hotspot
    origins."""
    equals_the_fold_pin(name, packed)


N_RANK = 40  # rows a rank holds
M = 8


def _seeded(n: int, seed: int = 7) -> dict:
    """The swarm's planes both ranks build alike (numpy-seeded): liveness,
    the slot planes, a CSR, the re-wiring plane and its credit book."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 6, n)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    alive = rng.random(n) < 0.9
    rewired = rng.random(n) < 0.4
    rt = rng.integers(-1, n, (n, 3)).astype(np.int32)
    rt[~rewired] = -1
    planes = dict(
        row_ptr=row_ptr, col_idx=rng.integers(0, n, row_ptr[-1]).astype(np.int32), alive=alive,
        declared_dead=(rng.random(n) < 0.05) & alive, exists=rng.random(n) < 0.95, rewired=rewired,
        rewire_targets=rt, degree_credit=np.bincount(rt[rewired][rt[rewired] >= 0], minlength=n).astype(np.int32),
        seen=rng.random((n, M)) < 0.6, incoming=rng.random((n, M)) < 0.5,
        slot_lease=np.where(rng.random(M) < 0.7, rng.integers(0, 12, M), -1).astype(np.int16),
        dropped=rng.integers(0, 50, n).astype(np.int32), delivered=rng.integers(0, 500, n).astype(np.int32))
    planes["seen_prev"] = planes["seen"] & (rng.random((n, M)) < 0.7)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in planes.items()}


WHOLE = ("row_ptr", "col_idx", "slot_lease")


def _hooks(p: dict, rows, lo: int, n: int) -> dict:
    """The planes' hooks over ``rows`` on the rows ``[lo, lo + n)`` of
    :func:`_seeded`'s planes: the controller's decision and update with the
    refresh due, the admission draw, the gamma and the stream's gate."""
    import types

    from tpu_gossip_torch.control import compile_control
    from tpu_gossip_torch.control.engine import apply_control, control_round
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.growth import engine as ge

    mine = {k: v if k in WHOLE else v[lo:lo + n] for k, v in p.items()}
    spec = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=5, refresh_every=3, ttl=8, device="cpu")
    state = types.SimpleNamespace(control_lvl=torch.tensor(3, dtype=torch.int32), **mine)
    rc = control_round(spec, state, want_needy=True, rows=rows)
    fstats = types.SimpleNamespace(msgs_dropped=mine["dropped"].sum(dtype=torch.int32),
                                   msgs_delivered=mine["delivered"].sum(dtype=torch.int32))
    key = prng.key(5, "cpu")
    cursor, targets, credit, tel = apply_control(
        spec, key, torch.tensor(12, dtype=torch.int32), rc, fstats=fstats, rewire_slots=3, rows=rows,
        **{k: mine[k] for k in ("incoming", "seen_prev", "seen", "alive", "declared_dead", "exists", "rewired",
                                "rewire_targets", "degree_credit", "row_ptr", "col_idx", "slot_lease")})
    log_deg = ge.attach_log_degrees(mine["row_ptr"], mine["exists"], mine["alive"], mine["declared_dead"],
                                    mine["rewired"], mine["rewire_targets"], mine["degree_credit"], lo)
    finite, tgt = ge.gumbel_top_k(key, log_deg, 5, 2, chunk_rows=2, held=rows)
    deg = ge.realized_degrees(mine["row_ptr"], mine["exists"], mine["rewired"], mine["rewire_targets"],
                              mine["degree_credit"], lo)
    gamma = ge.hill_gamma_device(deg, mine["alive"], 2, rows)
    ids = torch.tensor([0, 3, 2 * N_RANK - 1, N_RANK, N_RANK - 1, 17], dtype=torch.int64)
    gate = rows.lookup(ids, mine["exists"] & mine["alive"], label="t")
    return dict(lvl=int(rc.lvl), m_eff=int(rc.m_eff), pull_on=bool(rc.pull_on), needy=rc.needy.tolist(),
                cursor=int(cursor), targets=targets.tolist(), credit=credit.tolist(),
                tel=[int(tel.level), int(tel.fanout), int(tel.duplicate), int(rows.sum(tel.refreshed))],
                finite=finite.tolist(), tgt=tgt.tolist(), gamma=float(gamma), gate=gate.tolist())


def _worker(rank: int, port: int, out):
    """One rank of :func:`two_ranks` (spawned)."""
    from tpu_gossip_torch.cluster import topology as topo
    from tpu_gossip_torch.cluster.launch import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, rank, "gloo", "cpu")
    rows = topo.row_block(topo.make_cluster_mesh(2, 2, "cpu"), N_RANK)
    res = {"rank": rank, "hooks": _hooks(_seeded(2 * N_RANK), rows, rows.lo, N_RANK)}
    part = torch.tensor([0.1, 1e16, -1e16][rank:rank + 2], dtype=torch.float64).sum()
    res["fsum"] = rows.fsum(part, label="f").item()
    res["stack"] = rows.stack(torch.tensor([rank, 7 * rank], dtype=torch.int16), label="s").tolist()
    res["stack_bool"] = rows.stack(torch.tensor([rank == 0, True]), label="s").tolist()
    out.put(res)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks():
    """Both ranks' results (:func:`_worker`) and the one-process hooks on
    the whole planes."""
    import torch.multiprocessing as mp

    from tpu_gossip_torch.core.rows import ALL_ROWS

    ctx = mp.get_context("spawn")
    out, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, out)) for r in range(2)]
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
    return got, _hooks(_seeded(2 * N_RANK), ALL_ROWS, 0, 2 * N_RANK)


def test_every_rank_moves_the_whole_cursor_alike(two_ranks):
    """The controller's decision and update on two ranks: each rank resolves
    the same level, fanout and pull gate and ends the round with the same
    cursor, the one-process round's; the telemetry's level, fanout and
    duplicates are whole on each and the refreshes sum to the swarm's;
    each rank's needy rows, re-wiring targets and credit are its block of
    the one-process planes."""
    got, whole = two_ranks
    for r, res in got.items():
        h, lo = res["hooks"], r * N_RANK
        for k in ("lvl", "m_eff", "pull_on", "cursor", "tel"):
            assert h[k] == whole[k], k
        for k in ("needy", "targets", "credit"):
            assert h[k] == whole[k][lo:lo + N_RANK], k
    assert whole["tel"][3] > 0  # the refresh swapped


def test_admission_gamma_and_gate_on_two_ranks_equal_one_process(two_ranks):
    """The admission draw (each rank its column block, the top-m merged),
    the degree gamma (the float64 partials in rank order, within 1e-6 of
    the one-process sum) and the stream's gate at ids across both blocks
    are the one-process results on every rank."""
    got, whole = two_ranks
    for res in got.values():
        h = res["hooks"]
        assert (h["finite"], h["tgt"], h["gate"]) == (whole["finite"], whole["tgt"], whole["gate"])
        assert h["gamma"] == pytest.approx(whole["gamma"], abs=1e-6)
    assert got[0]["hooks"]["gamma"] == got[1]["hooks"]["gamma"]


def test_fsum_adds_in_rank_order_and_stack_keeps_dtypes(two_ranks):
    """``fsum`` adds the partials in rank order on every rank (``(0.1 +
    1e16) + (1e16 - 1e16)`` here, bit for bit on both), and ``stack`` gives
    each rank's tensor in rank order in its own dtype, bools included."""
    got, _ = two_ranks
    p0 = np.float64(0.1) + np.float64(1e16)
    p1 = np.float64(1e16) + np.float64(-1e16)
    for res in got.values():
        assert res["fsum"] == float(p0 + p1)
        assert res["stack"] == [[0, 0], [1, 7]] and res["stack_bool"] == [[True, True], [False, True]]
