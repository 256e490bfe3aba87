"""The row planes on two gloo ranks, continued (``test_torch_cluster_planes.py``
holds the matching mesh's composed, compact and split-brain witnesses):
silent peers under the quorum detector on the auto transport, churn with a
delayed-loss scenario on the hier transport, the bucketed mesh's composed
siege through K6's plan (its plain version here), each packed and not,
against the JAX fold's pins; the row helpers of ``core.rows`` in one
process and of ``cluster.topology.ProcessRows`` in two ranks; and one pin
of the group recomputed by the JAX package in a child process."""

import queue

import pytest
import torch

from tests.jax_pins import pinned
from tests.test_torch_cluster_planes import equals_the_fold_pin
from tests.test_torch_cluster_procs import free_port
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.cluster import topology as topo
from tpu_gossip_torch.core.rows import ALL_ROWS


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("name", ["silent", "hier", "bucketed"])
def test_row_planes_on_two_ranks_equal_the_jax_fold(name, packed):
    """``--silent-frac 0.05 --quorum-k 3`` (auto transport), churn under
    ``lossy_links.toml``'s loss and delay with quorum 3 (hier transport),
    and the bucketed mesh's composed siege with ``--staircase`` (S = 4)."""
    equals_the_fold_pin(name, packed)


def _planes(rank: int, n: int):
    """The global planes both ranks build alike, and rank ``rank``'s
    contribution plane to every reduction (from its own seed)."""
    g = torch.Generator().manual_seed(5)
    flags = torch.rand(2 * n, 3, generator=g) > 0.5
    marks = torch.randint(-9, 9, (2 * n,), generator=g).to(torch.int16)
    c = torch.randint(0, 3, (2 * n,), generator=torch.Generator().manual_seed(100 + rank)).to(torch.int32)
    return flags, marks, c


def _helpers_worker(rank: int, port: int, n: int, out):
    """One rank of :func:`two_rank_helpers` (spawned)."""
    from tpu_gossip_torch.cluster.launch import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", 2, rank, "gloo", "cpu")
    flags, marks, c = _planes(rank, n)
    lo = rank * n
    mine = slice(lo, lo + n)
    res = {"rank": rank}
    res["one_process_block"] = topo.row_block(topo.Mesh(4, torch.device("cpu")), 2 * n) is ALL_ROWS
    topo.SIDE_PATHS.clear()
    rows = topo.row_block(topo.make_cluster_mesh(4, 2, "cpu"), n)  # two shards of n / 2 rows a rank
    res["offset"], res["rows"] = rows.lo, rows.total(n)
    res["row_sum"] = int(rows.sum(torch.tensor(rank + 1, dtype=torch.int32)))
    got_flags, got_marks = rows.gather(flags[mine], marks[mine], label="t")
    res["gathered"] = [got_flags.tolist(), got_marks.tolist(), str(got_marks.dtype)]
    res["or"] = rows.reduce(c > 1, "or", label="t").tolist()
    res["sum"] = rows.reduce(c, "sum", label="t").tolist()
    res["max"] = rows.reduce(c, "max", label="t").tolist()
    res["sum_dtype"] = str(rows.reduce(c, "sum", label="u").dtype)
    res["sent"] = topo.SIDE_PATHS["t"][:2]
    out.put(res)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank_helpers():
    """Both ranks' results of the helpers on ``_planes``' planes, n = 10
    rows a rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out, port, n = ctx.Queue(), free_port(), 10
    procs = [ctx.Process(target=_helpers_worker, args=(r, port, n, out)) for r in range(2)]
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
    return n, got


def test_helpers_are_the_identity_in_one_process():
    """A one-process mesh's block is every row (``ALL_ROWS``), whose every
    helper hands its input back: offset 0, the rows themselves, the plane
    object itself."""
    flags, marks, c = _planes(0, 6)
    rows = topo.row_block(topo.make_cluster_mesh(4, 2, "cpu"), 12)
    assert rows is ALL_ROWS
    assert rows.lo == 0 and rows.total(12) == 12
    x = torch.tensor(7, dtype=torch.int32)
    assert rows.sum(x) is x
    got = rows.gather(flags, marks)
    assert got[0] is flags and got[1] is marks
    for op, plane in (("or", c > 1), ("sum", c), ("max", c)):
        assert rows.reduce(plane, op) is plane


@pytest.mark.parametrize("held", ["all", "block"])
@pytest.mark.parametrize("plane,op", [("float", "sum"), ("int", "or"), ("int", "min")])
def test_reduce_rows_refuses_what_is_not_order_free(plane, op, held):
    """A float plane (its sum depends on the order), OR of a non-bool plane
    and an unknown combination are refused, by every row and by a
    process's block (before any collective)."""
    x = torch.zeros(4, dtype=torch.float32 if plane == "float" else torch.int32)
    rows = ALL_ROWS if held == "all" else topo.ProcessRows(world=2, lo=2)
    with pytest.raises(ValueError):
        rows.reduce(x, op)


def test_row_offset_and_counts_on_two_ranks(two_rank_helpers):
    """Rank r's rows start at r * n of 2n rows, and a count sums over the
    ranks (1 + 2); a one-process mesh's block is every row."""
    n, got = two_rank_helpers
    for r, res in got.items():
        assert res["one_process_block"]
        assert (res["offset"], res["rows"], res["row_sum"]) == (r * n, 2 * n, 3)


def test_gather_planes_on_two_ranks_is_the_global_plane(two_rank_helpers):
    """Each rank gets the whole plane, a bool plane and an int16 plane in
    their own dtypes."""
    n, got = two_rank_helpers
    flags, marks, _ = _planes(0, n)
    for res in got.values():
        assert res["gathered"] == [flags.tolist(), marks.tolist(), "torch.int16"]


def test_reduce_rows_on_two_ranks_lands_on_the_owners(two_rank_helpers):
    """Each rank keeps its rows of the OR, the integer SUM (in the plane's
    dtype) and the MAX of both ranks' contribution planes."""
    n, got = two_rank_helpers
    c0, c1 = _planes(0, n)[2], _planes(1, n)[2]
    for r, res in got.items():
        mine = slice(r * n, (r + 1) * n)
        assert res["or"] == ((c0 > 1) | (c1 > 1))[mine].tolist()
        assert res["sum"] == (c0 + c1)[mine].tolist() and res["sum_dtype"] == "torch.int32"
        assert res["max"] == torch.maximum(c0, c1)[mine].tolist()


def test_side_path_bytes_move_bools_as_bits(two_rank_helpers):
    """A rank sends the other: the gather's 30 bools as 4 bytes and its 10
    int16 as 20; each reduction the other rank's block, 10 bools as 2
    bytes, 10 int32 as 40 twice."""
    n, got = two_rank_helpers
    for res in got.values():
        assert res["sent"] == [4, (4 + 2 * n) + 2 + 2 * 4 * n]


def test_planes_pins_are_current():
    """One pin of the planes' runs, recomputed by the JAX package's CLI in a
    child process on its forced host devices, equals the file."""
    names = ["planes_silent"]
    assert jax_in_child("tests.jax_pins", "compute", "cluster", names) == {
        name: pinned("cluster", name) for name in names}
