"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip without one.
Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`` (the
suite's conftest imports JAX, which a GPU machine need not have).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda", 0)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("entry", ["lane_shuffle", "lane_shuffle_t", "tinv_lane_shuffle"])
@pytest.mark.parametrize("rows,dtype", [(40, torch.int32), (72, torch.int32), (2056, torch.int32), (96, torch.int8),
                                        (4128, torch.int8), (43424, torch.int8), (43424, torch.int32)])
def test_lane_shuffle_kernel_equals_plain(dev, entry, rows, dtype):
    """Each K1 entry, ragged int32 tiles (R % 32 != 0) among the shapes."""
    from tpu_gossip_torch.kernels import permute
    from tpu_gossip_torch.kernels.native import K1_ENTRIES, LAUNCHES

    g = _gen(dev, rows)
    x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=g, device=dev, dtype=torch.int32)
    idx = torch.argsort(torch.rand((rows, 128), generator=g, device=dev), dim=1).to(dtype)
    before, before_entry = LAUNCHES["lane_shuffle"], K1_ENTRIES[entry]
    got = getattr(permute, entry)(x, idx)
    assert LAUNCHES["lane_shuffle"] == before + 1 and K1_ENTRIES[entry] == before_entry + 1
    assert torch.equal(got, getattr(permute, f"{entry}_plain")(x, idx))


@pytest.mark.parametrize("n", [2000, 500_000])
def test_partner_pass_on_card_runs_fused_shuffles_and_no_transpose(dev, n, monkeypatch):
    """A K-stage plan's pass on the card: 2K+1 K1 launches, no torch
    transpose, and the plain stages' result."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.kernels import permute
    from tpu_gossip_torch.kernels.native import LAUNCHES

    _, plan = matching_powerlaw_graph(n, fanout=1, key=prng.key(0, dev), device=dev)
    x = torch.randint(-2**31, 2**31 - 1, (plan.rows, 128), generator=_gen(dev, 5), device=dev, dtype=torch.int32)
    want = x
    for stage in plan.stages:
        if stage[0] == "lane":
            want = permute.lane_shuffle_plain(want, stage[1])
        else:
            want = (permute.transpose_pass if stage[0] == "t" else permute.untranspose_pass)(want)
    for name in ("transpose_pass", "untranspose_pass"):
        monkeypatch.setattr(permute, name, lambda x, name=name: pytest.fail(f"partner pass ran {name}"))
    before = LAUNCHES["lane_shuffle"]
    got = plan.partner(x)
    assert LAUNCHES["lane_shuffle"] - before == 2 * len(plan.lanes) + 1
    assert torch.equal(got, want)


def test_kernels_refuse_unaligned_operands(dev):
    from tpu_gossip_torch.kernels.permute import lane_shuffle, lane_shuffle_t, tinv_lane_shuffle
    from tpu_gossip_torch.kernels.round_tail import tail_kernel

    flat = torch.zeros(33 * 128, dtype=torch.int32, device=dev)
    x = flat[1 : 1 + 32 * 128].view(32, 128)
    idx = torch.zeros((32, 128), dtype=torch.int8, device=dev)
    for fn in (lane_shuffle, lane_shuffle_t, tinv_lane_shuffle):
        with pytest.raises(ValueError, match="16-byte"):
            fn(x, idx)
    planes = [torch.zeros((64, 3), dtype=torch.bool, device=dev) for _ in range(6)]
    ir = torch.full((64, 3), -1, dtype=torch.int16, device=dev)
    shifted = torch.zeros(64 * 3 + 1, dtype=torch.bool, device=dev)[1:].view(64, 3)
    with pytest.raises(ValueError, match="16-byte"):
        tail_kernel(shifted, planes[0], ir, *planes[1:5], None, torch.tensor(1, device=dev),
                    forward_once=False, sir_recover_rounds=0)


@pytest.mark.parametrize("op", ["or", "sum"])
@pytest.mark.parametrize("slot_off,cstride,count,pad_deg", [(0, 1024, 1000, 1), (2048, 9216, 9115, 2),
                                                              (0, 455680, 455670, 2)])
def test_fold_planes_kernel_equals_plain(dev, slot_off, cstride, count, pad_deg, op):
    from tpu_gossip_torch.kernels.permute import fold_planes, fold_planes_plain

    rows = -(-(slot_off + pad_deg * cstride) // 128)
    x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=_gen(dev, 1), device=dev, dtype=torch.int32)
    assert torch.equal(fold_planes(x, slot_off, cstride, count, pad_deg, op),
                       fold_planes_plain(x, slot_off, cstride, count, pad_deg, op))


@pytest.mark.parametrize("op", ["or", "sum"])
@pytest.mark.parametrize("case", ["mixed", "gaps", "node_major", "plan1000000"])
def test_fold_classes_kernel_equals_plain(dev, case, op):
    """K2 over a whole class table, one launch: the crafted tables (gaps,
    hubs, pad_deg 1 to 5000) and the 1M plan's."""
    from tpu_gossip_torch.kernels.fold_cases import crafted_classes
    from tpu_gossip_torch.core.matching_topology import class_layout, plan_shape
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.permute import fold_classes, fold_classes_plain

    if case.startswith("plan"):
        n_out = int(case[4:])
        _, _, classes, rows = plan_shape(n_out)
    else:
        classes, rows, n_out = crafted_classes(case)
    layout = class_layout(classes, rows, n_out, dev)
    x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=_gen(dev, rows), device=dev, dtype=torch.int32)
    before = LAUNCHES[f"fold_planes_{op}"]
    got = fold_classes(x, layout, op)
    assert LAUNCHES[f"fold_planes_{op}"] == before + 1
    assert torch.equal(got, fold_classes_plain(x, layout, op))


def test_plan_reduce_is_one_k2_launch_and_nothing_else(dev):
    """One ``plan.reduce`` on the card: one K2 launch counted, and the
    profiler sees that one kernel on the device and no other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.permute import fold_classes_plain

    _, plan = matching_powerlaw_graph(200_000, fanout=1, key=prng.key(0, dev), device=dev)
    x = torch.randint(-2**31, 2**31 - 1, (plan.rows, 128), generator=_gen(dev, 2), device=dev, dtype=torch.int32)
    plan.reduce(x, "or")  # built and loaded before the count
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = plan.reduce(x, "or")
        torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]} == {"fold_planes_or": 1}
    kernels = [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "fold_classes_kernel" in kernels[0], kernels
    assert torch.equal(got, fold_classes_plain(x, plan.layout, "or"))


@pytest.mark.parametrize("fo,sir,fresh,expired", list(itertools.product([False, True], [0, 4], [False, True], [False, True])))
def test_round_tail_kernel_equals_plain(dev, fo, sir, fresh, expired):
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    n, m = 1001, 7
    g = _gen(dev, 3)
    b = lambda p: torch.rand((n, m), generator=g, device=dev) < p  # noqa: E731
    ir = torch.where(b(0.5), torch.randint(-1, 9, (n, m), generator=g, device=dev, dtype=torch.int16),
                     torch.full((n, m), -1, dtype=torch.int16, device=dev))
    args = (b(0.5), b(0.3), ir, b(0.2), b(0.4), b(0.8), b(0.5),
            (torch.rand(n, generator=g, device=dev) < 0.1) if fresh else None,
            torch.tensor(9, dtype=torch.int32, device=dev))
    kw = dict(forward_once=fo, sir_recover_rounds=sir,
              expired=(torch.rand(m, generator=g, device=dev) < 0.3) if expired else None)
    for a, p in zip(tail_kernel(*args, **kw), tail_fused(*args, **kw)):
        assert torch.equal(a, p)


def _cap_edge_tail(dev, n, m, g):
    """Bool tail operands whose infected_round holds ROUND_CAP, -1 and small
    values."""
    b = lambda p: torch.rand((n, m), generator=g, device=dev) < p  # noqa: E731
    vals = torch.tensor([32767, 32766, -1, 0, 1, 5, 8], dtype=torch.int16, device=dev)
    ir = vals[torch.randint(0, 7, (n, m), generator=g, device=dev)]
    return [b(0.5), b(0.3), ir, b(0.2), b(0.5), b(0.9), b(0.5)]


@pytest.mark.parametrize("rnd", [9, 32771])
@pytest.mark.parametrize("age_saturated", [False, True])
def test_round_tail_kernel_cap_edge_equals_plain(dev, rnd, age_saturated):
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    n, m = 1001, 7
    g = _gen(dev, 4)
    ops = _cap_edge_tail(dev, n, m, g)
    fresh = torch.rand(n, generator=g, device=dev) < 0.1
    expired = torch.rand(m, generator=g, device=dev) < 0.3
    r = torch.tensor(rnd, dtype=torch.int32, device=dev)
    for kw in (dict(expired=None), dict(expired=expired)):
        kw.update(forward_once=True, sir_recover_rounds=4, age_saturated=age_saturated)
        for a, p in zip(tail_kernel(*ops, fresh, r, **kw), tail_fused(*ops, fresh, r, **kw)):
            assert torch.equal(a, p)


@pytest.mark.parametrize("m", [1, 3, 16, 32])
@pytest.mark.parametrize("n", [1001, 4099])
def test_round_tail_kernel_vector_widths_equal_plain(dev, m, n):
    """K3's 16-element vectors across row ends (m = 3), several rows a
    vector (m = 1) and rows of whole vectors (m = 16, 32), with the
    N*M mod 16 remainder, every flag, rounds 9 and 32771, both SIR ages."""
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    g = _gen(dev, m * 7 + n)
    ops = _cap_edge_tail(dev, n, m, g)
    fresh = torch.rand(n, generator=g, device=dev) < 0.1
    expired = torch.rand(m, generator=g, device=dev) < 0.3
    for fo, sir, f, e, rnd, sat in itertools.product([False, True], [0, 4], [None, fresh], [None, expired],
                                                     [9, 32771], [False, True]):
        r = torch.tensor(rnd, dtype=torch.int32, device=dev)
        kw = dict(forward_once=fo, sir_recover_rounds=sir, expired=e, age_saturated=sat)
        for a, p in zip(tail_kernel(*ops, f, r, **kw), tail_fused(*ops, f, r, **kw)):
            assert torch.equal(a, p)


@pytest.mark.parametrize("m", [16, 13, 1, 17])
@pytest.mark.parametrize("fo,sir", list(itertools.product([False, True], [0, 4])))
def test_round_tail_words_kernel_equals_plain(dev, m, fo, sir):
    from tpu_gossip_torch.core.packed import pack_bits, word_mask
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.round_tail import round_tail_words, tail_words_plain

    n = 4099
    g = _gen(dev, m * 10 + sir + fo)
    ops = _cap_edge_tail(dev, n, m, g)
    words = [pack_bits(t) if t.dtype == torch.bool else t for t in ops]
    fresh = torch.rand(n, generator=g, device=dev) < 0.1
    expired = torch.rand(m, generator=g, device=dev) < 0.3
    pad = ~word_mask(m, dev)
    for f, e, rnd, pallas in itertools.product([None, fresh], [None, expired], [9, 32771], [False, True]):
        r = torch.tensor(rnd, dtype=torch.int32, device=dev)
        kw = dict(m=m, forward_once=fo, sir_recover_rounds=sir, expired=e)
        before = LAUNCHES["round_tail_words"]
        got = round_tail_words(*words, f, r, pallas=pallas, **kw)
        assert LAUNCHES["round_tail_words"] == before + 1
        want = tail_words_plain(*words, f, r, age_saturated=pallas, **kw)
        for i, (a, p) in enumerate(zip(got, want)):
            assert torch.equal(a, p)
            if i != 2:
                assert not bool((a & pad).any())


def test_headline_digest_on_card_equals_cpu(dev):
    from tpu_gossip_torch.cli import run_sim

    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "matching",
            "--rounds", "20", "--digest", "--quiet"]
    parser = run_sim.build_parser()
    on_card = run_sim.run(parser.parse_args(argv + ["--device", "cuda"]))
    on_cpu = run_sim.run(parser.parse_args(argv + ["--device", "cpu"]))
    assert on_card == on_cpu
    assert np.isfinite(on_card["final_coverage"])


def _staircase_case(dev, case: str, rows: int):
    """(plan, vals, bill) for one K5 case: a Chung-Lu CSR, a row spanning
    several tiles, or an edgeless CSR; words with bit 31 set."""
    from tpu_gossip_torch.core import topology as tt
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan

    if case == "chung_lu":
        deg = tt.powerlaw_degree_sequence(20000, rng=np.random.default_rng(rows))
        g = tt.build_csr(20000, tt.configuration_model(deg, rng=np.random.default_rng(1)))
        rp, ci = g.row_ptr, g.col_idx
    elif case == "hub":
        deg = np.array([9000] + [3] * 700)
        rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        ci = (np.arange(rp[-1]) % 701).astype(np.int32)
    else:
        rp, ci = np.zeros(3001, np.int32), np.zeros(0, np.int32)
    plan = build_staircase_plan(rp, ci, fanout=1, rows=rows, device=dev)
    g = _gen(dev, rows)
    vals = torch.randint(-2**31, 2**31 - 1, plan.offs.shape, generator=g, device=dev, dtype=torch.int32)
    vals[0, :4] = -2**31
    bill = torch.randint(0, 40, plan.offs.shape, generator=g, device=dev, dtype=torch.int32)
    return plan, vals, bill


@pytest.mark.parametrize("case", ["chung_lu", "hub", "edgeless"])
@pytest.mark.parametrize("rows", [128, 512, 1024])
@pytest.mark.parametrize("billed", [False, True])
def test_staircase_segment_kernel_equals_plain(dev, case, rows, billed):
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.pallas_segment import staircase_plain, staircase_segment

    plan, vals, bill = _staircase_case(dev, case, rows)
    bill = bill if billed else None
    before = LAUNCHES["staircase_segment"]
    got = staircase_segment(plan.tile_block, plan.offs, vals, plan.rows, plan.n_blocks, bill)
    assert LAUNCHES["staircase_segment"] == before + 1
    want = staircase_plain(plan.tile_block, plan.offs, vals, plan.rows, plan.n_blocks, bill)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (not billed)
    if billed:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("argv", [
    ["--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--staircase"],
    ["--graph", "chung-lu", "--mode", "flood", "--staircase", "--slots", "40"],
    ["--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1"],
])
def test_staircase_digest_on_card_equals_cpu(dev, argv):
    _assert_card_equals_cpu(argv)


@pytest.mark.parametrize("argv", [
    ["--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--tail", "pallas", "--sir-recover", "4",
     "--slots", "13"],
    ["--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--forward-once"],
])
def test_packed_digest_on_card_equals_cpu(dev, argv):
    _assert_card_equals_cpu(argv + ["--packed"])


def _assert_card_equals_cpu(argv):
    from tpu_gossip_torch.cli import run_sim

    argv = ["--peers", "2000", "--rounds", "20", "--digest", "--quiet", *argv]
    parser = run_sim.build_parser()
    assert run_sim.run(parser.parse_args(argv + ["--device", "cuda"])) == \
        run_sim.run(parser.parse_args(argv + ["--device", "cpu"]))


def _shard_plans(dev, kind: str, s: int):
    """(ShardedGraph, ShardPlans) on the card: a Chung-Lu graph, or a star
    and ring inside shard 0 (windows split across blocks, shard 1's runs
    empty), or an edgeless graph."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import topology as tt

    if kind == "chung_lu":
        deg = tt.powerlaw_degree_sequence(20000, rng=np.random.default_rng(s))
        g = tt.build_csr(20000, tt.configuration_model(deg, rng=np.random.default_rng(1)))
    elif kind == "hub":
        star = np.stack([np.zeros(299, np.int64), np.arange(1, 300)], axis=1)
        ring = np.stack([np.arange(1, 299), np.arange(2, 300)], axis=1)
        g = tt.build_csr(600, np.concatenate([star, ring]))
    else:
        g = tt.build_csr(600, np.zeros((0, 2), np.int64))
    sg, _, _ = dist.partition_graph(g, s, seed=0, permute=kind == "chung_lu", device=dev)
    return sg, dist.build_shard_plans(sg, rows=1024 if kind == "chung_lu" else 128)


@pytest.mark.parametrize("kind,s", [("chung_lu", 1), ("chung_lu", 2), ("chung_lu", 8), ("hub", 2), ("edgeless", 2)])
@pytest.mark.parametrize("m", [1, 16, 32])
def test_stream_segment_kernel_equals_plain(dev, kind, s, m):
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.pallas_segment import stream_segment_or, stream_segment_plain

    sg, plan = _shard_plans(dev, kind, s)
    g = _gen(dev, s * 100 + m)
    for d in range(s):
        vals = torch.randint(-2**31, 2**31 - 1, (s * sg.bucket,), generator=g, device=dev, dtype=torch.int32)
        vals = vals if m == 32 else vals & ((1 << m) - 1)
        args = (plan.tile_block[d], plan.window_idx[d], plan.offs[d], vals, plan.rows, plan.n_blocks)
        before = LAUNCHES["stream_segment"]
        got = stream_segment_or(*args)
        assert LAUNCHES["stream_segment"] == before + 1
        assert torch.equal(got, stream_segment_plain(*args))


def test_stream_segment_refuses_window_past_the_stream(dev):
    """The kernel's route refuses a window outside the stream, as the plain
    version does, and launches nothing."""
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.pallas_segment import stream_segment_or

    sg, plan = _shard_plans(dev, "chung_lu", 2)
    vals = torch.zeros((2 * sg.bucket,), dtype=torch.int32, device=dev)
    wi = plan.window_idx[1].clone()
    wi[-1] = 2 * sg.bucket // 1024
    before = LAUNCHES["stream_segment"]
    with pytest.raises(ValueError, match="window_idx must lie in"):
        stream_segment_or(plan.tile_block[1], wi, plan.offs[1], vals, plan.rows, plan.n_blocks)
    assert LAUNCHES["stream_segment"] == before


@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("receive", ["k6", "scatter", "packed"])
def test_sharded_runs_launch_what_their_path_needs(dev, s, receive):
    """A sharded run on one card equals its CPU run and launches K6 once a
    round per shard (m = 16: one slot group) with a plan, never without
    one; K3 once a round, or K4 on the packed state; K5 never."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core import topology as tt
    from tpu_gossip_torch.core.packed import pack_state, unpack_state
    from tpu_gossip_torch.core.state import SwarmConfig
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    deg = tt.powerlaw_degree_sequence(5000, rng=np.random.default_rng(0))
    graph = tt.build_csr(5000, tt.configuration_model(deg, rng=np.random.default_rng(1)))
    rounds, out = 6, {}
    for d in (dev, torch.device("cpu")):
        mesh = dist.make_mesh(s, device=d)
        sg, rel, pos = dist.partition_graph(graph, s, seed=1, device=d)
        cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=16, fanout=1, mode="push_pull")
        state = dist.shard_swarm(dist.init_sharded_swarm(sg, rel, pos, cfg, key=prng.key(1, d), origins=[0, 7],
                                                         device=d), mesh)
        plan = None if receive == "scatter" else dist.build_shard_plans(sg)
        native.reset_launches()
        fin, stats = dist.simulate_dist(pack_state(state) if receive == "packed" else state, cfg, sg, mesh,
                                        rounds, plan)
        fin = unpack_state(fin) if receive == "packed" else fin
        out[d.type] = (state_digest(fin), stats_digest(stats), dict(native.LAUNCHES))
    assert out["cuda"][:2] == out["cpu"][:2]
    launches = out["cuda"][2]
    assert launches["stream_segment"] == (0 if receive == "scatter" else s * rounds)
    assert launches["round_tail"] == (0 if receive == "packed" else rounds)
    assert launches["round_tail_words"] == (rounds if receive == "packed" else 0)
    assert launches["staircase_segment"] == 0
    assert all(v == 0 for v in out["cpu"][2].values())


@pytest.mark.parametrize("extra", [["--staircase"], ["--staircase", "--packed"], []])
def test_shard_digest_on_card_equals_cpu(dev, extra):
    _assert_card_equals_cpu(["--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--shard", *extra])


# every P2 shape (32 KB rows staged whole, 256 and 512 KB rows in part, 4 KB
# rows on the L2 route), P1 axis 1 and P4 (T = N, the L2 route), ragged
# staged shapes (a row just past the stage, a 1 MB row, one block a row) and
# W not a multiple of 4
LANE_CASES = [(8, 1024, 512), (8, 8192, 256), (16, 8192, 256), (8, 65536, 64), (16, 65536, 128), (8, 131072, 32),
              (8, 128, 8), (64, 128, 64), (512, 128, 512), (2048, 128, 2048), (8192, 128, 8192),
              (65536, 128, 65536), (3, 40000, 9), (5, 65540, 10), (1, 262144, 3), (7, 32768, 14), (2, 8196, 6),
              (4, 6, 12), (3, 10, 9)]


@pytest.mark.parametrize("t_rows,width,n_rows", LANE_CASES)
def test_lane_gather_kernel_equals_plain(dev, t_rows, width, n_rows):
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.permute import lane_shuffle
    from tpu_gossip_torch.kernels.probes import lane_gather, lane_gather_plain

    g = _gen(dev, width)
    tab = torch.randint(-2**31, 2**31 - 1, (t_rows, width), generator=g, device=dev, dtype=torch.int32)
    idx = torch.randint(0, width, (n_rows, width), generator=g, device=dev, dtype=torch.int32)
    before = LAUNCHES["lane_gather"]
    got = lane_gather(tab, idx)
    assert LAUNCHES["lane_gather"] == before + 1
    assert torch.equal(got, lane_gather_plain(tab, idx))
    if t_rows == n_rows and width == 128:
        assert torch.equal(got, lane_shuffle(tab, idx))


# P3 and ragged slab shapes (group 0, at least two idx rows a table row),
# every P1 axis-0 row count and a table past the slab (the L2 route), P5
# and another group
SUBLANE_CASES = [(8192, 47104, 0), (8192, 47105, 0), (100, 4097, 0), (1, 9, 0), (5000, 20000, 0), (8192, 16389, 0),
                 (8, 8, 0), (64, 64, 0), (512, 512, 0), (2048, 2048, 0), (8192, 8192, 0), (9000, 20000, 0),
                 (65536, 65536, 8), (48, 48, 16)]


@pytest.mark.parametrize("t_rows,n_rows,group", SUBLANE_CASES)
def test_sublane_gather_kernel_equals_plain(dev, t_rows, n_rows, group):
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.probes import sublane_gather, sublane_gather_plain

    g = _gen(dev, n_rows)
    tab = torch.randint(-2**31, 2**31 - 1, (t_rows, 128), generator=g, device=dev, dtype=torch.int32)
    idx = torch.randint(0, group or t_rows, (n_rows, 128), generator=g, device=dev, dtype=torch.int32)
    before = LAUNCHES["sublane_gather"]
    got = sublane_gather(tab, idx, group)
    assert LAUNCHES["sublane_gather"] == before + 1
    assert torch.equal(got, sublane_gather_plain(tab, idx, group))


# ---------------------------------------------------------------- churn


CHURN = dict(churn_leave_prob=0.01, churn_join_prob=0.2, rewire_slots=2)


def _churned(dev, n=20000, rounds=6, cap=0):
    """A Chung-Lu swarm on the card after a few rounds of heavy churn,
    and one more round's tail operands with the churn stage's fresh mask."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core import topology as tt
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim import engine, stages

    deg = tt.powerlaw_degree_sequence(n, rng=np.random.default_rng(3))
    g = tt.build_csr(n, tt.configuration_model(deg, rng=np.random.default_rng(4)))
    cfg = SwarmConfig(n_peers=n, msg_slots=16, mode="push_pull", fanout=1, rewire_compact_cap=cap, **CHURN)
    st = init_swarm(g, cfg, key=prng.key(1, dev), origins=[0, 7, 99], device=dev)
    st, _ = engine.simulate(st, cfg, rounds)
    _, tr, rc = engine.compute_roles(st)
    tx = engine.transmit_bitmap(st, cfg, tr)
    _, kp, kq, kl, kj = prng.split(st.rng, 5)
    inc, _ = engine._disseminate_local(st, cfg, tx, tr, rc, kp, kq)
    churn = stages._churn_stage(cfg)
    vals = {k: getattr(st, k) for k in churn.reads if hasattr(st, k)}
    vals.update(rnd=st.round + 1, k_leave=kl, k_join=kj)
    fresh = churn.fn(stages.StageView(vals, churn))["fresh"]
    assert int(fresh.sum()) > 0 and int(st.rewired.sum()) > 0
    return cfg, st, dict(incoming=inc, receptive=rc, transmit=tx, fresh=fresh, rnd=st.round + 1)


@pytest.mark.parametrize("cap", [0, 512])
@pytest.mark.parametrize("fo,sir", [(False, 0), (True, 4)])
def test_tail_kernels_with_fresh_on_churned_state_equal_plain(dev, cap, fo, sir):
    """K3 and K4 with the churn stage's fresh row mask, on a churned state."""
    from tpu_gossip_torch.core.packed import pack_bits
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.round_tail import round_tail, round_tail_words, tail_fused, tail_words_plain

    _, st, op = _churned(dev, cap=cap)
    planes = (st.seen, st.forwarded, st.infected_round, st.recovered, op["incoming"], op["receptive"],
              op["transmit"], op["fresh"], op["rnd"])
    kw = dict(forward_once=fo, sir_recover_rounds=sir)
    before = LAUNCHES["round_tail"], LAUNCHES["round_tail_words"]
    got = round_tail(*planes, impl="fused", **kw)
    want = tail_fused(*planes, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    words = [pack_bits(p) if p.dtype == torch.bool and p.dim() == 2 else p for p in planes]
    got_w = round_tail_words(*words, m=16, **kw)
    want_w = tail_words_plain(*words, m=16, age_saturated=False, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got_w, want_w))
    assert (LAUNCHES["round_tail"], LAUNCHES["round_tail_words"]) == (before[0] + 1, before[1] + 1)
    # the rejoined rows come out reset
    fresh = op["fresh"]
    assert not bool(got[0][fresh].any()) and bool((got[2][fresh] == -1).all())


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("kind", ["push_pull", "push", "pull"])
def test_stream_segment_with_blocked_runs_equals_scatter_and_plain(dev, s, kind):
    """K6 receiving runs the stale-edge filter zeroed (rewired receivers):
    the same bits and bill as the scatter receive, and each launch equal to
    its plain version."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.packed import packed_width, words8_to_words32
    from tpu_gossip_torch.dist import mesh as dm
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.pallas_segment import stream_segment_or, stream_segment_plain

    sg, plans = _shard_plans(dev, "chung_lu", s)
    g = _gen(dev, s)
    transmit = torch.rand((sg.n_pad, 16), generator=g, device=dev) < 0.3
    blocked = torch.rand((sg.n_pad,), generator=g, device=dev) < 0.2
    keys = prng.split(prng.key(3, dev), s)
    before = LAUNCHES["stream_segment"]
    k6 = dm._exchange(transmit & ~blocked[:, None], sg, keys, kind, 1, plans, blocked)
    scatter = dm._exchange(transmit & ~blocked[:, None], sg, keys, kind, 1, None, blocked)
    assert LAUNCHES["stream_segment"] == before + s
    assert torch.equal(k6[0], scatter[0]) and int(k6[1]) == int(scatter[1]) > 0
    assert not bool(k6[0][blocked].any())
    active, acts = dm.activation(sg, keys, kind, 1)
    received = dm.drop_blocked(dm.all_to_all(dm.send_payload(dm.payload_words(transmit, sg), active, acts)), sg,
                               blocked)
    words, _ = dm.bill(received, packed_width(16))
    for d in range(s):
        flat32 = words8_to_words32(words[d]).reshape(s * sg.bucket, -1)[:, 0].contiguous()
        args = (plans.tile_block[d], plans.window_idx[d], plans.offs[d], flat32, plans.rows, plans.n_blocks)
        assert torch.equal(stream_segment_or(*args), stream_segment_plain(*args))


def test_remat_plan_rebuild_on_card(dev):
    """A fold on the card, its staircase plan built on the host and on the
    card (equal routing tables), and K5 over the rebuilt plan delivering
    what ``flood_all`` delivers over the folded CSR (its tail ignored)."""
    from tpu_gossip_torch.kernels.gossip import flood_all
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan, build_staircase_plan_device, segment_or
    from tpu_gossip_torch.sim import engine

    cfg, st, _ = _churned(dev)
    folded, over = engine.rematerialize_rewired(st, cfg, engine.remat_capacity(st, cfg))
    assert int(over) == 0 and int(folded.row_ptr[-1]) < folded.col_idx.shape[0]
    plan = build_staircase_plan(folded.row_ptr, folded.col_idx, device=dev)
    dplan = build_staircase_plan_device(folded.row_ptr, folded.col_idx)
    for name in ("tile_block", "offs", "col_gather"):
        assert torch.equal(getattr(plan, name), getattr(dplan, name)), name
    before = LAUNCHES["staircase_segment"]
    got = segment_or(plan, folded.seen, 16)
    assert LAUNCHES["staircase_segment"] == before + 1
    assert torch.equal(got, flood_all(folded.seen, folded.row_ptr, folded.col_idx))


@pytest.mark.parametrize("argv", [
    ["--graph", "matching", "--rewire-compact-cap", "256"],
    ["--graph", "matching", "--rewire-compact-cap", "256", "--packed"],
    ["--graph", "chung-lu", "--staircase"],
    ["--graph", "chung-lu", "--staircase", "--remat-every", "7"],
    ["--graph", "chung-lu", "--shard", "--staircase", "--remat-every", "7"],
])
def test_churn_digest_on_card_equals_cpu(dev, argv):
    from tpu_gossip_torch.cli import run_sim

    argv = ["--peers", "2000", "--rounds", "20", "--digest", "--quiet", "--mode", "push_pull", "--fanout", "1",
            "--churn-leave", "0.01", "--churn-join", "0.1", "--rewire-slots", "2", *argv]
    parser = run_sim.build_parser()
    card, cpu = (run_sim.run(parser.parse_args(argv + ["--device", d])) for d in ("cuda", "cpu"))
    for summary in (card, cpu):
        summary.pop("epoch_rebuild_seconds_total", None)
    assert card == cpu


def _ckpt_swarm(dev, n=4000):
    """A churned Chung-Lu swarm after 6 rounds on ``dev``, and its config."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core import topology as tt
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim import engine

    deg = tt.powerlaw_degree_sequence(n, rng=np.random.default_rng(3))
    g = tt.build_csr(n, tt.configuration_model(deg, rng=np.random.default_rng(4)))
    cfg = SwarmConfig(n_peers=n, msg_slots=16, mode="push_pull", fanout=1, **CHURN)
    st = init_swarm(g, cfg, key=prng.key(1, dev), origins=[0, 7, 99], device=dev)
    return cfg, engine.simulate(st, cfg, 6)[0]


def _save_load(form, st, tmp_path, to):
    from tpu_gossip_torch.ckpt import load_checkpoint, save_checkpoint
    from tpu_gossip_torch.core.packed import pack_state
    from tpu_gossip_torch.core.state import load_swarm, save_swarm

    if form == "flat npz":
        save_swarm(tmp_path / "st.npz", st)
        return load_swarm(tmp_path / "st.npz", device=to)
    save_checkpoint(tmp_path, pack_state(st) if form == "packed checkpoint" else st, step=6, shards=3)
    return load_checkpoint(tmp_path / "ckpt-00000006", device=to)[0]


@pytest.mark.parametrize("form", ["checkpoint", "packed checkpoint", "flat npz"])
@pytest.mark.parametrize("written_on", ["cuda", "cpu"])
def test_checkpoint_crosses_card_and_cpu_leaf_equal(dev, tmp_path, form, written_on):
    """A state saved from the card loads onto the CPU leaf for leaf, and the
    reverse; both copies then run on to equal digests, each on its device."""
    from tpu_gossip_torch.convert import to_numpy
    from tpu_gossip_torch.sim import engine
    from tpu_gossip_torch.utils.digest import state_digest

    other = "cpu" if written_on == "cuda" else "cuda"
    cfg, st = _ckpt_swarm(torch.device(written_on))
    back = _save_load(form, st, tmp_path, other)
    assert back.seen.device.type == other
    want, got = to_numpy(st), to_numpy(back)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and np.array_equal(got[name], arr), name
    fin_a, stats_a = engine.simulate(st, cfg, 4)
    fin_b, stats_b = engine.simulate(back, cfg, 4)
    assert state_digest(fin_a) == state_digest(fin_b)


# the fault plane: each path's launches over R rounds, P of them partitioned (side B's second delivery)
FAULT_PATHS = {
    "matching": lambda r, p: {"fold_planes_or": r + p, "round_tail": r, "round_tail_words": 0},
    "packed matching": lambda r, p: {"fold_planes_or": r + p, "round_tail": 0, "round_tail_words": r},
    "staircase": lambda r, p: {"staircase_segment": r + p, "round_tail": r, "fold_planes_or": 0},
    "exactly-k": lambda r, p: {"staircase_segment": 0, "round_tail": r, "fold_planes_or": 0},
    "sharded staircase": lambda r, p: {"stream_segment": r + p, "round_tail": r},
    "sharded scatter": lambda r, p: {"stream_segment": 0, "round_tail": r},
    "sharded packed": lambda r, p: {"stream_segment": r + p, "round_tail": 0, "round_tail_words": r},
}


@pytest.mark.parametrize("argv,path,partitioned", [
    (["--graph", "matching", "--scenario", "scenarios/split_brain.toml"], "matching", 16),
    (["--graph", "matching", "--packed", "--scenario", "scenarios/lossy_links.toml"], "packed matching", 0),
    (["--graph", "matching", "--silent-frac", "0.1", "--scenario", "scenarios/rack_failure.toml"], "matching", 0),
    (["--graph", "chung-lu", "--staircase", "--scenario", "scenarios/split_brain.toml"], "staircase", 16),
    (["--graph", "chung-lu", "--scenario", "scenarios/churn_storm.toml", "--churn-leave", "0.002", "--churn-join",
      "0.02", "--rewire-slots", "2"], "exactly-k", 0),
    (["--graph", "chung-lu", "--shard", "--staircase", "--scenario", "scenarios/rack_failure.toml"],
     "sharded staircase", 0),
    (["--graph", "chung-lu", "--shard", "--scenario", "scenarios/split_brain.toml"], "sharded scatter", 16),
    (["--graph", "chung-lu", "--shard", "--staircase", "--packed", "--scenario", "scenarios/lossy_links.toml"],
     "sharded packed", 0),
])
def test_fault_digest_on_card_equals_cpu(dev, argv, path, partitioned):
    """Each fault path at n=20000 on the card equals its CPU run (summary,
    phase report and digests), with the card run's launches counted."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    argv = ["--peers", "20000", "--rounds", "32", "--digest", "--quiet", "--mode", "push_pull", "--fanout", "1", *argv]
    parser = run_sim.build_parser()
    reset_launches()
    card = run_sim.run(parser.parse_args(argv + ["--device", "cuda"]))
    launches = dict(LAUNCHES)
    assert card == run_sim.run(parser.parse_args(argv + ["--device", "cpu"]))
    assert card["phases"]
    for key, n in FAULT_PATHS[path](32, partitioned).items():
        assert launches[key] == n, (key, launches)


# the quorum detector under the byzantine siege (56 rounds, no partition)
@pytest.mark.parametrize("argv,path", [
    (["--graph", "matching"], "matching"),
    (["--graph", "matching", "--quorum-k", "1"], "matching"),
    (["--graph", "matching", "--packed"], "packed matching"),
    (["--graph", "chung-lu", "--staircase"], "staircase"),
    (["--graph", "chung-lu", "--churn-leave", "0.002", "--churn-join", "0.02", "--rewire-slots", "2",
      "--rewire-compact-cap", "4096"], "exactly-k"),
    (["--graph", "chung-lu", "--shard", "--staircase"], "sharded staircase"),
    (["--graph", "chung-lu", "--shard"], "sharded scatter"),
    (["--graph", "chung-lu", "--shard", "--staircase", "--packed"], "sharded packed"),
])
def test_quorum_digest_on_card_equals_cpu(dev, argv, path):
    """The siege at quorum 3 (or 1) on each path at n=20000: the card run
    equals the CPU run (summary, ``liveness`` and ``phases`` blocks,
    digests), its launches counted."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    argv = ["--peers", "20000", "--rounds", "56", "--digest", "--quiet", "--mode", "push_pull", "--fanout", "1",
            "--scenario", "scenarios/byzantine_siege.toml", "--quorum-k", "3", *argv]
    parser = run_sim.build_parser()

    def run(device):
        args = parser.parse_args(argv + ["--device", device])
        assert run_sim._validate_liveness(args, run_sim._scenario_spec(args)) is None
        return run_sim.run(args)

    reset_launches()
    card = run("cuda")
    launches = dict(LAUNCHES)
    assert card == run("cpu")
    assert card["liveness"]["accusations"] > 0 and card["phases"]
    for key, n in FAULT_PATHS[path](56, 0).items():
        assert launches[key] == n, (key, launches)


def test_quorum_stages_on_card_equal_cpu(dev):
    """The detector's and the flood's scatters at 1M rows on the card give
    the CPU's bits (every scatter is order-free)."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict
    from tpu_gossip_torch.faults.inject import flood_replay
    from tpu_gossip_torch.kernels import liveness as lv

    n, rnd = 1_000_001, 20
    g = np.random.default_rng(0)
    planes = {
        "last_hb": (rnd - g.integers(0, 13, n)).astype(np.int16), "alive": g.random(n) < 0.85,
        "silent": g.random(n) < 0.2, "declared_dead": g.random(n) < 0.1,
        "suspect_round": np.where(g.random(n) < 0.35, rnd - g.integers(0, 9, n), -1).astype(np.int16),
        "suspect_mark": (g.integers(0, 4, n) + 256 * g.integers(0, 4, n)).astype(np.int16),
        "quarantine": g.random(n) < 0.05, "exists": g.random(n) < 0.97,
    }
    accuser, forger = g.random(n) < 0.05, g.random(n) < 0.03
    seen = g.random((n, 16)) < 0.5
    sc_spec = scenario_from_dict({"phases": [{"start": 0, "end": 4, "floods": {"frac": 0.05, "seed": 5},
                                              "flood_fanout": 3, "blackout": {"frac": 0.1, "seed": 2}}]})

    def run(device):
        t = {k: torch.from_numpy(v).to(device) for k, v in planes.items()}
        r = torch.tensor(rnd, dtype=torch.int32, device=device)
        last, forged = lv.forge_heartbeats(t["last_hb"], t["suspect_round"], torch.from_numpy(forger).to(device), r,
                                           prng.key(8, device), torch.tensor(2, device=device), 2)
        out = lv.quorum_liveness(lv.compile_quorum(3, window=4, budget=2), last, t["alive"], t["silent"],
                                 t["declared_dead"], t["suspect_round"], t["suspect_mark"], t["quarantine"],
                                 t["exists"], r, 6, 2, k_accuse=prng.key(5, device),
                                 accuser_ok=torch.from_numpy(accuser).to(device))
        sc = compile_scenario(sc_spec, n_peers=n, n_slots=n, total_rounds=8, device=device)
        rf = sc.at_round(2)
        replay, bill = flood_replay(sc, rf, torch.from_numpy(seen).to(device), rf.flooder & ~rf.blackout,
                                    prng.key(4, device))
        return {**{k: v.cpu() for k, v in out.items()}, "forged": forged.cpu(), "replay": replay.cpu(),
                "bill": bill.cpu()}

    card, cpu = run("cuda"), run("cpu")
    for k in cpu:
        assert torch.equal(card[k], cpu[k]), k
    assert int(card["adv_accusations"]) > 0 and bool(card["newly_quarantined"].any()) and int(card["bill"]) > 0


def test_gumbel_table_and_log_on_card_equal_cpu(dev):
    """XLA's float32 ``log`` (``prng.xla_log``) over every input the
    Gumbel draw can feed it, and the 2^23-entry Gumbel table, are the
    CPU's bits on the card (plain float64 arithmetic rounds alike)."""
    from tpu_gossip_torch.core import prng

    j = torch.arange(1, 1 << 23, dtype=torch.int32)
    u = (j | 0x3F800000).view(torch.float32) - 1.0
    for x in (u, -prng.xla_log(u), torch.arange(1, 1 << 24, dtype=torch.float32)):
        assert torch.equal(prng.xla_log(x.to(dev)).cpu(), prng.xla_log(x))
    assert torch.equal(prng.gumbel_table(dev).cpu(), prng.gumbel_table("cpu"))


@pytest.mark.parametrize("rows,chunk", [(3, None), (256, None), (256, 7), (17, 1)])
def test_gumbel_top_k_on_card_equals_cpu_at_1m_columns(dev, rows, chunk):
    """The admission draw's Gumbel-top-k at 1M columns, ties seeded in
    (equal log degrees) and -inf columns: the card's targets and
    finiteness equal the CPU's, and any chunking equals the whole draw."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.growth.engine import gumbel_top_k

    n = 1_000_001
    g = np.random.default_rng(rows)
    deg = g.integers(1, 6, n).astype(np.float32)
    log_deg = torch.from_numpy(np.where(g.random(n) < 0.1, -np.inf, np.log(deg)).astype(np.float32))
    cpu = gumbel_top_k(prng.key(rows, "cpu"), log_deg, rows, 3, chunk)
    card = gumbel_top_k(prng.key(rows, dev), log_deg.to(dev), rows, 3, chunk)
    whole = gumbel_top_k(prng.key(rows, dev), log_deg.to(dev), rows, 3, rows)
    for a, b, c in zip(card, cpu, whole):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


@pytest.mark.parametrize("argv,path", [
    (["--graph", "matching"], "matching"),
    (["--graph", "matching", "--packed"], "packed matching"),
    (["--graph", "chung-lu", "--staircase", "--remat-every", "8"], "staircase"),
    (["--graph", "pa", "--churn-leave", "0.002", "--churn-join", "0.02", "--rewire-slots", "2", "--grow-rate", "64"],
     "exactly-k"),
    (["--graph", "chung-lu", "--shard", "--staircase"], "sharded staircase"),
    (["--graph", "chung-lu", "--shard", "--packed"], "sharded packed scatter"),
    (["--graph", "matching", "--scenario", "scenarios/flash_crowd_under_fire.toml"], "matching"),
])
def test_growth_digest_on_card_equals_cpu(dev, argv, path):
    """A growing run (n=20000 to 24000, 24 rounds) on each engine: the card
    equals the CPU (summary, membership, gamma, digests), the card run's
    launches counted."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    argv = ["--peers", "20000", "--grow", "24000", "--rounds", "24", "--digest", "--quiet", "--mode", "push_pull",
            "--fanout", "1", *argv]
    parser = run_sim.build_parser()

    def run(device):
        args = parser.parse_args(argv + ["--device", device])
        assert run_sim.validate(args) is None
        return run_sim.run(args)

    reset_launches()
    card = run("cuda")
    launches = dict(LAUNCHES)
    assert card == run("cpu")
    assert card["n_members"] > 20000
    paths = {**FAULT_PATHS, "sharded packed scatter": lambda r, p: {"stream_segment": 0, "round_tail": 0,
                                                                     "round_tail_words": r}}
    for key, n in paths[path](24, 0).items():
        assert launches[key] == n, (key, launches)


def test_poisson_and_lgamma32_on_card_equal_cpu(dev):
    """The stream's count on the card: ``prng.poisson`` over both branches
    and ``lgamma32`` over the integers 1..2^24 give the CPU's bits."""
    from tpu_gossip_torch.core import prng

    x = torch.arange(1, (1 << 24) + 1, dtype=torch.float32)
    for lo in range(0, x.numel(), 1 << 22):
        chunk = x[lo:lo + (1 << 22)]
        assert torch.equal(prng.lgamma32(chunk.to(dev)).cpu().view(torch.int32), prng.lgamma32(chunk).view(torch.int32))
    keys = torch.from_numpy(np.random.default_rng(0).integers(0, 2 ** 32, size=(4096, 2), dtype=np.uint64)
                            .astype(np.int64))
    for rate in (0.5, 4.0, 9.999999, 10.0, 16.0, 400.0):
        lam = torch.full((4096,), rate, dtype=torch.float32)
        assert torch.equal(prng.poisson(keys.to(dev), lam.to(dev)).cpu(), prng.poisson(keys, lam))


def _streamed(dev, rounds=30):
    """A loaded state on the card (n=20000 exactly-k push_pull, rate 4,
    TTL 20) one round before an age-out, and that round's expired mask."""
    from tpu_gossip_torch.core import prng, topology
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim import engine
    from tpu_gossip_torch.traffic import compile_stream, slot_expiry

    n = 20000
    g = topology.build_csr(n, topology.configuration_model(
        topology.powerlaw_degree_sequence(n, 2.5, rng=np.random.default_rng(0)), rng=np.random.default_rng(1)))
    cfg = SwarmConfig(n_peers=n, msg_slots=16, fanout=1, mode="push_pull")
    st = init_swarm(g, cfg, key=prng.key(0, dev), origins=[0], device=dev)
    strm = compile_stream(rate=4.0, msg_slots=16, ttl=20, origin_rows=np.arange(n), device=dev)
    st, _ = engine.simulate(st, cfg, rounds, stream=strm)
    for _ in range(20):
        expired = slot_expiry(st.slot_lease, st.round + 1, strm.ttl)
        if bool(expired.any()):
            return cfg, st, expired
        st, _ = engine.gossip_round(st, cfg, stream=strm)
    raise AssertionError("no lease aged out in 20 rounds")


@pytest.mark.parametrize("fo,sir", [(False, 0), (True, 4)])
def test_tail_kernels_with_a_live_age_out_mask_equal_plain(dev, fo, sir):
    """K3 and K4 with the expired mask a stream's age-out produces, on the
    loaded state it produced it for: the recycled columns come out clear."""
    from tpu_gossip_torch.core.packed import pack_bits
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.round_tail import round_tail, round_tail_words, tail_fused, tail_words_plain
    from tpu_gossip_torch.sim import engine

    cfg, st, expired = _streamed(dev)
    _, transmitter, receptive = engine.compute_roles(st)
    transmit = engine.transmit_bitmap(st, cfg, transmitter)
    planes = (st.seen, st.forwarded, st.infected_round, st.recovered, st.seen, receptive, transmit, None,
              st.round + 1)
    kw = dict(forward_once=fo, sir_recover_rounds=sir, expired=expired)
    before = LAUNCHES["round_tail"], LAUNCHES["round_tail_words"]
    got = round_tail(*planes, impl="fused", **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, tail_fused(*planes, **kw)))
    words = [pack_bits(p) if p is not None and p.dtype == torch.bool and p.dim() == 2 else p for p in planes]
    got_w = round_tail_words(*words, m=16, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got_w, tail_words_plain(*words, m=16, age_saturated=False, **kw)))
    assert (LAUNCHES["round_tail"], LAUNCHES["round_tail_words"]) == (before[0] + 1, before[1] + 1)
    assert not bool(got[0][:, expired].any()) and bool((got[2][:, expired] == -1).all())


@pytest.mark.parametrize("argv,path", [
    (["--graph", "matching"], "matching"),
    (["--graph", "matching", "--packed", "--stream-origins", "hotspot"], "packed matching"),
    (["--graph", "chung-lu", "--staircase", "--stream-burst-every", "3"], "staircase"),
    (["--graph", "chung-lu", "--stream-origins", "degree", "--stream-hashes", "2"], "exactly-k"),
    (["--graph", "chung-lu", "--shard", "--staircase"], "sharded staircase"),
    (["--graph", "chung-lu", "--staircase", "--remat-every", "8", "--churn-leave", "0.002", "--churn-join", "0.02",
      "--rewire-slots", "2"], "staircase"),
])
def test_stream_digest_on_card_equals_cpu(dev, argv, path):
    """A loaded run (n=20000, rate 4, TTL 20, 32 rounds) on each engine:
    the card equals the CPU (summary, the stream block, digests), the card
    run launching its path's kernels and K3 or K4 once a round."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    argv = ["--peers", "20000", "--stream", "4", "--slot-ttl", "20", "--rounds", "32", "--digest", "--quiet",
            "--mode", "push_pull", "--fanout", "1", *argv]
    parser = run_sim.build_parser()

    def run(device):
        args = parser.parse_args(argv + ["--device", device])
        assert run_sim.validate(args) is None
        return run_sim.run(args)

    reset_launches()
    card = run("cuda")
    launches = dict(LAUNCHES)
    assert card == run("cpu")
    assert card["stream"]["msgs_expired"] > 0
    for key, n in FAULT_PATHS[path](32, 0).items():
        assert launches[key] == n, (key, launches)


@pytest.mark.parametrize("fanout", [1, 3, 8])
def test_controlled_segment_sampled_on_card_equals_cpu(dev, fanout):
    """K5's wrapper under the controller on the card, every effective
    fanout from 1 to twice the plan's (the scaled thresholds, the pull gate
    and the needy rows): the CPU's delivery and bill, one K5 launch a
    call."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core import topology as tt
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan, segment_sampled

    deg = tt.powerlaw_degree_sequence(20000, rng=np.random.default_rng(fanout))
    g = tt.build_csr(20000, tt.configuration_model(deg, rng=np.random.default_rng(1)))
    plans = {d: build_staircase_plan(g.row_ptr, g.col_idx, fanout=fanout, device=d) for d in ("cpu", dev)}
    rng = np.random.default_rng(fanout)
    tx = torch.from_numpy(rng.random((g.n, 16)) < 0.3)
    rec = torch.from_numpy(rng.random(g.n) < 0.9)
    needy = torch.from_numpy(rng.random(g.n) < 0.6)
    for m_eff in range(1, 2 * fanout + 1):
        out = {}
        for d in ("cpu", dev):
            before = LAUNCHES["staircase_segment"]
            out[str(d)] = segment_sampled(
                plans[d], tx.to(d), None, 16, prng.key(m_eff, d), receptive_rows=rec.to(d), do_push=True,
                do_pull=True, fanout=torch.tensor(m_eff, dtype=torch.int32, device=d),
                pull_gate=torch.tensor(bool(m_eff % 2), device=d), pull_needy_rows=needy.to(d))
            assert LAUNCHES["staircase_segment"] == before + (0 if d == "cpu" else 1)
        (ci, cm), (gi, gm) = out["cpu"], out[str(dev)]
        assert torch.equal(ci, gi.cpu()) and int(cm) == int(gm) > 0, m_eff


@pytest.mark.parametrize("kind", ["push_pull", "push", "pull"])
def test_controlled_bucketed_exchange_on_card_equals_cpu(dev, kind):
    """The bucketed exchange with the controller's decision (the effective
    fanout in the push law, the pull gate, the needy rows on the merged
    wire) on the card through K6, against the CPU's scatter receive."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.control import RoundControl
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.dist import mesh as dm

    sg, plans = _shard_plans(dev, "chung_lu", 4)
    cpu_sg = dataclasses.replace(sg, **{f.name: getattr(sg, f.name).cpu() for f in dataclasses.fields(sg)
                                        if isinstance(getattr(sg, f.name), torch.Tensor)})
    g = _gen(dev, 7)
    transmit = torch.rand((sg.n_pad, 16), generator=g, device=dev) < 0.3
    blocked = torch.rand((sg.n_pad,), generator=g, device=dev) < 0.1
    needy = torch.rand((sg.n_pad,), generator=g, device=dev) < 0.5
    for m_eff, gate in ((1, True), (3, False), (6, True)):
        out = {}
        for d, graph, plan in ((dev, sg, plans), ("cpu", cpu_sg, None)):
            rc = RoundControl(m_eff=torch.tensor(m_eff, dtype=torch.int32, device=d),
                              pull_on=torch.tensor(gate, device=d), lvl=torch.tensor(0, dtype=torch.int32, device=d),
                              width=6, needy=needy.to(d))
            keys = prng.split(prng.key(3, d), 4)
            out[str(d)] = dm._exchange((transmit & ~blocked[:, None]).to(d), graph, keys, kind, 2, plan,
                                       blocked.to(d), rc)
        (gi, gm), (ci, cm) = out[str(dev)], out["cpu"]
        assert torch.equal(gi.cpu(), ci) and int(gm) == int(cm), (kind, m_eff)
        # a closed pull gate ships nothing on the pull wire
        assert (int(gm) > 0) == (kind != "pull" or gate), (kind, m_eff)
    assert isinstance(dist.make_mesh(1, device=dev), dist.Mesh)


@pytest.mark.parametrize("argv,path", [
    (["--graph", "matching", "--fanout", "1", "--control", "0.99"], "matching"),
    (["--graph", "matching", "--fanout", "1", "--packed", "--control", "0.99"], "packed matching"),
    (["--graph", "chung-lu", "--staircase", "--fanout", "3", "--control-bounds", "1,6", "--control", "0.99"],
     "staircase"),
    (["--graph", "chung-lu", "--fanout", "3", "--churn-leave", "0.01", "--churn-join", "0.05", "--rewire-slots", "6",
      "--refresh-every", "4", "--control", "0.9"], "exactly-k"),
    (["--graph", "chung-lu", "--shard", "--staircase", "--fanout", "2", "--control", "0.9"], "sharded staircase"),
])
def test_control_digest_on_card_equals_cpu(dev, argv, path):
    """A controlled run (n=20000, 32 rounds) on each engine: the card equals
    the CPU (summary, the control and reliability blocks, digests), the
    card run launching its path's kernels and K3 or K4 once a round."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    argv = ["--peers", "20000", "--rounds", "32", "--digest", "--quiet", "--mode", "push_pull", *argv]
    parser = run_sim.build_parser()

    def run(device):
        args = parser.parse_args(argv + ["--device", device])
        assert run_sim.validate(args) is None
        return run_sim.run(args)

    reset_launches()
    card = run("cuda")
    launches = dict(LAUNCHES)
    assert card == run("cpu")
    assert card["reliability"]["messages_judged"] == 1
    for key, n in FAULT_PATHS[path](32, 0).items():
        assert launches[key] == n, (key, launches)


@pytest.mark.parametrize("extra,tail", [
    (["--staircase"], "round_tail"),
    (["--packed"], "round_tail_words"),
    (["--staircase", "--stream", "2", "--slot-ttl", "20"], "round_tail"),
])
def test_pipelined_digest_on_card_equals_cpu(dev, extra, tail):
    """A pipelined run on the one-process bucketed mesh (n=20000, 24
    rounds): the card equals the CPU (summary and digests), launching its
    tail kernel once a round and K6 once a round with ``--staircase``."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    argv = ["--peers", "20000", "--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--shard",
            "--pipeline", "1", "--rounds", "24", "--digest", "--quiet", *extra]
    parser = run_sim.build_parser()

    def run(device):
        args = parser.parse_args(argv + ["--device", device])
        assert run_sim.validate(args) is None
        return run_sim.run(args)

    reset_launches()
    card = run("cuda")
    launches = dict(LAUNCHES)
    assert card == run("cpu") and card["pipeline"] == 1
    assert launches[tail] == 24 and launches["stream_segment"] == (24 if "--staircase" in extra else 0)


def test_fleet_lanes_on_card_equal_cpu(dev, tmp_path):
    """A 4-lane campaign (a loss sweep, a stream, the controller) run on
    the card and on the CPU: every lane's digests equal, K3 once a
    lane-round."""
    from tpu_gossip_torch import fleet
    from tpu_gossip_torch.core.state import lane_state
    from tpu_gossip_torch.kernels.native import LAUNCHES, reset_launches

    (tmp_path / "lossy.toml").write_text("[scenario]\nname = \"lossy\"\n[[phase]]\nname = \"lossy\"\nstart = 0\n"
                                         "end = 6\nloss = 0.2\ndelay = 0.1\n")
    spec = fleet.campaign_from_dict({
        "name": "card", "seed": 1,
        "base": {"peers": 64, "rounds": 12, "slots": 4, "fanout": 2, "mode": "push_pull", "stream_rate": 1.0,
                 "slot_ttl": 10, "control": 0.9, "control_hi": 3, "rewire_slots": 3, "churn_join": 0.02},
        "families": [{"name": "lossy", "scenario": str(tmp_path / "lossy.toml"), "seeds": 4,
                      "sweeps": [{"axis": "phase.loss", "dist": "uniform", "lo": 0.05, "hi": 0.3}]}]})
    digests = {}
    for device in ("cuda", "cpu"):
        camp = fleet.compile_campaign(spec, device=device)
        reset_launches()
        fin, stats = fleet.run_campaign(camp)
        if device == "cuda":
            assert LAUNCHES["round_tail"] == camp.k * camp.rounds
        digests[device] = [(fleet.state_digest(lane_state(fin, k)), fleet.stats_digest(stats, k))
                           for k in range(camp.k)]
    assert digests["cuda"] == digests["cpu"]


@pytest.mark.parametrize("s", [1, 2, 8])
@pytest.mark.parametrize("transport", ["dense", "sparse", "packed"])
def test_matching_mesh_on_card_equals_cpu(dev, s, transport):
    """The sharded matching engine on one card equals its CPU run (the
    plain kernels) and the card's local round on the same plan; a round
    launches K1 2K+1 times (lane stages only), K2 and K3 (K4 packed)
    once."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.packed import pack_state, unpack_state
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim.engine import simulate
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    rounds, out = 6, {}
    for d in (dev, torch.device("cpu")):
        g, plan = matching_powerlaw_graph_sharded(20000, s, fanout=1, key=prng.key(2, d), device=d)
        mesh = dist.make_mesh(s, device=d)
        cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull")
        st = init_swarm(g.as_padded_graph(), cfg, origins=[0, 7], exists=g.exists, key=prng.key(1, d), device=d)
        pm = dist.shard_matching_plan(plan, mesh)
        tr = None if transport == "dense" else dist.build_transport(pm, "sparse", mesh=mesh)
        native.reset_launches()
        fin, stats = dist.simulate_dist(pack_state(st) if transport == "packed" else st, cfg, pm, mesh, rounds,
                                        transport=tr)
        launches, k1 = dict(native.LAUNCHES), dict(native.K1_ENTRIES)
        fin = unpack_state(fin) if transport == "packed" else fin
        lfin, lstats = simulate(st, cfg, rounds, plan)
        out[d.type] = (state_digest(fin), stats_digest(stats), state_digest(lfin), stats_digest(lstats), launches,
                       k1, sum(1 for st_ in plan.stages if st_[0] == "lane"))
    assert out["cuda"][:2] == out["cpu"][:2] == out["cuda"][2:4]
    launches, k1, lanes = out["cuda"][4:]
    assert launches["lane_shuffle"] == k1["lane_shuffle"] == lanes * rounds  # no fused entry on the mesh
    assert launches["fold_planes_or"] == rounds
    assert launches["round_tail" if transport != "packed" else "round_tail_words"] == rounds


def test_sparse_transposes_on_card_equal_dense(dev):
    """The compact lanes of the matching transposes on the card rebuild the
    dense lanes' blocks (hub rows and leaf rows, sentinels included)."""
    from tpu_gossip_torch.dist import transport as tt
    from tpu_gossip_torch.kernels import permute

    g = _gen(dev, 3)
    s, per, h, cap = 8, 64, 4, 10
    hub = torch.stack([torch.randperm(per, generator=g, device=dev)[:h] for _ in range(s)]).to(torch.int32)
    x = torch.zeros((s, per, 128), dtype=torch.int32, device=dev)
    for i in range(s):
        rows = torch.randperm(per, generator=g, device=dev)[:cap]
        x[i, rows, 3] = i + 1
        x[i, hub[i].long()] = 9
    assert torch.equal(tt.transpose_pass_sparse(x, s, hub, cap), permute.transpose_pass_sharded(x, s))
    assert torch.equal(tt.untranspose_pass_sparse(x * 0, s, hub[:, :0], cap), permute.untranspose_pass_sharded(
        x * 0, s))


@pytest.mark.parametrize("kw", [dict(msg_slots=16, fanout=3), dict(msg_slots=32, fanout=2, mode="push_pull",
                                                                    dedup_hashes=3)])
def test_simcluster_on_card_equals_cpu(dev, kw):
    """A small ``SimCluster`` script (silent before and after
    ``materialize``, three messages, a kill, two steps) gives the same
    digests, coverages and verdicts on the card as on the CPU; each round
    launches K3 once and no other kernel."""
    from tpu_gossip_torch.compat.peer import PeerNode
    from tpu_gossip_torch.compat.simnet import SimCluster
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    out = {}
    for d in (dev, torch.device("cpu")):
        cluster = SimCluster(seed=3, device=d, **kw)
        peers = [PeerNode("10.0.0.1", 9000 + i, transport="tpu-sim", cluster=cluster) for i in range(1500)]
        peers[5].set_silent(True)
        cluster.materialize(m=3)
        peers[9].set_silent(True)
        for i, text in ((0, "a"), (700, "b"), (1499, "c")):
            peers[i].gossip(text)
        native.reset_launches()
        first = cluster.step(6)
        cluster.kill(peers[3].addr)
        second = cluster.step(10)
        launches = dict(native.LAUNCHES)
        out[d.type] = (state_digest(cluster.state), stats_digest(first), stats_digest(second),
                       [cluster.coverage(t) for t in "abc"], [cluster.is_declared_dead(peers[i].addr)
                                                              for i in (3, 5, 9, 10)], [peers[-1].has_seen(t)
                                                                                        for t in "abc"])
        if d.type == "cuda":
            assert launches.pop("round_tail") == 16 and not any(launches.values()), launches
    assert out["cuda"] == out["cpu"]
