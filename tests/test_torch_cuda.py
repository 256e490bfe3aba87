"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these need an NVIDIA GPU with nvcc and skip without one.
Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda`` (the
suite's conftest imports JAX, which a GPU machine need not have).
"""

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


@pytest.mark.parametrize("rows,dtype", [(40, torch.int32), (2056, torch.int32), (96, torch.int8), (43424, torch.int8)])
def test_lane_shuffle_kernel_equals_plain(dev, rows, dtype):
    from tpu_gossip_torch.kernels.native import LAUNCHES
    from tpu_gossip_torch.kernels.permute import lane_shuffle, lane_shuffle_plain

    g = _gen(dev, rows)
    x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=g, device=dev, dtype=torch.int32)
    idx = torch.argsort(torch.rand((rows, 128), generator=g, device=dev), dim=1).to(dtype)
    before = LAUNCHES["lane_shuffle"]
    got = lane_shuffle(x, idx)
    assert LAUNCHES["lane_shuffle"] == before + 1
    assert torch.equal(got, lane_shuffle_plain(x, idx))


@pytest.mark.parametrize("op", ["or", "sum"])
@pytest.mark.parametrize("slot_off,cstride,count,pad_deg", [(0, 1024, 1000, 1), (2048, 9216, 9115, 2),
                                                              (0, 455680, 455670, 2)])
def test_fold_planes_kernel_equals_plain(dev, slot_off, cstride, count, pad_deg, op):
    from tpu_gossip_torch.kernels.permute import fold_planes, fold_planes_plain

    rows = -(-(slot_off + pad_deg * cstride) // 128)
    x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=_gen(dev, 1), device=dev, dtype=torch.int32)
    assert torch.equal(fold_planes(x, slot_off, cstride, count, pad_deg, op),
                       fold_planes_plain(x, slot_off, cstride, count, pad_deg, op))


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
