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


def test_headline_digest_on_card_equals_cpu(dev):
    from tpu_gossip_torch.cli import run_sim

    argv = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "matching",
            "--rounds", "20", "--digest", "--quiet"]
    parser = run_sim.build_parser()
    on_card = run_sim.run(parser.parse_args(argv + ["--device", "cuda"]))
    on_cpu = run_sim.run(parser.parse_args(argv + ["--device", "cpu"]))
    assert on_card == on_cpu
    assert np.isfinite(on_card["final_coverage"])
