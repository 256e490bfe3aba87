"""K1's fused entries and the stage pairing of ``apply_pipeline`` on the CPU
(their plain versions) against the JAX package's Pallas ``lane_shuffle``
run in interpret mode and its transposes, exactly; and K3's wrapper
dispatch on the CPU at the slot widths its vector path splits on."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import matching_topology as jmt
from tpu_gossip.kernels import permute as jperm
from tpu_gossip.kernels import round_tail as jtail
from tpu_gossip_torch.core import matching_topology as tmt
from tpu_gossip_torch.kernels import native
from tpu_gossip_torch.kernels import permute as tperm
from tpu_gossip_torch.kernels import round_tail as ttail
from tests.test_torch_kernels import _slots, _tables, _tail_inputs
from tests.test_torch_matching import _carried
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SHAPES = [(40, np.int32), (2056, np.int32), (96, np.int8), (2080, np.int8)]


@pytest.mark.parametrize("rows,dtype", SHAPES)
def test_lane_shuffle_t_equals_jax_shuffle_then_transpose(rows, dtype):
    x, idx = _slots(rows, rows + 7), _tables(rows, dtype, rows + 8)
    want = np.asarray(jperm.transpose_pass(jperm.lane_shuffle(jnp.asarray(x), jnp.asarray(idx))))
    got = tperm.lane_shuffle_t(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("rows,dtype", SHAPES)
def test_tinv_lane_shuffle_equals_jax_untranspose_then_shuffle(rows, dtype):
    x, idx = _slots(rows, rows + 9), _tables(rows, dtype, rows + 10)
    want = np.asarray(jperm.lane_shuffle(jperm.untranspose_pass(jnp.asarray(x)), jnp.asarray(idx)))
    got = tperm.tinv_lane_shuffle(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("entry", [tperm.lane_shuffle_t, tperm.tinv_lane_shuffle])
@pytest.mark.parametrize("rows,dtype", [(44, np.int32), (40, np.int8)])
def test_fused_entries_reject_what_lane_shuffle_rejects(entry, rows, dtype):
    with pytest.raises(ValueError):
        entry(torch.from_numpy(_slots(rows, 0)), torch.from_numpy(_tables(rows, dtype, 1)))


@pytest.mark.parametrize("entry", [tperm.lane_shuffle_t, tperm.tinv_lane_shuffle])
def test_fused_entries_never_fall_back_off_cpu(entry):
    x = torch.empty((32, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        entry(x, torch.empty((32, 128), dtype=torch.int8, device="meta"))


def _kinds(stages):
    return [s[0] for s in stages]


@pytest.mark.parametrize("n_stages,before,after", [(3, 13, 7), (2, 9, 5)])
def test_fuse_stages_pairs_every_shuffle_with_its_transpose(n_stages, before, after):
    tabs = tuple(torch.full((8, 128), i, dtype=torch.int32) for i in range(n_stages))
    inv = tuple(torch.full((8, 128), 10 + i, dtype=torch.int32) for i in range(n_stages))
    m3 = torch.full((8, 128), 99, dtype=torch.int32)
    stages = tmt.pipeline_stages(tabs, m3, inv)
    fused = tperm.fuse_stages(stages)
    assert len(stages) == before and len(fused) == after
    assert _kinds(fused) == ["lane_t"] * n_stages + ["lane"] + ["tinv_lane"] * n_stages
    want_tabs = [*tabs, m3, *reversed(inv)]
    assert all(s[1] is t for s, t in zip(fused, want_tabs))
    assert tperm.fuse_stages(fused) == fused


def test_fuse_stages_keeps_an_unpaired_transpose():
    t = torch.zeros((8, 128), dtype=torch.int32)
    stages = (("t",), ("lane", t), ("tinv",), ("tinv",), ("lane", t), ("lane", t), ("t",), ("t",))
    assert _kinds(tperm.fuse_stages(stages)) == ["t", "lane", "tinv", "tinv_lane", "lane_t", "t"]


@pytest.mark.parametrize("rows,dtype", [(96, np.int8), (40, np.int32)])
def test_three_stage_pipeline_equals_jax(rows, dtype):
    x = _slots(rows, 5)
    tabs = [_tables(rows, dtype, 20 + s) for s in range(3)]
    inv = [np.argsort(t, axis=1, kind="stable").astype(dtype) for t in tabs]
    m3 = _tables(rows, dtype, 30)
    j_stages = jmt.pipeline_stages(tuple(map(jnp.asarray, tabs)), jnp.asarray(m3), tuple(map(jnp.asarray, inv)))
    t_stages = tmt.pipeline_stages(tuple(map(torch.from_numpy, tabs)), torch.from_numpy(m3),
                                   tuple(map(torch.from_numpy, inv)))
    want = np.asarray(jperm.apply_pipeline(jnp.asarray(x), j_stages))
    np.testing.assert_array_equal(want, tperm.apply_pipeline(torch.from_numpy(x), t_stages).numpy())


@pytest.fixture(scope="module")
def jax_plan():
    _, jp = jmt.matching_powerlaw_graph(2000, fanout=1, key=jax.random.key(0))
    return jp


def test_partner_pass_runs_fused_shuffles_only(jax_plan, monkeypatch):
    """A pass of a K-stage plan equals JAX's pass, makes 2K+1 shuffle
    calls, K of each fused kind, and takes no transpose branch of its own."""
    tp = _carried(jax_plan)
    calls = []
    for kind, fn in list(tperm._STAGE_OPS.items()):
        monkeypatch.setitem(tperm._STAGE_OPS, kind, lambda x, t, kind=kind, fn=fn: calls.append(kind) or fn(x, t))
    x = torch.from_numpy(_slots(tp.rows, 12))
    want = np.asarray(jax_plan.partner(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(want, tp.partner(x).numpy())
    k = len(tp.lanes)
    assert len(tp.stages) == 4 * k + 1
    assert calls == ["lane_t"] * k + ["lane"] + ["tinv_lane"] * k


TAIL_NAMES = ("seen", "forwarded", "infected_round", "recovered", "incoming", "receptive", "transmit")


@pytest.mark.parametrize("m", [1, 3, 16, 32])
@pytest.mark.parametrize("forward_once,sir,use_fresh,use_expired",
                         list(itertools.product([False, True], [0, 4], [False, True], [False, True]))[::3])
def test_tail_kernel_on_cpu_equals_jax_pallas_tail(m, forward_once, sir, use_fresh, use_expired):
    """K3's wrapper on CPU tensors takes its plain version, launches
    nothing, and equals JAX's Pallas tail at odd row counts."""
    n, rnd = 301, 9
    ops = _tail_inputs(n, m, m * 100 + sir, rnd)
    fresh = ops["fresh"] if use_fresh else None
    expired = ops["expired"] if use_expired else None
    kw = dict(forward_once=forward_once, sir_recover_rounds=sir)
    want = jtail.tail_pallas(*[jnp.asarray(ops[k]) for k in TAIL_NAMES],
                             None if fresh is None else jnp.asarray(fresh), jnp.asarray(rnd, jnp.int32),
                             expired=None if expired is None else jnp.asarray(expired), **kw)
    before = dict(native.LAUNCHES)
    got = ttail.tail_kernel(*[torch.from_numpy(ops[k]) for k in TAIL_NAMES],
                            None if fresh is None else torch.from_numpy(fresh), torch.tensor(rnd, dtype=torch.int32),
                            expired=None if expired is None else torch.from_numpy(expired), age_saturated=True, **kw)
    assert native.LAUNCHES == before
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
