"""The port's kernel modules on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode, exactly."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.kernels import permute as jperm
from tpu_gossip.kernels import round_tail as jtail
from tpu_gossip_torch.kernels import native
from tpu_gossip_torch.kernels import permute as tperm
from tpu_gossip_torch.kernels import round_tail as ttail
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _tables(rows, dtype, seed):
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((rows, 128)), axis=1).astype(dtype)


def _slots(rows, seed):
    return np.random.default_rng(seed).integers(-2**31, 2**31, (rows, 128)).astype(np.int32)


@pytest.mark.parametrize("rows,dtype", [(40, np.int32), (2056, np.int32), (96, np.int8), (2080, np.int8)])
def test_lane_shuffle_matches_pallas(rows, dtype):
    x, idx = _slots(rows, rows), _tables(rows, dtype, rows + 1)
    want = np.asarray(jperm.lane_shuffle(jnp.asarray(x), jnp.asarray(idx)))
    got = tperm.lane_shuffle(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        got, tperm.lane_shuffle_plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    )


@pytest.mark.parametrize("rows,dtype", [(44, np.int32), (40, np.int8)])
def test_lane_shuffle_rejects_what_jax_rejects(rows, dtype):
    x, idx = torch.from_numpy(_slots(rows, 0)), torch.from_numpy(_tables(rows, dtype, 1))
    with pytest.raises(ValueError):
        jperm.lane_shuffle(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()))
    with pytest.raises(ValueError):
        tperm.lane_shuffle(x, idx)


def test_kernel_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not computed by the plain version."""
    x = torch.empty((32, 128), dtype=torch.int32, device="meta")
    idx = torch.empty((32, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tperm.lane_shuffle(x, idx)
    with pytest.raises(ValueError):
        tperm.fold_planes(x, 0, 1024, 1000, 2, "or")
    b = torch.empty((4, 3), dtype=torch.bool, device="meta")
    ir = torch.empty((4, 3), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError):
        ttail.tail_kernel(b, b, ir, b, b, b, b, None, torch.tensor(1, device="meta"),
                          forward_once=False, sir_recover_rounds=0)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no kernel is launched (nor built)."""
    before = dict(native.LAUNCHES)
    x = torch.from_numpy(_slots(32, 0))
    tperm.lane_shuffle(x, torch.from_numpy(_tables(32, np.int8, 0)))
    tperm.fold_planes(x, 0, 1024, 1000, 2, "sum")
    assert native.LAUNCHES == before


@pytest.mark.parametrize("rows,dtype", [(80, np.int32), (832, np.int8)])
def test_transposes_inverse_tables_and_pipeline(rows, dtype):
    x = _slots(rows, 3)
    np.testing.assert_array_equal(
        np.asarray(jperm.transpose_pass(jnp.asarray(x))),
        tperm.transpose_pass(torch.from_numpy(x)).numpy(),
    )
    np.testing.assert_array_equal(
        np.asarray(jperm.untranspose_pass(jnp.asarray(x))),
        tperm.untranspose_pass(torch.from_numpy(x)).numpy(),
    )
    tabs = [_tables(rows, dtype, s) for s in range(3)]
    inv_j = [np.asarray(jperm.inverse_tables(jnp.asarray(t))) for t in tabs]
    inv_t = [tperm.inverse_tables(torch.from_numpy(t)).numpy() for t in tabs]
    for a, b in zip(inv_j, inv_t):
        np.testing.assert_array_equal(a, b)
    stages_j = (("lane", jnp.asarray(tabs[0])), ("t",), ("lane", jnp.asarray(tabs[1])),
                ("tinv",), ("lane", jnp.asarray(inv_j[2])))
    stages_t = (("lane", torch.from_numpy(tabs[0])), ("t",), ("lane", torch.from_numpy(tabs[1])),
                ("tinv",), ("lane", torch.from_numpy(inv_t[2])))
    np.testing.assert_array_equal(
        np.asarray(jperm.apply_pipeline(jnp.asarray(x), stages_j)),
        tperm.apply_pipeline(torch.from_numpy(x), stages_t).numpy(),
    )


FOLDS = [(0, 1024, 1000, 1), (1024, 2048, 2047, 3), (2048, 9216, 9115, 2), (0, 3072, 3072, 5)]


@pytest.mark.parametrize("op", ["or", "sum"])
@pytest.mark.parametrize("slot_off,cstride,count,pad_deg", FOLDS)
def test_fold_planes_matches_pallas(slot_off, cstride, count, pad_deg, op):
    slots = _slots(256, slot_off + cstride)
    want = np.asarray(jperm.fold_planes(jnp.asarray(slots), slot_off, cstride, count, pad_deg, op))
    got = tperm.fold_planes(torch.from_numpy(slots), slot_off, cstride, count, pad_deg, op).numpy()
    np.testing.assert_array_equal(want, got)


def test_fold_planes_rejects_unaligned():
    slots = torch.zeros((64, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tperm.fold_planes(slots, 512, 1024, 1000, 1)
    with pytest.raises(ValueError):
        tperm.fold_planes(slots, 0, 1024, 1000, 1, "max")


def _tail_inputs(n, m, seed, rnd):
    rng = np.random.default_rng(seed)
    b = lambda p: rng.random((n, m)) < p  # noqa: E731
    ir = np.where(b(0.5), rng.integers(-1, rnd, (n, m)), -1).astype(np.int16)
    return dict(
        seen=b(0.5), forwarded=b(0.3), infected_round=ir, recovered=b(0.2),
        incoming=b(0.4), receptive=b(0.8), transmit=b(0.5),
        fresh=rng.random(n) < 0.1, expired=rng.random(m) < 0.3,
    )


TAIL_FLAGS = list(itertools.product([False, True], [0, 4], [False, True], [False, True]))


@pytest.mark.parametrize("forward_once,sir,use_fresh,use_expired", TAIL_FLAGS)
def test_tail_matches_pallas_and_reference(forward_once, sir, use_fresh, use_expired):
    rnd = 9
    ops = _tail_inputs(300, 7, hash((forward_once, sir, use_fresh, use_expired)) % 1000, rnd)
    names = ("seen", "forwarded", "infected_round", "recovered", "incoming", "receptive", "transmit")
    fresh = ops["fresh"] if use_fresh else None
    expired = ops["expired"] if use_expired else None
    kw = dict(forward_once=forward_once, sir_recover_rounds=sir)
    j_args = [jnp.asarray(ops[k]) for k in names] + [None if fresh is None else jnp.asarray(fresh),
                                                     jnp.asarray(rnd, jnp.int32)]
    t_args = [torch.from_numpy(ops[k]) for k in names] + [
        None if fresh is None else torch.from_numpy(fresh), torch.tensor(rnd, dtype=torch.int32)]
    j_exp = None if expired is None else jnp.asarray(expired)
    t_exp = None if expired is None else torch.from_numpy(expired)
    want = jtail.tail_pallas(*j_args, expired=j_exp, **kw)
    want_ref = jtail.tail_reference(*j_args, expired=j_exp, **kw)
    for a, b in zip(want, want_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for impl in ttail.TAIL_IMPLS:
        got = ttail.round_tail(*t_args, expired=t_exp, impl=impl, **kw)
        for a, b in zip(want, got):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_tail_latch_saturates_past_round_cap():
    ops = _tail_inputs(64, 5, 0, 3)
    names = ("seen", "forwarded", "infected_round", "recovered", "incoming", "receptive", "transmit")
    rnd = 2**15 + 5
    kw = dict(forward_once=False, sir_recover_rounds=3)
    want = jtail.tail_fused(*[jnp.asarray(ops[k]) for k in names], None, jnp.asarray(rnd, jnp.int32), **kw)
    got = ttail.tail_fused(*[torch.from_numpy(ops[k]) for k in names], None,
                           torch.tensor(rnd, dtype=torch.int32), **kw)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_round_tail_dispatch_errors():
    ops = {k: torch.from_numpy(v) for k, v in _tail_inputs(8, 3, 0, 2).items()}
    args = (ops["seen"], ops["forwarded"], ops["infected_round"], ops["recovered"],
            ops["incoming"], ops["receptive"], ops["transmit"], None, torch.tensor(1))
    meta = [None if a is None else a.to("meta") for a in args]
    with pytest.raises(ValueError):  # the CPU oracle refuses a device tensor
        ttail.round_tail(*meta, forward_once=False, sir_recover_rounds=0, impl="reference")
    with pytest.raises(ValueError):
        ttail.round_tail(*args, forward_once=False, sir_recover_rounds=0, impl="bogus")
