"""The port's matching plan build and delivery against the JAX package.

Every MatchingPlan leaf and the CSR equal JAX's at n=2000 (int32 tables,
node-major classes only) and n=20000 (int8 tables, one position-major
class, so the build's degree sum runs through fold_planes); delivery runs
on a JAX-built plan carried across by ``tpu_gossip_torch.convert``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_gossip.core import matching_topology as jmt
from tpu_gossip.kernels import matching as jmatch
from tpu_gossip_torch import convert
from tpu_gossip_torch.core import matching_topology as tmt
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.kernels import matching as tmatch
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SIZES = [2000, 20000]


@pytest.fixture(scope="module", params=SIZES, ids=[f"n{n}" for n in SIZES])
def built(request):
    n = request.param
    jg, jp = jmt.matching_powerlaw_graph(n, fanout=1, key=jax.random.key(0))
    tg, tp = tmt.matching_powerlaw_graph(n, fanout=1, key=prng.key(0, "cpu"), device="cpu")
    return n, (jg, jp), (tg, tp)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf", ["lanes", "lanes_inv", "m3", "valid", "deg_other", "deg_real"])
def test_plan_leaf_equals_jax(built, leaf):
    n, (_, jp), (_, tp) = built
    a, b = getattr(jp, leaf), getattr(tp, leaf)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        _eq(a, b)
    want_dt = np.int32 if n == 2000 else np.int8
    assert tp.m3.numpy().dtype == want_dt


@pytest.mark.parametrize("leaf", ["row_ptr", "col_idx", "exists"])
def test_csr_equals_jax(built, leaf):
    _, (jg, _), (tg, _) = built
    _eq(getattr(jg, leaf), getattr(tg, leaf))


def test_plan_statics_equal_jax(built):
    n, (jg, jp), (tg, tp) = built
    for f in ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk", "per_rows", "local_classes"):
        assert getattr(jp, f) == getattr(tp, f), f
    assert jg.n == tg.n == n
    has_fold = any(c[2] >= tmt._POS_MAJOR_MIN for c in tp.classes)
    assert has_fold == (n == 20000)


def test_csr_free_export_equals_jax():
    jg, jp = jmt.matching_powerlaw_graph(2000, fanout=1, key=jax.random.key(3), export_csr=False)
    tg, tp = tmt.matching_powerlaw_graph(2000, fanout=1, key=prng.key(3, "cpu"), export_csr=False,
                                         device="cpu")
    _eq(jg.row_ptr, tg.row_ptr)
    _eq(jg.col_idx, tg.col_idx)
    _eq(jp.valid, tp.valid)


def _carried(jp):
    leaves = {name: getattr(jp, name) for name in convert.PLAN_LEAVES}
    leaves = {k: [np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)
              for k, v in leaves.items()}
    static = {name: getattr(jp, name) for name in convert.PLAN_STATIC}
    return convert.plan_from_jax(leaves, static, device="cpu")


def test_plan_carried_across_round_trips(built):
    _, (_, jp), _ = built
    tp = _carried(jp)
    back = convert.to_numpy(tp)
    for name in convert.PLAN_LEAVES:
        a = getattr(jp, name)
        if isinstance(a, tuple):
            for x, y in zip(a, back[name]):
                _eq(x, torch.from_numpy(y))
        else:
            _eq(a, torch.from_numpy(back[name]))


@pytest.mark.parametrize("op", ["or", "sum"])
def test_expand_reduce_equal_jax(built, op):
    n, (_, jp), (_, tp) = built
    vals = np.random.default_rng(n).integers(0, 2**16, n).astype(np.int32)
    jx = jax.jit(lambda p, v: p.expand(v))(jp, jax.numpy.asarray(vals))
    _eq(jx, tp.expand(torch.from_numpy(vals)))
    slots = np.random.default_rng(n + 1).integers(-2**31, 2**31, (tp.rows, 128)).astype(np.int32)
    jr = jax.jit(lambda p, s: p.reduce(s, op))(jp, jax.numpy.asarray(slots))
    _eq(jr, tp.reduce(torch.from_numpy(slots), op))


def _rows(n_state, m, seed, p=0.3):
    return np.random.default_rng(seed).random((n_state, m)) < p


@pytest.mark.parametrize("mode", ["push", "push_pull", "push_pull_answer"])
def test_matching_sampled_on_jax_plan(built, mode):
    n, (_, jp), _ = built
    tp = _carried(jp)
    m = 16
    tx = _rows(n + 1, m, 1)
    ans = _rows(n + 1, m, 2, 0.6) if mode == "push_pull_answer" else None
    rec = np.random.default_rng(3).random(n + 1) < 0.9
    do_pull = mode != "push"
    jk = jax.random.key(11)
    j_inc, j_msgs = jmatch.matching_sampled(
        jp, jax.numpy.asarray(tx), None if ans is None else jax.numpy.asarray(ans), m, jk,
        receptive_rows=jax.numpy.asarray(rec), do_push=True, do_pull=do_pull,
    )
    t_inc, t_msgs = tmatch.matching_sampled(
        tp, torch.from_numpy(tx), None if ans is None else torch.from_numpy(ans), m,
        prng.key(11, "cpu"), receptive_rows=torch.from_numpy(rec), do_push=True, do_pull=do_pull,
    )
    _eq(j_inc, t_inc)
    _eq(j_msgs, t_msgs)


def test_matching_flood_on_jax_plan(built):
    n, (_, jp), _ = built
    tp = dataclasses.replace(_carried(jp), fanout=None)
    tx = _rows(n + 1, 16, 5)
    _eq(jmatch.matching_flood(jp, jax.numpy.asarray(tx), 16), tmatch.matching_flood(tp, torch.from_numpy(tx), 16))


def test_sampled_needs_fanout(built):
    _, _, (_, tp) = built
    with pytest.raises(ValueError):
        tmatch.matching_sampled(dataclasses.replace(tp, fanout=None), torch.zeros((tp.n + 1, 4), dtype=torch.bool),
                                None, 4, prng.key(0, "cpu"))
