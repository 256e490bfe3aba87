"""The controller's hooks in the two sampled kernel wrappers, against the
JAX package on the CPU: K5's wrapper (``segment_sampled``) rescales its
precomputed push thresholds to the round's effective fanout, exhaustively
over ``plan.fanout`` 1-8 and ``m_eff`` 1 to twice the fanout, each pair
equal to JAX's ``segment_sampled`` (Pallas in interpret mode) and to the
expression XLA compiles from JAX's scale (the division by the constant
``plan.fanout`` becomes a multiply by its float32 reciprocal, the 5/3
trap pinned on its own); and the matching family's ``matching_sampled``
with its three hooks on a JAX-built plan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import matching_topology as jmt
from tpu_gossip.kernels import matching as jmatch
from tpu_gossip.kernels import pallas_segment as jseg
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.kernels import matching as tmatch
from tpu_gossip_torch.kernels import pallas_segment as tseg
from tests.test_torch_matching import _carried
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_staircase import _jax_plan_to_port, chung_lu

FANOUTS = range(1, 9)


@pytest.fixture(scope="module")
def plans():
    """JAX's staircase plan at each fanout over one Chung-Lu graph, and the
    port's copy of it."""
    g = chung_lu(600, seed=3)
    out = {}
    for f in FANOUTS:
        jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=f)
        out[f] = (jp, _jax_plan_to_port(jp))
    return g, out


def _xla_scaled(jp, fanout):
    """JAX's scaled thresholds as XLA compiles them: the wrapper's own
    expression under ``jax.jit``, the plan's fanout a constant."""
    f_static = jp.fanout

    def scaled(pt, f):
        scale = f.astype(jnp.float32) / jnp.float32(f_static)
        s = jnp.minimum(pt.astype(jnp.float32) * scale, jnp.float32(2**32 - 2**8)).astype(jnp.uint32)
        return jnp.where(f == f_static, pt, s)

    return np.asarray(jax.jit(scaled)(jp.push_thresh, jnp.int32(fanout))).astype(np.int64)


@pytest.mark.parametrize("f", FANOUTS)
def test_k5_scaled_thresholds_equal_xla_on_every_pair(plans, f):
    _, by_f = plans
    jp, tp = by_f[f]
    for m_eff in range(1, 2 * f + 1):
        got = tseg.scaled_push_thresholds(tp, torch.tensor(m_eff, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), _xla_scaled(jp, m_eff), err_msg=f"fanout {f} m_eff {m_eff}")
        if m_eff == f:
            np.testing.assert_array_equal(got.numpy(), tp.push_thresh.numpy())


@pytest.mark.parametrize("f", FANOUTS)
def test_k5_controlled_segment_sampled_equals_jax_on_every_pair(plans, f):
    """The whole controlled wrapper: the scaled push law, the pull gate on
    the pull activation and the needy rows on the pull bill, delivery and
    bill equal to JAX's for every ``m_eff``."""
    g, by_f = plans
    jp, tp = by_f[f]
    m = 8
    rng = np.random.default_rng(f)
    tx = rng.random((g.n, m)) < 0.3
    rec = rng.random(g.n) < 0.9
    needy = rng.random(g.n) < 0.6
    for m_eff in range(1, 2 * f + 1):
        gate = bool(m_eff % 2)
        jinc, jmsgs = jseg.segment_sampled(
            jp, jnp.asarray(tx), None, m, jax.random.key(m_eff), receptive_rows=jnp.asarray(rec), do_push=True,
            do_pull=True, fanout=jnp.int32(m_eff), pull_gate=jnp.asarray(gate), pull_needy_rows=jnp.asarray(needy))
        tinc, tmsgs = tseg.segment_sampled(
            tp, torch.from_numpy(tx), None, m, prng.key(m_eff, "cpu"), receptive_rows=torch.from_numpy(rec),
            do_push=True, do_pull=True, fanout=torch.tensor(m_eff, dtype=torch.int32),
            pull_gate=torch.tensor(gate), pull_needy_rows=torch.from_numpy(needy))
        np.testing.assert_array_equal(tinc.numpy(), np.asarray(jinc), err_msg=f"fanout {f} m_eff {m_eff}")
        assert int(tmsgs) == int(jmsgs) > 0, (f, m_eff)


def test_k5_scale_five_thirds_trap():
    """At ``plan.fanout = 3`` and ``m_eff = 5`` the division and XLA's
    multiply by the reciprocal round apart in float32, and so do the
    thresholds of some slots: the port takes the multiply, as the compiled
    JAX program does."""
    f32 = np.float32
    assert f32(5) / f32(3) == f32(1.66666663) and f32(5) * (f32(1) / f32(3)) == f32(1.66666675)
    g = chung_lu(600, seed=3)
    jp = jseg.build_staircase_plan(g.row_ptr, g.col_idx, fanout=3)
    tp = _jax_plan_to_port(jp)
    pt = np.asarray(jp.push_thresh).astype(np.float32)
    divided = np.minimum(pt * (f32(5) / f32(3)), f32(2**32 - 2**8)).astype(np.uint32).astype(np.int64)
    got = tseg.scaled_push_thresholds(tp, torch.tensor(5, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, _xla_scaled(jp, 5))
    assert (got != divided).any()
    hlo = jax.jit(lambda f: f.astype(jnp.float32) / jnp.float32(3)).lower(jnp.int32(5)).compile().as_text()
    assert "multiply" in hlo and "divide" not in hlo


def test_k5_hooks_refuse_shapes_that_are_not_a_round_decision(plans):
    g, by_f = plans
    _, tp = by_f[2]
    tx = torch.zeros((g.n, 4), dtype=torch.bool)
    for kw in (dict(fanout=torch.tensor([2], dtype=torch.int32)),
               dict(pull_needy_rows=torch.ones(3, dtype=torch.bool))):
        with pytest.raises(ValueError, match="round decision"):
            tseg.segment_sampled(tp, tx, None, 4, prng.key(0, "cpu"), do_pull=True, **kw)


@pytest.fixture(scope="module")
def matching():
    jg, jp = jmt.matching_powerlaw_graph(2000, fanout=2, key=jax.random.key(0))
    return jp, _carried(jp)


@pytest.mark.parametrize("m_eff,gate,needy", [(2, True, False), (1, True, True), (4, False, True), (3, True, True),
                                             (4, True, False)])
def test_matching_sampled_hooks_equal_jax(matching, m_eff, gate, needy):
    jp, tp = matching
    n, m = jp.n, 16
    rng = np.random.default_rng(m_eff)
    tx = rng.random((n + 1, m)) < 0.3
    rec = rng.random(n + 1) < 0.9
    rows = rng.random(n + 1) < 0.5
    jinc, jmsgs = jmatch.matching_sampled(
        jp, jnp.asarray(tx), None, m, jax.random.key(5), receptive_rows=jnp.asarray(rec), do_push=True, do_pull=True,
        fanout=jnp.int32(m_eff), pull_gate=jnp.asarray(gate), pull_needy_rows=jnp.asarray(rows) if needy else None)
    tinc, tmsgs = tmatch.matching_sampled(
        tp, torch.from_numpy(tx), None, m, prng.key(5, "cpu"), receptive_rows=torch.from_numpy(rec), do_push=True,
        do_pull=True, fanout=torch.tensor(m_eff, dtype=torch.int32), pull_gate=torch.tensor(gate),
        pull_needy_rows=torch.from_numpy(rows) if needy else None)
    np.testing.assert_array_equal(tinc.numpy(), np.asarray(jinc))
    assert int(tmsgs) == int(jmsgs) > 0
    if m_eff == 2 and gate and not needy:
        # the static fanout through the hook: the uncontrolled call's bits
        sinc, smsgs = tmatch.matching_sampled(tp, torch.from_numpy(tx), None, m, prng.key(5, "cpu"),
                                              receptive_rows=torch.from_numpy(rec), do_push=True, do_pull=True)
        assert torch.equal(sinc, tinc) and int(smsgs) == int(tmsgs)
