"""Whole churned runs against the JAX package's, bit for bit on the CPU:
every local delivery path under churn and re-wiring (exactly-k, the
staircase kernel path, flood, the matching kernel path and its packed
twin), the delivery shim the packed round's side paths read, the bucketed
engine at one and four shards (K6 and scatter receive), and a churned,
folded JAX state carried across by ``convert``."""

import dataclasses

import pytest
import torch

from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import engine as je
from tpu_gossip_torch import convert
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state as t_pack_state
from tpu_gossip_torch.core.packed import unpack_state as t_unpack_state
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.sim import packed_engine as tpe
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_churn import CHURN, _build_csr_swarms, _churned_pair, _fold_both, _np
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_staircase import chung_lu


def _plans(g, path, fanout):
    if path != "staircase":
        return None, None
    from tpu_gossip.kernels.pallas_segment import build_staircase_plan as j_build

    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan as t_build

    return j_build(g.row_ptr, g.col_idx, fanout=fanout), t_build(g.row_ptr, g.col_idx, fanout=fanout, device="cpu")


ROUND_CASES = {  # name: (delivery path, config changes)
    "exactly_k_dense": ("xla", {}),
    "exactly_k_compact": ("xla", dict(rewire_compact_cap=24)),
    "exactly_k_push_f2": ("xla", dict(mode="push", fanout=2)),
    "staircase_dense": ("staircase", {}),
    "staircase_compact_forward_once": ("staircase", dict(rewire_compact_cap=24, forward_once=True)),
    "flood_ignores_rewiring": ("xla", dict(mode="flood")),
    "sir_leave_only": ("xla", dict(churn_join_prob=0.0, rewire_slots=0, sir_recover_rounds=3)),
}


@pytest.mark.parametrize("name", list(ROUND_CASES))
def test_churned_simulate_equals_jax(name):
    path, cfg_kw = ROUND_CASES[name]
    g, (jc, jsw), (tc, tsw) = _build_csr_swarms(1200, seed=2, **cfg_kw)
    jp, tp = _plans(g, path, None if jc.mode == "flood" else jc.fanout)
    jf, jst = je.simulate(jsw, jc, 10, jp)
    tf, tst = te.simulate(tsw, tc, 10, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    if tc.rewire_slots:
        assert int(tf.rewired.sum()) > 0


@pytest.mark.parametrize("cap", [0, 48])
def test_churned_matching_and_packed_twin_equal_jax(cap):
    """The matching kernel path (K1, K2, K3 with ``fresh``) and its packed
    twin (K4), whose side paths read the delivery shim's fields alone."""
    from tests.test_torch_slice import build_both

    (jc, jsw, jp), (tc, tsw, tp) = build_both(2000, seed=1, mode="push_pull", fanout=1, **CHURN,
                                              rewire_compact_cap=cap)
    jf, jst = je.simulate(jsw, jc, 8, jp)
    tf, tst = te.simulate(tsw, tc, 8, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    pf, pst = te.simulate(t_pack_state(tsw), tc, 8, tp)
    assert t_state_digest(t_unpack_state(pf)) == t_state_digest(tf)
    assert t_stats_digest(pst) == t_stats_digest(tst)


def test_delivery_shim_carries_what_the_side_paths_read():
    """The packed round's shim serves the re-wiring side paths the same
    planes the unpacked state does."""
    _, (tc, tsw) = _build_csr_swarms(600, seed=4)[1:]
    tsw, _ = te.simulate(tsw, tc, 6, None)
    ps = t_pack_state(tsw)
    flags = tpe._decode_flags(ps)
    shim = tpe._delivery_shim(ps, flags, tsw.seen)
    transmit = tsw.seen & tsw.alive[:, None]
    args = (transmit, tsw.seen, tsw.alive, prng.key(1, "cpu"), prng.key(2, "cpu"), True)
    a, b = te.fresh_rewire_traffic(shim, tc, *args), te.fresh_rewire_traffic(tsw, tc, *args)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    assert int(tsw.rewired.sum()) > 0


# ------------------------------------------------ the bucketed engine


@pytest.mark.parametrize("s,k6,cap", [(1, True, 0), (1, False, 32), (4, True, 0)])
def test_churned_simulate_dist_equals_jax(s, k6, cap):
    from tpu_gossip.dist import build_shard_plans as j_plans
    from tpu_gossip.dist import simulate_dist as j_sim
    from tests.test_torch_dist import _build

    g = chung_lu(2000, seed=3)
    (jc, jsw, jsg, jm), (tc, tsw, tsg, tm) = _build(g, s, mode="push_pull", fanout=1, **CHURN,
                                                    rewire_compact_cap=cap)
    jp, tp = (j_plans(jsg), tdist.build_shard_plans(tsg)) if k6 else (None, None)
    jf, jst = j_sim(jsw, jc, jsg, jm, 8, jp)
    tf, tst = tdist.simulate_dist(tsw, tc, tsg, tm, 8, tp)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    assert int(tf.rewired.sum()) > 0


def test_convert_carries_a_churned_folded_jax_state():
    """A JAX state mid-churn after a fold (col_idx at capacity with its
    tail, live rewire_targets and degree_credit) runs on in the port."""
    j, t = _churned_pair()
    (jc, jf), _, _ = _fold_both(j, t, te.remat_capacity(t[1], t[0]))
    jf, _ = je.simulate(jf, jc, 4)
    leaves = {f.name: _np(getattr(jf, f.name)) for f in dataclasses.fields(jf)}
    assert leaves["rewire_targets"].max() >= 0 and leaves["degree_credit"].any()
    carried = convert.state_from_jax(leaves, device="cpu")
    assert t_state_digest(carried) == j_state_digest(jf)
    tf, tst = te.simulate(carried, t[0], 5)
    jf2, jst = je.simulate(jf, jc, 5)
    assert t_state_digest(tf) == j_state_digest(jf2) and t_stats_digest(tst) == j_stats_digest(jst)
    back = convert.to_numpy(tf)
    assert back["col_idx"].shape == _np(jf2.col_idx).shape
