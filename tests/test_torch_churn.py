"""The churn, re-wiring and re-materialization plane against the JAX
package's, bit for bit on the CPU: ``prng.randint``, the churn stage (dense
and compact draws), the fresh-edge delivery (``_substitute_rewired``,
``reverse_fresh_push``, both ``fresh_rewire_traffic`` forms), the CSR fold
(``rematerialize_rewired``), the epoch re-partition
(``repartition_swarm``) and the CSR-free refusal. Whole churned runs are
in ``test_torch_churn_runs.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import topology as jt
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import clone_state as j_clone
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.dist import repartition_swarm as j_repartition
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.sim import engine as je
from tpu_gossip.sim import stages as js
from tpu_gossip_torch import convert
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.sim import stages as ts
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_staircase import chung_lu

CHURN = dict(churn_leave_prob=0.05, churn_join_prob=0.3, rewire_slots=2)


def _np(x):
    return np.asarray(jax.random.key_data(x)) if hasattr(x, "dtype") and jnp.issubdtype(
        x.dtype, jax.dtypes.prng_key) else np.asarray(x)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want.astype(got.dtype) if want.dtype != got.dtype else want, err_msg=what)
    assert got.dtype == want.dtype or (got.dtype == np.int64 and want.dtype == np.uint32), what


# ---------------------------------------------------------------- randint

SPANS = [1, 2, 3, 65535, 65536, 65537, 5_583_220, 2**31 - 1]


@pytest.mark.parametrize("span", SPANS)
def test_randint_equals_jax(span):
    """uint32 wrap-around included: past 2^16 the multiplier is 0."""
    for seed in (0, 3, 1234):
        want = jax.random.randint(jax.random.key(seed), (33, 7), 0, span)
        got = prng.randint(prng.key(seed, "cpu"), (33, 7), 0, span)
        _eq(got, want, f"span {span} seed {seed}")


def test_randint_empty_span_and_offset_equal_jax():
    for lo, hi in ((5, 5), (7, 3), (0, 0), (-9, 4), (100, 65636), (3, 2**31 - 1)):
        want = jax.random.randint(jax.random.key(11), (50,), lo, hi)
        _eq(prng.randint(prng.key(11, "cpu"), (50,), lo, hi), want, f"[{lo}, {hi})")


def test_randint_tensor_maxval_equals_jax():
    """A device-tensor bound (the churn draws' ``row_ptr[-1]``), read by
    neither package on the host."""
    for hi in (1, 17, 5_583_220):
        want = jax.jit(lambda k, m: jax.random.randint(k, (9, 2), 0, m))(jax.random.key(3), jnp.int32(hi))
        _eq(prng.randint(prng.key(3, "cpu"), (9, 2), 0, torch.tensor(hi, dtype=torch.int32)), want, str(hi))


@pytest.mark.parametrize("cap", [1, 7, 40, 300])
def test_first_rows_is_nonzero_with_size(cap):
    mask = np.random.default_rng(cap).random(300) < 0.1
    want = jnp.nonzero(jnp.asarray(mask), size=cap, fill_value=0)[0]
    rows, live = ts.first_rows(torch.from_numpy(mask), cap)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
    np.testing.assert_array_equal(live.numpy(), np.arange(cap) < mask.sum())


# ------------------------------------------------------------ churn stage


def _csr_values(g, n, seed, exists=None):
    """Row-level churn operands over a host CSR, from one numpy seed."""
    rng = np.random.default_rng(seed)
    exists = np.ones(n, bool) if exists is None else exists
    alive = exists & (rng.random(n) < 0.6)
    rewired = rng.random(n) < 0.2
    tg = np.where(rng.random((n, 2)) < 0.8, rng.integers(0, n, (n, 2)), -1).astype(np.int32)
    return dict(
        alive=alive, silent=rng.random(n) < 0.1, exists=exists,
        last_hb=rng.integers(0, 30, n).astype(np.int16), declared_dead=~alive & (rng.random(n) < 0.5),
        rewired=rewired, rewire_targets=np.where(rewired[:, None], tg, rng.integers(-1, n, (n, 2))).astype(np.int32),
        degree_credit=rng.integers(0, 3, n).astype(np.int32),
        row_ptr=np.asarray(g.row_ptr, np.int32), col_idx=np.asarray(g.col_idx, np.int32),
    )


def _run_churn_stage(host, cfg_kw, seed=5, rnd=37):
    jcfg, tcfg = JConfig(n_peers=len(host["alive"]), **cfg_kw), TConfig(n_peers=len(host["alive"]), **cfg_kw)
    jk = jax.random.split(jax.random.key(seed), 5)
    tk = prng.split(prng.key(seed, "cpu"), 5)
    jst, tst = js._churn_stage(jcfg, burst=False), ts._churn_stage(tcfg)
    jv = {k: jnp.asarray(v) for k, v in host.items()}
    jv.update(rnd=jnp.int32(rnd), k_leave=jk[3], k_join=jk[4])
    tv = {k: torch.from_numpy(np.array(v)) for k, v in host.items()}
    tv.update(rnd=torch.tensor(rnd, dtype=torch.int32), k_leave=tk[3], k_join=tk[4])
    want = jst.fn(js.StageView(jv, jst))
    got = tst.fn(ts.StageView(tv, tst))
    assert set(got) == set(want) == set(jst.writes) == set(tst.writes)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            _eq(got[k], want[k], k)
    return got


STAGE_CASES = {  # name: config
    "dense": dict(CHURN),
    "compact_undersubscribed": dict(CHURN, rewire_compact_cap=250),
    "compact_oversubscribed": dict(CHURN, rewire_compact_cap=6),
    "leave_only": dict(churn_leave_prob=0.3),
    "join_without_rewiring": dict(churn_join_prob=0.4),
    "three_slots": dict(CHURN, rewire_slots=3),
}


@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_churn_stage_equals_jax(name):
    cfg_kw = STAGE_CASES[name]
    g = chung_lu(400, seed=1)
    host = _csr_values(g, 400, seed=2)
    if cfg_kw.get("rewire_slots", 0) == 3:
        host["rewire_targets"] = np.concatenate([host["rewire_targets"], host["rewire_targets"][:, :1]], axis=1)
    got = _run_churn_stage(host, cfg_kw)
    fresh = got["fresh"]
    if cfg_kw.get("churn_join_prob"):
        assert int(fresh.sum()) > 6  # joiners past the cap exist in the oversubscribed case
    if cfg_kw.get("rewire_compact_cap") == 6:
        assert int((fresh & ~got["rewired"]).sum()) > 0


def test_churn_stage_edgeless_csr_equals_jax():
    """No endpoints to draw: joiners rejoin un-rewired, credit untouched."""
    g = jt.build_csr(50, np.zeros((0, 2), np.int64))
    host = _csr_values(g, 50, seed=4)
    got = _run_churn_stage(host, dict(CHURN, churn_join_prob=0.9))
    assert int(got["fresh"].sum()) > 0
    np.testing.assert_array_equal(got["degree_credit"].numpy(), host["degree_credit"])


@pytest.mark.parametrize("cap", [0, 64])
def test_churn_stage_self_and_sentinel_draws_equal_jax(cap):
    """A star on row 0 (half the endpoint list is row 0 itself) and a
    non-member sentinel row holding edges: both draw kinds become -1."""
    n = 64
    edges = np.array([(0, i) for i in range(1, n - 1)] + [(n - 1, i) for i in range(1, 20)])
    g = jt.build_csr(n, edges)
    exists = np.ones(n, bool)
    exists[n - 1] = False
    host = _csr_values(g, n, seed=6, exists=exists)
    host["alive"][0] = False
    got = _run_churn_stage(host, dict(CHURN, churn_join_prob=0.95, rewire_compact_cap=cap), seed=8)
    assert bool(got["fresh"][0]) and int((got["rewire_targets"][got["fresh"]] == -1).sum()) > 0


# ------------------------------------------------- the fresh-edge delivery


def _rewired_views(n=500, m=16, seed=3, cap=0, slots=2):
    """The same duck-typed state for both packages (the fields the
    re-wiring side paths read), a transmit and an answer plane."""
    g = chung_lu(n, seed=seed)
    rng = np.random.default_rng(seed)
    rewired = rng.random(n) < 0.15
    tg = np.where(rng.random((n, slots)) < 0.85, rng.integers(0, n, (n, slots)), -1).astype(np.int32)
    host = dict(seen=rng.random((n, m)) < 0.3, rewired=rewired, rewire_targets=tg,
                row_ptr=np.asarray(g.row_ptr, np.int32), col_idx=np.asarray(g.col_idx, np.int32))
    transmit = host["seen"] & (rng.random((n, m)) < 0.7)
    answer = host["seen"] & (rng.random((n, m)) < 0.9)
    receptive_any = rng.random(n) < 0.8
    kw = dict(mode="push_pull", fanout=2, msg_slots=m, rewire_slots=slots, rewire_compact_cap=cap)
    jv = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in host.items()})
    tv = types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in host.items()})
    j = (JConfig(n_peers=n, **kw), jv, jnp.asarray(transmit), jnp.asarray(answer), jnp.asarray(receptive_any))
    t = (TConfig(n_peers=n, **kw), tv, torch.from_numpy(transmit), torch.from_numpy(answer),
         torch.from_numpy(receptive_any))
    return j, t


def test_substitute_rewired_equals_jax():
    (jc, jv, *_), (tc, tv, *_) = _rewired_views()
    from tpu_gossip.kernels.gossip import sample_fanout_targets as j_sample

    from tpu_gossip_torch.kernels.gossip import sample_fanout_targets as t_sample

    jt_, jvalid = j_sample(jax.random.key(1), jv.row_ptr, jv.col_idx, 3)
    tt_, tvalid = t_sample(prng.key(1, "cpu"), tv.row_ptr, tv.col_idx, 3)
    want = je._substitute_rewired(jv, jc, jt_, jvalid, jax.random.key(2))
    got = te._substitute_rewired(tv, tc, tt_, tvalid, prng.key(2, "cpu"))
    _eq(got[0], want[0], "targets")
    _eq(got[1], want[1], "valid")


def test_reverse_fresh_push_equals_jax():
    (jc, jv, jtx, *_), (tc, tv, ttx, *_) = _rewired_views()
    want = je.reverse_fresh_push(jv, jc, jtx, jax.random.key(4))
    got = te.reverse_fresh_push(tv, tc, ttx, prng.key(4, "cpu"))
    _eq(got[0], want[0], "incoming")
    assert int(got[1]) == int(want[1]) > 0


@pytest.mark.parametrize("cap", [0, 20, 400])
@pytest.mark.parametrize("do_pull", [False, True])
def test_fresh_rewire_traffic_equals_jax(cap, do_pull):
    """Dense, and compact with the cap over- (20) and under-subscribed (400)."""
    (jc, jv, jtx, jans, jrec), (tc, tv, ttx, tans, trec) = _rewired_views(cap=cap)
    want = je.fresh_rewire_traffic(jv, jc, jtx, jans, jrec, jax.random.key(5), jax.random.key(6), do_pull)
    got = te.fresh_rewire_traffic(tv, tc, ttx, tans, trec, prng.key(5, "cpu"), prng.key(6, "cpu"), do_pull)
    _eq(got[0], want[0], "incoming")
    assert int(got[1]) == int(want[1]) > 0


# ------------------------------------------------------ set-up


def _build_csr_swarms(n, seed=0, **cfg_kw):
    g, kw, origins = _csr_swarm_args(n, seed, cfg_kw)
    jsw = j_init(g, JConfig(**kw), key=jax.random.key(seed), origins=origins)
    return g, (JConfig(**kw), jsw), _port_csr_swarm(n, seed, **cfg_kw)


def _csr_swarm_args(n, seed, cfg_kw):
    g = chung_lu(n, seed=seed)
    kw = dict(n_peers=n, msg_slots=16, mode="push_pull", fanout=1, **CHURN)
    kw.update(cfg_kw)
    return g, kw, np.random.default_rng(seed).choice(n, size=2, replace=False)


def _port_csr_swarm(n, seed=0, **cfg_kw):
    """The port's half of :func:`_build_csr_swarms`: ``(cfg, state)``."""
    from tpu_gossip_torch.core.state import init_swarm as t_init

    g, kw, origins = _csr_swarm_args(n, seed, cfg_kw)
    return TConfig(**kw), t_init(g, TConfig(**kw), key=prng.key(seed, "cpu"), origins=origins, device="cpu")


def test_validate_rewire_width_refuses_csr_free_graph_like_jax():
    from tpu_gossip.core.matching_topology import matching_powerlaw_graph as j_build

    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph as t_build

    kw = dict(n_peers=None, msg_slots=16, mode="push_pull", fanout=1, **CHURN)
    jg, _ = j_build(500, fanout=1, key=jax.random.key(0), export_csr=False)
    tg, _ = t_build(500, fanout=1, key=prng.key(0, "cpu"), export_csr=False, device="cpu")
    assert tg.col_idx.shape == (1,)
    kw["n_peers"] = tg.n_pad
    jsw = j_init(jg.as_padded_graph(), JConfig(**kw), key=jax.random.key(0), exists=jg.exists)
    from tpu_gossip_torch.core.state import init_swarm as t_init

    tsw = t_init(tg.as_padded_graph(), TConfig(**kw), key=prng.key(0, "cpu"), exists=tg.exists, device="cpu")
    with pytest.raises(ValueError) as want:
        je.validate_rewire_width(jsw, JConfig(**kw))
    with pytest.raises(ValueError) as got:
        te.validate_rewire_width(tsw, TConfig(**kw))
    assert str(got.value) == str(want.value) and "without a CSR export" in str(got.value)
    with pytest.raises(ValueError, match="without a CSR export"):
        te.gossip_round(tsw, TConfig(**kw))
    te.validate_rewire_width(tsw, TConfig(**dict(kw, churn_join_prob=0.0)))  # no joins, no draws


# ------------------------------------------------------ the CSR fold


def _churned_pair(n=800, rounds=8, **cfg_kw):
    g, (jc, jsw), (tc, tsw) = _build_csr_swarms(n, seed=3, **cfg_kw)
    jsw, _ = je.simulate(jsw, jc, rounds)
    tsw, _ = te.simulate(tsw, tc, rounds)
    assert t_state_digest(tsw) == j_state_digest(jsw) and int(tsw.rewired.sum()) > 0
    return (jc, jsw), (tc, tsw)


def _fold_both(j, t, capacity):
    (jc, jsw), (tc, tsw) = j, t
    jf, jover = je.rematerialize_rewired(j_clone(jsw), jc, capacity)
    tf, tover = te.rematerialize_rewired(tsw, tc, capacity)
    assert int(tover) == int(jover)
    assert t_state_digest(tf) == j_state_digest(jf)
    _eq(tf.col_idx, jf.col_idx, "col_idx")
    _eq(tf.row_ptr, jf.row_ptr, "row_ptr")
    return (jc, jf), (tc, tf), int(tover)


def test_rematerialize_rewired_equals_jax_and_folds_again_at_capacity():
    j, t = _churned_pair()
    cap = te.remat_capacity(t[1], t[0])
    assert cap == je.remat_capacity(j[1], j[0])
    j, t, over = _fold_both(j, t, cap)
    assert over == 0 and int(t[1].col_idx.shape[0]) == cap and not bool(t[1].rewired.any())
    # the tail past row_ptr[-1] is self-loops on the last row with edges
    e = int(t[1].row_ptr[-1])
    assert e < cap and bool((t[1].col_idx[e:] == t[1].col_idx[e:][0]).all())
    # churn on, then a second fold at the capacity shape
    jf, _ = je.simulate(j[1], j[0], 6)
    tf, _ = te.simulate(t[1], t[0], 6)
    assert t_state_digest(tf) == j_state_digest(jf) and int(tf.rewired.sum()) > 0
    _fold_both((j[0], jf), (t[0], tf), cap)


def test_rematerialize_rewired_overflow_equals_jax():
    """A capacity below the assembled edge list: the highest rows' edges go."""
    j, t = _churned_pair()
    kept = int(te.rematerialize_rewired(t[1], t[0], te.remat_capacity(t[1], t[0]))[0].row_ptr[-1])
    _, (_, tf), over = _fold_both(j, t, kept - 50)
    assert over == 50 and int(tf.row_ptr[-1]) == kept - 50


@pytest.mark.parametrize("s", [1, 4])
def test_repartition_swarm_equals_jax(s):
    """A churned, folded swarm re-partitioned: tables, permutation and
    every per-peer plane remapped (fresh targets through ``pos``)."""
    j, t = _churned_pair(rounds=6)
    (jc, jsw), (tc, tsw) = j, t
    # a second churn epoch after no fold keeps rewire_targets live; fold
    # one copy to trim a capacity tail on the other path
    for fold in (False, True):
        if fold:
            (jc, jsw), (tc, tsw), _ = _fold_both((jc, jsw), (tc, tsw), te.remat_capacity(tsw, tc))
        jsg, jnew, jpos = j_repartition(jsw, s, seed=7)
        tsg, tnew, tpos = tdist.repartition_swarm(tsw, s, seed=7)
        np.testing.assert_array_equal(tpos, jpos)
        for name in convert.SHARDED_LEAVES:
            _eq(getattr(tsg, name), getattr(jsg, name), name)
        assert all(getattr(tsg, k) == getattr(jsg, k) for k in convert.SHARDED_STATIC)
        assert t_state_digest(tnew) == j_state_digest(jnew)


@pytest.mark.parametrize("what", ["pipeline", "inject"])
def test_burst_and_quarantined_churn_are_not_ported(what):
    """Every plane once refused on a churned round runs now: a pipelined
    churned round (ROADMAP item 9f: the round stores its issue in
    ``pipe_buf``; its cells against JAX are ``test_torch_pipeline.py``'s)
    and live ingestion (ROADMAP item 12: a zero-count batch equals no
    batch, a landed arrival sets its bit; its cells against JAX are
    ``test_torch_serve_*.py``'s), as do the burst form
    (``test_torch_faults.py``), the quarantined rejoin
    (``test_torch_adversary.py``), growth's admission waves
    (``test_torch_growth_runs.py``), streams (``test_torch_stream.py``) and
    the controller (``test_torch_control*.py``). A batch of another type is
    refused."""
    tc, tsw = _port_csr_swarm(200, seed=1)
    if what == "pipeline":
        from tpu_gossip_torch.sim.stages import compile_pipeline

        serial, _ = te.gossip_round(tsw, tc)
        piped, _ = te.gossip_round(tsw, tc, pipeline=compile_pipeline(1))
        # the buffer holds the issued exchange: every bit the serial round
        # newly delivered is in it
        assert bool(piped.pipe_buf.any()) and not bool((serial.seen & ~tsw.seen & ~piped.pipe_buf).any())
        assert torch.equal(piped.alive, serial.alive) and torch.equal(piped.rng, serial.rng)
        return
    from tpu_gossip_torch.core.state import message_slots
    from tpu_gossip_torch.traffic.ingest import IngestPlan, empty_batch, make_batch
    from tpu_gossip_torch.utils.digest import state_digest

    plan = IngestPlan(msg_slots=tc.msg_slots, max_inject=2)
    plain, _ = te.gossip_round(tsw, tc)
    zero, zstats = te.gossip_round(tsw, tc, inject=empty_batch(plan, "cpu"))
    assert state_digest(zero) == state_digest(plain) and int(zstats.ingest_offered) == 0
    row = int(torch.nonzero(plain.alive & ~plain.declared_dead)[0])
    landed, stats = te.gossip_round(tsw, tc, inject=make_batch(plan, [row], [77], device="cpu"))
    assert bool(landed.seen[row, message_slots(77, tc.msg_slots, 1)[0]]) and int(stats.ingest_injected) == 1
    assert torch.equal(landed.alive, plain.alive) and torch.equal(landed.rng, plain.rng)
    with pytest.raises(TypeError, match="InjectBatch"):
        te.gossip_round(tsw, tc, **{what: object()})
