"""The cells of ``tests/sim/test_traffic.py`` as port-against-JAX
equalities on the CPU: the streaming plane (``tpu_gossip_torch/traffic/``)
runs each cell on the same seed-built inputs as the JAX package, the run
equal to JAX's through ``state_digest``/``stats_digest`` (every per-round
column, ``slot_infected`` and ``slot_age`` included), and the cell's own
law then holds on the port's run. Here: the lease mechanics and
``compile_stream``'s refusals in JAX's words, the age-out through every
tail, the k = 1 and k = 2 counter balances, the origin laws and the
degree law's CSR refusal, dead origins, zero-rate streams equal to no
stream on each shape, mid- and pre-stream checkpoints across the
packages, the predictors, the message hashes, the episode reconstruction
and the round's host half. The longer runs (the bucketed mesh,
conformance, the steady state) are ``test_torch_stream_runs.py``'s, the
matching layout's ``test_torch_stream_matching.py``'s."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip import traffic as jt
from tpu_gossip.core.state import SwarmConfig as JConfig
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.core.topology import build_csr, preferential_attachment
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import engine as je
from tpu_gossip.sim import metrics as JM
from tpu_gossip_torch import traffic as tt
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.sim import engine as te
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.traffic import engine as tte
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

N = 256


def seed_graph(n=N, seed=0):
    return build_csr(n, preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(seed)))


def setup(m=8, seed=1, origins=(0,), n=N, **cfg_kw):
    """(jax (cfg, state), port (cfg, state)) over
    tests/sim/test_traffic.py::stream_setup's swarm."""
    g = seed_graph(n)
    kw = dict(n_peers=n, msg_slots=m, fanout=cfg_kw.pop("fanout", 2), mode=cfg_kw.pop("mode", "push_pull"), **cfg_kw)
    jc, tc = JConfig(**kw), TConfig(**kw)
    js = j_init(g, jc, origins=list(origins) or None, key=jax.random.key(seed))
    ts = t_init(g, tc, origins=list(origins) or None, key=prng.key(seed, "cpu"), device="cpu")
    return (jc, js), (tc, ts)


def streams(**kw):
    return jt.compile_stream(**kw), tt.compile_stream(**kw, device="cpu")


def run_both(pair, rounds, strm_pair, tail="fused", jtail="fused"):
    """Both packages' runs; asserts them equal; returns the port's."""
    (jc, js), (tc, ts) = pair
    jstrm, tstrm = strm_pair
    jf, jst = je.simulate(js, jc, rounds, None, jtail, None, None, jstrm)
    tf, tst = te.simulate(ts, tc, rounds, None, tail, stream=tstrm)
    assert t_state_digest(tf) == j_state_digest(jf)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    np.testing.assert_array_equal(tst.coverage.numpy(), np.asarray(jst.coverage))
    return tf, tst


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ lease mechanics and compile-time validation

def test_slot_expiry_mask():
    lease = [-1, 0, 3, 7]
    want = np.asarray(jt.slot_expiry(jnp.asarray(lease, dtype=jnp.int16), jnp.asarray(7), ttl=4))
    got = tt.slot_expiry(torch.tensor(lease, dtype=torch.int16), torch.tensor(7, dtype=torch.int32), ttl=4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [False, True, True, False])


def test_min_feasible_ttl_and_batch_equal_jax():
    for n in (2, 96, 1000, 20000, 1_000_000):
        for fanout in (1, 2, 3, 8):
            assert tt.min_feasible_ttl(n, fanout) == jt.min_feasible_ttl(n, fanout)
    for rate in (0.0, 0.5, 2.0, 4.0, 16.0, 400.0):
        assert tt.default_max_inject(rate) == jt.default_max_inject(rate)
    assert tt.min_feasible_ttl(1_000_000, 2) > tt.min_feasible_ttl(1000, 2)
    assert tt.min_feasible_ttl(1000, 8) < tt.min_feasible_ttl(1000, 1)
    assert tt.min_feasible_ttl(2, 1) >= 1 and tt.min_feasible_ttl(1_000_000, 1) == 24
    assert tt.default_max_inject(4.0) == 16


BAD = [
    dict(rate=-1.0), dict(ttl=0), dict(k_hashes=9), dict(origins="zipf"), dict(burst_every=-1),
    dict(burst_mult=0.0), dict(origin_rows=np.zeros((0,))), dict(hot_weight=1.5),
    dict(origins="hotspot", hot_frac=0.0), dict(max_inject=0),
]


def test_compile_stream_rejections_in_jax_words():
    ok = dict(rate=1.0, msg_slots=8, ttl=10, origin_rows=np.arange(16))
    for bad in BAD:
        with pytest.raises(jt.StreamError) as jerr:
            jt.compile_stream(**{**ok, **bad})
        with pytest.raises(tt.StreamError) as terr:
            tt.compile_stream(**{**ok, **bad}, device="cpu")
        assert str(terr.value) == str(jerr.value), bad


@pytest.mark.parametrize("kw", [
    dict(rate=1.0, msg_slots=8, ttl=10, origin_rows=np.arange(16)),
    dict(rate=2.5, msg_slots=16, ttl=7, origin_rows=np.arange(5, 300), origins="hotspot", hot_frac=0.05,
         hot_weight=0.7, burst_every=3, burst_mult=2.5, k_hashes=3),
    dict(rate=400.0, msg_slots=64, ttl=50, origin_rows=np.arange(N), origins="degree", max_inject=512),
])
def test_compiled_stream_tables_equal_jax(kw):
    j, t = streams(**kw)
    for f in ("rate", "origin_rows", "hot_rows"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
        assert getattr(t, f).dtype == {"rate": torch.float32}.get(f, torch.int32)
    for f in ("ttl", "max_inject", "k_hashes", "origins", "hot_weight", "burst_every", "burst_mult"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.rate_f32 == float(np.asarray(j.rate))


# ------------------------------------------------------------ age-out: the sliding window

def test_age_out_recycles_seeded_epidemic_through_tail():
    """A zero-rate stream still ages the round-0 epidemic's lease out: its
    column clears in one round through the tail and the lease frees."""
    pair = setup(m=4)
    fin, stats = run_both(pair, 8, streams(rate=0.0, msg_slots=4, ttl=5, origin_rows=np.arange(N)))
    cov = stats.coverage.numpy()
    assert cov[3] > 0.1 and (cov[5:] == 0).all()
    assert not fin.seen.any() and (fin.slot_lease == -1).all()
    assert int(stats.stream_expired.sum()) == 1
    np.testing.assert_array_equal(stats.slot_age.numpy()[:5, 0], [1, 2, 3, 4, -1])


@pytest.mark.parametrize("tail", ["reference", "fused", "pallas"])
def test_stream_bit_identical_across_tails(tail):
    """The expired-column mask rides every tail implementation (the K3
    plain version, the reference and the saturated-age ``pallas`` map) on
    a churned loaded run, each equal to JAX's reference-tail run."""
    pair = setup(m=8, churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=2)
    _, stats = run_both(pair, 15, streams(rate=3.0, msg_slots=8, ttl=6, origin_rows=np.arange(N)), tail=tail,
                        jtail="reference")
    assert int(stats.stream_expired.sum()) > 0


# ------------------------------------------------------------ injection semantics

@pytest.mark.parametrize("k,m", [(1, 8), (2, 16)])
def test_counter_balance_k1_and_k2(k, m):
    """k=1: every live arrival lands (injected == offered); k>=2: a Bloom
    false positive is suppressed (injected + conflated == offered)."""
    _, stats = run_both(setup(m=m), 30, streams(rate=4.0, msg_slots=m, ttl=1000, origin_rows=np.arange(N),
                                                 k_hashes=k))
    off, inj, conf = (int(getattr(stats, f"stream_{f}").sum()) for f in ("offered", "injected", "conflated"))
    assert off > 0 and conf > 0
    if k == 1:
        assert inj == off and conf < inj
    else:
        assert inj + conf == off


def _raw_injection(strm_pair, pair, key_seed, rnd=1):
    """The injection stage alone on a virgin swarm in both packages; asserts
    the products equal and returns the port's seen plane and telemetry."""
    (_, js), (_, ts) = pair
    jstrm, tstrm = strm_pair
    m = ts.seen.shape[1]
    jseen, _, jlease, jtel = jt.apply_stream(
        jstrm, jax.random.key(key_seed), jnp.asarray(rnd, jnp.int32), jnp.zeros((), jnp.int32),
        seen=jnp.zeros_like(js.seen), infected_round=jnp.full(js.seen.shape, -1, dtype=jnp.int16),
        slot_lease=jnp.full((m,), -1, dtype=jnp.int16), row_ptr=js.row_ptr, col_idx=js.col_idx, exists=js.exists,
        alive=js.alive, declared_dead=js.declared_dead)
    tseen, tir, tlease, ttel = tt.apply_stream(
        tstrm, prng.key(key_seed, "cpu"), torch.tensor(rnd, dtype=torch.int32), torch.zeros((), dtype=torch.int32),
        seen=torch.zeros_like(ts.seen), infected_round=torch.full(tuple(ts.seen.shape), -1, dtype=torch.int16),
        slot_lease=torch.full((m,), -1, dtype=torch.int16), row_ptr=ts.row_ptr, col_idx=ts.col_idx,
        exists=ts.exists, alive=ts.alive, declared_dead=ts.declared_dead)
    np.testing.assert_array_equal(tseen.numpy(), np.asarray(jseen))
    np.testing.assert_array_equal(tlease.numpy(), np.asarray(jlease))
    np.testing.assert_array_equal(tir.numpy(), np.where(np.asarray(jseen), rnd, -1))
    for f in tt.StreamTelemetry._fields:
        assert int(getattr(ttel, f)) == int(getattr(jtel, f)), f
    return tseen.numpy(), ttel


def test_hotspot_origin_law_concentrates():
    pair = setup(m=64, origins=())
    strm = streams(rate=400.0, msg_slots=64, ttl=50, origin_rows=np.arange(N), origins="hotspot", hot_frac=0.05,
                   hot_weight=0.9, max_inject=512)
    seen, _ = _raw_injection(strm, pair, 11)
    rows = np.flatnonzero(seen.any(axis=1))
    hot_n = int(0.05 * N)
    assert len(rows[rows < hot_n]) / hot_n == 1.0
    assert len(rows[rows >= hot_n]) / (N - hot_n) < 0.3 and len(rows) > 20


def test_degree_origin_law_favors_hubs():
    pair = setup(m=64, origins=())
    strm = streams(rate=400.0, msg_slots=64, ttl=50, origin_rows=np.arange(N), origins="degree", max_inject=512)
    counts = sum(_raw_injection(strm, pair, 100 + s)[0].sum(axis=1) for s in range(6))
    deg = seed_graph().degrees
    assert counts[np.argsort(deg)[-10:]].mean() > 2 * counts[np.argsort(deg)[:100]].mean()


@pytest.mark.parametrize("via_plan", [False, True])
def test_degree_origin_law_requires_csr_in_jax_words(via_plan):
    """On a CSR-free matching graph the run refuses in JAX's words: through
    the exactly-k delivery first without the plan (JAX's cell), through the
    stream's degree law with it."""
    from tpu_gossip.core.matching_topology import matching_powerlaw_graph as jbuild

    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph as tbuild

    jg, jplan = jbuild(256, fanout=2, key=jax.random.key(0), export_csr=False)
    tg, tplan = tbuild(256, fanout=2, key=prng.key(0, "cpu"), export_csr=False, device="cpu")
    jplan, tplan = (jplan, tplan) if via_plan else (None, None)
    kw = dict(n_peers=tg.n_pad, msg_slots=8, fanout=2)
    js = j_init(jg.as_padded_graph(), JConfig(**kw), origins=[0], exists=jg.exists, key=jax.random.key(1))
    ts = t_init(tg.as_padded_graph(), TConfig(**kw), origins=[0], exists=tg.exists, key=prng.key(1, "cpu"),
                device="cpu")
    skw = dict(rate=2.0, msg_slots=8, ttl=20, origin_rows=np.flatnonzero(np.asarray(jg.exists)), origins="degree")
    jstrm, tstrm = streams(**skw)
    with pytest.raises(ValueError, match="export_csr") as jerr:
        je.simulate(js, JConfig(**kw), 4, jplan, "fused", None, None, jstrm)
    with pytest.raises(ValueError, match="export_csr") as terr:
        te.simulate(ts, TConfig(**kw), 4, tplan, stream=tstrm)
    assert str(terr.value) == str(jerr.value)
    assert ("degree-weighted stream origins" in str(terr.value)) == via_plan


def test_dead_origin_loses_arrival():
    (jc, js), (tc, ts) = setup(m=8, origins=())
    js = dataclasses.replace(js, alive=jnp.zeros_like(js.alive))
    ts = dataclasses.replace(ts, alive=torch.zeros_like(ts.alive))
    _, stats = run_both(((jc, js), (tc, ts)), 10, streams(rate=4.0, msg_slots=8, ttl=100, origin_rows=np.arange(N)))
    assert int(stats.stream_offered.sum()) > 0 and int(stats.stream_injected.sum()) == 0


# ------------------------------------------------------------ determinism rails

@pytest.mark.parametrize("shape", ["none-vs-zero", "with-churn", "packed", "bucketed"])
def test_zero_rate_stream_bit_identical_to_no_stream(shape):
    """A zero-rate stream with a TTL past the horizon reproduces the run
    without a stream bit for bit (its draws come from their own stream),
    on the local engine, under churn, packed and on the bucketed mesh; and
    the port's zero-rate run equals JAX's."""
    extra = dict(churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=2) if shape == "with-churn" else {}
    pair = setup(m=8, **extra)
    strm = streams(rate=0.0, msg_slots=8, ttl=1000, origin_rows=np.arange(N))
    (_, _), (tc, ts) = pair
    if shape == "bucketed":
        from tpu_gossip_torch import dist as tdist

        sg, rel, pos = tdist.partition_graph(seed_graph(), 1, seed=1, device="cpu")
        mesh = tdist.make_mesh(1, device="cpu")
        cfg = dataclasses.replace(tc, n_peers=sg.n_pad)
        st = tdist.shard_swarm(tdist.init_sharded_swarm(sg, rel, pos, cfg, key=prng.key(1, "cpu"), origins=[0],
                                                        device="cpu"), mesh)
        zstrm = tt.compile_stream(rate=0.0, msg_slots=8, ttl=1000, origin_rows=pos[np.arange(N)], device="cpu")
        base, bst = tdist.simulate_dist(st, cfg, sg, mesh, 12)
        zero, zst = tdist.simulate_dist(st, cfg, sg, mesh, 12, stream=zstrm)
    else:
        run_both(pair, 12, strm)
        st = pack_state(ts) if shape == "packed" else ts
        base, bst = te.simulate(st, tc, 12)
        zero, zst = te.simulate(st, tc, 12, stream=strm[1])
        if shape == "packed":
            base, zero = unpack_state(base), unpack_state(zero)
    assert t_state_digest(zero) == t_state_digest(base)
    for f in ("coverage", "msgs_sent", "n_infected", "n_alive"):
        np.testing.assert_array_equal(getattr(zst, f).numpy(), getattr(bst, f).numpy(), err_msg=f)


# ------------------------------------------------------------ checkpointing: the lease table is the stream cursor

def test_mid_stream_checkpoint_resumes_bit_exactly_across_packages(tmp_path):
    """A state saved mid-stream by either package loads in the other with
    its leases and finishes on the same bits."""
    from tpu_gossip.core.state import load_swarm as j_load
    from tpu_gossip.core.state import save_swarm as j_save
    from tpu_gossip_torch.core.state import load_swarm as t_load
    from tpu_gossip_torch.core.state import save_swarm as t_save

    (jc, js), (tc, ts) = setup(m=8)
    jstrm, tstrm = streams(rate=3.0, msg_slots=8, ttl=10, origin_rows=np.arange(N))
    jmid, _ = je.simulate(js, jc, 12, None, "fused", None, None, jstrm)
    tmid, _ = te.simulate(ts, tc, 12, stream=tstrm)
    assert (tmid.slot_lease >= 0).any() and t_state_digest(tmid) == j_state_digest(jmid)
    j_save(tmp_path / "j.npz", jmid)
    t_save(tmp_path / "t.npz", tmid)
    jfin, _ = je.simulate(j_load(tmp_path / "t.npz"), jc, 10, None, "fused", None, None, jstrm)
    tfin, _ = te.simulate(t_load(tmp_path / "j.npz", device="cpu"), tc, 10, stream=tstrm)
    cont, _ = te.simulate(tmid, tc, 10, stream=tstrm)
    assert t_state_digest(tfin) == j_state_digest(jfin) == t_state_digest(cont)


def test_pre_stream_checkpoint_loads_with_implied_leases(tmp_path):
    from tpu_gossip_torch.core.state import load_swarm as t_load
    from tpu_gossip_torch.core.state import save_swarm as t_save

    (_, _), (tc, ts) = setup(m=4)
    mid, _ = te.simulate(ts, tc, 3)
    t_save(tmp_path / "new.npz", mid)
    data = dict(np.load(tmp_path / "new.npz"))
    assert "field_slot_lease" in data
    del data["field_slot_lease"]  # the format before the streaming plane
    np.savez(tmp_path / "old.npz", **data)
    restored = t_load(tmp_path / "old.npz", device="cpu")
    np.testing.assert_array_equal(restored.slot_lease.numpy(), np.where(mid.seen.numpy().any(axis=0), 0, -1))
    fin, _ = te.simulate(restored, tc, 3, stream=tt.compile_stream(rate=1.0, msg_slots=4, ttl=20,
                                                                     origin_rows=np.arange(N), device="cpu"))
    assert int(fin.round) == 6


# ------------------------------------------------------------ the closed-form predictors and the message hashes

@pytest.mark.parametrize("r,m,k", [(0, 8, 1), (1, 8, 1), (10, 64, 1), (300, 64, 1), (40, 128, 2), (7, 16, 3)])
def test_predictors_equal_jax(r, m, k):
    assert TM.expected_conflations(r, m) == JM.expected_conflations(r, m)
    assert TM.bloom_false_positive_rate(r, m, k) == JM.bloom_false_positive_rate(r, m, k)


def test_message_slots_equal_jax():
    from tpu_gossip.core.state import message_slot as j_slot
    from tpu_gossip.core.state import message_slots as j_slots
    from tpu_gossip_torch.core.state import message_slot as t_slot
    from tpu_gossip_torch.core.state import message_slots as t_slots

    for mid in (0, 1, 12345, -7, 2 ** 70 + 3, "hello", "rumor-42", ""):
        for m, k in ((8, 1), (64, 3), (128, 2)):
            assert t_slots(mid, m, k) == j_slots(mid, m, k)
        assert t_slot(mid, 64) == j_slot(mid, 64)
    with pytest.raises(ValueError, match="k must be"):
        t_slots(1, 8, 9)


# ------------------------------------------------------------ the steady-state report

def test_stream_episodes_reconstruction_synthetic():
    stats = types.SimpleNamespace(
        slot_age=np.asarray([[0, -1], [1, -1], [2, 0], [3, 1], [-1, 2], [-1, 3]]),
        slot_infected=np.asarray([[10, 0], [40, 0], [95, 5], [99, 10], [0, 20], [0, 30]]),
        n_alive=np.full(6, 100), coverage=np.zeros(6, dtype=np.float32))
    eps = TM.stream_episodes(stats, target=0.9)
    assert eps == JM.stream_episodes(stats, target=0.9)
    by_slot = {}
    for e in eps:
        by_slot.setdefault(e["slot"], []).append(e)
    (s0,), (s1,) = by_slot[0], by_slot[1]
    assert (s0["start_round"], s0["end_round"], s0["completed_age"]) == (1, 4, 2)
    assert s1["end_round"] == -1 and s1["completed_age"] == -1


# ------------------------------------------------------------ the round's host half

def test_round_arrivals_are_jax_counts_at_the_burst_rate():
    """The host half of the injection: the round's count is
    ``min(poisson(k_count, rate [* burst_mult]), max_inject)`` of the
    round's key, JAX's draw, on burst and plain rounds and past the
    batch."""
    _, strm = streams(rate=3.0, msg_slots=8, ttl=10, origin_rows=np.arange(N), burst_every=3, burst_mult=4.0,
                      max_inject=12)
    for seed in range(12):
        for rnd in (1, 3, 6, 7):
            k_count = jax.random.split(jax.random.fold_in(jax.random.key(seed), tt.TRAFFIC_STREAM_SALT), 5)[0]
            lam = jnp.float32(3.0) * jnp.where(rnd % 3 == 0, jnp.float32(4.0), jnp.float32(1.0))
            want = min(int(jax.random.poisson(k_count, lam, dtype=jnp.int32)), 12)
            assert tte.round_arrivals(strm, prng.key(seed, "cpu"), rnd) == want
    assert tte.round_rate(strm, 6) == 12.0 and tte.round_rate(strm, 7) == 3.0
