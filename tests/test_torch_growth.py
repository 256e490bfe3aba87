"""The growth plane (``tpu_gossip_torch/growth/``) against the JAX
package's, bit for bit on the CPU.

The draw first: the port's float32 ``log`` (``prng.xla_log``) equals
``jnp.log`` on every input the admission draw can feed it (each of the
2^23 uniforms, each inner log's negation, the integer degrees), the
Gumbel table and ``prng.gumbel`` equal ``jax.random.gumbel`` whole or in
row chunks, and the top-k breaks ties as ``jax.lax.top_k`` does. Then the
host half (``compile_growth``, ``pad_graph_for_growth``,
``matching_admit_rows`` and every refusal in JAX's words) and the device
half on seeded planes (``realized_degrees``, ``hill_gamma_device``,
``apply_growth``). The whole runs are ``test_torch_growth_runs.py``'s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip import growth as jg
from tpu_gossip.core.topology import build_csr, preferential_attachment
from tpu_gossip_torch import growth as tg
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.growth import engine as te_grow
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

N0, CAP, ATTACH = 64, 128, 3
TINY = np.float32(np.finfo(np.float32).tiny)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


# ------------------------------------------------------------ the draw

def _uniforms() -> np.ndarray:
    """Every value the Gumbel draw's uniform takes: j * 2^-23 for j >= 1,
    and tiny for j = 0."""
    u = (np.arange(1 << 23, dtype=np.float64) * 2.0 ** -23).astype(np.float32)
    u[0] = TINY
    return u


@pytest.mark.parametrize("domain", ["inner", "outer", "integers"])
def test_xla_log_equals_jnp_log_on_its_whole_domain(domain):
    """Exhaustive: the inner log over all 2^23 uniforms, the outer log over
    all 2^23 negated inner logs, and every integer 1..2^24 (the degrees)."""
    jlog = jax.jit(jnp.log)
    if domain == "integers":
        x = np.arange(1, (1 << 24) + 1, dtype=np.float32)
    else:
        x = _uniforms()
        if domain == "outer":
            x = -np.asarray(jlog(x))
    want = np.asarray(jlog(x))
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, f"{bad.size} inputs differ, first {x[bad[0]]!r}"
    if domain == "inner":  # torch's own log is not XLA's: the reason xla_log exists
        assert (_bits(torch.log(torch.from_numpy(x)).numpy()) != _bits(want)).any()


def test_xla_log_special_values_equal_jnp_log():
    x = np.asarray([0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, 1e-39, 1.0, 3.4e38], dtype=np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got[ok]), _bits(want[ok]))


def test_gumbel_table_equals_jax_on_every_uniform():
    """The 2^23-entry table is ``-log(-log(u))`` of each uniform, JAX's."""
    want = np.asarray(jax.jit(lambda u: -jnp.log(-jnp.log(u)))(_uniforms()))
    np.testing.assert_array_equal(_bits(prng.gumbel_table("cpu").numpy()), _bits(want))


@pytest.mark.parametrize("seed,shape", [(0, (7, 1001)), (3, (256, 257)), (9, (1, 1 << 18)), (4, (5,))])
def test_gumbel_equals_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape, jnp.float32))
    np.testing.assert_array_equal(_bits(prng.gumbel(prng.key(seed, "cpu"), shape).numpy()), _bits(want))


@pytest.mark.parametrize("chunk", [1, 3, 5, 64])
def test_gumbel_in_row_chunks_equals_the_whole_draw(chunk):
    """A counter offset per chunk: chunks of ``chunk`` rows (non-dividing
    ones and single rows among them) concatenate to JAX's whole draw."""
    rows, n = 37, 389
    want = np.asarray(jax.random.gumbel(jax.random.key(2), (rows, n), jnp.float32))
    k = prng.key(2, "cpu")
    got = torch.cat([prng.gumbel(k, (min(rows, r0 + chunk) - r0, n), offset=r0 * n) for r0 in range(0, rows, chunk)])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("lo,hi", [(0.3, 1.7), (-2.5, 3.1), (float(TINY), 1.0), (0.0, 1.0)])
def test_uniform_with_bounds_equals_jax(lo, hi):
    """``max(minval, floats * (maxval - minval) + minval)`` with the
    multiply-add fused, as XLA's CPU code fuses it."""
    want = np.asarray(jax.random.uniform(jax.random.key(6), (1 << 16,), jnp.float32, lo, hi))
    got = prng.uniform(prng.key(6, "cpu"), (1 << 16,), lo, hi).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_top_k_breaks_ties_to_the_lower_index_as_lax_top_k():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    finite, idx = te_grow._top_k_tie_low(scores, 3)
    assert idx.tolist() == [[1, 2, 4]] and finite.all()
    assert np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()), 3)[1]).tolist() == [[1, 2, 4]]


def test_top_k_equals_lax_top_k_on_ties_signed_zeros_and_minus_inf():
    g = np.random.default_rng(0)
    x = g.integers(-3, 4, (64, 500)).astype(np.float32)  # dense ties
    x[:, :7] = np.float32(-0.0)
    x[:, 7:14] = np.float32(0.0)
    x[g.random(x.shape) < 0.3] = -np.inf
    x[5] = -np.inf  # a row with no finite score
    x[6, :498] = -np.inf  # two finite, the third -inf
    for m in (1, 3, 8):
        ws, wi = jax.lax.top_k(jnp.asarray(x), m)
        finite, idx = te_grow._top_k_tie_low(torch.from_numpy(x), m)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(finite.numpy(), np.isfinite(np.asarray(ws)))


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_gumbel_top_k_equals_jax(chunk):
    """``top_k(log_deg + gumbel(k, (rows, n)))`` with equal log degrees
    (ties) and -inf columns, drawn whole or in chunks."""
    g = np.random.default_rng(1)
    n, rows, m = 3000, 10, 3
    log_deg = np.log(g.integers(1, 4, n).astype(np.float32))
    log_deg[g.random(n) < 0.2] = -np.inf
    key = jax.random.key(11)
    ws, wi = jax.lax.top_k(jnp.asarray(log_deg)[None, :] + jax.random.gumbel(key, (rows, n), jnp.float32), m)
    finite, idx = tg.gumbel_top_k(prng.key(11, "cpu"), torch.from_numpy(log_deg), rows, m, chunk)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(finite.numpy(), np.isfinite(np.asarray(ws)))


# ------------------------------------------------------------ the host half

def _seed_graph(n=N0, m=ATTACH, seed=0):
    return build_csr(n, preferential_attachment(n, m=m, use_native=False, rng=np.random.default_rng(seed)))


def _growth_pair(**kw):
    return jg.compile_growth(**kw), tg.compile_growth(**kw, device="cpu")


def _growth_equal(j, t):
    np.testing.assert_array_equal(t.admit_rows.numpy(), np.asarray(j.admit_rows))
    np.testing.assert_array_equal(t.growable.numpy(), np.asarray(j.growable))
    assert t.admit_rows.dtype == torch.int32 and t.growable.dtype == torch.bool
    for f in ("joins_per_round", "max_batch", "attach_m", "total", "gamma_d_min"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("kw", [
    dict(n_initial=64, target=128, n_slots=128, joins_per_round=8, attach_m=3),
    dict(n_initial=64, target=100, n_slots=140, joins_per_round=0, attach_m=2, max_join_burst=5),
    dict(n_initial=64, target=64, n_slots=128, joins_per_round=8, attach_m=3),
    dict(n_initial=10, target=20, n_slots=40, joins_per_round=3, attach_m=2, admit_rows=np.arange(39, 19, -2)),
    dict(n_initial=10, target=14, n_slots=30, joins_per_round=2, attach_m=2, node_map=lambda ids: 29 - ids,
         gamma_d_min=3),
])
def test_compile_growth_equals_jax(kw):
    _growth_equal(*_growth_pair(**kw))


REFUSALS = {  # name: (compile_growth kwargs, JAX's words)
    "target_below_initial": (dict(n_initial=64, target=32, n_slots=128, joins_per_round=4, attach_m=2),
                             "below initial"),
    "negative_rate": (dict(n_initial=64, target=70, n_slots=128, joins_per_round=-1, attach_m=2), ">= 0"),
    "never_grows": (dict(n_initial=64, target=128, n_slots=128, joins_per_round=0, attach_m=2), "never grow"),
    "attach_zero": (dict(n_initial=64, target=70, n_slots=128, joins_per_round=1, attach_m=0), "positive"),
    "attach_too_wide": (dict(n_initial=4, target=16, n_slots=16, joins_per_round=2, attach_m=4), "initial peers"),
    "row_space": (dict(n_initial=64, target=128, n_slots=100, joins_per_round=4, attach_m=2), "row space"),
    "twice": (dict(n_initial=64, target=66, n_slots=128, joins_per_round=4, attach_m=2,
                   admit_rows=np.asarray([70, 70])), "twice"),
    "wrong_count": (dict(n_initial=64, target=66, n_slots=128, joins_per_round=4, attach_m=2,
                         admit_rows=np.asarray([70])), "entries"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_compile_growth_refuses_as_jax(name):
    kw, words = REFUSALS[name]
    with pytest.raises(jg.GrowthError, match=words) as want:
        jg.compile_growth(**kw)
    with pytest.raises(tg.GrowthError, match=words) as got:
        tg.compile_growth(**kw, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cap", [N0, 100])
def test_pad_graph_for_growth_equals_jax(cap):
    g = _seed_graph()
    (jgr, jex), (tgr, tex) = jg.pad_graph_for_growth(g, cap), tg.pad_graph_for_growth(g, cap)
    np.testing.assert_array_equal(tex, jex)
    np.testing.assert_array_equal(tgr.row_ptr, jgr.row_ptr)
    np.testing.assert_array_equal(tgr.col_idx, jgr.col_idx)
    assert tgr.n == jgr.n == cap
    with pytest.raises(tg.GrowthError, match="capacity 10 < initial peers 64"):
        tg.pad_graph_for_growth(g, 10)
    # a device graph's CSR pads where it lies
    dev_g = dataclasses.replace(g, row_ptr=torch.from_numpy(g.row_ptr), col_idx=torch.from_numpy(g.col_idx))
    dgr, dex = tg.pad_graph_for_growth(dev_g, cap)
    np.testing.assert_array_equal(dgr.row_ptr.numpy(), jgr.row_ptr)
    np.testing.assert_array_equal(dex, jex)


@pytest.fixture(scope="module")
def sharded8():
    """The S=8 matching layout with 32 growth rows a block, both packages."""
    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded as jb

    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded as tb

    return (jb(800, 8, fanout=2, key=jax.random.key(0), growth_rows=32),
            tb(800, 8, fanout=2, key=prng.key(0, "cpu"), growth_rows=32, device="cpu"))


def test_matching_admit_rows_equal_jax_and_refuse_overflow(sharded8):
    (_, jp), (_, tp) = sharded8
    for total in (0, 5, 80, 256):
        np.testing.assert_array_equal(tg.matching_admit_rows(tp, total), jg.matching_admit_rows(jp, total))
    rows = tg.matching_admit_rows(tp, 80)
    assert np.ptp(np.bincount(rows // tp.n_blk, minlength=8)) <= 1  # round-robin balance
    with pytest.raises(jg.GrowthError, match="growth_rows") as want:
        jg.matching_admit_rows(jp, 8 * 32 + 1)
    with pytest.raises(tg.GrowthError, match="growth_rows") as got:
        tg.matching_admit_rows(tp, 8 * 32 + 1)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ the device half, seeded planes

def _planes(seed=1, n=300, n0=200, w=4):
    g = np.random.default_rng(seed)
    row_ptr = np.concatenate([[0], np.cumsum(g.integers(0, 5, n))]).astype(np.int32)
    row_ptr[n0 + 1:] = row_ptr[n0]
    exists = np.arange(n) < n0
    exists[g.integers(0, n0, 10)] = False
    return dict(row_ptr=row_ptr, exists=exists, alive=g.random(n) < 0.9, silent=g.random(n) < 0.1,
                last_hb=g.integers(0, 50, n).astype(np.int16), declared_dead=g.random(n) < 0.05,
                rewired=g.random(n) < 0.2, rewire_targets=g.integers(-1, n0, (n, w)).astype(np.int32),
                join_round=np.where(exists, 0, -1).astype(np.int16), admitted_by=np.full(n, -1, np.int32),
                degree_credit=g.integers(0, 3, n).astype(np.int32))


def test_realized_degrees_and_gamma_track_equal_jax():
    p = _planes()
    keys = ("row_ptr", "exists", "rewired", "rewire_targets", "degree_credit")
    want = np.asarray(jg.realized_degrees(*(jnp.asarray(p[k]) for k in keys)))
    got = tg.realized_degrees(*(torch.from_numpy(p[k]) for k in keys))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    live = p["alive"] & ~p["declared_dead"]
    for d_min in (1, 2, 4, 50):
        jgam = float(jg.hill_gamma_device(jnp.asarray(want), jnp.asarray(live), d_min))
        tgam = float(tg.hill_gamma_device(got, torch.from_numpy(live), d_min))
        np.testing.assert_allclose(tgam, jgam, rtol=1e-5)
        assert (tgam == 0.0) == (jgam == 0.0)


@pytest.mark.parametrize("burst,seed,cursor", [(0, 1, 0), (8, 2, 0), (3, 7, 76), (0, 5, 80)])
def test_apply_growth_equals_jax_on_seeded_planes(burst, seed, cursor):
    """All ten returned fields, bit for bit and dtype for dtype: ties among
    the log degrees, -inf rows (non-members, the dead, the declared),
    a burst on top of the rate, a cursor near the schedule's end and a
    drained one (nothing left to admit), each draw chunked three ways."""
    p = _planes(seed)
    kw = dict(n_initial=200, target=280, n_slots=300, joins_per_round=16, attach_m=3, max_join_burst=8)
    jgp, tgp = _growth_pair(**kw)
    p["exists"][200:200 + cursor] = True  # the cursor: rows already admitted
    jo = jg.apply_growth(jgp, jax.random.key(seed), jnp.int32(5), jnp.int32(burst),
                         **{k: jnp.asarray(v) for k, v in p.items()})
    for chunk in (None, 1, 5):
        to = tg.apply_growth(tgp, prng.key(seed, "cpu"), torch.tensor(5, dtype=torch.int32),
                             torch.tensor(burst, dtype=torch.int32), chunk_rows=chunk,
                             **{k: torch.from_numpy(np.array(v)) for k, v in p.items()})
        assert set(to) == set(jo)
        for f in jo:
            want, got = np.asarray(jo[f]), to[f].numpy()
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    admitted = int(to["exists"].sum()) - int(p["exists"].sum())
    assert admitted == min(16 + burst, 80 - cursor)


def test_apply_growth_refuses_a_narrow_rewire_plane_as_jax():
    p = _planes(w=2)
    _, tgp = _growth_pair(n_initial=200, target=280, n_slots=300, joins_per_round=16, attach_m=3)
    with pytest.raises(ValueError, match="rewire_slots >= 3"):
        tg.apply_growth(tgp, prng.key(0, "cpu"), torch.tensor(1), torch.tensor(0),
                        **{k: torch.from_numpy(v) for k, v in p.items()})
