"""The exactly-k XLA delivery ops against tpu_gossip/kernels/gossip.py, bit
for bit, on the same graphs, keys and bitmaps (bitmaps from numpy seeds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.core import topology as jt
from tpu_gossip.kernels import gossip as jg
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.kernels import gossip as tg
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _graph(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    g = jt.build_csr(n, jt.configuration_model(jt.powerlaw_degree_sequence(n, rng=rng), rng=rng))
    return g.row_ptr, g.col_idx


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _isolated(row_ptr, col_idx, k=5):
    """The same edge list with ``k`` trailing degree-0 rows."""
    return np.concatenate([row_ptr, np.full(k, row_ptr[-1], row_ptr.dtype)]), col_idx


@pytest.mark.parametrize("isolated", [False, True])
def test_edge_sources_equal_jax(isolated):
    rp, ci = _graph()
    if isolated:
        rp, ci = _isolated(rp, ci)
    np.testing.assert_array_equal(tg.edge_sources(torch.from_numpy(rp), ci.shape[0]).numpy(),
                                  np.asarray(jg.edge_sources(jnp.asarray(rp), ci.shape[0])))


@pytest.mark.parametrize("fanout,seed", [(1, 0), (3, 5), (4, 2**31 - 1)])
def test_sample_fanout_targets_equal_jax(fanout, seed):
    rp, ci = _isolated(*_graph(seed=seed % 7))
    (jrp, trp), (jci, tci) = _both(rp), _both(ci)
    jt_, jv = jg.sample_fanout_targets(jax.random.key(seed), jrp, jci, fanout)
    tt_, tv = tg.sample_fanout_targets(prng.key(seed, "cpu"), trp, tci, fanout)
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt_))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tt_.dtype == torch.int32 and not bool(tv[-1].any())


def test_sample_fanout_targets_of_an_edgeless_graph():
    rp = np.zeros(6, np.int32)
    tt_, tv = tg.sample_fanout_targets(prng.key(0, "cpu"), torch.from_numpy(rp), torch.zeros(0, dtype=torch.int32), 2)
    assert tt_.shape == (5, 2) and not bool(tv.any())


@pytest.mark.parametrize("m", [1, 16, 33])
def test_push_and_pull_fanout_equal_jax(m):
    rp, ci = _graph(seed=m)
    n = rp.shape[0] - 1
    rng = np.random.default_rng(m)
    tx = rng.random((n, m)) < 0.3
    tgt, valid = jg.sample_fanout_targets(jax.random.key(m), jnp.asarray(rp), jnp.asarray(ci), 3)
    pv = np.asarray(valid) & (rng.random((n, 3)) < 0.7)
    (jtx, ttx), (jtg, ttg), (jpv, tpv) = _both(tx), _both(np.asarray(tgt)), _both(pv)
    np.testing.assert_array_equal(tg.push_fanout(ttx, ttg, tpv).numpy(), np.asarray(jg.push_fanout(jtx, jtg, jpv)))
    np.testing.assert_array_equal(tg.pull_fanout(ttx, ttg, tpv).numpy(), np.asarray(jg.pull_fanout(jtx, jtg, jpv)))


@pytest.mark.parametrize("padding", [0, 300])
def test_flood_all_equals_jax(padding):
    """With ``padding`` capacity slots past row_ptr[-1] (a re-materialized
    CSR keeps col_idx at a fixed length), which must carry nothing."""
    rp, ci = _graph(seed=3)
    n = rp.shape[0] - 1
    ci = np.concatenate([ci, np.arange(padding, dtype=ci.dtype) % n])
    tx = np.random.default_rng(1).random((n, 20)) < 0.1
    (jtx, ttx), (jrp, trp), (jci, tci) = _both(tx), _both(rp), _both(ci)
    np.testing.assert_array_equal(tg.flood_all(ttx, trp, tci).numpy(), np.asarray(jg.flood_all(jtx, jrp, jci)))
    assert not bool(tg.flood_all(ttx, trp, tci[:0]).any())
