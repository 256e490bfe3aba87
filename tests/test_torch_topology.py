"""The port's graph builders against the JAX package's, bit for bit: the
host builders on the same numpy seeds, the C++ preferential attachment on
the same seed, and the on-device power-law generator on the same key."""

import jax
import numpy as np
import pytest

from tpu_gossip.core import device_topology as jdt
from tpu_gossip.core import topology as jt
from tpu_gossip.native import pa_edges_native as j_pa_native
from tpu_gossip_torch.core import device_topology as tdt
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core import topology as tt
from tpu_gossip_torch.native import pa_edges_native as t_pa_native
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("n,gamma,seed", [(1000, 2.5, 0), (20000, 2.2, 3), (5000, 3.0, 11)])
def test_degree_sequence_and_configuration_model_equal_jax(n, gamma, seed):
    jr, tr = _rngs(seed)
    jdeg = jt.powerlaw_degree_sequence(n, gamma=gamma, rng=jr)
    tdeg = tt.powerlaw_degree_sequence(n, gamma=gamma, rng=tr)
    np.testing.assert_array_equal(tdeg, jdeg)
    je, te = jt.configuration_model(jdeg, rng=jr), tt.configuration_model(tdeg, rng=tr)
    np.testing.assert_array_equal(te, je)
    jg, tg = jt.build_csr(n, je), tt.build_csr(n, te)
    assert tg.n == jg.n and tg.num_edges == jg.num_edges
    for name in ("row_ptr", "col_idx"):
        a, b = getattr(jg, name), getattr(tg, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_build_csr_of_no_edges():
    g = tt.build_csr(4, np.zeros((0, 2), dtype=np.int64))
    np.testing.assert_array_equal(g.row_ptr, jt.build_csr(4, np.zeros((0, 2), dtype=np.int64)).row_ptr)
    assert g.col_idx.shape == (0,)


@pytest.mark.parametrize("n,m,seed", [(300, 3, 0), (1000, 2, 5)])
def test_python_preferential_attachment_equals_jax(n, m, seed):
    jr, tr = _rngs(seed)
    np.testing.assert_array_equal(tt.preferential_attachment(n, m, rng=tr, use_native=False),
                                  jt.preferential_attachment(n, m, rng=jr, use_native=False))


@pytest.mark.parametrize("n,m,seed", [(5000, 3, 1), (20000, 4, 9)])
def test_native_preferential_attachment_equals_jax_native(n, m, seed):
    want = j_pa_native(n, m, seed=seed)
    if want is None:
        pytest.skip("the JAX package's libtpugossip.so is not built (make -C tpu_gossip/native)")
    np.testing.assert_array_equal(t_pa_native(n, m, seed=seed), want)
    jr, tr = _rngs(seed)
    np.testing.assert_array_equal(tt.preferential_attachment(n, m, rng=tr),
                                  jt.preferential_attachment(n, m, rng=jr))


def test_preferential_attachment_rejects_small_n():
    with pytest.raises(ValueError):
        tt.preferential_attachment(3, 3, use_native=False)


@pytest.mark.parametrize("d_min", [4, 8])
def test_fit_powerlaw_gamma_equals_jax(d_min):
    deg = jt.powerlaw_degree_sequence(50000, gamma=2.5, rng=np.random.default_rng(2))
    got = tt.fit_powerlaw_gamma(deg, d_min=d_min)
    assert got == jt.fit_powerlaw_gamma(deg, d_min=d_min)
    assert abs(got - 2.5) < 0.3
    assert tt.hill_gamma(10, 4.0) == jt.hill_gamma(10, 4.0)
    with pytest.raises(ValueError):
        tt.fit_powerlaw_gamma(np.full(5, 9))


def test_save_load_graph_roundtrip(tmp_path):
    deg = tt.powerlaw_degree_sequence(500, rng=np.random.default_rng(0))
    g = tt.build_csr(500, tt.configuration_model(deg, rng=np.random.default_rng(1)))
    tt.save_graph(tmp_path / "g.npz", g)
    back = jt.load_graph(tmp_path / "g.npz")
    mine = tt.load_graph(tmp_path / "g.npz")
    assert mine.n == back.n == 500
    np.testing.assert_array_equal(mine.row_ptr, back.row_ptr)
    np.testing.assert_array_equal(mine.col_idx, back.col_idx)


@pytest.mark.parametrize("gamma,d_max", [(2.5, 141), (2.2, 3000)])
def test_truncated_pareto_mean_equals_jax(gamma, d_max):
    assert tdt.truncated_pareto_mean(gamma, 2, d_max) == jdt.truncated_pareto_mean(gamma, 2, d_max)


@pytest.mark.parametrize("n,seed", [(2000, 0), (2000, 5), (20000, 3)])
def test_device_powerlaw_graph_equals_jax(n, seed):
    jg = jdt.device_powerlaw_graph(n, key=jax.random.key(seed))
    tg = tdt.device_powerlaw_graph(n, key=prng.key(seed, "cpu"), device="cpu")
    assert tg.n == jg.n
    for name in ("row_ptr", "col_idx", "exists"):
        a, b = np.asarray(getattr(jg, name)), getattr(tg, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    # the sentinel row n holds every erased stub; real rows hold real peers
    rp, ci = tg.row_ptr.numpy(), tg.col_idx.numpy()
    assert (ci[: rp[n]] < n).all() and (ci[rp[n]:] == n).all()
    jh, th = jg.to_host_graph(), tg.to_host_graph()
    assert th.n == jh.n == n
    np.testing.assert_array_equal(th.row_ptr, jh.row_ptr)
    np.testing.assert_array_equal(th.col_idx, jh.col_idx)
