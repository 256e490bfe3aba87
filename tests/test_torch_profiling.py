"""The port's profiling module against ``tpu_gossip/utils/profiling.py``,
and the sparse transport's compaction helpers against
``tpu_gossip/dist/transport.py``."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip.dist import transport as jt
from tpu_gossip.utils import profiling as jprof
from tpu_gossip_torch.dist import transport as tt
from tpu_gossip_torch.utils import profiling as tprof
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def test_format_stage_table_equals_jax():
    stages = {"delivery": 0.0123456, "tail[fused]": 1e-5, "rng": float("nan"), "full_round[fused]": 0.02}
    assert tprof.format_stage_table(stages) == jprof.format_stage_table(stages)


def test_stages_ms_rounds_as_the_jax_cli_and_writes_nan_as_null():
    got = tprof.stages_ms({"a": 0.00123456789, "b": float("nan")})
    assert got == {"a": round(0.00123456789 * 1e3, 4), "b": None}
    assert json.loads(json.dumps(got)) == got


class _Clock:
    """A clock that advances by a fixed step per read, whatever runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_slope_time_is_nan_on_a_non_positive_slope(monkeypatch):
    monkeypatch.setattr(tprof.time, "perf_counter", _Clock())
    calls = []

    def body(i, c):
        calls.append(i)
        return c + 1

    dt = tprof.slope_time(body, torch.zeros((), dtype=torch.int32), 2, 5, reps=2)
    assert math.isnan(dt)
    # one warm run and ``reps`` timed runs at each length
    assert len(calls) == 3 * 5 + 3 * 2


def test_slope_time_slope_of_a_patched_clock(monkeypatch):
    """With a clock that charges each iteration one second, the slope is 1."""
    clock = {"t": 0.0}
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: clock["t"])

    def body(i, c):
        clock["t"] += 1.0
        return c

    assert tprof.slope_time(body, torch.zeros(3), 4, 24, reps=3) == 1.0


@pytest.mark.parametrize("cap", [3, 40])
@pytest.mark.parametrize("g", [1, 2])
def test_compaction_helpers_equal_jax(cap, g):
    rng = np.random.default_rng(cap + g)
    s, b = 8, 64
    occ = rng.random((s, b)) < 0.15
    occ[0] = False  # an empty row: sentinels only
    occ[1, :20] = True  # a row past the small cap: its tail drops
    payload = rng.integers(1, 2**31, (s, b, g), dtype=np.int32) * occ[..., None]
    counts = tt.occupancy_counts(torch.from_numpy(occ))
    assert (counts.numpy() == np.asarray(jt.occupancy_counts(jnp.asarray(occ)))).all()
    assert counts.dtype == torch.int32
    idx_j = np.asarray(jt.compact_index(jnp.asarray(occ), cap))
    idx_t = tt.compact_index(torch.from_numpy(occ), cap)
    assert idx_t.dtype == torch.int32 and (idx_t.numpy() == idx_j).all()
    assert (idx_j == b).any()  # sentinels present
    vals_j = np.asarray(jt.gather_compact(jnp.asarray(payload), jnp.asarray(idx_j)))
    vals_t = tt.gather_compact(torch.from_numpy(payload), idx_t)
    assert (vals_t.numpy() == vals_j).all()
    back_j = np.asarray(jt.scatter_compact(jnp.asarray(idx_j), jnp.asarray(vals_j), b))
    back_t = tt.scatter_compact(idx_t, vals_t, b)
    assert (back_t.numpy() == back_j).all()
    if cap == 3:
        assert (back_t.numpy() != payload).any()  # the overflow dropped
    else:
        assert (back_t.numpy() == payload).all()  # round trip exact under the cap


def test_compaction_helpers_on_a_2d_payload():
    occ = np.zeros((2, 6), dtype=bool)
    occ[0, [1, 4]] = True
    payload = np.arange(12, dtype=np.int32).reshape(2, 6) * occ
    idx = tt.compact_index(torch.from_numpy(occ), 3)
    vals = tt.gather_compact(torch.from_numpy(payload), idx)
    want = np.asarray(jt.gather_compact(jnp.asarray(payload), jnp.asarray(idx.numpy())))
    assert (vals.numpy() == want).all()
    assert (tt.scatter_compact(idx, vals, 6).numpy() == payload).all()


def _port_swarm(n):
    """The port's matching swarm of ``tests.jax_pins.profile_stage_keys``."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm

    tg, tplan = matching_powerlaw_graph(n, gamma=2.5, fanout=1, key=prng.key(0, "cpu"), device="cpu")
    tcfg = SwarmConfig(n_peers=n + 1, msg_slots=16, mode="push_pull", fanout=1)
    tst = init_swarm(tg.as_padded_graph(), tcfg, key=prng.key(0, "cpu"), origins=np.arange(4), exists=tg.exists,
                     device="cpu")
    return tst, tcfg, tplan


def test_profile_round_stages_keys_equal_jax():
    """Both tail sets, the second with the compaction probe: JAX's stage
    names in JAX's order; every value a positive number or NaN. The JAX
    names are pinned (tests/jax_pins.json, group profile): the JAX
    profile's in-process compiles are the slowest of the file, and any
    in-process compile can lose a worker to XLA's CPU compiler under the
    suite's load."""
    from tests.jax_pins import CASES, pinned

    tst, tcfg, tplan = _port_swarm(500)
    fast = dict(reps=1, loop_lengths=(1, 2))
    n, runs = CASES["profile"]["stage_keys_500"][1]
    assert n == 500
    for (tails, tp), want in zip(runs, pinned("profile", "stage_keys_500")):
        tails, tp = tuple(tails), None if tp is None else tuple(tp)
        got = tprof.profile_round_stages(tst, tcfg, tplan, tails=tails, transport_probe=tp, device="cpu", **fast)
        assert list(got) == want
        assert all(v > 0 or math.isnan(v) for v in got.values())


def test_trace_writes_a_trace_and_none_is_a_no_op(tmp_path):
    with tprof.trace(tmp_path / "prof"):
        torch.arange(1000).sum()
    written = tmp_path / "prof" / tprof.TRACE_FILE
    assert written.exists()
    assert "traceEvents" in json.loads(written.read_text())
    with tprof.trace(None):
        pass
    with tprof.trace(""):
        pass
    assert sorted(p.name for p in tmp_path.iterdir()) == ["prof"]
