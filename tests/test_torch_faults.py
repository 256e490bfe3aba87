"""The fault plane (``tpu_gossip_torch/faults/``) against the JAX package's,
bit for bit on the CPU: the parser, the validator's rejections and the
compiled tables for every node-set form, ``faulted_dissemination`` per
fault class plane by plane, ``drain_held``, and whole runs under the cells
of ``tests/sim/test_faults.py`` (each cell's run equal to JAX's through
``state_digest``/``stats_digest``, and the cell's own law holding on the
port's run), the quiescent scenario against none, side B's pass forced on
quiescent rounds, the bucketed engine at S = 1 and 3 against the local
engine and the JAX mesh, and the packed round against the unpacked one."""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gossip import SwarmConfig as JConfig
from tpu_gossip import build_csr, preferential_attachment
from tpu_gossip import faults as jf
from tpu_gossip.core.state import init_swarm as j_init
from tpu_gossip.fleet.engine import state_digest as j_state_digest
from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
from tpu_gossip.sim import metrics as JM
from tpu_gossip.sim.engine import simulate as j_sim
from tpu_gossip_torch import convert
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch import faults as tf
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig as TConfig
from tpu_gossip_torch.core.state import init_swarm as t_init
from tpu_gossip_torch.sim import metrics as TM
from tpu_gossip_torch.sim.engine import simulate as t_sim
from tpu_gossip_torch.utils.digest import state_digest as t_state_digest
from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest
from tests.test_torch_ckpt import _jleaves
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

N = 200


@pytest.fixture(scope="module")
def graph():
    return build_csr(N, preferential_attachment(N, m=3, use_native=False))


def _cfgs(**kw):
    kw = {**dict(n_peers=N, msg_slots=8, fanout=3, mode="push"), **kw}
    return JConfig(**kw), TConfig(**kw)


def _swarms(g, seed=0, **kw):
    jc, tc = _cfgs(**kw)
    return ((jc, j_init(g, jc, origins=[0], key=jax.random.key(seed))),
            (tc, t_init(g, tc, origins=[0], key=prng.key(seed, "cpu"), device="cpu")))


def _compile(d, total_rounds=40, n=N, **kw):
    return (jf.compile_scenario(jf.scenario_from_dict(d), n_peers=n, n_slots=n, total_rounds=total_rounds, **kw),
            tf.compile_scenario(tf.scenario_from_dict(d), n_peers=n, n_slots=n, total_rounds=total_rounds,
                                device="cpu", **kw))


def _run_both(g, d, rounds, seed=0, **kw):
    (jc, js), (tc, ts) = _swarms(g, seed, **kw)
    jsc, tsc = _compile(d)
    jfin, jst = j_sim(js, jc, rounds, None, "fused", jsc)
    tfin, tst = t_sim(ts, tc, rounds, None, "fused", scenario=tsc)
    assert t_state_digest(tfin) == j_state_digest(jfin)
    assert t_stats_digest(tst) == j_stats_digest(jst)
    np.testing.assert_array_equal(tst.coverage.numpy(), np.asarray(jst.coverage))
    return tfin, tst, tsc


# ------------------------------------------------------------- the parser

TOML = """
# a comment
[scenario]
name = "demo"

[[phase]]
name  = "lossy"
start = 0
end   = 10
loss  = 0.3           # inline comment
delay = 0.1

[[phase]]
name      = "split"
start     = 10
end       = 20
partition = {frac = 0.5, seed = 3}
blackout  = {span = [0.25, 0.5]}
churn_leave = 0.05
churn_nodes = {ids = [1, 2, 3]}
"""


def _spec_tuple(spec):
    return (spec.name, tuple(dataclasses.astuple(p) for p in spec.phases))


@pytest.mark.parametrize("source", ["text", "file", "catalogue"])
def test_parse_equals_jax(tmp_path, source):
    """The TOML subset parses to the same spec in both packages: inline
    text, a file, and every scenario shipped in ``scenarios/``."""
    import pathlib

    if source == "text":
        sources = [TOML]
    elif source == "file":
        p = tmp_path / "s.toml"
        p.write_text('[scenario]\nname = "f"\n[[phase]]\nstart = 0\nend = 5\n')
        sources = [p]
    else:
        sources = sorted((pathlib.Path(__file__).resolve().parents[1] / "scenarios").glob("*.toml"))
        assert len(sources) >= 4
    for src in sources:
        want, got = jf.parse_scenario(src), tf.parse_scenario(src)
        assert _spec_tuple(got) == _spec_tuple(want)
        assert (got.last_round, got.uses_node_sets, got.uses_adversaries, got.uses_join_burst) == (
            want.last_round, want.uses_node_sets, want.uses_adversaries, want.uses_join_burst)


REJECTIONS = {  # name: (how, argument)
    "unknown_table": ("parse", "[nonsense]\nx = 1\n"),
    "no_key_value": ("parse", "[scenario]\njust words\n"),
    "bad_value": ("parse", "[scenario]\nname = @@@\n"),
    "outside_table": ("parse", "x = 1\n[scenario]\n"),
    "bad_inline": ("parse", "[scenario]\n[[phase]]\nstart = 0\nend = 5\nblackout = {ids}\n"),
    "unknown_keys": ("dict", {"phases": [{"start": 0, "end": 1, "lss": 0.1}]}),
    "no_start": ("dict", {"phases": [{"end": 1}]}),
    "node_keyword": ("dict", {"phases": [{"start": 0, "end": 1, "blackout": "most"}]}),
    "node_keys": ("dict", {"phases": [{"start": 0, "end": 1, "blackout": {"ids": [1], "frac": 0.5}}]}),
    "node_type": ("dict", {"phases": [{"start": 0, "end": 1, "blackout": 7}]}),
    "no_phases": ("validate", []),
    "empty": ("validate", [{"start": 5, "end": 5}]),
    "horizon": ("validate", [{"start": 0, "end": 50}]),
    "overlap": ("validate", [{"start": 0, "end": 9}, {"start": 5, "end": 12}]),
    "probability": ("validate", [{"start": 0, "end": 5, "loss": 1.5}]),
    "partition_all": ("validate", [{"start": 0, "end": 5, "partition": "all"}]),
    "partition_frac_1": ("validate", [{"start": 0, "end": 5, "partition": {"frac": 1.0}}]),
    "partition_span_full": ("validate", [{"start": 0, "end": 5, "partition": {"span": [0.0, 1.0]}}]),
    "partition_every_id": ("validate", [{"start": 0, "end": 5, "partition": {"ids": list(range(N))}}]),
    "ids_outside": ("validate", [{"start": 0, "end": 5, "blackout": {"ids": [999]}}]),
    "frac_outside": ("validate", [{"start": 0, "end": 5, "blackout": {"frac": 1.5}}]),
    "span_order": ("validate", [{"start": 0, "end": 5, "churn_leave": 0.1, "churn_nodes": {"span": [0.5, 0.2]}}]),
    "shards_unsharded": ("validate", [{"start": 0, "end": 5, "blackout": {"shards": [0]}}]),
    "shards_outside": ("validate4", [{"start": 0, "end": 5, "blackout": {"shards": [4]}}]),
    "shards_every": ("validate4", [{"start": 0, "end": 5, "partition": {"shards": [0, 1, 2, 3]}}]),
    "join_burst_negative": ("validate", [{"start": 0, "end": 5, "join_burst": -1}]),
    "accusers_all": ("validate", [{"start": 0, "end": 5, "accusers": "all"}]),
    "forge_fanout": ("validate", [{"start": 0, "end": 5, "forgers": {"ids": [1]}, "forge_fanout": 0}]),
    "flood_fanout": ("validate", [{"start": 0, "end": 5, "floods": {"ids": [1]}, "flood_fanout": 0}]),
}


def _reject(pkg, how, arg) -> str:
    with pytest.raises(pkg.ScenarioError) as e:
        if how == "parse":
            pkg.parse_scenario(arg)
        elif how == "dict":
            pkg.scenario_from_dict(arg)
        else:
            shards = 4 if how == "validate4" else None
            pkg.scenario_from_dict({"phases": arg}).validate(total_rounds=40, n_peers=N, n_shards=shards)
    return str(e.value)


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_rejections_say_what_jax_says(name):
    how, arg = REJECTIONS[name]
    assert _reject(tf, how, arg) == _reject(jf, how, arg)


NODE_SETS = {
    "all": "all",
    "half": "half",
    "ids": {"ids": [3, 17, 40, 199]},
    "frac": {"frac": 0.25, "seed": 7},
    "span": {"span": [0.5, 0.75]},
    "shards": {"shards": [1, 2]},
}
TABLES = ("phase_of_round", "loss", "delay", "leave", "join", "burst", "blackout", "group_b")


@pytest.mark.parametrize("form,where", [(f, w) for w in ("partition", "blackout", "churn_nodes") for f in NODE_SETS
                                        if (f, w) != ("all", "partition")])  # that one is a rejection
def test_compiled_tables_equal_jax(form, where):
    """Every node-set form resolved through a layout with pads (N real
    peers over 256 slots, a permutation as ``node_map``, four 64-row
    shards) compiles to JAX's tables."""
    n_slots = 256
    perm = np.random.default_rng(0).permutation(n_slots)[:N]
    phase = {"name": "p", "start": 3, "end": 9, "loss": 0.2, "churn_leave": 0.1, where: NODE_SETS[form]}
    if where == "churn_nodes":
        phase["churn_join"] = 0.3
    d = {"phases": [{"name": "q", "start": 0, "end": 2, "delay": 0.4}, phase]}
    kw = dict(n_peers=N, n_slots=n_slots, total_rounds=12, node_map=lambda ids: perm[np.asarray(ids)],
              shard_ranges=[(s * 64, (s + 1) * 64) for s in range(4)], n_shards=4)
    want = jf.compile_scenario(jf.scenario_from_dict(d), **kw)
    got = tf.compile_scenario(tf.scenario_from_dict(d), device="cpu", **kw)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("name", "has_partition", "has_blackout", "has_churn", "has_loss_delay", "n_rounds"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_array_equal(got.phase_host, np.asarray(want.phase_of_round))
    gb = np.asarray(want.group_b) & ~(np.asarray(want.blackout) & want.has_blackout)
    np.testing.assert_array_equal(got.pass_b_host, gb.any(axis=1))
    for rnd in (1, 4, 9, 10, 13, 99):  # the clamp onto the quiescent row past the schedule
        jr, tr = want.at_round(jnp.int32(rnd)), got.at_round(rnd)
        for f in ("loss", "delay", "leave", "join", "burst", "blackout", "group_b"):
            np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), err_msg=f)
        dev = got.at_round(torch.tensor(rnd, dtype=torch.int32))
        assert all(torch.equal(getattr(dev, f), getattr(tr, f)) for f in ("loss", "burst", "group_b"))


# ------------------------------------------------------ the head, per class

HEAD_CASES = {
    "none": {"phases": [{"start": 0, "end": 3}]},
    "loss": {"phases": [{"start": 0, "end": 3, "loss": 0.4}]},
    "delay": {"phases": [{"start": 0, "end": 3, "delay": 0.5}]},
    "loss_delay_quiescent_round": {"phases": [{"start": 5, "end": 8, "loss": 0.4, "delay": 0.5}]},
    "partition": {"phases": [{"start": 0, "end": 3, "partition": {"frac": 0.4, "seed": 2}}]},
    "partition_blackout_loss": {"phases": [{"start": 0, "end": 3, "partition": "half", "loss": 0.3,
                                            "blackout": {"span": [0.1, 0.3]}}]},
    "blackout": {"phases": [{"start": 0, "end": 3, "blackout": {"ids": [1, 5, 9, 100]}}]},
    "blackout_delay": {"phases": [{"start": 0, "end": 3, "blackout": {"frac": 0.2, "seed": 1}, "delay": 0.6}]},
}


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_faulted_dissemination_equals_jax_plane_by_plane(name):
    """The head around a deterministic delivery core (each row receives its
    ring neighbour's transmit bits, billed by count), on random planes and a
    live held buffer: incoming, bill, effective transmit, new held buffer
    and the three counters equal JAX's."""
    rng = np.random.default_rng(5)
    planes = {k: rng.random((N, 8)) < p for k, p in
              (("transmit", 0.3), ("transmitter", 0.8), ("receptive", 0.8), ("held", 0.2), ("seen", 0.4))}
    jsc, tsc = _compile(HEAD_CASES[name])

    def j_deliver(tx, tr, rc, kp, kq):
        return jnp.roll(tx & tr, 1, axis=0) & rc, jnp.sum(tx, dtype=jnp.int32)

    def t_deliver(tx, tr, rc, kp, kq):
        return torch.roll(tx & tr, 1, dims=0) & rc, tx.sum(dtype=torch.int64).to(torch.int32)

    jk, tk = [jax.random.key(i) for i in (1, 2, 3)], [prng.key(i, "cpu") for i in (1, 2, 3)]
    want = jf.faulted_dissemination(jsc, jsc.at_round(jnp.int32(2)), j_deliver,
                                    *(jnp.asarray(planes[k]) for k in ("transmit", "transmitter", "receptive",
                                                                       "held", "seen")), *jk)
    got = tf.faulted_dissemination(tsc, tsc.at_round(2), t_deliver,
                                   *(torch.from_numpy(planes[k]) for k in ("transmit", "transmitter", "receptive",
                                                                           "held", "seen")), *tk)
    for what, g, w in zip(("incoming", "msgs", "tx_eff", "new_held"), got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    for f in jf.FaultTelemetry._fields:
        assert int(getattr(got[4], f)) == int(getattr(want[4], f)), f
    assert got[4].msgs_held.dtype == torch.int32


def test_drain_held_equals_jax(graph):
    """Resuming a mid-delay state without its scenario leaves the backlog
    frozen; ``drain_held`` releases it as JAX's does."""
    (jc, js), (tc, ts) = _swarms(graph)
    jsc, tsc = _compile({"phases": [{"name": "frozen", "start": 0, "end": 8, "delay": 1.0}]})
    jmid, _ = j_sim(js, jc, 5, None, "fused", jsc)
    tmid, _ = t_sim(ts, tc, 5, None, "fused", scenario=tsc)
    assert t_state_digest(tmid) == j_state_digest(jmid) and bool(tmid.fault_held.any())
    stuck, _ = t_sim(tmid, tc, 2)
    assert torch.equal(stuck.fault_held, tmid.fault_held)
    got, want = tf.drain_held(tmid), jf.drain_held(jmid)
    assert t_state_digest(got) == j_state_digest(want)
    assert not bool(got.fault_held.any()) and bool((got.seen & ~tmid.seen).any())


# ------------------------------------------------- the cells of test_faults


def _cov(stats):
    return stats.coverage.numpy()


def _check_total_loss(fin, stats, sc):
    cov = _cov(stats)
    assert cov[7] == cov[0] and cov[-1] > cov[7]
    assert stats.msgs_dropped[:8].sum() > 0 and stats.msgs_sent[:8].sum() > 0


def _check_partial_loss(fin, stats, sc):
    rep = TM.phase_report(stats, tf.scenario_from_dict(CELLS["partial_loss"][0]))
    assert 0.35 < rep[0]["delivery_loss_rate"] < 0.65


def _check_delay_holds(fin, stats, sc):
    cov, held = _cov(stats), stats.msgs_held.numpy()
    assert cov[5] == cov[0] and held[:6].max() > 0 and held[-1] == 0 and cov[-1] > 0.5


def _check_geometric_delay(fin, stats, sc):
    assert TM.rounds_to_coverage(stats, 0.95) > 0


def _check_split_brain(fin, stats, sc):
    cov = _cov(stats)
    share = 1.0 - sc.group_b[sc.phase_host[5]].numpy().mean()
    assert (cov[:12] <= share + 1e-6).all() and cov[11] == pytest.approx(share)
    rec = TM.recoverage_rounds(stats, 12, 0.99)
    assert 0 < rec <= 8
    assert TM.phase_report(stats, tf.scenario_from_dict(CELLS["split_brain"][0]))[0][
        "recoverage_rounds_after_heal"] == rec


def _check_explicit_groups(fin, stats, sc):
    seen = fin.seen[:, 0].numpy()
    assert seen[: N // 2].sum() > 1 and not seen[N // 2:].any()


def _check_blackout(fin, stats, sc):
    blacked = sc.blackout[0].numpy()
    dead = fin.declared_dead.numpy()
    assert blacked.sum() == N // 4 and dead[blacked].all() and not dead[~blacked].any()
    assert not fin.seen.numpy()[blacked].any()
    rep = TM.phase_report(stats, tf.scenario_from_dict(CELLS["blackout"][0]))
    assert 7 <= rep[0]["detection_latency_rounds"] <= 9


def _check_burst(fin, stats, sc):
    alive = stats.n_alive.numpy()
    assert alive[-1] > alive[7] and alive[7] < N * 0.7


def _check_burst_mask(fin, stats, sc):
    alive = fin.alive.numpy()
    assert not alive[: N // 4].any() and alive[N // 4:].all()


def _check_skip(fin, stats, sc):
    assert not sc.has_loss_delay
    assert not any(bool(getattr(stats, f).any()) for f in ("msgs_dropped", "msgs_held", "msgs_delivered"))
    assert not bool(fin.fault_held.any())


CELLS = {  # name: (scenario, rounds, config changes, the cell's law)
    "total_loss": ({"phases": [{"name": "dark", "start": 0, "end": 8, "loss": 1.0}]}, 16, {}, _check_total_loss),
    "partial_loss": ({"phases": [{"name": "lossy", "start": 0, "end": 30, "loss": 0.5}]}, 30, {},
                     _check_partial_loss),
    "delay_holds": ({"phases": [{"name": "frozen", "start": 0, "end": 6, "delay": 1.0}]}, 14, {},
                    _check_delay_holds),
    "geometric_delay": ({"phases": [{"name": "slow", "start": 0, "end": 40, "delay": 0.6}]}, 40, {},
                        _check_geometric_delay),
    "split_brain": ({"phases": [{"name": "split", "start": 0, "end": 12, "partition": "half"}]}, 30, {},
                    _check_split_brain),
    "explicit_groups_flood": ({"phases": [{"name": "p", "start": 0, "end": 4, "partition": "half"}]}, 4,
                              dict(mode="flood", msg_slots=4), _check_explicit_groups),
    "blackout": ({"phases": [{"name": "rack", "start": 0, "end": 16, "blackout": {"span": [0.5, 0.75]}}]}, 16,
                 {}, _check_blackout),
    "burst_with_config_churn": ({"phases": [{"name": "storm", "start": 2, "end": 8, "churn_leave": 0.25},
                                            {"name": "refill", "start": 8, "end": 12, "churn_join": 0.2}]}, 12,
                                dict(churn_leave_prob=0.002, churn_join_prob=0.1), _check_burst),
    "burst_node_mask": ({"phases": [{"name": "storm", "start": 0, "end": 10, "churn_leave": 1.0,
                                     "churn_nodes": {"span": [0.0, 0.25]}}]}, 3, {}, _check_burst_mask),
    "partition_skips_loss_stage": ({"phases": [{"name": "p", "start": 0, "end": 6, "partition": "half"}]}, 8, {},
                                   _check_skip),
}


@pytest.mark.parametrize("name", list(CELLS))
def test_fault_cell_equals_jax(graph, name):
    d, rounds, kw, law = CELLS[name]
    fin, stats, sc = _run_both(graph, d, rounds, seed=2 if "burst_with" in name else (1 if "flood" in name else 0),
                               **kw)
    law(fin, stats, sc)


def test_quiescent_scenario_is_bit_identical_to_none(graph):
    """A scenario whose phases inject nothing leaves the run as it was,
    field for field (the fault stream is folded, not taken)."""
    (_, _), (tc, ts) = _swarms(graph)
    _, tsc = _compile({"phases": [{"start": 0, "end": 10}]})
    fa, sa = t_sim(ts, tc, 12)
    fb, sb = t_sim(ts, tc, 12, scenario=tsc)
    for f in dataclasses.fields(fa):
        assert torch.equal(getattr(fa, f.name), getattr(fb, f.name)), f.name
    assert t_stats_digest(sa) == t_stats_digest(sb) and not bool(sb.msgs_dropped.any())


@pytest.mark.parametrize("mode", ["push", "push_pull"])
def test_forced_pass_b_on_quiescent_rounds_changes_no_bit(graph, mode):
    """Side B's pass is skipped on rounds whose side B is empty (decided on
    the host); forcing it on every round gives the same digests."""
    (_, _), (tc, ts) = _swarms(graph, mode=mode, fanout=2)
    _, tsc = _compile({"phases": [{"start": 3, "end": 6, "partition": "half", "loss": 0.2}]})
    assert list(tsc.pass_b_host) == [True, False]
    forced = dataclasses.replace(tsc, pass_b_host=np.ones_like(tsc.pass_b_host))
    fa, sa = t_sim(ts, tc, 10, scenario=tsc)
    fb, sb = t_sim(ts, tc, 10, scenario=forced)
    assert t_state_digest(fa) == t_state_digest(fb) and t_stats_digest(sa) == t_stats_digest(sb)


def test_scenario_rounds_are_absolute_and_resume_mid_scenario(graph, tmp_path):
    """The round counter is the cursor: a scenario attached mid-run lands
    in the right phase, and a state saved mid-delay (``save_swarm``) or
    carried across from JAX (``convert``) resumes onto the uninterrupted
    run."""
    from tpu_gossip_torch.core.state import load_swarm, save_swarm

    (jc, js), (tc, ts) = _swarms(graph)
    _, late = _compile({"phases": [{"name": "late-dark", "start": 6, "end": 12, "loss": 1.0}]})
    mid, _ = t_sim(ts, tc, 6)
    _, stats = t_sim(mid, tc, 6, scenario=late)
    assert _cov(stats)[-1] == _cov(stats)[0]

    d = {"phases": [{"name": "slow", "start": 0, "end": 12, "delay": 0.7, "loss": 0.1}]}
    jsc, tsc = _compile(d)
    tmid, _ = t_sim(ts, tc, 5, scenario=tsc)
    assert bool(tmid.fault_held.any())
    save_swarm(tmp_path / "mid.npz", tmid)
    direct, _ = t_sim(tmid, tc, 7, scenario=tsc)
    resumed, _ = t_sim(load_swarm(tmp_path / "mid.npz", device="cpu"), tc, 7, scenario=tsc)
    jmid, _ = j_sim(js, jc, 5, None, "fused", jsc)
    carried = convert.state_from_jax(_jleaves(jmid), device="cpu")
    assert t_state_digest(carried) == t_state_digest(tmid)
    across, _ = t_sim(carried, tc, 7, scenario=tsc)
    assert t_state_digest(resumed) == t_state_digest(direct) == t_state_digest(across)


def test_stats_rows_carry_fault_telemetry(graph):
    (_, _), (tc, ts) = _swarms(graph)
    _, tsc = _compile({"phases": [{"start": 0, "end": 5, "loss": 0.5}]})
    _, stats = t_sim(ts, tc, 5, scenario=tsc)
    buf = io.StringIO()
    TM.write_jsonl(stats, buf)
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert {"msgs_dropped", "msgs_held", "msgs_delivered"} <= set(rows[0])
    assert sum(r["msgs_dropped"] for r in rows) > 0


def test_phase_report_equals_jax(graph):
    """``phase_report`` and ``recoverage_rounds`` on the same stats."""
    d = {"phases": [{"name": "split", "start": 2, "end": 8, "partition": "half", "loss": 0.2},
                    {"name": "dark", "start": 8, "end": 14, "blackout": {"span": [0.0, 0.1]}, "delay": 0.3}]}
    (jc, js), (tc, ts) = _swarms(graph, mode="push_pull", fanout=1)
    jsc, tsc = _compile(d)
    _, jst = j_sim(js, jc, 24, None, "fused", jsc)
    _, tst = t_sim(ts, tc, 24, scenario=tsc)
    assert TM.phase_report(tst, tf.scenario_from_dict(d)) == JM.phase_report(jst, jf.scenario_from_dict(d))
    for after in (0, 8, 14, 30):
        assert TM.recoverage_rounds(tst, after, 0.9) == JM.recoverage_rounds(jst, after, 0.9)


def test_scenario_on_another_device_is_refused(graph):
    """Tables compiled for another device than the round's raise; the
    round never moves them (no silent fallback)."""
    (_, _), (tc, ts) = _swarms(graph)
    _, tsc = _compile({"phases": [{"start": 0, "end": 4, "loss": 0.5}]})
    elsewhere = dataclasses.replace(tsc, blackout=tsc.blackout.to("meta"))
    with pytest.raises(ValueError, match="compile it with device='cpu'"):
        t_sim(ts, tc, 2, scenario=elsewhere)


def test_later_phase_classes_are_refused(graph):
    """Adversary phases without the quorum detector are refused with the
    JAX round's words. A scenario (admission waves included) under
    live-ingestion batches, once refused, runs since the serving slice
    (ROADMAP item 12): zero-count batches leave the scenario's run as it
    was, bit for bit."""
    from tpu_gossip_torch.traffic.ingest import IngestPlan, empty_batch

    tc = _cfgs()[1]
    ts = t_init(graph, tc, origins=[0], key=prng.key(0, "cpu"), device="cpu")

    def port_scenario(d):
        return tf.compile_scenario(tf.scenario_from_dict(d), n_peers=N, n_slots=N, total_rounds=40, device="cpu")

    tsc = port_scenario({"phases": [{"start": 0, "end": 4, "floods": {"ids": [1]}}]})
    with pytest.raises(ValueError, match="QuorumSpec"):
        t_sim(ts, tc, 2, scenario=tsc)
    tsc = port_scenario({"phases": [{"start": 0, "end": 4, "join_burst": 3}]})
    zero = [empty_batch(IngestPlan(msg_slots=tc.msg_slots, max_inject=2), "cpu")] * 2
    a, sa = t_sim(ts, tc, 2, scenario=tsc)
    b, sb = t_sim(ts, tc, 2, scenario=tsc, inject=zero)
    assert t_state_digest(a) == t_state_digest(b) and t_stats_digest(sa) == t_stats_digest(sb)


# ------------------------------------------------ the bucketed engine, packed

CHAOS = {"name": "chaos", "phases": [
    {"name": "lossy", "start": 0, "end": 2, "loss": 0.3, "delay": 0.3},
    {"name": "split", "start": 2, "end": 4, "partition": "half", "loss": 0.1},
    {"name": "storm", "start": 4, "end": 6, "churn_leave": 0.1, "churn_join": 0.3, "blackout": {"frac": 0.1, "seed": 9}},
]}


def _sharded(g, s, **cfg_kw):
    from tests.test_torch_dist import _build

    (jc, js, jsg, jm), (tc, ts, tsg, tm) = _build(g, s, origins=(0, 5), **cfg_kw)
    _, _, position = tdist.partition_graph(g, s, seed=1, device="cpu")
    kw = dict(n_peers=N, n_slots=tsg.n_pad, total_rounds=8, node_map=lambda ids: position[np.asarray(ids)],
              shard_ranges=tdist.shard_ranges(s, tsg.per_shard), n_shards=s)
    jsc = jf.compile_scenario(jf.scenario_from_dict(CHAOS), **kw)
    tsc = tf.compile_scenario(tf.scenario_from_dict(CHAOS), device="cpu", **kw)
    return (jc, js, jsg, jm, jsc), (tc, ts, tsg, tm, tsc)


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_flood_under_chaos_equals_local(graph, s):
    """Flood is deterministic, so the bucketed mesh (K6 receive and
    scatter) under every fault class equals the local engine on the same
    slot layout bit for bit."""
    from tpu_gossip_torch.sim.engine import simulate

    _, (tc, ts, tsg, tm, tsc) = _sharded(graph, s, mode="flood", m=8)
    fl, sl = simulate(ts, tc, 7, scenario=tsc)
    for plans in (None, tdist.build_shard_plans(tsg)):
        fd, sd = tdist.simulate_dist(ts, tc, tsg, tm, 7, plans, scenario=tsc)
        assert t_state_digest(fd) == t_state_digest(fl) and t_stats_digest(sd) == t_stats_digest(sl)
    assert int(sl.msgs_dropped.sum()) > 0 and int(sl.msgs_held.max()) > 0


@pytest.mark.parametrize("s", [1, 3])
def test_bucketed_chaos_equals_jax_mesh_and_packed_twin(graph, s):
    """push_pull on the bucketed engine under every fault class, K6
    receive: the port's run equals the JAX mesh's, and its packed twin
    equals it."""
    from tpu_gossip.dist import build_shard_plans as j_plans
    from tpu_gossip.dist import simulate_dist as j_sim_dist

    (jc, js, jsg, jm, jsc), (tc, ts, tsg, tm, tsc) = _sharded(graph, s, mode="push_pull", fanout=1, m=8)
    jfin, jst = j_sim_dist(js, jc, jsg, jm, 7, j_plans(jsg), jsc)
    plans = tdist.build_shard_plans(tsg)
    tfin, tst = tdist.simulate_dist(ts, tc, tsg, tm, 7, plans, scenario=tsc)
    assert t_state_digest(tfin) == j_state_digest(jfin) and t_stats_digest(tst) == j_stats_digest(jst)
    pfin, pst = tdist.simulate_dist(pack_state(ts), tc, tsg, tm, 7, plans, scenario=tsc)
    assert t_state_digest(unpack_state(pfin)) == t_state_digest(tfin) and t_stats_digest(pst) == t_stats_digest(tst)


def test_repartition_carries_fault_held(graph):
    """An epoch re-partition mid-scenario moves held deliveries with their
    (permuted) owners."""
    (_, _), (tc, ts) = _swarms(graph)
    _, tsc = _compile({"phases": [{"name": "slow", "start": 0, "end": 10, "delay": 0.8}]})
    mid, _ = t_sim(ts, tc, 4, scenario=tsc)
    held_rows = mid.fault_held.any(1).numpy()
    assert held_rows.any()
    _, remapped, position = tdist.repartition_swarm(mid, 4, seed=1)
    np.testing.assert_array_equal(remapped.fault_held.numpy()[position[: len(held_rows)]].any(1), held_rows)


@pytest.mark.parametrize("mode", ["push", "push_pull", "flood"])
def test_packed_equals_unpacked_under_chaos(graph, mode):
    """The packed round (word-native delivery outside the fault head, the
    bool twin inside it) equals the unpacked one and JAX's."""
    kw = dict(mode=mode) if mode == "flood" else dict(mode=mode, fanout=2)
    (jc, js), (tc, ts) = _swarms(graph, **kw)
    jsc, tsc = _compile(CHAOS)
    jfin, jst = j_sim(js, jc, 8, None, "fused", jsc)
    ufin, ust = t_sim(ts, tc, 8, scenario=tsc)
    pfin, pst = t_sim(pack_state(ts), tc, 8, scenario=tsc)
    assert t_state_digest(unpack_state(pfin)) == t_state_digest(ufin) == j_state_digest(jfin)
    assert t_stats_digest(pst) == t_stats_digest(ust) == j_stats_digest(jst)
