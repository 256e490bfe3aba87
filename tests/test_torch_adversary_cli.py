"""The port's CLI under ``--quorum-k`` against the JAX CLI's: every refusal
of ``--quorum-k``, ``--suspicion-window`` and ``--accusation-budget`` with
the JAX CLI's first stderr line and exit 2, the ``liveness`` summary block,
the siege (``scenarios/byzantine_siege.toml``) on every engine the port
runs at n=2000 (summary, ``liveness`` and ``phases`` blocks, digests and
rows), a checkpoint cut inside the siege with suspicions open finished by
the other package, and the quorum cases of
``tests/conformance/test_liveness_band.py``."""

import json
import shutil

import numpy as np
import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests.test_torch_churn_cli import TIMING, one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

SIEGE = ["--scenario", "scenarios/byzantine_siege.toml"]
ADV_TOML = ('[scenario]\nname = "adv"\n\n[[phase]]\nname = "a"\nstart = 0\nend = {end}\n'
            "accusers = {{frac = 0.05, seed = 1}}\n{extra}")


def _toml(tmp_path, end=4, extra=""):
    p = tmp_path / "adv.toml"
    p.write_text(ADV_TOML.format(end=end, extra=extra))
    return str(p)


REJECTIONS = {  # name: argv after --peers 64 --rounds 6 (tests/sim/test_adversary.py's, then the scenario's)
    "window_without_quorum": ["--suspicion-window", "4"],
    "budget_without_quorum": ["--accusation-budget", "2"],
    "quorum_0": ["--quorum-k", "0"],
    "quorum_negative": ["--quorum-k", "-3"],
    "window_below_grace": ["--quorum-k", "2", "--suspicion-window", "1"],
    "budget_past_cap": ["--quorum-k", "2", "--accusation-budget", "200"],
    "quorum_past_cap": ["--quorum-k", "256"],
    "profile_round": ["--quorum-k", "2", "--profile-round", "3"],
    "adversaries_without_quorum": ["SCENARIO"],
    "window_with_adversaries": ["SCENARIO", "--suspicion-window", "4"],
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_cli_quorum_rejections_say_what_jax_says(capsys, tmp_path, name):
    extra = [a for b in REJECTIONS[name] for a in (["--scenario", _toml(tmp_path)] if b == "SCENARIO" else [b])]
    argv = ["--peers", "64", "--rounds", "6", *extra]
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err.strip().splitlines()
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()
    assert got and got[0] == want[0]


def test_cli_liveness_summary_block_equals_jax(capsys, tmp_path):
    """tests/sim/test_adversary.py's summary cell: accusers and a blackout
    at 96 peers, quorum 3 with the settled defaults."""
    argv = ["--peers", "96", "--rounds", "16", "--quiet", "--quorum-k", "3", "--graph", "chung-lu", "--digest",
            "--scenario", _toml(tmp_path, end=8, extra="blackout = {frac = 0.1, seed = 2}\n")]
    want, _ = _summary(capsys, jcli.main, argv)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert got == want
    lv = got["liveness"]
    assert (lv["quorum_k"], lv["suspicion_window"], lv["accusation_budget"]) == (3, 4, 3)
    assert lv["accusations"] > 0 and lv["eviction_precision"] is not None


BASE = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--digest", "--seed", "3", "--quorum-k", "3"]
CHURN = ["--churn-leave", "0.01", "--churn-join", "0.1", "--rewire-slots", "2"]
PATHS = {  # name: extra argv (phase 9 of chip_smoke.py, shrunk)
    "siege_matching": ["--graph", "matching", *SIEGE, "--rounds", "56"],
    "siege_matching_k1": ["--graph", "matching", *SIEGE, "--rounds", "56", "--quorum-k", "1"],
    "siege_matching_packed": ["--graph", "matching", "--packed", *SIEGE, "--rounds", "56", "--quiet"],
    "siege_staircase": ["--graph", "chung-lu", "--staircase", *SIEGE, "--rounds", "56", "--quiet"],
    "siege_exactly_k_churn_compact": ["--graph", "chung-lu", *SIEGE, *CHURN, "--rewire-compact-cap", "64",
                                      "--rounds", "56", "--quiet"],
    "siege_shard_k6": ["--graph", "chung-lu", "--shard", "--staircase", *SIEGE, "--rounds", "56", "--quiet"],
    "siege_shard_scatter_churn": ["--graph", "chung-lu", "--shard", *SIEGE, *CHURN, "--rounds", "56", "--quiet"],
    "siege_local_remat": ["--graph", "chung-lu", "--staircase", *SIEGE, *CHURN, "--remat-every", "14",
                          "--rounds", "56", "--quiet"],
    "silent_shard_remat": ["--graph", "chung-lu", "--shard", "--silent-frac", "0.05", *CHURN, "--remat-every", "8",
                           "--rounds", "24", "--quiet", "--suspicion-window", "6", "--accusation-budget", "0"],
    "siege_to_target": ["--graph", "matching", *SIEGE, "--max-rounds", "60", "--quiet"],
    "siege_shard_to_target": ["--graph", "chung-lu", "--shard", "--staircase", *SIEGE, "--max-rounds", "60",
                              "--quiet"],
    "silent_shard_remat_to_target": ["--graph", "chung-lu", "--shard", "--silent-frac", "0.05", *CHURN,
                                     "--remat-every", "8", "--max-rounds", "40", "--quiet"],
}


@pytest.mark.parametrize("name", list(PATHS))
def test_quorum_cli_summary_and_rows_equal_jax(capsys, one_shard, name):
    argv = BASE + PATHS[name]
    want, want_rows = _summary(capsys, jcli.main, argv)
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in TIMING:
        assert (k in got) == (k in want), k
        got.pop(k, None), want.pop(k, None)
    assert got == want
    assert [json.loads(r) for r in got_rows] == [json.loads(r) for r in want_rows]
    if name != "silent_shard_remat_to_target":  # the JAX CLI's sharded remat target row has no block
        assert got["liveness"]["quorum_k"] == (1 if name == "siege_matching_k1" else 3)
    if "--rounds" in argv and "--scenario" in argv:
        lv = got["liveness"]
        assert lv["accusations"] > 0 and lv["forged_heartbeats"] > 0
        if "--remat-every" not in argv:  # a remat row carries the scenario's name alone, as JAX's
            assert got["phases"]
        if name == "siege_matching_k1":
            assert lv["false_evictions"] > 0 and lv["quarantined"] == 0
        else:
            assert lv["eviction_precision"] >= 0.95 and lv["quarantined"] > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mid_siege_checkpoint_resumes_across_packages(capsys, tmp_path, writer):
    """The siege checkpointed every 4 rounds; the checkpoints past round 8
    are dropped, so the other package resumes inside the siege with
    suspicions open and strikes accrued, and ends on the writer's
    uninterrupted digests, ``liveness`` and ``phases`` blocks."""
    from tpu_gossip_torch.ckpt import load_checkpoint

    argv = BASE + ["--graph", "matching", *SIEGE, "--rounds", "56", "--quiet", "--checkpoint-every", "4",
                   "--checkpoint-dir", str(tmp_path / "ck")]
    write, finish = (jcli.main, tcli.main) if writer == "jax" else (tcli.main, jcli.main)
    full, _ = _summary(capsys, write, argv + ([] if writer == "jax" else ["--device", "cpu"]))
    for late in range(12, 56, 4):
        shutil.rmtree(tmp_path / "ck" / f"ckpt-{late:08d}")
    mid = load_checkpoint(tmp_path / "ck" / "ckpt-00000008", device="cpu")[0]
    assert bool((mid.suspect_round >= 0).any()) and bool((mid.suspect_mark >= 256).any())
    assert finish(["resume", str(tmp_path / "ck")] + (["--device", "cpu"] if writer == "jax" else [])) == 0
    out = capsys.readouterr()
    assert "resume: ckpt-00000008 at round 8" in out.err
    resumed = json.loads(out.out.strip().splitlines()[-1])
    for k in ("state_digest", "stats_digest", "liveness", "scenario", "phases", "total_msgs", "final_coverage"):
        assert resumed[k] == full[k], k


@pytest.mark.parametrize("quorum_k", [2, 3, 7])
def test_quorum_detection_stays_inside_reference_band(quorum_k):
    """tests/conformance/test_liveness_band.py's quorum cases on the port:
    the round constants derived from the scaled ProtocolTiming, 50 silent
    of 500 peers, every one declared at round 8 (40 s of reference time,
    inside the 30-42 s band), no responsive peer declared, and the run
    equal to JAX's."""
    import jax
    import jax.numpy as jnp
    import torch

    from tpu_gossip.compat.timing import ProtocolTiming
    from tpu_gossip.core.state import SwarmConfig as JConfig
    from tpu_gossip.core.state import init_swarm as j_init
    from tpu_gossip.core.topology import build_csr, preferential_attachment
    from tpu_gossip.fleet.engine import stats_digest as j_stats_digest
    from tpu_gossip.kernels.liveness import compile_quorum as j_quorum
    from tpu_gossip.sim.engine import simulate as j_sim
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig as TConfig
    from tpu_gossip_torch.core.state import init_swarm as t_init
    from tpu_gossip_torch.kernels.liveness import compile_quorum as t_quorum
    from tpu_gossip_torch.sim.engine import simulate as t_sim
    from tpu_gossip_torch.utils.digest import stats_digest as t_stats_digest

    n, silent = 500, 50
    t = ProtocolTiming().scaled(0.01)
    kw = dict(n_peers=n, msg_slots=4, fanout=3, mode="push", hb_period_rounds=round(t.heartbeat_period / t.gossip_period),
              timeout_rounds=round(t.heartbeat_timeout / t.gossip_period),
              detect_period_rounds=round(t.detect_period / t.gossip_period), round_seconds=t.gossip_period)
    assert (kw["hb_period_rounds"], kw["timeout_rounds"], kw["detect_period_rounds"]) == (3, 6, 2)
    g = build_csr(n, preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(7)))
    ids = np.random.default_rng(7).choice(n, size=silent, replace=False)
    js = j_init(g, JConfig(**kw), origins=[0], key=jax.random.key(0))
    js.silent = js.silent.at[jnp.asarray(ids)].set(True)
    ts = t_init(g, TConfig(**kw), origins=[0], key=prng.key(0, "cpu"), device="cpu")
    ts.silent[torch.as_tensor(ids)] = True
    _, jst = j_sim(js, JConfig(**kw), 12, None, "fused", None, None, None, None, None,
                   j_quorum(quorum_k, window=4, budget=3))
    fin, st = t_sim(ts, TConfig(**kw), 12, liveness=t_quorum(quorum_k, window=4, budget=3))
    assert t_stats_digest(st) == j_stats_digest(jst)
    dead = st.n_declared_dead.numpy()
    assert dead[-1] == silent and not (fin.declared_dead.numpy() & ~np.isin(np.arange(n), ids)).any()
    secs = (int(np.nonzero(dead >= silent)[0][0]) + 1) * ProtocolTiming().gossip_period
    assert 30.0 <= secs <= 42.0
