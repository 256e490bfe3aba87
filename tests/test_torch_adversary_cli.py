"""The port's CLI under ``--quorum-k`` against the JAX CLI's: every refusal
of ``--quorum-k``, ``--suspicion-window`` and ``--accusation-budget`` with
the JAX CLI's first stderr line and exit 2, the ``liveness`` summary block,
the siege (``scenarios/byzantine_siege.toml``) on every engine the port
runs at n=2000 (summary, ``liveness`` and ``phases`` blocks, digests and
rows), a checkpoint cut inside the siege with suspicions open finished by
the other package, and the quorum cases of
``tests/conformance/test_liveness_band.py``. The summary cell's and the
engines' JAX halves are pinned in ``tests/jax_pins.json`` (group
``adversary_cli``), one of them rechecked in a child process."""

import json
import shutil

import numpy as np
import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests import jax_pins
from tests.test_torch_churn_cli import TIMING, one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests.test_torch_growth_cli_engines import jax_in_child
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
    at 96 peers, quorum 3 with the settled defaults (JAX's summary pinned
    in ``tests/jax_pins.json``, group ``adversary_cli``)."""
    toml, argv = jax_pins.ADV_SUMMARY
    want = jax_pins.pinned("adversary_cli", "summary_cell")["summary"]
    got, _ = _summary(capsys, tcli.main, [*argv, "--scenario", jax_pins.adv_toml(str(tmp_path / "adv.toml"), **toml),
                                          "--device", "cpu"])
    assert got == want
    lv = got["liveness"]
    assert (lv["quorum_k"], lv["suspicion_window"], lv["accusation_budget"]) == (3, 4, 3)
    assert lv["accusations"] > 0 and lv["eviction_precision"] is not None


BASE = jax_pins.ADV_BASE
PATHS = jax_pins.ADV_PATHS  # name: extra argv (phase 9 of chip_smoke.py, shrunk)


@pytest.mark.parametrize("name", list(PATHS))
def test_quorum_cli_summary_and_rows_equal_jax(capsys, one_shard, name):
    """Each engine's siege against the JAX CLI's summary and rows, pinned in
    ``tests/jax_pins.json`` (group ``adversary_cli``, the JAX mesh on one
    device)."""
    argv = BASE + PATHS[name]
    pin = jax_pins.pinned("adversary_cli", name)
    want, want_rows = dict(pin["summary"]), pin["rows"]
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


def test_jax_pins_are_current():
    """One case of the group recomputed by the JAX CLI in a child process."""
    name = "summary_cell"
    got = jax_in_child("tests.jax_pins", "compute", "adversary_cli", [name])
    assert got == {name: jax_pins.pinned("adversary_cli", name)}


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
