"""Fleet campaigns (ROADMAP item 10) against the JAX package on the CPU,
the cells of ``tests/sim/test_fleet.py`` and the fleet's adversary lane of
``tests/sim/test_adversary.py``: the 16-lane composed campaign (scenario,
stream and control on every lane, a loss sweep and a bound-and-rate
sweep), every lane's digests equal to JAX's and the sampled lanes equal to
their solo runs; the unified scenario; the report, equal to JAX's and with
its quantiles, bins and frontier; the clamped bounds; the frontier's
one-sided truth; the integral bound samples; the consumed campaign; every
parse and compile refusal in JAX's words; the fleet salt; the stacked
states; the siege lane. The JAX runs are pinned in ``tests/jax_pins.json``
(``test_torch_pipeline_pins.py`` recomputes them)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpu_gossip import fleet as jfleet
from tpu_gossip.fleet.metrics import _frontier as j_frontier
from tpu_gossip_torch import fleet
from tpu_gossip_torch.core.state import lane_state
from tests.jax_pins import MIX_CAMPAIGN, SIEGE_CAMPAIGN, composed_campaign, pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def pin(name):
    return pinned("fleet", name)


@pytest.fixture(scope="module")
def composed():
    camp = fleet.compile_campaign(fleet.campaign_from_dict(composed_campaign()), device="cpu")
    fin, stats = fleet.run_campaign(camp, keep_states=True)
    return camp, fin, stats


def assert_close(got, want, path="report"):
    """Equal JSON values, floats within 1e-6 (the report's float fields)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=0, abs_tol=1e-6), path
    else:
        assert got == want, path


def test_every_composed_lane_equals_jax(composed):
    camp, fin, stats = composed
    assert camp.k == 16
    assert [fleet.state_digest(lane_state(fin, k)) for k in range(camp.k)] == pin("composed")["lane_digests"]
    assert [fleet.stats_digest(stats, k) for k in range(camp.k)] == pin("composed")["stats_digests"]


@pytest.mark.parametrize("k", [0, 7, 13])
def test_lane_bit_identical_to_solo(composed, k):
    """Sampled lanes of both families reproduce their solo run, full state
    and the whole integer trajectory, and JAX's solo run."""
    camp, fin, stats = composed
    solo_fin, solo_stats = fleet.run_lane_solo(camp, k)
    lane = lane_state(fin, k)
    for f in dataclasses.fields(solo_fin):
        assert torch.equal(getattr(solo_fin, f.name), getattr(lane, f.name)), f"lane {k}: {f.name}"
    for name in solo_stats._fields:
        a = getattr(solo_stats, name)
        if a.dtype.is_floating_point:
            continue
        assert torch.equal(a, getattr(stats, name)[k]), f"lane {k}: {name}"
    want = pin("composed")["solo"][str(k)]
    assert fleet.state_digest(solo_fin) == want["state_digest"]
    assert fleet.stats_digest(solo_stats) == want["stats_digest"]


def test_report_equals_jax(composed):
    camp, _, stats = composed
    assert_close(fleet.campaign_report(camp, stats), pin("composed")["report"])


def test_report_has_quantiles_bins_and_frontier(composed):
    camp, _, stats = composed
    rep = fleet.campaign_report(camp, stats)
    fam = {f["family"]: f for f in rep["families"]}
    rel = fam["loss-sweep"]["reliability"]
    assert set(rel["quantiles"]) == {"p05", "p25", "p50", "p75", "p95"}
    lo, hi = rel["bootstrap_ci95_mean"]
    assert 0.0 <= lo <= hi <= 1.0
    bins = fam["loss-sweep"]["sweeps"][0]["bins"]
    assert bins and all("bootstrap_ci95_mean" in b for b in bins)
    assert sum(b["lanes"] for b in bins) == fam["loss-sweep"]["lanes_judged"]
    fr = fam["bound-sweep"]["frontier"]
    assert fr["axis"] == "control.hi"
    assert {t["value"] for t in fr["per_value"]} == {2.0, 3.0, 4.0, 5.0}


def test_clamped_control_bounds_saturate(composed):
    """A lane's clamped table never exceeds its sampled bound, and every
    lane shares one table width."""
    camp, _, _ = composed
    widths = {tuple(c.fanout_table.shape) for c in camp.control}
    assert len(widths) == 1
    for lane in camp.lanes:
        tbl = camp.control[lane.index].fanout_table
        if "control.hi" in lane.sampled:
            assert int(tbl.max()) <= int(lane.sampled["control.hi"])
        assert int(tbl.min()) >= 1


def test_unified_scenario_value_identical_to_family_compile():
    """A lossy lane batched with a partition family runs the partition
    machinery over zero tables; its trajectory equals a solo run over its
    family's own compile, and every lane equals JAX's."""
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict
    from tpu_gossip_torch.sim.engine import simulate

    camp = fleet.compile_campaign(fleet.campaign_from_dict(MIX_CAMPAIGN, root="scenarios/campaigns"), device="cpu")
    assert camp.scenario[0].has_partition and camp.scenario[0].has_loss_delay
    fin, _ = fleet.run_campaign(camp, keep_states=True)
    assert [fleet.state_digest(lane_state(fin, k)) for k in range(camp.k)] == pin("mix")["lane_digests"]
    own = compile_scenario(scenario_from_dict(fleet.plan._scenario_dict("scenarios/lossy_links.toml", None)),
                           n_peers=64, n_slots=64, total_rounds=30, device="cpu")
    assert not own.has_partition
    st0, _, _, _, _ = camp.lane(0)
    solo_fin, _ = simulate(st0, camp.cfg, camp.rounds, None, "fused", scenario=own)
    for f in ("seen", "infected_round", "alive", "declared_dead", "round"):
        assert torch.equal(getattr(solo_fin, f), getattr(fin, f)[0]), f


def test_frontier_nonmonotone_top_break_no_crash():
    args = ("control.hi", [2, 2, 3, 3, 4, 4], [0.95, 0.93, 0.92, 0.91, 0.80, 0.85], 0.9)
    fr = fleet.metrics._frontier(*args)
    assert fr == j_frontier(*args)
    assert fr["found"] and fr["last_break"] == 4.0 and fr["first_hold"] is None


def test_control_bound_samples_are_integral():
    for dist in ("uniform", "linspace"):
        ax = fleet.SweepAxis(axis="control.hi", dist=dist, lo=2, hi=5)
        jax_ax = jfleet.SweepAxis(axis="control.hi", dist=dist, lo=2, hi=5)
        v = ax.sample(16, np.random.default_rng(0))
        np.testing.assert_array_equal(v, np.rint(v))
        np.testing.assert_array_equal(v, jax_ax.sample(16, np.random.default_rng(0)))


def test_consumed_campaign_refuses_lane_extraction():
    camp = fleet.compile_campaign(fleet.campaign_from_dict(composed_campaign(seeds=4)), device="cpu")
    camp.rounds = 2
    fleet.run_campaign(camp, keep_states=False)
    assert camp.consumed and int(camp.states.round[0]) == 2
    with pytest.raises(fleet.CampaignError, match="donated"):
        camp.lane(0)
    with pytest.raises(fleet.CampaignError, match="outside"):
        fleet.compile_campaign(fleet.campaign_from_dict(composed_campaign(seeds=4)), device="cpu").lane(4)


# ------------------------------------------------------- parse refusals
PARSE_REFUSALS = {
    "single_lane": {"name": "one", "base": {"peers": 16, "rounds": 4}, "families": [{"name": "f", "seeds": 1}]},
    "duplicate_family": {"name": "dup", "base": {"peers": 16, "rounds": 4},
                         "families": [{"name": "f", "seeds": 2}, {"name": "f", "seeds": 2}]},
    "probability": {"name": "bad", "base": {"peers": 16, "rounds": 4},
                    "families": [{"name": "f", "seeds": 4, "sweeps": [{"axis": "phase.loss", "dist": "uniform",
                                                                        "lo": 0.5, "hi": 1.5}]}]},
    "choice_probability": {"name": "bad", "base": {"peers": 16, "rounds": 4},
                           "families": [{"name": "f", "seeds": 4, "sweeps": [
                               {"axis": "phase.delay", "dist": "choice", "values": [0.1, 2.0]}]}]},
    "unknown_axis": {"name": "bad", "base": {"peers": 16, "rounds": 4},
                     "families": [{"name": "f", "seeds": 4, "sweeps": [{"axis": "slots", "dist": "uniform",
                                                                         "lo": 4, "hi": 64}]}]},
    "unknown_dist": {"name": "bad", "base": {"peers": 16, "rounds": 4},
                     "families": [{"name": "f", "seeds": 4, "sweeps": [{"axis": "stream.rate", "dist": "normal",
                                                                         "lo": 1, "hi": 2}]}]},
    "unknown_base_key": {"name": "bad", "base": {"peers": 16, "rounds": 4, "tail": "pallas"},
                         "families": [{"name": "f", "seeds": 2}]},
    "no_rounds": {"name": "bad", "base": {"peers": 16}, "families": [{"name": "f", "seeds": 2}]},
    "no_family": {"name": "bad", "base": {"peers": 16, "rounds": 4}, "families": []},
    "zero_seeds": {"name": "bad", "base": {"peers": 16, "rounds": 4}, "families": [{"name": "f", "seeds": 0}]},
}


@pytest.mark.parametrize("name", list(PARSE_REFUSALS))
def test_parse_refusals_in_jax_words(name):
    with pytest.raises(jfleet.CampaignError) as want:
        jfleet.campaign_from_dict(PARSE_REFUSALS[name])
    with pytest.raises(fleet.CampaignError) as got:
        fleet.campaign_from_dict(PARSE_REFUSALS[name])
    assert str(got.value) == str(want.value)


def test_toml_reader_refusals_in_jax_words():
    for text in ("[campaign]\nname = \"x\"\n[[family.sweep]]\naxis = \"phase.loss\"\n",
                 "[campaign]\n[nope]\n", "[campaign]\nname\n", "name = 1\n"):
        with pytest.raises(jfleet.CampaignError) as want:
            jfleet.parse_campaign(text)
        with pytest.raises(fleet.CampaignError) as got:
            fleet.parse_campaign(text)
        assert str(got.value) == str(want.value)


def test_reject_mixed_static_shapes():
    """The shared-static-shape backstop names a leaf shape or a structure
    that differs across lanes."""
    a = {"x": torch.zeros(4), "y": torch.zeros(2)}
    with pytest.raises(fleet.CampaignError, match="static shape"):
        fleet.plan._check_lane_structures([a, {"x": torch.zeros(5), "y": torch.zeros(2)}], "probe")
    with pytest.raises(fleet.CampaignError, match="structure"):
        fleet.plan._check_lane_structures([a, {"x": torch.zeros(4)}], "probe")


def compile_refusal(d, root=None):
    with pytest.raises(fleet.CampaignError) as got:
        fleet.compile_campaign(fleet.campaign_from_dict(d, root=root), device="cpu")
    return str(got.value)


def test_reject_join_burst_without_grow():
    msg = compile_refusal({"name": "jb", "seed": 0, "base": {"peers": 96, "rounds": 20, "slots": 4, "fanout": 2},
                           "families": [{"name": "flash", "scenario": "scenarios/flash_crowd_under_fire.toml",
                                         "seeds": 2}]}, root="scenarios/campaigns")
    assert msg.startswith("family 'flash': join_burst phases are admission waves") and "static shape" in msg


def test_reject_sweep_matching_no_phase(tmp_path):
    scen = tmp_path / "noloss.toml"
    scen.write_text("[scenario]\nname = \"noloss\"\n[[phase]]\nname = \"p\"\nstart = 0\nend = 4\nchurn_leave = 0.1\n")
    msg = compile_refusal({"name": "miss", "seed": 0, "base": {"peers": 32, "rounds": 8, "slots": 4, "fanout": 2},
                           "families": [{"name": "f", "scenario": str(scen), "seeds": 2,
                                         "sweeps": [{"axis": "phase.loss", "dist": "uniform", "lo": 0.1,
                                                     "hi": 0.5}]}]})
    assert msg == ("sweep axis 'phase.loss' matched no phase — the scenario has no any phase declaring 'loss' "
                   "(sampling it would flip a static has_* flag mid-batch)")


def test_reject_bound_sweep_without_controller():
    msg = compile_refusal({"name": "b", "seed": 0, "base": {"peers": 32, "rounds": 8, "slots": 4, "fanout": 2},
                           "families": [{"name": "f", "seeds": 2, "sweeps": [
                               {"axis": "control.hi", "dist": "linspace", "lo": 2, "hi": 4}]}]})
    assert msg.startswith("sweep axes control.* need an active [base] controller")


def test_reject_other_compile_refusals():
    base = {"peers": 32, "rounds": 8, "slots": 4, "fanout": 2}
    assert compile_refusal({"name": "g", "base": {**base, "graph": "matching"},
                            "families": [{"name": "f", "seeds": 2}]}).startswith("[base] graph 'matching'")
    assert compile_refusal({"name": "g", "base": {**base, "grow": 16},
                            "families": [{"name": "f", "seeds": 2}]}) == "[base] grow 16 must exceed peers 32"
    assert compile_refusal({"name": "s", "base": {**base, "stream_rate": 1.0, "slot_ttl": 2},
                            "families": [{"name": "f", "seeds": 2}]}).startswith("[base] slot_ttl 2 below")
    assert compile_refusal({"name": "q", "base": {**base, "suspicion_window": 4},
                            "families": [{"name": "f", "seeds": 2}]}).startswith("[base] suspicion_window/")
    assert compile_refusal({"name": "c", "base": {**base, "control": 0.9, "rewire_slots": 2, "control_hi": 4},
                            "families": [{"name": "f", "seeds": 2}]}).startswith("controller bound hi 4 exceeds")
    assert compile_refusal({"name": "m", "base": base, "families": [
        {"name": "a", "scenario": "scenarios/lossy_links.toml", "seeds": 1}, {"name": "b", "seeds": 1}]},
        root="scenarios/campaigns").startswith("families mix scenario and scenario-free lanes")


def test_fleet_salt_registered():
    from tpu_gossip_torch.core.streams import registered_salts

    assert fleet.FLEET_STREAM_SALT == jfleet.FLEET_STREAM_SALT
    assert registered_salts()[fleet.FLEET_STREAM_SALT] == "fleet"


def test_stack_states_roundtrip():
    from tpu_gossip_torch.core import prng, topology
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm, stack_states

    g = topology.build_csr(32, topology.preferential_attachment(32, m=2, rng=np.random.default_rng(0),
                                                                use_native=False))
    cfg = SwarmConfig(n_peers=32, msg_slots=4)
    sts = [init_swarm(g, cfg, key=prng.key(k, "cpu"), origins=[k], device="cpu") for k in range(3)]
    b = stack_states(sts)
    assert tuple(b.seen.shape) == (3, 32, 4)
    assert fleet.state_digest(lane_state(b, 1)) == fleet.state_digest(sts[1])


def test_fleet_adversary_lane_bit_identical_to_solo():
    """A siege campaign (``[base] quorum_k``): the QuorumSpec is shared by
    the lanes, the adversaries draw per lane; lane 1 equals its solo run
    and JAX's, and the attack bit. Without ``quorum_k`` the campaign is
    refused."""
    no_defense = dict(SIEGE_CAMPAIGN, base={k: v for k, v in SIEGE_CAMPAIGN["base"].items()
                                            if k not in ("quorum_k", "suspicion_window", "accusation_budget")})
    assert "quorum_k" in compile_refusal(no_defense)
    camp = fleet.compile_campaign(fleet.campaign_from_dict(SIEGE_CAMPAIGN), device="cpu")
    assert camp.liveness is not None and camp.liveness.quorum_k == 3
    fin, stats = fleet.run_campaign(camp)
    fin_solo, stats_solo = fleet.run_lane_solo(camp, 1)
    assert fleet.state_digest(lane_state(fin, 1)) == fleet.state_digest(fin_solo) == pin("siege")["solo"]["1"][
        "state_digest"]
    assert fleet.stats_digest(stats, 1) == fleet.stats_digest(stats_solo)
    assert [fleet.state_digest(lane_state(fin, k)) for k in range(camp.k)] == pin("siege")["lane_digests"]
    assert int(stats.adv_accusations.sum()) == pin("siege")["adv_accusations"] > 0
