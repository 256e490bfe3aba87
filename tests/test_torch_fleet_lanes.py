"""``scenarios/campaigns/catalogue_smoke.toml`` (every catalogued scenario
family, 3 seeds each: 21 lanes at n = 96 under the loaded, controlled,
growing and quorum-hardened base, 60 rounds) on the CPU: each lane, run
alone through the plain ``simulate`` over its compiled plans (a fleet
lane is its solo run, ``fleet/engine.py``), equals lane k of the JAX
package's batched run, state and integer stats, as pinned in
``tests/jax_pins.json``. A lane takes about 6 s here, so the 21 lanes are
split over this file (lanes 0-6) and ``test_torch_fleet_lanes_mid.py``
(7-13) and ``test_torch_fleet_lanes_last.py`` (14-20)."""

import functools

import pytest

from tpu_gossip_torch import fleet
from tests.jax_pins import pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

CATALOGUE = "scenarios/campaigns/catalogue_smoke.toml"


@functools.lru_cache(maxsize=1)
def campaign():
    return fleet.compile_campaign(fleet.parse_campaign(CATALOGUE), device="cpu")


def test_catalogue_compiles_to_jax_lanes():
    camp = campaign()
    assert camp.k == len(pinned("fleet", "catalogue")["lane_digests"]) == 21
    assert [lane.family for lane in camp.lanes[::3]] == [f.name for f in camp.families]
    flags = {f: getattr(camp.scenario[0], f) for f in ("has_partition", "has_blackout", "has_churn",
                                                         "has_loss_delay", "has_join_burst", "has_accusers")}
    assert all(flags.values()), flags  # the unified structure carries every class
    assert camp.liveness.quorum_k == 3 and camp.growth is not None


def check_lane(k: int) -> None:
    fin, stats = fleet.run_lane_solo(campaign(), k)
    want = pinned("fleet", "catalogue")
    assert fleet.state_digest(fin) == want["lane_digests"][k]
    assert fleet.stats_digest(stats) == want["stats_digests"][k]


@pytest.mark.parametrize("k", range(0, 7))
def test_catalogue_lane_equals_jax(k):
    check_lane(k)
