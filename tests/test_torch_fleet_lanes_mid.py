"""Lanes 7-13 of ``scenarios/campaigns/catalogue_smoke.toml`` against the
JAX package's batched run (``test_torch_fleet_lanes.py`` has the
others)."""

import pytest

from tests.test_torch_fleet_lanes import check_lane
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", range(7, 14))
def test_catalogue_lane_equals_jax(k):
    check_lane(k)
