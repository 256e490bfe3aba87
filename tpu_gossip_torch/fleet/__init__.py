"""Fleet campaigns: K seeded swarms under sampled scenarios, certified.

Ports ``tpu_gossip/fleet/``. ``fleet/plan.py`` compiles a campaign TOML
(a base run config and sampled axes over scenario families) into a
:class:`CompiledCampaign` of K lanes sharing every static shape;
``fleet/engine.py`` runs the lanes, each bit-identical to its solo run;
``fleet/metrics.py`` reduces the per-lane trajectories to certification
reports: reliability quantiles with bootstrap confidence intervals per
scenario family, rounds-to-coverage distributions and contract-break
frontiers of swept controller bounds.
"""

from tpu_gossip_torch.core.streams import FLEET_STREAM_SALT
from tpu_gossip_torch.fleet.engine import run_campaign, run_lane_solo, simulate_fleet, state_digest, stats_digest
from tpu_gossip_torch.fleet.metrics import campaign_report, lane_stats
from tpu_gossip_torch.fleet.plan import (
    SWEEP_AXES,
    CampaignError,
    CampaignSpec,
    CompiledCampaign,
    FamilySpec,
    SweepAxis,
    campaign_from_dict,
    compile_campaign,
    parse_campaign,
)

__all__ = [
    "FLEET_STREAM_SALT",
    "CampaignError",
    "CampaignSpec",
    "CompiledCampaign",
    "FamilySpec",
    "SweepAxis",
    "SWEEP_AXES",
    "campaign_from_dict",
    "compile_campaign",
    "parse_campaign",
    "simulate_fleet",
    "run_campaign",
    "run_lane_solo",
    "state_digest",
    "stats_digest",
    "campaign_report",
    "lane_stats",
]
