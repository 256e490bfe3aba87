"""Certification reports: per-lane trajectories to fleet-level statistics.

A copy of ``tpu_gossip/fleet/metrics.py`` (host numpy over the fetched
stats). It reduces the ``(K, rounds, ...)`` stats of a fleet run to:

- reliability quantiles with a bootstrap 95% confidence interval of the
  mean per scenario family, and per bin of a swept fault-phase or stream
  axis;
- rounds-to-coverage distributions (each lane's p50 and p99, distributed
  over the family);
- the contract-break frontier of a swept controller bound.

Each lane is judged by ``sim.metrics.reliability_report``, the code path
a solo run is certified by. The bootstrap's generator is seeded as the JAX
package seeds it (``default_rng([bootstrap_seed, K])``) and draws in the
same order, so the report equals JAX's.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "lane_stats",
    "campaign_report",
]

_QUANTILES = (5, 25, 50, 75, 95)
_BOOTSTRAP = 500


def lane_stats(stats, k: int):
    """Lane ``k``'s ``(rounds, ...)`` slice of stacked ``(K, rounds, ...)``
    stats, the shape every ``sim.metrics`` report reads."""
    return type(stats)(*(f[k] for f in stats))


def _quantile_block(values: np.ndarray, rng: np.random.Generator) -> dict:
    """Quantiles and a bootstrap 95% CI of the mean over one lane set."""
    v = np.asarray(values, dtype=np.float64)
    boot = np.asarray([rng.choice(v, size=v.size, replace=True).mean() for _ in range(_BOOTSTRAP)])
    return {
        "lanes": int(v.size),
        "mean": round(float(v.mean()), 4),
        "quantiles": {f"p{q:02d}": round(float(np.percentile(v, q)), 4) for q in _QUANTILES},
        "bootstrap_ci95_mean": [round(float(np.percentile(boot, 2.5)), 4), round(float(np.percentile(boot, 97.5)), 4)],
    }


def _frontier(axis: str, values, ratios, target: float) -> dict:
    """The contract-break frontier of a swept controller bound: lanes
    grouped by bound value, each value held or broken by its mean delivery
    ratio against ``target``. ``found`` is True when the sweep located a
    break (some value breaks, some holds); ``first_hold`` is the smallest
    holding value above the last break."""
    values = np.asarray(values, dtype=np.float64)
    ratios = np.asarray(ratios, dtype=np.float64)
    table = []
    for v in np.unique(values):
        r = ratios[values == v]
        table.append({
            "value": round(float(v), 4),
            "lanes": int(r.size),
            "delivery_ratio_mean": round(float(r.mean()), 4),
            "holds": bool(r.mean() >= target),
        })
    breaks = [t["value"] for t in table if not t["holds"]]
    holds = [t["value"] for t in table if t["holds"]]
    above = [v for v in holds if not breaks or v > max(breaks)]
    return {
        "axis": axis,
        "target_ratio": float(target),
        "per_value": table,
        "found": bool(breaks and holds),
        "last_break": max(breaks) if breaks else None,
        "first_hold": min(above) if above else None,
    }


def _lane_row(lane, rep: dict) -> dict:
    return {
        "lane": lane.index,
        "family": lane.family,
        "sampled": lane.sampled,
        "delivery_ratio": rep["delivery_ratio"],
        "holds": rep["holds"],
        "messages_judged": rep["messages_judged"],
        "msgs_per_delivered_infection": rep["msgs_per_delivered_infection"],
        "rounds_to_coverage": rep["rounds_to_coverage"],
        "peak_coverage": rep["peak_coverage"],
    }


def _sweep_blocks(fam, judged, ratios, target: float, bins: int, rng) -> tuple[list, list]:
    """A family's per-bin blocks of each swept phase or stream axis
    (``bins`` equal-width bins over the realized range) and the frontiers
    of its swept ``control.*`` axes."""
    sweep_blocks, frontiers = [], []
    for ax in fam.sweeps:
        vals = np.asarray([r["sampled"][ax.axis] for r in judged])
        if not judged:
            continue
        if ax.axis.startswith("control."):
            frontiers.append(_frontier(ax.axis, vals, ratios, target))
            continue
        lo, hi = float(vals.min()), float(vals.max())
        edges = np.linspace(lo, hi, num=min(bins, len(judged)) + 1)
        bin_rows = []
        for i in range(len(edges) - 1):
            sel = (vals >= edges[i]) & (vals <= edges[i + 1] if i == len(edges) - 2 else vals < edges[i + 1])
            if not sel.any():
                continue
            bin_rows.append({"range": [round(float(edges[i]), 4), round(float(edges[i + 1]), 4)],
                             **_quantile_block(ratios[sel], rng)})
        sweep_blocks.append({"axis": ax.axis, "dist": ax.dist, "bins": bin_rows})
    return sweep_blocks, frontiers


def campaign_report(campaign, stats, *, bins: int = 4, bootstrap_seed: int = 0) -> dict:
    """The certification report of one campaign run.

    ``stats`` is :func:`~tpu_gossip_torch.fleet.engine.run_campaign`'s
    stacked stats. Per family: each lane's reliability judgment, the
    family's delivery-ratio quantile block with a bootstrap CI and the
    verdicts (``holds``: the mean clears the target; ``certified``: the
    CI's lower bound does), the rounds-to-coverage distributions, per-bin
    blocks of each swept phase or stream axis, and the frontier of each
    swept ``control.*`` axis. Deterministic: the bootstrap is seeded."""
    from tpu_gossip_torch.sim import metrics as SM

    rng = np.random.default_rng([bootstrap_seed, campaign.k])
    per_lane = [_lane_row(lane, SM.reliability_report(lane_stats(stats, lane.index),
                                                      target_ratio=campaign.target_ratio,
                                                      coverage_target=campaign.coverage_target))
                for lane in campaign.lanes]

    families = []
    for fam in campaign.families:
        rows = [r for r in per_lane if r["family"] == fam.name]
        # a lane whose horizon judged nothing is vacuous: left out of the
        # quantiles, counted
        judged = [r for r in rows if r["delivery_ratio"] is not None]
        ratios = np.asarray([r["delivery_ratio"] for r in judged])
        block = {
            "family": fam.name,
            "scenario": fam.scenario_label,
            "lanes": len(rows),
            "lanes_judged": len(judged),
            "target_ratio": campaign.target_ratio,
            "coverage_target": campaign.coverage_target,
        }
        if judged:
            rel = _quantile_block(ratios, rng)
            rel["holds_fraction"] = round(float(np.mean([r["holds"] for r in judged])), 4)
            rel["holds"] = bool(rel["mean"] >= campaign.target_ratio)
            rel["certified"] = bool(rel["bootstrap_ci95_mean"][0] >= campaign.target_ratio)
            block["reliability"] = rel
            p50s = [r["rounds_to_coverage"]["p50"] for r in judged if r["rounds_to_coverage"]["p50"] is not None]
            p99s = [r["rounds_to_coverage"]["p99"] for r in judged if r["rounds_to_coverage"]["p99"] is not None]
            block["rounds_to_coverage"] = {
                "p50_over_lanes": _quantile_block(np.asarray(p50s), rng) if p50s else None,
                "p99_over_lanes": _quantile_block(np.asarray(p99s), rng) if p99s else None,
            }
        sweep_blocks, frontiers = _sweep_blocks(fam, judged, ratios, campaign.target_ratio, bins, rng)
        if sweep_blocks:
            block["sweeps"] = sweep_blocks
        if frontiers:
            block["frontier"] = frontiers[0]
            if len(frontiers) > 1:
                block["frontiers"] = frontiers
        families.append(block)

    return {
        "campaign": campaign.name,
        "lanes": campaign.k,
        "rounds": campaign.rounds,
        "n_peers": int(campaign.base.get("peers", 0)),
        "families": families,
        "lanes_detail": per_lane,
    }
