"""The fleet engine: K independent swarms, stacked.

Ports ``tpu_gossip/fleet/engine.py``. ``simulate_fleet`` is the fleet twin
of ``sim.engine.simulate``: it takes a ``stack_states`` batch and each
lane's plans and returns the stacked final states and ``(K, rounds, ...)``
stats. The JAX package ``vmap``s the round over the lane axis, one
compiled program for every lane. Here the lanes run in turn, each through
the solo round (``sim.engine.simulate`` over its own state and plans): the
port's round launches hand-written kernels through ctypes and reads some
values on the host (a stream's arrival count, a scenario's phase), which
``torch.func.vmap`` cannot batch. A lane is therefore its solo run by
construction.

The conformance contract (``tests/sim/test_fleet.py``): lane k is
bit-identical (full state and every integer stat) to
:func:`run_lane_solo` of k and to lane k of the JAX package's batched run.
Float stats (coverage, the growth gamma track) are left out of the digest
as the JAX package leaves them out.
"""

from __future__ import annotations

import torch

from tpu_gossip_torch.utils.digest import state_digest
from tpu_gossip_torch.utils.digest import stats_digest as _stats_digest

__all__ = [
    "simulate_fleet",
    "run_campaign",
    "run_lane_solo",
    "state_digest",
    "stats_digest",
]


def simulate_fleet(state, cfg, num_rounds: int, scenario=None, growth=None, stream=None, control=None,
                   liveness=None):
    """Run K stacked swarms ``num_rounds`` rounds.

    ``state`` is a :func:`~tpu_gossip_torch.core.state.stack_states` batch;
    ``scenario``/``growth``/``stream``/``control`` are K-tuples of the
    lanes' compiled plans, or None (a plane absent for every lane);
    ``liveness`` is the lane-shared ``QuorumSpec``. Returns
    ``(final_states, stats)``, every stats field shaped
    ``(K, num_rounds, ...)``. The input batch is left as it was."""
    from tpu_gossip_torch.core.state import lane_state, stack_states
    from tpu_gossip_torch.sim.engine import RoundStats, simulate

    k = state.round.shape[0]

    def pick(plans, i):
        return None if plans is None else plans[i]

    finals, rows = [], []
    for i in range(k):
        fin, stats = simulate(lane_state(state, i), cfg, num_rounds, None, "fused", scenario=pick(scenario, i),
                              growth=pick(growth, i), stream=pick(stream, i), control=pick(control, i),
                              liveness=liveness)
        finals.append(fin)
        rows.append(stats)
    return stack_states(finals), RoundStats(*(torch.stack(col) for col in zip(*rows)))


def run_campaign(campaign, *, keep_states: bool = True):
    """Run a :class:`~tpu_gossip_torch.fleet.plan.CompiledCampaign` end to
    end; returns ``(final_states, stats)``, the stacked final states and
    the ``(K, rounds, ...)`` stats ``fleet/metrics.campaign_report``
    reduces. With ``keep_states=False`` (the JAX package's donating path)
    ``campaign.states`` is replaced by the final states and the campaign
    is marked ``consumed``, so ``campaign.lane()`` and
    :func:`run_lane_solo` refuse instead of handing out post-run state."""
    fin, stats = simulate_fleet(campaign.states, campaign.cfg, campaign.rounds, campaign.scenario, campaign.growth,
                                campaign.stream, campaign.control, campaign.liveness)
    if not keep_states:
        campaign.states = fin
        campaign.consumed = True
    return fin, stats


def run_lane_solo(campaign, k: int):
    """The conformance oracle: lane ``k`` run alone through
    ``sim.engine.simulate`` over exactly its plans. Returns
    ``(final_state, stats)``."""
    from tpu_gossip_torch.sim.engine import simulate

    st, sc, gr, sp, cp = campaign.lane(k)
    return simulate(st, campaign.cfg, campaign.rounds, None, "fused", scenario=sc, growth=gr, stream=sp,
                    control=cp, liveness=campaign.liveness)


def stats_digest(stats, k: int | None = None) -> str:
    """sha256 over the integer stats tracks (``utils.digest.stats_digest``);
    ``k`` selects one lane of stacked stats."""
    if k is not None:
        stats = type(stats)(*(f[k] for f in stats))
    return _stats_digest(stats)
