"""The fault plane: deterministic, time-phased fault injection.

Ports ``tpu_gossip/faults/``: a declarative schedule (TOML or a dict) of
message loss, delivery delay, partitions, blackouts and churn bursts
compiles to device tables (:mod:`~tpu_gossip_torch.faults.scenario`) that
every engine the port runs (the local engine, packed or not, and the
bucketed sharded engine) applies identically from a stream of its own
(:mod:`~tpu_gossip_torch.faults.inject`).
"""

from tpu_gossip_torch.faults.inject import (
    CompiledScenario,
    FaultTelemetry,
    RoundFaults,
    drain_held,
    faulted_dissemination,
    scenario_dissemination,
)
from tpu_gossip_torch.faults.scenario import (
    FaultPhase,
    NodeSet,
    ScenarioError,
    ScenarioSpec,
    compile_scenario,
    parse_scenario,
    scenario_from_dict,
)

__all__ = [
    "CompiledScenario",
    "FaultTelemetry",
    "RoundFaults",
    "drain_held",
    "faulted_dissemination",
    "scenario_dissemination",
    "FaultPhase",
    "NodeSet",
    "ScenarioError",
    "ScenarioSpec",
    "compile_scenario",
    "parse_scenario",
    "scenario_from_dict",
]
