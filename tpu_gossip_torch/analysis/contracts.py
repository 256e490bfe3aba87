"""The contract audit: shape and dtype contracts over the entry matrix.

Every entry of ``entrypoints.py`` runs once on the device it is given and
its declared contract is asserted:

- the output state carries exactly the input's planes, each with the
  input's shape and dtype (the round is a fixed point of the state: a
  loop's carry, a checkpoint's resume and a fleet's stacked lanes rest on
  it), and a packed state keeps its static ``msg_slots``;
- ``RoundStats`` has every declared field at its declared dtype, scalars
  but the per-slot tracks (``(M,)``), under the entry's leading shape
  (``(rounds,)`` from ``simulate``, ``(lanes, rounds)`` from the fleet);
- the sparse and hier entries' ``IciRound`` counters are 0-d int64 (the
  JAX package's are int32; the port counts in int64).

Each problem is one ``contract-audit`` finding, anchored on its check and
entry. On a card the entries launch the real kernels (K1-K6).
"""

from __future__ import annotations

import dataclasses

from tpu_gossip_torch.analysis.entrypoints import entry_points, run_matrix
from tpu_gossip_torch.analysis.registry import Finding

__all__ = ["STATS_DECLARED", "audit_contracts", "check_entry", "msg_slots_of", "state_specs"]

# field -> (dtype name, trailing shape; "M" is the message slots)
STATS_DECLARED = {
    "coverage": ("float32", ()), "msgs_sent": ("int32", ()), "n_infected": ("int32", ()),
    "n_alive": ("int32", ()), "n_declared_dead": ("int32", ()), "msgs_dropped": ("int32", ()),
    "msgs_held": ("int32", ()), "msgs_delivered": ("int32", ()), "n_members": ("int32", ()),
    "degree_gamma": ("float32", ()), "stream_offered": ("int32", ()), "stream_injected": ("int32", ()),
    "stream_conflated": ("int32", ()), "stream_expired": ("int32", ()), "slot_infected": ("int32", ("M",)),
    "slot_age": ("int32", ("M",)), "control_level": ("int32", ()), "control_fanout": ("int32", ()),
    "msgs_duplicate": ("int32", ()), "control_refreshed": ("int32", ()), "evictions_new": ("int32", ()),
    "false_evictions": ("int32", ()), "n_quarantined": ("int32", ()), "dead_undeclared": ("int32", ()),
    "adv_accusations": ("int32", ()), "adv_forged": ("int32", ()), "ingest_offered": ("int32", ()),
    "ingest_injected": ("int32", ()), "ingest_conflated": ("int32", ()), "ingest_overflow": ("int32", ()),
}
ICI_DTYPE = "int64"


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def state_specs(state) -> dict:
    """field -> (shape, dtype name) of a state's tensors, or the value of
    a static field."""
    import torch

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = (tuple(v.shape), _dtype(v)) if isinstance(v, torch.Tensor) else v
    return out


def _diff_state(name: str, got, want, problems: list) -> None:
    if type(got) is not type(want):
        problems.append(f"{name}: output state is a {type(got).__name__}, input a {type(want).__name__}")
        return
    g, w = state_specs(got), state_specs(want)
    for field in w:
        if g[field] != w[field]:
            problems.append(f"{name}: plane {field} drifted: got {g[field]}, input {w[field]}")


def _stats_contract(name: str, stats, problems: list, leading=(), msg_slots: int | None = None) -> None:
    for field, (dt, trailing) in STATS_DECLARED.items():
        leaf = getattr(stats, field, None)
        if leaf is None:
            problems.append(f"{name}: RoundStats lost field {field!r}")
            continue
        want = tuple(leading) + tuple(msg_slots if t == "M" else t for t in trailing)
        if tuple(leaf.shape) != want:
            problems.append(f"{name}: RoundStats.{field} shape {tuple(leaf.shape)} != declared {want}")
        if _dtype(leaf) != dt:
            problems.append(f"{name}: RoundStats.{field} dtype {_dtype(leaf)} != declared {dt}")


def _ici_contract(name: str, ici, problems: list) -> None:
    from tpu_gossip_torch.dist import transport as tp

    for field in tp.IciRound._fields:
        leaf = getattr(ici, field, None)
        if leaf is None:
            problems.append(f"{name}: IciRound lost field {field!r}")
        elif tuple(leaf.shape) != () or _dtype(leaf) != ICI_DTYPE:
            problems.append(f"{name}: IciRound.{field} {tuple(leaf.shape)}/{_dtype(leaf)} != declared "
                            f"scalar {ICI_DTYPE}")


def msg_slots_of(state) -> int:
    """M of a state: the packed state's static field, else seen's last axis."""
    return getattr(state, "msg_slots", 0) or int(state.seen.shape[-1])


def check_entry(ran) -> list:
    """The contract problems of one run entry."""
    ep, name = ran.ep, ran.ep.name
    if ran.error is not None:
        return [f"{name}: entry failed to run: {ran.error}"]
    problems: list[str] = []
    out, ici = ran.out, None
    if ep.has_ici:
        out_st, out_stats, ici = out
    elif ep.stats_leading is None:
        out_st, out_stats = out, None
    else:
        out_st, out_stats = out
    _diff_state(name, out_st, ran.state, problems)
    if out_stats is not None:
        _stats_contract(name, out_stats, problems, ep.stats_leading, msg_slots_of(ran.state))
    if ici is not None:
        _ici_contract(name, ici, problems)
    return problems


def audit_contracts(device, names=None, cache: dict | None = None) -> list[Finding]:
    """Run the matrix (or the entries ``names``) on ``device`` and turn
    every contract problem into a finding. ``cache`` shares the runs with
    the memory tier."""
    eps = [ep for ep in entry_points() if names is None or ep.name in names]
    findings: list[Finding] = []
    for name, ran in run_matrix(eps, device, cache=cache).items():
        for p in check_entry(ran):
            findings.append(Finding(
                file=f"<contract:{ran.ep.audit_check}>", line=0, col=0, rule="contract-audit", message=p,
                hint="declared contracts live in tpu_gossip_torch/analysis/contracts.py: fix the entry point or "
                "change the declaration with the behaviour",
                qualname=f"{ran.ep.audit_check}.{name}"))
    return findings
