"""Campaign plans: parse a campaign TOML, compile a fleet of swarms.

A copy of ``tpu_gossip/fleet/plan.py`` (host code over numpy) whose
:func:`compile_campaign` builds the lanes' states and plans on an
explicit device. A *campaign* is a Monte Carlo certification run: K
independent swarms, the *lanes*, drawn from a sampled distribution over
fault space, run by ``fleet/engine.py`` and reduced to reliability
quantiles per scenario family by ``fleet/metrics.py``.

A campaign TOML holds one ``[campaign]`` table, one ``[base]`` run config
(every knob the lanes share) and ``[[family]]`` entries, each naming a
scenario file of the catalogue, a seed count and optional
``[[family.sweep]]`` axes::

    [campaign]
    name = "lossy-sweep"
    seed = 0

    [base]
    peers  = 96
    rounds = 30
    slots  = 4
    fanout = 2
    mode   = "push"

    [[family]]
    name     = "lossy"
    scenario = "scenarios/lossy_links.toml"
    seeds    = 32

    [[family.sweep]]
    axis = "phase.loss"
    dist = "uniform"
    lo   = 0.05
    hi   = 0.6

**The shared-static-shape rule.** Every lane shares every static property
of the JAX package's batched program: n, m, the horizon, ``max_inject``,
the fanout-table width. The sampled axes are the ones that ride values,
not shapes: fault-phase parameters, traffic rates (``max_inject`` pinned
to the largest sampled rate) and controller bounds (per-lane clamped
fanout tables over one global-width spec). An axis that would move a
static shape is refused at parse time, and after compilation every lane's
plan is checked against lane 0's structure.

**Scenario-family unification.** Families compile their scenarios
apart, then unify to one structure: per-phase tables zero-padded to the
widest phase count (padded rows are quiescent and no round names them),
the ``has_*`` flags OR-ed across lanes, absent adversary and
``join_burst`` tables made zero tables, so a lane's plans are
value-identical to its family's own compile.

**Determinism.** Lane k's root key is ``fold_in(fold_in(key(campaign
seed), FLEET_STREAM_SALT), k)`` (``core/streams.py``). Lane k of the
fleet is bit-identical (full state and integer stats) to a solo
``simulate`` of ``campaign.lane(k)``, and to lane k of the JAX package's
batched run.

The JAX package stacks the lanes' plans into one batched pytree for its
``vmap``; here :class:`CompiledCampaign` keeps them as per-lane tuples
(the lanes run in turn, ``fleet/engine.py``), and only the states are
stacked (``core.state.stack_states``).
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path

import numpy as np
import torch

from tpu_gossip_torch.core.streams import FLEET_STREAM_SALT
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.faults.scenario import ScenarioError, _parse_value, _strip_comment

__all__ = [
    "CampaignError",
    "SweepAxis",
    "FamilySpec",
    "CampaignSpec",
    "LaneInfo",
    "CompiledCampaign",
    "parse_campaign",
    "campaign_from_dict",
    "compile_campaign",
    "SWEEP_AXES",
]


class CampaignError(ValueError):
    """A campaign that cannot mean what it says (parse or compile time)."""


# the sampled axes a campaign may declare: each rides a value of a compiled
# plan, never a static shape. Anything else is refused by name.
SWEEP_AXES = (
    "phase.loss",
    "phase.delay",
    "phase.churn_leave",
    "phase.churn_join",
    "stream.rate",
    "control.lo",
    "control.hi",
    "control.target",
)

_DISTS = ("uniform", "linspace", "choice")

_BASE_KEYS = {
    "peers", "rounds", "slots", "fanout", "mode", "graph", "gamma", "m",
    "origins", "graph_seed", "forward_once", "sir_recover", "churn_leave",
    "churn_join", "rewire_slots", "coverage_target", "target_ratio",
    "stream_rate", "slot_ttl", "stream_origins", "stream_hashes",
    "control", "control_lo", "control_hi", "refresh_every",
    "grow", "grow_rate", "grow_capacity",
    "quorum_k", "suspicion_window", "accusation_budget",
}


@dataclasses.dataclass(frozen=True)
class SweepAxis:
    """One sampled axis of a family: ``axis`` in :data:`SWEEP_AXES`."""

    axis: str
    dist: str  # "uniform" | "linspace" | "choice"
    lo: float = 0.0
    hi: float = 0.0
    values: tuple[float, ...] = ()
    phase: str | None = None  # phase.* axes: scope to one named phase

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        if self.dist == "uniform":
            v = rng.uniform(self.lo, self.hi, size=n)
        elif self.dist == "linspace":
            v = np.linspace(self.lo, self.hi, num=n)
        else:  # choice: cycle deterministically over values
            v = np.asarray([self.values[i % len(self.values)] for i in range(n)], dtype=float)
        if self.axis in ("control.lo", "control.hi"):
            # bounds are integers: rounded at sampling, so the value a lane's
            # report groups by is the bound its controller ran with
            v = np.rint(v)
        return v


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """One scenario family: a catalogue entry plus its sampled axes.
    ``scenario`` is a path to a scenarios/*.toml, an inline scenario dict
    (the ``scenario_from_dict`` surface), or None for a fault-free family."""

    name: str
    scenario: str | dict | None
    seeds: int
    sweeps: tuple[SweepAxis, ...] = ()

    @property
    def scenario_label(self) -> str | None:
        """Report-facing label: the path, or an inline dict's name."""
        if isinstance(self.scenario, dict):
            return str(self.scenario.get("name", "inline"))
        return self.scenario


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A parsed, not yet compiled campaign. ``root`` is the campaign
    file's directory: family scenario paths resolve against the working
    directory first, then against ``root`` and its parents."""

    name: str
    seed: int
    base: dict
    families: tuple[FamilySpec, ...]
    root: str | None = None

    @property
    def n_lanes(self) -> int:
        return sum(f.seeds for f in self.families)


@dataclasses.dataclass(frozen=True)
class LaneInfo:
    """Host-side metadata of one compiled lane (report bookkeeping)."""

    index: int
    family: str
    seed_index: int  # the lane's index inside its family
    sampled: dict  # axis -> sampled value


@dataclasses.dataclass
class CompiledCampaign:
    """K lanes' states, stacked (every leaf with a leading lane axis), and
    their plans, one per lane (``scenario``, ``growth``, ``stream``,
    ``control``: a tuple of K plans, or None when the plane is absent for
    every lane). ``lane(k)`` hands out one lane's solo inputs."""

    name: str
    k: int
    cfg: object  # SwarmConfig shared by every lane
    rounds: int
    coverage_target: float
    target_ratio: float
    states: object  # stacked SwarmState
    scenario: tuple | None  # per-lane CompiledScenario
    growth: tuple | None  # per-lane CompiledGrowth (one shared plan)
    stream: tuple | None  # per-lane CompiledStream
    control: tuple | None  # per-lane ControlSpec
    lanes: tuple[LaneInfo, ...]
    families: tuple[FamilySpec, ...]
    base: dict
    # the quorum detector's spec is a static value shared by every lane
    liveness: object | None = None
    # set by run_campaign(keep_states=False): ``states`` then holds the
    # final states, and lane extraction refuses
    consumed: bool = False

    def lane(self, k: int):
        """(state, scenario, growth, stream, control) of lane ``k``: the
        inputs the fleet runs for that lane, so a solo ``simulate`` over
        them is the conformance oracle."""
        from tpu_gossip_torch.core.state import lane_state

        if self.consumed:
            raise CampaignError(
                "campaign states were donated by run_campaign("
                "keep_states=False) and now hold the FINAL states — "
                "extract lanes before the donating run, or run with "
                "keep_states=True"
            )
        if not 0 <= k < self.k:
            raise CampaignError(f"lane {k} outside [0, {self.k})")

        def pick(plans):
            return None if plans is None else plans[k]

        return lane_state(self.states, k), pick(self.scenario), pick(self.growth), pick(self.stream), pick(self.control)


# ------------------------------------------------------------- the parser
def _toml_tables(text: str) -> tuple[dict, dict, list[dict]]:
    """(campaign, base, families) from the campaign TOML subset:
    ``[campaign]``/``[base]`` tables, ``[[family]]`` entries, nested
    ``[[family.sweep]]`` attaching to the most recent family."""
    campaign: dict = {}
    base: dict = {}
    families: list[dict] = []
    cur: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line == "[campaign]":
            cur = campaign
        elif line == "[base]":
            cur = base
        elif line == "[[family]]":
            cur = {"sweeps": []}
            families.append(cur)
        elif line == "[[family.sweep]]":
            if not families:
                raise CampaignError(f"line {lineno}: [[family.sweep]] before any [[family]]")
            cur = {}
            families[-1]["sweeps"].append(cur)
        elif line.startswith("["):
            raise CampaignError(
                f"line {lineno}: unknown table {line!r} (campaign files "
                "hold [campaign], [base], [[family]] and [[family.sweep]])"
            )
        else:
            key, eq, value = line.partition("=")
            if not eq:
                raise CampaignError(f"line {lineno}: expected key = value")
            if cur is None:
                raise CampaignError(f"line {lineno}: key outside any table")
            try:
                cur[key.strip()] = _parse_value(value)
            except ScenarioError as e:
                raise CampaignError(f"line {lineno}: {e}") from None
    return campaign, base, families


def _sweep_axis(s: dict, where: str) -> SweepAxis:
    """One ``[[family.sweep]]`` table validated, with JAX's refusals."""
    axis = s.get("axis")
    if axis not in SWEEP_AXES:
        raise CampaignError(
            f"{where}: unknown sampled axis {axis!r} — a campaign "
            "can sample only axes that ride traced leaves (shared "
            f"static shapes across the batch): {list(SWEEP_AXES)}"
        )
    dist = s.get("dist", "uniform")
    if dist not in _DISTS:
        raise CampaignError(f"{where}: unknown dist {dist!r}; choose from {_DISTS}")
    if dist == "choice":
        vals = tuple(float(v) for v in s.get("values", ()))
        if not vals:
            raise CampaignError(f"{where}: choice needs values = [...]")
        if axis.startswith("phase.") and not all(0.0 <= v <= 1.0 for v in vals):
            raise CampaignError(
                f"{where}: {axis} samples a probability — every "
                "value must lie in [0, 1] (the report groups lanes "
                "by the sampled value, so an out-of-range sample "
                "would misreport what actually ran)"
            )
        return SweepAxis(axis=axis, dist=dist, values=vals, phase=s.get("phase"))
    if "lo" not in s or "hi" not in s:
        raise CampaignError(f"{where}: {dist} needs lo and hi")
    lo, hi = float(s["lo"]), float(s["hi"])
    if hi < lo:
        raise CampaignError(f"{where}: lo {lo} > hi {hi}")
    if axis.startswith("phase.") and not (0.0 <= lo and hi <= 1.0):
        raise CampaignError(
            f"{where}: {axis} samples a probability — lo/hi "
            f"[{lo}, {hi}] must lie inside [0, 1] (the report "
            "groups lanes by the sampled value, so a clamped "
            "sample would misreport what actually ran)"
        )
    return SweepAxis(axis=axis, dist=dist, lo=lo, hi=hi, phase=s.get("phase"))


def campaign_from_dict(d: dict, root: str | None = None) -> CampaignSpec:
    """Build a spec from a plain dict (the TOML surface, for library use):
    ``{"name", "seed", "base": {...}, "families": [{...}, ...]}``."""
    base = dict(d.get("base", {}))
    unknown = set(base) - _BASE_KEYS
    if unknown:
        raise CampaignError(f"[base]: unknown keys {sorted(unknown)} (known: {sorted(_BASE_KEYS)})")
    families = []
    for i, f in enumerate(d.get("families", ())):
        unknown = set(f) - {"name", "scenario", "seeds", "sweeps"}
        if unknown:
            raise CampaignError(f"family {i}: unknown keys {sorted(unknown)}")
        sweeps = tuple(_sweep_axis(s, f"family {i} sweep {j}") for j, s in enumerate(f.get("sweeps", ())))
        seeds = int(f.get("seeds", 0))
        if seeds < 1:
            raise CampaignError(f"family {i}: seeds must be >= 1 (got {seeds})")
        families.append(FamilySpec(name=str(f.get("name", f"family{i}")), scenario=f.get("scenario"), seeds=seeds,
                                   sweeps=sweeps))
    spec = CampaignSpec(name=str(d.get("name", "campaign")), seed=int(d.get("seed", 0)), base=base,
                        families=tuple(families), root=root)
    if not spec.families:
        raise CampaignError("campaign declares no [[family]] entries")
    names = [f.name for f in spec.families]
    if len(names) != len(set(names)):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise CampaignError(
            f"duplicate family names {dup} — lanes, scenarios and report "
            "blocks are grouped by family name, so duplicates would "
            "cross-wire them"
        )
    if spec.n_lanes < 2:
        raise CampaignError(
            f"campaign has {spec.n_lanes} lane — a one-lane campaign is a "
            "solo run (use run_sim --scenario); declare seeds >= 2 total"
        )
    if int(base.get("rounds", 0)) <= 0:
        raise CampaignError(
            "[base] needs rounds > 0 — campaigns run fixed horizons (the "
            "certification report reads per-round stats)"
        )
    return spec


def parse_campaign(source: str | Path) -> CampaignSpec:
    """Parse a campaign TOML file (or TOML text containing a newline)."""
    if isinstance(source, str) and "\n" in source:
        text, root = str(source), None
    else:
        text, root = Path(source).read_text(), str(Path(source).parent)
    campaign, base, families = _toml_tables(text)
    return campaign_from_dict({"name": campaign.get("name", "campaign"), "seed": campaign.get("seed", 0),
                               "base": base, "families": families}, root=root)


# ----------------------------------------------------------- the compiler
def _sample_lanes(spec: CampaignSpec) -> list[LaneInfo]:
    """Deterministic per-lane axis values: each (family, axis) draws from
    ``default_rng([campaign_seed, family_idx, axis_idx])``, so editing one
    family never moves another family's samples."""
    lanes: list[LaneInfo] = []
    idx = 0
    for fi, fam in enumerate(spec.families):
        values = {}
        for ai, ax in enumerate(fam.sweeps):
            values[ax.axis] = ax.sample(fam.seeds, np.random.default_rng([spec.seed, fi, ai]))
        for si in range(fam.seeds):
            lanes.append(LaneInfo(index=idx, family=fam.name, seed_index=si,
                                  sampled={a: float(v[si]) for a, v in values.items()}))
            idx += 1
    return lanes


def _override_phases(sdict: dict, axis: SweepAxis, value: float) -> None:
    """Apply a sampled phase parameter to a scenario dict (in place):
    scoped to ``axis.phase`` when named, else to every phase that declares
    the parameter (> 0), so a lane never turns a fault class on in a phase
    its family never wrote."""
    param = axis.axis.split(".", 1)[1]
    hits = 0
    for p in sdict["phases"]:
        if axis.phase is not None and p.get("name") != axis.phase:
            continue
        if axis.phase is None and not p.get(param, 0.0):
            continue
        p[param] = float(np.clip(value, 0.0, 1.0))
        hits += 1
    if hits == 0:
        where = f"phase {axis.phase!r}" if axis.phase is not None else f"any phase declaring {param!r}"
        raise CampaignError(
            f"sweep axis {axis.axis!r} matched no phase — the scenario "
            f"has no {where} (sampling it would flip a static has_* flag "
            "mid-batch)"
        )


def _scenario_dict(path: str, root: str | None) -> dict:
    """A scenario file as the dict surface ``scenario_from_dict`` takes.
    Relative paths try the cwd first, then the campaign file's directory
    and its parents."""
    from tpu_gossip_torch.faults.scenario import _toml_tables as _scenario_tables

    candidates = [Path(path)]
    if root is not None and not Path(path).is_absolute():
        r = Path(root)
        candidates += [r / path, r.parent / path, r.parent.parent / path]
    for c in candidates:
        if c.is_file():
            text = c.read_text()
            break
    else:
        raise CampaignError(f"family scenario {path!r}: no such file (tried {[str(c) for c in candidates]})")
    scenario, phases = _scenario_tables(text)
    return {"name": scenario.get("name", "scenario"), "phases": phases}


_FLAGS = ("has_partition", "has_blackout", "has_churn", "has_loss_delay", "has_join_burst", "has_accusers",
          "has_forgers", "has_floods")


def _unify_scenarios(compiled: list, name: str) -> list:
    """Pad per-lane compiled scenarios to one structure: phase tables
    zero-padded to the widest phase count, ``has_*`` flags OR-ed, the
    adversary and ``join_burst`` tables of lanes without them made zero
    tables, the static draw widths the batch maximum. Returns the per-lane
    list rebuilt with the shared structure."""
    p_max = max(c.loss.shape[0] for c in compiled)
    flags = {f: any(getattr(c, f) for c in compiled) for f in _FLAGS}
    statics = {f: max(getattr(c, f) for c in compiled) for f in ("max_forge_fanout", "max_flood_fanout")}

    def pad1(a, rows):
        if a.shape[0] >= rows:
            return a
        if isinstance(a, np.ndarray):
            return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:], dtype=a.dtype)])
        return torch.cat([a, a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))])

    def unify_opt(c, field, flag, n_cols=None, dtype=torch.int32):
        if not flags[flag]:
            return None
        a = getattr(c, field)
        if a is None:
            shape = (c.loss.shape[0],) if n_cols is None else (c.loss.shape[0], n_cols)
            a = torch.zeros(shape, dtype=dtype, device=c.loss.device)
        return pad1(a, p_max)

    out = []
    for c in compiled:
        n_cols = c.burst.shape[1]
        out.append(dataclasses.replace(
            c,
            pass_b_host=pad1(c.pass_b_host, p_max),
            loss=pad1(c.loss, p_max), delay=pad1(c.delay, p_max),
            leave=pad1(c.leave, p_max), join=pad1(c.join, p_max),
            burst=pad1(c.burst, p_max), blackout=pad1(c.blackout, p_max),
            group_b=pad1(c.group_b, p_max),
            join_burst=unify_opt(c, "join_burst", "has_join_burst"),
            accuser=unify_opt(c, "accuser", "has_accusers", n_cols, torch.bool),
            forger=unify_opt(c, "forger", "has_forgers", n_cols, torch.bool),
            flooder=unify_opt(c, "flooder", "has_floods", n_cols, torch.bool),
            forge_fanout=unify_opt(c, "forge_fanout", "has_forgers"),
            flood_fanout=unify_opt(c, "flood_fanout", "has_floods"),
            name=name,
            **flags,
            **statics,
        ))
    return out


def _plan_structure(plan) -> tuple[list, list]:
    """(structure, leaves) of a plan (a dataclass or a dict): the structure
    names each field with its static value (None-ness, ints, strings and
    bools), the leaves are its arrays (tensors and numpy tables). Floats
    are values the lanes may differ in (a stream's host rate), as JAX's
    leaves are."""
    items = (plan.items() if isinstance(plan, dict)
             else ((f.name, getattr(plan, f.name)) for f in dataclasses.fields(plan)))
    structure, leaves = [], []
    for name, v in items:
        if isinstance(v, (torch.Tensor, np.ndarray)):
            structure.append((name, "leaf"))
            leaves.append(v)
        elif isinstance(v, float):
            structure.append((name, "value"))
        else:
            structure.append((name, v))
    return structure, leaves


def _check_lane_structures(plans: list, what: str) -> None:
    """The shared-static-shape backstop: every lane's compiled plan must
    match lane 0's structure and leaf shapes and dtypes; raises
    :class:`CampaignError` naming the first divergence."""
    ref_paths, ref_leaves = _plan_structure(plans[0])
    for k, p in enumerate(plans[1:], 1):
        paths, leaves = _plan_structure(p)
        if paths != ref_paths:
            raise CampaignError(
                f"{what}: lane {k}'s plan structure differs from lane 0's "
                "— the lanes disagree on a static field (shared-static-"
                "shape rule; every lane must compile to one structure)"
            )
        for a, b in zip(ref_leaves, leaves):
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise CampaignError(
                    f"{what}: lane {k} materializes {tuple(b.shape)}/{b.dtype} "
                    f"where lane 0 has {tuple(a.shape)}/{a.dtype} — a static "
                    "shape changed across the batch"
                )


def _clamped_control(spec, lo_k: int, hi_k: int):
    """A per-lane controller bound over the global spec's table width:
    entries clamp into ``[lo_k, hi_k]``, so widening saturates at the
    lane's bound while the draw width (the static ``spec.hi``) and the
    table length stay shared. The pull mix follows the clamped values; the
    stress rung keeps its pull bit."""
    tbl = spec.fanout_table.cpu().numpy()
    clipped = np.clip(tbl, lo_k, hi_k).astype(np.int32)
    pull = clipped <= spec.base
    if spec.levels > (spec.hi - spec.lo + 1):  # stress rung present
        pull[-1] = True
    dev = spec.fanout_table.device
    return dataclasses.replace(spec, fanout_table=torch.from_numpy(clipped).to(dev),
                               pull_table=torch.from_numpy(pull).to(dev))


def _shared_graph(b: dict, seed: int, n_peers: int):
    """The campaign's one host CSR graph, from ``graph_seed``."""
    from tpu_gossip_torch.core import topology

    g_rng = np.random.default_rng(int(b.get("graph_seed", seed)))
    kind = str(b.get("graph", "pa"))
    if kind == "pa":
        return topology.build_csr(n_peers,
                                  topology.preferential_attachment(n_peers, m=int(b.get("m", 3)), rng=g_rng))
    if kind == "chung-lu":
        deg = topology.powerlaw_degree_sequence(n_peers, gamma=float(b.get("gamma", 2.5)), rng=g_rng)
        return topology.build_csr(n_peers, topology.configuration_model(deg, rng=g_rng))
    raise CampaignError(
        f"[base] graph {kind!r}: campaigns run the local engine over "
        "a host CSR ('pa' or 'chung-lu')"
    )


def _lane_scenarios(spec: CampaignSpec, lanes, rounds: int, n_peers: int, n_slots: int, grow: int, dev):
    """Each lane's compiled scenario, unified (None for a scenario-free
    campaign), and the largest ``join_burst`` any lane declares."""
    from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict

    b = spec.base
    fam_dicts = {f.name: (f.scenario if isinstance(f.scenario, dict) else _scenario_dict(f.scenario, spec.root))
                 if f.scenario else None for f in spec.families}
    with_s = [f for f in spec.families if f.scenario]
    if with_s and len(with_s) != len(spec.families):
        raise CampaignError(
            "families mix scenario and scenario-free lanes — the batch "
            "compiles ONE static structure; give every family a scenario "
            "(a quiescent one is free) or none"
        )
    if not with_s:
        return None, 0
    fam_by_name = {f.name: f for f in spec.families}
    out, max_jb = [], 0
    for lane in lanes:
        sdict = copy.deepcopy(fam_dicts[lane.family])
        for ax in fam_by_name[lane.family].sweeps:
            if ax.axis.startswith("phase."):
                _override_phases(sdict, ax, lane.sampled[ax.axis])
        try:
            sspec = scenario_from_dict(sdict)
            sspec.validate(total_rounds=rounds, n_peers=n_peers)
            if sspec.uses_join_burst and not grow:
                raise CampaignError(
                    f"family {lane.family!r}: join_burst phases are "
                    "admission waves for a growing fleet; set [base] "
                    "grow (a lane cannot grow alone — capacity is a "
                    "static shape shared by the batch)"
                )
            if sspec.uses_adversaries and not int(b.get("quorum_k", 0)):
                raise CampaignError(
                    f"family {lane.family!r}: Byzantine adversary "
                    "phases (accusers/forgers/floods) need the "
                    "quorum-defense planes; set [base] quorum_k "
                    "(quorum_k = 1 reproduces the reference's "
                    "single-report purge)"
                )
            max_jb = max(max_jb, sspec.max_join_burst)
            out.append(compile_scenario(sspec, n_peers=n_peers, n_slots=n_slots, total_rounds=rounds, device=dev))
        except ScenarioError as e:
            raise CampaignError(f"family {lane.family!r} lane {lane.seed_index}: {e}") from None
    out = _unify_scenarios(out, spec.name)
    _check_lane_structures(out, "scenario")
    return out, max_jb


def _lane_streams(spec: CampaignSpec, lanes, n_peers: int, fanout: int, mode: str, msg_slots: int, exists, dev):
    """Each lane's compiled stream (None unloaded) and the slot TTL the
    base settles (0 unloaded)."""
    from tpu_gossip_torch.traffic import StreamError, compile_stream, default_max_inject, min_feasible_ttl

    b = spec.base
    base_rate = float(b.get("stream_rate", 0.0))
    rate_axis = any(ax.axis == "stream.rate" for f in spec.families for ax in f.sweeps)
    if rate_axis and base_rate <= 0:
        raise CampaignError(
            "sweep axis 'stream.rate' needs a loaded [base] "
            "(stream_rate > 0) — the stream's static batch shape is "
            "shared by every lane"
        )
    slot_ttl = int(b.get("slot_ttl", 0))
    if base_rate <= 0:
        return None, slot_ttl
    feasible = min_feasible_ttl(n_peers, fanout, mode)
    if slot_ttl == 0:
        slot_ttl = 3 * feasible
    if slot_ttl < feasible:
        raise CampaignError(
            f"[base] slot_ttl {slot_ttl} below the feasible coverage "
            f"horizon (~{feasible} rounds) — every message would "
            "recycle before it could cover"
        )
    lane_rates = [float(lane.sampled.get("stream.rate", base_rate)) for lane in lanes]
    if min(lane_rates) < 0:
        raise CampaignError("sampled stream.rate went negative")
    origin_rows = np.flatnonzero(np.asarray(exists)) if exists is not None else np.arange(n_peers)
    # one batch shape serves every sampled rate: max_inject pins to the
    # largest lane's
    try:
        shared_inject = default_max_inject(max(lane_rates))
        out = [compile_stream(rate=r, msg_slots=msg_slots, ttl=slot_ttl, origin_rows=origin_rows,
                              origins=str(b.get("stream_origins", "uniform")), k_hashes=int(b.get("stream_hashes", 1)),
                              max_inject=shared_inject, device=dev)
               for r in lane_rates]
    except StreamError as e:
        raise CampaignError(f"[base] stream: {e}") from None
    _check_lane_structures(out, "stream")
    return out, slot_ttl


def _lane_controls(spec: CampaignSpec, lanes, cfg, fanout: int, stream_ttl: int, dev):
    """Each lane's controller (None without one): the global spec's table
    clamped to the lane's sampled bounds, its sampled target."""
    from tpu_gossip_torch.control import ControlError, compile_control

    b = spec.base
    ctl_target = float(b.get("control", 0.0))
    bound_axis = any(ax.axis in ("control.lo", "control.hi", "control.target")
                     for f in spec.families for ax in f.sweeps)
    if bound_axis and ctl_target <= 0:
        raise CampaignError(
            "sweep axes control.* need an active [base] controller "
            "(control = TARGET_RATIO) — the fanout table's static width "
            "is shared by every lane"
        )
    if ctl_target <= 0:
        return None
    lo_b = int(b.get("control_lo", 1))
    hi_b = int(b.get("control_hi", max(2 * fanout, fanout)))
    lane_bounds = []
    for lane in lanes:
        lo_k = int(round(lane.sampled.get("control.lo", lo_b)))
        hi_k = int(round(lane.sampled.get("control.hi", hi_b)))
        if not (1 <= lo_k <= fanout <= hi_k):
            raise CampaignError(
                f"lane {lane.index} ({lane.family!r}): sampled bounds "
                f"[{lo_k}, {hi_k}] must satisfy 1 <= lo <= fanout "
                f"{fanout} <= hi — the policy must express the static "
                "rate on every lane"
            )
        lane_bounds.append((lo_k, hi_k))
    lo_g = min(lo for lo, _ in lane_bounds)
    hi_g = max(hi for _, hi in lane_bounds)
    if cfg.rewire_slots > 0 and hi_g > cfg.rewire_slots:
        raise CampaignError(
            f"controller bound hi {hi_g} exceeds the re-wiring width "
            f"rewire_slots {cfg.rewire_slots} (raise rewire_slots or "
            "narrow the sweep)"
        )
    try:
        g_spec = compile_control(target_ratio=ctl_target, fanout=fanout, lo=lo_g, hi=hi_g,
                                 refresh_every=int(b.get("refresh_every", 0)), ttl=stream_ttl, device=dev)
    except ControlError as e:
        raise CampaignError(f"[base] control: {e}") from None
    out = []
    for lane, (lo_k, hi_k) in zip(lanes, lane_bounds):
        c = _clamped_control(g_spec, lo_k, hi_k)
        t = float(lane.sampled.get("control.target", ctl_target))
        if not (0.0 < t <= 1.0):
            raise CampaignError(f"lane {lane.index}: sampled control.target {t} outside (0, 1]")
        out.append(dataclasses.replace(c, target_ratio=torch.tensor(t, dtype=torch.float32, device=dev)))
    _check_lane_structures(out, "control")
    return out


def _quorum(b: dict, cfg):
    """The lane-shared QuorumSpec (None without ``quorum_k``)."""
    if int(b.get("quorum_k", 0)):
        from tpu_gossip_torch.kernels.liveness import compile_quorum

        try:
            liveness = compile_quorum(quorum_k=int(b["quorum_k"]),
                                      window=int(b.get("suspicion_window", 2 * cfg.detect_period_rounds)),
                                      budget=int(b.get("accusation_budget", 3)))
        except ValueError as e:
            raise CampaignError(f"[base] quorum: {e}") from None
        if liveness.window < cfg.detect_period_rounds:
            raise CampaignError(
                f"[base] suspicion_window {liveness.window} is shorter "
                f"than the detector sweep period "
                f"({cfg.detect_period_rounds} rounds — the PING grace): "
                "a suspicion would expire before its probe could refute"
            )
        return liveness
    if any(b.get(k) for k in ("suspicion_window", "accusation_budget")):
        raise CampaignError(
            "[base] suspicion_window/accusation_budget shape the quorum "
            "detector; set quorum_k"
        )
    return None


def compile_campaign(spec: CampaignSpec, *, device: str | torch.device = "cuda") -> CompiledCampaign:
    """Compile a validated campaign into a :class:`CompiledCampaign` on
    ``device``: the shared topology once (a per-lane graph would move the
    edge count, a static shape, so lane diversity comes from the protocol
    keys, fault parameters, traffic rates and controller bounds), every
    lane's plans, the scenarios unified, the shared-static-shape rule
    enforced, and the lanes' states stacked."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm, stack_states

    dev = resolve_device(device)
    b = spec.base
    n_peers = int(b.get("peers", 1000))
    rounds = int(b["rounds"])
    mode = str(b.get("mode", "push"))
    fanout = int(b.get("fanout", 3))
    attach_m = int(b.get("m", 3))
    grow = int(b.get("grow", 0))
    lanes = _sample_lanes(spec)

    graph = _shared_graph(b, spec.seed, n_peers)
    exists = None
    rewire_slots = int(b.get("rewire_slots", 0))
    if grow:
        from tpu_gossip_torch.growth import compile_growth, pad_graph_for_growth

        if grow <= n_peers:
            raise CampaignError(f"[base] grow {grow} must exceed peers {n_peers}")
        capacity = int(b.get("grow_capacity", grow))
        if capacity < grow:
            raise CampaignError(f"[base] grow_capacity {capacity} below the target {grow}")
        graph, exists = pad_graph_for_growth(graph, capacity)
        rewire_slots = max(rewire_slots, attach_m)
    n_slots = graph.n
    cfg = SwarmConfig(
        n_peers=n_slots, msg_slots=int(b.get("slots", 16)), fanout=fanout, mode=mode,
        forward_once=bool(b.get("forward_once", False)), sir_recover_rounds=int(b.get("sir_recover", 0)),
        churn_leave_prob=float(b.get("churn_leave", 0.0)), churn_join_prob=float(b.get("churn_join", 0.0)),
        rewire_slots=rewire_slots,
    )

    scen_lanes, max_jb = _lane_scenarios(spec, lanes, rounds, n_peers, n_slots, grow, dev)
    growth = None
    if grow:
        growth = compile_growth(
            n_initial=n_peers, target=grow, n_slots=n_slots,
            joins_per_round=int(b.get("grow_rate", 0) or max(1, -(-(grow - n_peers) // max(rounds // 2, 1)))),
            attach_m=attach_m, max_join_burst=max_jb, device=dev,
        )
    stream_lanes, slot_ttl = _lane_streams(spec, lanes, n_peers, fanout, mode, cfg.msg_slots, exists, dev)
    control_lanes = _lane_controls(spec, lanes, cfg, fanout, slot_ttl if stream_lanes is not None else 0, dev)
    liveness = _quorum(b, cfg)

    parent = prng.fold_in(prng.key(spec.seed, dev), FLEET_STREAM_SALT)
    n_origins = int(b.get("origins", 1))
    exists_t = None if exists is None else torch.from_numpy(np.asarray(exists)).to(dev)
    states = []
    for lane in lanes:
        o_rng = np.random.default_rng([spec.seed, 0x0F1E, lane.index])
        origins = o_rng.choice(n_peers, size=min(n_origins, n_peers), replace=False)
        states.append(init_swarm(graph, cfg, key=prng.fold_in(parent, lane.index), origins=origins,
                                 exists=exists_t, device=dev))

    def per_lane(plans):
        return None if plans is None else tuple(plans)

    return CompiledCampaign(
        name=spec.name, k=len(lanes), cfg=cfg, rounds=rounds,
        coverage_target=float(b.get("coverage_target", 0.99)), target_ratio=float(b.get("target_ratio", 0.9)),
        states=stack_states(states), scenario=per_lane(scen_lanes),
        growth=None if growth is None else (growth,) * len(lanes),
        stream=per_lane(stream_lanes), control=per_lane(control_lanes),
        lanes=tuple(lanes), families=spec.families, base=dict(b), liveness=liveness,
    )
