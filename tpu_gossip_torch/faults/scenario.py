"""Declarative fault scenarios: parse, validate, compile to device tables.

A copy of ``tpu_gossip/faults/scenario.py`` (host code over numpy) whose
:func:`compile_scenario` builds torch tables on an explicit device. A
scenario is a time-phased fault schedule: named phases over disjoint
round ranges, each enabling some mix of message loss, delivery delay, a
two-group partition, node blackouts and churn bursts, authored as TOML
(or an equivalent dict)::

    [scenario]
    name = "split-brain"

    [[phase]]
    name  = "partition"
    start = 5          # phase covers rounds 6..20 (0-based offsets 5..19)
    end   = 20
    partition = "half" # group B = upper half of peer ids

Phase ``start``/``end`` are 0-based round offsets, half-open: a phase
``[s, e)`` governs the rounds that take ``state.round`` from ``s`` to
``e``. Phases must be disjoint and fit inside the run's horizon. Rounds
no phase claims, and every round past the schedule, are quiescent: no
faults, held deliveries drain.

Node sets (``partition``, ``blackout``, ``churn_nodes``) are declared over
real peer ids ``[0, n_peers)`` and resolved to state rows at compile time
through the engine's layout (``node_map``, the bucketed mesh's
``position``), so one scenario file runs identically on every engine:
``"all"``, ``"half"`` (the upper half of peer ids), ``{ids = [...]}``,
``{frac = f, seed = s}`` (drawn by ``np.random.default_rng(seed).choice``),
``{span = [lo, hi]}`` (a contiguous id range by fraction) and
``{shards = [...]}`` (whole mesh shards, sharded runs only).

The reader handles the restricted TOML subset scenarios use:
``[scenario]``, ``[[phase]]``, scalar values, arrays and one-level inline
tables. The adversary phase keys (``accusers``, ``forgers``, ``floods``)
and ``join_burst`` parse and compile as in the JAX package: the quorum
detector (``kernels/liveness.py``) runs the first, the growth stage
(``growth/``) reads the second as admission waves.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

import torch

from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.faults.inject import CompiledScenario

__all__ = [
    "ScenarioError",
    "NodeSet",
    "FaultPhase",
    "ScenarioSpec",
    "parse_scenario",
    "scenario_from_dict",
    "compile_scenario",
]


class ScenarioError(ValueError):
    """A scenario file that cannot mean what it says (parse/validate time)."""


# --------------------------------------------------------------- the spec
@dataclasses.dataclass(frozen=True)
class NodeSet:
    """A declarative peer set, resolved to a row mask at compile time."""

    kind: str  # "all" | "half" | "ids" | "frac" | "span" | "shards"
    ids: tuple[int, ...] = ()
    frac: float = 0.0
    seed: int = 0
    span: tuple[float, float] = (0.0, 0.0)
    shards: tuple[int, ...] = ()

    def covers_all(self, n_peers: int, n_shards: int | None) -> bool:
        """True when the set provably selects every peer — in any spelling
        (``"all"``, ``frac=1.0``, a full span, an exhaustive id list, every
        shard), so degenerate partitions can't sneak past validation."""
        if self.kind == "all":
            return True
        if self.kind == "frac":
            return int(round(self.frac * n_peers)) >= n_peers
        if self.kind == "span":
            lo, hi = self.span
            return int(lo * n_peers) == 0 and int(hi * n_peers) >= n_peers
        if self.kind == "ids":
            return len(set(self.ids)) >= n_peers
        if self.kind == "shards" and n_shards is not None:
            return set(self.shards) >= set(range(n_shards))
        return False

    def validate(self, n_peers: int, n_shards: int | None, where: str) -> None:
        if self.kind not in ("all", "half", "ids", "frac", "span", "shards"):
            raise ScenarioError(f"{where}: unknown node-set kind {self.kind!r}")
        if self.kind == "ids":
            bad = [i for i in self.ids if not 0 <= i < n_peers]
            if bad:
                raise ScenarioError(
                    f"{where}: peer ids {bad} outside [0, {n_peers})"
                )
        if self.kind == "frac" and not 0.0 <= self.frac <= 1.0:
            raise ScenarioError(f"{where}: frac {self.frac} outside [0, 1]")
        if self.kind == "span":
            lo, hi = self.span
            if not (0.0 <= lo < hi <= 1.0):
                raise ScenarioError(
                    f"{where}: span {self.span} must satisfy 0 <= lo < hi <= 1"
                )
        if self.kind == "shards":
            if n_shards is None:
                raise ScenarioError(
                    f"{where}: names mesh shards, but this run is not "
                    "sharded (use --shard, or a frac/span/ids set)"
                )
            bad = [s for s in self.shards if not 0 <= s < n_shards]
            if bad:
                raise ScenarioError(
                    f"{where}: shard ids {bad} outside [0, {n_shards})"
                )

    def resolve(
        self,
        n_peers: int,
        n_slots: int,
        node_map,
        shard_ranges: list[tuple[int, int]] | None,
    ) -> np.ndarray:
        """(n_slots,) bool row mask for this set under the engine layout."""
        mask = np.zeros(n_slots, dtype=bool)
        if self.kind == "shards":
            for s in self.shards:
                lo, hi = shard_ranges[s]
                mask[lo:hi] = True
            return mask
        if self.kind == "all":
            ids = np.arange(n_peers)
        elif self.kind == "half":
            ids = np.arange(n_peers // 2, n_peers)
        elif self.kind == "ids":
            ids = np.asarray(self.ids, dtype=np.int64)
        elif self.kind == "frac":
            rng = np.random.default_rng(self.seed)
            k = int(round(self.frac * n_peers))
            ids = rng.choice(n_peers, size=min(k, n_peers), replace=False)
        else:  # span
            lo, hi = self.span
            ids = np.arange(int(lo * n_peers), int(hi * n_peers))
        if node_map is not None and len(ids):
            ids = np.asarray(node_map(np.asarray(ids, dtype=np.int64)))
        mask[ids] = True
        return mask


ALL_NODES = NodeSet(kind="all")


@dataclasses.dataclass(frozen=True)
class FaultPhase:
    """One schedule entry: a round range and the faults it enables."""

    name: str
    start: int  # 0-based round offset, inclusive
    end: int  # exclusive
    loss: float = 0.0
    delay: float = 0.0
    churn_leave: float = 0.0
    churn_join: float = 0.0
    churn_nodes: NodeSet = ALL_NODES
    partition: NodeSet | None = None  # group B of the split
    blackout: NodeSet | None = None
    # admission wave (growth/): extra joins per round ON TOP of the
    # active growth schedule's rate — composes churn storms with growth
    # bursts. Requires a growing run (run_sim rejects it without --grow).
    join_burst: int = 0
    # Byzantine adversaries (docs/adversarial_model.md) — require the
    # quorum-defense planes (run_sim rejects them without --quorum-k):
    # ``accusers`` emit one false dead-verdict per round each against a
    # uniformly sampled live victim (the reference's single-report purge
    # vulnerability, Seed.py:358-406); ``forgers`` emit ``forge_fanout``
    # forged heartbeats per round each on behalf of sampled peers,
    # stalling detection of the genuinely dead; ``floods`` replay each
    # flooder's full seen bitmap at ``flood_fanout`` sampled targets per
    # round — duplicate pressure on the dedup/Bloom plane (and on the
    # AIMD controller's duplicate-saturation feedback).
    accusers: NodeSet | None = None
    forgers: NodeSet | None = None
    floods: NodeSet | None = None
    forge_fanout: int = 2
    flood_fanout: int = 2


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A parsed, not-yet-compiled scenario."""

    name: str
    phases: tuple[FaultPhase, ...]

    @property
    def last_round(self) -> int:
        return max((p.end for p in self.phases), default=0)

    @property
    def max_join_burst(self) -> int:
        """Largest per-round admission wave any phase adds — sizes the
        growth engine's static batch shape (growth/plan.compile_growth)."""
        return max((p.join_burst for p in self.phases), default=0)

    @property
    def uses_join_burst(self) -> bool:
        return any(p.join_burst for p in self.phases)

    @property
    def uses_adversaries(self) -> bool:
        """True when any phase fields Byzantine adversaries — such
        scenarios need the quorum-defense planes compiled in (run_sim
        rejects them without ``--quorum-k``)."""
        return any(
            p.accusers is not None or p.forgers is not None
            or p.floods is not None
            for p in self.phases
        )

    @property
    def max_forge_fanout(self) -> int:
        """Static draw width for the forgery scatter (0 = no forgers)."""
        return max(
            (p.forge_fanout for p in self.phases if p.forgers is not None),
            default=0,
        )

    @property
    def max_flood_fanout(self) -> int:
        """Static draw width for the flood scatter (0 = no floods)."""
        return max(
            (p.flood_fanout for p in self.phases if p.floods is not None),
            default=0,
        )

    @property
    def uses_node_sets(self) -> bool:
        """True when any phase scopes a fault to a proper peer subset —
        such masks are fixed in the initial slot layout and do NOT survive
        an epoch re-partition (``--shard --remat-every``)."""
        return any(
            p.partition is not None
            or p.blackout is not None
            or p.accusers is not None
            or p.forgers is not None
            or p.floods is not None
            or (p.churn_nodes.kind != "all" and (p.churn_leave or p.churn_join))
            for p in self.phases
        )

    def validate(
        self,
        *,
        total_rounds: int,
        n_peers: int,
        n_shards: int | None = None,
    ) -> None:
        """Reject impossible schedules BEFORE anything runs: phases past
        the horizon, overlapping phases, out-of-range probabilities or
        node sets, empty/total partitions."""
        if not self.phases:
            raise ScenarioError("scenario has no phases")
        for p in self.phases:
            w = f"phase {p.name!r}"
            if p.start < 0 or p.end <= p.start:
                raise ScenarioError(
                    f"{w}: round range [{p.start}, {p.end}) is empty or "
                    "negative"
                )
            if p.end > total_rounds:
                raise ScenarioError(
                    f"{w}: ends at round {p.end}, beyond the run's horizon "
                    f"of {total_rounds} rounds — a schedule the run can "
                    "never reach is a config error, not a no-op"
                )
            for field in ("loss", "delay", "churn_leave", "churn_join"):
                v = getattr(p, field)
                if not 0.0 <= v <= 1.0:
                    raise ScenarioError(
                        f"{w}: {field}={v} outside [0, 1]"
                    )
            if p.join_burst < 0:
                raise ScenarioError(
                    f"{w}: join_burst={p.join_burst} must be >= 0"
                )
            p.churn_nodes.validate(n_peers, n_shards, f"{w}.churn_nodes")
            if p.partition is not None:
                p.partition.validate(n_peers, n_shards, f"{w}.partition")
                if p.partition.covers_all(n_peers, n_shards):
                    raise ScenarioError(
                        f"{w}: partition group B covers every peer — group "
                        "A would be empty and the 'partition' a silent "
                        "no-op (use blackout to cut everyone off)"
                    )
            if p.blackout is not None:
                p.blackout.validate(n_peers, n_shards, f"{w}.blackout")
            for adv in ("accusers", "forgers", "floods"):
                ns = getattr(p, adv)
                if ns is None:
                    continue
                ns.validate(n_peers, n_shards, f"{w}.{adv}")
                if ns.covers_all(n_peers, n_shards):
                    raise ScenarioError(
                        f"{w}: {adv} covers every peer — an all-adversary "
                        "swarm has no honest protocol left to attack "
                        "(scope the set below the full membership)"
                    )
            if p.forgers is not None and p.forge_fanout < 1:
                raise ScenarioError(
                    f"{w}: forge_fanout={p.forge_fanout} must be >= 1 when "
                    "the phase fields forgers"
                )
            if p.floods is not None and p.flood_fanout < 1:
                raise ScenarioError(
                    f"{w}: flood_fanout={p.flood_fanout} must be >= 1 when "
                    "the phase fields floods"
                )
        ordered = sorted(self.phases, key=lambda p: (p.start, p.end))
        for a, b in zip(ordered, ordered[1:]):
            if b.start < a.end:
                raise ScenarioError(
                    f"phases {a.name!r} [{a.start}, {a.end}) and {b.name!r} "
                    f"[{b.start}, {b.end}) overlap — which phase governs "
                    f"round {b.start + 1} is ambiguous"
                )


# ------------------------------------------------------------- the parser
def _parse_value(s: str):
    s = s.strip()
    if s.startswith("{") and s.endswith("}"):
        body = s[1:-1].strip()
        out = {}
        for part in _split_top(body, ","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            if not _:
                raise ScenarioError(f"bad inline-table entry {part!r}")
            out[k.strip()] = _parse_value(v)
        return out
    if s.startswith("[") and s.endswith("]"):
        body = s[1:-1].strip()
        return [_parse_value(p) for p in _split_top(body, ",") if p.strip()]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in ("'", '"'):
        return s[1:-1]
    if s in ("true", "false"):
        return s == "true"
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        raise ScenarioError(f"cannot parse value {s!r}") from None


def _split_top(s: str, sep: str) -> list[str]:
    """Split on ``sep`` outside brackets/braces/quotes (one level deep)."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def _strip_comment(raw: str) -> str:
    quote = None
    for i, ch in enumerate(raw):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return raw[:i]
    return raw


def _toml_tables(text: str) -> tuple[dict, list[dict]]:
    """(scenario_table, phase_tables) from the scenario TOML subset."""
    scenario: dict = {}
    phases: list[dict] = []
    cur: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if line == "[scenario]":
            cur = scenario
        elif line == "[[phase]]":
            cur = {}
            phases.append(cur)
        elif line.startswith("["):
            raise ScenarioError(
                f"line {lineno}: unknown table {line!r} (scenario files "
                "hold one [scenario] table and [[phase]] entries)"
            )
        else:
            key, eq, value = line.partition("=")
            if not eq:
                raise ScenarioError(f"line {lineno}: expected key = value")
            if cur is None:
                raise ScenarioError(
                    f"line {lineno}: key outside any table"
                )
            cur[key.strip()] = _parse_value(value)
    return scenario, phases


def _node_set(v, where: str) -> NodeSet:
    if isinstance(v, NodeSet):
        return v
    if isinstance(v, str):
        if v in ("all", "half"):
            return NodeSet(kind=v)
        raise ScenarioError(f"{where}: unknown node-set keyword {v!r}")
    if not isinstance(v, dict):
        raise ScenarioError(f"{where}: expected a node-set table, got {v!r}")
    keys = set(v) - {"seed"}
    if keys == {"ids"}:
        return NodeSet(kind="ids", ids=tuple(int(i) for i in v["ids"]))
    if keys == {"frac"}:
        return NodeSet(
            kind="frac", frac=float(v["frac"]), seed=int(v.get("seed", 0))
        )
    if keys == {"span"}:
        lo, hi = v["span"]
        return NodeSet(kind="span", span=(float(lo), float(hi)))
    if keys == {"shards"}:
        return NodeSet(kind="shards", shards=tuple(int(s) for s in v["shards"]))
    raise ScenarioError(
        f"{where}: node set needs exactly one of ids/frac/span/shards, "
        f"got keys {sorted(v)}"
    )


_PHASE_KEYS = {
    "name", "start", "end", "loss", "delay", "churn_leave", "churn_join",
    "churn_nodes", "partition", "blackout", "join_burst",
    "accusers", "forgers", "floods", "forge_fanout", "flood_fanout",
}


def scenario_from_dict(d: dict) -> ScenarioSpec:
    """Build a spec from a plain dict (the TOML surface, for library use).

    ``{"name": ..., "phases": [{...}, ...]}`` with phase dicts carrying
    the TOML keys."""
    phases = []
    for i, p in enumerate(d.get("phases", ())):
        unknown = set(p) - _PHASE_KEYS
        if unknown:
            raise ScenarioError(
                f"phase {i}: unknown keys {sorted(unknown)} (known: "
                f"{sorted(_PHASE_KEYS)})"
            )
        if "start" not in p or "end" not in p:
            raise ScenarioError(f"phase {i}: start and end are required")
        name = str(p.get("name", f"phase{i}"))
        phases.append(
            FaultPhase(
                name=name,
                start=int(p["start"]),
                end=int(p["end"]),
                loss=float(p.get("loss", 0.0)),
                delay=float(p.get("delay", 0.0)),
                churn_leave=float(p.get("churn_leave", 0.0)),
                churn_join=float(p.get("churn_join", 0.0)),
                churn_nodes=_node_set(
                    p.get("churn_nodes", ALL_NODES), f"phase {name!r}.churn_nodes"
                ),
                partition=(
                    None
                    if p.get("partition") is None
                    else _node_set(p["partition"], f"phase {name!r}.partition")
                ),
                blackout=(
                    None
                    if p.get("blackout") is None
                    else _node_set(p["blackout"], f"phase {name!r}.blackout")
                ),
                join_burst=int(p.get("join_burst", 0)),
                accusers=(
                    None if p.get("accusers") is None
                    else _node_set(p["accusers"], f"phase {name!r}.accusers")
                ),
                forgers=(
                    None if p.get("forgers") is None
                    else _node_set(p["forgers"], f"phase {name!r}.forgers")
                ),
                floods=(
                    None if p.get("floods") is None
                    else _node_set(p["floods"], f"phase {name!r}.floods")
                ),
                forge_fanout=int(p.get("forge_fanout", 2)),
                flood_fanout=int(p.get("flood_fanout", 2)),
            )
        )
    return ScenarioSpec(
        name=str(d.get("name", "scenario")), phases=tuple(phases)
    )


def parse_scenario(source: str | Path) -> ScenarioSpec:
    """Parse a scenario TOML file (or TOML text containing a newline)."""
    text = (
        str(source)
        if isinstance(source, str) and "\n" in source
        else Path(source).read_text()
    )
    scenario, phases = _toml_tables(text)
    return scenario_from_dict(
        {"name": scenario.get("name", "scenario"), "phases": phases}
    )


# ----------------------------------------------------------- the compiler
def compile_scenario(
    spec: ScenarioSpec,
    *,
    n_peers: int,
    n_slots: int,
    total_rounds: int,
    node_map=None,
    shard_ranges: list[tuple[int, int]] | None = None,
    n_shards: int | None = None,
    device: str | torch.device = "cuda",
) -> CompiledScenario:
    """Compile a validated spec to the device tables the engines consume.

    ``n_peers`` is the REAL peer count (node sets are declared over it),
    ``n_slots`` the state row count (pads included), ``node_map`` an
    optional peer-id→row mapping (the bucketed mesh's ``position``, the
    sharded matching row formula), ``shard_ranges`` the per-shard
    ``(row_lo, row_hi)`` spans for shard-scoped sets. Validates as a
    precondition — callers that already validated pay a cheap re-check.
    The tables are built in numpy, kept on the host for the round's
    host-side decisions (which phase governs a round, whether the
    partition's second pass runs) and copied once to ``device``.
    """
    spec.validate(
        total_rounds=total_rounds, n_peers=n_peers, n_shards=n_shards
    )
    dev = resolve_device(device)

    n_ph = len(spec.phases)
    phase_of_round = np.full(total_rounds + 1, n_ph, dtype=np.int32)
    loss = np.zeros(n_ph + 1, dtype=np.float32)
    delay = np.zeros(n_ph + 1, dtype=np.float32)
    leave = np.zeros(n_ph + 1, dtype=np.float32)
    join = np.zeros(n_ph + 1, dtype=np.float32)
    jburst = np.zeros(n_ph + 1, dtype=np.int32)
    burst = np.zeros((n_ph + 1, n_slots), dtype=bool)
    blackout = np.zeros((n_ph + 1, n_slots), dtype=bool)
    group_b = np.zeros((n_ph + 1, n_slots), dtype=bool)
    has_acc = any(p.accusers is not None for p in spec.phases)
    has_forge = any(p.forgers is not None for p in spec.phases)
    has_flood = any(p.floods is not None for p in spec.phases)
    accuser = np.zeros((n_ph + 1, n_slots), dtype=bool)
    forger = np.zeros((n_ph + 1, n_slots), dtype=bool)
    flooder = np.zeros((n_ph + 1, n_slots), dtype=bool)
    forge_fo = np.zeros(n_ph + 1, dtype=np.int32)
    flood_fo = np.zeros(n_ph + 1, dtype=np.int32)

    for i, p in enumerate(spec.phases):
        phase_of_round[p.start : p.end] = i
        loss[i] = p.loss
        delay[i] = p.delay
        leave[i] = p.churn_leave
        join[i] = p.churn_join
        jburst[i] = p.join_burst
        if p.churn_leave or p.churn_join:
            burst[i] = p.churn_nodes.resolve(
                n_peers, n_slots, node_map, shard_ranges
            )
        if p.partition is not None:
            group_b[i] = p.partition.resolve(
                n_peers, n_slots, node_map, shard_ranges
            )
        if p.blackout is not None:
            blackout[i] = p.blackout.resolve(
                n_peers, n_slots, node_map, shard_ranges
            )
        if p.accusers is not None:
            accuser[i] = p.accusers.resolve(
                n_peers, n_slots, node_map, shard_ranges
            )
        if p.forgers is not None:
            forger[i] = p.forgers.resolve(
                n_peers, n_slots, node_map, shard_ranges
            )
            forge_fo[i] = p.forge_fanout
        if p.floods is not None:
            flooder[i] = p.floods.resolve(
                n_peers, n_slots, node_map, shard_ranges
            )
            flood_fo[i] = p.flood_fanout

    pass_b = group_b & ~blackout if any(p.blackout is not None for p in spec.phases) else group_b

    def _dev(a):
        return torch.from_numpy(a).to(dev)

    return CompiledScenario(
        phase_host=phase_of_round,
        pass_b_host=pass_b.any(axis=1),
        phase_of_round=_dev(phase_of_round),
        loss=_dev(loss),
        delay=_dev(delay),
        leave=_dev(leave),
        join=_dev(join),
        burst=_dev(burst),
        blackout=_dev(blackout),
        group_b=_dev(group_b),
        join_burst=_dev(jburst) if spec.uses_join_burst else None,
        accuser=_dev(accuser) if has_acc else None,
        forger=_dev(forger) if has_forge else None,
        flooder=_dev(flooder) if has_flood else None,
        forge_fanout=_dev(forge_fo) if has_forge else None,
        flood_fanout=_dev(flood_fo) if has_flood else None,
        name=spec.name,
        has_partition=any(p.partition is not None for p in spec.phases),
        has_blackout=any(p.blackout is not None for p in spec.phases),
        has_churn=any(p.churn_leave or p.churn_join for p in spec.phases),
        has_loss_delay=any(p.loss or p.delay for p in spec.phases),
        has_join_burst=spec.uses_join_burst,
        has_accusers=has_acc,
        has_forgers=has_forge,
        has_floods=has_flood,
        max_forge_fanout=spec.max_forge_fanout,
        max_flood_fanout=spec.max_flood_fanout,
        n_rounds=total_rounds,
    )
