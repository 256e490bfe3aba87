"""Runtime fault injection: the fault plane's device half.

Ports ``RoundFaults``, ``FaultTelemetry``, ``CompiledScenario`` (with
``at_round``), ``faulted_dissemination`` (its flood replay as
:func:`flood_replay`), ``scenario_dissemination`` and ``drain_held`` of
``tpu_gossip/faults/inject.py``. A compiled scenario is a
set of per-phase tables on the device plus a per-round phase index; the
``has_*`` flags decide which fault classes a round runs at all, so an
absent class costs nothing.

Every fault draw comes from a stream of its own, ``prng.fold_in(state.rng,
FAULT_STREAM_SALT)`` split into ``(k_loss, k_delay, k_push_b, k_pull_b)``:
the protocol's 5-way split is untouched, so a quiescent scenario leaves the
scenario-free trajectory bit-identical. A scenario with a loss or delay
phase draws both ``(N, M)`` uniforms on every round of the run, quiescent
rounds included, so a draw's stream position depends only on the round.

Fault classes (the JAX package's semantics, bit for bit):

- **loss**: each delivered (receiver, slot) bit is dropped with
  probability ``loss``, on the merged incoming plane.
- **delay**: a surviving delivery is deferred with probability ``delay``
  into ``fault_held`` and offered again next round; a held bit the
  receiver has since seen leaves the buffer.
- **partition**: delivery runs once per side over side-masked transmit,
  transmitter and receptive planes, and bits that cross are discarded.
  Side B's pass runs only while a partition phase has a non-empty side B;
  the round decides that on the host from the compiled numpy tables
  whenever the round number is known there (no device synchronisation).
- **blackout**: masked rows neither send, receive nor heartbeat; the
  detector sees them as silent, and their dead declarations stay.
- **churn burst**: per-row leave/join thresholds folded into the churn
  stage's own draws.
- **flood** (an adversary class): flooders replay their whole seen rows at
  sampled targets, drawn from the adversary stream the round driver
  folds; the replay respects the partition and blackouts and rides the
  loss/delay stage. Accusers and forgers act in the liveness stage
  (``kernels/liveness.py``); every adversary class needs the quorum
  detector, and the round driver refuses them without it.

The loss/delay draws, the masks and the held-buffer merge are plain torch
on the device; the delivery they wrap runs the engine's kernels.

On a process of a mesh over several processes the planes hold its block
of rows (a ``core.rows.Rows``): :meth:`CompiledScenario.rows` cuts the row
masks to them, the loss and delay draws and the flood targets are the
block of each of the swarm's draws, the delay buffer stays with its rows,
and a flood replay reads the targets' side and blackout in the gathered
masks and lands on their holders (OR).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import ALL_ROWS
from tpu_gossip_torch.core.streams import FAULT_STREAM_SALT

__all__ = [
    "FAULT_STREAM_SALT",
    "CompiledScenario",
    "RoundFaults",
    "FaultTelemetry",
    "faulted_dissemination",
    "scenario_dissemination",
    "drain_held",
    "flood_replay",
]


class RoundFaults(NamedTuple):
    """One round's fault parameters (0-d tensors and (N,) row masks)."""

    loss: torch.Tensor  # f32: P(drop a delivered (receiver, slot) bit)
    delay: torch.Tensor  # f32: P(defer a surviving delivery one round)
    leave: torch.Tensor  # f32: extra per-round leave probability (burst rows)
    join: torch.Tensor  # f32: extra per-round rejoin probability (burst rows)
    burst: torch.Tensor  # bool (N,): rows the churn burst applies to
    blackout: torch.Tensor  # bool (N,): rows cut off from the network
    group_b: torch.Tensor  # bool (N,): partition side B
    pass_b: bool | None  # whether side B's delivery pass runs (None: read it off group_b)
    accuser: torch.Tensor | None = None  # bool (N,): rows emitting false dead-verdicts
    forger: torch.Tensor | None = None  # bool (N,): rows forging heartbeats
    flooder: torch.Tensor | None = None  # bool (N,): rows replaying their seen bitmaps
    forge_fanout: torch.Tensor | None = None  # i32: forged heartbeats per forger this round
    flood_fanout: torch.Tensor | None = None  # i32: replay targets per flooder this round
    forge_width: int = 0  # the forgers' draw width: the schedule's largest forge fanout
    join_burst: torch.Tensor | None = None  # i32: extra growth admissions this round (growth/)


class FaultTelemetry(NamedTuple):
    """Per-round fault counters for RoundStats (0-d int32)."""

    msgs_dropped: torch.Tensor  # deliveries eaten by the loss fault
    msgs_held: torch.Tensor  # deliveries sitting in the delay buffer
    msgs_delivered: torch.Tensor  # deliveries that landed this round


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledScenario:
    """A fault schedule compiled to device tables (``faults/scenario.py``).

    ``phase_of_round[o]`` maps the 0-based round offset to a row of the
    per-phase tables; row ``P`` (the last) is the quiescent row, which also
    covers every round past the schedule. ``phase_host`` is its numpy copy
    and ``pass_b_host[p]`` says whether phase ``p``'s side B has a row
    that can receive, so a round whose number is known on the host picks
    its phase and its partition branch there. The adversary and
    ``join_burst`` tables are None unless a phase uses them.
    """

    phase_host: np.ndarray  # int32 (R+1,)
    pass_b_host: np.ndarray  # bool (P+1,)
    phase_of_round: torch.Tensor  # int32 (R+1,)
    loss: torch.Tensor  # f32 (P+1,)
    delay: torch.Tensor  # f32 (P+1,)
    leave: torch.Tensor  # f32 (P+1,)
    join: torch.Tensor  # f32 (P+1,)
    burst: torch.Tensor  # bool (P+1, N)
    blackout: torch.Tensor  # bool (P+1, N)
    group_b: torch.Tensor  # bool (P+1, N)
    join_burst: torch.Tensor | None = None  # i32 (P+1,)
    accuser: torch.Tensor | None = None  # bool (P+1, N)
    forger: torch.Tensor | None = None  # bool (P+1, N)
    flooder: torch.Tensor | None = None  # bool (P+1, N)
    forge_fanout: torch.Tensor | None = None  # i32 (P+1,)
    flood_fanout: torch.Tensor | None = None  # i32 (P+1,)
    name: str = "scenario"
    has_partition: bool = False
    has_blackout: bool = False
    has_churn: bool = False
    has_loss_delay: bool = False
    has_join_burst: bool = False
    has_accusers: bool = False
    has_forgers: bool = False
    has_floods: bool = False
    max_forge_fanout: int = 0
    max_flood_fanout: int = 0
    n_rounds: int = 0

    @property
    def has_adversary(self) -> bool:
        """Any Byzantine attack class present."""
        return self.has_accusers or self.has_forgers or self.has_floods

    def rows(self, lo: int, hi: int) -> "CompiledScenario":
        """The scenario with every (P+1, N) row table cut to rows ``[lo,
        hi)``, the rows a process of a multi-process mesh holds (views;
        the phase tables, ``pass_b_host`` among them, stay the swarm's)."""
        cut = {f: getattr(self, f)[:, lo:hi] for f in _ROW_TABLES if getattr(self, f) is not None}
        return dataclasses.replace(self, **cut)

    def at_round(self, rnd) -> RoundFaults:
        """The fault parameters governing round ``rnd`` (1-based): a Python
        int (the phase is picked on the host) or a 0-d tensor on the
        tables' device (picked there). Rounds past the schedule clamp onto
        the quiescent row."""
        last = self.phase_host.shape[0] - 1
        if isinstance(rnd, torch.Tensor):
            o = torch.clamp(rnd.to(torch.int64) - 1, 0, last)
            ph = self.phase_of_round[o].to(torch.int64)
            pass_b = None
        else:
            ph = int(self.phase_host[min(max(int(rnd) - 1, 0), last)])
            pass_b = bool(self.pass_b_host[ph])
        def pick(table):
            return None if table is None else table[ph]

        return RoundFaults(
            loss=self.loss[ph], delay=self.delay[ph], leave=self.leave[ph], join=self.join[ph],
            burst=self.burst[ph], blackout=self.blackout[ph], group_b=self.group_b[ph], pass_b=pass_b,
            accuser=pick(self.accuser), forger=pick(self.forger), flooder=pick(self.flooder),
            forge_fanout=pick(self.forge_fanout), flood_fanout=pick(self.flood_fanout),
            forge_width=self.max_forge_fanout, join_burst=pick(self.join_burst),
        )


_ROW_TABLES = ("burst", "blackout", "group_b", "accuser", "forger", "flooder")


def _count(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=torch.int64).to(torch.int32)


def faulted_dissemination(scenario: CompiledScenario, rf: RoundFaults, deliver: Callable, transmit, transmitter,
                          receptive, held, seen, k_push, k_pull, k_fault, flood_ok=None, k_flood=None, rows=ALL_ROWS):
    """One round's dissemination with the scenario's faults applied.

    ``deliver(tx, transmitter, receptive, k_push, k_pull) -> (incoming,
    msgs)`` is the engine's delivery core. Returns ``(incoming, msgs_sent,
    tx_effective, new_held, telemetry)``: ``tx_effective`` is the transmit
    plane that actually left senders (blacked-out senders pushed nothing),
    ``new_held`` the delay buffer to carry. Side B's pass runs when
    ``rf.pass_b`` says so (read off the device when it is None); on a round
    whose side B is empty it would deliver nothing, so running it anyway
    changes no bit, only the launches. Under a flood phase the rows of
    ``flood_ok`` replay their whole ``seen`` rows at ``rf.flood_fanout``
    targets drawn from ``k_flood`` (:func:`flood_replay`) before the loss
    and delay stage. The planes hold ``rows`` (``core.rows``), whose block
    of each of the swarm's draws the loss and delay take."""
    k_loss, k_delay, k_push_b, k_pull_b = prng.split(k_fault, 4)

    if scenario.has_partition:
        ga, gb = ~rf.group_b, rf.group_b
        if scenario.has_blackout:
            ga, gb = ga & ~rf.blackout, gb & ~rf.blackout
        ca, cb = ga[:, None], gb[:, None]
        inc_a, msgs_a = deliver(transmit & ca, transmitter & ca, receptive & ca, k_push, k_pull)
        # graftlint: disable=round-host-sync -- without a compiled pass_b the partition's second pass is picked on the host
        pass_b = rf.pass_b if rf.pass_b is not None else bool(gb.any())
        if pass_b:
            inc_b, msgs_b = deliver(transmit & cb, transmitter & cb, receptive & cb, k_push_b, k_pull_b)
        else:
            inc_b, msgs_b = torch.zeros_like(transmit), torch.zeros((), dtype=torch.int32, device=transmit.device)
        raw = (inc_a & ca) | (inc_b & cb)
        msgs = (msgs_a.to(torch.int64) + msgs_b.to(torch.int64)).to(torch.int32)
        recv_ok = ga | gb
    elif scenario.has_blackout:
        lv = ~rf.blackout
        lc = lv[:, None]
        raw, msgs = deliver(transmit & lc, transmitter & lc, receptive & lc, k_push, k_pull)
        raw = raw & lc
        recv_ok = lv
    else:
        raw, msgs = deliver(transmit, transmitter, receptive, k_push, k_pull)
        recv_ok = None

    if scenario.has_floods:
        replay, replay_msgs = flood_replay(scenario, rf, seen, flood_ok, k_flood, rows)
        raw = raw | replay
        msgs = (msgs.to(torch.int64) + replay_msgs).to(torch.int32)

    if scenario.has_loss_delay:
        # loss: a last-hop drop on the merged delivery plane
        at = rows.lo * raw.shape[1]
        keep = prng.uniform(k_loss, tuple(raw.shape), offset=at) >= rf.loss
        dropped = _count(raw & ~keep)
        surviving = raw & keep
        # delay: held bits release only to rows that can receive now, merge
        # with the fresh deliveries and may defer again
        release = held if recv_ok is None else held & recv_ok[:, None]
        merged = surviving | release
        defer = prng.uniform(k_delay, tuple(raw.shape), offset=at) < rf.delay
        incoming = merged & ~defer
        new_held = merged & defer & ~seen
        if recv_ok is not None:
            new_held = new_held | (held & ~recv_ok[:, None])
        telem = FaultTelemetry(msgs_dropped=dropped, msgs_held=_count(new_held), msgs_delivered=_count(incoming))
    else:
        incoming, new_held = raw, held
        z = torch.zeros((), dtype=torch.int32, device=transmit.device)
        telem = FaultTelemetry(msgs_dropped=z, msgs_held=z, msgs_delivered=z)

    tx_eff = transmit & ~rf.blackout[:, None] if scenario.has_blackout else transmit
    return incoming, msgs, tx_eff, new_held, telem


def flood_replay(scenario: CompiledScenario, rf: RoundFaults, seen, flood_ok, k_flood, rows=ALL_ROWS):
    """The flood attack's traffic: each row of ``flood_ok`` sends its whole
    ``seen`` row to ``rf.flood_fanout`` of ``scenario.max_flood_fanout``
    targets drawn uniformly from ``k_flood`` (drawn every round, at full
    width, so a draw's stream position depends only on the round). A
    replay never crosses the partition and never reaches a blacked-out
    row. Returns the (N, M) plane it delivers (an OR over its targets,
    landed on the holders of ``rows``) and its bill, ``seen.sum(-1) *
    act.sum(-1)`` summed."""
    n, m = seen.shape
    n_all = rows.total(n)
    fw = scenario.max_flood_fanout
    # graftlint: disable=mem-widening-cast -- torch's index ops take int64 indices
    tgt = prng.randint(k_flood, (n, fw), 0, n_all, rows.lo * fw).to(torch.int64)
    act = flood_ok[:, None] & (torch.arange(fw, device=seen.device)[None, :] < rf.flood_fanout)
    if scenario.has_partition or scenario.has_blackout:
        group_b_all, blackout_all = rows.gather(rf.group_b, rf.blackout, label="flood")
    if scenario.has_partition:
        act = act & (group_b_all[tgt] == rf.group_b[:, None])
    if scenario.has_blackout:
        act = act & ~blackout_all[tgt]
    payload = (seen[:, None, :] & act[:, :, None]).reshape(n * fw, m)
    hits = torch.zeros((n_all, m), dtype=torch.int32, device=seen.device)
    hits.index_add_(0, tgt.reshape(-1), payload.to(torch.int32))
    bill = (seen.sum(-1, dtype=torch.int64) * act.sum(-1, dtype=torch.int64)).sum()
    return rows.reduce(hits > 0, "or", label="flood"), bill


def scenario_dissemination(scenario: CompiledScenario, state, rnd, transmit, transmitter, receptive, k_push, k_pull,
                           deliver: Callable, k_flood=None, rows=ALL_ROWS):
    """The per-round scenario head every engine shares: the round's fault
    parameters (``rnd`` is the round's 1-based number: a Python int picks
    them on the host, a 0-d tensor on the device), the fault stream
    ``fold_in(state.rng, FAULT_STREAM_SALT)`` and
    :func:`faulted_dissemination` around ``deliver``. ``state`` needs
    ``rng``, ``fault_held`` and ``seen``, and under a flood phase
    ``alive``, ``declared_dead`` and ``quarantine``: the rows that flood
    are the phase's flooders that are alive, undeclared, not quarantined
    and not blacked out. ``k_flood`` is the adversary stream's flood child
    (the round driver derives it); ``rows`` (``core.rows``) the rows the
    state holds. Returns ``(incoming, msgs_sent, tx_effective, new_held,
    telemetry, round_faults)``."""
    if scenario.blackout.device != transmit.device:
        raise ValueError(f"the scenario's tables lie on {scenario.blackout.device} but the round runs on "
                         f"{transmit.device}: compile it with device={str(transmit.device)!r}")
    rf = scenario.at_round(rnd)
    k_fault = prng.fold_in(state.rng, FAULT_STREAM_SALT)
    flood_ok = None
    if scenario.has_floods:
        flood_ok = rf.flooder & state.alive & ~state.declared_dead & ~state.quarantine
        if scenario.has_blackout:
            flood_ok = flood_ok & ~rf.blackout
    incoming, msgs, tx_eff, new_held, telem = faulted_dissemination(
        scenario, rf, deliver, transmit, transmitter, receptive, state.fault_held, state.seen, k_push, k_pull,
        k_fault, flood_ok, k_flood, rows)
    return incoming, msgs, tx_eff, new_held, telem, rf


def drain_held(state):
    """One release of the delay buffer outside any scenario (a mid-delay
    checkpoint resumed without its scenario): held deliveries merge through
    the round's receptive gate, ``infected_round`` latches at the current
    round and the buffer clears. Returns a new state."""
    from tpu_gossip_torch.core.state import saturate_round

    active = state.alive & ~state.declared_dead
    inc = state.fault_held & active[:, None] & ~state.recovered
    latch = (inc & ~state.seen) & (state.infected_round < 0)
    return dataclasses.replace(
        state,
        seen=state.seen | inc,
        infected_round=torch.where(latch, saturate_round(state.round, state.infected_round.dtype),
                                   state.infected_round),
        fault_held=torch.zeros_like(state.fault_held),
    )
