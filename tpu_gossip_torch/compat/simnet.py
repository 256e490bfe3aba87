"""SimCluster: the tpu-sim transport backend behind the PeerNode API.

Ports ``tpu_gossip/compat/simnet.py``. The north-star requirement
(BASELINE.json): the same Peer/Seed surface, but the per-process socket
loop replaced by the batched engine on the card. A SimCluster plays the
*seed* role host-side (topology construction = the power-law subset
policy, executed once as a graph build instead of per-registration
handouts) and runs all peers as rows of a
:class:`~tpu_gossip_torch.core.state.SwarmState`. One ``step()`` is one
protocol round for every peer at once (gossip fan-out + dedup + liveness),
replacing wall-clock timers with the round mapping of SURVEY.md §7.4.

The cluster holds its state by value: ``gossip``, ``set_silent``, ``kill``
and ``step`` each install a new :class:`SwarmState` and write no tensor in
place (the round shares unchanged planes between its input and output
states), so a state the caller took earlier stays as it was.
``has_seen``, ``is_declared_dead`` and ``coverage`` read one value back
from the card a call; ``step`` reads nothing back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.compat.wire import Addr
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.state import SwarmConfig, SwarmState, init_swarm, message_slots
from tpu_gossip_torch.core.topology import build_csr, preferential_attachment
from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.sim.engine import simulate

__all__ = ["SimCluster"]


class SimCluster:
    """Hosts a whole swarm of tpu-sim PeerNodes on ``device`` (the card by
    default; ``device="cpu"`` runs the plain PyTorch versions).

    Usage::

        cluster = SimCluster(msg_slots=64, fanout=3)
        peers = [PeerNode("10.0.0.%d" % i, 9000, transport="tpu-sim",
                          cluster=cluster) for i in range(1000)]
        cluster.materialize(m=3)          # power-law topology, one build
        peers[0].gossip("hello")          # infect origin
        cluster.step(20)                  # 20 batched rounds
        peers[999].has_seen("hello")      # -> True
    """

    def __init__(
        self,
        *,
        msg_slots: int = 64,
        fanout: int = 3,
        mode: str = "push",
        seed: int = 0,
        dedup_hashes: int = 1,
        device: str | torch.device = "cuda",
        **config_kw,
    ) -> None:
        if dedup_hashes < 1:
            raise ValueError("dedup_hashes must be >= 1")
        self._device = resolve_device(device)
        self._addrs: list[Addr] = []
        self._ids: dict[Addr, int] = {}
        self._msg_slots = msg_slots
        self._fanout = fanout
        self._mode = mode
        self._seed = seed
        # k > 1: Bloom-filter dedup over the same (N, M) bitmap, k hash
        # planes per message (core.state.message_slots)
        self._dedup_hashes = dedup_hashes
        self._config_kw = config_kw
        self._silent_pending: set[Addr] = set()
        self.cfg: SwarmConfig | None = None
        self.state: SwarmState | None = None
        self._graph = None

    # --- registration (the seed role's registry) ---------------------------

    def register_peer(self, addr: Addr) -> int:
        if addr in self._ids:
            raise ValueError(f"duplicate peer {addr}")
        if self.state is not None:
            raise RuntimeError("cluster already materialized; register first")
        self._ids[addr] = len(self._addrs)
        self._addrs.append(addr)
        return self._ids[addr]

    @property
    def n_peers(self) -> int:
        return len(self._addrs)

    def materialize(self, *, m: int = 3, graph=None) -> None:
        """Build the power-law topology (preferential attachment through the
        port's C++ generator) and the state on the cluster's device.

        Pass ``graph`` (a :class:`~tpu_gossip_torch.core.topology.Graph` over
        the registered peers, e.g. from ``load_graph``) to run an externally
        fixed topology: the conformance path where socket-mode and tpu-sim
        execute the SAME graph (SURVEY.md §7.4)."""
        n = len(self._addrs)
        if graph is not None:
            if graph.n != n:
                raise ValueError(f"graph has {graph.n} nodes, {n} peers registered")
            self._graph = graph
        elif n < m + 2:
            raise ValueError(f"need at least {m + 2} peers, have {n}")
        else:
            rng = np.random.default_rng(self._seed)
            self._graph = build_csr(n, preferential_attachment(n, m=m, rng=rng))
        self.cfg = SwarmConfig(
            n_peers=n,
            msg_slots=self._msg_slots,
            fanout=self._fanout,
            mode=self._mode,
            **self._config_kw,
        )
        self.state = init_swarm(self._graph, self.cfg, key=prng.key(self._seed, self._device),
                                 device=self._device)
        for addr in self._silent_pending:
            self.set_silent(addr, True)

    def _require_state(self) -> SwarmState:
        if self.state is None:
            raise RuntimeError("call materialize() first")
        return self.state

    def _id(self, addr: Addr) -> int:
        return self._ids[addr]

    def _slots(self, text: str) -> tuple[int, ...]:
        return message_slots(text, self._msg_slots, self._dedup_hashes)

    # --- the PeerNode-facing API -------------------------------------------

    def gossip(self, addr: Addr, text: str) -> None:
        st = self._require_state()
        i = self._id(addr)
        seen, infected = st.seen.clone(), st.infected_round.clone()
        stamp = st.round.to(torch.int16)
        for slot in self._slots(text):
            seen[i, slot] = True
            # record the first-infection round unless already infected (-1 =
            # never; the engine gates SIR recovery on infected_round >= 0)
            infected[i, slot] = torch.where(infected[i, slot] < 0, stamp, infected[i, slot])
        self.state = dataclasses.replace(st, seen=seen, infected_round=infected)

    def has_seen(self, addr: Addr, text: str) -> bool:
        st = self._require_state()
        return bool(st.seen[self._id(addr), list(self._slots(text))].all())

    def set_silent(self, addr: Addr, value: bool) -> None:
        if self.state is None:
            (self._silent_pending.add if value else self._silent_pending.discard)(addr)
            return
        silent = self.state.silent.clone()
        silent[self._id(addr)] = value
        self.state = dataclasses.replace(self.state, silent=silent)

    def kill(self, addr: Addr) -> None:
        """Crash a peer (connection-dropping death, vs silent-mode)."""
        st = self._require_state()
        alive = st.alive.clone()
        alive[self._id(addr)] = False
        self.state = dataclasses.replace(st, alive=alive)

    def is_declared_dead(self, addr: Addr) -> bool:
        st = self._require_state()
        return bool(st.declared_dead[self._id(addr)])

    def neighbors(self, addr: Addr) -> list[Addr]:
        if self._graph is None:
            raise RuntimeError("call materialize() first")
        return sorted(self._addrs[j] for j in self._graph.neighbors(self._id(addr)))

    # --- round loop ---------------------------------------------------------

    def step(self, rounds: int = 1):
        """Advance every peer ``rounds`` protocol rounds (batched on the
        device); returns stacked per-round RoundStats (fields shaped
        (rounds,))."""
        st = self._require_state()
        self.state, stats = simulate(st, self.cfg, rounds)
        return stats

    def coverage(self, text: str) -> float:
        st = self._require_state()
        slots = self._slots(text)
        if len(slots) == 1:
            return float(st.coverage(slots[0]))
        live = st.alive & ~st.declared_dead
        got = st.seen[:, list(slots)].all(dim=1) & live
        return float(got.sum().to(torch.float32) / torch.clamp(live.sum(), min=1).to(torch.float32))
