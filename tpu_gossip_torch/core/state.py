"""SwarmState: the whole gossip swarm as one dataclass of device tensors.

Ports ``ROUND_CAP``, ``saturate_round``, ``SwarmConfig``, ``SwarmState``
(every one of its 25 planes, in the JAX field order, which is the
``state_digest`` leaf order), ``coverage``, ``init_swarm`` (:783) and
``clone_state`` of ``tpu_gossip/core/state.py``; the message hashes
``message_slot`` and ``message_slots`` (:728, :747, host FNV-1a); the plane registry
(``PlaneSpec``, ``PLANES``, ``plane_registry``, :110-198) and the helpers
the checkpoint store stands on (``cast_to_declared``,
``validate_state_planes``, ``zero_suspicion``, ``stack_states``,
``lane_state``); the registry's pricing, ``state_plane_bytes`` and
``state_bytes_per_peer`` (:207, :251); and the flat npz checkpoint, ``save_swarm`` (:450) and
``load_swarm`` (:484), which reads every generation the JAX loader reads.
The load helpers work on host numpy arrays; a loaded state lands on
``device`` once, at the end.

Planes keep the JAX dtypes: bool masks, int16 round-valued planes
saturated at :data:`ROUND_CAP`, int32 ids and counters. The PRNG key is an
int64 (2,) tensor of uint32 words (core/prng.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.topology import Graph
from tpu_gossip_torch.device import resolve_device

__all__ = [
    "ROUND_CAP",
    "saturate_round",
    "SwarmConfig",
    "SwarmState",
    "init_swarm",
    "clone_state",
    "message_slot",
    "message_slots",
    "PlaneSpec",
    "PLANES",
    "plane_registry",
    "state_plane_bytes",
    "state_bytes_per_peer",
    "cast_to_declared",
    "validate_state_planes",
    "zero_suspicion",
    "state_from_host",
    "stack_states",
    "lane_state",
    "save_swarm",
    "load_swarm",
]

ROUND_CAP = 2**15 - 1


def saturate_round(rnd: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A round cursor narrowed into a round-valued plane: saturated at
    :data:`ROUND_CAP`, cast to ``dtype``."""
    return torch.clamp(rnd, max=ROUND_CAP).to(dtype)


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    """Static protocol parameters (the JAX package's defaults)."""

    n_peers: int
    msg_slots: int = 64
    fanout: int = 3
    hb_period_rounds: int = 3
    timeout_rounds: int = 6
    detect_period_rounds: int = 2
    round_seconds: float = 5.0
    forward_once: bool = False
    sir_recover_rounds: int = 0
    mode: str = "push"
    churn_leave_prob: float = 0.0
    churn_join_prob: float = 0.0
    rewire_slots: int = 0
    rewire_compact_cap: int = 0

    def __post_init__(self):
        if self.n_peers <= 0:
            raise ValueError("n_peers must be positive")
        if self.msg_slots <= 0:
            raise ValueError("msg_slots must be positive")
        if self.mode not in ("push", "push_pull", "flood"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.rewire_compact_cap < 0:
            raise ValueError("rewire_compact_cap must be >= 0")


@dataclasses.dataclass
class SwarmState:
    """Every plane of the swarm. Shapes: N peers, D edge slots, M slots,
    S rewire slots. Field order is the JAX package's."""

    row_ptr: torch.Tensor  # int32 (N+1,)
    col_idx: torch.Tensor  # int32 (D,)
    seen: torch.Tensor  # bool (N, M)
    forwarded: torch.Tensor  # bool (N, M)
    infected_round: torch.Tensor  # int16 (N, M)
    recovered: torch.Tensor  # bool (N, M)
    exists: torch.Tensor  # bool (N,)
    alive: torch.Tensor  # bool (N,)
    silent: torch.Tensor  # bool (N,)
    last_hb: torch.Tensor  # int16 (N,)
    declared_dead: torch.Tensor  # bool (N,)
    rewired: torch.Tensor  # bool (N,)
    rewire_targets: torch.Tensor  # int32 (N, S)
    fault_held: torch.Tensor  # bool (N, M)
    join_round: torch.Tensor  # int16 (N,)
    admitted_by: torch.Tensor  # int32 (N,)
    degree_credit: torch.Tensor  # int32 (N,)
    slot_lease: torch.Tensor  # int16 (M,)
    control_lvl: torch.Tensor  # int32 ()
    pipe_buf: torch.Tensor  # bool (N, M)
    suspect_round: torch.Tensor  # int16 (N,)
    suspect_mark: torch.Tensor  # int16 (N,)
    quarantine: torch.Tensor  # bool (N,)
    rng: torch.Tensor  # int64 (2,) threefry key words
    round: torch.Tensor  # int32 ()

    @property
    def n_peers(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    def coverage(self, slot: int = 0) -> torch.Tensor:
        """Fraction of live peers that have seen message ``slot`` (float32
        ratio of the two counts, as in the JAX package)."""
        live = self.alive & ~self.declared_dead
        n_live = torch.clamp(live.sum(), min=1).to(torch.float32)
        return (self.seen[:, slot] & live).sum().to(torch.float32) / n_live


def init_swarm(
    graph: Graph,
    config: SwarmConfig,
    *,
    key: torch.Tensor | None = None,
    origins=None,
    origin_slot: int = 0,
    origin_slots=None,
    exists: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
    rows: tuple[int, int] | None = None,
) -> SwarmState:
    """Build the swarm state on ``device`` from a graph; infect ``origins``
    in ``origin_slot`` (or each in its own ``origin_slots`` entry).
    ``rows`` ``(lo, count)`` builds only the swarm's rows ``[lo, lo +
    count)`` (a process of a mesh over several processes): its per-peer
    planes hold those rows, ``exists`` is theirs, the origins there are
    infected and every origin leases its slot; the CSR, the leases, the
    key and the round stay whole. Nothing is drawn per peer, so the block
    is the whole state's block."""
    dev = resolve_device(device)
    if graph.n != config.n_peers:
        raise ValueError(f"graph has {graph.n} nodes but config.n_peers={config.n_peers}")
    if key is None:
        key = prng.key(0, dev)
    lo, n = (0, config.n_peers) if rows is None else rows
    if lo < 0 or n < 1 or lo + n > config.n_peers:
        raise ValueError(f"rows {rows} outside the swarm's {config.n_peers}")
    m = config.msg_slots
    seen = torch.zeros((n, m), dtype=torch.bool, device=dev)
    infected_round = torch.full((n, m), -1, dtype=torch.int16, device=dev)
    slot_lease = torch.full((m,), -1, dtype=torch.int16, device=dev)
    if origins is not None:
        org = torch.as_tensor(np.asarray(origins), dtype=torch.int64, device=dev)
        if origin_slots is not None:
            slots_host = np.asarray(origin_slots)
            if slots_host.shape != np.asarray(origins).shape:
                raise ValueError(
                    f"origin_slots shape {slots_host.shape} != origins shape "
                    f"{np.asarray(origins).shape}"
                )
            if slots_host.size and (slots_host.min() < 0 or slots_host.max() >= m):
                raise ValueError(f"origin_slots must lie in [0, msg_slots={m})")
            slots = torch.as_tensor(slots_host, dtype=torch.int64, device=dev)
        else:
            slots = torch.full(org.shape, origin_slot, dtype=torch.int64, device=dev)
        held = (org >= lo) & (org < lo + n)
        seen[org[held] - lo, slots[held]] = True
        infected_round[org[held] - lo, slots[held]] = 0
        slot_lease[slots] = 0
    if exists is None:
        exists = torch.ones((n,), dtype=torch.bool, device=dev)
    exists = torch.as_tensor(exists, device=dev).to(torch.bool).clone()
    if exists.shape != (n,):
        raise ValueError(f"exists holds {tuple(exists.shape)} rows but the state holds {n}")
    s = max(config.rewire_slots, 1)
    return SwarmState(
        row_ptr=torch.as_tensor(graph.row_ptr, device=dev).to(torch.int32).clone(),
        col_idx=torch.as_tensor(graph.col_idx, device=dev).to(torch.int32).clone(),
        seen=seen,
        forwarded=torch.zeros((n, m), dtype=torch.bool, device=dev),
        infected_round=infected_round,
        recovered=torch.zeros((n, m), dtype=torch.bool, device=dev),
        exists=exists,
        alive=exists.clone(),
        silent=torch.zeros((n,), dtype=torch.bool, device=dev),
        last_hb=torch.zeros((n,), dtype=torch.int16, device=dev),
        declared_dead=torch.zeros((n,), dtype=torch.bool, device=dev),
        rewired=torch.zeros((n,), dtype=torch.bool, device=dev),
        rewire_targets=torch.zeros((n, s), dtype=torch.int32, device=dev),
        fault_held=torch.zeros((n, m), dtype=torch.bool, device=dev),
        join_round=torch.where(exists, 0, -1).to(torch.int16),
        admitted_by=torch.full((n,), -1, dtype=torch.int32, device=dev),
        degree_credit=torch.zeros((n,), dtype=torch.int32, device=dev),
        slot_lease=slot_lease,
        control_lvl=torch.tensor(-1, dtype=torch.int32, device=dev),
        pipe_buf=torch.zeros((n, m), dtype=torch.bool, device=dev),
        suspect_round=torch.full((n,), -1, dtype=torch.int16, device=dev),
        suspect_mark=torch.zeros((n,), dtype=torch.int16, device=dev),
        quarantine=torch.zeros((n,), dtype=torch.bool, device=dev),
        rng=key.to(dev).clone(),
        round=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def message_slot(message_id: int | str, msg_slots: int) -> int:
    """A message identity's dedup slot: plane 0 of :func:`message_slots`.
    Two rumors hashing to one slot are conflated (the intended semantics
    past capacity; ``sim.metrics.expected_conflations`` prices it)."""
    return message_slots(message_id, msg_slots, 1)[0]


def message_slots(message_id: int | str, msg_slots: int, k: int = 1) -> tuple[int, ...]:
    """``k`` dedup slots for one message, the Bloom view for k > 1: plane
    ``i`` is FNV-1a seeded by ``i`` over the id's bytes (a string's UTF-8,
    an int's 64-bit little-endian two's complement, wrapped), modulo
    ``msg_slots``."""
    if k <= 0 or k > msg_slots:
        raise ValueError(f"k must be in [1, msg_slots]; got {k}")
    data = (message_id.encode() if isinstance(message_id, str)
            else (int(message_id) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))
    out = []
    for plane in range(k):
        h = (2166136261 ^ (plane * 0x9E3779B9)) & 0xFFFFFFFF
        for b in data:
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        out.append(h % msg_slots)
    return tuple(out)


def clone_state(state: SwarmState) -> SwarmState:
    """Deep-copy every plane (a state that outlives its run, e.g. a
    benchmark's input, stays independent of the copy)."""
    return SwarmState(**{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(SwarmState)})


def stack_states(states: list[SwarmState]) -> SwarmState:
    """Stack K per-lane states into one batched state (every leaf gains a
    leading lane axis, scalars and the key included). The batch owns its
    leaves (``torch.stack`` copies)."""
    if not states:
        raise ValueError("stack_states needs at least one lane state")
    return SwarmState(**{f.name: torch.stack([getattr(s, f.name) for s in states])
                         for f in dataclasses.fields(SwarmState)})


def lane_state(batched: SwarmState, k: int) -> SwarmState:
    """Lane ``k`` of a :func:`stack_states` batch, as copies."""
    return SwarmState(**{f.name: getattr(batched, f.name)[k].clone() for f in dataclasses.fields(SwarmState)})


# ------------------------------------------------------------ plane registry


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """Declared memory contract of one :class:`SwarmState` plane: its
    minimal dtype (numpy name; ``"key"`` for the PRNG key), its shape,
    symbolic in N (peer slots), M (message slots), S (rewire slots) and D
    (edge slots), its information bits an element, the cap that makes the
    width sufficient, and its storage encoding (``core/packed.py``:
    ``"bits"`` LSB-first uint8 words along the slot axis, ``"flag:<k>"``
    bit k of the shared ``flags`` word, ``None`` the dtype as it is)."""

    name: str
    dtype: str
    shape: str
    info_bits: int
    why: str
    packed: str | None = None


PLANES: tuple[PlaneSpec, ...] = (
    PlaneSpec("row_ptr", "int32", "(N+1,)", 32,
              "cumulative edge counts: D < 2^31 at every tracked scale"),
    PlaneSpec("col_idx", "int32", "(D,)", 32,
              "peer row ids: N up to 100M needs 27 bits"),
    PlaneSpec("seen", "bool", "(N, M)", 1, "dedup bit", packed="bits"),
    PlaneSpec("forwarded", "bool", "(N, M)", 1, "relay bit", packed="bits"),
    PlaneSpec("infected_round", "int16", "(N, M)", 16,
              "round numbers: -1 or a first-receipt round <= ROUND_CAP "
              "(saturate_round at every latch site)"),
    PlaneSpec("recovered", "bool", "(N, M)", 1,
              "SIR removed bit (with seen: the 2-bit SIR state)",
              packed="bits"),
    PlaneSpec("exists", "bool", "(N,)", 1, "membership bit",
              packed="flag:0"),
    PlaneSpec("alive", "bool", "(N,)", 1, "liveness bit", packed="flag:1"),
    PlaneSpec("silent", "bool", "(N,)", 1, "fault bit", packed="flag:2"),
    PlaneSpec("last_hb", "int16", "(N,)", 16,
              "round numbers: a heartbeat round <= ROUND_CAP "
              "(saturate_round at every refresh site)"),
    PlaneSpec("declared_dead", "bool", "(N,)", 1, "detector verdict bit",
              packed="flag:3"),
    PlaneSpec("rewired", "bool", "(N,)", 1, "re-attach bit",
              packed="flag:4"),
    PlaneSpec("rewire_targets", "int32", "(N, S)", 32,
              "peer row ids: need 27 bits at 100M"),
    PlaneSpec("fault_held", "bool", "(N, M)", 1, "delay-buffer bit",
              packed="bits"),
    PlaneSpec("join_round", "int16", "(N,)", 16,
              "round numbers: -1 or a round index <= ROUND_CAP"),
    PlaneSpec("admitted_by", "int32", "(N,)", 32,
              "peer row ids: need 27 bits at 100M"),
    PlaneSpec("degree_credit", "int32", "(N,)", 32,
              "unfolded in-edge counts: a hub can hold > 2^15 credits "
              "between rematerializations at 100M"),
    PlaneSpec("slot_lease", "int16", "(M,)", 16,
              "round numbers: -1 or a round index <= ROUND_CAP"),
    PlaneSpec("control_lvl", "int32", "()", 8,
              "level index into a tiny fanout table; scalar — narrowing "
              "saves nothing"),
    PlaneSpec("pipe_buf", "bool", "(N, M)", 1, "in-flight delivery bit",
              packed="bits"),
    PlaneSpec("suspect_round", "int16", "(N,)", 16,
              "round numbers: -1 or the suspicion-entry round <= ROUND_CAP "
              "(saturate_round at the latch site)"),
    PlaneSpec("suspect_mark", "int16", "(N,)", 15,
              "packed witness-count: confirmation votes (low 8 bits, "
              "saturating at SUSPECT_VOTE_CAP=255) + false-accusation "
              "strikes (high 7 bits, saturating at SUSPECT_STRIKE_CAP="
              "127) — max packed value 32767 fits int16 exactly"),
    PlaneSpec("quarantine", "bool", "(N,)", 1, "Byzantine-verdict bit",
              packed="flag:5"),
    PlaneSpec("rng", "key", "()", 64, "threefry key (2x uint32)"),
    PlaneSpec("round", "int32", "()", 16, "scalar round cursor"),
)



def plane_registry() -> dict:
    """name -> :class:`PlaneSpec`."""
    return {p.name: p for p in PLANES}


def _dtype_bytes(dtype: str) -> int:
    return 8 if dtype == "key" else np.dtype(dtype).itemsize


def state_plane_bytes(n: int, m: int, rewire_slots: int = 1, d: int | None = None, lanes: int = 1,
                      packed: bool = False) -> dict:
    """Declared bytes a plane at (N=n, M=m, S=rewire_slots, D=d), priced
    from :data:`PLANES` without building an array. ``d`` (edge slots)
    defaults to 0; ``lanes`` prices ``lanes`` stacked swarms, every plane
    ``lanes`` times. ``packed`` prices the storage encoding: a ``"bits"``
    plane ceil(M/8) bytes a row, and the one shared flags word charged in
    full to its ``flag:0`` holder (``exists``), the other flag planes 0,
    so the dict still sums to the total."""
    dims = {"N": n, "M": m, "S": max(rewire_slots, 1), "D": 0 if d is None else d}
    out = {}
    for p in PLANES:
        elems = max(lanes, 1)
        terms = [t.strip() for t in p.shape.strip("()").split(",") if t.strip()]
        if packed and p.packed == "bits":
            for term in terms[:-1]:
                elems *= n + 1 if term == "N+1" else dims[term]
            out[p.name] = elems * ((dims[terms[-1]] + 7) // 8)
            continue
        if packed and p.packed is not None and p.packed.startswith("flag:"):
            out[p.name] = elems * n if p.packed == "flag:0" else 0
            continue
        for term in terms:
            elems *= n + 1 if term == "N+1" else dims[term]
        out[p.name] = elems * _dtype_bytes(p.dtype)
    return out


def state_bytes_per_peer(n: int, m: int, rewire_slots: int = 1, d: int | None = None, lanes: int = 1,
                         packed: bool = False) -> float:
    """Declared state bytes a peer slot: :func:`state_plane_bytes` summed
    over ``lanes * n`` slots."""
    return sum(state_plane_bytes(n, m, rewire_slots, d, lanes, packed).values()) / (n * max(lanes, 1))


def cast_to_declared(kwargs: dict) -> dict:
    """Host planes cast to their declared dtypes where only the width
    differs (a checkpoint written before a plane narrowed, e.g. int32
    round planes, now int16; the values are within the declared caps, so
    the cast is lossless). A kind mismatch is left for
    :func:`validate_state_planes` to name."""
    reg = plane_registry()
    out = dict(kwargs)
    for name in list(out):
        spec = reg.get(name)
        if spec is None or spec.dtype == "key":
            continue
        want = np.dtype(spec.dtype)
        leaf = np.asarray(out[name])
        if leaf.dtype != want and leaf.dtype.kind == want.kind:
            out[name] = leaf.astype(want)
    return out


def _np_dtype(leaf: torch.Tensor) -> np.dtype:
    return np.dtype(str(leaf.dtype).removeprefix("torch."))


def validate_state_planes(state: SwarmState, source: str | None = None) -> None:
    """Check every plane of a loaded state against :data:`PLANES` and fail
    with the plane named: N and M bind from ``seen``, S from
    ``rewire_targets``, D from ``col_idx``; every plane must then have its
    declared shape and exactly its declared dtype. The key is the port's
    int64 (2,) tensor of threefry words."""
    where = f" in {source}" if source else ""

    def fail(name, what):
        raise ValueError(
            f"checkpoint plane {name!r}{where} {what} — stale or foreign "
            "checkpoint (the PLANES registry in core/state.py declares "
            "every plane's dtype and shape)"
        )

    seen = state.seen
    if seen.ndim != 2:
        fail("seen", f"has shape {tuple(seen.shape)}, expected the 2-D (N, M) dedup bitmap")
    if state.rewire_targets.ndim != 2:
        fail("rewire_targets", f"has shape {tuple(state.rewire_targets.shape)}, expected the 2-D (N, S) "
             "fresh-target table")
    dims = {"N": int(seen.shape[0]), "M": int(seen.shape[1]), "S": int(state.rewire_targets.shape[1]),
            "D": int(state.col_idx.shape[0])}
    for spec in PLANES:
        leaf = getattr(state, spec.name)
        if spec.dtype == "key":
            if leaf.dtype != torch.int64 or tuple(leaf.shape) != (2,):
                fail(spec.name, f"has dtype {_np_dtype(leaf)} and shape {tuple(leaf.shape)}, expected a PRNG "
                     "key (int64 (2,) threefry words)")
            continue
        want = np.dtype(spec.dtype)
        if _np_dtype(leaf) != want:
            fail(spec.name, f"has dtype {_np_dtype(leaf)}, expected {want}")
        expect = tuple(dims[t.strip()] if t.strip() != "N+1" else dims["N"] + 1
                       for t in spec.shape.strip("()").split(",") if t.strip())
        if tuple(leaf.shape) != expect:
            fail(spec.name, f"has shape {tuple(leaf.shape)}, expected {expect} at (N={dims['N']}, "
                 f"M={dims['M']}, S={dims['S']}, D={dims['D']})")


def _implied_leases(seen: np.ndarray) -> np.ndarray:
    """The slot-lease table a checkpoint from before the streaming plane
    implies: a slot carrying bits holds a round-0 message, the rest are
    free."""
    return np.where(np.any(seen, axis=0), 0, -1).astype(np.int16)


def zero_suspicion(n: int) -> dict:
    """The suspicion planes of a cold start (host arrays): nobody
    suspected, no votes or strikes, nobody quarantined."""
    return {
        "suspect_round": np.full((n,), -1, dtype=np.int16),
        "suspect_mark": np.zeros((n,), dtype=np.int16),
        "quarantine": np.zeros((n,), dtype=bool),
    }


def _zero_registry(exists: np.ndarray) -> dict:
    """The registry planes a checkpoint from before the growth engine
    implies: every existing row a bootstrap member."""
    exists = np.asarray(exists)
    return {
        "join_round": np.where(exists, 0, -1).astype(np.int16),
        "admitted_by": np.full(exists.shape, -1, dtype=np.int32),
        "degree_credit": np.zeros(exists.shape, dtype=np.int32),
    }


def state_from_host(host: dict, device: str | torch.device = "cuda", source: str | None = None) -> SwarmState:
    """A :class:`SwarmState` on ``device`` from host planes keyed by field
    name (the key as its uint32 (2,) words), cast to the declared widths
    and validated against :data:`PLANES`."""
    dev = resolve_device(device)
    host = cast_to_declared(host)
    kw = {}
    for f in dataclasses.fields(SwarmState):
        a = np.asarray(host[f.name])
        if f.name == "rng":
            a = a.astype(np.int64)
        if not a.flags.c_contiguous:
            a = a.copy(order="C")  # (np.ascontiguousarray would lift a 0-d plane to 1-d)
        kw[f.name] = torch.from_numpy(a).to(dev)
    state = SwarmState(**kw)
    validate_state_planes(state, source=source)
    return state


# ------------------------------------------------------------ flat npz checkpoint

# field order of the round-1 checkpoint format (positional arr_i/key_i keys,
# before the ``exists`` field existed)
_V1_FIELDS = (
    "row_ptr", "col_idx", "seen", "forwarded", "infected_round", "recovered",
    "alive", "silent", "last_hb", "declared_dead", "rng", "round",
)
# planes the named formats gained after their first release, filled on load
_LATER_PLANES = ("fault_held", "slot_lease", "control_lvl", "pipe_buf", "suspect_round", "suspect_mark",
                 "quarantine", "join_round", "admitted_by", "degree_credit")


def save_swarm(path, state: SwarmState) -> None:
    """The whole swarm as one flat npz, keyed by field name, in the packed
    storage encoding (``core/packed.py``: bit planes as LSB-first uint8
    words, the six masks in one ``field_flags`` word; the key as its uint32
    words under ``prngkey_rng``). No atomicity and no digests: the durable
    route is ``tpu_gossip_torch.ckpt``. The state is read to the host once."""
    from tpu_gossip_torch.core.packed import pack_host_planes
    from tpu_gossip_torch.utils.digest import leaf_array

    host = {f.name: leaf_array(f.name, getattr(state, f.name)) for f in dataclasses.fields(SwarmState)}
    arrays = {"prngkey_rng": host.pop("rng")}
    for name, arr in pack_host_planes(host).items():
        arrays[f"field_{name}"] = arr
    np.savez(path, **arrays)


def load_swarm(path, device: str | torch.device = "cuda") -> SwarmState:
    """Restore a :func:`save_swarm` file onto ``device``, or any older
    generation the JAX loader reads:

    - the packed ``field_flags`` payload (decoded losslessly);
    - the unpacked named format, and named files from before scenarios
      (``fault_held`` zeroed), growth (the registry planes: every existing
      row a bootstrap member), streams (``slot_lease`` implied by the seen
      slots), control (``control_lvl`` -1), pipelines (``pipe_buf``
      zeroed) and suspicion (nobody suspected);
    - the round-1 positional layout (``arr_i``/``key_i``, before
      ``exists``: all True), its per-peer SIR planes lifted onto the slots
      each peer saw.

    Planes narrowed since are cast to their declared widths, and the state
    is validated against :data:`PLANES`."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    kw = {}
    if "field_flags" in data:
        from tpu_gossip_torch.core.packed import decode_host_planes

        data = decode_host_planes(data, int(data["field_infected_round"].shape[-1]))
    if any(k.startswith("field_") or k.startswith("prngkey_") for k in data):
        for f in dataclasses.fields(SwarmState):
            if f"prngkey_{f.name}" in data:
                kw[f.name] = data[f"prngkey_{f.name}"]
            elif f.name in _LATER_PLANES and f"field_{f.name}" not in data:
                continue
            else:
                kw[f.name] = data[f"field_{f.name}"]
        if "fault_held" not in kw:
            kw["fault_held"] = np.zeros(kw["seen"].shape, dtype=bool)
        if "join_round" not in kw:
            kw.update(_zero_registry(kw["exists"]))
        if "slot_lease" not in kw:
            kw["slot_lease"] = _implied_leases(kw["seen"])
        if "control_lvl" not in kw:
            kw["control_lvl"] = np.asarray(-1, dtype=np.int32)
        if "pipe_buf" not in kw:
            kw["pipe_buf"] = np.zeros(kw["seen"].shape, dtype=bool)
        for name, leaf in zero_suspicion(np.asarray(kw["exists"]).shape[0]).items():
            kw.setdefault(name, leaf)
    else:
        for i, name in enumerate(_V1_FIELDS):
            kw[name] = data[f"key_{i}"] if f"key_{i}" in data else data[f"arr_{i}"]
        n, m = kw["seen"].shape
        kw["exists"] = np.ones((n,), dtype=bool)
        if kw["infected_round"].ndim == 1:
            kw["infected_round"] = np.where(kw["seen"], kw["infected_round"][:, None], -1).astype(np.int32)
        if kw["recovered"].ndim == 1:
            kw["recovered"] = kw["seen"] & kw["recovered"][:, None]
        kw["rewired"] = np.zeros((n,), dtype=bool)
        kw["rewire_targets"] = np.zeros((n, 1), dtype=np.int32)
        kw["fault_held"] = np.zeros((n, m), dtype=bool)
        kw.update(_zero_registry(kw["exists"]))
        kw["slot_lease"] = _implied_leases(kw["seen"])
        kw["control_lvl"] = np.asarray(-1, dtype=np.int32)
        kw["pipe_buf"] = np.zeros((n, m), dtype=bool)
        kw.update(zero_suspicion(n))
    return state_from_host(kw, device, source=str(path))
