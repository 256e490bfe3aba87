"""Device traces and the slope-timed stage decomposition of one round.

Ports ``tpu_gossip/utils/profiling.py``:

- :func:`trace` records a ``torch.profiler`` trace (chrome-trace JSON) of
  a region into a directory: ``--profile DIR`` on ``cli/run_sim.py``.
- :func:`slope_time` times a loop body at two iteration counts and divides
  the difference, so the constant cost of starting and reading back
  cancels.
- :func:`profile_round_stages` decomposes one fault-free local round into
  its stages (delivery, the tail per implementation, liveness, stats, the
  key splits, the growth, stream and control stages when those planes are
  passed, the sparse transport's compaction, the composed round per tail
  with every passed plane active), in the JAX package's order and under
  its names: ``run_sim --profile-round R``, with ``--grow``, ``--stream``
  and ``--control``. Every stage body folds its outputs into an int32
  carry, as JAX's do, so every stage pays that one reduction.
- :func:`format_stage_table` prints the stages as JAX's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from pathlib import Path
from typing import Iterator

import torch

from tpu_gossip_torch.device import resolve_device

__all__ = ["trace", "slope_time", "time_ms", "cold_ms", "in_turns", "profile_round_stages", "format_stage_table"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | Path | None) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the region (the card's kernels
    too when a card is present) into ``log_dir/trace.json``, viewable in
    Perfetto or ``chrome://tracing``. No-op when ``log_dir`` is falsy, so
    call sites can pass the CLI flag straight through."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / TRACE_FILE))


def _first_leaf(carry) -> torch.Tensor:
    """The first tensor of a carry: a tensor, a dataclass (a state) or a
    sequence."""
    if dataclasses.is_dataclass(carry):
        return _first_leaf(getattr(carry, dataclasses.fields(carry)[0].name))
    return carry if isinstance(carry, torch.Tensor) else _first_leaf(carry[0])


def slope_time(body, carry, n1: int, n2: int, reps: int = 3, operands=()) -> float:
    """Seconds per iteration of ``body(i, carry, *operands) -> carry``.

    Two-point slope: run the loop at ``n1`` and ``n2`` iterations and
    divide the wall delta by ``n2 - n1``, so the constant cost of starting
    the loop and reading back its result cancels. Min wall over ``reps``
    after one warm run. Returns NaN when noise wins (non-positive slope).

    JAX runs the loop on the device (``fori_loop``); torch has none, so the
    body runs in an eager loop, then the first leaf of the final carry is
    read back and the card synchronised, and the wall time taken. Each
    iteration's launch cost is therefore inside the slope: the cost the
    port's round pays (CUDA graphs would take it out, a later step).
    """

    def once(iters: int) -> None:
        c = carry
        for i in range(iters):
            c = body(i, c, *operands)
        leaf = _first_leaf(c)
        _ = float(leaf.sum())  # barrier: read back
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)

    def run(iters: int) -> float:
        once(iters)  # warm
        best = float("inf")
        for _rep in range(max(reps, 1)):
            t0 = time.perf_counter()
            once(iters)
            best = min(best, time.perf_counter() - t0)
        return best

    dt = (run(n2) - run(n1)) / (n2 - n1)
    return dt if dt > 0 else float("nan")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).
    The launches are queued behind a sleep kernel twice as long as the
    host takes to issue them, so the card runs them back to back and the
    host's launch cost is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(issue_s * 4e9) + 1000)  # cycles: twice issue_s at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters: int = 30) -> float:
    """Mean device time of ``fn`` with L2 cold: each launch follows a read
    of 128 MB (more than the card's 50 MB L2) and is timed alone by its own
    events, all queued behind a sleep kernel as in :func:`time_ms`."""
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        flush.sum()
        fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(issue_s * 4e9) + 1000)
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def in_turns(kernel, other, iters: int = 50, timer=time_ms) -> tuple[float, float]:
    """Mean device times of ``kernel`` and ``other`` (by ``timer``),
    timed in turns: kernel, other, other, kernel."""
    a1, b1, b2, a2 = (timer(fn, iters) for fn in (kernel, other, other, kernel))
    return (a1 + a2) / 2, (b1 + b2) / 2


def _fold(c: torch.Tensor, *arrays: torch.Tensor) -> torch.Tensor:
    for a in arrays:
        c = c ^ a.sum(dtype=torch.int32)
    return c


def profile_round_stages(state, cfg, plan=None, *, reps: int = 3, loop_lengths: tuple[int, int] = (4, 24),
                         tails: tuple[str, ...] = ("reference", "fused"), growth=None, stream=None, control=None,
                         transport_probe: tuple[int, int, int, int] | None = None,
                         device: str | torch.device = "cuda") -> dict[str, float]:
    """Stage decomposition of one fault-free local round, seconds a round.

    Each stage is a separate slope measurement on the same ``state`` (run a
    few rounds first so the slot planes are mid-epidemic), which must lie on
    ``device``:

    - ``delivery``: ``_disseminate_local`` with ``plan``, a fresh key per
      iteration;
    - ``tail[<impl>]``: the round tail per implementation over one
      delivery's ``incoming`` (``fused`` and ``pallas`` launch K3 on the
      card; ``reference`` is JAX's multi-pass tail in plain torch);
    - ``liveness``: heartbeat emission and the failure detector;
    - ``stats``: the per-round ``RoundStats`` reductions (with the passed
      planes' tracks);
    - ``rng``: the round's 5-way key split;
    - ``growth``: the admission stage (``growth/engine.apply_growth``: the
      Gumbel-top-k draw and the registry scatters), with a ``growth``
      schedule;
    - ``stream``: the streaming stage (``slot_expiry`` and
      ``apply_stream``: the host's arrival count, the device draws, the
      landing), with a ``stream`` workload;
    - ``control``: the controller (``control_round``, the AIMD update and
      the PeerSwap refresh of ``apply_control``), with a ``control``
      policy;
    - ``transport_compact``: the sparse transport's compaction round trip
      (``dist/transport.py``: occupancy header, compact index, gather,
      scatter) over a synthetic ``transport_probe = (s, b, g, budget)``
      payload about 1/8 occupied, when given;
    - ``full_round[<impl>]``: the composed ``gossip_round`` per tail, every
      passed plane active.

    Stage sums need not equal the full round: each stage alone pays its
    own launches.
    """
    from tpu_gossip_torch.control.engine import apply_control, control_round
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.dist.transport import compact_index, gather_compact, occupancy_counts, scatter_compact
    from tpu_gossip_torch.kernels.liveness import detect_failures, emit_heartbeats
    from tpu_gossip_torch.growth.engine import apply_growth
    from tpu_gossip_torch.kernels.round_tail import round_tail
    from tpu_gossip_torch.sim import engine
    from tpu_gossip_torch.traffic.engine import apply_stream, slot_expiry

    dev = resolve_device(device)
    if state.seen.device.type != dev.type:
        raise ValueError(f"state lies on {state.seen.device}, not on {dev}")
    dev = state.seen.device
    n1, n2 = loop_lengths
    _, transmitter, receptive = engine.compute_roles(state)
    transmit = engine.transmit_bitmap(state, cfg, transmitter)
    # the loop counter as a device scalar per iteration, made once (a host
    # scalar copied to the card each iteration would synchronise it)
    rounds = torch.arange(max(n1, n2), dtype=torch.int32, device=dev)
    k_delivery, k_rng = prng.key(1, dev), prng.key(2, dev)

    def one_delivery(key, st, tx, tr, rc, pl):
        k_push, k_pull = prng.split(key)
        return engine._disseminate_local(st, cfg, tx, tr, rc, k_push, k_pull, pl)

    incoming, _ = one_delivery(prng.key(17, dev), state, transmit, transmitter, receptive, plan)
    fresh = None
    if cfg.churn_join_prob > 0.0:
        # a plausibly dense fresh mask (the tail's churn-reset operand)
        # graftlint: disable=key-linearity -- the stage profiler times a constant draw on purpose
        fresh = state.exists & (prng.uniform(prng.key(23, dev), tuple(state.alive.shape)) < cfg.churn_join_prob)

    def t_delivery(i, c, st, tx, tr, rc, pl):
        inc, msgs = one_delivery(prng.fold_in(k_delivery, i), st, tx, tr, rc, pl)
        return _fold(c, inc, msgs)

    def tail_body(impl):
        def body(i, c, st, inc, rc, tx, fr):
            out = round_tail(st.seen, st.forwarded, st.infected_round, st.recovered, inc, rc, tx, fr, rounds[i],
                             forward_once=cfg.forward_once, sir_recover_rounds=cfg.sir_recover_rounds, impl=impl)
            return _fold(c, *out)

        return body

    def t_liveness(i, c, st):
        hb = emit_heartbeats(st.last_hb, st.alive, st.silent, st.declared_dead, rounds[i], cfg.hb_period_rounds)
        hb, dead = detect_failures(hb, st.alive, st.silent, st.declared_dead, rounds[i], cfg.timeout_rounds,
                                   cfg.detect_period_rounds)
        return _fold(c, hb, dead)

    def t_stats(i, c, st):
        stats = engine._stats(st, rounds[i], growth=growth, stream=stream)
        return _fold(c, stats.msgs_sent, stats.n_infected, stats.n_alive) ^ (stats.coverage > 0.5).to(torch.int32)

    def t_rng(i, c):
        keys = prng.split(prng.fold_in(k_rng, i), 5)
        return _fold(c, keys[:, 0].to(torch.int32))

    # the planes' per-iteration keys, fold_in(state.rng, i) as JAX's stage
    # bodies draw them: made once, on the device and (for the stream's
    # arrival count, which is drawn on the host) on the host
    keys = [prng.fold_in(state.rng, i) for i in range(max(n1, n2))]
    host_keys = [k.cpu() for k in keys] if stream is not None else None
    zero_i32 = torch.zeros((), dtype=torch.int32, device=dev)

    def t_growth(i, c, st, gp):
        grown = apply_growth(gp, keys[i], rounds[i], zero_i32, row_ptr=st.row_ptr, exists=st.exists,
                             alive=st.alive, silent=st.silent, last_hb=st.last_hb, declared_dead=st.declared_dead,
                             rewired=st.rewired, rewire_targets=st.rewire_targets, join_round=st.join_round,
                             admitted_by=st.admitted_by, degree_credit=st.degree_credit)
        return _fold(c, grown["exists"], grown["join_round"], grown["degree_credit"])

    def t_stream(i, c, st, sp):
        expired = slot_expiry(st.slot_lease, rounds[i], sp.ttl)
        lease = torch.where(expired, -1, st.slot_lease)
        seen, infected_round, lease, stel = apply_stream(
            sp, keys[i], rounds[i], expired.sum(dtype=torch.int32), seen=st.seen,
            infected_round=st.infected_round, slot_lease=lease, row_ptr=st.row_ptr, col_idx=st.col_idx,
            exists=st.exists, alive=st.alive, declared_dead=st.declared_dead, host_rng=host_keys[i], host_rnd=i)
        return _fold(c, seen, infected_round, lease, stel.injected)

    def t_control(i, c, st, inc, cp):
        rctl = control_round(cp, st, want_needy=cfg.mode == "push_pull")
        lvl, tgts, credit, ctel = apply_control(
            cp, keys[i], rounds[i], rctl, incoming=inc, seen_prev=st.seen, seen=st.seen | inc, alive=st.alive,
            declared_dead=st.declared_dead, exists=st.exists, rewired=st.rewired,
            rewire_targets=st.rewire_targets, degree_credit=st.degree_credit, row_ptr=st.row_ptr,
            col_idx=st.col_idx, slot_lease=st.slot_lease, rewire_slots=cfg.rewire_slots, fstats=None)
        return _fold(c, lvl, tgts, credit, ctel.fanout)

    def t_transport(i, c, payload):
        _, b_probe, _, budget = transport_probe
        occ = (payload != 0).any(-1)
        idx = compact_index(occ, budget)
        back = scatter_compact(idx, gather_compact(payload, idx), b_probe)
        return _fold(c, occupancy_counts(occ), back)

    def round_body(impl):
        def body(i, s, pl, gp, sp, cp):
            return engine.gossip_round(s, cfg, pl, tail=impl, growth=gp, stream=sp, control=cp)[0]

        return body

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    deliver_ops = (state, transmit, transmitter, receptive, plan)
    tail_ops = (state, incoming, receptive, transmit, fresh)
    stages: dict[str, float] = {"delivery": slope_time(t_delivery, zero, n1, n2, reps, operands=deliver_ops)}
    for impl in tails:
        stages[f"tail[{impl}]"] = slope_time(tail_body(impl), zero, n1, n2, reps, operands=tail_ops)
    stages["liveness"] = slope_time(t_liveness, zero, n1, n2, reps, operands=(state,))
    stages["stats"] = slope_time(t_stats, zero, n1, n2, reps, operands=(state,))
    stages["rng"] = slope_time(t_rng, zero, n1, n2, reps)
    if growth is not None:
        stages["growth"] = slope_time(t_growth, zero, n1, n2, reps, operands=(state, growth))
    if stream is not None:
        stages["stream"] = slope_time(t_stream, zero, n1, n2, reps, operands=(state, stream))
    if control is not None:
        stages["control"] = slope_time(t_control, zero, n1, n2, reps, operands=(state, incoming, control))
    if transport_probe is not None:
        s_probe, b_probe, g_probe, _budget = transport_probe
        # a plausibly sparse synthetic payload (~1/8 occupancy, the compact
        # lane's design point): nonzero words where the mask hits
        # graftlint: disable=key-linearity -- the stage profiler times a constant draw on purpose
        occ_mask = prng.uniform(prng.key(29, dev), (s_probe, b_probe, 1)) < 0.125
        payload = torch.where(occ_mask, 0x5A5A5A5A, 0).to(torch.int32).expand(s_probe, b_probe, g_probe).contiguous()
        stages["transport_compact"] = slope_time(t_transport, zero, n1, n2, reps, operands=(payload,))
    for impl in tails:
        stages[f"full_round[{impl}]"] = slope_time(round_body(impl), state, n1, n2, reps,
                                                   operands=(plan, growth, stream, control))
    return stages


def format_stage_table(stages: dict[str, float]) -> str:
    """The stage dict as a markdown table (ms per round), in the profiler's
    emission order: decomposition stages first, composed rounds last."""
    lines = ["| stage | ms/round |", "|---|---|"]
    for name, secs in stages.items():
        ms = secs * 1e3
        lines.append(f"| {name} | {ms:.3f} |")
    return "\n".join(lines)


def stages_ms(stages: dict[str, float]) -> dict[str, float | None]:
    """ms per round rounded as the JAX CLI's summary rounds them, NaN (a
    slope lost to noise) as None so the summary stays strict JSON."""
    return {k: (round(v * 1e3, 4) if math.isfinite(v) else None) for k, v in stages.items()}
