"""Where one round's time goes, on the card.

    python -m tpu_gossip_torch.sim.profile --peers 1000000 --warm 6
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --graph device --staircase
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --packed
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --graph device --shard --staircase
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --churn-leave 0.002 \\
        --churn-join 0.02 --rewire-slots 2 --rewire-compact-cap 65536
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --warm 18 \\
        --scenario scenarios/lossy_links.toml
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --warm 12 \\
        --scenario scenarios/byzantine_siege.toml --quorum-k 3
    python -m tpu_gossip_torch.sim.profile --peers 950000 --grow 1000000 \\
        --grow-rate 256
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --graph device \\
        --stream 4 --warm 40
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --control 0.99

Builds a swarm (push_pull, fanout 1, 16 slots) over ``--graph``: the
matching graph (the headline), ``device`` (the power-law configuration
model built on the card, gamma 2.5) or ``pa`` (preferential attachment,
m=3, on the host); the CSR graphs deliver through the staircase kernel
with ``--staircase`` (a host-built plan, as the CLI builds it) and through
the exactly-k XLA path without. It advances ``--warm`` rounds so the slot
planes are mid-epidemic, then prints JSON lines: the time of each stage of
the round taken alone (CUDA events, mean over ``--reps`` calls; the XLA
path reports the whole round only), and a ``torch.profiler`` trace of
``--rounds`` rounds summed by kernel name with the device's busy share of
the wall time. With ``--packed`` the swarm is packed after the warm rounds
and the stages are the packed round's: the flags decode, the word head,
the codec at delivery, the delivery itself, K4 and the stats (the matching
graph and ``--graph device`` without ``--staircase``). With ``--shard`` the
CSR graph (exported to the host) runs on the bucketed sharded engine over
a one-shard mesh, its receive through K6 with ``--staircase`` and the
scatter without, and the stages are the sharded round's: key splits,
draws, send gather and payload, exchange, bill, receive, then the tail (K3,
or K4 with ``--packed``, whose stages are then the packed round's with the
sharded delivery). The churn flags (``--churn-leave``, ``--churn-join``,
``--rewire-slots``, ``--rewire-compact-cap``) run the warm and timed
rounds under churn and add the churn round's own stages: ``churn_draws``
(the churn stage: departures, rejoins, the re-wiring draws and their
credit), ``fresh_side_paths`` (``fresh_rewire_traffic`` over the rewired
rows) and, with ``--remat-every R`` on a CSR graph, ``remat`` (one
``rematerialize_rewired`` fold, with ``remat_per_round`` its share of R
rounds) and on the sharded path ``repartition`` (the epoch's
re-partition, re-shard and K6 plans). ``--scenario F`` (the local
unpacked round) runs the warm and traced rounds under the fault schedule
in ``F`` and adds ``fault_draws``
(the fault head's two ``(N, M)`` uniforms), ``fault_round`` (the whole
round under the scenario at the round after the warm ones) and
``plain_round`` (the same round without it). ``--quorum-k K`` (local
unpacked round, window 4, budget 3) runs every round under the quorum
detector and adds ``liveness`` (the hardened stage alone: forged
heartbeats, accusations, the suspicion machine, the quarantine's credit
release) beside ``liveness_direct`` (the unhardened stage on the same
state), and under an adversary scenario ``adv_draws`` (the adversary
stream's fold and its three ``randint`` draws: ``(N,)`` accusations,
``(N, forge width)`` forgeries, ``(N, flood width)`` floods) and
``flood_replay`` (the flood's payload scatter and bill). ``--grow TARGET``
(``--grow-rate J`` joins a round, attach 3) builds the swarm at the
capacity TARGET (the matching graph in its sharded layout at one shard
with the capacity as reserved rows, a CSR graph padded as ``bench.py``'s
``bench_grow`` pads it), runs every round growing and adds the growth
stage: ``growth`` (the whole admission), split into ``growth_draw`` (the
``(J, N)`` Gumbel draw), ``growth_top_k`` (the tie-ordered top-k over its
scores) and ``growth_scatters`` (the cursor, the log degrees and the
registry and credit scatters), with ``growth_round`` and
``plain_round`` (the same round with ``growth=None``) beside them and
``growth_chunk_rows`` the draw's rows a chunk. ``--stream RATE`` runs
every round (the warm ones included) under ``bench.py``'s ``bench_stream``
workload: 32 slots, fanout 2, TTL ``1.5 * min_feasible_ttl(n, 2)``, the
batch of ``default_max_inject(4.0)`` arrivals, uniform origins, no seeded
epidemic; warm past one TTL so leases age out, it adds the stream's
stages on the loaded state: ``stream_ageout`` (the expiry mask, the lease
and held-buffer updates), ``stream_inject`` (the whole injection), split
into ``stream_poisson_host`` (the arrival count on the host, wall ms),
``stream_draws`` (the origin and slot draws at the batch shape),
``stream_landing`` (the sequential landing, ``stream_arrivals`` steps)
and ``stream_scatter`` (the bits and the latch), ``slot_stats`` (the
per-slot columns, the (N, M) column sum among them), and
``stream_round`` beside ``plain_round`` (the same round without the
stream). ``--control TARGET`` runs every round (the warm ones included)
under ``bench.py``'s ``bench_control`` policy (fanout 3, bounds 1..6,
push_pull, the delivery-ratio target TARGET) and adds the control stage's
rows on the warm state: ``control_resolve`` (``control_round``: the
cursor, the knee gate's slot coverage and the needy rows),
``control_apply`` (``apply_control``'s AIMD update from the round's
feedback), ``control_refresh`` (the PeerSwap refresh at full shape:
its draws, the credit scatter-adds and the swap), and
``controlled_round`` beside ``plain_round`` (the same round without the
controller). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpu_gossip_torch import dist
from tpu_gossip_torch.core import prng, topology
from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph, matching_powerlaw_graph_sharded
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
from tpu_gossip_torch.kernels import pallas_segment as seg
from tpu_gossip_torch.kernels.liveness import detect_failures, emit_heartbeats
from tpu_gossip_torch.kernels.pallas_segment import pack_words, popcount, unpack_words
from tpu_gossip_torch.core.packed import pack_bits, pack_state, packed_width, unpack_bits
from tpu_gossip_torch.kernels.round_tail import round_tail, round_tail_words
from tpu_gossip_torch.sim import engine
from tpu_gossip_torch.sim import packed_engine as pe
from tpu_gossip_torch.sim.stages import has_churn, next_host_key


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _common_stages(state, cfg, plan) -> tuple[dict, dict]:
    """(stages before delivery, stages after it) shared by every path."""
    _, transmitter, receptive = engine.compute_roles(state)
    transmit = engine.transmit_bitmap(state, cfg, transmitter)
    rnd = state.round + 1
    head = {
        "key_splits": lambda: prng.split(prng.split(prng.split(state.rng, 5)[1])[0]),
        "roles_transmit": lambda: engine.transmit_bitmap(state, cfg, engine.compute_roles(state)[1]),
    }
    tail = {
        "liveness": lambda: detect_failures(
            emit_heartbeats(state.last_hb, state.alive, state.silent, state.declared_dead, rnd,
                            cfg.hb_period_rounds),
            state.alive, state.silent, state.declared_dead, rnd, cfg.timeout_rounds,
            cfg.detect_period_rounds),
        "tail_k3": lambda: round_tail(
            state.seen, state.forwarded, state.infected_round, state.recovered, state.seen,
            receptive, transmit, None, rnd, forward_once=False, sir_recover_rounds=0),
        "stats": lambda: engine._stats(state, torch.zeros((), dtype=torch.int32, device=rnd.device)),
        "whole_round": lambda: engine.gossip_round(state, cfg, plan),
    }
    return head, tail


def stage_times(state, cfg, plan, reps: int) -> dict:
    """Each stage of one sampled push-pull matching round, timed alone (ms)."""
    shape = (plan.rows, 128)
    transmit = engine.transmit_bitmap(state, cfg, engine.compute_roles(state)[1])
    key = prng.split(state.rng, 5)[1]
    words = pack_words(transmit[: plan.n])
    slot_tx = plan.partner(plan.expand(words))
    head, tail = _common_stages(state, cfg, plan)
    stages = {
        **head,
        "draw_bits_x2": lambda: (prng.bits(key, shape), prng.bits(key, shape)),
        "thresholds_push_pull": lambda: (plan.push_threshold(), plan.pull_threshold()),
        "pack_expand": lambda: plan.expand(pack_words(transmit[: plan.n])),
        "partner_pass": lambda: plan.partner(slot_tx),
        "reduce_or": lambda: plan.reduce(slot_tx, "or"),
        "popcount_bill": lambda: popcount(slot_tx).sum(),
        "unpack": lambda: unpack_words(words, transmit.shape[1]),
        **tail,
    }
    return {name: _event_ms(fn, reps) for name, fn in stages.items()}


def staircase_stage_times(state, cfg, plan, reps: int) -> dict:
    """Each stage of one sampled push-pull staircase round, timed alone (ms)."""
    shape = tuple(plan.offs.shape)
    transmit = engine.transmit_bitmap(state, cfg, engine.compute_roles(state)[1])
    k_push, k_pull = prng.split(prng.split(prng.split(state.rng, 5)[1])[0])
    active_p = prng.bits(k_push, shape) < plan.push_thresh
    active_q = prng.bits(k_pull, shape) < plan.pull_thresh
    gathered = seg._gather_words(plan, transmit)

    def mask_bill():
        wp, wq = torch.where(active_p, gathered, 0), torch.where(active_q, gathered, 0)
        return wp | wq, popcount(wp).sum(), active_q.to(torch.int32) + popcount(wq)

    combined, _, bill = mask_bill()
    head, tail = _common_stages(state, cfg, plan)
    stages = {
        **head,
        # graftlint: disable=key-linearity -- the stage timer replays the round's draws on purpose
        "draw_bits_x2": lambda: (prng.bits(k_push, shape) < plan.push_thresh,
                                 # graftlint: disable=key-linearity -- the stage timer replays the round's draws on purpose
                                 prng.bits(k_pull, shape) < plan.pull_thresh),
        "word_gather": lambda: seg._gather_words(plan, transmit),
        "mask_combine_bill": mask_bill,
        "k5_and_unpack": lambda: seg._launch(plan, combined, transmit.shape[1], bill=bill),
        **tail,
    }
    return {name: _event_ms(fn, reps) for name, fn in stages.items()}


def shard_stage_times(state, cfg, sg, mesh, plan, reps: int) -> dict:
    """Each stage of one sharded push-pull round (the merged exchange),
    timed alone (ms)."""
    m = cfg.msg_slots
    transmit = engine.transmit_bitmap(state, cfg, engine.compute_roles(state)[1])

    def shard_keys():
        return prng.split(prng.split(prng.split(state.rng, 5)[1])[0], sg.n_shards)

    keys = shard_keys()
    active, acts = dist.mesh.activation(sg, keys, "push_pull", cfg.fanout)
    payload = dist.mesh.send_payload(dist.mesh.payload_words(transmit, sg), active, acts)
    received = dist.mesh.all_to_all(payload)
    words, _ = dist.mesh.bill(received, packed_width(m))
    head, tail = _common_stages(state, cfg, None)
    stages = {
        "key_splits": lambda: torch.stack([prng.split(k) for k in shard_keys()]),
        "roles_transmit": head["roles_transmit"],
        "draws_gates": lambda: dist.mesh.activation(sg, keys, "push_pull", cfg.fanout),
        "send_gather_payload": lambda: dist.mesh.send_payload(dist.mesh.payload_words(transmit, sg), active, acts),
        "exchange": lambda: dist.mesh.all_to_all(payload),
        "bill": lambda: dist.mesh.bill(received, packed_width(m)),
        "receive_k6" if plan is not None else "receive_scatter": lambda: dist.mesh.receive(words, sg, plan, m),
        **tail,
        "whole_round": lambda: dist.gossip_round_dist(state, cfg, sg, mesh, plan),
    }
    return {name: _event_ms(fn, reps) for name, fn in stages.items()}


def packed_stage_times(ps, cfg, plan, reps: int, shard=None) -> dict:
    """Each stage of one packed round, timed alone (ms). ``codec`` is the
    decode and repack that the delivery pays: three planes and the
    product on a plan's path and on the sharded path (``shard``, the
    ``(sg, mesh)`` pair), the push payload and product on the word-native
    exactly-k path."""
    m = ps.msg_slots
    flags = pe._decode_flags(ps)
    _, role_w, tx_w = pe.packed_round_head(ps, cfg, flags)
    k_push, k_pull = prng.split(ps.rng, 5)[1:3]
    if shard is None:
        def deliver():
            return pe._disseminate_local_packed(ps, cfg, flags, role_w, tx_w, k_push, k_pull, plan)

        def whole():
            return engine.gossip_round(ps, cfg, plan)
    else:
        def deliver():
            return dist.mesh._disseminate_bucketed_packed(ps, cfg, shard[0], plan, flags, role_w, tx_w, k_push,
                                                          k_pull)

        def whole():
            return dist.gossip_round_dist(ps, cfg, shard[0], shard[1], plan)
    inc_w, _ = deliver()
    rnd = ps.round + 1
    if plan is None and shard is None:
        def codec():
            return pack_bits(unpack_bits(tx_w, m))
    else:
        def codec():
            return (unpack_bits(role_w, m), unpack_bits(ps.seen, m), pack_bits(unpack_bits(tx_w, m)))
    stages = {
        "key_splits": lambda: prng.split(prng.split(prng.split(ps.rng, 5)[1])[0]),
        "decode_flags": lambda: pe._decode_flags(ps),
        "head_words": lambda: pe.packed_round_head(ps, cfg, flags),
        "codec": codec,
        "delivery_with_codec": deliver,
        "liveness": lambda: detect_failures(
            emit_heartbeats(ps.last_hb, flags["alive"], flags["silent"], flags["declared_dead"], rnd,
                            cfg.hb_period_rounds),
            flags["alive"], flags["silent"], flags["declared_dead"], rnd, cfg.timeout_rounds,
            cfg.detect_period_rounds),
        "tail_k4": lambda: round_tail_words(
            ps.seen, ps.forwarded, ps.infected_round, ps.recovered, inc_w, role_w, tx_w, None, rnd,
            m=m, forward_once=False, sir_recover_rounds=0),
        "stats": lambda: pe._stats_packed(ps, flags, torch.zeros((), dtype=torch.int32, device=rnd.device)),
        "whole_round": whole,
    }
    return {name: _event_ms(fn, reps) for name, fn in stages.items()}


def churn_stage_times(state, cfg, reps: int, remat_cap: int | None, shard=None) -> dict:
    """The churn round's own stages on an unpacked state, timed alone (ms);
    ``shard`` (the ``(mesh, plans)`` pair) adds the epoch re-partition."""
    from tpu_gossip_torch.sim import stages as st

    _, transmitter, receptive = engine.compute_roles(state)
    transmit = engine.transmit_bitmap(state, cfg, transmitter)
    _, _, _, k_leave, k_join = prng.split(state.rng, 5)
    churn = st._churn_stage(cfg)
    values = {name: getattr(state, name) for name in churn.reads if hasattr(state, name)}
    values.update(rnd=state.round + 1, k_leave=k_leave, k_join=k_join)
    k_rw = prng.split(prng.split(state.rng, 5)[1])[1]
    stages = {"churn_draws": lambda: churn.fn(st.StageView(values, churn))}
    if cfg.rewire_slots > 0:
        stages["fresh_side_paths"] = lambda: engine.fresh_rewire_traffic(
            state, cfg, transmit, state.seen & transmitter, receptive.any(-1), k_rw, k_rw,
            do_pull=cfg.mode == "push_pull")
    if remat_cap is not None:
        stages["remat"] = lambda: engine.rematerialize_rewired(state, cfg, remat_cap)
    if shard is not None and remat_cap is not None:
        mesh, plans = shard

        def repartition():
            sg, st2, _ = dist.repartition_swarm(state, mesh.size, seed=1)
            dist.shard_swarm(st2, mesh)
            return dist.build_shard_plans(sg) if plans is not None else sg

        stages["repartition"] = repartition
    return {name: _event_ms(fn, reps if name not in ("remat", "repartition") else max(1, reps // 10))
            for name, fn in stages.items()}


def trace_rounds(state, step, rounds: int) -> dict:
    """torch.profiler over ``rounds`` rounds: device time by kernel name
    (kernel rows only, so no time is counted twice) and the device's busy
    share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = state
        for _ in range(rounds):
            s, _ = step(s)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (ev.key, ev.self_device_time_total / 1e3, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {
        "wall_ms_per_round": wall_ms / rounds,
        "device_ms_per_round": busy_ms / rounds,
        "device_busy_share": busy_ms / wall_ms if wall_ms else 0.0,
        "top_kernels_ms_per_round": [
            {"name": k[:90], "ms": ms / rounds, "calls": c / rounds} for k, ms, c in rows[:25]
        ],
    }


def _fanout(args) -> int:
    """The round's fanout: bench_stream's 2 under --stream, bench_control's
    3 under --control, else the headline's 1."""
    if getattr(args, "stream", 0.0) > 0:
        return 2
    return CONTROL_FANOUT if getattr(args, "control", 0.0) > 0 else 1


CONTROL_FANOUT = 3  # bench_control's static fanout; its bounds are 1..2x


def _cfg_kw(args) -> dict:
    stream = getattr(args, "stream", 0.0) > 0
    return dict(msg_slots=32 if stream else 16, fanout=_fanout(args), mode="push_pull",
                churn_leave_prob=args.churn_leave,
                churn_join_prob=args.churn_join,
                rewire_slots=max(args.rewire_slots, GROW_ATTACH) if getattr(args, "grow", 0) else args.rewire_slots,
                rewire_compact_cap=args.rewire_compact_cap)


GROW_ATTACH = 3


def growth_stage_times(state, cfg, plan, grow, reps: int) -> dict:
    """The growth stage on a warm state, timed alone (ms), and split: the
    Gumbel draw, the top-k over its scores (precomputed) and the rest
    (cursor, log degrees, scatters); then the whole round with and without
    the schedule."""
    from tpu_gossip_torch.core.streams import GROWTH_STREAM_SALT
    from tpu_gossip_torch.growth import engine as ge

    n = state.exists.shape[0]
    jb, m = grow.max_batch, grow.attach_m
    chunk = ge.draw_chunk_rows(n, state.exists.device)
    key = prng.fold_in(state.rng, GROWTH_STREAM_SALT)
    planes = {f: getattr(state, f) for f in ("exists", "alive", "silent", "last_hb", "declared_dead", "rewired",
                                               "rewire_targets", "join_round", "admitted_by", "degree_credit")}
    rnd = state.round + 1
    zero = torch.zeros((), dtype=torch.int32, device=rnd.device)
    log_deg = ge.attach_log_degrees(state.row_ptr, state.exists, state.alive, state.declared_dead, state.rewired,
                                    state.rewire_targets, state.degree_credit)
    chunks = [(r0, min(jb, r0 + chunk)) for r0 in range(0, jb, chunk)]

    def draw():
        return [prng.gumbel(key, (r1 - r0, n), offset=r0 * n) for r0, r1 in chunks]

    scores = [log_deg[None, :] + g for g in draw()]
    # graftlint: disable=key-linearity -- the stage timer replays the round's draws on purpose
    finite, targets = ge.gumbel_top_k(key, log_deg, jb, m)

    def scatters():
        rows, live = ge.admission_batch(grow, state.exists, zero)
        ge.attach_log_degrees(state.row_ptr, state.exists, state.alive, state.declared_dead, state.rewired,
                              state.rewire_targets, state.degree_credit)
        return ge.admit(grow, rows, live, finite, targets, rnd, **planes)

    stages = {
        "growth": lambda: ge.apply_growth(grow, state.rng, rnd, zero, row_ptr=state.row_ptr, **planes),
        "growth_draw": draw,
        "growth_top_k": lambda: [ge._top_k_tie_low(sc, m) for sc in scores],
        "growth_scatters": scatters,
        "growth_round": lambda: engine.gossip_round(state, cfg, plan, growth=grow),
        "plain_round": lambda: engine.gossip_round(state, cfg, plan),
    }
    out = {name: _event_ms(fn, reps) for name, fn in stages.items()}
    out["growth_chunk_rows"] = chunk
    return out


def _host_ms(fn, reps: int) -> float:
    """Wall ms of a host-side call, mean over ``reps``."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


STREAM_PEAK_RATE = 4.0  # bench_stream's largest rate: the batch every rate compiles to


def bench_stream_workload(state, cfg, exists, rate: float, device):
    """``bench.py::bench_stream``'s compiled stream at ``rate`` for a swarm
    whose real rows ``exists`` marks: TTL ``1.5 * min_feasible_ttl(n,
    fanout)`` and the peak rate's batch."""
    from tpu_gossip_torch.traffic import compile_stream, default_max_inject, min_feasible_ttl

    rows = np.flatnonzero(exists.cpu().numpy()) if exists is not None else np.arange(state.seen.shape[0])
    return compile_stream(rate=rate, msg_slots=cfg.msg_slots, ttl=int(1.5 * min_feasible_ttl(rows.size, cfg.fanout)),
                          origin_rows=rows, max_inject=default_max_inject(STREAM_PEAK_RATE), device=device)


def stream_stage_times(state, cfg, plan, strm, reps: int) -> dict:
    """The stream's stages on a loaded state, timed alone (ms): the
    age-out, the injection whole and in its parts, the per-slot columns,
    and the round with and without the stream."""
    from tpu_gossip_torch.sim.stages import _stream_ageout_stage, run_stages
    from tpu_gossip_torch.traffic import engine as tr

    rnd = state.round + 1
    host_rnd, host_rng = int(state.round) + 1, state.rng.cpu()
    n, m = state.seen.shape
    planes = dict(row_ptr=state.row_ptr, col_idx=state.col_idx, exists=state.exists)
    n_arr = tr.round_arrivals(strm, host_rng, host_rnd)
    origins, slots = tr.stream_draws(strm, state.rng, n=n, m=m, **planes)
    safe_o = torch.clamp(origins[:n_arr], 0, n - 1).to(torch.int64)
    ok = state.exists[safe_o] & state.alive[safe_o] & ~state.declared_dead[safe_o]
    _, landed, _ = tr.land_arrivals(state.slot_lease, slots[:n_arr], ok, rnd, strm.k_hashes)
    live = state.alive & ~state.declared_dead
    ageout = _stream_ageout_stage(strm)
    zero = torch.zeros((), dtype=torch.int32, device=rnd.device)
    stages = {
        "stream_ageout": lambda: run_stages((ageout,), {"slot_lease": state.slot_lease, "rnd": rnd,
                                                        "held": state.fault_held}),
        "stream_inject": lambda: tr.apply_stream(
            strm, state.rng, rnd, zero, seen=state.seen, infected_round=state.infected_round,
            slot_lease=state.slot_lease, alive=state.alive, declared_dead=state.declared_dead, host_rng=host_rng,
            host_rnd=host_rnd, **planes),
        "stream_draws": lambda: tr.stream_draws(strm, state.rng, n=n, m=m, **planes),
        "stream_landing": lambda: tr.land_arrivals(state.slot_lease, slots[:n_arr], ok, rnd, strm.k_hashes),
        "stream_scatter": lambda: tr.scatter_arrivals(state.seen, state.infected_round, safe_o, slots[:n_arr],
                                                      landed, rnd),
        "slot_stats": lambda: engine.slot_tracks(state.seen, live, state.slot_lease, state.round, strm),
        "stream_round": lambda: engine.gossip_round(state, cfg, plan, stream=strm, host_rng=host_rng,
                                                    host_round=host_rnd - 1),
        "plain_round": lambda: engine.gossip_round(state, cfg, plan),
    }
    out = {name: _event_ms(fn, reps) for name, fn in stages.items()}
    out["stream_poisson_host"] = _host_ms(lambda: tr.round_arrivals(strm, host_rng, host_rnd), reps)
    out["stream_arrivals"] = n_arr
    return out


def control_stage_times(state, cfg, plan, ctl, reps: int) -> dict:
    """The control stage's rows on a warm controlled state, timed alone
    (ms), its feedback read off the next round: the resolve, the AIMD
    update, the PeerSwap refresh at full shape (over the state's whole
    re-wiring table, every row drawing) and the round with and without
    the controller."""
    import dataclasses

    from tpu_gossip_torch.control.engine import apply_control, control_round, peerswap_refresh

    rc = control_round(ctl, state, want_needy=True)
    nxt, _ = engine.gossip_round(state, cfg, plan, control=ctl)
    rnd = state.round + 1
    feedback = dict(incoming=nxt.seen, seen_prev=state.seen, seen=nxt.seen, alive=state.alive,
                    declared_dead=state.declared_dead, exists=state.exists, rewired=state.rewired,
                    rewire_targets=state.rewire_targets, degree_credit=state.degree_credit, row_ptr=state.row_ptr,
                    col_idx=state.col_idx, slot_lease=state.slot_lease, rewire_slots=0)
    every = dataclasses.replace(ctl, refresh_every=1)
    refresh = dict(exists=state.exists, rewired=state.rewired, alive=state.alive,
                   rewire_targets=state.rewire_targets, degree_credit=state.degree_credit, row_ptr=state.row_ptr,
                   col_idx=state.col_idx, rewire_slots=state.rewire_targets.shape[1])
    return {
        "control_resolve": _event_ms(lambda: control_round(ctl, state, want_needy=True), reps),
        "control_apply": _event_ms(lambda: apply_control(ctl, state.rng, rnd, rc, **feedback), reps),
        "control_refresh": _event_ms(lambda: peerswap_refresh(every, state.rng, rnd, **refresh), reps),
        "controlled_round": _event_ms(lambda: engine.gossip_round(state, cfg, plan, control=ctl), reps),
        "plain_round": _event_ms(lambda: engine.gossip_round(state, cfg, plan), reps),
    }


def _churn_keys(args) -> dict:
    return {k: getattr(args, k) for k in ("churn_leave", "churn_join", "rewire_slots", "rewire_compact_cap",
                                          "remat_every")}


def _with_share(churn: dict, remat_every: int) -> dict:
    """The churn stages, with the fold's share of ``remat_every`` rounds."""
    if "remat" in churn:
        churn = dict(churn, remat_per_round=churn["remat"] / remat_every)
    return churn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--peers", type=int, default=1_000_000)
    p.add_argument("--graph", choices=["matching", "device", "pa"], default="matching")
    p.add_argument("--staircase", action="store_true", help="deliver the CSR graphs through K5")
    p.add_argument("--packed", action="store_true",
                   help="profile the packed round (no --staircase, except with --shard)")
    p.add_argument("--shard", action="store_true",
                   help="profile the bucketed sharded round on a one-shard mesh (--graph device or pa)")
    p.add_argument("--churn-leave", type=float, default=0.0, help="per-round leave probability")
    p.add_argument("--churn-join", type=float, default=0.0, help="per-round rejoin probability")
    p.add_argument("--rewire-slots", type=int, default=0, help="fresh degree-preferential edges per rejoiner")
    p.add_argument("--rewire-compact-cap", type=int, default=0, help="rows of the fresh side paths' table (0 = dense)")
    p.add_argument("--remat-every", type=int, default=0,
                   help="time one CSR fold (and, with --shard, the epoch re-partition) and its share of R rounds")
    p.add_argument("--scenario", type=str, default="",
                   help="fault schedule (TOML) the warm and traced rounds run under (local unpacked round)")
    p.add_argument("--quorum-k", type=int, default=0,
                   help="run the rounds under the quorum detector with this quorum (window 4, budget 3) and time "
                   "its stages (local unpacked round; 0 = the direct detector)")
    p.add_argument("--grow", type=int, default=0, metavar="TARGET",
                   help="build the swarm at capacity TARGET and run every round growing toward it (local round)")
    p.add_argument("--grow-rate", type=int, default=256, help="joins a round under --grow")
    p.add_argument("--stream", type=float, default=0.0, metavar="RATE",
                   help="run every round under bench_stream's workload at RATE arrivals a round (32 slots, "
                   "fanout 2; local round) and time the stream's stages")
    p.add_argument("--control", type=float, default=0.0, metavar="TARGET",
                   help="run every round under bench_control's policy (fanout 3, bounds 1..6, push_pull) at this "
                   "delivery-ratio target and time the control stage's rows (local unpacked round)")
    p.add_argument("--warm", type=int, default=6)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    dev = torch.device("cuda", 0)
    if args.remat_every > 0 and (args.graph == "matching" or args.packed):
        raise SystemExit("--remat-every folds a CSR graph's unpacked state (--graph device or pa, no --packed)")
    if args.shard:
        if args.scenario or args.quorum_k or args.stream or args.control:
            raise SystemExit("--scenario, --quorum-k, --stream and --control profile the local unpacked round; "
                             "drop --shard")
        return main_shard(args, dev)
    if args.packed and args.quorum_k:
        raise SystemExit("--quorum-k profiles the local unpacked round; drop --packed")
    if args.stream and (args.packed or args.scenario or args.quorum_k or args.grow or args.remat_every):
        raise SystemExit("--stream profiles the local unpacked round; drop --packed, --scenario, --quorum-k, "
                         "--grow and --remat-every")
    if args.control and (args.packed or args.scenario or args.quorum_k or args.grow or args.stream
                         or args.remat_every):
        raise SystemExit("--control profiles the local unpacked round; drop --packed, --scenario, --quorum-k, "
                         "--grow, --stream and --remat-every")
    if args.grow and (args.packed or args.scenario or args.quorum_k or args.remat_every or args.shard
                      or args.grow <= args.peers):
        raise SystemExit("--grow profiles the local unpacked round to a TARGET above --peers; drop --packed, "
                         "--shard, --scenario, --quorum-k and --remat-every")
    lqs = None
    if args.quorum_k:
        from tpu_gossip_torch.kernels.liveness import compile_quorum

        lqs = compile_quorum(args.quorum_k)
    n = args.peers
    exists = plan = grow = None
    if args.graph == "matching" and args.grow:
        dgraph, plan = matching_powerlaw_graph_sharded(n, 1, fanout=1, key=prng.key(0, dev),
                                                       growth_rows=args.grow - n, device=dev)
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
    elif args.graph == "matching":
        dgraph, plan = matching_powerlaw_graph(n, fanout=_fanout(args), key=prng.key(0, dev), device=dev)
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
    elif args.graph == "device":
        dgraph = device_powerlaw_graph(n, gamma=2.5, key=prng.key(0, dev), device=dev)
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
    else:
        graph = topology.build_csr(n, topology.preferential_attachment(n, 3, rng=np.random.default_rng(0)))
    n_initial = graph.n
    if args.grow and args.graph != "matching":
        from tpu_gossip_torch.growth import pad_graph_for_growth

        # bench_grow's layout: the device graph's sentinel row stays a
        # non-member and admission starts past it
        graph, pad_exists = pad_graph_for_growth(graph, args.grow + (n_initial - n))
        if exists is not None:
            pad_exists[:n_initial] = exists.cpu().numpy()
        exists = torch.from_numpy(pad_exists).to(dev)
    if args.graph != "matching" and args.staircase:
        plan = seg.build_staircase_plan(graph.row_ptr, graph.col_idx, fanout=_fanout(args), device=dev)
    cfg = SwarmConfig(n_peers=graph.n, **_cfg_kw(args))
    origins = None if args.stream else np.random.default_rng(0).choice(n, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=exists, device=dev)
    cap = engine.remat_capacity(state, cfg) if args.remat_every > 0 else None
    strm = bench_stream_workload(state, cfg, exists, args.stream, dev) if args.stream else None
    ctl = None
    if args.control:
        from tpu_gossip_torch.control import compile_control

        ctl = compile_control(target_ratio=args.control, fanout=cfg.fanout, lo=1, hi=2 * cfg.fanout, device=dev)
    if args.grow:
        from tpu_gossip_torch.growth import compile_growth, matching_admit_rows

        admit = matching_admit_rows(plan, args.grow - n) if args.graph == "matching" else None
        grow = compile_growth(n_initial=n if admit is not None else n_initial,
                              target=args.grow if admit is not None else graph.n, n_slots=graph.n,
                              joins_per_round=args.grow_rate, attach_m=GROW_ATTACH, admit_rows=admit, device=dev)
    sc = None
    if args.scenario:
        if args.packed:
            raise SystemExit("--scenario profiles the local unpacked round; drop --packed")
        from tpu_gossip_torch.faults import compile_scenario, parse_scenario

        spec = parse_scenario(args.scenario)
        sc = compile_scenario(spec, n_peers=n, n_slots=graph.n, device=dev,
                              total_rounds=max(spec.last_round, args.warm + args.rounds))
    state, _ = engine.simulate(state, cfg, args.warm, plan, scenario=sc, liveness=lqs, growth=grow, stream=strm,
                               control=ctl)
    churn = churn_stage_times(state, cfg, args.reps, cap) if has_churn(cfg) else {}
    if args.packed:
        if args.staircase:
            raise SystemExit("--packed profiles the matching and exactly-k paths; drop --staircase")
        state = pack_state(state)
        stages = packed_stage_times(state, cfg, plan, args.reps)
    elif args.graph == "matching":
        stages = stage_times(state, cfg, plan, args.reps)
    elif plan is not None:
        stages = staircase_stage_times(state, cfg, plan, args.reps)
    else:
        stages = {"whole_round": _event_ms(lambda: engine.gossip_round(state, cfg, None), args.reps)}
    stages.update(_with_share(churn, args.remat_every))
    if sc is not None:
        stages.update(fault_stage_times(state, cfg, plan, sc, args.warm, args.reps, lqs))
    if lqs is not None:
        stages.update(liveness_stage_times(state, cfg, sc, lqs, args.warm, args.reps))
    if grow is not None:
        stages.update(growth_stage_times(state, cfg, plan, grow, args.reps))
    if strm is not None:
        stages.update(stream_stage_times(state, cfg, plan, strm, args.reps))
    if ctl is not None:
        stages.update(control_stage_times(state, cfg, plan, ctl, args.reps))
    print(json.dumps({"graph": args.graph, "staircase": plan is not None and args.graph != "matching",
                      "packed": args.packed, **_churn_keys(args), "scenario": args.scenario or None,
                      "quorum_k": args.quorum_k or None, "grow": args.grow or None, "stream": args.stream or None,
                      "control": args.control or None, "slot_ttl": strm.ttl if strm is not None else None,
                      "stage_ms": stages}))
    rnd = [args.warm]
    hkey = [state.rng.cpu() if strm is not None else None]

    def step(s):
        out = engine.gossip_round(s, cfg, plan, scenario=sc,
                                  host_round=rnd[0] if sc is not None or strm is not None else None,
                                  liveness=lqs, growth=grow, stream=strm, host_rng=hkey[0], control=ctl)
        rnd[0] += 1
        hkey[0] = next_host_key(hkey[0])
        return out

    print(json.dumps({"trace": trace_rounds(state, step, args.rounds)}))
    return 0


def fault_stage_times(state, cfg, plan, sc, at: int, reps: int, lqs=None) -> dict:
    """The fault head's own cost on a warm state at round ``at``: its two
    ``(N, M)`` uniforms (drawn whether or not a phase is lossy, when any
    is), the whole round under the scenario and the same round without
    (both under the quorum detector ``lqs`` when it is given)."""
    from tpu_gossip_torch.core.streams import FAULT_STREAM_SALT

    k_loss, k_delay, _, _ = prng.split(prng.fold_in(state.rng, FAULT_STREAM_SALT), 4)
    shape = tuple(state.seen.shape)
    out = {}
    if sc.has_loss_delay:
        out["fault_draws"] = _event_ms(lambda: (prng.uniform(k_loss, shape), prng.uniform(k_delay, shape)), reps)
    out["fault_round"] = _event_ms(
        lambda: engine.gossip_round(state, cfg, plan, scenario=sc, host_round=at, liveness=lqs), reps)
    out["plain_round"] = _event_ms(lambda: engine.gossip_round(state, cfg, plan, liveness=lqs), reps)
    return out


def liveness_stage_times(state, cfg, sc, lqs, at: int, reps: int) -> dict:
    """The quorum detector's cost on a warm state at round ``at``: the
    hardened liveness stage alone (with the scenario's adversaries and
    faults when ``sc`` is given) beside the direct stage, and under an
    adversary scenario the adversary stream's draws and the flood replay."""
    from tpu_gossip_torch.faults.inject import flood_replay
    from tpu_gossip_torch.sim.stages import _liveness_stage, adversary_keys, run_stages

    rf = None if sc is None else sc.at_round(at + 1)
    k_accuse, k_forge, k_flood = adversary_keys(sc, state.rng)
    values = {name: getattr(state, name) for name in (
        "silent", "alive", "declared_dead", "last_hb", "exists", "suspect_round", "suspect_mark", "quarantine",
        "rewired", "rewire_targets", "degree_credit")}
    values.update(rnd=state.round + 1, faults=rf, k_accuse=k_accuse, k_forge=k_forge)
    hardened = _liveness_stage(cfg, rf, lqs)
    direct = _liveness_stage(cfg, rf)
    out = {"liveness": _event_ms(lambda: run_stages((hardened,), dict(values)), reps),
           "liveness_direct": _event_ms(lambda: run_stages((direct,), dict(values)), reps)}
    if sc is None or not sc.has_adversary:
        return out
    n = state.alive.shape[0]
    widths = ((), (sc.max_forge_fanout,), (sc.max_flood_fanout,))
    drawn = (sc.has_accusers, sc.has_forgers, sc.has_floods)

    def draws():
        keys = adversary_keys(sc, state.rng)
        return [prng.randint(k, (n, *w), 0, n) for k, w, on in zip(keys, widths, drawn) if on]

    out["adv_draws"] = _event_ms(draws, reps)
    if sc.has_floods:
        flood_ok = rf.flooder & state.alive & ~state.declared_dead & ~state.quarantine
        if sc.has_blackout:
            flood_ok = flood_ok & ~rf.blackout
        out["flood_replay"] = _event_ms(lambda: flood_replay(sc, rf, state.seen, flood_ok, k_flood), reps)
    return out


def main_shard(args, dev) -> int:
    """``--shard``: the CSR graph on the host, ``partition_graph`` over a
    one-shard mesh, K6's plans with ``--staircase``, warm rounds, then the
    sharded round's stages and trace."""
    n = args.peers
    if args.graph == "matching":
        raise SystemExit("--shard profiles the CSR graphs (--graph device or pa)")
    if args.graph == "device":
        graph = device_powerlaw_graph(n, gamma=2.5, key=prng.key(0, dev), device=dev).to_host_graph()
    else:
        graph = topology.build_csr(n, topology.preferential_attachment(n, 3, rng=np.random.default_rng(0)))
    mesh = dist.make_mesh(device=dev)
    sg, rel, pos = dist.partition_graph(graph, mesh.size, device=dev)
    plan = dist.build_shard_plans(sg) if args.staircase else None
    cfg = SwarmConfig(n_peers=sg.n_pad, **_cfg_kw(args))
    origins = np.random.default_rng(0).choice(n, size=1, replace=False)
    state = dist.shard_swarm(dist.init_sharded_swarm(sg, rel, pos, cfg, key=prng.key(0, dev), origins=origins,
                                                     device=dev), mesh)
    cap = engine.remat_capacity(state, cfg) if args.remat_every > 0 else None
    state, _ = dist.simulate_dist(state, cfg, sg, mesh, args.warm, plan)
    churn = churn_stage_times(state, cfg, args.reps, cap, shard=(mesh, plan)) if has_churn(cfg) else {}
    if args.packed:
        state = pack_state(state)
        stages = packed_stage_times(state, cfg, plan, args.reps, shard=(sg, mesh))
    else:
        stages = shard_stage_times(state, cfg, sg, mesh, plan, args.reps)
    stages.update(_with_share(churn, args.remat_every))
    print(json.dumps({"graph": args.graph, "shard": True, "shards": mesh.size, "staircase": plan is not None,
                      "packed": args.packed, **_churn_keys(args), "stage_ms": stages}))
    step = lambda s: dist.gossip_round_dist(s, cfg, sg, mesh, plan)  # noqa: E731
    print(json.dumps({"trace": trace_rounds(state, step, args.rounds)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
