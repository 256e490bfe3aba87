"""Where one round's time goes, on the card.

    python -m tpu_gossip_torch.sim.profile --peers 1000000 --warm 6
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --graph device --staircase
    python -m tpu_gossip_torch.sim.profile --peers 1000000 --packed

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
graph and ``--graph device`` without ``--staircase``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpu_gossip_torch.core import prng, topology
from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
from tpu_gossip_torch.kernels import pallas_segment as seg
from tpu_gossip_torch.kernels.liveness import detect_failures, emit_heartbeats
from tpu_gossip_torch.kernels.pallas_segment import pack_words, popcount, unpack_words
from tpu_gossip_torch.core.packed import pack_bits, pack_state, unpack_bits
from tpu_gossip_torch.kernels.round_tail import round_tail, round_tail_words
from tpu_gossip_torch.sim import engine
from tpu_gossip_torch.sim import packed_engine as pe


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
        "draw_bits_x2": lambda: (prng.bits(k_push, shape) < plan.push_thresh,
                                 prng.bits(k_pull, shape) < plan.pull_thresh),
        "word_gather": lambda: seg._gather_words(plan, transmit),
        "mask_combine_bill": mask_bill,
        "k5_and_unpack": lambda: seg._launch(plan, combined, transmit.shape[1], bill=bill),
        **tail,
    }
    return {name: _event_ms(fn, reps) for name, fn in stages.items()}


def packed_stage_times(ps, cfg, plan, reps: int) -> dict:
    """Each stage of one packed round, timed alone (ms). ``codec`` is the
    decode and repack that the delivery pays: three planes and the
    product on a plan's path, the push payload and product on the
    word-native exactly-k path."""
    m = ps.msg_slots
    flags = pe._decode_flags(ps)
    _, role_w, tx_w = pe.packed_round_head(ps, cfg, flags)
    k_push, k_pull = prng.split(ps.rng, 5)[1:3]
    inc_w, _ = pe._disseminate_local_packed(ps, cfg, flags, role_w, tx_w, k_push, k_pull, plan)
    rnd = ps.round + 1
    if plan is None:
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
        "delivery_with_codec": lambda: pe._disseminate_local_packed(ps, cfg, flags, role_w, tx_w, k_push,
                                                                    k_pull, plan),
        "liveness": lambda: detect_failures(
            emit_heartbeats(ps.last_hb, flags["alive"], flags["silent"], flags["declared_dead"], rnd,
                            cfg.hb_period_rounds),
            flags["alive"], flags["silent"], flags["declared_dead"], rnd, cfg.timeout_rounds,
            cfg.detect_period_rounds),
        "tail_k4": lambda: round_tail_words(
            ps.seen, ps.forwarded, ps.infected_round, ps.recovered, inc_w, role_w, tx_w, None, rnd,
            m=m, forward_once=False, sir_recover_rounds=0),
        "stats": lambda: pe._stats_packed(ps, flags, torch.zeros((), dtype=torch.int32, device=rnd.device)),
        "whole_round": lambda: engine.gossip_round(ps, cfg, plan),
    }
    return {name: _event_ms(fn, reps) for name, fn in stages.items()}


def trace_rounds(state, cfg, plan, rounds: int) -> dict:
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
            s, _ = engine.gossip_round(s, cfg, plan)
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--peers", type=int, default=1_000_000)
    p.add_argument("--graph", choices=["matching", "device", "pa"], default="matching")
    p.add_argument("--staircase", action="store_true", help="deliver the CSR graphs through K5")
    p.add_argument("--packed", action="store_true", help="profile the packed round (no --staircase)")
    p.add_argument("--warm", type=int, default=6)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    dev = torch.device("cuda", 0)
    n = args.peers
    exists = plan = None
    if args.graph == "matching":
        dgraph, plan = matching_powerlaw_graph(n, fanout=1, key=prng.key(0, dev), device=dev)
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
    elif args.graph == "device":
        dgraph = device_powerlaw_graph(n, gamma=2.5, key=prng.key(0, dev), device=dev)
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
    else:
        graph = topology.build_csr(n, topology.preferential_attachment(n, 3, rng=np.random.default_rng(0)))
    if args.graph != "matching" and args.staircase:
        plan = seg.build_staircase_plan(graph.row_ptr, graph.col_idx, fanout=1, device=dev)
    cfg = SwarmConfig(n_peers=graph.n, msg_slots=16, fanout=1, mode="push_pull")
    origins = np.random.default_rng(0).choice(n, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=exists, device=dev)
    state, _ = engine.simulate(state, cfg, args.warm, plan)
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
    print(json.dumps({"graph": args.graph, "staircase": plan is not None and args.graph != "matching",
                      "packed": args.packed, "stage_ms": stages}))
    print(json.dumps({"trace": trace_rounds(state, cfg, plan, args.rounds)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
