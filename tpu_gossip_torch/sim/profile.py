"""Where one headline round's time goes, on the card.

    python -m tpu_gossip_torch.sim.profile --peers 1000000 --warm 6

Builds the headline swarm (matching graph, push_pull, fanout 1, 16 slots),
advances ``--warm`` rounds so the slot planes are mid-epidemic, then
prints JSON lines: the time of each stage of the round taken alone (CUDA
events, mean over ``--reps`` calls), the whole round, and a
``torch.profiler`` trace of ``--rounds`` rounds summed by kernel name with
the device's busy share of the wall time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
from tpu_gossip_torch.kernels.liveness import detect_failures, emit_heartbeats
from tpu_gossip_torch.kernels.round_tail import round_tail
from tpu_gossip_torch.kernels.segment import pack_words, popcount, unpack_words
from tpu_gossip_torch.sim import engine


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


def stage_times(state, cfg, plan, reps: int) -> dict:
    """Each stage of one sampled push-pull round, timed alone (ms)."""
    shape = (plan.rows, 128)
    _, transmitter, receptive = engine.compute_roles(state)
    transmit = engine.transmit_bitmap(state, cfg, transmitter)
    key = prng.split(state.rng, 5)[1]
    words = pack_words(transmit[: plan.n])
    slot_tx = plan.partner(plan.expand(words))
    rnd = state.round + 1
    stages = {
        "key_splits": lambda: prng.split(prng.split(prng.split(state.rng, 5)[1])[0]),
        "roles_transmit": lambda: engine.transmit_bitmap(state, cfg, engine.compute_roles(state)[1]),
        "draw_bits_x2": lambda: (prng.bits(key, shape), prng.bits(key, shape)),
        "thresholds_push_pull": lambda: (plan.push_threshold(), plan.pull_threshold()),
        "pack_expand": lambda: plan.expand(pack_words(transmit[: plan.n])),
        "partner_pass": lambda: plan.partner(slot_tx),
        "reduce_or": lambda: plan.reduce(slot_tx, "or"),
        "popcount_bill": lambda: popcount(slot_tx).sum(),
        "unpack": lambda: unpack_words(words, transmit.shape[1]),
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
    p.add_argument("--warm", type=int, default=6)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    if not torch.cuda.is_available():
        raise SystemExit("profile needs a CUDA device")
    dgraph, plan = matching_powerlaw_graph(args.peers, fanout=1, key=prng.key(0, dev), device=dev)
    graph = dgraph.as_padded_graph()
    cfg = SwarmConfig(n_peers=graph.n, msg_slots=16, fanout=1, mode="push_pull")
    origins = np.random.default_rng(0).choice(args.peers, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=dgraph.exists, device=dev)
    state, _ = engine.simulate(state, cfg, args.warm, plan)
    print(json.dumps({"stage_ms": stage_times(state, cfg, plan, args.reps)}))
    print(json.dumps({"trace": trace_rounds(state, cfg, plan, args.rounds)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
