"""Run a whole gossip swarm on the card.

    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph chung-lu --staircase
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --packed
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph chung-lu --shard --staircase
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --profile-round 6
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --churn-leave 0.002 --churn-join 0.02 \\
        --rewire-slots 2 --rewire-compact-cap 65536 --rounds 16 --digest

Ports the local path of ``tpu_gossip/cli/run_sim.py``: build the graph
(``--graph matching`` on the device; ``pa`` by the C++ preferential
attachment with ``--m`` edges per node, or ``chung-lu``, the configuration
model, both on the host from ``np.random.default_rng(seed)``), with
``--staircase`` a host-built staircase plan for the CSR families, then
seed the origins drawn from the same ``rng`` after the graph, exactly as
the JAX CLI draws them. Then either run a fixed ``--rounds`` horizon (one
JSON row per round, then the summary, with ``state_digest`` and
``stats_digest`` under ``--digest``) or run to ``--target`` coverage and
print the benchmark summary. With ``--packed`` the seeded state is packed
(``core/packed.py``), the rounds run on its words, and the final state is
unpacked before the digest, as the JAX CLI does. With ``--shard`` the CSR
graphs run on the bucketed sharded engine (``dist/mesh.py``) over a mesh
of one shard per card (one on the CPU), its receive through K6 with
``--staircase``; the summary adds ``devices`` and ``transport`` (always
``dense``), as the JAX CLI's does. ``--churn-leave``/``--churn-join``
run Poisson churn on every engine, with ``--rewire-slots`` fresh
degree-preferential edges per rejoiner (``--rewire-compact-cap`` bounds
their side paths to a table of rewired rows); ``--remat-every R`` folds
the fresh edges into the CSR every R rounds (``rematerialize_rewired``),
rebuilding the staircase plan, and under ``--shard`` re-partitioning the
swarm and rebuilding K6's plans. The summary keys are the JAX CLI's.
``--profile-round R`` advances R rounds of the local unpacked engine and
prints the slope-timed stage decomposition of its round instead
(``utils/profiling.py``); ``--profile DIR`` records a ``torch.profiler``
trace of the run. Runs on ``--device cuda`` unless told otherwise; every
other flag of the JAX CLI is not ported yet and exits 2 (the checkpoint
flags, the checkpointed remat loops among them, come with the checkpoint
slice).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_LATER = (
    "this flag is not ported yet; the port runs the local engine over the "
    "matching, preferential-attachment and Chung-Lu graphs, packed or not, "
    "and the bucketed sharded engine over the CSR graphs, churn and re-wiring "
    "included (later slices add faults, growth, streams, control, checkpoints, "
    "fleets, the sharded matching engine and the multi-card exchange)"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--peers", type=int, default=1000, help="swarm size N")
    p.add_argument("--graph", choices=["pa", "chung-lu", "matching"], default="pa",
                   help="pa: preferential attachment (C++ generator, host); chung-lu: "
                   "configuration model with P(d)~d^-gamma (host); matching: the "
                   "structured-matching graph built on the device")
    p.add_argument("--gamma", type=float, default=2.5, help="power-law exponent")
    p.add_argument("--m", type=int, default=3, help="edges per new node (pa graph build)")
    p.add_argument("--mode", choices=["push", "push_pull", "flood"], default="push")
    p.add_argument("--fanout", type=int, default=3)
    p.add_argument("--slots", type=int, default=16, help="hash-dedup message slots")
    p.add_argument("--origins", type=int, default=1, help="number of initially infected peers")
    p.add_argument("--target", type=float, default=0.99, help="coverage target")
    p.add_argument("--rounds", type=int, default=0, help="fixed horizon (0 = run to target)")
    p.add_argument("--max-rounds", type=int, default=1000)
    p.add_argument("--forward-once", action="store_true")
    p.add_argument("--sir-recover", type=int, default=0, help="rounds until SIR recovery (0 = off)")
    p.add_argument("--churn-leave", type=float, default=0.0, help="per-round leave probability")
    p.add_argument("--churn-join", type=float, default=0.0, help="per-round rejoin probability")
    p.add_argument("--rewire-slots", type=int, default=0,
                   help="rejoiners attach this many fresh degree-preferential edges (0 = reuse slot edges)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--rewire-compact-cap", type=int, default=0, metavar="CAP",
                   help="bound the fresh-edge side paths to a CAP-row table of rewired peers (O(CAP) instead "
                   "of O(N) random access; at most CAP joiners re-wire per round; pair with --remat-every so "
                   "the rewired set stays under CAP). 0 = exact dense paths")
    p.add_argument("--remat-every", type=int, default=0, metavar="R",
                   help="every R rounds, fold rejoiners' fresh edges into the CSR and clear the rewired set "
                   "(sim.engine.rematerialize_rewired); with --staircase the plan is rebuilt per segment; "
                   "with --shard the fold is followed by a re-partition of the swarm (dist.repartition_swarm: "
                   "fresh bucket tables and shard plans). 0 = off")
    p.add_argument("--staircase", action="store_true",
                   help="deliver through the staircase segment kernel (K5): exact "
                   "segment OR for flood, Bernoulli-per-edge sampling for push and "
                   "push_pull; ignored with --graph matching")
    p.add_argument("--tail", choices=["fused", "reference", "pallas"], default="fused",
                   help="round-tail implementation (fused and pallas launch K3 on the card, "
                   "K4 with --packed; pallas takes the SIR age from the saturated round)")
    p.add_argument("--packed", action="store_true",
                   help="carry the swarm as packed state planes (uint8 bit words, one flags "
                   "byte); the round computes on the words, bit-identical to the unpacked run")
    p.add_argument("--shard", action="store_true",
                   help="run the bucketed sharded engine over a mesh of one shard per card "
                   "(dist/mesh.py); with --staircase each shard's receive runs K6")
    p.add_argument("--profile-round", type=int, default=0, metavar="R",
                   help="instead of the normal run: advance R warm rounds, then slope-time the round's "
                   "stage decomposition (delivery, tail per implementation, liveness, stats, rng, the "
                   "compaction probe, composed round: utils.profiling.profile_round_stages) and print it "
                   "as the summary JSON, the table to stderr. Local engine only, unpacked")
    p.add_argument("--profile", type=str, default="",
                   help="record a torch.profiler trace of the run into this directory (trace.json, "
                   "chrome-trace JSON)")
    p.add_argument("--digest", action="store_true",
                   help="add state_digest/stats_digest to a fixed-horizon summary")
    p.add_argument("--quiet", action="store_true", help="summary line only, no per-round JSONL")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "resume" or any(a.startswith("--checkpoint") for a in argv):
        from tpu_gossip_torch.sim.stages import not_ported

        print(str(not_ported("checkpointing (--checkpoint, --checkpoint-every, resume; the checkpointed remat "
                             "loops among them)", "checkpoints (ROADMAP item 8)")), file=sys.stderr)
        return 2
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"{' '.join(unknown)}: {_LATER}", file=sys.stderr)
        return 2
    if args.packed and args.remat_every > 0:
        print("--packed cannot compose with --remat-every: the epoch fold (rematerialize_rewired / "
              "re-partition) rebuilds the unpacked CSR between segments; run the remat loop unpacked",
              file=sys.stderr)
        return 2
    if args.graph == "matching" and args.remat_every > 0 and not args.shard:
        print("--graph matching cannot re-materialize locally (its pairing IS the delivery plan: a folded CSR "
              "has no pipeline); use --shard, whose remat path falls back to the bucketed-CSR engine on the "
              "exported CSR", file=sys.stderr)
        return 2
    if args.shard and args.tail != "fused":
        print(f"--tail {args.tail} selects the LOCAL engine's tail implementation; the sharded engines "
              "always run the fused tail", file=sys.stderr)
        return 2
    if args.profile_round > 0 and args.shard:
        print("--profile-round decomposes the LOCAL round (use tpu_gossip_torch/experiments/dist_profile.py "
              "for the sharded engine)", file=sys.stderr)
        return 2
    if args.profile_round > 0 and args.packed:
        print("--profile-round decomposes the UNPACKED round's stages; the packed carry adds only the "
              "boundary codec: drop --packed for the decomposition", file=sys.stderr)
        return 2
    from tpu_gossip_torch.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    try:
        summary = run(args)
    except NotImplementedError as e:  # a part of a later slice (not_ported), e.g. --shard on several cards
        print(str(e), file=sys.stderr)
        return 2
    print(json.dumps(summary))
    return 0


def run(args: argparse.Namespace) -> dict:
    """The run body: parsed ``args`` in, the summary dict out (per-round
    JSONL goes to stdout first unless ``--quiet``)."""
    from tpu_gossip_torch.core import prng, topology
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.sim.engine import run_until_coverage, simulate
    from tpu_gossip_torch.sim.stages import not_ported
    from tpu_gossip_torch.utils.profiling import trace

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    exists = plan = None
    if args.graph == "matching":
        if args.shard:
            raise not_ported("--shard --graph matching (the sharded matching engine)", "multi-device (11b)")
        dgraph, plan = matching_powerlaw_graph(
            args.peers, gamma=args.gamma,
            fanout=None if args.mode == "flood" else args.fanout,
            key=prng.key(args.seed, dev), device=dev,
        )
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
        if args.staircase:
            print("note: --staircase is ignored with --graph matching (the "
                  "matching pipeline IS the delivery plan)", file=sys.stderr)
    else:
        if args.graph == "pa":
            edges = topology.preferential_attachment(args.peers, m=args.m, rng=rng)
        else:
            deg = topology.powerlaw_degree_sequence(args.peers, gamma=args.gamma, rng=rng)
            edges = topology.configuration_model(deg, rng=rng)
        graph = topology.build_csr(args.peers, edges)
        if args.staircase and not args.shard and args.remat_every == 0:
            # (with --remat-every the plan is rebuilt per segment instead)
            plan = _staircase_plan(args, graph, dev)
    cfg_kw = dict(msg_slots=args.slots, fanout=args.fanout, mode=args.mode, forward_once=args.forward_once,
                  sir_recover_rounds=args.sir_recover, churn_leave_prob=args.churn_leave,
                  churn_join_prob=args.churn_join, rewire_slots=args.rewire_slots,
                  rewire_compact_cap=args.rewire_compact_cap)
    origins = rng.choice(args.peers, size=min(args.origins, args.peers), replace=False)
    if args.shard:
        cfg, state, horizon, to_target, extra, epoch = _shard_runners(args, graph, origins, cfg_kw, dev)
    else:
        cfg = SwarmConfig(n_peers=graph.n, **cfg_kw)
        state = init_swarm(graph, cfg, key=prng.key(args.seed, dev), origins=origins,
                           exists=exists, device=dev)
        extra = {}

        def horizon(st):
            return simulate(st, cfg, args.rounds, plan, args.tail)

        def to_target(st):
            return run_until_coverage(st, cfg, args.target, args.max_rounds, plan=plan, tail=args.tail)

        if args.profile_round > 0:
            return _profile_round(args, cfg, state, plan)
    with trace(args.profile):
        if args.remat_every > 0 and args.shard:
            summary = _run_shard_with_remat(args, cfg, state, *epoch)
        elif args.remat_every > 0:
            summary = _run_with_remat(args, cfg, state, dev)
        else:
            summary = _run_body(args, cfg, state, horizon, to_target, extra)
    summary["packed"] = args.packed
    return summary


def _staircase_plan(args: argparse.Namespace, graph, dev):
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan

    return build_staircase_plan(graph.row_ptr, graph.col_idx, fanout=None if args.mode == "flood" else args.fanout,
                                device=dev)


def _horizon_summary(args: argparse.Namespace, stats, **extra) -> dict:
    """The fixed-horizon summary row, one schema for every engine."""
    from tpu_gossip_torch.sim import metrics as M

    return {
        "summary": True,
        "n_peers": args.peers,
        "mode": args.mode,
        "rounds_run": args.rounds,
        "rounds_to_target": M.rounds_to_coverage(stats, args.target),
        "final_coverage": float(stats.coverage[-1]),
        "total_msgs": int(stats.msgs_sent.sum()),
        **extra,
    }


def _remat_loop(args: argparse.Namespace, state, run_segment, fold):
    """The epoch loop of both remat runners: segments of ``--remat-every``
    rounds (to the horizon, or until ``--target`` with no horizon), each
    but the last followed by ``fold``. Returns the final state, the
    segments' stats (a horizon only), the number of folds and the wall
    seconds."""
    import time

    total = args.rounds if args.rounds > 0 else args.max_rounds
    parts, remats = [], 0
    t0 = time.perf_counter()
    while int(state.round) < total:
        state, stats = run_segment(state, min(args.remat_every, total - int(state.round)))
        if args.rounds > 0:
            parts.append(stats)
        elif float(state.coverage(0)) >= args.target:
            break
        if int(state.round) < total:
            state = fold(state)
            remats += 1
    return state, parts, remats, time.perf_counter() - t0


def _remat_summary(args: argparse.Namespace, state, parts, wall: float, extra: dict, sim_wall: float) -> dict:
    """The summary of a remat run: the horizon row with the digests, or
    the run-to-target row."""
    from tpu_gossip_torch.sim.engine import _concat
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    if args.rounds > 0:
        stats = _concat(parts)
        if not args.quiet:
            from tpu_gossip_torch.sim import metrics as M

            M.write_jsonl(stats, sys.stdout)
        summary = _horizon_summary(args, stats, **extra)
        if args.digest:
            summary.update(state_digest=state_digest(state), stats_digest=stats_digest(stats))
        return summary
    rounds = int(state.round)
    return {
        "summary": True, "mode": args.mode, "n_peers": args.peers, "rounds": rounds, "target": args.target,
        "wall_seconds": wall, "peers_rounds_per_sec": args.peers * rounds / max(wall, 1e-9),
        "coverage": float(state.coverage(0)), "ms_per_round": sim_wall / max(rounds, 1) * 1000.0, **extra,
    }


def _run_with_remat(args: argparse.Namespace, cfg, state, dev) -> dict:
    """--remat-every R on the local engine: R rounds, then fold the fresh
    edges into the CSR at the capacity taken once from the initial graph;
    with --staircase the plan is rebuilt from each segment's CSR."""
    from tpu_gossip_torch.sim.engine import remat_capacity, rematerialize_rewired, run_until_coverage, simulate

    cap = remat_capacity(state, cfg)
    overflow = []

    def run_segment(st, seg):
        plan = _staircase_plan(args, st, dev) if args.staircase else None
        if args.rounds > 0:
            return simulate(st, cfg, seg, plan, args.tail)
        return run_until_coverage(st, cfg, args.target, seg, plan=plan, tail=args.tail), None

    def fold(st):
        st, over = rematerialize_rewired(st, cfg, cap)
        overflow.append(over)
        return st

    state, parts, remats, wall = _remat_loop(args, state, run_segment, fold)
    extra = {"remat_every": args.remat_every, "remats": remats,
             "remat_overflow_edges": sum(int(o) for o in overflow)}
    return _remat_summary(args, state, parts, wall, extra, wall)


def _run_shard_with_remat(args: argparse.Namespace, cfg, state, mesh, sg, plans) -> dict:
    """--shard --remat-every R: R rounds on the mesh, then fold the fresh
    edges into the CSR, re-partition the live swarm (seed ``--seed`` plus
    the fold's ordinal), re-shard it and rebuild K6's plans with
    --staircase. The rebuilds' seconds are reported apart."""
    import time

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.sim.engine import remat_capacity, rematerialize_rewired

    epoch = {"sg": sg, "plans": plans, "overflow": 0, "rebuild_s": 0.0, "folds": 0}

    def run_segment(st, seg):
        if args.rounds > 0:
            return dist.simulate_dist(st, cfg, epoch["sg"], mesh, seg, epoch["plans"])
        return dist.run_until_coverage_dist(st, cfg, epoch["sg"], mesh, args.target, seg,
                                            shard_plan=epoch["plans"]), None

    def fold(st):
        t0 = time.perf_counter()
        st, over = rematerialize_rewired(st, cfg, remat_capacity(st, cfg))
        epoch["folds"] += 1
        epoch["sg"], st, _ = dist.repartition_swarm(st, mesh.size, seed=args.seed + epoch["folds"])
        st = dist.shard_swarm(st, mesh)
        if epoch["plans"] is not None:
            epoch["plans"] = dist.build_shard_plans(epoch["sg"])
        epoch["overflow"] += int(over)
        epoch["rebuild_s"] += time.perf_counter() - t0
        return st

    state, parts, remats, wall = _remat_loop(args, state, run_segment, fold)
    out = {"devices": mesh.size, "remat_every": args.remat_every, "remats": remats,
           "remat_overflow_edges": epoch["overflow"],
           "epoch_rebuild_seconds_total": round(epoch["rebuild_s"], 3)}
    summary = _remat_summary(args, state, parts, wall, out, wall - epoch["rebuild_s"])
    if args.rounds == 0:
        summary["ms_per_round_amortized"] = wall / max(int(state.round), 1) * 1000.0
    summary["transport"] = "dense"
    return summary


def _run_body(args: argparse.Namespace, cfg, state, horizon, to_target, extra: dict) -> dict:
    """The fixed horizon or the run to ``--target``; returns the summary."""
    from tpu_gossip_torch.core.packed import pack_state, unpack_state
    from tpu_gossip_torch.sim import metrics as M
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    if args.rounds > 0:
        fin, stats = horizon(pack_state(state) if args.packed else state)
        if args.packed:
            fin = unpack_state(fin)
        if not args.quiet:
            M.write_jsonl(stats, sys.stdout)
        summary = _horizon_summary(args, stats, **extra)
        if args.digest:
            summary.update(state_digest=state_digest(fin), stats_digest=stats_digest(stats))
    else:
        def cov_run(st):
            out = to_target(pack_state(st) if args.packed else st)
            return unpack_state(out) if args.packed else out

        # a sharded run reports the real peer count, not the padded slot count
        result, _ = M.bench_swarm(state, cfg, args.target, args.max_rounds, run=cov_run,
                                  n_peers=args.peers if args.shard else None)
        summary = {"summary": True, "mode": args.mode, **extra, **json.loads(result.to_json())}
    return summary


def _profile_round(args: argparse.Namespace, cfg, state, plan) -> dict:
    """--profile-round R: advance R rounds (mid-epidemic slot densities),
    then slope-time each stage and the composed round per tail; the table
    goes to stderr, the summary (ms a round, NaN as null) is returned. The
    ``transport_compact`` stage measures the sparse lane's compaction at
    this swarm's synthetic 8-shard bucket geometry: capacity the directed
    edges per (src, dst) pair rounded up to whole 1024-entry windows, budget
    1/8 of it."""
    from tpu_gossip_torch.core.state import clone_state
    from tpu_gossip_torch.kernels.pallas_segment import _slot_groups
    from tpu_gossip_torch.sim.engine import simulate
    from tpu_gossip_torch.utils.profiling import format_stage_table, profile_round_stages, stages_ms, trace

    warm, _ = simulate(clone_state(state), cfg, args.profile_round, plan)
    tails = ("reference", "fused") if args.tail != "pallas" else ("reference", "fused", "pallas")
    s_probe = 8
    e_real = int(state.row_ptr[-1])
    b_probe = max(1024, -(-e_real // (s_probe * s_probe * 1024)) * 1024)
    probe = (s_probe, b_probe, len(_slot_groups(args.slots)), max(b_probe // 8, 1))
    with trace(args.profile):
        stages = profile_round_stages(warm, cfg, plan, tails=tails, transport_probe=probe,
                                      device=state.seen.device)
    print(format_stage_table(stages), file=sys.stderr)
    return {"summary": True, "profile_round": True, "mode": args.mode, "n_peers": args.peers,
            "warm_rounds": args.profile_round, "stages_ms": stages_ms(stages)}


def _shard_runners(args: argparse.Namespace, graph, origins, cfg_kw: dict, dev):
    """--shard: partition the graph over the mesh (pads born dead), with
    --staircase build K6's plans, seed ``origins`` through the partition's
    relabelling; returns ``(cfg, state, horizon, to_target, extra summary
    keys, (mesh, sharded graph, plans))``."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig

    mesh = dist.make_mesh(device=dev)
    sg, relabeled, position = dist.partition_graph(graph, mesh.size, seed=args.seed, device=dev)
    cfg = SwarmConfig(n_peers=sg.n_pad, **cfg_kw)
    plans = dist.build_shard_plans(sg) if args.staircase else None
    state = dist.shard_swarm(dist.init_sharded_swarm(sg, relabeled, position, cfg, key=prng.key(args.seed, dev),
                                                     origins=origins, device=dev), mesh)

    def horizon(st):
        return dist.simulate_dist(st, cfg, sg, mesh, args.rounds, plans)

    def to_target(st):
        return dist.run_until_coverage_dist(st, cfg, sg, mesh, args.target, args.max_rounds, shard_plan=plans)

    return cfg, state, horizon, to_target, {"devices": mesh.size, "transport": "dense"}, (mesh, sg, plans)


if __name__ == "__main__":
    raise SystemExit(main())
