"""Run a whole gossip swarm on the card.

    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph chung-lu --staircase
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --packed

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
unpacked before the digest, as the JAX CLI does. The summary keys are the
JAX CLI's. Runs on ``--device cuda`` unless told otherwise; every other
flag of the JAX CLI is not ported yet and exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_LATER = (
    "this flag is not ported yet; the port runs the local engine over the "
    "matching, preferential-attachment and Chung-Lu graphs, packed or not "
    "(later slices add faults, churn, growth, streams, control, checkpoints, "
    "fleets and the sharded engines)"
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
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
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
    p.add_argument("--digest", action="store_true",
                   help="add state_digest/stats_digest to a fixed-horizon summary")
    p.add_argument("--quiet", action="store_true", help="summary line only, no per-round JSONL")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"{' '.join(unknown)}: {_LATER}", file=sys.stderr)
        return 2
    from tpu_gossip_torch.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(json.dumps(run(args)))
    return 0


def run(args: argparse.Namespace) -> dict:
    """The run body: parsed ``args`` in, the summary dict out (per-round
    JSONL goes to stdout first unless ``--quiet``)."""
    from tpu_gossip_torch.core import prng, topology
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.core.packed import pack_state, unpack_state
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan
    from tpu_gossip_torch.sim import metrics as M
    from tpu_gossip_torch.sim.engine import run_until_coverage, simulate
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    exists = plan = None
    if args.graph == "matching":
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
        if args.staircase:
            plan = build_staircase_plan(graph.row_ptr, graph.col_idx,
                                        fanout=None if args.mode == "flood" else args.fanout, device=dev)
    cfg = SwarmConfig(
        n_peers=graph.n, msg_slots=args.slots, fanout=args.fanout, mode=args.mode,
        forward_once=args.forward_once, sir_recover_rounds=args.sir_recover,
    )
    origins = rng.choice(args.peers, size=min(args.origins, args.peers), replace=False)
    state = init_swarm(graph, cfg, key=prng.key(args.seed, dev), origins=origins,
                       exists=exists, device=dev)
    if args.rounds > 0:
        fin, stats = simulate(pack_state(state) if args.packed else state, cfg, args.rounds, plan, args.tail)
        if args.packed:
            fin = unpack_state(fin)
        if not args.quiet:
            M.write_jsonl(stats, sys.stdout)
        summary = {
            "summary": True,
            "n_peers": args.peers,
            "mode": args.mode,
            "rounds_run": args.rounds,
            "rounds_to_target": M.rounds_to_coverage(stats, args.target),
            "final_coverage": float(stats.coverage[-1]),
            "total_msgs": int(stats.msgs_sent.sum()),
        }
        if args.digest:
            summary.update(state_digest=state_digest(fin), stats_digest=stats_digest(stats))
    elif args.packed:
        def cov_run(st):
            out = run_until_coverage(pack_state(st), cfg, args.target, args.max_rounds, plan=plan,
                                     tail=args.tail)
            return unpack_state(out)

        result, fin = M.bench_swarm(state, cfg, args.target, args.max_rounds, run=cov_run)
        summary = {"summary": True, "mode": args.mode, **json.loads(result.to_json())}
    else:
        result, fin = M.bench_swarm(state, cfg, args.target, args.max_rounds, plan=plan,
                                    tail=args.tail)
        summary = {"summary": True, "mode": args.mode, **json.loads(result.to_json())}
    summary["packed"] = args.packed
    return summary


if __name__ == "__main__":
    raise SystemExit(main())
