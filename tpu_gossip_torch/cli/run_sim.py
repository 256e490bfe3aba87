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
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --rounds 16 --checkpoint-every 4 \\
        --checkpoint-dir D --keep 2
    python -m tpu_gossip_torch.cli.run_sim resume D
    python -m tpu_gossip_torch.cli.run_sim --peers 1000 --graph pa --m 3 \
        --slots 8 --fanout 3 --mode push --silent-frac 0.1 --rounds 20 --digest
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \
        --fanout 1 --graph matching --scenario scenarios/split_brain.toml \
        --rounds 32 --digest
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --scenario scenarios/byzantine_siege.toml \\
        --quorum-k 3 --rounds 56 --digest
    python -m tpu_gossip_torch.cli.run_sim --peers 950000 --grow 1000000 \\
        --grow-rate 256 --mode push_pull --fanout 1 --graph matching \\
        --rounds 32 --digest
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph matching --stream 4 --stream-burst-every 6 \\
        --slot-ttl 24 --rounds 48 --digest
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 3 --graph matching --control 0.99 --control-bounds 1,6 \\
        --rounds 48 --digest
    python -m tpu_gossip_torch.cli.run_sim --peers 1000000 --mode push_pull \\
        --fanout 1 --graph chung-lu --shard --staircase --pipeline 1 --rounds 48
    python -m tpu_gossip_torch.cli.run_sim fleet \\
        scenarios/campaigns/catalogue_smoke.toml --report report.json

Ports the local path of ``tpu_gossip/cli/run_sim.py``: build the graph
(``--graph matching`` on the device; ``pa`` by the C++ preferential
attachment with ``--m`` edges per node, or ``chung-lu``, the configuration
model, both on the host from ``np.random.default_rng(seed)``), with
``--staircase`` a host-built staircase plan for the CSR families, then
seed the origins drawn from the same ``rng`` after the graph, and with
``--silent-frac`` the silent peers drawn after them, exactly as the JAX
CLI draws them. ``--scenario F`` runs the fault schedule in the TOML file
``F`` (``faults/``: loss, delay, partitions, blackouts, churn bursts) on
every engine, validated before anything is built with the JAX CLI's
words, and adds ``scenario`` (and on a fixed horizon its per-phase
``phases`` report) to the summary. ``--quorum-k K`` (with
``--suspicion-window`` and ``--accusation-budget``) hardens the failure
detector into the quorum suspicion machine on every engine, lets a
scenario field Byzantine accusers, forgers and flooders, and adds the
``liveness`` block to the summary. ``--grow TARGET`` (with ``--grow-rate``
and ``--grow-capacity``) grows the swarm to TARGET peers while it gossips
(``growth/``: per-round join batches admitted by preferential attachment,
``join_burst`` scenario phases adding waves) on every engine; the matching
graph is then built in the sharded layout at one shard with the capacity
as reserved rows, a CSR graph padded to the capacity, and the summary
adds the final membership and the degree tail's gamma. ``--stream RATE``
(with ``--stream-origins``, ``--slot-ttl``, ``--stream-hashes``, the burst
and hotspot knobs) injects a sustained Poisson message stream on every
engine (``traffic/``), its leases aging out through the round tail, and
adds the ``stream`` block (the steady-state serving report) to the summary
of the fixed horizon it needs. ``--control TARGET`` (with
``--control-bounds LO,HI`` and ``--refresh-every K``) closes the fanout
feedback loop on every engine (``control/``: the AIMD fanout and
push/push-pull mix, the PeerSwap refresh on the re-wiring plane) and adds
the ``control`` block, and on a fixed horizon the ``reliability`` block,
to the summary. Then either run a fixed ``--rounds`` horizon (one
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
trace of the run. ``--checkpoint-every K --checkpoint-dir D`` writes a
durable checkpoint every K rounds of a fixed horizon (``ckpt/``: sharded
atomic files, the manifest written last) on every engine, the remat loops
included, and ``run_sim resume D`` finishes the run from the newest
complete checkpoint, rolling back past torn ones, on the same final state
and integer stats as the uninterrupted run, whichever package wrote the
checkpoint; ``--checkpoint F`` saves the final state as one npz
(``save_swarm``). ``--shard --pipeline 1`` pipelines the rounds
(``sim/stages.py::PipelineSpec``: each delivers the exchange the round
before issued), and ``--profile-round`` composes with ``--grow``,
``--stream`` and ``--control``. ``run_sim fleet campaign.toml`` runs a
fleet campaign (``fleet/``) and prints its certification summary, with
``--lane K --solo`` one lane alone, and checkpoints a file a lane that
``run_sim resume D [--lane K --solo]`` finishes. Runs on ``--device
cuda`` unless told otherwise; every other flag of the JAX CLI is not
ported yet and exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

_LATER = (
    "this flag is not ported yet; the port runs the local engine over the "
    "matching, preferential-attachment and Chung-Lu graphs, packed or not, "
    "and the bucketed sharded engine over the CSR graphs, churn and re-wiring "
    "included, and the sharded matching engine with the dense, sparse and auto transports, with "
    "checkpoints and resume, silent peers, fault scenarios, the quorum detector with its adversaries, "
    "growth, streams, adaptive control, pipelined rounds, fleet campaigns and serving, the (hosts, devices) fold "
    "with the hier transport, and over several processes (--coordinator) static rounds, churn, faults, silent "
    "peers, the quorum detector, growth, streams, adaptive control, pipelined rounds and the distributed builder, "
    "each process building only its shards; a later slice adds the analysis tier (ROADMAP item 14))"
)
# the JAX CLI's flags the port has not ported: the JAX parser's default of
# each (the only value a JAX checkpoint's run section may hold for it here)
# and the slice that brings it
JAX_FLAG_DEFAULTS: dict = {}
# layout facts a manifest records beside the args, and the JAX validators' extras
_KNOWN_EXTRA = {"devices", "control_lo", "control_hi"}
# port flags no manifest records: the JAX CLI has no --device or
# --dist-backend, and a trace directory is this process's
_UNRECORDED = ("device", "profile", "dist_backend")
# where this process sits among the ranks: a manifest records their
# defaults, as the checkpoint holds the whole swarm whoever wrote it
_PLACEMENT = {"coordinator": "", "num_processes": 0, "process_id": -1}


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
    p.add_argument("--silent-frac", type=float, default=0.0, help="fraction of peers made silent (fault injection)")
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
                   help="run the sharded engine over a mesh of one shard per card: the bucketed engine "
                   "(dist/mesh.py) over a CSR graph, with --staircase each shard's receive through K6; the "
                   "sharded matching engine (dist/matching_mesh.py) with --graph matching")
    p.add_argument("--transport", choices=["dense", "sparse", "auto", "hier"], default="dense",
                   help="sharded-exchange transport (dist/transport.py): dense ships the rectangular exchange; "
                   "sparse gates each exchange on an occupancy header and ships the occupied entries (bucketed) "
                   "or leaf rows (matching, hubs on a dense sub-lane) compacted; auto is sparse only where the "
                   "static geometry predicts a byte win; hier is the two-level ICI/DCN transport (cluster/hier.py): "
                   "dense inside each host row, compacted across the host axis, and needs --hosts H > 1. "
                   "Bit-identical to dense in every mode. Requires --shard; the summary gains the realized occupancy "
                   "and bytes (per axis under --hosts)")
    p.add_argument("--hosts", type=int, default=1, metavar="H",
                   help="fold the mesh into a 2-D (hosts, devices) cluster mesh (cluster/topology.py): the same "
                   "shards in the same row-major order, so the trajectory is bit-identical to the flat mesh. H must "
                   "divide the mesh size. Requires --shard; enables --transport hier and splits the summary's wire "
                   "accounting into per-axis ici/dcn bytes. 1 = flat mesh (the default)")
    p.add_argument("--coordinator", type=str, default="", metavar="ADDR",
                   help="run as one rank of a torch.distributed process group (cluster/launch.py): ADDR is the "
                   "rendezvous host:port; needs --num-processes and --process-id, and --hosts must equal "
                   "--num-processes (one rank per host row, holding only its rows). Localhost launches go through "
                   "`python -m tpu_gossip_torch.cluster.launch`")
    p.add_argument("--num-processes", type=int, default=0, metavar="P",
                   help="ranks of the process group (with --coordinator)")
    p.add_argument("--process-id", type=int, default=-1, metavar="I",
                   help="this process's rank in [0, --num-processes) (with --coordinator)")
    p.add_argument("--dist-backend", choices=["gloo", "nccl"], default="gloo",
                   help="the process group's backend under --coordinator: nccl with a card a rank, gloo across CPU "
                   "processes or ranks sharing a card (the launcher's --backend)")
    p.add_argument("--builder", choices=["local", "dist"], default="local",
                   help="the sharded matching layout's builder: local (matching_powerlaw_graph_sharded) or dist "
                   "(dist/builder.py: each shard derives its own blocks, bit-identical to the block-keyed local "
                   "build). dist needs --shard --graph matching")
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
    p.add_argument("--checkpoint", type=str, default="", help="save the final SwarmState to this .npz")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="durable periodic checkpoints (ckpt/): every K rounds of a fixed --rounds horizon, a "
                   "sharded atomic checkpoint (temp file and rename a file, the manifest with sha256 digests "
                   "written last) into --checkpoint-dir; `run_sim resume D` finishes the run from the newest "
                   "complete one on the same final state and integer stats. With --shard --remat-every R, K "
                   "must be a multiple of R")
    p.add_argument("--checkpoint-dir", type=str, default="", metavar="D",
                   help="directory the periodic checkpoints land in (one ckpt-<round> subdirectory each)")
    p.add_argument("--keep", type=int, default=0, metavar="N",
                   help="prune all but the newest N checkpoints after each save (0 = keep all)")
    p.add_argument("--checkpoint-shards", type=int, default=0, metavar="S",
                   help="file-level shard count a checkpoint (a storage choice: any S loads into the same "
                   "state). Default: the mesh size under --shard, else 1")
    p.add_argument("--scenario", type=str, default="", metavar="TOML",
                   help="fault scenario schedule (tpu_gossip_torch/faults/): time-phased message loss, delivery "
                   "delay, split-brain partitions, node/shard blackouts, churn bursts, injected from a PRNG "
                   "stream of their own on every engine (local and sharded rounds stay bit-identical). The "
                   "schedule is validated before the run: phases beyond --rounds/--max-rounds or overlapping "
                   "phases are config errors")
    p.add_argument(
        "--quorum-k", type=int, default=None, metavar="K",
        help="harden the failure detector into the witness-quorum "
        "suspicion machine (kernels/liveness.py, docs/"
        "adversarial_model.md): a stale peer is only SUSPECTED, and "
        "declared dead after K distinct witness confirmations inside the "
        "suspicion window. K=1 degrades to the reference's single-report "
        "purge (bit-identical to the unhardened detector with no "
        "adversaries); K>1 defends against Byzantine accusers — a "
        "scenario with accusers/forgers/floods phases REQUIRES this "
        "flag. The summary JSON gains a `liveness` block (evictions, "
        "false evictions, precision, quarantined count)",
    )
    p.add_argument(
        "--suspicion-window", type=int, default=None, metavar="W",
        help="rounds a suspicion may accumulate witness votes before it "
        "expires without quorum (default: 2x the detector sweep period). "
        "Must be at least the sweep period — the PING grace — or a "
        "suspicion would expire before its probe could refute. Needs "
        "--quorum-k",
    )
    p.add_argument(
        "--accusation-budget", type=int, default=None, metavar="B",
        help="false accusations (victim refutes inside the window) a "
        "peer may emit before the quarantine verdict latches: its sends "
        "are masked, its accusations ignored, its rewire slots released "
        "through the degree-credit book (default 3; 0 disables "
        "quarantine). Needs --quorum-k",
    )
    p.add_argument(
        "--grow", type=int, default=0, metavar="TARGET_N",
        help="grow the swarm to TARGET_N peers while gossiping (growth/): per-round join batches are admitted "
        "INSIDE the round, each joiner attaching --m fresh edges by preferential attachment over the current "
        "realized degree vector (Gumbel-top-k from a dedicated PRNG stream, so local and sharded runs stay "
        "bit-identical). Composes with --scenario join_burst phases (admission waves) and every delivery "
        "engine; node-scoped scenario sets stay declared over the INITIAL --peers ids",
    )
    p.add_argument("--grow-rate", type=int, default=0, metavar="J",
                   help="joins admitted per round (default: sized so TARGET_N is reached in about half of "
                   "--rounds/--max-rounds)")
    p.add_argument("--grow-capacity", type=int, default=0, metavar="CAP",
                   help="state capacity in peer slots (>= TARGET_N; default TARGET_N). Slots beyond the target "
                   "stay reserved: headroom for resuming the checkpoint into a later, larger growth schedule "
                   "without a state rebuild")
    p.add_argument("--stream", type=float, default=0.0, metavar="RATE",
                   help="streaming serving plane (traffic/): inject a sustained message stream at RATE Poisson "
                   "arrivals per round, each message leasing dedup slot(s) that age out after --slot-ttl rounds, "
                   "so the (N, M) bitmap becomes a sliding window over live messages. Draws come from a dedicated "
                   "PRNG stream on every engine (local and sharded loaded runs stay bit-identical; rate 0 = off). "
                   "Needs a fixed --rounds horizon; the summary gains the steady-state serving block")
    p.add_argument("--stream-origins", choices=["uniform", "degree", "hotspot"], default="uniform", metavar="DIST",
                   help="origin law for injected messages: uniform over the initial membership, degree "
                   "(degree-proportional), or hotspot (--stream-hot-frac of the lowest peer ids originate "
                   "--stream-hot-weight of the traffic)")
    p.add_argument("--slot-ttl", type=int, default=0, metavar="R",
                   help="rounds a message holds its dedup slot(s) before the age-out recycles them (default: 3x "
                   "the feasible coverage horizon); a TTL below the feasible horizon is rejected")
    p.add_argument("--stream-hashes", type=int, default=1, metavar="K",
                   help="Bloom planes per message: 1 = slot conflation, >=2 = k-hash Bloom dedup (arrivals whose "
                   "planes are all leased are suppressed at ingestion)")
    p.add_argument("--stream-burst-every", type=int, default=0, metavar="B",
                   help="bursty arrivals: every B-th round draws at RATE * --stream-burst-mult (0 = pure Poisson)")
    p.add_argument("--stream-burst-mult", type=float, default=4.0, metavar="X")
    p.add_argument("--stream-hot-frac", type=float, default=0.01, metavar="F")
    p.add_argument("--stream-hot-weight", type=float, default=0.9, metavar="W")
    p.add_argument("--control", type=float, default=0.0, metavar="TARGET_RATIO",
                   help="adaptive protocol control (control/): close the fanout feedback loop inside the round, "
                   "defending the declared delivery-ratio target. Each round an AIMD policy widens the effective "
                   "fanout when the observed delivery signals fall below TARGET_RATIO (realized loss, lagging "
                   "stream slots) and shrinks it when the duplicate rate saturates; in push_pull mode the "
                   "anti-entropy half runs only at-or-below the static --fanout. Runs on every engine from a "
                   "dedicated PRNG stream; the summary gains the reliability contract block on fixed-horizon runs")
    p.add_argument("--control-bounds", type=str, default="", metavar="LO,HI",
                   help="the policy's fanout bounds (default: 1,2*--fanout, clamped to --rewire-slots when churn "
                   "re-wiring is active). --fanout must lie inside; LO,HI = --fanout,--fanout is the "
                   "zero-adjustment controller, bit-identical to the static run")
    p.add_argument("--refresh-every", type=int, default=0, metavar="K",
                   help="PeerSwap neighbour refresh: every K rounds each live re-wired peer swaps one fresh-edge "
                   "slot for a new degree-preferential draw (degree-credit bookkeeping preserved). Needs "
                   "--control and the re-wiring plane (--rewire-slots/--grow); 0 = off")
    p.add_argument("--pipeline", type=int, choices=[0, 1], default=None, metavar="DEPTH",
                   help="pipelined sharded rounds (sim/stages.py): 1 double-buffers the exchange, each round "
                   "delivering the exchange the round before issued (delivery one round stale); 0 is the serial "
                   "schedule, bit-identical to omitting the flag. Requires --shard")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "resume":
        return _main_resume(argv[1:])
    if argv and argv[0] == "fleet":
        return _main_fleet(argv[1:])
    if argv and argv[0] == "serve":
        return _main_serve(argv[1:])
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"{' '.join(unknown)}: {_LATER}", file=sys.stderr)
        return 2
    return _run(args)


def validate(args: argparse.Namespace) -> str | None:
    """Every check of a parsed run config, in the JAX CLI's order (the
    scenario, growth, the stream, the controller, the quorum detector,
    then the rest): the first reason it cannot run (exit 2), or None.
    Settles the defaults the validators fill in (``grow_rate``,
    ``grow_capacity``, ``slot_ttl``, the control bounds, the detector's
    window and budget) into ``args``."""
    spec = None
    err = _validate_cluster(args)
    if err:
        return err
    err = _scenario_refusal(args)
    if err is None and args.scenario:
        spec = _scenario_spec(args)
    return (err or _validate_grow(args, spec) or _validate_stream(args) or _validate_control(args)
            or _validate_liveness(args, spec) or _refusal(args))


def _validate_cluster(args: argparse.Namespace) -> str | None:
    """Impossible --hosts/--coordinator configs, in the JAX CLI's words
    (its refusals of a run to coverage and of checkpoints under
    --coordinator are lifted: the port reduces the coverage over the ranks
    and writes the whole swarm from rank 0); every plane runs under
    --coordinator. The exit-2 reason or None."""
    if args.hosts < 1:
        return f"--hosts {args.hosts} must be >= 1"
    if args.hosts > 1 and not args.shard:
        return ("--hosts folds the SHARDED device mesh into a 2-D (hosts, devices) cluster mesh; add --shard (the "
                "local engine has no mesh to fold)")
    if args.hosts > 1 and args.remat_every > 0:
        return ("--hosts cannot compose with --remat-every: the epoch re-partition rebuilds bucket tables for the "
                "flat shard order only — run the remat loop on the flat mesh")
    if args.transport == "hier" and args.hosts <= 1:
        return ("--transport hier is the two-level ICI/DCN transport (dense inside each host slice, compacted across "
                "the host axis); it needs a (hosts, devices) mesh — add --hosts H > 1")
    if args.coordinator:
        if args.num_processes < 2 or not (0 <= args.process_id < args.num_processes):
            return ("--coordinator needs --num-processes P >= 2 and --process-id in [0, P) — one rank per process "
                    "(cluster/launch.py spawns them)")
        if args.hosts != args.num_processes:
            return (f"--hosts {args.hosts} must equal --num-processes {args.num_processes}: the mesh's host axis is "
                    "one row per process")
        if args.profile:
            return "--profile records a single process's trace; drop it"
        return None
    if args.num_processes or args.process_id >= 0:
        return "--num-processes/--process-id need --coordinator"
    return None


def _refusal(args: argparse.Namespace) -> str | None:
    """The reason a flag combination cannot run (exit 2), or None."""
    ckpt_err = _validate_ckpt(args)
    if ckpt_err:
        return ckpt_err
    if args.packed and args.remat_every > 0:
        return ("--packed cannot compose with --remat-every: the epoch fold (rematerialize_rewired / "
                "re-partition) rebuilds the unpacked CSR between segments; run the remat loop unpacked")
    if args.builder == "dist" and not (args.shard and args.graph == "matching"):
        return ("--builder dist builds the matching layout born on the mesh (dist/builder.py); it needs --shard "
                "--graph matching")
    if args.builder == "dist" and args.remat_every > 0:
        return ("--builder dist cannot compose with --remat-every: the remat path falls back to the bucketed-CSR "
                "engine, which rebuilds from a host partition")
    if args.pipeline is not None and not args.shard:
        return ("--pipeline overlaps the SHARDED exchange with the shard-local tail (sim/stages.py); add --shard "
                "(the local engine has no collective to overlap)")
    if args.transport != "dense" and not args.shard:
        return (f"--transport {args.transport} compacts the sharded exchanges (dist/transport.py); add --shard "
                "(the local engine moves no ICI bytes)")
    if args.graph == "matching" and args.remat_every > 0 and not args.shard:
        return ("--graph matching cannot re-materialize locally (its pairing IS the delivery plan: a folded CSR "
                "has no pipeline); use --shard, whose remat path falls back to the bucketed-CSR engine on the "
                "exported CSR")
    if args.shard and args.tail != "fused":
        return (f"--tail {args.tail} selects the LOCAL engine's tail implementation; the sharded engines "
                "always run the fused tail")
    if args.profile_round > 0 and args.shard:
        return ("--profile-round decomposes the LOCAL round (use tpu_gossip_torch/experiments/dist_profile.py "
                "for the sharded engine)")
    if args.profile_round > 0 and args.packed:
        return ("--profile-round decomposes the UNPACKED round's stages; the packed carry adds only the "
                "boundary codec: drop --packed for the decomposition")
    return None


def _validate_control(args: argparse.Namespace) -> str | None:
    """The reason a --control config cannot run (exit 2, the JAX CLI's
    words), or None. Settles the bounds (``control_lo``, ``control_hi``)
    into ``args``, so every engine path and the checkpoint manifest read
    one config."""
    if args.control == 0:
        set_flags = [name for name, dflt in (("--control-bounds", args.control_bounds == ""),
                                             ("--refresh-every", args.refresh_every == 0)) if not dflt]
        if set_flags:
            return f"{set_flags[0]} shapes the adaptive-control policy; add --control TARGET_RATIO"
        return None
    if not (0.0 < args.control <= 1.0):
        return f"--control {args.control} must be a delivery-ratio target in (0, 1]"
    if args.mode == "flood":
        return ("--control modulates the sampled fanout and the anti-entropy mix; flood delivery has neither — "
                "use --mode push or push_pull")
    rewire = _rewire_slots(args)
    if args.control_bounds:
        try:
            lo_s, hi_s = args.control_bounds.split(",")
            lo, hi = int(lo_s), int(hi_s)
        except ValueError:
            return f"--control-bounds {args.control_bounds!r} must be LO,HI (two integers)"
        if lo < 1:
            return f"--control-bounds lower bound {lo} must be >= 1"
        if hi < lo:
            return f"--control-bounds {lo},{hi} has LO > HI"
        if not (lo <= args.fanout <= hi):
            return (f"--control-bounds [{lo}, {hi}] must contain --fanout {args.fanout} — the policy must be able "
                    "to express the static rate")
        if rewire > 0 and hi > rewire:
            return (f"--control-bounds upper bound {hi} exceeds the re-wiring width --rewire-slots {rewire}: a "
                    "widened rejoiner would redraw its few fresh edges past their useful multiplicity; raise "
                    "--rewire-slots or lower HI")
    else:
        lo, hi = 1, max(2 * args.fanout, args.fanout)
        if rewire > 0:
            hi = max(args.fanout, min(hi, rewire))
        if rewire > 0 and hi > rewire:
            return (f"the default control bounds need HI >= --fanout {args.fanout}, but --rewire-slots is "
                    f"{rewire}; raise --rewire-slots or pass --control-bounds")
    args.control_lo, args.control_hi = lo, hi
    if args.refresh_every < 0:
        return "--refresh-every must be >= 0"
    if args.refresh_every > 0 and rewire == 0:
        return ("--refresh-every rides the re-wiring plane (rewire_targets) — only re-wired peers carry "
                "swappable fresh edges; add --rewire-slots (with churn) or --grow")
    return None


def _compile_cli_control(args: argparse.Namespace, dev):
    """The --control policy on ``dev`` (None without --control): layout-
    blind, so one spec serves every engine path and survives an epoch
    re-partition; its TTL is the stream's slot TTL under --stream."""
    if args.control <= 0:
        return None
    from tpu_gossip_torch.control import compile_control

    return compile_control(target_ratio=args.control, fanout=args.fanout, lo=args.control_lo, hi=args.control_hi,
                           refresh_every=args.refresh_every, ttl=args.slot_ttl if args.stream > 0 else 0,
                           device=dev)


def _control_summary(args: argparse.Namespace, cfg=None, stats=None) -> dict:
    """The summary's ``control`` block (the policy's config) and, when
    per-round stats exist, the ``reliability`` block
    (``sim.metrics.reliability_report``)."""
    if args.control <= 0:
        return {}
    out = {"control": {"target_ratio": args.control, "bounds": [args.control_lo, args.control_hi],
                       "refresh_every": args.refresh_every}}
    if stats is not None:
        from tpu_gossip_torch.sim import metrics as M

        out["reliability"] = M.reliability_report(stats, target_ratio=args.control, coverage_target=args.target,
                                                  round_seconds=cfg.round_seconds if cfg is not None else 5.0)
    return out


def _validate_stream(args: argparse.Namespace) -> str | None:
    """The reason a --stream config cannot run (exit 2, the JAX CLI's
    words), or None. Settles the TTL default (three times the feasible
    coverage horizon) into ``args``, so every engine path and the
    checkpoint manifest read one config."""
    if args.stream == 0:
        set_flags = [name for name, dflt in (("--slot-ttl", args.slot_ttl == 0),
                                             ("--stream-origins", args.stream_origins == "uniform"),
                                             ("--stream-hashes", args.stream_hashes == 1),
                                             ("--stream-burst-every", args.stream_burst_every == 0)) if not dflt]
        if set_flags:
            return f"{set_flags[0]} shapes the streaming workload; add --stream RATE"
        return None
    from tpu_gossip_torch.traffic import min_feasible_ttl

    if args.stream < 0:
        return f"--stream {args.stream} must be a non-negative arrival rate"
    if args.rounds <= 0 and args.profile_round == 0:
        return ("--stream measures a steady state over a fixed horizon — run-to-coverage stops on slot 0, which "
                "the age-out recycles; pass --rounds R (R >> --slot-ttl)")
    if args.shard and args.remat_every > 0:
        return ("--stream cannot compose with --shard --remat-every: the epoch re-partition permutes peers, so the "
                "compiled origin tables would inject at the wrong rows after the first rebuild (local "
                "--remat-every composes fine)")
    if not (1 <= args.stream_hashes <= args.slots):
        return (f"--stream-hashes {args.stream_hashes} outside [1, --slots {args.slots}] — the Bloom planes live "
                "in the slot dimension")
    if args.stream_burst_every < 0 or args.stream_burst_mult <= 0:
        return "--stream-burst-every must be >= 0 and --stream-burst-mult > 0"
    if not (0 < args.stream_hot_frac <= 1) or not (0 <= args.stream_hot_weight <= 1):
        return "--stream-hot-frac must lie in (0, 1] and --stream-hot-weight in [0, 1]"
    feasible = min_feasible_ttl(args.peers, args.fanout, args.mode)
    if args.slot_ttl == 0:
        args.slot_ttl = 3 * feasible
    if args.slot_ttl < feasible:
        return (f"--slot-ttl {args.slot_ttl} is below the feasible coverage horizon (~{feasible} rounds for "
                f"{args.peers} peers at fanout {args.fanout}): every message would be recycled before it could "
                "possibly cover — raise the TTL or the fanout")
    return None


def _compile_cli_stream(args: argparse.Namespace, origin_rows, dev):
    """The --stream workload for one engine's row layout on ``dev`` (None
    without --stream); ``origin_rows`` is the id-ordered table of the
    initial members' state rows."""
    if args.stream <= 0:
        return None
    from tpu_gossip_torch.traffic import compile_stream

    return compile_stream(rate=args.stream, msg_slots=args.slots, ttl=args.slot_ttl,
                          origin_rows=np.asarray(origin_rows), origins=args.stream_origins,
                          k_hashes=args.stream_hashes, hot_frac=args.stream_hot_frac,
                          hot_weight=args.stream_hot_weight, burst_every=args.stream_burst_every,
                          burst_mult=args.stream_burst_mult, device=dev)


def _stream_summary(args: argparse.Namespace, cfg, stats=None) -> dict:
    """The summary's ``stream`` block: the workload's config and, when
    per-round stats exist, ``sim.metrics.steady_state_report`` past one TTL
    of warmup (at most half the horizon)."""
    if args.stream <= 0:
        return {}
    out = {"stream": {"rate": args.stream, "origins": args.stream_origins, "slot_ttl": args.slot_ttl,
                      "k_hashes": args.stream_hashes}}
    if stats is not None:
        from tpu_gossip_torch.sim import metrics as M

        out["stream"].update(M.steady_state_report(stats, target=args.target, round_seconds=cfg.round_seconds,
                                                   warmup_rounds=min(args.slot_ttl, args.rounds // 2)))
    return out


def _scenario_refusal(args: argparse.Namespace) -> str | None:
    """Parse and validate ``--scenario`` before anything is built; the
    reason it cannot run (exit 2, the JAX CLI's words), or None. The phase
    classes of later slices are refused as the JAX CLI refuses them without
    ``--grow`` or ``--quorum-k``."""
    if not args.scenario:
        return None
    from tpu_gossip_torch.faults import ScenarioError, parse_scenario

    try:
        spec = parse_scenario(args.scenario)
        spec.validate(total_rounds=_total_rounds(args), n_peers=args.peers,
                      n_shards=_mesh_size(args) if args.shard else None)
    except (ScenarioError, OSError) as e:
        if args.grow and "outside" in str(e):
            # node sets bind to the INITIAL membership: grown peers have no
            # stable scenario-addressable id
            return (f"--scenario: {e}\nnote: with --grow, node-scoped scenario sets are declared over the "
                    f"INITIAL --peers ids [0, {args.peers}) — grown peers are not scenario-addressable")
        return f"--scenario: {e}"
    except (RuntimeError, NotImplementedError) as e:  # no card, or a mesh of a later slice
        return str(e)
    if args.profile_round > 0:
        return "--profile-round measures the fault-free round's stage decomposition; drop --scenario"
    if args.shard and args.remat_every > 0 and spec.uses_node_sets:
        return ("--scenario with node-scoped faults cannot compose with --shard --remat-every: the epoch "
                "re-partition permutes peers, so compiled node masks would hit the wrong rows after the first "
                "rebuild (scalar loss/delay/full-swarm churn phases are fine)")
    return None


def _validate_grow(args: argparse.Namespace, spec) -> str | None:
    """The reason a --grow config cannot run (exit 2, the JAX CLI's words),
    or None. Settles the rate and capacity defaults into ``args``, so every
    engine path and the checkpoint manifest read one config."""
    if not args.grow:
        if spec is not None and spec.uses_join_burst:
            return "--scenario: join_burst phases are admission waves for a growing run; add --grow"
        return None
    if args.grow <= args.peers:
        return f"--grow {args.grow} must exceed --peers {args.peers} (the target is the grown swarm size)"
    if args.grow_capacity == 0:
        args.grow_capacity = args.grow
    if args.grow_capacity < args.grow:
        return f"--grow-capacity {args.grow_capacity} below the growth target {args.grow}"
    if args.grow_rate < 0:
        return "--grow-rate must be >= 0"
    if args.grow_rate == 0:
        # default pace: the target in about half the horizon, so the grown
        # swarm still gossips at full size for a while
        args.grow_rate = max(1, -(-(args.grow - args.peers) // max(_total_rounds(args) // 2, 1)))
    if args.m >= args.peers:
        return f"--m {args.m} fresh edges per joiner needs at least that many initial peers (--peers {args.peers})"
    if args.shard and args.remat_every > 0:
        return ("--grow cannot compose with --shard --remat-every: the epoch re-partition permutes peers, so the "
                "compiled admission schedule would admit the wrong rows after the first rebuild (local "
                "--remat-every composes fine)")
    return None


def _rewire_slots(args: argparse.Namespace) -> int:
    """Growth edges ride the re-wiring plane: a growing config needs at
    least --m target slots a row."""
    return max(args.rewire_slots, args.m) if args.grow else args.rewire_slots


def _compile_cli_growth(args: argparse.Namespace, spec, n_slots: int, dev, plan=None, node_map=None):
    """The --grow admission schedule for one engine's layout on ``dev``
    (None without --grow): the matching layout's reserved rows in
    round-robin order, else the flat rows after the initial peers, mapped
    through ``node_map`` (the bucketed mesh's ``position``)."""
    if not args.grow:
        return None
    from tpu_gossip_torch.growth import compile_growth, matching_admit_rows

    admit = matching_admit_rows(plan, args.grow - args.peers) if plan is not None else None
    return compile_growth(n_initial=args.peers, target=args.grow, n_slots=n_slots, joins_per_round=args.grow_rate,
                          attach_m=args.m, admit_rows=admit, node_map=node_map,
                          max_join_burst=spec.max_join_burst if spec is not None else 0, device=dev)


def _growth_summary(args: argparse.Namespace, fin) -> dict:
    """Final membership and the degree tail's gamma (the host fit of the
    live realized degrees, 4 decimals; None on a tail too thin), from the
    final state of a growing run."""
    if not args.grow:
        return {}
    from tpu_gossip_torch.core.topology import fit_powerlaw_gamma
    from tpu_gossip_torch.growth.engine import realized_degrees

    deg = realized_degrees(fin.row_ptr, fin.exists, fin.rewired, fin.rewire_targets, fin.degree_credit)
    deg = deg.cpu().numpy()
    live = (fin.alive & ~fin.declared_dead).cpu().numpy()
    try:
        gamma = round(fit_powerlaw_gamma(deg[live]), 4)
    except ValueError:  # tail too thin (tiny swarms)
        gamma = None
    return {"grow_target": args.grow, "grow_rate": args.grow_rate, "grow_capacity": args.grow_capacity,
            "n_members": int(fin.exists.sum()), "degree_gamma": gamma}


def _validate_liveness(args: argparse.Namespace, spec) -> str | None:
    """The reason a --quorum-k config cannot run (exit 2, the JAX CLI's
    words), or None; an adversary scenario without --quorum-k is refused
    here. Settles the window default (twice the detector's sweep) and the
    budget default (3) into ``args``, so every engine path and the
    checkpoint manifest read one config."""
    from tpu_gossip_torch.core.state import SwarmConfig
    from tpu_gossip_torch.kernels.liveness import SUSPECT_STRIKE_CAP, SUSPECT_VOTE_CAP

    sweep = SwarmConfig.__dataclass_fields__["detect_period_rounds"].default
    if args.quorum_k is None:
        set_flags = [name for name, dflt in (("--suspicion-window", args.suspicion_window is None),
                                             ("--accusation-budget", args.accusation_budget is None)) if not dflt]
        if set_flags:
            return f"{set_flags[0]} shapes the quorum failure detector; add --quorum-k K"
        if spec is not None and spec.uses_adversaries:
            return ("--scenario: Byzantine adversary phases (accusers/forgers/floods) need the quorum-defense "
                    "planes; add --quorum-k K (K=1 reproduces the reference's single-report purge — the "
                    "unhardened baseline)")
        return None
    if args.quorum_k < 1:
        return (f"--quorum-k {args.quorum_k} must be >= 1 — at least one witness must confirm a suspicion (K=1 is "
                "the reference's single-report behavior)")
    if args.quorum_k > SUSPECT_VOTE_CAP:
        return f"--quorum-k {args.quorum_k} exceeds the packed vote counter's cap ({SUSPECT_VOTE_CAP})"
    if args.suspicion_window is None:
        args.suspicion_window = 2 * sweep
    if args.suspicion_window < sweep:
        return (f"--suspicion-window {args.suspicion_window} is shorter than the detector sweep period ({sweep} "
                "rounds — the PING grace): a suspicion would expire before its probe could refute it")
    if args.accusation_budget is None:
        args.accusation_budget = 3
    if not 0 <= args.accusation_budget <= SUSPECT_STRIKE_CAP:
        return (f"--accusation-budget {args.accusation_budget} outside [0, {SUSPECT_STRIKE_CAP}] (the packed "
                "strike counter's range; 0 disables quarantine)")
    if args.profile_round > 0:
        return "--profile-round measures the unhardened round's stage decomposition; drop --quorum-k"
    return None


def _compile_cli_liveness(args: argparse.Namespace):
    """The run's ``QuorumSpec`` (one for every engine path), None without
    --quorum-k."""
    if args.quorum_k is None:
        return None
    from tpu_gossip_torch.kernels.liveness import compile_quorum

    return compile_quorum(quorum_k=args.quorum_k, window=args.suspicion_window, budget=args.accusation_budget)


def _liveness_summary(args: argparse.Namespace, stats=None) -> dict:
    """The summary's ``liveness`` block under --quorum-k: the detector's
    config and, when per-round stats exist, ``sim.metrics.liveness_report``."""
    if args.quorum_k is None:
        return {}
    out = {"quorum_k": args.quorum_k, "suspicion_window": args.suspicion_window,
           "accusation_budget": args.accusation_budget}
    if stats is not None:
        from tpu_gossip_torch.sim import metrics as M

        out.update(M.liveness_report(stats))
    return {"liveness": out}


def _total_rounds(args: argparse.Namespace) -> int:
    return args.rounds if args.rounds > 0 else args.max_rounds


def _mesh_size(args: argparse.Namespace) -> int:
    from tpu_gossip_torch import dist

    return dist.make_mesh(device=args.device).size


def _run(args: argparse.Namespace, resume: "_Resume | None" = None) -> int:
    """The run body behind ``main`` and ``resume``: validate, run, print
    the summary, then save ``--checkpoint``; the exit code out."""
    from tpu_gossip_torch.device import resolve_device

    err = validate(args)
    if err:
        print(err, file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.coordinator:
        err = _join_cluster(args)
        if err:
            print(err, file=sys.stderr)
            return 2
    if args.shard and args.hosts > 1 and _mesh_size(args) % args.hosts:
        print(f"--hosts {args.hosts} does not divide the device count {_mesh_size(args)} (the cluster mesh folds "
              "the flat device order row-major into (hosts, devices))", file=sys.stderr)
        return 2
    try:
        summary, fin = _execute(args, resume)
    except NotImplementedError as e:  # a part of a later slice (not_ported)
        print(str(e), file=sys.stderr)
        return 2
    if _rank() == 0:
        print(json.dumps(summary))
        if args.checkpoint and fin is not None:
            from tpu_gossip_torch.core.state import save_swarm

            save_swarm(args.checkpoint, fin)
    return 0


def _rank() -> int:
    from tpu_gossip_torch.cluster.topology import rank

    return rank()


def _join_cluster(args: argparse.Namespace) -> str | None:
    """Join the process group as ``--process-id`` (the rank's first stderr
    line names its backend and device); a rank other than 0 prints no rows
    and no summary. The reason it cannot join (exit 2), or None."""
    from tpu_gossip_torch.cluster.launch import SharedCardError, init_distributed, rank_device

    _stderr_log(f"cluster: rank {args.process_id} of {args.num_processes}, backend {args.dist_backend}, device "
                f"{rank_device(args.device, args.process_id)}, coordinator {args.coordinator}")
    try:
        args.device = init_distributed(args.coordinator, args.num_processes, args.process_id, args.dist_backend,
                                       args.device)
    except SharedCardError as e:
        return f"cluster: rank {args.process_id}: {e}"
    if args.process_id != 0:
        args.quiet = True
    return None


def _cluster_mesh(args: argparse.Namespace, dev):
    """The run's mesh: the flat mesh's shards folded into ``--hosts`` rows
    (one a rank under --coordinator)."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.cluster import make_cluster_mesh

    mesh = make_cluster_mesh(dist.make_mesh(device=dev).size, args.hosts, dev)
    args._mesh = mesh
    return mesh


def _gathered(args: argparse.Namespace, state):
    """The whole swarm from each rank's rows (the state itself in one
    process)."""
    mesh = getattr(args, "_mesh", None)
    if mesh is None or mesh.world == 1 or state is None:
        return state
    from tpu_gossip_torch import dist

    return dist.gather_swarm(state, mesh)


@dataclasses.dataclass
class _Resume:
    """A loaded checkpoint on its way into a rebuilt run: the state (on the
    host until the swap), the stats prefix, the manifest, and the
    recovery's clock (its start, and the seconds of ``latest_complete``
    and ``load_checkpoint``)."""

    state: object
    prefix: dict | None
    manifest: dict
    t0: float
    scan_s: float
    load_s: float


def _main_resume(argv: list[str]) -> int:
    """``run_sim resume D``: crash recovery from the newest complete
    checkpoint under ``D``, rolling back past torn or corrupt ones with a
    logged reason. The run config recorded in the manifest rebuilds the
    graph and plans (deterministic in the seed), the checkpointed state
    replaces the fresh one, and the horizon finishes bit-identically to the
    uninterrupted run, the digests in the summary. A manifest either
    package wrote is read; a recorded flag the port has not ported is
    accepted only at the JAX CLI's default."""
    from tpu_gossip_torch.ckpt import CheckpointError, latest_complete, load_checkpoint
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.sim.stages import not_ported

    p = argparse.ArgumentParser(prog="run_sim resume", description="Resume a checkpointed run bit-exactly")
    p.add_argument("directory", help="the run's --checkpoint-dir")
    p.add_argument("--quiet", action="store_true", help="summary line only (overrides the recorded flag)")
    p.add_argument("--local", action="store_true",
                   help="restore a --shard --graph matching checkpoint into the local engine")
    p.add_argument("--hosts", type=int, default=-1, metavar="H",
                   help="override the recorded --hosts: resume onto another (hosts, devices) fold of the same mesh "
                   "(under --coordinator, one rank a host row), or 1 for the flat mesh")
    p.add_argument("--coordinator", type=str, default="", metavar="ADDR",
                   help="resume as one rank of a process group (the launcher's flags, as run_sim takes them)")
    p.add_argument("--num-processes", type=int, default=0, metavar="P")
    p.add_argument("--process-id", type=int, default=-1, metavar="I")
    p.add_argument("--dist-backend", choices=["gloo", "nccl"], default="gloo")
    p.add_argument("--lane", type=int, default=-1, metavar="K", help="fleet checkpoints: resume lane K")
    p.add_argument("--solo", action="store_true", help="with --lane K: finish lane K unbatched")
    p.add_argument("--device", default="cuda", help="torch device the run finishes on (cuda or cpu)")
    rargs = p.parse_args(argv)
    try:
        resolve_device(rargs.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        path, manifest = latest_complete(rargs.directory, log=_stderr_log)
    except CheckpointError as e:
        print(f"resume: {e}", file=sys.stderr)
        return 2
    scan_s = time.perf_counter() - t0
    run_cfg = manifest.get("run")
    if not run_cfg:
        print("resume: the checkpoint manifest carries no run config (library-written checkpoint?) — resume "
              "rebuilds the run from the manifest's `run` section", file=sys.stderr)
        return 2
    if manifest.get("kind") == "fleet":
        if rargs.coordinator:
            # the JAX CLI's resume parser has no cluster flags: argparse's
            # own refusal, exit 2
            p.error("unrecognized arguments: " + " ".join(_cluster_tokens(argv)))
        if rargs.local:
            print("resume: --local restores a sharded-matching RUN checkpoint; fleet checkpoints resume batched (or "
                  "one lane via --lane K --solo)", file=sys.stderr)
            return 2
        return _resume_fleet(rargs, path, manifest)
    if rargs.lane >= 0 or rargs.solo:
        print("resume: --lane/--solo select a fleet checkpoint's lane; this is a single-run checkpoint",
              file=sys.stderr)
        return 2
    if rargs.hosts >= 1 and not run_cfg.get("shard"):
        print("resume: --hosts re-folds a SHARDED checkpoint's mesh; this run was local", file=sys.stderr)
        return 2
    if rargs.local and not (run_cfg.get("shard") and run_cfg.get("graph") == "matching"
                            and not run_cfg.get("remat_every")):
        print("resume: --local restores a --shard --graph matching checkpoint (no --remat-every) into the local "
              "engine", file=sys.stderr)
        return 2
    base = vars(build_parser().parse_args([]))
    stale = []
    for key, value in run_cfg.items():
        if key in base or key in _KNOWN_EXTRA:
            continue
        if key in JAX_FLAG_DEFAULTS:
            default, item = JAX_FLAG_DEFAULTS[key]
            if value != default:
                flag = "--" + key.replace("_", "-")
                print(str(not_ported(f"{flag} {value!r} (recorded in the checkpoint's run section)", item)),
                      file=sys.stderr)
                return 2
            continue
        stale.append(key)
    args = argparse.Namespace(**{**base, **{k: v for k, v in run_cfg.items() if k in base}})
    args.device = rargs.device
    args._resume_local = rargs.local
    args.coordinator, args.num_processes = rargs.coordinator, rargs.num_processes
    args.process_id, args.dist_backend = rargs.process_id, rargs.dist_backend
    if rargs.hosts >= 1:
        args.hosts = rargs.hosts
        if args.hosts == 1 and args.transport == "hier":
            print("resume: the recorded --transport hier needs a host axis; continuing on the flat mesh with "
                  "--transport sparse (trajectory unchanged — the transport reorders bytes, never draws)",
                  file=sys.stderr)
            args.transport = "sparse"
    if stale:
        print(f"resume: manifest records unknown args {sorted(stale)} (ignored beyond layout checks)",
              file=sys.stderr)
    args.quiet = bool(rargs.quiet or args.quiet)
    print(f"resume: {path.name} at round {manifest['round']} of {args.rounds} ({manifest.get('kind', 'run')})",
          file=sys.stderr)
    try:
        t1 = time.perf_counter()
        state, prefix, _ = load_checkpoint(path, manifest=manifest, device="cpu")
        resume = _Resume(state, prefix, manifest, t0, scan_s, time.perf_counter() - t1)
        del state
        return _run(args, resume=resume)
    except (CheckpointError, ValueError) as e:
        print(f"resume: {e}", file=sys.stderr)
        return 2


def _cluster_tokens(argv: list[str]) -> list[str]:
    """The cluster flags of ``argv`` with their values, in order, as
    argparse lists unrecognized arguments."""
    flags = ("--coordinator", "--num-processes", "--process-id", "--dist-backend")
    out, i = [], 0
    while i < len(argv):
        tok = argv[i]
        if tok.split("=", 1)[0] in flags:
            out.append(tok)
            if "=" not in tok and i + 1 < len(argv):
                out.append(argv[i + 1])
                i += 1
        i += 1
    return out


def _main_fleet(argv: list[str]) -> int:
    """``run_sim fleet campaign.toml``: compile and run a Monte Carlo
    certification campaign (``fleet/``) and print the certification
    summary. ``--lane K --solo`` runs lane K alone through the plain
    ``simulate`` over the plans the campaign compiled for it and prints its
    digests, the other half of the lane-equals-solo contract. Config errors
    exit 2 with ``fleet: ...``, as in the JAX CLI."""
    from tpu_gossip_torch import fleet
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.faults import ScenarioError
    p = argparse.ArgumentParser(prog="run_sim fleet", description="Monte Carlo certification campaigns")
    p.add_argument("campaign", help="campaign TOML (scenarios/campaigns/)")
    p.add_argument("--report", default="", metavar="PATH",
                   help="write the FULL certification report JSON here (per-lane detail included; stdout carries "
                   "the compact summary)")
    p.add_argument("--lane", type=int, default=-1, metavar="K", help="with --solo: the lane to run alone")
    p.add_argument("--solo", action="store_true",
                   help="run --lane K alone through sim.engine.simulate over the lane's compiled plans and print "
                   "its digests (the conformance oracle; bit-identical to lane K of the fleet)")
    p.add_argument("--quiet", action="store_true", help="omit per-lane digests from the summary row")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="durable periodic checkpointing of the whole lane stack (one file per lane); `run_sim "
                   "resume D` finishes the campaign bit-identically, `resume D --lane K --solo` recovers one lane")
    p.add_argument("--checkpoint-dir", type=str, default="", metavar="D")
    p.add_argument("--keep", type=int, default=0, metavar="N",
                   help="retention: keep the newest N checkpoints (0 = all)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    try:
        camp = fleet.compile_campaign(fleet.parse_campaign(args.campaign), device=dev)
    except (fleet.CampaignError, ScenarioError, OSError) as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2

    if args.solo:
        if args.lane < 0:
            print("fleet: --solo needs --lane K", file=sys.stderr)
            return 2
        try:
            fin, stats = fleet.run_lane_solo(camp, args.lane)
        except fleet.CampaignError as e:
            print(f"fleet: {e}", file=sys.stderr)
            return 2
        from tpu_gossip_torch.sim import metrics as M

        print(json.dumps({
            "summary": True, "fleet": "solo", "campaign": camp.name, "lane": args.lane,
            "state_digest": fleet.state_digest(fin), "stats_digest": fleet.stats_digest(stats),
            "reliability": M.reliability_report(stats, target_ratio=camp.target_ratio,
                                                coverage_target=camp.coverage_target),
        }))
        return 0
    err = _fleet_refusal(args, camp)
    if err:
        print(f"fleet: {err}", file=sys.stderr)
        return 2
    policy = _fleet_policy(args, camp, args.campaign, report=args.report, quiet=args.quiet)
    t0 = time.perf_counter()
    if policy is not None:
        fin, stats = _run_fleet_checkpointed(camp, camp.states, policy)
    else:
        fin, stats = fleet.run_campaign(camp, keep_states=False)
        if dev.type == "cuda":  # the wall clock stops after the last round
            import torch

            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    camp.states, camp.consumed = fin, True
    return _emit_fleet_summary(camp, fin, stats, wall, quiet=args.quiet, report_path=args.report)


def _fleet_refusal(args: argparse.Namespace, camp) -> str | None:
    """The reason a fleet run's flags cannot run (the JAX CLI's words,
    after ``fleet: ``), or None."""
    if args.lane >= 0:
        return "--lane selects the --solo lane; drop it for the batched run (every lane runs)"
    if args.checkpoint_every < 0 or args.keep < 0:
        return "--checkpoint-every and --keep must be >= 0"
    if args.checkpoint_every and not args.checkpoint_dir:
        return "--checkpoint-every needs --checkpoint-dir D"
    if args.checkpoint_dir and not args.checkpoint_every:
        return "--checkpoint-dir shapes periodic checkpointing; add --checkpoint-every K"
    if args.checkpoint_every and args.checkpoint_every >= camp.rounds:
        return (f"--checkpoint-every {args.checkpoint_every} must be below the campaign horizon ({camp.rounds} "
                "rounds)")
    return None


def _run_fleet_checkpointed(camp, state, policy, prefix=None):
    """The fleet's horizon in segments with a checkpoint between them (one
    file a lane); returns ``(final states, stacked stats)``."""
    from tpu_gossip_torch import fleet
    from tpu_gossip_torch.ckpt import host_stats, run_checkpointed

    def seg_run(st, seg):
        st, s = fleet.simulate_fleet(st, camp.cfg, seg, camp.scenario, camp.growth, camp.stream, camp.control,
                                     camp.liveness)
        return st, host_stats(s)

    fin, sd = run_checkpointed(state, camp.rounds, seg_run, policy=policy, stats_prefix=prefix, round_axis=1,
                               log=_stderr_log)
    return fin, _split_host_stats(sd)[0]


def _fleet_policy(a, camp, campaign_path, *, report="", quiet=False):
    """The fleet run's CheckpointPolicy (one checkpoint file a lane), or
    None without --checkpoint-every."""
    if not getattr(a, "checkpoint_every", 0):
        return None
    from tpu_gossip_torch.ckpt import CheckpointPolicy

    return CheckpointPolicy(every=a.checkpoint_every, directory=a.checkpoint_dir, keep=a.keep, shards=camp.k,
                            kind="fleet",
                            run_config={"campaign": campaign_path, "report": report, "quiet": bool(quiet),
                                        "checkpoint_every": a.checkpoint_every, "checkpoint_dir": a.checkpoint_dir,
                                        "keep": a.keep})


def _emit_fleet_summary(camp, fin, stats, wall: float, *, quiet: bool, report_path: str,
                        rounds_timed: int | None = None) -> int:
    """The campaign's certification summary (and the full report to
    ``report_path``), one emitter for the plain, checkpointed and resumed
    runs; ``rounds_timed`` is the rounds ``wall`` covers (a resumed run
    timed only what it ran)."""
    from tpu_gossip_torch import fleet
    from tpu_gossip_torch.core.state import lane_state

    report = fleet.campaign_report(camp, stats)
    timed = camp.rounds if rounds_timed is None else rounds_timed
    summary = {
        "summary": True, "fleet": True, "campaign": camp.name, "lanes": camp.k, "rounds": camp.rounds,
        "n_peers": int(camp.base.get("peers", 0)), "wall_seconds": round(wall, 3),
        "swarm_rounds_per_sec": round(camp.k * timed / max(wall, 1e-9), 2),
        "families": [{k: f.get(k) for k in ("family", "lanes", "lanes_judged", "reliability", "frontier")
                      if f.get(k) is not None} for f in report["families"]],
    }
    if not quiet:
        summary["lane_digests"] = {str(k): fleet.state_digest(lane_state(fin, k)) for k in range(camp.k)}
        summary["stats_digests"] = {str(k): fleet.stats_digest(stats, k) for k in range(camp.k)}
    print(json.dumps(summary))
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")
    return 0


def _resume_fleet(rargs, path, manifest) -> int:
    """Fleet crash recovery: rebuild the campaign from the recorded TOML,
    put the checkpointed lane stack (or one lane, ``--lane K --solo``) in,
    finish the horizon and print the summary the uninterrupted run would
    have printed, lane digests equal."""
    from tpu_gossip_torch import fleet
    from tpu_gossip_torch.ckpt import CheckpointError, load_checkpoint
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.faults import ScenarioError

    dev = resolve_device(rargs.device)
    run_cfg = manifest["run"]
    try:
        camp = fleet.compile_campaign(fleet.parse_campaign(run_cfg["campaign"]), device=dev)
    except (fleet.CampaignError, ScenarioError, OSError, KeyError) as e:
        print(f"resume: cannot rebuild campaign {run_cfg.get('campaign')!r}: {e}", file=sys.stderr)
        return 2
    if rargs.solo or rargs.lane >= 0:
        if not (rargs.solo and rargs.lane >= 0):
            print("resume: per-lane recovery needs BOTH --lane K and --solo", file=sys.stderr)
            return 2
        try:
            st, _prefix, _ = load_checkpoint(path, lane=rargs.lane, manifest=manifest, device=dev)
        except CheckpointError as e:
            print(f"resume: {e}", file=sys.stderr)
            return 2
        from tpu_gossip_torch.sim.engine import simulate

        _st0, sc, gr, sp, cp = camp.lane(rargs.lane)
        fin, _stats = simulate(st, camp.cfg, camp.rounds - int(st.round), None, "fused", scenario=sc, growth=gr,
                               stream=sp, control=cp, liveness=camp.liveness)
        print(json.dumps({"summary": True, "fleet": "solo-resume", "campaign": camp.name, "lane": rargs.lane,
                          "state_digest": fleet.state_digest(fin)}))
        return 0
    try:
        state, prefix, _ = load_checkpoint(path, manifest=manifest, device=dev)
    except CheckpointError as e:
        print(f"resume: {e}", file=sys.stderr)
        return 2
    start_round = int(state.round.reshape(-1)[0])
    if start_round >= camp.rounds:
        print("resume: checkpoint round is past the campaign horizon — nothing to resume", file=sys.stderr)
        return 2
    policy = _fleet_policy(argparse.Namespace(checkpoint_every=run_cfg.get("checkpoint_every", 0),
                                              checkpoint_dir=run_cfg.get("checkpoint_dir", ""),
                                              keep=run_cfg.get("keep", 0)),
                           camp, run_cfg.get("campaign", ""), report=run_cfg.get("report", ""),
                           quiet=run_cfg.get("quiet", False))
    t0 = time.perf_counter()
    fin, stats = _run_fleet_checkpointed(camp, state, policy, prefix)
    wall = time.perf_counter() - t0
    camp.states, camp.consumed = fin, True
    return _emit_fleet_summary(camp, fin, stats, wall, quiet=bool(rargs.quiet or run_cfg.get("quiet")),
                               report_path=run_cfg.get("report", ""), rounds_timed=camp.rounds - start_round)


def _validate_ckpt(args: argparse.Namespace) -> str | None:
    """The reason a checkpoint config cannot run (the JAX CLI's wording),
    or None."""
    if args.checkpoint_every < 0:
        return "--checkpoint-every must be >= 0"
    if args.checkpoint_every == 0:
        set_flags = [name for name, dflt in (("--checkpoint-dir", args.checkpoint_dir == ""),
                                             ("--keep", args.keep == 0),
                                             ("--checkpoint-shards", args.checkpoint_shards == 0)) if not dflt]
        if set_flags:
            return f"{set_flags[0]} shapes periodic checkpointing; add --checkpoint-every K"
        return None
    if not args.checkpoint_dir:
        return ("--checkpoint-every needs --checkpoint-dir D — the durable directory the ckpt-<round> "
                "checkpoints land in")
    if args.rounds <= 0:
        return ("--checkpoint-every segments a FIXED horizon; a run-to-coverage loop is a single on-device "
                "while_loop with no deterministic segment grid to cut at — pass --rounds R")
    if args.profile_round > 0:
        return ("--profile-round slope-times the round's stages instead of running a horizon; drop the "
                "checkpoint flags")
    if args.keep < 0 or args.checkpoint_shards < 0:
        return "--keep and --checkpoint-shards must be >= 0"
    if args.checkpoint_every >= args.rounds:
        return (f"--checkpoint-every {args.checkpoint_every} must be below --rounds {args.rounds}, or no "
                "checkpoint would ever land inside the horizon")
    if args.shard and args.remat_every > 0 and args.checkpoint_every % args.remat_every != 0:
        return ("--checkpoint-every must be a MULTIPLE of --remat-every under --shard: mid-epoch mesh state "
                "cannot be re-placed without that epoch's partition tables, so checkpoints land at epoch "
                "boundaries (pre-fold) and resume replays the fold + re-partition deterministically "
                "(docs/checkpointing.md)")
    return None


def _ckpt_policy(args: argparse.Namespace, shards: int, extra: dict | None = None):
    """The run's CheckpointPolicy, or None without --checkpoint-every;
    ``shards`` is the path's default file count, ``extra`` layout facts
    a resume checks."""
    if args.checkpoint_every <= 0:
        return None
    from tpu_gossip_torch.ckpt import CheckpointPolicy

    run_cfg = _manifest_run_config(args)
    run_cfg.update(extra or {})
    return CheckpointPolicy(every=args.checkpoint_every, directory=args.checkpoint_dir, keep=args.keep,
                            shards=args.checkpoint_shards or shards, run_config=run_cfg)


def _manifest_run_config(args: argparse.Namespace) -> dict:
    """The manifest's ``run`` section: every settled arg under the JAX
    CLI's name (the port's own --device and --profile left out), so either
    package's ``resume`` rebuilds the run."""
    out = {k: v for k, v in vars(args).items()
           if not k.startswith("_") and k not in _UNRECORDED
           and (v is None or isinstance(v, (str, int, float, bool)))}
    return {**out, **_PLACEMENT}


def _stderr_log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _split_host_stats(sd: dict):
    """The driver's joined host stats back into ``(RoundStats, IciRound |
    None)`` of tensors: the transport counters ride the ``ici__`` prefix."""
    import torch

    from tpu_gossip_torch.sim.engine import RoundStats

    stats = RoundStats(*(torch.from_numpy(np.asarray(sd[f])) for f in RoundStats._fields))
    ici = None
    if any(k.startswith("ici__") for k in sd):
        from tpu_gossip_torch.dist.transport import IciRound

        ici = IciRound(*(torch.from_numpy(np.asarray(sd[f"ici__{f}"])) for f in IciRound._fields))
    return stats, ici


def _layout_summary(args: argparse.Namespace) -> dict:
    """The summary's layout fields: whether the run carried packed state
    and, off the default, which matching builder laid the graph out."""
    out = {"packed": bool(args.packed)}
    if getattr(args, "builder", "local") != "local":
        out["builder"] = args.builder
    return out


def _transport_summary(args: argparse.Namespace, ici=None, rounds: int = 0, graph=None) -> dict:
    """The summary's transport fields of a --shard run: the configured lane
    and, when the counter ran, the realized bytes a round (dense, shipped,
    occupied; ``dense_bool`` the bool-plane wire of ``graph``) and the
    compact lanes taken. On the matching mesh these are the JAX package's
    byte-plane wire model, as its summary prints them; the port's pipeline
    moves int32 words and gates its own lanes on them
    (``dist.transport.lane_counts``)."""
    if not args.shard:
        return {}
    out = {"transport": args.transport}
    if ici is None:
        return out
    tot = {f: int(np.asarray(getattr(ici, f)).astype(np.int64).sum()) for f in ici._fields}
    r = max(rounds, 1)
    out["ici_bytes_per_round"] = {
        "dense": round(4 * tot["dense_words"] / r, 1),
        "shipped": round(4 * tot["shipped_words"] / r, 1),
        "occupied": round(4 * tot["occupied_words"] / r, 1),
        "reduction_vs_dense": round(tot["dense_words"] / max(tot["shipped_words"], 1), 3),
    }
    if args.hosts > 1:
        # the per-axis split of the same totals: the dcn_* columns price the
        # host axis, the rest is the intra-host remainder
        dcn_d, dcn_s = tot["dcn_dense_words"], tot["dcn_shipped_words"]
        ici_d, ici_s = tot["dense_words"] - dcn_d, tot["shipped_words"] - dcn_s
        out["ici_bytes"] = {"dense": round(4 * ici_d / r, 1), "shipped": round(4 * ici_s / r, 1),
                            "reduction_vs_dense": round(ici_d / max(ici_s, 1), 3)}
        out["dcn_bytes"] = {"dense": round(4 * dcn_d / r, 1), "shipped": round(4 * dcn_s / r, 1),
                            "reduction_vs_dense": round(dcn_d / max(dcn_s, 1), 3)}
    if graph is not None:
        from tpu_gossip_torch.core.matching_topology import MatchingPlan

        if isinstance(graph, MatchingPlan):
            from tpu_gossip_torch.dist.matching_mesh import dense_wire_words
        else:
            from tpu_gossip_torch.dist.mesh import dense_wire_words
        out["ici_bytes_per_round"]["dense_bool"] = round(
            4 * dense_wire_words(graph, args.slots, args.mode, args.forward_once, bool_planes=True), 1)
    out["sparse_lanes"] = {"taken": tot["sparse_lanes"], "gated": tot["total_lanes"]}
    return out


def _swap_in_resume(resume: _Resume, shape: tuple, args: argparse.Namespace, dev):
    """The checkpointed state in place of the fresh one (whose shape the
    rebuilt layout gave; the fresh state is dropped first, so the card
    never holds both), moved to ``dev``; returns ``(state, stats
    prefix)``. A layout mismatch fails with a named reason."""
    from tpu_gossip_torch.ckpt import CheckpointError

    loaded, manifest = resume.state, resume.manifest
    if tuple(loaded.seen.shape) != tuple(shape):
        raise CheckpointError(
            f"checkpoint state is (N={loaded.seen.shape[0]}, M={loaded.seen.shape[1]}) but the rebuilt run layout "
            f"is (N={shape[0]}, M={shape[1]}) — the manifest's recorded config no longer reproduces this layout")
    if int(manifest.get("round", 0)) >= args.rounds:
        raise CheckpointError(f"checkpoint round {manifest.get('round')} is not inside the run's horizon "
                              f"({args.rounds} rounds) — nothing to resume")
    t0 = time.perf_counter()
    rebuild_s = t0 - resume.t0 - resume.scan_s - resume.load_s
    state = dataclasses.replace(loaded, **{f.name: getattr(loaded, f.name).to(dev)
                                           for f in dataclasses.fields(loaded)})
    resume.state = None
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    _stderr_log(f"resume: recovered in {t1 - resume.t0:.3f} s (latest_complete {resume.scan_s:.3f} s, "
                f"load_checkpoint {resume.load_s:.3f} s, graph and plans rebuilt {rebuild_s:.3f} s, state to "
                f"{dev} {t1 - t0:.3f} s)")
    return state, resume.prefix


def _check_resume_devices(resume: _Resume | None, mesh_size: int) -> None:
    """A mesh checkpoint resumes onto a mesh of the size it recorded."""
    if resume is None:
        return
    from tpu_gossip_torch.ckpt import CheckpointError

    recorded = (resume.manifest.get("run") or {}).get("devices")
    if recorded is not None and int(recorded) != int(mesh_size):
        raise CheckpointError(
            f"checkpoint was written by a {recorded}-device mesh run but this process has {mesh_size} devices — "
            f"resume on a {recorded}-device mesh, or (sharded matching) restore into the local engine with "
            "`run_sim resume D --local`")


def _digest_summary(args: argparse.Namespace, fin, stats, durable: bool = False) -> dict:
    """state/stats digests for the summary row: with --digest, and always
    on a checkpointed or resumed run (the recovery contract's keys)."""
    if not (args.digest or durable):
        return {}
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    return {"state_digest": state_digest(fin), "stats_digest": stats_digest(stats)}


def run(args: argparse.Namespace) -> dict:
    """The run body: parsed ``args`` in, the summary dict out (per-round
    JSONL goes to stdout first unless ``--quiet``)."""
    return _execute(args)[0]


def _execute(args: argparse.Namespace, resume: _Resume | None = None):
    """:func:`run`'s body; returns ``(summary, final state)`` (the state
    None for ``--profile-round``). With ``resume``, the graph, plans and
    fresh state are rebuilt from the recorded args, then the checkpointed
    state takes the fresh one's place."""
    import torch

    from tpu_gossip_torch.core import prng, topology
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph, matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.sim.engine import remat_capacity, run_until_coverage, simulate
    from tpu_gossip_torch.utils.profiling import trace

    dev = resolve_device(args.device)
    spec = _scenario_spec(args)
    lqs = _compile_cli_liveness(args)
    ctl = _compile_cli_control(args, dev)
    rng = np.random.default_rng(args.seed)
    exists = plan = graph = None
    local = bool(getattr(args, "_resume_local", False))
    if args.graph == "matching" and args.shard:
        reason = None
        if args.remat_every > 0:
            reason = "--remat-every re-materializes the CSR, which the matching pipeline cannot absorb"
        elif not local and 128 % _mesh_size(args):
            reason = (f"mesh size {_mesh_size(args)} does not divide 128 (the sharded matching transpose's lane "
                      "split)")
        if reason is not None:
            # the one bucketed-CSR fallback: the classic build's exported CSR
            print(f"note: {reason} — falling back to the bucketed-CSR shard engine on the exported CSR",
                  file=sys.stderr)
            dgraph, _ = matching_powerlaw_graph(args.peers, gamma=args.gamma, fanout=None,
                                                key=prng.key(args.seed, dev), device=dev)
            graph = dgraph.to_host_graph()
        elif args.staircase:
            print("note: --staircase is ignored with --graph matching (the "
                  "matching pipeline IS the delivery plan)", file=sys.stderr)
    elif args.graph == "matching":
        fanout = None if args.mode == "flood" else args.fanout
        if args.grow:
            # the sharded layout's build at one shard: its growth rows are
            # reserved node gaps of the class table the pairing pipeline
            # never touches, the one matching growth layout
            dgraph, plan = matching_powerlaw_graph_sharded(
                args.peers, 1, gamma=args.gamma, fanout=fanout, key=prng.key(args.seed, dev),
                growth_rows=args.grow_capacity - args.peers, device=dev,
            )
        else:
            dgraph, plan = matching_powerlaw_graph(
                args.peers, gamma=args.gamma, fanout=fanout, key=prng.key(args.seed, dev), device=dev,
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
        if args.grow and not args.shard:
            from tpu_gossip_torch.growth import pad_graph_for_growth

            graph, exists = pad_graph_for_growth(graph, args.grow_capacity)
            exists = torch.from_numpy(exists).to(dev)
        if args.staircase and not args.shard and args.remat_every == 0:
            # (with --remat-every the plan is rebuilt per segment instead)
            plan = _staircase_plan(args, graph, dev)
    cfg_kw = dict(msg_slots=args.slots, fanout=args.fanout, mode=args.mode, forward_once=args.forward_once,
                  sir_recover_rounds=args.sir_recover, churn_leave_prob=args.churn_leave,
                  churn_join_prob=args.churn_join, rewire_slots=_rewire_slots(args),
                  rewire_compact_cap=args.rewire_compact_cap)
    origins, silent_ids = _sample_ids(args, rng)
    replay = None
    if args.shard and graph is None:
        cfg, state, segment, to_target, extra, replay, n_build = _shard_matching_runners(
            args, origins, silent_ids, cfg_kw, dev, spec, lqs, ctl, local, resume)
        policy = _ckpt_policy(args, shards=n_build, extra={"devices": n_build})
    elif args.shard:
        cfg, state, segment, to_target, extra, epoch, grow, replay = _shard_runners(
            args, graph, origins, silent_ids, cfg_kw, dev, spec, lqs, ctl)
        strm = None  # (the bucketed runners carry their own, in the mesh's rows)
        policy = _ckpt_policy(args, shards=epoch[0].size, extra={"devices": epoch[0].size})
        _check_resume_devices(resume, epoch[0].size)
    else:
        cfg = SwarmConfig(n_peers=graph.n, **cfg_kw)
        state = init_swarm(graph, cfg, key=prng.key(args.seed, dev), origins=origins,
                           exists=exists, device=dev)
        state.silent = _set_rows(state.silent, silent_ids)
        scen = _compile_cli_scenario(spec, args, graph.n, dev)
        grow = _compile_cli_growth(args, spec, graph.n, dev, plan=plan if args.graph == "matching" else None)
        strm = _compile_cli_stream(args, np.arange(graph.n) if exists is None else
                                   np.flatnonzero(_host_mask(exists)), dev)
        extra = {}

        def segment(st, rounds):
            return simulate(st, cfg, rounds, plan, args.tail, scenario=scen, liveness=lqs, growth=grow,
                            stream=strm, control=ctl)

        def to_target(st):
            return run_until_coverage(st, cfg, args.target, args.max_rounds, plan=plan, tail=args.tail,
                                      scenario=scen, liveness=lqs, growth=grow, control=ctl)

        if args.profile_round > 0:
            return _profile_round(args, cfg, state, plan, grow, strm, ctl), None
        policy = _ckpt_policy(args, shards=1)
    # the local remat loop's capacity comes from the fresh state, as in the
    # uninterrupted run, before a resumed state takes its place
    cap = remat_capacity(state, cfg) if args.remat_every > 0 and not args.shard else 0
    prefix = None
    mesh = getattr(args, "_mesh", None)
    if resume is not None:
        shape = tuple(state.seen.shape)
        if mesh is not None and mesh.world > 1:
            shape = (shape[0] * mesh.world,) + shape[1:]
        del state
        state, prefix = _swap_in_resume(resume, shape, args, dev)
        if mesh is not None and mesh.world > 1:
            from tpu_gossip_torch import dist

            state = dist.shard_swarm(state, mesh)
        if local and prefix is not None:
            # the local restore ships no ICI bytes: the byte accounting ends
            # at the crash (the trajectory's stats are the transport's own)
            prefix = {k: v for k, v in prefix.items() if not k.startswith("ici__")}
    durable = policy is not None or resume is not None
    marks = _horizon_start(dev) if durable and dev.type == "cuda" else None
    with trace(args.profile):
        if args.remat_every > 0 and args.shard:
            summary, fin = _run_shard_with_remat(args, cfg, state, *epoch, lqs, ctl, policy=policy, prefix=prefix,
                                                 durable=durable)
            summary.update(_scenario_summary(spec))
            summary.update(_pipeline_summary(args))
            summary.update(_control_summary(args))
        elif args.remat_every > 0:
            summary, fin = _run_with_remat(args, cfg, state, dev, cap, scen, lqs, grow, strm, ctl, policy=policy,
                                           prefix=prefix, durable=durable)
            summary.update(_scenario_summary(spec))
        elif args.rounds > 0:
            fin, stats, ici, _wall = _run_checkpointed_horizon(args, state, segment, policy, prefix,
                                                               pack=args.packed)
            fin = _gathered(args, fin)
            wire = extra.pop("_wire", None)
            summary = {**_horizon_summary(args, stats, **extra, **_scenario_summary(spec, stats),
                                          **_transport_summary(args, ici, args.rounds, wire),
                                          **_stream_summary(args, cfg, stats), **_control_summary(args, cfg, stats),
                                          **_liveness_summary(args, stats)),
                       **_digest_summary(args, fin, stats, durable)}
        else:
            wire = extra.pop("_wire", None)
            summary, fin = _run_to_target(args, cfg, state, to_target,
                                          {**extra, **_scenario_summary(spec), **_control_summary(args),
                                           **_liveness_summary(args)})
            rounds = int(fin.round) - int(state.round)
            # the timed run carries no counter; an untimed replay of the
            # realized horizon (the same rounds, bit for bit) reads the bytes
            ici = replay(state, rounds) if replay is not None and rounds > 0 else None
            summary.update(_transport_summary(args, ici, rounds, wire))
    if marks is not None:
        import torch

        build, start = marks
        horizon = torch.cuda.max_memory_allocated(dev)
        _stderr_log(f"checkpoint: device peak max_memory_allocated {max(build, horizon)} B (the build {build} B; "
                    f"the horizon {horizon} B, from {start} B allocated at its start)")
    summary.update(_growth_summary(args, fin))
    summary.update(_layout_summary(args))
    return summary, fin


def _host_mask(mask) -> np.ndarray:
    """A bool row mask (numpy, or a tensor on any device) as numpy."""
    return mask.detach().cpu().numpy() if hasattr(mask, "detach") else np.asarray(mask)


def _scenario_spec(args: argparse.Namespace):
    """The run's parsed ``--scenario``, None without one."""
    if not args.scenario:
        return None
    from tpu_gossip_torch.faults import parse_scenario

    return parse_scenario(args.scenario)


def _sample_ids(args: argparse.Namespace, rng):
    """Origin peers, then silent peers, drawn once from the run's ``rng``
    as the JAX CLI draws them (the sharded path maps both through
    ``position``)."""
    origins = rng.choice(args.peers, size=min(args.origins, args.peers), replace=False)
    silent_ids = None
    if args.silent_frac > 0:
        k = int(args.silent_frac * args.peers)
        silent_ids = rng.choice(args.peers, size=k, replace=False)
    return origins, silent_ids


def _set_rows(mask, rows):
    """``mask`` with ``rows`` (numpy ids, or None for none) set."""
    if rows is None:
        return mask
    import torch

    return mask.index_fill(0, torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=mask.device), True)


def _compile_cli_scenario(spec, args: argparse.Namespace, n_slots: int, dev, node_map=None, shard_ranges=None,
                          n_shards=None):
    """Compile the parsed --scenario for one engine's slot layout on
    ``dev`` (node sets are declared over real peer ids; ``node_map`` is the
    engine's id-to-row mapping, the bucketed mesh's ``position``)."""
    if spec is None:
        return None
    from tpu_gossip_torch.faults import compile_scenario

    return compile_scenario(spec, n_peers=args.peers, n_slots=n_slots, total_rounds=_total_rounds(args),
                            node_map=node_map, shard_ranges=shard_ranges, n_shards=n_shards, device=dev)


def _scenario_summary(spec, stats=None) -> dict:
    """Summary-row fields for an active scenario, with the per-phase report
    when per-round stats exist."""
    if spec is None:
        return {}
    out = {"scenario": spec.name}
    if stats is not None:
        from tpu_gossip_torch.sim import metrics as M

        out["phases"] = M.phase_report(stats, spec)
    return out


def _horizon_start(dev) -> tuple[int, int]:
    """On the card, as a durable horizon starts: the device peak of the
    build (graph, plans, state, a resumed state's load) and the bytes
    allocated now; the peak is then reset, so the horizon's is its own."""
    import torch

    torch.cuda.synchronize(dev)
    marks = torch.cuda.max_memory_allocated(dev), torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return marks


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
    """The epoch loop of both remat runners without checkpoints: segments
    of ``--remat-every`` rounds (to the horizon, or until ``--target``
    with no horizon), each but the last followed by ``fold``. Returns the
    final state, the segments' stats (a horizon only), the number of folds
    and the wall seconds."""
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


def _remat_summary(args: argparse.Namespace, state, parts, wall: float, extra: dict, sim_wall: float,
                   target_liveness: bool = True, cfg=None) -> dict:
    """The summary of a remat run: the horizon row with the digests, or
    the run-to-target row (with the ``liveness`` block's config when
    ``target_liveness``: the JAX CLI's sharded remat row has none)."""
    from tpu_gossip_torch.sim.engine import _concat

    if args.rounds > 0:
        stats = _concat(parts)
        if not args.quiet:
            from tpu_gossip_torch.sim import metrics as M

            M.write_jsonl(stats, sys.stdout)
        summary = _horizon_summary(args, stats, **extra, **_stream_summary(args, cfg, stats),
                                   **_control_summary(args, cfg, stats), **_liveness_summary(args, stats))
        summary.update(_digest_summary(args, state, stats))
        return summary
    rounds = int(state.round)
    return {
        "summary": True, "mode": args.mode, "n_peers": args.peers, "rounds": rounds, "target": args.target,
        "wall_seconds": wall, "peers_rounds_per_sec": args.peers * rounds / max(wall, 1e-9),
        "coverage": float(state.coverage(0)), "ms_per_round": sim_wall / max(rounds, 1) * 1000.0, **extra,
        **(_liveness_summary(args) if target_liveness else {}),
    }


def _run_checkpointed_horizon(args: argparse.Namespace, state, segment, policy, prefix, *, fold=None,
                              pack: bool = False):
    """Every fixed horizon, through ``ckpt.run_checkpointed``: segments
    cut at the checkpoint grid (and, with ``fold``, the remat grid), a
    checkpoint between segments, a resumed run's stats prefix in front;
    one segment without a policy. A packed run's checkpoints hold the
    packed carry as it is. Returns the final state (unpacked), the stats
    and the wall seconds."""
    from tpu_gossip_torch.ckpt import host_stats, run_checkpointed
    from tpu_gossip_torch.core.packed import pack_state, unpack_state

    def seg_run(st, seg):
        st, s = segment(st, seg)
        return st, host_stats(*s) if type(s) is tuple else host_stats(s)  # (stats, ici) with a counter

    def to_save(st):
        # every rank joins the gather; rank 0 writes the whole swarm
        whole = _gathered(args, st)
        return whole if _rank() == 0 else None

    t0 = time.perf_counter()
    fin, sd = run_checkpointed(pack_state(state) if pack else state, args.rounds, seg_run, policy=policy,
                               stats_prefix=prefix, fold_every=args.remat_every if fold else 0, fold=fold,
                               log=_stderr_log, to_save=to_save)
    wall = time.perf_counter() - t0
    stats, ici = _split_host_stats(sd)
    if not args.quiet:
        from tpu_gossip_torch.sim import metrics as M

        M.write_jsonl(stats, sys.stdout)
    return (unpack_state(fin) if pack else fin), stats, ici, wall


def _run_with_remat(args: argparse.Namespace, cfg, state, dev, cap: int, scen=None, lqs=None, grow=None, strm=None,
                    ctl=None, *, policy=None, prefix=None, durable: bool = False):
    """--remat-every R on the local engine: R rounds, then fold the fresh
    edges into the CSR at the capacity ``cap`` taken once from the fresh
    initial state; with --staircase the plan is rebuilt from each
    segment's CSR. Checkpointed or resumed (``durable``), the horizon runs
    through the driver, whose fold hook folds at the epoch boundaries (a
    run resumed on one replays its fold first); ``remats`` is then the
    whole horizon's count."""
    from tpu_gossip_torch.sim.engine import rematerialize_rewired, run_until_coverage, simulate

    overflow = []

    def fold(st):
        st, over = rematerialize_rewired(st, cfg, cap)
        overflow.append(over)
        if durable:
            _stderr_log(f"remat: fold at round {int(st.round)}, {int(over)} overflow edges")
        return st

    def horizon_segment(st, seg):
        return simulate(st, cfg, seg, _staircase_plan(args, st, dev) if args.staircase else None, args.tail,
                        scenario=scen, liveness=lqs, growth=grow, stream=strm, control=ctl)

    r = args.remat_every
    if durable:
        fin, stats, _, wall = _run_checkpointed_horizon(args, state, horizon_segment, policy, prefix, fold=fold)
        summary = _horizon_summary(args, stats, remat_every=r, remats=(args.rounds - 1) // r,
                                   remat_overflow_edges=sum(int(o) for o in overflow), wall_seconds=wall,
                                   **_stream_summary(args, cfg, stats), **_control_summary(args, cfg, stats),
                                   **_liveness_summary(args, stats))
        summary.update(_digest_summary(args, fin, stats, durable=True))
        return summary, fin

    def run_segment(st, seg):
        if args.rounds > 0:
            return horizon_segment(st, seg)
        plan = _staircase_plan(args, st, dev) if args.staircase else None
        return run_until_coverage(st, cfg, args.target, seg, plan=plan, tail=args.tail, scenario=scen,
                                  liveness=lqs, growth=grow, stream=strm, control=ctl), None

    state, parts, remats, wall = _remat_loop(args, state, run_segment, fold)
    extra = {"remat_every": r, "remats": remats, "remat_overflow_edges": sum(int(o) for o in overflow)}
    return _remat_summary(args, state, parts, wall, extra, wall, cfg=cfg), state


def _run_shard_with_remat(args: argparse.Namespace, cfg, state, mesh, sg, plans, scen=None, lqs=None, ctl=None, *,
                          policy=None, prefix=None, durable: bool = False):
    """--shard --remat-every R: R rounds on the mesh, then fold the fresh
    edges into the CSR, re-partition the live swarm with seed ``--seed``
    plus the fold's index (the round over R, so a resumed run draws the
    partition the uninterrupted one drew), re-shard it and rebuild K6's
    plans with --staircase. Checkpointed or resumed (``durable``), the
    horizon runs through the driver; its checkpoints land on the epoch
    boundaries before the fold, and a resumed run replays the fold first.
    The rebuilds' seconds are reported apart. A scenario (scalar phases
    only: node masks would not survive the re-partition) stays compiled
    over the first epoch's layout, as in the JAX CLI; so does a --pipeline
    schedule."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.sim.engine import remat_capacity, rematerialize_rewired

    pipe = _compile_cli_pipeline(args)
    r = args.remat_every

    def transport_for(sg_now):
        # the compact lane's tables key on the bucket layout: rebuilt each epoch
        return None if args.transport == "dense" else dist.build_transport(sg_now, mode=args.transport)

    epoch = {"sg": sg, "plans": plans, "overflow": 0, "rebuild_s": 0.0, "transport": transport_for(sg)}

    def run_segment(st, seg):
        if args.rounds > 0:
            return dist.simulate_dist(st, cfg, epoch["sg"], mesh, seg, epoch["plans"], scenario=scen, liveness=lqs,
                                      control=ctl, pipeline=pipe, transport=epoch["transport"])
        return dist.run_until_coverage_dist(st, cfg, epoch["sg"], mesh, args.target, seg,
                                            shard_plan=epoch["plans"], scenario=scen, liveness=lqs,
                                            control=ctl, pipeline=pipe, transport=epoch["transport"]), None

    def fold(st):
        t0 = time.perf_counter()
        seed = args.seed + int(st.round) // r
        st, over = rematerialize_rewired(st, cfg, remat_capacity(st, cfg))
        epoch["sg"], st, _ = dist.repartition_swarm(st, mesh.size, seed=seed)
        st = dist.shard_swarm(st, mesh)
        if epoch["plans"] is not None:
            epoch["plans"] = dist.build_shard_plans(epoch["sg"])
        epoch["transport"] = transport_for(epoch["sg"])
        epoch["overflow"] += int(over)
        epoch["rebuild_s"] += time.perf_counter() - t0
        if durable:
            _stderr_log(f"remat: fold at round {int(st.round)}, {int(over)} overflow edges, re-partition seed "
                        f"{seed}")
        return st

    if durable:
        fin, stats, _, wall = _run_checkpointed_horizon(args, state, run_segment, policy, prefix, fold=fold)
        summary = _horizon_summary(args, stats, devices=mesh.size, remat_every=r, remats=(args.rounds - 1) // r,
                                   wall_seconds=wall, **_control_summary(args, cfg, stats),
                                   **_liveness_summary(args, stats))
        summary.update(_digest_summary(args, fin, stats, durable=True))
        summary["transport"] = args.transport
        return summary, fin

    state, parts, remats, wall = _remat_loop(args, state, run_segment, fold)
    out = {"devices": mesh.size, "remat_every": r, "remats": remats, "remat_overflow_edges": epoch["overflow"],
           "epoch_rebuild_seconds_total": round(epoch["rebuild_s"], 3)}
    summary = _remat_summary(args, state, parts, wall, out, wall - epoch["rebuild_s"], target_liveness=False,
                             cfg=cfg)
    if args.rounds == 0:
        summary["ms_per_round_amortized"] = wall / max(int(state.round), 1) * 1000.0
    summary["transport"] = args.transport
    return summary, state


def _run_to_target(args: argparse.Namespace, cfg, state, to_target, extra: dict):
    """The run to ``--target`` (the benchmark summary); returns the summary
    and the final state."""
    from tpu_gossip_torch.core.packed import pack_state, unpack_state
    from tpu_gossip_torch.sim import metrics as M

    def cov_run(st):
        out = _gathered(args, to_target(pack_state(st) if args.packed else st))
        return unpack_state(out) if args.packed else out

    # a sharded run reports the real peer count, not the padded slot count
    result, fin = M.bench_swarm(state, cfg, args.target, args.max_rounds, run=cov_run,
                                n_peers=args.peers if args.shard else None)
    return {"summary": True, "mode": args.mode, **extra, **json.loads(result.to_json())}, fin


def _profile_round(args: argparse.Namespace, cfg, state, plan, grow=None, strm=None, ctl=None) -> dict:
    """--profile-round R: advance R rounds (mid-epidemic slot densities;
    with --grow, --stream or --control those planes run in the warm rounds
    too), then slope-time each stage (the growth, stream and control rows
    with their planes) and the composed round per tail; the table goes to
    stderr, the summary (ms a round, NaN as null) is returned. The
    ``transport_compact`` stage measures the sparse lane's compaction at
    this swarm's synthetic 8-shard bucket geometry: capacity the directed
    edges per (src, dst) pair rounded up to whole 1024-entry windows, budget
    1/8 of it."""
    from tpu_gossip_torch.core.state import clone_state
    from tpu_gossip_torch.kernels.pallas_segment import _slot_groups
    from tpu_gossip_torch.sim.engine import simulate
    from tpu_gossip_torch.utils.profiling import format_stage_table, profile_round_stages, stages_ms, trace

    warm, _ = simulate(clone_state(state), cfg, args.profile_round, plan, growth=grow, stream=strm, control=ctl)
    tails = ("reference", "fused") if args.tail != "pallas" else ("reference", "fused", "pallas")
    s_probe = 8
    e_real = int(state.row_ptr[-1])
    b_probe = max(1024, -(-e_real // (s_probe * s_probe * 1024)) * 1024)
    probe = (s_probe, b_probe, len(_slot_groups(args.slots)), max(b_probe // 8, 1))
    with trace(args.profile):
        stages = profile_round_stages(warm, cfg, plan, tails=tails, growth=grow, stream=strm, control=ctl,
                                      transport_probe=probe, device=state.seen.device)
    print(format_stage_table(stages), file=sys.stderr)
    return {"summary": True, "profile_round": True, "mode": args.mode, "n_peers": args.peers,
            "warm_rounds": args.profile_round, "stages_ms": stages_ms(stages)}


def _ici_runners(args: argparse.Namespace, transport, run_horizon):
    """``(segment, replay)`` of a sharded run: with a transport the horizon
    runs with the counter (segments return ``(stats, ici)``), and
    ``replay(state, rounds)`` reads the counter off an untimed replay of a
    run to target; without one, the plain segment and no replay."""
    if transport is None:
        return (lambda st, rounds: run_horizon(st, rounds, False)), None

    def replay(st, rounds):
        from tpu_gossip_torch.core.packed import pack_state

        return run_horizon(pack_state(st) if args.packed else st, rounds, True)[1][1]

    return (lambda st, rounds: run_horizon(st, rounds, True)), replay


def _shard_runners(args: argparse.Namespace, graph, origins, silent_ids, cfg_kw: dict, dev, spec=None, lqs=None,
                   ctl=None):
    """--shard: partition the graph over the mesh (pads born dead), with
    --staircase build K6's plans, with --transport the compact lane's
    tables, seed ``origins`` and the silent peers through the partition's
    relabelling, compile the scenario over the padded slot space through
    ``position``; returns ``(cfg, state, segment, to_target, extra summary
    keys, (mesh, sharded graph, plans, compiled scenario), compiled growth,
    the counter's replay)``. Under --grow the graph is padded to the
    capacity first and the admission order is the original ids' through
    ``position``."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig

    mesh = _cluster_mesh(args, dev)
    gexists = None
    if args.grow:
        from tpu_gossip_torch.growth import pad_graph_for_growth

        graph, gexists = pad_graph_for_growth(graph, args.grow_capacity)
    sg, relabeled, position = dist.partition_graph(graph, mesh.size, seed=args.seed, device=dev)
    transport = None if args.transport == "dense" else dist.build_transport(sg, mode=args.transport,
                                                                              hosts=args.hosts)
    cfg = SwarmConfig(n_peers=sg.n_pad, **cfg_kw)
    plans = dist.shard_plans(dist.build_shard_plans(sg) if args.staircase else None, mesh)
    state = dist.init_sharded_swarm(sg, relabeled, position, cfg, key=prng.key(args.seed, dev), origins=origins,
                                    exists=gexists, device=dev)
    state.silent = _set_rows(state.silent, None if silent_ids is None else position[silent_ids])
    state = dist.shard_swarm(state, mesh)
    held = dist.shard_graph(sg, mesh)
    scen = _compile_cli_scenario(spec, args, sg.n_pad, dev, node_map=lambda ids: position[np.asarray(ids)],
                                 shard_ranges=dist.shard_ranges(mesh.size, sg.per_shard, mesh=mesh),
                                 n_shards=mesh.size)
    grow = _compile_cli_growth(args, spec, sg.n_pad, dev, node_map=lambda ids: position[np.asarray(ids)])
    strm = _compile_cli_stream(args, position[np.arange(args.peers)], dev)
    pipe = _compile_cli_pipeline(args)

    def run_horizon(st, rounds, ici):
        return dist.simulate_dist(st, cfg, held, mesh, rounds, plans, scenario=scen, liveness=lqs, growth=grow,
                                  stream=strm, control=ctl, pipeline=pipe, transport=transport, collect_ici=ici)

    def to_target(st):
        return dist.run_until_coverage_dist(st, cfg, held, mesh, args.target, args.max_rounds, shard_plan=plans,
                                            scenario=scen, liveness=lqs, growth=grow, control=ctl, pipeline=pipe,
                                            transport=transport)

    segment, replay = _ici_runners(args, transport, run_horizon)
    return (cfg, state, segment, to_target, {"devices": mesh.size, "_wire": sg, **_pipeline_summary(args)},
            (mesh, sg, plans, scen), grow, replay)


def _shard_matching_runners(args: argparse.Namespace, origins, silent_ids, cfg_kw: dict, dev, spec=None, lqs=None,
                            ctl=None, local: bool = False, resume=None):
    """--shard --graph matching: the sharded matching layout built for the
    mesh (``--builder dist``: only the shards this process holds, equal to
    their rows of the block-keyed local build; ``--builder local``: whole,
    then this process's rows kept), the transport built from the held plan
    and the state initialised on this process's rows, peers ``i`` mapped to
    rows skipping each shard's pad rows, the planes compiled over the
    swarm's rows (its size from the layout); returns ``(cfg, state,
    segment, to_target, extra summary keys, the counter's replay, the
    layout's shard count)``. ``local`` (``run_sim
    resume D --local``) rebuilds the checkpoint's S-shard layout and
    finishes on the local engine over the unplaced plan."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim.engine import simulate

    mesh = None
    if local:
        from tpu_gossip_torch.ckpt import CheckpointError

        n_build = int(((resume.manifest.get("run") or {}) if resume else {}).get("devices") or 0)
        if n_build <= 0:
            raise CheckpointError("checkpoint manifest records no device count — cannot rebuild the sharded "
                                  "matching layout for a local restore")
        if args.transport != "dense":
            print("note: the recorded --transport compacts MESH collectives; the local restore moves no ICI bytes "
                  "(trajectory unchanged — the transport reorders bytes, never draws)", file=sys.stderr)
    else:
        mesh = _cluster_mesh(args, dev)
        _check_resume_devices(resume, mesh.size)
        n_build = mesh.size
    grow_rows = -(-(args.grow_capacity - args.peers) // n_build) if args.grow else 0
    fanout = None if args.mode == "flood" else args.fanout
    key = prng.key(args.seed, dev)
    if args.builder == "dist" and not local:
        # born on the mesh: this process's shards only, the CSR whole
        dgraph, plan = dist.matching_powerlaw_graph_dist(args.peers, mesh, gamma=args.gamma, fanout=fanout, key=key,
                                                         growth_rows=grow_rows)
        exists = dgraph.exists
    else:
        # a local restore of a --builder dist run rebuilds the same layout
        # through the block-keyed derivation; on a mesh the whole build
        # keeps this process's rows
        dgraph, plan = matching_powerlaw_graph_sharded(args.peers, n_build, gamma=args.gamma, fanout=fanout, key=key,
                                                       growth_rows=grow_rows, block_keys=args.builder == "dist",
                                                       device=dev)
        if not local:
            plan = dist.shard_matching_plan(plan, mesh)
        exists = dgraph.exists[plan.shard_lo * plan.n_blk: plan.shard_lo * plan.n_blk + plan.n]
    # the swarm's rows come from the layout; this process holds [lo, lo + plan.n)
    n_swarm, lo = plan.mesh_shards * plan.n_blk, plan.shard_lo * plan.n_blk
    transport = (dist.build_transport(plan, mode=args.transport, hosts=args.hosts, mesh=mesh)
                 if args.transport != "dense" and not local else None)
    cfg = SwarmConfig(n_peers=n_swarm, **cfg_kw)

    def to_rows(ids):
        """Peer index -> state row (skipping each shard's pad rows)."""
        ids = np.asarray(ids)
        return (ids // plan.n_per) * plan.n_blk + (ids % plan.n_per)

    state = init_swarm(dgraph.as_padded_graph(), cfg, key=prng.key(args.seed, dev), origins=to_rows(origins),
                       exists=exists, device=dev, rows=(lo, plan.n))
    del dgraph, exists
    if silent_ids is not None:
        held = to_rows(silent_ids) - lo
        state.silent = _set_rows(state.silent, held[(held >= 0) & (held < plan.n)])
    scen = _compile_cli_scenario(spec, args, n_swarm, dev, node_map=to_rows,
                                 shard_ranges=dist.shard_ranges(n_build, plan.n_blk, mesh=mesh), n_shards=n_build)
    grow = _compile_cli_growth(args, spec, n_swarm, dev, plan=plan)
    strm = _compile_cli_stream(args, to_rows(np.arange(args.peers)), dev)
    pipe = _compile_cli_pipeline(args)
    planes = dict(scenario=scen, liveness=lqs, growth=grow, stream=strm, control=ctl, pipeline=pipe)

    def run_horizon(st, rounds, ici):
        if local:
            return simulate(st, cfg, rounds, plan, "fused", **planes)
        return dist.simulate_dist(st, cfg, plan, mesh, rounds, transport=transport, collect_ici=ici, **planes)

    def to_target(st):
        return dist.run_until_coverage_dist(st, cfg, plan, mesh, args.target, args.max_rounds, transport=transport,
                                            **planes)

    segment, replay = _ici_runners(args, transport, run_horizon)
    extra = {"devices": n_build, "_wire": plan, **_pipeline_summary(args)}
    if args.rounds <= 0:
        extra["delivery"] = "matching"
    return cfg, state, segment, to_target, extra, replay, n_build


def _pipeline_summary(args: argparse.Namespace) -> dict:
    """The summary's ``pipeline`` field of a --shard run (absent: serial)."""
    return {} if args.pipeline is None else {"pipeline": args.pipeline}


def _compile_cli_pipeline(args: argparse.Namespace):
    """The --pipeline spec, None without the flag."""
    if args.pipeline is None:
        return None
    from tpu_gossip_torch.sim.stages import compile_pipeline

    return compile_pipeline(args.pipeline)


def _add_serve_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("serving", "run_sim serve: the live ingestion frontend (tpu_gossip_torch/serve/)")
    g.add_argument("--port", type=int, default=0, metavar="P",
                   help="listen port (0 = ephemeral; the bound port is announced on stderr)")
    g.add_argument("--serve-host", type=str, default="127.0.0.1", metavar="H", help="listen address")
    g.add_argument("--rounds-per-sec", type=float, default=0.0, metavar="R",
                   help="pace round windows at R/sec (0 = unpaced: as fast as the device steps)")
    g.add_argument("--max-inject", type=int, default=64, metavar="J",
                   help="static per-round injection batch; arrivals past it defer to the next window and are "
                   "counted as overflow — never dropped silently")
    g.add_argument("--trace-out", type=str, default="", metavar="F",
                   help="record every accepted arrival as (round, origin, payload_hash) to this JSONL — the "
                   "bit-exact replay input (serve/trace.py), in the JAX package's format")
    g.add_argument("--replay-check", action="store_true",
                   help="after serving, replay the recorded trace through the pure-sim injection path and fail "
                   "(exit 1) unless state digest + integer-stat trajectory match bit for bit")
    g.add_argument("--serve-target-ratio", type=float, default=0.9, metavar="T",
                   help="delivery-ratio target the reliability report certifies against")


def _validate_serve(args: argparse.Namespace) -> str | None:
    """The reason a serving config cannot run (exit 2, the JAX CLI's
    words), or None; the serving twin of :func:`_validate_stream`. Serving
    runs in one process: ``--coordinator``, ``--num-processes`` and
    ``--process-id`` are ignored, as the JAX CLI's serve ignores them (it
    dispatches before its cluster checks), and so is ``--hosts``."""
    if args.rounds <= 0:
        return ("serve runs a fixed horizon of round windows — pass --rounds R; run-to-coverage has no serving "
                "window to batch arrivals into")
    if not (0 <= args.port <= 65535):
        return f"--port {args.port} outside [0, 65535]"
    if args.rounds_per_sec < 0:
        return f"--rounds-per-sec {args.rounds_per_sec} must be >= 0"
    if args.max_inject < 1:
        return f"--max-inject {args.max_inject} must be >= 1"
    if args.stream <= 0 and args.slot_ttl == 0:
        return ("serve lands live arrivals in the streaming slot plane, which needs its age-out lease configured: "
                "pass --slot-ttl T (and optionally --stream RATE for background synthetic load)")
    if args.stream <= 0:
        # a rate-0 stream: the slot plane's knobs are checked here (the
        # stream's validator refuses a TTL without a rate, but serving is
        # the rate here)
        from tpu_gossip_torch.traffic import min_feasible_ttl

        if not (1 <= args.stream_hashes <= args.slots):
            return (f"--stream-hashes {args.stream_hashes} outside [1, --slots {args.slots}] — the Bloom planes "
                    "live in the slot dimension")
        feasible = min_feasible_ttl(args.peers, args.fanout, args.mode)
        if args.slot_ttl < feasible:
            return (f"--slot-ttl {args.slot_ttl} is below the feasible coverage horizon (~{feasible} rounds for "
                    f"{args.peers} peers at fanout {args.fanout}) — every served message would be recycled before "
                    "it could possibly cover")
    else:
        err = _validate_stream(args)
        if err:
            return err
    if args.scenario:
        return ("serve does not compose with --scenario yet: fault phases would make live delivery attribution "
                "ambiguous (run the fault catalogue through run_sim/fleet instead)")
    if args.grow:
        return "serve does not compose with --grow yet: grown peers have no client-addressable identity to map " \
               "arrivals onto"
    if args.control > 0:
        return ("serve does not compose with --control yet: the controller and the live load would chase each "
                "other's delivery ratio — serve certifies the STATIC protocol")
    if args.remat_every > 0:
        return ("serve cannot compose with --remat-every: the epoch re-partition permutes peers, so the frontend's "
                "client-to-row map would inject at the wrong rows")
    if args.pipeline is not None:
        return ("serve double-buffers the injection window against the in-flight device round itself "
                "(serve/driver.py); --pipeline's exchange overlap does not compose with it")
    if args.profile_round > 0:
        return "--profile-round decomposes the offline round; drop it for serve"
    if args.transport != "dense":
        return (f"--transport {args.transport} is not wired through the serving driver; run the transport A/B "
                "offline")
    if args.checkpoint_every:
        return ("serve does not checkpoint mid-run (the trace IS the recovery artifact: replay it); drop "
                "--checkpoint-every")
    if args.shard and args.graph != "matching":
        return "serve's sharded engine is the matching mesh (dist/matching_mesh.py); add --graph matching or drop " \
               "--shard"
    return None


def _serve_swarm(args: argparse.Namespace, dev):
    """The served swarm, built as the JAX CLI's ``run_sim serve`` builds it:
    the origins and silent peers drawn first from ``default_rng(seed)``,
    then the graph (``--graph pa``/``chung-lu`` on the host from the same
    generator, the matching graph on the device; no staircase plan), or
    with ``--shard`` the sharded matching layout on the mesh. Returns
    ``(cfg, plan, mesh, origin_rows, make_state)``: ``origin_rows`` is the
    id-ordered table of the state rows clients map onto."""
    from tpu_gossip_torch.core import prng, topology
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm

    rng = np.random.default_rng(args.seed)
    origins, silent_ids = _sample_ids(args, rng)
    fanout = None if args.mode == "flood" else args.fanout
    cfg_kw = dict(msg_slots=args.slots, fanout=args.fanout, mode=args.mode, forward_once=args.forward_once,
                  sir_recover_rounds=args.sir_recover, churn_leave_prob=args.churn_leave,
                  churn_join_prob=args.churn_join, rewire_slots=_rewire_slots(args),
                  rewire_compact_cap=args.rewire_compact_cap)
    mesh = plan = exists = None
    if args.graph == "matching" and args.shard:
        from tpu_gossip_torch import dist
        from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded

        mesh = dist.make_mesh(device=dev)
        if 128 % mesh.size:
            raise ValueError(f"serve: mesh size {mesh.size} does not divide 128 (the sharded matching transpose's "
                             "lane split)")
        dgraph, plan = matching_powerlaw_graph_sharded(args.peers, mesh.size, gamma=args.gamma, fanout=fanout,
                                                       key=prng.key(args.seed, dev), device=dev)
        plan = dist.shard_matching_plan(plan, mesh)

        def to_rows(ids):
            ids = np.asarray(ids)
            return (ids // plan.n_per) * plan.n_blk + (ids % plan.n_per)

        cfg = SwarmConfig(n_peers=plan.n, **cfg_kw)
        origin_rows = to_rows(np.arange(args.peers))

        def make_state():
            st = init_swarm(dgraph.as_padded_graph(), cfg, key=prng.key(args.seed, dev), origins=to_rows(origins),
                            exists=dgraph.exists, device=dev)
            st.silent = _set_rows(st.silent, None if silent_ids is None else to_rows(silent_ids))
            return dist.shard_swarm(st, mesh)

        return cfg, plan, mesh, origin_rows, make_state
    if args.graph == "matching":
        from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph

        dgraph, plan = matching_powerlaw_graph(args.peers, gamma=args.gamma, fanout=fanout,
                                               key=prng.key(args.seed, dev), device=dev)
        graph, exists = dgraph.as_padded_graph(), dgraph.exists
    elif args.graph == "pa":
        graph = topology.build_csr(args.peers, topology.preferential_attachment(args.peers, m=args.m, rng=rng))
    else:
        deg = topology.powerlaw_degree_sequence(args.peers, gamma=args.gamma, rng=rng)
        graph = topology.build_csr(args.peers, topology.configuration_model(deg, rng=rng))
    cfg = SwarmConfig(n_peers=graph.n, **cfg_kw)
    origin_rows = np.arange(graph.n) if exists is None else np.flatnonzero(_host_mask(exists))

    def make_state():
        st = init_swarm(graph, cfg, key=prng.key(args.seed, dev), origins=origins, exists=exists, device=dev)
        st.silent = _set_rows(st.silent, silent_ids)
        return st

    return cfg, plan, mesh, origin_rows, make_state


def _main_serve(argv: list[str]) -> int:
    """``run_sim serve``: accept reference-wire clients on a socket and
    disseminate their payloads through the swarm on the card.

    The frontend thread batches arrivals a round window; the driver
    overlaps each window's host work with the card's round and records the
    ``(round, origin, payload_hash)`` trace, whose replay is bit-identical
    to the live run (``--replay-check`` replays it in this process, exit 1
    when it diverges). The announce line ``{"serving": true, ...}`` goes to
    stderr before round 0; the summary carries the JAX CLI's keys: the
    ``serve`` block with the frontend's counters, ``steady_state``,
    ``reliability`` and the digests."""
    from tpu_gossip_torch.core.packed import pack_state, unpack_state
    from tpu_gossip_torch.device import resolve_device
    from tpu_gossip_torch.sim import metrics as M
    from tpu_gossip_torch.traffic.ingest import IngestPlan
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    p = build_parser()
    _add_serve_args(p)
    args, unknown = p.parse_known_args(argv)
    if unknown:
        print(f"{' '.join(unknown)}: {_LATER}", file=sys.stderr)
        return 2
    # the quorum flags settle their defaults as on every run (JAX's serve
    # passes an unset window through to a spec that cannot take it)
    err = _validate_serve(args) or _validate_liveness(args, None)
    if err:
        print(err, file=sys.stderr)
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    try:
        cfg, plan, mesh, origin_rows, make_state = _serve_swarm(args, dev)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.stream > 0:
        strm = _compile_cli_stream(args, origin_rows, dev)
    else:
        # a rate-0 stream: a masked no-op injection whose age-out lease and
        # per-slot tracks are what the live arrivals ride
        from tpu_gossip_torch.traffic import compile_stream

        strm = compile_stream(rate=0.0, msg_slots=args.slots, ttl=args.slot_ttl, origin_rows=np.asarray(origin_rows),
                              k_hashes=args.stream_hashes, device=dev)
    lqs = _compile_cli_liveness(args)

    from tpu_gossip_torch.serve import ServeDriver, ServeFrontend, build_step, replay_trace, stack_round_stats

    ingest_plan = IngestPlan(msg_slots=args.slots, max_inject=args.max_inject, k_hashes=args.stream_hashes)

    def fresh_state():
        st = make_state()
        return pack_state(st) if args.packed else st

    def fresh_step():
        return build_step(cfg, plan, mesh=mesh, tail=args.tail if not args.shard else "fused", stream=strm,
                          liveness=lqs)

    driver_box: dict = {}
    frontend = ServeFrontend(host=args.serve_host, port=args.port, origin_rows=origin_rows,
                             max_inject=args.max_inject,
                             query_snapshot=lambda: driver_box["d"].snapshot() if "d" in driver_box else {})
    try:
        frontend.start()
    except (OSError, TimeoutError) as e:
        print(f"serve: cannot listen on {args.serve_host}:{args.port}: {e}", file=sys.stderr)
        return 2
    try:
        # announce the bound port before the first round, so scripted
        # clients connect while the run is live
        print(json.dumps({"serving": True, "host": args.serve_host, "port": frontend.port, "rounds": args.rounds,
                          "rounds_per_sec": args.rounds_per_sec, "max_inject": args.max_inject}),
              file=sys.stderr, flush=True)
        driver = ServeDriver(fresh_step(), fresh_state(), frontend, ingest_plan, rounds=args.rounds,
                             rounds_per_sec=args.rounds_per_sec, coverage_target=args.target)
        driver_box["d"] = driver
        rep = driver.run()
    finally:
        frontend.stop()

    stats = rep.stats
    live_sd, live_td = state_digest(rep.state), stats_digest(stats)
    if not args.quiet:
        M.write_jsonl(stats, sys.stdout)
    round_seconds = 1.0 / args.rounds_per_sec if args.rounds_per_sec > 0 else cfg.round_seconds
    summary = _horizon_summary(args, stats)
    summary["serve"] = {
        "host": args.serve_host, "port": frontend.port, "rounds_per_sec": args.rounds_per_sec,
        "max_inject": args.max_inject, "wall_seconds": round(rep.wall_seconds, 3),
        "ms_per_round": round(1000.0 * rep.wall_seconds / args.rounds, 3),
        "trace_rounds": rep.trace.num_rounds, "trace_arrivals": rep.trace.total_arrivals,
        **{f"ingest_{k}": int(getattr(stats, f"ingest_{k}").sum()) for k in ("offered", "injected", "conflated",
                                                                              "overflow")},
        "counters": frontend.counters.as_dict(),
    }
    summary["steady_state"] = M.steady_state_report(stats, target=args.target, round_seconds=round_seconds,
                                                    warmup_rounds=min(args.slot_ttl, args.rounds // 2))
    summary["reliability"] = M.reliability_report(stats, target_ratio=args.serve_target_ratio,
                                                  coverage_target=args.target, round_seconds=round_seconds)
    summary["state_digest"] = live_sd
    summary["stats_digest"] = live_td
    if args.trace_out:
        rep.trace.save(args.trace_out)
        summary["serve"]["trace_path"] = args.trace_out
    rc = 0
    if args.replay_check:
        fin2, trail = replay_trace(rep.trace, fresh_step(), fresh_state())
        replay_sd, replay_td = state_digest(fin2), stats_digest(stack_round_stats(trail))
        identical = replay_sd == live_sd and replay_td == live_td
        summary["replay"] = {"state_digest": replay_sd, "stats_digest": replay_td, "bit_identical": identical}
        if not identical:
            print(f"serve: trace replay DIVERGED from the live run (state {live_sd[:12]}../{replay_sd[:12]}.., "
                  f"stats {live_td[:12]}../{replay_td[:12]}..)", file=sys.stderr)
            rc = 1
    print(json.dumps(summary))
    if args.checkpoint:
        from tpu_gossip_torch.core.state import save_swarm

        save_swarm(args.checkpoint, unpack_state(rep.state) if args.packed else rep.state)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
