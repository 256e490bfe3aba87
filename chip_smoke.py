"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 lane shuffle with its two fused
transpose entries, K2 class fold, K3 round tail, K4 packed word tail, K5
staircase segment, K6 streaming segment, and the lane and sublane gathers
of the probes P1-P5) from ``tpu_gossip_torch/csrc`` and the host C++
preferential-attachment library, holds each kernel against its plain
PyTorch version on the card (exact equality; each K1 entry at int8 and
int32 tables, ragged tiles too; K2 one class and a whole class table a
launch, on the 1M plan and crafted tables; K3 at slot widths 1, 3, 7, 16 and 32; K3
and K4 in both SIR-age modes, past ROUND_CAP too), reproduces the
JAX-pinned digests (``tpu_gossip_torch/reference_digests.json``:
seventeen n=20000 runs, packed, sharded and churned included, the 1M
matching headline and the 1M churn headline; the later phases check the
rest), then drives eight paths at 1M peers (push_pull, fanout 1, 16
slots, to 99% coverage), each with its launches counted from zero: the
matching headline (K1, K2, K3), the power-law CSR swarm delivered by the
staircase kernel (K5, K3), the exactly-k XLA delivery on the same graph
(K3), the packed twins of the headline (K1, K2, K4) and of the exactly-k
path (K4 alone), each packed run digest-equal to its unpacked twin, and
the bucketed sharded engine on a one-shard mesh over the same graph: its
receive through K6 (K6, K3), its scatter twin (K3) and its packed twin
(K6, K4), all three digest-equal. Then BASELINE config 5 (Poisson churn
0.002/0.02 with 2 fresh degree-preferential edges a rejoiner) for a fixed
horizon on every path, launches counted from zero: 4i the matching
headline with a 65536-row side-path table (K1, K2, K3 with the churn's
fresh mask), digest-equal to the JAX-pinned 1M churn run; 4j its packed
twin (K4); 4k staircase (K5) and 4l exactly-k on the power-law graph,
dense side paths; 4m the staircase remat loop (72 rounds, a fold every
24, table 49152), each segment's plan built on the host and the card
and held equal, each fold held against a numpy model of the edge
multiset, 0 overflow edges; 4n the sharded K6 path and its scatter twin,
digest-equal; 4o the sharded remat loop (32 rounds, one fold and
re-partition, K6's plans rebuilt and timed). One partner pass of the headline plan
is counted apart: 2K+1 K1 launches and no torch transpose; and one reduce:
one K2 launch, the only kernel the profiler sees. Then it times
each kernel at its path's shapes beside its byte bound, its plain
version and the one torch call that computes the same function, where
there is one, kernel and yardstick in turns, and the whole partner pass
beside the same stages run unfused (K1 and the torch transposes); K2 also
over each block kind of its work table alone. Last come the
probes: both probe kernels held exactly against their plain versions at
every probe shape and ragged ones (P4 against K1 too) and timed (P1-P3
with L2 cold, their operands fitting in L2), the four ported probe
scripts (``tpu_gossip_torch/experiments``) run with their launches
counted, and ``run_sim --profile-round 6`` on the 1M headline, which must
launch K1, K2 and K3. Last, phase 7 drives durable checkpoints and crash
recovery through the CLI, each run its own process, its checkpoints in a
temporary directory: 7a the 1M headline checkpointed every 4 rounds
(``--keep 2``), SIGKILLed once its round-8 checkpoint lands, that
checkpoint's bytes flipped, and ``run_sim resume`` rolling back to round 4
and finishing on the JAX pin; 7b its packed twin, uninterrupted and
resumed from round 8; 7c the 1M churn pin resumed from round 8; 7d the
sharded remat loop (32 rounds, a fold every 16) resumed on its epoch
boundary, the fold and the re-partition with seed 1 replayed, 0 overflow
edges, digest-equal to its uninterrupted run; 7e the n=20000 matching pin
written on the card and resumed on the CPU, and the reverse. It prints the
checkpoints' bytes and files, the seconds a save, the recovery seconds and
the resumed run's peak memory; 7a fails if its resume holds more than its
uninterrupted twin, at the horizon's start or at its peak. Phase 8 drives
silent peers and the fault scenarios through the CLI in this process (8a
config 2 and the n=20000 fault pins, 8b config 2's flags at 1M, 8c the
four catalogued scenarios at 1M with packed twins, 8d the staircase and
sharded paths, 8e a mid-delay checkpoint across card and CPU), and phase
9 the quorum detector and the Byzantine adversaries (9a the quorum pins,
config 2 at quorum 3 and the n=20000 siege on every engine; 9b the
siege on the 1M matching headline at quorum 3 onto the JAX pin, its
packed twin and quorum 1, ms/round over the siege and the aftermath
apart; 9c the siege at 1M on the sharded K6 path, its scatter twin and
the staircase, and a mid-siege checkpoint across card and CPU), each run's
launches counted from zero. Phase 10 drives growth (``growth/``, ``run_sim
--grow``): 10a the eight n=20000 growth pins (JAX CLI) through the CLI on
every engine (matching and its packed twin, PA under config 5's churn,
the staircase remat loop, the bucketed mesh and its packed twin, silent
peers, the flash-crowd scenario's join_burst waves); 10b the 1M matching
headline growing 950000 -> 1000000 at 256 joins a round for 32 rounds onto
its JAX pin, its packed twin digest-equal, the same capacity-padded state
growing and fixed-n side by side (ms/round from CUDA events, peaks, the
draw's chunk) and ``sim.profile --grow`` (the growth stage split into the
Gumbel draw, the top-k and the scatters); 10c ``bench.py::bench_grow``'s
configuration for the first 32 rounds of its 197-round schedule (cut from
the whole schedule to keep the script inside its time), membership at
950000 + 32 x 256 and ``degree_gamma`` within 1e-3 of the host fit; 10d a mid-growth
n=20000 checkpoint killed and resumed on the other device, both ways.
Phase 11 drives the streaming plane (``traffic/``, ``run_sim --stream``):
first ``prng.poisson`` (both branches) and ``lgamma32`` (the integers
1..2^24) against the CPU's bits; 11a the nine n<=20000 stream pins (JAX
CLI) through the CLI on every engine (matching and its packed twin,
Chung-Lu exactly-k with the degree law and two Bloom planes, PA with the
hotspot law, the Chung-Lu staircase with bursts, the bucketed mesh with
K6 and its packed twin, the staircase remat loop under churn, and
flash-crowd-under-fire as its header runs it), each run's leases aging
out through K3 or K4; 11b the 1M matching headline under a stream (rate
4, bursts x4 every 6 rounds, TTL 24, 48 rounds) onto its JAX pin, its
packed twin digest-equal; 11c ``bench.py::bench_stream``'s configuration
at full width (the 1M device power-law graph, 32 slots, fanout 2,
exactly-k push_pull, TTL 25, a batch of 16) at rates 0.5, 1.5 and 4.0,
each 25 warm and 96 measured rounds beside the unloaded run on the same
state (ms/round, the steady-state report, the peak, K3's launches), K3
and K4 against their plain versions under a live age-out mask, and
``sim.profile --stream 4``; 11d a mid-stream n=20000 checkpoint killed
and resumed on the other device, both ways. Phase 12 drives the adaptive
controller (``control/``, ``run_sim --control``): 12a the seven n<=20000
control pins (JAX CLI) through the CLI on every engine (the matching
headline and its packed twin, PA exactly-k with fresh edges and the
PeerSwap refresh, the Chung-Lu staircase under a late loss, whose
effective fanout must visit 5, the bucketed mesh with K6 and its packed
twin, the degraded scenario under a stream), every round's effective
fanout inside the bounds; 12b ``bench.py::bench_control``'s policy on the
1M matching headline (fanout 3, bounds 1..6, 48 rounds) onto its JAX pin,
its packed twin digest-equal, the static run and the zero-adjustment run
(bounds 3,3) on the same state, the zero-adjustment trajectory the static
one's beyond the four control columns, and the message bill of the
controlled and static runs cut at their rounds to 99%; 12c the 1M stream
headline under the controller onto its JAX pin; 12d pin 2 killed after
its round-16 checkpoint and resumed on the other device, both ways; 12e
``sim.profile --control 0.99``. Phase 13 drives pipelined rounds and
fleets (``sim/stages.py::PipelineSpec``, ``fleet/``): 13a the four
pipelined JAX pins of ``reference_pins.json`` (``--shard --staircase
--pipeline 1`` at n=20000, unpacked and packed, plain and under a stream
whose age-out runs inside the horizon), K6 and K3 or K4 once a round, and
``--pipeline 0`` onto the serial sharded pin; 13b ``bench_pipeline``'s
comparison on its own set-up, the 1M sharded matching mesh at one shard
(24 rounds, serial and pipelined in turns: ms/round by CUDA events and
wall, rounds to 99%, peaks, K1, K2 and K3 launches), the pipelined run
onto its JAX pin; 13c
the catalogue campaign's 21 lanes (four processes at once, each running
its lanes through the solo round as the fleet does, while this process
runs the next two checks) onto the JAX pin's
lane digests and family blocks, ``run_sim fleet --lane 5 --solo`` equal to
lane 5, and a 4-lane campaign checkpointed a file a lane, killed after
its round-4 checkpoint and resumed whole and as ``--lane 3 --solo`` on the
other device, both ways; 13d ``bench_fleet``'s configuration at full width
(n=131072, K = 1, 8, 32, the first 5 of its 10 rounds) beside K solo runs
of the same lanes;
13e ``run_sim --profile-round`` with ``--grow``, ``--stream 4`` and
``--control 0.99`` at 1M (the composed rows). Phase 14 drives the sharded
matching engine and its transports (``dist/matching_mesh.py``,
``dist/transport.py``, ``dist/builder.py``): 14a K1 over the mesh's
stacked blocks and K2 over its shard-major class table against their
plain versions at the 1M S = 8 layout, K2's zeros on every shard's pad
rows; 14b ``bench_dist_matching``'s configuration (1M, 16 origins on 16
slots, push_pull fanout 1, to 99%) at S = 1 (14b) and S = 8 (14c), the
local engine on the plan and the mesh under the dense, sparse and auto
transports, all digest-equal, launches counted from 0 a run (K1 7 a
round, lane stages only; K2 and K3 once), the S = 8 dense run's digest
and ICI totals, the sparse replay's digests and totals and auto's totals
onto the JAX pins, the packed twin (the exchange on the words, K4); 14d
``--builder dist`` at 1M S = 8 against the block-keyed build, leaf for
leaf; 14e the eleven
n=20000 sharded matching pins of ``reference_pins.json`` through the CLI
on an 8-shard mesh (dense, sparse, auto packed, the dist builder, churn,
split-brain, the siege at quorum 3, growth, a stream, the controller, a
depth-1 pipeline). Phase 15, serving (``serve/``, ``traffic/ingest.py``,
``run_sim serve``): 15a K3 at ``bench_serve``'s 1,000,001 x 32 and the
headline's x 16 and K4 x 16 against their plain versions; 15b
``bench.py::bench_serve``'s configuration (``device_powerlaw_graph(1M)``,
32 slots, push_pull fanout 2, a rate-0 stream, windows of 1024, 12
unpaced rounds) live under 8 loopback clients x 400 lines, a warm-up,
then unloaded and loaded runs in turns on one state, each trace's rounds
and offered arrivals checked and K3 counted from 0 (one a round), the
loaded run replayed bit for bit on the card and one QUERY answered with a
round, the replay's first rounds under ``torch.profiler``, the ingest
stage at a full window, and every host synchronisation of a served round
(``torch.cuda.set_sync_debug_mode``); 15c a numpy-seeded 1M trace
(``serve/trace.py::scripted_trace``) replayed onto ``reference_pins.json``'s
JAX pin; 15d ``run_sim serve`` on the 1M matching graph, packed and on the
one-card mesh under the same load, each with ``--replay-check``, the live
rounds' launches counted apart from the replay's (K1 7, K2 1, K3 or K4 1
a round). Phase 16, the tpu-sim transport and the socket nodes
(``compat/``, ``cli/run_seed.py``, ``cli/run_peer.py``): 16a K3 against
its plain version at the swarm's 1,000,000 x 64, then the north-star
swarm, 1,000,000 ``PeerNode(transport="tpu-sim")`` registered into one
``SimCluster(msg_slots=64, fanout=3, mode="push", seed=0)`` on the card,
``materialize(m=3)``, three messages (the highest-degree peer, peer 0,
peer n-1), ``step(R)`` to the JAX run's 99% round, 1,000 peers killed and
1,000 silenced, ``step(12)``: both digests of each step, the declared dead
and the three coverages onto ``reference_pins.json``'s ``simnet_1m``, K3
once a round and no other kernel (launches from 0), the registration and
``materialize`` seconds, ms/round by CUDA events, the peak over what was
resident; 16b ``tests/conformance/test_curves.py``'s barrier-stepped socket
curve against three ``SimCluster`` curves on the card over the same fixed
graph, at 40 peers and at 1,000 (the slow test's tolerances; the 1k leg
says it did not run when ``RLIMIT_NOFILE`` cannot be raised to 10,000);
16c two ``run_seed`` and four ``run_peer`` processes on a temporary
``config.txt`` at ``--time-scale 0.01``, two stdin lines in every other
peer's log, ``exit`` to every node, each exiting 0. It prints phase 13's,
14's, 15's and 16's seconds and the script's. Each check of a checkpoint
written on one device and resumed on the other (8e, 9c, 10d, 11d, 12d)
runs its two directions at once, 10c runs the first 32 rounds of
``bench_grow``'s schedule and 13d the first 5 of ``bench_fleet``'s 10, to
keep the script inside its time.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present or any phase fails. Imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from tpu_gossip_torch.utils.profiling import cold_ms, in_turns, time_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
N_HEADLINE = 1_000_000
M_SLOTS = 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def loop_ms(fn, iters: int = 50) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls (CUDA events):
    the larger of its device time and the host's cost to launch it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Exact comparison: raises on any difference, returns 0."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"kernel/plain mismatch in type or shape: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
    if err != 0:
        raise AssertionError(f"kernel disagrees with its plain version: max |diff| = {err}")
    return err


def lane_tables(rows: int, dtype: torch.dtype, gen: torch.Generator, dev) -> torch.Tensor:
    u = torch.rand((rows, 128), generator=gen, device=dev)
    return torch.argsort(u, dim=1).to(dtype)


K1_ENTRIES = ("lane_shuffle", "lane_shuffle_t", "tinv_lane_shuffle")


def check_k1(dev, gen, main_rows: int) -> int:
    """Each K1 entry against its plain version at the 1M plan's rows (int8
    and int32 tables) and at small and ragged (R % 32 != 0) shapes."""
    from tpu_gossip_torch.kernels import permute

    err = 0
    for rows, dt in ((main_rows, torch.int8), (main_rows, torch.int32), (40, torch.int32), (72, torch.int32),
                     (96, torch.int8), (2056, torch.int32), (4128, torch.int8)):
        x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=gen, device=dev, dtype=torch.int32)
        idx = lane_tables(rows, dt, gen, dev)
        for entry in K1_ENTRIES:
            err = max(err, max_err(getattr(permute, entry)(x, idx), getattr(permute, f"{entry}_plain")(x, idx)))
    return err


def check_k2(dev, gen, classes, rows: int) -> int:
    """K2 against its plain version: one position-major class a launch
    (``fold_planes``) at the 1M plan's classes and two small ones, and the
    whole class table a launch (``fold_classes``) on the 1M plan and on the
    crafted tables of ``kernels/fold_cases.py`` (node gaps, hubs, pad_deg 1
    to 5000)."""
    from tpu_gossip_torch.core.matching_topology import class_layout
    from tpu_gossip_torch.kernels.fold_cases import CRAFTED, crafted_classes
    from tpu_gossip_torch.kernels.permute import fold_classes, fold_classes_plain, fold_planes, fold_planes_plain

    slots = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=gen, device=dev, dtype=torch.int32)
    small = torch.randint(0, 2**16, (64, 128), generator=gen, device=dev, dtype=torch.int32)
    cases = [(slots, so, cs, c, pd) for (_, so, c, pd, cs) in classes if c >= 8192]
    cases += [(small, 0, 1024, 1000, 1), (small, 1024, 2048, 2047, 3)]
    tables = [(classes, rows, N_HEADLINE)] + [crafted_classes(name) for name in CRAFTED]
    err = 0
    for op in ("or", "sum"):
        for buf, so, cs, c, pd in cases:
            err = max(err, max_err(fold_planes(buf, so, cs, c, pd, op),
                                   fold_planes_plain(buf, so, cs, c, pd, op)))
        for cls, r, n_out in tables:
            layout = class_layout(cls, r, n_out, dev)
            buf = slots if r == rows else torch.randint(-2**31, 2**31 - 1, (r, 128), generator=gen, device=dev,
                                                        dtype=torch.int32)
            err = max(err, max_err(fold_classes(buf, layout, op), fold_classes_plain(buf, layout, op)))
    return err


def fold_bytes(layout) -> int:
    """Bytes one whole reduce must move: the count * pad_deg slots of each
    class read once (neither a plane's stride padding nor a zero row's
    nothing), every output written once."""
    read = sum(count * pd for (_, _, count, pd, _, _) in layout.table_rows)
    return 4 * (read + layout.n)


def tail_operands(n: int, m: int, gen, dev, rnd: int):
    def b(p):
        return torch.rand((n, m), generator=gen, device=dev) < p

    ir = torch.randint(-1, rnd, (n, m), generator=gen, device=dev, dtype=torch.int16)
    ir = torch.where(b(0.5), ir, torch.full_like(ir, -1))
    return dict(seen=b(0.5), forwarded=b(0.3), infected_round=ir, recovered=b(0.2),
                incoming=b(0.4), receptive=b(0.8), transmit=b(0.5),
                fresh=torch.rand((n,), generator=gen, device=dev) < 0.1,
                expired=torch.rand((m,), generator=gen, device=dev) < 0.3)


def cap_edge_operands(n: int, m: int, gen, dev):
    """Tail operands whose infected_round holds ROUND_CAP, -1 and small
    values: a round past the cap recovers them under the wide SIR age and
    not under the saturated one."""
    ops = tail_operands(n, m, gen, dev, rnd=9)
    vals = torch.tensor([32767, 32766, -1, 0, 1, 5, 8], dtype=torch.int16, device=dev)
    ops["infected_round"] = vals[torch.randint(0, 7, (n, m), generator=gen, device=dev)]
    return ops


TAIL_PLANES = ("seen", "forwarded", "infected_round", "recovered", "incoming", "receptive", "transmit")
FLAG_GRID = [(fo, sir, f, e) for fo in (False, True) for sir in (0, 4) for f in (False, True) for e in (False, True)]


def check_k3(dev, gen, n_main: int) -> int:
    """K3 against its plain version over forward-once, SIR, fresh and
    expired at round 9, and in both SIR-age modes at round 32771, at slot
    widths that put several rows in a 16-element vector (1), vectors
    across row ends (3, 7) and rows of whole vectors (16, 32), N*M mod 16
    left over in each small shape."""
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    err = 0
    for n, m in ((n_main, M_SLOTS), (1001, 7), (4099, 1), (1001, 3), (1001, 32)):
        for rnd_v, ages in ((9, (False,)), (32771, (False, True))):
            ops = tail_operands(n, m, gen, dev, rnd=9) if rnd_v == 9 else cap_edge_operands(n, m, gen, dev)
            rnd = torch.tensor(rnd_v, dtype=torch.int32, device=dev)
            for (fo, sir, use_fresh, use_exp), age_saturated in ((f, a) for f in FLAG_GRID for a in ages):
                args = (*(ops[k] for k in TAIL_PLANES), ops["fresh"] if use_fresh else None, rnd)
                kw = dict(forward_once=fo, sir_recover_rounds=sir, age_saturated=age_saturated,
                          expired=ops["expired"] if use_exp else None)
                for a, p in zip(tail_kernel(*args, **kw), tail_fused(*args, **kw)):
                    err = max(err, max_err(a, p))
    return err


def check_k4(dev, gen, n_main: int) -> int:
    """K4 against the word chain over m = 16, 13, 1 and 17 at the main
    path's row count: forward-once, SIR, fresh and expired present and
    absent, rounds 9 and 32771 in both SIR-age modes. No padding bit may
    be set."""
    from tpu_gossip_torch.core.packed import pack_bits, word_mask
    from tpu_gossip_torch.kernels.round_tail import round_tail_words, tail_words_plain

    err = 0
    for m in (16, 13, 1, 17):
        ops = cap_edge_operands(n_main, m, gen, dev)
        words = [pack_bits(ops[k]) if k != "infected_round" else ops[k] for k in TAIL_PLANES]
        pad = ~word_mask(m, dev)
        for fo, sir, use_fresh, use_exp in FLAG_GRID:
            for rnd_v in (9, 32771):
                rnd = torch.tensor(rnd_v, dtype=torch.int32, device=dev)
                for pallas in (False, True):
                    kw = dict(m=m, forward_once=fo, sir_recover_rounds=sir,
                              expired=ops["expired"] if use_exp else None)
                    fresh = ops["fresh"] if use_fresh else None
                    got = round_tail_words(*words, fresh, rnd, pallas=pallas, **kw)
                    want = tail_words_plain(*words, fresh, rnd, age_saturated=pallas, **kw)
                    for i, (a, p) in enumerate(zip(got, want)):
                        err = max(err, max_err(a, p))
                        if i != 2 and bool((a & pad).any()):
                            raise AssertionError(f"K4 set a padding bit at m={m}")
    return err


def staircase_cases(dev, gen, dgraph):
    """(plan, vals) for every K5 case: the 1M plan; a Chung-Lu CSR at
    rows 128, 512 and 1024; a row spanning several tiles; an edgeless CSR.
    Words are random 32-bit values with bit 31 set in the first slots."""
    import numpy as np

    from tpu_gossip_torch.core import topology as tt
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan, build_staircase_plan_device

    deg = tt.powerlaw_degree_sequence(100_000, rng=np.random.default_rng(1))
    cl = tt.build_csr(100_000, tt.configuration_model(deg, rng=np.random.default_rng(2)))
    hub_deg = np.array([20_000] + [3] * 5000)
    hub_ptr = np.concatenate([[0], np.cumsum(hub_deg)]).astype(np.int32)
    plans = [build_staircase_plan_device(dgraph.row_ptr, dgraph.col_idx, fanout=1)]
    plans += [build_staircase_plan(cl.row_ptr, cl.col_idx, rows=r, device=dev) for r in (128, 512, 1024)]
    plans += [build_staircase_plan(hub_ptr, np.arange(hub_ptr[-1], dtype=np.int32) % 5001, rows=128, device=dev),
              build_staircase_plan(np.zeros(5001, np.int32), np.zeros(0, np.int32), device=dev)]
    for plan in plans:
        vals = torch.randint(-2**31, 2**31 - 1, plan.offs.shape, generator=gen, device=dev, dtype=torch.int32)
        vals[0, :8] = -2**31
        yield plan, vals


def check_k5(dev, gen, dgraph) -> int:
    """K5 against its plain version, billed and unbilled, at word widths
    m = 1, 16 and 32 (the words masked to m bits)."""
    from tpu_gossip_torch.kernels.pallas_segment import staircase_plain, staircase_segment

    err = 0
    for plan, vals in staircase_cases(dev, gen, dgraph):
        bill = torch.randint(0, 40, plan.offs.shape, generator=gen, device=dev, dtype=torch.int32)
        for m in (1, 16, 32):
            v = vals if m == 32 else vals & ((1 << m) - 1)
            for b in (None, bill):
                args = (plan.tile_block, plan.offs, v, plan.rows, plan.n_blocks, b)
                got, want = staircase_segment(*args), staircase_plain(*args)
                err = max(err, max_err(got[0], want[0]))
                if b is not None:
                    err = max(err, max_err(got[1], want[1]))
    return err


def shard_setup(dev, n: int) -> dict:
    """The sharded path's set-up as ``run_sim --shard --staircase`` makes
    it: the 4b graph built on the card and exported to the host, then
    ``partition_graph`` over a one-shard mesh and ``build_shard_plans``,
    each timed."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph

    t0 = time.perf_counter()
    graph = device_powerlaw_graph(n, gamma=2.5, key=prng.key(0, dev), device=dev).to_host_graph()
    t1 = time.perf_counter()
    mesh = dist.make_mesh(device=dev)
    sg, rel, pos = dist.partition_graph(graph, mesh.size, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    plan = dist.build_shard_plans(sg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    valid = int(sg.send_valid.sum())
    return dict(mesh=mesh, sg=sg, rel=rel, pos=pos, plan=plan,
                info=dict(graph_s=t1 - t0, partition_s=t2 - t1, plan_s=t3 - t2, shards=mesh.size,
                          valid_slots=valid, bucket=sg.bucket, windows=sg.n_shards * sg.bucket // 1024,
                          n_tiles=plan.n_tiles, n_blocks=plan.n_blocks, n_pad=sg.n_pad))


def stream_cases(dev, setup: dict):
    """(plan, length) of every K6 case: the 4f plan; each of the eight
    shards of a Chung-Lu 100k graph's S = 8 plans; an edgeless plan."""
    import numpy as np

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import topology as tt

    yield setup["plan"], 0, setup["sg"].n_shards * setup["sg"].bucket
    deg = tt.powerlaw_degree_sequence(100_000, rng=np.random.default_rng(3))
    cl = tt.build_csr(100_000, tt.configuration_model(deg, rng=np.random.default_rng(4)))
    sg8, _, _ = dist.partition_graph(cl, 8, seed=1, device=dev)
    plan8 = dist.build_shard_plans(sg8)
    for d in range(8):
        yield plan8, d, 8 * sg8.bucket
    sg0, _, _ = dist.partition_graph(tt.build_csr(5000, np.zeros((0, 2), np.int64)), 2, device=dev)
    yield dist.build_shard_plans(sg0, rows=128), 1, 2 * sg0.bucket


def check_k6(dev, gen, setup: dict) -> int:
    """K6 against its plain version at word widths m = 1, 16 and 32, words
    random with bit 31 set in the first slots."""
    from tpu_gossip_torch.kernels.pallas_segment import stream_segment_or, stream_segment_plain

    err = 0
    for plan, d, length in stream_cases(dev, setup):
        vals = torch.randint(-2**31, 2**31 - 1, (length,), generator=gen, device=dev, dtype=torch.int32)
        vals[:8] = -2**31
        for m in (1, 16, 32):
            v = vals if m == 32 else vals & ((1 << m) - 1)
            args = (plan.tile_block[d], plan.window_idx[d], plan.offs[d], v, plan.rows, plan.n_blocks)
            err = max(err, max_err(stream_segment_or(*args), stream_segment_plain(*args)))
    return err


def control_pin(ref: dict) -> bool:
    """A pin of the adaptive controller (``--control``): phase 12's."""
    return "--control" in ref["argv"]


def stream_pin(ref: dict) -> bool:
    """A pin of the streaming plane (``--stream``, no controller): phase 11's."""
    return "--stream" in ref["argv"] and not control_pin(ref)


def growth_pin(ref: dict) -> bool:
    """A pin of the growth plane (``--grow``, no stream, no controller):
    phase 10's."""
    return "--grow" in ref["argv"] and not stream_pin(ref) and not control_pin(ref)


def quorum_pin(ref: dict) -> bool:
    """A pin of the quorum detector (``--quorum-k``): phase 9's."""
    return "--quorum-k" in ref["argv"] and not growth_pin(ref) and not stream_pin(ref) and not control_pin(ref)


def fault_pin(ref: dict) -> bool:
    """A pin of the fault plane (silent peers or a scenario) without the
    quorum detector, growth, a stream or the controller: phase 8's."""
    return ("--scenario" in ref["argv"] or "--silent-frac" in ref["argv"]) and not quorum_pin(ref) and (
        not growth_pin(ref)) and not stream_pin(ref) and not control_pin(ref)


def phase_digest(root: Path, dev) -> list[dict]:
    """The port's CLI at every JAX-pinned configuration of the earlier
    slices (the n=20000 runs and the 1M headlines)."""
    from tpu_gossip_torch.cli import run_sim

    out = []
    for ref in json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text()):
        if fault_pin(ref) or quorum_pin(ref) or growth_pin(ref) or stream_pin(ref) or control_pin(ref):
            continue  # phase 8's, 9's, 10's, 11's and 12's
        args, unknown = run_sim.build_parser().parse_known_args(ref["argv"] + ["--device", str(dev)])
        if unknown:
            raise AssertionError(f"reference argv not understood: {unknown}")
        got = run_sim.run(args)
        for k in ref["summary"]:
            if got[k] != ref["summary"][k]:
                raise AssertionError(f"{ref['source']}: {k} {got[k]} != JAX reference {ref['summary'][k]}")
        out.append(got)
    return out


def phase_headline(dev, n: int):
    """Build the headline plan and run it to 99% coverage; returns the
    graph, the plan and the run's figures."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dgraph, plan = matching_powerlaw_graph(n, fanout=1, key=prng.key(0, dev), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    return dgraph, plan, dict(build_s=build_s, **run_to_coverage(dev, dgraph, n, plan, "headline"))


def run_to_coverage(dev, dgraph, n: int, plan, what: str, packed: bool = False) -> dict:
    """Seed one origin (``default_rng(0)``, as the CLI draws it), run
    push_pull fanout 1 over ``plan`` to 99% coverage (on the packed state
    when ``packed``) and check the final state; returns rounds, coverage,
    seconds, the peak of allocated device memory during the run alone
    (``run_peak``) and since the caller's last reset (``peak``), and the
    unpacked final state's digest."""
    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.packed import PackedSwarm, pack_state, unpack_state
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim.engine import run_until_coverage
    from tpu_gossip_torch.utils.digest import state_digest

    graph = dgraph.as_padded_graph()
    cfg = SwarmConfig(n_peers=graph.n, msg_slots=M_SLOTS, fanout=1, mode="push_pull")
    origins = np.random.default_rng(0).choice(n, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=dgraph.exists, device=dev)
    if packed:
        state = pack_state(state)
    torch.cuda.synchronize()
    prior_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fin = run_until_coverage(state, cfg, 0.99, 1000, plan=plan)
    cov = float(fin.coverage(0))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated(dev)
    if isinstance(fin, PackedSwarm) != packed:
        raise AssertionError(f"{what} run returned a {type(fin).__name__}")
    if packed:
        fin = unpack_state(fin)
    rounds = int(fin.round)
    if not (0.99 <= cov <= 1.0) or not 0 < rounds < 1000:
        raise AssertionError(f"{what} run ended at coverage {cov} after {rounds} rounds")
    live = fin.alive & ~fin.declared_dead
    if int((fin.seen[:, 0] & live).sum()) < 0.99 * int(live.sum()):
        raise AssertionError(f"{what} final state holds fewer infected peers than its coverage")
    if bool((fin.infected_round[:, 0] >= 0).ne(fin.seen[:, 0]).any()):
        raise AssertionError(f"{what} infected_round latch disagrees with seen")
    return dict(rounds=rounds, coverage=cov, run_s=run_s, run_peak=run_peak, peak=max(prior_peak, run_peak),
                digest=state_digest(fin))


def run_sharded(dev, setup: dict, plan, what: str, packed: bool = False) -> dict:
    """``init_sharded_swarm`` with one origin (``default_rng(0)``, as the
    CLI draws it), push_pull fanout 1 to 99% by ``run_until_coverage_dist``
    over the one-shard mesh, through K6 with ``plan`` and the scatter
    receive without (on the packed state when ``packed``), then the checks
    of :func:`run_to_coverage`."""
    import numpy as np

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.packed import PackedSwarm, pack_state, unpack_state
    from tpu_gossip_torch.core.state import SwarmConfig
    from tpu_gossip_torch.utils.digest import state_digest

    sg, mesh = setup["sg"], setup["mesh"]
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=M_SLOTS, fanout=1, mode="push_pull")
    origins = np.random.default_rng(0).choice(sg.n, size=1, replace=False)
    state = dist.shard_swarm(dist.init_sharded_swarm(sg, setup["rel"], setup["pos"], cfg, key=prng.key(0, dev),
                                                     origins=origins, device=dev), mesh)
    if packed:
        state = pack_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fin = dist.run_until_coverage_dist(state, cfg, sg, mesh, 0.99, 1000, shard_plan=plan)
    cov = float(fin.coverage(0))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated(dev)
    if isinstance(fin, PackedSwarm) != packed:
        raise AssertionError(f"{what} run returned a {type(fin).__name__}")
    if packed:
        fin = unpack_state(fin)
    rounds = int(fin.round)
    if not (0.99 <= cov <= 1.0) or not 0 < rounds < 1000:
        raise AssertionError(f"{what} run ended at coverage {cov} after {rounds} rounds")
    live = fin.alive & ~fin.declared_dead
    if int((fin.seen[:, 0] & live).sum()) < 0.99 * int(live.sum()):
        raise AssertionError(f"{what} final state holds fewer infected peers than its coverage")
    if bool((fin.infected_round[:, 0] >= 0).ne(fin.seen[:, 0]).any()):
        raise AssertionError(f"{what} infected_round latch disagrees with seen")
    if bool(fin.seen[sg.n:].any()) or int(live[sg.n:].sum()) != 0:
        raise AssertionError(f"{what} run reached a pad slot")
    return dict(rounds=rounds, coverage=cov, run_s=run_s, run_peak=run_peak, digest=state_digest(fin))


# BASELINE config 5 at the JAX bench's widths (bench.py, "churn_rewire_1m_*")
CHURN = dict(churn_leave_prob=0.002, churn_join_prob=0.02, rewire_slots=2)
CHURN_ROUNDS = 16
REMAT_EVERY, REMAT_CAP, REMAT_ROUNDS = 24, 49152, 72
SHARD_REMAT_EVERY, SHARD_REMAT_ROUNDS = 16, 32


def churn_cfg(n_peers: int, cap: int = 0):
    from tpu_gossip_torch.core.state import SwarmConfig

    return SwarmConfig(n_peers=n_peers, msg_slots=M_SLOTS, fanout=1, mode="push_pull", rewire_compact_cap=cap,
                       **CHURN)


def check_churned(fin, what: str, n_real: int) -> None:
    """A churned final state: the infection latch agrees with seen, no
    rejoined row holds a stale slot, fresh targets are member rows or -1,
    and no pad slot joined."""
    live = fin.alive & ~fin.declared_dead
    if bool((fin.infected_round[:, 0] >= 0).ne(fin.seen[:, 0]).any()):
        raise AssertionError(f"{what} infected_round latch disagrees with seen")
    if bool((fin.alive & ~fin.exists).any()):
        raise AssertionError(f"{what} run brought a non-member slot alive")
    tg = fin.rewire_targets[fin.rewired]
    if bool(((tg < -1) | (tg >= fin.exists.shape[0])).any()) or bool((~fin.exists[tg[tg >= 0].long()]).any()):
        raise AssertionError(f"{what} run holds a fresh target that is no member row")
    if int(live[n_real:].sum()) != 0:
        raise AssertionError(f"{what} run reached a pad slot")


def run_churn(dev, what: str, step, state, rounds: int, n_real: int, packed: bool = False) -> dict:
    """``step(state, rounds) -> (state, stats)`` from ``state`` (packed
    first when ``packed``), timed, its peak taken alone; the final
    (unpacked) state checked. Returns rounds, digests, seconds, run peak,
    coverage and the rewired count."""
    from tpu_gossip_torch.core.packed import PackedSwarm, pack_state, unpack_state
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    if packed:
        state = pack_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fin, stats = step(state, rounds)
    cov = stats.coverage.cpu()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated(dev)
    if isinstance(fin, PackedSwarm) != packed:
        raise AssertionError(f"{what} run returned a {type(fin).__name__}")
    if packed:
        fin = unpack_state(fin)
    if int(fin.round) != rounds or not bool(torch.isfinite(cov).all()) or not 0.9 <= float(cov[-1]) <= 1.0:
        raise AssertionError(f"{what} run ended at round {int(fin.round)} with coverage {cov.tolist()}")
    check_churned(fin, what, n_real)
    return dict(rounds=rounds, digest=state_digest(fin), stats_digest=stats_digest(stats), run_s=run_s,
                run_peak=run_peak, coverage=float(cov[-1]), rewired=int(fin.rewired.sum()),
                total_msgs=int(stats.msgs_sent.sum()), fin=fin)


def churn_line(card: str, what: str, r: dict, launches: dict, extra: str = "") -> str:
    # a remat loop's ms/round is its rounds' alone; amortized adds what the
    # CLI's loop pays an epoch (host plan build, fold, re-partition, K6 plans)
    ms = (f"{r['round_ms']} ms/round (amortized over the epochs' rebuilds {r['amortized_ms']})"
          if "round_ms" in r else f"{r['run_s'] * 1e3 / r['rounds']} ms/round")
    return (f"[{card}] {what} n={N_HEADLINE} m={M_SLOTS} push_pull fanout 1, churn leave 0.002 join 0.02 rewire 2"
            f"{extra}: {r['rounds']} rounds, final coverage {r['coverage']}, rewired rows {r['rewired']}, "
            f"{ms}, run max_memory_allocated {r['run_peak']} B, "
            f"final state_digest {r['digest']} stats_digest {r['stats_digest']}; launches {launches}")


def fold_model(st, cap: int):
    """The fold ``rematerialize_rewired`` must make, in numpy: the kept
    edges (both endpoints members and not rewired) plus each rejoiner's
    valid fresh targets, both ways, as sorted (src, dst) pairs."""
    import numpy as np

    row_ptr, col = st.row_ptr.cpu().numpy().astype(np.int64), st.col_idx.cpu().numpy().astype(np.int64)
    exists, rewired = st.exists.cpu().numpy(), st.rewired.cpu().numpy()
    e = int(row_ptr[-1])
    src = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    dst = col[:e]
    keep = exists[src] & exists[dst] & ~rewired[src] & ~rewired[dst]
    tg = st.rewire_targets.cpu().numpy().astype(np.int64)
    r = np.repeat(np.arange(tg.shape[0]), tg.shape[1])
    t = tg.reshape(-1)
    fv = rewired[r] & (t >= 0) & (t != r)
    pairs = np.concatenate([np.stack([src[keep], dst[keep]], 1), np.stack([r[fv], t[fv]], 1),
                            np.stack([t[fv], r[fv]], 1)])
    if len(pairs) > cap:
        raise AssertionError(f"the fold model holds {len(pairs)} edges, past the capacity {cap}")
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def check_fold(before, after, cap: int) -> None:
    """The folded CSR against :func:`fold_model`: the same edge multiset,
    row-major, ``col_idx`` at capacity with a self-loop tail."""
    import numpy as np

    want = fold_model(before, cap)
    row_ptr = after.row_ptr.cpu().numpy().astype(np.int64)
    col = after.col_idx.cpu().numpy().astype(np.int64)
    e = int(row_ptr[-1])
    src = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    got = np.stack([src, col[:e]], 1)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    if col.shape[0] != cap or not np.array_equal(got, want):
        raise AssertionError(f"the folded CSR ({e} edges, capacity {col.shape[0]}) is not the model's "
                             f"({len(want)} edges, capacity {cap})")
    if e < cap and not bool((col[e:] == col[e]).all()):
        raise AssertionError("the folded CSR's tail past row_ptr[-1] is not one row's self-loops")
    if bool(after.rewired.any()) or bool((after.rewire_targets != -1).any()) or bool(after.degree_credit.any()):
        raise AssertionError("the fold left rewired rows, fresh targets or credit behind")


def plans_equal(plan, dplan) -> int:
    """The host-built and card-built staircase plans: equal routing tables
    and thresholds within 2^-22 relative + 1 (the card's float32
    thresholds are within 2^-24 relative of the host's float64 ones before
    the ceil, which may then differ by one); returns the largest threshold
    difference."""
    for name in ("n", "n_tiles", "n_blocks", "rows"):
        if getattr(plan, name) != getattr(dplan, name):
            raise AssertionError(f"device plan {name} {getattr(dplan, name)} != host {getattr(plan, name)}")
    for name in ("tile_block", "offs", "col_gather"):
        if not torch.equal(getattr(plan, name), getattr(dplan, name)):
            raise AssertionError(f"device plan routing table {name} differs from the host build")
    thr_err = 0
    for t in ("push_thresh", "pull_thresh"):
        diff = (getattr(plan, t) - getattr(dplan, t)).abs()
        if bool((diff > 1 + getattr(plan, t) * 2.0**-22).any()):
            raise AssertionError(f"device plan {t} off the host's by more than 2^-22 relative + 1")
        thr_err = max(thr_err, int(diff.max()))
    return thr_err


def run_remat(dev, dgraph, what: str) -> dict:
    """4m: the staircase remat loop at the JAX bench's operating point
    (``run_sim --remat-every 24 --rewire-compact-cap 49152``): each
    segment's plan built on the host and on the card, held equal; each
    fold checked against the numpy model."""
    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import init_swarm
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan, build_staircase_plan_device
    from tpu_gossip_torch.sim.engine import _concat, remat_capacity, rematerialize_rewired, simulate

    graph = dgraph.as_padded_graph()
    cfg = churn_cfg(graph.n, REMAT_CAP)
    origins = np.random.default_rng(0).choice(N_HEADLINE, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=dgraph.exists, device=dev)
    cap = remat_capacity(state, cfg)
    info = dict(capacity=cap, plan_host_s=[], plan_device_s=[], fold_s=[], rounds_s=0.0, thresh_max_abs_diff=0,
                overflow=0)

    def step(st, rounds):
        parts = []
        while int(st.round) < rounds:
            plan = timed(info["plan_host_s"], lambda: build_staircase_plan(st.row_ptr, st.col_idx, fanout=1,
                                                                           device=dev))
            dplan = timed(info["plan_device_s"], lambda: build_staircase_plan_device(st.row_ptr, st.col_idx,
                                                                                     fanout=1))
            info["thresh_max_abs_diff"] = max(info["thresh_max_abs_diff"], plans_equal(plan, dplan))
            del dplan
            seg = []
            st, stats = timed(seg, lambda: simulate(st, cfg, min(REMAT_EVERY, rounds - int(st.round)), plan))
            info["rounds_s"] += seg[0]
            parts.append(stats)
            if int(st.round) < rounds:
                folded, over = timed(info["fold_s"], lambda: rematerialize_rewired(st, cfg, cap))
                info["overflow"] += int(over)
                check_fold(st, folded, cap)
                st = folded
        return st, _concat(parts)

    r = run_churn(dev, what, step, state, REMAT_ROUNDS, N_HEADLINE)
    if info["overflow"] != 0 or len(info["fold_s"]) != 2:
        raise AssertionError(f"{what}: {len(info['fold_s'])} folds, {info['overflow']} overflow edges")
    # what the CLI's loop pays: the rounds, a host plan build a segment and the folds
    epoch_s = sum(info["plan_host_s"]) + sum(info["fold_s"])
    return dict(r, info=info, round_ms=info["rounds_s"] * 1e3 / REMAT_ROUNDS,
                amortized_ms=(info["rounds_s"] + epoch_s) * 1e3 / REMAT_ROUNDS)


def timed(acc: list, fn):
    """``fn()`` between two synchronisations, its seconds appended to ``acc``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    acc.append(time.perf_counter() - t0)
    return out


def run_shard_churn(dev, setup: dict, plan, what: str) -> dict:
    """4n: the sharded churn path on 4f's one-shard set-up, dense side
    paths, through K6 with ``plan`` and the scatter receive without."""
    import numpy as np

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng

    sg, mesh = setup["sg"], setup["mesh"]
    cfg = churn_cfg(sg.n_pad)
    origins = np.random.default_rng(0).choice(sg.n, size=1, replace=False)
    state = dist.shard_swarm(dist.init_sharded_swarm(sg, setup["rel"], setup["pos"], cfg, key=prng.key(0, dev),
                                                     origins=origins, device=dev), mesh)
    return run_churn(dev, what, lambda st, k: dist.simulate_dist(st, cfg, sg, mesh, k, plan), state, CHURN_ROUNDS,
                     sg.n)


def run_shard_remat(dev, setup: dict, what: str) -> dict:
    """4o: ``run_sim --shard --staircase --remat-every 16`` for 32 rounds:
    one fold, one re-partition (seed 1), the state re-sharded and K6's
    plans rebuilt (timed); the fold checked against the numpy model."""
    import numpy as np

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.sim.engine import _concat, remat_capacity, rematerialize_rewired

    sg, mesh = setup["sg"], setup["mesh"]
    cfg = churn_cfg(sg.n_pad)
    origins = np.random.default_rng(0).choice(sg.n, size=1, replace=False)
    state = dist.shard_swarm(dist.init_sharded_swarm(sg, setup["rel"], setup["pos"], cfg, key=prng.key(0, dev),
                                                     origins=origins, device=dev), mesh)
    info = dict(overflow=0, rounds_s=[], fold_s=[], repartition_s=[], plan_s=[])
    epoch = dict(sg=sg, plan=setup["plan"])

    def step(st, rounds):
        parts = []
        while int(st.round) < rounds:
            st, stats = timed(info["rounds_s"], lambda: dist.simulate_dist(st, cfg, epoch["sg"], mesh,
                                                                           SHARD_REMAT_EVERY, epoch["plan"]))
            parts.append(stats)
            if int(st.round) < rounds:
                cap = remat_capacity(st, cfg)
                folded, over = timed(info["fold_s"], lambda: rematerialize_rewired(st, cfg, cap))
                check_fold(st, folded, cap)

                def repartition():
                    sg_new, moved, _ = dist.repartition_swarm(folded, mesh.size, seed=1)
                    return sg_new, dist.shard_swarm(moved, mesh)

                epoch["sg"], st = timed(info["repartition_s"], repartition)
                epoch["plan"] = timed(info["plan_s"], lambda: dist.build_shard_plans(epoch["sg"]))
                info.update(bucket=epoch["sg"].bucket, n_tiles=epoch["plan"].n_tiles)
                info["overflow"] += int(over)
        return st, _concat(parts)

    r = run_churn(dev, what, step, state, SHARD_REMAT_ROUNDS, sg.n)
    if info["overflow"] != 0 or len(info["plan_s"]) != 1:
        raise AssertionError(f"{what}: overflow {info['overflow']}, {len(info['plan_s'])} re-partitions")
    rounds_s = sum(info["rounds_s"])
    epoch_s = sum(info["fold_s"]) + sum(info["repartition_s"]) + sum(info["plan_s"])
    return dict(r, info=info, round_ms=rounds_s * 1e3 / SHARD_REMAT_ROUNDS,
                amortized_ms=(rounds_s + epoch_s) * 1e3 / SHARD_REMAT_ROUNDS)


def phase_churn(dev, card: str, hgraph, plan, dgraph, splan, shard: dict, pin: dict) -> dict:
    """Phases 4i-4o: BASELINE config 5 at 1M on every delivery path, each
    run's launches counted from 0; returns the launches by phase."""
    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import init_swarm
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim.engine import simulate

    out = {}

    def local(graph_, cfg, pl, what, packed=False):
        g = graph_.as_padded_graph()
        origins = np.random.default_rng(0).choice(N_HEADLINE, size=1, replace=False)
        st = init_swarm(g, cfg, key=prng.key(0, dev), origins=origins, exists=graph_.exists, device=dev)
        native.reset_launches()
        r = run_churn(dev, what, lambda s, k: simulate(s, cfg, k, pl), st, CHURN_ROUNDS, N_HEADLINE, packed)
        out[what] = dict(native.LAUNCHES)
        return r

    # 4i: the matching headline under churn, compact side paths (cap 65536);
    # its digests are the JAX-pinned 1M churn entry's
    m_cfg = churn_cfg(hgraph.as_padded_graph().n, 65536)
    r_i = local(hgraph, m_cfg, plan, "4i churn matching")
    check_launches("4i churn matching", out["4i churn matching"], CHURN_MATCHING_PATH, CHURN_ROUNDS)
    for k, v in (("state_digest", r_i["digest"]), ("stats_digest", r_i["stats_digest"]),
                 ("total_msgs", r_i["total_msgs"])):
        if v != pin[k]:
            raise AssertionError(f"4i churn matching {k} {v} != the JAX pin's {pin[k]} ({pin['source']})")
    print(churn_line(card, "4i churn matching", r_i, out["4i churn matching"], ", compact cap 65536")
          + "; digests equal the JAX pin", flush=True)
    # 4j: its packed twin
    r_j = local(hgraph, m_cfg, plan, "4j churn matching packed", packed=True)
    check_launches("4j churn matching packed", out["4j churn matching packed"], CHURN_PACKED_MATCHING_PATH,
                   CHURN_ROUNDS)
    if (r_j["digest"], r_j["stats_digest"]) != (r_i["digest"], r_i["stats_digest"]):
        raise AssertionError("4j packed churn run's digests differ from 4i's")
    print(churn_line(card, "4j churn matching packed", r_j, out["4j churn matching packed"], ", compact cap 65536")
          + "; digest-equal to 4i", flush=True)
    del r_i["fin"], r_j["fin"]
    # 4k and 4l: staircase (K5) and exactly-k churn on 4b's graph, dense side paths
    c_cfg = churn_cfg(dgraph.as_padded_graph().n)
    for what, pl, want in (("4k churn staircase", splan, CHURN_STAIRCASE_PATH),
                           ("4l churn exactly-k", None, CHURN_XLA_PATH)):
        r = local(dgraph, c_cfg, pl, what)
        check_launches(what, out[what], want, CHURN_ROUNDS)
        print(churn_line(card, what, r, out[what], ", dense side paths"), flush=True)
        del r["fin"]
    # 4m: the staircase remat loop
    native.reset_launches()
    r_m = run_remat(dev, dgraph, "4m churn staircase remat")
    out["4m churn staircase remat"] = dict(native.LAUNCHES)
    check_launches("4m churn staircase remat", out["4m churn staircase remat"], CHURN_STAIRCASE_PATH,
                   REMAT_ROUNDS)
    print(churn_line(card, "4m churn staircase remat", r_m, out["4m churn staircase remat"],
                     f", remat every {REMAT_EVERY}, compact cap {REMAT_CAP}")
          + f"; remats 2, remat_overflow_edges {r_m['info']['overflow']}, {r_m['info']}", flush=True)
    del r_m["fin"]
    # 4n: the sharded churn path (K6) and its scatter twin
    r_n = {}
    for what, pl, want in (("4n churn sharded staircase", shard["plan"], CHURN_SHARD_PATH),
                           ("4n churn sharded scatter", None, CHURN_XLA_PATH)):
        native.reset_launches()
        r_n[what] = run_shard_churn(dev, shard, pl, what)
        out[what] = dict(native.LAUNCHES)
        check_launches(what, out[what], want, CHURN_ROUNDS)
        print(churn_line(card, what, r_n[what], out[what], ", dense side paths, one-shard mesh"), flush=True)
        del r_n[what]["fin"]
    a, b = r_n.values()
    if (a["digest"], a["stats_digest"]) != (b["digest"], b["stats_digest"]):
        raise AssertionError("4n scatter twin's digests differ from the K6 run's")
    # 4o: the sharded remat loop
    native.reset_launches()
    r_o = run_shard_remat(dev, shard, "4o churn sharded remat")
    out["4o churn sharded remat"] = dict(native.LAUNCHES)
    check_launches("4o churn sharded remat", out["4o churn sharded remat"], CHURN_SHARD_PATH, SHARD_REMAT_ROUNDS)
    print(churn_line(card, "4o churn sharded remat", r_o, out["4o churn sharded remat"],
                     f", remat every {SHARD_REMAT_EVERY}, one-shard mesh")
          + f"; remats 1, remat_overflow_edges {r_o['info']['overflow']}, {r_o['info']}", flush=True)
    return out


def phase_staircase(dev, n: int):
    """The slice's path: the power-law swarm built on the card, its
    staircase plan built on the host as the CLI builds it (and on the card,
    held equal), run to 99% through K5."""
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan, build_staircase_plan_device

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    dgraph, graph_s = timed(lambda: device_powerlaw_graph(n, gamma=2.5, key=prng.key(0, dev), device=dev))
    plan, host_s = timed(lambda: build_staircase_plan(dgraph.row_ptr, dgraph.col_idx, fanout=1, device=dev))
    dplan, device_s = timed(lambda: build_staircase_plan_device(dgraph.row_ptr, dgraph.col_idx, fanout=1))
    thr_err = plans_equal(plan, dplan)
    deg = dgraph.degrees
    info = dict(graph_s=graph_s, host_plan_s=host_s, device_plan_s=device_s, thresh_max_abs_diff=thr_err,
                n_tiles=plan.n_tiles, n_blocks=plan.n_blocks, sentinel_slots=int(deg[-1]),
                csr_slots=int(dgraph.col_idx.shape[0]))
    return dgraph, plan, info


def time_k5(plan, dev, gen) -> dict:
    """K5 billed at the 1M plan (dense 16-bit words, every slot firing: the
    most atomics a round can give), its plain version, and the torch
    yardstick: ``scatter_reduce_`` amax over pre-unpacked (slots, 16) uint8
    bit planes plus ``index_add_`` of the bill."""
    from tpu_gossip_torch.kernels.pallas_segment import TILE, staircase_plain, staircase_segment

    vals = torch.randint(0, 1 << M_SLOTS, plan.offs.shape, generator=gen, device=dev, dtype=torch.int32)
    bill = torch.randint(0, 3, plan.offs.shape, generator=gen, device=dev, dtype=torch.int32)
    args = (plan.tile_block, plan.offs, vals, plan.rows, plan.n_blocks, bill)
    o = plan.offs.reshape(-1).to(torch.int64)
    keep = o >= 0
    dest = (torch.repeat_interleave(plan.tile_block.to(torch.int64) * plan.rows, TILE) + o)[keep]
    shifts = torch.arange(M_SLOTS, dtype=torch.int32, device=dev)
    planes = ((vals.reshape(-1)[keep][:, None] >> shifts) & 1).to(torch.uint8)
    bill_kept = bill.reshape(-1)[keep]
    size = plan.n_blocks * plan.rows
    idx = dest[:, None].expand(-1, M_SLOTS)

    def library():
        words = torch.zeros((size, M_SLOTS), dtype=torch.uint8, device=dev).scatter_reduce_(0, idx, planes, "amax")
        return words, torch.zeros((size,), dtype=torch.int32, device=dev).index_add_(0, dest, bill_kept)

    slots = plan.n_tiles * TILE
    return dict(ms=time_ms(lambda: staircase_segment(*args)), plain_ms=time_ms(lambda: staircase_plain(*args), 10),
                library_ms=time_ms(library, 10), bytes=slots * 12 + size * 8)


def time_k6(setup: dict, dev, gen) -> dict:
    """K6's launch at the 4f plan over dense 16-bit words (its wrapper
    checks the windows first, a read back from the card: timed apart), its
    plain version, and the torch yardstick: ``scatter_reduce_`` amax of pre-unpacked (entries,
    16) uint8 bit planes into the destination rows (the JAX scatter
    receive). Bytes: each tile's offs (4 B a slot), each distinct window of
    the stream the plan reads once (4 B a word; a window two blocks share
    and the padding tiles' window count once), each output row (4 B)."""
    from tpu_gossip_torch.kernels.pallas_segment import TILE, _stream_launch, stream_segment_or, stream_segment_plain

    sg, plan = setup["sg"], setup["plan"]
    vals = torch.randint(0, 1 << M_SLOTS, (sg.n_shards * sg.bucket,), generator=gen, device=dev, dtype=torch.int32)
    args = (plan.tile_block[0], plan.window_idx[0], plan.offs[0], vals, plan.rows, plan.n_blocks)
    shifts = torch.arange(M_SLOTS, dtype=torch.int32, device=dev)
    planes = ((vals[:, None] >> shifts) & 1).to(torch.uint8)
    idx = sg.recv_dst[0].reshape(-1).to(torch.int64)[:, None].expand(-1, M_SLOTS)

    def library():
        return torch.zeros((sg.per_shard, M_SLOTS), dtype=torch.uint8, device=dev).scatter_reduce_(
            0, idx, planes, "amax")

    windows = int(torch.unique(plan.window_idx[0]).numel())
    return dict(ms=time_ms(lambda: _stream_launch(*args)), plain_ms=time_ms(lambda: stream_segment_plain(*args), 10),
                wrapper_ms=loop_ms(lambda: stream_segment_or(*args)), library_ms=time_ms(library, 10),
                windows_read=windows,
                bytes=(plan.n_tiles + windows) * TILE * 4 + plan.n_blocks * plan.rows * 4)


def partner_pass_counts(plan, dev) -> dict:
    """One ``plan.partner`` pass with its K1 launches (in all and by entry)
    and the torch transposes it runs counted; fails unless a K-stage plan
    makes 2K+1 launches and no transpose."""
    from tpu_gossip_torch.kernels import native, permute

    x = torch.zeros((plan.rows, 128), dtype=torch.int32, device=dev)
    transposes = {"transpose_pass": 0, "untranspose_pass": 0}
    saved = {name: getattr(permute, name) for name in transposes}

    def counted(name):
        def fn(t):
            transposes[name] += 1
            return saved[name](t)
        return fn

    native.reset_launches()
    try:
        for name in transposes:
            setattr(permute, name, counted(name))
        plan.partner(x)
    finally:
        for name, fn in saved.items():
            setattr(permute, name, fn)
    torch.cuda.synchronize()
    out = dict(stages=len(plan.stages), k1_launches=native.LAUNCHES["lane_shuffle"],
               by_entry=dict(native.K1_ENTRIES), torch_transposes=sum(transposes.values()))
    if out["k1_launches"] != 2 * len(plan.lanes) + 1 or out["torch_transposes"]:
        raise AssertionError(f"a partner pass of a {len(plan.lanes)}-stage plan ran {out}")
    return out


def reduce_kernels(plan, dev) -> dict:
    """One ``plan.reduce`` under ``torch.profiler``: fails unless it is one
    K2 launch and the card runs that kernel and no other. A trace that holds
    no device activity at all (the profiler lost it; the launch was counted
    and checked) is taken again, at most three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_gossip_torch.kernels import native

    x = torch.zeros((plan.rows, 128), dtype=torch.int32, device=dev)
    for _ in range(3):
        torch.cuda.synchronize()
        native.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            plan.reduce(x, "or")
            torch.cuda.synchronize()
        kernels = {ev.key: ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA}
        launches = {k: v for k, v in native.LAUNCHES.items() if v}
        if kernels:
            break
    if launches != {"fold_planes_or": 1} or len(kernels) != 1 or "fold_classes_kernel" not in next(iter(kernels)):
        raise AssertionError(f"a reduce launched {launches} and ran {kernels} on the card")
    return dict(launches=launches, device_kernels=kernels)


def time_partner_pass(plan, x) -> dict:
    """The whole partner pass as ``plan.partner`` runs it (fused K1 entries)
    and the same stages unfused (K1 ``lane_shuffle`` and the torch
    transposes), held equal, then timed in turns. Bytes: each K1 launch
    reads x and its table and writes out once."""
    from tpu_gossip_torch.kernels.permute import fuse_stages, lane_shuffle, transpose_pass, untranspose_pass

    def unfused():
        y = x
        for stage in plan.stages:
            if stage[0] == "lane":
                y = lane_shuffle(y, stage[1])
            else:
                y = (transpose_pass if stage[0] == "t" else untranspose_pass)(y)
        return y

    max_err(plan.partner(x), unfused())
    ms, unfused_ms = in_turns(lambda: plan.partner(x), unfused, 20)
    launches = len(fuse_stages(plan.stages))
    return dict(ms=ms, unfused_ms=unfused_ms, launches=launches,
                bytes=launches * plan.rows * 128 * (4 + plan.lanes[0].element_size() + 4))


def fold_kind_times(x, layout) -> dict:
    """K2 (OR) over the blocks of one kind of its work table alone, L2 cold
    and warm, in us: where the whole reduce's time goes."""
    from tpu_gossip_torch.kernels import permute

    out = {}
    for name, kind in (("hub", permute.FOLD_HUB), ("staged", permute.FOLD_STAGED), ("plane", permute.FOLD_PLANE)):
        part = dataclasses.replace(layout, work=layout.work[layout.work[:, 3] == kind].contiguous())
        kernel = lambda part=part: permute.fold_classes(x, part, "or")  # noqa: E731
        out[name] = dict(blocks=part.work.shape[0], cold_us=cold_ms(kernel) * 1e3, warm_us=time_ms(kernel) * 1e3)
    return out


def phase_timing(plan, dev, gen, n: int) -> dict:
    """Each kernel, its plain version and its library call at the main
    path's shapes (kernel and library in turns), and the partner pass."""
    from tpu_gossip_torch.kernels import permute
    from tpu_gossip_torch.kernels.permute import fold_classes, fold_classes_plain
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    x = plan.expand(torch.arange(plan.n, dtype=torch.int32, device=dev))
    tab = plan.lanes[0]
    idx_long = tab.to(torch.int64)
    k1_bytes = plan.rows * 128 * (4 + tab.element_size() + 4)
    libraries = {  # one torch.gather (int64 index made beforehand), with the transpose it absorbs
        "lane_shuffle": lambda: torch.gather(x, 1, idx_long),
        "lane_shuffle_t": lambda: torch.gather(x, 1, idx_long).t().contiguous(),
        "tinv_lane_shuffle": lambda: torch.gather(x.view(128, plan.rows).t().contiguous(), 1, idx_long),
    }
    out = {}
    for entry, library in libraries.items():
        kernel, plain = getattr(permute, entry), getattr(permute, f"{entry}_plain")
        ms, library_ms = in_turns(lambda: kernel(x, tab), library)
        out[entry] = dict(ms=ms, plain_ms=time_ms(lambda: plain(x, tab)), library_ms=library_ms, bytes=k1_bytes)
    out["partner_pass"] = time_partner_pass(plan, x)
    # K2's 26 MB stay in L2 across back-to-back launches, so its time is
    # taken with L2 cold (the bound is the device memory's), warm beside it
    layout = plan.layout
    flat = x.reshape(-1)

    def library():  # one index_add_ over every slot, the dead ones into row n
        return torch.zeros(n + 1, dtype=torch.int32, device=dev).index_add_(0, layout.slot_node, flat)[:n]

    max_err(library(), fold_classes(x, layout, "sum"))
    empty_ms = cold_ms(lambda: torch.cuda._sleep(1))  # what the method itself costs a launch
    for op in ("or", "sum"):
        kernel = lambda op=op: fold_classes(x, layout, op)  # noqa: E731
        ms, library_ms = in_turns(kernel, library, 30, cold_ms) if op == "sum" else (cold_ms(kernel), None)
        out[f"fold_planes_{op}"] = dict(ms=ms, plain_ms=cold_ms(lambda op=op: fold_classes_plain(x, layout, op), 10),
                                        library_ms=library_ms, warm_ms=time_ms(kernel), empty_ms=empty_ms,
                                        bytes=fold_bytes(layout))
    out["fold_planes_or"]["by_kind"] = fold_kind_times(x, layout)
    ops = tail_operands(n + 1, M_SLOTS, gen, dev, rnd=9)
    targs = (*(ops[k] for k in TAIL_PLANES), None, torch.tensor(9, dtype=torch.int32, device=dev))
    tkw = dict(forward_once=False, sir_recover_rounds=0)
    ms, plain_ms = in_turns(lambda: tail_kernel(*targs, **tkw), lambda: tail_fused(*targs, **tkw))
    out["round_tail"] = dict(ms=ms, plain_ms=plain_ms, loop_ms=loop_ms(lambda: tail_kernel(*targs, **tkw)),
                             library_ms=None, bytes=(n + 1) * M_SLOTS * (6 + 4))
    out["round_tail_words"] = time_k4(targs, n + 1)
    return out


def time_k4(targs, rows: int) -> dict:
    """K4 and its plain version (the word chain) at the packed paths'
    shape and flags: 1M rows x 16 slots, no forward-once, fresh or expired.
    Bytes: seen, recovered, incoming and receptive words (2 B each) and the
    int16 latch plane (32 B) read; seen, recovered (2 B each) and the latch
    plane (32 B) written: 76 B a row."""
    from tpu_gossip_torch.core.packed import pack_bits
    from tpu_gossip_torch.kernels.round_tail import round_tail_words, tail_words_plain

    words = [pack_bits(t) if t.dtype == torch.bool else t for t in targs[:7]]
    wargs = (*words, None, targs[8])
    kw = dict(m=M_SLOTS, forward_once=False, sir_recover_rounds=0)
    return dict(ms=time_ms(lambda: round_tail_words(*wargs, **kw)),
                plain_ms=time_ms(lambda: tail_words_plain(*wargs, **kw)),
                loop_ms=loop_ms(lambda: round_tail_words(*wargs, **kw)),
                library_ms=None, bytes=rows * (4 * 2 + 2 * M_SLOTS + 2 * 2 + 2 * M_SLOTS))


def probe_operands(dev, gen):
    """(name, tab, idx, group) at every probe shape of P1-P5, indices in
    range: P1 both axes at every row count, P2's six shapes, P3's full
    shape, P4 and P5 at R = 65,536. ``group`` None is ``lane_gather``, else
    ``sublane_gather`` with that group."""
    from tpu_gossip_torch.experiments import pallas_gather_caps, pallas_wide_lane_gather

    def ints(shape, hi=2**31 - 1, lo=-2**31):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    for rows in pallas_gather_caps.ROWS:
        yield f"P1 rows={rows} axis=0", ints((rows, 128)), ints((rows, 128), rows, 0), 0
        yield f"P1 rows={rows} axis=1", ints((rows, 128)), ints((rows, 128), 128, 0), None
    for s_, w, steps in pallas_wide_lane_gather.SHAPES:
        yield f"P2 S={s_} W={w} steps={steps}", ints((s_, w)), ints((steps * s_, w), w, 0), None
    yield "P3", ints((8192, 128)), ints((23 * 2048, 128), 8192, 0), 0
    yield "P4", ints((65536, 128)), ints((65536, 128), 128, 0), None
    yield "P5", ints((65536, 128)), ints((65536, 128), 8, 0), 8


def probe_fns(tab, idx, group):
    """(kernel, plain version, one ``torch.gather`` with the int64 index
    made beforehand) of the probe gather on these operands."""
    from tpu_gossip_torch.kernels.probes import lane_gather, lane_gather_plain, sublane_gather, sublane_gather_plain

    il = idx.long()
    if group is None:
        t, w = tab.shape
        tab3, il3 = tab.unsqueeze(0).expand(idx.shape[0] // t, t, w), il.view(-1, t, w)
        return (lambda: lane_gather(tab, idx), lambda: lane_gather_plain(tab, idx),
                lambda: torch.gather(tab3, 2, il3))
    tab3, il3, dim = (tab, il, 0) if group == 0 else (tab.view(-1, group, 128), il.view(-1, group, 128), 1)
    return (lambda: sublane_gather(tab, idx, group), lambda: sublane_gather_plain(tab, idx, group),
            lambda: torch.gather(tab3, dim, il3))


RAGGED_LANE = ((3, 40000, 9), (5, 65540, 10), (1, 262144, 3), (7, 32768, 14), (2, 8196, 6), (4, 6, 12))
RAGGED_SUBLANE = ((100, 4097), (8192, 47105), (1, 9), (5000, 20000), (8192, 16389))


def check_probes(dev, gen) -> int:
    """Both probe kernels against their plain versions at every probe
    shape, exactly; P4's output against K1's ``lane_shuffle`` too; and the
    staged routes at ragged shapes: lane_gather (T, W, N) with a partly
    staged row, W not a multiple of 4, and sublane_gather group 0 (T, N)
    with idx rows not a multiple of the slab's step or box."""
    from tpu_gossip_torch.kernels.permute import lane_shuffle

    def ints(shape, hi=2**31 - 1, lo=-2**31):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    cases = list(probe_operands(dev, gen))
    cases += [(f"lane {c}", ints(c[:2]), ints((c[2], c[1]), c[1], 0), None) for c in RAGGED_LANE]
    cases += [(f"sublane {c}", ints((c[0], 128)), ints((c[1], 128), c[0], 0), 0) for c in RAGGED_SUBLANE]
    err = 0
    for name, tab, idx, group in cases:
        kernel, plain, _ = probe_fns(tab, idx, group)
        got = kernel()
        err = max(err, max_err(got, plain()))
        if name == "P4":
            err = max(err, max_err(got, lane_shuffle(tab, idx)))
    return err


def time_probes(dev, gen) -> dict:
    """Each probe's kernel at its row's shape (P1 at 8192 rows, axis 1 in the
    row and axis 0 beside it; P2 at (8, 131072, 4)), its plain version and
    its ``torch.gather``. P1, P2 and P3 fit in L2 (12.6, 37.7 and 52.4 MB
    against 50), so their times are taken with L2 cold (``cold_ms``), kernel
    and ``torch.gather`` in turns, warm beside them; P4 and P5 warm. Bytes:
    idx read and out written once, 4 B an element each, the table read
    once; ``gathers``: the random reads, one an idx element."""
    cases = {c[0]: c[1:] for c in probe_operands(dev, gen)}
    rows = {"P1 axis 0": "P1 rows=8192 axis=0", "P1": "P1 rows=8192 axis=1", "P2": "P2 S=8 W=131072 steps=4",
            "P3": "P3", "P4": "P4", "P5": "P5"}
    out = {}
    empty_ms = cold_ms(lambda: torch.cuda._sleep(1))  # what the cold method itself costs a launch
    for key, case in rows.items():
        tab, idx, group = cases[case]
        kernel, plain, library = probe_fns(tab, idx, group)
        t = dict(bytes=(2 * idx.numel() + tab.numel()) * 4, gathers=idx.numel())
        if key in ("P4", "P5"):
            t.update(ms=time_ms(kernel), plain_ms=time_ms(plain, 10), library_ms=time_ms(library, 10))
        else:
            ms, library_ms = in_turns(kernel, library, 30, cold_ms)
            t.update(ms=ms, library_ms=library_ms, plain_ms=cold_ms(plain, 10), warm_ms=time_ms(kernel),
                     empty_ms=empty_ms)
        out[key] = t
    return out


def probe_line(card: str, name: str, t: dict) -> str:
    """One probe row's times beside its bound, with its random-gather rate."""
    cold = "" if t.get("warm_ms") is None else (
        f" with L2 cold (an empty launch timed so: {t['empty_ms'] * 1e3} us), L2 warm {t['warm_ms'] * 1e3} us "
        f"({t['gathers'] / t['warm_ms'] / 1e6} G/s warm)")
    return (f"[{card}] {name}: {t['ms'] * 1e3} us{cold}, {t['gathers'] / t['ms'] / 1e6} G gathers/s, bound "
            f"{t['bytes'] / HBM_BYTES_PER_S * 1e6} us ({t['bytes']} B), plain {t['plain_ms'] * 1e3} us, "
            f"library (torch.gather) {t['library_ms'] * 1e3} us")


def run_probe_scripts(card: str) -> dict:
    """Each ported probe script's ``main()`` at its own shapes, launches
    counted from 0 per script; its lines printed behind the card's name.
    Fails on a WRONG line or a probe kernel its script never launched."""
    import contextlib
    import io

    from tpu_gossip_torch.experiments import gather_probe, pallas_gather_caps, pallas_wide_lane_gather, \
        perm_pipeline_probe
    from tpu_gossip_torch.kernels import native

    launches = {}
    for name, mod in (("pallas_gather_caps", pallas_gather_caps), ("pallas_wide_lane_gather", pallas_wide_lane_gather),
                      ("gather_probe", gather_probe), ("perm_pipeline_probe", perm_pipeline_probe)):
        native.reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main()
        launches[name] = dict(native.LAUNCHES)
        for line in buf.getvalue().splitlines():
            if line.strip():
                print(f"[{card}] {name}: {line}", flush=True)
        if "WRONG" in buf.getvalue():
            raise AssertionError(f"{name} printed a WRONG result")
        print(f"[{card}] {name}: {time.perf_counter() - t0:.2f} s, launches {launches[name]}", flush=True)
    rows = {"P1": launches["pallas_gather_caps"]["lane_gather"] + launches["pallas_gather_caps"]["sublane_gather"],
            "P2": launches["pallas_wide_lane_gather"]["lane_gather"],
            "P3": launches["gather_probe"]["sublane_gather"],
            "P4": launches["perm_pipeline_probe"]["lane_gather"],
            "P5": launches["perm_pipeline_probe"]["sublane_gather"]}
    for key, n in rows.items():
        if n == 0:
            raise AssertionError(f"the {key} probe script never launched its kernel")
    if launches["pallas_gather_caps"]["sublane_gather"] == 0:
        raise AssertionError("pallas_gather_caps never launched sublane_gather (axis 0)")
    return rows


PROFILE_STAGES = ["delivery", "tail[reference]", "tail[fused]", "liveness", "stats", "rng", "transport_compact",
                  "full_round[reference]", "full_round[fused]"]


def run_profile_round(card: str, n: int) -> dict:
    """``run_sim --profile-round 6`` on the 1M matching headline, launches
    counted from 0: K1, K2 and K3 must each launch. Prints the stage table."""
    import contextlib
    import io

    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels import native

    argv = ["--peers", str(n), "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--profile-round", "6",
            "--device", "cuda"]
    native.reset_launches()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_sim.main(argv)
    launches = dict(native.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"run_sim --profile-round exited {rc}: {err.getvalue()}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    if list(summary["stages_ms"]) != PROFILE_STAGES:
        raise AssertionError(f"--profile-round stages {list(summary['stages_ms'])} != {PROFILE_STAGES}")
    check_launches("--profile-round", launches, {"lane_shuffle": None, "fold_planes_or": None, "round_tail": None},
                   1)
    for line in err.getvalue().splitlines():
        print(f"[{card}] profile-round n={n}: {line}", flush=True)
    print(f"[{card}] profile-round summary: {json.dumps(summary)}", flush=True)
    print(f"[{card}] profile-round launches: {launches}", flush=True)
    return summary


# ------------------------------------------------------------ phase 7: checkpoints

CKPT_WROTE = re.compile(r"checkpoint: wrote (ckpt-\d{8}) \((\d+) bytes, (\d+) files\) in ([0-9.]+) s")
CKPT_RECOVERED = re.compile(r"resume: recovered in ([0-9.]+) s \((.*)\)")
CKPT_PEAK = re.compile(r"checkpoint: device peak max_memory_allocated (\d+) B \(the build (\d+) B; the horizon "
                       r"(\d+) B, from (\d+) B allocated at its start\)")
CKPT_FOLD = re.compile(r"remat: fold at round (\d+), (\d+) overflow edges, re-partition seed (\d+)")


def cli_start(root: Path, argv: list[str]) -> subprocess.Popen:
    """``python -m tpu_gossip_torch.cli.run_sim argv`` started in its own
    process."""
    return subprocess.Popen([sys.executable, "-m", "tpu_gossip_torch.cli.run_sim", *argv], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_finish(proc: subprocess.Popen, what: str) -> tuple[dict, str]:
    """Wait for a :func:`cli_start` process; fails unless it exits 0.
    Returns the summary (its last stdout line) and its stderr."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{what}: run_sim {' '.join(proc.args[3:])} exited {proc.returncode}: {err[-4000:]}")
    return json.loads(out.strip().splitlines()[-1]), err


def cli_run(root: Path, argv: list[str], what: str) -> tuple[dict, str]:
    """One run_sim process, start to end."""
    return cli_finish(cli_start(root, argv), what)


def check_pin(summary: dict, pin: dict, what: str) -> None:
    for k, want in pin["summary"].items():
        if summary[k] != want:
            raise AssertionError(f"{what}: {k} {summary[k]} != the JAX pin's {want} ({pin['source']})")


def ckpt_saves(err: str) -> list[dict]:
    """The checkpoints a run's stderr says it wrote: name, bytes, files,
    seconds."""
    return [dict(name=m.group(1), bytes=int(m.group(2)), files=int(m.group(3)), seconds=float(m.group(4)))
            for m in CKPT_WROTE.finditer(err)]


def device_peak(err: str, what: str) -> dict:
    """A durable run's device peak from its stderr: the whole run's, the
    build's, the horizon's and the bytes allocated as the horizon began."""
    m = CKPT_PEAK.search(err)
    if m is None:
        raise AssertionError(f"{what}: the run logged no device peak: {err[-2000:]}")
    return dict(zip(("peak", "build", "horizon", "start"), (int(g) for g in m.groups())))


def peak_text(p: dict) -> str:
    return (f"max_memory_allocated {p['peak']} B (build {p['build']} B, horizon {p['horizon']} B from "
            f"{p['start']} B allocated at its start)")


def recovery(err: str, resumed_from: str, what: str) -> dict:
    """A resume's stderr: it must have resumed from ``resumed_from``;
    returns its recovery seconds (and their parts) and its device peak."""
    if f"resume: {resumed_from} at round" not in err:
        raise AssertionError(f"{what}: the resume did not start from {resumed_from}: {err[-2000:]}")
    rec = CKPT_RECOVERED.search(err)
    if rec is None:
        raise AssertionError(f"{what}: the resume logged no recovery time: {err[-2000:]}")
    return dict(seconds=float(rec.group(1)), parts=rec.group(2), peak=device_peak(err, what))


def ckpt_line(card: str, what: str, saves: list[dict], rec: dict, extra: str = "") -> str:
    secs = [s["seconds"] for s in saves]
    return (f"[{card}] {what}: checkpoints {[s['name'] for s in saves]}, {saves[0]['bytes']} B in "
            f"{saves[0]['files']} files each ({[s['bytes'] for s in saves]} B), seconds a save {secs} (mean "
            f"{sum(secs) / len(secs)}), recovery {rec['seconds']} s ({rec['parts']}), resumed run's "
            f"{peak_text(rec['peak'])}{extra}")


def both_ways(leg) -> None:
    """``leg(write_on, resume_on)`` for a checkpoint written on the card
    and resumed on the CPU and for the reverse, both at once (two threads,
    each waiting on its own processes); the first failure is raised."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(leg, w, r) for w, r in (("cuda", "cpu"), ("cpu", "cuda"))]
    for f in futures:
        f.result()


def kill_at(root: Path, argv: list[str], line: str) -> str:
    """Run ``run_sim argv`` and SIGKILL it as soon as its stderr logs
    ``line``; returns the stderr it logged. Fails if the run ends first."""
    proc = subprocess.Popen([sys.executable, "-m", "tpu_gossip_torch.cli.run_sim", *argv], cwd=root,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    seen = []
    try:
        for got in proc.stderr:
            seen.append(got)
            if line in got:
                proc.kill()
                break
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        proc.stderr.close()
    if not seen or line not in seen[-1]:
        raise AssertionError(f"the run ended before it logged {line!r}: {''.join(seen)[-2000:]}")
    return "".join(seen)


def phase_checkpoints(root: Path, card: str, headline_peak: int) -> dict:
    """Phase 7: durable checkpoints and crash recovery through the CLI, each
    run its own process, at 1M peers (7e at 20000): 7a a checkpointed
    headline SIGKILLed after its round-8 checkpoint, that checkpoint
    corrupted, resumed from round 4 onto the JAX pin, its device memory held
    to the same run's uninterrupted; 7b its packed twin,
    uninterrupted and resumed from round 8; 7c the churn pin resumed from
    round 8; 7d the sharded remat loop resumed on its epoch boundary (the
    fold and the re-partition with seed + 1 replayed, 0 overflow edges),
    digest-equal to its uninterrupted run; 7e checkpoints written on the
    card resumed on the CPU and the reverse. Returns the figures by phase."""
    import shutil
    import tempfile

    from tpu_gossip_torch.ckpt import corrupt_checkpoint, list_checkpoint_steps, verify_checkpoint

    refs = json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
    headline = [r for r in refs if "1000000" in r["argv"] and "--churn-join" not in r["argv"]][0]
    churn = [r for r in refs if "1000000" in r["argv"] and "--churn-join" in r["argv"]][0]
    small = refs[0]
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as tmp:
        tmp = Path(tmp)

        # 7a: SIGKILL once ckpt-8 lands, flip a byte of it, resume from ckpt-4
        t0 = time.perf_counter()
        d = tmp / "7a"
        err = kill_at(root, headline["argv"] + ["--checkpoint-every", "4", "--checkpoint-dir", str(d), "--keep", "2"],
                      "checkpoint: wrote ckpt-00000008")
        saves = ckpt_saves(err)
        later = [p for step, p in list_checkpoint_steps(d) if step > 8 and (p / "MANIFEST.json").is_file()]
        if later:
            raise AssertionError(f"7a: the kill came after a later checkpoint landed: {later}")
        verify_checkpoint(d / "ckpt-00000008")
        corrupt_checkpoint(d / "ckpt-00000008", "flip_byte")
        summary, err = cli_run(root, ["resume", str(d)], "7a resume")
        if "checkpoint: rolling back past ckpt-00000008" not in err:
            raise AssertionError(f"7a: the resume logged no rollback past the corrupted ckpt-00000008: {err[-2000:]}")
        check_pin(summary, headline, "7a resume")
        rec = recovery(err, "ckpt-00000004", "7a")
        # the same checkpointed run uninterrupted: the peak a resume is held to
        full, err = cli_run(root, headline["argv"] + ["--checkpoint-every", "4", "--checkpoint-dir",
                                                      str(tmp / "7a-full"), "--keep", "2"], "7a uninterrupted")
        check_pin(full, headline, "7a uninterrupted")
        twin = device_peak(err, "7a uninterrupted")
        # a second device copy of the state left by the load would add its 166 MB at the horizon's start
        for k in ("start", "horizon"):
            if rec["peak"][k] > twin[k] + (16 << 20):
                raise AssertionError(f"7a: the resumed run's {k} bytes {rec['peak'][k]} exceed the uninterrupted "
                                     f"run's {twin[k]} by more than 16 MiB")
        out["7a"] = dict(saves=saves, recovery=rec, uninterrupted_peak=twin, seconds=time.perf_counter() - t0)
        print(ckpt_line(card, "7a headline, SIGKILL after ckpt-00000008, flipped byte, resumed from ckpt-00000004",
                        saves, rec, f"; the same run uninterrupted {peak_text(twin)}; 4a's, plan build included: "
                        f"{headline_peak} B; digests equal the JAX pin; {out['7a']['seconds']:.2f} s"), flush=True)

        # 7b: the packed twin, uninterrupted, then resumed from round 8
        t0 = time.perf_counter()
        d = tmp / "7b"
        full, err = cli_run(root, headline["argv"] + ["--packed", "--checkpoint-every", "4", "--checkpoint-dir",
                                                      str(d)], "7b")
        saves = ckpt_saves(err)
        check_pin(full, headline, "7b uninterrupted")
        shutil.rmtree(d / "ckpt-00000012")
        summary, err = cli_run(root, ["resume", str(d)], "7b resume")
        check_pin(summary, headline, "7b resume")
        rec = recovery(err, "ckpt-00000008", "7b")
        out["7b"] = dict(saves=saves, recovery=rec, seconds=time.perf_counter() - t0)
        print(ckpt_line(card, "7b packed headline, resumed from ckpt-00000008", saves, rec,
                        f"; both runs' digests equal the JAX pin; {out['7b']['seconds']:.2f} s"), flush=True)

        # 7c: the churn headline, uninterrupted, then resumed from round 8
        t0 = time.perf_counter()
        d = tmp / "7c"
        full, err = cli_run(root, churn["argv"] + ["--checkpoint-every", "8", "--checkpoint-dir", str(d)], "7c")
        saves = ckpt_saves(err)
        check_pin(full, churn, "7c uninterrupted")
        summary, err = cli_run(root, ["resume", str(d)], "7c resume")
        check_pin(summary, churn, "7c resume")
        rec = recovery(err, "ckpt-00000008", "7c")
        out["7c"] = dict(saves=saves, recovery=rec, seconds=time.perf_counter() - t0)
        print(ckpt_line(card, "7c churn headline, resumed from ckpt-00000008", saves, rec,
                        f"; both runs' digests equal the JAX pin; {out['7c']['seconds']:.2f} s"), flush=True)

        # 7d: the sharded remat loop, resumed on its epoch boundary (round 16)
        t0 = time.perf_counter()
        d = tmp / "7d"
        argv = ["--peers", "1000000", "--mode", "push_pull", "--fanout", "1", "--seed", "0", "--graph", "chung-lu",
                "--shard", "--staircase", "--churn-leave", "0.002", "--churn-join", "0.02", "--rewire-slots", "2",
                "--remat-every", "16", "--rounds", "32", "--digest", "--quiet"]
        full, err_full = cli_run(root, argv + ["--checkpoint-every", "16", "--checkpoint-dir", str(d)], "7d")
        saves = ckpt_saves(err_full)
        summary, err = cli_run(root, ["resume", str(d)], "7d resume")
        rec = recovery(err, "ckpt-00000016", "7d")
        folds = [tuple(int(g) for g in m.groups()) for m in CKPT_FOLD.finditer(err)]
        if folds != [(16, 0, 1)] or [tuple(int(g) for g in m.groups()) for m in CKPT_FOLD.finditer(err_full)] != folds:
            raise AssertionError(f"7d: the folds (round, overflow edges, seed) were {folds}, need [(16, 0, 1)] in "
                                 "both runs")
        timing = ("wall_seconds",)
        if {k: v for k, v in summary.items() if k not in timing} != {k: v for k, v in full.items() if k not in timing}:
            raise AssertionError(f"7d: the resumed summary {summary} != the uninterrupted one {full}")
        out["7d"] = dict(saves=saves, recovery=rec, seconds=time.perf_counter() - t0, digest=summary["state_digest"])
        print(ckpt_line(card, "7d sharded remat loop, resumed from ckpt-00000016 (fold replayed, re-partition "
                        "seed 1, 0 overflow edges)", saves, rec,
                        f"; digests equal the uninterrupted run's ({summary['state_digest']}); "
                        f"{out['7d']['seconds']:.2f} s"), flush=True)

        # 7e: n=20000, written on the card and resumed on the CPU, and the
        # reverse (the two directions' processes side by side: nothing timed)
        t0 = time.perf_counter()
        legs = (("card->cpu", "cuda", "cpu"), ("cpu->card", "cpu", "cuda"))
        writes = [cli_start(root, small["argv"] + ["--checkpoint-every", "8", "--checkpoint-dir",
                                                   str(tmp / f"7e-{w}"), "--device", w]) for _n, w, _r in legs]
        for (name, _w, _r), proc in zip(legs, writes):
            cli_finish(proc, f"7e {name} write")
        resumes = []
        for name, write_on, resume_on in legs:
            shutil.rmtree(tmp / f"7e-{write_on}" / "ckpt-00000016")
            resumes.append(cli_start(root, ["resume", str(tmp / f"7e-{write_on}"), "--device", resume_on]))
        for (name, _w, _r), proc in zip(legs, resumes):
            summary, err = cli_finish(proc, f"7e {name} resume")
            if "resume: ckpt-00000008 at round" not in err:
                raise AssertionError(f"7e {name}: the resume did not start from ckpt-00000008")
            check_pin(summary, small, f"7e {name}")
        out["7e"] = dict(seconds=time.perf_counter() - t0)
        print(f"[{card}] 7e n=20000: ckpt-00000008 written on the card resumed on the CPU, and written on the CPU "
              f"resumed on the card, both onto the JAX pin; {out['7e']['seconds']:.2f} s", flush=True)
    return out


# ------------------------------------------------------------ phase 8: the fault plane

# the kernel launches a fault path makes over a horizon of R rounds, P of
# them with an active partition (side B's second delivery pass)
def fault_launches(path: str, rounds: int, partitioned: int = 0) -> dict:
    both = rounds + partitioned
    return {
        "matching": {"fold_planes_or": both, "round_tail": rounds, "round_tail_words": 0, "staircase_segment": 0,
                     "stream_segment": 0},
        "packed matching": {"fold_planes_or": both, "round_tail": 0, "round_tail_words": rounds,
                            "staircase_segment": 0, "stream_segment": 0},
        "staircase": {"lane_shuffle": 0, "fold_planes_or": 0, "staircase_segment": both, "round_tail": rounds,
                      "round_tail_words": 0, "stream_segment": 0},
        "sharded staircase": {"lane_shuffle": 0, "fold_planes_or": 0, "staircase_segment": 0, "stream_segment": both,
                              "round_tail": rounds, "round_tail_words": 0},
        "sharded scatter": {"lane_shuffle": 0, "fold_planes_or": 0, "staircase_segment": 0, "stream_segment": 0,
                            "round_tail": rounds, "round_tail_words": 0},
        "sharded packed": {"lane_shuffle": 0, "fold_planes_or": 0, "staircase_segment": 0, "stream_segment": both,
                           "round_tail": 0, "round_tail_words": rounds},
    }[path]


def cli_here(argv: list[str], dev, marks: bool = False) -> dict:
    """run_sim's run body in this process (so the kernels' launch counters
    see it), every launch counted from 0: the summary, the per-round rows,
    the final (unpacked) state, the launches, the fixed horizon's wall
    seconds (graph, plans and state built before it) and the device peak
    over it (the peak reset as it starts). With ``marks`` (a local
    engine's horizon), a CUDA event is recorded as the horizon starts and
    after each round, and ``round_ms`` holds the ms between consecutive
    ones: each round's span on the card's clock, idle gaps included."""
    import contextlib
    import io

    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim import engine

    events = []
    plain_round = engine.gossip_round

    def marked(*a, **k):
        out = plain_round(*a, **k)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    args = run_sim.build_parser().parse_args(argv + ["--device", str(dev)])
    err = run_sim.validate(args)
    if err:
        raise AssertionError(f"run_sim {' '.join(argv)} refused: {err}")
    horizon = {}
    plain = run_sim._run_checkpointed_horizon

    def timed(*a, **k):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        horizon["start_bytes"] = torch.cuda.memory_allocated(dev)
        if marks:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        out = plain(*a, **k)
        torch.cuda.synchronize(dev)
        horizon.update(wall_s=out[3], peak=torch.cuda.max_memory_allocated(dev))
        return out

    native.reset_launches()
    run_sim._run_checkpointed_horizon = timed
    if marks:
        engine.gossip_round = marked
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            summary, fin = run_sim._execute(args)
        torch.cuda.synchronize(dev)
    finally:
        run_sim._run_checkpointed_horizon = plain
        engine.gossip_round = plain_round
    rows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    return dict(summary=summary, rows=rows, fin=fin, launches=dict(native.LAUNCHES), horizon=horizon,
                call_s=time.perf_counter() - t0,
                round_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])])


def check_counts(what: str, launches: dict, want: dict) -> None:
    for key, n in want.items():
        if launches[key] != n:
            raise AssertionError(f"{what} launched {key} {launches[key]} times, needs {n}")


def fault_line(card: str, what: str, r: dict, extra: str = "") -> str:
    s, h = r["summary"], r["horizon"]
    rounds = s.get("rounds_run") or s.get("rounds")
    timing = (f"{h['wall_s'] * 1e3 / rounds} ms/round over the horizon, peak {h['peak']} B (from {h['start_bytes']} "
              f"B at its start)" if h else f"{r['call_s']:.2f} s for the whole call, graph build included")
    return (f"[{card}] {what}: {timing}; launches {({k: v for k, v in r['launches'].items() if v})}; "
            f"state_digest {s.get('state_digest', '-')}{extra}")


def same_run(a: dict, b: dict, what: str) -> None:
    """Twins: the same summary apart from the ``packed`` flag and timings."""
    drop = ("packed", "wall_seconds", "epoch_rebuild_seconds_total")
    sa = {k: v for k, v in a["summary"].items() if k not in drop}
    sb = {k: v for k, v in b["summary"].items() if k not in drop}
    if sa != sb:
        raise AssertionError(f"{what}: the twins' summaries differ: {sa} != {sb}")


def phase_faults(root: Path, dev, card: str, n_big: int = N_HEADLINE) -> dict:
    """Phase 8: silent peers and the fault plane through the CLI. 8a
    BASELINE config 2 at its 1000 peers (onto the JAX pin; no peer declared
    dead through round 7, all 100 silent peers from round 8) and the
    n=20000 fault pins; 8b config 2's flags on the 1M matching headline
    (onto the JAX pin; every silent peer declared, no other) and its packed
    twin; 8c the four catalogued scenarios at 1M on the headline, each
    equal to its packed twin, lossy-links and split-brain onto the JAX pins,
    split-brain launching K2 once a round plus once a partitioned round and
    K3 once a round; 8d split-brain on the staircase, rack-failure on the
    sharded K6 path with its scatter and packed twins, lossy-links on the
    sharded remat loop; 8e lossy-links at n=20000 killed after its round-20
    checkpoint (mid-delay) and resumed on the CPU (written on the CPU, on
    the card), onto the JAX pin. Returns the figures by run. ``n_big``
    replaces the 1M runs' peer count (the pins are checked only at 1M)."""
    import shutil
    import tempfile

    pins = [r for r in json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
            if fault_pin(r)]
    by_argv = {" ".join(r["argv"]): r for r in pins}
    out = {}

    def pinned(argv: list[str]) -> dict | None:
        """The JAX pin of a 1M run (every 1M pin must be found)."""
        pin = by_argv.get(" ".join(argv))
        if pin is None and n_big == N_HEADLINE and argv[1] == str(N_HEADLINE) and (
                "--silent-frac" in argv or "lossy_links" in " ".join(argv) or "split_brain" in " ".join(argv)):
            raise AssertionError(f"no JAX pin for {' '.join(argv)}")
        return pin

    # 8a: config 2 at 1000 peers, then the other small pins
    t0 = time.perf_counter()
    c2 = [r for r in pins if r["argv"][1] == "1000"][0]
    r = cli_here([a for a in c2["argv"] if a != "--quiet"], dev)
    check_pin(r["summary"], c2, "8a config 2")
    dead = [row["n_declared_dead"] for row in r["rows"]]
    if dead[:7] != [0] * 7 or dead[7:] != [100] * (len(dead) - 7):
        raise AssertionError(f"8a: config 2 declared {dead} dead by round, needs 0 through round 7 and 100 after")
    print(f"[{card}] 8a config 2 (1000 peers, pa m=3, 8 slots, push fanout 3, 10% silent): n_declared_dead by round "
          f"{dead}, digests equal the JAX pin ({r['summary']['state_digest']})", flush=True)
    for ref in pins:
        if ref["argv"][1] == "20000":
            got = cli_here(ref["argv"], dev)
            check_pin(got["summary"], ref, "8a n=20000")
            print(f"[{card}] 8a n=20000 pin equal: {' '.join(ref['argv'][2:-3])}", flush=True)
    out["8a"] = dict(seconds=time.perf_counter() - t0)

    big = ["--peers", str(n_big), "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--digest", "--quiet"]

    # 8b: config 2's flags on the 1M headline, and its packed twin
    t0 = time.perf_counter()
    argv = big + ["--slots", "16", "--silent-frac", "0.1", "--rounds", "16"]
    r = cli_here(argv, dev)
    pin = pinned(argv)
    if pin is not None:
        check_pin(r["summary"], pin, "8b")
    check_counts("8b", r["launches"], fault_launches("matching", 16))
    fin = r["fin"]
    silent, dead, real = fin.silent, fin.declared_dead, fin.exists
    if int(silent.sum()) != n_big // 10 or bool((silent & ~dead).any()) or bool((dead & real & ~silent).any()):
        raise AssertionError(f"8b: {int(silent.sum())} silent peers, {int((silent & ~dead).sum())} of them not "
                             f"declared, {int((dead & real & ~silent).sum())} peers declared that were never silent")
    p = cli_here(argv + ["--packed"], dev)
    same_run(r, p, "8b packed twin")
    check_counts("8b packed", p["launches"], fault_launches("packed matching", 16))
    out["8b"] = dict(unpacked=r["horizon"], packed=p["horizon"], seconds=time.perf_counter() - t0)
    print(fault_line(card, f"8b config 2's flags at n={n_big} on the matching headline (16 rounds)", r,
                     f"; all {n_big // 10} silent peers declared dead, no other peer"
                     + ("; digests equal the JAX pin" if pin is not None else "")), flush=True)
    print(fault_line(card, "8b packed twin", p, ", digest-equal"), flush=True)
    del fin, silent, dead, real, r, p

    # 8c: the four catalogued scenarios at 1M on the headline, each with its packed twin
    t0 = time.perf_counter()
    for name, partitioned in (("split_brain", 16), ("lossy_links", 0), ("rack_failure", 0), ("churn_storm", 0)):
        argv = big + ["--scenario", f"scenarios/{name}.toml", "--rounds", "32"]
        r = cli_here(argv, dev)
        pin = pinned(argv)
        if pin is not None:
            check_pin(r["summary"], pin, f"8c {name}")
        check_counts(f"8c {name}", r["launches"], fault_launches("matching", 32, partitioned))
        p = cli_here(argv + ["--packed"], dev)
        same_run(r, p, f"8c {name} packed twin")
        check_counts(f"8c {name} packed", p["launches"], fault_launches("packed matching", 32, partitioned))
        out[f"8c {name}"] = dict(unpacked=r["horizon"], packed=p["horizon"], phases=r["summary"]["phases"])
        pinned_text = "; digests equal the JAX pin" if pin is not None else ""
        print(fault_line(card, f"8c {name} at n={n_big} on the matching headline (32 rounds)", r,
                         f"; phases {json.dumps(r['summary']['phases'])}{pinned_text}"), flush=True)
        print(fault_line(card, f"8c {name} packed twin", p, ", digest-equal"), flush=True)
        del r, p
    d = out["8c lossy_links"]["unpacked"]["peak"] - out["8c split_brain"]["unpacked"]["peak"]
    print(f"[{card}] 8c lossy-links' two (N, M) = ({n_big + 1}, 16) uniforms a round: horizon peak "
          f"{out['8c lossy_links']['unpacked']['peak']} B, {d} B above split-brain's (no draws)", flush=True)
    out["8c"] = dict(seconds=time.perf_counter() - t0)

    # 8d: the other delivery paths at 1M (Chung-Lu, 24 rounds; the remat loop 32)
    t0 = time.perf_counter()
    csr = ["--peers", str(n_big), "--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--digest", "--quiet"]
    r = cli_here(csr + ["--staircase", "--scenario", "scenarios/split_brain.toml", "--rounds", "24"], dev)
    check_counts("8d staircase", r["launches"], fault_launches("staircase", 24, 16))
    out["8d staircase"] = r["horizon"]
    print(fault_line(card, f"8d split-brain on the staircase at n={n_big} (24 rounds)", r,
                     f"; phases {json.dumps(r['summary']['phases'])}"), flush=True)
    rack = csr + ["--shard", "--scenario", "scenarios/rack_failure.toml", "--rounds", "24"]
    twins = {}
    for what, extra in (("sharded staircase", ["--staircase"]), ("sharded scatter", []),
                        ("sharded packed", ["--staircase", "--packed"])):
        twins[what] = cli_here(rack + extra, dev)
        check_counts(f"8d {what}", twins[what]["launches"], fault_launches(what, 24))
        if what != "sharded staircase":
            same_run(twins["sharded staircase"], twins[what], f"8d {what}")
        out[f"8d {what}"] = twins[what]["horizon"]
        print(fault_line(card, f"8d rack-failure, {what} at n={n_big} (24 rounds)", twins[what],
                         f"; phases {json.dumps(twins[what]['summary']['phases'])}" if what == "sharded staircase"
                         else ", digest-equal to the K6 run"), flush=True)
    del twins
    r = cli_here(csr + ["--shard", "--staircase", "--scenario", "scenarios/lossy_links.toml", "--churn-leave", "0.002",
                        "--churn-join", "0.02", "--rewire-slots", "2", "--remat-every", "16", "--rounds", "32"], dev)
    if r["summary"]["remats"] != 1 or r["summary"]["remat_overflow_edges"] != 0:
        raise AssertionError(f"8d remat loop: {r['summary']['remats']} folds, {r['summary']['remat_overflow_edges']} "
                             "overflow edges; needs 1 and 0")
    check_counts("8d remat loop", r["launches"], {"stream_segment": 32, "round_tail": 32})
    out["8d remat"] = dict(call_s=r["call_s"], rebuild_s=r["summary"]["epoch_rebuild_seconds_total"])
    print(fault_line(card, f"8d lossy-links on the sharded remat loop at n={n_big} (32 rounds, a fold and a re-partition "
                     "at round 16, 0 overflow edges)", r), flush=True)
    del r
    out["8d"] = dict(seconds=time.perf_counter() - t0)

    # 8e: n=20000 lossy-links checkpointed every 4 rounds, killed after
    # ckpt-20 (inside the loss-and-delay phase, its delay buffer live) and
    # resumed on the other device, both ways, onto the JAX pin
    from tpu_gossip_torch.ckpt import load_checkpoint

    t0 = time.perf_counter()
    small = [r for r in pins if r["argv"][1] == "20000" and "scenarios/lossy_links.toml" in r["argv"]][0]
    held = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-faults-") as tmp:
        tmp = Path(tmp)

        def leg(write_on, resume_on):
            d = tmp / write_on
            kill_at(root, small["argv"] + ["--checkpoint-every", "4", "--checkpoint-dir", str(d), "--device",
                                           write_on], "checkpoint: wrote ckpt-00000020")
            for late in (24, 28):
                shutil.rmtree(d / f"ckpt-{late:08d}", ignore_errors=True)
            held[write_on] = int(load_checkpoint(d / "ckpt-00000020", device="cpu")[0].fault_held.sum())
            if held[write_on] == 0:
                raise AssertionError("8e: ckpt-00000020 holds an empty delay buffer; the resume would not be mid-delay")
            summary, err = cli_run(root, ["resume", str(d), "--device", resume_on], f"8e {write_on} resume")
            if "resume: ckpt-00000020 at round 20" not in err:
                raise AssertionError(f"8e: the resume did not start from ckpt-00000020: {err[-2000:]}")
            check_pin(summary, small, f"8e {write_on}->{resume_on}")

        both_ways(leg)
    out["8e"] = dict(seconds=time.perf_counter() - t0, held=held)
    print(f"[{card}] 8e lossy-links n=20000 killed after ckpt-00000020 (delay buffer {held} bits) on the card and "
          f"resumed on the CPU, and the reverse, both onto the JAX pin (phases included); "
          f"{out['8e']['seconds']:.2f} s", flush=True)
    return out


# ------------------------------------------------------------ phase 9: the quorum detector

SIEGE = ["--scenario", "scenarios/byzantine_siege.toml"]
SIEGE_ROUNDS = (6, 45)  # the siege phase's rounds (1-based, inclusive); the aftermath's are 46-55


def quorum_path(argv: list[str]) -> str:
    """The delivery path of a run_sim argv (fault_launches' names)."""
    if "--shard" in argv:
        return "sharded staircase" if "--staircase" in argv else "sharded scatter"
    if "matching" in argv:
        return "packed matching" if "--packed" in argv else "matching"
    return "staircase" if "--staircase" in argv else "exactly-k"


def check_quorum_launches(what: str, argv: list[str], r: dict) -> None:
    """Every launch a quorum run must make, counted from 0: the path's
    kernels once a round (K1 at least once on matching), none other."""
    rounds = int(argv[argv.index("--rounds") + 1])
    path = quorum_path(argv)
    want = (fault_launches(path, rounds) if path != "exactly-k" else
            {"lane_shuffle": 0, "fold_planes_or": 0, "staircase_segment": 0, "stream_segment": 0,
             "round_tail": rounds, "round_tail_words": 0})
    check_counts(what, r["launches"], want)
    if "matching" in path and r["launches"]["lane_shuffle"] == 0:
        raise AssertionError(f"{what}: the matching path launched no K1")


def phase_ms(round_ms: list[float], lo: int, hi: int) -> float:
    """Mean ms/round over rounds ``lo``-``hi`` (1-based, inclusive)."""
    span = round_ms[lo - 1:hi]
    return sum(span) / len(span)


def quorum_line(card: str, what: str, r: dict, extra: str = "") -> str:
    lv = r["summary"]["liveness"]
    split = ""
    if r.get("round_ms"):
        rm = r["round_ms"]
        split = (f"; {phase_ms(rm, *SIEGE_ROUNDS)} ms/round over the siege (rounds 6-45), "
                 f"{phase_ms(rm, 46, 55)} over the aftermath (46-55), {phase_ms(rm, 1, 5)} before it")
    return fault_line(card, what, r, f"{split}; liveness {json.dumps(lv)}{extra}")


def phase_quorum(root: Path, dev, card: str, n_big: int = N_HEADLINE) -> dict:
    """Phase 9: the quorum detector and the Byzantine adversaries through
    the CLI, launches counted from 0 a run. 9a the JAX pins at n <= 20000:
    config 2 at quorum 3 (the unhardened run's state, every silent peer
    declared at round 8) and the n=20000 siege at quorum 3 and 1, packed,
    on the staircase, sharded, and on PA push with config 5's churn; 9b the
    siege on the 1M matching headline at quorum 3 (onto the JAX pin,
    eviction precision at least 0.95), its packed twin, and at quorum 1
    (false evictions, as the reference's single-report purge makes them),
    ms/round over the siege and the aftermath apart; 9c the siege at 1M on
    the sharded K6 path with its scatter twin and on the staircase (K5),
    and the n=20000 siege killed after its round-8 checkpoint (suspicions
    open) and resumed on the other device, both ways, onto the pin.
    Returns the figures by part. ``n_big`` replaces the 1M runs' peer
    count (the pin is checked only at 1M)."""
    import shutil
    import tempfile

    refs = json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
    pins = [r for r in refs if quorum_pin(r)]
    out = {}

    # 9a: the small pins
    t0 = time.perf_counter()
    for ref in pins:
        if ref["argv"][1] == "1000000":
            continue
        argv = [a for a in ref["argv"] if a != "--quiet"]
        r = cli_here(argv, dev)
        what = (f"9a n={argv[1]} {quorum_path(argv)}{' with config 5 churn' if '--churn-join' in argv else ''}, "
                f"quorum {r['summary']['liveness']['quorum_k']}")
        check_pin(r["summary"], ref, what)
        check_quorum_launches(what, argv, r)
        if "--silent-frac" in argv:
            i = ref["argv"].index("--quorum-k")
            plain = [p for p in refs if p["argv"] == ref["argv"][:i] + ref["argv"][i + 2:]][0]
            dead = [row["n_declared_dead"] for row in r["rows"]]
            if r["summary"]["state_digest"] != plain["summary"]["state_digest"] or dead[:7] != [0] * 7 or (
                    dead[7:] != [100] * (len(dead) - 7)):
                raise AssertionError(f"{what}: state {r['summary']['state_digest']} (unhardened "
                                     f"{plain['summary']['state_digest']}), dead by round {dead}")
            what += f", dead by round {dead}, the unhardened run's state"
        print(quorum_line(card, what, r, "; equal to the JAX pin"), flush=True)
        del r
    out["9a"] = dict(seconds=time.perf_counter() - t0)

    # 9b: the 1M headline under the siege
    t0 = time.perf_counter()
    big = ["--peers", str(n_big), "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--digest", "--quiet",
           "--slots", "16", *SIEGE, "--quorum-k", "3", "--rounds", "56"]
    pin = {" ".join(p["argv"]): p for p in pins}.get(" ".join(big))
    if pin is None and n_big == N_HEADLINE:
        raise AssertionError(f"no JAX pin for {' '.join(big)}")
    runs = {}
    for what, argv in (("quorum 3", big), ("quorum 3 packed", big + ["--packed"]),
                       ("quorum 1", big[:-4] + ["--quorum-k", "1", "--rounds", "56"])):
        r = runs[what] = cli_here(argv, dev, marks=True)
        check_quorum_launches(f"9b {what}", argv, r)
        lv = r["summary"]["liveness"]
        if what == "quorum 3":
            if pin is not None:
                check_pin(r["summary"], pin, "9b quorum 3")
            if lv["eviction_precision"] < 0.95 or lv["quarantined"] == 0:
                raise AssertionError(f"9b quorum 3: eviction precision {lv['eviction_precision']}, "
                                     f"{lv['quarantined']} quarantined")
        elif what == "quorum 3 packed":
            same_run(runs["quorum 3"], r, "9b packed twin")
        elif lv["false_evictions"] == 0:
            raise AssertionError("9b quorum 1: no false eviction; the single-report purge evicts healthy peers")
        out[f"9b {what}"] = dict(horizon=r["horizon"], siege_ms=phase_ms(r["round_ms"], *SIEGE_ROUNDS),
                                 aftermath_ms=phase_ms(r["round_ms"], 46, 55), liveness=lv)
        extra = ("; digests equal the JAX pin" if what == "quorum 3" and pin is not None else
                 ", digest-equal to quorum 3" if what == "quorum 3 packed" else "")
        print(quorum_line(card, f"9b the byzantine siege at n={n_big} on the matching headline, {what} (56 rounds)",
                          r, extra), flush=True)
    del runs, r
    out["9b"] = dict(seconds=time.perf_counter() - t0)

    # 9c: the other engines at 1M, then a checkpoint cut mid-siege
    t0 = time.perf_counter()
    csr = ["--peers", str(n_big), "--graph", "chung-lu", "--mode", "push_pull", "--fanout", "1", "--digest", "--quiet",
           *SIEGE, "--quorum-k", "3", "--rounds", "56"]
    twins = {}
    for what, argv in (("sharded staircase", csr + ["--shard", "--staircase"]), ("sharded scatter", csr + ["--shard"]),
                       ("staircase", csr + ["--staircase"])):
        r = twins[what] = cli_here(argv, dev)
        check_quorum_launches(f"9c {what}", argv, r)
        if what == "sharded scatter":
            same_run(twins["sharded staircase"], r, "9c scatter twin")
        if r["summary"]["liveness"]["eviction_precision"] < 0.95:
            raise AssertionError(f"9c {what}: eviction precision {r['summary']['liveness']['eviction_precision']}")
        out[f"9c {what}"] = dict(horizon=r["horizon"], liveness=r["summary"]["liveness"])
        print(quorum_line(card, f"9c the siege at n={n_big} on Chung-Lu, {what}, quorum 3 (56 rounds)", r,
                          ", digest-equal to the K6 run" if what == "sharded scatter" else ""), flush=True)
    del twins, r
    from tpu_gossip_torch.ckpt import load_checkpoint

    small = [p for p in pins if p["argv"][1] == "20000" and "matching" in p["argv"] and "--packed" not in p["argv"]
             and p["summary"]["liveness"]["quorum_k"] == 3][0]
    opened = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-quorum-") as tmp:
        tmp = Path(tmp)

        def leg(write_on, resume_on):
            d = tmp / write_on
            kill_at(root, small["argv"] + ["--checkpoint-every", "4", "--checkpoint-dir", str(d), "--device",
                                           write_on], "checkpoint: wrote ckpt-00000008")
            for late in range(12, 56, 4):
                shutil.rmtree(d / f"ckpt-{late:08d}", ignore_errors=True)
            mid = load_checkpoint(d / "ckpt-00000008", device="cpu")[0]
            opened[write_on] = int((mid.suspect_round >= 0).sum())
            if opened[write_on] == 0:
                raise AssertionError("9c: ckpt-00000008 holds no open suspicion; the resume would not be mid-siege")
            summary, err = cli_run(root, ["resume", str(d), "--device", resume_on], f"9c {write_on} resume")
            if "resume: ckpt-00000008 at round 8" not in err:
                raise AssertionError(f"9c: the resume did not start from ckpt-00000008: {err[-2000:]}")
            check_pin(summary, small, f"9c {write_on}->{resume_on}")

        both_ways(leg)
    out["9c"] = dict(seconds=time.perf_counter() - t0, open_suspicions=opened)
    print(f"[{card}] 9c the n=20000 siege at quorum 3 killed after ckpt-00000008 ({opened} open suspicions) on the "
          f"card and resumed on the CPU, and the reverse, both onto the JAX pin (liveness and phases included)",
          flush=True)
    return out


# ------------------------------------------------------------ phase 10: growth

GROW_BIG = ["--graph", "matching", "--peers", "950000", "--grow", "1000000", "--grow-rate", "256", "--rounds", "32",
            "--mode", "push_pull", "--fanout", "1", "--digest", "--quiet"]
BENCH_GROW = dict(n0=950_000, target=1_000_000, rate=256, attach=3)  # bench.py::bench_grow's configuration
BENCH_GROW_ROUNDS = 32  # of its 197-round schedule: the script's time limit


def growth_launches(argv: list[str], rounds: int) -> dict:
    """The kernel launches a growing CLI run makes over its horizon: its
    delivery path's kernels once a round (K1 checked apart), no other."""
    packed = "--packed" in argv
    tail = {"round_tail": 0 if packed else rounds, "round_tail_words": rounds if packed else 0}
    if "matching" in argv:
        return {"fold_planes_or": rounds, "staircase_segment": 0, "stream_segment": 0, **tail}
    k5 = rounds if "--staircase" in argv and "--shard" not in argv else 0
    k6 = rounds if "--staircase" in argv and "--shard" in argv else 0
    return {"lane_shuffle": 0, "fold_planes_or": 0, "staircase_segment": k5, "stream_segment": k6, **tail}


def check_growth_run(what: str, argv: list[str], r: dict) -> None:
    rounds = int(argv[argv.index("--rounds") + 1])
    check_counts(what, r["launches"], growth_launches(argv, rounds))
    if "matching" in argv and r["launches"]["lane_shuffle"] == 0:
        raise AssertionError(f"{what}: the matching path launched no K1")


def growth_line(card: str, what: str, r: dict, extra: str = "") -> str:
    s = r["summary"]
    grown = {k: s[k] for k in ("n_members", "grow_rate", "degree_gamma")}
    rm = ""
    if r.get("round_ms"):
        rm = f"; {sum(r['round_ms']) / len(r['round_ms'])} ms/round by CUDA events a round"
    return fault_line(card, what, r, f"; growth {grown}{rm}{extra}")


def timed_rounds(dev, step, state, rounds: int) -> tuple:
    """``rounds`` calls of ``step`` from ``state``, a CUDA event after each:
    the final state and stats, the ms of each round, the device peak over
    them (reset as they start) and the bytes allocated at their start."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    ev = [torch.cuda.Event(enable_timing=True)]
    ev[0].record()
    rows = []
    for _ in range(rounds):
        state, st = step(state)
        rows.append(st)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
    torch.cuda.synchronize(dev)
    from tpu_gossip_torch.sim.engine import _stack

    return state, _stack(rows), [a.elapsed_time(b) for a, b in zip(ev, ev[1:])], \
        torch.cuda.max_memory_allocated(dev), start


def grow_vs_fixed(dev, graph, cfg, state, grow, plan, rounds: int) -> dict:
    """The same capacity-padded state run ``rounds`` rounds growing and with
    ``growth=None``, as bench_grow prices it: each run's final state, ms a
    round and device peak, and its launches counted from 0."""
    from tpu_gossip_torch.core.state import clone_state
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim import engine

    out = {}
    for what, g in (("growing", grow), ("fixed", None)):
        native.reset_launches()
        fin, stats, ms, peak, start = timed_rounds(
            dev, lambda s: engine.gossip_round(s, cfg, plan, growth=g), clone_state(state), rounds)
        out[what] = dict(fin=fin, stats=stats, ms=ms, ms_per_round=sum(ms) / len(ms), peak=peak, start=start,
                         launches=dict(native.LAUNCHES))
    return out


def run_growth_profile(root: Path, card: str) -> dict:
    """``sim.profile --grow`` on 10b's configuration: the growth stage row
    and its split, the growing and plain rounds, and the traced round."""
    proc = subprocess.run([sys.executable, "-m", "tpu_gossip_torch.sim.profile", "--peers", "950000", "--grow",
                           "1000000", "--grow-rate", "256", "--warm", "8", "--rounds", "3", "--reps", "5"], cwd=root,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"sim.profile --grow exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    stages, trace = lines[0]["stage_ms"], lines[1]["trace"]
    for key in ("growth", "growth_draw", "growth_top_k", "growth_scatters", "growth_round", "plain_round"):
        if key not in stages:
            raise AssertionError(f"sim.profile --grow printed no {key} row: {stages}")
    print(f"[{card}] 10b sim.profile --grow (n=950000 -> 1000000, 256 joins a round, 8 warm rounds): growth stage "
          f"{stages['growth']} ms (draw {stages['growth_draw']}, top-k {stages['growth_top_k']}, cursor, log degrees "
          f"and scatters {stages['growth_scatters']}; {stages['growth_chunk_rows']} rows a draw chunk), growing round "
          f"{stages['growth_round']} ms, the same round without growth {stages['plain_round']} ms; every stage "
          f"{stages}; traced: {trace['wall_ms_per_round']} ms/round wall, {trace['device_ms_per_round']} ms device, "
          f"busy {trace['device_busy_share']}, top kernels {trace['top_kernels_ms_per_round'][:8]}", flush=True)
    return dict(stages=stages, trace={k: v for k, v in trace.items() if k != "top_kernels_ms_per_round"})


def phase_growth(root: Path, dev, card: str) -> dict:
    """Phase 10: growth on the card. 10a the JAX pins at n <= 20000 through
    the CLI (every engine, join_burst waves under flash-crowd-under-fire),
    launches counted from 0 a run; 10b the 1M matching headline growing
    (950000 -> 1000000, 256 joins a round, 32 rounds) onto its JAX pin,
    its packed twin digest-equal, the same capacity-padded state growing
    and fixed-n (ms/round and peaks), and ``sim.profile --grow``; 10c
    bench_grow's configuration for the first ``BENCH_GROW_ROUNDS`` rounds of
    its schedule (the device power-law graph of 950000 padded to 1000001
    rows, exactly-k delivery), membership at 950000 plus 256 a round and
    the device gamma track within 1e-3 of the host fit; 10d the n=20000 matching pin killed after its mid-growth
    round-8 checkpoint and resumed on the other device, both ways."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.growth import compile_growth, matching_admit_rows, pad_graph_for_growth
    from tpu_gossip_torch.growth.engine import DRAW_CHUNK_WORDS, draw_chunk_rows, realized_degrees
    from tpu_gossip_torch.utils.digest import state_digest

    refs = json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
    pins = [r for r in refs if growth_pin(r)]
    out = {}

    # 10a: the small pins, every engine
    t0 = time.perf_counter()
    for ref in pins:
        if ref["argv"][ref["argv"].index("--peers") + 1] != "20000":
            continue
        argv = [a for a in ref["argv"] if a != "--quiet"]
        r = cli_here(argv, dev)
        what = f"10a run_sim {' '.join(a for a in argv if a != '--digest')}"
        check_pin(r["summary"], ref, what)
        check_growth_run(what, argv, r)
        print(growth_line(card, what, r, "; equal to the JAX pin"), flush=True)
        del r
    out["10a"] = dict(seconds=time.perf_counter() - t0)

    # 10b: the 1M matching headline growing, its packed twin, and the same
    # state growing and fixed-n
    t0 = time.perf_counter()
    pin = {" ".join(p["argv"]): p for p in pins}[" ".join(GROW_BIG)]
    runs = {}
    for what, argv in (("growing", GROW_BIG), ("growing packed", GROW_BIG + ["--packed"])):
        r = runs[what] = cli_here(argv, dev, marks=True)
        check_growth_run(f"10b {what}", argv, r)
        if what == "growing":
            check_pin(r["summary"], pin, "10b")
            if r["launches"]["fold_planes_sum"] != 1:
                raise AssertionError(f"10b: the plan build launched fold_planes_sum {r['launches']['fold_planes_sum']} "
                                     "times, needs 1")
        else:
            same_run(runs["growing"], r, "10b packed twin")
        print(growth_line(card, f"10b the matching headline growing 950000 -> 1000000, 256 joins a round, {what} "
                                f"(32 rounds)", r, "; digests equal the JAX pin" if what == "growing" else
                          ", digest-equal to the unpacked run"), flush=True)
        out[f"10b cli {what}"] = dict(horizon=r["horizon"], launches=r["launches"],
                                      ms_per_round=sum(r["round_ms"]) / len(r["round_ms"]))
    cli_digest = runs["growing"]["summary"]["state_digest"]
    del runs, r
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded

    dgraph, plan = matching_powerlaw_graph_sharded(950_000, 1, fanout=1, key=prng.key(0, dev), growth_rows=50_000,
                                                   device=dev)
    graph = dgraph.as_padded_graph()
    cfg = SwarmConfig(n_peers=graph.n, msg_slots=M_SLOTS, fanout=1, mode="push_pull", rewire_slots=3)
    origins = np.random.default_rng(0).choice(950_000, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=dgraph.exists, device=dev)
    grow = compile_growth(n_initial=950_000, target=1_000_000, n_slots=graph.n, joins_per_round=256, attach_m=3,
                          admit_rows=matching_admit_rows(plan, 50_000), device=dev)
    pair = grow_vs_fixed(dev, graph, cfg, state, grow, plan, 32)
    if state_digest(pair["growing"]["fin"]) != cli_digest:
        raise AssertionError("10b: the library's growing run differs from the CLI's")
    chunk = draw_chunk_rows(graph.n, dev)
    for what in ("growing", "fixed"):
        p = pair[what]
        out[f"10b {what}"] = {k: v for k, v in p.items() if k not in ("fin", "stats", "ms")}
        chunk_text = (f"; draw chunk {chunk} rows of {graph.n} (DRAW_CHUNK_WORDS {DRAW_CHUNK_WORDS['cuda']})"
                      if what == "growing" else "")
        print(f"[{card}] 10b the same capacity-padded state (n_state {graph.n}), {what}: {p['ms_per_round']} "
              f"ms/round over 32 rounds (each {p['ms']}), peak {p['peak']} B from {p['start']} B at the start; "
              f"launches {({k: v for k, v in p['launches'].items() if v})}{chunk_text}", flush=True)
    print(f"[{card}] 10b growing/fixed: {pair['growing']['ms_per_round'] / pair['fixed']['ms_per_round']}x the "
          f"ms/round, peak {pair['growing']['peak'] - pair['fixed']['peak']} B above; the library's growing run "
          f"equals the CLI's digest", flush=True)
    del pair, state, plan, dgraph, graph
    out["10b profile"] = run_growth_profile(root, card)
    out["10b"] = dict(seconds=time.perf_counter() - t0)

    # 10c: bench_grow's configuration, the first BENCH_GROW_ROUNDS rounds of its schedule
    t0 = time.perf_counter()
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
    from tpu_gossip_torch.core.topology import fit_powerlaw_gamma

    b = BENCH_GROW
    dg = device_powerlaw_graph(b["n0"], gamma=2.5, key=prng.key(0, dev), device=dev)
    cap = b["target"] + 1  # and the device graph's sentinel row
    graph, pad_exists = pad_graph_for_growth(dg.as_padded_graph(), cap)
    # the sentinel stays a non-member and is never admitted: admission starts past it
    pad_exists[: b["n0"] + 1] = dg.exists.cpu().numpy()
    cfg = SwarmConfig(n_peers=cap, msg_slots=M_SLOTS, fanout=1, mode="push_pull", rewire_slots=b["attach"])
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=np.arange(M_SLOTS), origin_slots=np.arange(M_SLOTS),
                       exists=torch.from_numpy(pad_exists).to(dev), device=dev)
    grow = compile_growth(n_initial=b["n0"] + 1, target=cap, n_slots=cap, joins_per_round=b["rate"],
                          attach_m=b["attach"], device=dev)
    rounds = BENCH_GROW_ROUNDS
    pair = grow_vs_fixed(dev, graph, cfg, state, grow, None, rounds)
    fin, stats = pair["growing"]["fin"], pair["growing"]["stats"]
    members = int(fin.exists.sum())
    deg = realized_degrees(fin.row_ptr, fin.exists, fin.rewired, fin.rewire_targets, fin.degree_credit).cpu().numpy()
    host_gamma = fit_powerlaw_gamma(deg[fin.exists.cpu().numpy()])
    dev_gamma = float(stats.degree_gamma[-1])
    check_counts("10c growing", pair["growing"]["launches"], {"lane_shuffle": 0, "fold_planes_or": 0,
                                                              "round_tail": rounds, "staircase_segment": 0})
    if members != b["n0"] + rounds * b["rate"] or abs(dev_gamma - host_gamma) > 1e-3:
        raise AssertionError(f"10c: {members} members (want {b['n0'] + rounds * b['rate']}), device gamma "
                             f"{dev_gamma} against the host fit {host_gamma}")
    for what in ("growing", "fixed"):
        p = pair[what]
        out[f"10c {what}"] = {k: v for k, v in p.items() if k not in ("fin", "stats", "ms")}
    out["10c"] = dict(members=members, device_gamma=dev_gamma, host_gamma=host_gamma, rounds=rounds)
    print(f"[{card}] 10c bench_grow's configuration (device power-law graph n0={b['n0']} padded to {cap} rows, "
          f"{b['rate']} joins a round, attach {b['attach']}, exactly-k push_pull, {rounds} rounds): n_members "
          f"{members}, device degree_gamma {dev_gamma} against the host fit {host_gamma} (|diff| "
          f"{abs(dev_gamma - host_gamma)}); growing {pair['growing']['ms_per_round']} ms/round, peak "
          f"{pair['growing']['peak']} B; fixed-n {pair['fixed']['ms_per_round']} ms/round, peak {pair['fixed']['peak']} "
          f"B; launches {({k: v for k, v in pair['growing']['launches'].items() if v})}", flush=True)
    del pair, fin, state, graph, dg
    out["10c"]["seconds"] = time.perf_counter() - t0

    # 10d: a mid-growth checkpoint killed and resumed on the other device
    t0 = time.perf_counter()
    from tpu_gossip_torch.ckpt import load_checkpoint

    small = [p for p in pins if p["argv"][1] == "20000" and "matching" in p["argv"] and "--packed" not in p["argv"]
             and "--scenario" not in p["argv"]][0]
    members = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-growth-") as tmp:
        tmp = Path(tmp)

        def leg(write_on, resume_on):
            d = tmp / write_on
            kill_at(root, small["argv"] + ["--checkpoint-every", "4", "--checkpoint-dir", str(d), "--device",
                                           write_on], "checkpoint: wrote ckpt-00000008")
            for late in range(12, 20, 4):
                shutil.rmtree(d / f"ckpt-{late:08d}", ignore_errors=True)
            mid = load_checkpoint(d / "ckpt-00000008", device="cpu")[0]
            members[write_on] = int(mid.exists.sum())
            if not 20_000 < members[write_on] < int(small["argv"][small["argv"].index("--grow") + 1]):
                raise AssertionError(f"10d: ckpt-00000008 holds {members[write_on]} members; not mid-growth")
            summary, err = cli_run(root, ["resume", str(d), "--device", resume_on], f"10d {write_on} resume")
            if "resume: ckpt-00000008 at round 8" not in err:
                raise AssertionError(f"10d: the resume did not start from ckpt-00000008: {err[-2000:]}")
            check_pin(summary, small, f"10d {write_on}->{resume_on}")

        both_ways(leg)
    out["10d"] = dict(seconds=time.perf_counter() - t0, members=members)
    print(f"[{card}] 10d the n=20000 matching pin ({' '.join(small['argv'])}) killed after ckpt-00000008 "
          f"({members} members) on "
          f"the card and resumed on the CPU, and the reverse, both onto the JAX pin", flush=True)
    return out


# ------------------------------------------------------------ phase 11: streams

STREAM_BIG = ["--peers", "1000000", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--stream", "4",
              "--stream-burst-every", "6", "--slot-ttl", "24", "--rounds", "48", "--digest", "--quiet"]
BENCH_STREAM = dict(n=1_000_000, rates=(0.5, 1.5, 4.0), msg_slots=32, fanout=2, measure=96)  # bench.py::bench_stream


def stream_line(card: str, what: str, r: dict, extra: str = "") -> str:
    s = r["summary"]["stream"]
    keys = ("msgs_offered", "msgs_injected", "msgs_conflated", "msgs_expired", "delivery_ratio", "conflation_rate",
            "episodes_completed", "rounds_to_coverage")
    rm = ""
    if r.get("round_ms"):
        rm = f"; {sum(r['round_ms']) / len(r['round_ms'])} ms/round by CUDA events a round"
    return fault_line(card, what, r, f"; stream {({k: s[k] for k in keys})}{rm}{extra}")


def check_stream_run(what: str, argv: list[str], r: dict) -> None:
    """A streamed CLI run's path launches (its tail once a round, every
    round carrying the stream's expired mask), and an age-out that bit."""
    check_growth_run(what, argv, r)
    expired = sum(row["stream_expired"] for row in r["rows"]) if r["rows"] else r["summary"]["stream"]["msgs_expired"]
    if expired <= 0:
        raise AssertionError(f"{what}: no lease aged out, so the tail never saw a live expired mask")


def check_stream_prng(dev) -> dict:
    """``prng.poisson`` on the card over both branches and ``lgamma32``
    over the integers 1..2^24 give the CPU's bits; the draws per second."""
    from tpu_gossip_torch.core import prng

    x = torch.arange(1, (1 << 24) + 1, dtype=torch.float32)
    gx = x.to(dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = prng.lgamma32(gx)
    torch.cuda.synchronize(dev)
    lg_s = time.perf_counter() - t0
    if not torch.equal(got.cpu().view(torch.int32), prng.lgamma32(x).view(torch.int32)):
        raise AssertionError("11: lgamma32 on the card differs from the CPU's on the integers 1..2^24")
    gen = torch.Generator().manual_seed(11)
    keys = torch.randint(0, 2 ** 32, (4096, 2), generator=gen, dtype=torch.int64)
    for rate in (0.5, 4.0, 9.999999, 10.0, 16.0, 400.0):
        lam = torch.full((4096,), rate, dtype=torch.float32)
        if not torch.equal(prng.poisson(keys.to(dev), lam.to(dev)).cpu(), prng.poisson(keys, lam)):
            raise AssertionError(f"11: poisson on the card differs from the CPU's at rate {rate}")
    return dict(lgamma_s=lg_s)


def live_mask_tails(dev, cfg, state, strm, step) -> dict:
    """K3 and K4 against their plain versions with a real age-out mask: the
    first round at or after ``state`` whose lease table expires a slot."""
    from tpu_gossip_torch.core.packed import pack_bits
    from tpu_gossip_torch.kernels.round_tail import round_tail, round_tail_words, tail_fused, tail_words_plain
    from tpu_gossip_torch.sim import engine
    from tpu_gossip_torch.traffic import slot_expiry

    for _ in range(30):
        expired = slot_expiry(state.slot_lease, state.round + 1, strm.ttl)
        if bool(expired.any()):
            break
        state = step(state)[0]
    else:
        raise AssertionError("11c: no lease aged out in 30 rounds")
    _, transmitter, receptive = engine.compute_roles(state)
    transmit = engine.transmit_bitmap(state, cfg, transmitter)
    planes = (state.seen, state.forwarded, state.infected_round, state.recovered, state.seen, receptive, transmit,
              None, state.round + 1)
    m = state.seen.shape[1]
    err = 0
    for fo, sir in ((False, 0), (True, 4)):
        kw = dict(forward_once=fo, sir_recover_rounds=sir, expired=expired)
        for a, b in zip(round_tail(*planes, impl="fused", **kw), tail_fused(*planes, **kw)):
            err = max(err, max_err(a, b))
        words = [pack_bits(p) if p is not None and p.dtype == torch.bool and p.dim() == 2 else p for p in planes]
        for a, b in zip(round_tail_words(*words, m=m, **kw), tail_words_plain(*words, m=m, age_saturated=False, **kw)):
            err = max(err, max_err(a, b))
    return dict(err=err, round=int(state.round) + 1, expired_slots=int(expired.sum()))


def stream_rounds(dev, cfg, state, strm, rounds: int) -> dict:
    """``rounds`` rounds from a copy of ``state`` under ``strm`` (None: the
    unloaded run), the round and key mirrored on the host as the horizon
    loops mirror them, launches counted from 0: the final state, stats,
    ms a round by CUDA events and the device peak."""
    from tpu_gossip_torch.core.state import clone_state
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim import engine
    from tpu_gossip_torch.sim.stages import next_host_key

    cursor = {"round": int(state.round), "key": state.rng.cpu() if strm is not None else None}

    def step(s):
        out = engine.gossip_round(s, cfg, None, stream=strm, host_round=cursor["round"], host_rng=cursor["key"])
        cursor["round"] += 1
        cursor["key"] = next_host_key(cursor["key"])
        return out

    native.reset_launches()
    fin, stats, ms, peak, start = timed_rounds(dev, step, clone_state(state), rounds)
    return dict(fin=fin, stats=stats, ms=ms, ms_per_round=sum(ms) / len(ms), peak=peak, start=start,
                launches=dict(native.LAUNCHES), step=step)


def run_stream_profile(root: Path, card: str) -> dict:
    """``sim.profile --stream 4`` on 11c's configuration: the stream's stage
    rows on a loaded state, the loaded and plain rounds, the traced round."""
    proc = subprocess.run([sys.executable, "-m", "tpu_gossip_torch.sim.profile", "--peers", "1000000", "--graph",
                           "device", "--stream", "4", "--warm", "40", "--rounds", "3", "--reps", "5"], cwd=root,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"sim.profile --stream exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    stages, trace = lines[0]["stage_ms"], lines[1]["trace"]
    for key in ("stream_ageout", "stream_inject", "stream_poisson_host", "stream_draws", "stream_landing",
                "stream_scatter", "slot_stats", "stream_round", "plain_round"):
        if key not in stages:
            raise AssertionError(f"sim.profile --stream printed no {key} row: {stages}")
    print(f"[{card}] 11c sim.profile --stream 4 (device power-law graph n=1000000, 32 slots, fanout 2, TTL "
          f"{lines[0]['slot_ttl']}, 40 warm rounds, {stages['stream_arrivals']} arrivals in the profiled round): "
          f"stream_ageout {stages['stream_ageout']} ms, stream_inject {stages['stream_inject']} ms (Poisson count on "
          f"the host {stages['stream_poisson_host']} ms wall, origin and slot draws {stages['stream_draws']}, "
          f"landing {stages['stream_landing']}, scatter {stages['stream_scatter']}), slot_stats "
          f"{stages['slot_stats']} ms, stream_round {stages['stream_round']} ms against plain_round "
          f"{stages['plain_round']} ms; every stage {stages}; traced: {trace['wall_ms_per_round']} ms/round wall, "
          f"{trace['device_ms_per_round']} ms device, busy {trace['device_busy_share']}, top kernels "
          f"{trace['top_kernels_ms_per_round'][:8]}", flush=True)
    return dict(stages=stages, trace={k: v for k, v in trace.items() if k != "top_kernels_ms_per_round"})


def phase_stream(root: Path, dev, card: str) -> dict:
    """Phase 11: the streaming plane on the card. First ``prng.poisson``
    and ``lgamma32`` against the CPU's bits. 11a the JAX stream pins at
    n <= 20000 through the CLI on every engine (matching and its packed
    twin, Chung-Lu exactly-k with the degree law and two Bloom planes, PA
    with the hotspot law, the Chung-Lu staircase with bursts, the bucketed
    mesh with K6 and its packed twin, the staircase remat loop under churn,
    flash-crowd-under-fire with growth), launches counted from 0 a run and
    an age-out in each; 11b the 1M matching headline under a stream (rate
    4, bursts every 6, TTL 24, 48 rounds) onto its JAX pin and its packed
    twin digest-equal; 11c ``bench.py::bench_stream``'s configuration at
    full width (the 1M device power-law graph, 32 slots, fanout 2,
    exactly-k push_pull, TTL 25, a batch of 16) at rates 0.5, 1.5 and 4.0,
    each 25 warm and 96 measured rounds beside the unloaded run on the same
    state, K3 and K4 against their plain versions under a live age-out
    mask, and ``sim.profile --stream 4``; 11d the n=20000 matching pin
    killed after its round-24 checkpoint (leases live, expiries past) and
    resumed on the other device, both ways."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim import metrics as SM
    from tpu_gossip_torch.traffic import compile_stream, default_max_inject, min_feasible_ttl

    refs = json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
    pins = [r for r in refs if stream_pin(r)]
    out = {}

    t0 = time.perf_counter()
    out["11 prng"] = check_stream_prng(dev)
    print(f"[{card}] 11 prng.poisson (both branches, 4096 keys at six rates) and lgamma32 (the integers 1..2^24, "
          f"{out['11 prng']['lgamma_s']} s on the card) equal the CPU's bits", flush=True)

    # 11a: the small pins, every engine
    for ref in pins:
        if ref["argv"][ref["argv"].index("--peers") + 1] == "1000000":
            continue
        argv = [a for a in ref["argv"] if a != "--quiet"]
        r = cli_here(argv, dev)
        what = f"11a run_sim {' '.join(a for a in argv if a != '--digest')}"
        check_pin(r["summary"], ref, what)
        check_stream_run(what, argv, r)
        print(stream_line(card, what, r, "; equal to the JAX pin"), flush=True)
        del r
    out["11a"] = dict(seconds=time.perf_counter() - t0)

    # 11b: the 1M matching headline under a stream, and its packed twin
    t0 = time.perf_counter()
    pin = {" ".join(p["argv"]): p for p in pins}[" ".join(STREAM_BIG)]
    runs = {}
    for what, argv in (("streamed", STREAM_BIG), ("streamed packed", STREAM_BIG + ["--packed"])):
        r = runs[what] = cli_here(argv, dev, marks=True)
        check_stream_run(f"11b {what}", argv, r)
        if what == "streamed":
            check_pin(r["summary"], pin, "11b")
        else:
            same_run(runs["streamed"], r, "11b packed twin")
        print(stream_line(card, f"11b the 1M matching headline under a stream (rate 4, bursts x4 every 6 rounds, TTL "
                                f"24, 48 rounds), {what}", r, "; digests equal the JAX pin" if what == "streamed"
                          else ", digest-equal to the unpacked run"), flush=True)
        out[f"11b {what}"] = dict(horizon=r["horizon"], launches=r["launches"],
                                  ms_per_round=sum(r["round_ms"]) / len(r["round_ms"]))
    del runs, r
    out["11b"] = dict(seconds=time.perf_counter() - t0)

    # 11c: bench_stream's configuration at full width: the saturation curve
    t0 = time.perf_counter()
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph

    b = BENCH_STREAM
    dg = device_powerlaw_graph(b["n"], gamma=2.5, key=prng.key(0, dev), device=dev)
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=b["msg_slots"], fanout=b["fanout"], mode="push_pull")
    state = init_swarm(dg.as_padded_graph(), cfg, exists=dg.exists, key=prng.key(0, dev), device=dev)
    ttl = int(1.5 * min_feasible_ttl(b["n"], b["fanout"]))
    batch = default_max_inject(max(b["rates"]))
    rows = np.flatnonzero(dg.exists.cpu().numpy())
    horizon = ttl + b["measure"]
    unloaded = stream_rounds(dev, cfg, state, None, horizon)
    check_launches("11c unloaded", unloaded["launches"], XLA_PATH, horizon)
    out["11c unloaded"] = dict(ms_per_round=unloaded["ms_per_round"], peak=unloaded["peak"])
    print(f"[{card}] 11c bench_stream's configuration (device power-law graph n={b['n']}, {b['msg_slots']} slots, "
          f"fanout {b['fanout']}, exactly-k push_pull, TTL {ttl}, batch {batch}, {ttl} warm + {b['measure']} measured "
          f"rounds), unloaded: {unloaded['ms_per_round']} ms/round by CUDA events, peak {unloaded['peak']} B "
          f"(from {unloaded['start']} B at the start); launches "
          f"{({k: v for k, v in unloaded['launches'].items() if v})}", flush=True)
    del unloaded
    for rate in b["rates"]:
        strm = compile_stream(rate=rate, msg_slots=b["msg_slots"], ttl=ttl, origin_rows=rows, max_inject=batch,
                              device=dev)
        r = stream_rounds(dev, cfg, state, strm, horizon)
        check_launches(f"11c rate {rate}", r["launches"], XLA_PATH, horizon)
        rep = SM.steady_state_report(r["stats"], target=0.99, round_seconds=cfg.round_seconds, warmup_rounds=ttl)
        offered, injected = int(r["stats"].stream_offered.sum()), int(r["stats"].stream_injected.sum())
        expired = int(r["stats"].stream_expired.sum())
        if injected != offered or expired <= 0 or not 0 <= rep["delivery_ratio"] <= 1:
            raise AssertionError(f"11c rate {rate}: offered {offered}, injected {injected} (k=1, every peer up: "
                                 f"equal), {expired} leases aged out, delivery ratio {rep['delivery_ratio']}")
        if abs(rep["offered_per_round"] - rate) > 5 * (rate / b["measure"]) ** 0.5:
            raise AssertionError(f"11c rate {rate}: {rep['offered_per_round']} offered a round")
        row = dict(rate=rate, ms_per_round=r["ms_per_round"], peak=r["peak"], k3_launches=r["launches"]["round_tail"],
                   **{k: rep[k] for k in ("delivered_per_round", "delivered_msgs_per_sec", "offered_per_round",
                                          "delivery_ratio", "conflation_rate", "episodes_completed")},
                   p50=rep["rounds_to_coverage"]["p50"], p99=rep["rounds_to_coverage"]["p99"], expired=expired)
        out[f"11c rate {rate}"] = row
        print(f"[{card}] 11c rate {rate} msgs/round: {row['ms_per_round']} ms/round loaded against "
              f"{out['11c unloaded']['ms_per_round']} unloaded (CUDA events, the host's Poisson count and the "
              f"landing's launches included); delivered_per_round {row['delivered_per_round']}, delivered "
              f"{row['delivered_msgs_per_sec']} msgs/s at 5 s rounds, offered_per_round {row['offered_per_round']}, "
              f"delivery_ratio {row['delivery_ratio']}, conflation_rate {row['conflation_rate']}, rounds to 99% "
              f"p50 {row['p50']} p99 {row['p99']}, episodes_completed {row['episodes_completed']}, {expired} leases "
              f"aged out, max_memory_allocated {row['peak']} B, K3 launches {row['k3_launches']} ({horizon} rounds)",
              flush=True)
        if rate == max(b["rates"]):
            tails = live_mask_tails(dev, cfg, r["fin"], strm, r["step"])
            if tails["err"] != 0:
                raise AssertionError(f"11c: K3/K4 under the live age-out mask differ from their plain versions: {tails}")
            out["11c live mask"] = tails
            print(f"[{card}] 11c K3 and K4 equal their plain versions under the live age-out mask of round "
                  f"{tails['round']} ({tails['expired_slots']} slots recycled), forward-once and SIR on and off",
                  flush=True)
        del r
    del state, dg
    out["11c profile"] = run_stream_profile(root, card)
    out["11c"] = dict(seconds=time.perf_counter() - t0)

    # 11d: a mid-stream checkpoint killed and resumed on the other device
    t0 = time.perf_counter()
    from tpu_gossip_torch.ckpt import load_checkpoint

    small = [p for p in pins if p["argv"][1] == "20000" and "matching" in p["argv"] and "--packed" not in p["argv"]][0]
    leases = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        tmp = Path(tmp)

        def leg(write_on, resume_on):
            d = tmp / write_on
            kill_at(root, small["argv"] + ["--checkpoint-every", "12", "--checkpoint-dir", str(d), "--device",
                                           write_on], "checkpoint: wrote ckpt-00000024")
            shutil.rmtree(d / "ckpt-00000036", ignore_errors=True)
            mid = load_checkpoint(d / "ckpt-00000024", device="cpu")[0]
            leases[write_on] = int((mid.slot_lease >= 0).sum())
            if leases[write_on] == 0 or int(mid.slot_lease.min()) < -1:
                raise AssertionError(f"11d: ckpt-00000024 holds no live lease ({mid.slot_lease.tolist()})")
            summary, err = cli_run(root, ["resume", str(d), "--device", resume_on], f"11d {write_on} resume")
            if "resume: ckpt-00000024 at round 24" not in err:
                raise AssertionError(f"11d: the resume did not start from ckpt-00000024: {err[-2000:]}")
            check_pin(summary, small, f"11d {write_on}->{resume_on}")

        both_ways(leg)
    out["11d"] = dict(seconds=time.perf_counter() - t0, live_leases=leases)
    print(f"[{card}] 11d the n=20000 matching stream pin ({' '.join(small['argv'])}) killed after ckpt-00000024 "
          f"({leases} live leases, TTL 20, so leases have aged out before it) on the card and resumed on the CPU, "
          f"and the reverse, both onto the JAX pin", flush=True)
    return out


# ------------------------------------------------------------ phase 12: adaptive control

CONTROL_BIG = ["--peers", "1000000", "--graph", "matching", "--mode", "push_pull", "--fanout", "3", "--control",
               "0.99", "--control-bounds", "1,6", "--rounds", "48", "--digest", "--quiet"]  # bench_control's policy
CONTROL_STREAM_BIG = ["--peers", "1000000", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--stream",
                      "4", "--stream-burst-every", "6", "--slot-ttl", "24", "--control", "0.9", "--rounds", "48",
                      "--digest", "--quiet"]
SCENARIO_ARG = "LATE_LOSS_TOML"  # a pin's argv naming the file its scenario_text is written to
CONTROL_COLUMNS = ("control_level", "control_fanout", "msgs_duplicate", "control_refreshed")


def without(argv: list[str], *flags: str) -> list[str]:
    """``argv`` without each of ``flags`` and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


def pin_argv(ref: dict, tmp: Path) -> list[str]:
    """A pin's argv, ``--quiet`` dropped, a scenario given as text written to
    a file where the argv names it."""
    argv = [a for a in ref["argv"] if a != "--quiet"]
    if "scenario_text" in ref:
        path = tmp / "late_loss.toml"
        path.write_text(ref["scenario_text"])
        argv = [str(path) if a == SCENARIO_ARG else a for a in argv]
    return argv


def check_control_run(what: str, argv: list[str], r: dict) -> None:
    """A controlled CLI run's path launches (its delivery kernels and tail
    once a round), and every round's effective fanout inside the bounds."""
    check_growth_run(what, argv, r)
    lo, hi = r["summary"]["control"]["bounds"]
    fanouts = {row["control_fanout"] for row in r["rows"]}
    if not fanouts or not fanouts <= set(range(lo, hi + 1)):
        raise AssertionError(f"{what}: effective fanouts {sorted(fanouts)} outside the bounds [{lo}, {hi}]")


def control_line(card: str, what: str, r: dict, extra: str = "") -> str:
    fanouts = [row["control_fanout"] for row in r["rows"]]
    rm = ""
    if r.get("round_ms"):
        rm = f"; {sum(r['round_ms']) / len(r['round_ms'])} ms/round by CUDA events a round"
    return fault_line(card, what, r, f"; control_fanout {fanouts}; reliability {r['summary']['reliability']}{rm}"
                                     f"{extra}")


def message_bill(rows: list[dict], target: float = 0.99) -> dict:
    """bench_control's bill: the messages sent up to the run's rounds to
    ``target`` over the infections held then."""
    cov = [row["coverage"] for row in rows]
    rtc = next((i + 1 for i, c in enumerate(cov) if c >= target), -1)
    cut = rtc if rtc > 0 else len(rows)
    msgs = sum(row["msgs_sent"] for row in rows[:cut])
    ninf = rows[cut - 1]["n_infected"]
    return dict(rounds_to_target=rtc, msgs_to_target=msgs, infections_delivered=ninf,
                msgs_per_delivered_infection=round(msgs / max(ninf, 1), 3))


def zero_adjustment_identity(static: dict, zero: dict) -> None:
    """The zero-adjustment run's protocol trajectory is the static run's:
    every plane of the final state but the cursor, every row but the four
    control columns."""
    for f in dataclasses.fields(static["fin"]):
        if f.name != "control_lvl" and not torch.equal(getattr(static["fin"], f.name), getattr(zero["fin"], f.name)):
            raise AssertionError(f"12b zero adjustment: plane {f.name} differs from the static run's")
    strip = [{k: v for k, v in row.items() if k not in CONTROL_COLUMNS} for row in static["rows"]]
    if strip != [{k: v for k, v in row.items() if k not in CONTROL_COLUMNS} for row in zero["rows"]]:
        raise AssertionError("12b zero adjustment: the rows differ from the static run's beyond the control columns")
    if any(row["control_fanout"] != 3 or row["control_level"] != 0 for row in zero["rows"]):
        raise AssertionError("12b zero adjustment: the controller left its one level")


def run_control_profile(root: Path, card: str) -> dict:
    """``sim.profile --control 0.99`` at 1M (bench_control's policy on the
    matching headline): the control stage's rows and the traced round."""
    proc = subprocess.run([sys.executable, "-m", "tpu_gossip_torch.sim.profile", "--peers", "1000000", "--control",
                           "0.99", "--warm", "6", "--rounds", "3", "--reps", "5"], cwd=root, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"sim.profile --control exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    stages, trace = lines[0]["stage_ms"], lines[1]["trace"]
    for key in ("control_resolve", "control_apply", "control_refresh", "controlled_round", "plain_round"):
        if key not in stages:
            raise AssertionError(f"sim.profile --control printed no {key} row: {stages}")
    print(f"[{card}] 12e sim.profile --control 0.99 (the matching graph n=1000000, push_pull, fanout 3, bounds 1..6, "
          f"6 warm rounds): control_resolve {stages['control_resolve']} ms, control_apply {stages['control_apply']} "
          f"ms, control_refresh {stages['control_refresh']} ms, controlled_round {stages['controlled_round']} ms "
          f"against plain_round {stages['plain_round']} ms; every stage {stages}; traced: "
          f"{trace['wall_ms_per_round']} ms/round wall, {trace['device_ms_per_round']} ms device, busy "
          f"{trace['device_busy_share']}, top kernels {trace['top_kernels_ms_per_round'][:8]}", flush=True)
    return dict(stages=stages, trace={k: v for k, v in trace.items() if k != "top_kernels_ms_per_round"})


def phase_control(root: Path, dev, card: str) -> dict:
    """Phase 12: the adaptive controller on the card. 12a the JAX control
    pins at n <= 20000 through the CLI on every engine (matching and its
    packed twin, PA exactly-k with fresh edges and the refresh, the
    Chung-Lu staircase under a late loss, whose effective fanout visits 5,
    the bucketed mesh with K6 and its packed twin, the degraded scenario
    under a stream), launches counted from 0 a run; 12b bench_control's
    policy on the 1M matching headline (48 rounds) onto its JAX pin, its
    packed twin digest-equal, the static run and the zero-adjustment run
    (bounds 3,3) on the same state, the zero-adjustment trajectory the
    static one's beyond the control columns, and the message bill of the
    controlled and static runs cut at their rounds to 0.99; 12c the 1M
    stream headline under the controller onto its JAX pin; 12d pin 2
    (PA, the refresh every 4 rounds) killed after its round-16 checkpoint
    and resumed on the other device, both ways; 12e ``sim.profile
    --control``."""
    import shutil
    import tempfile

    refs = json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
    pins = [r for r in refs if control_pin(r)]
    out = {}

    # 12a: the small pins, every engine
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-control-") as tmp:
        for ref in pins:
            if ref["argv"][ref["argv"].index("--peers") + 1] == "1000000":
                continue
            argv = pin_argv(ref, Path(tmp))
            r = cli_here(argv, dev)
            what = f"12a run_sim {' '.join(a for a in ref['argv'] if a not in ('--digest', '--quiet'))}"
            check_pin(r["summary"], ref, what)
            check_control_run(what, argv, r)
            fanouts = [row["control_fanout"] for row in r["rows"]]
            if "scenario_text" in ref and 5 not in fanouts:
                raise AssertionError(f"{what}: the effective fanout never visits 5 ({fanouts})")
            print(control_line(card, what, r, "; equal to the JAX pin"), flush=True)
            del r
    out["12a"] = dict(seconds=time.perf_counter() - t0)

    # 12b: bench_control's policy at 1M, its packed twin, the static and
    # zero-adjustment runs on the same state, and the message bill
    t0 = time.perf_counter()
    pin = {" ".join(p["argv"]): p for p in pins}[" ".join(CONTROL_BIG)]
    static_argv = without(CONTROL_BIG, "--control", "--control-bounds")
    runs = {}
    for what, argv in (("controlled", CONTROL_BIG), ("controlled packed", CONTROL_BIG + ["--packed"]),
                       ("static", static_argv), ("zero adjustment", static_argv + ["--control", "0.99",
                                                                                    "--control-bounds", "3,3"])):
        argv = [a for a in argv if a != "--quiet"]
        r = runs[what] = cli_here(argv, dev, marks=True)
        check_growth_run(f"12b {what}", argv, r)
        if what == "controlled":
            check_pin(r["summary"], pin, "12b")
        elif what == "controlled packed":
            same_run(runs["controlled"], r, "12b packed twin")
        r["bill"] = message_bill(r["rows"])
        r["ms_per_round"] = sum(r["round_ms"]) / len(r["round_ms"])
        if what.startswith("controlled"):
            r["fin"] = None  # only the static and zero-adjustment states are compared
        line = control_line if "reliability" in r["summary"] else fault_line
        print(line(card, f"12b bench_control's policy on the 1M matching headline (push_pull, fanout 3, 48 rounds), "
                         f"{what}", r, f"; bill to 99% {r['bill']}; {r['ms_per_round']} ms/round by CUDA events"),
              flush=True)
        out[f"12b {what}"] = dict(horizon=r["horizon"], launches=r["launches"], ms_per_round=r["ms_per_round"],
                                  bill=r["bill"])
    zero_adjustment_identity(runs["static"], runs["zero adjustment"])
    c, st = runs["controlled"]["bill"], runs["static"]["bill"]
    reduction = round(1.0 - c["msgs_per_delivered_infection"] / st["msgs_per_delivered_infection"], 4)
    reliability = runs["controlled"]["summary"]["reliability"]
    print(f"[{card}] 12b the zero-adjustment run (bounds 3,3) equals the static run beyond the four control columns "
          f"(every plane but control_lvl, every row); message bill to 99%: controlled {c} against static {st}, "
          f"msgs per delivered infection reduced by {reduction}; the controlled run's reliability block "
          f"{reliability}", flush=True)
    del runs, r
    out["12b"] = dict(seconds=time.perf_counter() - t0, reduction=reduction, reliability=reliability)

    # 12c: the 1M stream headline under the controller
    t0 = time.perf_counter()
    pin = {" ".join(p["argv"]): p for p in pins}[" ".join(CONTROL_STREAM_BIG)]
    argv = [a for a in CONTROL_STREAM_BIG if a != "--quiet"]
    r = cli_here(argv, dev, marks=True)
    check_pin(r["summary"], pin, "12c")
    check_stream_run("12c", argv, r)
    check_control_run("12c", argv, r)
    out["12c"] = dict(horizon=r["horizon"], launches=r["launches"],
                      ms_per_round=sum(r["round_ms"]) / len(r["round_ms"]))
    print(control_line(card, "12c the 1M matching headline under a stream (rate 4, bursts x4 every 6 rounds, TTL 24, "
                             "48 rounds) and the controller (0.9)", r, "; digests equal the JAX pin"), flush=True)
    del r
    out["12c"]["seconds"] = time.perf_counter() - t0

    # 12d: pin 2 killed after a refresh round's checkpoint, resumed on the other device
    t0 = time.perf_counter()
    from tpu_gossip_torch.ckpt import load_checkpoint

    small = [p for p in pins if "--refresh-every" in p["argv"] and p["argv"][1] == "20000"][0]
    cursors = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-control-") as tmp:
        tmp = Path(tmp)

        def leg(write_on, resume_on):
            d = tmp / write_on
            kill_at(root, small["argv"] + ["--checkpoint-every", "8", "--checkpoint-dir", str(d), "--device",
                                           write_on], "checkpoint: wrote ckpt-00000016")
            shutil.rmtree(d / "ckpt-00000024", ignore_errors=True)
            cursors[write_on] = int(load_checkpoint(d / "ckpt-00000016", device="cpu")[0].control_lvl)
            if cursors[write_on] < 0:
                raise AssertionError(f"12d: ckpt-00000016 holds no cursor ({cursors[write_on]})")
            summary, err = cli_run(root, ["resume", str(d), "--device", resume_on], f"12d {write_on} resume")
            if "resume: ckpt-00000016 at round 16" not in err:
                raise AssertionError(f"12d: the resume did not start from ckpt-00000016: {err[-2000:]}")
            check_pin(summary, small, f"12d {write_on}->{resume_on}")

        both_ways(leg)
    out["12d"] = dict(seconds=time.perf_counter() - t0, cursors=cursors)
    print(f"[{card}] 12d pin 2 ({' '.join(small['argv'])}) killed after ckpt-00000016 (a refresh round; cursor "
          f"{cursors}) on the card and resumed on the CPU, and the reverse, both onto the JAX pin", flush=True)

    # 12e: the control stage's rows
    t0 = time.perf_counter()
    out["12e profile"] = run_control_profile(root, card)
    out["12e"] = dict(seconds=time.perf_counter() - t0)
    return out


# ---------------------------------------------- phase 13: pipelined rounds and fleets

PIPELINE_BIG_ROUNDS = 24  # bench.py::bench_pipeline's horizon
CATALOGUE = "scenarios/campaigns/catalogue_smoke.toml"
# bench.py::bench_fleet's configuration: K composed lanes (a lossy sweep, a
# stream and the controller) of n-peer Chung-Lu swarms, the first 5 of its 10
# rounds (cut to keep the script inside its time once phase 16 joined it)
BENCH_FLEET = dict(n=131_072, ks=(1, 8, 32), rounds=5)
# a small campaign for the checkpoint round trip across devices (4 lanes, 12
# rounds, a file a lane every 4)
SMALL_CAMPAIGN = """[campaign]
name = "chip-small"
seed = 1
[base]
peers = 64
rounds = 12
slots = 4
fanout = 2
mode = "push_pull"
stream_rate = 1.0
slot_ttl = 10
control = 0.9
control_hi = 3
rewire_slots = 3
churn_join = 0.02
[[family]]
name = "lossy"
scenario = "lossy.toml"
seeds = 2
[[family.sweep]]
axis = "phase.loss"
dist = "uniform"
lo = 0.05
hi = 0.3
[[family]]
name = "quiet"
scenario = "lossy.toml"
seeds = 2
"""
SMALL_SCENARIO = ("[scenario]\nname = \"lossy\"\n[[phase]]\nname = \"lossy\"\nstart = 0\nend = 6\nloss = 0.2\n"
                  "delay = 0.1\n")
COMPOSED_PROFILE = ["--peers", "950000", "--grow", "1000000", "--grow-rate", "32", "--graph", "matching", "--mode",
                    "push_pull", "--fanout", "1", "--stream", "4", "--control", "0.99", "--profile-round", "4"]


def pipeline_1m(dev, setup: dict, depth, rounds: int = PIPELINE_BIG_ROUNDS) -> dict:
    """bench_pipeline's comparison on its own set-up: the 1M sharded
    matching mesh at one shard (phase 14's layout, ``make_mesh()`` on one
    card), 16 origins on 16 slots, push_pull fanout 1, ``rounds`` rounds at
    ``depth`` (None: serial), launches counted from 0, a CUDA event a
    round."""
    from tpu_gossip_torch import dist
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim import metrics as M
    from tpu_gossip_torch.sim.stages import compile_pipeline
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    plan, mesh, cfg = setup["plan_m"], setup["mesh"], setup["cfg"]
    pipe = None if depth is None else compile_pipeline(depth)

    def step(st):
        return dist.gossip_round_dist(st, cfg, plan, mesh, pipeline=pipe)

    native.reset_launches()
    t0 = time.perf_counter()
    fin, stats, round_ms, peak, start = timed_rounds(dev, step, setup["state"], rounds)
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    check_launches(f"13b {'serial' if depth is None else 'pipelined'}", launches, MESH_PATH, rounds)
    return dict(state_digest=state_digest(fin), stats_digest=stats_digest(stats),
                rounds_to_target=M.rounds_to_coverage(stats, 0.99), final_coverage=float(stats.coverage[-1]),
                wall_ms_per_round=wall * 1e3 / rounds, event_ms_per_round=sum(round_ms) / rounds, peak=peak,
                start=start, launches={k: v for k, v in launches.items() if v},
                pipe_buf_bits=int(fin.pipe_buf.sum()))


def phase_pipeline(root: Path, dev, card: str, setup: dict) -> dict:
    """13a: the four pipelined JAX pins at n=20000 (``--shard --staircase
    --pipeline 1``, packed and unpacked, plain and under a stream whose
    age-out runs inside the horizon) through the CLI, launches counted from
    0 (K6 once a round, K3 or K4 once a round), and ``--pipeline 0`` onto
    the serial pin of ``reference_digests.json``; 13b bench_pipeline's
    comparison on its own set-up (the 1M sharded matching mesh at one
    shard, ``setup`` from phase 14), serial and pipelined in turns, the
    pipelined run onto its JAX pin."""
    pins = json.loads((root / "tpu_gossip_torch" / "reference_pins.json").read_text())
    out = {}
    t0 = time.perf_counter()
    for ref in pins["pipeline"]:
        argv = [a for a in ref["argv"] if a != "--quiet"]
        what = f"13a run_sim {' '.join(a for a in ref['argv'] if a not in ('--digest', '--quiet'))}"
        r = cli_here(argv, dev)
        check_pin(r["summary"], ref, what)
        if "--stream" in argv:
            check_stream_run(what, argv, r)
            print(stream_line(card, what, r, "; equal to the JAX pin"), flush=True)
        else:
            check_growth_run(what, argv, r)
            print(fault_line(card, what, r, "; equal to the JAX pin"), flush=True)
        del r
    serial = [ref for ref in json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
              if ref["argv"] == SERIAL_SHARD_PIN][0]
    r = cli_here([a for a in SERIAL_SHARD_PIN if a != "--quiet"] + ["--pipeline", "0"], dev)
    check_pin(r["summary"], serial, "13a --pipeline 0")
    if r["summary"].get("pipeline") != 0:
        raise AssertionError(f"13a --pipeline 0 reported pipeline {r['summary'].get('pipeline')}")
    print(fault_line(card, "13a the serial sharded pin with --pipeline 0", r, "; equal to the serial JAX pin"),
          flush=True)
    out["13a"] = dict(seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    pin = pins["pipeline_1m"]
    runs = {"serial": [], "pipelined": []}
    for what in ("serial", "pipelined", "pipelined", "serial"):
        runs[what].append(pipeline_1m(dev, setup, None if what == "serial" else 1))
    for what, (a, b) in runs.items():
        for k in ("state_digest", "stats_digest", "rounds_to_target", "pipe_buf_bits"):
            if a[k] != b[k]:
                raise AssertionError(f"13b {what}: the two runs' {k} differ: {a[k]} != {b[k]}")
    piped = runs["pipelined"][0]
    for k, want in pin["summary"].items():
        if piped[k] != want:
            raise AssertionError(f"13b pipelined: {k} {piped[k]} != the JAX pin's {want} ({pin['source']})")
    if runs["serial"][0]["pipe_buf_bits"] != 0 or piped["pipe_buf_bits"] == 0:
        raise AssertionError("13b: the serial run touched pipe_buf or the pipelined run left it empty")
    for what, pair in runs.items():
        print(f"[{card}] 13b bench_pipeline's comparison on its own set-up (the 1M sharded matching mesh, one shard, "
              f"push_pull fanout 1, {M_SLOTS} origins on {M_SLOTS} slots, {PIPELINE_BIG_ROUNDS} rounds), {what}: "
              f"{[round(r['event_ms_per_round'], 4) for r in pair]} ms/round by CUDA events, "
              f"{[round(r['wall_ms_per_round'], 4) for r in pair]} by wall (the turns serial, pipelined, pipelined, "
              f"serial), rounds to 99% {pair[0]['rounds_to_target']}, final coverage {pair[0]['final_coverage']}, "
              f"peak {pair[0]['peak']} B (from {pair[0]['start']} B), launches {pair[0]['launches']}, "
              f"state_digest {pair[0]['state_digest']}"
              + ("; equal to the JAX pin" if what == "pipelined" else ""), flush=True)
    out["13b"] = dict(seconds=time.perf_counter() - t0,
                      runs={w: [{k: r[k] for k in ("event_ms_per_round", "wall_ms_per_round", "rounds_to_target",
                                                    "peak", "launches")} for r in pair] for w, pair in runs.items()})
    return out


def check_report(got: dict, want: dict, path: str = "report") -> None:
    """A fleet summary's family blocks against the JAX pin's: integers,
    strings and booleans equal, floats within 1e-6."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"13c {path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            check_report(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"13c {path}: {len(got)} entries != {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            check_report(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        if abs(got - want) > 1e-6:
            raise AssertionError(f"13c {path}: {got} != the JAX pin's {want}")
    elif got != want:
        raise AssertionError(f"13c {path}: {got} != the JAX pin's {want}")


def run_fleet_cli(argv: list[str], dev) -> dict:
    """``run_sim`` (fleet or resume) in this process; its summary."""
    import contextlib
    import io

    from tpu_gossip_torch.cli import run_sim

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_sim.main(argv + ["--device", str(dev)])
    if rc != 0:
        raise AssertionError(f"run_sim {' '.join(argv)} exited {rc}: {err.getvalue()[-3000:]}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def fleet_lanes(camp, k: int):
    """The first ``k`` lanes of a compiled campaign: the stacked states and
    each plane's plans."""
    states = dataclasses.replace(camp.states, **{f.name: getattr(camp.states, f.name)[:k]
                                                 for f in dataclasses.fields(camp.states)})
    return states, [None if p is None else p[:k] for p in (camp.scenario, camp.growth, camp.stream, camp.control)]


LANE_PROCESSES = 4
LANE_CHILD = """import json, sys, time
import numpy as np
import torch
from tpu_gossip_torch import fleet
from tpu_gossip_torch.ckpt import host_stats
from tpu_gossip_torch.kernels import native
lo, hi, path, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
camp = fleet.compile_campaign(fleet.parse_campaign(path), device="cuda")
native.reset_launches()
t0 = time.perf_counter()
digests = {}
for k in range(lo, hi):
    fin, stats = fleet.run_lane_solo(camp, k)
    digests[str(k)] = fleet.state_digest(fin)
    np.savez(f"{out}/lane-{k}.npz", **host_stats(stats))
torch.cuda.synchronize()
print(json.dumps({"digests": digests, "launches": dict(native.LAUNCHES), "wall": time.perf_counter() - t0}))
"""


def start_catalogue_lanes(root: Path, tmp: Path, k: int) -> list:
    """The catalogue's ``k`` lanes on the card in ``LANE_PROCESSES``
    processes at once, each compiling the campaign and running its share of
    the lanes through the solo round (a fleet lane is its solo run)."""
    cuts = [k * i // LANE_PROCESSES for i in range(LANE_PROCESSES + 1)]
    return [subprocess.Popen([sys.executable, "-c", LANE_CHILD, str(lo), str(hi), str(root / CATALOGUE), str(tmp)],
                             cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for lo, hi in zip(cuts, cuts[1:])]


def finish_catalogue_lanes(procs: list, tmp: Path, k: int):
    """Wait for :func:`start_catalogue_lanes`' processes: every lane's
    state digest, the stacked stats, the summed launches and the wall
    seconds of the slowest process's lanes."""
    import numpy as np

    from tpu_gossip_torch.sim.engine import RoundStats

    digests, launches, wall = {}, {}, 0.0
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"13c: a lane process exited {proc.returncode}: {err[-3000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        digests.update(got["digests"])
        for key, n in got["launches"].items():
            launches[key] = launches.get(key, 0) + n
        wall = max(wall, got["wall"])
    parts = [np.load(tmp / f"lane-{i}.npz") for i in range(k)]
    stats = RoundStats(*(torch.from_numpy(np.stack([p[f] for p in parts])) for f in RoundStats._fields))
    return {str(i): digests[str(i)] for i in range(k)}, stats, launches, wall


def bench_fleet(dev, card: str, tmp: Path) -> dict:
    """13d: bench.py::bench_fleet's configuration at full width, the fleet
    at K = 1, 8 and 32 lanes beside K in-process solo runs of the same
    lanes (the fleet runs its lanes in turn through the solo round, so the
    two should match), swarms/s, peers*rounds/s, the peak and K3's
    launches."""
    from tpu_gossip_torch import fleet
    from tpu_gossip_torch.kernels import native

    b = BENCH_FLEET
    scen = tmp / "lossy_short.toml"
    scen.write_text(f"[scenario]\nname = \"lossy-short\"\n[[phase]]\nname = \"lossy\"\nstart = 0\n"
                    f"end = {max(b['rounds'] - 2, 1)}\nloss = 0.2\ndelay = 0.1\n")
    camp_path = tmp / "fleet_bench.toml"
    camp_path.write_text(
        f"[campaign]\nname = \"fleet-bench\"\nseed = 0\n[base]\npeers = {b['n']}\nrounds = {b['rounds']}\n"
        "slots = 16\nfanout = 2\nmode = \"push_pull\"\ngraph = \"chung-lu\"\ncoverage_target = 0.95\n"
        "target_ratio = 0.9\nstream_rate = 1.0\nslot_ttl = 24\ncontrol = 0.9\ncontrol_hi = 4\nrewire_slots = 4\n"
        f"[[family]]\nname = \"lossy\"\nscenario = \"{scen}\"\nseeds = {max(b['ks'])}\n"
        "[[family.sweep]]\naxis = \"phase.loss\"\ndist = \"uniform\"\nlo = 0.05\nhi = 0.4\n")
    t0 = time.perf_counter()
    camp = fleet.compile_campaign(fleet.parse_campaign(camp_path), device=dev)
    torch.cuda.synchronize(dev)
    compile_s = time.perf_counter() - t0
    fleet.run_lane_solo(camp, 0)  # warm
    rows = {}
    for k in b["ks"]:
        states, plans = fleet_lanes(camp, k)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        native.reset_launches()
        t0 = time.perf_counter()
        fin, stats = fleet.simulate_fleet(states, camp.cfg, b["rounds"], *plans, camp.liveness)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        check_counts(f"13d K={k}", launches, {"round_tail": k * b["rounds"], "lane_shuffle": 0, "fold_planes_or": 0,
                                             "staircase_segment": 0, "stream_segment": 0, "round_tail_words": 0})
        digests = [fleet.state_digest(dataclasses.replace(fin, **{f.name: getattr(fin, f.name)[i] for f in
                                                                  dataclasses.fields(fin)})) for i in range(k)]
        del fin, stats
        t0 = time.perf_counter()
        for i in range(k):
            solo, _ = fleet.run_lane_solo(camp, i)
            if fleet.state_digest(solo) != digests[i]:
                raise AssertionError(f"13d K={k}: lane {i} differs from its solo run")
        torch.cuda.synchronize(dev)
        serial = time.perf_counter() - t0
        rows[k] = dict(fleet_wall_s=wall, swarms_per_s=k / wall, swarm_rounds_per_s=k * b["rounds"] / wall,
                       peers_rounds_per_s=k * b["n"] * b["rounds"] / wall, ms_per_round_per_lane=wall * 1e3 /
                       (k * b["rounds"]), serial_solo_wall_s=serial, serial_swarms_per_s=k / serial,
                       fleet_over_serial=serial / wall, peak=peak, start=start, k3_launches=launches["round_tail"])
        print(f"[{card}] 13d bench_fleet's configuration (n={b['n']} Chung-Lu, {b['rounds']} rounds, 16 slots, "
              f"push_pull fanout 2, stream 1.0 TTL 24, control 0.9 hi 4, rewire 4, loss 0.05-0.4) K={k}: fleet "
              f"{wall} s, {rows[k]['swarms_per_s']} swarms/s, {rows[k]['peers_rounds_per_s']} peers*rounds/s, "
              f"{rows[k]['ms_per_round_per_lane']} ms a lane-round; {k} solo runs {serial} s "
              f"({rows[k]['serial_swarms_per_s']} swarms/s, fleet/serial speed {rows[k]['fleet_over_serial']}); "
              f"peak {peak} B (from {start} B); K3 launches {launches['round_tail']}; every lane equals its solo "
              f"run", flush=True)
    return dict(compile_s=compile_s, rows=rows)


def fleet_checkpoint_across_devices(root: Path, dev, card: str, tmp: Path) -> None:
    """A 4-lane campaign checkpointed a file a lane every 4 rounds, killed
    after its round-4 checkpoint on one device and finished on the other,
    whole and as ``--lane 3 --solo``, both ways: the uninterrupted run's
    lane digests."""
    import shutil

    (tmp / "lossy.toml").write_text(SMALL_SCENARIO)
    camp_path = tmp / "campaign.toml"
    camp_path.write_text(SMALL_CAMPAIGN)
    full = run_fleet_cli(["fleet", str(camp_path)], dev)
    for write_on, resume_on in (("cuda", "cpu"), ("cpu", "cuda")):
        d = tmp / write_on
        kill_at(root, ["fleet", str(camp_path), "--checkpoint-every", "4", "--checkpoint-dir", str(d), "--device",
                       write_on], "checkpoint: wrote ckpt-00000004")
        shutil.rmtree(d / "ckpt-00000008", ignore_errors=True)
        lane = run_fleet_cli(["resume", str(d), "--lane", "3", "--solo"], resume_on)
        whole = run_fleet_cli(["resume", str(d)], resume_on)
        if lane["state_digest"] != full["lane_digests"]["3"] or whole["lane_digests"] != full["lane_digests"]:
            raise AssertionError(f"13c: the fleet written on {write_on} and resumed on {resume_on} differs")
    print(f"[{card}] 13c a 4-lane campaign checkpointed a file a lane every 4 rounds, killed after ckpt-00000004 on "
          "the card and resumed on the CPU, and the reverse, whole and as --lane 3 --solo: the uninterrupted run's "
          "lane digests", flush=True)


def phase_fleet(root: Path, dev, card: str) -> dict:
    """13c: the catalogue campaign (21 lanes at n=96 under every scenario
    family, 60 rounds) on the card, every lane's digests and the summary's
    family blocks onto the JAX pin, K3 once a lane-round; ``--lane 5
    --solo`` equal to its fleet lane; a small campaign checkpointed a file
    a lane, killed after its round-4 checkpoint and finished whole and as
    ``--lane 3 --solo`` on the other device, both ways. 13d
    ``bench_fleet``'s configuration at full width."""
    import tempfile

    from tpu_gossip_torch import fleet

    pin = json.loads((root / "tpu_gossip_torch" / "reference_pins.json").read_text())["fleet"]
    out = {}
    t0 = time.perf_counter()
    camp = fleet.compile_campaign(fleet.parse_campaign(root / CATALOGUE), device="cpu")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fleet-") as tmp:
        tmp = Path(tmp)
        (tmp / "lanes").mkdir()
        procs = start_catalogue_lanes(root, tmp / "lanes", camp.k)
        try:
            # meanwhile, in this process: lane 5 alone through the CLI, and
            # a small campaign's checkpoint across the devices
            solo = run_fleet_cli(["fleet", str(root / CATALOGUE), "--lane", "5", "--solo"], dev)
            fleet_checkpoint_across_devices(root, dev, card, tmp)
            lanes, stats, launches, wall = finish_catalogue_lanes(procs, tmp / "lanes", camp.k)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        check_counts("13c", launches, {"round_tail": camp.k * camp.rounds, "lane_shuffle": 0, "fold_planes_or": 0,
                                       "staircase_segment": 0, "stream_segment": 0, "round_tail_words": 0})
        want = pin["summary"]
        if lanes != want["lane_digests"]:
            bad = [k for k in lanes if lanes[k] != want["lane_digests"][k]]
            raise AssertionError(f"13c: lanes {bad} differ from the JAX pin")
        if {str(k): fleet.stats_digest(stats, k) for k in range(camp.k)} != want["stats_digests"]:
            raise AssertionError("13c: a lane's stats digest differs from the JAX pin")
        report = fleet.campaign_report(camp, stats)
        families = [{k: f.get(k) for k in ("family", "lanes", "lanes_judged", "reliability", "frontier")
                     if f.get(k) is not None} for f in report["families"]]
        check_report(families, want["families"], "families")
        if solo["state_digest"] != lanes["5"] or solo["stats_digest"] != want["stats_digests"]["5"]:
            raise AssertionError("13c: --lane 5 --solo differs from the fleet's lane 5")
        verdicts = [(f["family"], f["reliability"]["mean"], f["reliability"]["certified"]) for f in families]
        print(f"[{card}] 13c {CATALOGUE} ({camp.k} lanes, n=96, {camp.rounds} rounds; {LANE_PROCESSES} processes at "
              f"once beside the checkpoint run, each running its lanes in turn as the fleet does): {wall} s, "
              f"{camp.k * camp.rounds / wall} swarm-rounds/s; launches {({k: v for k, v in launches.items() if v})}; "
              f"every lane's digests and the family blocks equal the JAX pin; run_sim fleet --lane 5 --solo equals "
              f"lane 5; families {verdicts}", flush=True)
        del stats, camp
        out["13c"] = dict(seconds=time.perf_counter() - t0, wall=wall, launches=launches)
        t0 = time.perf_counter()
        out["13d"] = bench_fleet(dev, card, tmp)
        out["13d"]["seconds"] = time.perf_counter() - t0
    return out


def run_composed_profile(card: str, dev) -> dict:
    """13e: ``run_sim --profile-round`` with ``--grow``, ``--stream 4`` and
    ``--control 0.99`` on the 1M matching headline growing toward 1M (32
    joins a round, so the Gumbel draw does not swamp the slopes): the
    growth, stream and control rows between the key splits and the
    transport probe, K1, K2 and K3 launched."""
    import contextlib
    import io

    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels import native

    native.reset_launches()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_sim.main(COMPOSED_PROFILE + ["--device", str(dev)])
    launches = dict(native.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"run_sim {' '.join(COMPOSED_PROFILE)} exited {rc}: {err.getvalue()[-3000:]}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    want = PROFILE_STAGES[:6] + ["growth", "stream", "control"] + PROFILE_STAGES[6:]
    if list(summary["stages_ms"]) != want:
        raise AssertionError(f"13e --profile-round stages {list(summary['stages_ms'])} != {want}")
    check_launches("13e --profile-round", launches, {"lane_shuffle": None, "fold_planes_or": None,
                                                     "round_tail": None}, 1)
    print(f"[{card}] 13e run_sim {' '.join(COMPOSED_PROFILE)}: stages_ms {summary['stages_ms']}; launches "
          f"{({k: v for k, v in launches.items() if v})}", flush=True)
    return summary


SERIAL_SHARD_PIN = ["--peers", "20000", "--mode", "push_pull", "--fanout", "1", "--graph", "chung-lu", "--shard",
                    "--staircase", "--rounds", "20", "--digest", "--quiet"]


KERNELS = (  # (name, launch key, source, TPU kernel it replaces, check key)
    ("lane_shuffle", "lane_shuffle", "tpu_gossip_torch/csrc/lane_shuffle.cu",
     "tpu_gossip/kernels/permute.py:77", "lane_shuffle"),
    ("lane_shuffle_t", "lane_shuffle_t", "tpu_gossip_torch/csrc/lane_shuffle.cu",
     "tpu_gossip/kernels/permute.py:77", "lane_shuffle"),
    ("tinv_lane_shuffle", "tinv_lane_shuffle", "tpu_gossip_torch/csrc/lane_shuffle.cu",
     "tpu_gossip/kernels/permute.py:77", "lane_shuffle"),
    ("fold_planes[or]", "fold_planes_or", "tpu_gossip_torch/csrc/fold_planes.cu",
     "tpu_gossip/kernels/permute.py:229", "fold_planes"),
    ("fold_planes[sum]", "fold_planes_sum", "tpu_gossip_torch/csrc/fold_planes.cu",
     "tpu_gossip/kernels/permute.py:229", "fold_planes"),
    ("round_tail", "round_tail", "tpu_gossip_torch/csrc/round_tail.cu",
     "tpu_gossip/kernels/round_tail.py:263", "round_tail"),
    ("staircase_segment", "staircase_segment", "tpu_gossip_torch/csrc/staircase_segment.cu",
     "tpu_gossip/kernels/pallas_segment.py:447", "staircase_segment"),
    ("round_tail_words", "round_tail_words", "tpu_gossip_torch/csrc/round_tail_words.cu",
     "tpu_gossip/kernels/round_tail.py:444", "round_tail_words"),
    ("stream_segment", "stream_segment", "tpu_gossip_torch/csrc/stream_segment.cu",
     "tpu_gossip/kernels/pallas_segment.py:509", "stream_segment"),
)
PROBES = (  # (name, row of time_probes, the Pallas probe it replaces)
    ("P1 lane_gather (pallas_gather_caps, axis 1)", "P1", "experiments/pallas_gather_caps.py:28"),
    ("P2 lane_gather (pallas_wide_lane_gather)", "P2", "experiments/pallas_wide_lane_gather.py:30"),
    ("P3 sublane_gather (gather_probe)", "P3", "experiments/gather_probe.py:140"),
    ("P4 lane_gather (perm_pipeline_probe)", "P4", "experiments/perm_pipeline_probe.py:69"),
    ("P5 sublane_gather group 8 (perm_pipeline_probe)", "P5", "experiments/perm_pipeline_probe.py:97"),
)
# the launches each path must make, and must not make, per round (None: at
# least one; a key left out is not checked)
# (4a's build adds one fold_planes_sum, checked apart)
MATCHING_PATH = {"lane_shuffle": None, "fold_planes_or": 1, "round_tail": None,
                 "staircase_segment": 0, "round_tail_words": 0, "stream_segment": 0}
STAIRCASE_PATH = {"lane_shuffle": 0, "fold_planes_or": 0, "fold_planes_sum": 0, "round_tail": 1,
                  "staircase_segment": 1, "round_tail_words": 0, "stream_segment": 0}
XLA_PATH = dict(STAIRCASE_PATH, staircase_segment=0)
# the packed headline reuses 4a's plan, so the build's SUM fold is not in its window
PACKED_MATCHING_PATH = {"lane_shuffle": None, "fold_planes_or": 1, "round_tail": 0, "staircase_segment": 0,
                        "round_tail_words": 1, "stream_segment": 0}
PACKED_XLA_PATH = dict(XLA_PATH, round_tail=0, round_tail_words=1)
# the sharded paths on a one-shard mesh: one K6 launch a round (one 32-slot group)
SHARD_STAIRCASE_PATH = dict(XLA_PATH, stream_segment=1)
SHARD_SCATTER_PATH = dict(XLA_PATH)
SHARD_PACKED_PATH = dict(SHARD_STAIRCASE_PATH, round_tail=0, round_tail_words=1)
# the churn paths (4i-4o): the same kernels a round, the churn's fresh mask in the tail
CHURN_MATCHING_PATH = dict(MATCHING_PATH, fold_planes_sum=0)
CHURN_PACKED_MATCHING_PATH = dict(PACKED_MATCHING_PATH, fold_planes_sum=0)
CHURN_STAIRCASE_PATH = STAIRCASE_PATH
CHURN_XLA_PATH = XLA_PATH
CHURN_SHARD_PATH = SHARD_STAIRCASE_PATH


# ---------------------------------- phase 14: the sharded matching mesh and its transports

MESH_SHARDS = 8
MESH_MAX_ROUNDS = 300
# a round on the matching mesh at 1M (three transpose stages): one partner
# pass of 7 K1 lane stages, one K2 reduce, one tail (K3, or K4 packed)
MESH_PATH = {"lane_shuffle": 7, "fold_planes_or": 1, "fold_planes_sum": 0, "round_tail": 1, "round_tail_words": 0,
             "staircase_segment": 0, "stream_segment": 0}
PACKED_MESH_PATH = dict(MESH_PATH, round_tail=0, round_tail_words=1)


def mesh_setup_1m(dev, shards: int) -> dict:
    """bench_dist_matching's layout: ``matching_powerlaw_graph_sharded(1M,
    shards, gamma=2.5, fanout=1, key 0, export_csr=False)``, push_pull
    fanout 1, origins ``arange(16)`` on slots ``arange(16)``, state key 0;
    the plan and state placed on a ``shards``-shard mesh, the build's
    seconds and device peak."""
    import numpy as np

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g, plan = matching_powerlaw_graph_sharded(N_HEADLINE, shards, gamma=2.5, fanout=1, key=prng.key(0, dev),
                                              export_csr=False, device=dev)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    mesh = dist.make_mesh(shards, device=dev)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=M_SLOTS, fanout=1, mode="push_pull")
    st = init_swarm(g.as_padded_graph(), cfg, origins=np.arange(M_SLOTS), origin_slots=np.arange(M_SLOTS),
                    exists=g.exists, key=prng.key(0, dev), device=dev)
    return dict(plan=plan, plan_m=dist.shard_matching_plan(plan, mesh), mesh=mesh, cfg=cfg,
                state=dist.shard_swarm(st, mesh), build_s=build_s, build_peak=torch.cuda.max_memory_allocated(dev),
                shards=shards)


def mesh_coverage_run(dev, step, state, what: str, want: dict, packed: bool = False) -> dict:
    """``step`` to 99% coverage of slot 0 (compared in float32, at most
    MESH_MAX_ROUNDS rounds), a CUDA event a round, launches counted from 0
    and checked against ``want``; an ICI counter a step returns is summed.
    The rounds, the unpacked final state's digest, ms a round by events and
    by wall, the device peak, the launches, the counter's totals (the JAX
    package's byte-plane model) and the transpose stages the port itself
    ran on a compact lane and dense."""
    from tpu_gossip_torch.core.packed import unpack_state
    from tpu_gossip_torch.dist.transport import accumulate_ici, lane_counts, reset_lane_counts, zero_ici_totals
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.utils.digest import state_digest

    tgt = torch.tensor(0.99, dtype=torch.float32, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    native.reset_launches()
    reset_lane_counts()
    tot, rounds, ev = None, 0, [torch.cuda.Event(enable_timing=True)]
    t0 = time.perf_counter()
    ev[0].record()
    while bool(state.coverage(0) < tgt) and rounds < MESH_MAX_ROUNDS:
        out = step(state)
        state, rounds = out[0], rounds + 1
        if len(out) == 3:
            tot = accumulate_ici(zero_ici_totals(dev) if tot is None else tot, out[2])
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    check_launches(what, launches, want, rounds)
    k1 = dict(native.K1_ENTRIES)
    fin = unpack_state(state) if packed else state
    cov = float(fin.coverage(0))
    if not 0.99 <= cov <= 1.0:
        raise AssertionError(f"{what} ended at coverage {cov} after {rounds} rounds")
    return dict(rounds=rounds, digest=state_digest(fin), coverage=cov,
                event_ms=sum(a.elapsed_time(b) for a, b in zip(ev, ev[1:])) / rounds, wall_ms=wall * 1e3 / rounds,
                peak=torch.cuda.max_memory_allocated(dev), start=start,
                launches={k: v for k, v in launches.items() if v}, k1_entries={k: v for k, v in k1.items() if v},
                ici=None if tot is None else tot.words(), port_lanes=lane_counts())


def mesh_line(card: str, what: str, r: dict, extra: str = "") -> str:
    return (f"[{card}] {what}: rounds to 99% {r['rounds']}, coverage {r['coverage']}, {r['event_ms']} ms/round by "
            f"CUDA events, {r['wall_ms']} by wall, peak {r['peak']} B (from {r['start']} B), launches "
            f"{r['launches']}, K1 by entry {r['k1_entries']}"
            + ("" if r["ici"] is None else f", ICI words (JAX's wire model) {r['ici']}")
            + f", the port's transpose stages {r['port_lanes']}; state_digest {r['digest']}{extra}")


def check_k1_k2_mesh(dev, gen, setup: dict) -> int:
    """K1 over the mesh's stacked blocks (one launch over all S·per rows,
    each of the plan's lane tables) and K2 over its shard-major class table
    (OR and SUM), each against its plain version; K2's outputs on every
    shard's pad rows are zero."""
    from tpu_gossip_torch.kernels import permute

    plan = setup["plan_m"]
    x = torch.randint(-2**31, 2**31 - 1, (plan.rows, 128), generator=gen, device=dev, dtype=torch.int32)
    err = 0
    for tbl in (*plan.lanes, plan.m3, *plan.lanes_inv):
        err = max(err, max_err(permute.lane_shuffle(x, tbl), permute.lane_shuffle_plain(x, tbl)))
    pad = torch.arange(plan.n, device=dev) % plan.n_blk >= plan.n_per
    for op in ("or", "sum"):
        got = permute.fold_classes(x, plan.layout, op)
        err = max(err, max_err(got, permute.fold_classes_plain(x, plan.layout, op)))
        if bool(got[pad].any()):
            raise AssertionError(f"K2 ({op}) wrote nonzero values on the mesh's pad rows")
    return err


def plans_equal_leafwise(a, ga, b, gb, what: str) -> None:
    for f in ("lanes", "lanes_inv"):
        if not all(torch.equal(x, y) for x, y in zip(getattr(a, f), getattr(b, f))):
            raise AssertionError(f"{what}: {f} differ")
    for f in ("m3", "valid", "deg_other", "deg_real"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{what}: {f} differ")
    for f in ("row_ptr", "col_idx", "exists"):
        if not torch.equal(getattr(ga, f), getattr(gb, f)):
            raise AssertionError(f"{what}: graph {f} differ")


def phase_mesh(root: Path, dev, card: str, gen, one: dict) -> dict:
    """14a: K1 and K2 against their plain versions at the mesh's shapes
    (the 1M layout at S = 8, K2's shard-major table and its pad rows);
    bench_dist_matching's configuration, the local engine on the plan and
    the mesh dense, sparse and auto, all equal: 14b at S = 1 (``one``),
    14c at S = 8 with the packed twin, the dense run's digest and ICI
    totals, the sparse replay and auto's totals onto the JAX pins; 14d
    ``--builder dist`` at 1M S = 8 against the block-keyed build, leaf for
    leaf; 14e the n=20000 sharded matching pins through the CLI on an
    8-shard mesh."""
    import unittest.mock

    from tpu_gossip_torch import dist
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip_torch.core.packed import pack_state
    from tpu_gossip_torch.sim.engine import gossip_round
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    pins = json.loads((root / "tpu_gossip_torch" / "reference_pins.json").read_text())
    out = {}
    t0 = time.perf_counter()
    eight = mesh_setup_1m(dev, MESH_SHARDS)
    out["14a"] = dict(max_abs_err=check_k1_k2_mesh(dev, gen, eight))
    print(f"[{card}] 14a K1 over the 1M S={MESH_SHARDS} mesh's stacked blocks (every lane table) and K2 over its "
          f"shard-major class table equal their plain versions: max_abs_err {out['14a']['max_abs_err']}; K2 writes "
          f"zeros on every shard's pad rows", flush=True)
    runs = {}
    for setup in (one, eight):
        s, cfg, plan, mesh = setup["shards"], setup["cfg"], setup["plan_m"], setup["mesh"]
        part = "14b" if s == 1 else "14c"
        t1 = time.perf_counter()
        print(f"[{card}] {part} layout S={s}: rows {plan.rows} ({plan.per_rows} a shard), state rows {plan.n}, build "
              f"{setup['build_s']:.3f} s, build peak {setup['build_peak']} B", flush=True)
        local = mesh_coverage_run(dev, lambda st: gossip_round(st, cfg, setup["plan"]), setup["state"],
                                  f"{part} S={s} local", MESH_PATH)
        print(mesh_line(card, f"{part} S={s} the local engine on the same plan", local), flush=True)
        runs[(s, "local")] = local
        for name in ("dense", "sparse", "auto"):
            tr = None if name == "dense" else dist.build_transport(plan, mode=name, mesh=mesh)
            collect = s == MESH_SHARDS and name != "sparse"

            def step(st, tr=tr, collect=collect):
                return dist.gossip_round_dist(st, cfg, plan, mesh, transport=tr, collect_ici=collect)

            r = mesh_coverage_run(dev, step, setup["state"], f"{part} S={s} {name}", MESH_PATH)
            if (r["rounds"], r["digest"]) != (local["rounds"], local["digest"]):
                raise AssertionError(f"{part} S={s} {name}: ({r['rounds']}, {r['digest']}) != the local run's")
            if r["k1_entries"].get("lane_shuffle_t") or r["k1_entries"].get("tinv_lane_shuffle"):
                raise AssertionError(f"{part} S={s} {name}: a fused K1 entry ran on the mesh")
            modes = "" if tr is None else f", stage modes {tr.stage_mode}, budget {tr.budget}, active {tr.active}"
            print(mesh_line(card, f"{part} S={s} mesh {name}", r, f"; equal to the local run{modes}"), flush=True)
            runs[(s, name)] = r
        if s == 1:
            out["14b"] = dict(seconds=time.perf_counter() - t1)
    pin = pins["mesh_1m"]
    dense = runs[(MESH_SHARDS, "dense")]
    if dense["digest"] != pin["dense"]["state_digest"] or dense["rounds"] != pin["dense"]["rounds"] \
            or dense["ici"] != pin["dense"]["ici"]:
        raise AssertionError(f"14c S={MESH_SHARDS} dense: ({dense['rounds']}, {dense['digest']}, {dense['ici']}) != "
                             f"the JAX pin's {pin['dense']} ({pin['source']})")
    if runs[(MESH_SHARDS, "auto")]["ici"] != pin["auto"]["ici"]:
        raise AssertionError(f"14c auto: ICI {runs[(MESH_SHARDS, 'auto')]['ici']} != the JAX pin's {pin['auto']}")
    s8 = eight
    tr = dist.build_transport(s8["plan_m"], mode="sparse", mesh=s8["mesh"])
    fin, (stats, ici) = dist.simulate_dist(s8["state"], s8["cfg"], s8["plan_m"], s8["mesh"], dense["rounds"],
                                           transport=tr, collect_ici=True)
    got = {"state_digest": state_digest(fin), "stats_digest": stats_digest(stats),
           "ici": {f: int(getattr(ici, f).sum()) for f in ici._fields}}
    if got != {k: pin["sparse"][k] for k in got}:
        raise AssertionError(f"14c sparse replay: {got} != the JAX pin's {pin['sparse']}")
    print(f"[{card}] 14c S={MESH_SHARDS} dense run onto the JAX pin (digest, {dense['rounds']} rounds, ICI totals "
          f"{dense['ici']}); the sparse replay's digests and ICI totals {got['ici']} onto the JAX pin; auto's totals "
          f"onto the JAX pin (active {pin['auto']['active']})", flush=True)
    packed = mesh_coverage_run(dev, lambda st: dist.gossip_round_dist(st, s8["cfg"], s8["plan_m"], s8["mesh"],
                                                                      transport=tr),
                               pack_state(s8["state"]), f"14c S={MESH_SHARDS} packed sparse", PACKED_MESH_PATH,
                               packed=True)
    if (packed["rounds"], packed["digest"]) != (dense["rounds"], dense["digest"]):
        raise AssertionError("14c packed twin differs from the dense run")
    print(mesh_line(card, f"14c S={MESH_SHARDS} packed twin (sparse transport, the exchange on the words)", packed,
                    "; equal to the unpacked run"), flush=True)
    runs[(MESH_SHARDS, "packed")] = packed
    out["14c"] = dict(seconds=time.perf_counter() - t0 - out["14b"]["seconds"],
                      runs={f"S={s} {n}": {k: r[k] for k in ("rounds", "event_ms", "wall_ms", "peak", "launches",
                                                              "ici", "port_lanes")} for (s, n), r in runs.items()})
    del eight, fin, stats, s8

    t0 = time.perf_counter()
    mesh8 = dist.make_mesh(MESH_SHARDS, device=dev)
    builds = {}
    for name in ("block_keys", "dist"):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        if name == "dist":
            built = dist.matching_powerlaw_graph_dist(N_HEADLINE, mesh8, gamma=2.5, fanout=1, key=prng.key(0, dev))
        else:
            built = matching_powerlaw_graph_sharded(N_HEADLINE, MESH_SHARDS, gamma=2.5, fanout=1,
                                                    key=prng.key(0, dev), block_keys=True, device=dev)
        torch.cuda.synchronize(dev)
        builds[name] = dict(graph=built[0], plan=built[1], seconds=time.perf_counter() - t1,
                            peak=torch.cuda.max_memory_allocated(dev))
    plans_equal_leafwise(builds["dist"]["plan"], builds["dist"]["graph"], builds["block_keys"]["plan"],
                         builds["block_keys"]["graph"], "14d")
    print(f"[{card}] 14d --builder dist at 1M S={MESH_SHARDS} (CSR exported) equals the block-keyed build leaf for "
          f"leaf: dist {builds['dist']['seconds']:.3f} s, peak {builds['dist']['peak']} B; block-keyed "
          f"{builds['block_keys']['seconds']:.3f} s, peak {builds['block_keys']['peak']} B", flush=True)
    out["14d"] = dict(seconds=time.perf_counter() - t0, **{k: {"s": v["seconds"], "peak": v["peak"]}
                                                          for k, v in builds.items()})
    del builds

    t0 = time.perf_counter()
    make = dist.make_mesh
    with unittest.mock.patch.object(dist, "make_mesh",
                                    lambda n_shards=None, device="cuda": make(MESH_SHARDS, device=device)):
        for ref in pins["mesh"]:
            argv = [a for a in ref["argv"] if a != "--quiet"]
            what = f"14e run_sim {' '.join(a for a in ref['argv'] if a not in ('--digest', '--quiet'))}"
            r = cli_here(argv, dev)
            check_pin(r["summary"], ref, what)
            tail = "round_tail_words" if "--packed" in argv else "round_tail"
            check_launches(what, r["launches"], {"lane_shuffle": None, "fold_planes_or": None, tail: 1},
                           r["summary"]["rounds_run"])
            print(fault_line(card, what, r, f"; equal to the JAX pin on a {ref['shards']}-device mesh"), flush=True)
            del r
    out["14e"] = dict(seconds=time.perf_counter() - t0)
    return out


# ---------------------------------- phase 15: serving (ROADMAP item 12)

# bench.py::bench_serve's configuration: the swarm, the load and the run
BENCH_SERVE = dict(n=1_000_000, gamma=2.5, msg_slots=32, fanout=2, max_inject=1024, rounds=12, clients=8,
                   msgs_per_client=400)
# the matching engines under the same load through the CLI (15d), with
# bench_serve's window; paced at 20 rounds/s so the clients' lines land
# inside the 12 windows
SERVE_CLI = ["--peers", "1000000", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", "--slots", "16",
             "--rounds", "12", "--replay-check", "--quiet", "--rounds-per-sec", "20", "--max-inject", "1024"]
# a served round's launches: the exactly-k path (bench_serve) one tail; the
# matching paths a partner pass (K1, 7 launches on the mesh), a reduce (K2)
# and a tail (K3, K4 packed)
SERVE_XLA_PATH = dict(XLA_PATH)
SERVE_PROFILE_ROUNDS = 4  # the profiled replay's rounds: the loaded run's full windows land in rounds 1-3
SERVE_MATCHING_PATH = dict(MATCHING_PATH)
SERVE_PACKED_PATH = dict(PACKED_MATCHING_PATH)
SERVE_MESH_PATH = dict(MESH_PATH)


def check_served_tails(dev, gen, n_xla: int, n_matching: int) -> int:
    """K3 at the served shapes (bench_serve's rows by 32 slots, the matching
    headline's by 16) and K4 at the packed matching rows by 16 slots, each
    against its plain version, the stream's age-out mask live and absent,
    forward-once and SIR off and on."""
    from tpu_gossip_torch.core.packed import pack_bits
    from tpu_gossip_torch.kernels.round_tail import round_tail_words, tail_fused, tail_kernel, tail_words_plain

    err = 0
    rnd = torch.tensor(9, dtype=torch.int32, device=dev)
    for n, m in ((n_xla, BENCH_SERVE["msg_slots"]), (n_matching, M_SLOTS)):
        ops = tail_operands(n, m, gen, dev, rnd=9)
        args = (*(ops[k] for k in TAIL_PLANES), None, rnd)
        for fo, sir, use_exp in ((False, 0, True), (False, 0, False), (True, 4, True)):
            kw = dict(forward_once=fo, sir_recover_rounds=sir, expired=ops["expired"] if use_exp else None)
            for a, b in zip(tail_kernel(*args, **kw), tail_fused(*args, **kw)):
                err = max(err, max_err(a, b))
            if m == M_SLOTS:
                words = [pack_bits(ops[k]) if k != "infected_round" else ops[k] for k in TAIL_PLANES]
                got = round_tail_words(*words, None, rnd, m=m, pallas=True, **kw)
                want = tail_words_plain(*words, None, rnd, m=m, age_saturated=True, **kw)
                for a, b in zip(got, want):
                    err = max(err, max_err(a, b))
    return err


def serve_setup_1m(dev) -> dict:
    """bench_serve's swarm on the card: ``device_powerlaw_graph(1M,
    gamma=2.5, key 0)``, 32 slots, push_pull fanout 2, the state from key 0,
    a rate-0 stream with ``ttl = int(1.5 * min_feasible_ttl(1M, 2))``, the
    ingest plan (1024 a window, k = 1) and the serving step."""
    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.serve import build_step
    from tpu_gossip_torch.traffic import compile_stream, min_feasible_ttl
    from tpu_gossip_torch.traffic.ingest import IngestPlan

    c = BENCH_SERVE
    t0 = time.perf_counter()
    dg = device_powerlaw_graph(c["n"], gamma=c["gamma"], key=prng.key(0, dev), device=dev)
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=c["msg_slots"], fanout=c["fanout"], mode="push_pull")
    state = init_swarm(dg.as_padded_graph(), cfg, exists=dg.exists, key=prng.key(0, dev), device=dev)
    ttl = int(1.5 * min_feasible_ttl(c["n"], c["fanout"]))
    rows = np.flatnonzero(dg.exists.cpu().numpy())
    strm = compile_stream(rate=0.0, msg_slots=c["msg_slots"], ttl=ttl, origin_rows=rows, device=dev)
    plan = IngestPlan(msg_slots=c["msg_slots"], max_inject=c["max_inject"], k_hashes=1)
    torch.cuda.synchronize(dev)
    return dict(cfg=cfg, state=state, rows=rows, plan=plan, ttl=ttl, step=lambda: build_step(cfg, stream=strm),
                build_s=time.perf_counter() - t0)


def query_until_live(port: int, box: dict, timeout: float = 60.0) -> None:
    """``QUERY status`` lines to the frontend until its snapshot holds a
    round (``round`` >= 0) or the run ends: the last reply kept."""
    import socket

    from tpu_gossip_torch.serve.protocol import encode_query

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=10.0) as sock:
                sock.sendall(encode_query("status"))
                box["query"] = json.loads(sock.makefile().readline())
        except (OSError, ValueError):
            return
        if box["query"].get("round", -1) >= 0:
            return
        time.sleep(0.01)


def serve_run(dev, setup: dict, load: bool) -> dict:
    """One served run of ``BENCH_SERVE["rounds"]`` unpaced windows on the
    setup's state: with ``load``, the clients (8 x 400 lines, no jitter)
    and a QUERY client race the windows, as bench_serve's do. Launches
    counted from 0 and the device peak over the run; ms/round by wall, the
    accepted rate, the driver's busy share (its wall less its waits on the
    card's events)."""
    import threading

    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.serve import ServeDriver, ServeFrontend, run_load

    c = BENCH_SERVE
    fe = ServeFrontend(origin_rows=setup["rows"], max_inject=c["max_inject"], port=0)
    fe.start()
    box, threads = {}, []
    try:
        if load:
            threads = [threading.Thread(target=lambda: box.update(load=run_load(
                "127.0.0.1", fe.port, clients=c["clients"], msgs_per_client=c["msgs_per_client"], seed=0)),
                daemon=True), threading.Thread(target=query_until_live, args=(fe.port, box), daemon=True)]
            for t in threads:
                t.start()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
        native.reset_launches()
        driver = ServeDriver(setup["step"](), setup["state"], fe, setup["plan"], rounds=c["rounds"])
        fe.query_snapshot = driver.snapshot
        rep = driver.run()
        torch.cuda.synchronize(dev)
        launches = dict(native.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        for t in threads:
            t.join(timeout=120.0)
    finally:
        fe.stop()
    return dict(rep=rep, launches=launches, peak=peak, start=start, counters=fe.counters.as_dict(),
                ms=rep.wall_seconds * 1e3 / rep.rounds, busy=1.0 - rep.wait_seconds / rep.wall_seconds,
                accepted_per_s=rep.trace.total_arrivals / rep.wall_seconds, load=box.get("load"),
                query=box.get("query"))


def check_served(what: str, r: dict, rounds: int, want: dict) -> None:
    """A served run's trace has its rounds, every recorded arrival was
    offered to the card (deferred is not dropped), and the path launched
    what it must."""
    rep = r["rep"]
    if rep.trace.num_rounds != rounds:
        raise AssertionError(f"{what}: trace holds {rep.trace.num_rounds} rounds, needs {rounds}")
    if int(rep.stats.ingest_offered.sum()) != rep.trace.total_arrivals:
        raise AssertionError(f"{what}: ingest_offered {int(rep.stats.ingest_offered.sum())} != the trace's "
                             f"{rep.trace.total_arrivals} arrivals")
    check_launches(what, r["launches"], want, rounds)


def full_window(setup: dict, dev, seed: int):
    """A full window (``max_inject`` arrivals at seeded member rows with
    seeded payload hashes) of the setup's ingest plan on ``dev``."""
    import numpy as np

    from tpu_gossip_torch.traffic.ingest import make_batch

    j = setup["plan"].max_inject
    rng = np.random.default_rng(seed)
    return make_batch(setup["plan"], setup["rows"][rng.integers(0, len(setup["rows"]), j)],
                      [int(h) for h in rng.integers(0, 2**62, j)], device=dev)


def served_round_syncs(dev, setup: dict, state) -> list[str]:
    """Every host synchronisation two chained served rounds make, a full
    window landed in each (the step's one read of the state's round and key
    made before): ``torch.cuda.set_sync_debug_mode`` warns at each, and the
    port's innermost frame of each warning's stack is kept."""
    import traceback
    import warnings

    batch = full_window(setup, dev, 1)
    step = setup["step"]()
    state, _ = step(state, batch)
    torch.cuda.synchronize(dev)
    sites = set()

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            frames = [f for f in stack if "tpu_gossip_torch" in f.filename] or stack[-3:]
            sites.add(" <- ".join(f"{Path(f.filename).parent.name}/{Path(f.filename).name}:{f.lineno} ({f.line})"
                                  for f in reversed(frames[-3:])))

    torch.cuda.set_sync_debug_mode("warn")  # (its own notice is not a synchronisation)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = keep
        try:
            for _ in range(2):
                state, _ = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    return sorted(sites)


def ingest_window_ms(dev, setup: dict, state) -> dict:
    """The ingest stage at a full window (``max_inject`` arrivals) on the
    served state: ``apply_arrivals`` alone (unpacked states), and a whole
    served round with the full window against one with an empty window
    (CUDA events around back-to-back calls: the larger of the device's time
    and the host's launches)."""
    from tpu_gossip_torch.core.packed import is_packed
    from tpu_gossip_torch.traffic.ingest import apply_arrivals, empty_batch

    full = full_window(setup, dev, 2)
    rnd = state.round + 1

    def land():
        return apply_arrivals(full, rnd, seen=state.seen, infected_round=state.infected_round,
                              slot_lease=state.slot_lease, exists=state.exists, alive=state.alive,
                              declared_dead=state.declared_dead)

    step = setup["step"]()
    zero = empty_batch(setup["plan"], dev)
    return dict(apply_arrivals_ms=None if is_packed(state) else loop_ms(land, iters=5),
                round_full_ms=loop_ms(lambda: step(state, full), iters=5),
                round_empty_ms=loop_ms(lambda: step(state, zero), iters=5))


def matching_setup(dev, extra: list[str]) -> dict:
    """The 15d swarm ``run_sim serve`` builds for ``SERVE_CLI + extra``
    (``_serve_swarm``, the rate-0 stream, the step), for its served-round
    timings apart from the CLI's run."""
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.core.packed import pack_state
    from tpu_gossip_torch.serve import build_step
    from tpu_gossip_torch.traffic import compile_stream
    from tpu_gossip_torch.traffic.ingest import IngestPlan

    p = run_sim.build_parser()
    run_sim._add_serve_args(p)
    args = p.parse_args(SERVE_CLI + extra + ["--device", str(dev)])
    cfg, plan, mesh, rows, make_state = run_sim._serve_swarm(args, dev)
    strm = compile_stream(rate=0.0, msg_slots=args.slots, ttl=args.slot_ttl, origin_rows=rows, device=dev)
    state = make_state()
    return dict(cfg=cfg, state=pack_state(state) if args.packed else state, rows=rows,
                plan=IngestPlan(msg_slots=args.slots, max_inject=args.max_inject, k_hashes=args.stream_hashes),
                step=lambda: build_step(cfg, plan, mesh=mesh, stream=strm))


def serve_cli_run(root: Path, dev, argv: list[str], want: dict) -> dict:
    """``run_sim serve`` in this process under bench_serve's load (8 x 400
    lines, the clients connecting once the frontend listens), the live
    rounds' launches counted from 0 apart from the replay's; the summary,
    the launches, the live run's ms/round, peak and the driver's busy
    share."""
    import contextlib
    import io
    import socket
    import threading

    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.serve import ServeDriver, run_load

    c = BENCH_SERVE
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    box, live = {}, {}

    def clients():
        deadline = time.monotonic() + 300.0
        while time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
                break
            except OSError:
                time.sleep(0.01)
        box["load"] = run_load("127.0.0.1", port, clients=c["clients"], msgs_per_client=c["msgs_per_client"],
                               seed=0)

    plain_run = ServeDriver.run

    def counted(self):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        live["start"] = torch.cuda.memory_allocated(dev)
        native.reset_launches()
        rep = plain_run(self)
        torch.cuda.synchronize(dev)
        live.update(launches=dict(native.LAUNCHES), peak=torch.cuda.max_memory_allocated(dev),
                    busy=1.0 - rep.wait_seconds / rep.wall_seconds)
        native.reset_launches()
        return rep

    t = threading.Thread(target=clients, daemon=True)
    t.start()
    ServeDriver.run = counted
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run_sim.main(["serve", *argv, "--port", str(port), "--device", str(dev)])
        torch.cuda.synchronize(dev)
    finally:
        ServeDriver.run = plain_run
    t.join(timeout=120.0)
    if rc != 0:
        raise AssertionError(f"run_sim serve {' '.join(argv)} exited {rc}: {err.getvalue()[-2000:]}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    replay_launches = dict(native.LAUNCHES)
    rounds = summary["rounds_run"]
    check_launches(f"served {' '.join(argv[-4:])}", live["launches"], want, rounds)
    check_launches(f"replayed {' '.join(argv[-4:])}", replay_launches, want, rounds)
    if not summary["replay"]["bit_identical"]:
        raise AssertionError(f"run_sim serve {' '.join(argv)}: the replay diverged")
    sv = summary["serve"]
    if sv["ingest_offered"] != sv["trace_arrivals"] or sv["trace_rounds"] != rounds:
        raise AssertionError(f"run_sim serve {' '.join(argv)}: trace {sv['trace_rounds']} rounds, "
                             f"{sv['trace_arrivals']} arrivals, {sv['ingest_offered']} offered")
    return dict(summary=summary, launches={k: v for k, v in live["launches"].items() if v}, peak=live["peak"],
                start=live["start"], busy=live["busy"], load=box.get("load"), call_s=time.perf_counter() - t0)


def serve_line(card: str, what: str, r: dict) -> str:
    rep = r["rep"]
    st = rep.stats
    return (f"[{card}] {what}: {r['ms']} ms/round by wall over {rep.rounds} unpaced rounds, "
            f"{rep.trace.total_arrivals} arrivals accepted ({r['accepted_per_s']} msgs/s accepted), ingest offered "
            f"{int(st.ingest_offered.sum())} injected {int(st.ingest_injected.sum())} conflated "
            f"{int(st.ingest_conflated.sum())} overflow {int(st.ingest_overflow.sum())} (by round "
            f"{st.ingest_offered.tolist()}), driver busy share {r['busy']}, peak {r['peak']} B (from {r['start']} "
            f"B), launches {({k: v for k, v in r['launches'].items() if v})}, frontend {r['counters']}")


def serve_pin_replay(root: Path, setup: dict) -> dict:
    """15c: ``reference_pins.json``'s ``serve_1m`` trace (``scripted_trace``
    of its seed over bench_serve's members) replayed through the serving
    step onto the JAX package's digests and ingest sums."""
    from tpu_gossip_torch.serve import replay_trace, stack_round_stats
    from tpu_gossip_torch.serve.trace import scripted_trace
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    pin = json.loads((root / "tpu_gossip_torch" / "reference_pins.json").read_text())["serve_1m"]
    trace = scripted_trace(setup["plan"], setup["rows"], pin["config"]["rounds"], pin["config"]["seed"])
    fin, trail = replay_trace(trace, setup["step"](), setup["state"])
    stats = stack_round_stats(trail)
    got = dict(state_digest=state_digest(fin), stats_digest=stats_digest(stats), arrivals=trace.total_arrivals,
               ingest={k: int(getattr(stats, f"ingest_{k}").sum()) for k in ("offered", "injected", "conflated",
                                                                             "overflow")})
    for k, v in got.items():
        if v != pin[k]:
            raise AssertionError(f"15c: {k} {v} != the JAX pin's {pin[k]} ({pin['source']})")
    return got


def phase_serve(root: Path, dev, card: str, gen) -> dict:
    """Phase 15: the serving plane on the card (15a-15d)."""
    from tpu_gossip_torch.serve import replay_trace, stack_round_stats
    from tpu_gossip_torch.sim.profile import trace_rounds
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    parts = {}
    c = BENCH_SERVE
    t0 = time.perf_counter()
    setup = serve_setup_1m(dev)
    err = check_served_tails(dev, gen, setup["cfg"].n_peers, N_HEADLINE + 1)
    torch.cuda.synchronize(dev)
    print(f"[{card}] 15a: K3 at {setup['cfg'].n_peers} x {c['msg_slots']} and {N_HEADLINE + 1} x {M_SLOTS}, K4 at "
          f"{N_HEADLINE + 1} x {M_SLOTS}, each equal to its plain version: max_abs_err {err}; bench_serve's swarm "
          f"built in {setup['build_s']:.2f} s (ttl {setup['ttl']})", flush=True)
    parts["15a"] = dict(seconds=time.perf_counter() - t0, err=err)

    # 15b: bench_serve live, unloaded and loaded in turns on the same state
    t0 = time.perf_counter()
    turns = (("warm-up, unloaded", False), ("unloaded", False), ("loaded", True), ("loaded again", True),
             ("unloaded again", False))
    runs = {}
    for what, load in turns:
        runs[what] = r = serve_run(dev, setup, load)
        check_served(f"bench_serve {what}", r, c["rounds"], SERVE_XLA_PATH)
        print(serve_line(card, f"15b bench_serve n={c['n']} {what}", r), flush=True)
    loaded = runs["loaded"]
    quiet = [runs["unloaded"]["ms"], runs["unloaded again"]["ms"]]
    busy = [runs["loaded"]["ms"], runs["loaded again"]["ms"]]
    rep = loaded["rep"]
    if rep.trace.total_arrivals == 0 or loaded["load"] is None or loaded["load"].errors:
        raise AssertionError(f"15b: the load did not land: {loaded['load']}, {rep.trace.total_arrivals} arrivals")
    q = loaded["query"]
    if not isinstance(q, dict) or q.get("round", -1) < 0:
        raise AssertionError(f"15b: the QUERY reply {q!r} holds no round")
    live_sd, live_td = state_digest(rep.state), stats_digest(rep.stats)
    fin2, trail = replay_trace(rep.trace, setup["step"](), setup["state"])
    if (state_digest(fin2), stats_digest(stack_round_stats(trail))) != (live_sd, live_td):
        raise AssertionError("15b: the replay of the live trace diverged on the card")
    print(f"[{card}] 15b: the live run replays bit for bit on the card (state_digest {live_sd}, stats_digest "
          f"{live_td}); QUERY status -> {q}; loaded {busy} against unloaded {quiet} ms/round: loaded/unloaded "
          f"{sum(busy) / sum(quiet)}", flush=True)
    marks = {"runs and replay": time.perf_counter() - t0}
    # the profiler over the trace's first rounds (its full windows among them)
    batches = list(rep.trace.batches(dev))[:SERVE_PROFILE_ROUNDS]
    step = setup["step"]()
    feed = iter(batches)
    prof = trace_rounds(setup["state"], lambda s: step(s, next(feed)), len(batches))
    marks["profiler"] = time.perf_counter() - t0
    ingest = ingest_window_ms(dev, setup, rep.state)
    marks["ingest"] = time.perf_counter() - t0
    syncs = served_round_syncs(dev, setup, rep.state)
    marks["syncs"] = time.perf_counter() - t0
    print(f"[{card}] 15b replayed under torch.profiler ({len(batches)} rounds): {prof['wall_ms_per_round']} "
          f"ms/round wall, "
          f"{prof['device_ms_per_round']} ms device, device busy share {prof['device_busy_share']}, top kernels "
          f"{prof['top_kernels_ms_per_round'][:8]}", flush=True)
    print(f"[{card}] 15b ingest at a full window ({c['max_inject']} arrivals): apply_arrivals "
          f"{ingest['apply_arrivals_ms']} ms, a served round {ingest['round_full_ms']} ms against "
          f"{ingest['round_empty_ms']} ms with an empty window; host synchronisations in a served round: "
          f"{len(syncs)} {syncs}; 15b's seconds so far by step {marks}", flush=True)
    parts["15b"] = dict(seconds=time.perf_counter() - t0, loaded_ms=busy, unloaded_ms=quiet,
                        accepted_per_s=[r["accepted_per_s"] for r in runs.values() if r["rep"].trace.total_arrivals],
                        ingest=ingest, syncs=syncs, busy=loaded["busy"], device_busy=prof["device_busy_share"],
                        peak=loaded["peak"], launches=loaded["launches"])

    # 15c: a numpy-seeded 1M trace replayed on the card onto the JAX pin
    t0 = time.perf_counter()
    got = serve_pin_replay(root, setup)
    print(f"[{card}] 15c: the seeded 1M trace ({got['arrivals']} arrivals, overflow {got['ingest']['overflow']}) "
          f"replays on the card onto the JAX pin: state_digest {got['state_digest']}", flush=True)
    parts["15c"] = dict(seconds=time.perf_counter() - t0)
    del setup, runs, loaded, rep, fin2, trail, batches

    # 15d: the matching engines through run_sim serve under the same load
    t0 = time.perf_counter()
    from tpu_gossip_torch.traffic import min_feasible_ttl

    ttl = ["--slot-ttl", str(min_feasible_ttl(N_HEADLINE, 1, "push_pull"))]
    cli = {}
    for what, extra, want in (("local", [], SERVE_MATCHING_PATH), ("packed", ["--packed"], SERVE_PACKED_PATH),
                              ("mesh S=1", ["--shard"], SERVE_MESH_PATH)):
        r = serve_cli_run(root, dev, SERVE_CLI + ttl + extra, want)
        s = r["summary"]
        cli[what] = r
        print(f"[{card}] 15d run_sim serve matching {what}: {s['serve']['ms_per_round']} ms/round paced, "
              f"{s['serve']['trace_arrivals']} arrivals (overflow {s['serve']['ingest_overflow']}), replay "
              f"bit_identical {s['replay']['bit_identical']}, driver busy share {r['busy']}, peak {r['peak']} B (from "
              f"{r['start']} B), live launches {r['launches']}, coverage {s['final_coverage']}, state_digest "
              f"{s['state_digest']}, {r['call_s']:.2f} s for the call", flush=True)
        ms = matching_setup(dev, ttl + extra)
        r["ingest"] = ingest_window_ms(dev, ms, ms["state"])
        r["syncs"] = served_round_syncs(dev, ms, ms["state"])
        del ms
        print(f"[{card}] 15d {what}: a served round {r['ingest']['round_full_ms']} ms with a full window "
              f"({c['max_inject']} arrivals) against {r['ingest']['round_empty_ms']} ms with an empty one"
              + ("" if r["ingest"]["apply_arrivals_ms"] is None else
                 f", apply_arrivals {r['ingest']['apply_arrivals_ms']} ms")
              + f"; host synchronisations in a served round: {len(r['syncs'])} {r['syncs']}", flush=True)
    parts["15d"] = dict(seconds=time.perf_counter() - t0, cli={k: dict(busy=v["busy"], peak=v["peak"],
                                                                      launches=v["launches"], ingest=v["ingest"],
                                                                      syncs=v["syncs"])
                                                              for k, v in cli.items()})
    return parts


# phase 16: the tpu-sim transport (compat/simnet.py) launches the exactly-k round's kernels: K3 once a round
SIMNET_PATH = dict(XLA_PATH, lane_gather=0, sublane_gather=0)
CURVE_FANOUT, CURVE_TICK = 3, 0.08  # tests/conformance/test_curves.py's push fanout and socket tick
# (peers, rounds, |r50 diff|, |r99 diff|): its tier-1 40-peer case and its slow 1k case's tolerances
CURVE_LEGS = ((40, 25, 3, 5), (1000, 20, 2, 3))
CURVE_FDS = 10_000  # the 1k leg's descriptors: 1000 servers and ~2 x 3000 connections
CLI_SEEDS, CLI_PEERS = 2, 4


def simnet_addr(i: int) -> tuple:
    """Peer ``i``'s address in the 1M swarm (``tests/jax_pins.py::simnet_addr``)."""
    return (f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", 9000)


def check_simnet_tail(dev, gen, n: int, m: int) -> int:
    """K3 at 16a's shape against its plain version, with the flags of the
    exactly-k push round (no churn ``fresh``, no ``expired`` mask, the
    unsaturated SIR age), forward-once and SIR off and on."""
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    err = 0
    ops = tail_operands(n, m, gen, dev, rnd=9)
    args = (*(ops[k] for k in TAIL_PLANES), None, torch.tensor(9, dtype=torch.int32, device=dev))
    for fo, sir in ((False, 0), (True, 4)):
        kw = dict(forward_once=fo, sir_recover_rounds=sir, age_saturated=False, expired=None)
        for a, b in zip(tail_kernel(*args, **kw), tail_fused(*args, **kw)):
            err = max(err, max_err(a, b))
    return err


def simnet_swarm(dev, card: str, pin: dict, gen) -> dict:
    """16a: K3 at the swarm's shape against its plain version; then the
    pin's swarm through ``PeerNode(transport="tpu-sim")`` and
    ``SimCluster`` on ``dev``: registration, ``materialize``, the three
    messages, ``step(R)``, the victims killed and silenced, ``step(12)``,
    each against the JAX pin; launches counted from 0 over the two steps."""
    import numpy as np

    from tpu_gossip_torch.compat.peer import PeerNode
    from tpu_gossip_torch.compat.simnet import SimCluster
    from tpu_gossip_torch.kernels import native
    from tpu_gossip_torch.sim.metrics import coverage_curve, rounds_to_coverage
    from tpu_gossip_torch.utils.digest import state_digest, stats_digest

    c = pin["config"]
    n, rounds = c["n"], pin["rounds"]
    k3_err = check_simnet_tail(dev, gen, n, c["msg_slots"])
    torch.cuda.synchronize(dev)
    print(f"[{card}] 16a: K3 at {n} x {c['msg_slots']} (the exactly-k push round's flags, forward-once and SIR "
          f"off and on) equal to its plain version: max_abs_err {k3_err}", flush=True)
    cluster = SimCluster(msg_slots=c["msg_slots"], fanout=c["fanout"], mode=c["mode"], seed=c["seed"], device=dev)
    t0 = time.perf_counter()
    peers = [PeerNode(*simnet_addr(i), transport="tpu-sim", cluster=cluster) for i in range(n)]
    register_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cluster.materialize(m=c["m"])
    torch.cuda.synchronize(dev)
    materialize_s = time.perf_counter() - t0
    origins = [int(np.argmax(cluster._graph.degrees)), 0, n - 1]
    if origins != pin["origins"]:
        raise AssertionError(f"16a: origins {origins} != the JAX pin's {pin['origins']}: another graph")
    for i, text in zip(origins, pin["texts"]):
        peers[i].gossip(text)
    victims = np.random.default_rng(c["victims_seed"]).choice(n, size=c["kill"] + c["silence"], replace=False)
    killed, silenced = victims[:c["kill"]].tolist(), victims[c["kill"]:].tolist()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    native.reset_launches()
    ev[0].record()
    first = cluster.step(rounds)
    ev[1].record()
    mid = cluster.state
    for i in killed:
        cluster.kill(peers[i].addr)
    for i in silenced:
        peers[i].set_silent(True)
    ev[2].record()
    second = cluster.step(c["after"])
    ev[3].record()
    torch.cuda.synchronize(dev)
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    check_launches("16a tpu-sim", launches, SIMNET_PATH, rounds + c["after"])
    got = {"steps": [{"stats_digest": stats_digest(first), "state_digest": state_digest(mid)},
                     {"stats_digest": stats_digest(second), "state_digest": state_digest(cluster.state)}],
           "declared_dead": sum(cluster.is_declared_dead(peers[i].addr) for i in killed + silenced)}
    for k, v in got.items():
        if v != pin[k]:
            raise AssertionError(f"16a: {k} {v} != the JAX pin's {pin[k]} ({pin['source']})")
    coverage = [cluster.coverage(t) for t in pin["texts"]]
    curve = coverage_curve(first)
    worst = max(max(abs(a - b) for a, b in zip(coverage, pin["coverage"])),
                max(abs(float(a) - b) for a, b in zip(curve, pin["curve"])))
    if worst > 1e-6:
        raise AssertionError(f"16a: coverages {coverage} or the curve differ from the JAX pin's by {worst}")
    r99 = rounds_to_coverage(first, 0.99)
    if r99 != rounds:
        raise AssertionError(f"16a: coverage_curve passes 99% at round {r99}, the pin's horizon is {rounds}")
    r = dict(k3_err=k3_err, register_s=register_s, materialize_s=materialize_s, rounds=rounds, r99=r99,
             ms_first=ev[0].elapsed_time(ev[1]) / rounds, ms_after=ev[2].elapsed_time(ev[3]) / c["after"],
             peak=peak, resident=resident, launches=launches, coverage=coverage,
             declared_dead=got["declared_dead"], worst=worst)
    print(f"[{card}] 16a tpu-sim swarm n={n} m={c['msg_slots']} push fanout {c['fanout']}: registered "
          f"{n} PeerNode(transport='tpu-sim') in {register_s:.2f} s, materialize(m={c['m']}) {materialize_s:.2f} s "
          f"(the native PA build, CSR and the state on the card); step({rounds}) {r['ms_first']} ms/round and, "
          f"after {c['kill']} kills and {c['silence']} silenced, step({c['after']}) {r['ms_after']} ms/round (CUDA "
          f"events); rounds to 99% from coverage_curve {r99}; max_memory_allocated {peak} B (from {resident} B "
          f"resident); launches {launches}; declared dead {got['declared_dead']} of {c['kill'] + c['silence']}; "
          f"coverages {coverage} (max |diff| to the pin {worst}); state_digest {got['steps'][1]['state_digest']} "
          f"and both stats digests equal to the JAX pin", flush=True)
    return r


async def socket_curve(graph, origin: int, rounds: int, tmp: Path) -> list:
    """``tests/conformance/test_curves.py::socket_curve`` on the port's
    ``PeerNode``: barrier-stepped push gossip over localhost sockets."""
    import asyncio

    from tpu_gossip_torch.compat.peer import PeerNode
    from tpu_gossip_torch.compat.timing import ProtocolTiming

    n = graph.n
    timing = ProtocolTiming(gossip_period=CURVE_TICK, heartbeat_period=10.0, detect_period=10.0,
                            heartbeat_timeout=60.0)
    addrs = [("127.0.0.1", p) for p in free_ports(n)]
    peers = [PeerNode(*a, timing=timing, relay_mode="manual", fanout=CURVE_FANOUT, log_dir=str(tmp)) for a in addrs]
    try:
        for p in peers:
            await p.start_detached()
        for i, p in enumerate(peers):
            await p.connect_to([addrs[j] for j in graph.neighbors(i) if j > i])
        await asyncio.sleep(CURVE_TICK)
        peers[origin].gossip("conformance-msg")
        curve = []
        for _ in range(rounds):
            snaps = [list(p.seen_messages) for p in peers]
            for p, snap in zip(peers, snaps):
                await p.push_tick(snap)
            # settle: three stable polls of the round's coverage
            deadline, prev, stable = asyncio.get_event_loop().time() + 2.0, -1, 0
            while asyncio.get_event_loop().time() < deadline and stable < 3:
                cur = sum(p.has_seen("conformance-msg") for p in peers)
                stable, prev = (stable + 1 if cur == prev else 0), cur
                await asyncio.sleep(0.01)
            curve.append(sum(p.has_seen("conformance-msg") for p in peers) / n)
        return curve
    finally:
        for p in peers:
            if p.running:
                await p.stop()


def free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def sim_curve(dev, graph, origin: int, rounds: int, seed: int) -> list:
    """``test_curves.py::sim_curve`` on the card: the message's coverage a
    round through ``SimCluster.step(1)``."""
    from tpu_gossip_torch.compat.peer import PeerNode
    from tpu_gossip_torch.compat.simnet import SimCluster

    cluster = SimCluster(msg_slots=8, fanout=CURVE_FANOUT, seed=seed, device=dev)
    peers = [PeerNode("10.0.0.1", 9000 + i, transport="tpu-sim", cluster=cluster) for i in range(graph.n)]
    cluster.materialize(graph=graph)
    peers[origin].gossip("conformance-msg")
    curve = []
    for _ in range(rounds):
        cluster.step(1)
        curve.append(cluster.coverage("conformance-msg"))
    return curve


def rounds_to(curve: list, frac: float) -> int:
    hit = [i for i, c in enumerate(curve) if c >= frac]
    return hit[0] + 1 if hit else len(curve) + 10


def curve_leg(dev, card: str, n: int, rounds: int, tol50: int, tol99: int, tmp: Path) -> dict:
    """One leg of 16b: the socket curve and three card curves on
    ``default_rng(42)``'s fixed PA graph, held to ``test_curves.py``'s
    tolerances at this size."""
    import asyncio
    from statistics import median

    import numpy as np

    from tpu_gossip_torch.core.topology import build_csr, preferential_attachment

    graph = build_csr(n, preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(42)))
    origin = int(np.argmax(graph.degrees))
    t0 = time.perf_counter()
    sock = asyncio.run(socket_curve(graph, origin, rounds, tmp))
    sock_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sims = [sim_curve(dev, graph, origin, rounds, s) for s in range(3)]
    sim_s = time.perf_counter() - t0
    r = {"socket": (rounds_to(sock, 0.5), rounds_to(sock, 0.99)),
         "sims": [(rounds_to(c, 0.5), rounds_to(c, 0.99)) for c in sims]}
    s50, s99 = median(a for a, _ in r["sims"]), median(b for _, b in r["sims"])
    bad = []
    if sock[-1] < 0.99 or any(c[-1] < 0.99 for c in sims):
        bad.append(f"final coverage socket {sock[-1]}, sims {[c[-1] for c in sims]}")
    if abs(r["socket"][0] - s50) > tol50 or abs(r["socket"][1] - s99) > tol99:
        bad.append(f"rounds to 50%/99% socket {r['socket']} against the sims' medians {s50}/{s99}")
    if any(b < a - 1e-9 for a, b in zip(sock, sock[1:])):
        bad.append("the socket curve falls")
    if n == CURVE_LEGS[0][0]:
        mean = np.mean(np.asarray(sims), axis=0)
        if np.max(np.abs(np.asarray(sock)[2:rounds - 5] - mean[2:rounds - 5])) > 0.35:
            bad.append("mid-curve gap > 0.35")
    if bad:
        raise AssertionError(f"16b n={n}: {'; '.join(bad)}")
    print(f"[{card}] 16b n={n} fixed PA graph (default_rng(42), hub origin {origin}), {rounds} rounds: socket "
          f"(barrier-stepped, {n} localhost PeerNodes, {sock_s:.2f} s) rounds to 50%/99% {r['socket']}; SimCluster "
          f"on the card, seeds 0-2 ({sim_s:.2f} s) {r['sims']}, medians {s50}/{s99}; within |{tol50}|/|{tol99}|",
          flush=True)
    return dict(r, sock_s=sock_s, sim_s=sim_s)


def conformance_curves(dev, card: str, tmp: Path) -> dict:
    """16b: the 40-peer leg, then the 1k leg with ``RLIMIT_NOFILE`` raised
    to ``CURVE_FDS`` (restored after; the leg says it did not run when the
    limit cannot be raised)."""
    import resource

    out = {}
    n, rounds, tol50, tol99 = CURVE_LEGS[0]
    out[n] = curve_leg(dev, card, n, rounds, tol50, tol99, tmp)
    n, rounds, tol50, tol99 = CURVE_LEGS[1]
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    raised = False
    if soft < CURVE_FDS:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (CURVE_FDS, hard))
            raised = True
        except (ValueError, OSError):
            print(f"[{card}] 16b n={n}: did not run: RLIMIT_NOFILE {soft}/{hard} cannot be raised to {CURVE_FDS}",
                  flush=True)
            return out
    try:
        out[n] = curve_leg(dev, card, n, rounds, tol50, tol99, tmp)
    finally:
        if raised:
            resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    return out


def wait_for(cond, what: str, procs: list, timeout: float = 60.0) -> None:
    """Poll ``cond`` until it holds; fail on timeout or a process that died."""
    deadline = time.monotonic() + timeout
    while not cond():
        dead = [p.args for p in procs if p.poll() is not None]
        if dead or time.monotonic() > deadline:
            raise AssertionError(f"16c: {what}: " + (f"{dead} exited" if dead else f"not within {timeout} s"))
        time.sleep(0.05)


def cli_swarm(root: Path, card: str, tmp: Path) -> dict:
    """16c: ``run_seed`` twice and ``run_peer`` four times from the port on a
    temporary ``config.txt`` at ``--time-scale 0.01``: one stdin line
    gossiped at the last peer and one at the first reach every other peer's
    log, then ``exit`` on every node's stdin, each process exiting 0."""
    import os

    config = tmp / "config.txt"
    config.write_text("")
    ports = free_ports(CLI_SEEDS + CLI_PEERS)
    env = dict(os.environ, PYTHONPATH=str(root))
    log = lambda name: (tmp / name).read_text() if (tmp / name).exists() else ""  # noqa: E731

    def start(module: str, port: int) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, "-m", f"tpu_gossip_torch.cli.{module}", "--port", str(port),
                                 "--config", str(config), "--time-scale", "0.01", "--quiet"], cwd=tmp, env=env,
                                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    seeds = [start("run_seed", p) for p in ports[:CLI_SEEDS]]
    procs = list(seeds)
    try:
        wait_for(lambda: all(f"127.0.0.1:{p}" in config.read_text() and "Seed listening" in log(f"seed_log_{p}.txt")
                             for p in ports[:CLI_SEEDS]), "the seeds' start", procs)
        peers = []
        for p in ports[CLI_SEEDS:]:
            peers.append(start("run_peer", p))
            procs.append(peers[-1])
            wait_for(lambda: "Peer up" in log(f"peer_log_{p}.txt"), f"peer {p}'s bootstrap", procs)
        up_s = time.perf_counter() - t0
        lines = {0: "chip-smoke-line-from-the-first-peer", CLI_PEERS - 1: "chip-smoke-line-from-the-last-peer"}
        for k, text in lines.items():
            peers[k].stdin.write(text + "\n")
            peers[k].stdin.flush()
        t1 = time.perf_counter()
        for k, text in lines.items():
            for j, p in enumerate(ports[CLI_SEEDS:]):
                if j != k:
                    wait_for(lambda: f"Gossip: {text}" in log(f"peer_log_{p}.txt"), f"{text!r} at peer {p}", procs)
        relay_s = time.perf_counter() - t1
        codes = []
        for proc in peers + seeds:
            proc.stdin.write("exit\n")
            proc.stdin.flush()
            codes.append(proc.wait(timeout=60))
        if any(codes):
            raise AssertionError(f"16c: exit codes {codes}: {[p.stderr.read()[-2000:] for p in procs]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    registered = sum(log(f"seed_log_{p}.txt").count("Registered peer") for p in ports[:CLI_SEEDS])
    r = dict(up_s=up_s, relay_s=relay_s, codes=codes, registered=registered, seconds=time.perf_counter() - t0)
    print(f"[{card}] 16c: {CLI_SEEDS} run_seed and {CLI_PEERS} run_peer processes (--time-scale 0.01) up in "
          f"{up_s:.2f} s ({registered} registrations logged by the seeds), two stdin lines in every other peer's log "
          f"{relay_s:.2f} s after they were sent, 'exit' to every node: exit codes {codes}", flush=True)
    return r


def phase_simnet(root: Path, dev, card: str, gen) -> dict:
    """Phase 16: the tpu-sim transport on the card (16a), the conformance
    curves (16b) and the socket CLIs (16c)."""
    import tempfile

    parts = {}
    pin = json.loads((root / "tpu_gossip_torch" / "reference_pins.json").read_text())["simnet_1m"]
    t0 = time.perf_counter()
    parts["16a"] = simnet_swarm(dev, card, pin, gen)
    parts["16a"]["seconds"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        parts["16b"] = dict(legs=conformance_curves(dev, card, Path(d)), seconds=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        parts["16c"] = cli_swarm(root, card, Path(d))
    return parts


def check_launches(what: str, launches: dict, want: dict, rounds: int) -> None:
    """Fail unless ``launches`` (counted from 0 over one path) are what the
    path must launch: per round, or at least once where ``want`` says None."""
    for key, per_round in want.items():
        got = launches[key]
        if (got == 0) if per_round is None else (got != per_round * rounds):
            need = "at least 1" if per_round is None else f"{per_round * rounds} ({per_round}/round)"
            raise AssertionError(f"{what} path launched {key} {got} times, needs {need}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    card = card_line()
    print(card, flush=True)
    return smoke(root, torch.device("cuda", 0), card)


def smoke(root: Path, dev: torch.device, card: str) -> int:
    """Every phase on ``dev``; raises on the first that fails."""
    t_script = time.perf_counter()
    from tpu_gossip_torch.core.matching_topology import plan_shape
    from tpu_gossip_torch.kernels import native

    # phase 1: build every kernel and the host library from the checkout's sources, in parallel
    from tpu_gossip_torch import native as host_native

    t0 = time.perf_counter()
    pa_job = host_native.start_build()
    native.build_all()
    host_native.finish_build(pa_job)
    for name in native.SOURCES:
        native.library(name)
    host_native.library()
    print(f"build: {len(native.SOURCES)} kernel sources ({', '.join(native.SOURCES)}) and the host PA library in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2: each kernel against its plain version on the card, exactly (K6 at phase 4f)
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph

    _, _, classes, rows = plan_shape(N_HEADLINE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {"lane_shuffle": check_k1(dev, gen, rows),
            "fold_planes": check_k2(dev, gen, classes, rows),
            "round_tail": check_k3(dev, gen, N_HEADLINE + 1),
            "round_tail_words": check_k4(dev, gen, N_HEADLINE + 1),
            "staircase_segment": check_k5(dev, gen, device_powerlaw_graph(N_HEADLINE, key=prng.key(0, dev),
                                                                          device=dev))}
    torch.cuda.synchronize()
    print(f"kernels equal their plain versions: {errs}", flush=True)

    # phase 3: the JAX-pinned digests at n=20000 through the port's CLI
    for got in phase_digest(root, dev):
        print(f"n={got['n_peers']} digests equal the JAX reference: {got['mode']} {got['state_digest']} "
              f"{got['stats_digest']}", flush=True)

    # phase 4a: the matching headline, every launch counted from 0
    torch.cuda.reset_peak_memory_stats(dev)
    native.reset_launches()
    hgraph, plan, run = phase_headline(dev, N_HEADLINE)
    launches = dict(native.LAUNCHES)
    k1_entries = dict(native.K1_ENTRIES)
    peak = run["peak"]
    rounds = run["rounds"]
    check_launches("matching", launches, MATCHING_PATH, rounds)
    if launches["fold_planes_sum"] != 1:
        raise AssertionError(f"the matching plan's build launched fold_planes_sum {launches['fold_planes_sum']} "
                             "times, needs 1")
    print(f"[{card}] headline n={N_HEADLINE} m={M_SLOTS} push_pull fanout 1: "
          f"plan build {run['build_s']} s, rounds to 99% {rounds}, coverage {run['coverage']}, "
          f"{run['run_s'] * 1e3 / rounds} ms/round, {N_HEADLINE * rounds / run['run_s']} peers*rounds/s, "
          f"max_memory_allocated {peak} B (run alone {run['run_peak']} B), final state_digest {run['digest']}", flush=True)
    print(f"[{card}] matching-path launches: {launches}; K1 by entry {k1_entries}", flush=True)
    print(f"[{card}] one partner pass of the headline plan: {partner_pass_counts(plan, dev)}", flush=True)
    print(f"[{card}] one reduce of the headline plan: {reduce_kernels(plan, dev)}", flush=True)

    # phase 4b: the staircase path, counted from 0: graph and plans built
    # on the card, run to 99% through K5
    torch.cuda.reset_peak_memory_stats(dev)
    native.reset_launches()
    dgraph, splan, sinfo = phase_staircase(dev, N_HEADLINE)
    srun = run_to_coverage(dev, dgraph, N_HEADLINE, splan, "staircase")
    s_launches = dict(native.LAUNCHES)
    s_peak = srun["peak"]
    check_launches("staircase", s_launches, STAIRCASE_PATH, srun["rounds"])
    print(f"[{card}] staircase n={N_HEADLINE} gamma=2.5 m={M_SLOTS} push_pull fanout 1: {sinfo}", flush=True)
    print(f"[{card}] staircase run: plan build (host) {sinfo['host_plan_s']} s, rounds to 99% {srun['rounds']}, "
          f"coverage {srun['coverage']}, {srun['run_s'] * 1e3 / srun['rounds']} ms/round, "
          f"{N_HEADLINE * srun['rounds'] / srun['run_s']} peers*rounds/s, max_memory_allocated {s_peak} B, "
          f"final state_digest {srun['digest']}",
          flush=True)
    print(f"[{card}] staircase-path launches: {s_launches}", flush=True)

    # phase 4c: the exactly-k XLA delivery (the CLI's default) on the same graph
    native.reset_launches()
    xrun = run_to_coverage(dev, dgraph, N_HEADLINE, None, "exactly-k")
    check_launches("exactly-k", dict(native.LAUNCHES), XLA_PATH, xrun["rounds"])
    print(f"[{card}] exactly-k XLA run on the same graph: rounds to 99% {xrun['rounds']}, coverage "
          f"{xrun['coverage']}, {xrun['run_s'] * 1e3 / xrun['rounds']} ms/round, "
          f"run max_memory_allocated {xrun['run_peak']} B, final state_digest {xrun['digest']}", flush=True)

    # phases 4d and 4e: the packed twins of 4a (same state and plan) and of
    # 4c (same graph), counted from 0, each digest-equal to its twin
    packed_launches = {}
    for what, graph, pplan, twin, want in (("packed matching", hgraph, plan, run, PACKED_MATCHING_PATH),
                                           ("packed exactly-k", dgraph, None, xrun, PACKED_XLA_PATH)):
        native.reset_launches()
        prun = run_to_coverage(dev, graph, N_HEADLINE, pplan, what, packed=True)
        packed_launches[what] = dict(native.LAUNCHES)
        check_launches(what, packed_launches[what], want, prun["rounds"])
        for k in ("rounds", "digest"):
            if prun[k] != twin[k]:
                raise AssertionError(f"{what} run's {k} {prun[k]} != its unpacked twin's {twin[k]}")
        print(f"[{card}] {what} n={N_HEADLINE} m={M_SLOTS} push_pull fanout 1: rounds to 99% "
              f"{prun['rounds']}, coverage {prun['coverage']}, {prun['run_s'] * 1e3 / prun['rounds']} ms/round "
              f"(unpacked {twin['run_s'] * 1e3 / twin['rounds']}), {N_HEADLINE * prun['rounds'] / prun['run_s']} "
              f"peers*rounds/s, run max_memory_allocated {prun['run_peak']} B (unpacked {twin['run_peak']} B), "
              f"final state digest equal to the unpacked twin's", flush=True)
        print(f"[{card}] {what}-path launches: {packed_launches[what]}", flush=True)

    # phases 4f, 4g and 4h: the bucketed sharded engine over 4b's graph on
    # a one-shard mesh (run_sim --shard --staircase, its scatter twin, its
    # packed twin), counted from 0, all three digest-equal
    shard = shard_setup(dev, N_HEADLINE)
    print(f"[{card}] sharded set-up n={N_HEADLINE} gamma=2.5, one-shard mesh: {shard['info']}", flush=True)
    # K6 against its plain version, on this set-up's plan among others (phase
    # 2's check, made here so the set-up is built once and 4a-4e's peaks exclude it)
    errs["stream_segment"] = check_k6(dev, gen, shard)
    print(f"K6 equals its plain version: {errs['stream_segment']}", flush=True)
    shard_runs, shard_launches = {}, {}
    for what, pl, packed, want in (("sharded staircase", shard["plan"], False, SHARD_STAIRCASE_PATH),
                                   ("sharded scatter", None, False, SHARD_SCATTER_PATH),
                                   ("sharded packed", shard["plan"], True, SHARD_PACKED_PATH)):
        native.reset_launches()
        r = run_sharded(dev, shard, pl, what, packed)
        shard_launches[what] = dict(native.LAUNCHES)
        check_launches(what, shard_launches[what], want, r["rounds"])
        if shard_runs:
            first = shard_runs["sharded staircase"]
            for k in ("rounds", "digest"):
                if r[k] != first[k]:
                    raise AssertionError(f"{what} run's {k} {r[k]} != the K6 run's {first[k]}")
        shard_runs[what] = r
        print(f"[{card}] {what} n={N_HEADLINE} m={M_SLOTS} push_pull fanout 1: rounds to 99% {r['rounds']}, "
              f"coverage {r['coverage']}, {r['run_s'] * 1e3 / r['rounds']} ms/round, "
              f"{N_HEADLINE * r['rounds'] / r['run_s']} peers*rounds/s, run max_memory_allocated {r['run_peak']} B"
              + (f", final state_digest {r['digest']}" if what == "sharded staircase"
                 else ", final state digest equal to the K6 run's"), flush=True)
        print(f"[{card}] {what}-path launches: {shard_launches[what]}", flush=True)

    # phases 4i-4o: BASELINE config 5 (churn and re-wiring) at 1M on every
    # delivery path, each counted from 0 (the 1M churn pin is the JAX CLI's)
    t0 = time.perf_counter()
    pin = [r for r in json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
           if "--churn-join" in r["argv"] and "1000000" in r["argv"]][0]
    churn_launches = phase_churn(dev, card, hgraph, plan, dgraph, splan, shard,
                                 dict(pin["summary"], source=pin["source"]))
    print(f"[{card}] phases 4i-4o: {time.perf_counter() - t0:.2f} s; launches by phase {churn_launches}",
          flush=True)

    # phase 5: kernel times at each path's shapes
    times = phase_timing(plan, dev, gen, N_HEADLINE)
    times["staircase_segment"] = time_k5(splan, dev, gen)
    times["stream_segment"] = time_k6(shard, dev, gen)
    path_launches = dict(launches, lane_shuffle_t=k1_entries["lane_shuffle_t"],
                         tinv_lane_shuffle=k1_entries["tinv_lane_shuffle"],
                         staircase_segment=s_launches["staircase_segment"],
                         round_tail_words=packed_launches["packed matching"]["round_tail_words"],
                         stream_segment=shard_launches["sharded staircase"]["stream_segment"])
    kernels = []
    for name, key, source, replaces, err_key in KERNELS:
        t = times[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[key], "max_abs_err": errs[err_key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": t["library_ms"],
        })
        lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3} us"
        loop = "" if t.get("loop_ms") is None else f", back-to-back calls {t['loop_ms'] * 1e3} us"
        loop += "" if t.get("warm_ms") is None else (f"; timed with L2 cold (an empty launch timed so: "
                                                     f"{t['empty_ms'] * 1e3} us), L2 warm {t['warm_ms'] * 1e3} us")
        loop += "" if t.get("wrapper_ms") is None else f", wrapper with its check {t['wrapper_ms'] * 1e3} us"
        loop += "" if t.get("by_kind") is None else f"; each block kind alone {t['by_kind']}"
        reads = "" if t.get("windows_read") is None else f", {t['windows_read']} stream windows read"
        print(f"[{card}] {name}: {t['ms'] * 1e3} us, bound {kernels[-1]['bound_ms'] * 1e3} us "
              f"({t['bytes']} B{reads}), plain {t['plain_ms'] * 1e3} us, library {lib}{loop}", flush=True)

    pp = times["partner_pass"]
    print(f"[{card}] partner pass ({pp['launches']} K1 launches, no transpose): {pp['ms'] * 1e3} us, bound "
          f"{pp['bytes'] / HBM_BYTES_PER_S * 1e6} us ({pp['bytes']} B); the same stages unfused (K1 lane_shuffle "
          f"and the torch transposes) {pp['unfused_ms'] * 1e3} us", flush=True)

    # phase 6: the probe kernels (P1-P5): (a) exact at every probe shape,
    # (b) timed, (c) the four ported probe scripts with their launches
    # counted, (d) run_sim --profile-round on the 1M headline
    t0 = time.perf_counter()
    errs["probes"] = check_probes(dev, gen)
    print(f"probe kernels equal their plain versions at every probe shape (and P4 equals K1): {errs['probes']}",
          flush=True)
    ptimes = time_probes(dev, gen)
    probe_launches = run_probe_scripts(card)
    run_profile_round(card, N_HEADLINE)
    print(f"[{card}] phase 6: {time.perf_counter() - t0:.2f} s", flush=True)
    print(probe_line(card, "P1 axis 0 (sublane_gather, 8192 rows)", ptimes["P1 axis 0"]), flush=True)
    for name, key, replaces in PROBES:
        t = ptimes[key]
        kernels.append({
            "name": name, "route": "cuda", "source": "tpu_gossip_torch/csrc/gather_probes.cu",
            "replaces": replaces, "launches": probe_launches[key], "max_abs_err": errs["probes"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": t["library_ms"],
        })
        print(f"{probe_line(card, name, t)}, launches in its script {probe_launches[key]}", flush=True)

    # phase 7: durable checkpoints and crash recovery through the CLI (7a-7e)
    t0 = time.perf_counter()
    phase_checkpoints(root, card, peak)
    print(f"[{card}] phase 7: {time.perf_counter() - t0:.2f} s", flush=True)

    # phase 8: silent peers and the fault plane through the CLI (8a-8e)
    t0 = time.perf_counter()
    faults = phase_faults(root, dev, card)
    print(f"[{card}] phase 8: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in faults.items() if 'seconds' in v} }", flush=True)

    # phase 9: the quorum detector and the Byzantine adversaries through the CLI (9a-9c)
    t0 = time.perf_counter()
    quorum = phase_quorum(root, dev, card)
    print(f"[{card}] phase 9: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in quorum.items() if 'seconds' in v} }", flush=True)

    # phase 10: growth (10a-10d)
    t0 = time.perf_counter()
    growth = phase_growth(root, dev, card)
    print(f"[{card}] phase 10: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in growth.items() if 'seconds' in v} }", flush=True)

    # phase 11: streams (11a-11d)
    t0 = time.perf_counter()
    stream = phase_stream(root, dev, card)
    print(f"[{card}] phase 11: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in stream.items() if 'seconds' in v} }", flush=True)

    # phase 12: adaptive control (12a-12e)
    t0 = time.perf_counter()
    control = phase_control(root, dev, card)
    print(f"[{card}] phase 12: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in control.items() if 'seconds' in v} }", flush=True)

    # phase 13: pipelined rounds (13a, 13b on phase 14's 1M one-shard matching mesh), fleets (13c, 13d)
    # and the composed profile rows (13e)
    t0 = time.perf_counter()
    one = mesh_setup_1m(dev, 1)
    pipeline = phase_pipeline(root, dev, card, one)
    fleets = phase_fleet(root, dev, card)
    t1 = time.perf_counter()
    run_composed_profile(card, dev)
    parts = {**pipeline, **fleets, "13e": dict(seconds=time.perf_counter() - t1)}
    print(f"[{card}] phase 13: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in parts.items() if 'seconds' in v} }", flush=True)

    # phase 14: the sharded matching mesh and its transports (14a-14e)
    t0 = time.perf_counter()
    mesh = phase_mesh(root, dev, card, gen, one)
    print(f"[{card}] phase 14: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in mesh.items() if 'seconds' in v} }; the script "
          f"{time.perf_counter() - t_script:.2f} s", flush=True)
    # phase 15: serving (15a-15d)
    t0 = time.perf_counter()
    serve = phase_serve(root, dev, card, gen)
    print(f"[{card}] phase 15: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in serve.items()} }; the script "
          f"{time.perf_counter() - t_script:.2f} s", flush=True)
    # phase 16: the tpu-sim transport, the conformance curves and the socket CLIs (16a-16c)
    t0 = time.perf_counter()
    simnet = phase_simnet(root, dev, card, gen)
    print(f"[{card}] phase 16: {time.perf_counter() - t0:.2f} s; by part "
          f"{ {k: round(v['seconds'], 2) for k, v in simnet.items()} }; the script "
          f"{time.perf_counter() - t_script:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
