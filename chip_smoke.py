"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's five CUDA kernels (K1 lane shuffle, K2 plane fold, K3
round tail, K4 packed word tail, K5 staircase segment) from
``tpu_gossip_torch/csrc`` and the host C++ preferential-attachment
library, holds each kernel against its plain PyTorch version on the card
(exact equality; K3 and K4 in both SIR-age modes, past ROUND_CAP too),
reproduces the JAX-pinned n=20000 digests
(``tpu_gossip_torch/reference_digests.json``, packed runs included), then
drives five paths at 1M peers (push_pull, fanout 1, 16 slots, to 99%
coverage), each with its launches counted from zero: the matching headline
(K1, K2, K3), the power-law CSR swarm delivered by the staircase kernel
(K5, K3), the exactly-k XLA delivery on the same graph (K3), and the packed
twins of the headline (K1, K2, K4) and of the exactly-k path (K4 alone),
each packed run digest-equal to its unpacked twin. Last it times each
kernel at its path's shapes beside its byte bound, its plain version and
the one torch call that computes the same function, where there is one.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present or any phase fails. Imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

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


def check_k1(dev, gen, main_rows: int) -> int:
    from tpu_gossip_torch.kernels.permute import lane_shuffle, lane_shuffle_plain

    err = 0
    for rows, dt in ((main_rows, torch.int8), (main_rows, torch.int32), (40, torch.int32),
                     (96, torch.int8), (2056, torch.int32), (4128, torch.int8)):
        x = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=gen, device=dev, dtype=torch.int32)
        idx = lane_tables(rows, dt, gen, dev)
        err = max(err, max_err(lane_shuffle(x, idx), lane_shuffle_plain(x, idx)))
    return err


def check_k2(dev, gen, classes, rows: int) -> int:
    from tpu_gossip_torch.kernels.permute import fold_planes, fold_planes_plain

    slots = torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=gen, device=dev, dtype=torch.int32)
    small = torch.randint(0, 2**16, (64, 128), generator=gen, device=dev, dtype=torch.int32)
    cases = [(slots, so, cs, c, pd) for (_, so, c, pd, cs) in classes if c >= 8192]
    cases += [(small, 0, 1024, 1000, 1), (small, 1024, 2048, 2047, 3)]
    err = 0
    for op in ("or", "sum"):
        for buf, so, cs, c, pd in cases:
            err = max(err, max_err(fold_planes(buf, so, cs, c, pd, op),
                                   fold_planes_plain(buf, so, cs, c, pd, op)))
    return err


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
    expired at round 9, and in both SIR-age modes at round 32771."""
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    err = 0
    for n, m in ((n_main, M_SLOTS), (1001, 7)):
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


def phase_digest(root: Path, dev) -> list[dict]:
    """The port's CLI at every JAX-pinned n=20000 configuration."""
    from tpu_gossip_torch.cli import run_sim

    out = []
    for ref in json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text()):
        args, unknown = run_sim.build_parser().parse_known_args(ref["argv"] + ["--device", str(dev)])
        if unknown:
            raise AssertionError(f"reference argv not understood: {unknown}")
        got = run_sim.run(args)
        for k in ("state_digest", "stats_digest", "rounds_to_target", "total_msgs", "final_coverage"):
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
    for name in ("n", "n_tiles", "n_blocks", "rows"):
        if getattr(plan, name) != getattr(dplan, name):
            raise AssertionError(f"device plan {name} {getattr(dplan, name)} != host {getattr(plan, name)}")
    for name in ("tile_block", "offs", "col_gather"):
        if not torch.equal(getattr(plan, name), getattr(dplan, name)):
            raise AssertionError(f"device plan routing table {name} differs from the host build")
    # float32 thresholds are within 2^-24 relative of the host's float64
    # ones before the ceil, which may then differ by one
    thr_err = 0
    for t in ("push_thresh", "pull_thresh"):
        diff = (getattr(plan, t) - getattr(dplan, t)).abs()
        if bool((diff > 1 + getattr(plan, t) * 2.0**-22).any()):
            raise AssertionError(f"device plan {t} off the host's by more than 2^-22 relative + 1")
        thr_err = max(thr_err, int(diff.max()))
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


def phase_timing(plan, dev, gen, n: int) -> dict:
    """Each kernel, its plain version and its library call at the main
    path's shapes."""
    from tpu_gossip_torch.kernels.permute import fold_planes, fold_planes_plain, lane_shuffle, lane_shuffle_plain
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    x = plan.expand(torch.arange(plan.n, dtype=torch.int32, device=dev))
    tab = plan.lanes[0]
    idx_long = tab.to(torch.int64)
    slots = plan.rows * 128
    out = {"lane_shuffle": dict(
        ms=time_ms(lambda: lane_shuffle(x, tab)), plain_ms=time_ms(lambda: lane_shuffle_plain(x, tab)),
        library_ms=time_ms(lambda: torch.gather(x, 1, idx_long)),
        bytes=slots * (4 + tab.element_size() + 4))}
    pm = [(so, cs, c, pd) for (_, so, c, pd, cs) in plan.classes if c >= 8192]
    fold_bytes = sum((pd + 1) * cs * 4 for (_, cs, _, pd) in pm)
    flat = x.reshape(-1)

    def fold_all(fn, op):
        return lambda: [fn(x, so, cs, c, pd, op) for (so, cs, c, pd) in pm]

    for op in ("or", "sum"):
        out[f"fold_planes_{op}"] = dict(ms=time_ms(fold_all(fold_planes, op)),
                                        plain_ms=time_ms(fold_all(fold_planes_plain, op)),
                                        library_ms=None, bytes=fold_bytes)
    out["fold_planes_sum"]["library_ms"] = time_ms(
        lambda: [flat[so: so + pd * cs].view(pd, cs).sum(0, dtype=torch.int32) for (so, cs, c, pd) in pm])
    ops = tail_operands(n + 1, M_SLOTS, gen, dev, rnd=9)
    targs = (*(ops[k] for k in TAIL_PLANES), None, torch.tensor(9, dtype=torch.int32, device=dev))
    tkw = dict(forward_once=False, sir_recover_rounds=0)
    out["round_tail"] = dict(ms=time_ms(lambda: tail_kernel(*targs, **tkw)),
                             plain_ms=time_ms(lambda: tail_fused(*targs, **tkw)),
                             loop_ms=loop_ms(lambda: tail_kernel(*targs, **tkw)),
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


KERNELS = (  # (name, launch key, source, TPU kernel it replaces, check key)
    ("lane_shuffle", "lane_shuffle", "tpu_gossip_torch/csrc/lane_shuffle.cu",
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
)
# the launches each path must make, and must not make, per round (None: at
# least one; a key left out is not checked)
MATCHING_PATH = {"lane_shuffle": None, "fold_planes_or": None, "fold_planes_sum": None, "round_tail": None,
                 "staircase_segment": 0, "round_tail_words": 0}
STAIRCASE_PATH = {"lane_shuffle": 0, "fold_planes_or": 0, "fold_planes_sum": 0, "round_tail": 1,
                  "staircase_segment": 1, "round_tail_words": 0}
XLA_PATH = dict(STAIRCASE_PATH, staircase_segment=0)
# the packed headline reuses 4a's plan, so the build's SUM fold is not in its window
PACKED_MATCHING_PATH = {"lane_shuffle": None, "fold_planes_or": None, "round_tail": 0, "staircase_segment": 0,
                        "round_tail_words": 1}
PACKED_XLA_PATH = dict(XLA_PATH, round_tail=0, round_tail_words=1)


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
    print(f"build: {len(native.SOURCES)} kernel sources and the host PA library in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2: each kernel against its plain version on the card, exactly
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
        print(f"n=20000 digests equal the JAX reference: {got['mode']} {got['state_digest']} "
              f"{got['stats_digest']}", flush=True)

    # phase 4a: the matching headline, every launch counted from 0
    torch.cuda.reset_peak_memory_stats(dev)
    native.reset_launches()
    hgraph, plan, run = phase_headline(dev, N_HEADLINE)
    launches = dict(native.LAUNCHES)
    peak = run["peak"]
    rounds = run["rounds"]
    check_launches("matching", launches, MATCHING_PATH, rounds)
    print(f"[{card}] headline n={N_HEADLINE} m={M_SLOTS} push_pull fanout 1: "
          f"plan build {run['build_s']} s, rounds to 99% {rounds}, coverage {run['coverage']}, "
          f"{run['run_s'] * 1e3 / rounds} ms/round, {N_HEADLINE * rounds / run['run_s']} peers*rounds/s, "
          f"max_memory_allocated {peak} B (run alone {run['run_peak']} B)", flush=True)
    print(f"[{card}] matching-path launches: {launches}", flush=True)

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
          f"{N_HEADLINE * srun['rounds'] / srun['run_s']} peers*rounds/s, max_memory_allocated {s_peak} B",
          flush=True)
    print(f"[{card}] staircase-path launches: {s_launches}", flush=True)

    # phase 4c: the exactly-k XLA delivery (the CLI's default) on the same graph
    native.reset_launches()
    xrun = run_to_coverage(dev, dgraph, N_HEADLINE, None, "exactly-k")
    check_launches("exactly-k", dict(native.LAUNCHES), XLA_PATH, xrun["rounds"])
    print(f"[{card}] exactly-k XLA run on the same graph: rounds to 99% {xrun['rounds']}, coverage "
          f"{xrun['coverage']}, {xrun['run_s'] * 1e3 / xrun['rounds']} ms/round, "
          f"run max_memory_allocated {xrun['run_peak']} B", flush=True)

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

    # phase 5: kernel times at each path's shapes
    times = phase_timing(plan, dev, gen, N_HEADLINE)
    times["staircase_segment"] = time_k5(splan, dev, gen)
    path_launches = dict(launches, staircase_segment=s_launches["staircase_segment"],
                         round_tail_words=packed_launches["packed matching"]["round_tail_words"])
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
        print(f"[{card}] {name}: {t['ms'] * 1e3} us, bound {kernels[-1]['bound_ms'] * 1e3} us, "
              f"plain {t['plain_ms'] * 1e3} us, library {lib}{loop}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
