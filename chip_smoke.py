"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 lane shuffle, K2 plane fold, K3 round
tail) from ``tpu_gossip_torch/csrc``, holds each against its plain PyTorch
version on the card (exact equality), reproduces the JAX-pinned n=20000
digests (``tpu_gossip_torch/reference_digests.json``), then runs the
headline 1M-peer matching swarm (push_pull, fanout 1, 16 slots) to 99%
coverage with every kernel launch counted, and times each kernel at the
main path's shapes beside its byte bound, its plain version and the one
torch call that computes the same function, where there is one.

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


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
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


def check_k3(dev, gen, n_main: int) -> int:
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    err = 0
    for n, m in ((n_main, M_SLOTS), (1001, 7)):
        ops = tail_operands(n, m, gen, dev, rnd=9)
        rnd = torch.tensor(9, dtype=torch.int32, device=dev)
        for fo in (False, True):
            for sir in (0, 4):
                for use_fresh in (False, True):
                    for use_exp in (False, True):
                        args = (ops["seen"], ops["forwarded"], ops["infected_round"], ops["recovered"],
                                ops["incoming"], ops["receptive"], ops["transmit"],
                                ops["fresh"] if use_fresh else None, rnd)
                        kw = dict(forward_once=fo, sir_recover_rounds=sir,
                                  expired=ops["expired"] if use_exp else None)
                        for a, p in zip(tail_kernel(*args, **kw), tail_fused(*args, **kw)):
                            err = max(err, max_err(a, p))
    return err


def phase_digest(root: Path, dev) -> dict:
    """The port's CLI at the JAX-pinned n=20000 configuration."""
    from tpu_gossip_torch.cli import run_sim

    ref = json.loads((root / "tpu_gossip_torch" / "reference_digests.json").read_text())
    args, unknown = run_sim.build_parser().parse_known_args(ref["argv"] + ["--device", str(dev)])
    if unknown:
        raise AssertionError(f"reference argv not understood: {unknown}")
    got = run_sim.run(args)
    for k in ("state_digest", "stats_digest", "rounds_to_target", "total_msgs", "final_coverage"):
        if got[k] != ref["summary"][k]:
            raise AssertionError(f"n=20000 {k} {got[k]} != JAX reference {ref['summary'][k]}")
    return got


def phase_headline(dev, n: int):
    """Build the headline plan and run it to 99% coverage; returns the plan
    and the run's figures."""
    import numpy as np

    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.sim.engine import run_until_coverage

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    dgraph, plan = matching_powerlaw_graph(n, fanout=1, key=prng.key(0, dev), device=dev)
    sync()
    build_s = time.perf_counter() - t0
    graph = dgraph.as_padded_graph()
    cfg = SwarmConfig(n_peers=graph.n, msg_slots=M_SLOTS, fanout=1, mode="push_pull")
    origins = np.random.default_rng(0).choice(n, size=1, replace=False)
    state = init_swarm(graph, cfg, key=prng.key(0, dev), origins=origins, exists=dgraph.exists, device=dev)
    sync()
    t0 = time.perf_counter()
    fin = run_until_coverage(state, cfg, 0.99, 1000, plan=plan)
    cov = float(fin.coverage(0))
    sync()
    run_s = time.perf_counter() - t0
    rounds = int(fin.round)
    if not (0.99 <= cov <= 1.0) or not 0 < rounds < 1000:
        raise AssertionError(f"headline run ended at coverage {cov} after {rounds} rounds")
    live = fin.alive & ~fin.declared_dead
    if int((fin.seen[:, 0] & live).sum()) < 0.99 * int(live.sum()):
        raise AssertionError("headline final state holds fewer infected peers than its coverage")
    if bool((fin.infected_round[:, 0] >= 0).ne(fin.seen[:, 0]).any()):
        raise AssertionError("headline infected_round latch disagrees with seen")
    return plan, dict(build_s=build_s, rounds=rounds, coverage=cov, run_s=run_s)


def phase_timing(plan, dev, gen, n: int, timer=time_ms) -> dict:
    """Each kernel, its plain version and its library call at the main
    path's shapes."""
    from tpu_gossip_torch.kernels.permute import fold_planes, fold_planes_plain, lane_shuffle, lane_shuffle_plain
    from tpu_gossip_torch.kernels.round_tail import tail_fused, tail_kernel

    x = plan.expand(torch.arange(plan.n, dtype=torch.int32, device=dev))
    tab = plan.lanes[0]
    idx_long = tab.to(torch.int64)
    slots = plan.rows * 128
    out = {"lane_shuffle": dict(
        ms=timer(lambda: lane_shuffle(x, tab)), plain_ms=timer(lambda: lane_shuffle_plain(x, tab)),
        library_ms=timer(lambda: torch.gather(x, 1, idx_long)),
        bytes=slots * (4 + tab.element_size() + 4))}
    pm = [(so, cs, c, pd) for (_, so, c, pd, cs) in plan.classes if c >= 8192]
    fold_bytes = sum((pd + 1) * cs * 4 for (_, cs, _, pd) in pm)
    flat = x.reshape(-1)

    def fold_all(fn, op):
        return lambda: [fn(x, so, cs, c, pd, op) for (so, cs, c, pd) in pm]

    for op in ("or", "sum"):
        out[f"fold_planes_{op}"] = dict(ms=timer(fold_all(fold_planes, op)),
                                        plain_ms=timer(fold_all(fold_planes_plain, op)),
                                        library_ms=None, bytes=fold_bytes)
    out["fold_planes_sum"]["library_ms"] = timer(
        lambda: [flat[so: so + pd * cs].view(pd, cs).sum(0, dtype=torch.int32) for (so, cs, c, pd) in pm])
    ops = tail_operands(n + 1, M_SLOTS, gen, dev, rnd=9)
    targs = (ops["seen"], ops["forwarded"], ops["infected_round"], ops["recovered"], ops["incoming"],
             ops["receptive"], ops["transmit"], None, torch.tensor(9, dtype=torch.int32, device=dev))
    tkw = dict(forward_once=False, sir_recover_rounds=0)
    out["round_tail"] = dict(ms=timer(lambda: tail_kernel(*targs, **tkw)),
                             plain_ms=timer(lambda: tail_fused(*targs, **tkw)),
                             library_ms=None, bytes=(n + 1) * M_SLOTS * (6 + 4))
    return out


KERNELS = (  # (name, launch key, source, TPU kernel it replaces, check key)
    ("lane_shuffle", "lane_shuffle", "tpu_gossip_torch/csrc/lane_shuffle.cu",
     "tpu_gossip/kernels/permute.py:77", "lane_shuffle"),
    ("fold_planes[or]", "fold_planes_or", "tpu_gossip_torch/csrc/fold_planes.cu",
     "tpu_gossip/kernels/permute.py:229", "fold_planes"),
    ("fold_planes[sum]", "fold_planes_sum", "tpu_gossip_torch/csrc/fold_planes.cu",
     "tpu_gossip/kernels/permute.py:229", "fold_planes"),
    ("round_tail", "round_tail", "tpu_gossip_torch/csrc/round_tail.cu",
     "tpu_gossip/kernels/round_tail.py:263", "round_tail"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from tpu_gossip_torch.core.matching_topology import plan_shape
    from tpu_gossip_torch.kernels import native

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)

    # phase 1: build every kernel from the checkout's sources, in parallel
    t0 = time.perf_counter()
    native.build_all()
    for name in native.SOURCES:
        native.library(name)
    print(f"build: {len(native.SOURCES)} kernel sources in {time.perf_counter() - t0:.2f} s", flush=True)

    # phase 2: each kernel against its plain version on the card, exactly
    _, _, classes, rows = plan_shape(N_HEADLINE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {"lane_shuffle": check_k1(dev, gen, rows),
            "fold_planes": check_k2(dev, gen, classes, rows),
            "round_tail": check_k3(dev, gen, N_HEADLINE + 1)}
    torch.cuda.synchronize()
    print(f"kernels equal their plain versions: {errs}", flush=True)

    # phase 3: the JAX-pinned digests at n=20000 through the port's CLI
    got = phase_digest(root, dev)
    print(f"n=20000 digests equal the JAX reference: {got['state_digest']} {got['stats_digest']}", flush=True)

    # phase 4: the headline main path, every launch counted
    torch.cuda.reset_peak_memory_stats(dev)
    native.reset_launches()
    plan, run = phase_headline(dev, N_HEADLINE)
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    rounds = run["rounds"]
    print(f"[{card}] headline n={N_HEADLINE} m={M_SLOTS} push_pull fanout 1: "
          f"plan build {run['build_s']} s, rounds to 99% {rounds}, coverage {run['coverage']}, "
          f"{run['run_s'] * 1e3 / rounds} ms/round, {N_HEADLINE * rounds / run['run_s']} peers*rounds/s, "
          f"max_memory_allocated {peak} B", flush=True)
    print(f"[{card}] main-path launches: {launches}", flush=True)

    # phase 5: kernel times at the main path's shapes
    times = phase_timing(plan, dev, gen, N_HEADLINE)
    kernels = []
    for name, key, source, replaces, err_key in KERNELS:
        t = times[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[err_key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": t["library_ms"],
        })
        lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3} us"
        print(f"[{card}] {name}: {t['ms'] * 1e3} us, bound {kernels[-1]['bound_ms'] * 1e3} us, "
              f"plain {t['plain_ms'] * 1e3} us, library {lib}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
