"""The rates and the designs behind the staged probe gathers (P2, P3).

``csrc/gather_probes.cu`` stages P2's table rows and P3's table slabs in
shared memory. This script measures what that choice rests on, and the
designs it was chosen over, with the kernels of ``gather_designs.cu``
(built here, none of them on a path of the port):

  smem reads     random 4-byte reads of a block's shared memory, and of its
                 cluster's through distributed shared memory (2, 4, 8 blocks)
  L2 reads       random 4-byte reads of a 4 MB table and 16-byte reads 512 B
                 apart, by 16 to all SMs (one block an SM)
  box stores     TMA stores of 4-lane and 8-lane boxes (16 and 32 B a row)
                 over P3's (47104, 128) out
  P2 designs     the L2 route at every P2 shape (the kernel the probes ran
                 before rows were staged, still the C entry ``lane_gather``);
                 the row over a cluster's shared memory, lookups through
                 distributed shared memory; each beside ``lane_gather``
  P3 designs     the L2 route (the C entry ``sublane_gather`` at group 0,
                 likewise); the slab moved by the load/store units; two slabs a cluster
                 with 8-lane out stores; 8 slabs a cluster with lookups through
                 distributed shared memory; beside ``sublane_gather``; and the
                 slab route forced at P1 axis 0 beside its L2 route

Each design is checked exactly against the plain version, then timed with L2
cold and warm, in turns with the chosen kernel. Runs on a CUDA card only.

    python -m tpu_gossip_torch.experiments.gather_designs
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.experiments.pallas_wide_lane_gather import SHAPES
from tpu_gossip_torch.kernels import native, probes
from tpu_gossip_torch.utils.profiling import cold_ms, in_turns, time_ms

_SRC = Path(__file__).resolve().parent / "gather_designs.cu"
_P, _I, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
_SIGNATURES = {
    "smem_reads": (_I, _I, _P, _U, _U, _P),
    "l2_reads": (_I, _P, _U, _P, _U, _U, _P),
    "box_stores": (_I, _P, _L, _L, _P),
    "lane_cluster": (_P, _P, _P, _L, _L, _L, _I, _L, _L, _P),
    "sublane_design": (_I, _P, _P, _P, _L, _L, _L, _P),
}
SUBLANE_DESIGNS = {0: "slab by the load/store units", 1: "two slabs a cluster, 8-lane out stores",
                   2: "8 slabs a cluster, lookups through distributed shared memory"}


def _library() -> ctypes.CDLL:
    target = native.hashed_target(_SRC, native.NVCC_FLAGS, "gather_designs")
    job = native.start_compile([native._nvcc(), *native.NVCC_FLAGS, str(_SRC)], target)
    if job is not None:
        native.finish_compile(job, f"{_SRC.name} (nvcc)")
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _call(rc: int, what: str) -> None:
    native.check(rc, what)


def _compare(label: str, design, chosen, want: torch.Tensor, got: torch.Tensor, results: dict) -> None:
    design()
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    d_cold, c_cold = in_turns(design, chosen, 20, cold_ms)
    d_warm, c_warm = in_turns(design, chosen, 30, time_ms)
    results[label] = dict(ok=ok, cold_us=d_cold * 1e3, warm_us=d_warm * 1e3, chosen_cold_us=c_cold * 1e3,
                          chosen_warm_us=c_warm * 1e3)
    print(f"{label}: {'OK' if ok else 'WRONG'} cold {d_cold * 1e3:.2f} us, warm {d_warm * 1e3:.2f} us; "
          f"chosen kernel cold {c_cold * 1e3:.2f}, warm {c_warm * 1e3:.2f}", flush=True)


def main(device: str | torch.device = "cuda") -> dict:
    """Every measurement above; prints the card's name and power limit, then
    one line a measurement; returns them by name."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("gather_designs measures CUDA kernels: it needs a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = _library()
    stream = native.stream_of(torch.empty(1, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results: dict = {}

    def ints(shape, hi=2**31 - 1, lo=-2**31):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    sink = torch.empty(sms * 1024 * 4, dtype=torch.int32, device=dev)
    for cluster, local in ((1, 1), (2, 0), (4, 0), (8, 0)):
        iters, blocks = 64, 128
        ms = time_ms(lambda: _call(lib.smem_reads(cluster, local, sink.data_ptr(), blocks, iters, stream), "smem"),
                      20)
        rate = blocks * 1024 * iters * 8 / ms / 1e6
        what = "own block" if local else f"cluster of {cluster}, distributed"
        results[f"smem reads {what}"] = rate
        print(f"shared memory random 4 B reads, {what}: {rate:.1f} G/s", flush=True)

    table = ints((1 << 20,), 2**30, 0)
    rows = ints((47104 * 128,), 2**30, 0)
    for strided, src, arg, per_thread in ((0, table, (1 << 20) - 1, 8), (1, rows, 47104, 4)):
        for blocks in (16, 33, 66, sms):
            ms = time_ms(lambda: _call(lib.l2_reads(strided, src.data_ptr(), arg, sink.data_ptr(), blocks, 64,
                                                     stream), "l2"), 20)
            rate = blocks * 1024 * 64 * per_thread / ms / 1e6
            what = "16 B reads 512 B apart" if strided else "random 4 B reads"
            results[f"L2 {what}, {blocks} SMs"] = rate
            print(f"L2 {what}, {blocks} SMs: {rate:.1f} G/s ({rate / blocks:.3f} an SM)", flush=True)

    out = torch.empty((47104, 128), dtype=torch.int32, device=dev)
    for lanes in (4, 8):
        rows_per = 47104 // lanes  # 128 blocks: 128 / lanes columns, `lanes` row chunks
        fn = lambda: _call(lib.box_stores(lanes, out.data_ptr(), 47104, rows_per, stream), "box stores")  # noqa
        cold, warm = cold_ms(fn), time_ms(fn)
        results[f"box stores {lanes} lanes"] = dict(cold_us=cold * 1e3, warm_us=warm * 1e3)
        print(f"TMA stores of {lanes}-lane boxes ({lanes * 4} B a row), 128 blocks, over (47104, 128): cold "
              f"{cold * 1e3:.2f} us, warm {warm * 1e3:.2f} us", flush=True)

    gp = native.library("gather_probes")
    for s, w, steps in SHAPES:  # the L2 route: the C entry lane_gather
        tab, idx = ints((s, w)), ints((s * steps, w), w, 0)
        got = torch.empty_like(idx)
        design = lambda: _call(gp.lane_gather(tab.data_ptr(), idx.data_ptr(), got.data_ptr(), s * steps, s, w,  # noqa
                                              stream), "lane_gather L2 route")
        _compare(f"P2 ({s}, {w}, {steps}) on the L2 route", design, lambda: probes.lane_gather(tab, idx),
                 probes.lane_gather_plain(tab, idx), got, results)

    for s, w, steps, cluster in ((8, 65536, 8, 2), (8, 131072, 4, 4)):
        tab, idx = ints((s, w)), ints((s * steps, w), w, 0)
        got = torch.empty_like(idx)
        per, bpr = 32768, s * steps * w // 32768 // s
        design = lambda: _call(lib.lane_cluster(tab.data_ptr(), idx.data_ptr(), got.data_ptr(), s * steps, s, w,  # noqa
                                                cluster, per, bpr, stream), "lane_cluster")
        _compare(f"P2 ({s}, {w}, {steps}) row over a cluster of {cluster}", design,
                 lambda: probes.lane_gather(tab, idx), probes.lane_gather_plain(tab, idx), got, results)

    tab, idx = ints((8192, 128)), ints((47104, 128), 8192, 0)
    want = probes.sublane_gather_plain(tab, idx, 0)
    got = torch.empty_like(idx)
    design = lambda: _call(gp.sublane_gather(tab.data_ptr(), idx.data_ptr(), got.data_ptr(), 47104, 0, stream),  # noqa
                           "sublane_gather L2 route")
    _compare("P3 on the L2 route", design, lambda: probes.sublane_gather(tab, idx, 0), want, got, results)
    for design_id, what in SUBLANE_DESIGNS.items():
        rows_per = 12288 if design_id == 1 else 11776
        design = lambda: _call(lib.sublane_design(design_id, tab.data_ptr(), idx.data_ptr(), got.data_ptr(),  # noqa
                                                  8192, 47104, rows_per, stream), what)
        _compare(f"P3 {what}", design, lambda: probes.sublane_gather(tab, idx, 0), want, got, results)

    tab, idx = ints((8192, 128)), ints((8192, 128), 8192, 0)
    got = torch.empty_like(idx)
    design = lambda: _call(gp.sublane_gather_slab(tab.data_ptr(), idx.data_ptr(), got.data_ptr(), 8192, 8192,  # noqa
                                                  2048, stream), "slab at P1 axis 0")
    _compare("P1 axis 0 (8192 rows) on the slab route", design, lambda: probes.sublane_gather(tab, idx, 0),
             probes.sublane_gather_plain(tab, idx, 0), got, results)
    return results


if __name__ == "__main__":
    main()
