"""The card's gather candidates at the 1M round's feed shape (P3).

Ports ``experiments/gather_probe.py``: every candidate for E = 6,160,384
random int32 reads from an N = 1,048,576-word table, slope-timed:

  flat        y = table[idx]
  row<W>      two steps: gather W-word rows by idx >> log2(W), then pick
              lane idx & (W - 1) with ``torch.gather``
  taa0        tall sublane gather: ``torch.gather`` of the (R, 128) table
              down its rows, in chunks
  lane        ``torch.gather`` along the lanes of (E / 128, 128) rows alone
  pallas_taa0 the same tall sublane gather as the CUDA kernel
              ``sublane_gather`` (``kernels/probes.py``), the table staged
              in shared memory a 4-lane column slab a block, where the TPU
              kernel held it in VMEM

The first four are plain torch, as JAX left them to XLA. The summary gives
each in ms at E.

    python -m tpu_gossip_torch.experiments.gather_probe
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels.probes import sublane_gather
from tpu_gossip_torch.utils.profiling import slope_time

N = 1_048_576  # table words (1M peers)
E = 6_160_384  # edge slots at the 1M headline (9.4% padded plan)
CH = 2048  # index rows a step of the TPU kernel's grid


def main(device: str | torch.device = "cuda", n: int = N, e: int = E, ch: int = CH) -> dict:
    """Time every candidate; prints the lines and the summary, returns the
    seconds at E by candidate. ``n`` and every ``n // W`` powers of two."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(dev)

    def slope(body, n1, n2):
        return slope_time(body, torch.zeros((), dtype=torch.int32, device=dev), n1, n2)

    table = put(rng.integers(0, 2**31, (n,), dtype=np.int32))
    idx = put(rng.integers(0, n, (e,), dtype=np.int32))
    results = {}

    def flat(i, c):
        return c ^ table[((idx + i) & (n - 1)).long()].sum(dtype=torch.int32)

    results["flat"] = slope(flat, 2, 12)
    print(f"flat 4B gather: {results['flat']*1e3:.1f} ms", flush=True)

    for w in (8, 32, 128, 512):
        tab2 = table.view(n // w, w)
        rowm = put(rng.integers(0, n // w, (e,), dtype=np.int32))
        lane = put(rng.integers(0, w, (e, 1), dtype=np.int32)).long()

        def two(i, c, tab2=tab2, rowm=rowm, lane=lane, w=w):
            rows = tab2[((rowm + i) & (n // w - 1)).long()]  # (E, w) row gather
            return c ^ torch.gather(rows, 1, lane)[:, 0].sum(dtype=torch.int32)

        results[f"row{w}"] = slope(two, 2, 8)
        print(f"row{w} gather+laneselect: {results[f'row{w}']*1e3:.1f} ms", flush=True)

    r = n // 128
    tab128 = table.view(r, 128)
    nchunk = e // (r * 128)  # whole chunks; scaled to E at the end
    idx0 = put(rng.integers(0, r, (nchunk, r, 128), dtype=np.int32))

    def taa0(i, c):
        for j in range(nchunk):
            g = torch.gather(tab128, 0, ((idx0[j] + i) & (r - 1)).long())
            c = c ^ g.sum(dtype=torch.int32)
        return c

    t = slope(taa0, 2, 12)
    results["taa0"] = t * e / (nchunk * r * 128)
    print(f"tall sublane taa axis0 ({nchunk} chunks of ({r},128)): "
          f"{t*1e3:.1f} ms raw -> {results['taa0']*1e3:.1f} ms at E", flush=True)

    rows_e = e // 128
    bigrows = put(rng.integers(0, 2**31, (rows_e, 128), dtype=np.int32))
    lidx = put(rng.integers(0, 128, (rows_e, 128), dtype=np.int32))

    def lane_only(i, c):
        g = torch.gather(bigrows, 1, ((lidx + i) & 127).long())
        return c ^ g.sum(dtype=torch.int32)

    results["lane"] = slope(lane_only, 2, 12)
    print(f"lane shuffle axis1 at E: {results['lane']*1e3:.1f} ms", flush=True)

    nch = e // (ch * 128)  # ~23 steps
    idxp_np = rng.integers(0, r, (nch * ch, 128), dtype=np.int32)
    idxp = put(idxp_np)
    ok = bool((sublane_gather(tab128, idxp, 0).cpu().numpy()
               == np.take_along_axis(tab128.cpu().numpy(), idxp_np, axis=0)).all())

    def pallas_body(i, c):
        g = sublane_gather(tab128, (idxp + i) & (r - 1), 0)
        return c ^ g.sum(dtype=torch.int32)

    t = slope(pallas_body, 2, 12)
    results["pallas_taa0"] = t * e / (nch * ch * 128)
    print(f"pallas taa0 resident table: {'OK' if ok else 'WRONG'} {t*1e3:.1f} ms raw -> "
          f"{results['pallas_taa0']*1e3:.1f} ms at E", flush=True)

    print(f"\nsummary (ms at E={e / 1e6:.2f}M):")
    for k, v in results.items():
        print(f"  {k:12s} {v*1e3:8.1f}")
    return results


if __name__ == "__main__":
    main()
