"""Rate of the lane gather at wide operands (P2).

Ports ``experiments/pallas_wide_lane_gather.py``: a (S, W) table resident
for the whole call and ``steps`` blocks of (S, W) indices in [0, W),
``out[j*S + s, w] = table[s, idx[j*S + s, w]]``. On the TPU the table sat
in VMEM; here the CUDA kernel ``lane_gather`` (``kernels/probes.py``)
stages each table row in a block's shared memory (up to 224 KB of it; the
rest of a wider row is read through L2). Each shape is checked against
numpy, then slope-timed.

    python -m tpu_gossip_torch.experiments.pallas_wide_lane_gather
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels.probes import lane_gather
from tpu_gossip_torch.utils.profiling import slope_time

SHAPES = ((8, 1024, 64), (8, 8192, 32), (16, 8192, 16), (8, 65536, 8), (16, 65536, 8), (8, 131072, 4))


def probe(S: int, W: int, steps: int = 8, device: str | torch.device = "cuda") -> float:
    """Check and slope-time one (S, W, steps); prints its line, returns s/call."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    table_np = rng.integers(0, 2**31, (S, W), dtype=np.int32)
    idx_np = rng.integers(0, W, (steps * S, W), dtype=np.int32)
    table, idx = torch.from_numpy(table_np).to(dev), torch.from_numpy(idx_np).to(dev)
    out = lane_gather(table, idx)
    ref = np.take_along_axis(np.broadcast_to(table_np, (steps, S, W)).reshape(steps * S, W), idx_np, axis=1)
    ok = bool((out.cpu().numpy() == ref).all())

    def body(i, c):
        g = lane_gather(table, (idx + i) % W)
        return c ^ g.sum(dtype=torch.int32)

    dt = slope_time(body, torch.zeros((), dtype=torch.int32, device=dev), 2, 10)
    elems = steps * S * W
    print(
        f"S={S} W={W}: {'OK' if ok else 'WRONG'}  {dt*1e3:.2f} ms/call "
        f"({elems/1e6:.1f}M elems) -> {elems/dt/1e9:.2f} G elem/s; "
        f"6.16M edges would take {6.16e6 * dt / elems * 1e3:.2f} ms"
    )
    return dt


def main(device: str | torch.device = "cuda", shapes=SHAPES) -> None:
    for S, W, steps in shapes:
        probe(S, W, steps=steps, device=device)


if __name__ == "__main__":
    main()
