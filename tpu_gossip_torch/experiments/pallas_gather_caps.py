"""Which equal-shape gathers run, and how fast (P1).

Ports ``experiments/pallas_gather_caps.py``: ``take_along_axis(x, idx,
axis)`` with ``x.shape == idx.shape == (rows, 128)``, the only gather
Mosaic lowers (per-lane down the rows for axis 0, a per-row lane shuffle
for axis 1). Here axis 1 is the CUDA kernel ``lane_gather`` and axis 0
``sublane_gather`` (``kernels/probes.py``); each shape is checked against
numpy, then slope-timed.

    python -m tpu_gossip_torch.experiments.pallas_gather_caps
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels.probes import lane_gather, sublane_gather
from tpu_gossip_torch.utils.profiling import slope_time

ROWS = (8, 64, 512, 2048, 8192)


def run(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """The probe's gather: ``take_along_axis(x, idx, axis)``."""
    return sublane_gather(x, idx, 0) if axis == 0 else lane_gather(x, idx)


def try_shape(rows: int, axis: int, iters=None, device: str | torch.device = "cuda") -> float:
    """Check and slope-time one shape; prints its line, returns s/call."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x_np = rng.integers(0, 2**31, (rows, 128), dtype=np.int32)
    hi = rows if axis == 0 else 128
    idx_np = rng.integers(0, hi, (rows, 128), dtype=np.int32)
    x, idx = torch.from_numpy(x_np).to(dev), torch.from_numpy(idx_np).to(dev)
    out = run(x, idx, axis)
    ok = bool((out.cpu().numpy() == np.take_along_axis(x_np, idx_np, axis=axis)).all())
    msg = "OK" if ok else "WRONG RESULT"

    def body(i, c):
        g = run(x, (idx + i) % hi, axis)
        return c ^ g.sum(dtype=torch.int32)

    dt = slope_time(body, torch.zeros((), dtype=torch.int32, device=dev), 4, 64)
    rate = rows * 128 / dt / 1e6
    print(f"rows={rows} axis={axis}: {msg}  {dt*1e6:.0f} us/call  {rate:.0f} M elem/s")
    return dt


def main(device: str | torch.device = "cuda", rows: tuple[int, ...] = ROWS) -> None:
    for axis in (0, 1):
        for r in rows:
            try_shape(r, axis, device=device)


if __name__ == "__main__":
    main()
