"""The structured-permutation pipeline's building blocks at 1M scale (P4, P5).

Ports ``experiments/perm_pipeline_probe.py`` at E = 2^23 int32 as (R, 128)
rows: the 2-D transpose and the 3-D transpose pair (plain torch, as JAX
left them to XLA), the per-row lane shuffle (P4, the CUDA kernel
``lane_gather``), the 8-way sublane shuffle (P5, ``sublane_gather`` with
group 8; ``kernels/probes.py``) and the composed shuffle/transpose
pipelines, each slope-timed. The TPU kernels cut the rows into 2048-row
grid blocks; the CUDA kernels cover all rows in one launch.

    python -m tpu_gossip_torch.experiments.perm_pipeline_probe
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_gossip_torch.device import resolve_device
from tpu_gossip_torch.kernels.probes import lane_gather, sublane_gather
from tpu_gossip_torch.utils.profiling import slope_time

E = 8_388_608  # 2^23 stub slots


def lane_shuffle(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P4: ``out[r, l] = v[r, idx[r, l]]``."""
    return lane_gather(v, idx)


def sub_shuffle(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P5: ``out[8g + s, l] = v[8g + idx[8g + s, l], l]``."""
    return sublane_gather(v, idx, 8)


def main(device: str | torch.device = "cuda", e: int = E) -> None:
    """Time every block and pipeline at ``e`` elements (a multiple of
    128 * 128); prints one line each."""
    dev = resolve_device(device)
    r = e // 128
    rng = np.random.default_rng(0)
    x_np = rng.integers(0, 2**31, (r, 128), dtype=np.int32)
    x = torch.from_numpy(x_np).to(dev)

    def t2d(i, c):
        return (c + i).T.reshape(r, 128)

    dt = slope_time(t2d, x, 4, 64)
    print(f"XLA transpose (R,128)->(128,R)+reshape: {dt*1e3:.2f} ms "
          f"({2*e*4/dt/1e9:.0f} GB/s eff)", flush=True)

    r1, r2 = r // 128, 128
    x3 = x.reshape(r1, r2, 128)

    def t3d_pair(i, c):
        return (c + i).transpose(0, 1).contiguous().transpose(0, 1).contiguous()

    dt = slope_time(t3d_pair, x3, 4, 64)
    print(f"XLA 3D transpose pair ({r1},{r2},128)<->: {dt*1e3:.2f} ms", flush=True)

    lidx_np = rng.integers(0, 128, (r, 128), dtype=np.int32)
    lidx = torch.from_numpy(lidx_np).to(dev)
    ok = bool((lane_shuffle(x, lidx).cpu().numpy() == np.take_along_axis(x_np, lidx_np, axis=1)).all())
    dt = slope_time(lambda i, c: lane_shuffle(c, lidx) + i, x, 4, 64)
    print(f"pallas lane shuffle {e / 1e6:.1f}M: {'OK' if ok else 'WRONG'} {dt*1e3:.2f} ms "
          f"({e/dt/1e9:.1f} G elem/s)", flush=True)

    sidx_np = rng.integers(0, 8, (r, 128), dtype=np.int32)
    sidx = torch.from_numpy(sidx_np).to(dev)
    out = sub_shuffle(x, sidx).cpu().numpy()
    ok = bool((out.reshape(-1, 8, 128)
               == np.take_along_axis(x_np.reshape(-1, 8, 128), sidx_np.reshape(-1, 8, 128), axis=1)).all())
    dt = slope_time(lambda i, c: sub_shuffle(c, sidx) + i, x, 4, 64)
    print(f"pallas sublane shuffle {e / 1e6:.1f}M: {'OK' if ok else 'WRONG'} {dt*1e3:.2f} ms", flush=True)

    l2 = torch.from_numpy(rng.integers(0, 128, (r, 128), dtype=np.int32)).to(dev)
    l3 = torch.from_numpy(rng.integers(0, 128, (r, 128), dtype=np.int32)).to(dev)

    def pipeline(i, c):
        v = lane_shuffle(c + i, lidx)
        v = v.T.reshape(r, 128)
        v = lane_shuffle(v, l2)
        v = v.T.reshape(r, 128)
        return lane_shuffle(v, l3)

    dt = slope_time(pipeline, x, 4, 64)
    print(f"composed 5-pass pipeline {e / 1e6:.1f}M: {dt*1e3:.2f} ms", flush=True)

    def pipeline2(i, c):
        v = lane_shuffle(c + i, lidx)
        v = v.T.reshape(r, 128)
        return lane_shuffle(v, l2)

    dt = slope_time(pipeline2, x, 4, 64)
    print(f"composed 3-pass pipeline {e / 1e6:.1f}M: {dt*1e3:.2f} ms", flush=True)


if __name__ == "__main__":
    main()
