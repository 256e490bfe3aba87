"""Device resolution shared by every entry point of the port.

Entry points take ``device`` and default to ``"cuda"``: the port is written
for the card, so a run that finds no card raises instead of carrying on
silently on the CPU. Tests and CPU checks pass ``device="cpu"``, which runs
every kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_gossip_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
