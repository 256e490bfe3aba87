"""Durability fault injection: damage a checkpoint the way hardware does.

Ports ``tpu_gossip/ckpt/chaos.py``. Each mode is made deterministically
on a real checkpoint directory:

- ``truncate_shard``: a payload file loses its second half (power loss
  between write and fsync, a copy cut short);
- ``flip_byte``: one byte flips mid-file (bit rot, a bad transfer);
- ``drop_manifest``: the manifest is gone (a crash before its rename);
- ``drop_shard``: a payload file is gone (a crash between two renames).

Recovery must detect each (``verify_checkpoint`` names it) and roll back
past it (``latest_complete``), never load it.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from tpu_gossip_torch.ckpt.store import MANIFEST_NAME, CheckpointError

__all__ = ["CORRUPTION_MODES", "corrupt_checkpoint"]

CORRUPTION_MODES = ("truncate_shard", "flip_byte", "drop_manifest", "drop_shard")


def _payload_files(ckdir: Path) -> list[Path]:
    manifest = json.loads((ckdir / MANIFEST_NAME).read_text())
    return [ckdir / n for n in sorted(manifest.get("files", {}))]


def corrupt_checkpoint(ckdir, mode: str, *, index: int = 0, seed: int = 0) -> Path:
    """Apply one corruption ``mode`` to the checkpoint at ``ckdir``;
    ``index`` picks the payload file (manifest order), ``seed`` the
    flipped byte. Returns the path damaged."""
    ckdir = Path(ckdir)
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; choose from {CORRUPTION_MODES}")
    if mode == "drop_manifest":
        target = ckdir / MANIFEST_NAME
        if not target.is_file():
            raise CheckpointError(f"{ckdir} has no manifest to drop")
        target.unlink()
        return target
    files = _payload_files(ckdir)
    if not files:
        raise CheckpointError(f"{ckdir} lists no payload files")
    target = files[index % len(files)]
    if mode == "drop_shard":
        target.unlink()
        return target
    payload = bytearray(target.read_bytes())
    if not payload:
        raise CheckpointError(f"{target} is empty — nothing to corrupt")
    if mode == "truncate_shard":
        del payload[len(payload) // 2:]
    else:  # flip_byte, never at offset 0: the digest, not the npz parser, must catch it
        offset = 1 + (seed * 2654435761) % (len(payload) - 1)
        payload[offset] ^= 0x40
    tmp = target.with_name(f".tmp-chaos-{target.name}")
    tmp.write_bytes(bytes(payload))
    os.replace(tmp, target)
    return target
