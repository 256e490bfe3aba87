"""Durable checkpoints: sharded atomic writes, torn-write detection,
bit-exact crash recovery.

Ports ``tpu_gossip/ckpt/``, with the same public names; a checkpoint
either package writes, the other loads leaf for leaf.

- :mod:`tpu_gossip_torch.ckpt.store`: the on-disk format (a shard's row
  slice of every plane a file, temp file and rename, the manifest with a
  sha256 a file written last).
- :mod:`tpu_gossip_torch.ckpt.driver`: the segmented fixed-horizon runner
  that saves between rounds and joins the stats prefix of a resumed run.
- :mod:`tpu_gossip_torch.ckpt.chaos`: the fault injector (truncated or
  dropped files, flipped bytes, a dropped manifest).
"""

from tpu_gossip_torch.ckpt.chaos import CORRUPTION_MODES, corrupt_checkpoint
from tpu_gossip_torch.ckpt.driver import CheckpointPolicy, concat_stats, host_stats, next_cut, run_checkpointed
from tpu_gossip_torch.ckpt.store import (
    MANIFEST_NAME,
    CheckpointError,
    checkpoint_name,
    latest_complete,
    list_checkpoint_steps,
    load_any,
    load_checkpoint,
    prune_checkpoints,
    save_checkpoint,
    verify_checkpoint,
)

__all__ = [
    "CheckpointError",
    "CheckpointPolicy",
    "CORRUPTION_MODES",
    "MANIFEST_NAME",
    "checkpoint_name",
    "concat_stats",
    "corrupt_checkpoint",
    "host_stats",
    "latest_complete",
    "list_checkpoint_steps",
    "load_any",
    "load_checkpoint",
    "next_cut",
    "prune_checkpoints",
    "run_checkpointed",
    "save_checkpoint",
    "verify_checkpoint",
]
