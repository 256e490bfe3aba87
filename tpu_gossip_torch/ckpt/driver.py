"""The segmented fixed-horizon runner: periodic checkpoints between rounds.

Ports ``tpu_gossip/ckpt/driver.py``. Every round is a function of the
carried state, so cutting a horizon at a round boundary changes nothing:
the driver runs the horizon in segments cut at the checkpoint grid (and
the remat grid), saves the state and the stats so far between segments,
and joins the segments' stats into the one trajectory the summary reads.
A resumed run therefore ends on the same state and the same integer stats
as the run that was never interrupted. The planes' cursors (``fault_held``,
``slot_lease``, ``control_lvl``) ride the state, so a scenario, a stream
or a controller (given to the segment runner) resumes with no bookkeeping
of its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CheckpointPolicy", "next_cut", "host_stats", "concat_stats", "run_checkpointed"]


@dataclasses.dataclass
class CheckpointPolicy:
    """The CLI's settled checkpoint config: ``every`` rounds into
    ``directory``, keeping the newest ``keep``; ``shards`` is the
    file-level shard count (a storage choice); ``run_config`` lands in
    each manifest for ``run_sim resume`` to rebuild from."""

    every: int
    directory: str
    keep: int = 0
    shards: int = 1
    kind: str = "run"
    run_config: dict | None = None


def next_cut(cur: int, total: int, *periods: int) -> int:
    """Rounds from ``cur`` to the next boundary: the horizon's end or any
    period's next multiple (0 and None periods ignored)."""
    nxt = total
    for p in periods:
        if p:
            nxt = min(nxt, (cur // p + 1) * p)
    return nxt - cur


def host_stats(stats, ici=None) -> dict:
    """One segment's stats as host arrays keyed by field name, with the
    dtypes the JAX package stores (float32 ``coverage`` and
    ``degree_gamma``, int32 the rest); transport counters ride along under
    the ``ici__`` prefix."""
    out = {f: getattr(stats, f).detach().cpu().numpy() for f in stats._fields}
    if ici is not None:
        for f in ici._fields:
            v = getattr(ici, f)
            v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
            out[f"ici__{f}"] = v.astype(np.int32)  # the JAX package's int32 counters
    return out


def concat_stats(parts: list[dict], round_axis: int = 0) -> dict:
    """Per-segment stats joined along the round axis (axis 1 for a fleet's
    batched stats). The key sets must agree: a prefix from a run with
    another stats schema is a config error."""
    if not parts:
        return {}
    keys = set(parts[0])
    for p in parts[1:]:
        if set(p) != keys:
            raise ValueError(f"stats segments disagree on fields: {sorted(keys ^ set(p))} — the checkpoint was "
                             "written by an incompatible run configuration")
    return {k: np.concatenate([p[k] for p in parts], axis=round_axis) for k in sorted(keys)}


def run_checkpointed(state, total_rounds: int, run_segment, *, policy: CheckpointPolicy | None = None,
                     stats_prefix: dict | None = None, round_axis: int = 0, fold_every: int = 0, fold=None,
                     log=None, to_save=None):
    """Drive ``state`` to ``total_rounds`` in segments cut at the
    checkpoint and fold grids.

    ``run_segment(state, seg) -> (state, host stats dict)`` runs ``seg``
    rounds. ``fold(state) -> state`` (with ``fold_every``) is the remat
    epoch hook, called at each ``fold_every`` multiple inside the horizon
    after any checkpoint saved there: a checkpoint on an epoch boundary
    holds the state before the fold, and a run resumed from it replays the
    fold first. ``to_save(state)`` is what a checkpoint holds (the whole
    swarm from a rank's rows), None where this process writes nothing.
    Returns ``(state, stats dict)``, the prefix in front."""
    from tpu_gossip_torch.ckpt.store import save_checkpoint

    parts: list[dict] = []
    if stats_prefix is not None:
        parts.append(dict(stats_prefix))
    cur = _round_of(state)
    every = policy.every if policy is not None else 0
    if fold is not None and fold_every and cur and cur % fold_every == 0 and cur < total_rounds \
            and stats_prefix is not None:
        state = fold(state)
    while cur < total_rounds:
        seg = next_cut(cur, total_rounds, every, fold_every)
        state, seg_stats = run_segment(state, seg)
        parts.append(seg_stats)
        cur += seg
        if policy is not None and every and cur % every == 0 and cur < total_rounds:
            saved = state if to_save is None else to_save(state)
            if saved is not None:
                save_checkpoint(policy.directory, saved, step=cur, shards=policy.shards,
                                stats=concat_stats(parts, round_axis), run_config=policy.run_config,
                                kind=policy.kind, keep=policy.keep, log=log)
        if fold is not None and fold_every and cur % fold_every == 0 and cur < total_rounds:
            state = fold(state)
    return state, concat_stats(parts, round_axis)


def _round_of(state) -> int:
    return int(state.round.reshape(-1)[0])
