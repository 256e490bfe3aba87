"""The on-disk checkpoint format: sharded atomic writes and a manifest gate.

Ports ``tpu_gossip/ckpt/store.py``; a directory either package writes, the
other reads. One checkpoint is one directory::

    <dir>/ckpt-00000040/
        shard-00000-of-00008.npz   # rows [lo, hi) of every (N, ·) plane
        ...                        # and that range's CSR slice
        global.npz                 # the (M,) and scalar planes, the key's
                                   # uint32 words, the CSR capacity tail
                                   # (kind "run")
        lane-00003-of-00016.npz    # one lane's whole solo state (kind
                                   # "fleet")
        stats.npz                  # the per-round stats so far (the
                                   # resumed trajectory's prefix)
        MANIFEST.json              # written last: format, round cursor,
                                   # sha256 a file, the planes' dtypes and
                                   # shapes, the run config resume rebuilds

Every file is written to a temp name in its directory, fsynced, then
``os.replace``d into place; the manifest lands last, after a directory
fsync, so a crash mid-save leaves a directory without a complete manifest,
which recovery skips. A truncated shard, a flipped byte or a missing file
fails the manifest's sha256 and byte counts, and :func:`latest_complete`
rolls back to the previous complete checkpoint with the reason logged.

The S shard files are row slices of the one global state layout, so the
file-level shard count is a storage choice: any S loads into the same
state. Format 3 stores the packed encoding (``core/packed.py``: the five
(N, M) bool planes as LSB-first uint8 words, the six (N,) masks as one
``flags`` word); format 2 (unpacked planes) is read as well. The key is
stored as its two uint32 threefry words, the manifest declaring it
``{"dtype": "key"}`` as the JAX package does. A state is read to the host
once a save; a load builds numpy arrays and moves them to ``device`` once.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
from pathlib import Path

import numpy as np

__all__ = [
    "CheckpointError",
    "MANIFEST_NAME",
    "FORMAT_VERSION",
    "checkpoint_name",
    "save_checkpoint",
    "verify_checkpoint",
    "list_checkpoint_steps",
    "latest_complete",
    "load_checkpoint",
    "load_any",
    "prune_checkpoints",
]

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 3
READABLE_FORMATS = (2, 3)
_CKPT_RE = re.compile(r"^ckpt-(\d{8})$")
# the CSR pair is row-sliced apart from the other planes
_CSR_PLANES = ("row_ptr", "col_idx")
_SUSPICION = ("suspect_round", "suspect_mark", "quarantine")


class CheckpointError(Exception):
    """A torn, corrupt, or structurally foreign checkpoint."""


def checkpoint_name(step: int) -> str:
    return f"ckpt-{step:08d}"


def _row_planes(packed: bool = False) -> tuple[str, ...]:
    """The planes stored a row slice a shard file: every (N, ·) plane of
    the registry but the CSR pair (with ``packed``, the six flag planes
    as the one ``flags`` word)."""
    from tpu_gossip_torch.core.packed import FLAG_PLANES
    from tpu_gossip_torch.core.state import PLANES

    base = tuple(p.name for p in PLANES if p.shape.startswith("(N") and p.name not in _CSR_PLANES)
    if not packed:
        return base
    return tuple(p for p in base if p not in FLAG_PLANES) + ("flags",)


def _global_planes() -> tuple[str, ...]:
    from tpu_gossip_torch.core.state import PLANES

    return tuple(p.name for p in PLANES if not p.shape.startswith("(N") and p.name not in _CSR_PLANES)


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _atomic_write(path: Path, payload: bytes) -> dict:
    """Temp file, fsync, atomic rename; returns the manifest's entry."""
    tmp = path.with_name(f".tmp-{path.name}.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return {"sha256": hashlib.sha256(payload).hexdigest(), "bytes": len(payload)}


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a filesystem without directory handles
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _state_to_host(state) -> dict:
    """Every leaf as the host array the JAX package stores (the key as its
    uint32 (2,) words; a ``PackedSwarm``'s static ``msg_slots`` left out)."""
    from tpu_gossip_torch.utils.digest import leaf_array, leaf_fields

    return {name: leaf_array(name, getattr(state, name)) for name in leaf_fields(state)}


def _host_packed(state) -> tuple[dict, int]:
    """(packed host planes, msg_slots) of either state representation: a
    ``PackedSwarm``'s leaves are the storage layout already, a
    ``SwarmState`` packs through the host codec."""
    from tpu_gossip_torch.core.packed import PackedSwarm, pack_host_planes

    host = _state_to_host(state)
    if isinstance(state, PackedSwarm):
        return host, int(state.msg_slots)
    return pack_host_planes(host), int(host["seen"].shape[-1])


def _plane_entry(name: str, arr: np.ndarray, key_shape=None) -> dict:
    if name == "rng":
        return {"dtype": "key", "shape": list(arr.shape) if key_shape is None else key_shape}
    return {"dtype": str(arr.dtype), "shape": list(arr.shape)}


def save_checkpoint(directory, state, *, step: int, shards: int = 1, stats: dict | None = None,
                    run_config: dict | None = None, kind: str = "run", keep: int = 0, log=None) -> Path:
    """Write one complete checkpoint of ``state`` (a ``SwarmState`` or a
    ``PackedSwarm``) at round ``step``.

    ``kind="run"`` splits the peer axis over ``shards`` files;
    ``kind="fleet"`` takes a :func:`~tpu_gossip_torch.core.state.stack_states`
    batch and writes a file a lane, each a whole solo state. ``stats`` is a
    dict of host arrays (the trajectory so far); ``run_config`` lands in
    the manifest as it is. ``keep`` > 0 prunes all but the newest ``keep``
    checkpoints once the new manifest is durable."""
    import time

    from tpu_gossip_torch.core.packed import pack_host_planes
    from tpu_gossip_torch.utils.digest import leaf_array, leaf_fields

    t0 = time.perf_counter()
    directory = Path(directory)
    ckdir = directory / checkpoint_name(step)
    ckdir.mkdir(parents=True, exist_ok=True)
    for leftover in ckdir.glob(".tmp-*"):
        leftover.unlink()

    files: dict[str, dict] = {}
    manifest: dict = {"format": FORMAT_VERSION, "kind": kind, "round": int(step), "files": files}

    if kind == "fleet":
        lead = tuple(state.round.shape)
        if len(lead) != 1:
            raise CheckpointError("kind='fleet' expects a stack_states batch (every leaf with a leading lane "
                                  f"axis); round has shape {lead}")
        lanes = int(lead[0])
        manifest["lanes"] = lanes
        manifest["n_peers"] = int(state.seen.shape[1])
        manifest["msg_slots"] = int(state.seen.shape[2])
        lane_hosts = [pack_host_planes({name: leaf_array(name, getattr(state, name)[k])
                                        for name in leaf_fields(state)}) for k in range(lanes)]
        manifest["planes"] = {name: _plane_entry(name, arr, key_shape=[]) for name, arr in lane_hosts[0].items()}
        for k, lane_host in enumerate(lane_hosts):
            arrays = {(f"prngkey_{p}" if p == "rng" else f"field_{p}"): arr for p, arr in lane_host.items()}
            name = f"lane-{k:05d}-of-{lanes:05d}.npz"
            entry = _atomic_write(ckdir / name, _npz_bytes(arrays))
            entry["lane"] = k
            files[name] = entry
    elif kind == "run":
        host, m = _host_packed(state)
        n = host["flags"].shape[0]
        manifest["n_peers"] = int(n)
        manifest["msg_slots"] = m
        manifest["shards"] = int(shards)
        manifest["planes"] = {name: _plane_entry(name, arr) for name, arr in host.items()}
        rp = host["row_ptr"]
        e_real = int(rp[-1])
        bounds = np.linspace(0, n, int(shards) + 1).astype(int)
        row_planes = [p for p in _row_planes(packed=True) if p in host]
        for s in range(int(shards)):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            arrays = {f"rows_{p}": host[p][lo:hi] for p in row_planes}
            # absolute row_ptr entries [lo, hi] and the real edges they
            # span, stored verbatim (the capacity tail rides global.npz)
            arrays["rows_row_ptr"] = rp[lo:hi + 1]
            arrays["rows_col_idx"] = host["col_idx"][int(rp[lo]):int(rp[hi])]
            name = f"shard-{s:05d}-of-{int(shards):05d}.npz"
            entry = _atomic_write(ckdir / name, _npz_bytes(arrays))
            entry["rows"] = [lo, hi]
            files[name] = entry
        gl = {f"field_{p}": host[p] for p in _global_planes() if p != "rng"}
        gl["prngkey_rng"] = host["rng"]
        gl["col_tail"] = host["col_idx"][e_real:]
        files["global.npz"] = _atomic_write(ckdir / "global.npz", _npz_bytes(gl))
    else:
        raise CheckpointError(f"unknown checkpoint kind {kind!r}")

    if stats is not None:
        files["stats.npz"] = _atomic_write(ckdir / "stats.npz",
                                           _npz_bytes({k: np.asarray(v) for k, v in stats.items()}))
    if run_config is not None:
        manifest["run"] = run_config

    # every payload is durable and recorded: the manifest lands last, so its
    # presence is the completeness marker
    _fsync_dir(ckdir)
    _atomic_write(ckdir / MANIFEST_NAME, json.dumps(manifest, indent=1).encode())
    _fsync_dir(ckdir)
    _fsync_dir(directory)
    if log is not None:
        log(f"checkpoint: wrote {ckdir.name} ({sum(e['bytes'] for e in files.values())} bytes, "
            f"{len(files)} files) in {time.perf_counter() - t0:.3f} s")
    if keep > 0:
        prune_checkpoints(directory, keep=keep, log=log)
    return ckdir


def list_checkpoint_steps(directory) -> list[tuple[int, Path]]:
    """All ckpt-* entries under ``directory``, newest first (unverified)."""
    directory = Path(directory)
    out = []
    if not directory.is_dir():
        return out
    for child in directory.iterdir():
        m = _CKPT_RE.match(child.name)
        if m and child.is_dir():
            out.append((int(m.group(1)), child))
    out.sort(key=lambda t: t[0], reverse=True)
    return out


def verify_checkpoint(path) -> dict:
    """The manifest, if the checkpoint is complete and every file matches
    its sha256 and byte count; else :class:`CheckpointError` naming the
    failure."""
    path = Path(path)
    mpath = path / MANIFEST_NAME
    if not mpath.is_file():
        raise CheckpointError(f"{path.name}: no {MANIFEST_NAME} — torn write (the manifest lands last; a crash "
                              "mid-save leaves none)")
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"{path.name}: unreadable manifest ({e}) — torn write") from e
    if manifest.get("format") not in READABLE_FORMATS:
        raise CheckpointError(f"{path.name}: manifest format {manifest.get('format')!r} (this build reads "
                              f"{READABLE_FORMATS})")
    for name, entry in manifest.get("files", {}).items():
        fpath = path / name
        if not fpath.is_file():
            raise CheckpointError(f"{path.name}: shard file {name} missing — dropped mid-write")
        payload = fpath.read_bytes()
        if len(payload) != entry["bytes"]:
            raise CheckpointError(f"{path.name}: {name} holds {len(payload)} bytes, manifest says "
                                  f"{entry['bytes']} — truncated")
        if hashlib.sha256(payload).hexdigest() != entry["sha256"]:
            raise CheckpointError(f"{path.name}: {name} sha256 mismatch — corrupted")
    return manifest


def latest_complete(directory, log=None) -> tuple[Path, dict]:
    """The newest complete checkpoint under ``directory``, rolling back
    past torn or corrupt ones with a logged reason each."""
    steps = list_checkpoint_steps(directory)
    if not steps:
        raise CheckpointError(f"no checkpoints under {directory}")
    for _step, path in steps:
        try:
            manifest = verify_checkpoint(path)
        except CheckpointError as e:
            if log is not None:
                log(f"checkpoint: rolling back past {path.name}: {e}")
            continue
        return path, manifest
    raise CheckpointError(f"no COMPLETE checkpoint under {directory} — every candidate was torn or corrupt "
                          "(reasons logged above)")


def _load_npz(path: Path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _solo_host(arrays: dict, source: str, msg_slots: int) -> dict:
    """One solo state's host planes from a file's ``field_``/``prngkey_``
    arrays: a packed payload decoded, the suspicion planes of a file from
    before them zeroed (all three absent, never a part)."""
    from tpu_gossip_torch.core.packed import decode_host_planes
    from tpu_gossip_torch.core.state import SwarmState, zero_suspicion

    if "field_flags" in arrays:
        arrays = decode_host_planes(arrays, msg_slots)
    host = {}
    for f in dataclasses.fields(SwarmState):
        if f"prngkey_{f.name}" in arrays:
            host[f.name] = arrays[f"prngkey_{f.name}"]
        elif f"field_{f.name}" in arrays:
            host[f.name] = arrays[f"field_{f.name}"]
        elif f.name not in _SUSPICION:
            raise CheckpointError(f"{source}: plane {f.name!r} missing from the checkpoint — foreign or "
                                  "pre-format file")
    absent = [p for p in _SUSPICION if p not in host]
    if len(absent) == len(_SUSPICION):
        host.update(zero_suspicion(np.asarray(host["exists"]).shape[0]))
    elif absent:
        raise CheckpointError(f"{source}: suspicion plane(s) {absent} missing while "
                              f"{sorted(set(_SUSPICION) - set(absent))} are present — torn or foreign checkpoint "
                              "(a pre-adversarial file carries none of the three)")
    return host


def load_checkpoint(path, *, lane: int | None = None, manifest: dict | None = None, device="cuda"):
    """Load one checkpoint directory onto ``device``.

    Returns ``(state, stats, manifest)``: ``state`` a ``SwarmState`` (the
    global layout for kind "run"; for kind "fleet" the stacked batch, or
    lane ``lane`` alone), ``stats`` the stored trajectory prefix as host
    arrays (None if there is none). The files are verified first unless
    the ``manifest`` that :func:`latest_complete` verified is passed. The
    planes are cast to their declared widths and validated against the
    PLANES registry, so a stale or foreign file fails here with the plane
    named."""
    from tpu_gossip_torch.core.state import stack_states, state_from_host

    path = Path(path)
    if manifest is None:
        manifest = verify_checkpoint(path)
    kind = manifest.get("kind", "run")
    packed_fmt = manifest.get("format", 2) >= 3
    m = int(manifest["msg_slots"]) if "msg_slots" in manifest else 0

    def build_solo(arrays: dict, source: str):
        return state_from_host(_solo_host(arrays, source, m), device, source=source)

    if kind == "fleet":
        lanes = int(manifest["lanes"])
        lane_files = sorted((e["lane"], name) for name, e in manifest["files"].items() if "lane" in e)
        if len(lane_files) != lanes:
            raise CheckpointError(f"{path.name}: manifest declares {lanes} lanes but lists {len(lane_files)} "
                                  "lane files")
        if lane is not None:
            if not (0 <= lane < lanes):
                raise CheckpointError(f"{path.name}: lane {lane} outside [0, {lanes})")
            name = dict(lane_files)[lane]
            state = build_solo(_load_npz(path / name), f"{path.name}/{name}")
        else:
            state = stack_states([build_solo(_load_npz(path / name), f"{path.name}/{name}")
                                  for _k, name in lane_files])
    else:
        shard_files = sorted((e["rows"][0], e["rows"][1], name) for name, e in manifest["files"].items()
                             if "rows" in e)
        if not shard_files:
            raise CheckpointError(f"{path.name}: manifest lists no shard files")
        gl = _load_npz(path / "global.npz")
        parts = [_load_npz(path / name) for _lo, _hi, name in shard_files]
        covered = 0
        for lo, hi, name in shard_files:
            if lo != covered:
                raise CheckpointError(f"{path.name}: shard rows are not contiguous at {name} (expected "
                                      f"[{covered}, ...), got [{lo}, {hi}))")
            covered = hi
        if covered != int(manifest["n_peers"]):
            raise CheckpointError(f"{path.name}: shard files cover {covered} rows, manifest declares "
                                  f"n_peers={manifest['n_peers']}")
        arrays = {f"field_{p}": np.concatenate([part[f"rows_{p}"] for part in parts], axis=0)
                  for p in _row_planes(packed=packed_fmt)}
        # the absolute row_ptr slices overlap by one entry at each boundary;
        # the capacity tail comes back from global.npz
        arrays["field_row_ptr"] = np.concatenate(
            [parts[0]["rows_row_ptr"]] + [part["rows_row_ptr"][1:] for part in parts[1:]], axis=0)
        arrays["field_col_idx"] = np.concatenate([part["rows_col_idx"] for part in parts] + [gl["col_tail"]],
                                                 axis=0)
        arrays.update({k: v for k, v in gl.items() if k != "col_tail"})
        del parts, gl
        state = build_solo(arrays, path.name)

    stats = _load_npz(path / "stats.npz") if "stats.npz" in manifest.get("files", {}) else None
    return state, stats, manifest


def load_any(path, *, lane: int | None = None, device="cuda"):
    """Load a checkpoint from either world: a manifest directory (or a
    checkpoint root, through :func:`latest_complete`) or a bare ``.npz``
    of the flat formats (``core.state.load_swarm``). Returns ``(state,
    stats, manifest)``; a flat file has no stats and a synthetic
    manifest."""
    path = Path(path)
    if path.is_dir():
        if (path / MANIFEST_NAME).is_file() or _CKPT_RE.match(path.name):
            return load_checkpoint(path, lane=lane, device=device)
        ck, _manifest = latest_complete(path)
        return load_checkpoint(ck, lane=lane, device=device)
    from tpu_gossip_torch.core.state import load_swarm

    state = load_swarm(path, device=device)
    return state, None, {"format": "legacy-npz", "kind": "run", "round": int(state.round)}


def prune_checkpoints(directory, *, keep: int, log=None) -> list[Path]:
    """Delete all but the newest ``keep`` checkpoint directories (torn
    ones among the older included). Returns the deleted paths."""
    if keep <= 0:
        return []
    doomed = [path for _step, path in list_checkpoint_steps(directory)[keep:]]
    for path in doomed:
        shutil.rmtree(path, ignore_errors=True)
        if log is not None:
            log(f"checkpoint: pruned {path.name} (keep={keep})")
    return doomed
