"""The port's checkpoint layer against the JAX package's, bit for bit: the
plane registry, the flat npz (``save_swarm``/``load_swarm``, every legacy
generation), the sharded store (round trips, the shard count, the capacity
tail, each corruption mode rolled back with JAX's reason, retention), the
driver's grid and stats, and checkpoint directories of every kind that
one package writes and the other loads leaf for leaf."""

import dataclasses
import hashlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_gossip import ckpt as jck
from tpu_gossip.core import packed as jpacked
from tpu_gossip.core import state as jstate
from tpu_gossip.core.topology import build_csr, preferential_attachment
from tpu_gossip.fleet.engine import state_digest as jdigest
from tpu_gossip.sim import engine as jengine
from tpu_gossip_torch import ckpt as tck
from tpu_gossip_torch import convert
from tpu_gossip_torch.core import packed as tpacked
from tpu_gossip_torch.core import state as tstate
from tpu_gossip_torch.sim import engine as tengine
from tpu_gossip_torch.utils.digest import state_digest as tdigest
from tpu_gossip_torch.utils.digest import stats_digest as tstats_digest
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.unit.test_state import save_v1


def _jleaves(st) -> dict:
    """A JAX state's leaves as numpy (the key as its uint32 words)."""
    out = {}
    for f in dataclasses.fields(type(st)):
        if f.metadata.get("static"):
            continue
        leaf = getattr(st, f.name)
        out[f.name] = np.asarray(jax.random.key_data(leaf) if f.name == "rng" else leaf)
    return out


def _to_port(st):
    if isinstance(st, jpacked.PackedSwarm):
        return convert.packed_state_from_jax(_jleaves(st), st.msg_slots, device="cpu")
    return convert.state_from_jax(_jleaves(st), device="cpu")


def _leaf_equal(port_state, jax_state) -> None:
    got, want = convert.to_numpy(port_state), _jleaves(jax_state)
    assert list(got) == list(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape, name
        assert np.array_equal(got[name], arr), name


def _cfg(churn: bool, n=96):
    kw = dict(churn_leave_prob=0.05, churn_join_prob=0.3, rewire_slots=2) if churn else {}
    return jstate.SwarmConfig(n_peers=n, msg_slots=8, fanout=2, **kw)


@pytest.fixture(scope="module")
def states():
    """JAX states after 6 rounds: warm (no churn), churned (two, from other
    keys), and churned then folded (a CSR with a capacity tail)."""
    rng = np.random.default_rng(0)
    g = build_csr(96, preferential_attachment(96, m=2, rng=rng, use_native=False))
    out = {}
    for kind, key in (("warm", 1), ("churned", 1), ("churned_b", 5)):
        cfg = _cfg(kind != "warm")
        st = jstate.init_swarm(g, cfg, origins=[0, 3], key=jax.random.key(key))
        out[kind], _ = jengine.simulate(st, cfg, 6)
    cfg = _cfg(True)
    st = jstate.init_swarm(g, cfg, origins=[0, 3], key=jax.random.key(1))
    cap = jengine.remat_capacity(st, cfg)
    st, _ = jengine.simulate(st, cfg, 6)
    out["folded"], _ = jengine.rematerialize_rewired(st, cfg, cap)
    assert int(out["folded"].col_idx.shape[0]) > int(np.asarray(out["folded"].row_ptr)[-1])
    return out


# ------------------------------------------------------------ registry


def test_planes_equal_jax():
    assert [(p.name, p.dtype, p.shape, p.info_bits, p.packed) for p in tstate.PLANES] == \
        [(p.name, p.dtype, p.shape, p.info_bits, p.packed) for p in jstate.PLANES]
    assert [p.name for p in tstate.PLANES] == [f.name for f in dataclasses.fields(tstate.SwarmState)]
    assert set(tstate.plane_registry()) == set(jstate.plane_registry())


def test_store_partition_covers_every_plane():
    from tpu_gossip.ckpt import store as js
    from tpu_gossip_torch.ckpt import store as ts

    names = {f.name for f in dataclasses.fields(tstate.SwarmState)}
    assert set(ts._row_planes()) | set(ts._global_planes()) | set(ts._CSR_PLANES) == names
    for packed in (False, True):
        assert ts._row_planes(packed) == js._row_planes(packed)
    assert ts._global_planes() == js._global_planes()


def test_packed_swarm_fields_are_jax_storage_layout():
    assert [f.name for f in dataclasses.fields(tpacked.PackedSwarm)] == \
        [f.name for f in dataclasses.fields(jpacked.PackedSwarm)]


# ------------------------------------------------------------ flat npz


@pytest.mark.parametrize("kind", ["warm", "churned", "folded"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_swarm_crosses_packages(tmp_path, states, kind, writer):
    st = states[kind]
    path = tmp_path / "st.npz"
    if writer == "port":
        tstate.save_swarm(path, _to_port(st))
        back = jstate.load_swarm(path)
        assert jdigest(back) == jdigest(st)
        jstate.save_swarm(tmp_path / "j.npz", st)
        assert set(np.load(path).files) == set(np.load(tmp_path / "j.npz").files)
    else:
        jstate.save_swarm(path, st)
        _leaf_equal(tstate.load_swarm(path, device="cpu"), st)


def _legacy(kind: str, st, path):
    """Write ``st`` as one of the older flat generations the loaders read."""
    if kind.startswith("v1"):
        save_v1(st, path, per_peer_sir=kind == "v1_per_peer_sir")
        return
    jstate.save_swarm(path, st)
    data = dict(np.load(path))
    # unpack the packed payload: the named format before packing
    data = jpacked.decode_host_planes(data, int(data["field_infected_round"].shape[-1]))
    if kind == "pre_scenario":
        for newer in ("fault_held", "join_round", "admitted_by", "degree_credit", "slot_lease", "control_lvl",
                      "pipe_buf", "suspect_round", "suspect_mark", "quarantine"):
            data.pop(f"field_{newer}")
    elif kind == "pre_suspicion":
        for newer in ("suspect_round", "suspect_mark", "quarantine"):
            data.pop(f"field_{newer}")
    elif kind == "wide_rounds":
        for name in ("join_round", "slot_lease", "infected_round", "last_hb"):
            data[f"field_{name}"] = data[f"field_{name}"].astype(np.int32)
    np.savez(path, **data)


@pytest.mark.parametrize("kind", ["v1_per_peer_sir", "v1_per_slot_sir", "unpacked_named", "pre_scenario",
                                  "pre_suspicion", "wide_rounds"])
def test_every_legacy_generation_loads_as_in_jax(tmp_path, states, kind):
    path = tmp_path / "legacy.npz"
    _legacy(kind, states["churned"], path)
    want = jstate.load_swarm(path)
    _leaf_equal(tstate.load_swarm(path, device="cpu"), want)
    got, _stats, manifest = tck.load_any(path, device="cpu")
    assert manifest["format"] == "legacy-npz" and tdigest(got) == jdigest(want)


def test_load_swarm_names_the_broken_plane(tmp_path, states):
    path = tmp_path / "ck.npz"
    jstate.save_swarm(path, states["warm"])
    data = dict(np.load(path))
    data["field_seen"] = data["field_seen"].astype(np.float32)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="'seen'.*dtype"):
        tstate.load_swarm(path, device="cpu")
    jstate.save_swarm(path, states["warm"])
    data = dict(np.load(path))
    data["field_flags"] = data["field_flags"][:16]
    np.savez(path, **data)
    with pytest.raises(ValueError, match="'exists'.*shape"):
        tstate.load_swarm(path, device="cpu")


def test_stack_and_lane_state_equal_jax(states):
    lanes = [states["churned"], states["churned_b"]]
    batch = tstate.stack_states([_to_port(s) for s in lanes])
    _leaf_equal(batch, jstate.stack_states(lanes))
    _leaf_equal(tstate.lane_state(batch, 1), jstate.lane_state(jstate.stack_states(lanes), 1))


# ------------------------------------------------------------ the store


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_roundtrip_is_bit_exact(tmp_path, states, shards):
    st = _to_port(states["churned"])
    stats = {"coverage": np.arange(6, dtype=np.float32), "msgs_sent": np.arange(6, dtype=np.int32)}
    tck.save_checkpoint(tmp_path, st, step=6, shards=shards, stats=stats, run_config={"peers": 96})
    back, stats2, manifest = tck.load_checkpoint(tmp_path / "ckpt-00000006", device="cpu")
    assert tdigest(back) == tdigest(st)
    for k, v in stats.items():
        assert stats2[k].dtype == v.dtype and np.array_equal(stats2[k], v)
    assert manifest["format"] == 3 and manifest["shards"] == shards and manifest["run"] == {"peers": 96}
    jck.save_checkpoint(tmp_path / "j", states["churned"], step=6, shards=shards)
    jm = json.loads((tmp_path / "j" / "ckpt-00000006" / "MANIFEST.json").read_text())
    assert manifest["planes"] == jm["planes"] and manifest["planes"]["rng"] == {"dtype": "key", "shape": [2]}
    assert {k: e.get("rows") for k, e in manifest["files"].items()} == \
        {k: e.get("rows") for k, e in jm["files"].items() if k != "stats.npz"} | {"stats.npz": None}


def test_shard_count_is_a_storage_choice(tmp_path, states):
    st = _to_port(states["churned"])
    digests = set()
    for s in (1, 3, 8):
        tck.save_checkpoint(tmp_path / f"s{s}", st, step=6, shards=s)
        digests.add(tdigest(tck.load_checkpoint(tmp_path / f"s{s}" / "ckpt-00000006", device="cpu")[0]))
    assert digests == {tdigest(st)}


def test_capacity_tail_survives_the_roundtrip(tmp_path, states):
    st = _to_port(states["folded"])
    tck.save_checkpoint(tmp_path, st, step=6, shards=3)
    back, _, _ = tck.load_checkpoint(tmp_path / "ckpt-00000006", device="cpu")
    assert back.col_idx.shape[0] > int(back.row_ptr[-1])
    assert np.array_equal(back.col_idx.numpy(), st.col_idx.numpy())
    assert np.array_equal(back.row_ptr.numpy(), st.row_ptr.numpy())


@pytest.mark.parametrize("mode", tck.CORRUPTION_MODES)
def test_every_corruption_mode_is_rolled_back_with_jax_reason(tmp_path, states, mode):
    """The port's damage is caught, and the port's rollback logs the very
    text JAX's logs on the same directory."""
    cfg = tstate.SwarmConfig(n_peers=96, msg_slots=8, fanout=2, churn_leave_prob=0.05, churn_join_prob=0.3,
                             rewire_slots=2)
    st = _to_port(states["churned"])
    tck.save_checkpoint(tmp_path, st, step=6, shards=2)
    st2, _ = tengine.simulate(st, cfg, 3)
    tck.save_checkpoint(tmp_path, st2, step=9, shards=2)
    tck.corrupt_checkpoint(tmp_path / "ckpt-00000009", mode)
    with pytest.raises(tck.CheckpointError):
        tck.verify_checkpoint(tmp_path / "ckpt-00000009")
    logs, jlogs = [], []
    path, _ = tck.latest_complete(tmp_path, log=logs.append)
    jpath, _ = jck.latest_complete(tmp_path, log=jlogs.append)
    assert path.name == jpath.name == "ckpt-00000006"
    assert logs == jlogs and "ckpt-00000009" in logs[0]
    assert tdigest(tck.load_checkpoint(path, device="cpu")[0]) == tdigest(st)


def test_all_checkpoints_corrupt_is_a_clean_error(tmp_path, states):
    tck.save_checkpoint(tmp_path, _to_port(states["warm"]), step=6, shards=2)
    tck.corrupt_checkpoint(tmp_path / "ckpt-00000006", "flip_byte")
    with pytest.raises(tck.CheckpointError, match="no COMPLETE checkpoint"):
        tck.latest_complete(tmp_path, log=lambda _m: None)
    with pytest.raises(tck.CheckpointError, match="no checkpoints"):
        tck.latest_complete(tmp_path / "empty")


def test_retention_prunes_oldest(tmp_path, states):
    cfg = tstate.SwarmConfig(n_peers=96, msg_slots=8, fanout=2)
    st = _to_port(states["warm"])
    for k in range(4):
        tck.save_checkpoint(tmp_path, st, step=6 + 3 * k, shards=1, keep=2)
        st, _ = tengine.simulate(st, cfg, 3)
    assert [s for s, _ in tck.list_checkpoint_steps(tmp_path)] == [15, 12]
    tck.prune_checkpoints(tmp_path, keep=1)
    assert [s for s, _ in tck.list_checkpoint_steps(tmp_path)] == [15]


def test_foreign_plane_in_a_manifest_dir_is_named(tmp_path, states):
    tck.save_checkpoint(tmp_path, _to_port(states["warm"]), step=6, shards=2)
    ck, name = tmp_path / "ckpt-00000006", "shard-00000-of-00002.npz"
    arrays = dict(np.load(ck / name))
    arrays["rows_seen"] = arrays["rows_seen"].astype(np.float32)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    (ck / name).write_bytes(buf.getvalue())
    manifest = json.loads((ck / "MANIFEST.json").read_text())
    manifest["files"][name].update(sha256=hashlib.sha256(buf.getvalue()).hexdigest(), bytes=len(buf.getvalue()))
    (ck / "MANIFEST.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="'seen'"):
        tck.load_checkpoint(ck, device="cpu")


# ------------------------------------------------------------ the driver


def test_next_cut_grids():
    for args in ((0, 20, 5), (7, 20, 5), (18, 20, 5), (0, 20, 0), (4, 30, 6, 10), (6, 30, 6, 10)):
        assert tck.next_cut(*args) == jck.next_cut(*args)
    assert [tck.next_cut(*a) for a in ((0, 20, 5), (7, 20, 5), (4, 30, 6, 10), (6, 30, 6, 10))] == [5, 3, 2, 4]


def test_host_stats_and_concat_keep_jax_dtypes(states):
    """A JAX stats prefix joined to the port's segment stays float32 where
    JAX stores float32, so the joined trajectory digests as JAX's does."""
    from tpu_gossip.fleet.engine import stats_digest as jstats_digest
    from tpu_gossip_torch.cli.run_sim import _split_host_stats

    cfg = _cfg(True)
    tcfg = tstate.SwarmConfig(**dataclasses.asdict(cfg))
    jfin, jstats = jengine.simulate(jstate.clone_state(states["churned"]), cfg, 4)
    _, tstats = tengine.simulate(_to_port(states["churned"]), tcfg, 4)
    jh, th = jck.host_stats(jstats), tck.host_stats(tstats)
    assert {k: (v.dtype, v.shape) for k, v in th.items()} == {k: (v.dtype, v.shape) for k, v in jh.items()}
    tmid = _to_port(jfin)
    _, jmore = jengine.simulate(jfin, cfg, 2)
    joined = tck.concat_stats([jh, tck.host_stats(tengine.simulate(tmid, tcfg, 2)[1])])
    want = jck.concat_stats([jh, jck.host_stats(jmore)])
    assert joined["coverage"].dtype == np.float32 and joined["degree_gamma"].dtype == np.float32
    for k, v in want.items():
        assert joined[k].dtype == v.dtype and np.array_equal(joined[k], v), k
    assert tstats_digest(_split_host_stats(joined)[0]) == jstats_digest(jengine.RoundStats(**want))


def test_run_checkpointed_resume_replays_the_fold(tmp_path, states):
    """The driver on the port's local remat loop: a run resumed from an
    epoch-boundary checkpoint replays its fold and ends where the
    uninterrupted run ends."""
    cfg = tstate.SwarmConfig(n_peers=96, msg_slots=8, fanout=2, churn_leave_prob=0.05, churn_join_prob=0.3,
                             rewire_slots=2)
    st0 = _to_port(states["churned"])
    cap = tengine.remat_capacity(st0, cfg)

    def seg(st, n):
        st, s = tengine.simulate(st, cfg, n)
        return st, tck.host_stats(s)

    def fold(st):
        return tengine.rematerialize_rewired(st, cfg, cap)[0]

    policy = tck.CheckpointPolicy(every=4, directory=str(tmp_path))
    fin, sd = tck.run_checkpointed(st0, 18, seg, policy=policy, fold_every=4, fold=fold)
    shutil.rmtree(tmp_path / "ckpt-00000016")
    path, _ = tck.latest_complete(tmp_path)
    assert path.name == "ckpt-00000012"
    loaded, prefix, _ = tck.load_checkpoint(path, device="cpu")
    fin2, sd2 = tck.run_checkpointed(loaded, 18, seg, policy=policy, stats_prefix=prefix, fold_every=4, fold=fold)
    assert tdigest(fin2) == tdigest(fin)
    assert all(np.array_equal(sd2[k], sd[k]) for k in sd)


# ------------------------------------------------------------ directories across packages


def _format2(ckdir):
    """Rewrite a format-3 run checkpoint as format 2 (unpacked planes),
    its digests recomputed: the layout the stores wrote before packing."""
    from tpu_gossip.ckpt import store as js

    manifest = json.loads((ckdir / "MANIFEST.json").read_text())
    m = manifest["msg_slots"]
    for name, entry in manifest["files"].items():
        if "rows" not in entry:
            continue
        arrays = dict(np.load(ckdir / name))
        arrays = jpacked.decode_host_planes(arrays, m, prefix="rows_")
        payload = js._npz_bytes(arrays)
        (ckdir / name).write_bytes(payload)
        entry.update(sha256=hashlib.sha256(payload).hexdigest(), bytes=len(payload))
    manifest["format"] = 2
    (ckdir / "MANIFEST.json").write_text(json.dumps(manifest))


@pytest.mark.parametrize("form", ["format3", "format3_packed_carry", "format2", "fleet", "fleet_lane"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_dirs_load_leaf_equal_across_packages(tmp_path, states, form, writer):
    st = states["churned"]
    if form.startswith("fleet"):
        lanes = [states["churned"], states["churned_b"], states["churned"]]
        obj = jstate.stack_states(lanes)
        kw = dict(kind="fleet")
    elif form == "format3_packed_carry":
        obj, kw = jpacked.pack_state(st), dict(shards=3)
    else:
        obj, kw = st, dict(shards=3)
    if writer == "jax":
        jck.save_checkpoint(tmp_path, obj, step=6, **kw)
    else:
        tck.save_checkpoint(tmp_path, tstate.stack_states([_to_port(s) for s in lanes]) if form.startswith("fleet")
                            else _to_port(obj), step=6, **kw)
    ck = tmp_path / "ckpt-00000006"
    if form == "format2":
        _format2(ck)
    lane = 1 if form == "fleet_lane" else None
    load = (lambda: tck.load_checkpoint(ck, lane=lane, device="cpu")[0]) if writer == "jax" else \
        (lambda: jck.load_checkpoint(ck, lane=lane)[0])
    want = jstate.lane_state(obj, 1) if form == "fleet_lane" else \
        (st if form == "format3_packed_carry" else obj)
    if writer == "jax":
        _leaf_equal(load(), want)
    else:
        assert jdigest(load()) == jdigest(want)


def test_loads_default_to_the_card(tmp_path, states, monkeypatch, capsys):
    """Without a card, every load that is not told the CPU raises, and
    ``run_sim resume`` exits 2: nothing carries on on the CPU unasked."""
    import torch

    from tpu_gossip_torch.cli import run_sim

    tstate.save_swarm(tmp_path / "st.npz", _to_port(states["warm"]))
    tck.save_checkpoint(tmp_path, _to_port(states["warm"]), step=6, run_config={"peers": 96})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tstate.load_swarm(tmp_path / "st.npz"),
                 lambda: tck.load_checkpoint(tmp_path / "ckpt-00000006"),
                 lambda: tck.load_any(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert run_sim.main(["resume", str(tmp_path)]) == 2
    assert "CUDA" in capsys.readouterr().err
