"""Pipelined rounds (ROADMAP item 9f) against the JAX package on the CPU,
the one-process cells of ``tests/sim/test_pipeline.py``: the spec's
refusals, depth 0 equal to the serial run on the bucketed mesh at S = 8
(plain modes and the composed scenario, growth, stream and control cell)
with the depth-1 runs and their packed twins, the flood closed form, the
depth-1 matching run, the continuation, the run to coverage, the
mid-pipeline, pre-pipeline and round-1 checkpoints, the untouched buffer
of a serial continuation and the stream's expired columns dying in the
buffer. Each run is held to the JAX package's result pinned in
``tests/jax_pins.json`` (``test_torch_pipeline_pins.py`` recomputes the
pins with JAX); the checkpoint cells call JAX in a child process
(``jax_in_child``)."""

import numpy as np
import pytest
import torch

from tpu_gossip.sim.stages import PipelineSpec as JPipelineSpec
from tpu_gossip.sim.stages import compile_pipeline as j_compile_pipeline
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.control import compile_control
from tpu_gossip_torch.core import prng, topology
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig, clone_state, init_swarm, load_swarm, save_swarm
from tpu_gossip_torch.faults import compile_scenario, scenario_from_dict
from tpu_gossip_torch.growth import compile_growth, pad_graph_for_growth
from tpu_gossip_torch.sim.engine import gossip_round, run_until_coverage, simulate
from tpu_gossip_torch.sim.stages import PipelineSpec, compile_pipeline
from tpu_gossip_torch.traffic import compile_stream
from tpu_gossip_torch.traffic.engine import slot_expiry
from tpu_gossip_torch.utils.digest import state_digest, stats_digest
from tests.jax_pins import CHAOS, pinned
from tests.test_torch_growth_cli_engines import jax_in_child
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

PINS = "tests.jax_pins"


def pa(n, m, seed):
    return topology.build_csr(n, topology.preferential_attachment(n, m=m, rng=np.random.default_rng(seed),
                                                                  use_native=False))


def digests(fin, stats) -> dict:
    return {"state_digest": state_digest(fin), "stats_digest": stats_digest(stats)}


def pipe(depth):
    return None if depth is None else compile_pipeline(depth)


def test_compile_pipeline_validates_as_jax():
    assert compile_pipeline(0).depth == 0 and compile_pipeline().depth == 1
    for bad in (2, -1):
        with pytest.raises(ValueError) as got:
            PipelineSpec(depth=bad)
        with pytest.raises(ValueError) as want:
            JPipelineSpec(depth=bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        j_compile_pipeline(2)
    with pytest.raises(ValueError):
        compile_pipeline(2)


# ------------------------------------------------ the bucketed mesh at S = 8


def bucketed_run(mode: str, composed: bool, depth, packed: bool = False, rounds: int = 7) -> dict:
    """The port's twin of ``tests.jax_pins.bucketed_run``."""
    g, gexists = pad_graph_for_growth(pa(600, 3, 0), 640)
    sg, relabeled, position = tdist.partition_graph(g, 8, seed=0, device="cpu")
    mesh = tdist.make_mesh(8, device="cpu")
    extra = dict(rewire_slots=2, churn_leave_prob=0.01, churn_join_prob=0.05) if composed else {}
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=8, fanout=2, mode=mode, **extra)
    planes = {}
    if composed:
        def node_map(ids):
            return position[np.asarray(ids)]

        planes = dict(
            scenario=compile_scenario(scenario_from_dict(CHAOS), n_peers=600, n_slots=sg.n_pad, total_rounds=10,
                                      node_map=node_map, device="cpu"),
            growth=compile_growth(n_initial=600, target=640, n_slots=sg.n_pad, joins_per_round=8, attach_m=2,
                                  node_map=node_map, max_join_burst=4, device="cpu"),
            stream=compile_stream(rate=1.5, msg_slots=8, ttl=6, origin_rows=position[np.arange(600)], k_hashes=1,
                                  device="cpu"),
            control=compile_control(target_ratio=0.9, fanout=2, lo=1, hi=2, refresh_every=3, device="cpu"))
    st = tdist.init_sharded_swarm(sg, relabeled, position, cfg, origins=[0], exists=gexists, device="cpu")
    st = tdist.shard_swarm(st, mesh)
    fin, stats = tdist.simulate_dist(pack_state(st) if packed else st, cfg, sg, mesh, rounds, None,
                                     pipeline=pipe(depth), **planes)
    if packed:
        fin = unpack_state(fin)
    return {**digests(fin, stats), "pipe_buf_bits": int(fin.pipe_buf.sum())}


def pin(name):
    return pinned("pipeline", name)


@pytest.mark.parametrize("mode,composed", [("push", False), ("push_pull", False), ("push_pull", True)],
                         ids=["push", "push_pull", "composed"])
def test_bucketed_depth0_equals_serial_and_jax(mode, composed):
    """Depth 0 is the serial run bit for bit; the depth-1 run (and its
    packed twin) equals JAX's, and so does the composed cell's serial run
    (the plain modes' serial runs are held to JAX since the bucketed
    engine's slice)."""
    name = f"bucketed_{mode}{'_composed' if composed else ''}"
    serial = bucketed_run(mode, composed, None)
    assert bucketed_run(mode, composed, 0) == serial
    if composed:
        assert serial == pin(f"{name}_None")
    assert serial["pipe_buf_bits"] == 0
    depth1 = bucketed_run(mode, composed, 1)
    assert depth1 == pin(f"{name}_1")
    assert depth1["pipe_buf_bits"] > 0 and depth1["state_digest"] != serial["state_digest"]
    assert bucketed_run(mode, composed, 1, packed=True) == depth1


# --------------------------------------------------------- depth-1 semantics


def local_run(n, m, seed, key, origins, mode, slots, rounds, depth, stream_rate=0.0, ttl=6, churn=False, split=0,
              tail_depth="same"):
    """The port's twin of ``tests.jax_pins.local_pipeline_run``; returns the
    final state and its digests."""
    extra = dict(churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=3) if churn else {}
    cfg = SwarmConfig(n_peers=n, msg_slots=slots, fanout=2, mode=mode, **extra)
    st = init_swarm(pa(n, m, seed), cfg, origins=origins, key=prng.key(key, "cpu"), device="cpu")
    sp = compile_stream(rate=stream_rate, msg_slots=slots, ttl=ttl, origin_rows=np.arange(n),
                        device="cpu") if stream_rate else None
    tail = pipe(depth) if tail_depth == "same" else pipe(tail_depth)
    if split:
        st, _ = simulate(st, cfg, split, stream=sp, pipeline=pipe(depth))
    fin, stats = simulate(st, cfg, rounds - split, stream=sp, pipeline=tail)
    return fin, {**digests(fin, stats), "pipe_buf_bits": int(fin.pipe_buf.sum())}


def test_flood_depth1_closed_form():
    """2k pipelined flood rounds land on k serial rounds' seen plane (the
    recurrence seen_t = seen_{t-1} | F(seen_{t-2})), and the 6-round
    pipelined run equals JAX's."""
    for k in (1, 2, 3):
        fin_p, _ = local_run(300, 2, 0, 1, [0], "flood", 4, 2 * k, 1)
        fin_s, _ = local_run(300, 2, 0, 1, [0], "flood", 4, k, None)
        assert torch.equal(fin_p.seen, fin_s.seen), k
    assert local_run(300, 2, 0, 1, [0], "flood", 4, 6, 1)[1] == pin("flood_6")


def test_depth1_matching_run_equals_jax():
    """The pipelined matching engine over ``tests/sim/test_pipeline.py``'s
    eight-shard layout: the local run (the JAX test's local half) equals
    JAX's, and so does the same run on the 8-shard matching mesh (its mesh
    half, which JAX holds bit-identical to the local one)."""
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph_sharded

    g, plan = matching_powerlaw_graph_sharded(800, 8, fanout=2, key=prng.key(0, "cpu"), growth_rows=32,
                                              device="cpu")
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=2, mode="push_pull")
    st = init_swarm(g.as_padded_graph(), cfg, origins=[0, 5], exists=g.exists, key=prng.key(3, "cpu"), device="cpu")
    fin, stats = simulate(st, cfg, 6, plan, pipeline=compile_pipeline(1))
    got = {**digests(fin, stats), "pipe_buf_bits": int(fin.pipe_buf.sum())}
    assert got["pipe_buf_bits"] > 0  # the buffer is live
    assert got == pin("matching_6")
    mesh = tdist.make_mesh(8, device="cpu")
    fin, stats = tdist.simulate_dist(tdist.shard_swarm(st, mesh), cfg, tdist.shard_matching_plan(plan, mesh), mesh, 6,
                                     pipeline=compile_pipeline(1))
    assert {**digests(fin, stats), "pipe_buf_bits": int(fin.pipe_buf.sum())} == got


def test_depth1_continuation_is_exact():
    """A pipelined 3 + 2 split lands on the straight 5 rounds, equal to
    JAX's: the in-flight buffer is a true state carry."""
    mid, _ = local_run(240, 3, 2, 4, [1], "push_pull", 4, 3, 1)
    assert bool(mid.pipe_buf.any())
    whole = local_run(240, 3, 2, 4, [1], "push_pull", 4, 5, 1)[1]
    split = local_run(240, 3, 2, 4, [1], "push_pull", 4, 5, 1, split=3)[1]
    assert whole["state_digest"] == split["state_digest"]
    assert whole == pin("continuation_5")


def test_depth1_reaches_coverage():
    """The epidemic tolerates the one-round staleness: the pipelined run
    reaches 0.99 in JAX's rounds, on JAX's state."""
    cfg = SwarmConfig(n_peers=400, msg_slots=4, fanout=2, mode="push_pull")
    st = init_swarm(pa(400, 3, 3), cfg, origins=[0], key=prng.key(5, "cpu"), device="cpu")
    fin = run_until_coverage(st, cfg, 0.99, 200, pipeline=compile_pipeline(1))
    assert float(fin.coverage(0)) >= 0.99
    assert {"rounds": int(fin.round), "state_digest": state_digest(fin)} == pin("coverage")


# ------------------------------------------------------------ checkpointing


def test_mid_pipeline_checkpoint_roundtrips_across_packages(tmp_path):
    """A churned state saved mid-pipeline (non-empty buffer) loads leaf for
    leaf, resumes onto the uninterrupted run, and the JAX package resumes
    the port's file onto the same digests."""
    mid, _ = local_run(200, 3, 7, 9, [0], "push_pull", 4, 3, 1, churn=True)
    assert bool(mid.pipe_buf.any()), "fixture buffer unexpectedly empty"
    save_swarm(tmp_path / "pipe.npz", mid)
    loaded = load_swarm(tmp_path / "pipe.npz", device="cpu")
    assert state_digest(loaded) == state_digest(mid)
    cfg = SwarmConfig(n_peers=200, msg_slots=4, fanout=2, mode="push_pull", churn_leave_prob=0.02,
                      churn_join_prob=0.2, rewire_slots=3)
    fin_a, st_a = simulate(clone_state(mid), cfg, 3, pipeline=compile_pipeline(1))
    fin_b, st_b = simulate(loaded, cfg, 3, pipeline=compile_pipeline(1))
    assert digests(fin_a, st_a) == digests(fin_b, st_b)
    whole = local_run(200, 3, 7, 9, [0], "push_pull", 4, 6, 1, churn=True)[0]
    assert state_digest(whole) == state_digest(fin_a)
    assert jax_in_child(PINS, "resume_pipeline_npz", str(tmp_path / "pipe.npz"), 200, 3, 7, 3) == digests(fin_a, st_a)


def test_pre_pipeline_named_checkpoint_loads_empty_buffer(tmp_path):
    """A named-format file written before the plane existed (its key
    stripped) loads with an empty (N, M) buffer."""
    cfg = SwarmConfig(n_peers=64, msg_slots=4)
    st = init_swarm(pa(64, 2, 0), cfg, origins=[1], key=prng.key(0, "cpu"), device="cpu")
    save_swarm(tmp_path / "new.npz", st)
    data = dict(np.load(tmp_path / "new.npz"))
    assert "field_pipe_buf" in data
    del data["field_pipe_buf"]
    np.savez(tmp_path / "old.npz", **data)
    st2 = load_swarm(tmp_path / "old.npz", device="cpu")
    assert tuple(st2.pipe_buf.shape) == tuple(st.seen.shape) and not bool(st2.pipe_buf.any())


def test_v1_checkpoint_loads_empty_buffer(tmp_path):
    """The JAX package's round-1 positional file predates the plane too."""
    want = jax_in_child(PINS, "write_v1", str(tmp_path / "v1.npz"), 32, 4, 2)
    st = load_swarm(tmp_path / "v1.npz", device="cpu")
    assert st.seen.numpy().tolist() == want["seen"]
    assert tuple(st.pipe_buf.shape) == (32, 4) and not bool(st.pipe_buf.any())


def test_serial_rounds_carry_buffer_untouched():
    """A serial continuation of a mid-pipeline state carries the in-flight
    plane verbatim, as JAX's does."""
    mid, _ = local_run(150, 3, 11, 2, [0], "push", 4, 2, 1)
    buf = mid.pipe_buf.clone()
    assert bool(buf.any())
    fin, got = local_run(150, 3, 11, 2, [0], "push", 4, 5, 1, split=2, tail_depth=None)
    assert torch.equal(fin.pipe_buf, buf)
    assert got == pin("serial_tail")


def test_depth1_expired_columns_die_in_the_buffer():
    """Pipelined and streaming: a column the age-out recycles at round t
    keeps none of its retired message's bits in the stored buffer; the run
    and its packed twin equal JAX's."""
    cfg = SwarmConfig(n_peers=200, msg_slots=4, fanout=2, mode="push_pull")
    state = init_swarm(pa(200, 3, 13), cfg, origins=[0, 1, 2], key=prng.key(6, "cpu"), device="cpu")
    packed = pack_state(clone_state(state))
    sp = compile_stream(rate=1.0, msg_slots=4, ttl=6, origin_rows=np.arange(200), device="cpu")
    saw_expiry = False
    rows = []
    for _ in range(14):
        expired = slot_expiry(state.slot_lease, state.round + 1, sp.ttl)
        state, st = gossip_round(state, cfg, stream=sp, pipeline=compile_pipeline(1))
        packed, _ = gossip_round(packed, cfg, stream=sp, pipeline=compile_pipeline(1))
        rows.append(st)
        if bool(expired.any()):
            saw_expiry = True
            assert not bool(state.pipe_buf[:, expired].any()), "a retired message's bits survived in the buffer"
    assert saw_expiry, "the fixture never recycled a slot"
    assert state_digest(unpack_state(packed)) == state_digest(state)
    assert state_digest(state) == pin("expired")["state_digest"]
