"""The JAX package's halves of the pipelined-round, fleet and sharded
matching comparisons, as JSON-able results. Each function builds its run
from plain arguments, so the port's test builds the same run from the
same arguments.

:data:`CASES` names the runs the port's tests compare with; their results
are pinned in ``tests/jax_pins.json`` (so a test compares the port's run
with the pin, in its own process), and ``test_jax_pins_are_current`` of
each group recomputes the group, or for the costlier groups (``mesh``,
``mesh_cli``, ``mesh_facts``, ``stream_cli``, ``tail_words``) a batch of it, here in a
child process (``tests.test_torch_growth_cli_engines.jax_in_child``) and
holds it to the file; ``profile`` holds timing-free shapes no test
recomputes. The pins of ``tpu_gossip_torch/reference_pins.json`` that
``chip_smoke.py`` runs on the card come from here too::

    JAX_PLATFORMS=cpu python -m tests.jax_pins write        # tests/jax_pins.json
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.jax_pins write mesh mesh_cli mesh_facts stream_cli profile tail_words
    JAX_PLATFORMS=cpu python -m tests.jax_pins matching_pipeline_1m
    JAX_PLATFORMS=cpu python -m tests.jax_pins cli_pin ARGV...
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.jax_pins dist_matching_1m            # phase 14's 1M pins
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.jax_pins mesh_card_pins              # phase 14's n=20000 pins
    JAX_PLATFORMS=cpu python -m tests.jax_pins write simnet  # the tpu-sim transport's runs
    JAX_PLATFORMS=cpu python -m tests.jax_pins simnet_1m_pin # phase 16a's 1M pin
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.jax_pins write cluster               # the (hosts, devices) cells and runs
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.jax_pins dist_matching_1m_hier       # phase 17a's hier leg
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m tests.jax_pins cluster_grow_pins           # phase 17f's three pins
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -c "from tests import jax_pins as J; J.write('stream_runs')"
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

from tpu_gossip_torch.serve.trace import scripted_windows  # noqa: F401 (a numpy generator both halves read)


# the round tail's operand planes, in ``round_tail``'s argument order
NAMES = ("seen", "forwarded", "infected_round", "recovered", "incoming", "receptive", "transmit")
# the fresh-row, round, expired-column and form combinations of a word-tail case
TAIL_COMBOS = [(f, e, r, p) for f in (False, True) for e in (False, True) for r in (9, 32771) for p in (False, True)]


def cap_edge_operands(n, m, seed, rnd):
    """Tail operands whose ``infected_round`` holds ROUND_CAP, -1 and small
    values, and mostly receptive incoming deliveries."""
    rng = np.random.default_rng(seed)
    b = lambda p: rng.random((n, m)) < p  # noqa: E731
    ir = rng.choice(np.array([32767, 32766, -1, 0, 1, 5, 8], np.int16), (n, m))
    ops = dict(seen=b(0.5), forwarded=b(0.3), infected_round=ir, recovered=b(0.2),
               incoming=b(0.5), receptive=b(0.9), transmit=b(0.5))
    return ops, rng.random(n) < 0.1, rng.random(m) < 0.3


def word_tail_forms(m, forward_once, sir):
    """Both JAX forms of ``round_tail_words`` (the XLA word chain and the
    Pallas kernel in interpret mode) on one grid point's operands, each
    ``TAIL_COMBOS`` combination: the four outputs as ``(dtype name,
    nested list)`` pairs."""
    import jax
    import jax.numpy as jnp

    from tpu_gossip.core.packed import pack_bits
    from tpu_gossip.kernels import round_tail

    ops, fresh, expired = cap_edge_operands(300, m, m * 7 + sir + forward_once, 0)
    words = [pack_bits(jnp.asarray(ops[k])) if k != "infected_round" else jnp.asarray(ops[k]) for k in NAMES]
    forms = {}  # one jit a static form: the round is a traced operand, so both rounds share the compile

    def form(has_fresh, has_expired, pallas):
        def run(*args):
            *w, f, r, e = args
            return round_tail.round_tail_words(
                *w, f if has_fresh else None, r, m=m, forward_once=forward_once, sir_recover_rounds=sir,
                expired=e if has_expired else None, pallas=pallas, interpret=True if pallas else None)

        return forms.setdefault((has_fresh, has_expired, pallas), jax.jit(run))

    out = []
    for has_fresh, has_expired, rnd, pallas in TAIL_COMBOS:
        want = form(has_fresh, has_expired, pallas)(*words, jnp.asarray(fresh), jnp.asarray(rnd, jnp.int32),
                                                    jnp.asarray(expired))
        out.append([(str(np.asarray(a).dtype), np.asarray(a).tolist()) for a in want])
    return out


def word_tail_digests(m, forward_once, sir) -> list:
    """:func:`word_tail_forms` as a sha256 an output (:func:`leaf_digest`)."""
    return [[leaf_digest(np.asarray(a, dtype=dtype)) for dtype, a in outs]
            for outs in word_tail_forms(m, forward_once, sir)]


def _digests(fin, stats) -> dict:
    from tpu_gossip.fleet.engine import state_digest, stats_digest

    return {"state_digest": state_digest(fin), "stats_digest": stats_digest(stats)}


def _planes(st) -> dict:
    """Every state leaf as a nested list (the key as its uint32 words)."""
    import jax

    out = {}
    for f in dataclasses.fields(st):
        a = getattr(st, f.name)
        if f.name == "rng":
            a = jax.random.key_data(a)
        out[f.name] = np.asarray(a).astype(np.int64).tolist()
    return out


def bucketed_setup(n: int, m: int, seed: int, shards: int, grow_to: int = 0):
    """(sg, relabeled, position, exists) of a PA graph on ``shards``
    shards, padded for growth to ``grow_to`` rows when given."""
    from tpu_gossip.core import topology
    from tpu_gossip.dist import partition_graph

    g = topology.build_csr(n, topology.preferential_attachment(n, m=m, rng=np.random.default_rng(seed),
                                                               use_native=False))
    exists = None
    if grow_to:
        from tpu_gossip.growth import pad_graph_for_growth

        g, exists = pad_graph_for_growth(g, grow_to)
    sg, relabeled, position = partition_graph(g, shards, seed=0)
    return sg, relabeled, position, exists


def bucketed_run(mode: str, composed: bool, pipeline, rounds: int = 7, shards: int = 8, packed: bool = False):
    """``tests/sim/test_pipeline.py``'s bucketed cell: a 600-peer PA graph
    padded to 640 rows on ``shards`` shards, 7 rounds, serial
    (``pipeline`` None) or at a depth, with the composed scenario, growth,
    stream and control planes when ``composed``; the digests and the
    final ``pipe_buf`` occupancy."""
    from tpu_gossip.control import compile_control
    from tpu_gossip.core.packed import pack_state, unpack_state
    from tpu_gossip.core.state import SwarmConfig
    from tpu_gossip.dist import init_sharded_swarm, make_mesh, shard_swarm, simulate_dist
    from tpu_gossip.growth import compile_growth
    from tpu_gossip.sim.stages import compile_pipeline
    from tpu_gossip.traffic import compile_stream

    sg, relabeled, position, gexists = bucketed_setup(600, 3, 0, shards, grow_to=640)
    mesh = make_mesh(shards)
    extra = dict(rewire_slots=2, churn_leave_prob=0.01, churn_join_prob=0.05) if composed else {}
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=8, fanout=2, mode=mode, **extra)
    scen = gp = sp = cp = None
    if composed:
        def node_map(ids):
            return position[np.asarray(ids)]

        scen = chaos_scenario(sg.n_pad, 600, node_map=node_map)
        gp = compile_growth(n_initial=600, target=640, n_slots=sg.n_pad, joins_per_round=8, attach_m=2,
                            node_map=node_map, max_join_burst=4)
        sp = compile_stream(rate=1.5, msg_slots=8, ttl=6, origin_rows=position[np.arange(600)], k_hashes=1)
        cp = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=2, refresh_every=3)
    st = init_sharded_swarm(sg, relabeled, position, cfg, origins=[0], exists=gexists)
    st = shard_swarm(st, mesh)
    fin, stats = simulate_dist(pack_state(st) if packed else st, cfg, sg, mesh, rounds, None, scen, gp, stream=sp,
                               control=cp, pipeline=None if pipeline is None else compile_pipeline(pipeline))
    if packed:
        fin = unpack_state(fin)
    return {**_digests(fin, stats), "pipe_buf_bits": int(np.asarray(fin.pipe_buf).sum())}


def chaos_scenario(n_slots: int, n_real: int, node_map=None):
    """``tests/sim/test_pipeline.py``'s three-phase chaos scenario."""
    from tpu_gossip.faults import compile_scenario, scenario_from_dict

    return compile_scenario(scenario_from_dict(CHAOS), n_peers=n_real, n_slots=n_slots, total_rounds=10,
                            node_map=node_map)


CHAOS = {
    "name": "pipe-chaos",
    "phases": [
        {"name": "lossy", "start": 0, "end": 3, "loss": 0.2, "delay": 0.2},
        {"name": "split", "start": 3, "end": 5, "partition": "half"},
        {"name": "storm", "start": 5, "end": 7, "churn_leave": 0.05, "churn_join": 0.2,
         "blackout": {"frac": 0.1, "seed": 1}},
    ],
}


def bucketed_cell(mode: str, composed: bool) -> dict:
    """:func:`bucketed_run` serial, at depth 0 and at depth 1, and the
    depth-1 run packed."""
    return {"serial": bucketed_run(mode, composed, None), "depth0": bucketed_run(mode, composed, 0),
            "depth1": bucketed_run(mode, composed, 1), "depth1_packed": bucketed_run(mode, composed, 1, packed=True)}


def local_pipeline_run(n: int, m: int, seed: int, key: int, origins: list, mode: str, slots: int, rounds: int,
                       pipeline, stream_rate: float = 0.0, ttl: int = 6, churn: bool = False,
                       planes: bool = False, split: int = 0, tail_pipeline="same") -> dict:
    """A local-engine run of a ``use_native=False`` PA graph (seeded
    ``default_rng(seed)``), pipelined at ``pipeline`` (None: serial),
    under a stream when ``stream_rate``; with ``split`` the horizon runs
    as two ``simulate`` calls cut there, the second at ``tail_pipeline``
    (by default the first's depth). The digests, and every final plane
    with ``planes``."""
    import jax

    from tpu_gossip.core import topology
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.sim.engine import simulate
    from tpu_gossip.sim.stages import compile_pipeline
    from tpu_gossip.traffic import compile_stream

    g = topology.build_csr(n, topology.preferential_attachment(n, m=m, rng=np.random.default_rng(seed),
                                                               use_native=False))
    extra = dict(churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=3) if churn else {}
    cfg = SwarmConfig(n_peers=n, msg_slots=slots, fanout=2, mode=mode, **extra)
    st = init_swarm(g, cfg, origins=origins, key=jax.random.key(key))
    sp = compile_stream(rate=stream_rate, msg_slots=slots, ttl=ttl, origin_rows=np.arange(n)) if stream_rate else None
    pipe = None if pipeline is None else compile_pipeline(pipeline)
    tail = pipe if tail_pipeline == "same" else None if tail_pipeline is None else compile_pipeline(tail_pipeline)
    if split:
        st, _ = simulate(st, cfg, split, stream=sp, pipeline=pipe)
    fin, stats = simulate(st, cfg, rounds - split, stream=sp, pipeline=tail)
    out = {**_digests(fin, stats), "pipe_buf_bits": int(np.asarray(fin.pipe_buf).sum())}
    if planes:
        out["planes"] = _planes(fin)
    return out


def local_pipeline_coverage(n: int, m: int, seed: int, key: int, origins: list) -> dict:
    """``run_until_coverage`` to 0.99 (at most 200 rounds) of a pipelined
    push_pull run, fanout 2, 4 slots: the rounds it took and the digest."""
    import jax

    from tpu_gossip.core import topology
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.fleet.engine import state_digest
    from tpu_gossip.sim.engine import run_until_coverage
    from tpu_gossip.sim.stages import compile_pipeline

    g = topology.build_csr(n, topology.preferential_attachment(n, m=m, rng=np.random.default_rng(seed),
                                                               use_native=False))
    cfg = SwarmConfig(n_peers=n, msg_slots=4, fanout=2, mode="push_pull")
    st = init_swarm(g, cfg, origins=origins, key=jax.random.key(key))
    fin = run_until_coverage(st, cfg, 0.99, 200, pipeline=compile_pipeline(1))
    return {"rounds": int(fin.round), "state_digest": state_digest(fin)}


def resume_pipeline_npz(path: str, n: int, m: int, seed: int, rounds: int) -> dict:
    """A ``save_swarm`` file (written by either package) of a churned
    push_pull run loaded by the JAX package and run ``rounds`` more
    pipelined rounds: the digests."""
    from tpu_gossip.core.state import SwarmConfig, load_swarm
    from tpu_gossip.sim.engine import simulate
    from tpu_gossip.sim.stages import compile_pipeline

    del m, seed  # the graph rides the file
    cfg = SwarmConfig(n_peers=n, msg_slots=4, fanout=2, mode="push_pull", churn_leave_prob=0.02,
                      churn_join_prob=0.2, rewire_slots=3)
    fin, stats = simulate(load_swarm(path), cfg, rounds, pipeline=compile_pipeline(1))
    return _digests(fin, stats)


def write_v1(path: str, n: int, slots: int, origin: int) -> dict:
    """A round-1 positional (``arr_i``/``key_i``) checkpoint of a fresh
    PA swarm (``tests/unit/test_state.py::save_v1``): its seen plane."""
    import jax

    from tpu_gossip.core import topology
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tests.unit.test_state import save_v1

    g = topology.build_csr(n, topology.preferential_attachment(n, m=2, rng=np.random.default_rng(1),
                                                               use_native=False))
    st = init_swarm(g, SwarmConfig(n_peers=n, msg_slots=slots), origins=[origin], key=jax.random.key(0))
    save_v1(st, path, per_peer_sir=True)
    return {"seen": np.asarray(st.seen).tolist()}


def matching_pipeline_run(n: int, shards: int, key: int, rounds: int, pipeline) -> dict:
    """The local matching engine over ``tests/sim/test_pipeline.py``'s
    layout (``matching_powerlaw_graph_sharded`` at ``shards`` shards,
    growth rows 32) pipelined at ``pipeline``, push_pull fanout 2, origins
    0 and 5."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.sim.engine import simulate
    from tpu_gossip.sim.stages import compile_pipeline

    g, plan = matching_powerlaw_graph_sharded(n, shards, fanout=2, key=jax.random.key(0), growth_rows=32)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=2, mode="push_pull")
    st = init_swarm(g.as_padded_graph(), cfg, origins=[0, 5], exists=g.exists, key=jax.random.key(key))
    fin, stats = simulate(st, cfg, rounds, plan, pipeline=None if pipeline is None else compile_pipeline(pipeline))
    return {**_digests(fin, stats), "pipe_buf_bits": int(np.asarray(fin.pipe_buf).sum())}


def _ici_words(tot) -> dict:
    """An ``IciTotals`` or a stacked ``IciRound`` as exact python ints."""
    if hasattr(tot, "words"):
        return tot.words()
    return {f: int(np.asarray(getattr(tot, f)).astype(np.int64).sum()) for f in tot._fields}


def dist_matching_1m(n: int = 1_000_000, shards: int = 8) -> dict:
    """``bench.py::bench_dist_matching``'s configuration on an ``shards``
    mesh: ``matching_powerlaw_graph_sharded(n, shards, gamma=2.5,
    fanout=1, key(0), export_csr=False)``, push_pull, 16 slots, origins
    ``arange(16)`` on slots ``arange(16)``, to 0.99 coverage (at most 300
    rounds). The dense run's digest, rounds and ICI totals; the sparse
    transport replayed over those rounds with the counter (digests and
    totals); the auto transport's static gate and totals; the hier leg
    (:func:`dist_matching_1m_hier`)."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.core.state import SwarmConfig, clone_state, init_swarm
    from tpu_gossip.dist import (build_transport, make_mesh, run_until_coverage_dist, shard_matching_plan,
                                 shard_swarm, simulate_dist)
    from tpu_gossip.fleet.engine import state_digest

    g, plan = matching_powerlaw_graph_sharded(n, shards, gamma=2.5, fanout=1, key=jax.random.key(0),
                                              export_csr=False)
    mesh = make_mesh(shards)
    plan_m = shard_matching_plan(plan, mesh)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull")
    st = shard_swarm(init_swarm(g.as_padded_graph(), cfg, origins=np.arange(16), origin_slots=np.arange(16),
                                exists=g.exists, key=jax.random.key(0)), mesh)
    fin, tot = run_until_coverage_dist(clone_state(st), cfg, plan_m, mesh, 0.99, 300, collect_ici=True)
    rounds = int(fin.round)
    out = {"rows": plan.rows, "per_rows": plan.per_rows, "n_state": plan.n,
           "dense": {"state_digest": state_digest(fin), "rounds": rounds, "ici": _ici_words(tot),
                     "coverage": float(fin.coverage(0))}}
    sparse = build_transport(plan_m, mode="sparse", mesh=mesh)
    sfin, (stats, ici) = simulate_dist(clone_state(st), cfg, plan_m, mesh, rounds, None, None, None, sparse, True)
    out["sparse"] = {**_digests(sfin, stats), "ici": _ici_words(ici), "stage_mode": list(sparse.stage_mode),
                     "budget": sparse.budget}
    auto = build_transport(plan_m, mode="auto", mesh=mesh)
    afin, atot = run_until_coverage_dist(clone_state(st), cfg, plan_m, mesh, 0.99, 300, transport=auto,
                                         collect_ici=True)
    out["auto"] = {"active": bool(auto.active), "state_digest": state_digest(afin), "ici": _ici_words(atot)}
    out["hier"] = dist_matching_1m_hier(n, shards)
    return out


def dist_matching_1m_hier(n: int = 1_000_000, shards: int = 8, hosts: int = 2) -> dict:
    """:func:`dist_matching_1m`'s ``hier`` leg: the same layout and swarm
    on the (``hosts``, ``shards / hosts``) fold of the forced host devices
    (``make_cluster_mesh(hosts=)``, the JAX CLI's ``--hosts 2``) under
    ``build_transport(plan, "hier", hosts=)``, run to 0.99 coverage: the
    digest, the rounds and the ICI totals with their DCN columns."""
    import jax

    from tpu_gossip.cluster import make_cluster_mesh
    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.dist import build_transport, run_until_coverage_dist, shard_matching_plan, shard_swarm
    from tpu_gossip.fleet.engine import state_digest

    g, plan = matching_powerlaw_graph_sharded(n, shards, gamma=2.5, fanout=1, key=jax.random.key(0),
                                              export_csr=False)
    mesh = make_cluster_mesh(shards, hosts=hosts)
    plan_m = shard_matching_plan(plan, mesh)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull")
    st = shard_swarm(init_swarm(g.as_padded_graph(), cfg, origins=np.arange(16), origin_slots=np.arange(16),
                                exists=g.exists, key=jax.random.key(0)), mesh)
    tr = build_transport(plan_m, mode="hier", hosts=hosts)
    fin, tot = run_until_coverage_dist(st, cfg, plan_m, mesh, 0.99, 300, transport=tr, collect_ici=True)
    return {"hosts": hosts, "state_digest": state_digest(fin), "rounds": int(fin.round), "ici": _ici_words(tot),
            "dcn_budget": tr.dcn_budget, "coverage": float(fin.coverage(0))}


def field_digest(a) -> str:
    """sha256 of an integer or bool plane's values (as int64) and shape."""
    a = np.asarray(a)
    return leaf_digest((a.astype(np.int64), np.asarray(a.shape)))


def stream_matching_case(mode: str, law: str, compose) -> dict:
    """The JAX half of ``tests/test_torch_stream_matching.py``'s cell
    (``jax_matching_stream`` there), each stream state plane as its
    :func:`field_digest`."""
    from tests.test_torch_stream_matching import jax_matching_stream

    out = jax_matching_stream(mode, law, compose)
    return {**out, "fields": {f: field_digest(v) for f, v in out["fields"].items()}}


def growth_runs_case(name: str) -> dict:
    """The JAX half of ``tests/test_torch_growth_runs.py``'s growing run
    ``name`` (``jax_grown_run`` there)."""
    from tests.test_torch_growth_runs import jax_grown_run

    return jax_grown_run(name)


def stream_runs_case(name: str) -> dict:
    """The JAX half of ``tests/test_torch_stream_runs.py``'s run ``name``
    (``jax_stream_run`` there)."""
    from tests.test_torch_stream_runs import jax_stream_run

    return jax_stream_run(name)


# tests/test_torch_packed.py's codec slot counts
CODEC_MS = [1, 8, 13, 16, 17]


def codec_bools(m: int) -> np.ndarray:
    """The codec test's (57, m) bool plane, from numpy's seed ``m``."""
    return np.random.default_rng(m).random((57, m)) < 0.4


def codec_case(m: int) -> dict:
    """The JAX half of ``tests/test_torch_packed.py::test_codec_equals_jax``
    at ``m`` slots: each codec output on :func:`codec_bools` as its dtype
    and values (:func:`_leaf`)."""
    import jax.numpy as jnp

    from tpu_gossip.core import packed as jpk

    x = codec_bools(m)
    words = jpk.pack_bits(jnp.asarray(x))
    w32 = jpk.words8_to_words32(words)
    ones = np.full((3, 7), 0xFF, np.uint8)
    out = {"pack_bits": _leaf(words), "unpack_bits": _leaf(jpk.unpack_bits(words, m)),
           "word_mask": _leaf(jpk.word_mask(m)), "packed_width": jpk.packed_width(m),
           "words8_to_words32": _leaf(w32), "words32_to_words8": _leaf(jpk.words32_to_words8(w32, words.shape[-1])),
           "words8_to_words32_ones": _leaf(jpk.words8_to_words32(jnp.asarray(ones))),
           "np_pack_bits": _leaf(jpk.np_pack_bits(x)),
           "np_unpack_bits": _leaf(jpk.np_unpack_bits(np.asarray(words), m))}
    out.update({f"bit_column_{slot}": _leaf(jpk.bit_column(words, slot)) for slot in sorted({0, m // 2, m - 1})})
    return out


def fold_classes_case(case: str, op: str) -> str:
    """The JAX half of ``tests/test_torch_fold_classes.py``'s
    ``test_reduce_classes_equals_jax`` (``jax_fold_case`` there)."""
    from tests.test_torch_fold_classes import jax_fold_case

    return jax_fold_case(case, op)


# its cases: crafted class tables (kernels/fold_cases.py) and two plans' classes
FOLD_CLASSES_CASES = ["mixed", "gaps", "node_major", "plan2000", "plan20000"]


# tests/test_torch_stream_matching.py's cells: name -> (mode, origin law, composed plane)
STREAM_MATCHING = {"push_pull": ("push_pull", "uniform", None), "flood_hotspot": ("flood", "hotspot", None),
                   "chaos_scenario": ("push_pull", "uniform", "scenario"),
                   "flash_crowd": ("push_pull", "uniform", "growth")}


# tests/sim/test_cluster.py's swarms (tests/test_torch_cluster.py)
N_BUCKETED, N_MATCHING = 250, 256


def cluster_bucketed_graph():
    """The cluster cells' bucketed graph: JAX's numpy PA generator at
    N_BUCKETED, m 3, and its CSR (host arrays both packages build from)."""
    from tpu_gossip.core import topology

    return topology.preferential_attachment(N_BUCKETED, m=3, use_native=False)


def cluster_bucketed(hosts: int, transport: str) -> dict:
    """tests/sim/test_cluster.py's bucketed cell: 8 shards (partition seed
    1), push_pull fanout 2, 8 slots, churn (0.02, 0.2), origin 0, 6 rounds
    on the (``hosts``, 8 / hosts) fold (1: the flat mesh) under
    ``transport`` (dense: None): the digests and the ICI totals."""
    from tpu_gossip import SwarmConfig, build_csr
    from tpu_gossip.cluster import make_cluster_mesh
    from tpu_gossip.dist import build_transport, init_sharded_swarm, partition_graph, shard_swarm, simulate_dist

    g = build_csr(N_BUCKETED, cluster_bucketed_graph())
    sg, relabeled, position = partition_graph(g, 8, seed=1)
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=8, fanout=2, mode="push_pull", churn_leave_prob=0.02,
                      churn_join_prob=0.2)
    st = init_sharded_swarm(sg, relabeled, position, cfg, origins=[0])
    mesh = make_cluster_mesh(8, hosts=hosts)
    tp = None if transport == "dense" else build_transport(sg, mode=transport, hosts=hosts)
    fin, (stats, ici) = simulate_dist(shard_swarm(st, mesh), cfg, sg, mesh, 6, transport=tp, collect_ici=True)
    return {**_digests(fin, stats), "ici": _ici_words(ici)}


def _cluster_matching_swarm():
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.core.state import SwarmConfig, init_swarm

    dg, plan = matching_powerlaw_graph_sharded(N_MATCHING, 8, gamma=2.5, fanout=1, key=jax.random.key(0),
                                               export_csr=False)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull")
    st = init_swarm(dg.as_padded_graph(), cfg, origins=[0], exists=dg.exists, key=jax.random.key(0))
    return plan, cfg, st


def cluster_matching(rounds: int, hosts: int, packed: bool = False) -> dict:
    """tests/sim/test_cluster.py's matching cell: 8 shards at N_MATCHING,
    push_pull fanout 1, 16 slots, origin 0, ``rounds`` rounds on the
    (``hosts``, 8 / hosts) fold under the hier transport (``hosts`` 0: the
    local engine, no counters); ``packed`` carries the packed state."""
    from tpu_gossip.cluster import make_cluster_mesh
    from tpu_gossip.core.packed import pack_state, unpack_state
    from tpu_gossip.dist import build_transport, shard_matching_plan, shard_swarm, simulate_dist
    from tpu_gossip.sim.engine import simulate

    plan, cfg, st = _cluster_matching_swarm()
    if not hosts:
        return _digests(*simulate(st, cfg, rounds, plan))
    mesh = make_cluster_mesh(8, hosts=hosts)
    splan = shard_matching_plan(plan, mesh)
    tp = build_transport(plan, mode="hier", hosts=hosts)
    sharded = shard_swarm(st, mesh)
    fin, (stats, ici) = simulate_dist(pack_state(sharded) if packed else sharded, cfg, splan, mesh, rounds,
                                      transport=tp, collect_ici=True)
    return {**_digests(unpack_state(fin) if packed else fin, stats), "ici": _ici_words(ici)}


def cluster_composed() -> dict:
    """tests/sim/test_cluster.py's composed cell on the local engine: the
    audit's chaos scenario, stream (k 2, bursty) and control plan (ttl 8),
    6 rounds."""
    from tpu_gossip.analysis.entrypoints import _chaos_scenario, _control_plan, _stream_plan
    from tpu_gossip.sim.engine import simulate

    plan, cfg, st = _cluster_matching_swarm()
    kw = dict(scenario=_chaos_scenario(plan.n, N_MATCHING), stream=_stream_plan(16, np.asarray(st.exists)),
              control=_control_plan(ttl=8))
    return _digests(*simulate(st, cfg, 6, plan, **kw))


def cli_cluster(shards: int, *argv: str) -> dict:
    """:func:`cli_mesh` with the cluster mesh pinned to ``shards`` devices
    too (``--hosts H`` folds those)."""
    import tpu_gossip.cluster as cl

    make = cl.make_cluster_mesh
    cl.make_cluster_mesh = lambda n_devices=None, hosts=1: make(int(shards), hosts)
    try:
        return cli_mesh(shards, *argv)
    finally:
        cl.make_cluster_mesh = make


CLUSTER_M = ["--peers", "2000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1", "--seed",
             "4", "--quiet", "--digest"]
CLUSTER_B = ["--peers", "1200", "--graph", "chung-lu", "--shard", "--mode", "push_pull", "--fanout", "2",
             "--slots", "8", "--quiet", "--digest"]
# the runs tests/test_torch_cluster_procs.py launches as two gloo ranks,
# each held to the JAX CLI's one-process run on the same fold: name ->
# (mesh size, argv)
CLUSTER_CLI = {
    "acceptance_hier": (8, ["--peers", "2000", "--graph", "matching", "--shard", "--transport", "hier", "--rounds",
                            "12", "--digest", "--quiet", "--hosts", "2"]),
    "matching_dense": (4, [*CLUSTER_M, "--rounds", "10", "--hosts", "2"]),
    "matching_hier": (4, [*CLUSTER_M, "--rounds", "10", "--hosts", "2", "--transport", "hier"]),
    "matching_target": (4, [*CLUSTER_M[:-1], "--hosts", "2", "--transport", "hier", "--target", "0.95",
                            "--max-rounds", "60"]),
    "matching_sparse": (4, [*CLUSTER_M, "--rounds", "10", "--hosts", "2", "--transport", "sparse"]),
    "matching_auto": (4, [*CLUSTER_M, "--rounds", "10", "--hosts", "2", "--transport", "auto"]),
    "bucketed_k6": (2, [*CLUSTER_B, "--rounds", "10", "--hosts", "2", "--staircase"]),
    "bucketed_scatter": (2, [*CLUSTER_B, "--rounds", "10", "--hosts", "2", "--transport", "sparse"]),
    "ckpt_hier": (8, [*CLUSTER_M, "--rounds", "12", "--hosts", "2", "--transport", "hier", "--mode", "flood"]),
    # tests/test_torch_shard_cli.py's --hosts case: the one-process fold of a 2-shard mesh
    "fold_chung_lu": (2, ["--peers", "100", "--rounds", "2", "--graph", "chung-lu", "--shard", "--hosts", "2"]),
}

PLANES_CHURN = ["--churn-leave", "0.002", "--churn-join", "0.02", "--rewire-slots", "2"]
PLANES_SIEGE = ["--scenario", "scenarios/byzantine_siege.toml", "--quorum-k", "3"]
# growth under the flash crowd's join bursts with a stream; a degraded
# scenario with a stream, churn joins and the controller
PLANES_GROW_FLASH = ["--grow", "3000", "--grow-rate", "16", "--rewire-slots", "2", "--stream", "3", "--slot-ttl", "24",
                     "--scenario", "scenarios/flash_crowd_under_fire.toml"]
PLANES_CONTROL_DEGRADED = ["--stream", "2", "--slot-ttl", "24", "--rewire-slots", "4", "--churn-join", "0.02",
                           "--control", "0.85", "--refresh-every", "5", "--scenario",
                           "scenarios/degraded_under_control.toml"]
# the row planes' runs tests/test_torch_cluster_planes*.py launch as two
# gloo ranks (ROADMAP item 11d part 1), each held to the JAX CLI's
# one-process run on the same (2, 2) fold: name -> (mesh size, argv); a
# packed run lands on its unpacked twin's pin
CLUSTER_PLANES = {
    "composed": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "56", *PLANES_CHURN, *PLANES_SIEGE]),
    "compact": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "24", *PLANES_CHURN, "--rewire-compact-cap", "64",
                    "--scenario", "scenarios/churn_storm.toml"]),
    "split_brain": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "32", "--transport", "sparse", "--scenario",
                        "scenarios/split_brain.toml"]),
    "silent": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "24", "--transport", "auto", "--silent-frac", "0.05",
                   "--quorum-k", "3"]),
    "hier": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "24", "--transport", "hier", *PLANES_CHURN, "--scenario",
                 "scenarios/lossy_links.toml", "--quorum-k", "3"]),
    "bucketed": (4, [*CLUSTER_B, "--seed", "4", "--hosts", "2", "--rounds", "56", "--staircase", *PLANES_CHURN,
                     *PLANES_SIEGE]),
    # growth, streams and adaptive control (ROADMAP item 11d parts 2-3)
    "grow_flash": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "30", *PLANES_GROW_FLASH]),
    "control_degraded": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "30", *PLANES_CONTROL_DEGRADED]),
    "control_hier_hotspot": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "30", *PLANES_CONTROL_DEGRADED,
                                 "--transport", "hier", "--stream-origins", "hotspot"]),
    "degree_k2": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "24", "--grow", "2600", "--grow-rate", "24",
                      "--rewire-slots", "2", "--stream", "4", "--slot-ttl", "24", "--stream-origins", "degree",
                      "--stream-hashes", "2", "--transport", "sparse"]),
    "bucketed_grow": (4, [*CLUSTER_B, "--staircase", "--seed", "4", "--hosts", "2", "--rounds", "30", "--grow",
                          "1500", "--grow-rate", "8", *PLANES_CONTROL_DEGRADED]),
    # pipelined rounds and the distributed builder (ROADMAP item 11d parts 4-5)
    "pipe_dense": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "16", "--pipeline", "1"]),
    "pipe_hier_churn": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "24", "--pipeline", "1", "--transport", "hier",
                            *PLANES_CHURN, "--scenario", "scenarios/lossy_links.toml", "--quorum-k", "3"]),
    "pipe_bucketed": (4, [*CLUSTER_B, "--staircase", "--seed", "4", "--hosts", "2", "--rounds", "16", "--pipeline",
                          "1", *PLANES_CHURN]),
    "dist_dense": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "10", "--builder", "dist"]),
    "dist_sparse_pipe": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "16", "--builder", "dist", "--transport",
                             "sparse", "--pipeline", "1"]),
    "dist_control_pipe": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "30", "--pipeline", "1", "--builder", "dist",
                              *PLANES_CONTROL_DEGRADED]),
    "dist_grow": (4, [*CLUSTER_M, "--hosts", "2", "--rounds", "30", "--builder", "dist", *PLANES_GROW_FLASH]),
}
# the witnesses of item 11d parts 4-5 (tests/test_torch_cluster_pipe_build.py)
CLUSTER_PIPE_BUILD = ("pipe_dense", "pipe_hier_churn", "pipe_bucketed", "dist_dense", "dist_sparse_pipe",
                      "dist_control_pipe", "dist_grow")
# chip_smoke.py phase 17e's full-width pins: the composed matching run at
# 1M (no --seed) and its bucketed twin at n=20000, on an 8-shard (2, 4) fold
PLANES_1M = ["--peers", "1000000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1",
             "--hosts", "2", "--rounds", "56", *PLANES_CHURN, *PLANES_SIEGE, "--digest", "--quiet"]
PLANES_BUCKETED_20K = ["--peers", "20000", "--graph", "chung-lu", "--shard", "--mode", "push_pull", "--fanout", "2",
                       "--slots", "8", "--staircase", "--hosts", "2", "--rounds", "56", *PLANES_CHURN, *PLANES_SIEGE,
                       "--digest", "--quiet"]


# ROADMAP §3's serve under --coordinator: JAX's serve ignores the three
# cluster flags (no arrivals: the windows are empty)
SERVE_COORDINATOR = ["--peers", "500", "--rounds", "4", "--slot-ttl", "16", "--port", "0", "--coordinator",
                     "127.0.0.1:29517", "--num-processes", "2", "--process-id", "0"]
# chip_smoke.py phase 17f's pins (ROADMAP item 11d parts 2-3): growth with
# the flash crowd's join bursts, a stream and the controller on the 1M
# matching mesh (no --seed), the same argv at n=20000 (the card runs it
# --packed), and the bucketed twin at n=20000; an 8-shard (2, 4) fold
PLANES_GROW_CONTROL = ["--rewire-slots", "2", "--stream", "2", "--slot-ttl", "32", "--control", "0.9",
                       "--refresh-every", "4", "--scenario", "scenarios/flash_crowd_under_fire.toml"]
PLANES_GROW_1M = ["--peers", "1000000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1",
                  "--hosts", "2", "--rounds", "40", "--grow", "1000640", "--grow-rate", "16", *PLANES_GROW_CONTROL,
                  "--digest", "--quiet"]
PLANES_GROW_20K = ["--peers", "20000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1",
                   "--hosts", "2", "--rounds", "40", "--grow", "20640", "--grow-rate", "16", *PLANES_GROW_CONTROL,
                   "--digest", "--quiet"]
PLANES_GROW_BUCKETED_20K = ["--peers", "20000", "--graph", "chung-lu", "--shard", "--mode", "push_pull", "--fanout",
                            "2", "--slots", "8", "--staircase", "--hosts", "2", "--rounds", "40", "--grow", "20640",
                            "--grow-rate", "16", *PLANES_GROW_CONTROL, "--digest", "--quiet"]


# chip_smoke.py phase 17g's pins (ROADMAP item 11d parts 4-5): the 1M
# matching mesh built by the distributed builder, pipelined on the sparse
# transport (no --seed); n=20000 grown under control, built by the
# distributed builder, pipelined on the hier transport (the card runs it
# --packed); and the bucketed twin pipelined under churn; an 8-shard (2, 4) fold
PIPE_BUILD_1M = ["--peers", "1000000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1",
                 "--hosts", "2", "--builder", "dist", "--pipeline", "1", "--transport", "sparse", "--rounds", "32",
                 "--digest", "--quiet"]
PIPE_BUILD_20K = ["--peers", "20000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1",
                  "--hosts", "2", "--builder", "dist", "--pipeline", "1", "--transport", "hier", "--rounds", "40",
                  "--grow", "20640", "--grow-rate", "16", *PLANES_GROW_CONTROL, "--digest", "--quiet"]
PIPE_BUCKETED_20K = ["--peers", "20000", "--graph", "chung-lu", "--shard", "--mode", "push_pull", "--fanout", "2",
                     "--slots", "8", "--staircase", "--hosts", "2", "--pipeline", "1", "--rounds", "40", *PLANES_CHURN,
                     "--digest", "--quiet"]


def cli_cluster_pin(shards: int, *argv: str) -> dict:
    """A pin entry of ``reference_pins.json``: the JAX CLI's one-process
    fold of ``argv`` on ``shards`` forced host devices and its summary,
    timing fields left out."""
    import time

    t0 = time.perf_counter()
    summary = cli_cluster(int(shards), *argv)
    return {"source": f"python -m tpu_gossip.cli.run_sim {' '.join(argv)} (JAX package, CPU, the one-process fold "
                      f"of a {shards}-device mesh of forced host devices)", "shards": int(shards),
            "argv": list(argv), "seconds": round(time.perf_counter() - t0, 1), "summary": summary}


def cluster_planes_pins() -> dict:
    """Phase 17e's two new pins (:data:`PLANES_1M`, about 80 s, and
    :data:`PLANES_BUCKETED_20K`), keyed as ``reference_pins.json`` holds
    them."""
    return {"cluster_planes_1m": cli_cluster_pin(8, *PLANES_1M),
            "cluster_planes_bucketed": cli_cluster_pin(8, *PLANES_BUCKETED_20K)}


def cluster_grow_pins(names: str = "") -> dict:
    """Phase 17f's three pins (:data:`PLANES_GROW_1M`, about 100 s, the
    n=20000 matching run and :data:`PLANES_GROW_BUCKETED_20K`), keyed as
    ``reference_pins.json`` holds them; ``names`` (comma-separated) picks
    some."""
    runs = {"cluster_planes_grow_1m": PLANES_GROW_1M, "cluster_planes_grow_20k": PLANES_GROW_20K,
            "cluster_planes_grow_bucketed": PLANES_GROW_BUCKETED_20K}
    pick = [n for n in names.split(",") if n] or list(runs)
    return {name: cli_cluster_pin(8, *runs[name]) for name in pick}


def cluster_pipe_build_pins(names: str = "") -> dict:
    """Phase 17g's three pins (:data:`PIPE_BUILD_1M`, several minutes,
    :data:`PIPE_BUILD_20K` and :data:`PIPE_BUCKETED_20K`), keyed as
    ``reference_pins.json`` holds them; ``names`` (comma-separated) picks
    some."""
    runs = {"cluster_dist_pipe_1m": PIPE_BUILD_1M, "cluster_dist_pipe_20k": PIPE_BUILD_20K,
            "cluster_pipe_bucketed": PIPE_BUCKETED_20K}
    pick = [n for n in names.split(",") if n] or list(runs)
    return {name: cli_cluster_pin(8, *runs[name]) for name in pick}


def matching_pipeline_1m(n: int = 1_000_000, shards: int = 1, rounds: int = 24, pipeline=1) -> dict:
    """``bench.py::bench_pipeline``'s configuration: the sharded matching
    mesh (``matching_powerlaw_graph_sharded(n, shards, gamma=2.5,
    fanout=1, key(0), export_csr=False)``), push_pull, 16 slots, origins
    ``arange(16)`` on slots ``arange(16)``, a ``rounds``-round horizon at
    ``pipeline`` (None: serial); the digests, rounds to 99% and final
    coverage."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.dist import make_mesh, shard_matching_plan, shard_swarm, simulate_dist
    from tpu_gossip.sim import metrics as M
    from tpu_gossip.sim.stages import compile_pipeline

    g, plan = matching_powerlaw_graph_sharded(n, shards, gamma=2.5, fanout=1, key=jax.random.key(0),
                                              export_csr=False)
    mesh = make_mesh(shards)
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=16, fanout=1, mode="push_pull")
    st = shard_swarm(init_swarm(g.as_padded_graph(), cfg, origins=np.arange(16), origin_slots=np.arange(16),
                                exists=g.exists, key=jax.random.key(0)), mesh)
    fin, stats = simulate_dist(st, cfg, shard_matching_plan(plan, mesh), mesh, rounds,
                               pipeline=None if pipeline is None else compile_pipeline(pipeline))
    return {**_digests(fin, stats), "rounds_to_target": M.rounds_to_coverage(stats, 0.99),
            "final_coverage": float(np.asarray(stats.coverage)[-1])}


SIEGE_SMALL = {
    "name": "siege-small",
    "phases": [{"name": "adv", "start": 0, "end": 6, "accusers": {"frac": 0.06, "seed": 3},
                "forgers": {"frac": 0.04, "seed": 4}, "floods": {"frac": 0.05, "seed": 5},
                "blackout": {"frac": 0.1, "seed": 2}}],
}


def matching_mesh_run(n: int, shards: int, mode: str = "push_pull", rounds: int = 8, transport: str = "dense",
                      packed: bool = False, plane: str = "", pipeline=None, builder: str = "local",
                      ici: bool = False) -> dict:
    """A run of the sharded matching mesh at ``shards`` shards over
    ``matching_powerlaw_graph_sharded(n, shards, fanout=2, key(1))``
    (``growth_rows`` 16 under the growth plane, ``block_keys`` with
    ``builder="dist"``, which builds it with ``matching_powerlaw_graph_dist``),
    8 slots, origins 0 and 5 mapped to rows, the state key 3, ``rounds``
    rounds through ``simulate_dist`` under ``transport`` (dense: None) and
    at most one ``plane``: churn, scenario (the pipelined-round chaos
    scenario), quorum (a short siege at quorum 3), growth, stream or
    control; the digests and, with ``ici``, the counters' totals."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.core.packed import pack_state, unpack_state
    from tpu_gossip.core.state import SwarmConfig, init_swarm, shard_ranges
    from tpu_gossip.dist import (build_transport, make_mesh, matching_powerlaw_graph_dist, shard_matching_plan,
                                 shard_swarm, simulate_dist)
    from tpu_gossip.sim.stages import compile_pipeline

    mesh = make_mesh(shards)
    fanout = None if mode == "flood" else 2
    grow_rows = 16 if plane == "growth" else 0
    if builder == "dist":
        g, plan = matching_powerlaw_graph_dist(n, mesh, fanout=fanout, key=jax.random.key(1), growth_rows=grow_rows)
    else:
        g, plan = matching_powerlaw_graph_sharded(n, shards, fanout=fanout, key=jax.random.key(1),
                                                  growth_rows=grow_rows)
    plan = shard_matching_plan(plan, mesh)
    churn = dict(churn_leave_prob=0.02, churn_join_prob=0.2, rewire_slots=2) if plane == "churn" else {}
    if plane == "growth":
        churn = dict(rewire_slots=2)  # growth edges ride the re-wiring plane
    cfg = SwarmConfig(n_peers=plan.n, msg_slots=8, fanout=2, mode=mode, **churn)

    def to_rows(ids):
        ids = np.asarray(ids)
        return (ids // plan.n_per) * plan.n_blk + (ids % plan.n_per)

    st = shard_swarm(init_swarm(g.as_padded_graph(), cfg, origins=to_rows([0, 5]), exists=g.exists,
                                key=jax.random.key(3)), mesh)
    kw = {}
    if plane in ("scenario", "quorum"):
        from tpu_gossip.faults import compile_scenario, scenario_from_dict

        kw["scenario"] = compile_scenario(scenario_from_dict(CHAOS if plane == "scenario" else SIEGE_SMALL),
                                          n_peers=plan.n_per * shards, n_slots=plan.n, total_rounds=rounds,
                                          node_map=to_rows, shard_ranges=shard_ranges(shards, plan.n_blk),
                                          n_shards=shards)
    if plane == "quorum":
        from tpu_gossip.kernels.liveness import compile_quorum

        kw["liveness"] = compile_quorum(3, 4, 2)
    if plane == "growth":
        from tpu_gossip.growth import compile_growth, matching_admit_rows

        joins = 8 * shards
        kw["growth"] = compile_growth(n_initial=plan.n_per * shards, target=plan.n_per * shards + joins,
                                      n_slots=plan.n, joins_per_round=4, attach_m=2,
                                      admit_rows=matching_admit_rows(plan, joins))
    if plane == "stream":
        from tpu_gossip.traffic import compile_stream

        kw["stream"] = compile_stream(rate=1.5, msg_slots=8, ttl=6, origin_rows=to_rows(np.arange(plan.n_per * shards)),
                                      k_hashes=1)
    if plane == "control":
        from tpu_gossip.control import compile_control

        kw["control"] = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=4)
    if pipeline is not None:
        kw["pipeline"] = compile_pipeline(pipeline)
    tr = None if transport == "dense" else build_transport(plan, mode=transport, mesh=mesh)
    if tr is not None:
        kw["transport"] = tr
    out = simulate_dist(pack_state(st) if packed else st, cfg, plan, mesh, rounds, collect_ici=ici, **kw)
    fin, stats = out if not ici else (out[0], out[1][0])
    res = _digests(unpack_state(fin) if packed else fin, stats)
    if ici:
        res["ici"] = _ici_words(out[1][1])
    return res


def mesh_transport_tables(n: int, shards: int, mode: str = "sparse", hub_rows_frac: float = 1 / 32) -> dict:
    """``build_transport`` of ``matching_powerlaw_graph_sharded(n, shards,
    fanout=2, key(1))``'s plan, computed without a mesh: the static fields,
    the leaf slots' count and each hub table."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.dist import build_transport

    _, plan = matching_powerlaw_graph_sharded(n, shards, fanout=2, key=jax.random.key(1))
    tr = build_transport(plan, mode=mode, hub_rows_frac=hub_rows_frac)
    return {"active": tr.active, "budget": tr.budget, "stage_mode": list(tr.stage_mode),
            "hub_degree_min": tr.hub_degree_min, "leaf": int(np.asarray(tr.leaf_slots).sum()),
            "hub_tables": [np.asarray(t).tolist() for t in tr.hub_tables]}


def _leaf(a):
    """A JAX leaf (or a tuple of them) as ``{"dtype", "data"}`` JSON."""
    if isinstance(a, tuple):
        return [_leaf(x) for x in a]
    a = np.asarray(a)
    return {"dtype": str(a.dtype), "data": a.tolist()}


def leaf_digest(a) -> str:
    """sha256 of one leaf's dtype name and bytes (a tuple: of each)."""
    import hashlib

    if isinstance(a, (tuple, list)):
        return hashlib.sha256("".join(leaf_digest(x) for x in a).encode()).hexdigest()
    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha256(str(a.dtype).encode() + a.tobytes()).hexdigest()


def sharded_plan_digests(n: int, shards: int, fanout: int, key: int, block_keys: bool = False,
                         export_csr: bool = True, growth_rows: int = 0) -> dict:
    """:func:`sharded_plan_leaves` as a digest a leaf (:func:`leaf_digest`)."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded

    g, plan = matching_powerlaw_graph_sharded(n, shards, fanout=fanout, key=jax.random.key(key),
                                              block_keys=block_keys, export_csr=export_csr, growth_rows=growth_rows)
    return {**{k: leaf_digest(getattr(plan, k)) for k in ("lanes", "m3", "lanes_inv", "valid", "deg_other",
                                                          "deg_real")},
            **{k: leaf_digest(getattr(g, k)) for k in ("row_ptr", "col_idx", "exists")}}


def sharded_plan_leaves(n: int, shards: int, fanout: int, key: int, block_keys: bool = False,
                        export_csr: bool = True, growth_rows: int = 0) -> dict:
    """``matching_powerlaw_graph_sharded``'s plan leaves, static fields and
    graph arrays (no mesh)."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded

    g, plan = matching_powerlaw_graph_sharded(n, shards, fanout=fanout, key=jax.random.key(key),
                                              block_keys=block_keys, export_csr=export_csr, growth_rows=growth_rows)
    names = ("lanes", "m3", "lanes_inv", "valid", "deg_other", "deg_real")
    static = {k: getattr(plan, k) for k in ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk",
                                           "per_rows", "local_classes")}
    return {"plan": {k: _leaf(getattr(plan, k)) for k in names}, "static": static,
            "graph": {k: _leaf(getattr(g, k)) for k in ("row_ptr", "col_idx", "exists")}}


def transport_tables(n: int, shards: int, mode: str, hub_rows_frac: float) -> dict:
    """``build_transport`` of ``matching_powerlaw_graph_sharded(n, shards,
    fanout=2, key(1))``'s plan (no mesh): every field and table."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.dist import build_transport

    _, plan = matching_powerlaw_graph_sharded(n, shards, fanout=2, key=jax.random.key(1))
    tr = build_transport(plan, mode=mode, hub_rows_frac=hub_rows_frac)
    out = {f: getattr(tr, f) for f in ("engine", "mode", "active", "budget", "hub_degree_min", "n_shards",
                                       "fingerprint")}
    out["stage_mode"] = list(tr.stage_mode)
    out["leaf_slots"] = leaf_digest(tr.leaf_slots)
    out["hub_tables"] = [np.asarray(t).tolist() for t in tr.hub_tables]
    return out


def ici_counter_cases(n: int, shards: int, m: int) -> dict:
    """JAX's ``ici_round_matching`` (dense and sparse, with and without an
    answer plane, three densities) on ``matching_powerlaw_graph_sharded(n,
    shards, fanout=2, key(1))``'s plan and ``ici_round_bucketed`` (merged and
    split, dense and sparse, two densities) on :func:`bucketed_setup`'s
    partition, the planes drawn from ``default_rng(shards + m)`` in the
    order ``tests/test_torch_mesh.py`` draws them; and the plan's dense wire
    declarations."""
    import jax
    import jax.numpy as jnp

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph_sharded
    from tpu_gossip.dist import build_transport
    from tpu_gossip.dist import matching_mesh as jmm
    from tpu_gossip.dist import transport as jt

    def words(ici):
        return {f: int(np.asarray(getattr(ici, f))) for f in ici._fields}

    _, plan = matching_powerlaw_graph_sharded(n, shards, fanout=2, key=jax.random.key(1))
    rng = np.random.default_rng(shards + m)
    tr = build_transport(plan, "sparse")
    matching = jax.jit(jt.ici_round_matching, static_argnums=(2,))
    out = {"matching": [], "bucketed": []}
    for density in (0.0005, 0.01, 0.5):
        tx = rng.random((plan.n, m)) < density
        ans = rng.random((plan.n, m)) < density
        for trans in (None, tr):
            for a in (None, ans):
                out["matching"].append(words(matching(plan, trans, m, jnp.asarray(tx),
                                                      None if a is None else jnp.asarray(a))))
    sg = bucketed_setup(600, 3, 0, shards)[0]
    btr = build_transport(sg, "sparse")
    for density in (0.002, 0.3):
        tx_any, ans_any = rng.random(sg.n_pad) < density, rng.random(sg.n_pad) < density
        for merged, a in ((True, None), (False, ans_any)):
            for trans in (None, btr):
                out["bucketed"].append(words(jt.ici_round_bucketed(sg, trans, 2, jnp.asarray(tx_any),
                                                                   None if a is None else jnp.asarray(a), merged)))
    out["wire"] = [jmm.dense_wire_words(plan, 16, mode, fo, bp) for mode in ("push", "push_pull", "flood")
                   for fo in (False, True) for bp in (False, True)]
    return out


def ici_totals_fold(rounds: list) -> dict:
    """``IciTotals.words()`` of ``accumulate_ici`` folding ``rounds`` (each
    an ``IciRound``'s seven int32 values) into ``zero_ici_totals()``."""
    import jax.numpy as jnp

    from tpu_gossip.dist import transport as jt

    tot = jt.zero_ici_totals()
    for r in rounds:
        tot = jt.accumulate_ici(tot, jt.IciRound(*(jnp.int32(v) for v in r)))
    return tot.words()


def cli_mesh(shards: int, *argv: str) -> dict:
    """The JAX CLI's summary line for ``argv`` on a ``shards``-device mesh
    (``make_mesh`` pinned to that many of the forced host devices), timing
    fields left out; a refused run's exit code and last stderr line."""
    import contextlib
    import io

    from tpu_gossip import dist
    from tpu_gossip.cli import run_sim

    make_mesh = dist.make_mesh
    dist.make_mesh = lambda *a, **k: make_mesh(int(shards))
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run_sim.main(list(argv))
    finally:
        dist.make_mesh = make_mesh
    if rc != 0:
        return {"exit": rc, "stderr": err.getvalue().strip().splitlines()[-1]}
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    for k in ("wall_seconds", "swarm_rounds_per_sec", "peers_rounds_per_sec", "ms_per_round",
              "ms_per_round_amortized", "epoch_rebuild_seconds_total"):
        summary.pop(k, None)
    return summary


def cli_mesh_runs(shards: int, argvs: list) -> list:
    """:func:`cli_mesh` on each of ``argvs`` in turn, in this process."""
    return [cli_mesh(shards, *argv) for argv in argvs]


def cli_mesh_pin(shards: int, *argv: str) -> dict:
    """A pin entry of ``reference_pins.json``: the JAX CLI's command line on
    a ``shards``-device mesh and its summary, timing fields left out."""
    return {"source": f"python -m tpu_gossip.cli.run_sim {' '.join(argv)} (JAX package, CPU, a {shards}-device "
                      "mesh of forced host devices)", "shards": int(shards), "argv": list(argv),
            "summary": cli_mesh(shards, *argv)}


MESH_CARD_BASE = ["--peers", "20000", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1"]
MESH_CARD_RUNS = [
    ["--rounds", "24"],
    ["--rounds", "24", "--transport", "sparse"],
    ["--rounds", "24", "--transport", "auto", "--packed"],
    ["--rounds", "24", "--builder", "dist"],
    ["--rounds", "24", "--churn-leave", "0.002", "--churn-join", "0.02", "--rewire-slots", "2"],
    ["--rounds", "32", "--scenario", "scenarios/split_brain.toml"],
    ["--rounds", "56", "--scenario", "scenarios/byzantine_siege.toml", "--quorum-k", "3"],
    ["--rounds", "20", "--grow", "22000", "--grow-rate", "100"],
    ["--rounds", "40", "--stream", "2", "--slot-ttl", "20"],
    ["--rounds", "24", "--control", "0.99"],
    ["--rounds", "24", "--pipeline", "1"],
]


def mesh_card_pins(shards: int = 8) -> list:
    """The n=20000 sharded matching pins ``chip_smoke.py`` phase 14 runs on
    the card: :data:`MESH_CARD_RUNS` on a ``shards``-device mesh."""
    return [cli_mesh_pin(shards, *MESH_CARD_BASE, *run, "--digest", "--quiet") for run in MESH_CARD_RUNS]


def seeded_matching_run(n: int, seed: int, rounds: int) -> dict:
    """``tests/test_torch_slice.py``'s headline swarm built by the JAX
    package (push_pull fanout 1, 16 slots, one origin drawn by
    ``default_rng(seed)``): its state and plan leaves and static fields as
    lists, its digest, and the digest and key of ``rounds`` rounds on."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.fleet.engine import state_digest
    from tpu_gossip.sim.engine import simulate

    cfg = SwarmConfig(n_peers=n + 1, msg_slots=16, mode="push_pull", fanout=1)
    g, plan = matching_powerlaw_graph(n, fanout=1, key=jax.random.key(seed))
    st = init_swarm(g.as_padded_graph(), cfg, key=jax.random.key(seed),
                    origins=np.random.default_rng(seed).choice(n, size=1, replace=False), exists=g.exists)
    def leaf(a):
        return [leaf(x) for x in a] if isinstance(a, tuple) else {"dtype": str(np.asarray(a).dtype),
                                                                   "data": np.asarray(a).tolist()}

    state = {f.name: leaf(jax.random.key_data(st.rng) if f.name == "rng" else getattr(st, f.name))
             for f in dataclasses.fields(st)}
    digest = state_digest(st)
    fin, _ = simulate(st, cfg, rounds, plan)  # (donates st)
    names = ("lanes", "m3", "lanes_inv", "valid", "deg_other", "deg_real")
    static = {k: getattr(plan, k) for k in ("n", "rows", "classes", "fanout", "mesh_shards", "n_per", "n_blk",
                                           "per_rows", "local_classes")}
    return {"state": state, "plan": {k: leaf(getattr(plan, k)) for k in names}, "static": static,
            "state_digest": digest, "final_digest": state_digest(fin),
            "final_rng": np.asarray(jax.random.key_data(fin.rng)).tolist()}


def campaign_run(campaign: dict, lanes: list | None = None, root: str | None = None) -> dict:
    """A campaign (the ``campaign_from_dict`` surface) run by the JAX
    package's fleet: every lane's digests, the solo digests of ``lanes``,
    and the certification report."""
    import jax

    from tpu_gossip import fleet

    camp = fleet.compile_campaign(fleet.campaign_from_dict(campaign, root=root))
    fin, stats = fleet.run_campaign(camp, keep_states=True)
    out = {
        "lane_digests": [fleet.state_digest(jax.tree.map(lambda x: x[k], fin)) for k in range(camp.k)],
        "stats_digests": [fleet.stats_digest(stats, k) for k in range(camp.k)],
        "report": fleet.campaign_report(camp, stats),
        "solo": {},
    }
    for k in lanes or ():
        sfin, sstats = fleet.run_lane_solo(camp, k)
        out["solo"][str(k)] = {**_digests(sfin, sstats), "adv_accusations": int(np.asarray(sstats.adv_accusations)
                                                                                .sum())}
    out["adv_accusations"] = int(np.asarray(stats.adv_accusations).sum())
    return out


COMPOSED_SCENARIO = {
    "name": "test-chaos",
    "phases": [
        {"name": "lossy", "start": 0, "end": 6, "loss": 0.2, "delay": 0.15},
        {"name": "split", "start": 6, "end": 10, "partition": "half"},
        {"name": "storm", "start": 10, "end": 14, "churn_leave": 0.05, "churn_join": 0.2,
         "blackout": {"frac": 0.1, "seed": 1}},
    ],
}


def composed_campaign(seeds: int = 16) -> dict:
    """``tests/sim/test_fleet.py``'s composed campaign (scenario, stream
    and control on every lane; a loss sweep and a bound-and-rate sweep),
    its scenario inline."""
    return {
        "name": "composed", "seed": 3,
        "base": {"peers": 96, "rounds": 18, "slots": 8, "fanout": 2, "mode": "push_pull", "coverage_target": 0.9,
                 "target_ratio": 0.8, "stream_rate": 1.0, "slot_ttl": 12, "control": 0.9, "control_hi": 5,
                 "rewire_slots": 5, "churn_join": 0.02, "refresh_every": 4},
        "families": [
            {"name": "loss-sweep", "scenario": COMPOSED_SCENARIO, "seeds": seeds // 2,
             "sweeps": [{"axis": "phase.loss", "dist": "uniform", "lo": 0.05, "hi": 0.5}]},
            {"name": "bound-sweep", "scenario": COMPOSED_SCENARIO, "seeds": seeds - seeds // 2,
             "sweeps": [{"axis": "control.hi", "dist": "linspace", "lo": 2, "hi": 5},
                        {"axis": "stream.rate", "dist": "uniform", "lo": 0.5, "hi": 2.0}]},
        ],
    }


MIX_CAMPAIGN = {
    "name": "mix", "seed": 0,
    "base": {"peers": 64, "rounds": 30, "slots": 4, "fanout": 2, "mode": "push"},
    "families": [{"name": "lossy", "scenario": "scenarios/lossy_links.toml", "seeds": 2},
                 {"name": "split", "scenario": "scenarios/split_brain.toml", "seeds": 2}],
}

SIEGE_SCENARIO = {
    "name": "siege",
    "phases": [{"name": "adv", "start": 0, "end": 6, "accusers": {"frac": 0.06, "seed": 3},
                "floods": {"frac": 0.05, "seed": 5}, "blackout": {"frac": 0.1, "seed": 2}}],
}
SIEGE_CAMPAIGN = {
    "name": "siege", "seed": 0,
    "base": {"peers": 64, "rounds": 8, "slots": 4, "fanout": 2, "mode": "push", "quorum_k": 3,
             "suspicion_window": 4, "accusation_budget": 2},
    "families": [{"name": "adv", "scenario": SIEGE_SCENARIO, "seeds": 3}],
}


def campaign_file_run(path: str) -> dict:
    """A campaign TOML run by the JAX package's fleet: every lane's
    digests."""
    import jax

    from tpu_gossip import fleet

    camp = fleet.compile_campaign(fleet.parse_campaign(path))
    fin, stats = fleet.run_campaign(camp, keep_states=True)
    return {"lane_digests": [fleet.state_digest(jax.tree.map(lambda x: x[k], fin)) for k in range(camp.k)],
            "stats_digests": [fleet.stats_digest(stats, k) for k in range(camp.k)]}


def cli_exits(argvs: list) -> list:
    """``[exit code, stderr]`` of the JAX CLI on each argv (in this
    process, one after another)."""
    import contextlib
    import io

    from tpu_gossip.cli import run_sim

    out = []
    for argv in argvs:
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            try:
                rc = run_sim.main(list(argv))
            except SystemExit as e:
                rc = e.code
        out.append([rc, err.getvalue()])
    return out


def cli_with_stderr(argv: list) -> dict:
    """The JAX CLI on ``argv`` in this process: its exit code, summary line
    and stderr."""
    import contextlib
    import io

    from tpu_gossip.cli import run_sim

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_sim.main(list(argv))
    lines = out.getvalue().strip().splitlines()
    return {"rc": rc, "summary": json.loads(lines[-1]) if rc == 0 else None, "stderr": err.getvalue()}


def cli_profile_shape(*argv: str) -> dict:
    """The timing-free shape of the JAX CLI's ``--profile-round`` output:
    the summary's keys and fields, its stage names in order, and the stage
    table's row count on stderr."""
    run = cli_with_stderr(list(argv))
    summary = run["summary"]
    return {"keys": list(summary), "stages": list(summary["stages_ms"]),
            "fields": {k: summary[k] for k in ("summary", "profile_round", "mode", "n_peers", "warm_rounds")},
            "table_rows": run["stderr"].count("\n| ")}


def profile_stage_keys(n: int, runs: list) -> list:
    """``utils.profiling.profile_round_stages``'s stage names, in order, on
    ``tests/test_torch_profiling.py``'s matching swarm of ``n`` peers, for
    each ``(tails, transport_probe)`` of ``runs``."""
    import jax

    from tpu_gossip.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.utils.profiling import profile_round_stages

    g, plan = matching_powerlaw_graph(n, gamma=2.5, fanout=1, key=jax.random.key(0))
    cfg = SwarmConfig(n_peers=n + 1, msg_slots=16, mode="push_pull", fanout=1)
    st = init_swarm(g.as_padded_graph(), cfg, key=jax.random.key(0), origins=np.arange(4), exists=g.exists)
    return [list(profile_round_stages(st, cfg, plan, tails=tuple(tails), transport_probe=None if tp is None
                                      else tuple(tp), reps=1, loop_lengths=(1, 2)))
            for tails, tp in runs]


def cli_lines(one_shard: bool, *argv: str) -> dict:
    """The JAX CLI's summary and per-round JSON lines for ``argv`` (its mesh
    pinned to one device with ``one_shard``), as the port's CLI tests read
    them."""
    import contextlib
    import io

    from tpu_gossip import dist
    from tpu_gossip.cli import run_sim

    make_mesh = dist.make_mesh
    if one_shard:
        dist.make_mesh = lambda *a, **k: make_mesh(1)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run_sim.main(list(argv))
    finally:
        dist.make_mesh = make_mesh
    if rc != 0:
        raise SystemExit(f"JAX CLI exited {rc} on {argv}")
    lines = out.getvalue().strip().splitlines()
    return {"summary": json.loads(lines[-1]), "rows": lines[:-1]}


def cli(argv: list) -> dict:
    """The JAX CLI's summary line for ``argv``, on one device."""
    import contextlib
    import io

    from tpu_gossip import dist
    from tpu_gossip.cli import run_sim

    make_mesh = dist.make_mesh
    dist.make_mesh = lambda *a, **k: make_mesh(1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_sim.main(list(argv))
    if rc != 0:
        raise SystemExit(f"JAX CLI exited {rc} on {argv}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def cli_pin(*argv: str) -> dict:
    """A pin entry of ``reference_pins.json``: the JAX CLI's command line
    and its summary, timing fields left out."""
    summary = cli(list(argv))
    for k in ("wall_seconds", "swarm_rounds_per_sec", "packed"):
        summary.pop(k, None)
    return {"source": "python -m tpu_gossip.cli.run_sim " + " ".join(argv) + " (JAX package, CPU, one device)",
            "argv": list(argv), "summary": summary}


MESH_CLI_BASE = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--quiet", "--seed", "2"]
MATCHING_SHARD = ["--graph", "matching", "--shard"]
# the sharded CLI paths the port's CLI tests compare with, on a 2-device mesh
MESH_CLI = {
    "dense": [*MESH_CLI_BASE, *MATCHING_SHARD, "--rounds", "8", "--digest"],
    "sparse": [*MESH_CLI_BASE, *MATCHING_SHARD, "--rounds", "8", "--digest", "--transport", "sparse"],
    "auto_packed": [*MESH_CLI_BASE, *MATCHING_SHARD, "--rounds", "8", "--digest", "--transport", "auto", "--packed"],
    "dist_sparse": [*MESH_CLI_BASE, *MATCHING_SHARD, "--rounds", "8", "--digest", "--builder", "dist",
                    "--transport", "sparse"],
    "flood": [*MESH_CLI_BASE[:2], "--mode", "flood", *MESH_CLI_BASE[4:], *MATCHING_SHARD, "--rounds", "6",
              "--digest"],
    "target_sparse": [*MESH_CLI_BASE, *MATCHING_SHARD, "--transport", "sparse"],
    "remat_fallback": [*MESH_CLI_BASE, *MATCHING_SHARD, "--churn-leave", "0.01", "--churn-join", "0.1",
                       "--rewire-slots", "2", "--remat-every", "4", "--rounds", "8", "--digest"],
    "pa_sparse": [*MESH_CLI_BASE, "--graph", "pa", "--shard", "--rounds", "8", "--digest", "--transport", "sparse"],
    "chung_lu_staircase_auto": [*MESH_CLI_BASE, "--graph", "chung-lu", "--shard", "--staircase", "--rounds", "8",
                                "--digest", "--transport", "auto"],
    "pa_target_sparse": [*MESH_CLI_BASE, "--graph", "pa", "--shard", "--transport", "sparse"],
    "ckpt12": [*MESH_CLI_BASE, *MATCHING_SHARD, "--rounds", "12", "--digest", "--transport", "sparse"],
    # the cases that refused the sharded matching engine before it was ported
    "control_pipeline": ["--peers", "96", "--slots", "4", "--fanout", "2", "--quiet", "--control", "0.9", "--rounds",
                         "20", "--shard", "--graph", "matching", "--pipeline", "1"],
    "control": ["--peers", "96", "--slots", "4", "--fanout", "2", "--quiet", "--control", "0.9", "--rounds", "20",
                "--shard", "--graph", "matching"],
    "stream_pipeline": ["--peers", "96", "--slots", "4", "--fanout", "2", "--quiet", "--stream", "2", "--rounds", "20",
                        "--shard", "--graph", "matching", "--pipeline", "1"],
    "stream": ["--peers", "96", "--slots", "4", "--fanout", "2", "--quiet", "--stream", "2", "--rounds", "20",
               "--shard", "--graph", "matching"],
    "grow_target": ["--peers", "64", "--graph", "matching", "--shard", "--grow", "128", "--max-rounds", "40"],
    "small_target": ["--peers", "100", "--rounds", "2", "--graph", "matching", "--shard"],
    "small_chung_lu_sparse": ["--peers", "100", "--rounds", "2", "--graph", "chung-lu", "--shard", "--transport",
                              "sparse"],
    "matching_target": ["--peers", "100", "--graph", "matching", "--shard", "--max-rounds", "40"],
    "matching_control_pipeline": ["--peers", "100", "--graph", "matching", "--control", "0.9", "--rounds", "8",
                                  "--shard", "--pipeline", "1"],
}

STREAM_M = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "matching"]
STREAM_S = ["--stream", "2", "--slot-ttl", "20", "--rounds", "40", "--digest"]
STREAM_C = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1"]
# the streamed scenario runs of test_torch_stream_cli_scenarios.py (their meshes of one shard)
STREAM_SCENARIOS = {
    "lossy_links": STREAM_C + ["--graph", "matching", "--scenario", "scenarios/lossy_links.toml"] + STREAM_S,
    "siege": STREAM_C + ["--graph", "matching", "--scenario", "scenarios/byzantine_siege.toml", "--quorum-k", "3",
                         "--stream", "2", "--slot-ttl", "20", "--rounds", "56", "--digest"],
    "flash_crowd_header": ["--peers", "96", "--grow", "192", "--grow-rate", "4", "--m", "2", "--stream", "3",
                           "--slot-ttl", "12", "--rounds", "30", "--scenario", "scenarios/flash_crowd_under_fire.toml",
                           "--digest"],
}
# the streamed CLI runs of test_torch_stream_cli.py (local engines) and
# test_torch_stream_cli_engines.py (each engine, meshes of one shard)
STREAM_ENGINES = {
    "matching": STREAM_M + STREAM_S,
    "matching_hotspot_burst": STREAM_M + ["--stream-origins", "hotspot", "--stream-burst-every", "4"] + STREAM_S,
    "matching_packed": STREAM_M + ["--packed"] + STREAM_S,
    "pa_hotspot_packed": ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--graph", "pa", "--m", "3",
                          "--packed", "--stream-origins", "hotspot"] + STREAM_S,
}
STREAM_ENGINES_ONE_SHARD = {
    "chung_lu_degree_bloom": STREAM_C + ["--graph", "chung-lu", "--stream-origins", "degree", "--stream-hashes",
                                         "2"] + STREAM_S,
    "pa_hotspot": STREAM_C + ["--graph", "pa", "--m", "3", "--stream-origins", "hotspot"] + STREAM_S,
    "staircase_burst": STREAM_C + ["--graph", "chung-lu", "--staircase", "--stream", "4", "--stream-burst-every",
                                   "3", "--slot-ttl", "20", "--rounds", "40", "--digest"],
    "staircase_packed": STREAM_C + ["--graph", "chung-lu", "--staircase", "--packed"] + STREAM_S,
    "shard_k6": STREAM_C + ["--graph", "pa", "--m", "2", "--shard", "--staircase"] + STREAM_S,
    "shard_packed": STREAM_C + ["--graph", "pa", "--m", "2", "--shard", "--packed"] + STREAM_S,
    "staircase_remat_churn": STREAM_C + ["--graph", "chung-lu", "--staircase", "--remat-every", "8", "--churn-leave",
                                         "0.01", "--churn-join", "0.1", "--rewire-slots", "2"] + STREAM_S,
    "silent": STREAM_C + ["--graph", "chung-lu", "--silent-frac", "0.1"] + STREAM_S,
}

def trace_windows(path: str) -> list:
    """A saved serve trace's windows, ``[[(row, hash), ...], overflow]`` a
    round, read from the JSONL (either package's)."""
    with open(path) as fh:
        lines = [json.loads(line) for line in fh if line.strip()][1:]
    return [[list(zip(d["origins"], d["hashes"])), d["overflow"]] for d in lines]


def windows_take(windows: list, rows: bool):
    """A ``ServeFrontend.take_window`` that hands out ``windows`` in turn
    (origins mapped through the frontend's origin table unless ``rows``),
    billing each overflow as the frontend does; empty windows after."""
    queue = list(windows)

    def take_window(self):
        if not queue:
            return [], 0
        window, overflow = queue.pop(0)
        window = [(int(o) if rows else self.origin_rows[int(o)], int(h)) for o, h in window]
        self.counters.overflow_billed += overflow
        return window, overflow

    return take_window


SERVE_ASIDE = ("wall_seconds", "ms_per_round", "port", "trace_path")


def serve_summary(summary: dict) -> dict:
    """A ``run_sim serve`` summary with its timing and port keys aside."""
    summary = dict(summary, serve={k: v for k, v in summary["serve"].items() if k not in SERVE_ASIDE})
    return summary


def serve_cli(shards: int, windows: list, rows: bool, *argv: str) -> dict:
    """The JAX CLI's ``run_sim serve`` on ``argv`` (``make_mesh`` pinned to
    ``shards`` of the forced host devices) with the frontend's windows
    replaced by ``windows`` (:func:`windows_take`): its summary with the
    timing and port keys aside, or a refused run's exit code and last
    stderr line."""
    import contextlib
    import io

    from tpu_gossip import dist
    from tpu_gossip.cli import run_sim
    from tpu_gossip.serve.frontend import ServeFrontend

    make_mesh, take = dist.make_mesh, ServeFrontend.take_window
    dist.make_mesh = lambda *a, **k: make_mesh(int(shards))
    ServeFrontend.take_window = windows_take(windows, rows)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run_sim.main(["serve", *argv])
    finally:
        dist.make_mesh, ServeFrontend.take_window = make_mesh, take
    if rc != 0:
        return {"exit": rc, "stderr": err.getvalue().strip().splitlines()[-1]}
    return serve_summary(json.loads(out.getvalue().strip().splitlines()[-1]))


def serve_scripted(shards: int, seed: int, *argv: str) -> dict:
    """:func:`serve_cli` on :func:`scripted_windows` of ``seed``, sized by
    the argv's ``--rounds``, ``--max-inject`` and ``--peers``."""
    return serve_cli(shards, argv_windows(seed, argv), False, *argv)


def argv_windows(seed: int, argv) -> list:
    """:func:`scripted_windows` sized by a serve argv's ``--rounds``,
    ``--max-inject`` and ``--peers``."""
    def flag(name, default=None):
        return int(argv[list(argv).index(name) + 1]) if name in argv else default

    return scripted_windows(seed, flag("--rounds"), flag("--max-inject", 64), flag("--peers"))


def ingest_rules() -> dict:
    """``tests/serve/test_ingest.py``'s engine cases run by the JAX package:
    each case's state and stats digests (and the stats it asserts on)."""
    import jax

    from tpu_gossip.core.device_topology import device_powerlaw_graph
    from tpu_gossip.core.packed import pack_state, unpack_state
    from tpu_gossip.core.state import SwarmConfig, init_swarm, message_slots
    from tpu_gossip.sim.engine import gossip_round
    from tpu_gossip.traffic.ingest import IngestPlan, empty_batch, make_batch

    dg = device_powerlaw_graph(INGEST_N, gamma=2.5, key=jax.random.key(0))
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=INGEST_M, fanout=3, mode="push")
    state = init_swarm(dg.as_padded_graph(), cfg, key=jax.random.key(0), origins=np.array([0]), exists=dg.exists)
    out = {}
    for name, (origins, hashes, overflow, k, packed) in ingest_cases(int(dg.n_pad), message_slots).items():
        plan = IngestPlan(msg_slots=INGEST_M, max_inject=4, k_hashes=k)
        batch = empty_batch(plan) if origins is None else make_batch(plan, origins, hashes, overflow=overflow)
        fin, stats = gossip_round(pack_state(state) if packed else state, cfg, inject=batch)
        fin = unpack_state(fin) if packed else fin
        out[name] = {**_digests(fin, jax.tree.map(lambda a: a[None], stats)),
                     "ingest": [int(getattr(stats, f"ingest_{c}")) for c in ("offered", "injected", "conflated",
                                                                              "overflow")]}
    return out


INGEST_N, INGEST_M = 48, 8


def ingest_cases(n_pad: int, message_slots) -> dict:
    """The ingest rules' batches: ``(origins or None for the empty batch,
    payload hashes, overflow, k, packed)``; the hashes are the ones
    ``tests/serve/test_ingest.py`` picks (distinct k=1 slots, two on one
    slot), found with the caller's ``message_slots``."""
    distinct, seen_slots, h = [], set(), 1
    while len(distinct) < 3:
        sl = message_slots(h, INGEST_M, 1)[0]
        if sl not in seen_slots:
            seen_slots.add(sl)
            distinct.append(h)
        h += 1
    by_slot, h = {}, 1
    while True:
        sl = message_slots(h, INGEST_M, 1)[0]
        if sl in by_slot:
            same = [by_slot[sl], h]
            break
        by_slot[sl] = h
        h += 1
    return {
        "zero_batch": (None, [], 0, 1, False),
        "overflow_billed": ([2], distinct[:1], 5, 1, False),
        "land_and_latch": ([2, 3, 4], distinct, 0, 1, False),
        "dead_origin": ([n_pad - 1], distinct[:1], 0, 1, False),
        "same_slot_conflates": ([2, 3], same, 0, 1, False),
        "k2_bloom_planes": ([5], [12345], 0, 2, False),
        "packed_parity": ([2, 9, 11], distinct, 0, 1, True),
        "next_round_transmit": ([7], distinct[:1], 0, 1, False),
    }


SERVE_BASE = ["--slots", "8", "--slot-ttl", "20", "--rounds", "10", "--max-inject", "6", "--quiet", "--seed", "3",
              "--replay-check"]
# the served engines of tests/test_torch_serve_replay.py: name -> (shards, argv)
SERVE_ENGINES = {
    "pa": (1, ["--peers", "400", "--graph", "pa", "--m", "3", "--mode", "push_pull", "--fanout", "2", *SERVE_BASE]),
    "chung_lu": (1, ["--peers", "400", "--graph", "chung-lu", "--mode", "push", "--fanout", "3", *SERVE_BASE]),
    "matching": (1, ["--peers", "600", "--graph", "matching", "--mode", "push_pull", "--fanout", "1", *SERVE_BASE]),
    "matching_packed": (1, ["--peers", "600", "--graph", "matching", "--mode", "push_pull", "--fanout", "1",
                            "--packed", *SERVE_BASE]),
    "mesh_s2": (2, ["--peers", "600", "--graph", "matching", "--shard", "--mode", "push_pull", "--fanout", "1",
                    *SERVE_BASE]),
    "pa_k2_stream": (1, ["--peers", "400", "--graph", "pa", "--mode", "push", "--fanout", "2", "--stream", "1.5",
                         "--stream-hashes", "2", *SERVE_BASE]),
}
SERVE_SEED = 11
SERVE_REFUSED = [
    ["--peers", "48", "--slots", "4", "--fanout", "2", "--quiet", *extra] for extra in (
        ["--slot-ttl", "12"], ["--rounds", "20"], ["--rounds", "20", "--slot-ttl", "2"],
        ["--rounds", "20", "--slot-ttl", "12", "--port", "70000"],
        ["--rounds", "20", "--slot-ttl", "12", "--rounds-per-sec", "-1"],
        ["--rounds", "20", "--slot-ttl", "12", "--max-inject", "0"],
        ["--rounds", "20", "--slot-ttl", "12", "--stream-hashes", "5"],
        ["--rounds", "20", "--stream", "2", "--slot-ttl", "2"],
        ["--rounds", "20", "--slot-ttl", "12", "--shard"],
        ["--rounds", "20", "--slot-ttl", "12", "--control", "0.9"],
        ["--rounds", "20", "--slot-ttl", "12", "--grow", "96"],
        ["--rounds", "20", "--slot-ttl", "12", "--remat-every", "8"],
        ["--rounds", "20", "--slot-ttl", "12", "--scenario", "scenarios/split_brain.toml"],
        ["--rounds", "20", "--slot-ttl", "12", "--shard", "--graph", "matching", "--pipeline", "1"],
        ["--rounds", "20", "--slot-ttl", "12", "--profile-round", "2"],
        ["--rounds", "20", "--slot-ttl", "12", "--shard", "--graph", "matching", "--transport", "sparse"],
        ["--rounds", "20", "--slot-ttl", "12", "--checkpoint-every", "4", "--checkpoint-dir", "d"])]


def serve_refusals(argvs: list) -> list:
    """``[exit code, last stderr line]`` of the JAX CLI's ``run_sim serve``
    on each argv (each refused before anything is built)."""
    return [list(serve_cli(1, [], False, *argv).values()) for argv in argvs]


SERVE_1M = dict(n=1_000_000, gamma=2.5, graph_key=0, state_key=0, msg_slots=32, fanout=2, mode="push_pull",
                max_inject=1024, k_hashes=1, rounds=12, seed=0)


def serve_1m_pin() -> dict:
    """``chip_smoke.py`` phase 15c's pin: ``bench.py::bench_serve``'s swarm
    (``device_powerlaw_graph(1M, gamma=2.5, key 0)``, 32 slots, push_pull
    fanout 2, a rate-0 stream with ``ttl = int(1.5 * min_feasible_ttl(1M,
    2))``, ``max_inject`` 1024, k = 1) replaying the numpy-seeded trace of
    ``scripted_windows(0, 12, 1024, members)`` through the JAX package's
    serving step."""
    import jax

    from tpu_gossip.core.device_topology import device_powerlaw_graph
    from tpu_gossip.core.state import SwarmConfig, init_swarm
    from tpu_gossip.serve import TraceRecorder, build_step, replay_trace
    from tpu_gossip.serve.driver import stack_round_stats
    from tpu_gossip.traffic import compile_stream, min_feasible_ttl
    from tpu_gossip.traffic.ingest import IngestPlan

    c = SERVE_1M
    dg = device_powerlaw_graph(c["n"], gamma=c["gamma"], key=jax.random.key(c["graph_key"]))
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=c["msg_slots"], fanout=c["fanout"], mode=c["mode"])
    state = init_swarm(dg.as_padded_graph(), cfg, exists=dg.exists, key=jax.random.key(c["state_key"]))
    ttl = int(1.5 * min_feasible_ttl(c["n"], c["fanout"]))
    rows = np.flatnonzero(np.asarray(dg.exists))
    strm = compile_stream(rate=0.0, msg_slots=c["msg_slots"], ttl=ttl, origin_rows=rows)
    plan = IngestPlan(msg_slots=c["msg_slots"], max_inject=c["max_inject"], k_hashes=c["k_hashes"])
    rec = TraceRecorder(plan)
    for r, (window, overflow) in enumerate(scripted_windows(c["seed"], c["rounds"], c["max_inject"], len(rows))):
        rec.record_round(r, [(int(rows[i]), h) for i, h in window], overflow)
    trace = rec.finish()
    fin, trail = replay_trace(trace, build_step(cfg, stream=strm), state)
    stats = stack_round_stats([jax.device_get(s) for s in trail])
    return {"source": "JAX_PLATFORMS=cpu python -m tests.jax_pins serve_1m_pin (JAX package, CPU)",
            "config": dict(c, ttl=ttl), "arrivals": trace.total_arrivals,
            "ingest": {k: int(np.asarray(getattr(stats, f"ingest_{k}")).sum())
                       for k in ("offered", "injected", "conflated", "overflow")},
            "coverage": float(np.asarray(stats.coverage)[-1]), **_digests(fin, stats)}


CONTROL_CHURN = dict(churn_leave_prob=0.01, churn_join_prob=0.05, rewire_slots=3)


def control_pa_graph(n: int = 300, seed: int = 0, m: int = 3, native: bool = False):
    """The control tests' PA graph (host numpy, or the native generator)."""
    from tpu_gossip.core.topology import build_csr, preferential_attachment

    return build_csr(n, preferential_attachment(n, m=m, use_native=native, rng=np.random.default_rng(seed)))


def _control_swarm(g, seed=0, exists=None, **kw):
    from tpu_gossip.core.state import SwarmConfig, init_swarm

    cfg = SwarmConfig(n_peers=g.n, **kw)
    return cfg, init_swarm(g, cfg, origins=[0], exists=exists, key=_jax_key(seed))


def _jax_key(seed):
    import jax

    return jax.random.key(seed)


def _control_matching(n, fanout, key, slots):
    from tpu_gossip.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip.core.state import SwarmConfig, init_swarm

    dg, plan = matching_powerlaw_graph(n, gamma=2.5, fanout=fanout, key=_jax_key(key))
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=slots, fanout=fanout, mode="push_pull")
    return cfg, init_swarm(dg.as_padded_graph(), cfg, origins=[0], exists=dg.exists, key=_jax_key(key)), plan


def _control_sim(swarm, rounds, plan=None, control=None):
    from tpu_gossip.core.state import clone_state
    from tpu_gossip.sim.engine import simulate

    cfg, state = swarm
    return _digests(*simulate(clone_state(state), cfg, rounds, plan, control=control))


def control_runs_case(name: str) -> list:
    """The JAX halves of ``tests/test_torch_control_runs.py``: each case's
    runs (plain, zero-adjustment or active control) as digests, in the
    test's order."""
    from tpu_gossip.control import compile_control
    from tpu_gossip.kernels.pallas_segment import build_staircase_plan

    if name.startswith("zero_exactly_k_"):
        sw = _control_swarm(control_pa_graph(), msg_slots=4, fanout=3, mode=name[len("zero_exactly_k_"):],
                            **CONTROL_CHURN)
        z = compile_control(target_ratio=0.9, fanout=3, lo=3, hi=3)
        return [_control_sim(sw, 15), _control_sim(sw, 15, control=z)]
    if name == "zero_staircase_matching":
        g = control_pa_graph()
        sw = _control_swarm(g, msg_slots=4, fanout=2, mode="push_pull")
        sp = build_staircase_plan(g.row_ptr, g.col_idx, fanout=2)
        z = compile_control(target_ratio=0.9, fanout=2, lo=2, hi=2)
        cfg, st, mp = _control_matching(256, 2, 0, 4)
        return [_control_sim(sw, 12, sp), _control_sim(sw, 12, sp, z), _control_sim((cfg, st), 12, mp),
                _control_sim((cfg, st), 12, mp, z)]
    if name.startswith("bucketed_active_s"):
        from tpu_gossip.core.state import SwarmConfig
        from tpu_gossip.dist import init_sharded_swarm, make_mesh, partition_graph, shard_swarm, simulate_dist

        shards = int(name[len("bucketed_active_s"):])
        sg, rel, pos = partition_graph(control_pa_graph(400), shards, seed=1, window=1024)
        cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=4, mode="push_pull", fanout=3, churn_leave_prob=0.01,
                          churn_join_prob=0.05, rewire_slots=5)
        mesh = make_mesh(shards)
        st = shard_swarm(init_sharded_swarm(sg, rel, pos, cfg, key=_jax_key(1), origins=[0, 5]), mesh)
        a = compile_control(target_ratio=0.9, fanout=3, lo=1, hi=5, refresh_every=4)
        return [_digests(*simulate_dist(st, cfg, sg, mesh, 12, control=a))]
    if name.startswith("controlled_exactly_k_cap"):
        sw = _control_swarm(control_pa_graph(), msg_slots=4, fanout=3, mode="push_pull",
                            rewire_compact_cap=int(name[len("controlled_exactly_k_cap"):]), **CONTROL_CHURN)
        c = compile_control(target_ratio=0.9, fanout=3, lo=1, hi=3, refresh_every=2)
        return [_control_sim(sw, 20, control=c)]
    if name == "controlled_staircase_matching":
        g = control_pa_graph()
        sw = _control_swarm(g, msg_slots=4, fanout=3, mode="push_pull", rewire_slots=5, churn_join_prob=0.05)
        sp = build_staircase_plan(g.row_ptr, g.col_idx, fanout=3)
        c1 = compile_control(target_ratio=0.99, fanout=3, lo=1, hi=5, refresh_every=3)
        cfg, st, mp = _control_matching(2000, 2, 1, 8)
        c2 = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=4)
        return [_control_sim(sw, 16, sp, c1), _control_sim((cfg, st), 16, mp, c2)]
    raise KeyError(name)


# tests/test_torch_pipeline_profile.py's --profile-round runs: each plane alone, then composed
PROFILE_BASE = ["--peers", "300", "--mode", "push_pull", "--fanout", "2", "--profile-round", "2"]
PROFILE_PLANES = {"grow": ["--grow", "360", "--grow-rate", "12"], "stream": ["--stream", "2", "--slot-ttl", "12"],
                  "control": ["--control", "0.99"]}
PROFILE_COMPOSED = PROFILE_BASE + [a for argv in PROFILE_PLANES.values() for a in argv]

# tests/test_torch_packed_engine.py's packed runs: name -> (graph, cfg keywords, tail)
PACKED_RUNS = {
    "matching_push_pull_f1": ("matching", dict(mode="push_pull", fanout=1), "fused"),
    "xla_push_pull_f1": ("xla", dict(mode="push_pull", fanout=1), "fused"),
    "xla_push_f3": ("xla", dict(mode="push", fanout=3), "fused"),
    "xla_flood": ("xla", dict(mode="flood"), "fused"),
    "staircase_push_pull_f1": ("staircase", dict(mode="push_pull", fanout=1), "fused"),
    "xla_sir4_tail_pallas": ("xla", dict(mode="push_pull", fanout=1, sir_recover_rounds=4), "pallas"),
    "matching_forward_once": ("matching", dict(mode="push_pull", fanout=1, forward_once=True), "fused"),
}


def _jax_packed_swarm(graph: str, seed: int, **cfg_kw):
    """``tests/test_torch_packed_engine.py``'s swarm, the JAX half: the
    n=2000 matching swarm of ``test_torch_slice.build_jax`` or the Chung-Lu
    one of ``test_torch_staircase.build_both_csr``."""
    if graph == "matching":
        from tests.test_torch_slice import build_jax

        return build_jax(2000, seed, **cfg_kw)
    from tests.test_torch_staircase import build_both_csr

    return build_both_csr(2000, seed=seed, staircase=graph == "staircase", **cfg_kw)[0]


def packed_simulate(name: str) -> dict:
    """The JAX packed run of ``PACKED_RUNS[name]``: 20 rounds of the packed
    state, its digests packed and unpacked, the stats digest, coverage."""
    from tpu_gossip.core.packed import pack_state, unpack_state
    from tpu_gossip.fleet.engine import state_digest
    from tpu_gossip.sim.engine import simulate

    graph, cfg_kw, tail = PACKED_RUNS[name]
    jc, js, jp = _jax_packed_swarm(graph, 1, **cfg_kw)
    fin, stats = simulate(pack_state(js), jc, 20, jp, tail)
    return {**_digests(fin, stats), "unpacked_digest": state_digest(unpack_state(fin)),
            "coverage": np.asarray(stats.coverage).tolist()}


def packed_coverage(graph: str) -> dict:
    """The JAX packed run to 99% coverage (seed 2, push_pull fanout 1)."""
    import jax

    from tpu_gossip.core.packed import pack_state
    from tpu_gossip.fleet.engine import state_digest
    from tpu_gossip.sim.engine import run_until_coverage

    jc, js, jp = _jax_packed_swarm(graph, 2, mode="push_pull", fanout=1)
    fin = run_until_coverage(pack_state(js), jc, 0.99, 1000, plan=jp)
    return {"round": int(fin.round), "state_digest": state_digest(fin),
            "coverage": float(np.asarray(jax.device_get(fin.coverage(0))))}


GROWTH_M = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1"]
# tests/test_torch_growth_cli_engines.py's growing CLI runs (16 rounds, --digest added)
GROWTH_ENGINES = {
    "matching": GROWTH_M + ["--graph", "matching", "--grow", "2600"],
    "matching_packed": GROWTH_M + ["--graph", "matching", "--packed", "--grow", "2600"],
    "pa_push_churn": ["--peers", "2000", "--graph", "pa", "--m", "3", "--slots", "8", "--fanout", "3", "--mode",
                      "push", "--churn-leave", "0.01", "--churn-join", "0.1", "--rewire-slots", "2", "--grow", "2400",
                      "--grow-rate", "64"],
    "staircase_remat": GROWTH_M + ["--graph", "chung-lu", "--staircase", "--remat-every", "4", "--grow", "2400",
                                   "--grow-capacity", "2500"],
    "shard": GROWTH_M + ["--graph", "chung-lu", "--shard", "--staircase", "--grow", "2400"],
    "shard_packed": GROWTH_M + ["--graph", "chung-lu", "--shard", "--packed", "--grow", "2400"],
    "silent_exactly_k": GROWTH_M + ["--graph", "chung-lu", "--silent-frac", "0.1", "--grow", "2400"],
    "flash_crowd": GROWTH_M + ["--graph", "matching", "--grow", "2400", "--scenario",
                               "scenarios/flash_crowd_under_fire.toml"],
}
GROWTH_HORIZON = ["--rounds", "16", "--digest"]


def staircase_simulate(name: str) -> dict:
    """``tests/test_torch_staircase.py::jax_simulate_digests`` (the JAX half
    of its ``test_simulate_digests_equal_jax``)."""
    from tests.test_torch_staircase import jax_simulate_digests

    return jax_simulate_digests(name)


CONTROL_M = ["--peers", "2000", "--mode", "push_pull"]
# the controlled CLI runs of tests/test_torch_control_cli.py (local engines) and
# tests/test_torch_control_cli_engines.py (the bucketed mesh, the remat loops)
CONTROL_CLI_LOCAL = {
    "exactly_k_refresh": CONTROL_M + ["--graph", "pa", "--m", "3", "--slots", "8", "--fanout", "3", "--churn-leave",
                                      "0.01", "--churn-join", "0.05", "--rewire-slots", "6", "--refresh-every", "4",
                                      "--control", "0.9", "--rounds", "20"],
    "staircase_bounds": CONTROL_M + ["--graph", "chung-lu", "--staircase", "--fanout", "3", "--control-bounds", "1,6",
                                     "--control", "0.99", "--rounds", "20"],
    "matching_packed": CONTROL_M + ["--graph", "matching", "--fanout", "1", "--packed", "--control", "0.99",
                                    "--rounds", "20"],
    "matching_to_target": CONTROL_M + ["--graph", "matching", "--fanout", "2", "--control", "0.95"],
    "stream_scenario": CONTROL_M + ["--graph", "chung-lu", "--fanout", "2", "--stream", "2", "--slot-ttl", "12",
                                    "--scenario", "scenarios/lossy_links.toml", "--control", "0.9", "--rounds", "32"],
}
CONTROL_CLI_MESH = {
    "shard_staircase": CONTROL_M + ["--graph", "chung-lu", "--fanout", "2", "--shard", "--staircase", "--control",
                                    "0.9", "--rounds", "16"],
    "shard_to_target": CONTROL_M + ["--graph", "chung-lu", "--fanout", "2", "--shard", "--control", "0.95"],
    "remat_staircase": CONTROL_M + ["--graph", "chung-lu", "--staircase", "--fanout", "2", "--churn-leave", "0.01",
                                    "--churn-join", "0.05", "--rewire-slots", "4", "--remat-every", "6",
                                    "--refresh-every", "2", "--control", "0.9", "--rounds", "16"],
    "remat_to_target": CONTROL_M + ["--graph", "chung-lu", "--fanout", "2", "--churn-join", "0.05", "--rewire-slots",
                                    "4", "--remat-every", "6", "--control", "0.9"],
    "shard_remat": CONTROL_M + ["--graph", "chung-lu", "--fanout", "2", "--shard", "--churn-leave", "0.01",
                                "--churn-join", "0.05", "--rewire-slots", "4", "--remat-every", "6", "--refresh-every",
                                "3", "--control", "0.9", "--rounds", "16"],
}


def digest_argv(argv: list) -> list:
    """A CLI argv with ``--digest`` on a fixed horizon."""
    return argv + (["--digest"] if "--rounds" in argv else [])


ADV_SIEGE = ["--scenario", "scenarios/byzantine_siege.toml"]
ADV_BASE = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1", "--digest", "--seed", "3", "--quorum-k", "3"]
ADV_CHURN = ["--churn-leave", "0.01", "--churn-join", "0.1", "--rewire-slots", "2"]
# the quorum detector's CLI runs of tests/test_torch_adversary_cli.py (phase 9 of chip_smoke.py, shrunk)
ADV_PATHS = {
    "siege_matching": ["--graph", "matching", *ADV_SIEGE, "--rounds", "56"],
    "siege_matching_k1": ["--graph", "matching", *ADV_SIEGE, "--rounds", "56", "--quorum-k", "1"],
    "siege_matching_packed": ["--graph", "matching", "--packed", *ADV_SIEGE, "--rounds", "56", "--quiet"],
    "siege_staircase": ["--graph", "chung-lu", "--staircase", *ADV_SIEGE, "--rounds", "56", "--quiet"],
    "siege_exactly_k_churn_compact": ["--graph", "chung-lu", *ADV_SIEGE, *ADV_CHURN, "--rewire-compact-cap", "64",
                                      "--rounds", "56", "--quiet"],
    "siege_shard_k6": ["--graph", "chung-lu", "--shard", "--staircase", *ADV_SIEGE, "--rounds", "56", "--quiet"],
    "siege_shard_scatter_churn": ["--graph", "chung-lu", "--shard", *ADV_SIEGE, *ADV_CHURN, "--rounds", "56",
                                  "--quiet"],
    "siege_local_remat": ["--graph", "chung-lu", "--staircase", *ADV_SIEGE, *ADV_CHURN, "--remat-every", "14",
                          "--rounds", "56", "--quiet"],
    "silent_shard_remat": ["--graph", "chung-lu", "--shard", "--silent-frac", "0.05", *ADV_CHURN, "--remat-every",
                           "8", "--rounds", "24", "--quiet", "--suspicion-window", "6", "--accusation-budget", "0"],
    "siege_to_target": ["--graph", "matching", *ADV_SIEGE, "--max-rounds", "60", "--quiet"],
    "siege_shard_to_target": ["--graph", "chung-lu", "--shard", "--staircase", *ADV_SIEGE, "--max-rounds", "60",
                              "--quiet"],
    "silent_shard_remat_to_target": ["--graph", "chung-lu", "--shard", "--silent-frac", "0.05", *ADV_CHURN,
                                     "--remat-every", "8", "--max-rounds", "40", "--quiet"],
}
ADV_TOML = ('[scenario]\nname = "adv"\n\n[[phase]]\nname = "a"\nstart = 0\nend = {end}\n'
            "accusers = {{frac = 0.05, seed = 1}}\n{extra}")
# tests/sim/test_adversary.py's summary cell: accusers and a blackout at 96 peers, quorum 3 with the settled defaults
ADV_SUMMARY = (dict(end=8, extra="blackout = {frac = 0.1, seed = 2}\n"),
               ["--peers", "96", "--rounds", "16", "--quiet", "--quorum-k", "3", "--graph", "chung-lu", "--digest"])


def adv_toml(path: str, end: int, extra: str) -> str:
    """Write the adversary scenario of ``tests/test_torch_adversary_cli.py``
    to ``path``; returns ``path``."""
    Path(path).write_text(ADV_TOML.format(end=end, extra=extra))
    return path


def adversary_summary_cell() -> dict:
    """:func:`cli_lines` of :data:`ADV_SUMMARY` (its scenario written to a
    temporary file: the summary names the scenario, not the file)."""
    import tempfile

    toml, argv = ADV_SUMMARY
    with tempfile.TemporaryDirectory() as d:
        return cli_lines(True, *argv, "--scenario", adv_toml(f"{d}/adv.toml", **toml))


COMPOSED_PAIR = {"name": "t", "phases": [
    {"name": "lossy", "start": 1, "end": 5, "loss": 0.2, "delay": 0.2},
    {"name": "storm", "start": 5, "end": 9, "churn_leave": 0.05, "churn_join": 0.2,
     "blackout": {"frac": 0.1, "seed": 1}, "join_burst": 2}]}


def control_pairs_case(name: str) -> list:
    """The JAX halves of ``tests/test_torch_control_pairs.py``: each run's
    digests (and, for the acceptance pairs, JAX's reports on its stats), in
    the test's order."""
    from tpu_gossip.control import compile_control
    from tpu_gossip.faults import compile_scenario, parse_scenario, scenario_from_dict
    from tpu_gossip.kernels import liveness as jl
    from tpu_gossip.sim import metrics as JM
    from tpu_gossip.traffic import compile_stream

    from tests.test_torch_slice import ensure_jax_native_pa

    if name == "composed":
        from tpu_gossip.growth import compile_growth, pad_graph_for_growth

        n, cap, rounds = 200, 224, 15
        g, exists = pad_graph_for_growth(control_pa_graph(n), cap)
        cfg, st = _control_swarm(g, exists=exists, msg_slots=8, fanout=2, mode="push_pull", churn_leave_prob=0.01,
                                 churn_join_prob=0.05, rewire_slots=4)
        kw = dict(scenario=compile_scenario(scenario_from_dict(COMPOSED_PAIR), n_peers=n, n_slots=cap,
                                            total_rounds=rounds),
                  growth=compile_growth(n_initial=n, target=cap, n_slots=cap, joins_per_round=2, attach_m=2,
                                        max_join_burst=2),
                  stream=compile_stream(rate=2.0, msg_slots=8, ttl=10, origin_rows=np.arange(n), k_hashes=2),
                  control=compile_control(target_ratio=0.9, fanout=2, lo=1, hi=4, refresh_every=3, ttl=10))
        return [_control_run(cfg, st, rounds, **kw)[0]]
    ensure_jax_native_pa()
    if name == "degraded":
        path, n, rounds, ttl = "scenarios/degraded_under_control.toml", 96, 60, 12
        cfg, st = _control_swarm(control_pa_graph(n, native=True), msg_slots=8, fanout=2, mode="push_pull",
                                 churn_join_prob=0.02, rewire_slots=4)
        sc = compile_scenario(parse_scenario(path), n_peers=n, n_slots=n, total_rounds=rounds)
        strm = compile_stream(rate=1.5, msg_slots=8, ttl=ttl, origin_rows=np.arange(n))
        c = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=4, refresh_every=5, ttl=ttl)
        out = []
        for ctl in (None, c):
            d, stats = _control_run(cfg, st, rounds, scenario=sc, stream=strm, control=ctl)
            out.append({**d, "reliability": JM.reliability_report(stats, target_ratio=0.9, coverage_target=0.95)})
        return out
    if name == "siege":
        path, n, rounds = "scenarios/byzantine_siege.toml", 96, 55
        cfg, st = _control_swarm(control_pa_graph(n, m=2, native=True), msg_slots=8, fanout=2, mode="push_pull",
                                 rewire_slots=6, churn_join_prob=0.02)
        spec = parse_scenario(path)
        spec.validate(total_rounds=rounds, n_peers=n)
        sc = compile_scenario(spec, n_peers=n, n_slots=n, total_rounds=rounds)
        strm = compile_stream(rate=1.5, msg_slots=8, ttl=24, origin_rows=np.arange(n))
        c = compile_control(target_ratio=0.9, fanout=2, lo=1, hi=6, refresh_every=5, ttl=24)
        return [_control_run(cfg, st, rounds, scenario=sc, stream=strm, control=c,
                             liveness=jl.compile_quorum(k, window=4, budget=2))[0] for k in (1, 3)]
    raise KeyError(name)


def _control_run(cfg, state, rounds, **kw):
    """``(digests, host stats)`` of a JAX ``simulate`` on a clone of ``state``."""
    import jax

    from tpu_gossip.core.state import clone_state
    from tpu_gossip.sim.engine import simulate

    fin, stats = simulate(clone_state(state), cfg, rounds, **kw)
    return _digests(fin, stats), jax.device_get(stats)


# tests/test_torch_simnet.py's scripted SimCluster runs: name -> (cluster keywords, peers, ops); an op is
# ("materialize", m, fixed-graph seed or None), ("gossip", peer, text), ("silent", peer, value), ("kill", peer)
# or ("step", rounds)
SIMNET_SCRIPTS = {
    "one_message": (dict(msg_slots=16, fanout=3, seed=0), 500,
                    [("materialize", 3, None), ("gossip", 0, "hello"), ("step", 14)]),
    "several_messages": (dict(msg_slots=32, fanout=2, mode="push_pull", seed=3), 1200,
                         [("materialize", 3, None), ("gossip", 0, "msg-a"), ("gossip", 10, "msg-b"), ("step", 4),
                          ("gossip", 700, "msg-c"), ("gossip", 0, "msg-a"), ("step", 10)]),
    "bloom_k3": (dict(msg_slots=32, fanout=3, seed=1, dedup_hashes=3), 600,
                 [("materialize", 3, None), ("gossip", 0, "alpha"), ("gossip", 5, "beta"), ("step", 6),
                  ("gossip", 9, "gamma"), ("step", 8)]),
    "silent_before_and_after": (dict(msg_slots=8, fanout=3, seed=2), 400,
                                [("silent", 5, True), ("silent", 6, True), ("silent", 6, False),
                                 ("materialize", 3, None), ("silent", 9, True), ("gossip", 0, "x"), ("step", 12)]),
    "kill": (dict(msg_slots=8, fanout=3, seed=4), 400,
             [("materialize", 3, None), ("gossip", 1, "y"), ("step", 3), ("kill", 2), ("kill", 50),
              ("silent", 60, True), ("step", 12)]),
    "fixed_graph": (dict(msg_slots=8, fanout=3, seed=7), 300,
                    [("materialize", 3, 42), ("gossip", 0, "z"), ("step", 10)]),
    "config_kw_flood_sir": (dict(msg_slots=16, fanout=2, mode="flood", seed=5, sir_recover_rounds=4,
                                 timeout_rounds=4), 2000,
                            [("materialize", 2, None), ("gossip", 0, "flood"), ("gossip", 3, "flood-2"),
                             ("step", 10)]),
}


def simnet_addr(i: int) -> tuple:
    """Peer ``i``'s address in the scripted and 1M swarms."""
    return (f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", 9000)


def simnet_fixed_graph(pkg: str, n: int, seed: int):
    """``tests/conformance/test_curves.py::fixed_graph``: a ``use_native=False``
    PA graph (m = 3, ``default_rng(seed)``), built by ``pkg``'s topology."""
    if pkg == "jax":
        from tpu_gossip.core.topology import build_csr, preferential_attachment
    else:
        from tpu_gossip_torch.core.topology import build_csr, preferential_attachment
    return build_csr(n, preferential_attachment(n, m=3, use_native=False, rng=np.random.default_rng(seed)))


def simnet_script(pkg: str, name: str, device: str = "cpu") -> dict:
    """``SIMNET_SCRIPTS[name]`` through ``pkg``'s ``PeerNode(transport="tpu-sim")``
    and ``SimCluster`` (``"jax"`` or ``"torch"``, the port on ``device``):
    each step's stats digest and the state digest after it, then each
    message's coverage and ``has_seen`` at three peers, and every peer's
    ``is_declared_dead``."""
    from tests.test_torch_slice import ensure_jax_native_pa

    ensure_jax_native_pa()
    if pkg == "jax":
        from tpu_gossip.compat.peer import PeerNode
        from tpu_gossip.compat.simnet import SimCluster
        from tpu_gossip.fleet.engine import state_digest, stats_digest

        extra = {}
    else:
        from tpu_gossip_torch.compat.peer import PeerNode
        from tpu_gossip_torch.compat.simnet import SimCluster
        from tpu_gossip_torch.utils.digest import state_digest, stats_digest

        extra = {"device": device}
    kw, n, ops = SIMNET_SCRIPTS[name]
    cluster = SimCluster(**kw, **extra)
    peers = [PeerNode(*simnet_addr(i), transport="tpu-sim", cluster=cluster) for i in range(n)]
    out, texts = {"steps": []}, []
    for op, *args in ops:
        if op == "materialize":
            m, graph_seed = args
            cluster.materialize(m=m, graph=None if graph_seed is None else simnet_fixed_graph(pkg, n, graph_seed))
        elif op == "gossip":
            peers[args[0]].gossip(args[1])
            texts += [args[1]] if args[1] not in texts else []
        elif op == "silent":
            peers[args[0]].set_silent(args[1])
        elif op == "kill":
            cluster.kill(peers[args[0]].addr)
        else:
            stats = cluster.step(args[0])
            out["steps"].append({"stats_digest": stats_digest(stats), "state_digest": state_digest(cluster.state)})
    out["coverage"] = {t: cluster.coverage(t) for t in texts}
    out["has_seen"] = {t: [peers[i].has_seen(t) for i in (0, n // 2, n - 1)] for t in texts}
    out["declared_dead"] = [i for i in range(n) if cluster.is_declared_dead(peers[i].addr)]
    return out


def simnet_curve(n: int, rounds: int, seed: int, origin: int | None = None) -> list:
    """``tests/conformance/test_curves.py::sim_curve`` run by the JAX package
    on :func:`simnet_fixed_graph` (``default_rng(42)``), from the
    highest-degree peer by default: the message's coverage a round (the
    port's twin is ``chip_smoke.py::sim_curve``)."""
    from tpu_gossip.compat.peer import PeerNode
    from tpu_gossip.compat.simnet import SimCluster

    graph = simnet_fixed_graph("jax", n, 42)
    origin = int(np.argmax(graph.degrees)) if origin is None else origin
    cluster = SimCluster(msg_slots=8, fanout=3, seed=seed)
    peers = [PeerNode("10.0.0.1", 9000 + i, transport="tpu-sim", cluster=cluster) for i in range(n)]
    cluster.materialize(graph=graph)
    peers[origin].gossip("conformance-msg")
    curve = []
    for _ in range(rounds):
        cluster.step(1)
        curve.append(cluster.coverage("conformance-msg"))
    return curve


# tests/conformance/test_liveness_band.py's tier-1 runs: name -> (timing scale, quorum k or None, timeout factor)
LIVENESS_BAND = {"reference": (1.0, None, 1), "quorum_2": (0.01, 2, 1), "slow_timeout": (1.0, None, 2)}
LIVENESS_N, LIVENESS_SILENT = 500, 50


def liveness_band_run(pkg: str, name: str) -> dict:
    """``test_liveness_band.py::_detection_round``'s run through ``pkg``'s
    ``ProtocolTiming``, ``simulate`` and quorum detector: the round constants
    the timing maps to, the detection round, the digests and the declared
    rows."""
    scale, quorum_k, slow = LIVENESS_BAND[name]
    if pkg == "jax":
        import jax
        import jax.numpy as jnp

        from tpu_gossip.compat.timing import ProtocolTiming
        from tpu_gossip.core.state import SwarmConfig, init_swarm
        from tpu_gossip.core.topology import build_csr, preferential_attachment
        from tpu_gossip.fleet.engine import state_digest, stats_digest
        from tpu_gossip.kernels.liveness import compile_quorum
        from tpu_gossip.sim.engine import simulate

        key = jax.random.key(0)
    else:
        import torch

        from tpu_gossip_torch.compat.timing import ProtocolTiming
        from tpu_gossip_torch.core import prng
        from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
        from tpu_gossip_torch.core.topology import build_csr, preferential_attachment
        from tpu_gossip_torch.kernels.liveness import compile_quorum
        from tpu_gossip_torch.sim.engine import simulate
        from tpu_gossip_torch.utils.digest import state_digest, stats_digest

        key = prng.key(0, "cpu")
    t = ProtocolTiming().scaled(scale)
    round_s = t.gossip_period
    consts = dict(hb_period_rounds=round(t.heartbeat_period / round_s),
                  timeout_rounds=round(t.heartbeat_timeout / round_s) * slow,
                  detect_period_rounds=round(t.detect_period / round_s))
    cfg = SwarmConfig(n_peers=LIVENESS_N, msg_slots=4, fanout=3, mode="push", round_seconds=round_s, **consts)
    graph = build_csr(LIVENESS_N, preferential_attachment(LIVENESS_N, m=3, use_native=False,
                                                          rng=np.random.default_rng(7)))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    state = init_swarm(graph, cfg, origins=[0], key=key, **kw)
    silent_ids = np.random.default_rng(7).choice(LIVENESS_N, size=LIVENESS_SILENT, replace=False)
    if pkg == "jax":
        state.silent = state.silent.at[jnp.asarray(silent_ids)].set(True)
    else:
        silent = state.silent.clone()
        silent[torch.as_tensor(silent_ids)] = True
        state = dataclasses.replace(state, silent=silent)
    liveness = None if quorum_k is None else compile_quorum(quorum_k, window=4, budget=3)
    fin, stats = simulate(state, cfg, 20 if slow > 1 else 12, liveness=liveness)
    dead = np.asarray(stats.n_declared_dead).tolist()
    hit = [r for r, d in enumerate(dead) if d >= LIVENESS_SILENT]
    return {"consts": consts, "detection_round": hit[0] + 1 if hit else -1, "n_declared_dead": dead,
            "declared": np.flatnonzero(np.asarray(fin.declared_dead)).tolist(),
            "silent": sorted(silent_ids.tolist()), "state_digest": state_digest(fin),
            "stats_digest": stats_digest(stats)}


SIMNET_1M = dict(n=1_000_000, msg_slots=64, fanout=3, mode="push", seed=0, m=3, kill=1000, silence=1000,
                 after=12, victims_seed=1)


def simnet_1m_texts(msg_slots: int = SIMNET_1M["msg_slots"]) -> list:
    """The 1M swarm's three messages: the first the first ``north-star-J``
    hashing to slot 0 (so ``RoundStats.coverage`` is its coverage), then two
    on slots of their own."""
    from tpu_gossip_torch.core.state import message_slot

    first = next(f"north-star-{j}" for j in range(10_000) if message_slot(f"north-star-{j}", msg_slots) == 0)
    return [first, "second-message", "third-message"]


def simnet_1m_victims(c: dict = SIMNET_1M) -> tuple:
    """The 1M swarm's killed and silenced peer ids."""
    v = np.random.default_rng(c["victims_seed"]).choice(c["n"], size=c["kill"] + c["silence"], replace=False)
    return v[:c["kill"]].tolist(), v[c["kill"]:].tolist()


def simnet_1m_pin() -> dict:
    """``chip_smoke.py`` phase 16a's pin: ``SimCluster(msg_slots=64, fanout=3,
    mode="push", seed=0)`` over 1,000,000 ``PeerNode(transport="tpu-sim")``s,
    ``materialize(m=3)`` (the native PA generator, built first), the three
    messages of :func:`simnet_1m_texts` gossiped by the highest-degree peer,
    peer 0 and peer n-1, ``step(R)`` with R the round the first message
    passes 99% (``run_until_coverage`` on a copy), then the victims of
    :func:`simnet_1m_victims` killed and silenced and ``step(12)``."""
    import gc

    from tpu_gossip.compat.peer import PeerNode
    from tpu_gossip.compat.simnet import SimCluster
    from tpu_gossip.core.state import clone_state
    from tpu_gossip.fleet.engine import state_digest, stats_digest
    from tpu_gossip.sim.engine import run_until_coverage

    from tests.test_torch_slice import ensure_jax_native_pa

    import tpu_gossip.native as native

    ensure_jax_native_pa()
    if native._load() is None:
        raise RuntimeError("the 1M pin needs tpu_gossip/native/libtpugossip.so (make -C tpu_gossip/native)")
    c = SIMNET_1M
    cluster = SimCluster(msg_slots=c["msg_slots"], fanout=c["fanout"], mode=c["mode"], seed=c["seed"])
    gc.disable()
    peers = [PeerNode(*simnet_addr(i), transport="tpu-sim", cluster=cluster) for i in range(c["n"])]
    gc.enable()
    cluster.materialize(m=c["m"])
    texts = simnet_1m_texts()
    origins = [int(np.argmax(cluster._graph.degrees)), 0, c["n"] - 1]
    for i, text in zip(origins, texts):
        peers[i].gossip(text)
    probe = run_until_coverage(clone_state(cluster.state), cluster.cfg, 0.99, 200, slot=0)
    rounds = int(probe.round) - int(cluster.state.round)
    del probe
    first = cluster.step(rounds)
    mid = state_digest(cluster.state)
    killed, silenced = simnet_1m_victims()
    for i in killed:
        cluster.kill(peers[i].addr)
    for i in silenced:
        peers[i].set_silent(True)
    second = cluster.step(c["after"])
    return {"source": "JAX_PLATFORMS=cpu python -m tests.jax_pins simnet_1m_pin (JAX package, CPU, the native PA "
                      "generator tpu_gossip/native/libtpugossip.so built)",
            "config": c, "texts": texts, "origins": origins, "rounds": rounds,
            "curve": np.asarray(first.coverage).tolist(),
            "steps": [{"stats_digest": stats_digest(first), "state_digest": mid},
                      {"stats_digest": stats_digest(second), "state_digest": state_digest(cluster.state)}],
            "declared_dead": sum(cluster.is_declared_dead(peers[i].addr) for i in killed + silenced),
            "coverage": [cluster.coverage(t) for t in texts]}


CONTROL_PAIRS = ["composed", "degraded", "siege"]
CONTROL_RUNS = ["zero_exactly_k_push", "zero_exactly_k_push_pull", "zero_staircase_matching", "bucketed_active_s1",
                "bucketed_active_s3", "controlled_exactly_k_cap0", "controlled_exactly_k_cap64",
                "controlled_staircase_matching"]


# the pinned runs, by group: name -> (function, arguments)

# ------------------------------------------------------------ the analysis tier (tests/test_torch_analysis_*.py)

def _jax_spec(leaf) -> list:
    """[shape, dtype] of one abstract JAX leaf; a PRNG key's dtype is "key"."""
    import jax

    dt = "key" if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key) else str(leaf.dtype)
    return [list(leaf.shape), dt]


def analysis_entry_names() -> list:
    """The JAX tier's entry matrix names (8 forced host devices)."""
    from tpu_gossip.analysis.entrypoints import entry_points

    return [ep.name for ep in entry_points()]


def analysis_contracts() -> dict:
    """Each entry's output contract from ``jax.make_jaxpr(...,
    return_shape=True)`` (the JAX tier's shared trace): the state's fields
    as [shape, dtype] (static fields as their value), the stats' and the
    ICI counters' fields."""
    import dataclasses as dc

    from tpu_gossip.analysis.entrypoints import entry_points, trace_matrix

    out = {}
    for name, te in trace_matrix(entry_points()).items():
        ep, res = te.ep, te.out_shape
        if te.error is not None:
            out[name] = {"error": te.error}
            continue
        ici = None
        if ep.has_ici:
            st, stats, ici = res
        elif ep.stats_leading is None:
            st, stats = res, None
        else:
            st, stats = res
        state = {}
        for f in dc.fields(st):
            v = getattr(st, f.name)
            state[f.name] = _jax_spec(v) if hasattr(v, "dtype") else v
        out[name] = {"state": state,
                     "stats": None if stats is None else {f: _jax_spec(getattr(stats, f)) for f in stats._fields},
                     "ici": None if ici is None else {f: _jax_spec(getattr(ici, f)) for f in ici._fields}}
    return out


def analysis_planes() -> list:
    """``core.state.PLANES`` as [name, dtype, shape, packed]."""
    from tpu_gossip.core.state import PLANES

    return [[p.name, p.dtype, p.shape, p.packed] for p in PLANES]


def analysis_wire() -> dict:
    """``mem/wire.py``'s report on the dense mesh entries: the declared and
    the traced all_to_all words of ``collective_census``."""
    from tpu_gossip.analysis.entrypoints import entry_points, trace_matrix
    from tpu_gossip.analysis.mem.wire import _WIRE_ENTRIES, wire_findings

    traced = trace_matrix([ep for ep in entry_points() if ep.name in _WIRE_ENTRIES])
    _, report = wire_findings(traced)
    return {name: {"declared_words": r["declared_words"], "traced_words": r["traced_words"]}
            for name, r in report.items()}


CASES = {
    "pipeline": {
        **{f"bucketed_{mode}{'_composed' if composed else ''}_{depth}": ("bucketed_run", [mode, composed, depth])
           for mode, composed, depth in (("push", False, 1), ("push_pull", False, 1), ("push_pull", True, None),
                                         ("push_pull", True, 1))},
        "flood_6": ("local_pipeline_run", [300, 2, 0, 1, [0], "flood", 4, 6, 1]),
        "matching_6": ("matching_pipeline_run", [800, 8, 3, 6, 1]),
        "continuation_5": ("local_pipeline_run", [240, 3, 2, 4, [1], "push_pull", 4, 5, 1]),
        "coverage": ("local_pipeline_coverage", [400, 3, 3, 5, [0]]),
        "serial_tail": ("local_pipeline_run", [150, 3, 11, 2, [0], "push", 4, 5, 1, 0.0, 6, False, False, 2, None]),
        "expired": ("local_pipeline_run", [200, 3, 13, 6, [0, 1, 2], "push_pull", 4, 14, 1, 1.0, 6]),
    },
    "mesh": {
        **{f"s{s}": ("matching_mesh_run", [1200, s, "push_pull", 8, "dense", False, "", None, "local", True])
           for s in (2, 4, 8)},
        "s8_push": ("matching_mesh_run", [1200, 8, "push", 8, "dense", False, "", None, "local", True]),
        "s8_flood": ("matching_mesh_run", [1200, 8, "flood", 8, "dense", False, "", None, "local", True]),
        "s8_sparse": ("matching_mesh_run", [1200, 8, "push_pull", 8, "sparse", False, "", None, "local", True]),
        "s4_auto": ("matching_mesh_run", [1200, 4, "push_pull", 8, "auto", False, "", None, "local", True]),
        "s8_packed_sparse": ("matching_mesh_run", [1200, 8, "push_pull", 8, "sparse", True, "", None, "local", True]),
        "s8_dist": ("matching_mesh_run", [1200, 8, "push_pull", 8, "dense", False, "", None, "dist", False]),
        **{f"s4_{plane}": ("matching_mesh_run", [1200, 4, "push_pull", 8, "dense", False, plane, None, "local", False])
           for plane in ("churn", "scenario", "quorum", "growth", "stream", "control")},
        "s4_pipeline": ("matching_mesh_run", [1200, 4, "push_pull", 8, "dense", False, "", 1, "local", False]),
    },
    "mesh_cli": {name: ("cli_mesh", [2, *argv]) for name, argv in MESH_CLI.items()},
    # the word tail's two JAX forms on K4's grid (tests/test_torch_tail_words.py)
    "tail_words": {f"m{m}_fo{int(fo)}_sir{sir}": ("word_tail_digests", [m, fo, sir])
                   for m in (16, 13, 1, 17) for fo in (False, True) for sir in (0, 4)},
    # the JAX halves of tests/test_torch_mesh.py (no mesh)
    "mesh_facts": {
        "tables_s8_auto": ("transport_tables", [1500, 8, "auto", 1 / 32]),
        "tables_s2_sparse_frac8": ("transport_tables", [1500, 2, "sparse", 1 / 8]),
        "ici_s1_m16": ("ici_counter_cases", [1500, 1, 16]),
        "ici_s8_m12": ("ici_counter_cases", [1500, 8, 12]),
        "block_keys_s4": ("sharded_plan_digests", [1500, 4, 1, 5, True, False, 7]),
        "block_keys_s8": ("sharded_plan_digests", [1500, 8, 1, 5, True, True, 3]),
        "totals": ("ici_totals_fold", [[[v * (i + 1) for v in (2**25 + 3, 5, 7, 1, 2, 0, 0)] for i in range(40)]]),
    },
    # the timing-free shapes the profile tests compare (no mesh)
    "profile": {
        "stage_keys_500": ("profile_stage_keys", [500, [[["reference", "fused", "pallas"], None],
                                                        [["reference", "fused"], [8, 1024, 1, 128]]]]),
        "cli_500": ("cli_profile_shape", ["--peers", "500", "--graph", "matching", "--mode", "push_pull", "--fanout",
                                          "1", "--profile-round", "2"]),
        "composed_300": ("cli_profile_shape", PROFILE_COMPOSED),
    },
    "stream_cli": {**{name: ("cli_lines", [False, *argv]) for name, argv in STREAM_ENGINES.items()},
                   **{name: ("cli_lines", [True, *argv]) for name, argv in STREAM_ENGINES_ONE_SHARD.items()},
                   **{f"scenario_{name}": ("cli_lines", [True, *argv]) for name, argv in STREAM_SCENARIOS.items()}},
    # the JAX halves of tests/test_torch_control_runs.py
    "control_runs": {name: ("control_runs_case", [name]) for name in CONTROL_RUNS},
    # the JAX halves of tests/test_torch_staircase.py's runs and
    # tests/test_torch_growth_cli_engines.py's engines (the mesh on one device)
    "staircase": {name: ("staircase_simulate", [name]) for name in
                  ("xla_push_f3", "xla_push_pull_f1", "xla_flood", "staircase_push_pull_f1", "staircase_flood",
                   "staircase_push_f2_forward_once_sir")},
    "growth_cli": {name: ("cli_lines", [True, *argv, *GROWTH_HORIZON]) for name, argv in GROWTH_ENGINES.items()},
    # the JAX halves of tests/test_torch_packed_engine.py
    "packed_engine": {**{name: ("packed_simulate", [name]) for name in PACKED_RUNS},
                      **{f"coverage_{g}": ("packed_coverage", [g]) for g in ("matching", "xla")}},
    # the JAX halves of tests/test_torch_control_cli*.py (the mesh pinned to one device)
    "control_cli": {name: ("cli_lines", [True, *digest_argv(argv)])
                    for name, argv in {**CONTROL_CLI_LOCAL, **CONTROL_CLI_MESH}.items()},
    # the JAX halves of tests/test_torch_adversary_cli.py (its mesh pinned to one device)
    "adversary_cli": {**{name: ("cli_lines", [True, *ADV_BASE, *argv]) for name, argv in ADV_PATHS.items()},
                      "summary_cell": ("adversary_summary_cell", [])},
    # the JAX halves of tests/test_torch_control_pairs.py
    "control_pairs": {name: ("control_pairs_case", [name]) for name in CONTROL_PAIRS},
    # the serving plane (tests/test_torch_serve_*.py): the ingest rules, each
    # engine's CLI on scripted windows, the refusals
    "serve": {
        "ingest_rules": ("ingest_rules", []),
        **{name: ("serve_scripted", [shards, SERVE_SEED, *argv]) for name, (shards, argv) in SERVE_ENGINES.items()},
        "refusals": ("serve_refusals", [SERVE_REFUSED]),
    },
    # the tpu-sim transport (tests/test_torch_simnet.py, tests/test_torch_conformance.py): the scripted
    # SimCluster runs, the 40-peer conformance curves and the liveness band's tier-1 runs
    "simnet": {
        **{name: ("simnet_script", ["jax", name]) for name in SIMNET_SCRIPTS},
        **{f"curve_40_s{s}": ("simnet_curve", [40, 25, s]) for s in (0, 1, 2)},
        "curve_40_s7_origin0": ("simnet_curve", [40, 10, 7, 0]),
        **{f"liveness_{name}": ("liveness_band_run", ["jax", name]) for name in LIVENESS_BAND},
    },
    # the JAX half of tests/test_torch_packed.py's codec test
    "packed_codec": {str(m): ("codec_case", [m]) for m in CODEC_MS},
    # the JAX halves of tests/test_torch_fold_classes.py (K2's whole-plan fold)
    "fold_classes": {f"{case}-{op}": ("fold_classes_case", [case, op]) for case in FOLD_CLASSES_CASES
                     for op in ("or", "sum")},
    # the JAX halves of tests/test_torch_stream_runs.py (the local engine and the bucketed mesh at S = 1, 3)
    "stream_runs": {name: ("stream_runs_case", [name]) for name in
                    ["until_coverage", "conflation_k1", "bloom_k2", "band_k1", "steady_report", "saturation_0.5",
                     "saturation_8.0", "bucketed_s1", "bucketed_s3"]},
    # the JAX halves of tests/test_torch_stream_matching.py (the local engine)
    "stream_matching": {name: ("stream_matching_case", list(args)) for name, args in STREAM_MATCHING.items()},
    # tests/test_torch_cluster.py's cells and tests/test_torch_cluster_procs.py's runs
    "cluster": {
        "bucketed_flat": ("cluster_bucketed", [1, "dense"]),
        "bucketed_hier": ("cluster_bucketed", [2, "hier"]),
        "matching_local": ("cluster_matching", [5, 0]),
        "matching_hier": ("cluster_matching", [5, 2]),
        "matching_packed_hier": ("cluster_matching", [6, 2, True]),
        "composed_local": ("cluster_composed", []),
        **{f"cli_{name}": ("cli_cluster", [shards, *argv]) for name, (shards, argv) in CLUSTER_CLI.items()},
        **{f"planes_{name}": ("cli_cluster", [shards, *argv]) for name, (shards, argv) in CLUSTER_PLANES.items()},
        "serve_coordinator": ("serve_cli", [1, [], False, *SERVE_COORDINATOR]),
    },
    # the JAX halves of tests/test_torch_growth_runs.py's growing runs
    "growth_runs": {name: ("growth_runs_case", [name]) for name in
                    ("admits", "preferential", "zero_exhausted", "wave", "storm", "composes", "credit",
                     "to_coverage")},
    # the JAX analysis tier's matrix, contracts, plane registry and wire
    # census (8 forced host devices), for tests/test_torch_analysis_*.py
    "analysis": {"entry_names": ("analysis_entry_names", []), "contracts": ("analysis_contracts", []),
                 "planes": ("analysis_planes", []), "wire": ("analysis_wire", [])},
    "fleet": {
        "composed": ("campaign_run", [composed_campaign(), [0, 7, 13]]),
        "mix": ("campaign_run", [MIX_CAMPAIGN, [], "scenarios/campaigns"]),
        "siege": ("campaign_run", [SIEGE_CAMPAIGN, [1]]),
        "catalogue": ("campaign_file_run", ["scenarios/campaigns/catalogue_smoke.toml"]),
    },
}
PINS_FILE = Path(__file__).with_name("jax_pins.json")


def compute(group: str, names=None) -> dict:
    """The cases ``names`` of ``group`` (every case by default) computed by
    the JAX package."""
    return {name: globals()[fn](*args) for name, (fn, args) in CASES[group].items() if names is None or name in names}


def pinned(group: str, name: str):
    """One case's pinned JAX result."""
    return json.loads(PINS_FILE.read_text())[group][name]


def write(*groups: str) -> dict:
    """Recompute ``groups`` (every group by default) and write
    ``tests/jax_pins.json``."""
    pins = json.loads(PINS_FILE.read_text()) if PINS_FILE.exists() else {}
    pins.update({group: compute(group) for group in groups or CASES})
    PINS_FILE.write_text(json.dumps(pins, indent=1, sort_keys=True) + "\n")
    return {group: sorted(v) for group, v in pins.items()}


if __name__ == "__main__":
    fn = globals()[sys.argv[1]]
    print(json.dumps(fn(*sys.argv[2:])))
