"""The JAX package's halves of the pipelined-round and fleet comparisons,
as JSON-able results. Each function builds its run from plain arguments,
so the port's test builds the same run from the same arguments.

:data:`CASES` names the runs the port's tests compare with; their results
are pinned in ``tests/jax_pins.json`` (so a test compares the port's run
with the pin, in its own process), and ``test_jax_pins_are_current`` of
each group recomputes the group here in a child process
(``tests.test_torch_growth_cli_engines.jax_in_child``) and holds it to the
file. The pins of ``tpu_gossip_torch/reference_pins.json`` that
``chip_smoke.py`` runs on the card come from here too::

    JAX_PLATFORMS=cpu python -m tests.jax_pins write        # tests/jax_pins.json
    JAX_PLATFORMS=cpu python -m tests.jax_pins bucketed_pipeline_1m
    JAX_PLATFORMS=cpu python -m tests.jax_pins cli_pin ARGV...
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np


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


def bucketed_pipeline_1m(n: int = 1_000_000, rounds: int = 48) -> dict:
    """``bench.py::bench_pipeline``'s comparison on the one-process
    bucketed mesh: the 1M device power-law graph (``key(0)``, gamma 2.5)
    exported and partitioned over one shard, push_pull fanout 1, 16
    slots, one origin drawn by ``default_rng(0)``, ``rounds`` rounds
    pipelined at depth 1; the digests, rounds to 99% and final coverage."""
    import jax

    from tpu_gossip.core.device_topology import device_powerlaw_graph
    from tpu_gossip.core.state import SwarmConfig
    from tpu_gossip.dist import init_sharded_swarm, make_mesh, partition_graph, shard_swarm, simulate_dist
    from tpu_gossip.sim import metrics as M
    from tpu_gossip.sim.stages import compile_pipeline

    graph = device_powerlaw_graph(n, gamma=2.5, key=jax.random.key(0)).to_host_graph()
    mesh = make_mesh(1)
    sg, rel, pos = partition_graph(graph, 1, seed=0)
    cfg = SwarmConfig(n_peers=sg.n_pad, msg_slots=16, fanout=1, mode="push_pull")
    origins = np.random.default_rng(0).choice(sg.n, size=1, replace=False)
    st = shard_swarm(init_sharded_swarm(sg, rel, pos, cfg, key=jax.random.key(0), origins=origins), mesh)
    fin, stats = simulate_dist(st, cfg, sg, mesh, rounds, pipeline=compile_pipeline(1))
    return {**_digests(fin, stats), "rounds_to_target": M.rounds_to_coverage(stats, 0.99),
            "final_coverage": float(np.asarray(stats.coverage)[-1])}


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


# the pinned runs, by group: name -> (function, arguments)
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
