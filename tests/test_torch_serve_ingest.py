"""The ingest stage's rules (``tests/serve/test_ingest.py``) in the port on
the CPU: each case's round held to the JAX package's state and stats
digests, pinned in ``tests/jax_pins.json`` (group ``serve``, case
``ingest_rules``; ``test_torch_serve_cli.py`` recomputes the group in a
child process), plus the rule each case names. No JAX program is compiled
in this process."""

import numpy as np
import pytest
import torch

from tests.jax_pins import INGEST_M, INGEST_N, ingest_cases, pinned
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip.traffic import ingest as jingest
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
from tpu_gossip_torch.core.packed import pack_state, unpack_state
from tpu_gossip_torch.core.state import SwarmConfig, init_swarm, message_slots
from tpu_gossip_torch.sim.engine import _stack, gossip_round, run_until_coverage, simulate
from tpu_gossip_torch.traffic.ingest import IngestError, IngestPlan, InjectBatch, empty_batch, make_batch
from tpu_gossip_torch.utils.digest import state_digest, stats_digest

CASES = list(ingest_cases(INGEST_N, message_slots))


@pytest.fixture(scope="module")
def ctx():
    dg = device_powerlaw_graph(INGEST_N, gamma=2.5, key=prng.key(0, "cpu"), device="cpu")
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=INGEST_M, fanout=3, mode="push")
    state = init_swarm(dg.as_padded_graph(), cfg, key=prng.key(0, "cpu"), origins=np.array([0]), exists=dg.exists,
                       device="cpu")
    return cfg, state, dg, ingest_cases(int(dg.n_pad), message_slots)


def _batch(case):
    origins, hashes, overflow, k, _ = case
    plan = IngestPlan(msg_slots=INGEST_M, max_inject=4, k_hashes=k)
    return empty_batch(plan, "cpu") if origins is None else make_batch(plan, origins, hashes, overflow=overflow,
                                                                       device="cpu")


def _round(ctx, name):
    cfg, state, _, cases = ctx
    packed = cases[name][4]
    fin, stats = gossip_round(pack_state(state) if packed else state, cfg, inject=_batch(cases[name]))
    return (unpack_state(fin) if packed else fin), stats


@pytest.mark.parametrize("name", CASES)
def test_rule_equals_jax(ctx, name):
    """The round's digests equal JAX's, and the rule holds."""
    cfg, state, dg, cases = ctx
    fin, stats = _round(ctx, name)
    want = pinned("serve", "ingest_rules")[name]
    assert state_digest(fin) == want["state_digest"]
    assert stats_digest(_stack([stats])) == want["stats_digest"]
    got = [int(getattr(stats, f"ingest_{c}")) for c in ("offered", "injected", "conflated", "overflow")]
    assert got == want["ingest"]
    origins, hashes, _, k, packed = cases[name]
    if name == "zero_batch":
        base, base_stats = gossip_round(state, cfg)
        assert state_digest(base) == state_digest(fin)
        assert stats_digest(_stack([base_stats])) == stats_digest(_stack([stats]))
    elif name == "overflow_billed":
        assert got[0] == 1 and got[3] == 5
    elif name in ("land_and_latch", "k2_bloom_planes", "packed_parity"):
        assert got[1] == len(origins) and got[2] == 0
        for row, h in zip(origins, hashes):
            for s in message_slots(h, INGEST_M, k):
                assert bool(fin.seen[row, s]) and int(fin.infected_round[row, s]) >= 0 and int(fin.slot_lease[s]) >= 0
        if packed:
            plain, _ = gossip_round(state, cfg, inject=_batch(cases[name]))
            assert state_digest(plain) == state_digest(fin)
    elif name == "dead_origin":
        assert not bool(dg.exists[origins[0]]) and got[:2] == [1, 0]
        assert not bool(fin.seen[origins[0], message_slots(hashes[0], INGEST_M, 1)[0]])
    elif name == "same_slot_conflates":
        assert got[1:3] == [2, 1]
    elif name == "next_round_transmit":
        s = message_slots(hashes[0], INGEST_M, 1)[0]
        if s != 0:
            assert int((fin.seen[:, s] & fin.alive).sum()) == 1


def test_plan_and_batch_refusals_equal_jax():
    for kw in (dict(msg_slots=8, max_inject=0), dict(msg_slots=8, max_inject=4, k_hashes=9)):
        with pytest.raises(jingest.IngestError) as want:
            jingest.IngestPlan(**kw)
        with pytest.raises(IngestError) as got:
            IngestPlan(**kw)
        assert str(got.value) == str(want.value)
    plan = IngestPlan(msg_slots=8, max_inject=4)
    with pytest.raises(IngestError, match="exceed max_inject=4"):
        make_batch(plan, list(range(5)), list(range(5)), device="cpu")
    with pytest.raises(IngestError, match="parallel 1-D"):
        make_batch(plan, [1, 2], [3], device="cpu")
    with pytest.raises(TypeError, match="InjectBatch"):
        gossip_round(*_tiny(), inject=object())


def _tiny():
    dg = device_powerlaw_graph(40, gamma=2.5, key=prng.key(1, "cpu"), device="cpu")
    cfg = SwarmConfig(n_peers=dg.n_pad, msg_slots=4, fanout=2, mode="push_pull")
    return init_swarm(dg.as_padded_graph(), cfg, key=prng.key(1, "cpu"), origins=np.array([0]), exists=dg.exists,
                      device="cpu"), cfg


def test_dead_entries_past_count_are_not_read(ctx):
    """Entries at index >= count change nothing: a batch whose padding
    holds live rows and slots lands as the zero-padded one."""
    cfg, state, _, cases = ctx
    padded = _batch(cases["land_and_latch"])
    dirty = InjectBatch(origins=torch.tensor([2, 3, 4, 5], dtype=torch.int32),
                        slots=torch.cat([padded.slots[:3], torch.tensor([[1]], dtype=torch.int32)]), count=3,
                        overflow=0)
    a, sa = gossip_round(state, cfg, inject=padded)
    b, sb = gossip_round(state, cfg, inject=dirty)
    assert state_digest(a) == state_digest(b) and stats_digest(_stack([sa])) == stats_digest(_stack([sb]))


def test_simulate_lands_one_batch_a_round(ctx):
    """``simulate(inject=[...])`` (JAX's stacked batch) equals the round
    loop; a run to coverage takes no batches, as JAX's takes none."""
    cfg, state, _, cases = ctx
    batches = [_batch(cases[n]) for n in ("land_and_latch", "zero_batch", "same_slot_conflates")]
    fin, stats = simulate(state, cfg, 3, inject=batches)
    s, rows = state, []
    for b in batches:
        s, st = gossip_round(s, cfg, inject=b)
        rows.append(st)
    assert state_digest(fin) == state_digest(s) and stats_digest(stats) == stats_digest(_stack(rows))
    assert stats.ingest_offered.tolist() == [3, 0, 2]
    with pytest.raises(ValueError, match="2 batches for 3 rounds"):
        simulate(state, cfg, 3, inject=batches[:2])
    with pytest.raises(TypeError, match="no serving batches"):
        run_until_coverage(state, cfg, inject=batches[0])
