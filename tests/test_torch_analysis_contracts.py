"""The port's entry matrix and contract audit (``tpu_gossip_torch/analysis``)
against the JAX analysis tier: the same entry names, each entry's output
contract (the state's planes, ``RoundStats``, the ICI counters) equal to
the JAX tier's ``make_jaxpr`` output shapes pinned in
``tests/jax_pins.json`` (group ``analysis``), the whole matrix clean on
the CPU, and a deliberately broken entry reported."""

import dataclasses

import pytest
import torch

from tests import jax_pins
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.analysis import contracts
from tpu_gossip_torch.analysis.entrypoints import entry_points, run_matrix

NAMES = [ep.name for ep in entry_points()]


@pytest.fixture(scope="module")
def ran():
    return run_matrix(entry_points(), "cpu")


def test_entry_names_equal_jax():
    """Every JAX entry has its port twin under the same name, in the same
    order; the port excludes none."""
    assert NAMES == jax_pins.pinned("analysis", "entry_names")


def test_matrix_is_clean_on_the_cpu(ran):
    problems = [p for r in ran.values() for p in contracts.check_entry(r)]
    assert problems == []


def _port_leaf(name: str, leaf, want):
    """A port leaf as the JAX pin writes it: the key's int64 (..., 2)
    threefry words are JAX's key<fry> (...)."""
    shape, dtype = list(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    if name == "rng" and want[1] == "key":
        assert dtype == "int64" and shape[-1] == 2
        return [shape[:-1], "key"]
    return [shape, dtype]


@pytest.mark.parametrize("name", NAMES)
def test_contract_equals_jax(ran, name):
    """The port's output state, stats and ICI counters against JAX's abstract
    outputs: same fields, shapes and dtypes (bool as bool, int8/16/32 at
    the same width); the ICI counters are the port's int64 where JAX's
    are int32, as ``dist/transport.py::IciRound`` declares."""
    want, r = jax_pins.pinned("analysis", "contracts")[name], ran[name]
    assert r.error is None, r.error
    out = r.out
    if want["ici"] is not None:
        st, stats, ici = out
    elif want["stats"] is None:
        st, stats, ici = out, None, None
    else:
        (st, stats), ici = out, None
    got_state = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        got_state[f.name] = _port_leaf(f.name, v, want["state"][f.name]) if isinstance(v, torch.Tensor) else v
    assert got_state == want["state"]
    assert (stats is None) == (want["stats"] is None)
    if stats is not None:
        assert {f: _port_leaf(f, getattr(stats, f), want["stats"][f]) for f in stats._fields} == want["stats"]
    if ici is not None:
        got = {f: _port_leaf(f, getattr(ici, f), want["ici"][f]) for f in ici._fields}
        assert {f: [s, "int32" if d == "int64" else d] for f, (s, d) in got.items()} == want["ici"]


def test_broken_round_is_reported(monkeypatch):
    """A round that widens a plane, and one that drops a stats field, each
    give a contract-audit finding on the entries they break."""
    from tpu_gossip_torch.sim import engine

    real = engine.gossip_round

    def widened(state, cfg, plan=None, **kw):
        new, stats = real(state, cfg, plan, **kw)
        return dataclasses.replace(new, join_round=new.join_round.to(torch.int32)), stats

    monkeypatch.setattr(engine, "gossip_round", widened)
    found = contracts.audit_contracts("cpu", names=["local[xla,push,m=1]", "dist[bucketed]"])
    assert [f.rule for f in found] == ["contract-audit"]
    assert "join_round" in found[0].message and found[0].qualname == "gossip_round_local.local[xla,push,m=1]"

    def stats_short(state, cfg, plan=None, **kw):
        new, stats = real(state, cfg, plan, **kw)
        return new, stats._replace(slot_age=stats.slot_age[:1])

    monkeypatch.setattr(engine, "gossip_round", stats_short)
    found = contracts.audit_contracts("cpu", names=["local[matching,push,m=16]"])
    assert len(found) == 1 and "RoundStats.slot_age shape (1,)" in found[0].message


def test_failing_entry_is_a_finding(monkeypatch):
    from tpu_gossip_torch.dist import mesh

    def boom(*a, **k):
        raise RuntimeError("exchange lost")

    monkeypatch.setattr(mesh, "gossip_round_dist", boom)
    found = contracts.audit_contracts("cpu", names=["dist[matching,sparse]"])
    assert len(found) == 1 and "exchange lost" in found[0].message


def test_analysis_pins_are_current():
    """The names and the plane registry, recomputed by the JAX package in a
    child process on 8 forced host devices, equal the pins."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    got = jax_in_child("tests.jax_pins", "compute", "analysis", ["entry_names", "planes"])
    assert got == {k: jax_pins.pinned("analysis", k) for k in ("entry_names", "planes")}
