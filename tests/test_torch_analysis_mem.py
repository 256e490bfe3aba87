"""The port's memory tier (``tpu_gossip_torch/analysis/mem``) and its op
recorder (``analysis/optrace.py``): the plane registry against JAX's
``PLANES``, the width and widening-cast findings on fixtures that fire,
``mem-hot-clone``, the budget round trip through ``--write-budget``, the
dense wire census against ``dense_wire_words`` and JAX's census pinned in
``tests/jax_pins.json`` (group ``analysis``), the recorder's private-API
behaviour pinned, and the tier clean on the port's tree (the matrix in
four slices)."""

import dataclasses
import gc

import pytest
import torch

from tests import jax_pins
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.analysis import entrypoints, optrace
from tpu_gossip_torch.analysis.entrypoints import RanEntry, entry_points, run_matrix
from tpu_gossip_torch.analysis.mem import budget, ledger, run_mem, widths, wire

NAMES = [ep.name for ep in entry_points()]
EP = {ep.name: ep for ep in entry_points()}


def test_planes_equal_jax():
    from tpu_gossip_torch.core.state import PLANES

    assert [[p.name, p.dtype, p.shape, p.packed] for p in PLANES] == jax_pins.pinned("analysis", "planes")


def test_recorder_sees_aten_ops_storages_and_frees():
    """The private-API behaviour the recorder rests on: the dispatch mode
    sees each aten op with its tensors, a view shares its base's storage
    object, and a storage's finaliser runs when its last tensor goes."""
    x = torch.arange(8, dtype=torch.int32)
    with optrace.record_ops(x) as rec:
        y = x + 1
        v = y.view(2, 4)
        z = (v * 2).sum()
        del y, v
        gc.collect()
    ops = [e.op for e in rec.events]
    assert ops[:2] == ["aten.add.Tensor", "aten.view.default"] and "aten.sum.default" in ops
    add, view = rec.events[0], rec.events[1]
    assert add.inputs == (((8,), "int32"),) and add.outputs == (((8,), "int32"),) and len(add.new_storages) == 1
    assert view.new_storages == () and view.in_storages == add.new_storages
    assert rec.state_bytes == 32 and rec.peak_bytes >= 32 + 32 + 32
    assert rec.live_at_exit == int(z.untyped_storage().nbytes())  # y's storage was freed
    assert add.src == "" and rec.const_bytes == 0  # issued from outside the package


def test_mem_tier_runs_on_the_cpu_only():
    with pytest.raises(ValueError, match="CPU only"):
        run_mem("meta")


def _entry(name, state, record=None, out=None):
    return RanEntry(ep=EP[name], state=state, out=out, record=record)


def test_widened_plane_is_a_finding():
    fn, st = EP["local[xla,push,m=1]"].build("cpu")
    wide = dataclasses.replace(st, join_round=st.join_round.to(torch.int32))
    found = widths.plane_width_findings({"x": _entry("local[xla,push,m=1]", wide, out=(wide, None))})
    assert [f.rule for f in found] == ["mem-plane-width"] and "join_round materialises int32: WIDER" in \
        found[0].message


def test_widening_cast_fixture_fires():
    fn, st = EP["local[xla,push,m=1]"].build("cpu")
    with optrace.record_ops(st) as rec:
        wide = st.admitted_by.to(torch.int64) + 1
        narrow = st.seen.to(torch.int32)  # bool to int: a mask, exempt
        small = st.round.to(torch.int64)  # below N elements: exempt
    del wide, narrow, small
    found = widths.widening_cast_findings({"fx": _entry("local[xla,push,m=1]", st, rec)})
    assert [f.rule for f in found] == ["mem-widening-cast"]
    assert "int32->int64 on a (513,) operand" in found[0].message


def test_clone_in_a_round_is_a_finding(monkeypatch):
    from tpu_gossip_torch.core.state import clone_state
    from tpu_gossip_torch.sim import engine

    real = engine.gossip_round
    monkeypatch.setattr(engine, "gossip_round", lambda s, cfg, plan=None, **kw: real(clone_state(s), cfg, plan, **kw))
    ran = run_matrix([EP["local[xla,push,m=1]"]], "cpu", record=True)
    found, ledgers = ledger.ledger_findings(ran)
    assert [f.rule for f in found] == ["mem-hot-clone"] and "local[xla,push,m=1]" in ledgers


def test_budget_round_trip_through_the_cli(tmp_path, monkeypatch, capsys):
    from tpu_gossip_torch.analysis.cli import main

    few = tuple(EP[n] for n in ("local[matching,push_pull,m=16]", "dist[bucketed]", "local[simulate,packed]"))
    monkeypatch.setattr(entrypoints, "entry_points", lambda: few)
    path = tmp_path / "budget.toml"
    assert main(["--device", "cpu", "--write-budget", "--budget", str(path)]) == 0
    pinned = budget.load_budget(path)
    assert sorted(pinned) == sorted(ep.name for ep in few)
    assert main(["--device", "cpu", "--mem-only", "--budget", str(path)]) == 0
    shrunk = {n: dict(v, peak_bytes=int(v["peak_bytes"] * 0.9)) for n, v in pinned.items() if n != "dist[bucketed]"}
    text = path.read_text()
    budget_lines = [ledger.EntryLedger(name=n, n_peers=v["n_peers"], state_bytes=0, const_bytes=v["const_bytes"],
                                       peak_bytes=v["peak_bytes"], top=[]) for n, v in shrunk.items()]
    budget.write_budget(path, {led.name: led for led in budget_lines})
    assert main(["--device", "cpu", "--mem-only", "--budget", str(path), "--json"]) == 1
    out = capsys.readouterr().out
    assert out.count('"mem-budget-regression"') == 2 and out.count('"mem-budget-missing"') == 1
    assert text.startswith("# The port's memory budget")


def test_the_committed_budget_prices_every_entry():
    assert sorted(budget.load_budget(budget.DEFAULT_BUDGET)) == sorted(NAMES)
    assert budget.TOLERANCE == 0.05


def test_wire_census_equals_the_model_and_jax():
    """One round of each dense mesh entry through the counted all_to_all:
    the bucketed engine ships exactly ``dense_wire_words``, the counter's
    dense words and JAX's census; the matching engine's declaration and
    counter equal JAX's, its K1 int32 lane words ship twice that at M = 16
    (the drift ROADMAP section 3 records, pragma'd at its declaration)."""
    found, report = wire.wire_findings(entry_points(), "cpu")
    assert found == []
    pins = jax_pins.pinned("analysis", "wire")
    assert sorted(report) == sorted(pins) == sorted(wire.WIRE_ENTRIES)
    for name, got in report.items():
        want = pins[name]
        assert got["declared_words"] == got["ici_dense_words"] == want["declared_words"] == want["traced_words"]
        factor = 2 if wire.WIRE_ENTRIES[name] == "matching" else 1
        assert got["census_words"] == factor * want["traced_words"], name


def test_wire_drift_is_reported(monkeypatch):
    from tpu_gossip_torch.dist import mesh

    real = mesh.dense_wire_words
    monkeypatch.setattr(mesh, "dense_wire_words", lambda *a, **k: real(*a, **k) - 1)
    found, _ = wire.wire_findings([EP["dist[bucketed]"]], "cpu")
    assert [f.rule for f in found] == ["mem-wire-drift"] and found[0].file == "tpu_gossip_torch/dist/mesh.py"


@pytest.mark.parametrize("part", range(4))
def test_mem_tier_is_clean_on_the_tree(part):
    names = NAMES[part::4]
    found, report = run_mem("cpu", names=names)
    assert found == [], "\n".join(f.render() for f in found)
    assert sorted(report["entries"]) == sorted(names)
