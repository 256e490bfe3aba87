"""The port's graftlint AST tier (``tpu_gossip_torch/analysis``): each rule
on a fixture that breaks it and on one that keeps it, the pragma hygiene
findings, the CLI's exit codes, and the port's own tree lint-clean with
the empty baseline. Fixture sources are written under ``tmp_path`` as
``tpu_gossip_torch/...`` modules, so the round entries resolve there."""

import textwrap

import pytest
import torch

from tpu_gossip_torch.analysis import RULES
from tpu_gossip_torch.analysis.baseline import DEFAULT_BASELINE, load_baseline, split_new, write_baseline
from tpu_gossip_torch.analysis.cli import DEFAULT_SCOPE, lint_paths, main, modules_for, repo_root
from tpu_gossip_torch.analysis.registry import Finding
from tpu_gossip_torch.analysis.walker import ROUND_ENTRIES, Project

AST_RULES = {"key-linearity", "global-torch-rng", "round-host-sync", "raw-collective", "state-in-place"}


def _lint(tmp_path, files: dict, rules=None) -> list:
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return lint_paths(list(files), root=tmp_path, rules=rules)


def _rules(findings) -> list:
    return sorted(f.rule for f in findings)


ENGINE = "tpu_gossip_torch/sim/engine.py"

CASES = {
    "key-linearity": (
        {"tpu_gossip_torch/growth/draws.py": """
            from tpu_gossip_torch.core import prng

            def draw(key, n):
                a = prng.bits(key, (n,))
                b = prng.uniform(key, (n,))
                return a, b

            def minted(n):
                return prng.gumbel(prng.key(0), (n,))
        """},
        {"tpu_gossip_torch/growth/draws.py": """
            from tpu_gossip_torch.core import prng

            def draw(key, n, i):
                k_a, k_b = prng.split(key)
                a = prng.bits(k_a, (n,))
                b = prng.uniform(prng.fold_in(k_b, i), (n,))
                c = prng.randint(prng.fold_in(k_b, i + 1), (n,), 0, 4)
                return a, b, c
        """},
        2,
    ),
    "global-torch-rng": (
        {"tpu_gossip_torch/faults/noise.py": """
            import random

            import numpy as np
            import torch

            def noise(n):
                torch.manual_seed(0)
                return torch.rand(n), torch.randperm(n), np.random.rand(n), random.random()
        """},
        {"tpu_gossip_torch/faults/noise.py": """
            import random

            import numpy as np
            import torch

            def noise(n, seed):
                g = torch.Generator().manual_seed(seed)
                rng = np.random.default_rng(seed)
                return torch.rand(n, generator=g), rng.random(n), random.Random(seed).random()
        """},
        5,
    ),
    "round-host-sync": (
        {ENGINE: """
            import time

            def gossip_round(state, cfg):
                return helper(state), time.time()

            def helper(state):
                n = state.seen.sum().item()
                if bool(state.alive.any()):
                    return float(state.round) + n + len(state.seen.tolist())
                return state.seen.cpu()
        """},
        {ENGINE: """
            def gossip_round(state, cfg, rounds: int):
                return helper(state, rounds)

            def helper(state, rounds: int):
                n = int(state.seen.shape[0])
                m = int(state.seen.numel()) // n
                k = float(rounds * m) + bool(len(cfg_like()))
                return state.seen.sum() + n + k

            def cfg_like():
                return ()

            def not_a_round(state):
                return state.seen.sum().item()
        """},
        6,
    ),
    "raw-collective": (
        {"tpu_gossip_torch/dist/reduce.py": """
            import torch
            import torch.distributed as dist
            from torch.distributed import all_reduce

            def total(x):
                dist.all_reduce(x)
                all_reduce(x)
                return torch.distributed.get_world_size()
        """},
        {"tpu_gossip_torch/cluster/topology.py": """
            import torch
            import torch.distributed as dist

            def total(x):
                dist.all_reduce(x)
                return torch.distributed.get_world_size()
        """},
        4,
    ),
    "state-in-place": (
        {ENGINE: """
            def gossip_round(state, cfg):
                state.seen[0] = True
                state.alive.fill_(False)
                seen = state.seen
                seen |= state.forwarded
                state.last_hb.index_put_((state.seen[:, 0],), state.round)
                return state
        """},
        {ENGINE: """
            import dataclasses

            def gossip_round(state, cfg):
                seen = state.seen.clone()
                seen[0] = True
                alive = torch.zeros_like(state.alive)
                alive.fill_(True)
                return dataclasses.replace(state, seen=seen | state.forwarded, alive=alive)

            def outside(state):
                state.seen[0] = True
        """},
        4,
    ),
}


@pytest.mark.parametrize("rule_id", sorted(CASES))
def test_rule_fires_on_its_fixture(tmp_path, rule_id):
    bad, _, n = CASES[rule_id]
    found = _lint(tmp_path, bad)
    assert _rules(found) == [rule_id] * n, [f.render() for f in found]
    assert all(f.line > 0 and f.file in bad for f in found)


@pytest.mark.parametrize("rule_id", sorted(CASES))
def test_rule_is_clean_on_its_fixture(tmp_path, rule_id):
    _, good, _ = CASES[rule_id]
    assert _lint(tmp_path, good) == []


def test_rule_ids_are_the_ports():
    assert set(RULES) == AST_RULES


def test_pragma_suppresses_only_with_a_reason(tmp_path):
    src = {ENGINE: """
        def gossip_round(state, cfg):
            # graftlint: disable=round-host-sync -- the stop condition is read once a round
            a = state.seen.sum().item()
            b = state.alive.sum().item()  # graftlint: disable=round-host-sync
            c = state.round.item()  # graftlint: disable=no-such-rule -- a reason
            return a + b + c
    """}
    found = _lint(tmp_path, src)
    assert _rules(found) == ["pragma-needs-reason", "pragma-unknown-rule", "round-host-sync"]
    assert {f.line for f in found if f.rule != "round-host-sync"} == {5, 6}


def test_pragma_in_a_string_is_text(tmp_path):
    src = {ENGINE: '''
        def gossip_round(state, cfg):
            doc = "# graftlint: disable=round-host-sync -- quoted"
            return state.seen.sum().item(), doc
    '''}
    assert _rules(_lint(tmp_path, src)) == ["round-host-sync"]


def test_round_entries_resolve_in_the_port():
    project = Project(modules_for(repo_root(), ["tpu_gossip_torch"]))
    assert project.unresolved_entries() == []
    assert len(project.round_reachable()) > len(ROUND_ENTRIES)


def test_the_ports_tree_lints_clean_with_an_empty_baseline():
    assert load_baseline(DEFAULT_BASELINE) == set()
    found = lint_paths(list(DEFAULT_SCOPE))
    assert found == [], "\n".join(f.render() for f in found)


def test_baseline_round_trip_suppresses_by_identity(tmp_path):
    f = Finding(file="a.py", line=3, col=1, rule="key-linearity", message="m", qualname="draw")
    write_baseline(tmp_path / "b.toml", [f, f])
    assert load_baseline(tmp_path / "b.toml") == {("a.py", "key-linearity", "draw")}
    moved = Finding(file="a.py", line=9, col=1, rule="key-linearity", message="other", qualname="draw")
    assert split_new([moved], load_baseline(tmp_path / "b.toml")) == ([], [moved])


def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\ndef f(n):\n    return torch.rand(n)\n")
    assert main([str(bad)]) == 1
    good = tmp_path / "good.py"
    good.write_text("def f(n):\n    return n\n")
    assert main([str(good)]) == 0
    assert main([str(good), "--mem-only"]) == 2
    assert main(["--rules", "no-such-rule", str(good)]) == 2
    assert main([str(tmp_path / "missing.py")]) == 2
    assert main([str(bad), "--json"]) == 1
    assert '"global-torch-rng"' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        main(["--contracts-only", "--device", "cuda"])
