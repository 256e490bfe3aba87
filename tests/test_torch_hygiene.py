"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points run on the card by default and raise without one, and
chip_smoke.py fails without a card or without the repo."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_gossip_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "tpu_gossip", "experiments")]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tpu_gossip'] = None\n"
        "sys.modules['experiments'] = None\n"
        "import tpu_gossip_torch, tpu_gossip_torch.convert, tpu_gossip_torch.cli.run_sim\n"
        "import tpu_gossip_torch.sim.metrics, tpu_gossip_torch.kernels.round_tail\n"
        "import tpu_gossip_torch.kernels.pallas_segment, tpu_gossip_torch.kernels.gossip\n"
        "import tpu_gossip_torch.native, tpu_gossip_torch.core.device_topology\n"
        "import tpu_gossip_torch.core.packed, tpu_gossip_torch.kernels.packed_ops\n"
        "import tpu_gossip_torch.sim.packed_engine, tpu_gossip_torch.dist, tpu_gossip_torch.sim.profile\n"
        "import tpu_gossip_torch.kernels.probes, tpu_gossip_torch.utils.profiling, tpu_gossip_torch.dist.transport\n"
        "import tpu_gossip_torch.ckpt, tpu_gossip_torch.ckpt.chaos\n"
        "import tpu_gossip_torch.faults, tpu_gossip_torch.core.streams\n"
        "import tpu_gossip_torch.serve, tpu_gossip_torch.compat.wire, tpu_gossip_torch.traffic.ingest\n"
        "import tpu_gossip_torch.compat, tpu_gossip_torch.compat.simnet, tpu_gossip_torch.cli.run_seed\n"
        "import tpu_gossip_torch.cli.run_peer\n"
        "import tpu_gossip_torch.cluster, tpu_gossip_torch.cluster.topology, tpu_gossip_torch.cluster.hier\n"
        "import tpu_gossip_torch.cluster.launch\n"
        "import tpu_gossip_torch.analysis, tpu_gossip_torch.analysis.cli, tpu_gossip_torch.analysis.contracts\n"
        "import tpu_gossip_torch.analysis.entrypoints, tpu_gossip_torch.analysis.optrace\n"
        "import tpu_gossip_torch.analysis.mem, tpu_gossip_torch.analysis.mem.ledger\n"
        "import tpu_gossip_torch.analysis.mem.widths, tpu_gossip_torch.analysis.mem.budget\n"
        "import tpu_gossip_torch.analysis.mem.wire\n"
        "from tpu_gossip_torch.experiments import pallas_gather_caps, pallas_wide_lane_gather, gather_probe\n"
        "from tpu_gossip_torch.experiments import perm_pipeline_probe, matching_round_profile, dist_profile\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_card(no_card, capsys):
    from tpu_gossip_torch import convert
    from tpu_gossip_torch.cli import run_sim
    from tpu_gossip_torch.core import prng
    from tpu_gossip_torch.core.device_topology import device_powerlaw_graph
    from tpu_gossip_torch.core.matching_topology import matching_powerlaw_graph
    from tpu_gossip_torch.kernels.pallas_segment import build_staircase_plan
    from tpu_gossip_torch.core.state import SwarmConfig, init_swarm
    from tpu_gossip_torch.core.topology import Graph

    with pytest.raises(RuntimeError):
        prng.key(0)
    with pytest.raises(RuntimeError):
        matching_powerlaw_graph(500, fanout=1, key=prng.key(0, "cpu"))
    with pytest.raises(RuntimeError):
        device_powerlaw_graph(500, key=prng.key(0, "cpu"))
    with pytest.raises(RuntimeError):
        build_staircase_plan(np.array([0, 1, 2]), np.array([1, 0]), fanout=1)
    graph = Graph(n=3, row_ptr=np.array([0, 1, 2, 2]), col_idx=np.array([1, 0]))
    with pytest.raises(RuntimeError):
        init_swarm(graph, SwarmConfig(n_peers=3, msg_slots=4), key=prng.key(0, "cpu"))
    with pytest.raises(RuntimeError):
        convert.state_from_jax({})
    from tpu_gossip_torch import dist

    with pytest.raises(RuntimeError):
        dist.make_mesh()
    with pytest.raises(RuntimeError):
        dist.partition_graph(graph, 1)
    for argv in (["--graph", "matching"], ["--graph", "chung-lu"], ["--graph", "chung-lu", "--shard"]):
        assert run_sim.main(["--peers", "100", *argv, "--rounds", "2"]) == 2
        assert "CUDA" in capsys.readouterr().err


def test_probe_and_profiling_entry_points_raise_without_card(no_card):
    """The probe scripts and the stage profiler run on the card by default
    and raise without one, as every entry point of the port does."""
    from tpu_gossip_torch.experiments import (dist_profile, gather_probe, matching_round_profile,
                                              pallas_gather_caps, pallas_wide_lane_gather, perm_pipeline_probe)
    from tpu_gossip_torch.utils.profiling import profile_round_stages

    for call in (lambda: pallas_gather_caps.try_shape(8, 1), lambda: pallas_gather_caps.main(rows=(8,)),
                 lambda: pallas_wide_lane_gather.probe(8, 256, 2), lambda: gather_probe.main(n=2**10, e=2**12),
                 lambda: perm_pipeline_probe.main(e=128 * 128), lambda: matching_round_profile.main(200),
                 lambda: dist_profile.main(200), lambda: profile_round_stages(None, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _smoke(cwd: Path, env_extra: dict) -> subprocess.CompletedProcess:
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _smoke(tmp_path, {"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_ctypes_signatures_match_the_c_entries():
    """Each kernel entry's ctypes argtypes have the C declaration's arity:
    an argument too few makes ctypes pass the last one (the stream) as a
    32-bit int, which faults at launch on the card."""
    import re

    from tpu_gossip_torch.kernels import native

    for name, src in native.SOURCES.items():
        text = (ROOT / "tpu_gossip_torch" / "csrc" / src).read_text()
        entries = {m.group(1): m.group(2) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}
        assert set(entries) == set(native._SIGNATURES[name]), src
        for fn, params in entries.items():
            assert len(params.split(",")) == len(native._SIGNATURES[name][fn]), fn
