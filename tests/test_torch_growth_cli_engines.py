"""Each engine growing through ``run_sim --grow`` at n=2000, the port's
CLI against the JAX CLI on the CPU: the local matching path and its
packed twin, preferential attachment under churn, the staircase remat
loop with spare capacity, the one-process bucketed mesh (K6 receive, and
packed with the scatter receive), silent peers on exactly-k, and the
flash-crowd scenario's join_burst waves; the summary and every per-round
row equal (``degree_gamma`` within 1e-5), and the run to coverage. The JAX
CLI's summaries and rows of the fixed horizons are pinned in
``tests/jax_pins.json`` (group ``growth_cli``), one engine recomputed in a
child process; the runs to coverage run the JAX CLI in a child process
(:func:`jax_cli_child`), retried once if XLA's CPU compiler kills it with
a signal; the port's half runs in this process. Other files run the JAX
half of an in-process comparison so through :func:`jax_in_child`."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_gossip.cli import run_sim as jcli
from tpu_gossip_torch.cli import run_sim as tcli
from tests import jax_pins
from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_cli import _summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

M = jax_pins.GROWTH_M
ENGINES = jax_pins.GROWTH_ENGINES
TIMING = ("wall_seconds", "peers_rounds_per_sec", "ms_per_round", "ms_per_round_amortized",
          "epoch_rebuild_seconds_total", "packed")


ROOT = Path(__file__).resolve().parent.parent
# a child the reference compiler took down: it is run once more
COMPILER_SIGNALS = (signal.SIGSEGV, signal.SIGABRT)
_CHILD = """import sys
from tpu_gossip import dist
make_mesh = dist.make_mesh
if sys.argv[1] == "one_shard":
    dist.make_mesh = lambda *a, **k: make_mesh(1)
from tpu_gossip.cli import run_sim
sys.exit(run_sim.main(sys.argv[2:]))
"""


_CALL = """import importlib, json, sys
fn = getattr(importlib.import_module(sys.argv[1]), sys.argv[2])
print(json.dumps(fn(*json.loads(sys.argv[3]))))
"""


def _child(cmd: list[str], what: str) -> list[str]:
    """``cmd`` run from the repo root on the CPU, its stdout lines. A child
    killed by a signal of the reference compiler (SIGSEGV, SIGABRT) is run
    exactly once more; any other failure fails."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for attempt in range(2):
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        if attempt == 0 and proc.returncode in tuple(-s for s in COMPILER_SIGNALS):
            continue
        break
    assert proc.returncode == 0, f"{what} exited {proc.returncode}: {proc.stderr[-3000:]}"
    return proc.stdout.strip().splitlines()


def jax_cli_child(argv, one_shard: bool = False):
    """The JAX CLI on ``argv`` in a child process (on a one-device mesh with
    ``one_shard``), as :func:`tests.test_torch_cli._summary` returns it:
    ``(summary, per-round lines)``, retried once on a compiler signal."""
    lines = _child([sys.executable, "-c", _CHILD, "one_shard" if one_shard else "-", *argv], "JAX CLI")
    return json.loads(lines[-1]), lines[:-1]


def jax_in_child(module: str, fn: str, *args):
    """``module.fn(*args)`` in a child process, its JSON result: the JAX half
    of an in-process comparison, kept out of a test worker whose XLA CPU
    compiler might die under load; retried once on a compiler signal."""
    return json.loads(_child([sys.executable, "-c", _CALL, module, fn, json.dumps(args)], f"{module}.{fn}")[-1])


def jax_cli(capsys, argv, one_shard: bool = False):
    """The JAX CLI's half of a comparison: in a child process when the run
    compiles a composed scenario, in this process otherwise."""
    if "--scenario" in argv:
        return jax_cli_child(argv, one_shard)
    return _summary(capsys, jcli.main, argv)


@pytest.mark.parametrize("name", list(ENGINES))
def test_growing_run_equals_jax_cli(capsys, one_shard, name):
    """Each engine growing against the JAX CLI's summary and rows, pinned in
    ``tests/jax_pins.json`` (group ``growth_cli``, the JAX mesh on one
    device)."""
    argv = ENGINES[name] + jax_pins.GROWTH_HORIZON
    pin = jax_pins.pinned("growth_cli", name)
    want, want_rows = dict(pin["summary"]), pin["rows"]
    got, got_rows = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    assert {k: v for k, v in got.items() if k not in TIMING} == {k: v for k, v in want.items() if k not in TIMING}
    got_rows, want_rows = [json.loads(r) for r in got_rows], [json.loads(r) for r in want_rows]
    # degree_gamma is the plane's one float reduction: held to JAX's own
    # local/sharded tolerance; every other column is equal
    np.testing.assert_allclose([r.pop("degree_gamma") for r in got_rows],
                               [r.pop("degree_gamma") for r in want_rows], rtol=1e-5)
    assert got_rows == want_rows
    assert got["n_members"] > 2000


def test_growth_pins_are_current():
    """One engine of the ``growth_cli`` group recomputed by the JAX CLI in a
    child process."""
    name = "silent_exactly_k"
    assert jax_in_child("tests.jax_pins", "compute", "growth_cli", [name]) == {
        name: jax_pins.pinned("growth_cli", name)}


@pytest.mark.parametrize("name", ["matching_packed", "shard"])
def test_growing_run_to_coverage_equals_jax_cli(capsys, one_shard, name):
    argv = ENGINES[name]
    want, _ = jax_cli_child(argv, one_shard=True)
    got, _ = _summary(capsys, tcli.main, argv + ["--device", "cpu"])
    for k in ("rounds", "coverage", "n_members", "grow_rate", "degree_gamma"):
        assert got[k] == want[k], k
