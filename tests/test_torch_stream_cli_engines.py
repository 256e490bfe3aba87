"""Each engine under ``run_sim --stream`` at n=2000, the port's CLI against
the JAX CLI on the CPU: Chung-Lu exactly-k with the degree law and two
Bloom planes, preferential attachment with the hotspot law, the Chung-Lu
staircase (K5) with bursts past rate 10 (the Poisson rejection branch) and
its packed twin, the one-process bucketed mesh (K6 receive, and packed
with the scatter receive), the local staircase remat loop under churn and
silent peers; the summary (the ``stream`` block and digests) and every
per-round row equal. The scenario runs are
``test_torch_stream_cli_scenarios.py``'s."""

import pytest

from tests.test_torch_churn_cli import one_shard  # noqa: F401
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_stream_cli import S, check_engine

C = ["--peers", "2000", "--mode", "push_pull", "--fanout", "1"]
ENGINES = {
    "chung_lu_degree_bloom": C + ["--graph", "chung-lu", "--stream-origins", "degree", "--stream-hashes", "2"] + S,
    "pa_hotspot": C + ["--graph", "pa", "--m", "3", "--stream-origins", "hotspot"] + S,
    "staircase_burst": C + ["--graph", "chung-lu", "--staircase", "--stream", "4", "--stream-burst-every", "3",
                            "--slot-ttl", "20", "--rounds", "40", "--digest"],
    "staircase_packed": C + ["--graph", "chung-lu", "--staircase", "--packed"] + S,
    "shard_k6": C + ["--graph", "pa", "--m", "2", "--shard", "--staircase"] + S,
    "shard_packed": C + ["--graph", "pa", "--m", "2", "--shard", "--packed"] + S,
    "staircase_remat_churn": C + ["--graph", "chung-lu", "--staircase", "--remat-every", "8", "--churn-leave", "0.01",
                                  "--churn-join", "0.1", "--rewire-slots", "2"] + S,
    "silent": C + ["--graph", "chung-lu", "--silent-frac", "0.1"] + S,
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_streamed_engine_equals_jax_cli(capsys, one_shard, name):
    check_engine(capsys, ENGINES[name], one_shard=True)
