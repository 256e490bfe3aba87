"""Two gloo ranks on this CPU running the row planes (ROADMAP item 11d
part 1): churn and re-wiring, the fault plane, silent peers, and the quorum
detector with its adversaries, each rank holding only its rows.

Each run goes through the port's launcher (``python -m
tpu_gossip_torch.cluster.launch --nprocs 2``) and rank 0's summary equals
the JAX CLI's one-process run on the same (2, 2) fold, pinned in
``tests/jax_pins.json`` (group ``cluster``, ``CLUSTER_PLANES``): the
digests, every integer column, the ``phases`` and ``liveness`` blocks and
the ICI/DCN totals; the coverages and loss rates (of the ``phases`` block
too) within 1e-6 and the degree tail's gamma within 1e-5. A
packed run lands on its unpacked twin's pin. The matching mesh's composed
siege, the compact side paths under a churn storm and the split brain are
here; silent peers, the hier transport, the bucketed mesh and the
cross-row helpers are ``test_torch_cluster_planes_more.py``'s."""

import pytest
import torch

from tests.jax_pins import CLUSTER_PLANES, pinned
from tests.test_torch_cluster_procs import TIMING, rank0_summary
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.core import prng

# the summary's floats a fold's ranks may round apart from the one-process
# run, each with its tolerance: the coverages and the loss rate as their
# float32 ratios, the gamma's float sum in the ranks' order (ROADMAP 11d)
FLOATS = {"final_coverage": 1e-6, "coverage_end": 1e-6, "delivery_loss_rate": 1e-6, "degree_gamma": 1e-5}


def _floats_aside(summary: dict) -> tuple[dict, dict]:
    """The summary without its float fields, and those floats by ``(phase
    row or None, name)``."""
    out, floats = {}, {}
    for k, v in summary.items():
        if k in FLOATS:
            floats[None, k] = v
        elif k == "phases":
            rows = []
            for i, row in enumerate(v):
                floats.update({(i, f): row[f] for f in FLOATS if f in row})
                rows.append({f: x for f, x in row.items() if f not in FLOATS})
            out[k] = rows
        else:
            out[k] = v
    return out, floats


def equals_the_fold_pin(name: str, packed: bool) -> None:
    """Rank 0's summary of ``CLUSTER_PLANES[name]`` as two ranks against the
    JAX fold's pin: equal but for the floats, held to 1e-6."""
    shards, argv = CLUSTER_PLANES[name]
    got = rank0_summary(argv + (["--packed"] if packed else []), shards // 2)
    want = dict(pinned("cluster", f"planes_{name}"))
    for k in TIMING:
        want.pop(k, None)
    assert got.pop("packed") is packed
    want.pop("packed")
    got, got_f = _floats_aside(got)
    want, want_f = _floats_aside(want)
    assert got == want
    assert sorted(got_f, key=str) == sorted(want_f, key=str)
    for (i, f), x in got_f.items():
        y = want_f[i, f]
        assert (x is None and y is None) or x == pytest.approx(y, abs=FLOATS[f]), (i, f)


@pytest.mark.parametrize("packed", [False, True], ids=["bool", "packed"])
@pytest.mark.parametrize("name", ["composed", "compact", "split_brain"])
def test_row_planes_on_two_ranks_equal_the_jax_fold(name, packed):
    """The composed siege (churn with dense re-wiring, blackout, accusers,
    forgers, floods, loss, quorum 3), the compact side paths
    (``--rewire-compact-cap 64`` under a churn storm's burst thresholds) and
    the split brain (a side B pass each partition round, sparse transport)
    on the matching mesh, two shards a rank."""
    equals_the_fold_pin(name, packed)


@pytest.mark.parametrize("shape,offset,lo,hi", [
    ((3, 2), 0, 0, 2000),
    ((7, 3), 3 * 5, 0, 1 << 31),
    ((5, 4), 4 * 9 + 1, -7, 1 << 20),
    ((4,), 11, 0, "tensor"),
], ids=["first_block", "wide_span", "negative_lo", "tensor_bound"])
def test_randint_with_offset_is_the_global_draws_block(shape, offset, lo, hi):
    """``prng.randint`` at a counter offset is the block of the one global
    draw, at every span class: both of its ``bits`` draws take the offset."""
    k = prng.split(prng.key(23, "cpu"))[1]
    bound = torch.tensor(977, dtype=torch.int64) if hi == "tensor" else hi
    n = 1
    for d in shape:
        n *= d
    whole = prng.randint(k, (offset + n + 9,), lo, bound)
    assert torch.equal(prng.randint(k, shape, lo, bound, offset), whole[offset: offset + n].view(shape))
