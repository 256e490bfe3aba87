"""Growth and streams on two gloo ranks on this CPU (ROADMAP item 11d parts
2 and 3), each rank holding only its rows, against the JAX CLI's
one-process run on the same (2, 2) fold pinned in ``tests/jax_pins.json``
(group ``cluster``, ``CLUSTER_PLANES``): the flash crowd's join bursts
under a stream on the matching mesh, packed and not, degree-weighted
origins with two hashes on the sparse transport, and the bucketed mesh
growing under the controller with ``--staircase``; and the pieces the
admission draw is made of: the draw over a column block, and the top-m
of each holder's top-m keys, ties included."""

import numpy as np
import pytest
import torch

from tests.test_torch_cluster_planes import equals_the_fold_pin
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tpu_gossip_torch.core import prng
from tpu_gossip_torch.core.rows import Rows
from tpu_gossip_torch.growth import engine as ge


@pytest.mark.parametrize("name,packed", [("grow_flash", False), ("grow_flash", True), ("degree_k2", False),
                                         ("bucketed_grow", False)])
def test_growth_planes_on_two_ranks_equal_the_jax_fold(name, packed):
    """``--grow`` under ``flash_crowd_under_fire.toml``'s join bursts with a
    stream at rate 3 (the packed run onto the unpacked pin), growth with
    degree-weighted origins and ``--stream-hashes 2`` on the sparse
    transport, and the bucketed mesh (S = 4, ``--staircase``) growing under
    a degraded scenario with churn joins, a stream and the controller."""
    equals_the_fold_pin(name, packed)


@pytest.mark.parametrize("draw", ["bits", "gumbel", "randint"])
@pytest.mark.parametrize("rows,cols,c0,w,r0", [(5, 40, 0, 40, 0), (5, 40, 13, 9, 0), (7, 33, 20, 13, 2),
                                               (3, 1000, 999, 1, 1)],
                         ids=["whole", "inner", "last_cols_from_row_2", "one_col"])
def test_column_block_draw_is_the_global_draws_slice(draw, rows, cols, c0, w, r0):
    """Rows ``[r0, rows)``, columns ``[c0, c0 + w)`` of a global ``(rows,
    cols)`` draw, drawn alone at ``offset = r0 * cols + c0`` and ``row_stride
    = cols``, are the global draw's slice bit for bit."""
    k = prng.split(prng.key(31, "cpu"))[0]
    fn = {"bits": prng.bits, "gumbel": prng.gumbel,
          "randint": lambda key, shape, **kw: prng.randint(key, shape, -5, 1 << 20, **kw)}[draw]
    whole = fn(k, (rows, cols))
    got = fn(k, (rows - r0, w), offset=r0 * cols + c0, row_stride=cols)
    assert torch.equal(got, whole[r0:, c0:c0 + w])


class _Block(Rows):
    """Columns ``[lo, lo + n)`` of ``total`` held in this process, its top-m
    keys kept for the merge (a holder of a mesh over several processes,
    without the process group)."""

    def __init__(self, lo: int, total: int, sent: list):
        self.lo, self._total, self.sent = lo, total, sent

    def total(self, n: int) -> int:
        return self._total

    def stack(self, x, label="stack"):
        self.sent.append(x)
        return x[None]


def _merged(cuts, fn):
    """The top-m of every block's top-m keys: ``fn(block, lo, hi)`` gives a
    block's ``(rows, m)`` keys."""
    sent = []
    for lo, hi in zip(cuts, cuts[1:]):
        fn(_Block(lo, cuts[-1], sent), lo, hi)
    return sent


@pytest.mark.parametrize("cuts", [[0, 9, 20], [0, 1, 7, 8, 20], [0, 10, 20]], ids=["two", "four", "halves"])
def test_top_m_merge_equals_the_whole_rows_ties_included(cuts):
    """Crafted float32 rows full of ties (equal scores, -inf, -0.0 and +0.0)
    cut into column blocks: the top-m of the blocks' top-m keys is
    ``jax.lax.top_k``'s order on the whole row, ties to the lower index."""
    vals = torch.tensor([1.5, 1.5, -0.0, 0.0, float("-inf"), 2.0, 2.0, -3.0], dtype=torch.float32)
    scores = vals[torch.from_numpy(np.random.default_rng(3).integers(0, len(vals), (6, 20)))]
    scores[0] = float("-inf")
    scores[1, :] = 1.5
    m = 4
    sent = _merged(cuts, lambda blk, lo, hi: blk.stack(
        torch.topk(ge._score_keys(scores[:, lo:hi], lo), min(m, hi - lo), dim=1).values))
    width = max(k.shape[1] for k in sent)
    pad = torch.iinfo(torch.int64).min
    union = torch.cat([torch.nn.functional.pad(k, (0, width - k.shape[1]), value=pad) for k in sent], dim=1)
    got = ge._from_keys(torch.topk(union, m, dim=1).values)
    want = ge._top_k_tie_low(scores, m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cuts", [[0, 500, 1000], [0, 333, 334, 1000]], ids=["halves", "uneven"])
def test_gumbel_top_k_over_column_blocks_equals_the_whole_draw(cuts):
    """``gumbel_top_k`` by holders of column blocks, each drawing only its
    block of every batch row, merges onto the one-process draw's targets
    (log degrees with -inf holes and repeats, row chunks of 3)."""
    k = prng.key(9, "cpu")
    g = torch.Generator().manual_seed(4)
    log_deg = prng.xla_log(torch.randint(1, 4, (1000,), generator=g).to(torch.float32))
    log_deg[torch.randperm(1000, generator=g)[:400]] = float("-inf")
    whole = ge.gumbel_top_k(k, log_deg, 7, 3)
    sent = _merged(cuts, lambda blk, lo, hi: ge.gumbel_top_k(k, log_deg[lo:hi], 7, 3, chunk_rows=3, held=blk))
    got = ge._from_keys(torch.topk(torch.cat(sent, dim=1), 3, dim=1).values)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
