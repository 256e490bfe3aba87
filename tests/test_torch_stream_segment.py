"""K6's plain version against the JAX package's ``stream_segment_or`` (the
Pallas kernel in interpret mode), exactly: on the shard plans of a Chung-Lu
graph at S = 1, 2 and 8, and on hand-made plans whose windows split across
output blocks, whose runs are empty, and whose tiles pad the grid."""

import numpy as np
import pytest
import torch

from tpu_gossip.core.topology import build_csr
from tpu_gossip.dist import build_shard_plans as j_plans
from tpu_gossip.dist import partition_graph as j_partition
from tpu_gossip.kernels import pallas_segment as jseg
from tpu_gossip_torch import dist as tdist
from tpu_gossip_torch.kernels import native
from tpu_gossip_torch.kernels import pallas_segment as tseg
from tests.test_torch_slice import _one_torch_thread  # noqa: F401
from tests.test_torch_staircase import _words, chung_lu


def _hand_graph(kind):
    """600 peers on two shards (no permutation): ``hub`` puts every edge
    inside shard 0 (a star from peer 0 and a ring), so shard 1's runs are
    empty and its tiles pad the grid; ``edgeless`` has no edge at all."""
    if kind == "edgeless":
        return build_csr(600, np.zeros((0, 2), np.int64))
    star = np.stack([np.zeros(299, np.int64), np.arange(1, 300)], axis=1)
    ring = np.stack([np.arange(1, 299), np.arange(2, 300)], axis=1)
    return build_csr(600, np.concatenate([star, ring]))


CASES = [("chung_lu", 1, 1024), ("chung_lu", 2, 1024), ("chung_lu", 8, 1024), ("hub", 2, 128),
         ("edgeless", 2, 128)]


def _plans(kind, s, rows):
    if kind == "chung_lu":
        g, permute = chung_lu(2000, seed=s), True
    else:
        g, permute = _hand_graph(kind), False
    jsg, _, _ = j_partition(g, s, seed=0, permute=permute)
    tsg, _, _ = tdist.partition_graph(g, s, seed=0, permute=permute, device="cpu")
    return jsg, j_plans(jsg, rows=rows), tdist.build_shard_plans(tsg, rows=rows)


@pytest.mark.parametrize("m", [1, 16, 32])
@pytest.mark.parametrize("kind,s,rows", CASES, ids=lambda v: str(v))
def test_stream_segment_plain_equals_jax_kernel(kind, s, rows, m):
    jsg, jp, tp = _plans(kind, s, rows)
    for name in ("tile_block", "offs", "window_idx"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    length = s * jsg.bucket
    for d in range(s):
        vals = _words((length,), 10 * d + m, m)
        if m == 32:
            vals[:8] = np.int32(-2**31)  # bit 31 alone
        want = jseg.stream_segment_or(jp.tile_block[d], jp.first_visit[d], jp.window_idx[d], jp.offs[d],
                                      vals, m, n=jp.per, n_tiles=jp.n_tiles, n_blocks=jp.n_blocks, rows=rows,
                                      interpret=True)
        words = tseg.stream_segment_plain(tp.tile_block[d], tp.window_idx[d], tp.offs[d], torch.from_numpy(vals),
                                          tp.rows, tp.n_blocks)
        np.testing.assert_array_equal(tseg.unpack_words(words[: tp.per], m).numpy(), np.asarray(want))


def test_hand_plans_hold_the_edge_cases():
    _, _, tp = _plans("hub", 2, 128)
    tb, wi, offs = tp.tile_block.numpy(), tp.window_idx.numpy(), tp.offs.numpy().reshape(2, tp.n_tiles, -1)
    live = (offs >= 0).any(-1)
    # a window read by tiles of two blocks, with complementary masks
    w0 = live[0] & (wi[0] == 0)
    assert len(set(tb[0][w0])) > 1
    assert not ((offs[0][w0] >= 0).sum(0) > 1).any()
    # shard 1 receives nothing: every tile of it is inert, the grid's padding
    assert not live[1].any() and (tb[1][tp.n_tiles - 1] == tp.n_blocks - 1)
    _, _, empty = _plans("edgeless", 2, 128)
    assert not (empty.offs.numpy() >= 0).any()


def test_stream_segment_or_takes_plain_on_cpu_and_counts_nothing():
    _, _, tp = _plans("chung_lu", 2, 1024)
    vals = torch.from_numpy(_words((2 * tp.bucket,), 1, 32))
    before = native.LAUNCHES["stream_segment"]
    args = (tp.tile_block[1], tp.window_idx[1], tp.offs[1], vals, tp.rows, tp.n_blocks)
    assert torch.equal(tseg.stream_segment_or(*args), tseg.stream_segment_plain(*args))
    assert native.LAUNCHES["stream_segment"] == before
    with pytest.raises(ValueError, match="multiple of 1024"):
        tseg.stream_segment_or(*args[:3], vals[:1000], *args[4:])
    with pytest.raises(ValueError, match="window_idx"):
        tseg.stream_segment_or(args[0], args[1][:-1], *args[2:])
    # a window past the stream's end is refused by both routes alike
    for bad in (2 * tp.bucket // 1024, -1):
        wi = args[1].clone()
        wi[-1] = bad
        for fn in (tseg.stream_segment_or, tseg.stream_segment_plain):
            with pytest.raises(ValueError, match=r"window_idx must lie in \[0, "):
                fn(args[0], wi, *args[2:])
