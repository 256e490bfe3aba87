"""The staged probe gathers' geometry on the CPU: a numpy model of the index
math of ``csrc/gather_probes.cu`` (``lane_gather_staged`` for P2,
``sublane_slab`` for P3) over every probe shape and ragged ones, driven by
the plans the wrapper passes (``kernels/probes.py``): every output element
written exactly once, every lookup read from the staged slice that holds
it (or, past a partly staged lane row, from the row itself), the slab's
rotation spreading a lane's lookups over all 32 banks; and the kernel's
constants held equal to the wrapper's."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_gossip_torch.kernels import probes

CU = (Path(probes.__file__).resolve().parent.parent / "csrc" / "gather_probes.cu").read_text()

P1_ROWS = (8, 64, 512, 2048, 8192)
P2_SHAPES = ((8, 1024, 64), (8, 8192, 32), (16, 8192, 16), (8, 65536, 8), (16, 65536, 8), (8, 131072, 4))
LANE_RAGGED = ((3, 40000, 9), (5, 65540, 10), (1, 262144, 3), (7, 32768, 14), (2, 8196, 6), (3, 8192, 3000))
SUBLANE_SLAB = ((8192, 47104), (8192, 47105), (100, 4097), (1, 9), (5000, 20000), (8192, 16389), (3000, 6000))
BOX_ROWS = 256  # the slab route's TMA box: 4 lanes x 256 rows


def _cu_int(name: str) -> int:
    """A literal ``constexpr int``/``unsigned`` of the kernel source."""
    return int(re.search(rf"constexpr (?:int|unsigned) {name} = (\d+);", CU).group(1))


def test_kernel_constants_are_the_wrappers():
    """The wrapper sizes its plans with the kernel's own block, stage, slab,
    box and step sizes."""
    assert _cu_int("kStageThreads") == probes.STAGE_THREADS
    assert _cu_int("kStageBytes") == probes.STAGE_BYTES
    assert "constexpr int kStageWords = kStageBytes / 4;" in CU
    assert _cu_int("kSlabLanes") == probes.SLAB_LANES
    assert _cu_int("kSlabRows") == probes.SLAB_ROWS
    assert _cu_int("kBoxRows") == BOX_ROWS
    assert "constexpr unsigned kStepRows = kStageThreads;" in CU and probes.STEP_ROWS == probes.STAGE_THREADS
    assert probes.STEP_ROWS % BOX_ROWS == 0


def test_slab_fits_shared_memory():
    """The largest slab, its idx and out rings and the barriers fit one
    block's shared memory (the kernel's dynamic size)."""
    biggest = (-(-probes.SLAB_ROWS // BOX_ROWS) * BOX_ROWS + 4 * probes.STEP_ROWS) * 16 + 64
    assert biggest <= probes.STAGE_BYTES <= 232448  # the H100's per-block limit


def _lane_cases():
    for s, w, steps in P2_SHAPES[1:]:  # the 4 KB rows take the L2 route
        yield pytest.param(s, w, s * steps, id=f"P2-{s}-{w}-{steps}")
    for t, w, n in LANE_RAGGED:
        yield pytest.param(t, w, n, id=f"ragged-{t}-{w}-{n}")


@pytest.mark.parametrize("t_rows,width,n_rows", list(_lane_cases()))
def test_lane_staged_model(t_rows, width, n_rows):
    """lane_gather_staged: block b serves table row b // blocks_per_row and
    positions [part * per, +per) of its uses, 4 at a time; each output
    element written exactly once, each lookup from the staged words or,
    past them, the row; the result the plain gather's."""
    plan = probes.lane_plan(t_rows, width, n_rows)
    assert plan is not None
    per, bpr = plan
    uses = n_rows // t_rows * width
    assert per % 4 == 0 and per * bpr >= uses and t_rows * bpr < 2**31
    staged = min(width, probes.STAGE_WORDS)
    rng = np.random.default_rng(width + n_rows)
    tab = rng.integers(-2**31, 2**31, (t_rows, width), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, width, (n_rows, width), dtype=np.int32)
    stage = tab[:, :staged]  # each block's shared copy of its row's first words
    out = np.zeros(n_rows * width, np.int32)
    writes = np.zeros(n_rows * width, np.int32)
    flat_idx = idx.reshape(-1)
    for b in range(t_rows * bpr):
        s, part = divmod(b, bpr)
        begin, end = part * per, min(part * per + per, uses)
        if begin >= end:
            continue
        p = np.arange(begin, end, 4)  # a thread's vector: 4 positions of one idx row
        j = p // width
        assert ((p % width) + 4 <= width).all()  # a vector never crosses a row
        at = ((j * t_rows + s) * width + (p - j * width))[:, None] + np.arange(4)
        i = flat_idx[at]
        got = np.where(i < staged, stage[s][np.minimum(i, staged - 1)], tab[s][i])
        out[at] = got
        writes[at] += 1
    assert (writes == 1).all()
    want = probes.lane_gather_plain(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    assert (out.reshape(n_rows, width) == want).all()


@pytest.mark.parametrize("t_rows,width,n_rows", [(8192, 128, 8192), (65536, 128, 65536), (4, 6, 12), (3, 10, 9),
                                                 (8, 1024, 512), (2, 8188, 4)])
def test_lane_l2_route_shapes(t_rows, width, n_rows):
    """P1 axis 1 and P4 (T = N), W not a multiple of 4 and rows under 32 KB
    (P2's 4 KB rows) keep the L2 route."""
    assert probes.lane_plan(t_rows, width, n_rows) is None


def test_lane_plans_of_the_probe_shapes():
    """About one block an SM at every staged P2 shape; a row past 224 KB is
    partly staged (the 256 and 512 KB rows)."""
    for s, w, steps in P2_SHAPES[1:]:
        per, bpr = probes.lane_plan(s, w, s * steps)
        assert s * bpr == probes.TARGET_BLOCKS
        assert (w > probes.STAGE_WORDS) == (w >= 65536)


def _rotate(v: np.ndarray, i: np.ndarray) -> np.ndarray:
    """The kernel's in-place rotation of staged rows: swap lane pairs when
    bit 0 of (i >> 3) & 3 is set, then swap halves when bit 1 is."""
    sw = (i >> 3) & 3
    v = v.copy()
    m = (sw & 1).astype(bool)
    v[m] = v[m][:, [1, 0, 3, 2]]
    m = (sw & 2).astype(bool)
    v[m] = v[m][:, [2, 3, 0, 1]]
    return v


def _slab_word(i: np.ndarray, k: int) -> np.ndarray:
    return 4 * i + (k ^ ((i >> 3) & 3))


@pytest.mark.parametrize("t_rows,n_rows", SUBLANE_SLAB)
def test_sublane_slab_model(t_rows, n_rows):
    """sublane_slab: block b stages slab b % 32 (TMA boxes of 256 rows, zeros
    past the table), walks rows [(b // 32) * rows_per, +rows_per) in steps
    of 1024 rows, a thread a row; a box is loaded only for rows inside the
    chunk and stored only there (clipped at the tensor's end). Each output
    element written exactly once, each lookup inside the slab and on the
    word the rotation put its value, and the result the plain gather's."""
    rows_per = probes.sublane_plan(t_rows, n_rows)
    assert rows_per is not None and rows_per % probes.STEP_ROWS == 0
    chunks = -(-n_rows // rows_per)
    assert chunks <= probes.ROW_CHUNKS
    slabs = probes.LANES // probes.SLAB_LANES
    slab_rows = -(-t_rows // BOX_ROWS) * BOX_ROWS
    rng = np.random.default_rng(t_rows + n_rows)
    tab = rng.integers(-2**31, 2**31, (t_rows, probes.LANES), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, t_rows, (n_rows, probes.LANES), dtype=np.int32)
    out = np.zeros_like(idx)
    writes = np.zeros(idx.shape, np.int32)
    for b in range(chunks * slabs):
        slab, chunk = b % slabs, b // slabs
        lanes = slice(slab * 4, slab * 4 + 4)
        staged = np.zeros((slab_rows, 4), np.int32)
        staged[:t_rows] = tab[:, lanes]
        rows = np.arange(slab_rows)
        staged[:t_rows] = _rotate(staged[:t_rows], rows[:t_rows])
        words = staged.reshape(-1)
        r0, r1 = chunk * rows_per, min(chunk * rows_per + rows_per, n_rows)
        for j in range(-(-(r1 - r0) // probes.STEP_ROWS)):
            row = r0 + j * probes.STEP_ROWS
            live = min(probes.STEP_ROWS, r1 - row)
            loaded = -(-live // BOX_ROWS) * BOX_ROWS  # rows of the loaded boxes
            step_rows = row + np.arange(loaded)
            ix = np.zeros((loaded, 4), np.int32)  # past the tensor's end: zeros
            inside = step_rows < n_rows
            ix[inside] = idx[step_rows[inside], lanes]
            o = np.stack([words[_slab_word(ix[:, k], k)] for k in range(4)], axis=1)
            assert (_slab_word(ix, np.arange(4)) < 4 * slab_rows).all()
            stored = step_rows < min(row + live, n_rows)  # boxes end at r1; the map clips at n_rows
            out[step_rows[stored], lanes] = o[stored]
            writes[step_rows[stored], lanes] += 1
    assert (writes == 1).all()
    want = probes.sublane_gather_plain(torch.from_numpy(tab), torch.from_numpy(idx), 0).numpy()
    assert (out == want).all()


@pytest.mark.parametrize("k", range(4))
def test_slab_rotation_spans_all_banks(k):
    """A lane's lookups by 32 threads over 32 consecutive rows fall on 32
    distinct banks (without the rotation, 8)."""
    i = np.arange(32)
    assert len(set(_slab_word(i, k) % 32)) == 32
    assert len(set((4 * i + k) % 32)) == 8


@pytest.mark.parametrize("rows", P1_ROWS)
def test_p1_axis0_keeps_the_l2_route(rows):
    """P1 axis 0 has one idx row a table row: staging the 32 slabs costs as
    many L2 requests as the gather, so it keeps the L2 route."""
    assert probes.sublane_plan(rows, rows) is None


def test_sublane_routes():
    assert probes.sublane_plan(8192, 47104) == 12288  # P3: 4 chunks of 12 steps, the last 10
    assert probes.sublane_plan(probes.SLAB_ROWS + 1, 10**5) is None  # the slab would not fit


def test_design_script_needs_a_card():
    """``experiments/gather_designs.py`` measures CUDA kernels only; on the
    CPU it refuses before building anything."""
    from tpu_gossip_torch.experiments import gather_designs

    with pytest.raises(RuntimeError):
        gather_designs.main(device="cpu")
