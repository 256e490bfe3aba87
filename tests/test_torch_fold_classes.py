"""K2's whole-plan fold on the CPU: the port's ``reduce_classes`` (its
``fold_classes``, the plain version here) against the JAX package's
``reduce_classes`` bit for bit (its outputs pinned in
``tests/jax_pins.json``, group ``fold_classes``, as a sha256 each;
``test_fold_classes_pins_are_current`` recomputes one in a child
process), and a numpy model of the kernel's index
math (``csrc/fold_planes.cu``) over the class and work tables that
``class_layout`` builds: every output written exactly once, every read
inside its class and the slot buffer, and the folded values the plain
version's."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.jax_pins import FOLD_CLASSES_CASES, field_digest, pinned
from tpu_gossip_torch.core import matching_topology as mt
from tpu_gossip_torch.kernels import native
from tpu_gossip_torch.kernels import permute
from tpu_gossip_torch.kernels.fold_cases import crafted_classes
from tests.test_torch_slice import _one_torch_thread  # noqa: F401

CU = (Path(permute.__file__).resolve().parent.parent / "csrc" / "fold_planes.cu").read_text()


def _cu_int(name: str) -> int:
    """A literal ``constexpr int`` of the kernel source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


THREADS, CHUNK, HUB_DEG = (_cu_int(k) for k in ("kThreads", "kChunk", "kHubDeg"))
STAGE = (CHUNK + 6) // 4  # kStage, in 16-byte slots


def test_work_table_geometry_is_the_kernels():
    """``fold_work`` sizes its entries with the kernel's own block size,
    staged chunk, hub degree and kind numbers (the kernel traps on an entry
    that does not fit its shared stage)."""
    assert (permute.FOLD_THREADS, permute.FOLD_CHUNK, permute.FOLD_HUB_DEG) == (THREADS, CHUNK, HUB_DEG)
    assert "constexpr int kStage = (kChunk + 6) / 4;" in CU
    kinds = dict((k, int(v)) for k, v in re.findall(r"(k[A-Z][a-z]+) = (\d)", re.search(r"enum Kind[^}]+", CU).group()))
    assert kinds == {"kZero": permute.FOLD_ZERO, "kPlane": permute.FOLD_PLANE, "kStaged": permute.FOLD_STAGED,
                     "kHub": permute.FOLD_HUB}


def _slots(rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-2**31, 2**31, (rows, 128)).astype(np.int32)


def _plan_case(n: int):
    _, _, classes, rows = mt.plan_shape(n)
    return classes, rows, n


def _fold_case(case: str):
    """(classes, rows, n_out) and the slot buffer of one fold case."""
    classes, rows, n_out = _plan_case(int(case[4:])) if case.startswith("plan") else crafted_classes(case)
    return classes, rows, n_out, _slots(rows, rows + n_out)


def jax_fold_case(case: str, op: str) -> str:
    """The JAX package's ``reduce_classes`` on one case, as its
    :func:`tests.jax_pins.field_digest`."""
    import jax.numpy as jnp

    from tpu_gossip.core.matching_topology import reduce_classes as jax_reduce_classes

    classes, _, n_out, slots = _fold_case(case)
    return field_digest(jax_reduce_classes(jnp.asarray(slots), classes, n_out, op))


@pytest.mark.parametrize("op", ["or", "sum"])
@pytest.mark.parametrize("case", FOLD_CLASSES_CASES)
def test_reduce_classes_equals_jax(case, op):
    classes, rows, n_out, slots = _fold_case(case)
    layout = mt.class_layout(classes, rows, n_out, "cpu")
    before = dict(native.LAUNCHES)
    got = mt.reduce_classes(torch.from_numpy(slots), layout, op).numpy()
    assert native.LAUNCHES == before  # CPU tensors take the plain version
    assert got.dtype == np.int32 and got.shape == (n_out,)
    assert field_digest(got) == pinned("fold_classes", f"{case}-{op}")


def test_fold_classes_pins_are_current():
    """A plan case's pin, recomputed by the JAX package in a child process,
    equals the file."""
    from tests.test_torch_growth_cli_engines import jax_in_child

    names = ["plan2000-sum"]
    assert jax_in_child("tests.jax_pins", "compute", "fold_classes", names) == {
        name: pinned("fold_classes", name) for name in names}


def _fold(a: np.ndarray, axis: int, op: str) -> np.ndarray:
    a = a.astype(np.uint32)
    return (np.bitwise_or.reduce(a, axis=axis) if op == "or" else a.sum(axis=axis, dtype=np.uint32))


def kernel_model(table: tuple, work: np.ndarray, flat: np.ndarray | None, n_out: int, op: str = "or"):
    """The kernel's index math, block by block: (writes per output node,
    folded outputs or None without ``flat``). ``flat`` None checks the
    bounds and coverage only, against a buffer of the table's length."""
    size = max(r[1] + (r[3] * r[4] if permute.fold_kind(r) == permute.FOLD_PLANE else r[2] * r[3])
               for r in table)
    size = -(-size // 128) * 128 if flat is None else flat.size
    writes = np.zeros(n_out, np.int64)
    out = np.zeros(n_out, np.uint32)
    for row_i, k0, k1, kind in work.tolist():
        node_off, slot_off, count, pd, ps, ns = table[row_i]
        assert kind == permute.fold_kind(table[row_i]) and 0 <= k0 < k1 <= count
        if kind == permute.FOLD_ZERO:
            writes[node_off + k0 : node_off + k1] += 1
            continue
        if kind == permute.FOLD_PLANE:
            assert k1 - k0 <= 4 * THREADS and slot_off % 4 == 0 and ps % 4 == 0
            k = k0 + 4 * np.arange(THREADS)
            k = k[k < k1]
            assert k[-1] + 3 < ps  # a thread's 16-byte load stays in its class plane
            idx = slot_off + k[:, None, None] + np.arange(pd)[None, :, None] * ps + np.arange(4)
            assert idx.max() < size
            keep = (k[:, None] + np.arange(4)) < k1
            writes[node_off + (k[:, None] + np.arange(4))[keep]] += 1
            if flat is not None:
                out[node_off + (k[:, None] + np.arange(4))[keep]] = _fold(flat[idx], 1, op)[keep]
            continue
        assert ps == 1 and ns == pd
        if kind == permute.FOLD_STAGED:
            assert pd < HUB_DEG and (k1 - k0) * pd <= CHUNK
            a = slot_off + k0 * pd
            a0 = a & ~3
            n4 = (a + (k1 - k0) * pd - a0 + 3) >> 2
            assert n4 <= STAGE and a0 + 4 * n4 <= size
            writes[node_off + k0 : node_off + k1] += 1
            if flat is not None:
                words = flat[a0 : a0 + 4 * n4][a - a0 :]
                out[node_off + k0 : node_off + k1] = _fold(words[: (k1 - k0) * pd].reshape(k1 - k0, pd), 1, op)
            continue
        assert kind == permute.FOLD_HUB and pd >= HUB_DEG and k1 == k0 + 1
        a = slot_off + k0 * pd
        b = a + pd
        a4, b4 = (a + 3) & ~3, b & ~3
        assert a4 < b4 and b <= size
        writes[node_off + k0] += 1
        if flat is not None:
            out[node_off + k0] = _fold(np.concatenate([flat[a:a4], flat[b4:b], flat[a4:b4]]), 0, op)
    return writes, out


@pytest.mark.parametrize("op", ["or", "sum"])
@pytest.mark.parametrize("case", ["mixed", "gaps", "node_major", "plan2000", "plan20000"])
def test_work_table_model_equals_plain(case, op):
    """The numpy model of the kernel over the layout's own tables writes
    each output once and folds the plain version's values."""
    classes, rows, n_out = _plan_case(int(case[4:])) if case.startswith("plan") else crafted_classes(case)
    slots = _slots(rows, 7)
    layout = mt.class_layout(classes, rows, n_out, "cpu")
    assert layout.table.dtype == torch.int64 and layout.work.dtype == torch.int32
    assert layout.table.tolist() == [list(r) for r in layout.table_rows]
    writes, got = kernel_model(layout.table_rows, layout.work.numpy(), slots.reshape(-1), n_out, op)
    np.testing.assert_array_equal(writes, 1)
    want = permute.fold_classes_plain(torch.from_numpy(slots), layout, op).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want)


def test_work_table_covers_the_1m_plan():
    """The 1M plan's class and work tables (host only): each of the n
    outputs written once, hub blocks first, every read in bounds."""
    n = 1_000_000
    _, _, classes, rows = mt.plan_shape(n)
    table = mt.class_table(classes, n)
    work = permute.fold_work(table)
    writes, _ = kernel_model(table, work, None, n)
    np.testing.assert_array_equal(writes, 1)
    assert max(r[1] + (r[3] * r[4] if r[4] != 1 else r[2] * r[3]) for r in table) <= rows * 128
    assert work[0, 3] == permute.FOLD_HUB and (np.diff(work[:, 3]) <= 0).all()  # hub, staged, plane, zero
    hubs = [r for r in table if permute.fold_kind(r) == permute.FOLD_HUB]
    assert sum(r[2] for r in hubs) == 89 and sum(r[2] * r[3] for r in hubs) == 188_889
    assert sum(r[2] * r[3] for r in table if permute.fold_kind(r) == permute.FOLD_STAGED) == 2_380_422 - 188_889


def test_class_table_rows():
    classes, _, n_out = crafted_classes("gaps")
    table = mt.class_table(classes, n_out)
    assert table[0] == (0, 0, 3, 0, 0, 0)  # the gap before the first class
    assert table[1] == (3, 0, 9000, 3, 9216, 1)  # position-major: (cstride, 1)
    assert table[2] == (9003, 0, 7, 0, 0, 0)  # a gap between classes
    assert table[3][4:] == (1, 31)  # node-major: (1, pad_deg)
    assert table[-1] == (17301, 0, 99, 0, 0, 0)  # the tail up to n_out
    assert sum(r[2] for r in table) == n_out


def test_fold_work_refuses_bad_rows():
    with pytest.raises(ValueError):
        permute.fold_work(((0, 512, 9000, 2, 9216, 1),))  # unaligned position-major
    with pytest.raises(ValueError):
        permute.fold_work(((0, 0, 9000, 2, 8192, 1),))  # count past the plane stride
    with pytest.raises(ValueError):
        permute.fold_work(((0, 0, 5, 3, 1, 2),))  # node stride other than pad_deg
    assert permute.fold_work(()).shape == (0, 4)


def test_fold_classes_refuses_a_foreign_slot_buffer():
    classes, rows, n_out = crafted_classes("mixed")
    layout = mt.class_layout(classes, rows, n_out, "cpu")
    with pytest.raises(ValueError):
        permute.fold_classes(torch.zeros((rows + 8, 128), dtype=torch.int32), layout)
    with pytest.raises(ValueError):
        permute.fold_classes(torch.zeros((rows, 128), dtype=torch.int64), layout)
    with pytest.raises(ValueError):
        permute.fold_classes(torch.zeros((rows, 128), dtype=torch.int32), layout, "max")


def test_bound_counts_each_class_slot_once():
    """``chip_smoke.py``'s K2 bound reads the count * pad_deg slots of each
    class (no plane's stride padding, nothing for a gap) and writes n_out."""
    from chip_smoke import fold_bytes

    classes, rows, n_out = crafted_classes("gaps")
    layout = mt.class_layout(classes, rows, n_out, "cpu")
    assert fold_bytes(layout) == 4 * (9000 * 3 + 31 + 2 * 1025 + 40 * 33 + 8192 + 1 + n_out)
