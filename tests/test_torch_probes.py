"""The probe kernels' plain versions against the Pallas probes they port.

Each of P1-P5 (``experiments/``) is a Pallas body; each is copied here and
run in interpret mode on the CPU, with the same numpy operands given to the
port's plain version (``kernels/probes.py``) and to ``np.take_along_axis``.
Integer gathers: equal exactly. Then the wrappers' refusals and the ported
probe scripts at tiny sizes on the CPU.
"""

import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_gossip_torch.kernels.permute import lane_shuffle_plain
from tpu_gossip_torch.kernels.probes import lane_gather, lane_gather_plain, sublane_gather, sublane_gather_plain
from tests.test_torch_slice import _one_torch_thread  # noqa: F401


def _ints(rng, shape, hi=2**31):
    return rng.integers(0, hi, shape, dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def p1_pallas(x, idx, axis):
    """experiments/pallas_gather_caps.py:24-31 (body :24-25, call :29)."""

    def k(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=axis)

    return pl.pallas_call(k, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32), interpret=True)(x, idx)


def p2_pallas(table, idx, steps):
    """experiments/pallas_wide_lane_gather.py:26-40 (body :26-27, call :31)."""
    S, W = table.shape

    def k(tab_ref, idx_ref, out_ref):
        out_ref[:] = jnp.take_along_axis(tab_ref[:], idx_ref[:], axis=1)

    return pl.pallas_call(
        k, grid=(steps,),
        in_specs=[pl.BlockSpec((S, W), lambda j: (0, 0)), pl.BlockSpec((S, W), lambda j: (j, 0))],
        out_specs=pl.BlockSpec((S, W), lambda j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((steps * S, W), jnp.int32), interpret=True,
    )(table, idx)


def p3_pallas(tab, idxs, ch):
    """experiments/gather_probe.py:121-150 (body :121-132, call :141): idx
    padded with zero rows to the table's R rows, the first CH rows kept."""
    R = tab.shape[0]
    nch = idxs.shape[0] // ch

    def pk(tab_ref, idx_ref, out_ref):
        t = tab_ref[:]
        ii = idx_ref[:]
        pad = jnp.zeros((R - ch, 128), jnp.int32)
        full = jnp.concatenate([ii, pad], axis=0)
        g = jnp.take_along_axis(t, full, axis=0)
        out_ref[:] = g[:ch]

    return pl.pallas_call(
        pk, grid=(nch,),
        in_specs=[pl.BlockSpec((R, 128), lambda j: (0, 0)), pl.BlockSpec((ch, 128), lambda j: (j, 0))],
        out_specs=pl.BlockSpec((ch, 128), lambda j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((nch * ch, 128), jnp.int32), interpret=True,
    )(tab, idxs)


def _rows_call(kernel, v, idx, br):
    r = v.shape[0]
    return pl.pallas_call(
        kernel, grid=(r // br,),
        in_specs=[pl.BlockSpec((br, 128), lambda j: (j, 0)), pl.BlockSpec((br, 128), lambda j: (j, 0))],
        out_specs=pl.BlockSpec((br, 128), lambda j: (j, 0)),
        out_shape=jax.ShapeDtypeStruct((r, 128), jnp.int32), interpret=True,
    )(v, idx)


def p4_pallas(v, idx, br):
    """experiments/perm_pipeline_probe.py:65-79 (body :65-66, call :70)."""

    def ksh(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=1)

    return _rows_call(ksh, v, idx, br)


def p5_pallas(v, idx, br):
    """experiments/perm_pipeline_probe.py:88-107 (body :88-94, call :98)."""

    def ksub(x_ref, i_ref, o_ref):
        def body(j, _):
            sl = pl.ds(j * 8, 8)
            o_ref[sl, :] = jnp.take_along_axis(x_ref[sl, :], i_ref[sl, :], axis=0)
            return 0

        jax.lax.fori_loop(0, br // 8, body, 0)

    return _rows_call(ksub, v, idx, br)


@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("axis", [0, 1])
def test_p1_plain_equals_pallas(rows, axis):
    rng = np.random.default_rng(rows + axis)
    x = _ints(rng, (rows, 128))
    idx = _ints(rng, (rows, 128), rows if axis == 0 else 128)
    want = np.asarray(p1_pallas(x, idx, axis))
    assert (want == np.take_along_axis(x, idx, axis=axis)).all()
    plain = sublane_gather_plain(_t(x), _t(idx), 0) if axis == 0 else lane_gather_plain(_t(x), _t(idx))
    assert (plain.numpy() == want).all()
    got = sublane_gather(_t(x), _t(idx), 0) if axis == 0 else lane_gather(_t(x), _t(idx))
    assert (got.numpy() == want).all()


def test_p2_plain_equals_pallas():
    S, W, steps = 8, 256, 2
    rng = np.random.default_rng(2)
    table, idx = _ints(rng, (S, W)), _ints(rng, (steps * S, W), W)
    want = np.asarray(p2_pallas(table, idx, steps))
    ref = np.take_along_axis(np.broadcast_to(table, (steps, S, W)).reshape(steps * S, W), idx, axis=1)
    assert (want == ref).all()
    assert (lane_gather_plain(_t(table), _t(idx)).numpy() == want).all()
    assert (lane_gather(_t(table), _t(idx)).numpy() == want).all()


def test_p3_plain_equals_pallas():
    R, ch, steps = 64, 16, 3
    rng = np.random.default_rng(3)
    tab, idx = _ints(rng, (R, 128)), _ints(rng, (steps * ch, 128), R)
    want = np.asarray(p3_pallas(tab, idx, ch))
    assert (want == np.take_along_axis(tab, idx, axis=0)).all()
    assert (sublane_gather_plain(_t(tab), _t(idx), 0).numpy() == want).all()
    assert (sublane_gather(_t(tab), _t(idx), 0).numpy() == want).all()


def test_p4_plain_equals_pallas_and_k1():
    R, br = 64, 16
    rng = np.random.default_rng(4)
    v, idx = _ints(rng, (R, 128)), _ints(rng, (R, 128), 128)
    want = np.asarray(p4_pallas(v, idx, br))
    assert (want == np.take_along_axis(v, idx, axis=1)).all()
    plain = lane_gather_plain(_t(v), _t(idx))
    assert (plain.numpy() == want).all()
    assert torch.equal(plain, lane_shuffle_plain(_t(v), _t(idx)))
    assert (lane_gather(_t(v), _t(idx)).numpy() == want).all()


def test_p5_plain_equals_pallas():
    R, br = 64, 16
    rng = np.random.default_rng(5)
    v, idx = _ints(rng, (R, 128)), _ints(rng, (R, 128), 8)
    want = np.asarray(p5_pallas(v, idx, br))
    ref = np.take_along_axis(v.reshape(-1, 8, 128), idx.reshape(-1, 8, 128), axis=1).reshape(R, 128)
    assert (want == ref).all()
    assert (sublane_gather_plain(_t(v), _t(idx), 8).numpy() == want).all()
    assert (sublane_gather(_t(v), _t(idx), 8).numpy() == want).all()


def test_sublane_gather_other_group_sizes():
    rng = np.random.default_rng(6)
    v, idx = _ints(rng, (48, 128)), _ints(rng, (48, 128), 16)
    ref = np.take_along_axis(v.reshape(-1, 16, 128), idx.reshape(-1, 16, 128), axis=1).reshape(48, 128)
    assert (sublane_gather(_t(v), _t(idx), 16).numpy() == ref).all()


def _i32(shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("tab,idx", [
    (_i32((8, 128)).to(torch.int64), _i32((8, 128))),  # wrong dtype
    (_i32((8, 128)), _i32((8, 128)).to(torch.int8)),
    (_i32((8, 128)), _i32((8, 64))),  # widths differ
    (_i32((3, 128)), _i32((8, 128))),  # T does not divide N
    (_i32((8,)), _i32((8,))),  # not 2-D
    (_i32((0, 128)), _i32((0, 128))),  # empty table
])
def test_lane_gather_refuses(tab, idx):
    with pytest.raises(ValueError):
        lane_gather(tab, idx)


@pytest.mark.parametrize("tab,idx,group", [
    (_i32((8, 128)).to(torch.int16), _i32((8, 128)), 0),
    (_i32((8, 64)), _i32((8, 64)), 0),  # not 128 lanes
    (_i32((16, 128)), _i32((8, 128)), 8),  # group > 0 needs equal rows
    (_i32((12, 128)), _i32((12, 128)), 8),  # 8 does not divide 12
    (_i32((8, 128)), _i32((8, 128)), -1),
])
def test_sublane_gather_refuses(tab, idx, group):
    with pytest.raises(ValueError):
        sublane_gather(tab, idx, group)


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_gather_caps_script_on_cpu():
    from tpu_gossip_torch.experiments import pallas_gather_caps

    _, text = _run(pallas_gather_caps.main, "cpu", rows=(8, 64))
    lines = text.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [f"rows={r} axis={a}" for a in (0, 1) for r in (8, 64)]
    assert all(": OK " in ln for ln in lines)


def test_wide_lane_gather_script_on_cpu():
    from tpu_gossip_torch.experiments import pallas_wide_lane_gather

    _, text = _run(pallas_wide_lane_gather.main, "cpu", shapes=((8, 256, 2), (16, 128, 4)))
    lines = text.splitlines()
    assert len(lines) == 2 and all(": OK " in ln for ln in lines)


def test_gather_probe_script_on_cpu():
    from tpu_gossip_torch.experiments import gather_probe

    results, text = _run(gather_probe.main, "cpu", n=2**14, e=3 * 2**14 + 1000, ch=16)
    assert list(results) == ["flat", "row8", "row32", "row128", "row512", "taa0", "lane", "pallas_taa0"]
    assert "pallas taa0 resident table: OK" in text
    assert "summary (ms at E=" in text


def test_perm_pipeline_script_on_cpu():
    from tpu_gossip_torch.experiments import perm_pipeline_probe

    _, text = _run(perm_pipeline_probe.main, "cpu", e=128 * 256)
    assert "pallas lane shuffle 0.0M: OK" in text
    assert "pallas sublane shuffle 0.0M: OK" in text
    assert text.count("composed") == 2
