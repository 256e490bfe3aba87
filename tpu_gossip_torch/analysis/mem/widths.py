"""Declared widths: the state's planes against ``PLANES``, and widening casts.

- ``mem-plane-width``: ``core.state.PLANES`` covers exactly the fields of
  ``SwarmState``, and every plane of every entry's input and output state
  materialises exactly its declared dtype (a packed state's ``"bits"``
  planes as uint8 words; the key is the port's int64 (2,) threefry words).
  Wider is the regression the bytes-a-peer budget exists to stop;
  narrower is the same finding (the registry is the one width truth).
- ``mem-widening-cast``: a ``_to_copy``/``to`` in an entry's recorded ops
  (``optrace.py``) that widens an integer or float operand already 16 bits
  or wider with at least N elements (N: the entry's state rows). Bool to
  int mask materialisations are exempt. A deliberate cast keeps a line
  pragma with its reason at the source line that issued it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from tpu_gossip_torch.analysis.registry import Finding, pragma_suppresses

__all__ = ["width_findings", "plane_width_findings", "widening_cast_findings", "n_rows"]

WIDTH_RULE = "mem-plane-width"
CAST_RULE = "mem-widening-cast"
_STATE_FILE = "tpu_gossip_torch/core/state.py"
_CASTS = ("aten._to_copy.", "aten.to.")


def n_rows(state) -> int:
    """The state's peer rows (a fleet's lanes times its rows)."""
    seen = state.seen
    return int(np.prod(seen.shape[:-1]))


def _np(dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


def _finding(name: str, message: str, hint: str) -> Finding:
    return Finding(file=_STATE_FILE, line=0, col=0, rule=WIDTH_RULE, message=message, hint=hint,
                   qualname=f"SwarmState.{name}")


def plane_width_findings(ran: dict) -> list:
    """The registry against the dataclass, then every materialised plane."""
    from tpu_gossip_torch.core.packed import PackedSwarm
    from tpu_gossip_torch.core.state import SwarmState, plane_registry

    reg = plane_registry()
    fields = {f.name for f in dataclasses.fields(SwarmState)}
    out = [_finding(n, f"SwarmState.{n} has no declared width in the PLANES registry",
                    "add a PlaneSpec to core.state.PLANES with the minimal dtype and its cap")
           for n in sorted(fields - set(reg))]
    out += [_finding(n, f"PLANES declares {n!r} but SwarmState has no such field",
                     "drop the PlaneSpec, or restore the plane") for n in sorted(set(reg) - fields)]
    seen: set = set()
    for r in ran.values():
        states = [r.state] + ([r.out[0]] if isinstance(r.out, tuple) else [r.out])
        for st in states:
            if st is None or not dataclasses.is_dataclass(st):
                continue
            packed = isinstance(st, PackedSwarm)
            for f in dataclasses.fields(st):
                spec = reg.get(f.name)
                leaf = getattr(st, f.name)
                if spec is None or f.name in seen or not hasattr(leaf, "dtype"):
                    continue
                if spec.dtype == "key":
                    want = np.dtype("int64")
                elif packed and spec.packed == "bits":
                    want = np.dtype("uint8")
                else:
                    want = np.dtype(spec.dtype)
                got = _np(leaf.dtype)
                if got != want:
                    seen.add(f.name)
                    direction = "WIDER" if got.itemsize > want.itemsize else "narrower"
                    out.append(_finding(f.name, f"SwarmState.{f.name} materialises {got}: {direction} than the "
                                        f"declared {want} ({spec.why}) (first seen in {r.ep.name})",
                                        "materialise the declared dtype, or widen the PlaneSpec in the same "
                                        "commit with the new cap written down"))
    return out


@functools.lru_cache(maxsize=None)
def _module_pragmas(rel: str):
    from tpu_gossip_torch.analysis.cli import repo_root
    from tpu_gossip_torch.analysis.walker import ModuleInfo

    path = repo_root() / rel
    if not path.is_file():
        return {}
    try:
        return ModuleInfo(path, rel).pragmas
    except SyntaxError:
        return {}


def widening_cast_findings(ran: dict) -> list:
    """The widening casts of every recorded entry, once a (site, widths)."""
    out: list[Finding] = []
    seen: set = set()
    for name, r in ran.items():
        if r.record is None:
            continue
        n = n_rows(r.state)
        for ev in r.record.events:
            if not ev.op.startswith(_CASTS) or not ev.inputs or not ev.outputs:
                continue
            (shape, old), (_, new) = ev.inputs[0], ev.outputs[0]
            old, new = np.dtype(old), np.dtype(new)
            if not (old.kind in "iuf" and new.kind in "iuf" and old.itemsize >= 2 and new.itemsize > old.itemsize
                    and int(np.prod(shape)) >= max(n, 1)):
                continue
            file, _, line = ev.src.rpartition(":")
            if file and pragma_suppresses(_module_pragmas(file), int(line), CAST_RULE):
                continue
            key = (ev.src, str(old), str(new))
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                file=file or f"<mem:{name}>", line=int(line) if file else 0, col=0, rule=CAST_RULE,
                message=f"widening cast {old}->{new} on a {shape} operand in {ev.function or 'the round'} "
                f"(first seen running {name})",
                hint="keep N-scale arithmetic at the plane's declared width, or carry a line pragma with the "
                "reason: # graftlint: disable=mem-widening-cast -- <why>",
                qualname=ev.function or name))
    return out


def width_findings(ran: dict) -> list:
    return plane_width_findings(ran) + widening_cast_findings(ran)
