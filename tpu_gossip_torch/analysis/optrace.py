"""The op recorder the dynamic passes share: every aten op an entry runs.

The counterpart of the JAX tier's jaxpr walk (``deep/jaxpr_tools.py``).
:func:`record_ops` runs a block under a
``torch.utils._python_dispatch.TorchDispatchMode`` and keeps, for each
aten op, its name, its inputs' and outputs' shapes, dtypes and storages,
and the innermost ``tpu_gossip_torch/`` frame that issued it (the
recorder's own frames and the analysis tier's excluded) as ``file:line``.

It also tracks the live storages: a storage is alive from the op whose
output first holds it until it is freed, which a ``weakref.finalize`` on
its ``untyped_storage()`` reports (torch keeps one Python object per live
storage). The state's own storages and the constants the ops read (plan
tables, compiled schedules: storages older than the block) are priced
apart. ``peak_bytes`` is the state's bytes plus the most bytes the block's
own storages held at once.

``TorchDispatchMode`` is a private API; ``tests/test_torch_analysis_mem.py``
pins the behaviour this module relies on. The recorder runs on the CPU
only: on the card, ``torch.cuda.max_memory_allocated`` measures instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpEvent", "OpRecord", "record_ops", "tensor_leaves", "src_of_frame"]

_PKG = "/tpu_gossip_torch/"
_SKIP = ("/tpu_gossip_torch/analysis/",)
_TOP_K = 8


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One aten op: its name, (shape, dtype) of every tensor in and out,
    the storages it read and made, and its source line."""

    op: str
    inputs: tuple
    outputs: tuple
    in_storages: tuple
    new_storages: tuple
    src: str  # "tpu_gossip_torch/<file>.py:<line>" or "" outside the package
    function: str


@dataclasses.dataclass
class OpRecord:
    """Everything :func:`record_ops` saw."""

    events: list = dataclasses.field(default_factory=list)
    state_bytes: int = 0
    const_bytes: int = 0
    peak_bytes: int = 0  # state bytes + the block's peak live bytes
    top: list = dataclasses.field(default_factory=list)  # [[src, bytes], ...] live at the peak
    live_at_exit: int = 0


def tensor_leaves(obj) -> list:
    """Every tensor in a (nested) dataclass, NamedTuple, tuple, list or dict."""
    out = []
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            out += tensor_leaves(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            out += tensor_leaves(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            out += tensor_leaves(x)
    return out


def src_of_frame(frame) -> tuple[str, str]:
    """(``file:line``, function) of the innermost package frame at or above
    ``frame``, or ("", "")."""
    while frame is not None:
        fn = frame.f_code.co_filename.replace("\\", "/")
        if _PKG in fn and not any(s in fn for s in _SKIP):
            rel = "tpu_gossip_torch/" + fn.split(_PKG, 1)[1]
            return f"{rel}:{frame.f_lineno}", frame.f_code.co_name
        frame = frame.f_back
    return "", ""


def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


class _Recorder(TorchDispatchMode):
    def __init__(self, state):
        super().__init__()
        self.rec = OpRecord()
        self._state = set()
        self._const: set[int] = set()
        self._live: dict[int, tuple[int, str]] = {}  # the block's own live storages -> (nbytes, src)
        self._live_bytes = 0
        for t in tensor_leaves(state):
            s = t.untyped_storage()
            if id(s) not in self._state:
                self._state.add(id(s))
                self.rec.state_bytes += s.nbytes()

    def _freed(self, sid: int) -> None:
        nbytes, _ = self._live.pop(sid, (0, ""))
        self._live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tensor_leaves(list(args)) + tensor_leaves(kwargs)
        outs = tensor_leaves(out)
        if any(t.device.type != "cpu" for t in ins + outs):
            raise RuntimeError("the op recorder runs on the CPU only; measure the card with "
                               "torch.cuda.max_memory_allocated")
        src, fn = src_of_frame(sys._getframe(1))
        in_ids = []
        for t in ins:
            s = t.untyped_storage()
            sid = id(s)
            in_ids.append(sid)
            if sid not in self._state and sid not in self._live and sid not in self._const:
                self._const.add(sid)
                self.rec.const_bytes += s.nbytes()
        new = []
        for t in outs:
            s = t.untyped_storage()
            sid = id(s)
            if sid in self._live or sid in self._state or sid in self._const or sid in new:
                continue
            new.append(sid)
            self._live[sid] = (s.nbytes(), src or "<outside the package>")
            self._live_bytes += s.nbytes()
            weakref.finalize(s, self._freed, sid)
        if self._live_bytes + self.rec.state_bytes > self.rec.peak_bytes:
            self.rec.peak_bytes = self._live_bytes + self.rec.state_bytes
            by_src: dict[str, int] = {}
            for nbytes, where in self._live.values():
                by_src[where] = by_src.get(where, 0) + nbytes
            self.rec.top = [[k, v] for k, v in sorted(by_src.items(), key=lambda kv: (-kv[1], kv[0]))[:_TOP_K]]
        self.rec.events.append(OpEvent(op=str(func), inputs=tuple(_spec(t) for t in ins),
                                       outputs=tuple(_spec(t) for t in outs), in_storages=tuple(in_ids),
                                       new_storages=tuple(new), src=src, function=fn))
        return out


@contextlib.contextmanager
def record_ops(state):
    """Record the aten ops the block runs (``state``: the entry's input,
    whose storages are priced as the state); yields the :class:`OpRecord`,
    complete when the block exits."""
    mode = _Recorder(state)
    with mode:
        yield mode.rec
    mode.rec.peak_bytes = max(mode.rec.peak_bytes, mode.rec.state_bytes)
    mode.rec.live_at_exit = mode._live_bytes
