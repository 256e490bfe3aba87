"""Each entry's residency ledger, from the op recorder, and ``mem-hot-clone``.

The recorder (``optrace.py``) tracks every storage an entry's run makes,
alive from the op that makes it until its ``weakref`` finaliser reports it
freed. An entry's ledger holds its state's bytes, the constants its ops
read (plan tables, compiled schedules), its peak live bytes (the state
plus the most bytes its own storages held at once) a peer row, and the
top resident intermediates at the peak by ``file:line``. The budget
(``budget.py``) gates ``peak_bytes`` and ``const_bytes``.

The peaks are the CPU's (the kernels' plain versions); on the card
``chip_smoke.py`` phase 18 prints each entry's
``torch.cuda.max_memory_allocated`` beside them.

``mem-hot-clone``: ``core.state.clone_state`` is the caller's escape
hatch (a state that outlives its run); called inside a round it copies the
whole state every round. The recorder sees it as ops issued from
``clone_state``.
"""

from __future__ import annotations

import dataclasses

from tpu_gossip_torch.analysis.registry import Finding

__all__ = ["EntryLedger", "entry_ledger", "ledger_findings"]

CLONE_RULE = "mem-hot-clone"


@dataclasses.dataclass
class EntryLedger:
    """One entry's residency report."""

    name: str
    n_peers: int
    state_bytes: int
    const_bytes: int
    peak_bytes: int
    top: list  # [[file:line, bytes], ...] at the peak, descending
    bytes_per_peer: float = 0.0

    def __post_init__(self):
        self.bytes_per_peer = round(self.peak_bytes / max(self.n_peers, 1), 2)


def entry_ledger(name: str, ran) -> EntryLedger | None:
    """The ledger of one recorded run (None when it did not run)."""
    from tpu_gossip_torch.analysis.mem.widths import n_rows

    rec = ran.record
    if rec is None:
        return None
    return EntryLedger(name=name, n_peers=n_rows(ran.state), state_bytes=rec.state_bytes,
                       const_bytes=rec.const_bytes, peak_bytes=rec.peak_bytes, top=[list(t) for t in rec.top])


def ledger_findings(ran: dict) -> tuple[list, dict]:
    """(findings, name -> EntryLedger): an entry that failed to run is a
    ``mem-trace-error``, a round that clones its state ``mem-hot-clone``."""
    findings: list[Finding] = []
    ledgers: dict = {}
    for name, r in ran.items():
        if r.error is not None:
            findings.append(Finding(file=f"<mem:{name}>", line=0, col=0, rule="mem-trace-error",
                                    message=f"entry failed to run: {r.error}",
                                    hint="the ledger needs a running round; the contract audit reports the same "
                                    "break", qualname=name))
            continue
        led = entry_ledger(name, r)
        if led is None:
            continue
        ledgers[name] = led
        for ev in r.record.events:
            if ev.function == "clone_state":
                findings.append(Finding(
                    file=f"<mem:{name}>", line=0, col=0, rule=CLONE_RULE,
                    message=f"clone_state runs inside the round ({ev.src}): one whole state copy every round",
                    hint="clone_state is the caller's escape hatch for a state that outlives its run; hoist it "
                    "out of the round", qualname=name))
                break  # one finding an entry
    return findings, ledgers
