"""graftmem for the port: the memory tier over the shared entry matrix.

- :mod:`.widths`: every state plane materialises its declared ``PLANES``
  dtype (``mem-plane-width``); widening casts of N-scale operands in the
  recorded ops (``mem-widening-cast``, line pragmas honoured).
- :mod:`.ledger`: each entry's peak live bytes on the CPU from the op
  recorder, its top residents by ``file:line`` (``mem-hot-clone`` when a
  round clones its state).
- :mod:`.budget`: ``memory_budget.toml`` beside the package, 5% tolerance
  (``mem-budget-regression``, ``mem-budget-missing``).
- :mod:`.wire`: the dense mesh entries' ``all_to_all`` words against
  ``dense_wire_words`` and the ICI counter (``mem-wire-drift``).

Run: ``python -m tpu_gossip_torch.analysis --device cpu --mem`` (or
``--mem-only``; ``--write-budget`` refreshes the budget). The recorder
runs on the CPU only: on a card the tier refuses, and ``chip_smoke.py``
phase 18 reads ``torch.cuda.max_memory_allocated`` instead.
"""

from __future__ import annotations

from tpu_gossip_torch.analysis.registry import MEM_RULES  # noqa: F401

__all__ = ["run_mem", "MEM_RULES"]


def run_mem(device, cache: dict | None = None, *, budget_path=None, check_budget: bool = True,
            names=None) -> tuple[list, dict]:
    """Every memory pass over the matrix (or the entries ``names``) on the
    CPU; returns (sorted findings, report). ``check_budget=False`` prices
    without judging (``--write-budget``)."""
    from pathlib import Path

    import torch

    from tpu_gossip_torch.analysis.entrypoints import entry_points, run_matrix
    from tpu_gossip_torch.analysis.mem.budget import DEFAULT_BUDGET, budget_findings, load_budget
    from tpu_gossip_torch.analysis.mem.ledger import ledger_findings
    from tpu_gossip_torch.analysis.mem.widths import width_findings
    from tpu_gossip_torch.analysis.mem.wire import wire_findings
    from tpu_gossip_torch.core.state import state_bytes_per_peer

    if torch.device(device).type != "cpu":
        raise ValueError("the memory tier records ops on the CPU only (--device cpu); on a card chip_smoke.py "
                         "phase 18 reads torch.cuda.max_memory_allocated")
    eps = [ep for ep in entry_points() if names is None or ep.name in names]
    # an unrecorded pass first: module-level caches (tables built once a
    # device) then exist before any recorded run, whatever the subset
    run_matrix(eps, device, cache=cache)
    ran = run_matrix(eps, device, cache=cache, record=True)
    findings, ledgers = ledger_findings(ran)
    findings += width_findings(ran)
    wfindings, wire_report = wire_findings(eps, device)
    findings += wfindings
    budget_path = Path(budget_path) if budget_path else DEFAULT_BUDGET
    stale: list = []
    if check_budget:
        bfindings, stale = budget_findings(ledgers, load_budget(budget_path))
        findings += bfindings
        if names is not None:
            stale = []
    findings.sort(key=lambda f: f.sort_key)
    report = {
        "entries": {name: {"n_peers": led.n_peers, "state_bytes": led.state_bytes, "const_bytes": led.const_bytes,
                           "peak_bytes": led.peak_bytes, "bytes_per_peer": led.bytes_per_peer, "top": led.top}
                    for name, led in sorted(ledgers.items())},
        "wire": wire_report,
        "stale_budget_entries": stale,
        "budget_path": str(budget_path),
        # the declared state bytes a peer at 1M, 16 slots (PLANES alone, no arrays)
        "state_bytes_per_peer_1m": round(state_bytes_per_peer(1_000_000, 16, packed=True), 3),
        "state_bytes_per_peer_1m_unpacked": round(state_bytes_per_peer(1_000_000, 16), 3),
        "ledgers": ledgers,
    }
    return findings, report
