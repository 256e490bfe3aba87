"""``memory_budget.toml`` beside this package: the committed residency budget.

Every matrix entry's CPU peak live bytes and constant bytes are pinned in
the file; an entry more than :data:`TOLERANCE` over its line is a
``mem-budget-regression``, an entry with no line a ``mem-budget-missing``.
Lines naming no entry are reported as stale and do not fail. Refresh
deliberately with ``python -m tpu_gossip_torch.analysis --device cpu
--write-budget``: the file's diff is the review. The format is the JAX
tier's (``version`` and ``[[entry]]`` tables); the root
``memory_budget.toml`` is the JAX package's and is not this file.
"""

from __future__ import annotations

from pathlib import Path

from tpu_gossip_torch.analysis.baseline import read_tables
from tpu_gossip_torch.analysis.registry import Finding

__all__ = ["DEFAULT_BUDGET", "TOLERANCE", "load_budget", "write_budget", "budget_findings"]

DEFAULT_BUDGET = Path(__file__).resolve().parent.parent / "memory_budget.toml"
TOLERANCE = 0.05  # an entry may grow 5% over its line before it fails
REGRESSION_RULE = "mem-budget-regression"
MISSING_RULE = "mem-budget-missing"
_GATED_FIELDS = ("peak_bytes", "const_bytes")


def _parse_value(raw: str):
    raw = raw.strip()
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in ("'", '"'):
        return raw[1:-1]
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    return raw


def load_budget(path: str | Path) -> dict:
    """name -> {n_peers, peak_bytes, const_bytes, bytes_per_peer}; empty
    when the file is missing (every entry then reports missing)."""
    return {t["name"]: {k: v for k, v in t.items() if k != "name"}
            for t in read_tables(path, "entry", _parse_value) if "name" in t}


def write_budget(path: str | Path, ledgers: dict) -> None:
    """Write the budget from name -> EntryLedger."""
    lines = [
        "# The port's memory budget: each matrix entry's peak live bytes on the CPU",
        "# (tpu_gossip_torch/analysis/mem/ledger.py, from the op recorder).",
        "# An entry more than 5% over its line fails. Refresh:",
        "#   python -m tpu_gossip_torch.analysis --device cpu --write-budget",
        "version = 1",
    ]
    for name in sorted(ledgers):
        led = ledgers[name]
        lines += ["", "[[entry]]", f'name = "{name}"', f"n_peers = {led.n_peers}", f"peak_bytes = {led.peak_bytes}",
                  f"const_bytes = {led.const_bytes}", f"bytes_per_peer = {led.bytes_per_peer}"]
    Path(path).write_text("\n".join(lines) + "\n")


def budget_findings(ledgers: dict, budget: dict) -> tuple[list, list]:
    """(findings, stale names) of the ledgers against the budget."""
    findings: list[Finding] = []
    for name in sorted(ledgers):
        led, pinned = ledgers[name], budget.get(name)
        if pinned is None:
            findings.append(Finding(
                file=f"<mem:{name}>", line=0, col=0, rule=MISSING_RULE,
                message=f"matrix entry has no line in the budget (peak {led.peak_bytes} B, {led.bytes_per_peer} "
                "B/peer unbudgeted)",
                hint="price the entry: python -m tpu_gossip_torch.analysis --device cpu --write-budget, and "
                "review the diff", qualname=name))
            continue
        for field in _GATED_FIELDS:
            allowed, got = pinned.get(field), getattr(led, field)
            if isinstance(allowed, (int, float)) and got > allowed * (1.0 + TOLERANCE):
                findings.append(Finding(
                    file=f"<mem:{name}>", line=0, col=0, rule=REGRESSION_RULE,
                    message=f"{field} {got} B exceeds the budget {int(allowed)} B by "
                    f"{got / max(allowed, 1) - 1:.1%} (> {TOLERANCE:.0%}; top residents: {led.top[:3]})",
                    hint="shrink the regression, or refresh with --write-budget if the growth is deliberate",
                    qualname=name))
    return findings, sorted(set(budget) - set(ledgers))
