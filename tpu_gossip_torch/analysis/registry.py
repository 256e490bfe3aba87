"""Finding record and rule registry of the port's analysis tier.

A *rule* is a callable ``rule(module: ModuleInfo) -> Iterable[Finding]``
registered under a stable kebab-case id. Rules are pure AST passes: they
import nothing of the code they analyse and execute none of it, so the
linter runs on a tree whose runtime is broken. The contract audit
(``contracts.py``) and the memory tier (``mem/``) are the dynamic passes
and live outside this registry.

Suppression layers, strongest first:

1. ``# graftlint: disable=<rule>[,<rule>] -- <reason>`` on the finding's
   line (``walker.py`` parses it; a pragma without a reason is itself a
   finding, ``pragma-needs-reason``, and one naming no known rule is
   ``pragma-unknown-rule``).
2. ``lint_baseline.toml`` beside this file (``baseline.py``), keyed on
   (file, rule, qualname); it stays empty.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable

__all__ = ["Finding", "RULES", "DYNAMIC_RULES", "MEM_RULES", "rule", "run_rules"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: where, which rule, what, and how to fix it."""

    file: str  # repo-relative posix path
    line: int  # 1-based; 0 = whole-file or non-positional (contract audit)
    col: int
    rule: str
    message: str
    hint: str = ""
    # enclosing function or check: the identity anchor a baseline keys on
    # (line numbers drift with any edit above, messages with shapes)
    qualname: str = ""

    @property
    def baseline_key(self) -> tuple[str, str, str]:
        """(file, rule, qualname), or (file, rule, message) without one."""
        return (self.file, self.rule, self.qualname or self.message)

    @property
    def sort_key(self) -> tuple:
        """Identity-stable order for machine-readable output."""
        return (self.file, self.rule, self.qualname, self.message, self.line)

    def render(self) -> str:
        loc = f"{self.file}:{self.line}:{self.col}" if self.line else self.file
        out = f"{loc}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


RULES: Dict[str, Callable] = {}

# the dynamic passes' ids: not per-module AST rules, but pragmas may name
# them (mem-widening-cast honours line pragmas at the emitting source line)
DYNAMIC_RULES = frozenset({"contract-audit"})
MEM_RULES = frozenset({
    "mem-plane-width",
    "mem-widening-cast",
    "mem-hot-clone",
    "mem-wire-drift",
    "mem-budget-regression",
    "mem-budget-missing",
    "mem-trace-error",
})


def rule(rule_id: str):
    """Register a rule under ``rule_id`` (decorator)."""

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = fn
        fn.rule_id = rule_id
        return fn

    return deco


def pragma_suppresses(pragmas: dict, line: int, rule_id: str) -> bool:
    """True when a pragma on ``line`` names ``rule_id`` (or ``*``)."""
    prag = pragmas.get(line)
    return prag is not None and ("*" in prag.rules or rule_id in prag.rules)


def run_rules(module, only: Iterable[str] | None = None) -> list[Finding]:
    """Every registered rule over one module, pragmas applied, plus the
    pragma hygiene findings."""
    findings: list[Finding] = []
    for rid in tuple(only) if only is not None else tuple(RULES):
        for f in RULES[rid](module):
            if not pragma_suppresses(module.pragmas, f.line, f.rule):
                findings.append(f)
    seen: set[int] = set()
    for line, prag in sorted(module.pragmas.items()):
        if id(prag) in seen:
            continue  # a comment-line pragma is registered on the next code line too
        seen.add(id(prag))
        if not prag.reason:
            findings.append(Finding(
                file=module.rel, line=line, col=1, rule="pragma-needs-reason",
                message=f"graftlint pragma suppresses {','.join(sorted(prag.rules))} without a reason",
                hint="write `# graftlint: disable=<rule> -- <why this is deliberate>`",
            ))
        unknown = prag.rules - set(RULES) - DYNAMIC_RULES - MEM_RULES - {"*", "pragma-needs-reason"}
        if unknown:
            findings.append(Finding(
                file=module.rel, line=line, col=1, rule="pragma-unknown-rule",
                message=f"graftlint pragma names unknown rule(s): {','.join(sorted(unknown))}",
                hint=f"known rules: {', '.join(sorted(RULES))}",
            ))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings
