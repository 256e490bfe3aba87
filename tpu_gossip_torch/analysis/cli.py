"""The port's graftlint CLI: ``python -m tpu_gossip_torch.analysis`` or
``tpu-gossip-torch-lint``.

Exit codes: 0 clean (no finding beyond the baseline), 1 new findings, 2 a
usage error. The default scope is the port's package and ``chip_smoke.py``
(tests are exempt: they build pathological inputs on purpose), then the
contract audit over the entry matrix; ``--mem`` adds the memory tier.
Explicit paths lint just those files and skip the dynamic passes (linting
a fixture must not run it). The dynamic passes run each entry on
``--device``: ``cuda`` (the default) raises without a card, ``cpu`` runs
every kernel's plain version.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from tpu_gossip_torch.analysis.baseline import DEFAULT_BASELINE, load_baseline, split_new, write_baseline
from tpu_gossip_torch.analysis.registry import RULES, Finding, run_rules
from tpu_gossip_torch.analysis.walker import ModuleInfo, Project

__all__ = ["main", "lint_paths", "modules_for", "repo_root", "DEFAULT_SCOPE"]

DEFAULT_SCOPE = ("tpu_gossip_torch", "chip_smoke.py")
_EXCLUDE_PARTS = {"tests", ".git", "__pycache__", "_build"}


def repo_root() -> Path:
    """The checkout holding this package (its pyproject.toml)."""
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "pyproject.toml").is_file():
            return parent
    return here.parents[2]


def _collect_files(root: Path, paths: list[str]) -> list[Path]:
    files: list[Path] = []
    for p in paths:
        pt = Path(p) if Path(p).is_absolute() else root / p
        if pt.is_dir():
            files.extend(f for f in sorted(pt.rglob("*.py")) if not set(f.relative_to(pt).parts) & _EXCLUDE_PARTS)
        elif pt.is_file():
            files.append(pt)
        else:
            raise FileNotFoundError(f"no such file or directory: {p}")
    return files


def modules_for(root: Path, paths: list[str]) -> list[ModuleInfo]:
    """ModuleInfos of ``paths`` under their repo-relative names."""
    modules = []
    for f in _collect_files(root, paths):
        try:
            rel = str(f.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(f)
        modules.append(ModuleInfo(f, rel))
    return modules


def lint_paths(paths: list[str], *, root: Path | None = None, rules=None) -> list[Finding]:
    """The AST rules over ``paths`` (files or directories), sorted; the
    round reachability is the fixpoint over everything collected."""
    from tpu_gossip_torch.analysis import rules_purity

    root = repo_root() if root is None else Path(root)
    modules = modules_for(root, paths)
    rules_purity.set_project(Project(modules))
    try:
        findings: list[Finding] = []
        for m in modules:
            findings.extend(run_rules(m, only=rules))
    finally:
        rules_purity.set_project(None)
    return sorted(findings, key=lambda f: (f.file, f.line, f.col, f.rule))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-gossip-torch-lint",
        description="graftlint for the port: key linearity, the global torch RNG, host reads in rounds, raw "
        "collectives and in-place state writes, plus the contract audit and the memory tier run on a device.")
    ap.add_argument("paths", nargs="*", help="files or directories to lint (default: tpu_gossip_torch/ "
                    "chip_smoke.py and the contract audit)")
    ap.add_argument("--device", default="cuda", help="device the dynamic passes run the entries on "
                    "(default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--json", action="store_true", help="print {clean, new, baselined, rules, mem_report, ...} "
                    "as JSON")
    ap.add_argument("--rules", default=None, help="comma-separated AST rule subset")
    ap.add_argument("--no-contracts", action="store_true", help="skip the contract audit")
    ap.add_argument("--contracts-only", action="store_true", help="run only the contract audit")
    ap.add_argument("--mem", action="store_true", help="add the memory tier (plane widths, widening casts, "
                    "peak live bytes against the budget, the wire census)")
    ap.add_argument("--mem-only", action="store_true", help="run only the memory tier")
    ap.add_argument("--budget", default=None, help="memory budget file (default: the package's "
                    "memory_budget.toml)")
    ap.add_argument("--write-budget", action="store_true", help="write every entry's ledger to the budget file "
                    "and exit 0")
    ap.add_argument("--baseline", default=None, help="baseline file (default: the package's lint_baseline.toml)")
    ap.add_argument("--write-baseline", action="store_true", help="write the findings to the baseline and exit 0")
    ap.add_argument("--list-rules", action="store_true", help="print the rule ids and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(rid)
        return 0
    root = repo_root()
    only = [r.strip() for r in args.rules.split(",") if r.strip()] if args.rules else None
    if only and set(only) - set(RULES):
        print(f"unknown rule(s): {', '.join(sorted(set(only) - set(RULES)))} (known: {', '.join(sorted(RULES))})",
              file=sys.stderr)
        return 2
    explicit = bool(args.paths)
    if (args.write_budget or args.mem_only or args.contracts_only) and explicit:
        print("--contracts-only/--mem-only/--write-budget run the entry matrix; they take no explicit paths",
              file=sys.stderr)
        return 2
    dedicated = args.contracts_only or args.mem_only or args.write_budget
    run_contracts = (not args.no_contracts and not explicit and only is None and not dedicated) or \
        args.contracts_only
    run_mem = (args.mem or args.mem_only or args.write_budget) and not explicit
    device = None
    if run_contracts or run_mem:
        from tpu_gossip_torch.device import resolve_device

        device = resolve_device(args.device)  # raises on cuda without a card

    t0 = time.perf_counter()
    findings: list[Finding] = []
    if not dedicated:
        try:
            findings = lint_paths(args.paths or list(DEFAULT_SCOPE), root=root, rules=only)
        except (FileNotFoundError, SyntaxError) as e:
            print(str(e), file=sys.stderr)
            return 2
    cache: dict = {}
    if run_contracts:
        from tpu_gossip_torch.analysis.contracts import audit_contracts

        findings += audit_contracts(device, cache=cache)
    mem_report = None
    if run_mem:
        from tpu_gossip_torch.analysis.mem import run_mem as run_mem_tier

        mem_findings, mem_report = run_mem_tier(device, cache=cache, budget_path=args.budget,
                                                check_budget=not args.write_budget)
        ledgers = mem_report.pop("ledgers")
        if args.write_budget:
            from tpu_gossip_torch.analysis.mem.budget import DEFAULT_BUDGET, write_budget

            path = Path(args.budget) if args.budget else DEFAULT_BUDGET
            write_budget(path, ledgers)
            print(f"wrote {len(ledgers)} entry budget(s) to {path}", file=sys.stderr)
            return 0
        findings += mem_findings

    baseline_path = Path(args.baseline) if args.baseline else DEFAULT_BASELINE
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}", file=sys.stderr)
        return 0
    new, old = split_new(findings, load_baseline(baseline_path))
    elapsed = time.perf_counter() - t0
    if args.json:
        print(json.dumps({
            "clean": not new,
            "new": [f.to_dict() for f in sorted(new, key=lambda f: f.sort_key)],
            "baselined": [f.to_dict() for f in sorted(old, key=lambda f: f.sort_key)],
            "rules": sorted(RULES),
            "contract_audit": run_contracts,
            "mem": run_mem,
            "mem_report": mem_report,
            "device": None if device is None else str(device),
            "elapsed_seconds": round(elapsed, 2),
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        print(f"graftlint: {len(new)} new finding(s), {len(old)} baselined, {len(RULES)} rules"
              + (", contract audit on" if run_contracts else "") + (", mem tier on" if run_mem else "")
              + (f" ({device})" if device is not None else "") + f", {elapsed:.1f}s", file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
