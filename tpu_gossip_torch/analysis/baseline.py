"""The port's lint baseline: ``tpu_gossip_torch/analysis/lint_baseline.toml``.

A finding whose identity (file, rule, qualname) appears in the baseline is
reported as baselined and does not fail the run. The committed file stays
empty: a deliberate exception belongs inline, as a ``# graftlint:
disable=<rule> -- <reason>`` pragma where the next reader sees it.

A minimal reader and writer for the subset the file uses (top-level scalar
keys and ``[[finding]]`` tables of string values) live here; Python 3.10
has no ``tomllib``.
"""

from __future__ import annotations

from pathlib import Path

from tpu_gossip_torch.analysis.registry import Finding

__all__ = ["DEFAULT_BASELINE", "load_baseline", "write_baseline", "split_new", "read_tables"]

DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.toml"


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in ("'", '"'):
        body = s[1:-1]
        if s[0] == '"':
            body = (body.replace("\\\\", "\x00").replace('\\"', '"').replace("\\n", "\n")
                    .replace("\\t", "\t").replace("\x00", "\\"))
        return body
    return s


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n").replace("\t", "\\t") + '"'


def read_tables(path: str | Path, header: str, parse=_unquote) -> list[dict]:
    """The ``[[header]]`` tables of a restricted TOML file, each a dict of
    its keys; empty when the file is missing."""
    p = Path(path)
    if not p.is_file():
        return []
    tables: list[dict] = []
    cur: dict | None = None
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == f"[[{header}]]":
            cur = {}
            tables.append(cur)
        elif "=" in line and cur is not None:
            key, _, value = line.partition("=")
            cur[key.strip()] = parse(value)
    return tables


def load_baseline(path: str | Path) -> set[tuple[str, str, str]]:
    """Identity triples (file, rule, qualname or message) of the baseline."""
    return {(t["file"], t["rule"], t.get("qualname") or t.get("message", ""))
            for t in read_tables(path, "finding") if "file" in t and "rule" in t}


def write_baseline(path: str | Path, findings: list[Finding]) -> None:
    """Write ``findings`` in a deterministic order (rule, file, line,
    qualname, message), each identity once."""
    lines = [
        "# The port's graftlint baseline: findings suppressed from the exit code.",
        "# Keep it empty; a deliberate pattern takes an inline pragma with its reason.",
        "# Regenerate: python -m tpu_gossip_torch.analysis --write-baseline",
        "version = 1",
    ]
    seen = set()
    for f in sorted(findings, key=lambda f: (f.rule, f.file, f.line, f.qualname, f.message)):
        if f.baseline_key in seen:
            continue
        seen.add(f.baseline_key)
        lines += ["", "[[finding]]", f"file = {_quote(f.file)}", f"line = {int(f.line)}", f"rule = {_quote(f.rule)}"]
        if f.qualname:
            lines.append(f"qualname = {_quote(f.qualname)}")
        lines.append(f"message = {_quote(f.message)}")
    Path(path).write_text("\n".join(lines) + "\n")


def split_new(findings: list[Finding], baseline: set) -> tuple[list[Finding], list[Finding]]:
    """(new, baselined) partition of ``findings``."""
    new, old = [], []
    for f in findings:
        (old if f.baseline_key in baseline else new).append(f)
    return new, old
