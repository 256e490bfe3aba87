"""Module loading, pragma parsing, import resolution, round reachability.

Everything the rules share, computed once a file:

- :class:`ModuleInfo`: source text, AST, pragma map, import alias maps,
  and every function (nested included) as a :class:`FuncInfo`.
- :meth:`ModuleInfo.dotted`: an expression's absolute dotted path through
  the module's imports (``prng.bits`` after ``from tpu_gossip_torch.core
  import prng`` is ``tpu_gossip_torch.core.prng.bits``), so rules never
  match local aliases by string.
- :meth:`Project.round_reachable`: the functions a round can reach, a
  fixpoint over the resolved call graph from :data:`ROUND_ENTRIES`.
  Reachability spreads to resolved callees, to functions nested in a
  reachable one, and to module-level functions passed by name as call
  arguments (a stage's ``fn``, a delivery callback). Calls through objects
  (``plan.partner(...)``) do not resolve statically and are out of reach.

Pragma grammar (line-scoped)::

    # graftlint: disable=<rule>[,<rule>...] [--] <reason>

A reason is required: ``registry.run_rules`` turns a pragma without one
into a ``pragma-needs-reason`` finding.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

__all__ = ["Pragma", "FuncInfo", "ModuleInfo", "Project", "ROUND_ENTRIES", "walk_own", "enclosing"]

# the port's round entry points: (module, function). round-host-sync and
# state-in-place hold everything reachable from them; the list is kept
# here alone and a test resolves every name
ROUND_ENTRIES = (
    ("tpu_gossip_torch.sim.engine", "gossip_round"),
    ("tpu_gossip_torch.sim.engine", "simulate"),
    ("tpu_gossip_torch.sim.engine", "run_until_coverage"),
    ("tpu_gossip_torch.sim.packed_engine", "gossip_round_packed"),
    ("tpu_gossip_torch.dist.mesh", "gossip_round_dist"),
    ("tpu_gossip_torch.dist.mesh", "simulate_dist"),
    ("tpu_gossip_torch.dist.mesh", "run_until_coverage_dist"),
    ("tpu_gossip_torch.dist.matching_mesh", "gossip_round_dist_matching"),
)

_PRAGMA_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Za-z0-9_*,\-]+)[ \t]*(?:--)?[ \t]*(.*)$")


@dataclasses.dataclass(frozen=True)
class Pragma:
    rules: frozenset
    reason: str
    line: int


@dataclasses.dataclass
class FuncInfo:
    """One function (or nested function) definition."""

    qualname: str  # dotted within the module, e.g. "simulate.body"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    parent: "FuncInfo | None"
    # resolved call targets: set of (module_dotted, name)
    calls: set = dataclasses.field(default_factory=set)
    # functions referenced by name as call arguments (higher-order)
    fn_args: set = dataclasses.field(default_factory=set)


class ModuleInfo:
    """Parsed view of one source file, shared by every rule."""

    def __init__(self, path: Path, rel: str, text: str | None = None):
        self.path = Path(path)
        self.rel = rel.replace("\\", "/")
        self.text = self.path.read_text() if text is None else text
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=str(path))
        self.module_dotted = module_dotted(self.rel)
        self.import_aliases: dict[str, str] = {}  # local alias -> module ("np" -> "numpy")
        self.from_imports: dict[str, tuple[str, str]] = {}  # local name -> (module, attr)
        self.pragmas: dict[int, Pragma] = {}
        self.functions: list[FuncInfo] = []
        self._collect_pragmas()
        self._collect_imports()
        self._collect_functions()

    def _collect_pragmas(self) -> None:
        """A pragma suppresses its own line; one on a comment line of its
        own suppresses the next code line too. Comments come from the
        tokenizer, so pragma syntax quoted in a string is text."""
        comments: dict[int, str] = {}
        standalone: set[int] = set()
        try:
            for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    comments[tok.start[0]] = tok.string
                    if self.lines[tok.start[0] - 1].strip().startswith("#"):
                        standalone.add(tok.start[0])
        except tokenize.TokenError:
            return
        for i, comment in sorted(comments.items()):
            m = _PRAGMA_RE.search(comment)
            if not m:
                continue
            rules = frozenset(r.strip() for r in m.group(1).split(",") if r.strip())
            prag = Pragma(rules=rules, reason=m.group(2).strip(), line=i)
            self.pragmas[i] = prag
            if i in standalone:
                for j in range(i, len(self.lines)):
                    nxt = self.lines[j].strip()
                    if nxt and not nxt.startswith("#"):
                        self.pragmas.setdefault(j + 1, prag)
                        break

    def _collect_imports(self) -> None:
        # function-local imports count too (the port imports lazily)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.import_aliases[alias.asname] = alias.name
                    else:
                        head = alias.name.split(".")[0]
                        self.import_aliases[head] = head
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for alias in node.names:
                    self.from_imports[alias.asname or alias.name] = (node.module, alias.name)

    def dotted(self, node: ast.AST) -> str | None:
        """Absolute dotted path of a Name/Attribute chain, or None. A bare
        local name with no import mapping resolves to itself."""
        parts: list[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        base = cur.id
        if base in self.from_imports:
            mod, attr = self.from_imports[base]
            head = f"{mod}.{attr}"
        else:
            head = self.import_aliases.get(base, base)
        return ".".join([head] + list(reversed(parts)))

    def _collect_functions(self) -> None:
        def visit(node: ast.AST, parent: FuncInfo | None, prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fi = FuncInfo(qualname=f"{prefix}{child.name}", node=child, parent=parent)
                    self._index_calls(fi)
                    self.functions.append(fi)
                    visit(child, fi, fi.qualname + ".")
                elif isinstance(child, ast.ClassDef):
                    # methods: indexed under Class.name, reached only by
                    # name (attribute dispatch is dynamic)
                    visit(child, parent, prefix + child.name + ".")
                else:
                    visit(child, parent, prefix)

        visit(self.tree, None, "")

    def _index_calls(self, fi: FuncInfo) -> None:
        own_nested = {sub.name for sub in ast.walk(fi.node)
                      if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and sub is not fi.node}
        for sub in ast.walk(fi.node):
            if not isinstance(sub, ast.Call):
                continue
            target = self._resolve_callable(sub.func)
            if target is not None:
                fi.calls.add(target)
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(arg, ast.Name) and arg.id not in own_nested:
                    t = self._resolve_callable(arg)
                    if t is not None:
                        fi.fn_args.add(t)

    def _resolve_callable(self, node: ast.AST):
        """(module_dotted, name) of a callee expression, if resolvable."""
        if isinstance(node, ast.Name):
            if node.id in self.from_imports:
                return self.from_imports[node.id]
            if node.id in self.import_aliases:
                return None  # a bare module is not a callable target
            return (self.module_dotted, node.id)
        if isinstance(node, ast.Attribute):
            base = self.dotted(node.value)
            if base is not None:
                return (base, node.attr)
        return None


def module_dotted(rel: str) -> str:
    p = rel[:-3] if rel.endswith(".py") else rel
    p = p.replace("/", ".")
    return p[: -len(".__init__")] if p.endswith(".__init__") else p


class Project:
    """All modules and the project-wide round-reachability fixpoint."""

    def __init__(self, modules: list[ModuleInfo], entries=ROUND_ENTRIES):
        self.modules = modules
        self.entries = tuple(entries)
        # (module_dotted, top-level function name) -> (ModuleInfo, FuncInfo)
        self.symbols: dict[tuple[str, str], tuple[ModuleInfo, FuncInfo]] = {}
        for m in modules:
            for fi in m.functions:
                if "." not in fi.qualname:
                    self.symbols[(m.module_dotted, fi.qualname)] = (m, fi)
        self._reachable: set[int] | None = None

    def unresolved_entries(self) -> list[tuple[str, str]]:
        """Round entries naming no function of the project."""
        return [e for e in self.entries if e not in self.symbols]

    def round_reachable(self) -> set:
        """ids of the FuncInfo objects a round entry reaches."""
        if self._reachable is not None:
            return self._reachable
        children: dict[int, list[FuncInfo]] = {}
        for m in self.modules:
            for fi in m.functions:
                if fi.parent is not None:
                    children.setdefault(id(fi.parent), []).append(fi)
        reachable: set[int] = set()
        work = [self.symbols[e][1] for e in self.entries if e in self.symbols]
        while work:
            fi = work.pop()
            if id(fi) in reachable:
                continue
            reachable.add(id(fi))
            work.extend(children.get(id(fi), ()))
            for target in fi.calls | fi.fn_args:
                hit = self.symbols.get(target)
                if hit is not None:
                    work.append(hit[1])
        self._reachable = reachable
        return reachable


def walk_own(fn: ast.AST):
    """A function's own body, not descending into nested defs (each is a
    FuncInfo of its own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def enclosing(module: ModuleInfo, node: ast.AST) -> str:
    """Qualname of the innermost function holding ``node`` ("" at module level)."""
    best, span = "", None
    for fi in module.functions:
        lo, hi = fi.node.lineno, getattr(fi.node, "end_lineno", fi.node.lineno)
        if lo <= node.lineno <= hi and (span is None or hi - lo < span):
            best, span = fi.qualname, hi - lo
    return best
