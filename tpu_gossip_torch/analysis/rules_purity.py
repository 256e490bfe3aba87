"""round-host-sync: round-reachable code reads nothing back to the host.

A round of the port is a stream of kernel launches the host only
enqueues. ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` on a
device tensor, and ``bool()``/``int()``/``float()`` of one, block the host
until the card has caught up: one synchronisation a round where it is a
stop condition, many where it sits in a stage. ``time.*`` and stdlib or
numpy ``random.*`` read host state a round must not depend on.
Reachability is the project-wide fixpoint of ``walker.Project`` from its
declared round entries. This is the static twin of ``chip_smoke.py``
phase 15's ``torch.cuda.set_sync_debug_mode`` audit.

Static-cast exemption: ``int()``/``float()``/``bool()`` over a value the
host already holds is no read. An argument mentioning ``.shape``,
``.ndim``, ``.numel()``, ``.size``, ``.dtype``, ``len(...)`` or a literal
stays clean, as do locals bound from such expressions and parameters
annotated as host scalars (``int``, ``float``, ``bool``, ``str``).

A known host read keeps a line pragma naming why it is deliberate.
"""

from __future__ import annotations

import ast

from tpu_gossip_torch.analysis.registry import Finding, rule
from tpu_gossip_torch.analysis.walker import ModuleInfo, Project, walk_own

__all__ = ["check_round_host_sync", "set_project"]

_BAD_PREFIXES = (
    ("time.", "reads the host clock"),
    ("random.", "draws from the stdlib's host RNG"),
    ("numpy.random.", "draws from numpy's host RNG"),
)
_READS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"float", "int", "bool"}
_STATIC_ATTRS = {"shape", "ndim", "numel", "size", "dtype", "itemsize"}
_HOST_TYPES = {"int", "float", "bool", "str", "tuple", "list"}
_CONFIG_NAMES = {"cfg", "config"}  # a SwarmConfig's fields are host values
_STATIC_CALLS = {"len", "int", "float", "bool", "min", "max", "abs", "round", "range"}

# the active project, set by the CLI so the rule sees the global fixpoint
# (rules are per-module callables)
_PROJECT: Project | None = None


def set_project(project: Project | None) -> None:
    global _PROJECT
    _PROJECT = project


def _is_static_expr(node: ast.AST, static_names=frozenset()) -> bool:
    """True when every value the expression reads is one the host holds:
    literals, static names, ``.shape``/``.ndim``/``.dtype``/``.itemsize``
    (and their subscripts), ``.numel()``/``.size()``/``.dim()``, ``len()``,
    a config's fields, and arithmetic, comparisons and builtins of those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in static_names or node.id in _CONFIG_NAMES
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return True
        return _is_static_expr(node.value, static_names)
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value, static_names) and _is_static_expr(node.slice, static_names)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _STATIC_ATTRS | {"dim"}:
            return True
        if isinstance(f, ast.Name) and f.id == "len":
            return True  # a host int, whatever it measures
        if isinstance(f, ast.Name) and f.id in _STATIC_CALLS:
            return all(_is_static_expr(a, static_names) for a in node.args)
        return False
    if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp, ast.Tuple, ast.List,
                         ast.Slice)):
        return all(_is_static_expr(c, static_names) for c in ast.iter_child_nodes(node)
                   if not isinstance(c, (ast.operator, ast.unaryop, ast.boolop, ast.cmpop, ast.expr_context)))
    return False


def _host_annotated(ann: ast.AST | None) -> bool:
    """``int``, ``float | None``, ``Optional[int]``: a host scalar."""
    if ann is None:
        return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {n.value for n in ast.walk(ann) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    return bool(names) and names <= _HOST_TYPES | {"None", "Optional"}


def _static_names(fn: ast.AST) -> set[str]:
    """Host-scalar parameters and the locals bound from static
    expressions only (a fixpoint; a name also bound from anything else is
    dropped)."""
    args = fn.args
    params = list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
    seed = {p.arg for p in params if _host_annotated(p.annotation)}
    banned = {p.arg for p in params} - seed
    assigns = []
    for node in walk_own(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            assigns.append((node.targets[0].id, node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) and node.value is not None:
            assigns.append((node.target.id, node.value))
    for node in walk_own(fn):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            assigns.append((node.target.id, node.iter))
    names = set(seed)
    changed = True
    while changed:
        changed = False
        for name, value in assigns:
            if name not in names and name not in banned and _is_static_expr(value, names):
                names.add(name)
                changed = True
        for name, value in assigns:
            if name in names and name not in seed and not _is_static_expr(value, names):
                names.discard(name)
                banned.add(name)
                changed = True
    return names


def _finding(module: ModuleInfo, node: ast.AST, fname: str, what: str) -> Finding:
    return Finding(file=module.rel, line=node.lineno, col=node.col_offset + 1, rule="round-host-sync",
                   message=f"{what} inside round-reachable {fname}",
                   hint="keep the value on the device, hoist the read to the host-side caller, or give a known "
                   "read a pragma with its reason",
                   qualname=fname)


def _check_function(module: ModuleInfo, fi):
    fn, fname = fi.node, fi.qualname
    static = _static_names(fn)
    for node in walk_own(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) and node.func.attr in _READS and not node.args:
            yield _finding(module, node, fname, f".{node.func.attr}() reads a tensor back to the host")
            continue
        dotted = module.dotted(node.func)
        if dotted is None:
            continue
        for prefix, why in _BAD_PREFIXES:
            if dotted.startswith(prefix) and (prefix != "random." or module.import_aliases.get("random") == "random"):
                yield _finding(module, node, fname, f"{dotted}(...) {why}")
                break
        else:
            if dotted in _HOST_CASTS and node.args and not _is_static_expr(node.args[0], static):
                yield _finding(module, node, fname, f"{dotted}() of a possibly-device value synchronises the host")


@rule("round-host-sync")
def check_round_host_sync(module: ModuleInfo):
    project = _PROJECT if _PROJECT is not None else Project([module])
    reach = project.round_reachable()
    for fi in module.functions:
        if id(fi) in reach:
            yield from _check_function(module, fi)
