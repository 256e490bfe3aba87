"""state-in-place: a round writes no plane of its input state in place.

The port's rounds are functional: ``gossip_round`` returns a new state and
leaves its input's planes as they were. Fleet lanes, serving's bit-for-bit
replays, checkpoints taken mid-run and ``core.state.clone_state`` all rest
on that; in torch it is what buffer donation protects in JAX. In
round-reachable code (``walker.Project.round_reachable``) this rule flags
writes through a parameter named ``state`` or annotated ``SwarmState`` or
``PackedSwarm``, or through a local bound straight to one of its planes
(``seen = state.seen``):

- ``state.x[...] = ...`` and augmented assignments to a plane;
- ``state.x.copy_()``, ``.index_put_()``, ``.scatter_()``, ``.add_()``,
  ``.fill_()`` and the other in-place tensor methods.
"""

from __future__ import annotations

import ast

from tpu_gossip_torch.analysis.registry import Finding, rule
from tpu_gossip_torch.analysis.walker import ModuleInfo, Project, walk_own

__all__ = ["check_state_in_place", "INPLACE_METHODS"]

INPLACE_METHODS = frozenset({
    "copy_", "index_put_", "scatter_", "scatter_add_", "scatter_reduce_", "add_", "sub_", "mul_", "fill_",
    "zero_", "masked_fill_", "masked_scatter_", "index_add_", "index_fill_", "index_copy_", "bitwise_or_",
    "bitwise_and_", "bitwise_xor_", "logical_or_", "logical_and_", "clamp_", "put_",
})
_STATE_TYPES = {"SwarmState", "PackedSwarm"}


def _state_params(fn: ast.AST) -> set[str]:
    a = fn.args
    out = set()
    for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
        ann = {n.id for n in ast.walk(p.annotation) if isinstance(n, ast.Name)} if p.annotation else set()
        if p.arg == "state" or ann & _STATE_TYPES:
            out.add(p.arg)
    return out


def _plane_of(node: ast.AST, states: set[str], aliases: dict[str, str]) -> str | None:
    """The ``state.plane`` a write target or method base names, or None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) and node.value.id in states:
        return f"{node.value.id}.{node.attr}"
    if isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    return None


def _check_function(module: ModuleInfo, fi):
    states = _state_params(fi.node)
    if not states:
        return
    aliases: dict[str, str] = {}
    for node in walk_own(fi.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            v = node.value
            if isinstance(v, ast.Attribute) and isinstance(v.value, ast.Name) and v.value.id in states:
                aliases[node.targets[0].id] = f"{v.value.id}.{v.attr}"
    for node in walk_own(fi.node):
        where = what = None
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                subscripted = isinstance(t, ast.Subscript)
                if subscripted or isinstance(node, ast.AugAssign):
                    plane = _plane_of(t, states, aliases)
                    if plane is not None and (subscripted or isinstance(t, ast.Attribute) or t.id in aliases):
                        where, what = node, f"{plane} written in place ({'item assignment' if subscripted else 'augmented assignment'})"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and \
                node.func.attr in INPLACE_METHODS:
            plane = _plane_of(node.func.value, states, aliases)
            if plane is not None:
                where, what = node, f"{plane}.{node.func.attr}() writes the input state's plane in place"
        if where is not None:
            yield Finding(file=module.rel, line=where.lineno, col=where.col_offset + 1, rule="state-in-place",
                          message=f"{what} inside round-reachable {fi.qualname}",
                          hint="build the new plane out of place (torch.where, .clone() then write, "
                          "index_put without the underscore) and return it in the new state",
                          qualname=fi.qualname)


@rule("state-in-place")
def check_state_in_place(module: ModuleInfo):
    from tpu_gossip_torch.analysis import rules_purity

    project = rules_purity._PROJECT if rules_purity._PROJECT is not None else Project([module])
    reach = project.round_reachable()
    for fi in module.functions:
        if id(fi) in reach:
            yield from _check_function(module, fi)
