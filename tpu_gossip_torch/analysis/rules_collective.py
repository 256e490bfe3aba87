"""raw-collective: ``torch.distributed`` is called from the cluster layer only.

The port's processes meet in two files: ``cluster/launch.py`` starts the
ranks and joins the group, ``cluster/topology.py`` holds every collective
the rounds use (the block exchange, the reductions, the gathers), with
their wire formats and their side-path accounting. A collective called
anywhere else bypasses that accounting and the one-process fallback, and
a rank that skips it hangs the others. The JAX package confines
``shard_map`` to one shim for the same reason. Docstrings and comments are
exempt: this is an AST pass.
"""

from __future__ import annotations

import ast

from tpu_gossip_torch.analysis.registry import Finding, rule
from tpu_gossip_torch.analysis.walker import ModuleInfo, enclosing

__all__ = ["check_raw_collective", "ALLOWED_FILES"]

ALLOWED_FILES = ("tpu_gossip_torch/cluster/topology.py", "tpu_gossip_torch/cluster/launch.py")


def _finding(module: ModuleInfo, node: ast.AST, what: str) -> Finding:
    return Finding(file=module.rel, line=node.lineno, col=node.col_offset + 1, rule="raw-collective",
                   message=f"torch.distributed reached directly ({what}) outside cluster/topology.py and "
                   "cluster/launch.py",
                   hint="route through tpu_gossip_torch.cluster.topology (world, rank, the exchange and "
                   "reductions) or cluster.launch",
                   qualname=enclosing(module, node))


@rule("raw-collective")
def check_raw_collective(module: ModuleInfo):
    if module.rel in ALLOWED_FILES:
        return
    inner: set[int] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ImportFrom) and not node.level:
            mod = node.module or ""
            if mod == "torch.distributed" or mod.startswith("torch.distributed."):
                yield _finding(module, node, f"from {mod} import ...")
            elif mod == "torch" and any(a.name == "distributed" for a in node.names):
                yield _finding(module, node, "from torch import distributed")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" or a.name.startswith("torch.distributed."):
                    yield _finding(module, node, f"import {a.name}")
        elif isinstance(node, ast.Attribute) and id(node) not in inner:
            cur = node.value
            while isinstance(cur, ast.Attribute):
                inner.add(id(cur))
                cur = cur.value
            dotted = module.dotted(node) or ""
            if dotted == "torch.distributed" or dotted.startswith("torch.distributed."):
                yield _finding(module, node, dotted)
