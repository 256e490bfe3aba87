"""The wire census: what the dense mesh entries ship, against their model.

The port's wire model is each engine's ``dense_wire_words``
(``dist/mesh.py`` and ``dist/matching_mesh.py``), whose formulas the
analytic ``IciRound`` counters (``dist/transport.py::ici_round_*``) share.
The wire itself is ``dist/mesh.py::all_to_all``. :func:`census` wraps it
for one round of an entry and counts the words it ships: each of the S
shards ships its block of the payload, ``ceil(block bytes / 4)`` words,
as the JAX tier counts a traced ``all_to_all`` operand. On the dense
entries the total must equal ``dense_wire_words`` and the round's
``IciRound.dense_words``; any skew is ``mem-wire-drift``, reported at the
declaration's ``def`` line, where a known deviation keeps a pragma with
its reason.
"""

from __future__ import annotations

import contextlib

from tpu_gossip_torch.analysis.mem.widths import _module_pragmas
from tpu_gossip_torch.analysis.registry import Finding, pragma_suppresses

__all__ = ["WIRE_ENTRIES", "census", "wire_words", "declared_words", "drift_finding", "wire_findings"]

WIRE_RULE = "mem-wire-drift"
# the dense mesh entries (push_pull, 16 slots, forward_once off) and their
# engine family; the (hosts, devices) fold ships the flat mesh's wire
WIRE_ENTRIES = {
    "dist[bucketed]": "bucketed",
    "dist[matching]": "matching",
    "dist[bucketed,2d]": "bucketed",
    "dist[matching,2d]": "matching",
}


def wire_words(payload, n_shards: int) -> int:
    """Global words of one exchange: S blocks of the per-shard payload."""
    block = payload.numel() * payload.element_size() // payload.shape[0]
    return n_shards * -(-block // 4)


@contextlib.contextmanager
def census(n_shards: int):
    """Count the words every ``dist.mesh.all_to_all`` call ships inside the
    block; yields a dict with ``words`` and ``calls``."""
    from tpu_gossip_torch.dist import mesh as mesh_mod

    counts = {"words": 0, "calls": 0}
    real = mesh_mod.all_to_all

    def counted(payload):
        counts["words"] += wire_words(payload, n_shards)
        counts["calls"] += 1
        return real(payload)

    mesh_mod.all_to_all = counted
    try:
        yield counts
    finally:
        mesh_mod.all_to_all = real


_DECLARING = {"bucketed": "tpu_gossip_torch/dist/mesh.py", "matching": "tpu_gossip_torch/dist/matching_mesh.py"}


def _module(family: str):
    if family == "bucketed":
        from tpu_gossip_torch.dist import mesh as mod
    else:
        from tpu_gossip_torch.dist import matching_mesh as mod
    return mod


def declared_words(family: str, target, m: int = 16, mode: str = "push_pull") -> int:
    """The engine's ``dense_wire_words``, resolved through its module at call time."""
    return int(_module(family).dense_wire_words(target, m, mode, forward_once=False))


def _anchor(family: str) -> tuple[str, int]:
    """(repo-relative file, line) of the declaration's ``def``: a drift is
    reported there, and a line pragma there with its reason suppresses it."""
    from tpu_gossip_torch.analysis.cli import repo_root
    from tpu_gossip_torch.analysis.walker import ModuleInfo

    rel = _DECLARING[family]
    m = ModuleInfo(repo_root() / rel, rel)
    return rel, next(fi.node.lineno for fi in m.functions if fi.qualname == "dense_wire_words")


def drift_finding(name: str, family: str, declared: int, shipped: int, counter: int) -> Finding | None:
    """The ``mem-wire-drift`` finding of one census, or None when the words
    agree or a pragma at the declaration names the deviation."""
    file, line = _anchor(family)
    if (shipped == declared and counter == declared) or pragma_suppresses(_module_pragmas(file), line, WIRE_RULE):
        return None
    return Finding(
        file=file, line=line, col=0, rule=WIRE_RULE,
        message=f"dense_wire_words declares {declared} words a round, all_to_all shipped {shipped} and the ICI "
        f"counter says {counter} ({name}): the wire model has drifted from the exchange",
        hint="change dense_wire_words and the transport formula the counters share in the same commit as the "
        "exchange", qualname=name)


def wire_findings(eps, device) -> tuple[list, dict]:
    """(findings, report): one round of each dense entry of ``eps``, with
    the ICI counter collected, under the census; its words against the
    declaration and the counter's dense words."""
    from tpu_gossip_torch.analysis.entrypoints import N_SHARDS, _dist_ctx
    from tpu_gossip_torch.dist import mesh as mesh_mod

    findings: list[Finding] = []
    report: dict = {}
    for ep in eps:
        family = WIRE_ENTRIES.get(ep.name)
        if family is None:
            continue
        dctx = _dist_ctx(str(device))
        matching = family == "matching"
        target = dctx["plan"] if matching else dctx["sg"]
        mesh = dctx["mesh2"] if ep.name.endswith(",2d]") else dctx["mesh"]
        st, cfg = (dctx["m_state"] if matching else dctx["b_state"])()
        with census(N_SHARDS) as counts:
            ici = mesh_mod.gossip_round_dist(st, cfg, target, mesh, None if matching else dctx["shard_plan"],
                                             collect_ici=True)[2]
        declared, counter = declared_words(family, target), int(ici.dense_words)
        report[ep.name] = {"declared_words": declared, "census_words": counts["words"], "calls": counts["calls"],
                           "ici_dense_words": counter}
        found = drift_finding(ep.name, family, declared, counts["words"], counter)
        findings += [] if found is None else [found]
    return findings, report
