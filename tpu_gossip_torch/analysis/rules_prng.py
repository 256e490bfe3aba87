"""key-linearity and global-torch-rng: every draw comes from an explicit
threefry key, and each key is consumed at most once.

The port's runs equal the JAX package's bit for bit because every draw is
``core/prng.py``'s threefry over a key the round threads: derive with
``split`` or ``fold_in``, consume once with ``bits``, ``uniform``,
``randint``, ``gumbel`` or ``poisson``. A key consumed twice correlates
draws the protocol treats as independent, and both packages would inherit
the same correlated stream, so no digest comparison can catch it.

``key-linearity`` is a small per-function abstract interpreter over
statement order:

- Key variables: parameters named like keys (``key``, ``k_*``, ``key_*``,
  ``*_key``; not ``rng``, which names numpy Generators and the state's
  plane) and variables assigned from ``prng.split``/``key``/``fold_in``.
- Consumption: a key handed to a sampler or to ``split``, or to any other
  callable (the callee owns it then). ``fold_in`` derives without
  consuming (``fold_in(key, i)`` over varying ``i`` is the sanctioned
  pattern); ``key`` and ``key_data`` do not consume.
- Reassignment refreshes: ``key, sub = prng.split(key)`` consumes the old
  key and binds fresh ones.
- Branches merge the consumptions of the arms that fall through; loops run
  their body twice, so a key consumed across iterations is caught.
- Subscripted keys (``keys[i]``) and attributes (``state.rng``) are not
  tracked.

A root key minted inline inside a sampler call (``prng.bits(prng.key(0),
...)``) is flagged too: library code threads keys.

``global-torch-rng``: library code never draws from a global generator:
no ``torch.manual_seed``, no ``torch.rand*``/``randint``/``randperm``/
``bernoulli``/``multinomial``/``normal``/``poisson`` without
``generator=``, and no module-level ``numpy.random`` or stdlib ``random``
function (their global state); a seeded ``numpy.random.default_rng``, a
``random.Random`` or a ``torch.Generator`` is explicit and clean.
"""

from __future__ import annotations

import ast
import re

from tpu_gossip_torch.analysis.registry import Finding, rule
from tpu_gossip_torch.analysis.walker import ModuleInfo, enclosing

__all__ = ["check_key_linearity", "check_global_torch_rng"]

PRNG = "tpu_gossip_torch.core.prng."
_KEY_PARAM_RE = re.compile(r"^(key|k_\w+|key_\w+|\w+_key)$")
_NON_CONSUMING = {"key", "key_data", "fold_in"}
_PRODUCERS = {"split", "key", "fold_in"}
_TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)


class _Env:
    """var -> line of its consumption, or None while fresh."""

    def __init__(self, data=None):
        self.data: dict[str, int | None] = dict(data or {})

    def copy(self) -> "_Env":
        return _Env(self.data)

    def merge(self, branches: list["_Env"]) -> None:
        for b in branches:
            for var, site in b.data.items():
                if (site is not None or var not in self.data) and self.data.get(var) is None:
                    self.data[var] = site


def _prng_fn(module: ModuleInfo, call: ast.Call) -> str | None:
    dotted = module.dotted(call.func) or ""
    return dotted[len(PRNG):] if dotted.startswith(PRNG) else None


class _FnChecker:
    def __init__(self, module: ModuleInfo, fn: ast.AST):
        self.module = module
        self.fn = fn
        self.findings: list[Finding] = []
        self._reported: set[tuple[int, str]] = set()

    def run(self) -> list[Finding]:
        env = _Env()
        a = self.fn.args
        for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            if _KEY_PARAM_RE.match(p.arg):
                env.data[p.arg] = None
        self._block(self.fn.body, env)
        return self.findings

    def _finding(self, node: ast.AST, message: str, hint: str) -> Finding:
        return Finding(file=self.module.rel, line=node.lineno, col=node.col_offset + 1, rule="key-linearity",
                       message=message, hint=hint, qualname=self.fn.name)

    def _reuse(self, name: str, node: ast.AST, first_line: int) -> None:
        if (node.lineno, name) in self._reported:
            return
        self._reported.add((node.lineno, name))
        self.findings.append(self._finding(
            node, f"PRNG key {name!r} consumed again (first consumed at line {first_line}) in {self.fn.name}",
            "derive a fresh key with prng.split/fold_in before each consumer; reuse correlates draws the "
            "protocol treats as independent"))

    def _consume_in_expr(self, expr: ast.AST, env: _Env) -> None:
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            fn = _prng_fn(self.module, node)
            argv = list(node.args) + [kw.value for kw in node.keywords]
            if fn is not None and fn in _NON_CONSUMING:
                continue
            for a in argv:
                self._consume_name(a, env, node)
            if fn is not None:
                for a in argv:
                    if isinstance(a, ast.Call) and _prng_fn(self.module, a) == "key":
                        self.findings.append(self._finding(
                            a, f"root key minted inline inside prng.{fn} in {self.fn.name}",
                            "thread a split of the caller's key instead of a constant stream"))

    def _consume_name(self, a: ast.AST, env: _Env, site: ast.AST) -> None:
        if isinstance(a, ast.Name) and a.id in env.data:
            prior = env.data[a.id]
            if prior is not None:
                self._reuse(a.id, site, prior)
            else:
                env.data[a.id] = site.lineno

    def _block(self, stmts, env: _Env) -> bool:
        """Interpret a statement list; True when it always terminates."""
        for stmt in stmts:
            if isinstance(stmt, _TERMINATORS):
                for child in ast.iter_child_nodes(stmt):
                    self._consume_in_expr(child, env)
                return True
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._consume_captured(stmt, env)
                continue
            if isinstance(stmt, ast.ClassDef):
                continue
            if isinstance(stmt, ast.If):
                self._consume_in_expr(stmt.test, env)
                arms, n_arms, n_term = [], 0, 0
                for body in (stmt.body, stmt.orelse):
                    if not body:
                        continue
                    n_arms += 1
                    arm = env.copy()
                    if self._block(body, arm):
                        n_term += 1
                    else:
                        arms.append(arm)
                env.merge(arms)
                if stmt.orelse and n_term == n_arms:
                    return True
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._consume_in_expr(stmt.test if isinstance(stmt, ast.While) else stmt.iter, env)
                self._block(stmt.body, env)
                self._block(stmt.body, env)
                self._block(stmt.orelse, env)
                continue
            if isinstance(stmt, ast.Try):
                arms = []
                for body in [stmt.body] + [h.body for h in stmt.handlers] + [stmt.orelse, stmt.finalbody]:
                    if body:
                        arm = env.copy()
                        self._block(body, arm)
                        arms.append(arm)
                env.merge(arms)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._consume_in_expr(item.context_expr, env)
                if self._block(stmt.body, env):
                    return True
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = stmt.value
                if value is not None:
                    self._consume_in_expr(value, env)
                targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                produces = isinstance(value, ast.Call) and _prng_fn(self.module, value) in _PRODUCERS
                for tgt in targets:
                    for name in _target_names(tgt):
                        if produces or name in env.data:
                            env.data[name] = None
                continue
            for child in ast.iter_child_nodes(stmt):
                self._consume_in_expr(child, env)
        return False

    def _consume_captured(self, nested: ast.AST, env: _Env) -> None:
        """Outer keys a nested def consumes (free names handed to a call)
        count against the outer budget."""
        a = nested.args
        bound = {p.arg for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)}
        bound |= {p.arg for p in (a.vararg, a.kwarg) if p is not None}
        bound |= {sub.id for sub in ast.walk(nested) if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store)}
        for sub in ast.walk(nested):
            if not isinstance(sub, ast.Call) or _prng_fn(self.module, sub) in _NON_CONSUMING:
                continue
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(arg, ast.Name) and arg.id not in bound and arg.id in env.data:
                    self._consume_name(arg, env, sub)


def _target_names(tgt: ast.AST):
    if isinstance(tgt, ast.Name):
        yield tgt.id
    elif isinstance(tgt, (ast.Tuple, ast.List)):
        for el in tgt.elts:
            yield from _target_names(el)
    elif isinstance(tgt, ast.Starred):
        yield from _target_names(tgt.value)


@rule("key-linearity")
def check_key_linearity(module: ModuleInfo):
    for fi in module.functions:
        yield from _FnChecker(module, fi.node).run()


# torch draws that take a generator= and otherwise read the global one
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint", "randint_like", "randperm", "bernoulli",
                "multinomial", "normal", "poisson"}
_TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                "torch.random.manual_seed"}
# explicit generators and their seeds: clean
_NUMPY_EXPLICIT = {"default_rng", "Generator", "RandomState", "SeedSequence", "PCG64", "Philox", "MT19937",
                   "SFC64", "BitGenerator"}
_STDLIB_EXPLICIT = {"Random", "SystemRandom"}


@rule("global-torch-rng")
def check_global_torch_rng(module: ModuleInfo):
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = module.dotted(node.func) or ""
        why = None
        if dotted in _TORCH_SEEDS:
            why = f"{dotted}(...) reseeds the global torch generator"
        elif dotted.startswith("torch.") and dotted[len("torch."):] in _TORCH_DRAWS and not any(
                kw.arg == "generator" for kw in node.keywords):
            why = f"{dotted}(...) without generator= draws from the global torch generator"
        elif dotted.startswith("numpy.random.") and dotted.count(".") == 2 and \
                dotted.rsplit(".", 1)[1] not in _NUMPY_EXPLICIT:
            why = f"{dotted}(...) draws from numpy's global RandomState"
        elif dotted.startswith("random.") and dotted.count(".") == 1 and \
                dotted.split(".")[1] not in _STDLIB_EXPLICIT and module.import_aliases.get("random") == "random":
            why = f"{dotted}(...) draws from the stdlib's global Random"
        if why is not None:
            yield Finding(file=module.rel, line=node.lineno, col=node.col_offset + 1, rule="global-torch-rng",
                          message=why, hint="draw from core/prng.py's threefry on a threaded key, or from an "
                          "explicitly seeded generator (torch.Generator, numpy.random.default_rng)",
                          qualname=enclosing(module, node))

