"""replay-key-integrity: no salted builtin ``hash()`` in keys that must
survive a restart.

Counterpart of ``docqa_tpu/analysis/replay_keys.py``.  CPython salts
``str`` / ``bytes`` hashes per process (``PYTHONHASHSEED``): the same
string hashes to a different value in every interpreter.  A builtin
``hash()`` that flows into a cross-restart key (prefix-cache keys and the
pool's affinity routing, journal records, the shadow sampler, store
fingerprints) breaks every replay and affinity contract while passing
every single-process test.  Sanctioned derivations: ``hashlib``,
``zlib.crc32`` (``resilience/faults.py`` draws its fault decisions that
way) and pure integer arithmetic (ints hash to themselves).

Scope: the profile's ``replay_key_modules`` plus one resolve hop: a
helper called from a scope module owns its ``hash()`` site even if it
lives elsewhere (the finding names the reaching caller).  Fixtures opt in
with the ``docqa-lint: request-path`` pragma.

A ``hash()`` whose argument is provably numeric (an int literal, an
``int()`` / ``len()`` / ``ord()`` result, arithmetic over those) is not
flagged.  Anything else (names, strings, tuples) is.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    stmt_walk,
)

_NUMERIC_CALLS = frozenset({"int", "len", "ord", "round", "abs"})


def _provably_numeric(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, bool))
    if isinstance(node, ast.UnaryOp):
        return _provably_numeric(node.operand)
    if isinstance(node, ast.BinOp):
        return _provably_numeric(node.left) and _provably_numeric(node.right)
    if isinstance(node, ast.Call):
        return call_name(node) in _NUMERIC_CALLS
    return False


class ReplayKeyChecker:
    rule = "replay-key-integrity"

    def check(self, package: Package) -> List[Finding]:
        scope = package.profile.replay_key_modules
        out: List[Finding] = []
        seen_sites: Set[Tuple[str, int]] = set()
        for fn in package.functions:
            if not (fn.module.relname in scope or fn.module.request_path_pragma):
                continue
            self._scan(package, fn, None, out, seen_sites, hop=0)
        for module in package.modules:
            if not (module.relname in scope or module.request_path_pragma):
                continue
            stack = list(ast.iter_child_nodes(module.tree))
            while stack:
                node = stack.pop()
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(node, ast.Call):
                    self._check_hash(module, node, "<module>", None, out, seen_sites)
                stack.extend(ast.iter_child_nodes(node))
        return out

    def _scan(
        self,
        package: Package,
        fn: FunctionInfo,
        origin,
        out: List[Finding],
        seen: Set[Tuple[str, int]],
        hop: int,
    ) -> None:
        scope = package.profile.replay_key_modules
        for node in stmt_walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            self._check_hash(fn.module, node, fn.qualname, origin, out, seen)
            if hop == 0:
                callee = package.resolve_call(fn, node)
                if callee is not None and callee.module.relname not in scope:
                    # one resolve hop: a helper a scope module delegates
                    # key construction to owns its hash() sites
                    self._scan(package, callee, fn, out, seen, hop=1)

    def _check_hash(self, module, node, symbol, origin, out, seen) -> None:
        if call_name(node) != "hash" or "hash" in module.imports:
            return
        if len(node.args) != 1 or node.keywords:
            return
        if _provably_numeric(node.args[0]):
            return
        site = (module.relpath, getattr(node, "lineno", 1))
        if site in seen:
            return
        seen.add(site)
        reached = (
            f" (reached from {origin.module.name}.{origin.qualname})"
            if origin is not None
            else ""
        )
        out.append(
            Finding(
                self.rule,
                module.relpath,
                getattr(node, "lineno", 1),
                symbol,
                "builtin hash() feeding a cross-restart-persistent key"
                f"{reached} — str/bytes hashes are salted per process "
                "(PYTHONHASHSEED), so the key differs every restart; "
                "derive with hashlib/zlib.crc32 or pure-integer "
                "arithmetic",
            )
        )
