"""retire-once: request retirement happens at DECLARED sites, exactly once,
counterpart of ``docqa_tpu/analysis/retire_once.py``.

Every admitted request reaches exactly one terminal retirement: the
``serve._finish`` completion path, a typed shed's cost retirement, the
pool's rescue or shed, or the trace-completion fallback.  The ledger
(``retirement_sites.json``, in the profile's ``ledger_dir``) declares
every function allowed to invoke a retirement primitive, so a new
terminal site is a ledger diff, not an accident.  Three sub-rules:

1. **undeclared site** — a call to a retirement primitive (``_finish``, or
   ``retire(...)`` on a cost-ledger receiver) outside a declared site
   function.  The primitives themselves (``serve._finish``,
   ``RequestCostLedger.retire``) are sites too;
2. **stale site** — a declared site whose function no longer contains a
   retirement call (only when the declaring module is analysed);
3. **error-set-without-finish** — in a module that binds ``_finish``, a
   function that stamps ``<req>.error = ...`` must reach a terminal call
   (the profile's ``retire_terminal_tails``) later in its body, or be
   declared with kind ``error-setter`` (it stamps for a caller who
   finishes).

Two ``_finish`` calls on the same request in one straight-line block are
flagged as well.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    expr_text,
    load_json,
    package_ledger_path,
)

LEDGER_NAME = "retirement_sites.json"


def default_ledger_path() -> str:
    """The port's checked-in ledger:
    ``docqa_tpu_torch/analysis/retirement_sites.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), LEDGER_NAME)


def load_ledger(path: Optional[str]) -> Dict:
    return load_json(path, sites={})


def _is_retire_call(node: ast.Call) -> bool:
    """A retirement-primitive call: ``_finish(req)`` (however imported) or
    ``retire(...)`` on a cost-ledger receiver (``DEFAULT_COST_LEDGER.
    retire``, ``self._ledger.retire``)."""
    name = call_name(node)
    if not name:
        return False
    tail = name.rsplit(".", 1)[-1]
    if tail == "_finish":
        return True
    if tail == "retire":
        receiver = name[: -len(".retire")] if "." in name else ""
        return "ledger" in receiver.lower()
    return False


class RetireOnceChecker:
    rule = "retire-once"

    def __init__(self, ledger_path: Optional[str] = None):
        self._ledger_path = ledger_path

    def check(self, package: Package) -> List[Finding]:
        path = (
            self._ledger_path
            or package_ledger_path(package, LEDGER_NAME)
            or default_ledger_path()
        )
        sites: Dict[str, Dict] = load_ledger(path)["sites"]
        terminal = package.profile.retire_terminal_tails
        out: List[Finding] = []
        retiring: Dict[str, FunctionInfo] = {}
        for fn in package.functions:
            key = f"{fn.module.name}:{fn.qualname}"
            for node in self._own_calls(fn):
                if _is_retire_call(node):
                    retiring.setdefault(key, fn)
                    if key not in sites:
                        out.append(
                            Finding(
                                self.rule,
                                fn.module.relpath,
                                node.lineno,
                                fn.qualname,
                                f"undeclared retirement site {key} — "
                                "terminal request retirement must be "
                                "declared in retirement_sites.json",
                            )
                        )
                    break
        module_names = {m.name for m in package.modules}
        by_name = {m.name: m for m in package.modules}
        for key in sorted(sites):
            mod = key.split(":", 1)[0]
            if mod not in module_names or key in retiring:
                continue
            if sites[key].get("kind") == "error-setter":
                # error-setters stamp <req>.error for a caller to finish;
                # the function must still exist and still stamp
                fn = self._find_fn(package, key)
                if fn is not None and self._error_assigns(fn):
                    continue
            out.append(
                Finding(
                    self.rule,
                    by_name[mod].relpath,
                    1,
                    "<ledger>",
                    f"stale retirement_sites entry: {key} no longer "
                    "contains a retirement call",
                )
            )
        binds = {id(m): self._binds_finish(m) for m in package.modules}
        for fn in package.functions:
            if not binds[id(fn.module)]:
                continue
            out.extend(self._check_error_sets(fn, sites, terminal))
            out.extend(self._check_double(fn))
        return out

    # -- helpers --------------------------------------------------------------

    @staticmethod
    def _own_calls(fn: FunctionInfo):
        stack = list(ast.iter_child_nodes(fn.node))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    @staticmethod
    def _find_fn(package: Package, key: str) -> Optional[FunctionInfo]:
        mod, _, qual = key.partition(":")
        for fn in package.functions:
            if fn.module.name == mod and fn.qualname == qual:
                return fn
        return None

    @staticmethod
    def _binds_finish(module) -> bool:
        """The module takes part in the request lifecycle: it defines or
        imports ``_finish``."""
        if "_finish" in module.imports:
            return True
        for node in ast.walk(module.tree):
            if isinstance(node, ast.FunctionDef) and node.name == "_finish":
                return True
        return False

    @staticmethod
    def _error_assigns(fn: FunctionInfo) -> List[ast.Assign]:
        out = []
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "error"
                    and isinstance(t.value, ast.Name)
                ):
                    out.append(node)
        return out

    def _check_error_sets(
        self, fn: FunctionInfo, sites: Dict[str, Dict], terminal
    ) -> List[Finding]:
        assigns = self._error_assigns(fn)
        if not assigns:
            return []
        key = f"{fn.module.name}:{fn.qualname}"
        if sites.get(key, {}).get("kind") == "error-setter":
            return []
        terminal_lines = [
            node.lineno
            for node in self._own_calls(fn)
            if call_name(node).rsplit(".", 1)[-1] in terminal
        ]
        out: List[Finding] = []
        for a in assigns:
            if any(line >= a.lineno for line in terminal_lines):
                continue
            out.append(
                Finding(
                    self.rule,
                    fn.module.relpath,
                    a.lineno,
                    fn.qualname,
                    "request error stamped but no terminal call "
                    "(_finish/_retire/_fail_active) follows — the waiter "
                    "strands to its timeout and the cost record leaks "
                    "(declare kind=error-setter in retirement_sites.json "
                    "if a caller finishes it)",
                )
            )
        return out

    def _check_double(self, fn: FunctionInfo) -> List[Finding]:
        """Two _finish calls on the SAME request in one straight-line
        statement block: a guaranteed double-retire attempt."""
        out: List[Finding] = []
        for node in ast.walk(fn.node):
            body = getattr(node, "body", None)
            if not isinstance(body, list):
                continue
            seen: Set[str] = set()
            for stmt in body:
                if not (
                    isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                ):
                    continue
                call = stmt.value
                if call_name(call).rsplit(".", 1)[-1] != "_finish":
                    continue
                arg = expr_text(call.args[0]) if call.args else ""
                sig = f"_finish({arg})"
                if sig in seen:
                    out.append(
                        Finding(
                            self.rule,
                            fn.module.relpath,
                            stmt.lineno,
                            fn.qualname,
                            f"{sig} called twice on one straight-line "
                            "path — a request retires exactly once",
                        )
                    )
                seen.add(sig)
        return out
