"""resource-flow: every acquired resource reaches exactly one release.

Counterpart of ``docqa_tpu/analysis/resource_flow.py``.  The serving
plane's hardest invariants are ledgers — zero leaked KV blocks, pins
released exactly once, every cost record retired — and a load test only
re-proves them under the load it samples.  This checker proves the
*local* half statically: the profile's protocol table names the
acquire/release pairs (on the port ``engines/paged.py``'s
``BlockAllocator.new_table``→``BlockTable.release``, ``obs/costs.py``'s
``RequestCostLedger.open``→``retire``, ``engines/spine.py``'s
``spine_submit``→``result``/``cancel``, ``obs/recorder.py``'s trace
``from_headers``→``finish``/``complete``), and an abstract
interpreter walks every control-flow path of each function — early
returns, raise edges, ``finally``, loop ``break``/``continue`` —
holding each locally-acquired resource to exactly one release.

Ownership is local-or-transferred: a resource variable that ESCAPES
(stored into an attribute/container, returned, passed to a call that
isn't a declared borrow) transfers its obligation to the new owner and
tracking ends — cross-function custody is the dynamic ledger witness's
half (``analysis/ledger_audit.py``), mirroring how race_witness splits
the lock-order proof with lock-discipline.  Release APIs here RAISE on
double-free (``BlockAllocator.release``), so a second release on any
path is a finding, not a no-op.

Exception edges are modeled for RAISE-PRONE statements only: explicit
``raise``, calls whose tail is a known raising primitive (the profile's
``raise_prone_tails``: ``ensure``/``grow``/``share``/``acquire``/
``check``/``perturb``/``result``/``submit*``/``insert``), and calls resolving (via the chassis'
``resolve_call``) to a package function whose own body raises.  A
``try`` routes the raise edge through its handlers (a handler is
assumed to match — selectivity modeling would trade real leak findings
for type inference the chassis deliberately doesn't do), and
``finally`` bodies run on every exit edge.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    Protocol,
    call_name,
)

# resource statuses
_HELD = 0
_RELEASED = 1
_ESCAPED = 2

State = FrozenSet[Tuple[str, int]]


def _edges() -> Dict[str, Set[State]]:
    return {
        "fall": set(), "return": set(), "raise": set(),
        "break": set(), "continue": set(),
    }


def _merge(into: Dict[str, Set[State]], frm: Dict[str, Set[State]],
           skip: Tuple[str, ...] = ()) -> None:
    for k, v in frm.items():
        if k not in skip:
            into[k] |= v


def _set_var(state: State, var: str, status: int) -> State:
    return frozenset(
        {(v, s) for v, s in state if v != var} | {(var, status)}
    )


def _get_var(state: State, var: str) -> Optional[int]:
    for v, s in state:
        if v == var:
            return s
    return None


class _FnAnalysis:
    """Abstract interpretation of one function body."""

    def __init__(
        self, checker: "ResourceFlowChecker", package: Package,
        fn: FunctionInfo,
    ):
        self.checker = checker
        self.package = package
        self.fn = fn
        # var -> (protocol, acquire lineno) for message/anchor purposes
        self.acquired_at: Dict[str, Tuple[Protocol, int]] = {}
        self.findings: List[Finding] = []
        self._reported: Set[Tuple[str, str]] = set()

    # -- findings -------------------------------------------------------------

    def _report(self, kind: str, var: str, line: int, message: str):
        if (kind, var) in self._reported:
            return
        self._reported.add((kind, var))
        self.findings.append(
            Finding(
                "resource-flow",
                self.fn.module.relpath,
                line,
                self.fn.qualname,
                message,
            )
        )

    def _leak(self, states: Set[State], exit_kind: str) -> None:
        for state in states:
            for var, status in state:
                if status != _HELD:
                    continue
                proto, line = self.acquired_at.get(var, (None, 0))
                pname = proto.name if proto else "resource"
                if exit_kind == "raise":
                    self._report(
                        "leak-raise", var, line,
                        f"{pname} held by '{var}' leaks on an exception "
                        "path — release it in a finally/except or escape "
                        "it before the raising call",
                    )
                else:
                    self._report(
                        "leak", var, line,
                        f"{pname} held by '{var}' is not released on "
                        "every path (leaked on a normal exit)",
                    )

    # -- expression scanning --------------------------------------------------

    def _protocol_for_acquire(self, call: ast.Call) -> Optional[Protocol]:
        name = call_name(call)
        if not name:
            return None
        tail = name.rsplit(".", 1)[-1]
        receiver = name[: -(len(tail) + 1)] if "." in name else ""
        for proto in self.package.profile.protocols:
            for hint, attr in proto.acquires:
                if tail != attr:
                    continue
                if hint and hint not in receiver.lower():
                    continue
                return proto
        return None

    def _call_is_raise_prone(self, call: ast.Call) -> bool:
        name = call_name(call)
        tail = name.rsplit(".", 1)[-1] if name else ""
        if tail in self.package.profile.raise_prone_tails:
            return True
        callee = self.package.resolve_call(self.fn, call)
        return callee is not None and self.checker.has_raise(callee)

    def _scan_expr(
        self, node: ast.AST, states: Set[State]
    ) -> Tuple[Set[State], bool]:
        """Apply release/borrow/escape effects of one expression tree in
        source order; returns (new states, may_raise)."""
        may_raise = False
        tracked = set(self.acquired_at)

        def tracked_name(n: ast.AST) -> Optional[str]:
            if isinstance(n, ast.Name) and n.id in tracked:
                return n.id
            return None

        def apply(op: str, var: str, line: int) -> None:
            nonlocal states
            out: Set[State] = set()
            for state in states:
                status = _get_var(state, var)
                if status is None:
                    out.add(state)
                    continue
                if op == "release":
                    if status == _RELEASED:
                        proto, _ = self.acquired_at[var]
                        self._report(
                            "double", var, line,
                            f"{proto.name} held by '{var}' released "
                            "twice on one path (release raises on "
                            "double-free)",
                        )
                    out.add(_set_var(state, var, _RELEASED))
                elif op == "escape":
                    if status == _HELD:
                        out.add(_set_var(state, var, _ESCAPED))
                    else:
                        out.add(state)
                else:  # borrow
                    out.add(state)
            states = out

        def walk(n: ast.AST) -> None:
            nonlocal may_raise
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                # nested scope: a closure capturing the var keeps it
                # alive beyond this frame's reasoning — escape it
                for inner in ast.walk(n):
                    var = tracked_name(inner)
                    if var:
                        apply("escape", var, n.lineno)
                return
            if isinstance(n, ast.Call):
                # receiver-method form: x.release() / x.result() /
                # x.set_session() — classify by the protocol's tables
                func = n.func
                recv_var = None
                if isinstance(func, ast.Attribute):
                    recv_var = tracked_name(func.value)
                if recv_var is not None:
                    proto, _ = self.acquired_at[recv_var]
                    if func.attr in proto.release_methods:
                        apply("release", recv_var, n.lineno)
                    # any other method on the var is a borrow
                else:
                    walk(func)
                name = call_name(n)
                tail = name.rsplit(".", 1)[-1] if name else ""
                for arg in list(n.args) + [kw.value for kw in n.keywords]:
                    var = tracked_name(arg)
                    if var is not None:
                        proto, _ = self.acquired_at[var]
                        if tail in proto.release_funcs:
                            apply("release", var, n.lineno)
                        elif tail in proto.borrow_attrs:
                            apply("borrow", var, n.lineno)
                        else:
                            apply("escape", var, n.lineno)
                    else:
                        walk(arg)
                if self._call_is_raise_prone(n):
                    may_raise = True
                return
            if isinstance(n, ast.Attribute):
                # attribute READ off the var (table.blocks) — neutral
                if tracked_name(n.value) is not None:
                    return
            if isinstance(n, (ast.Compare, ast.BoolOp)):
                # identity/None tests keep tracking alive
                for child in ast.iter_child_nodes(n):
                    if tracked_name(child) is None and not (
                        isinstance(child, (ast.Name, ast.Constant))
                    ):
                        walk(child)
                return
            var = tracked_name(n)
            if var is not None:
                apply("escape", var, getattr(n, "lineno", 0))
                return
            for child in ast.iter_child_nodes(n):
                walk(child)

        walk(node)
        return states, may_raise

    # -- statement execution --------------------------------------------------

    def exec_block(
        self, stmts: List[ast.stmt], in_states: Set[State]
    ) -> Dict[str, Set[State]]:
        out = _edges()
        cur = set(in_states)
        for stmt in stmts:
            if not cur:
                break
            e = self.exec_stmt(stmt, cur)
            _merge(out, e, skip=("fall",))
            cur = e["fall"]
        out["fall"] = cur
        return out

    def exec_stmt(
        self, stmt: ast.stmt, states: Set[State]
    ) -> Dict[str, Set[State]]:
        out = _edges()
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # nested defs: closure capture escapes (handled in _scan)
            states, _ = self._scan_expr(stmt, states)
            out["fall"] = states
            return out
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                states, _ = self._scan_expr(stmt.value, states)
            out["return"] = states
            return out
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                states, _ = self._scan_expr(stmt.exc, states)
            out["raise"] = states
            return out
        if isinstance(stmt, ast.Break):
            out["break"] = states
            return out
        if isinstance(stmt, ast.Continue):
            out["continue"] = states
            return out
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            return self._exec_assign(stmt, states)
        if isinstance(stmt, ast.Expr):
            new_states, may_raise = self._scan_expr(stmt.value, states)
            if may_raise:
                out["raise"] |= new_states
            out["fall"] = new_states
            return out
        if isinstance(stmt, ast.If):
            t, _ = self._scan_expr(stmt.test, states)
            _merge(out, self.exec_block(stmt.body, t))
            _merge(out, self.exec_block(stmt.orelse, t))
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._exec_loop(stmt, states)
        if isinstance(stmt, ast.Try):
            return self._exec_try(stmt, states)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                states, may_raise = self._scan_expr(
                    item.context_expr, states
                )
                if may_raise:
                    out["raise"] |= states
            _merge(out, self.exec_block(stmt.body, states))
            return out
        # generic statement (assert, delete, global, import, pass, …):
        # scan child expressions for effects, no control flow
        may_raise = False
        for child in ast.iter_child_nodes(stmt):
            states, mr = self._scan_expr(child, states)
            may_raise = may_raise or mr
        if may_raise:
            out["raise"] |= states
        out["fall"] = states
        return out

    def _exec_assign(
        self, stmt: ast.stmt, states: Set[State]
    ) -> Dict[str, Set[State]]:
        out = _edges()
        value = getattr(stmt, "value", None)
        targets = (
            stmt.targets
            if isinstance(stmt, ast.Assign)
            else [stmt.target]
        )
        proto = (
            self._protocol_for_acquire(value)
            if isinstance(value, ast.Call)
            else None
        )
        if (
            proto is not None
            and len(targets) == 1
            and isinstance(targets[0], ast.Name)
        ):
            var = targets[0].id
            # the acquire call's ARGUMENTS may still release/escape
            # other tracked vars and may raise (pre-acquire)
            pre, may_raise = self._scan_expr_call_args(value, states)
            if may_raise:
                out["raise"] |= pre
            new: Set[State] = set()
            for state in pre:
                if _get_var(state, var) == _HELD:
                    old_proto, old_line = self.acquired_at[var]
                    self._report(
                        "rebind", var, stmt.lineno,
                        f"'{var}' rebound while still holding an "
                        f"unreleased {old_proto.name} (acquired at "
                        f"line {old_line})",
                    )
                new.add(_set_var(state, var, _HELD))
            self.acquired_at[var] = (proto, stmt.lineno)
            out["fall"] = new
            return out
        if value is not None:
            states, may_raise = self._scan_expr(value, states)
            if may_raise:
                out["raise"] |= states
        # escape through non-Name targets / aliasing
        for t in targets:
            if isinstance(t, ast.Name):
                # plain alias y = x already escaped x in the value scan
                continue
            states, _ = self._scan_expr(t, states)
        out["fall"] = states
        return out

    def _scan_expr_call_args(
        self, call: ast.Call, states: Set[State]
    ) -> Tuple[Set[State], bool]:
        may_raise = self._call_is_raise_prone(call)
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            states, mr = self._scan_expr(arg, states)
            may_raise = may_raise or mr
        return states, may_raise

    def _exec_loop(
        self, stmt, states: Set[State]
    ) -> Dict[str, Set[State]]:
        out = _edges()
        if isinstance(stmt, ast.While):
            states, _ = self._scan_expr(stmt.test, states)
        else:
            states, _ = self._scan_expr(stmt.iter, states)
            states, _ = self._scan_expr(stmt.target, states)
        seen: Set[State] = set(states)
        frontier = set(states)
        falls: Set[State] = set(states)  # zero-iteration exit
        for _ in range(10):
            if not frontier:
                break
            e = self.exec_block(stmt.body, frontier)
            _merge(out, e, skip=("fall", "break", "continue"))
            falls |= e["break"] | e["fall"]
            nxt = (e["fall"] | e["continue"]) - seen
            seen |= nxt
            frontier = nxt
        _merge(out, self.exec_block(stmt.orelse, falls), skip=())
        out["fall"] |= falls
        return out

    def _exec_try(
        self, stmt: ast.Try, states: Set[State]
    ) -> Dict[str, Set[State]]:
        out = _edges()
        body = self.exec_block(stmt.body, states)
        raised = body["raise"]
        pre_final = _edges()
        for k in ("return", "break", "continue"):
            pre_final[k] |= body[k]
        if stmt.handlers:
            for handler in stmt.handlers:
                h = self.exec_block(handler.body, raised)
                _merge(pre_final, h)
        else:
            pre_final["raise"] |= raised
        orelse = self.exec_block(stmt.orelse, body["fall"])
        _merge(pre_final, orelse)
        if not stmt.finalbody:
            return pre_final
        for kind, sts in pre_final.items():
            if not sts:
                continue
            f = self.exec_block(stmt.finalbody, sts)
            out[kind] |= f["fall"]
            _merge(out, f, skip=("fall",))
        return out

    # -- entry ---------------------------------------------------------------

    def run(self) -> List[Finding]:
        body = list(self.fn.node.body)  # type: ignore[attr-defined]
        edges = self.exec_block(body, {frozenset()})
        self._leak(edges["fall"] | edges["return"], "normal")
        self._leak(edges["raise"], "raise")
        return self.findings


class ResourceFlowChecker:
    rule = "resource-flow"

    def __init__(self) -> None:
        self._has_raise: Dict[int, bool] = {}

    def has_raise(self, fn: FunctionInfo) -> bool:
        cached = self._has_raise.get(id(fn))
        if cached is None:
            cached = any(
                isinstance(n, ast.Raise)
                for n in ast.walk(fn.node)
            )
            self._has_raise[id(fn)] = cached
        return cached

    def check(self, package: Package) -> List[Finding]:
        out: List[Finding] = []
        acquire_attrs = {
            attr
            for proto in package.profile.protocols
            for _hint, attr in proto.acquires
        }
        for fn in package.functions:
            if not self._worth_analyzing(fn, acquire_attrs):
                continue
            out.extend(_FnAnalysis(self, package, fn).run())
        return out

    @staticmethod
    def _worth_analyzing(fn: FunctionInfo, acquire_attrs: Set[str]) -> bool:
        """Cheap prescan: only run the interpreter over functions whose
        own body contains an acquire-shaped call."""
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                name = call_name(node)
                tail = name.rsplit(".", 1)[-1] if name else ""
                if tail in acquire_attrs:
                    return True
        return False


def static_sites(package: Package) -> Dict[str, List[Dict]]:
    """Every acquire/release call site per protocol, keyed for the
    dynamic ledger witness: the witness maps runtime events back onto
    exactly these ``path:lineno`` ids and fails on any witnessed site
    the static table doesn't know (witnessed ⊆ static)."""
    protocols = package.profile.protocols
    sites: Dict[str, List[Dict]] = {p.name: [] for p in protocols}
    for fn in package.functions:
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            tail = name.rsplit(".", 1)[-1]
            receiver = (
                name[: -(len(tail) + 1)] if "." in name else ""
            )
            for proto in protocols:
                kinds = []
                for hint, attr in proto.acquires:
                    if tail == attr and (
                        not hint or hint in receiver.lower()
                    ):
                        kinds.append("acquire")
                        break
                if (
                    tail in proto.release_methods
                    or tail in proto.release_funcs
                ):
                    kinds.append("release")
                for kind in kinds:
                    sites[proto.name].append(
                        {
                            "kind": kind,
                            "path": fn.module.path,
                            "relpath": fn.module.relpath,
                            "line": node.lineno,
                            "symbol": fn.qualname,
                        }
                    )
    return sites
