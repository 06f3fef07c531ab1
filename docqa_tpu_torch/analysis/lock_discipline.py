"""lock-discipline: consistent acquisition order, no blocking call held.

Counterpart of ``docqa_tpu/analysis/lock_discipline.py``.  The port's
serving process holds a few dozen ``threading.Lock``/``Condition``
instances (the batcher's cv, the pool's lock and cv, the spine's cv, the
broker's cv, the store's RLock, the tier's rebuild and build locks, the
command stream's slot, the registry, pipeline, metrics, recorder and
kernel-build locks).  Two classes of bug regress silently:

* **inconsistent ordering** — thread 1 acquires A then B, thread 2
  acquires B then A: a deadlock that only fires under load.  The checker
  discovers lock attributes (``self.X = threading.Lock()/RLock()/
  Condition()``, plus module-level ones), builds the acquisition graph
  (edges from every held lock to each lock acquired under it, through the
  TRANSITIVE closure of package-resolvable calls), and flags every cycle
  via full DFS.  The dynamic witness in ``analysis/race_witness.py``
  cross-checks its *witnessed* edges against exactly this graph, so the
  two views use one edge and one cycle definition.  ``Condition(
  self._lock)`` aliases canonicalize to the underlying lock.  Lock
  identity is ``Class.attr`` for ``self`` attributes and the receiver
  text otherwise — two *instances* of one class's lock are one node.
* **blocking while holding a lock** — broker publishes, journal fsyncs,
  registry writes, checkpoint loads, thread joins, sleeps, decode waits,
  and (the port's addition, from the profile) every wait for a CUDA
  stream — ``torch.cuda.synchronize``, ``Event.synchronize``, the device
  fetches ``.item()`` / ``.tolist()`` / ``.cpu()`` — performed inside a
  critical section stall every other thread contending for that lock
  behind the card.  Blocking-ness propagates through package-resolvable
  calls.  ``cv.wait(…)`` on the *held* condition is the one legitimate
  blocking-under-lock (it releases), and is exempt.

Both sub-rules are per-site findings; deliberate exceptions (the kernel
build under ``_kernels._LOCK``, which serialises builds on purpose)
belong in the baseline with a justification.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    stmt_walk as _stmt_walk,
)
from docqa_tpu_torch.analysis.concurrency import (
    LOCKISH_ATTR_RE,
    _memoized,
    canonical,
    resolve_target,
    discover_lock_attr_names,
    discover_locks,
    find_cycles,
    known_lock_attrs,
    lock_aliases,
)

# ``.join`` is blocking only on thread-like receivers — ``str.join`` /
# ``os.path.join`` share the attribute name.
THREADISH_RE = re.compile(r"worker|thread|proc|consumer", re.IGNORECASE)


def _is_blocking_call(
    module, node: ast.Call, blocking_attrs: FrozenSet[str]
) -> Optional[str]:
    """Blocking description for this call, or None (``blocking_attrs``:
    the profile's ``lock_blocking_attrs``)."""
    name = call_name(node)
    if not name:
        return None
    attr = name.rsplit(".", 1)[-1]
    receiver = name.rsplit(".", 1)[0] if "." in name else ""
    resolved = module.resolve_alias(name)
    if attr in blocking_attrs:
        return name
    if resolved == "time.sleep" or resolved == "os.fsync":
        return resolved
    if attr == "join" and (
        THREADISH_RE.search(receiver)
        or any(kw.arg == "timeout" for kw in node.keywords)
    ):
        return name
    return None


def _stmt_calls(package: Package, fn: FunctionInfo) -> List[ast.Call]:
    """The calls of ``fn``'s own body (nested defs excluded), walked once
    per package."""
    table = _memoized(package, "stmt_calls", dict)
    out = table.get(id(fn.node))
    if out is None:
        out = [n for n in _stmt_walk(fn.node) if isinstance(n, ast.Call)]
        table[id(fn.node)] = out
    return out


class LockDisciplineChecker:
    rule = "lock-discipline"

    # -- lock discovery -------------------------------------------------------

    def _discover_locks(self, package: Package) -> Set[str]:
        """Attribute/variable names assigned a threading primitive —
        delegated to the shared concurrency model (one regex, one
        implementation) so this classification can never drift from the
        witness id-map."""
        return discover_lock_attr_names(package)

    def _lock_id(
        self, fn: FunctionInfo, expr_text: str
    ) -> str:
        """Stable identity: Class.attr for self attrs, receiver text else."""
        attr = expr_text.rsplit(".", 1)[-1]
        if expr_text.startswith("self.") and fn.class_name:
            return f"{fn.class_name}.{attr}"
        return expr_text

    def _is_lock_expr(self, text: str, known: Set[str]) -> bool:
        if not text:
            return False
        attr = text.rsplit(".", 1)[-1]
        return attr in known or bool(LOCKISH_ATTR_RE.search(attr))

    # -- blocking propagation -------------------------------------------------

    def _direct_blocking(
        self, fn: FunctionInfo, blocking_attrs: FrozenSet[str]
    ) -> List[Tuple[ast.Call, str]]:
        out = []
        for node in _stmt_walk(fn.node):
            if isinstance(node, ast.Call):
                desc = _is_blocking_call(fn.module, node, blocking_attrs)
                if desc is not None:
                    out.append((node, desc))
        return out

    def _blocking_closure(
        self, package: Package
    ) -> Dict[int, Set[str]]:
        """fn-node-id -> set of blocking descriptions reachable from it."""
        blocking: Dict[int, Set[str]] = {}
        attrs = package.profile.lock_blocking_attrs
        for fn in package.functions:
            direct = {
                name for _node, name in self._direct_blocking(fn, attrs)
            }
            if direct:
                blocking[id(fn.node)] = direct
        # each function's resolvable calls, found once: (callee, tag)
        calls = []
        for fn in package.functions:
            resolved = []
            for node in _stmt_calls(package, fn):
                callee = package.resolve_call(fn, node)
                if callee is not None:
                    # propagate the callee NAME only (bounded strings)
                    resolved.append((id(callee.node), f"{call_name(node)}()"))
            if resolved:
                calls.append((id(fn.node), resolved))
        changed = True
        while changed:
            changed = False
            for fn_id, resolved in calls:
                for callee_id, tag in resolved:
                    if not blocking.get(callee_id):
                        continue
                    cur = blocking.setdefault(fn_id, set())
                    if tag not in cur:
                        cur.add(tag)
                        changed = True
        return blocking

    # -- transitive acquisition closure ---------------------------------------

    # Generic method names whose unresolved calls UNION into the lock
    # closure anyway.  Curated by the dynamic witness: each entry is a
    # name the cross-check caught acquiring a lock the static graph
    # didn't know about (store.add under the pipeline suppress lock,
    # gauge.set from the breaker board, histogram/digest observe under
    # everything).  Do NOT widen casually — a name like ``get`` or
    # ``close`` unions wildly unrelated classes and manufactures phantom
    # cycles; grow this set exactly when the witness gate reports a new
    # missing edge through a generic name.
    UNION_FALLBACK_ATTRS = frozenset({"add", "set", "observe"})

    def _lock_callees(
        self, package: Package, fn: FunctionInfo, node: ast.Call
    ) -> List[FunctionInfo]:
        """The call's callees (:meth:`_resolved_callees`) and, for a
        profile invoker, the function it runs (:meth:`_invoked`)."""
        return self._resolved_callees(package, fn, node) + self._invoked(
            package, fn, node
        )

    def _resolved_callees(
        self, package: Package, fn: FunctionInfo, node: ast.Call
    ) -> List[FunctionInfo]:
        """Callees for LOCK-CLOSURE purposes.  Exact resolution first;
        when it abstains: a class construction reaches its ``__init__``,
        and a call to one of the witness-curated generic names unions
        every same-named package METHOD.  For an acquisition CLOSURE,
        over-approximating which locks a call may take is the
        conservative direction — it can only add edges the cycle scan
        must then prove consistent."""
        exact = package.resolve_call(fn, node)
        if exact is not None:
            return [exact]
        name = call_name(node)
        if not name:
            return []
        attr = name.rsplit(".", 1)[-1]
        # ClassName(...) -> ClassName.__init__
        if "." not in name and name[:1].isupper():
            cands = [
                f
                for f in package.by_bare_name.get("__init__", ())
                if f.class_name == name
            ]
            if len(cands) == 1:
                return cands
        # a declared module singleton (the profile's receiver_classes):
        # `DEFAULT_OBSERVATORY.record(...)` is Observatory.record
        if "." in name:
            cls = dict(package.profile.receiver_classes).get(
                name.rsplit(".", 2)[-2]
            )
            if cls is not None:
                owned = [
                    f
                    for f in package.by_bare_name.get(attr, ())
                    if f.class_name == cls
                ]
                if owned:
                    return owned
        # receiver-name hint: `self.registry.get(...)` resolves to a
        # method of a class whose NAME matches the receiver (Document-
        # Registry), even for generic attrs.  The witness caught
        # `wait_indexed` holding _done_cv into DocumentRegistry.get this
        # way.  ≥4 chars so `d.get`/`r.state` can't match everything.
        if "." in name:
            recv_tail = name.rsplit(".", 2)[-2].lstrip("_").lower()
            if len(recv_tail) >= 4:
                hinted = [
                    f
                    for f in package.by_bare_name.get(attr, ())
                    if f.class_name is not None
                    and recv_tail in f.class_name.lower()
                ]
                if 0 < len(hinted) <= 4:
                    return hinted
        if attr in self.UNION_FALLBACK_ATTRS:
            # bare names included: `registry.gauge(...).set(...)` chains
            # collapse to a bare `set` (the receiver is a Call), and the
            # witness caught exactly that edge.  Phantom matches (a
            # builtin `set()` constructor) only add edges INTO leaf
            # metric locks, which have no out-edges to cycle through.
            head = name.split(".")[0]
            origin = fn.module.imports.get(head) if "." in name else None
            if origin is not None and origin.split(".")[0] != (
                fn.module.name.split(".")[0]
            ):
                return []  # external-module receiver never enters the pkg
            methods = [
                f
                for f in package.by_bare_name.get(attr, ())
                if f.class_name is not None
            ]
            if 0 < len(methods) <= 6:
                return methods
        return []

    @staticmethod
    def _invoked(
        package: Package, fn: FunctionInfo, node: ast.Call
    ) -> List[FunctionInfo]:
        """The function a profile invoker (``mirrored(obj, name, fn)``)
        runs: its callable argument, resolved as a call from here."""
        invokers = dict(package.profile.invokers)
        if not invokers:
            return []
        name = call_name(node)
        pos = invokers.get(name.rsplit(".", 1)[-1]) if name else None
        if pos is None or len(node.args) <= pos:
            return []
        target = resolve_target(package, fn, node.args[pos])
        return [target] if target is not None else []

    def _locks_closure(
        self, package: Package, known_locks: Set[str]
    ) -> Dict[int, Set[str]]:
        """fn-node-id -> every lock id the function may acquire, through
        the TRANSITIVE closure of package calls (``_lock_callees``).  The
        direct version missed e.g. ``_pop_free_slots -> _finish -> with
        req.cv`` (two frames down) — exactly the edges the dynamic
        witness sees at runtime, so without the closure every witnessed
        deep edge would fail the witness-vs-static cross-check."""
        closure: Dict[int, Set[str]] = {}
        for fn in package.functions:
            direct = self._direct_locks(fn, known_locks)
            if direct:
                closure[id(fn.node)] = set(direct)
        # each function's lock callees, found once
        calls = []
        for fn in package.functions:
            callee_ids = [
                id(callee.node)
                for node in _stmt_calls(package, fn)
                for callee in self._lock_callees(package, fn, node)
            ]
            if callee_ids:
                calls.append((id(fn.node), callee_ids))
        changed = True
        while changed:
            changed = False
            for fn_id, callee_ids in calls:
                for callee_id in callee_ids:
                    sub = closure.get(callee_id)
                    if not sub:
                        continue
                    cur = closure.setdefault(fn_id, set())
                    if not sub <= cur:
                        cur |= sub
                        changed = True
        return closure

    # -- main -----------------------------------------------------------------

    def check(self, package: Package) -> List[Finding]:
        out: List[Finding] = []
        edges = self.build_graph(package, out)
        # full DFS cycle detection over the canonicalized graph (the same
        # scan the dynamic witness runs over its own graph)
        for cycle in find_cycles(edges.keys()):
            path, line, sym = edges[(cycle[0], cycle[1])]
            pretty = " -> ".join(cycle)
            others = "; ".join(
                f"{a} -> {b} in {edges[(a, b)][2]} "
                f"({edges[(a, b)][0]}:{edges[(a, b)][1]})"
                for a, b in zip(cycle[1:], cycle[2:])
            )
            out.append(
                Finding(
                    self.rule,
                    path,
                    line,
                    sym,
                    f"inconsistent lock order: cycle {pretty} "
                    f"({cycle[0]} -> {cycle[1]} here; {others})",
                )
            )
        return out

    def build_graph(
        self, package: Package, out: Optional[List[Finding]] = None
    ) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
        """The static acquisition-order graph: (A, B) -> first example
        site where B was acquired (directly or through calls) while A
        was held.  Edge endpoints are canonicalized through the
        Condition→lock alias map.  ``analysis/race_witness.py`` holds its
        witnessed edges to membership in THIS graph."""
        decls = discover_locks(package)
        aliases = lock_aliases(decls, package)
        known_locks = self._discover_locks(package) | known_lock_attrs(decls)
        blocking = self._blocking_closure(package)
        closure = self._locks_closure(package, known_locks)
        findings: List[Finding] = out if out is not None else []
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

        for fn in package.functions:
            self._check_fn(
                package, fn, known_locks, blocking, closure, aliases,
                edges, findings,
            )
        return edges

    def _check_fn(
        self,
        package: Package,
        fn: FunctionInfo,
        known_locks: Set[str],
        blocking: Dict[int, Set[str]],
        closure: Dict[int, Set[str]],
        aliases: Dict[str, str],
        edges: Dict,
        out: List[Finding],
    ) -> None:
        module = fn.module

        def add_edge(held_id: str, lock: str, line: int) -> None:
            a = canonical(held_id, aliases)
            b = canonical(lock, aliases)
            if a != b:
                edges.setdefault(
                    (a, b), (module.relpath, line, fn.qualname)
                )

        def visit(node: ast.AST, held: List[Tuple[str, str]]) -> None:
            # held: list of (lock_id, receiver_text)
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    acquired: List[Tuple[str, str]] = []
                    for item in child.items:
                        try:
                            text = ast.unparse(item.context_expr)
                        except Exception:
                            text = ""
                        if isinstance(item.context_expr, ast.Call):
                            continue  # with span(...), with open(...) ...
                        if self._is_lock_expr(text, known_locks):
                            lock = self._lock_id(fn, text)
                            # edges from every already-held lock AND from
                            # earlier items of this same with-statement
                            # (`with a, b:` acquires a then b — the
                            # canonical deadlock pair against
                            # `with b: with a:` elsewhere)
                            for h, _r in held + acquired:
                                add_edge(h, lock, child.lineno)
                            acquired.append((lock, text))
                    visit(child, held + acquired)
                    continue
                if isinstance(child, ast.Call) and held:
                    name = call_name(child)
                    attr = name.rsplit(".", 1)[-1] if name else ""
                    receiver = name.rsplit(".", 1)[0] if "." in name else ""
                    held_receivers = {r for _h, r in held}
                    if attr in ("wait", "notify", "notify_all") and (
                        receiver in held_receivers
                    ):
                        pass  # cv ops on the held lock are the pattern
                    elif _is_blocking_call(
                        module, child, package.profile.lock_blocking_attrs
                    ) is not None:
                        out.append(
                            Finding(
                                self.rule,
                                module.relpath,
                                child.lineno,
                                fn.qualname,
                                f"blocking call {name}() while holding "
                                f"{held[-1][0]}",
                            )
                        )
                    else:
                        callee = package.resolve_call(fn, child)
                        if callee is not None:
                            sub = blocking.get(id(callee.node))
                            if sub:
                                out.append(
                                    Finding(
                                        self.rule,
                                        module.relpath,
                                        child.lineno,
                                        fn.qualname,
                                        f"call {name}() blocks (via "
                                        f"{sorted(sub)[0]}) while holding "
                                        f"{held[-1][0]}",
                                    )
                                )
                        # cross-call lock-order edges, through the
                        # TRANSITIVE acquisition closures of everything
                        # the call may reach (over-approximating callees
                        # — see _lock_callees)
                        for cand in self._lock_callees(
                            package, fn, child
                        ):
                            for lock in closure.get(id(cand.node), ()):
                                for h, _r in held:
                                    add_edge(h, lock, child.lineno)
                visit(child, held)

        visit(fn.node, [])

    def _direct_locks(
        self, fn: FunctionInfo, known_locks: Set[str]
    ) -> Set[str]:
        out: Set[str] = set()
        for node in _stmt_walk(fn.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call):
                        continue
                    try:
                        text = ast.unparse(item.context_expr)
                    except Exception:
                        continue
                    if self._is_lock_expr(text, known_locks):
                        out.add(self._lock_id(fn, text))
        return out


def build_acquisition_graph(package: Package):
    """Module-level convenience for the dynamic witness and tests: the
    canonicalized static acquisition-order graph, without findings."""
    return LockDisciplineChecker().build_graph(package)
