"""cv-protocol: condition variables used the one correct way.

Counterpart of ``docqa_tpu/analysis/cv_protocol.py``.

Three sub-rules over every ``threading.Condition`` (discovered
assignments, dataclass ``field(default_factory=…)`` declarations, and
cv-ish receivers — ``…._cv`` / ``….cv``):

1. **wait-in-a-loop** — ``cv.wait(…)`` must sit inside a ``while`` whose
   predicate is re-checked after every wakeup.  Spurious wakeups and
   stolen predicates are not theoretical: ``notify_all`` wakes every
   waiter and only one gets the queue slot.  An ``if``-guarded or bare
   wait flags; ``wait_for`` carries its own predicate loop and is
   exempt.
2. **notify-under-the-lock** — ``cv.notify()`` / ``notify_all()``
   without holding the cv (or the lock it was constructed over —
   ``Condition(self._lock)`` aliases canonicalize) raises RuntimeError
   at runtime *when it runs*; the paths that notify on error cleanup
   are exactly the ones tests never run.  A helper whose every
   package-resolvable call site holds the cv is analyzed as holding it
   (``serve._pop_free_slots`` — "caller holds ``_cv``").
3. **request-path waits carry a Deadline** — in the ``/ask`` serving
   chain (the profile's ``request_path_modules``), a ``cv.wait`` whose timeout is neither derived
   from a deadline (``.bound(…)`` / ``.remaining(…)`` dataflow, same
   derivation deadline-flow uses) nor clamped by one in scope is a wait
   that can outlive the request budget.  Composes with deadline-flow:
   that rule flags unclamped waits *when a deadline is in scope*; this
   one flags request-path cv waits with NO deadline in reach at all —
   a worker's idle tick is the known, baselined exception.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.concurrency import (
    CONDITIONISH_ATTR_RE,
    canonical,
    discover_locks,
    held_at_call_sites,
    is_lock_expr,
    known_lock_attrs,
    lock_aliases,
    lock_id_for,
)
from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
)
from docqa_tpu_torch.analysis.deadline_flow import (
    _FunctionScan,
    is_request_path,
)


def _is_cvish(receiver: str, known_cvs: Set[str]) -> bool:
    if not receiver:
        return False
    attr = receiver.rsplit(".", 1)[-1]
    return attr in known_cvs or bool(CONDITIONISH_ATTR_RE.search(attr))


class CvProtocolChecker:
    rule = "cv-protocol"

    def check(self, package: Package) -> List[Finding]:
        decls = discover_locks(package)
        aliases = lock_aliases(decls, package)
        known_attrs = known_lock_attrs(decls)
        known_cvs = {
            d.lock_id.rsplit(".", 1)[-1]
            for d in decls.values()
            if d.kind == "Condition"
        }
        call_site_held = held_at_call_sites(package, known_attrs)
        out: List[Finding] = []
        for fn in package.functions:
            out.extend(
                self._check_fn(
                    fn, known_attrs, known_cvs, aliases, call_site_held,
                    is_request_path(package, fn.module),
                )
            )
        return out

    def _check_fn(
        self,
        fn: FunctionInfo,
        known_attrs: Set[str],
        known_cvs: Set[str],
        aliases: Dict[str, str],
        call_site_held: Dict[int, Set[str]],
        request_path: bool,
    ) -> List[Finding]:
        module = fn.module
        base_held = {
            canonical(lid, aliases)
            for lid in call_site_held.get(id(fn.node), set())
        }
        scan: Optional[_FunctionScan] = None
        out: List[Finding] = []

        def visit(
            node: ast.AST, held: Tuple[str, ...], in_while: bool
        ) -> None:
            nonlocal scan
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                child_in_while = in_while or isinstance(child, ast.While)
                new_held = held
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        if isinstance(item.context_expr, ast.Call):
                            continue
                        try:
                            text = ast.unparse(item.context_expr)
                        except Exception:
                            continue
                        if is_lock_expr(text, known_attrs) or _is_cvish(
                            text, known_cvs
                        ):
                            new_held = new_held + (
                                canonical(
                                    lock_id_for(fn, text), aliases
                                ),
                            )
                if isinstance(child, ast.Call):
                    name = call_name(child)
                    attr = name.rsplit(".", 1)[-1] if name else ""
                    receiver = (
                        name.rsplit(".", 1)[0] if "." in name else ""
                    )
                    if attr in ("wait", "notify", "notify_all") and _is_cvish(
                        receiver, known_cvs
                    ):
                        cv_id = canonical(
                            lock_id_for(fn, receiver), aliases
                        )
                        holds = cv_id in set(new_held) | base_held
                        if attr == "wait":
                            if not child_in_while:
                                out.append(
                                    Finding(
                                        self.rule,
                                        module.relpath,
                                        child.lineno,
                                        fn.qualname,
                                        f"{receiver}.wait() outside a "
                                        "while-predicate loop (spurious "
                                        "wakeups and stolen predicates "
                                        "need the re-check; use wait_for "
                                        "or loop)",
                                    )
                                )
                            if request_path:
                                if scan is None:
                                    scan = _FunctionScan(fn)
                                arg = scan.timeout_arg(child, "wait")
                                clamped = (
                                    arg is not None
                                    and scan.arg_is_clamped(arg)
                                )
                                if not scan.has_deadline() and not clamped:
                                    out.append(
                                        Finding(
                                            self.rule,
                                            module.relpath,
                                            child.lineno,
                                            fn.qualname,
                                            f"request-path {receiver}."
                                            "wait() without a Deadline: "
                                            "the timeout is neither "
                                            "deadline-derived nor is one "
                                            "in scope to clamp it",
                                        )
                                    )
                        else:  # notify / notify_all
                            if not holds:
                                out.append(
                                    Finding(
                                        self.rule,
                                        module.relpath,
                                        child.lineno,
                                        fn.qualname,
                                        f"{receiver}.{attr}() without "
                                        f"holding {cv_id} — notify "
                                        "outside the lock raises "
                                        "RuntimeError on exactly the "
                                        "paths tests never run",
                                    )
                                )
                visit(child, new_held, child_in_while)

        visit(fn.node, (), False)
        return out
