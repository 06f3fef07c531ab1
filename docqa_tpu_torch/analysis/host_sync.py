"""host-sync: no blocking device→host syncs on the /ask serving path,
counterpart of ``docqa_tpu/analysis/host_sync.py``.

A sync is legal Python (``.item()``, ``.tolist()``, ``.cpu()``,
``float(t)`` on a tensor, ``torch.cuda.synchronize()``) and each one
blocks the calling thread until the card has drained the stream, so one
stray sync on /ask serialises the pipeline invisibly.  The port's
sanctioned fetch is the spine's: a closure starts its copies with
``to_host`` (``engines/spine.py``), and what ``spine_run`` / a ticket's
``result()`` returns has landed on the host; the lane's own wait on an
item's end event is the other sanctioned wait.

Scope: the /ask chain (the profile's ``request_path_modules`` and its
``host_sync_modules``; fixtures opt in with ``# docqa-lint:
request-path``).  The reference also skips functions jit-purity marks
traced; the port traces nothing, so nothing is skipped here.

Findings — patterns that are unambiguously a sync:

1. a fetch call (the profile's ``host_sync_fetch_calls``:
   ``torch.cuda.synchronize`` here, ``jax.device_get`` in the reference);
2. a sync method (the profile's ``host_sync_methods``: ``.item()``,
   ``.tolist()``, ``.cpu()``, ``.numpy()``, an event's or stream's
   ``.synchronize()``) on a receiver that is not a known host value;
3. ``float(x)`` / ``int(x)`` / ``bool(x)`` where ``x``'s fact says device:
   assigned from a call under a device prefix (``torch.*``), from a
   device value's method (``done.all()``), from arithmetic or a comparison
   over device values, or from calling a compiled wrapper;
4. ``np.asarray(...)`` / ``np.array(...)`` applied DIRECTLY to a device
   computation.

Facts flow in statement order; a loop's body is scanned once for facts
before its test and body are checked, so a value that turns device inside
the loop (``done |= is_eos``) is device at the loop's test.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
)

_GET_FN_RE = re.compile(r"_get_\w*fn$")
_LOOPS = (ast.While, ast.For, ast.AsyncFor)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


class HostSyncChecker:
    rule = "host-sync"

    def check(self, package: Package) -> List[Finding]:
        profile = package.profile
        scope = profile.request_path_modules | profile.host_sync_modules
        out: List[Finding] = []
        for fn in package.functions:
            module = fn.module
            if not (module.relname in scope or module.request_path_pragma):
                continue
            key = f"{module.relname}:{fn.qualname}"
            if key in profile.host_sync_sanctioned:
                continue
            self._scan(package, fn, out)
        return out

    # -- per-function --------------------------------------------------------

    def _scan(self, package: Package, fn: FunctionInfo, out: List[Finding]) -> None:
        module = fn.module
        profile = package.profile
        checking = [True]

        def add(node, message) -> None:
            if checking[0]:
                out.append(
                    Finding(
                        self.rule, module.relpath,
                        getattr(node, "lineno", 1), fn.qualname, message,
                    )
                )

        # value facts: name -> True (device) / False (host or unknown)
        device: Dict[str, bool] = {}
        host: Set[str] = set()
        # names bound to compiled wrappers (calling them yields device values)
        wrappers: Set[str] = set()

        def resolved_of(call: ast.Call) -> str:
            name = call_name(call)
            return module.resolve_alias(name) if name else ""

        def is_host_call(call: ast.Call) -> bool:
            resolved = resolved_of(call)
            if not resolved:
                return False
            tail = resolved.rsplit(".", 1)[-1]
            return (
                resolved in profile.host_sync_host_calls
                or tail in profile.host_sync_host_calls
            )

        def is_device_call(call: ast.Call) -> bool:
            name = call_name(call)
            if not name:
                return False
            resolved = module.resolve_alias(name)
            tail = resolved.rsplit(".", 1)[-1]
            for prefix in profile.host_sync_device_prefixes:
                if resolved.startswith(prefix) or name.startswith(prefix):
                    return True
            if tail in profile.host_sync_wrapper_tails:
                return False  # constructing a wrapper is not a dispatch
            base = name.split(".")[0]
            if base in wrappers or name in wrappers:
                return True
            if (
                isinstance(call.func, ast.Attribute)
                and call.func.attr not in profile.host_sync_methods
            ):
                return expr_is_device(call.func.value)
            return False

        def expr_is_device(node: ast.AST) -> bool:
            if isinstance(node, ast.Name):
                return device.get(node.id, False)
            if isinstance(node, ast.Subscript):
                return expr_is_device(node.value)
            if isinstance(node, ast.Attribute) and node.attr in (
                "T", "mT", "real", "imag"
            ):
                return expr_is_device(node.value)
            if isinstance(node, ast.Call):
                name = call_name(node)
                resolved = module.resolve_alias(name) if name else ""
                # np.asarray(...) LAUNDERS: its result is host-side
                if resolved.rsplit(".", 1)[-1] in (
                    "asarray", "array"
                ) and resolved.split(".")[0] in ("np", "numpy"):
                    return False
                if is_host_call(node):
                    return False
                return is_device_call(node)
            if isinstance(node, ast.BinOp):
                return expr_is_device(node.left) or expr_is_device(
                    node.right
                )
            if isinstance(node, ast.Compare):
                return any(
                    expr_is_device(x)
                    for x in [node.left] + list(node.comparators)
                )
            if isinstance(node, ast.UnaryOp):
                return expr_is_device(node.operand)
            return False

        def expr_is_host(node: ast.AST) -> bool:
            if isinstance(node, ast.Name):
                return node.id in host
            if isinstance(node, ast.Subscript):
                return expr_is_host(node.value)
            if isinstance(node, ast.Call):
                return is_host_call(node)
            return False

        def handle_expr(node: ast.AST) -> None:
            """Check every call in an expression tree, without descending
            into nested defs/lambdas (their own scopes)."""
            stack = [node]
            while stack:
                cur = stack.pop()
                if isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue
                if isinstance(cur, ast.Call):
                    check_call(cur)
                elif isinstance(cur, _COMPREHENSIONS):
                    for gen in cur.generators:
                        bind_iter(gen.target, gen.iter)
                stack.extend(ast.iter_child_nodes(cur))

        def bind_iter(target: ast.AST, it: ast.AST) -> None:
            """Elements of a host value are host values."""
            if expr_is_host(it):
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        host.add(n.id)
                        device[n.id] = False

        def bind_names(target: ast.AST, dev: bool, is_host: bool,
                       jitish: bool) -> None:
            for n in ast.walk(target):
                if not isinstance(n, ast.Name):
                    continue
                if jitish:
                    wrappers.add(n.id)
                    device[n.id] = False
                else:
                    device[n.id] = dev
                if is_host and not jitish:
                    host.add(n.id)
                else:
                    host.discard(n.id)

        def bind_assign(stmt: ast.Assign) -> None:
            value = stmt.value
            jitish = False
            if isinstance(value, ast.Call):
                name = call_name(value)
                tail = (
                    module.resolve_alias(name).rsplit(".", 1)[-1]
                    if name else ""
                )
                attr_tail = name.rsplit(".", 1)[-1] if name else ""
                jitish = tail in profile.host_sync_wrapper_tails or bool(
                    _GET_FN_RE.search(attr_tail)
                )
            for target in stmt.targets:
                if (
                    isinstance(target, ast.Tuple)
                    and isinstance(value, ast.Tuple)
                    and len(target.elts) == len(value.elts)
                ):
                    # a, b = x, y binds element by element
                    facts = [
                        (expr_is_device(v), expr_is_host(v))
                        for v in value.elts
                    ]
                    for t, (dev, is_host) in zip(target.elts, facts):
                        bind_names(t, dev, is_host, False)
                    continue
                bind_names(
                    target, expr_is_device(value), expr_is_host(value), jitish
                )

        def bind_aug(stmt: ast.AugAssign) -> None:
            if isinstance(stmt.target, ast.Name):
                name = stmt.target.id
                device[name] = device.get(name, False) or expr_is_device(
                    stmt.value
                )
                if device[name]:
                    host.discard(name)

        # statement-order scan (no nested defs: they have their own pass)
        def walk(stmts) -> None:
            for stmt in stmts:
                if isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if isinstance(stmt, ast.Assign):
                    handle_expr(stmt.value)
                    bind_assign(stmt)
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    bind_iter(stmt.target, stmt.iter)
                if isinstance(stmt, ast.AugAssign):
                    handle_expr(stmt.value)
                    bind_aug(stmt)
                    continue
                if isinstance(stmt, _LOOPS) and checking[0]:
                    # bind the body's facts before the test is checked
                    checking[0] = False
                    try:
                        walk(stmt.body)
                    finally:
                        checking[0] = True
                for _name, field in ast.iter_fields(stmt):
                    if isinstance(field, ast.expr):
                        handle_expr(field)
                    elif isinstance(field, list):
                        if field and isinstance(field[0], ast.stmt):
                            walk(field)
                        elif field and isinstance(
                            field[0], ast.excepthandler
                        ):
                            for handler in field:
                                walk(handler.body)
                        elif field and isinstance(field[0], ast.expr):
                            for e in field:
                                handle_expr(e)
                        elif field and isinstance(field[0], ast.withitem):
                            for item in field:
                                handle_expr(item.context_expr)

        def check_call(node: ast.Call) -> None:
            name = call_name(node)
            if not name:
                return
            resolved = module.resolve_alias(name)
            tail = name.rsplit(".", 1)[-1]
            if resolved in profile.host_sync_fetch_calls:
                add(node, f"{resolved}() on the request path — a "
                         "blocking device fetch outside the sanctioned "
                         "one-fetch-per-dispatch idiom")
                return
            if tail in profile.host_sync_methods and isinstance(
                node.func, ast.Attribute
            ):
                if not expr_is_host(node.func.value):
                    add(node, f".{tail}() on the request path — a blocking "
                             "scalar/host sync; batch it into the dispatch's "
                             "single packed fetch")
                return
            if name in ("float", "int", "bool") and len(node.args) == 1:
                if expr_is_device(node.args[0]):
                    add(node, f"{name}() on a device value — an implicit "
                             "blocking sync per scalar; fetch once with "
                             "np.asarray and convert host-side")
                return
            if tail in ("asarray", "array") and resolved.split(".")[0] in (
                "np", "numpy"
            ):
                if node.args and isinstance(node.args[0], ast.Call) and (
                    is_device_call(node.args[0])
                ):
                    add(node, "np.asarray() directly over a device "
                             "computation — materializes a mid-pipeline "
                             "intermediate on host; keep the value "
                             "device-side or fetch a held reference once")

        body = getattr(fn.node, "body", None)
        if body:
            walk(body)
