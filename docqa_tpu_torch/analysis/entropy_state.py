"""entropy-in-state: no wall-clock, uuid or urandom value in a key or a
replayed record.

Counterpart of ``docqa_tpu/analysis/entropy_state.py``.  Replay rebuilds
state from persisted records and derives cache and prefix keys again from
request content.  A ``time.time()`` / ``uuid4()`` / ``os.urandom()`` value
that leaks into a *key*, or into a journal field that replay reads back as
state, can never be minted again by the second run: the replay gate
diverges, or two runs build different cache keys and the warm path never
runs.  Timestamps in *telemetry* are fine: the taint stops at the
observability sinks, and scheduling or audit fields that follow the
timestamp naming convention (``*_at`` / ``*_date`` / ``*_time`` / ``ts``
/ ``timestamp``) are sanctioned, since replay carries them as data and
never as identity.

Scope: the profile's ``state_modules`` (qa keys, the batcher, paged pool
and replica pool caches, the broker journal, registry and pipeline
records, the store, the retrieval observatory); fixtures opt in with the
``docqa-lint: request-path`` pragma.

Taint sources (through :mod:`docqa_tpu_torch.analysis.entropy`): the
process and wall-clock kinds, plus the monotonic interval clocks, which
measure durations legitimately everywhere except inside a key.
Propagation is one-level name taint (an assignment from a tainted
expression taints its targets; one from a clean expression clears them).

Sinks that flag a tainted value:

1. an argument to ``hashlib.*`` / ``zlib.crc32`` / builtin ``hash``;
2. a keyword argument whose name contains ``key``;
3. the right-hand side of an assignment to a ``*key*`` / ``*fingerprint*``
   name (f-strings and concatenation included);
4. a journal or publish record field whose name does not follow the
   timestamp convention;
5. a subscript key on a cache-like receiver (``*cache*`` / ``*entries*``
   / ``*table*``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Module,
    Package,
    call_name,
    dotted_name,
)
from docqa_tpu_torch.analysis.entropy import classify_entropy_call

# record fields that carry a timestamp AS DATA (telemetry/scheduling/
# audit) — replay never derives identity or ordering keys from them
_TIMESTAMP_FIELD_RE = re.compile(
    r"(_at|_date|_unix|_ts|_time|_ms|_s)$|^(ts|t0|time|now|timestamp|"
    r"ready_at|deadline)$"
)
_KEYISH_NAME_RE = re.compile(r"key|fingerprint", re.IGNORECASE)
_CACHEISH_RECV_RE = re.compile(r"cache|entries|table", re.IGNORECASE)
_JOURNAL_CALL_TAILS = frozenset({"publish", "_journal_write"})


class EntropyStateChecker:
    rule = "entropy-in-state"

    def check(self, package: Package) -> List[Finding]:
        self._profile = package.profile
        scope = package.profile.state_modules
        out: List[Finding] = []
        for fn in package.functions:
            module = fn.module
            if not (module.relname in scope or module.request_path_pragma):
                continue
            self._scan(fn, out)
        return out

    # -- taint ---------------------------------------------------------------

    def _is_entropy_call(self, module: Module, node: ast.Call) -> bool:
        hit = classify_entropy_call(module, node, self._profile)
        if hit is not None:
            # rng mints are rng-discipline's rule, not taint-into-state
            return hit[0] in ("process", "wallclock")
        name = call_name(node)
        if not name:
            return False
        return module.resolve_alias(name) in self._profile.entropy_monotonic_clocks

    def _scan(self, fn: FunctionInfo, out: List[Finding]) -> None:
        module = fn.module
        tainted: Set[str] = set()
        # dict-literal names: name -> {field: tainted?} so a record built
        # locally then published still attributes the tainted field
        dict_fields: Dict[str, Dict[str, bool]] = {}

        def emit(node, message) -> None:
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    fn.qualname,
                    message,
                )
            )

        def expr_tainted(node: ast.AST) -> bool:
            stack = [node]
            while stack:
                cur = stack.pop()
                if isinstance(
                    cur,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                if isinstance(cur, ast.Name) and cur.id in tainted:
                    return True
                if isinstance(cur, ast.Call) and self._is_entropy_call(
                    module, cur
                ):
                    return True
                stack.extend(ast.iter_child_nodes(cur))
            return False

        def tainted_dict_fields(node: ast.Dict) -> Dict[str, bool]:
            fields: Dict[str, bool] = {}
            for k, v in zip(node.keys, node.values):
                if not (
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                ):
                    continue
                fields[k.value] = expr_tainted(v)
            return fields

        def check_record_fields(call_node, fields, label) -> None:
            for field, is_tainted in fields.items():
                if not is_tainted:
                    continue
                if _TIMESTAMP_FIELD_RE.search(field):
                    continue
                emit(
                    call_node,
                    f"record field '{field}' in {label} carries "
                    "wall-clock/uuid/urandom entropy — replay reads this "
                    "record back as state it cannot re-mint; use a "
                    "timestamp-convention field name (*_at/ts) for "
                    "telemetry, or derive the value from request content",
                )

        def check_call_sinks(node: ast.Call) -> None:
            name = call_name(node)
            resolved = module.resolve_alias(name) if name else ""
            tail = name.rsplit(".", 1)[-1] if name else ""
            # sink 1: digests
            if (
                resolved.startswith("hashlib.")
                or resolved == "zlib.crc32"
                or (name == "hash" and "hash" not in module.imports)
            ):
                for arg in node.args:
                    if expr_tainted(arg):
                        emit(
                            node,
                            f"entropy flows into {tail}() — the digest "
                            "becomes a key no replayed process can "
                            "re-derive; digest request content, not "
                            "clocks/uuids",
                        )
                        break
            # sink 2: key-named keyword arguments
            for kw in node.keywords:
                if (
                    kw.arg
                    and "key" in kw.arg.lower()
                    and expr_tainted(kw.value)
                ):
                    emit(
                        node,
                        f"keyword '{kw.arg}' receives wall-clock/uuid "
                        "entropy — keys must be derivable from request "
                        "content alone",
                    )
            # sink 4: journal/publish record fields
            if tail in _JOURNAL_CALL_TAILS:
                for arg in list(node.args) + [
                    k.value for k in node.keywords
                ]:
                    if isinstance(arg, ast.Dict):
                        check_record_fields(
                            node, tainted_dict_fields(arg), f"{tail}()"
                        )
                    elif (
                        isinstance(arg, ast.Name)
                        and arg.id in dict_fields
                    ):
                        check_record_fields(
                            node, dict_fields[arg.id], f"{tail}()"
                        )

        def handle_expr(node: ast.AST) -> None:
            stack = [node]
            while stack:
                cur = stack.pop()
                if isinstance(
                    cur,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                if isinstance(cur, ast.Call):
                    check_call_sinks(cur)
                stack.extend(ast.iter_child_nodes(cur))

        def bind_assign(stmt: ast.Assign) -> None:
            value = stmt.value
            is_tainted = expr_tainted(value)
            fields = (
                tainted_dict_fields(value)
                if isinstance(value, ast.Dict)
                else None
            )
            for target in stmt.targets:
                # sink 5: tainted subscript KEY on a cache-ish receiver
                if isinstance(target, ast.Subscript):
                    recv = dotted_name(target.value)
                    if _CACHEISH_RECV_RE.search(recv) and expr_tainted(
                        target.slice
                    ):
                        emit(
                            stmt,
                            f"cache/table '{recv}' keyed by a wall-clock/"
                            "uuid value — the entry is unreachable after "
                            "restart; key by request content",
                        )
                    continue
                if not isinstance(target, ast.Name):
                    continue
                # sink 3: key-named variables
                if is_tainted and _KEYISH_NAME_RE.search(target.id):
                    emit(
                        stmt,
                        f"'{target.id}' is built from wall-clock/uuid "
                        "entropy — a key that no restarted process can "
                        "re-derive; build it from request content",
                    )
                if is_tainted:
                    tainted.add(target.id)
                else:
                    tainted.discard(target.id)
                if fields is not None:
                    dict_fields[target.id] = fields
                else:
                    dict_fields.pop(target.id, None)

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

        body = getattr(fn.node, "body", None)
        if body:
            walk(body)
