"""rng-discipline: random draws on the serving path are explicit and
seeded per request.

Counterpart of ``docqa_tpu/analysis/rng_discipline.py``.  The reference's
rule is about JAX keys being affine: a key is consumed at most once and
every further key is derived with ``split`` / ``fold_in``; a fixed
``PRNGKey(<literal>)`` on the request path makes every request sample
alike.  Those findings come from the profile's key tables and still fire
under the reference's profile.  A ``torch.Generator`` is a stateful
stream, not an affine key, so the port's profile has no key tables and
the rule's port half says instead:

1. no call on the request path draws from the process-global torch
   generator: ``torch.rand*`` / ``multinomial`` / ``bernoulli`` (and the
   in-place samplers) without ``generator=`` — sampling draws from the
   ``torch.Generator`` seeded per request (``engines/serve.py``
   ``ContinuousBatcher._generator``, ``engines/generate.py``
   ``GenerateEngine.next_request_seed``);
2. nothing on the request path reseeds the global generator
   (``torch.manual_seed``);
3. a literal seed on the request path (``gen.manual_seed(0)``,
   ``np.random.default_rng(0)``) is a finding;
4. module-level RNG (``np.random.<fn>`` bar the seeded-generator family,
   bare ``random.<fn>`` bar ``random.Random``) is global mutable state on
   a device-result or replay-key path, in both profiles.

Scope: the profile's ``rng_modules`` (the /ask chain, the decode and
batching engines and the broker, whose redelivery jitter must come from
seeded state); fixtures opt in with the ``docqa-lint: request-path``
pragma.  Resolution is name-based: only bare names are tracked for key
reuse, and a tracked name returned or stored escapes tracking.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Module,
    Package,
    call_name,
)

def _is_numeric_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(
        node.op, (ast.USub, ast.UAdd)
    ):
        return _is_numeric_literal(node.operand)
    return False


class RngDisciplineChecker:
    rule = "rng-discipline"

    def check(self, package: Package) -> List[Finding]:
        self._p = package.profile
        scope = package.profile.rng_modules
        out: List[Finding] = []
        for fn in package.functions:
            module = fn.module
            if not (module.relname in scope or module.request_path_pragma):
                continue
            self._scan(fn, out)
        for module in package.modules:
            if not (module.relname in scope or module.request_path_pragma):
                continue
            self._scan_module_level(module, out)
        return out

    # -- shared call checks ---------------------------------------------------

    def _resolved(self, module: Module, node: ast.Call) -> str:
        name = call_name(node)
        return module.resolve_alias(name) if name else ""

    def _check_literal_key(
        self,
        module: Module,
        node: ast.Call,
        symbol: str,
        exempt: Set[int],
        out: List[Finding],
    ) -> None:
        if id(node) in exempt:
            return
        if self._resolved(module, node) not in self._p.rng_key_mints:
            return
        if len(node.args) == 1 and _is_numeric_literal(node.args[0]):
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    symbol,
                    "fixed jax.random.PRNGKey(<literal>) on the request "
                    "path — every request would sample identically; mint "
                    "per-request keys from the counter scheme "
                    "(GenerateEngine.next_request_key / serve._next_rng), "
                    "or thread greedy_dummy_key() on greedy-only paths",
                )
            )

    def _check_module_rng(
        self,
        module: Module,
        node: ast.Call,
        symbol: str,
        out: List[Finding],
    ) -> None:
        resolved = self._resolved(module, node)
        if not resolved:
            return
        tail = resolved.rsplit(".", 1)[-1]
        if (
            resolved.startswith("numpy.random.")
            and tail not in self._p.rng_numpy_ok
        ):
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    symbol,
                    f"np.random.{tail}() — global numpy RNG state on a "
                    "device-result/replay path; use a seeded "
                    "np.random.default_rng instance",
                )
            )
        elif (
            resolved.startswith("random.")
            and resolved.count(".") == 1
            and tail != "Random"
        ):
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    symbol,
                    f"random.{tail}() — process-global RNG on a "
                    "device-result/replay path; use a seeded "
                    "random.Random instance or the engine key scheme",
                )
            )

    def _check_global_generator(
        self,
        module: Module,
        node: ast.Call,
        symbol: str,
        out: List[Finding],
    ) -> None:
        """The port's half: a draw from the process-global torch generator
        (no ``generator=``), seeding that generator, and a literal seed."""
        name = call_name(node)
        if not name:
            return
        resolved = module.resolve_alias(name)
        tail = "." + name.rsplit(".", 1)[-1] if "." in name else ""
        kwargs = {k.arg for k in node.keywords}
        if (
            resolved in self._p.rng_global_draws
            or (tail and tail in self._p.rng_global_draws and not resolved.startswith(
                ("numpy.", "random.")))
        ) and self._p.rng_generator_kwarg not in kwargs:
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    symbol,
                    f"{name}() without {self._p.rng_generator_kwarg}= draws "
                    "from the process-global torch generator on the request "
                    "path — every request shares one stream, so a draw "
                    "depends on every draw before it; pass the request's "
                    "seeded torch.Generator",
                )
            )
        if resolved in self._p.rng_global_seeders:
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    symbol,
                    f"{name}() reseeds the process-global torch generator on "
                    "the request path — concurrent requests would reset each "
                    "other's streams; seed a per-request torch.Generator",
                )
            )
        if (
            (resolved in self._p.rng_seed_calls or tail in self._p.rng_seed_calls)
            and len(node.args) == 1
            and _is_numeric_literal(node.args[0])
        ):
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    symbol,
                    f"literal seed in {name}() on the request path — every "
                    "request would draw the same stream; derive the seed "
                    "per request (GenerateEngine.next_request_seed)",
                )
            )

    def _lower_exempt_ids(self, root: ast.AST) -> Set[int]:
        """ids of every node inside ``.lower(...)`` call arguments — AOT
        shape probes pass placeholder keys that trace shapes and never
        draw."""
        exempt: Set[int] = set()
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name or name.rsplit(".", 1)[-1] != "lower":
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                for sub in ast.walk(arg):
                    exempt.add(id(sub))
        return exempt

    # -- module level ---------------------------------------------------------

    def _scan_module_level(self, module: Module, out: List[Finding]) -> None:
        exempt = self._lower_exempt_ids(module.tree)
        stack = list(ast.iter_child_nodes(module.tree))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Call):
                self._check_literal_key(
                    module, node, "<module>", exempt, out
                )
                self._check_module_rng(module, node, "<module>", out)
                self._check_global_generator(module, node, "<module>", out)
            stack.extend(ast.iter_child_nodes(node))

    # -- per-function affine scan ---------------------------------------------

    def _scan(self, fn: FunctionInfo, out: List[Finding]) -> None:
        module = fn.module
        exempt = self._lower_exempt_ids(fn.node)
        in_dummy = fn.name == self._p.rng_greedy_dummy
        # Key-named PARAMS are tracked only when the body actually
        # touches jax.random — ``rng``/``key`` params elsewhere are
        # numpy generators or cache-key strings, and flagging a dict key
        # passed to two calls would be pure noise.  Locally minted keys
        # are always tracked.
        touches_jax_random = False
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                resolved = self._resolved(module, node)
                name = call_name(node)
                if resolved.startswith("jax.random.") or (
                    name
                    and name.rsplit(".", 1)[-1] in self._p.rng_key_scheme_tails
                ):
                    touches_jax_random = True
                    break
        # fresh[name]: True = mint/derive result not yet consumed;
        # False = consumed once already
        fresh: Dict[str, bool] = (
            {p: True for p in fn.params if p in self._p.rng_key_params}
            if touches_jax_random
            else {}
        )
        emitted: Set[tuple] = set()

        def emit(node, message, dedup_key=None) -> None:
            key = dedup_key or (getattr(node, "lineno", 1), message)
            if key in emitted:
                return
            emitted.add(key)
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    getattr(node, "lineno", 1),
                    fn.qualname,
                    message,
                )
            )

        def key_source(value: ast.AST) -> Optional[str]:
            """'fresh' when the expression mints/derives a key (or indexes
            one out of a split result), else None."""
            if isinstance(value, ast.Subscript):
                return key_source(value.value)
            if not isinstance(value, ast.Call):
                return None
            resolved = self._resolved(module, value)
            if resolved in self._p.rng_key_mints or resolved in self._p.rng_key_derives:
                return "fresh"
            name = call_name(value)
            if name and name.rsplit(".", 1)[-1] in self._p.rng_key_scheme_tails:
                return "fresh"
            return None

        def consume_args(call: ast.Call) -> None:
            """Any call consumes the tracked key names in its argument
            list — including split/fold_in (they consume the old key and
            mint fresh ones into the assignment targets)."""
            if id(call) in exempt:
                return
            for arg in list(call.args) + [k.value for k in call.keywords]:
                target = arg
                if isinstance(target, ast.Starred):
                    target = target.value
                if not isinstance(target, ast.Name):
                    continue
                name = target.id
                if name not in fresh:
                    continue
                if not fresh[name]:
                    emit(
                        call,
                        f"key '{name}' reused after being consumed — "
                        "jax.random keys are affine; split/fold_in "
                        "before every additional use",
                        dedup_key=(getattr(call, "lineno", 1), name),
                    )
                fresh[name] = False

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
                    if not in_dummy:
                        self._check_literal_key(
                            module, cur, fn.qualname, exempt, out
                        )
                    self._check_module_rng(module, cur, fn.qualname, out)
                    self._check_global_generator(module, cur, fn.qualname, out)
                    consume_args(cur)
                stack.extend(ast.iter_child_nodes(cur))

        def untrack_escapes(node: ast.AST) -> None:
            """A tracked key that escapes (returned, yielded, stored on
            an attribute/container) leaves the affine scan — ownership
            moved somewhere this name-based pass cannot follow."""
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and sub.id in fresh:
                    del fresh[sub.id]

        def bind_assign(stmt: ast.Assign) -> None:
            src = key_source(stmt.value)
            is_tuple_derive = isinstance(stmt.value, ast.Call) and (
                self._resolved(module, stmt.value) in self._p.rng_key_derives
            )
            for target in stmt.targets:
                names = []
                if isinstance(target, ast.Name):
                    names = [target]
                elif isinstance(target, (ast.Tuple, ast.List)):
                    names = [
                        e for e in target.elts if isinstance(e, ast.Name)
                    ]
                elif isinstance(target, (ast.Attribute, ast.Subscript)):
                    # storing INTO state: the value escapes
                    untrack_escapes(stmt.value)
                    continue
                for n in names:
                    if src == "fresh" or (is_tuple_derive and names):
                        fresh[n.id] = True
                    elif n.id in fresh:
                        del fresh[n.id]

        def merge(base: Dict[str, bool], *branches: Dict[str, bool]):
            names = set()
            for b in branches:
                names |= set(b)
            base.clear()
            for name in names:
                vals = [b[name] for b in branches if name in b]
                if len(vals) == len(branches):
                    base[name] = all(vals)
                # tracked in only one arm: untracked after the join
                # (the other arm escaped/rebound it — don't guess)

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
                if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    if stmt.value is not None:
                        handle_expr(stmt.value)
                    continue
                if isinstance(stmt, (ast.Return, ast.Expr)) and isinstance(
                    getattr(stmt, "value", None), (ast.Yield, ast.YieldFrom)
                ):
                    if stmt.value.value is not None:
                        handle_expr(stmt.value.value)
                        untrack_escapes(stmt.value.value)
                    continue
                if isinstance(stmt, ast.Return):
                    if stmt.value is not None:
                        handle_expr(stmt.value)
                        untrack_escapes(stmt.value)
                    continue
                if isinstance(stmt, ast.If):
                    handle_expr(stmt.test)
                    saved = dict(fresh)
                    walk(stmt.body)
                    then_end = dict(fresh)
                    fresh.clear()
                    fresh.update(saved)
                    walk(stmt.orelse)
                    else_end = dict(fresh)
                    merge(fresh, then_end, else_end)
                    continue
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    handle_expr(stmt.iter)
                    # two passes: a consume-without-rebind shows up when
                    # iteration two replays the body
                    walk(stmt.body)
                    walk(stmt.body)
                    walk(stmt.orelse)
                    continue
                if isinstance(stmt, ast.While):
                    handle_expr(stmt.test)
                    walk(stmt.body)
                    walk(stmt.body)
                    walk(stmt.orelse)
                    continue
                if isinstance(stmt, ast.Try):
                    walk(stmt.body)
                    for handler in stmt.handlers:
                        walk(handler.body)
                    walk(stmt.orelse)
                    walk(stmt.finalbody)
                    continue
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        handle_expr(item.context_expr)
                    walk(stmt.body)
                    continue
                for _name, field in ast.iter_fields(stmt):
                    if isinstance(field, ast.expr):
                        handle_expr(field)
                    elif isinstance(field, list):
                        if field and isinstance(field[0], ast.stmt):
                            walk(field)
                        elif field and isinstance(field[0], ast.expr):
                            for e in field:
                                handle_expr(e)

        body = getattr(fn.node, "body", None)
        if body:
            walk(body)
