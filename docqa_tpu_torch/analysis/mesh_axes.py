"""mesh-axes: every collective runs over a declared mesh axis, through
the mesh's own wrappers.

Counterpart of ``docqa_tpu/analysis/mesh_axes.py``.  Under the
reference's profile it gives the reference's two JAX sub-rules: every
string literal in axis position (a ``PartitionSpec`` argument, an
``axis_name=`` keyword, a ``lax`` collective's axis) is a declared axis
(``*_axis`` defaults, ``Mesh(...)`` axis names), and every ``lax``
collective runs inside a ``shard_map`` body over an axis that site binds
(bodies resolved through bare names, nested defs, ``functools.partial``
aliases and package calls with a parameter-binding environment).

The port has no ``shard_map``: each rank is one process, and its
collectives are ``torch.distributed`` calls over the process groups of a
:class:`~docqa_tpu_torch.runtime.mesh.MeshContext`.  The profile's
``mesh_module`` (``runtime/mesh.py``) holds the counted wrappers
(``all_reduce``, ``all_gather``, ``barrier``, ``all_to_all``,
``ring_exchange`` and the autograd ``copy_to_group`` /
``reduce_from_group`` / ``gather_from_group``): each counts its call in
``COLLECTIVES`` under ``<op>.<site>`` and breaks the mesh on a lost peer.
The port's half checks three things:

* no ``torch.distributed`` collective is called outside the mesh module
  (an uncounted collective escapes the shard budget, and a failure there
  does not break the mesh);
* each wrapper call's group resolves to a MeshContext data or model group
  (``mesh.data_group`` / ``mesh.model_group`` / ``mesh.group(axis)``),
  through local assignments, ``self.<attr>`` assignments of the class
  and parameters (a parameter is the caller's group, checked at its
  call);
* each wrapper call's site is a string literal, so the ``COLLECTIVES``
  keys the shard budget reads are stable (inside the mesh module a site
  parameter passes through).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Module,
    Package,
    call_name,
    expr_text,
    stmt_walk,
)

_AXIS_ARG_POS = {"axis_index": 0, "axis_size": 0}
_LIT = "lit:"  # token namespace for string literals


# set by MeshAxesChecker.check from the profile (the rule runs one
# package at a time)
_SPEC_TAILS = frozenset({"PartitionSpec"})
_COLLECTIVES = frozenset()


def _is_partition_spec(module: Module, node: ast.Call) -> bool:
    resolved = module.resolve_alias(call_name(node))
    return resolved.rsplit(".", 1)[-1] in _SPEC_TAILS


def _is_collective(module: Module, node: ast.Call) -> Optional[str]:
    """The collective's bare name, or None.  Requires the call to resolve
    into jax (``jax.lax.psum``, ``lax.psum``, or a ``from jax.lax import
    psum`` alias) so a package helper named ``psum`` never matches."""
    name = call_name(node)
    if not name:
        return None
    resolved = module.resolve_alias(name)
    tail = resolved.rsplit(".", 1)[-1]
    if tail not in _COLLECTIVES:
        return None
    if resolved == tail:  # bare, un-imported name: not jax.lax
        return None
    head = resolved.split(".")[0]
    if head != "jax" and "lax" not in resolved.split("."):
        return None
    return tail


def _axis_expr(tail: str, node: ast.Call) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == "axis_name":
            return kw.value
    pos = _AXIS_ARG_POS.get(tail, 1)
    if len(node.args) > pos:
        return node.args[pos]
    return None


def _literal_assignments(scope: ast.AST) -> Dict[str, str]:
    """name -> string literal, for simple ``ax = "model"`` assignments."""
    out: Dict[str, str] = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def _arg(node: ast.Call, pos: int, kw: str) -> Optional[ast.AST]:
    for k in node.keywords:
        if k.arg == kw:
            return k.value
    return node.args[pos] if len(node.args) > pos else None


class _Element(ast.AST):
    """Element ``index`` of the tuple ``call`` returns (``a, b = f(x)``)."""

    def __init__(self, call: ast.Call, index: int):
        super().__init__()
        self.call, self.index = call, index


def _local_assignments(scope: ast.AST) -> Dict[str, List[ast.AST]]:
    """name -> every value assigned to it in ``scope`` (tuple targets
    element by element)."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(scope):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.setdefault(t.id, []).append(node.value)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for i, el in enumerate(t.elts):
                    if not isinstance(el, ast.Name):
                        continue
                    if isinstance(node.value, (ast.Tuple, ast.List)) and len(
                        node.value.elts
                    ) == len(t.elts):
                        out.setdefault(el.id, []).append(node.value.elts[i])
                    elif isinstance(node.value, ast.Call):
                        out.setdefault(el.id, []).append(_Element(node.value, i))
                    else:
                        out.setdefault(el.id, []).append(node.value)
    return out


def _site_ok(expr: ast.AST, params) -> bool:
    """A string literal; inside the mesh module, a site parameter passed
    through (and a literal suffix on it)."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str)
    if isinstance(expr, ast.Name):
        return expr.id in params
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        return expr.value.id in params
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _site_ok(expr.left, params) and _site_ok(expr.right, params)
    return False


class MeshAxesChecker:
    rule = "mesh-axes"

    # -- declared axes --------------------------------------------------------

    def _declared_axes(self, package: Package) -> Set[str]:
        declared: Set[str] = set()
        for module in package.modules:
            for node in ast.walk(module.tree):
                # config-field / local defaults: data_axis: str = "data"
                if isinstance(node, ast.AnnAssign):
                    target, value = node.target, node.value
                    if (
                        isinstance(target, ast.Name)
                        and target.id.endswith("_axis")
                        and isinstance(value, ast.Constant)
                        and isinstance(value.value, str)
                    ):
                        declared.add(value.value)
                elif isinstance(node, ast.Assign):
                    if isinstance(node.value, ast.Constant) and isinstance(
                        node.value.value, str
                    ):
                        for t in node.targets:
                            if isinstance(t, ast.Name) and t.id.endswith(
                                "_axis"
                            ):
                                declared.add(node.value.value)
                elif isinstance(node, ast.Call):
                    # Mesh(devices, ("data", "model")) / axis_names=(...)
                    resolved = module.resolve_alias(call_name(node))
                    if resolved.rsplit(".", 1)[-1] != "Mesh":
                        continue
                    names_arg: Optional[ast.AST] = None
                    if len(node.args) > 1:
                        names_arg = node.args[1]
                    for kw in node.keywords:
                        if kw.arg == "axis_names":
                            names_arg = kw.value
                    if isinstance(names_arg, (ast.Tuple, ast.List)):
                        for el in names_arg.elts:
                            if isinstance(el, ast.Constant) and isinstance(
                                el.value, str
                            ):
                                declared.add(el.value)
                    elif isinstance(names_arg, ast.Constant) and isinstance(
                        names_arg.value, str
                    ):
                        declared.add(names_arg.value)
        return declared

    # -- checker entry --------------------------------------------------------

    def check(self, package: Package) -> List[Finding]:
        global _SPEC_TAILS, _COLLECTIVES
        _SPEC_TAILS = package.profile.spec_call_tails
        _COLLECTIVES = package.profile.mesh_collectives
        declared = self._declared_axes(package)
        out: List[Finding] = []

        # innermost functions first (the collector appends outer defs before
        # the defs nested in them), module pseudo-scopes last: a spec inside
        # a nested def is attributed to the nearest enclosing def, and the
        # per-node marker keeps the wider walks from re-reporting it
        scopes: List[FunctionInfo] = list(reversed(package.functions))
        for module in package.modules:
            scopes.append(
                FunctionInfo(
                    module=module, node=module.tree, qualname="<module>",
                    class_name=None,
                )
            )

        # ---- sub-rule 1: literal axis names resolve to declared axes ----
        seen: Set[int] = set()  # wider scopes re-walk nested functions
        for fn in scopes:
            local_lits = _literal_assignments(fn.node)
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if id(node) in seen:
                    continue
                if _is_partition_spec(fn.module, node):
                    seen.add(id(node))
                    for arg in node.args:
                        elts = (
                            arg.elts
                            if isinstance(arg, (ast.Tuple, ast.List))
                            else [arg]
                        )
                        for el in elts:
                            lit: Optional[str] = None
                            where = el
                            if isinstance(el, ast.Constant) and isinstance(
                                el.value, str
                            ):
                                lit = el.value
                            elif isinstance(el, ast.Name):
                                lit = local_lits.get(el.id)
                            if lit is not None and lit not in declared:
                                out.append(self._finding(
                                    fn, where,
                                    f"PartitionSpec axis '{lit}' is not a "
                                    f"declared mesh axis "
                                    f"(declared: {self._fmt(declared)})",
                                ))
                else:
                    for kw in node.keywords:
                        if kw.arg != "axis_name":
                            continue
                        if isinstance(kw.value, ast.Constant) and isinstance(
                            kw.value.value, str
                        ) and kw.value.value not in declared:
                            seen.add(id(node))
                            out.append(self._finding(
                                fn, kw.value,
                                f"axis_name '{kw.value.value}' is not a "
                                f"declared mesh axis "
                                f"(declared: {self._fmt(declared)})",
                            ))

        # ---- sub-rule 2: collective binding ----
        out.extend(self._check_collectives(package, declared))
        if package.profile.mesh_module is not None:
            out.extend(self._check_wrappers(package))
        return out

    # -- the port's half: torch.distributed through the counted wrappers ------

    def _check_wrappers(self, package: Package) -> List[Finding]:
        """No ``torch.distributed`` collective outside the mesh module;
        every counted wrapper's group a MeshContext data or model group;
        every wrapper's site a string literal."""
        p = package.profile
        self._package = package
        wrappers = {name: (g, s) for name, g, s in p.mesh_wrappers}
        home = p.mesh_module
        out: List[Finding] = []
        class_assigns = self._self_assignments(package)
        for fn in package.functions:
            module = fn.module
            in_home = module.relname == home
            params = set(fn.params)
            local = _local_assignments(fn.node)
            for node in stmt_walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if not name:
                    continue
                resolved = module.resolve_alias(name)
                head, _, tail = resolved.rpartition(".")
                if head == p.mesh_dist_head and tail in p.mesh_dist_collectives:
                    if not in_home:
                        out.append(self._finding(
                            fn, node,
                            f"collective {resolved}() outside {home.replace('.', '/')}.py "
                            "— it is neither counted in COLLECTIVES nor fenced by "
                            "the mesh's fault handling (a lost peer must break the "
                            "mesh); call a counted wrapper there",
                        ))
                    continue
                wrapper = None
                if in_home and "." not in name and name in wrappers:
                    wrapper = name
                elif tail in wrappers and head.endswith(home) and head.startswith(
                    module.name.split(".")[0]
                ):
                    wrapper = tail
                if wrapper is None:
                    continue
                g_pos, s_pos = wrappers[wrapper]
                group = _arg(node, g_pos, "group")
                site = _arg(node, s_pos, "site")
                if group is not None and not self._group_ok(
                    group, fn, params, local, class_assigns, p, depth=0
                ):
                    out.append(self._finding(
                        fn, node,
                        f"{wrapper}() over group '{expr_text(group)}', which does "
                        "not resolve to a MeshContext data or model group — a "
                        "collective over another group is outside the mesh's "
                        "axes and its budget",
                    ))
                if site is not None and not _site_ok(site, params if in_home else ()):
                    out.append(self._finding(
                        fn, node,
                        f"{wrapper}() site '{expr_text(site)}' is not a string "
                        "literal — the COLLECTIVES key it counts under must be "
                        "stable for the shard budget",
                    ))
        return out

    @staticmethod
    def _self_assignments(package: Package) -> Dict[Tuple[str, str, str], List[ast.AST]]:
        """(module, class, attr) -> every value assigned to ``self.<attr>``."""
        out: Dict[Tuple[str, str, str], List[ast.AST]] = {}
        for fn in package.functions:
            if fn.class_name is None:
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        key = (fn.module.relpath, fn.class_name, t.attr)
                        out.setdefault(key, []).append(node.value)
        return out

    def _group_ok(self, expr, fn, params, local, class_assigns, p, depth) -> bool:
        if depth > 4:
            return False

        def ok(e, owner=None):
            owner = owner or fn
            if owner is fn:
                return self._group_ok(e, fn, params, local, class_assigns, p,
                                      depth + 1)
            return self._group_ok(e, owner, set(owner.params),
                                  _local_assignments(owner.node), class_assigns,
                                  p, depth + 1)

        if isinstance(expr, ast.Constant) and expr.value is None:
            return True  # no process group: the wrapper is the identity
        if isinstance(expr, ast.Attribute) and expr.attr in p.mesh_group_attrs:
            return True
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            return bool(name) and name.rsplit(".", 1)[-1] in p.mesh_group_attrs
        if isinstance(expr, ast.IfExp):
            return ok(expr.body) and ok(expr.orelse)
        if isinstance(expr, _Element):
            # one element of a tuple a package function returns
            callee = self._package.resolve_call(fn, expr.call)
            if callee is None:
                return False
            rets = [
                n.value for n in ast.walk(callee.node)
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Tuple)
                and len(n.value.elts) > expr.index
            ]
            return bool(rets) and all(ok(r.elts[expr.index], callee) for r in rets)
        if isinstance(expr, ast.Name):
            if expr.id in local:
                return all(ok(v) for v in local[expr.id])
            if expr.id in params:
                # a parameter: the caller's group, checked at its call
                return True
            # a closure: the enclosing function's binding
            outer_q, sep, _ = fn.qualname.rpartition(".<locals>.")
            if sep:
                for cand in self._package.functions:
                    if cand.module is fn.module and cand.qualname == outer_q:
                        return ok(expr, cand)
            return False
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base == "self" and fn.class_name is not None:
                values = class_assigns.get(
                    (fn.module.relpath, fn.class_name, expr.attr), [])
                return bool(values) and all(ok(v) for v in values)
            # a carrier the caller filled (the autograd ctx)
            return base in params
        return False
        if isinstance(expr, ast.Constant) and expr.value is None:
            return True  # no process group: the wrapper is the identity
        if isinstance(expr, ast.Attribute) and expr.attr in p.mesh_group_attrs:
            return True
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            return bool(name) and name.rsplit(".", 1)[-1] in p.mesh_group_attrs
        if isinstance(expr, ast.IfExp):
            return all(
                self._group_ok(e, fn, params, local, class_assigns, p, depth + 1)
                for e in (expr.body, expr.orelse)
            )
        if isinstance(expr, ast.Name):
            if expr.id in local:
                return all(
                    self._group_ok(v, fn, params, local, class_assigns, p, depth + 1)
                    for v in local[expr.id]
                )
            # a parameter: the caller's group, checked at the caller
            return expr.id in params
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base == "self" and fn.class_name is not None:
                values = class_assigns.get(
                    (fn.module.relpath, fn.class_name, expr.attr), [])
                return bool(values) and all(
                    self._group_ok(v, fn, params, local, class_assigns, p, depth + 1)
                    for v in values
                )
            # a carrier the caller filled (the autograd ctx)
            return base in params
        return False

    # -- collective binding ---------------------------------------------------

    def _check_collectives(
        self, package: Package, declared: Set[str]
    ) -> List[Finding]:
        out: List[Finding] = []
        visited: Set[Tuple[int, Tuple[Tuple[str, str], ...]]] = set()
        # every Call node scanned under some shard_map body walk: the
        # "outside shard_map" pass below flags collectives NOT in this set
        scanned: Set[int] = set()
        # (body owner fn, body node, param->token env, bound tokens,
        #  lexically-enclosing scope for closure/alias lookups)
        frontier: List[
            Tuple[FunctionInfo, ast.AST, Dict[str, str], Set[str],
                  FunctionInfo]
        ] = []

        scopes: List[FunctionInfo] = list(reversed(package.functions))
        for module in package.modules:
            scopes.append(
                FunctionInfo(
                    module=module, node=module.tree, qualname="<module>",
                    class_name=None,
                )
            )

        sm_seen: Set[int] = set()
        for fn in scopes:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call) or id(node) in sm_seen:
                    continue
                sm_seen.add(id(node))
                resolved = fn.module.resolve_alias(call_name(node))
                if resolved.rsplit(".", 1)[-1] != "shard_map":
                    continue
                if not node.args:
                    continue
                bound = self._bound_tokens(fn, node)
                target, env = self._resolve_body(
                    package, fn, node.args[0], {}
                )
                if target is None:
                    continue
                body_fn, body_node = target
                frontier.append((body_fn, body_node, env, bound, fn))

        while frontier:
            fn, body, env, bound, home = frontier.pop()
            key = (id(body), tuple(sorted(env.items())))
            if key in visited:
                continue
            visited.add(key)
            # closure reads resolve in the lexically-enclosing scope: a
            # nested body's axis names ARE the enclosing function's locals
            local_lits = _literal_assignments(home.node)
            local_lits.update(_literal_assignments(body))
            bound_lits = {
                t[len(_LIT):] for t in bound if t.startswith(_LIT)
            }
            for node in ast.walk(body):
                if not isinstance(node, ast.Call):
                    continue
                scanned.add(id(node))
                tail = _is_collective(fn.module, node)
                if tail is not None:
                    token = self._token(
                        _axis_expr(tail, node), env, local_lits
                    )
                    if token is None:
                        continue
                    if token.startswith(_LIT):
                        lit = token[len(_LIT):]
                        if bound_lits and lit not in bound_lits:
                            out.append(self._finding(
                                fn, node,
                                f"collective {tail}() over axis '{lit}' not "
                                f"bound by the enclosing shard_map "
                                f"(binds: {self._fmt(bound_lits)})",
                            ))
                        elif lit not in declared:
                            out.append(self._finding(
                                fn, node,
                                f"collective {tail}() over axis '{lit}', "
                                f"not a declared mesh axis "
                                f"(declared: {self._fmt(declared)})",
                            ))
                    # non-literal tokens: ok when they textually match a
                    # bound token; unprovable otherwise -> silent
                    continue
                # follow package calls with a rebuilt parameter env
                callee_env: Dict[str, str] = {}
                callee = self._resolve_call_env(
                    package, fn, node, env, local_lits, callee_env, home
                )
                if callee is not None:
                    frontier.append(
                        (callee, callee.node, callee_env, bound, callee)
                    )

        # ---- collectives never reached from any shard_map body ----
        checked: Set[int] = set()
        for fn in scopes:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call) or id(node) in checked:
                    continue
                tail = _is_collective(fn.module, node)
                if tail is None:
                    continue
                checked.add(id(node))
                if id(node) in scanned:
                    continue
                out.append(self._finding(
                    fn, node,
                    f"collective {tail}() outside any shard_map body "
                    f"(collectives need a bound mesh axis)",
                ))
        return out

    # -- token / body resolution ----------------------------------------------

    def _token(
        self,
        expr: Optional[ast.AST],
        env: Dict[str, str],
        local_lits: Dict[str, str],
    ) -> Optional[str]:
        if expr is None:
            return None
        if isinstance(expr, ast.Constant):
            return (
                _LIT + expr.value if isinstance(expr.value, str) else None
            )
        if isinstance(expr, ast.Name):
            if expr.id in env:
                return env[expr.id]
            if expr.id in local_lits:
                return _LIT + local_lits[expr.id]
            return expr.id
        text = expr_text(expr)
        return text or None

    def _bound_tokens(self, fn: FunctionInfo, call: ast.Call) -> Set[str]:
        """Axis tokens THIS shard_map site binds: the PartitionSpec
        arguments of its own ``in_specs``/``out_specs`` (chased through
        local Name assignments and ``specs.append(...)`` list building —
        the ``in_specs = [seq_spec, ...]`` idiom), plus an explicit
        ``axis_name=`` keyword.  Per-site, so two shard_maps in one
        function check their bodies against their OWN axes, not the
        union.  Falls back to every spec in the enclosing function only
        when the site's spec expressions resolve to nothing (specs built
        by a helper)."""
        bound: Set[str] = set()
        local_lits = _literal_assignments(fn.node)

        def add_spec_call(node: ast.Call) -> None:
            for arg in node.args:
                elts = (
                    arg.elts
                    if isinstance(arg, (ast.Tuple, ast.List))
                    else [arg]
                )
                for el in elts:
                    if isinstance(el, ast.Constant):
                        if isinstance(el.value, str):
                            bound.add(_LIT + el.value)
                    elif isinstance(el, ast.Name):
                        if el.id in local_lits:
                            bound.add(_LIT + local_lits[el.id])
                        bound.add(el.id)
                    else:
                        text = expr_text(el)
                        if text:
                            bound.add(text)

        def collect(expr: ast.AST, depth: int) -> None:
            """P-calls in ``expr``, chasing Names through assignments and
            list ``.append``/``.extend`` mutations in ``fn``."""
            if depth > 4:
                return
            names: List[str] = []
            for node in ast.walk(expr):
                if isinstance(node, ast.Call) and _is_partition_spec(
                    fn.module, node
                ):
                    add_spec_call(node)
                elif isinstance(node, ast.Name):
                    names.append(node.id)
            for name in names:
                for node in ast.walk(fn.node):
                    if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == name
                        for t in node.targets
                    ):
                        if node.value is not expr:
                            collect(node.value, depth + 1)
                    elif (
                        isinstance(node, ast.Call)
                        and call_name(node)
                        in (f"{name}.append", f"{name}.extend")
                        and node.args
                    ):
                        collect(node.args[0], depth + 1)

        spec_exprs: List[ast.AST] = list(call.args[1:])
        for kw in call.keywords:
            if kw.arg in ("in_specs", "out_specs"):
                spec_exprs.append(kw.value)
            elif kw.arg == "axis_name":
                if isinstance(kw.value, ast.Constant) and isinstance(
                    kw.value.value, str
                ):
                    bound.add(_LIT + kw.value.value)
                else:
                    text = expr_text(kw.value)
                    if text:
                        bound.add(text)
        for expr in spec_exprs:
            collect(expr, 0)
        if not bound:
            # specs came from a helper: the whole-function walk is the
            # best (over-)approximation left
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call) and _is_partition_spec(
                    fn.module, node
                ):
                    add_spec_call(node)
        return bound

    def _resolve_body(
        self,
        package: Package,
        fn: FunctionInfo,
        target: ast.AST,
        prebound: Dict[str, str],
        depth: int = 0,
    ) -> Tuple[Optional[Tuple[FunctionInfo, ast.AST]], Dict[str, str]]:
        """Resolve a shard_map body expression to (FunctionInfo, body node)
        plus the axis-token env its params were pre-bound with (through
        ``functools.partial``/alias chains)."""
        if depth > 6:
            return None, {}
        if isinstance(target, ast.Lambda):
            lam_fn = FunctionInfo(
                module=fn.module,
                node=target,
                qualname=f"{fn.qualname}.<lambda>",
                class_name=fn.class_name,
            )
            return (lam_fn, target), dict(prebound)
        if isinstance(target, ast.Call):
            name = call_name(target)
            tail = name.rsplit(".", 1)[-1]
            if tail == "partial" and target.args:
                env = dict(prebound)
                lits = _literal_assignments(fn.node)
                for kw in target.keywords:
                    tok = self._token(kw.value, {}, lits)
                    if kw.arg and tok:
                        env[kw.arg] = tok
                return self._resolve_body(
                    package, fn, target.args[0], env, depth + 1
                )
            if tail in ("jit", "pjit", "shard_map") and target.args:
                return self._resolve_body(
                    package, fn, target.args[0], prebound, depth + 1
                )
            return None, {}
        if isinstance(target, (ast.Name, ast.Attribute)):
            fake = ast.Call(func=target, args=[], keywords=[])
            ast.copy_location(fake, target)
            resolved = package.resolve_call(fn, fake)
            if resolved is not None:
                env = {}
                params = resolved.params
                # positional prebinds from partial(...) args are rare for
                # bodies; keyword prebinds map by name
                for p in params:
                    if p in prebound:
                        env[p] = prebound[p]
                return (resolved, resolved.node), env
            if isinstance(target, ast.Name):
                # alias chain: wrapped = kernel / kernel = partial(f, ...)
                for node in ast.walk(fn.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    if not any(
                        isinstance(t, ast.Name) and t.id == target.id
                        for t in node.targets
                    ):
                        continue
                    if node.value is target:
                        continue
                    return self._resolve_body(
                        package, fn, node.value, prebound, depth + 1
                    )
        return None, {}

    def _resolve_call_env(
        self,
        package: Package,
        fn: FunctionInfo,
        node: ast.Call,
        env: Dict[str, str],
        local_lits: Dict[str, str],
        callee_env: Dict[str, str],
        home: FunctionInfo,
    ) -> Optional[FunctionInfo]:
        """Resolve a call inside a shard_map body and populate the callee's
        param->token env from the call's arguments (and any partial-alias
        prebinding on the way).  ``home`` is the lexically-enclosing scope:
        ``fn = functools.partial(helper, axis_name=ax)`` aliases live
        there, not in the nested body."""
        prebound: Dict[str, str] = {}
        callee = package.resolve_call(fn, node)
        if callee is None:
            name = call_name(node)
            if name and "." not in name:
                resolved = self._resolve_body(
                    package, home, node.func, {},
                )
                if resolved[0] is not None and not isinstance(
                    resolved[0][1], ast.Lambda
                ):
                    callee = resolved[0][0]
                    prebound = resolved[1]
        if callee is None:
            return None
        params = callee.params
        if callee.class_name is not None and params[:1] == ["self"]:
            params = params[1:]
        for p, tok in prebound.items():
            callee_env[p] = tok
        for i, arg in enumerate(node.args):
            # positional args fill params not pre-bound by partial kwargs
            free = [p for p in params if p not in prebound]
            if i < len(free):
                tok = self._token(arg, env, local_lits)
                if tok:
                    callee_env[free[i]] = tok
        for kw in node.keywords:
            if kw.arg and kw.arg in params:
                tok = self._token(kw.value, env, local_lits)
                if tok:
                    callee_env[kw.arg] = tok
        return callee

    # -- plumbing -------------------------------------------------------------

    @staticmethod
    def _fmt(names: Set[str]) -> str:
        return ", ".join(sorted(names)) if names else "none"

    def _finding(self, fn: FunctionInfo, node: ast.AST, msg: str) -> Finding:
        return Finding(
            self.rule,
            fn.module.relpath,
            getattr(node, "lineno", 1),
            fn.qualname,
            msg,
        )
