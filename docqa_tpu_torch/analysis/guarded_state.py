"""guarded-state: a field guarded by a lock anywhere is guarded everywhere.

Counterpart of ``docqa_tpu/analysis/guarded_state.py``.  Data races of the
serving plane (a drain judging quiescence from fields the worker mutates
outside the cv, hedge bookkeeping popped under no lock while a waiter
reads it, a rolling-restart teardown racing a monitor tick over replica
state) are found by stress, not by lint, unless a rule reasons about
*which lock guards which state*.  This rule infers each module's guard
discipline and holds every access to it:

* **guard inference** — a field (``self.X`` or ``obj.X``) *written*
  under ``with <lock>`` in any non-``__init__`` method establishes the
  fact "X is guarded by that lock".  Facts are keyed by attribute name
  per MODULE (no type system: ``r.state`` written under
  ``EnginePool._lock`` and read as ``self.state`` in ``_Replica`` is the
  same field, and one module is the blast radius worth flagging);
* **unguarded write** — any other write to X outside the guard flags;
* **unguarded read** — any read of X outside the guard flags (one
  finding per function, not per site — the fix is the same lock either
  way).  Reads/writes in ``__init__`` are construction (happens-before
  publication) and exempt;
* **mixed-lock access** — X written under lock A here and lock B there
  is a field with two owners, i.e. no owner;
* **published reference** — ``return self.X`` of a guarded MUTABLE
  container (assigned a list/dict/set/deque literal or constructor in
  ``__init__``) hands callers a reference they will mutate or iterate
  outside the guard; return a copy taken under the lock instead.

A helper whose every package-resolvable call site sits under the guard
(``serve._pop_free_slots`` — "caller holds self._cv") is analyzed as
holding it.  Locks aliased through ``Condition(self._lock)`` count as
one guard.  Intentional lock-free access (GIL-atomic scalar reads on
operator surfaces, single-reference publishes) belongs in the baseline
with a written justification — that is the point: the exceptions become
enumerable instead of tribal.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.concurrency import (
    canonical,
    discover_locks,
    direct_with_locks,
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
)

def _access_root(node: ast.Attribute) -> Optional[str]:
    """'self' / a bare receiver name for one-hop attribute access."""
    if isinstance(node.value, ast.Name):
        return node.value.id
    return None


class GuardedStateChecker:
    rule = "guarded-state"

    def check(self, package: Package) -> List[Finding]:
        decls = discover_locks(package)
        aliases = lock_aliases(decls, package)
        known_attrs = known_lock_attrs(decls)
        call_site_held = held_at_call_sites(package, known_attrs)
        out: List[Finding] = []

        # per-module pass: facts do not cross files
        by_module: Dict[object, List[FunctionInfo]] = {}
        for fn in package.functions:
            by_module.setdefault(fn.module, []).append(fn)

        for module, fns in by_module.items():
            out.extend(
                self._check_module(
                    module, fns, known_attrs, aliases, call_site_held
                )
            )
        return out

    # -- per module -----------------------------------------------------------

    # receiver methods that MUTATE the container they're called on — a
    # `self._queue.append(req)` under the lock is a guarded write even
    # though the attribute itself is never rebound
    MUTATING_METHODS = frozenset(
        {
            "append", "appendleft", "pop", "popleft", "popitem", "clear",
            "add", "remove", "discard", "update", "extend", "insert",
            "setdefault", "sort",
        }
    )

    def _accesses(
        self,
        fn: FunctionInfo,
        known_attrs: Set[str],
        aliases: Dict[str, str],
        base_held: Set[str],
    ):
        """Yield (root, attr, is_write, held_locks, lineno) for every
        one-hop attribute access in ``fn`` (nested defs excluded — they
        are separate functions with their own call sites).  Writes =
        Store/Del contexts, subscript stores (``self.x[k] = v``), and
        mutating method calls (``self.x.append(v)``)."""
        results: List[Tuple[str, str, bool, Set[str], int]] = []

        # attribute nodes that are written THROUGH (not rebound): the
        # receiver of a mutating method call or of a subscript store
        written_through: Set[int] = set()
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                recv = node.func.value
                if (
                    node.func.attr in self.MUTATING_METHODS
                    and isinstance(recv, ast.Attribute)
                ):
                    written_through.add(id(recv))
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                if isinstance(node.value, ast.Attribute):
                    written_through.add(id(node.value))

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                ):
                    continue
                new_held = held
                if isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        if isinstance(item.context_expr, ast.Call):
                            continue
                        try:
                            text = ast.unparse(item.context_expr)
                        except Exception:
                            continue
                        if is_lock_expr(text, known_attrs):
                            new_held = new_held + (
                                canonical(
                                    lock_id_for(fn, text), aliases
                                ),
                            )
                if isinstance(child, ast.Attribute):
                    root = _access_root(child)
                    if root is not None and child.attr not in known_attrs:
                        is_write = (
                            isinstance(child.ctx, (ast.Store, ast.Del))
                            or id(child) in written_through
                        )
                        results.append(
                            (
                                root,
                                child.attr,
                                is_write,
                                set(new_held) | base_held,
                                child.lineno,
                            )
                        )
                # augmented assignment targets parse as Store only at the
                # target; `self.x += 1` is BOTH a read and a write — the
                # Attribute appears once with Store ctx, which is the
                # stricter of the two, so nothing extra to do
                visit(child, new_held)

        visit(fn.node, ())
        return results

    def _check_module(
        self,
        module,
        fns: List[FunctionInfo],
        known_attrs: Set[str],
        aliases: Dict[str, str],
        call_site_held: Dict[int, Set[str]],
    ) -> List[Finding]:
        # guard facts, two strengths:
        # * class facts — SELF-writes under a lock, keyed (class, attr):
        #   a class's own discipline binds its own accesses only (two
        #   classes each caching a `_fns` under their own lock are not
        #   each other's business);
        # * bridge facts — writes through a NON-self receiver (`r.state`
        #   under the pool lock), keyed attr module-wide, kept only when
        #   some class in the module touches the attr via `self` — the
        #   cross-object pattern (owner class + managing class) the
        #   per-class view cannot see.  Without the self-partner filter,
        #   every `req.error = …` in a locked helper would claim guard
        #   facts over a dataclass whose real ordering contract is the
        #   done-Event, not a lock.
        # each group: list of (held-lock frozenset, line, qualname), one
        # per guarded write site.  The group's GUARD set is the
        # intersection across sites — a write under {A, B} and a write
        # under {A} are consistently guarded by A (flag_window holds the
        # caller's lock AND its own; the recorder lock is the guard),
        # while disjoint sets mean mixed-lock access.
        class_guards: Dict[
            Tuple[Optional[str], str], List[Tuple[frozenset, int, str]]
        ] = {}
        bridge_guards: Dict[str, List[Tuple[frozenset, int, str]]] = {}
        self_touched: Set[str] = set()  # attrs with a self access
        # attr -> was assigned a mutable container in __init__
        mutable_init: Set[str] = set()
        # collected accesses: (fn, root, attr, is_write, held, lineno)
        accesses: List[
            Tuple[FunctionInfo, str, str, bool, Set[str], int]
        ] = []

        for fn in fns:
            base_held = {
                canonical(lid, aliases)
                for lid in call_site_held.get(id(fn.node), set())
            }
            acc = self._accesses(fn, known_attrs, aliases, base_held)
            if fn.name == "__init__":
                # mutable-container detection needs the assigned VALUE
                for node in ast.walk(fn.node):
                    if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                        continue
                    value = getattr(node, "value", None)
                    if value is None:
                        continue
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    mutable = isinstance(
                        value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                ast.DictComp)
                    )
                    if isinstance(value, ast.Call):
                        tail = ast.unparse(value.func).rsplit(".", 1)[-1]
                        mutable = mutable or tail in (
                            "list", "dict", "set", "deque", "OrderedDict",
                            "defaultdict",
                        )
                    if not mutable:
                        continue
                    for t in targets:
                        if isinstance(t, ast.Attribute) and _access_root(t):
                            mutable_init.add(t.attr)
                continue  # __init__ accesses are construction — exempt
            for root, attr, is_write, held, line in acc:
                accesses.append((fn, root, attr, is_write, held, line))
                if root == "self":
                    self_touched.add(attr)
                if is_write and held:
                    slot = (
                        class_guards.setdefault(
                            (fn.class_name, attr), []
                        )
                        if root == "self"
                        else bridge_guards.setdefault(attr, [])
                    )
                    slot.append((frozenset(held), line, fn.qualname))

        # bridge facts need a self-side partner (see above)
        bridge_guards = {
            attr: sites
            for attr, sites in bridge_guards.items()
            if attr in self_touched
        }

        def guard_set(
            sites: List[Tuple[frozenset, int, str]]
        ) -> Set[str]:
            return set(frozenset.intersection(*[s for s, _l, _q in sites]))

        def facts_for(fn: FunctionInfo, root: str, attr: str) -> Set[str]:
            """Union of the guard sets that bind this access."""
            guards: Set[str] = set()
            if root == "self":
                for sites in (
                    class_guards.get((fn.class_name, attr)),
                    bridge_guards.get(attr),
                ):
                    if sites:
                        guards |= guard_set(sites)
                return guards
            for (_cls, a), sites in class_guards.items():
                if a == attr:
                    guards |= guard_set(sites)
            if attr in bridge_guards:
                guards |= guard_set(bridge_guards[attr])
            return guards

        out: List[Finding] = []
        # mixed-lock writes: a fact group whose write sites share NO lock
        seen_mixed: Set[str] = set()
        groups = list(class_guards.items()) + [
            ((None, attr), sites) for attr, sites in bridge_guards.items()
        ]
        for (_cls, attr), sites in sorted(
            groups, key=lambda kv: (kv[0][1], str(kv[0][0]))
        ):
            if len(sites) > 1 and not guard_set(sites) and (
                attr not in seen_mixed
            ):
                seen_mixed.add(attr)
                ordered = sorted(sites, key=lambda s: s[1])
                (h1, line1, q1) = ordered[0]
                other = next(
                    (s for s in ordered if not (s[0] & h1)), ordered[1]
                )
                out.append(
                    Finding(
                        self.rule,
                        module.relpath,
                        line1,
                        q1,
                        f"field '{attr}' is written under "
                        f"{sorted(h1)[0]} here but under "
                        f"{sorted(other[0])[0]} in {other[2]} (mixed-lock "
                        "access: a field with two guards has none)",
                    )
                )

        # unguarded access to guarded fields: one finding per (attr, fn)
        reported: Set[Tuple[str, str, bool]] = set()
        for fn, root, attr, is_write, held, line in accesses:
            if fn.name.endswith("_locked"):
                # the codebase's caller-holds-the-lock convention: the
                # suffix IS the annotation (call-site inference already
                # proves most of these; the suffix covers mixed callers)
                continue
            guards = facts_for(fn, root, attr)
            if not guards:
                continue
            if guards & held:
                continue
            key = (attr, fn.qualname, is_write)
            if key in reported:
                continue
            reported.add(key)
            guard = sorted(guards)[0]
            verb = "written" if is_write else "read"
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    line,
                    fn.qualname,
                    f"field '{attr}' is guarded by {guard} but {verb} "
                    "without it here",
                )
            )

        # published references: `return self.X` of a guarded mutable field
        for fn in fns:
            if fn.name == "__init__":
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                v = node.value
                if (
                    isinstance(v, ast.Attribute)
                    and _access_root(v) == "self"
                    and facts_for(fn, "self", v.attr)
                    and v.attr in mutable_init
                ):
                    out.append(
                        Finding(
                            self.rule,
                            module.relpath,
                            node.lineno,
                            fn.qualname,
                            f"guarded mutable field '{v.attr}' published "
                            "by reference (callers mutate/iterate it "
                            "outside the guard) — return a copy taken "
                            "under the lock",
                        )
                    )
        return out
