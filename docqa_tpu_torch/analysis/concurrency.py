"""Shared concurrency model for the racecheck rule family.

Counterpart of ``docqa_tpu/analysis/concurrency.py``.  Everything the
thread-safety checkers (``guarded-state``, ``thread-lifecycle``,
``cv-protocol``, ``lock-discipline``) and the dynamic witness
(``analysis/race_witness.py``) agree on lives here, so the static and
dynamic views can be cross-checked without naming drift:

* **lock discovery** — every ``threading.Lock/RLock/Condition`` (and
  ``multiprocessing.Lock``) assignment, with its *creation site*
  ``(abs_path, lineno)`` so the runtime witness can map a live primitive
  back to the same ``Class.attr`` identity the static graph uses;
* **condition→lock aliases** — ``self._cv = threading.Condition(
  self._lock)`` makes the two names ONE lock; both the static
  acquisition graph and the witnessed graph canonicalize through
  :func:`canonical`, or an edge between the aliases would read as an
  ordering fact about two locks that cannot deadlock against each other;
* **held-at-call-sites inference** — a helper whose every
  package-resolvable call site sits under lock L is treated as running
  with L held (the "caller holds ``self._cv``" contract of
  ``serve._pop_free_slots``), so guarded-state and cv-protocol don't flag
  the helper body for the caller's discipline;
* **dispatch reachability** — can a function's transitive package call
  graph reach device work?  On the port that is a call through one of the
  profile's import heads (``torch.*``), a kernel wrapper's launch funnel
  (``ops/_kernels.py``'s ``build`` / ``load`` / ``count``), a
  ``spine_run`` / ``spine_submit`` onto a spine lane, a ``warmup``, or a
  constructor whose ``__init__`` allocates on the device.  Thread-lifecycle
  names the threads whose unjoined device work outlives their owner;
* **thread-entry enumeration** — ``threading.Thread(target=…)``,
  ``executor.submit(…)``, ``loop.run_in_executor(pool, …)`` and
  ``obs.call_in(ctx, fn, …)`` sites, with their resolved targets where
  resolution is possible (``self.method``, bare names, ``partial``);
* **full cycle detection** — iterative DFS over an acquisition-order
  graph returning every elementary cycle once.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    FunctionInfo,
    Package,
    call_name,
    dotted_name,
)

LOCK_FACTORY_RE = re.compile(
    r"threading\.(?:Lock|RLock|Condition)\b|multiprocessing\.Lock\b"
)
LOCKISH_ATTR_RE = re.compile(r"(?:^|_)(?:lock|cv|mutex|rlock)$|_lock$|_cv$")
CONDITIONISH_ATTR_RE = re.compile(r"(?:^|_)cv$|_cv$|(?:^|\.)cv$|condition$")
EXECUTORISH_RE = re.compile(r"pool|executor", re.IGNORECASE)

LOCK_FACTORY_TAILS = frozenset({"Lock", "RLock", "Condition"})


def _factory_kind(module, value: ast.AST) -> Optional[str]:
    """'Lock' / 'RLock' / 'Condition' when ``value`` is a direct
    threading-primitive construction (through import aliases), else
    None.  ``field(default_factory=threading.Condition)`` counts too —
    the *declaration* site names the lock even though construction
    happens inside dataclass machinery."""
    if isinstance(value, ast.Call):
        name = module.resolve_alias(call_name(value))
        tail = name.rsplit(".", 1)[-1]
        head = name.split(".")[0]
        if tail in LOCK_FACTORY_TAILS and head in (
            "threading", "multiprocessing"
        ):
            return tail
        if tail == "field":
            for kw in value.keywords:
                if kw.arg == "default_factory":
                    inner = module.resolve_alias(dotted_name(kw.value))
                    t = inner.rsplit(".", 1)[-1]
                    if t in LOCK_FACTORY_TAILS and inner.split(".")[0] in (
                        "threading", "multiprocessing"
                    ):
                        return t
    return None


@dataclasses.dataclass
class LockDecl:
    """One discovered lock declaration."""

    lock_id: str  # "Class.attr" / module-level name — the graph node id
    kind: str  # Lock | RLock | Condition
    module_relpath: str
    module_abspath: str
    lineno: int  # the factory call's line (witness creation-site key)
    alias_of: Optional[str] = None  # Condition(self._lock) -> "Class._lock"


def _owner_class(package: Package, module, node: ast.AST) -> Optional[str]:
    """Class whose method (usually ``__init__``) contains ``node``."""
    for fn in package.functions:
        if fn.module is not module or fn.class_name is None:
            continue
        lo = getattr(fn.node, "lineno", None)
        hi = getattr(fn.node, "end_lineno", None)
        if lo is not None and hi is not None and lo <= node.lineno <= hi:
            return fn.class_name
    return None


def _memoized(package: Package, key: str, compute):
    """Per-Package memo for the shared fixed points: four checkers run
    over one Package per lint invocation, and lock discovery / call-site
    holding / dispatch reachability are identical across them.  The
    cache lives ON the package object, so it dies with it (no global
    keyed by ``id()`` to go stale)."""
    cache = getattr(package, "_concurrency_memo", None)
    if cache is None:
        cache = {}
        package._concurrency_memo = cache  # type: ignore[attr-defined]
    if key not in cache:
        cache[key] = compute()
    return cache[key]


def discover_lock_attr_names(package: Package) -> Set[str]:
    """Attribute/variable NAMES assigned a threading primitive anywhere
    in the package — the broad, text-matched discovery lock-discipline
    has always used for ``with``-expression classification.  Wider than
    :func:`discover_locks` on purpose: a lock created through a wrapper
    (``X(threading.Lock())``) still names a lock attr here even though
    it has no witness-mappable creation site.  One implementation, one
    regex — lock-discipline and the witness id-map must never drift."""

    def compute() -> Set[str]:
        names: Set[str] = set()
        for module in package.modules:
            for node in ast.walk(module.tree):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                value = getattr(node, "value", None)
                if value is None:
                    continue
                try:
                    text = ast.unparse(value)
                except Exception:
                    continue
                if not LOCK_FACTORY_RE.search(text):
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        names.add(t.attr)
                    elif isinstance(t, ast.Name):
                        names.add(t.id)
        return names

    return _memoized(package, "lock_attr_names", compute)


def discover_locks(package: Package) -> Dict[str, LockDecl]:
    return _memoized(package, "locks", lambda: _discover_locks(package))


def _discover_locks(package: Package) -> Dict[str, LockDecl]:
    """Every lock/cv declaration in the package, keyed by lock id.

    Identity matches ``lock_discipline._lock_id``: ``Class.attr`` for
    ``self.X`` assignments inside a class, the bare target name for
    module-level locks.  Dataclass ``field(default_factory=…)``
    declarations are keyed ``Class.attr`` but carry no usable runtime
    creation site (construction happens inside generated ``__init__``
    code) — the witness leaves those unwrapped by design."""
    out: Dict[str, LockDecl] = {}
    for module in package.modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = getattr(node, "value", None)
            if value is None:
                continue
            kind = _factory_kind(module, value)
            if kind is None:
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Attribute) and isinstance(
                    t.value, ast.Name
                ) and t.value.id == "self":
                    cls = _owner_class(package, module, node)
                    lock_id = f"{cls}.{t.attr}" if cls else t.attr
                elif isinstance(t, ast.Attribute):
                    lock_id = t.attr
                elif isinstance(t, ast.Name):
                    cls = _owner_class(package, module, node)
                    # AnnAssign inside a class body (dataclass field):
                    # the name is an attribute of the class
                    lock_id = f"{cls}.{t.id}" if cls else t.id
                else:
                    continue
                alias_of = None
                if (
                    kind == "Condition"
                    and isinstance(value, ast.Call)
                    and value.args
                ):
                    # Condition(self._lock): the cv IS that lock
                    inner = dotted_name(value.args[0])
                    if inner.startswith("self.") and lock_id.count("."):
                        alias_of = (
                            f"{lock_id.rsplit('.', 1)[0]}."
                            f"{inner.rsplit('.', 1)[-1]}"
                        )
                    elif inner:
                        alias_of = inner
                out.setdefault(
                    lock_id,
                    LockDecl(
                        lock_id=lock_id,
                        kind=kind,
                        module_relpath=module.relpath,
                        module_abspath=module.path,
                        lineno=value.lineno,
                        alias_of=alias_of,
                    ),
                )
    return out


def lock_aliases(
    locks: Dict[str, LockDecl], package: Optional[Package] = None
) -> Dict[str, str]:
    """cv→lock aliases of the declarations, plus the ``package``
    profile's declared lock identities."""
    out = {lid: d.alias_of for lid, d in locks.items() if d.alias_of}
    if package is not None:
        out.update(package.profile.lock_aliases)
    return out


def canonical(lock_id: str, aliases: Dict[str, str]) -> str:
    """Resolve a lock id through the cv→lock alias chain (bounded)."""
    seen = set()
    while lock_id in aliases and lock_id not in seen:
        seen.add(lock_id)
        lock_id = aliases[lock_id]
    return lock_id


def lock_id_for(fn: FunctionInfo, expr_text: str) -> str:
    """The ONE lock-identity convention (static checkers + witness map):
    ``Class.attr`` for ``self.…`` expressions, receiver text otherwise."""
    attr = expr_text.rsplit(".", 1)[-1]
    if expr_text.startswith("self.") and fn.class_name:
        return f"{fn.class_name}.{attr}"
    return expr_text


def is_lock_expr(text: str, known: Set[str]) -> bool:
    if not text:
        return False
    attr = text.rsplit(".", 1)[-1]
    return attr in known or bool(LOCKISH_ATTR_RE.search(attr))


def known_lock_attrs(locks: Dict[str, LockDecl]) -> Set[str]:
    return {lid.rsplit(".", 1)[-1] for lid in locks}


# ---------------------------------------------------------------------------
# held-lock regions
# ---------------------------------------------------------------------------


def direct_with_locks(
    fn: FunctionInfo, known_attrs: Set[str]
) -> Set[str]:
    """Lock ids this function acquires via ``with`` directly (no calls)."""
    out: Set[str] = set()
    stack = list(ast.iter_child_nodes(fn.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    continue
                try:
                    text = ast.unparse(item.context_expr)
                except Exception:
                    continue
                if is_lock_expr(text, known_attrs):
                    out.add(lock_id_for(fn, text))
    return out


def held_at_call_sites(
    package: Package, known_attrs: Set[str]
) -> Dict[int, Set[str]]:
    return _memoized(
        package,
        ("held_at_call_sites", tuple(sorted(known_attrs))),
        lambda: _held_at_call_sites(package, known_attrs),
    )


def _held_at_call_sites(
    package: Package, known_attrs: Set[str]
) -> Dict[int, Set[str]]:
    """fn-node-id -> locks held at EVERY package-resolvable call site of
    that function (∅ when any site is lock-free or no site resolves).

    This is the "caller holds the lock" inference: a helper like
    ``serve._pop_free_slots`` (docstring: caller holds ``_cv``) is only
    ever invoked under the lock, so its body runs guarded even though it
    never acquires anything.  Computed to a FIXED POINT so the
    convention chains: ``_compose_live_locked`` called only from other
    ``*_locked`` helpers inherits the lock their callers hold."""
    # callee-node-id -> [(caller-node-id, directly-held-locks)] per site
    sites: Dict[int, List[Tuple[int, Set[str]]]] = {}

    for fn in package.functions:

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
                                lock_id_for(fn, text),
                            )
                if isinstance(child, ast.Call):
                    callee = package.resolve_call(fn, child)
                    if callee is not None:
                        sites.setdefault(id(callee.node), []).append(
                            (id(fn.node), set(new_held))
                        )
                visit(child, new_held)

        visit(fn.node, ())

    out: Dict[int, Set[str]] = {}
    changed = True
    while changed:
        changed = False
        for node_id, call_list in sites.items():
            effective = [
                held | out.get(caller_id, set())
                for caller_id, held in call_list
            ]
            common = set.intersection(*effective) if effective else set()
            if common and common != out.get(node_id, set()):
                out[node_id] = common
                changed = True
    return out


# ---------------------------------------------------------------------------
# dispatch reachability
# ---------------------------------------------------------------------------


def _is_dispatching_call(package: Package, fn: FunctionInfo, node: ast.Call) -> Optional[str]:
    """A call that enqueues device work, by the package profile: a call
    through one of its import heads (``torch.…`` via import aliases), a
    method name that means device work by convention, or a call resolving
    to one of its launch-funnel functions.  Pure-shape helpers are
    indistinguishable without types — conservative is correct here: the
    question is whether the THREAD can own device work at all."""
    profile = package.profile
    name = call_name(node)
    if not name:
        return None
    if name.rsplit(".", 1)[-1] in profile.dispatch_attrs:
        return f"{name} (device work by convention)"
    module = fn.module
    resolved = module.resolve_alias(name)
    head = resolved.split(".")[0]
    if head in profile.dispatch_heads and "." in resolved:
        return resolved
    if profile.dispatch_calls:
        pkg_root = module.name.split(".")[0]
        rel = resolved.partition(".")[2] if head == pkg_root else ""
        if rel in profile.dispatch_calls:
            return resolved
        callee = package.resolve_call(fn, node)
        if callee is not None and (
            f"{callee.module.relname}.{callee.name}" in profile.dispatch_calls
        ):
            return f"{callee.module.relname}.{callee.name}"
    return None


def dispatch_reachable(package: Package) -> Dict[int, str]:
    return _memoized(
        package, "dispatch_reachable", lambda: _dispatch_reachable(package)
    )


def _dispatch_reachable(package: Package) -> Dict[int, str]:
    """fn-node-id -> first dispatching call (its dotted text) reachable
    from the function through package-resolvable calls.

    Class constructions resolve to ``__init__`` (``ContinuousBatcher(…)``
    from the pool monitor allocates a KV pool on the card — that IS device
    work on the monitor thread)."""
    # class name -> __init__ FunctionInfo
    inits: Dict[str, FunctionInfo] = {}
    for fn in package.functions:
        if fn.name == "__init__" and fn.class_name:
            inits.setdefault(fn.class_name, fn)

    reach: Dict[int, str] = {}
    for fn in package.functions:
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                hit = _is_dispatching_call(package, fn, node)
                if hit is not None:
                    reach[id(fn.node)] = hit
                    break

    def callees(fn: FunctionInfo) -> Iterable[FunctionInfo]:
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            callee = package.resolve_call(fn, node)
            if callee is None:
                name = call_name(node)
                tail = name.rsplit(".", 1)[-1]
                callee = inits.get(tail)
            if callee is not None:
                yield callee

    changed = True
    while changed:
        changed = False
        for fn in package.functions:
            if id(fn.node) in reach:
                continue
            for callee in callees(fn):
                sub = reach.get(id(callee.node))
                if sub is not None:
                    reach[id(fn.node)] = f"via {callee.qualname} ({sub})"
                    changed = True
                    break
    return reach


# ---------------------------------------------------------------------------
# thread entry points
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ThreadEntry:
    """One place the process grows a thread of control."""

    kind: str  # "thread" | "executor" | "call_in"
    module_relpath: str
    lineno: int
    site_qualname: str  # function containing the spawn
    target: Optional[FunctionInfo]  # resolved entry function, or None
    target_text: str  # source text of the target expression
    daemon: bool
    thread_name: str  # name= kwarg when present
    binding: Optional[str]  # "self.X" / local name the Thread lands in

    @property
    def key(self) -> str:
        """Stable ledger key: the resolved target when available (two
        sites spawning the same loop are one stream class), else the
        spawning site."""
        if self.target is not None:
            return (
                f"{self.target.module.relpath}:{self.target.qualname}"
            )
        return f"{self.module_relpath}:{self.site_qualname}"


def resolve_target(
    package: Package, fn: FunctionInfo, target: ast.AST, depth: int = 0
) -> Optional[FunctionInfo]:
    if depth > 4 or target is None:
        return None
    if isinstance(target, ast.Call):
        name = call_name(target)
        if name.rsplit(".", 1)[-1] == "partial" and target.args:
            return resolve_target(package, fn, target.args[0], depth + 1)
        return None
    if isinstance(target, ast.Lambda):
        # scan the lambda body for the one resolvable call
        for node in ast.walk(target.body):
            if isinstance(node, ast.Call):
                resolved = package.resolve_call(fn, node)
                if resolved is not None:
                    return resolved
        return None
    fake = ast.Call(func=target, args=[], keywords=[])
    ast.copy_location(fake, target)
    return package.resolve_call(fn, fake)


def module_scope_fn(module) -> FunctionInfo:
    """Pseudo-FunctionInfo for module-level statements (a script that
    builds its thread list at module scope)."""
    return FunctionInfo(
        module=module, node=module.tree, qualname="<module>",
        class_name=None,
    )


def _module_level_nodes(module) -> Iterable[ast.AST]:
    stack = list(ast.iter_child_nodes(module.tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def enumerate_thread_entries(package: Package) -> List[ThreadEntry]:
    return _memoized(
        package,
        "thread_entries",
        lambda: _enumerate_thread_entries(package),
    )


def _enumerate_thread_entries(package: Package) -> List[ThreadEntry]:
    # keyed by creation site so a spawn inside a nested def is attributed
    # once, to the INNERMOST scope (collector order: outer first, so the
    # nested visit overwrites)
    found: Dict[Tuple[str, int, str], ThreadEntry] = {}

    def record(entry: ThreadEntry) -> None:
        found[(entry.module_relpath, entry.lineno, entry.kind)] = entry

    scopes = [(fn, ast.walk(fn.node)) for fn in package.functions] + [
        (module_scope_fn(m), _module_level_nodes(m))
        for m in package.modules
    ]
    for fn, nodes in scopes:
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            resolved = fn.module.resolve_alias(name)
            tail = name.rsplit(".", 1)[-1]
            if resolved == "threading.Thread" or resolved.endswith(
                "threading.Thread"
            ):
                target = None
                daemon = False
                tname = ""
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
                    elif kw.arg == "daemon":
                        daemon = bool(
                            isinstance(kw.value, ast.Constant)
                            and kw.value.value
                        )
                    elif kw.arg == "name" and isinstance(
                        kw.value, ast.Constant
                    ):
                        tname = str(kw.value.value)
                record(
                    ThreadEntry(
                        kind="thread",
                        module_relpath=fn.module.relpath,
                        lineno=node.lineno,
                        site_qualname=fn.qualname,
                        target=resolve_target(package, fn, target),
                        target_text=(
                            ast.unparse(target) if target is not None else ""
                        ),
                        daemon=daemon,
                        thread_name=tname,
                        binding=None,  # filled by thread_lifecycle
                    )
                )
            elif tail == "submit" and "." in name and EXECUTORISH_RE.search(
                name.rsplit(".", 1)[0]
            ):
                target = node.args[0] if node.args else None
                record(
                    ThreadEntry(
                        kind="executor",
                        module_relpath=fn.module.relpath,
                        lineno=node.lineno,
                        site_qualname=fn.qualname,
                        target=resolve_target(package, fn, target),
                        target_text=(
                            ast.unparse(target) if target is not None else ""
                        ),
                        daemon=False,
                        thread_name="",
                        binding=None,
                    )
                )
            elif tail == "run_in_executor" and len(node.args) >= 2:
                target = node.args[1]
                record(
                    ThreadEntry(
                        kind="executor",
                        module_relpath=fn.module.relpath,
                        lineno=node.lineno,
                        site_qualname=fn.qualname,
                        target=resolve_target(package, fn, target),
                        target_text=ast.unparse(target),
                        daemon=False,
                        thread_name="",
                        binding=None,
                    )
                )
            elif tail == "call_in" and len(node.args) >= 2:
                # obs.call_in(ctx, fn, …): runs fn on an executor thread
                # with the trace context attached
                target = node.args[1]
                record(
                    ThreadEntry(
                        kind="call_in",
                        module_relpath=fn.module.relpath,
                        lineno=node.lineno,
                        site_qualname=fn.qualname,
                        target=resolve_target(package, fn, target),
                        target_text=ast.unparse(target),
                        daemon=False,
                        thread_name="",
                        binding=None,
                    )
                )
    return sorted(
        found.values(), key=lambda e: (e.module_relpath, e.lineno)
    )


# ---------------------------------------------------------------------------
# cycle detection
# ---------------------------------------------------------------------------


def find_cycles(
    edges: Iterable[Tuple[str, str]], limit: int = 64
) -> List[List[str]]:
    """Every elementary cycle in the directed graph, each reported once
    with its smallest node first (deterministic).  Iterative DFS with a
    path stack — the graphs here are a dozen nodes, so no Johnson's
    machinery is needed; ``limit`` bounds pathological fixtures."""
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        if a == b:
            continue
        graph.setdefault(a, []).append(b)
    for v in graph.values():
        v.sort()
    cycles: List[List[str]] = []
    seen: Set[Tuple[str, ...]] = set()

    def canon_cycle(path: Sequence[str]) -> Tuple[str, ...]:
        i = path.index(min(path))
        return tuple(path[i:]) + tuple(path[:i])

    for start in sorted(graph):
        # DFS from `start`, only through nodes >= start (each cycle is
        # found from its smallest node exactly once)
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        while stack and len(cycles) < limit:
            node, path = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start:
                    key = canon_cycle(path)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(list(path) + [start])
                elif nxt > start and nxt not in path and len(path) < 16:
                    stack.append((nxt, path + [nxt]))
    return cycles
