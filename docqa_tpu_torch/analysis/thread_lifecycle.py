"""thread-lifecycle: every thread has a reachable join on its owner's
stop/close path.

Counterpart of ``docqa_tpu/analysis/thread_lifecycle.py``.  Two failure
classes this rule exists for:

* **unjoined device threads** — a thread whose target's call graph can
  reach device work (the shared dispatch predicate of
  ``analysis/concurrency.py``: a ``torch.*`` call, a kernel wrapper's
  launch, a ``spine_run`` / ``spine_submit``, a constructor that
  allocates on the card) still enqueueing or fetching when its owner
  stops races the owner's teardown of the buffers it reads, and at
  interpreter exit the CUDA context under it.  Such a thread MUST be
  join-reachable, daemon or not;
* **leaked workers** — a non-daemon thread with no join anywhere keeps
  the process alive on shutdown; a daemon one dies mid-mutation.

"Join-reachable" is checked in the thread's OWNER scope:

* ``self._x = threading.Thread(…)`` — some method of the same module
  joins ``self._x`` (directly, or through a local alias
  ``t = self._x; t.join(…)``);
* a local ``t = threading.Thread(…)`` — the same function joins ``t``,
  or ``t`` flows into a container (``append``, list literal, list
  concat) that a ``for`` loop later iterates and joins;
* ``threading.Thread(…).start()`` with NO binding can never be joined —
  always flagged.

Deliberately unjoined threads (a watchdog designed to die with the
process and provably free of device work) belong in the baseline with a
justification.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from docqa_tpu_torch.analysis.concurrency import (
    dispatch_reachable,
    enumerate_thread_entries,
    module_scope_fn,
)
from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    dotted_name,
)


def _join_receivers(root: ast.AST) -> Set[str]:
    """Dotted receiver texts of every ``.join(…)`` call under ``root``."""
    out: Set[str] = set()
    for node in ast.walk(root):
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr == "join":
            recv = dotted_name(node.func.value)
            if recv:
                out.add(recv)
    return out


def _local_aliases_of(root: ast.AST, attr: str) -> Set[str]:
    """Local names assigned from ``self.<attr>`` — plain reads and the
    defensive ``getattr(self, "<attr>", None)`` idiom alike."""
    out: Set[str] = set()
    for node in ast.walk(root):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        matches = (
            isinstance(value, ast.Attribute) and value.attr == attr
        )
        if (
            not matches
            and isinstance(value, ast.Call)
            and call_name(value) == "getattr"
            and len(value.args) >= 2
            and isinstance(value.args[1], ast.Constant)
            and value.args[1].value == attr
        ):
            matches = True
        if matches:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _containers_fed_by(root: ast.AST, name: str) -> Set[str]:
    """Container expressions (dotted text) the name flows into: via
    ``c.append(name)``, ``c = [... name ...]`` list literals, or list
    concatenation re-assignments (the pool's ``self._warmups = […] + [t]``
    idiom)."""
    out: Set[str] = set()
    for node in ast.walk(root):
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr == "append":
            if any(
                isinstance(a, ast.Name) and a.id == name for a in node.args
            ):
                recv = dotted_name(node.func.value)
                if recv:
                    out.add(recv)
        elif isinstance(node, ast.Assign):
            has_name = any(
                isinstance(n, ast.Name) and n.id == name
                for n in ast.walk(node.value)
            )
            if not has_name:
                continue
            for t in node.targets:
                text = dotted_name(t)
                if text:
                    out.add(text)
    return out


def _loop_vars_over(root: ast.AST, containers: Set[str]) -> Set[str]:
    """Loop variables of ``for v in <container>`` statements."""
    out: Set[str] = set()
    norm = {c.split(".")[-1] for c in containers} | containers
    for node in ast.walk(root):
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            it = dotted_name(node.iter)
            if not it and isinstance(node.iter, ast.Call):
                # for t in list(self._warmups): / reversed(threads):
                if node.iter.args:
                    it = dotted_name(node.iter.args[0])
            if not it and isinstance(node.iter, (ast.Tuple, ast.List)):
                # for t in (sampler, watchdog_thread): — the loop var
                # aliases each named element
                if any(
                    dotted_name(e) in containers
                    or dotted_name(e).split(".")[-1] in norm
                    for e in node.iter.elts
                    if dotted_name(e)
                ):
                    out.add(node.target.id)
                    continue
            if it and (it in containers or it.split(".")[-1] in norm):
                out.add(node.target.id)
    return out


class ThreadLifecycleChecker:
    rule = "thread-lifecycle"

    def check(self, package: Package) -> List[Finding]:
        reach = dispatch_reachable(package)
        out: List[Finding] = []

        # module-wide join receivers, computed once per module
        module_joins: Dict[object, Set[str]] = {}

        for entry in enumerate_thread_entries(package):
            if entry.kind != "thread":
                continue  # executor lanes belong to dispatch-streams
            fn = self._site_fn(package, entry)
            if fn is None:
                continue
            module = fn.module
            binding = self._binding(fn, entry.lineno)
            joined = self._is_joined(
                package, fn, module, binding, module_joins
            )
            if joined:
                continue
            target_reach = (
                reach.get(id(entry.target.node))
                if entry.target is not None
                else None
            )
            name = entry.thread_name or entry.target_text or "<thread>"
            if target_reach is not None:
                detail = (
                    f" and its target can reach device work "
                    f"({target_reach}): device work on an unjoined "
                    "thread outlives its owner's teardown and, at "
                    "interpreter exit, the CUDA context"
                )
            elif entry.daemon:
                detail = (
                    ": a daemon thread dies mid-mutation at interpreter "
                    "exit"
                )
            else:
                detail = ": an unjoined non-daemon thread blocks shutdown"
            out.append(
                Finding(
                    self.rule,
                    module.relpath,
                    entry.lineno,
                    entry.site_qualname,
                    f"thread {name!r} has no reachable join() on its "
                    f"owner's stop/close path{detail}",
                )
            )
        return out

    # -- helpers --------------------------------------------------------------

    def _site_fn(self, package: Package, entry) -> Optional[FunctionInfo]:
        for fn in package.functions:
            if (
                fn.module.relpath == entry.module_relpath
                and fn.qualname == entry.site_qualname
            ):
                return fn
        if entry.site_qualname == "<module>":
            for m in package.modules:
                if m.relpath == entry.module_relpath:
                    return module_scope_fn(m)
        return None

    def _binding(self, fn: FunctionInfo, lineno: int) -> Optional[str]:
        """The name the Thread(...) at ``lineno`` is bound to: 'self.X',
        a local name, a container it is appended into — or None for an
        unbound ``Thread(...).start()`` chain."""

        def creates_here(root: ast.AST) -> bool:
            return any(
                isinstance(c, ast.Call)
                and c.lineno == lineno
                and call_name(c).rsplit(".", 1)[-1] == "Thread"
                for c in ast.walk(root)
            )

        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and creates_here(node.value):
                for t in node.targets:
                    text = dotted_name(t)
                    if text:
                        return text
            # threads.append(Thread(...)): bound to the container
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and node.args
                and creates_here(node.args[0])
            ):
                recv = dotted_name(node.func.value)
                if recv:
                    return recv
        return None

    def _is_joined(
        self,
        package: Package,
        fn: FunctionInfo,
        module,
        binding: Optional[str],
        module_joins: Dict[object, Set[str]],
    ) -> bool:
        if binding is None:
            return False  # Thread(...).start() — nothing to join
        if module not in module_joins:
            module_joins[module] = _join_receivers(module.tree)
        joins = module_joins[module]

        def attr_joined(attr: str) -> bool:
            """self.X joined anywhere in the module: `self.X.join`, an
            alias `t = self.X; t.join` (getattr idiom included), or via
            a joined for-loop over a container self.X flows into."""
            if any(j.split(".")[-1] == attr for j in joins):
                return True
            for other in package.functions:
                if other.module is not module:
                    continue
                local_joins = _join_receivers(other.node)
                for alias in _local_aliases_of(other.node, attr):
                    if alias in local_joins:
                        return True
                # for t in self.X: t.join(...)
                loop_vars = _loop_vars_over(other.node, {f"self.{attr}"})
                if loop_vars & local_joins:
                    return True
            return False

        if binding.startswith("self."):
            attr = binding.split(".", 1)[1]
            if attr_joined(attr):
                return True
            # the thread may flow onward into a tracked container
            containers = _containers_fed_by(module.tree, attr)
            return any(
                attr_joined(c.split(".")[-1]) for c in containers
            )

        # local binding: joined in the same function, or flows into a
        # container / self attribute that is joined elsewhere
        local_joins = _join_receivers(fn.node)
        if binding in local_joins:
            return True
        # the binding may itself BE the container (threads = [Thread(…),
        # …] at script scope) — treat it as one for the loop-join scan
        containers = {binding} | _containers_fed_by(fn.node, binding)
        loop_vars = _loop_vars_over(fn.node, containers)
        if loop_vars & local_joins:
            return True
        for c in containers:
            if c.startswith("self.") and attr_joined(c.split(".", 1)[1]):
                return True
        # module-level script idiom: threads list at module scope
        mod_loop_vars = _loop_vars_over(module.tree, containers)
        return bool(mod_loop_vars & _join_receivers(module.tree))
