"""dispatch-streams: device work is SPINE-DELEGATED or it is ledgered,
counterpart of ``docqa_tpu/analysis/dispatch_streams.py``.

Every device phase of the port is a work item on the dispatch spine
(``engines/spine.py``): ``spine_run`` / ``spine_issue`` / ``spine_submit``
put a closure on one of the spine's ``n_lanes`` slots.  The checker holds
the tree to that at the spine boundary:

* **ownership** — a function OWNS device work when it can reach it on its
  own thread: a call in its own body that the profile's dispatch predicate
  names (a call through one of its ``dispatch_heads`` — ``torch.*`` here —
  other than a ``dispatch_wrapper_tails`` call that builds a host object,
  or one of its ``dispatch_calls``, the kernel wrappers' launch funnel),
  or a resolvable call into an owning function.  Nested closures handed to
  ``spine_run`` / ``spine_submit`` are the spine's work, not the
  caller's, and calls INTO the spine's module never propagate ownership:
  that is the delegation boundary.  An unresolvable call whose name is one
  of the profile's ``dispatch_attrs`` (``warmup``) is device work by
  convention;
* **the thread gate** — every thread entry point whose target OWNS device
  work appears in the ledger (``dispatch_streams.json``, in the profile's
  ``ledger_dir``) with a justification, and the entries marked
  ``concurrent_with_serving`` stay within
  ``budget.max_concurrent_device_streams``;
* **the stage gate** — every ``spine_run("<stage>", ...)`` submission site
  names a stage listed under the ledger's ``spine.stages``; an unknown
  stage and a stale stage entry both fail, like stale baselines.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.concurrency import (
    ThreadEntry,
    enumerate_thread_entries,
)
from docqa_tpu_torch.analysis.core import (
    GENERIC_NAMES,
    Finding,
    FunctionInfo,
    Package,
    call_name,
    load_json,
    package_ledger_path,
)

LEDGER_NAME = "dispatch_streams.json"



def load_ledger(path: Optional[str]) -> Dict:
    return load_json(path, streams={}, budget={}, spine={})


def _is_spine_module(package: Package, fn: FunctionInfo) -> bool:
    return fn.module.relname == package.profile.spine_module


def _iter_own_body(fn_node: ast.AST) -> Iterable[ast.AST]:
    """Nodes of a function's OWN body — nested def/lambda subtrees are
    skipped (each nested def is its own FunctionInfo; a closure's device
    work belongs to whoever EXECUTES it, which for spine submissions is a
    ledgered lane, not this function's thread)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _direct_dispatch(package: Package, fn: FunctionInfo) -> Optional[str]:
    """First call in the function's own body that enqueues device work by
    the profile's predicate (host-object constructors excluded), or None."""
    profile = package.profile
    pkg_root = fn.module.name.split(".")[0]
    for node in _iter_own_body(fn.node):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if not name:
            continue
        resolved = fn.module.resolve_alias(name)
        head = resolved.split(".")[0]
        if head in profile.dispatch_heads and "." in resolved:
            if resolved.rsplit(".", 1)[-1] in profile.dispatch_wrapper_tails:
                continue
            return resolved
        if profile.dispatch_calls:
            rel = resolved.partition(".")[2] if head == pkg_root else ""
            if rel in profile.dispatch_calls:
                return resolved
            callee = package.resolve_call(fn, node)
            if callee is not None:
                key = f"{callee.module.relname}.{callee.name}"
                if key in profile.dispatch_calls:
                    return key
    return None


def spine_aware_owners(package: Package) -> Dict[int, str]:
    """fn-node-id -> reason, for functions that OWN device work on their
    calling thread (spine-delegated work excluded).  Fixed point over
    package-resolvable calls; calls into the spine module are the
    delegation boundary and never propagate."""
    cache = getattr(package, "_concurrency_memo", None)
    if cache is None:
        cache = {}
        package._concurrency_memo = cache  # type: ignore[attr-defined]
    if "spine_owners" in cache:
        return cache["spine_owners"]

    submit_tails = package.profile.spine_submit_tails
    convention = package.profile.dispatch_attrs - submit_tails
    inits: Dict[str, FunctionInfo] = {}
    for fn in package.functions:
        if fn.name == "__init__" and fn.class_name:
            inits.setdefault(fn.class_name, fn)

    owners: Dict[int, str] = {}
    for fn in package.functions:
        # the spine's own lane machinery is THE ledgered stream family:
        # its executor is marked so the lane-loop thread entry is gated,
        # but callers never inherit it (delegation)
        hit = _direct_dispatch(package, fn)
        if hit is not None:
            owners[id(fn.node)] = hit

    def propagated(fn: FunctionInfo) -> Optional[str]:
        for node in _iter_own_body(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            tail = name.rsplit(".", 1)[-1]
            if tail in submit_tails:
                continue  # delegated: the spine's lanes execute it
            callee = package.resolve_call(fn, node)
            if callee is not None:
                if _is_spine_module(package, callee) and not _is_spine_module(
                    package, fn
                ):
                    continue  # delegation boundary (cross-module only:
                    # the spine's own machinery still chains to its lane
                    # loop, THE ledgered stream family)
                sub = owners.get(id(callee.node))
                if sub is not None:
                    return f"via {callee.qualname} ({sub})"
                continue
            if "." in name:
                if tail in GENERIC_NAMES:
                    continue  # ambiguity never guesses (core.resolve_call)
                # an external-module receiver (np.linalg.norm, os.path.x)
                # never resolves into the package (mirrors resolve_call)
                head = name.rsplit(".", 1)[0].split(".")[0]
                origin = fn.module.imports.get(head)
                pkg_root = fn.module.name.split(".")[0]
                if origin is not None and origin.split(".")[0] != pkg_root:
                    continue
                # candidates are methods/module functions only — a nested
                # def cannot be the target of an attribute call
                cands = [
                    c
                    for c in package.by_bare_name.get(tail, ())
                    if not _is_spine_module(package, c)
                    and "<locals>" not in c.qualname
                ]
                if cands:
                    for c in cands:
                        sub = owners.get(id(c.node))
                        if sub is not None:
                            return f"via candidate {c.qualname} ({sub})"
                    continue
                if tail in convention:
                    return f"{name} (compile/dispatch by convention)"
            else:
                ctor = inits.get(tail)
                if ctor is not None:
                    sub = owners.get(id(ctor.node))
                    if sub is not None:
                        return f"via {ctor.qualname} ({sub})"
        return None

    changed = True
    while changed:
        changed = False
        for fn in package.functions:
            if id(fn.node) in owners:
                continue
            why = propagated(fn)
            if why is not None:
                owners[id(fn.node)] = why
                changed = True
    cache["spine_owners"] = owners
    return owners


def enumerate_spine_sites(
    package: Package,
) -> List[Tuple[FunctionInfo, int, Optional[str]]]:
    """Every spine submission call site: (enclosing fn, lineno, stage
    literal or None when the stage is dynamic)."""
    out: List[Tuple[FunctionInfo, int, Optional[str]]] = []
    submit_tails = package.profile.spine_submit_tails
    for fn in package.functions:
        for node in _iter_own_body(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name or name.rsplit(".", 1)[-1] not in submit_tails:
                continue
            stage: Optional[str] = None
            if node.args and isinstance(node.args[0], ast.Constant) and (
                isinstance(node.args[0].value, str)
            ):
                stage = node.args[0].value
            out.append((fn, node.lineno, stage))
    return out


class DispatchStreamsChecker:
    rule = "dispatch-streams"

    def __init__(self, ledger_path: Optional[str] = None) -> None:
        self.ledger_path = ledger_path

    def check(self, package: Package) -> List[Finding]:
        ledger_path = self.ledger_path or package_ledger_path(
            package, LEDGER_NAME
        )
        ledger = load_ledger(ledger_path)
        streams: Dict[str, Dict] = ledger["streams"]
        owners = spine_aware_owners(package)
        out: List[Finding] = []

        present: Dict[str, ThreadEntry] = {}
        for entry in enumerate_thread_entries(package):
            capable, why = self._capability(entry, owners)
            if not capable:
                continue
            present.setdefault(entry.key, entry)
            row = streams.get(entry.key)
            if row is None:
                out.append(
                    Finding(
                        self.rule,
                        entry.module_relpath,
                        entry.lineno,
                        entry.site_qualname,
                        f"unledgered device-dispatch stream {entry.key!r} "
                        f"({why}) — route the device work through the "
                        f"dispatch spine (engines/spine.py spine_run), or "
                        f"add the entry to {LEDGER_NAME} with a "
                        "justification and account for it in the "
                        "concurrency budget",
                    )
                )

        analyzed = {m.relpath for m in package.modules}
        if ledger_path is not None:
            for key, row in sorted(streams.items()):
                rel = key.split(":", 1)[0]
                if rel not in analyzed:
                    continue  # another package's entries
                if key not in present:
                    out.append(
                        Finding(
                            self.rule,
                            rel,
                            1,
                            "<ledger>",
                            f"stale {LEDGER_NAME} entry {key!r}: no such "
                            "dispatch-owning thread entry point exists "
                            "any more — remove it (and reclaim its "
                            "budget slot)",
                        )
                    )
            budget = ledger["budget"].get("max_concurrent_device_streams")
            if budget is not None and present:
                # process-wide: entries verified present here, plus every
                # declared entry of another package run over one ledger
                concurrent = [
                    key
                    for key, row in sorted(streams.items())
                    if row.get("concurrent_with_serving")
                    and (
                        key in present
                        or key.split(":", 1)[0] not in analyzed
                    )
                ]
                if len(concurrent) > int(budget):
                    anchor = next(
                        (present[k] for k in concurrent if k in present),
                        next(iter(present.values())),
                    )
                    out.append(
                        Finding(
                            self.rule,
                            anchor.module_relpath,
                            anchor.lineno,
                            "<ledger>",
                            f"{len(concurrent)} streams marked "
                            "concurrent_with_serving exceed the ledger "
                            f"budget max_concurrent_device_streams="
                            f"{budget} — device work belongs on the "
                            "dispatch spine (engines/spine.py); raise "
                            "the budget only with new capacity evidence",
                        )
                    )
        out.extend(self._check_spine_stages(package, ledger, ledger_path))
        return out

    def _check_spine_stages(
        self, package: Package, ledger: Dict, ledger_path: Optional[str]
    ) -> List[Finding]:
        """Spine submission sites must use stage names the ledger's
        ``spine.stages`` declares, and every declared stage must still
        have a submission site (stale stages are pruned only by a package
        that contains spine sites at all)."""
        sites = enumerate_spine_sites(package)
        if not sites or ledger_path is None:
            return []
        stages: Dict[str, str] = dict(ledger.get("spine", {}).get(
            "stages", {}
        ))
        out: List[Finding] = []
        used: Set[str] = set()
        for fn, lineno, stage in sites:
            if stage is None:
                continue  # dynamic stage: the submitting API's problem
            used.add(stage)
            if stage not in stages:
                out.append(
                    Finding(
                        self.rule,
                        fn.module.relpath,
                        lineno,
                        fn.qualname,
                        f"spine stage {stage!r} is not declared in "
                        f"{LEDGER_NAME} spine.stages — name the new "
                        "device workload there with a one-line "
                        "description (the reviewed list of everything "
                        "that can occupy a dispatch lane)",
                    )
                )
        for stage in sorted(set(stages) - used):
            out.append(
                Finding(
                    self.rule,
                    package.modules[0].relpath,
                    1,
                    "<ledger>",
                    f"stale spine stage {stage!r} in {LEDGER_NAME}: no "
                    "spine_run/spine_submit site uses it any more — "
                    "remove the entry",
                )
            )
        return out

    @staticmethod
    def _capability(entry: ThreadEntry, owners: Dict[int, str]):
        if entry.target is not None:
            why = owners.get(id(entry.target.node))
            if why is None:
                return False, ""
            return True, f"target {entry.target.qualname} dispatches: {why}"
        return True, (
            f"dynamic target {entry.target_text!r} — unresolvable "
            "statically, conservatively dispatch-capable"
        )
