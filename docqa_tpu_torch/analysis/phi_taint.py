"""phi-taint: raw pre-deid text must not reach logs, metrics, or
externally visible payloads.

Counterpart of ``docqa_tpu/analysis/phi_taint.py``.  The clinical
contract: extracted document text is PHI until it has been through
``deid/engine.py`` (``DeidEngine.deidentify_batch`` / ``anonymize``,
``anonymize_text``).  The raw queue (``raw_queue``) is the ONE sanctioned
pre-deid hop — everything else that leaves the process or lands in an
observability surface must carry masked text only.

Taint model (per function, flow-insensitive fixed point — deliberately
simple; the pipeline's handlers are short).  Every name below comes from
the package profile:

* **sources** — calls to ``phi_source_calls`` (``extract_text_ex`` /
  ``extract_text``); subscripts with a raw-schema key (``["text"]``);
  iteration/comprehension over a tainted collection.  A *nested* function
  whose body returns a tainted expression taints calls it is passed to
  (the ``retry.call(_extract)`` idiom).
* **propagation** — assignments (including tuple unpack and
  ``list.append``), f-strings/formatting/concatenation, subscripts of
  tainted values, and any call carrying a tainted argument (except
  content-free builtins: ``len``/``sum``/``bool``/…).
* **sanitizer** — a call whose name ends in one of
  ``phi_sanitizer_suffixes`` returns clean.
* **sinks** — logging calls (``log.…``/``logger.…``/``logging.…``)
  with a tainted argument; metrics-name construction
  (``….counter/histogram/gauge(tainted)``); broker publishes where the
  queue expression does not mention ``raw`` and the body is tainted;
  HTTP responses (on the port ``Response(tainted)`` /
  ``json_error(…, tainted)``).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from docqa_tpu_torch.analysis.core import (
    AnalysisProfile,
    Finding,
    FunctionInfo,
    Package,
    call_name,
    stmt_walk as _stmt_walk,
)

class _Taint:
    """Per-function taint state over local names."""

    def __init__(
        self, fn: FunctionInfo, tainted_fns: Set[str], profile: AnalysisProfile
    ):
        self.fn = fn
        self.profile = profile
        self.tainted_names: Set[str] = set()
        self.tainted_fns = tainted_fns  # nested defs returning tainted

    def is_sanitizer(self, name: str) -> bool:
        suffixes = self.profile.phi_sanitizer_suffixes
        return name.rsplit(".", 1)[-1] in suffixes or any(
            name.endswith(s) for s in suffixes
        )

    def tainted(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted_names
        if isinstance(node, ast.Subscript):
            key = node.slice
            if (
                isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and key.value in self.profile.phi_source_keys
            ):
                return True
            return self.tainted(node.value)
        if isinstance(node, ast.Call):
            name = call_name(node)
            bare = name.rsplit(".", 1)[-1]
            if self.is_sanitizer(name):
                return False
            if bare in self.profile.phi_source_calls:
                return True
            if bare in self.profile.phi_clean_calls:
                return False
            # method on a tainted receiver (text.strip()), tainted args,
            # or a tainted-returning function passed as an argument
            if isinstance(node.func, ast.Attribute) and self.tainted(
                node.func.value
            ):
                return True
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                if self.tainted(a):
                    return True
                if isinstance(a, ast.Name) and a.id in self.tainted_fns:
                    return True
            return False
        if isinstance(node, ast.JoinedStr):
            return any(
                self.tainted(v.value)
                for v in node.values
                if isinstance(v, ast.FormattedValue)
            )
        if isinstance(node, ast.FormattedValue):
            return self.tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tainted(v) for v in node.values if v is not None)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.tainted(node.elt) or any(
                self.tainted(g.iter) for g in node.generators
            )
        if isinstance(node, ast.DictComp):
            return self.tainted(node.value)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, ast.Attribute):
            return self.tainted(node.value)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        return False

    def _mark_targets(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted_names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mark_targets(e)

    def fixed_point(self) -> None:
        changed = True
        while changed:
            changed = False
            before = len(self.tainted_names)
            for node in _stmt_walk(self.fn.node):
                if isinstance(node, ast.Assign):
                    if self.tainted(node.value):
                        for t in node.targets:
                            self._mark_targets(t)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    if self.tainted(node.value):
                        self._mark_targets(node.target)
                elif isinstance(node, ast.AugAssign):
                    if self.tainted(node.value):
                        self._mark_targets(node.target)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    if self.tainted(node.iter):
                        self._mark_targets(node.target)
                elif isinstance(node, ast.Call):
                    name = call_name(node)
                    if (
                        name.endswith(".append")
                        and node.args
                        and self.tainted(node.args[0])
                    ):
                        base = name[: -len(".append")]
                        if "." not in base:
                            self.tainted_names.add(base)
                elif isinstance(node, ast.withitem):
                    pass
            for node in _stmt_walk(self.fn.node):
                if isinstance(
                    node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)
                ):
                    for g in node.generators:
                        if self.tainted(g.iter):
                            self._mark_targets(g.target)
            if len(self.tainted_names) != before:
                changed = True


class PhiTaintChecker:
    rule = "phi-taint"

    def check(self, package: Package) -> List[Finding]:
        out: List[Finding] = []
        # nested defs whose return value is tainted (the _extract idiom):
        # computed with an empty taint env — sources only
        tainted_fns: Set[str] = set()
        profile = package.profile
        for fn in package.functions:
            probe = _Taint(fn, set(), profile)
            probe.fixed_point()
            for node in _stmt_walk(fn.node):
                if isinstance(node, ast.Return) and probe.tainted(node.value):
                    tainted_fns.add(fn.name)
                    break
        for fn in package.functions:
            out.extend(self._check_fn(fn, tainted_fns, profile))
        return out

    def _check_fn(
        self, fn: FunctionInfo, tainted_fns: Set[str], profile: AnalysisProfile
    ) -> List[Finding]:
        module = fn.module
        taint = _Taint(fn, tainted_fns, profile)
        taint.fixed_point()
        out: List[Finding] = []
        for node in _stmt_walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            receiver = name.split(".")[0]
            attr = name.rsplit(".", 1)[-1]
            args = list(node.args) + [kw.value for kw in node.keywords]
            any_tainted = any(taint.tainted(a) for a in args)
            if not any_tainted:
                continue
            if receiver in profile.phi_log_receivers and "." in name:
                out.append(
                    Finding(
                        self.rule,
                        module.relpath,
                        node.lineno,
                        fn.qualname,
                        f"raw pre-deid text reaches logging via {name}()",
                    )
                )
            elif attr in profile.phi_metric_attrs:
                out.append(
                    Finding(
                        self.rule,
                        module.relpath,
                        node.lineno,
                        fn.qualname,
                        f"raw pre-deid text used as a metrics label in "
                        f"{name}()",
                    )
                )
            elif attr in profile.phi_publish_attrs:
                queue_expr = ""
                if node.args:
                    try:
                        queue_expr = ast.unparse(node.args[0])
                    except Exception:
                        queue_expr = ""
                if "raw" not in queue_expr:
                    out.append(
                        Finding(
                            self.rule,
                            module.relpath,
                            node.lineno,
                            fn.qualname,
                            f"raw pre-deid text published to "
                            f"{queue_expr or 'a queue'} (only the raw queue "
                            "may carry un-deidentified text)",
                        )
                    )
            elif attr in profile.phi_response_attrs:
                out.append(
                    Finding(
                        self.rule,
                        module.relpath,
                        node.lineno,
                        fn.qualname,
                        "raw pre-deid text reaches an HTTP response "
                        f"({name}())",
                    )
                )
        return out
