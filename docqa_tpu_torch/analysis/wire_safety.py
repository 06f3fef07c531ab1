"""wire-safety: unserializable values must not reach the wire,
counterpart of ``docqa_tpu/analysis/wire_safety.py``.

``json.dumps`` fails loud on locks and Trace objects but SILENTLY
miscarries the subtle cases: a tensor on the card syncs the calling
thread before failing, a numpy scalar serializes on one numpy version
and raises on another, and ``float("nan")`` produces ``NaN``, a token
that is not JSON and that strict parsers reject.  This rule flows coarse
type facts to the serialization boundaries — the profile's
``response_calls`` (``json_response(payload)``, the port's
``Response(status, payload)``), ``publish(queue, body)`` /
``_publish`` (``service/broker.py``, ``service/pipeline.py``), and
``_journal_write(queue, record)`` — and flags:

* device arrays (any value produced by a call through one of the
  profile's ``device_value_heads``: ``torch.*`` here, ``jax.*`` /
  ``jnp.*`` in the reference),
* numpy scalars and arrays (``np.mean`` et al., ``np.array``/``zeros``),
* locks and other ``threading`` primitives,
* ``Trace`` / ``Span`` objects (``obs.new_trace(...)`` and friends),
* non-finite floats (``float("nan"/"inf")``, ``math.inf``/``math.nan``).

A payload is sanctioned when it is wrapped in ``to_wire(...)`` at the
call site, or when the called function's own body routes through
``to_wire`` (the reference's ``json_response`` wrapper), or the called
class has a method that does (the port's ``Response``, whose
``json_body`` coerces its payload) — coercion at the boundary is the fix
this rule exists to enforce, so it must recognize the fix.  Facts are per-function and deliberately
shallow: a value this rule cannot type is silently trusted; every
finding names a concrete producer expression.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
)

_NUMPY_SCALAR_FNS = frozenset(
    {
        "mean", "sum", "min", "max", "median", "percentile", "quantile",
        "std", "var", "dot", "prod", "float32", "float64", "int32",
        "int64",
    }
)
_NUMPY_ARRAY_FNS = frozenset(
    {"array", "zeros", "ones", "asarray", "arange", "concatenate",
     "stack", "full", "empty"}
)
_LOCK_FNS = frozenset(
    {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
     "Event", "Barrier"}
)
_TRACE_FNS = frozenset({"new_trace", "Trace", "Span", "new_span"})
_CLEAN_WRAPPERS = frozenset(
    {"float", "int", "str", "bool", "list", "dict", "item", "tolist",
     "to_wire", "len", "round", "sorted", "repr"}
)


def _call_kind(
    node: ast.Call, fn: FunctionInfo, heads: Tuple[str, ...]
) -> Optional[str]:
    """Coarse type of a call's result, or None when untyped; ``heads`` are
    the import heads whose calls produce device arrays."""
    dotted = call_name(node)
    if not dotted:
        return None
    head = dotted.split(".", 1)[0]
    tail = dotted.rsplit(".", 1)[-1]
    origin = fn.module.resolve_alias(dotted)
    origin_head = origin.split(".", 1)[0]
    if origin_head in heads or head in heads or ".numpy." in origin:
        return "device array"
    if origin_head == "numpy" or head in ("np", "numpy"):
        if tail in _NUMPY_SCALAR_FNS:
            return "numpy scalar"
        if tail in _NUMPY_ARRAY_FNS:
            return "numpy array"
        return None
    if tail in _LOCK_FNS and (
        head in ("threading", "asyncio") or head == tail
    ):
        return "lock"
    if tail in _TRACE_FNS:
        return "trace/span object"
    if tail == "float" and node.args:
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(
            arg.value, str
        ) and arg.value.lstrip("+-").lower() in ("inf", "infinity", "nan"):
            return "non-finite float"
    return None


def _const_kind(node: ast.AST) -> Optional[str]:
    """math.inf / math.nan attribute reads."""
    if isinstance(node, ast.Attribute) and node.attr in ("inf", "nan"):
        base = node.value
        if isinstance(base, ast.Name) and base.id in ("math", "np",
                                                      "numpy"):
            return "non-finite float"
    return None


def _gather_facts(fn: FunctionInfo, heads: Tuple[str, ...]) -> Dict[str, str]:
    facts: Dict[str, str] = {}
    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        kind: Optional[str] = None
        if isinstance(node.value, ast.Call):
            kind = _call_kind(node.value, fn, heads)
        else:
            kind = _const_kind(node.value)
        if kind is not None:
            facts[tgt.id] = kind
        else:
            facts.pop(tgt.id, None)  # reassigned to something untyped
    return facts


def _wraps_to_wire(fn: FunctionInfo) -> bool:
    return any(
        isinstance(n, ast.Call)
        and call_name(n).rsplit(".", 1)[-1] == "to_wire"
        for n in ast.walk(fn.node)
    )


class WireSafetyChecker:
    rule = "wire-safety"

    def check(self, package: Package) -> List[Finding]:
        from docqa_tpu_torch.analysis.wire_schema import response_parts

        profile = package.profile
        heads = profile.device_value_heads
        responses = {name for name, _s, _p in profile.response_calls}
        # bare names of functions whose body coerces via to_wire, and of
        # classes with such a method — calling THEM is a sanctioned
        # boundary.
        sanctioned: Set[str] = set()
        for fn in package.functions:
            if _wraps_to_wire(fn):
                sanctioned.add(fn.name)
                if fn.class_name:
                    sanctioned.add(fn.class_name)
        out: List[Finding] = []
        for fn in package.functions:
            facts = _gather_facts(fn, heads)
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                tail = call_name(node).rsplit(".", 1)[-1]
                payload: Optional[ast.AST] = None
                boundary = ""
                if tail in responses:
                    payload = response_parts(node, profile.response_calls)[1]
                    boundary = tail
                    if payload is None:
                        continue
                elif tail in ("publish", "_publish") and len(
                    node.args
                ) >= 2:
                    payload = node.args[1]
                    boundary = "broker publish"
                elif tail == "_journal_write" and len(node.args) >= 2:
                    payload = node.args[1]
                    boundary = "journal write"
                if payload is None:
                    continue
                if tail not in responses and tail in sanctioned:
                    continue
                if (
                    tail in responses
                    and call_name(node) == tail
                    and tail in sanctioned
                    and fn.name != tail
                ):
                    # the local to_wire-coercing wrapper
                    continue
                self._check_expr(
                    fn, facts, payload, boundary, node.lineno, out, heads
                )
        return out

    def _check_expr(
        self,
        fn: FunctionInfo,
        facts: Dict[str, str],
        expr: ast.AST,
        boundary: str,
        lineno: int,
        out: List[Finding],
        heads: Tuple[str, ...],
    ) -> None:
        kind: Optional[str] = None
        if isinstance(expr, ast.Name):
            kind = facts.get(expr.id)
        elif isinstance(expr, ast.Call):
            tail = call_name(expr).rsplit(".", 1)[-1]
            if tail in _CLEAN_WRAPPERS:
                return  # float(x), x.item(), to_wire(x), ... are safe
            kind = _call_kind(expr, fn, heads)
        elif isinstance(expr, ast.Dict):
            for v in expr.values:
                if v is not None:
                    self._check_expr(
                        fn, facts, v, boundary, lineno, out, heads
                    )
            return
        elif isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            for v in expr.elts:
                self._check_expr(fn, facts, v, boundary, lineno, out, heads)
            return
        else:
            kind = _const_kind(expr)
        if kind is None:
            return
        if fn.module.is_suppressed(self.rule, lineno):
            return
        out.append(
            Finding(
                self.rule,
                fn.module.relpath,
                lineno,
                fn.qualname,
                f"{kind} crosses the wire at a {boundary} boundary — "
                "coerce with to_wire() before serializing",
            )
        )
