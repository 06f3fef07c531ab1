"""dtype-flow: low-precision math accumulates wide, and nothing silently
widens a bf16 pipeline.

Counterpart of ``docqa_tpu/analysis/dtype_flow.py``.  The serving stack
stores weights in bf16 / int8 / int4 because decode is bound by memory
bandwidth, but the math contract is that every product over those
operands accumulates in float32, every reduction over bf16 activations
upcasts first, and nothing drags float64 into device code.  The idioms
are the profile's: under the reference's, JAX's (``jnp.bfloat16``,
``.astype``, ``preferred_element_type``); under the port's, torch's.

Dtype **facts** are tracked per name, per function, in statement order,
with no type inference, only what the source states:

* literal dtype references through import aliases (``torch.bfloat16``,
  ``np.int8``, ``"bfloat16"`` strings);
* ``x = y.astype(D)`` / ``x = y.to(D)`` rebinds ``x`` to ``D``'s fact,
  including the ``.dtype`` rebind ``y.to(z.dtype)``; ``y.to(device)``
  keeps ``y``'s fact; the named casts ``.bfloat16()`` / ``.half()`` /
  ``.float()`` / ``.double()`` name theirs;
* array creation (``torch.zeros / ones / full / empty / tensor /
  as_tensor``, the numpy and jnp families) with a resolvable dtype;
* propagation through ``.T``, subscripts, unary and binary operations
  (Python scalar literals never widen a fact);
* across modules: a call that resolves through the package index scans
  the callee with the caller's low-precision argument facts bound to its
  parameters (depth-limited, memoized), and a resolved callee's return
  fact flows back.

Findings (an unresolvable dtype is silent):

1. a product (``@``, ``matmul``, ``einsum``, ...) over a bf16 / f16 /
   int8 / int4 fact: under the reference's profile without a
   ``preferred_element_type`` of f32 or wider.  Torch has no such
   argument: cuBLAS accumulates a bf16 product in float32 but, while
   ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
   keeps its default (True), may reduce split-K partials in bf16.  Under
   the port's profile a bf16 product is a finding unless the package
   assigns that flag False (``utils.py``, where ``resolve_device``
   resolves a CUDA device);
2. a reduction (``sum`` / ``mean`` / ``var`` / ``std`` / ``norm`` /
   ``logsumexp``, function or method form) over a bf16 / f16 fact without
   a wide ``dtype=``, and ``softmax`` / ``log_softmax`` over one (torch
   accepts ``dtype=torch.float32`` there);
3. float64 entering device code: an f64 dtype argument to a device call
   (``torch.*``), ``.astype`` / ``.to(float64)`` on a float fact,
   ``.double()``, and (port) an f64 numpy operand handed to a torch call;
4. silent widening: a binary operation between a bf16 / f16 fact and an
   f64 fact.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    dotted_name,
)

# canonical category names; width order for promotion
_DTYPE_NAMES = {
    "int4": "i4",
    "int8": "i8",
    "uint8": "i8",
    "bfloat16": "bf16",
    "float16": "f16",
    "half": "f16",
    "int32": "i32",
    "int64": "i64",
    "float32": "f32",
    "single": "f32",
    "float64": "f64",
    "double": "f64",
}
_WIDTH = {"i4": 0, "i8": 1, "bf16": 2, "f16": 2, "i32": 3, "i64": 4,
          "f32": 5, "f64": 6}
LOW_MATMUL = frozenset({"bf16", "f16", "i8", "i4"})
LOW_FLOAT = frozenset({"bf16", "f16"})
WIDE_ACC = frozenset({"f32", "f64", "i32", "i64"})

_CREATE_TAILS = {
    # tail -> positional index of the dtype argument (after the first)
    "zeros": 1, "ones": 1, "empty": 1, "full": 2,
    "asarray": 1, "array": 1, "full_like": 2, "arange": None,
}

# the port's creation calls beyond the reference's (torch takes dtype by
# keyword, bar as_tensor's second position)
_TORCH_CREATE_TAILS = {
    "tensor": None, "as_tensor": 1, "zeros_like": None, "ones_like": None,
    "empty_like": None, "randn": None, "rand": None, "randn_like": None,
}

_MAX_DEPTH = 5


class DtypeFlowChecker:
    rule = "dtype-flow"

    def check(self, package: Package) -> List[Finding]:
        self._package = package
        p = package.profile
        self._p = p
        self._names = dict(_DTYPE_NAMES)
        self._names.update(p.dtype_extra_names)
        self._create = dict(_CREATE_TAILS)
        if "torch" in p.dtype_array_heads:
            self._create.update(_TORCH_CREATE_TAILS)
        self._cast_methods = dict(p.dtype_cast_methods)
        self._pinned = p.dtype_accumulation_pin is not None and any(
            self._pins_accumulation(m, p.dtype_accumulation_pin)
            for m in package.modules
        )
        self._out: List[Finding] = []
        self._seen: set = set()  # (node id, fact context) scan memo
        self._ret_memo: Dict[int, object] = {}
        for fn in package.functions:
            self._scan(fn, {}, via="", depth=0)
        for module in package.modules:
            pseudo = FunctionInfo(
                module=module, node=module.tree, qualname="<module>",
                class_name=None,
            )
            self._scan(pseudo, {}, via="", depth=0)
        return self._out

    # -- dtype literal resolution -------------------------------------------

    def _dtype_of(self, module, node: Optional[ast.AST],
                  facts: Dict[str, Optional[str]]) -> Optional[str]:
        """Category of an expression used IN DTYPE POSITION, or None."""
        if node is None:
            return None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return self._names.get(node.value)
        if isinstance(node, (ast.Name, ast.Attribute)):
            dotted = dotted_name(node)
            if isinstance(node, ast.Attribute) and node.attr == "dtype":
                # y.dtype in dtype position: the .dtype rebind — take y's fact
                return self._fact_quiet(module, node.value, facts)
            resolved = module.resolve_alias(dotted)
            tail = resolved.rsplit(".", 1)[-1]
            cat = self._names.get(tail)
            if cat is None:
                return None
            if "." not in resolved:
                return cat  # from-import of the dtype name itself
            head = resolved.rsplit(".", 1)[0]
            heads = self._p.dtype_heads
            return cat if head in heads or head.startswith(
                self._p.dtype_device_heads[:1]) else None
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name.rsplit(".", 1)[-1] == "dtype" and node.args:
                return self._dtype_of(module, node.args[0], facts)
        return None

    def _fact_quiet(self, module, node, facts):
        """Fact of an expression without emitting findings (used from
        dtype-position resolution, where nothing is computed)."""
        sink: List[Finding] = []
        return self._eval(None, module, node, facts, sink, depth=_MAX_DEPTH)

    # -- function scan -------------------------------------------------------

    def _scan(self, fn: FunctionInfo, param_facts: Dict[str, Optional[str]],
              via: str, depth: int) -> None:
        key = (id(fn.node), tuple(sorted(
            (k, v) for k, v in param_facts.items() if v
        )))
        if key in self._seen or depth > _MAX_DEPTH:
            return
        self._seen.add(key)
        facts: Dict[str, Optional[str]] = dict(param_facts)
        body = getattr(fn.node, "body", None)
        if body is None:
            return
        self._exec_block(fn, body, facts, via, depth)

    def _exec_block(self, fn, stmts, facts, via, depth) -> None:
        for stmt in stmts:
            self._exec_stmt(fn, stmt, facts, via, depth)

    def _exec_stmt(self, fn, stmt, facts, via, depth) -> None:
        module = fn.module
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # own FunctionInfo pass
        if isinstance(stmt, ast.Assign):
            fact = self._eval(fn, module, stmt.value, facts, self._out,
                              depth, via=via)
            for target in stmt.targets:
                self._bind(target, fact, facts)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            fact = self._eval(fn, module, stmt.value, facts, self._out,
                              depth, via=via)
            self._bind(stmt.target, fact, facts)
            return
        if isinstance(stmt, ast.AugAssign):
            self._eval(fn, module, stmt.value, facts, self._out, depth,
                       via=via)
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._eval(fn, module, stmt.value, facts, self._out, depth,
                           via=via)
            return
        if isinstance(stmt, ast.Expr):
            self._eval(fn, module, stmt.value, facts, self._out, depth,
                       via=via)
            return
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While)):
            for attr in ("iter", "test"):
                sub = getattr(stmt, attr, None)
                if sub is not None:
                    self._eval(fn, module, sub, facts, self._out, depth,
                               via=via)
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._bind(stmt.target, None, facts)
            self._exec_block(fn, stmt.body, facts, via, depth)
            self._exec_block(fn, stmt.orelse, facts, via, depth)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._eval(fn, module, item.context_expr, facts, self._out,
                           depth, via=via)
            self._exec_block(fn, stmt.body, facts, via, depth)
            return
        if isinstance(stmt, ast.Try):
            self._exec_block(fn, stmt.body, facts, via, depth)
            for handler in stmt.handlers:
                self._exec_block(fn, handler.body, facts, via, depth)
            self._exec_block(fn, stmt.orelse, facts, via, depth)
            self._exec_block(fn, stmt.finalbody, facts, via, depth)
            return
        # any other statement kind: evaluate nested expressions for findings
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._eval(fn, module, sub, facts, self._out, depth, via=via)

    @staticmethod
    def _bind(target, fact, facts) -> None:
        if isinstance(target, ast.Name):
            facts[target.id] = fact if isinstance(fact, str) else None
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            elts = target.elts
            sub = fact if isinstance(fact, tuple) else (None,) * len(elts)
            if len(sub) != len(elts):
                sub = (None,) * len(elts)
            for t, f in zip(elts, sub):
                DtypeFlowChecker._bind(t, f, facts)

    # -- expression evaluation (facts + findings) ----------------------------

    def _emit(self, fn, node, message, via) -> None:
        suffix = f" [dtype via {via}]" if via else ""
        self._out.append(
            Finding(
                self.rule,
                fn.module.relpath,
                getattr(node, "lineno", 1),
                fn.qualname,
                message + suffix,
            )
        )

    def _eval(self, fn, module, node, facts, out, depth, via=""):
        """Returns the fact (category str, tuple of facts, or None) and
        appends findings for the patterns in the module docstring.  ``fn``
        may be None for quiet dtype-position evaluation."""
        if isinstance(node, ast.Name):
            return facts.get(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT", "real", "imag"):
                return self._eval(fn, module, node.value, facts, out, depth,
                                  via)
            return None
        if isinstance(node, ast.Subscript):
            self._eval(fn, module, node.slice, facts, out, depth, via)
            return self._eval(fn, module, node.value, facts, out, depth, via)
        if isinstance(node, ast.UnaryOp):
            return self._eval(fn, module, node.operand, facts, out, depth,
                              via)
        if isinstance(node, ast.Tuple):
            return tuple(
                self._eval(fn, module, e, facts, out, depth, via)
                for e in node.elts
            )
        if isinstance(node, ast.Lambda):
            inner = dict(facts)
            for a in node.args.args:
                inner[a.arg] = None
            return self._eval(fn, module, node.body, inner, out, depth, via)
        if isinstance(node, ast.IfExp):
            self._eval(fn, module, node.test, facts, out, depth, via)
            a = self._eval(fn, module, node.body, facts, out, depth, via)
            b = self._eval(fn, module, node.orelse, facts, out, depth, via)
            return a if a == b else None
        if isinstance(node, ast.BinOp):
            left = self._eval(fn, module, node.left, facts, out, depth, via)
            right = self._eval(fn, module, node.right, facts, out, depth, via)
            lf = left if isinstance(left, str) else None
            rf = right if isinstance(right, str) else None
            if isinstance(node.op, ast.MatMult):
                if fn is not None and (lf in LOW_MATMUL or rf in LOW_MATMUL):
                    low = lf if lf in LOW_MATMUL else rf
                    if self._p.dtype_accumulation_pin is not None:
                        self._unpinned(fn, node, low, "'@'", via)
                    else:
                        self._emit(
                            fn, node,
                            f"{low} matmul via '@' without f32 accumulation "
                            f"(use jnp.matmul/lax.dot_general with "
                            f"preferred_element_type=jnp.float32)",
                            via,
                        )
                return self._widest(lf, rf)
            if fn is not None and (
                (lf in LOW_FLOAT and rf == "f64")
                or (rf in LOW_FLOAT and lf == "f64")
            ):
                self._emit(
                    fn, node,
                    "float64 operand silently widens a bf16/f16 pipeline "
                    "(weak-type promotion; cast explicitly or keep f32)",
                    via,
                )
            return self._widest(lf, rf)
        if isinstance(node, ast.Call):
            return self._eval_call(fn, module, node, facts, out, depth, via)
        if isinstance(node, (ast.List, ast.Set)):
            for e in node.elts:
                self._eval(fn, module, e, facts, out, depth, via)
            return None
        if isinstance(node, ast.Dict):
            for e in list(node.keys) + list(node.values):
                if e is not None:
                    self._eval(fn, module, e, facts, out, depth, via)
            return None
        if isinstance(node, ast.Compare):
            self._eval(fn, module, node.left, facts, out, depth, via)
            for c in node.comparators:
                self._eval(fn, module, c, facts, out, depth, via)
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return None  # comprehension scopes: out of fact range
        return None

    @staticmethod
    def _widest(a: Optional[str], b: Optional[str]) -> Optional[str]:
        if a is None:
            return b
        if b is None:
            return a
        return a if _WIDTH.get(a, 0) >= _WIDTH.get(b, 0) else b

    def _kwarg(self, node: ast.Call, name: str) -> Optional[ast.AST]:
        for kw in node.keywords:
            if kw.arg == name:
                return kw.value
        return None

    def _is_device_head(self, resolved: str) -> bool:
        heads = self._p.dtype_device_heads
        return resolved.split(".")[0] in heads or any(
            resolved.startswith(h + ".") for h in heads
        )

    @staticmethod
    def _pins_accumulation(module, pin: str) -> bool:
        """``<pin> = False`` anywhere in ``module`` (through its import
        aliases)."""
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Constant) and node.value.value is False
            ):
                continue
            for t in node.targets:
                if module.resolve_alias(dotted_name(t)) == pin:
                    return True
        return False

    def _unpinned(self, fn, node, low, what, via) -> None:
        """The port's product finding: cuBLAS accumulates a low-precision
        product in float32 but may reduce its split-K partials in the
        operand's precision unless the package pins that off."""
        if self._pinned or low not in LOW_FLOAT:
            return
        self._emit(
            fn, node,
            f"{low} operand to {what} while "
            f"{self._p.dtype_accumulation_pin} keeps its default (True) — "
            "cuBLAS may reduce split-K partials in reduced precision; set "
            "it False where the engines are built",
            via,
        )

    def _eval_call(self, fn, module, node, facts, out, depth, via):
        p = self._p
        name = call_name(node)
        resolved = module.resolve_alias(name) if name else ""
        tail = name.rsplit(".", 1)[-1] if name else ""
        if not isinstance(node.func, (ast.Name, ast.Attribute)):
            # computed target — e.g. jax.jit(lambda ...)(args): the
            # wrapper call (and any lambda body) still carries dtype flow
            self._eval(fn, module, node.func, facts, out, depth, via)
        arg_facts = [
            self._eval(fn, module, a, facts, out, depth, via)
            for a in node.args
        ]
        for kw in node.keywords:
            self._eval(fn, module, kw.value, facts, out, depth, via)

        device_call = self._is_device_head(resolved)
        # float64 entering a device call through any dtype-ish argument
        if fn is not None and device_call:
            for candidate in list(node.args) + [
                kw.value for kw in node.keywords
            ]:
                if self._dtype_of(module, candidate, facts) == "f64":
                    self._emit(
                        fn, node,
                        f"float64 dtype passed to {name}() — "
                        f"{p.dtype_f64_reason}; use float32",
                        via,
                    )
                    break
            else:
                if p.dtype_f64_operands and "f64" in arg_facts:
                    self._emit(
                        fn, node,
                        f"float64 operand passed to {name}() — "
                        f"{p.dtype_f64_reason}; cast to float32 on the host "
                        "first",
                        via,
                    )

        # x.bfloat16() / .half() / .float() / .double(): a named cast
        if (
            tail in self._cast_methods
            and isinstance(node.func, ast.Attribute)
            and not node.args
            and not node.keywords
            and not module.imports.get(dotted_name(node.func.value).split(".")[0])
        ):
            recv = self._eval(fn, module, node.func.value, facts, out, depth,
                              via)
            cat = self._cast_methods[tail]
            if fn is not None and cat == "f64":
                self._emit(
                    fn, node,
                    f".{tail}() casts to float64 — {p.dtype_f64_cast_reason}; "
                    "accumulate in float32 instead",
                    via,
                )
            return cat

        # x.astype(D) / x.to(D): the rebind
        if tail in p.dtype_cast_tails and isinstance(node.func, ast.Attribute):
            recv = self._eval(fn, module, node.func.value, facts, out,
                              depth, via)
            arg = node.args[0] if node.args else None
            if tail != "astype" and self._kwarg(node, "dtype") is not None:
                arg = self._kwarg(node, "dtype")
            cat = self._dtype_of(module, arg, facts)
            if cat is None and tail != "astype":
                # .to(device) keeps the receiver's dtype; .to(D) names it
                for extra in node.args[1:]:
                    cat = cat or self._dtype_of(module, extra, facts)
            if (
                fn is not None
                and cat == "f64"
                and isinstance(recv, str)
                and recv in ("bf16", "f16", "f32")
            ):
                self._emit(
                    fn, node,
                    f"{tail}(float64) on a float pipeline value — "
                    f"{p.dtype_f64_cast_reason}; accumulate in float32 instead",
                    via,
                )
            if tail == "astype":
                return cat
            return cat or (recv if isinstance(recv, str) else None)

        # creation calls with a dtype argument
        head = resolved.split(".")[0]
        if tail in self._create and head in p.dtype_array_heads:
            d = self._kwarg(node, "dtype")
            if d is None:
                pos = self._create[tail]
                if pos is not None and len(node.args) > pos:
                    d = node.args[pos]
            return self._dtype_of(module, d, facts)
        if tail == "ShapeDtypeStruct" and len(node.args) >= 2:
            return self._dtype_of(module, node.args[1], facts)

        # matmul family
        if tail in p.dtype_matmul_tails and (
            device_call or head in ("np", "numpy")
        ):
            if tail == "einsum" and node.args and isinstance(
                node.args[0], ast.Constant
            ):
                operands = arg_facts[1:]
            elif tail == "dot_general":
                operands = arg_facts[:2]
            else:
                operands = arg_facts[:2]
            low = next((f for f in operands if f in LOW_MATMUL), None)
            if p.dtype_accumulation_pin is not None:
                if fn is not None and low is not None and device_call:
                    self._unpinned(fn, node, low, f"{tail}()", via)
                known = [f for f in operands if isinstance(f, str)]
                return known[0] if len(known) == len(operands) and known else None
            pet = self._kwarg(node, "preferred_element_type")
            pet_cat = self._dtype_of(module, pet, facts)
            if fn is not None and low is not None:
                if pet is None:
                    self._emit(
                        fn, node,
                        f"{low} operand to {tail}() without "
                        "preferred_element_type — low-precision matmuls "
                        "must accumulate in float32 or wider",
                        via,
                    )
                elif pet_cat is not None and pet_cat not in WIDE_ACC:
                    self._emit(
                        fn, node,
                        f"{tail}() accumulates a {low} operand into "
                        f"{pet_cat} — preferred_element_type must be "
                        "float32 or wider",
                        via,
                    )
            if pet_cat is not None:
                return pet_cat
            known = [f for f in operands if isinstance(f, str)]
            return known[0] if len(known) == len(operands) and known else None

        # method-form matmul: x.dot(y)
        if tail == "dot" and isinstance(node.func, ast.Attribute):
            recv = self._eval(fn, module, node.func.value, facts, out,
                              depth, via)
            low = recv if recv in LOW_MATMUL else next(
                (f for f in arg_facts if f in LOW_MATMUL), None)
            if fn is not None and low is not None:
                if p.dtype_accumulation_pin is not None:
                    self._unpinned(fn, node, low, ".dot()", via)
                else:
                    self._emit(
                        fn, node,
                        "low-precision .dot() without f32 accumulation (use "
                        "jnp.matmul/lax.dot_general with "
                        "preferred_element_type=jnp.float32)",
                        via,
                    )
            return recv if isinstance(recv, str) else None

        # reductions
        if tail in p.dtype_reduce_tails:
            operand = None
            if isinstance(node.func, ast.Attribute) and head not in (
                p.dtype_array_heads
            ):
                operand = self._eval(fn, module, node.func.value, facts,
                                     out, depth, via)
            elif arg_facts:
                if device_call or head in ("np", "numpy"):
                    operand = arg_facts[0]
            dt = self._dtype_of(module, self._kwarg(node, "dtype"), facts)
            if fn is not None and operand in LOW_FLOAT and (
                dt is None or dt not in WIDE_ACC
            ):
                self._emit(
                    fn, node,
                    f"{tail}() reduces a {operand} value without an f32 "
                    f"accumulator — pass dtype={p.dtype_f32_name} or upcast "
                    "the operand first",
                    via,
                )
            return dt or (operand if isinstance(operand, str) else None)
        if tail in p.dtype_softmax_tails:
            operand = arg_facts[0] if arg_facts else None
            if (
                p.dtype_softmax_takes_dtype
                and isinstance(node.func, ast.Attribute)
                and head not in p.dtype_array_heads
            ):
                operand = self._eval(fn, module, node.func.value, facts,
                                     out, depth, via)
            if operand is not None or arg_facts:
                dt = (
                    self._dtype_of(module, self._kwarg(node, "dtype"), facts)
                    if p.dtype_softmax_takes_dtype else None
                )
                if fn is not None and operand in LOW_FLOAT and (
                    dt is None or dt not in WIDE_ACC
                ):
                    self._emit(
                        fn, node,
                        f"{tail}() over a {operand} value — softmax "
                        "must run in float32 (upcast the scores first)",
                        via,
                    )
                if dt is not None:
                    return dt
                return operand if isinstance(operand, str) else None

        # jnp.dtype(...) in value position
        if tail == "dtype" and node.args:
            return self._dtype_of(module, node.args[0], facts)

        # cross-module propagation through the package index
        if fn is not None and self._package is not None:
            callee = self._package.resolve_call(fn, node)
            if callee is not None and hasattr(callee.node, "args"):
                low_binding = self._bind_params(callee, node, arg_facts)
                if low_binding:
                    self._scan(
                        callee, low_binding,
                        via=via or fn.qualname, depth=depth + 1,
                    )
                return self._return_fact(callee, depth + 1)
        return None

    def _bind_params(self, callee: FunctionInfo, node: ast.Call,
                     arg_facts) -> Dict[str, Optional[str]]:
        """Positional/keyword binding of LOW facts onto callee params;
        empty when no low fact crosses the call (nothing new to scan)."""
        params = callee.params
        offset = 1 if callee.class_name and params[:1] == ["self"] else 0
        binding: Dict[str, Optional[str]] = {}
        for i, f in enumerate(arg_facts):
            if f in LOW_MATMUL and i + offset < len(params):
                binding[params[i + offset]] = f
        for kw in node.keywords:
            if kw.arg and kw.arg in params:
                # facts for keywords were evaluated already; re-derive is
                # costlier than it is worth — positional covers the tree
                continue
        return binding

    def _return_fact(self, callee: FunctionInfo, depth: int):
        """Fact of a resolved callee's return value, from a quiet scan of
        its body with no parameter facts (memoized)."""
        if depth > _MAX_DEPTH:
            return None
        memo = self._ret_memo
        key = id(callee.node)
        if key in memo:
            return memo[key]
        memo[key] = None  # cycle guard
        facts: Dict[str, Optional[str]] = {}
        sink: List[Finding] = []
        rets = []

        def walk(stmts):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.Assign):
                    fact = self._eval(None, callee.module, stmt.value, facts,
                                      sink, depth)
                    for t in stmt.targets:
                        self._bind(t, fact, facts)
                elif isinstance(stmt, ast.Return) and stmt.value is not None:
                    rets.append(
                        self._eval(None, callee.module, stmt.value, facts,
                                   sink, depth)
                    )
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if isinstance(sub, list):
                        walk(sub)
                if isinstance(stmt, ast.Try):
                    for handler in stmt.handlers:
                        walk(handler.body)

        body = getattr(callee.node, "body", None)
        if body:
            walk(body)
        uniq = {repr(r) for r in rets}
        result = rets[0] if len(uniq) == 1 and rets else None
        memo[key] = result
        return result
