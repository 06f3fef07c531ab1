"""spec-shape: a sharding spec's entry count must match its array's rank.

Counterpart of ``docqa_tpu/analysis/spec_shape.py``.  A spec with k
entries annotates exactly a rank-k array.  The shapes and the specs live
in different modules by design (``models/decoder.py`` owns
``decoder_param_schema`` and ``init_kv_cache``, ``engines/paged.py``
``init_paged_pools``; ``parallel/sharding.py`` owns
``decoder_param_pspecs`` / ``cache_pspecs`` / ``paged_pool_pspecs``), so
nothing structural keeps them in sync; this rule does.  In the port a
spec is a tuple of axis names (``parallel/sharding.py`` ``Spec``), and
``shard_leaf`` refuses a mismatch only when the leaf is first sharded,
which a (1, 1) mesh never does.

Resolution: package-wide **name-template facts** (f-string names are
normalized, ``f"l{i}_wq"`` -> ``l{}_wq``, so schema and spec rows written
as parallel f-strings match):

* **rank facts** — ``(name, ..., (shape, tuple), ...)`` rows yielded by
  schema generators (the shape is the unique literal-tuple element), and
  ``d[f"k{i}"] = torch.zeros(shape, ...)`` subscript stores whose shape
  resolves to a literal tuple (directly or through one local assignment);
* **spec facts** — dict-literal entries and subscript stores whose value
  is a spec: a ``PartitionSpec`` / ``P`` call (the profile's
  ``spec_call_tails``), or, inside the profile's ``spec_tuple_functions``,
  a tuple literal (or a local name assigned from one).

A template with consistent rank facts and a spec of another arity flags
at the spec site.  Templates with conflicting rank facts (the KV cache's
4-d ``k{i}`` and the paged pool's 3-d ``k{i}``) are dropped: ambiguity
never guesses; ``tests/test_torch_shardcheck.py`` holds those at run time
on abstract shapes.  ``P()`` (fully replicated) matches any rank.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
)


def _name_template(node: ast.AST) -> Optional[str]:
    """Literal or f-string key -> template ("l{}_wq"); None otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue):
                parts.append("{}")
            else:
                return None
        return "".join(parts)
    return None


def _is_pspec_call(fn: FunctionInfo, node: ast.AST, tails) -> Optional[ast.Call]:
    if not isinstance(node, ast.Call):
        return None
    resolved = fn.module.resolve_alias(call_name(node))
    if resolved.rsplit(".", 1)[-1] in tails:
        return node
    return None


def _tuple_arity(node: ast.AST) -> Optional[int]:
    """len of a spec written as a tuple literal (None with a starred
    element)."""
    if not isinstance(node, ast.Tuple):
        return None
    if any(isinstance(e, ast.Starred) for e in node.elts):
        return None
    return len(node.elts)


def _spec_arity(call: ast.Call) -> Optional[int]:
    """len(P(...)) — None for P(*xs) or P() (replicated matches any)."""
    if any(isinstance(a, ast.Starred) for a in call.args):
        return None
    if call.keywords or not call.args:
        return None
    return len(call.args)


_SHAPED_CTORS = frozenset({"zeros", "ones", "full", "empty", "normal"})


class SpecShapeChecker:
    rule = "spec-shape"

    def check(self, package: Package) -> List[Finding]:
        self._tails = package.profile.spec_call_tails
        self._tuple_fns = package.profile.spec_tuple_functions
        ranks = self._rank_facts(package)
        out: List[Finding] = []
        for fn in package.functions:
            for template, arity, node in self._spec_facts(fn):
                rank = ranks.get(template)
                if rank is None or arity is None or rank < 0:
                    continue
                if rank != arity:
                    out.append(
                        Finding(
                            self.rule,
                            fn.module.relpath,
                            getattr(node, "lineno", 1),
                            fn.qualname,
                            f"PartitionSpec for '{template}' has {arity} "
                            f"entries but the array is rank {rank} "
                            f"(shape declared elsewhere in the package)",
                        )
                    )
        return out

    # -- rank facts -----------------------------------------------------------

    def _rank_facts(self, package: Package) -> Dict[str, int]:
        """template -> rank; conflicting templates collapse to -1."""
        ranks: Dict[str, int] = {}

        def record(template: Optional[str], rank: Optional[int]) -> None:
            if template is None or rank is None:
                return
            old = ranks.get(template)
            if old is None:
                ranks[template] = rank
            elif old != rank:
                ranks[template] = -1  # ambiguous: never checked

        for fn in package.functions:
            lits = self._literal_tuples(fn.node)
            for node in ast.walk(fn.node):
                # schema rows: yield (name, ..., (a, b), ...)
                if isinstance(node, ast.Yield) and isinstance(
                    node.value, ast.Tuple
                ):
                    elts = node.value.elts
                    template = _name_template(elts[0]) if elts else None
                    tuples = [
                        e for e in elts[1:] if isinstance(e, ast.Tuple)
                    ]
                    if template is not None and len(tuples) == 1:
                        record(template, len(tuples[0].elts))
                # d[f"k{i}"] = jnp.zeros(shape, ...)
                elif isinstance(node, ast.Assign) and len(
                    node.targets
                ) == 1 and isinstance(node.targets[0], ast.Subscript):
                    template = _name_template(node.targets[0].slice)
                    rank = self._ctor_rank(node.value, lits)
                    record(template, rank)
        return ranks

    def _ctor_rank(
        self, value: ast.AST, lits: Dict[str, int]
    ) -> Optional[int]:
        if not isinstance(value, ast.Call):
            return None
        tail = call_name(value).rsplit(".", 1)[-1]
        if tail not in _SHAPED_CTORS:
            return None
        shape = value.args[0] if value.args else None
        if isinstance(shape, ast.Tuple):
            if any(isinstance(e, ast.Starred) for e in shape.elts):
                return None
            return len(shape.elts)
        if isinstance(shape, ast.Name):
            return lits.get(shape.id)
        return None

    @staticmethod
    def _literal_tuples(scope: ast.AST) -> Dict[str, int]:
        """name -> rank for ``shape = (a, b, c)`` local assignments."""
        out: Dict[str, int] = {}
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Tuple
            ) and not any(
                isinstance(e, ast.Starred) for e in node.value.elts
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = len(node.value.elts)
        return out

    # -- spec facts -----------------------------------------------------------

    def _spec_facts(self, fn: FunctionInfo):
        """Yield (template, arity, site-node) for every name -> P(...)
        association in ``fn``."""
        # local names bound to a P(...) call: spec = P(a, None, b, None)
        # a function whose specs are tuple literals (the port's
        # ``Dict[str, Spec]`` tables): its tuple values are specs
        tuples = fn.name in self._tuple_fns
        local_specs: Dict[str, int] = {}
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign):
                call = _is_pspec_call(fn, node.value, self._tails)
                arity = _spec_arity(call) if call is not None else (
                    _tuple_arity(node.value) if tuples else None)
                if arity is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_specs[t.id] = arity

        def value_arity(value: ast.AST) -> Optional[int]:
            call = _is_pspec_call(fn, value, self._tails)
            if call is not None:
                return _spec_arity(call)
            if tuples and isinstance(value, ast.Tuple):
                return _tuple_arity(value)
            if isinstance(value, ast.Name):
                return local_specs.get(value.id)
            return None

        for node in ast.walk(fn.node):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if k is None:
                        continue
                    template = _name_template(k)
                    arity = value_arity(v)
                    if template is not None and arity is not None:
                        yield template, arity, k
            elif isinstance(node, ast.Assign) and len(
                node.targets
            ) == 1 and isinstance(node.targets[0], ast.Subscript):
                template = _name_template(node.targets[0].slice)
                arity = value_arity(node.value)
                if template is not None and arity is not None:
                    yield template, arity, node
