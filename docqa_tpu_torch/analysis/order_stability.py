"""order-stability: iteration order feeding device packing, key
construction or journal serialisation must be pinned.

Counterpart of ``docqa_tpu/analysis/order_stability.py``.  The batcher's
ragged-prefill pack order decides position-dependent numerics: its
bitwise gates (warm == cold, spec on == off, two processes equal) hold
only because pack order is a function of admission order alone.  Anything
that puts an unordered iterate upstream of packing, batch assembly, key
derivation or journal serialisation makes two identical runs diverge:

* ``set`` / ``frozenset`` iteration order varies per process (str hash
  salting): flagged wherever it appears in a scope module;
* ``os.listdir`` / ``os.scandir`` / ``glob`` order depends on the file
  system: flagged unless wrapped in ``sorted(...)``;
* ``dict`` iteration is insertion-ordered, deterministic only if the
  insertions were: flagged only inside order-sink functions (a name
  matching pack / admis / assemble / serial / journal / key / fingerprint
  / batch / snapshot / replay, or a body that writes the journal or a
  hashlib / json digest).

Order pins, checked on the iterate's line: a ``sorted(...)`` wrap, an
earlier ``.sort()`` on the name, or the pragma ``# docqa-lint:
ordered(<why insertion order is deterministic>)``.

Scope: the profile's ``order_modules`` (in the port the batcher and paged
pool, ``service/qa.py``, ``service/broker.py``, the store and its
snapshot); fixtures opt in with the ``docqa-lint: request-path`` pragma.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Module,
    Package,
    call_name,
)

_ORDERED_PRAGMA_RE = re.compile(r"#\s*docqa-lint:\s*ordered\(([^)]*)\)")
_SINK_NAME_RE = re.compile(
    r"pack|admis|admit|assemble|serial|journal|key|fingerprint|batch"
    r"|snapshot|replay",
    re.IGNORECASE,
)
_SINK_CALL_TAILS = frozenset(
    {"_journal_write", "dumps", "sha1", "sha256", "md5", "crc32", "blake2b"}
)
_LISTING_CALLS = frozenset(
    {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}
)
_DICT_METHODS = frozenset({"items", "keys", "values"})
_SET_METHODS = frozenset(
    {"difference", "union", "intersection", "symmetric_difference"}
)


def ordered_pragma_lines(module: Module) -> Dict[int, str]:
    """line -> justification text for ``# docqa-lint: ordered(...)``."""
    out: Dict[int, str] = {}
    for i, line in enumerate(module.source.splitlines(), start=1):
        m = _ORDERED_PRAGMA_RE.search(line)
        if m:
            out[i] = m.group(1).strip()
    return out


class OrderStabilityChecker:
    rule = "order-stability"

    def check(self, package: Package) -> List[Finding]:
        scope = package.profile.order_modules
        out: List[Finding] = []
        for module in package.modules:
            if not (module.relname in scope or module.request_path_pragma):
                continue
            pragmas = ordered_pragma_lines(module)
            fns = [
                f for f in package.functions if f.module is module
            ]
            for fn in fns:
                self._scan_fn(module, fn, pragmas, out)
            self._scan_module_level(module, pragmas, out)
        return out

    # -- classification -------------------------------------------------------

    def _classify(
        self, module: Module, node: ast.AST, facts: Dict[str, str]
    ) -> Optional[str]:
        """'set' | 'dict' | 'listing' for an unordered iterable
        expression, None when unknown/pinned."""
        if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
            return "set"
        if isinstance(node, ast.Name):
            return facts.get(node.id)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
        ):
            return self._classify(
                module, node.left, facts
            ) or self._classify(module, node.right, facts)
        if isinstance(node, ast.Call):
            name = call_name(node)
            if not name:
                return None
            resolved = module.resolve_alias(name)
            tail = name.rsplit(".", 1)[-1]
            if resolved == "sorted" or tail == "sort":
                return None  # pinned
            if resolved in ("set", "frozenset"):
                return "set"
            if resolved in _LISTING_CALLS:
                return "listing"
            if resolved == "dict":
                return "dict"
            if "." in name and tail in _SET_METHODS:
                recv = node.func.value if isinstance(
                    node.func, ast.Attribute
                ) else None
                if (
                    self._classify(module, recv, facts) == "set"
                    if recv is not None
                    else False
                ):
                    return "set"
                return None
            if "." in name and tail in _DICT_METHODS:
                return "dict"
        return None

    def _bind_facts(
        self, module: Module, stmt: ast.Assign, facts: Dict[str, str]
    ) -> None:
        kind = None
        value = stmt.value
        if isinstance(value, (ast.Set, ast.SetComp)):
            kind = "set"
        elif isinstance(value, (ast.Dict, ast.DictComp)):
            kind = "dict"
        elif isinstance(value, ast.Call):
            name = call_name(value)
            resolved = module.resolve_alias(name) if name else ""
            if resolved in ("set", "frozenset"):
                kind = "set"
            elif resolved in ("dict", "collections.OrderedDict"):
                kind = "dict"
            elif resolved in _LISTING_CALLS:
                kind = "listing"
            elif resolved == "sorted":
                kind = None
        for target in stmt.targets:
            if isinstance(target, ast.Name):
                if kind is None:
                    facts.pop(target.id, None)
                else:
                    facts[target.id] = kind

    # -- sink-function detection ----------------------------------------------

    def _is_order_sink(self, module: Module, fn: FunctionInfo) -> bool:
        if _SINK_NAME_RE.search(fn.name):
            return True
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if not name:
                continue
            resolved = module.resolve_alias(name)
            tail = name.rsplit(".", 1)[-1]
            if tail in _SINK_CALL_TAILS or resolved.startswith("hashlib."):
                return True
        return False

    # -- scanning -------------------------------------------------------------

    _MESSAGES = {
        "set": (
            "iterating a set/frozenset into an order-sensitive path — "
            "per-process hash salting makes the order nondeterministic; "
            "wrap in sorted(...)"
        ),
        "listing": (
            "unsorted directory listing — os.listdir/glob order is "
            "filesystem-dependent, so replay/pack order would vary per "
            "host; wrap in sorted(...)"
        ),
        "dict": (
            "dict iteration inside an order sink (packing/key/journal "
            "construction) — insertion order is deterministic only if "
            "the inserts were; wrap in sorted(...) or justify with "
            "# docqa-lint: ordered(<reason>)"
        ),
    }

    def _flag(
        self,
        module: Module,
        node: ast.AST,
        symbol: str,
        kind: str,
        pragmas: Dict[int, str],
        out: List[Finding],
    ) -> None:
        line = getattr(node, "lineno", 1)
        if line in pragmas:
            return
        out.append(
            Finding(self.rule, module.relpath, line, symbol,
                    self._MESSAGES[kind])
        )

    def _scan_iterables(
        self,
        module: Module,
        root: ast.AST,
        symbol: str,
        facts: Dict[str, str],
        dict_sinks: bool,
        pragmas: Dict[int, str],
        out: List[Finding],
    ) -> None:
        """Flag unordered iterates under ``root`` (no nested defs)."""
        # the root itself may be the function whose body we're scanning —
        # the nested-def guard below must only prune defs BELOW it
        if isinstance(root, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack = list(ast.iter_child_nodes(root))
        else:
            stack = [root]
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name and module.resolve_alias(name) == "sorted":
                    # everything under sorted(...) is order-pinned at
                    # this level — an unordered iterate inside is fine
                    continue
            iters: List[ast.AST] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters = [node.iter]
            elif isinstance(
                node,
                (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
            ):
                iters = [g.iter for g in node.generators]
            for it in iters:
                kind = self._classify(module, it, facts)
                if kind in ("set", "listing"):
                    self._flag(module, it, symbol, kind, pragmas, out)
                elif kind == "dict" and dict_sinks:
                    self._flag(module, it, symbol, kind, pragmas, out)
            if isinstance(node, ast.Assign):
                self._bind_facts(module, node, facts)
            stack.extend(ast.iter_child_nodes(node))

    def _scan_fn(
        self,
        module: Module,
        fn: FunctionInfo,
        pragmas: Dict[int, str],
        out: List[Finding],
    ) -> None:
        facts: Dict[str, str] = {}
        # facts need statement order; the stack walk above visits in
        # reverse, so pre-seed facts with a linear pass first
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign):
                self._bind_facts(module, node, facts)
            elif isinstance(node, ast.Call):
                # names.sort() pins a listing in place
                name = call_name(node)
                if name.endswith(".sort") and "." in name:
                    facts.pop(name.rsplit(".", 1)[0], None)
        self._scan_iterables(
            module,
            fn.node,
            fn.qualname,
            facts,
            self._is_order_sink(module, fn),
            pragmas,
            out,
        )

    def _scan_module_level(
        self, module: Module, pragmas: Dict[int, str], out: List[Finding]
    ) -> None:
        facts: Dict[str, str] = {}
        for stmt in module.tree.body:
            if isinstance(stmt, ast.Assign):
                self._bind_facts(module, stmt, facts)
        for stmt in module.tree.body:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            self._scan_iterables(
                module, stmt, "<module>", facts, False, pragmas, out
            )
