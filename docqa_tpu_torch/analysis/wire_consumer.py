"""wire-consumer: every wire read resolves to a declared producer key,
counterpart of ``docqa_tpu/analysis/wire_consumer.py``.

The spec-shape technique applied to the service wire: producers and
consumers of the same payload live in DIFFERENT modules by design
(``service/pipeline.py`` publishes broker bodies its own Consumer
handlers read back; ``scripts/soak.py`` reads HTTP payloads
``service/app.py`` serves; ``scripts/perf_gate.py`` resolves dotted
paths into ``bench.py``'s DETAILS sections) — nothing structural keeps
the key names in sync, so this rule cross-references package-wide
producer facts against every consumer read:

* **HTTP** — a function whose body calls ``urlopen`` and returns
  ``json.loads(...)`` (bare or as one tuple element) is a fetch helper;
  an ``(await client.get(url)).json()`` chain tags the same way.  The
  call site's literal/f-string URL (f-string holes normalize to ``{}``,
  query strings strip) must match exactly one ``api_contract.json``
  route — an unmatched URL is an undeclared-endpoint finding — and the
  payload variable is then tagged with that entry's response tree:
  every ``var["k"]`` / ``var.get("k")`` read must name a declared key
  (``"*"`` maps accept anything).  Tags flow through assignment,
  iteration, ``zip``, slicing, and comprehensions; an unresolvable
  value is simply untagged — ambiguity never guesses.
* **broker** — ``publish(queue, {...})`` / ``_publish(queue, {...})``
  dict literals are producer facts per queue (queues normalize to the
  literal value or the trailing config attribute name);
  ``Consumer(broker, queue, handler)`` wires a handler whose first
  body-batch parameter reads are checked against that queue's producer
  keys.  A producer key NO wired consumer reads is an orphan finding at
  the publish site — schema freight nobody consumes is drift waiting
  to be load-bearing.
* **bench details** — ``DETAILS["section"] = {...}`` literals in
  ``bench.py`` (in-package, or the profile's ``bench_file`` resolved next
  to the contract; the port has no benchmark yet) close a
  section's key set; dotted-path string literals anywhere in the
  package (``"qa_e2e.p50_ms"``) and ``perf_baseline.json`` entry paths
  whose first segment names a closed section must name one of its keys.
  Call-assigned, ``.update(non-literal)``, and variable-keyed sections
  stay open and are never checked.
* **journal** — in functions whose qualname mentions ``journal`` or
  ``replay``, a variable assigned from ``json.loads(...)`` carries the
  contract's ``journal_record`` spec; undeclared reads flag.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Any, Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    dotted_name,
)
from docqa_tpu_torch.analysis.wire_schema import (
    LEDGER_NAME,
    load_contract,
    resolve_contract_path,
    sibling_path,
    spec_child,
)

_DOTTED_RE = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)+$")
_METHODS = frozenset({"GET", "POST", "PUT", "DELETE", "PATCH"})


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _str_template(node: ast.AST) -> Optional[str]:
    """Literal / f-string / ``a + b`` string expression -> template with
    ``{}`` holes; None when no literal part survives."""
    s = _const_str(node)
    if s is not None:
        return s
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
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _str_template(node.left)
        right = _str_template(node.right)
        left = "{}" if left is None else left
        right = "{}" if right is None else right
        if left == "{}" and right == "{}":
            return None
        return left + right
    return None


# ---------------------------------------------------------------------------
# contract route matching
# ---------------------------------------------------------------------------


def _route_sample(path: str) -> str:
    """Contract path -> a concrete sample ("/api/trace/{trace_id}" ->
    "/api/trace/X") the template regex is matched against."""
    return re.sub(r"\{[^}]*\}", "X", path)


def match_endpoint(
    template: str,
    endpoints: Dict[str, Any],
    method: Optional[str] = None,
) -> Tuple[Optional[str], bool]:
    """(matched endpoint key or None, matched-anything flag).

    The template's literal query string is stripped, ``{}`` holes become
    ``.*``; it must match exactly one contract route's sample path (or
    several whose specs are identical — then the first wins).
    """
    t = template.split("?", 1)[0]
    if "/" not in t:
        return None, True  # not a URL-ish string: out of scope
    parts = re.split(r"(\{\})", t)
    body = "".join(
        ".*" if p == "{}" else re.escape(p) for p in parts if p
    )
    pattern = re.compile(("^" if t.startswith("/") else "^.*") + body + "$")
    hits = []
    for key in sorted(endpoints):
        m, _, path = key.partition(" ")
        if method is not None and m != method:
            continue
        if pattern.match(_route_sample(path)):
            hits.append(key)
    if len(hits) == 1:
        return hits[0], True
    if len(hits) > 1:
        specs = {
            json.dumps(endpoints[k].get("response"), sort_keys=True)
            for k in hits
        }
        if len(specs) == 1:
            return hits[0], True
        return None, True  # ambiguous: tag nothing, flag nothing
    return None, False


# ---------------------------------------------------------------------------
# spec environment: tag propagation + read checking inside one function
# ---------------------------------------------------------------------------


class _SpecEnv:
    """name -> spec node (dict tree / [elem] / scalar str / None)."""

    def __init__(self) -> None:
        self.specs: Dict[str, Tuple[Any, str]] = {}  # name -> (spec, origin)

    def tag(self, name: str, spec: Any, origin: str) -> None:
        if spec is None:
            self.specs.pop(name, None)
        else:
            self.specs[name] = (spec, origin)

    def spec_of(self, node: ast.AST) -> Optional[Tuple[Any, str]]:
        """Spec carried by an expression: a tagged Name, a slice of a
        tagged list, an index into a tagged list."""
        if isinstance(node, ast.Name):
            return self.specs.get(node.id)
        if isinstance(node, ast.Subscript):
            base = self.spec_of(node.value)
            if base is None:
                return None
            spec, origin = base
            if isinstance(spec, list) and len(spec) == 1:
                if isinstance(node.slice, ast.Slice):
                    return spec, origin
                if _const_str(node.slice) is None:
                    return spec[0], origin
            return None
        return None


def _iter_elem(env: _SpecEnv, it: ast.AST) -> Optional[Tuple[Any, str]]:
    """Spec of one element when iterating ``it``."""
    got = env.spec_of(it)
    if got is None:
        return None
    spec, origin = got
    if isinstance(spec, list) and len(spec) == 1:
        return spec[0], origin
    return None


def _bind_loop(env: _SpecEnv, target: ast.AST, it: ast.AST) -> None:
    if isinstance(target, ast.Name):
        elem = _iter_elem(env, it)
        if elem is not None:
            env.tag(target.id, elem[0], elem[1])
        return
    # for a, b, c in zip(xs, ys, zs)
    if (
        isinstance(target, ast.Tuple)
        and isinstance(it, ast.Call)
        and call_name(it).rsplit(".", 1)[-1] == "zip"
        and len(it.args) == len(target.elts)
    ):
        for tgt, arg in zip(target.elts, it.args):
            if isinstance(tgt, ast.Name):
                elem = _iter_elem(env, arg)
                if elem is not None:
                    env.tag(tgt.id, elem[0], elem[1])


class _ReadChecker:
    """Shared read-checking over a tagged environment."""

    def __init__(self, rule: str, fn: FunctionInfo):
        self.rule = rule
        self.fn = fn
        self.findings: List[Finding] = []
        self.consumed: List[Tuple[str, str]] = []  # (origin, key)

    def _flag(self, node: ast.AST, key: str, origin: str) -> None:
        if self.fn.module.is_suppressed(self.rule, node.lineno):
            return
        self.findings.append(
            Finding(
                self.rule,
                self.fn.module.relpath,
                node.lineno,
                self.fn.qualname,
                f"reads key '{key}' that no producer declares for "
                f"{origin}",
            )
        )

    def check_read(
        self, env: _SpecEnv, node: ast.AST, key: str, base: ast.AST
    ) -> Optional[Tuple[Any, str]]:
        got = env.spec_of(base)
        if got is None:
            return None
        spec, origin = got
        if not isinstance(spec, dict):
            return None
        self.consumed.append((origin, key))
        child = spec_child(spec, key)
        if child is None:
            self._flag(node, key, origin)
            return None
        return child, origin

    def walk(self, env: _SpecEnv, root: ast.AST) -> None:
        """Three passes: (1+2) propagate tags through assignments and
        loops to a fixpoint, (3) check every subscript/.get read."""
        for _ in range(2):
            for node in ast.walk(root):
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    _bind_loop(env, node.target, node.iter)
                elif isinstance(node, ast.comprehension):
                    _bind_loop(env, node.target, node.iter)
                elif isinstance(node, ast.Assign) and len(
                    node.targets
                ) == 1 and isinstance(node.targets[0], ast.Name):
                    tgt = node.targets[0].id
                    value = node.value
                    # var = tagged["k"] / tagged.get("k", d) propagates
                    sub = self._read_spec(env, value)
                    if sub is not None:
                        env.tag(tgt, sub[0], sub[1])
                    else:
                        got = env.spec_of(value)
                        if got is not None:
                            env.tag(tgt, got[0], got[1])
        for node in ast.walk(root):
            if isinstance(node, ast.Subscript):
                key = _const_str(node.slice)
                if key is not None:
                    self.check_read(env, node, key, node.value)
            elif isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr == "get"
                    and node.args
                ):
                    key = _const_str(node.args[0])
                    if key is not None:
                        self.check_read(env, node, key, func.value)

    def _read_spec(
        self, env: _SpecEnv, value: ast.AST
    ) -> Optional[Tuple[Any, str]]:
        """Spec of ``tagged["k"]`` / ``tagged.get("k")`` expressions
        (silent: checking happens in the read pass)."""
        if isinstance(value, ast.Subscript):
            key = _const_str(value.slice)
            if key is not None:
                got = env.spec_of(value.value)
                if got is not None and isinstance(got[0], dict):
                    child = spec_child(got[0], key)
                    if child is not None:
                        return child, got[1]
        if isinstance(value, ast.Call):
            func = value.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "get"
                and value.args
            ):
                key = _const_str(value.args[0])
                if key is not None:
                    got = env.spec_of(func.value)
                    if got is not None and isinstance(got[0], dict):
                        child = spec_child(got[0], key)
                        if child is not None:
                            return child, got[1]
        return None


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------


def _queue_id(node: ast.AST) -> Optional[str]:
    """Literal queue name, or the trailing attribute of a config chain
    (``cfg.broker.raw_queue`` -> ``raw_queue``).  A bare Name is a local
    variable — no fact (the ``_publish(queue, body)`` forwarding helper
    must not register a queue called 'queue')."""
    s = _const_str(node)
    if s is not None:
        return s
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


class WireConsumerChecker:
    rule = "wire-consumer"

    def __init__(
        self,
        ledger_path: Optional[str] = None,
        bench_path: Optional[str] = None,
        perf_baseline_path: Optional[str] = None,
    ):
        self._ledger_path = ledger_path
        self._bench_path = bench_path
        self._perf_baseline_path = perf_baseline_path

    def check(self, package: Package) -> List[Finding]:
        contract = load_contract(
            resolve_contract_path(package, self._ledger_path)
        )
        out: List[Finding] = []
        out.extend(self._http_checks(package, contract))
        out.extend(self._broker_checks(package))
        out.extend(self._bench_checks(package))
        out.extend(self._journal_checks(package, contract))
        return out

    # -- HTTP -----------------------------------------------------------------

    @staticmethod
    def _fetch_helpers(package: Package) -> Dict[str, Optional[int]]:
        """helper bare name -> tuple index of the JSON payload in its
        return value (None = the whole return IS the payload)."""
        helpers: Dict[str, Optional[int]] = {}
        for fn in package.functions:
            has_urlopen = any(
                isinstance(n, ast.Call)
                and call_name(n).rsplit(".", 1)[-1] == "urlopen"
                for n in ast.walk(fn.node)
            )
            if not has_urlopen:
                continue
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Return) or node.value is None:
                    continue
                v = node.value
                if WireConsumerChecker._is_json_loads(v):
                    helpers[fn.name] = None
                elif isinstance(v, ast.Tuple):
                    for i, elt in enumerate(v.elts):
                        if WireConsumerChecker._is_json_loads(elt):
                            helpers[fn.name] = i
                            break
        return helpers

    @staticmethod
    def _is_json_loads(node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and call_name(node).rsplit(
            ".", 1
        )[-1] == "loads"

    @staticmethod
    def _call_url(call: ast.Call) -> Optional[str]:
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            t = _str_template(a)
            if t is not None and "/" in t:
                return t
        return None

    @staticmethod
    def _call_method(call: ast.Call) -> Optional[str]:
        for a in call.args:
            s = _const_str(a)
            if s in _METHODS:
                return s
        return None

    def _http_payload_call(
        self,
        node: ast.AST,
        helpers: Dict[str, Optional[int]],
        endpoints: Dict[str, Any],
    ) -> Optional[Tuple[Any, str, Optional[int], ast.AST]]:
        """If ``node`` is a tagged-payload-producing expression, return
        (spec, endpoint key, tuple index or None, URL-carrying node)."""
        # unwrap awaits
        while isinstance(node, ast.Await):
            node = node.value
        if not isinstance(node, ast.Call):
            return None
        tail = call_name(node).rsplit(".", 1)[-1]
        if tail in helpers:
            url = self._call_url(node)
            if url is None:
                return None
            key, matched = match_endpoint(
                url, endpoints, self._call_method(node)
            )
            if key is None:
                return ("<nomatch>", url, None, node) if not matched else None
            spec = endpoints[key].get("response")
            if spec is None:
                return None
            return spec, key, helpers[tail], node
        if tail == "json" and isinstance(node.func, ast.Attribute):
            # (await client.get(url)).json()
            inner: Any = node.func.value
            while isinstance(inner, ast.Await):
                inner = inner.value
            if isinstance(inner, ast.Call):
                m = call_name(inner).rsplit(".", 1)[-1].upper()
                if m in _METHODS:
                    url = self._call_url(inner)
                    if url is not None:
                        key, matched = match_endpoint(url, endpoints, m)
                        if key is None:
                            if not matched:
                                return "<nomatch>", url, None, inner
                            return None
                        spec = endpoints[key].get("response")
                        if spec is None:
                            return None
                        return spec, key, None, inner
        return None

    def _http_checks(
        self, package: Package, contract: Dict[str, Any]
    ) -> List[Finding]:
        endpoints = contract.get("endpoints", {})
        if not endpoints:
            return []
        helpers = self._fetch_helpers(package)
        out: List[Finding] = []
        for fn in package.functions:
            env = _SpecEnv()
            checker = _ReadChecker(self.rule, fn)
            for node in ast.walk(fn.node):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.Expr):
                    value = node.value
                if value is None:
                    continue
                got = self._http_payload_call(value, helpers, endpoints)
                if got is None:
                    continue
                spec, key, idx, url_node = got
                if spec == "<nomatch>":
                    if not fn.module.is_suppressed(
                        self.rule, node.lineno
                    ):
                        out.append(
                            Finding(
                                self.rule,
                                fn.module.relpath,
                                node.lineno,
                                fn.qualname,
                                f"HTTP request to '{key}' matches no "
                                f"route in {LEDGER_NAME}",
                            )
                        )
                    continue
                for tgt in targets:
                    if isinstance(tgt, ast.Name) and idx is None:
                        env.tag(tgt.id, spec, key)
                    elif isinstance(tgt, ast.Tuple) and idx is not None:
                        if idx < len(tgt.elts) and isinstance(
                            tgt.elts[idx], ast.Name
                        ):
                            env.tag(tgt.elts[idx].id, spec, key)
            if env.specs:
                checker.walk(env, fn.node)
            out.extend(checker.findings)
        return out

    # -- broker ---------------------------------------------------------------

    def _broker_checks(self, package: Package) -> List[Finding]:
        producers: Dict[str, Dict[str, Any]] = {}
        sites: Dict[Tuple[str, str], Tuple[FunctionInfo, int]] = {}
        consumers: Dict[str, str] = {}  # handler bare name -> queue
        for fn in package.functions:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                tail = call_name(node).rsplit(".", 1)[-1]
                if tail in ("publish", "_publish") and len(
                    node.args
                ) >= 2 and isinstance(node.args[1], ast.Dict):
                    q = _queue_id(node.args[0])
                    if q is None:
                        continue
                    spec = producers.setdefault(q, {})
                    for k, v in zip(
                        node.args[1].keys, node.args[1].values
                    ):
                        key = _const_str(k) if k is not None else None
                        if key is None:
                            continue
                        sub: Any = "any"
                        if isinstance(v, ast.Dict):
                            sub = {
                                sk: "any"
                                for sk in (
                                    _const_str(x)
                                    for x in v.keys
                                    if x is not None
                                )
                                if sk is not None
                            }
                        prev = spec.get(key)
                        if prev is None or prev == "any":
                            spec[key] = sub if prev is None else "any"
                        elif sub == "any":
                            spec[key] = "any"
                        sites.setdefault(
                            (q, key), (fn, node.lineno)
                        )
                elif tail == "Consumer" and len(node.args) >= 3:
                    q = _queue_id(node.args[1])
                    h = dotted_name(node.args[2]).rsplit(".", 1)[-1]
                    if q is not None and h:
                        consumers[h] = q
        if not producers or not consumers:
            return []
        out: List[Finding] = []
        consumed: Dict[str, Set[str]] = {}
        analyzed_queues: Set[str] = set()
        for fn in package.functions:
            q = consumers.get(fn.name)
            if q is None or q not in producers:
                continue
            params = [
                p for p in fn.params if p not in ("self", "cls")
            ]
            if not params:
                continue
            analyzed_queues.add(q)
            env = _SpecEnv()
            # first param: the batch of bodies
            env.tag(params[0], [producers[q]], f"queue '{q}'")
            checker = _ReadChecker(self.rule, fn)
            checker.walk(env, fn.node)
            out.extend(checker.findings)
            for origin, key in checker.consumed:
                if origin == f"queue '{q}'":
                    consumed.setdefault(q, set()).add(key)
        for q in sorted(analyzed_queues):
            orphan = set(producers[q]) - consumed.get(q, set())
            for key in sorted(orphan):
                fn, lineno = sites[(q, key)]
                if fn.module.is_suppressed(self.rule, lineno):
                    continue
                out.append(
                    Finding(
                        self.rule,
                        fn.module.relpath,
                        lineno,
                        fn.qualname,
                        f"publishes key '{key}' to queue '{q}' that no "
                        "wired consumer reads — orphaned producer key",
                    )
                )
        return out

    # -- bench details / dotted paths -----------------------------------------

    def _bench_facts(
        self, package: Package
    ) -> Dict[str, Optional[Set[str]]]:
        """section -> closed key set, or None when the section is open
        (call-assigned / non-literal update)."""
        trees: List[ast.AST] = [
            m.tree
            for m in package.modules
            if m.name.rsplit(".", 1)[-1] == "bench"
        ]
        bench_file = package.profile.bench_file
        if not trees and (self._bench_path or bench_file):
            path = self._bench_path or sibling_path(package, bench_file)
            if path:
                try:
                    with open(path, encoding="utf-8") as f:
                        trees = [ast.parse(f.read(), filename=path)]
                except (OSError, SyntaxError):
                    trees = []
        facts: Dict[str, Optional[Set[str]]] = {}
        for tree in trees:
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Subscript)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "DETAILS"
                ):
                    section = _const_str(node.targets[0].slice)
                    if section is None:
                        continue
                    if isinstance(node.value, ast.Dict):
                        keys = {
                            k
                            for k in (
                                _const_str(x)
                                for x in node.value.keys
                                if x is not None
                            )
                            if k is not None
                        }
                        prev = facts.get(section)
                        if section in facts and prev is None:
                            continue
                        facts[section] = (prev or set()) | keys
                    else:
                        facts[section] = None
                elif isinstance(node, ast.Call):
                    func = node.func
                    if (
                        isinstance(func, ast.Attribute)
                        and func.attr == "update"
                        and isinstance(func.value, ast.Subscript)
                        and isinstance(func.value.value, ast.Name)
                        and func.value.value.id == "DETAILS"
                    ):
                        section = _const_str(func.value.slice)
                        if section is None:
                            continue
                        if node.args and isinstance(
                            node.args[0], ast.Dict
                        ) and not node.keywords:
                            keys = {
                                k
                                for k in (
                                    _const_str(x)
                                    for x in node.args[0].keys
                                    if x is not None
                                )
                                if k is not None
                            }
                            prev = facts.get(section)
                            if section in facts and prev is None:
                                continue
                            facts[section] = (prev or set()) | keys
                        else:
                            facts[section] = None
        return facts

    def _bench_checks(self, package: Package) -> List[Finding]:
        facts = self._bench_facts(package)
        closed = {s for s, keys in facts.items() if keys is not None}
        if not closed:
            return []
        out: List[Finding] = []

        def check_path(
            dotted: str, relpath: str, lineno: int, symbol: str,
            module=None,
        ) -> None:
            head, _, rest = dotted.partition(".")
            if head not in closed or not rest:
                return
            key = rest.split(".", 1)[0]
            if key in facts[head]:  # type: ignore[operator]
                return
            if module is not None and module.is_suppressed(
                self.rule, lineno
            ):
                return
            out.append(
                Finding(
                    self.rule,
                    relpath,
                    lineno,
                    symbol,
                    f"dotted path '{dotted}' reads key '{key}' that "
                    f"bench section '{head}' never produces",
                )
            )

        for module in package.modules:
            for node in ast.walk(module.tree):
                s = _const_str(node)
                if s is None or not _DOTTED_RE.match(s):
                    continue
                check_path(
                    s, module.relpath, node.lineno, module.name,
                    module=module,
                )
        perf_file = package.profile.perf_baseline_file
        baseline = self._perf_baseline_path or (
            sibling_path(package, perf_file) if perf_file else None
        )
        if baseline:
            try:
                with open(baseline, encoding="utf-8") as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            entries = (
                data.get("metrics", data)
                if isinstance(data, dict)
                else {}
            )
            if isinstance(entries, dict):
                for name, entry in sorted(entries.items()):
                    if isinstance(entry, dict) and isinstance(
                        entry.get("path"), str
                    ):
                        check_path(
                            entry["path"],
                            "perf_baseline.json",
                            1,
                            f"<{name}>",
                        )
        return out

    # -- journal --------------------------------------------------------------

    def _journal_checks(
        self, package: Package, contract: Dict[str, Any]
    ) -> List[Finding]:
        spec = contract.get("journal_record")
        if not isinstance(spec, dict):
            return []
        out: List[Finding] = []
        for fn in package.functions:
            low = fn.qualname.lower()
            if "journal" not in low and "replay" not in low:
                continue
            env = _SpecEnv()
            for node in ast.walk(fn.node):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and self._is_json_loads(node.value)
                ):
                    env.tag(
                        node.targets[0].id, spec, "the journal record"
                    )
            if not env.specs:
                continue
            checker = _ReadChecker(self.rule, fn)
            checker.walk(env, fn.node)
            out.extend(checker.findings)
        return out
