"""wire-schema: every HTTP route serves a LEDGERED response contract,
counterpart of ``docqa_tpu/analysis/wire_schema.py``.

``api_contract.json`` (the repository root's, shared with the reference:
both apps serve the same routes) names every endpoint's response key tree,
with a per-endpoint ``version`` an amendment must bump.  This rule holds
the tree to it:

1. **undeclared route** — every route registration must have a contract
   entry keyed ``"METHOD /path"``: aiohttp's ``web.get/post/delete/...``
   calls and the port's route table of ``("METHOD", "/path",
   self.handler)`` tuples (``service/app.py``).
   The entry's ``handler`` must name the registered handler and its
   ``version`` must be a positive int.  ``TODO`` anywhere in an entry is a
   finding — the ledger is reviewed, never scaffolded.
2. **stale entry** — a contract entry whose route no longer exists
   fails (PR-3 ledger style).  Staleness only fires on a package that
   actually registers routes, so the ``scripts/`` pass doesn't report
   the whole contract stale.
3. **key drift** — where a handler's payload is DERIVABLE from the AST
   (dict-literal payloads of the profile's ``response_calls``:
   ``json_response(payload)`` and the port's ``Response(status,
   payload)``; ``payload["k"] = ...`` stores, ``payload.update({...})``),
   every produced key must be declared (NEW keys fail), and for a closed
   entry with a complete derivation every required declared key must be
   produced (REMOVED keys fail).  The profile's ``wire_key_exceptions``
   name the keys a route may produce beyond its entry, each with its
   reason.  Call-built payloads derive no facts — the live audit
   (``analysis/wire_audit.py``) covers them.
4. **journal drift** — ``_journal_write(queue, {...})`` record literals
   are held to the contract's ``journal_record`` schema: undeclared
   keys and missing required keys both fail.
5. **model reconciliation** — a contract entry naming a pydantic
   ``model`` must match it exactly (model fields ⊇ required keys,
   ⊆ declared keys); a response model in ``service/schemas.py``
   referenced by neither the contract nor any code is dead and flags.

Spec grammar (shared with wire-consumer and the Tier-B audit): leaves
are JSON type names (``"str" | "int" | "float" | "number" | "bool" |
"any" | "null"``, unions via ``"str|null"``); ``[spec]`` is a list of
``spec``; a dict maps literal keys to specs — a trailing ``?`` marks an
optional key, ``"*"`` declares an open map (arbitrary extra keys).  An
entry with ``"open": true`` requires its declared keys but tolerates
extras (delegated snapshot payloads); closed entries are exact.
Non-JSON surfaces carry ``"kind"`` (``html``/``prometheus-text``/
``sse``) instead of a response tree.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    dotted_name,
    package_dir,
    package_ledger_path,
)

LEDGER_NAME = "api_contract.json"

_HTTP_VERBS = {
    "get": "GET",
    "post": "POST",
    "put": "PUT",
    "delete": "DELETE",
    "patch": "PATCH",
}


def default_ledger_path() -> str:
    """The checked-in contract: ``<repo>/api_contract.json``."""
    return os.path.join(os.path.dirname(package_dir()), LEDGER_NAME)


def sibling_path(package: Package, name: str) -> Optional[str]:
    """A repo-root file resolved the way the contract is (fixture trees
    may carry their own ``bench.py`` / ``perf_baseline.json``)."""
    return package_ledger_path(package, name)


def load_contract(path: Optional[str]) -> Dict[str, Any]:
    if not path or not os.path.exists(path):
        return {"endpoints": {}}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    data.setdefault("endpoints", {})
    return data


def resolve_contract_path(
    package: Package, override: Optional[str] = None
) -> str:
    return (
        override
        or package_ledger_path(package, LEDGER_NAME)
        or default_ledger_path()
    )


# ---------------------------------------------------------------------------
# spec-tree helpers (shared with wire_consumer / wire_audit)
# ---------------------------------------------------------------------------


def spec_dict_keys(spec: Dict[str, Any]) -> Tuple[Set[str], Set[str], bool]:
    """(required, all declared, has "*") for a dict spec — declared names
    have the optional ``?`` stripped."""
    required: Set[str] = set()
    declared: Set[str] = set()
    star = False
    for key in spec:
        if key == "*":
            star = True
            continue
        if key.endswith("?"):
            declared.add(key[:-1])
        else:
            declared.add(key)
            required.add(key)
    return required, declared, star


def spec_child(spec: Dict[str, Any], key: str) -> Optional[Any]:
    """The declared sub-spec for ``key`` in a dict spec (``None`` when
    the key is undeclared and the dict has no ``"*"``)."""
    if key in spec:
        return spec[key]
    if key + "?" in spec:
        return spec[key + "?"]
    if "*" in spec:
        return spec["*"]
    return None


def response_dict(entry: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The entry's checkable dict spec: the response tree itself, or the
    element spec of a list-of-dicts response."""
    resp = entry.get("response")
    if isinstance(resp, dict):
        return resp
    if (
        isinstance(resp, list)
        and len(resp) == 1
        and isinstance(resp[0], dict)
    ):
        return resp[0]
    return None


# ---------------------------------------------------------------------------
# route table
# ---------------------------------------------------------------------------


class Route:
    __slots__ = ("method", "path", "handler", "module", "lineno")

    def __init__(self, method, path, handler, module, lineno):
        self.method = method
        self.path = path
        self.handler = handler
        self.module = module
        self.lineno = lineno

    @property
    def key(self) -> str:
        return f"{self.method} {self.path}"


def _route_tuple(node: ast.Tuple) -> Optional[Tuple[str, str, str]]:
    """``("METHOD", "/path", handler)`` -> (method, path, handler name)."""
    if len(node.elts) != 3:
        return None
    method, path = (_const_str(e) for e in node.elts[:2])
    if method not in _HTTP_VERBS.values() or not path or path[0] != "/":
        return None
    handler = dotted_name(node.elts[2]).rsplit(".", 1)[-1]
    return (method, path, handler) if handler else None


def route_table(package: Package) -> List[Route]:
    """Every ``web.get("/path", handler)``-style registration in the
    package (the receiver must be (an alias of) ``aiohttp.web`` or a bare
    ``web`` name — ``requests.get(url)`` never parses as a route), and
    every ``("METHOD", "/path", handler)`` tuple."""
    routes: List[Route] = []
    for module in package.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Tuple):
                got = _route_tuple(node)
                if got is not None:
                    routes.append(Route(*got, module, node.lineno))
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            method = _HTTP_VERBS.get(func.attr)
            if method is None or len(node.args) < 2:
                continue
            recv = dotted_name(func.value)
            resolved = module.resolve_alias(recv) if recv else ""
            if recv != "web" and not resolved.startswith("aiohttp"):
                continue
            path_node, handler_node = node.args[0], node.args[1]
            if not (
                isinstance(path_node, ast.Constant)
                and isinstance(path_node.value, str)
            ):
                continue
            handler = dotted_name(handler_node).rsplit(".", 1)[-1]
            if not handler:
                continue
            routes.append(
                Route(
                    method, path_node.value, handler, module, node.lineno
                )
            )
    return routes


# ---------------------------------------------------------------------------
# payload derivation
# ---------------------------------------------------------------------------


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _dict_keys_nested(node: ast.Dict) -> Dict[str, Any]:
    """Literal top-level keys; nested dict literals keep their key sets,
    everything else derives no sub-facts (None)."""
    out: Dict[str, Any] = {}
    for k, v in zip(node.keys, node.values):
        key = _const_str(k) if k is not None else None
        if key is None:
            continue
        out[key] = _dict_keys_nested(v) if isinstance(v, ast.Dict) else None
    return out


def response_parts(
    node: ast.Call, calls: Tuple[Tuple[str, int, int], ...]
) -> Optional[Tuple[Optional[ast.AST], Optional[ast.AST]]]:
    """(status node, payload node) of a response call of the profile's
    ``response_calls``, or None for any other call.  A keyword-only status
    (position -1) is the ``status=`` keyword, a positional one may also be
    passed as ``status=``; the payload is positional, or the ``payload=``
    keyword of a call whose status is positional."""
    tail = call_name(node).rsplit(".", 1)[-1]
    for name, status_pos, payload_pos in calls:
        if tail != name:
            continue
        kws = {kw.arg: kw.value for kw in node.keywords if kw.arg}
        status = kws.get("status")
        if status is None and 0 <= status_pos < len(node.args):
            status = node.args[status_pos]
        payload = (
            node.args[payload_pos] if payload_pos < len(node.args) else None
        )
        if payload is None and status_pos >= 0:
            payload = kws.get("payload")
        return status, payload
    return None


def payload_facts(
    fn: FunctionInfo,
    calls: Tuple[Tuple[str, int, int], ...] = (("json_response", -1, 0),),
) -> Tuple[Dict[str, Any], bool, bool, Dict[str, int]]:
    """(produced keys, derivation complete, any response site seen,
    key -> lineno anchors) for a route handler.

    Facts come from dict-literal payloads of the response ``calls``, local
    ``var = {...}`` dicts later passed, ``var["k"] = ...`` stores, and
    ``var.update({...})``.  A payload that is a call (or a var assigned
    from one) derives nothing and marks the derivation incomplete —
    exactness is then the live audit's job, never a guess here.
    """
    local_dicts: Dict[str, ast.Dict] = {}
    local_calls: Set[str] = set()
    sub_stores: Dict[str, Dict[str, int]] = {}
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                if isinstance(node.value, ast.Dict):
                    local_dicts[tgt.id] = node.value
                    local_calls.discard(tgt.id)
                else:
                    local_calls.add(tgt.id)
                    local_dicts.pop(tgt.id, None)
            elif isinstance(tgt, ast.Subscript) and isinstance(
                tgt.value, ast.Name
            ):
                key = _const_str(tgt.slice)
                if key is not None:
                    sub_stores.setdefault(tgt.value.id, {})[key] = (
                        node.lineno
                    )
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "update"
                and isinstance(func.value, ast.Name)
                and node.args
                and isinstance(node.args[0], ast.Dict)
            ):
                for k in node.args[0].keys:
                    key = _const_str(k) if k is not None else None
                    if key is not None:
                        sub_stores.setdefault(func.value.id, {})[key] = (
                            node.lineno
                        )

    produced: Dict[str, Any] = {}
    anchors: Dict[str, int] = {}
    complete = True
    saw_site = False

    def merge(keys: Dict[str, Any], lineno: int) -> None:
        for k, sub in keys.items():
            if k not in produced or produced[k] is None:
                produced[k] = sub
            anchors.setdefault(k, lineno)

    for node in ast.walk(fn.node):
        if not isinstance(node, ast.Call):
            continue
        parts = response_parts(node, calls)
        if parts is None:
            continue
        status_kw, payload = parts
        # error-status sites carry the {"detail"} error shape, not the
        # endpoint's 200 contract
        if (
            isinstance(status_kw, ast.Constant)
            and status_kw.value != 200
        ):
            continue
        if payload is None:
            continue
        saw_site = True
        if isinstance(payload, ast.Dict):
            merge(_dict_keys_nested(payload), node.lineno)
        elif isinstance(payload, ast.Name):
            name = payload.id
            if name in local_dicts:
                merge(_dict_keys_nested(local_dicts[name]), node.lineno)
            else:
                complete = False
            for k, ln in sub_stores.get(name, {}).items():
                merge({k: None}, ln)
        else:
            complete = False
    return produced, complete, saw_site, anchors


# ---------------------------------------------------------------------------
# pydantic models (service/schemas.py reconciliation)
# ---------------------------------------------------------------------------


def collect_models(
    package: Package,
) -> Dict[str, Tuple[Dict[str, bool], str, int, str]]:
    """Pydantic models in ``*schemas*`` modules:
    name -> (field -> has_default, module relpath, lineno, module name)."""
    models: Dict[str, Tuple[Dict[str, bool], str, int, str]] = {}
    bases_of: Dict[str, List[str]] = {}
    nodes: Dict[str, Tuple[ast.ClassDef, Any]] = {}
    for module in package.modules:
        if "schemas" not in module.name.rsplit(".", 1)[-1]:
            continue
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                bases_of[node.name] = [
                    dotted_name(b).rsplit(".", 1)[-1]
                    for b in node.bases
                    if dotted_name(b)
                ]
                nodes[node.name] = (node, module)

    def is_model(name: str, seen=()) -> bool:
        for b in bases_of.get(name, []):
            if b == "BaseModel":
                return True
            if b in bases_of and b not in seen and is_model(
                b, seen + (name,)
            ):
                return True
        return False

    for name, (node, module) in nodes.items():
        if not is_model(name):
            continue
        fields: Dict[str, bool] = {}
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                fields[stmt.target.id] = stmt.value is not None
        models[name] = (fields, module.relpath, node.lineno, module.name)
    return models


def _referenced_names(package: Package) -> Set[str]:
    """Every Name id / Attribute tail used anywhere in the package,
    class-definition bindings excluded."""
    used: Set[str] = set()
    for module in package.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                used.add(node.attr)
    return used


# ---------------------------------------------------------------------------
# checker
# ---------------------------------------------------------------------------


class WireSchemaChecker:
    rule = "wire-schema"

    def __init__(self, ledger_path: Optional[str] = None):
        self._ledger_path = ledger_path

    def check(self, package: Package) -> List[Finding]:
        path = resolve_contract_path(package, self._ledger_path)
        contract = load_contract(path)
        endpoints: Dict[str, Any] = contract.get("endpoints", {})
        out: List[Finding] = []
        routes = route_table(package)
        if routes:
            out.extend(self._check_routes(package, routes, endpoints))
            out.extend(self._check_stale(routes, endpoints))
            out.extend(self._check_models(package, endpoints))
        out.extend(self._check_journal(package, contract))
        return out

    # -- routes vs entries ----------------------------------------------------

    def _check_routes(
        self,
        package: Package,
        routes: List[Route],
        endpoints: Dict[str, Any],
    ) -> List[Finding]:
        out: List[Finding] = []
        for route in routes:
            entry = endpoints.get(route.key)
            if entry is None:
                out.append(
                    Finding(
                        self.rule,
                        route.module.relpath,
                        route.lineno,
                        route.handler,
                        f"route {route.key} is not declared in "
                        f"{LEDGER_NAME} — add a versioned entry",
                    )
                )
                continue
            if entry.get("handler") != route.handler:
                out.append(
                    Finding(
                        self.rule,
                        route.module.relpath,
                        route.lineno,
                        route.handler,
                        f"{LEDGER_NAME} entry for {route.key} names "
                        f"handler '{entry.get('handler')}' but the route "
                        f"registers '{route.handler}'",
                    )
                )
            version = entry.get("version")
            if not isinstance(version, int) or version < 1:
                out.append(
                    Finding(
                        self.rule,
                        route.module.relpath,
                        route.lineno,
                        route.handler,
                        f"{LEDGER_NAME} entry for {route.key} needs a "
                        "positive integer 'version'",
                    )
                )
            if "TODO" in json.dumps(entry):
                out.append(
                    Finding(
                        self.rule,
                        route.module.relpath,
                        route.lineno,
                        route.handler,
                        f"{LEDGER_NAME} entry for {route.key} carries a "
                        "TODO — the contract is reviewed, not scaffolded",
                    )
                )
            out.extend(self._check_payload(package, route, entry))
        return out

    def _handler_fn(
        self, package: Package, route: Route
    ) -> Optional[FunctionInfo]:
        cands = [
            fn
            for fn in package.functions
            if fn.name == route.handler and fn.module is route.module
        ]
        if len(cands) == 1:
            return cands[0]
        return None  # missing or ambiguous: never guess

    def _check_payload(
        self, package: Package, route: Route, entry: Dict[str, Any]
    ) -> List[Finding]:
        spec = response_dict(entry)
        if spec is None:
            return []
        fn = self._handler_fn(package, route)
        if fn is None:
            return []
        produced, complete, saw_site, anchors = payload_facts(
            fn, package.profile.response_calls
        )
        if not saw_site:
            return []
        out: List[Finding] = []
        required, declared, star = spec_dict_keys(spec)
        excepted = {
            key for route_key, key, _why in package.profile.wire_key_exceptions
            if route_key == route.key
        }
        for key, sub in sorted(produced.items()):
            line = anchors.get(key, fn.node.lineno)
            if fn.module.is_suppressed(self.rule, line) or key in excepted:
                continue
            if key not in declared and not star:
                out.append(
                    Finding(
                        self.rule,
                        fn.module.relpath,
                        line,
                        fn.qualname,
                        f"handler produces key '{key}' not declared for "
                        f"{route.key} in {LEDGER_NAME} — declare it and "
                        "bump the entry's version",
                    )
                )
                continue
            child = spec_child(spec, key)
            if isinstance(sub, dict) and isinstance(child, dict):
                c_req, c_decl, c_star = spec_dict_keys(child)
                for sk in sorted(sub):
                    if sk not in c_decl and not c_star:
                        out.append(
                            Finding(
                                self.rule,
                                fn.module.relpath,
                                line,
                                fn.qualname,
                                f"handler produces key '{key}.{sk}' not "
                                f"declared for {route.key} in "
                                f"{LEDGER_NAME}",
                            )
                        )
        if complete and not entry.get("open"):
            for key in sorted(required - set(produced)):
                if fn.module.is_suppressed(self.rule, fn.node.lineno):
                    continue
                out.append(
                    Finding(
                        self.rule,
                        fn.module.relpath,
                        fn.node.lineno,
                        fn.qualname,
                        f"{LEDGER_NAME} declares key '{key}' for "
                        f"{route.key} but the handler never produces it "
                        "— remove it from the contract (version bump) or "
                        "restore the field",
                    )
                )
        return out

    def _check_stale(
        self, routes: List[Route], endpoints: Dict[str, Any]
    ) -> List[Finding]:
        route_keys = {r.key for r in routes}
        anchor = routes[0].module
        out: List[Finding] = []
        for key in sorted(endpoints):
            if key not in route_keys:
                out.append(
                    Finding(
                        self.rule,
                        anchor.relpath,
                        1,
                        "<ledger>",
                        f"stale {LEDGER_NAME} entry: no route registers "
                        f"{key}",
                    )
                )
        return out

    # -- journal records ------------------------------------------------------

    def _check_journal(
        self, package: Package, contract: Dict[str, Any]
    ) -> List[Finding]:
        spec = contract.get("journal_record")
        if not isinstance(spec, dict):
            return []
        required, declared, star = spec_dict_keys(spec)
        out: List[Finding] = []
        for fn in package.functions:
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                if call_name(node).rsplit(".", 1)[-1] != "_journal_write":
                    continue
                if len(node.args) < 2 or not isinstance(
                    node.args[1], ast.Dict
                ):
                    continue
                if fn.module.is_suppressed(self.rule, node.lineno):
                    continue
                keys = set(_dict_keys_nested(node.args[1]))
                for key in sorted(keys - declared):
                    if star:
                        break
                    out.append(
                        Finding(
                            self.rule,
                            fn.module.relpath,
                            node.lineno,
                            fn.qualname,
                            f"journal record key '{key}' is not declared "
                            f"in {LEDGER_NAME} journal_record",
                        )
                    )
                for key in sorted(required - keys):
                    out.append(
                        Finding(
                            self.rule,
                            fn.module.relpath,
                            node.lineno,
                            fn.qualname,
                            f"journal record is missing required key "
                            f"'{key}' ({LEDGER_NAME} journal_record)",
                        )
                    )
        return out

    # -- pydantic model reconciliation ---------------------------------------

    def _check_models(
        self, package: Package, endpoints: Dict[str, Any]
    ) -> List[Finding]:
        models = collect_models(package)
        if not models:
            return []
        out: List[Finding] = []
        referenced_by_contract: Set[str] = set()
        for key, entry in sorted(endpoints.items()):
            model_name = entry.get("model")
            if not model_name:
                continue
            referenced_by_contract.add(model_name)
            model = models.get(model_name)
            if model is None:
                # anchor at the schemas module if one exists in-package
                relpath, lineno = next(
                    ((m[1], 1) for m in models.values()), (None, 1)
                )
                if relpath is not None:
                    out.append(
                        Finding(
                            self.rule,
                            relpath,
                            lineno,
                            "<ledger>",
                            f"{LEDGER_NAME} entry for {key} names model "
                            f"'{model_name}' which is not defined in the "
                            "schemas module",
                        )
                    )
                continue
            spec = response_dict(entry)
            if spec is None:
                continue
            fields, relpath, lineno, _mod = model
            required, declared, star = spec_dict_keys(spec)
            if package.modules and any(
                m.relpath == relpath
                and m.is_suppressed(self.rule, lineno)
                for m in package.modules
            ):
                continue
            missing = sorted(required - set(fields))
            extra = sorted(set(fields) - declared) if not star else []
            if missing or extra:
                bits = []
                if missing:
                    bits.append(f"missing contract keys {missing}")
                if extra:
                    bits.append(f"undeclared fields {extra}")
                out.append(
                    Finding(
                        self.rule,
                        relpath,
                        lineno,
                        model_name,
                        f"pydantic model {model_name} drifted from the "
                        f"{LEDGER_NAME} entry for {key}: "
                        + "; ".join(bits),
                    )
                )
        # transitive closure: models nested in referenced models stay live
        used = _referenced_names(package)
        for name, (fields, relpath, lineno, _mod) in sorted(
            models.items()
        ):
            if name in referenced_by_contract:
                continue
            if name in used:
                continue
            module = next(
                (m for m in package.modules if m.relpath == relpath), None
            )
            if module is not None and module.is_suppressed(
                self.rule, lineno
            ):
                continue
            out.append(
                Finding(
                    self.rule,
                    relpath,
                    lineno,
                    name,
                    f"dead schema model {name}: referenced by no code "
                    f"and no {LEDGER_NAME} entry",
                )
            )
        return out
