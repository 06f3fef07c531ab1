"""shed-taxonomy: every request-path raise is a LEDGERED typed shed, and
device faults pass every catch-all, counterpart of
``docqa_tpu/analysis/shed_taxonomy.py``.

The serving chain's failure surface is a closed taxonomy
(``shed_taxonomy.json``, in the profile's ``ledger_dir``): each shed class
carries its declared HTTP status, cost-ledger outcome and trace flag in one
reviewed file.  Sub-rules:

1. **unledgered raise** — every ``raise`` in a function reachable from the
   profile's ``request_path_modules`` (BFS over the package call graph)
   must name a ledgered class.  Bare ``Exception`` / ``RuntimeError`` /
   ``BaseException`` / ``TimeoutError`` raises are findings; validation
   builtins (``ValueError``, ``TypeError``, ...) are programming-error
   raises, not sheds, and pass.  Re-raises pass; so does raising a helper
   call whose arguments name a ledgered class.
2. **undeclared / stale taxonomy** — a package class whose base chain
   reaches a ledgered class must itself be ledgered, and every entry must
   still name a class defined in its declared module (stale entries fail).
   Entries carry ``http_status``, ``cost_outcome`` and ``trace_flag``.
3. **subtype swallow** — an ``except C`` handler on the request path that
   catches a ledgered class whose ledgered SUBCLASS declares a different
   HTTP status loses that subtype's contract, unless an earlier handler
   of the same try caught the subtype or the handler re-raises.
4. **device faults pass** (the port's) — the ledger's ``faults`` section
   declares the errors that are not sheds (a failed kernel, a lost rank, a
   CUDA error): they must reach the top of the request unchanged.  A
   request-path handler that catches one of them (a bare ``except``,
   ``Exception``, ``BaseException``, or a declared base of a fault such as
   ``RuntimeError``), neither re-raises nor consults a device-fault
   predicate (the profile's ``device_fault_predicates``:
   ``is_device_fault``), nor hands the caught error on (stores it, or
   passes it to a call that is not a log call), and was not preceded in
   its try by a handler that lets the faults through, swallows them: a
   finding.  Raising a declared fault is not an unledgered raise.  A
   declared fault class that is gone from its module is stale.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.core import (
    Finding,
    FunctionInfo,
    Package,
    call_name,
    dotted_name,
    load_json,
    package_ledger_path,
    stmt_walk,
)

LEDGER_NAME = "shed_taxonomy.json"

# builtin raises that are programming-error/validation contracts, not
# load sheds
_VALIDATION_BUILTINS = frozenset(
    {
        "ValueError", "TypeError", "KeyError", "IndexError",
        "AttributeError", "NotImplementedError", "AssertionError",
        "StopIteration", "StopAsyncIteration", "FileNotFoundError",
        "OSError", "IOError", "GeneratorExit", "KeyboardInterrupt",
    }
)

# raising one of these bare is always a finding on the request path
_BARE_GENERICS = frozenset(
    {"Exception", "RuntimeError", "BaseException", "TimeoutError"}
)

# what a catch-all catches
_CATCH_ALLS = frozenset({"Exception", "BaseException"})


def default_ledger_path() -> str:
    """The port's checked-in taxonomy:
    ``docqa_tpu_torch/analysis/shed_taxonomy.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), LEDGER_NAME)


def load_ledger(path: Optional[str]) -> Dict:
    return load_json(path, sheds={}, faults={})


def request_path_functions(package: Package) -> Set[int]:
    """id()s of every function reachable from a request-path module via
    the chassis call resolution (BFS; unresolvable calls don't extend the
    frontier)."""
    reachable: Dict[int, FunctionInfo] = {}
    frontier: List[FunctionInfo] = []
    for fn in package.functions:
        if (
            fn.module.relname in package.profile.request_path_modules
            or fn.module.request_path_pragma
        ):
            reachable[id(fn)] = fn
            frontier.append(fn)
    while frontier:
        fn = frontier.pop()
        for node in stmt_walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            callee = package.resolve_call(fn, node)
            if callee is not None and id(callee) not in reachable:
                reachable[id(callee)] = callee
                frontier.append(callee)
    return set(reachable)


class ShedTaxonomyChecker:
    rule = "shed-taxonomy"

    def __init__(self, ledger_path: Optional[str] = None):
        self._ledger_path = ledger_path

    def check(self, package: Package) -> List[Finding]:
        path = (
            self._ledger_path
            or package_ledger_path(package, LEDGER_NAME)
            or default_ledger_path()
        )
        ledger = load_ledger(path)
        sheds: Dict[str, Dict] = ledger["sheds"]
        faults: Dict[str, Dict] = ledger["faults"]
        out: List[Finding] = []
        class_defs = self._class_defs(package)
        out.extend(self._check_ledger(package, sheds, class_defs))
        out.extend(self._check_stale_faults(package, faults, class_defs))
        out.extend(self._check_subclasses(sheds, class_defs))
        fault_catchers = self._fault_catchers(faults, class_defs)
        reachable = request_path_functions(package)
        predicates = package.profile.device_fault_predicates
        for fn in package.functions:
            if id(fn) not in reachable:
                continue
            out.extend(self._check_raises(fn, sheds, faults))
            out.extend(self._check_handlers(fn, sheds, class_defs))
            if faults:
                out.extend(
                    self._check_fault_swallow(
                        fn, fault_catchers, predicates,
                        package.profile.phi_log_receivers,
                    )
                )
        return out

    # -- ledger integrity -----------------------------------------------------

    @staticmethod
    def _class_defs(
        package: Package,
    ) -> Dict[str, Tuple[str, int, str, List[str]]]:
        """name -> (module_name, lineno, relpath, base names)."""
        defs: Dict[str, Tuple[str, int, str, List[str]]] = {}
        for module in package.modules:
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases = [
                    dotted_name(b).rsplit(".", 1)[-1]
                    for b in node.bases
                    if dotted_name(b)
                ]
                defs[node.name] = (
                    module.name, node.lineno, module.relpath, bases,
                )
        return defs

    def _check_ledger(
        self, package: Package, sheds: Dict[str, Dict], class_defs
    ) -> List[Finding]:
        """Stale entries (declared class gone from its module) and
        malformed entries (missing status/outcome/flag), for entries whose
        module is in this package."""
        out: List[Finding] = []
        module_names = {m.name for m in package.modules}
        by_name = {m.name: m for m in package.modules}
        for name, entry in sorted(sheds.items()):
            declared_module = entry.get("module", "")
            if declared_module not in module_names:
                continue
            module = by_name[declared_module]
            defined = class_defs.get(name)
            if defined is None or defined[0] != declared_module:
                out.append(
                    Finding(
                        self.rule,
                        module.relpath,
                        1,
                        "<ledger>",
                        f"stale shed_taxonomy entry: class {name} is not "
                        f"defined in {declared_module}",
                    )
                )
                continue
            missing = [
                k
                for k in ("http_status", "cost_outcome", "trace_flag")
                if k not in entry
            ]
            if missing:
                out.append(
                    Finding(
                        self.rule,
                        defined[2],
                        defined[1],
                        name,
                        f"shed_taxonomy entry for {name} is missing "
                        f"{', '.join(missing)}",
                    )
                )
        return out

    def _check_stale_faults(
        self, package: Package, faults: Dict[str, Dict], class_defs
    ) -> List[Finding]:
        out: List[Finding] = []
        by_name = {m.name: m for m in package.modules}
        for name, entry in sorted(faults.items()):
            module = by_name.get(entry.get("module", ""))
            if module is None:
                continue  # declared outside this package (torch's errors)
            defined = class_defs.get(name)
            if defined is None or defined[0] != module.name:
                out.append(
                    Finding(
                        self.rule,
                        module.relpath,
                        1,
                        "<ledger>",
                        f"stale shed_taxonomy fault: class {name} is not "
                        f"defined in {module.name}",
                    )
                )
        return out

    def _ledger_bases(
        self, name: str, sheds: Dict[str, Dict], class_defs
    ) -> Set[str]:
        """Transitive base-name closure of a class, through both the
        package class defs and the ledger's declared bases."""
        seen: Set[str] = set()
        frontier = [name]
        while frontier:
            n = frontier.pop()
            bases: List[str] = []
            if n in class_defs:
                bases.extend(class_defs[n][3])
            if n in sheds:
                bases.extend(sheds[n].get("bases", []))
            for b in bases:
                if b not in seen:
                    seen.add(b)
                    frontier.append(b)
        return seen

    def _check_subclasses(
        self, sheds: Dict[str, Dict], class_defs
    ) -> List[Finding]:
        """A package class subclassing a ledgered shed must be ledgered
        itself."""
        out: List[Finding] = []
        if not sheds:
            return out
        for name, (mod, lineno, relpath, _bases) in sorted(
            class_defs.items()
        ):
            if name in sheds:
                continue
            chain = self._ledger_bases(name, sheds, class_defs)
            hit = sorted(chain & set(sheds))
            if hit:
                out.append(
                    Finding(
                        self.rule,
                        relpath,
                        lineno,
                        name,
                        f"typed shed {name} (subclass of {hit[0]}) is not "
                        "declared in shed_taxonomy.json",
                    )
                )
        return out

    # -- raise sites ----------------------------------------------------------

    @staticmethod
    def _raised_class(node: ast.Raise) -> Optional[str]:
        """Syntactic class name of a raise, or None when the raised value
        is dynamic (re-raised binding, stored error, lowercase helper)."""
        exc = node.exc
        if exc is None:
            return None  # bare re-raise
        if isinstance(exc, ast.Call):
            name = call_name(exc)
        else:
            name = dotted_name(exc)
        if not name:
            return None
        tail = name.rsplit(".", 1)[-1]
        if not tail or not tail[0].isupper():
            return None  # helper call / variable — not a class name
        return tail

    def _check_raises(
        self, fn: FunctionInfo, sheds: Dict[str, Dict], faults: Dict[str, Dict]
    ) -> List[Finding]:
        out: List[Finding] = []
        ledgered = set(sheds) | set(faults)
        for node in stmt_walk(fn.node):
            if not isinstance(node, ast.Raise):
                continue
            tail = self._raised_class(node)
            if tail is None:
                continue
            if tail in ledgered or tail in _VALIDATION_BUILTINS:
                continue
            if isinstance(node.exc, ast.Call):
                arg_names = {
                    n
                    for a in list(node.exc.args)
                    + [kw.value for kw in node.exc.keywords]
                    for n in (
                        dotted_name(c).rsplit(".", 1)[-1]
                        for c in ast.walk(a)
                        if isinstance(c, (ast.Name, ast.Attribute))
                    )
                    if n
                }
                if arg_names & ledgered:
                    continue  # wraps/forwards a ledgered instance
            if tail in _BARE_GENERICS:
                message = (
                    f"bare {tail} raised on the request path — raise a "
                    "typed shed declared in shed_taxonomy.json"
                )
            else:
                message = (
                    f"{tail} raised on the request path is not declared "
                    "in shed_taxonomy.json"
                )
            out.append(
                Finding(
                    self.rule, fn.module.relpath, node.lineno, fn.qualname,
                    message,
                )
            )
        return out

    # -- catch sites ----------------------------------------------------------

    @staticmethod
    def _handler_names(handler: ast.ExceptHandler) -> List[str]:
        t = handler.type
        if t is None:
            return []
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        return [
            dotted_name(e).rsplit(".", 1)[-1]
            for e in elts
            if dotted_name(e)
        ]

    def _check_handlers(
        self, fn: FunctionInfo, sheds: Dict[str, Dict], class_defs
    ) -> List[Finding]:
        out: List[Finding] = []
        for node in stmt_walk(fn.node):
            if not isinstance(node, ast.Try):
                continue
            caught_earlier: Set[str] = set()
            for handler in node.handlers:
                names = self._handler_names(handler)
                reraises = any(
                    isinstance(n, ast.Raise) for n in ast.walk(handler)
                )
                for cname in names:
                    if cname in sheds and not reraises:
                        c_status = sheds[cname].get("http_status")
                        for sname, sentry in sorted(sheds.items()):
                            if sname == cname or sname in caught_earlier:
                                continue
                            if cname not in self._ledger_bases(
                                sname, sheds, class_defs
                            ):
                                continue
                            if sentry.get("http_status") == c_status:
                                continue
                            out.append(
                                Finding(
                                    self.rule,
                                    fn.module.relpath,
                                    handler.lineno,
                                    fn.qualname,
                                    f"except {cname} swallows subtype "
                                    f"{sname} (declared status "
                                    f"{sentry.get('http_status')} != "
                                    f"{c_status}) — catch the subtype "
                                    "first or re-raise",
                                )
                            )
                caught_earlier.update(names)
        return out

    # -- device faults --------------------------------------------------------

    def _fault_catchers(self, faults: Dict[str, Dict], class_defs) -> Set[str]:
        """Class names whose ``except`` catches a declared fault: the
        catch-alls, every declared fault and every base in its chain."""
        out = set(_CATCH_ALLS)
        for name, entry in faults.items():
            out.add(name)
            out.update(entry.get("bases", []))
            out |= self._ledger_bases(name, {}, class_defs)
        return out

    @staticmethod
    def _hands_on(handler: ast.ExceptHandler, log_receivers) -> bool:
        """The handler passes the caught error on: it stores the bound name
        (``item.error = e``) or hands it, bare, to a call that is not a log
        call (``fut.set_exception(e)``, ``self._worker_died(e)``)."""
        bound = handler.name
        if bound is None:
            return False

        def is_bound(n: ast.AST) -> bool:
            return isinstance(n, ast.Name) and n.id == bound

        for n in ast.walk(handler):
            if isinstance(n, ast.Assign) and is_bound(n.value) and any(
                isinstance(t, (ast.Attribute, ast.Subscript)) for t in n.targets
            ):
                return True
            args = list(n.args) + [k.value for k in n.keywords] if isinstance(
                n, ast.Call) else []
            # bare, or an element of a tuple / list argument
            args += [e for a in args if isinstance(a, (ast.Tuple, ast.List))
                     for e in a.elts]
            if isinstance(n, ast.Call) and any(is_bound(a) for a in args):
                name = call_name(n)
                if name.split(".")[0] not in log_receivers and name not in (
                    "print", "repr", "str", "format", "type", "isinstance",
                ):
                    return True
        return False

    def _check_fault_swallow(
        self, fn: FunctionInfo, catchers: Set[str], predicates, log_receivers
    ) -> List[Finding]:
        out: List[Finding] = []
        for node in stmt_walk(fn.node):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                names = self._handler_names(handler)
                catches = handler.type is None or bool(set(names) & catchers)
                if not catches:
                    continue
                passes = any(
                    isinstance(n, ast.Raise)
                    or (
                        isinstance(n, ast.Call)
                        and call_name(n).rsplit(".", 1)[-1] in predicates
                    )
                    for n in ast.walk(handler)
                ) or self._hands_on(handler, log_receivers)
                if passes:
                    # its catch-all successors see no fault this one let by
                    break
                what = "bare except" if handler.type is None else (
                    "except " + ", ".join(names)
                )
                out.append(
                    Finding(
                        self.rule,
                        fn.module.relpath,
                        handler.lineno,
                        fn.qualname,
                        f"{what} on the request path swallows device "
                        "faults (shed_taxonomy.json faults) — re-raise "
                        "when is_device_fault(e)",
                    )
                )
        return out
