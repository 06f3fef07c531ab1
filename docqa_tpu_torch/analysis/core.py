"""docqa-lint core for the port: package model, profile, suppressions,
baseline, runner.

Counterpart of ``docqa_tpu/analysis/core.py``.  The checkers encode the
port's concurrency, lifecycle and serving-contract invariants: one global
lock order with no blocking call (I/O, a thread join, a wait on a CUDA
stream) inside a critical section, a field guarded by a lock everywhere it is guarded
anywhere, condition waits in predicate loops, every thread joined on its
owner's stop path, request deadlines threaded through and clamping every
wait, every acquired KV table, cost record, spine ticket and trace
released exactly once, and raw pre-deid text kept out of logs, metric
labels and external payloads; no device sync on /ask outside the
spine's fetch, every thread that reaches the card ledgered, one
retirement per request at declared sites, typed sheds with device faults
passing every catch-all, and the HTTP and broker wire held to
``api_contract.json``.  This module holds everything they share:

* :class:`Package` — a parsed view of the tree: one :class:`Module` per
  file (AST + per-line suppressions + import-alias map) and one
  :class:`FunctionInfo` per ``def`` (qualname, params, enclosing class),
  indexed by bare name so checkers can resolve ``self.engine.foo(...)``
  style calls without a type system;
* :class:`AnalysisProfile` — every project-specific table the rules read
  (the request-path modules, the blocking-call names, phi-taint's sources,
  sanitizers and sinks, resource-flow's protocols, the dispatch
  predicate).  Module names in it are relative to the analysed package
  (``"service.qa"``), so one analyzer runs under the port's profile
  (:data:`PORT_PROFILE`, the default) or under another project's;
* suppressions — ``# docqa-lint: disable=<rule>[,<rule>]`` on the
  *finding's* line silences that rule there (``disable=all`` silences every
  rule); ``# docqa-lint: request-path`` anywhere in a file puts it on the
  request path;
* :class:`Baseline` — a checked-in JSON ledger of accepted findings, each
  carrying a human justification.  Findings are matched by a stable
  fingerprint (rule + path + enclosing symbol + message — deliberately
  *not* the line number, so unrelated edits don't churn the file).  The
  gate fails on any NEW finding and on any STALE entry (baselined finding
  that no longer fires), keeping the ledger exactly in sync with the tree;
* :func:`run` / :func:`analyze_paths`, used by ``python -m
  docqa_tpu_torch.analysis`` and the tests.

Checkers are heuristic by design (no type inference): each documents its
resolution rules, and every rule can be silenced per line or per finding.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import (
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

_SUPPRESS_RE = re.compile(r"#\s*docqa-lint:\s*disable=([\w, -]+)")
_REQUEST_PATH_PRAGMA_RE = re.compile(r"#\s*docqa-lint:\s*request-path")


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    path: str  # package-root-relative posix path
    line: int
    symbol: str  # qualname of the enclosing function, or "<module>"
    message: str

    @property
    def fingerprint(self) -> str:
        """Stable identity for baseline matching: everything but the line
        number (line drift from unrelated edits must not churn the
        baseline; a moved-but-unchanged finding still matches)."""
        raw = "|".join((self.rule, self.path, self.symbol, self.message))
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message} ({self.symbol})"


# ---------------------------------------------------------------------------
# the project profile
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Protocol:
    """One acquire/release pairing (resource-flow and the ledger witness)."""

    name: str
    # (receiver-substring hint, attr): `hint` matches case-insensitively
    # against the dotted receiver text ("" matches bare calls too)
    acquires: Tuple[Tuple[str, str], ...]
    release_methods: FrozenSet[str]  # x.release() style
    release_funcs: FrozenSet[str]  # retire(x) style (x bare in args)
    borrow_attrs: FrozenSet[str]  # f(.., x, ..) that does NOT take custody


@dataclasses.dataclass(frozen=True)
class AnalysisProfile:
    """Every project-specific table the rules read.  Module names are
    relative to the analysed package (``"service.qa"``)."""

    # deadline-flow / cv-protocol: the /ask serving chain, whose waits are
    # request waits and which never sleep-polls
    request_path_modules: FrozenSet[str]
    # lock-discipline: attribute names whose calls block the calling thread
    lock_blocking_attrs: FrozenSet[str]
    # deadline-flow: attribute names of the waits a deadline must clamp
    wait_blocking_attrs: FrozenSet[str]
    # phi-taint
    phi_source_calls: FrozenSet[str]
    phi_source_keys: FrozenSet[str]
    phi_sanitizer_suffixes: Tuple[str, ...]
    phi_clean_calls: FrozenSet[str]
    phi_log_receivers: FrozenSet[str]
    phi_metric_attrs: FrozenSet[str]
    phi_publish_attrs: FrozenSet[str]
    phi_response_attrs: FrozenSet[str]
    # resource-flow / ledger witness
    protocols: Tuple[Protocol, ...]
    raise_prone_tails: FrozenSet[str]
    # dispatch reachability (thread-lifecycle): a call through one of these
    # import heads, a call whose attribute names device work by
    # convention, or a call resolving to one of these package-relative
    # functions enqueues device work
    dispatch_heads: Tuple[str, ...]
    dispatch_attrs: FrozenSet[str]
    dispatch_calls: FrozenSet[str]
    # lock-discipline (and the witness): declared identities of locks the
    # static view names by a receiver (``item.settle_lock``) and the
    # witness by their declaration (``_Item.settle_lock``)
    lock_aliases: Tuple[Tuple[str, str], ...] = ()
    # lock-discipline: calls that invoke one of their arguments on the
    # calling thread, by call tail -> argument position (a function passed
    # to ``mirrored(obj, name, fn, ...)`` runs as if called there)
    invokers: Tuple[Tuple[str, int], ...] = ()
    # lock-discipline: module singletons by the class they hold
    # (``DEFAULT_OBSERVATORY.record(...)`` is ``Observatory.record``)
    receiver_classes: Tuple[Tuple[str, str], ...] = ()
    # The serving-contract rules.  Every default below is the reference's
    # table, so a profile built from the reference's older tables alone is
    # the reference's profile.
    #
    # where the ledgers of dispatch-streams, retire-once and shed-taxonomy
    # live, relative to the analysed package's root; None keeps the
    # reference's convention (beside the package root, or in it)
    ledger_dir: Optional[str] = None
    # host-sync: modules it scans besides the request path; call prefixes
    # whose results live on the device; calls that are a device fetch by
    # definition; methods that sync on any receiver that is not a known
    # host value; calls that build a compiled wrapper (calling the wrapper
    # yields device values); calls whose results are host values (the
    # sanctioned fetch); "module:qualname" functions whose waits are the
    # sanctioned ones
    host_sync_modules: FrozenSet[str] = frozenset()
    host_sync_device_prefixes: Tuple[str, ...] = (
        "jnp.", "jax.numpy.", "jax.lax.", "jax.random.",
    )
    host_sync_fetch_calls: FrozenSet[str] = frozenset({"jax.device_get"})
    host_sync_methods: FrozenSet[str] = frozenset({"item", "tolist"})
    host_sync_wrapper_tails: FrozenSet[str] = frozenset(
        {"jit", "pjit", "shard_map"}
    )
    host_sync_host_calls: FrozenSet[str] = frozenset()
    host_sync_sanctioned: FrozenSet[str] = frozenset()
    # dispatch-streams: calls through a dispatch head that build a program
    # or a host object without enqueueing device work, and the spine's
    # module (calls into it are the delegation boundary)
    dispatch_wrapper_tails: FrozenSet[str] = frozenset({
        "jit", "ShapeDtypeStruct", "eval_shape", "shard_map", "tree_map",
        "TraceAnnotation", "dtype",
    })
    spine_module: str = "engines.spine"
    # the calls that put their closure on the spine, stage name first
    spine_submit_tails: FrozenSet[str] = frozenset(
        {"spine_run", "spine_submit"}
    )
    # retire-once: call tails that terminally retire a request
    retire_terminal_tails: FrozenSet[str] = frozenset(
        {"_finish", "_retire", "_fail_active"}
    )
    # shed-taxonomy: calls that tell a device fault from other errors (a
    # catch-all that consults one lets device faults through)
    device_fault_predicates: FrozenSet[str] = frozenset()
    # wire-schema / wire-safety: the calls that answer a request, as (call
    # tail, status position, payload position), -1 for keyword-only;
    # (route key, response key, reason) keys a handler may produce beyond
    # its contract entry
    response_calls: Tuple[Tuple[str, int, int], ...] = (
        ("json_response", -1, 0),
    )
    wire_key_exceptions: Tuple[Tuple[str, str, str], ...] = ()
    # wire-safety: import heads whose call results are device arrays
    device_value_heads: Tuple[str, ...] = ("jax", "jnp")
    # wire-consumer: the benchmark script and perf baseline beside the
    # package whose dotted paths it resolves (None: none)
    bench_file: Optional[str] = "bench.py"
    perf_baseline_file: Optional[str] = "perf_baseline.json"


_PROTOCOLS = (
    Protocol(
        name="kv-table",
        # engines/paged.py BlockAllocator.new_table -> BlockTable.release
        acquires=(("alloc", "new_table"),),
        release_methods=frozenset({"release"}),
        release_funcs=frozenset(),
        # prefix-cache ops map blocks in/out of a table the caller
        # still owns; ensure/grow mutate it in place
        borrow_attrs=frozenset({"acquire", "insert", "share"}),
    ),
    Protocol(
        name="cost-record",
        # obs/costs.py RequestCostLedger.open -> retire
        acquires=(("ledger", "open"),),
        release_methods=frozenset(),
        release_funcs=frozenset({"retire"}),
        borrow_attrs=frozenset({"record_shed"}),
    ),
    Protocol(
        name="spine-ticket",
        # engines/spine.py spine_submit / DispatchSpine.submit -> a
        # ticket's result() or cancel()
        acquires=(("", "spine_submit"), ("spine", "submit")),
        release_methods=frozenset({"result", "cancel"}),
        release_funcs=frozenset(),
        borrow_attrs=frozenset(),
    ),
    Protocol(
        name="trace",
        # obs/recorder.py from_headers / FlightRecorder.start -> finish
        acquires=(("", "from_headers"), ("recorder", "start")),
        release_methods=frozenset({"finish"}),
        release_funcs=frozenset({"finish", "complete", "finish_id"}),
        borrow_attrs=frozenset({"record_span", "add_event", "flag"}),
    ),
)

PORT_PROFILE = AnalysisProfile(
    # docqa_tpu_torch's /ask chain: the app's handlers, QAService, the
    # retrievers, the fused chain, the batcher, the pool in front of it,
    # the dispatch spine every device call rides and the mesh's command
    # stream (the spine and the stream stand where the reference's
    # engines/dispatch.py stands)
    request_path_modules=frozenset({
        "service.app", "service.qa", "engines.retrieve", "engines.rag_fused",
        "engines.serve", "engines.pool", "engines.spine", "runtime.mesh",
    }),
    lock_blocking_attrs=frozenset({
        "sleep", "publish", "get_many", "communicate", "urlopen", "fsync",
        "result", "drain", "wait", "set_status", "set_status_unless_deleted",
        "list_documents", "encode_texts", "deidentify_batch",
        "extract_text_ex", "load_checkpoint_dir",
        # a wait for a CUDA stream: torch.cuda.synchronize,
        # Event.synchronize, and the device fetches .item() / .tolist() /
        # .cpu() hold every thread behind the lock behind the card
        "synchronize", "item", "tolist", "cpu",
    }),
    wait_blocking_attrs=frozenset({"wait", "result", "join", "get_many"}),
    phi_source_calls=frozenset({"extract_text_ex", "extract_text"}),
    phi_source_keys=frozenset({"text"}),
    # deid/engine.py: DeidEngine.deidentify_batch / anonymize, anonymize_text
    phi_sanitizer_suffixes=(
        "deidentify_batch", "deidentify", "anonymize", "anonymize_text",
    ),
    phi_clean_calls=frozenset({
        "len", "sum", "bool", "enumerate", "range", "id", "hash", "isinstance",
    }),
    phi_log_receivers=frozenset({"log", "logger", "logging"}),
    phi_metric_attrs=frozenset({"counter", "histogram", "gauge"}),
    phi_publish_attrs=frozenset({"publish", "_publish"}),
    # service/app.py answers through Response(...) / json_error(...)
    phi_response_attrs=frozenset({"json_response", "Response", "json_error"}),
    protocols=_PROTOCOLS,
    raise_prone_tails=frozenset({
        "ensure", "grow", "share", "acquire", "check", "perturb", "result",
        "insert", "submit", "submit_request", "submit_ids", "submit_text",
    }),
    dispatch_heads=("torch",),
    # every warmup compiles and launches; spine_run / spine_submit put the
    # callable on a spine lane, whose work is device work
    dispatch_attrs=frozenset({"warmup", "spine_run", "spine_submit"}),
    # the kernel wrappers' launch funnel: ops/_kernels.py builds, loads and
    # counts every hand-written kernel launch
    dispatch_calls=frozenset({
        "ops._kernels.build", "ops._kernels.load", "ops._kernels.count",
        # engines/spine.py: where an item's closure runs (a lane's, or its
        # caller's when a slot is free)
        "engines.spine._run_item",
    }),
    # engines/spine.py: a spine item's own lock, taken through the item
    lock_aliases=(("item.settle_lock", "_Item.settle_lock"),),
    # runtime/mesh.py mirrored(obj, method, fn, *args) runs fn here (or on
    # a follower, as the same command); engines/spine.py _fenced(what, fn)
    # runs one accounting step; index/store.py _call_sink(hook, *args) runs
    # a secondary index's hook
    invokers=(("mirrored", 2), ("_fenced", 1), ("_call_sink", 0)),
    # the obs and metrics singletons every layer calls into
    receiver_classes=(
        ("DEFAULT_REGISTRY", "MetricsRegistry"),
        ("DEFAULT_COST_LEDGER", "RequestCostLedger"),
        ("DEFAULT_OBSERVATORY", "Observatory"),
        ("DEFAULT_PROFILER", "ProfilerWindow"),
        ("DEFAULT_RECORDER", "FlightRecorder"),
    ),
    # the port's ledgers are its own: docqa_tpu_torch/analysis/*.json
    ledger_dir="analysis",
    # the solo engine's decode loop runs on /ask's spine items
    host_sync_modules=frozenset({"engines.generate"}),
    host_sync_device_prefixes=("torch.",),
    # a wait for a CUDA stream
    host_sync_fetch_calls=frozenset({"torch.cuda.synchronize"}),
    host_sync_methods=frozenset({"item", "tolist", "cpu", "numpy", "synchronize"}),
    host_sync_wrapper_tails=frozenset(),
    # engines/spine.py: to_host starts an item's copy to pinned memory and
    # a ticket's result() returns once it has landed, so what spine_run /
    # result() return is on the host
    host_sync_host_calls=frozenset({
        "to_host", "spine_run", "result", "numpy.asarray", "numpy.array",
    }),
    # the item's end-event wait: the device-time read at the fetch and a
    # strict spine's wait before a slot frees
    host_sync_sanctioned=frozenset({"engines.spine:DispatchSpine._wait_end"}),
    dispatch_wrapper_tails=frozenset({
        "device", "dtype", "no_grad", "inference_mode", "set_grad_enabled",
        "is_inference_mode_enabled", "is_grad_enabled", "is_available",
        "device_count", "get_device_name", "current_device", "Event",
        "Stream", "stream", "record_function", "manual_seed", "Generator",
        "set_num_threads", "get_num_threads", "finfo", "iinfo",
    }),
    # spine_issue returns once the item has issued; the batcher's
    # _on_lane(stage, fn, ...) issues on its own CUDA stream
    spine_submit_tails=frozenset(
        {"spine_run", "spine_submit", "spine_issue", "_on_lane"}
    ),
    device_fault_predicates=frozenset({"is_device_fault"}),
    # service/app.py answers through Response(status, payload, ...)
    response_calls=(("json_response", -1, 0), ("Response", 0, 1)),
    wire_key_exceptions=(
        ("GET /api/status", "mesh",
         "the mesh's ranks and axes, present only when the runtime runs on "
         "a mesh of ranks (runtime/mesh.py); the reference has no such "
         "runtime, so its contract has no such key"),
    ),
    device_value_heads=("torch",),
    # the port has no benchmark of its own yet
    bench_file=None,
    perf_baseline_file=None,
)


# ---------------------------------------------------------------------------
# source model
# ---------------------------------------------------------------------------


def expr_text(node: Optional[ast.AST]) -> str:
    """Best-effort source text of an expression (resolution heuristics
    compare these strings; they never eval anything)."""
    if node is None:
        return ""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed synthetic nodes
        return ""


def call_name(node: ast.Call) -> str:
    """Dotted text of a call target: ``self.registry.set_status``,
    ``time.sleep``, ``print`` ...  Empty for computed targets."""
    return _dotted(node.func)


def dotted_name(node: ast.AST) -> str:
    """Dotted text of a Name/Attribute chain ("self.registry.get")."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


_dotted = dotted_name  # internal alias


def stmt_walk(root: ast.AST):
    """Walk a function body WITHOUT descending into nested defs/lambdas
    (they have their own scopes; checkers visit them separately)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class Module:
    """One parsed source file."""

    def __init__(self, path: str, relpath: str, source: str, name: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.name = name  # dotted module name
        self.tree = ast.parse(source, filename=path)
        # per-line suppressions: line -> set of rule names (or {"all"})
        self.suppressed: Dict[int, Set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                if rules:
                    self.suppressed[i] = rules
        self.request_path_pragma = bool(
            _REQUEST_PATH_PRAGMA_RE.search(source)
        )
        # local alias -> dotted origin ("np" -> "numpy",
        # "time_monotonic" -> "time.monotonic", "faults" ->
        # "docqa_tpu_torch.resilience.faults")
        self.imports: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )

    @property
    def relname(self) -> str:
        """Dotted name relative to the analysed package ("service.qa")."""
        return self.name.partition(".")[2]

    def is_suppressed(self, rule: str, line: int) -> bool:
        rules = self.suppressed.get(line)
        return bool(rules) and (rule in rules or "all" in rules)

    def resolve_alias(self, dotted: str) -> str:
        """Rewrite a call/attr chain's first segment through the import
        map: ``_time.sleep`` -> ``time.sleep``."""
        head, _, rest = dotted.partition(".")
        origin = self.imports.get(head)
        if origin is None:
            return dotted
        return f"{origin}.{rest}" if rest else origin


@dataclasses.dataclass
class FunctionInfo:
    """One ``def`` (sync or async), anywhere in a module."""

    module: Module
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str  # "Class.method" / "outer.<locals>.inner" / "func"
    class_name: Optional[str]

    @property
    def name(self) -> str:
        return self.node.name  # type: ignore[attr-defined]

    @property
    def params(self) -> List[str]:
        a = self.node.args  # type: ignore[attr-defined]
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    @property
    def has_kwargs(self) -> bool:
        return self.node.args.kwarg is not None  # type: ignore[attr-defined]


class _FunctionCollector(ast.NodeVisitor):
    def __init__(self, module: Module):
        self.module = module
        self.stack: List[str] = []
        self.class_stack: List[str] = []
        self.out: List[FunctionInfo] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()
        self.stack.pop()

    def _visit_fn(self, node) -> None:
        qual = ".".join(self.stack + [node.name])
        self.out.append(
            FunctionInfo(
                module=self.module,
                node=node,
                qualname=qual,
                class_name=self.class_stack[-1] if self.class_stack else None,
            )
        )
        self.stack.append(node.name)
        self.stack.append("<locals>")
        self.generic_visit(node)
        self.stack.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn


# Method/function names too generic for unique-bare-name call resolution:
# ``self.store.add(...)`` must not resolve to an arbitrary package function
# that happens to be called ``add``.
GENERIC_NAMES = frozenset(
    "get set add search check wait result text call run stop start close "
    "read write update append encode decode reset build load save format "
    "items keys values count copy clear pop remove join split strip "
    "submit handler body main "
    # array/statistics method names (jnp/np tracer methods must never
    # resolve to a same-named package function)
    "mean std var max min sum all any round sort take clip dot "
    "reshape astype ravel flatten squeeze transpose argmax argmin "
    "argsort cumsum prod repeat tile observe".split()
)


class Package:
    """Parsed view of every ``*.py`` under a root directory."""

    def __init__(
        self,
        modules: List[Module],
        profile: Optional[AnalysisProfile] = None,
    ):
        self.modules = modules
        self.profile = profile or PORT_PROFILE
        self.functions: List[FunctionInfo] = []
        for m in modules:
            collector = _FunctionCollector(m)
            collector.visit(m.tree)
            self.functions.extend(collector.out)
        self.by_bare_name: Dict[str, List[FunctionInfo]] = {}
        for f in self.functions:
            self.by_bare_name.setdefault(f.name, []).append(f)

    @classmethod
    def load(
        cls,
        root: str,
        package_name: Optional[str] = None,
        profile: Optional[AnalysisProfile] = None,
    ) -> "Package":
        root = os.path.abspath(root)
        if os.path.isfile(root):
            base = os.path.dirname(root)
            files = [root]
        else:
            base = root
            files = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [
                    d for d in sorted(dirnames) if d != "__pycache__"
                ]
                files.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames)
                    if f.endswith(".py")
                )
        # normalize to the PACKAGE root (outermost dir with __init__.py):
        # fingerprint paths must be identical whether the analyzer was
        # pointed at the package, a subpackage, or a single file —
        # otherwise a path-scoped run mismatches every baseline entry
        while os.path.exists(
            os.path.join(os.path.dirname(base), "__init__.py")
        ) and os.path.dirname(base) != base:
            base = os.path.dirname(base)
        pkg = package_name or os.path.basename(base.rstrip(os.sep))
        modules = []
        for path in files:
            rel = os.path.relpath(path, base)
            dotted = rel[: -len(".py")].replace(os.sep, ".")
            if dotted.endswith(".__init__"):
                dotted = dotted[: -len(".__init__")]
            name = f"{pkg}.{dotted}" if dotted != "__init__" else pkg
            with open(path, encoding="utf-8") as f:
                source = f.read()
            modules.append(Module(path, rel, source, name))
        return cls(modules, profile)

    # -- call resolution ------------------------------------------------------

    def resolve_call(
        self, fn: FunctionInfo, node: ast.Call
    ) -> Optional[FunctionInfo]:
        """Resolve a call site to a package function, or None.

        Order: bare name in the caller's module (then import alias, then
        package-unique bare name); ``self.X`` to a method of the caller's
        class; any other ``….X`` attribute call to a package-unique,
        non-generic method name.  No type inference — ambiguity resolves
        to None (unchecked), never to a guess between candidates.
        """
        name = call_name(node)
        if not name:
            return None
        if "." not in name:
            # a nested def in the CALLER's own scope wins over any
            # same-named def elsewhere in the module (two `_get_fn`s each
            # nesting a `program` must resolve to their own)
            prefix = f"{fn.qualname}.<locals>."
            for cand in self.by_bare_name.get(name, ()):
                if cand.module is fn.module and cand.qualname == (
                    prefix + name
                ):
                    return cand
            local = self._in_module(fn.module, name)
            if local is not None:
                return local
            origin = fn.module.imports.get(name)
            if origin:
                tail = origin.rsplit(".", 1)[-1]
                for cand in self.by_bare_name.get(tail, ()):
                    if origin.startswith(cand.module.name) or "." not in origin:
                        return cand
            return self._unique(name)
        base, _, attr = name.rpartition(".")
        if base == "self" and fn.class_name:
            for cand in self.by_bare_name.get(attr, ()):
                if (
                    cand.class_name == fn.class_name
                    and cand.module is fn.module
                ):
                    return cand
        if attr in GENERIC_NAMES:
            return None
        # a receiver that is an imported EXTERNAL module (np.mean,
        # jnp.concatenate, os.path.join) never resolves into the package
        head = base.split(".")[0]
        origin = fn.module.imports.get(head)
        if origin is not None:
            pkg_root = fn.module.name.split(".")[0]
            if origin.split(".")[0] != pkg_root:
                return None
        return self._unique(attr)

    def _in_module(self, module: Module, name: str) -> Optional[FunctionInfo]:
        for cand in self.by_bare_name.get(name, ()):
            if cand.module is module:
                return cand
        return None

    def _unique(self, name: str) -> Optional[FunctionInfo]:
        if name in GENERIC_NAMES:
            return None
        cands = self.by_bare_name.get(name, ())
        return cands[0] if len(cands) == 1 else None


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


class Baseline:
    """Checked-in ledger of accepted findings (with justifications).

    Schema: ``{"entries": [{"rule", "path", "symbol", "message",
    "justification"}]}``.  Matching is by :attr:`Finding.fingerprint`;
    entries and findings must stay in exact 1:1 sync (stale entries fail
    the gate just like new findings, so the ledger can only shrink by
    fixing code and only grow deliberately via ``--update-baseline``).
    """

    def __init__(self, entries: Optional[List[dict]] = None):
        self.entries = entries or []

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(list(data.get("entries", [])))

    @staticmethod
    def _fp(entry: dict) -> str:
        raw = "|".join(
            (
                entry.get("rule", ""),
                entry.get("path", ""),
                entry.get("symbol", ""),
                entry.get("message", ""),
            )
        )
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def split(
        self, findings: Sequence[Finding]
    ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """Partition into (new, baselined, stale-entries)."""
        by_fp = {self._fp(e): e for e in self.entries}
        new: List[Finding] = []
        matched: List[Finding] = []
        seen: Set[str] = set()
        for f in findings:
            if f.fingerprint in by_fp:
                matched.append(f)
                seen.add(f.fingerprint)
            else:
                new.append(f)
        stale = [e for fp, e in by_fp.items() if fp not in seen]
        return new, matched, stale

    @classmethod
    def from_findings(
        cls, findings: Sequence[Finding], justification: str = "TODO: justify"
    ) -> "Baseline":
        entries = [
            {
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
                "justification": justification,
            }
            for f in sorted(findings, key=lambda f: (f.rule, f.path, f.line))
        ]
        return cls(entries)

    def updated(
        self,
        findings: Sequence[Finding],
        active_rules: Set[str],
        analyzed_paths: Set[str],
    ) -> "Baseline":
        """The --update-baseline result: accept ``findings``, preserve the
        justifications of entries that still fire, and carry over UNTOUCHED
        every entry outside this run's scope — a rule that wasn't selected
        or a path that wasn't analyzed.  Without the carry-over, a scoped
        ``--rules``/sub-path update would silently destroy every other
        justified entry."""
        keep_just = {
            self._fp(e): e.get("justification", "") for e in self.entries
        }
        out = Baseline.from_findings(findings)
        for e in out.entries:
            j = keep_just.get(self._fp(e))
            if j:
                e["justification"] = j
        fresh = {self._fp(e) for e in out.entries}
        for e in self.entries:
            if self._fp(e) in fresh:
                continue
            if (
                e.get("rule") not in active_rules
                or e.get("path") not in analyzed_paths
            ):
                out.entries.append(e)
        out.entries.sort(
            key=lambda e: (e.get("rule", ""), e.get("path", ""),
                           e.get("symbol", ""), e.get("message", ""))
        )
        return out

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"entries": self.entries}, f, indent=2, sort_keys=True)
            f.write("\n")


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def all_checkers() -> Dict[str, object]:
    """Rule name -> checker instance (import here to avoid cycles)."""
    from docqa_tpu_torch.analysis.cv_protocol import CvProtocolChecker
    from docqa_tpu_torch.analysis.deadline_flow import DeadlineFlowChecker
    from docqa_tpu_torch.analysis.dispatch_streams import DispatchStreamsChecker
    from docqa_tpu_torch.analysis.guarded_state import GuardedStateChecker
    from docqa_tpu_torch.analysis.host_sync import HostSyncChecker
    from docqa_tpu_torch.analysis.lock_discipline import LockDisciplineChecker
    from docqa_tpu_torch.analysis.phi_taint import PhiTaintChecker
    from docqa_tpu_torch.analysis.resource_flow import ResourceFlowChecker
    from docqa_tpu_torch.analysis.retire_once import RetireOnceChecker
    from docqa_tpu_torch.analysis.shed_taxonomy import ShedTaxonomyChecker
    from docqa_tpu_torch.analysis.thread_lifecycle import ThreadLifecycleChecker
    from docqa_tpu_torch.analysis.wire_consumer import WireConsumerChecker
    from docqa_tpu_torch.analysis.wire_safety import WireSafetyChecker
    from docqa_tpu_torch.analysis.wire_schema import WireSchemaChecker

    checkers = [
        CvProtocolChecker(),
        DeadlineFlowChecker(),
        DispatchStreamsChecker(),
        GuardedStateChecker(),
        HostSyncChecker(),
        LockDisciplineChecker(),
        PhiTaintChecker(),
        ResourceFlowChecker(),
        RetireOnceChecker(),
        ShedTaxonomyChecker(),
        ThreadLifecycleChecker(),
        WireConsumerChecker(),
        WireSafetyChecker(),
        WireSchemaChecker(),
    ]
    return {c.rule: c for c in checkers}


def _run_package(
    package: Package, rules: Optional[Iterable[str]] = None
) -> List[Finding]:
    checkers = all_checkers()
    selected = list(rules) if rules else sorted(checkers)
    unknown = [r for r in selected if r not in checkers]
    if unknown:
        raise ValueError(
            f"unknown rule(s): {', '.join(unknown)} "
            f"(available: {', '.join(sorted(checkers))})"
        )
    by_path = {m.relpath: m for m in package.modules}
    findings: List[Finding] = []
    for rule in selected:
        for f in checkers[rule].check(package):  # type: ignore[attr-defined]
            module = by_path.get(f.path)
            if module is not None and module.is_suppressed(f.rule, f.line):
                continue
            findings.append(f)
    return findings


def run(
    root: str,
    rules: Optional[Iterable[str]] = None,
    package_name: Optional[str] = None,
    profile: Optional[AnalysisProfile] = None,
) -> List[Finding]:
    """Run the selected checkers over ``root`` under ``profile`` (the
    port's by default); returns findings with per-line suppressions
    already applied, sorted by (path, line)."""
    findings, _ = analyze_paths(
        [root], rules=rules, package_name=package_name, profile=profile
    )
    return findings


def analyze_paths(
    paths: Sequence[str],
    rules: Optional[Iterable[str]] = None,
    package_name: Optional[str] = None,
    profile: Optional[AnalysisProfile] = None,
) -> Tuple[List[Finding], Set[str]]:
    """Run the checkers over several roots in ONE parse pass; returns
    (findings, analyzed module relpaths).  The relpath set defines the
    run's scope for baseline staleness and scoped updates."""
    findings: List[Finding] = []
    analyzed: Set[str] = set()
    for path in paths:
        package = Package.load(path, package_name=package_name, profile=profile)
        analyzed |= {m.relpath for m in package.modules}
        findings.extend(_run_package(package, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, analyzed


def package_ledger_path(package: Package, name: str) -> Optional[str]:
    """The ledger ``name`` of the analysed package: under the profile's
    ``ledger_dir`` of the package root, else beside the root, else in it
    (fixture trees carry their own or none), or None."""
    for module in package.modules:
        rel = module.relpath.replace("/", os.sep)
        if not module.path.endswith(rel):
            continue
        base = module.path[: -len(rel)].rstrip(os.sep)
        roots = [os.path.dirname(base), base]
        if package.profile.ledger_dir is not None:
            roots.insert(0, os.path.join(base, package.profile.ledger_dir))
        for root in roots:
            cand = os.path.join(root, name)
            if os.path.exists(cand):
                return cand
    return None


def load_json(path: Optional[str], **defaults) -> Dict:
    """A ledger's JSON (``defaults`` for missing top-level keys, and the
    whole of it when ``path`` is None or missing)."""
    data: Dict = {}
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    for key, value in defaults.items():
        data.setdefault(key, value)
    return data


def package_dir() -> str:
    """The ``docqa_tpu_torch`` package directory: the analyzer's default
    scope and the witnesses' static tree."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline_path() -> str:
    """The checked-in baseline of the port's tree:
    ``docqa_tpu_torch/analysis/lint_baseline.json``."""
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "lint_baseline.json"
    )
