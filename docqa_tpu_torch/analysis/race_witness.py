"""race-witness: runtime instrumentation of lock acquisition order.

Counterpart of ``docqa_tpu/analysis/race_witness.py``.  The static
acquisition graph (``lock_discipline.build_acquisition_graph``) is a
model; this module records what the process actually DOES.  With the
witness installed, every ``threading.Lock`` / ``RLock`` / ``Condition``
created at a source line the static analyzer knows (the
``self._x = threading.Lock()`` declarations ``concurrency.discover_locks``
enumerates over the port's tree) is wrapped, and each acquisition records:

* **witnessed lock-order edges** — acquiring B while holding A adds edge
  ``A → B`` to the witnessed graph, under the SAME ``Class.attr``
  identity and Condition→lock aliasing the static graph uses, so the two
  views cross-check edge-for-edge;
* **held-lock blocking events** — a ``Condition.wait`` / ``wait_for``
  entered while OTHER locks are held (waiting releases only the cv's own
  lock), and any acquisition that blocked longer than ``blocking_ms``
  while the thread held something (measured contention, the
  precondition of every order-inversion deadlock).

The gate (the tests and ``chip_smoke.py``'s witness phase; a served
process exposes the same dump at ``GET /api/witness``):

* a **cycle** in the witnessed graph fails the run — that is a deadlock
  the load simply didn't lose the coin-flip on;
* a witnessed edge **missing from the static graph** fails the run —
  the analyzer has a blind spot (an unresolvable call, a lock the
  discovery missed) that must be fixed or the lock declared, otherwise
  the static gate is quietly vouching for orderings it never checked.

Known blind spot, by design: primitives created through dataclass
``field(default_factory=…)`` (the per-request ``_Request.cv``) construct
inside generated ``__init__`` code, so their creation site cannot be
mapped back to a declaration — they stay unwrapped, and the static
rules (guarded-state, cv-protocol) carry them instead.  So do locks built
before the install: the served process installs at process entry
(``service/app.py``'s ``main``), an embedding runtime at
``DocQARuntime.__init__``.

Overhead is a dict update per acquisition on wrapped locks only; the
witness is opt-in (tests, ``DOCQA_RACE_WITNESS=1`` for a served process)
and never belongs in a latency benchmark.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from docqa_tpu_torch.analysis.concurrency import canonical, find_cycles

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

# stack frames from these files are machinery, not creation sites
_SKIP_FRAME_PARTS = (
    os.sep + "threading.py",
    os.sep + "dataclasses.py",
    "race_witness.py",
)


def build_lock_id_map(
    paths: Optional[List[str]] = None,
) -> Tuple[Dict[Tuple[str, int], str], Dict[str, str], Dict]:
    """(creation-site → lock id, aliases, static edges) for the witness.

    ``paths`` defaults to the installed ``docqa_tpu_torch`` package — the
    same scope as ``python -m docqa_tpu_torch.analysis``.  The
    creation-site key is ``(absolute source path, factory lineno)``:
    exactly what a stack walk sees when the patched factory runs."""
    from docqa_tpu_torch.analysis.concurrency import discover_locks, lock_aliases
    from docqa_tpu_torch.analysis.core import Package, package_dir
    from docqa_tpu_torch.analysis.lock_discipline import build_acquisition_graph

    if paths is None:
        paths = [package_dir()]
    id_map: Dict[Tuple[str, int], str] = {}
    aliases: Dict[str, str] = {}
    edges: Dict = {}
    for root in paths:
        package = Package.load(root)
        decls = discover_locks(package)
        for decl in decls.values():
            id_map[
                (os.path.abspath(decl.module_abspath), decl.lineno)
            ] = decl.lock_id
        aliases.update(lock_aliases(decls, package))
        edges.update(build_acquisition_graph(package))
    return id_map, aliases, edges


class _HeldState(threading.local):
    def __init__(self) -> None:
        self.stack: List[str] = []  # canonical ids, acquisition order
        self.counts: Dict[str, int] = {}  # reentrancy


class LockOrderWitness:
    """Records the witnessed acquisition-order graph + blocking events."""

    def __init__(
        self,
        id_map: Dict[Tuple[str, int], str],
        aliases: Optional[Dict[str, str]] = None,
        blocking_ms: float = 50.0,
    ) -> None:
        self.id_map = dict(id_map)
        self.aliases = dict(aliases or {})
        self.blocking_ms = float(blocking_ms)
        self._held = _HeldState()
        self._mu = _REAL_LOCK()  # witness-internal; never wrapped
        # (from, to) -> {"count", "example_thread"}
        self.edges: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.blocking: List[Dict[str, Any]] = []
        self.locks_seen: Set[str] = set()
        self._installed = False

    # ---- recording -----------------------------------------------------------

    def _canon(self, lock_id: str) -> str:
        return canonical(lock_id, self.aliases)

    def on_acquired(self, lock_id: str, waited_s: float) -> None:
        lid = self._canon(lock_id)
        held = self._held
        n = held.counts.get(lid, 0)
        held.counts[lid] = n + 1
        if n:  # reentrant re-acquire: no new node on the stack
            return
        new_edges = []
        for h in held.stack:
            if h != lid:
                new_edges.append((h, lid))
        held.stack.append(lid)
        blocked = waited_s * 1000.0 >= self.blocking_ms and bool(
            held.stack[:-1]
        )
        if not new_edges and not blocked:
            with self._mu:
                self.locks_seen.add(lid)
            return
        tname = threading.current_thread().name
        with self._mu:
            self.locks_seen.add(lid)
            for edge in new_edges:
                row = self.edges.setdefault(
                    edge, {"count": 0, "example_thread": tname}
                )
                row["count"] += 1
            if blocked:
                self.blocking.append(
                    {
                        "op": "acquire",
                        "lock": lid,
                        "held": list(held.stack[:-1]),
                        "ms": round(waited_s * 1000.0, 3),
                        "thread": tname,
                    }
                )

    def on_released(self, lock_id: str) -> None:
        lid = self._canon(lock_id)
        held = self._held
        n = held.counts.get(lid, 0)
        if n > 1:
            held.counts[lid] = n - 1
            return
        held.counts.pop(lid, None)
        if lid in held.stack:
            held.stack.remove(lid)

    def on_cv_wait(self, lock_id: str) -> None:
        """Entering ``Condition.wait``: the cv's own lock is released,
        anything ELSE still held is a held-lock blocking call."""
        lid = self._canon(lock_id)
        others = [h for h in self._held.stack if h != lid]
        if others:
            with self._mu:
                self.blocking.append(
                    {
                        "op": "cv_wait",
                        "lock": lid,
                        "held": others,
                        "thread": threading.current_thread().name,
                    }
                )

    # ---- results -------------------------------------------------------------

    def _edge_keys(self) -> List[Tuple[str, str]]:
        """Stable copy of the edge set — cycles()/cross_check() must
        never iterate the LIVE dict: on_acquired() inserts from any
        thread, and a mid-iteration insert is a RuntimeError exactly
        while /api/witness observes a loaded process."""
        with self._mu:
            return list(self.edges.keys())

    def cycles(self) -> List[List[str]]:
        return find_cycles(self._edge_keys())

    def cross_check(self, static_edges) -> List[Tuple[str, str]]:
        """Witnessed edges absent from the static acquisition graph."""
        static = set(static_edges)
        return sorted(e for e in self._edge_keys() if e not in static)

    def snapshot(
        self, static_edges=None
    ) -> Dict[str, Any]:
        with self._mu:
            edge_items = sorted(self.edges.items())
            edges = [
                {"from": a, "to": b, **row} for (a, b), row in edge_items
            ]
            blocking = list(self.blocking)
            locks = sorted(self.locks_seen)
        edge_keys = [key for key, _row in edge_items]
        out: Dict[str, Any] = {
            "locks_seen": locks,
            "edges": edges,
            "blocking": blocking,
            "cycles": find_cycles(edge_keys),
        }
        if static_edges is not None:
            static = set(static_edges)
            out["static_edge_count"] = len(static)
            out["edges_missing_from_static"] = [
                list(e) for e in edge_keys if e not in static
            ]
        return out

    # ---- installation --------------------------------------------------------

    def _creation_id(self) -> Optional[str]:
        import sys

        frame = sys._getframe(2)
        while frame is not None:
            fname = frame.f_code.co_filename
            if not any(p in fname for p in _SKIP_FRAME_PARTS) and not (
                fname.startswith("<")
            ):
                break
            frame = frame.f_back
        if frame is None:
            return None
        key = (os.path.abspath(frame.f_code.co_filename), frame.f_lineno)
        return self.id_map.get(key)

    def install(self) -> "LockOrderWitness":
        """Patch the threading factories.  Only locks created AFTER this
        (at mapped declaration sites) are wrapped; everything else gets
        the real primitive untouched."""
        if self._installed:
            return self
        self._installed = True
        witness = self

        def make_lock(*a, **kw):
            lid = witness._creation_id()
            inner = _REAL_LOCK(*a, **kw)
            return inner if lid is None else _WitnessLock(
                inner, lid, witness
            )

        def make_rlock(*a, **kw):
            lid = witness._creation_id()
            inner = _REAL_RLOCK(*a, **kw)
            return inner if lid is None else _WitnessLock(
                inner, lid, witness
            )

        def make_condition(lock=None, *a, **kw):
            lid = witness._creation_id()
            inner_lock = lock
            base_id = None
            if isinstance(lock, _WitnessLock):
                inner_lock = lock._inner
                base_id = lock.lock_id
            inner = _REAL_CONDITION(inner_lock, *a, **kw)
            if lid is None:
                return inner
            if base_id is not None:
                # Condition(self._lock): ONE lock, two names — record
                # under the lock's id so the graphs don't grow a
                # self-alias edge
                witness.aliases.setdefault(lid, base_id)
            return _WitnessCondition(inner, lid, witness)

        threading.Lock = make_lock  # type: ignore[assignment]
        threading.RLock = make_rlock  # type: ignore[assignment]
        threading.Condition = make_condition  # type: ignore[assignment]
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        threading.Lock = _REAL_LOCK  # type: ignore[assignment]
        threading.RLock = _REAL_RLOCK  # type: ignore[assignment]
        threading.Condition = _REAL_CONDITION  # type: ignore[assignment]


class _WitnessLock:
    """Lock/RLock wrapper feeding the witness.  Undeclared attributes
    delegate to the real primitive (Condition's ``_is_owned`` /
    ``_release_save`` probes keep working on RLocks)."""

    def __init__(self, inner, lock_id: str, witness: LockOrderWitness):
        self._inner = inner
        self.lock_id = lock_id
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.on_acquired(
                self.lock_id, time.perf_counter() - t0
            )
        return ok

    def release(self) -> None:
        self._inner.release()
        self._witness.on_released(self.lock_id)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _WitnessCondition:
    """Condition wrapper: acquisition records like a lock; ``wait`` and
    ``wait_for`` additionally record held-lock blocking and keep the held
    stack honest across the release-wait-reacquire cycle; ``notify`` /
    ``notify_all`` pass through."""

    def __init__(self, inner, lock_id: str, witness: LockOrderWitness):
        self._inner = inner
        self.lock_id = lock_id
        self._witness = witness

    # -- lock surface ---------------------------------------------------------

    def acquire(self, *a, **kw):
        t0 = time.perf_counter()
        ok = self._inner.acquire(*a, **kw)
        if ok:
            self._witness.on_acquired(
                self.lock_id, time.perf_counter() - t0
            )
        return ok

    def release(self) -> None:
        self._inner.release()
        self._witness.on_released(self.lock_id)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- cv surface -----------------------------------------------------------

    def wait(self, timeout: Optional[float] = None):
        self._witness.on_cv_wait(self.lock_id)
        # the inner wait releases the REAL lock; mirror that on the
        # witnessed stack so reacquisition doesn't double-push
        self._witness.on_released(self.lock_id)
        try:
            return self._inner.wait(timeout)
        finally:
            self._witness.on_acquired(self.lock_id, 0.0)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._witness.on_cv_wait(self.lock_id)
        self._witness.on_released(self.lock_id)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._witness.on_acquired(self.lock_id, 0.0)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __getattr__(self, name):
        return getattr(self._inner, name)


# ---------------------------------------------------------------------------
# module-level convenience (the app's endpoint, tests, chip_smoke)
# ---------------------------------------------------------------------------

DEFAULT_WITNESS: Optional[LockOrderWitness] = None
_STATIC_EDGES: Optional[Dict] = None


def install_witness(
    paths: Optional[List[str]] = None, blocking_ms: float = 50.0
) -> LockOrderWitness:
    """Build the id map from the real tree and install a process-wide
    witness.  Idempotent; returns the active witness."""
    global DEFAULT_WITNESS, _STATIC_EDGES
    if DEFAULT_WITNESS is not None:
        return DEFAULT_WITNESS
    id_map, aliases, edges = build_lock_id_map(paths)
    _STATIC_EDGES = edges
    DEFAULT_WITNESS = LockOrderWitness(
        id_map, aliases, blocking_ms=blocking_ms
    ).install()
    return DEFAULT_WITNESS


def witness_snapshot() -> Optional[Dict[str, Any]]:
    """The active witness's dump, cross-checked against the static graph
    (None when no witness is installed)."""
    if DEFAULT_WITNESS is None:
        return None
    return DEFAULT_WITNESS.snapshot(static_edges=_STATIC_EDGES)


def maybe_install_from_env() -> Optional[LockOrderWitness]:
    """``DOCQA_RACE_WITNESS=1`` installs the witness at service boot —
    ``GET /api/witness`` then serves the live dump."""
    if os.environ.get("DOCQA_RACE_WITNESS", "") in ("1", "true", "yes"):
        return install_witness()
    return None
