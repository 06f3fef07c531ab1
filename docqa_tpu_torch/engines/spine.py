"""Bounded dispatch spine: the one executor device work flows through,
counterpart of ``docqa_tpu/engines/spine.py``.

* Every device phase is a work item submitted to the process's
  :class:`DispatchSpine` (``spine_run(stage, closure)``).  The submitting
  thread blocks for the result (:func:`spine_run`), holds a
  :class:`SpineTicket` from the moment the item has issued
  (:func:`spine_issue`, the batcher's pipelined chunk) or at once
  (:func:`spine_submit`), so call sites keep their program order.
* At most ``n_lanes`` items execute at once (default
  :data:`DEFAULT_LANES`).  An issued item runs on its caller's thread
  while a slot is free and no item is queued, as the port's threads issued
  their own work before the spine; otherwise, and for submitted items, it
  queues for the spine's own lane threads.  Queued serving items go first,
  prefill items next (``PREFILL_STREAMS``; an aged prefill head is
  promoted, so decode load delays admissions and never starves them),
  background items (``BACKGROUND_STREAMS``: warm-ups, probes) on at most
  ``n_lanes - 1`` slots.  The queue is bounded (:class:`SpineSaturated`).
* An item runs on the submitting thread's CUDA stream, in its grad and
  inference mode: a :class:`Lane` entered on the submitting thread (the
  batcher's, the ingest workers') is the stream the item's kernels go to.
* The spine is the observability substrate: every item records a queue
  wait / device time split, per-stage aggregates feed
  ``obs.DEFAULT_OBSERVATORY`` (FLOPs and MFU), gauges and counters feed the
  telemetry sampler (``dispatch_*``), and a traced submitter gets a
  ``dispatch:<stage>`` span and, with a cost record, its device time.

Device time.  The reference takes the wall time of the closure, which on a
TPU is device time because every item blocks on its one fetch.  On a card
a closure returns when its kernels are enqueued, so the port records two
CUDA events on the item's stream around the closure and reports their
elapsed time as ``device_s``.  The item's slot does not wait for them: it
is free once the closure returns, so a slot is held for an item's host
time (its launches and any fetch inside it), never for device work queued
behind it.  The item's device time is read where its submitter takes the result
(:meth:`SpineTicket.result`, which waits for the end event), as the
reference measures a decode chunk at its fetch: the batcher issues chunk
N+1 before it fetches and processes chunk N (``engines/serve.py``).  Its
count and queue wait enter the stage series when the closure returns; its
device time, observatory record, ``dispatch:<stage>`` span and cost
attribution when the result is taken, so a ticket nobody fetched (a chunk
dropped on a failed dispatch) adds no device time, as the reference's
unfetched chunk adds none.  On the CPU an item's device time is the
closure's wall time, as in the reference.

Lanes.  On a TPU the reference's two lanes overlap one dispatch with one
fetch, and every item crosses to a lane thread.  Here a crossing costs
interpreter-lock handoffs, which a busy Python thread beside it (the deid
worker beside the index worker) stretches, and slows that thread too
(``chip_smoke.py`` phase 8 times both ways): so an issued item
runs on its caller when it can.  A slot is held for an
item's host time, which the fetches inside an item stretch: a speculative
decode chunk fetches once per verify step and holds one for the whole
chunk (about half a second at full width).  The main path runs one such
long holder per replica and the ingest workers' encoder batches, beside
/ask's retrievals and each replica's admissions.  On an H100
(``chip_smoke.py`` phases 6 and 7: two replicas; one replica beside
ingest), 2 slots kept a retrieval waiting 94.8 and 19.9 ms on the mean
and an admission 8.0 and 10.8 ms; with :data:`DEFAULT_LANES` = 8 (a slot
for each of up to four replicas, the encoder and the retrievals, with room
to spare) every stage waited under 0.1 ms.

A kernel or CUDA fault (``ops/_kernels.is_device_fault``) raised by a
closure or by the accounting around it (reading an event after a fault
raises) reaches the submitter; other accounting errors are logged and never
fail an item.

Closures are pure device phases: no app lock is taken inside one (a
submitter may hold locks while it waits).

On a mesh of ranks (``runtime/mesh.py``'s command stream) the mirrored
entry points take the mesh slot and publish their command before they
issue their items, so the mesh slot is always taken before a spine slot.
An item issued inside a command carries that scope to the thread it runs
on, and is never shed, neither by its deadline nor by a full queue: once
a command is published, every rank must issue its collectives.  Off a mesh
nothing changes.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import threading
from time import monotonic as _mono
from time import perf_counter as _now
from typing import Any, Callable, Dict, List, Optional

import torch

from docqa_tpu_torch import obs
from docqa_tpu_torch.obs.costs import DEFAULT_COST_LEDGER
from docqa_tpu_torch.obs.observatory import DEFAULT_OBSERVATORY
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.resilience.deadline import DeadlineExceeded
from docqa_tpu_torch.runtime.mesh import command_scope, in_command
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger

log = get_logger("docqa.spine")

# serving-class streams get lane priority; everything else is background
BACKGROUND_STREAMS = frozenset({"warmup", "probe", "rebuild", "background"})
# prefill items are serving-class but schedule below decode items, so one
# replica's long admission prefill cannot head-of-line block another's
# decode chunks; a prefill head older than this bound promotes
PREFILL_STREAMS = frozenset({"prefill"})
PREFILL_MAX_WAIT_S = 0.1
# see "Lanes" above
DEFAULT_LANES = 8


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Inside a spine item: start ``t``'s copy to the host with no host
    sync.  On a card the copy goes to pinned memory on the item's stream,
    ahead of the item's end event, so it has landed once the item's
    :meth:`SpineTicket.result` returns; on the CPU ``t`` itself."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _fenced(what: str, fn: Callable[[], None]) -> None:
    """Run one accounting step; log its failure, but let a kernel or CUDA
    fault through to the item's submitter."""
    try:
        fn()
    except Exception as e:
        if is_device_fault(e):
            raise
        log.exception("spine %s failed", what)


class Lane:
    """A device and the one CUDA stream (None on the CPU) its work runs on.

    Entered on the submitting thread (:meth:`active`), it makes its stream
    the current one, so the spine items submitted inside run on it."""

    def __init__(self, device) -> None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = (
            torch.cuda.Stream(device=self.device)
            if self.device.type == "cuda" else None
        )

    @contextlib.contextmanager
    def active(self):
        """Run the enclosed work in inference mode on this lane's stream,
        after everything the calling thread's current stream has issued so
        far."""
        with torch.inference_mode():
            if self.stream is None:
                yield
                return
            with torch.cuda.device(self.device):
                caller = torch.cuda.current_stream(self.device)
                if caller != self.stream:
                    self.stream.wait_stream(caller)
                with torch.cuda.stream(self.stream):
                    yield


class SpineSaturated(RuntimeError):
    """The spine's bounded queue is full: a runaway producer, since
    submitters are synchronous; failing typed beats queueing without
    bound."""

    def __init__(self, message: str, depth: Optional[int] = None) -> None:
        self.depth = depth
        if depth is not None:
            message = f"{message} (depth={depth})"
        super().__init__(message)


class SpineClosed(RuntimeError):
    """Submit after :meth:`DispatchSpine.close`."""


class SpineCancelled(RuntimeError):
    """The ticket was cancelled before a lane picked it up."""


class _Item:
    __slots__ = (
        "stage", "stream", "fn", "args", "kwargs", "cost_key", "deadline",
        "trace", "span_parent", "t_submit", "done", "result", "error",
        "queue_wait_s", "device_s", "cuda_stream", "inference", "grad",
        "t_start", "t_issued", "events", "settle_lock", "settled",
        "in_command",
    )

    def __init__(self, stage, stream, fn, args, kwargs, cost_key, deadline,
                 trace, span_parent, device):
        self.stage = stage
        self.stream = stream
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.cost_key = cost_key
        self.deadline = deadline
        self.trace = trace
        self.span_parent = span_parent
        self.t_submit = _now()
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.queue_wait_s = 0.0
        self.device_s = 0.0
        # closure start and return, and the CUDA event pair around it
        self.t_start = self.t_issued = self.t_submit
        self.events = None
        self.settle_lock = threading.Lock()
        self.settled = False
        # the submitter's execution context, replayed where the item runs
        device = torch.device(device) if device is not None else None
        self.cuda_stream = (
            torch.cuda.current_stream(device)
            if device is not None and device.type == "cuda" else None
        )
        self.inference = torch.is_inference_mode_enabled()
        self.grad = torch.is_grad_enabled()
        # issued inside a mesh command: it must run, whatever its deadline
        # or the queue's depth, or the ranks' collectives part ways
        self.in_command = in_command()


class SpineTicket:
    """Future-like handle for a submitted work item."""

    def __init__(self, spine: "DispatchSpine", item: _Item) -> None:
        self._spine = spine
        self._item = item

    def _wait_issued(self, timeout: Optional[float]) -> None:
        """Wait until the closure has returned (on a card its work is
        enqueued, not finished), the wait clamped to the item's deadline."""
        it = self._item
        if it.deadline is not None and not it.in_command:
            timeout = it.deadline.bound(timeout)
        if not it.done.wait(timeout):
            if (it.deadline is not None and it.deadline.expired
                    and not it.in_command):
                # the deadline was the binding constraint: pull the item off
                # the queue if no lane reached it, else wait it out (a
                # running closure never outlives its submitter's lock
                # scope), then report the budget shed
                if not self.cancel():
                    it.done.wait()
                raise DeadlineExceeded(
                    f"spine:{it.stage}", -it.deadline.remaining()
                )
            raise TimeoutError(
                f"spine item {it.stage!r} did not complete in time"
            )

    def result(self, timeout: Optional[float] = None) -> Any:
        """The closure's result once its device work has finished (the
        fetch); the first call accounts the item's device time."""
        self._wait_issued(timeout)
        self._spine._settle(self._item)
        if self._item.error is not None:
            raise self._item.error
        return self._item.result

    def cancel(self) -> bool:
        """True when the item had not started and will never run (its
        waiter gets :class:`SpineCancelled`)."""
        return self._spine._cancel(self._item)

    @property
    def done(self) -> bool:
        return self._item.done.is_set()

    @property
    def queue_wait_s(self) -> float:
        """Measured submit -> lane wait (valid once done)."""
        return self._item.queue_wait_s

    @property
    def device_s(self) -> float:
        """Measured device time (valid once :meth:`result` returned):
        CUDA-event elapsed time on a card, closure wall time on the CPU.
        The batcher's cost attribution splits exactly this value across
        the requests the item served."""
        return self._item.device_s


class DispatchSpine:
    """Bounded executor for device work items (one per process)."""

    def __init__(
        self,
        n_lanes: int = DEFAULT_LANES,
        max_depth: int = 256,
        inline: bool = False,
        name: str = "spine",
    ) -> None:
        self.n_lanes = max(1, int(n_lanes))
        self.max_depth = max(1, int(max_depth))
        self.inline = bool(inline)
        self.name = name
        self._cv = threading.Condition()
        # serving items beat prefill items (unless the prefill head aged),
        # both beat background
        self._ready: collections.deque = collections.deque()
        self._ready_pf: collections.deque = collections.deque()
        self._ready_bg: collections.deque = collections.deque()
        self._busy = 0
        self._busy_bg = 0
        self._closed = False
        self._lanes: List[threading.Thread] = []
        # set on a thread while it executes an item (a lane's or a caller's)
        self._local = threading.local()
        self._stats_lock = threading.Lock()
        self._stage_stats: Dict[str, Dict[str, float]] = {}
        self._submitted = 0
        self._completed = 0
        self._errors = 0
        self._peak_depth = 0

    # ---- lanes ---------------------------------------------------------------

    def _ensure_lanes_locked(self) -> None:
        # a lane that died is pruned so capacity self-heals
        self._lanes = [t for t in self._lanes if t.is_alive()]
        while len(self._lanes) < self.n_lanes:
            t = threading.Thread(
                target=self._lane_loop,
                daemon=True,
                name=f"{self.name}-lane-{len(self._lanes)}",
            )
            self._lanes.append(t)
            t.start()

    def _depth_locked(self) -> int:
        return len(self._ready) + len(self._ready_pf) + len(self._ready_bg)

    def _bg_slot_locked(self) -> bool:
        return self._busy_bg < max(1, self.n_lanes - 1) or self.n_lanes == 1

    def _lane_loop(self) -> None:
        """Pick serving items first, while fewer than ``n_lanes`` items
        execute (on lanes or on their callers); background items run on at
        most ``n_lanes - 1`` slots at once."""
        while True:
            with self._cv:
                item = None
                while item is None:
                    free = self._busy < self.n_lanes
                    pf_aged = bool(self._ready_pf) and (
                        _now() - self._ready_pf[0].t_submit
                        > PREFILL_MAX_WAIT_S
                    )
                    if free and self._ready and not pf_aged:
                        item = self._ready.popleft()
                    elif free and self._ready_pf:
                        item = self._ready_pf.popleft()
                    elif free and self._ready_bg and self._bg_slot_locked():
                        item = self._ready_bg.popleft()
                        self._busy_bg += 1
                    elif self._closed:
                        return
                    else:
                        self._cv.wait(0.5)
                self._busy += 1
            bg = item.stream in BACKGROUND_STREAMS
            try:
                self._execute(item)
            finally:
                with self._cv:
                    self._busy -= 1
                    if bg:
                        self._busy_bg -= 1
                    self._cv.notify_all()

    # ---- execution -----------------------------------------------------------

    @staticmethod
    @contextlib.contextmanager
    def _submitter_context(item: _Item):
        """The submitting thread's grad/inference mode, CUDA stream and
        mesh command scope."""
        with torch.inference_mode(item.inference), torch.set_grad_enabled(
            item.grad
        ), command_scope(item.in_command and not in_command()):
            if item.cuda_stream is None:
                yield
                return
            with torch.cuda.device(item.cuda_stream.device), torch.cuda.stream(
                item.cuda_stream
            ):
                yield

    @staticmethod
    def _timing_events(item: _Item):
        """A start/end pair of CUDA timing events for an item on a card
        (recorded on its stream), None on the CPU.  The fetch sleeps on
        the end event (``blocking``) instead of spinning a host core."""
        if item.cuda_stream is None:
            return None
        return (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True, blocking=True),
        )

    def _execute(self, item: _Item) -> None:
        outer = getattr(self._local, "in_item", False)
        self._local.in_item = True
        try:
            self._run_item(item)
        finally:
            self._local.in_item = outer

    def _run_item(self, item: _Item) -> None:
        item.t_start = _now()
        try:
            if (item.deadline is not None and item.deadline.expired
                    and not item.in_command):
                # shed before issuing: nobody can use this answer
                raise DeadlineExceeded(
                    f"spine:{item.stage}", -item.deadline.remaining()
                )
            with self._submitter_context(item):
                events = self._timing_events(item)
                if events is not None:
                    events[0].record()
                out = item.fn(*item.args, **item.kwargs)
                if events is not None:
                    events[1].record()
                    item.events = events
            item.result = out
        except BaseException as e:  # propagated to the submitter
            item.error = e
        finally:
            item.t_issued = _now()
            # done.set() is unconditional: an accounting surprise must
            # neither strand the submitter nor kill the lane thread
            try:
                self._account(item)
            except Exception:
                log.exception(
                    "spine accounting failed for stage %r", item.stage
                )
            item.done.set()

    @staticmethod
    def _device_seconds(item: _Item) -> float:
        """The item's device time: CUDA-event elapsed time once the end
        event has completed (this waits for it), else closure wall time."""
        if item.events is not None and item.error is None:
            item.events[1].synchronize()
            return item.events[0].elapsed_time(item.events[1]) / 1e3
        return item.t_issued - item.t_start

    def _stage_row_locked(self, stage: str) -> Dict[str, float]:
        return self._stage_stats.setdefault(
            stage,
            {"count": 0, "queue_wait_s": 0.0, "device_s": 0.0, "errors": 0},
        )

    def _account(self, item: _Item, idle: bool = False) -> None:
        """Record one terminal item's count and queue wait; ``idle``
        (cancel, close) means it never ran and took no device time, so it
        is settled here too."""
        t_start = _now() if idle else item.t_start
        queue_wait = max(t_start - item.t_submit, 0.0)
        item.queue_wait_s = queue_wait
        with self._stats_lock:
            row = self._stage_row_locked(item.stage)
            row["count"] += 1
            row["queue_wait_s"] += queue_wait
            if item.error is not None:
                row["errors"] += 1
                self._errors += 1
            self._completed += 1
        DEFAULT_REGISTRY.histogram("dispatch_queue_wait_ms").observe(
            queue_wait * 1e3
        )
        if idle:
            item.settled = True

    def _settle(self, item: _Item) -> None:
        """Account a done item's device time, once (the first
        :meth:`SpineTicket.result`): the stage series, the observatory, the
        ``dispatch:<stage>`` span and the cost record.  A device fault in
        here (an event read after a fault) is the item's error."""
        with item.settle_lock:
            if item.settled:
                return
            item.settled = True
            try:
                self._account_device(item)
            except Exception as e:
                if not is_device_fault(e):
                    log.exception(
                        "spine accounting failed for stage %r", item.stage
                    )
                elif item.error is None:
                    item.error = e

    def _account_device(self, item: _Item) -> None:
        device_s = max(self._device_seconds(item), 0.0)
        t_end = _now()
        item.device_s = device_s
        with self._stats_lock:
            self._stage_row_locked(item.stage)["device_s"] += device_s
        DEFAULT_REGISTRY.histogram("dispatch_device_ms").observe(
            device_s * 1e3
        )
        if item.error is None:
            def record_cost():
                cost_key = item.cost_key
                if callable(cost_key):
                    # a key the device decided (a verify loop's steps)
                    cost_key = cost_key(item.result)
                DEFAULT_OBSERVATORY.record(item.stage, cost_key, device_s)

            _fenced(f"observatory record for {item.stage!r}", record_cost)
        if item.trace is not None:
            # a finished trace must never fail a dispatch
            _fenced("dispatch span", lambda: item.trace.record_span(
                f"dispatch:{item.stage}", item.t_submit, t_end,
                parent_id=item.span_parent,
                queue_wait_ms=round(item.queue_wait_s * 1e3, 3),
                device_ms=round(device_s * 1e3, 3),
                stream=item.stream,
            ))
            # per-class cost attribution: a submitter-side item under a
            # traced request accrues its measured split to the request's
            # CostRecord.  Worker-side serve items carry no trace and are
            # attributed explicitly by the batcher: no stage counts twice.
            rec = getattr(item.trace, "cost_record", None)
            if item.error is None and rec is not None:
                _fenced("cost attribution", lambda: rec.account_dispatch(
                    item.stage, item.queue_wait_s, device_s
                ))

    # ---- public API ----------------------------------------------------------

    def _dispatch(self, item: _Item, on_caller: bool) -> SpineTicket:
        """Execute ``item`` on this thread (re-entrancy, inline mode, or
        ``on_caller`` with a free slot and nothing queued ahead), else queue
        it for a lane thread."""
        if getattr(self._local, "in_item", False):
            # re-entrancy (an item whose closure reaches another routed
            # call) runs on the current thread: waiting on the queue from
            # inside an item would deadlock the spine
            with self._cv:
                self._submitted += 1
            self._execute(item)
            return SpineTicket(self, item)
        bg = item.stream in BACKGROUND_STREAMS
        with self._cv:
            if self._closed:
                raise SpineClosed("dispatch spine is closed")
            self._submitted += 1
            inline = self.inline
            claimed = (
                not inline and on_caller and self._busy < self.n_lanes
                and not self._depth_locked()
                and (not bg or self._bg_slot_locked())
            )
            if claimed:
                self._busy += 1
                self._busy_bg += bg
            elif not inline:
                depth = self._depth_locked()
                if depth >= self.max_depth and not item.in_command:
                    self._submitted -= 1
                    rec = getattr(item.trace, "cost_record", None)
                    DEFAULT_COST_LEDGER.record_shed(
                        "spine_saturated",
                        cls=rec.cls if rec is not None else None,
                        stage=item.stage,
                        depth=depth,
                    )
                    raise SpineSaturated(
                        f"spine queue at capacity for {item.stage!r}",
                        depth=depth,
                    )
                if bg:
                    self._ready_bg.append(item)
                elif item.stream in PREFILL_STREAMS:
                    self._ready_pf.append(item)
                else:
                    self._ready.append(item)
                self._peak_depth = max(self._peak_depth, depth + 1)
                self._ensure_lanes_locked()
                self._cv.notify_all()
        if inline or claimed:
            try:
                self._execute(item)
            finally:
                if claimed:
                    with self._cv:
                        self._busy -= 1
                        self._busy_bg -= bg
                        self._cv.notify_all()
        return SpineTicket(self, item)

    def _new_item(self, stage, fn, args, kwargs, stream, cost_key,
                  deadline, device) -> _Item:
        ctx = obs.current()
        return _Item(
            stage, stream, fn, args, kwargs, cost_key, deadline,
            ctx.trace if ctx is not None else None,
            ctx.span_id if ctx is not None else None, device,
        )

    def submit(
        self,
        stage: str,
        fn: Callable,
        *args,
        stream: str = "serve",
        cost_key: Any = None,
        deadline=None,
        device=None,
        **kwargs,
    ) -> SpineTicket:
        """Queue a device work item for a lane thread; returns a
        :class:`SpineTicket` at once.

        ``device`` is the device the closure works on: on a card the item
        runs on the submitting thread's current stream of that device and
        its device time comes from CUDA events.  ``cost_key`` links the item
        to a cost model of the observatory; a callable is applied to the
        item's result (a key only the device run decides)."""
        item = self._new_item(
            stage, fn, args, kwargs, stream, cost_key, deadline, device
        )
        return self._dispatch(item, on_caller=False)

    def issue(
        self,
        stage: str,
        fn: Callable,
        *args,
        stream: str = "serve",
        cost_key: Any = None,
        deadline=None,
        device=None,
        **kwargs,
    ) -> SpineTicket:
        """Run a device work item and return its ticket once the closure
        has returned (on a card its work is enqueued; the ticket's
        :meth:`~SpineTicket.result` is the fetch).  The item runs on the
        calling thread when a slot is free and no item is queued, else on
        a lane thread while this waits; the closure's error is raised
        here.  Arguments as :meth:`submit`."""
        item = self._new_item(
            stage, fn, args, kwargs, stream, cost_key, deadline, device
        )
        ticket = self._dispatch(item, on_caller=True)
        # an item of a mesh command is waited for until it has issued: its
        # collectives must precede the next command's
        ticket._wait_issued(
            None if deadline is None or item.in_command else deadline.bound(None)
        )
        if item.error is not None:
            self._settle(item)
            raise item.error
        return ticket

    def run(
        self,
        stage: str,
        fn: Callable,
        *args,
        stream: str = "serve",
        cost_key: Any = None,
        deadline=None,
        device=None,
        **kwargs,
    ) -> Any:
        """Issue and fetch (the call-site idiom).  The wait is clamped to
        the request deadline when one rides the item."""
        ticket = self.issue(
            stage, fn, *args, stream=stream, cost_key=cost_key,
            deadline=deadline, device=device, **kwargs,
        )
        timeout = None if deadline is None else deadline.bound(None)
        return ticket.result(timeout=timeout)

    def reconfigure(
        self,
        n_lanes: Optional[int] = None,
        max_depth: Optional[int] = None,
        inline: Optional[bool] = None,
    ) -> "DispatchSpine":
        """Apply runtime config.  The lane count changes only before the
        first lane starts; depth and inline apply live."""
        with self._cv:
            if n_lanes is not None:
                if not self._lanes:
                    self.n_lanes = max(1, int(n_lanes))
                elif int(n_lanes) != self.n_lanes:
                    log.warning(
                        "spine lanes already started at n_lanes=%d; "
                        "requested n_lanes=%d ignored (configure the "
                        "spine before the first device dispatch)",
                        self.n_lanes, int(n_lanes),
                    )
            if max_depth is not None:
                self.max_depth = max(1, int(max_depth))
            if inline is not None:
                self.inline = bool(inline)
        return self

    def _cancel(self, item: _Item) -> bool:
        with self._cv:
            for q in (self._ready, self._ready_pf, self._ready_bg):
                try:
                    q.remove(item)
                except ValueError:
                    continue
                item.error = SpineCancelled(
                    f"spine item {item.stage!r} cancelled before start"
                )
                break
            else:
                return False
        # accounted like any terminal outcome (error row, zero device
        # time), so submitted == completed + in flight always holds
        self._account(item, idle=True)
        item.done.set()
        return True

    # ---- observability surface ----------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return self._depth_locked()

    def stats(self) -> Dict[str, Any]:
        """Aggregate and per-stage snapshot."""
        with self._stats_lock:
            stages = {
                name: dict(row) for name, row in self._stage_stats.items()
            }
            completed, errors = self._completed, self._errors
        with self._cv:
            depth = self._depth_locked()
            busy, busy_bg = self._busy, self._busy_bg
            n_lanes, max_depth = self.n_lanes, self.max_depth
            inline, peak = self.inline, self._peak_depth
            submitted = self._submitted
        for row in stages.values():
            n = max(row["count"], 1)
            row["queue_wait_mean_ms"] = round(row["queue_wait_s"] / n * 1e3, 3)
            row["device_mean_ms"] = round(row["device_s"] / n * 1e3, 3)
            row["queue_wait_s"] = round(row["queue_wait_s"], 6)
            row["device_s"] = round(row["device_s"], 6)
        return {
            "n_lanes": n_lanes,
            "max_depth": max_depth,
            "inline": inline,
            "queue_depth": depth,
            "peak_depth": peak,
            "busy_lanes": busy,
            "busy_background": busy_bg,
            "submitted": submitted,
            "completed": completed,
            "errors": errors,
            "stages": stages,
        }

    def telemetry_gauges(self) -> Dict[str, float]:
        """Live gauges for the telemetry sampler (``dispatch_*``)."""
        with self._cv:
            depth = self._depth_locked()
            pf_depth = len(self._ready_pf)
            busy, busy_bg = self._busy, self._busy_bg
            n_lanes = self.n_lanes
        return {
            "dispatch_queue_depth": float(depth),
            "dispatch_prefill_queue_depth": float(pf_depth),
            "dispatch_occupancy": busy / n_lanes,
            "dispatch_lanes": float(n_lanes),
            "dispatch_busy_background": float(busy_bg),
        }

    def telemetry_counters(self) -> Dict[str, float]:
        """Cumulative per-stage device/queue time (ms) and item counts."""
        out: Dict[str, float] = {}
        with self._stats_lock:
            out["dispatch_items_total"] = float(self._completed)
            out["dispatch_errors_total"] = float(self._errors)
            for name, row in self._stage_stats.items():
                out[f"dispatch_device_ms_{name}"] = row["device_s"] * 1e3
                out[f"dispatch_queue_wait_ms_{name}"] = (
                    row["queue_wait_s"] * 1e3
                )
                out[f"dispatch_count_{name}"] = float(row["count"])
        return out

    def reset_stats(self) -> None:
        """Zero the per-stage aggregates (measurement windows)."""
        with self._stats_lock:
            self._stage_stats.clear()

    # ---- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work, fail queued items typed, join the lanes."""
        with self._cv:
            if not self._closed:
                self._closed = True
                queued = (
                    list(self._ready) + list(self._ready_pf)
                    + list(self._ready_bg)
                )
                self._ready.clear()
                self._ready_pf.clear()
                self._ready_bg.clear()
                self._cv.notify_all()
                for item in queued:
                    item.error = SpineClosed(
                        f"spine closed before {item.stage!r} ran"
                    )
                    self._account(item, idle=True)
                    item.done.set()
        deadline = _mono() + timeout
        for t in self._lanes:
            t.join(timeout=max(deadline - _mono(), 0.1))


# ---------------------------------------------------------------------------
# process singleton
# ---------------------------------------------------------------------------

_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[DispatchSpine] = None


def get_spine() -> DispatchSpine:
    global _GLOBAL
    s = _GLOBAL  # lock-free fast path; the lock only guards creation
    if s is not None:
        return s
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = DispatchSpine()
            atexit.register(_GLOBAL.close, 5.0)
        return _GLOBAL


def set_spine(spine: Optional[DispatchSpine]) -> Optional[DispatchSpine]:
    """Swap the process spine (tests, runtime config).  Returns the
    previous one; the caller owns closing it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, spine
        return prev


def configure(
    n_lanes: Optional[int] = None,
    max_depth: Optional[int] = None,
    inline: Optional[bool] = None,
) -> DispatchSpine:
    """Apply runtime config to the process spine."""
    return get_spine().reconfigure(
        n_lanes=n_lanes, max_depth=max_depth, inline=inline,
    )


def spine_run(stage: str, fn: Callable, *args, **kwargs) -> Any:
    """The call-site idiom for routing device work through the process
    spine."""
    return get_spine().run(stage, fn, *args, **kwargs)


def spine_issue(stage: str, fn: Callable, *args, **kwargs) -> SpineTicket:
    """:func:`spine_run` up to the fetch: returns the ticket once the item
    has issued."""
    return get_spine().issue(stage, fn, *args, **kwargs)


def spine_submit(stage: str, fn: Callable, *args, **kwargs) -> SpineTicket:
    """Async variant of :func:`spine_run`: the item runs on a lane thread."""
    return get_spine().submit(stage, fn, *args, **kwargs)
