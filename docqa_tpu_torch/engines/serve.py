"""Continuous-batching decode scheduler, counterpart of
``docqa_tpu/engines/serve.py``'s ``ContinuousBatcher``.

A fixed set of decode *slots* shares one paged KV block pool
(``engines/paged.py``):

* admission: every free slot is filled from the queue in one round; the
  round's prompts PACK into a flat token axis (starts RAGGED_ALIGN-aligned)
  and prefill in one ragged pass per token budget
  (``gen.prefill_token_buckets`` plus the full packed capacity), their K/V
  written straight into their block tables.  A copy-on-write prefix cache
  keyed by the submitter's ``prefix_key`` maps a cached, token-verified,
  aligned prompt prefix into a new request's table and prefills only the
  novel suffix (warm lanes pack and dispatch after the cold ones);
* decode: one chunk advances every live slot ``chunk`` tokens through the
  block tables — plain steps, or (greedy, ``speculative_k >= 2``)
  prompt-lookup verify steps of q_len K; attention is K1's paged decode
  kernel on the card (``ops/attention.paged_decode_attention``);
* retirement: a slot frees, and returns its blocks, as soon as its lane
  hits EOS or its token budget; blocks are allocated at admission (prompt
  + a grow margin) and grown before each chunk;
* pipelining: the worker keeps one decode chunk's results in flight past
  the host: chunk N+1 is issued before chunk N's packed results are read.
  Every chunk carries the slot->request mapping of its own dispatch, and
  tokens go only to slots whose occupant is still that request.  A slot
  retired on budget mid-pipeline decodes one extra chunk whose tokens are
  discarded; a capacity guard deactivates any lane before a K/V write could
  land past its allocated blocks, and such writes land on the pool's drop
  row, never on a live row.

Device work runs as dispatch-spine work items (``engines/spine.py``) on the
batcher's ONE CUDA stream (``spine.Lane``), so the reference's
donation-ordering argument holds unchanged: an in-flight chunk's stale
writes to freed blocks land before the prefill that reuses them.  The
worker issues each item (on its own thread while a spine slot is free) before
it touches batcher state again.
A chunk is one item, ``serve_decode_chunk`` (the chunk and the start of
its packed results' copy to pinned memory), and its fetch is the item's
result, which waits for the item's end event and reads its device time:
the worker issues chunk N+1 before it fetches and processes chunk N, so the
plain chunk's ``chunk`` steps run on the device while the host processes
the chunk before, as in the reference.  The speculative chunk is the
reference's ``lax.while_loop``, whose condition costs one small
device->host fetch per verify step, so its item waits on the device as it
issues.  An admission round is one item, ``serve_prefill_fetch`` (the
packed prefill groups, the slot-state scatter and the first tokens' copy),
fetched at once; the reference's separate ``serve_prefill`` and
``serve_decode`` dispatch items have no counterpart.

Serve == solo.  XLA keeps batcher output bitwise equal to the solo engine
through RAGGED_ALIGN; on a card cuBLAS and K1's split count change with
the batch shape, so the port states a weaker guarantee:
* float32 on the CPU: greedy tokens identical to the solo engine (and to
  ``docqa_tpu``'s), speculation on or off, warm or cold;
* bf16 on the card: first-step logits of a prompt within a stated
  tolerance of the solo engine's (``chip_smoke.py`` holds it), tokens
  allowed to diverge where two logits tie within bf16 rounding.

KV preemption (``QoSConfig.preemption``): under block-pool pressure a
higher-ranked request evicts lower-ranked lanes (``engines/qos.py``), at
admission or when a live lane cannot grow.  A victim keeps its delivered
tokens and requeues (through the replica pool's ``on_preempt`` hook when
one is wired); its next admission re-prefills prompt + generated tokens, so
its stream never rewinds.  In float32 on the CPU the resumed stream equals
the unpreempted one; on the card the re-prefill computes the K/V that
decode computed before, so later tokens may part on bf16 ties.

Liveness contract (``engines/pool.py`` reads it): the worker stamps a
heartbeat every iteration and idle wakeup; ``cold`` holds until warm-up or
the first decode chunk, so a first-shape call is never read as a wedge;
``n_admitting`` shows work popped from the queue but not yet
slot-resident.  Fault sites: ``serve.worker_loop`` (top of each iteration)
and ``serve.decode_chunk`` (before each chunk's fetch).

A kernel or CUDA fault (``ops/_kernels.is_device_fault``) is never reset
around: the worker dies with it, and every request it holds, queued ones
included, fails with that original error.

Observability, as in the reference: a request carries its submitter's
trace and cost record (``make_request``); the worker records
``serve_queue_wait``, ``serve_prefill`` and ``serve_decode_chunk`` spans and
instant events on it explicitly, the waiter ``serve_result_wait``.  Each
spine item's measured device time is split across the requests it served
(prefill by novel tokens, a chunk equally over its occupants), so the
per-class sums of the cost ledger equal the spine's series for those
stages.  Sheds leave a pressure snapshot in the ledger
(``_record_shed``).  :meth:`ContinuousBatcher.annotate_costs` registers the
analytic cost models (``obs/observatory.py``); ``set_slo_probe`` wires the
burn probe that defers batch admission.  A plain ``stats`` counter stands
beside the metrics registry's counters.

On a mesh (the engine's ``mesh``, ``runtime/mesh.py``) the batcher serves
the engine's tensor-parallel shards, as the reference's does: its slots
round up to a multiple of the data axis, its paged pools hold this rank's
kv heads (``parallel/sharding.shard_paged_pools``: kv heads over model, the
block rows replicated over data, so every data rank runs every slot), and
each forward all-reduces twice a layer over the model axis and gathers its
logits once.  Every device phase is a named entry point whose arguments
are the host's decisions (:meth:`ContinuousBatcher.prefill_round`,
:meth:`~ContinuousBatcher.decode_chunk`, :meth:`~ContinuousBatcher.reset_state`,
:meth:`~ContinuousBatcher.warmup`): packed ids, positions, destination
rows, slots, block tables, the slots to deactivate and the per-dispatch
sampling seed.  Registered with a command stream, the leader publishes each
before it runs and a follower's batcher (no worker thread) replays it on
its own pools, so every rank samples the same tokens.
"""

from __future__ import annotations

import collections
import itertools
import threading
from dataclasses import dataclass, field
from time import monotonic as time_monotonic
from time import perf_counter as _now
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch import obs
from docqa_tpu_torch.engines.generate import accept_drafts, draft_tokens
from docqa_tpu_torch.engines.paged import (
    BlockAllocator,
    OutOfBlocks,
    PrefixCache,
    init_paged_pools,
    kv_bytes_per_token,
    paged_decode_forward,
    ragged_prefill_forward,
    share_alignment,
)
from docqa_tpu_torch.engines.qos import QoSPolicy, request_class
from docqa_tpu_torch.engines.spine import (
    Lane,
    SpineSaturated,
    spine_issue,
    to_host,
)
from docqa_tpu_torch.obs.costs import DEFAULT_COST_LEDGER, cost_record_of
from docqa_tpu_torch.obs.observatory import (
    DEFAULT_OBSERVATORY,
    causal_pairs,
    decoder_cost,
)
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.ops.attention import RAGGED_ALIGN
from docqa_tpu_torch.ops.sampling import sample
from docqa_tpu_torch.resilience import faults
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.runtime.mesh import mirrored
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import round_up

log = get_logger("docqa.serve")


@dataclass
class _Request:
    prompt_ids: List[int]
    max_new: int
    done: threading.Event = field(default_factory=threading.Event)
    tokens: List[int] = field(default_factory=list)
    error: Optional[BaseException] = None
    # notified whenever tokens grow or the request finishes (streaming)
    cv: threading.Condition = field(default_factory=threading.Condition)
    # end-to-end budget: the worker sheds the request (queued or live) the
    # moment it is gone
    deadline: Optional[Deadline] = None
    # the submitter's trace and span: the worker records this request's
    # spans on it explicitly (it serves many requests, so it never uses the
    # context var); None = untraced, every hook no-ops
    trace: Optional[Any] = None
    span_parent: Optional[str] = None
    t_submit: float = 0.0
    # when the request last entered a queue (reset on every bounce)
    t_queue: float = 0.0
    # cooperative cancellation: dropped at the next admission round, or
    # retired at the next chunk boundary
    cancelled: bool = False
    # prefix-cache key (for /ask: template hash + chunk-set hash); None =
    # always cold
    prefix_key: Optional[str] = None
    # admission class for the QoS queue and preemption ranks
    req_class: str = "interactive"
    # replica hops taken by pool failover / preemption requeue
    hops: int = 0
    # the request's CostRecord (obs/costs.py): queue wait, device ms and KV
    # block-seconds land here; retired once, at _finish.  None = ledger off
    cost: Optional[Any] = None
    # a hedge twin shares its primary's record but must not retire it
    cost_shadow: bool = False
    # shed and retired by the pool's terminal decision, not by one
    # replica's refusal (which routing may retry)
    pool_managed: bool = False


def make_request(
    prompt_ids: Sequence[int],
    max_new: int,
    deadline: Optional[Deadline] = None,
    prefix_key: Optional[str] = None,
    req_class: Optional[str] = None,
    cost: Optional[Any] = None,
) -> _Request:
    """Build a :class:`_Request`, capturing the submitter's trace position
    and cost record; a request already past its deadline is shed here,
    before it takes a queue slot.

    The record is, in order: ``cost`` (a hedge twin shares its primary's),
    the record the endpoint stamped on the trace, or a fresh one of
    ``req_class`` (default interactive)."""
    if deadline is not None and deadline.expired:
        DEFAULT_REGISTRY.counter("serve_deadline_shed").inc()
        deadline.check("serve_submit")
    req = _Request(
        list(prompt_ids), max_new, deadline=deadline, prefix_key=prefix_key,
        req_class=req_class or "interactive",
    )
    ctx = obs.current()
    if ctx is not None:
        req.trace = ctx.trace
        req.span_parent = ctx.span_id
    req.cost = cost if cost is not None else cost_record_of(req.trace)
    if req.cost is None:
        req.cost = DEFAULT_COST_LEDGER.open(req.req_class, session=prefix_key)
    else:
        req.cost.set_session(prefix_key)
    req.t_submit = _now()
    req.t_queue = req.t_submit
    return req


def _cost_add(req: _Request, field: str, value: float) -> None:
    if req.cost is not None and value:
        req.cost.add(field, value)


def _cost_outcome(req: _Request) -> str:
    """A finished request's ledger outcome, from its typed error."""
    e = req.error
    if e is None:
        return "ok"
    if isinstance(e, DeadlineExceeded):
        return "shed_deadline"
    if isinstance(e, BlockPoolExhausted):
        return "shed_block_pool"
    if isinstance(e, SpineSaturated):
        return "shed_spine"
    if isinstance(e, DeferredByPolicy):
        # before the QueueFull it subclasses: a policy choice, not a
        # capacity shed
        return "shed_deferred"
    if isinstance(e, QueueFull):
        return "shed_queue"
    if isinstance(e, RequestCancelled):
        return "cancelled"
    if isinstance(e, WorkerDied):
        return "failed_replica"
    return "error"


def _req_span(req: _Request, name: str, t0: float, t1: float, **attrs) -> None:
    """Attribute a measured interval to the request's trace (no-op when
    untraced), parented under the span current at submit time."""
    if req.trace is not None:
        req.trace.record_span(
            name, t0, t1, parent_id=req.span_parent, **attrs
        )


def _req_mark(req: _Request, reason: str, anomalous: bool = True, **attrs):
    """An instant event on the request's trace; ``anomalous`` also flags
    the trace for the flight recorder's always-keep ring."""
    if req.trace is not None:
        if anomalous:
            req.trace.flag(reason)
        req.trace.add_event(reason, span_id=req.span_parent, **attrs)


# one wait policy for every consumer of a Handle
DEFAULT_RESULT_TIMEOUT = 600.0


def _finish(req: _Request) -> None:
    """Mark a request terminal and wake streamers: the one completion path,
    and the one cost retirement (typed outcome, exactly once; a hedge twin
    never retires its shared record)."""
    if req.cost is not None and not req.cost_shadow:
        DEFAULT_COST_LEDGER.retire(req.cost, _cost_outcome(req))
    req.done.set()
    with req.cv:
        req.cv.notify_all()


class WorkerDied(RuntimeError):
    """The batcher's worker thread died; waiters fail at once, typed,
    instead of hanging to their :class:`ResultTimeout`."""


class RequestCancelled(RuntimeError):
    """The request was cancelled; its lane was released before
    completion."""


class ResultTimeout(TimeoutError):
    """``Handle.result()``/``iter_tokens()`` waited out its timeout while
    the request was still decoding (slow, as opposed to shed)."""

    def __init__(self, waited_s: Optional[float]) -> None:
        self.waited_s = waited_s
        detail = "" if waited_s is None else f" after {waited_s:.1f}s"
        super().__init__(f"generation timed out{detail}")


class Handle:
    """Future-like result for a submitted request."""

    def __init__(self, req: _Request) -> None:
        self._req = req

    def result(
        self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT
    ) -> List[int]:
        t0 = _now()
        try:
            dl = self._req.deadline
            if dl is not None:
                timeout = dl.bound(timeout)
            if not self._req.done.wait(timeout):
                if dl is not None and dl.expired:
                    _req_mark(
                        self._req, "deadline_exceeded", stage="serve_result"
                    )
                    raise DeadlineExceeded("serve_result", -dl.remaining())
                _req_mark(self._req, "result_timeout")
                raise ResultTimeout(timeout)
            if self._req.error is not None:
                raise self._req.error
            return list(self._req.tokens)
        finally:
            # the waiter-side span overlaps the worker's decode-chunk spans,
            # so coverage stays gapless from submission to delivery
            _req_span(self._req, "serve_result_wait", t0, _now())

    def text(
        self, tokenizer, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT
    ) -> str:
        """Wait and detokenize."""
        return tokenizer.decode_ids(self.result(timeout))

    def cancel(self) -> None:
        """Best-effort cancellation (see :class:`_Request`)."""
        self._req.cancelled = True

    @property
    def started(self) -> bool:
        """A first token arrived, or the request is already finished."""
        return bool(self._req.tokens) or self._req.done.is_set()

    def iter_tokens(self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT):
        """Stream token ids as decode chunks land: every token exactly once,
        in order; raises the request's error (or a timeout) instead of
        returning partial output silently."""
        req = self._req
        sent = 0
        if req.deadline is not None:
            timeout = req.deadline.bound(timeout)

        def _timed_out():
            if req.deadline is not None and req.deadline.expired:
                _req_mark(req, "deadline_exceeded", stage="serve_result")
                raise DeadlineExceeded(
                    "serve_result", -req.deadline.remaining()
                )
            _req_mark(req, "result_timeout")
            raise ResultTimeout(timeout)

        deadline = None if timeout is None else time_monotonic() + timeout
        t0 = _now()
        try:
            while True:
                with req.cv:
                    while len(req.tokens) <= sent and not req.done.is_set():
                        remaining = (
                            None if deadline is None
                            else deadline - time_monotonic()
                        )
                        if remaining is not None and remaining <= 0:
                            _timed_out()
                        if not req.cv.wait(remaining):
                            _timed_out()
                    fresh = list(req.tokens[sent:])
                sent += len(fresh)
                for t in fresh:
                    yield t
                if req.done.is_set() and sent >= len(req.tokens):
                    if req.error is not None:
                        raise req.error
                    return
        finally:
            # on exhaust, error and generator close (client disconnect)
            _req_span(req, "serve_result_wait", t0, _now(), streaming=True)


class QueueFull(RuntimeError):
    """Admission control: the wait queue is at capacity (an HTTP 503).
    Carries the load snapshot at rejection time."""

    def __init__(
        self,
        message: str,
        n_queued: Optional[int] = None,
        n_active: Optional[int] = None,
    ) -> None:
        self.n_queued = n_queued
        self.n_active = n_active
        if n_queued is not None or n_active is not None:
            message = f"{message} (queued={n_queued}, active={n_active})"
        super().__init__(message)


class Draining(QueueFull):
    """Admission refused because the batcher is draining."""


class BlockPoolExhausted(QueueFull):
    """The KV block pool ran dry: at submit, when the queue is full AND the
    pool has no free block; on a request's handle, when its lane could not
    grow mid-decode in an overcommitted pool.  Requests merely waiting for
    blocks stay queued under their deadline."""


class DeferredByPolicy(QueueFull):
    """QoS deferral of batch admission while an interactive SLO burns
    (``QoSConfig.defer_batch_on_burn`` with a probe wired by
    ``set_slo_probe``)."""


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host array (never sharing the host buffer)."""
    return torch.tensor(arr, device=device)


class ContinuousBatcher:
    """Slot-based continuous batching over a ``GenerateEngine``'s model, on
    the engine's device."""

    def __init__(
        self,
        engine,  # GenerateEngine: supplies cfg/gen/params/tokenizer/device
        n_slots: Optional[int] = None,
        chunk: Optional[int] = None,
        cache_len: Optional[int] = None,
        seed: int = 0,
        max_queue: Optional[int] = 256,
        kv_block_size: Optional[int] = None,
        kv_pool_tokens: Optional[int] = None,
        prefix_cache: Optional[bool] = None,
        qos=None,  # config.QoSConfig | qos.QoSPolicy | None (FIFO)
    ) -> None:
        self.engine = engine
        self.cfg = engine.cfg
        self.gen = engine.gen
        self.device = engine.device
        self.mesh = getattr(engine, "mesh", None)
        self.n_slots = n_slots or self.gen.max_concurrent
        if self.mesh is not None and self.n_slots % self.mesh.n_data:
            self.n_slots = round_up(self.n_slots, self.mesh.n_data)
        self.chunk = chunk or self.gen.decode_chunk
        self.cache_len = round_up(cache_len or self.cfg.max_seq_len, 128)
        self._seed = seed
        self._rng_counter = itertools.count(1)
        self.max_queue = max_queue
        # prompt-lookup speculation (greedy only)
        self.spec_k = (
            self.gen.speculative_k
            if self.gen.speculative_k >= 2 and self.gen.temperature == 0.0
            else 0
        )
        # work counts (the reference's registry counters are not ported):
        # verify_steps / decode_steps are forwards of the decode programs —
        # each launches the paged decode kernel once per layer
        self.stats: collections.Counter = collections.Counter()

        # ---- paged KV geometry ----
        self.block_size = int(kv_block_size or self.gen.kv_block_size)
        self.block_size = max(1, min(self.block_size, self.cache_len))
        self.blocks_per_seq = -(-self.cache_len // self.block_size)
        self.seq_capacity = self.blocks_per_seq * self.block_size
        pool_tokens = (
            kv_pool_tokens
            or self.gen.kv_pool_tokens
            or self.n_slots * self.seq_capacity  # worst-case provisioning
        )
        self.n_blocks = max(
            self.blocks_per_seq, -(-int(pool_tokens) // self.block_size)
        )
        # ragged-prefill token budgets: clamped to the packed capacity one
        # maximal prompt needs, which is always included
        usable = self.cache_len - 2 - self.spec_k
        full_t = round_up(max(usable, 1), RAGGED_ALIGN)
        self._token_buckets = sorted(
            {
                min(round_up(int(t), RAGGED_ALIGN), full_t)
                for t in self.gen.prefill_token_buckets
                if int(t) > 0
            }
            | {full_t}
        )
        # grow-at-decode margin: a pipelined chunk can run one dispatch past
        # the host's token count, and a spec dispatch emits up to chunk-1+K
        self._grow_margin = 2 * (self.chunk + max(self.spec_k, 1)) + 2

        self._alloc = BlockAllocator(self.n_blocks, self.block_size)
        # copy-on-write prefix cache: shared runs are full blocks AND
        # RAGGED_ALIGN-aligned; disabled when one unit reaches the capacity
        self._share_align = share_alignment(self.block_size)
        self._prefix_cache: Optional[PrefixCache] = None
        want_cache = (
            bool(self.gen.prefix_cache)
            if prefix_cache is None
            else bool(prefix_cache)
        )
        if want_cache and self._share_align < self.seq_capacity:
            self._prefix_cache = PrefixCache(
                self._alloc, self._share_align,
                max_entries=int(self.gen.prefix_cache_entries),
            )
        self._lane = Lane(self.device)
        # the burn probe batch deferral reads (set_slo_probe); None = off
        self._slo_probe = None
        # on a mesh with a command stream: a target of its own (replicas and
        # rebuilds register in one order on every rank); a follower's
        # batcher runs no worker, only the leader's commands
        stream = getattr(engine, "_command_stream", None)
        self._follower = stream is not None and stream.follower
        if stream is not None:
            stream.register_auto("batcher", self)
        self._on_lane("serve_alloc", self._init_device_state).result()

        # host-side slot bookkeeping (worker-thread state)
        self._slot_req: List[Optional[_Request]] = [None] * self.n_slots
        self._slot_budget = np.zeros((self.n_slots,), np.int64)
        # prompt tokens each occupied slot was admitted with: with the
        # delivered-token count, the lane's KV length on the host
        self._slot_prompt = [0] * self.n_slots
        # per-request block tables and their device mirror: the flat
        # [n_slots, blocks_per_seq] int32 table (sentinel n_blocks = hole),
        # re-uploaded only when dirty
        self._slot_table: List[Optional[Any]] = [None] * self.n_slots
        self._block_rows = np.full(
            (self.n_slots, self.blocks_per_seq), self.n_blocks, np.int32
        )
        self._caps_np = np.zeros((self.n_slots,), np.int32)
        self._tables_dev = None
        self._caps_dev = None
        self._tables_dirty = True
        # slots retired on the host whose device `active` lane is not
        # cleared yet: applied first in the next device work item
        self._deact_pending: List[int] = []
        # id() of the queue head last counted block-starved: one count per
        # starvation episode, not per worker poll (guarded by _cv)
        self._block_wait_marked: Optional[int] = None

        self._qos: Optional[QoSPolicy] = QoSPolicy.coerce(qos)
        if self._qos is not None:
            self._queue: Any = self._qos.make_queue(now_fn=_now)
        else:
            self._queue = collections.deque()
        self._cv = threading.Condition()
        self._stopped = False
        # requests popped from the queue but not yet slot-resident (guarded
        # by _cv): drain() counts them as pending, and the death/kill sweeps
        # must see them
        self._admitting_reqs: List[_Request] = []
        # liveness contract (engines/pool.py): the worker stamps _beat every
        # loop iteration and idle wakeup, so a stale beat with work pending
        # is a wedge inside one iteration, not idleness
        self._beat = time_monotonic()
        # last processed decode chunk: recent progress is a passed canary
        self._last_progress = 0.0
        # True until warmup() completes or the first decode chunk lands: a
        # cold iteration may hold a kernel build or a first-shape call
        self._cold = True
        self._worker_dead = False
        self._death_cause: Optional[BaseException] = None
        # the kernel or CUDA fault the worker died of, if it did
        self.device_fault: Optional[BaseException] = None
        self._draining = False
        # called from the dying worker with (batcher, queued requests);
        # returns the requests it could NOT rescue
        self.on_worker_death = None
        # called from the worker (outside _cv) with (batcher, victim) when a
        # preemption victim needs a requeue; True when the hook placed,
        # parked or typed-failed it, else it requeues locally
        self.on_preempt = None
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="continuous-batcher"
        )
        if not self._follower:
            self._worker.start()

    # ---- device programs -----------------------------------------------------

    def _on_lane(self, stage: str, fn, *args, stream: str = "serve",
                 cost_key: Any = None):
        """Issue ``fn`` as a spine work item on this batcher's lane stream
        (inference mode); returns its ticket once the item has issued."""
        with self._lane.active():
            return spine_issue(
                stage, fn, *args, stream=stream, cost_key=cost_key,
                device=self.device,
            )

    def _next_seed(self) -> Optional[int]:
        """The sampling seed of one dispatch, from the batcher's seed and a
        counter (``next`` on itertools.count is atomic); None when greedy.
        It rides the dispatch's command, so every rank draws alike."""
        if self.gen.temperature == 0.0:
            return None
        return self._seed * 100_003 + next(self._rng_counter)

    def _generator(self, seed: Optional[int]) -> Optional[torch.Generator]:
        if seed is None:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _prefill_program(self, ids, seg, pos, dest, last_rows, slots,
                         generator, block_tables=None, prefix_lens=None):
        """Ragged prefill of one packed group (engines/paged.py), in place
        on the pools; returns the sampled first tokens [n_slots].

        ``ids``/``seg``/``pos``/``dest`` [T] are the packed stream (padding:
        seg -1, dest on the drop row), ``last_rows`` [n_slots] each lane's
        last prompt row, ``slots`` [n_slots] each lane's slot (padding lanes
        carry n_slots, the spare row of the drafting table).  With
        speculation on, the admitted slots' drafting-table rows are REPLACED
        by each prompt's bigrams plus the confirmed (last prompt token ->
        first token) pair.  WARM (``block_tables``/``prefix_lens`` set):
        the stream holds only each lane's novel suffix and attention also
        reads the cached prefix through the tables."""
        S = self.n_slots
        warm_kw = {}
        if block_tables is not None:
            warm_kw = dict(
                block_tables=block_tables, prefix_lens=prefix_lens,
                n_prefix_rows=self.seq_capacity, block_size=self.block_size,
            )
        logits = ragged_prefill_forward(
            self.engine.params, self.cfg, self._pools, ids, seg, pos, dest,
            last_rows, rope_len=self.seq_capacity, mesh=self.mesh, **warm_kw,
        )
        toks = sample(
            logits, generator, self.gen.temperature, self.gen.top_k,
            self.gen.top_p,
        )
        if not self.spec_k:
            return toks
        # bigram rows from the packed stream: a (prev, next) pair wherever
        # two adjacent packed tokens share a segment; the spare row S and
        # spare column vocab take the pairs the reference drops
        vocab = self.cfg.vocab_size
        prev, nxt = ids[:-1], ids[1:]
        pair_ok = (seg[:-1] == seg[1:]) & (seg[:-1] >= 0)
        lane = torch.where(pair_ok, seg[:-1], S)
        prev = torch.where(pair_ok, prev, vocab)
        rows = torch.full((S + 1, vocab + 1), -1, dtype=torch.long, device=ids.device)
        rows[lane, prev] = nxt
        rows[torch.arange(S, device=ids.device), ids[last_rows]] = toks
        self._table[slots] = rows[:S]
        return toks

    def _decode_program(self, tables, caps, generator):
        """Advance every active slot ``chunk`` tokens (plain steps, no host
        sync).  Returns packed [S, 2*chunk + 1] int64: tokens (pad on
        inactive steps), valid flags (EOS excluded), the active flag."""
        S, C = self.n_slots, self.chunk
        pad, eos = self.gen.pad_id, self.gen.eos_id
        out = torch.full((S, C), pad, dtype=torch.long, device=self.device)
        valid = torch.zeros((S, C), dtype=torch.bool, device=self.device)
        tok, lengths, active = self._tok, self._lengths, self._active
        for t in range(C):
            logits = paged_decode_forward(
                self.engine.params, self.cfg, self._pools, tables,
                tok[:, None], lengths, block_size=self.block_size,
                rope_len=self.seq_capacity, mesh=self.mesh,
            )
            self.stats["decode_steps"] += 1
            nxt = sample(
                logits[:, 0], generator, self.gen.temperature,
                self.gen.top_k, self.gen.top_p,
            )
            nxt = torch.where(active, nxt, pad)
            is_eos = active & (nxt == eos)
            out[:, t] = nxt
            valid[:, t] = active & ~is_eos
            lengths = lengths + active.to(lengths.dtype)
            active = active & ~is_eos
            # capacity guard: the next step writes row `lengths`; a lane at
            # its last ALLOCATED row stops here
            active = active & (lengths < caps) & (lengths < self.cache_len)
            tok = torch.where(active, nxt, tok)
        self._tok, self._lengths, self._active = tok, lengths, active
        return torch.cat([out, valid.long(), active.long()[:, None]], dim=1)

    def _decode_spec_program(self, tables, caps):
        """Speculative chunk: verify steps until every live slot has emitted
        >= ``chunk`` tokens or retired.  Each step drafts K-1 tokens per slot
        from its bigram row and verifies them in ONE forward of q_len K
        (``draft_tokens``/``accept_drafts``, the solo engine's halves),
        emitting the matched prefix + bonus — output-exact with the plain
        program.  The loop condition is one small fetch per step.

        Returns (packed [S, chunk + 2K + 2] int64, verify steps run): token
        slab (sized so the K-wide write at n_out never runs off its end),
        per-slot emission count, active flag."""
        S, K, C = self.n_slots, self.spec_k, self.chunk
        pad = self.gen.pad_id
        dev = self.device
        width = C + 2 * K
        karange = torch.arange(K, device=dev)[None, :]
        out = torch.full((S, width), pad, dtype=torch.long, device=dev)
        n_out = torch.zeros((S,), dtype=torch.long, device=dev)
        table = self._table[:S]  # view: in-place bigram confirmations
        tok, lengths, active = self._tok, self._lengths, self._active
        steps = 0
        while bool((active & (n_out < C)).any()):
            steps += 1
            drafts = draft_tokens(table, tok, K)
            verify_in = torch.cat([tok[:, None], drafts], dim=1)
            logits = paged_decode_forward(
                self.engine.params, self.cfg, self._pools, tables, verify_in,
                lengths, block_size=self.block_size, rope_len=self.seq_capacity,
                mesh=self.mesh,
            )
            self.stats["verify_steps"] += 1
            g, m, cand, is_eos, eos_pos = accept_drafts(
                logits, drafts, self.gen.eos_id
            )
            # slots that filled their chunk quota freeze until next dispatch
            live = active & (n_out < C)
            emit_valid = cand & (karange < eos_pos[:, None]) & live[:, None]
            emitted = torch.where(emit_valid, g, pad)
            out.scatter_(1, n_out[:, None] + karange, emitted)
            n_valid = emit_valid.long().sum(dim=1)
            n_out = n_out + n_valid
            saw_eos = live & is_eos.any(dim=1)
            last_tok = emitted.gather(1, (n_valid - 1).clamp(min=0)[:, None])[:, 0]
            self.engine.confirm_bigrams(table, tok, g, emit_valid)
            lengths = lengths + torch.where(active, n_valid, 0).to(lengths.dtype)
            active = active & ~saw_eos
            # capacity guard: a verify writes rows [lengths, lengths + K)
            active = active & (lengths <= caps - K) & (lengths < self.cache_len - K)
            tok = torch.where(active & (n_valid > 0), last_tok, tok)
        self._tok, self._lengths, self._active = tok, lengths, active
        return (
            torch.cat([out, n_out[:, None], active.long()[:, None]], dim=1),
            steps,
        )

    def _init_device_state(self):
        """Fresh pools and zeroed slot state assigned to self: the spine
        items ``serve_alloc`` (construction) and ``serve_reset`` (the
        failed-dispatch reset).  The drafting table carries a spare row
        (index n_slots) and a spare column (index vocab) for the writes the
        reference drops."""
        S, dev = self.n_slots, self.device
        self._pools = init_paged_pools(
            self.cfg, self.n_blocks, self.block_size,
            dtype=self.engine.params["tok_emb"].dtype, device=dev, mesh=self.mesh,
        )
        self._table = (
            torch.full((S + 1, self.cfg.vocab_size + 1), -1, dtype=torch.long, device=dev)
            if self.spec_k else None
        )
        self._tok = torch.zeros((S,), dtype=torch.long, device=dev)
        self._lengths = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._active = torch.zeros((S,), dtype=torch.bool, device=dev)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """:meth:`_warmup` as a command: every rank of a mesh warms alike."""
        mirrored(self, "warmup", self._warmup,
                 None if buckets is None else [int(b) for b in buckets])

    def _warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run the admission path's shapes once on throwaway state before
        traffic, each as a background spine item (``serve_warmup``): one
        ragged prefill per packed token budget (and its warm variant with
        the prefix cache on) and one decode/verify step.  This builds the
        kernel library and pays first-call costs; live slots are untouched.
        ``buckets`` narrows the budgets to those the given prompt sizes pack
        into (default: every budget).  A kernel that fails to build or
        launch raises here.  Clears :attr:`cold`."""
        S, dev = self.n_slots, self.device
        nb = self.blocks_per_seq
        if buckets is None:
            warm = list(self._token_buckets)
        else:
            warm = sorted({self._pick_token_bucket(int(b)) for b in buckets})

        def fresh_pools():
            return init_paged_pools(
                self.cfg, nb, self.block_size,
                dtype=self.engine.params["tok_emb"].dtype, device=dev,
                mesh=self.mesh,
            )

        def sentinel():
            return torch.full((S, nb), nb, dtype=torch.int32, device=dev)

        def warm_prefill(T: int, prefix: bool):
            kw = {}
            if prefix:
                kw = dict(
                    block_tables=sentinel(),
                    prefix_lens=torch.zeros((S,), dtype=torch.long, device=dev),
                    n_prefix_rows=self.seq_capacity,
                    block_size=self.block_size,
                )
            zeros = torch.zeros((T,), dtype=torch.long, device=dev)
            return ragged_prefill_forward(
                self.engine.params, self.cfg, fresh_pools(), zeros,
                torch.full((T,), -1, dtype=torch.long, device=dev), zeros,
                torch.full((T,), nb * self.block_size, device=dev),
                torch.zeros((S,), dtype=torch.long, device=dev),
                rope_len=self.seq_capacity, mesh=self.mesh, **kw,
            )

        def warm_decode():
            s = self.spec_k or 1
            return paged_decode_forward(
                self.engine.params, self.cfg, fresh_pools(), sentinel(),
                torch.zeros((S, s), dtype=torch.long, device=dev),
                torch.zeros((S,), dtype=torch.int32, device=dev),
                block_size=self.block_size, rope_len=self.seq_capacity,
                mesh=self.mesh,
            ).sum().item()

        for T in warm:
            variants = [False] + ([True] if self._prefix_cache is not None else [])
            for prefix in variants:
                self._on_lane(
                    "serve_warmup", warm_prefill, T, prefix, stream="warmup"
                ).result()
        self._on_lane("serve_warmup", warm_decode, stream="warmup").result()
        # one paged forward outside any chunk: launch identities count it
        self.stats["warmup_steps"] += 1
        self._cold = False

    def annotate_costs(self) -> bool:
        """Register the analytic cost models of the batcher's two costed
        stages with the observatory (``obs/observatory.py``), so the spine's
        measured device time yields per-stage MFU: ``serve_prefill_fetch``
        (keys ``("prefill", T, lanes, pairs, kv_rows)``, one per packed
        group) and ``serve_decode_chunk`` (``("decode", lanes, q, steps,
        pairs, kv_rows)``).  Returns True."""
        cfg = self.cfg

        def prefill_cost(key):
            _tag, T, lanes, pairs, kv_rows = key
            return decoder_cost(cfg, T, lanes, pairs, kv_rows)

        def decode_cost(key):
            _tag, lanes, q, steps, pairs, kv_rows = key
            return decoder_cost(
                cfg, lanes * q, lanes * q, pairs, kv_rows, forwards=steps
            )

        DEFAULT_OBSERVATORY.annotate_model("serve_prefill_fetch", prefill_cost)
        DEFAULT_OBSERVATORY.annotate_model("serve_decode_chunk", decode_cost)
        return True

    def _pick_token_bucket(self, n_tokens: int) -> int:
        """Smallest packed token budget covering ``n_tokens`` (the largest
        for anything bigger: admission splits into several passes)."""
        for t in self._token_buckets:
            if n_tokens <= t:
                return t
        return self._token_buckets[-1]

    # ---- public API ----------------------------------------------------------

    @property
    def prefix_cache_enabled(self) -> bool:
        """Submitters (service/qa.py) check this before passing a key."""
        return self._prefix_cache is not None

    def submit_ids(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        prefix_key: Optional[str] = None,
        req_class: Optional[str] = None,
    ) -> Handle:
        max_new = max_new_tokens or self.gen.max_new_tokens
        return self.submit_request(
            make_request(
                prompt_ids, max_new, deadline=deadline,
                prefix_key=prefix_key, req_class=req_class,
            )
        )

    def submit_request(self, req: _Request) -> Handle:
        """Admit an already-built :class:`_Request` (the pool's requeue
        re-admits the same object on another replica).  Every refusal
        leaves a shed snapshot and retires the request's cost record,
        except for pool-managed requests, whose refusal is routing."""
        # the burn probe takes the SLO evaluator's lock: read it before the
        # batcher's, so the two never nest
        firing = (self._slo_firing()
                  if not req.pool_managed and self._qos is not None else [])
        with self._cv:
            if self._worker_dead:
                self._record_shed(
                    req, "worker_dead", outcome="failed_replica",
                    stage="serve_submit",
                )
                if self.device_fault is not None:
                    raise self.device_fault
                raise WorkerDied(f"batcher worker is dead: {self._death_cause!r}")
            if self._stopped:
                self._record_shed(
                    req, "stopped", outcome="error", stage="serve_submit",
                )
                raise RuntimeError("batcher is stopped")
            if self._draining:
                self._record_shed(
                    req, "draining", outcome="shed_queue",
                    stage="serve_submit", n_queued=len(self._queue),
                )
                raise Draining(
                    "batcher is draining",
                    n_queued=len(self._queue), n_active=self.n_active,
                )
            if not req.pool_managed and self._qos is not None:
                # SLO-aware self-protection: while an interactive SLO burns,
                # batch admission defers typed (the pool checks its managed
                # requests once, at dispatch)
                cls = request_class(req)
                if self._qos.should_defer(cls, firing):
                    DEFAULT_REGISTRY.counter("qos_deferred").inc()
                    DEFAULT_REGISTRY.counter(f"qos_deferred_{cls}").inc()
                    _req_mark(
                        req, "qos_deferred", stage="serve_submit",
                        firing=",".join(firing),
                    )
                    self._record_shed(
                        req, "deferred_by_policy", outcome="shed_deferred",
                        stage="serve_submit", firing=",".join(firing),
                    )
                    raise DeferredByPolicy(
                        "batch admission deferred: interactive SLO "
                        f"burning ({', '.join(firing)})",
                        n_queued=len(self._queue), n_active=self.n_active,
                    )
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                DEFAULT_REGISTRY.counter("serve_shed").inc()
                n_active = self.n_active
                if self._alloc.n_free == 0 and self._prefix_cache is not None:
                    # cached-but-idle prefixes give their blocks back
                    # before live work is shed
                    self._prefix_cache.evict_for(1)
                if self._alloc.n_free == 0:
                    # the queue backed up BECAUSE the pool is dry
                    DEFAULT_REGISTRY.counter("serve_block_shed").inc()
                    _req_mark(
                        req, "block_pool_exhausted", n_queued=len(self._queue)
                    )
                    self._record_shed(
                        req, "block_pool_exhausted", stage="serve_submit",
                        n_queued=len(self._queue), n_active=n_active,
                    )
                    raise BlockPoolExhausted(
                        "KV block pool exhausted and generation queue at "
                        f"capacity ({self.max_queue})",
                        n_queued=len(self._queue), n_active=n_active,
                    )
                _req_mark(req, "queue_full", n_queued=len(self._queue))
                self._record_shed(
                    req, "queue_full", stage="serve_submit",
                    n_queued=len(self._queue), n_active=n_active,
                )
                raise QueueFull(
                    f"generation queue at capacity ({self.max_queue})",
                    n_queued=len(self._queue), n_active=n_active,
                )
            req.t_queue = _now()
            self._queue.append(req)
            n_queued = len(self._queue)
            self._cv.notify_all()
        _req_mark(
            req, "serve_submit", anomalous=False,
            n_queued=n_queued, prompt_len=len(req.prompt_ids),
        )
        DEFAULT_REGISTRY.counter("serve_submitted").inc()
        return Handle(req)

    def submit_text(
        self,
        prompt: str,
        max_new_tokens: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        prefix_key: Optional[str] = None,
        req_class: Optional[str] = None,
    ) -> Handle:
        """The solo engine's text contract (chat template applied,
        template-aware truncation against this batcher's cache budget)."""
        usable = self.cache_len - 2 - self.spec_k
        return self.submit_ids(
            self.engine.encode_prompt(prompt, usable),
            max_new_tokens, deadline=deadline, prefix_key=prefix_key,
            req_class=req_class,
        )

    def generate_texts(
        self, prompts: Sequence[str], max_new_tokens: Optional[int] = None
    ) -> List[str]:
        """Batch convenience (the solo engine's contract), any N: a bulk
        batch waits for queue room instead of shedding mid-batch, bounded
        end to end by ``DEFAULT_RESULT_TIMEOUT``."""
        if self.max_queue == 0:
            raise QueueFull("batcher has queueing disabled (max_queue=0)")
        deadline = Deadline.after(DEFAULT_RESULT_TIMEOUT)
        handles = []
        for p in prompts:
            while True:
                try:
                    handles.append(
                        self.submit_text(
                            p, max_new_tokens, deadline=deadline,
                            req_class="batch",
                        )
                    )
                    break
                except DeadlineExceeded as e:
                    raise QueueFull(
                        "generation queue stayed full past the bulk "
                        f"budget ({e})",
                        n_queued=self.n_queued, n_active=self.n_active,
                    ) from e
                except QueueFull:
                    if deadline.expired:
                        raise
                    # woken when an admission round frees queue space
                    with self._cv:
                        self._cv.wait(deadline.bound(0.05))
        return [h.text(self.engine.tokenizer) for h in handles]

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._worker.ident is not None:
            self._worker.join(timeout=10)
        # sweep under the lock, the admission window included
        with self._cv:
            swept = (
                self._admitting_reqs
                + list(self._queue)
                + [r for r in self._slot_req if r]
            )
            self._admitting_reqs = []
            self._queue.clear()
        for req in swept:
            if not req.done.is_set():
                req.error = RuntimeError("batcher stopped")
                _finish(req)
        # block accounting closes with the batcher (release is idempotent)
        for slot in range(self.n_slots):
            self._release_slot_blocks(slot)
        if self._prefix_cache is not None:
            self._prefix_cache.clear()

    # ---- graceful drain -------------------------------------------------------

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admitting (new submissions raise :class:`Draining`), let
        queued and in-flight requests finish, then return True; False when
        not quiescent within ``timeout`` or the worker died.  The batcher
        stays alive; :meth:`resume` re-opens admission."""
        deadline = Deadline.after(timeout) if timeout is not None else None
        with self._cv:
            self._draining = True
            self._cv.notify_all()
            while (
                self._queue
                or self._admitting_reqs
                or any(r is not None for r in self._slot_req)
            ):
                if self._stopped or self._worker_dead:
                    return False
                if deadline is not None and deadline.expired:
                    return False
                wait_s = 0.1 if deadline is None else deadline.bound(0.1)
                self._cv.wait(wait_s)
            return True

    def resume(self) -> None:
        with self._cv:
            self._draining = False
            self._cv.notify_all()

    # ---- liveness contract (engines/pool.py) ---------------------------------

    @property
    def worker_alive(self) -> bool:
        """The worker loop can still make progress (thread running and not
        past its death handler)."""
        return self._worker.is_alive() and not self._worker_dead

    @property
    def heartbeat_age_s(self) -> float:
        """Seconds since the worker last stamped its heartbeat.  An idle
        worker re-stamps every 0.5 s wakeup, so a large age with work
        pending means the loop is wedged inside one iteration."""
        return time_monotonic() - self._beat

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def cold(self) -> bool:
        """True until :meth:`warmup` completes or the first decode chunk
        lands; a monitor must not read a cold worker's stale heartbeat as a
        wedge (its iteration may hold a kernel build)."""
        return self._cold

    @property
    def last_progress_age_s(self) -> float:
        """Seconds since the worker last processed a decode chunk (``inf``
        before the first)."""
        if not self._last_progress:
            return float("inf")
        return time_monotonic() - self._last_progress

    @property
    def n_admitting(self) -> int:
        """Requests popped from the queue but not yet slot-resident: work
        pending that neither ``n_queued`` nor ``n_active`` shows."""
        return len(self._admitting_reqs)

    def steal_queued(self) -> List[_Request]:
        """Atomically take every queued-but-unadmitted request (they own no
        slot, token or block)."""
        with self._cv:
            out = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        return out

    def fail_active(self, error: BaseException) -> None:
        """Typed-fail every slot-resident request (device state untouched)."""
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is not None and not req.done.is_set():
                req.error = error
                _req_mark(req, "replica_failed", slot=slot)
                _finish(req)

    def kill(self, error: BaseException) -> None:
        """Fail-fast teardown without joining the worker (it may be hung):
        mark stopped and dead, fail everything typed, close the block
        accounting."""
        with self._cv:
            self._stopped = True
            self._worker_dead = True
            queued = list(
                {
                    id(r): r
                    for r in self._admitting_reqs + list(self._queue)
                }.values()
            )
            self._admitting_reqs = []
            self._queue.clear()
            self._cv.notify_all()
        for req in queued:
            if not req.done.is_set():
                req.error = error
                _req_mark(req, "replica_killed", queued=True)
                _finish(req)
        self.fail_active(error)
        for slot in range(self.n_slots):
            self._release_slot_blocks(slot)
        if self._prefix_cache is not None:
            self._prefix_cache.clear()

    @property
    def n_active(self) -> int:
        return sum(1 for r in self._slot_req if r is not None)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def kv_bytes_per_token(self) -> int:
        """Device bytes one token of KV occupies (all layers)."""
        return kv_bytes_per_token(self.cfg)

    def kv_block_occupancy(self) -> Dict[str, float]:
        """Block-pool occupancy snapshot (lock-free reads; a sample that
        races a transition may miscount one block)."""
        bpt = self.kv_bytes_per_token
        used = self._alloc.blocks_in_use
        tokens = 0
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is not None:
                tokens += self._slot_prompt[slot] + len(req.tokens)
        out = {
            "blocks_total": self.n_blocks,
            "blocks_used": used,
            "block_size": self.block_size,
            "bytes_per_token": bpt,
            "pool_bytes": self.n_blocks * self.block_size * bpt,
            "used_bytes": used * self.block_size * bpt,
            "tokens_committed": tokens,
            "utilization": used / self.n_blocks,
        }
        if self._prefix_cache is not None:
            pstats = self._prefix_cache.stats()
            out["prefix_entries"] = pstats["entries"]
            out["prefix_blocks"] = pstats["pinned_blocks"]
            out["prefix_hits"] = pstats["hits"]
            out["prefix_misses"] = pstats["misses"]
            out["prefix_hit_rate"] = round(pstats["hit_rate"], 4)
            out["prefix_tokens_avoided"] = pstats["tokens_avoided"]
        return out

    def block_seconds(self) -> Dict[str, float]:
        """The pool's block-second ledger: total/billed/residual (residual
        ~0 after drain/stop)."""
        return self._alloc.block_seconds()

    def pressure_by_class(self) -> Dict[str, Any]:
        """Which request classes hold how many KV blocks, decode lanes and
        queue slots right now.  Lock-free (it may run on a thread that
        holds another batcher's lock): a sample racing a transition may
        miscount one lane."""
        by: Dict[str, Dict[str, int]] = {}

        def row(cls: str) -> Dict[str, int]:
            return by.setdefault(cls, {"kv_blocks": 0, "lanes": 0, "queued": 0})

        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is None:
                continue
            r = row(request_class(req))
            r["lanes"] += 1
            table = self._slot_table[slot]
            if table is not None:
                r["kv_blocks"] += len(table.blocks)
        try:
            queued = list(self._queue)
        except RuntimeError:  # deque mutated mid-iteration (lock-free)
            queued = []
        for req in queued:
            row(request_class(req))["queued"] += 1
        out: Dict[str, Any] = {
            "by_class": by,
            "free_blocks": self._alloc.n_free,
            "blocks_total": self.n_blocks,
        }
        if self._prefix_cache is not None:
            out["prefix_cache_blocks"] = int(
                self._prefix_cache.stats()["pinned_blocks"]
            )
        return out

    # ---- QoS: status and KV preemption ----------------------------------------

    def set_slo_probe(self, probe) -> None:
        """Wire the burn-rate probe (``obs.BurnRateEvaluator.firing``) that
        drives batch deferral; None disables deferral."""
        self._slo_probe = probe

    def _slo_firing(self) -> List[str]:
        probe = self._slo_probe
        if probe is None:
            return []
        try:
            return list(probe() or [])
        except Exception as e:
            if is_device_fault(e):
                raise
            # a broken probe must never take admission down with it
            return []

    def qos_status(self) -> Dict[str, Any]:
        """Policy state, live deferral and per-class queue depths
        (lock-free snapshot)."""
        if self._qos is None:
            return {"enabled": False}
        out: Dict[str, Any] = {"enabled": True}
        out.update(self._qos.status())
        firing = self._slo_firing()
        out["slo_firing"] = firing
        out["defer_active"] = self._qos.should_defer("batch", firing)
        depths = getattr(self._queue, "depths", None)
        if depths is not None:
            out["queued_by_class"] = depths()
        return out

    def _holders_snapshot(
        self, exclude_slot: Optional[int] = None
    ) -> List[Tuple[int, str, int]]:
        """(slot, class, reclaimable blocks) of every live lane: the victim
        selection input (exact on the worker thread, advisory elsewhere)."""
        out = []
        for slot in range(self.n_slots):
            if slot == exclude_slot:
                continue
            req = self._slot_req[slot]
            table = self._slot_table[slot]
            if req is None or table is None:
                continue
            out.append((slot, request_class(req), self._alloc.reclaimable(table)))
        return out

    def preemption_candidates(
        self, pressure_cls: str = "interactive"
    ) -> List[Dict[str, Any]]:
        """What preemption WOULD evict for ``pressure_cls`` pressure, in
        eviction order, in every mode including ``off`` (an operator's dry
        run)."""
        if self._qos is None:
            return []
        victims = QoSPolicy.order_victims(self._holders_snapshot(), pressure_cls)
        return [
            {"slot": s, "class": c, "reclaimable_blocks": r}
            for s, c, r in victims
        ]

    def _preempt_slot(self, slot: int, pressure_cls: str) -> Optional[_Request]:
        """Evict one victim lane's KV blocks (worker thread; does not take
        ``_cv``).  Returns the victim for the caller to requeue (its tokens
        stay on the request for the re-prefill), or None when its deadline
        cannot survive a second prefill: then it sheds typed here."""
        req = self._slot_req[slot]
        table = self._slot_table[slot]
        self._slot_req[slot] = None
        cls = request_class(req)
        was_released = table.released if table is not None else True
        self._release_slot_blocks(slot, req=req)
        if table is not None and not was_released:
            # the waste line: also billed under kv_block_seconds
            _cost_add(
                req, "preempted_block_seconds", table.billed_block_seconds
            )
        # the device lane deactivates in the next device work item
        self._deact_pending.append(slot)
        self.stats["preempted"] += 1
        DEFAULT_REGISTRY.counter("qos_preempted").inc()
        DEFAULT_REGISTRY.counter(f"qos_preempted_{cls}").inc()
        _req_mark(
            req, "pool_preempted", slot=slot, pressure_class=pressure_cls,
            tokens_so_far=len(req.tokens),
        )
        if req.deadline is not None and (
            req.deadline.expired
            or req.deadline.remaining() < self._qos.preempt_min_resume_s
        ):
            req.error = BlockPoolExhausted(
                f"preempted by {pressure_cls} pressure with too little "
                "deadline budget left to re-prefill",
                n_active=self.n_active,
            )
            DEFAULT_REGISTRY.counter("serve_block_shed").inc()
            DEFAULT_COST_LEDGER.record_shed(
                "preempted", cls=cls, stage="serve_preempt",
                pressure_class=pressure_cls,
            )
            _finish(req)
            return None
        return req

    def _requeue_preempted(self, victim: _Request) -> None:
        """Requeue a victim: the pool's hook first (it may place it on a
        replica with free blocks now), the local class head otherwise.
        Called outside ``_cv``: the hook takes the pool's and other
        replicas' locks."""
        cb = self.on_preempt
        if cb is not None:
            try:
                if cb(self, victim):
                    return
            except Exception:
                log.exception("on_preempt hook failed; requeueing locally")
        with self._cv:
            victim.t_queue = _now()
            self._queue.appendleft(victim)
            self._cv.notify_all()

    def _admission_preempt(
        self, head: _Request, planned: int, need: int,
        requeue_out: List[_Request],
    ) -> int:
        """Admission-side preemption (caller holds ``_cv``): evict
        lower-ranked lanes until ``planned + need`` blocks fit.  Victims go
        to ``requeue_out`` for the caller to requeue after it pops the head.
        Returns the head's re-estimated block need.  Advisory mode only
        counts, once per starvation episode."""
        cls = request_class(head)
        victims = QoSPolicy.order_victims(self._holders_snapshot(), cls)
        if not victims:
            return need
        if self._qos.preemption == "advisory":
            if self._block_wait_marked != id(head):
                DEFAULT_REGISTRY.counter("qos_preempt_advisory").inc()
                _req_mark(
                    head, "qos_preempt_advisory", anomalous=False,
                    candidates=[s for s, _c, _r in victims],
                )
            return need
        for slot, _vcls, _reclaim in victims:
            if self._alloc.can_alloc(planned + need):
                break
            victim = self._preempt_slot(slot, cls)
            if victim is not None:
                requeue_out.append(victim)
            need = self._blocks_for_admission(head)
        return need

    def _grow_preempt(self, slot: int, req: _Request, table, target: int) -> bool:
        """Mid-decode preemption (worker thread, outside ``_cv``): a live
        lane that cannot grow evicts lower-ranked lanes, one at a time,
        retrying the grow after each; True when the grow succeeded.  Stale
        in-flight writes to the freed blocks land before any reuse: the
        batcher's one stream runs its work in issue order."""
        if self._qos is None or self._qos.preemption != "on":
            return False
        victims = QoSPolicy.order_victims(
            self._holders_snapshot(exclude_slot=slot), request_class(req)
        )
        for vslot, _vcls, _reclaim in victims:
            victim = self._preempt_slot(vslot, request_class(req))
            if victim is not None:
                self._requeue_preempted(victim)
            try:
                table.ensure(target)
            except OutOfBlocks:
                continue
            row = self._block_rows[slot]
            row[: len(table.blocks)] = table.blocks
            self._caps_np[slot] = table.capacity
            self._tables_dirty = True
            return True
        return False

    def _record_shed(
        self, req: _Request, kind: str, outcome: Optional[str] = None,
        **attrs,
    ) -> None:
        """Shed forensics and terminal cost retirement for a request this
        batcher refuses at submit.  Pool-managed requests and hedge twins
        skip both: the pool may still place the former, and a twin's shared
        record belongs to its primary.  Safe under ``_cv`` (the pressure
        probe is lock-free)."""
        if req.pool_managed or req.cost_shadow:
            return
        cls = req.cost.cls if req.cost is not None else None
        DEFAULT_COST_LEDGER.record_shed(kind, cls=cls, **attrs)
        if req.cost is not None:
            DEFAULT_COST_LEDGER.retire(
                req.cost,
                outcome or (
                    "shed_block_pool" if kind == "block_pool_exhausted"
                    else "shed_queue"
                ),
            )

    # ---- worker loop ---------------------------------------------------------

    def _admit_round(self, pairs: List[Tuple[int, "_Request"]]):
        """Prefill every (slot, request) pair of this round through ragged
        packed passes, as one spine item (``serve_prefill_fetch``) that also
        scatters the slot state and copies the first tokens to the host;
        ``_finalize_admissions`` delivers them.  Each request's blocks are
        allocated here (prompt + grow margin, net of a shared cached
        prefix); a request the pool cannot hold goes back to the queue
        head."""
        # truncation keeps budget >= 1 for a maximal prompt (mirrors the
        # budget formula below)
        usable = self.cache_len - 2 - self.spec_k
        # entry: (slot, req, ids, table, shared); shared > 0 = WARM lane
        good: List[Tuple[int, "_Request", List[int], Any, int]] = []
        send_back: List["_Request"] = []
        for slot, req in pairs:
            if req.deadline is not None and req.deadline.expired:
                req.error = DeadlineExceeded(
                    "serve_admit", -req.deadline.remaining()
                )
                DEFAULT_REGISTRY.counter("serve_deadline_shed").inc()
                _req_mark(req, "deadline_exceeded", stage="serve_admit")
                DEFAULT_COST_LEDGER.record_shed(
                    "deadline",
                    cls=req.cost.cls if req.cost is not None else None,
                    stage="serve_admit",
                )
                _finish(req)
                continue
            try:
                # token-preserving re-prefill: a preemption victim re-admits
                # with its generated tokens appended, so the prefill's first
                # token is its NEXT token and its stream never rewinds
                ids = (
                    [int(t) for t in req.prompt_ids] + [int(t) for t in req.tokens]
                )[-usable:] or [self.gen.pad_id]
            except (TypeError, ValueError) as e:  # bad request: fail it alone
                req.error = e
                _finish(req)
                continue
            table = self._alloc.new_table()
            shared = 0
            try:
                if self._prefix_cache is not None:
                    shared = self._prefix_cache.acquire(req.prefix_key, ids, table)
                table.ensure(min(len(ids) + self._grow_margin, self.seq_capacity))
            except OutOfBlocks:
                # release first: a partial share would strand refcounts; the
                # moment of holding still bills
                table.release()
                _cost_add(req, "kv_block_seconds", table.billed_block_seconds)
                DEFAULT_REGISTRY.counter("serve_block_pool_wait").inc()
                _req_mark(
                    req, "block_pool_exhausted", queued=True,
                    free_blocks=self._alloc.n_free,
                )
                send_back.append(req)
                continue
            try:
                if self._prefix_cache is not None and req.prefix_key is not None:
                    self._prefix_cache.credit(shared)
                if shared:
                    DEFAULT_REGISTRY.counter("serve_prefix_hits").inc()
                    DEFAULT_REGISTRY.counter(
                        "serve_prefix_tokens_avoided"
                    ).inc(shared)
                    _req_mark(
                        req, "prefix_hit", anomalous=False,
                        shared_tokens=shared, prompt_tokens=len(ids),
                    )
                if self._prefix_cache is not None:
                    # insert IN the allocation loop: a later same-key request
                    # of this round shares in-round (cold groups dispatch
                    # before warm ones on the one stream, so the shared rows
                    # are written before any sharer reads them)
                    self._prefix_cache.insert(req.prefix_key, ids, table)
            except BaseException:
                # the table is in no slot yet: release (and bill) before
                # propagating
                table.release()
                _cost_add(req, "kv_block_seconds", table.billed_block_seconds)
                raise
            good.append((slot, req, ids, table, shared))
        if send_back:
            sent = {id(r) for r in send_back}
            with self._cv:
                for req in reversed(send_back):
                    req.t_queue = _now()
                    self._queue.appendleft(req)
                self._admitting_reqs = [
                    r for r in self._admitting_reqs if id(r) not in sent
                ]
                self._cv.notify_all()
        if not good:
            return None

        # register slot state BEFORE the dispatch: a failed dispatch's
        # _fail_active then releases these tables too
        for slot, req, ids, table, _shared in good:
            n_ids = len(ids)
            # a resumed victim's delivered tokens count toward its budget
            # (the retire check compares len(req.tokens) with it) and are
            # part of its KV, so _slot_prompt + len(req.tokens) stays the
            # lane's KV length
            resumed = min(len(req.tokens), n_ids)
            self._slot_req[slot] = req
            self._slot_budget[slot] = resumed + min(
                req.max_new - resumed, self.cache_len - n_ids - 1 - self.spec_k
            )
            self._slot_prompt[slot] = n_ids - resumed
            self._slot_table[slot] = table
            row = self._block_rows[slot]
            row[:] = self.n_blocks
            row[: len(table.blocks)] = table.blocks
            self._caps_np[slot] = table.capacity
        self._tables_dirty = True

        # pack into dispatch groups: each prompt's NOVEL portion starts on a
        # RAGGED_ALIGN boundary and a group never exceeds the largest
        # budget; warm lanes group apart from cold ones
        def _packed_len(entry) -> int:
            return round_up(len(entry[2]) - entry[4], RAGGED_ALIGN)

        groups: List[Tuple[bool, List[tuple]]] = []
        max_t = self._token_buckets[-1]
        for warm_flag in (False, True):
            cur: List[tuple] = []
            cur_tokens = 0
            for entry in good:
                if bool(entry[4]) != warm_flag:
                    continue
                n_aligned = _packed_len(entry)
                if cur and cur_tokens + n_aligned > max_t:
                    groups.append((warm_flag, cur))
                    cur, cur_tokens = [], 0
                cur.append(entry)
                cur_tokens += n_aligned
            if cur:
                groups.append((warm_flag, cur))

        S = self.n_slots
        drop_row = self.n_blocks * self.block_size
        window = self.cfg.sliding_window
        group_inputs = []
        # one analytic cost key per group (obs/observatory.py): live causal
        # pairs of each lane's novel rows (prefix included) and the K/V
        # rows attention reads
        cost_keys = []
        for warm_flag, group in groups:
            T = self._pick_token_bucket(sum(_packed_len(e) for e in group))
            cost_keys.append((
                "prefill", T, S,
                sum(causal_pairs(e[4], len(e[2]), window) for e in group),
                sum(len(e[2]) for e in group),
            ))
            ids_flat = np.full((T,), self.gen.pad_id, np.int64)
            seg = np.full((T,), -1, np.int64)
            pos = np.zeros((T,), np.int64)
            dest = np.full((T,), drop_row, np.int64)
            last_rows = np.zeros((S,), np.int64)
            slots_arr = np.full((S,), S, np.int64)  # spare drafting row
            tables_np = plens_np = None
            if warm_flag:
                tables_np = np.full((S, self.blocks_per_seq), self.n_blocks, np.int32)
                plens_np = np.zeros((S,), np.int64)
            off = 0
            for lane, (slot, _req, ids, table, shared) in enumerate(group):
                n = len(ids)
                # only the novel suffix, at ABSOLUTE positions
                p = np.arange(shared, n, dtype=np.int64)
                n_sfx = n - shared
                ids_flat[off: off + n_sfx] = ids[shared:]
                seg[off: off + n_sfx] = lane
                pos[off: off + n_sfx] = p
                blocks = np.asarray(table.blocks, np.int64)
                dest[off: off + n_sfx] = (
                    blocks[p // self.block_size] * self.block_size
                    + p % self.block_size
                )
                last_rows[lane] = off + n_sfx - 1
                slots_arr[lane] = slot
                if warm_flag:
                    tables_np[lane, : len(table.blocks)] = table.blocks
                    plens_np[lane] = shared
                off += round_up(n_sfx, RAGGED_ALIGN)
            group_inputs.append(
                (ids_flat, seg, pos, dest, last_rows, slots_arr, len(group),
                 tables_np, plens_np)
            )
            # group-major order: the slot scatters and the first-token fetch
        # line up with the concatenated outputs
        ordered = [e for _w, group in groups for e in group]
        slots_np = np.array([e[0] for e in ordered], np.int64)
        lens_np = np.array([len(e[2]) for e in ordered], np.int32)
        budget_ok = np.array(
            [self._slot_budget[e[0]] >= 2 for e in ordered], bool
        )

        deact = self._take_deact()
        seeds = [self._next_seed() for _ in group_inputs]
        t_prefill0 = _now()
        with span("serve_prefill", DEFAULT_REGISTRY):
            ticket = self.prefill_round(
                deact, group_inputs, slots_np, lens_np, budget_ok, seeds,
                cost_keys,
            )
            firsts = ticket.result().numpy()
        t_prefill1 = _now()
        for gi, (_warm, group) in enumerate(groups):
            for slot, req, ids, table, shared in group:
                _req_span(
                    req, "serve_prefill", t_prefill0, t_prefill1,
                    batch=len(good), dispatch=gi, slot=slot,
                    prompt_tokens=len(ids), blocks=len(table.blocks),
                    shared_tokens=shared,
                )
        self.stats["prefill_dispatches"] += len(groups)
        self.stats["admissions"] += len(ordered)
        self.stats["warm_admissions"] += sum(1 for e in ordered if e[4])
        meta = [
            (slot, req, len(ids), shared)
            for slot, req, ids, _t, shared in ordered
        ]
        return meta, firsts, ticket, cost_keys

    def prefill_round(self, deact, group_inputs, slots, lens, budget_ok,
                      seeds, cost_keys):
        """Issue one admission round (a command on a mesh; the arguments are
        the host's decisions) as the spine item ``serve_prefill_fetch``:
        the slots ``deact`` deactivated, one packed prefill per group of
        ``group_inputs`` (``(ids, seg, pos, dest, last_rows, slots, lanes,
        tables, prefix_lens)`` arrays, sampled with its seed of ``seeds``),
        the slot-state scatter on the device (alive = first != eos and
        ``budget_ok``, no fetch), then the first tokens' copy to the host.
        Returns the item's ticket once it has issued."""
        return mirrored(self, "prefill_round", self._prefill_round, deact,
                        group_inputs, slots, lens, budget_ok, seeds, cost_keys)

    def _prefill_round(self, deact, group_inputs, slots_np, lens_np, budget_ok,
                       seeds, cost_keys):
        dev = self.device

        def _prefill_on_lane():
            self._apply_deact(deact)
            parts = []
            for (ids_flat, seg, pos, dest, last_rows, slots_arr, n_lanes,
                 tables_np, plens_np), seed in zip(group_inputs, seeds):
                warm_kw = {}
                if tables_np is not None:
                    warm_kw = dict(
                        block_tables=_to_device(tables_np, dev),
                        prefix_lens=_to_device(plens_np, dev),
                    )
                toks = self._prefill_program(
                    _to_device(ids_flat, dev), _to_device(seg, dev),
                    _to_device(pos, dev), _to_device(dest, dev),
                    _to_device(last_rows, dev), _to_device(slots_arr, dev),
                    self._generator(seed), **warm_kw,
                )
                parts.append(toks[:n_lanes])
            first = torch.cat(parts)
            idx = _to_device(slots_np, dev)
            self._tok[idx] = first
            self._lengths[idx] = _to_device(lens_np, dev)
            self._active[idx] = (first != self.gen.eos_id) & _to_device(budget_ok, dev)
            return to_host(first)

        # the prefill rides the spine's prefill stream: decode items of
        # other replicas schedule ahead of it
        return self._on_lane(
            "serve_prefill_fetch", _prefill_on_lane, stream="prefill",
            cost_key=cost_keys,
        )

    def _finalize_admissions(self, admitted) -> None:
        """Per-request cost attribution and delivery (or retirement) of an
        admission round's first tokens.

        The round's measured device time splits across its requests in
        proportion to the NOVEL tokens each packed (warm lanes bill the
        warm field and record their avoided tokens), so the per-class sums
        equal the ``serve_prefill_fetch`` series (same measured value,
        partitioned)."""
        meta, firsts, ticket, cost_keys = admitted
        firsts = firsts[: len(meta)]
        sfx = [max(n_ids - shared, 1) for _s, _r, n_ids, shared in meta]
        total_sfx = float(sum(sfx)) or 1.0
        flops_total = 0.0
        for key in cost_keys:
            c = DEFAULT_OBSERVATORY.cost_of("serve_prefill_fetch", key)
            if c is not None:
                flops_total += c["flops"]
        dev_ms = ticket.device_s * 1e3
        qw_ms = ticket.queue_wait_s * 1e3
        for (slot, req, n_ids, shared), n_sfx in zip(meta, sfx):
            share = n_sfx / total_sfx
            field = (
                "prefill_device_ms_warm" if shared
                else "prefill_device_ms_cold"
            )
            _cost_add(req, field, dev_ms * share)
            _cost_add(req, "spine_queue_wait_ms", qw_ms * share)
            _cost_add(req, "prefill_tokens", n_ids)
            _cost_add(req, "prefill_tokens_avoided", shared)
            if flops_total:
                _cost_add(req, "flops_est", flops_total * share)
        for (slot, req, _n_ids, _shared), first in zip(meta, firsts):
            first = int(first)
            budget = self._slot_budget[slot]
            if first == self.gen.eos_id or budget <= 0:
                self._retire(slot)
            else:
                req.tokens.append(first)
                _cost_add(req, "decode_tokens", 1)
                _req_mark(req, "first_token", anomalous=False, slot=slot)
                with req.cv:  # the first streamed token
                    req.cv.notify_all()
                if len(req.tokens) >= budget:
                    self._retire(slot)

    def _take_deact(self) -> List[int]:
        """The host-retired slots whose device ``active`` lane is still set,
        handed to the next device phase (the worker's thread)."""
        deact, self._deact_pending = self._deact_pending, []
        return deact

    def _apply_deact(self, slots: List[int]) -> None:
        """Clear the device ``active`` lanes of ``slots`` (first inside
        every device work item)."""
        if slots:
            idx = torch.tensor(slots, dtype=torch.long, device=self.device)
            self._active[idx] = False

    def _release_slot_blocks(
        self, slot: int, req: Optional[_Request] = None
    ) -> None:
        """Return a slot's blocks to the pool (idempotent) and sentinel its
        table row so in-flight programs' further writes through it land on
        the drop row.  The release is where the occupant's KV
        block-seconds bill lands (after retirement too: the ledger
        late-adds), once: only the call that released credits."""
        if req is None:
            req = self._slot_req[slot]
        table = self._slot_table[slot]
        self._slot_table[slot] = None
        self._block_rows[slot, :] = self.n_blocks
        self._caps_np[slot] = 0
        self._tables_dirty = True
        if table is not None:
            was_released = table.released
            table.release()
            if not was_released and req is not None:
                _cost_add(req, "kv_block_seconds", table.billed_block_seconds)

    def _fail_active(self, err: BaseException) -> None:
        """Fail all in-flight requests, free their blocks, and rebuild clean
        device state.  A kernel or CUDA fault is re-raised instead: the
        context is poisoned, so the worker dies with it (``_worker_died``
        fails every request with the original error)."""
        if is_device_fault(err):
            raise err
        DEFAULT_REGISTRY.counter("serve_decode_failures").inc()
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            self._slot_req[slot] = None
            # bill KV block-seconds before _finish retires the record
            self._release_slot_blocks(slot, req=req)
            if req is not None:
                req.error = RuntimeError(f"decode failed: {err!r}")
                _req_mark(req, "decode_failed", slot=slot)
                _finish(req)
        # the reset replaces the pools: every cached prefix row is garbage
        if self._prefix_cache is not None:
            self._prefix_cache.clear()
        if self._stopped:
            return
        self._deact_pending = []
        self.reset_state()

    def reset_state(self) -> None:
        """Fresh pools and zeroed slot state (``serve_reset``; a command on a
        mesh)."""
        mirrored(self, "reset_state",
                 lambda: self._on_lane("serve_reset", self._init_device_state).result())

    def _retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        # blocks return IMMEDIATELY: the next queued request can take them
        # this same worker iteration; the KV bill lands before _finish
        self._release_slot_blocks(slot, req=req)
        if req is not None:
            _finish(req)
            if req.error is None:
                self.stats["completed"] += 1
                DEFAULT_REGISTRY.counter("serve_completed").inc()

    def _process_chunk(self, pending, snap: List[Optional[_Request]]) -> bool:
        """Fetch one decode chunk and deliver its packed results to the
        slots whose occupant is still the dispatch-time request.  Returns
        False when the chunk failed (state reset).

        The fetch (the item's result) reads the chunk's measured device
        time, which splits equally across the dispatch-time occupants
        ``snap`` (a lane that retired in flight still owns its share,
        late-added), so the per-class sums equal the
        ``serve_decode_chunk`` series: an unfetched chunk enters neither."""
        ticket, cost_key, t_issue0, t_issue1 = pending
        t_fetch0 = _now()
        try:
            # resilience_site: serve.decode_chunk — a delay is a slow-decode
            # replica, a raise a decode failure (typed, the batcher lives)
            faults.perturb("serve.decode_chunk")
            if self.spec_k:
                packed, steps = ticket.result()
            else:
                # the pipelined chunk: the worker waits on its device work
                # here, as the reference's fetch does
                with span("serve_decode_chunk", DEFAULT_REGISTRY):
                    packed, steps = ticket.result()
        except Exception as e:
            self._fail_active(e)
            return False
        t_fetch1 = _now()
        # the interval the worker waited on this chunk's device work
        t_chunk0, t_chunk1 = (
            (t_issue0, t_issue1) if self.spec_k else (t_fetch0, t_fetch1)
        )
        packed_h = packed.numpy()
        charged = [r for r in snap if r is not None]
        dev_ms = ticket.device_s * 1e3 / len(charged)
        qw_ms = ticket.queue_wait_s * 1e3 / len(charged)
        model = DEFAULT_OBSERVATORY.cost_of(
            "serve_decode_chunk", cost_key((packed, steps))
        )
        fl = model["flops"] / len(charged) if model else 0.0
        for req in charged:
            _cost_add(req, "decode_device_ms", dev_ms)
            _cost_add(req, "spine_queue_wait_ms", qw_ms)
            if fl:
                _cost_add(req, "flops_est", fl)
        # the first chunk landed: liveness monitoring may engage, and a
        # processed chunk is real progress (the pool skips canaries on it)
        self._cold = False
        self._last_progress = time_monotonic()
        if self.spec_k:
            width = self.chunk + 2 * self.spec_k
            out_h = packed_h[:, :width]
            counts_h = packed_h[:, width]
            active_h = packed_h[:, width + 1].astype(bool)
            valid_h = np.arange(width)[None, :] < counts_h[:, None]
            n_cols = width
        else:
            out_h = packed_h[:, : self.chunk]
            valid_h = packed_h[:, self.chunk: 2 * self.chunk].astype(bool)
            active_h = packed_h[:, -1].astype(bool)
            n_cols = self.chunk
        deactivate = []
        n_appended = 0
        for slot in range(self.n_slots):
            req = snap[slot]
            if req is None or self._slot_req[slot] is not req:
                continue
            before = len(req.tokens)
            for t in range(n_cols):
                if not valid_h[slot, t]:
                    continue
                if len(req.tokens) >= self._slot_budget[slot]:
                    break
                req.tokens.append(int(out_h[slot, t]))
                n_appended += 1
            # every chunk the request decoded through shows on its timeline
            _req_span(
                req, "serve_decode_chunk", t_chunk0, t_chunk1,
                slot=slot, tokens=len(req.tokens) - before,
            )
            _cost_add(req, "decode_tokens", len(req.tokens) - before)
            if len(req.tokens) > before:  # wake streamers per chunk
                with req.cv:
                    req.cv.notify_all()
            finished = (
                not active_h[slot]
                or len(req.tokens) >= self._slot_budget[slot]
            )
            expired = (
                not finished
                and req.deadline is not None
                and req.deadline.expired
            )
            if expired:
                req.error = DeadlineExceeded(
                    "serve_decode", -req.deadline.remaining()
                )
                DEFAULT_REGISTRY.counter("serve_deadline_shed").inc()
                _req_mark(req, "deadline_exceeded", stage="serve_decode")
                DEFAULT_COST_LEDGER.record_shed(
                    "deadline",
                    cls=req.cost.cls if req.cost is not None else None,
                    stage="serve_decode",
                )
            cancelled = not finished and not expired and req.cancelled
            if cancelled and not req.done.is_set():
                req.error = RequestCancelled("cancelled mid-decode")
                _req_mark(
                    req, "cancelled", anomalous=False, stage="serve_decode"
                )
            if finished or expired or cancelled:
                deactivate.append(slot)
                self._retire(slot)
        # tokens delivered per chunk: with speculation this exceeds chunk x
        # live slots when drafts accept
        DEFAULT_REGISTRY.histogram("serve_tokens_per_chunk").observe(
            float(n_appended)
        )
        if deactivate:
            self._deact_pending.extend(deactivate)
        return True

    def _blocks_for_admission(self, req: "_Request") -> int:
        """FRESH blocks admitting ``req`` would allocate (prompt after
        truncation plus the grow margin, one sequence at most), net of a
        cached prefix it would share."""
        usable = self.cache_len - 2 - self.spec_k
        # a preemption victim re-prefills its generated tokens too
        n_ids = max(1, min(len(req.prompt_ids) + len(req.tokens), usable))
        total = self._alloc.blocks_for(
            min(n_ids + self._grow_margin, self.seq_capacity)
        )
        if self._prefix_cache is not None and req.prefix_key is not None:
            try:
                ids = (
                    [int(t) for t in req.prompt_ids] + [int(t) for t in req.tokens]
                )[-usable:]
            except (TypeError, ValueError):
                return total  # bad request: _admit_round fails it alone
            shared = self._prefix_cache.peek(req.prefix_key, ids)
            total -= shared // self.block_size
        return max(total, 0)

    def _pop_free_slots(self, pairs: List[Tuple[int, "_Request"]]) -> None:
        """Fill every free slot from the queue into ``pairs`` (caller holds
        ``_cv``).  Requests whose deadline lapsed or that were cancelled
        while queued are finished here, never admitted.  A head the pool
        cannot hold STOPS the fill (FIFO is kept): it stays queued until
        retirements free blocks; cached idle prefixes are evicted for it
        first."""
        taken = {s for s, _ in pairs}
        drained = False
        # blocks already earmarked by earlier picks of this round
        planned = sum(self._blocks_for_admission(r) for _, r in pairs)
        blocked = False
        # preemption victims, requeued after the fill: the head the block
        # plan was computed against must stay the next pop
        preempted_back: List[_Request] = []
        for slot in range(self.n_slots):
            if blocked or self._slot_req[slot] is not None or slot in taken:
                continue
            filled = False
            while self._queue and not filled:
                head = self._queue[0]
                need = self._blocks_for_admission(head)
                head_live = (
                    head.deadline is None or not head.deadline.expired
                ) and not head.cancelled
                if (
                    head_live
                    and self._prefix_cache is not None
                    and not self._alloc.can_alloc(planned + need)
                ):
                    # re-estimate after eviction: it may have taken the
                    # head's own entry
                    if self._prefix_cache.evict_for(planned + need):
                        need = self._blocks_for_admission(head)
                if (
                    head_live
                    and self._qos is not None
                    and self._qos.preemption != "off"
                    and not self._alloc.can_alloc(planned + need)
                ):
                    # KV preemption after the prefix-cache valve, before the
                    # head is left block-starved (advisory only counts)
                    need = self._admission_preempt(
                        head, planned, need, preempted_back
                    )
                if head_live and not self._alloc.can_alloc(planned + need):
                    # one mark and count per starvation episode, not per poll
                    if self._block_wait_marked != id(head):
                        self._block_wait_marked = id(head)
                        _req_mark(
                            head, "block_pool_exhausted", queued=True,
                            anomalous=False, free_blocks=self._alloc.n_free,
                        )
                        DEFAULT_REGISTRY.counter("serve_block_pool_wait").inc()
                    blocked = True
                    break
                req = self._queue.popleft()
                if self._block_wait_marked == id(req):
                    self._block_wait_marked = None
                drained = True
                # queue wait is over either way (admitted or shed); the
                # cost is this queue entry's interval only (t_queue resets
                # on every requeue)
                _req_span(req, "serve_queue_wait", req.t_submit, _now())
                _cost_add(
                    req, "queue_wait_ms",
                    (_now() - (req.t_queue or req.t_submit)) * 1e3,
                )
                if req.cancelled:
                    if not req.done.is_set():
                        req.error = RequestCancelled("cancelled before admission")
                        _req_mark(
                            req, "cancelled", anomalous=False,
                            stage="serve_queue",
                        )
                        _finish(req)
                    continue
                if req.deadline is not None and req.deadline.expired:
                    req.error = DeadlineExceeded(
                        "serve_queue", -req.deadline.remaining()
                    )
                    DEFAULT_REGISTRY.counter("serve_deadline_shed").inc()
                    _req_mark(req, "deadline_exceeded", stage="serve_queue")
                    DEFAULT_COST_LEDGER.record_shed(
                        "deadline",
                        cls=req.cost.cls if req.cost is not None else None,
                        stage="serve_queue",
                    )
                    _finish(req)
                    continue
                pairs.append((slot, req))
                planned += need
                filled = True
            if not self._queue and not filled:
                break
        for victim in preempted_back:
            # back at their class head with their tokens kept; a local
            # requeue (the pool's hook takes locks that must not nest under
            # _cv; the mid-decode path offers victims to the pool first)
            victim.t_queue = _now()
            self._queue.appendleft(victim)
        self._admitting_reqs = [r for _, r in pairs]
        if drained:
            # wake bulk submitters blocked on queue capacity
            self._cv.notify_all()

    def _run(self) -> None:
        """Worker entry: the loop must never die silently."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self._lane.device)
            self._run_loop()
        except BaseException as e:
            self._worker_died(e)
        finally:
            # a kill() landing mid-iteration lets this loop register fresh
            # tables after the kill's sweep: close the accounting on exit
            with self._cv:
                stopped = self._stopped
            if stopped:
                for slot in range(self.n_slots):
                    self._release_slot_blocks(slot)
                if self._prefix_cache is not None:
                    self._prefix_cache.clear()

    def _worker_died(self, e: BaseException) -> None:
        """The loop crashed: queued (and admission-window) requests go to
        ``on_worker_death`` first; the rest, and every admitted request,
        fail typed with :class:`WorkerDied`.  Blocks and cache pins are
        released.  A kernel or CUDA fault is recorded as
        :attr:`device_fault` before the hook runs (the pool rescues nothing
        then), and every request fails with that original error."""
        fault = is_device_fault(e)
        if fault:
            self.device_fault = e
            log.error("batcher worker died of a device fault: %r", e)
        DEFAULT_REGISTRY.counter("serve_worker_deaths").inc()
        with self._cv:
            self._worker_dead = True
            self._death_cause = e
            queued = list(
                {
                    id(r): r
                    for r in self._admitting_reqs + list(self._queue)
                }.values()
            )
            self._admitting_reqs = []
            self._queue.clear()
            self._cv.notify_all()
        cb = self.on_worker_death
        if cb is not None:
            try:
                queued = list(cb(self, queued) or [])
            except Exception:
                pass  # the hook failed: every queued request fails below
        err = e if fault else WorkerDied(f"batcher worker died: {e!r}")
        for req in queued:
            if not req.done.is_set():
                req.error = err
                _req_mark(req, "worker_died", queued=True)
                _finish(req)
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            self._slot_req[slot] = None
            self._release_slot_blocks(slot, req=req)
            if req is not None and not req.done.is_set():
                req.error = err
                _req_mark(req, "worker_died", slot=slot)
                _finish(req)
        if self._prefix_cache is not None:
            self._prefix_cache.clear()

    def _grow_tables(self) -> None:
        """Grow-at-decode: top every live lane's table up to the margin
        before a chunk (the in-program capacity guard must never be what
        stops a live lane).  A lane the pool cannot grow, after the prefix
        cache gave back idle blocks, sheds typed."""
        shed_slots = []
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            table = self._slot_table[slot]
            if req is None or table is None:
                continue
            est = self._slot_prompt[slot] + len(req.tokens)
            target = min(est + self._grow_margin, self.seq_capacity)
            if table.capacity >= target:
                continue
            try:
                try:
                    table.ensure(target)
                except OutOfBlocks:
                    if self._prefix_cache is None:
                        raise
                    self._prefix_cache.evict_for(
                        self._alloc.blocks_for(target) - len(table.blocks)
                    )
                    table.ensure(target)
                row = self._block_rows[slot]
                row[: len(table.blocks)] = table.blocks
                self._caps_np[slot] = table.capacity
                self._tables_dirty = True
            except OutOfBlocks:
                if self._grow_preempt(slot, req, table, target):
                    # a lower-ranked lane gave up its blocks and requeued
                    # with its tokens kept; this lane decodes on
                    continue
                with self._cv:
                    n_queued = len(self._queue)
                DEFAULT_REGISTRY.counter("serve_block_shed").inc()
                req.error = BlockPoolExhausted(
                    "KV block pool exhausted mid-decode (lane at "
                    f"{est} tokens, pool {self.n_blocks}x{self.block_size})",
                    n_queued=n_queued, n_active=self.n_active,
                )
                _req_mark(req, "block_pool_exhausted", slot=slot)
                # forensics BEFORE the retire frees its blocks: the snapshot
                # shows the holdings that caused the shed
                DEFAULT_COST_LEDGER.record_shed(
                    "block_pool_exhausted",
                    cls=req.cost.cls if req.cost is not None else None,
                    stage="serve_decode_grow", lane_tokens=est,
                )
                self._retire(slot)
                shed_slots.append(slot)
        if shed_slots:
            self._deact_pending.extend(shed_slots)

    def _dispatch_decode(self, snap: List[Optional[_Request]]):
        """Issue one decode chunk for every live slot as a spine item
        (``serve_decode_chunk``): pending deactivations, the dirty table
        upload, the chunk, and the start of its packed results' copy to the
        host.  Returns ``(ticket, cost key, t0, t1)`` once the item has
        issued; :meth:`_process_chunk` fetches it.

        The cost key counts the steps the device ran and, per step, each
        occupied lane's live pairs and K/V rows at its length at dispatch
        (``snap``)."""
        q = self.spec_k or 1
        window = self.cfg.sliding_window
        lens = [
            self._slot_prompt[slot] + len(req.tokens)
            for slot, req in enumerate(snap) if req is not None
        ]
        pairs = sum(causal_pairs(n, n + q, window) for n in lens)
        kv_rows = sum(n + q for n in lens)
        deact = self._take_deact()
        tables = caps = None
        if self._tables_dirty:
            tables, caps = self._block_rows.copy(), self._caps_np.copy()
            self._tables_dirty = False
        seed = None if self.spec_k else self._next_seed()

        def issue():
            return self.decode_chunk(deact, tables, caps, seed, pairs, kv_rows)

        t0 = _now()
        if self.spec_k:
            # the speculative chunk fetches once per verify step inside its
            # item: the worker waits on the chunk's device work here
            with span("serve_decode_chunk", DEFAULT_REGISTRY):
                ticket = issue()
        else:
            ticket = issue()
        return ticket, self._decode_cost_key(pairs, kv_rows), t0, _now()

    def _decode_cost_key(self, pairs: int, kv_rows: int):
        """The decode chunk's cost key: the steps the device ran and, per
        step, the live pairs and K/V rows of the occupied lanes."""
        q = self.spec_k or 1

        def cost_key(result):
            steps = result[1]
            return ("decode", self.n_slots, q, steps, steps * pairs,
                    steps * kv_rows)

        return cost_key

    def decode_chunk(self, deact, tables, caps, seed, pairs, kv_rows):
        """Issue one decode chunk for every live slot (a command on a mesh;
        the arguments are the host's decisions) as the spine item
        ``serve_decode_chunk``: the slots ``deact`` deactivated, the block
        tables and capacities uploaded when given (None: unchanged since
        the last chunk), the plain chunk sampled with ``seed`` or the
        speculative one, and the start of its packed results' copy to the
        host.  ``pairs`` / ``kv_rows`` feed the item's cost key.  Returns
        the ticket once the item has issued."""
        return mirrored(self, "decode_chunk", self._decode_chunk, deact,
                        tables, caps, seed, pairs, kv_rows)

    def _decode_chunk(self, deact, tables, caps, seed, pairs, kv_rows):
        def _decode_on_lane():
            self._apply_deact(deact)
            if tables is not None:
                self._tables_dev = _to_device(tables, self.device)
                self._caps_dev = _to_device(caps, self.device)
            if self.spec_k:
                packed, steps = self._decode_spec_program(
                    self._tables_dev, self._caps_dev
                )
            else:
                packed = self._decode_program(
                    self._tables_dev, self._caps_dev, self._generator(seed)
                )
                steps = self.chunk
            return to_host(packed), steps

        return self._on_lane(
            "serve_decode_chunk", _decode_on_lane,
            cost_key=self._decode_cost_key(pairs, kv_rows),
        )

    def _run_loop(self) -> None:
        # the one issued-but-unfetched decode chunk: (its ticket, cost key
        # and issue times, the dispatch-time slot->request snapshot)
        pending: Optional[Tuple[Any, List[Optional[_Request]]]] = None
        while True:
            self._beat = time_monotonic()
            # resilience_site: serve.worker_loop — a raise is a worker CRASH
            # (queued requests fail over through the pool, admitted ones
            # fail typed); a pure delay is a WEDGE (the heartbeat goes stale)
            faults.perturb("serve.worker_loop")
            pairs: List[Tuple[int, _Request]] = []
            with self._cv:
                while (
                    not self._stopped
                    and not self._queue
                    and not any(self._slot_req)
                ):
                    self._beat = time_monotonic()
                    self._cv.wait(0.5)
                if self._stopped:
                    return
                self._pop_free_slots(pairs)
                if not pairs and self._queue and not any(self._slot_req):
                    # block-starved head with every slot idle: bounded wait
                    # instead of a hot spin (retirements notify)
                    self._beat = time_monotonic()
                    self._cv.wait(0.05)
                    self._pop_free_slots(pairs)
            if pairs and pending is not None:
                # process the previous chunk before admitting: it may retire
                # slots this round can refill
                drained_ok = self._process_chunk(*pending)
                pending = None
                if drained_ok:
                    with self._cv:
                        self._pop_free_slots(pairs)
            # disaggregated order: the chunk for ALREADY-LIVE lanes runs
            # before this round's admission prefill
            self._grow_tables()
            packed = snap = None
            if any(self._slot_req):
                # snapshot at DISPATCH time: lanes admitted below were free
                snap = list(self._slot_req)
                try:
                    packed = self._dispatch_decode(snap)
                except Exception as e:
                    self._fail_active(e)
                    pending = None
                    continue
            admitted = None
            if pairs:
                try:
                    admitted = self._admit_round(pairs)
                except Exception as e:
                    if is_device_fault(e):
                        raise  # the worker dies with it (_worker_died)
                    # the round's prefill died: fail its requests (those sent
                    # back to the queue stay queued) and reset; the chunk
                    # run above shares the poisoned state — drop it
                    with self._cv:
                        requeued = {id(r) for r in self._queue}
                    for _slot, req in pairs:
                        if id(req) in requeued:
                            continue
                        if not req.done.is_set():
                            req.error = RuntimeError(f"prefill failed: {e!r}")
                            _finish(req)
                    self._fail_active(e)
                    pending = None
                    continue
                finally:
                    with self._cv:
                        self._admitting_reqs = []
                        self._cv.notify_all()
            if admitted is not None:
                self._finalize_admissions(admitted)
            ok = True
            if pending is not None:
                ok = self._process_chunk(*pending)
            if ok and packed is None and any(self._slot_req):
                # admission-only iteration: give the fresh lanes their first
                # chunk now instead of one loop later
                snap = list(self._slot_req)
                try:
                    packed = self._dispatch_decode(snap)
                except Exception as e:
                    self._fail_active(e)
                    pending = None
                    continue
            pending = (packed, snap) if ok and packed is not None else None
