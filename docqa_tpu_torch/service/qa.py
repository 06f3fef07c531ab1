"""QA / RAG service core: retrieval -> prompt -> generation, with the
reference's failure policy.  Counterpart of ``docqa_tpu/service/qa.py``
(``PendingAnswer``, ``QAService``: ``ask_submit`` / ``ask``, the answer
router, the fake LLM, patient snippets, the fused RAG lane).

With a ``FusedRAG`` wired in (``engines/rag_fused.py``), ``ask`` at the
service's own ``k`` runs the single-sync chain whenever the batcher (or
pool) is idle or absent; under load, or with another ``k``, it takes the
classic path below.  An empty store falls through to the classic path; any
other failure of the fused chain disables it loudly and serves the classic
path, as the reference does, except a device fault, which propagates.

Retrieval is the fused retriever (encoder forward and store search in one
device item) for an ``EncoderEngine``; the fake encoder (``HashEncoder``)
keeps the reference's two steps, host embeddings then ``store.search``.

With an answer router (``engines/router.py``), a lookup question asks the
retriever for the ``hybrid`` mode (honoured where the retriever declares
``supports_modes``: the tiered index and its fused retriever) and, when
the evidence gate passes, is answered with
the retrieved chunks verbatim: no prompt, no batcher, no decode.  The
answer then carries ``route: "extractive"``.

With a batcher wired in — an ``EnginePool`` in the reference's default
``/ask``, or a bare ``ContinuousBatcher`` — ``ask`` submits the prompt to
it, keyed for the prefix cache and the pool's session affinity by
:func:`prefix_key_for`; without one, generation is the solo
``GenerateEngine``.

Failure policy: retrieval failures propagate (no context, nothing to
degrade to).  Once retrieval produced chunks, a decoder problem — the
``decoder`` breaker open, too little deadline budget left for a decode
round, a failed submission, a replica lost with the request admitted, a
timed-out or failed decode — serves the degraded extractive answer
(``{"answer", "sources", "degraded": true, "degrade_reason"}``) instead of
an error.  ``QueueFull`` still propagates: an overloaded but healthy
decoder is admission control, not an outage.

One exception the reference does not have: a kernel that fails to build
or launch, or a CUDA error on the card (``ops/_kernels.is_device_fault``),
reaches the caller unchanged.  It is never turned into a degraded answer
and never recorded as a breaker failure, so a broken kernel cannot hide
behind a plausible answer.

Observability, as in the reference: ``ask_submit`` stamps a cost record of
the request's class on the active trace (``obs.cost_open``) before
retrieval, so the retrieve item's device time and the batcher's prefill and
decode shares land on one record; a degraded answer flags the trace
``degraded`` with a reason event; a queue-full shed retires the record
typed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from docqa_tpu_torch import obs
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.rag_fused import EmptyStoreError
from docqa_tpu_torch.engines.retrieve import FusedRetriever, FusedTieredRetriever
from docqa_tpu_torch.engines.router import ROUTE_EXTRACTIVE, extractive_answer
from docqa_tpu_torch.engines.serve import (
    DEFAULT_RESULT_TIMEOUT,
    DeferredByPolicy,
    QueueFull,
    WorkerDied,
)
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.resilience import faults
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.qa")

# Copied verbatim from docqa_tpu/service/qa.py.
QA_TEMPLATE = (
    "Tu es un expert en médecine traditionnelle chinoise et en analyse de "
    "dossiers cliniques. Appuie-toi uniquement sur le contexte ci-dessous. "
    "Quand plusieurs éléments portent un score, privilégie les scores les "
    "plus élevés et mentionne-les. Si le contexte ne permet pas de répondre, "
    "dis-le explicitement.\n\n"
    "Contexte:\n{context}\n\nQuestion: {question}\n\nRéponse:"
)

# template half of the prefix-cache key: a template edit invalidates every
# cached prefix by key
_TEMPLATE_HASH = hashlib.sha1(QA_TEMPLATE.encode("utf-8")).hexdigest()[:12]


def prefix_key_for(chunks: List[str]) -> str:
    """The (template hash, retrieved-chunk-set hash) prefix-cache key:
    consecutive questions against the same retrieved chunks share the whole
    template + context prompt prefix.  Order-sensitive, as the prompt is.
    Same value as the reference's ``prefix_key_for``."""
    h = hashlib.sha1()
    for c in chunks:
        h.update(c.encode("utf-8", "surrogatepass"))
        h.update(b"\x1f")
    return f"{_TEMPLATE_HASH}:{h.hexdigest()[:16]}"


@dataclass
class PendingAnswer:
    """An ``/ask`` answer in flight: retrieval is done, generation may
    still be decoding in the batcher; :meth:`resolve` waits for it.

    When generation fails or times out, :meth:`resolve` serves the
    extractive answer over ``chunks``, marked ``degraded`` with its reason,
    and counts ``qa_degraded``; a submit-time degrade arrives with
    ``answer`` already set.  ``breaker`` is the decoder breaker the outcome
    is recorded on."""

    sources: List[str]
    answer: Optional[str] = None  # already final (solo path or degraded)
    handle: Optional[Any] = None  # the batcher's or the pool's handle
    tokenizer: Optional[Any] = None
    chunks: List[str] = field(default_factory=list)  # retrieved texts
    degraded: bool = False
    degrade_reason: Optional[str] = None
    breaker: Optional[Any] = None  # decoder CircuitBreaker (outcome sink)
    degraded_max_chars: int = 600
    route: Optional[str] = None  # "extractive": no decode was dispatched

    def _result(self, answer: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {"answer": answer, "sources": self.sources}
        if self.degraded:
            # present ONLY on degraded responses: the normal contract stays
            # exactly {"answer", "sources"}
            out["degraded"] = True
            out["degrade_reason"] = self.degrade_reason
        if self.route is not None:
            out["route"] = self.route  # opt-in, as the degraded keys are
        return out

    def _degrade(self, reason: str) -> Dict[str, Any]:
        self.degraded = True
        self.degrade_reason = reason
        DEFAULT_REGISTRY.counter("qa_degraded").inc()
        # the flight recorder always keeps degraded requests, and the event
        # says why
        obs.flag("degraded")
        obs.event("degraded", reason=reason)
        return self._result(extractive_answer(self.chunks, self.degraded_max_chars))

    def _release(self) -> None:
        if self.breaker is not None:
            self.breaker.release_probe()

    def _record(self, ok: bool) -> None:
        if self.breaker is not None:
            if ok:
                self.breaker.record_success()
            else:
                self.breaker.record_failure()

    def resolve(
        self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT
    ) -> Dict[str, Any]:
        """The reference's response contract ``{"answer", "sources"}``, or
        the degraded answer with ``degraded`` / ``degrade_reason``."""
        if self.answer is not None:
            return self._result(self.answer)
        try:
            answer = self.handle.text(self.tokenizer, timeout)
        except DeadlineExceeded:
            # shed by the batcher or the pool: not a decoder fault
            self._release()
            return self._degrade("deadline")
        except TimeoutError:  # ResultTimeout: slow, possibly hung decode
            self._record(False)
            return self._degrade("decode_timeout")
        except WorkerDied as e:
            # a replica died or wedged with this request admitted
            self._record(False)
            log.warning("decode replica died; serving degraded answer: %r", e)
            return self._degrade("replica_died")
        except Exception as e:
            if is_device_fault(e):
                self._release()
                raise
            self._record(False)
            log.warning("generation failed; serving degraded answer: %r", e)
            return self._degrade("decoder_error")
        self._record(True)
        return self._result(answer)

    def iter_text(self, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT):
        """Yield the answer text as decode chunks land: deltas of the
        cumulative detokenization, so their concatenation equals
        :meth:`resolve`'s answer.  A final or degraded answer yields once."""
        if self.answer is not None:
            yield self.answer
            return
        ids: list = []
        emitted = 0
        try:
            for tok in self.handle.iter_tokens(timeout):
                ids.append(tok)
                decoded = self.tokenizer.decode_ids(ids)
                if len(decoded) > emitted:
                    yield decoded[emitted:]
                    emitted = len(decoded)
        except (DeadlineExceeded, GeneratorExit):
            # a budget shed or a client gone: no decoder outcome
            self._release()
            raise
        except Exception as e:
            if is_device_fault(e):
                self._release()
            else:
                self._record(False)
            raise
        self._record(True)


class QAService:
    def __init__(
        self,
        encoder,  # EncoderEngine, or the fake encoder (HashEncoder)
        store,  # VectorStore, or a TieredIndex over one
        generator: GenerateEngine,
        k: int = 3,
        device="cuda",
        batcher=None,  # EnginePool or ContinuousBatcher
        breakers=None,  # resilience.BreakerBoard: "decoder" gates generation
        resilience=None,  # config.ResilienceConfig: degrade thresholds
        use_fake_llm: bool = False,
        retriever=None,  # FusedRetriever or FusedTieredRetriever
        router=None,  # engines.router.AnswerRouter
        fused_rag=None,  # engines.rag_fused.FusedRAG: the single-sync ask
    ) -> None:
        self.device = resolve_device(device)
        for name, part in (("generator", generator), ("batcher", batcher)):
            if part is not None and part.device != self.device:
                raise ValueError(
                    f"{name} on {part.device}; the service runs on "
                    f"{self.device}"
                )
        if retriever is None and isinstance(encoder, EncoderEngine):
            if isinstance(store, VectorStore):
                retriever = FusedRetriever(encoder, store, device=self.device)
            else:  # a TieredIndex
                retriever = FusedTieredRetriever(encoder, store, device=self.device)
        self.retriever = retriever
        self.encoder = encoder
        self.store = store
        self.use_fake_llm = use_fake_llm
        self.router = router
        self.generator = generator
        self.batcher = batcher
        self.fused_rag = fused_rag
        self.k = k
        self.decoder_breaker = (
            breakers.get("decoder") if breakers is not None else None
        )
        self.min_generate_budget_s = (
            resilience.min_generate_budget_s if resilience is not None else 0.5
        )
        self.degraded_max_chars = (
            resilience.degraded_max_chars if resilience is not None else 600
        )

    def _retrieve(self, text: str, k: int, filters=None, deadline=None,
                  mode: Optional[str] = None):
        """The fused retriever when one is wired, else host embeddings and
        ``store.search``; ``mode`` reaches only a retriever or store that
        declares ``supports_modes`` (everything else serves dense)."""
        if self.retriever is not None:
            kw = {}
            if mode is not None and getattr(self.retriever, "supports_modes", False):
                kw["mode"] = mode
            return self.retriever.search_texts(
                [text], k=k, filters=filters, deadline=deadline, **kw
            )[0]
        if deadline is not None:
            deadline.check("retrieve")
        emb = self.encoder.encode_texts([text])
        if mode is not None and getattr(self.store, "supports_modes", False):
            return self.store.search(
                emb, k=k, filters=filters, mode=mode, query_texts=[text]
            )[0]
        return self.store.search(emb, k=k, filters=filters)[0]

    def _degraded_pending(
        self, sources: List[str], chunks: List[str], reason: str
    ) -> PendingAnswer:
        DEFAULT_REGISTRY.counter("qa_degraded").inc()
        obs.flag("degraded")
        obs.event("degraded", reason=reason)
        return PendingAnswer(
            sources=sources,
            answer=extractive_answer(chunks, self.degraded_max_chars),
            chunks=chunks,
            degraded=True,
            degrade_reason=reason,
        )

    def ask_submit(
        self,
        question: str,
        k: Optional[int] = None,
        deadline: Optional[Deadline] = None,
        req_class: str = "interactive",
    ) -> PendingAnswer:
        """Retrieval, prompt assembly and generation SUBMISSION: with a
        batcher this returns once the prompt is queued.  The failure policy
        is the module docstring's."""
        if deadline is not None:
            deadline.check("qa_admission")
        # the request's cost record, on its trace BEFORE retrieval (the
        # endpoint usually stamped one already; cost_open reuses it)
        cost = obs.cost_open(obs.current(), req_class)
        # the router's text stage picks the retrieve mode, so it runs first
        decision = None
        if self.router is not None and self.router.enabled:
            decision = self.router.decide(question)
            obs.event(
                "route_decision",
                route=decision.route,
                confidence=round(decision.confidence, 3),
                reason=decision.reason,
            )
        mode = (
            "hybrid"
            if decision is not None and decision.route == ROUTE_EXTRACTIVE
            else None
        )
        with span("qa_retrieve", DEFAULT_REGISTRY):
            hits = self._retrieve(
                question, k=k or self.k, deadline=deadline, mode=mode
            )
        chunks = [
            h.metadata.get("text_content", h.metadata.get("source", ""))
            for h in hits
        ]
        context = "\n\n".join(chunks)
        prompt = QA_TEMPLATE.format(context=context, question=question)
        sources = [h.metadata.get("source", "") for h in hits]
        if decision is not None:
            # the evidence gate: a routed answer must be in the context; a
            # demotion is the generative path with a reason, not a failure
            decision, ev = self.router.evidence_gate(decision, question, chunks)
            if decision.route == ROUTE_EXTRACTIVE:
                DEFAULT_REGISTRY.counter("qa_routed_extractive").inc()
                obs.event(
                    "routed_extractive", reason=decision.reason,
                    evidence=round(ev, 3),
                )
                if cost is not None:
                    cost.add("routed_extractive", 1.0)
                return PendingAnswer(
                    sources=sources,
                    answer=extractive_answer(chunks, self.degraded_max_chars),
                    chunks=chunks,
                    route=ROUTE_EXTRACTIVE,
                )
            DEFAULT_REGISTRY.counter("qa_routed_generative").inc()
        if self.use_fake_llm:
            answer = context[:500] if context else "Aucun contexte trouvé."
            return PendingAnswer(sources=sources, answer=answer)
        if deadline is not None and deadline.remaining() < self.min_generate_budget_s:
            # checked before the breaker: a budget shed never takes a
            # half-open probe slot
            return self._degraded_pending(sources, chunks, "insufficient_budget")
        breaker = self.decoder_breaker
        if breaker is not None and not breaker.allow():
            return self._degraded_pending(sources, chunks, "decoder_breaker_open")
        try:
            faults.perturb("decoder")  # resilience_site: decoder
            if self.batcher is not None:
                kw: Dict[str, Any] = {"req_class": req_class}
                if deadline is not None:
                    kw["deadline"] = deadline
                if self.batcher.prefix_cache_enabled:
                    kw["prefix_key"] = prefix_key_for(chunks)
                    if cost is not None:
                        # the ledger's top-spender table groups a patient
                        # session's questions
                        cost.set_session(kw["prefix_key"])
                return PendingAnswer(
                    sources=sources,
                    handle=self.batcher.submit_text(prompt, **kw),
                    tokenizer=self.batcher.engine.tokenizer,
                    chunks=chunks,
                    breaker=breaker,
                    degraded_max_chars=self.degraded_max_chars,
                )
            answer = self.generator.generate_texts([prompt])[0]
            if breaker is not None:
                breaker.record_success()
            return PendingAnswer(sources=sources, answer=answer, chunks=chunks)
        except QueueFull as e:
            # overload is not an outage: the shed never reached the decoder.
            # The record retires typed (idempotent: the batcher or pool
            # usually retired it already)
            if breaker is not None:
                breaker.release_probe()
            obs.DEFAULT_COST_LEDGER.retire(
                cost,
                "shed_deferred" if isinstance(e, DeferredByPolicy)
                else "shed_queue",
            )
            raise
        except DeadlineExceeded:
            if breaker is not None:
                breaker.release_probe()
            return self._degraded_pending(sources, chunks, "deadline")
        except Exception as e:
            if is_device_fault(e):
                if breaker is not None:
                    breaker.release_probe()
                raise
            if breaker is not None:
                breaker.record_failure()
            log.warning("generation submission failed; serving degraded answer: %r", e)
            return self._degraded_pending(sources, chunks, "decoder_error")

    def ask(
        self,
        question: str,
        k: Optional[int] = None,
        deadline: Optional[Deadline] = None,
    ) -> Dict[str, Any]:
        """The reference's response contract ``{"answer", "sources"}``
        (plus ``degraded`` / ``degrade_reason`` on a degraded answer).  The
        fused chain serves it when wired, at the default ``k``, with the
        batcher idle (module docstring)."""
        if deadline is not None:
            deadline.check("qa_admission")
        if (
            self.fused_rag is not None
            and (k is None or k == self.k)
            and (
                self.batcher is None
                or (self.batcher.n_active == 0 and self.batcher.n_queued == 0)
            )
        ):
            try:
                with span("qa_e2e", DEFAULT_REGISTRY):
                    return self.fused_rag.ask(question)
            except EmptyStoreError:
                pass  # the classic path answers the empty index uniformly
            except Exception as e:
                if is_device_fault(e):
                    raise
                # a broken fused chain must not tax every request with a
                # failed attempt, nor fail silently
                log.exception("fused ask failed; disabling the fused path")
                self.fused_rag = None
        with span("qa_e2e", DEFAULT_REGISTRY):
            return self.ask_submit(question, k, deadline=deadline).resolve()

    def patient_snippets(
        self,
        patient_id: str,
        from_date: Optional[str] = None,
        to_date: Optional[str] = None,
        focus: Optional[str] = None,
        limit: int = 20,
    ) -> List[Dict[str, str]]:
        """``[{doc_id, text}]`` of one patient's chunks: ranked by
        similarity to ``focus`` when given, else in row order.  Both paths
        filter through the store's columnar mask; a malformed date bound
        raises ``ValueError``."""
        filters = {
            "patient_id": patient_id,
            "date_from": from_date,
            "date_to": to_date,
        }
        if focus:
            rows = [h.metadata for h in self._retrieve(focus, k=limit, filters=filters)]
        else:
            rows = self.store.metadata_select(limit=limit, **filters)
        return [
            {"doc_id": md["doc_id"], "text": md.get("text_content", "")}
            for md in rows
        ]
