"""QA / RAG service core: retrieval -> prompt -> generation, with the
reference's failure policy.  Counterpart of ``docqa_tpu/service/qa.py``'s
``PendingAnswer`` and ``QAService`` (``ask_submit`` / ``ask``) without the
answer router, the fused RAG lane or the fake LLM.

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
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.retrieve import FusedRetriever
from docqa_tpu_torch.engines.router import (  # noqa: F401 (re-exported)
    ROUTE_EXTRACTIVE,
    extractive_answer,
)
from docqa_tpu_torch.engines.serve import (
    DEFAULT_RESULT_TIMEOUT,
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

    def _result(self, answer: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {"answer": answer, "sources": self.sources}
        if self.degraded:
            # present ONLY on degraded responses: the normal contract stays
            # exactly {"answer", "sources"}
            out["degraded"] = True
            out["degrade_reason"] = self.degrade_reason
        return out

    def _degrade(self, reason: str) -> Dict[str, Any]:
        self.degraded = True
        self.degrade_reason = reason
        DEFAULT_REGISTRY.counter("qa_degraded").inc()
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
        encoder: EncoderEngine,
        store: VectorStore,
        generator: GenerateEngine,
        k: int = 3,
        device="cuda",
        batcher=None,  # EnginePool or ContinuousBatcher
        breakers=None,  # resilience.BreakerBoard: "decoder" gates generation
        resilience=None,  # config.ResilienceConfig: degrade thresholds
    ) -> None:
        self.device = resolve_device(device)
        for name, part in (("generator", generator), ("batcher", batcher)):
            if part is not None and part.device != self.device:
                raise ValueError(
                    f"{name} on {part.device}; the service runs on "
                    f"{self.device}"
                )
        self.retriever = FusedRetriever(encoder, store, device=self.device)
        self.generator = generator
        self.batcher = batcher
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

    def _degraded_pending(
        self, sources: List[str], chunks: List[str], reason: str
    ) -> PendingAnswer:
        DEFAULT_REGISTRY.counter("qa_degraded").inc()
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
        with span("qa_retrieve", DEFAULT_REGISTRY):
            if deadline is not None:
                deadline.check("retrieve")
            hits = self.retriever.search_texts([question], k=k or self.k)[0]
        chunks = [
            h.metadata.get("text_content", h.metadata.get("source", ""))
            for h in hits
        ]
        context = "\n\n".join(chunks)
        prompt = QA_TEMPLATE.format(context=context, question=question)
        sources = [h.metadata.get("source", "") for h in hits]
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
        except QueueFull:
            # overload is not an outage: the shed never reached the decoder
            if breaker is not None:
                breaker.release_probe()
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
        (plus ``degraded`` / ``degrade_reason`` on a degraded answer)."""
        if deadline is not None:
            deadline.check("qa_admission")
        with span("qa_e2e", DEFAULT_REGISTRY):
            return self.ask_submit(question, k, deadline=deadline).resolve()
