"""The async document pipeline: ingest → de-identify → chunk+embed+index.
Counterpart of ``docqa_tpu/service/pipeline.py``'s ``DocumentPipeline``.

* ingest: registry row PENDING → extract → publish to the raw queue →
  PROCESSED / ERROR_EXTRACTION / ERROR_QUEUE;
* deid worker: batch-consumes the raw queue, runs the pattern recognizers
  and the NER tagger over the batch, publishes ``{doc_id,
  original_text_masked, metadata, processed_at}`` to the clean queue;
* index worker: batch-consumes, chunks, encodes ALL chunks of the batch in
  one device call and appends them to the store, immediately searchable.

Completion is observable: the registry reaches INDEXED with a chunk count,
and :meth:`DocumentPipeline.wait_indexed` blocks on it.

Each worker runs its device work on a ``spine.Lane`` of its own (one CUDA
stream, inference mode), so a tagger or encoder batch never queues on the
stream of another thread's work; the encoder's and the store's spine items
run on that stream.

Every document leaves one timeline (``docqa_tpu_torch/obs``): the trace
opens at ingest (or continues the caller's), its headers ride the broker
messages, each worker re-links it (``obs.from_headers``) and records its
batch interval as a ``deid_batch`` / ``index_batch`` span, and the first
terminal status finishes it, a dead letter included (flagged).

With a ``prompt_tokenizer`` (the generator's) and a store whose token
sidecar is on, the index worker writes each chunk's generator tokens into
the sidecar at index time (the fused RAG path's prompt source).  The
``on_indexed(n_docs)`` hook (the runtime's periodic snapshot) runs after
each batch's rows are added and before their INDEXED status is written, so
with ``data.snapshot_every = 1`` an INDEXED row implies durable vectors.
A replayed message whose document the store already holds (the set is
seeded from the store, a restored one included) adds no chunk.

One departure from the reference: a kernel or CUDA fault
(``ops/_kernels.is_device_fault``) in either worker is never retried,
dead-lettered or written as ``ERROR_DEID`` / ``ERROR_INDEXING``: the worker
stops, the pipeline keeps the error, and :meth:`wait_indexed` and
:meth:`stop` raise it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from docqa_tpu_torch import obs
from docqa_tpu_torch.config import Config
from docqa_tpu_torch.engines.spine import Lane
from docqa_tpu_torch.index.store import sidecar_rows
from docqa_tpu_torch.ops._kernels import is_device_fault
from docqa_tpu_torch.resilience import faults
from docqa_tpu_torch.resilience.policy import RetryPolicy
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger, span
from docqa_tpu_torch.service import registry as reg
from docqa_tpu_torch.service.broker import Consumer, MemoryBroker
from docqa_tpu_torch.service.extract import extract_text_ex
from docqa_tpu_torch.service.registry import DocumentRegistry
from docqa_tpu_torch.text.chunker import chunk_text

log = get_logger("docqa.pipeline")


class DocumentPipeline:
    """Owns the two queue consumers and the ingest entrypoint."""

    def __init__(
        self,
        cfg: Config,
        broker: MemoryBroker,
        registry: DocumentRegistry,
        deid_engine,  # DeidEngine
        encoder_engine,  # EncoderEngine
        store,  # VectorStore
        http_extractor=None,
        on_indexed=None,  # callable(n_docs) after each indexed batch
        breakers=None,  # resilience.BreakerBoard: broker/deid/index circuits
        prompt_tokenizer=None,  # the generator's: the store's token sidecar
    ) -> None:
        self.cfg = cfg
        self.broker = broker
        self.registry = registry
        self.deid = deid_engine
        self.encoder = encoder_engine
        self.store = store
        self.http_extractor = http_extractor
        self.on_indexed = on_indexed
        self.prompt_tokenizer = prompt_tokenizer
        self.breakers = breakers
        # one stream per worker for its device work
        self._deid_lane = Lane(deid_engine.device)
        self._index_lane = Lane(encoder_engine.device)
        res = cfg.resilience
        # in-place publish retries: a transient broker hiccup must not turn
        # into ERROR_QUEUE (ingest) or a redelivery burn (deid)
        self._retry = RetryPolicy(
            max_attempts=res.retry_attempts,
            base_delay_s=res.retry_base_delay_s,
            max_delay_s=res.retry_max_delay_s,
        )
        # extraction: only IO-class failures retry — a corrupt upload fails
        # identically every attempt
        self._io_retry = dataclasses.replace(
            self._retry, retry_on=(OSError, faults.InjectedFault)
        )
        # consumer handlers: transient classes only (IO, broker
        # RuntimeErrors, InjectedFault included), so a poison message's
        # deterministic KeyError/TypeError goes straight to the nack path.
        # A device fault is a RuntimeError too; the policy never retries it.
        self._consumer_retry = dataclasses.replace(
            self._retry, retry_on=(OSError, RuntimeError)
        )
        self._broker_breaker = (
            breakers.get("broker") if breakers is not None else None
        )
        # signaled on every terminal status write (INDEXED / ERROR_*) and on
        # a device fault, so wait_indexed() blocks on a Condition
        self._done_cv = threading.Condition()
        self._fault: Optional[BaseException] = None
        self._started = False
        self._stopped = False
        # Replay idempotence: a redelivered, already-indexed message must
        # not duplicate its chunks.  doc_ids are per-upload uuids, so a
        # same-id body always IS the same document.
        self._indexed_doc_ids = {
            md.get("doc_id") for md in store.metadata_rows()
        }
        # docs deleted while still in flight: the index worker drops their
        # messages and never marks them INDEXED.  The lock closes the
        # batch-start-to-store.add window (see suppress_doc).
        self._suppressed_doc_ids: set = set()
        self._suppress_lock = threading.Lock()

        def _dead(body, headers, status):
            self.registry.set_status_unless_deleted(body["doc_id"], status)
            # the timeline ends here, flagged: the recorder always keeps it
            obs.finish_id(
                (headers or {}).get(obs.TRACE_HEADER), flag="dead_lettered"
            )
            self._notify_done()

        # per-stage breakers: while a stage's circuit is open its consumer
        # pauses pulling (messages keep their redelivery budget); the retry
        # policy absorbs transient failures before any nack.  pass_headers
        # threads each message's trace headers through both hops.
        self._consumers = [
            Consumer(
                broker,
                cfg.broker.raw_queue,
                self._deid_handler,
                batch=cfg.broker.prefetch,
                name="deid-worker",
                on_dead=lambda body, headers: _dead(
                    body, headers, reg.ERROR_DEID
                ),
                retry=self._consumer_retry,
                breaker=breakers.get("deid") if breakers else None,
                pass_headers=True,
                on_fault=self._on_fault,
            ),
            Consumer(
                broker,
                cfg.broker.clean_queue,
                self._index_handler,
                batch=cfg.broker.prefetch,
                name="index-worker",
                on_dead=lambda body, headers: _dead(
                    body, headers, reg.ERROR_INDEXING
                ),
                retry=self._consumer_retry,
                breaker=breakers.get("index") if breakers else None,
                pass_headers=True,
                on_fault=self._on_fault,
            ),
        ]

    def suppress_doc(self, doc_id: str) -> None:
        """Never index this document, even if its pipeline message is still
        queued or replays later.  Blocks while an index-worker batch is
        inside its store-add critical section: on return, the doc's chunks
        are either dropped or already in the store."""
        with self._suppress_lock:
            self._suppressed_doc_ids.add(doc_id)

    # ---- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._started = True
        self._stopped = False
        for c in self._consumers:
            c.start()

    def stop(self) -> None:
        """Stop both workers (idempotent), then raise the device fault that
        stopped a worker, if one did."""
        if not self._stopped:
            self._stopped = True
            for c in self._consumers:
                c.stop()
            self._notify_done()  # release any wait_indexed() blocked at stop
        if self._fault is not None:
            raise self._fault

    @property
    def fault(self) -> Optional[BaseException]:
        """The device fault that stopped a worker, or None."""
        return self._fault

    def _on_fault(self, exc: BaseException) -> None:
        with self._done_cv:
            if self._fault is None:
                self._fault = exc
            self._done_cv.notify_all()

    def _notify_done(self) -> None:
        with self._done_cv:
            self._done_cv.notify_all()

    # ---- ingest (sync stage) -------------------------------------------------

    def ingest_document(
        self,
        filename: str,
        data: bytes,
        doc_type: Optional[str] = None,
        patient_id: Optional[str] = None,
        doc_date: Optional[str] = None,
    ):
        """Create the metadata row first, then extract, then queue; every
        failure mode gets a distinct terminal status.  Returns the row.

        The document's trace starts here (or continues the caller's) and
        spans extract -> deid -> index: it finishes at the first terminal
        status."""
        with obs.ensure("ingest") as ctx:
            return self._ingest_traced(
                ctx, filename, data, doc_type, patient_id, doc_date
            )

    def _ingest_traced(
        self, ctx, filename, data, doc_type, patient_id, doc_date
    ):
        record = self.registry.create(filename, doc_type, patient_id, doc_date)
        if ctx is not None:
            ctx.trace.root.attrs.setdefault("doc_id", record.doc_id)

        def _extract():
            faults.perturb("extract")  # resilience_site: extract
            return extract_text_ex(data, filename, self.http_extractor)

        with span("extract", DEFAULT_REGISTRY):
            try:
                # retried in place: a flaky HTTP extractor (or an injected
                # fault) gets retry_attempts before the terminal status
                text, why = self._io_retry.call(_extract, name="extract")
            except Exception:
                log.exception("extraction failed for %s", filename)
                text, why = None, "extractor_error"
        if text is None or not text.strip():
            # the row says WHY ("pdf_scanned_image_only", ...)
            self.registry.set_status(
                record.doc_id,
                reg.ERROR_EXTRACTION,
                detail=why or "empty_text",
            )
            self._notify_done()
            obs.flag("error_extraction")
            obs.finish(ctx, status="error")
            return self.registry.get(record.doc_id)
        try:
            self._publish(
                self.cfg.broker.raw_queue,
                {
                    "doc_id": record.doc_id,
                    "text": text,
                    "metadata": {
                        "filename": filename,
                        "type": doc_type,
                        "patient_id": patient_id,
                        "doc_date": doc_date,
                    },
                },
                headers=obs.headers_of(ctx),
            )
        except Exception:
            log.exception("queue publish failed")
            self.registry.set_status(record.doc_id, reg.ERROR_QUEUE)
            self._notify_done()
            obs.flag("error_queue")
            obs.finish(ctx, status="error")
            return self.registry.get(record.doc_id)
        self.registry.set_status(record.doc_id, reg.PROCESSED)
        # the trace stays open: the deid and index hops finish it
        return self.registry.get(record.doc_id)

    def _publish(
        self,
        queue: str,
        body: Dict[str, Any],
        headers: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Broker publish under the retry policy.  The broker breaker
        observes (one outcome per publish) but does not gate: a publish has
        no queue to wait in, so hold-and-retry beats failing fast."""
        br = self._broker_breaker
        try:
            self._retry.call(
                lambda: self.broker.publish(queue, body, headers=headers),
                name="broker_publish",
            )
        except Exception:
            if br is not None:
                br.record_failure()
            raise
        if br is not None:
            br.record_success()

    def ingest_text(self, text: str, **kw):
        """Convenience for pre-extracted text (tests, CSV bootstrap)."""
        return self.ingest_document(kw.pop("filename", "inline.txt"), text.encode(), **kw)

    # ---- workers -------------------------------------------------------------

    def _deid_handler(
        self,
        bodies: List[Dict[str, Any]],
        headers: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        # Pure phase first — a raise here is side-effect-free, so the
        # Consumer's one-by-one poison isolation (and its in-place retry
        # policy) may safely replay the batch.
        faults.perturb("deid")  # resilience_site: deid (slow-stage/outage)
        headers = headers if headers is not None else [{} for _ in bodies]
        texts = [b["text"] for b in bodies]
        t_batch0 = time.perf_counter()
        with span("deid_batch", DEFAULT_REGISTRY), self._deid_lane.active():
            masked = self.deid.deidentify_batch(texts)
        t_batch1 = time.perf_counter()
        # Side-effect phase: per-message failures are terminal here, never
        # re-raised (a raise would make the retry republish the prefix).
        for body, clean, hdrs in zip(bodies, masked, headers):
            # re-link the document's trace (or adopt a stub after a replay)
            # and charge it this batch's interval
            ctx = obs.from_headers(hdrs, name="doc")
            if ctx is not None:
                ctx.trace.record_span(
                    "deid_batch", t_batch0, t_batch1,
                    parent_id=ctx.span_id, batch=len(bodies),
                    doc_id=body.get("doc_id"),
                )
            try:
                # deleted docs stop here too; the suppress lock covers only
                # the set read — registry I/O runs outside it, and its
                # status write is conditional AT the database
                with self._suppress_lock:
                    suppressed = body["doc_id"] in self._suppressed_doc_ids
                if not suppressed:
                    # status BEFORE publish: once the message is on the
                    # clean queue the index worker may race us to INDEXED
                    if not self.registry.set_status_unless_deleted(
                        body["doc_id"], reg.DEIDENTIFIED
                    ):
                        # rowcount 0: a DELETED row suppresses; an absent
                        # row keeps the message flowing
                        record = self.registry.get(body["doc_id"])
                        suppressed = record is not None
                        if record is None:
                            log.warning(
                                "doc %s not in registry; processing anyway",
                                body["doc_id"],
                            )
                if suppressed:
                    log.info(
                        "dropping deleted doc %s at deid stage", body["doc_id"]
                    )
                    obs.finish(ctx, status="dropped")
                    continue
                self._publish(
                    self.cfg.broker.clean_queue,
                    {
                        "doc_id": body["doc_id"],
                        "original_text_masked": clean,
                        "metadata": body.get("metadata", {}),
                        "processed_at": time.time(),
                    },
                    headers=obs.headers_of(ctx),
                )
            except Exception:
                log.exception("clean-queue publish failed for %s", body["doc_id"])
                try:
                    self.registry.set_status_unless_deleted(
                        body["doc_id"], reg.ERROR_DEID
                    )
                    self._notify_done()
                except Exception:
                    log.exception("status write failed for %s", body["doc_id"])
                if ctx is not None:
                    ctx.trace.flag("error_deid")
                    obs.finish(ctx, status="error")

    def _index_handler(
        self,
        bodies: List[Dict[str, Any]],
        headers: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        # before any side effect: an injected raise here replays the whole
        # batch safely (resilience_site: index)
        faults.perturb("index")
        headers = headers if headers is not None else [{} for _ in bodies]
        # per-doc trace contexts, re-linked from the message headers; the
        # terminal status below finishes each trace
        ctx_by_doc = {
            body["doc_id"]: obs.from_headers(hdrs, name="doc")
            for body, hdrs in zip(bodies, headers)
        }
        all_chunks: List[str] = []
        all_meta: List[Dict[str, Any]] = []
        per_doc: List[tuple] = []
        replayed: List[str] = []
        for body in bodies:
            # durable suppression: a DELETED registry row survives restarts
            # that the in-memory suppressed set does not
            record = self.registry.get(body["doc_id"])
            if record is not None and record.status == reg.DELETED:
                log.info("dropping deleted doc %s (registry)", body["doc_id"])
                obs.finish(ctx_by_doc.get(body["doc_id"]), status="dropped")
                continue
            if body["doc_id"] in self._suppressed_doc_ids:
                log.info("dropping deleted in-flight doc %s", body["doc_id"])
                obs.finish(ctx_by_doc.get(body["doc_id"]), status="dropped")
                continue
            if body["doc_id"] in self._indexed_doc_ids:
                log.info(
                    "skipping replayed already-indexed doc %s", body["doc_id"]
                )
                replayed.append(body["doc_id"])
                continue
            text = body["original_text_masked"]
            md = body.get("metadata", {})
            published_at = body.get("processed_at")
            if published_at is not None:
                DEFAULT_REGISTRY.histogram("clean_queue_lag_s").observe(
                    max(0.0, time.time() - float(published_at))
                )
            chunks = chunk_text(text, self.cfg.chunk)
            per_doc.append((body["doc_id"], len(chunks)))
            for ci, ch in enumerate(chunks):
                all_chunks.append(ch.text)
                all_meta.append(
                    {
                        "doc_id": body["doc_id"],
                        "text_content": ch.text,
                        "source": f"Dossier Patient {body['doc_id']}"
                        if md.get("patient_id")
                        else (md.get("filename") or body["doc_id"]),
                        "type": "patient_file",
                        "patient_id": md.get("patient_id"),
                        "doc_type": md.get("type"),
                        "doc_date": md.get("doc_date"),
                        "chunk_index": ci,
                        "char_start": ch.start,
                        "char_end": ch.end,
                    }
                )
        t_batch0 = time.perf_counter()
        if all_chunks:
            with span("index_batch", DEFAULT_REGISTRY), self._index_lane.active():
                # encode is pure; a raise from it (or from store.add, whose
                # append is all-or-nothing) leaves no partial state, so the
                # Consumer's individual retry cannot duplicate vectors
                embeddings = self.encoder.encode_texts(all_chunks)
                tok_rows = tok_lens = None
                if self.prompt_tokenizer is not None and self.store.cfg.token_width:
                    tok_rows, tok_lens = sidecar_rows(
                        self.prompt_tokenizer, all_chunks,
                        self.store.cfg.token_width,
                    )
                with self._suppress_lock:
                    # a DELETE may have landed during the encode; drop those
                    # docs' rows now, while suppress_doc is excluded
                    late = {
                        d for d, _n in per_doc if d in self._suppressed_doc_ids
                    }
                    if late:
                        keep = [
                            i
                            for i, md in enumerate(all_meta)
                            if md["doc_id"] not in late
                        ]
                        embeddings = np.asarray(embeddings)[keep]
                        all_meta = [all_meta[i] for i in keep]
                        if tok_rows is not None:
                            tok_rows, tok_lens = tok_rows[keep], tok_lens[keep]
                        per_doc = [
                            (d, n) for d, n in per_doc if d not in late
                        ]
                        log.info(
                            "dropped %d doc(s) deleted mid-encode", len(late)
                        )
                        for d in sorted(late):
                            obs.finish(ctx_by_doc.get(d), status="dropped")
                    if all_meta:
                        self.store.add(
                            embeddings, all_meta,
                            token_rows=tok_rows, token_lens=tok_lens,
                        )
                    self._indexed_doc_ids.update(d for d, _n in per_doc)
            t_batch1 = time.perf_counter()
            for doc_id, n in per_doc:
                ctx = ctx_by_doc.get(doc_id)
                if ctx is not None:
                    ctx.trace.record_span(
                        "index_batch", t_batch0, t_batch1,
                        parent_id=ctx.span_id, batch=len(per_doc),
                        doc_id=doc_id, n_chunks=n,
                    )
        # vectors are committed past this point: never raise (a retry would
        # re-encode and re-append the whole batch)
        if self.on_indexed is not None and per_doc:
            # before the status writes: with snapshot_every=1 an INDEXED
            # status then implies the vectors are already durable
            try:
                self.on_indexed(len(per_doc))
            except Exception as e:
                if is_device_fault(e):
                    raise
                log.exception("on_indexed hook failed")
        for doc_id, n in per_doc:
            try:
                # conditional at the database: a DELETE between store.add
                # and here keeps its DELETED status
                with self._suppress_lock:
                    skip = doc_id in self._suppressed_doc_ids
                if skip:
                    obs.finish(ctx_by_doc.get(doc_id), status="dropped")
                    continue
                self.registry.set_status_unless_deleted(
                    doc_id, reg.INDEXED, n_chunks=n
                )
                # terminal: the whole ingest -> deid -> index timeline ends
                obs.finish(ctx_by_doc.get(doc_id), status="ok")
            except Exception:
                log.exception("status write failed for %s", doc_id)
        for doc_id in replayed:
            # the crash the replay recovers from may have hit between the
            # store add and the status write: make the registry agree with
            # the vectors it already has (idempotent overwrite)
            try:
                with self._suppress_lock:
                    skip = doc_id in self._suppressed_doc_ids
                if skip:
                    obs.finish(ctx_by_doc.get(doc_id), status="dropped")
                    continue
                self.registry.set_status_unless_deleted(doc_id, reg.INDEXED)
                obs.finish(ctx_by_doc.get(doc_id), status="ok")
            except Exception:
                log.exception("status write failed for %s", doc_id)
        if per_doc or replayed:  # wake wait_indexed() blockers
            self._notify_done()

    # ---- completion signal ---------------------------------------------------

    _TERMINAL = (
        reg.INDEXED,
        reg.ERROR_EXTRACTION,
        reg.ERROR_QUEUE,
        reg.ERROR_DEID,
        reg.ERROR_INDEXING,
        reg.DELETED,
    )

    def wait_indexed(self, doc_id: str, timeout: float = 30.0) -> bool:
        """True once the document is INDEXED, False at another terminal
        status, at the timeout or after stop().  Raises the device fault
        that stopped a worker.  Blocks on a Condition signaled by every
        terminal status write, re-reading at least once a second (another
        process's write to a shared registry cannot signal it)."""
        deadline = time.monotonic() + timeout
        with self._done_cv:
            while True:
                if self._fault is not None:
                    raise self._fault
                record = self.registry.get(doc_id)
                if record is not None and record.status in self._TERMINAL:
                    return record.status == reg.INDEXED
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stopped:
                    return False
                self._done_cv.wait(min(remaining, 1.0))
