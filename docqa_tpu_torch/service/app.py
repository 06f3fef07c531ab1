"""Application wiring and the HTTP surface, counterpart of
``docqa_tpu/service/app.py``.

:class:`DocQARuntime` builds and owns every component under one
``Config``: the dispatch spine, encoder, vector store with its lexical
tier, de-identification engine, generator and its ``EnginePool``,
summarizer, broker, registry, ingest pipeline, answer router, QA and
synthesis services, cost ledger probe, telemetry sampler and SLO
evaluator.  :meth:`DocQARuntime.start` / :meth:`DocQARuntime.stop` run and
join the workers.

:class:`App` holds the reference's 29 routes (``make_app``) as plain
functions from a :class:`Request` to a :class:`Response` (JSON payload,
raw body, or an iterator of server-sent events for ``/ask/stream``), with
the reference's statuses, payloads and its three executor lanes: the
device lane (1 thread: retrieval, submissions, deletes), the wait lane
(``max(generate.max_concurrent, 4)`` threads: waits on decodes) and the
host lane (4 threads: extraction, registry and journal IO, pool control).

:class:`AppServer` puts the standard library's ``ThreadingHTTPServer`` in
front of an :class:`App`.  The card's Python has neither aiohttp nor
pydantic, so the port's server is stdlib-only in every place it runs.
Bodies above 64 MiB get 413; ``multipart/form-data`` uploads are parsed
with ``email.parser.BytesParser``.

Failure policy.  The reference's handlers catch broadly (a probe that
fails reads as absent, a profiler that fails answers 500, a stream that
fails sends an error event).  Here a kernel that fails to build or launch,
or a CUDA error (``ops/_kernels.is_device_fault``), passes every such
catch: :meth:`App.handle` raises it, and the HTTP front answers nothing,
closes the connection and stops serving, and :func:`serve` re-raises it.
The runtime's warm-up thread keeps its fault for :meth:`DocQARuntime.stop`
to raise.

Persistence, as in the reference, rides ``data.work_dir``: the store
restores from ``<work_dir>/index`` on boot (a corrupt or mismatched
snapshot logs and serves a fresh store; a device fault raises), the broker
journals under ``<work_dir>/journal``, the default registry lives in
``<work_dir>/registry.db``, registry rows INDEXED whose vectors the
restored snapshot lacks are re-marked ``ERROR_INDEXING``, and the store
snapshots after a bootstrap, every ``data.snapshot_every`` indexed
documents, after a DELETE (an erasure keeps no predecessor) and at
:meth:`DocQARuntime.stop`.  With ``store.token_width > 0`` (and a real
encoder and decoder) ``/ask`` takes the single-sync fused chain while the
pool is idle (``engines/rag_fused.py``).

With ``store.serving_index="tiered"`` the store is served through a
``TieredIndex`` (IVF over the bulk, an exact tail, the lexical tier's modes)
and ``/ask`` retrieves through ``FusedTieredRetriever``.  The retrieval
observatory (``retrieval_quality.enabled``) is the process hook the tiered
paths offer shadow jobs to; ``/api/retrieval`` serves its ``status()``
(under exact serving it idles).

Checkpoints, as in the reference: ``encoder.checkpoint_dir`` (BERT),
``decoder.checkpoint_dir`` (Llama/Mistral, its context capped at the
configured ``decoder.max_seq_len``) and ``seq2seq.checkpoint_dir`` (BART,
for ``summarizer.backend="seq2seq"``) load architecture, weights and
vocabulary from an HF directory (``models/hf_checkpoint.py``); the
loader's ``checkpoint`` breaker is on the runtime's board, so
``/api/status`` shows it.  The seq2seq summarizer packs the raw documents
(no instruction template) within ``min(max_input_tokens, max_src_len)``.

On a mesh of ranks (a ``torch.distributed`` process group is up: torchrun,
or :func:`~docqa_tpu_torch.runtime.mesh.multihost_init`) the runtime builds
its mesh with ``make_mesh(cfg.mesh)`` and hands it to the encoder (data
parallel), the store and the lexical tier (rows over the model axis), the
tagger's trainer (data parallel) and the decoder and its pool (Megatron
tensor parallel, the paged pools' kv heads over the model axis), as the
reference's runtime does.  Every rank builds those parts from the same
config and weights, in the same order, with a command stream
(``runtime/mesh.py``).  Rank 0, the leader, then builds the rest and alone
serves HTTP, runs the ingest workers, the pool's monitor and canaries,
the telemetry sampler, the journal, the registry and the snapshots; every
device-plane call that issues a collective or writes a sharded tensor is
a command it publishes before it runs.  Every other rank, a follower,
runs :meth:`DocQARuntime.follow` until the leader's :meth:`DocQARuntime.stop`
publishes ``stop``.  A lost rank breaks the mesh: the collective or the
publish raises ``MeshFault``, a device fault, so ``/ask`` answers 503 and
the front stops serving.  That holds where collectives block (gloo); over
NCCL a rank lost during a collective ends the process through NCCL's
watchdog instead (``runtime/mesh.py``).  ``/api/status`` gains a ``mesh`` section.  In a
world of one rank the leader's path runs alike, its commands counted and
published to no one.  The seq2seq summarizer and the tagger's forward stay
off the mesh on the leader, as in the reference.

Every configuration the reference can name boots: :func:`refuse_unported`,
the one place a boot would refuse a part this port lacks, refuses nothing
since tiered serving on a mesh came (queue 1 item 9c: the int8 IVF tier
row-sharded over the model axis, the tiered and hybrid programs as
commands, ``index/tiered.py``).
``/api/witness`` and ``/api/ledger`` serve the two runtime witnesses of
``analysis/`` (the lock-order graph, the KV-table and cost-record ledger)
when the process booted with ``DOCQA_RACE_WITNESS=1`` /
``DOCQA_LEDGER_WITNESS=1``, and answer 404 otherwise, as the reference's
do.

Entry point: ``python -m docqa_tpu_torch.service.app`` (see :func:`main`),
or ``torchrun --nproc-per-node N -m docqa_tpu_torch.service.app`` on a mesh
(rank 0 binds ``--port``, the others bind nothing).
"""

from __future__ import annotations

if __name__ == "__main__":
    # served as `python -m`: the lock witness goes in before the port's
    # modules below build their import-time locks
    from docqa_tpu_torch.analysis import race_witness as _race_witness

    _race_witness.maybe_install_from_env()

import argparse
import concurrent.futures
import functools
import json
import os
import queue
import re
import signal
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from docqa_tpu_torch import obs
from docqa_tpu_torch.config import Config, coerce_value, load_config, unused_fields
from docqa_tpu_torch.engines import spine as _spine
from docqa_tpu_torch.engines.serve import QueueFull
from docqa_tpu_torch.models import hf_checkpoint
from docqa_tpu_torch.ops._kernels import MeshFault, is_device_fault
from docqa_tpu_torch.resilience import faults as _faults
from docqa_tpu_torch.resilience.breaker import BreakerBoard
from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
from docqa_tpu_torch.resilience.faults import FaultPlan
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger
from docqa_tpu_torch.service.schemas import (
    PatientComparisonRequest,
    PatientSummaryRequest,
    Query,
    SummarizeRequest,
)
from docqa_tpu_torch.service.synthesis import SynthesisError
from docqa_tpu_torch.service.wire import to_wire
from docqa_tpu_torch.utils import resolve_device

log = get_logger("docqa.app")

MAX_BODY = 64 * 1024 * 1024  # the reference's client_max_size
UI_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ui.html")


def refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a configuration that needs a part
    of the reference this port does not have yet, naming its ROADMAP item.
    None is left: every configuration the reference can name is ported,
    tiered serving on a mesh (item 9c) last, so this refuses nothing; the
    boot keeps calling it as the place such a refusal goes."""
    del cfg


def check_config(cfg: Config) -> None:
    """Refuse a store score the store does not compute (``ValueError``),
    and log once each field the port keeps for the reference's surface but
    has no subject for, when it is set away from its default."""
    if cfg.store.score != "cosine":
        raise ValueError(
            f"store.score={cfg.store.score!r}: the store ranks by cosine "
            "(a product of normalised rows) only"
        )
    for path, value in sorted(unused_fields(cfg).items()):
        log.info("%s=%r has no subject in this package; ignored", path, value)


class DocQARuntime:
    """Builds and owns every component; :meth:`start` / :meth:`stop`
    manage the workers.  Everything runs on ``device`` (the card unless
    the caller asks for the CPU).

    ``decoder_params``: the generator's weights (a tree with the
    reference's names, e.g. ``models.decoder.init_decoder_params`` drawn on
    the card); None draws the reference's seeded host init, which is slow
    at full width, unless ``decoder.checkpoint_dir`` names a checkpoint
    (then passing weights too is an error).

    ``load_seconds`` holds the seconds each checkpoint load took (keys
    ``encoder``, ``decoder``, ``seq2seq``)."""

    def __init__(
        self,
        cfg: Optional[Config] = None,
        journal_dir: Optional[str] = None,
        device="cuda",
        decoder_params=None,
    ) -> None:
        # DOCQA_RACE_WITNESS=1 wraps every named lock and cv built from here
        # on (GET /api/witness); DOCQA_LEDGER_WITNESS=1 tracks every KV
        # table and cost record (GET /api/ledger).  This is the fallback
        # install point: locks built when the port's modules were imported
        # (obs, runtime.metrics, ops/_kernels) predate it; main() installs
        # the lock witness at process entry for a served process.
        from docqa_tpu_torch.analysis import ledger_audit, race_witness

        race_witness.maybe_install_from_env()
        ledger_audit.maybe_install_from_env()
        from docqa_tpu_torch.deid.engine import DeidEngine
        from docqa_tpu_torch.engines.encoder import EncoderEngine, HashEncoder
        from docqa_tpu_torch.engines.generate import GenerateEngine
        from docqa_tpu_torch.engines.pool import EnginePool
        from docqa_tpu_torch.engines.rag_fused import FusedRAG
        from docqa_tpu_torch.engines.retrieve import (
            FusedRetriever,
            FusedTieredRetriever,
        )
        from docqa_tpu_torch.engines.router import AnswerRouter
        from docqa_tpu_torch.index.lexical import LexicalIndex
        from docqa_tpu_torch.index.store import VectorStore
        from docqa_tpu_torch.index.tiered import TieredIndex
        from docqa_tpu_torch.service.broker import make_broker
        from docqa_tpu_torch.service.pipeline import DocumentPipeline
        from docqa_tpu_torch.service.qa import QA_TEMPLATE, QAService
        from docqa_tpu_torch.service.registry import DocumentRegistry
        from docqa_tpu_torch.service.synthesis import (
            SynthesisService,
            fake_patient_retrieval,
        )

        self.cfg = cfg = cfg or load_config()
        refuse_unported(cfg)
        check_config(cfg)
        if (cfg.decoder.checkpoint_dir and not cfg.flags.use_fake_llm
                and decoder_params is not None):
            raise ValueError(
                "decoder.checkpoint_dir and decoder_params both give the "
                "generator's weights; pass one"
            )
        self.device = resolve_device(device)
        self.breakers = BreakerBoard(
            failure_threshold=cfg.resilience.breaker_failure_threshold,
            reset_timeout_s=cfg.resilience.breaker_reset_s,
        )
        # the loader's breaker is a module singleton (loads happen outside
        # the runtime too), adopted so that /api/status shows it
        self.breakers.adopt(hf_checkpoint._LOAD_BREAKER)
        self.load_seconds: Dict[str, float] = {}
        self._fault_plan = FaultPlan.from_env()
        if self._fault_plan is not None:
            _faults.install(self._fault_plan)
            log.warning(
                "fault-injection plan ACTIVE (%d rule(s), seed %d)",
                len(self._fault_plan.rules), self._fault_plan.seed,
            )
        # every component below runs its device work through the spine
        self.spine = _spine.configure(
            n_lanes=cfg.dispatch.n_lanes,
            max_depth=cfg.dispatch.max_depth,
            inline=cfg.dispatch.inline,
            strict_sync=cfg.dispatch.strict_sync,
        )
        # a process group up: the mesh over it and the command stream every
        # rank builds at this same point (module docstring)
        self.mesh = self.stream = None
        import torch.distributed as dist

        if dist.is_initialized():
            from docqa_tpu_torch.runtime.mesh import CommandStream, make_mesh

            self.mesh = make_mesh(cfg.mesh, device=self.device)
            self.device = self.mesh.device
            self.stream = CommandStream(self.mesh)
        dev, mesh = self.device, self.mesh
        follower = self.stream is not None and self.stream.follower
        if cfg.flags.use_fake_encoder:
            if cfg.encoder.checkpoint_dir:
                # a real checkpoint configured, yet hash embeddings served
                log.warning(
                    "flags.use_fake_encoder=true shadows encoder.checkpoint_dir"
                    "=%s — serving HASH embeddings", cfg.encoder.checkpoint_dir,
                )
            self.encoder = HashEncoder(cfg.encoder, device=dev)
        elif cfg.encoder.checkpoint_dir:
            from docqa_tpu_torch.config import EncoderConfig

            t0 = time.perf_counter()
            enc_cfg, enc_params, _ = hf_checkpoint.load_checkpoint_dir(
                cfg.encoder.checkpoint_dir, expect=EncoderConfig,
                tokenizer_fallback=cfg.encoder.tokenizer_path,
            )
            if enc_cfg.embed_dim != cfg.store.dim:
                raise ValueError(
                    f"encoder checkpoint embeds {enc_cfg.embed_dim}-d but "
                    f"store.dim is {cfg.store.dim} — set "
                    f"DOCQA_STORE__DIM={enc_cfg.embed_dim} (an existing "
                    "index snapshot of the old dim cannot be reused)"
                )
            self.encoder = EncoderEngine(enc_cfg, params=enc_params, device=dev,
                                         mesh=mesh)
            self.load_seconds["encoder"] = time.perf_counter() - t0
        else:
            self.encoder = EncoderEngine(cfg.encoder, device=dev, mesh=mesh)
        if self.stream is not None and not cfg.flags.use_fake_encoder:
            self.stream.register("encoder", self.encoder)
        work_dir = cfg.data.work_dir
        # restore on boot; a corrupt or mismatched snapshot logs and serves
        # a fresh store, as the reference's does, but a device fault raises
        self._index_dir = os.path.join(work_dir, "index") if work_dir else None
        self._docs_since_snapshot = 0
        self._snapshot_lock = threading.Lock()
        self.store = None
        if self._index_dir and os.path.exists(
            os.path.join(self._index_dir, "LATEST")
        ):
            try:
                self.store = VectorStore.restore(
                    self._index_dir, cfg.store, device=dev, mesh=mesh
                )
                log.info(
                    "restored index v%d (%d rows) from %s",
                    self.store.version, self.store.count, self._index_dir,
                )
            except Exception as e:
                if is_device_fault(e):
                    raise
                log.exception("index restore failed; starting with an empty store")
        if self.store is None:
            self.store = VectorStore(cfg.store, device=dev, mesh=mesh)
        if self.stream is not None:
            self.stream.register("store", self.store)
        # the lexical tier is fed by the store's sink seam, registered
        # before any bootstrap indexing
        self.lexical = None
        if cfg.lexical.enabled:
            lx = cfg.lexical
            self.lexical = LexicalIndex(
                vocab_size=lx.vocab_size, tile_width=lx.tile_width,
                k1=lx.k1, b=lx.b, ref_len=lx.ref_len, device=dev, mesh=mesh,
            )
            if self.stream is not None:
                self.stream.register("lexical", self.lexical)
            self.store.register_index_sink(self.lexical)
        self.search_index = self.store
        if cfg.store.serving_index == "tiered":
            sc = cfg.store
            # on a mesh the tier shards where the store shards
            self.search_index = TieredIndex(
                self.store, nprobe=sc.ivf_nprobe, min_rows=sc.ivf_min_rows,
                rebuild_tail_rows=sc.ivf_rebuild_tail, storage=sc.ivf_storage,
                lexical=self.lexical, hybrid_alpha=cfg.lexical.hybrid_alpha,
                default_mode=cfg.lexical.serving_mode,
            )
            if self.stream is not None:
                self.stream.register("tiered", self.search_index)
        if cfg.ner.train_steps > 0 or cfg.ner.params_path:
            # loads the trained tagger's cache, or trains it (in a child
            # process on a card) and caches it there: restarts load
            # instead of retrain; the npz fingerprint invalidates the
            # cache on any architecture or recipe change
            params_path = cfg.ner.params_path or (
                os.path.join(work_dir, "ner.npz") if work_dir
                else os.path.join(
                    os.path.expanduser("~"), ".cache", "docqa_tpu", "ner.npz"
                )
            )
            self.deid = DeidEngine.trained(
                cfg.ner, params_path=params_path, steps=cfg.ner.train_steps,
                device=dev, mesh=mesh,
            )
        else:  # plumbing mode: a seeded random tagger
            self.deid = DeidEngine(cfg.ner, device=dev)
        dec_cfg = cfg.decoder
        if dec_cfg.checkpoint_dir and cfg.flags.use_fake_llm:
            # the fake path never decodes: no multi-GB load for it
            log.warning(
                "flags.use_fake_llm=true: decoder.checkpoint_dir=%s is NOT "
                "loaded (fake answers are served)", dec_cfg.checkpoint_dir,
            )
        elif dec_cfg.checkpoint_dir:
            import dataclasses

            from docqa_tpu_torch.config import DecoderConfig

            # the configured quantize_weights / quant_bits still govern the
            # serving precision: the engine quantises on load, tensor by
            # tensor as it uploads
            t0 = time.perf_counter()
            loaded_cfg, decoder_params, _ = hf_checkpoint.load_checkpoint_dir(
                dec_cfg.checkpoint_dir, expect=DecoderConfig,
                keep={"quantize_weights": dec_cfg.quantize_weights,
                      "quant_bits": dec_cfg.quant_bits},
                tokenizer_fallback=dec_cfg.tokenizer_path,
            )
            # the batcher sizes its KV pool from max_seq_len: a checkpoint's
            # 32k context is capped at the configured window
            dec_cfg = dataclasses.replace(
                loaded_cfg,
                max_seq_len=min(loaded_cfg.max_seq_len, dec_cfg.max_seq_len),
                chat_template=dec_cfg.chat_template,
            )
            self.load_seconds["decoder"] = time.perf_counter() - t0
        self.generator = GenerateEngine(
            dec_cfg, gen=cfg.generate, params=decoder_params, device=dev,
            mesh=mesh,
        )
        if self.stream is not None:
            self.stream.register("generator", self.generator)
        # the seq2seq summarizer's checkpoint loads before the pool starts
        # its workers, so a bad directory fails the boot with none running;
        # it stays off the mesh, on the leader
        seq2seq = None if follower else self._build_seq2seq()
        self.batcher = None
        if not cfg.flags.use_fake_llm:
            self.batcher = EnginePool(
                self.generator, cfg=cfg.pool, qos=cfg.qos, device=dev
            )
        # exact serving retrieves dense, as the reference's does; the
        # retrieve modes ride on the tiered index
        retriever = None
        if not cfg.flags.use_fake_encoder:
            if self.search_index is self.store:
                retriever = FusedRetriever(self.encoder, self.store, device=dev)
            else:
                retriever = FusedTieredRetriever(
                    self.encoder, self.search_index, device=dev
                )
            if self.stream is not None:
                self.stream.register("retriever", retriever)
        self._started = False
        self._warmup_thread: Optional[threading.Thread] = None
        self._warmup_fault: Optional[BaseException] = None
        if follower:
            # a follower serves nothing: it replays the leader's commands
            # (follow()) on the parts above
            for name in ("summarizer", "broker", "registry", "pipeline",
                         "router", "qa", "synthesis", "retrieval_obs",
                         "costs", "telemetry", "slo", "sampler"):
                setattr(self, name, None)
            return
        if self.stream is not None:
            self.stream.open()
        self.summarizer = self._build_summarizer(seq2seq)
        if journal_dir is None and work_dir:
            # un-acked pipeline messages replay after a crash
            journal_dir = os.path.join(work_dir, "journal")
        self.broker = make_broker(cfg.broker, journal_dir=journal_dir)
        registry_url = cfg.registry.url
        if registry_url == "sqlite://" and work_dir:
            # an index that outlives its registry would serve vectors for
            # documents /documents/ no longer lists
            os.makedirs(work_dir, exist_ok=True)
            registry_url = "sqlite:///" + os.path.join(work_dir, "registry.db")
        self.registry = DocumentRegistry(registry_url, table=cfg.registry.table)
        # generator tokens at index time feed the fused chain's sidecar
        prompt_tokenizer = (
            self.generator.tokenizer if cfg.store.token_width else None
        )
        http_extractor = None
        if cfg.service.extractor_url:
            from docqa_tpu_torch.service.extract import make_http_extractor

            http_extractor = make_http_extractor(cfg.service.extractor_url)
        self.pipeline = DocumentPipeline(
            cfg, self.broker, self.registry, self.deid, self.encoder,
            self.store, http_extractor=http_extractor,
            on_indexed=self._on_indexed, breakers=self.breakers,
            prompt_tokenizer=prompt_tokenizer,
        )
        if self._index_dir:
            self._reconcile_registry()
        if cfg.data.bootstrap_dir and self.store.count == 0:
            from docqa_tpu_torch.service.bootstrap import bootstrap_csv_dir

            n = bootstrap_csv_dir(
                cfg.data.bootstrap_dir, self.encoder, self.store,
                prompt_tokenizer=prompt_tokenizer,
            )
            if n and self._index_dir:
                self._snapshot()
        # the single-sync ask needs the sidecar, device encoder params and
        # a real decoder, over exact serving on one device: as the
        # reference's runtime, none on a mesh (FusedRAG itself takes a
        # row-sharded store and a tensor-parallel generator)
        fused_rag = None
        if (
            cfg.store.token_width
            and not cfg.flags.use_fake_llm
            and not cfg.flags.use_fake_encoder
            and cfg.store.serving_index == "exact"
            and (mesh is None or mesh.n_devices == 1)
        ):
            fused_rag = FusedRAG(
                self.encoder, self.store, self.generator, QA_TEMPLATE,
                k=cfg.store.default_k, device=dev,
            )
        self.router = None
        if cfg.router.enabled:
            self.router = AnswerRouter(
                min_confidence=cfg.router.min_confidence,
                evidence_min=cfg.router.evidence_min,
            )
        self.qa = QAService(
            self.encoder, self.search_index, self.generator,
            k=cfg.store.default_k, device=dev, batcher=self.batcher,
            breakers=self.breakers, resilience=cfg.resilience,
            use_fake_llm=cfg.flags.use_fake_llm,
            retriever=retriever, router=self.router, fused_rag=fused_rag,
        )
        retrieval = (
            fake_patient_retrieval if cfg.flags.use_fake_retrieval
            else self.qa.patient_snippets
        )
        self.synthesis = SynthesisService(retrieval=retrieval, summarizer=self.summarizer)
        # the retrieval observatory, installed as the process hook the
        # tiered paths offer shadow jobs to; its worker starts in start()
        rq = cfg.retrieval_quality
        self.retrieval_obs = None
        if rq.enabled:
            self.retrieval_obs = obs.RetrievalObservatory(
                sample_every=rq.sample_every, seed=rq.seed, window=rq.window,
                max_pending=rq.max_pending, frontier_every=rq.frontier_every,
                frontier_factors=rq.frontier_factors,
                min_frontier_n=rq.min_frontier_n,
                recall_target=rq.recall_target,
                auto_apply=rq.auto_apply_nprobe,
                apply_nprobe=getattr(self.search_index, "set_nprobe", None),
                registry=DEFAULT_REGISTRY,
            )
            obs.set_retrieval_observatory(self.retrieval_obs)
        self.costs = obs.DEFAULT_COST_LEDGER
        self.costs.set_pressure_probe(self._cost_pressure)
        self.telemetry = None
        self.slo = None
        self.sampler = None
        tcfg = cfg.telemetry
        if tcfg.enabled:
            # align the histograms' rollup windows with the store's clock
            # before serving (re-windowing drops sealed history)
            DEFAULT_REGISTRY.configure_windows(tcfg.interval_s, tcfg.points)
            self.telemetry = obs.TelemetryStore(
                interval_s=tcfg.interval_s, points=tcfg.points
            )
            slos = obs.default_ask_slos(
                p95_objective_ms=tcfg.slo_ask_p95_ms,
                availability=tcfg.slo_ask_availability,
                degraded_budget=tcfg.slo_ask_degraded_budget,
                short_windows=tcfg.slo_short_windows,
                long_windows=tcfg.slo_long_windows,
                burn_threshold=tcfg.slo_burn_threshold,
            )
            if self.retrieval_obs is not None:
                slos += obs.default_retrieval_slos(
                    recall_target=rq.recall_target,
                    short_windows=rq.slo_short_windows,
                    long_windows=rq.slo_long_windows,
                    burn_threshold=rq.slo_burn_threshold,
                    min_events=rq.slo_min_events,
                )
            self.slo = obs.BurnRateEvaluator(
                self.telemetry, slos, registry=DEFAULT_REGISTRY,
                recorder=obs.DEFAULT_RECORDER,
            )
            if self.batcher is not None:
                # the burn evaluator is the admission layer's deferral signal
                self.batcher.set_slo_probe(self.slo.firing)
            self.sampler = obs.TelemetrySampler(
                self.telemetry,
                registry=DEFAULT_REGISTRY,
                batcher=self.batcher,
                broker=self.broker,
                queues=(cfg.broker.raw_queue, cfg.broker.clean_queue),
                recorder=obs.DEFAULT_RECORDER,
                engine=self.generator if self.batcher is not None else None,
                slo_evaluator=self.slo,
                spine=self.spine,
                retrieval=self.retrieval_obs,
                sample_every_s=tcfg.sample_every_s,
                extra_probes=(self.costs.telemetry_gauges,),
            )

    def _build_seq2seq(self):
        """The seq2seq summarizer's engine (``summarizer.backend="seq2seq"``
        and a decoding runtime), else None: from ``seq2seq.checkpoint_dir``
        when set (architecture, weights, vocabulary and the shipped policy;
        a policy knob the operator set wins, so ``num_beams=1`` forces
        greedy over a checkpoint's 4), else the seeded init."""
        cfg = self.cfg
        if cfg.summarizer.backend != "seq2seq" or cfg.flags.use_fake_llm:
            return None  # the fake path never decodes: no BART for it
        from docqa_tpu_torch.config import Seq2SeqConfig
        from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine

        s2s = cfg.seq2seq
        if not s2s.checkpoint_dir:
            return Seq2SeqEngine(s2s, device=self.device)
        knobs = ("num_beams", "length_penalty", "min_length", "no_repeat_ngram")
        t0 = time.perf_counter()
        s2s, params, _ = hf_checkpoint.load_checkpoint_dir(
            s2s.checkpoint_dir, expect=Seq2SeqConfig,
            keep={k: getattr(s2s, k) for k in knobs if getattr(s2s, k) is not None},
            tokenizer_fallback=s2s.tokenizer_path,
        )
        model = Seq2SeqEngine(s2s, params=params, device=self.device)
        self.load_seconds["seq2seq"] = time.perf_counter() - t0
        return model

    def _build_summarizer(self, seq2seq):
        """The decoder backend through the pool, or ``seq2seq`` (its own
        weights and decode loop, no batcher) on the raw packed documents,
        whose source window caps the packing budget: otherwise the engine
        would cut a packed prompt at ``max_src_len`` and drop documents
        silently."""
        import dataclasses

        from docqa_tpu_torch.engines.summarize import SummarizeEngine

        cfg = self.cfg
        if seq2seq is None:
            return SummarizeEngine(
                self.generator, cfg.summarizer,
                use_fake=cfg.flags.use_fake_llm, batcher=self.batcher,
            )
        return SummarizeEngine(
            seq2seq,
            dataclasses.replace(
                cfg.summarizer,
                max_input_tokens=min(cfg.summarizer.max_input_tokens,
                                     seq2seq.cfg.max_src_len),
            ),
            instruction_prompts=False,  # BART summarizes raw source text
        )

    def _reconcile_registry(self) -> None:
        """Re-mark ``ERROR_INDEXING`` every registry row INDEXED whose
        vectors the restored store lacks (a crash between snapshots): the
        registry must not claim documents that cannot be retrieved."""
        from docqa_tpu_torch.service import registry as reg

        try:
            indexed_ids = {md.get("doc_id") for md in self.store.metadata_rows()}
            lost = [
                rec for rec in self.registry.list_documents()
                if rec.status == reg.INDEXED and rec.doc_id not in indexed_ids
            ]
            for rec in lost:
                self.registry.set_status(rec.doc_id, reg.ERROR_INDEXING)
            if lost:
                log.warning(
                    "reconciled %d registry rows whose vectors predate the "
                    "restored snapshot (re-marked ERROR_INDEXING)", len(lost),
                )
        except Exception:
            log.exception("registry/index reconciliation failed")

    @property
    def follower(self) -> bool:
        """True on a rank of a mesh other than the leader."""
        return self.stream is not None and self.stream.follower

    def _snapshot(self, keep_previous: bool = True) -> None:
        """Snapshot the store under ``<work_dir>/index`` (one at a time, the
        leader alone on a mesh); a failure is logged, a device fault
        raised."""
        if not self._index_dir or self.follower:
            return
        with self._snapshot_lock:
            try:
                self.store.snapshot(self._index_dir, keep_previous=keep_previous)
                self._docs_since_snapshot = 0
            except Exception as e:
                if is_device_fault(e):
                    raise
                log.exception("index snapshot failed")

    def _on_indexed(self, n_docs: int) -> None:
        """The index worker's hook after each batch: a snapshot every
        ``data.snapshot_every`` documents."""
        if not self._index_dir or self.cfg.data.snapshot_every <= 0:
            return
        # counted under the snapshot's lock: a batch landing while a
        # snapshot is written is counted after its reset, not erased by it
        with self._snapshot_lock:
            self._docs_since_snapshot += n_docs
            due = self._docs_since_snapshot >= self.cfg.data.snapshot_every
        if due:
            self._snapshot()

    def _cost_pressure(self) -> Dict[str, Any]:
        """Shed-forensics pressure snapshot: per-class holdings of the pool,
        its preemption dry run, and the spine's queue depth."""
        out: Dict[str, Any] = {}
        b = self.batcher
        if b is not None:
            out = b.pressure_by_class() or {}
            try:
                out["preemption_candidates"] = b.preemption_candidates()
            except Exception as e:
                if is_device_fault(e):
                    raise
        out["spine_queue_depth"] = self.spine.queue_depth
        return out

    def follow(self) -> int:
        """A follower's serving loop: replay the leader's commands until it
        stops (``runtime/mesh.py``); returns the commands replayed."""
        if not self.follower:
            raise RuntimeError("only a follower rank of a mesh follows")
        return self.stream.follow()

    def start(self) -> "DocQARuntime":
        if self.follower:
            raise RuntimeError("a follower rank starts nothing; call follow()")
        self.pipeline.start()
        if self.retrieval_obs is not None:
            self.retrieval_obs.start()
        if self.sampler is not None:
            self.sampler.start()
        if self.batcher is not None:
            # the pool warmed its programs at construction; one real request
            # end to end checks admission, sampling and retirement off the
            # request path (background class: never interactive spend)
            self._warmup_thread = threading.Thread(
                target=self._warmup_decode, daemon=True, name="warmup"
            )
            self._warmup_thread.start()
        self._started = True
        return self

    def _warmup_decode(self) -> None:
        try:
            self.batcher.submit_ids(
                [1, 2, 3], max_new_tokens=2, req_class="background"
            ).result(timeout=600)
            if self.cfg.dispatch.annotate_costs:
                self.batcher.annotate_costs()
            log.info("decode path warm")
        except Exception as e:
            if is_device_fault(e):
                self._warmup_fault = e  # raised by stop()
                return
            log.exception("decode warmup failed (serving continues cold)")

    def retrieval_status(self) -> Dict[str, Any]:
        """``/api/retrieval``: the observatory's ``status()`` (estimates,
        drift, the frontier, the recommended nprobe), the serving tier and
        the router's posture and route split.  Needs the observatory
        (``retrieval_quality.enabled``)."""
        index = self.search_index
        stats_fn = getattr(index, "index_stats", None)
        return {
            **self.retrieval_obs.status(),
            "serving": {
                "serving_index": self.cfg.store.serving_index,
                "rows": self.store.count,
                "nprobe": getattr(index, "nprobe", None),
                "covered": getattr(index, "covered", None),
                "tail_rows": getattr(index, "tail_rows", None),
                "index": stats_fn() if stats_fn is not None else None,
                # the port has no off-mesh fallback: a tiered or hybrid
                # retrieval on a mesh runs its sharded program, so this
                # stays 0 on every path, as the reference's gate holds it
                "offmesh_fallbacks": DEFAULT_REGISTRY.counter(
                    "retrieve_offmesh_fallback"
                ).value,
            },
            "routing": {
                "enabled": self.router is not None,
                "min_confidence": getattr(self.router, "min_confidence", None),
                "evidence_min": getattr(self.router, "evidence_min", None),
                "routed_extractive": DEFAULT_REGISTRY.counter(
                    "qa_routed_extractive"
                ).value,
                "routed_generative": DEFAULT_REGISTRY.counter(
                    "qa_routed_generative"
                ).value,
                "hybrid_alpha": self.cfg.lexical.hybrid_alpha,
                "serving_mode": self.cfg.lexical.serving_mode,
            },
        }

    def delete_document(self, doc_id: str, erase: bool = False) -> int:
        """Tombstone a document out of retrieval: a document still in the
        pipeline is suppressed, an indexed one's chunks are tombstoned, and
        ``erase=True`` (or tombstones past ``store.compact_threshold`` of
        the rows) compacts the store.  A change is snapshotted at once; an
        erasure's snapshot keeps no predecessor (it would still hold the
        erased rows).  Returns the chunks tombstoned by this call."""
        from docqa_tpu_torch.service import registry as reg

        # first, so a racing index batch cannot add chunks after the look
        self.pipeline.suppress_doc(doc_id)
        n = self.store.delete_docs([doc_id])
        threshold = self.cfg.store.compact_threshold
        auto = (
            not erase
            and threshold > 0
            and self.store.count > 0
            and self.store.deleted_count >= threshold * self.store.count
        )
        compacted = 0
        if erase or auto:
            compacted = self.store.compact_deleted()
            # compaction renumbers the rows a tier was built over
            if compacted and self.search_index is not self.store:
                self.search_index.reset()
        try:
            self.registry.set_status(doc_id, reg.DELETED)
        except Exception:
            log.exception("status write failed for %s", doc_id)
        if n or compacted:
            self._snapshot(keep_previous=not erase)
        return n

    def stop(self) -> None:
        """Join every worker (each with a bound) and release the process
        hooks this runtime installed; raises a device fault the warm-up
        thread, the retrieval observatory or a tier rebuild kept."""
        faults_kept: List[BaseException] = []

        def keep_fault(fn):
            try:
                fn()
            except Exception as e:
                if not is_device_fault(e):
                    raise
                faults_kept.append(e)

        if self.follower:
            if self.batcher is not None:
                self.batcher.stop()
            # a tier's stage may be building this rank's shard
            index_close = getattr(self.search_index, "close", None)
            if index_close is not None:
                index_close()
            return

        if self.sampler is not None:
            self.sampler.stop()
        # the observatory's worker submits work against the store and the
        # tier: join it before the index plane; uninstall the hook only if
        # it is still this runtime's
        if self.retrieval_obs is not None:
            keep_fault(self.retrieval_obs.stop)
            if obs.get_retrieval_observatory() is self.retrieval_obs:
                obs.set_retrieval_observatory(None)
        self.pipeline.stop()
        if self.batcher is not None:
            self.batcher.stop()
        # a tiered index may have a background rebuild in flight
        index_close = getattr(self.search_index, "close", None)
        if index_close is not None:
            keep_fault(index_close)
        warmup = self._warmup_thread
        if warmup is not None:
            warmup.join(timeout=5)
            if warmup.is_alive():
                log.warning("decode warmup thread still alive after stop()")
        try:
            # a restart resumes exactly here
            self._snapshot()
        finally:
            if self.stream is not None:
                # after every thread that publishes: followers leave follow()
                self.stream.stop()
        self.broker.close()
        self.registry.close()
        if self.costs._pressure_probe == self._cost_pressure:
            self.costs.set_pressure_probe(None)
        if self._fault_plan is not None:
            _faults.uninstall(self._fault_plan)
        if self._warmup_fault is not None:
            raise self._warmup_fault
        if faults_kept:
            raise faults_kept[0]


# ---------------------------------------------------------------------------
# Requests, responses and the executor lanes
# ---------------------------------------------------------------------------


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str] = field(default_factory=dict)
    headers: Dict[str, str] = field(default_factory=dict)  # lower-case names
    body: bytes = b""
    match: Dict[str, str] = field(default_factory=dict)  # path parameters

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip()


@dataclass
class Response:
    """A JSON ``payload`` (sent through :func:`to_wire`), or a raw
    ``body``, or server-sent ``events``."""

    status: int = 200
    payload: Any = None
    headers: Dict[str, str] = field(default_factory=dict)
    body: Optional[bytes] = None
    content_type: str = "application/json; charset=utf-8"
    events: Optional[Iterator[bytes]] = None

    def json_body(self) -> bytes:
        return json.dumps(to_wire(self.payload)).encode("utf-8")


def json_error(status: int, detail: str, ctx=None) -> Response:
    return _traced(Response(status, {"detail": detail}), ctx)


def _traced(resp: Response, ctx) -> Response:
    """Stamp the request's trace id on a response header (the body stays
    the reference's contract)."""
    if ctx is not None:
        resp.headers["X-Trace-Id"] = ctx.trace_id
    return resp


class _Lane:
    """A fixed set of named threads running submitted calls in order: one
    of the app's executor lanes.  :meth:`call` blocks for the result and
    raises the call's exception."""

    def __init__(self, name: str, workers: int) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # handed to the caller through fut
                fut.set_exception(e)

    def submit(self, fn: Callable, *args, **kw) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, functools.partial(fn, *args, **kw)))
        return fut

    def call(self, fn: Callable, *args, **kw) -> Any:
        return self.submit(fn, *args, **kw).result()

    def close(self, timeout: float = 10.0) -> bool:
        """Stop the threads once the queued calls ran; True when every
        thread ended within ``timeout`` each."""
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout)
        return not any(t.is_alive() for t in self._threads)


def _multipart_fields(content_type: str, body: bytes) -> List[Tuple[str, Optional[str], bytes]]:
    """``(field name, filename or None, raw bytes)`` of each part of a
    ``multipart/form-data`` body."""
    msg = BytesParser().parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body
    )
    if not msg.is_multipart():
        raise ValueError("malformed multipart body")
    out = []
    for part in msg.get_payload():
        name = part.get_param("name", header="content-disposition")
        out.append((name, part.get_filename(), part.get_payload(decode=True) or b""))
    return out


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------


class App:
    """The reference's route table over one runtime.  :meth:`handle` maps a
    :class:`Request` to a :class:`Response`; a device fault raises."""

    def __init__(self, rt: DocQARuntime) -> None:
        self.rt = rt
        self.device_lane = _Lane("device", 1)
        self.gen_lane = _Lane("genwait", max(rt.cfg.generate.max_concurrent, 4))
        self.host_lane = _Lane("host", 4)
        routes = [
            ("GET", "/", self.index_page),
            ("GET", "/health", self.health),
            ("GET", "/api/status", self.api_status),
            ("GET", "/metrics", self.metrics),
            ("GET", "/api/metrics", self.api_metrics),
            ("GET", "/api/telemetry", self.api_telemetry),
            ("GET", "/api/costs", self.api_costs),
            ("GET", "/api/costs/sheds", self.api_costs_sheds),
            ("GET", "/api/retrieval", self.api_retrieval),
            ("GET", "/api/traces", self.api_traces),
            ("GET", "/api/witness", self.api_witness),
            ("GET", "/api/ledger", self.api_ledger),
            ("GET", "/api/trace/{trace_id}", self.api_trace_one),
            ("GET", "/api/pool", self.api_pool),
            ("POST", "/api/pool/drain", self.api_pool_drain),
            ("POST", "/api/pool/resume", self.api_pool_resume),
            ("POST", "/api/pool/rolling_restart", self.api_pool_rolling_restart),
            ("POST", "/api/profiler/start", self.profiler_start),
            ("POST", "/api/profiler/stop", self.profiler_stop),
            ("POST", "/ingest/", self.ingest),
            ("GET", "/documents/", self.documents),
            ("GET", "/documents/{doc_id}", self.document_one),
            ("DELETE", "/documents/{doc_id}", self.document_delete),
            ("POST", "/ask/", self.ask),
            ("POST", "/ask/stream", self.ask_stream),
            ("GET", "/api/search/patient-snippets", self.patient_snippets),
            ("POST", "/api/llm/summarize", self.llm_summarize),
            ("POST", "/api/synthese/patient", self.synthese_patient),
            ("POST", "/api/synthese/comparaison", self.synthese_comparaison),
        ]
        self.routes = [
            (
                method,
                path,
                re.compile(
                    "^" + re.sub(r"\\{(\w+)\\}", r"(?P<\1>[^/]+)", re.escape(path)) + "$"
                ),
                fn,
            )
            for method, path, fn in routes
        ]

    def close(self, timeout: float = 10.0) -> bool:
        return all(
            [lane.close(timeout) for lane in (self.device_lane, self.gen_lane, self.host_lane)]
        )

    def handle(self, req: Request) -> Response:
        allowed = []
        for method, _path, pattern, fn in self.routes:
            m = pattern.match(req.path)
            if m is None:
                continue
            if method != req.method:
                allowed.append(method)
                continue
            req.match = m.groupdict()
            return fn(req)
        if allowed:
            return Response(405, {"detail": "method not allowed"})
        return Response(404, {"detail": "not found"})

    # ---- health / status --------------------------------------------------

    def index_page(self, _req: Request) -> Response:
        with open(UI_PATH, "rb") as f:
            return Response(body=f.read(), content_type="text/html")

    def health(self, _req: Request) -> Response:
        return Response(payload={"status": "ok"})

    def api_status(self, _req: Request) -> Response:
        rt = self.rt
        queues = (rt.cfg.broker.raw_queue, rt.cfg.broker.clean_queue)
        return Response(payload={
            "service": "docqa-tpu",
            "status": "running",
            "indexed_vectors": rt.store.count,
            "index_version": rt.store.version,
            "queue_depths": {q: rt.broker.depth(q) for q in queues},
            "in_flight": {q: rt.broker.in_flight(q) for q in queues},
            "dead_letters": {q: len(rt.broker.dead_letters(q)) for q in queues},
            "breakers": rt.breakers.states(),
            "pool": rt.batcher.status() if rt.batcher is not None else None,
            "slo": rt.slo.status() if rt.slo is not None else None,
            "qos": rt.batcher.qos_status() if rt.batcher is not None else None,
            "dispatch": {
                "spine": rt.spine.stats(),
                "observatory": obs.DEFAULT_OBSERVATORY.stats(),
            },
            # on a mesh only: off one, the surface is the reference's
            **({"mesh": rt.stream.status()} if rt.stream is not None else {}),
        })

    def metrics(self, req: Request) -> Response:
        """Prometheus text: 0.0.4 by default, OpenMetrics 1.0 (with
        exemplar trace ids) when the Accept header asks for it."""
        openmetrics = "application/openmetrics-text" in req.headers.get("accept", "")
        text = obs.prometheus_text(
            DEFAULT_REGISTRY, self.rt.telemetry, openmetrics=openmetrics
        )
        if openmetrics:
            return Response(
                body=text.encode("utf-8"),
                content_type="application/openmetrics-text; charset=utf-8",
                headers={"X-Prometheus-Format": "openmetrics-1.0"},
            )
        return Response(
            body=text.encode("utf-8"),
            content_type="text/plain; charset=utf-8",
            headers={"X-Prometheus-Format": "0.0.4"},
        )

    def api_metrics(self, _req: Request) -> Response:
        return Response(payload=DEFAULT_REGISTRY.snapshot())

    def api_telemetry(self, req: Request) -> Response:
        if self.rt.telemetry is None:
            return json_error(404, "telemetry disabled (telemetry.enabled)")
        return Response(payload=obs.telemetry_json(self.rt.telemetry, req.query.get("name")))

    def api_costs(self, _req: Request) -> Response:
        rt = self.rt
        spine_dev = sum(
            row.get("device_s", 0.0) for row in rt.spine.stats()["stages"].values()
        )
        pool_bs = None
        if rt.batcher is not None:
            try:
                pool_bs = rt.batcher.block_seconds()["total"]
            except Exception as e:
                if is_device_fault(e):
                    raise
        return Response(payload=rt.costs.snapshot(
            spine_device_s=spine_dev, pool_block_seconds=pool_bs
        ))

    def api_costs_sheds(self, req: Request) -> Response:
        try:
            limit = int(req.query.get("limit", "64"))
        except ValueError:
            return json_error(422, "limit must be an integer")
        if limit < 0:
            return json_error(422, "limit must be >= 0")
        return Response(payload=self.rt.costs.sheds(limit))

    def api_retrieval(self, _req: Request) -> Response:
        if not self.rt.cfg.retrieval_quality.enabled:
            return json_error(
                404, "retrieval observatory disabled (retrieval_quality.enabled)"
            )
        return Response(payload=self.rt.retrieval_status())

    # ---- decode-engine pool -----------------------------------------------

    def _pool_or_error(self) -> Tuple[Any, Optional[Response]]:
        if self.rt.batcher is None:
            return None, json_error(404, "no decode pool (fake-llm runtime)")
        return self.rt.batcher, None

    @staticmethod
    def _body_or_error(req: Request) -> Tuple[Dict[str, Any], Optional[Response]]:
        if not req.body:
            return {}, None
        try:
            body = req.json()
        except ValueError:
            return {}, json_error(422, "body must be JSON")
        if not isinstance(body, dict):
            return {}, json_error(422, "body must be JSON")
        return body, None

    def api_pool(self, _req: Request) -> Response:
        pool, err = self._pool_or_error()
        return err or Response(payload=pool.status())

    def _replica_or_error(self, pool, body) -> Optional[Response]:
        replica = body.get("replica", 0)
        if not isinstance(replica, int) or not 0 <= replica < pool.n_replicas:
            return json_error(422, f"replica must be 0..{pool.n_replicas - 1}")
        return None

    def api_pool_drain(self, req: Request) -> Response:
        """Drain one replica until ``/api/pool/resume`` (``{"replica": i,
        "timeout": s}``)."""
        pool, err = self._pool_or_error()
        if err:
            return err
        body, err = self._body_or_error(req)
        if err:
            return err
        try:
            timeout = float(body.get("timeout", 30.0))
        except (TypeError, ValueError):
            return json_error(422, "timeout must be a number")
        err = self._replica_or_error(pool, body)
        if err:
            return err
        return Response(payload=self.host_lane.call(
            pool.drain, body.get("replica", 0), timeout
        ))

    def api_pool_resume(self, req: Request) -> Response:
        pool, err = self._pool_or_error()
        if err:
            return err
        body, err = self._body_or_error(req)
        if err:
            return err
        err = self._replica_or_error(pool, body)
        if err:
            return err
        return Response(payload=self.host_lane.call(
            pool.resume, body.get("replica", 0), bool(body.get("rebuild", False))
        ))

    def api_pool_rolling_restart(self, req: Request) -> Response:
        """Drain, rebuild and resume every replica in turn."""
        pool, err = self._pool_or_error()
        if err:
            return err
        body, _err = self._body_or_error(req)
        try:
            timeout = float(body.get("timeout_per_replica", 30.0))
        except (TypeError, ValueError):
            timeout = 30.0
        return Response(payload=self.host_lane.call(pool.rolling_restart, timeout))

    # ---- observability ----------------------------------------------------

    def api_traces(self, req: Request) -> Response:
        anomalous = req.query.get("anomalous") in ("1", "true")
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            return json_error(422, "limit must be an integer")
        return Response(payload=obs.DEFAULT_RECORDER.summaries(n=limit, anomalous=anomalous))

    def api_witness(self, _req: Request) -> Response:
        """The lock witness's dump (locks seen, witnessed edges, held-lock
        blocking events, cycles, and the cross-check against the static
        acquisition graph).  404 unless the process booted with
        ``DOCQA_RACE_WITNESS=1``: the witness wraps locks at creation, so
        it cannot be enabled after boot."""
        from docqa_tpu_torch.analysis.race_witness import witness_snapshot

        snap = witness_snapshot()
        if snap is None:
            return json_error(404, "witness not installed (boot with DOCQA_RACE_WITNESS=1)")
        return Response(payload=snap)

    def api_ledger(self, _req: Request) -> Response:
        """The resource-ledger witness's live dump (table and record counts,
        live entries, witnessed call sites, the witnessed-⊆-static check).
        While serving, ``leaked_tables`` / ``unretired_records`` list work
        in flight; they are leaks only at quiesce.  404 unless booted with
        ``DOCQA_LEDGER_WITNESS=1``."""
        from docqa_tpu_torch.analysis.ledger_audit import ledger_snapshot

        snap = ledger_snapshot()
        if snap is None:
            return json_error(
                404, "ledger witness not installed (boot with DOCQA_LEDGER_WITNESS=1)"
            )
        return Response(payload=snap)

    def api_trace_one(self, req: Request) -> Response:
        trace = obs.DEFAULT_RECORDER.get(req.match["trace_id"])
        if trace is None:
            return json_error(404, "trace not found (evicted or unknown)")
        if req.query.get("format") == "chrome":
            return Response(payload=obs.to_chrome_trace([trace]))
        return Response(payload=obs.timeline_dict(trace))

    def profiler_start(self, req: Request) -> Response:
        """Open a ``torch.profiler`` window (``{"logdir": ...}``)."""
        body, _err = self._body_or_error(req)
        try:
            logdir = self.host_lane.call(
                obs.DEFAULT_PROFILER.start, body.get("logdir"), self.rt.device
            )
        except RuntimeError as e:  # a window is already open
            if is_device_fault(e):
                raise
            return json_error(409, str(e))
        except Exception as e:
            if is_device_fault(e):
                raise
            return json_error(500, f"profiler start failed: {e!r}")
        return Response(payload={"profiling": True, "logdir": logdir})

    def profiler_stop(self, _req: Request) -> Response:
        try:
            logdir = self.host_lane.call(obs.DEFAULT_PROFILER.stop)
        except RuntimeError as e:  # no window open
            if is_device_fault(e):
                raise
            return json_error(409, str(e))
        except Exception as e:
            if is_device_fault(e):
                raise
            return json_error(500, f"profiler stop failed: {e!r}")
        return Response(payload={"profiling": False, "logdir": logdir})

    # ---- ingestion --------------------------------------------------------

    def ingest(self, req: Request) -> Response:
        """Multipart (``file`` plus ``doc_type`` / ``patient_id`` /
        ``doc_date`` form fields) or JSON ``{filename, text, ...}``;
        ``?wait=1`` waits for the document's terminal status."""
        rt = self.rt
        filename, data = None, None
        form: Dict[str, Optional[str]] = {}
        wait = req.query.get("wait") in ("1", "true")
        if req.content_type.startswith("multipart/"):
            try:
                parts = _multipart_fields(req.headers["content-type"], req.body)
            except (KeyError, ValueError) as e:
                return json_error(400, f"malformed multipart body: {e}")
            for name, part_filename, raw in parts:
                if name == "file":
                    filename = part_filename or "upload"
                    data = raw
                elif name in ("doc_type", "patient_id", "doc_date"):
                    form[name] = raw.decode("utf-8").strip() or None
        else:
            body = req.json()
            filename = body.get("filename", "inline.txt")
            data = body.get("text", "").encode()
            for name in ("doc_type", "patient_id", "doc_date"):
                form[name] = body.get(name)
        if not data:
            return json_error(400, "no file/text provided")
        # the document's trace, finished by the pipeline at its terminal
        # status
        ctx = obs.new_trace("ingest")
        obs.cost_open(ctx, "background")
        try:
            record = self.host_lane.call(
                obs.call_in, ctx, rt.pipeline.ingest_document, filename, data,
                form.get("doc_type"), form.get("patient_id"), form.get("doc_date"),
            )
        except BaseException:
            obs.finish(ctx, status="error")
            raise
        if wait:
            rt.pipeline.wait_indexed(record.doc_id)
            record = rt.registry.get(record.doc_id)
        return _traced(
            Response(payload={"doc_id": record.doc_id, "status": record.status}), ctx
        )

    def documents(self, _req: Request) -> Response:
        return Response(payload=[r.to_dict() for r in self.rt.registry.list_documents()])

    def document_one(self, req: Request) -> Response:
        rec = self.rt.registry.get(req.match["doc_id"])
        if rec is None:
            return json_error(404, "document not found")
        return Response(payload=rec.to_dict())

    def document_delete(self, req: Request) -> Response:
        doc_id = req.match["doc_id"]
        if self.rt.registry.get(doc_id) is None:
            return json_error(404, "document not found")
        erase = req.query.get("erase") in ("1", "true")
        # the device lane: tombstoning races with appends and searches
        n = self.device_lane.call(self.rt.delete_document, doc_id, erase)
        return Response(payload={"doc_id": doc_id, "chunks_removed": n, "erased": erase})

    # ---- QA ---------------------------------------------------------------

    def _ask_preamble(self, req: Request, ctx) -> Tuple[Any, Optional[Response]]:
        """Shared /ask admission: parse -> 422, empty index -> 503,
        submission on the device lane -> QueueFull 503, budget gone -> 504.
        The request's deadline is stamped here and rides retrieval, the
        pool and the batcher."""
        try:
            q = Query.from_json(req.json())
        except ValueError as e:
            return None, json_error(422, str(e), ctx)
        rt = self.rt
        if rt.store.count == 0:
            return None, json_error(503, "index is empty; ingest documents first", ctx)
        budget = rt.cfg.resilience.request_deadline_s
        deadline = Deadline.after(budget) if budget > 0 else None
        try:
            pending = self.device_lane.call(
                obs.call_in, ctx, rt.qa.ask_submit, q.question, deadline=deadline
            )
        except QueueFull as e:
            return None, json_error(503, str(e), ctx)
        except DeadlineExceeded as e:
            DEFAULT_REGISTRY.counter("qa_deadline_shed").inc()
            return None, json_error(504, str(e), ctx)
        return pending, None

    @staticmethod
    def _ask_outcome(status: int) -> None:
        """SLO accounting: every /ask admission is a request; a 5xx spends
        the availability budget."""
        DEFAULT_REGISTRY.counter("ask_requests").inc()
        if status >= 500:
            DEFAULT_REGISTRY.counter("ask_failures").inc()

    def ask(self, req: Request) -> Response:
        # retrieval and submission on the device lane, the decode wait on
        # the wait lane, so concurrent /ask share the batcher's slots
        t0 = time.perf_counter()
        ctx = obs.new_trace("ask")
        obs.cost_open(ctx, "interactive")
        try:
            pending, err = self._ask_preamble(req, ctx)
            if err is not None:
                obs.finish(ctx, status="error")
                self._ask_outcome(err.status)
                return err
            try:
                result = self.gen_lane.call(obs.call_in, ctx, pending.resolve)
            except DeadlineExceeded as e:
                DEFAULT_REGISTRY.counter("qa_deadline_shed").inc()
                obs.finish(ctx, status="error")
                self._ask_outcome(504)
                return json_error(504, str(e), ctx)
            DEFAULT_REGISTRY.histogram("qa_e2e_ms").observe(
                (time.perf_counter() - t0) * 1000,
                trace_id=ctx.trace_id if ctx else None,
            )
            obs.finish(ctx)
            self._ask_outcome(200)
            return _traced(Response(payload=result), ctx)
        except BaseException:
            obs.finish(ctx, status="error")
            self._ask_outcome(500)
            raise

    def ask_stream(self, req: Request) -> Response:
        """Server-sent events: one ``data: {"delta": ...}`` event per text
        delta as the decode lands, then ``event: done`` with the sources
        (or ``event: error``).  A device fault ends the stream by raising."""
        t0 = time.perf_counter()
        ctx = obs.new_trace("ask_stream")
        obs.cost_open(ctx, "interactive")
        pending, err = self._ask_preamble(req, ctx)
        if err is not None:
            obs.finish(ctx, status="error")
            self._ask_outcome(err.status)
            return err
        # the stream commits to a 200 here; decode failures become error
        # events, so availability is accounted at admission
        self._ask_outcome(200)
        deltas: "queue.Queue" = queue.Queue()
        gone = threading.Event()  # the client is gone: stop pumping

        def pump():
            try:
                for delta in pending.iter_text():
                    if gone.is_set():
                        return  # the batcher slot retires on its own budget
                    deltas.put(("d", delta))
                deltas.put(("end", None))
            except BaseException as e:  # an error event, or a device fault
                deltas.put(("err", e))

        def events() -> Iterator[bytes]:
            self.gen_lane.submit(pump)
            try:
                while True:
                    kind, payload = deltas.get()
                    if kind == "d":
                        yield b"data: " + json.dumps({"delta": payload}).encode() + b"\n\n"
                    elif kind == "err":
                        if is_device_fault(payload):
                            raise payload
                        yield (
                            b"event: error\ndata: "
                            + json.dumps({"detail": str(payload)}).encode() + b"\n\n"
                        )
                        return
                    else:
                        yield (
                            b"event: done\ndata: "
                            + json.dumps({"sources": pending.sources}).encode() + b"\n\n"
                        )
                        return
            finally:
                gone.set()
                DEFAULT_REGISTRY.histogram("qa_e2e_ms").observe(
                    (time.perf_counter() - t0) * 1000,
                    trace_id=ctx.trace_id if ctx else None,
                )
                obs.finish(ctx)

        return _traced(Response(
            headers={"Cache-Control": "no-cache"},
            content_type="text/event-stream",
            events=events(),
        ), ctx)

    def patient_snippets(self, req: Request) -> Response:
        pid = req.query.get("patient_id")
        if not pid:
            return json_error(422, "patient_id is required")
        try:
            rows = self.device_lane.call(
                self.rt.qa.patient_snippets, pid, req.query.get("from_date"),
                req.query.get("to_date"), req.query.get("focus"),
            )
        except ValueError as e:  # a malformed date bound
            return json_error(422, str(e))
        return Response(payload=rows)

    def llm_summarize(self, req: Request) -> Response:
        try:
            body = SummarizeRequest.from_json(req.json())
        except ValueError as e:
            return json_error(422, str(e))
        rt = self.rt
        t0 = time.perf_counter()
        ctx = obs.new_trace("summarize")
        obs.cost_open(ctx, "batch")
        try:
            pending = self.device_lane.call(
                obs.call_in, ctx, rt.summarizer.submit_prompt, body.prompt,
                body.max_tokens,
            )
        except QueueFull as e:
            obs.finish(ctx, status="error")
            return json_error(503, str(e), ctx)
        try:
            summary = self.gen_lane.call(obs.call_in, ctx, rt.summarizer.resolve, pending)
        except BaseException:
            obs.finish(ctx, status="error")
            raise
        if rt.batcher is not None:
            DEFAULT_REGISTRY.histogram("summarize_ms").observe(
                (time.perf_counter() - t0) * 1000,
                trace_id=ctx.trace_id if ctx else None,
            )
        obs.finish(ctx)
        return _traced(Response(payload={"summary": summary}), ctx)

    def _synthesis(self, name: str, submit: Callable, *args) -> Response:
        """Retrieval and packing on the device lane, the decode wait on the
        wait lane."""
        ctx = obs.new_trace(name)
        obs.cost_open(ctx, "batch")
        try:
            finish = self.device_lane.call(obs.call_in, ctx, submit, *args)
        except SynthesisError as e:
            obs.finish(ctx, status="error")
            return json_error(e.status, e.detail, ctx)
        except QueueFull as e:
            obs.finish(ctx, status="error")
            return json_error(503, str(e), ctx)
        try:
            resp = self.gen_lane.call(obs.call_in, ctx, finish)
        except BaseException:
            obs.finish(ctx, status="error")
            raise
        obs.finish(ctx)
        return _traced(Response(payload=resp.to_dict()), ctx)

    def synthese_patient(self, req: Request) -> Response:
        try:
            body = PatientSummaryRequest.from_json(req.json())
        except ValueError as e:
            return json_error(422, str(e))
        return self._synthesis(
            "synthese_patient", self.rt.synthesis.patient_summary_submit,
            body.patient_id, body.from_date, body.to_date, body.focus,
        )

    def synthese_comparaison(self, req: Request) -> Response:
        try:
            body = PatientComparisonRequest.from_json(req.json())
        except ValueError as e:
            return json_error(422, str(e))
        return self._synthesis(
            "synthese_comparaison", self.rt.synthesis.patient_comparison_submit,
            body.patient_ids, body.focus,
        )


def make_app(rt: DocQARuntime) -> App:
    return App(rt)


# ---------------------------------------------------------------------------
# The HTTP front
# ---------------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server: "AppServer"
    server_version = "docqa-torch"

    def setup(self) -> None:
        # the connection's socket timeout (service.request_timeout_s)
        self.timeout = self.server.request_timeout_s
        super().setup()

    def log_message(self, format, *args):  # noqa: A002 (the stdlib's name)
        log.debug("%s - %s", self.address_string(), format % args)

    def _dispatch(self, method: str) -> None:
        url = urllib.parse.urlsplit(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY:
            self._send(Response(413, {"detail": "request body too large"}))
            return
        body = self.rfile.read(length) if length else b""
        req = Request(
            method=method,
            path=url.path,
            query={k: v[0] for k, v in urllib.parse.parse_qs(url.query).items()},
            headers={k.lower(): v for k, v in self.headers.items()},
            body=body,
        )
        try:
            resp = self.server.app.handle(req)
        except Exception as e:
            if isinstance(e, MeshFault):
                # a rank is gone: answer 503 at once, then stop serving
                self._send(Response(503, {"detail": f"mesh lost: {e}"}))
                self.server.on_device_fault(e)
                return
            if is_device_fault(e):
                self.server.on_device_fault(e)
                return  # no response: the connection closes
            log.exception("%s %s failed", method, url.path)
            resp = Response(500, {"detail": f"internal error: {e!r}"})
        self._send(resp)

    def _send(self, resp: Response) -> None:
        body = None
        if resp.events is None:
            body = resp.body if resp.body is not None else resp.json_body()
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        for name, value in resp.headers.items():
            self.send_header(name, value)
        if body is not None:
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.end_headers()
        events = resp.events
        try:
            for event in events:
                self.wfile.write(event)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client left; closing the iterator stops the pump
        except Exception as e:
            if not is_device_fault(e):
                raise
            self.server.on_device_fault(e)
        finally:
            events.close()

    def do_GET(self):  # noqa: N802 (the stdlib's names)
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")


class AppServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` over an :class:`App`: one thread a request.
    :meth:`start` serves from a background thread; :meth:`close` stops
    serving and joins the server's threads and the app's lanes, each with
    a bound.  ``fault`` holds the device fault that stopped it, if any.
    ``request_timeout_s`` is each connection's socket timeout (None: no
    timeout; :func:`serve` passes ``service.request_timeout_s``)."""

    daemon_threads = True

    def __init__(
        self,
        app: App,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: Optional[float] = None,
    ) -> None:
        super().__init__((host, port), _Handler)
        self.app = app
        self.request_timeout_s = request_timeout_s
        self.fault: Optional[BaseException] = None
        self._threads_lock = threading.Lock()
        self._request_threads: List[threading.Thread] = []
        self._serve_thread: Optional[threading.Thread] = None
        self._shutdown_thread: Optional[threading.Thread] = None
        self._serving = threading.Event()

    @property
    def port(self) -> int:
        return self.server_address[1]

    def process_request(self, request, client_address):
        t = threading.Thread(
            target=self.process_request_thread, args=(request, client_address),
            name="http-request", daemon=True,
        )
        with self._threads_lock:
            self._request_threads = [x for x in self._request_threads if x.is_alive()]
            self._request_threads.append(t)
        t.start()

    def on_device_fault(self, exc: BaseException) -> None:
        """Keep the first fault and stop serving (from a helper thread:
        ``shutdown`` waits for the serving loop)."""
        with self._threads_lock:
            if self.fault is None:
                self.fault = exc
        log.error("device fault in a handler; the server stops: %r", exc)
        if self._serving.is_set():
            t = threading.Thread(target=self.shutdown, name="http-shutdown", daemon=True)
            with self._threads_lock:
                if self._shutdown_thread is not None:
                    return
                self._shutdown_thread = t
            t.start()

    def serve_forever(self, poll_interval: float = 0.05) -> None:
        self._serving.set()
        try:
            super().serve_forever(poll_interval)
        finally:
            self._serving.clear()

    def start(self) -> "AppServer":
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="http-serve", daemon=True
        )
        self._serve_thread.start()
        return self

    def close(self, timeout: float = 10.0) -> bool:
        """Stop, close the socket, and join; True when every thread ended."""
        if self._serve_thread is not None and self._serve_thread.is_alive():
            self.shutdown()
            self._serve_thread.join(timeout)
        self.server_close()
        with self._threads_lock:
            threads = list(self._request_threads)
            shutdown_thread = self._shutdown_thread
        if shutdown_thread is not None:
            shutdown_thread.join(timeout)
        for t in threads:
            t.join(timeout)
        lanes_done = self.app.close(timeout)
        alive = [t for t in threads if t.is_alive()]
        for t in (shutdown_thread, self._serve_thread):
            if t is not None and t.is_alive():
                alive.append(t)
        return lanes_done and not alive


def serve(
    cfg: Optional[Config] = None,
    port: Optional[int] = None,
    host: Optional[str] = None,
    device="cuda",
    decoder_params=None,
) -> None:
    """Boot the runtime and serve until interrupted (``ingest_port`` on
    ``service.host`` unless given); a device fault in a handler stops the
    server and is re-raised here."""
    rt = DocQARuntime(cfg, device=device, decoder_params=decoder_params).start()
    server = None
    try:
        server = AppServer(
            make_app(rt),
            host=host if host is not None else rt.cfg.service.host,
            port=port if port is not None else rt.cfg.service.ingest_port,
            request_timeout_s=rt.cfg.service.request_timeout_s,
        )
        log.info("serving on %s:%d", *server.server_address[:2])
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        if server is not None:
            server.close()
        rt.stop()
    if server.fault is not None:
        raise server.fault


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Serve the DocQA app (the PyTorch port) over HTTP."
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--host", default=None, help="bind address (service.host)")
    p.add_argument("--port", type=int, default=None,
                   help="port (service.ingest_port); 0 picks a free one")
    p.add_argument("--set", action="append", default=[], metavar="SECTION.FIELD=VALUE",
                   help="config override, after the DOCQA_* environment overlay")
    p.add_argument("--decoder", choices=("default", "mistral-7b"), default="default",
                   help="decoder width preset (mistral-7b: DecoderConfig.mistral_7b())")
    return p.parse_args(argv)


def config_from_args(args) -> Config:
    """The config ``main`` serves: defaults, the environment overlay, the
    decoder preset, then each ``--set``."""
    import dataclasses

    from docqa_tpu_torch.config import DecoderConfig

    cfg = load_config()
    if args.decoder == "mistral-7b":
        cfg = dataclasses.replace(cfg, decoder=DecoderConfig.mistral_7b())
    for item in args.set:
        path, sep, raw = item.partition("=")
        section, _, name = path.partition(".")
        if not sep or not name:
            raise SystemExit(f"--set expects SECTION.FIELD=VALUE, got {item!r}")
        part = getattr(cfg, section)
        current = getattr(part, name)
        value = coerce_value(raw, type(current) if current is not None else object)
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(part, **{name: value})}
        )
    return cfg


def main(argv=None) -> None:
    """Serve under the arguments; under torchrun's environment (a world of
    ``WORLD_SIZE`` ranks, :func:`~docqa_tpu_torch.runtime.mesh.multihost_init`)
    rank 0 serves on ``--port`` and every other rank follows it, and the
    process group is destroyed on every rank at the end."""
    # the lock witness at process entry (run as `python -m`, the module's
    # own first statements installed it before its imports)
    from docqa_tpu_torch.analysis import race_witness

    race_witness.maybe_install_from_env()
    import torch.distributed as dist

    from docqa_tpu_torch.runtime.mesh import multihost_init

    args = _parse_args(argv)
    cfg = config_from_args(args)
    on_mesh = multihost_init(device=args.device)
    try:
        _serve_main(args, cfg, on_mesh and dist.get_rank() != 0)
    finally:
        if on_mesh and dist.is_initialized():
            dist.destroy_process_group()


def _serve_main(args, cfg: Config, follower: bool) -> None:
    # random decoder weights drawn on the device from a seed: the
    # reference's host init takes minutes at full width; a quantised
    # decoder is quantised tensor by tensor as it is drawn
    from docqa_tpu_torch.models.decoder import init_decoder_params
    from docqa_tpu_torch.models.quant import init_quantized_decoder_params

    params = None
    if not cfg.decoder.checkpoint_dir:
        dev = resolve_device(args.device)
        params = (
            init_quantized_decoder_params(cfg.decoder, 0, dev, bits=cfg.decoder.quant_bits)
            if cfg.decoder.quantize_weights
            else init_decoder_params(cfg.decoder, seed=0, device=dev)
        )
    # SIGTERM stops the server like Ctrl-C, so the runtime joins its workers
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    if follower:
        rt = DocQARuntime(cfg, device=args.device, decoder_params=params)
        try:
            rt.follow()
        finally:
            rt.stop()
        return
    serve(cfg, port=args.port, host=args.host, device=args.device, decoder_params=params)


if __name__ == "__main__":
    main()
