#!/usr/bin/env python3
"""Where the time of one /ask goes on the card, for the PyTorch/CUDA port.

    python3 scripts/torch_ask_profile.py [--out PATH] [--batcher | --pool N,M | --ingest]

Builds the same full-width service as ``chip_smoke.py`` (MiniLM-L6
encoder, 1,000,000-row bf16 store, Mistral-7B-width bf16 decoder with
random seeded weights, greedy, K=4 speculation), answers one warm-up
question, then answers each question under ``torch.profiler`` and reports
per question: wall time, device busy time (union of kernel intervals) and
idle share, kernel launches, and device time by kernel family and by
kernel name.  With ``--batcher`` the service goes through
``chip_smoke.py`` phase 5's ``ContinuousBatcher`` instead, and one round
of eight concurrent questions is profiled as a whole (plus device and
wall time per verify step).  With ``--pool 1,2`` it goes through
``chip_smoke.py`` phase 6's ``EnginePool`` (16 slots a replica) at each
replica count in turn and profiles one round of sixteen concurrent
questions per count.  With ``--ingest`` it profiles one round of 64
uploads through ``chip_smoke.py`` phase 7's ``DocumentPipeline`` (NER
tagger at full width, the same encoder and store), after a warm-up round
of 16, and reports K1's share of the device time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    QUESTIONS, _ask_round, build_main_path, ingest_corpus, nvidia_smi_line,
)
from docqa_tpu_torch.config import (  # noqa: E402
    Config, NERConfig, PoolConfig, QoSConfig,
)
from docqa_tpu_torch.deid.engine import DeidEngine  # noqa: E402
from docqa_tpu_torch.engines.pool import EnginePool  # noqa: E402
from docqa_tpu_torch.engines.serve import ContinuousBatcher  # noqa: E402
from docqa_tpu_torch.models.ner import init_ner_params  # noqa: E402
from docqa_tpu_torch.ops import _kernels  # noqa: E402
from docqa_tpu_torch.service.broker import make_broker  # noqa: E402
from docqa_tpu_torch.service.pipeline import DocumentPipeline  # noqa: E402
from docqa_tpu_torch.service.qa import QAService  # noqa: E402
from docqa_tpu_torch.service.registry import DocumentRegistry  # noqa: E402


def family(name: str) -> str:
    """Coarse kernel family from its (mangled) name."""
    low = name.lower()
    if "flash_" in name and "kernel" in name:
        # every kernel of csrc/flash_attention.cu: K1's decode, combine,
        # prefill and SIMT kernels
        return "flash_attention (port kernel)"
    if any(t in low for t in ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas", "splitk")):
        return "matmul (cuBLAS)"
    if "topk" in low or "sort" in low or "radix" in low:
        return "top-k / sort"
    if "reduce" in low:
        return "reductions"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "elementwise" in low or "vectorized" in low or "fill" in low:
        return "elementwise"
    return "other"


def busy_us(intervals):
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def analyse(prof, wall_us):
    """Device busy time, idle share and time by kernel family / K1 kernel /
    name for one profiled window of ``wall_us`` microseconds."""
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_family = defaultdict(float), defaultdict(float)
    counts, k1 = defaultdict(int), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        dur = e.time_range.elapsed_us()
        by_name[e.name] += dur
        by_family[family(e.name)] += dur
        counts[family(e.name)] += 1
        if family(e.name).startswith("flash_attention"):
            short = re.search(r"flash_\w+?_kernel", e.name).group(0)
            k1[short][0] += dur
            k1[short][1] += 1
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if kernels else None,
        "kernel_launches": len(kernels),
        "by_family_ms": {
            k: {"ms": v / 1e3, "launches": counts[k]}
            for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])
        },
        "k1_by_kernel": {
            k: {"ms": v[0] / 1e3, "launches": v[1]} for k, v in sorted(k1.items())
        },
        "top_kernels_ms": {
            k[:120]: v / 1e3
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        },
    }


def print_breakdown(rec):
    for fam, v in rec["by_family_ms"].items():
        print(f"    {fam:32s} {v['ms']:9.3f} ms  {v['launches']:6d} launches")
    for kern, v in rec["k1_by_kernel"].items():
        print(f"      K1 {kern:29s} {v['ms']:9.3f} ms  {v['launches']:6d} launches")


def profile_batcher(qa_solo):
    """One round of eight concurrent /ask through phase 5's batcher, after
    one warm-up round."""
    gen = qa_solo.generator
    batcher = ContinuousBatcher(gen, n_slots=8, chunk=16, cache_len=1024,
                                kv_block_size=16, prefix_cache=True)
    try:
        qa = QAService(qa_solo.retriever.encoder, qa_solo.retriever.store, gen,
                       k=3, device=gen.device, batcher=batcher)
        batcher.warmup()
        _ask_round(qa, ["question de préchauffage sur le patient P001"])
        torch.cuda.synchronize()
        before = dict(batcher.stats)
        # device activity only: recording the worker's CPU ops would slow
        # the host that bounds the batcher
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _ask_round(qa, list(QUESTIONS) * 2)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rec = analyse(prof, wall_us)
        done = {k: v - before.get(k, 0) for k, v in batcher.stats.items()}
        steps = done.get("verify_steps", 0)
        rec.update(mode="batcher", requests=8, batcher_stats=done,
                   ms_per_verify_step=rec["wall_ms"] / max(steps, 1),
                   device_ms_per_verify_step=rec["device_busy_ms"] / max(steps, 1),
                   launches_per_verify_step=rec["kernel_launches"] / max(steps, 1))
    finally:
        batcher.stop()
    print(f"batcher round of 8 /ask: wall {rec['wall_ms']:.1f} ms, device busy "
          f"{rec['device_busy_ms']:.1f} ms (idle share {rec['device_idle_share']}), "
          f"{rec['kernel_launches']} kernels, {steps} verify steps: "
          f"{rec['ms_per_verify_step']:.2f} ms wall and "
          f"{rec['device_ms_per_verify_step']:.2f} ms device a step, "
          f"{rec['launches_per_verify_step']:.0f} kernels a step", flush=True)
    print_breakdown(rec)
    return rec


def profile_pool(qa_solo, replicas):
    """One round of sixteen concurrent /ask through phase 6's pool with
    ``replicas`` replicas of 16 slots, after one warm-up round."""
    gen = qa_solo.generator
    pool = EnginePool(gen, cfg=PoolConfig(replicas=replicas, n_slots=16),
                      qos=QoSConfig(), chunk=16, cache_len=1024, device=gen.device)
    try:
        qa = QAService(qa_solo.retriever.encoder, qa_solo.retriever.store, gen,
                       k=3, device=gen.device, batcher=pool)
        _ask_round(qa, ["question de préchauffage sur le patient P001"])
        torch.cuda.synchronize()
        before = pool.stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _ask_round(qa, list(QUESTIONS) * 4)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rec = analyse(prof, wall_us)
        done = dict(pool.stats() - before)
        steps = done.get("verify_steps", 0)
        # replicas step concurrently: a replica's step takes wall / (its steps)
        rec.update(mode="pool", replicas=replicas, requests=16, pool_stats=done,
                   wall_ms_per_replica_step=rec["wall_ms"] * replicas / max(steps, 1),
                   device_ms_per_verify_step=rec["device_busy_ms"] / max(steps, 1),
                   launches_per_verify_step=rec["kernel_launches"] / max(steps, 1))
    finally:
        pool.stop()
    print(f"pool of {replicas} replica(s), round of 16 /ask: wall {rec['wall_ms']:.1f} ms, "
          f"device busy {rec['device_busy_ms']:.1f} ms (idle share "
          f"{rec['device_idle_share']}), {rec['kernel_launches']} kernels, {steps} verify "
          f"steps: {rec['wall_ms_per_replica_step']:.2f} ms wall a replica step, "
          f"{rec['device_ms_per_verify_step']:.2f} ms device a step", flush=True)
    print_breakdown(rec)
    return rec


def profile_ingest(qa_solo, n_docs=64):
    """One round of ``n_docs`` uploads through phase 7's pipeline (seeded
    random tagger at ``NERConfig()``, phase 3's encoder and store), timed
    from the first upload to the last INDEXED, after a warm-up round."""
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    ner_cfg = NERConfig()
    deid = DeidEngine(ner_cfg, params=init_ner_params(ner_cfg, seed=11),
                      device=encoder.device)
    cfg = Config(encoder=encoder.cfg, ner=ner_cfg, store=store.cfg)
    pipe = DocumentPipeline(cfg, make_broker(cfg.broker), DocumentRegistry("sqlite://"),
                            deid, encoder, store)
    rng = np.random.default_rng(2025)
    warm, docs = ingest_corpus(rng, 16, "warm"), ingest_corpus(rng, n_docs, "profiled")

    def ingest(batch):
        ids = [pipe.ingest_document(d["filename"], d["data"]).doc_id for d in batch]
        for doc_id in ids:
            if not pipe.wait_indexed(doc_id, timeout=300):
                raise RuntimeError(f"{doc_id} not INDEXED")

    pipe.start()
    try:
        ingest(warm)
        torch.cuda.synchronize()
        nf, ne, rows = deid.forwards, encoder.forwards, store.count
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ingest(docs)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        pipe.stop()
    rec = analyse(prof, wall_us)
    k1_ms = sum(v["ms"] for v in rec["k1_by_kernel"].values())
    rec.update(mode="ingest", docs=n_docs, chunks=store.count - rows,
               docs_per_s=n_docs / (wall_us / 1e6),
               tagger_forwards=deid.forwards - nf, encoder_forwards=encoder.forwards - ne,
               k1_ms=k1_ms, k1_share_of_busy=k1_ms / max(rec["device_busy_ms"], 1e-9))
    print(f"ingest round of {n_docs} uploads ({rec['chunks']} chunks): wall "
          f"{rec['wall_ms']:.1f} ms = {rec['docs_per_s']:.1f} docs/s, device busy "
          f"{rec['device_busy_ms']:.1f} ms (idle share {rec['device_idle_share']}), "
          f"{rec['kernel_launches']} kernels, {rec['tagger_forwards']} tagger + "
          f"{rec['encoder_forwards']} encoder forwards; K1 {k1_ms:.3f} ms = "
          f"{100 * rec['k1_share_of_busy']:.1f} % of the busy time", flush=True)
    print_breakdown(rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--batcher", action="store_true",
                    help="profile a round of eight /ask through the batcher")
    ap.add_argument("--pool", default=None, metavar="COUNTS",
                    help="profile a round of sixteen /ask through a pool of each "
                         "comma-separated replica count")
    ap.add_argument("--ingest", action="store_true",
                    help="profile a round of 64 uploads through the ingest pipeline")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ask_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    _kernels.build()
    qa, _, _ = build_main_path(_kernels.LAUNCHES)
    report = {"card": smi, "questions": []}
    if args.ingest:
        report["ingest_round"] = profile_ingest(qa)
    elif args.pool:
        report["pool_rounds"] = [profile_pool(qa, int(n)) for n in args.pool.split(",")]
    elif args.batcher:
        report["batcher_round"] = profile_batcher(qa)
    else:
        qa.ask("question de préchauffage sur le patient P001")  # warm-up
        torch.cuda.synchronize()
        for question in QUESTIONS:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                qa.ask(question)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            rec = analyse(prof, wall_us)
            st = qa.generator.last_stats
            rec.update(question=question, decoder_forwards=st["forwards"],
                       decode_tokens=st["decode_tokens"])
            report["questions"].append(rec)
            print(f"{question!r}: wall {rec['wall_ms']:.1f} ms, device busy "
                  f"{rec['device_busy_ms']:.1f} ms (idle share "
                  f"{rec['device_idle_share']}), {rec['kernel_launches']} kernels, "
                  f"{st['forwards']} decoder forwards", flush=True)
            print_breakdown(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
