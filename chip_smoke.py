#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (docqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each of which fails the run on any error (nothing is caught):

1. build: print the card's name and power limit, build every CUDA kernel
   from ``docqa_tpu_torch/csrc`` (one nvcc per source, started together)
   and print each kernel's registers and spills.
2. kernels: call the flash wrapper on the card at the shapes the /ask path
   gives it and at a 4K-token prompt, hold the result against the plain
   PyTorch version on the same inputs (bf16: the decode or prefill
   tensor-core path; float32: the SIMT path), and time the kernel, the
   first port's SIMT kernel on the same bf16 inputs, the plain version,
   the library yardstick (masked, and over the live slice where that is
   expressible) and the roofline bound.  K1's paged mode (the batcher's
   verify step through a block table: 8 and 16 lanes, K=4, shuffled blocks
   with holes, idle lanes) is held against its plain version too, and
   timed beside gather + masked SDPA and the reference's TPU route, gather
   + K1's contiguous decode path.  The NER tagger's window batches (32
   windows, and the pipeline's 8, of up to 512 rows, 8 heads of 32) are
   prefill cases.
3. main path: /ask end to end through ``QAService.ask`` at full width —
   MiniLM-L6 encoder, a 1,000,000-row bf16 store, Mistral-7B-width decoder
   in bf16 with random seeded weights, greedy with K=4 speculation — with
   the launch counters reset just before and read just after; every verify
   step must go through the split-kv kernel, every prefill and encoder
   call through the wgmma kernel.
4. reference: the same path at a tiny float32 width on the card (kernels)
   and on the CPU (plain versions) must give the same answers.
5. main path through the continuous batcher: phase 3's service rewired to
   a ``ContinuousBatcher`` (8 slots, paged KV pool, prefix cache, K=4);
   two rounds of eight concurrent /ask; every verify step's attention on
   K1's paged mode (launches = 32 layers x verify steps), at least one
   warm prefix admission, no leaked block after the drain; one prompt
   submitted alone gives first-step logits (taken from the batcher's own
   prefill dispatch) within ``FIRST_STEP_RTOL`` of the solo engine's, and
   the batcher delivers their argmax.
6. main path through the replica pool: phase 3's service over
   ``EnginePool(PoolConfig(replicas=2, n_slots=16), QoSConfig())`` with the
   decoder breaker and ``ResilienceConfig`` (every /ask under a 60 s
   deadline).  A1 (reported): round A's asks through one replica.  Two
   prompts at once, one on each replica, give first-step logits within
   ``FIRST_STEP_RTOL`` of solo's.  A: 16 concurrent /ask, none degraded,
   both replicas routed, decode_paged launches = 32 x the pool's verify
   steps, blocks after the drain = the prefix caches' pins.  B: a worker crash injected mid-round;
   every answer generated or degraded ``replica_died``, no waiter hangs,
   the replica rebuilt healthy within ``REBUILD_LIMIT_S``, reserved memory
   within one replica pool.  C: a rolling restart under 8 /ask drops and
   degrades nothing.  D: a 1-replica pool with preemption on, sized to hold
   eight batch requests, takes four interactive /ask: at least one
   preemption, nothing degraded, every batch request completes with its
   earlier tokens kept, no block leaked.  E: a decoder outage degrades
   ``decoder_error`` until the breaker trips, then ``decoder_breaker_open``;
   after the outage and the breaker's reset a plain answer comes back.
7. ingest: ``DocumentPipeline`` over phase 3's encoder and store with the
   NER tagger at ``NERConfig()`` (bf16, seeded random weights), the
   in-memory broker and a SQLite registry.  512 generated notes (8 .docx,
   8 .pdf) with header PHI go up; each reaches INDEXED; the registry's
   chunk counts, the store's new rows and ``chunk_text`` over the masked
   texts agree; no header phone, email or date reaches the store.  The
   tagger batches the deid worker served are tapped: those of its most
   served shape (8 windows x 512), until they hold 64 documents, give the
   same masked texts as the port on the CPU in float32 (the regexes'
   spans; the random tagger's stay under the 0.8 threshold on both), and
   their served logits, like those of one 32-window batch, are within
   ``FIRST_STEP_RTOL`` of the CPU's with word labels equal but for tied
   words.  32 new rows find
   themselves first over the whole store; an /ask over an ingested chunk
   cites its document; K1 launches = 4 x tagger forwards + 6 x encoder
   forwards, all on the prefill path.  Reported: a ``deidentify_batch`` of
   32 notes, docs/s, upload -> INDEXED, the stage spans, and 8 /ask through
   a 1-replica pool alone and beside 64 more uploads.

8. obs: phase 6's 1-replica pool takes round A1 (16 /ask, 64 new tokens)
   three times with the flight recorder off and three times on,
   alternating, each /ask under its own trace and cost record as the
   reference app opens them (the median difference and its spread are
   reported against the reference's 2 % budget, not asserted).  Over the
   last traced round: every trace complete with the expected spans; the
   observatory's peak names the card; ``serve_prefill_fetch`` and
   ``serve_decode_chunk`` costed on every call; no MFU above 1; every
   spine item's device time within its submit-to-done wall time; the cost
   ledger's per-class device ms equal to the spine's series; K1's launch
   identity.  A ``torch.profiler`` window around at least four verify
   steps names K1's decode kernel, and each decode chunk fetched in it
   launched kernels whose CUPTI time is nonzero and within the chunk's
   CUDA-event span; a telemetry tick over the pool, the
   spine, a broker and the recorder renders lint-clean Prometheus text;
   one upload through a pipeline configured as phase 7's leaves a
   timeline of extract, deid and index spans.  Prints the attribution
   table, the per-stage MFU table, the recorder numbers and what a spine
   item pays to cross to a lane thread beside a busy Python thread.

The recorder is on by default, so phases 3-7 run traced too.  Prints the
pool JSON line, the ingest JSON line, the obs JSON line, the kernels JSON
line, the nvidia-smi line, and last the ok line.  Phases 6 and 7 also
print each spine stage's queue wait; ``--spine-lanes N`` sets the spine's
lane count.
Exits non-zero when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from docqa_tpu_torch import obs
from docqa_tpu_torch.config import (
    Config, DecoderConfig, EncoderConfig, GenerateConfig, NERConfig, PoolConfig,
    QoSConfig, ResilienceConfig, StoreConfig,
)
from docqa_tpu_torch.deid import datagen
from docqa_tpu_torch.deid.engine import DeidEngine
from docqa_tpu_torch.engines import paged as paged_mod
from docqa_tpu_torch.engines import serve as serve_mod
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool
from docqa_tpu_torch.engines.serve import ContinuousBatcher
from docqa_tpu_torch.engines.spine import DispatchSpine, configure, get_spine
from docqa_tpu_torch.index.store import VectorStore
from docqa_tpu_torch.models.decoder import (
    decoder_forward, init_decoder_params, init_kv_cache,
)
from docqa_tpu_torch.models.ner import init_ner_params, ner_forward
from docqa_tpu_torch.obs.expo import lint_prometheus_text, prometheus_text
from docqa_tpu_torch.ops import _kernels
from docqa_tpu_torch.ops import attention as attn
from docqa_tpu_torch.resilience import (
    BreakerBoard, Deadline, FaultPlan, FaultRule, faults,
)
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY
from docqa_tpu_torch.service import registry as reg
from docqa_tpu_torch.service.broker import make_broker
from docqa_tpu_torch.service.extract import extract_text_ex
from docqa_tpu_torch.service.pipeline import DocumentPipeline
from docqa_tpu_torch.service.qa import QA_TEMPLATE, QAService
from docqa_tpu_torch.service.registry import DocumentRegistry
from docqa_tpu_torch.text.chunker import chunk_text
from docqa_tpu_torch.utils import pick_bucket, round_up

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

STORE_ROWS = 1_000_000
N_NOTES = 20
QUESTIONS = (
    "Quelle est la dose de metformine du patient P003 ?",
    "Quel traitement pour l'hypertension du patient P007 ?",
    "Le patient P012 a-t-il une allergie à la pénicilline ?",
    "Quelle est la tension artérielle du patient P015 ?",
)
# |kernel - plain| <= atol + rtol * |plain|.  bf16: both sides compute in
# float32 and round once to bf16 (2^-8 relative), so allow ~2.5 bf16 ulps;
# float32: only the summation order differs.
PATH_KEYS = ("flash_attention.decode", "flash_attention.prefill", "flash_attention.simt")
TOL = {
    torch.bfloat16: (1e-2, 1e-2),
    torch.float32: (5e-5, 0.0),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(log_text: str):
    """(kernel, registers, spill stores/loads) per entry of a -Xptxas -v log;
    the kernel named by its template, e.g. flash_decode_kernel<128,1>."""
    rows, kernel, spills = [], None, "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            name = re.search(r"(flash_[a-z]+(?:_[a-z]+)*_kernel)I(\S+)", kernel)
            if name:
                rest = name.group(2)
                dtype = ("bf16," if rest.startswith("13__nv_bfloat16")
                         else "f32," if rest.startswith("f") else "")
                nums = ",".join(re.findall(r"Li(\d+)E", rest))
                kernel = f"{name.group(1)}<{dtype}{nums}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spills))
            kernel, spills = None, "?"
    return rows


# ---- phase 2: kernels against their plain versions ----------------------

def kernel_cases():
    """Shapes the /ask path gives the flash kernel — Mistral-7B decoder: a
    ~200-token RAG prompt in the 256 bucket, a 384-row cache (256 + 64 new
    + K, rounded to 128); MiniLM encoder: the note batch (32 lanes, some
    empty) — plus a ragged GQA case whose sq is no multiple of a tile, and
    the ingest path's NER window batch."""
    mistral = dict(hq=32, hkv=8, d=128, causal=True, window=4096)
    return [
        dict(name="mistral_prefill", b=1, sq=256, skv=384,
             lengths=[197], q_offset=[0], **mistral),
        dict(name="mistral_decode", b=1, sq=1, skv=384,
             lengths=[230], q_offset=[229], **mistral),
        dict(name="mistral_verify", b=1, sq=4, skv=384,
             lengths=[233], q_offset=[229], **mistral),
        dict(name="minilm_encoder", b=32, sq=128, skv=128, hq=12, hkv=12,
             d=32, causal=False, window=None,
             lengths=[0, 128, 1, 77, 0, 33] + [64 + i for i in range(26)],
             q_offset=None),
        dict(name="gqa_ragged", b=3, sq=37, skv=300, hq=8, hkv=2, d=64,
             causal=True, window=50, lengths=[300, 123, 37], q_offset=None),
        # a 4K-token prompt: prefill is bound by operations there, and
        # verify reads a 4K-row cache
        dict(name="mistral_prefill_4k", b=1, sq=4096, skv=4224,
             lengths=[4096], q_offset=[0], **mistral),
        dict(name="mistral_verify_4k", b=1, sq=4, skv=4224,
             lengths=[4100], q_offset=[4096], **{**mistral, "window": None}),
        # the NER tagger's window batch on phase 7's path (NERConfig: 8
        # heads of 32, no GQA, bidirectional): 32 windows of 300-512 rows,
        # two of them empty lanes
        dict(name="ner_window_batch", b=32, sq=512, skv=512, hq=8, hkv=8, d=32,
             causal=False, window=None, q_offset=None,
             lengths=[0, 0] + np.random.default_rng(32).integers(300, 513, 30).tolist()),
        # the batch the pipeline's deid worker serves (prefetch 8: 8 windows
        # of up to 512 rows), one lane empty; plan_flash gives it one
        # warpgroup a block where the 32-window batch takes two
        dict(name="ner_served_batch", b=8, sq=512, skv=512, hq=8, hkv=8, d=32,
             causal=False, window=None, q_offset=None,
             lengths=[0] + np.random.default_rng(8).integers(300, 513, 7).tolist()),
    ]


def time_ms(fn, flush, reps=25, warmup=3, spin_cycles=4_000_000) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each timed with
    CUDA events after overwriting a 64 MB buffer so L2 starts cold (as it
    is for attention inside a 7B forward).  A spin kernel ahead of the
    start event (~2 ms by default; longer for a ``fn`` of many launches)
    keeps the card busy while the host enqueues ``fn``, so the events
    bracket device work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def simt_bf16(q, k, v, lengths, q_offset, causal, window, out):
    """The first port's SIMT kernel on bf16 inputs (path 0 of the C entry
    point), for a same-run comparison; it bypasses the wrapper and its
    launch counts."""
    b, sq, hq, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    rc = attn._flash_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), q_offset.data_ptr(), ctypes.addressof(strides),
        b, sq, k.shape[1], hq, k.shape[2], d, int(causal), int(window or 0),
        float(d ** -0.5), 1, attn.PATHS.index("simt"), 1, 0, 0, None, None,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"SIMT kernel launch failed: CUDA error {rc}")


def live_sdpa(case, q, k, v):
    """SDPA with no mask over the live slice, where the case's mask can be
    written that way (decode: one row over the live prefix; prefill from
    position 0: is_causal over the prompt rows), else None."""
    n = case["lengths"][0]
    if case["b"] != 1 or not case["causal"] or (case["window"] or n) < n:
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = case["hq"] != case["hkv"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if case["sq"] == 1 and case["q_offset"] == [n - 1]:
        return lambda: sdpa(qt, kt[:, :, :n], vt[:, :, :n], enable_gqa=gqa)
    if case["q_offset"] == [0] and case["sq"] >= n:
        return lambda: sdpa(qt[:, :, :n], kt[:, :, :n], vt[:, :, :n],
                            is_causal=True, enable_gqa=gqa)
    return None


def run_kernel_cases():
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = []
    for case in kernel_cases():
        b, sq, skv = case["b"], case["sq"], case["skv"]
        hq, hkv, d = case["hq"], case["hkv"], case["d"]
        lengths = torch.tensor(case["lengths"], dtype=torch.int32, device=dev)
        q_offset = (
            torch.tensor(case["q_offset"], dtype=torch.int32, device=dev)
            if case["q_offset"] is not None
            else (lengths - sq if case["causal"] else torch.zeros_like(lengths))
        )
        kw = dict(causal=case["causal"], lengths=lengths, q_offset=q_offset,
                  sliding_window=case["window"])
        q32 = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k32 = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v32 = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = attn.plan_flash(torch.bfloat16, b, sq, skv, hq, hkv, sms)
        rec = {"case": case["name"], "shape": f"b{b} sq{sq} skv{skv} hq{hq} hkv{hkv} d{d}",
               "path": plan.path, "plan": plan._asdict()}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            got = attn.flash_attention(q, k, v, **kw)
            want = attn.attention_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = TOL[dtype]
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            if not torch.isfinite(got.float()).all() or not ok:
                raise AssertionError(
                    f"flash_attention {case['name']} {tag}: max |err| "
                    f"{float(err.max()):.3e} over atol {atol} rtol {rtol}"
                )
            rec[f"max_abs_err_{tag}"] = float(err.max())
        # times at the main path's type, bf16
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        mask = attn.live_mask(b, sq, skv, lengths, q_offset, case["causal"],
                              case["window"], dev)
        rec["ms"] = time_ms(lambda: attn.flash_attention(q, k, v, **kw), flush)
        out = torch.empty_like(q)
        rec["simt_ms"] = time_ms(
            lambda: simt_bf16(q, k, v, lengths, q_offset, case["causal"],
                              case["window"], out), flush
        )
        rec["plain_ms"] = time_ms(
            lambda: attn.attention_reference(q, k, v, **kw), flush
        )
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask[:, None]
        rec["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=hq != hkv
            ),
            flush,
        )
        live_fn = live_sdpa(case, q, k, v)
        rec["library_live_ms"] = time_ms(live_fn, flush) if live_fn else None
        es = 2  # bf16
        live_pairs = int(mask.sum())
        live_kv_rows = int(mask.any(dim=1).sum())
        flops = 4 * d * hq * live_pairs
        nbytes = (2 * b * sq * hq * d + 2 * live_kv_rows * hkv * d) * es + 8 * b
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_flops = flops / PEAK_BF16_FLOPS * 1e3
        rec["bound_ms"] = max(t_bytes, t_flops)
        rec["bound_by"] = "bytes" if t_bytes >= t_flops else "operations"
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["tolerance"] = {"bf16": TOL[torch.bfloat16], "f32": TOL[torch.float32]}
        live = rec["library_live_ms"]
        log(f"  {rec['case']:18s} {rec['shape']:36s} {plan.path:7s} err bf16 "
            f"{rec['max_abs_err_bf16']:.2e} f32 {rec['max_abs_err_f32']:.2e}  "
            f"kernel {rec['ms']:.4f} ms  simt {rec['simt_ms']:.4f} ms  "
            f"plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms  "
            f"sdpa-live {'-' if live is None else f'{live:.4f}'} ms  "
            f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
            f"{100 * rec['bound_share']:.1f} % of it)")
        results.append(rec)
    return results


def paged_cases():
    """The batcher's verify step at Mistral widths and with Mistral's
    4,096-token sliding window, as the main path passes it (8 lanes, K=4,
    16-token blocks, NB=64: the 1,024-row capacity of phase 5), the same
    over ~4,100 live rows per lane, where the window cuts the first rows,
    and a replica of phase 6 (16 lanes over a pool of 16 x 64 blocks, half
    of them idle: their table rows all holes, as a free slot's are)."""
    mistral = dict(hq=32, hkv=8, d=128, sq=4, block_size=16, window=4096)
    return [
        dict(name="mistral_paged_verify", lanes=8, nb=64, live=(180, 260), **mistral),
        dict(name="mistral_paged_verify_4k", lanes=8, nb=264, live=(4090, 4110), **mistral),
        dict(name="mistral_paged_verify_16", lanes=16, idle=8, nb=64, live=(180, 300),
             **mistral),
    ]


def run_paged_cases():
    """K1's paged mode against its plain version (gather_paged_kv +
    attention_reference) on shuffled block ids with hole entries, and the
    times of: the kernel, the plain version, the library call (gather +
    masked SDPA) and the reference's own TPU route (gather + K1's
    contiguous decode path)."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rng = np.random.default_rng(4321)
    results = []
    for case in paged_cases():
        S, sq, nb, bs = case["lanes"], case["sq"], case["nb"], case["block_size"]
        hq, hkv, d = case["hq"], case["hkv"], case["d"]
        n_blocks = S * nb  # every lane could fill its table
        lengths_np = rng.integers(case["live"][0], case["live"][1] + 1, S)
        perm = rng.permutation(n_blocks)
        tables_np = np.full((S, nb), n_blocks, np.int32)  # holes past the live blocks
        busy = S - case.get("idle", 0)  # the last lanes idle: no block, any length
        for lane, n in enumerate(lengths_np[:busy]):
            used = -(-int(n) // bs)
            tables_np[lane, :used] = perm[lane * nb: lane * nb + used]
        if busy < S:
            lengths_np[busy:] = rng.integers(sq, case["live"][1] + 1, S - busy)
        tables = torch.from_numpy(tables_np).to(dev)
        lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
        q_offset = lengths - sq
        q = torch.randn((S, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        k_pool, v_pool = (
            torch.randn((n_blocks * bs, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2)
        )
        kw = dict(block_size=bs, q_offset=q_offset, sliding_window=case["window"])
        dense_kw = dict(causal=True, lengths=lengths, q_offset=q_offset,
                        sliding_window=case["window"])

        def kernel():
            return attn.paged_decode_attention(q, k_pool, v_pool, tables, lengths, **kw)

        def gathered():
            return (attn.gather_paged_kv(k_pool, tables, bs),
                    attn.gather_paged_kv(v_pool, tables, bs))

        def plain():
            k, v = gathered()
            return attn.attention_reference(q, k, v, **dense_kw)

        skv = nb * bs
        mask = attn.live_mask(S, sq, skv, lengths, q_offset, True, case["window"], dev)

        def library():
            k, v = gathered()
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=hq != hkv,
            )

        def gather_k1():
            k, v = gathered()
            return attn.flash_attention(q, k, v, **dense_kw)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        atol, rtol = TOL[torch.bfloat16]
        if not torch.isfinite(got.float()).all() or not bool(
            (err <= atol + rtol * want.float().abs()).all()
        ):
            raise AssertionError(
                f"paged_decode_attention {case['name']}: max |err| "
                f"{float(err.max()):.3e} over atol {atol} rtol {rtol}"
            )
        plan = attn.plan_flash(torch.bfloat16, S, sq, skv, hq, hkv,
                               torch.cuda.get_device_properties(dev).multi_processor_count)
        rec = {"case": case["name"], "path": "decode_paged",
               "shape": f"S{S} sq{sq} NB{nb} bs{bs} hq{hq} hkv{hkv} d{d}",
               "plan": plan._asdict(), "lengths": lengths_np.tolist(),
               "max_abs_err_bf16": float(err.max())}
        rec["ms"] = time_ms(kernel, flush)
        rec["plain_ms"] = time_ms(plain, flush)
        rec["library_ms"] = time_ms(library, flush)
        rec["gather_k1_ms"] = time_ms(gather_k1, flush)
        es = 2  # bf16
        live_pairs = int(mask.sum())
        live_kv_rows = int(mask.any(dim=1).sum())
        flops = 4 * d * hq * live_pairs
        nbytes = ((2 * S * sq * hq * d + 2 * live_kv_rows * hkv * d) * es
                  + 4 * S * nb + 8 * S)  # + the block table, lengths, q_offset
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_flops = flops / PEAK_BF16_FLOPS * 1e3
        rec["bound_ms"] = max(t_bytes, t_flops)
        rec["bound_by"] = "bytes" if t_bytes >= t_flops else "operations"
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        log(f"  {rec['case']:24s} {rec['shape']:38s} {plan.num_splits} splits  err bf16 "
            f"{rec['max_abs_err_bf16']:.2e}  kernel {rec['ms']:.4f} ms  plain "
            f"{rec['plain_ms']:.4f} ms  gather+sdpa {rec['library_ms']:.4f} ms  "
            f"gather+K1 {rec['gather_k1_ms']:.4f} ms  bound {rec['bound_ms']:.5f} ms "
            f"({rec['bound_by']}, {100 * rec['bound_share']:.1f} % of it)")
        results.append(rec)
    return results


# ---- phase 3: the main path at full width ---------------------------------

def clinical_notes(rng: np.random.Generator):
    drugs = [("metformine", 500), ("lisinopril", 10), ("amlodipine", 5),
             ("atorvastatine", 20), ("aspirine", 100), ("lévothyroxine", 75)]
    conditions = ["diabète de type 2", "hypertension artérielle",
                  "dyslipidémie", "hypothyroïdie", "insuffisance cardiaque"]
    notes = []
    for i in range(N_NOTES):
        drug, dose = drugs[int(rng.integers(len(drugs)))]
        cond = conditions[int(rng.integers(len(conditions)))]
        allergy = "pénicilline" if rng.random() < 0.3 else "aucune connue"
        text = (
            f"Consultation du patient P{i:03d}, {int(rng.integers(30, 90))} ans. "
            f"Antécédents : {cond}. Traitement : {drug} {dose} mg "
            f"{int(rng.integers(1, 3))} fois par jour. Tension artérielle "
            f"{int(rng.integers(110, 170))}/{int(rng.integers(60, 100))} mmHg. "
            f"Allergies : {allergy}. Suivi dans {int(rng.integers(1, 6))} mois."
        )
        notes.append((f"note-{i:02d}.txt", text))
    return notes


def build_main_path(counts):
    """The /ask service at full width on the card: MiniLM-L6 encoder, a
    store of the notes (encoded through the engine) plus seeded random
    unit vectors up to STORE_ROWS rows, and a Mistral-7B-width bf16
    generator with weights drawn on the card.  ``counts`` is reset before
    the notes are encoded.  Returns (qa, params, note-encoding launches)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    enc_cfg = EncoderConfig()
    dec_cfg = DecoderConfig.mistral_7b()

    t0 = time.perf_counter()
    encoder = EncoderEngine(enc_cfg, seed=0, device=dev)
    store = VectorStore(StoreConfig(), device=dev)
    notes = clinical_notes(rng)
    counts.clear()
    note_emb = encoder.encode_texts([text for _, text in notes])
    enc_launches = counts["flash_attention"]
    if enc_launches != enc_cfg.num_layers or counts["flash_attention.prefill"] != enc_launches:
        raise AssertionError(
            f"note encoding launched the flash kernel {enc_launches} times, "
            f"expected {enc_cfg.num_layers}"
        )
    if not np.isfinite(note_emb).all() or not np.allclose(
        np.linalg.norm(note_emb, axis=1), 1.0, atol=1e-3
    ):
        raise AssertionError("note embeddings are not finite unit vectors")
    store.add(note_emb, [
        {"source": src, "text_content": text, "doc_id": src}
        for src, text in notes
    ])
    n_fill = STORE_ROWS - N_NOTES
    filler = rng.standard_normal((n_fill, enc_cfg.embed_dim), dtype=np.float32)
    store.add(filler, [{"source": f"filler-{i:07d}"} for i in range(n_fill)])
    del filler
    t_store = time.perf_counter() - t0
    log(f"  store: {store.count} rows x {enc_cfg.embed_dim} "
        f"{store.cfg.dtype} (capacity {store.capacity}), built in {t_store:.1f} s")

    t0 = time.perf_counter()
    params = init_decoder_params(dec_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  decoder: Mistral-7B width, {sum(p.numel() for p in params.values()) / 1e9:.2f} "
        f"B params bf16 drawn on the card in {time.perf_counter() - t0:.1f} s")
    generator = GenerateEngine(
        dec_cfg, GenerateConfig(max_new_tokens=64, speculative_k=4),
        params=params, device=dev,
    )
    qa = QAService(encoder, store, generator, k=3, device=dev)
    return qa, params, enc_launches


def run_main_path(counts, qa, params, enc_launches):
    dev = torch.device("cuda")
    generator = qa.generator
    enc_cfg = qa.retriever.encoder.cfg
    dec_cfg = generator.cfg

    per_q = []
    for question in QUESTIONS:
        before = dict(counts)
        t0 = time.perf_counter()
        out = qa.ask(question)
        latency = time.perf_counter() - t0
        _no_degraded("solo /ask", [out])
        delta = {key: counts[key] - before.get(key, 0) for key in PATH_KEYS}
        launched = counts["flash_attention"] - before.get("flash_attention", 0)
        st = dict(generator.last_stats)
        expected = enc_cfg.num_layers + st["forwards"] * dec_cfg.num_layers
        if launched != expected or st["forwards"] < 1:
            raise AssertionError(
                f"ask launched the flash kernel {launched} times; expected "
                f"{enc_cfg.num_layers} (encoder) + {st['forwards']} forwards x "
                f"{dec_cfg.num_layers} layers (decoder)"
            )
        # the query encode and the one prefill forward on the wgmma path,
        # every verify forward on the split-kv path, nothing on the SIMT one
        want = {
            "flash_attention.prefill": enc_cfg.num_layers + dec_cfg.num_layers,
            "flash_attention.decode": (st["forwards"] - 1) * dec_cfg.num_layers,
            "flash_attention.simt": 0,
        }
        if delta != want:
            raise AssertionError(f"ask's launches by path {delta}, expected {want}")
        if not isinstance(out["answer"], str) or not out["answer"].strip():
            raise AssertionError(f"empty answer for {question!r}")
        if len(out["sources"]) != 3:
            raise AssertionError(f"expected 3 sources, got {out['sources']}")
        if not any(s.startswith("note-") for s in out["sources"]):
            raise AssertionError(f"no real note among sources {out['sources']}")
        rec = {
            "question": question,
            "latency_s": latency,
            "sources": out["sources"],
            "answer": out["answer"],
            "answer_words": len(out["answer"].split()),
            "prefill_tokens": st["prefill_tokens"],
            "prefill_s": st["prefill_s"],
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tokens": st["decode_tokens"],
            "decode_s": st["decode_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "decoder_forwards": st["forwards"],
            "flash_launches": launched,
            "flash_launches_by_path": delta,
        }
        log(f"  ask {len(per_q)}: {latency:.3f} s, sources {out['sources']}, "
            f"prefill {rec['prefill_tokens']} tok in {rec['prefill_s'] * 1e3:.1f} ms "
            f"({rec['prefill_tok_s']:.0f} tok/s), decode {rec['decode_tokens']} tok "
            f"in {rec['decode_s'] * 1e3:.1f} ms ({rec['decode_tok_s']:.1f} tok/s), "
            f"{st['forwards']} forwards, {launched} flash launches "
            f"(decode {delta['flash_attention.decode']}, prefill "
            f"{delta['flash_attention.prefill']}, simt {delta['flash_attention.simt']})")
        per_q.append(rec)
    launches = {"total": dict(counts), "note_encoding": enc_launches}

    # full-width output check (after the counts are read): one prefill of
    # the last question gives finite logits of the expected shape
    prompt_ids = generator.tokenizer.encode(QUESTIONS[-1])
    ids = torch.tensor([prompt_ids], device=dev)
    cache = init_kv_cache(dec_cfg, 1, max_len=128, dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        logits = decoder_forward(
            params, dec_cfg, ids, cache, torch.zeros(1, dtype=torch.int32, device=dev),
            last_token_only=True,
        )
    if logits.shape != (1, 1, dec_cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"full-width logits bad: {tuple(logits.shape)}")
    return per_q, launches


# ---- phase 4: tiny float32 path, card (kernels) against CPU (plain) -------

def run_reference_check():
    enc_cfg = EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2,
                            num_heads=2, mlp_dim=128, max_seq_len=128,
                            embed_dim=64, dtype="float32")
    dec_cfg = DecoderConfig(vocab_size=256, hidden_dim=128, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=32,
                            mlp_dim=256, max_seq_len=1024, dtype="float32",
                            sliding_window=64)
    gen_cfg = GenerateConfig(max_new_tokens=16, prefill_buckets=(64, 128, 256, 512))
    notes = clinical_notes(np.random.default_rng(3))
    answers = {}
    for device in ("cuda", "cpu"):
        encoder = EncoderEngine(enc_cfg, seed=1, device=device)
        store = VectorStore(StoreConfig(dim=64), device=device)
        emb = encoder.encode_texts([t for _, t in notes])
        store.add(emb, [{"source": s, "text_content": t} for s, t in notes])
        generator = GenerateEngine(dec_cfg, gen_cfg, seed=2, device=device)
        qa = QAService(encoder, store, generator, k=3, device=device)
        answers[device] = ([qa.ask(q) for q in QUESTIONS], emb)
        _no_degraded(f"tiny /ask on {device}", answers[device][0])
    (ans_gpu, emb_gpu), (ans_cpu, emb_cpu) = answers["cuda"], answers["cpu"]
    emb_err = float(np.abs(emb_gpu - emb_cpu).max())
    if emb_err > 1e-4 or ans_gpu != ans_cpu:
        raise AssertionError(
            f"tiny float32 path differs between card and CPU: embeddings "
            f"max |err| {emb_err:.2e}, answers equal {ans_gpu == ans_cpu}"
        )
    log(f"  tiny float32 /ask: {len(QUESTIONS)} answers identical on card and "
        f"CPU; embeddings max |err| {emb_err:.2e} (tolerance 1e-4)")
    return {"answers_identical": True, "embedding_max_abs_err": emb_err}


# ---- phase 5: /ask through the continuous batcher at full width ------------

# Batcher vs solo first-step logits for one prompt, bf16 on the card: the
# relative RMS difference ||served - solo|| / ||solo||.  The two routes run
# the same 32 layers but with other GEMM batch shapes (a 512-token packed
# stream against the solo engine's 256 bucket, so cuBLAS may pick other
# kernels and summation orders) and another prefill attention (the plain
# f32 ragged version against K1's wgmma path, which rounds P to bf16).
# Each bf16 rounding is 2^-9 relative; compounded over 32 layers of a
# random-weight stack they stay well under 5 % of the logits' RMS.
FIRST_STEP_RTOL = 5e-2


def first_step_prompt(qa, question, usable):
    """``question``'s /ask prompt (retrieval at the service's k) and its
    token ids as the batcher truncates them to ``usable`` tokens."""
    hits = qa.retriever.search_texts([question], k=qa.k)[0]
    chunks = [h.metadata.get("text_content", h.metadata.get("source", "")) for h in hits]
    prompt = QA_TEMPLATE.format(context="\n\n".join(chunks), question=question)
    return prompt, qa.generator.encode_prompt(prompt, usable)


def solo_first_step(gen, ids):
    """First-step logits of ``ids`` from the solo engine's bucketed prefill
    through K1, bf16 on the card."""
    cfg, dev, n = gen.cfg, gen.device, len(ids)
    with torch.inference_mode():
        bucket = pick_bucket(n, gen.gen.prefill_buckets)
        solo_ids = torch.full((1, bucket), gen.gen.pad_id, dtype=torch.long, device=dev)
        solo_ids[0, :n] = torch.tensor(ids, device=dev)
        cache = init_kv_cache(cfg, 1, max_len=round_up(bucket + 64 + 4, 128),
                              dtype=gen.params["tok_emb"].dtype, device=dev)
        solo = decoder_forward(
            gen.params, cfg, solo_ids, cache, torch.zeros(1, dtype=torch.int32, device=dev),
            attn_lengths=torch.tensor([n], dtype=torch.int32, device=dev),
            last_token_only=True,
        )[0, 0]
    return solo.float()


def served_first_step(submit, items):
    """The first step of each ``(prompt, ids, submit kwargs)`` as a batcher
    (or a pool of them) serves it: every prompt is submitted at once with
    ``max_new_tokens=1`` (admission, packing, the prefill program and the
    pipelined fetch as any request takes them) while a tap on the batcher's
    ragged prefill forward keeps the logits of each lane whose packed tokens
    are one prompt's ``ids`` from position 0 (a concurrent canary's lane is
    not taken).  Returns [(served logits, the token delivered)] in order."""
    wants = [torch.tensor(ids) for _p, ids, _kw in items]
    taken = [[] for _ in items]
    forward = serve_mod.ragged_prefill_forward

    def tap(params, cfg, pools, ids_t, seg, pos, dest, last_rows, **kw):
        logits = forward(params, cfg, pools, ids_t, seg, pos, dest, last_rows, **kw)
        seg_h, ids_h, pos_h = seg.cpu(), ids_t.cpu(), pos.cpu()
        for lane in range(last_rows.shape[0]):
            mine = seg_h == lane
            for i, want in enumerate(wants):
                if (int(mine.sum()) == len(want) and int(pos_h[mine][0]) == 0
                        and torch.equal(ids_h[mine], want)):
                    taken[i].append(logits[lane].float().clone())
        return logits

    serve_mod.ragged_prefill_forward = tap
    try:
        handles = [submit(prompt, max_new_tokens=1, **kw) for prompt, _ids, kw in items]
        delivered = [h.result(timeout=600) for h in handles]
    finally:
        serve_mod.ragged_prefill_forward = forward
    torch.cuda.synchronize()
    if [len(t) for t in taken] != [1] * len(items) or any(len(d) != 1 for d in delivered):
        raise AssertionError(
            f"one prefill lane and one token per prompt expected, got "
            f"{[len(t) for t in taken]} lanes and tokens {delivered}"
        )
    return [(t[0], d[0]) for t, d in zip(taken, delivered)]


def check_first_step(where, solo_logits, served_logits, token, n_prompt):
    """Served first-step logits within ``FIRST_STEP_RTOL`` relative RMS of
    solo's, the delivered token their argmax (and solo's past a decisive
    top-2 gap); returns the record."""
    diff = served_logits - solo_logits
    rel = float(diff.norm() / solo_logits.norm())
    top2 = solo_logits.topk(2).values
    gap = float(top2[0] - top2[1])
    max_abs = float(diff.abs().max())
    # a solo top-2 gap wider than twice the largest logit difference
    # cannot flip the argmax: then the delivered token must be solo's
    decisive = gap > 2 * max_abs
    rec = {
        "prompt_tokens": n_prompt, "rel_rms_diff": rel,
        "max_abs_diff": max_abs,
        "solo_logit_rms": float(solo_logits.pow(2).mean().sqrt()),
        "solo_top2_gap": gap,
        "delivered_token": token,
        "served_argmax": int(served_logits.argmax()),
        "solo_argmax": int(solo_logits.argmax()),
        "tolerance_rel_rms": FIRST_STEP_RTOL,
    }
    log(f"  first step through the {where} vs solo ({n_prompt}-token prompt): "
        f"logits relative RMS diff {rel:.3e} (tolerance {FIRST_STEP_RTOL}), max |diff| "
        f"{max_abs:.3e}; delivered token {token}, served argmax "
        f"{rec['served_argmax']}, solo argmax {rec['solo_argmax']} "
        f"(solo top-2 gap {gap:.3e}, {'asserted' if decisive else 'reported'})")
    if not rel <= FIRST_STEP_RTOL:
        raise AssertionError(f"{where} vs solo first-step logits differ: {rec}")
    if token != rec["served_argmax"]:
        raise AssertionError(f"the {where} delivered another token than its logits' argmax: {rec}")
    if decisive and token != rec["solo_argmax"]:
        raise AssertionError(f"{where} and solo first tokens differ past a decisive gap: {rec}")
    return rec


def _no_degraded(where, outs):
    """Phases 3-5 run no fault and no deadline: every answer is generated."""
    bad = [(o.get("degrade_reason"), o.get("answer", "")[:60]) for o in outs
           if o.get("degraded")]
    if bad:
        raise AssertionError(f"{where}: degraded answers {bad}")


def _ask_round(qa, questions):
    """Submit every question at once (retrieval then a queued decode each),
    then wait for all of them on one thread per request; returns
    (question, response, latency_s) per request, latency from its submit."""
    pend = []
    for q in questions:
        t0 = time.perf_counter()
        pend.append((q, t0, qa.ask_submit(q)))
    results = [None] * len(pend)

    def wait(i, q, t0, pending):
        try:
            out = pending.resolve(timeout=600)
            results[i] = (q, out, time.perf_counter() - t0)
        except BaseException as e:  # reported below, failing the phase
            results[i] = (q, e, None)

    threads = [threading.Thread(target=wait, args=(i, *p)) for i, p in enumerate(pend)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=660)
    for q, out, _lat in results:
        if not isinstance(out, dict):
            raise AssertionError(f"batcher /ask {q!r} failed: {out!r}")
    _no_degraded("batcher /ask", [r[1] for r in results])
    return results


def _tokens(answer: str):
    return answer.split()  # the hash tokenizer decodes one "w<id>" per token


def run_batcher_path(counts, qa_solo, solo_per_q):
    """Phase 5: /ask through ``ContinuousBatcher`` at full width on phase
    3's encoder, store and Mistral-7B-width weights (no second copy): 8
    slots, 16-token chunks, 1,024-token capacity, 16-token blocks, a
    worst-case pool, the prefix cache on, K=4, FIFO.  Round A submits the
    four questions twice each at once; round B the same eight after A
    drained, so the prefix cache serves warm admissions.  The launch counts
    are set to 0 just before the two rounds and read just after."""
    dev = torch.device("cuda")
    gen = qa_solo.generator
    dec_cfg = gen.cfg
    enc_layers = qa_solo.retriever.encoder.cfg.num_layers
    batcher = ContinuousBatcher(gen, n_slots=8, chunk=16, cache_len=1024,
                                kv_block_size=16, kv_pool_tokens=None,
                                prefix_cache=True)
    try:
        qa = QAService(qa_solo.retriever.encoder, qa_solo.retriever.store, gen,
                       k=3, device=dev, batcher=batcher)
        t0 = time.perf_counter()
        batcher.warmup()
        torch.cuda.synchronize()
        log(f"  batcher: {batcher.n_slots} slots, chunk {batcher.chunk}, K={batcher.spec_k}, "
            f"{batcher.n_blocks} blocks x {batcher.block_size} tokens "
            f"({batcher.n_blocks * batcher.block_size * batcher.kv_bytes_per_token / 2**30:.2f} GiB "
            f"of KV), token budgets {batcher._token_buckets}; warmed in "
            f"{time.perf_counter() - t0:.1f} s")

        prompt, ids = first_step_prompt(qa, QUESTIONS[0],
                                        batcher.cache_len - 2 - batcher.spec_k)
        [(served, token)] = served_first_step(batcher.submit_text, [(prompt, ids, {})])
        logit_check = check_first_step("batcher", solo_first_step(gen, ids), served,
                                       token, len(ids))

        # the plain versions, counted while the two rounds run: none of the
        # flash wrappers may take them on the card (the ragged prefill
        # attention IS plain in this slice and is counted apart)
        plain_calls = collections.Counter()
        originals = {
            (attn, "attention_reference"): attn.attention_reference,
            (attn, "gather_paged_kv"): attn.gather_paged_kv,
            (paged_mod, "ragged_prefill_attention"): paged_mod.ragged_prefill_attention,
        }

        def counting(name, fn):
            def wrapper(*a, **k):
                plain_calls[name] += 1
                return fn(*a, **k)
            return wrapper

        for (mod, name), fn in originals.items():
            setattr(mod, name, counting(name, fn))
        try:
            stats0 = collections.Counter(batcher.stats)
            torch.cuda.reset_peak_memory_stats()
            counts.clear()
            rounds = {}
            t_all = time.perf_counter()
            for name in ("A", "B"):
                t0 = time.perf_counter()
                before = collections.Counter(batcher.stats)
                results = _ask_round(qa, QUESTIONS * 2)
                if not batcher.drain(timeout=600):
                    raise AssertionError(f"round {name} did not drain")
                wall = time.perf_counter() - t0
                batcher.resume()
                done = collections.Counter(batcher.stats) - before
                lat = sorted(r[2] for r in results)
                n_tok = sum(len(_tokens(r[1]["answer"])) for r in results)
                rounds[name] = {
                    "wall_s": wall,
                    "latency_p50_s": statistics.median(lat),
                    "latency_max_s": lat[-1],
                    "latencies_s": [r[2] for r in results],
                    "answer_tokens": n_tok,
                    "tokens_per_s": n_tok / wall,
                    "verify_steps": done["verify_steps"],
                    "admissions": done["admissions"],
                    "warm_admissions": done["warm_admissions"],
                    "prefill_dispatches": done["prefill_dispatches"],
                    "answers": [(r[0], r[1]["answer"], r[1]["sources"]) for r in results],
                }
                occ = batcher.kv_block_occupancy()
                log(f"  round {name}: 8 /ask in {wall:.3f} s, latency p50 "
                    f"{rounds[name]['latency_p50_s']:.3f} s max {lat[-1]:.3f} s, "
                    f"{n_tok} answer tokens = {n_tok / wall:.1f} tok/s, "
                    f"{done['verify_steps']} verify steps, {done['admissions']} admissions "
                    f"({done['warm_admissions']} warm) in {done['prefill_dispatches']} "
                    f"prefill passes; blocks after drain {occ['blocks_used']} / "
                    f"{occ['blocks_total']} (prefix cache {occ.get('prefix_blocks')})")
            wall_all = time.perf_counter() - t_all
            launches = dict(counts)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            stats = collections.Counter(batcher.stats) - stats0
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)

        # ---- what must hold ----
        for rnd in rounds.values():
            for q, answer, sources in rnd["answers"]:
                if not answer.strip():
                    raise AssertionError(f"empty batcher answer for {q!r}")
                if len(sources) != 3:
                    raise AssertionError(f"expected 3 sources, got {sources}")
        pstats = batcher._prefix_cache.stats()
        if pstats["hits"] < 1 or stats["warm_admissions"] < 1:
            raise AssertionError(f"no warm prefix admission: {pstats}")
        in_use = batcher._alloc.blocks_in_use
        if in_use != pstats["pinned_blocks"]:
            raise AssertionError(
                f"{in_use} blocks in use after drain, the prefix cache pins "
                f"{pstats['pinned_blocks']}: blocks leaked"
            )
        if plain_calls["attention_reference"] or plain_calls["gather_paged_kv"]:
            raise AssertionError(f"an attention call took the plain version: {dict(plain_calls)}")
        n_ask = 16
        want = {
            "flash_attention.decode_paged": dec_cfg.num_layers * stats["verify_steps"],
            "flash_attention.prefill": enc_layers * n_ask,
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want or stats["verify_steps"] < 1:
            raise AssertionError(f"batcher phase launches {got}, expected {want}")
        if launches.get("flash_attention", 0) != sum(want.values()):
            raise AssertionError(f"flash_attention launches {launches}, expected {sum(want.values())}")
        if plain_calls["ragged_prefill_attention"] != dec_cfg.num_layers * stats["prefill_dispatches"]:
            raise AssertionError(f"ragged prefill calls {dict(plain_calls)} vs {stats}")

        # reported, not asserted: greedy tokens against phase 3's solo answers
        solo = {r["question"]: _tokens(r["answer"]) for r in solo_per_q}
        match = []
        for q, answer, _src in rounds["A"]["answers"] + rounds["B"]["answers"]:
            a, s = _tokens(answer), solo[q]
            same = next((i for i, (x, y) in enumerate(zip(a, s)) if x != y), min(len(a), len(s)))
            match.append({"question": q, "matching_prefix": same, "solo_tokens": len(s),
                          "batcher_tokens": len(a)})
        lat_all = sorted(x for r in rounds.values() for x in r["latencies_s"])
        tok_all = sum(r["answer_tokens"] for r in rounds.values())
        summary = {
            "latency_p50_s": statistics.median(lat_all), "latency_max_s": lat_all[-1],
            "tokens_per_s": tok_all / wall_all, "wall_s": wall_all,
            "verify_steps": stats["verify_steps"],
            "peak_device_gib": peak_gib,
            "kv_block_occupancy": batcher.kv_block_occupancy(),
            "prefix_cache": pstats, "plain_calls": dict(plain_calls),
            "greedy_match_vs_solo": match,
            "full_matches": sum(m["matching_prefix"] == m["solo_tokens"] == m["batcher_tokens"]
                                for m in match),
        }
        log(f"  batcher /ask: 16 answers, latency p50 {summary['latency_p50_s']:.3f} s "
            f"max {lat_all[-1]:.3f} s, {tok_all / wall_all:.1f} answer tok/s overall, "
            f"{stats['verify_steps']} verify steps, peak device memory {peak_gib:.2f} GiB, "
            f"launches {got} (= {dec_cfg.num_layers} "
            f"x verify steps on decode_paged), plain calls {dict(plain_calls)}; "
            f"prefix hits {pstats['hits']:.0f} / misses {pstats['misses']:.0f}; "
            f"greedy answers equal to solo: {summary['full_matches']} of 16 "
            f"(matching prefixes {[m['matching_prefix'] for m in match]})")
        return {"rounds": rounds, "summary": summary, "logit_check": logit_check,
                "launches": launches, "stats": dict(stats)}
    finally:
        batcher.stop()


# ---- phase 6: /ask through the replica pool at full width -------------------

# Rounds B-E pass this budget to every /ask, not the reference's 8 s: the
# host's clock spread 2x between runs of the same code (PERF.md section 4)
POOL_DEADLINE_S = 60.0
# a dead replica must be healthy again within this many seconds
REBUILD_LIMIT_S = 30.0
# round E's decoder breaker: the reference's 5-failure threshold, its 30 s
# reset cut to 2 s so the drill waits out one reset window
BREAKER_RESET_S = 2.0


def _resolve_all(pend):
    """Wait for every (question, t0, PendingAnswer) on its own thread, each
    result taken with a timeout; returns (question, response, latency_s).
    Fails when a waiter hangs or an /ask raised."""
    results = [None] * len(pend)

    def wait(i, q, t0, pending):
        try:
            out = pending.resolve(timeout=120)
            results[i] = (q, out, time.perf_counter() - t0)
        except BaseException as e:  # reported below, failing the phase
            results[i] = (q, e, None)

    threads = [threading.Thread(target=wait, args=(i, *p)) for i, p in enumerate(pend)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    hung = [pend[i][0] for i, r in enumerate(results) if r is None]
    if hung:
        raise AssertionError(f"pool /ask waiter(s) hung: {hung}")
    for q, out, _lat in results:
        if not isinstance(out, dict):
            raise AssertionError(f"pool /ask {q!r} failed: {out!r}")
    return results


def _submit_round(qa, questions, req_class="interactive"):
    pend = []
    for q in questions:
        t0 = time.perf_counter()
        pend.append((q, t0, qa.ask_submit(
            q, deadline=Deadline.after(POOL_DEADLINE_S), req_class=req_class)))
    return pend


def _round_record(results, wall):
    lat = sorted(r[2] for r in results)
    served = [r[1] for r in results if not r[1].get("degraded")]
    n_tok = sum(len(_tokens(out["answer"])) for out in served)
    reasons = collections.Counter(r[1]["degrade_reason"] for r in results
                                  if r[1].get("degraded"))
    return {"asks": len(results), "wall_s": wall,
            "latency_p50_s": statistics.median(lat), "latency_max_s": lat[-1],
            "answer_tokens": n_tok, "tokens_per_s": n_tok / wall,
            "degraded": dict(reasons)}


def _reserved_bytes() -> int:
    """Reserved device memory once the caching allocator returned what no
    tensor holds."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _pool_prompt(qa, question):
    hits = qa.retriever.search_texts([question], k=qa.k)[0]
    chunks = [h.metadata.get("text_content", h.metadata.get("source", "")) for h in hits]
    return QA_TEMPLATE.format(context="\n\n".join(chunks), question=question)


def run_pool_path(counts, qa_solo):
    """Phase 6: /ask through ``EnginePool(PoolConfig(replicas=2, n_slots=16),
    QoSConfig())`` on phase 3's encoder, store and Mistral-7B-width weights
    (chunk 16, capacity 1,024, 16-token blocks, prefix cache, K=4), with the
    decoder breaker and ``ResilienceConfig`` wired as the reference's
    ``/ask`` does.  Rounds: A1 (reported) the 16 /ask of round A through a
    1-replica pool; A 16 concurrent /ask at 64 new tokens; B the same
    at 32 with a worker crash injected; C a rolling restart under 8 /ask; D
    KV preemption in a separate 1-replica pool; E the degraded path.  Before
    A, two prompts submitted at once through the 2-replica pool, one on
    each replica, give first-step logits within ``FIRST_STEP_RTOL`` of the
    solo engine's.  The
    launch counts are set to 0 just before round A1 and read after E."""
    gen = qa_solo.generator
    dev = gen.device
    dec_cfg = gen.cfg
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    enc_layers = encoder.cfg.num_layers
    res_cfg = ResilienceConfig()
    # the solo side of the pool's first-step check, before the counts start:
    # its launches compare, they do not serve
    first = [first_step_prompt(qa_solo, q, 1024 - 2 - gen.gen.speculative_k)
             for q in QUESTIONS[1:3]]
    solo_fs = [solo_first_step(gen, ids) for _prompt, ids in first]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts.clear()
    n_encodes = 0
    rounds = {}

    # ---- A1, reported and not asserted: round A's 16 /ask through ONE
    # replica of 16 slots (the reference's default replica count), the same
    # work on one worker thread
    pool1 = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=16), qos=QoSConfig(),
                       chunk=16, cache_len=1024, device=dev)
    try:
        qa1 = QAService(encoder, store, gen, k=3, device=dev, batcher=pool1,
                        breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                              res_cfg.breaker_reset_s),
                        resilience=res_cfg)
        t0 = time.perf_counter()
        res = _resolve_all(_submit_round(qa1, QUESTIONS * 4))
        wall = time.perf_counter() - t0
        stats_1 = pool1.stats()
    finally:
        pool1.stop()
    n_encodes += len(res)
    rec = _round_record(res, wall)
    rec["verify_steps"] = stats_1["verify_steps"]
    rounds["A1"] = rec
    log(f"  round A1 (1 replica x 16 slots, reported): 16 /ask in {wall:.3f} s, p50 "
        f"{rec['latency_p50_s']:.3f} s max {rec['latency_max_s']:.3f} s, "
        f"{rec['tokens_per_s']:.1f} answer tok/s, {rec['verify_steps']} verify steps, "
        f"degraded {rec['degraded']}")

    t0 = time.perf_counter()
    pool = EnginePool(gen, cfg=PoolConfig(replicas=2, n_slots=16), qos=QoSConfig(),
                      chunk=16, cache_len=1024, device=dev)
    build_s = time.perf_counter() - t0
    pool_d = None
    try:
        b0 = pool._replicas[0].batcher
        pool_bytes = b0.kv_block_occupancy()["pool_bytes"]
        log(f"  pool: 2 replicas x {b0.n_slots} slots, chunk {b0.chunk}, K={b0.spec_k}, "
            f"{b0.n_blocks} blocks x {b0.block_size} tokens ({pool_bytes / 2**30:.2f} GiB "
            f"of KV each), weighted-fair QoS; built and warmed in {build_s:.1f} s")
        def make_qa(board=None):
            board = board or BreakerBoard(res_cfg.breaker_failure_threshold,
                                          res_cfg.breaker_reset_s)
            return QAService(encoder, store, gen, k=3, device=dev, batcher=pool,
                             breakers=board, resilience=res_cfg)

        def routed():
            return [r["routed"] for r in pool.status()["replicas"]]

        # two prompts at once, one on each replica (session affinity on the
        # prefix key), their prefills on the two worker threads and streams
        keys = [next(f"fs{j}" for j in range(64)
                     if zlib.crc32(f"fs{j}".encode()) % pool.n_replicas == i)
                for i in range(pool.n_replicas)]
        routed_fs = routed()
        served = served_first_step(pool.submit_text, [
            (prompt, ids, {"prefix_key": key}) for (prompt, ids), key in zip(first, keys)])
        logit_check = [
            check_first_step(f"pool replica {i}", solo, got, token, len(ids))
            for i, (solo, (got, token), (_p, ids)) in enumerate(zip(solo_fs, served, first))]
        if [a - b for a, b in zip(routed(), routed_fs)] != [1] * pool.n_replicas:
            raise AssertionError(f"first-step prompts not one per replica: {routed()}")

        # ---- A: 16 concurrent /ask, 64 new tokens
        stats0 = pool.stats()
        paged0 = counts["flash_attention.decode_paged"]
        routed0 = routed()
        t0 = time.perf_counter()
        res = _resolve_all(_submit_round(make_qa(), QUESTIONS * 4))
        wall = time.perf_counter() - t0
        n_encodes += len(res)
        for i in range(pool.n_replicas):
            if not pool.drain(i, timeout=120)["drained"]:
                raise AssertionError(f"round A: replica {i} did not drain")
        occ = pool.kv_block_occupancy()
        for i in range(pool.n_replicas):
            pool.resume(i)
        steps = pool.stats() - stats0
        launches_a = counts["flash_attention.decode_paged"] - paged0
        rec = _round_record(res, wall)
        rec["routed"] = [a - b for a, b in zip(routed(), routed0)]
        rec["verify_steps"] = steps["verify_steps"]
        rec["blocks_after_drain"] = occ["blocks_used"]
        rec["prefix_pins"] = occ.get("prefix_blocks", 0)
        rounds["A"] = rec
        want = dec_cfg.num_layers * (steps["verify_steps"] + steps["decode_steps"]
                                     + steps["warmup_steps"])
        if rec["degraded"]:
            raise AssertionError(f"round A degraded answers: {rec['degraded']}")
        if min(rec["routed"]) < 1:
            raise AssertionError(f"round A left a replica without traffic: {rec['routed']}")
        if launches_a != want or want < 1:
            raise AssertionError(f"round A decode_paged launches {launches_a}, expected "
                                 f"{dec_cfg.num_layers} x verify steps = {want}")
        if occ["blocks_used"] != rec["prefix_pins"]:
            raise AssertionError(f"round A: {occ['blocks_used']} blocks in use after the "
                                 f"drain, the prefix caches pin {rec['prefix_pins']}")
        log(f"  round A: 16 /ask in {wall:.3f} s, p50 {rec['latency_p50_s']:.3f} s max "
            f"{rec['latency_max_s']:.3f} s, {rec['tokens_per_s']:.1f} answer tok/s, routed "
            f"{rec['routed']}, {rec['verify_steps']} verify steps, decode_paged launches "
            f"{want}, blocks after drain {occ['blocks_used']} = prefix pins")

        # rounds B-E answer 32 new tokens: the pool's default answer length
        pool.gen = dataclasses.replace(pool.gen, max_new_tokens=32)

        # ---- B: a worker crash mid-round
        mem_b0 = _reserved_bytes()
        deaths0 = sum(r["deaths"] for r in pool.status()["replicas"])
        gens0 = sum(r["generation"] for r in pool.status()["replicas"])
        seen = {}
        watching = threading.Event()

        def watch():
            while not watching.is_set():
                st = pool.status()["replicas"]
                now = time.perf_counter()
                if "death" not in seen and sum(r["deaths"] for r in st) > deaths0:
                    seen["death"] = now
                if ("death" in seen and sum(r["generation"] for r in st) > gens0
                        and all(r["state"] == "healthy" for r in st)):
                    seen["healthy"] = now
                    return
                time.sleep(0.01)

        watcher = threading.Thread(target=watch)
        watcher.start()
        t0 = time.perf_counter()
        plan = FaultPlan([FaultRule("serve.worker_loop", at_steps=(4,))])
        try:
            with plan:
                res = _resolve_all(_submit_round(make_qa(), QUESTIONS * 4))
            wall = time.perf_counter() - t0
            watcher.join(timeout=REBUILD_LIMIT_S + 60)
        finally:
            watching.set()
        n_encodes += len(res)
        rec = _round_record(res, wall)
        st = pool.status()["replicas"]
        rec["deaths"] = sum(r["deaths"] for r in st) - deaths0
        rec["rebuild_s"] = (seen["healthy"] - seen["death"]) if "healthy" in seen else None
        rec["fault_log"] = plan.log
        mem_b1 = _reserved_bytes()
        rec["memory_reserved_before"], rec["memory_reserved_after"] = mem_b0, mem_b1
        rounds["B"] = rec
        if not plan.log or rec["deaths"] < 1:
            raise AssertionError(f"round B: no replica died ({plan.log}, {st})")
        if set(rec["degraded"]) - {"replica_died"}:
            raise AssertionError(f"round B degraded for another reason: {rec['degraded']}")
        if rec["rebuild_s"] is None or rec["rebuild_s"] > REBUILD_LIMIT_S:
            raise AssertionError(f"round B: the dead replica was not healthy within "
                                 f"{REBUILD_LIMIT_S} s: {seen}, {st}")
        if mem_b1 - mem_b0 > pool_bytes:
            raise AssertionError(f"round B: reserved memory grew {mem_b1 - mem_b0} bytes, "
                                 f"more than one replica pool ({pool_bytes})")
        log(f"  round B: crash at {plan.log}, {rec['deaths']} death(s), rebuilt healthy in "
            f"{rec['rebuild_s']:.3f} s; 16 /ask: {rec['asks'] - sum(rec['degraded'].values())} "
            f"generated, degraded {rec['degraded']}, p50 {rec['latency_p50_s']:.3f} s; "
            f"reserved {mem_b0 / 2**30:.2f} -> {mem_b1 / 2**30:.2f} GiB")

        # ---- C: a rolling restart under 8 /ask
        mem_c0 = _reserved_bytes()
        gens0 = [r["generation"] for r in pool.status()["replicas"]]
        t0 = time.perf_counter()
        pend = _submit_round(make_qa(), QUESTIONS * 2)
        restart = pool.rolling_restart(timeout_per_replica=120)
        res = _resolve_all(pend)
        wall = time.perf_counter() - t0
        n_encodes += len(res)
        rec = _round_record(res, wall)
        gens1 = [r["generation"] for r in pool.status()["replicas"]]
        mem_c1 = _reserved_bytes()
        rec["restart"] = restart
        rec["memory_reserved_before"], rec["memory_reserved_after"] = mem_c0, mem_c1
        rounds["C"] = rec
        if not restart["ok"] or rec["degraded"] or any(b <= a for a, b in zip(gens0, gens1)):
            raise AssertionError(f"round C: restart {restart}, degraded {rec['degraded']}, "
                                 f"generations {gens0} -> {gens1}")
        if mem_c1 - mem_c0 > pool_bytes:
            raise AssertionError(f"round C: reserved memory grew {mem_c1 - mem_c0} bytes, "
                                 f"more than one replica pool ({pool_bytes})")
        log(f"  round C: rolling restart under 8 /ask in {wall:.3f} s, 0 dropped, 0 "
            f"degraded, generations {gens0} -> {gens1}; reserved {mem_c0 / 2**30:.2f} -> "
            f"{mem_c1 / 2**30:.2f} GiB")

        # ---- D: KV preemption in a separate 1-replica pool.  Its block pool
        # holds exactly the eight batch requests at their full length
        # (prompt + 64 new tokens + the grow margin, in 16-token blocks);
        # four interactive /ask arrive once each batch lane has 32 tokens
        prompts = [_pool_prompt(qa_solo, q) for q in QUESTIONS * 2]
        n_encodes += len(prompts)
        chunk, spec_k, bs, batch_new = 16, gen.gen.speculative_k, 16, 64
        margin = 2 * (chunk + max(spec_k, 1)) + 2
        lens = [len(gen.encode_prompt(p, 1024 - 2 - spec_k)) for p in prompts]
        n_blocks = sum(-(-(n + batch_new + margin) // bs) for n in lens)
        gen_d = GenerateEngine(
            dec_cfg, dataclasses.replace(gen.gen, max_new_tokens=32, kv_block_size=bs,
                                         kv_pool_tokens=n_blocks * bs, prefix_cache=False),
            params=gen.params, tokenizer=gen.tokenizer, device=dev,
        )
        pool_d = EnginePool(gen_d, cfg=PoolConfig(replicas=1, n_slots=16),
                            qos=QoSConfig(preemption="on"), chunk=chunk,
                            cache_len=1024, device=dev)
        bd = pool_d._replicas[0].batcher
        if bd.n_blocks != n_blocks or bd._grow_margin != margin:
            raise AssertionError(f"round D pool sized {bd.n_blocks} blocks (margin "
                                 f"{bd._grow_margin}), expected {n_blocks} ({margin})")
        qa_d = QAService(encoder, store, gen_d, k=3, device=dev, batcher=pool_d,
                         breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                               res_cfg.breaker_reset_s),
                         resilience=res_cfg)
        preempted0 = DEFAULT_REGISTRY.counter("qos_preempted").value
        t0 = time.perf_counter()
        batch = [pool_d.submit_text(p, max_new_tokens=batch_new, req_class="batch",
                                    deadline=Deadline.after(120)) for p in prompts]
        end = time.monotonic() + 120
        while (min(len(h._req.tokens) for h in batch) < 32
               and time.monotonic() < end):
            time.sleep(0.005)
        before = [list(h._req.tokens) for h in batch]
        res = _resolve_all(_submit_round(qa_d, QUESTIONS))
        n_encodes += len(res)
        outs = [h.result(timeout=120) for h in batch]
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while pool_d.n_active and time.monotonic() < deadline:
            time.sleep(0.01)
        occ_d = pool_d.kv_block_occupancy()
        stats_d = pool_d.stats()
        rec = _round_record(res, wall)
        rec.update({
            "pool_blocks": n_blocks, "prompt_tokens": lens, "grow_margin": margin,
            "batch_tokens_at_arrival": [len(b) for b in before],
            "batch_tokens": [len(o) for o in outs],
            "preempted": stats_d["preempted"],
            "qos_preempted": DEFAULT_REGISTRY.counter("qos_preempted").value - preempted0,
            "blocks_after": occ_d["blocks_used"],
        })
        rounds["D"] = rec
        kept = all(o[: len(b)] == b for o, b in zip(outs, before))
        if rec["qos_preempted"] < 1 or rec["preempted"] < 1:
            raise AssertionError(f"round D: nothing was preempted: {rec}")
        # every batch result() returned (none failed); a lane may end early
        # on EOS, so lengths are reported, not asserted
        if rec["degraded"] or not kept:
            raise AssertionError(f"round D: degraded {rec['degraded']}, tokens kept {kept}, "
                                 f"batch lengths {rec['batch_tokens']}")
        if occ_d["blocks_used"] != 0:
            raise AssertionError(f"round D: {occ_d['blocks_used']} blocks leaked")
        log(f"  round D: {n_blocks}-block pool (prompts {lens}), 8 batch requests at "
            f"{rec['batch_tokens_at_arrival']} tokens when 4 interactive /ask arrived; "
            f"{rec['preempted']} preempted, interactive p50 {rec['latency_p50_s']:.3f} s, "
            f"every batch request complete ({rec['batch_tokens']} tokens) with its "
            f"earlier tokens kept, 0 blocks leaked")
        pool_d.stop()
        pool_d = None

        # ---- E: the degraded path (decoder outage, then the breaker)
        board = BreakerBoard(res_cfg.breaker_failure_threshold, BREAKER_RESET_S)
        qa_e = make_qa(board)
        plan = FaultPlan.from_env({"DOCQA_FAULTS": "decoder:p=1"})
        t0 = time.perf_counter()
        faults.install(plan)
        try:
            outs = [qa_e.ask(q, deadline=Deadline.after(POOL_DEADLINE_S))
                    for q in QUESTIONS * 2]
        finally:
            faults.uninstall(plan)
        reasons = [o.get("degrade_reason") for o in outs]
        time.sleep(BREAKER_RESET_S + 0.1)
        healthy = qa_e.ask(QUESTIONS[0], deadline=Deadline.after(POOL_DEADLINE_S))
        n_encodes += len(outs) + 1
        want_reasons = (["decoder_error"] * res_cfg.breaker_failure_threshold
                        + ["decoder_breaker_open"] * (len(outs) - res_cfg.breaker_failure_threshold))
        rounds["E"] = {"reasons": reasons, "after_reset": sorted(healthy),
                       "breaker": board.states(), "wall_s": time.perf_counter() - t0}
        if reasons != want_reasons or sorted(healthy) != ["answer", "sources"]:
            raise AssertionError(f"round E: reasons {reasons}, expected {want_reasons}; "
                                 f"after the reset {healthy}")
        if board.states() != {"decoder": "closed"}:
            raise AssertionError(f"round E: breaker {board.states()} after the reset")
        log(f"  round E: decoder outage -> {reasons}; after the reset a plain "
            f"{{answer, sources}}, breaker {board.states()}")

        # ---- the launch identity over the whole phase, all three pools
        # (their construction warm-ups included)
        launches = dict(counts)
        steps = pool.stats() + stats_d + stats_1
        want = {
            "flash_attention.decode_paged": dec_cfg.num_layers * (
                steps["verify_steps"] + steps["decode_steps"] + steps["warmup_steps"]),
            "flash_attention.prefill": enc_layers * n_encodes,
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want:
            raise AssertionError(f"pool phase launches {got}, expected {want}")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        summary = {
            "rounds": rounds,
            "routed": [r["routed"] for r in pool.status()["replicas"]],
            "deaths": sum(r["deaths"] for r in pool.status()["replicas"]),
            "rebuild_s": rounds["B"]["rebuild_s"],
            "first_step": logit_check,
            "preempted": rounds["D"]["preempted"],
            "degraded": dict(sum((collections.Counter(rnd.get("degraded", {}))
                                  for rnd in rounds.values()), collections.Counter(reasons))),
            "memory_reserved_gib": {
                f"{r}_{w}": rounds[r][f"memory_reserved_{w}"] / 2**30
                for r in ("B", "C") for w in ("before", "after")},
            "pool_bytes": pool_bytes,
            "peak_device_gib": peak_gib,
            "launches_by_path": got,
            "steps": dict(steps),
            "build_s": build_s,
        }
        log(f"  pool phase: launches {got} (= {dec_cfg.num_layers} x "
            f"{steps['verify_steps']} verify + {steps['warmup_steps']} warm-up steps over "
            f"the three pools), peak device memory {peak_gib:.2f} GiB")
        return {"summary": summary, "launches": launches}
    finally:
        if pool_d is not None:
            pool_d.stop()
        pool.stop()


# ---- phase 7: document ingest at full width ---------------------------------

INGEST_DOCS = 512
INGEST_MIN_CHARS = 2000  # about 4-5 chunks of 500 characters a note
INGEST_TIMEOUT_S = 300.0
CPU_CHECK_DOCS = 64
SELF_RETRIEVAL_ROWS = 32
CONCURRENT_DOCS = 64
MONTHS_FR = ("janvier", "février", "mars", "avril", "mai", "juin", "juillet",
             "août", "septembre", "octobre", "novembre", "décembre")


def _docx_bytes(paragraphs):
    """A minimal .docx (zip with word/document.xml), built as the
    reference's tests build one."""
    xml = (b'<?xml version="1.0"?><w:document><w:body>'
           + b"".join(b"<w:p><w:r><w:t>" + p.encode() + b"</w:t></w:r></w:p>"
                      for p in paragraphs)
           + b"</w:body></w:document>")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("word/document.xml", xml)
    return buf.getvalue()


def _pdf_bytes(lines):
    """A text-layer .pdf (one FlateDecode content stream of Tj lines), built
    as the reference's tests build one; parentheses would end a PDF string,
    so the lines carry none."""
    content = b"BT /F1 12 Tf " + b" ".join(
        b"(" + ln.encode() + b") Tj T*" for ln in lines) + b" ET"
    stream = zlib.compress(content)
    return (b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(stream)).encode()
            + b" /Filter /FlateDecode >>\nstream\n" + stream
            + b"endstream\nendobj\ntrailer\n%%EOF")


def ingest_corpus(rng, n, prefix):
    """``n`` uploads: notes of the port's synthetic generator (training
    lexicons) taking sentences until they reach INGEST_MIN_CHARS, each
    under a header line with a seeded phone number, email address and
    French date; notes 1 and 2 of every 64 go up as .docx and as .pdf,
    the rest as .txt."""
    docs = []
    for i in range(n):
        phone = f"0{int(rng.integers(1, 10))} " + " ".join(
            f"{int(rng.integers(0, 100)):02d}" for _ in range(4))
        email = f"dossier{int(rng.integers(1000, 9999))}.{i}@chu-{int(rng.integers(1, 99))}.fr"
        date = (f"{int(rng.integers(1, 29))} {MONTHS_FR[int(rng.integers(12))]} "
                f"{int(rng.integers(2015, 2027))}")
        lines = [f"Tél : {phone} — courriel : {email} — consultation du {date}."]
        while len("\n".join(lines)) < INGEST_MIN_CHARS:
            text, _spans = datagen.generate_example(rng, datagen.TRAIN_LEXICONS)
            lines.append(text.replace("(", " ").replace(")", " "))
        kind = {1: "docx", 2: "pdf"}.get(i % 64, "txt")
        data = (_docx_bytes(lines) if kind == "docx" else _pdf_bytes(lines)
                if kind == "pdf" else "\n".join(lines).encode("utf-8"))
        docs.append({"filename": f"{prefix}-{i:04d}.{kind}", "data": data,
                     "phi": (phone, email, date)})
    return docs


def _memo_logits(engine):
    """Make ``engine.ner_logits`` compute each (ids, lengths) batch once;
    returns the memo (batch key -> logits)."""
    forward, memo = engine.ner_logits, {}

    def cached(ids, lengths):
        key = (ids.tobytes(), lengths.tobytes())
        if key not in memo:
            memo[key] = forward(ids, lengths)
        return memo[key]

    engine.ner_logits = cached
    return memo


def _hold_tagger_batch(cpu, batch):
    """One tagger batch as the card ran it (``batch``: its texts, ids,
    lengths and bf16 logits) against the CPU engine's float32 forward on
    the same ids (``cpu.ner_logits``, memoised by the caller).  The logits must be
    within ``FIRST_STEP_RTOL`` relative RMS over the live rows; the word
    labels are compared with phases 5-6's decisive-gap rule: a word whose
    two largest CPU logits differ by less than twice the largest |card -
    CPU| logit difference of its window may take either label, every other
    word must take the same label on both.  Returns (relative RMS, words,
    words tied, labels that differ, max |diff|)."""
    segments, ids, lengths, token_idx = cpu.windows(batch["texts"])
    if not (np.array_equal(ids, batch["ids"]) and np.array_equal(lengths, batch["lengths"])):
        raise AssertionError("a tagger batch does not repack to the ids it ran on the card")
    lc, lp = batch["logits"], cpu.ner_logits(ids, lengths)
    valid = np.arange(ids.shape[1])[None, :] < lengths[:, None]
    rel = float(np.linalg.norm((lc - lp)[valid]) / np.linalg.norm(lp[valid]))
    if not rel <= FIRST_STEP_RTOL:
        raise AssertionError(
            f"tagger logits of a {ids.shape[0]} x {ids.shape[1]} batch, card vs CPU: "
            f"relative RMS {rel:.3e} (tolerance {FIRST_STEP_RTOL})")
    n_words = n_tied = n_flipped = 0
    max_diff = 0.0
    for si, (di, seg) in enumerate(segments):
        n = int(lengths[si])
        diff = float(np.abs(lc[si, :n] - lp[si, :n]).max())
        max_diff = max(max_diff, diff)
        for wi, (_w, s, e) in enumerate(seg):
            ti = token_idx[si][wi]
            top2 = np.sort(lp[si, ti])[-2:]
            tied = top2[1] - top2[0] < 2 * diff
            n_words += 1
            n_tied += int(tied)
            if int(lc[si, ti].argmax()) != int(lp[si, ti].argmax()):
                n_flipped += 1
                if not tied:
                    raise AssertionError(
                        f"the NER label of word [{s}, {e}) of document {di} differs "
                        f"between the card and the CPU past a decisive gap "
                        f"({top2[1] - top2[0]:.3e} >= 2 x {diff:.3e})")
    return rel, n_words, n_tied, n_flipped, max_diff


def run_ingest_path(counts, qa_solo):
    """Phase 7: ``DocumentPipeline.ingest_document`` at full width on phase
    3's MiniLM encoder and 1,000,000-row store, with ``DeidEngine(NERConfig())``
    (4 layers, hidden 256, 8 heads, 512 positions, bf16; a seeded random
    tagger: plumbing mode), ``make_broker(BrokerConfig())`` (prefetch 8) and
    ``DocumentRegistry("sqlite://")``.  The launch counts are set to 0 just
    before the 512 uploads and read once all are INDEXED; then the rows,
    the masked texts against the CPU in float32, self-retrieval and an
    /ask over an ingested chunk are checked, and a round of 64 more uploads
    runs beside 8 /ask through a 1-replica pool."""
    dev = torch.device("cuda")
    gen = qa_solo.generator
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    enc_layers = encoder.cfg.num_layers
    ner_cfg = NERConfig()
    ner_params = init_ner_params(ner_cfg, seed=11)
    deid = DeidEngine(ner_cfg, params=ner_params, device=dev)
    cfg = Config(encoder=encoder.cfg, ner=ner_cfg, store=store.cfg)
    registry = DocumentRegistry(cfg.registry.url)  # "sqlite://": in memory
    pipe = DocumentPipeline(cfg, make_broker(cfg.broker), registry, deid, encoder, store)
    rng = np.random.default_rng(2024)
    docs = ingest_corpus(rng, INGEST_DOCS, "ingest")
    extra = ingest_corpus(rng, CONCURRENT_DOCS, "concurrent")
    texts = {d["filename"]: extract_text_ex(d["data"], d["filename"])[0]
             for d in docs + extra}
    if any(not t for t in texts.values()):
        raise AssertionError("a generated upload did not extract")

    # BASELINE config 2, reported: one deidentify_batch of 32 notes, and
    # the tagger's forward over their window batch timed with CUDA events
    batch32 = [texts[d["filename"]] for d in docs[:32]]
    deid.deidentify_batch(batch32)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deid.deidentify_batch(batch32)
    batch32_wall = time.perf_counter() - t0
    _seg, ids32, len32, _tidx = deid.windows(batch32)
    ids_t = torch.from_numpy(ids32).long().to(dev)
    len_t = torch.from_numpy(len32).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with torch.inference_mode():
        # ~20 ms of spin: the host enqueues the forward's ~150 launches
        # behind it, so the events see device time only
        ner_ms = time_ms(lambda: ner_forward(deid.params, ner_cfg, ids_t, len_t), flush,
                         reps=10, spin_cycles=40_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ner_forward(deid.params, ner_cfg, ids_t, len_t)
        torch.cuda.synchronize()
        ner_wall_ms = (time.perf_counter() - t0) * 100
    del flush
    log(f"  deidentify_batch of 32 notes ({ids32.shape[0]} windows x {ids32.shape[1]} "
        f"tokens): {batch32_wall * 1e3:.1f} ms wall; tagger forward {ner_ms:.3f} ms of "
        f"device time (CUDA events), {ner_wall_ms:.3f} ms wall a forward back to back")

    # instruments of the counted run: masked texts, INDEXED times, spans,
    # and every tagger batch the deid worker served (texts, ids, lengths
    # and the logits it masked with)
    masked, indexed_at, served_spans, served = {}, {}, [0], []
    deidentify, set_status = deid.deidentify_batch, registry.set_status_unless_deleted
    ner_results, ner_logits = deid._ner_results, deid.ner_logits

    def recording_deidentify(batch):
        out = deidentify(batch)
        masked.update(zip(batch, out))
        return out

    def recording_status(doc_id, status, n_chunks=None):
        ok = set_status(doc_id, status, n_chunks=n_chunks)
        if status == reg.INDEXED:
            indexed_at[doc_id] = time.perf_counter()
        return ok

    def recording_logits(ids, lengths):
        out = ner_logits(ids, lengths)
        served.append({"ids": ids, "lengths": lengths, "logits": out})
        return out

    def recording_spans(batch):
        n = len(served)
        out = ner_results(batch)
        served_spans[0] += sum(map(len, out))
        if len(served) > n:  # one deid worker: the forward this call made
            served[n]["texts"] = list(batch)
        return out

    def untap():
        deid.deidentify_batch, deid._ner_results = deidentify, ner_results
        deid.ner_logits = ner_logits
        registry.set_status_unless_deleted = set_status

    deid.deidentify_batch = recording_deidentify
    registry.set_status_unless_deleted = recording_status
    deid._ner_results, deid.ner_logits = recording_spans, recording_logits
    pool = None
    try:
        pipe.start()
        rows0, nf0, ne0 = store.count, deid.forwards, encoder.forwards
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.clear()
        t_start = time.perf_counter()
        uploaded = []
        for d in docs:
            rec = pipe.ingest_document(d["filename"], d["data"])
            uploaded.append((rec.doc_id, time.perf_counter()))
        t_uploaded = time.perf_counter() - t_start
        deadline = time.perf_counter() + INGEST_TIMEOUT_S
        for doc_id, _t in uploaded:
            if not pipe.wait_indexed(doc_id, timeout=max(0.0, deadline - time.perf_counter())):
                raise AssertionError(
                    f"{doc_id} not INDEXED: {registry.get(doc_id).status} "
                    f"({registry.get(doc_id).status_detail})")
        wall = max(indexed_at[d] for d, _t in uploaded) - t_start
        launches = dict(counts)
        n_ner, n_enc = deid.forwards - nf0, encoder.forwards - ne0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        untap()

        # ---- what must hold over the 512 uploads ----
        want = {"flash_attention.prefill": ner_cfg.num_layers * n_ner + enc_layers * n_enc,
                "flash_attention.decode": 0, "flash_attention.decode_paged": 0,
                "flash_attention.simt": 0}
        got = {key: launches.get(key, 0) for key in want}
        if got != want or launches.get("flash_attention", 0) != want["flash_attention.prefill"]:
            raise AssertionError(
                f"ingest launches {launches}, expected {want} ({n_ner} tagger forwards "
                f"x {ner_cfg.num_layers} layers + {n_enc} encoder forwards x {enc_layers})")
        new_rows = store.metadata_rows()[rows0:]
        n_chunks = sum(registry.get(d).n_chunks for d, _t in uploaded)
        masked_docs = [masked[texts[d["filename"]]] for d in docs]
        n_expected = sum(len(chunk_text(m, cfg.chunk)) for m in masked_docs)
        if not (n_chunks == len(new_rows) == store.count - rows0 == n_expected):
            raise AssertionError(
                f"registry n_chunks {n_chunks}, store rows gained {store.count - rows0}, "
                f"chunk_text over the masked texts {n_expected}")
        joined = "\x00".join(r["text_content"] for r in new_rows)
        leaked = [s for d in docs for s in d["phi"] if s in joined]
        if leaked:
            raise AssertionError(f"header PHI survived into the store: {leaked[:5]}")
        lat = sorted(indexed_at[d] - t for d, t in uploaded)
        spans = {name: DEFAULT_REGISTRY.histogram(f"{name}_ms").summary()["p50"]
                 for name in ("extract", "deid_batch", "index_batch")}
        log(f"  {INGEST_DOCS} uploads ({sum(d['filename'].endswith('.docx') for d in docs)} "
            f"docx, {sum(d['filename'].endswith('.pdf') for d in docs)} pdf) INDEXED in "
            f"{wall:.2f} s (uploads queued in {t_uploaded:.2f} s): "
            f"{INGEST_DOCS / wall:.1f} docs/s, {len(new_rows) / wall:.1f} chunks/s; upload -> "
            f"INDEXED p50 {statistics.median(lat):.3f} s max {lat[-1]:.3f} s; span p50 "
            f"extract {spans['extract']:.2f} ms, deid_batch {spans['deid_batch']:.1f} ms, "
            f"index_batch {spans['index_batch']:.1f} ms; {n_ner} tagger + {n_enc} encoder "
            f"forwards, launches {got}; {served_spans[0]} NER spans served; peak device "
            f"memory {peak_gib:.2f} GiB")

        # ---- served tagger batches against the port on the CPU in float32 ----
        # the batches of the shape the deid worker served most (8 windows x
        # 512: the K1 launch the path made most), in order, until they hold
        # CPU_CHECK_DOCS documents: their masked texts, their logits and
        # their word labels as served, against the CPU on the same batches
        shapes = collections.Counter(bt["ids"].shape for bt in served)
        served_shape, n_at_shape = shapes.most_common(1)[0]
        checked, n_docs = [], 0
        for bt in served:
            if bt["ids"].shape == served_shape and n_docs < CPU_CHECK_DOCS:
                checked.append(bt)
                n_docs += len(bt["texts"])
        cpu_cfg = dataclasses.replace(ner_cfg, dtype="float32")
        cpu = DeidEngine(cpu_cfg, params=ner_params, device="cpu")
        _memo_logits(cpu)  # one float32 forward a batch serves both checks
        t0 = time.perf_counter()
        held = []
        for bt in checked:
            if cpu.deidentify_batch(bt["texts"]) != [masked[t] for t in bt["texts"]]:
                raise AssertionError(
                    "the masked texts of a served batch differ between the card's "
                    "pipeline and the CPU in float32")
            held.append(_hold_tagger_batch(cpu, bt))
        # BASELINE config 2's batch (32 notes, 32 windows x 512: two
        # warpgroups a block), on the pipeline's engine after the run
        card32 = {"texts": batch32, "ids": ids32, "lengths": len32,
                  "logits": deid.ner_logits(ids32, len32)}
        rel32, words32, tied32, flipped32, diff32 = _hold_tagger_batch(cpu, card32)
        cpu_s = time.perf_counter() - t0
        rel = max(h[0] for h in held)
        n_words, n_tied, n_flipped = (sum(h[i] for h in held) for i in (1, 2, 3))
        max_diff = max(h[4] for h in held)
        log(f"  served tagger batches: {len(served)}, shapes {dict(shapes)}; "
            f"{len(checked)} of shape {served_shape} holding {n_docs} documents held "
            f"against the CPU in float32: masked texts identical, logits relative RMS "
            f"<= {rel:.3e} (tolerance {FIRST_STEP_RTOL}), word labels equal but "
            f"{n_flipped} of {n_words}, all among {n_tied} tied words (max |logit diff| "
            f"{max_diff:.3e}); the 32-window batch: relative RMS {rel32:.3e}, labels "
            f"equal but {flipped32} of {words32}, all among {tied32} tied; "
            f"CPU check {cpu_s:.1f} s")

        # ---- self-retrieval over the whole store, and /ask over a chunk ----
        picks = np.random.default_rng(5).choice(len(new_rows), SELF_RETRIEVAL_ROWS,
                                                replace=False)
        queries = [new_rows[i]["text_content"] for i in picks]
        hits = qa_solo.retriever.search_texts(queries, k=2)
        missed = [i for i, (q, h) in enumerate(zip(queries, hits))
                  if h[0].metadata.get("text_content") != q]
        margins = [h[0].score - h[1].score for h in hits]
        if missed:
            raise AssertionError(f"self-retrieval missed rank 1 for {len(missed)} of "
                                 f"{SELF_RETRIEVAL_ROWS} rows over {store.count} rows")
        row = new_rows[int(picks[0])]
        out = qa_solo.ask(row["text_content"])
        _no_degraded("/ask over an ingested chunk", [out])
        if row["source"] not in out["sources"]:
            raise AssertionError(f"/ask over a chunk of {row['source']} cites {out['sources']}")
        log(f"  self-retrieval: {SELF_RETRIEVAL_ROWS} of {SELF_RETRIEVAL_ROWS} new rows "
            f"first over {store.count} rows (rank 1 - rank 2 score margin min "
            f"{min(margins):.4f}); /ask over a chunk of {row['source']} cites {out['sources']}")

        # ---- /ask beside a concurrent ingest, through a 1-replica pool ----
        res_cfg = ResilienceConfig()
        pool = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=8), qos=QoSConfig(),
                          chunk=16, cache_len=1024, device=dev)
        qa = QAService(encoder, store, gen, k=3, device=dev, batcher=pool,
                       breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                             res_cfg.breaker_reset_s),
                       resilience=res_cfg)
        questions = list(QUESTIONS) * 2
        t0 = time.perf_counter()
        alone = _round_record(_resolve_all(_submit_round(qa, questions)),
                              time.perf_counter() - t0)
        counts.clear()
        nf1, ne1 = deid.forwards, encoder.forwards
        extra_ids = []

        def upload():
            for d in extra:
                extra_ids.append(pipe.ingest_document(d["filename"], d["data"]).doc_id)

        uploader = threading.Thread(target=upload)
        t0 = time.perf_counter()
        uploader.start()
        beside = _round_record(_resolve_all(_submit_round(qa, questions)),
                               time.perf_counter() - t0)
        uploader.join(timeout=INGEST_TIMEOUT_S)
        for doc_id in extra_ids:
            if not pipe.wait_indexed(doc_id, timeout=INGEST_TIMEOUT_S):
                raise AssertionError(f"concurrent upload {doc_id} not INDEXED")
        concurrent_wall = time.perf_counter() - t0
        round_launches = dict(counts)
        if len(extra_ids) != CONCURRENT_DOCS or alone["degraded"] or beside["degraded"]:
            raise AssertionError(f"concurrent round: {len(extra_ids)} uploads, /ask "
                                 f"degraded alone {alone['degraded']} beside {beside['degraded']}")
        log(f"  8 /ask through a 1-replica pool: alone p50 {alone['latency_p50_s']:.3f} s "
            f"max {alone['latency_max_s']:.3f} s; beside {CONCURRENT_DOCS} uploads p50 "
            f"{beside['latency_p50_s']:.3f} s max {beside['latency_max_s']:.3f} s; all "
            f"{CONCURRENT_DOCS} INDEXED {concurrent_wall:.2f} s after the round began "
            f"({deid.forwards - nf1} tagger + {encoder.forwards - ne1} encoder forwards)")
    finally:
        if pool is not None:
            pool.stop()
        untap()
        pipe.stop()
    summary = {
        "docs": INGEST_DOCS, "chunks": len(new_rows), "wall_s": wall,
        "uploads_queued_s": t_uploaded,
        "docs_per_s": INGEST_DOCS / wall, "chunks_per_s": len(new_rows) / wall,
        "upload_to_indexed_p50_s": statistics.median(lat),
        "upload_to_indexed_max_s": lat[-1],
        "span_p50_ms": spans, "tagger_forwards": n_ner, "encoder_forwards": n_enc,
        "ner_spans_served": served_spans[0], "peak_device_gib": peak_gib,
        "deidentify_batch_32_wall_ms": batch32_wall * 1e3,
        "ner_forward_32_ms": ner_ms, "ner_forward_32_wall_ms": ner_wall_ms,
        "ner_batch_shape": list(ids32.shape),
        "tagger_batches_served": {"x".join(map(str, k)): v for k, v in shapes.items()},
        "cpu_check": {"served_shape": list(served_shape), "batches": len(checked),
                      "docs": n_docs, "masked_texts_identical": True,
                      "words": n_words, "tied_words": n_tied, "labels_differing": n_flipped,
                      "max_abs_logit_diff": max_diff, "logits_rel_rms_max": rel,
                      "batch_32": {"logits_rel_rms": rel32, "words": words32,
                                   "tied_words": tied32, "labels_differing": flipped32,
                                   "max_abs_logit_diff": diff32},
                      "tolerance_rel_rms": FIRST_STEP_RTOL, "seconds": cpu_s},
        "self_retrieval_min_margin": min(margins),
        "ask_alone": alone, "ask_beside_ingest": beside,
        "concurrent_docs_indexed_s": concurrent_wall,
    }
    return {"summary": summary, "launches": launches, "round_launches": round_launches}


# ---- phase 8: observability over the pool and ingest ----------------------------

# the spans every traced /ask of the pool path must hold (submitted and
# resolved as the reference app's /ask does: no qa_e2e span)
ASK_SPANS = frozenset({
    "ask", "qa_retrieve", "fused_query", "dispatch:retrieve",
    "serve_queue_wait", "serve_prefill", "serve_decode_chunk", "serve_result_wait",
})
# the spans of one ingested document's timeline
DOC_SPANS = frozenset({"ingest", "extract", "deid_batch", "index_batch"})
PROFILED_VERIFY_STEPS = 4
# the reference's recorder overhead budget: reported beside the measured
# difference, never asserted (the host's clock spreads 2x between runs)
RECORDER_BUDGET = 0.02
# recorder off/on round pairs, alternating
RECORDER_PAIRS = 3
# the profiler range name of one spine item in the profiled window
ITEM_RANGE = "smoke_spine_item_"
# a decode chunk's kernel busy time (CUPTI) may exceed its CUDA-event span
# by no more than the two clocks' resolution
SPAN_REL_SLACK = 1e-3
SPAN_ABS_SLACK_US = 5.0
# the spine handoff reading: items a pass, passes a side
HANDOFF_ITEMS = 40
HANDOFF_ROUNDS = 2


class _Traced:
    """A PendingAnswer resolved under its /ask trace, as the HTTP layer
    resolves it."""

    def __init__(self, ctx, pending):
        self.ctx, self.pending = ctx, pending

    def resolve(self, timeout):
        return obs.call_in(self.ctx, self.pending.resolve, timeout)


def _traced_round(qa, questions):
    """Round A1's /ask, each under its own trace with an interactive cost
    record (``obs.new_trace`` + ``obs.cost_open``, the reference app's
    /ask), finished once answered.  With the recorder off every trace is
    None and the round runs untraced.  Returns (results, traces)."""
    pend, ctxs = [], []
    for q in questions:
        t0 = time.perf_counter()
        ctx = obs.new_trace("ask")
        obs.cost_open(ctx, "interactive")
        pending = obs.call_in(ctx, qa.ask_submit, q,
                              deadline=Deadline.after(POOL_DEADLINE_S))
        pend.append((q, t0, _Traced(ctx, pending)))
        ctxs.append(ctx)
    results = _resolve_all(pend)
    for ctx in ctxs:
        obs.finish(ctx)
    return results, [c.trace for c in ctxs if c is not None]


def _spine_waits(stats):
    """Per-stage items, mean queue wait and mean device time of a spine
    snapshot, with its lane count."""
    return {
        "n_lanes": stats["n_lanes"],
        "stages": {name: {key: row[key] for key in (
            "count", "queue_wait_mean_ms", "device_mean_ms")}
            for name, row in sorted(stats["stages"].items())},
    }


def _log_spine_waits(where, waits):
    log(f"  spine over {where} ({waits['n_lanes']} lanes): " + ", ".join(
            f"{name} {row['count']} items, queue wait mean "
            f"{row['queue_wait_mean_ms']:.3f} ms, device mean {row['device_mean_ms']:.3f} ms"
            for name, row in waits["stages"].items()))


def _item_kernel_busy_us(events):
    """Kernel time (us) per profiled spine item, from a torch.profiler
    Chrome trace: a kernel belongs to the item whose ``ITEM_RANGE`` range
    holds its launch (joined on the CUPTI correlation id), on the same
    thread when the trace's thread ids join, else by time alone.  Returns
    ``({item: us}, how)``."""
    ranges = [(int(e["name"][len(ITEM_RANGE):]), str(e.get("tid")), e["ts"],
               e["ts"] + e.get("dur", 0.0))
              for e in events
              if e.get("ph") == "X" and str(e.get("name", "")).startswith(ITEM_RANGE)]
    launches = {e["args"]["correlation"]: (str(e.get("tid")), e["ts"])
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    by_tid = bool({r[1] for r in ranges} & {tid for tid, _ in launches.values()})
    busy = collections.defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        for n, r_tid, t0, t1 in ranges:
            if t0 <= ts <= t1 and (r_tid == tid or not by_tid):
                busy[n] += e.get("dur", 0.0)
                break
    return dict(busy), "thread and time" if by_tid else "time"


def spine_handoff(device, items=HANDOFF_ITEMS, rounds=HANDOFF_ROUNDS):
    """What crossing to a spine lane thread costs an item on this host:
    ``items`` small work items (one 64 x 64 matmul) on a fresh spine of
    ``DEFAULT_LANES`` slots, beside a thread running a busy Python loop (as
    ingest's deid worker runs beside its index worker), once on a lane
    thread (``submit(...).result()``) and once on the caller (``run``) a
    round, alternating which goes first.  Returns, per side, the ms an item
    and the busy loop's iterations a second, one entry a round."""
    x = torch.ones(64, 64, device=device)
    spine = DispatchSpine()
    out = {"lane": [], "caller": []}

    def one(on_lane):
        stop, count = threading.Event(), [0]

        def busy():
            while not stop.is_set():
                sum(i * i for i in range(2000))
                count[0] += 1

        loop = threading.Thread(target=busy)
        loop.start()
        t0 = time.perf_counter()
        try:
            for _ in range(items):
                if on_lane:
                    spine.submit("handoff", lambda: (x @ x).sum(), device=device).result()
                else:
                    spine.run("handoff", lambda: (x @ x).sum(), device=device)
        finally:
            wall = time.perf_counter() - t0
            stop.set()
            loop.join()
        return {"ms_per_item": wall / items * 1e3, "busy_loop_per_s": count[0] / wall}

    try:
        for r in range(rounds):
            for side in (("lane", "caller") if r % 2 == 0 else ("caller", "lane")):
                out[side].append(one(side == "lane"))
    finally:
        spine.close()
    return out


def _mfu_table(stats):
    lines = [f"    {'stage':<22} {'calls':>6} {'device_s':>10} {'GFLOP':>10} "
             f"{'MFU':>9} {'FLOP/B':>8} bound"]
    for stage, row in stats["stages"].items():
        mfu = "-" if row["mfu"] is None else f"{row['mfu']:.6f}"
        if "mfu_raw_invalid" in row:
            mfu = f"invalid {row['mfu_raw_invalid']:.3f}"
        inten = row["intensity_flops_per_byte"]
        lines.append(
            f"    {stage:<22} {row['calls']:>6} {row['device_s']:>10.6f} "
            f"{row['flops'] / 1e9:>10.3f} {mfu:>9} "
            f"{'-' if inten is None else f'{inten:.1f}':>8} {row['roofline_bound'] or '-'}")
    return "\n".join(lines)


def run_obs_path(counts, qa_solo):
    """Phase 8: observability over phase 6's 1-replica pool (16 slots,
    chunk 16, capacity 1,024, K=4) and round A1 (16 /ask, 64 new tokens),
    then one upload through a pipeline configured as phase 7's.

    The round runs ``RECORDER_PAIRS`` times with the recorder off and on,
    alternating (the median difference reported against the reference's
    2 % budget).  Around the last traced round the launch counts,
    the spine's stage series, the observatory and the cost ledger are set
    to 0; after it: every /ask trace complete with ``ASK_SPANS``; the
    observatory's peak names the card; the costed stages with no uncosted
    call and no MFU above 1; every spine item's device time within its
    submit-to-done wall time; the per-class device ms equal to the spine's
    series; a telemetry tick over the pool, the spine, a broker and the
    recorder rendering lint-clean Prometheus text; K1's launch identity.
    A profiler window around at least ``PROFILED_VERIFY_STEPS`` verify
    steps names K1's decode kernel; every decode chunk fetched in it
    launched kernels whose CUPTI time is nonzero and at most its
    CUDA-event span (an event pair on the wrong stream would read near 0);
    the document's timeline holds ``DOC_SPANS``.  Reports what a spine item
    pays to cross to a lane thread (:func:`spine_handoff`)."""
    gen = qa_solo.generator
    dev = gen.device
    dec_cfg = gen.cfg
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    enc_layers = encoder.cfg.num_layers
    res_cfg = ResilienceConfig()
    spine = get_spine()
    card = torch.cuda.get_device_name(0)
    pool1 = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=16), qos=QoSConfig(),
                       chunk=16, cache_len=1024, device=dev)
    pipe = None
    try:
        pool1.annotate_costs()
        encoder.annotate_costs()
        qa_solo.retriever.annotate_costs()
        qa1 = QAService(encoder, store, gen, k=3, device=dev, batcher=pool1,
                        breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                              res_cfg.breaker_reset_s),
                        resilience=res_cfg)
        questions = list(QUESTIONS) * 4

        # ---- the recorder off and on, alternating (reported); the last
        # round, recorder on, is the counted and checked one
        pairs = []
        items = []
        settle = spine._settle

        def tapped(item):
            # the item's wall time runs to the end of its accounting
            first = not item.settled
            settle(item)
            if first:
                items.append((item.stage, item.device_s,
                              time.perf_counter() - item.t_submit))

        for i in range(RECORDER_PAIRS):
            obs.set_enabled(False)
            try:
                t0 = time.perf_counter()
                res, traces = _traced_round(qa1, questions)
                off = _round_record(res, time.perf_counter() - t0)
            finally:
                obs.set_enabled(True)
            if traces:
                raise AssertionError(f"recorder off, yet {len(traces)} traces opened")
            counted = i == RECORDER_PAIRS - 1
            if counted:
                spine.reset_stats()
                obs.DEFAULT_OBSERVATORY.reset()
                obs.DEFAULT_COST_LEDGER.reset()
                stats0 = pool1.stats()
                spine._settle = tapped
                counts.clear()
            try:
                t0 = time.perf_counter()
                res, traces = _traced_round(qa1, questions)
                on = _round_record(res, time.perf_counter() - t0)
            finally:
                if counted:
                    del spine._settle
            pairs.append({"off": off, "on": on, "overhead": {
                "p50": on["latency_p50_s"] / off["latency_p50_s"] - 1.0,
                "max": on["latency_max_s"] / off["latency_max_s"] - 1.0,
                "tokens_per_s": 1.0 - on["tokens_per_s"] / off["tokens_per_s"],
            }})
        launches = dict(counts)
        steps = pool1.stats() - stats0
        for pair in pairs:
            for r in (pair["off"], pair["on"]):
                if r["degraded"]:
                    raise AssertionError(f"phase 8 degraded answers: {r['degraded']}")
        overhead = {key: {
            "median": statistics.median(p["overhead"][key] for p in pairs),
            "min": min(p["overhead"][key] for p in pairs),
            "max": max(p["overhead"][key] for p in pairs),
        } for key in ("p50", "max", "tokens_per_s")}
        for pair in pairs:
            off, on = pair["off"], pair["on"]
            log(f"  round A1, recorder off: p50 {off['latency_p50_s']:.3f} s max "
                f"{off['latency_max_s']:.3f} s {off['tokens_per_s']:.1f} answer tok/s; on: "
                f"p50 {on['latency_p50_s']:.3f} s max {on['latency_max_s']:.3f} s "
                f"{on['tokens_per_s']:.1f} answer tok/s")
        log(f"  recorder on against off over {RECORDER_PAIRS} alternating pairs, median "
            f"[min, max]: " + ", ".join(
                f"{label} {sign * o['median']:+.1%} "
                f"[{min(sign * o['min'], sign * o['max']):+.1%}, "
                f"{max(sign * o['min'], sign * o['max']):+.1%}]"
                for label, sign, o in (("p50", 1, overhead["p50"]),
                                       ("max", 1, overhead["max"]),
                                       ("tok/s", -1, overhead["tokens_per_s"])))
            + f" (the reference's budget {RECORDER_BUDGET:.0%}, reported, not asserted)")

        # ---- every /ask trace complete, with the expected spans
        if len(traces) != len(questions):
            raise AssertionError(f"{len(traces)} traces for {len(questions)} /ask")
        for tr in traces:
            names = {sp.name for sp in tr.snapshot_spans()}
            ids = {sp.span_id for sp in tr.snapshot_spans()}
            orphans = [sp.name for sp in tr.snapshot_spans()
                       if sp.parent_id is not None and sp.parent_id not in ids]
            if (not tr.finished or tr.status != "ok" or not ASK_SPANS <= names
                    or orphans or obs.DEFAULT_RECORDER.get(tr.trace_id) is not tr):
                raise AssertionError(
                    f"trace {tr.trace_id}: finished {tr.finished}, status {tr.status}, "
                    f"missing {sorted(ASK_SPANS - names)}, orphans {orphans}")
        attribution = obs.attribution(traces)
        log("  attribution over the 16 traced /ask:\n"
            + "\n".join("    " + line for line in obs.format_table(attribution).splitlines()))

        # ---- the observatory: the card's peak, costed stages, MFU <= 1
        stats = obs.DEFAULT_OBSERVATORY.stats()
        peak = stats["peak"]
        if card not in peak["peak_flops_source"] or not peak["peak_flops"]:
            raise AssertionError(f"observatory peak does not name {card}: {peak}")
        for stage in ("serve_prefill_fetch", "serve_decode_chunk"):
            row = stats["stages"].get(stage)
            if row is None or row["uncosted_calls"] or not row["flops"]:
                raise AssertionError(f"{stage}: {row}")
        invalid = {k: v for k, v in stats["stages"].items() if "mfu_raw_invalid" in v}
        if invalid:
            raise AssertionError(f"MFU above 1 in {sorted(invalid)}: {invalid}")
        log(f"  per-stage MFU (analytic FLOPs over CUDA-event device time, peak "
            f"{peak['peak_flops'] / 1e12:.0f} TFLOP/s, {peak['peak_flops_source']}):\n"
            + _mfu_table(stats))

        # ---- every spine item's device time within its wall time
        over = [(st, d, w) for st, d, w in items if d > w]
        if not items or over:
            raise AssertionError(f"{len(over)} of {len(items)} spine items took more "
                                 f"device than wall time: {over[:5]}")

        # ---- per-class device ms equal the spine's series
        counters = spine.telemetry_counters()
        classes = obs.DEFAULT_COST_LEDGER.class_totals()
        reconcile = {}
        for stage, fields in (
            ("serve_prefill_fetch", ("prefill_device_ms_cold", "prefill_device_ms_warm")),
            ("serve_decode_chunk", ("decode_device_ms",)),
            ("retrieve", ("retrieve_device_ms",)),
        ):
            spine_ms = counters.get(f"dispatch_device_ms_{stage}", 0.0)
            attributed = sum(row.get(f, 0.0) for row in classes.values() for f in fields)
            reconcile[stage] = {"spine_ms": spine_ms, "attributed_ms": attributed}
            if not spine_ms or abs(attributed - spine_ms) > 1e-6 * spine_ms:
                raise AssertionError(f"{stage}: classes {attributed} ms, spine "
                                     f"{spine_ms} ms")
        log(f"  per-class device ms = the spine's series: {reconcile}")

        # ---- K1's launch identity over the traced round
        want = {
            "flash_attention.decode_paged": dec_cfg.num_layers * (
                steps["verify_steps"] + steps["decode_steps"] + steps["warmup_steps"]),
            "flash_attention.prefill": enc_layers * len(questions),
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want:
            raise AssertionError(f"obs phase launches {got}, expected {want}")

        # ---- a profiler window around verify steps: each decode chunk's
        # CUDA-event span held against the CUPTI time of the kernels it
        # launched
        before = pool1.stats()["verify_steps"]
        paged0 = counts["flash_attention.decode_paged"]
        execute, seq, window = spine._execute, itertools.count(), {}

        def annotated(item):
            # a profiler range per item on the thread that executes it (a
            # lane's or its caller's): the launches inside it are the item's
            n = next(seq)
            window[n] = item
            with torch.profiler.record_function(f"{ITEM_RANGE}{n}"):
                execute(item)

        logdir = obs.DEFAULT_PROFILER.start(device=dev)  # a temporary directory
        spine._execute = annotated
        try:
            pool1.submit_text(_pool_prompt(qa_solo, QUESTIONS[0]), max_new_tokens=8,
                              deadline=Deadline.after(POOL_DEADLINE_S)).result(timeout=120)
        finally:
            del spine._execute
            obs.DEFAULT_PROFILER.stop()
        profiled_steps = pool1.stats()["verify_steps"] - before
        with open(obs.DEFAULT_PROFILER.trace_path) as f:
            events = json.load(f)["traceEvents"]
        shutil.rmtree(logdir, ignore_errors=True)
        kernel_names = collections.Counter(
            e["name"] for e in events if e.get("cat") == "kernel")
        k1 = {n: c for n, c in kernel_names.items() if "flash_decode_kernel" in n}
        if profiled_steps < PROFILED_VERIFY_STEPS or not k1:
            raise AssertionError(f"profiler window: {profiled_steps} verify steps, K1 "
                                 f"decode kernels {k1}, {len(kernel_names)} kernel names")
        if counts["flash_attention.decode_paged"] == paged0:
            raise AssertionError("profiler window: no paged decode launch counted")
        busy, matched_by = _item_kernel_busy_us(events)
        chunks = []
        for n, item in sorted(window.items()):
            # a chunk still unfetched when the window closed has no span
            if item.stage != "serve_decode_chunk" or not item.settled or item.error:
                continue
            span_us, busy_us = item.device_s * 1e6, busy.get(n, 0.0)
            chunks.append({"span_ms": span_us / 1e3, "busy_ms": busy_us / 1e3,
                           "busy_share": busy_us / span_us if span_us else None})
            if not 0.0 < busy_us <= span_us * (1 + SPAN_REL_SLACK) + SPAN_ABS_SLACK_US:
                raise AssertionError(
                    f"decode chunk {n}: CUDA-event span {span_us:.1f} us, kernel busy "
                    f"{busy_us:.1f} us (launches matched by {matched_by}, "
                    f"{len(busy)} items with kernels)")
        if not chunks:
            raise AssertionError(f"profiler window: no fetched decode chunk among "
                                 f"{[it.stage for it in window.values()]}")
        log(f"  profiler window: {profiled_steps} verify steps, {sum(kernel_names.values())} "
            f"kernel events; K1 {k1}")
        log(f"  decode chunks in the window (launches matched to items by {matched_by}): "
            + "; ".join(f"span {c['span_ms']:.3f} ms, kernel busy {c['busy_ms']:.3f} ms "
                        f"({c['busy_share']:.1%})" for c in chunks))

        # ---- one document through a pipeline configured as phase 7's
        ner_cfg = NERConfig()
        deid = DeidEngine(ner_cfg, params=init_ner_params(ner_cfg, seed=11), device=dev)
        cfg = Config(encoder=encoder.cfg, ner=ner_cfg, store=store.cfg)
        pipe = DocumentPipeline(cfg, make_broker(cfg.broker),
                                DocumentRegistry(cfg.registry.url), deid, encoder, store)
        doc = ingest_corpus(np.random.default_rng(808), 1, "obs")[0]
        pipe.start()
        doc_id = pipe.ingest_document(doc["filename"], doc["data"]).doc_id
        if not pipe.wait_indexed(doc_id, timeout=INGEST_TIMEOUT_S):
            raise AssertionError(f"phase 8 upload {doc_id} not INDEXED")
        doc_trace = next(t for t in obs.DEFAULT_RECORDER.recent(64)
                         if t.root.attrs.get("doc_id") == doc_id)
        spans = doc_trace.snapshot_spans()
        doc_names = collections.Counter(sp.name for sp in spans)
        parents = {sp.parent_id for sp in spans if sp.parent_id is not None}
        if (set(doc_names) != DOC_SPANS or any(n != 1 for n in doc_names.values())
                or parents != {doc_trace.root.span_id} or doc_trace.status != "ok"):
            raise AssertionError(f"document timeline {dict(doc_names)}, parents "
                                 f"{parents}, status {doc_trace.status}")
        log(f"  ingested document: {obs.timeline_dict(doc_trace)['spans'][1:]!r:.300}")

        # ---- a telemetry tick over the pool, the spine, a broker, the recorder
        store_t = obs.TelemetryStore(interval_s=10.0, points=60)
        slo = obs.BurnRateEvaluator(store_t, obs.default_ask_slos(8000.0),
                                    registry=DEFAULT_REGISTRY,
                                    recorder=obs.DEFAULT_RECORDER)
        sampler = obs.TelemetrySampler(
            store_t, registry=DEFAULT_REGISTRY, batcher=pool1, broker=pipe.broker,
            queues=(cfg.broker.raw_queue, cfg.broker.clean_queue),
            recorder=obs.DEFAULT_RECORDER, engine=gen, slo_evaluator=slo,
            spine=spine, extra_probes=[obs.DEFAULT_COST_LEDGER.telemetry_gauges],
        )
        sampler.tick()
        lint = {om: lint_prometheus_text(prometheus_text(DEFAULT_REGISTRY, store_t,
                                                         openmetrics=om))
                for om in (False, True)}
        gauges = store_t.latest_gauges()
        needed = ("pool_replica0_alive", "dispatch_occupancy", "trace_open",
                  f"broker_depth_{cfg.broker.raw_queue}", "device_mem_allocated_bytes")
        if any(lint.values()) or any(n not in gauges for n in needed):
            raise AssertionError(f"telemetry: lint {lint}, missing "
                                 f"{[n for n in needed if n not in gauges]}")
        log(f"  telemetry tick: {len(store_t.names())} series, Prometheus text lint-clean "
            f"in both dialects; device_mem_allocated_bytes "
            f"{gauges['device_mem_allocated_bytes'] / 2**30:.2f} GiB")
        # ---- what a lane crossing costs an item here (reported)
        handoff = spine_handoff(dev)
        log("  spine handoff beside a busy Python thread, ms an item (busy loops/s): "
            + "; ".join(f"{side} " + ", ".join(
                f"{h['ms_per_item']:.3f} ({h['busy_loop_per_s']:.0f})" for h in runs)
                for side, runs in handoff.items()))
        summary = {
            "recorder_pairs": pairs, "recorder_overhead": overhead, "spine_handoff": handoff,
            "recorder_budget": RECORDER_BUDGET, "attribution": attribution,
            "observatory": stats, "reconcile": reconcile, "spine_items": len(items),
            "launches": got, "profiled_verify_steps": profiled_steps,
            "profiled_k1_kernels": k1, "profiled_chunks": chunks,
            "profiled_launch_match": matched_by, "document_spans": dict(doc_names),
            "telemetry_series": len(store_t.names()),
        }
        return {"summary": summary, "launches": launches}
    finally:
        if pipe is not None:
            pipe.stop()
        pool1.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full results as JSON to this path")
    ap.add_argument("--spine-lanes", type=int, default=None,
                    help="the dispatch spine's lane count (default: the spine's own)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.spine_lanes is not None:
        configure(n_lanes=args.spine_lanes)  # before the first dispatch

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/8] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logs = _kernels.build()
    build_s = time.perf_counter() - t0
    log(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s")
    for name, text in build_logs.items():
        for kernel, regs, spills in ptxas_summary(text):
            log(f"    {name}: {kernel}: {regs} registers, spill stores/loads {spills}")

    log("[2/8] kernels against their plain versions (bf16 and float32)")
    cases = run_kernel_cases()
    cases += run_paged_cases()

    log("[3/8] main path: QAService.ask at full width")
    t_main = time.perf_counter()
    qa, params, enc_launches = build_main_path(_kernels.LAUNCHES)
    per_q, launches = run_main_path(_kernels.LAUNCHES, qa, params, enc_launches)
    main_s = time.perf_counter() - t_main

    log("[4/8] reference: tiny float32 /ask on the card against the CPU")
    reference = run_reference_check()

    log("[5/8] main path: QAService.ask through the continuous batcher at full width")
    t_batch = time.perf_counter()
    batcher_path = run_batcher_path(_kernels.LAUNCHES, qa, per_q)
    batcher_s = time.perf_counter() - t_batch

    log("[6/8] main path: QAService.ask through the replica pool at full width")
    t_pool = time.perf_counter()
    get_spine().reset_stats()
    pool_path = run_pool_path(_kernels.LAUNCHES, qa)
    pool_s = time.perf_counter() - t_pool
    pool_path["summary"]["spine"] = _spine_waits(get_spine().stats())
    _log_spine_waits("phase 6", pool_path["summary"]["spine"])

    log("[7/8] ingest: DocumentPipeline at full width, then /ask over what it indexed")
    t_ingest = time.perf_counter()
    get_spine().reset_stats()
    ingest_path = run_ingest_path(_kernels.LAUNCHES, qa)
    ingest_s = time.perf_counter() - t_ingest
    ingest_path["summary"]["spine"] = _spine_waits(get_spine().stats())
    _log_spine_waits("phase 7", ingest_path["summary"]["spine"])

    log("[8/8] obs: traces, stage device time, MFU and costs over the pool, "
        "and an ingested document's timeline")
    t_obs = time.perf_counter()
    obs_path = run_obs_path(_kernels.LAUNCHES, qa)
    obs_s = time.perf_counter() - t_obs
    del qa, params
    # launches of the main-path runs (each counted from 0 around its run)
    path_launches = collections.Counter(launches["total"])
    path_launches.update(batcher_path["launches"])
    path_launches.update(pool_path["launches"])
    path_launches.update(ingest_path["launches"])
    path_launches.update(ingest_path["round_launches"])
    path_launches.update(obs_path["launches"])

    def entry(name, source, counter, timed, path=None):
        head = next(c for c in cases if c["case"] == timed)
        own = [c for c in cases if path is None or c["path"] == path]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "docqa_tpu/ops/attention.py:315",
            "launches": path_launches.get(counter, 0),
            "max_abs_err": max(c["max_abs_err_bf16"] for c in own),
            "tolerance": "bf16 |err| <= 1e-2 + 1e-2*|plain|; f32 |err| <= 5e-5",
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_live_ms": head.get("library_live_ms"),
            "gather_k1_ms": head.get("gather_k1_ms"),
            "timed_case": head["case"],
            "cases": [c["case"] for c in own],
        }

    # K1 as a whole (the wrapper's entry), then its bf16 paths
    kernels = [
        entry("flash_attention", "docqa_tpu_torch/csrc/flash_attention.cu",
              "flash_attention", "mistral_prefill"),
        entry("flash_attention.decode", "docqa_tpu_torch/csrc/flash_decode.cuh",
              "flash_attention.decode", "mistral_verify", "decode"),
        entry("flash_attention.prefill", "docqa_tpu_torch/csrc/flash_prefill.cuh",
              "flash_attention.prefill", "mistral_prefill", "prefill"),
        entry("flash_attention.decode_paged", "docqa_tpu_torch/csrc/flash_decode.cuh",
              "flash_attention.decode_paged", "mistral_paged_verify", "decode_paged"),
    ]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "card": smi, "torch": torch.__version__,
                "build_s": build_s, "build_logs": build_logs,
                "kernels": kernels, "cases": cases,
                "main_path": per_q, "main_path_s": main_s,
                "launches": launches, "reference": reference,
                "batcher_path": batcher_path, "batcher_path_s": batcher_s,
                "pool_path": pool_path, "pool_path_s": pool_s,
                "ingest_path": ingest_path, "ingest_path_s": ingest_s,
                "obs_path": obs_path, "obs_path_s": obs_s,
            }, f, indent=1)
    print(json.dumps({"pool": {**pool_path["summary"], "phase_s": pool_s}}))
    print(json.dumps({"ingest": {
        **ingest_path["summary"], "phase_s": ingest_s,
        "launches": ingest_path["launches"],
        **{c["case"]: {key: c[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err_bf16")}
           for c in cases if c["case"] in ("ner_window_batch", "ner_served_batch")},
    }}))
    print(json.dumps({"obs": {
        key: obs_path["summary"][key] for key in (
            "recorder_pairs", "recorder_overhead", "reconcile", "spine_items",
            "launches", "profiled_verify_steps", "profiled_chunks", "spine_handoff",
            "document_spans")
    } | {"phase_s": obs_s}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
