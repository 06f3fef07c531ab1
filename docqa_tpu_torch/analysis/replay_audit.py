"""The bitwise replay witness: two runs of one seeded smoke, each in a
fresh interpreter under a different ``PYTHONHASHSEED``, must be equal.

Counterpart of ``docqa_tpu/analysis/replay_audit.py`` and of the smoke in
the reference's ``scripts/replay_audit.py``.  The determinism rules
(rng-discipline, replay-key-integrity, order-stability, entropy-in-state)
over-approximate statically; this module holds the dynamic side of the
same contract:

* :func:`compare_transcripts` — the equality gate over two transcripts:
  per-request token streams (bitwise), retrieval result ids, the broker
  journal's document states across a simulated restart, and the shadow
  sampler's selection.  It returns a divergence report (first diverging
  request, token index, stage), decode first since a decode divergence
  usually causes the downstream ones;
* the determinism manifest (``analysis/determinism_manifest.json``)
  ledgers every entropy source of the port's tree
  (:func:`docqa_tpu_torch.analysis.entropy.enumerate_entropy_sites`) with
  a justification.  A NEW site, a STALE entry and a TODO justification
  each fail.  ``--write-manifest`` regenerates the ledger but cannot
  launder a divergence: equality is measured again each run, and a fresh
  entry carries a TODO that fails until someone writes down why the
  source is sanctioned;
* the smoke (:func:`run_smoke`) and the two-run gate
  (:func:`run_replay_audit`), ``python -m docqa_tpu_torch.analysis
  --replay-audit [--device cpu|cuda]``.

The smoke's four sections are the reference's: decode (cold admissions,
then a warm-prefix burst, greedy with K = 4 speculation, through a
:class:`~docqa_tpu_torch.engines.serve.ContinuousBatcher`; at full width
a solo engine's answers too), retrieval ids from a tiered index (at full
width beside an exact 1,000,000-row store), broker-journal replay across a
restart, and the shadow sampler's selection.  Each group of admissions is
queued under the batcher's lock, so one admission round takes it whole:
otherwise which requests share a pack would depend on when the worker
wakes.  ``width="test"`` is the reference's configuration (float32,
2 layers, the CPU), so its transcript equals the reference's section by
section on the same seed; ``width="full"`` is Mistral-7B in bf16 on the
card (``chip_smoke.py`` phase 21).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

MANIFEST_FILENAME = "determinism_manifest.json"
_TODO_MARK = "TODO"

# the two child interpreters' hash salts: different, so a salted hash() or
# a set-order dependency shows up as a divergence instead of cancelling out
HASH_SEEDS = ("0", "1")
# one child's smoke at test width takes ~15 s on the CPU
CHILD_TIMEOUT_S = 600.0


def default_manifest_path() -> str:
    """``docqa_tpu_torch/analysis/determinism_manifest.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), MANIFEST_FILENAME)


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


def _site_key(entry: Dict[str, Any]) -> Tuple[str, str, str, str]:
    """Manifest identity: (kind, path, symbol, call), not the line, so
    unrelated edits don't churn the ledger."""
    return (
        entry.get("kind", ""),
        entry.get("path", ""),
        entry.get("symbol", ""),
        entry.get("call", ""),
    )


def load_manifest(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("entries", []))


def save_manifest(path: str, entries: Sequence[Dict[str, Any]]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"entries": list(entries)}, f, indent=2, sort_keys=True)
        f.write("\n")


def manifest_split(
    sites: Sequence[Dict[str, Any]], entries: Sequence[Dict[str, Any]]
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Partition into (new-sites, matched-sites, stale-entries)."""
    by_key = {_site_key(e): e for e in entries}
    new: List[Dict[str, Any]] = []
    matched: List[Dict[str, Any]] = []
    seen = set()
    for s in sites:
        key = _site_key(s)
        if key in by_key:
            matched.append(s)
            seen.add(key)
        else:
            new.append(s)
    stale = [e for k, e in by_key.items() if k not in seen]
    return new, matched, stale


def manifest_todos(entries: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Entries whose justification is missing or still a TODO."""
    out = []
    for e in entries:
        j = str(e.get("justification", "")).strip()
        if not j or j.upper().startswith(_TODO_MARK):
            out.append(e)
    return out


def updated_manifest(
    sites: Sequence[Dict[str, Any]], old_entries: Sequence[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """The ``--write-manifest`` result: one entry per current site, the
    justification of every entry that still matches kept; a new site gets
    an explicit TODO (which fails the gate)."""
    keep = {_site_key(e): e.get("justification", "") for e in old_entries}
    out = []
    for s in sites:
        out.append({
            "kind": s["kind"],
            "path": s["path"],
            "symbol": s["symbol"],
            "call": s["call"],
            "justification": keep.get(_site_key(s), "")
            or "TODO: justify this entropy source",
        })
    out.sort(key=_site_key)
    return out


def manifest_gate(
    root: Optional[str] = None, manifest_path: Optional[str] = None,
    write: bool = False,
) -> Dict[str, Any]:
    """The ledger half of the gate over the tree at ``root`` (the port's
    package by default): ``{"entries", "new", "matched", "stale",
    "todo"}``, each a list."""
    from docqa_tpu_torch.analysis.core import Package, package_dir
    from docqa_tpu_torch.analysis.entropy import enumerate_entropy_sites

    sites = enumerate_entropy_sites(Package.load(root or package_dir()))
    path = manifest_path or default_manifest_path()
    entries = load_manifest(path)
    if write:
        entries = updated_manifest(sites, entries)
        save_manifest(path, entries)
    new, matched, stale = manifest_split(sites, entries)
    return {"entries": entries, "new": new, "matched": matched,
            "stale": stale, "todo": manifest_todos(entries)}


# ---------------------------------------------------------------------------
# transcript comparison
# ---------------------------------------------------------------------------


def _first_token_diff(a: Sequence[int], b: Sequence[int]) -> int:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b))


def _by_id(items: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    return {str(r["id"]): r for r in items}


def compare_transcripts(run_a: Dict[str, Any], run_b: Dict[str, Any]) -> Dict[str, Any]:
    """Bitwise equality gate over two smoke transcripts.

    Returns ``{"equal", "divergences", "first_divergence"}``; each
    divergence carries ``stage`` and its attribution (request and token
    index for decode, query for retrieval, documents for journal)."""
    divergences: List[Dict[str, Any]] = []

    # -- stage: decode (per-request token streams, bitwise) ------------------
    req_a = _by_id(run_a.get("decode", {}).get("requests", []))
    req_b = _by_id(run_b.get("decode", {}).get("requests", []))
    for rid in sorted(set(req_a) | set(req_b)):
        ra, rb = req_a.get(rid), req_b.get(rid)
        if ra is None or rb is None:
            divergences.append({"stage": "decode", "request": rid,
                                "detail": "request present in only one run"})
            continue
        ta, tb = list(ra.get("tokens", [])), list(rb.get("tokens", []))
        if ta != tb:
            divergences.append({
                "stage": "decode",
                "request": rid,
                "phase": ra.get("phase"),
                "token_index": _first_token_diff(ta, tb),
                "len_a": len(ta),
                "len_b": len(tb),
                "detail": "token streams diverge",
            })

    keys_a = run_a.get("decode", {}).get("prefix_keys")
    keys_b = run_b.get("decode", {}).get("prefix_keys")
    if keys_a != keys_b:
        divergences.append({
            "stage": "decode",
            "request": "prefix-keys",
            "detail": "prefix-cache keys differ (a process-salted value in the "
            "key's derivation?)",
        })

    # -- stage: retrieval (result ids, ordered) ------------------------------
    q_a = _by_id(run_a.get("retrieval", {}).get("queries", []))
    q_b = _by_id(run_b.get("retrieval", {}).get("queries", []))
    for qid in sorted(set(q_a) | set(q_b)):
        qa, qb = q_a.get(qid), q_b.get(qid)
        if qa is None or qb is None:
            divergences.append({"stage": "retrieval", "query": qid,
                                "detail": "query present in only one run"})
            continue
        if list(qa.get("doc_ids", [])) != list(qb.get("doc_ids", [])):
            divergences.append({
                "stage": "retrieval",
                "query": qid,
                "detail": "retrieval result ids differ",
                "doc_ids_a": list(qa.get("doc_ids", [])),
                "doc_ids_b": list(qb.get("doc_ids", [])),
            })

    # -- stage: journal (restart convergence, within and across runs) --------
    for label, run in (("run_a", run_a), ("run_b", run_b)):
        j = run.get("journal", {})
        if j and j.get("doc_states_pre") != j.get("doc_states_post"):
            divergences.append({
                "stage": "journal",
                "detail": f"{label}: journal replay did not converge "
                "to the pre-restart document states",
            })
    ja = run_a.get("journal", {}).get("doc_states_post")
    jb = run_b.get("journal", {}).get("doc_states_post")
    if ja != jb:
        diff_docs = sorted(
            k for k in set(ja or {}) | set(jb or {})
            if (ja or {}).get(k) != (jb or {}).get(k)
        )
        divergences.append({
            "stage": "journal",
            "detail": "post-restart document states differ across runs",
            "docs": diff_docs,
        })
    if run_a.get("journal", {}).get("drained") != run_b.get("journal", {}).get("drained"):
        divergences.append({
            "stage": "journal",
            "detail": "replayed delivery order/content differs across runs",
        })

    # -- stage: shadow sampler (identical request selection set) -------------
    sa = run_a.get("shadow", {})
    sb = run_b.get("shadow", {})
    if list(sa.get("selected", [])) != list(sb.get("selected", [])):
        divergences.append({
            "stage": "shadow_sampler",
            "detail": "shadow sampler selected different request sets",
            "selected_a": list(sa.get("selected", [])),
            "selected_b": list(sb.get("selected", [])),
        })

    return {
        "equal": not divergences,
        "divergences": divergences,
        "first_divergence": divergences[0] if divergences else None,
    }


def format_divergence(d: Dict[str, Any]) -> str:
    """One line naming a divergence's stage and attribution."""
    return f"stage={d.get('stage')} " + " ".join(
        f"{k}={v}" for k, v in d.items()
        if k not in ("stage", "doc_ids_a", "doc_ids_b", "selected_a", "selected_b")
    )


# ---------------------------------------------------------------------------
# the smoke (runs in the child interpreters)
# ---------------------------------------------------------------------------

# width "full": the card's configuration (chip_smoke.py phase 21)
FULL_SOLO_QUESTIONS = 2
FULL_NEW_TOKENS = 32
FULL_SLOTS, FULL_CHUNK = 8, 16
FULL_GROUP = 4
FULL_STORE_ROWS = 1_000_000
FULL_TIER_ROWS = 100_000
FULL_QUERIES = 16
FULL_NPROBE = 8


def _queued(batcher, submits):
    """Queue a group of admissions under the batcher's lock, so one
    admission round takes as many of them as slots allow."""
    with batcher._cv:
        return [submit() for submit in submits]


def decode_section(seed: int, device: str = "cpu", width: str = "test") -> Dict[str, Any]:
    """The serving window.  Test width: the reference's tiny engine
    (float32, drawn by the reference's host init), six distinct cold
    admissions, one admission that pins a prefix and four warm ones on
    it.  Full width: Mistral-7B in bf16 drawn on the card, a solo engine's
    answers to two questions, then four cold and (after the pinning
    admission) four warm admissions through an 8-slot batcher."""
    import torch

    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.serve import ContinuousBatcher

    requests: List[Dict[str, Any]] = []

    def collect(rid, phase, prompt_len, tokens):
        requests.append({"id": rid, "phase": phase, "prompt_len": prompt_len,
                         "tokens": [int(t) for t in tokens]})

    if width == "test":
        cfg = DecoderConfig(
            vocab_size=256, hidden_dim=128, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, mlp_dim=256, max_seq_len=512,
            dtype="float32",
        )
        new_tokens = 24
        gen = GenerateConfig(temperature=0.0, prefill_buckets=(32, 64), eos_id=2,
                             max_new_tokens=new_tokens, speculative_k=4)
        engine = GenerateEngine(cfg, gen, seed=seed, device=device)
        batcher_kw = dict(n_slots=4, chunk=8, cache_len=256)
        colds = [[(3 + 7 * i + 11 * j) % 250 + 1 for j in range(20 + 2 * i)]
                 for i in range(6)]
        ctx = [(3 + i * 7) % 250 + 1 for i in range(160)]
        warm_tails = [7 + i for i in range(4)]
        pin_tail, warmup = 5, gen.prefill_buckets[:1]
    else:
        from docqa_tpu_torch.models.decoder import init_decoder_params
        import numpy as np

        cfg = DecoderConfig.mistral_7b()
        new_tokens = FULL_NEW_TOKENS
        gen = GenerateConfig(temperature=0.0, max_new_tokens=new_tokens, speculative_k=4)
        params = init_decoder_params(cfg, seed=seed, device=device, dtype=torch.bfloat16)
        engine = GenerateEngine(cfg, gen, params=params, device=device)
        del params
        rng = np.random.default_rng(seed)
        vocab = cfg.vocab_size - 3
        solo = [(rng.integers(0, vocab, 96 + 32 * i) + 3).tolist()
                for i in range(FULL_SOLO_QUESTIONS)]
        for i, ids in enumerate(solo):
            out = engine.generate_ids([ids], max_new_tokens=new_tokens)[0]
            collect(f"solo-{i}", "solo", len(ids), out)
        batcher_kw = dict(n_slots=FULL_SLOTS, chunk=FULL_CHUNK, cache_len=1024)
        colds = [(rng.integers(0, vocab, 64 + 24 * i) + 3).tolist()
                 for i in range(FULL_GROUP)]
        ctx = (rng.integers(0, vocab, 384) + 3).tolist()
        warm_tails = [int(t) + 3 for t in rng.integers(0, vocab, FULL_GROUP)]
        pin_tail, warmup = int(rng.integers(0, vocab)) + 3, None

    # the warm group's prefix key, derived as /ask derives one from the
    # retrieved context: a key that is not bitwise stable across processes
    # (a salted hash()) diverges here
    from docqa_tpu_torch.service.qa import prefix_key_for

    key = prefix_key_for([" ".join(map(str, ctx))])
    b = ContinuousBatcher(engine, prefix_cache=True, seed=seed, **batcher_kw)
    try:
        b.warmup(buckets=warmup)
        # distinct cold admissions, one group: pack order from admission
        # order alone
        handles = _queued(b, [
            (lambda ids=ids: b.submit_ids(ids, max_new_tokens=new_tokens))
            for ids in colds
        ])
        for i, (ids, h) in enumerate(zip(colds, handles)):
            collect(f"cold-{i}", "cold", len(ids), h.result(timeout=CHILD_TIMEOUT_S))
        # one admission pins the prefix, then the warm group shares it
        h0 = b.submit_ids(ctx + [pin_tail], max_new_tokens=new_tokens,
                          prefix_key=key)
        collect("prefix-cold", "prefix-cold", len(ctx) + 1, h0.result(timeout=CHILD_TIMEOUT_S))
        handles = _queued(b, [
            (lambda t=t: b.submit_ids(ctx + [t], max_new_tokens=new_tokens,
                                      prefix_key=key))
            for t in warm_tails
        ])
        for i, h in enumerate(handles):
            collect(f"warm-{i}", "warm", len(ctx) + 1, h.result(timeout=CHILD_TIMEOUT_S))
    finally:
        b.stop()
    return {"requests": requests, "spec_k": b.spec_k, "prefix_keys": [key]}


def retrieval_section(seed: int, device: str = "cpu", width: str = "test") -> Dict[str, Any]:
    """Ordered top-10 ids per seeded query through a tiered index (ties
    included: the merge is deterministic); at full width also over an
    exact 1,000,000-row store whose first 100,000 rows the tier holds."""
    import numpy as np

    from docqa_tpu_torch.config import StoreConfig
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.index.tiered import TieredIndex

    rng = np.random.default_rng(seed)
    out = []
    if width == "test":
        vecs = rng.standard_normal((400, 32)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        store = VectorStore(StoreConfig(dim=32, shard_capacity=1024), device=device)
        store.add(vecs, [{"doc_id": f"d{i}"} for i in range(len(vecs))])
        tiered = TieredIndex(store, nprobe=4, min_rows=100, rebuild_tail_rows=100_000)
        tiered.rebuild()
        queries = rng.standard_normal((24, 32)).astype(np.float32)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
        for qi in range(queries.shape[0]):
            res = tiered.search(queries[qi], k=10)[0]
            out.append({"id": f"q{qi}", "doc_ids": [r.metadata.get("doc_id") for r in res]})
        return {"queries": out}

    dim = StoreConfig().dim
    exact = VectorStore(StoreConfig(), device=device)
    tier_store = VectorStore(StoreConfig(), device=device)
    step = 1 << 18
    for start in range(0, FULL_STORE_ROWS, step):
        n = min(step, FULL_STORE_ROWS - start)
        rows = rng.standard_normal((n, dim), dtype=np.float32)
        meta = [{"doc_id": f"d{start + i:07d}"} for i in range(n)]
        exact.add(rows, meta)
        if start < FULL_TIER_ROWS:
            m = min(n, FULL_TIER_ROWS - start)
            tier_store.add(rows[:m], meta[:m])
        del rows
    tiered = TieredIndex(tier_store, nprobe=FULL_NPROBE, min_rows=50_000,
                         rebuild_tail_rows=FULL_STORE_ROWS, seed=seed)
    tiered.rebuild()
    queries = rng.standard_normal((FULL_QUERIES, dim), dtype=np.float32)
    for qi, res in enumerate(exact.search(queries, k=10)):
        out.append({"id": f"exact-q{qi}", "doc_ids": [r.metadata.get("doc_id") for r in res]})
    for qi, res in enumerate(tiered.search(queries, k=10)):
        out.append({"id": f"tier-q{qi}", "doc_ids": [r.metadata.get("doc_id") for r in res]})
    return {"queries": out}


def shadow_section(seed: int) -> Dict[str, Any]:
    """The shadow sampler's selection over a fixed request window: pure
    integer arithmetic of (seed, window index), no RNG state, no str
    hash."""
    from docqa_tpu_torch.obs.retrieval_observatory import RetrievalObservatory

    robs = RetrievalObservatory(sample_every=4, seed=seed, frontier_every=0).start()
    try:
        selected = [i for i in range(64) if robs.sample()]
    finally:
        robs.stop()
    return {"sample_every": 4, "seed": seed, "selected": selected}


def journal_section(seed: int) -> Dict[str, Any]:
    """The broker journal across a simulated restart: publish 12 document
    records, ack 4, dead-letter 2, close; a fresh broker over the same
    journal directory must rebuild exactly the expected states and replay
    the survivors in publish order."""
    from docqa_tpu_torch.service.broker import MemoryBroker

    states = ("ingested", "encoded", "indexed")
    with tempfile.TemporaryDirectory() as jd:
        broker = MemoryBroker(journal_dir=jd)
        for i in range(12):
            broker.publish("docs", {"doc_id": f"d{i:02d}", "state": states[i % 3], "seq": i})
        got = broker.get_many("docs", 6, timeout=5.0)
        acked, dead = [], []
        for k, d in enumerate(got):
            if k < 4:
                broker.ack(d)
                acked.append(d.body["doc_id"])
            else:
                broker.nack(d, requeue=False)
                dead.append(d.body["doc_id"])
        # what a correct replay must rebuild, from intent, not from the
        # broker's internals
        pre = {}
        for i in range(12):
            did = f"d{i:02d}"
            pre[did] = "done" if did in acked else "dead" if did in dead else "pending"
        broker.close()

        broker2 = MemoryBroker(journal_dir=jd)  # the restart
        drained = []
        while True:
            ds = broker2.get_many("docs", 12, timeout=0.2)
            if not ds:
                break
            for d in ds:
                drained.append(d.body["doc_id"])
                broker2.ack(d)
        dead_post = [b["doc_id"] for b in broker2.dead_letters("docs")]
        post = {}
        for i in range(12):
            did = f"d{i:02d}"
            post[did] = ("pending" if did in drained
                         else "dead" if did in dead_post else "done")
        broker2.close()
    return {"doc_states_pre": pre, "doc_states_post": post,
            "drained": drained, "dead": dead_post}


def run_smoke(seed: int, device: str = "cpu", width: str = "test") -> Dict[str, Any]:
    """One run's transcript."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = {
        "seed": seed,
        "width": width,
        "python_hash_seed": os.environ.get("PYTHONHASHSEED", ""),
        "decode": decode_section(seed, device, width),
        "retrieval": retrieval_section(seed, device, width),
        "shadow": shadow_section(seed),
        "journal": journal_section(seed),
    }
    if device != "cpu":
        torch.cuda.synchronize()
        out["peak_bytes"] = int(torch.cuda.max_memory_allocated())
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the two-run gate (parent)
# ---------------------------------------------------------------------------


def spawn_runs(seed: int, device: str, width: str, workdir: str,
               timeout_s: float = CHILD_TIMEOUT_S,
               hash_seeds: Sequence[str] = HASH_SEEDS,
               root: Optional[str] = None) -> List[Dict[str, Any]]:
    """Both runs at once, each in a fresh interpreter under its own
    ``PYTHONHASHSEED``; returns their transcripts.  ``root`` is the
    directory the children import ``docqa_tpu_torch`` from (this
    checkout's by default).  A child that fails or outlives ``timeout_s``
    raises ``RuntimeError`` with its output (every child is killed)."""
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    try:
        for hs in hash_seeds:
            out = os.path.join(workdir, f"run_{hs}.json")
            env = dict(os.environ)
            env["PYTHONHASHSEED"] = hs
            env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
            log = open(os.path.join(workdir, f"run_{hs}.log"), "w")
            procs.append((out, log, subprocess.Popen(
                [sys.executable, "-m", "docqa_tpu_torch.analysis.replay_audit",
                 "--seed", str(seed), "--device", device, "--width", width,
                 "--out", out],
                env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL,
            )))
        deadline = time.monotonic() + timeout_s
        runs = []
        for out, log, proc in procs:
            try:
                rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(
                    f"replay child {os.path.basename(out)} "
                    f"{'timed out' if rc is None else f'exited {rc}'}:\n{tail}")
            with open(out, encoding="utf-8") as f:
                runs.append(json.load(f))
        return runs
    finally:
        for _out, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if not log.closed:
                log.close()


def run_replay_audit(
    seed: int = 7, device: str = "cpu", width: str = "test",
    manifest_path: Optional[str] = None, write_manifest: bool = False,
    report_path: Optional[str] = None, timeout_s: float = CHILD_TIMEOUT_S,
) -> Dict[str, Any]:
    """The measurement (two fresh runs, the same seed) and the ledger;
    ``report["ok"]`` is the gate."""
    with tempfile.TemporaryDirectory(prefix="docqa_replay_") as td:
        runs = spawn_runs(seed, device, width, td, timeout_s=timeout_s)
    cmp = compare_transcripts(runs[0], runs[1])
    ledger = manifest_gate(manifest_path=manifest_path, write=write_manifest)
    report = {
        "seed": seed, "device": device, "width": width,
        "equal": cmp["equal"],
        "first_divergence": cmp["first_divergence"],
        "divergences": cmp["divergences"],
        "decode_requests": len(runs[0].get("decode", {}).get("requests", [])),
        "spec_k": runs[0].get("decode", {}).get("spec_k"),
        "retrieval_queries": len(runs[0].get("retrieval", {}).get("queries", [])),
        "shadow_selected": runs[0].get("shadow", {}).get("selected"),
        "child_seconds": [r.get("seconds") for r in runs],
        "child_peak_bytes": [r.get("peak_bytes") for r in runs],
        "manifest": {k: len(v) for k, v in ledger.items()},
        "unledgered": ledger["new"], "stale": ledger["stale"], "todo": ledger["todo"],
    }
    report["ok"] = bool(cmp["equal"] and not ledger["new"] and not ledger["stale"]
                        and not ledger["todo"])
    if report_path:
        with open(report_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    return report


def print_report(report: Dict[str, Any], manifest_name: str = MANIFEST_FILENAME) -> None:
    """The gate's text report: divergences and ledger faults to stderr, a
    one-line verdict to stdout."""
    if not report["equal"]:
        print("REPLAY DIVERGENCE:", file=sys.stderr)
        print("  first: " + format_divergence(report["first_divergence"]), file=sys.stderr)
        for d in report["divergences"][1:]:
            print(f"  also: stage={d.get('stage')} {d.get('detail')}", file=sys.stderr)
    for s in report["unledgered"]:
        print(f"UNLEDGERED ENTROPY SOURCE: {s['path']} :: {s['symbol']} :: "
              f"{s['call']} [{s['kind']}] — add it to {manifest_name} with a "
              "justification (--write-manifest scaffolds it)", file=sys.stderr)
    for e in report["stale"]:
        print(f"STALE MANIFEST ENTRY: {e.get('path')} :: {e.get('symbol')} :: "
              f"{e.get('call')} — the source is gone", file=sys.stderr)
    for e in report["todo"]:
        print(f"TODO JUSTIFICATION: {e.get('path')} :: {e.get('symbol')} :: "
              f"{e.get('call')}", file=sys.stderr)
    if report["ok"]:
        print(f"replay witness clean — {report['decode_requests']} request stream(s) "
              f"bitwise-equal, {report['retrieval_queries']} retrieval(s) identical, "
              f"journal converged, shadow set identical; manifest in sync "
              f"({report['manifest']['matched']} justified entropy source(s))")


def _child_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one run of the replay smoke")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--width", choices=("test", "full"), default="test")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    transcript = run_smoke(args.seed, args.device, args.width)
    with open(args.out + ".tmp", "w", encoding="utf-8") as f:
        json.dump(transcript, f, sort_keys=True)
    os.replace(args.out + ".tmp", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())
