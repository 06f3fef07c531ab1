"""Worker process for tests/test_torch_mesh.py, not a test module.

Each rank of a gloo world on the CPU runs this script: it joins the world
through the port's own ``multihost_init`` (a file store: no port is bound),
builds the port's meshes and runs the scenarios named on its command line
in order, every rank the same program (SPMD).  Each scenario's results are
written to ``<out>/<scenario>.r<rank>.npz``.  It imports torch, numpy and
docqa_tpu_torch only.

    python torch_mesh_worker.py REPO INIT_FILE WORLD RANK OUT SCENARIO[,...] [TIMEOUT_S]

The inputs are drawn here from numpy seeds by the same helpers the test
imports (:func:`attn_inputs` and the configs below), or read from
``<out>/inputs.npz`` where only the reference can draw them.
"""

import os
import subprocess
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")

from datetime import timedelta  # noqa: E402

import numpy as np  # noqa: E402

TP_WIDTHS = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=8,
                 num_kv_heads=8, head_dim=16, mlp_dim=128, max_seq_len=128,
                 dtype="float32")
# tests/test_quant.py's TP case (int8) and its int4 one (one group a
# projection: the groups never divide the model axis), and a config whose
# int4 groups divide it for w_down (4 groups) and for wo at n = 2 (2 groups)
QUANT_WIDTHS = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=8,
                    num_kv_heads=8, head_dim=8, mlp_dim=128, max_seq_len=128,
                    dtype="float32")
INT4_DIV_WIDTHS = dict(vocab_size=256, hidden_dim=256, num_layers=1, num_heads=8,
                       num_kv_heads=4, head_dim=32, mlp_dim=512, max_seq_len=128,
                       dtype="float32")
PROMPTS = [[3, 4, 5], [9, 8, 7, 6]]
# a vocabulary no model axis here divides: the gathered logits are padded
UNEVEN_VOCAB = 125
ENC_WIDTHS = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
                  mlp_dim=128, max_seq_len=64, embed_dim=64, dtype="float32")
S2S_WIDTHS = dict(vocab_size=256, d_model=64, enc_layers=2, dec_layers=2, num_heads=4,
                  mlp_dim=128, max_src_len=64, max_tgt_len=32, dtype="float32")
S2S_SRC = [[5, 9, 11, 7], list(range(3, 40)), [8], [4, 8, 2, 6, 10]]
RETRIEVE_TEXTS = [f"note {i} about diabetes metformin dose {i % 7} and blood pressure "
                  f"{'high' if i % 3 else 'low'} patient p{i % 4}" for i in range(40)]
RETRIEVE_QUERIES = ["diabetes management", "blood pressure high", "metformin dose 3"]
# the ring tests' recipes: (name, b, s, hq, hkv, d, seed, causal, lengths)
RING_CASES = [
    ("dense", 2, 64, 8, 8, 16, 0, False, None),
    ("dense_causal", 2, 64, 8, 8, 16, 0, True, None),
    ("lengths_gqa", 2, 64, 8, 2, 16, 1, True, [37, 64]),
    ("masked_rows", 2, 32, 4, 4, 8, 2, False, [0, 32]),
]
ULYSSES_CASES = [
    ("ulysses", 2, 64, 8, 8, 16, 3, False, [50, 64]),
    ("ulysses_causal", 2, 64, 8, 8, 16, 3, True, [50, 64]),
    ("ulysses_gqa", 2, 64, 8, 2, 16, 5, True, [50, 64]),
]
RING_2D = ("ring_2d", 2, 32, 4, 4, 8, 4, True, None)
# every recipe at (1, 4); at (1, 2) the two that mix GQA, lengths and
# causality (the reference's ring programs compile slowly)
RING_ON_2 = ("lengths_gqa", "ulysses_gqa")


def attn_inputs(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, d), dtype=np.float32)
    return q, k, v


def topk_scores():
    return np.random.default_rng(8).normal(size=(4, 64)).astype(np.float32)


def store_vectors(n, dim, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def cache_tensor():
    return np.random.default_rng(11).standard_normal((4, 16, 8, 4), dtype=np.float32)


def pool_tensor():
    return np.random.default_rng(12).standard_normal((64, 8, 4), dtype=np.float32)


def mesh_shapes(world):
    return [(1, 2)] if world == 2 else [(1, 4), (2, 2)]


# ---- the runtime on a mesh (tests/test_torch_mesh_runtime.py) --------------

# tests/test_torch_app.py's tiny runtime over a real (seeded) encoder and a
# decoder that decodes: 8 q and 8 kv heads divide every model axis here
RT_CFG = {
    "encoder.embed_dim": 64, "store.dim": 64, "store.shard_capacity": 256,
    "store.dtype": "float32",
    "encoder.vocab_size": 512, "encoder.hidden_dim": 64, "encoder.num_layers": 2,
    "encoder.num_heads": 8, "encoder.mlp_dim": 128, "encoder.max_seq_len": 128,
    "encoder.dtype": "float32",
    "ner.hidden_dim": 32, "ner.num_layers": 1, "ner.num_heads": 2,
    "ner.mlp_dim": 64, "ner.train_steps": 0,
    "decoder.hidden_dim": 64, "decoder.num_layers": 2, "decoder.num_heads": 8,
    "decoder.num_kv_heads": 8, "decoder.head_dim": 8, "decoder.mlp_dim": 128,
    "decoder.vocab_size": 512, "decoder.max_seq_len": 512,
    "decoder.dtype": "float32",
    "generate.max_new_tokens": 8, "generate.max_concurrent": 2,
    "generate.prefill_buckets": (64, 128, 256, 512),
    "generate.startup_warm_buckets": 1,
    "summarizer.max_summary_tokens": 8, "summarizer.max_input_tokens": 448,
    "pool.canary_interval_s": 3600.0,
    "resilience.request_deadline_s": 0.0,
    "qos.defer_batch_on_burn": False,
}
RT_NOTES = [
    ("okafor.txt", "p1", "admission", "2024-03-05",
     "Admission note: patient Okafor admitted to ward B for observation after "
     "a fall at home. Aspirin 100 mg daily."),
    ("nguyen.txt", "p2", "registration", "2024-04-10",
     "Registration sheet: patient Nguyen, next of kin listed as spouse. "
     "Metformin 850 mg twice daily."),
    ("silva.txt", "p1", "medication", "2023-11-30",
     "Medication list for patient Silva: metformin 850 mg twice daily with "
     "meals, dosage reviewed at last visit."),
    ("lavoie.txt", "p3", None, None,
     "Compte rendu: la patiente Lavoie presente une tension arterielle de "
     "150/95 mmHg, lisinopril 10 mg par jour."),
]
RT_QUESTIONS = [
    "Why was patient Okafor admitted for observation?",
    "What is the dosage of metformin for patient Silva?",
    "Which medication lowers the blood pressure of patient Lavoie?",
]
# the tiered runtime: a tier over the handful of ingested chunks, probed whole
RT_TIERED = {"store.serving_index": "tiered", "store.ivf_min_rows": 4}
# the runs of a world of 2, of a world of 4, and their overrides
RT_RUNS = {
    "greedy": {"pool.replicas": 2},
    "sampled": {"generate.temperature": 0.8, "generate.speculative_k": 0},
    "wide": {"mesh.data_parallel": 2},
    "refused": {"store.serving_index": "tiered"},
    "tiered": RT_TIERED,
    "tiered_wide": {**RT_TIERED, "mesh.data_parallel": 2},
}
N_CONCURRENT = 8
LEX_WORDS = ("metformin aspirin lisinopril insulin diabete hypertension asthme fracture "
             "chute observation dose mg daily twice patient ward admission sortie "
             "tension arterielle glycemie mrn 40081223 01.42.34.56.78 co-amoxiclav "
             "anti-inflammatoire renal hepatique cardiaque pulmonaire").split()


def lex_texts(n=150, seed=4):
    """Seeded notes of 4 to 24 words of LEX_WORDS: few rows tie."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(LEX_WORDS, size=int(rng.integers(4, 25))))
            for _ in range(n)]


LEX_TEXTS = lex_texts()
LEX_QUERIES = ["metformin dose twice daily", "mrn 40081223 hypertension",
               "tension arterielle 01.42.34.56.78", "unknown words only"]
LEX_DELETED = [3, 50, 149]
LEX_VOCAB, LEX_WIDTH, LEX_K = 4096, 8, 7
NER_WIDTHS = dict(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=2,
                  mlp_dim=64, max_seq_len=64, dtype="float32")
NER_BATCH, NER_SEQ, NER_LR, NER_STEPS = 8, 48, 2e-3, 3


def rt_post(base, path, payload, timeout=120):
    """POST ``payload`` as JSON; (status, decoded body)."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def rt_call(base, method, path, timeout=60):
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def rt_ingest(call_post):
    """Every note of RT_NOTES through /ingest/?wait=1; their doc ids."""
    ids = []
    for filename, pid, dtype, date, text in RT_NOTES:
        status, body = call_post("/ingest/?wait=1", {
            "filename": filename, "text": text, "patient_id": pid,
            "doc_type": dtype, "doc_date": date})
        assert status == 200, body
        ids.append(body["doc_id"])
    return ids


def rt_answer(status, body):
    """The parts of an /ask answer the tests compare."""
    if status != 200:
        return {"status": status}
    return {"status": status, "answer": body.get("answer"),
            "degraded": bool(body.get("degraded")),
            "sources": list(body.get("sources") or [])}


def retrieval_rows(results):
    """A retrieval's [(row id, score)] per query."""
    return [[(int(r.row_id), float(r.score)) for r in row] for row in results]


# ---- tiered retrieval on a mesh (tests/test_torch_mesh_tiered.py) ------------

IVF_DIM = 64
IVF_C = 30  # divides none of the model axes here: padded cells are masked
IVF_NPROBES = (2, 8, 30)
TIER_ENC = dict(vocab_size=128, hidden_dim=32, num_layers=1, num_heads=4, mlp_dim=64,
                max_seq_len=16, embed_dim=IVF_DIM, dtype="float32")
TIER_TEXTS = [f"note {i}: drug-{i % 13} for condition-{i % 7}" for i in range(300)]
TIER_QUERIES = ["drug-3 for condition-3", "drug-7 for condition-0"]
# every other note is a letter: the filtered retrieval's exact path
TIER_DOC_TYPES = ("note", "letter")
TIER_FILTER = {"doc_type": "note"}
RAG_CHUNKS = [f"chunk {i}: aspirin reduces cardiac risk {i % 5} and metformin controls "
              f"glucose {i % 3}" for i in range(24)]
RAG_QUESTIONS = ["what reduces cardiac risk?", "how is glucose controlled?"]
RAG_WIDTH = 32
# tests/test_torch_rag_fused.py's decoder with 8 q and 8 kv heads (they divide
# the model axis); its context fits the whole QA template
RAG_DEC = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=8, num_kv_heads=8,
               head_dim=8, mlp_dim=128, max_seq_len=1024, dtype="float32")
RAG_GEN = dict(temperature=0.0, eos_id=2, prefill_buckets=(128, 256, 512), max_new_tokens=12)
RT_EXTRA_NOTE = ("martin.txt", "p4", "admission", "2024-05-02",
                 "Admission note: patient Martin admitted for chest pain, aspirin "
                 "300 mg loading dose, troponin pending.")
REBUILD_SLOW_S = 2.0  # the leader's k-means held this long under load


def clustered(n, d=IVF_DIM, n_centers=32, seed=0):
    """tests/test_ivf_sharded.py's corpus."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4
    assign = rng.integers(0, n_centers, n)
    x = (centers[assign] + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def near(x, n, seed):
    """The first ``n`` rows of ``x`` moved a little."""
    rng = np.random.default_rng(seed)
    return x[:n] + 0.01 * rng.standard_normal((n, x.shape[1])).astype(np.float32)


def ivf_rows(res, k):
    """(ids, scores) [q, k] of IVFIndex.search's rows, padded with -1."""
    ids = np.full((len(res), k), -1, np.int64)
    scores = np.full((len(res), k), -1.0, np.float32)
    for qi, row in enumerate(res):
        for j, (s, rid, _m) in enumerate(row):
            ids[qi, j], scores[qi, j] = rid, s
    return ids, scores


def result_rows(res, k):
    """(ids, scores) [q, k] of SearchResult rows, padded with -1."""
    return ivf_rows([[(r.score, r.row_id, r.metadata) for r in row] for row in res], k)


def lapsing_deadline():
    """A deadline live until its command is published and spent inside it
    (a budget the slot wait, the marshal or the tail's upload ate)."""
    from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded
    from docqa_tpu_torch.runtime.mesh import in_command

    class Lapsing(Deadline):
        def remaining(self):
            return -1.0 if in_command() else 60.0

        @property
        def expired(self):
            return in_command()

        def check(self, stage=""):
            if in_command():
                raise DeadlineExceeded(stage, 1.0)

    return Lapsing(expires_at=0.0, budget_s=60.0)


def tier_script(base, rt):
    """:func:`tier_requests` over HTTP to ``base``."""
    return tier_requests(lambda path, payload: rt_post(base, path, payload),
                         lambda path: rt_call(base, "GET", path)[1], rt)


def tier_requests(post, get, rt):
    """The tiered runtime's requests (the leader's, or the reference's in
    the test process): ingest, a rebuild, the questions dense then hybrid,
    then a background rebuild under load (the tail's threshold lowered, one
    more note, the questions asked while it runs), /api/retrieval and
    /api/status."""
    ids = rt_ingest(post)
    tiered = rt.search_index
    out = {"doc_ids": ids, "rebuilt": bool(tiered.rebuild())}
    out["dense"] = [rt_answer(*post("/ask/", {"question": q})) for q in RT_QUESTIONS]
    tiered.default_mode = "hybrid"
    out["hybrid"] = [rt_answer(*post("/ask/", {"question": q})) for q in RT_QUESTIONS]
    tiered.default_mode = "dense"
    tiered.rebuild_tail_rows = 1
    filename, pid, dtype, date, text = RT_EXTRA_NOTE
    status, body = post("/ingest/?wait=1", {"filename": filename, "text": text,
                                            "patient_id": pid, "doc_type": dtype,
                                            "doc_date": date})
    assert status == 200, body
    out["doc_ids"].append(body["doc_id"])
    out["during"], out["rebuilding"] = [], []
    for q in RT_QUESTIONS:
        out["during"].append(rt_answer(*post("/ask/", {"question": q})))
        out["rebuilding"].append(bool(tiered._rebuilding))
    tiered.close()
    out["covered_all"] = tiered.covered == rt.store.count
    out["retrieval"] = get("/api/retrieval")
    out["status_mesh"] = get("/api/status").get("mesh")
    return out


# ---- the trainers on a mesh (tests/test_torch_mesh_train.py) -----------------

# tests/test_torch_train_lm.py's DEC with 4 q and 4 kv heads (they divide
# every model axis here)
TRAIN_WIDTHS = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
                    num_kv_heads=4, head_dim=8, mlp_dim=64, max_seq_len=64,
                    dtype="float32")
TRAIN_UNEVEN_VOCAB = 62  # cut 16, 16, 16, 14 at a model axis of 4
TRAIN_LR, TRAIN_SEED = 1e-2, 3
# one ragged 4 x 16 batch a step; the data shards of every mesh here hold
# different token counts
TRAIN_LENGTHS = ((16, 13, 7, 5), (9, 16, 4, 12), (6, 8, 16, 15), (11, 3, 14, 16))
TRAIN_STEPS = 3
ENC_TRAIN_BATCH, ENC_TRAIN_SEQ, ENC_TRAIN_STEPS = 8, 16, 3
CKPT_SEED, CKPT_TEMPLATE_SEED = 5, 9
CKPT_WAIT_S = 120.0


def train_batch(i, vocab=64):
    """Step ``i``'s ids [4, 16] in [1, vocab) and TRAIN_LENGTHS[i]."""
    rng = np.random.default_rng(100 + i)
    ids = rng.integers(1, vocab, (4, 16)).astype(np.int32)
    return ids, np.array(TRAIN_LENGTHS[i % len(TRAIN_LENGTHS)], np.int32)


def enc_train_batch(i, cfg, b=ENC_TRAIN_BATCH):
    from docqa_tpu_torch.text.tokenizer import default_tokenizer
    from docqa_tpu_torch.training import encoder

    pairs = encoder.synthetic_pairs(np.random.default_rng(200 + i), b)
    return encoder.encode_pair_batch(default_tokenizer(cfg.vocab_size), pairs,
                                     ENC_TRAIN_SEQ)


def wait_for_step(directory, step, timeout_s=CKPT_WAIT_S):
    """Poll until a checkpoint at ``step`` is committed in ``directory``."""
    from docqa_tpu_torch.training.checkpoint import TrainCheckpointer

    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if os.path.isdir(directory) and TrainCheckpointer(directory).latest_step() == step:
            return
        time.sleep(0.1)
    raise TimeoutError(f"no checkpoint at step {step} in {directory}")


class Worker:
    def __init__(self, world, rank, out):
        import torch

        from docqa_tpu_torch.runtime import mesh as M

        torch.set_num_threads(1)
        self.torch, self.M = torch, M
        self.world, self.rank, self.out = world, rank, out
        self._meshes = {}
        self._recording = False

    def mesh(self, shape):
        if shape not in self._meshes:
            from docqa_tpu_torch.config import MeshConfig

            self._meshes[shape] = self.M.make_mesh(
                MeshConfig(data_parallel=shape[0], model_parallel=shape[1],
                           platform="cpu"))
        return self._meshes[shape]

    def save(self, name, **arrays):
        path = os.path.join(self.out, f"{name}.r{self.rank}.npz")
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)

    def counted(self, fn):
        """(fn's result, the collectives it issued by key)."""
        self.M.COLLECTIVES.clear()
        res = fn()
        return res, dict(self.M.COLLECTIVES)

    @staticmethod
    def counts(d, prefix=""):
        keys = sorted(d)
        return {f"{prefix}ckeys": np.array(keys), f"{prefix}cvals": np.array([d[k] for k in keys])}

    def streamed(self, mesh, targets, lead):
        """Register ``targets`` ((name, object) pairs, in the same order on
        every rank) with a command stream over ``mesh``: the leader opens
        it, runs ``lead()`` and stops it, every other rank replays its
        commands.  Returns this rank's command digest of that run."""
        stream = self.M.CommandStream(mesh)
        for name, obj in targets:
            stream.register(name, obj)
        self.M.reset_commands()
        if stream.leader:
            stream.open()
            try:
                lead()
            finally:
                stream.stop()
        else:
            stream.follow()
        return self.M.command_digest()

    def replayed(self, obj, method, log):
        """Record each outermost call of ``obj.<method>`` on this rank (the
        leader's own, or a follower's replay of its command) in ``log`` as
        (result, the collectives it issued)."""
        fn = getattr(obj, method)

        def rec(*a, **k):
            if self._recording:
                return fn(*a, **k)
            self._recording = True
            try:
                log.append(self.counted(lambda: fn(*a, **k)))
            finally:
                self._recording = False
            return log[-1][0]

        setattr(obj, method, rec)

    # ---- scenarios -------------------------------------------------------

    def mesh_basics(self):
        out = {}
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            out[tag + "_coords"] = np.array([m.n_data, m.n_model, m.data_index,
                                             m.model_index, m.rank])
            out[tag + "_model_ranks"] = np.array(self.M.ranks_of(m.model_group))
            out[tag + "_data_ranks"] = np.array(self.M.ranks_of(m.data_group))
        self.save("mesh_basics", **out)

    def _trees(self):
        from docqa_tpu_torch import weights
        from docqa_tpu_torch.config import DecoderConfig

        tp = DecoderConfig(**TP_WIDTHS)
        q8 = DecoderConfig(**QUANT_WIDTHS)
        q4 = DecoderConfig(**INT4_DIV_WIDTHS)
        return {
            "float": (tp, weights.host_init_decoder_params(tp, 1)),
            "int8": (q8, weights.host_init_quantized_decoder_params(q8, 0, 8)),
            "int4": (q8, weights.host_init_quantized_decoder_params(q8, 0, 4)),
            "int4div": (q4, weights.host_init_quantized_decoder_params(q4, 0, 4)),
        }

    def shard_trees(self):
        from docqa_tpu_torch import weights
        from docqa_tpu_torch.parallel import sharding as S

        trees = self._trees()
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            out = {}
            for kind, (cfg, tree) in trees.items():
                host = {k: weights.leaf_to_tensor(v) for k, v in tree.items()}
                for name, t in S.shard_decoder_params(host, cfg, m).items():
                    out[f"{kind}/{name}"] = t.numpy()
            cfg = trees["float"][0]
            cache = self.torch.from_numpy(cache_tensor())
            out["cache/k0"] = S.shard_kv_cache({"k0": cache}, cfg, m)["k0"].numpy()
            pool = self.torch.from_numpy(pool_tensor())
            out["pool/k0"] = S.shard_paged_pools({"k0": pool}, cfg, m)["k0"].numpy()
            self.save(f"shard_trees_{tag}", **out)

    def topk(self):
        from docqa_tpu_torch.ops.topk import sharded_topk

        m = self.mesh((1, self.world))
        scores = topk_scores()
        n_local = scores.shape[1] // m.n_model
        local = self.torch.from_numpy(scores[:, m.model_index * n_local:
                                             (m.model_index + 1) * n_local])
        (vals, ids), c = self.counted(
            lambda: sharded_topk(local, m.model_index * n_local, 5, m.model_group))
        self.save("topk", vals=vals.numpy(), ids=ids.numpy(), **self.counts(c))

    def ring(self):
        from docqa_tpu_torch.parallel import ring_attention, ulysses_attention

        torch = self.torch
        out = {}
        cases = [(c, (1, self.world), ring_attention) for c in RING_CASES]
        cases += [(c, (1, self.world), ulysses_attention) for c in ULYSSES_CASES]
        if self.world == 2:
            cases = [case for case in cases if case[0][0] in RING_ON_2]
        else:
            cases.append((RING_2D, (2, 2), ring_attention))
        for (name, b, s, hq, hkv, d, seed, causal, lengths), shape, fn in cases:
            q, k, v = (torch.from_numpy(a) for a in attn_inputs(b, s, hq, hkv, d, seed))
            lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
            m = self.mesh(shape)
            res, c = self.counted(lambda: fn(q, k, v, m, causal=causal, lengths=lens))
            out[name] = res.numpy()
            out.update(self.counts(c, name + "/"))
        self.save("ring", **out)

    def _engine(self, cfg, mesh, **gen_kw):
        from docqa_tpu_torch.config import GenerateConfig
        from docqa_tpu_torch.engines.generate import GenerateEngine

        return GenerateEngine(cfg, GenerateConfig(**gen_kw), seed=1, device="cpu",
                              mesh=mesh)

    def tp_generate(self):
        from docqa_tpu_torch.config import DecoderConfig

        torch = self.torch
        cfg = DecoderConfig(**TP_WIDTHS)
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            out = {}
            for k in (0, 4):
                eng = self._engine(cfg, m, max_new_tokens=6, speculative_k=k)
                ids, c = self.counted(lambda: eng.generate_ids(PROMPTS))
                out[f"spec{k}/ids"] = np.array([r + [-1] * (6 - len(r)) for r in ids])
                out[f"spec{k}/forwards"] = np.array(eng.last_stats["forwards"])
                out.update(self.counts(c, f"spec{k}/"))
            # the first step's logits over the whole vocabulary (float32)
            ids = torch.tensor([[3, 4, 5, 0], [9, 8, 7, 6]])
            lengths = torch.tensor([3, 4], dtype=torch.int32)
            cache = eng._new_cache(2, 128)
            with torch.inference_mode():
                logits, c = self.counted(lambda: eng.forward(
                    ids, cache, torch.zeros_like(lengths), attn_lengths=lengths,
                    last_token_only=True))
            out["logits"] = logits.numpy()
            out["cache_heads"] = np.array(cache["k0"].shape[2])
            out.update(self.counts(c, "prefill/"))
            # sampled: every rank of a model group must draw the same tokens
            eng = self._engine(cfg, m, max_new_tokens=6, speculative_k=4)
            ids, c = self.counted(
                lambda: eng.generate_ids(PROMPTS, temperature=0.8, seed=5))
            out["sampled/ids"] = np.array([r + [-1] * (6 - len(r)) for r in ids])
            out["sampled/forwards"] = np.array(eng.last_stats["forwards"])
            out.update(self.counts(c, "sampled/"))
            uneven = DecoderConfig(**{**TP_WIDTHS, "vocab_size": UNEVEN_VOCAB})
            ids = self._engine(uneven, m, max_new_tokens=6).generate_ids(PROMPTS)
            out["uneven/ids"] = np.array([r + [-1] * (6 - len(r)) for r in ids])
            ids = self._engine(uneven, None, max_new_tokens=6).generate_ids(PROMPTS)
            out["uneven/solo_ids"] = np.array([r + [-1] * (6 - len(r)) for r in ids])
            self.save(f"tp_generate_{tag}", **out)

    def quant_tp(self):
        from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
        from docqa_tpu_torch.engines.generate import GenerateEngine

        inputs = np.load(os.path.join(self.out, "inputs.npz"))
        q8 = {k[len("int8/"):]: inputs[k] for k in inputs.files if k.startswith("int8/")}
        cfg8 = DecoderConfig(**QUANT_WIDTHS)
        cfg4 = DecoderConfig(**{**QUANT_WIDTHS, "quantize_weights": True, "quant_bits": 4})
        cfg4d = DecoderConfig(**{**INT4_DIV_WIDTHS, "quantize_weights": True,
                                 "quant_bits": 4})
        gen = GenerateConfig(max_new_tokens=6, prefill_buckets=(16,))
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            out = {}
            runs = [("int8", cfg8, dict(params=q8)), ("int4", cfg4, {}),
                    ("int4div", cfg4d, {})]
            for name, cfg, kw in runs:
                eng = GenerateEngine(cfg, gen, device="cpu", mesh=m, **kw)
                ids, c = self.counted(lambda: eng.generate_ids([[5, 9, 11]]))
                out[name] = np.array(ids[0] + [-1] * (6 - len(ids[0])))
                out.update(self.counts(c, name + "/"))
            self.save(f"quant_tp_{shape[0]}x{shape[1]}", **out)

    def _store_cfg(self):
        from docqa_tpu_torch.config import StoreConfig

        return StoreConfig(dim=64, shard_capacity=256, dtype="float32")

    def store(self):
        from docqa_tpu_torch.index.store import VectorStore

        m = self.mesh((1, self.world))
        out = {}

        def rows(res):
            return (np.array([[r.row_id for r in row] for row in res]),
                    np.array([[r.score for r in row] for row in res]))

        v = store_vectors(512, 64)
        q = store_vectors(3, 64, seed=3)
        st = VectorStore(self._store_cfg(), device="cpu", mesh=m)
        st.add(v, [{"doc_id": f"d{i}"} for i in range(512)])
        res, c = self.counted(lambda: st.search(q, k=7))
        out["match/ids"], out["match/scores"] = rows(res)
        out.update(self.counts(c, "match/"))
        out["match/block"] = np.array(st._dev.shape[0])

        st = VectorStore(self._store_cfg(), device="cpu", mesh=m)
        v = store_vectors(1500, 64)
        meta = [{"patient_id": f"P{i % 5}", "doc_id": f"doc{i // 10}"} for i in range(1500)]
        st.add(v[:800], meta[:800])
        out["grow/cap800"] = np.array(st.capacity)
        st.add(v[800:], meta[800:])
        out["grow/cap1500"] = np.array(st.capacity)
        out["grow/filtered"] = rows(st.search(v[1203], k=4, filters={"patient_id": "P3"}))[0]
        out["grow/all"] = rows(st.search(v[[5, 700, 1203, 1499]], k=6))[0]
        st.delete_docs([f"doc{i}" for i in range(70, 130)])
        out["grow/deleted"] = rows(st.search(v[[5, 700, 1203, 1499]], k=6))[0]
        out["grow/compacted_n"] = np.array(st.compact_deleted())
        out["grow/cap_compacted"] = np.array(st.capacity)
        out["grow/compacted"] = rows(st.search(v[[5, 700, 1203, 1499]], k=6))[0]
        self.save("store", **out)

    def retrieve(self):
        from docqa_tpu_torch.config import EncoderConfig, StoreConfig
        from docqa_tpu_torch.engines.encoder import EncoderEngine
        from docqa_tpu_torch.engines.retrieve import FusedRetriever
        from docqa_tpu_torch.index.store import VectorStore

        m = self.mesh((2, 2))
        enc = EncoderEngine(EncoderConfig(**ENC_WIDTHS), device="cpu", mesh=m)
        emb, c_enc = self.counted(lambda: enc.encode_texts(RETRIEVE_TEXTS))
        st = VectorStore(StoreConfig(dim=64, shard_capacity=256), device="cpu", mesh=m)
        st.add(emb, [{"doc_id": f"d{i}", "patient_id": f"p{i % 4}"}
                     for i in range(len(RETRIEVE_TEXTS))])
        retr = FusedRetriever(enc, st)
        res, c = self.counted(lambda: retr.search_texts(RETRIEVE_QUERIES, k=5,
                                                        return_emb=True))
        filt = retr.search_texts(RETRIEVE_QUERIES[:1], k=6, filters={"patient_id": "p2"})
        self.save("retrieve", emb=emb, qemb=res[1],
                  ids=np.array([[r.row_id for r in row] for row in res[0]]),
                  scores=np.array([[r.score for r in row] for row in res[0]]),
                  filtered=np.array([r.row_id for r in filt[0]]),
                  **self.counts(c), **self.counts(c_enc, "enc/"))

    def seq2seq(self):
        from docqa_tpu_torch.config import Seq2SeqConfig
        from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine
        from docqa_tpu_torch.models import seq2seq as P

        P.GELU_APPROXIMATE = "tanh"  # the reference's MLP (test_torch_seq2seq.py)
        m = self.mesh((2, 2))
        eng = Seq2SeqEngine(Seq2SeqConfig(**S2S_WIDTHS), seed=0, device="cpu", mesh=m)
        ids, c = self.counted(lambda: eng.generate_ids(S2S_SRC, max_new_tokens=10))
        self.save("seq2seq", ids=np.array([r + [-1] * (10 - len(r)) for r in ids]),
                  **self.counts(c))

    def runtime_refused(self):
        """Tiered serving in a world of more than one rank, once refused:
        it boots, and the leader ingests the notes and answers a question
        over HTTP."""
        def script(base, rt):
            rt_ingest(lambda path, payload: rt_post(base, path, payload))
            return {"index": type(rt.search_index).__name__,
                    "retriever": type(rt.qa.retriever).__name__,
                    "ask": rt_answer(*rt_post(base, "/ask/", {"question": RT_QUESTIONS[0]}))}

        self._runtime("refused", None, script)

    # ---- the runtime on a mesh --------------------------------------------

    def _record_batches(self):
        """Every batcher dispatch's fetched result on this rank, by batcher,
        and every retrieval's rows and scores: the leader's and a
        follower's must be equal."""
        from docqa_tpu_torch.engines import retrieve, serve

        rec = []
        search = retrieve.FusedRetriever._search_texts

        def rec_search(r, *a, **k):
            res = search(r, *a, **k)
            rec.append(("retriever", "search", retrieval_rows(
                res[0] if k.get("return_emb") else res)))
            return res
        prefill, decode = (serve.ContinuousBatcher._prefill_round,
                           serve.ContinuousBatcher._decode_chunk)

        def rec_prefill(b, *a, **k):
            t = prefill(b, *a, **k)
            rec.append((b._command_name, "prefill", t.result().numpy().tolist()))
            return t

        def rec_decode(b, *a, **k):
            t = decode(b, *a, **k)
            rec.append((b._command_name, "decode", t.result()[0].numpy().tolist()))
            return t

        serve.ContinuousBatcher._prefill_round = rec_prefill
        serve.ContinuousBatcher._decode_chunk = rec_decode
        retrieve.FusedRetriever._search_texts = rec_search

        def restore():
            serve.ContinuousBatcher._prefill_round = prefill
            serve.ContinuousBatcher._decode_chunk = decode
            retrieve.FusedRetriever._search_texts = search

        return rec, restore

    def _runtime(self, run, work_dir, script, extra=None):
        """Boot DocQARuntime under RT_CFG + RT_RUNS[run]; the leader serves
        on 127.0.0.1 port 0 and runs ``script(base)``, every other rank
        follows.  Saves ``runtime_<run>`` with the rank's command digest,
        its batches and its store, and ``extra(rt)``'s arrays."""
        import json

        from docqa_tpu_torch.config import load_config
        from docqa_tpu_torch.index.store import VectorStore
        from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

        snapshots = []
        snap = VectorStore.snapshot

        def counted_snapshot(st, *a, **k):
            snapshots.append(1)
            return snap(st, *a, **k)

        VectorStore.snapshot = counted_snapshot
        overrides = {**RT_CFG, **RT_RUNS.get(run, {})}
        if work_dir:
            overrides["data.work_dir"] = work_dir
        self.M.reset_commands()
        self.M.COLLECTIVES.clear()
        rec, restore = self._record_batches()
        rt = DocQARuntime(load_config(env={}, overrides=overrides), device="cpu")
        out = {}
        if rt.follower:
            rt.follow()
            rt.stop()
        else:
            rt.start()
            server = AppServer(make_app(rt), "127.0.0.1", 0).start()
            try:
                out = script(f"http://127.0.0.1:{server.port}", rt)
            finally:
                server.close()
                rt.stop()
        restore()
        VectorStore.snapshot = snap
        st = rt.store
        live = [m.get("doc_id") for m in st.metadata_select()]
        self.save(f"runtime_{run}", digest=np.array(self.M.command_digest()),
                  commands=np.array(json.dumps(dict(self.M.COMMANDS))),
                  collectives=np.array(json.dumps(dict(self.M.COLLECTIVES))),
                  batches=np.array(json.dumps(rec)), results=np.array(json.dumps(out)),
                  count=np.array(st.count), deleted=np.array(st.deleted_count),
                  live_docs=np.array(json.dumps(sorted(set(live)))),
                  snapshots=np.array(len(snapshots)), **(extra(rt) if extra else {}))

    def _serve_script(self, n_concurrent):
        """The leader's requests: ingest, ask each question, ``n_concurrent``
        asks at once, delete the first document, ask again, /api/status."""
        from concurrent.futures import ThreadPoolExecutor

        def script(base, rt):
            post = lambda path, payload: rt_post(base, path, payload)  # noqa: E731
            ids = rt_ingest(post)
            out = {"doc_ids": ids, "asks": [rt_answer(*post("/ask/", {"question": q}))
                                            for q in RT_QUESTIONS]}
            if n_concurrent:
                qs = [RT_QUESTIONS[i % len(RT_QUESTIONS)] for i in range(n_concurrent)]
                with ThreadPoolExecutor(n_concurrent) as pool:
                    futs = [pool.submit(post, "/ask/", {"question": q}) for q in qs]
                    out["concurrent"] = [rt_answer(*f.result(timeout=300)) for f in futs]
            out["delete"] = rt_call(base, "DELETE", f"/documents/{ids[0]}")[0]
            out["after_delete"] = [rt_answer(*post("/ask/", {"question": q}))
                                   for q in RT_QUESTIONS]
            out["status_mesh"] = rt_call(base, "GET", "/api/status")[1].get("mesh")
            return out

        return script

    def runtime_greedy(self):
        self._runtime("greedy", os.path.join(self.out, "work"),
                      self._serve_script(N_CONCURRENT))

    def runtime_restart(self):
        """A second boot over runtime_greedy's work dir: every rank
        restores the leader's snapshot; the questions again."""
        def script(base, rt):
            return {"asks": [rt_answer(*rt_post(base, "/ask/", {"question": q}))
                             for q in RT_QUESTIONS], "restored": rt.store.count}

        self._runtime("restart", os.path.join(self.out, "work"), script)

    def runtime_sampled(self):
        self._runtime("sampled", None, self._serve_script(0))

    def runtime_wide(self):
        self._runtime("wide", None, self._serve_script(0))

    def runtime_lost_rank(self):
        """The leader serves; once it has answered, rank 1 kills itself
        mid-serve; the leader's next /ask must fail 5xx within the process
        group's timeout, and its stop() must return."""
        import signal
        import threading
        import time as _time

        from docqa_tpu_torch.config import load_config
        from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

        flag = os.path.join(self.out, "kill_rank1")
        rt = DocQARuntime(load_config(env={}, overrides=dict(RT_CFG)), device="cpu")
        if rt.follower:
            def watchdog():
                while not os.path.exists(flag):
                    _time.sleep(0.05)
                os.kill(os.getpid(), signal.SIGKILL)

            threading.Thread(target=watchdog, daemon=True).start()
            rt.follow()
            return
        rt.start()
        server = AppServer(make_app(rt), "127.0.0.1", 0).start()
        base = f"http://127.0.0.1:{server.port}"
        post = lambda path, payload: rt_post(base, path, payload)  # noqa: E731
        rt_ingest(post)
        first = post("/ask/", {"question": RT_QUESTIONS[0]})[0]
        open(flag, "w").close()
        _time.sleep(1.0)
        t0 = _time.perf_counter()
        try:
            status = post("/ask/", {"question": RT_QUESTIONS[1]})[0]
        except Exception as e:  # noqa: BLE001 - a dropped connection is a result too
            status = f"{type(e).__name__}: {e}"
        ask_s = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        server.close()
        try:
            rt.stop()
        except Exception as e:  # noqa: BLE001 - the kept fault is expected
            stop_error = f"{type(e).__name__}"
        else:
            stop_error = ""
        self.save("runtime_lost_rank", first=np.array(first), status=np.array(str(status)),
                  ask_s=np.array(ask_s), stop_s=np.array(_time.perf_counter() - t1),
                  stop_error=np.array(stop_error))
        os._exit(0)  # the process group cannot be torn down with a rank gone

    # ---- the sharded lexical tier ------------------------------------------

    def lexical_sharded(self):
        from docqa_tpu_torch.index.lexical import LexicalIndex

        out = {}
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            lx = LexicalIndex(vocab_size=LEX_VOCAB, tile_width=LEX_WIDTH, device="cpu",
                              mesh=m)
            lx.add(list(range(len(LEX_TEXTS))), LEX_TEXTS)
            lx.on_delete(LEX_DELETED)
            res, c = self.counted(lambda: lx.search(LEX_QUERIES, k=LEX_K))
            q_terms, q_weights = lx.encode_queries(LEX_QUERIES)
            out[tag + "/q_terms"], out[tag + "/q_weights"] = q_terms, q_weights
            for qi, row in enumerate(res):
                out[f"{tag}/ids{qi}"] = np.array([r for _s, r in row], np.int64)
                out[f"{tag}/scores{qi}"] = np.array([sc for sc, _r in row], np.float32)
            out[tag + "/rows"] = np.array(lx.device_tiles()[0].shape[0])
            out.update(self.counts(c, tag + "/"))
        self.save("lexical_sharded", **out)

    # ---- tiered retrieval on a mesh ------------------------------------------

    def ivf_sharded(self):
        """The reference's one-device tier carried onto each mesh and
        probed; the port's own mesh build beside its one-device build; int8
        forced; the bytes a shard holds."""
        from docqa_tpu_torch.index.ivf import IVFIndex, ivf_from_arrays

        with np.load(os.path.join(self.out, "ivf_inputs.npz")) as d:
            arrays = {k: d[k] for k in d.files}
        arrays["n_assign"] = int(arrays["n_assign"])
        x = clustered(4000)
        meta = [{"row": i} for i in range(len(x))]
        q = near(x, 20, 1)
        solo = IVFIndex(x, meta, n_clusters=IVF_C, nprobe=8, dtype="float32", device="cpu")
        out = {f"solo/{k}": v for k, v in solo.arrays().items()
               if k in ("cells", "cell_scale", "cell_ids")}
        for p in IVF_NPROBES:
            out[f"solo/ids{p}"], out[f"solo/scores{p}"] = ivf_rows(solo.search(q, k=10, nprobe=p), 10)
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            carried = ivf_from_arrays(arrays, meta, nprobe=8, dtype="float32", device="cpu",
                                      mesh=m)
            own = IVFIndex(x, meta, n_clusters=IVF_C, nprobe=8, dtype="float32",
                           device="cpu", mesh=m)
            for name, ivf in (("carried", carried), ("own", own)):
                for p in IVF_NPROBES:
                    res, c = self.counted(lambda: ivf.search(q, k=10, nprobe=p))
                    out[f"{tag}/{name}/ids{p}"], out[f"{tag}/{name}/scores{p}"] = ivf_rows(res, 10)
                    out.update(self.counts(c, f"{tag}/{name}/{p}/"))
            for k, v in own.arrays().items():
                if k in ("cells", "cell_scale", "cell_ids"):
                    out[f"{tag}/own/{k}"] = v
            out[f"{tag}/cells_per_shard"] = np.array(own.cells_per_shard)
            forced = IVFIndex(x[:1000], [{}] * 1000, n_clusters=16, dtype="float32",
                              device="cpu", mesh=m, storage="float")
            out[f"{tag}/forced_storage"] = np.array(forced.storage)
            b = IVFIndex(x, [{}] * len(x), n_clusters=32, dtype="float32", device="cpu",
                         mesh=m).index_bytes()
            for k in ("shards", "per_shard_bytes", "total_bytes"):
                out[f"{tag}/bytes/{k}"] = np.array(b[k])
        self.save("ivf_sharded", **out)

    def _tiered(self, x, mesh, **kw):
        """A TieredIndex over a store of ``x`` on ``mesh``, its tier not yet
        built (in a world of ranks the leader of a command stream builds
        it)."""
        from docqa_tpu_torch.config import StoreConfig
        from docqa_tpu_torch.index.store import VectorStore
        from docqa_tpu_torch.index.tiered import TieredIndex

        store = VectorStore(StoreConfig(dim=IVF_DIM, shard_capacity=4096, dtype="float32"),
                            device="cpu", mesh=mesh)
        store.add(x, [{"doc_id": f"d{i}"} for i in range(len(x))])
        return TieredIndex(store, min_rows=100, rebuild_tail_rows=10**6, **kw)

    def tiered_sharded(self):
        """tests/test_ivf_sharded.py's TieredIndex cases on each mesh, the
        leader driving a command stream: serving and self-queries, fresh
        rows through the tail, the ids of the one-device tiered path, no
        shadow dispatch while sampling is off; a rebuild refused with no
        stream."""
        from docqa_tpu_torch.engines.spine import get_spine

        def shadows():
            row = get_spine().stats()["stages"].get("retrieve_shadow")
            return row["count"] if row else 0

        x3 = clustered(3000, seed=3)
        x21 = clustered(3000, seed=21)
        q21 = near(x21, 24, 2)
        fresh = clustered(8, seed=99)
        solo = self._tiered(x21, None, nprobe=6, n_clusters=30, seed=0)
        assert solo.rebuild()
        out = {}
        out["solo/ids"], out["solo/scores"] = result_rows(solo.search(q21, k=10), 10)
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            tiers = {"serve": self._tiered(x3, m, nprobe=8),
                     "wide": self._tiered(x21, m, nprobe=6, n_clusters=30, seed=0),
                     "quiet": self._tiered(clustered(2000, seed=11), m, nprobe=4)}
            serve, wide, quiet = tiers.values()
            try:
                serve.rebuild()
                out[f"{tag}/unstreamed_refused"] = np.array(False)
            except RuntimeError:
                out[f"{tag}/unstreamed_refused"] = np.array(True)
            log = []
            for t in tiers.values():
                self.replayed(t, "search", log)

            def lead():
                for t in tiers.values():
                    assert t.rebuild()
                serve.search(x3[77], k=5)
                serve.store.add(fresh, [{"doc_id": f"new{i}"} for i in range(8)])
                serve.search(fresh, k=1)
                wide.search(q21, k=10)
                for _ in range(4):
                    quiet.search(x3[:4], k=5)

            before = shadows()
            self.streamed(m, [(f"{name}_{part}", obj) for name, t in tiers.items()
                              for part, obj in (("store", t.store), ("tiered", t))], lead)
            assert len(log) == 7, len(log)
            (self_res, c), (fresh_res, _c), (wide_res, _c) = log[:3]
            st = serve.index_stats()
            out[f"{tag}/shards"], out[f"{tag}/storage"] = np.array(st["shards"]), np.array(st["storage"])
            out[f"{tag}/per_shard_bytes"] = np.array(st["per_shard_bytes"])
            out[f"{tag}/self_ids"], out[f"{tag}/self_scores"] = result_rows(self_res, 5)
            out.update(self.counts(c, f"{tag}/search/"))
            out[f"{tag}/fresh"] = np.array([row[0].metadata["doc_id"] for row in fresh_res])
            out[f"{tag}/generation"] = np.array(serve.tier_generation)
            out[f"{tag}/ids"], out[f"{tag}/scores"] = result_rows(wide_res, 10)
            out[f"{tag}/shadow_dispatches"] = np.array(shadows() - before)
        self.save("tiered_sharded", **out)

    def fused_tiered(self):
        """tests/test_ivf_sharded.py's fused case on each mesh, dense and
        hybrid over a lexical tier, the leader driving a command stream:
        the fused retrieval against the two-step search, collectives
        counted, no off-mesh fallback; then the same retrievals, and a
        filtered one, under a deadline that runs out once the command is
        published."""
        from docqa_tpu_torch.config import EncoderConfig, StoreConfig
        from docqa_tpu_torch.engines.encoder import EncoderEngine
        from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
        from docqa_tpu_torch.index.lexical import LexicalIndex
        from docqa_tpu_torch.index.store import VectorStore
        from docqa_tpu_torch.index.tiered import TieredIndex
        from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY

        out = {}
        fallback = DEFAULT_REGISTRY.counter("retrieve_offmesh_fallback")
        lapsing = lapsing_deadline()
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            enc = EncoderEngine(EncoderConfig(**TIER_ENC), device="cpu", mesh=m)
            store = VectorStore(StoreConfig(dim=IVF_DIM, shard_capacity=512, dtype="float32"),
                                device="cpu", mesh=m)
            lex = LexicalIndex(vocab_size=LEX_VOCAB, tile_width=LEX_WIDTH, device="cpu", mesh=m)
            store.register_index_sink(lex)
            store.add(enc.encode_texts(TIER_TEXTS),
                      [{"doc_id": f"d{i}", "source": t, "text_content": t,
                        "doc_type": TIER_DOC_TYPES[i % 2]} for i, t in enumerate(TIER_TEXTS)])
            q_emb = enc.encode_texts(TIER_QUERIES)
            tiered = TieredIndex(store, nprobe=4, min_rows=100, rebuild_tail_rows=10**6,
                                 lexical=lex)
            retr = FusedTieredRetriever(enc, tiered, device="cpu")
            log = []
            self.replayed(retr, "search_texts", log)
            self.replayed(tiered, "search", log)
            cases = [("dense", ""), ("dense", "two_"), ("hybrid", ""), ("hybrid", "two_"),
                     ("dense", "lapsed_"), ("hybrid", "lapsed_"), ("filtered", ""),
                     ("filtered", "lapsed_")]

            def lead():
                assert tiered.rebuild()
                for mode in ("dense", "hybrid"):
                    retr.search_texts(TIER_QUERIES, k=5, mode=mode)
                    tiered.search(q_emb, k=5, mode=mode, query_texts=TIER_QUERIES)
                for mode in ("dense", "hybrid"):
                    retr.search_texts(TIER_QUERIES, k=5, mode=mode, deadline=lapsing)
                for deadline in (None, lapsing):
                    retr.search_texts(TIER_QUERIES, k=5, filters=TIER_FILTER,
                                      deadline=deadline)

            f0 = fallback.value
            digest = self.streamed(m, [("tiered", tiered), ("retriever", retr)], lead)
            assert len(log) == len(cases), len(log)
            for (case, pre), (res, c) in zip(cases, log):
                out[f"{tag}/{case}/{pre}ids"], out[f"{tag}/{case}/{pre}scores"] = result_rows(res, 5)
                if pre != "two_":
                    sub = f"{pre.rstrip('_')}/" if pre else ""
                    out.update(self.counts(c, f"{tag}/{case}/{sub}"))
            out[f"{tag}/fallbacks"] = np.array(fallback.value - f0)
            out[f"{tag}/digest"] = np.array(digest)
        self.save("fused_tiered", **out)

    def _tier_extra(self, calls):
        def extra(rt):
            t = rt.search_index
            return {"generation": np.array(t.tier_generation), "covered": np.array(t.covered),
                    "rebuild_calls": np.array(len(calls)), "shards": np.array(
                        t._tier[0].n_shards if t._tier is not None else 0)}

        return extra

    def _tiered_runtime(self, run):
        """tier_script on the leader; every rank counts the rebuilds it
        started (a follower none) and, under load, the leader's k-means
        is held ``REBUILD_SLOW_S`` so the questions land during it."""
        import time as _time

        from docqa_tpu_torch.index import tiered as T

        calls = []
        rebuild, fit = T.TieredIndex.rebuild, T.fit_cells

        def counted(t, *a, **k):
            calls.append(1)
            return rebuild(t, *a, **k)

        def slow_fit(*a, **k):
            if len(calls) > 1:  # the background rebuild, not the first
                _time.sleep(REBUILD_SLOW_S)
            return fit(*a, **k)

        T.TieredIndex.rebuild, T.fit_cells = counted, slow_fit
        try:
            self._runtime(run, None, tier_script, extra=self._tier_extra(calls))
        finally:
            T.TieredIndex.rebuild, T.fit_cells = rebuild, fit

    def runtime_tiered(self):
        self._tiered_runtime("tiered")

    def runtime_tiered_wide(self):
        self._tiered_runtime("tiered_wide")

    def fused_rag(self):
        """tests/test_rag_fused.py's sharded case at (1, 2): FusedRAG over a
        row-sharded store with its sidecar and a TP generator, every rank
        asking; the classic text path on the same engine; a one-device
        store's sources; the runtime's rule of no FusedRAG on a mesh."""
        import json

        from docqa_tpu_torch.config import (
            DecoderConfig,
            EncoderConfig,
            GenerateConfig,
            StoreConfig,
            load_config,
        )
        from docqa_tpu_torch.engines.encoder import EncoderEngine
        from docqa_tpu_torch.engines.generate import GenerateEngine
        from docqa_tpu_torch.engines.rag_fused import FusedRAG
        from docqa_tpu_torch.index.store import VectorStore, sidecar_rows
        from docqa_tpu_torch.service.app import DocQARuntime
        from docqa_tpu_torch.service.qa import QA_TEMPLATE

        m = self.mesh((1, self.world))
        enc = EncoderEngine(EncoderConfig(**ENC_WIDTHS), device="cpu")
        gen = GenerateEngine(DecoderConfig(**RAG_DEC), GenerateConfig(**RAG_GEN), seed=7,
                             device="cpu", mesh=m)
        vecs = enc.encode_texts(RAG_CHUNKS)
        rows, lens = sidecar_rows(gen.tokenizer, RAG_CHUNKS, RAG_WIDTH)
        meta = [{"doc_id": f"d{i}", "source": f"chunk {i}", "text_content": t}
                for i, t in enumerate(RAG_CHUNKS)]
        cfg = StoreConfig(dim=64, shard_capacity=256, token_width=RAG_WIDTH, dtype="float32")
        stores = {"mesh": VectorStore(cfg, device="cpu", mesh=m),
                  "solo": VectorStore(cfg, device="cpu")}
        for st in stores.values():
            st.add(vecs, meta, token_rows=rows, token_lens=lens)
        rag = FusedRAG(enc, stores["mesh"], gen, QA_TEMPLATE, k=3, device="cpu")
        out = {"block": np.array(stores["mesh"].token_sidecar()[0].shape[0])}
        for qi, question in enumerate(RAG_QUESTIONS):
            got, c = self.counted(lambda: rag.ask(question, max_new_tokens=10))
            emb = enc.encode_texts([question])
            hits = stores["mesh"].search(emb, k=3)[0]
            context = "\n\n".join(h.metadata["text_content"] for h in hits)
            want = gen.generate_texts([QA_TEMPLATE.format(context=context, question=question)],
                                      max_new_tokens=10)[0]
            solo = [h.metadata["source"] for h in stores["solo"].search(emb, k=3)[0]]
            out[f"q{qi}"] = np.array(json.dumps({
                "answer": got["answer"], "sources": got["sources"], "classic": want,
                "classic_sources": [h.metadata["source"] for h in hits], "solo": solo}))
            out.update(self.counts(c, f"q{qi}/"))
        rt = DocQARuntime(load_config(env={}, overrides={**RT_CFG, "store.token_width": 8}),
                          device="cpu")
        out["runtime_fused_rag"] = np.array(rt.qa is not None and rt.qa.fused_rag is not None)
        if rt.follower:
            rt.follow()
        rt.stop()
        self.save("fused_rag", **out)

    # ---- the tagger's data-parallel step -------------------------------------

    def ner_dp(self):
        from docqa_tpu_torch.config import NERConfig
        from docqa_tpu_torch.deid import datagen
        from docqa_tpu_torch.training import ner

        inputs = np.load(os.path.join(self.out, "ner_init.npz"))
        init = {k: inputs[k] for k in inputs.files}
        cfg = NERConfig(**NER_WIDTHS)
        shape = (2, self.world // 2)
        m = self.mesh(shape)
        params = ner.trainable(init, cfg, "cpu")
        opt = ner.default_ner_optimizer(NER_LR, steps=NER_STEPS)
        state = opt.init(params)
        step = ner.make_ner_train_step(cfg, opt, mesh=m)
        rng = np.random.default_rng(0)
        tok = datagen.ner_tokenizer(cfg)
        losses = []
        self.M.COLLECTIVES.clear()
        for _ in range(NER_STEPS):
            batch = datagen.sample_batch(rng, tok, cfg, NER_BATCH, NER_SEQ)
            params, state, loss = step(params, state, *batch)
            losses.append(float(loss))
        c = dict(self.M.COLLECTIVES)
        # the runtime's entry: trained in process over the mesh, cached once
        from docqa_tpu_torch.deid.engine import DeidEngine

        cache = os.path.join(self.out, f"ner_{shape[0]}x{shape[1]}.npz")
        eng = DeidEngine.trained(cfg, params_path=cache, steps=2, device="cpu", mesh=m)
        self.save(f"ner_dp_{shape[0]}x{shape[1]}", losses=np.array(losses),
                  **{"p/" + k: v.detach().numpy() for k, v in params.items()},
                  **{"trained/" + k: np.asarray(v) for k, v in eng.params.items()},
                  **self.counts(c))

    # ---- the trainers on a mesh --------------------------------------------

    def _lm_state(self, m, seed=TRAIN_SEED, vocab=None):
        from docqa_tpu_torch import weights
        from docqa_tpu_torch.config import DecoderConfig
        from docqa_tpu_torch.training import train

        cfg = DecoderConfig(**{**TRAIN_WIDTHS, **({"vocab_size": vocab} if vocab else {})})
        state, opt = train.init_train_state(
            cfg, optimizer=train.default_optimizer(TRAIN_LR),
            params=weights.host_init_decoder_params(cfg, seed), device="cpu", mesh=m)
        return cfg, state, train.make_train_step(cfg, opt, m)

    @staticmethod
    def _moments(state):
        st = state["opt_state"].adamw.state
        return ({k: st[p]["exp_avg"] for k, p in state["params"].items()},
                {k: st[p]["exp_avg_sq"] for k, p in state["params"].items()})

    def _whole(self, state, prefix):
        """The state's params and moments gathered whole, as arrays."""
        from docqa_tpu_torch.parallel.sharding import unshard

        layout = state["opt_state"].layout
        out = {}
        trees = (state["params"],) + (self._moments(state) if state["opt_state"].count else ())
        for tag, tree in zip(("p", "m1", "m2"), trees):
            for k, v in unshard(tree, layout).items():
                out[f"{prefix}{tag}/{k}"] = v.detach().clone().numpy()
        return out

    def lm_train(self):
        """Each mesh shape: TRAIN_STEPS steps from the seeded tree, every
        step's loss, collectives, clip norm and replicated gradients, and
        the whole params after it; one step at an uneven vocabulary; the
        trees a step refuses."""
        from docqa_tpu_torch.config import DecoderConfig
        from docqa_tpu_torch.parallel import sharding as S
        from docqa_tpu_torch.training import train

        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            cfg, state, step = self._lm_state(m)
            layout = state["opt_state"].layout
            seen = {}
            update = state["opt_state"].update

            def recorded():
                seen["grads"] = {k: p.grad.detach().clone() for k, p in
                                 state["params"].items() if layout.dims[k] is None}
                seen["norm"] = update()
                return seen["norm"]

            state["opt_state"].update = recorded
            out = {}
            for i in range(TRAIN_STEPS):
                (state, loss), c = self.counted(lambda: step(state, *train_batch(i)))
                out[f"loss{i}"] = np.array(float(loss))
                out[f"norm{i}"] = np.array(float(seen["norm"]))
                out.update(self.counts(c, f"s{i}/"))
                out.update({f"g{i}/{k}": v.numpy() for k, v in seen["grads"].items()})
                out.update(self._whole(state, f"s{i}/"))
                out.update({f"local{i}/{k}": v.detach().clone().numpy()
                            for k, v in state["params"].items() if layout.dims[k] is None})
            ucfg, ustate, ustep = self._lm_state(m, vocab=TRAIN_UNEVEN_VOCAB)
            ids, lengths = train_batch(0, TRAIN_UNEVEN_VOCAB)
            ustate, uloss = ustep(ustate, ids, lengths)
            out["uneven/loss"] = np.array(float(uloss))
            out.update(self._whole(ustate, "uneven/"))
            # refusals: a whole tree on this mesh, a shard without one
            errs = []
            whole_cfg, whole, _ = self._lm_state(None)
            for fn in (lambda: step(whole, *train_batch(0)),
                       lambda: train.make_train_step(cfg, state["opt_state"].chain)(
                           state, *train_batch(0)),
                       lambda: step(state, *[a[:3] for a in train_batch(0)])):
                try:
                    fn()
                    errs.append("")
                except ValueError as e:
                    errs.append(str(e))
            out["refused"] = np.array(errs)
            self.save(f"lm_train_{tag}", **out)

    def encoder_train(self):
        """The data-parallel encoder step at each shape: losses, collectives
        and whole params after each step; a checkpoint of the trained state
        (:meth:`_encoder_ckpt`); train_encoder's batch rounding; a batch
        whose rows do not divide the data axis."""
        from docqa_tpu_torch import weights
        from docqa_tpu_torch.config import EncoderConfig
        from docqa_tpu_torch.training import encoder

        cfg = EncoderConfig(**ENC_WIDTHS)
        shapes = [(2, 1)] if self.world == 2 else [(4, 1), (2, 2)]
        for shape in shapes:
            m = self.mesh(shape)
            state, opt = encoder.init_encoder_train_state(
                cfg, params=weights.host_init_encoder_params(cfg, 1), mesh=m)
            step = encoder.make_encoder_train_step(cfg, opt, m)
            out = {}
            for i in range(ENC_TRAIN_STEPS):
                (state, loss), c = self.counted(lambda: step(state, *enc_train_batch(i, cfg)))
                out[f"loss{i}"] = np.array(float(loss))
                out.update(self.counts(c, f"s{i}/"))
                out.update({f"s{i}/p/{k}": v.detach().clone().numpy()
                            for k, v in state["params"].items()})
            out.update(self._encoder_ckpt(state, step, cfg, m))
            try:
                step(state, *enc_train_batch(0, cfg, b=ENC_TRAIN_BATCH - 1))
                out["refused"] = np.array("")
            except ValueError as e:
                out["refused"] = np.array(str(e))
            sizes = []
            real = encoder.encode_pair_batch

            def sized(tok, pairs, seq):
                sizes.append(len(pairs))
                return real(tok, pairs, seq)

            encoder.encode_pair_batch = sized
            try:
                encoder.train_encoder(cfg, steps=1, batch_size=5, seq=ENC_TRAIN_SEQ,
                                      params=weights.host_init_encoder_params(cfg, 1),
                                      device="cpu", mesh=m)
            finally:
                encoder.encode_pair_batch = real
            out["rounded"] = np.array(sizes)
            self.save(f"encoder_train_{shape[0]}x{shape[1]}", **out)

    def _encoder_ckpt(self, state, step, cfg, m):
        """The trained encoder state saved by every rank into one directory,
        restored into another tree on this mesh; one more step from each."""
        from docqa_tpu_torch import weights
        from docqa_tpu_torch.training import encoder
        from docqa_tpu_torch.training.checkpoint import TrainCheckpointer

        ck_dir = os.path.join(self._ckpt_root(), f"enc_{m.n_data}x{m.n_model}")
        (_, c) = self.counted(lambda: TrainCheckpointer(ck_dir, max_to_keep=1).save(state))
        out = {**self.counts(c, "save/"), **self._whole(state, "saved/")}
        tmpl, _ = encoder.init_encoder_train_state(
            cfg, params=weights.host_init_encoder_params(cfg, 2), mesh=m)
        TrainCheckpointer(ck_dir).restore(tmpl)
        out["restored/step"] = np.array([tmpl["step"], tmpl["opt_state"].count])
        out.update(self._whole(tmpl, "restored/"))
        batch = enc_train_batch(ENC_TRAIN_STEPS, cfg)
        out["next"] = np.array(float(step(state, *batch)[1]))
        out["restored/next"] = np.array(float(step(tmpl, *batch)[1]))
        return out

    def _ckpt_root(self):
        with open(os.path.join(self.out, "ckpt_root.txt")) as f:
            return f.read().strip()

    def _steps_from(self, state, step, first, n):
        losses = []
        for i in range(first, first + n):
            state, loss = step(state, *train_batch(i))
            losses.append(float(loss))
        return np.array(losses)

    def ckpt_save(self):
        """(1, 2): two steps, a save, two more (the uninterrupted run); the
        one-device save restored here; then (2, 2)'s save restored here."""
        from docqa_tpu_torch.training.checkpoint import TrainCheckpointer

        root = self._ckpt_root()
        m = self.mesh((1, 2))
        _cfg, state, step = self._lm_state(m, seed=CKPT_SEED)
        self._steps_from(state, step, 0, 2)
        ck = TrainCheckpointer(os.path.join(root, "ck_1x2"), max_to_keep=1)
        out = {"saved_step": np.array(ck.save(state))}
        out.update(self._whole(state, "saved/"))
        out["straight"] = self._steps_from(state, step, 2, 2)
        for name in ("ck_whole", "ck_2x2"):
            if name == "ck_2x2":
                wait_for_step(os.path.join(root, name), 2)
            _cfg, tmpl, step2 = self._lm_state(m, seed=CKPT_TEMPLATE_SEED)
            TrainCheckpointer(os.path.join(root, name)).restore(tmpl)
            out[f"{name}/step"] = np.array([tmpl["step"], tmpl["opt_state"].count])
            out.update(self._whole(tmpl, f"{name}/"))
            out[f"{name}/resumed"] = self._steps_from(tmpl, step2, 2, 2)
        self.save("ckpt_save", **out)

    def ckpt_restore(self):
        """(1, 4) and (2, 2): (1, 2)'s save restored into another tree, then
        two steps; (2, 2) saves what it restored before stepping."""
        from docqa_tpu_torch.training.checkpoint import TrainCheckpointer

        root = self._ckpt_root()
        wait_for_step(os.path.join(root, "ck_1x2"), 2)
        out = {}
        for shape in mesh_shapes(self.world):
            m = self.mesh(shape)
            tag = f"{shape[0]}x{shape[1]}"
            _cfg, tmpl, step = self._lm_state(m, seed=CKPT_TEMPLATE_SEED)
            TrainCheckpointer(os.path.join(root, "ck_1x2")).restore(tmpl)
            out[f"{tag}/step"] = np.array([tmpl["step"], tmpl["opt_state"].count])
            out.update(self._whole(tmpl, f"{tag}/"))
            if shape == (2, 2):
                (_, c) = self.counted(lambda: TrainCheckpointer(
                    os.path.join(root, "ck_2x2"), max_to_keep=1).save(tmpl))
                out.update(self.counts(c, "save/"))
            out[f"{tag}/resumed"] = self._steps_from(tmpl, step, 2, 2)
        self.save("ckpt_restore", **out)

    def train_lost_rank(self):
        """(1, 2): a step, then rank 1 kills itself; rank 0's next step must
        raise MeshFault within the process group's timeout."""
        import signal

        from docqa_tpu_torch.ops._kernels import MeshFault

        m = self.mesh((1, 2))
        _cfg, state, step = self._lm_state(m)
        state, _loss = step(state, *train_batch(0))
        if self.rank == 1:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(0.5)
        t0 = time.perf_counter()
        try:
            step(state, *train_batch(1))
            kind, msg = "", "the step returned with a rank gone"
        except MeshFault as e:
            kind, msg = "MeshFault", str(e)
        except Exception as e:  # noqa: BLE001 - another failure is the result
            kind, msg = type(e).__name__, str(e)
        self.save("train_lost_rank", kind=np.array(kind), message=np.array(msg),
                  seconds=np.array(time.perf_counter() - t0))
        os._exit(0)  # the process group cannot be torn down with a rank gone

    def rank_fails(self):
        """Rank 1 raises before the collective; rank 0's all_reduce must
        raise (peer gone or timed out), never hang."""
        import time

        t0 = time.perf_counter()
        if self.rank == 1:
            raise RuntimeError("rank 1 fails before the collective")
        try:
            self.M.all_reduce(self.torch.ones(4), None if self.world == 1 else
                              self.torch.distributed.group.WORLD, "test")
        except Exception as e:  # noqa: BLE001 - the failure is the result
            self.save("rank_fails", message=np.array(f"{type(e).__name__}: {e}"),
                      seconds=np.array(time.perf_counter() - t0))
            return
        raise AssertionError("the collective returned with a rank gone")


# ---- the test side: a world of these workers ------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240  # a whole world's run, joined with a kill on expiry
COLLECTIVE_TIMEOUT_S = 30  # the process group's: a lost peer raises by then


def shape_of(tag):
    d, m = tag.split("x")
    return int(d), int(m)


def world_of(tag):
    d, m = shape_of(tag)
    return d * m


class World:
    """A gloo world of ``n`` worker processes running ``scenarios``."""

    def __init__(self, n, scenarios, out, timeout_s=COLLECTIVE_TIMEOUT_S):
        self.n, self.out = n, str(out)
        env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
                   PYTHONPATH=REPO)
        env.pop("MASTER_ADDR", None)
        init = os.path.join(self.out, "init")
        self.logs = [open(os.path.join(self.out, f"rank{r}.log"), "w+") for r in range(n)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "torch_mesh_worker.py"),
                 REPO, init, str(n), str(r), self.out, scenarios, str(timeout_s)],
                env=env, stdout=self.logs[r], stderr=subprocess.STDOUT,
            )
            for r in range(n)
        ]
        self.t0 = time.monotonic()
        self.rcs = None

    def join(self):
        if self.rcs is None:
            deadline = self.t0 + WORLD_TIMEOUT_S
            rcs = []
            for p in self.procs:
                try:
                    rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
                except subprocess.TimeoutExpired:
                    rcs.append(None)
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            self.rcs = rcs
            self.seconds = time.monotonic() - self.t0
        return self.rcs

    def stderr(self):
        out = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            out.append(f"--- rank {r} ---\n{f.read()[-4000:]}")
        return "\n".join(out)

    def ok(self):
        rcs = self.join()
        if rcs != [0] * self.n:
            _fail(f"world of {self.n} exited {rcs} after {self.seconds:.1f} s:\n"
                        f"{self.stderr()}")
        return self

    def result(self, name, rank):
        self.ok()
        with np.load(os.path.join(self.out, f"{name}.r{rank}.npz")) as d:
            return {k: d[k] for k in d.files}

    def close(self):
        self.join()
        for f in self.logs:
            f.close()



def _fail(msg):
    import pytest

    pytest.fail(msg)


def counts_of(res, prefix=""):
    return dict(zip(res[prefix + "ckeys"].tolist(), res[prefix + "cvals"].tolist()))


def main():
    repo, init_file, world, rank, out, scenarios = sys.argv[1:7]
    timeout_s = float(sys.argv[7]) if len(sys.argv) > 7 else 60.0
    sys.path.insert(0, repo)
    world, rank = int(world), int(rank)
    from docqa_tpu_torch.runtime.mesh import multihost_init

    assert multihost_init(f"file://{init_file}", world, rank, device="cpu",
                          timeout=timedelta(seconds=timeout_s))
    w = Worker(world, rank, out)
    for name in scenarios.split(","):
        getattr(w, name)()
    import torch.distributed as dist

    if "rank_fails" not in scenarios and "lost_rank" not in scenarios:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
