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
# the runs of a world of 2, of a world of 4, and their overrides
RT_RUNS = {
    "greedy": {"pool.replicas": 2},
    "sampled": {"generate.temperature": 0.8, "generate.speculative_k": 0},
    "wide": {"mesh.data_parallel": 2},
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


class Worker:
    def __init__(self, world, rank, out):
        import torch

        from docqa_tpu_torch.runtime import mesh as M

        torch.set_num_threads(1)
        self.torch, self.M = torch, M
        self.world, self.rank, self.out = world, rank, out
        self._meshes = {}

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
        from docqa_tpu_torch.config import load_config
        from docqa_tpu_torch.service.app import DocQARuntime

        try:
            DocQARuntime(load_config(env={}, overrides={
                "ner.train_steps": 0, "store.serving_index": "tiered"}), device="cpu")
        except NotImplementedError as e:
            self.save("runtime_refused", message=np.array(str(e)))
            return
        raise AssertionError("tiered serving booted in a world of more than one rank")

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

    def _runtime(self, run, work_dir, script):
        """Boot DocQARuntime under RT_CFG + RT_RUNS[run]; the leader serves
        on 127.0.0.1 port 0 and runs ``script(base)``, every other rank
        follows.  Saves ``runtime_<run>`` with the rank's command digest,
        its batches and its store."""
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
                  snapshots=np.array(len(snapshots)))

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

    if "rank_fails" not in scenarios:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
