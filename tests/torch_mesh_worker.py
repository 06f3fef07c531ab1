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
            DocQARuntime(load_config(env={}, overrides={"ner.train_steps": 0}), device="cpu")
        except NotImplementedError as e:
            self.save("runtime_refused", message=np.array(str(e)))
            return
        raise AssertionError("DocQARuntime booted in a world of more than one rank")

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
