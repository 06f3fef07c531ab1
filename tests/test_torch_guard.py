"""Guards for the port: it never imports jax or docqa_tpu, and its entry
points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from docqa_tpu_torch.config import (
    DecoderConfig,
    EncoderConfig,
    GenerateConfig,
    StoreConfig,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "docqa_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "docqa_tpu", "ml_dtypes", "optax", "orbax")
# the card's Python has none of these: the app's server and schemas are
# stdlib, and the checkpoint import reads safetensors and tokenizer files
# with the port's own code
NOT_ON_THE_CARD = ("aiohttp", "pydantic", "safetensors", "tokenizers", "transformers",
                   "sentencepiece")
# imported inside the function that needs it, never at module level: the
# AMQP broker's pika (on neither machine; AmqpBroker raises without it)
CALL_TIME_ONLY = ("pika",)

torch.set_num_threads(1)

_BLOCKED_IMPORT = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN + NOT_ON_THE_CARD + CALL_TIME_ONLY!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
sys.path.insert(0, {REPO!r})
import docqa_tpu_torch
for mod in pkgutil.walk_packages(docqa_tpu_torch.__path__, "docqa_tpu_torch."):
    importlib.import_module(mod.name)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "aiohttp", "pydantic", "ml_dtypes",
                                       "optax", "orbax", "safetensors", "tokenizers",
                                       "transformers", "sentencepiece", "pika")
                and sys.modules[m] is not None)
print("LOADED", loaded)
print("PORT", sorted(m for m in sys.modules if m.startswith("docqa_tpu_torch.")))
"""

# the batcher and serving-plane slices' modules: each must be imported by
# the blocked-import subprocess and read by the AST scan
BATCHER_MODULES = (
    "docqa_tpu_torch.engines.paged",
    "docqa_tpu_torch.engines.pool",
    "docqa_tpu_torch.engines.qos",
    "docqa_tpu_torch.engines.router",
    "docqa_tpu_torch.engines.serve",
    "docqa_tpu_torch.engines.spine",
    "docqa_tpu_torch.resilience.breaker",
    "docqa_tpu_torch.resilience.deadline",
    "docqa_tpu_torch.resilience.faults",
    "docqa_tpu_torch.runtime.metrics",
    "docqa_tpu_torch.service.qa",
)
# the ingest slice's modules, held to the same two checks
INGEST_MODULES = (
    "docqa_tpu_torch.deid.datagen",
    "docqa_tpu_torch.deid.engine",
    "docqa_tpu_torch.models.ner",
    "docqa_tpu_torch.resilience.policy",
    "docqa_tpu_torch.service.bootstrap",
    "docqa_tpu_torch.service.broker",
    "docqa_tpu_torch.service.extract",
    "docqa_tpu_torch.service.pipeline",
    "docqa_tpu_torch.service.registry",
    "docqa_tpu_torch.text.chunker",
    "docqa_tpu_torch.training.ner",
)
# the observability slice's modules, held to the same two checks
OBS_MODULES = (
    "docqa_tpu_torch.obs",
    "docqa_tpu_torch.obs.context",
    "docqa_tpu_torch.obs.costs",
    "docqa_tpu_torch.obs.export",
    "docqa_tpu_torch.obs.expo",
    "docqa_tpu_torch.obs.observatory",
    "docqa_tpu_torch.obs.profiler",
    "docqa_tpu_torch.obs.recorder",
    "docqa_tpu_torch.obs.slo",
    "docqa_tpu_torch.obs.spans",
    "docqa_tpu_torch.obs.telemetry",
)
# the app slice's modules, held to the same two checks
APP_MODULES = (
    "docqa_tpu_torch.config",
    "docqa_tpu_torch.engines.retrieve",
    "docqa_tpu_torch.engines.summarize",
    "docqa_tpu_torch.index.lexical",
    "docqa_tpu_torch.index.store",
    "docqa_tpu_torch.service.app",
    "docqa_tpu_torch.service.schemas",
    "docqa_tpu_torch.service.synthesis",
    "docqa_tpu_torch.service.wire",
)

# the store-lifecycle and fused /ask slice's new and touched modules, held
# to the same two checks
LIFECYCLE_MODULES = (
    "docqa_tpu_torch.engines.encoder",
    "docqa_tpu_torch.engines.generate",
    "docqa_tpu_torch.engines.rag_fused",
    "docqa_tpu_torch.runtime.native",
    "docqa_tpu_torch.service.pipeline",
    "docqa_tpu_torch.service.bootstrap",
)
# the training slice's new and touched modules, held to the same two checks
TRAINING_MODULES = (
    "docqa_tpu_torch.deid.evalset",
    "docqa_tpu_torch.models.decoder",
    "docqa_tpu_torch.models.encoder",
    "docqa_tpu_torch.ops.attention",
    "docqa_tpu_torch.training",
    "docqa_tpu_torch.training.checkpoint",
    "docqa_tpu_torch.training.encoder",
    "docqa_tpu_torch.training.optim",
    "docqa_tpu_torch.training.train",
)
# the tiered retrieval slice's new and touched modules, held to the same
# two checks
RETRIEVAL_MODULES = (
    "docqa_tpu_torch.engines.retrieve",
    "docqa_tpu_torch.index.ivf",
    "docqa_tpu_torch.index.lexical",
    "docqa_tpu_torch.index.store",
    "docqa_tpu_torch.index.tiered",
    "docqa_tpu_torch.obs.retrieval_observatory",
    "docqa_tpu_torch.obs.telemetry",
    "docqa_tpu_torch.service.app",
)
# the checkpoint and seq2seq slice's new and touched modules, held to the
# same two checks
CHECKPOINT_MODULES = (
    "docqa_tpu_torch.engines.encoder",
    "docqa_tpu_torch.engines.generate",
    "docqa_tpu_torch.engines.seq2seq",
    "docqa_tpu_torch.engines.summarize",
    "docqa_tpu_torch.models",
    "docqa_tpu_torch.models.hf_checkpoint",
    "docqa_tpu_torch.models.safetensors_io",
    "docqa_tpu_torch.models.seq2seq",
    "docqa_tpu_torch.service.app",
    "docqa_tpu_torch.text",
    "docqa_tpu_torch.text.bpe",
    "docqa_tpu_torch.text.tokenizer",
    "docqa_tpu_torch.weights",
)
# the quantised decoder and AMQP slice's new and touched modules, held to
# the same two checks (ml_dtypes and pika above: neither is imported at
# module level, pika only inside AmqpBroker)
QUANT_MODULES = (
    "docqa_tpu_torch.config",
    "docqa_tpu_torch.engines.generate",
    "docqa_tpu_torch.models.decoder",
    "docqa_tpu_torch.models.hf_checkpoint",
    "docqa_tpu_torch.models.quant",
    "docqa_tpu_torch.obs.observatory",
    "docqa_tpu_torch.ops.qmatmul",
    "docqa_tpu_torch.service.app",
    "docqa_tpu_torch.service.broker",
    "docqa_tpu_torch.weights",
)
SLICE_MODULES = (BATCHER_MODULES + INGEST_MODULES + OBS_MODULES + APP_MODULES
                 + LIFECYCLE_MODULES + TRAINING_MODULES + RETRIEVAL_MODULES
                 + CHECKPOINT_MODULES + QUANT_MODULES)


def _python_files():
    files = [
        os.path.join(REPO, "chip_smoke.py"),
        os.path.join(REPO, "scripts", "torch_ask_profile.py"),
    ]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    port_line = next(line for line in out.stdout.splitlines() if line.startswith("PORT"))
    for mod in SLICE_MODULES:
        assert f"'{mod}'" in port_line, mod


def test_ast_scan_covers_the_batcher_modules():
    scanned = {os.path.relpath(p, REPO) for p in _python_files()}
    for mod in SLICE_MODULES:
        path = mod.replace(".", os.sep)
        assert path + ".py" in scanned or os.path.join(path, "__init__.py") in scanned, mod


def test_no_module_reaches_jax_profiler_or_the_reference_obs():
    """Neither an import statement nor a dynamic import (``importlib``,
    ``__import__``) names ``jax.profiler`` or ``docqa_tpu.obs``: the
    profiler window is ``torch.profiler``'s, the obs package the port's own
    copy."""
    offenders = []
    for path in _python_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant
            ) and isinstance(node.args[0].value, str):
                func = node.func
                callee = func.attr if isinstance(func, ast.Attribute) else getattr(
                    func, "id", "")
                if callee in ("import_module", "__import__"):
                    names = [node.args[0].value]
            for name in names:
                if name.startswith(("jax.profiler", "docqa_tpu.obs")):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert offenders == []


def test_ast_scan_finds_no_forbidden_import():
    offenders = []
    for path in _python_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN + NOT_ON_THE_CARD:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert len(_python_files()) > 10
    assert offenders == []


def _module_level_imports(tree):
    """Import statements that run when the module is imported: everywhere
    but inside function bodies."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def test_ast_scan_finds_no_module_level_pika():
    offenders = []
    for path in _python_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in _module_level_imports(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            for name in names:
                if name.split(".")[0] in CALL_TIME_ONLY:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert offenders == []


def _build(entry):
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.retrieve import FusedRetriever
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.service.qa import QAService

    enc_cfg = EncoderConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                            num_heads=1, mlp_dim=32, max_seq_len=16,
                            embed_dim=32, dtype="float32")
    dec_cfg = DecoderConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                            num_heads=1, num_kv_heads=1, head_dim=32,
                            mlp_dim=32, dtype="float32")
    store_cfg = StoreConfig(dim=32, shard_capacity=128)
    if entry == "EncoderEngine":
        return EncoderEngine(enc_cfg)
    if entry == "GenerateEngine":
        return GenerateEngine(dec_cfg, GenerateConfig())
    if entry == "quantised GenerateEngine":
        import dataclasses

        return GenerateEngine(dataclasses.replace(dec_cfg, quantize_weights=True,
                                                  quant_bits=4), GenerateConfig())
    if entry == "VectorStore":
        return VectorStore(store_cfg)
    if entry == "DeidEngine":
        from docqa_tpu_torch.config import NERConfig
        from docqa_tpu_torch.deid.engine import DeidEngine

        return DeidEngine(NERConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                                    num_heads=1, mlp_dim=32, max_seq_len=16,
                                    dtype="float32"))
    enc = EncoderEngine(enc_cfg, device="cpu")
    store = VectorStore(store_cfg, device="cpu")
    if entry == "FusedRetriever":
        return FusedRetriever(enc, store)
    if entry == "IVFIndex":
        from docqa_tpu_torch.index.ivf import IVFIndex

        return IVFIndex(np.eye(32, dtype=np.float32), [{}] * 32, n_clusters=2)
    if entry == "FusedTieredRetriever":
        from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
        from docqa_tpu_torch.index.tiered import TieredIndex

        return FusedTieredRetriever(enc, TieredIndex(store))
    if entry == "FusedRAG":
        from docqa_tpu_torch.engines.rag_fused import FusedRAG

        gen = GenerateEngine(dec_cfg, GenerateConfig(), device="cpu")
        store = VectorStore(StoreConfig(dim=32, token_width=8), device="cpu")
        return FusedRAG(enc, store, gen, "{context} {question}")
    if entry == "LexicalIndex":
        from docqa_tpu_torch.index.lexical import LexicalIndex

        return LexicalIndex()
    if entry == "HashEncoder":
        from docqa_tpu_torch.engines.encoder import HashEncoder

        return HashEncoder(enc_cfg)
    if entry == "Seq2SeqEngine":
        from docqa_tpu_torch.config import Seq2SeqConfig
        from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine

        return Seq2SeqEngine(Seq2SeqConfig(vocab_size=64, d_model=32, enc_layers=1,
                                           dec_layers=1, num_heads=1, mlp_dim=32,
                                           dtype="float32"))
    if entry == "generate_engine_from_dir":
        from docqa_tpu_torch.models.hf_checkpoint import generate_engine_from_dir

        return generate_engine_from_dir("/nonexistent")
    if entry == "DocQARuntime":
        from docqa_tpu_torch.config import load_config
        from docqa_tpu_torch.service.app import DocQARuntime

        return DocQARuntime(load_config(env={}, overrides={"ner.train_steps": 0}))
    gen = GenerateEngine(dec_cfg, GenerateConfig(), device="cpu")
    if entry == "EnginePool":
        from docqa_tpu_torch.engines.pool import EnginePool

        return EnginePool(gen)
    return QAService(enc, store, gen)


@pytest.mark.parametrize(
    "entry",
    ["EncoderEngine", "GenerateEngine", "VectorStore", "FusedRetriever", "QAService",
     "EnginePool", "DeidEngine", "LexicalIndex", "HashEncoder", "DocQARuntime",
     "FusedRAG", "IVFIndex", "FusedTieredRetriever", "Seq2SeqEngine",
     "generate_engine_from_dir", "quantised GenerateEngine"],
)
def test_entry_points_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-CUDA guard cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build(entry)


def test_flash_wrapper_rejects_other_devices():
    from docqa_tpu_torch.ops.attention import flash_attention

    q = torch.zeros((1, 2, 1, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


def test_batcher_runs_on_its_engine_device_only():
    """The batcher takes its device from the engine (which raised without
    a card unless given the CPU), and the service refuses a batcher on
    another device."""
    from docqa_tpu_torch.engines.encoder import EncoderEngine
    from docqa_tpu_torch.engines.generate import GenerateEngine
    from docqa_tpu_torch.engines.serve import ContinuousBatcher
    from docqa_tpu_torch.index.store import VectorStore
    from docqa_tpu_torch.service.qa import QAService

    dec_cfg = DecoderConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                            num_heads=1, num_kv_heads=1, head_dim=32,
                            mlp_dim=32, max_seq_len=128, dtype="float32")
    enc_cfg = EncoderConfig(vocab_size=64, hidden_dim=32, num_layers=1,
                            num_heads=1, mlp_dim=32, max_seq_len=16,
                            embed_dim=32, dtype="float32")
    gen = GenerateEngine(dec_cfg, GenerateConfig(), device="cpu")
    b = ContinuousBatcher(gen, n_slots=1, chunk=2)
    try:
        assert b.device == torch.device("cpu")
        b.device = torch.device("meta")  # as if on another device
        with pytest.raises(ValueError, match="batcher on meta"):
            QAService(EncoderEngine(enc_cfg, device="cpu"),
                      VectorStore(StoreConfig(dim=32), device="cpu"), gen,
                      device="cpu", batcher=b)
    finally:
        b.stop()
