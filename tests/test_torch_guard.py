"""Guards for the port: it never imports jax or docqa_tpu, and its entry
points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

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
FORBIDDEN = ("jax", "jaxlib", "docqa_tpu")

torch.set_num_threads(1)

_BLOCKED_IMPORT = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
sys.path.insert(0, {REPO!r})
import docqa_tpu_torch
for mod in pkgutil.walk_packages(docqa_tpu_torch.__path__, "docqa_tpu_torch."):
    importlib.import_module(mod.name)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
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
    for mod in BATCHER_MODULES + INGEST_MODULES + OBS_MODULES:
        assert f"'{mod}'" in port_line, mod


def test_ast_scan_covers_the_batcher_modules():
    scanned = {os.path.relpath(p, REPO) for p in _python_files()}
    for mod in BATCHER_MODULES + INGEST_MODULES + OBS_MODULES:
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
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert len(_python_files()) > 10
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
    gen = GenerateEngine(dec_cfg, GenerateConfig(), device="cpu")
    if entry == "EnginePool":
        from docqa_tpu_torch.engines.pool import EnginePool

        return EnginePool(gen)
    return QAService(enc, store, gen)


@pytest.mark.parametrize(
    "entry",
    ["EncoderEngine", "GenerateEngine", "VectorStore", "FusedRetriever", "QAService",
     "EnginePool", "DeidEngine"],
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
