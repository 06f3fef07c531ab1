"""A tiny cell for the CPU tests: the cells' files at toy widths in a
directory of their own, laid out as the repository lays out the real
ones, so the registry, the harness and the check run on them unchanged."""

from __future__ import annotations

import copy
import json
import os

from portbench.registry import ROOT, load_json

def tiny_config(weights: str = "bf16") -> dict:
    cfg = load_json(os.path.join(ROOT, "portbench", "configs", "mistral7b-bf16.json"))
    cfg = copy.deepcopy(cfg)
    cfg.update({"name": f"tiny-{weights}", "hidden_size": 64, "intermediate_size": 160,
                "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                "vocab_size": 4096, "max_position_embeddings": 1024, "sliding_window": 1024,
                "torch_dtype": "float32"})
    cfg["served"] = {"weights": weights, "weight_bits": 8 if weights == "int8" else 16}
    cfg["encoder"].update({"vocab_size": 1000, "hidden_size": 32, "num_hidden_layers": 2,
                           "num_attention_heads": 2, "intermediate_size": 64,
                           "max_position_embeddings": 128, "dtype": "float32"})
    cfg["store"].update({"rows": 3000, "dim": 32, "default_k": 3,
                         "dtype": "float32"})
    cfg["pool"].update({"n_slots": 4, "decode_chunk": 4})
    return cfg


def tiny_mix() -> dict:
    return {"clients": 3, "stagger_s": 0.0, "ramp_s": 0.5, "chunk_tokens": 20,
            "question_tokens": 10, "text_pool": 64, "max_new_tokens": 12,
            "request_deadline_s": 60.0, "trace_seconds": 1.0, "why": "toy"}


def write_root(path: str, weights: str = "bf16", limits: dict = None) -> str:
    """A benchmark root at ``path`` holding one tiny cell; the metric
    readers are the repository's own."""
    pb = os.path.join(path, "portbench")
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(pb, sub), exist_ok=True)
    if not os.path.exists(os.path.join(pb, "metrics")):
        os.symlink(os.path.join(ROOT, "portbench", "metrics"), os.path.join(pb, "metrics"))
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = tiny_config(weights)
    bench["configs"] = [{"name": cfg["name"], "source": cfg["source"],
                         "file": f"portbench/configs/{cfg['name']}.json", "reduced": [],
                         "why": "toy"}]
    cell = f"{cfg['name']}.tiny"
    bench["workloads"] = [{"name": cell, "config": cfg["name"], "traffic": "tiny",
                           "chips": 1, "why": "toy"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cell]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(pb, "configs", f"{cfg['name']}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as f:
        json.dump(tiny_mix(), f)
    with open(os.path.join(pb, "checks", f"{cell}.json"), "w") as f:
        json.dump({"sample": 8, "limits": limits or {
            "retrieval_gap": 1e-4, "prompt_mismatch": 0, "logit_gap": 1e-3, "jax_modules": 0}}, f)
    return cell
