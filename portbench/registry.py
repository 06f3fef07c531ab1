"""Find a cell's parts by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives; the mix is
``traffic/<traffic>.json``; the limits of the cell's output check are
``checks/<cell>.json``; each metric the cell reports, end to end or per
layer, is read by ``metrics/<metric>.py``.  Nothing here knows a cell, so a new cell, mix or
metric is added by adding its files and its entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    checks: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one without it is every cell's that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_reader(name: str, root: str = ROOT) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py`` (a metric's
    name may hold dots, so the file is loaded by path)."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find_cell(name: str, root: str = ROOT, bench: Optional[Dict[str, Any]] = None) -> Cell:
    bench = bench if bench is not None else load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json"))
    checks = load_json(os.path.join(root, "portbench", "checks", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    readers = {m["name"]: load_reader(m["name"], root) for m in e2e + per_layer}
    return Cell(name, int(w["chips"]), config, traffic, checks, e2e, per_layer, readers)
