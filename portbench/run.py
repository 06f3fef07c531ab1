"""Run one cell of ``BENCHMARK.json`` once on the card this process starts on.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (inputs and weights from the seed, the port's ``/ask`` path, the
warm-up of the cell's shapes) is timed as ``setup_s``; then the window runs
the cell's traffic for ``--seconds``; then the program is stopped, its
device memory freed, and the answers are held to the plain reference
(``check.py``).  With ``--trace 1`` the last ``trace_seconds`` of the window
run under the profiler and the line carries the per-layer metrics, the
device's busy and window seconds and a breakdown; with ``--trace 0`` it
carries the end-to-end metrics.  The last line of standard output is the
result; each number compared is printed beside its limit on standard error
and under ``checks``, the line's last key.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), when the port cannot be imported, and when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

from time import perf_counter

T_START = perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# kernel and compiler caches at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(ROOT, "build", _sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

BLOCKED = ("jax", "jaxlib", "flax", "optax", "docqa_tpu")


def blocked_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names (``docqa_tpu_torch`` is not ``docqa_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BLOCKED))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _spine_stages() -> Dict[str, Dict[str, float]]:
    from docqa_tpu_torch.engines.spine import get_spine

    return {k: {"count": v["count"], "device_s": v["device_s"]}
            for k, v in get_spine().stats()["stages"].items()}


def _delta(after, before):
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v} for k, v in after.items()}


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda", control=None,
             out_dir: Optional[str] = None, t_start: float = T_START) -> Dict[str, Any]:
    """One run of ``cell`` (a ``registry.Cell``).  Returns the result line
    as a dict (``checks`` last).  ``control`` (``check.control_bits``): also
    judge the control in the program's place, under ``_control`` (the
    readings that set the limits; the benchmark's runs never do)."""
    import torch

    from portbench import check, system, traffic
    from portbench import trace as tracing
    from portbench.drive import Driver
    from portbench.record import Run

    config, mix = cell.config, cell.traffic
    if not system.prompt_lengths_ok(config, mix):
        raise ValueError("the mix's prompt and answer do not fit a slot")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    asks = traffic.schedule(mix, seed, seconds)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sut = system.build(config, mix, seed, dev, log=log)
    system.warm(sut, config, mix, log=log)
    out_dir = out_dir or os.path.join(ROOT, "build", "portbench")
    window = tracing.Window(os.path.join(out_dir, f"trace-{cell.name}"), dev) if trace else None
    if window is not None:  # the profiler's first start pays its own set-up
        window.start()
        window.stop()

    driver = Driver(sut.qa, float(mix["request_deadline_s"]))
    snaps: Dict[str, Any] = {}
    # set-up ends where the traffic starts: the ramp fills the loop before
    # the window opens and belongs to neither
    t_traffic = perf_counter() + 0.05
    t_open = t_traffic + float(mix.get("ramp_s", 0))
    t_close = t_open + seconds
    trace_s = min(float(mix.get("trace_seconds", 3.0)), seconds)

    def clock():
        def until(t):
            while perf_counter() < t and not driver.stop.is_set():
                threading.Event().wait(min(0.01, max(t - perf_counter(), 0)))
        until(t_open)
        snaps["open"] = (_spine_stages(), dict(sut.pool.stats()))
        if window is not None:
            until(t_close - trace_s)
            window.start()
        until(t_close)
        snaps["close"] = (_spine_stages(), dict(sut.pool.stats()))
        if window is not None:
            snaps["trace_path"] = window.stop()

    timer = threading.Thread(target=clock, name="portbench-clock", daemon=True)
    timer.start()
    try:
        records = driver.run_closed(asks, int(mix["clients"]), t_close,
                                    float(mix.get("stagger_s", 0.0)))
        timer.join()
    finally:
        driver.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    (sp0, st0), (sp1, st1) = snaps["open"], snaps["close"]
    run = Run(config, mix, sut.shape, records, t_open, t_close, t_traffic - t_start,
              spine=_delta(sp1, sp0),
              stats={k: st1.get(k, 0) - st0.get(k, 0) for k in st1})
    sut.stop()
    del sut
    gc.collect()

    if window is not None:
        run.trace = tracing.read(snaps["trace_path"])

    judged = run.judged()
    failed = sum(1 for r in judged if not r.answered)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cell.readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    sample = check.sample(records, int(cell.checks["sample"]), seed)
    numbers, ctl_numbers = check.judge(sample, config, mix, seed, dev, control=control)
    numbers["jax_modules"] = float(len(blocked_modules()))
    verdict = check.verdict(numbers, cell.checks["limits"])
    correct = bool(sample) and all(v["ok"] for v in verdict) and bool(judged)

    result: Dict[str, Any] = {
        "correct": correct, "attempted": len(judged), "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = tracing.breakdown(run.trace)
    result["checks"] = _checks(verdict)
    if ctl_numbers is not None:
        ctl_numbers["jax_modules"] = numbers["jax_modules"]
        ctl_verdict = check.verdict(ctl_numbers, cell.checks["limits"])
        result["_control"] = {"bits": control, "correct": bool(sample) and all(
            v["ok"] for v in ctl_verdict), "checks": _checks(ctl_verdict)}
    _write_run_file(out_dir, cell.name, seed, trace, run, result)
    return result


def _checks(verdict) -> Dict[str, Any]:
    return {v["name"]: {"value": v["value"], "limit": v["limit"]} for v in verdict}


def _write_run_file(out_dir, name, seed, trace, run, result) -> None:
    os.makedirs(os.path.join(out_dir, "runs"), exist_ok=True)
    asks = [{"i": r.ask.index, "due": r.t_due - run.t_open,
             "sent": r.t_sent - run.t_open, "first": r.t_first - run.t_open,
             "end": r.t_end - run.t_open, "outcome": r.outcome,
             "prompt": len(r.prompt_ids), "tokens": len(r.tokens),
             "deltas": len(r.piece_times)} for r in run.records]
    body = {"result": result, "pool_stats": run.stats, "spine": run.spine, "asks": asks}
    path = os.path.join(out_dir, "runs", f"{name}-{seed}-t{int(trace)}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(body, f, default=lambda o: None if o != o else str(o))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.registry import find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("portbench: no CUDA card visible; nothing was measured")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible; nothing was measured")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = blocked_modules()
    if found:
        log(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}; no result")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
