"""The compile audit: the kernels' resources, each main-path entry
point's peak device memory and the steady state, held to a checked-in
budget.

Counterpart of ``docqa_tpu/analysis/compile_audit.py``.  The reference
counts each jit root's compilations and reads its XLA memory analysis.
The port jits nothing (``analysis/core.py``'s ``subjectless``), so its
compilation-class contracts are three others, ledgered in
``docqa_tpu_torch/analysis/compile_budget.json``:

* **kernel resources** — registers, spill stores and loads, stack frame
  and static shared memory of every K1 (``csrc/flash_attention.cu``) and
  K4 (``csrc/qmatmul.cu``) kernel symbol, parsed
  (:func:`parse_ptxas`) from the ``-Xptxas -v`` log that
  ``ops/_kernels.py`` keeps beside each library.  A spill the budget does
  not grant, or a register count over its ceiling, fails;
* **peak device memory** of each main-path entry point
  (:data:`ENTRY_POINTS`): ``torch.cuda.max_memory_allocated`` above what
  was allocated before, around runs ``chip_smoke.py``'s phases already
  make.  Each has a ceiling, preserved by regeneration while the
  measurement fits and grown only through a TODO note the gate rejects
  (the reference's ``peak_bytes_ceiling`` / ``ceiling_note``);
* **the steady state**, the counterpart of "zero retraces": after a
  warm-up round, a repeated round builds no new ``plan_qmatmul`` entry,
  no new leaf plan, encodes no weight tensor map and grows no scratch
  buffer (:func:`steady_state`; each root that repeated a round carries
  ``steady_state_retraces``, the sum of those deltas, which must be 0).

:func:`semantic_violations`, :func:`compare_budget`, :func:`load_budget`
and :func:`write_budget` are the reference's mechanics with the
reference's names (a budget regenerated from a broken run still fails, a
missing measurement fails, a TODO waiver or note is rejected), and they
give the reference's verdicts on its own reports
(``tests/test_torch_numcheck.py``).  The card readings run in
``chip_smoke.py`` phase 21 (b); on the CPU the mechanics and the parser
are tested on fixtures.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

WORKLOADS = ("main_path",)
# the main path's entry points, each read in its own smoke phase
ENTRY_POINTS = (
    "solo_ask",        # phase 3: QAService.ask, solo engine, Mistral-7B bf16
    "batcher_round",   # phase 5: a round of eight concurrent /ask
    "pool_round_a1",   # phase 6: round A1 through a one-replica pool
    "ingest_batch",    # phase 7: a DocumentPipeline upload batch
    "summary",         # phase 13 (a): BART-large-cnn beam summaries
    "int8_ask",        # phase 14 (b): the int8 solo ask (K4)
    "llama_ask",       # phase 20: Llama-3-8B bf16 solo ask
)
CEILING_HEADROOM = 1.25
KERNEL_SOURCES = ("flash_attention", "qmatmul")


def default_budget_path() -> str:
    """``docqa_tpu_torch/analysis/compile_budget.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "compile_budget.json")


# ---------------------------------------------------------------------------
# kernel resources
# ---------------------------------------------------------------------------

_KERNEL_RE = re.compile(
    r"(flash_[a-z]+(?:_[a-z]+)*_kernel|qmatmul_[a-z]+_kernel)I(\S+)")


def kernel_symbol(mangled: str) -> str:
    """A readable name for a mangled kernel: its template with the dtype
    and integer arguments (``flash_decode_kernel<128,4>``,
    ``flash_fwd_kernel<bf16,64,16>``), else the mangled name."""
    name = _KERNEL_RE.search(mangled)
    if not name:
        return mangled
    rest = name.group(2)
    dtype = ("bf16," if rest.startswith("13__nv_bfloat16")
             else "f32," if rest.startswith("f") else "")
    nums = ",".join(re.findall(r"L[ib](\d+)E", rest))
    return f"{name.group(1)}<{dtype}{nums}>"


def parse_ptxas(log_text: str, source: str = "") -> Dict[str, Dict[str, Any]]:
    """Per kernel entry of a ``-Xptxas -v`` log: ``{"source", "mangled",
    "registers", "spill_stores", "spill_loads", "stack_bytes",
    "smem_bytes"}``, keyed by :func:`kernel_symbol`."""
    out: Dict[str, Dict[str, Any]] = {}
    entry: Optional[Dict[str, Any]] = None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = {"source": source, "mangled": m.group(1), "spill_stores": 0,
                     "spill_loads": 0, "stack_bytes": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry["stack_bytes"] = int(m.group(1))
            entry["spill_stores"] = int(m.group(2))
            entry["spill_loads"] = int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["smem_bytes"] = int(smem.group(1)) if smem else 0
            out[kernel_symbol(entry["mangled"])] = entry
            entry = None
    return out


def kernel_resources(logs: Optional[Dict[str, Optional[str]]] = None) -> Dict[str, Any]:
    """Every K1 and K4 kernel's resources from the build logs kept beside
    the libraries (``ops/_kernels.build_log``), or from ``logs``."""
    if logs is None:
        from docqa_tpu_torch.ops import _kernels

        logs = {name: _kernels.build_log(name) for name in KERNEL_SOURCES}
    out: Dict[str, Any] = {}
    for source, text in logs.items():
        if text:
            out.update(parse_ptxas(text, source))
    return out


# ---------------------------------------------------------------------------
# the steady state
# ---------------------------------------------------------------------------


def steady_state() -> Dict[str, int]:
    """The sizes a repeated round must leave as they were: K4's
    ``plan_qmatmul`` cache, the leaf plans built, the weight tensor maps
    encoded and the scratch (re)allocations (``ops/qmatmul.py``)."""
    from docqa_tpu_torch.ops import qmatmul as qm

    return {
        "plan_qmatmul": qm.plan_qmatmul.cache_info().currsize,
        "leaf_plans": qm.CACHE_EVENTS["leaf_plans"],
        "tensor_maps": qm.CACHE_EVENTS["tensor_maps"],
        "scratch": qm.CACHE_EVENTS["scratch"],
    }


def steady_state_delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------
# report, semantics, budget
# ---------------------------------------------------------------------------


def make_report(kernels: Dict[str, Any], peaks: Dict[str, int],
                steady: Dict[str, Dict[str, int]]) -> Dict[str, Any]:
    """The audit's report from the card's readings: ``peaks`` entry point
    -> bytes, ``steady`` entry point -> the deltas of a repeated round."""
    roots: Dict[str, Any] = {}
    for name in ENTRY_POINTS:
        root: Dict[str, Any] = {"compiles": None, "peak_bytes": peaks.get(name, 0)}
        if name in steady:
            root["steady_state"] = dict(steady[name])
            root["steady_state_retraces"] = sum(steady[name].values())
        roots[name] = root
    return {
        "kernels": kernels,
        "workloads": {"main_path": {
            "meta": {"steady_state_roots": sorted(steady)}, "roots": roots}},
        "jit_roots": {"discovered": []},
    }


def _iter_roots(section: Dict[str, Any]):
    for wname, wl in section.get("workloads", {}).items():
        for rname, root in wl.get("roots", {}).items():
            yield wname, rname, root


def semantic_violations(report: Dict[str, Any]) -> List[str]:
    """Invariants checked against the MEASUREMENT, so regenerating the
    budget from a broken run still fails the gate."""
    out: List[str] = []
    for wname, rname, root in _iter_roots(report):
        steady_roots = report["workloads"][wname].get("meta", {}).get("steady_state_roots")
        if steady_roots is None or rname in steady_roots or (
            "steady_state_retraces" in root
        ):
            retraces = root.get("steady_state_retraces")
            if retraces != 0:
                out.append(
                    f"{wname}/{rname}: {retraces} steady-state retrace(s) — "
                    "every admitted shape must be compiled at warmup, never "
                    "inside a serving round"
                )
        expected = root.get("expected_shapes")
        if expected is not None and root.get("compiles") != expected:
            out.append(
                f"{wname}/{rname}: {root.get('compiles')} compiled "
                f"specialization(s) for {expected} admitted shape(s) — "
                "the warmed shape set drifted from the admission policy"
            )
        if not root.get("peak_bytes"):
            out.append(
                f"{wname}/{rname}: no memory_analysis measurement — the "
                "HBM gate cannot be satisfied by an empty measurement"
            )
    serve = report.get("workloads", {}).get("serve", {})
    prefill = serve.get("roots", {}).get("serve_prefill", {})
    shapes = prefill.get("per_shape") or {}
    trickle = (shapes.get("trickle") or {}).get("peak_bytes")
    full = (shapes.get("full") or {}).get("peak_bytes")
    if trickle is not None and full is not None and trickle >= full:
        out.append(
            f"serve_prefill: trickle-shape peak ({trickle}B) is not "
            f"smaller than the full-width peak ({full}B) — the narrow "
            "admission shape exists to make trickle rounds cheaper; this "
            "layout broke that"
        )
    meta = serve.get("meta", {})
    if meta.get("paged"):
        n_buckets = max(len(meta.get("token_buckets") or ()), 1)
        families = 2 if meta.get("prefix_cache") else 1
        allowed = families * n_buckets + 1
        total = sum(int(root.get("compiles") or 0)
                    for root in serve.get("roots", {}).values())
        if total > allowed:
            out.append(
                f"serve: {total} compiled programs across prefill+decode "
                f"— the paged batcher's whole matrix must stay <= "
                f"{allowed} ({families} prefill family(ies) x "
                f"{n_buckets} token budget(s) + one decode chunk); a "
                "regrowth toward the per-bucket shape families is a "
                "regression"
            )
    # the port's kernels: every entry read, with its registers
    for sym, k in sorted(report.get("kernels", {}).items()):
        if k.get("registers") is None:
            out.append(f"kernel {sym}: no ptxas reading — the register and spill "
                       "gate cannot be satisfied by an empty measurement")
    if "kernels" in report and not report["kernels"]:
        out.append("kernels: no ptxas log was read — the kernel gate needs the "
                   "build logs beside the libraries")
    return out


def compare_budget(report: Dict[str, Any], budget: Dict[str, Any]) -> List[str]:
    """Budget-gate violations: semantic invariants on the measurement,
    exact compile counts, per-root peak-memory ceilings (TODO growth notes
    rejected), the kernels' registers and spills against theirs, and the
    jit-root ledger in exact sync."""
    out: List[str] = list(semantic_violations(report))
    want = {(w, r): root for w, r, root in _iter_roots(budget)}
    got = {(w, r): root for w, r, root in _iter_roots(report)}
    for key in sorted(set(want) | set(got)):
        wname, rname = key
        if key not in got:
            out.append(f"budget root '{wname}/{rname}' was not audited (stale?)")
            continue
        if key not in want:
            out.append(f"root '{wname}/{rname}' has no budget entry")
            continue
        g, w = got[key], want[key]
        if g.get("compiles") != w.get("compiles"):
            out.append(
                f"{wname}/{rname}: {g.get('compiles')} compile(s) "
                f"(budget grants exactly {w.get('compiles')})"
            )
        ceiling = w.get("peak_bytes_ceiling")
        if ceiling is None:
            out.append(f"{wname}/{rname}: budget entry lacks peak_bytes_ceiling")
        elif g.get("peak_bytes", 0) > ceiling:
            peak = g.get("peak_bytes", 0)
            pct = 100.0 * (peak - ceiling) / max(ceiling, 1)
            out.append(
                f"{wname}/{rname}: peak {peak}B exceeds the HBM ceiling "
                f"{ceiling}B (+{pct:.0f}%) — justify and regrow the "
                "ceiling via --write-budget + an edited ceiling_note, or "
                "fix the regression"
            )
        note = str(w.get("ceiling_note", ""))
        if "TODO" in note:
            out.append(
                f"{wname}/{rname}: ceiling_note is an unjustified TODO — "
                "a grown ceiling needs a human-written reason"
            )

    if "kernels" in report or "kernels" in budget:
        out.extend(_compare_kernels(report.get("kernels", {}), budget.get("kernels", {})))

    ledger = budget.get("jit_roots", {})
    discovered = report.get("jit_roots", {}).get("discovered", [])
    for symbol in discovered:
        reason = ledger.get(symbol)
        if reason is None:
            out.append(
                f"new jit root '{symbol}' is neither covered by a "
                "compile-audit workload nor waived in compile_budget.json"
            )
        elif not str(reason).strip() or "TODO" in str(reason):
            out.append(f"jit root '{symbol}' has no real coverage/waiver reason")
    for symbol in sorted(set(ledger) - set(discovered)):
        out.append(f"stale jit-root ledger entry '{symbol}' (root no longer exists)")
    return out


def _compare_kernels(got: Dict[str, Any], want: Dict[str, Any]) -> List[str]:
    out: List[str] = []
    for sym in sorted(set(got) | set(want)):
        g, w = got.get(sym), want.get(sym)
        if g is None:
            out.append(f"budget kernel '{sym}' was not read (stale?)")
            continue
        if w is None:
            out.append(f"kernel '{sym}' has no budget entry")
            continue
        if g.get("registers", 0) > w.get("registers_ceiling", 0):
            out.append(f"kernel {sym}: {g.get('registers')} registers, over its "
                       f"ceiling {w.get('registers_ceiling')}")
        for what in ("spill_stores", "spill_loads"):
            if g.get(what, 0) > w.get(what, 0):
                out.append(f"kernel {sym}: {g.get(what)} bytes of {what.replace('_', ' ')}, "
                           f"the budget grants {w.get(what, 0)} — a new spill")
        for what in ("stack_bytes", "smem_bytes"):
            ceiling = w.get(f"{what}_ceiling")
            if ceiling is not None and g.get(what, 0) > ceiling:
                out.append(f"kernel {sym}: {g.get(what)} {what.replace('_', ' ')}, over "
                           f"its ceiling {ceiling}")
        if "TODO" in str(w.get("note", "")):
            out.append(f"kernel {sym}: note is an unjustified TODO — a grown ceiling "
                       "or a granted spill needs a human-written reason")
    return out


def load_budget(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or default_budget_path()
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _kernel_entry(k: Dict[str, Any], prior: Dict[str, Any]) -> Dict[str, Any]:
    """A kernel's budget entry: a ceiling kept while the reading fits, a
    grown one (or a new spill) stamped TODO."""
    entry = {"source": k.get("source", "")}
    note = prior.get("note", "")
    grew = False
    for what, key in (("registers", "registers_ceiling"),
                      ("stack_bytes", "stack_bytes_ceiling"),
                      ("smem_bytes", "smem_bytes_ceiling")):
        old = prior.get(key)
        if old is not None and k.get(what, 0) <= old:
            entry[key] = old
        else:
            entry[key] = int(k.get(what, 0))
            grew = grew or old is not None
    for what in ("spill_stores", "spill_loads"):
        old = prior.get(what)
        entry[what] = old if old is not None and k.get(what, 0) <= old else int(k.get(what, 0))
        grew = grew or (old is not None and k.get(what, 0) > old) or (
            old is None and k.get(what, 0) > 0)
    if grew:
        note = "TODO: justify the grown ceiling or the new spill"
    elif not prior:
        note = note or ("TODO: justify the spill" if k.get("spill_stores") else
                        "registers, stack and shared memory as built, no spill")
    entry["note"] = note
    return entry


def write_budget(report: Dict[str, Any], path: Optional[str] = None) -> Dict[str, Any]:
    """Regenerate the budget from a report.  Compile counts are copied, the
    peak-memory ceilings are PRESERVED while the measurement still fits
    and only grow through a TODO note the gate rejects until someone edits
    it; kernel ceilings and granted spills likewise; jit-root reasons are
    preserved (a new root gets a TODO)."""
    path = path or default_budget_path()
    old: Dict[str, Any] = {}
    if os.path.exists(path):
        old = load_budget(path)
    old_roots = {(w, r): root for w, r, root in _iter_roots(old)}
    old_ledger = old.get("jit_roots", {})

    workloads: Dict[str, Any] = {}
    for wname, wl in report.get("workloads", {}).items():
        roots_out = {}
        for rname, root in wl.get("roots", {}).items():
            peak = int(root.get("peak_bytes", 0))
            prior = old_roots.get((wname, rname), {})
            prior_ceiling = prior.get("peak_bytes_ceiling")
            if prior_ceiling is not None and peak <= prior_ceiling:
                ceiling = prior_ceiling
                note = prior.get("ceiling_note", "")
            else:
                ceiling = int(math.ceil(peak * CEILING_HEADROOM))
                if prior_ceiling is None:
                    note = prior.get("ceiling_note", "TODO: justify the initial ceiling")
                else:
                    note = (f"TODO: justify growth from {prior_ceiling} to "
                            f"{ceiling} bytes")
            roots_out[rname] = {
                "compiles": root.get("compiles"),
                "steady_state_retraces": 0,
                "peak_bytes_ceiling": ceiling,
                "ceiling_note": note,
            }
        workloads[wname] = {"meta": wl.get("meta", {}), "roots": roots_out}

    budget: Dict[str, Any] = {
        "_comment": (
            "Kernel-resource, peak-device-memory and steady-state budget of the "
            "port's main path (docqa_tpu_torch/analysis/compile_audit.py), read on "
            "the card by chip_smoke.py phase 21 (b).  Amend only by regenerating "
            "from a card run's report plus a reviewed note for any grown ceiling or "
            "granted spill.  jit_roots is empty: the port jits nothing."
        ),
        "workloads": workloads,
        "jit_roots": {
            symbol: old_ledger.get(symbol, "TODO: justify")
            for symbol in report.get("jit_roots", {}).get("discovered", [])
        },
    }
    if "kernels" in report:
        old_kernels = old.get("kernels", {})
        budget["kernels"] = {sym: _kernel_entry(k, old_kernels.get(sym, {}))
                             for sym, k in sorted(report["kernels"].items())}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(budget, f, indent=2, sort_keys=True)
        f.write("\n")
    return budget


def check_reading(report: Dict[str, Any], path: Optional[str] = None) -> Tuple[bool, List[str]]:
    """(ok, violations) of a card run's report against the budget."""
    violations = compare_budget(report, load_budget(path))
    return not violations, violations
