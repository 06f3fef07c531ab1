"""The shard audit: count each device-plane program's collectives on
each mesh shape and hold them to a checked-in budget.

Counterpart of ``docqa_tpu/analysis/shard_audit.py``.  The reference
lowers its programs on virtual meshes and counts collectives in the
partitioned HLO; the port runs one process a rank, so its collectives are
calls, each counted by ``runtime/mesh.py`` in ``COLLECTIVES`` under
``<op>.<site>``.  :func:`audit_rank` runs each audited program once on
each mesh shape of the world it is called in and reads ``COLLECTIVES``
around it: in this process for ``1x1``, and in the mesh tests' gloo
worlds on the CPU (``tests/torch_mesh_worker.py``'s ``shard_audit``
scenario) for ``1x2``, ``1x4`` and ``2x2``.  :func:`make_report` merges
them (every rank of a world must count the same), and
:func:`compare_budget` holds the report to
``docqa_tpu_torch/analysis/shard_budget.json``.

The semantic rules (:func:`semantic_violations`) are checked against the
*measurement*, so a budget regenerated from a broken run still fails:

* a TP decoder forward: one all-reduce per Megatron block (2 a layer,
  ``all_reduce.decoder``) and one logits gather on a model axis > 1;
* the ``1x1`` mesh: no collective in any program;
* a sharded exact search (or an IVF probe, the same merge): two gathers,
  the top-k's values and ids;
* a data-parallel batch (the encoder, the generate streams): one gather
  on a data axis > 1;
* ring attention: n - 1 rounds on a ring of n, then one gather;
* Ulysses: four all-to-alls (q, k, v in, the output back) and one gather;
* an LM train step, by site: 3 L all-reduces of the decoder with remat,
  2 L + 1 of Megatron's *f*, two of the vocabulary-parallel loss, one of
  the clip on a model axis > 1; one a leaf and one of the loss on a data
  axis > 1.

The port jits nothing, so its budget's ``jit_roots`` ledger is empty and
any discovered root fails (``analysis/core.py``'s ``subjectless``).

Entry points: ``tests/test_torch_mesh_tp.py::test_shard_budget_over_the_worlds``
measures every program on every mesh shape and gates the report (with
``DOCQA_SHARD_REPORT=<path>`` it also writes it there);
``python -m docqa_tpu_torch.analysis --shard-audit REPORT [--write-budget]``
gates such a report, or regenerates the budget from it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

MESH_SHAPES: Dict[str, Tuple[int, int]] = {
    "1x1": (1, 1),
    "1x2": (1, 2),
    "1x4": (1, 4),
    "2x2": (2, 2),
}

AUDIT_PROGRAMS = (
    "decoder_tp_forward",
    "generate_data_gather",
    "sharded_topk",
    "ivf_probe_sharded",
    "encoder_data_parallel",
    "ring_attention",
    "ulysses_attention",
    "lm_train_step",
)

# the audit's widths, which tests/torch_mesh_worker.py imports for its own
# TP, training and encoder scenarios: one source, one budget
DECODER_WIDTHS = dict(vocab_size=128, hidden_dim=64, num_layers=2, num_heads=8,
                      num_kv_heads=8, head_dim=16, mlp_dim=128, max_seq_len=128,
                      dtype="float32")
TRAIN_WIDTHS = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=4,
                    num_kv_heads=4, head_dim=8, mlp_dim=64, max_seq_len=64,
                    dtype="float32")
ENCODER_WIDTHS = dict(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
                      mlp_dim=128, max_seq_len=64, embed_dim=64, dtype="float32")
TRAIN_LENGTHS = ((16, 13, 7, 5), (9, 16, 4, 12), (6, 8, 16, 15), (11, 3, 14, 16))


def default_budget_path() -> str:
    """``docqa_tpu_torch/analysis/shard_budget.json``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "shard_budget.json")


def model_dim(mesh_name: str) -> int:
    return MESH_SHAPES[mesh_name][1]


def data_dim(mesh_name: str) -> int:
    return MESH_SHAPES[mesh_name][0]


# ---------------------------------------------------------------------------
# the audited programs (one rank's part; counts from runtime.mesh)
# ---------------------------------------------------------------------------


def _counted(fn: Callable[[], Any]) -> Dict[str, int]:
    from docqa_tpu_torch.runtime import mesh as M

    M.COLLECTIVES.clear()
    fn()
    return dict(M.COLLECTIVES)


def _decoder_tp_forward(mesh):
    import torch

    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine

    cfg = DecoderConfig(**DECODER_WIDTHS)
    eng = GenerateEngine(cfg, GenerateConfig(max_new_tokens=2), seed=1, device="cpu",
                         mesh=mesh)
    ids = torch.tensor([[3, 4, 5, 0], [9, 8, 7, 6]])
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    cache = eng._new_cache(2, 64)
    with torch.inference_mode():
        counts = _counted(lambda: eng.forward(
            ids, cache, torch.zeros_like(lengths), attn_lengths=lengths,
            last_token_only=True))
    return counts, {"num_layers": cfg.num_layers, "megatron_blocks": 2 * cfg.num_layers,
                    "unit": "one forward"}


def _generate_data_gather(mesh):
    """A generate call's collectives beyond its forwards': the streams
    gathered over the data axis."""
    from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
    from docqa_tpu_torch.engines.generate import GenerateEngine

    cfg = DecoderConfig(**DECODER_WIDTHS)
    eng = GenerateEngine(cfg, GenerateConfig(max_new_tokens=4), seed=1, device="cpu",
                         mesh=mesh)
    counts = _counted(lambda: eng.generate_ids([[3, 4, 5], [9, 8, 7, 6]]))
    counts = {k: v for k, v in counts.items()
              if k not in ("all_reduce.decoder", "all_gather.logits")}
    return counts, {"unit": "one generate_ids call, its forwards' collectives apart"}


def _sharded_topk(mesh):
    import torch

    from docqa_tpu_torch.ops.topk import sharded_topk

    g = torch.Generator().manual_seed(11)
    scores = torch.randn(3, 64, generator=g)
    n_local = 64 // mesh.n_model
    lo = mesh.model_index * n_local
    counts = _counted(lambda: sharded_topk(scores[:, lo:lo + n_local], lo, 5,
                                           mesh.model_group))
    return counts, {"unit": "one search"}


def _ivf_probe_sharded(mesh):
    import numpy as np

    from docqa_tpu_torch.index.ivf import IVFIndex

    rng = np.random.default_rng(4)
    centres = rng.standard_normal((16, 32)).astype(np.float32)
    x = centres[rng.integers(0, 16, 2000)] + 0.1 * rng.standard_normal((2000, 32)).astype(
        np.float32)
    ivf = IVFIndex(x, [{}] * len(x), n_clusters=16, nprobe=4, dtype="float32",
                   device="cpu", mesh=mesh)
    counts = _counted(lambda: ivf.search(x[:5], k=10))
    return counts, {"unit": "one probe"}


def _encoder_data_parallel(mesh):
    from docqa_tpu_torch.config import EncoderConfig
    from docqa_tpu_torch.engines.encoder import EncoderEngine

    enc = EncoderEngine(EncoderConfig(**ENCODER_WIDTHS), device="cpu", mesh=mesh)
    texts = [f"note {i} about patient P00{i % 4}" for i in range(8)]
    return _counted(lambda: enc.encode_texts(texts)), {"unit": "one batch"}


def _attention_inputs():
    import torch

    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 64, 8, 16, generator=g) for _ in range(3)]


def _ring(mesh):
    from docqa_tpu_torch.parallel import ring_attention

    q, k, v = _attention_inputs()
    counts = _counted(lambda: ring_attention(q, k, v, mesh, causal=True))
    counts["ring_size"] = mesh.n_model
    return counts, {"unit": "one attention"}


def _ulysses(mesh):
    from docqa_tpu_torch.parallel import ulysses_attention

    q, k, v = _attention_inputs()
    return _counted(lambda: ulysses_attention(q, k, v, mesh, causal=True)), {
        "unit": "one attention"}


def train_batch(i: int, vocab: int = 64):
    """Step ``i``'s ids [4, 16] and ragged lengths (the mesh tests')."""
    import numpy as np

    rng = np.random.default_rng(100 + i)
    ids = rng.integers(1, vocab, (4, 16)).astype(np.int32)
    return ids, np.array(TRAIN_LENGTHS[i % len(TRAIN_LENGTHS)], np.int32)


def _lm_train_step(mesh):
    from docqa_tpu_torch import weights
    from docqa_tpu_torch.config import DecoderConfig
    from docqa_tpu_torch.training import train

    cfg = DecoderConfig(**TRAIN_WIDTHS)
    state, opt = train.init_train_state(
        cfg, optimizer=train.default_optimizer(1e-2),
        params=weights.host_init_decoder_params(cfg, 3), device="cpu", mesh=mesh)
    step = train.make_train_step(cfg, opt, mesh)
    counts = _counted(lambda: step(state, *train_batch(0)))
    return counts, {"num_layers": cfg.num_layers, "n_leaves": len(state["params"]),
                    "remat": True, "unit": "one step"}


_AUDITS: Dict[str, Callable] = {
    "decoder_tp_forward": _decoder_tp_forward,
    "generate_data_gather": _generate_data_gather,
    "sharded_topk": _sharded_topk,
    "ivf_probe_sharded": _ivf_probe_sharded,
    "encoder_data_parallel": _encoder_data_parallel,
    "ring_attention": _ring,
    "ulysses_attention": _ulysses,
    "lm_train_step": _lm_train_step,
}


def audit_rank(mesh_names: Sequence[str], programs: Sequence[str]) -> Dict[str, Any]:
    """This rank's counts: ``{program: {"meta", "per_mesh": {mesh: counts}}}``
    over the meshes of the world it is in (or the 1x1 mesh alone)."""
    import torch

    from docqa_tpu_torch.config import MeshConfig
    from docqa_tpu_torch.runtime import mesh as M

    torch.set_num_threads(1)
    out: Dict[str, Any] = {}
    for mesh_name in mesh_names:
        data, model = MESH_SHAPES[mesh_name]
        mesh = M.make_mesh(MeshConfig(data_parallel=data, model_parallel=model,
                                      platform="cpu"))
        for name in programs:
            counts, meta = _AUDITS[name](mesh)
            prog = out.setdefault(name, {"meta": {}, "per_mesh": {}})
            prog["meta"].update(meta)
            prog["per_mesh"][mesh_name] = counts
    return out


def world_meshes(n: int) -> List[str]:
    """The audited mesh shapes of a world of ``n`` ranks."""
    return [m for m, (d, k) in MESH_SHAPES.items() if d * k == n]


def merge_ranks(per_rank: Sequence[Dict[str, Any]]) -> Tuple[Dict[str, Any], List[str]]:
    """Rank 0's counts, and a violation for every rank that counted
    otherwise (every rank issues every collective of its groups)."""
    out = per_rank[0]
    bad = []
    for r, res in enumerate(per_rank[1:], start=1):
        for name, prog in res.items():
            for mesh_name, counts in prog["per_mesh"].items():
                want = out[name]["per_mesh"][mesh_name]
                if counts != want:
                    bad.append(f"{name}/{mesh_name}: rank {r} counted {counts}, "
                               f"rank 0 {want}")
    return out, bad


def make_report(single: Dict[str, Any],
                worlds: Sequence[Sequence[Dict[str, Any]]]) -> Dict[str, Any]:
    """The audit's report from this process's ``1x1`` counts and each
    world's per-rank counts (``audit_rank``'s results): ``programs``,
    ``jit_roots`` and ``rank_disagreements``."""
    report: Dict[str, Any] = {"programs": {}, "jit_roots": {"discovered": []},
                              "rank_disagreements": []}
    parts = [single]
    for per_rank in worlds:
        merged, bad = merge_ranks(per_rank)
        parts.append(merged)
        report["rank_disagreements"] += bad
    for part in parts:
        for name, prog in part.items():
            dst = report["programs"].setdefault(name, {"meta": {}, "per_mesh": {}})
            dst["meta"].update(prog["meta"])
            dst["per_mesh"].update(prog["per_mesh"])
    report["jit_roots"]["discovered"] = enumerate_jit_roots()
    return report


def enumerate_jit_roots(package=None) -> List[str]:
    """Every construct that would give jit-purity a subject in the port
    (``analysis/core.py``'s ``subjectless``), as ``<relpath>:<line>``; the
    budget's ledger is empty, so any one fails the gate."""
    from docqa_tpu_torch.analysis.core import Package, package_dir
    from docqa_tpu_torch.analysis.subjectless import subject_sites

    package = package or Package.load(package_dir())
    return sorted(f"{s['path']}:{s['line']}" for s in subject_sites(package, "jit-purity"))


# ---------------------------------------------------------------------------
# semantics, budget
# ---------------------------------------------------------------------------


def _collectives(counts: Dict[str, Any]) -> Dict[str, int]:
    return {k: v for k, v in counts.items() if "." in k}


def _only(name, mesh_name, counts, want, out, why) -> None:
    got = _collectives(counts)
    if got != want:
        out.append(f"{name}/{mesh_name}: {got or 'no collective'} — {why} "
                   f"(expected {want or 'no collective'})")


def semantic_violations(report: Dict[str, Any]) -> List[str]:
    """The invariants, checked against the MEASUREMENT (not the budget):
    an "update the budget to whatever it prints" workflow still cannot
    admit a layout that breaks them."""
    out: List[str] = []
    progs = report.get("programs", {})
    for name, prog in progs.items():
        counts = prog.get("per_mesh", {}).get("1x1")
        if counts is not None and _collectives(counts):
            out.append(f"{name}/1x1: {_collectives(counts)} — the (1, 1) mesh issues "
                       "no collective")

    def each(name):
        prog = progs.get(name)
        if not prog:
            return
        for mesh_name, counts in prog.get("per_mesh", {}).items():
            if mesh_name != "1x1":
                yield prog.get("meta", {}), mesh_name, counts

    for meta, mesh_name, counts in each("decoder_tp_forward"):
        blocks = meta.get("megatron_blocks", 0)
        want = ({"all_reduce.decoder": blocks, "all_gather.logits": 1}
                if model_dim(mesh_name) > 1 else {})
        _only("decoder_tp_forward", mesh_name, counts, want, out,
              f"a TP forward owes one all-reduce per Megatron block ({blocks}) and one "
              "logits gather, every other edge local")
    for meta, mesh_name, counts in each("generate_data_gather"):
        want = {"all_gather.generate": 1} if data_dim(mesh_name) > 1 else {}
        _only("generate_data_gather", mesh_name, counts, want, out,
              "a data-parallel generate gathers its streams once")
    for name in ("sharded_topk", "ivf_probe_sharded"):
        for meta, mesh_name, counts in each(name):
            want = {"all_gather.topk": 2} if model_dim(mesh_name) > 1 else {}
            _only(name, mesh_name, counts, want, out,
                  "a sharded search owes exactly its top-k merge pair (vals + ids); "
                  "the scan never leaves the shard")
    for meta, mesh_name, counts in each("encoder_data_parallel"):
        want = {"all_gather.encode": 1} if data_dim(mesh_name) > 1 else {}
        _only("encoder_data_parallel", mesh_name, counts, want, out,
              "a data-parallel batch gathers its rows once")
    for meta, mesh_name, counts in each("ring_attention"):
        n = counts.get("ring_size", model_dim(mesh_name))
        want = ({"ring_round.ring_attention": n - 1, "all_gather.ring_attention": 1}
                if n > 1 else {})
        if counts.get("ring_round.ring_attention", 0) != (n - 1 if n > 1 else 0):
            out.append(f"ring_attention/{mesh_name}: "
                       f"{counts.get('ring_round.ring_attention', 0)} round(s) on a "
                       f"{n}-rank ring — a ring needs exactly n-1 (= {n - 1}); the n-th "
                       "rotation is pure wasted traffic")
        else:
            _only("ring_attention", mesh_name, counts, want, out,
                  "the ring only rotates KV shards, then gathers its output")
    for meta, mesh_name, counts in each("ulysses_attention"):
        grouped = model_dim(mesh_name) > 1
        want = {"all_to_all.ulysses": 4, "all_gather.ulysses": 1} if grouped else {}
        if counts.get("all_to_all.ulysses", 0) != (4 if grouped else 0):
            out.append(f"ulysses_attention/{mesh_name}: "
                       f"{counts.get('all_to_all.ulysses', 0)} all-to-all(s) — the "
                       f"seq<->head reshuffle owes exactly {4 if grouped else 0}")
        else:
            _only("ulysses_attention", mesh_name, counts, want, out,
                  "Ulysses reshuffles q, k, v and the output, then gathers")
    for meta, mesh_name, counts in each("lm_train_step"):
        L = meta.get("num_layers", 0)
        want: Dict[str, int] = {}
        if model_dim(mesh_name) > 1:
            want.update({
                "all_reduce.decoder": (3 if meta.get("remat") else 2) * L,
                "all_reduce.decoder_grad": 2 * L + 1,
                "all_reduce.vocab_ce": 2, "all_reduce.clip": 1,
            })
        if data_dim(mesh_name) > 1:
            want.update({"all_reduce.lm_grads": meta.get("n_leaves", 0),
                         "all_reduce.lm_loss": 1})
        _only("lm_train_step", mesh_name, counts, want, out,
              "a step's collectives by site (module docstring)")
    for d in report.get("rank_disagreements", []):
        out.append(f"ranks disagree: {d}")
    return out


def compare_budget(report: Dict[str, Any], budget: Dict[str, Any],
                   programs: Optional[Sequence[str]] = None) -> List[str]:
    """Violations of the checked-in budget: any measured-vs-granted drift,
    any program or mesh missing on either side, any jit root neither
    covered nor waived (or waived without a real reason), plus the
    semantic invariants on the measurement itself.  ``programs`` narrows
    the comparison to those programs (a test world measures its own)."""
    out: List[str] = list(semantic_violations(report))
    want_progs = budget.get("programs", {})
    got_progs = report.get("programs", {})
    names = set(want_progs) | set(got_progs)
    if programs is not None:
        names &= set(programs)
    for name in sorted(names):
        if name not in got_progs:
            out.append(f"budget program '{name}' was not audited (stale?)")
            continue
        if name not in want_progs:
            out.append(f"program '{name}' has no budget entry")
            continue
        want_meshes = want_progs[name].get("per_mesh", {})
        got_meshes = got_progs[name].get("per_mesh", {})
        for mesh_name in sorted(set(want_meshes) | set(got_meshes)):
            want = want_meshes.get(mesh_name)
            got = got_meshes.get(mesh_name)
            if want is None or got is None:
                out.append(f"{name}/{mesh_name}: present in "
                           f"{'report' if want is None else 'budget'} only")
                continue
            for key in sorted(set(want) | set(got)):
                if want.get(key) != got.get(key):
                    out.append(f"{name}/{mesh_name}: {key} = {got.get(key)} "
                               f"(budget grants {want.get(key)})")

    ledger = budget.get("jit_roots", {})
    discovered = report.get("jit_roots", {}).get("discovered", [])
    for symbol in discovered:
        reason = ledger.get(symbol)
        if reason is None:
            out.append(f"new jit root '{symbol}' is neither audited nor waived "
                       f"in shard_budget.json")
        elif not str(reason).strip() or "TODO" in str(reason):
            out.append(f"jit root '{symbol}' has no real coverage/waiver reason")
    for symbol in sorted(set(ledger) - set(discovered)):
        out.append(f"stale jit-root ledger entry '{symbol}' (root no longer exists)")
    return out


def load_budget(path: Optional[str] = None) -> Dict[str, Any]:
    path = path or default_budget_path()
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_budget(report: Dict[str, Any], path: Optional[str] = None) -> Dict[str, Any]:
    """Regenerate the budget from a report, keeping existing jit-root and
    program reasons (a new root gets a TODO the gate rejects)."""
    path = path or default_budget_path()
    old: Dict[str, Any] = {}
    if os.path.exists(path):
        old = load_budget(path)
    old_ledger = old.get("jit_roots", {})
    old_progs = old.get("programs", {})
    budget = {
        "_comment": (
            "Collective budget of the port's device-plane programs, counted in "
            "runtime.mesh.COLLECTIVES by docqa_tpu_torch/analysis/shard_audit.py in "
            "the mesh tests' gloo worlds on the CPU (tests/test_torch_mesh_tp.py "
            "test_shard_budget_over_the_worlds).  Amend only with --shard-audit "
            "REPORT --write-budget and a reviewed why. "
            "The semantic rules are checked against the measurement, so an edit "
            "here cannot relax them.  jit_roots is empty: the port jits nothing."
        ),
        "programs": {
            name: {
                "why": old_progs.get(name, {}).get("why", "TODO: justify"),
                "meta": prog.get("meta", {}),
                "per_mesh": prog.get("per_mesh", {}),
            }
            for name, prog in report.get("programs", {}).items()
        },
        "jit_roots": {
            symbol: old_ledger.get(symbol, "TODO: justify")
            for symbol in report.get("jit_roots", {}).get("discovered", [])
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(budget, f, indent=2, sort_keys=True)
        f.write("\n")
    return budget


def budget_todos(budget: Dict[str, Any]) -> List[str]:
    """Programs whose ``why`` is missing or a TODO."""
    return sorted(name for name, prog in budget.get("programs", {}).items()
                  if not str(prog.get("why", "")).strip() or "TODO" in str(prog.get("why")))

