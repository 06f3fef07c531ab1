"""docqa-lint for the port: AST invariant analysis of ``docqa_tpu_torch``.

Counterpart of ``docqa_tpu/analysis/``, its concurrency and lifecycle
half.  Seven checkers, every project-specific table of theirs in one
:class:`~docqa_tpu_torch.analysis.core.AnalysisProfile` (the port's by
default):

* ``cv-protocol``     — condition waits in predicate loops, notify under
  the lock, request-path waits carry a Deadline.
* ``deadline-flow``   — request deadlines thread through; waits clamp.
* ``guarded-state``   — a field written under a lock anywhere is accessed
  under that lock everywhere (per-class + cross-object bridge facts).
* ``lock-discipline`` — one lock order (full-DFS cycles over a transitive
  acquisition graph); no blocking call under a lock, a wait for a CUDA
  stream included.
* ``phi-taint``       — raw pre-deid text never reaches logs/metrics/
  external payloads.
* ``resource-flow``   — every acquired resource (KV block table, cost
  record, spine ticket, trace) reaches exactly one release on every
  control-flow path.
* ``thread-lifecycle``— every thread has a reachable join on its owner's
  stop/close path (threads that can reach device work especially).

Two runtime witnesses hold the static graphs to what a live process does:
``analysis/race_witness.py`` (``DOCQA_RACE_WITNESS=1``: the witnessed
lock-order graph against lock-discipline's, served at ``GET
/api/witness``) and ``analysis/ledger_audit.py``
(``DOCQA_LEDGER_WITNESS=1``: every KV table and cost record from acquire
to release, against resource-flow's static sites, served at ``GET
/api/ledger``).

Entry point: ``python -m docqa_tpu_torch.analysis`` (the gate over the
port's tree against ``analysis/lint_baseline.json``).
"""

from docqa_tpu_torch.analysis.core import (  # noqa: F401
    PORT_PROFILE,
    AnalysisProfile,
    Baseline,
    Finding,
    Package,
    Protocol,
    all_checkers,
    analyze_paths,
    default_baseline_path,
    run,
)
