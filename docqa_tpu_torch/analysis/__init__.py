"""docqa-lint for the port: AST invariant analysis of ``docqa_tpu_torch``.

Counterpart of ``docqa_tpu/analysis/``, its concurrency, lifecycle and
serving-contract halves.  Fourteen checkers, every project-specific table
of theirs in one
:class:`~docqa_tpu_torch.analysis.core.AnalysisProfile` (the port's by
default):

* ``cv-protocol``     — condition waits in predicate loops, notify under
  the lock, request-path waits carry a Deadline.
* ``deadline-flow``   — request deadlines thread through; waits clamp.
* ``dispatch-streams``— every thread entry point that can reach device
  work outside a spine item is ledgered in
  ``analysis/dispatch_streams.json`` under a concurrency budget, and every
  spine stage is declared there.
* ``guarded-state``   — a field written under a lock anywhere is accessed
  under that lock everywhere (per-class + cross-object bridge facts).
* ``host-sync``       — no blocking device→host sync on the /ask path
  outside the spine's sanctioned fetch (``to_host``, read after the
  ticket's result).
* ``lock-discipline`` — one lock order (full-DFS cycles over a transitive
  acquisition graph); no blocking call under a lock, a wait for a CUDA
  stream included.
* ``phi-taint``       — raw pre-deid text never reaches logs/metrics/
  external payloads.
* ``resource-flow``   — every acquired resource (KV block table, cost
  record, spine ticket, trace) reaches exactly one release on every
  control-flow path.
* ``retire-once``     — every request retires at a site declared in
  ``analysis/retirement_sites.json``, exactly once.
* ``shed-taxonomy``   — every request-path raise is a typed shed ledgered
  in ``analysis/shed_taxonomy.json`` with its HTTP status, cost outcome and
  trace flag; device faults (a kernel, a lost rank, CUDA) pass every
  catch-all.
* ``thread-lifecycle``— every thread has a reachable join on its owner's
  stop/close path (threads that can reach device work especially).
* ``wire-consumer``   — every read of an HTTP or broker body resolves to a
  declared producer key.
* ``wire-safety``     — tensors, numpy values, locks, traces and
  non-finite floats never reach a serialization boundary uncoerced.
* ``wire-schema``     — every route of the app's table has its
  ``api_contract.json`` entry, and derivable payload keys match it.

The Tier-B wire audit (``analysis/wire_audit.py``) drives every route of a
runtime over HTTP and validates each live response against the contract,
and round-trips a broker journal.

Two runtime witnesses hold the static graphs to what a live process does:
``analysis/race_witness.py`` (``DOCQA_RACE_WITNESS=1``: the witnessed
lock-order graph against lock-discipline's, served at ``GET
/api/witness``) and ``analysis/ledger_audit.py``
(``DOCQA_LEDGER_WITNESS=1``: every KV table and cost record from acquire
to release, against resource-flow's static sites, served at ``GET
/api/ledger``).

Entry point: ``python -m docqa_tpu_torch.analysis`` (the gate over the
port's tree against ``analysis/lint_baseline.json``; ``--wire-audit`` for
the live audit).
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
