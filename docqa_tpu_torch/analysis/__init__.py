"""docqa-lint for the port: AST invariant analysis of ``docqa_tpu_torch``.

Counterpart of ``docqa_tpu/analysis/``: its concurrency, lifecycle,
serving-contract, determinism, numerics and sharding halves.  Twenty-one
checkers, every project-specific table of theirs in one
:class:`~docqa_tpu_torch.analysis.core.AnalysisProfile` (the port's by
default):

* ``cv-protocol``     — condition waits in predicate loops, notify under
  the lock, request-path waits carry a Deadline.
* ``deadline-flow``   — request deadlines thread through; waits clamp.
* ``dtype-flow``      — bf16 reductions and softmax upcast, nothing drags
  float64 onto the card, and bf16 products keep float32 to the end
  (``allow_bf16_reduced_precision_reduction`` assigned False where
  ``utils.resolve_device`` resolves a CUDA device).
* ``entropy-in-state``— no wall-clock, uuid or urandom value in a cache or
  prefix key or a replayed journal field.
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
* ``mesh-axes``       — every collective goes through ``runtime/mesh.py``'s
  counted wrappers, over a MeshContext data or model group, under a
  literal site.
* ``order-stability`` — no set or unsorted directory order, and no
  unpinned dict order in an order sink, feeds pack, batch, key or journal
  order.
* ``phi-taint``       — raw pre-deid text never reaches logs/metrics/
  external payloads.
* ``replay-key-integrity`` — no salted builtin ``hash()`` in a key that
  must survive a restart.
* ``resource-flow``   — every acquired resource (KV block table, cost
  record, spine ticket, trace) reaches exactly one release on every
  control-flow path.
* ``retire-once``     — every request retires at a site declared in
  ``analysis/retirement_sites.json``, exactly once.
* ``rng-discipline``  — request-path sampling draws from a per-request
  seeded ``torch.Generator``: no global-generator draw or reseed, no
  literal seed, no module-global numpy or ``random`` RNG.
* ``shed-taxonomy``   — every request-path raise is a typed shed ledgered
  in ``analysis/shed_taxonomy.json`` with its HTTP status, cost outcome and
  trace flag; device faults (a kernel, a lost rank, CUDA) pass every
  catch-all.
* ``spec-shape``      — each sharding spec has its leaf's rank.
* ``thread-lifecycle``— every thread has a reachable join on its owner's
  stop/close path (threads that can reach device work especially).
* ``wire-consumer``   — every read of an HTTP or broker body resolves to a
  declared producer key.
* ``wire-safety``     — tensors, numpy values, locks, traces and
  non-finite floats never reach a serialization boundary uncoerced.
* ``wire-schema``     — every route of the app's table has its
  ``api_contract.json`` entry, and derivable payload keys match it.

The reference's jit-purity, donation and retrace-hazard have no subject
in the port (nothing is jitted, donated or traced): the profile's
``subjectless`` table names why, and ``analysis/subjectless.py`` finds the
constructs that would give them one.

The Tier-B audits:

* ``analysis/wire_audit.py`` drives every route of a runtime over HTTP,
  validates each live response against the contract and round-trips a
  broker journal (``--wire-audit``);
* ``analysis/replay_audit.py`` runs the replay smoke in two interpreters
  under different ``PYTHONHASHSEED``s and gates on bitwise-equal
  transcripts, with ``analysis/determinism_manifest.json`` ledgering every
  entropy source (``analysis/entropy.py``) (``--replay-audit``);
* ``analysis/shard_audit.py`` counts the device-plane programs'
  collectives in the mesh tests' gloo worlds (and at 1x1 in-process)
  against ``analysis/shard_budget.json``
  (``tests/test_torch_mesh_tp.py::test_shard_budget_over_the_worlds``;
  ``--shard-audit REPORT``);
* ``analysis/compile_audit.py`` holds the kernels' ptxas resources, the
  main path's peak device memory and its steady state, read on the card by
  ``chip_smoke.py`` phase 21, to ``analysis/compile_budget.json``
  (``--compile-audit REPORT``).

Two runtime witnesses hold the static graphs to what a live process does:
``analysis/race_witness.py`` (``DOCQA_RACE_WITNESS=1``: the witnessed
lock-order graph against lock-discipline's, served at ``GET
/api/witness``) and ``analysis/ledger_audit.py``
(``DOCQA_LEDGER_WITNESS=1``: every KV table and cost record from acquire
to release, against resource-flow's static sites, served at ``GET
/api/ledger``).

Entry point: ``python -m docqa_tpu_torch.analysis`` (the gate over the
port's tree against ``analysis/lint_baseline.json``; the audits' flags
above).
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
