"""Shared entropy-source classification for the determinism rules.

Counterpart of ``docqa_tpu/analysis/entropy.py``.  Every determinism gate
of the port is a *replay* gate: two runs under the same seeds must give
bitwise-identical token streams, retrieval ids and journal states.  The
enemy is entropy: values a process mints that the next process (or the
same process restarted) cannot mint again.  This module is the one place
that knows what counts as an entropy source; entropy-in-state and the
replay witness's manifest (``analysis/determinism_manifest.json``) both
classify through it, so the static rule, the dynamic gate and the ledger
cannot disagree about what "entropy" means.  The tables are the
profile's (``AnalysisProfile.entropy_*``).

Kinds:

* ``rng`` — explicit RNG mints and seeding: in the port
  ``torch.manual_seed``, a ``torch.Generator``'s ``manual_seed``,
  ``np.random.default_rng``, ``random.Random``.  Sanctioned when the seed
  derives from config or request state (the manifest entry records the
  derivation);
* ``process`` — per-process entropy that can never replay: ``os.urandom``,
  ``secrets.*``, ``uuid.uuid1`` / ``uuid4``.  Sanctioned only when the
  value is minted once and persisted, or is process-local on purpose;
* ``wallclock`` — ``time.time`` / ``time_ns``, ``datetime.now`` /
  ``utcnow``: clocks that can mint identity.  Sanctioned for telemetry
  timestamps and scheduling fields, never for keys.

Monotonic interval clocks (``perf_counter``, ``monotonic``) are not
enumerated into the manifest: they measure durations and cannot mint
identity, and nearly every module reads one.  Entropy-in-state still
polices them at key sinks.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from docqa_tpu_torch.analysis.core import (
    Module,
    Package,
    PORT_PROFILE,
    AnalysisProfile,
    call_name,
    stmt_walk,
)


def classify_entropy_call(
    module: Module, node: ast.Call, profile: Optional[AnalysisProfile] = None
) -> Optional[Tuple[str, str]]:
    """(kind, resolved-dotted-name) for an entropy-minting call, else
    None.  Resolution goes through the module's import-alias map, so
    ``from time import time`` classifies too."""
    profile = profile or PORT_PROFILE
    name = call_name(node)
    if not name:
        return None
    resolved = module.resolve_alias(name)
    if resolved in profile.entropy_rng_mints:
        return ("rng", resolved)
    if "." in name:
        tail = name.rsplit(".", 1)[-1]
        for rng_tail, as_name in profile.entropy_rng_tails:
            if tail == rng_tail:
                return ("rng", as_name)
    if (
        resolved in profile.entropy_process_sources
        or resolved.startswith("secrets.")
    ):
        return ("process", resolved)
    if resolved in profile.entropy_wallclock_sources:
        return ("wallclock", resolved)
    return None


def enumerate_entropy_sites(package: Package) -> List[Dict[str, str]]:
    """Every sanctioned-or-not entropy mint in the package, one entry per
    (kind, path, symbol, call): the unit the determinism manifest
    ledgers.  Several same-call sites in one function collapse to one
    entry (the justification covers the function's scheme), so line drift
    never churns the manifest."""
    profile = package.profile
    seen = {}
    for fn in package.functions:
        for node in stmt_walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            hit = classify_entropy_call(fn.module, node, profile)
            if hit is None:
                continue
            kind, call = hit
            key = (kind, fn.module.relpath, fn.qualname, call)
            seen.setdefault(key, getattr(node, "lineno", 1))
    for module in package.modules:
        for node in stmt_walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = classify_entropy_call(module, node, profile)
            if hit is None:
                continue
            kind, call = hit
            key = (kind, module.relpath, "<module>", call)
            seen.setdefault(key, getattr(node, "lineno", 1))
    out = [
        {
            "kind": kind,
            "path": path,
            "symbol": symbol,
            "call": call,
            "line": line,
        }
        for (kind, path, symbol, call), line in seen.items()
    ]
    out.sort(key=lambda e: (e["path"], e["symbol"], e["call"]))
    return out
