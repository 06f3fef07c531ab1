"""The reference's rules with no subject in the port, and the trip-wire
that says when one gets a subject.

``jit-purity``, ``donation`` and ``retrace-hazard`` police JAX's traced
programs: side effects in a traced body, a donated buffer read after the
call, a program traced again per shape.  The port traces, donates and
compiles nothing (``AnalysisProfile.subjectless`` names why), so they are
not ported as rules over the port.  :func:`subject_sites` finds every
construct that would give one a subject: ``torch.compile``,
``torch.jit.*``, a CUDA graph capture (``torch.cuda.graph``,
``CUDAGraph``, ``make_graphed_callables``) and, for donation, a
``donate``-named parameter or keyword.  ``tests/test_torch_detcheck.py``
fails while the port's tree holds one and its rule is still listed as
subjectless: a change that captures the verify step in a CUDA graph
(ROADMAP queue 2, G1) brings the graph-capture forms of jit-purity and
retrace-hazard with it.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from docqa_tpu_torch.analysis.core import Package, dotted_name


def _matches(text: str, construct: str) -> bool:
    if construct.endswith("."):
        return text.startswith(construct)
    if "." in construct:
        return text == construct or text.startswith(construct + ".")
    return construct in text.split(".")


def subject_sites(package: Package, rule: str) -> List[Dict[str, object]]:
    """Every construct of ``rule``'s ``subjectless`` entry in the package,
    as ``{"path", "line", "construct", "text"}``."""
    entry = next((e for e in package.profile.subjectless if e[0] == rule), None)
    if entry is None:
        return []
    constructs = entry[2]
    out: List[Dict[str, object]] = []
    for module in package.modules:
        for node in ast.walk(module.tree):
            texts: List[str] = []
            if isinstance(node, (ast.Attribute, ast.Name)):
                texts.append(module.resolve_alias(dotted_name(node)))
            elif isinstance(node, ast.arg):
                texts.append(node.arg)
            elif isinstance(node, ast.keyword) and node.arg:
                texts.append(node.arg)
            for text in texts:
                for construct in constructs:
                    hit = (construct in text) if "." not in construct and not (
                        construct[:1].isupper()) else _matches(text, construct)
                    if hit:
                        out.append({"path": module.relpath,
                                    "line": getattr(node, "lineno", 1),
                                    "construct": construct, "text": text})
    # one site a line and construct (an attribute chain visits its parts)
    seen = set()
    uniq = []
    for s in out:
        key = (s["path"], s["line"], s["construct"])
        if key not in seen:
            seen.add(key)
            uniq.append(s)
    return uniq
