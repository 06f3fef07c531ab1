"""Boundary coercion for everything that crosses the service wire, a copy
of ``docqa_tpu/service/wire.py``.

``json.dumps`` fails two ways worth guarding: values that raise (numpy
scalars, tensors, arbitrary objects) and values that serialize to non-JSON
(``float("nan")`` -> ``NaN``, which strict parsers reject).  ``to_wire``
normalizes both:

* numpy scalars -> native Python via ``.item()``; numpy arrays -> nested
  lists via ``.tolist()`` (re-coerced, so an array of NaN still gets the
  non-finite treatment);
* non-finite floats -> ``None``, with the dotted path of every such
  replacement recorded in a ``_nonfinite_fields`` list on the root object
  when the root is a dict;
* dicts, lists and tuples recurse; numpy-scalar keys coerce to ``str``.

Anything else passes through untouched, so ``json.dumps`` still fails
loudly on it.
"""

from __future__ import annotations

import math
from typing import Any, List

import numpy as _np

NONFINITE_KEY = "_nonfinite_fields"


def _coerce(value: Any, path: str, flagged: List[str]) -> Any:
    if isinstance(value, _np.generic):
        value = value.item()
    elif isinstance(value, _np.ndarray):
        value = value.tolist()
    if isinstance(value, float):
        if not math.isfinite(value):
            flagged.append(path)
            return None
        return value
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if isinstance(k, _np.generic):
                k = k.item()
            if not isinstance(k, str):
                k = str(k)
            out[k] = _coerce(v, f"{path}.{k}" if path else k, flagged)
        return out
    if isinstance(value, (list, tuple)):
        return [
            _coerce(v, f"{path}[{i}]", flagged)
            for i, v in enumerate(value)
        ]
    return value


def to_wire(payload: Any) -> Any:
    """Coerce ``payload`` for serialization (see module docstring).  When
    a non-finite float was nulled and the coerced root is a dict, the root
    gains ``"_nonfinite_fields": [<dotted paths>]``, a key every contract
    validator tolerates."""
    paths: List[str] = []
    out = _coerce(payload, "", paths)
    if paths and isinstance(out, dict):
        out[NONFINITE_KEY] = paths
    return out
