"""The one traffic generator: a mix file of parameters in, the asks out.

A mix is a closed loop: ``clients`` callers, each sending its next ask when
its last one ends, as clinicians at the chat UI do.  Keys of a mix file
(``traffic/<name>.json``):

* ``clients``, ``stagger_s``, ``ramp_s``: callers, the seconds between two
  callers' first asks (so that answers do not move in step), and the
  seconds from the first caller's start to the window's opening, so the
  window sees a loop that has filled;
* ``chunk_tokens``, ``question_tokens``: the exact pieces of a chunk text
  and of a question; ``text_pool``: distinct chunk texts in the store.
  Every ask retrieves the deployment's ``default_k`` chunks, as ``/ask``
  does (it takes no ``k`` from its caller);
* ``max_new_tokens``: answer length; ``request_deadline_s``: the ``/ask``
  budget stamped at admission;
* ``trace_seconds``: the length of the profiled part of a traced run, at
  the window's end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

from portbench.inputs import questions


@dataclass
class Ask:
    index: int
    question: str


def schedule(mix: Dict[str, Any], seed: int, seconds: float) -> List[Ask]:
    """Enough asks for every caller's first and then ten a second over the
    ramp and the window (a bound far above what a card answers), taken in
    order."""
    n = int(mix["clients"]) + int(math.ceil(10 * (float(mix.get("ramp_s", 0)) + seconds)))
    qs = questions(seed, n, int(mix["question_tokens"]))
    return [Ask(i, qs[i]) for i in range(n)]
