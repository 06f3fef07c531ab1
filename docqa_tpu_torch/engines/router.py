"""The extractive answer, counterpart of ``docqa_tpu/engines/router.py``'s
``extractive_answer``: the degraded ``/ask`` answer when generation is down
(``service/qa.py``).

Only this part of the reference module is ported.  Its answer router (the
two-stage decision that serves lookup questions straight from retrieval,
``AnswerRouter`` with its evidence gate) and the dense/lexical score fusion
come with the lexical retrieval tier (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import List

ROUTE_EXTRACTIVE = "extractive"


def extractive_answer(chunks: List[str], max_chars: int = 600) -> str:
    """The top-k retrieved chunks verbatim, joined by blank lines and cut
    at ``max_chars``; deterministic and model-free.  Byte-identical to the
    reference's."""
    text = "\n\n".join(c for c in chunks if c).strip()
    if not text:
        return "Aucun contexte trouvé."
    return text[:max_chars]
