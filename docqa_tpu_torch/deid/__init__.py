"""PHI de-identification (pattern and cue recognizers, the NER tagger)
and the synthetic labeled-PHI generator, counterpart of
``docqa_tpu/deid``."""

from docqa_tpu_torch.deid.engine import (  # noqa: F401
    DeidEngine,
    RecognizerResult,
    anonymize_text,
)
