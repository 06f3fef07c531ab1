"""Request and response schemas of the HTTP surface, counterpart of
``docqa_tpu/service/schemas.py`` as plain dataclasses (the card's Python
has no pydantic).

Fields, defaults and constraints are the reference's.  A request model is
built from a JSON body with :meth:`Model.from_json`, which raises
``ValueError`` (the app answers 422) for a body that is not an object, a
missing required field, a value of the wrong type or a list below its
minimum length; unknown keys are ignored, as pydantic's default does.  The
type check is strict where pydantic's lax mode would convert (a numeric
string for an int, say).  A response model serializes with
:meth:`Model.to_dict`.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _type_ok(value: Any, hint: Any) -> bool:
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        return any(_type_ok(value, h) for h in typing.get_args(hint))
    if origin in (list, List):
        (elem,) = typing.get_args(hint)
        return isinstance(value, list) and all(_type_ok(v, elem) for v in value)
    if hint is type(None):
        return value is None
    if hint is int:
        return isinstance(value, int) and not isinstance(value, bool)
    if hint is dict:
        return isinstance(value, dict)
    return isinstance(value, hint)


class Model:
    """Base of the schema dataclasses."""

    @classmethod
    def from_json(cls, body: Any):
        if not isinstance(body, dict):
            raise ValueError(f"{cls.__name__}: body must be a JSON object")
        hints = typing.get_type_hints(cls)
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in body:
                required = (
                    f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING
                )
                if required:
                    raise ValueError(f"{cls.__name__}.{f.name}: field required")
                continue
            value = body[f.name]
            if not _type_ok(value, hints[f.name]):
                raise ValueError(
                    f"{cls.__name__}.{f.name}: expected {hints[f.name]}, "
                    f"got {type(value).__name__}"
                )
            min_length = f.metadata.get("min_length")
            if min_length is not None and len(value) < min_length:
                raise ValueError(
                    f"{cls.__name__}.{f.name}: at least {min_length} item(s)"
                )
            kwargs[f.name] = value
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class Query(Model):
    question: str


@dataclass
class SummarizeRequest(Model):
    prompt: str
    max_tokens: Optional[int] = None


@dataclass
class PatientSummaryRequest(Model):
    patient_id: str
    from_date: Optional[str] = None  # ISO yyyy-mm-dd
    to_date: Optional[str] = None
    focus: Optional[str] = None
    language: str = "fr"


@dataclass
class PatientComparisonRequest(Model):
    patient_ids: List[str] = field(metadata={"min_length": 1})
    focus: Optional[str] = None
    language: str = "fr"


@dataclass
class SourceSnippet(Model):
    doc_id: str
    snippet: str


@dataclass
class Section(Model):
    title: str
    content: str


@dataclass
class SinglePatientSummaryResponse(Model):
    patient_id: str
    sections: List[Section]
    key_points: List[str]
    sources: List[SourceSnippet]
    type: str = "single_patient_summary"


@dataclass
class ComparisonRow(Model):
    criterion: str
    values: dict  # patient_id -> value


@dataclass
class MultiPatientComparisonResponse(Model):
    patient_ids: List[str]
    summary: str
    comparison_table: List[ComparisonRow]
    sources: List[SourceSnippet]
    type: str = "multi_patient_comparison"
