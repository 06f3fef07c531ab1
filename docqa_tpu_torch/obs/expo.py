"""Exposition: Prometheus text and JSON time series, counterpart of
``docqa_tpu/obs/expo.py``.

:func:`prometheus_text` renders the metrics registry (counters, gauges,
histogram windowed digests) plus the telemetry store's sampled gauges as
plain 0.0.4 text, or as OpenMetrics 1.0 when asked.  Histograms render as
summaries (quantile labels); in the OpenMetrics dialect each histogram also
exposes a ``<name>_samples_total`` counter carrying the largest traced
sample as an exemplar (legal there, unlike on summary lines), so a p95 can
be chased to a flight-recorder timeline by trace id.  :func:`telemetry_json`
gives the rollup ring as JSON, one series per name.

:func:`lint_prometheus_text` is a strict line lint of the format: every
sample line must match :data:`PROM_LINE_RE`, every name :data:`PROM_NAME_RE`,
and HELP/TYPE must precede their samples.  Stdlib only.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterable, List, Optional

from docqa_tpu_torch.obs.telemetry import TelemetryStore

PROM_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
# one sample line: name{labels} value [timestamp] [# {exemplar} value]
PROM_LINE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"  # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"  # labels
    r" (-?(?:[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?|Inf)|\+Inf|NaN)"
    r"( -?[0-9]+)?"  # optional ms timestamp
    r"( # \{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\"\}"
    r" -?[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)?$"  # exemplar
)

_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str, prefix: str = "docqa_") -> str:
    """Metric-name sanitation: the registry allows dots/dashes in names
    (``broker_depth_raw-docs``); Prometheus does not."""
    out = prefix + _SANITIZE_RE.sub("_", name)
    if not PROM_NAME_RE.match(out):
        out = "docqa_invalid_" + _SANITIZE_RE.sub("_", out)
    return out


def _fmt(value: float) -> str:
    if isinstance(value, float):
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "+Inf" if value > 0 else "-Inf"
        if value == int(value) and abs(value) < 1e15:
            return str(int(value))
        return repr(value)
    return str(value)


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def prometheus_text(
    registry,
    store: Optional[TelemetryStore] = None,
    prefix: str = "docqa_",
    openmetrics: bool = False,
) -> str:
    """Render the registry (and the store's sampled gauges that have no
    registry instrument) as Prometheus exposition text.

    Two dialects, negotiated by the HTTP layer from the Accept header:

    * ``openmetrics=False`` — plain 0.0.4 text.  NO exemplars: the
      legacy parser treats ``# {...}`` after a value as a syntax error
      and a single exemplar would fail the WHOLE scrape, dropping every
      metric.  Counters are typed under their ``_total`` sample name
      (the 0.0.4 client-library convention).
    * ``openmetrics=True`` — OpenMetrics 1.0: families typed under the
      base name (counter samples get the ``_total`` suffix), terminated
      with ``# EOF``, and each histogram additionally exposes a
      ``<name>_samples_total`` counter carrying the largest traced
      sample as an **exemplar** — exemplars are legal on counter
      samples (not on summary quantiles), so the trace-id → timeline
      link survives a spec-strict parser.
    """
    lines: List[str] = []
    snapshot_counters, snapshot_hists, snapshot_gauges = (
        registry.instruments()
    )

    def head(name: str, kind: str, help_text: str) -> None:
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")

    for name in sorted(snapshot_counters):
        base = sanitize_name(name, prefix)
        # 0.0.4 types counters under the `_total` SAMPLE name (metadata
        # under a sample-less name is dropped by scrapers); OpenMetrics
        # types the FAMILY and mandates the suffix on samples
        head(
            base if openmetrics else base + "_total",
            "counter",
            f"cumulative count of {name}",
        )
        lines.append(
            f"{base}_total {_fmt(float(snapshot_counters[name].value))}"
        )

    for name in sorted(snapshot_gauges):
        pname = sanitize_name(name, prefix)
        head(pname, "gauge", f"last sampled value of {name}")
        lines.append(f"{pname} {_fmt(float(snapshot_gauges[name].value))}")

    emitted = {sanitize_name(n, prefix) for n in snapshot_counters}
    emitted |= {sanitize_name(n, prefix) for n in snapshot_gauges}

    for name in sorted(snapshot_hists):
        h = snapshot_hists[name]
        summary = h.summary()
        pname = sanitize_name(name, prefix)
        head(
            pname,
            "summary",
            f"windowed percentiles of {name} "
            "(quantiles over the recent rollup windows)",
        )
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            value = summary.get(key)
            if value is None or (
                isinstance(value, float) and math.isnan(value)
            ):
                continue
            lines.append(
                f'{pname}{{quantile="{q}"}} {_fmt(float(value))}'
            )
        lines.append(f"{pname}_sum {_fmt(float(h.sum))}")
        lines.append(f"{pname}_count {_fmt(float(summary['count']))}")
        emitted.add(pname)
        exemplars = summary.get("exemplars") or []
        if openmetrics and exemplars:
            # the exemplar rides a dedicated counter family: OpenMetrics
            # allows exemplars on counter samples, never on summary
            # quantile/_count lines
            ex = exemplars[0]  # the largest traced sample
            head(
                f"{pname}_samples",
                "counter",
                f"observations of {name} (exemplar = largest traced "
                "sample; chase the trace_id via /api/trace/<id>)",
            )
            lines.append(
                f"{pname}_samples_total {_fmt(float(summary['count']))}"
                f' # {{trace_id="{_escape_label(ex["trace_id"])}"}}'
                f" {_fmt(float(ex['value']))}"
            )
            emitted.add(f"{pname}_samples")

    if store is not None:
        # sampled serving-plane gauges that exist only in the store
        # (pool replica health, KV occupancy, broker depths, HBM):
        # expose the LATEST window's value
        for name, value in sorted(store.latest_gauges().items()):
            pname = sanitize_name(name, prefix)
            if pname in emitted:
                continue
            head(pname, "gauge", f"sampled serving-plane gauge {name}")
            lines.append(f"{pname} {_fmt(float(value))}")
            emitted.add(pname)

    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def lint_prometheus_text(text: str) -> List[str]:
    """Strict structural lint of an exposition payload; returns the
    violations (empty = clean)."""
    problems: List[str] = []
    typed: Dict[str, str] = {}
    helped: set = set()
    all_lines = text.splitlines()
    for i, line in enumerate(all_lines, 1):
        if not line:
            continue
        if line == "# EOF":
            if i != len(all_lines):
                problems.append(f"line {i}: # EOF before end of payload")
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not PROM_NAME_RE.match(parts[2]):
                problems.append(f"line {i}: malformed HELP: {line!r}")
            else:
                helped.add(parts[2])
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or not PROM_NAME_RE.match(parts[2]):
                problems.append(f"line {i}: malformed TYPE: {line!r}")
            elif parts[3] not in (
                "counter", "gauge", "summary", "histogram", "untyped"
            ):
                problems.append(f"line {i}: unknown TYPE {parts[3]!r}")
            elif parts[2] in typed:
                problems.append(f"line {i}: duplicate TYPE for {parts[2]}")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            problems.append(f"line {i}: stray comment: {line!r}")
            continue
        if not PROM_LINE_RE.match(line):
            problems.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = re.split(r"[{ ]", line, maxsplit=1)[0]
        if " # {" in line and not name.endswith("_total"):
            # exemplars are only legal on counter samples (OpenMetrics);
            # on a summary line they fail a spec-strict parser
            problems.append(
                f"line {i}: exemplar on a non-counter sample: {name}"
            )
        base = re.sub(r"_(total|sum|count|bucket)$", "", name)
        if base not in typed and name not in typed:
            problems.append(f"line {i}: sample before TYPE: {name}")
    for name, kind in typed.items():
        if name not in helped:
            problems.append(f"TYPE without HELP: {name}")
    return problems


def telemetry_json(
    store: TelemetryStore, name: Optional[str] = None
) -> Dict[str, Any]:
    """The rollup ring as JSON (one series, or all of them)."""
    if name is not None:
        s = store.series(name)
        return {
            "interval_s": store.interval_s,
            "points": store.points,
            "series": {} if s is None else {name: s},
        }
    return store.snapshot()

