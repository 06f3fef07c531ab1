"""Request-scoped tracing, flight recorder, cost ledger, telemetry and
profiling, counterpart of ``docqa_tpu/obs``.  One import site for the rest
of the port:

* identity and propagation: :func:`new_trace`, :func:`current`,
  :func:`call_in`, :func:`headers_of`, :func:`from_headers`;
* recording: :func:`start_span`, ``Trace.record_span`` (worker threads),
  :func:`event`, :func:`flag`;
* retention: :data:`DEFAULT_RECORDER`, :func:`finish` / :func:`finish_id`;
* export: :func:`timeline_dict`, :func:`to_chrome_trace`, :func:`coverage`;
* analysis: :func:`attribution`, :func:`format_table`,
  :data:`DEFAULT_PROFILER` (an on-demand ``torch.profiler`` window),
  :data:`DEFAULT_OBSERVATORY` (analytic FLOPs over measured device time);
* telemetry: :class:`TelemetryStore`, :class:`WindowedDigest`,
  :class:`TelemetrySampler`, :class:`BurnRateEvaluator`,
  :func:`default_ask_slos`, :func:`prometheus_text`,
  :func:`telemetry_json`, :func:`lint_prometheus_text`;
* cost attribution: :class:`RequestCostLedger`, :class:`CostRecord`,
  :data:`DEFAULT_COST_LEDGER`, :func:`cost_open`.

* retrieval quality: :class:`RetrievalObservatory` (recall shadows of the
  tiered search, the nprobe frontier), :class:`ShadowJob`,
  :func:`wilson_interval`, :func:`compare_topk` and the process hook
  :func:`get_retrieval_observatory` / :func:`set_retrieval_observatory`.

Stdlib only at
import (torch is imported inside the profiler window, the peak detection
and the device-memory probe), so ``runtime/metrics.py`` imports it without
cycles.
"""

from docqa_tpu_torch.obs.context import (  # noqa: F401
    SPAN_HEADER,
    TRACE_HEADER,
    TraceContext,
    call_in,
    current,
    current_trace_id,
    event,
    flag,
    headers_of,
    next_trace_id,
    reset_ids,
)
from docqa_tpu_torch.obs.costs import (  # noqa: F401
    DEFAULT_COST_LEDGER,
    REQUEST_CLASSES,
    CostRecord,
    RequestCostLedger,
    cost_open,
    cost_record_of,
)
from docqa_tpu_torch.obs.export import (  # noqa: F401
    coverage,
    timeline_dict,
    to_chrome_trace,
)
from docqa_tpu_torch.obs.profiler import (  # noqa: F401
    DEFAULT_PROFILER,
    DEVICE_STAGES,
    ProfilerWindow,
    attribution,
    device_host_split,
    format_table,
    stage_kind,
)
from docqa_tpu_torch.obs.expo import (  # noqa: F401
    lint_prometheus_text,
    prometheus_text,
    telemetry_json,
)
from docqa_tpu_torch.obs.observatory import (  # noqa: F401
    DEFAULT_OBSERVATORY,
    Observatory,
    detect_peak_flops,
)
from docqa_tpu_torch.obs.recorder import (  # noqa: F401
    DEFAULT_RECORDER,
    FlightRecorder,
    enabled,
    ensure,
    finish,
    finish_id,
    from_headers,
    new_trace,
    set_enabled,
)
from docqa_tpu_torch.obs.retrieval_observatory import (  # noqa: F401
    RetrievalObservatory,
    ShadowJob,
    compare_topk,
    get_retrieval_observatory,
    set_retrieval_observatory,
    wilson_interval,
)
from docqa_tpu_torch.obs.slo import (  # noqa: F401
    BurnRateEvaluator,
    SLODef,
    default_ask_slos,
    default_retrieval_slos,
)
from docqa_tpu_torch.obs.spans import Span, Trace, start_span  # noqa: F401
from docqa_tpu_torch.obs.telemetry import (  # noqa: F401
    TelemetrySampler,
    TelemetryStore,
    WindowedDigest,
)
