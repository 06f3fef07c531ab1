"""Failure-path primitives of the serving plane, counterpart of
``docqa_tpu/resilience``:

* :mod:`deadline` — an end-to-end request budget threaded through
  retrieval, the replica pool and the continuous batcher; every stage sheds
  instead of queueing past it.
* :mod:`breaker` — per-dependency circuit breakers (the decoder, each pool
  replica) that stop hammering a failing dependency.
* :mod:`faults` — a deterministic seeded fault-injection plan that drives
  every behaviour above in the tests and in ``chip_smoke.py``.
* :mod:`policy` — in-place retries with seeded jitter, for the ingest
  pipeline's publishes, extraction and queue handlers.
"""

from docqa_tpu_torch.resilience.breaker import (  # noqa: F401
    BreakerBoard,
    BreakerOpen,
    CircuitBreaker,
)
from docqa_tpu_torch.resilience.deadline import (  # noqa: F401
    Deadline,
    DeadlineExceeded,
)
from docqa_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    FaultRule,
    InjectedFault,
    active_plan,
    install,
    perturb,
    uninstall,
)
from docqa_tpu_torch.resilience.policy import RetryPolicy  # noqa: F401
