"""Deterministic seeded fault injection, counterpart of
``docqa_tpu/resilience/faults.py`` (host only, near verbatim).

Production code calls :func:`perturb(site)` at its instrumented points;
with no active plan that is one global read and an immediate return.

Instrumented sites in this package (grep ``resilience_site:``):

=====================  =====================================================
``broker.publish``     ``MemoryBroker.publish`` — a raise is a dropped
                       broker connection
``extract``            ``DocumentPipeline.ingest_document``, before
                       extraction
``deid``               ``DocumentPipeline._deid_handler``, before the tagger
                       batch
``index``              ``DocumentPipeline._index_handler``, before encoding
``decoder``            ``QAService`` generation submission — a raise here is
                       a decoder outage (the degraded-answer trigger)
``serve.worker_loop``  top of every ``ContinuousBatcher`` worker iteration —
                       a raise is a replica worker CRASH (queued requests
                       fail over via the pool, admitted ones fail typed); a
                       pure delay (``noerror``) is a worker WEDGE (the
                       heartbeat goes stale, the pool declares it dead)
``serve.decode_chunk`` before each decode chunk's fetch — a delay is a
                       SLOW-DECODE replica; a raise is a decode failure
                       (typed errors, the batcher survives)
=====================  =====================================================

The reference's ``checkpoint.load`` site comes with the checkpoint-import
slice.

A :class:`FaultPlan` is a list of :class:`FaultRule`; each rule matches a
site and fires at explicit call indices (``at_steps``) or with probability
``p`` drawn from a ``random.Random`` seeded by ``(plan.seed, site,
call_index)`` — the same plan and seed perturb the same calls, in this
package and in the reference alike.  Rules raise (:class:`InjectedFault`),
sleep (``delay_s``), or both.

Activation: ``with FaultPlan([...]):``, or :meth:`FaultPlan.from_env` on
``DOCQA_FAULTS`` / ``DOCQA_FAULTS_SEED``: semicolon-separated rules
``site[:key=value]*`` with keys ``p``, ``delay``, ``steps`` (comma-separated
call indices), ``times`` (max fires) and the flag ``noerror``, e.g.
``decoder:p=1;serve.decode_chunk:delay=0.2:p=0.5:noerror``.
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger

log = get_logger("docqa.faults")


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised unless a fault plan is
    installed)."""

    def __init__(self, site: str, step: int) -> None:
        self.site = site
        self.step = step
        super().__init__(f"injected fault at {site} (call #{step})")


@dataclass(frozen=True)
class FaultRule:
    site: str
    p: float = 0.0  # per-call probability of firing
    at_steps: Tuple[int, ...] = ()  # 0-based call indices that always fire
    delay_s: float = 0.0  # sleep this long when firing (slow stage)
    raise_error: bool = True  # raise InjectedFault when firing
    times: Optional[int] = None  # stop firing after this many hits

    def __post_init__(self):
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0,1], got {self.p}")


class FaultPlan:
    """A deterministic set of fault rules, installable as the process-wide
    active plan — one plan at a time: compose rules into one plan."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0) -> None:
        self.rules = list(rules)
        self.seed = seed
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}  # per-site call counter
        self._fires: Dict[int, int] = {}  # per-rule fire counter
        self.log: List[Tuple[str, int]] = []  # (site, step) of every fire

    @classmethod
    def from_env(
        cls, env: Optional[Mapping[str, str]] = None
    ) -> Optional["FaultPlan"]:
        """Parse ``DOCQA_FAULTS`` / ``DOCQA_FAULTS_SEED``; None when unset or
        empty."""
        env = os.environ if env is None else env
        spec = (env.get("DOCQA_FAULTS") or "").strip()
        if not spec:
            return None
        seed = int(env.get("DOCQA_FAULTS_SEED", "0"))
        rules = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            tokens = part.split(":")
            site, kv = tokens[0].strip(), tokens[1:]
            kwargs: Dict[str, object] = {}
            for tok in kv:
                key, _, value = tok.partition("=")
                key = key.strip()
                if key == "p":
                    kwargs["p"] = float(value)
                elif key == "delay":
                    kwargs["delay_s"] = float(value)
                elif key == "steps":
                    kwargs["at_steps"] = tuple(int(s) for s in value.split(",") if s)
                elif key == "times":
                    kwargs["times"] = int(value)
                elif key == "noerror":
                    kwargs["raise_error"] = False
                else:
                    raise ValueError(
                        f"unknown DOCQA_FAULTS key {key!r} in {part!r}"
                    )
            rules.append(FaultRule(site, **kwargs))
        return cls(rules, seed=seed)

    # ---- activation ----------------------------------------------------------

    def __enter__(self) -> "FaultPlan":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)

    # ---- the hook ------------------------------------------------------------

    def perturb(self, site: str, sleep=time.sleep) -> None:
        """Called by instrumented code: maybe delay, maybe raise."""
        with self._lock:
            step = self._calls.get(site, 0)
            self._calls[site] = step + 1
            firing: List[Tuple[int, FaultRule]] = []
            for ri, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if rule.times is not None and self._fires.get(ri, 0) >= rule.times:
                    continue
                hit = step in rule.at_steps
                if not hit and rule.p > 0.0:
                    # crc32, not hash(): str hashes are randomized per
                    # interpreter, and a plan must replay across runs
                    rng = random.Random(
                        (self.seed * 1_000_003 + step)
                        ^ zlib.crc32(site.encode())
                        ^ (ri << 16)
                    )
                    hit = rng.random() < rule.p
                if hit:
                    self._fires[ri] = self._fires.get(ri, 0) + 1
                    firing.append((ri, rule))
            if firing:
                self.log.append((site, step))
        for _ri, rule in firing:
            DEFAULT_REGISTRY.counter(f"faults_{site}").inc()
            if rule.delay_s > 0.0:
                log.info(
                    "injected %.0f ms stall at %s (call #%d)",
                    rule.delay_s * 1000, site, step,
                )
                sleep(rule.delay_s)
            if rule.raise_error:
                log.info("injected fault at %s (call #%d)", site, step)
                raise InjectedFault(site, step)


# ---- process-wide active plan ----------------------------------------------

_active_lock = threading.Lock()
_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _active
    with _active_lock:
        if _active is not None and _active is not plan:
            raise RuntimeError(
                "a FaultPlan is already active; compose rules into one plan"
            )
        _active = plan


def uninstall(plan: FaultPlan) -> None:
    global _active
    with _active_lock:
        if _active is plan:
            _active = None


def active_plan() -> Optional[FaultPlan]:
    return _active


def perturb(site: str) -> None:
    """The production-code hook: near-zero cost when no plan is active."""
    plan = _active
    if plan is not None:
        plan.perturb(site)
