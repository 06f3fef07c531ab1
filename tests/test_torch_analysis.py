"""Port parity, the analyzer: ``docqa_tpu_torch.analysis`` held against
``docqa_tpu.analysis``, its concurrency and lifecycle half.

* The shared fixtures: every positive, suppressed and clean fixture of the
  seven ported rules in the reference's own tests
  (``tests/test_analysis.py``, ``tests/test_racecheck.py``'s guarded-state,
  thread-lifecycle, cv-protocol and lock-discipline DFS cases,
  ``tests/test_lifecheck.py``'s resource-flow cases; the one whose subject
  is a jax dispatch is left out), written to ``tmp_path`` and run through
  both analyzers, the port's under its own default profile.  The findings
  must be equal as (rule, path, line, symbol, message).
* The reference tree: the port's analyzer under the reference's profile
  (built from the reference's own tables) over ``docqa_tpu/`` gives exactly
  the reference analyzer's findings for lock-discipline, guarded-state,
  cv-protocol, deadline-flow, phi-taint and resource-flow.  Each tree is
  parsed once.
* Thread-lifecycle's dispatch predicate on the port's subject: ``torch``
  calls, the kernel wrappers' launch funnel, spine items, device-allocating
  constructors.
* Baseline mechanics on one baseline file read by both analyzers, and the
  port's tree gate: ``docqa_tpu_torch/`` against
  ``docqa_tpu_torch/analysis/lint_baseline.json``, NEW and STALE both
  failing, every entry justified.
* The true positives the rules found in the port, each pinned by a test
  that fails without its fix.
"""

import dataclasses
import json
import os
import textwrap
import threading
import time

import pytest

from docqa_tpu.analysis import concurrency as j_concurrency
from docqa_tpu.analysis import deadline_flow as j_deadline
from docqa_tpu.analysis import entropy_state as j_entropy_state
from docqa_tpu.analysis import order_stability as j_order
from docqa_tpu.analysis import replay_keys as j_replay_keys
from docqa_tpu.analysis import rng_discipline as j_rng
from docqa_tpu.analysis import lock_discipline as j_lock
from docqa_tpu.analysis import phi_taint as j_phi
from docqa_tpu.analysis import resource_flow as j_resource
from docqa_tpu.analysis import run as j_run
from docqa_tpu.analysis.core import Baseline as JBaseline
from docqa_tpu.analysis.core import all_checkers as j_all_checkers
from docqa_tpu.analysis.core import Finding as JFinding
from docqa_tpu.analysis.core import Package as JPackage
from docqa_tpu.analysis.core import _run_package as j_run_package
from docqa_tpu_torch.analysis import (
    PORT_PROFILE,
    AnalysisProfile,
    Baseline,
    Finding,
    Package,
    Protocol,
    all_checkers,
    analyze_paths,
    default_baseline_path,
    run,
)
from docqa_tpu_torch.analysis.__main__ import main as lint_main
from docqa_tpu_torch.analysis.core import _run_package, package_dir
from docqa_tpu_torch.analysis.resource_flow import static_sites

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(REPO, "docqa_tpu")
RULES = ("cv-protocol", "deadline-flow", "guarded-state", "lock-discipline",
         "phi-taint", "resource-flow", "thread-lifecycle")
# the rules whose findings on the reference's own tree must be the
# reference's (thread-lifecycle's dispatch predicate is the port's own)
TREE_RULES = ("lock-discipline", "guarded-state", "cv-protocol", "deadline-flow",
              "phi-taint", "resource-flow")


def _rel(names):
    return frozenset(n.partition(".")[2] for n in names)


# the reference's tables as a profile (module names made package-relative)
REF_PROFILE = AnalysisProfile(
    request_path_modules=_rel(j_deadline.REQUEST_PATH_MODULES),
    lock_blocking_attrs=j_lock.BLOCKING_ATTRS,
    wait_blocking_attrs=j_deadline.BLOCKING_ATTRS,
    phi_source_calls=j_phi.SOURCE_CALLS,
    phi_source_keys=j_phi.SOURCE_KEYS,
    phi_sanitizer_suffixes=j_phi.SANITIZER_SUFFIXES,
    phi_clean_calls=j_phi.CLEAN_CALLS,
    phi_log_receivers=j_phi.LOG_RECEIVERS,
    phi_metric_attrs=j_phi.METRIC_ATTRS,
    # hard-coded in the reference's checker body
    phi_publish_attrs=frozenset({"publish", "_publish"}),
    phi_response_attrs=frozenset({"json_response"}),
    protocols=tuple(
        Protocol(p.name, p.acquires, p.release_methods, p.release_funcs, p.borrow_attrs)
        for p in j_resource.PROTOCOLS
    ),
    raise_prone_tails=j_resource._RAISE_PRONE_TAILS,
    dispatch_heads=j_concurrency._JAX_HEADS,
    dispatch_attrs=j_concurrency._DISPATCHING_ATTRS,
    dispatch_calls=frozenset(),
    # the determinism rules' scopes (their other tables default to the
    # reference's)
    replay_key_modules=_rel(j_replay_keys.PERSIST_KEY_MODULES),
    state_modules=_rel(j_entropy_state.STATE_MODULES),
    order_modules=_rel(j_order.ORDER_MODULES),
    rng_modules=_rel(j_rng.RNG_SCOPE_MODULES),
)


def _key(f):
    return (f.rule, f.path, f.line, f.symbol, f.message)


def _write(root, sources):
    root.mkdir(parents=True, exist_ok=True)
    for name, src in sources.items():
        (root / name).write_text(textwrap.dedent(src))
    return str(root)


# ---------------------------------------------------------------------------
# the shared fixtures
# ---------------------------------------------------------------------------

# Copied from the reference's tests (the fixture sources, verbatim after
# dedent), keyed by the reference test they come from.
FIXTURES = [
    pytest.param('deadline-flow', {
        'mod.py': '''
def retrieve(query, deadline=None):
    return query

def ask(question, deadline=None):
    return retrieve(question)
''',
    }, id='TestDeadlineFlow.test_dropped_deadline_detected'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def retrieve(query, deadline=None):
    return query

def ask(question, deadline=None):
    return retrieve(question, deadline=deadline)
''',
    }, id='TestDeadlineFlow.test_threaded_deadline_clean'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def submit(prompt, deadline=None):
    return prompt

def ask(question, deadline=None):
    kw = {} if deadline is None else {"deadline": deadline}
    return submit(question, **kw)
''',
    }, id='TestDeadlineFlow.test_kwargs_forwarding_trusted'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def resolve(handle, deadline=None):
    handle.done.wait(30.0)
''',
    }, id='TestDeadlineFlow.test_unclamped_wait_detected'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def resolve(handle, deadline=None):
    handle.done.wait()
''',
    }, id='TestDeadlineFlow.test_unbounded_wait_detected'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def resolve(handle, timeout, deadline=None):
    if deadline is not None:
        timeout = deadline.bound(timeout)
    handle.done.wait(timeout)
''',
    }, id='TestDeadlineFlow.test_clamped_wait_clean'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def pull(cv, deadline=None):
    waits = []
    waits.append(deadline.remaining())
    budget = min(waits)
    cv.wait(budget)
''',
    }, id='TestDeadlineFlow.test_derived_clamp_propagates'),
    pytest.param('deadline-flow', {
        'mod.py': '''
# docqa-lint: request-path
import time

def poll():
    time.sleep(0.005)
''',
    }, id='TestDeadlineFlow.test_sleep_on_request_path_detected'),
    pytest.param('deadline-flow', {
        'mod.py': '''
import time

def poll():
    time.sleep(0.005)
''',
    }, id='TestDeadlineFlow.test_sleep_off_request_path_clean'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def retrieve(query, deadline=None):
    return query

def ask(req, question, deadline=None):
    return retrieve(question, req.deadline)
''',
    }, id='TestDeadlineFlow.test_positional_deadline_expression_counts'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def pull(broker, deadline=None):
    a = broker.get_many("queue", 8)
    b = broker.get_many("queue", 8, deadline.bound(0.1))
    return a or b
''',
    }, id='TestDeadlineFlow.test_get_many_timeout_is_third_positional'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def ask(parts, worker, deadline=None):
    joined = " ".join(parts)
    worker.join(timeout=10)
    return joined
''',
    }, id='TestDeadlineFlow.test_str_join_not_a_wait'),
    pytest.param('deadline-flow', {
        'mod.py': '''
def retrieve(query, deadline=None):
    return query

def ask(question, deadline=None):
    return retrieve(question)  # docqa-lint: disable=deadline-flow
''',
    }, id='TestDeadlineFlow.test_suppression'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class Worker:
    def __init__(self, broker):
        self._lock = threading.Lock()
        self.broker = broker

    def flush(self, body):
        with self._lock:
            self.broker.publish("queue", body)
''',
    }, id='TestLockDiscipline.test_blocking_under_lock'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import os
import threading

class Journal:
    def __init__(self):
        self._lock = threading.Lock()

    def _write(self, f, rec):
        f.write(rec)
        os.fsync(f.fileno())

    def record(self, f, rec):
        with self._lock:
            self._write(f, rec)
''',
    }, id='TestLockDiscipline.test_blocking_through_callee'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class Pair:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def one(self):
        with self._a_lock:
            with self._b_lock:
                return 1

    def two(self):
        with self._b_lock:
            with self._a_lock:
                return 2
''',
    }, id='TestLockDiscipline.test_inconsistent_order'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class Pair:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def one(self):
        with self._a_lock, self._b_lock:
            return 1

    def two(self):
        with self._b_lock:
            with self._a_lock:
                return 2
''',
    }, id='TestLockDiscipline.test_multi_item_with_orders_its_own_items'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def pop(self):
        with self._cv:
            while not self.items:
                self._cv.wait(0.5)
            return self.items.pop()
''',
    }, id='TestLockDiscipline.test_cv_wait_on_held_lock_clean'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import os
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def fmt(self, parts, d):
        with self._lock:
            return os.path.join(d, ",".join(parts))
''',
    }, id='TestLockDiscipline.test_str_join_not_blocking'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=print)

    def stop(self):
        with self._lock:
            self._worker.join(timeout=10)
''',
    }, id='TestLockDiscipline.test_thread_join_under_lock_detected'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class Worker:
    def __init__(self, broker):
        self._lock = threading.Lock()
        self.broker = broker

    def flush(self, body):
        with self._lock:
            self.broker.publish("q", body)  # docqa-lint: disable=lock-discipline
''',
    }, id='TestLockDiscipline.test_suppression'),
    pytest.param('phi-taint', {
        'mod.py': '''
def handler(log, bodies):
    for body in bodies:
        log.info("processing %s", body["text"])
''',
    }, id='TestPhiTaint.test_raw_text_logged'),
    pytest.param('phi-taint', {
        'mod.py': '''
def handler(broker, cfg, body):
    broker.publish(
        cfg.clean_queue,
        {"doc_id": body["doc_id"], "masked": body["text"]},
    )
''',
    }, id='TestPhiTaint.test_raw_text_to_clean_queue'),
    pytest.param('phi-taint', {
        'mod.py': '''
def ingest(broker, cfg, doc_id, text_blob):
    text, why = extract_text_ex(text_blob, "f.txt")
    broker.publish(cfg.raw_queue, {"doc_id": doc_id, "text": text})
''',
    }, id='TestPhiTaint.test_raw_queue_publish_sanctioned'),
    pytest.param('phi-taint', {
        'mod.py': '''
def handler(log, deid, broker, cfg, bodies):
    texts = [b["text"] for b in bodies]
    masked = deid.deidentify_batch(texts)
    for b, clean in zip(bodies, masked):
        log.info("masked doc %s", clean)
        broker.publish(cfg.clean_queue, {"masked": clean})
''',
    }, id='TestPhiTaint.test_deidentified_text_clean'),
    pytest.param('phi-taint', {
        'mod.py': '''
def handler(registry, body):
    raw = body["text"]
    label = f"doc:{raw[:20]}"
    registry.counter(label).inc()
''',
    }, id='TestPhiTaint.test_taint_through_assignment_and_fstring'),
    pytest.param('phi-taint', {
        'mod.py': '''
def ingest(log, retry, data):
    def _extract():
        return extract_text_ex(data, "f.txt")

    text, why = retry.call(_extract, name="extract")
    log.info("got %s", text)
''',
    }, id='TestPhiTaint.test_nested_extractor_taints_retry_call'),
    pytest.param('phi-taint', {
        'mod.py': '''
def handler(log, body):
    log.debug("raw: %s", body["text"])  # docqa-lint: disable=phi-taint
''',
    }, id='TestPhiTaint.test_suppression'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0

    def push(self):
        with self._lock:
            self._depth += 1

    def peek(self):
        return self._depth
''',
    }, id='TestGuardedState.test_unguarded_read_detected'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0

    def push(self):
        with self._lock:
            self._depth += 1

    def reset(self):
        self._depth = 0
''',
    }, id='TestGuardedState.test_unguarded_write_detected'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0

    def push(self):
        with self._lock:
            self._depth += 1

    def peek(self):
        with self._lock:
            return self._depth
''',
    }, id='TestGuardedState.test_all_guarded_clean'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def push(self, x):
        with self._lock:
            self._items.append(x)

    def snapshot(self):
        return list(self._items)
''',
    }, id='TestGuardedState.test_mutating_method_is_a_write'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0

    def _bump(self):
        self._depth += 1

    def push(self):
        with self._lock:
            self._bump()

    def push_two(self):
        with self._lock:
            self._bump()
''',
    }, id='TestGuardedState.test_caller_holds_lock_inference'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0

    def _bump_locked(self):
        self._depth += 1

    def push(self):
        with self._lock:
            self._bump_locked()
''',
    }, id='TestGuardedState.test_locked_suffix_convention'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self._depth = 0

    def one(self):
        with self._a_lock:
            self._depth = 1

    def two(self):
        with self._b_lock:
            self._depth = 2
''',
    }, id='TestGuardedState.test_mixed_lock_detected'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self._depth = 0

    def one(self):
        with self._a_lock:
            self._depth = 1

    def two(self):
        with self._b_lock:
            with self._a_lock:
                self._depth = 2

    def read(self):
        with self._a_lock:
            return self._depth
''',
    }, id='TestGuardedState.test_intersection_is_the_guard_not_mixed'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Replica:
    def __init__(self):
        self.state = "ok"

    def routable(self):
        return self.state == "ok"

class Pool:
    def __init__(self):
        self._lock = threading.Lock()
        self.replicas = [Replica()]

    def kill(self, r):
        with self._lock:
            r.state = "dead"
''',
    }, id='TestGuardedState.test_cross_object_bridge_fact'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def push(self, x):
        with self._lock:
            self._items.append(x)

    def raw(self):
        with self._lock:
            return self._items
''',
    }, id='TestGuardedState.test_published_reference_detected'),
    pytest.param('guarded-state', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0

    def push(self):
        with self._lock:
            self._depth += 1

    def peek(self):
        return self._depth  # docqa-lint: disable=guarded-state
''',
    }, id='TestGuardedState.test_suppression'),
    pytest.param('thread-lifecycle', {
        'mod.py': '''
import threading

def kick(fn):
    threading.Thread(target=fn, daemon=True).start()
''',
    }, id='TestThreadLifecycle.test_unbound_thread_detected'),
    pytest.param('thread-lifecycle', {
        'mod.py': '''
import threading

class W:
    def start(self):
        self._t = threading.Thread(target=print)
        self._t.start()

    def stop(self):
        self._t.join(timeout=5)
''',
    }, id='TestThreadLifecycle.test_joined_attr_clean'),
    pytest.param('thread-lifecycle', {
        'mod.py': '''
import threading

class W:
    def start(self):
        self._t = threading.Thread(target=print)
        self._t.start()

    def stop(self):
        t = getattr(self, "_t", None)
        if t is not None:
            t.join(timeout=5)
''',
    }, id='TestThreadLifecycle.test_getattr_alias_join_clean'),
    pytest.param('thread-lifecycle', {
        'mod.py': '''
import threading

def fan_out(n):
    waiters = []
    for _ in range(n):
        t = threading.Thread(target=print)
        t.start()
        waiters.append(t)
    waiters.append(threading.Thread(target=print))
    for w in waiters:
        w.join()
''',
    }, id='TestThreadLifecycle.test_container_flow_join_clean'),
    pytest.param('thread-lifecycle', {
        'mod.py': '''
import threading

def kick(fn):
    threading.Thread(target=fn, daemon=True).start()  # docqa-lint: disable=thread-lifecycle
''',
    }, id='TestThreadLifecycle.test_suppression'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def pop(self):
        with self._cv:
            if not self.items:
                self._cv.wait(1.0)
            return self.items.pop()
''',
    }, id='TestCvProtocol.test_wait_outside_loop_detected'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def pop(self):
        with self._cv:
            while not self.items:
                self._cv.wait(1.0)
            return self.items.pop()
''',
    }, id='TestCvProtocol.test_wait_in_while_clean'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def push(self, x):
        self.items.append(x)
        self._cv.notify_all()
''',
    }, id='TestCvProtocol.test_notify_without_lock_detected'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def push(self, x):
        with self._cv:
            self.items.append(x)
            self._cv.notify_all()
''',
    }, id='TestCvProtocol.test_notify_under_cv_clean'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def push(self, x):
        with self._lock:
            self.items.append(x)
            self._cv.notify_all()
''',
    }, id='TestCvProtocol.test_notify_under_aliased_lock_clean'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def _wake(self):
        self._cv.notify_all()

    def push(self, x):
        with self._cv:
            self.items.append(x)
            self._wake()

    def close(self):
        with self._cv:
            self._wake()
''',
    }, id='TestCvProtocol.test_notify_in_caller_held_helper_clean'),
    pytest.param('cv-protocol', {
        'mod.py': '''
# docqa-lint: request-path
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def pull(self):
        with self._cv:
            while not self.items:
                self._cv.wait(0.5)
''',
    }, id='TestCvProtocol.test_request_path_wait_without_deadline_detected'),
    pytest.param('cv-protocol', {
        'mod.py': '''
# docqa-lint: request-path
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def pull(self, req):
        timeout = req.deadline.bound(30.0)
        with self._cv:
            while not self.items:
                self._cv.wait(timeout)
''',
    }, id='TestCvProtocol.test_request_path_clamped_wait_clean'),
    pytest.param('cv-protocol', {
        'mod.py': '''
import threading

class Q:
    def __init__(self):
        self._cv = threading.Condition()

    def push(self, x):
        self._cv.notify_all()  # docqa-lint: disable=cv-protocol
''',
    }, id='TestCvProtocol.test_suppression'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class T:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()
        self._c_lock = threading.Lock()

    def one(self):
        with self._a_lock:
            with self._b_lock:
                return 1

    def two(self):
        with self._b_lock:
            with self._c_lock:
                return 2

    def three(self):
        with self._c_lock:
            with self._a_lock:
                return 3
''',
    }, id='TestLockDisciplineDFS.test_three_cycle_detected'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class T:
    def __init__(self):
        self._a_lock = threading.Lock()
        self._b_lock = threading.Lock()

    def _inner(self):
        with self._b_lock:
            return 1

    def _middle(self):
        return self._inner()

    def one(self):
        with self._a_lock:
            return self._middle()

    def two(self):
        with self._b_lock:
            with self._a_lock:
                return 2
''',
    }, id='TestLockDisciplineDFS.test_transitive_closure_cycle_detected'),
    pytest.param('lock-discipline', {
        'mod.py': '''
import threading

class T:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def one(self):
        with self._cv:
            return 1

    def two(self):
        with self._lock:
            return 2
''',
    }, id='TestLockDisciplineDFS.test_condition_alias_not_an_edge'),
    pytest.param('resource-flow', {
        'mod.py': '''
def leaky(alloc, want_it):
    t = alloc.new_table()
    if want_it:
        return t
    return None
''',
    }, id='TestResourceFlow.test_leak_on_normal_exit_detected'),
    pytest.param('resource-flow', {
        'mod.py': '''
def leaky(alloc, deadline):
    t = alloc.new_table()
    deadline.check("stage")
    t.release()
''',
    }, id='TestResourceFlow.test_leak_on_exception_edge_detected'),
    pytest.param('resource-flow', {
        'mod.py': '''
def doubled(alloc):
    t = alloc.new_table()
    t.release()
    t.release()
''',
    }, id='TestResourceFlow.test_double_release_detected'),
    pytest.param('resource-flow', {
        'mod.py': '''
def clean(alloc, deadline):
    t = alloc.new_table()
    try:
        deadline.check("stage")
    finally:
        t.release()
''',
    }, id='TestResourceFlow.test_try_finally_release_clean'),
    pytest.param('resource-flow', {
        'mod.py': '''
def clean(alloc, cond):
    t = alloc.new_table()
    if cond:
        t.release()
        return None
    t.release()
    return cond
''',
    }, id='TestResourceFlow.test_release_on_both_branches_clean'),
    pytest.param('resource-flow', {
        'mod.py': '''
def transfer(self, alloc):
    t = alloc.new_table()
    self.slots.append(t)
''',
    }, id='TestResourceFlow.test_escape_transfers_custody'),
    pytest.param('resource-flow', {
        'mod.py': '''
def borrowed(alloc, blocks):
    t = alloc.new_table()
    alloc.share(t, blocks)
''',
    }, id='TestResourceFlow.test_borrow_does_not_transfer'),
    pytest.param('resource-flow', {
        'mod.py': '''
def clean(ledger):
    rec = ledger.open("interactive")
    ledger.retire(rec, "ok")
''',
    }, id='TestResourceFlow.test_cost_record_retire_func_clean'),
    pytest.param('resource-flow', {
        'mod.py': '''
def leaky(alloc, want_it):
    t = alloc.new_table()  # docqa-lint: disable=resource-flow
    if want_it:
        return t
    return None
''',
    }, id='TestResourceFlow.test_suppression_silences'),
]


def test_every_ported_rule_has_shared_fixtures():
    rules = {p.values[0] for p in FIXTURES}
    assert rules == set(RULES)
    # the serving-contract rules' fixtures are tests/test_torch_contracts.py's;
    # the determinism, numerics and sharding rules' are
    # tests/test_torch_{det,num,shard}check.py's, and the three JAX-only
    # rules are the profile's subjectless entries, their fixtures listed
    # there as subjectless
    serving = {"dispatch-streams", "host-sync", "retire-once", "shed-taxonomy",
               "wire-consumer", "wire-safety", "wire-schema"}
    later = {"entropy-in-state", "order-stability", "replay-key-integrity",
             "rng-discipline", "dtype-flow", "mesh-axes", "spec-shape"}
    assert sorted(all_checkers()) == sorted(set(RULES) | serving | later)
    subjectless = {e[0] for e in PORT_PROFILE.subjectless}
    assert subjectless == {"jit-purity", "donation", "retrace-hazard"}
    # every rule of the reference's analyzer is accounted for
    assert set(j_all_checkers()) == set(all_checkers()) | subjectless


@pytest.mark.parametrize("rule,sources", FIXTURES)
def test_fixture_findings_equal_reference(rule, sources, tmp_path):
    root = _write(tmp_path / "fixture", sources)
    ref = sorted(map(_key, j_run(root, rules=[rule], package_name="fixture")))
    port = sorted(map(_key, run(root, rules=[rule], package_name="fixture")))
    assert port == ref


# ---------------------------------------------------------------------------
# the reference's own tree, under the reference's profile
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_tree():
    """docqa_tpu parsed once by each analyzer."""
    return JPackage.load(REF_PKG), Package.load(REF_PKG, profile=REF_PROFILE)


@pytest.mark.parametrize("rule", TREE_RULES)
def test_reference_tree_findings_equal_reference(reference_tree, rule):
    jpkg, pkg = reference_tree
    ref = sorted(map(_key, j_run_package(jpkg, [rule])))
    port = sorted(map(_key, _run_package(pkg, [rule])))
    assert port == ref
    if rule in ("guarded-state", "lock-discipline"):
        assert ref, f"the reference tree gives no {rule} finding: the check is vacuous"


def test_static_sites_equal_reference(tmp_path):
    """resource-flow's site table (the ledger witness's static half) on the
    reference's fixture: the same sites under both analyzers."""
    root = _write(tmp_path / "fx", {"mod.py": """
        def pair(alloc, ledger):
            t = alloc.new_table()
            rec = ledger.open("interactive")
            t.release()
            retire(rec)
    """})
    ref = j_resource.static_sites(JPackage.load(root, package_name="fx"))
    port = static_sites(Package.load(root, package_name="fx"))
    assert port == ref
    assert sorted(s["kind"] for s in port["kv-table"]) == ["acquire", "release"]


# ---------------------------------------------------------------------------
# thread-lifecycle's dispatch predicate on the port's subject
# ---------------------------------------------------------------------------

_THREAD = """
import threading


class W:
    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        {body}
"""


@pytest.mark.parametrize("imports,body,via", [
    pytest.param("import torch", "return torch.zeros((4,))", "torch.zeros", id="torch"),
    pytest.param("import torch as th", "return th.empty(4)", "torch.empty", id="torch-alias"),
    pytest.param("from fixture.ops import _kernels", "_kernels.count('k1')",
                 "fixture.ops._kernels.count", id="kernel-launch-funnel"),
    pytest.param("from fixture.engines.spine import spine_run",
                 "return spine_run('stage', print)", "spine_run", id="spine-item"),
    pytest.param("from fixture.pool import Buffer", "return Buffer(4)",
                 "via Buffer.__init__ (torch.empty)", id="device-constructor"),
])
def test_thread_reaching_device_work_is_named(imports, body, via, tmp_path):
    pkg = tmp_path / "fixture"
    _write(pkg, {
        "__init__.py": "",
        "mod.py": imports + "\n" + _THREAD.format(body=body),
        "pool.py": """
            import torch


            class Buffer:
                def __init__(self, n):
                    self.t = torch.empty(n)
        """,
    })
    _write(pkg / "ops", {"__init__.py": "", "_kernels.py": """
        LAUNCHES = {}

        def count(*names):
            for n in names:
                LAUNCHES[n] = LAUNCHES.get(n, 0) + 1
    """})
    _write(pkg / "engines", {"__init__.py": "", "spine.py": """
        def spine_run(stage, fn, *args):
            return fn(*args)
    """})
    findings = [f for f in run(str(pkg), rules=["thread-lifecycle"]) if f.path == "mod.py"]
    assert len(findings) == 1, [f.format() for f in findings]
    assert "can reach device work" in findings[0].message
    assert via in findings[0].message


def test_thread_without_device_work_is_a_plain_daemon_finding(tmp_path):
    root = _write(tmp_path / "fixture", {
        "mod.py": _THREAD.format(body="return sum(range(4))"),
    })
    (finding,) = run(root, rules=["thread-lifecycle"], package_name="fixture")
    assert "device work" not in finding.message
    assert finding.message.endswith("a daemon thread dies mid-mutation at interpreter exit")


def test_joined_device_thread_is_clean(tmp_path):
    root = _write(tmp_path / "fixture", {"mod.py": """
        import threading
        import torch


        class W:
            def start(self):
                self._t = threading.Thread(target=self._loop, daemon=True)
                self._t.start()

            def _loop(self):
                return torch.zeros(4)

            def stop(self):
                self._t.join(timeout=5)
    """})
    assert run(root, rules=["thread-lifecycle"], package_name="fixture") == []


# ---------------------------------------------------------------------------
# lock-discipline's port additions (profile tables; none change the
# reference's findings, which the reference-tree test holds)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    "torch.cuda.synchronize()", "self._done.synchronize()", "x.item()", "x.tolist()",
    "x.cpu()",
])
def test_a_wait_for_the_card_under_a_lock_is_blocking(call, tmp_path):
    root = _write(tmp_path / "fixture", {"mod.py": f"""
        import threading
        import torch


        class S:
            def __init__(self):
                self._lock = threading.Lock()

            def fetch(self, x):
                with self._lock:
                    return {call}
    """})
    (f,) = run(root, rules=["lock-discipline"], package_name="fixture")
    assert f.message.startswith("blocking call") and "while holding S._lock" in f.message
    # the reference's profile does not count them
    assert run(root, rules=["lock-discipline"], package_name="fixture",
               profile=REF_PROFILE) == []


def test_profile_invokers_and_singletons_resolve_lock_edges(tmp_path):
    """A function handed to an invoker (``mirrored(obj, name, fn)``) runs
    as if called there, and a declared singleton resolves to its class:
    both edges reach the static graph, so a witnessed inversion is a
    cycle."""
    root = _write(tmp_path / "fixture", {"mod.py": """
        import threading


        def mirrored(obj, name, fn, *args):
            return fn(*args)


        class Obs:
            def __init__(self):
                self._lock = threading.Lock()

            def record(self, x):
                with self._lock:
                    return x


        DEFAULT_OBS = Obs()


        class Log:
            def record(self, x):  # a second `record`: the bare name is ambiguous
                return x


        class Store:
            def __init__(self):
                self._lock = threading.Lock()

            def add(self, x):
                return mirrored(self, "add", self._add, x)

            def _add(self, x):
                with self._lock:
                    return DEFAULT_OBS.record(x)


        class Pipe:
            def __init__(self, store):
                self._suppress_lock = threading.Lock()
                self.store = store

            def index(self, x):
                with self._suppress_lock:
                    return self.store.add(x)
    """})
    profile = dataclasses.replace(
        PORT_PROFILE, invokers=(("mirrored", 2),),
        receiver_classes=(("DEFAULT_OBS", "Obs"),),
    )
    pkg = Package.load(root, package_name="fixture", profile=profile)
    from docqa_tpu_torch.analysis.lock_discipline import build_acquisition_graph

    edges = set(build_acquisition_graph(pkg))
    assert ("Pipe._suppress_lock", "Store._lock") in edges
    assert ("Store._lock", "Obs._lock") in edges
    bare = set(build_acquisition_graph(Package.load(root, package_name="fixture",
                                                    profile=REF_PROFILE)))
    assert ("Pipe._suppress_lock", "Store._lock") not in bare
    assert ("Store._lock", "Obs._lock") not in bare


# ---------------------------------------------------------------------------
# baseline mechanics: one file, both analyzers
# ---------------------------------------------------------------------------

_BASE_SRC = {"mod.py": """
    import threading
    import time


    class T:
        def __init__(self):
            self._lock = threading.Lock()

        def slow(self):
            with self._lock:
                time.sleep(1)

        def slower(self):
            with self._lock:
                time.sleep(2)
"""}


def test_baseline_file_reads_the_same_in_both(tmp_path):
    root = _write(tmp_path / "fixture", _BASE_SRC)
    ref = j_run(root, rules=["lock-discipline"], package_name="fixture")
    port = run(root, rules=["lock-discipline"], package_name="fixture")
    assert len(port) == 2 and [f.fingerprint for f in port] == [f.fingerprint for f in ref]
    path = str(tmp_path / "baseline.json")
    JBaseline.from_findings(ref[:1], "the journal order is the lock's job").save(path)
    for base, found in ((JBaseline.load(path), ref), (Baseline.load(path), port)):
        new, matched, stale = base.split(found)
        assert [f.symbol for f in new] == ["T.slower"]  # NEW
        assert [f.symbol for f in matched] == ["T.slow"] and stale == []
        new, matched, stale = base.split(found[1:])
        assert [e["symbol"] for e in stale] == ["T.slow"]  # STALE


def test_scoped_update_preserves_out_of_scope_entries_in_both():
    other_rule = {"rule": "guarded-state", "path": "a.py", "symbol": "f",
                  "message": "held", "justification": "operator surface"}
    other_path = {"rule": "lock-discipline", "path": "elsewhere.py", "symbol": "g",
                  "message": "sleep", "justification": "test-only helper"}
    out = []
    for base_cls, finding_cls in ((JBaseline, JFinding), (Baseline, Finding)):
        firing = finding_cls("lock-discipline", "a.py", 3, "f", "kept")
        old = base_cls.from_findings([firing], "real reason")
        old.entries += [dict(other_rule), dict(other_path)]
        scoped = old.updated([firing], active_rules={"lock-discipline"},
                             analyzed_paths={"a.py"})
        full = old.updated([firing], active_rules={"lock-discipline", "guarded-state"},
                           analyzed_paths={"a.py", "elsewhere.py"})
        out.append((scoped.entries, full.entries))
    assert out[0] == out[1]
    scoped, full = out[1]
    assert {e["message"] for e in scoped} == {"kept", "held", "sleep"}
    assert [e["justification"] for e in full] == ["real reason"]


def test_missing_justification_is_caught(tmp_path):
    """A fresh --update-baseline entry carries "TODO: justify", which the
    gate's justification check refuses, in both analyzers' files."""
    root = _write(tmp_path / "fixture", _BASE_SRC)
    path = str(tmp_path / "baseline.json")
    rc = lint_main([root, "--rules", "lock-discipline", "--baseline", path,
                    "--update-baseline"])
    assert rc == 0
    entries = Baseline.load(path).entries
    assert len(entries) == 2 and all("TODO" in e["justification"] for e in entries)
    assert JBaseline.load(path).entries == entries
    assert not _justified(entries)


def test_cli_gate_exit_codes_and_json(tmp_path, capsys):
    root = _write(tmp_path / "fixture", _BASE_SRC)
    path = str(tmp_path / "baseline.json")
    assert lint_main([root, "--baseline", path, "--no-baseline"]) == 1
    assert lint_main([root, "--baseline", path, "--update-baseline"]) == 0
    data = json.load(open(path))
    for e in data["entries"]:
        e["justification"] = "serialises its own slow path on purpose"
    json.dump(data, open(path, "w"))
    capsys.readouterr()
    assert lint_main([root, "--baseline", path, "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == [] and out["stale_baseline_entries"] == []
    assert len(out["baselined"]) == 2
    # a re-update keeps the justifications of the entries that still fire
    assert lint_main([root, "--baseline", path, "--update-baseline"]) == 0
    assert all(e["justification"] == "serialises its own slow path on purpose"
               for e in Baseline.load(path).entries)


# ---------------------------------------------------------------------------
# the port's tree gate
# ---------------------------------------------------------------------------


def _justified(entries):
    return all(e.get("justification") and "TODO" not in e["justification"]
               for e in entries)


@pytest.fixture(scope="module")
def port_tree_findings():
    findings, analyzed = analyze_paths([package_dir()])
    return findings, analyzed


def test_port_tree_in_sync_with_its_baseline(port_tree_findings):
    findings, analyzed = port_tree_findings
    assert "service/app.py" in analyzed and "analysis/core.py" in analyzed
    baseline = Baseline.load(default_baseline_path())
    new, _matched, stale = baseline.split(findings)
    assert not new, "unbaselined findings:\n" + "\n".join(f.format() for f in new)
    assert not stale, "stale baseline entries:\n" + json.dumps(stale, indent=2)


def test_port_baseline_entries_justified():
    entries = Baseline.load(default_baseline_path()).entries
    assert entries and _justified(entries)
    assert os.path.dirname(default_baseline_path()) == os.path.join(
        REPO, "docqa_tpu_torch", "analysis")


def test_port_tree_holds_no_cycle_and_no_leak(port_tree_findings):
    """Of the port's baselined findings, the one cycle is the documented
    phantom (a set's add); resource-flow and deadline-flow find nothing."""
    findings, _ = port_tree_findings
    cycles = [f for f in findings if "inconsistent lock order" in f.message]
    assert [(f.path, f.symbol) for f in cycles] == [("index/lexical.py", "LexicalIndex._add")]
    assert [f for f in findings if f.rule in ("resource-flow", "deadline-flow")] == []


# ---------------------------------------------------------------------------
# the true positives the rules found in the port
# ---------------------------------------------------------------------------


def test_a_batch_indexed_during_a_snapshot_is_counted_after_it(tmp_path):
    """guarded-state: ``DocQARuntime._on_indexed`` counted documents
    without the snapshot's lock, so a batch landing while a snapshot was
    written was erased by the snapshot's reset and the next snapshot came
    late.  It now counts under the lock, after the reset."""
    from docqa_tpu_torch.service.app import DocQARuntime

    started, release = threading.Event(), threading.Event()

    class Store:
        def snapshot(self, path, keep_previous=True):
            started.set()
            release.wait(10)

    rt = DocQARuntime.__new__(DocQARuntime)
    rt.store = Store()
    rt._index_dir = str(tmp_path)
    rt.cfg = type("Cfg", (), {"data": type("Data", (), {"snapshot_every": 100})()})()
    rt._docs_since_snapshot = 0
    rt._snapshot_lock = threading.Lock()
    rt.stream = None  # no mesh
    snap = threading.Thread(target=rt._snapshot)
    snap.start()
    assert started.wait(10)
    batch = threading.Thread(target=rt._on_indexed, args=(3,))
    batch.start()
    batch.join(0.2)
    release.set()
    snap.join(10)
    batch.join(10)
    assert not snap.is_alive() and not batch.is_alive()
    assert rt._docs_since_snapshot == 3


def test_close_joins_the_shutdown_thread_a_device_fault_starts():
    """thread-lifecycle: ``AppServer.on_device_fault`` stopped the server
    from an unjoined ``http-shutdown`` thread, so ``close()`` could return
    True with it still running.  ``close()`` now joins it."""
    from docqa_tpu_torch.ops._kernels import KernelError
    from docqa_tpu_torch.service.app import AppServer

    class App:
        def close(self, timeout):
            return True

    server = AppServer(App()).start()
    real = server.shutdown
    gate = threading.Event()

    def slow_shutdown():
        if threading.current_thread().name == "http-shutdown":
            gate.wait(0.5)
        real()

    server.shutdown = slow_shutdown
    deadline = time.perf_counter() + 10
    while not server._serving.is_set() and time.perf_counter() < deadline:
        time.sleep(0.01)
    server.on_device_fault(KernelError("launch failed"))
    assert server.close(timeout=10)
    assert not [t for t in threading.enumerate() if t.name == "http-shutdown"]
    assert isinstance(server.fault, KernelError)
