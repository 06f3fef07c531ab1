"""Drive the window: send a mix's asks to ``QAService.ask_submit`` as
``/ask`` does (the question and the request's deadline; ``k`` is the
deployment's) and read each answer from ``PendingAnswer.iter_text()``.

Submissions go through one lane, as the app's device lane serialises them;
each caller reads its answer on its own thread, as the app's wait lane
does, and sends its next ask when the last one ends.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from time import perf_counter, sleep
from typing import Any, List, Optional

from portbench.traffic import Ask


@dataclass
class AskRecord:
    ask: Ask
    t_due: float = float("nan")  # when its caller asked
    t_sent: float = float("nan")  # when the submission lane took it
    t_first: float = float("nan")
    t_end: float = float("nan")
    piece_times: List[float] = field(default_factory=list)
    outcome: str = "unanswered"
    tokens: List[int] = field(default_factory=list)
    prompt_ids: List[int] = field(default_factory=list)
    sources: List[str] = field(default_factory=list)
    chunks: List[str] = field(default_factory=list)
    ctx: Any = None
    handle: Any = None

    @property
    def answered(self) -> bool:
        return self.outcome == "answered"


class Driver:
    """Runs asks against ``qa``; ``fault`` holds a kernel or CUDA fault that
    stopped the run (it is raised again once every thread has ended)."""

    def __init__(self, qa, deadline_s: float):
        from docqa_tpu_torch import obs
        from docqa_tpu_torch.engines.serve import QueueFull
        from docqa_tpu_torch.ops._kernels import is_device_fault
        from docqa_tpu_torch.resilience.deadline import Deadline, DeadlineExceeded

        self._obs, self._QueueFull, self._is_fault = obs, QueueFull, is_device_fault
        self._Deadline, self._DeadlineExceeded = Deadline, DeadlineExceeded
        self.qa = qa
        self.deadline_s = deadline_s
        self.submit_lock = threading.Lock()
        self.fault: Optional[BaseException] = None
        self.stop = threading.Event()
        self.open: List[AskRecord] = []  # sent, not yet ended
        self._open_lock = threading.Lock()

    # ---- one ask -----------------------------------------------------------

    def submit(self, rec: AskRecord):
        """The submission lane: retrieval and the queueing of the prompt.
        Returns the pending answer, or None when the ask ended here."""
        obs = self._obs
        with self.submit_lock:
            rec.t_sent = perf_counter()
            rec.ctx = obs.new_trace("ask")
            obs.cost_open(rec.ctx, "interactive")
            try:
                pending = obs.call_in(
                    rec.ctx, self.qa.ask_submit, rec.ask.question,
                    deadline=self._Deadline.after(self.deadline_s),
                )
            except self._QueueFull:
                return self._end(rec, "shed")
            except self._DeadlineExceeded:
                return self._end(rec, "deadline")
            except Exception as e:  # noqa: BLE001 - classified and kept
                if self._is_fault(e):
                    self.fault = self.fault or e
                    self.stop.set()
                return self._end(rec, f"error:{type(e).__name__}")
        rec.sources, rec.chunks = list(pending.sources), list(pending.chunks)
        if pending.answer is not None:  # degraded at submission, or routed
            return self._end(rec, f"degraded:{pending.degrade_reason or pending.route}")
        rec.handle = pending.handle
        with self._open_lock:
            self.open.append(rec)
        return pending

    def stream(self, rec: AskRecord, pending) -> None:
        """The wait lane: every text delta as it lands, then the outcome."""
        try:
            for _delta in pending.iter_text():
                t = perf_counter()
                if not rec.piece_times:
                    rec.t_first = t
                rec.piece_times.append(t)
            rec.tokens = list(pending.handle.result(timeout=5.0))
            # the prompt the program built (its output, judged by the check)
            rec.prompt_ids = list(pending.handle._req.prompt_ids)
            self._end(rec, "answered")
        except self._DeadlineExceeded:
            self._end(rec, "deadline")
        except Exception as e:  # noqa: BLE001 - classified and kept
            if self._is_fault(e):
                self.fault = self.fault or e
                self.stop.set()
            self._end(rec, "cancelled" if type(e).__name__ == "RequestCancelled"
                      else f"error:{type(e).__name__}")
        finally:
            with self._open_lock:
                if rec in self.open:
                    self.open.remove(rec)

    def _end(self, rec: AskRecord, outcome: str) -> None:
        rec.t_end = perf_counter()
        rec.outcome = outcome
        self._obs.finish(rec.ctx, status="ok" if outcome == "answered" else "error")
        return None

    # ---- loops ---------------------------------------------------------------

    def run_closed(self, asks: List[Ask], clients: int, t_close: float,
                   stagger_s: float = 0.0) -> List[AskRecord]:
        """``clients`` callers take asks in order until ``t_close``, caller
        ``i`` starting ``i * stagger_s`` seconds after the first (so that
        their answers do not move in step); asks still open at the close
        are cancelled, and the callers joined."""
        records: List[AskRecord] = []
        it = iter(asks)
        take = threading.Lock()
        t_first = perf_counter()

        def client(i):
            start = t_first + i * stagger_s
            while perf_counter() < start and not self.stop.is_set():
                sleep(min(0.05, max(start - perf_counter(), 0.0)))
            while not self.stop.is_set() and perf_counter() < t_close:
                with take:
                    ask = next(it, None)
                    if ask is None:
                        return
                    rec = AskRecord(ask)
                    records.append(rec)
                rec.t_due = perf_counter()
                pending = self.submit(rec)
                if pending is not None:
                    self.stream(rec, pending)

        threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}", daemon=True)
                   for i in range(clients)]
        for t in threads:
            t.start()
        while perf_counter() < t_close and not self.stop.is_set():
            sleep(min(0.05, max(t_close - perf_counter(), 0.0)))
        with self._open_lock:
            still = list(self.open)
        for rec in still:
            rec.handle.cancel()  # the pool's cooperative cancellation
        for t in threads:
            t.join(timeout=120.0)
        return records

    def close(self) -> None:
        if self.fault is not None:
            raise self.fault
