"""Mean over the window's asks of the flight recorder's ``serve_queue_wait``
span: from submission to the admission round that took the ask."""


def read(run):
    waits = []
    for r in run.judged():
        if r.ctx is None:
            continue
        waits += [s.duration_ms for s in r.ctx.trace.snapshot_spans()
                  if s.name == "serve_queue_wait"]
    return sum(waits) / len(waits) if waits else None
