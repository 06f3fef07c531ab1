"""Mean over every answer that ended in the window of the milliseconds
between its tokens as its caller read them: from the first answer delta
to the last, over the tokens after the first (failed asks are counted in
``failed``)."""


def read(run):
    gaps = [(r.t_end - r.t_first) / (len(r.tokens) - 1)
            for r in run.judged() if r.answered and len(r.tokens) > 1]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
