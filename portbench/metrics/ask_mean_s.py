"""Mean over every ask that ended in the window of the seconds from its
caller's ask to its whole answer (a failed ask counts as missing every
limit: at the budget or later)."""


def read(run):
    values = run.latencies(first=False)
    return sum(values) / len(values) if values else None
