"""Answer tokens delivered in the window over the verify steps the pool ran
in it (``stats["verify_steps"]``): lanes filled times drafts accepted."""


def read(run):
    steps = run.stats.get("verify_steps", 0)
    return run.pieces_in_window() / steps if steps else None
