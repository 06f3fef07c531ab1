"""The window's share of the bf16 peak: the FLOPs that the asks answered in
the window need (prompt and answer, each token once, whatever was cached
or drafted) over the window's seconds."""

from portbench import flops


def read(run):
    work = sum(flops.ask_flops(run.shape, len(r.prompt_ids), len(r.tokens))
               for r in run.judged() if r.answered)
    return flops.mfu_share(work, run.seconds) if work else None
