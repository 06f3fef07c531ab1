"""The prefill's share of the bf16 peak: the FLOPs that the prompts whose
first token came in the window need (the benchmark's count: each prompt's
tokens once, no padding; every prompt of a mix has the same length) over
the spine's ``serve_prefill_fetch`` device seconds in the window."""

from portbench import flops
from portbench.system import prompt_tokens


def read(run):
    s = run.spine_stage("serve_prefill_fetch")
    n = sum(1 for r in run.records if run.t_open <= r.t_first <= run.t_close)
    work = n * flops.prompt_flops(run.shape, prompt_tokens(run.config, run.mix))
    return flops.mfu_share(work, s["device_s"]) if work and s["count"] else None
