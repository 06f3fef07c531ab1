"""Device milliseconds a verify step: the spine's ``serve_decode_chunk``
device seconds in the window over the verify steps run in it."""


def read(run):
    steps = run.stats.get("verify_steps", 0)
    s = run.spine_stage("serve_decode_chunk")
    return 1e3 * s["device_s"] / steps if steps and s["count"] else None
