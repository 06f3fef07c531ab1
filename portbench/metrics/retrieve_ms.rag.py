"""Device milliseconds of one retrieval (the spine's ``retrieve`` stage:
the encoder forward and the exact top-k over the store), its device
seconds over its items in the window."""


def read(run):
    s = run.spine_stage("retrieve")
    return 1e3 * s["device_s"] / s["count"] if s["count"] else None
