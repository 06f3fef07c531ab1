"""Seconds from the process's start to its first ask: imports, inputs,
weights, store, pool, warm-up (a closed loop's ramp, which fills the loop
before the window opens, is traffic and not set-up)."""


def read(run):
    return run.setup_s
