"""The stream the batcher's device work runs on, reduced from
``docqa_tpu/engines/spine.py``.

The reference runs every device dispatch as a work item on a few owned
lane threads, to bound the threads inside JAX dispatch.  Here a
:class:`Lane` is one device and ONE CUDA stream, and the batcher runs its
device work on the calling thread inside ``with lane.active():``.

Why one stream is enough for correctness: the reference orders device
work through donated buffers — an overshoot decode chunk's stale K/V
writes land before the prefill that reuses those blocks.  The port writes
its pools in place, and a single stream runs kernels in issue order, so
the same ordering holds without events.  Entering the lane first makes
its stream wait for the calling thread's current stream, so tensors that
thread produced (weights, inputs) are ready before the lane reads them.

Not in this port yet: the work-item API (``spine_run``/``spine_submit``,
stage names), lane threads and queue bounds, per-stage telemetry and cost
accounting, ``reconfigure``.  They come back with the obs slice (ROADMAP
queue 1), when lane threads or telemetry give them something to do.
"""

from __future__ import annotations

import contextlib

import torch


class Lane:
    """A device and the one CUDA stream (None on the CPU) its work runs on."""

    def __init__(self, device) -> None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = (
            torch.cuda.Stream(device=self.device)
            if self.device.type == "cuda" else None
        )

    @contextlib.contextmanager
    def active(self):
        """Run the enclosed work in inference mode on this lane's stream,
        after everything the calling thread's current stream has issued so
        far."""
        with torch.inference_mode():
            if self.stream is None:
                yield
                return
            with torch.cuda.device(self.device):
                caller = torch.cuda.current_stream(self.device)
                if caller != self.stream:
                    self.stream.wait_stream(caller)
                with torch.cuda.stream(self.stream):
                    yield
