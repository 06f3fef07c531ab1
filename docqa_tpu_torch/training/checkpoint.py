"""Checkpoint / resume for a training state, counterpart of
``docqa_tpu/training/checkpoint.py`` (whose format is Orbax's; this one is
the port's own).

A state is ``{"params": {name: tensor}, "opt_state": ChainState, "step":
int}`` (``training/train.py``, ``training/encoder.py``).  Each save is one
directory per step, ``<directory>/<step>/state.pt``: the params on the
host, the optimizer's ``state_dict`` (AdamW moments and update count) and
the step, written under a temporary name and then ``os.replace``d, so a
crash mid-write leaves no directory that :meth:`latest_step` would name.
The newest ``max_to_keep`` steps are kept.  Files are read with
``torch.load(weights_only=True)``: tensors and plain containers only.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, List, Optional

import torch

from docqa_tpu_torch.runtime.metrics import get_logger

log = get_logger("docqa.checkpoint")

_FILE = "state.pt"


def _to_host(obj):
    """A copy of ``obj`` with every tensor cloned to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class TrainCheckpointer:
    """Saves and restores training states under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---- API -----------------------------------------------------------------

    def save(self, state: Any, step: Optional[int] = None, wait: bool = True) -> int:
        """Persist the full state; returns the step it was saved as.  The
        host copy is taken before this returns; with ``wait=False`` the
        files are written on a background thread, which the next call
        (or :meth:`close`) waits for."""
        self.wait_until_finished()
        if step is None:
            step = int(state["step"])
        payload = _to_host({
            "params": dict(state["params"]),
            "opt_state": state["opt_state"].state_dict(),
            "step": int(state["step"]),
        })
        if wait:
            self._write(step, payload)
        else:
            self._writer = threading.Thread(
                target=self._write_catching, args=(step, payload),
                name="train-checkpoint", daemon=True,
            )
            self._writer.start()
        return step

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into ``template`` (an initialized state, e.g. from
        ``init_train_state``): its params are overwritten in place on their
        own device and dtype, its optimizer state loaded (PyTorch places
        the moments beside their params) and its step set.  Returns the
        template.  Raises ``FileNotFoundError`` when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        path = os.path.join(self.directory, str(step), _FILE)
        if step is None or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        params = template["params"]
        if set(saved["params"]) != set(params):
            raise ValueError(
                f"checkpoint at step {step} holds other params than the template"
            )
        with torch.no_grad():
            for name, value in saved["params"].items():
                params[name].copy_(value)
        template["opt_state"].load_state_dict(saved["opt_state"])
        template["step"] = int(saved["step"])
        log.info("checkpoint restored from step %d", step)
        return template

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait_until_finished()

    # ---- internals -------------------------------------------------------------

    def _steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit()
            and os.path.exists(os.path.join(self.directory, name, _FILE))
        )

    def _write(self, step: int, payload: dict) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        log.info("checkpoint saved at step %d -> %s", step, self.directory)

    def _write_catching(self, step: int, payload: dict) -> None:
        try:
            self._write(step, payload)
        except Exception as e:  # re-raised by the next call
            self._error = e
