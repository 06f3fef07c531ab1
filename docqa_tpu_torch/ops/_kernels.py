"""Build, load and count the port's hand-written CUDA kernels.

Each ``docqa_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, under
``build/torch_kernels/`` at the repository root, at first use.  The file
name carries a hash of the source, of every ``csrc/*.cuh`` header it may
include, and of the full flag list, so an edited source, header or flag
builds anew.  Libraries are loaded with ``ctypes``; the wrapper that binds a
function sets its ``argtypes``.  Nothing here runs at import time: the CPU
tests import every module on a host without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name.  A wrapper adds one
(:func:`count`) where it launches its kernel and nowhere else, so a run can
show that its path really went through the kernels.  The count takes a
lock: the batcher's worker and request threads launch concurrently.

A kernel that fails to build, load or launch raises :class:`KernelError`.
:func:`is_device_fault` names it, and the CUDA errors torch raises on the
card, as the faults no serving policy may hide: the degraded answer, the
breakers and the replica pool's failover all let them through to the
caller (after a CUDA error the context is poisoned, so failing over inside
the process would serve nothing).  A collective that fails or times out on
a mesh (:class:`MeshFault`, raised by ``runtime/mesh.py``) is one too: a
rank is gone, and no rank may go on alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_attention", "qmatmul")  # K1, K4
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / spills in the build log
)

LAUNCHES: Counter = Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


class MeshFault(RuntimeError):
    """A collective or a published command failed or timed out: a rank of
    the mesh is gone or unreachable, and the mesh is broken for good."""


def is_device_fault(exc: BaseException) -> bool:
    """True for a :class:`KernelError`, a :class:`MeshFault` and a CUDA
    error raised by torch (``torch.AcceleratorError``, or a
    ``RuntimeError`` whose message starts with "CUDA error"): errors that
    reach the caller unchanged."""
    if isinstance(exc, (KernelError, MeshFault)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


def count(*names: str) -> None:
    """Add one launch under each of ``names``."""
    with _COUNT_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels cannot be built"
        )
    return path


def library_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    """Where the library of ``<csrc_dir>/<name>.cu`` lives: its name hashes
    the source, every header beside it (by name and content) and the
    flags."""
    h = hashlib.sha1((csrc_dir / f"{name}.cu").read_bytes())
    for header in sorted(csrc_dir.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together.  Returns the compiler log of each
    source it built; raises if any build fails (after waiting for all)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise KernelError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    The lock serialises the build: two replicas warming at once build it
    once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path.name}: {e}") from e
            _LIBS[name] = lib
        return lib
