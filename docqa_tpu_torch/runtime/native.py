"""The DNS1 snapshot codec: a ctypes binding to the repository's C++ host
library (``native/docqa_native.cpp``) and a pure-Python codec of the same
format.  Counterpart of ``docqa_tpu/runtime/native.py``.

A DNS1 shard is a 64-byte header (``<4sIIIQQI28x``: magic ``DNS1``, header
size, dtype 0 = float32 / 1 = bf16, dim, count, payload bytes, the
payload's crc32) and the row-major payload.  The store's snapshots write
their vectors as one shard.

The library is compiled by ``g++`` from the repository's source into
``build/torch_kernels/`` at first use (never into ``native/``); its file
name hashes the source, the flags, the compiler's version and the C
library's, so a library built on another host is rebuilt rather than
loaded.  A host without ``g++`` (or whose build fails) takes the Python
codec: both read and write the same bytes, so a snapshot written on one
host restores on the other.  Each read and write logs which codec ran and
counts it in :data:`RUNS` (``("write"|"read", "native"|"python")``).

bf16 goes through ``torch`` (round to nearest even), as the C++ codec
rounds.

API:
  load()                          -> _NativeLib or None
  write_vectors(path, arr, bf16)  -> path + ".dns"
  read_vectors(path)              -> np.ndarray [count, dim] float32
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import threading
import zlib
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from docqa_tpu_torch.runtime.metrics import get_logger

log = get_logger("docqa.native")

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "docqa_native.cpp"
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror")

_DTYPE_F32, _DTYPE_BF16 = 0, 1
_ERRORS = {
    -1: "io error",
    -2: "bad header",
    -3: "size mismatch",
    -4: "crc mismatch",
    -5: "bad arguments",
}
_HEADER = struct.Struct("<4sIIIQQI28x")  # magic, hsize, dtype, dim, count, bytes, crc
assert _HEADER.size == 64

# (operation, codec) -> calls; read it to know which codec served
RUNS: Counter = Counter()

_lock = threading.Lock()
_cached: Optional["_NativeLib"] = None
_load_failed = False


class ShardError(RuntimeError):
    pass


def _count(op: str, codec: str, path: str) -> None:
    with _lock:
        RUNS[(op, codec)] += 1
    log.info("%s %s with the %s codec", op, path, codec)


class _NativeLib:
    def __init__(self, path: str) -> None:
        lib = ctypes.CDLL(path)
        lib.dn_shard_write.restype = ctypes.c_int
        lib.dn_shard_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.dn_shard_info.restype = ctypes.c_int
        lib.dn_shard_info.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.dn_shard_read.restype = ctypes.c_int
        lib.dn_shard_read.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
        ]
        for name in ("dn_f32_to_bf16", "dn_bf16_to_f32"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        self._lib = lib

    def write_shard(self, path: str, arr: np.ndarray, bf16: bool = False) -> None:
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.ndim != 2:
            raise ValueError("expected [count, dim] array")
        count, dim = arr.shape
        if bf16:
            out = np.empty(arr.size, np.uint16)
            self._lib.dn_f32_to_bf16(
                arr.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p), arr.size,
            )
            data, dtype = out, _DTYPE_BF16
        else:
            data, dtype = arr, _DTYPE_F32
        rc = self._lib.dn_shard_write(
            path.encode(), data.ctypes.data_as(ctypes.c_void_p), count, dim, dtype
        )
        if rc != 0:
            raise ShardError(f"shard write failed: {_ERRORS.get(rc, rc)}")

    def read_shard(self, path: str) -> np.ndarray:
        """The shard's rows as float32, its crc verified."""
        dtype, dim = ctypes.c_uint32(), ctypes.c_uint32()
        count, nbytes = ctypes.c_uint64(), ctypes.c_uint64()
        rc = self._lib.dn_shard_info(
            path.encode(), ctypes.byref(dtype), ctypes.byref(dim),
            ctypes.byref(count), ctypes.byref(nbytes),
        )
        if rc != 0:
            raise ShardError(f"shard info failed: {_ERRORS.get(rc, rc)}")
        bf16 = dtype.value == _DTYPE_BF16
        raw = np.empty(
            nbytes.value // (2 if bf16 else 4), np.uint16 if bf16 else np.float32
        )
        rc = self._lib.dn_shard_read(
            path.encode(), raw.ctypes.data_as(ctypes.c_void_p), nbytes.value, 1
        )
        if rc != 0:
            raise ShardError(f"shard read failed: {_ERRORS.get(rc, rc)}")
        if bf16:
            out = np.empty(raw.size, np.float32)
            self._lib.dn_bf16_to_f32(
                raw.ctypes.data_as(ctypes.c_void_p),
                out.ctypes.data_as(ctypes.c_void_p), raw.size,
            )
        else:
            out = raw
        return out.reshape(count.value, dim.value)


def library_path(gxx: str) -> Path:
    """Where the library lives: its name hashes the source, the flags, the
    compiler's version and the C library's."""
    version = subprocess.run(
        [gxx, "--version"], capture_output=True, text=True, timeout=60, check=True
    ).stdout
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    h.update(version.encode() + "\0".join(platform.libc_ver()).encode())
    return BUILD_DIR / f"libdocqa_native-{h.hexdigest()[:12]}.so"


def build() -> str:
    """Compile the library if its file is missing; returns its path.
    Raises when ``g++`` is absent or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    out = library_path(gxx)
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run(
        [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return str(out)


def load() -> Optional[_NativeLib]:
    """The native library, built on first use; None when it cannot be
    built or loaded (the Python codec then serves)."""
    global _cached, _load_failed
    with _lock:
        if _cached is not None or _load_failed:
            return _cached
        try:
            _cached = _NativeLib(build())
        except (OSError, subprocess.SubprocessError) as e:
            log.warning("native codec unavailable (%s); using the Python codec", e)
            _load_failed = True
        return _cached


# ---- the pure-Python codec (same bytes) ------------------------------------

def _to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    return torch.from_numpy(arr).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return t.float().numpy()


def _py_write_shard(path: str, arr: np.ndarray, bf16: bool = False) -> None:
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim != 2:
        raise ValueError("expected [count, dim] array")
    count, dim = arr.shape
    if bf16:
        payload = _to_bf16_bits(arr).tobytes()
        dtype = _DTYPE_BF16
    else:
        payload = arr.tobytes()
        dtype = _DTYPE_F32
    header = _HEADER.pack(
        b"DNS1", 64, dtype, dim, count, len(payload),
        zlib.crc32(payload) & 0xFFFFFFFF,
    )
    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def _py_read_shard(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 64:
        raise ShardError("bad header")
    magic, hsize, dtype, dim, count, nbytes, crc = _HEADER.unpack_from(raw)
    if magic != b"DNS1" or hsize != 64 or dtype > 1 or dim == 0:
        raise ShardError("bad header")
    payload = raw[64:]
    if len(payload) != nbytes or nbytes != count * dim * (2 if dtype else 4):
        raise ShardError("size mismatch")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ShardError("crc mismatch")
    if dtype == _DTYPE_BF16:
        return _from_bf16_bits(np.frombuffer(payload, np.uint16)).reshape(count, dim)
    return np.frombuffer(payload, np.float32).reshape(count, dim).copy()


# ---- front door: one on-disk format, the native codec when it loads ---------

def write_vectors(path: str, arr: np.ndarray, bf16: bool = False) -> str:
    """Write vectors as a checksummed DNS1 shard; returns the path written."""
    p = path + ".dns"
    lib = load()
    if lib is not None:
        lib.write_shard(p, arr, bf16=bf16)
    else:
        _py_write_shard(p, arr, bf16=bf16)
    _count("write", "native" if lib is not None else "python", p)
    return p


def read_vectors(path: str) -> np.ndarray:
    """Read a DNS1 shard (crc verified), or a ``.npy`` of an older
    snapshot."""
    if not path.endswith(".dns"):
        return np.load(path)
    lib = load()
    out = lib.read_shard(path) if lib is not None else _py_read_shard(path)
    _count("read", "native" if lib is not None else "python", path)
    return out
