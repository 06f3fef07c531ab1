"""The port's own safetensors reader (the card's machine has no
``safetensors`` package).

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus an
optional ``"__metadata__"`` map of strings), then the raw little-endian
tensor bytes, offsets relative to the end of the header.

:func:`load_file` maps the file copy-on-write and returns CPU tensors that
view the mapping (``torch.frombuffer``): nothing is read until a tensor is
used, and a write to a tensor never reaches the file.  BF16 is read as
``torch.bfloat16`` directly (numpy has no bf16; the bytes are the same).
A header that lies — an unknown dtype, offsets out of range, overlapping
or leaving holes, a shape whose byte count differs from its span — raises
``ValueError`` before any tensor is made.

"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
MAX_HEADER = 100 * 1024 * 1024


def read_header(path: str) -> Tuple[Dict[str, dict], int, int]:
    """(entries, data_start, data_len) of a safetensors file, every entry
    checked against the file's size; ``"__metadata__"`` is dropped."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER or 8 + n > size:
            raise ValueError(f"{path}: header length {n} exceeds the file ({size} bytes)")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    meta = header.pop("__metadata__", None)
    if meta is not None and not (
        isinstance(meta, dict) and all(isinstance(v, str) for v in meta.values())
    ):
        raise ValueError(f"{path}: __metadata__ must map names to strings")
    data_start, data_len = 8 + n, size - 8 - n
    spans = []
    for name, info in header.items():
        if not isinstance(info, dict):
            raise ValueError(f"{path}: entry {name!r} is not an object")
        dtype = DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: {name!r} has unknown dtype {info.get('dtype')!r}")
        shape, offsets = info.get("shape"), info.get("data_offsets")
        if not (isinstance(shape, list)
                and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: {name!r} has a bad shape {shape!r}")
        if not (isinstance(offsets, list) and len(offsets) == 2
                and all(isinstance(o, int) for o in offsets)):
            raise ValueError(f"{path}: {name!r} has bad data_offsets {offsets!r}")
        begin, end = offsets
        if not 0 <= begin <= end <= data_len:
            raise ValueError(
                f"{path}: {name!r} spans [{begin}, {end}) outside the "
                f"{data_len}-byte data section"
            )
        want = math.prod(shape) * _itemsize(dtype)
        if end - begin != want:
            raise ValueError(
                f"{path}: {name!r} of shape {shape} {info['dtype']} needs "
                f"{want} bytes, its offsets hold {end - begin}"
            )
        spans.append((begin, end, name))
    pos = 0
    for begin, end, name in sorted(spans):
        if begin != pos:
            raise ValueError(
                f"{path}: {name!r} starts at {begin}, expected {pos} "
                "(tensors overlap or leave a hole)"
            )
        pos = end
    if pos != data_len:
        raise ValueError(f"{path}: {data_len - pos} bytes after the last tensor")
    return header, data_start, data_len


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor over a copy-on-write mapping of ``path``."""
    header, data_start, data_len = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    if not header:
        return out
    buf = None
    if data_len:
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        shape = info["shape"]
        begin, end = info["data_offsets"]
        count = end - begin
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        off = data_start + begin
        if off % _itemsize(dtype):
            # an unaligned span (no standard writer makes one): copy it out
            t = torch.frombuffer(bytearray(buf[off : off + count]), dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=count // _itemsize(dtype),
                                 offset=off)
        out[name] = t.reshape(shape)
    return out

