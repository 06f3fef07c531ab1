"""K4, the weight-only quantised matmul: the plain PyTorch version and the
Hopper kernel's wrapper.

The reference's ``_qmatmul`` (``docqa_tpu/models/decoder.py``) is XLA: it
dequantises ``q.astype(dtype) * scale.astype(dtype)`` inside the dot's
operand read, so the bf16 tree never reaches HBM.  :func:`qmatmul` on a
CUDA tensor launches ``csrc/qmatmul.cu``, which does the same from shared
memory; on a CPU tensor it runs :func:`qmatmul_reference`, the plain
version the kernel is held against (dequantise into a temporary, then
``x @ W~``).

Stores, as ``models/quant.py`` writes them:

* **int8** (``quant_bits=8``, and ``lm_head`` in both modes): ``q`` int8
  ``[in, out]``, ``scale`` float32 ``[out]`` (per-column absmax / 127).
* **int4** (``quant_bits=4``): torch has no usable int4 tensor, so ``q`` is
  **packed** two values a byte along the contraction axis, uint8
  ``[groups, ceil(g / 2), out]``: byte ``[G, j, n]`` holds row ``2j`` of
  group ``G`` in its low nibble and row ``2j + 1`` in its high nibble, each
  a two's-complement 4-bit value in [-7, 7]; an odd ``g`` leaves the last
  high nibble of each group 0.  ``scale`` float32 ``[groups, out]``.  The
  reference stores ``int4 [groups, g, out]``; :func:`pack_int4` /
  :func:`unpack_int4` convert.  The group size is ``in / groups``, read
  from x's last axis.  Adjacent rows in one byte are the pairs an
  ``mma.sync`` B fragment holds.

Dequantisation rounds as the reference's does in the compute dtype:
``W~ = dtype(dtype(q) * dtype(scale))``.

``LAUNCHES`` (``ops/_kernels``) counts one launch under ``qmatmul`` and one
under ``qmatmul.int8`` or ``qmatmul.int4`` where the wrapper launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from docqa_tpu_torch.ops import _kernels

TILE_K = 64      # contraction rows a kernel tile
TILE_N = 128     # output columns a block
H100_SMS = 132


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values ``[groups, g, out]`` (any integer dtype, in [-8, 7]) ->
    the packed uint8 store ``[groups, ceil(g / 2), out]``."""
    q = q.to(torch.int16)
    if q.shape[1] % 2:
        q = F.pad(q, (0, 0, 0, 1))
    lo = q[:, 0::2] & 0xF
    hi = q[:, 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, g: int) -> torch.Tensor:
    """The packed store ``[groups, ceil(g / 2), out]`` -> int8
    ``[groups, g, out]``."""
    b = packed.to(torch.int16)
    lo = (b & 0xF) - ((b & 0x8) << 1)
    hi = (b >> 4) - ((b & 0x80) >> 3)
    out = torch.stack((lo, hi), dim=2).reshape(b.shape[0], 2 * b.shape[1], b.shape[2])
    return out[:, :g].to(torch.int8)


def int4_group(packed: torch.Tensor, in_dim: int) -> int:
    """The group size of a packed store for a contraction of ``in_dim``."""
    groups = packed.shape[0]
    if groups == 0 or in_dim % groups or packed.shape[1] != -(-(in_dim // groups) // 2):
        raise ValueError(
            f"packed int4 store {tuple(packed.shape)} does not fit in_dim {in_dim}"
        )
    return in_dim // groups


def dequantize(w: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
               in_dim: int) -> torch.Tensor:
    """``W~ [in, out]`` in ``dtype``, rounded as the reference rounds it."""
    if w.dtype == torch.int8:
        return w.to(dtype) * scale.to(dtype)[None, :]
    g = int4_group(w, in_dim)
    q = unpack_int4(w, g)
    return (q.to(dtype) * scale.to(dtype)[:, None, :]).reshape(in_dim, -1)


def qmatmul_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """Plain version: ``x [..., in] @ dequantize(w, scale)`` in ``dtype``
    (default x's)."""
    dtype = dtype or x.dtype
    return x.to(dtype) @ dequantize(w, scale, dtype, x.shape[-1])


class QPlan(NamedTuple):
    mode: str             # "int8" or "int4"
    k: int                # contraction length the kernel walks (int4: padded)
    group: int            # int4 group size on that axis (even); 0 for int8
    splits: int           # K splits (grid.z); 1 writes bf16 directly
    tiles_per_split: int  # TILE_K-row tiles a split


@functools.lru_cache(maxsize=4096)
def plan_qmatmul(mode: str, m: int, in_dim: int, out: int, group: int = 0,
                 num_sms: int = H100_SMS) -> QPlan:
    """The launch shape from static shapes alone.  The K axis is split
    until about eight blocks an SM are in flight (a block keeps one tile of
    loads in flight, so the bytes in flight grow with the blocks), but never
    so far that the float32 partials (written and read once each) pass the
    weight bytes.  Cached: a decode step asks for the same few shapes 225
    times (Mistral-7B), and the host's time a launch is the step's bound."""
    if mode == "int4":
        gp = group + (group % 2)  # odd groups are padded to even
        k = (in_dim // group) * gp
        w_bytes = k * out // 2
    else:
        gp, k, w_bytes = 0, in_dim, in_dim * out
    bm = 16 if m <= 16 else 32 if m <= 32 else 64 if m <= 64 else 128
    blocks = math.ceil(m / bm) * math.ceil(out / TILE_N)
    tiles = math.ceil(k / TILE_K)
    want = math.ceil(8 * num_sms / blocks)
    cap = max(1, w_bytes // (8 * m * out))
    splits = max(1, min(tiles, want, cap))
    per = math.ceil(tiles / splits)
    return QPlan(mode, k, gp, math.ceil(tiles / per), per)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _qmatmul_fn():
    fn = _kernels.load("qmatmul").docqa_qmatmul
    fn.argtypes = (
        [ctypes.c_void_p] * 5  # x, w, scale, out, part
        + [ctypes.c_longlong]  # ldx
        + [ctypes.c_int] * 8  # m, K, N, int4, group, splits, tiles_per_split, vec
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    return fn


class _Store:
    """A quantised leaf as K4 reads it, validated at its first product on
    the card and kept on the weight tensor (attribute ``_STORE``): a leaf's
    layout is fixed once it is quantised, so a product checks only x (and
    that the store is this weight's and scale's, not a copy's)."""

    __slots__ = ("scale", "in_dim", "out", "mode", "group", "device", "w_ptr",
                 "s_ptr", "w_vec", "sms", "names", "plans")

    def __init__(self, w: torch.Tensor, scale: torch.Tensor, in_dim: int, device: int):
        for name, t in (("w", w), ("scale", scale)):
            if t.device.type != "cuda" or t.get_device() != device:
                raise ValueError(f"{name} is on {t.device}, x on cuda:{device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if scale.dtype != torch.float32:
            raise ValueError(f"scale must be float32, got {scale.dtype}")
        if w.dtype == torch.int8 and w.dim() == 2:
            if w.shape[0] != in_dim or scale.shape != (w.shape[1],):
                raise ValueError(
                    f"int8 store {tuple(w.shape)} / scale {tuple(scale.shape)} does "
                    f"not fit in_dim {in_dim}"
                )
            self.mode, self.group = "int8", 0
        elif w.dtype == torch.uint8 and w.dim() == 3:
            self.mode, self.group = "int4", int4_group(w, in_dim)
            if scale.shape != (w.shape[0], w.shape[2]):
                raise ValueError(
                    f"int4 scale {tuple(scale.shape)} does not fit {tuple(w.shape)}"
                )
        else:
            raise ValueError(
                f"qmatmul takes an int8 [in, out] or packed int4 [groups, g/2, out] "
                f"store, got {w.dtype} {tuple(w.shape)}"
            )
        self.scale, self.in_dim, self.out, self.device = scale, in_dim, w.shape[-1], device
        self.w_ptr, self.s_ptr = w.data_ptr(), scale.data_ptr()
        self.sms = _num_sms(device)
        self.names = ("qmatmul", f"qmatmul.{self.mode}")
        self.plans = {}
        k = plan_qmatmul(self.mode, 1, in_dim, self.out, self.group, self.sms).k
        self.w_vec = self.w_ptr % 16 == 0 and self.out % 16 == 0 and k % 8 == 0

    def plan(self, m: int) -> QPlan:
        plan = self.plans.get(m)
        if plan is None:
            plan = self.plans[m] = plan_qmatmul(
                self.mode, m, self.in_dim, self.out, self.group, self.sms)
        return plan


_STORE = "_qmatmul_store"

# float32 split-K partials, one buffer per thread and (device, stream),
# grown to the largest product it has served: the kernel writes every
# partial a product reads before its reduce pass reads them, and the
# products of one thread on one stream run in order
_SCRATCH = threading.local()


def _partials(numel: int, device: int, stream: int) -> int:
    bufs = _SCRATCH.__dict__
    buf = bufs.get((device, stream))
    if buf is None or buf.numel() < numel:
        buf = bufs[(device, stream)] = torch.empty(
            numel, dtype=torch.float32, device=torch.device("cuda", device))
    return buf.data_ptr()


def qmatmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., in] @ W~`` for a quantised store (module docstring).  A CPU
    tensor takes :func:`qmatmul_reference`; a CUDA tensor launches K4 or
    raises (bf16 x only) — no fallback on the card.

    Forward-only, as the reference's trainers never take a quantised tree:
    an ``x`` that requires grad while grad mode is on raises on both
    devices, since on the card a ctypes launch would carry no ``grad_fn``
    and drop the gradient silently."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "qmatmul is forward-only and cannot be differentiated: quantised "
            "weights are for serving"
        )
    if not x.is_cuda:
        if x.device.type == "cpu":
            return qmatmul_reference(x, w, scale)
        raise ValueError(f"qmatmul runs on cuda or cpu, not {x.device}")
    if x.dtype is not torch.bfloat16:
        raise ValueError(f"qmatmul kernel takes bf16 activations, got {x.dtype}")
    in_dim, device = x.shape[-1], x.get_device()
    st = getattr(w, _STORE, None)
    if (st is None or st.scale is not scale or st.in_dim != in_dim
            or st.device != device or st.w_ptr != w.data_ptr()):
        st = _Store(w, scale, in_dim, device)
        setattr(w, _STORE, st)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_dim)
    m = x2.shape[0]
    if st.group % 2:
        # the kernel pairs rows within a group: a zero column of x meets the
        # packed store's zero high nibble at the end of each group
        x2 = F.pad(x2.reshape(m, -1, st.group), (0, 1)).reshape(m, -1)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = x2.new_empty((m, st.out))
    if m == 0:
        return out.reshape(*lead, st.out)
    plan = st.plan(m)
    # the current stream's handle, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(device)
    part = _partials(plan.splits * m * st.out, device, stream) if plan.splits > 1 else None
    ldx, x_ptr = x2.stride(0), x2.data_ptr()
    vec = int(st.w_vec and x_ptr % 16 == 0 and ldx % 8 == 0)
    rc = _qmatmul_fn()(
        x_ptr, st.w_ptr, st.s_ptr, out.data_ptr(), part, ldx, m, plan.k, st.out,
        int(st.mode == "int4"), plan.group, plan.splits, plan.tiles_per_split, vec,
        stream,
    )
    if rc != 0:
        raise _kernels.KernelError(
            f"qmatmul {st.mode} kernel launch failed: CUDA error {rc}"
        )
    _kernels.count(*st.names)
    return out.reshape(*lead, st.out)
