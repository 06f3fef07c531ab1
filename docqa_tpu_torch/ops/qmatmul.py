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

``LAUNCHES`` (``ops/_kernels``) counts one launch under ``qmatmul``, one
under ``qmatmul.int8`` or ``qmatmul.int4``, and one under the kernel mode
that ran (``qmatmul.ring``, ``qmatmul.wgmma`` or ``qmatmul.simple``, see
:func:`plan_qmatmul`) where the wrapper launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from docqa_tpu_torch.ops import _kernels

TILE_N = 128     # output columns a block (one TMA box of weight bytes)
STAGE_K = 64     # contraction rows a stage of the simple and wgmma modes
RING_K = {"int8": 64, "int4": 128}  # and of the ring mode (64 weight byte rows)
RING_ROWS = 64   # m at or below which the ring mode runs; above it, wgmma
WGMMA_ROWS = 128  # x rows a wgmma unit (256 at large m); its columns 128
SIMPLE_SPLITS = 32  # the simple mode's most K splits
H100_SMS = 132
KERNELS = ("simple", "ring", "wgmma")  # the C entry's kernel codes, in order


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
    kernel: str           # "ring" (m <= 64), "wgmma" (m > 64) or "simple"
    k: int                # contraction length the kernel walks (int4: padded)
    group: int            # int4 group size on that axis (even); 0 for int8
    splits: int           # K splits; 1 writes bf16 directly
    tiles: int            # K tiles of the kernel's stage
    tiles_per_split: int  # of those, a split
    grid: int             # blocks launched
    rows: int             # x rows a block (a wgmma unit: 128 or 256)


def tma_ok(mode: str, k: int, out: int, group: int) -> bool:
    """Whether a store's shapes meet the TMA modes' rules: weight and x rows
    16-byte multiples (``out % 16``, ``k % 8``), and an int4 group constant
    across a ring stage (128 rows)."""
    return out % 16 == 0 and k % 8 == 0 and (mode == "int8" or group % 128 == 0)


@functools.lru_cache(maxsize=4096)
def plan_qmatmul(mode: str, m: int, in_dim: int, out: int, group: int = 0,
                 num_sms: int = H100_SMS, tma: bool = True) -> QPlan:
    """The launch from static shapes alone (``tma=False``: the store's
    pointers refuse TMA, so the simple mode).  ``m <= 64`` takes the ring,
    bound by bytes, its K split until the column blocks fill the card (the
    rule below was read off a sweep of split counts on the card).  Past 64
    rows wgmma, bound by operations: one persistent block an SM over units
    of 128 columns by 256 rows of x (128 where 256 would leave SMs idle),
    K split only when the units cannot fill the card.  The simple mode
    keeps the first K4's rule (about eight blocks an SM), with at most
    ``SIMPLE_SPLITS`` splits.  Every split count is capped where the
    float32 partials (written and read once each) would pass the weight
    bytes.  Cached: a decode step asks for the
    same few shapes 225 times (Mistral-7B), and the host's time a launch is
    the step's bound."""
    if mode == "int4":
        gp = group + (group % 2)  # odd groups are padded to even
        k = (in_dim // group) * gp
        w_bytes = k * out // 2
    else:
        gp, k, w_bytes = 0, in_dim, in_dim * out
    cap = max(1, w_bytes // (8 * max(m, 1) * out))
    cols = math.ceil(out / TILE_N)  # column blocks
    rows = 16 if m <= 16 else 32 if m <= 32 else 64 if m <= 64 else WGMMA_ROWS
    if not (tma and tma_ok(mode, k, out, gp)):
        # at most 32 splits: the last block of a tile sums them alone
        kernel, stage = "simple", STAGE_K
        blocks = math.ceil(m / rows) * cols
        want = min(math.ceil(8 * num_sms / blocks), SIMPLE_SPLITS)
    elif m <= RING_ROWS:
        # a power of two (splits of equal length), about two blocks an SM at
        # m <= 16 and one above, at most max(8, 256 / m) (the last block of
        # a tile sums splits x m rows of partials) and every split a ring of
        # tiles
        kernel, stage, blocks = "ring", RING_K[mode], cols
        want = min((2 if m <= 16 else 1) * num_sms // blocks, max(8, 256 // max(m, 1)),
                   math.ceil(k / stage) // 4)
        want = 1 << (max(want, 1).bit_length() - 1)
    else:
        # 256-row units where they fill the card, else 128
        kernel, stage = "wgmma", STAGE_K
        if math.ceil(m / (2 * WGMMA_ROWS)) * cols >= num_sms:
            rows = 2 * WGMMA_ROWS
        blocks = math.ceil(m / rows) * cols
        want = num_sms // blocks
    tiles = math.ceil(k / stage)
    splits = max(1, min(tiles, want, cap))
    per = max(1, math.ceil(tiles / splits))
    splits = max(1, math.ceil(tiles / per))
    grid = blocks * splits
    if kernel == "wgmma":
        grid = min(grid, num_sms)
    return QPlan(mode, kernel, k, gp, splits, tiles, per, grid, rows)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _qmatmul_fn():
    fn = _kernels.load("qmatmul").docqa_qmatmul
    fn.argtypes = (
        [ctypes.c_void_p] * 5  # launch, x, out, part, counters
        + [ctypes.c_longlong]  # ldx
        + [ctypes.c_int] * 2  # m, vec
        + [ctypes.c_void_p]  # stream
    )
    fn.restype = ctypes.c_int
    return fn


class _Launch(ctypes.Structure):
    """A leaf's launch at one row count, as ``csrc/qmatmul.cu``'s
    ``QLaunch``: what does not change from one product to the next, so a
    product passes one pointer for it."""

    _fields_ = [("w", ctypes.c_void_p), ("wmap", ctypes.c_void_p),
                ("scale", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in ("K", "N", "int4", "gs", "kernel", "splits",
                                          "tiles", "tiles_per_split", "grid", "rows")]


@functools.lru_cache(maxsize=None)
def _weight_map_fn():
    fn = _kernels.load("qmatmul").docqa_qmatmul_weight_map
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


class _Store:
    """A quantised leaf as K4 reads it, validated at its first product on
    the card and kept on the weight tensor (attribute ``_STORE``): a leaf's
    layout is fixed once it is quantised, so a product checks only x (and
    that the store is this weight's and scale's, not a copy's).  Where the
    TMA modes can read the leaf, its tensor map is encoded here, once."""

    __slots__ = ("scale", "in_dim", "out", "mode", "group", "device", "w_ptr",
                 "s_ptr", "w_vec", "tma", "wmap", "wmap_ptr", "sms", "plans")

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
        self.plans = {}
        k = plan_qmatmul(self.mode, 1, in_dim, self.out, self.group, self.sms).k
        self.w_vec = self.w_ptr % 16 == 0 and self.out % 16 == 0 and k % 8 == 0
        self.tma = (self.w_vec and self.s_ptr % 16 == 0
                    and tma_ok(self.mode, k, self.out, self.group + self.group % 2))
        self.wmap = self.wmap_ptr = None
        if self.tma:
            self.wmap = ctypes.create_string_buffer(128)  # a CUtensorMap
            self.wmap_ptr = ctypes.addressof(self.wmap)
            rows = k // 2 if self.mode == "int4" else k
            rc = _weight_map_fn()(self.wmap_ptr, self.w_ptr, rows, self.out,
                                  int(self.mode == "int4"))
            if rc != 0:
                raise _kernels.KernelError(
                    f"qmatmul {self.mode}: encoding the weight's tensor map failed: "
                    f"CUDA error {rc}"
                )
            _event("tensor_maps")

    def __reduce__(self):
        # a copy or a pickle of the weight is another leaf, whose first
        # product validates it anew; the launches hold raw pointers
        return (_no_store, ())

    def plan(self, m: int) -> QPlan:
        return self.launch(m)[0]

    def launch(self, m: int):
        """``(plan, address of its _Launch, counter names, the _Launch)``
        at ``m`` rows, built at the first product of that size (the entry
        keeps the structure alive)."""
        entry = self.plans.get(m)
        if entry is None:
            plan = plan_qmatmul(self.mode, m, self.in_dim, self.out, self.group, self.sms,
                                self.tma)
            launch = _Launch(self.w_ptr, self.wmap_ptr, self.s_ptr, plan.k, self.out,
                             int(self.mode == "int4"), plan.group,
                             KERNELS.index(plan.kernel), plan.splits, plan.tiles,
                             plan.tiles_per_split, plan.grid, plan.rows)
            names = ("qmatmul", f"qmatmul.{self.mode}", f"qmatmul.{plan.kernel}")
            entry = self.plans[m] = (plan, ctypes.addressof(launch), names, launch)
            _event("leaf_plans")
        return entry


def _no_store():
    return None


_STORE = "_qmatmul_store"

# what the kernel's host state has built, for the compile audit's steady
# state (analysis/compile_audit.py): leaf plans made, weight tensor maps
# encoded, scratch buffers (re)allocated.  A repeated round adds none.
CACHE_EVENTS: Counter = Counter()
_EVENTS_LOCK = threading.Lock()


def _event(name: str) -> None:
    with _EVENTS_LOCK:
        CACHE_EVENTS[name] += 1


# float32 split-K partials and the tiles' zeroed counters, one pair per
# thread and (device, stream), grown to the largest product served: a
# product's last block of each tile re-zeroes its counter, and the products
# of one thread on one stream run in order
_SCRATCH = threading.local()


def _scratch(parts: int, tiles: int, device: int, stream: int):
    bufs = _SCRATCH.__dict__
    key = (device, stream)
    part, counters = bufs.get(key, (None, None))
    dev = torch.device("cuda", device)
    if part is None or part.numel() < parts:
        part = torch.empty(parts, dtype=torch.float32, device=dev)
        _event("scratch")
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
        _event("scratch")
    bufs[key] = (part, counters)
    return part.data_ptr(), counters.data_ptr()


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
    out = x2.new_empty((m, st.out))
    if m == 0:
        return out.reshape(*lead, st.out)
    plan, launch, names, _ = st.launch(m)
    if x2.stride(-1) != 1 or (plan.kernel != "simple" and (
            x2.stride(0) % 8 or x2.stride(0) < x2.shape[1] or x2.data_ptr() % 16)):
        # a fresh allocation: the TMA modes read disjoint 16-byte-aligned rows
        x2 = torch.empty_like(x2, memory_format=torch.contiguous_format).copy_(x2)
    # the current stream's handle, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(device)
    part = counters = None
    if plan.splits > 1:
        part, counters = _scratch(plan.splits * m * st.out,
                                  math.ceil(m / 16) * math.ceil(st.out / TILE_N), device,
                                  stream)
    ldx, x_ptr = x2.stride(0), x2.data_ptr()
    vec = int(st.w_vec and x_ptr % 16 == 0 and ldx % 8 == 0)
    rc = _qmatmul_fn()(launch, x_ptr, out.data_ptr(), part, counters, ldx, m, vec, stream)
    if rc != 0:
        raise _kernels.KernelError(
            f"qmatmul {st.mode} {plan.kernel} kernel launch failed: CUDA error {rc}"
        )
    _kernels.count(*names)
    return out.reshape(*lead, st.out)
