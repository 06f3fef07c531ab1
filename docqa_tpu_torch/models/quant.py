"""Int8 (w8a16) and grouped-int4 (w4a16) weight-only decoder quantisation,
counterpart of ``docqa_tpu/models/quant.py``.

Decode at batch sizes a server sees is bound by the bytes of weights read
a step: int8 halves them (Mistral-7B: 14.5 GB of bf16 -> 7.1 GB), int4
quarters them (~3.8 GB with its scales and the int8 ``lm_head``).

Schemes, for each 2-D weight ``w [in, out]``, as in the reference:

* **int8, per-output-channel absmax**: ``scale[out] = max |w| / 127``,
  ``q = clip(round(w / scale), -127, 127)``.
* **int4, grouped absmax** along ``in`` (group :data:`GROUP_SIZE` = 128, or
  the largest divisor of ``in`` below it): ``scale[in // g, out] = absmax
  over the group / 7``, ``q`` in [-7, 7].  The port stores ``q`` packed two
  a byte (``ops/qmatmul.py`` documents the layout); the reference's
  ``int4 [groups, g, out]`` converts with ``ops.qmatmul.pack_int4``.

Rounding is half-to-even (``torch.round``, as ``jnp.round`` and numpy).
``lm_head`` stays int8 in int4 mode; embeddings and norm gains are not
quantised.  Products go through :func:`docqa_tpu_torch.ops.qmatmul.qmatmul`
(K4 on a card), which dequantises inside the kernel.

Memory: :func:`quantize_decoder_params` and
:func:`init_quantized_decoder_params` work tensor by tensor, so the peak is
the quantised tree plus one float tensor (the reference's discipline).
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from docqa_tpu_torch.config import DecoderConfig
from docqa_tpu_torch.ops.qmatmul import pack_int4, qmatmul
from docqa_tpu_torch.utils import torch_dtype

Params = Dict[str, torch.Tensor]

_log = logging.getLogger(__name__)
_WARNED_DEGRADED_DIMS: set = set()

SCALE_SUFFIX = "__scale"

GROUP_SIZE = 128  # int4 grouping along the `in` axis (llama.cpp/AWQ size)

# 2-D matmul weights that quantise; everything else passes through
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# The reference's jitted quantisers divide the absmax by 127 (or 7), which
# XLA compiles to a multiply by the float32 reciprocal; the port multiplies
# by the same float32 value, so a supplied tree quantises to the same
# scales bit for bit.  Its host init divides in numpy, and ``divide=True``
# does the same (float32 division on the CPU rounds as numpy's does).
_INV = {127: float(np.float32(1.0) / np.float32(127.0)),
        7: float(np.float32(1.0) / np.float32(7.0))}


def _int4_group(in_dim: int, group: Optional[int] = None) -> int:
    """Largest usable group <= GROUP_SIZE that divides ``in_dim`` (tiny test
    configs have in_dim < 128)."""
    g = min(group or GROUP_SIZE, in_dim)
    while in_dim % g:
        g -= 1
    if g < 16 and in_dim >= 16 and in_dim not in _WARNED_DEGRADED_DIMS:
        # e.g. in_dim=298 degrades to g=2: the f32 scale tensor then costs
        # 2 bytes per 0.5-byte weight, so "int4" lands larger than int8
        # with only 15 levels.  Warn once per distinct in_dim.
        _WARNED_DEGRADED_DIMS.add(in_dim)
        _log.warning(
            "int4 group size degraded to %d for in_dim=%d (no divisor <= %d "
            ">= 16); scale overhead now exceeds int8 — prefer quant_bits=8 "
            "for this shape",
            g, in_dim, GROUP_SIZE,
        )
    return g


def probe_int4_support(device="cuda") -> Tuple[bool, str]:
    """``(True, "")`` once K4's int4 mode has run a toy product on
    ``device`` and agreed with its plain version.  The reference's probe
    guards a TPU client that could not lower int4; here a kernel that fails
    to build or launch, or a device fault, raises (it is never reported as
    ``(False, reason)``), and a wrong product raises ``AssertionError``."""
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((32, 16), generator=gen)
    q, scale = quantize_array_int4(w, group=16)
    x = torch.randn((4, 32), generator=gen).to(torch.bfloat16)
    q, scale, x = q.to(dev), scale.to(dev), x.to(dev)
    from docqa_tpu_torch.ops.qmatmul import qmatmul_reference

    got = qmatmul(x, q, scale).float().cpu()
    want = qmatmul_reference(x, q, scale).float().cpu()
    if not torch.allclose(got, want, atol=1e-2, rtol=1e-2):
        raise AssertionError(
            f"int4 probe: max |err| {float((got - want).abs().max()):.3e}"
        )
    return True, ""


def is_quantized(params: Mapping[str, object]) -> bool:
    return any(k.endswith(SCALE_SUFFIX) for k in params)


def should_quantize(name: str) -> bool:
    if name == "lm_head":
        return True
    return any(name.endswith(f"_{k}") for k in _QUANT_KEYS)


def _scale(absmax: torch.Tensor, levels: int, divide: bool) -> torch.Tensor:
    s = absmax / levels if divide else absmax * _INV[levels]
    return torch.clamp_min(s, 1e-12)


def quantize_array(w: torch.Tensor, divide: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] -> (int8 [in, out], float32 scale [out]) per-column
    absmax, on w's device."""
    w32 = w.float()
    scale = _scale(w32.abs().amax(dim=0), 127, divide)
    q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_array_int4(
    w: torch.Tensor, group: Optional[int] = None, divide: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] -> (packed uint8 [in // g, ceil(g / 2), out], float32
    scale [in // g, out]), grouped absmax along ``in``."""
    in_dim, out_dim = w.shape
    g = _int4_group(in_dim, group)
    w32 = w.float().reshape(in_dim // g, g, out_dim)
    scale = _scale(w32.abs().amax(dim=1), 7, divide)
    q = torch.clamp(torch.round(w32 / scale[:, None, :]), -7, 7)
    return pack_int4(q), scale


def leaf_bits(name: str, bits: int) -> int:
    """The bits a quantised leaf is stored at: ``lm_head`` stays int8 in
    int4 mode (its logit errors bite directly into token choice; ~3 % of a
    7B tree's bytes)."""
    return 8 if name == "lm_head" else bits


def quantized_bytes(name: str, in_dim: int, out_dim: int, bits: int) -> int:
    """Bytes of one quantised ``[in, out]`` leaf and its scales as
    :func:`quantize_decoder_params` stores it (packed int4: half a byte a
    weight, an odd group padded by one row)."""
    if leaf_bits(name, bits) == 8:
        return in_dim * out_dim + 4 * out_dim
    g = _int4_group(in_dim)
    groups = in_dim // g
    return groups * -(-g // 2) * out_dim + 4 * groups * out_dim


def _quantize_leaf(name: str, w: torch.Tensor, bits: int, out: Params,
                   divide: bool = False) -> None:
    if should_quantize(name) and w.dim() == 2:
        if leaf_bits(name, bits) == 8:
            q, scale = quantize_array(w, divide)
        else:
            q, scale = quantize_array_int4(w, divide=divide)
        out[name] = q
        out[name + SCALE_SUFFIX] = scale
    else:
        out[name] = w


def quantize_decoder_params(params: Mapping[str, object], bits: int = 8,
                            device=None) -> Params:
    """Quantise a float tree, tensor by tensor, from its values as given and
    in their own dtype.  Leaves may be tensors or numpy arrays; with
    ``device`` each is moved there before it is quantised, so a tree on the
    host becomes a quantised tree on the card with one float tensor on the
    card at a time.  In int4 mode ``lm_head`` stays int8 (:func:`leaf_bits`)."""
    if bits not in (4, 8):
        raise ValueError(f"quantization bits must be 4 or 8, got {bits}")
    from docqa_tpu_torch.weights import leaf_to_tensor

    out: Params = {}
    for name, arr in params.items():
        w = leaf_to_tensor(arr)
        if device is not None:
            w = w.to(device)
        _quantize_leaf(name, w, bits, out)
        del w
    return out


def init_quantized_decoder_params(
    cfg: DecoderConfig, seed: int, device, bits: int = 8,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random init drawn on ``device`` and quantised tensor by tensor: the
    float32 draws of :func:`~docqa_tpu_torch.models.decoder.init_decoder_params`
    (the same ``torch.Generator`` stream, schema order) quantised before
    any cast, as the reference's device route quantises its float32 draws.
    Unquantised leaves take ``dtype`` (default ``cfg.dtype``).  The host
    route equal to the reference's is
    ``weights.host_init_quantized_decoder_params``."""
    from docqa_tpu_torch.models.decoder import decoder_param_schema

    if bits not in (4, 8):
        raise ValueError(f"quantization bits must be 4 or 8, got {bits}")
    dtype = dtype or torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: Params = {}
    for name, kind, shape, fan_in in decoder_param_schema(cfg):
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        w = w * fan_in ** -0.5
        if should_quantize(name):
            _quantize_leaf(name, w, bits, out)
        else:
            out[name] = w.to(dtype)
        del w
    return out


def tree_bytes(params: Mapping[str, torch.Tensor]) -> int:
    """Bytes the tree holds on its device (packed int4 at half a byte)."""
    return sum(t.numel() * t.element_size() for t in params.values())
