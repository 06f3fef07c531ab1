"""Plain float32 forwards of the encoder and the decoder, and the weight
quantisers of the configurations and of their controls.

Weights arrive as the benchmark drew them (``portbench/inputs.py``): the
decoder's in its served float type with projections stored [in, out], the
encoder's in float32.  Each leaf is taken to float32 (or to its quantised
values) one layer at a time, so the full float32 tree never sits in memory.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

INT4_GROUP = 128


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


# ---- quantisers ------------------------------------------------------------

def int8_columns(w: torch.Tensor) -> torch.Tensor:
    """Per-output-column absmax int8 (``scale = absmax * float32(1/127)``,
    round half to even, clip to +-127), returned dequantised in float32."""
    w32 = w.float()
    scale = (w32.abs().amax(dim=0) * (1.0 / 127.0)).clamp_min(1e-12)
    return torch.clamp(torch.round(w32 / scale), -127, 127) * scale


def int4_groups(w: torch.Tensor, group: int = INT4_GROUP) -> torch.Tensor:
    """Absmax int4 in groups of ``group`` rows along the input axis (+-7),
    returned dequantised in float32."""
    i, o = w.shape
    g = min(group, i)
    while i % g:
        g -= 1
    w32 = w.float().reshape(i // g, g, o)
    scale = (w32.abs().amax(dim=1, keepdim=True) * (1.0 / 7.0)).clamp_min(1e-12)
    return (torch.clamp(torch.round(w32 / scale), -7, 7) * scale).reshape(i, o)


FP8_MAX = 448.0  # largest finite float8 e4m3


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """float8 e4m3 with one absmax scale along ``dim`` (0: per column of a
    weight, 1: per row of stored vectors), dequantised in float32."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=dim, keepdim=True) / FP8_MAX).clamp_min(1e-12)
    return (x32 / scale).to(torch.float8_e4m3fn).float() * scale


def projection(w: torch.Tensor, bits, name: str) -> torch.Tensor:
    """A projection's weights as float32 at ``bits``: 16 the values as
    drawn, 8 int8 per column, 4 int4 in groups (the lm head stays int8),
    "fp8" float8 e4m3 per column."""
    if bits == 16:
        return w.float()
    if bits == "fp8":
        return fp8(w, 0)
    if bits == 8 or name == "lm_head":
        return int8_columns(w)
    if bits == 4:
        return int4_groups(w)
    raise ValueError(f"no reference quantiser for {bits} bits")


# ---- encoder ---------------------------------------------------------------

def _layer_norm(x, g, b, eps=1e-12):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def bert_embed(params: Dict[str, torch.Tensor], layers: int, heads: int,
               ids: Sequence[int], device, bits=16) -> torch.Tensor:
    """One text's embedding [d]: BERT stack, masked mean pool, optional
    projection, L2 normalised twice (the store scores cosine).  ``bits``
    other than 16 runs the dense layers on weights at that precision
    (:func:`projection`; a control)."""
    def p(name):
        t = params[name].to(device)
        if bits != 16 and name.endswith("_w") and t.dim() == 2:
            return projection(t, bits, name)
        return t.float()

    ids_t = torch.as_tensor(list(ids), dtype=torch.long, device=device)
    s = ids_t.shape[0]
    x = p("tok_emb")[ids_t] + p("pos_emb")[:s] + p("type_emb")[0][None]
    x = _layer_norm(x, p("emb_ln_g"), p("emb_ln_b"))
    h = x.shape[-1]
    hd = h // heads

    def dense(y, name):
        return y @ p(f"{name}_w") + p(f"{name}_b")

    for i in range(layers):
        q = dense(x, f"l{i}_q").reshape(s, heads, hd).transpose(0, 1)
        k = dense(x, f"l{i}_k").reshape(s, heads, hd).transpose(0, 1)
        v = dense(x, f"l{i}_v").reshape(s, heads, hd).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1) @ v
        att = dense(att.transpose(0, 1).reshape(s, h), f"l{i}_o")
        x = _layer_norm(x + att, p(f"l{i}_attn_ln_g"), p(f"l{i}_attn_ln_b"))
        up = F.gelu(dense(x, f"l{i}_up"), approximate="none")
        x = _layer_norm(x + dense(up, f"l{i}_down"), p(f"l{i}_mlp_ln_g"), p(f"l{i}_mlp_ln_b"))
    pooled = x.mean(dim=0)
    if "proj_w" in params:
        pooled = pooled @ p("proj_w") + p("proj_b")
    pooled = pooled / pooled.norm().clamp_min(1e-9)
    return pooled / pooled.norm().clamp_min(1e-9)


# ---- decoder ---------------------------------------------------------------

def _rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * g


def _rope(x, positions, theta):
    """Split-halves rotary embedding of x [s, heads, d] at ``positions``."""
    d = x.shape[-1]
    inv = 1.0 / torch.pow(float(theta), torch.arange(0, d, 2, dtype=torch.float32,
                                                      device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _causal_attention(q, k, v, window: Optional[int], block: int = 1024):
    """q [s, hq, d], k/v [s, hkv, d] -> [s, hq, d], causal (and windowed),
    softmax in float32, in blocks of query rows."""
    s, hq, d = q.shape
    groups = hq // k.shape[1]
    k = k.repeat_interleave(groups, dim=1).transpose(0, 1)  # [hq, s, d]
    v = v.repeat_interleave(groups, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1) / math.sqrt(d)
    out = []
    keys = torch.arange(s, device=q.device)
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        scores = qt[:, lo:hi] @ k[:, :hi].transpose(1, 2)  # [hq, b, hi]
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        mask = keys[None, :hi] <= rows
        if window:
            mask &= keys[None, :hi] > rows - window
        scores = scores.masked_fill(~mask[None], float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ v[:, :hi])
    return torch.cat(out, dim=1).transpose(0, 1)


def decoder_logits(weights: Dict[str, torch.Tensor], shape, seqs: List[List[int]],
                   starts: List[int], device, bits=16,
                   rope_theta: float = 10000.0, norm_eps: float = 1e-5) -> List[torch.Tensor]:
    """Float32 logits [len(seq) - start, vocab] of each sequence's positions
    from ``start`` on (the logits that chose each later token).  Layer by
    layer over all sequences, so each layer's weights are made float32 once.
    ``shape``: a ``portbench.flops.ModelShape``; ``bits`` picks the
    projections' precision (:func:`projection`)."""
    hd, hq, hkv = shape.head_dim, shape.heads, shape.kv_heads
    emb = weights["tok_emb"]
    xs = [emb[torch.as_tensor(s, dtype=torch.long, device=emb.device)].to(device).float()
          for s in seqs]
    pos = [torch.arange(len(s), device=device) for s in seqs]
    for i in range(shape.layers):
        w = {n: projection(weights[f"l{i}_{n}"].to(device), bits, n)
             for n, _, _ in shape.projections()}
        g_attn = weights[f"l{i}_attn_norm_g"].to(device).float()
        g_mlp = weights[f"l{i}_mlp_norm_g"].to(device).float()
        for j, x in enumerate(xs):
            n = x.shape[0]
            y = _rms_norm(x, g_attn, norm_eps)
            q = _rope((y @ w["wq"]).reshape(n, hq, hd), pos[j], rope_theta)
            k = _rope((y @ w["wk"]).reshape(n, hkv, hd), pos[j], rope_theta)
            v = (y @ w["wv"]).reshape(n, hkv, hd)
            x = x + _causal_attention(q, k, v, shape.window).reshape(n, hq * hd) @ w["wo"]
            y = _rms_norm(x, g_mlp, norm_eps)
            xs[j] = x + (F.silu(y @ w["w_gate"]) * (y @ w["w_up"])) @ w["w_down"]
        del w
    head = projection(weights["lm_head"].to(device), bits, "lm_head")
    g = weights["final_norm_g"].to(device).float()
    return [_rms_norm(x[st:], g, norm_eps) @ head for x, st in zip(xs, starts)]
