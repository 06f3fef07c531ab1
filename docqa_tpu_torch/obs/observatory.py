"""Device observatory: per-stage FLOP/byte cost models, device-time
accounting and MFU attribution, counterpart of
``docqa_tpu/obs/observatory.py``.

The dispatch spine (``engines/spine.py``) measures where device time goes;
this module says what that time bought.  Each spine item reports
``(stage, cost_key, device_seconds)`` here (:meth:`Observatory.record`), and
a stage's cost model turns the key into FLOPs and bytes, so

    MFU = flops / device_seconds / peak_flops

is an attribution over measured device time (CUDA events on a card,
``engines/spine.py``).

The reference reads XLA's ``cost_analysis()`` of each compiled program.
The port compiles nothing, so its cost models are analytic, computed from
``DecoderConfig`` / ``EncoderConfig`` and the shape key the call site passes:

* a linear layer of ``m`` rows, ``k`` inputs and ``n`` outputs counts
  ``2·m·n·k`` FLOPs, at the shapes that actually run (padding rows and idle
  lanes included: the GEMMs compute them);
* attention counts ``4·d·hq·pairs`` FLOPs, the convention of ``PERF.md``'s
  bound column, over the live (query, key) pairs: causal within a segment,
  prefix rows included, clamped to the sliding window;
* bytes are the weights read once per forward plus the K/V rows attention
  reads (``2·kv_heads·d`` elements a row and layer).

The keys (``engines/serve.py``, ``engines/encoder.py``,
``engines/retrieve.py``), each model registered by the engine's
``annotate_costs``:

* ``serve_prefill_fetch``: ``("prefill", T, lanes, pairs, kv_rows)`` per
  packed group, T the token budget, ``lanes`` the head's rows (the batcher's
  slots);
* ``serve_decode_chunk``: ``("decode", lanes, q, steps, pairs, kv_rows)``
  for a chunk of ``steps`` forwards of ``q`` tokens a lane (q = K for a
  verify step); pairs and K/V rows are counted at each lane's length at
  dispatch, which undercounts a lane by what it grows inside the chunk;
* ``encode``: ``("encode", batch, seq, pairs)``, pairs the live
  (non-causal) pairs of the marshalled batch;
* ``retrieve``: ``("retrieve", batch, seq, pairs, rows)``: the query
  encode plus the exact scores over ``rows`` store rows
  (``2·batch·rows·dim`` FLOPs, the rows read once).

MFU needs a peak.  :func:`detect_peak_flops` names the card from
``torch.cuda.get_device_name``; a card outside :data:`_PEAKS` and a CPU get
no peak, and then every ``mfu`` is ``None`` (a visible gap beats a wrong
utilisation).  ``DOCQA_PEAK_FLOPS`` (FLOP/s) overrides the FLOP peak.

Stdlib only at import: torch is imported inside :func:`detect_peak_flops`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

# (substring of torch.cuda.get_device_name, dense bf16 FLOP/s, HBM bytes/s,
# source label): NVIDIA's data sheet figures for the SXM H100 at its 700 W
# limit, the peaks PERF.md's bounds use
_PEAKS: Tuple[Tuple[str, float, float, str], ...] = (
    ("H100 80GB HBM3", 989e12, 3.35e12, "NVIDIA H100 SXM dense bf16"),
)


def detect_peak_flops(device: Any = None) -> Dict[str, Any]:
    """``{"peak_flops", "peak_bytes_s", "peak_flops_source"}`` for MFU math.

    ``device`` defaults to the current CUDA device when a card is present.
    A known card gives its data-sheet peaks and names itself in the source;
    an unknown card or a CPU gives ``None`` peaks.  ``DOCQA_PEAK_FLOPS``
    replaces the FLOP peak (the byte peak stays the card's).  Never
    raises."""
    peak_flops: Optional[float] = None
    peak_bytes: Optional[float] = None
    source = "none:cpu"
    try:
        import torch

        dev = torch.device(device) if device is not None else None
        if dev is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev is not None and dev.type == "cuda":
            name = torch.cuda.get_device_name(dev)
            source = f"unknown-card:{name}"
            for sub, flops, bw, label in _PEAKS:
                if sub in name:
                    peak_flops, peak_bytes = flops, bw
                    source = f"{name} ({label})"
                    break
    except Exception:  # obs must not raise; the gap shows as mfu None
        pass
    env = os.environ.get("DOCQA_PEAK_FLOPS")
    if env:
        try:
            peak_flops = float(env)
            source = "env:DOCQA_PEAK_FLOPS"
        except ValueError:
            pass
    return {
        "peak_flops": peak_flops,
        "peak_bytes_s": peak_bytes,
        "peak_flops_source": source,
    }


# ---- analytic cost models ---------------------------------------------------


def _dtype_bytes(dtype: str) -> int:
    return 4 if dtype in ("float32", "fp32") else 2


def causal_pairs(start: int, end: int, window: Optional[int] = None) -> int:
    """Live (query, key) pairs of positions ``[start, end)`` attending
    causally from position 0: ``min(p + 1, window)`` keys each."""
    if end <= start:
        return 0
    if not window:
        return (end * (end + 1) - start * (start + 1)) // 2
    return sum(min(p + 1, window) for p in range(start, end))


def decoder_linear_flops(cfg, rows: int, logit_rows: int) -> float:
    """FLOPs of the decoder's linear layers: ``rows`` tokens through every
    layer's q/k/v/o and SwiGLU projections, and ``logit_rows`` through the
    lm head."""
    h = cfg.hidden_dim
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    per_token = 2 * h * (qd + 2 * kvd) + 2 * qd * h + 3 * 2 * h * cfg.mlp_dim
    return float(
        rows * cfg.num_layers * per_token + logit_rows * 2 * h * cfg.vocab_size
    )


def _projection_bytes(cfg, in_dim: int, out_dim: int, name: str) -> int:
    """Bytes of one ``[in, out]`` projection as the engine stores it: the
    compute dtype, or quantised as ``models/quant.py`` stores it."""
    if not cfg.quantize_weights:
        return in_dim * out_dim * _dtype_bytes(cfg.dtype)
    from docqa_tpu_torch.models.quant import quantized_bytes

    return quantized_bytes(name, in_dim, out_dim, cfg.quant_bits)


def decoder_weight_bytes(cfg) -> float:
    """Bytes a decoder forward reads in weights: every layer's projections
    and norm gains, the final norm and ``lm_head`` (the embedding is
    gathered, a few rows a step, and not counted), at the precision the
    engine stores them, quantised or not."""
    h = cfg.hidden_dim
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    shapes = (("wq", h, qd), ("wk", h, kvd), ("wv", h, kvd), ("wo", qd, h),
              ("w_gate", h, cfg.mlp_dim), ("w_up", h, cfg.mlp_dim),
              ("w_down", cfg.mlp_dim, h))
    per_layer = sum(_projection_bytes(cfg, i, o, n) for n, i, o in shapes)
    per_layer += 2 * h * _dtype_bytes(cfg.dtype)
    n = (cfg.num_layers * per_layer + _projection_bytes(cfg, h, cfg.vocab_size, "lm_head")
         + h * _dtype_bytes(cfg.dtype))
    return float(n)


def decoder_cost(
    cfg, rows: int, logit_rows: int, pairs: int, kv_rows: int, forwards: int = 1
) -> Dict[str, float]:
    """One or more decoder forwards: ``rows`` tokens and ``logit_rows``
    head rows a forward, ``pairs`` live attention pairs and ``kv_rows``
    K/V rows read in all (per layer)."""
    attn = 4.0 * cfg.head_dim * cfg.num_heads * pairs * cfg.num_layers
    kv_bytes = (
        kv_rows * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
        * _dtype_bytes(cfg.dtype)
    )
    return {
        "flops": forwards * decoder_linear_flops(cfg, rows, logit_rows) + attn,
        "bytes": forwards * decoder_weight_bytes(cfg) + float(kv_bytes),
    }


def encoder_linear_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of the encoder's linear layers over ``batch x seq`` tokens (q,
    k, v, o, up, down a layer), the masked mean pool over them, and the
    projection when ``embed_dim != hidden_dim``."""
    h = cfg.hidden_dim
    per_token = 4 * 2 * h * h + 2 * 2 * h * cfg.mlp_dim
    flops = batch * seq * (cfg.num_layers * per_token + 2 * h)
    if cfg.embed_dim != cfg.hidden_dim:
        flops += 2 * batch * h * cfg.embed_dim
    return float(flops)


def encoder_cost(cfg, batch: int, seq: int, pairs: int) -> Dict[str, float]:
    """One encoder forward of ``batch x seq`` tokens with ``pairs`` live
    (non-causal, within each text's length) attention pairs."""
    h = cfg.hidden_dim
    hd = h // cfg.num_heads
    per_layer = 4 * h * h + 2 * h * cfg.mlp_dim + 8 * h
    weights = cfg.num_layers * per_layer * _dtype_bytes(cfg.dtype)
    kv = cfg.num_layers * batch * seq * 2 * h * _dtype_bytes(cfg.dtype)
    return {
        "flops": encoder_linear_flops(cfg, batch, seq)
        + 4.0 * hd * cfg.num_heads * pairs * cfg.num_layers,
        "bytes": float(weights + kv),
    }


CostModel = Callable[[Any], Optional[Dict[str, float]]]


class Observatory:
    """Cost-model registry plus per-stage device-time/FLOP aggregates.

    The reference registers one static cost per compiled program (its
    ``annotate`` / ``annotate_lowered``); the port registers one analytic
    model per stage (:meth:`annotate_model`), since its keys carry
    data-dependent counts (live pairs, verify steps)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # stage -> model(cost_key) -> {"flops", "bytes"} or None
        self._models: Dict[str, CostModel] = {}
        # stage -> {"calls", "device_s", "flops", "bytes", "uncosted"}
        self._stages: Dict[str, Dict[str, float]] = {}

    # ---- cost registration ---------------------------------------------------

    def annotate_model(self, stage: str, model: CostModel) -> None:
        """The cost model of ``stage``: ``model(key)`` gives ``{"flops",
        "bytes"}``, or None for a key it does not cost."""
        with self._lock:
            self._models[stage] = model

    def _cost_locked(self, stage: str, key: Any) -> Optional[Dict[str, float]]:
        model = self._models.get(stage)
        return model(key) if model is not None else None

    def cost_of(self, stage: str, key: Any = None) -> Optional[Dict[str, float]]:
        with self._lock:
            c = self._cost_locked(stage, key)
            return dict(c) if c else None

    # ---- accounting (called by the spine) ------------------------------------

    def record(self, stage: str, cost_key: Any, device_s: float) -> None:
        """One completed work item.  ``cost_key`` may be a list of keys (a
        prefill round covering several packed groups): each key's cost
        accrues to the stage.  A tuple is one key."""
        keys = list(cost_key) if isinstance(cost_key, list) else [cost_key]
        with self._lock:
            row = self._stages.setdefault(
                stage,
                {"calls": 0, "device_s": 0.0, "flops": 0.0, "bytes": 0.0,
                 "uncosted": 0},
            )
            row["calls"] += 1
            row["device_s"] += max(device_s, 0.0)
            costed = False
            for k in keys:
                c = self._cost_locked(stage, k)
                if c is not None:
                    row["flops"] += c["flops"]
                    row["bytes"] += c["bytes"]
                    costed = True
            if not costed:
                row["uncosted"] += 1

    def reset(self) -> None:
        """Zero the aggregates (measurement windows); cost models
        survive."""
        with self._lock:
            self._stages.clear()

    # ---- attribution ---------------------------------------------------------

    def stats(self, peak: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Per-stage MFU / roofline table.  A stage with no cost, or a run
        with no known peak, reports device time with ``mfu: None``.  An
        MFU above 1 is never reported as utilisation: the measured device
        time under-covers the work, so the raw ratio goes to
        ``mfu_raw_invalid`` instead."""
        peak = peak or detect_peak_flops()
        peak_flops = peak["peak_flops"]
        peak_bw = peak["peak_bytes_s"]
        ridge = peak_flops / peak_bw if peak_flops and peak_bw else None
        with self._lock:
            rows = {k: dict(v) for k, v in self._stages.items()}
        out: Dict[str, Any] = {"peak": peak, "stages": {}}
        for stage, row in sorted(rows.items()):
            dev = row["device_s"]
            flops = row["flops"]
            entry: Dict[str, Any] = {
                "calls": int(row["calls"]),
                "device_s": round(dev, 6),
                "flops": flops,
                "bytes": row["bytes"],
                "uncosted_calls": int(row["uncosted"]),
                "mfu": None,
                "intensity_flops_per_byte": None,
                "roofline_bound": None,
            }
            if flops > 0.0 and dev > 0.0 and peak_flops:
                mfu = flops / dev / peak_flops
                if mfu > 1.0:
                    entry["mfu_raw_invalid"] = round(mfu, 6)
                else:
                    entry["mfu"] = round(mfu, 6)
            if flops > 0.0 and row["bytes"] > 0.0:
                intensity = flops / row["bytes"]
                entry["intensity_flops_per_byte"] = round(intensity, 3)
                if ridge is not None:
                    entry["roofline_bound"] = (
                        "compute" if intensity >= ridge else "memory"
                    )
            out["stages"][stage] = entry
        return out


DEFAULT_OBSERVATORY = Observatory()
