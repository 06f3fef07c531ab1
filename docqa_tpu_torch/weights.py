"""Parameter trees for the port.

Two routes, both numpy-only on the way in:

* :func:`host_init_decoder_params` / :func:`host_init_encoder_params`
  reproduce ``docqa_tpu``'s ``host_init`` trees bit for bit without JAX:
  ``np.random.default_rng(seed)``, then for the decoder
  ``standard_normal(shape, float32) * fan_in**-0.5`` in schema order
  (``docqa_tpu/models/decoder.py`` init_decoder_params) and for the
  encoder ``standard_normal(shape) * 0.02`` cast to float32
  (``docqa_tpu/models/encoder.py`` init_encoder_params).
* :func:`host_init_seq2seq_params` does the same for the BART-class
  summarizer: ``standard_normal(shape, float32) * 0.02`` for each "normal"
  leaf of ``seq2seq_param_schema`` in its order, ones and zeros drawing
  nothing (``docqa_tpu/models/seq2seq.py`` init_seq2seq_params).
* :func:`host_init_quantized_decoder_params` is the reference's quantised
  host init (``docqa_tpu/models/quant.py`` init_quantized_decoder_params
  with ``host_init=True``): the same draws, quantised on the host.
* :func:`to_torch` turns any such tree of numpy arrays — including one
  exported from ``docqa_tpu`` with ``np.asarray`` on each leaf, bfloat16
  and int4 leaves too — into tensors on a device, never casting a
  quantised weight or its scale; :func:`ner_params_to_torch` does
  so for a NER tagger tree after checking its names and shapes (the
  reference draws its tagger with ``jax.random``, so a tagger reaches the
  port only this way or through ``training/ner.py``'s npz).

Names and layouts are the reference's, so a tree moves between the two
packages unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from docqa_tpu_torch.config import (
    DecoderConfig, EncoderConfig, NERConfig, Seq2SeqConfig,
)
from docqa_tpu_torch.models.decoder import decoder_param_schema
from docqa_tpu_torch.models.quant import SCALE_SUFFIX, _quantize_leaf, should_quantize
from docqa_tpu_torch.models.seq2seq import seq2seq_param_schema
from docqa_tpu_torch.ops.qmatmul import pack_int4

HostTree = Dict[str, np.ndarray]


def _host_rng(seed: int) -> np.random.Generator:
    # the reference masks an explicit host seed to 31 bits
    return np.random.default_rng(int(seed) & 0x7FFFFFFF)


def host_init_decoder_params(cfg: DecoderConfig, seed: int) -> HostTree:
    """float32 numpy decoder tree equal to the reference's
    ``init_decoder_params(PRNGKey(seed), cfg, host_init=True,
    host_seed=seed)`` before its cast to the parameter dtype."""
    rng = _host_rng(seed)
    p: HostTree = {}
    for name, kind, shape, fan_in in decoder_param_schema(cfg):
        if kind == "ones":
            p[name] = np.ones(shape, np.float32)
        else:
            p[name] = rng.standard_normal(shape, np.float32) * (fan_in ** -0.5)
    return p


def host_init_encoder_params(cfg: EncoderConfig, seed: int) -> HostTree:
    """float32 numpy encoder tree equal to the reference's
    ``init_encoder_params(PRNGKey(seed), cfg, host_init=True,
    host_seed=seed)``; draws happen in the reference's order."""
    rng = _host_rng(seed)

    def norm(shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ones(n):
        return np.ones((n,), np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    h, m = cfg.hidden_dim, cfg.mlp_dim
    p: HostTree = {
        "tok_emb": norm((cfg.vocab_size, h)),
        "pos_emb": norm((cfg.max_seq_len, h)),
        "type_emb": norm((2, h)),
        "emb_ln_g": ones(h),
        "emb_ln_b": zeros(h),
    }
    if cfg.embed_dim != h:
        p["proj_w"] = norm((h, cfg.embed_dim))
        p["proj_b"] = zeros(cfg.embed_dim)
    for i in range(cfg.num_layers):
        p.update(
            {
                f"l{i}_q_w": norm((h, h)), f"l{i}_q_b": zeros(h),
                f"l{i}_k_w": norm((h, h)), f"l{i}_k_b": zeros(h),
                f"l{i}_v_w": norm((h, h)), f"l{i}_v_b": zeros(h),
                f"l{i}_o_w": norm((h, h)), f"l{i}_o_b": zeros(h),
                f"l{i}_attn_ln_g": ones(h), f"l{i}_attn_ln_b": zeros(h),
                f"l{i}_up_w": norm((h, m)), f"l{i}_up_b": zeros(m),
                f"l{i}_down_w": norm((m, h)), f"l{i}_down_b": zeros(h),
                f"l{i}_mlp_ln_g": ones(h), f"l{i}_mlp_ln_b": zeros(h),
            }
        )
    return p


def host_init_seq2seq_params(cfg: Seq2SeqConfig, seed: int) -> HostTree:
    """float32 numpy seq2seq tree equal to the reference's
    ``init_seq2seq_params(PRNGKey(seed), cfg, param_dtype=float32,
    host_init=True, host_seed=seed)``."""
    rng = _host_rng(seed)
    p: HostTree = {}
    for name, kind, shape in seq2seq_param_schema(cfg):
        if kind == "ones":
            p[name] = np.ones(shape, np.float32)
        elif kind == "zeros":
            p[name] = np.zeros(shape, np.float32)
        else:
            p[name] = rng.standard_normal(shape, np.float32) * 0.02
    return p


def seq2seq_params_to_torch(
    tree: Mapping[str, object], cfg: Seq2SeqConfig, device
) -> Dict[str, torch.Tensor]:
    """A seq2seq tree (numpy, e.g. exported from the reference with
    ``np.asarray`` on each leaf, or tensors from
    ``models.seq2seq.load_hf_bart_weights``) -> tensors on ``device`` in
    their own dtypes.  Raises on a missing, extra or misshapen leaf."""
    _check_shapes(tree, {name: tuple(shape) for name, _k, shape in
                         seq2seq_param_schema(cfg)}, "seq2seq")
    return to_torch(tree, device)


def leaf_to_tensor(arr) -> torch.Tensor:
    """One leaf as a tensor on the host (a tensor passes as it is).  numpy
    bfloat16 is reinterpreted from its 16-bit payload; an exported int4
    array (``ml_dtypes.int4``, recognised by its dtype's name, stored
    ``[groups, g, out]`` by the reference) becomes the port's packed uint8
    store (``ops/qmatmul.py``)."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if not arr.flags.writeable:
        # an exported (read-only) buffer: never let a tensor alias it
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(
            torch.bfloat16
        )
    if arr.dtype.name == "int4":
        return pack_int4(torch.from_numpy(np.ascontiguousarray(arr.astype(np.int8))))
    return torch.from_numpy(np.ascontiguousarray(arr))


def _keeps_dtype(name: str, t: torch.Tensor) -> bool:
    """A quantised weight or its scale: never cast to the compute dtype."""
    return t.dtype in (torch.int8, torch.uint8) or name.endswith(SCALE_SUFFIX)


def to_torch(
    tree: Mapping[str, object], device, dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) tree -> tensors on ``device``, each floating leaf
    cast to ``dtype`` when given (one tensor at a time: a full-width float32
    tree never sits on the device).  Quantised weights (int8, packed int4)
    and their ``__scale`` leaves keep their dtypes, as the reference's
    engine never casts them."""
    out = {}
    for name, arr in tree.items():
        t = leaf_to_tensor(arr)
        keep = dtype is None or _keeps_dtype(name, t)
        out[name] = t.to(device=device, dtype=t.dtype if keep else dtype)
    return out


def _bf16_values(w: np.ndarray) -> np.ndarray:
    """float32 array rounded to bfloat16's values (round to nearest even),
    kept as float32."""
    return torch.from_numpy(w).to(torch.bfloat16).float().numpy()


def host_init_quantized_decoder_params(
    cfg: DecoderConfig, seed: int, bits: int = 8
) -> Dict[str, object]:
    """The reference's ``init_quantized_decoder_params(PRNGKey(seed), cfg,
    host_init=True, bits=bits, host_seed=seed)``, integer for integer and
    scale for scale: the float32 draws of :func:`host_init_decoder_params`
    quantised on the host by ``models/quant.py`` dividing the absmax as
    numpy does, int8 per column or int4 in groups (``lm_head`` int8 in both
    modes), as CPU tensors; int4 leaves come packed (``ops/qmatmul.py``).
    The other leaves hold bfloat16 values (as float32 arrays), as the
    reference stores them in bfloat16."""
    if bits not in (4, 8):
        raise ValueError(f"quantization bits must be 4 or 8, got {bits}")
    rng = _host_rng(seed)
    out: Dict[str, object] = {}
    for name, kind, shape, fan_in in decoder_param_schema(cfg):
        if kind == "ones":
            out[name] = np.ones(shape, np.float32)
            continue
        w = rng.standard_normal(shape, np.float32) * (fan_in ** -0.5)
        if should_quantize(name):
            _quantize_leaf(name, torch.from_numpy(w), bits, out, divide=True)
        else:
            out[name] = _bf16_values(w)
        del w
    return out


def ner_param_shapes(cfg: NERConfig) -> Dict[str, tuple]:
    """Name -> shape of a NER tagger tree: the encoder trunk at the
    tagger's widths (no pooling projection) plus ``head_w`` [hidden,
    num_labels] and ``head_b`` [num_labels]."""
    h, m = cfg.hidden_dim, cfg.mlp_dim
    shapes = {
        "tok_emb": (cfg.vocab_size, h), "pos_emb": (cfg.max_seq_len, h),
        "type_emb": (2, h), "emb_ln_g": (h,), "emb_ln_b": (h,),
        "head_w": (h, cfg.num_labels), "head_b": (cfg.num_labels,),
    }
    for i in range(cfg.num_layers):
        for name in ("q", "k", "v", "o"):
            shapes[f"l{i}_{name}_w"], shapes[f"l{i}_{name}_b"] = (h, h), (h,)
        shapes[f"l{i}_up_w"], shapes[f"l{i}_up_b"] = (h, m), (m,)
        shapes[f"l{i}_down_w"], shapes[f"l{i}_down_b"] = (m, h), (h,)
        for ln in ("attn_ln", "mlp_ln"):
            shapes[f"l{i}_{ln}_g"], shapes[f"l{i}_{ln}_b"] = (h,), (h,)
    return shapes


def ner_params_to_torch(
    tree: Mapping[str, object], cfg: NERConfig, device
) -> Dict[str, torch.Tensor]:
    """A NER tagger tree (numpy or tensors, the reference's names, head
    included) -> float32 tensors on ``device``.  Raises on a missing,
    extra or misshapen leaf."""
    _check_shapes(tree, ner_param_shapes(cfg), "NER")
    return to_torch(tree, device, dtype=torch.float32)


def _check_shapes(tree: Mapping[str, object], want: Dict[str, tuple], what: str) -> None:
    """Raise ``ValueError`` naming every missing, extra or misshapen leaf."""
    got = {name: tuple(np.shape(arr)) for name, arr in tree.items()}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shape = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise ValueError(
            f"not a {what} tree for this config: missing {missing}, extra "
            f"{extra}, wrong shape {shape}"
        )
