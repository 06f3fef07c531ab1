"""Encoder serving engine: tokenize -> bucket -> encode on the device.
Counterpart of ``docqa_tpu/engines/encoder.py``.

:meth:`EncoderEngine.encode_texts` runs each marshalled batch as one
dispatch-spine work item (stage ``encode``: upload, forward, fetch) inside
an ``encode_batch`` span; :meth:`EncoderEngine.encode_ids` is the forward
alone, for callers that run it inside their own item (the fused
retriever).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from docqa_tpu_torch import weights
from docqa_tpu_torch.config import EncoderConfig
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.models.encoder import Params, encode_batch
from docqa_tpu_torch.obs.observatory import DEFAULT_OBSERVATORY, encoder_cost
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.text.tokenizer import Tokenizer, default_tokenizer
from docqa_tpu_torch.utils import pick_bucket, resolve_device

SEQ_BUCKETS = (64, 128, 256, 512)
BATCH_BUCKETS = (8, 32, 128)


def marshal_texts(
    tokenizer,
    cfg: EncoderConfig,
    texts: Sequence[str],
    batch_buckets: Tuple[int, ...] = BATCH_BUCKETS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize + seq/batch bucket + pad — the one marshalling path, shared
    by :class:`EncoderEngine` and the fused retriever, with the reference's
    buckets.  Returns (ids [B, S] int32, lengths [B] int32); rows beyond
    ``len(texts)`` are zero-length lanes."""
    n = len(texts)
    ids, lengths = tokenizer.batch(
        texts, max_len=min(cfg.max_seq_len, SEQ_BUCKETS[-1])
    )
    seq_b = min(
        pick_bucket(int(lengths.max()) if n else 1, SEQ_BUCKETS), ids.shape[1]
    )
    batch_b = pick_bucket(n, batch_buckets) if n <= batch_buckets[-1] else n
    ids_p = np.zeros((batch_b, seq_b), np.int32)
    len_p = np.zeros((batch_b,), np.int32)
    ids_p[:n] = ids[:, :seq_b]
    len_p[:n] = np.minimum(lengths, seq_b)
    return ids_p, len_p


class EncoderEngine:
    def __init__(
        self,
        cfg: EncoderConfig,
        tokenizer: Optional[Tokenizer] = None,
        params: Optional[Params] = None,
        seed: int = 0,
        device="cuda",
    ):
        """``params``: a tree of numpy arrays or tensors with the
        reference's names; None draws the reference's seeded host init.
        Parameters stay float32 (matmuls cast to ``cfg.dtype``).
        ``forwards`` counts encoder forwards (one per marshalled batch)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer or default_tokenizer(cfg.vocab_size)
        if params is None:
            params = weights.host_init_encoder_params(cfg, seed)
        self.params = weights.to_torch(params, self.device)
        self.forwards = 0
        self._count_lock = threading.Lock()

    def cost_key(self, ids: np.ndarray, lengths: np.ndarray) -> tuple:
        """The analytic cost key of one forward over a marshalled batch:
        ``("encode", batch, seq, live pairs)`` (``obs/observatory.py``)."""
        lens = lengths.astype(np.int64)
        return ("encode", ids.shape[0], ids.shape[1], int((lens * lens).sum()))

    def annotate_costs(self) -> None:
        """Register the ``encode`` stage's analytic cost model."""
        cfg = self.cfg
        DEFAULT_OBSERVATORY.annotate_model(
            "encode", lambda key: encoder_cost(cfg, *key[1:])
        )

    def encode_ids(self, ids: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """Marshalled [B, S] ids -> [B, embed_dim] f32 embeddings, left on
        the device (the forward alone: no spine item)."""
        ids_t = torch.from_numpy(ids).long().to(self.device)
        len_t = torch.from_numpy(lengths).to(self.device)
        with torch.inference_mode():
            out = encode_batch(self.params, self.cfg, ids_t, len_t)
        with self._count_lock:
            self.forwards += 1
        return out

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """[n] texts -> [n, embed_dim] float32 embeddings (host).  Splits
        oversized requests into max-bucket batches."""
        if not len(texts):
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        out = []
        max_b = BATCH_BUCKETS[-1]
        for start in range(0, len(texts), max_b):
            chunk = texts[start : start + max_b]
            ids_p, len_p = marshal_texts(self.tokenizer, self.cfg, chunk)

            def _encode_on_device(ids_p=ids_p, len_p=len_p):
                return to_host(self.encode_ids(ids_p, len_p).float())

            with span("encode_batch", DEFAULT_REGISTRY):
                emb = spine_run(
                    "encode", _encode_on_device, device=self.device,
                    cost_key=self.cost_key(ids_p, len_p),
                )
            out.append(emb.numpy()[: len(chunk)])
        return np.concatenate(out, 0)
