"""Encoder serving engine: tokenize -> bucket -> encode on the device.
Counterpart of ``docqa_tpu/engines/encoder.py``, with its device-free
stand-in :class:`HashEncoder` (the runtime's ``flags.use_fake_encoder``).

:meth:`EncoderEngine.encode_texts` runs each marshalled batch as one
dispatch-spine work item (stage ``encode``: upload, forward, fetch) inside
an ``encode_batch`` span; :meth:`EncoderEngine.encode_ids` is the forward
alone, for callers that run it inside their own item (the fused
retriever).

On a mesh (``mesh=``) the parameters are replicated on every rank and
each marshalled batch, padded to a multiple of the data axis, splits over
it: every data rank encodes its rows and the embeddings are gathered (one
``all_gather`` a forward), so every rank holds the whole batch's.
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
from docqa_tpu_torch.runtime.mesh import MeshContext, all_gather
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.text.tokenizer import Tokenizer, default_tokenizer
from docqa_tpu_torch.utils import pick_bucket, resolve_device, round_up

SEQ_BUCKETS = (64, 128, 256, 512)
BATCH_BUCKETS = (8, 32, 128)


def marshal_texts(
    tokenizer,
    cfg: EncoderConfig,
    texts: Sequence[str],
    batch_buckets: Tuple[int, ...] = BATCH_BUCKETS,
    n_data: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize + seq/batch bucket + pad — the one marshalling path, shared
    by :class:`EncoderEngine` and the fused retriever, with the reference's
    buckets.  Returns (ids [B, S] int32, lengths [B] int32); rows beyond
    ``len(texts)`` are zero-length lanes; ``n_data`` rounds the batch up to
    a multiple of the mesh's data axis."""
    n = len(texts)
    ids, lengths = tokenizer.batch(
        texts, max_len=min(cfg.max_seq_len, SEQ_BUCKETS[-1])
    )
    seq_b = min(
        pick_bucket(int(lengths.max()) if n else 1, SEQ_BUCKETS), ids.shape[1]
    )
    batch_b = pick_bucket(n, batch_buckets) if n <= batch_buckets[-1] else n
    if n_data is not None:
        batch_b = round_up(batch_b, n_data)
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
        mesh: Optional[MeshContext] = None,
    ):
        """``params``: a tree of numpy arrays or tensors with the
        reference's names (an imported checkpoint's among them); None draws
        the reference's seeded host init.  Parameters keep their dtype
        (matmuls cast to ``cfg.dtype``).  The tokenizer reads
        ``cfg.tokenizer_path`` when set (the hash fallback otherwise).
        ``forwards`` counts encoder forwards (one per marshalled batch).
        ``mesh``: encode data-parallel on the mesh's device (module
        docstring)."""
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.tokenizer = tokenizer or default_tokenizer(
            cfg.vocab_size, vocab_path=cfg.tokenizer_path
        )
        if params is None:
            params = weights.host_init_encoder_params(cfg, seed)
        self.params = weights.to_torch(params, self.device)
        self.forwards = 0
        self._count_lock = threading.Lock()

    @property
    def n_data(self) -> Optional[int]:
        """The data axis a marshalled batch must divide (None alone)."""
        return None if self.mesh is None else self.mesh.n_data

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

    def encode_ids(self, ids, lengths) -> torch.Tensor:
        """Marshalled [B, S] ids and [B] lengths (numpy arrays, or tensors
        already on the device) -> [B, embed_dim] f32 embeddings, left on
        the device (the forward alone: no spine item).  On a mesh this rank
        encodes its rows of the batch (a multiple of the data axis) and
        the embeddings are gathered."""
        mesh = self.mesh
        lanes = slice(None) if mesh is None else mesh.data_lanes(len(ids))
        ids_t = torch.as_tensor(ids)[lanes].long().to(self.device)
        len_t = torch.as_tensor(lengths)[lanes].to(self.device)
        with torch.inference_mode():
            out = encode_batch(self.params, self.cfg, ids_t, len_t)
            if mesh is not None:
                out = all_gather(out, mesh.data_group, "encode")
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
            ids_p, len_p = marshal_texts(self.tokenizer, self.cfg, chunk,
                                         n_data=self.n_data)

            def _encode_on_device(ids_p=ids_p, len_p=len_p):
                return to_host(self.encode_ids(ids_p, len_p).float())

            with span("encode_batch", DEFAULT_REGISTRY):
                emb = spine_run(
                    "encode", _encode_on_device, device=self.device,
                    cost_key=self.cost_key(ids_p, len_p),
                )
            out.append(emb.numpy()[: len(chunk)])
        return np.concatenate(out, 0)


class HashEncoder:
    """Device-free deterministic stand-in for :class:`EncoderEngine`:
    seeded random projections of token counts, so similar texts land near
    each other and fake-encoder runs exercise real retrieval.  Embeddings
    equal the reference's ``HashEncoder`` for the same config and seed.
    ``device`` is where its callers' device work runs (the store's)."""

    def __init__(self, cfg: EncoderConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = default_tokenizer(cfg.vocab_size)
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal(
            (cfg.vocab_size, cfg.embed_dim)
        ).astype(np.float32) / np.sqrt(cfg.embed_dim)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.cfg.embed_dim), np.float32)
        for i, t in enumerate(texts):
            ids = self.tokenizer.encode(t, add_specials=False)
            if ids:
                counts = np.bincount(
                    np.asarray(ids) % self.cfg.vocab_size,
                    minlength=self.cfg.vocab_size,
                ).astype(np.float32)
                v = counts @ self._proj
                out[i] = v / max(np.linalg.norm(v), 1e-9)
        return out
