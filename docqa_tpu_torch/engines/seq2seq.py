"""Serving wrapper for the BART-class summarizer (``models/seq2seq.py``),
counterpart of ``docqa_tpu/engines/seq2seq.py``.

It has what ``SummarizeEngine`` needs of a generator (``tokenizer`` and
``generate_texts``), so the synthesis service runs on either backend.
Sources are cut at their head and padded to ``SRC_BUCKETS``, batches to
``BATCH_BUCKETS``.  The policy knobs decide the decode: beam search when
``num_beams > 1`` or when ``min_length`` or ``no_repeat_ngram`` is set (one
beam is exactly greedy plus the constraints), else greedy.  A summary
batch is one dispatch-spine work item (stage ``seq2seq_generate``: upload,
encode, the whole decode loop, the copy back) inside a
``seq2seq_generate`` span; the loop reads its termination flag once every
``GenerateConfig.decode_chunk`` (16) steps.

On a mesh (``mesh=``) the weights are replicated and a batch, padded to a
multiple of the data axis, splits over it as the encoder engine's does:
each data rank decodes its sources with no collective inside the loop, and
the summaries (``[b, max_new]`` on every rank) are gathered once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from docqa_tpu_torch import weights
from docqa_tpu_torch.config import GenerateConfig, Seq2SeqConfig
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.models.seq2seq import (
    Params,
    beam_summarize,
    greedy_summarize,
    serving_params,
)
from docqa_tpu_torch.runtime.mesh import MeshContext, all_gather
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.text.tokenizer import Tokenizer, default_tokenizer
from docqa_tpu_torch.utils import pick_bucket, resolve_device, round_up, torch_dtype

SRC_BUCKETS = (64, 128, 256, 512, 1024)
BATCH_BUCKETS = (1, 2, 4, 8)


class Seq2SeqEngine:
    def __init__(
        self,
        cfg: Seq2SeqConfig,
        params: Optional[Params] = None,
        tokenizer: Optional[Tokenizer] = None,
        seed: int = 0,
        device="cuda",
        mesh: Optional[MeshContext] = None,
    ) -> None:
        """``params``: a tree with the reference's names (numpy arrays, or
        tensors from ``load_hf_bart_weights``), kept in its own dtypes; None
        draws the reference's seeded host init, stored in ``cfg.dtype`` as
        the reference stores it.  ``last_stats`` holds the last batch's
        decode ``steps`` and host ``flag_reads``.  ``mesh``: split batches
        over its data axis on the mesh's device (module docstring)."""
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.tokenizer = tokenizer or default_tokenizer(
            cfg.vocab_size, vocab_path=cfg.tokenizer_path
        )
        if params is None:
            tree = weights.to_torch(
                weights.host_init_seq2seq_params(cfg, seed), self.device,
                torch_dtype(cfg.dtype),
            )
        else:
            tree = weights.seq2seq_params_to_torch(params, cfg, self.device)
        self.params = serving_params(tree, cfg)
        # the decode loop reads its termination flag once a chunk, as the
        # batcher fetches once a chunk
        self.check_every = GenerateConfig().decode_chunk
        self.last_stats: Dict[str, int] = {}

    def policy(self) -> dict:
        """The effective decode policy: the config's knobs, None read as
        the engine defaults (greedy, no constraint, length penalty 1)."""
        cfg = self.cfg
        return {
            "n_beams": cfg.num_beams if cfg.num_beams is not None else 1,
            "length_penalty": (
                cfg.length_penalty if cfg.length_penalty is not None else 1.0
            ),
            "min_length": cfg.min_length if cfg.min_length is not None else 0,
            "no_repeat_ngram": (
                cfg.no_repeat_ngram if cfg.no_repeat_ngram is not None else 0
            ),
        }

    def summarize_device(self, ids: torch.Tensor, lengths: torch.Tensor,
                         max_new: int):
        """[b, s] source ids and [b] lengths on the device -> (tokens [b,
        max_new], tokens emitted [b]) on the device, by the policy's
        route."""
        pol = self.policy()
        stats: Dict[str, int] = {}
        self.last_stats = stats
        with torch.inference_mode():
            if pol["n_beams"] > 1 or pol["min_length"] > 0 or pol["no_repeat_ngram"] >= 1:
                return beam_summarize(
                    self.params, self.cfg, ids, lengths, max_new=max_new,
                    check_every=self.check_every, stats=stats, **pol,
                )
            return greedy_summarize(
                self.params, self.cfg, ids, lengths, max_new=max_new,
                check_every=self.check_every, stats=stats,
            )

    def generate_ids(
        self,
        src_ids: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
    ) -> List[List[int]]:
        """Source token ids -> summary ids (EOS excluded)."""
        max_new = (
            self.cfg.max_tgt_len - 1
            if max_new_tokens is None  # an explicit 0 means no tokens
            else min(max_new_tokens, self.cfg.max_tgt_len - 1)
        )
        b = len(src_ids)
        if b == 0 or max_new == 0:
            return [[] for _ in src_ids]
        longest = max(1, max(len(s) for s in src_ids))
        bucket = min(
            pick_bucket(longest, SRC_BUCKETS)
            if longest <= SRC_BUCKETS[-1]
            else round_up(longest, 128),
            self.cfg.max_src_len,
        )
        b_pad = pick_bucket(b, BATCH_BUCKETS) if b <= BATCH_BUCKETS[-1] else b
        if self.mesh is not None:
            b_pad = round_up(b_pad, self.mesh.n_data)
        ids = np.full((b_pad, bucket), self.cfg.pad_id, np.int64)
        lengths = np.ones((b_pad,), np.int32)
        for i, s in enumerate(src_ids):
            s = list(s)[:bucket]  # summarization keeps the source's head
            ids[i, : len(s)] = s
            lengths[i] = max(len(s), 1)

        lanes = slice(None) if self.mesh is None else self.mesh.data_lanes(b_pad)

        def _summarize_on_device():
            """The device phase: upload, encode, the decode loop of this
            data rank's sources, the gather over the data axis, and the
            start of the copy to the host."""
            o, n = self.summarize_device(
                torch.from_numpy(ids[lanes]).to(self.device),
                torch.from_numpy(lengths[lanes]).to(self.device), max_new,
            )
            if self.mesh is not None and self.mesh.n_data > 1:
                both = all_gather(torch.cat([o, n[:, None].to(o.dtype)], dim=1),
                                  self.mesh.data_group, "seq2seq")
                o, n = both[:, :-1], both[:, -1]
            return to_host(o[:b]), to_host(n[:b])

        with span("seq2seq_generate", DEFAULT_REGISTRY):
            out, n_emitted = spine_run(
                "seq2seq_generate", _summarize_on_device, device=self.device
            )
        return [
            [int(t) for t in row[:count]]
            for row, count in zip(out.numpy(), n_emitted.numpy())
        ]

    def generate_texts(
        self,
        prompts: Sequence[str],
        max_new_tokens: Optional[int] = None,
    ) -> List[str]:
        src = [self.tokenizer.encode(p) for p in prompts]
        outs = self.generate_ids(src, max_new_tokens)
        return [self.tokenizer.decode_ids(ids) for ids in outs]
