"""Single-sync RAG: retrieval -> prompt assembly -> decode chained on the
device.  Counterpart of ``docqa_tpu/engines/rag_fused.py`` (``FusedRAG``,
``FusedAnswer``, ``EmptyStoreError``) on one device.

The classic ``/ask`` fetches the top-k rows (the host needs the chunk
texts to build the prompt string), then the generated tokens.  Here the
store keeps a token sidecar (``StoreConfig.token_width``): each row's chunk
tokenized with the generator's tokenizer at index time.  One chain of
kernels on the caller's stream then runs

    encode(question) -> L2 normalize -> top-k over the live rows -> gather
    the hit rows' tokens -> pack the prompt (template prefix + chunks +
    separators + question tail) -> prefill -> decode

and the generator's device-prompt entry (``GenerateEngine.generate_device``)
consumes the packed prompt where it lies: nothing between the query
encode's first launch and the prefill's last waits on the device.  The
host sizes every shape beforehand (``k``, the tail and prompt buckets,
under the store lock); the hits and the answer are fetched afterwards
(:class:`FusedAnswer`), hits first.

The pack is a gather: output position ``j`` maps to (segment, offset) by a
``searchsorted`` over the segments' cumulative lengths, so chunks of
different true lengths concatenate with no pad token inside the prompt.
A hit scoring ``NEG_INF`` (fewer live rows than ``k``: the tie indices may
point at tombstoned rows) packs zero tokens, and each chunk is capped so
the question's tail always fits the prompt bucket.

For a whitespace-pretokenized tokenizer (the hash tokenizer) the packed ids
equal ``tokenizer.encode(template.format(...))`` exactly, so the fused
answer equals the classic text path's.  The prompt bucket is larger than
the classic path's (the sidecar's full width per chunk is budgeted), so in
bf16 the padded shapes, and so the rounding, differ.

Spans ``fused_rag_pack``, ``fused_rag_generate`` and ``qa_e2e_fused``;
spine stages ``fused_rag_generate`` (the generation) and
``fused_rag_fetch`` (each fetch), as in the reference.

Over a row-sharded store (``VectorStore(mesh=)``) the search and the
sidecar gather are the reference's sharded ``_search_gather``: the store's
sharded search (two all-gathers), then each model rank gathers the hit rows
it owns from its block of the sidecar, zeroes the rest, and a sum over the
model group (two all-reduces, the reference's two psums) merges the token
rows and lengths; the packed prompt then feeds a tensor-parallel
generator's ``generate_device``.  Every rank of the mesh calls
:meth:`FusedRAG.ask` with the same question (SPMD); no shard ever holds
another's sidecar.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from docqa_tpu_torch.engines.encoder import marshal_texts
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.index.store import NEG_INF, SearchResult
from docqa_tpu_torch.runtime.mesh import all_reduce
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.utils import pick_bucket, resolve_device, round_up

TAIL_BUCKETS = (64, 128, 256)


class EmptyStoreError(RuntimeError):
    """Nothing indexed yet: the caller's fallback path owns the reply."""


def _seg_tokens(tokenizer, text: str) -> List[int]:
    """Tokenize one template segment (no CLS/SEP: the stream is one
    sequence, not a batch of sentences)."""
    return [int(t) for t in tokenizer.encode(text, add_specials=False)]


@dataclass
class _Segments:
    """The device constants of one (k, tail bucket, prompt bucket) shape."""

    k: int
    t_bucket: int
    l_bucket: int
    w_seg: int
    chunk_cap: int
    prefix_row: torch.Tensor  # [w_seg] int64
    sep_row: torch.Tensor
    prefix_len: torch.Tensor  # 0-d int64
    sep_len: torch.Tensor


class FusedAnswer:
    """A fused ask in flight: device handles of the answer and the hits.
    :meth:`resolve` fetches the hits first, then the tokens."""

    def __init__(self, rag: "FusedRAG", row_ids_dev, vals_dev, out_dev,
                 n_emitted_dev, prompt_dev=None, prompt_len_dev=None):
        self._rag = rag
        self._row_ids_dev = row_ids_dev
        self._vals_dev = vals_dev
        self._out_dev = out_dev
        self._n_dev = n_emitted_dev
        # the packed prompt stays on the device; kept for inspection (a
        # fetch of it is an extra sync, never made on the serving path)
        self._prompt_dev = prompt_dev
        self._prompt_len_dev = prompt_len_dev
        self._hits: Optional[List[SearchResult]] = None

    def _fetch(self, *tensors):
        return [
            t.numpy() for t in spine_run(
                "fused_rag_fetch", lambda: [to_host(t) for t in tensors],
                device=self._rag.device,
            )
        ]

    def prompt_tokens(self) -> List[int]:
        """The packed prompt (costs a fetch; for tests and checks)."""
        toks, n = self._fetch(self._prompt_dev[0], self._prompt_len_dev)
        return [int(t) for t in toks[: int(n[0])]]

    def hits(self) -> List[SearchResult]:
        if self._hits is None:
            vals, row_ids = self._fetch(self._vals_dev[:1], self._row_ids_dev[:1])
            self._hits = self._rag.store.assemble_results(vals, row_ids)[0]
        return self._hits

    def resolve(self) -> Dict[str, Any]:
        hits = self.hits()  # hits first, as the reference fetches
        out, n = self._fetch(self._out_dev[0], self._n_dev)
        answer = self._rag.generator.tokenizer.decode_ids(
            [int(t) for t in out[: int(n[0])]]
        )
        return {
            "answer": answer,
            "sources": [h.metadata.get("source", "") for h in hits],
        }


class FusedRAG:
    """Single-sync ask over an ``EncoderEngine``, a ``VectorStore`` with a
    token sidecar and a ``GenerateEngine``, all on ``device``.  The
    template is the QA template split at ``{context}`` / ``{question}``,
    with the generator's chat template around the whole prompt when one is
    configured."""

    def __init__(self, encoder, store, generator, template: str,
                 k: int = 3, joiner: str = "\n\n", device="cuda"):
        """On a mesh it runs on the store's device (the mesh's)."""
        self.device = (store.device if getattr(store, "mesh", None) is not None
                       else resolve_device(device))
        for name, part in (("encoder", encoder), ("store", store),
                           ("generator", generator)):
            if part.device != self.device:
                raise ValueError(
                    f"{name} on {part.device}; FusedRAG runs on {self.device}"
                )
        if not store.cfg.token_width:
            raise ValueError("FusedRAG needs StoreConfig.token_width > 0")
        self.encoder = encoder
        self.store = store
        self.generator = generator
        self.k = k
        tok = generator.tokenizer
        before, after = template.split("{context}", 1)
        mid, suffix = after.split("{question}", 1)
        # mirror encode_prompt exactly, so the fused prompt equals the text
        # path's: untemplated, encode(prompt) = head words tail; templated,
        # encode(pre) + raw + encode(post, no specials)
        chat = generator._chat_template
        if chat is None:
            # the head and tail encode() would add: the hash tokenizer
            # (no add_bos / add_eos) always wraps [CLS] ... [SEP]; a
            # tokenizer that declares them adds BOS / EOS only when the
            # flag is set and the id exists
            if not hasattr(tok, "add_bos"):
                head = [tok.cls_id]
            elif tok.add_bos and tok.bos_id is not None:
                head = [tok.bos_id]
            else:
                head = []
            if not hasattr(tok, "add_eos"):
                self._tail_extra: List[int] = [tok.sep_id]
            elif tok.add_eos and tok.eos_id is not None:
                self._tail_extra = [tok.eos_id]
            else:
                self._tail_extra = []
            self._prefix = head + _seg_tokens(tok, before)
        else:
            pre, _, post = chat.partition("{prompt}")
            self._prefix = [int(t) for t in tok.encode(pre)] + _seg_tokens(tok, before)
            self._tail_extra = _seg_tokens(tok, post)
        self._sep = _seg_tokens(tok, joiner)
        self._mid = mid  # tokenized with the question at ask time
        self._suffix = suffix
        self._segments: Dict[Tuple[int, int, int], _Segments] = {}

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device, from pinned memory on a card, so the copy
        queues on the stream without a host wait."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _segments_for(self, k: int, t_bucket: int, l_bucket: int) -> _Segments:
        key = (k, t_bucket, l_bucket)
        seg = self._segments.get(key)
        if seg is None:
            W = self.store.cfg.token_width
            w_seg = max(W, len(self._prefix), len(self._sep), t_bucket, 1)
            # the per-chunk budget: the template and the question are not
            # negotiable, the chunks absorb the squeeze when the prompt
            # bucket is clamped by max_seq_len - max_new
            chunk_cap = max(
                0,
                (l_bucket - len(self._prefix) - (k - 1) * len(self._sep) - t_bucket)
                // k,
            )

            def row(ids):
                r = np.zeros((w_seg,), np.int64)
                r[: len(ids)] = ids
                return torch.from_numpy(r).to(self.device)

            seg = _Segments(
                k=k, t_bucket=t_bucket, l_bucket=l_bucket, w_seg=w_seg,
                chunk_cap=chunk_cap,
                prefix_row=row(self._prefix), sep_row=row(self._sep),
                prefix_len=torch.tensor(len(self._prefix), device=self.device),
                sep_len=torch.tensor(len(self._sep), device=self.device),
            )
            self._segments[key] = seg
        return seg

    def _pack(self, seg: _Segments, q_ids, q_len, buf, count, tok, tok_len,
              tail, mask):
        """The device chain from the query ids to the packed prompt:
        (prompt [1, l_bucket] int64, length [1] int64, vals [1, k],
        row ids [1, k]).  Every shape is fixed on the host beforehand, so
        nothing here waits on the device."""
        k, W = seg.k, self.store.cfg.token_width
        if buf.is_cuda:
            # an add or a compaction on another stream may swap in new
            # tensors meanwhile: the allocator must not reuse these before
            # this stream's reads of them are done
            stream = torch.cuda.current_stream(buf.device)
            for t in (buf, tok, tok_len):
                t.record_stream(stream)
        emb = self.encoder.encode_ids(q_ids, q_len)
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        vals, row_ids, hit_toks, hit_lens = self._search_gather(
            buf, emb.to(buf.dtype), count, tok, tok_len, mask, k)
        chunk_toks = F.pad(hit_toks.long(), (0, seg.w_seg - W))
        # under-fill guard: with fewer than k live rows, top-k pads with
        # NEG_INF ties whose ids may be tombstoned rows; they pack nothing
        chunk_lens = torch.where(
            vals[0] > NEG_INF / 2, hit_lens.long(), 0
        ).clamp(max=seg.chunk_cap)
        tail_ids, tail_len = tail[: seg.t_bucket], tail[seg.t_bucket]
        seg_rows, seg_lens = [seg.prefix_row], [seg.prefix_len]
        for i in range(k):
            seg_rows.append(chunk_toks[i])
            seg_lens.append(chunk_lens[i])
            if i < k - 1:
                seg_rows.append(seg.sep_row)
                seg_lens.append(seg.sep_len)
        seg_rows.append(F.pad(tail_ids, (0, seg.w_seg - seg.t_bucket)))
        seg_lens.append(tail_len)
        seg_toks = torch.stack(seg_rows)  # [n_seg, w_seg]
        lens = torch.stack(seg_lens)
        bounds = lens.cumsum(0)
        starts = bounds - lens
        total = bounds[-1:].clamp(max=seg.l_bucket)
        j = torch.arange(seg.l_bucket, device=self.device)
        seg_idx = torch.searchsorted(bounds, j, right=True).clamp(
            0, len(seg_rows) - 1
        )
        within = (j - starts[seg_idx]).clamp(0, seg.w_seg - 1)
        toks = seg_toks[seg_idx, within]
        prompt = torch.where(j < total, toks, self.generator.gen.pad_id)[None, :]
        return prompt, total, vals, row_ids

    def _search_gather(self, buf, q, count, tok, tok_len, mask, k):
        """(vals [1, k], row ids [1, k], the hits' sidecar tokens [k, W]
        and lengths [k]).  Sharded: the store's sharded search, each model
        rank's owned hit rows from its sidecar block (zeros elsewhere), and
        a sum over the model group (module docstring)."""
        store = self.store
        vals, row_ids = store.search_rows(buf, q, count, k, mask)
        n_local = tok.shape[0]
        if store.mesh is None or store.mesh.n_model == 1:
            rows = row_ids[0].clamp(0, n_local - 1)
            return vals, row_ids, tok[rows], tok_len[rows]
        local = row_ids[0] - store.mesh.model_index * n_local
        owned = (local >= 0) & (local < n_local)
        safe = local.clamp(0, n_local - 1)
        group = store.mesh.model_group
        toks = all_reduce(torch.where(owned[:, None], tok[safe], 0), group, "fused_rag")
        lens = all_reduce(torch.where(owned, tok_len[safe], 0), group, "fused_rag")
        return vals, row_ids, toks, lens

    def ask_submit(self, question: str,
                   max_new_tokens: Optional[int] = None) -> FusedAnswer:
        gen = self.generator
        store = self.store
        max_new = max_new_tokens or gen.gen.max_new_tokens
        q_ids, q_len = marshal_texts(
            self.encoder.tokenizer, self.encoder.cfg, [question],
            batch_buckets=(1,), n_data=getattr(self.encoder, "n_data", None),
        )
        tail = (
            _seg_tokens(gen.tokenizer, self._mid + question + self._suffix)
            + self._tail_extra
        )
        t_bucket = pick_bucket(max(len(tail), 1), TAIL_BUCKETS)
        tail_arr = np.zeros((t_bucket + 1,), np.int64)  # ids, then the length
        tail_arr[: min(len(tail), t_bucket)] = tail[:t_bucket]
        tail_arr[t_bucket] = min(len(tail), t_bucket)
        W = store.cfg.token_width
        usable = gen.cfg.max_seq_len - max_new
        l_need = len(self._prefix) + self.k * W + (self.k - 1) * len(self._sep) + t_bucket
        buckets = gen.gen.prefill_buckets
        l_bucket = min(
            pick_bucket(l_need, buckets) if l_need <= buckets[-1]
            else round_up(l_need, 128),
            usable,
        )
        # one consistent view: rows below the count never change until a
        # compaction, which swaps in new tensors
        with store._lock:
            buf, count, mask = store.search_view(None)
            tok, tok_len = store.token_sidecar()
        if count == 0:
            raise EmptyStoreError("empty store: nothing to retrieve")
        seg = self._segments_for(min(self.k, count), t_bucket, l_bucket)
        # every upload queued before the chain's first launch
        args = (
            self._upload(q_ids), self._upload(q_len), buf, count, tok, tok_len,
            self._upload(tail_arr),
            None if mask is None else self._upload(mask),
        )
        with span("fused_rag_pack", DEFAULT_REGISTRY), torch.inference_mode():
            prompt, total, vals, row_ids = self._pack(seg, *args)
        # a per-request seed (temperature > 0) minted outside the item
        seed = 0 if gen.gen.temperature == 0.0 else gen.next_request_seed()

        def _generate_on_device():
            return gen.generate_device(
                prompt, total, max_new, gen.gen.temperature, seed
            )

        with span("fused_rag_generate", DEFAULT_REGISTRY):
            out, n_emitted = spine_run(
                "fused_rag_generate", _generate_on_device, device=self.device
            )
        return FusedAnswer(
            self, row_ids, vals, out, n_emitted,
            prompt_dev=prompt, prompt_len_dev=total,
        )

    def ask(self, question: str,
            max_new_tokens: Optional[int] = None) -> Dict[str, Any]:
        with span("qa_e2e_fused", DEFAULT_REGISTRY):
            return self.ask_submit(question, max_new_tokens).resolve()
