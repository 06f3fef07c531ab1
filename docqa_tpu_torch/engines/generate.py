"""Solo decode engine: bucketed prefill, then a decode loop over the KV
cache.  Counterpart of ``docqa_tpu/engines/generate.py`` (GenerateEngine
without the batcher hooks or the memory probe).

On a mesh (``mesh=``, ``runtime/mesh.py``) the engine serves a Megatron
tensor-parallel decoder: the weights are sharded at construction
(``parallel/sharding.py``), the KV cache holds this rank's kv heads, every
forward all-reduces twice a layer over the model axis (the trunk) and its
vocabulary-local logits are gathered once before sampling, so every rank
of a model group draws the same token.  Lanes split over the data axis;
each data rank decodes its own with no collective inside the loop, and the
token streams, padded to a fixed width, are gathered once at the end.

The reference runs the loop on device (``lax.while_loop``); here it is a
Python loop whose only host sync per step is the all-lanes-done exit test.
Greedy decode with ``speculative_k >= 2`` (the default, K=4) runs
prompt-lookup speculation: draft K-1 tokens from a per-lane bigram table,
verify them in one forward of q_len=K, emit the matched prefix plus the
bonus token.  Every emitted token is an argmax of the model's own logits,
so the output equals plain greedy decoding.

A generation is one dispatch-spine work item (stage ``generate``: upload,
the whole loop, the fetch) inside a ``generate`` span.
:meth:`GenerateEngine.generate_device` is the device-prompt entry of the
fused RAG path: prefill and decode start from a prompt that is already on
the device, which is never copied to the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from docqa_tpu_torch import weights
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
from docqa_tpu_torch.engines.spine import spine_run, to_host
from docqa_tpu_torch.models import quant
from docqa_tpu_torch.models.decoder import (
    KVCache,
    Params,
    decoder_forward,
    init_kv_cache,
)
from docqa_tpu_torch.ops.sampling import sample
from docqa_tpu_torch.parallel.sharding import shard_decoder_params
from docqa_tpu_torch.runtime.mesh import MeshContext, all_gather
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span
from docqa_tpu_torch.text.tokenizer import Tokenizer, default_tokenizer
from docqa_tpu_torch.utils import pick_bucket, resolve_device, round_up, torch_dtype

BATCH_BUCKETS = (1, 2, 4, 8, 16)

CHAT_TEMPLATES = {
    "mistral-inst": "[INST] {prompt} [/INST]",
}


def draft_tokens(table: torch.Tensor, cur: torch.Tensor, K: int) -> torch.Tensor:
    """Chained bigram drafting: K-1 draft tokens per lane from the lookup
    table (misses repeat the current token).  Returns [b, K-1]."""
    drafts = []
    tok = cur
    for _ in range(K - 1):
        nt = torch.gather(table, 1, tok[:, None])[:, 0]
        tok = torch.where(nt < 0, tok, nt)
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


def accept_drafts(logits: torch.Tensor, drafts: torch.Tensor, eos_id: int):
    """Verify-step acceptance: greedy targets ``g`` [b, K], accepted-draft
    count ``m``, the emission-candidate mask (g0..gm), EOS hits among the
    candidates, and the first-EOS position (K = none)."""
    K = logits.shape[1]
    karange = torch.arange(K, device=logits.device)[None, :]
    g = torch.argmax(logits, dim=-1)  # [b, K]
    match = (drafts == g[:, :-1]).long()
    m = torch.cumprod(match, dim=1).sum(dim=1)  # accepted drafts
    cand = karange <= m[:, None]
    is_eos = (g == eos_id) & cand
    eos_pos = torch.where(
        is_eos.any(dim=1), is_eos.long().argmax(dim=1), torch.full_like(m, K)
    )
    return g, m, cand, is_eos, eos_pos


class GenerateEngine:
    def __init__(
        self,
        cfg: DecoderConfig,
        gen: Optional[GenerateConfig] = None,
        params: Optional[Params] = None,
        tokenizer: Optional[Tokenizer] = None,
        seed: int = 0,
        device="cuda",
        mesh: Optional[MeshContext] = None,
    ):
        """``params``: a tree of numpy arrays or tensors with the
        reference's names; None draws the reference's seeded numpy host
        init (bit-equal to ``docqa_tpu``'s engine with the same seed).
        Floating weights are stored in ``cfg.dtype``.

        ``mesh``: serve tensor- and data-parallel (module docstring); the
        engine runs on the mesh's device and keeps this rank's shards only
        (at 1x1 the tree itself, storage and all).

        ``cfg.quantize_weights`` serves a weight-only quantised decoder
        (``cfg.quant_bits`` 8 or 4, ``models/quant.py``), as the
        reference's engine does: no ``params`` draws the reference's
        quantised host init; a float tree is quantised tensor by tensor as
        it is uploaded, from its values as given and in their own dtype,
        before the remaining float leaves take ``cfg.dtype``; a tree
        already quantised passes through.  Quantised weights and their
        scales are never cast."""
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.gen = gen or GenerateConfig()
        self.tokenizer = tokenizer or default_tokenizer(
            cfg.vocab_size, vocab_path=cfg.tokenizer_path
        )
        # a real vocabulary carries the checkpoint's own special ids: the
        # decode loop must stop on that eos, not the hash fallback's 2.
        # Only ids left at their defaults are replaced (a caller's custom
        # eos_id stays)
        tok_eos = getattr(self.tokenizer, "eos_id", None)
        tok_pad = getattr(self.tokenizer, "pad_id", None)
        if (tokenizer is not None or cfg.tokenizer_path) and tok_eos is not None:
            defaults = GenerateConfig()
            updates = {}
            if self.gen.eos_id == defaults.eos_id and tok_eos != self.gen.eos_id:
                updates["eos_id"] = int(tok_eos)
            if (self.gen.pad_id == defaults.pad_id and tok_pad is not None
                    and tok_pad != self.gen.pad_id):
                updates["pad_id"] = int(tok_pad)
            if updates:
                self.gen = dataclasses.replace(self.gen, **updates)
        if cfg.chat_template:
            resolved = CHAT_TEMPLATES.get(cfg.chat_template, cfg.chat_template)
            if "{prompt}" not in resolved:
                raise ValueError(
                    f"chat_template {cfg.chat_template!r} is neither a "
                    f"known alias ({sorted(CHAT_TEMPLATES)}) nor a format "
                    "string containing '{prompt}'"
                )
            self._chat_template: Optional[str] = resolved
        else:
            self._chat_template = None
        if params is None:
            params = (
                weights.host_init_quantized_decoder_params(cfg, seed, cfg.quant_bits)
                if cfg.quantize_weights
                else weights.host_init_decoder_params(cfg, seed)
            )
        elif cfg.quantize_weights and not quant.is_quantized(params):
            # one float tensor on the device at a time: the quantised tree
            # plus one float tensor at the peak
            params = quant.quantize_decoder_params(
                params, cfg.quant_bits, device=self.device
            )
        if mesh is not None:
            # slice on the leaves' own device, then upload the slices only
            params = shard_decoder_params(
                {k: weights.leaf_to_tensor(v) for k, v in params.items()}, cfg, mesh
            )
        self.params = weights.to_torch(params, self.device, torch_dtype(cfg.dtype))
        # the kv heads this rank's cache holds (all of them without a mesh)
        self.kv_heads = (self.params["l0_wk"].shape[-1] // cfg.head_dim
                         if cfg.num_layers else cfg.num_kv_heads)
        # timings and counts of the last generation
        self.last_stats: Dict[str, float] = {}
        self._seed = seed
        self._request_counter = itertools.count()

    def next_request_seed(self) -> int:
        """Counter-minted per-request sampling seed, ``seed * 100_003 +
        counter`` as the reference mints its keys: concurrent submitters
        get distinct seeds (``next`` on ``itertools.count`` is atomic)."""
        return self._seed * 100_003 + next(self._request_counter)

    # ---- the forward ------------------------------------------------------

    def forward(self, ids, cache, cache_lengths, **kwargs) -> torch.Tensor:
        """:func:`decoder_forward` over this engine's tree and ``cache``,
        returning logits over the whole vocabulary: on a model axis of n > 1
        the vocabulary-local logits are gathered (one ``all_gather`` a
        forward, a vocabulary that does not divide padded for it)."""
        logits = decoder_forward(self.params, self.cfg, ids, cache, cache_lengths,
                                 mesh=self.mesh, **kwargs)
        mesh = self.mesh
        if mesh is None or mesh.n_model == 1:
            return logits
        vocab = self.cfg.vocab_size
        chunk = -(-vocab // mesh.n_model)
        if logits.shape[-1] < chunk:
            logits = torch.nn.functional.pad(logits, (0, chunk - logits.shape[-1]))
        return all_gather(logits, mesh.model_group, "logits", dim=-1)[..., :vocab]

    # ---- plain decode ---------------------------------------------------

    def _generate_plain(self, ids, lengths, max_new, temperature, generator):
        b, bucket = ids.shape
        cache = self._new_cache(b, round_up(bucket + max_new, 128))
        logits = self.forward(
            ids, cache, torch.zeros_like(lengths), attn_lengths=lengths,
            last_token_only=True,
        )
        gen = self.gen
        first = sample(logits[:, -1], generator, temperature, gen.top_k, gen.top_p)
        out = torch.full((b, max_new), gen.pad_id, dtype=torch.long, device=ids.device)
        out[:, 0] = first
        done = first == gen.eos_id
        # tokens produced per lane (EOS excluded): the host trims by this
        n_emitted = (~done).long()
        self._mark_prefill()
        lengths = lengths.clone()
        step = 1
        while step < max_new and not bool(done.all()):
            logits = self.forward(out[:, step - 1 : step], cache, lengths)
            nxt = sample(logits[:, 0], generator, temperature, gen.top_k, gen.top_p)
            nxt = torch.where(done, torch.full_like(nxt, gen.pad_id), nxt)
            out[:, step] = nxt
            is_eos = nxt == gen.eos_id
            n_emitted += (~(done | is_eos)).long()
            done |= is_eos
            lengths += 1
            step += 1
            self.last_stats["forwards"] += 1
        return out, n_emitted

    # ---- speculative decoding (prompt lookup) ---------------------------

    def _build_bigram(self, ids, lengths):
        """Per-lane bigram table over the prompt: table[lane, prev] = next,
        misses -1.  One spare column (index vocab) absorbs the writes of
        padded positions, as the reference's ``mode="drop"`` does."""
        b, s = ids.shape
        vocab = self.cfg.vocab_size
        prev = ids[:, :-1]
        nxt = ids[:, 1:]
        pos = torch.arange(1, s, device=ids.device)[None, :]
        prev = torch.where(pos < lengths[:, None], prev, vocab)
        table = torch.full((b, vocab + 1), -1, dtype=torch.long, device=ids.device)
        return table.scatter_(1, prev, nxt)

    def spec_verify_step(self, cache, table, cur, lengths, *, K):
        """Draft K-1 tokens per lane, verify them in one forward of q_len=K
        (K/V rows written in place from ``lengths``), and return
        ``(g, m, cand, is_eos, eos_pos)`` from :func:`accept_drafts`."""
        drafts = draft_tokens(table, cur, K)
        verify_in = torch.cat([cur[:, None], drafts], dim=1)
        logits = self.forward(verify_in, cache, lengths, attn_lengths=lengths + K)
        return accept_drafts(logits, drafts, self.gen.eos_id)

    def confirm_bigrams(self, table, cur, g, emit_valid):
        """Record confirmed bigrams (cur, g0), (g0, g1), ... in the table,
        in place, so the answer's own phrases become draftable."""
        prev_seq = torch.cat([cur[:, None], g[:, :-1]], dim=1)
        prev_scatter = torch.where(emit_valid, prev_seq, self.cfg.vocab_size)
        table.scatter_(1, prev_scatter, g)

    def _generate_spec(self, ids, lengths, max_new, K):
        """Greedy decode with prompt-lookup speculation.  Mis-speculated
        K/V rows are never attended (``attn_lengths`` windows the fresh
        rows) and the next verify overwrites them."""
        b, bucket = ids.shape
        eos, pad = self.gen.eos_id, self.gen.pad_id
        dev = ids.device
        cache = self._new_cache(b, round_up(bucket + max_new + K, 128))
        lane = torch.arange(b, device=dev)
        karange = torch.arange(K, device=dev)[None, :]

        logits = self.forward(
            ids, cache, torch.zeros_like(lengths), attn_lengths=lengths,
            last_token_only=True,
        )
        first = torch.argmax(logits[:, -1], dim=-1)
        table = self._build_bigram(ids, lengths)
        # the (last prompt token -> first) pair is confirmed; record it
        last_prompt = ids[lane, (lengths.long() - 1).clamp(min=0)]
        table[lane, last_prompt] = first

        out = torch.full((b, max_new + K), pad, dtype=torch.long, device=dev)
        out[:, 0] = first
        done = first == eos
        n_emit = (~done).long()
        done = done | (n_emit >= max_new)
        cur = first
        lengths = lengths.clone()
        self._mark_prefill()
        while not bool(done.all()):
            g, m, cand, is_eos, eos_pos = self.spec_verify_step(
                cache, table, cur, lengths, K=K
            )
            self.last_stats["forwards"] += 1
            budget = max_new - n_emit
            emit_valid = (
                cand
                & (karange < eos_pos[:, None])
                & (karange < budget[:, None])
                & (~done)[:, None]
            )
            emitted = torch.where(emit_valid, g, torch.full_like(g, pad))
            # each lane writes its K slots at its own offset (n_emit <= max_new)
            out.scatter_(1, n_emit[:, None] + karange, emitted)
            n_valid = emit_valid.long().sum(dim=1)
            n_emit_new = n_emit + n_valid
            done_new = (
                done
                | (is_eos.any(dim=1) & (eos_pos < budget))
                | (n_emit_new >= max_new)
            )
            last_tok = emitted[lane, (n_valid - 1).clamp(min=0)]
            self.confirm_bigrams(table, cur, g, emit_valid)
            cur = torch.where(done_new | (n_valid == 0), cur, last_tok)
            lengths = torch.where(done, lengths, lengths + n_valid.int())
            n_emit, done = n_emit_new, done_new
        return out, n_emit

    # ---- helpers ----------------------------------------------------------

    def _new_cache(self, b: int, cache_len: int) -> KVCache:
        return init_kv_cache(
            self.cfg, b, max_len=cache_len,
            dtype=self.params["tok_emb"].dtype, device=self.device,
            num_kv_heads=self.kv_heads,
        )

    def _mark_prefill(self) -> None:
        self.last_stats["prefill_s"] = time.perf_counter() - self._t0
        self.last_stats["forwards"] = 1

    # ---- device-prompt entry ------------------------------------------------

    def generate_device(self, ids: torch.Tensor, lengths: torch.Tensor,
                        max_new: int, temperature: float, seed: int = 0):
        """Prefill and decode from prompts already on the device: ``ids``
        [b, L] (padded past ``lengths``), ``lengths`` [b] int32.  Greedy
        with ``speculative_k >= 2`` speculates; otherwise plain decoding
        samples with a ``torch.Generator`` seeded with ``seed``.  Returns
        (tokens [b, >= max_new], tokens emitted [b]) on the device; the
        prompt is never fetched, and nothing between the prefill's first
        launch and its last waits on the device."""
        self._t0 = time.perf_counter()
        with torch.inference_mode():
            ids, lengths = ids.long(), lengths.to(torch.int32)
            spec_k = self.gen.speculative_k
            if temperature == 0.0 and spec_k >= 2:
                return self._generate_spec(ids, lengths, max_new, spec_k)
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(seed))
            return self._generate_plain(ids, lengths, max_new, temperature, generator)

    # ---- host API ---------------------------------------------------------

    def generate_ids(
        self,
        prompts_ids: Sequence[Sequence[int]],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
    ) -> List[List[int]]:
        """Token-id prompts -> generated token ids (EOS excluded)."""
        max_new = (
            self.gen.max_new_tokens if max_new_tokens is None else max_new_tokens
        )
        temperature = (
            self.gen.temperature if temperature is None else temperature
        )
        b = len(prompts_ids)
        if b == 0 or max_new == 0:
            return [[] for _ in prompts_ids]
        usable = self.cfg.max_seq_len - max_new
        if usable < 1:
            raise ValueError(
                f"max_new_tokens={max_new} leaves no prompt room within "
                f"max_seq_len={self.cfg.max_seq_len}"
            )
        longest = max(len(p) for p in prompts_ids)
        bucket = min(
            pick_bucket(longest, self.gen.prefill_buckets)
            if longest <= self.gen.prefill_buckets[-1]
            else round_up(longest, 128),
            usable,
        )
        # pad the batch to a bucket and to a multiple of the data axis;
        # dummy lanes get length-1 prompts and their outputs are dropped
        b_pad = pick_bucket(b, BATCH_BUCKETS) if b <= BATCH_BUCKETS[-1] else b
        if self.mesh is not None:
            b_pad = round_up(b_pad, self.mesh.n_data)
        ids = np.full((b_pad, bucket), self.gen.pad_id, np.int64)
        lengths = np.ones((b_pad,), np.int32)
        for i, p in enumerate(prompts_ids):
            p = list(p)[-bucket:]  # keep the tail on overflow
            ids[i, : len(p)] = p
            lengths[i] = max(len(p), 1)

        lanes = slice(None) if self.mesh is None else self.mesh.data_lanes(b_pad)

        def _generate_on_device():
            """The device phase (one spine work item): upload, the whole
            generation of this data rank's lanes, the gather of every data
            rank's streams, and the start of the copy to the host."""
            o, n = self.generate_device(
                torch.from_numpy(ids[lanes]).to(self.device),
                torch.from_numpy(lengths[lanes]).to(self.device),
                max_new, temperature, seed,
            )
            if self.mesh is not None and self.mesh.n_data > 1:
                # the streams' width is the same on every data rank
                both = all_gather(torch.cat([o, n[:, None].to(o.dtype)], dim=1),
                                  self.mesh.data_group, "generate")
                o, n = both[:, :-1], both[:, -1]
            return to_host(o[:b]), to_host(n[:b])

        with span("generate", DEFAULT_REGISTRY):
            out, n_emitted = spine_run(
                "generate", _generate_on_device, device=self.device
            )
        out, n_emitted = out.numpy(), n_emitted.numpy()
        total_s = time.perf_counter() - self._t0
        self.last_stats.update(
            prefill_tokens=int(lengths[:b].sum()),
            decode_tokens=int(max(int(n_emitted.sum()) - b, 0)),
            decode_s=total_s - self.last_stats["prefill_s"],
            total_s=total_s,
        )
        return [
            [int(t) for t in row[:count]]
            for row, count in zip(out, n_emitted)
        ]

    def format_prompt(self, prompt: str) -> str:
        """Apply the configured instruction template (``str.replace``, so
        braces in clinical text never raise)."""
        if self._chat_template is None:
            return prompt
        return self._chat_template.replace("{prompt}", prompt)

    def encode_prompt(self, prompt: str, budget: int) -> List[int]:
        """Tokenize with the chat template applied, truncation-safe: the
        RAW prompt is tail-trimmed to what the budget leaves after the
        template's own tokens, then wrapped."""
        if self._chat_template is None:
            return self.tokenizer.encode(prompt)
        pre, _, post = self._chat_template.partition("{prompt}")
        pre_ids = list(self.tokenizer.encode(pre))
        post_ids = (
            list(self.tokenizer.encode(post, add_specials=False))
            if post
            else []
        )
        room = max(1, budget - len(pre_ids) - len(post_ids))
        raw = list(self.tokenizer.encode(prompt, add_specials=False))[-room:]
        return pre_ids + raw + post_ids

    def generate_texts(
        self,
        prompts: Sequence[str],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
    ) -> List[str]:
        """Text prompts -> generated text (hash tokenizer: ``w<id>`` words)."""
        budget = self.gen.prefill_buckets[-1]
        prompt_ids = [self.encode_prompt(p, budget) for p in prompts]
        outs = self.generate_ids(prompt_ids, max_new_tokens, temperature, seed)
        return [self.tokenizer.decode_ids(ids) for ids in outs]
