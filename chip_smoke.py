#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (docqa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each of which fails the run on any error (nothing is caught):

1. build: print the card's name and power limit, build every CUDA kernel
   from ``docqa_tpu_torch/csrc`` (one nvcc per source, started together)
   and print each kernel's registers and spills.
2. kernels: call the flash wrapper on the card at the shapes the /ask path
   gives it, at a 4K-token prompt and at Llama-3-8B's 8K-token unwindowed
   prefill (32 q / 8 kv heads of 128), hold the result against the plain
   PyTorch version on the same inputs (bf16: the decode or prefill
   tensor-core path; float32: the SIMT path), and time the kernel, the
   first port's SIMT kernel on the same bf16 inputs, the plain version,
   the library yardstick (masked, and over the live slice where that is
   expressible) and the roofline bound.  K1's paged mode (the batcher's
   verify step through a block table: 8 and 16 lanes, K=4, shuffled blocks
   with holes, idle lanes) is held against its plain version too, and
   timed beside gather + masked SDPA and the reference's TPU route, gather
   + K1's contiguous decode path.  The trained NER tagger's window batches
   (about 140 windows for 32 notes, and the pipeline's ~36 for 8, of up to
   128 rows, 8 heads of 32) are prefill cases, and BART-large-cnn's three
   attentions on phase 13's path (16 heads of 64) are cases too: the
   encoder over 8 sources in the 1,024 bucket (``prefill``, not causal),
   the cross-attention of 32 beam lanes over them and the self-attention
   over the 143-row cache (``decode``, not causal and causal).
3. main path: /ask end to end through ``QAService.ask`` at full width —
   MiniLM-L6 encoder, a 1,000,000-row bf16 store, Mistral-7B-width decoder
   in bf16 with random seeded weights, greedy with K=4 speculation — with
   the launch counters reset just before and read just after; every verify
   step must go through the split-kv kernel, every prefill and encoder
   call through the wgmma kernel.
4. reference: the same path at a tiny float32 width on the card (kernels)
   and on the CPU (plain versions) must give the same answers.
5. main path through the continuous batcher: phase 3's service rewired to
   a ``ContinuousBatcher`` (8 slots, paged KV pool, prefix cache, K=4);
   two rounds of eight concurrent /ask; every verify step's attention on
   K1's paged mode (launches = 32 layers x verify steps), at least one
   warm prefix admission, no leaked block after the drain; one prompt
   submitted alone gives first-step logits (taken from the batcher's own
   prefill dispatch) within ``FIRST_STEP_RTOL`` of the solo engine's, and
   the batcher delivers their argmax.
6. main path through the replica pool: phase 3's service over
   ``EnginePool(PoolConfig(replicas=2, n_slots=16), QoSConfig())`` with the
   decoder breaker and ``ResilienceConfig`` (every /ask under a 60 s
   deadline).  A1 (reported): round A's asks through one replica.  Two
   prompts at once, one on each replica, give first-step logits within
   ``FIRST_STEP_RTOL`` of solo's.  A: 16 concurrent /ask, none degraded,
   both replicas routed, decode_paged launches = 32 x the pool's verify
   steps, blocks after the drain = the prefix caches' pins.  B: a worker crash injected mid-round;
   every answer generated or degraded ``replica_died``, no waiter hangs,
   the replica rebuilt healthy within ``REBUILD_LIMIT_S``, reserved memory
   within one replica pool.  C: a rolling restart under 8 /ask drops and
   degrades nothing.  D: a 1-replica pool with preemption on, sized to hold
   eight batch requests, takes four interactive /ask: at least one
   preemption, nothing degraded, every batch request completes with its
   earlier tokens kept, no block leaked.  E: a decoder outage degrades
   ``decoder_error`` until the breaker trips, then ``decoder_breaker_open``;
   after the outage and the breaker's reset a plain answer comes back.
7. ingest: ``DocumentPipeline`` over phase 3's encoder and store with the
   NER tagger at ``NERConfig()`` that phase 11 (a) trained (bf16, loaded
   from its cache and windowed at 128 tokens, as the runtime boots it), the
   in-memory broker and a SQLite registry.  512 generated notes (8 .docx,
   8 .pdf) with header PHI go up; each reaches INDEXED; the registry's
   chunk counts, the store's new rows and ``chunk_text`` over the masked
   texts agree; no header phone, email or date reaches the store.  The
   tagger batches the deid worker served are tapped: those of its most
   served shape, until they hold 64 documents, give the same masked texts
   as the port on the CPU in float32 but in documents holding a word whose
   label or side of the 0.8 threshold differs between the card's logits
   and the CPU's (the card's logits replayed through the host's span logic
   give its masked texts exactly), and their served logits, like those of
   the 32-note batch, are within ``FIRST_STEP_RTOL`` of the CPU's with word
   labels equal but for tied words.  32 new rows find
   themselves first over the whole store; an /ask over an ingested chunk
   cites its document; K1 launches = 4 x tagger forwards + 6 x encoder
   forwards, all on the prefill path.  Reported: a ``deidentify_batch`` of
   32 notes, docs/s, upload -> INDEXED, the stage spans, and 8 /ask through
   a 1-replica pool alone and beside 64 more uploads.

8. obs: phase 6's 1-replica pool takes round A1 (16 /ask, 64 new tokens)
   three times with the flight recorder off and three times on,
   alternating, each /ask under its own trace and cost record as the
   reference app opens them (the median difference and its spread are
   reported against the reference's 2 % budget, not asserted).  Over the
   last traced round: every trace complete with the expected spans; the
   observatory's peak names the card; ``serve_prefill_fetch`` and
   ``serve_decode_chunk`` costed on every call; no MFU above 1; every
   spine item's device time within its submit-to-done wall time; the cost
   ledger's per-class device ms equal to the spine's series; K1's launch
   identity.  A ``torch.profiler`` window around at least four verify
   steps names K1's decode kernel, and each decode chunk fetched in it
   launched kernels whose CUPTI time is nonzero and within the chunk's
   CUDA-event span; a telemetry tick over the pool, the
   spine, a broker and the recorder renders lint-clean Prometheus text;
   one upload through a pipeline configured as phase 7's leaves a
   timeline of extract, deid and index spans.  Prints the attribution
   table, the per-stage MFU table, the recorder numbers and what a spine
   item pays to cross to a lane thread beside a busy Python thread.

9. the app: ``DocQARuntime`` under the default ``Config`` (the decoder at
   Mistral-7B width sharing phase 3's seeded card weights, ``ner.params_path``
   the tagger cache of phase 11 (a), which the boot loads, and a 120 s /ask
   budget in place of 8 s, since a 256-token answer
   outlasts 8 s at the port's decode speed) behind its stdlib HTTP front on
   127.0.0.1, driven over real HTTP with ``urllib.request``, every JSON
   answer held to ``api_contract.json`` (the smoke's copy of the reference's
   validator): 16 generated notes (2 .docx, 2 .pdf, multipart) and two
   lookup documents of ``data/routing_mix.jsonl`` up through ``/ingest/``
   until INDEXED; patient snippets return only the asked patient's rows;
   ``/api/llm/summarize`` and both syntheses at once; one decoded /ask alone
   whose served first-step logits (a tap on the batcher's ragged prefill)
   are within ``FIRST_STEP_RTOL`` of phase 3's solo engine on the same
   prompt; 8 concurrent decoded /ask with K1's paged decode launched; the
   two routed lookups answered with no decode launch; one /ask/stream whose
   deltas concatenate to its final answer; a DELETE after which no answer
   cites the document; /metrics lint-clean, /api/costs, /api/traces.
   Reported: /ask p50/p95 and tokens/s over HTTP, the routed latency,
   /ingest/ docs/s against phase 7's, the front's cost (the same routed
   /ask in process and over HTTP), peak device memory, and whether batch
   work is deferred once the /ask rounds burn the default SLO.  Then
   ``python -m docqa_tpu_torch.service.app`` is started as a user starts it
   (default config with ``ner.params_path`` the same cache, Mistral-7B
   width) and must serve
   an upload and an /ask and exit 0 on SIGTERM; and a tiny runtime (float32
   encoder and tagger, bf16 decoder behind a pool) must retrieve, route and
   cite the same on the card and the CPU, its decoded answers equal but
   for a tie (``decoded_tie_check``).

10. the store's lifecycle and the single-sync /ask, run after phase 9's
   HTTP rounds and before its module and tiny-runtime checks (which need
   phase 3's weights freed): (a) phase 3's 1,000,000 rows in a store with
   a 128-token sidecar (the notes' own tokens; each filler row a text of a
   seeded pool, kept as its text so both paths read the same words);
   ``FusedRAG`` behind ``QAService``: for each of the four questions no
   synchronising call from the query encode's first launch to the
   prefill's last (``torch.cuda.set_sync_debug_mode("error")`` around that
   window, after a control ``.item()`` shows the mode raises), the packed
   prompt ids and the hits equal the classic path's, the fused prefill's
   first-step logits within ``FIRST_STEP_RTOL`` of the solo engine's on
   the classic prompt and the delivered token their argmax, K1's launches
   = encoder layers + decoder layers on the prefill path and decoder layers
   x verify steps on the decode path; then 8 alternating fused and classic
   /ask alone (both p50s reported).  (b) That store snapshotted and
   restored through the native DNS1 codec (write and restore seconds and
   bytes reported): rows, sidecar, metadata and version equal, the four
   questions' top-10 ids equal.  (c) Phase 9's runtime with
   ``data.work_dir`` and ``store.token_width=128`` over HTTP: 16 uploads,
   a fused /ask alone, stop and boot again (count, version, registry rows
   and the /ask's sources equal); two more uploads then a kill without the
   final snapshot: on the next boot they read ``ERROR_INDEXING``; a DELETE
   keeps one predecessor snapshot, an erasure none.

11. training, in two parts.  (a) runs after phase 6 and before phase 7, so
   that phases 7-10 serve the tagger it trains: ``DeidEngine.trained
   (NERConfig())`` with no cache, the default config's boot path, trains
   the tagger at full width (4 layers, hidden 256, 8 heads, float32 master
   weights, bf16 forward) for 1500 steps at batch 32, seq 128, lr 2e-3 in
   a child process on the card and caches it; the child's loss every 100
   steps, the wall time and the host's share of a step (datagen against
   the device step, timed apart over 50 steps) are printed; an in-process
   5-step ``train_ner`` launches K1 0 times; the trained tagger clears the
   reference's floors (``tests/test_ner_training.py``: ``evaluate_ner``
   F1 >= 0.8, ``evaluate_deid`` and ``evaluate_deid_split`` at threshold
   0.5), reported at 0.8 too, with K1 launched in the evaluation.  (b)-(d)
   run last, once phase 3's weights are freed: (b) ``make_train_step`` at
   Mistral-7B width cut to 2 layers (0.7 B float32 params; full depth
   needs ~116 GB of state) takes 20 remat steps on one ragged 4 x 512
   batch, whose loss must fall, remat on and off agreeing at the first
   step (ms a step, tokens/s and peak memory printed); (c) ``train_encoder``
   at MiniLM width, 60 steps of 16 synthetic pairs: the first batch's loss
   falls, held-out recall@1 on 8 pairs does not, and the trained encoder's
   embeddings through K1 match the plain attention's; (d) (b) saved at
   step 10 by ``TrainCheckpointer``, restored into a fresh state, 5 more
   steps give the uninterrupted run's losses, and ``max_to_keep`` prunes.

12. tiered retrieval, run after phase 10 and before phase 9's module and
   tiny-runtime checks: (a) a 1,000,000 x 384 bf16 store of phase 3's 20
   encoded notes and 999,980 clustered rows (4,096 seeded centres, noise
   0.35 x sqrt(32/384) a dimension: the reference tests' recipe at d=384;
   uniform rows are IVF's degenerate case), its int8 IVF tier built by
   ``TieredIndex.rebuild()`` at the default config (nprobe 8, n_assign 2),
   ``index_bytes``, the spill and the build's split printed; (b) recall@10
   against the exact store (tie rule, Wilson intervals) at nprobe 2-32 over
   256 perturbed rows and the four questions, tiered against exact
   ``search_texts`` latency (batch 1 and 16, alternating pairs, host and
   CUDA-event ms), the plain IVF probe (q 16, nprobe 8) and the plain
   lexical scoring (1M rows) against their byte bounds; (c) 1,000 fresh
   rows each first for its own vector, then a tail past a lowered
   ``rebuild_tail_rows`` rebuilds in the background while the questions
   keep being served; (d) ``QAService`` over the tier and a 1-replica pool
   at Mistral-7B width: the four questions, none degraded, sources equal to
   the exact path's (tie rule), K1's launch identity, the retrieval
   observatory (every retrieval sampled) drained into a ``tiered_fused@
   nprobe=8`` estimate, frontier rows and the recall SLO's counters; (e)
   phase 9's runtime with ``store.serving_index="tiered"`` over HTTP, an
   /ask with the tier's default mode dense, then hybrid, and
   ``/api/retrieval`` the running observatory's; (f) a tiny float32 tier
   gives the same dense and hybrid top-k on the card and the CPU.
13. checkpoints and the seq2seq summarizer, run last (it needs phase 11
   (a)'s tagger and the memory of the freed phases): (a) BART-large-cnn
   at full width and depth (406 M parameters) from the port's seeded host
   init, written as an HF directory (config.json with the shipped policy:
   4 beams, length penalty 2.0, min length 56, no repeated trigram, forced
   BOS; a 1.63 GB float32 ``model.safetensors`` by this script's writer; a
   byte-level BPE ``tokenizer.json`` built from the notes), read back
   through ``load_checkpoint_dir`` (every leaf equal to the written one in
   its serving dtype), then 8 generated notes summarised as one batch (32
   beam lanes, 142 new tokens) and 1 greedy (``num_beams=1`` over the
   shipped 4): K1 launched 12 times on ``prefill`` an encode and 24 times
   on ``decode`` a decoder step, the termination flag read at most
   ceil(steps / 16) + 1 times; wall, ms a step, tokens/s, peak memory and
   the host's share of a step printed; (b) a float32 BART at the reference
   test's widths gives identical greedy and beam-4 tokens on the card and
   the CPU; (c) phase 3's MiniLM weights as a ``bert`` directory with a
   WordPiece ``vocab.txt``: the 20 notes' embeddings bit-equal to phase 3's
   encoder's on the same ids; (d) a Mistral-7B-layout decoder at 2 of 32
   layers in two bf16 shards with a metaspace BPE ``tokenizer.json``:
   first-step logits bit-equal to an engine built from the same tree, a
   64-token greedy answer through the real vocabulary; (e)
   ``DocQARuntime`` under the default config with the three directories
   and ``summarizer.backend="seq2seq"``: boots with the ``checkpoint``
   breaker on ``/api/status``, 4 uploads, an /ask and a patient synthesis
   over HTTP, the synthesis through one ``seq2seq_generate`` item and no
   paged decode.
14. the quantised decoder, (a)-(c) after phase 12 (they need phase 3's
   weights), (d) inside phase 13 (it needs its Mistral directory): (a) K4
   (``csrc/qmatmul.cu``) alone at the five Mistral-7B projection shapes at
   4, 16, 32, 64 and 2,048 rows, int8 and (but ``lm_head``) int4, and at
   Llama-3-8B's ``lm_head`` [4,096 x 128,256] int8 at 4 and 2,048 rows, each
   case's kernel mode and launch printed, against its plain version at the
   bf16 tolerance, bit for bit on one-hot rows and run to run, timed beside
   the plain version, ``torch.matmul`` on the unquantised bf16 weight and
   the int-weight library call where the card's torch has one, with its
   byte / operation bound, and the host's cost of a product; the reference's quantised-forward criteria asserted where they
   were set (a float32 model of hidden 64, vocabulary 256, 2 layers) with
   K4 under the quantised side; (b) phase 3's bf16 tree
   quantised on the card tensor by tensor, int8 then int4: tree bytes,
   seconds and what quantising held beyond the tree; every quantised leaf
   within its dequantisation bound of its bf16 weight; first-step logits of
   the four questions' prompts against the bf16 engine at 32 layers and at
   2 (max|d|/std and the argmax, printed beside bf16's own gap to float32
   and the scheme's in float32 at 2 layers) and against the same quantised
   tree through the plain version (within ``FIRST_STEP_RTOL``); the four questions at 64 new
   tokens, K4 launched (7 L + 1) x forwards each; (c) round A1's shape
   through a 1-replica pool over the int8 engine (p50, tok/s, verify
   steps, device ms a step beside phase 6's bf16 A1), K4 launches
   (7 L + 1) x the forwards the batcher dispatched, warm-ups included;
   (d) ``DocQARuntime`` with ``decoder.checkpoint_dir`` the 2-layer
   Mistral directory and ``decoder.quantize_weights`` at ``quant_bits`` 8
   and 4: the tree bit-equal to ``quantize_decoder_params`` of the carried
   tree, the boot's peak memory, an /ask over HTTP not degraded.  AMQP is
   not driven: neither pika nor a broker is on the card's machine.
15. the device plane on a mesh, after phase 14 (a)-(c) (it needs phase 3's
   weights): (a) a world of one rank over NCCL (``multihost_init`` over a
   file store in a temporary directory, ``make_mesh`` -> (1, 1), a direct
   NCCL all-reduce and all-gather, the NCCL version printed); a
   ``GenerateEngine`` on that mesh over phase 3's bf16 tree (the same
   storage, checked by ``data_ptr``) answers phase 3's first question
   greedily, 64 new tokens with K = 4: ids equal phase 3's engine's bit for
   bit, K1 launches equal, 0 collectives; ``sharded_topk`` over phase 3's
   store's scores equals ``torch.topk`` (tie rule); ``ulysses_attention``
   (its attention on K1, one launch) and ``ring_attention`` at 32 / 8 heads
   x 4,096 tokens within 1e-2 + 1e-2 |plain| of the plain attention; (b)
   one rank's shard shapes at TP 1 (the row beside), 2, 4 and 8: K1's
   verify (K = 4, 233 live) and 256-token prefill at 32/n q and 8/n kv
   heads, K4 int8 and int4 at 4 and 2,048 rows on the column shards (wq,
   wk, w_gate, lm_head int8) and the row shards (wo, w_down, int4 on whole
   groups), sliced by ``parallel/sharding.py``, each held to its plain
   version and timed with its plan and bound, and the sum of one rank's
   225 products a step at m = 4 (one rank's work: no collective time).
   The phase must take at most 90 s.  Its world stays up for phase 16.
16. the runtime on a mesh, in phase 15's world of one NCCL rank: (a)
   ``DocQARuntime`` under the default config (phase 9's, over phase 3's
   tree, shared) builds the (1, 1) mesh and the leader's command stream;
   8 of phase 9's notes ingested over HTTP, then 4 generative questions one
   at a time and 4 at once, with every count from 0 around them: the
   first answer's first-step logits against the solo engine within
   ``FIRST_STEP_RTOL`` and the delivered token their argmax, the commands
   by name, every mirrored spine item (prefill round, decode chunk,
   retrieval) one published command, 0 collectives, K1's ``decode_paged``
   and ``prefill`` launched through the runtime, the /ask p50 beside phase
   9's and the mesh slot's waits; (b) K1's paged mode at one rank's kv
   heads: the table's 8-lane and 16-lane paged rows at TP 1, 2, 4 and 8
   (32/n q, 8/n kv heads), each held to its plain version within 1e-2 +
   1e-2 |plain| and timed beside gather + masked SDPA with its plan and
   bound; (c) the lexical program over ``LEX_ROWS`` rows of 32-slot tiles,
   1 query x 8 terms, split into 2, 4 and 8 row shards run in turn on the
   card and merged: ids and scores equal the whole search's (tie rule),
   each shard timed.  The phase must take at most 120 s.
17. tiered retrieval on a mesh, in phase 15's world of one NCCL rank, after
   phase 16: (a) ``DocQARuntime`` under phase 9's config with
   ``store.serving_index="tiered"`` (phase 12 (e)'s cuts), over phase 3's
   tree: phase 9's notes ingested over HTTP, then phase 12 (e)'s asks (dense
   before the tier, hybrid after it, dense over it) with every count from 0
   around them: none degraded, sources equal phase 12 (e)'s by upload index
   and in order, the tier staged and
   switched by one ``tiered.stage`` and one ``tiered.switch`` command,
   every mirrored spine item one published command, 0 collectives, each
   retrieval's encoder forward on K1 ``prefill``; then 200,000 random rows
   and 4 questions while the background rebuild covers them (none
   degraded), the commands' mesh-slot waits in that window printed, the
   rebuild's time split; (b) phase 12's 1M-row tier, kept as host arrays,
   split into 2, 4 and 8 cell shards, each uploaded and probed alone on the
   card (16 queries, nprobe 8, the shard's masking) and merged with
   ``merge_topk``: scores and ids equal the whole probe's (tie rule), each
   shard timed beside its byte bound.  The phase must take at most 120 s.
18. training on a mesh, last (after phases 11 (b)-(d), 13 and 14 (d)), in
   a world of one NCCL rank of its own: (a) on its (1, 1) mesh ``make_train_step(mesh=)`` at
   phase 11 (b)'s config (Mistral-7B width, 2 layers, float32 master
   weights, bf16 matmuls, remat) takes 5 steps on phase 11 (b)'s ragged
   4 x 512 batch, losses and params bit-equal to the mesh-less step's with
   0 collectives (under ``torch.use_deterministic_algorithms``: the
   embedding's backward adds with atomics otherwise), and
   ``make_encoder_train_step(mesh=)`` at MiniLM width the same way; the
   trained encoder's embeddings through K1 ``prefill`` against the plain
   attention's (K1 counted); the LM state through a sharded
   ``TrainCheckpointer`` save at step 4 and a restore into another tree:
   seconds and bytes, params bit-equal, the next loss the fifth's.  (b) one
   rank's shard of full-depth Mistral-7B at TP 8 and TP 4 (32/n q heads, 8/n
   kv heads, MLP 14,336/n, vocabulary 32,000/n, float32 master weights drawn
   on the card): 5 remat steps on a ragged 4 x 512 batch in the cut
   vocabulary, the loss falling; ms a step, the enqueue's share of it,
   tokens/s and peak memory beside the state's bytes reckoned at 16 B a
   parameter; one more TP-8 step under ``torch.profiler`` (device busy ms,
   idle share, activities).  One rank's work, no collective time.  The
   phase must take at most 120 s.
19. the two runtime witnesses on the card, after phase 9's module check
   (the parent holds no model weights then), in a child process (its own
   CUDA context) whose first statements install the lock witness
   (``analysis/race_witness.py``) and the ledger witness
   (``analysis/ledger_audit.py``): ``DocQARuntime`` under phase 9's config
   (Mistral-7B width, weights drawn on the card from phase 3's seed, phase
   11 (a)'s tagger) behind ``AppServer`` on 127.0.0.1 port 0; 8 of phase
   9's notes uploaded over HTTP, 8 generative /ask at once through the pool
   and the batcher with ``GET /api/witness`` and ``GET /api/ledger`` read
   while they run (200, the contract's key trees), a DELETE, then
   ``stop()``.  At quiesce: no witnessed lock-order cycle, no witnessed
   edge missing from lock-discipline's static graph, no leaked KV table,
   no unretired cost record, no witnessed site missing from resource-flow's
   static sites; K1 launched by the 8 asks, its total the sum of its
   paths.  The child prints one JSON line (edges, held-lock blocking
   events, tables and records, K1 by path, the /ask p50 under the
   witnesses, not a latency figure).  Before ``stop()`` the child runs the
   port's live wire audit (``analysis/wire_audit.py``) against that
   runtime: every route of the app driven over HTTP, ``rolling_restart``
   and the profiler included, each response validated against
   ``api_contract.json``, coverage both ways and a broker journal round
   trip; 0 violations.  The phase must take at most 120 s.
20. Llama-3-8B at full width, after phase 14 (a)-(c) and before phase 15
   (phase 3's Mistral tree is still held; both new trees are freed before
   phase 15): ``init_decoder_params(DecoderConfig.llama3_8b())`` drawn on
   the card in bf16 (8.03 B parameters: the 128,256-token vocabulary, no
   sliding window, ``rope_theta`` 500,000) and quantised int8 there as
   phase 14 (b) does; a solo ``GenerateEngine`` (64 new tokens, K = 4) on
   each tree over phase 3's encoder and store answers phase 3's first
   question.  Prints each tree's bytes, the draw and quantise seconds, the
   first-step logits int8 against bf16 (relative RMS, argmax), ms a verify
   step, decode tokens/s and K1 and K4 launches: K1 encoder layers +
   forwards x 32, K4 (7 x 32 + 1) x forwards for int8 and none for bf16.
   The phase must take at most 90 s.
21. determinism and the compile budget, last.  (a) The replay witness
   (``analysis/replay_audit.py``) at full width: two child interpreters at
   once under different ``PYTHONHASHSEED``s, each drawing
   ``DecoderConfig.mistral_7b()`` in bf16 on the card from seed 0 and
   running a solo ``GenerateEngine`` (greedy, K = 4) on 2 prompts, then a
   ``ContinuousBatcher(n_slots=8, chunk=16)``: 4 cold prompts queued under
   its lock, one admission pinning a prefix key and 4 warm prompts on it
   queued the same way, every answer 32 new tokens; the top-10 ids of 16
   seeded queries over an exact 1,000,000 x 384 bf16 store and over a
   ``TieredIndex`` of its first 100,000 rows (nprobe 8); the broker journal
   across a restart; the shadow sampler's selection.  The transcripts must
   be bitwise equal (a divergence prints its request, token and stage);
   each child at most 90 s.  The children run beside phase 11 (a)'s
   tagger training child only: they start just before it and are joined
   just after it, before phase 11 (a) times anything in this process, so
   only that child's wall time and steps/s (``contended`` in the training
   summary) and the children's own seconds are read under contention;
   the rest of the phase runs last.  The smoke's limit is kept by running
   them there and not by cutting an earlier path's depth.  (b) The compile
   budget
   (``analysis/compile_audit.py``): registers, spills, stack and shared
   memory of every K1 and K4 kernel from the ``-Xptxas -v`` logs kept
   beside the libraries; the peak memory above what was allocated before
   of seven entry points, each read in its own phase (phase 3's first solo
   ask, phase 5's round A, phase 6's round A1, phase 7's upload batch,
   phase 13 (a)'s beam summaries, phase 14 (b)'s first int8 ask, phase
   20's bf16 ask); the steady state (phase 3's first question asked again,
   phase 5's round B after round A, phase 14 (b)'s first int8 question
   again: no new K4 plan, leaf plan, tensor map or scratch growth), all
   against ``analysis/compile_budget.json``.  ``--compile-report PATH``
   writes the report before the gate.

The recorder is on by default, so phases 3-7 run traced too.  Prints the
pool JSON line, the ingest JSON line, the obs JSON line, the app JSON line,
the lifecycle JSON line, the training JSON line, the tiered JSON line, the
checkpoints JSON line, the quant JSON line, the mesh JSON line, the mesh runtime JSON
line, the mesh tiered JSON line, the mesh train JSON line, the witness JSON line,
the Llama-3 JSON line, the replay and compile JSON line, the launches-by-phase JSON
line (each main-path run's K1 and K4 counters, whose sums are the kernels
line's launches; each run's K1 total must equal the sum of its paths, and
its K4 total the sum of its weight modes and of its kernel modes), the
kernels JSON line (K1 and its paths, then K4, its int8 / int4 modes and
its ring / wgmma / simple kernels; each launched on the main path, the
simple kernel at the reference's own configuration), the nvidia-smi
line, and last the ok line.  Phases 6 and 7 also print each spine stage's
queue wait; ``--spine-lanes N`` sets the spine's lane count.
``--k4-ab ROOT`` runs only phase 14 (a)'s cases and ``host_us_a_call``,
this K4 against the K4 of the checkout at ROOT (a parent unpacked with
``git archive``) in turns.
Exits non-zero when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import gc
import io
import itertools
import json
import logging
import math
import os
import re
import shutil
import statistics
import string
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from docqa_tpu_torch import obs
from docqa_tpu_torch.analysis import compile_audit, replay_audit
from docqa_tpu_torch.config import (
    Config, DecoderConfig, EncoderConfig, GenerateConfig, MeshConfig, NERConfig,
    PoolConfig, QoSConfig, ResilienceConfig, StoreConfig,
)
from docqa_tpu_torch.deid import datagen
from docqa_tpu_torch.deid.engine import DeidEngine
from docqa_tpu_torch.engines import paged as paged_mod
from docqa_tpu_torch.engines import serve as serve_mod
from docqa_tpu_torch.engines.encoder import EncoderEngine
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.pool import EnginePool
from docqa_tpu_torch.engines.retrieve import FusedRetriever
from docqa_tpu_torch.engines.serve import ContinuousBatcher
from docqa_tpu_torch.engines.spine import DispatchSpine, configure, get_spine
from docqa_tpu_torch.index.store import VectorStore, sidecar_rows
from docqa_tpu_torch.models import quant
from docqa_tpu_torch.models.decoder import (
    decoder_forward, init_decoder_params, init_kv_cache,
)
from docqa_tpu_torch.models.ner import init_ner_params, ner_forward
from docqa_tpu_torch.obs.expo import lint_prometheus_text, prometheus_text
from docqa_tpu_torch.obs.observatory import decoder_weight_bytes
from docqa_tpu_torch.obs.retrieval_observatory import compare_topk, wilson_interval
from docqa_tpu_torch.ops import _kernels
from docqa_tpu_torch.ops import attention as attn
from docqa_tpu_torch.ops import qmatmul as qm
from docqa_tpu_torch.ops import topk as ttopk
from docqa_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention
from docqa_tpu_torch.parallel import sharding as shard_mod
from docqa_tpu_torch.resilience import (
    BreakerBoard, Deadline, FaultPlan, FaultRule, faults,
)
from docqa_tpu_torch.runtime import mesh as mesh_mod
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY
from docqa_tpu_torch.service import registry as reg
from docqa_tpu_torch.service.broker import make_broker
from docqa_tpu_torch.service.extract import extract_text_ex
from docqa_tpu_torch.service.pipeline import DocumentPipeline
from docqa_tpu_torch.service.qa import QA_TEMPLATE, QAService
from docqa_tpu_torch.service.registry import DocumentRegistry
from docqa_tpu_torch.text.chunker import chunk_text
from docqa_tpu_torch.utils import pick_bucket, round_up

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

STORE_ROWS = 1_000_000
N_NOTES = 20
QUESTIONS = (
    "Quelle est la dose de metformine du patient P003 ?",
    "Quel traitement pour l'hypertension du patient P007 ?",
    "Le patient P012 a-t-il une allergie à la pénicilline ?",
    "Quelle est la tension artérielle du patient P015 ?",
)
# |kernel - plain| <= atol + rtol * |plain|.  bf16: both sides compute in
# float32 and round once to bf16 (2^-8 relative), so allow ~2.5 bf16 ulps;
# float32: only the summation order differs.
PATH_KEYS = ("flash_attention.decode", "flash_attention.prefill", "flash_attention.simt")
TOL = {
    torch.bfloat16: (1e-2, 1e-2),
    torch.float32: (5e-5, 0.0),
}


# phase 21 (b)'s readings, taken in the phases that run each entry point:
# peak bytes allocated above what was allocated before, and the steady
# state's deltas over a repeated round
COMPILE_PEAKS: dict = {}
COMPILE_STEADY: dict = {}
# the peak an enclosing window had seen when a reading reset the counter
_PEAK_FLOOR = 0


def reset_peak() -> None:
    """Start a peak-memory window (``peak_allocated`` reads it)."""
    global _PEAK_FLOOR
    _PEAK_FLOOR = 0
    torch.cuda.reset_peak_memory_stats()


def peak_allocated() -> int:
    """The peak allocated since the last ``reset_peak``, a reading nested
    inside the window included."""
    return max(torch.cuda.max_memory_allocated(), _PEAK_FLOOR)


@contextlib.contextmanager
def peak_reading(name: str, on: bool = True):
    """Phase 21 (b)'s peak of entry point ``name`` around the block: the
    bytes allocated at its peak above those allocated before it."""
    global _PEAK_FLOOR
    if not on:
        yield
        return
    torch.cuda.synchronize()
    _PEAK_FLOOR = peak_allocated()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        COMPILE_PEAKS[name] = int(torch.cuda.max_memory_allocated() - base)


@contextlib.contextmanager
def steady_reading(name: str, on: bool = True):
    """Phase 21 (b)'s steady state of ``name``: what a repeated round adds
    to K4's plan cache, leaf plans, tensor maps and scratch (all 0)."""
    if not on:
        yield
        return
    before = compile_audit.steady_state()
    yield
    COMPILE_STEADY[name] = compile_audit.steady_state_delta(before, compile_audit.steady_state())


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(log_text: str):
    """(kernel, registers, spill stores/loads) per entry of a -Xptxas -v log;
    the kernel named by its template, e.g. flash_decode_kernel<128,1>."""
    rows, kernel, spills = [], None, "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            name = re.search(r"(flash_[a-z]+(?:_[a-z]+)*_kernel|qmatmul_[a-z]+_kernel)I(\S+)",
                             kernel)
            if name:
                rest = name.group(2)
                dtype = ("bf16," if rest.startswith("13__nv_bfloat16")
                         else "f32," if rest.startswith("f") else "")
                nums = ",".join(re.findall(r"L[ib](\d+)E", rest))
                kernel = f"{name.group(1)}<{dtype}{nums}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append((kernel, int(m.group(1)), spills))
            kernel, spills = None, "?"
    return rows


# ---- phase 2: kernels against their plain versions ----------------------

def kernel_cases():
    """Shapes the /ask path gives the flash kernel — Mistral-7B decoder: a
    ~200-token RAG prompt in the 256 bucket, a 384-row cache (256 + 64 new
    + K, rounded to 128); MiniLM encoder: the note batch (32 lanes, some
    empty) — plus a ragged GQA case whose sq is no multiple of a tile, and
    the ingest path's NER window batch."""
    mistral = dict(hq=32, hkv=8, d=128, causal=True, window=4096)
    return [
        dict(name="mistral_prefill", b=1, sq=256, skv=384,
             lengths=[197], q_offset=[0], **mistral),
        dict(name="mistral_decode", b=1, sq=1, skv=384,
             lengths=[230], q_offset=[229], **mistral),
        dict(name="mistral_verify", b=1, sq=4, skv=384,
             lengths=[233], q_offset=[229], **mistral),
        dict(name="minilm_encoder", b=32, sq=128, skv=128, hq=12, hkv=12,
             d=32, causal=False, window=None,
             lengths=[0, 128, 1, 77, 0, 33] + [64 + i for i in range(26)],
             q_offset=None),
        dict(name="gqa_ragged", b=3, sq=37, skv=300, hq=8, hkv=2, d=64,
             causal=True, window=50, lengths=[300, 123, 37], q_offset=None),
        # a 4K-token prompt: prefill is bound by operations there, and
        # verify reads a 4K-row cache
        dict(name="mistral_prefill_4k", b=1, sq=4096, skv=4224,
             lengths=[4096], q_offset=[0], **mistral),
        dict(name="mistral_verify_4k", b=1, sq=4, skv=4224,
             lengths=[4100], q_offset=[4096], **{**mistral, "window": None}),
        # Llama-3-8B's context (phase 20's decoder): an 8,192-token prompt,
        # no sliding window, into the 8,320-row cache of 64 new tokens + K
        dict(name="llama3_prefill_8k", b=1, sq=8192, skv=8320,
             lengths=[8192], q_offset=[0], **{**mistral, "window": None}),
        # the NER tagger's window batches on phase 7's path: the trained
        # tagger (NERConfig: 8 heads of 32, no GQA, bidirectional) is served
        # in windows of the 128 tokens it was trained at, about 4.4 a note.
        # BASELINE config 2's batch of 32 notes: ~140 windows, two empty
        # lanes among them
        dict(name="ner_window_batch", b=140, sq=128, skv=128, hq=8, hkv=8, d=32,
             causal=False, window=None, q_offset=None,
             lengths=[0, 0] + np.random.default_rng(32).integers(40, 129, 138).tolist()),
        # the batch the pipeline's deid worker serves (prefetch 8: the ~36
        # windows of 8 notes; past 32 windows a batch is not bucketed), one
        # lane empty
        dict(name="ner_served_batch", b=36, sq=128, skv=128, hq=8, hkv=8, d=32,
             causal=False, window=None, q_offset=None,
             lengths=[0] + np.random.default_rng(8).integers(40, 129, 35).tolist()),
        # BART-large-cnn's summaries on phase 13's path (16 heads of 64, no
        # GQA): the encoder over 8 sources padded to the 1,024 bucket, the
        # decoder's cross-attention from 32 beam lanes (8 sources x 4 beams)
        # over them, not causal, and its causal self-attention over the
        # 143-row cache (142 new tokens + the start token) mid-summary
        dict(name="bart_encoder", b=8, sq=1024, skv=1024, hq=16, hkv=16, d=64,
             causal=False, window=None, q_offset=None,
             lengths=[300, 1024, 517, 1024, 811, 402, 1024, 655]),
        dict(name="bart_cross", b=32, sq=1, skv=1024, hq=16, hkv=16, d=64,
             causal=False, window=None, q_offset=None,
             lengths=[n for n in (300, 1024, 517, 1024, 811, 402, 1024, 655)
                      for _ in range(4)]),
        dict(name="bart_self", b=32, sq=1, skv=143, hq=16, hkv=16, d=64,
             causal=True, window=None, q_offset=[70] * 32, lengths=[71] * 32),
    ]


def time_ms(fn, flush, reps=25, warmup=3, spin_cycles=4_000_000) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each timed with
    CUDA events after overwriting a 64 MB buffer so L2 starts cold (as it
    is for attention inside a 7B forward).  A spin kernel ahead of the
    start event (~2 ms by default; longer for a ``fn`` of many launches)
    keeps the card busy while the host enqueues ``fn``, so the events
    bracket device work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def simt_bf16(q, k, v, lengths, q_offset, causal, window, out):
    """The first port's SIMT kernel on bf16 inputs (path 0 of the C entry
    point), for a same-run comparison; it bypasses the wrapper and its
    launch counts."""
    b, sq, hq, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    rc = attn._flash_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), q_offset.data_ptr(), ctypes.addressof(strides),
        b, sq, k.shape[1], hq, k.shape[2], d, int(causal), int(window or 0),
        float(d ** -0.5), 1, attn.PATHS.index("simt"), 1, 0, 0, None, None,
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"SIMT kernel launch failed: CUDA error {rc}")


def live_sdpa(case, q, k, v):
    """SDPA with no mask over the live slice, where the case's mask can be
    written that way (decode: one row over the live prefix; prefill from
    position 0: is_causal over the prompt rows), else None."""
    n = case["lengths"][0]
    if case["b"] != 1 or not case["causal"] or (case["window"] or n) < n:
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = case["hq"] != case["hkv"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if case["sq"] == 1 and case["q_offset"] == [n - 1]:
        return lambda: sdpa(qt, kt[:, :, :n], vt[:, :, :n], enable_gqa=gqa)
    if case["q_offset"] == [0] and case["sq"] >= n:
        return lambda: sdpa(qt[:, :, :n], kt[:, :, :n], vt[:, :, :n],
                            is_causal=True, enable_gqa=gqa)
    return None


def run_kernel_cases():
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    results = []
    for case in kernel_cases():
        b, sq, skv = case["b"], case["sq"], case["skv"]
        hq, hkv, d = case["hq"], case["hkv"], case["d"]
        lengths = torch.tensor(case["lengths"], dtype=torch.int32, device=dev)
        q_offset = (
            torch.tensor(case["q_offset"], dtype=torch.int32, device=dev)
            if case["q_offset"] is not None
            else (lengths - sq if case["causal"] else torch.zeros_like(lengths))
        )
        kw = dict(causal=case["causal"], lengths=lengths, q_offset=q_offset,
                  sliding_window=case["window"])
        q32 = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k32 = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v32 = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = attn.plan_flash(torch.bfloat16, b, sq, skv, hq, hkv, sms)
        rec = {"case": case["name"], "shape": f"b{b} sq{sq} skv{skv} hq{hq} hkv{hkv} d{d}",
               "path": plan.path, "plan": plan._asdict()}
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            got = attn.flash_attention(q, k, v, **kw)
            want = attn.attention_reference(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = TOL[dtype]
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            if not torch.isfinite(got.float()).all() or not ok:
                raise AssertionError(
                    f"flash_attention {case['name']} {tag}: max |err| "
                    f"{float(err.max()):.3e} over atol {atol} rtol {rtol}"
                )
            rec[f"max_abs_err_{tag}"] = float(err.max())
        # times at the main path's type, bf16
        q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
        mask = attn.live_mask(b, sq, skv, lengths, q_offset, case["causal"],
                              case["window"], dev)
        rec["ms"] = time_ms(lambda: attn.flash_attention(q, k, v, **kw), flush)
        out = torch.empty_like(q)
        rec["simt_ms"] = time_ms(
            lambda: simt_bf16(q, k, v, lengths, q_offset, case["causal"],
                              case["window"], out), flush
        )
        rec["plain_ms"] = time_ms(
            lambda: attn.attention_reference(q, k, v, **kw), flush
        )
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_mask = mask[:, None]
        rec["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=hq != hkv
            ),
            flush,
        )
        live_fn = live_sdpa(case, q, k, v)
        rec["library_live_ms"] = time_ms(live_fn, flush) if live_fn else None
        es = 2  # bf16
        live_pairs = int(mask.sum())
        live_kv_rows = int(mask.any(dim=1).sum())
        flops = 4 * d * hq * live_pairs
        nbytes = (2 * b * sq * hq * d + 2 * live_kv_rows * hkv * d) * es + 8 * b
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_flops = flops / PEAK_BF16_FLOPS * 1e3
        rec["bound_ms"] = max(t_bytes, t_flops)
        rec["bound_by"] = "bytes" if t_bytes >= t_flops else "operations"
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["tolerance"] = {"bf16": TOL[torch.bfloat16], "f32": TOL[torch.float32]}
        live = rec["library_live_ms"]
        log(f"  {rec['case']:18s} {rec['shape']:36s} {plan.path:7s} err bf16 "
            f"{rec['max_abs_err_bf16']:.2e} f32 {rec['max_abs_err_f32']:.2e}  "
            f"kernel {rec['ms']:.4f} ms  simt {rec['simt_ms']:.4f} ms  "
            f"plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms  "
            f"sdpa-live {'-' if live is None else f'{live:.4f}'} ms  "
            f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
            f"{100 * rec['bound_share']:.1f} % of it)")
        results.append(rec)
    return results


def paged_cases():
    """The batcher's verify step at Mistral widths and with Mistral's
    4,096-token sliding window, as the main path passes it (8 lanes, K=4,
    16-token blocks, NB=64: the 1,024-row capacity of phase 5), the same
    over ~4,100 live rows per lane, where the window cuts the first rows,
    and a replica of phase 6 (16 lanes over a pool of 16 x 64 blocks, half
    of them idle: their table rows all holes, as a free slot's are)."""
    mistral = dict(hq=32, hkv=8, d=128, sq=4, block_size=16, window=4096)
    return [
        dict(name="mistral_paged_verify", lanes=8, nb=64, live=(180, 260), **mistral),
        dict(name="mistral_paged_verify_4k", lanes=8, nb=264, live=(4090, 4110), **mistral),
        dict(name="mistral_paged_verify_16", lanes=16, idle=8, nb=64, live=(180, 300),
             **mistral),
    ]


def run_paged_cases():
    """K1's paged mode against its plain version (gather_paged_kv +
    attention_reference) on shuffled block ids with hole entries, and the
    times of: the kernel, the plain version, the library call (gather +
    masked SDPA) and the reference's own TPU route (gather + K1's
    contiguous decode path)."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    rng = np.random.default_rng(4321)
    results = []
    for case in paged_cases():
        rec = paged_case(case, flush, gen, rng)
        log(f"  {rec['case']:24s} {rec['shape']:38s} {rec['plan']['num_splits']} splits  "
            f"err bf16 {rec['max_abs_err_bf16']:.2e}  kernel {rec['ms']:.4f} ms  plain "
            f"{rec['plain_ms']:.4f} ms  gather+sdpa {rec['library_ms']:.4f} ms  "
            f"gather+K1 {rec['gather_k1_ms']:.4f} ms  bound {rec['bound_ms']:.5f} ms "
            f"({rec['bound_by']}, {100 * rec['bound_share']:.1f} % of it)")
        results.append(rec)
    return results


def paged_case(case, flush, gen, rng, library_only=False):
    """One paged case (``paged_cases``'s keys; ``hq`` / ``hkv`` may be one
    rank's heads): the kernel held to its plain version, then the kernel,
    the plain version, gather + masked SDPA and (unless ``library_only``)
    gather + K1 timed, with the bound of its live work."""
    dev = torch.device("cuda")
    S, sq, nb, bs = case["lanes"], case["sq"], case["nb"], case["block_size"]
    hq, hkv, d = case["hq"], case["hkv"], case["d"]
    n_blocks = S * nb  # every lane could fill its table
    lengths_np = rng.integers(case["live"][0], case["live"][1] + 1, S)
    perm = rng.permutation(n_blocks)
    tables_np = np.full((S, nb), n_blocks, np.int32)  # holes past the live blocks
    busy = S - case.get("idle", 0)  # the last lanes idle: no block, any length
    for lane, n in enumerate(lengths_np[:busy]):
        used = -(-int(n) // bs)
        tables_np[lane, :used] = perm[lane * nb: lane * nb + used]
    if busy < S:
        lengths_np[busy:] = rng.integers(sq, case["live"][1] + 1, S - busy)
    tables = torch.from_numpy(tables_np).to(dev)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    q_offset = lengths - sq
    q = torch.randn((S, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
    k_pool, v_pool = (
        torch.randn((n_blocks * bs, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
        for _ in range(2)
    )
    kw = dict(block_size=bs, q_offset=q_offset, sliding_window=case["window"])
    dense_kw = dict(causal=True, lengths=lengths, q_offset=q_offset,
                    sliding_window=case["window"])

    def kernel():
        return attn.paged_decode_attention(q, k_pool, v_pool, tables, lengths, **kw)

    def gathered():
        return (attn.gather_paged_kv(k_pool, tables, bs),
                attn.gather_paged_kv(v_pool, tables, bs))

    def plain():
        k, v = gathered()
        return attn.attention_reference(q, k, v, **dense_kw)

    skv = nb * bs
    mask = attn.live_mask(S, sq, skv, lengths, q_offset, True, case["window"], dev)

    def library():
        k, v = gathered()
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=hq != hkv,
        )

    def gather_k1():
        k, v = gathered()
        return attn.flash_attention(q, k, v, **dense_kw)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[torch.bfloat16]
    if not torch.isfinite(got.float()).all() or not bool(
        (err <= atol + rtol * want.float().abs()).all()
    ):
        raise AssertionError(
            f"paged_decode_attention {case['name']}: max |err| "
            f"{float(err.max()):.3e} over atol {atol} rtol {rtol}"
        )
    plan = attn.plan_flash(torch.bfloat16, S, sq, skv, hq, hkv,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    rec = {"case": case["name"], "path": "decode_paged",
           "shape": f"S{S} sq{sq} NB{nb} bs{bs} hq{hq} hkv{hkv} d{d}",
           "plan": plan._asdict(), "lengths": lengths_np.tolist(),
           "max_abs_err_bf16": float(err.max())}
    rec["ms"] = time_ms(kernel, flush)
    rec["plain_ms"] = time_ms(plain, flush)
    rec["library_ms"] = time_ms(library, flush)
    if not library_only:
        rec["gather_k1_ms"] = time_ms(gather_k1, flush)
    es = 2  # bf16
    live_pairs = int(mask.sum())
    live_kv_rows = int(mask.any(dim=1).sum())
    flops = 4 * d * hq * live_pairs
    nbytes = ((2 * S * sq * hq * d + 2 * live_kv_rows * hkv * d) * es
              + 4 * S * nb + 8 * S)  # + the block table, lengths, q_offset
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    rec["bound_ms"] = max(t_bytes, t_flops)
    rec["bound_by"] = "bytes" if t_bytes >= t_flops else "operations"
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


# ---- phase 3: the main path at full width ---------------------------------

def clinical_notes(rng: np.random.Generator):
    drugs = [("metformine", 500), ("lisinopril", 10), ("amlodipine", 5),
             ("atorvastatine", 20), ("aspirine", 100), ("lévothyroxine", 75)]
    conditions = ["diabète de type 2", "hypertension artérielle",
                  "dyslipidémie", "hypothyroïdie", "insuffisance cardiaque"]
    notes = []
    for i in range(N_NOTES):
        drug, dose = drugs[int(rng.integers(len(drugs)))]
        cond = conditions[int(rng.integers(len(conditions)))]
        allergy = "pénicilline" if rng.random() < 0.3 else "aucune connue"
        text = (
            f"Consultation du patient P{i:03d}, {int(rng.integers(30, 90))} ans. "
            f"Antécédents : {cond}. Traitement : {drug} {dose} mg "
            f"{int(rng.integers(1, 3))} fois par jour. Tension artérielle "
            f"{int(rng.integers(110, 170))}/{int(rng.integers(60, 100))} mmHg. "
            f"Allergies : {allergy}. Suivi dans {int(rng.integers(1, 6))} mois."
        )
        notes.append((f"note-{i:02d}.txt", text))
    return notes


def build_main_path(counts):
    """The /ask service at full width on the card: MiniLM-L6 encoder, a
    store of the notes (encoded through the engine) plus seeded random
    unit vectors up to STORE_ROWS rows, and a Mistral-7B-width bf16
    generator with weights drawn on the card.  ``counts`` is reset before
    the notes are encoded.  Returns (qa, params, note-encoding launches)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    enc_cfg = EncoderConfig()
    dec_cfg = DecoderConfig.mistral_7b()

    t0 = time.perf_counter()
    encoder = EncoderEngine(enc_cfg, seed=0, device=dev)
    store = VectorStore(StoreConfig(), device=dev)
    notes = clinical_notes(rng)
    counts.clear()
    note_emb = encoder.encode_texts([text for _, text in notes])
    enc_launches = counts["flash_attention"]
    if enc_launches != enc_cfg.num_layers or counts["flash_attention.prefill"] != enc_launches:
        raise AssertionError(
            f"note encoding launched the flash kernel {enc_launches} times, "
            f"expected {enc_cfg.num_layers}"
        )
    if not np.isfinite(note_emb).all() or not np.allclose(
        np.linalg.norm(note_emb, axis=1), 1.0, atol=1e-3
    ):
        raise AssertionError("note embeddings are not finite unit vectors")
    store.add(note_emb, [
        {"source": src, "text_content": text, "doc_id": src}
        for src, text in notes
    ])
    n_fill = STORE_ROWS - N_NOTES
    filler = rng.standard_normal((n_fill, enc_cfg.embed_dim), dtype=np.float32)
    store.add(filler, [{"source": f"filler-{i:07d}"} for i in range(n_fill)])
    del filler
    t_store = time.perf_counter() - t0
    log(f"  store: {store.count} rows x {enc_cfg.embed_dim} "
        f"{store.cfg.dtype} (capacity {store.capacity}), built in {t_store:.1f} s")

    t0 = time.perf_counter()
    params = init_decoder_params(dec_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  decoder: Mistral-7B width, {sum(p.numel() for p in params.values()) / 1e9:.2f} "
        f"B params bf16 drawn on the card in {time.perf_counter() - t0:.1f} s")
    generator = GenerateEngine(
        dec_cfg, GenerateConfig(max_new_tokens=64, speculative_k=4),
        params=params, device=dev,
    )
    qa = QAService(encoder, store, generator, k=3, device=dev)
    return qa, params, enc_launches


def run_main_path(counts, qa, params, enc_launches):
    dev = torch.device("cuda")
    generator = qa.generator
    enc_cfg = qa.retriever.encoder.cfg
    dec_cfg = generator.cfg

    per_q = []
    for question in QUESTIONS:
        before = dict(counts)
        t0 = time.perf_counter()
        with peak_reading("solo_ask", on=not per_q):
            out = qa.ask(question)
        latency = time.perf_counter() - t0
        _no_degraded("solo /ask", [out])
        delta = {key: counts[key] - before.get(key, 0) for key in PATH_KEYS}
        launched = counts["flash_attention"] - before.get("flash_attention", 0)
        st = dict(generator.last_stats)
        expected = enc_cfg.num_layers + st["forwards"] * dec_cfg.num_layers
        if launched != expected or st["forwards"] < 1:
            raise AssertionError(
                f"ask launched the flash kernel {launched} times; expected "
                f"{enc_cfg.num_layers} (encoder) + {st['forwards']} forwards x "
                f"{dec_cfg.num_layers} layers (decoder)"
            )
        # the query encode and the one prefill forward on the wgmma path,
        # every verify forward on the split-kv path, nothing on the SIMT one
        want = {
            "flash_attention.prefill": enc_cfg.num_layers + dec_cfg.num_layers,
            "flash_attention.decode": (st["forwards"] - 1) * dec_cfg.num_layers,
            "flash_attention.simt": 0,
        }
        if delta != want:
            raise AssertionError(f"ask's launches by path {delta}, expected {want}")
        if not isinstance(out["answer"], str) or not out["answer"].strip():
            raise AssertionError(f"empty answer for {question!r}")
        if len(out["sources"]) != 3:
            raise AssertionError(f"expected 3 sources, got {out['sources']}")
        if not any(s.startswith("note-") for s in out["sources"]):
            raise AssertionError(f"no real note among sources {out['sources']}")
        rec = {
            "question": question,
            "latency_s": latency,
            "sources": out["sources"],
            "answer": out["answer"],
            "answer_words": len(out["answer"].split()),
            "prefill_tokens": st["prefill_tokens"],
            "prefill_s": st["prefill_s"],
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tokens": st["decode_tokens"],
            "decode_s": st["decode_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "decoder_forwards": st["forwards"],
            "flash_launches": launched,
            "flash_launches_by_path": delta,
        }
        log(f"  ask {len(per_q)}: {latency:.3f} s, sources {out['sources']}, "
            f"prefill {rec['prefill_tokens']} tok in {rec['prefill_s'] * 1e3:.1f} ms "
            f"({rec['prefill_tok_s']:.0f} tok/s), decode {rec['decode_tokens']} tok "
            f"in {rec['decode_s'] * 1e3:.1f} ms ({rec['decode_tok_s']:.1f} tok/s), "
            f"{st['forwards']} forwards, {launched} flash launches "
            f"(decode {delta['flash_attention.decode']}, prefill "
            f"{delta['flash_attention.prefill']}, simt {delta['flash_attention.simt']})")
        per_q.append(rec)
    launches = {"total": dict(counts), "note_encoding": enc_launches}
    # phase 21 (b)'s steady state: the first question again, after the
    # counts are read
    with steady_reading("solo_ask"):
        _no_degraded("solo /ask, repeated", [qa.ask(QUESTIONS[0])])

    # full-width output check (after the counts are read): one prefill of
    # the last question gives finite logits of the expected shape
    prompt_ids = generator.tokenizer.encode(QUESTIONS[-1])
    ids = torch.tensor([prompt_ids], device=dev)
    cache = init_kv_cache(dec_cfg, 1, max_len=128, dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        logits = decoder_forward(
            params, dec_cfg, ids, cache, torch.zeros(1, dtype=torch.int32, device=dev),
            last_token_only=True,
        )
    if logits.shape != (1, 1, dec_cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"full-width logits bad: {tuple(logits.shape)}")
    return per_q, launches


# ---- phase 4: tiny float32 path, card (kernels) against CPU (plain) -------

def run_reference_check():
    enc_cfg = EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2,
                            num_heads=2, mlp_dim=128, max_seq_len=128,
                            embed_dim=64, dtype="float32")
    dec_cfg = DecoderConfig(vocab_size=256, hidden_dim=128, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=32,
                            mlp_dim=256, max_seq_len=1024, dtype="float32",
                            sliding_window=64)
    gen_cfg = GenerateConfig(max_new_tokens=16, prefill_buckets=(64, 128, 256, 512))
    notes = clinical_notes(np.random.default_rng(3))
    answers = {}
    for device in ("cuda", "cpu"):
        encoder = EncoderEngine(enc_cfg, seed=1, device=device)
        store = VectorStore(StoreConfig(dim=64), device=device)
        emb = encoder.encode_texts([t for _, t in notes])
        store.add(emb, [{"source": s, "text_content": t} for s, t in notes])
        generator = GenerateEngine(dec_cfg, gen_cfg, seed=2, device=device)
        qa = QAService(encoder, store, generator, k=3, device=device)
        answers[device] = ([qa.ask(q) for q in QUESTIONS], emb)
        _no_degraded(f"tiny /ask on {device}", answers[device][0])
    (ans_gpu, emb_gpu), (ans_cpu, emb_cpu) = answers["cuda"], answers["cpu"]
    emb_err = float(np.abs(emb_gpu - emb_cpu).max())
    if emb_err > 1e-4 or ans_gpu != ans_cpu:
        raise AssertionError(
            f"tiny float32 path differs between card and CPU: embeddings "
            f"max |err| {emb_err:.2e}, answers equal {ans_gpu == ans_cpu}"
        )
    log(f"  tiny float32 /ask: {len(QUESTIONS)} answers identical on card and "
        f"CPU; embeddings max |err| {emb_err:.2e} (tolerance 1e-4)")
    return {"answers_identical": True, "embedding_max_abs_err": emb_err}


# ---- phase 5: /ask through the continuous batcher at full width ------------

# Batcher vs solo first-step logits for one prompt, bf16 on the card: the
# relative RMS difference ||served - solo|| / ||solo||.  The two routes run
# the same 32 layers but with other GEMM batch shapes (a 512-token packed
# stream against the solo engine's 256 bucket, so cuBLAS may pick other
# kernels and summation orders) and another prefill attention (the plain
# f32 ragged version against K1's wgmma path, which rounds P to bf16).
# Each bf16 rounding is 2^-9 relative; compounded over 32 layers of a
# random-weight stack they stay well under 5 % of the logits' RMS.
FIRST_STEP_RTOL = 5e-2


def first_step_prompt(qa, question, usable):
    """``question``'s /ask prompt (retrieval at the service's k) and its
    token ids as the batcher truncates them to ``usable`` tokens."""
    hits = qa.retriever.search_texts([question], k=qa.k)[0]
    chunks = [h.metadata.get("text_content", h.metadata.get("source", "")) for h in hits]
    prompt = QA_TEMPLATE.format(context="\n\n".join(chunks), question=question)
    return prompt, qa.generator.encode_prompt(prompt, usable)


def solo_first_step(gen, ids, params=None, cfg=None):
    """First-step logits of ``ids`` from the solo engine's bucketed prefill
    through K1 on the card, at the engine's weights and config or at
    ``params`` / ``cfg`` (a cut of its depth, another compute dtype)."""
    params, cfg = params or gen.params, cfg or gen.cfg
    dev, n = gen.device, len(ids)
    with torch.inference_mode():
        bucket = pick_bucket(n, gen.gen.prefill_buckets)
        solo_ids = torch.full((1, bucket), gen.gen.pad_id, dtype=torch.long, device=dev)
        solo_ids[0, :n] = torch.tensor(ids, device=dev)
        cache = init_kv_cache(cfg, 1, max_len=round_up(bucket + 64 + 4, 128),
                              dtype=getattr(torch, cfg.dtype), device=dev)
        solo = decoder_forward(
            params, cfg, solo_ids, cache, torch.zeros(1, dtype=torch.int32, device=dev),
            attn_lengths=torch.tensor([n], dtype=torch.int32, device=dev),
            last_token_only=True,
        )[0, 0]
    return solo.float()


def served_first_step(submit, items):
    """The first step of each ``(prompt, ids, submit kwargs)`` as a batcher
    (or a pool of them) serves it: every prompt is submitted at once with
    ``max_new_tokens=1`` (admission, packing, the prefill program and the
    pipelined fetch as any request takes them) while a tap on the batcher's
    ragged prefill forward keeps the logits of each lane whose packed tokens
    are one prompt's ``ids`` from position 0 (a concurrent canary's lane is
    not taken).  Returns [(served logits, the token delivered)] in order."""
    wants = [torch.tensor(ids) for _p, ids, _kw in items]
    taken = [[] for _ in items]
    forward = serve_mod.ragged_prefill_forward

    def tap(params, cfg, pools, ids_t, seg, pos, dest, last_rows, **kw):
        logits = forward(params, cfg, pools, ids_t, seg, pos, dest, last_rows, **kw)
        seg_h, ids_h, pos_h = seg.cpu(), ids_t.cpu(), pos.cpu()
        for lane in range(last_rows.shape[0]):
            mine = seg_h == lane
            for i, want in enumerate(wants):
                if (int(mine.sum()) == len(want) and int(pos_h[mine][0]) == 0
                        and torch.equal(ids_h[mine], want)):
                    taken[i].append(logits[lane].float().clone())
        return logits

    serve_mod.ragged_prefill_forward = tap
    try:
        handles = [submit(prompt, max_new_tokens=1, **kw) for prompt, _ids, kw in items]
        delivered = [h.result(timeout=600) for h in handles]
    finally:
        serve_mod.ragged_prefill_forward = forward
    torch.cuda.synchronize()
    if [len(t) for t in taken] != [1] * len(items) or any(len(d) != 1 for d in delivered):
        raise AssertionError(
            f"one prefill lane and one token per prompt expected, got "
            f"{[len(t) for t in taken]} lanes and tokens {delivered}"
        )
    return [(t[0], d[0]) for t, d in zip(taken, delivered)]


def check_first_step(where, solo_logits, served_logits, token, n_prompt):
    """Served first-step logits within ``FIRST_STEP_RTOL`` relative RMS of
    solo's, the delivered token their argmax (and solo's past a decisive
    top-2 gap); returns the record."""
    diff = served_logits - solo_logits
    rel = float(diff.norm() / solo_logits.norm())
    top2 = solo_logits.topk(2).values
    gap = float(top2[0] - top2[1])
    max_abs = float(diff.abs().max())
    # a solo top-2 gap wider than twice the largest logit difference
    # cannot flip the argmax: then the delivered token must be solo's
    decisive = gap > 2 * max_abs
    rec = {
        "prompt_tokens": n_prompt, "rel_rms_diff": rel,
        "max_abs_diff": max_abs,
        "solo_logit_rms": float(solo_logits.pow(2).mean().sqrt()),
        "solo_top2_gap": gap,
        "delivered_token": token,
        "served_argmax": int(served_logits.argmax()),
        "solo_argmax": int(solo_logits.argmax()),
        "tolerance_rel_rms": FIRST_STEP_RTOL,
    }
    log(f"  first step through the {where} vs solo ({n_prompt}-token prompt): "
        f"logits relative RMS diff {rel:.3e} (tolerance {FIRST_STEP_RTOL}), max |diff| "
        f"{max_abs:.3e}; delivered token {token}, served argmax "
        f"{rec['served_argmax']}, solo argmax {rec['solo_argmax']} "
        f"(solo top-2 gap {gap:.3e}, {'asserted' if decisive else 'reported'})")
    if not rel <= FIRST_STEP_RTOL:
        raise AssertionError(f"{where} vs solo first-step logits differ: {rec}")
    if token != rec["served_argmax"]:
        raise AssertionError(f"the {where} delivered another token than its logits' argmax: {rec}")
    if decisive and token != rec["solo_argmax"]:
        raise AssertionError(f"{where} and solo first tokens differ past a decisive gap: {rec}")
    return rec


def _no_degraded(where, outs):
    """Phases 3-5 run no fault and no deadline: every answer is generated."""
    bad = [(o.get("degrade_reason"), o.get("answer", "")[:60]) for o in outs
           if o.get("degraded")]
    if bad:
        raise AssertionError(f"{where}: degraded answers {bad}")


def _ask_round(qa, questions):
    """Submit every question at once (retrieval then a queued decode each),
    then wait for all of them on one thread per request; returns
    (question, response, latency_s) per request, latency from its submit."""
    pend = []
    for q in questions:
        t0 = time.perf_counter()
        pend.append((q, t0, qa.ask_submit(q)))
    results = [None] * len(pend)

    def wait(i, q, t0, pending):
        try:
            out = pending.resolve(timeout=600)
            results[i] = (q, out, time.perf_counter() - t0)
        except BaseException as e:  # reported below, failing the phase
            results[i] = (q, e, None)

    threads = [threading.Thread(target=wait, args=(i, *p)) for i, p in enumerate(pend)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=660)
    for q, out, _lat in results:
        if not isinstance(out, dict):
            raise AssertionError(f"batcher /ask {q!r} failed: {out!r}")
    _no_degraded("batcher /ask", [r[1] for r in results])
    return results


def _tokens(answer: str):
    return answer.split()  # the hash tokenizer decodes one "w<id>" per token


def run_batcher_path(counts, qa_solo, solo_per_q):
    """Phase 5: /ask through ``ContinuousBatcher`` at full width on phase
    3's encoder, store and Mistral-7B-width weights (no second copy): 8
    slots, 16-token chunks, 1,024-token capacity, 16-token blocks, a
    worst-case pool, the prefix cache on, K=4, FIFO.  Round A submits the
    four questions twice each at once; round B the same eight after A
    drained, so the prefix cache serves warm admissions.  The launch counts
    are set to 0 just before the two rounds and read just after."""
    dev = torch.device("cuda")
    gen = qa_solo.generator
    dec_cfg = gen.cfg
    enc_layers = qa_solo.retriever.encoder.cfg.num_layers
    batcher = ContinuousBatcher(gen, n_slots=8, chunk=16, cache_len=1024,
                                kv_block_size=16, kv_pool_tokens=None,
                                prefix_cache=True)
    try:
        qa = QAService(qa_solo.retriever.encoder, qa_solo.retriever.store, gen,
                       k=3, device=dev, batcher=batcher)
        t0 = time.perf_counter()
        batcher.warmup()
        torch.cuda.synchronize()
        log(f"  batcher: {batcher.n_slots} slots, chunk {batcher.chunk}, K={batcher.spec_k}, "
            f"{batcher.n_blocks} blocks x {batcher.block_size} tokens "
            f"({batcher.n_blocks * batcher.block_size * batcher.kv_bytes_per_token / 2**30:.2f} GiB "
            f"of KV), token budgets {batcher._token_buckets}; warmed in "
            f"{time.perf_counter() - t0:.1f} s")

        prompt, ids = first_step_prompt(qa, QUESTIONS[0],
                                        batcher.cache_len - 2 - batcher.spec_k)
        [(served, token)] = served_first_step(batcher.submit_text, [(prompt, ids, {})])
        logit_check = check_first_step("batcher", solo_first_step(gen, ids), served,
                                       token, len(ids))

        # the plain versions, counted while the two rounds run: none of the
        # flash wrappers may take them on the card (the ragged prefill
        # attention IS plain in this slice and is counted apart)
        plain_calls = collections.Counter()
        originals = {
            (attn, "attention_reference"): attn.attention_reference,
            (attn, "gather_paged_kv"): attn.gather_paged_kv,
            (paged_mod, "ragged_prefill_attention"): paged_mod.ragged_prefill_attention,
        }

        def counting(name, fn):
            def wrapper(*a, **k):
                plain_calls[name] += 1
                return fn(*a, **k)
            return wrapper

        for (mod, name), fn in originals.items():
            setattr(mod, name, counting(name, fn))
        try:
            stats0 = collections.Counter(batcher.stats)
            reset_peak()
            counts.clear()
            rounds = {}
            t_all = time.perf_counter()
            for name in ("A", "B"):
                t0 = time.perf_counter()
                before = collections.Counter(batcher.stats)
                with peak_reading("batcher_round", on=name == "A"), \
                        steady_reading("batcher_round", on=name == "B"):
                    results = _ask_round(qa, QUESTIONS * 2)
                    if not batcher.drain(timeout=600):
                        raise AssertionError(f"round {name} did not drain")
                wall = time.perf_counter() - t0
                batcher.resume()
                done = collections.Counter(batcher.stats) - before
                lat = sorted(r[2] for r in results)
                n_tok = sum(len(_tokens(r[1]["answer"])) for r in results)
                rounds[name] = {
                    "wall_s": wall,
                    "latency_p50_s": statistics.median(lat),
                    "latency_max_s": lat[-1],
                    "latencies_s": [r[2] for r in results],
                    "answer_tokens": n_tok,
                    "tokens_per_s": n_tok / wall,
                    "verify_steps": done["verify_steps"],
                    "admissions": done["admissions"],
                    "warm_admissions": done["warm_admissions"],
                    "prefill_dispatches": done["prefill_dispatches"],
                    "answers": [(r[0], r[1]["answer"], r[1]["sources"]) for r in results],
                }
                occ = batcher.kv_block_occupancy()
                log(f"  round {name}: 8 /ask in {wall:.3f} s, latency p50 "
                    f"{rounds[name]['latency_p50_s']:.3f} s max {lat[-1]:.3f} s, "
                    f"{n_tok} answer tokens = {n_tok / wall:.1f} tok/s, "
                    f"{done['verify_steps']} verify steps, {done['admissions']} admissions "
                    f"({done['warm_admissions']} warm) in {done['prefill_dispatches']} "
                    f"prefill passes; blocks after drain {occ['blocks_used']} / "
                    f"{occ['blocks_total']} (prefix cache {occ.get('prefix_blocks')})")
            wall_all = time.perf_counter() - t_all
            launches, stats = _quiescent(counts, lambda: collections.Counter(batcher.stats))
            peak_gib = peak_allocated() / 2**30
            stats = stats - stats0
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)

        # ---- what must hold ----
        for rnd in rounds.values():
            for q, answer, sources in rnd["answers"]:
                if not answer.strip():
                    raise AssertionError(f"empty batcher answer for {q!r}")
                if len(sources) != 3:
                    raise AssertionError(f"expected 3 sources, got {sources}")
        pstats = batcher._prefix_cache.stats()
        if pstats["hits"] < 1 or stats["warm_admissions"] < 1:
            raise AssertionError(f"no warm prefix admission: {pstats}")
        in_use = batcher._alloc.blocks_in_use
        if in_use != pstats["pinned_blocks"]:
            raise AssertionError(
                f"{in_use} blocks in use after drain, the prefix cache pins "
                f"{pstats['pinned_blocks']}: blocks leaked"
            )
        if plain_calls["attention_reference"] or plain_calls["gather_paged_kv"]:
            raise AssertionError(f"an attention call took the plain version: {dict(plain_calls)}")
        n_ask = 16
        want = {
            "flash_attention.decode_paged": dec_cfg.num_layers * stats["verify_steps"],
            "flash_attention.prefill": enc_layers * n_ask,
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want or stats["verify_steps"] < 1:
            raise AssertionError(f"batcher phase launches {got}, expected {want}")
        if launches.get("flash_attention", 0) != sum(want.values()):
            raise AssertionError(f"flash_attention launches {launches}, expected {sum(want.values())}")
        if plain_calls["ragged_prefill_attention"] != dec_cfg.num_layers * stats["prefill_dispatches"]:
            raise AssertionError(f"ragged prefill calls {dict(plain_calls)} vs {stats}")

        # reported, not asserted: greedy tokens against phase 3's solo answers
        solo = {r["question"]: _tokens(r["answer"]) for r in solo_per_q}
        match = []
        for q, answer, _src in rounds["A"]["answers"] + rounds["B"]["answers"]:
            a, s = _tokens(answer), solo[q]
            same = next((i for i, (x, y) in enumerate(zip(a, s)) if x != y), min(len(a), len(s)))
            match.append({"question": q, "matching_prefix": same, "solo_tokens": len(s),
                          "batcher_tokens": len(a)})
        lat_all = sorted(x for r in rounds.values() for x in r["latencies_s"])
        tok_all = sum(r["answer_tokens"] for r in rounds.values())
        summary = {
            "latency_p50_s": statistics.median(lat_all), "latency_max_s": lat_all[-1],
            "tokens_per_s": tok_all / wall_all, "wall_s": wall_all,
            "verify_steps": stats["verify_steps"],
            "peak_device_gib": peak_gib,
            "kv_block_occupancy": batcher.kv_block_occupancy(),
            "prefix_cache": pstats, "plain_calls": dict(plain_calls),
            "greedy_match_vs_solo": match,
            "full_matches": sum(m["matching_prefix"] == m["solo_tokens"] == m["batcher_tokens"]
                                for m in match),
        }
        log(f"  batcher /ask: 16 answers, latency p50 {summary['latency_p50_s']:.3f} s "
            f"max {lat_all[-1]:.3f} s, {tok_all / wall_all:.1f} answer tok/s overall, "
            f"{stats['verify_steps']} verify steps, peak device memory {peak_gib:.2f} GiB, "
            f"launches {got} (= {dec_cfg.num_layers} "
            f"x verify steps on decode_paged), plain calls {dict(plain_calls)}; "
            f"prefix hits {pstats['hits']:.0f} / misses {pstats['misses']:.0f}; "
            f"greedy answers equal to solo: {summary['full_matches']} of 16 "
            f"(matching prefixes {[m['matching_prefix'] for m in match]})")
        return {"rounds": rounds, "summary": summary, "logit_check": logit_check,
                "launches": launches, "stats": dict(stats)}
    finally:
        batcher.stop()


# ---- phase 6: /ask through the replica pool at full width -------------------

# Rounds B-E pass this budget to every /ask, not the reference's 8 s: the
# host's clock spread 2x between runs of the same code (PERF.md section 4)
POOL_DEADLINE_S = 60.0
# a dead replica must be healthy again within this many seconds
REBUILD_LIMIT_S = 30.0
# round E's decoder breaker: the reference's 5-failure threshold, its 30 s
# reset cut to 2 s so the drill waits out one reset window
BREAKER_RESET_S = 2.0


def _resolve_all(pend):
    """Wait for every (question, t0, PendingAnswer) on its own thread, each
    result taken with a timeout; returns (question, response, latency_s).
    Fails when a waiter hangs or an /ask raised."""
    results = [None] * len(pend)

    def wait(i, q, t0, pending):
        try:
            out = pending.resolve(timeout=120)
            results[i] = (q, out, time.perf_counter() - t0)
        except BaseException as e:  # reported below, failing the phase
            results[i] = (q, e, None)

    threads = [threading.Thread(target=wait, args=(i, *p)) for i, p in enumerate(pend)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    hung = [pend[i][0] for i, r in enumerate(results) if r is None]
    if hung:
        raise AssertionError(f"pool /ask waiter(s) hung: {hung}")
    for q, out, _lat in results:
        if not isinstance(out, dict):
            raise AssertionError(f"pool /ask {q!r} failed: {out!r}")
    return results


def _submit_round(qa, questions, req_class="interactive"):
    pend = []
    for q in questions:
        t0 = time.perf_counter()
        pend.append((q, t0, qa.ask_submit(
            q, deadline=Deadline.after(POOL_DEADLINE_S), req_class=req_class)))
    return pend


def _round_record(results, wall):
    lat = sorted(r[2] for r in results)
    served = [r[1] for r in results if not r[1].get("degraded")]
    n_tok = sum(len(_tokens(out["answer"])) for out in served)
    reasons = collections.Counter(r[1]["degrade_reason"] for r in results
                                  if r[1].get("degraded"))
    return {"asks": len(results), "wall_s": wall,
            "latency_p50_s": statistics.median(lat), "latency_max_s": lat[-1],
            "answer_tokens": n_tok, "tokens_per_s": n_tok / wall,
            "degraded": dict(reasons)}


def _reserved_bytes() -> int:
    """Reserved device memory once the caching allocator returned what no
    tensor holds."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _pool_prompt(qa, question):
    hits = qa.retriever.search_texts([question], k=qa.k)[0]
    chunks = [h.metadata.get("text_content", h.metadata.get("source", "")) for h in hits]
    return QA_TEMPLATE.format(context="\n\n".join(chunks), question=question)


def _quiescent(counts, stats, settle_s=0.25, timeout_s=30.0):
    """``(dict(counts), stats())`` once two reads ``settle_s`` apart agree:
    no worker is issuing launches or finishing steps any more."""
    deadline = time.perf_counter() + timeout_s
    last = (dict(counts), stats())
    while True:
        time.sleep(settle_s)
        now = (dict(counts), stats())
        if now == last:
            return now
        if time.perf_counter() > deadline:
            raise AssertionError(f"launch counts still moving after {timeout_s} s")
        last = now


def run_pool_path(counts, qa_solo):
    """Phase 6: /ask through ``EnginePool(PoolConfig(replicas=2, n_slots=16),
    QoSConfig())`` on phase 3's encoder, store and Mistral-7B-width weights
    (chunk 16, capacity 1,024, 16-token blocks, prefix cache, K=4), with the
    decoder breaker and ``ResilienceConfig`` wired as the reference's
    ``/ask`` does.  Rounds: A1 (reported) the 16 /ask of round A through a
    1-replica pool; A 16 concurrent /ask at 64 new tokens; B the same
    at 32 with a worker crash injected; C a rolling restart under 8 /ask; D
    KV preemption in a separate 1-replica pool; E the degraded path.  Before
    A, two prompts submitted at once through the 2-replica pool, one on
    each replica, give first-step logits within ``FIRST_STEP_RTOL`` of the
    solo engine's.  The
    launch counts are set to 0 just before round A1 and read after E."""
    gen = qa_solo.generator
    dev = gen.device
    dec_cfg = gen.cfg
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    enc_layers = encoder.cfg.num_layers
    res_cfg = ResilienceConfig()
    # the solo side of the pool's first-step check, before the counts start:
    # its launches compare, they do not serve
    first = [first_step_prompt(qa_solo, q, 1024 - 2 - gen.gen.speculative_k)
             for q in QUESTIONS[1:3]]
    solo_fs = [solo_first_step(gen, ids) for _prompt, ids in first]
    torch.cuda.empty_cache()
    reset_peak()
    counts.clear()
    n_encodes = 0
    rounds = {}

    # ---- A1, reported and not asserted: round A's 16 /ask through ONE
    # replica of 16 slots (the reference's default replica count), the same
    # work on one worker thread
    def chunk_device_s():
        return get_spine().stats()["stages"].get("serve_decode_chunk", {}).get("device_s", 0.0)

    chunk_s0 = chunk_device_s()
    pool1 = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=16), qos=QoSConfig(),
                       chunk=16, cache_len=1024, device=dev)
    try:
        qa1 = QAService(encoder, store, gen, k=3, device=dev, batcher=pool1,
                        breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                              res_cfg.breaker_reset_s),
                        resilience=res_cfg)
        t0 = time.perf_counter()
        with peak_reading("pool_round_a1"):
            res = _resolve_all(_submit_round(qa1, QUESTIONS * 4))
        wall = time.perf_counter() - t0
        stats_1 = pool1.stats()
    finally:
        pool1.stop()
    n_encodes += len(res)
    rec = _round_record(res, wall)
    rec["verify_steps"] = stats_1["verify_steps"]
    # the spine's decode-chunk device time over A1 (its pool's warm-up
    # included), as phase 14 (c) reads the int8 pool's
    rec["device_ms_a_verify_step"] = (chunk_device_s() - chunk_s0) * 1e3 / max(
        rec["verify_steps"], 1)
    rounds["A1"] = rec
    log(f"  round A1 (1 replica x 16 slots, reported): 16 /ask in {wall:.3f} s, p50 "
        f"{rec['latency_p50_s']:.3f} s max {rec['latency_max_s']:.3f} s, "
        f"{rec['tokens_per_s']:.1f} answer tok/s, {rec['verify_steps']} verify steps, "
        f"{rec['device_ms_a_verify_step']:.2f} device ms a verify step, "
        f"degraded {rec['degraded']}")

    t0 = time.perf_counter()
    pool = EnginePool(gen, cfg=PoolConfig(replicas=2, n_slots=16), qos=QoSConfig(),
                      chunk=16, cache_len=1024, device=dev)
    build_s = time.perf_counter() - t0
    pool_d = None
    try:
        b0 = pool._replicas[0].batcher
        pool_bytes = b0.kv_block_occupancy()["pool_bytes"]
        log(f"  pool: 2 replicas x {b0.n_slots} slots, chunk {b0.chunk}, K={b0.spec_k}, "
            f"{b0.n_blocks} blocks x {b0.block_size} tokens ({pool_bytes / 2**30:.2f} GiB "
            f"of KV each), weighted-fair QoS; built and warmed in {build_s:.1f} s")
        def make_qa(board=None):
            board = board or BreakerBoard(res_cfg.breaker_failure_threshold,
                                          res_cfg.breaker_reset_s)
            return QAService(encoder, store, gen, k=3, device=dev, batcher=pool,
                             breakers=board, resilience=res_cfg)

        def routed():
            return [r["routed"] for r in pool.status()["replicas"]]

        # two prompts at once, one on each replica (session affinity on the
        # prefix key), their prefills on the two worker threads and streams
        keys = [next(f"fs{j}" for j in range(64)
                     if zlib.crc32(f"fs{j}".encode()) % pool.n_replicas == i)
                for i in range(pool.n_replicas)]
        routed_fs = routed()
        served = served_first_step(pool.submit_text, [
            (prompt, ids, {"prefix_key": key}) for (prompt, ids), key in zip(first, keys)])
        logit_check = [
            check_first_step(f"pool replica {i}", solo, got, token, len(ids))
            for i, (solo, (got, token), (_p, ids)) in enumerate(zip(solo_fs, served, first))]
        if [a - b for a, b in zip(routed(), routed_fs)] != [1] * pool.n_replicas:
            raise AssertionError(f"first-step prompts not one per replica: {routed()}")

        # ---- A: 16 concurrent /ask, 64 new tokens
        stats0 = pool.stats()
        paged0 = counts["flash_attention.decode_paged"]
        routed0 = routed()
        t0 = time.perf_counter()
        res = _resolve_all(_submit_round(make_qa(), QUESTIONS * 4))
        wall = time.perf_counter() - t0
        n_encodes += len(res)
        for i in range(pool.n_replicas):
            if not pool.drain(i, timeout=120)["drained"]:
                raise AssertionError(f"round A: replica {i} did not drain")
        occ = pool.kv_block_occupancy()
        for i in range(pool.n_replicas):
            pool.resume(i)
        steps = pool.stats() - stats0
        launches_a = counts["flash_attention.decode_paged"] - paged0
        rec = _round_record(res, wall)
        rec["routed"] = [a - b for a, b in zip(routed(), routed0)]
        rec["verify_steps"] = steps["verify_steps"]
        rec["blocks_after_drain"] = occ["blocks_used"]
        rec["prefix_pins"] = occ.get("prefix_blocks", 0)
        rounds["A"] = rec
        want = dec_cfg.num_layers * (steps["verify_steps"] + steps["decode_steps"]
                                     + steps["warmup_steps"])
        if rec["degraded"]:
            raise AssertionError(f"round A degraded answers: {rec['degraded']}")
        if min(rec["routed"]) < 1:
            raise AssertionError(f"round A left a replica without traffic: {rec['routed']}")
        if launches_a != want or want < 1:
            raise AssertionError(f"round A decode_paged launches {launches_a}, expected "
                                 f"{dec_cfg.num_layers} x verify steps = {want}")
        if occ["blocks_used"] != rec["prefix_pins"]:
            raise AssertionError(f"round A: {occ['blocks_used']} blocks in use after the "
                                 f"drain, the prefix caches pin {rec['prefix_pins']}")
        log(f"  round A: 16 /ask in {wall:.3f} s, p50 {rec['latency_p50_s']:.3f} s max "
            f"{rec['latency_max_s']:.3f} s, {rec['tokens_per_s']:.1f} answer tok/s, routed "
            f"{rec['routed']}, {rec['verify_steps']} verify steps, decode_paged launches "
            f"{want}, blocks after drain {occ['blocks_used']} = prefix pins")

        # rounds B-E answer 32 new tokens: the pool's default answer length
        pool.gen = dataclasses.replace(pool.gen, max_new_tokens=32)

        # ---- B: a worker crash mid-round
        mem_b0 = _reserved_bytes()
        deaths0 = sum(r["deaths"] for r in pool.status()["replicas"])
        gens0 = sum(r["generation"] for r in pool.status()["replicas"])
        seen = {}
        watching = threading.Event()

        def watch():
            while not watching.is_set():
                st = pool.status()["replicas"]
                now = time.perf_counter()
                if "death" not in seen and sum(r["deaths"] for r in st) > deaths0:
                    seen["death"] = now
                if ("death" in seen and sum(r["generation"] for r in st) > gens0
                        and all(r["state"] == "healthy" for r in st)):
                    seen["healthy"] = now
                    return
                time.sleep(0.01)

        watcher = threading.Thread(target=watch)
        watcher.start()
        t0 = time.perf_counter()
        plan = FaultPlan([FaultRule("serve.worker_loop", at_steps=(4,))])
        try:
            with plan:
                res = _resolve_all(_submit_round(make_qa(), QUESTIONS * 4))
            wall = time.perf_counter() - t0
            watcher.join(timeout=REBUILD_LIMIT_S + 60)
        finally:
            watching.set()
        n_encodes += len(res)
        rec = _round_record(res, wall)
        st = pool.status()["replicas"]
        rec["deaths"] = sum(r["deaths"] for r in st) - deaths0
        rec["rebuild_s"] = (seen["healthy"] - seen["death"]) if "healthy" in seen else None
        rec["fault_log"] = plan.log
        mem_b1 = _reserved_bytes()
        rec["memory_reserved_before"], rec["memory_reserved_after"] = mem_b0, mem_b1
        rounds["B"] = rec
        if not plan.log or rec["deaths"] < 1:
            raise AssertionError(f"round B: no replica died ({plan.log}, {st})")
        if set(rec["degraded"]) - {"replica_died"}:
            raise AssertionError(f"round B degraded for another reason: {rec['degraded']}")
        if rec["rebuild_s"] is None or rec["rebuild_s"] > REBUILD_LIMIT_S:
            raise AssertionError(f"round B: the dead replica was not healthy within "
                                 f"{REBUILD_LIMIT_S} s: {seen}, {st}")
        if mem_b1 - mem_b0 > pool_bytes:
            raise AssertionError(f"round B: reserved memory grew {mem_b1 - mem_b0} bytes, "
                                 f"more than one replica pool ({pool_bytes})")
        log(f"  round B: crash at {plan.log}, {rec['deaths']} death(s), rebuilt healthy in "
            f"{rec['rebuild_s']:.3f} s; 16 /ask: {rec['asks'] - sum(rec['degraded'].values())} "
            f"generated, degraded {rec['degraded']}, p50 {rec['latency_p50_s']:.3f} s; "
            f"reserved {mem_b0 / 2**30:.2f} -> {mem_b1 / 2**30:.2f} GiB")

        # ---- C: a rolling restart under 8 /ask
        mem_c0 = _reserved_bytes()
        gens0 = [r["generation"] for r in pool.status()["replicas"]]
        t0 = time.perf_counter()
        pend = _submit_round(make_qa(), QUESTIONS * 2)
        restart = pool.rolling_restart(timeout_per_replica=120)
        res = _resolve_all(pend)
        wall = time.perf_counter() - t0
        n_encodes += len(res)
        rec = _round_record(res, wall)
        gens1 = [r["generation"] for r in pool.status()["replicas"]]
        mem_c1 = _reserved_bytes()
        rec["restart"] = restart
        rec["memory_reserved_before"], rec["memory_reserved_after"] = mem_c0, mem_c1
        rounds["C"] = rec
        if not restart["ok"] or rec["degraded"] or any(b <= a for a, b in zip(gens0, gens1)):
            raise AssertionError(f"round C: restart {restart}, degraded {rec['degraded']}, "
                                 f"generations {gens0} -> {gens1}")
        if mem_c1 - mem_c0 > pool_bytes:
            raise AssertionError(f"round C: reserved memory grew {mem_c1 - mem_c0} bytes, "
                                 f"more than one replica pool ({pool_bytes})")
        log(f"  round C: rolling restart under 8 /ask in {wall:.3f} s, 0 dropped, 0 "
            f"degraded, generations {gens0} -> {gens1}; reserved {mem_c0 / 2**30:.2f} -> "
            f"{mem_c1 / 2**30:.2f} GiB")

        # ---- D: KV preemption in a separate 1-replica pool.  Its block pool
        # holds exactly the eight batch requests at their full length
        # (prompt + 64 new tokens + the grow margin, in 16-token blocks);
        # four interactive /ask arrive once each batch lane has 32 tokens
        prompts = [_pool_prompt(qa_solo, q) for q in QUESTIONS * 2]
        n_encodes += len(prompts)
        chunk, spec_k, bs, batch_new = 16, gen.gen.speculative_k, 16, 64
        margin = 2 * (chunk + max(spec_k, 1)) + 2
        lens = [len(gen.encode_prompt(p, 1024 - 2 - spec_k)) for p in prompts]
        n_blocks = sum(-(-(n + batch_new + margin) // bs) for n in lens)
        gen_d = GenerateEngine(
            dec_cfg, dataclasses.replace(gen.gen, max_new_tokens=32, kv_block_size=bs,
                                         kv_pool_tokens=n_blocks * bs, prefix_cache=False),
            params=gen.params, tokenizer=gen.tokenizer, device=dev,
        )
        pool_d = EnginePool(gen_d, cfg=PoolConfig(replicas=1, n_slots=16),
                            qos=QoSConfig(preemption="on"), chunk=chunk,
                            cache_len=1024, device=dev)
        bd = pool_d._replicas[0].batcher
        if bd.n_blocks != n_blocks or bd._grow_margin != margin:
            raise AssertionError(f"round D pool sized {bd.n_blocks} blocks (margin "
                                 f"{bd._grow_margin}), expected {n_blocks} ({margin})")
        qa_d = QAService(encoder, store, gen_d, k=3, device=dev, batcher=pool_d,
                         breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                               res_cfg.breaker_reset_s),
                         resilience=res_cfg)
        preempted0 = DEFAULT_REGISTRY.counter("qos_preempted").value
        admissions0 = bd.stats["admissions"]
        t0 = time.perf_counter()
        # the worker admits whatever is queued when it wakes: a request
        # queued behind that pop lags a chunk, which can take the others to
        # their full 64 tokens (their blocks freed) before it has 32.  Its
        # lock (re-entrant) is held while the eight are queued, so they are
        # admitted in one round and the pool is full when the /ask arrive
        with bd._cv:
            batch = [pool_d.submit_text(p, max_new_tokens=batch_new,
                                        req_class="batch",
                                        deadline=Deadline.after(120))
                     for p in prompts]
        end = time.monotonic() + 120
        while (min(len(h._req.tokens) for h in batch) < 32
               and time.monotonic() < end):
            time.sleep(0.005)
        before = [list(h._req.tokens) for h in batch]
        live = bd.n_active
        if live != len(batch) or bd.stats["admissions"] - admissions0 != len(batch):
            raise AssertionError(
                f"round D: {live} of {len(batch)} batch lanes live when the /ask "
                f"arrived ({[len(b) for b in before]} tokens, "
                f"{bd.stats['admissions'] - admissions0} admissions)")
        res = _resolve_all(_submit_round(qa_d, QUESTIONS))
        n_encodes += len(res)
        outs = [h.result(timeout=120) for h in batch]
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while pool_d.n_active and time.monotonic() < deadline:
            time.sleep(0.01)
        occ_d = pool_d.kv_block_occupancy()
        stats_d = pool_d.stats()
        rec = _round_record(res, wall)
        rec.update({
            "pool_blocks": n_blocks, "prompt_tokens": lens, "grow_margin": margin,
            "batch_tokens_at_arrival": [len(b) for b in before],
            "batch_tokens": [len(o) for o in outs],
            "preempted": stats_d["preempted"],
            "qos_preempted": DEFAULT_REGISTRY.counter("qos_preempted").value - preempted0,
            "blocks_after": occ_d["blocks_used"],
        })
        rounds["D"] = rec
        kept = all(o[: len(b)] == b for o, b in zip(outs, before))
        if rec["qos_preempted"] < 1 or rec["preempted"] < 1:
            raise AssertionError(f"round D: nothing was preempted: {rec}")
        # every batch result() returned (none failed); a lane may end early
        # on EOS, so lengths are reported, not asserted
        if rec["degraded"] or not kept:
            raise AssertionError(f"round D: degraded {rec['degraded']}, tokens kept {kept}, "
                                 f"batch lengths {rec['batch_tokens']}")
        if occ_d["blocks_used"] != 0:
            raise AssertionError(f"round D: {occ_d['blocks_used']} blocks leaked")
        log(f"  round D: {n_blocks}-block pool (prompts {lens}), 8 batch requests at "
            f"{rec['batch_tokens_at_arrival']} tokens when 4 interactive /ask arrived; "
            f"{rec['preempted']} preempted, interactive p50 {rec['latency_p50_s']:.3f} s, "
            f"every batch request complete ({rec['batch_tokens']} tokens) with its "
            f"earlier tokens kept, 0 blocks leaked")
        pool_d.stop()
        pool_d = None

        # ---- E: the degraded path (decoder outage, then the breaker)
        board = BreakerBoard(res_cfg.breaker_failure_threshold, BREAKER_RESET_S)
        qa_e = make_qa(board)
        plan = FaultPlan.from_env({"DOCQA_FAULTS": "decoder:p=1"})
        t0 = time.perf_counter()
        faults.install(plan)
        try:
            outs = [qa_e.ask(q, deadline=Deadline.after(POOL_DEADLINE_S))
                    for q in QUESTIONS * 2]
        finally:
            faults.uninstall(plan)
        reasons = [o.get("degrade_reason") for o in outs]
        time.sleep(BREAKER_RESET_S + 0.1)
        healthy = qa_e.ask(QUESTIONS[0], deadline=Deadline.after(POOL_DEADLINE_S))
        n_encodes += len(outs) + 1
        want_reasons = (["decoder_error"] * res_cfg.breaker_failure_threshold
                        + ["decoder_breaker_open"] * (len(outs) - res_cfg.breaker_failure_threshold))
        rounds["E"] = {"reasons": reasons, "after_reset": sorted(healthy),
                       "breaker": board.states(), "wall_s": time.perf_counter() - t0}
        if reasons != want_reasons or sorted(healthy) != ["answer", "sources"]:
            raise AssertionError(f"round E: reasons {reasons}, expected {want_reasons}; "
                                 f"after the reset {healthy}")
        if board.states() != {"decoder": "closed"}:
            raise AssertionError(f"round E: breaker {board.states()} after the reset")
        log(f"  round E: decoder outage -> {reasons}; after the reset a plain "
            f"{{answer, sources}}, breaker {board.states()}")

        # ---- the launch identity over the whole phase, all three pools
        # (their construction warm-ups included), read once the pool's
        # workers are idle: a batcher issues its next chunk before it reads
        # the last one's results, so the last answer can arrive while a
        # step's launches are still being issued
        launches, steps = _quiescent(counts, pool.stats)
        steps = steps + stats_d + stats_1
        want = {
            "flash_attention.decode_paged": dec_cfg.num_layers * (
                steps["verify_steps"] + steps["decode_steps"] + steps["warmup_steps"]),
            "flash_attention.prefill": enc_layers * n_encodes,
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want:
            raise AssertionError(f"pool phase launches {got}, expected {want}")
        peak_gib = peak_allocated() / 2**30
        summary = {
            "rounds": rounds,
            "routed": [r["routed"] for r in pool.status()["replicas"]],
            "deaths": sum(r["deaths"] for r in pool.status()["replicas"]),
            "rebuild_s": rounds["B"]["rebuild_s"],
            "first_step": logit_check,
            "preempted": rounds["D"]["preempted"],
            "degraded": dict(sum((collections.Counter(rnd.get("degraded", {}))
                                  for rnd in rounds.values()), collections.Counter(reasons))),
            "memory_reserved_gib": {
                f"{r}_{w}": rounds[r][f"memory_reserved_{w}"] / 2**30
                for r in ("B", "C") for w in ("before", "after")},
            "pool_bytes": pool_bytes,
            "peak_device_gib": peak_gib,
            "launches_by_path": got,
            "steps": dict(steps),
            "build_s": build_s,
        }
        log(f"  pool phase: launches {got} (= {dec_cfg.num_layers} x "
            f"{steps['verify_steps']} verify + {steps['warmup_steps']} warm-up steps over "
            f"the three pools), peak device memory {peak_gib:.2f} GiB")
        return {"summary": summary, "launches": launches}
    finally:
        if pool_d is not None:
            pool_d.stop()
        pool.stop()


# ---- phase 7: document ingest at full width ---------------------------------

INGEST_DOCS = 512
INGEST_MIN_CHARS = 2000  # about 4-5 chunks of 500 characters a note
INGEST_TIMEOUT_S = 300.0
CPU_CHECK_DOCS = 64
SELF_RETRIEVAL_ROWS = 32
CONCURRENT_DOCS = 64
MONTHS_FR = ("janvier", "février", "mars", "avril", "mai", "juin", "juillet",
             "août", "septembre", "octobre", "novembre", "décembre")


def _docx_bytes(paragraphs):
    """A minimal .docx (zip with word/document.xml), built as the
    reference's tests build one."""
    xml = (b'<?xml version="1.0"?><w:document><w:body>'
           + b"".join(b"<w:p><w:r><w:t>" + p.encode() + b"</w:t></w:r></w:p>"
                      for p in paragraphs)
           + b"</w:body></w:document>")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("word/document.xml", xml)
    return buf.getvalue()


def _pdf_bytes(lines):
    """A text-layer .pdf (one FlateDecode content stream of Tj lines), built
    as the reference's tests build one; parentheses would end a PDF string,
    so the lines carry none."""
    content = b"BT /F1 12 Tf " + b" ".join(
        b"(" + ln.encode() + b") Tj T*" for ln in lines) + b" ET"
    stream = zlib.compress(content)
    return (b"%PDF-1.4\n1 0 obj\n<< /Length " + str(len(stream)).encode()
            + b" /Filter /FlateDecode >>\nstream\n" + stream
            + b"endstream\nendobj\ntrailer\n%%EOF")


def ingest_corpus(rng, n, prefix, binary_every=64):
    """``n`` uploads: notes of the port's synthetic generator (training
    lexicons) taking sentences until they reach INGEST_MIN_CHARS, each
    under a header line with a seeded phone number, email address and
    French date; notes 1 and 2 of every ``binary_every`` go up as .docx and
    as .pdf, the rest as .txt."""
    docs = []
    for i in range(n):
        phone = f"0{int(rng.integers(1, 10))} " + " ".join(
            f"{int(rng.integers(0, 100)):02d}" for _ in range(4))
        email = f"dossier{int(rng.integers(1000, 9999))}.{i}@chu-{int(rng.integers(1, 99))}.fr"
        date = (f"{int(rng.integers(1, 29))} {MONTHS_FR[int(rng.integers(12))]} "
                f"{int(rng.integers(2015, 2027))}")
        lines = [f"Tél : {phone} — courriel : {email} — consultation du {date}."]
        while len("\n".join(lines)) < INGEST_MIN_CHARS:
            text, _spans = datagen.generate_example(rng, datagen.TRAIN_LEXICONS)
            lines.append(text.replace("(", " ").replace(")", " "))
        kind = {1: "docx", 2: "pdf"}.get(i % binary_every, "txt")
        data = (_docx_bytes(lines) if kind == "docx" else _pdf_bytes(lines)
                if kind == "pdf" else "\n".join(lines).encode("utf-8"))
        docs.append({"filename": f"{prefix}-{i:04d}.{kind}", "data": data,
                     "phi": (phone, email, date)})
    return docs


def _memo_logits(engine):
    """Make ``engine.ner_logits`` compute each (ids, lengths) batch once;
    returns the memo (batch key -> logits)."""
    forward, memo = engine.ner_logits, {}

    def cached(ids, lengths):
        key = (ids.tobytes(), lengths.tobytes())
        if key not in memo:
            memo[key] = forward(ids, lengths)
        return memo[key]

    engine.ner_logits = cached
    return memo


def _hold_tagger_batch(cpu, batch):
    """One tagger batch as the card ran it (``batch``: its texts, ids,
    lengths and bf16 logits) against the CPU engine's float32 forward on
    the same ids (``cpu.ner_logits``, memoised by the caller).  The logits must be
    within ``FIRST_STEP_RTOL`` relative RMS over the live rows; the word
    labels are compared with phases 5-6's decisive-gap rule: a word whose
    two largest CPU logits differ by less than twice the largest |card -
    CPU| logit difference of its window may take either label, every other
    word must take the same label on both.  A word *flips* when its label,
    or the side of the engine's threshold its probability falls on,
    differs between the card's logits and the CPU's; returns (relative RMS,
    words, words tied, labels that differ, max |diff|, the texts of the
    documents holding a flipped word)."""
    segments, ids, lengths, token_idx = cpu.windows(batch["texts"])
    if not (np.array_equal(ids, batch["ids"]) and np.array_equal(lengths, batch["lengths"])):
        raise AssertionError("a tagger batch does not repack to the ids it ran on the card")
    lc, lp = batch["logits"], cpu.ner_logits(ids, lengths)
    valid = np.arange(ids.shape[1])[None, :] < lengths[:, None]
    rel = float(np.linalg.norm((lc - lp)[valid]) / np.linalg.norm(lp[valid]))
    if not rel <= FIRST_STEP_RTOL:
        raise AssertionError(
            f"tagger logits of a {ids.shape[0]} x {ids.shape[1]} batch, card vs CPU: "
            f"relative RMS {rel:.3e} (tolerance {FIRST_STEP_RTOL})")

    def decision(z):  # (label, probability of the label >= the threshold)
        z = z.astype(np.float64)
        p = 1.0 / np.exp(z - z.max()).sum()
        return int(z.argmax()), p >= cpu.ner_threshold

    n_words = n_tied = n_flipped = 0
    max_diff = 0.0
    flipped_docs = set()
    for si, (di, seg) in enumerate(segments):
        n = int(lengths[si])
        diff = float(np.abs(lc[si, :n] - lp[si, :n]).max())
        max_diff = max(max_diff, diff)
        for wi, (_w, s, e) in enumerate(seg):
            ti = token_idx[si][wi]
            top2 = np.sort(lp[si, ti])[-2:]
            tied = top2[1] - top2[0] < 2 * diff
            n_words += 1
            n_tied += int(tied)
            if decision(lc[si, ti]) != decision(lp[si, ti]):
                flipped_docs.add(batch["texts"][di])
            if int(lc[si, ti].argmax()) != int(lp[si, ti].argmax()):
                n_flipped += 1
                if not tied:
                    raise AssertionError(
                        f"the NER label of word [{s}, {e}) of document {di} differs "
                        f"between the card and the CPU past a decisive gap "
                        f"({top2[1] - top2[0]:.3e} >= 2 x {diff:.3e})")
    return rel, n_words, n_tied, n_flipped, max_diff, flipped_docs


def run_ingest_path(counts, qa_solo, tagger):
    """Phase 7: ``DocumentPipeline.ingest_document`` at full width on phase
    3's MiniLM encoder and 1,000,000-row store, with the tagger phase 11 (a)
    trained and cached at ``tagger`` (``NERConfig()``: 4 layers, hidden 256,
    8 heads, bf16 forward; loaded as the runtime's boot loads it, windowed
    at the 128 tokens it was trained at), ``make_broker(BrokerConfig())`` (prefetch 8) and
    ``DocumentRegistry("sqlite://")``.  The launch counts are set to 0 just
    before the 512 uploads and read once all are INDEXED; then the rows,
    the masked texts against the CPU in float32, self-retrieval and an
    /ask over an ingested chunk are checked, and a round of 64 more uploads
    runs beside 8 /ask through a 1-replica pool."""
    dev = torch.device("cuda")
    gen = qa_solo.generator
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    enc_layers = encoder.cfg.num_layers
    ner_cfg = NERConfig()
    deid = DeidEngine.trained(ner_cfg, params_path=tagger, device=dev)
    cfg = Config(encoder=encoder.cfg, ner=ner_cfg, store=store.cfg)
    registry = DocumentRegistry(cfg.registry.url)  # "sqlite://": in memory
    pipe = DocumentPipeline(cfg, make_broker(cfg.broker), registry, deid, encoder, store)
    rng = np.random.default_rng(2024)
    docs = ingest_corpus(rng, INGEST_DOCS, "ingest")
    extra = ingest_corpus(rng, CONCURRENT_DOCS, "concurrent")
    texts = {d["filename"]: extract_text_ex(d["data"], d["filename"])[0]
             for d in docs + extra}
    if any(not t for t in texts.values()):
        raise AssertionError("a generated upload did not extract")

    # BASELINE config 2, reported: one deidentify_batch of 32 notes, and
    # the tagger's forward over their window batch timed with CUDA events
    batch32 = [texts[d["filename"]] for d in docs[:32]]
    deid.deidentify_batch(batch32)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deid.deidentify_batch(batch32)
    batch32_wall = time.perf_counter() - t0
    _seg, ids32, len32, _tidx = deid.windows(batch32)
    ids_t = torch.from_numpy(ids32).long().to(dev)
    len_t = torch.from_numpy(len32).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with torch.inference_mode():
        # ~20 ms of spin: the host enqueues the forward's ~150 launches
        # behind it, so the events see device time only
        ner_ms = time_ms(lambda: ner_forward(deid.params, ner_cfg, ids_t, len_t), flush,
                         reps=10, spin_cycles=40_000_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            ner_forward(deid.params, ner_cfg, ids_t, len_t)
        torch.cuda.synchronize()
        ner_wall_ms = (time.perf_counter() - t0) * 100
    del flush
    log(f"  deidentify_batch of 32 notes ({ids32.shape[0]} windows x {ids32.shape[1]} "
        f"tokens): {batch32_wall * 1e3:.1f} ms wall; tagger forward {ner_ms:.3f} ms of "
        f"device time (CUDA events), {ner_wall_ms:.3f} ms wall a forward back to back")

    # instruments of the counted run: masked texts, INDEXED times, spans,
    # and every tagger batch the deid worker served (texts, ids, lengths
    # and the logits it masked with)
    masked, indexed_at, served_spans, served = {}, {}, [0], []
    deidentify, set_status = deid.deidentify_batch, registry.set_status_unless_deleted
    ner_results, ner_logits = deid._ner_results, deid.ner_logits

    def recording_deidentify(batch):
        out = deidentify(batch)
        masked.update(zip(batch, out))
        return out

    def recording_status(doc_id, status, n_chunks=None):
        ok = set_status(doc_id, status, n_chunks=n_chunks)
        if status == reg.INDEXED:
            indexed_at[doc_id] = time.perf_counter()
        return ok

    def recording_logits(ids, lengths):
        out = ner_logits(ids, lengths)
        served.append({"ids": ids, "lengths": lengths, "logits": out})
        return out

    def recording_spans(batch):
        n = len(served)
        out = ner_results(batch)
        served_spans[0] += sum(map(len, out))
        if len(served) > n:  # one deid worker: the forward this call made
            served[n]["texts"] = list(batch)
        return out

    def untap():
        deid.deidentify_batch, deid._ner_results = deidentify, ner_results
        deid.ner_logits = ner_logits
        registry.set_status_unless_deleted = set_status

    deid.deidentify_batch = recording_deidentify
    registry.set_status_unless_deleted = recording_status
    deid._ner_results, deid.ner_logits = recording_spans, recording_logits
    pool = None
    try:
        pipe.start()
        rows0, nf0, ne0 = store.count, deid.forwards, encoder.forwards
        torch.cuda.synchronize()
        reset_peak()
        counts.clear()
        t_start = time.perf_counter()
        uploaded = []
        with peak_reading("ingest_batch"):
            for d in docs:
                rec = pipe.ingest_document(d["filename"], d["data"])
                uploaded.append((rec.doc_id, time.perf_counter()))
            t_uploaded = time.perf_counter() - t_start
            deadline = time.perf_counter() + INGEST_TIMEOUT_S
            for doc_id, _t in uploaded:
                if not pipe.wait_indexed(doc_id,
                                         timeout=max(0.0, deadline - time.perf_counter())):
                    raise AssertionError(
                        f"{doc_id} not INDEXED: {registry.get(doc_id).status} "
                        f"({registry.get(doc_id).status_detail})")
        wall = max(indexed_at[d] for d, _t in uploaded) - t_start
        launches = dict(counts)
        n_ner, n_enc = deid.forwards - nf0, encoder.forwards - ne0
        peak_gib = peak_allocated() / 2**30
        untap()

        # ---- what must hold over the 512 uploads ----
        want = {"flash_attention.prefill": ner_cfg.num_layers * n_ner + enc_layers * n_enc,
                "flash_attention.decode": 0, "flash_attention.decode_paged": 0,
                "flash_attention.simt": 0}
        got = {key: launches.get(key, 0) for key in want}
        if got != want or launches.get("flash_attention", 0) != want["flash_attention.prefill"]:
            raise AssertionError(
                f"ingest launches {launches}, expected {want} ({n_ner} tagger forwards "
                f"x {ner_cfg.num_layers} layers + {n_enc} encoder forwards x {enc_layers})")
        new_rows = store.metadata_rows()[rows0:]
        n_chunks = sum(registry.get(d).n_chunks for d, _t in uploaded)
        masked_docs = [masked[texts[d["filename"]]] for d in docs]
        n_expected = sum(len(chunk_text(m, cfg.chunk)) for m in masked_docs)
        if not (n_chunks == len(new_rows) == store.count - rows0 == n_expected):
            raise AssertionError(
                f"registry n_chunks {n_chunks}, store rows gained {store.count - rows0}, "
                f"chunk_text over the masked texts {n_expected}")
        joined = "\x00".join(r["text_content"] for r in new_rows)
        leaked = [s for d in docs for s in d["phi"] if s in joined]
        if leaked:
            raise AssertionError(f"header PHI survived into the store: {leaked[:5]}")
        lat = sorted(indexed_at[d] - t for d, t in uploaded)
        spans = {name: DEFAULT_REGISTRY.histogram(f"{name}_ms").summary()["p50"]
                 for name in ("extract", "deid_batch", "index_batch")}
        log(f"  {INGEST_DOCS} uploads ({sum(d['filename'].endswith('.docx') for d in docs)} "
            f"docx, {sum(d['filename'].endswith('.pdf') for d in docs)} pdf) INDEXED in "
            f"{wall:.2f} s (uploads queued in {t_uploaded:.2f} s): "
            f"{INGEST_DOCS / wall:.1f} docs/s, {len(new_rows) / wall:.1f} chunks/s; upload -> "
            f"INDEXED p50 {statistics.median(lat):.3f} s max {lat[-1]:.3f} s; span p50 "
            f"extract {spans['extract']:.2f} ms, deid_batch {spans['deid_batch']:.1f} ms, "
            f"index_batch {spans['index_batch']:.1f} ms; {n_ner} tagger + {n_enc} encoder "
            f"forwards, launches {got}; {served_spans[0]} NER spans served; peak device "
            f"memory {peak_gib:.2f} GiB")

        # ---- served tagger batches against the port on the CPU in float32 ----
        # the batches of the shape the deid worker served most (8 windows x
        # 512: the K1 launch the path made most), in order, until they hold
        # CPU_CHECK_DOCS documents: their masked texts, their logits and
        # their word labels as served, against the CPU on the same batches
        shapes = collections.Counter(bt["ids"].shape for bt in served)
        served_shape, n_at_shape = shapes.most_common(1)[0]
        checked, n_docs = [], 0
        for bt in served:
            if bt["ids"].shape == served_shape and n_docs < CPU_CHECK_DOCS:
                checked.append(bt)
                n_docs += len(bt["texts"])
        cpu_cfg = dataclasses.replace(ner_cfg, dtype="float32")
        cpu = DeidEngine.trained(cpu_cfg, params_path=tagger, device="cpu")
        _memo_logits(cpu)  # one float32 forward a batch serves both checks
        # the host's span logic fed the card's own logits must give the
        # pipeline's masked texts exactly
        replay = DeidEngine.trained(cpu_cfg, params_path=tagger, device="cpu")
        t0 = time.perf_counter()
        held, n_flipped_docs, n_differ = [], 0, 0
        for bt in checked:
            held.append(_hold_tagger_batch(cpu, bt))
            flipped_docs = held[-1][5]
            n_flipped_docs += len(flipped_docs)
            replay.ner_logits = lambda ids, lengths, out=bt["logits"]: out
            if replay.deidentify_batch(bt["texts"]) != [masked[t] for t in bt["texts"]]:
                raise AssertionError("the card's logits, replayed through the host's span "
                                     "logic, do not give the pipeline's masked texts")
            for text, want in zip(bt["texts"], cpu.deidentify_batch(bt["texts"])):
                if masked[text] != want:
                    n_differ += 1
                    if text not in flipped_docs:
                        raise AssertionError(
                            "the masked text of a served document differs between the "
                            "card's pipeline and the CPU in float32, with no word whose "
                            "label or threshold side differs")
        # BASELINE config 2's batch (32 notes, 32 windows x 512: two
        # warpgroups a block), on the pipeline's engine after the run
        card32 = {"texts": batch32, "ids": ids32, "lengths": len32,
                  "logits": deid.ner_logits(ids32, len32)}
        rel32, words32, tied32, flipped32, diff32, _unc = _hold_tagger_batch(cpu, card32)
        cpu_s = time.perf_counter() - t0
        rel = max(h[0] for h in held)
        n_words, n_tied, n_flipped = (sum(h[i] for h in held) for i in (1, 2, 3))
        max_diff = max(h[4] for h in held)
        log(f"  served tagger batches: {len(served)}, shapes {dict(shapes)}; "
            f"{len(checked)} of shape {served_shape} holding {n_docs} documents held "
            f"against the CPU in float32: masked texts identical but {n_differ}, all "
            f"among {n_flipped_docs} documents with a word whose label or threshold side "
            f"differs (the card's logits replayed on the host give its masked texts "
            f"exactly), logits relative RMS "
            f"<= {rel:.3e} (tolerance {FIRST_STEP_RTOL}), word labels equal but "
            f"{n_flipped} of {n_words}, all among {n_tied} tied words (max |logit diff| "
            f"{max_diff:.3e}); the 32-window batch: relative RMS {rel32:.3e}, labels "
            f"equal but {flipped32} of {words32}, all among {tied32} tied; "
            f"CPU check {cpu_s:.1f} s")

        # ---- self-retrieval over the whole store, and /ask over a chunk ----
        picks = np.random.default_rng(5).choice(len(new_rows), SELF_RETRIEVAL_ROWS,
                                                replace=False)
        queries = [new_rows[i]["text_content"] for i in picks]
        hits = qa_solo.retriever.search_texts(queries, k=2)
        missed = [i for i, (q, h) in enumerate(zip(queries, hits))
                  if h[0].metadata.get("text_content") != q]
        margins = [h[0].score - h[1].score for h in hits]
        if missed:
            raise AssertionError(f"self-retrieval missed rank 1 for {len(missed)} of "
                                 f"{SELF_RETRIEVAL_ROWS} rows over {store.count} rows")
        row = new_rows[int(picks[0])]
        out = qa_solo.ask(row["text_content"])
        _no_degraded("/ask over an ingested chunk", [out])
        if row["source"] not in out["sources"]:
            raise AssertionError(f"/ask over a chunk of {row['source']} cites {out['sources']}")
        log(f"  self-retrieval: {SELF_RETRIEVAL_ROWS} of {SELF_RETRIEVAL_ROWS} new rows "
            f"first over {store.count} rows (rank 1 - rank 2 score margin min "
            f"{min(margins):.4f}); /ask over a chunk of {row['source']} cites {out['sources']}")

        # ---- /ask beside a concurrent ingest, through a 1-replica pool ----
        res_cfg = ResilienceConfig()
        pool = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=8), qos=QoSConfig(),
                          chunk=16, cache_len=1024, device=dev)
        qa = QAService(encoder, store, gen, k=3, device=dev, batcher=pool,
                       breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                             res_cfg.breaker_reset_s),
                       resilience=res_cfg)
        questions = list(QUESTIONS) * 2
        t0 = time.perf_counter()
        alone = _round_record(_resolve_all(_submit_round(qa, questions)),
                              time.perf_counter() - t0)
        counts.clear()
        nf1, ne1 = deid.forwards, encoder.forwards
        extra_ids = []

        def upload():
            for d in extra:
                extra_ids.append(pipe.ingest_document(d["filename"], d["data"]).doc_id)

        uploader = threading.Thread(target=upload)
        t0 = time.perf_counter()
        uploader.start()
        beside = _round_record(_resolve_all(_submit_round(qa, questions)),
                               time.perf_counter() - t0)
        uploader.join(timeout=INGEST_TIMEOUT_S)
        for doc_id in extra_ids:
            if not pipe.wait_indexed(doc_id, timeout=INGEST_TIMEOUT_S):
                raise AssertionError(f"concurrent upload {doc_id} not INDEXED")
        concurrent_wall = time.perf_counter() - t0
        round_launches = dict(counts)
        if len(extra_ids) != CONCURRENT_DOCS or alone["degraded"] or beside["degraded"]:
            raise AssertionError(f"concurrent round: {len(extra_ids)} uploads, /ask "
                                 f"degraded alone {alone['degraded']} beside {beside['degraded']}")
        log(f"  8 /ask through a 1-replica pool: alone p50 {alone['latency_p50_s']:.3f} s "
            f"max {alone['latency_max_s']:.3f} s; beside {CONCURRENT_DOCS} uploads p50 "
            f"{beside['latency_p50_s']:.3f} s max {beside['latency_max_s']:.3f} s; all "
            f"{CONCURRENT_DOCS} INDEXED {concurrent_wall:.2f} s after the round began "
            f"({deid.forwards - nf1} tagger + {encoder.forwards - ne1} encoder forwards)")
    finally:
        if pool is not None:
            pool.stop()
        untap()
        pipe.stop()
    summary = {
        "docs": INGEST_DOCS, "chunks": len(new_rows), "wall_s": wall,
        "uploads_queued_s": t_uploaded,
        "docs_per_s": INGEST_DOCS / wall, "chunks_per_s": len(new_rows) / wall,
        "upload_to_indexed_p50_s": statistics.median(lat),
        "upload_to_indexed_max_s": lat[-1],
        "span_p50_ms": spans, "tagger_forwards": n_ner, "encoder_forwards": n_enc,
        "ner_spans_served": served_spans[0], "peak_device_gib": peak_gib,
        "deidentify_batch_32_wall_ms": batch32_wall * 1e3,
        "ner_forward_32_ms": ner_ms, "ner_forward_32_wall_ms": ner_wall_ms,
        "ner_batch_shape": list(ids32.shape),
        "tagger_batches_served": {"x".join(map(str, k)): v for k, v in shapes.items()},
        "cpu_check": {"served_shape": list(served_shape), "batches": len(checked),
                      "docs": n_docs, "masked_texts_identical": True,
                      "words": n_words, "tied_words": n_tied, "labels_differing": n_flipped,
                      "max_abs_logit_diff": max_diff, "logits_rel_rms_max": rel,
                      "batch_32": {"logits_rel_rms": rel32, "words": words32,
                                   "tied_words": tied32, "labels_differing": flipped32,
                                   "max_abs_logit_diff": diff32},
                      "tolerance_rel_rms": FIRST_STEP_RTOL, "seconds": cpu_s},
        "self_retrieval_min_margin": min(margins),
        "ask_alone": alone, "ask_beside_ingest": beside,
        "concurrent_docs_indexed_s": concurrent_wall,
    }
    return {"summary": summary, "launches": launches, "round_launches": round_launches}


# ---- phase 8: observability over the pool and ingest ----------------------------

# the spans every traced /ask of the pool path must hold (submitted and
# resolved as the reference app's /ask does: no qa_e2e span)
ASK_SPANS = frozenset({
    "ask", "qa_retrieve", "fused_query", "dispatch:retrieve",
    "serve_queue_wait", "serve_prefill", "serve_decode_chunk", "serve_result_wait",
})
# the spans of one ingested document's timeline
DOC_SPANS = frozenset({"ingest", "extract", "deid_batch", "index_batch"})
PROFILED_VERIFY_STEPS = 4
# the reference's recorder overhead budget: reported beside the measured
# difference, never asserted (the host's clock spreads 2x between runs)
RECORDER_BUDGET = 0.02
# recorder off/on round pairs, alternating
RECORDER_PAIRS = 3
# the profiler range name of one spine item in the profiled window
ITEM_RANGE = "smoke_spine_item_"
# a decode chunk's kernel busy time (CUPTI) may exceed its CUDA-event span
# by no more than the two clocks' resolution
SPAN_REL_SLACK = 1e-3
SPAN_ABS_SLACK_US = 5.0
# the spine handoff reading: items a pass, passes a side
HANDOFF_ITEMS = 40
HANDOFF_ROUNDS = 2


class _Traced:
    """A PendingAnswer resolved under its /ask trace, as the HTTP layer
    resolves it."""

    def __init__(self, ctx, pending):
        self.ctx, self.pending = ctx, pending

    def resolve(self, timeout):
        return obs.call_in(self.ctx, self.pending.resolve, timeout)


def _traced_round(qa, questions):
    """Round A1's /ask, each under its own trace with an interactive cost
    record (``obs.new_trace`` + ``obs.cost_open``, the reference app's
    /ask), finished once answered.  With the recorder off every trace is
    None and the round runs untraced.  Returns (results, traces)."""
    pend, ctxs = [], []
    for q in questions:
        t0 = time.perf_counter()
        ctx = obs.new_trace("ask")
        obs.cost_open(ctx, "interactive")
        pending = obs.call_in(ctx, qa.ask_submit, q,
                              deadline=Deadline.after(POOL_DEADLINE_S))
        pend.append((q, t0, _Traced(ctx, pending)))
        ctxs.append(ctx)
    results = _resolve_all(pend)
    for ctx in ctxs:
        obs.finish(ctx)
    return results, [c.trace for c in ctxs if c is not None]


def _spine_waits(stats):
    """Per-stage items, mean queue wait and mean device time of a spine
    snapshot, with its lane count."""
    return {
        "n_lanes": stats["n_lanes"],
        "stages": {name: {key: row[key] for key in (
            "count", "queue_wait_mean_ms", "device_mean_ms")}
            for name, row in sorted(stats["stages"].items())},
    }


def _log_spine_waits(where, waits):
    log(f"  spine over {where} ({waits['n_lanes']} lanes): " + ", ".join(
            f"{name} {row['count']} items, queue wait mean "
            f"{row['queue_wait_mean_ms']:.3f} ms, device mean {row['device_mean_ms']:.3f} ms"
            for name, row in waits["stages"].items()))


def _item_kernel_busy_us(events):
    """Kernel time (us) per profiled spine item, from a torch.profiler
    Chrome trace: a kernel belongs to the item whose ``ITEM_RANGE`` range
    holds its launch (joined on the CUPTI correlation id), on the same
    thread when the trace's thread ids join, else by time alone.  Returns
    ``({item: us}, how)``."""
    ranges = [(int(e["name"][len(ITEM_RANGE):]), str(e.get("tid")), e["ts"],
               e["ts"] + e.get("dur", 0.0))
              for e in events
              if e.get("ph") == "X" and str(e.get("name", "")).startswith(ITEM_RANGE)]
    launches = {e["args"]["correlation"]: (str(e.get("tid")), e["ts"])
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    by_tid = bool({r[1] for r in ranges} & {tid for tid, _ in launches.values()})
    busy = collections.defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        for n, r_tid, t0, t1 in ranges:
            if t0 <= ts <= t1 and (r_tid == tid or not by_tid):
                busy[n] += e.get("dur", 0.0)
                break
    return dict(busy), "thread and time" if by_tid else "time"


def spine_handoff(device, items=HANDOFF_ITEMS, rounds=HANDOFF_ROUNDS):
    """What crossing to a spine lane thread costs an item on this host:
    ``items`` small work items (one 64 x 64 matmul) on a fresh spine of
    ``DEFAULT_LANES`` slots, beside a thread running a busy Python loop (as
    ingest's deid worker runs beside its index worker), once on a lane
    thread (``submit(...).result()``) and once on the caller (``run``) a
    round, alternating which goes first.  Returns, per side, the ms an item
    and the busy loop's iterations a second, one entry a round."""
    x = torch.ones(64, 64, device=device)
    spine = DispatchSpine()
    out = {"lane": [], "caller": []}

    def one(on_lane):
        stop, count = threading.Event(), [0]

        def busy():
            while not stop.is_set():
                sum(i * i for i in range(2000))
                count[0] += 1

        loop = threading.Thread(target=busy)
        loop.start()
        t0 = time.perf_counter()
        try:
            for _ in range(items):
                if on_lane:
                    spine.submit("handoff", lambda: (x @ x).sum(), device=device).result()
                else:
                    spine.run("handoff", lambda: (x @ x).sum(), device=device)
        finally:
            wall = time.perf_counter() - t0
            stop.set()
            loop.join()
        return {"ms_per_item": wall / items * 1e3, "busy_loop_per_s": count[0] / wall}

    try:
        for r in range(rounds):
            for side in (("lane", "caller") if r % 2 == 0 else ("caller", "lane")):
                out[side].append(one(side == "lane"))
    finally:
        spine.close()
    return out


def _mfu_table(stats):
    lines = [f"    {'stage':<22} {'calls':>6} {'device_s':>10} {'GFLOP':>10} "
             f"{'MFU':>9} {'FLOP/B':>8} bound"]
    for stage, row in stats["stages"].items():
        mfu = "-" if row["mfu"] is None else f"{row['mfu']:.6f}"
        if "mfu_raw_invalid" in row:
            mfu = f"invalid {row['mfu_raw_invalid']:.3f}"
        inten = row["intensity_flops_per_byte"]
        lines.append(
            f"    {stage:<22} {row['calls']:>6} {row['device_s']:>10.6f} "
            f"{row['flops'] / 1e9:>10.3f} {mfu:>9} "
            f"{'-' if inten is None else f'{inten:.1f}':>8} {row['roofline_bound'] or '-'}")
    return "\n".join(lines)


def run_obs_path(counts, qa_solo, tagger):
    """Phase 8: observability over phase 6's 1-replica pool (16 slots,
    chunk 16, capacity 1,024, K=4) and round A1 (16 /ask, 64 new tokens),
    then one upload through a pipeline configured as phase 7's.

    The round runs ``RECORDER_PAIRS`` times with the recorder off and on,
    alternating (the median difference reported against the reference's
    2 % budget).  Around the last traced round the launch counts,
    the spine's stage series, the observatory and the cost ledger are set
    to 0; after it: every /ask trace complete with ``ASK_SPANS``; the
    observatory's peak names the card; the costed stages with no uncosted
    call and no MFU above 1; every spine item's device time within its
    submit-to-done wall time; the per-class device ms equal to the spine's
    series; a telemetry tick over the pool, the spine, a broker and the
    recorder rendering lint-clean Prometheus text; K1's launch identity.
    A profiler window around at least ``PROFILED_VERIFY_STEPS`` verify
    steps names K1's decode kernel; every decode chunk fetched in it
    launched kernels whose CUPTI time is nonzero and at most its
    CUDA-event span (an event pair on the wrong stream would read near 0);
    the document's timeline holds ``DOC_SPANS``.  Reports what a spine item
    pays to cross to a lane thread (:func:`spine_handoff`)."""
    gen = qa_solo.generator
    dev = gen.device
    dec_cfg = gen.cfg
    encoder, store = qa_solo.retriever.encoder, qa_solo.retriever.store
    enc_layers = encoder.cfg.num_layers
    res_cfg = ResilienceConfig()
    spine = get_spine()
    card = torch.cuda.get_device_name(0)
    pool1 = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=16), qos=QoSConfig(),
                       chunk=16, cache_len=1024, device=dev)
    pipe = None
    try:
        pool1.annotate_costs()
        encoder.annotate_costs()
        qa_solo.retriever.annotate_costs()
        qa1 = QAService(encoder, store, gen, k=3, device=dev, batcher=pool1,
                        breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                              res_cfg.breaker_reset_s),
                        resilience=res_cfg)
        questions = list(QUESTIONS) * 4

        # ---- the recorder off and on, alternating (reported); the last
        # round, recorder on, is the counted and checked one
        pairs = []
        items = []
        settle = spine._settle

        def tapped(item):
            # the item's wall time runs to the end of its accounting
            first = not item.settled
            settle(item)
            if first:
                items.append((item.stage, item.device_s,
                              time.perf_counter() - item.t_submit))

        for i in range(RECORDER_PAIRS):
            obs.set_enabled(False)
            try:
                t0 = time.perf_counter()
                res, traces = _traced_round(qa1, questions)
                off = _round_record(res, time.perf_counter() - t0)
            finally:
                obs.set_enabled(True)
            if traces:
                raise AssertionError(f"recorder off, yet {len(traces)} traces opened")
            counted = i == RECORDER_PAIRS - 1
            if counted:
                spine.reset_stats()
                obs.DEFAULT_OBSERVATORY.reset()
                obs.DEFAULT_COST_LEDGER.reset()
                stats0 = pool1.stats()
                spine._settle = tapped
                counts.clear()
            try:
                t0 = time.perf_counter()
                res, traces = _traced_round(qa1, questions)
                on = _round_record(res, time.perf_counter() - t0)
            finally:
                if counted:
                    del spine._settle
            pairs.append({"off": off, "on": on, "overhead": {
                "p50": on["latency_p50_s"] / off["latency_p50_s"] - 1.0,
                "max": on["latency_max_s"] / off["latency_max_s"] - 1.0,
                "tokens_per_s": 1.0 - on["tokens_per_s"] / off["tokens_per_s"],
            }})
        launches, steps = _quiescent(counts, pool1.stats)
        steps = steps - stats0
        for pair in pairs:
            for r in (pair["off"], pair["on"]):
                if r["degraded"]:
                    raise AssertionError(f"phase 8 degraded answers: {r['degraded']}")
        overhead = {key: {
            "median": statistics.median(p["overhead"][key] for p in pairs),
            "min": min(p["overhead"][key] for p in pairs),
            "max": max(p["overhead"][key] for p in pairs),
        } for key in ("p50", "max", "tokens_per_s")}
        for pair in pairs:
            off, on = pair["off"], pair["on"]
            log(f"  round A1, recorder off: p50 {off['latency_p50_s']:.3f} s max "
                f"{off['latency_max_s']:.3f} s {off['tokens_per_s']:.1f} answer tok/s; on: "
                f"p50 {on['latency_p50_s']:.3f} s max {on['latency_max_s']:.3f} s "
                f"{on['tokens_per_s']:.1f} answer tok/s")
        log(f"  recorder on against off over {RECORDER_PAIRS} alternating pairs, median "
            f"[min, max]: " + ", ".join(
                f"{label} {sign * o['median']:+.1%} "
                f"[{min(sign * o['min'], sign * o['max']):+.1%}, "
                f"{max(sign * o['min'], sign * o['max']):+.1%}]"
                for label, sign, o in (("p50", 1, overhead["p50"]),
                                       ("max", 1, overhead["max"]),
                                       ("tok/s", -1, overhead["tokens_per_s"])))
            + f" (the reference's budget {RECORDER_BUDGET:.0%}, reported, not asserted)")

        # ---- every /ask trace complete, with the expected spans
        if len(traces) != len(questions):
            raise AssertionError(f"{len(traces)} traces for {len(questions)} /ask")
        for tr in traces:
            names = {sp.name for sp in tr.snapshot_spans()}
            ids = {sp.span_id for sp in tr.snapshot_spans()}
            orphans = [sp.name for sp in tr.snapshot_spans()
                       if sp.parent_id is not None and sp.parent_id not in ids]
            if (not tr.finished or tr.status != "ok" or not ASK_SPANS <= names
                    or orphans or obs.DEFAULT_RECORDER.get(tr.trace_id) is not tr):
                raise AssertionError(
                    f"trace {tr.trace_id}: finished {tr.finished}, status {tr.status}, "
                    f"missing {sorted(ASK_SPANS - names)}, orphans {orphans}")
        attribution = obs.attribution(traces)
        log("  attribution over the 16 traced /ask:\n"
            + "\n".join("    " + line for line in obs.format_table(attribution).splitlines()))

        # ---- the observatory: the card's peak, costed stages, MFU <= 1
        stats = obs.DEFAULT_OBSERVATORY.stats()
        peak = stats["peak"]
        if card not in peak["peak_flops_source"] or not peak["peak_flops"]:
            raise AssertionError(f"observatory peak does not name {card}: {peak}")
        for stage in ("serve_prefill_fetch", "serve_decode_chunk"):
            row = stats["stages"].get(stage)
            if row is None or row["uncosted_calls"] or not row["flops"]:
                raise AssertionError(f"{stage}: {row}")
        invalid = {k: v for k, v in stats["stages"].items() if "mfu_raw_invalid" in v}
        if invalid:
            raise AssertionError(f"MFU above 1 in {sorted(invalid)}: {invalid}")
        log(f"  per-stage MFU (analytic FLOPs over CUDA-event device time, peak "
            f"{peak['peak_flops'] / 1e12:.0f} TFLOP/s, {peak['peak_flops_source']}):\n"
            + _mfu_table(stats))

        # ---- every spine item's device time within its wall time
        over = [(st, d, w) for st, d, w in items if d > w]
        if not items or over:
            raise AssertionError(f"{len(over)} of {len(items)} spine items took more "
                                 f"device than wall time: {over[:5]}")

        # ---- per-class device ms equal the spine's series
        counters = spine.telemetry_counters()
        classes = obs.DEFAULT_COST_LEDGER.class_totals()
        reconcile = {}
        for stage, fields in (
            ("serve_prefill_fetch", ("prefill_device_ms_cold", "prefill_device_ms_warm")),
            ("serve_decode_chunk", ("decode_device_ms",)),
            ("retrieve", ("retrieve_device_ms",)),
        ):
            spine_ms = counters.get(f"dispatch_device_ms_{stage}", 0.0)
            attributed = sum(row.get(f, 0.0) for row in classes.values() for f in fields)
            reconcile[stage] = {"spine_ms": spine_ms, "attributed_ms": attributed}
            if not spine_ms or abs(attributed - spine_ms) > 1e-6 * spine_ms:
                raise AssertionError(f"{stage}: classes {attributed} ms, spine "
                                     f"{spine_ms} ms")
        log(f"  per-class device ms = the spine's series: {reconcile}")

        # ---- K1's launch identity over the traced round
        want = {
            "flash_attention.decode_paged": dec_cfg.num_layers * (
                steps["verify_steps"] + steps["decode_steps"] + steps["warmup_steps"]),
            "flash_attention.prefill": enc_layers * len(questions),
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want:
            raise AssertionError(f"obs phase launches {got}, expected {want}")

        # ---- a profiler window around verify steps: each decode chunk's
        # CUDA-event span held against the CUPTI time of the kernels it
        # launched
        before = pool1.stats()["verify_steps"]
        paged0 = counts["flash_attention.decode_paged"]
        execute, seq, window = spine._execute, itertools.count(), {}

        def annotated(item):
            # a profiler range per item on the thread that executes it (a
            # lane's or its caller's): the launches inside it are the item's
            n = next(seq)
            window[n] = item
            with torch.profiler.record_function(f"{ITEM_RANGE}{n}"):
                execute(item)

        logdir = obs.DEFAULT_PROFILER.start(device=dev)  # a temporary directory
        spine._execute = annotated
        try:
            pool1.submit_text(_pool_prompt(qa_solo, QUESTIONS[0]), max_new_tokens=8,
                              deadline=Deadline.after(POOL_DEADLINE_S)).result(timeout=120)
        finally:
            del spine._execute
            obs.DEFAULT_PROFILER.stop()
        profiled_steps = pool1.stats()["verify_steps"] - before
        with open(obs.DEFAULT_PROFILER.trace_path) as f:
            events = json.load(f)["traceEvents"]
        shutil.rmtree(logdir, ignore_errors=True)
        kernel_names = collections.Counter(
            e["name"] for e in events if e.get("cat") == "kernel")
        k1 = {n: c for n, c in kernel_names.items() if "flash_decode_kernel" in n}
        if profiled_steps < PROFILED_VERIFY_STEPS or not k1:
            raise AssertionError(f"profiler window: {profiled_steps} verify steps, K1 "
                                 f"decode kernels {k1}, {len(kernel_names)} kernel names")
        if counts["flash_attention.decode_paged"] == paged0:
            raise AssertionError("profiler window: no paged decode launch counted")
        busy, matched_by = _item_kernel_busy_us(events)
        chunks = []
        for n, item in sorted(window.items()):
            # a chunk still unfetched when the window closed has no span
            if item.stage != "serve_decode_chunk" or not item.settled or item.error:
                continue
            span_us, busy_us = item.device_s * 1e6, busy.get(n, 0.0)
            chunks.append({"span_ms": span_us / 1e3, "busy_ms": busy_us / 1e3,
                           "busy_share": busy_us / span_us if span_us else None})
            if not 0.0 < busy_us <= span_us * (1 + SPAN_REL_SLACK) + SPAN_ABS_SLACK_US:
                raise AssertionError(
                    f"decode chunk {n}: CUDA-event span {span_us:.1f} us, kernel busy "
                    f"{busy_us:.1f} us (launches matched by {matched_by}, "
                    f"{len(busy)} items with kernels)")
        if not chunks:
            raise AssertionError(f"profiler window: no fetched decode chunk among "
                                 f"{[it.stage for it in window.values()]}")
        log(f"  profiler window: {profiled_steps} verify steps, {sum(kernel_names.values())} "
            f"kernel events; K1 {k1}")
        log(f"  decode chunks in the window (launches matched to items by {matched_by}): "
            + "; ".join(f"span {c['span_ms']:.3f} ms, kernel busy {c['busy_ms']:.3f} ms "
                        f"({c['busy_share']:.1%})" for c in chunks))

        # ---- one document through a pipeline configured as phase 7's
        ner_cfg = NERConfig()
        deid = DeidEngine.trained(ner_cfg, params_path=tagger, device=dev)
        cfg = Config(encoder=encoder.cfg, ner=ner_cfg, store=store.cfg)
        pipe = DocumentPipeline(cfg, make_broker(cfg.broker),
                                DocumentRegistry(cfg.registry.url), deid, encoder, store)
        doc = ingest_corpus(np.random.default_rng(808), 1, "obs")[0]
        pipe.start()
        doc_id = pipe.ingest_document(doc["filename"], doc["data"]).doc_id
        if not pipe.wait_indexed(doc_id, timeout=INGEST_TIMEOUT_S):
            raise AssertionError(f"phase 8 upload {doc_id} not INDEXED")
        doc_trace = next(t for t in obs.DEFAULT_RECORDER.recent(64)
                         if t.root.attrs.get("doc_id") == doc_id)
        spans = doc_trace.snapshot_spans()
        doc_names = collections.Counter(sp.name for sp in spans)
        parents = {sp.parent_id for sp in spans if sp.parent_id is not None}
        if (set(doc_names) != DOC_SPANS or any(n != 1 for n in doc_names.values())
                or parents != {doc_trace.root.span_id} or doc_trace.status != "ok"):
            raise AssertionError(f"document timeline {dict(doc_names)}, parents "
                                 f"{parents}, status {doc_trace.status}")
        log(f"  ingested document: {obs.timeline_dict(doc_trace)['spans'][1:]!r:.300}")

        # ---- a telemetry tick over the pool, the spine, a broker, the recorder
        store_t = obs.TelemetryStore(interval_s=10.0, points=60)
        slo = obs.BurnRateEvaluator(store_t, obs.default_ask_slos(8000.0),
                                    registry=DEFAULT_REGISTRY,
                                    recorder=obs.DEFAULT_RECORDER)
        sampler = obs.TelemetrySampler(
            store_t, registry=DEFAULT_REGISTRY, batcher=pool1, broker=pipe.broker,
            queues=(cfg.broker.raw_queue, cfg.broker.clean_queue),
            recorder=obs.DEFAULT_RECORDER, engine=gen, slo_evaluator=slo,
            spine=spine, extra_probes=[obs.DEFAULT_COST_LEDGER.telemetry_gauges],
        )
        sampler.tick()
        lint = {om: lint_prometheus_text(prometheus_text(DEFAULT_REGISTRY, store_t,
                                                         openmetrics=om))
                for om in (False, True)}
        gauges = store_t.latest_gauges()
        needed = ("pool_replica0_alive", "dispatch_occupancy", "trace_open",
                  f"broker_depth_{cfg.broker.raw_queue}", "device_mem_allocated_bytes")
        if any(lint.values()) or any(n not in gauges for n in needed):
            raise AssertionError(f"telemetry: lint {lint}, missing "
                                 f"{[n for n in needed if n not in gauges]}")
        log(f"  telemetry tick: {len(store_t.names())} series, Prometheus text lint-clean "
            f"in both dialects; device_mem_allocated_bytes "
            f"{gauges['device_mem_allocated_bytes'] / 2**30:.2f} GiB")
        # ---- what a lane crossing costs an item here (reported)
        handoff = spine_handoff(dev)
        log("  spine handoff beside a busy Python thread, ms an item (busy loops/s): "
            + "; ".join(f"{side} " + ", ".join(
                f"{h['ms_per_item']:.3f} ({h['busy_loop_per_s']:.0f})" for h in runs)
                for side, runs in handoff.items()))
        summary = {
            "recorder_pairs": pairs, "recorder_overhead": overhead, "spine_handoff": handoff,
            "recorder_budget": RECORDER_BUDGET, "attribution": attribution,
            "observatory": stats, "reconcile": reconcile, "spine_items": len(items),
            "launches": got, "profiled_verify_steps": profiled_steps,
            "profiled_k1_kernels": k1, "profiled_chunks": chunks,
            "profiled_launch_match": matched_by, "document_spans": dict(doc_names),
            "telemetry_series": len(store_t.names()),
        }
        return {"summary": summary, "launches": launches}
    finally:
        if pipe is not None:
            pipe.stop()
        pool1.stop()


# ---- phase 9: the HTTP app ----------------------------------------------------

APP_NOTES = 16
# notes 1 and 9 go up as .docx, 2 and 10 as .pdf
APP_BINARY_EVERY = 8
APP_PATIENTS = ("P001", "P002", "P003", "P004")
APP_ASKS = 8
APP_FRONT_PAIRS = 10
APP_INDEX_TIMEOUT_S = 300.0
# the /ask budget (the default config's is 8 s): a 256-token answer at the
# port's host-bound decode step (PERF.md section 5) outlasts 8 s, and a shed
# answer is degraded; the phase reports how many asks took longer than 8 s
APP_DEADLINE_S = 120.0
DEFAULT_DEADLINE_S = 8.0
APP_HTTP_TIMEOUT_S = 900.0
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))

_CONTRACT_SCALARS = {
    "str": (str,), "int": (int,), "float": (float,), "number": (int, float),
    "bool": (bool,),
}


def _leaf_ok(value, leaf):
    for alt in (a.strip() for a in leaf.split("|")):
        if alt == "any" or (alt == "null" and value is None):
            return True
        types = _CONTRACT_SCALARS.get(alt)
        if types is None or (isinstance(value, bool) and alt != "bool"):
            continue
        if isinstance(value, types):
            return True
    return False


def contract_violations(value, spec, open_=False, path="$"):
    """Violations of ``value`` against an ``api_contract.json`` spec node:
    a copy of ``validate_value`` of the reference's wire audit (leaves
    ``str|int|float|number|bool|any|null`` with ``|`` unions, ``[spec]``
    lists, ``key?`` optional keys, ``*`` open maps, ``_nonfinite_fields``
    always tolerated)."""
    if isinstance(spec, str):
        return [] if _leaf_ok(value, spec) else [
            f"{path}: expected {spec}, got {type(value).__name__} ({value!r:.80})"]
    if isinstance(spec, list):
        if not isinstance(value, list):
            return [f"{path}: expected list, got {type(value).__name__}"]
        elem = spec[0] if spec else "any"
        return [v for i, x in enumerate(value)
                for v in contract_violations(x, elem, open_, f"{path}[{i}]")]
    if not isinstance(spec, dict):
        return [f"{path}: malformed spec node {spec!r}"]
    if not isinstance(value, dict):
        return [f"{path}: expected object, got {type(value).__name__}"]
    out = []
    declared = {k.rstrip("?"): (sub, not k.endswith("?"))
                for k, sub in spec.items() if k != "*"}
    for k, (sub, required) in declared.items():
        if k in value:
            out += contract_violations(value[k], sub, open_, f"{path}.{k}")
        elif required:
            out.append(f"{path}: missing required key '{k}'")
    for k, v in value.items():
        if k in declared or k == "_nonfinite_fields":
            continue
        if "*" in spec:
            out += contract_violations(v, spec["*"], open_, f"{path}.{k}")
        elif not open_:
            out.append(f"{path}: undeclared key '{k}'")
    return out


def load_contract():
    """The repository's ``api_contract.json`` endpoint entries."""
    with open(os.path.join(REPO_ROOT, "api_contract.json"), encoding="utf-8") as f:
        return json.load(f)["endpoints"]


def contract_check(contract, key, status, body):
    """Status and body of one response against its contract entry (the
    reference's ``validate_response``); raises on a violation."""
    entry = contract[key]
    allowed = entry.get("statuses", [200])
    if status not in allowed:
        bad = [f"$: status {status} not in declared {allowed}"]
    elif status != 200:
        bad = contract_violations(body, {"detail": "str"})
    elif entry.get("response") is None:
        bad = []
    else:
        bad = contract_violations(body, entry["response"], bool(entry.get("open")))
    if bad:
        raise AssertionError(f"{key}: contract violations {bad[:5]}")


def _multipart(filename, data, fields):
    """A ``multipart/form-data`` body: the file, then each non-None field."""
    boundary = "docqa-smoke-boundary"
    parts = [(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
              f'filename="{filename}"\r\nContent-Type: application/octet-stream'
              "\r\n\r\n").encode() + data + b"\r\n"]
    parts += [(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
               f"\r\n\r\n{v}\r\n").encode() for k, v in fields.items() if v is not None]
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def _parse_sse(text):
    """[(event name, decoded data)] of a server-sent event stream."""
    events = []
    for block in text.split("\n\n"):
        name, data = "data", []
        for line in block.split("\n"):
            if line.startswith("event:"):
                name = line.split(":", 1)[1].strip()
            elif line.startswith("data:"):
                data.append(line.split(":", 1)[1].strip())
        if data:
            events.append((name, json.loads("\n".join(data))))
    return events


class _Http:
    """``urllib.request`` against one local app server, every JSON answer
    held to ``api_contract.json``."""

    def __init__(self, port, contract):
        self.base = f"http://127.0.0.1:{port}"
        self.contract = contract

    def raw(self, method, path, body=None, ctype="application/json", headers=None):
        import urllib.error
        import urllib.request

        h = dict(headers or {})
        if body is not None:
            h["Content-Type"] = ctype
        req = urllib.request.Request(self.base + path, data=body, method=method, headers=h)
        try:
            with urllib.request.urlopen(req, timeout=APP_HTTP_TIMEOUT_S) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    def json(self, key, path, payload=None, body=None, ctype="application/json",
             expect=200):
        method = key.split(" ", 1)[0]
        if payload is not None:
            body = json.dumps(payload).encode()
        status, _h, raw = self.raw(method, path, body, ctype)
        out = json.loads(raw) if raw else None
        contract_check(self.contract, key, status, out)
        if status != expect:
            raise AssertionError(f"{key} {path}: status {status}, expected {expect}: {out}")
        return out


def app_notes(rng):
    """``APP_NOTES`` uploads of phase 7's generator (2 .docx, 2 .pdf),
    each with a patient, a type and a date."""
    docs = ingest_corpus(rng, APP_NOTES, "app", binary_every=APP_BINARY_EVERY)
    for i, d in enumerate(docs):
        d["fields"] = {"patient_id": APP_PATIENTS[i % len(APP_PATIENTS)],
                       "doc_type": "consultation", "doc_date": f"2024-{i % 12 + 1:02d}-15"}
    return docs


def routing_lookups(router, n=2, deid=None):
    """The first ``n`` lookups of ``data/routing_mix.jsonl`` the router
    routes and whose own document passes its evidence gate.  With a
    ``deid`` engine the document is gated as the store will hold it, masked,
    and a lookup qualifies only when every word it shares with its document
    survives the masking: a trained tagger masks the patient's name, and a
    lookup by a masked name has nothing left to match."""
    with open(os.path.join(REPO_ROOT, "data", "routing_mix.jsonl"), encoding="utf-8") as f:
        mix = [json.loads(line) for line in f if line.strip()]
    out = []
    for row in mix:
        if "doc" not in row:
            continue
        doc = row["doc"]
        if deid is not None:
            doc = deid.deidentify_batch([doc])[0]
            words = [set(re.findall(r"\w+", t.lower())) for t in (row["question"], row["doc"], doc)]
            if not (words[0] & words[1]) <= words[2]:
                continue
        d = router.decide(row["question"])
        gated, _ev = router.evidence_gate(d, row["question"], [doc])
        if gated.route == "extractive":
            out.append(row)
    generative = [r["question"] for r in mix if router.decide(r["question"]).route != "extractive"]
    return out[:n], generative


def _wait_indexed(http, doc_ids, timeout=APP_INDEX_TIMEOUT_S):
    """Poll ``GET /documents/{id}`` until every upload is INDEXED."""
    deadline = time.perf_counter() + timeout
    pending = set(doc_ids)
    while pending:
        for doc_id in sorted(pending):
            rec = http.json("GET /documents/{doc_id}", f"/documents/{doc_id}")
            if rec["status"] == reg.INDEXED:
                pending.discard(doc_id)
            elif rec["status"].startswith("ERROR") or rec["status"] == reg.DELETED:
                raise AssertionError(f"upload {doc_id} ended {rec}")
        if pending and time.perf_counter() > deadline:
            raise AssertionError(f"{len(pending)} uploads not INDEXED in {timeout} s")
        if pending:
            time.sleep(0.2)


class _Capture:
    """Keeps the ``PendingAnswer`` of every ``/ask`` the runtime's QA
    service submits (the handler wraps nothing else)."""

    def __init__(self, qa):
        self.qa, self.real, self.pending = qa, qa.ask_submit, []

    def __enter__(self):
        def submit(*a, **kw):
            p = self.real(*a, **kw)
            self.pending.append(p)
            return p

        self.qa.ask_submit = submit
        return self

    def __exit__(self, *exc):
        self.qa.ask_submit = self.real


def _tap_prefill():
    """Record (ids, logits) of every ragged-prefill lane that starts at
    position 0, until the returned ``untap`` is called."""
    forward, lanes = serve_mod.ragged_prefill_forward, []

    def tap(params, cfg, pools, ids_t, seg, pos, dest, last_rows, **kw):
        logits = forward(params, cfg, pools, ids_t, seg, pos, dest, last_rows, **kw)
        seg_h, ids_h, pos_h = seg.cpu(), ids_t.cpu(), pos.cpu()
        for lane in range(last_rows.shape[0]):
            mine = seg_h == lane
            if int(mine.sum()) and int(pos_h[mine][0]) == 0:
                lanes.append((ids_h[mine].tolist(), logits[lane].float().clone()))
        return logits

    serve_mod.ragged_prefill_forward = tap

    def untap():
        serve_mod.ragged_prefill_forward = forward

    return lanes, untap


def _pctl(values, q):
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def run_app_path(counts, qa, tagger, ingest_docs_s=None):
    """Phase 9: ``DocQARuntime`` under the default ``Config`` (decoder at
    Mistral-7B width sharing phase 3's seeded card weights, ``ner.params_path``
    the tagger phase 11 (a) cached, loaded at boot) behind its stdlib HTTP front on 127.0.0.1, driven
    over real HTTP.  ``counts`` is reset around each counted run."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.engines.router import AnswerRouter
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, Request, make_app

    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    dev = qa.generator.device
    contract = load_contract()
    cfg = dataclasses.replace(
        load_config(env={}, overrides={
            "ner.params_path": tagger,
            "resilience.request_deadline_s": APP_DEADLINE_S,
        }),
        decoder=qa.generator.cfg,
    )
    t0 = time.perf_counter()
    rt = DocQARuntime(cfg, device=dev, decoder_params=qa.generator.params).start()
    server = AppServer(make_app(rt)).start()
    boot_s = time.perf_counter() - t0
    lookups, generative = routing_lookups(AnswerRouter(), deid=rt.deid)
    http = _Http(server.port, contract)
    launches = collections.Counter()
    summary = {"boot_s": boot_s}
    log(f"  runtime booted in {boot_s:.1f} s; serving on 127.0.0.1:{server.port}")
    try:
        if len(lookups) < 2 or len(generative) < APP_ASKS + 2:
            raise AssertionError("the routing mix lacks the questions phase 9 asks")
        log(f"  lookups whose evidence survives the tagger: {[r['id'] for r in lookups]}")
        if http.json("GET /health", "/health") != {"status": "ok"}:
            raise AssertionError("/health is not ok")
        http.json("GET /api/status", "/api/status")

        # -- ingest over HTTP: 16 notes (multipart) + the lookups' documents
        docs = app_notes(np.random.default_rng(21))
        counts.clear()
        t0 = time.perf_counter()
        patient_of = {}
        for d in docs:
            body, ctype = _multipart(d["filename"], d["data"], d["fields"])
            out = http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)
            patient_of[out["doc_id"]] = d["fields"]["patient_id"]
        lookup_doc = {}
        for i, row in enumerate(lookups):
            out = http.json("POST /ingest/", "/ingest/", payload={
                "filename": f"lookup-{i}.txt", "text": row["doc"], "patient_id": "P900"})
            patient_of[out["doc_id"]] = "P900"
            lookup_doc[row["question"]] = out["doc_id"]
        _wait_indexed(http, list(patient_of))
        ingest_s = time.perf_counter() - t0
        launches.update(counts)
        summary["ingest"] = {
            "uploads": len(patient_of), "seconds": ingest_s,
            "docs_per_s": len(patient_of) / ingest_s,
            "in_process_docs_per_s_phase7": ingest_docs_s,
            "rows": rt.store.count, "launches": dict(counts),
        }
        log(f"  /ingest/: {len(patient_of)} uploads (2 docx, 2 pdf) INDEXED over HTTP in "
            f"{ingest_s:.2f} s = {len(patient_of) / ingest_s:.1f} docs/s "
            f"(phase 7 in process: {ingest_docs_s}); {rt.store.count} rows")

        # -- patient snippets: a filter returns only that patient's rows
        rows = http.json("GET /api/search/patient-snippets",
                         "/api/search/patient-snippets?patient_id=P002")
        if not rows or any(patient_of[r["doc_id"]] != "P002" for r in rows):
            raise AssertionError(f"patient-snippets for P002 returned {rows[:3]}")
        focus = http.json("GET /api/search/patient-snippets",
                          "/api/search/patient-snippets?patient_id=P003&focus=traitement")
        if not focus or any(patient_of[r["doc_id"]] != "P003" for r in focus):
            raise AssertionError("a focused patient-snippets left its patient")

        # -- the summarizer and the two syntheses, at once, before any /ask:
        # once /ask latency burns the default SLO, batch work is deferred
        counts.clear()
        jobs = [
            ("POST /api/llm/summarize", "/api/llm/summarize",
             {"prompt": "Résume ce dossier : " + rows[0]["text"]}),
            ("POST /api/synthese/patient", "/api/synthese/patient", {"patient_id": "P001"}),
            ("POST /api/synthese/comparaison", "/api/synthese/comparaison",
             {"patient_ids": ["P001", "P002"]}),
        ]
        synth = [None] * len(jobs)

        def run_job(i, key, path, payload):
            t = time.perf_counter()
            synth[i] = (http.json(key, path, payload=payload), time.perf_counter() - t)

        threads = [threading.Thread(target=run_job, args=(i, *j)) for i, j in enumerate(jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=APP_HTTP_TIMEOUT_S)
        if any(s is None for s in synth):
            raise AssertionError("a summary or synthesis did not answer")
        launches.update(counts)
        if not synth[0][0]["summary"] or synth[1][0]["patient_id"] != "P001":
            raise AssertionError(f"summaries came back empty: {synth[0][0]}")
        summary["summaries_s"] = [s[1] for s in synth]

        # -- one decode-routed /ask alone: its served first-step logits
        counts.clear()
        lanes, untap = _tap_prefill()
        try:
            with _Capture(rt.qa) as cap:
                out = http.json("POST /ask/", "/ask/", payload={"question": generative[0]})
        finally:
            untap()
        launches.update(counts)
        tokens = cap.pending[0].handle.result(timeout=60)
        if out.get("degraded") or "route" in out or not lanes:
            raise AssertionError(f"the first-step /ask was not decoded: {out}")
        ids, served = max(lanes, key=lambda lane: len(lane[0]))
        solo = solo_first_step(qa.generator, ids)
        summary["first_step"] = check_first_step("app over HTTP", solo, served, tokens[0], len(ids))

        # -- 8 concurrent decode-routed /ask
        counts.clear()
        results = [None] * APP_ASKS

        def ask(i, q):
            t = time.perf_counter()
            results[i] = (http.json("POST /ask/", "/ask/", payload={"question": q}),
                          time.perf_counter() - t)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i, q))
                   for i, q in enumerate(generative[1:APP_ASKS + 1])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=APP_HTTP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if any(r is None for r in results):
            raise AssertionError("a concurrent /ask over HTTP did not answer")
        outs = [r[0] for r in results]
        _no_degraded("app /ask", outs)
        if any("route" in o for o in outs):
            raise AssertionError("a generative question was routed")
        decoded = counts["flash_attention.decode_paged"]
        if decoded == 0:
            raise AssertionError(f"8 decoded /ask launched no paged decode: {dict(counts)}")
        launches.update(counts)
        lat = [r[1] for r in results]
        n_tok = sum(len(_tokens(o["answer"])) for o in outs)
        summary["ask"] = {
            "requests": APP_ASKS, "p50_s": _pctl(lat, 0.5), "p95_s": _pctl(lat, 0.95),
            "wall_s": wall, "answer_tokens": n_tok, "tokens_per_s": n_tok / wall,
            "decode_paged_launches": decoded,
            "over_default_deadline": sum(x > DEFAULT_DEADLINE_S for x in lat),
        }
        log(f"  {APP_ASKS} concurrent /ask over HTTP: p50 {summary['ask']['p50_s']:.2f} s, "
            f"p95 {summary['ask']['p95_s']:.2f} s, {n_tok} answer tokens in {wall:.2f} s = "
            f"{n_tok / wall:.1f} tokens/s; decode_paged launches {decoded}; "
            f"{summary['ask']['over_default_deadline']} over the default "
            f"{DEFAULT_DEADLINE_S:.0f} s budget")

        # -- 2 routed lookups: answered from retrieval, no decode
        counts.clear()
        routed = {}
        for row in lookups:
            t = time.perf_counter()
            out = http.json("POST /ask/", "/ask/", payload={"question": row["question"]})
            routed[row["question"]] = (out, time.perf_counter() - t)
            if out.get("route") != "extractive":
                raise AssertionError(f"lookup {row['question']!r} was not routed: {out}")
            if f"Dossier Patient {lookup_doc[row['question']]}" not in out["sources"]:
                raise AssertionError(f"lookup {row['question']!r} missed its document")
        decode_keys = ("flash_attention.decode", "flash_attention.decode_paged")
        if any(counts[k] for k in decode_keys):
            raise AssertionError(f"routed answers launched a decode: {dict(counts)}")
        launches.update(counts)
        summary["routed"] = {"requests": len(routed),
                             "latency_s": [v[1] for v in routed.values()],
                             "launches": dict(counts)}
        log(f"  {len(routed)} routed lookups: latency "
            f"{', '.join(f'{v[1] * 1e3:.1f} ms' for v in routed.values())}; "
            f"no decode launch ({dict(counts)})")

        # -- one stream: its deltas concatenate to its final answer
        counts.clear()
        with _Capture(rt.qa) as cap:
            status, hdrs, raw = http.raw("POST", "/ask/stream", json.dumps(
                {"question": generative[APP_ASKS + 1]}).encode())
        launches.update(counts)
        if status != 200 or not hdrs.get("Content-Type", "").startswith("text/event-stream"):
            raise AssertionError(f"/ask/stream answered {status} {hdrs}")
        events = _parse_sse(raw.decode())
        for name, payload in events:
            bad = contract_violations(payload, contract["POST /ask/stream"]["events"][name])
            if bad:
                raise AssertionError(f"/ask/stream event {name}: {bad}")
        pending = cap.pending[0]
        final = rt.generator.tokenizer.decode_ids(pending.handle.result(timeout=60))
        streamed = "".join(p["delta"] for n, p in events if n == "data")
        if events[-1][0] != "done" or streamed != final or not streamed:
            raise AssertionError("the stream's deltas do not make its final answer")
        if events[-1][1]["sources"] != pending.sources:
            raise AssertionError("the stream's done event lost the sources")
        summary["stream"] = {"events": len(events), "chars": len(streamed)}

        # -- delete a cited document: no later answer names it
        question = lookups[0]["question"]
        gone = lookup_doc[question]
        out = http.json("DELETE /documents/{doc_id}", f"/documents/{gone}")
        if out["chunks_removed"] < 1:
            raise AssertionError(f"DELETE removed nothing: {out}")
        after = http.json("POST /ask/", "/ask/", payload={"question": question})
        again = http.json("POST /ask/", "/ask/", payload={"question": generative[0]})
        if any(gone in s for o in (after, again) for s in o["sources"]):
            raise AssertionError("a deleted document is still cited")
        summary["deleted_chunks"] = out["chunks_removed"]

        # -- observability surfaces
        status, hdrs, raw = http.raw("GET", "/metrics")
        problems = lint_prometheus_text(raw.decode())
        if status != 200 or problems:
            raise AssertionError(f"/metrics: {status} {problems[:3]}")
        http.json("GET /api/costs", "/api/costs")
        traces = http.json("GET /api/traces", "/api/traces?limit=20")
        if not traces:
            raise AssertionError("no trace recorded")
        http.json("GET /api/retrieval", "/api/retrieval")
        status_now = http.json("GET /api/status", "/api/status")
        # batch work after the /ask rounds: deferred (503) while they burn
        # the default /ask SLO; reported
        status, _h, raw = http.raw("POST", "/api/llm/summarize", json.dumps(
            {"prompt": "Résume : " + rows[0]["text"], "max_tokens": 4}).encode())
        contract_check(contract, "POST /api/llm/summarize", status, json.loads(raw))
        summary["after_asks"] = {
            "summarize_status": status,
            "slo_firing": [x["name"] for x in status_now["slo"] if x.get("firing")],
        }
        log(f"  after the /ask rounds: SLOs firing {summary['after_asks']['slo_firing']}, "
            f"a summary answers {status}")

        # -- what the HTTP front costs: the same routed /ask in process and
        # over HTTP, in turns
        q = lookups[1]["question"]
        body = json.dumps({"question": q}).encode()
        inproc, over = [], []
        for _ in range(APP_FRONT_PAIRS):
            t = time.perf_counter()
            if server.app.handle(Request("POST", "/ask/", body=body)).status != 200:
                raise AssertionError("in-process /ask failed")
            inproc.append(time.perf_counter() - t)
            t = time.perf_counter()
            http.json("POST /ask/", "/ask/", body=body)
            over.append(time.perf_counter() - t)
        summary["front"] = {
            "in_process_ms_p50": statistics.median(inproc) * 1e3,
            "http_ms_p50": statistics.median(over) * 1e3,
            "http_minus_in_process_ms": (statistics.median(over) - statistics.median(inproc)) * 1e3,
            "pairs": APP_FRONT_PAIRS,
        }
        log(f"  HTTP front: routed /ask p50 {summary['front']['http_ms_p50']:.2f} ms over HTTP "
            f"vs {summary['front']['in_process_ms_p50']:.2f} ms in process "
            f"({APP_FRONT_PAIRS} pairs)")
        summary["peak_device_gib"] = peak_allocated() / 2**30
    finally:
        if not server.close(timeout=30):
            raise AssertionError("the app server's threads did not end")
        rt.stop()
    log(f"  peak device memory {summary['peak_device_gib']:.2f} GiB; launches {dict(launches)}")
    return {"summary": summary, "launches": launches}


def decoded_tie_check(gen, prompt_ids, card_tokens, cpu_tokens):
    """Two greedy answers to one prompt, the card's and the CPU's, may part
    only on a tie: at the first token where they differ, the CPU engine
    ``gen`` fed the prompt and the shared prefix must score the card's
    token within ``FIRST_STEP_RTOL`` of its logits' RMS below its best.
    Returns None for equal answers, else (position, gap / RMS)."""
    if list(card_tokens) == list(cpu_tokens):
        return None
    j = next((i for i, (a, b) in enumerate(zip(card_tokens, cpu_tokens)) if a != b),
             min(len(card_tokens), len(cpu_tokens)))
    if j >= min(len(card_tokens), len(cpu_tokens)):
        raise AssertionError(f"one answer is a prefix of the other ({j} shared tokens)")
    logits = solo_first_step(gen, list(prompt_ids) + list(card_tokens[:j]))
    gap = float(logits.max() - logits[card_tokens[j]])
    rel = gap / float(logits.pow(2).mean().sqrt())
    if not rel <= FIRST_STEP_RTOL:
        raise AssertionError(
            f"card and CPU answers part at token {j} without a tie: the card's "
            f"token is {rel:.3e} of the logits' RMS below the best (tolerance "
            f"{FIRST_STEP_RTOL})")
    return j, rel


def run_app_reference_check(devices=("cuda", "cpu")):
    """A tiny runtime (float32 encoder and tagger, a bf16 decoder behind a
    1-replica pool: the pool's paged decode takes bf16 only on the card)
    answers the same requests over HTTP on the card (K1's SIMT path in the
    encoder and the tagger, its paged decode in the pool) and on the CPU
    (plain).  Retrieval, routed answers, sources and snippets must be
    equal; each decoded answer's prompt must be equal and its tokens equal
    but for a tie (:func:`decoded_tie_check`)."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.engines.router import AnswerRouter
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    tiny = {
        "encoder.vocab_size": 512, "encoder.hidden_dim": 64, "encoder.num_layers": 2,
        "encoder.num_heads": 2, "encoder.mlp_dim": 128, "encoder.max_seq_len": 128,
        "encoder.embed_dim": 64, "encoder.dtype": "float32", "store.dim": 64,
        "store.dtype": "float32",
        # K1 takes head dims 32, 64 and 128: 64 / 2, 32 / 1 and 32
        "ner.hidden_dim": 32, "ner.num_layers": 1, "ner.num_heads": 1, "ner.mlp_dim": 64,
        # a seeded random tagger (plumbing mode): this runtime is held card
        # against CPU, it models no deployment
        "ner.dtype": "float32", "ner.train_steps": 0,
        "decoder.hidden_dim": 64, "decoder.num_layers": 1, "decoder.num_heads": 2,
        "decoder.num_kv_heads": 1, "decoder.head_dim": 32, "decoder.mlp_dim": 64,
        "decoder.vocab_size": 256, "decoder.max_seq_len": 512, "decoder.dtype": "bfloat16",
        "generate.max_new_tokens": 32, "generate.max_concurrent": 4,
        "generate.prefill_buckets": (64, 128, 256, 512),
        # a slow host must not degrade an answer, nor a canary share a step
        "resilience.request_deadline_s": 0.0, "pool.canary_interval_s": 3600.0,
    }
    lookups, generative = routing_lookups(AnswerRouter())
    notes = clinical_notes(np.random.default_rng(3))[:6]
    questions = [r["question"] for r in lookups] + list(QUESTIONS) + generative[:2]
    runs = {}
    for device in devices:
        rt = DocQARuntime(load_config(env={}, overrides=tiny), device=device).start()
        server = AppServer(make_app(rt)).start()
        http = _Http(server.port, load_contract())
        _kernels.LAUNCHES.clear()
        try:
            ids = []
            for i, (name, text) in enumerate(notes + [(f"l{i}.txt", r["doc"])
                                                      for i, r in enumerate(lookups)]):
                up = http.json("POST /ingest/", "/ingest/?wait=1", payload={
                    "filename": name, "text": text, "patient_id": f"P{i % 2}"})
                if up["status"] != reg.INDEXED:
                    raise AssertionError(f"tiny app upload on {device} ended {up}")
                ids.append(up["doc_id"])
            with _Capture(rt.qa) as cap:
                got = [http.json("POST /ask/", "/ask/", payload={"question": q})
                       for q in questions]
            decoded = []
            for q, body, p in zip(questions, got, cap.pending):
                if p.handle is None:
                    continue
                if body.get("degraded"):
                    raise AssertionError(f"tiny app on {device} degraded {q!r}: {body}")
                decoded.append((list(p.handle._req.prompt_ids), list(p.handle._req.tokens)))
                body["answer"] = "<decoded>"
            got.append(http.json("GET /api/search/patient-snippets",
                                 "/api/search/patient-snippets?patient_id=P1&focus=tension"))
            text = json.dumps(got)
            for i, d in enumerate(ids):
                text = text.replace(d, f"DOC{i}")
            runs[device] = (text, decoded, dict(_kernels.LAUNCHES), rt.generator)
        finally:
            server.close(timeout=30)
            rt.stop()
    (card, card_dec, card_launches, _g), (cpu, cpu_dec, _l, cpu_gen) = (
        runs[d] for d in devices)
    if card != cpu:
        raise AssertionError("the tiny app retrieves, routes or cites differently on the "
                             "card and the CPU")
    if not card_dec or len(card_dec) != len(cpu_dec):
        raise AssertionError(f"decoded answers: {len(card_dec)} on the card, "
                             f"{len(cpu_dec)} on the CPU")
    ties = []
    for (c_prompt, c_toks), (p_prompt, p_toks) in zip(card_dec, cpu_dec):
        if c_prompt != p_prompt:
            raise AssertionError("a decoded /ask got another prompt on the card")
        tie = decoded_tie_check(cpu_gen, p_prompt, c_toks, p_toks)
        if tie is not None:
            ties.append(tie)
    for path in ("simt", "decode_paged"):
        if devices[0] == "cuda" and not card_launches.get(f"flash_attention.{path}"):
            raise AssertionError(f"the tiny card runtime launched no K1 {path} kernel: "
                                 f"{card_launches}")
    n_routed = card.count('"route": "extractive"')
    log(f"  tiny app: {len(questions)} /ask ({n_routed} routed, {len(card_dec)} decoded "
        f"through the pool) and a focused snippet search; retrieval, routes, sources and "
        f"snippets identical on card and CPU; decoded answers equal in "
        f"{len(card_dec) - len(ties)} of {len(card_dec)}, parted on a tie in {len(ties)} "
        f"(position, gap / RMS: {ties}; tolerance {FIRST_STEP_RTOL}); card K1 launches "
        f"{card_launches}")
    return {"identical_but_decoding": True, "routed": n_routed, "decoded": len(card_dec),
            "decoded_equal": len(card_dec) - len(ties), "ties": ties,
            "card_launches": card_launches}


def run_app_module_check(tagger, boot_timeout=300.0):
    """``python -m docqa_tpu_torch.service.app`` as a user starts it on the
    card (Mistral-7B width, weights drawn on the device, the tagger cache
    of phase 11 (a) as ``ner.params_path``, everything else the default
    config, a free port): it must serve
    /health, /api/status, an upload, an /ask and /api/pool, then stop on
    SIGTERM with exit code 0.  The /ask runs under the default 8 s budget;
    whether it came back degraded is reported."""
    import signal

    cmd = [sys.executable, "-m", "docqa_tpu_torch.service.app",
           "--decoder", "mistral-7b",
           "--set", f"ner.params_path={tagger}", "--host", "127.0.0.1", "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines, found = [], threading.Event()

    def drain():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if "serving on" in line:
                found.set()

    reader = threading.Thread(target=drain, name="app-module-stderr", daemon=True)
    reader.start()
    out = {}
    try:
        while not found.wait(1.0):
            if proc.poll() is not None or time.perf_counter() - t0 > boot_timeout:
                raise AssertionError(
                    f"the app module did not start (rc {proc.poll()}): {lines[-20:]}")
        port = int(next(x for x in lines if "serving on" in x).rsplit(":", 1)[1])
        out["boot_s"] = time.perf_counter() - t0
        http = _Http(port, load_contract())
        if http.json("GET /health", "/health") != {"status": "ok"}:
            raise AssertionError("the module's /health is not ok")
        http.json("GET /api/status", "/api/status")
        note = clinical_notes(np.random.default_rng(5))[0][1]
        doc = http.json("POST /ingest/", "/ingest/?wait=1", payload={
            "filename": "note.txt", "text": note, "patient_id": "P001"})
        if doc["status"] != reg.INDEXED:
            raise AssertionError(f"the module's upload ended {doc}")
        t = time.perf_counter()
        ans = http.json("POST /ask/", "/ask/", payload={
            "question": "Pourquoi ce traitement a-t-il été choisi ?"})
        out["ask_s"] = time.perf_counter() - t
        out["ask_degraded"] = bool(ans.get("degraded"))
        out["ask_degrade_reason"] = ans.get("degrade_reason")
        http.json("GET /api/pool", "/api/pool")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=60)
        reader.join(timeout=10)
    if rc != 0:
        raise AssertionError(f"the app module exited {rc} on SIGTERM: {lines[-20:]}")
    out["rc"] = rc
    log(f"  python -m docqa_tpu_torch.service.app: serving after {out['boot_s']:.1f} s; "
        f"/ask in {out['ask_s']:.2f} s under the default budget "
        f"(degraded: {out['ask_degraded']}, {out['ask_degrade_reason']}); exit {rc} on SIGTERM")
    return out


# ---- phase 10: the store's lifecycle and the single-sync /ask -----------------

LIFE_WIDTH = 128  # the sidecar's width (bench.py's)
LIFE_PAIRS = 4  # 8 took phase 10 past 120 s on the card
LIFE_POOL = 512  # seeded texts for the filler rows
LIFE_RESTART_QUESTION = "Quel est le traitement du patient P002 ?"
LIFE_LOST_DOCS = 2
# a restored row is renormalized through add: within a few float32 ulps
LIFE_ROW_TOL = 1e-6


def _sidecar_rows(tokenizer, texts):
    """The sidecar rows of ``texts`` as ingest writes them; none may be cut
    (the classic prompt would hold the whole text)."""
    rows, lens = sidecar_rows(tokenizer, texts, LIFE_WIDTH)
    full = [len(tokenizer.encode(t, add_specials=False)) for t in texts]
    if max(full, default=0) > LIFE_WIDTH:
        raise AssertionError(f"a sidecar text of {max(full)} tokens exceeds {LIFE_WIDTH}")
    return rows, lens


def lifecycle_store(qa, dev):
    """Phase 3's store (its first ``STORE_ROWS`` rows) with a ``LIFE_WIDTH``
    token sidecar: the notes' own tokens, and for each filler row a text of
    a seeded pool (kept as its ``text_content``, so the classic prompt
    holds the same words the fused chain packs)."""
    tok = qa.generator.tokenizer
    vecs, meta = qa.store.vectors_snapshot()
    vecs, meta = vecs[:STORE_ROWS], meta[:STORE_ROWS]
    rng = np.random.default_rng(10)
    pool = []
    while len(pool) < LIFE_POOL:
        text = datagen.generate_example(rng, datagen.TRAIN_LEXICONS)[0]
        if len(tok.encode(text, add_specials=False)) <= LIFE_WIDTH:
            pool.append(text)
    pool_rows, pool_lens = _sidecar_rows(tok, pool)
    pick = np.arange(len(meta)) % LIFE_POOL
    rows, lens = pool_rows[pick], pool_lens[pick]
    with_text = [i for i, m in enumerate(meta) if "text_content" in m]
    note_rows, note_lens = _sidecar_rows(tok, [meta[i]["text_content"] for i in with_text])
    rows[with_text], lens[with_text] = note_rows, note_lens
    meta = [m if "text_content" in m else dict(m, text_content=pool[pick[i]])
            for i, m in enumerate(meta)]
    store = VectorStore(dataclasses.replace(qa.store.cfg, token_width=LIFE_WIDTH), device=dev)
    store.add(vecs, meta, token_rows=rows, token_lens=lens)
    return store, len(with_text)


def _sync_window(rag, windows):
    """Sync debug mode "error" from the fused chain's query encode (its
    first launch) to the generator's mark that the prefill is issued (its
    last launch; the decode loop's first exit test comes after it).
    Returns the undo."""
    enc, gen = rag.encoder, rag.generator
    real_encode, real_mark = enc.encode_ids, gen._mark_prefill

    def encode_ids(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        windows.append("open")
        return real_encode(*a, **kw)

    def mark_prefill():
        torch.cuda.set_sync_debug_mode(0)
        windows.append("closed")
        return real_mark()

    enc.encode_ids, gen._mark_prefill = encode_ids, mark_prefill

    def undo():
        torch.cuda.set_sync_debug_mode(0)
        del enc.encode_ids, gen._mark_prefill

    return undo


def _tap_first_forward():
    """Keep the logits of the generator's first decoder forward (the
    prefill) until the returned ``untap`` is called."""
    from docqa_tpu_torch.engines import generate as generate_mod

    real, taken = generate_mod.decoder_forward, []

    def tap(*a, **kw):
        logits = real(*a, **kw)
        if not taken:
            taken.append(logits[0, -1].float().clone())
        return logits

    generate_mod.decoder_forward = tap
    return taken, lambda: setattr(generate_mod, "decoder_forward", real)


def _fused_launch_check(counts, before, gen, enc_layers):
    """K1's launches of one fused ask: the query encode and the prefill on
    the wgmma path, every verify step on the split-kv path."""
    delta = {key: counts[key] - before.get(key, 0) for key in PATH_KEYS}
    steps = gen.last_stats["forwards"] - 1
    layers = gen.cfg.num_layers
    want = {"flash_attention.prefill": enc_layers + layers,
            "flash_attention.decode": steps * layers, "flash_attention.simt": 0}
    if delta != want:
        raise AssertionError(f"fused ask's launches by path {delta}, expected {want}")
    return steps


def _same_topk(a, b, tol=1e-3):
    """Hit ids equal, but a hit tied with the k-th score (within ``tol``,
    bf16 products) is interchangeable."""
    for ra, rb in zip(a, b):
        kth = rb[-1].score
        strict = lambda hits: [h.row_id for h in hits if h.score > kth + tol]
        if len(ra) != len(rb) or strict(ra) != strict(rb):
            return False
    return True


def run_lifecycle_fused(counts, qa):
    """Phase 10 (a): fused and classic /ask alone over phase 3's store with
    a sidecar.  Returns (summary, launches, the store)."""
    from docqa_tpu_torch.engines.rag_fused import FusedRAG

    dev, gen = qa.generator.device, qa.generator
    enc = qa.retriever.encoder
    t0 = time.perf_counter()
    store, n_notes = lifecycle_store(qa, dev)
    build_s = time.perf_counter() - t0
    log(f"  store with a {LIFE_WIDTH}-token sidecar: {store.count} rows ({n_notes} notes' "
        f"own tokens, the rest from a seeded pool of {LIFE_POOL} texts), built in "
        f"{build_s:.1f} s")
    rag = FusedRAG(enc, store, gen, QA_TEMPLATE, k=3, device=dev)
    qa_fused = QAService(enc, store, gen, k=3, device=dev, fused_rag=rag)
    qa_classic = QAService(enc, store, gen, k=3, device=dev)
    usable = gen.cfg.max_seq_len - gen.gen.max_new_tokens
    enc_layers = enc.cfg.num_layers
    # the check itself must catch a sync: a control
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device=dev).item()
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not caught:
        raise AssertionError("sync debug mode let .item() through: the check sees nothing")

    launches = collections.Counter()
    checks = []
    for q in QUESTIONS:
        before = dict(counts)
        windows = []
        undo = _sync_window(rag, windows)
        taken, untap = _tap_first_forward()
        try:
            ans = rag.ask_submit(q)
        finally:
            untap()
            undo()
        steps = _fused_launch_check(counts, before, gen, enc_layers)
        out = ans.resolve()
        launches.update({k: counts[k] - before.get(k, 0) for k in counts})
        if windows != ["open", "closed"]:
            raise AssertionError(f"the sync window did not bracket the chain: {windows}")
        fused_ids = ans.prompt_tokens()
        hits = [h.row_id for h in ans.hits()]
        classic_hits = [h.row_id for h in qa_classic.retriever.search_texts([q], k=3)[0]]
        _prompt, classic_ids = first_step_prompt(qa_classic, q, usable)
        if fused_ids != classic_ids:
            raise AssertionError(f"fused prompt ids differ from the classic prompt's for {q!r}")
        if hits != classic_hits:
            raise AssertionError(f"fused hits {hits} differ from classic {classic_hits}")
        token = int(ans._out_dev[0, 0])
        rec = check_first_step("fused path", solo_first_step(gen, classic_ids), taken[0],
                               token, len(classic_ids))
        checks.append({"question": q, "prompt_tokens": len(fused_ids), "hits": hits,
                       "fused_bucket": int(ans._prompt_dev.shape[1]),
                       "classic_bucket": pick_bucket(len(classic_ids), gen.gen.prefill_buckets),
                       "verify_steps": steps, "sources": out["sources"], **rec})
    log(f"  {len(QUESTIONS)} fused asks: 0 synchronising calls from the query encode to the "
        f"prefill (sync debug mode 'error'; a control .item() raised), prompt ids and hits "
        f"equal the classic path's (prefill buckets {checks[0]['fused_bucket']} fused, "
        f"{checks[0]['classic_bucket']} classic), K1 prefill = {enc_layers} + "
        f"{gen.cfg.num_layers} and decode = {gen.cfg.num_layers} x verify steps each")

    served = []
    real_ask = rag.ask
    rag.ask = lambda q, max_new_tokens=None: served.append(q) or real_ask(q, max_new_tokens)
    fused_lat, classic_lat = [], []
    try:
        for i in range(LIFE_PAIRS):
            q = QUESTIONS[i % len(QUESTIONS)]
            before = dict(counts)
            t = time.perf_counter()
            out_f = qa_fused.ask(q)
            fused_lat.append(time.perf_counter() - t)
            _fused_launch_check(counts, before, gen, enc_layers)
            t = time.perf_counter()
            out_c = qa_classic.ask(q)
            classic_lat.append(time.perf_counter() - t)
            launches.update({k: counts[k] - before.get(k, 0) for k in counts})
            _no_degraded("phase 10 /ask", [out_f, out_c])
            if out_f["sources"] != out_c["sources"]:
                raise AssertionError(f"fused and classic sources differ for {q!r}")
    finally:
        del rag.ask
    if len(served) != LIFE_PAIRS or qa_fused.fused_rag is not rag:
        raise AssertionError(f"the fused path served {len(served)} of {LIFE_PAIRS} asks")
    summary = {
        "store_build_s": build_s, "rows": store.count, "token_width": LIFE_WIDTH,
        "checks": checks, "pairs": LIFE_PAIRS,
        "fused_p50_s": statistics.median(fused_lat),
        "classic_p50_s": statistics.median(classic_lat),
        "fused_s": fused_lat, "classic_s": classic_lat,
        "syncs_in_window": 0,
    }
    log(f"  {LIFE_PAIRS} alternating pairs alone, {gen.gen.max_new_tokens} new tokens: fused "
        f"p50 {summary['fused_p50_s']:.3f} s, classic p50 {summary['classic_p50_s']:.3f} s")
    return summary, launches, store


def run_lifecycle_snapshot(qa, store):
    """Phase 10 (b): a snapshot of the 1M-row store with its sidecar,
    restored into a fresh store, through the native codec."""
    from docqa_tpu_torch.runtime import native

    dev = qa.generator.device
    tmp = tempfile.mkdtemp(prefix="docqa_phase10_")
    index = os.path.join(tmp, "index")
    try:
        runs0 = dict(native.RUNS)
        t = time.perf_counter()
        base = store.snapshot(index)
        write_s = time.perf_counter() - t
        nbytes = {name: os.path.getsize(os.path.join(base, name)) for name in os.listdir(base)}
        t = time.perf_counter()
        restored = VectorStore.restore(index, store.cfg, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        for op in ("write", "read"):
            if native.RUNS[(op, "native")] != runs0.get((op, "native"), 0) + 1:
                raise AssertionError(f"the snapshot's {op} did not run the native codec: "
                                     f"{dict(native.RUNS)}")
        n = store.count
        if (restored.count, restored.version) != (n, store.version):
            raise AssertionError(f"restored {restored.count} rows v{restored.version}, "
                                 f"expected {n} v{store.version}")
        shard = native.read_vectors(os.path.join(base, "vectors.dns"))
        if not np.array_equal(shard, store._host[:n]):
            raise AssertionError("the snapshot's vectors differ from the store's host rows")
        row_err = float(np.abs(restored._host[:n] - store._host[:n]).max())
        if row_err > LIFE_ROW_TOL:
            raise AssertionError(f"restored rows differ by {row_err:.3e}")
        for a, b in zip(store.token_sidecar(), restored.token_sidecar()):
            if not torch.equal(a[:n], b[:n]):
                raise AssertionError("the restored sidecar differs")
        if restored.metadata_rows() != store.metadata_rows():
            raise AssertionError("the restored metadata differs")
        enc = qa.retriever.encoder
        before = FusedRetriever(enc, store, device=dev).search_texts(list(QUESTIONS), k=10)
        after = FusedRetriever(enc, restored, device=dev).search_texts(list(QUESTIONS), k=10)
        ids_equal = ([[h.row_id for h in r] for r in before]
                     == [[h.row_id for h in r] for r in after])
        if not ids_equal and not _same_topk(after, before):
            raise AssertionError("top-10 ids differ after the restore")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {"write_s": write_s, "restore_s": restore_s, "bytes": nbytes,
               "total_bytes": sum(nbytes.values()), "codec": "native",
               "row_max_abs_err": row_err, "topk_ids_identical": ids_equal}
    log(f"  snapshot of {n} rows + sidecar: {summary['total_bytes'] / 1e9:.3f} GB written in "
        f"{write_s:.2f} s, restored in {restore_s:.2f} s (native codec both ways; "
        f"{', '.join(f'{k} {v / 1e6:.1f} MB' for k, v in sorted(nbytes.items()))}); rows "
        f"within {row_err:.2e}, sidecar, metadata and version equal; the four questions' "
        f"top-10 ids {'identical' if ids_equal else 'equal under the tie rule'}")
    return summary


def _registry_rows(http, names):
    """The listed documents as (upload index, status, chunks)."""
    rows = http.json("GET /documents/", "/documents/")
    return sorted((names[r["doc_id"]], r["status"], r["n_chunks"]) for r in rows
                  if r["doc_id"] in names)


def run_lifecycle_restart(counts, qa, tagger):
    """Phase 10 (c): phase 9's runtime with ``data.work_dir`` and a sidecar,
    over HTTP: ingest, a fused /ask alone, stop, boot again; then a kill
    without the final snapshot, and an erasure."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    gen = qa.generator
    dev = gen.device
    contract = load_contract()
    work = tempfile.mkdtemp(prefix="docqa_phase10_work_")
    cfg = dataclasses.replace(
        load_config(env={}, overrides={
            "ner.params_path": tagger,
            "resilience.request_deadline_s": APP_DEADLINE_S,
            "data.work_dir": work,
            "data.snapshot_every": 10_000,  # no periodic snapshot: the kill loses
            "store.token_width": LIFE_WIDTH,
        }),
        decoder=gen.cfg,
    )
    launches = collections.Counter()
    summary = {}

    def boot():
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rt = DocQARuntime(cfg, device=dev, decoder_params=gen.params).start()
        server = AppServer(make_app(rt)).start()
        return rt, server, _Http(server.port, contract), time.perf_counter() - t

    def close(rt, server):
        if not server.close(timeout=30):
            raise AssertionError("the app server's threads did not end")
        rt._warmup_thread.join(timeout=600)  # a warm-up cut by the stop only logs
        rt.stop()

    def fused_ask(rt, http):
        """The runtime's ``QAService.ask`` alone (the fused chain: the
        /ask route, as the reference's, submits to the pool), then the same
        question over HTTP; both cite the same sources."""
        rt._warmup_thread.join(timeout=600)  # the pool idle
        served = []
        real = rt.qa.fused_rag.ask
        rt.qa.fused_rag.ask = lambda q, max_new_tokens=None: served.append(q) or real(q)
        before = dict(counts)
        try:
            t = time.perf_counter()
            out = rt.qa.ask(LIFE_RESTART_QUESTION)
            ask_s = time.perf_counter() - t
        finally:
            del rt.qa.fused_rag.ask
        _fused_launch_check(counts, before, rt.generator, rt.encoder.cfg.num_layers)
        if served != [LIFE_RESTART_QUESTION] or out.get("degraded"):
            raise AssertionError(f"the /ask did not take the fused path: {out}")
        t = time.perf_counter()
        over_http = http.json("POST /ask/", "/ask/", payload={"question": LIFE_RESTART_QUESTION})
        http_s = time.perf_counter() - t
        launches.update({k: counts[k] - before.get(k, 0) for k in counts})
        if over_http.get("degraded") or over_http["sources"] != out["sources"]:
            raise AssertionError(f"the /ask route cites {over_http}, the fused ask {out}")
        return out, ask_s, http_s

    def state(rt, http, names):
        return {"count": rt.store.count, "version": rt.store.version,
                "registry": _registry_rows(http, names)}

    try:
        rt, server, http, boot_s = boot()
        try:
            names = {}
            for i, d in enumerate(app_notes(np.random.default_rng(21))):
                body, ctype = _multipart(d["filename"], d["data"], d["fields"])
                names[http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"]] = i
            _wait_indexed(http, list(names))
            out1, ask1_s, http1_s = fused_ask(rt, http)
            state1 = state(rt, http, names)
        finally:
            close(rt, server)
        rt, server, http, reboot_s = boot()
        try:
            state2 = state(rt, http, names)
            out2, ask2_s, http2_s = fused_ask(rt, http)
            if state2 != state1 or out2["sources"] != out1["sources"]:
                raise AssertionError(f"the restart changed the state: {state1} -> {state2}, "
                                     f"sources {out1['sources']} -> {out2['sources']}")
            lost = {}
            for i, d in enumerate(app_notes(np.random.default_rng(22))[:LIFE_LOST_DOCS]):
                body, ctype = _multipart(d["filename"], d["data"], d["fields"])
                lost[http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"]] = i
            _wait_indexed(http, list(lost))
            if not server.close(timeout=30):
                raise AssertionError("the app server's threads did not end")
            # a kill: every worker ends, the final snapshot never runs
            if rt.sampler is not None:
                rt.sampler.stop()
            rt.pipeline.stop()
            rt.batcher.stop()
            rt._warmup_thread.join(timeout=60)
            rt.broker.close()
            rt.registry.close()
        except BaseException:
            close(rt, server)
            raise
        rt, server, http, kill_boot_s = boot()
        try:
            statuses = [http.json("GET /documents/{doc_id}", f"/documents/{d}")["status"]
                        for d in lost]
            if statuses != [reg.ERROR_INDEXING] * LIFE_LOST_DOCS or rt.store.count != state1["count"]:
                raise AssertionError(f"after the kill: {statuses}, {rt.store.count} rows")
            # a plain DELETE keeps one predecessor snapshot; an erasure none
            index = os.path.join(work, "index")
            kept = []
            for doc_id, erase in zip(names, ("0", "1")):
                out = http.json("DELETE /documents/{doc_id}",
                                f"/documents/{doc_id}?erase={erase}")
                kept.append(sorted(d for d in os.listdir(index) if d.startswith("index_v")))
                if out["erased"] != (erase == "1") or not out["chunks_removed"]:
                    raise AssertionError(f"DELETE answered {out}")
            if [len(k) for k in kept] != [2, 1]:
                raise AssertionError(f"snapshots after a delete, then an erasure: {kept}")
        finally:
            close(rt, server)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {
        "uploads": len(names), "rows": state1["count"], "version": state1["version"],
        "boot_s": boot_s, "reboot_s": reboot_s, "boot_after_kill_s": kill_boot_s,
        "ask_s": [ask1_s, ask2_s], "http_ask_s": [http1_s, http2_s],
        "new_tokens": cfg.generate.max_new_tokens, "sources_equal": True,
        "answers_equal": out1["answer"] == out2["answer"],
        "lost_docs": LIFE_LOST_DOCS, "lost_status": reg.ERROR_INDEXING,
        "snapshots_after_delete_then_erase": [len(k) for k in kept],
    }
    log(f"  kill and restart over HTTP: {len(names)} uploads, {state1['count']} rows v"
        f"{state1['version']}; fused QAService.ask {ask1_s:.2f} s, after the restart "
        f"{ask2_s:.2f} s (the /ask route through the pool: {http1_s:.2f} / {http2_s:.2f} s, "
        f"the same sources; {cfg.generate.max_new_tokens} new tokens) "
        f"with the same count, version, registry rows and sources (answers "
        f"{'equal' if summary['answers_equal'] else 'differ'}); boots {boot_s:.1f} / "
        f"{reboot_s:.1f} / {kill_boot_s:.1f} s; {LIFE_LOST_DOCS} documents indexed after the "
        f"last snapshot read {reg.ERROR_INDEXING} after a kill; a DELETE left 2 snapshots, "
        f"an erasure 1")
    return summary, launches


def run_lifecycle_path(counts, qa, tagger):
    """Phase 10: (a) fused against classic /ask, (b) a 1M-row snapshot and
    restore, (c) kill and restart through HTTP.  Returns the summary and
    the main path's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    counts.clear()
    fused, launches, store = run_lifecycle_fused(counts, qa)
    persist = run_lifecycle_snapshot(qa, store)
    del store
    restart, restart_launches = run_lifecycle_restart(counts, qa, tagger)
    launches.update(restart_launches)
    return {"summary": {"fused": fused, "snapshot": persist, "restart": restart},
            "launches": launches}


# ---- phase 12: tiered retrieval at full width ---------------------------------

# the clustered filler rows: seeded centres, per-dimension noise scaled from
# the reference tests' 0.35 at d=32 to keep its angle to the centre at d=384
TIER_CENTERS = 4096
TIER_NOISE = 0.35 * (32 / 384) ** 0.5
TIER_QUERIES = 256
TIER_QUERY_NOISE = 0.02  # a query row's noise a dimension (~21 degrees off)
TIER_NPROBES = (2, 4, 8, 16, 32)
TIER_K = 10
TIER_PAIRS = 6  # alternating tiered / exact latency pairs a batch size
TIER_FRESH = 1000  # rows appended to the tail, each must find itself first
TIER_REBUILD_TAIL = 2000  # rebuild_tail_rows lowered so (c) rebuilds (a cut)
TIER_PACE_S = 0.05  # one question every 50 ms while the rebuild runs
LEX_ROWS = 1_000_000  # the lexical scoring's synthetic tiles
# the re-ranked tiered scores are float32 host cosines, the exact store's
# float32 sums of bf16 rows: a row within this of the exact k-th score is a
# tie, not a miss (bf16 rounds each component to 2^-9 relative)
TIER_TIE_TOL = 1e-2


def tiered_store(qa, dev):
    """Phase 12's 1,000,000 x 384 bf16 store: phase 3's 20 encoded notes,
    then clustered filler rows (module constants above).  Returns (store,
    each row's centre id (-1 for a note), the seeded generator)."""
    notes = qa.store.metadata_rows()[:N_NOTES]
    store = VectorStore(StoreConfig(), device=dev)
    store.add(qa.store.host_rows(np.arange(N_NOTES)), notes)
    rng = np.random.default_rng(12)
    d = store.cfg.dim
    centres = rng.standard_normal((TIER_CENTERS, d), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    n_fill = STORE_ROWS - N_NOTES
    which = rng.integers(0, TIER_CENTERS, n_fill)
    for start in range(0, n_fill, 1 << 18):
        idx = which[start : start + (1 << 18)]
        rows = centres[idx] + TIER_NOISE * rng.standard_normal((len(idx), d), dtype=np.float32)
        store.add(rows, [{"source": f"cluster-{start + i:07d}"} for i in range(len(idx))])
    return store, np.concatenate([np.full(N_NOTES, -1), which]), rng


def _ranked(rows):
    return [[(r.row_id, r.score) for r in row] for row in rows]


def _recall(served, exact, k):
    hits = expected = 0
    for s, e in zip(served, exact):
        h, n = compare_topk(s, e, k)
        hits, expected = hits + h, expected + n
    lo, hi = wilson_interval(hits, expected)
    return {"recall": hits / max(expected, 1), "hits": hits, "expected": expected,
            "ci_lo": lo, "ci_hi": hi}


def _same_sources(served, exact, tol=TIER_TIE_TOL):
    """Every served row is in the exact top list or scores within ``tol``
    of its last row (the tie rule)."""
    ids = {r.row_id for r in exact}
    last = exact[-1].score
    return len(served) == len(exact) and all(
        r.row_id in ids or r.score >= last - tol for r in served)


def _retrieve_device_ms():
    return get_spine().telemetry_counters().get("dispatch_device_ms_retrieve", 0.0)


def _timed_search(retr, texts):
    """One ``search_texts``: host ms around it, and the device ms its
    ``retrieve`` item took (CUDA events, the spine's series)."""
    d0 = _retrieve_device_ms()
    t0 = time.perf_counter()
    out = retr.search_texts(texts, k=TIER_K)
    host_ms = (time.perf_counter() - t0) * 1e3
    return out, host_ms, _retrieve_device_ms() - d0


def _latency_pairs(tiered_retr, exact_retr, texts):
    """Alternating tiered / exact ``search_texts`` pairs after one warm-up
    each: medians and spreads of host and device ms."""
    for retr in (tiered_retr, exact_retr):
        retr.search_texts(texts, k=TIER_K)
    rows = {"tiered": [], "exact": []}
    for _ in range(TIER_PAIRS):
        for name, retr in (("tiered", tiered_retr), ("exact", exact_retr)):
            _out, host_ms, dev_ms = _timed_search(retr, texts)
            rows[name].append((host_ms, dev_ms))
    out = {}
    for name, samples in rows.items():
        host = [h for h, _ in samples]
        devt = [d for _, d in samples]
        out[name] = {"host_ms_p50": statistics.median(host), "host_ms_min": min(host),
                     "host_ms_max": max(host), "device_ms_p50": statistics.median(devt),
                     "device_ms_min": min(devt), "device_ms_max": max(devt)}
    return out


def time_plain_probe(ivf, queries, nprobe, flush):
    """The plain IVF probe (``index/ivf._probe_kernel``) alone at ``len(
    queries)`` queries, with the bound of its bytes: each query's probed
    tiles, scales and ids plus the centroids and spill, read once."""
    from docqa_tpu_torch.index.ivf import _probe_kernel

    q = torch.from_numpy(queries).to(ivf.device, ivf._dtype)
    fetch = TIER_K * (ivf.n_assign + 1)

    def probe():
        return _probe_kernel(ivf._cells, ivf._cell_scale, ivf._cell_ids, ivf._centroids,
                             ivf._spill, ivf._spill_ids, q, nprobe=nprobe, k=fetch,
                             n_real_cells=ivf.n_real_cells)

    with torch.inference_mode():
        # the spin outlasts the host's ~100 launches of the plain probe
        ms = time_ms(probe, flush, reps=10, warmup=2, spin_cycles=40_000_000)
    d = ivf.dim
    per_query = nprobe * ivf.cap * (d * ivf._cells.element_size() + 4 + 4)
    fixed = (ivf._centroids.numel() * ivf._centroids.element_size()
             + ivf._spill.numel() * ivf._spill.element_size() + ivf._spill_ids.numel() * 4)
    nbytes = len(queries) * per_query + fixed
    flops = 2.0 * len(queries) * (nprobe * ivf.cap + ivf.n_clusters) * d
    bound_ms = max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS) * 1e3
    return {"queries": len(queries), "nprobe": nprobe, "plain_ms": ms,
            "bytes": nbytes, "bytes_per_query": per_query, "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / PEAK_BYTES_S >= flops / PEAK_BF16_FLOPS
            else "operations", "library_ms": None}


def time_plain_lexical(dev, flush, n_queries=1, terms=8):
    """The plain lexical scoring (``index/lexical.score_lexical``) plus its
    top-k over ``LEX_ROWS`` synthetic rows of 32-slot impact tiles, with the
    bound of its bytes: the tiles, liveness and queries read once, the
    scores written once."""
    from docqa_tpu_torch.index.lexical import score_lexical

    gen = torch.Generator(device=dev).manual_seed(31)
    width, vocab = 32, 1 << 17
    term_ids = torch.randint(0, vocab, (LEX_ROWS, width), generator=gen, device=dev,
                             dtype=torch.int32)
    impacts = torch.randint(1, 128, (LEX_ROWS, width), generator=gen, device=dev,
                            dtype=torch.int8)
    live = torch.ones(LEX_ROWS, dtype=torch.bool, device=dev)
    q_terms = term_ids[:n_queries, :terms].clone()
    q_weights = torch.rand((n_queries, terms), generator=gen, device=dev)

    def score():
        return torch.topk(score_lexical(term_ids, impacts, live, q_terms, q_weights),
                          TIER_K, dim=-1)

    with torch.inference_mode():
        ms = time_ms(score, flush, reps=5, warmup=1, spin_cycles=40_000_000)
    nbytes = LEX_ROWS * (width * 5 + 1) + n_queries * LEX_ROWS * 4
    flops = 2.0 * n_queries * terms * LEX_ROWS * width
    return {"rows": LEX_ROWS, "queries": n_queries, "terms": terms, "plain_ms": ms,
            "bytes": nbytes, "bound_ms": max(nbytes / PEAK_BYTES_S,
                                             flops / PEAK_BF16_FLOPS) * 1e3,
            "bound_by": "bytes", "library_ms": None}


def run_tiered_recall(qa, store, tiered, centre_of, rng, flush):
    """(b): recall@10 against exact at each nprobe, beside the share of
    queries whose own row comes first and the share of the exact top-10's
    other rows from the query row's own centre; tiered against exact
    retrieval latency; the plain probe and lexical scoring alone."""
    from docqa_tpu_torch.engines.retrieve import FusedRetriever, FusedTieredRetriever

    enc = qa.retriever.encoder
    dev = store.device
    pick = rng.choice(np.arange(N_NOTES, store.count), TIER_QUERIES, replace=False)
    q = store.host_rows(pick) + TIER_QUERY_NOISE * rng.standard_normal(
        (TIER_QUERIES, store.cfg.dim), dtype=np.float32)
    exact_rows = _ranked(store.search(q, k=TIER_K))
    others = [[rid for rid, _s in row if rid != src] for row, src in zip(exact_rows, pick)]
    same_centre = sum(int((centre_of[r] == centre_of[src]).sum())
                      for r, src in zip(others, pick)) / max(sum(len(r) for r in others), 1)
    tiered_retr = FusedTieredRetriever(enc, tiered, device=dev)
    exact_retr = FusedRetriever(enc, store, device=dev)
    exact_q = _ranked(exact_retr.search_texts(list(QUESTIONS), k=TIER_K))
    sweep = {}
    for nprobe in TIER_NPROBES:
        tiered.set_nprobe(nprobe)
        t0 = time.perf_counter()
        rows = _ranked(tiered.search(q, k=TIER_K))
        wall = time.perf_counter() - t0
        rec = _recall(rows, exact_rows, TIER_K)
        rec["questions"] = _recall(
            _ranked(tiered_retr.search_texts(list(QUESTIONS), k=TIER_K)), exact_q, TIER_K)
        rec["batch_wall_s"] = wall
        rec["own_row_first"] = float(np.mean([bool(r) and r[0][0] == src
                                              for r, src in zip(rows, pick)]))
        sweep[nprobe] = rec
        log(f"  nprobe {nprobe:2d}: recall@{TIER_K} {rec['recall']:.4f} "
            f"[{rec['ci_lo']:.4f}, {rec['ci_hi']:.4f}] over {TIER_QUERIES} perturbed rows "
            f"({rec['hits']}/{rec['expected']}), own row first {rec['own_row_first']:.3f}, "
            f"the 4 questions {rec['questions']['recall']:.3f}; "
            f"{TIER_QUERIES} queries in {wall:.2f} s (two-step, one probe item)")
    tiered.set_nprobe(8)
    log(f"  the exact top-{TIER_K}'s rows past the query's own: {same_centre:.3f} from its "
        f"own centre (the rest are the corpus' extreme-value draws)")
    latency = {}
    for batch in (1, 16):
        texts = (list(QUESTIONS) * 4)[:batch]
        latency[batch] = _latency_pairs(tiered_retr, exact_retr, texts)
        t, e = latency[batch]["tiered"], latency[batch]["exact"]
        log(f"  retrieval latency, batch {batch}, {TIER_PAIRS} alternating pairs, p50 "
            f"[min, max]: tiered host {t['host_ms_p50']:.2f} [{t['host_ms_min']:.2f}, "
            f"{t['host_ms_max']:.2f}] ms, device {t['device_ms_p50']:.3f} ms; exact host "
            f"{e['host_ms_p50']:.2f} [{e['host_ms_min']:.2f}, {e['host_ms_max']:.2f}] ms, "
            f"device {e['device_ms_p50']:.3f} ms")
    ivf = tiered._tier[0]
    probe = time_plain_probe(ivf, q[:16] / np.linalg.norm(q[:16], axis=1, keepdims=True),
                             8, flush)
    log(f"  plain IVF probe (_probe_kernel), q 16, nprobe 8: {probe['plain_ms']:.4f} ms, "
        f"bound {probe['bound_ms']:.4f} ms ({probe['bound_by']}: "
        f"{probe['bytes_per_query'] / 1e6:.2f} MB a query at 3.35 TB/s), "
        f"{probe['bound_ms'] / probe['plain_ms']:.1%} of the bound")
    lexical = time_plain_lexical(dev, flush)
    log(f"  plain lexical scoring (score_lexical + top-k), {LEX_ROWS} rows x 32 slots, "
        f"1 query x 8 terms: {lexical['plain_ms']:.3f} ms, bound {lexical['bound_ms']:.4f} ms "
        f"({lexical['bound_ms'] / lexical['plain_ms']:.2%} of it)")
    return {"sweep": sweep, "latency": latency, "probe": probe, "lexical": lexical,
            "exact_same_centre_share": same_centre}


def run_tiered_tail(qa, store, tiered, rng, latency_b1):
    """(c): fresh rows find themselves first in the exact tail; then a tail
    past the lowered ``rebuild_tail_rows`` starts the background rebuild,
    while the four questions keep being served."""
    from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever

    covered = tiered.covered
    fresh = rng.standard_normal((TIER_FRESH, store.cfg.dim), dtype=np.float32)
    store.add(fresh, [{"source": f"fresh-{i:04d}"} for i in range(TIER_FRESH)])
    got = tiered.search(fresh, k=1)
    missed = [i for i, row in enumerate(got) if not row or row[0].row_id != covered + i]
    if missed:
        raise AssertionError(f"{len(missed)} of {TIER_FRESH} fresh rows not first for "
                             f"their own vector: {missed[:5]}")
    log(f"  {TIER_FRESH} fresh rows in the exact tail: each first for its own vector "
        f"(recall 1.0 on fresh rows)")
    tiered.rebuild_tail_rows = TIER_REBUILD_TAIL
    more = rng.standard_normal((TIER_REBUILD_TAIL, store.cfg.dim), dtype=np.float32)
    store.add(more, [{"source": f"tail-{i:04d}"} for i in range(TIER_REBUILD_TAIL)])
    retr = FusedTieredRetriever(qa.retriever.encoder, tiered, device=store.device)
    t0 = time.perf_counter()
    during = []
    retr.search_texts([QUESTIONS[0]], k=TIER_K)  # starts the rebuild
    if not tiered.rebuilding and tiered.covered == covered:
        raise AssertionError("a tail past rebuild_tail_rows started no rebuild")
    i = 0
    while tiered.rebuilding:
        _out, host_ms, dev_ms = _timed_search(retr, [QUESTIONS[i % len(QUESTIONS)]])
        if tiered.rebuilding:
            during.append((host_ms, dev_ms))
        i += 1
        time.sleep(TIER_PACE_S)
    rebuild_s = time.perf_counter() - t0
    tiered.close()
    if tiered.covered != store.count:
        raise AssertionError(f"the rebuilt tier covers {tiered.covered} of {store.count}")
    ivf = tiered._tier[0]
    host = [h for h, _ in during]
    rec = {"fresh_rows": TIER_FRESH, "rebuild_s": rebuild_s, "served_during": len(during),
           "host_ms_p50": statistics.median(host) if host else None,
           "host_ms_max": max(host) if host else None,
           "device_ms_p50": statistics.median(d for _, d in during) if during else None,
           "before_host_ms_p50": latency_b1["tiered"]["host_ms_p50"],
           "covered": tiered.covered, "build_seconds": ivf.build_seconds}
    if not during:
        raise AssertionError("no retrieval was served while the tier rebuilt")
    log(f"  background rebuild over {store.count} rows: {rebuild_s:.1f} s; "
        f"{len(during)} single-question retrievals served meanwhile, host p50 "
        f"{rec['host_ms_p50']:.2f} ms (max {rec['host_ms_max']:.2f}) against "
        f"{rec['before_host_ms_p50']:.2f} ms in (b); the tier swapped to {tiered.covered} rows")
    return rec


def run_tiered_ask(counts, qa, store, tiered):
    """(d): ``QAService`` over the tiered index (its fused tiered retriever)
    and a 1-replica pool at Mistral-7B width: the four questions, none
    degraded, sources equal to the exact path's under the tie rule, K1's
    launch identity, and the observatory's shadows (every retrieval
    sampled) drained into an (ivf, 8) estimate, frontier rows and the
    recall SLO's counters."""
    from docqa_tpu_torch.engines.retrieve import FusedRetriever

    gen = qa.generator
    dev = gen.device
    enc = qa.retriever.encoder
    res_cfg = ResilienceConfig()
    robs = obs.RetrievalObservatory(sample_every=1, frontier_every=1, min_frontier_n=1,
                                    registry=DEFAULT_REGISTRY).start()
    prev = obs.set_retrieval_observatory(robs)
    pool1 = EnginePool(gen, cfg=PoolConfig(replicas=1, n_slots=16), qos=QoSConfig(),
                       chunk=16, cache_len=1024, device=dev)
    try:
        qa_t = QAService(enc, tiered, gen, k=3, device=dev, batcher=pool1,
                         breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                               res_cfg.breaker_reset_s),
                         resilience=res_cfg)
        if type(qa_t.retriever).__name__ != "FusedTieredRetriever":
            raise AssertionError(f"the tiered service retrieves through {qa_t.retriever}")
        exact = FusedRetriever(enc, store, device=dev)
        expected0 = DEFAULT_REGISTRY.counter("retrieve_shadow_expected").value
        stats0 = pool1.stats()
        counts.clear()
        t0 = time.perf_counter()
        results = _resolve_all(_submit_round(qa_t, list(QUESTIONS)))
        wall = time.perf_counter() - t0
        launches, steps = _quiescent(counts, pool1.stats)
        steps = steps - stats0
        _no_degraded("phase 12 /ask", [r[1] for r in results])
        for q, out, _lat in results:
            served = qa_t.retriever.search_texts([q], k=3)[0]
            want = exact.search_texts([q], k=3)[0]
            if not _same_sources(served, want):
                raise AssertionError(f"tiered sources for {q!r} differ from exact: "
                                     f"{_ranked([served])} vs {_ranked([want])}")
            if out["sources"] != [h.metadata.get("source", "") for h in served]:
                raise AssertionError(f"/ask sources {out['sources']} are not its hits")
        dec_layers, enc_layers = gen.cfg.num_layers, enc.cfg.num_layers
        want = {
            "flash_attention.decode_paged": dec_layers * (
                steps["verify_steps"] + steps["decode_steps"] + steps["warmup_steps"]),
            "flash_attention.prefill": enc_layers * len(QUESTIONS),
            "flash_attention.decode": 0,
            "flash_attention.simt": 0,
        }
        got = {key: launches.get(key, 0) for key in want}
        if got != want or steps["verify_steps"] < 1:
            raise AssertionError(f"tiered /ask launches {got}, expected {want}")
        if not robs.drain(120):
            raise AssertionError("the observatory did not drain its shadows")
        st = robs.status()
        key = "tiered_fused@nprobe=8"
        if key not in st["estimates"] or not st["frontier"] or st["counts"]["errors"]:
            raise AssertionError(f"observatory status lacks {key} or frontier rows: {st}")
        stamped = DEFAULT_REGISTRY.counter("retrieve_shadow_expected").value - expected0
        if stamped <= 0:
            raise AssertionError("the recall SLO's counters were not stamped")
        rec = _round_record(results, wall)
        # every counter of the round, K1's total with its paths
        rec.update(launches=launches, verify_steps=steps["verify_steps"],
                   estimate=st["estimates"][key], frontier=st["frontier"],
                   shadow_expected=stamped, sources=[r[1]["sources"] for r in results])
        log(f"  tiered /ask through a 1-replica pool: 4 asks p50 {rec['latency_p50_s']:.3f} s, "
            f"{rec['tokens_per_s']:.1f} answer tok/s, none degraded, sources equal to exact "
            f"(tie rule); K1 {got} = 6 prefill an encode, 32 x {steps['verify_steps']} verify "
            f"(+ {steps['decode_steps'] + steps['warmup_steps']} other) steps")
        log(f"  observatory: {key} {st['estimates'][key]}, frontier "
            + ", ".join(f"{r['nprobe']}: {r['recall']} ({r['probe_ms_p50']} ms)"
                        for r in st["frontier"])
            + f"; {stamped} expected comparisons stamped for the recall SLO")
        return rec
    finally:
        pool1.stop()
        obs.set_retrieval_observatory(prev)
        robs.stop()


def run_tiered_app(counts, qa, tagger):
    """(e): phase 9's runtime under ``store.serving_index="tiered"``
    (``ivf_min_rows`` lowered so its small corpus gets a tier, 64 new
    tokens: cuts), over HTTP: one /ask with the tier's default mode dense,
    then one with it hybrid (``lexical.serving_mode``, set live on the
    tier), and ``/api/retrieval`` answering the running observatory's
    payload."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    gc.collect()
    torch.cuda.empty_cache()
    dev = qa.generator.device
    contract = load_contract()
    cfg = dataclasses.replace(
        load_config(env={}, overrides={
            "ner.params_path": tagger,
            "resilience.request_deadline_s": APP_DEADLINE_S,
            "store.serving_index": "tiered", "store.ivf_min_rows": 32,
            "generate.max_new_tokens": 64,
        }),
        decoder=qa.generator.cfg,
    )
    rt = DocQARuntime(cfg, device=dev, decoder_params=qa.generator.params).start()
    server = AppServer(make_app(rt)).start()
    http = _Http(server.port, contract)
    launches = collections.Counter()
    try:
        docs = app_notes(np.random.default_rng(21))
        ids = []
        for d in docs:
            body, ctype = _multipart(d["filename"], d["data"], d["fields"])
            ids.append(http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"])
        _wait_indexed(http, ids)
        asks = {}
        deadline = time.perf_counter() + 120
        for mode in ("dense", "hybrid"):
            rt.search_index.default_mode = mode
            counts.clear()
            t0 = time.perf_counter()
            out = http.json("POST /ask/", "/ask/", payload={"question": QUESTIONS[1]})
            asks[mode] = {"latency_s": time.perf_counter() - t0, "sources": out["sources"],
                          "degraded": bool(out.get("degraded"))}
            launches.update(counts)
            if out.get("degraded") or not out["answer"].strip():
                raise AssertionError(f"tiered app /ask ({mode}) degraded: {out}")
            while rt.search_index.covered == 0 and time.perf_counter() < deadline:
                time.sleep(0.05)  # the first ask started the tier's build
        if rt.search_index.covered != rt.store.count:
            raise AssertionError(f"the app's tier covers {rt.search_index.covered} of "
                                 f"{rt.store.count} rows")
        counts.clear()
        out = http.json("POST /ask/", "/ask/", payload={"question": QUESTIONS[2]})
        launches.update(counts)
        if out.get("degraded"):
            raise AssertionError(f"tiered app /ask over the tier degraded: {out}")
        rt.retrieval_obs.drain(60)
        payload = http.json("GET /api/retrieval", "/api/retrieval")
        if not payload["running"] or not payload["serving"]["index"]["active"]:
            raise AssertionError(f"/api/retrieval is not the running tier's: {payload}")
        # the first ask, served exact before the tier, is not counted
        if payload["counts"]["served"] < 2 or payload["serving"]["serving_index"] != "tiered":
            raise AssertionError(f"/api/retrieval counted {payload['counts']}")
        rec = {"asks": asks, "rows": rt.store.count, "launches": dict(launches),
               "retrieval": {k: payload[k] for k in ("counts", "estimates", "serving")},
               "doc_ids": ids}
        log(f"  tiered app over HTTP: {rt.store.count} rows, tier over "
            f"{payload['serving']['covered']}; /ask dense {asks['dense']['latency_s']:.2f} s, "
            f"hybrid {asks['hybrid']['latency_s']:.2f} s, not degraded; /api/retrieval counts "
            f"{payload['counts']}, estimates {sorted(payload['estimates'])}")
        return rec
    finally:
        server.close(timeout=10)
        rt.stop()


def run_tiered_reference_check(devices=("cuda", "cpu")):
    """(f): a tiered store of a few thousand float32 rows (a tiny encoder's
    note embeddings plus noise) on the card and on the CPU.  The CPU's tier
    is carried to the card (``ivf_from_arrays``), then dense and hybrid
    fused searches give the same top-k ids but for a tie at the k-th score.
    Whether the card's own k-means gave the CPU's cells is reported."""
    from docqa_tpu_torch.engines.retrieve import FusedTieredRetriever
    from docqa_tpu_torch.index.ivf import ivf_from_arrays
    from docqa_tpu_torch.index.lexical import LexicalIndex
    from docqa_tpu_torch.index.tiered import TieredIndex

    enc_cfg = EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=2,
                            mlp_dim=128, max_seq_len=64, embed_dim=64, dtype="float32")
    texts = [f"note {i}: drug-{i % 13} for condition-{i % 7} ward {i % 11}"
             for i in range(3000)]
    stacks = {}
    for dev in devices:
        enc = EncoderEngine(enc_cfg, seed=1, device=dev)
        emb = enc.encode_texts(texts)
        emb = emb + 0.05 * np.random.default_rng(0).standard_normal(emb.shape).astype(np.float32)
        store = VectorStore(StoreConfig(dim=64, dtype="float32", shard_capacity=4096), device=dev)
        lex = LexicalIndex(vocab_size=4096, tile_width=8, device=dev)
        store.register_index_sink(lex)
        store.add(emb, [{"doc_id": f"d{i}", "text_content": t} for i, t in enumerate(texts)])
        tier = TieredIndex(store, nprobe=4, min_rows=1000, lexical=lex)
        if not tier.rebuild():
            raise AssertionError("the tiny tier did not build")
        stacks[dev] = (tier, FusedTieredRetriever(enc, tier, device=dev))
    card, cpu = (stacks[d] for d in devices)
    same_cells = bool(np.array_equal(card[0]._tier[0]._cell_ids.cpu().numpy(),
                                     cpu[0]._tier[0]._cell_ids.cpu().numpy()))
    ivf, covered = cpu[0]._tier
    carried = ivf_from_arrays(ivf.arrays(), ivf._meta, nprobe=ivf.nprobe, dtype="float32",
                              device=card[0].device)
    carried._store_compactions = card[0].store.compactions
    card[0]._tier = (carried, covered)
    qs = ["drug-3 for condition-3", "ward 7 drug-12", "note 42", "condition-5"]
    for mode in ("dense", "hybrid"):
        for got, want in zip(card[1].search_texts(qs, k=8, mode=mode),
                             cpu[1].search_texts(qs, k=8, mode=mode)):
            gs = np.array([h.score for h in got])
            ws = np.array([h.score for h in want])
            cut = ws[-1] + 2e-5
            if (len(got) != len(want) or np.abs(gs - ws).max() > 1e-5
                    or {h.row_id for h in got if h.score > cut}
                    != {h.row_id for h in want if h.score > cut}):
                raise AssertionError(f"tiny tier, {mode}: card {_ranked([got])} vs CPU "
                                     f"{_ranked([want])}")
    log(f"  tiny float32 tier: dense and hybrid top-8 equal on card and CPU over the CPU's "
        f"carried tier; the card's own k-means gave the CPU's cells: {same_cells}")
    return {"rows": len(texts), "same_cells_from_own_kmeans": same_cells}


def run_tiered_path(counts, qa, tagger):
    """Phase 12: tiered retrieval at full width (the module docstring)."""
    from docqa_tpu_torch.index.tiered import TieredIndex

    dev = qa.generator.device
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    store, centre_of, rng = tiered_store(qa, dev)
    store_s = time.perf_counter() - t0
    tiered = TieredIndex(store)
    t0 = time.perf_counter()
    if not tiered.rebuild():
        raise AssertionError("the 1M-row store built no IVF tier")
    build_s = time.perf_counter() - t0
    ivf = tiered._tier[0]
    summary = {"store_s": store_s, "build_s": build_s, "build_seconds": ivf.build_seconds,
               "index_bytes": ivf.index_bytes(), "n_spilled": ivf.n_spilled, "cap": ivf.cap,
               "n_clusters": ivf.n_clusters}
    split = ", ".join(f"{k} {v:.2f} s" for k, v in ivf.build_seconds.items())
    log(f"  store: {store.count} rows (20 notes + clustered fillers, {TIER_CENTERS} centres, "
        f"noise {TIER_NOISE:.4f}) in {store_s:.1f} s; tier: C={ivf.n_clusters} cap={ivf.cap} "
        f"n_assign={ivf.n_assign} spilled {ivf.n_spilled}, {ivf.index_bytes()}; "
        f"rebuild() {build_s:.1f} s wall ({split})")
    summary["recall"] = run_tiered_recall(qa, store, tiered, centre_of, rng, flush)
    summary["tail"] = run_tiered_tail(qa, store, tiered, rng,
                                      summary["recall"]["latency"][1])
    launches = collections.Counter()
    summary["ask"] = run_tiered_ask(counts, qa, store, tiered)
    launches.update(summary["ask"]["launches"])
    # phase 17 (b) shards this tier: its host arrays outlive the store
    tier_arrays = ivf.arrays()
    del tiered, store, ivf
    gc.collect()
    torch.cuda.empty_cache()
    summary["app"] = run_tiered_app(counts, qa, tagger)
    launches.update(summary["app"]["launches"])
    summary["reference"] = run_tiered_reference_check()
    return {"summary": summary, "launches": dict(launches), "tier_arrays": tier_arrays}


# ---- phase 13: checkpoints and the seq2seq summarizer -------------------------------

S2S_NOTES = 8  # (a): one batch of generated notes, 32 beam lanes under the shipped policy
S2S_NEW = 142  # (a): bart-large-cnn's max_length
S2S_MIN_CHARS = (600, 1000, 1400, 1800, 2200, 2600, 3000, 3400)  # source lengths ~300-1024
S2S_MERGES = 300  # merges the phase's BPE vocabularies learn from the notes
S2S_TINY_NEW = 12  # (b)
CKPT_LAYERS = 2  # (d): the Mistral layout at 2 of 32 layers (full depth: 14.5 GB of shards)
CKPT_ASK_TOKENS = 64  # (d)
CKPT_UPLOADS = 4  # (e)
CKPT_PATIENT = "P001"
STEP_SPIN_CYCLES = 80_000_000  # ~40 ms of spin ahead of a timed BART forward


def _bpe_merges(words, n_merges):
    """Learn ``n_merges`` BPE merges from {tuple(symbols): count}: each
    round merges the most frequent adjacent pair (ties: the smallest
    pair), everywhere it occurs."""
    words = dict(words)
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for sym, n in words.items():
            for a, b in zip(sym, sym[1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = {}
        for sym, n in words.items():
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and (sym[i], sym[i + 1]) == best:
                    out.append(sym[i] + sym[i + 1])
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged
    return merges


def _filler_pieces():
    """Distinct non-empty pieces of printable ASCII (each its own byte-level
    character): two letters or digits, then three."""
    alphabet = string.ascii_letters + string.digits
    for n in (2, 3):
        for chars in itertools.product(alphabet, repeat=n):
            yield "".join(chars)


def byte_level_tokenizer_json(texts, path, n_merges=S2S_MERGES, vocab_size=None):
    """A BART-style byte-level BPE ``tokenizer.json`` built in code: the
    specials ``<s> <pad> </s> <unk>`` at 0-3, the 256-byte alphabet, then
    merges counted from ``texts``; with ``vocab_size``, distinct filler
    pieces after them up to that many ids, so that every non-special id a
    model of that vocabulary emits decodes to text.  No merge produces a
    filler, so the notes encode as without them."""
    from docqa_tpu_torch.text import bpe

    words = collections.Counter()
    for text in texts:
        for pre in bpe.gpt2_pre_tokenize(text):
            words[tuple(bpe._BYTE_TO_CHAR[b] for b in pre.encode("utf-8"))] += 1
    merges = _bpe_merges(words, n_merges)
    vocab = {t: i for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])}
    for b in range(256):
        vocab.setdefault(bpe._BYTE_TO_CHAR[b], len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    if vocab_size is not None:
        fillers = _filler_pieces()
        while len(vocab) < vocab_size:
            vocab.setdefault(next(fillers), len(vocab))
    blob = {
        "added_tokens": [{"id": i, "content": t, "special": True}
                         for i, t in enumerate(["<s>", "<pad>", "</s>", "<unk>"])],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
        "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2], "cls": ["<s>", 0]},
        "decoder": {"type": "ByteLevel"},
        "model": {"type": "BPE", "vocab": vocab, "unk_token": "<unk>",
                  "merges": [f"{a} {b}" for a, b in merges]},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(blob, f, ensure_ascii=False)
    return path


def metaspace_tokenizer_json(texts, path, n_merges=S2S_MERGES):
    """A Mistral-style metaspace BPE ``tokenizer.json`` built in code:
    ``<unk> <s> </s>`` at 0-2, the 256 ``<0xNN>`` byte-fallback pieces,
    the notes' characters, then merges counted from them."""
    words = collections.Counter()
    for text in texts:
        marked = "▁" + text.replace(" ", "▁")
        for seg in re.split(r"(?=▁)", marked):
            if seg:
                words[tuple(seg)] += 1
    merges = _bpe_merges(words, n_merges)
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in sorted({c for w in words for c in w}):
        vocab.setdefault(ch, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    blob = {
        "added_tokens": [{"id": i, "content": t, "special": True}
                         for i, t in enumerate(specials)],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None,
        "post_processor": {"type": "TemplateProcessing", "single": [
            {"SpecialToken": {"id": "<s>", "type_id": 0}},
            {"Sequence": {"id": "A", "type_id": 0}}]},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]},
        "model": {"type": "BPE", "vocab": vocab, "unk_token": "<unk>",
                  "byte_fallback": True, "merges": [f"{a} {b}" for a, b in merges]},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(blob, f, ensure_ascii=False)
    return path


def wordpiece_vocab(texts, path):
    """A BERT ``vocab.txt`` built in code: the five specials, every word
    of ``texts`` (lowercased, the encoder's pre-tokenizer), then each
    character bare and as a ``##`` continuation."""
    from docqa_tpu_torch.text.tokenizer import _SPECIALS, _WORD_RE

    words = sorted({w for t in texts for w in _WORD_RE.findall(t.lower())})
    chars = sorted({c for w in words for c in w})
    vocab = list(_SPECIALS) + words
    seen = set(vocab)
    vocab += [c for c in chars if c not in seen] + ["##" + c for c in chars]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return path


# safetensors dtype codes by dtype name (torch's and numpy's names agree)
ST_CODES = {"float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
            "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8",
            "uint8": "U8", "bool": "BOOL"}


def save_safetensors(tensors, path, metadata=None):
    """Write CPU tensors or numpy arrays as one safetensors file, in name
    order: the 8-byte little-endian header length, the JSON header padded
    with spaces to a multiple of 8 bytes, then the raw bytes.  The card's
    machine has no ``safetensors`` package; the port reads these files with
    ``models/safetensors_io.py``."""
    header = {"__metadata__": dict(metadata)} if metadata else {}
    raws, pos = [], 0
    for name in sorted(tensors):
        t = tensors[name]
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            code = ST_CODES[str(t.dtype).removeprefix("torch.")]
            raw = t.reshape(-1).view(torch.uint8).numpy() if t.numel() else np.zeros(0, np.uint8)
        else:
            t = np.ascontiguousarray(t)
            code = ST_CODES[t.dtype.name]
            raw = t.reshape(-1).view(np.uint8)
        header[name] = {"dtype": code, "shape": list(t.shape),
                        "data_offsets": [pos, pos + raw.nbytes]}
        raws.append(raw)
        pos += raw.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in raws:
            f.write(raw.data)


def _write_config(path, hf):
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf, f, indent=1)


def bart_hf_tensors(tree, cfg):
    """A seq2seq tree (the reference's names, [in, out]) under
    ``BartForConditionalGeneration``'s names, Linear weights [out, in]."""
    def t(name):
        return np.ascontiguousarray(np.asarray(tree[name]).T)

    raw = {
        "model.shared.weight": tree["shared_emb"],
        "model.encoder.embed_positions.weight": tree["enc_pos"],
        "model.decoder.embed_positions.weight": tree["dec_pos"],
        "model.encoder.layernorm_embedding.weight": tree["enc_ln_emb_g"],
        "model.encoder.layernorm_embedding.bias": tree["enc_ln_emb_b"],
        "model.decoder.layernorm_embedding.weight": tree["dec_ln_emb_g"],
        "model.decoder.layernorm_embedding.bias": tree["dec_ln_emb_b"],
        "final_logits_bias": np.asarray(tree["final_logits_bias"]).reshape(1, -1),
    }
    proj = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "out_proj"}
    for side, hf_side, n in (("e", "encoder", cfg.enc_layers), ("d", "decoder", cfg.dec_layers)):
        for i in range(n):
            pre = f"model.{hf_side}.layers.{i}."
            attns = [("", "self_attn", "ln")] + ([("x", "encoder_attn", "xln")] if side == "d" else [])
            for mark, attn, ln in attns:
                for ours, theirs in proj.items():
                    raw[pre + f"{attn}.{theirs}.weight"] = t(f"{side}{i}_{mark}{ours}w")
                    raw[pre + f"{attn}.{theirs}.bias"] = tree[f"{side}{i}_{mark}{ours}b"]
                raw[pre + f"{attn}_layer_norm.weight"] = tree[f"{side}{i}_{ln}_g"]
                raw[pre + f"{attn}_layer_norm.bias"] = tree[f"{side}{i}_{ln}_b"]
            for fc in ("fc1", "fc2"):
                raw[pre + f"{fc}.weight"] = t(f"{side}{i}_{fc}_w")
                raw[pre + f"{fc}.bias"] = tree[f"{side}{i}_{fc}_b"]
            raw[pre + "final_layer_norm.weight"] = tree[f"{side}{i}_lnf_g"]
            raw[pre + "final_layer_norm.bias"] = tree[f"{side}{i}_lnf_b"]
    return raw


def write_bart_dir(path, cfg, tree, texts):
    """A bart-large-cnn-layout directory: config.json with ``cfg``'s
    hyper-parameters and the shipped generation policy, the tree as
    ``model.safetensors`` (float32, as the published file) and a byte-level
    BPE ``tokenizer.json`` whose pieces cover every id below
    ``cfg.vocab_size`` (the specials at the ids ``config.json`` names)."""
    os.makedirs(path, exist_ok=True)
    _write_config(path, {
        "model_type": "bart", "architectures": ["BartForConditionalGeneration"],
        "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
        "encoder_layers": cfg.enc_layers, "decoder_layers": cfg.dec_layers,
        "encoder_attention_heads": cfg.num_heads, "decoder_attention_heads": cfg.num_heads,
        "encoder_ffn_dim": cfg.mlp_dim, "decoder_ffn_dim": cfg.mlp_dim,
        "max_position_embeddings": cfg.max_src_len, "activation_function": "gelu",
        "scale_embedding": False, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
        "decoder_start_token_id": 2, "forced_bos_token_id": 0, "forced_eos_token_id": 2,
        "num_beams": 4, "length_penalty": 2.0, "min_length": 56, "max_length": 142,
        "no_repeat_ngram_size": 3, "early_stopping": True,
    })
    save_safetensors(bart_hf_tensors(tree, cfg), os.path.join(path, "model.safetensors"))
    byte_level_tokenizer_json(texts, os.path.join(path, "tokenizer.json"),
                              vocab_size=cfg.vocab_size)
    return path


def write_bert_dir(path, cfg, tree, texts):
    """A MiniLM directory under ``BertModel``'s names (no ``bert.``
    prefix), float32, with a WordPiece ``vocab.txt``."""
    os.makedirs(path, exist_ok=True)
    _write_config(path, {
        "model_type": "bert", "architectures": ["BertModel"], "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_dim, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.mlp_dim,
        "max_position_embeddings": cfg.max_seq_len, "type_vocab_size": 2,
        "hidden_act": "gelu", "layer_norm_eps": 1e-12,
    })
    names = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "o": "attention.output.dense",
             "up": "intermediate.dense", "down": "output.dense"}
    raw = {
        "embeddings.word_embeddings.weight": tree["tok_emb"],
        "embeddings.position_embeddings.weight": tree["pos_emb"],
        "embeddings.token_type_embeddings.weight": tree["type_emb"],
        "embeddings.LayerNorm.weight": tree["emb_ln_g"],
        "embeddings.LayerNorm.bias": tree["emb_ln_b"],
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        for ours, theirs in names.items():
            raw[pre + theirs + ".weight"] = np.ascontiguousarray(tree[f"l{i}_{ours}_w"].T)
            raw[pre + theirs + ".bias"] = tree[f"l{i}_{ours}_b"]
        raw[pre + "attention.output.LayerNorm.weight"] = tree[f"l{i}_attn_ln_g"]
        raw[pre + "attention.output.LayerNorm.bias"] = tree[f"l{i}_attn_ln_b"]
        raw[pre + "output.LayerNorm.weight"] = tree[f"l{i}_mlp_ln_g"]
        raw[pre + "output.LayerNorm.bias"] = tree[f"l{i}_mlp_ln_b"]
    save_safetensors(raw, os.path.join(path, "model.safetensors"))
    wordpiece_vocab(texts, os.path.join(path, "vocab.txt"))
    return path


def write_mistral_dir(path, cfg, tree, texts):
    """A Mistral-layout directory: config.json, two bf16 shards
    ``model-0000{1,2}-of-00002.safetensors`` (layer 0 and the embedding in
    the first; the rest, the final norm and ``lm_head.weight`` in the
    second) and a metaspace BPE ``tokenizer.json``."""
    os.makedirs(path, exist_ok=True)
    _write_config(path, {
        "model_type": "mistral", "architectures": ["MistralForCausalLM"],
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_dim,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.mlp_dim, "max_position_embeddings": 32768,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "sliding_window": cfg.sliding_window, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    })

    def t(name):
        return tree[name].T.contiguous().cpu()

    shards = [{"model.embed_tokens.weight": tree["tok_emb"].cpu()}, {}]
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        shards[min(i, 1)].update({
            pre + "input_layernorm.weight": tree[f"l{i}_attn_norm_g"].cpu(),
            pre + "self_attn.q_proj.weight": t(f"l{i}_wq"),
            pre + "self_attn.k_proj.weight": t(f"l{i}_wk"),
            pre + "self_attn.v_proj.weight": t(f"l{i}_wv"),
            pre + "self_attn.o_proj.weight": t(f"l{i}_wo"),
            pre + "post_attention_layernorm.weight": tree[f"l{i}_mlp_norm_g"].cpu(),
            pre + "mlp.gate_proj.weight": t(f"l{i}_w_gate"),
            pre + "mlp.up_proj.weight": t(f"l{i}_w_up"),
            pre + "mlp.down_proj.weight": t(f"l{i}_w_down"),
        })
    shards[1]["model.norm.weight"] = tree["final_norm_g"].cpu()
    shards[1]["lm_head.weight"] = t("lm_head")
    for k, shard in enumerate(shards):
        save_safetensors(
            shard, os.path.join(path, f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"))
    metaspace_tokenizer_json(texts, os.path.join(path, "tokenizer.json"))
    return path


def summary_notes(rng):
    """``S2S_NOTES`` notes of phase 7's generator (the training lexicons),
    note i taking sentences until ``S2S_MIN_CHARS[i]`` characters."""
    notes = []
    for n_chars in S2S_MIN_CHARS[:S2S_NOTES]:
        lines = []
        while len(" ".join(lines)) < n_chars:
            text, _spans = datagen.generate_example(rng, datagen.TRAIN_LEXICONS)
            lines.append(text.replace("(", " ").replace(")", " "))
        notes.append(" ".join(lines))
    return notes


def _launch_check(where, delta, encodes, decoder_forwards, enc_layers, dec_layers):
    """K1 launches of a summary: the encoder's self-attention on
    ``prefill`` once a layer an encode, the decoder's self- and
    cross-attention on ``decode`` twice a layer a decoder forward."""
    want = {"flash_attention": encodes * enc_layers + 2 * dec_layers * decoder_forwards,
            "flash_attention.prefill": encodes * enc_layers,
            "flash_attention.decode": 2 * dec_layers * decoder_forwards,
            "flash_attention.simt": 0, "flash_attention.decode_paged": 0}
    got = {k: delta.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{where}: K1 launches {got}, expected {want}")


def _timed_summary(eng, counts, src, max_new):
    """One ``generate_ids`` batch, synchronised: (outputs, wall s, launch
    delta, stats)."""
    torch.cuda.synchronize()
    before = collections.Counter(counts)
    t0 = time.perf_counter()
    outs = eng.generate_ids(src, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = collections.Counter(counts)
    delta.subtract(before)
    return outs, wall, dict(delta), dict(eng.last_stats)


def run_checkpoint_bart(counts, workdir, flush):
    """(a): bart-large-cnn at full width and depth, written as an HF
    directory from the port's seeded host init, imported, then 8 notes
    summarised at once under the shipped policy and 1 greedy."""
    from docqa_tpu_torch import weights
    from docqa_tpu_torch.config import Seq2SeqConfig
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine
    from docqa_tpu_torch.models import seq2seq as s2s
    from docqa_tpu_torch.models.hf_checkpoint import load_checkpoint_dir

    dev = torch.device("cuda")
    base = Seq2SeqConfig.bart_large_cnn()
    notes = summary_notes(np.random.default_rng(13))
    t0 = time.perf_counter()
    tree = weights.host_init_seq2seq_params(base, seed=13)
    init_s = time.perf_counter() - t0
    path = os.path.join(workdir, "bart-large-cnn")
    t0 = time.perf_counter()
    write_bart_dir(path, base, tree, notes)
    write_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(os.path.join(path, "model.safetensors"))
    n_params = sum(a.size for a in tree.values())

    t0 = time.perf_counter()
    cfg, params, tok_path = load_checkpoint_dir(path, expect=Seq2SeqConfig)
    read_s = time.perf_counter() - t0
    want_policy = dict(num_beams=4, length_penalty=2.0, min_length=56, no_repeat_ngram=3,
                       forced_bos_id=0)
    got_policy = {k: getattr(cfg, k) for k in want_policy}
    shape = ("vocab_size", "d_model", "enc_layers", "dec_layers", "num_heads", "mlp_dim",
             "max_src_len", "max_tgt_len")
    if got_policy != want_policy or any(getattr(cfg, k) != getattr(base, k) for k in shape):
        raise AssertionError(f"imported BART config {cfg}")
    reset_peak()
    t0 = time.perf_counter()
    eng = Seq2SeqEngine(cfg, params=params, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del params
    mismatched = [
        name for name, arr in tree.items()
        if not torch.equal(eng.params[name],
                           torch.from_numpy(arr).to(dev, eng.params[name].dtype))
    ]
    if mismatched or not torch.equal(
            eng.params["lm_head"], torch.from_numpy(tree["shared_emb"]).to(dev, torch.bfloat16)):
        raise AssertionError(f"imported BART leaves differ from the written ones: {mismatched[:5]}")
    del tree
    src = [eng.tokenizer.encode(n) for n in notes]
    src_lengths = [min(len(s), cfg.max_src_len) for s in src]
    log(f"  BART-large-cnn: {n_params / 1e6:.1f} M params, host init {init_s:.1f} s, "
        f"{file_bytes / 1e9:.2f} GB float32 written in {write_s:.1f} s, read in {read_s:.2f} s, "
        f"uploaded (bf16 projections) in {upload_s:.1f} s; every leaf equal to the written "
        f"one in its serving dtype; sources {src_lengths} tokens")

    # 8 notes under the shipped policy: 32 beam lanes
    with peak_reading("summary"):
        summaries, wall, delta, st = _timed_summary(eng, counts, src, S2S_NEW)
    _launch_check("beam summary", delta, 1, st["steps"] + 1, cfg.enc_layers, cfg.dec_layers)
    reads_cap = math.ceil(st["steps"] / eng.check_every) + 1
    if st["flag_reads"] > reads_cap:
        raise AssertionError(f"beam summary read its flag {st['flag_reads']} times > {reads_cap}")
    if len(summaries) != S2S_NOTES or any(
            not 56 - 1 <= len(s) <= S2S_NEW or max(s) >= cfg.vocab_size for s in summaries):
        raise AssertionError(f"beam summaries {[len(s) for s in summaries]}")
    for s in summaries:  # no_repeat_ngram_size=3: no trigram twice
        grams = list(zip(s, s[1:], s[2:]))
        if len(grams) != len(set(grams)):
            raise AssertionError("a beam summary repeats a trigram")
    short, wall_short, _d, st_short = _timed_summary(eng, counts, src, 2)
    step_ms = (wall - wall_short) / max(1, st["steps"] - st_short["steps"]) * 1e3
    n_tokens = sum(len(s) for s in summaries)
    beam = {
        "lanes": S2S_NOTES * cfg.num_beams, "wall_s": wall, "steps": st["steps"],
        "flag_reads": st["flag_reads"], "ms_per_step": step_ms,
        "summary_tokens": n_tokens, "summary_tokens_per_s": n_tokens / wall,
        "summary_lengths": [len(s) for s in summaries], "source_tokens": src_lengths,
        "peak_device_gib": peak_allocated() / 2**30,
        "launches": delta,
    }
    # one decoder step alone, device time (the host's launches hidden
    # behind a spin): what a step costs the card
    b = S2S_NOTES * cfg.num_beams
    ids_h = np.full((S2S_NOTES, cfg.max_src_len), cfg.pad_id, np.int64)
    for i, s in enumerate(src):
        ids_h[i, : src_lengths[i]] = s[: cfg.max_src_len]
    ids = torch.from_numpy(ids_h).to(dev)
    lens = torch.tensor(src_lengths, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        enc_h = s2s.encode_source(eng.params, cfg, ids, lens)
        xkv = {k: v.repeat_interleave(cfg.num_beams, 0)
               for k, v in s2s.precompute_cross_kv(eng.params, cfg, enc_h).items()}
        srcl = lens.repeat_interleave(cfg.num_beams)
        cache = s2s.init_self_cache(cfg, b, S2S_NEW + 1, device=dev)
        tok = torch.full((b, 1), 5, dtype=torch.long, device=dev)
        pos = torch.full((b,), 70, dtype=torch.int32, device=dev)
        # a forward is ~800 launches: the spin (~40 ms) outlasts their
        # enqueue, so the events bracket device work only
        beam["decoder_forward_device_ms"] = time_ms(
            lambda: s2s.decoder_forward(eng.params, cfg, tok, cache, pos, xkv, srcl),
            flush, reps=10, spin_cycles=STEP_SPIN_CYCLES)
        beam["encode_device_ms"] = time_ms(
            lambda: s2s.encode_source(eng.params, cfg, ids, lens), flush, reps=5,
            spin_cycles=STEP_SPIN_CYCLES)
    del enc_h, xkv, cache
    beam["host_share_of_step"] = 1.0 - beam["decoder_forward_device_ms"] / step_ms
    log(f"  beam summary: {S2S_NOTES} notes x {cfg.num_beams} beams = {b} lanes, "
        f"{st['steps']} steps in {wall:.2f} s ({step_ms:.2f} ms a step; the decoder "
        f"forward alone {beam['decoder_forward_device_ms']:.3f} ms of device time, so "
        f"{100 * beam['host_share_of_step']:.0f} % of a step is the host), "
        f"{n_tokens} summary tokens = {beam['summary_tokens_per_s']:.0f} tok/s, "
        f"flag read {st['flag_reads']} times (cap {reads_cap}), peak "
        f"{beam['peak_device_gib']:.2f} GiB, encode {beam['encode_device_ms']:.2f} ms device")

    # 1 note greedy: num_beams=1 set by the operator over the shipped 4
    eng.cfg = dataclasses.replace(cfg, num_beams=1)
    (one,), wall1, delta1, st1 = _timed_summary(eng, counts, src[:1], S2S_NEW)
    _launch_check("greedy summary", delta1, 1, st1["steps"] + 1, cfg.enc_layers,
                  cfg.dec_layers)
    cap1 = math.ceil(st1["steps"] / eng.check_every) + 1
    if st1["flag_reads"] > cap1 or not 55 <= len(one) <= S2S_NEW:
        raise AssertionError(f"greedy summary: {len(one)} tokens, {st1['flag_reads']} reads")
    greedy = {"wall_s": wall1, "steps": st1["steps"], "flag_reads": st1["flag_reads"],
              "ms_per_step": wall1 * 1e3 / (st1["steps"] + 1), "summary_tokens": len(one),
              "summary_tokens_per_s": len(one) / wall1, "launches": delta1}
    log(f"  greedy summary (num_beams=1 by the operator): {len(one)} tokens, "
        f"{st1['steps']} steps in {wall1:.2f} s ({greedy['ms_per_step']:.2f} ms a step, "
        f"encode included), flag read {st1['flag_reads']} times (cap {cap1})")
    launches = collections.Counter(delta)
    launches.update(delta1)
    summary = {"params_m": n_params / 1e6, "file_gb": file_bytes / 1e9, "init_s": init_s,
               "write_s": write_s, "read_s": read_s, "upload_s": upload_s,
               "tokenizer": tok_path, "beam": beam, "greedy": greedy,
               "text_sample": eng.tokenizer.decode_ids(summaries[0])[:120]}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return path, summary, launches


def run_checkpoint_tiny(devices=("cuda", "cpu")):
    """(b): a float32 BART at the reference test's widths (2 heads of 32,
    K1's smallest head_dim) gives identical greedy and beam-4 tokens on the
    card's kernels and the CPU's plain versions."""
    from docqa_tpu_torch import weights
    from docqa_tpu_torch.config import Seq2SeqConfig
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine

    cfg = Seq2SeqConfig(vocab_size=256, d_model=64, enc_layers=2, dec_layers=2, num_heads=2,
                        mlp_dim=128, max_src_len=64, max_tgt_len=32, dtype="float32")
    tree = weights.host_init_seq2seq_params(cfg, seed=5)
    quiet = dict(tree, final_logits_bias=tree["final_logits_bias"].copy())
    quiet["final_logits_bias"][cfg.eos_id] = -1e9  # greedy runs its whole horizon
    rng = np.random.default_rng(6)
    src = [rng.integers(3, cfg.vocab_size, int(n)).tolist() for n in (9, 40, 23)]
    runs = {
        "greedy": (cfg, quiet),
        "beam4": (dataclasses.replace(cfg, num_beams=4, length_penalty=2.0, min_length=6,
                                      no_repeat_ngram=2), tree),
    }
    out = {}
    for name, (c, params) in runs.items():
        got = {dev: Seq2SeqEngine(c, params=params, device=dev).generate_ids(
            src, max_new_tokens=S2S_TINY_NEW) for dev in devices}
        a, b = (got[d] for d in devices)
        if a != b or not any(a):
            raise AssertionError(f"tiny BART {name}: card {a} vs CPU {b}")
        out[name] = {"lengths": [len(x) for x in a]}
    log(f"  tiny float32 BART: greedy {out['greedy']['lengths']} and beam-4 "
        f"{out['beam4']['lengths']} tokens identical on {devices[0]} and {devices[1]}")
    return {"tokens_identical": True, **out}


def run_checkpoint_minilm(counts, workdir):
    """(c): phase 3's MiniLM weights (seed 0) as a ``bert`` directory,
    imported; the 20 notes' embeddings equal phase 3's encoder's, bit for
    bit, on the same token ids."""
    from docqa_tpu_torch import weights
    from docqa_tpu_torch.engines.encoder import marshal_texts
    from docqa_tpu_torch.models.hf_checkpoint import load_checkpoint_dir

    dev = torch.device("cuda")
    base = EncoderConfig()
    texts = [t for _, t in clinical_notes(np.random.default_rng(7))]
    path = write_bert_dir(os.path.join(workdir, "minilm"), base,
                          weights.host_init_encoder_params(base, 0), texts)
    t0 = time.perf_counter()
    cfg, params, tok_path = load_checkpoint_dir(path, expect=EncoderConfig)
    read_s = time.perf_counter() - t0
    phase3 = EncoderEngine(base, seed=0, device=dev)
    imported = EncoderEngine(cfg, params=params, device=dev)
    ids, lengths = marshal_texts(phase3.tokenizer, base, texts)
    before = collections.Counter(counts)
    a, b = phase3.encode_ids(ids, lengths), imported.encode_ids(ids, lengths)
    delta = collections.Counter(counts)
    delta.subtract(before)
    if not torch.equal(a, b):
        raise AssertionError(
            f"imported MiniLM embeddings differ: max |err| {float((a - b).abs().max()):.3e}")
    real = imported.encode_texts(texts)  # through the checkpoint's WordPiece vocabulary
    if not np.allclose(np.linalg.norm(real, axis=1), 1.0, atol=1e-3):
        raise AssertionError("WordPiece-tokenized embeddings are not unit vectors")
    wp_tokens = [len(imported.tokenizer.encode(t)) for t in texts]
    log(f"  MiniLM-L6 (bert dir, vocab.txt of {imported.tokenizer.vocab_size} pieces) read in "
        f"{read_s:.2f} s: 20 notes' embeddings bit-equal to phase 3's encoder on the same "
        f"ids; through WordPiece {min(wp_tokens)}-{max(wp_tokens)} tokens a note")
    return path, {"read_s": read_s, "bit_equal": True, "tokenizer": tok_path,
                  "wordpiece_tokens": wp_tokens}, dict(delta)


def run_checkpoint_mistral(counts, workdir):
    """(d): a Mistral-7B-layout decoder at full width and 2 of 32 layers
    in two bf16 shards, imported; first-step logits bit-equal to an engine
    built from the same tree carried in directly; a 64-token greedy answer
    through the checkpoint's vocabulary."""
    from docqa_tpu_torch.models.hf_checkpoint import load_checkpoint_dir

    dev = torch.device("cuda")
    base = dataclasses.replace(DecoderConfig.mistral_7b(), num_layers=CKPT_LAYERS)
    texts = [t for _, t in clinical_notes(np.random.default_rng(7))] + list(QUESTIONS)
    tree = init_decoder_params(base, seed=0, device=dev, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    path = write_mistral_dir(os.path.join(workdir, "mistral"), base, tree, texts)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)
                 if f.endswith(".safetensors"))
    t0 = time.perf_counter()
    cfg, params, tok_path = load_checkpoint_dir(path, expect=DecoderConfig)
    read_s = time.perf_counter() - t0
    if not all(torch.equal(params[k].to(dev), tree[k]) for k in tree):
        raise AssertionError("imported Mistral-layout leaves differ from the written ones")
    gen = GenerateConfig(max_new_tokens=CKPT_ASK_TOKENS)
    direct = GenerateEngine(base, gen, params=tree, device=dev)
    imported = GenerateEngine(cfg, gen, params=params, device=dev)
    del params
    prompt = imported.tokenizer.encode(QA_TEMPLATE.format(context=texts[3], question=QUESTIONS[0]))
    ids = torch.tensor([prompt], device=dev)
    logits = []
    for eng in (direct, imported):
        cache = init_kv_cache(eng.cfg, 1, max_len=round_up(len(prompt), 128),
                              dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            logits.append(decoder_forward(
                eng.params, eng.cfg, ids, cache, torch.zeros(1, dtype=torch.int32, device=dev),
                last_token_only=True))
    if not torch.equal(*logits) or not torch.isfinite(logits[0]).all():
        raise AssertionError("imported first-step logits differ from the direct engine's")
    if imported.gen.eos_id != imported.tokenizer.eos_id:
        raise AssertionError(f"eos {imported.gen.eos_id} is not the tokenizer's "
                             f"{imported.tokenizer.eos_id}")
    before = collections.Counter(counts)
    t0 = time.perf_counter()
    (answer_ids,) = imported.generate_ids([prompt], max_new_tokens=CKPT_ASK_TOKENS)
    answer_s = time.perf_counter() - t0
    delta = collections.Counter(counts)
    delta.subtract(before)
    answer = imported.tokenizer.decode_ids(answer_ids)
    if not answer_ids or max(answer_ids) >= cfg.vocab_size or not isinstance(answer, str):
        raise AssertionError(f"the imported decoder's answer {answer_ids[:8]}")
    eos_id = imported.gen.eos_id
    log(f"  Mistral layout ({CKPT_LAYERS} of 32 layers, 2 bf16 shards, {nbytes / 1e9:.2f} GB "
        f"written in {write_s:.1f} s, read in {read_s:.2f} s): first-step logits bit-equal "
        f"to the direct engine's; {len(answer_ids)}-token greedy answer in {answer_s:.2f} s "
        f"through the metaspace BPE (eos {imported.gen.eos_id}, prompt {len(prompt)} tokens)")
    del direct, imported, tree
    gc.collect()
    torch.cuda.empty_cache()
    return path, {"shard_gb": nbytes / 1e9, "write_s": write_s, "read_s": read_s,
                  "logits_bit_equal": True, "answer_tokens": len(answer_ids),
                  "answer_s": answer_s, "eos_id": eos_id, "tokenizer": tok_path}, dict(delta)


def run_checkpoint_runtime(counts, dirs, tagger):
    """(e): ``DocQARuntime`` under the default config with all three
    ``checkpoint_dir``s and ``summarizer.backend="seq2seq"``, over HTTP: 4
    uploads, one /ask, one patient synthesis whose summary is the seq2seq
    engine's (its ``seq2seq_generate`` spine item ran, no paged decode)."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.engines.seq2seq import Seq2SeqEngine
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    gc.collect()
    torch.cuda.empty_cache()
    contract = load_contract()
    cfg = load_config(env={}, overrides={
        "ner.params_path": tagger,
        "encoder.checkpoint_dir": dirs["encoder"],
        "decoder.checkpoint_dir": dirs["decoder"],
        "seq2seq.checkpoint_dir": dirs["seq2seq"],
        "summarizer.backend": "seq2seq",
        "resilience.request_deadline_s": APP_DEADLINE_S,
        # no canary decodes while the synthesis is counted
        "pool.canary_interval_s": 3600.0,
    })
    t0 = time.perf_counter()
    rt = DocQARuntime(cfg, device="cuda").start()
    server = AppServer(make_app(rt)).start()
    boot_s = time.perf_counter() - t0
    summary = {"boot_s": boot_s, "load_s": dict(rt.load_seconds)}
    log(f"  runtime with three checkpoints booted in {boot_s:.1f} s (loads "
        + ", ".join(f"{k} {v:.2f} s" for k, v in rt.load_seconds.items()) + ")")
    http = _Http(server.port, contract)
    delta = collections.Counter()
    try:
        if not isinstance(rt.summarizer.generator, Seq2SeqEngine):
            raise AssertionError("the runtime's summarizer is not the seq2seq engine")
        if rt.summarizer.cfg.max_input_tokens != 1024 or rt.summarizer.instruction_prompts:
            raise AssertionError(f"summarizer config {rt.summarizer.cfg}")
        status = http.json("GET /api/status", "/api/status")
        if "checkpoint" not in status["breakers"]:
            raise AssertionError(f"/api/status breakers {sorted(status['breakers'])}")
        docs = app_notes(np.random.default_rng(31))[:CKPT_UPLOADS]
        ids = []
        for i, d in enumerate(docs):
            fields = dict(d["fields"], patient_id=CKPT_PATIENT if i % 2 == 0 else "P002")
            body, ctype = _multipart(d["filename"], d["data"], fields)
            ids.append(http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"])
        _wait_indexed(http, ids)
        if rt._warmup_thread is not None:
            rt._warmup_thread.join(timeout=300)
        t0 = time.perf_counter()
        out = http.json("POST /ask/", "/ask/", payload={"question": QUESTIONS[0]})
        ask_s = time.perf_counter() - t0
        # random weights may decode to an empty text; degraded is the fault
        if out.get("degraded") or not isinstance(out.get("answer"), str) or not out["sources"]:
            raise AssertionError(f"checkpoint /ask: {out}")
        stages = rt.spine.stats()["stages"]
        n_s2s = stages.get("seq2seq_generate", {}).get("count", 0)
        before = collections.Counter(counts)
        t0 = time.perf_counter()
        synth = http.json("POST /api/synthese/patient", "/api/synthese/patient",
                          {"patient_id": CKPT_PATIENT})
        synth_s = time.perf_counter() - t0
        delta = collections.Counter(counts)
        delta.subtract(before)
        st = dict(rt.summarizer.generator.last_stats)
        n_s2s_after = rt.spine.stats()["stages"].get("seq2seq_generate", {}).get("count", 0)
        if n_s2s_after != n_s2s + 1 or delta.get("flash_attention.decode_paged", 0):
            raise AssertionError(
                f"the synthesis ran {n_s2s_after - n_s2s} seq2seq items and "
                f"{delta.get('flash_attention.decode_paged', 0)} paged decodes")
        s2s_cfg = rt.summarizer.generator.cfg
        _launch_check("runtime synthesis", dict(delta), 1, st["steps"] + 1,
                      s2s_cfg.enc_layers, s2s_cfg.dec_layers)
        text = "".join(s["content"] for s in synth.get("sections", []))
        if synth.get("patient_id") != CKPT_PATIENT or not text:
            raise AssertionError(f"empty synthesis {synth}")
        summary.update(ask_s=ask_s, ask_route=out.get("route"), synthesis_s=synth_s,
                       synthesis_steps=st["steps"], synthesis_flag_reads=st["flag_reads"],
                       synthesis_chars=len(text), uploads=len(ids),
                       breakers=sorted(status["breakers"]))
        log(f"  over HTTP: {len(ids)} uploads INDEXED, /ask in {ask_s:.2f} s (not degraded), "
            f"/api/synthese/patient in {synth_s:.2f} s through Seq2SeqEngine "
            f"({st['steps']} steps, flag read {st['flag_reads']} times, no paged decode)")
    finally:
        if not server.close(timeout=30):
            raise AssertionError("the app server's threads did not end")
        rt.stop()
    return summary, dict(delta)


def run_checkpoint_path(counts, tagger, then=None):
    """Phase 13 (the module docstring): (a)-(e) in a scratch directory that
    is removed at the end; ``then(dirs)``, when given, runs on the three
    directories before that (phase 14 (d) boots on the Mistral one)."""
    work = tempfile.mkdtemp(prefix="docqa_phase13_")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    launches = collections.Counter()
    try:
        bart_dir, bart, la = run_checkpoint_bart(counts, work, flush)
        launches.update(la)
        tiny = run_checkpoint_tiny()
        bert_dir, minilm, lc = run_checkpoint_minilm(counts, work)
        launches.update(lc)
        mistral_dir, mistral, ld = run_checkpoint_mistral(counts, work)
        launches.update(ld)
        dirs = {"encoder": bert_dir, "decoder": mistral_dir, "seq2seq": bart_dir}
        runtime, le = run_checkpoint_runtime(counts, dirs, tagger)
        launches.update(le)
        if then is not None:
            then(dirs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {"bart": bart, "tiny": tiny, "minilm": minilm, "mistral": mistral,
               "runtime": runtime}
    return {"summary": summary, "launches": dict(launches)}


# ---- phase 11: the training plane ------------------------------------------------

HOST_SPLIT_STEPS = 50  # (a): the host's share of a step, timed over this many
TRAIN_SMOKE_STEPS = 5  # (a): an in-process train_ner whose K1 launches must be 0
LM_LAYERS = 2  # (b): Mistral-7B width, depth cut (full depth: ~116 GB of state)
LM_LENGTHS = (512, 448, 301, 137)  # (b): one ragged 4 x 512 batch, repeated
LM_STEPS = 20
LM_SAVE_AT = 10  # (d): the checkpoint's step
LM_RESUME_STEPS = 5
# (b): remat on against off at the first step.  The forward runs the same
# bf16 kernels either way; the backward's embedding gradient is summed with
# atomics, so the global norm may differ in its last bits.
REMAT_LOSS_RTOL = 1e-5
REMAT_NORM_RTOL = 1e-3
# (d): a restored state is bitwise the saved one; later steps may part by
# the embedding backward's atomics only
RESUME_LOSS_RTOL = 1e-4
ENC_STEPS, ENC_BATCH, ENC_SEQ = 60, 16, 32  # (c), as tests/test_encoder_training.py
ENC_EVAL_PAIRS = 8


class _LogCapture(logging.Handler):
    """Keeps the messages one logger emits while attached."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.messages, self.logger = [], logging.getLogger(name)

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def _deid_floors(ev, split):
    """The reference's quality floors (tests/test_ner_training.py): on the
    dev set at threshold 0.5, and on the split evaluation's second
    development set."""
    misses = []

    def need(name, value, floor):
        if not value >= floor:
            misses.append(f"{name} {value} < {floor}")

    need("span_recall_any", ev["span_recall_any"], 0.85)
    need("char_f1", ev["char_f1"], 0.75)
    need("entity_f1", ev["entity_f1"], 0.50)
    need("EMAIL_ADDRESS f1", ev["per_entity"]["EMAIL_ADDRESS"]["f1"], 0.99)
    need("DATE_TIME recall", ev["per_entity"]["DATE_TIME"]["recall"], 0.99)
    test = split["test"]
    need("dev + test gold spans", split["dev"]["gold_spans"] + test["gold_spans"], 100)
    need("test gold spans", test["gold_spans"], 60)
    need("test span_recall_any", test["span_recall_any"], 0.85)
    need("test char_f1", test["char_f1"], 0.75)
    need("test entity_f1", test["entity_f1"], 0.70)
    need("test EMAIL_ADDRESS f1", test["per_entity"]["EMAIL_ADDRESS"]["f1"], 0.99)
    need("test PHONE_NUMBER recall", test["per_entity"]["PHONE_NUMBER"]["recall"], 0.99)
    lo, hi = test["entity_f1_ci95"]
    if not lo <= test["entity_f1"] <= hi:
        misses.append(f"test entity_f1 {test['entity_f1']} outside its CI {lo, hi}")
    return misses


def _deid_summary(ev, split):
    return {
        "dev": {k: ev[k] for k in ("span_recall_any", "char_f1", "entity_f1")},
        **{name: {k: split[name][k] for k in (
            "span_recall_any", "char_f1", "entity_f1", "entity_f1_ci95")}
           for name in ("test", "heldout")},
    }


def run_training_tagger(counts, workdir, replay=None):
    """Phase 11 (a): the tagger at ``NERConfig()`` trained as the default
    config's boot trains it (``DeidEngine.trained`` with no cache: 1500
    steps at batch 32, seq 128, lr 2e-3 in a child process on the card),
    then held to the reference's quality floors; returns the cache's path
    for phases 7-10 and the summary.  With ``replay`` (a dict), phase 21
    (a)'s children run beside the training child alone: started just
    before it, joined just after it (their summary goes into ``replay``),
    so every timing this process takes afterwards has the card to itself;
    the child's wall time and steps/s are marked ``contended``."""
    from docqa_tpu_torch.deid.evalset import evaluate_deid, evaluate_deid_split
    from docqa_tpu_torch.training import ner as ner_train

    dev = torch.device("cuda")
    cfg = NERConfig()
    path = os.path.join(workdir, "ner.npz")
    summary = {"steps": cfg.train_steps}
    witness = start_replay_witness() if replay is not None else None
    try:
        with _LogCapture("docqa.train.ner") as cap:
            t0 = time.perf_counter()
            DeidEngine.trained(cfg, params_path=path, device=dev)
            wall = time.perf_counter() - t0
    finally:
        if witness is not None:
            replay.update(finish_replay_witness(witness))
    if witness is not None:
        summary["contended"] = {
            "readings": ["wall_s", "steps_per_s"],
            "with": "phase 21 (a)'s two replay children (Mistral-7B bf16 each)"}
    losses = {int(m.split()[3].split("/")[0]): float(m.split()[-1])
              for m in cap.messages if m.startswith("child: ner step")}
    if sorted(losses) != list(range(100, cfg.train_steps + 1, 100)):
        raise AssertionError(f"the child's loss log is not every 100 steps: {cap.messages}")
    if not any("loaded ner params from child train" in m for m in cap.messages):
        raise AssertionError(f"the tagger did not train in its child process: {cap.messages}")
    summary.update(wall_s=wall, steps_per_s=cfg.train_steps / wall, losses=losses,
                   final_loss=losses[cfg.train_steps])
    log(f"  tagger trained at boot in a child process: {cfg.train_steps} steps in "
        f"{wall:.1f} s wall ({cfg.train_steps / wall:.1f} steps/s, start-up included"
        f"{'; beside the replay children' if witness is not None else ''}); "
        f"loss every 100 steps {[round(losses[s], 4) for s in sorted(losses)]}, final "
        f"{losses[cfg.train_steps]:.4f}")

    # the host's share of a step: datagen + encode_example, and the device
    # step (synchronised), timed apart over the same batches
    tok = datagen.ner_tokenizer(cfg)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    batches = [datagen.sample_batch(rng, tok, cfg, 32, 128) for _ in range(HOST_SPLIT_STEPS)]
    host_ms = (time.perf_counter() - t0) * 1e3 / HOST_SPLIT_STEPS
    opt = ner_train.default_ner_optimizer(2e-3, steps=cfg.train_steps)
    params = ner_train.trainable(init_ner_params(cfg, 0), cfg, dev)
    state = opt.init(params)
    step = ner_train.make_ner_train_step(cfg, opt)
    params, state, _loss = step(params, state, *batches[0])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        params, state, _loss = step(params, state, *b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / HOST_SPLIT_STEPS
    del params, state
    summary.update(host_ms=host_ms, device_step_ms=step_ms,
                   host_share=host_ms / (host_ms + step_ms))
    log(f"  a step's parts over {HOST_SPLIT_STEPS} steps: host datagen + encode_example "
        f"{host_ms:.2f} ms, device step (synchronised wall) {step_ms:.2f} ms; host share "
        f"{host_ms / (host_ms + step_ms):.3f}")

    # K1 is never launched in training: an in-process train_ner, counted
    counts.clear()
    ner_train.train_ner(cfg, steps=TRAIN_SMOKE_STEPS, log_every=0, device=dev)
    torch.cuda.synchronize()
    if counts.get("flash_attention", 0):
        raise AssertionError(f"K1 launched during training: {dict(counts)}")

    # the reference's quality floors, and K1 in the evaluation's forwards
    counts.clear()
    loaded = DeidEngine.trained(cfg, params_path=path, device=dev)
    ner08 = ner_train.evaluate_ner(loaded.params, cfg, n_examples=48, device=dev)
    ner05 = ner_train.evaluate_ner(loaded.params, cfg, n_examples=48, threshold=0.5,
                                   device=dev)
    at05 = DeidEngine.trained(cfg, params_path=path, ner_threshold=0.5, device=dev)
    ev05, split05 = evaluate_deid(at05), evaluate_deid_split(at05, n_boot=100)
    ev08, split08 = evaluate_deid(loaded), evaluate_deid_split(loaded, n_boot=100)
    torch.cuda.synchronize()
    eval_launches = dict(counts)
    if not eval_launches.get("flash_attention.prefill", 0):
        raise AssertionError(f"the evaluation's tagger forwards launched no K1: {eval_launches}")
    summary.update(
        train_launches=0, eval_launches=eval_launches,
        evaluate_ner={"threshold_0.8": ner08, "threshold_0.5": ner05},
        evaluate_deid={"threshold_0.5": _deid_summary(ev05, split05),
                       "threshold_0.8": _deid_summary(ev08, split08)},
        window=loaded._window,
    )
    log(f"  evaluate_ner (48 notes of the eval lexicons): F1 {ner08['f1']:.3f} at 0.8 "
        f"(floor 0.8), {ner05['f1']:.3f} at 0.5; evaluate_deid at 0.5 "
        f"{_deid_summary(ev05, split05)}; at 0.8 {_deid_summary(ev08, split08)}; K1 "
        f"launches: 0 in {TRAIN_SMOKE_STEPS} training steps, {eval_launches} in the "
        f"evaluation")
    misses = ([] if ner08["f1"] >= 0.8 else [f"evaluate_ner f1 {ner08['f1']} < 0.8"])
    misses += _deid_floors(ev05, split05)
    if misses:
        raise AssertionError(f"the trained tagger misses the reference's floors: {misses}")
    return path, summary


def _grad_norm(params):
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params.values()]))


def run_training_lm(counts, workdir):
    """Phase 11 (b) and (d): make_train_step at Mistral-7B width cut to
    ``LM_LAYERS`` layers, float32 master weights, one ragged 4 x 512 batch
    repeated for ``LM_STEPS`` steps with remat; remat on against off at the
    first step; a ``TrainCheckpointer`` save at ``LM_SAVE_AT``, restored
    into a fresh state that takes ``LM_RESUME_STEPS`` more steps."""
    from docqa_tpu_torch.training.checkpoint import TrainCheckpointer
    from docqa_tpu_torch.training.train import init_train_state, lm_loss, make_train_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(DecoderConfig.mistral_7b(), num_layers=LM_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    state, opt = init_train_state(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in state["params"].values())
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (len(LM_LENGTHS), max(LM_LENGTHS)),
                                        dtype=np.int32)).to(dev)
    lengths = torch.tensor(LM_LENGTHS, dtype=torch.int32, device=dev)
    counts.clear()

    # remat on against off: the first step's loss and global grad norm
    first = {}
    for remat in (False, True):
        loss = lm_loss(state["params"], cfg, ids, lengths, remat=remat)
        loss.backward()
        first[remat] = (float(loss.detach()), float(_grad_norm(state["params"])))
        for p in state["params"].values():
            p.grad = None
    (l_off, n_off), (l_on, n_on) = first[False], first[True]
    if not (abs(l_on - l_off) <= REMAT_LOSS_RTOL * abs(l_off)
            and abs(n_on - n_off) <= REMAT_NORM_RTOL * n_off):
        raise AssertionError(f"remat on {first[True]} against off {first[False]} at step 1")

    ckpt_dir = os.path.join(workdir, "lm_ckpt")
    ckpt = TrainCheckpointer(ckpt_dir, max_to_keep=1)
    step = make_train_step(cfg, opt)
    losses, times, save_s = [], [], None
    for i in range(LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, ids, lengths)
        losses.append(float(loss))  # synchronises
        times.append(time.perf_counter() - t0)
        if state["step"] == LM_SAVE_AT:
            free = shutil.disk_usage(workdir).free
            t0 = time.perf_counter()
            ckpt.save(state)
            save_s = time.perf_counter() - t0
    peak_gib = peak_allocated() / 2**30
    if counts.get("flash_attention", 0):
        raise AssertionError(f"K1 launched during LM training: {dict(counts)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the LM loss did not fall over {LM_STEPS} steps: {losses}")
    step_ms = statistics.median(times[1:]) * 1e3
    tokens = sum(LM_LENGTHS)
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, str(LM_SAVE_AT), f))
                     for f in os.listdir(os.path.join(ckpt_dir, str(LM_SAVE_AT))))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # (d): restore into a fresh state and take the next steps
    template, opt2 = init_train_state(cfg, seed=1, device=dev)
    t0 = time.perf_counter()
    restored = TrainCheckpointer(ckpt_dir, max_to_keep=1).restore(template)
    restore_s = time.perf_counter() - t0
    if restored["step"] != LM_SAVE_AT:
        raise AssertionError(f"restored step {restored['step']}, saved {LM_SAVE_AT}")
    step2 = make_train_step(cfg, opt2)
    resumed = []
    for _ in range(LM_RESUME_STEPS):
        restored, loss = step2(restored, ids, lengths)
        resumed.append(float(loss))
    want = losses[LM_SAVE_AT:LM_SAVE_AT + LM_RESUME_STEPS]
    if not all(abs(a - b) <= RESUME_LOSS_RTOL * abs(b) for a, b in zip(resumed, want)):
        raise AssertionError(f"resumed losses {resumed} against uninterrupted {want}")
    del restored, template
    shutil.rmtree(ckpt_dir)
    gc.collect()
    torch.cuda.empty_cache()
    summary = {
        "layers": LM_LAYERS, "params": n_params, "batch": [len(LM_LENGTHS), max(LM_LENGTHS)],
        "tokens_per_step": tokens, "losses": losses, "ms_per_step": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3, "peak_gib": peak_gib,
        "remat": {"off": first[False], "on": first[True]},
        "checkpoint": {"bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s,
                       "disk_free_before": free, "resumed_losses": resumed},
    }
    log(f"  LM at Mistral-7B width, {LM_LAYERS} layers ({n_params / 1e9:.3f} B float32 "
        f"params): {LM_STEPS} steps on a {len(LM_LENGTHS)} x {max(LM_LENGTHS)} batch "
        f"({tokens} tokens), loss {losses[0]:.4f} -> {losses[-1]:.3e}; {step_ms:.1f} ms a "
        f"step (median, remat on), {tokens / step_ms * 1e3:.0f} tokens/s, peak "
        f"{peak_gib:.2f} GiB; remat off/on at step 1: loss {l_off:.6f}/{l_on:.6f}, grad "
        f"norm {n_off:.6f}/{n_on:.6f}")
    log(f"  checkpoint at step {LM_SAVE_AT}: {ckpt_bytes / 2**30:.2f} GiB written in "
        f"{save_s:.1f} s ({free / 2**30:.0f} GiB free before), restored in "
        f"{restore_s:.1f} s; resumed losses {resumed} against {want}")
    return summary


def _recall_at_1(params, cfg, tok, pairs, use_flash):
    from docqa_tpu_torch.models.encoder import encode_batch

    dev = next(iter(params.values())).device
    emb = []
    for texts in ([q for q, _ in pairs], [p for _, p in pairs]):
        ids, lens = tok.batch(texts, max_len=ENC_SEQ)
        with torch.no_grad():
            emb.append(encode_batch(params, cfg, torch.from_numpy(ids).long().to(dev),
                                    torch.from_numpy(lens).to(dev), use_flash=use_flash))
    pred = (emb[0] @ emb[1].T).argmax(dim=1).cpu().numpy()
    return float(np.mean(pred == np.arange(len(pairs)))), emb[1]


def run_training_encoder(counts, workdir):
    """Phase 11 (c): ``train_encoder`` at MiniLM width (``EncoderConfig()``,
    bf16) for ``ENC_STEPS`` steps of batch ``ENC_BATCH`` on synthetic pairs;
    the loss on the first batch must fall and held-out recall@1 must not;
    the trained params encoded through K1 must match the plain attention;
    a ``TrainCheckpointer`` with ``max_to_keep=2`` must prune."""
    from docqa_tpu_torch.text.tokenizer import default_tokenizer
    from docqa_tpu_torch.training.checkpoint import TrainCheckpointer
    from docqa_tpu_torch.training.encoder import (
        encode_pair_batch, info_nce_loss, init_encoder_train_state,
        make_encoder_train_step, synthetic_pairs, train_encoder,
    )
    from docqa_tpu_torch.weights import host_init_encoder_params, to_torch

    dev = torch.device("cuda")
    cfg = EncoderConfig()
    tok = default_tokenizer(cfg.vocab_size)
    eval_pairs = synthetic_pairs(np.random.default_rng(123), ENC_EVAL_PAIRS)
    init = to_torch(host_init_encoder_params(cfg, 0), dev, torch.float32)
    first = [torch.as_tensor(a, device=dev) for a in encode_pair_batch(
        tok, synthetic_pairs(np.random.default_rng(1), ENC_BATCH), ENC_SEQ)]

    def first_loss(params):
        with torch.no_grad():
            return float(info_nce_loss(params, cfg, first[0].long(), first[1],
                                       first[2].long(), first[3]))

    acc0, _ = _recall_at_1(init, cfg, tok, eval_pairs, use_flash=False)
    loss0 = first_loss(init)
    counts.clear()
    t0 = time.perf_counter()
    trained = train_encoder(cfg, steps=ENC_STEPS, batch_size=ENC_BATCH, seq=ENC_SEQ,
                            seed=1, params=init, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if counts.get("flash_attention", 0):
        raise AssertionError(f"K1 launched during encoder training: {dict(counts)}")
    loss1 = first_loss(trained)
    acc1, plain = _recall_at_1(trained, cfg, tok, eval_pairs, use_flash=False)
    if not loss1 < loss0:
        raise AssertionError(f"the encoder's loss did not fall: {loss0} -> {loss1}")
    if not acc1 >= acc0:
        raise AssertionError(f"held-out recall@1 fell: {acc0} -> {acc1}")
    counts.clear()
    acc_k1, served = _recall_at_1(trained, cfg, tok, eval_pairs, use_flash=True)
    torch.cuda.synchronize()
    k1 = dict(counts)
    if not k1.get("flash_attention.prefill", 0):
        raise AssertionError(f"the trained encoder's serving encode launched no K1: {k1}")
    atol, rtol = TOL[torch.bfloat16]
    err = (served - plain).abs()
    if not bool((err <= atol + rtol * plain.abs()).all()):
        raise AssertionError(f"K1 embeddings part from the plain ones by {float(err.max())}")

    # max_to_keep prunes, and restore places the state on the card
    ck_dir = os.path.join(workdir, "enc_ckpt")
    state, opt = init_encoder_train_state(cfg, params=trained, device=dev)
    step = make_encoder_train_step(cfg, opt)
    ckpt = TrainCheckpointer(ck_dir, max_to_keep=2)
    batch = encode_pair_batch(tok, synthetic_pairs(np.random.default_rng(2), ENC_BATCH),
                              ENC_SEQ)
    for _ in range(3):
        state, _loss = step(state, *batch)
        ckpt.save(state)
    kept = sorted(os.listdir(ck_dir))
    if kept != ["2", "3"]:
        raise AssertionError(f"max_to_keep=2 kept {kept}")
    template, _opt = init_encoder_train_state(cfg, device=dev)
    ckpt.restore(template)
    if not all(torch.equal(template["params"][k], v) for k, v in state["params"].items()):
        raise AssertionError("the restored encoder state differs from the saved one")
    shutil.rmtree(ck_dir)
    summary = {"steps": ENC_STEPS, "batch": ENC_BATCH, "train_s": train_s,
               "first_batch_loss": [loss0, loss1], "recall_at_1": [acc0, acc1],
               "recall_at_1_k1": acc_k1, "k1_launches": k1,
               "k1_vs_plain_max_abs_err": float(err.max()), "checkpoints_kept": kept}
    log(f"  encoder at MiniLM width: {ENC_STEPS} steps of {ENC_BATCH} pairs in "
        f"{train_s:.1f} s; first-batch loss {loss0:.4f} -> {loss1:.4f}; held-out recall@1 "
        f"on {ENC_EVAL_PAIRS} pairs {acc0:.3f} -> {acc1:.3f} (through K1 {acc_k1:.3f}, "
        f"embeddings within {float(err.max()):.2e} of the plain path, K1 launches {k1}); "
        f"checkpoints kept {kept}")
    return summary


# ---- phase 14: the quantised decoder -------------------------------------------

# K4's cases: the Mistral-7B projections ([in, out]) at the main path's rows:
# the solo verify (K = 4), a 4-, 8- and 16-lane batcher verify, a packed
# prefill
QUANT_SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("w_gate", 4096, 14336),
                ("w_down", 14336, 4096), ("lm_head", 4096, 32000))
QUANT_ROWS = (4, 16, 32, 64, 2048)
# Llama-3-8B's lm_head (phase 20's decoder), int8, at the solo verify's rows
# and a packed prefill's; the int-weight library call is timed at m = 4
# only (at 2,048 rows one call of it takes seconds)
QUANT_LLAMA3_HEAD = ("lm_head_128k", 4096, 128256, (4, 2048))
QUANT_TIMED = "w_gate_m4"  # the case each K4 entry of the kernels line reports
QUANT_TIMED_MODE = {"ring": "w_gate_m4", "wgmma": "w_gate_m2048",  # and each kernel's
                    "simple": "ref_w_gate_m4"}
# shapes the TMA kernels refuse, so K4's simple kernel takes them, as
# (name, m, in, out, bits, int4 group or None): the reference's own
# configuration at its 4-token prompt (hidden 64, so int4 groups of 64;
# ``check_reference_config`` runs its projections there), and card-test
# shapes with ragged edges (in 100, out 130; out 1,000 with K split 64 ways;
# 70 rows over int4 groups of 48)
QUANT_SIMPLE = (("ref_wq", 4, 64, 64, 4, None), ("ref_wk", 4, 64, 32, 4, None),
                ("ref_w_gate", 4, 64, 128, 4, None), ("ragged", 37, 100, 130, 8, None),
                ("ragged_split", 4, 4096, 1000, 8, None), ("ragged_g48", 70, 96, 200, 4, 48))
# the reference's criteria for a quantised forward against its float one,
# max |logits - float logits| / std(float logits): int8 under 0.15 with the
# same argmax (tests/test_quant.py:63-86), int4 finite and under 3.0, which
# "only guards against a broken dequant" (tests/test_quant.py:244-265).
# They were set on a float32 model of hidden 64 and vocabulary 256, and are
# asserted on the card there (``check_reference_config``).  At Mistral-7B
# width they are printed, at 2 layers (``QUANT_CUT_LAYERS``) and at 32,
# beside bf16's own gap to float32 at the same weights (the depth baseline)
# and the reference's scheme computed in float32 (the width control); at
# that width each quantised leaf is held to its bf16 weight elementwise
# (``check_dequant_bound``)
QUANT_LOGIT_CRITERION = {8: 0.15, 4: 3.0}
QUANT_CUT_LAYERS = 2
QUANT_ASK_TOKENS = 64
QUANT_PROJECTIONS = 7  # q, k, v, o, gate, up, down: K4 launches a layer


def _has_cuda_kernel(op):
    try:
        return torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    except RuntimeError:
        return False


def int_weight_library(mode, q, sc, k):
    """The one PyTorch call that computes the same int-weight product on the
    card, as ``(fn(x), None)``, or ``(None, why not)``: int8
    ``torch._weight_int8pack_mm`` (``[N, K]`` int8, bf16 scales applied
    after the dot), int4 ``torch._weight_int4pack_mm`` on the weight
    converted by ``torch._convert_weight_to_int4pack`` (unsigned nibbles
    q + 8, even k in the high nibble, scale and zero point a group and
    column, zero 0).  A yardstick only: the port never calls either."""
    try:
        if mode == "int8":
            if not _has_cuda_kernel("aten::_weight_int8pack_mm"):
                return None, "not available (no CUDA kernel)"
            w_nk = q.t().contiguous()
            scales = sc.to(torch.bfloat16)
            return (lambda x: torch._weight_int8pack_mm(x, w_nk, scales)), None
        if not (_has_cuda_kernel("aten::_weight_int4pack_mm")
                and _has_cuda_kernel("aten::_convert_weight_to_int4pack")):
            return None, "not available (no CUDA kernel)"
        g = qm.int4_group(q, k)
        u = (qm.unpack_int4(q, g).reshape(k, -1).to(torch.int32) + 8).t().contiguous()
        packed = torch._convert_weight_to_int4pack(
            (u[:, 0::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack((sc, torch.zeros_like(sc)), dim=-1).to(torch.bfloat16).contiguous()
        return (lambda x: torch._weight_int4pack_mm(x, packed, g, sz)), None
    except (RuntimeError, TypeError) as e:
        return None, f"not available ({type(e).__name__}: {str(e).splitlines()[0][:120]})"


def _k4_case(case, x, q, sc, flush, library, lib, onehot, rows, parent=None):
    """One case of ``run_qmatmul_cases``: K4 on ``x`` and the store ``q``,
    ``sc`` against its plain version, on one-hot rows bit for bit and
    twice bit for bit, one launch counted under ``qmatmul``, its weight
    mode and the kernel its plan names; then timed (with ``parent``, the
    parent's K4 on a copy of the store too, in turns: parent, this, this,
    parent)."""
    m, k = x.shape
    n = q.shape[-1]
    mode = "int8" if q.dtype == torch.int8 else "int4"
    atol, rtol = TOL[torch.bfloat16]
    before = collections.Counter(_kernels.LAUNCHES)
    got = qm.qmatmul(x, q, sc)
    torch.cuda.synchronize()
    launched = collections.Counter(_kernels.LAUNCHES)
    launched.subtract(before)
    launched = {key: v for key, v in launched.items() if v}
    plan = getattr(q, qm._STORE).plan(m)
    if launched != {"qmatmul": 1, f"qmatmul.{mode}": 1, f"qmatmul.{plan.kernel}": 1}:
        raise AssertionError(f"qmatmul {case}: one product counted {launched}, "
                             f"plan {plan.kernel}")
    want = qm.qmatmul_reference(x, q, sc).float()

    def check(who, y):
        err = (y.float() - want).abs()
        if not bool((err <= atol + rtol * want.abs()).all()) or not torch.isfinite(y).all():
            raise AssertionError(f"qmatmul {case} {who}: max |err| {float(err.max()):.3e} "
                                 f"over atol {atol} rtol {rtol}")
        return float(err.max())

    max_err = check("K4", got)
    if not torch.equal(qm.qmatmul(x, q, sc), got):
        raise AssertionError(f"qmatmul {case}: a second product differs from the first")
    if not torch.equal(qm.qmatmul(onehot, q, sc), qm.dequantize(q, sc, torch.bfloat16, k)[rows]):
        raise AssertionError(f"qmatmul {case}: one-hot rows differ from the dequantised "
                             "weight rows")
    ab = None
    if parent is None:
        ms = time_ms(lambda: qm.qmatmul(x, q, sc), flush)
    else:
        qp = q.clone()  # the parent's store lives on its own tensor
        check("parent", parent.qmatmul(x, qp, sc))
        t = [time_ms(lambda: parent.qmatmul(x, qp, sc), flush),
             time_ms(lambda: qm.qmatmul(x, q, sc), flush),
             time_ms(lambda: qm.qmatmul(x, q, sc), flush),
             time_ms(lambda: parent.qmatmul(x, qp, sc), flush)]
        ms, ab = t[1], {"parent_ms": [t[0], t[3]], "this_ms": [t[1], t[2]]}
    lib_fn, lib_why = lib
    int_ms = int_err = None
    if lib_fn is not None:
        try:
            # a yardstick only; at m = 2,048 a call takes up to 0.6 s
            int_ms = time_ms(lambda: lib_fn(x), flush, reps=5, warmup=1)
            int_err = float((lib_fn(x).float() - want).abs().max())
        except RuntimeError as e:
            lib_why = f"not available (RuntimeError: {str(e).splitlines()[0][:120]})"
    nbytes = q.numel() + 4 * sc.numel() + 2 * m * k + 2 * m * n
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = 2 * m * k * n / PEAK_BF16_FLOPS * 1e3
    rec = {
        "case": case, "weight": case.split(f"_m{m}_")[0], "m": m, "mode": mode,
        "kernel": plan.kernel, "launched": launched, "shape": f"m{m} in{k} out{n}",
        "plan": plan._asdict(), "max_abs_err": max_err, "onehot_exact": True,
        "repeat_exact": True, "ms": ms,
        "plain_ms": time_ms(lambda: qm.qmatmul_reference(x, q, sc), flush),
        "library_ms": library, "int_library_ms": int_ms, "int_library_max_abs_err": int_err,
        "int_library": lib_why or ("torch._weight_int8pack_mm" if mode == "int8"
                                   else "torch._weight_int4pack_mm"),
        "bound_ms": max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
        "weight_bytes": q.numel() + 4 * sc.numel(), "tolerance": TOL[torch.bfloat16],
    }
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    if ab:
        rec["ab"] = ab
    int_lib = ("not available" if int_ms is None
               else f"{int_ms:.4f} ms (|err| {int_err:.2e})")
    vs = "" if ab is None else (
        f"  parent {ab['parent_ms'][0]:.4f}, {ab['parent_ms'][1]:.4f} ms  this "
        f"{ab['this_ms'][0]:.4f}, {ab['this_ms'][1]:.4f} ms ("
        f"{min(ab['parent_ms']) / max(ab['this_ms']):.2f}x or better)")
    log(f"  qmatmul {case:20s} {plan.kernel:6s} splits {plan.splits:2d} grid {plan.grid:4d}, "
        f"1 launch  err {max_err:.2e} one-hot and repeat exact  kernel {ms:.4f} ms  plain "
        f"{rec['plain_ms']:.4f} ms  cuBLAS bf16 {library:.4f} ms  int-weight library "
        f"{int_lib}  bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
        f"{100 * rec['bound_share']:.1f} % of it){vs}")
    return rec


def run_qmatmul_cases(flush, parent=None):
    """(a) K4 alone: each Mistral-7B projection at 4, 16, 32, 64 and 2,048
    rows, int8 and (but ``lm_head``, int8 in both modes) int4, then the
    shapes of ``QUANT_SIMPLE`` (the simple kernel's), each through
    ``_k4_case``.  Timed as phase 2 times K1: the kernel, the plain
    version, ``torch.matmul`` on the unquantised bf16 weight (what the bf16
    engine runs) and the int-weight library call where the card's torch
    has one (``int_weight_library``); the bound max(bytes / 3.35 TB/s,
    2 m in out / 989 TFLOP/s), the bytes the packed weights, scales, x and
    y once each.  ``parent`` (``load_parent_k4``) times another
    checkout's K4 beside each case, in turns."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    results = []

    def onehot_of(m, k):
        rows = torch.randint(0, k, (m,), generator=gen, device=dev)
        onehot = torch.zeros((m, k), dtype=torch.bfloat16, device=dev)
        onehot[torch.arange(m, device=dev), rows] = 1
        return onehot, rows

    for name, k, n in QUANT_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        wb = w.to(torch.bfloat16)
        packs = [("int8", *quant.quantize_array(w))]
        if name != "lm_head":
            packs.append(("int4", *quant.quantize_array_int4(w)))
        del w
        libs = {mode: int_weight_library(mode, q, sc, k) for mode, q, sc in packs}
        for m in QUANT_ROWS:
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            library = time_ms(lambda: x @ wb, flush)
            onehot, rows = onehot_of(m, k)
            for mode, q, sc in packs:
                results.append(_k4_case(f"{name}_m{m}_{mode}", x, q, sc, flush, library,
                                        libs[mode], onehot, rows, parent))
        for mode, (_fn, why) in libs.items():
            if why:
                log(f"  int-weight library for {name} {mode}: {why}")
        del wb, packs, libs
    name, k, n, rows_m = QUANT_LLAMA3_HEAD
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    wb = w.to(torch.bfloat16)
    q, sc = quant.quantize_array(w)
    del w
    for m in rows_m:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        onehot, rows = onehot_of(m, k)
        lib = (int_weight_library("int8", q, sc, k) if m == 4
               else (None, "not timed at this shape (a call takes seconds)"))
        results.append(_k4_case(f"{name}_m{m}_int8", x, q, sc, flush,
                                time_ms(lambda: x @ wb, flush), lib, onehot, rows, parent))
    del wb, q, sc
    for name, m, k, n, bits, group in QUANT_SIMPLE:
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        wb = w.to(torch.bfloat16)
        mode = f"int{bits}"
        q, sc = quant.quantize_array(w) if bits == 8 else quant.quantize_array_int4(w, group)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        onehot, rows = onehot_of(m, k)
        rec = _k4_case(f"{name}_m{m}_{mode}", x, q, sc, flush, time_ms(lambda: x @ wb, flush),
                       int_weight_library(mode, q, sc, k), onehot, rows, parent)
        if rec["kernel"] != "simple":
            raise AssertionError(f"qmatmul {rec['case']}: planned {rec['kernel']}, not simple")
        results.append(rec)
    return results


def host_us_a_call(parent=None, n=200, rounds=2):
    """Host microseconds to enqueue one product at the solo verify's ``wq``
    shape (m = 4, 4,096 x 4,096), no sync inside: K4 int8 and int4 against
    ``torch.matmul`` on the bf16 weight (and ``parent``'s K4 on copies of
    the stores), in turns, behind a long spin so the host never waits on
    the device.  A verify step enqueues 225 products and is host-bound, so
    this, not the device time, is what a step feels."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    w = torch.randn((4096, 4096), generator=gen, device=dev) * 4096 ** -0.5
    x = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    wb = w.to(torch.bfloat16)
    fns = [("torch.matmul bf16", lambda: x @ wb)]
    for mode, (q, sc) in (("int8", quant.quantize_array(w)),
                          ("int4", quant.quantize_array_int4(w))):
        if parent is not None:
            fns.append((f"parent {mode}",
                        lambda qp=q.clone(), sc=sc: parent.qmatmul(x, qp, sc)))
        fns.append((f"K4 {mode}", lambda q=q, sc=sc: qm.qmatmul(x, q, sc)))
    out = collections.defaultdict(list)
    for r in range(rounds):
        for name, fn in fns if r % 2 == 0 else fns[::-1]:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(250_000 * n)  # ~0.13 ms a call of spin
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out[name].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    log("  host us to enqueue one wq product at m = 4 (rounds): " + "; ".join(
        f"{name} " + ", ".join(f"{us:.1f}" for us in v) for name, v in out.items()))
    return dict(out)


def load_parent_k4(root):
    """The K4 wrapper of another checkout at ``root`` (its
    ``ops/qmatmul.py``, its ``csrc/qmatmul.cu`` built here with this
    tree's flags), bound to its own library and counting into its own
    counter, for an A/B in one process (``run_qmatmul_cases`` and
    ``host_us_a_call`` with ``parent``): the wrapper's module is loaded
    under another name, so the two keep their stores apart only if they
    are given separate weight tensors."""
    import importlib.util
    import types

    src = os.path.join(root, "docqa_tpu_torch", "csrc", "qmatmul.cu")
    lib_path = _kernels.BUILD_DIR / "libqmatmul-parent.so"
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib_path), src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    spec = importlib.util.spec_from_file_location(
        "k4_parent_qmatmul", os.path.join(root, "docqa_tpu_torch", "ops", "qmatmul.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    counted, lock = collections.Counter(), threading.Lock()

    def count(*names):
        with lock:
            for name in names:
                counted[name] += 1

    mod._kernels = types.SimpleNamespace(load=lambda name: lib, count=count,
                                         KernelError=_kernels.KernelError)
    return mod


def _logit_gap(got, ref):
    """The reference's quantised-forward criterion, max |got - ref| over
    std(ref), and whether the argmax agrees."""
    max_abs = float((got - ref).abs().max())
    return max_abs / max(float(ref.std()), 1e-6), int(got.argmax()) == int(ref.argmax())


def check_dequant_bound(qtree, params):
    """Each quantised leaf of ``qtree``, dequantised by the plain version
    (which K4 equals bit for bit on one-hot rows, (a)), against the bf16
    weight of ``params`` it was quantised from: |W~ - W| <= s / 2 (the
    rounding to a level) + 2^-7 |q| s (1 + 2^-8) (bf16's rounding of the
    scale and of the product) + 2^-22 |W| (float32's of W / s), elementwise,
    s the element's scale.  A wrong scale axis, group or packing breaks it
    at any depth.  Returns the largest |W~ - W| / s and the leaves held."""
    worst, leaves = 0.0, 0
    for name, w in params.items():
        sc = qtree.get(name + quant.SCALE_SUFFIX)
        if sc is None:
            continue
        q, in_dim = qtree[name], w.shape[0]
        if q.dtype == torch.int8:
            qv, s = q.float(), sc[None, :]
        else:
            g = qm.int4_group(q, in_dim)
            qv = qm.unpack_int4(q, g).reshape(in_dim, -1).float()
            s = sc.repeat_interleave(g, dim=0)
        w32 = w.float()
        err = (qm.dequantize(q, sc, torch.bfloat16, in_dim).float() - w32).abs()
        bound = 0.5 * s + 2.0 ** -7 * (1 + 2.0 ** -8) * qv.abs() * s + 2.0 ** -22 * w32.abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name}: dequantised weight off its bf16 weight by "
                                 f"{float((err - bound).max()):.3e} past the bound")
        worst = max(worst, float((err / s).max()))
        leaves += 1
        del qv, s, w32, err, bound
    return worst, leaves


K4_MODES = ("qmatmul.ring", "qmatmul.wgmma", "qmatmul.simple")


def _k4_split_ok(counts):
    """The wrapper counts a product under ``qmatmul``, its weight mode and
    its kernel mode: both splits of a run sum to its total."""
    total = counts.get("qmatmul", 0)
    return (counts.get("qmatmul.int8", 0) + counts.get("qmatmul.int4", 0) == total
            == sum(counts.get(name, 0) for name in K4_MODES))


def _k4_identity(where, delta, layers, forwards):
    want = (QUANT_PROJECTIONS * layers + 1) * forwards
    if delta.get("qmatmul", 0) != want or forwards < 1:
        raise AssertionError(f"{where}: K4 launched {delta.get('qmatmul', 0)} times, expected "
                             f"({QUANT_PROJECTIONS} x {layers} + 1) x {forwards} forwards = {want}")
    if not _k4_split_ok(delta):
        raise AssertionError(f"{where}: K4's weight and kernel modes do not sum to its "
                             f"launches: {dict(delta)}")
    return want


def _counted_ask(counts, qa, question, enc_layers, k4, where="phase 14 /ask"):
    """One solo /ask with its launch identities: K1 encoder layers +
    forwards x decoder layers, and (a quantised engine) K4 (7 L + 1) x
    forwards, or none."""
    gen = qa.generator
    layers = gen.cfg.num_layers
    before = collections.Counter(counts)
    t0 = time.perf_counter()
    out = qa.ask(question)
    latency = time.perf_counter() - t0
    _no_degraded(where, [out])
    delta = collections.Counter(counts)
    delta.subtract(before)
    st = dict(gen.last_stats)
    if k4:
        _k4_identity(where, delta, layers, st["forwards"])
    elif delta.get("qmatmul", 0):
        raise AssertionError(f"{where}: a bf16 /ask launched K4 {delta['qmatmul']} times")
    if delta["flash_attention"] != enc_layers + st["forwards"] * layers:
        raise AssertionError(f"{where}: K1 launched {delta['flash_attention']}")
    return {"latency_s": latency, "forwards": st["forwards"],
            "k1_launches": delta["flash_attention"], "k4_launches": delta.get("qmatmul", 0),
            "decode_tokens": st["decode_tokens"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "verify_step_ms": st["decode_s"] / max(st["forwards"] - 1, 1) * 1e3}


def check_reference_config(counts):
    """The reference's own quantised-forward tests on the card, where their
    criteria were set (tests/test_quant.py:63-86 and 244-265): a float32
    model of vocabulary 256, hidden 64, mlp 128, 2 layers (its 4 heads of
    16 regrouped into 2 of 32, K1's smallest head_dim: every weight shape
    the same), seeded random weights, the prompt [3, 9, 17, 4].  Its logits
    in float32 against the int8 and int4 trees' through K4 in bf16 (7 x 2 +
    1 launches): max|d|/std over every position under 0.15 with the last
    position's argmax kept (int8), finite and under 3.0 (int4).  Returns
    the gaps and the run's launches: its int4 groups of 64 take K4's
    simple kernel, which the Mistral-7B runs never launch."""
    dev = torch.device("cuda")
    rcfg = DecoderConfig(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=2,
                         num_kv_heads=1, head_dim=32, mlp_dim=128, max_seq_len=128,
                         dtype="float32")
    params = init_decoder_params(rcfg, 0, dev)
    ids = torch.tensor([[3, 9, 17, 4]], device=dev)

    def run(p, c):
        cache = init_kv_cache(c, 1, max_len=32, dtype=getattr(torch, c.dtype), device=dev)
        with torch.inference_mode():
            return decoder_forward(
                p, c, ids, cache, torch.zeros(1, dtype=torch.int32, device=dev),
                attn_lengths=torch.tensor([4], dtype=torch.int32, device=dev))[0].float()

    full = run(params, rcfg)
    out = {}
    start = collections.Counter(counts)
    for bits in (8, 4):
        qcfg = dataclasses.replace(rcfg, dtype="bfloat16", quantize_weights=True,
                                   quant_bits=bits)
        before = counts.get("qmatmul", 0)
        got = run(quant.quantize_decoder_params(params, bits), qcfg)
        launched = counts.get("qmatmul", 0) - before
        rel = _logit_gap(got, full)[0]
        same = int(got[-1].argmax()) == int(full[-1].argmax())
        out[f"int{bits}"] = {"max_abs_over_std": rel, "same_argmax": same}
        log(f"  the reference's config (hidden 64, vocabulary 256, 2 layers), int{bits} "
            f"through K4 in bf16 vs float32: max|d|/std {rel:.4f} (criterion "
            f"{QUANT_LOGIT_CRITERION[bits]}), last argmax {'kept' if same else 'differs'}, "
            f"K4 launches {launched}")
        if launched != QUANT_PROJECTIONS * rcfg.num_layers + 1:
            raise AssertionError(f"int{bits} at the reference's config: K4 launched {launched}")
        if not (math.isfinite(rel) and rel < QUANT_LOGIT_CRITERION[bits]
                and (same or bits == 4)):
            raise AssertionError(f"int{bits} at the reference's config fails its criterion: "
                                 f"{out[f'int{bits}']}")
    launched = collections.Counter(counts)
    launched.subtract(start)
    return out, {key: n for key, n in launched.items() if n}


def run_quant_solo(counts, qa, params):
    """(b) phase 3's Mistral-7B bf16 tree quantised on the card tensor by
    tensor, int8 then int4: tree bytes, seconds and peak memory above what
    was allocated; every quantised leaf within ``check_dequant_bound`` of
    its bf16 weight; first-step logits of the four questions' prompts
    against the bf16 engine's on the same weights at all layers and at the
    first ``QUANT_CUT_LAYERS`` (printed beside bf16's own gap to float32 and,
    at the cut, the scheme's in float32), and against the same quantised
    tree through the plain version (within ``FIRST_STEP_RTOL``); the four
    questions at 64 new tokens, asked of the
    bf16 engine and the quantised one in turns, each quantised /ask's K4
    launches (7 L + 1) x its forwards.  Returns the summary, the
    launches of each mode's asks and the int8 engine (for (c))."""
    dev = torch.device("cuda")
    gen16 = qa.generator
    cfg = gen16.cfg
    enc_layers = qa.retriever.encoder.cfg.num_layers
    prompts = [first_step_prompt(qa, q, 1024 - 2 - gen16.gen.speculative_k)[1]
               for q in QUESTIONS]
    bf16_logits = [solo_first_step(gen16, ids) for ids in prompts]
    # the depth baseline: bf16 against float32 compute at the same weights
    # (each projection's weight cast on the fly; TF32 is off), at all 32
    # layers and at the first QUANT_CUT_LAYERS
    def cut(tree):
        return {k: v for k, v in tree.items()
                if not (m := re.match(r"l(\d+)_", k)) or int(m.group(1)) < QUANT_CUT_LAYERS}

    cut_cfg = dataclasses.replace(cfg, num_layers=QUANT_CUT_LAYERS)
    cut_logits = [solo_first_step(gen16, ids, cut(params), cut_cfg) for ids in prompts]
    cut32_cfg = dataclasses.replace(cut_cfg, dtype="float32")
    cut32_logits = [solo_first_step(gen16, ids, cut(params), cut32_cfg) for ids in prompts]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    f32 = {str(cfg.num_layers): [_logit_gap(ref, solo_first_step(gen16, ids, cfg=cfg32))[0]
                                 for ids, ref in zip(prompts, bf16_logits)],
           str(QUANT_CUT_LAYERS): [_logit_gap(ref, r32)[0]
                                   for ref, r32 in zip(cut_logits, cut32_logits)]}
    log(f"  depth baseline, bf16 vs float32 first-step logits max|d|/std: {cfg.num_layers} "
        f"layers " + ", ".join(f"{g:.3f}" for g in f32[str(cfg.num_layers)])
        + f"; {QUANT_CUT_LAYERS} layers "
        + ", ".join(f"{g:.3f}" for g in f32[str(QUANT_CUT_LAYERS)]))
    summary, launches, engine8 = {"bf16_vs_f32": f32}, {}, None
    for bits in (8, 4):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_peak()
        t0 = time.perf_counter()
        qtree = quant.quantize_decoder_params(params, bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        # what quantising held beyond the finished tree: one tensor's
        # temporaries
        peak = peak_allocated() - torch.cuda.memory_allocated()
        qcfg = dataclasses.replace(cfg, quantize_weights=True, quant_bits=bits)
        qgen = GenerateEngine(qcfg, GenerateConfig(max_new_tokens=QUANT_ASK_TOKENS,
                                                   speculative_k=4),
                              params=qtree, device=dev)
        del qtree
        rec = {"tree_bytes": quant.tree_bytes(qgen.params), "quantise_s": quant_s,
               "quantise_transient_gib": peak / 2**30,
               "weight_bytes_a_forward": decoder_weight_bytes(qcfg)}
        worst, leaves = check_dequant_bound(qgen.params, params)
        rec["dequant_bound"] = {"max_err_over_scale": worst, "leaves": leaves}
        # first-step logits: against bf16 at all layers and at the cut, and
        # the kernel against the plain path
        gaps, plain_rel = [], []
        kernel_fn = qm.qmatmul
        for ids, ref in zip(prompts, bf16_logits):
            got = solo_first_step(qgen, ids)
            gaps.append(_logit_gap(got, ref))
            qm.qmatmul = qm.qmatmul_reference
            try:
                plain = solo_first_step(qgen, ids)
            finally:
                qm.qmatmul = kernel_fn
            plain_rel.append(float((got - plain).norm() / plain.norm()))
        qcut_cfg = dataclasses.replace(qcfg, num_layers=QUANT_CUT_LAYERS)
        cut_gaps = [_logit_gap(solo_first_step(qgen, ids, cut(qgen.params), qcut_cfg), ref)
                    for ids, ref in zip(prompts, cut_logits)]
        # the width control: the reference's scheme as its tests run it, the
        # dequantisation q * s and every product in float32 (the plain
        # version), against the float32 model, at the cut
        qm.qmatmul = qm.qmatmul_reference
        try:
            qcut32_cfg = dataclasses.replace(qcut_cfg, dtype="float32")
            ref32_gaps = [_logit_gap(solo_first_step(qgen, ids, cut(qgen.params), qcut32_cfg), r)
                          for ids, r in zip(prompts, cut32_logits)]
        finally:
            qm.qmatmul = kernel_fn
        rec["logits_vs_bf16"] = [{"max_abs_over_std": g, "same_argmax": a} for g, a in gaps]
        rec["logits_vs_bf16_cut"] = [{"max_abs_over_std": g, "same_argmax": a}
                                     for g, a in cut_gaps]
        rec["float32_scheme_vs_float32_cut"] = [{"max_abs_over_std": g, "same_argmax": a}
                                                for g, a in ref32_gaps]
        rec["kernel_vs_plain_rel_rms"] = plain_rel
        rec["reference_criterion"] = QUANT_LOGIT_CRITERION[bits]

        def gap_text(gs):
            return ", ".join(f"{g:.3f}{'' if a else ' (argmax differs)'}" for g, a in gs)

        log(f"  int{bits}: tree {rec['tree_bytes'] / 1e9:.3f} GB (a forward reads "
            f"{rec['weight_bytes_a_forward'] / 1e9:.3f} GB), quantised in {quant_s:.2f} s, "
            f"{rec['quantise_transient_gib']:.2f} GiB held beyond the tree; {leaves} leaves "
            f"within the dequantisation bound of their bf16 weights (max |W~ - W| / s "
            f"{worst:.4f}); first-step logits vs bf16 max|d|/std, {cfg.num_layers} layers "
            f"{gap_text(gaps)}; {QUANT_CUT_LAYERS} layers {gap_text(cut_gaps)}; the scheme in "
            f"float32 vs float32 at {QUANT_CUT_LAYERS} layers {gap_text(ref32_gaps)} (the "
            f"reference's criterion at hidden 64, vocabulary 256: "
            f"{QUANT_LOGIT_CRITERION[bits]}); kernel vs plain relative RMS "
            + ", ".join(f"{r:.2e}" for r in plain_rel) + f" (tolerance {FIRST_STEP_RTOL})")
        if max(plain_rel) > FIRST_STEP_RTOL:
            raise AssertionError(f"int{bits}: K4 engine vs the plain path {plain_rel}")
        if not all(math.isfinite(g) for g, _a in gaps + cut_gaps + ref32_gaps):
            raise AssertionError(f"int{bits} first-step logits not finite: {gaps} {cut_gaps}")
        # the four questions, counted, each asked of the bf16 engine and the
        # quantised one in turns (bf16 first on even questions), so a step's
        # time is compared on the host as it is at that moment
        qa_q = QAService(qa.retriever.encoder, qa.retriever.store, qgen, k=3, device=dev)
        per_q = []
        counts.clear()
        for i, question in enumerate(QUESTIONS):
            order = (("bf16", qa), (f"int{bits}", qa_q))
            rec_q = {}
            for mode, service in order if i % 2 == 0 else order[::-1]:
                with peak_reading("int8_ask", on=mode == "int8" and i == 0):
                    rec_q[mode] = _counted_ask(counts, service, question, enc_layers,
                                               k4=mode != "bf16")
            got, ref = rec_q[f"int{bits}"], rec_q["bf16"]
            per_q.append({**got, **{f"bf16_{k}": v for k, v in ref.items()}})
            log(f"    int{bits} ask {i}: {got['latency_s']:.3f} s (bf16 "
                f"{ref['latency_s']:.3f}), {got['forwards']} forwards (bf16 {ref['forwards']}), "
                f"{got['verify_step_ms']:.2f} ms a verify step (bf16 "
                f"{ref['verify_step_ms']:.2f}), decode {got['decode_tok_s']:.1f} tok/s (bf16 "
                f"{ref['decode_tok_s']:.1f})")
        launches[bits] = dict(counts)
        if bits == 8:
            # phase 21 (b)'s steady state: the first question again (K4's
            # plans, tensor maps and scratch were all made by the asks above)
            with steady_reading("int8_ask"):
                _no_degraded("int8 /ask, repeated", [qa_q.ask(QUESTIONS[0])])
        rec["asks"] = per_q
        summary[f"int{bits}"] = rec
        if bits == 8:
            engine8 = qgen
        del qa_q, qgen
    return summary, launches, engine8


def run_quant_pool(counts, qa, gen8, bf16_a1):
    """(c) round A1's shape (1 replica, 16 slots, 16 /ask, 64 new tokens)
    through a pool over the int8 engine: p50, answer tok/s, verify steps
    and device ms a verify step (the spine's ``serve_decode_chunk``), beside
    phase 6's bf16 round; K4 launches (7 L + 1) x the forwards the batcher
    dispatched (a tap on its prefill and decode forwards; warm-ups and
    canaries included)."""
    dev = gen8.device
    layers = gen8.cfg.num_layers
    encoder, store = qa.retriever.encoder, qa.retriever.store
    res_cfg = ResilienceConfig()
    calls = collections.Counter()
    prefill_fn, decode_fn = serve_mod.ragged_prefill_forward, serve_mod.paged_decode_forward

    def tap_prefill(*a, **kw):
        calls["prefill"] += 1
        return prefill_fn(*a, **kw)

    def tap_decode(*a, **kw):
        calls["decode"] += 1
        return decode_fn(*a, **kw)

    serve_mod.ragged_prefill_forward, serve_mod.paged_decode_forward = tap_prefill, tap_decode
    pool = None
    try:
        counts.clear()
        pool = EnginePool(gen8, cfg=PoolConfig(replicas=1, n_slots=16), qos=QoSConfig(),
                          chunk=16, cache_len=1024, device=dev)
        qa1 = QAService(encoder, store, gen8, k=3, device=dev, batcher=pool,
                        breakers=BreakerBoard(res_cfg.breaker_failure_threshold,
                                              res_cfg.breaker_reset_s),
                        resilience=res_cfg)
        spine = get_spine()
        spine.reset_stats()
        stats0 = pool.stats()
        t0 = time.perf_counter()
        res = _resolve_all(_submit_round(qa1, QUESTIONS * 4))
        wall = time.perf_counter() - t0
        if not pool.drain(0, timeout=120)["drained"]:
            raise AssertionError("the int8 pool did not drain")
        launches, steps = _quiescent(counts, pool.stats)
        steps.subtract(stats0)
        chunk = spine.stats()["stages"].get("serve_decode_chunk", {})
        forwards = calls["prefill"] + calls["decode"]
        all_steps = pool.stats()  # since the pool's construction, warm-ups included
    finally:
        serve_mod.ragged_prefill_forward, serve_mod.paged_decode_forward = prefill_fn, decode_fn
        if pool is not None:
            pool.stop()
    if calls["decode"] != (all_steps["verify_steps"] + all_steps["decode_steps"]
                           + all_steps["warmup_steps"]):
        raise AssertionError(f"decode forwards {calls['decode']} against the pool's steps "
                             f"{dict(all_steps)}")
    want = _k4_identity("int8 pool", launches, layers, forwards)
    rec = _round_record(res, wall)
    if rec["degraded"]:
        raise AssertionError(f"int8 pool round degraded: {rec['degraded']}")
    rec.update(verify_steps=steps["verify_steps"],
               device_ms_a_verify_step=chunk.get("device_s", 0.0) * 1e3 / max(
                   steps["verify_steps"], 1),
               forwards=forwards, prefill_forwards=calls["prefill"],
               decode_forwards=calls["decode"], k4_launches=want,
               bf16_A1={k: bf16_a1.get(k) for k in ("latency_p50_s", "tokens_per_s",
                                                    "verify_steps",
                                                    "device_ms_a_verify_step")})
    log(f"  int8 pool (1 replica x 16 slots): 16 /ask in {wall:.3f} s, p50 "
        f"{rec['latency_p50_s']:.3f} s (phase 6's bf16 A1 {bf16_a1['latency_p50_s']:.3f}), "
        f"{rec['tokens_per_s']:.1f} answer tok/s (bf16 {bf16_a1['tokens_per_s']:.1f}), "
        f"{rec['verify_steps']} verify steps (bf16 {bf16_a1['verify_steps']}), "
        f"{rec['device_ms_a_verify_step']:.2f} device ms a verify step (bf16 "
        f"{bf16_a1['device_ms_a_verify_step']:.2f}); K4 launches "
        f"{want} = ({QUANT_PROJECTIONS} x {layers} + 1) x {forwards} forwards "
        f"({calls['prefill']} prefill, {calls['decode']} decode, warm-ups included)")
    return rec, launches


def run_quant_runtime(counts, mistral_dir, tagger):
    """(d) ``DocQARuntime`` under the default config with phase 13's
    two-layer Mistral directory as ``decoder.checkpoint_dir`` and
    ``decoder.quantize_weights``, at ``quant_bits`` 8 then 4: the loaded tree
    equal, bit for bit, to ``quantize_decoder_params`` of the directly
    carried tree; the boot's peak memory above what was allocated; two
    uploads, then one /ask over HTTP answered and not degraded."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.models.hf_checkpoint import load_checkpoint_dir
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    dev = torch.device("cuda")
    contract = load_contract()
    summary, launches = {}, {}
    for bits in (8, 4):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_peak()
        base = torch.cuda.memory_allocated()
        cfg = load_config(env={}, overrides={
            "ner.params_path": tagger, "decoder.checkpoint_dir": mistral_dir,
            "decoder.quantize_weights": True, "decoder.quant_bits": bits,
            "resilience.request_deadline_s": APP_DEADLINE_S,
            "pool.canary_interval_s": 3600.0,
        })
        counts.clear()
        t0 = time.perf_counter()
        rt = DocQARuntime(cfg, device=dev).start()
        server = AppServer(make_app(rt)).start()
        boot_s = time.perf_counter() - t0
        try:
            peak = peak_allocated() - base
            _c, carried, _t = load_checkpoint_dir(mistral_dir, expect=DecoderConfig)
            want = quant.quantize_decoder_params(carried, bits, device=dev)
            del carried
            got = rt.generator.params
            if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"int{bits} runtime tree differs from "
                                     "quantize_decoder_params of the carried tree")
            del want
            http = _Http(server.port, contract)
            docs = app_notes(np.random.default_rng(41))[:2]
            ids = []
            for d in docs:
                body, ctype = _multipart(d["filename"], d["data"], d["fields"])
                ids.append(http.json("POST /ingest/", "/ingest/", body=body,
                                     ctype=ctype)["doc_id"])
            _wait_indexed(http, ids)
            if rt._warmup_thread is not None:
                rt._warmup_thread.join(timeout=300)
            t0 = time.perf_counter()
            out = http.json("POST /ask/", "/ask/", payload={"question": QUESTIONS[0]})
            ask_s = time.perf_counter() - t0
            if out.get("degraded") or not isinstance(out.get("answer"), str) or not out["sources"]:
                raise AssertionError(f"int{bits} runtime /ask: {out}")
            if not counts.get(f"qmatmul.int{bits}"):
                raise AssertionError(f"int{bits} runtime: K4 not launched {dict(counts)}")
        finally:
            if not server.close(timeout=30):
                raise AssertionError("the app server's threads did not end")
            rt.stop()
        launches[bits] = dict(counts)
        summary[f"int{bits}"] = {"boot_s": boot_s, "boot_peak_gib": peak / 2**30,
                                 "load_s": dict(rt.load_seconds), "ask_s": ask_s,
                                 "tree_equal": True, "uploads": len(ids)}
        log(f"  runtime, decoder.checkpoint_dir 2-layer Mistral, int{bits}: booted in "
            f"{boot_s:.1f} s, peak +{peak / 2**30:.2f} GiB, tree bit-equal to "
            f"quantize_decoder_params of the carried tree; /ask over HTTP {ask_s:.2f} s "
            f"(not degraded); K4 launches {counts.get('qmatmul', 0)}")
    return summary, launches


def run_quant_path(counts, qa, params, bf16_a1):
    """Phase 14 (a)-(c), while phase 3's weights are on the card; (d) runs
    with phase 13's directory (``run_quant_runtime``)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = run_qmatmul_cases(flush)
    del flush
    host = host_us_a_call()
    calibrated, calibrated_launches = check_reference_config(counts)
    solo, solo_launches, gen8 = run_quant_solo(counts, qa, params)
    pool, pool_launches = run_quant_pool(counts, qa, gen8, bf16_a1)
    del gen8
    gc.collect()
    torch.cuda.empty_cache()
    return {"cases": cases, "summary": {"solo": solo, "pool": pool, "host_us_a_call": host,
                                        "reference_config": calibrated},
            "launches": {"reference config": calibrated_launches,
                         "solo int8": solo_launches[8], "solo int4": solo_launches[4],
                         "pool int8": pool_launches}}


# ---- phase 20: Llama-3-8B at full width --------------------------------------

L3_NEW_TOKENS = 64  # phase 3's first question, greedy, K = 4
L3_PHASE_LIMIT_S = 90.0


def run_llama3_path(counts, qa):
    """Phase 20 (the module docstring): ``DecoderConfig.llama3_8b()`` drawn
    on the card in bf16 and quantised int8 there, a solo engine on each
    tree over phase 3's encoder and store answering phase 3's first
    question; first-step logits int8 against bf16; K1 and K4 launches held
    to their identities.  Both trees are freed before it returns."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = DecoderConfig.llama3_8b()
    enc_layers = qa.retriever.encoder.cfg.num_layers
    gen_cfg = GenerateConfig(max_new_tokens=L3_NEW_TOKENS, speculative_k=4)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_decoder_params(cfg, seed=3, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.values())
    t0 = time.perf_counter()
    qtree = quant.quantize_decoder_params(params, 8)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qcfg = dataclasses.replace(cfg, quantize_weights=True, quant_bits=8)
    engines = {"bf16": GenerateEngine(cfg, gen_cfg, params=params, device=dev),
               "int8": GenerateEngine(qcfg, gen_cfg, params=qtree, device=dev)}
    del params, qtree
    services = {mode: QAService(qa.retriever.encoder, qa.retriever.store, eng, k=3,
                                device=dev) for mode, eng in engines.items()}
    _prompt, ids = first_step_prompt(services["bf16"], QUESTIONS[0],
                                     1024 - 2 - gen_cfg.speculative_k)
    logits = {mode: solo_first_step(eng, ids) for mode, eng in engines.items()}
    for mode, lg in logits.items():
        if lg.shape != (cfg.vocab_size,) or not torch.isfinite(lg).all():
            raise AssertionError(f"phase 20 {mode}: first-step logits {tuple(lg.shape)}")
    ref, got = logits["bf16"], logits["int8"]
    rel_rms = float((got - ref).norm() / ref.norm())
    same_argmax = int(got.argmax()) == int(ref.argmax())
    summary = {"params_b": n_params / 1e9, "draw_s": draw_s, "quantise_s": quant_s,
               "first_step": {"int8_vs_bf16_rel_rms": rel_rms, "same_argmax": same_argmax,
                              "prompt_tokens": len(ids)}}
    # the main path: the counts from 0 just before the asks, read after
    counts.clear()
    for mode in ("bf16", "int8"):
        with peak_reading("llama_ask", on=mode == "bf16"):
            rec = _counted_ask(counts, services[mode], QUESTIONS[0], enc_layers,
                               k4=mode == "int8", where=f"phase 20 {mode} /ask")
        rec["tree_bytes"] = quant.tree_bytes(engines[mode].params)
        summary[mode] = rec
        log(f"  Llama-3-8B {mode}: tree {rec['tree_bytes'] / 1e9:.3f} GB, /ask "
            f"{rec['latency_s']:.3f} s, {rec['forwards']} forwards, "
            f"{rec['verify_step_ms']:.2f} ms a verify step, decode "
            f"{rec['decode_tok_s']:.1f} tok/s, K1 {rec['k1_launches']} launches "
            f"({enc_layers} + {rec['forwards']} x {cfg.num_layers}), K4 "
            f"{rec['k4_launches']}" + (f" (({QUANT_PROJECTIONS} x {cfg.num_layers} + 1) x "
                                       f"{rec['forwards']})" if mode == "int8" else ""))
    launches = dict(counts)
    del services, engines
    gc.collect()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    summary["phase_s"] = phase_s
    log(f"  Llama-3-8B: {n_params / 1e9:.3f} B params drawn in bf16 on the card in "
        f"{draw_s:.2f} s, quantised int8 in {quant_s:.2f} s; first-step logits int8 vs bf16 "
        f"relative RMS {rel_rms:.4f}, argmax {'kept' if same_argmax else 'differs'}")
    log(f"  phase 20 took {phase_s:.1f} s (limit {L3_PHASE_LIMIT_S:.0f} s)")
    if phase_s > L3_PHASE_LIMIT_S:
        raise AssertionError(f"phase 20 took {phase_s:.1f} s, over {L3_PHASE_LIMIT_S} s")
    return {"summary": summary, "launches": launches}


# ---- phase 15: the device plane on a mesh -----------------------------------

MESH_NEW_TOKENS = 64  # (a): phase 3's first question, greedy, K = 4
MESH_TOPK = 10  # (a): the sharded top-k over phase 3's store
MESH_SEQ = 4096  # (a): ring and Ulysses at 32 / 8 heads over this many tokens
MESH_TP = (1, 2, 4, 8)  # (b): one rank's shards at each model axis (1: the row beside)
MESH_ROWS = (4, 2048)  # (b): K4 at the solo verify's rows and at a packed prefill
MESH_PHASE_LIMIT_S = 90.0
# (b) the projections a rank serves, Mistral-7B: (name, in, out, split axis)
MESH_PROJECTIONS = (("wq", 4096, 4096, "out"), ("wk", 4096, 1024, "out"),
                    ("w_gate", 4096, 14336, "out"), ("lm_head", 4096, 32000, "out"),
                    ("wo", 4096, 4096, "in"), ("w_down", 14336, 4096, "in"))
# one decode step's products, 225 at Mistral-7B: per layer wq, wk, wv
# (= wk's shape), wo, w_gate, w_up (= w_gate's), w_down; then lm_head
MESH_STEP_PRODUCTS = {"wq": 32, "wk": 64, "wo": 32, "w_gate": 64, "w_down": 32,
                      "lm_head": 1}


def _rank0_of(n):
    """Model rank 0's place on a (1, n) mesh, with no process group: the
    shard shapes of one rank, sliced by the port's own sharding rule."""
    return mesh_mod.MeshContext(None, "data", "model", 1, n, 0, 0, torch.device("cuda"))


def _same_ids_tie_rule(vals, ids, want_vals, want_ids, where):
    """Equal scores, and equal ids among rows scoring clear of the k-th
    score (a row tied with the k-th score is not a miss)."""
    if not torch.equal(vals, want_vals):
        raise AssertionError(f"{where}: top-k scores differ")
    cut = want_vals[:, -1:]
    for row in range(ids.shape[0]):
        a = set(ids[row][vals[row] > cut[row]].tolist())
        b = set(want_ids[row][want_vals[row] > cut[row]].tolist())
        if a != b:
            raise AssertionError(f"{where}: top-k ids differ in row {row}")


def run_mesh_world(counts, qa, params, workdir):
    """(a) a world of one rank over NCCL: the (1, 1) mesh's engine over
    phase 3's tree (the same storage), phase 3's first question against
    the unsharded engine, a direct NCCL all-reduce and all-gather, the
    sharded top-k over phase 3's store, Ulysses (on K1) and ring attention
    at 4,096 tokens.  Returns (summary, launches by run)."""
    dev = torch.device("cuda")
    if not mesh_mod.multihost_init(f"file://{workdir}/nccl_init", 1, 0, local_rank=0,
                                   device="cuda"):
        raise AssertionError("multihost_init did not start the world")
    import torch.distributed as dist

    mesh = mesh_mod.make_mesh(MeshConfig(), device="cuda")
    if (mesh.n_data, mesh.n_model, dist.get_backend()) != (1, 1, "nccl"):
        raise AssertionError(f"mesh {mesh.n_data}x{mesh.n_model} over {dist.get_backend()}")
    nccl = ".".join(str(v) for v in torch.cuda.nccl.version())
    # NCCL itself, outside the port's wrappers (a group of one rank issues
    # none through them)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    torch.cuda.synchronize()
    if not (torch.equal(y, x) and torch.equal(parts[0], x)):
        raise AssertionError("NCCL all_reduce / all_gather over one rank changed the data")
    log(f"  world of 1 rank over NCCL {nccl}: mesh {mesh.n_data}x{mesh.n_model} on "
        f"{mesh.device}; all_reduce and all_gather round-trip")

    solo_gen = qa.generator
    eng = GenerateEngine(solo_gen.cfg, solo_gen.gen, params=params, mesh=mesh)
    shared = all(eng.params[k].data_ptr() == params[k].data_ptr() for k in params)
    if not shared or set(eng.params) != set(params):
        raise AssertionError("the 1x1 mesh engine copied phase 3's tree")
    _prompt, ids = first_step_prompt(qa, QUESTIONS[0], solo_gen.gen.prefill_buckets[-1])
    counts.clear()
    want = solo_gen.generate_ids([ids], MESH_NEW_TOKENS)[0]
    solo_k1 = counts["flash_attention"]
    counts.clear()
    mesh_mod.COLLECTIVES.clear()
    t0 = time.perf_counter()
    got = eng.generate_ids([ids], MESH_NEW_TOKENS)[0]
    mesh_s = time.perf_counter() - t0
    launches = {"15 mesh": dict(counts)}
    collectives = dict(mesh_mod.COLLECTIVES)
    if got != want:
        raise AssertionError(f"the 1x1 mesh engine's tokens differ from phase 3's: "
                             f"{got[:8]}... against {want[:8]}...")
    if counts["flash_attention"] != solo_k1 or collectives:
        raise AssertionError(f"mesh engine: K1 {counts['flash_attention']} launches against "
                             f"phase 3's {solo_k1}; collectives {collectives}")
    log(f"  1x1 mesh engine: {len(got)} tokens equal phase 3's bit for bit in "
        f"{mesh_s:.2f} s, K1 {solo_k1} launches on both, 0 collectives, weights shared")

    # the sharded top-k over the 1M-row store's scores
    buf, count = qa.store.device_view()
    emb = qa.retriever.encoder.encode_texts([QUESTIONS[0]])
    with torch.inference_mode():
        q = torch.from_numpy(emb).to(dev).to(buf.dtype).float()
        scores = torch.cat([q @ buf[s:min(s + (1 << 18), count)].float().T
                            for s in range(0, count, 1 << 18)], dim=1)
        vals, top = ttopk.sharded_topk(scores, 0, MESH_TOPK, mesh.model_group)
        want_vals, want_top = torch.topk(scores, MESH_TOPK, dim=-1)
    _same_ids_tie_rule(vals, top, want_vals, want_top, "sharded_topk")
    log(f"  sharded_topk over {count} rows: ids equal torch.topk's (tie rule)")

    # Ulysses (K1 on the local heads) and ring attention at 4,096 tokens
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    q, k, v = (torch.randn((1, MESH_SEQ, h, 128), generator=gen, device=dev
                           ).to(torch.bfloat16) for h in (32, 8, 8))
    lengths = torch.tensor([MESH_SEQ], dtype=torch.int32, device=dev)
    atol, rtol = TOL[torch.bfloat16]
    seq = {}
    with torch.inference_mode():
        plain = attn.attention_reference(q, k, v, causal=True, lengths=lengths,
                                         q_offset=torch.zeros_like(lengths)).float()
        for name, fn in (("ulysses", ulysses_attention), ("ring", ring_attention)):
            counts.clear()
            mesh_mod.COLLECTIVES.clear()
            out = fn(q, k, v, mesh, causal=True, lengths=lengths)
            torch.cuda.synchronize()
            launches[f"15 {name}"] = dict(counts)
            err = (out.float() - plain).abs()
            if not bool((err <= atol + rtol * plain.abs()).all()):
                raise AssertionError(f"{name} attention: max |err| {float(err.max()):.3e}")
            if mesh_mod.COLLECTIVES:
                raise AssertionError(f"{name}: collectives at 1x1 {dict(mesh_mod.COLLECTIVES)}")
            seq[name] = {"max_abs_err": float(err.max()), "k1_launches": counts["flash_attention"]}
        del plain
    if seq["ulysses"]["k1_launches"] != 1 or seq["ring"]["k1_launches"] != 0:
        raise AssertionError(f"K1 launches: Ulysses {seq['ulysses']['k1_launches']} (want 1), "
                             f"ring {seq['ring']['k1_launches']} (plain PyTorch, want 0)")
    log(f"  Ulysses (K1) and ring at 32/8 heads x {MESH_SEQ} tokens within "
        f"{atol} + {rtol}|plain|: max |err| {seq['ulysses']['max_abs_err']:.2e}, "
        f"{seq['ring']['max_abs_err']:.2e}")
    # the world stays up for phase 16 (one process group a process)
    return {"nccl": nccl, "tokens": len(got), "engine_s": mesh_s, "k1_launches": solo_k1,
            "collectives": collectives, "weights_shared": shared,
            "topk_rows": count, "sequence": seq}, launches


def _mesh_k1_case(n, case, flush):
    """K1 at one rank's heads (32/n q, 8/n kv) of a phase 2 case."""
    dev = torch.device("cuda")
    hq, hkv = 32 // n, 8 // n
    b, sq, skv, d = case["b"], case["sq"], case["skv"], case["d"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(150 + n)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    lengths = torch.tensor(case["lengths"], dtype=torch.int32, device=dev)
    q_offset = torch.tensor(case["q_offset"], dtype=torch.int32, device=dev)
    kw = dict(causal=True, lengths=lengths, q_offset=q_offset, sliding_window=case["window"])
    got = attn.flash_attention(q, k, v, **kw)
    want = attn.attention_reference(q, k, v, **kw).float()
    err = (got.float() - want).abs()
    atol, rtol = TOL[torch.bfloat16]
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"K1 {case['name']} at TP {n}: max |err| {float(err.max()):.3e}")
    ms = time_ms(lambda: attn.flash_attention(q, k, v, **kw), flush)
    mask = attn.live_mask(b, sq, skv, lengths, q_offset, True, case["window"], dev)
    live_pairs, live_kv = int(mask.sum()), int(mask.any(dim=1).sum())
    t_bytes = ((2 * b * sq * hq * d + 2 * live_kv * hkv * d) * 2 + 8 * b) / PEAK_BYTES_S * 1e3
    t_flops = 4 * d * hq * live_pairs / PEAK_BF16_FLOPS * 1e3
    plan = attn.plan_flash(torch.bfloat16, b, sq, skv, hq, hkv,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    return {"case": f"k1_{case['name']}_tp{n}", "tp": n, "kernel": "flash_attention",
            "shape": f"b{b} sq{sq} skv{skv} hq{hq} hkv{hkv} d{d}", "plan": plan._asdict(),
            "path": plan.path, "max_abs_err": float(err.max()), "ms": ms,
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def _mesh_k4_case(n, name, mode, m, q, sc, flush, gen):
    """K4 at one rank's store ``q``, ``sc`` (a shard) and ``m`` rows."""
    k = q.shape[0] if q.dim() == 2 else sc.shape[0] * (2 * q.shape[1])
    out = q.shape[-1]
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    got = qm.qmatmul(x, q, sc)
    want = qm.qmatmul_reference(x, q, sc).float()
    err = (got.float() - want).abs()
    atol, rtol = TOL[torch.bfloat16]
    if not bool((err <= atol + rtol * want.abs()).all()) or not torch.isfinite(got).all():
        raise AssertionError(f"K4 {name} {mode} m{m} at TP {n}: max |err| "
                             f"{float(err.max()):.3e}")
    plan = getattr(q, qm._STORE).plan(m)
    ms = time_ms(lambda: qm.qmatmul(x, q, sc), flush)
    nbytes = q.numel() + 4 * sc.numel() + 2 * m * k + 2 * m * out
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = 2 * m * k * out / PEAK_BF16_FLOPS * 1e3
    return {"case": f"{name}_m{m}_{mode}_tp{n}", "tp": n, "weight": name, "mode": mode,
            "m": m, "shape": f"m{m} in{k} out{out}", "kernel": plan.kernel,
            "splits": plan.splits, "grid": plan.grid, "max_abs_err": float(err.max()),
            "ms": ms, "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def run_mesh_shards(counts):
    """(b) one rank's work at TP 1, 2, 4 and 8 of Mistral-7B: K1's verify
    (K = 4, 233 live) and 256-token prefill at 32/n q and 8/n kv heads, and
    K4 int8 and int4 at 4 and 2,048 rows on the column shards (wq, wk,
    w_gate, lm_head int8) and the row shards (wo, w_down, int4 on whole
    groups), each sliced by ``parallel/sharding.py`` from a full weight
    quantised on the card, held to its plain version and timed; then the
    sum of one rank's 225 products a step at m = 4.  One rank's work only:
    no collective time.  Returns (cases, step sums, launches)."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1515)
    by_name = {c["name"]: c for c in kernel_cases()}
    counts.clear()
    cases = []
    for n in MESH_TP:
        for name in ("mistral_verify", "mistral_prefill"):
            rec = _mesh_k1_case(n, by_name[name], flush)
            cases.append(rec)
            log(f"  K1 {rec['case']:26s} {rec['shape']:30s} {rec['path']:7s} splits "
                f"{rec['plan']['num_splits']}  err {rec['max_abs_err']:.2e}  "
                f"{rec['ms']:.4f} ms  bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    for name, k, out, axis in MESH_PROJECTIONS:
        w = torch.randn((k, out), generator=gen, device=dev) * k ** -0.5
        packs = [("int8", *quant.quantize_array(w))]
        if name != "lm_head":
            packs.append(("int4", *quant.quantize_array_int4(w)))
        del w
        spec = "lm_head" if name == "lm_head" else f"l0_{name}"
        for mode, q_full, sc_full in packs:
            for n in MESH_TP:
                mesh = _rank0_of(n)
                specs = shard_mod.decoder_param_pspecs(DecoderConfig.mistral_7b(), "model")
                q = shard_mod.shard_leaf(q_full, shard_mod.spec_for(spec, q_full, specs, n), mesh)
                sc = shard_mod.shard_leaf(sc_full, shard_mod.spec_for(
                    spec + quant.SCALE_SUFFIX, sc_full, specs, n), mesh)
                for m in MESH_ROWS:
                    rec = _mesh_k4_case(n, name, mode, m, q, sc, flush, gen)
                    cases.append(rec)
                    log(f"  K4 {rec['case']:26s} {rec['shape']:22s} {rec['kernel']:6s} "
                        f"splits {rec['splits']:2d} grid {rec['grid']:4d}  err "
                        f"{rec['max_abs_err']:.2e}  {rec['ms']:.4f} ms  bound "
                        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}, "
                        f"{100 * rec['bound_ms'] / rec['ms']:.1f} %)")
                del q, sc
        del packs
    launches = dict(counts)
    del flush
    step = {}
    for mode in ("int8", "int4"):
        for n in MESH_TP:
            total = 0.0
            for name, times in MESH_STEP_PRODUCTS.items():
                leaf_mode = "int8" if name == "lm_head" else mode
                rec = next(c for c in cases if c.get("weight") == name and c["m"] == 4
                           and c["mode"] == leaf_mode and c["tp"] == n)
                total += times * rec["ms"]
            step[f"{mode}_tp{n}"] = total
        log(f"  one rank's 225 products a step at m = 4, {mode}: " + ", ".join(
            f"TP {n} {step[f'{mode}_tp{n}']:.3f} ms" for n in MESH_TP))
    return cases, step, launches


def run_mesh_path(counts, qa, params, workdir):
    """Phase 15, while phase 3's weights are on the card; the world of one
    rank it starts (its file store under ``workdir``) stays up."""
    t0 = time.perf_counter()
    world, launches = run_mesh_world(counts, qa, params, workdir)
    cases, step, shard_launches = run_mesh_shards(counts)
    launches["15 shards"] = shard_launches
    phase_s = time.perf_counter() - t0
    log(f"  phase 15 took {phase_s:.1f} s (limit {MESH_PHASE_LIMIT_S:.0f} s)")
    if phase_s > MESH_PHASE_LIMIT_S:
        raise AssertionError(f"phase 15 took {phase_s:.1f} s, over {MESH_PHASE_LIMIT_S} s")
    return {"summary": {**world, "step_m4_ms": step, "phase_s": phase_s},
            "cases": cases, "launches": launches}



# ---- phase 16: the runtime on a mesh ---------------------------------------

MRT_NOTES = 8  # (a): phase 9's notes ingested over HTTP
MRT_ASKS = 4  # (a): asked one at a time, then at once
MRT_STAGES = {"serve_prefill_fetch": "prefill_round", "serve_decode_chunk": "decode_chunk",
              "retrieve": "search_texts"}  # (a): the mirrored spine items and their commands
LEX_SHARDS = (2, 4, 8)  # (c): row shards of the lexical program
MESH_RT_PHASE_LIMIT_S = 120.0


def run_mesh_runtime(counts, qa, tagger, app_p50_s):
    """(a) ``DocQARuntime`` under the default config in the world of one
    NCCL rank phase 15 started: the (1, 1) mesh and the leader's command
    stream (commands counted and published to no one) over phase 3's tree
    as phase 9 passes it.  Ingests phase 9's first notes over HTTP, asks 4
    generative questions one at a time, then 4 at once; the first one's
    first-step logits against the solo engine.  Returns (summary,
    launches)."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.engines.router import AnswerRouter
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    gc.collect()
    torch.cuda.empty_cache()
    dev = qa.generator.device
    cfg = dataclasses.replace(
        load_config(env={}, overrides={
            "ner.params_path": tagger,
            "resilience.request_deadline_s": APP_DEADLINE_S,
        }),
        decoder=qa.generator.cfg,
    )
    t0 = time.perf_counter()
    rt = DocQARuntime(cfg, device=dev, decoder_params=qa.generator.params).start()
    server = AppServer(make_app(rt)).start()
    boot_s = time.perf_counter() - t0
    if rt.mesh is None or rt.stream is None or (rt.mesh.n_data, rt.mesh.n_model) != (1, 1):
        raise AssertionError("the runtime built no (1, 1) mesh in the world of one rank")
    shared = all(rt.generator.params[k].data_ptr() == qa.generator.params[k].data_ptr()
                 for k in qa.generator.params)
    if not shared:
        raise AssertionError("the mesh runtime copied phase 3's tree")
    _lookups, generative = routing_lookups(AnswerRouter(), deid=rt.deid)
    http = _Http(server.port, load_contract())
    summary = {"boot_s": boot_s, "weights_shared": shared}
    log(f"  runtime on the (1, 1) mesh booted in {boot_s:.1f} s; serving on "
        f"127.0.0.1:{server.port}")
    try:
        docs = app_notes(np.random.default_rng(21))[:MRT_NOTES]
        ids = []
        for d in docs:
            body, ctype = _multipart(d["filename"], d["data"], d["fields"])
            ids.append(http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"])
        _wait_indexed(http, ids)
        ingest_commands = dict(mesh_mod.COMMANDS)
        for name in ("encoder.encode_texts", "store.add"):
            if not ingest_commands.get(name):
                raise AssertionError(f"ingest published no {name}: {ingest_commands}")

        # the main path: every count from 0 just before it, read just after
        get_spine().reset_stats()
        rt.stream.reset_stats()
        mesh_mod.reset_commands()
        mesh_mod.COLLECTIVES.clear()
        counts.clear()
        lat_one, outs = [], []
        with _Capture(rt.qa) as cap:
            for i, q in enumerate(generative[:MRT_ASKS]):
                # the first answer's prefill lanes only (a warm-up's 3-token
                # lane may ride beside it)
                lanes, untap = _tap_prefill() if i == 0 else ([], lambda: None)
                t = time.perf_counter()
                try:
                    outs.append(http.json("POST /ask/", "/ask/", payload={"question": q}))
                finally:
                    untap()
                lat_one.append(time.perf_counter() - t)
                if i == 0:
                    first = max(lanes, key=lambda lane: len(lane[0]))
        tokens = cap.pending[0].handle.result(timeout=60)
        results = [None] * MRT_ASKS

        def ask(i, q):
            t = time.perf_counter()
            results[i] = (http.json("POST /ask/", "/ask/", payload={"question": q}),
                          time.perf_counter() - t)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i, q))
                   for i, q in enumerate(generative[MRT_ASKS:2 * MRT_ASKS])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=APP_HTTP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        # the pipelined worker may still be issuing (and counting) a chunk
        # after the last answer: read once the counts stand still
        launches, (commands, collectives, _items) = _quiescent(counts, lambda: (
            dict(mesh_mod.COMMANDS), dict(mesh_mod.COLLECTIVES),
            {k: v.get("count", 0) for k, v in get_spine().stats()["stages"].items()}))
        stages = get_spine().stats()["stages"]
        if any(r is None for r in results):
            raise AssertionError("a concurrent /ask on the mesh runtime did not answer")
        outs += [r[0] for r in results]
        _no_degraded("mesh runtime /ask", outs)
        summary["first_step"] = check_first_step(
            "mesh runtime over HTTP", solo_first_step(qa.generator, first[0]), first[1],
            tokens[0], len(first[0]))
        if collectives:
            raise AssertionError(f"collectives in a world of one rank: {collectives}")
        # every mirrored spine item ran inside a published command
        published = {}
        for stage, method in MRT_STAGES.items():
            items = int(stages.get(stage, {}).get("count", 0))
            cmds = sum(n for name, n in commands.items() if name.endswith("." + method))
            published[stage] = {"spine_items": items, "commands": cmds}
            if items == 0 or items != cmds:
                raise AssertionError(f"{stage}: {items} spine items against {cmds} "
                                     f"{method} commands: {commands}")
        for key in ("flash_attention.decode_paged", "flash_attention.prefill"):
            if not launches.get(key):
                raise AssertionError(f"the mesh runtime launched no {key}: {launches}")
        n_tok = sum(len(_tokens(o["answer"])) for o in outs)
        lat_all = [r[1] for r in results]
        # the mesh section is the port's own (a process group up): the rest of
        # the surface is held to the reference's contract
        code, _h, raw = http.raw("GET", "/api/status")
        body = json.loads(raw)
        status = body.pop("mesh", None)
        contract_check(http.contract, "GET /api/status", code, body)
        if not status or status["shape"] != [1, 1] or status["ranks"] != 1:
            raise AssertionError(f"/api/status has no (1, 1) mesh section: {status}")
        summary.update({
            "commands": commands, "ingest_commands": ingest_commands,
            "published": published, "collectives": collectives,
            "k1_decode_paged": launches.get("flash_attention.decode_paged", 0),
            "k1_prefill": launches.get("flash_attention.prefill", 0),
            "ask_one_p50_s": _pctl(lat_one, 0.5), "ask_at_once_p50_s": _pctl(lat_all, 0.5),
            "ask_at_once_wall_s": wall, "answer_tokens": n_tok,
            "phase9_ask_p50_s": app_p50_s,
            "slot_wait_ms": {k: v["slot_wait_mean_ms"] for k, v in status["commands"].items()},
            "spine_wait_ms": {k: v["queue_wait_mean_ms"] for k, v in stages.items()},
        })
        log(f"  commands: {commands}; collectives {collectives or 0}")
        log(f"  mirrored spine items published: " + ", ".join(
            f"{k} {v['spine_items']} = {v['commands']}" for k, v in published.items()))
        log(f"  K1 decode_paged {summary['k1_decode_paged']}, prefill {summary['k1_prefill']} "
            f"launches through the runtime; {launches}")
        log(f"  /ask p50 one at a time {summary['ask_one_p50_s']:.2f} s, {MRT_ASKS} at once "
            f"{summary['ask_at_once_p50_s']:.2f} s (phase 9, 8 at once without a process "
            f"group: {app_p50_s:.2f} s); mesh slot waits {summary['slot_wait_ms']}")
    finally:
        if not server.close(timeout=30):
            raise AssertionError("the mesh runtime's server threads did not end")
        rt.stop()
    return summary, launches


def run_paged_shards():
    """(b) K1's paged mode at one rank's heads: the table's two paged rows
    (8 lanes NB 64; 16 lanes with 8 idle) at TP 1, 2, 4 and 8 (32/n q and
    8/n kv heads, as ``_rank0_of`` slices them), each held to its plain
    version and timed beside masked SDPA.  Returns the records."""
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = []
    for case in paged_cases():
        if case["name"] == "mistral_paged_verify_4k":
            continue
        for n in MESH_TP:
            shard = dict(case, name=f"{case['name']}_tp{n}", hq=case["hq"] // n,
                         hkv=case["hkv"] // n)
            gen = torch.Generator(device=dev)
            gen.manual_seed(4321 + n)
            rec = paged_case(shard, flush, gen, np.random.default_rng(4321 + n),
                             library_only=True)
            rec["tp"] = n
            out.append(rec)
    del flush
    return out


def run_lexical_shards():
    """(c) the sharded lexical program on the one card: ``LEX_ROWS`` rows of
    32-slot tiles and 1 query x 8 terms (phase 12's case), split into n =
    2, 4 and 8 row shards of whole 64-row buckets; each shard's local
    program (``lexical_search_program`` under a group-less mesh context of
    its model index) run in turn and merged with ``ops/topk.merge_topk``.
    Ids and scores equal the unsharded search's (tie rule)."""
    from docqa_tpu_torch.index.lexical import _ROW_BUCKET, lexical_search_program

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    width, vocab, terms = 32, 1 << 17, 8
    term_ids = torch.randint(0, vocab, (LEX_ROWS, width), generator=gen, device=dev,
                             dtype=torch.int32)
    impacts = torch.randint(1, 128, (LEX_ROWS, width), generator=gen, device=dev,
                            dtype=torch.int8)
    live = torch.ones(LEX_ROWS, dtype=torch.bool, device=dev)
    q_terms = term_ids[:1, :terms].clone()
    q_weights = torch.rand((1, terms), generator=gen, device=dev)
    out = {}
    with torch.inference_mode():
        want_vals, want_ids = lexical_search_program(term_ids, impacts, live, q_terms,
                                                     q_weights, TIER_K)
        whole_ms = time_ms(lambda: lexical_search_program(
            term_ids, impacts, live, q_terms, q_weights, TIER_K), flush,
            reps=5, warmup=1, spin_cycles=40_000_000)
        out["whole_ms"] = whole_ms
        for n in LEX_SHARDS:
            chunk = _ROW_BUCKET * n
            per = -(-LEX_ROWS // chunk) * chunk // n
            pad = per * n - LEX_ROWS
            tid = torch.nn.functional.pad(term_ids, (0, 0, 0, pad), value=-1)
            imp = torch.nn.functional.pad(impacts, (0, 0, 0, pad))
            liv = torch.nn.functional.pad(live, (0, pad))
            parts, shard_ms = [], []
            for m in range(n):
                ctx = mesh_mod.MeshContext(None, "data", "model", 1, n, 0, m, dev)
                block = [t[m * per:(m + 1) * per] for t in (tid, imp, liv)]
                parts.append(lexical_search_program(*block, q_terms, q_weights, TIER_K, ctx))
                shard_ms.append(time_ms(lambda: lexical_search_program(
                    *block, q_terms, q_weights, TIER_K, ctx), flush, reps=5, warmup=1,
                    spin_cycles=40_000_000))
            vals, ids = ttopk.merge_topk(torch.stack([p[0] for p in parts]),
                                         torch.stack([p[1] for p in parts]), TIER_K)
            _same_ids_tie_rule(vals, ids, want_vals, want_ids, f"lexical over {n} shards")
            out[f"shards{n}"] = {"rows_a_shard": per, "shard_ms": shard_ms,
                                 "sum_ms": sum(shard_ms), "max_ms": max(shard_ms)}
            log(f"  lexical over {n} row shards of {per}: ids and scores equal the whole "
                f"search's; a shard {min(shard_ms):.3f}-{max(shard_ms):.3f} ms "
                f"(the whole {whole_ms:.3f} ms here)")
    del flush, term_ids, impacts
    return out


def run_mesh_runtime_path(counts, qa, tagger, app_p50_s):
    """Phase 16, in phase 15's world of one rank."""
    t0 = time.perf_counter()
    runtime, launches = run_mesh_runtime(counts, qa, tagger, app_p50_s)
    paged = run_paged_shards()
    for rec in paged:
        log(f"  K1 {rec['case']:30s} {rec['shape']:38s} {rec['plan']['num_splits']} splits  "
            f"err {rec['max_abs_err_bf16']:.2e}  {rec['ms']:.4f} ms  plain "
            f"{rec['plain_ms']:.4f} ms  gather+sdpa {rec['library_ms']:.4f} ms  bound "
            f"{rec['bound_ms']:.5f} ms ({100 * rec['bound_share']:.1f} %)")
    lexical = run_lexical_shards()
    phase_s = time.perf_counter() - t0
    log(f"  phase 16 took {phase_s:.1f} s (limit {MESH_RT_PHASE_LIMIT_S:.0f} s)")
    if phase_s > MESH_RT_PHASE_LIMIT_S:
        raise AssertionError(f"phase 16 took {phase_s:.1f} s, over {MESH_RT_PHASE_LIMIT_S} s")
    return {"summary": {"runtime": runtime, "lexical": lexical, "phase_s": phase_s},
            "paged": paged, "launches": {"16 runtime": launches}}


# ---- phase 17: tiered retrieval on a mesh ---------------------------------

MTR_FILLER = 200_000  # (a): random rows the background rebuild covers under load
MTR_ASKS = 4  # (a): questions asked while it runs
IVF_SHARDS = (2, 4, 8)  # (b): cell shards of phase 12's tier
IVF_SHARD_QUERIES = 16  # (b)
IVF_SHARD_NPROBE = 8  # (b)
MESH_TIER_PHASE_LIMIT_S = 120.0


def _doc_indexed(sources, doc_ids):
    """Sources with each document id replaced by its upload index."""
    text = json.dumps(sources)
    for i, d in enumerate(doc_ids):
        text = text.replace(d, f"DOC{i}")
    return json.loads(text)


def run_mesh_tiered_runtime(counts, qa, tagger, phase12_app):
    """(a) ``DocQARuntime`` under phase 9's config with
    ``store.serving_index="tiered"`` (phase 12 (e)'s cuts) in phase 15's
    world of one NCCL rank: the (1, 1) mesh, the leader's command stream,
    phase 3's tree.  Phase 12 (e)'s asks (dense before the tier, hybrid
    after it, dense over it), with every count from 0 around them: sources
    equal phase 12 (e)'s (upload indexes, in order), the tier built and
    switched by commands, every mirrored spine
    item one published command, 0 collectives, each retrieval's encoder on
    K1 ``prefill``.  Then ``MTR_FILLER`` random rows and ``MTR_ASKS``
    questions while the background rebuild covers them: none degraded, the
    commands' slot waits in that window.  Returns (summary, launches)."""
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.index.tiered import TieredIndex
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    gc.collect()
    torch.cuda.empty_cache()
    dev = qa.generator.device
    cfg = dataclasses.replace(
        load_config(env={}, overrides={
            "ner.params_path": tagger,
            "resilience.request_deadline_s": APP_DEADLINE_S,
            "store.serving_index": "tiered", "store.ivf_min_rows": 32,
            "generate.max_new_tokens": 64,
        }),
        decoder=qa.generator.cfg,
    )
    t0 = time.perf_counter()
    rt = DocQARuntime(cfg, device=dev, decoder_params=qa.generator.params).start()
    server = AppServer(make_app(rt)).start()
    boot_s = time.perf_counter() - t0
    tiered = rt.search_index
    if (rt.mesh is None or (rt.mesh.n_data, rt.mesh.n_model) != (1, 1)
            or not isinstance(tiered, TieredIndex) or tiered._stream() is not rt.stream):
        raise AssertionError("the tiered runtime built no (1, 1) mesh with its tier a "
                             "command target")
    http = _Http(server.port, load_contract())
    enc_layers = rt.encoder.cfg.num_layers
    retr = rt.qa.retriever
    per_retrieval = []
    real_search = retr._search_texts

    def counted_search(*a, **kw):
        before = counts["flash_attention.prefill"]
        out = real_search(*a, **kw)
        per_retrieval.append(counts["flash_attention.prefill"] - before)
        return out

    retr._search_texts = counted_search
    summary = {"boot_s": boot_s}
    try:
        docs = app_notes(np.random.default_rng(21))
        ids = []
        for d in docs:
            body, ctype = _multipart(d["filename"], d["data"], d["fields"])
            ids.append(http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"])
        _wait_indexed(http, ids)
        get_spine().reset_stats()
        rt.stream.reset_stats()
        mesh_mod.reset_commands()
        mesh_mod.COLLECTIVES.clear()
        counts.clear()
        per_retrieval.clear()
        asks = {}
        deadline = time.perf_counter() + 120
        for mode, question in (("dense", QUESTIONS[1]), ("hybrid", QUESTIONS[1]),
                               ("over_tier", QUESTIONS[2])):
            tiered.default_mode = "hybrid" if mode == "hybrid" else "dense"
            out = http.json("POST /ask/", "/ask/", payload={"question": question})
            asks[mode] = {"sources": out["sources"], "degraded": bool(out.get("degraded"))}
            if out.get("degraded") or not out["answer"].strip():
                raise AssertionError(f"tiered mesh runtime /ask ({mode}) degraded: {out}")
            while tiered.covered == 0 and time.perf_counter() < deadline:
                time.sleep(0.05)  # the first ask started the tier's build
        tiered.default_mode = "dense"
        launches, (commands, collectives) = _quiescent(counts, lambda: (
            dict(mesh_mod.COMMANDS), dict(mesh_mod.COLLECTIVES)))
        stages = get_spine().stats()["stages"]
        if tiered.covered != rt.store.count or tiered.tier_generation != 1:
            raise AssertionError(f"the tier covers {tiered.covered} of {rt.store.count} rows, "
                                 f"generation {tiered.tier_generation}")
        if commands.get("tiered.stage") != 1 or commands.get("tiered.switch") != 1:
            raise AssertionError(f"the tier was not built and switched by commands: {commands}")
        if collectives:
            raise AssertionError(f"collectives in a world of one rank: {collectives}")
        published = {}
        for stage, method in MRT_STAGES.items():
            items = int(stages.get(stage, {}).get("count", 0))
            cmds = sum(n for name, n in commands.items() if name.endswith("." + method))
            published[stage] = {"spine_items": items, "commands": cmds}
            if items == 0 or items != cmds:
                raise AssertionError(f"{stage}: {items} spine items against {cmds} "
                                     f"{method} commands: {commands}")
        if len(per_retrieval) != 3 or min(per_retrieval) < enc_layers:
            raise AssertionError(f"K1 prefill launches a retrieval {per_retrieval}, want at "
                                 f"least {enc_layers} (the encoder's layers) each")
        # phase 12 (e)'s sources, by upload index and in order: the same
        # tier over the same rows on the same card (the answers carry no
        # scores, so no tie can be told from a wrong ranking)
        ref = phase12_app["asks"]
        for mode in ("dense", "hybrid"):
            got = _doc_indexed(asks[mode]["sources"], ids)
            want = _doc_indexed(ref[mode]["sources"], phase12_app["doc_ids"])
            if got != want:
                raise AssertionError(f"{mode} sources {got} differ from phase 12 (e)'s {want}")
        summary.update({"asks": asks, "commands": commands,
                        "published": published, "collectives": collectives,
                        "k1_prefill_a_retrieval": list(per_retrieval),
                        "k1_decode_paged": launches.get("flash_attention.decode_paged", 0),
                        "rows": rt.store.count})
        log(f"  tiered runtime on the (1, 1) mesh booted in {boot_s:.1f} s; {rt.store.count} "
            f"rows; /ask dense (exact, before the tier), hybrid and dense over the tier, none "
            f"degraded; sources equal phase 12 (e)'s")
        log(f"  commands: {commands}; collectives {collectives or 0}; K1 prefill a "
            f"retrieval {per_retrieval} ({enc_layers} encoder layers)")

        # the background rebuild under load
        rng = np.random.default_rng(17)
        filler = rng.standard_normal((MTR_FILLER, rt.store.cfg.dim), dtype=np.float32)
        t0 = time.perf_counter()
        rt.store.add(filler, [{"source": f"filler-{i:06d}"} for i in range(MTR_FILLER)])
        add_s = time.perf_counter() - t0
        tiered.rebuild_tail_rows = MTR_FILLER
        rt.stream.reset_stats()
        mesh_mod.reset_commands()
        counts.clear()
        during, lat = [], []
        t0 = time.perf_counter()
        for i in range(MTR_ASKS):
            t = time.perf_counter()
            out = http.json("POST /ask/", "/ask/",
                            payload={"question": QUESTIONS[i % len(QUESTIONS)]})
            lat.append(time.perf_counter() - t)
            during.append(bool(tiered._rebuilding))
            if out.get("degraded"):
                raise AssertionError(f"an /ask during the rebuild degraded: {out}")
        tiered.close(timeout=300)
        rebuild_wall = time.perf_counter() - t0
        status = rt.stream.status()["commands"]
        commands = dict(mesh_mod.COMMANDS)
        if tiered.covered != rt.store.count or tiered.tier_generation != 2:
            raise AssertionError(f"the background rebuild left the tier at {tiered.covered} of "
                                 f"{rt.store.count} rows, generation {tiered.tier_generation}")
        if commands.get("tiered.stage") != 1 or commands.get("tiered.switch") != 1:
            raise AssertionError(f"the background rebuild's commands: {commands}")
        ivf = tiered._tier[0]
        summary["rebuild"] = {
            "rows": rt.store.count, "filler_add_s": add_s, "asks": MTR_ASKS,
            "asks_during": sum(during), "ask_s": lat, "wall_s": rebuild_wall,
            "build_seconds": ivf.build_seconds, "index_bytes": ivf.index_bytes(),
            "slot_wait_ms": {k: {"count": v["count"], "mean": v["slot_wait_mean_ms"],
                                 "max": v["slot_wait_max_ms"]} for k, v in status.items()},
        }
        wait = status.get("retriever.search_texts", {})
        log(f"  background rebuild over {rt.store.count} rows ({MTR_FILLER} random added in "
            f"{add_s:.1f} s): {sum(during)} of {MTR_ASKS} asks landed during it, none "
            f"degraded; build {', '.join(f'{k} {v:.2f} s' for k, v in ivf.build_seconds.items())}")
        log(f"  mesh slot waits in that window: a retrieval mean "
            f"{wait.get('slot_wait_mean_ms')} ms, max {wait.get('slot_wait_max_ms')} ms; "
            + ", ".join(f"{k} {v['slot_wait_mean_ms']}/{v['slot_wait_max_ms']} ms"
                        for k, v in status.items() if k != "retriever.search_texts"))
    finally:
        retr._search_texts = real_search
        if not server.close(timeout=30):
            raise AssertionError("the tiered mesh runtime's server threads did not end")
        rt.stop()
    return summary, launches


def run_ivf_shards(arrays):
    """(b) phase 12's 1M-row tier (its host arrays) split into 2, 4 and 8
    cell shards: each shard uploaded alone (``ivf_from_arrays`` under a
    group-less mesh context of its model index), probed on the card at
    ``IVF_SHARD_QUERIES`` queries and nprobe ``IVF_SHARD_NPROBE`` with the
    shard's masking, the shards' top lists merged with ``ops/topk.
    merge_topk``: scores and ids equal the whole probe's (tie rule).  Each
    shard timed beside its byte bound (the probed cells it owns, read once,
    and the replicated centroids and spill)."""
    from docqa_tpu_torch.index.ivf import _coarse_probe, _probe_kernel, ivf_from_arrays

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    meta = [{}] * (int(max(arrays["cell_ids"].max(), arrays["spill_ids"].max())) + 1)
    whole = ivf_from_arrays(arrays, meta, nprobe=IVF_SHARD_NPROBE, device="cuda")
    rng = np.random.default_rng(170)
    cent = arrays["centroids"][: IVF_SHARD_QUERIES]
    qs = cent + 0.02 * rng.standard_normal(cent.shape, dtype=np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    q = torch.from_numpy(qs).to(dev, whole._dtype)
    fetch = TIER_K * (whole.n_assign + 1)
    d = whole.dim
    cell_bytes = whole.cap * (d * whole._cells.element_size() + 4 + 4)
    fixed = (whole._centroids.numel() * whole._centroids.element_size()
             + whole._spill.numel() * whole._spill.element_size() + whole._spill_ids.numel() * 4)

    def probe(ivf, ctx):
        return _probe_kernel(ivf._cells, ivf._cell_scale, ivf._cell_ids, ivf._centroids,
                             ivf._spill, ivf._spill_ids, q, nprobe=IVF_SHARD_NPROBE, k=fetch,
                             n_real_cells=ivf.n_real_cells, mesh=ctx)

    out = {}
    with torch.inference_mode():
        want_vals, want_ids = probe(whole, None)
        probed = _coarse_probe(q, whole._centroids, IVF_SHARD_NPROBE, whole.n_real_cells)
        whole_ms = time_ms(lambda: probe(whole, None), flush, reps=5, warmup=1,
                           spin_cycles=40_000_000)
        flops = 2.0 * IVF_SHARD_QUERIES * (IVF_SHARD_NPROBE * whole.cap + whole.n_clusters) * d
        nbytes = IVF_SHARD_QUERIES * IVF_SHARD_NPROBE * cell_bytes + fixed
        out["whole"] = {"ms": whole_ms, "bytes": nbytes, "bound_ms": max(
            nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS) * 1e3}
        del whole
        torch.cuda.empty_cache()
        for n in IVF_SHARDS:
            parts, rec = [], []
            for m in range(n):
                ctx = mesh_mod.MeshContext(None, "data", "model", 1, n, 0, m, dev)
                shard = ivf_from_arrays(arrays, meta, nprobe=IVF_SHARD_NPROBE, device="cuda",
                                        mesh=ctx)
                parts.append(probe(shard, ctx))
                ms = time_ms(lambda: probe(shard, ctx), flush, reps=5, warmup=1,
                             spin_cycles=40_000_000)
                lo = m * shard.cells_per_shard
                owned = int(((probed >= lo) & (probed < lo + shard.cells_per_shard)).sum())
                nbytes = owned * cell_bytes + fixed
                flops = 2.0 * (owned * shard.cap + IVF_SHARD_QUERIES * shard.n_clusters) * d
                rec.append({"ms": ms, "probed_cells": owned, "bytes": nbytes,
                            "bound_ms": max(nbytes / PEAK_BYTES_S,
                                            flops / PEAK_BF16_FLOPS) * 1e3})
                del shard
                torch.cuda.empty_cache()
            vals, ids = ttopk.merge_topk(torch.stack([p[0] for p in parts]),
                                         torch.stack([p[1] for p in parts]), fetch)
            _same_ids_tie_rule(vals, ids, want_vals, want_ids, f"IVF probe over {n} shards")
            out[f"shards{n}"] = {"cells_a_shard": -(-arrays["centroids"].shape[0] // n),
                                 "shards": rec, "max_ms": max(r["ms"] for r in rec)}
            log(f"  IVF probe over {n} cell shards: ids and scores equal the whole probe's; "
                + "; ".join(f"shard {m} {r['ms']:.3f} ms (bound {r['bound_ms']:.4f} ms, "
                            f"{r['probed_cells']} probed cells)" for m, r in enumerate(rec))
                + f" (the whole {whole_ms:.3f} ms, bound {out['whole']['bound_ms']:.4f} ms)")
    del flush
    return out


def run_mesh_tiered_path(counts, qa, tagger, phase12_app, tier_arrays):
    """Phase 17, in phase 15's world of one rank."""
    t0 = time.perf_counter()
    runtime, launches = run_mesh_tiered_runtime(counts, qa, tagger, phase12_app)
    shards = run_ivf_shards(tier_arrays)
    phase_s = time.perf_counter() - t0
    log(f"  phase 17 took {phase_s:.1f} s (limit {MESH_TIER_PHASE_LIMIT_S:.0f} s)")
    if phase_s > MESH_TIER_PHASE_LIMIT_S:
        raise AssertionError(f"phase 17 took {phase_s:.1f} s, over "
                             f"{MESH_TIER_PHASE_LIMIT_S} s")
    return {"summary": {"runtime": runtime, "shards": shards, "phase_s": phase_s},
            "launches": {"17 runtime": launches}}


# ---- phase 18: training on a mesh ------------------------------------------------

MTRAIN_STEPS = 5  # (a) and (b)
MTRAIN_SAVE_AT = 4  # (a): the sharded save; the fifth step is the one resumed
MTRAIN_TP = (8, 4)  # (b): one rank's shard of full-depth Mistral-7B at these TP
MTRAIN_PHASE_LIMIT_S = 120.0


class _deterministic:
    """``torch.use_deterministic_algorithms`` for a block: the embedding's
    backward (an accumulating ``index_put_``) adds with atomics on the card
    otherwise, and two runs of one step then part in their last bits."""

    def __enter__(self):
        self.was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self.was)


def _bit_equal(a, b):
    return all(torch.equal(a[k].detach(), b[k].detach()) for k in a)


def run_mesh_train_lm(mesh, workdir):
    """(a) the LM at phase 11 (b)'s config: make_train_step(mesh=) on the
    (1, 1) mesh against the mesh-less step, ``MTRAIN_STEPS`` steps each on
    phase 11 (b)'s ragged batch; a sharded save at ``MTRAIN_SAVE_AT``,
    restored into a fresh tree whose next step gives the fifth loss."""
    from docqa_tpu_torch.training.checkpoint import TrainCheckpointer
    from docqa_tpu_torch.training.train import init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = dataclasses.replace(DecoderConfig.mistral_7b(), num_layers=LM_LAYERS)
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (len(LM_LENGTHS), max(LM_LENGTHS)),
                                        dtype=np.int32)).to(dev)
    lengths = torch.tensor(LM_LENGTHS, dtype=torch.int32, device=dev)
    ck_dir = os.path.join(workdir, "lm_sharded")
    ckpt = TrainCheckpointer(ck_dir, max_to_keep=1)
    runs, saved, save_s = {}, None, None
    for name, m in (("plain", None), ("mesh", mesh)):
        state, opt = init_train_state(cfg, seed=0, device=dev, mesh=m)
        step = make_train_step(cfg, opt, m)
        mesh_mod.COLLECTIVES.clear()
        losses = []
        for _ in range(MTRAIN_STEPS):
            state, loss = step(state, ids, lengths)
            losses.append(float(loss))
            if m is not None and state["step"] == MTRAIN_SAVE_AT:
                saved = {k: v.detach().clone() for k, v in state["params"].items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ckpt.save(state)
                save_s = time.perf_counter() - t0
        runs[name] = (losses, {k: v.detach() for k, v in state["params"].items()},
                      dict(mesh_mod.COLLECTIVES))
        del state, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    if runs["mesh"][0] != runs["plain"][0]:
        raise AssertionError(f"(1, 1) mesh losses {runs['mesh'][0]} against mesh-less "
                             f"{runs['plain'][0]}")
    if not _bit_equal(runs["mesh"][1], runs["plain"][1]):
        raise AssertionError("the (1, 1) mesh's params part from the mesh-less step's")
    if runs["mesh"][2]:
        raise AssertionError(f"the (1, 1) mesh issued collectives: {runs['mesh'][2]}")
    losses = runs["mesh"][0]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the LM loss did not fall: {losses}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    step_dir = os.path.join(ck_dir, str(MTRAIN_SAVE_AT))
    files = sorted(os.listdir(step_dir))
    ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in files)
    template, opt = init_train_state(cfg, seed=1, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TrainCheckpointer(ck_dir, max_to_keep=1).restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if (template["step"], template["opt_state"].count) != (MTRAIN_SAVE_AT, MTRAIN_SAVE_AT):
        raise AssertionError(f"restored step {template['step']}, saved {MTRAIN_SAVE_AT}")
    if not _bit_equal(template["params"], saved):
        raise AssertionError("the restored params differ from the saved ones")
    del saved
    template, loss = make_train_step(cfg, opt, mesh)(template, ids, lengths)
    resumed = float(loss)
    if resumed != losses[MTRAIN_SAVE_AT]:
        raise AssertionError(f"resumed loss {resumed} against uninterrupted "
                             f"{losses[MTRAIN_SAVE_AT]}")
    del template, opt
    shutil.rmtree(ck_dir)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) LM at Mistral-7B width, {LM_LAYERS} layers: {MTRAIN_STEPS} steps on the "
        f"(1, 1) mesh bit-equal to the mesh-less step (losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}), 0 collectives; sharded save at step {MTRAIN_SAVE_AT}: "
        f"{files}, {ck_bytes / 2**30:.2f} GiB in {save_s:.1f} s, restored in "
        f"{restore_s:.1f} s, params bit-equal, next loss {resumed:.6f} == uninterrupted")
    return {"layers": LM_LAYERS, "losses": losses, "bit_equal": True, "collectives": 0,
            "checkpoint": {"files": files, "bytes": ck_bytes, "save_s": save_s,
                           "restore_s": restore_s, "resumed_loss": resumed}}


def run_mesh_train_encoder(counts, mesh):
    """(a) the encoder at MiniLM width: make_encoder_train_step(mesh=) on the
    (1, 1) mesh against the mesh-less step, bit for bit; the trained
    embeddings through K1 ``prefill`` against the plain attention's."""
    from docqa_tpu_torch.text.tokenizer import default_tokenizer
    from docqa_tpu_torch.training.encoder import (
        encode_pair_batch, init_encoder_train_state, make_encoder_train_step,
        synthetic_pairs,
    )
    from docqa_tpu_torch.weights import host_init_encoder_params

    dev = torch.device("cuda")
    cfg = EncoderConfig()
    tok = default_tokenizer(cfg.vocab_size)
    host = host_init_encoder_params(cfg, 0)
    batches = [encode_pair_batch(tok, synthetic_pairs(np.random.default_rng(10 + i),
                                                      ENC_BATCH), ENC_SEQ)
               for i in range(MTRAIN_STEPS)]
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        state, opt = init_encoder_train_state(cfg, params=host, device=dev, mesh=m)
        step = make_encoder_train_step(cfg, opt, m)
        mesh_mod.COLLECTIVES.clear()
        losses = [float(step(state, *b)[1]) for b in batches]
        runs[name] = (losses, {k: v.detach() for k, v in state["params"].items()},
                      dict(mesh_mod.COLLECTIVES))
    if runs["mesh"][0] != runs["plain"][0] or not _bit_equal(runs["mesh"][1], runs["plain"][1]):
        raise AssertionError(f"the (1, 1) mesh's encoder steps part from the mesh-less "
                             f"ones: {runs['mesh'][0]} against {runs['plain'][0]}")
    if runs["mesh"][2]:
        raise AssertionError(f"the (1, 1) mesh issued collectives: {runs['mesh'][2]}")
    trained = runs["mesh"][1]
    pairs = synthetic_pairs(np.random.default_rng(123), ENC_EVAL_PAIRS)
    _acc, plain = _recall_at_1(trained, cfg, tok, pairs, use_flash=False)
    counts.clear()
    _acc, served = _recall_at_1(trained, cfg, tok, pairs, use_flash=True)
    torch.cuda.synchronize()
    k1 = dict(counts)
    if not k1.get("flash_attention.prefill", 0):
        raise AssertionError(f"the trained encoder's serving encode launched no K1: {k1}")
    atol, rtol = TOL[torch.bfloat16]
    err = (served - plain).abs()
    if not bool((err <= atol + rtol * plain.abs()).all()):
        raise AssertionError(f"K1 embeddings part from the plain ones by {float(err.max())}")
    log(f"  (a) encoder at MiniLM width: {MTRAIN_STEPS} steps on the (1, 1) mesh bit-equal "
        f"to the mesh-less step (losses {runs['mesh'][0][0]:.4f} -> "
        f"{runs['mesh'][0][-1]:.4f}), 0 collectives; its embeddings through K1 within "
        f"{float(err.max()):.2e} of the plain path (K1 launches {k1})")
    return {"losses": runs["mesh"][0], "bit_equal": True, "collectives": 0,
            "k1_vs_plain_max_abs_err": float(err.max()), "k1_launches": k1}


MTRAIN_NLL_ATOL = 1e-4  # (c): float32 nll near 30; two formulas of one log-softmax
MTRAIN_NLL_GRAD_ATOL = 1e-5  # (c): softmax - one-hot, each element within [-1, 1]


def run_vocab_parallel_nll(mesh):
    """(c) the vocabulary-parallel cross-entropy of make_train_step(mesh=)
    (``training/train._vocab_parallel_nll``) on the card.  On the (1, 1)
    mesh its MAX and SUM collectives are the identity, so the nll of a
    rank's logits block [4, 511, 32,000 / n] and its gradient are held
    against log_softmax + gather on the same logits at each TP of
    ``MTRAIN_TP``; forward and backward timed for both."""
    from docqa_tpu_torch.training.train import _vocab_parallel_nll

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for n in MTRAIN_TP:
        vocab = DecoderConfig.mistral_7b().vocab_size // n
        gen = torch.Generator(device=dev)
        gen.manual_seed(n)
        logits = 4 * torch.randn(len(LM_LENGTHS), max(LM_LENGTHS) - 1, vocab,
                                 generator=gen, device=dev)
        targets = torch.randint(0, vocab, logits.shape[:2], generator=gen, device=dev)
        routes = {
            "vocab_parallel": lambda x: _vocab_parallel_nll(x, targets, vocab, mesh),
            "plain": lambda x: -torch.gather(torch.log_softmax(x, -1), -1,
                                             targets[..., None])[..., 0],
        }
        res, ms = {}, {}
        for name, nll_of in routes.items():
            x = logits.clone().requires_grad_(True)

            def fwd_bwd():
                x.grad = None
                nll = nll_of(x)
                nll.sum().backward()
                return nll

            mesh_mod.COLLECTIVES.clear()
            res[name] = (fwd_bwd().detach(), x.grad.clone())
            if mesh_mod.COLLECTIVES:
                raise AssertionError(f"a group of one rank issued {dict(mesh_mod.COLLECTIVES)}")
            ms[name] = time_ms(fwd_bwd, flush, reps=10)
        err = float((res["vocab_parallel"][0] - res["plain"][0]).abs().max())
        grad_err = float((res["vocab_parallel"][1] - res["plain"][1]).abs().max())
        if not (err <= MTRAIN_NLL_ATOL and grad_err <= MTRAIN_NLL_GRAD_ATOL):
            raise AssertionError(f"TP {n}: the vocabulary-parallel nll parts from log_softmax "
                                 f"by {err} (gradient {grad_err})")
        out[f"tp{n}"] = {"vocab": vocab, "max_abs_err": err, "grad_max_abs_err": grad_err,
                         "ms": ms["vocab_parallel"], "plain_ms": ms["plain"]}
        log(f"  (c) TP {n}: the vocabulary-parallel nll of [{len(LM_LENGTHS)}, "
            f"{max(LM_LENGTHS) - 1}, {vocab}] float32 logits within {err:.2e} of "
            f"log_softmax + gather (atol {MTRAIN_NLL_ATOL:g}), its gradient within "
            f"{grad_err:.2e} (atol {MTRAIN_NLL_GRAD_ATOL:g}); forward and backward "
            f"{ms['vocab_parallel']:.3f} ms against {ms['plain']:.3f} ms")
    del flush
    torch.cuda.empty_cache()
    return out


def rank_shard_config(n):
    """One rank's widths of full-depth Mistral-7B at TP ``n``: 32/n q heads,
    8/n kv heads, MLP 14,336/n, vocabulary 32,000/n (its lm_head block; the
    embedding cut alike)."""
    full = DecoderConfig.mistral_7b()
    return dataclasses.replace(full, num_heads=full.num_heads // n,
                               num_kv_heads=full.num_kv_heads // n,
                               mlp_dim=full.mlp_dim // n, vocab_size=full.vocab_size // n)


def run_mesh_train_shards():
    """(b) one rank's shard of full-depth Mistral-7B at each TP of
    ``MTRAIN_TP``: float32 master weights drawn on the card,
    ``MTRAIN_STEPS`` remat steps on a ragged 4 x 512 batch in the cut
    vocabulary; ms a step, tokens/s and peak memory beside the state's
    bytes reckoned at 16 B a parameter (params, grads, two moments).  One
    rank's work: no collective time."""
    from docqa_tpu_torch.models.decoder import decoder_param_schema
    from docqa_tpu_torch.training.train import init_train_state, make_train_step

    dev = torch.device("cuda")
    out = {}
    for n in MTRAIN_TP:
        cfg = rank_shard_config(n)
        n_params = sum(math.prod(shape) for _n, _k, shape, _f in decoder_param_schema(cfg))
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak()
        base = torch.cuda.memory_allocated()
        state, opt = init_train_state(cfg, seed=0, device=dev)
        rng = np.random.default_rng(8)
        ids = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (len(LM_LENGTHS), max(LM_LENGTHS)),
                                            dtype=np.int32)).to(dev)
        lengths = torch.tensor(LM_LENGTHS, dtype=torch.int32, device=dev)
        step = make_train_step(cfg, opt)
        losses, times, enqueued = [], [], []
        for _ in range(MTRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, ids, lengths)
            enqueued.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        peak = peak_allocated() - base
        profiled = _profiled_step(step, state, ids, lengths) if n == MTRAIN_TP[0] else None
        del state, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        if not losses[-1] < losses[0]:
            raise AssertionError(f"TP {n}: the loss did not fall: {losses}")
        step_ms = statistics.median(times[1:]) * 1e3
        host_share = statistics.median(e / t for e, t in zip(enqueued[1:], times[1:]))
        tokens = sum(LM_LENGTHS)
        out[f"tp{n}"] = {
            "layers": cfg.num_layers, "params": n_params, "state_bytes": 16 * n_params,
            "losses": losses, "ms_per_step": step_ms, "first_step_ms": times[0] * 1e3,
            "step_ms": [t * 1e3 for t in times], "enqueue_ms": [e * 1e3 for e in enqueued],
            "host_share": host_share, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gib": peak / 2**30, "profiled_step": profiled,
        }
        log(f"  (b) TP {n}: one rank's shard of Mistral-7B at {cfg.num_layers} layers "
            f"({n_params / 1e9:.3f} B params, {16 * n_params / 1e9:.1f} GB of state "
            f"reckoned): loss {losses[0]:.4f} -> {losses[-1]:.4f}; {step_ms:.1f} ms a step "
            f"(median of steps 2-{MTRAIN_STEPS}; the first {times[0] * 1e3:.0f} ms), the "
            f"step's enqueue {host_share:.2f} of it, {tokens / step_ms * 1e3:.0f} tokens/s, "
            f"peak {peak / 2**30:.2f} GiB" + (f"; one step profiled: {profiled}" if profiled
                                              else ""))
    return out


def _profiled_step(step, state, ids, lengths):
    """One more step under ``torch.profiler``: its wall ms, the device's
    busy ms (the union of the card's activity intervals) and idle share,
    and the activities (kernels, copies) the card ran; None where the
    profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, ids, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    if not spans:  # the profiler saw no device activity: not measured
        return {"wall_ms": wall * 1e3, "device_busy_ms": None, "idle_share": None,
                "device_activities": 0}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / (wall * 1e3), "device_activities": len(spans)}


def run_mesh_train_path(counts):
    """Phase 18, last: a world of one NCCL rank of its own, (a) and (c) on
    its (1, 1) mesh, (b) one rank's full-depth shards."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="docqa_phase18_")
    try:
        if not mesh_mod.multihost_init(f"file://{workdir}/nccl_init", 1, 0, local_rank=0,
                                       device="cuda"):
            raise AssertionError("multihost_init did not start the world")
        mesh = mesh_mod.make_mesh(MeshConfig(), device="cuda")
        if (mesh.n_data, mesh.n_model, dist.get_backend()) != (1, 1, "nccl"):
            raise AssertionError(f"mesh {mesh.n_data}x{mesh.n_model} over "
                                 f"{dist.get_backend()}")
        with _deterministic():
            lm = run_mesh_train_lm(mesh, workdir)
            enc = run_mesh_train_encoder(counts, mesh)
        nll = run_vocab_parallel_nll(mesh)
        dist.destroy_process_group()
        shards = run_mesh_train_shards()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    phase_s = time.perf_counter() - t0
    log(f"  phase 18 took {phase_s:.1f} s (limit {MTRAIN_PHASE_LIMIT_S:.0f} s)")
    if phase_s > MTRAIN_PHASE_LIMIT_S:
        raise AssertionError(f"phase 18 took {phase_s:.1f} s, over {MTRAIN_PHASE_LIMIT_S} s")
    return {"summary": {"lm": lm, "encoder": enc, "vocab_parallel_nll": nll,
                        "shards": shards, "phase_s": phase_s},
            "launches": {"18 encoder": enc["k1_launches"]}}


# ---- phase 19: the runtime witnesses ---------------------------------------------

WIT_NOTES = 8  # phase 9's first notes, uploaded over HTTP
WIT_ASKS = 8  # generative questions asked at once
WIT_PHASE_LIMIT_S = 120.0
WIT_CHILD_TIMEOUT_S = 300.0
# the child: both witnesses first, before any port module builds a lock
WITNESS_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from docqa_tpu_torch.analysis import ledger_audit, race_witness
race_witness.install_witness()
ledger_audit.install_ledger_witness()
import chip_smoke
sys.exit(chip_smoke.witness_child(sys.argv[2]))
"""


def witness_child(tagger) -> int:
    """Phase 19's child (the module docstring), with both witnesses
    installed by its first statements.  Prints one ``{"witness_child":
    ...}`` JSON line; any failed check raises."""
    from docqa_tpu_torch.analysis import ledger_audit, race_witness
    from docqa_tpu_torch.analysis.wire_audit import run_wire_audit
    from docqa_tpu_torch.config import load_config
    from docqa_tpu_torch.engines.router import AnswerRouter
    from docqa_tpu_torch.service.app import AppServer, DocQARuntime, make_app

    if race_witness.DEFAULT_WITNESS is None or ledger_audit.DEFAULT_LEDGER_WITNESS is None:
        raise AssertionError("the witnesses were not installed before the port's imports")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_child = time.perf_counter()
    _kernels.build()  # the parent built them: found in the cache
    counts = _kernels.LAUNCHES
    dev = torch.device("cuda")
    dec_cfg = DecoderConfig.mistral_7b()
    params = init_decoder_params(dec_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    cfg = dataclasses.replace(
        load_config(env={}, overrides={
            "ner.params_path": tagger,
            "resilience.request_deadline_s": APP_DEADLINE_S,
        }),
        decoder=dec_cfg,
    )
    t0 = time.perf_counter()
    rt = DocQARuntime(cfg, device=dev, decoder_params=params).start()
    server = AppServer(make_app(rt)).start()
    boot_s = time.perf_counter() - t0
    _lookups, generative = routing_lookups(AnswerRouter(), deid=rt.deid)
    http = _Http(server.port, load_contract())
    log(f"  [child] witnessed runtime booted in {boot_s:.1f} s; serving on "
        f"127.0.0.1:{server.port}")
    closed = False
    try:
        docs = app_notes(np.random.default_rng(21))[:WIT_NOTES]
        ids = []
        for d in docs:
            body, ctype = _multipart(d["filename"], d["data"], d["fields"])
            ids.append(http.json("POST /ingest/", "/ingest/", body=body, ctype=ctype)["doc_id"])
        _wait_indexed(http, ids)
        if len(generative) < WIT_ASKS:
            raise AssertionError("the routing mix lacks the questions phase 19 asks")

        # the main path: the counts from 0 just before the asks, read after
        counts.clear()
        results = [None] * WIT_ASKS

        def ask(i, q):
            t = time.perf_counter()
            results[i] = (http.json("POST /ask/", "/ask/", payload={"question": q}),
                          time.perf_counter() - t)

        threads = [threading.Thread(target=ask, args=(i, q), name=f"witness-ask-{i}")
                   for i, q in enumerate(generative[:WIT_ASKS])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # both witnesses read over HTTP while the asks are in flight
        live = {"witness": http.json("GET /api/witness", "/api/witness"),
                "ledger": http.json("GET /api/ledger", "/api/ledger")}
        for t in threads:
            t.join(timeout=APP_HTTP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        launches = dict(counts)
        if any(r is None for r in results):
            raise AssertionError("a witnessed /ask over HTTP did not answer")
        _no_degraded("witnessed /ask", [r[0] for r in results])
        http.json("DELETE /documents/{doc_id}", f"/documents/{ids[0]}")
        http.json("GET /api/witness", "/api/witness")
        http.json("GET /api/ledger", "/api/ledger")
        # the port's live wire audit against this runtime, before stop:
        # every route over HTTP (a second front on its own port)
        t0 = time.perf_counter()
        audit = run_wire_audit(rt=rt, timeout=APP_HTTP_TIMEOUT_S)
        audit_s = time.perf_counter() - t0
        cov = audit["coverage"]
        if not audit["ok"] or len({cov["driven"], cov["registered"], cov["declared"]}) != 1:
            bad = {k: r["violations"] for k, r in audit["endpoints"].items()
                   if r["violations"]}
            raise AssertionError(f"phase 19's wire audit: {audit['violations_total']} "
                                 f"violations, coverage {cov}, journal "
                                 f"{audit['journal']}: {bad}")
        log(f"  [child] wire audit: {cov['driven']}/{cov['registered']} routes driven "
            f"({cov['declared']} declared), 0 violations, journal round trip ok, "
            f"{audit_s:.1f} s")
    finally:
        closed = server.close(timeout=30)
        rt.stop()
    if not closed:
        raise AssertionError("the witnessed app server's threads did not end")

    # at quiesce
    w = race_witness.witness_snapshot()
    led = ledger_audit.ledger_snapshot()
    for key, got in (("cycles", w["cycles"]),
                     ("edges_missing_from_static", w["edges_missing_from_static"]),
                     ("leaked_tables", led["leaked_tables"]),
                     ("unretired_records", led["unretired_records"]),
                     ("sites_missing_from_static", led["sites_missing_from_static"])):
        if got:
            raise AssertionError(f"phase 19 at quiesce: {key} = {got}")
    k1 = launches.get("flash_attention", 0)
    paths = {k: n for k, n in launches.items() if k.startswith("flash_attention.")}
    if k1 <= 0 or k1 != sum(paths.values()):
        raise AssertionError(f"phase 19's asks launched K1 {k1} times, its paths {paths}")
    held = [b for b in w["blocking"] if "ms" in b]
    lat = [r[1] for r in results]
    summary = {
        "boot_s": boot_s,
        "witness_edges": len(w["edges"]),
        "edge_names": [f"{e['from']} -> {e['to']}" for e in w["edges"]],
        "static_edge_count": w["static_edge_count"],
        "locks_seen": len(w["locks_seen"]),
        "blocking_events": len(w["blocking"]),
        "blocking_by_op": dict(collections.Counter(b["op"] for b in w["blocking"])),
        "longest_held_block_ms": max((b["ms"] for b in held), default=0.0),
        "live_edges_while_serving": len(live["witness"]["edges"]),
        "live_tables_while_serving": len(live["ledger"]["leaked_tables"]),
        "ledger_counts": led["counts"],
        "witnessed_sites": len(led["witnessed_sites"]),
        "static_site_count": led["static_site_count"],
        "k1_launches": launches.get("flash_attention", 0),
        "k1_by_path": paths,
        "launches": launches,
        "asks": WIT_ASKS, "asks_wall_s": wall,
        "ask_p50_s_under_witnesses_not_a_latency_figure": _pctl(lat, 0.5),
        "redundant_retire_sites": led.get("redundant_retire_sites"),
        "wire_audit": {
            "routes_driven": cov["driven"], "routes_registered": cov["registered"],
            "routes_declared": cov["declared"], "violations": audit["violations_total"],
            "journal_ok": audit["journal"]["ok"], "seconds": audit_s,
            "statuses": {k: r["status"] for k, r in audit["endpoints"].items()},
        },
        "child_s": time.perf_counter() - t_child,
    }
    print(json.dumps({"witness_child": summary}), flush=True)
    return 0


def run_witness_path(tagger):
    """Phase 19 (the module docstring): the witnessed runtime in a child
    process, its JSON line read back; fails on the child's failure or past
    the phase's limit."""
    t0 = time.perf_counter()
    env = dict(os.environ, DOCQA_RACE_WITNESS="1", DOCQA_LEDGER_WITNESS="1")
    proc = subprocess.run(
        [sys.executable, "-c", WITNESS_CHILD, REPO_ROOT, tagger],
        stdout=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT,
        timeout=WIT_CHILD_TIMEOUT_S,
    )
    summary = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"witness_child"'):
            summary = json.loads(line)["witness_child"]
        else:
            log(line)
    if proc.returncode != 0 or summary is None:
        raise AssertionError(f"phase 19's child exited {proc.returncode}")
    phase_s = time.perf_counter() - t0
    summary["phase_s"] = phase_s
    log(f"  witnessed runtime: {summary['witness_edges']} lock-order edges, none missing "
        f"from the static graph, no cycle; {summary['blocking_events']} held-lock blocking "
        f"events (longest {summary['longest_held_block_ms']:.1f} ms); tables "
        f"{summary['ledger_counts']['tables_created']} created / "
        f"{summary['ledger_counts']['tables_released']} released, records "
        f"{summary['ledger_counts']['records_opened']} opened / "
        f"{summary['ledger_counts']['records_retired']} retired, none left; K1 "
        f"{summary['k1_by_path']}; /ask p50 {summary['ask_p50_s_under_witnesses_not_a_latency_figure']:.2f} s "
        f"under the witnesses (not a latency figure)")
    log(f"  phase 19 took {phase_s:.1f} s (limit {WIT_PHASE_LIMIT_S:.0f} s)")
    if phase_s > WIT_PHASE_LIMIT_S:
        raise AssertionError(f"phase 19 took {phase_s:.1f} s, over {WIT_PHASE_LIMIT_S} s")
    return summary


REPLAY_SEED = 0
REPLAY_PHASE_LIMIT_S = 90.0
REPLAY_CHILD_TIMEOUT_S = 240.0


def start_replay_witness():
    """Phase 21 (a), started: the replay smoke at full width (Mistral-7B
    bf16 drawn on the card from seed 0: a solo engine's two answers and a
    batcher's cold and warm groups, K = 4, 32 new tokens each; top-10 ids
    of 16 queries over an exact 1,000,000 x 384 store and a tier of its
    first 100,000 rows; the journal across a restart; the shadow sampler)
    in two child interpreters at once under different ``PYTHONHASHSEED``s,
    on a thread of this process.  ``run_training_tagger`` starts it just
    before phase 11 (a)'s training child and ``finish_replay_witness``
    joins it just after that child."""
    gc.collect()
    torch.cuda.empty_cache()
    state = {"t0": time.perf_counter(), "td": tempfile.mkdtemp(prefix="docqa_phase21_")}

    def children():
        try:
            state["runs"] = replay_audit.spawn_runs(
                REPLAY_SEED, "cuda", "full", state["td"],
                timeout_s=REPLAY_CHILD_TIMEOUT_S, root=REPO_ROOT)
        except BaseException as e:  # re-raised by finish_replay_witness
            state["error"] = e
        state["wall_s"] = time.perf_counter() - state["t0"]

    state["thread"] = threading.Thread(target=children, name="phase21-replay", daemon=True)
    state["thread"].start()
    return state


def finish_replay_witness(state):
    """Phase 21 (a), joined: the transcripts must be bitwise equal; a
    divergence is printed with its attribution (request, token, stage) and
    fails the phase.  Each child must finish within the phase's limit."""
    state["thread"].join(REPLAY_CHILD_TIMEOUT_S + 60.0)
    shutil.rmtree(state["td"], ignore_errors=True)
    if state["thread"].is_alive():
        raise AssertionError("phase 21 (a): the replay children did not finish")
    if "error" in state:
        raise state["error"]
    runs = state["runs"]
    cmp = replay_audit.compare_transcripts(runs[0], runs[1])
    if not cmp["equal"]:
        for d in cmp["divergences"]:
            log("  divergence: " + replay_audit.format_divergence(d))
        raise AssertionError("phase 21 (a): the two runs diverge, first "
                             + replay_audit.format_divergence(cmp["first_divergence"]))
    reqs = runs[0]["decode"]["requests"]
    want = (replay_audit.FULL_SOLO_QUESTIONS + 2 * replay_audit.FULL_GROUP + 1)
    if len(reqs) != want or not all(
            0 < len(r["tokens"]) <= replay_audit.FULL_NEW_TOKENS for r in reqs):
        raise AssertionError(f"phase 21 (a): decode transcript {[(r['id'], len(r['tokens'])) for r in reqs]}")
    queries = runs[0]["retrieval"]["queries"]
    if len(queries) != 2 * replay_audit.FULL_QUERIES or not all(
            len(q["doc_ids"]) == 10 for q in queries):
        raise AssertionError("phase 21 (a): retrieval transcript short")
    if runs[0]["journal"]["doc_states_pre"] != runs[0]["journal"]["doc_states_post"]:
        raise AssertionError("phase 21 (a): journal replay did not converge")
    if runs[0]["python_hash_seed"] == runs[1]["python_hash_seed"]:
        raise AssertionError("phase 21 (a): both runs had the same hash seed")
    slowest = max(r["seconds"] for r in runs)
    if slowest > REPLAY_PHASE_LIMIT_S:
        raise AssertionError(f"phase 21 (a): a child took {slowest:.1f} s, over the "
                             f"phase's {REPLAY_PHASE_LIMIT_S:.0f} s limit")
    summary = {
        "equal": True, "wall_s": state["wall_s"],
        "hash_seeds": [r["python_hash_seed"] for r in runs],
        "child_s": [r["seconds"] for r in runs],
        "contended": {"readings": ["wall_s", "child_s"],
                      "with": "phase 11 (a)'s tagger training child"},
        "child_peak_gib": [r.get("peak_bytes", 0) / 2**30 for r in runs],
        "requests": len(reqs), "tokens": sum(len(r["tokens"]) for r in reqs),
        "queries": len(queries), "spec_k": runs[0]["decode"]["spec_k"],
        "shadow_selected": len(runs[0]["shadow"]["selected"]),
    }
    log(f"  replay: {summary['requests']} streams ({summary['tokens']} tokens), "
        f"{summary['queries']} retrievals, journal and shadow set bitwise equal across "
        f"PYTHONHASHSEED {summary['hash_seeds']}; children "
        + ", ".join(f"{s:.1f} s" for s in summary["child_s"])
        + " at peak " + ", ".join(f"{g:.1f} GiB" for g in summary["child_peak_gib"])
        + f"; {state['wall_s']:.1f} s from their start beside phase 11 (a)'s "
        "training child")
    return summary


def run_compile_audit(report_path=None):
    """Phase 21 (b): every K1 and K4 kernel's ptxas resources (from the
    build logs beside the libraries), the seven entry points' peak memory
    and the steady state, read in their phases, against
    ``docqa_tpu_torch/analysis/compile_budget.json``.  The report is
    written to ``report_path`` before the gate."""
    kernels = compile_audit.kernel_resources()
    report = compile_audit.make_report(kernels, COMPILE_PEAKS, COMPILE_STEADY)
    if report_path:
        os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    for sym, k in sorted(kernels.items()):
        log(f"    {sym}: {k['registers']} registers, spills {k['spill_stores']}/"
            f"{k['spill_loads']} bytes, stack {k['stack_bytes']} bytes, smem "
            f"{k['smem_bytes']} bytes")
    log("  peaks above allocated: " + ", ".join(
        f"{name} {COMPILE_PEAKS.get(name, 0) / 2**30:.3f} GiB"
        for name in compile_audit.ENTRY_POINTS))
    log("  steady state over a repeated round: " + ", ".join(
        f"{name} {delta}" for name, delta in sorted(COMPILE_STEADY.items())))
    ok, violations = compile_audit.check_reading(report)
    if not ok:
        raise AssertionError("phase 21 (b): compile budget violated:\n  "
                             + "\n  ".join(violations))
    return report


def numerics_ab(flush):
    """``--numerics-ab``: (1) phase 3's bf16 solo decode at Mistral-7B width
    (one 195-token prompt, 64 new tokens, K = 4) and K4's cuBLAS bf16
    library case (``torch.matmul`` at the w_gate and lm_head shapes) with
    cuBLAS's bf16 reduced-precision split-K reduction allowed (PyTorch's
    default) and pinned off (the port's), in turns allowed, off, off,
    allowed; (2) the k-means cell sums at the tier's fit shape (262,144 x
    384 float32 rows, 1,000 cells) by ``index_add_``, by one-hot products
    of 16,384-row blocks and by ``index_put_(accumulate=True)``: device ms
    and whether ten repeats are bitwise equal."""
    flags = torch.backends.cuda.matmul
    dev = torch.device("cuda")
    cfg = DecoderConfig.mistral_7b()
    params = init_decoder_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    gen = GenerateEngine(cfg, GenerateConfig(max_new_tokens=64, speculative_k=4),
                         params=params, device=dev)
    prompt = np.random.default_rng(3).integers(3, cfg.vocab_size, 195).tolist()
    g = torch.Generator(device=dev).manual_seed(5)
    mats = {f"{name}_m{m}": (torch.randn(m, k, device=dev, generator=g).bfloat16(),
                             torch.randn(k, n, device=dev, generator=g).bfloat16())
            for name, k, n in (("w_gate", 4096, 14336), ("lm_head", 4096, 32000))
            for m in (4, 2048)}
    runs = []
    for allowed in (True, False, False, True):
        flags.allow_bf16_reduced_precision_reduction = allowed
        gen.generate_ids([prompt])  # warm at this setting
        gen.generate_ids([prompt])
        st = dict(gen.last_stats)
        rec = {"reduced_precision_reduction": allowed,
               "decode_tokens": st["decode_tokens"], "forwards": st["forwards"],
               "decode_tok_s": st["decode_tokens"] / st["decode_s"],
               "verify_step_ms": st["decode_s"] * 1e3 / max(st["forwards"] - 1, 1),
               "library_ms": {key: time_ms(lambda x=x, w=w: torch.matmul(x, w), flush)
                              for key, (x, w) in mats.items()}}
        log(f"  reduced-precision reduction {'allowed' if allowed else 'off'}: decode "
            f"{rec['decode_tok_s']:.1f} tok/s, {rec['verify_step_ms']:.2f} ms a verify "
            f"step ({rec['forwards']} forwards); cuBLAS bf16 "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in rec["library_ms"].items()))
        runs.append(rec)
    flags.allow_bf16_reduced_precision_reduction = False
    del gen, params, mats
    gc.collect()
    torch.cuda.empty_cache()

    x = torch.nn.functional.normalize(
        torch.randn(262144, 384, device=dev, generator=g), dim=1)
    cent = x[torch.randperm(x.shape[0], device=dev, generator=g)[:1000]]
    assign = torch.argmax(x @ cent.T, dim=1)
    c = cent.shape[0]

    def by_index_add():
        return torch.zeros((c, x.shape[1]), device=dev).index_add_(0, assign, x)

    def by_onehot():
        sums = torch.zeros((c, x.shape[1]), device=dev)
        for start in range(0, x.shape[0], 16384):
            a = assign[start:start + 16384]
            onehot = torch.zeros((c, a.numel()), device=dev)
            onehot[a, torch.arange(a.numel(), device=dev)] = 1.0
            sums += onehot @ x[start:start + 16384]
        return sums

    def by_index_put():
        return torch.zeros((c, x.shape[1]), device=dev).index_put_(
            (assign,), x, accumulate=True)

    ref = torch.zeros((c, x.shape[1]), dtype=torch.float64, device=dev).index_add_(
        0, assign, x.double())
    sums = {}
    for name, fn in (("index_add", by_index_add), ("onehot_blocks", by_onehot),
                     ("index_put", by_index_put)):
        first = fn()
        sums[name] = {"ms": time_ms(fn, flush),
                      "bitwise_repeat": all(torch.equal(first, fn()) for _ in range(10)),
                      "max_abs_err_vs_f64": float((first.double() - ref).abs().max())}
        log(f"  cell sums by {name}: {sums[name]['ms']:.4f} ms, ten repeats bitwise "
            f"equal {sums[name]['bitwise_repeat']}, max |err| against float64 "
            f"{sums[name]['max_abs_err_vs_f64']:.3g}")
    return {"decode_and_library": runs, "cell_sums": sums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full results as JSON to this path")
    ap.add_argument("--spine-lanes", type=int, default=None,
                    help="the dispatch spine's lane count (default: the spine's own)")
    ap.add_argument("--compile-report", default=None,
                    help="write phase 21 (b)'s compile report (JSON) to this path")
    ap.add_argument("--k4-ab", metavar="ROOT", default=None,
                    help="only run phase 14 (a)'s K4 cases and host_us_a_call with the "
                         "K4 of the checkout at ROOT beside this one, in turns, and exit")
    ap.add_argument("--numerics-ab", action="store_true",
                    help="only time phase 3's bf16 decode and K4's cuBLAS library case "
                         "with cuBLAS's bf16 reduced-precision reduction allowed and off, "
                         "and the k-means cell sums' three forms, and exit")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.spine_lanes is not None:
        configure(n_lanes=args.spine_lanes)  # before the first dispatch

    t_smoke = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/14] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logs = _kernels.build()
    build_s = time.perf_counter() - t0
    log(f"  built {sorted(build_logs) or 'nothing (cached)'} in {build_s:.1f} s")
    for name, text in build_logs.items():
        for kernel, regs, spills in ptxas_summary(text):
            log(f"    {name}: {kernel}: {regs} registers, spill stores/loads {spills}")
    if args.k4_ab:
        parent = load_parent_k4(args.k4_ab)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        ab = {"cases": run_qmatmul_cases(flush, parent)}
        del flush
        ab["host_us"] = host_us_a_call(parent, n=500, rounds=4)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"card": smi, "torch": torch.__version__, "k4_ab": ab}, f, indent=1)
        print(json.dumps({"k4_ab_host_us": ab["host_us"]}))
        print(smi)
        return 0
    if args.numerics_ab:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        ab = numerics_ab(flush)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"card": smi, "torch": torch.__version__, "numerics_ab": ab},
                          f, indent=1)
        print(json.dumps({"numerics_ab": ab}))
        print(smi)
        return 0

    log("[2/14] kernels against their plain versions (bf16 and float32)")
    cases = run_kernel_cases()
    cases += run_paged_cases()

    log("[3/14] main path: QAService.ask at full width")
    t_main = time.perf_counter()
    qa, params, enc_launches = build_main_path(_kernels.LAUNCHES)
    per_q, launches = run_main_path(_kernels.LAUNCHES, qa, params, enc_launches)
    main_s = time.perf_counter() - t_main

    log("[4/14] reference: tiny float32 /ask on the card against the CPU")
    reference = run_reference_check()

    log("[5/14] main path: QAService.ask through the continuous batcher at full width")
    t_batch = time.perf_counter()
    batcher_path = run_batcher_path(_kernels.LAUNCHES, qa, per_q)
    batcher_s = time.perf_counter() - t_batch

    log("[6/14] main path: QAService.ask through the replica pool at full width")
    t_pool = time.perf_counter()
    get_spine().reset_stats()
    pool_path = run_pool_path(_kernels.LAUNCHES, qa)
    pool_s = time.perf_counter() - t_pool
    pool_path["summary"]["spine"] = _spine_waits(get_spine().stats())
    _log_spine_waits("phase 6", pool_path["summary"]["spine"])

    log("[11/14 (a)] training: the tagger at NERConfig() trained as the default config's "
        "boot trains it, then held to the reference's quality floors; beside its training "
        "child only, phase 21 (a)'s replay children")
    t_train = time.perf_counter()
    train_dir = tempfile.mkdtemp(prefix="docqa_phase11_")
    replay_path = {}
    tagger, tagger_summary = run_training_tagger(_kernels.LAUNCHES, train_dir, replay_path)
    train_s = time.perf_counter() - t_train
    log(f"  phase 11 (a) and 21 (a) took {train_s:.1f} s together")

    log("[7/14] ingest: DocumentPipeline at full width, then /ask over what it indexed")
    t_ingest = time.perf_counter()
    get_spine().reset_stats()
    ingest_path = run_ingest_path(_kernels.LAUNCHES, qa, tagger)
    ingest_s = time.perf_counter() - t_ingest
    ingest_path["summary"]["spine"] = _spine_waits(get_spine().stats())
    _log_spine_waits("phase 7", ingest_path["summary"]["spine"])

    log("[8/14] obs: traces, stage device time, MFU and costs over the pool, "
        "and an ingested document's timeline")
    t_obs = time.perf_counter()
    obs_path = run_obs_path(_kernels.LAUNCHES, qa, tagger)
    obs_s = time.perf_counter() - t_obs

    log("[9/14] the app: DocQARuntime behind its stdlib HTTP front at full width, "
        "driven over HTTP")
    t_app = time.perf_counter()
    get_spine().reset_stats()
    app_path = run_app_path(_kernels.LAUNCHES, qa, tagger,
                            ingest_path["summary"]["docs_per_s"])
    app_s = time.perf_counter() - t_app

    log("[10/14] the store's lifecycle and the single-sync /ask: fused against classic "
        "/ask over a 1M-row store with a token sidecar, its snapshot and restore, and a "
        "runtime killed and restarted through HTTP")
    t_life = time.perf_counter()
    get_spine().reset_stats()
    life_path = run_lifecycle_path(_kernels.LAUNCHES, qa, tagger)
    life_s = time.perf_counter() - t_life
    log(f"  phase 10 took {life_s:.1f} s")

    log("[12/14] tiered retrieval: the int8 IVF tier over a 1M-row clustered store, its "
        "recall and latency against exact, the tail and a background rebuild, a tiered "
        "/ask through the pool with the retrieval observatory, and the tiered app")
    t_tier = time.perf_counter()
    get_spine().reset_stats()
    tiered_path = run_tiered_path(_kernels.LAUNCHES, qa, tagger)
    tier_arrays = tiered_path.pop("tier_arrays")  # phase 17 (b)'s
    tiered_s = time.perf_counter() - t_tier
    log(f"  phase 12 took {tiered_s:.1f} s")

    log("[14/14 (a)-(c)] the quantised decoder: K4 against its plain version at the "
        "Mistral-7B projections, phase 3's tree quantised int8 and int4 on the card and "
        "served solo, and the int8 engine behind a 1-replica pool")
    t_quant = time.perf_counter()
    get_spine().reset_stats()
    quant_path = run_quant_path(_kernels.LAUNCHES, qa, params,
                                pool_path["summary"]["rounds"]["A1"])
    quant_s = time.perf_counter() - t_quant

    log("[20/20] Llama-3-8B at full width: its decoder drawn in bf16 on the card and "
        "quantised int8 there, a solo engine on each tree over phase 3's encoder and "
        "store answering phase 3's first question through K1 and K4")
    get_spine().reset_stats()
    llama3_path = run_llama3_path(_kernels.LAUNCHES, qa)

    log("[15/15] the device plane on a mesh: a world of one rank over NCCL, the (1, 1) mesh's "
        "engine over phase 3's tree, the sharded top-k, Ulysses and ring attention; then one "
        "rank's K1 and K4 shard shapes at TP 1, 2, 4 and 8 of Mistral-7B")
    get_spine().reset_stats()
    mesh_dir = tempfile.mkdtemp(prefix="docqa_phase15_")
    try:
        mesh_path = run_mesh_path(_kernels.LAUNCHES, qa, params, mesh_dir)
        mesh_s = mesh_path["summary"]["phase_s"]

        log("[16/16] the runtime on a mesh: DocQARuntime in the world of one NCCL rank (the "
            "leader's command stream) at full width over HTTP; K1's paged mode at one rank's "
            "kv heads at TP 1, 2, 4 and 8; the lexical program over 2, 4 and 8 row shards")
        mrt_path = run_mesh_runtime_path(_kernels.LAUNCHES, qa, tagger,
                                         app_path["summary"]["ask"]["p50_s"])
        mrt_s = mrt_path["summary"]["phase_s"]

        log("[17/17] tiered retrieval on a mesh: DocQARuntime with tiered serving in the world "
            "of one NCCL rank (the tier built and switched by commands, dense and hybrid /ask, "
            "a background rebuild under load); phase 12's 1M-row tier probed in 2, 4 and 8 cell "
            "shards and merged")
        get_spine().reset_stats()
        mtr_path = run_mesh_tiered_path(_kernels.LAUNCHES, qa, tagger,
                                        tiered_path["summary"]["app"], tier_arrays)
        mtr_s = mtr_path["summary"]["phase_s"]
        del tier_arrays
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(mesh_dir, ignore_errors=True)

    log("[9/14, continued] the app module as a user starts it, and a tiny runtime on the "
        "card against the CPU")
    t_app = time.perf_counter()
    del qa, params
    gc.collect()
    torch.cuda.empty_cache()
    app_path["summary"]["module"] = run_app_module_check(tagger)
    app_path["summary"]["reference"] = run_app_reference_check()
    app_s += time.perf_counter() - t_app

    log("[19/19] the runtime witnesses: DocQARuntime at full width in a child process "
        "with the lock-order and resource-ledger witnesses installed first, served over "
        "HTTP; no cycle, no blind spot, no leak at quiesce")
    witness_path = run_witness_path(tagger)

    log("[11/14 (b)-(d)] training: LM steps at Mistral-7B width with remat and a "
        "checkpoint resumed, and the encoder at MiniLM width")
    t_train = time.perf_counter()
    training = {"tagger": tagger_summary,
                "lm": run_training_lm(_kernels.LAUNCHES, train_dir),
                "encoder": run_training_encoder(_kernels.LAUNCHES, train_dir)}
    train_s += time.perf_counter() - t_train
    log(f"  phase 11 took {train_s:.1f} s")

    log("[13/14] checkpoints and the seq2seq summarizer: BART-large-cnn, MiniLM and a "
        "Mistral-layout decoder imported from HF directories, beam-search summaries on K1, "
        "and the runtime serving all three over HTTP")
    t_ckpt = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    quant_rt = {}

    def quant_runtime(dirs):
        log("[14/14 (d)] the quantised decoder in the runtime: phase 13's Mistral directory "
            "booted with decoder.quantize_weights at quant_bits 8 and 4, /ask over HTTP")
        t0 = time.perf_counter()
        quant_rt["summary"], quant_rt["launches"] = run_quant_runtime(
            _kernels.LAUNCHES, dirs["decoder"], tagger)
        quant_rt["s"] = time.perf_counter() - t0

    ckpt_path = run_checkpoint_path(_kernels.LAUNCHES, tagger, then=quant_runtime)
    shutil.rmtree(train_dir)
    ckpt_s = time.perf_counter() - t_ckpt - quant_rt["s"]
    quant_s += quant_rt["s"]
    quant_path["summary"]["runtime"] = quant_rt["summary"]
    quant_path["launches"].update({f"runtime int{b}": n
                                   for b, n in quant_rt["launches"].items()})
    log(f"  phase 13 took {ckpt_s:.1f} s; phase 14 {quant_s:.1f} s")

    log("[18/18] training on a mesh: a world of one NCCL rank, the LM and encoder steps on "
        "its (1, 1) mesh bit-equal to the mesh-less ones, a sharded checkpoint saved and "
        "restored; then one rank's shard of full-depth Mistral-7B at TP 8 and TP 4")
    mtrain_path = run_mesh_train_path(_kernels.LAUNCHES)
    mtrain_s = mtrain_path["summary"]["phase_s"]

    log("[21/21] determinism and the compile budget: (a) the replay smoke at Mistral-7B "
        "width in two child interpreters under different hash seeds, bitwise equal (run "
        "beside phase 11 (a), above); (b) K1's and K4's ptxas resources, the seven entry "
        "points' peak memory and the steady state against compile_budget.json")
    t_replay = time.perf_counter()
    compile_report = run_compile_audit(args.compile_report)
    replay_s = time.perf_counter() - t_replay + replay_path["wall_s"]
    log(f"  phase 21 took {replay_s:.1f} s")
    # launches of the main-path runs (each counted from 0 around its run);
    # the wrapper counts every call under K1 and under its path, so each
    # run's K1 total must be the sum of its paths
    phase_launches = {
        "3": launches["total"], "5": batcher_path["launches"],
        "6": pool_path["launches"], "7": ingest_path["launches"],
        "7 rounds": ingest_path["round_launches"], "8": obs_path["launches"],
        "9": app_path["launches"], "10": life_path["launches"],
        "11 tagger eval": training["tagger"]["eval_launches"],
        "11 encoder": training["encoder"]["k1_launches"],
        "12": tiered_path["launches"], "13": ckpt_path["launches"],
        **{f"14 {run}": n for run, n in quant_path["launches"].items()},
        **mesh_path["launches"],
        **mrt_path["launches"],
        **mtr_path["launches"],
        **mtrain_path["launches"],
        "19": witness_path["launches"],
        "20": llama3_path["launches"],
    }
    path_launches = collections.Counter()
    for phase, counted in phase_launches.items():
        paths = sum(n for key, n in counted.items() if key.startswith("flash_attention."))
        if counted.get("flash_attention", 0) != paths:
            raise AssertionError(f"phase {phase}: K1 counted {counted.get('flash_attention', 0)} "
                                 f"launches, its paths {paths}: {counted}")
        if not _k4_split_ok(counted):
            raise AssertionError(f"phase {phase}: K4's weight and kernel modes do not sum "
                                 f"to its launches: {counted}")
        path_launches.update(counted)

    def entry(name, source, counter, timed, path=None):
        head = next(c for c in cases if c["case"] == timed)
        own = [c for c in cases if path is None or c["path"] == path]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "docqa_tpu/ops/attention.py:315",
            "launches": path_launches.get(counter, 0),
            "max_abs_err": max(c["max_abs_err_bf16"] for c in own),
            "tolerance": "bf16 |err| <= 1e-2 + 1e-2*|plain|; f32 |err| <= 5e-5",
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_live_ms": head.get("library_live_ms"),
            "gather_k1_ms": head.get("gather_k1_ms"),
            "timed_case": head["case"],
            "cases": [c["case"] for c in own],
        }

    # K1 as a whole (the wrapper's entry), then its bf16 paths
    kernels = [
        entry("flash_attention", "docqa_tpu_torch/csrc/flash_attention.cu",
              "flash_attention", "mistral_prefill"),
        entry("flash_attention.decode", "docqa_tpu_torch/csrc/flash_decode.cuh",
              "flash_attention.decode", "mistral_verify", "decode"),
        entry("flash_attention.prefill", "docqa_tpu_torch/csrc/flash_prefill.cuh",
              "flash_attention.prefill", "mistral_prefill", "prefill"),
        entry("flash_attention.decode_paged", "docqa_tpu_torch/csrc/flash_decode.cuh",
              "flash_attention.decode_paged", "mistral_paged_verify", "decode_paged"),
    ]

    def k4_entry(name, mode, kernel=None):
        own = [c for c in quant_path["cases"] if (mode is None or c["mode"] == mode)
               and (kernel is None or c["kernel"] == kernel)]
        timed = QUANT_TIMED_MODE.get(kernel, QUANT_TIMED)
        head = next(c for c in own if c["case"].startswith(timed))
        return {
            "name": name, "route": "cuda", "source": "docqa_tpu_torch/csrc/qmatmul.cu",
            # no Pallas kernel: the reference's dequantising product is XLA
            "replaces": "docqa_tpu/models/decoder.py:132",
            "launches": path_launches.get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in own),
            "tolerance": "bf16 |err| <= 1e-2 + 1e-2*|plain|; one-hot rows bit-equal",
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": "torch.matmul on the unquantised bf16 weight",
            "int_library_ms": head["int_library_ms"], "int_library": head["int_library"],
            "timed_case": head["case"], "cases": [c["case"] for c in own],
        }

    kernels += [k4_entry("qmatmul", None), k4_entry("qmatmul.int8", "int8"),
                k4_entry("qmatmul.int4", "int4"), k4_entry("qmatmul.ring", None, "ring"),
                k4_entry("qmatmul.wgmma", None, "wgmma"),
                k4_entry("qmatmul.simple", None, "simple")]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "card": smi, "torch": torch.__version__,
                "build_s": build_s, "build_logs": build_logs,
                "kernels": kernels, "cases": cases,
                "main_path": per_q, "main_path_s": main_s,
                "launches": launches, "reference": reference,
                "batcher_path": batcher_path, "batcher_path_s": batcher_s,
                "pool_path": pool_path, "pool_path_s": pool_s,
                "ingest_path": ingest_path, "ingest_path_s": ingest_s,
                "obs_path": obs_path, "obs_path_s": obs_s,
                "app_path": app_path, "app_path_s": app_s,
                "lifecycle_path": life_path, "lifecycle_path_s": life_s,
                "tiered_path": tiered_path, "tiered_path_s": tiered_s,
                "training": training, "training_s": train_s,
                "checkpoint_path": ckpt_path, "checkpoint_path_s": ckpt_s,
                "quant_path": quant_path, "quant_path_s": quant_s,
                "mesh_path": mesh_path, "mesh_path_s": mesh_s,
                "mesh_runtime_path": mrt_path, "mesh_runtime_path_s": mrt_s,
                "mesh_tiered_path": mtr_path, "mesh_tiered_path_s": mtr_s,
                "mesh_train_path": mtrain_path, "mesh_train_path_s": mtrain_s,
                "witness_path": witness_path, "witness_path_s": witness_path["phase_s"],
                "llama3_path": llama3_path,
                "replay_path": replay_path, "compile_audit": compile_report,
                "replay_compile_s": replay_s,
                "launches_by_phase": phase_launches,
            }, f, indent=1)
    print(json.dumps({"pool": {**pool_path["summary"], "phase_s": pool_s}}))
    print(json.dumps({"ingest": {
        **ingest_path["summary"], "phase_s": ingest_s,
        "launches": ingest_path["launches"],
        **{c["case"]: {key: c[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err_bf16")}
           for c in cases if c["case"] in ("ner_window_batch", "ner_served_batch")},
    }}))
    print(json.dumps({"obs": {
        key: obs_path["summary"][key] for key in (
            "recorder_pairs", "recorder_overhead", "reconcile", "spine_items",
            "launches", "profiled_verify_steps", "profiled_chunks", "spine_handoff",
            "document_spans")
    } | {"phase_s": obs_s}}))
    print(json.dumps({"app": {**app_path["summary"], "phase_s": app_s}}))
    print(json.dumps({"lifecycle": {**life_path["summary"], "phase_s": life_s}}))
    print(json.dumps({"training": {**training, "phase_s": train_s}}))
    ts = tiered_path["summary"]
    print(json.dumps({"tiered": {
        "build_s": ts["build_s"], "build_seconds": ts["build_seconds"],
        "index_bytes": ts["index_bytes"], "n_spilled": ts["n_spilled"],
        "recall": {p: {k: r[k] for k in ("recall", "ci_lo", "ci_hi", "hits", "expected",
                                         "own_row_first")}
                   for p, r in ts["recall"]["sweep"].items()},
        "exact_same_centre_share": ts["recall"]["exact_same_centre_share"],
        "latency": ts["recall"]["latency"], "probe": ts["recall"]["probe"],
        "lexical": ts["recall"]["lexical"],
        "tail": {k: v for k, v in ts["tail"].items() if k != "build_seconds"},
        "ask": {k: ts["ask"][k] for k in ("latency_p50_s", "tokens_per_s", "launches",
                                          "verify_steps", "estimate", "shadow_expected")},
        "app": ts["app"]["asks"], "reference": ts["reference"], "phase_s": tiered_s,
    }}))
    cs = ckpt_path["summary"]
    print(json.dumps({"checkpoints": {
        "bart": {k: cs["bart"][k] for k in ("params_m", "file_gb", "write_s", "read_s",
                                            "upload_s", "beam", "greedy")},
        "tiny": cs["tiny"], "minilm": {k: cs["minilm"][k] for k in ("read_s", "bit_equal")},
        "mistral": {k: cs["mistral"][k] for k in ("shard_gb", "read_s", "logits_bit_equal",
                                                  "answer_tokens", "answer_s", "eos_id")},
        "runtime": cs["runtime"], "launches": ckpt_path["launches"], "phase_s": ckpt_s,
        **{c["case"]: {key: c[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err_bf16")}
           for c in cases if c["case"].startswith("bart_")},
    }}))
    qs = quant_path["summary"]
    print(json.dumps({"quant": {
        "solo": {mode: {k: v for k, v in r.items() if k != "asks"} | {
            "verify_step_ms": [a["verify_step_ms"] for a in r["asks"]],
            "bf16_verify_step_ms": [a["bf16_verify_step_ms"] for a in r["asks"]],
            "decode_tok_s": [a["decode_tok_s"] for a in r["asks"]]}
            for mode, r in qs["solo"].items() if mode != "bf16_vs_f32"},
        "bf16_vs_f32": qs["solo"]["bf16_vs_f32"], "reference_config": qs["reference_config"],
        "pool": qs["pool"], "runtime": qs["runtime"], "host_us_a_call": qs["host_us_a_call"],
        "phase_s": quant_s,
        **{c["case"]: {key: c[key] for key in (
            "kernel", "ms", "plain_ms", "library_ms", "int_library_ms", "bound_ms",
            "bound_by", "max_abs_err")}
           for c in quant_path["cases"] if c["m"] != 2048 or c["weight"] == "w_gate"},
    }}))
    ms = mesh_path["summary"]
    print(json.dumps({"mesh": {
        **{k: ms[k] for k in ("nccl", "tokens", "engine_s", "k1_launches", "collectives",
                              "weights_shared", "topk_rows", "sequence", "step_m4_ms")},
        "phase_s": mesh_s,
        **{c["case"]: {key: c[key] for key in ("ms", "bound_ms", "bound_by", "max_abs_err")}
           | ({"plan": c["path"], "splits": c["plan"]["num_splits"]} if "path" in c
              else {"plan": c["kernel"], "splits": c["splits"]})
           for c in mesh_path["cases"]},
    }}))
    mr = mrt_path["summary"]
    print(json.dumps({"mesh_runtime": {
        "runtime": {k: v for k, v in mr["runtime"].items() if k != "first_step"}
        | {"first_step_rel_rms": mr["runtime"]["first_step"]["rel_rms_diff"]},
        "lexical": mr["lexical"], "phase_s": mrt_s,
        **{c["case"]: {key: c[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                               "bound_by", "bound_share", "max_abs_err_bf16")}
           | {"splits": c["plan"]["num_splits"]} for c in mrt_path["paged"]},
    }}))
    mt = mtr_path["summary"]
    print(json.dumps({"mesh_tiered": {
        "runtime": {k: v for k, v in mt["runtime"].items() if k != "asks"},
        "shards": mt["shards"], "phase_s": mtr_s,
    }}))
    print(json.dumps({"mesh_train": mtrain_path["summary"]}))
    print(json.dumps({"witness": {k: v for k, v in witness_path.items() if k != "launches"}}))
    print(json.dumps({"llama3": llama3_path["summary"]}))
    print(json.dumps({"replay": replay_path, "compile_audit": {
        "peaks": COMPILE_PEAKS, "steady_state": COMPILE_STEADY,
        "kernels": len(compile_report["kernels"])}, "phase_s": replay_s}))
    print(json.dumps({"launches_by_phase": {
        phase: {key: n for key, n in counted.items() if n}
        for phase, counted in phase_launches.items()}}))
    log(f"smoke: {time.perf_counter() - t_smoke:.1f} s from the card query to the kernels line")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
