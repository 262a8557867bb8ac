#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with one card and the CUDA toolkit. Phases,
each of which fails the run (non-zero exit) if it fails:

  1. card      the card's name and power limit (nvidia-smi);
  2. build     the four kernels from ``src/repro_torch/kernels/csrc``,
               one nvcc each, in parallel;
  3. corpus    the paper's full-width configuration (SearchConfig
               defaults: vocab 141 000, ~60 nnz/doc, nnz_pad 128, top_k
               16) at 2^20 synthesized documents, seed 0, resident on the
               card in each backend's layout;
  4. kernels   each kernel against its plain PyTorch version on the
               main path's inputs (the L = 8 request): integral counts
               must agree exactly; one float-valued ELL case within its
               stated tolerance; what the hashed query table of B1, B2
               and B3 holds for that request (real items, distinct ids,
               slots, run-sum columns, B1's and B2's query tile bytes on
               the card) and the share of doc words that hit;
  5. launcher  ``repro_torch.launch.search.main`` on the card;
  6. main path 8 requests (L = 1..8) through ``PatternSearchEngine.
               search`` on gpu, gpu_packed and gpu_fused, then
               ``search_streaming`` over 4 slabs of 2^18 docs, with every
               launch counter set to 0 before and read after: each
               kernel must have launched; every self-query must rank
               itself first; the three backends and the ``torch`` gather
               path must agree bit for bit, streaming with resident;
  6b. store   the 2^20 documents written to a FlashStore of 16 segments
               of 2^16 (build seconds, MB on disk, filter kind); gpu,
               gpu_packed and gpu_fused FlashSearchSessions sharing one
               4 GiB slab cache; the L = 8 request cold (16 misses
               through the prefetcher), then all 8 requests warm (16
               hits each) on a second session a backend, every result
               equal to phase 6's resident one bit for bit, with the
               launch counters set to 0 before and read after (each of
               B1-B3 must have launched; these launches join phase 6's
               in the kernels line); cold and warm ms, segments_skipped,
               the stage_ms histograms (decode, upload, score,
               prefetch_wait, merge), the cache's device bytes beside
               the growth of torch.cuda.memory_allocated; one approx
               request (candidates 64) on each backend and on ``torch``,
               agreeing bit for bit with docs_scored far below 2^20;
               AutoTiling's doc tiles at nnz_pad 64-512 and L buckets
               1-8 staged whole in B3's shared memory, and a 2^16-doc
               gpu_fused engine with AutoTiling at nnz_pad 512 equal to
               its FixedTiling twin; B1-B3 against their plain versions
               at D = 8, 64 and 1000, B3 at block_docs 8, 32 and 128;
  6c. live     phase 6b's store served while it grows, with every launch
               counter set to 0 before and read after (each of B1-B3 must
               have launched; these launches join the kernels line): a
               gpu session with ``enable_ingest(seal_docs=256)`` serves
               16 client threads x 32 L = 1 self-queries of base documents
               through ``session.submit`` (max_batch 8, max_delay_ms 2)
               while a writer thread appends 4096 new documents (at least
               16 seals and one compactor fold); every served result ranks
               its document first at its resident score (phase 6's engine)
               bit for bit. Then, the memtable flushed and 2 documents
               appended, 8 self-queries (3 base, 3 sealed appends, 2 in
               the memtable) through ``submit`` on a gpu, a torch, a
               gpu_packed and a gpu_fused session in turn (the write path
               handed on: each replays the WAL), each equal to its own
               serial ``search`` and to gpu's bit for bit; on each kernel
               backend the serial search launches one kernel a scored
               segment plus one for the memtable. 100 more appends left
               unsealed, the session closed without sealing, the store
               reopened: the WAL replays 100 and the last document ranks
               itself first. Then ``repro_torch.launch.search_serve.main``
               on the store (``--ingest 4096 --backend gpu``). It prints
               QPS, latency p50/p99, batches, occupancy, flush reasons,
               appends/s, seals, folds, seal and fold ms, replay seconds,
               the stage_ms histograms, the memtable's score (from the
               traces' spans) apart from a segment's, and its wall time
               beside the card's name and power limit. The live
               telemetry plane runs through the serving under writes:
               the session's ``start_telemetry`` with the stock store
               SLOs (250 ms) and a profile directory, a scraper thread
               GETting /metrics, /healthz, /slo and /debug/traces in
               turn every 50 ms, every answer 200 (the body printed
               otherwise), and one /debug/profile?ms=500 under the load,
               whose trace must name B1's kernel and hold CPU ops of a
               thread other than the HTTP one; the phase's stderr must
               not hold Kineto's ``External init callback`` error. It
               prints scrapes by route and code, scrape ms p50/p99 by
               route, /metrics bytes, the capture's size, kernel launches
               and threads, and each objective's state, burn rate and
               window events; ``search_serve`` adds ``--telemetry-port 0
               --slo-ms 250 --profile-dir build/profile``;
  6d. cluster  the 2^20 documents as a ShardedStore of 4 shards x 2
               replicas (hash policy, segments of 2^16; build seconds, MB
               on disk, documents a shard) under ``build/cluster/``,
               removed at the end, with every launch counter set to 0
               before and read after: a gpu FlashClusterSession on a 4 GiB
               slab cache takes the L = 8 request cold, then all 8
               requests warm, each equal to phase 6's resident result bit
               for bit (cold and warm ms, skip rate, cache hits, the
               router's worker count, per-shard launch keys); the same 8
               requests on a gpu_packed and a gpu_fused cluster session;
               16 client threads x 32 L = 1 self-queries through
               ``submit`` (max_batch 8, max_delay_ms 2), each ranking its
               document first at its resident score bit for bit (QPS,
               p50/p99); shard 0's primary replaced by a session that
               raises (same result, one failover, the replica marked
               down, then health reset); shard 1's primary held on an
               event until the call returns, with HedgePolicy(fallback_ms
               1, min_ms 0) (same result, a hedge fired and won, nothing
               marked down) and then, hedging off, under a deadline with
               allow_partial (flagged partial, shards_missing (1,), equal
               to the merge of the other three shards); 512 documents
               appended through the cluster (seal_docs 256) and flushed,
               each ranking itself first; ``repro_torch.launch.
               search_serve.main`` with ``--cluster --hedge-percentile
               0.95 --allow-partial`` (QPS, p50/p99, hedges fired and
               won, stage histograms). B1-B3 must each have launched, one
               launch a slab that any replica attempt scored; where no
               hedge loser or straggler ran, exactly the sum of scored
               segments that ClusterStats reports. The gpu session's
               ``start_telemetry()``: /healthz ok before the failover,
               degraded with replicas_down 1 once shard 0's primary is
               marked down, ok after the health reset, and a scraper
               answered 200 throughout the 16-client load. It prints its
               wall time beside the card's name and power limit;
  7. times     each search kernel, its plain version and the library
               yardstick (torch.sparse.mm, CSR [D, V] x dense [V, L]) by
               CUDA events, median of repeats, beside the bound the card's
               memory rate puts on the same bytes;
  8. attention flash attention (B4) against its plain version at the
               qwen2-0.5b prefill shape (B 4, S 1024, 14 heads over 2 kv
               heads, hd 64) in bf16 (its wgmma instance) and f32 (its
               simt instance), non-causal, and at an S that no tile
               divides; each case must count under the instance that
               ``fa.design`` names; bf16 within ATTN_TOL and, beside it,
               within ATTN_ROW_TOL of each output row's largest entry;
  9. LM path   ``repro_torch.launch.serve.main``: qwen2-0.5b at full width
               (24 layers, d_model 896, vocab 151 936) from seed 0 in bf16,
               4 prompts of 1024 random tokens, 32 greedy tokens, with the
               launch counts set to 0 before and read after: B4 must have
               launched once a layer (24), all 24 on the wgmma instance;
               then the same call again, warm, for the prefill and decode
               times;
 10. LM checks the model with prefill attention by the kernel and then by
               its plain version, same weights and prompts, first in bf16
               (the main path's weights; the wgmma instance) within
               lm_atol (0.1, or six bf16 ulps at the largest logit where
               that is more), then in f32 (the simt instance) within
               LM_ATOL["float32"]: last-position prefill logits within the
               tolerance, and the greedy tokens equal or, at the first
               difference, the plain path's top-2 margin below it;
 11. B4 times  the kernel, its plain version and the library yardstick
               (scaled_dot_product_attention, causal, GQA) by CUDA events
               at the prefill shape (kernel and library as CUDA-graph
               replays of 10 calls, so no host time between launches;
               eager calls printed beside), beside its bound: causal
               FLOPs 2·B·H·S²·hd over the bf16 tensor-core peak, or the
               bytes of q, k, v and o over the memory rate, the larger.
 8b-11b. hd 128, phases 8-11 again for the Qwen3 family and internlm2:
               B4 at qwen3-4b's prefill shape (B 4, S 1024, 32 heads over
               8, hd 128) against its plain version as in 8; qwen3-4b
               (36 layers) and internlm2-20b (48) at full width and depth
               through ``serve.main``, and qwen3-moe-235b-a22b at full
               width cut to 8 of 94 layers through ``M.init`` and
               ``step.generate`` (what ``serve.main`` calls), each with
               the launch counts set to 0 before and read after (B4 once
               a layer, all wgmma), in-vocab tokens equal on warm calls,
               and, for the MoE, the tokens each layer dropped by
               capacity in prefill and decode; each against plain
               attention in bf16 as in 10, the MoE's plain run holding the
               kernel run's routing, a flip of it allowed only below the
               logits' limit (lm_atol); f32 at 4 (qwen3-4b) and 2
               (qwen3-moe) layers; B4's hd-128 times as in 11. Each phase
               prints its wall time.
 8c-11c. hd 256 and the sliding window, for gemma3-4b and kimi-k2: B4
               at gemma3's prefill shape (B 4, S 2048, 8 heads over 4,
               hd 256) against its plain version, bf16 (wgmma) and f32
               (simt), causal global and causal with its window of 1024
               (prompts of two windows, so the band bites); gemma3-4b at
               full width and depth (34 layers: 29 local, 5 global)
               through ``serve.main`` with 4 prompts of 2048 tokens, B4
               once a layer, all wgmma, 29 of them windowed; against
               plain attention in bf16 and, at 6 layers (one whole 5:1
               superblock), in f32; kimi-k2 at full width cut to 2 of 61
               layers (its dense lead of d_ff 18 432 and one MoE layer of
               384 experts, top-8, a shared expert) through ``M.init``
               and ``step.generate``, 4 prompts of 1024 tokens, B4 at hd
               128 once a layer, per-layer capacity drops, bf16 against
               plain attention with routing replayed (no f32: its MoE
               layer alone is ~68 GB in f32); B4's hd-256 times, global
               and windowed, beside their bounds (the band's pairs only)
               and SDPA (causal; a boolean band mask, its backend named).
               Each phase prints its wall time, and the run its total.
 8d-11d. the recurrent archs, rwkv6-7b and zamba2-1.2b: B4 at zamba2's
               prefill shape (B 4, S 1024, 32 heads over 32, hd 64: G = 1,
               full multi-head) against its plain version as in 8;
               rwkv6-7b (32 layers, the WKV scan, no attention) and
               zamba2-1.2b (38 Mamba-2 layers, the SSD scan, and a shared
               attention block at 6 sites) at full width and depth
               through ``serve.main``, 4 prompts of 1024 tokens (16 chunks
               of 64), 32 greedy tokens, with the launch counts set to 0
               before and read after: B4 6 times a zamba2 prefill, all
               wgmma, and never for rwkv6; in-vocab tokens equal on warm
               calls; prefill and decode ms and, from one profiled
               prefill and IDLE_DECODE_STEPS decode steps, the card's idle
               share; zamba2 against plain attention in bf16 (logits
               within ZAMBA_ULPS bf16 ulps, and B4 at each of the 6 sites
               against its plain version on the model's own q, k, v
               within phase 8's limits) and at 12 layers (two sites) in
               f32; for both, the recurrent rule of
               ``tests/test_recurrent_consistency.py`` (a prefill over
               S+1 tokens ends in the logits of a prefill over S and one
               decode step): in f32 within 1e-3 at full depth (S 63) and
               at 4 layers with S 1024 (the S+1 prefill in 25 chunks of
               41), in bf16 within that test's rtol 3e-2 and atol 5e-2 at
               4 layers (S 63) and within lm_atol at full depth (S 63);
               rwkv6 in f32 at 4 layers with chunks of 16 against 64
               within 1e-3; B4's times at zamba2's shape beside its bound
               and SDPA (causal). Each phase prints its wall time.
 8e-11e. the multimodal archs, musicgen-medium and llama-3.2-vision-90b:
               B4 at musicgen's prefill shape (B 4, S 1024, 24 heads over
               24, hd 64: G = 1) as in 8, and at keys of their own length
               (cross-attention, non-causal): the VLM's q [4, 1024, 64,
               128] over the image's k, v [4, 1600, 8, 128] in bf16
               (wgmma) and f32 (simt), one query over 1600 keys (a decode
               step) in both, and 1000 keys (no 64-key tile divides), each
               within phase 8's limits; musicgen-medium at full width and
               depth (48 layers) and the VLM at full width cut to 4 of its
               20 superblocks (16 self-attention and 4 cross-attention
               layers, ~38 GB) through ``M.init`` and ``step.generate``
               (``serve.main`` refuses both: frame embeddings, and ROADMAP
               C21), the VLM with seeded bf16 image embeddings [4, 1600,
               8192] (normal x 0.02); launch counts set to 0 before and
               read after: B4 48 times for musicgen (prefill only) and 144
               for the VLM (16 + 4 in the prefill, 4 in each of 31 decode
               steps), all wgmma; warm calls as in 9; each against plain
               attention (self and cross) in bf16 as in 10 and in f32 at
               12 layers (musicgen) and one superblock (the VLM, f32
               image embeddings on the simt instance); musicgen's own
               path, a prefill on seeded frame embeddings [4, 1024, 1536]
               and 8 decode steps on [4, 1, 1536] through ``make_prefill``
               and ``make_decode_step`` (B4 48 times, all in the
               prefill), against plain attention; B4's times at both
               shapes beside their bounds and SDPA (causal; non-causal
               with GQA). Each phase prints its wall time.
 12. graph     GraphBLAS (``repro_torch.core.graphblas``, plain PyTorch)
               on a graph of 2^20 vertices and 2^24 edges, in-neighbours
               uniform from seed 0, as an incoming-edges ELL on the card:
               PageRank (50 iterations, damping 0.85) sums to 1 within
               1e-3 and equals the same call on the CPU within rtol 1e-5;
               BFS levels from vertex 0 (32 iterations) equal a numpy BFS
               exactly; ms a PageRank iteration beside its bytes bound,
               and the phase's wall time.
 13. train     training on the card. B4 with its log-sum-exp (f32 [B, H,
               S], for the backward) at qwen3-4b's training shape (B 4,
               S 1024, 32 heads over 8, hd 128) in bf16 (wgmma) and f32
               (simt), and at S 1000: the lse within LSE_TOL of the plain
               version's, the output bit for bit the null-lse call's and
               within phase 8's limits; the training attention
               (``layers.blockwise_attention``'s autograd Function: B4
               forward with its lse, the plain backward) at the same
               shape against autograd through f32 softmax attention,
               dq, dk, dv within GRAD_TOL (relative norm) in f32 and
               bf16, and a planted fault (a key tile dropped for half
               the rows) beyond the bf16 limit; qwen3-4b at full width
               and depth (4.02 B params, bf16, f32 AdamW states, remat
               minimal) for 3 steps at 4 x 1024 Zipf tokens through
               ``repro_torch.launch.train.main``, with the launch counts
               set to 0 before and read after: B4 72 times a step (the
               forward and remat's recompute of 36 layers), all wgmma,
               all with the lse; finite losses, each step's loss, grad
               norm and ms, step ms (median of steps 2-3), tokens/s, MFU
               against 989 TFLOP/s (6 N T + 3 x the causal attention
               forward), max_memory_allocated; its first step again with
               plain attention: loss within lm_atol of the logits, grad
               norm within GNORM_RTOL; a restart check (qwen2-0.5b at 4
               of 24 layers, full width, int8 states, 4 x 1024): 4
               straight steps against 2, a restore from the checkpoint
               written under ``build/train/`` (removed after) and 2
               more, params, m and v bit for bit; B4's time with and
               without its lse beside its plain version, its bound and
               SDPA's forward.
 14. train     the recurrent archs train on the card. B4 with its lse
     recurrent at zamba2's training shape (B 4, S 1024, 32 heads over
               32, G = 1, hd 64) in bf16 and f32, and the training
               attention's dq, dk, dv there, as in 13 (a planted fault
               caught in bf16); rwkv6's WKV backward at one rwkv6-7b
               layer's time-mix (B 4, T 1024, 64 heads of 64, on the
               layer's own r, k, v, lw and u from seeded tokens):
               ``WKVChunked``'s gradients against plain autograd a chunk
               at a time within WKV_GRAD_TOL, its backward twice bit for
               bit, the peak memory of both, the Function's under
               WKV_PEAK_D x D_BYTES plus what it saves; rwkv6-7b at full
               width and depth (7.5 B params, int8 AdamW states) and
               zamba2-1.2b (f32 states) for 3 steps each at 4 x 1024
               Zipf tokens through ``launch.train.main``, launch counts
               set to 0 before and read after: none of B4 for rwkv6, 6 a
               step for zamba2 (one a shared-attention site), all wgmma
               with the lse; finite losses, each step's loss, grad norm
               and ms, step ms (median of steps 2-3), tokens/s, MFU at 6
               N T (zamba2's shared block counted once a site; the
               scans' own FLOPs not counted), max_memory_allocated;
               zamba2's first step again with plain attention (loss
               within lm_atol at ZAMBA_ULPS, grad norm within
               GNORM_RTOL); B4's times at zamba2's training shape.
 15. mesh      the search engine on a mesh, run right after 6b (it reads
               6b's store before 6c grows it), with B1's and B2's launch
               counts set to 0 before and read after, the ranks' own
               included (they join the kernels line). 15a: a world of
               one rank over NCCL, a 1 x 1 ("data", "model") mesh; gpu
               and gpu_packed engines on the 8 requests, each result bit
               for bit phase 6's (tree_topk and the model gather run on
               the card), and the L = 8 request's ms and parts as in
               15b. 15b: four ranks (``mesh_rank``, spawned after
               the parent built the kernels) of a 2 x 2 mesh on this one
               card over gloo, the world's group with a MESH_TIMEOUT_S
               timeout:
               NCCL refuses two ranks on one GPU, so the [L, k] lists
               cross the host here. Each rank maps phase 6's corpus
               (saved once under ``build/mesh/``, removed after) and
               uploads its 2^19 rows; gpu and gpu_packed at L = 8 and
               L = 3 (a bucket of 4, 2 columns a rank) bit for bit phase
               6's results on every rank; ``tree_topk_ppermute`` equal to
               ``tree_topk`` on the rank's own candidates; a
               ``FlashSearchSession`` over 6b's store (rows 2, slabs of
               2^16) bit for bit 6b's L = 8 result; gpu_fused raises.
               Per rank: B1 and B2 launches (each > 0), upload seconds,
               the median ms of MESH_WARM warm L = 8 requests a backend
               and of their parts (``mesh_times``: the host merge; the
               rank's uploads, kernel and top-k; the reduction), the
               session's cold ms, beside the card's name and power
               limit. 15c, the search service on a mesh (rank 0 leads
               each coalesced batch and the live snapshot, the others
               follow, ``distributed/lockstep.py``): in 15a's world of
               one rank over NCCL, a ``FlashSearchSession`` over 6b's
               store serves the 8 requests' rows through
               ``session.submit``, bit for bit phase 6's; then 15b's
               four ranks (``mesh_serve``) over a copy of 6b's store
               under ``build/mesh/`` (removed after): a gpu_packed
               service, read-only, serves the 8 requests' rows (bit for
               bit phase 6's); rank 0 of a gpu session with
               ``enable_ingest(seal_docs=MESH_SEAL_DOCS)`` serves
               MESH_CLIENTS x MESH_REQUESTS L = 1 self-queries through
               ``submit`` (max_batch 8, max_delay_ms 2) while a writer
               thread appends MESH_APPENDS documents (at least 4 seals
               and a compactor fold), every top-1 its own document at
               phase 6's resident score bit for bit; after a flush 2
               appended documents' queries, bit for bit a
               single-device session over the same store. Per rank, B1
               and B2 launches (each > 0, joining the kernels line),
               batches scored, the record broadcast's ms, the
               collectives' share of the rank's serving time
               (``compat.stats``); rank 0's served p50, p99 and QPS;
               the phase's wall time.
 16. LM mesh   LM serving on a mesh (``lm_mesh_phase``). The
               one-device run first: qwen3-4b at full size, LM_BATCH
               prompts of LM_PROMPT, MESH_LM_NEW greedy tokens, each
               step's logits kept. 16c: a world of one rank over NCCL,
               served through ``repro_torch.launch.serve.main --mesh 1,1
               --dist-backend nccl`` (a 1 x 1 DeviceMesh, the weights
               born sharded by ``sharding.sharded_init``): every step's
               logits bit for bit the one-device run's. 16a, qwen3-4b
               at MESH_LM_LAYERS of 36 layers (``--layers``) against one
               device at that depth: four ranks
               (``lm_mesh_rank``, spawned after the parent built the
               kernels, a MESH_TIMEOUT_S group timeout) of a 2 x 2 mesh
               on this card over gloo (NCCL refuses two ranks on one GPU,
               ROADMAP C24), each serving through ``launch.serve.main
               --mesh 2,2 --dist-backend gloo``: logits within lm_atol of
               the one-device run's and tokens equal wherever its top-2
               margin exceeds that, every rank's tokens equal. 16b:
               qwen3-moe at MESH_MOE_LAYERS layers on a 1 x 4 mesh (32 experts
               a rank, the all_to_all over four ranks; served through
               ``step.generate``, as phase 9b serves it, since the
               launcher takes no depth cut): each rank's first MoE block
               equal to ``moe.dispatch_simulated`` on its gathered input
               within two bf16 ulps; a prefill at NO_DROP_CF (nothing
               dropped, on either side; one device's routing replayed, as
               10b's lm_check replays it) within lm_atol of one device's
               last-position logits, every token-layer where the mesh's
               own router chose another expert set at a routing margin
               below that limit (10b's rule), and the pass's first MoE
               block within MOE_PLAIN_ULPS bf16 ulps of ``moe_plain``, a
               loop over the experts that shares no code with the port.
               Per rank, beside the card's name and power limit: the
               weight blocks' GB and draw seconds, prefill ms and decode
               ms a step, the collectives' ms and bytes in prefill and a
               decode step (``compat.stats``), B4's launches (each > 0;
               they join the hd-128 row of the kernels line) and B4 on
               the rank's first site's own q, k and v against its plain
               version. 16d (``families_phase``): the other four
               families at full width, MESH_FAMILY_RUNS: rwkv6-7b at 4
               of 32 layers through ``step.generate``, zamba2-1.2b at 12
               of 38 layers through ``launch.serve.main --mesh``,
               musicgen-medium at 16 of 48 layers on
               seeded frame embeddings through ``make_prefill`` and
               ``make_decode_step`` (as 9e), each on 2 x 2, and
               llama-3.2-vision-90b at 1 of 20 superblocks on 1 x 4 (8
               kv heads over 4, no FSDP gathers at data 1) through
               ``step.generate`` with seeded image embeddings; and, as
               the recurrent archs' sharp checks, rwkv6-7b at
               RULE_F32_LAYERS and zamba2-1.2b at ZAMBA_F32_LAYERS in
               f32 through ``step.generate`` (held to 1e-3);
               MESH_FAMILY_NEW greedy tokens each. Each on one device,
               then on a world of one rank over NCCL, every step's
               logits bit for bit the one-device run's; then one spawn
               of four ranks (``lm_family_rank``, a DeviceMesh for each
               shape over the same world) serves them all in turn:
               logits within lm_atol of one device's (the recurrent archs
               at MESH_FAMILY_ULPS), tokens equal wherever its top-2
               margin exceeds that, every rank's tokens equal, every
               rank's B4 launches ``b4_per_generate`` at its depth (none
               for rwkv6), B4 on the rank's first site and first cross
               site (the VLM's, Sk != S) against its plain version, and
               the same numbers a rank as 16a-16b; its launches join the
               G = 1, musicgen, hd-128 and Sk != S rows.

 17. train     training on a mesh (``mesh_train_phase``), run last.
     mesh      17c: a world of one rank over NCCL, qwen3-4b at full size
               for TRAIN_STEPS steps through ``launch.train.main --mesh
               1,1 --dist-backend nccl``: losses, grad norms and the final
               params' f64 leaf sums bit for bit 13c's. 17a: qwen3-4b at
               full width and MESH_TRAIN_LAYERS layers, f32 AdamW states,
               remat, TRAIN_BATCH x TRAIN_SEQ, on one device for
               MESH_TRAIN_STEPS steps and one more; then one spawn of four
               ranks (``mesh_train_rank``) on this card over gloo trains
               MESH_TRAIN_RUNS in turn through ``launch.train.main
               --mesh``: 17a on 2 x 2, each step's loss and grad norm
               within MESH_TRAIN_RTOL of one device's, every rank's
               equal, B4 2 x layers x steps times a rank (wgmma, with
               the lse), its
               first site against the plain version with the lse, the
               optimizer-state blocks as ``opt_state_specs`` lays them
               out, and a checkpoint after the last step (full arrays,
               gathered onto rank 0, which writes) restored on one device,
               whose next step is held to one device's the same way; 17b
               at COMP_TRAIN_LAYERS layers on (pod, data, model) =
               COMP_TRAIN_SHAPE with ``--grad-compression``: each step's
               compressed mean within the quantization bound of the exact
               f32 pod mean (``compressed_held``), the error feedback
               g + err - dequant(quant(g + err)) bit for bit, the pod
               reduction's wire bytes against f32's. 17d, in the same
               spawn after 17b: the ssm, hybrid, audio and vlm families
               at full width, FAMILY_TRAIN_RUNS (rwkv6-7b at 2 layers
               with int8 states, zamba2-1.2b at 12, musicgen-medium at
               12, each on 2 x 2; llama-3.2-vision-90b at one superblock
               on 1 x 4, batch 1, int8 states), 2 steps each, and
               rwkv6 at 2 and zamba2 at 6 layers in f32, a step, each
               through ``launch.train.main --mesh``, one device
               first: every rank's losses and grad norms within
               FAMILY_TRAIN_RTOL (else MESH_TRAIN_RTOL) of one device's,
               the ranks' losses equal, B4's launches a rank
               (``family_train_b4``: none for rwkv6, a site a step for
               zamba2's shared block, two a layer a step otherwise), its
               first site and the VLM's first cross site (Sk 1600 != S)
               against the plain version with the lse, the state blocks.
               Per rank: step ms, the collectives' ms, bytes and share,
               the weight blocks' GB. B4 with its lse timed at a rank's
               shape and at the VLM's cross shape on a rank; the ranks'
               launches are the ``flash_attention_train_rank`` (hd 128)
               and ``flash_attention_train_cross_rank`` rows, zamba2's and
               musicgen's join ``flash_attention_train_g1``, 17c's
               ``flash_attention_train``.

 18. perf      the reference's perf flags (``models/perfcfg``) on the
     flags     mesh path and the dry run (``perf_phase``, after 17).
               18a: B4 at a rank's sequence rows (``seq_shard_attn``):
               qwen2-0.5b's q [4, 256, 14, 64] over k, v [4, 256 (r +
               1), 2, 64] at ``q_offset`` 256 r for r = 0..3, bf16
               (wgmma) and f32 (simt), and gemma3's hd-256 windowed
               instance at offset 1024, with and without the lse: each
               rank's rows bit for bit the full causal call's, and
               within phase 8's limits of the plain version; the last
               rank's time beside the bound (``attention_flops``), the
               plain version and SDPA with the equivalent boolean mask
               (the ``flash_attention_seq_rank`` row). 18b, on phase
               17's four ranks after 17d (``seq_mesh_run``): qwen2-0.5b
               at full width and SEQ_LAYERS layers on 1 x 4 (14 heads do
               not divide 4), served through ``step.generate`` (4 x
               1024, SEQ_NEW tokens) with the flags off, then with
               ``seq_shard_attn`` and ``sp_residual``, and trained a
               step each way through ``launch.train.main --mesh 1,4``:
               logits within lm_atol of each other and of one device's,
               B4's offset launches (SEQ_LAYERS a prefill, twice that a
               training step, on model ranks 1-3; the row's launches),
               the step's loss and grad norm within MESH_TRAIN_RTOL,
               each rank's collective bytes by op and axis. 18c, on
               16b's ranks after its main path (``a2a_prefill``):
               prefills under the ``a2aint8`` variant, with the router's
               own choices and with one device's routing replayed at
               NO_DROP_CF: each rank's first MoE block (input bit for
               bit 16b's) within 16b's two bf16 ulps of
               ``moe.dispatch_simulated`` under the flag, each rank's
               rows quantized twice a MoE layer a prefill; the reference
               test's rule (mean |Δ| / mean |base| < A2A_RULE) read, not
               gated, against the flag off and between the mesh's and
               one device's passes under the flag (it holds at the smoke
               configs' width, not at 128 experts of 4096: ROADMAP C30). 18d: the dry run
               (``launch/dryrun.py``) on the meta device, in a process
               of its own started before phase 8 (``dry_child``, one
               thread, no card visible): 17a's
               configuration on each of its ranks, whose collective
               bytes and calls a step equal 17a's ranks' exactly and
               whose weight blocks equal theirs, the peak printed beside
               17a's max_memory_allocated; then qwen3-4b ``train_4k``
               on the single and kimi-k2 ``train_4k`` on the multi
               production mesh, with the seconds each took.

It prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true,
"device": {...}}``. Without a card, or without the repo beside it, it
exits non-zero and prints no result.
"""
import atexit
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_DOCS = 1 << 20
N_SLABS = 4
SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
F32_OPS_PER_S = 67e12                # H100 SXM float32, outside tensor cores
BF16_OPS_PER_S = 989e12              # H100 SXM bf16 tensor cores, dense
FLOAT_RTOL = 1e-5
LM_ARCH = "qwen2-0.5b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
# B4 against its plain version: sums in another order (f32); outputs
# rounded to bf16, 8 bits (tests/test_flash_kernel.py's tolerances)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# bf16 beside it, per output row (one (b, s, h) vector of hd entries):
# max |kernel - plain| over the row's max |plain|. Both round the same
# f32 value, summed in another order, to 8 bits, so an entry may differ
# by one bf16 ulp of itself, at most 2^-7 of the row's largest entry;
# the limit is two such ulps. A query row's output is ~0.05-0.2 where
# 3e-2 would pass a kernel that dropped a 64-key tile of it.
ATTN_ROW_TOL = 2.0 ** -6
# the model with the kernel against the same model with plain attention.
# f32: 24 layers carry each attention's ~1e-6 relative difference.
# bf16: outputs keep 8 bits, so kernel and plain round ~1 in 10^3 entries
# of an attention output the other way (one ulp, 2^-8 relative); random
# weights do not damp that, and 24 layers carry it into every later
# rounding: a few bf16 ulps of the logits (one ulp is 1.6e-2 at |logit|
# 2-4), so 0.1, ~3% of the logits' scale; a wrong tile or mask moves
# them by O(1).
LM_ATOL = {"float32": 1e-3, "bfloat16": 0.1}
# ... in bf16, 0.1 is six bf16 ulps at qwen2's |logit| 2-4 (2^-6 each;
# its max is 2.77); where the plain run's logits reach past 4 (qwen3-4b,
# internlm2 and qwen3-moe: 4.9-5.1), an ulp is 2^-5 and the limit is six
# of them (lm_atol); 48 layers (internlm2) carry more roundings than 24
LM_ULPS = 6
# musicgen-medium's 48 layers at G = 1 keep LM_ULPS and need no site
# check: its logits move 5.86e-02 from kernel against plain attention
# and as much from one-ulp flips of plain attention at the kernel's rate
# (1.43e-3 of its outputs), while the three planted faults move them
# 0.172, 0.234 and 0.641, all past the limit of 0.1
# (benchmarks/port_attention_faults.py --arch musicgen-medium, H100)
# ... but zamba2's bf16 logits (38 Mamba-2 layers behind 6 attention
# sites) move 8.3 ulps from kernel against plain attention, and 8.5 from
# plain attention with one-ulp flips at the kernel's own rate (1.4e-3 of
# its outputs), while the planted faults move them 8.7-12.3 ulps
# (benchmarks/port_attention_faults.py --arch zamba2-1.2b, H100): the
# logits cannot tell a fault from rounding there, so their limit is 12
# ulps, and the sharp checks are B4 at each site on the model's own
# inputs (``site_checked``, which flags every planted fault) and f32
ZAMBA_ULPS = 12
# phases 8b-11b: B4 at head dim 128 and the archs it serves
LM128_ARCHS = ("qwen3-4b", "internlm2-20b")   # full width and depth
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 8  # full width, 8 of 94 layers
LM128_F32_LAYERS = {"qwen3-4b": 4, "qwen3-moe-235b-a22b": 2}
# phases 8c-11c: B4 at head dim 256 with the sliding window (gemma3), and
# kimi-k2's leading dense layer ahead of its MoE layers
GEMMA_ARCH = "gemma3-4b"               # full width and depth, 34 layers
GEMMA_PROMPT = 2048                    # two windows: the band bites
GEMMA_F32_LAYERS = 6                   # one whole 5:1 superblock
KIMI_ARCH, KIMI_LAYERS = "kimi-k2-1t-a32b", 2  # the dense lead + 1 MoE
# phases 8d-11d: the recurrent archs, at full width and depth
RWKV_ARCH, ZAMBA_ARCH = "rwkv6-7b", "zamba2-1.2b"
ZAMBA_F32_LAYERS = 12                  # two shared-attention sites
RULE_F32_LAYERS = 4                    # the rule at S 1024 (f32), bf16
RULE_CHUNK = 41                        # 1025 = 25 x 41: the S+1 prefill
RULE_BF16_PROMPT = 63                  # S and S+1 each one chunk (bf16,
#                                        and f32 at full depth)
RULE_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (3e-2, 5e-2)}  # rtol, atol
CHUNKS = (16, 64)                      # rwkv6's chunk-size invariance
# phases 8e-11e: the multimodal archs
MUSICGEN_ARCH = "musicgen-medium"      # full width and depth, 48 layers
MUSICGEN_F32_LAYERS = 12
EMBEDS_DECODE_STEPS = 8                # decode steps on frame embeddings
VLM_ARCH = "llama-3.2-vision-90b"      # full width, 4 of 20 superblocks
VLM_SUPERBLOCKS, VLM_F32_SUPERBLOCKS = 4, 1
NONDIVIDING_SK = 1000                  # keys that no 64-key tile divides
IDLE_DECODE_STEPS = 8                  # decode steps profiled for idle share
STORE_SEGMENT_DOCS = 1 << 16           # 16 segments of the 2^20 documents
STORE_CACHE_BYTES = 4 << 30            # room for every backend's 16 slabs
APPROX_CANDIDATES = 64
STAGES = ("decode", "upload", "score", "prefetch_wait", "merge")
STORE_ROOT = Path(__file__).resolve().parent / "build" / "store"
LIVE_CLIENTS, LIVE_REQUESTS = 16, 32   # phase 6c's serving load
LIVE_APPENDS = 4096                    # ... and its writer's
LIVE_SEAL_DOCS = 256
LIVE_REPLAY = 100
LIVE_CACHE_MB = 4000                   # search_serve's slab cache
CLUSTER_ROOT = Path(__file__).resolve().parent / "build" / "cluster"
CLUSTER_SHARDS, CLUSTER_REPLICAS = 4, 2  # phase 6d's ShardedStore
CLUSTER_CLIENTS, CLUSTER_REQUESTS = 16, 32
CLUSTER_APPENDS, CLUSTER_SEAL_DOCS = 512, 256
TELEMETRY_ROUTES = ("/metrics", "/healthz", "/slo", "/debug/traces")
SCRAPE_EVERY_S = 0.05                  # the scraper's pace, ~20 GETs a second
PROFILE_MS = 500                       # phase 6c's /debug/profile capture
PROFILE_ROOT = Path(__file__).resolve().parent / "build" / "profile"
B1_TRACE_NAME = ("table_kernel", "EllDocs")  # B1's kernel in a CUDA trace
KINETO_THREAD_ERROR = "External init callback"
MESH_ROOT = Path(__file__).resolve().parent / "build" / "mesh"
MESH_SHAPE = (2, 2)                    # phase 15b: ("data", "model") ranks
MESH_TIMEOUT_S = 120                   # a diverged rank fails, never hangs
MESH_WARM = 10                         # warm L = 8 requests timed a rank
MESH_CLIENTS, MESH_REQUESTS = 8, 8     # 15c: L = 1 self-queries a client
                                       # (cut from 16 for phase 18's time)
MESH_APPENDS = 1024                    # 15c: the writer's documents ...
MESH_SEAL_DOCS = 256                   # ... sealed 256 at a time
MESH_CACHE_BYTES = 1 << 30             # a rank's 16 ELL slabs, 512 MiB
# phase 16: LM serving on a mesh, four ranks on this one card over gloo
MESH_LM_ARCH = "qwen3-4b"              # 16a and 16c: full width and depth
MESH_LM_SHAPE = (2, 2)                 # 16a: ("data", "model")
MESH_LM_LAYERS = 8                     # 16a: 8 of 36 layers (cut from
                                       # 36 for phase 17's time, from 12
                                       # for 17d's)
MESH_MOE_SHAPE = (1, 4)                # 16b: 32 of 128 experts a rank
MESH_MOE_LAYERS = 4                    # 16b: 4 of 94 layers (cut from
                                       # 8 for 17d's time)
MESH_LM_NEW = 4                        # greedy tokens a run (cut from 8
                                       # so that the run keeps inside
                                       # ~1000 s with 15c)
NO_DROP_CF = 2.0                       # 16b: no assignment drops (checked)
MOE_PLAIN_ULPS = 8                     # 16b: top_k bf16 adds in another order
# 16d: the other four families at full width, (label, arch, mesh, layers
# (None: all), route, dtype); the depths are cut only so that gloo's
# host-borne collectives (~0.25-0.4 GB/s a rank, PERF.md section 5) fit
# the run (zamba2 from 38 layers to 12, two sites, and musicgen from 48
# to 16, for 17d's time). The f32 runs are the recurrent archs' sharp
# checks (below)
MESH_FAMILY_RUNS = (
    ("ssm", "rwkv6-7b", (2, 2), 4, "generate", "bfloat16"),  # cut from 8
    ("hybrid", "zamba2-1.2b", (2, 2), 12, "launcher", "bfloat16"),
    ("audio", "musicgen-medium", (2, 2), 16, "embeds", "bfloat16"),
    ("vlm", "llama-3.2-vision-90b", (1, 4), 4, "generate",  # 1 superblock
     "bfloat16"),
    ("ssm-f32", "rwkv6-7b", (2, 2), RULE_F32_LAYERS, "generate", "float32"),
    ("hybrid-f32", "zamba2-1.2b", (2, 2), ZAMBA_F32_LAYERS, "generate",
     "float32"),
)
MESH_FAMILY_NEW = 2                    # greedy tokens a 16d run (cut
                                       # from 4, as MESH_LM_NEW)
# 16d's bf16 limit against one device, in ulps (lm_atol): a mesh rounds
# each row-parallel product's partials to bf16 before their f32 sum (as
# the reference's partitioner does), and its GEMMs run on other row
# counts, where one device rounds once; the recurrent archs carry those
# roundings through their states. On an H100 rwkv6's 8 layers read 7.5
# ulps and zamba2's 38 Mamba layers 27 (0.8438 at |logit| 4-8), against
# one device's 8.3 for kernel against plain attention. So their bf16
# logits catch only gross faults; the sharp checks are their f32 runs
# (LM_ATOL's 1e-3) and B4 at each rank's sites
MESH_FAMILY_ULPS = {"ssm": ZAMBA_ULPS, "hybrid": 32}
# phase 17: training on a mesh, four ranks on this one card over gloo
MESH_TRAIN_ROOT = Path(__file__).resolve().parent / "build" / "mesh_train"
MESH_TRAIN_SHAPE = (2, 2)              # 17a: ("data", "model")
MESH_TRAIN_LAYERS = 4                  # 17a: qwen3-4b, 4 of 36 layers
                                       # (cut from 8 for phase 18's time)
MESH_TRAIN_STEPS = 2                   # cut from 3 for 17d's time
COMP_TRAIN_SHAPE = (2, 2, 1)           # 17b: ("pod", "data", "model")
# 17a's losses and grad norms against one device's, relative: the gaps
# read on the card were at most 4.1e-4 at 8 layers and 2.2e-3 at 2
# (PERF.md section 6), from bf16 partials rounded before their f32 sums
# and GEMMs on other row counts
MESH_TRAIN_RTOL = 3e-3
# 17d's limits where a run needs its own (label: relative), with the
# reading that set each (H100, PERF.md section 6). In bf16 a mesh
# rounds each row-parallel partial to bf16 before its f32 sum and runs
# its GEMMs on other row counts; the recurrent archs carry that through
# their scans, and at their random init much of a bf16 gradient is
# rounding (on the CPU rwkv6's smoke config's bf16 grad norm is 91.3 on
# one device, 58.2 on 2 x 2, 112.8 in f32). Read: rwkv6's grad norm
# 2.8e-2 from one device's at step 0, zamba2's 1.9e-2 at step 1, where
# musicgen reads 8.3e-5 and the VLM 2.3e-4; their limits twice that.
# Their f32 runs are the sharp checks, at 1e-4 (read: zamba2 0 at step
# 0, rwkv6 1.6e-6)
FAMILY_TRAIN_RTOL = {"17d-ssm": 6e-2, "17d-hybrid": 4e-2,
                     "17d-ssm-f32": 1e-4, "17d-hybrid-f32": 1e-4}
COMP_TRAIN_LAYERS = 2                  # 17b: 2 of 36 layers
# phase 18: the reference's perf flags (models/perfcfg) and the dry run
SEQ_S = 1024                           # 18: qwen2-0.5b's prefill rows ...
SEQ_RANKS = 4                          # ... over a model axis of 4
SEQ_SHAPE = (1, SEQ_RANKS)             # 18b: ("data", "model")
SEQ_LAYERS = 4                         # 18b: qwen2-0.5b, 4 of 24 layers
SEQ_NEW = 2                            # 18b: greedy tokens a run
SEQ_FLAGS = {"seq_shard_attn": True, "sp_residual": True}
A2A_RULE = 0.03                        # 18c: the reference test's rule (read)
DRY_ROOT = Path(__file__).resolve().parent / "build" / "dry18"
DRY_CELLS = (("qwen3-4b", "train_4k", False),
             ("kimi-k2-1t-a32b", "train_4k", True))
DRY_WAIT_S = 600                       # the dry run's process, at most
# what phases 16 and 17 hand on to phase 18: 18c's logits from 16b's
# ranks, 18b's runs and 17a's numbers from phase 17's ranks
PHASE18 = {}
COMP_TRAIN_STEPS = 2
GRAPH_VERTICES, GRAPH_EDGES = 1 << 20, 1 << 24
GRAPH_PR_ITERS, GRAPH_BFS_ITERS = 50, 32
# phase 13: training on one card
TRAIN_ARCH = "qwen3-4b"                # full width and depth, 36 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
TRAIN_ROOT = Path(__file__).resolve().parent / "build" / "train"
# 17d: the ssm, hybrid, audio and vlm families train on a mesh at full
# width, in the spawn of 17a and 17b, through ``launch.train.main
# --mesh``: (label, arch, mesh, layers, batch, steps, flags). The depths
# are cut so that gloo's host-borne wire fits the run: rwkv6-7b 2 of 32
# layers (~1.0 B params), zamba2-1.2b 12 of 38 (two shared-attention
# sites), musicgen-medium 12 of 48, the VLM 4 of 80 (one superblock:
# four self layers and a cross layer over 1600 image tokens) with its
# batch cut to 1 x 1024 (from 2 x 1024, for the script's time); int8
# states for rwkv6 (as 14c) and for the VLM,
# whose f32 states for ~6.4 B params would not fit beside one device's
# run. The f32 runs are the recurrent archs' sharp checks, at the least
# depth that holds their parts (zamba2's 6 layers: one site), one step:
# the loss and grad norm at the same params; a second step's grad norm
# is taken where the first moved each entry by ~lr x sign(g) (Adam's
# first step, eps 1e-8), so a gradient within rounding of 0 steps
# either way (rwkv6 in f32, f32 states: 1.95e-2 from one device's at
# step 1, 1.6e-6 at step 0; H100, PERF.md section 6)
FAMILY_TRAIN_RUNS = (
    ("17d-ssm", "rwkv6-7b", (2, 2), 2, TRAIN_BATCH, 2, ("--int8-opt",)),
    ("17d-hybrid", "zamba2-1.2b", (2, 2), 12, TRAIN_BATCH, 2, ()),
    ("17d-audio", "musicgen-medium", (2, 2), 12, TRAIN_BATCH, 2, ()),
    ("17d-vlm", "llama-3.2-vision-90b", (1, 4), 4, 1, 2, ("--int8-opt",)),
    ("17d-ssm-f32", "rwkv6-7b", (2, 2), 2, TRAIN_BATCH, 1,
     ("--int8-opt", "--dtype", "float32")),
    ("17d-hybrid-f32", "zamba2-1.2b", (2, 2), 6, TRAIN_BATCH, 1,
     ("--dtype", "float32")),
)
# B4's lse against the plain version's: both sum the same f32 exps in
# another order; lse is ~5-10 here, and f32 keeps ~1e-6 of it
LSE_TOL = 1e-4
# the training attention's dq, dk, dv against autograd through f32
# attention, relative Frobenius error: f32 sums in other orders (~4e-7 on
# the CPU); in bf16 the inputs are the same bf16 values, but B4's output,
# rounded to bf16, enters delta = sum(dout * out): ~2e-3 on the CPU, while
# a 64-key tile dropped for half the query rows moves them ~4e-2
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FAULT_ROW, FAULT_TILE = 512, 1
# the kernel step's grad norm against the plain-attention step's: bf16
# rounding of attention outputs carried through 36 layers' backward
GNORM_RTOL = 1e-2
RESTART_ARCH, RESTART_LAYERS = "qwen2-0.5b", 4
# phase 14: WKVChunked's gradients against plain autograd through the scan
# a chunk at a time, relative Frobenius error: the same f32 terms summed
# group by group (~1e-7 on the CPU); r, k and v's gradients are bf16 at
# rwkv6-7b's width, where an entry may round one ulp (2^-8) the other way
WKV_GRAD_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
# the Function's backward recomputes one group's D (D_BYTES) with autograd:
# exp(D) and k_s D saved, their gradients and the masked exponent between
# them; it must peak below this many D_BYTES over what it saved
WKV_PEAK_D = 6
STORE_NNZ_PADS = (64, 128, 256, 512)
NEW_SHAPE_DOCS = (8, 64, 1000)         # an approx pool, a small one, odd
NEW_SHAPE_BLOCK_DOCS = (8, 32)         # AutoTiling's narrow doc tiles


def say(*args):
    print(*args, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def row_scaled_err(got, want) -> float:
    """max over output rows (the last dim) of max |got - want| over the
    row's max |want|."""
    err = (got.float() - want.float()).abs().amax(-1)
    return float((err / want.float().abs().amax(-1).clamp_min(1e-30)).max())


def cuda_ms(torch, fn, reps):
    """Median time of ``fn`` on the card by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(torch, fn, reps, per_graph=10):
    """Device time of one ``fn``: ``per_graph`` calls captured in a CUDA
    graph, the median of ``reps`` replays by CUDA events over
    ``per_graph``. No host time between launches: for kernels that are
    shorter than their Python wrapper's launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    return cuda_ms(torch, graph.replay, reps) / per_graph


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over ``ops_per_s``, in ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def http_get(url, timeout=300):
    """(status, body, ms) of one GET; a 4xx/5xx answer is returned, not
    raised."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            code, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    return code, body, (time.perf_counter() - t0) * 1e3


class Scraper:
    """GETs the telemetry routes in turn, one every SCRAPE_EVERY_S, on a
    thread of its own between ``start`` and ``stop``; keeps each answer's
    route, code, ms and bytes, and the body of any that is not 200."""

    def __init__(self, server):
        import threading
        self.server = server
        self.seen = []
        self.bad = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="scraper")

    def _run(self):
        i = 0
        while not self._stop.is_set():
            route = TELEMETRY_ROUTES[i % len(TELEMETRY_ROUTES)]
            code, body, ms = http_get(self.server.url(route))
            self.seen.append((route, code, ms, len(body.encode())))
            if code != 200:
                self.bad.append((route, code, body))
            i += 1
            self._stop.wait(SCRAPE_EVERY_S)

    def start(self):
        self._thread.start()
        return self

    def stop(self, where):
        """Stop, join, and fail the run on any answer that was not 200."""
        self._stop.set()
        self._thread.join()
        if self.bad:
            route, code, body = self.bad[0]
            fail(f"{where}: {len(self.bad)} scrapes were not 200; the "
                 f"first, {route} {code}:\n{body}")
        if not self.seen:
            fail(f"{where}: no scrape was answered")

    def summary(self) -> str:
        parts = []
        for route in TELEMETRY_ROUTES:
            rows = [r for r in self.seen if r[0] == route]
            codes = {}
            for r in rows:
                codes[r[1]] = codes.get(r[1], 0) + 1
            ms = [r[2] for r in rows]
            parts.append(f"{route} {codes} ms p50 "
                         f"{np.percentile(ms, 50):.2f} p99 "
                         f"{np.percentile(ms, 99):.2f}" if rows else
                         f"{route} none")
        sizes = [r[3] for r in self.seen if r[0] == "/metrics"]
        return (f"{len(self.seen)} scrapes: " + "; ".join(parts)
                + f"; /metrics {int(np.median(sizes)) if sizes else 0} bytes"
                  f" (median, max {max(sizes, default=0)})")


@contextlib.contextmanager
def fd2_copied(path):
    """Send file descriptor 2, where Kineto prints past Python's
    ``sys.stderr``, to ``path`` for the block; then write what it caught
    to the real stderr and into the yielded dict's ``text``."""
    out = {"text": ""}
    sys.stderr.flush()
    saved = os.dup(2)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w+b") as f:
        os.dup2(f.fileno(), 2)
        try:
            yield out
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            f.seek(0)
            out["text"] = f.read().decode(errors="replace")
            sys.stderr.write(out["text"])
            sys.stderr.flush()


def same(a, b) -> bool:
    return (np.array_equal(a.doc_ids, b.doc_ids)
            and np.array_equal(a.scores.view(np.uint32),
                               b.scores.view(np.uint32)))


def same_row(row, res, r) -> bool:
    """A served row against row ``r`` of a batched result, bit for bit."""
    return (np.array_equal(row.doc_ids, res.doc_ids[r])
            and np.array_equal(np.asarray(row.scores).view(np.uint32),
                               res.scores[r].view(np.uint32)))


def main() -> int:
    t_run = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs.paper_search import SearchConfig
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.core.engine import PatternSearchEngine
    from repro_torch.kernels import _build, fused, ops, ref
    from repro_torch.kernels import sparse_match_packed as b2
    from repro_torch.kernels.sparse_match import (
        MAX_KEY, MIN_PASS_COLS, query_tiles, sparse_match, sparse_match_plain,
        tile_bytes)
    from repro_torch.kernels.sparse_match_packed import (
        sparse_match_packed, sparse_match_packed_plain)
    from repro_torch.launch import search as launcher
    from repro_torch.serve import Query

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    simt_run = simt_counted(_build)

    # -- 1. card ---------------------------------------------------------
    card = nvidia_smi_line()
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    say(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{len(report)} libraries (one nvcc each, in parallel)")
    for name, r in report.items():
        # ptxas -v: each kernel's (mangled) name, then its registers and
        # shared memory
        regs = [ln.split("Used ")[1] if "Used " in ln else ln.split("'")[1]
                for ln in r["log"].splitlines()
                if "Used " in ln or "entry function" in ln]
        say(f"  {name}: {r['seconds']:.1f} s; ptxas: {' | '.join(regs)}")
    for name in _build.SOURCES:
        if not _build.library_path(name).exists():
            fail(f"{name} did not build")
    simt_spills(_build)
    # -- 3. corpus -------------------------------------------------------
    cfg = SearchConfig(name="paper-full")
    t0 = time.perf_counter()
    corpus = corpus_lib.synthesize(N_DOCS, cfg.vocab_size,
                                   cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                   seed=SEED)
    n_pairs = int((corpus.ids >= 0).sum())
    say(f"corpus: {N_DOCS} docs x nnz_pad {cfg.nnz_pad}, vocab "
        f"{cfg.vocab_size}, {n_pairs} pairs, synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    engines = {}
    for backend in ("gpu", "gpu_packed", "gpu_fused", "torch"):
        t0 = time.perf_counter()
        engines[backend] = PatternSearchEngine(corpus, cfg, dev, backend)
        torch.cuda.synchronize()
        say(f"  engine {backend}: resident in "
            f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = []
    for L in range(1, 9):
        idx = rng.integers(0, N_DOCS, L)
        qs = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
              for i in idx]
        requests.append((idx, np.stack([q[0] for q in qs]),
                         np.stack([q[1] for q in qs])))

    # -- 4. kernels against their plain versions -------------------------
    g, p, f = engines["gpu"], engines["gpu_packed"], engines["gpu_fused"]
    Lp, mi, mv, qn = g.merged_stream(*requests[-1][1:])
    q_ids = torch.from_numpy(mi).to(dev)        # -2 pads already
    q_vals = torch.from_numpy(mv).to(dev)
    q_norms = torch.from_numpy(qn).to(dev)
    bd, kp = f._block_docs, min(cfg.top_k, f._block_docs)
    say(f"shapes: D={N_DOCS} K={cfg.nnz_pad} L={Lp} Qm={mi.size} "
        f"tiles={tuple(f.f_tiles.shape)} block_docs={bd} kp={kp}")
    # what the request gives each kernel's table: B1 holds every id, B2
    # those below 2^20, B3 those up to 2^19 - 1; B1's and B2's query tiles
    # take what their registers leave (tile_bytes, from the card)
    b1_bytes = tile_bytes(dev, mi.size, Lp)
    b2_bytes = b2.tile_bytes(dev, mi.size, Lp)
    tables = {
        "B1": query_tiles(mi, MAX_KEY, min_cols=MIN_PASS_COLS,
                          tile_bytes=b1_bytes),
        "B2": query_tiles(mi, (1 << 20) - 1, min_cols=MIN_PASS_COLS,
                          tile_bytes=b2_bytes),
        "B3": query_tiles(mi, fused.KEY_MASK)}
    words = g.d_ids[g.d_ids >= 0]
    hit = float(torch.isin(words, q_ids[q_ids >= 0]).double().mean())
    table = tables["B3"]
    say(f"query table (L={Lp} request): {table[0]['real']} real items of "
        f"{mi.size} ({len(table)} tile, sorted {table[0]['sorted']}); "
        + "; ".join(f"{k}: {t[0]['distinct']} distinct ids in "
                    f"{t[0]['slots']} slots, run sums of {t[0]['sum_cols']} "
                    f"columns" for k, t in tables.items())
        + f"; query tiles B1 {b1_bytes} B, B2 {b2_bytes} B; {hit:.4f} of the "
        f"{words.numel()} doc words hit")
    del words
    calls = {
        "sparse_match": (
            lambda: sparse_match(g.d_ids, g.d_vals, q_ids, q_vals),
            lambda: sparse_match_plain(g.d_ids, g.d_vals, q_ids, q_vals)),
        "sparse_match_packed": (
            lambda: sparse_match_packed(p.d_ids, q_ids, q_vals),
            lambda: sparse_match_packed_plain(p.d_ids, q_ids, q_vals)),
        "fused_match_topk": (
            lambda: fused.fused_match_topk(f.f_tiles, q_ids, q_vals, q_norms,
                                           block_docs=bd, kp=kp),
            lambda: fused.fused_match_topk_plain(
                f.f_tiles, q_ids, q_vals, q_norms, block_docs=bd, kp=kp)),
    }
    max_err = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if name == "fused_match_topk":
            if not torch.equal(got[1], want[1]):
                fail(f"{name}: candidate ids differ from the plain version")
            got, want = got[0], want[0]
        if not torch.equal(got.isfinite(), want.isfinite()) or not torch.equal(
                got[~got.isfinite()], want[~want.isfinite()]):
            fail(f"{name}: non-finite entries differ from the plain version")
        fin = got.isfinite()
        max_err[name] = float((got[fin] - want[fin]).abs().max())
        if max_err[name] != 0.0:
            fail(f"{name}: max |kernel - plain| = {max_err[name]} on "
                 "integral counts (must be 0)")
        del got, want
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f_vals = g.d_vals * torch.rand(g.d_vals.shape, generator=gen, device=dev)
    f_qv = q_vals * torch.randn(q_vals.shape, generator=gen, device=dev)
    got = sparse_match(g.d_ids, f_vals, q_ids, f_qv)
    want = sparse_match_plain(g.d_ids, f_vals, q_ids, f_qv)
    atol = 1e-5 * float(want.abs().max())
    f_err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=FLOAT_RTOL, atol=atol)
    say(f"kernels vs plain: {', '.join(calls)} agree exactly on integral "
        f"counts (max_abs_err {max_err}); float-valued sparse_match "
        f"max_abs_err {f_err:.3e} within rtol {FLOAT_RTOL} + atol {atol:.3e}"
        " (1e-5 x max |score|: sums of <= K*L products in another order)")
    del got, want, f_vals, f_qv
    torch.cuda.empty_cache()

    # -- 5. launcher -----------------------------------------------------
    res = launcher.main(["--n-docs", "65536", "--queries", "4",
                         "--backend", "gpu", "--seed", "1"])
    idx = np.random.default_rng(1).integers(0, 65536, 4)
    if not np.array_equal(res.doc_ids[:, 0], idx):
        fail("launcher: a self-query did not rank itself first")

    # -- 6. main path ----------------------------------------------------
    kernels = {"sparse_match": sparse_match,
               "sparse_match_packed": sparse_match_packed,
               "fused_match_topk": fused.fused_match_topk}
    for fn in kernels.values():
        fn.launches = 0
    slabs = [corpus.slice_rows(i * N_DOCS // N_SLABS,
                               (i + 1) * N_DOCS // N_SLABS)
             for i in range(N_SLABS)]
    results, host_ms = {}, {}
    for backend in ("gpu", "gpu_packed", "gpu_fused"):
        eng = engines[backend]
        results[backend], host_ms[backend] = [], []
        for idx, qi, qv in requests:
            t0 = time.perf_counter()
            r = eng.search(Query(qi, qv))
            host_ms[backend].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(r.doc_ids[:, 0], idx):
                fail(f"{backend}: a self-query did not rank itself first")
            results[backend].append(r)
        t0 = time.perf_counter()
        streamed = eng.search_streaming(requests[2][1], requests[2][2],
                                        iter(slabs))
        s_ms = (time.perf_counter() - t0) * 1e3
        if not same(streamed, results[backend][2]):
            fail(f"{backend}: streaming over {N_SLABS} slabs differs from "
                 "the resident search")
        say(f"main path {backend}: request host ms "
            f"{', '.join(f'{t:.2f}' for t in host_ms[backend])}; streaming "
            f"{N_SLABS} x {N_DOCS // N_SLABS} docs (L=3) {s_ms:.0f} ms "
            f"(uploads included); launch keys "
            f"{eng.compile_stats['buckets']}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    say(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    ref_results = [engines["torch"].search(Query(qi, qv))
                   for _, qi, qv in requests]
    for backend in ("gpu_packed", "gpu_fused"):
        for l, (a, b) in enumerate(zip(results["gpu"], results[backend])):
            if not same(a, b):
                fail(f"{backend} differs from gpu on request L={l + 1}")
    for l, (a, b) in enumerate(zip(results["gpu"], ref_results)):
        if not same(a, b):
            fail(f"gpu differs from the torch gather path on L={l + 1}")
    say("main path: gpu, gpu_packed, gpu_fused and torch agree bit for bit "
        "on 8 requests; every self-query ranks itself first")

    # -- 6b. store -----------------------------------------------------------
    store_launches = store_phase(torch, dev, cfg, corpus, requests,
                                 results["gpu"], kernels,
                                 (q_ids, q_vals, q_norms))
    for name, n in store_launches.items():
        launches[name] += n

    # -- 15. the engine on a mesh (here: it reads 6b's store before 6c
    # grows it) ----------------------------------------------------------------
    mesh_launches = mesh_phase(torch, dev, cfg, corpus, requests,
                               results["gpu"], g, kernels)
    for name, n in mesh_launches.items():
        launches[name] += n
    torch.cuda.empty_cache()

    # -- 6c. live --------------------------------------------------------------
    with fd2_copied(STORE_ROOT.parent / "live.stderr") as err:
        live_launches = live_phase(torch, dev, cfg, corpus, g, kernels)
    if KINETO_THREAD_ERROR in err["text"]:
        fail(f"live: the phase's stderr holds {KINETO_THREAD_ERROR!r}")
    say(f"live: the phase's stderr ({len(err['text'])} bytes) holds no "
        f"{KINETO_THREAD_ERROR!r}")
    for name, n in live_launches.items():
        launches[name] += n
    shutil.rmtree(STORE_ROOT, ignore_errors=True)
    shutil.rmtree(PROFILE_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 6d. cluster -------------------------------------------------------------
    cluster_launches = cluster_phase(torch, dev, cfg, corpus, requests,
                                     results["gpu"], g, kernels)
    for name, n in cluster_launches.items():
        launches[name] += n
    shutil.rmtree(CLUSTER_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- 7. times ----------------------------------------------------------
    D, K = g.d_ids.shape
    n_valid = int((g.d_ids >= 0).sum())
    q_bytes = nbytes(q_ids, q_vals)
    out_bytes = D * Lp * 4
    csr = torch.sparse_csr_tensor(
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   (g.d_ids >= 0).sum(1).cumsum(0)]),
        g.d_ids[g.d_ids >= 0].long(), g.d_vals[g.d_ids >= 0],
        size=(D, cfg.vocab_size), check_invariants=False)
    dq = ref.dense_query(q_ids, q_vals, cfg.vocab_size)
    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, dq), 10)
    lib_err = float((torch.sparse.mm(csr, dq) - calls["sparse_match"][0]())
                    .abs().max())
    say(f"library torch.sparse.mm (CSR [D,V] x dense [V,L]): {lib_ms:.4f} ms"
        f" (max |diff| to sparse_match {lib_err})")
    # bytes each input is read once and each output written once (ELL
    # values only where the slot holds a word: a pad slot's value is
    # never needed); operations: a multiply-add per valid slot and column
    work = {
        "sparse_match": (nbytes(g.d_ids) + 4 * n_valid + q_bytes + out_bytes,
                         2 * n_valid * Lp),
        "sparse_match_packed": (nbytes(p.d_ids) + q_bytes + out_bytes,
                                2 * n_valid * Lp),
        "fused_match_topk": (nbytes(f.f_tiles, q_norms) + q_bytes
                             + f.f_tiles.shape[0] * Lp * kp * 8,
                             2 * n_valid * Lp + 2 * n_valid),
    }
    sources = {"sparse_match": ("src/repro_torch/kernels/csrc/sparse_match.cu",
                                "src/repro/kernels/sparse_match.py:39"),
               "sparse_match_packed": (
                   "src/repro_torch/kernels/csrc/sparse_match_packed.cu",
                   "src/repro/kernels/sparse_match_packed.py:40"),
               "fused_match_topk": ("src/repro_torch/kernels/csrc/fused.cu",
                                    "src/repro/kernels/fused.py:170")}
    rows = []
    for name, (kernel, plain) in calls.items():
        ms = cuda_ms(torch, kernel, 20)
        plain_ms = cuda_ms(torch, plain, 3)
        b_ms, b_by = bound(*work[name])
        library = None if name == "fused_match_topk" else lib_ms
        say(f"time {name}: {ms:.4f} ms, {ms / b_ms:.2f}x its bound (plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"{work[name][0] / 1e9:.3f} GB; library {library})")
        rows.append({"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library})

    # check the script's inputs, outputs and end state once more
    if not all(np.isfinite(r.scores[:, 0]).all() for r in results["gpu"]):
        fail("non-finite top-1 scores")
    del engines, g, p, f, corpus, slabs, csr, dq
    torch.cuda.empty_cache()

    # phase 18d's dry run needs no card: it runs on the host beside the LM
    # phases, whose host work is one thread's dispatch
    dry = dry_started()
    atexit.register(lambda: dry[0].poll() is None and dry[0].kill())
    rows.append(lm_phases(torch, dev))
    t0 = time.perf_counter()
    rows.append(lm128_phases(torch, dev))
    say(f"phases 8b-11b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hd256_rows, kimi_launches = lm256_phases(torch, dev)
    rows[-1]["launches"] += kimi_launches      # kimi-k2 runs B4 at hd 128
    rows.extend(hd256_rows)
    say(f"phases 8c-11c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows.append(recurrent_phases(torch, dev))
    say(f"phases 8d-11d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mm_rows, vlm_self = multimodal_phases(torch, dev)
    next(r for r in rows if r["name"] == "flash_attention_hd128")[
        "launches"] += vlm_self                # the VLM's self-attention
    rows.extend(mm_rows)
    say(f"phases 8e-11e: {time.perf_counter() - t0:.1f} s")
    graph_phase(torch, dev)
    row, c13 = train_phases(torch, dev)
    rows.append(row)
    rows.append(train_recurrent_phases(torch, dev))
    # -- 16. LM serving on a mesh: B4 at hd 128 (qwen3-4b, qwen3-moe, the
    # VLM's self layers), hd 64 (zamba2, musicgen) and Sk != S (the VLM) --
    for name, n in lm_mesh_phase(torch, dev).items():
        next(r for r in rows if r["name"] == name)["launches"] += n
    # -- 17. training on a mesh: B4 with its lse, at 17c's full shape and on
    # the ranks' heads -----------------------------------------------------
    launches17, rows17 = mesh_train_phase(torch, dev, nvidia_smi_line(), c13)
    for name, n in launches17.items():
        next(r for r in rows if r["name"] == name)["launches"] += n
    rows.extend(rows17)
    # -- 18. the reference's perf flags on the mesh path (B4 at a rank's
    # sequence rows) and the dry run on the meta device --------------------
    rows.append(perf_phase(torch, dev, nvidia_smi_line(), dry))
    rows.extend(F32_ROWS)
    say(f"B4's simt instance over the whole run, in this process: "
        f"{simt_run[0]} launches (launches_by_design['simt'], every "
        "reset added back; the mesh ranks' own are in phases 16-17's "
        "lines)")
    say(f"run: {time.perf_counter() - t_run:.1f} s wall")
    say(nvidia_smi_line())
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def simt_counted(_build):
    """B4's simt launches over the whole run: the phases set
    ``launches_by_design`` to 0 before each run they read, so the total
    is counted beside it, where the wrapper counts (``count_launch``).
    Returns a one-item list that holds the total."""
    total = [0]
    count = _build.count_launch

    def counted(wrapper, design=None, *also):
        if design == "simt":
            total[0] += 1
        count(wrapper, design, *also)
    _build.count_launch = counted
    return total


def simt_spills(_build):
    """Phase 2: ptxas' report of every simt instance of B4 (``ptxas
    -v``; f32 at each head dim and bf16 at 8, each global and windowed,
    with 16-byte and with one-element copies): its registers, and no
    bytes spilled to local memory."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    log = _build.ptxas_log("flash_attention").splitlines()
    seen = []
    for i, ln in enumerate(log):
        if "Compiling entry function" not in ln or "simt9flash_fwd" not in ln:
            continue
        props = next(x for x in log[i + 1:] if "spill stores" in x)
        used = next(x for x in log[i + 1:] if "Used " in x)
        # template arguments T, HD, kWindow, kWide
        args = ln.split("flash_fwdI")[1].split("EEEv")[0]
        window, wide = (f.startswith("1") for f in args.split("Lb")[1:])
        name = (("bf16" if "bfloat16" in args else "f32") + " hd "
                + args.split("Li")[1].split("E")[0]
                + (" window" if window else "")
                + ("" if wide else " one-element copies"))
        seen.append((name, int(used.split("Used ")[1].split()[0]),
                     props.strip()))
        if not props.strip().startswith("0 bytes stack frame, 0 bytes spill "
                                        "stores, 0 bytes spill loads"):
            fail(f"B4 simt instance {seen[-1][0]} spills: {props.strip()}")
    if len(seen) != 4 * (len(HEAD_DIMS) + 1):
        fail(f"ptxas reported {len(seen)} simt instances of B4, want "
             f"{4 * (len(HEAD_DIMS) + 1)}")
    narrow = [r for n, r, _ in seen if n.endswith("copies")]
    say(f"B4 simt instances (ptxas -v): {len(seen)}, none spills; registers"
        " " + ", ".join(f"{n} {r}" for n, r, _ in seen
                        if not n.endswith("copies"))
        + f"; with one-element copies {min(narrow)}-{max(narrow)}")


def mesh_phase(torch, dev, cfg, corpus, requests, resident, engine,
               kernels):
    """Phase 15: the search engine on a mesh. 15a: a world of one rank
    over NCCL, a 1 x 1 mesh, gpu and gpu_packed on the 8 requests, and
    15c's service there. 15b: four ranks (``mesh_rank``) of a 2 x 2 mesh
    on this one card, over gloo, then 15c's services on them
    (``mesh_serve``). Every result bit for bit phase 6's resident one
    (6b's for the session). Returns B1's and B2's launches, the ranks'
    included."""
    import datetime
    import pickle
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core.engine import PatternSearchEngine
    from repro_torch.distributed.meshctx import MeshCtx
    from repro_torch.kernels import _build
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    MESH_ROOT.mkdir(parents=True)
    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    mesh_kernels = {name: kernels[name]
                    for name in ("sparse_match", "sparse_match_packed")}

    # -- 15a: 1 x 1 through NCCL -------------------------------------------
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    for fn in mesh_kernels.values():
        fn.launches = 0
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(MESH_ROOT / "nccl"), 1), rank=0,
        world_size=1, timeout=timeout, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        ctx = MeshCtx(mesh, device=dev)
        wires = {a: dist.get_backend(ctx.group(a)) for a in ctx.shape}
        if set(wires.values()) != {"nccl"}:
            fail(f"mesh 15a: the axis groups' backends are {wires}")
        timed = {}
        for backend in ("gpu", "gpu_packed"):
            eng = PatternSearchEngine(corpus, cfg, backend=backend, ctx=ctx)
            for l, (idx, qi, qv) in enumerate(requests):
                if not same(eng.search(Query(qi, qv)), resident[l]):
                    fail(f"mesh 15a {backend}: L={l + 1} differs from phase "
                         "6's resident result")
            timed[backend] = mesh_times(torch, eng, *requests[-1][1:])
            del eng
        # 15c-1: the service over a session on the 1 x 1 mesh
        t0 = time.perf_counter()
        sess = FlashSearchSession(FlashStore.open(str(STORE_ROOT)), cfg,
                                  backend="gpu", ctx=ctx,
                                  cache_bytes=STORE_CACHE_BYTES)
        try:
            futs = [[sess.submit(Query(qi[r], qv[r]))
                     for r in range(len(idx))] for idx, qi, qv in requests]
            for l, fs in enumerate(futs):
                for r, f in enumerate(fs):
                    if not same_row(f.result(), resident[l], r):
                        fail(f"mesh 15c-1: row {r} of request L={l + 1} "
                             "differs from phase 6's")
            svc_batches = sess.service().stats.n_batches
        finally:
            sess.close()
        svc_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in mesh_kernels.items()}
    if min(launches.values()) <= 0:
        fail(f"mesh 15a: launches {launches}")
    say(f"mesh 15a (1 x 1, one rank over NCCL; tree_topk and the model "
        f"gather on the card): gpu and gpu_packed equal phase 6's 8 "
        f"requests bit for bit; launches {launches}; warm L=8 "
        + "; ".join(f"{b} {parts_line(t)}" for b, t in timed.items())
        + f"; {card}")
    say(f"mesh 15c-1 (1 x 1 over NCCL): session.submit served the 8 "
        f"requests' {sum(len(r[0]) for r in requests)} rows in "
        f"{svc_batches} batches, {svc_s:.1f} s with the cold pass, bit for "
        f"bit phase 6's; {card}")
    torch.cuda.empty_cache()

    # -- 15b: 2 x 2, four ranks on this card, over gloo ---------------------
    _build.build(mesh_kernels)          # the ranks load, never build
    t0 = time.perf_counter()
    for field in ("doc_ids", "ids", "vals", "norms"):
        np.save(MESH_ROOT / f"{field}.npy", getattr(corpus, field))
    saved_s = time.perf_counter() - t0
    reqs = {len(requests[l][0]): requests[l][1:] for l in (2, 7)}
    world = int(np.prod(MESH_SHAPE))
    serve_in = serve_inputs(cfg, corpus, requests, engine)
    t0 = time.perf_counter()
    shutil.copytree(STORE_ROOT, MESH_ROOT / "store")
    serve_in["copy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(world, str(MESH_ROOT), reqs,
                                        str(STORE_ROOT), serve_in),
                       nprocs=world, join=True, start_method="spawn")
    ranks_s = time.perf_counter() - t0
    outs = []
    for rank in range(world):
        with open(MESH_ROOT / f"rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    want = {L: resident[L - 1] for L in reqs}
    for o in outs:
        r = o["rank"]
        for (backend, L), got in o["results"].items():
            if not same(got, want[L]):
                fail(f"mesh 15b rank {r} {backend}: L={L} differs from phase "
                     "6's resident result")
        if not all(o["butterfly"].values()):
            fail(f"mesh 15b rank {r}: tree_topk_ppermute differs from "
                 f"tree_topk {o['butterfly']}")
        if not same(o["session"], resident[7]):
            fail(f"mesh 15b rank {r}: the session's L=8 request differs from "
                 "phase 6b's result")
        if o["session_plan"] != (MESH_SHAPE[0], STORE_SEGMENT_DOCS):
            fail(f"mesh 15b rank {r}: session plan {o['session_plan']}")
        if "single-device" not in o.get("fused_error", ""):
            fail(f"mesh 15b rank {r}: gpu_fused on the mesh did not raise")
        if min(o["launches"].values()) <= 0:
            fail(f"mesh 15b rank {r}: launches {o['launches']}")
        for name, n in o["launches"].items():
            launches[name] += n
        say(f"mesh 15b rank {r} (data {o['coord'][0]}, model "
            f"{o['coord'][1]}): {o['rows']} rows resident, uploaded in "
            f"{o['upload_s']:.1f} s; launches {o['launches']}; warm L=8 "
            + "; ".join(f"{b} {parts_line(t)}"
                        for b, t in o["warm_ms"].items())
            + f"; session cold L=8 {o['session_ms']:.0f} ms; {card}")
    say(f"mesh 15b (2 x 2, {world} ranks on one card over gloo: the [L, k] "
        "lists cross the host, since NCCL refuses two ranks on one GPU, "
        "'Duplicate GPU detected'; the NCCL wire between cards waits for a "
        "multi-card run): gpu and gpu_packed at L=8 and L=3 equal phase 6's "
        "results bit for bit on every rank, tree_topk_ppermute equals "
        "tree_topk, the session equals 6b's, gpu_fused raises; corpus "
        f"saved in {saved_s:.1f} s, ranks ran {ranks_s:.1f} s (15c "
        "included)")
    for name, n in served_checked(dev, cfg, outs, serve_in, resident,
                                  card).items():
        launches[name] += n
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    say(f"mesh phase: {time.perf_counter() - t_phase:.1f} s wall; {card}")
    return launches


def mesh_times(torch, eng, qi, qv):
    """Host ms of MESH_WARM warm requests through ``eng.search`` (median),
    then of the same request in its parts, each ended by a synchronize
    (medians): ``merge`` (the host's merged stream), ``score`` (uploads,
    B1/B2, cosine and the rank's top-k), ``reduce`` (``tree_topk`` over
    the data axes and the model gather)."""
    from repro_torch.core import topk as topk_lib
    from repro_torch.distributed import compat
    from repro_torch.serve import Query
    ctx, k = eng.ctx, eng.cfg.top_k
    parts = {"request": [], "merge": [], "score": [], "reduce": []}
    for _ in range(MESH_WARM):
        t0 = time.perf_counter()
        eng.search(Query(qi, qv))
        parts["request"].append((time.perf_counter() - t0) * 1e3)
    for _ in range(MESH_WARM):
        t0 = time.perf_counter()
        stream = eng.merged_stream(qi, qv)
        t1 = time.perf_counter()
        v, i = eng.shard_topk(*stream)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for axis in ctx.dp_axes:
            v, i = topk_lib.tree_topk(v, i, k, ctx, axis)
        v = compat.all_gather_axis(v, ctx, ctx.tp_axis, dim=0)
        i = compat.all_gather_axis(i, ctx, ctx.tp_axis, dim=0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, dt in (("merge", t1 - t0), ("score", t2 - t1),
                         ("reduce", t3 - t2)):
            parts[name].append(dt * 1e3)
    return {name: statistics.median(ts) for name, ts in parts.items()}


def parts_line(t) -> str:
    return (f"request {t['request']:.2f} ms (median of {MESH_WARM}; merge "
            f"{t['merge']:.2f}, score {t['score']:.2f}, reduce "
            f"{t['reduce']:.2f})")


def mesh_rank(rank, world, root, reqs, store_root, serve_in):
    """One rank of phase 15b: a process of its own on the card, in a gloo
    world through a FileStore under ``root``; it loads phase 6's corpus
    from ``root`` (memory-mapped: it uploads only its row block), runs
    the engine and the store session in lockstep with the other ranks,
    then 15c's services (``mesh_serve``), and pickles what it found to
    ``root/rank<r>.pkl``."""
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.paper_search import SearchConfig
    from repro_torch.core import topk as topk_lib
    from repro_torch.core.corpus import Corpus
    from repro_torch.core.engine import PatternSearchEngine
    from repro_torch.distributed.meshctx import MeshCtx
    from repro_torch.kernels.sparse_match import sparse_match
    from repro_torch.kernels.sparse_match_packed import sparse_match_packed
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(2)
    root = Path(root)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / "gloo"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        ctx = MeshCtx(init_device_mesh("cpu", MESH_SHAPE,
                                       mesh_dim_names=("data", "model")),
                      device="cuda:0")
        corpus = Corpus(*(np.load(root / f"{field}.npy", mmap_mode="r")
                          for field in ("doc_ids", "ids", "vals", "norms")))
        cfg = SearchConfig(name="paper-full")
        kernels = {"sparse_match": sparse_match,
                   "sparse_match_packed": sparse_match_packed}
        for fn in kernels.values():
            fn.launches = 0
        out = {"rank": rank, "coord": (ctx.dp_index, ctx.coord("model")),
               "results": {}}
        t0 = time.perf_counter()
        engines = {b: PatternSearchEngine(corpus, cfg, backend=b, ctx=ctx)
                   for b in ("gpu", "gpu_packed")}
        torch.cuda.synchronize()
        out["upload_s"] = time.perf_counter() - t0
        out["rows"] = engines["gpu"].d_ids.shape[0]
        for backend, eng in engines.items():
            for L, (qi, qv) in reqs.items():
                out["results"][backend, L] = eng.search(Query(qi, qv))
        try:
            PatternSearchEngine(None, cfg, backend="gpu_fused", ctx=ctx)
        except ValueError as e:
            out["fused_error"] = str(e)
        sess = FlashSearchSession(FlashStore.open(store_root), cfg,
                                  backend="gpu", ctx=ctx, cache_bytes=0)
        try:
            t0 = time.perf_counter()
            out["session"] = sess.search(Query(*reqs[8]))
            out["session_ms"] = (time.perf_counter() - t0) * 1e3
            out["session_plan"] = (sess._planner.rows, sess._slab_docs)
        finally:
            sess.close()
        torch.cuda.synchronize()
        out["launches"] = {n: fn.launches for n, fn in kernels.items()}
        out["warm_ms"], out["butterfly"] = {}, {}
        for backend, eng in engines.items():
            out["warm_ms"][backend] = mesh_times(torch, eng, *reqs[8])
            # tree_topk_ppermute against tree_topk on the rank's own
            # candidates of the L = 8 request
            v, i = eng.shard_topk(*eng.merged_stream(*reqs[8]))
            k, n = cfg.top_k, ctx.shape["data"]
            gv, gi = topk_lib.tree_topk(v, i, k, ctx, "data")
            pv, pi = topk_lib.tree_topk_ppermute(v, i, k, ctx, "data", n)
            out["butterfly"][backend] = (
                torch.equal(gv.view(torch.int32), pv.view(torch.int32))
                and torch.equal(gi, pi))
        out["serve"] = mesh_serve(torch, ctx, cfg, str(root / "store"),
                                  serve_in, kernels)
    finally:
        dist.destroy_process_group()
    with open(root / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def serve_inputs(cfg, corpus, requests, engine):
    """15c's load: the 8 requests' rows, MESH_CLIENTS x MESH_REQUESTS L = 1
    self-queries of base documents with the resident engine's top-1 of
    each, MESH_APPENDS new documents and the queries of the last two."""
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.serve import Query
    rng = np.random.default_rng(SEED + 4)
    n = MESH_CLIENTS * MESH_REQUESTS
    idx = rng.integers(0, N_DOCS, n)
    queries = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
               for i in idx]
    top1 = []
    for lo in range(0, n, 8):
        q = queries[lo:lo + 8]
        r = engine.search(Query(np.stack([x[0] for x in q]),
                                np.stack([x[1] for x in q])))
        top1 += list(zip(r.doc_ids[:, 0], r.scores[:, 0]))
    if [int(d) for d, _ in top1] != [int(i) for i in idx]:
        fail("mesh 15c: a resident self-query did not rank itself first")
    new = corpus_lib.synthesize(MESH_APPENDS, cfg.vocab_size,
                                cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                seed=SEED + 5)
    new.doc_ids[:] += N_DOCS
    return {"rows": [(qi[r], qv[r]) for _, qi, qv in requests
                     for r in range(len(qi))],
            "queries": queries, "top1": top1,
            "new_docs": ell_docs(new, range(MESH_APPENDS)),
            "new_queries": [corpus_lib.make_query(new, j, cfg.max_query_nnz)
                            for j in (MESH_APPENDS - 2, MESH_APPENDS - 1)]}


def mesh_serve(torch, ctx, cfg, store_root, serve_in, kernels):
    """15c on one rank of 15b's world, over the copy of 6b's store at
    ``store_root``. Rank 0 leads: a read-only gpu_packed service serves
    the 8 requests' rows, then a gpu session with the write path serves
    the clients' self-queries while a writer appends; after a flush,
    the 2 new documents' queries. The other ranks ``follow()`` each
    service. Returns the rank's rows, counts and times."""
    import threading
    from repro_torch.distributed import compat, lockstep
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    leader = lockstep.role(ctx) == lockstep.LEADER
    for fn in kernels.values():
        fn.launches = 0
    compat.stats = {}
    t_phase = time.perf_counter()
    out = {"leader": leader}

    def session(backend):
        return FlashSearchSession(FlashStore.open(store_root), cfg,
                                  backend=backend, ctx=ctx,
                                  cache_bytes=MESH_CACHE_BYTES)

    sess = session("gpu_packed")
    try:
        if leader:
            futs = [sess.submit(Query(*row)) for row in serve_in["rows"]]
            out["packed_rows"] = [f.result() for f in futs]
            out["packed"] = dataclasses.asdict(sess.service().lockstep_stats)
        else:
            out["packed"] = dataclasses.asdict(sess.follow())
    finally:
        sess.close()
    t_serve = time.perf_counter()
    sess = session("gpu")
    try:
        if not leader:
            out["live"] = dataclasses.asdict(sess.follow())
        else:
            pipe = sess.enable_ingest(seal_docs=MESH_SEAL_DOCS)
            svc = sess.service(max_batch=8, max_delay_ms=2.0)
            queries = serve_in["queries"]
            rows = [None] * len(queries)
            lats = [[] for _ in range(MESH_CLIENTS)]
            errors, writer_s = [], {}

            def client(t):
                try:
                    for j in range(t * MESH_REQUESTS,
                                   (t + 1) * MESH_REQUESTS):
                        t1 = time.perf_counter()
                        rows[j] = sess.submit(Query(*queries[j])).result()
                        lats[t].append(time.perf_counter() - t1)
                except Exception as e:
                    errors.append(repr(e))

            def writer():
                t1 = time.perf_counter()
                try:
                    for d, p in serve_in["new_docs"]:
                        sess.append(d, p)
                except Exception as e:
                    errors.append(repr(e))
                writer_s["wall"] = time.perf_counter() - t1

            threads = [threading.Thread(target=writer)] + [
                threading.Thread(target=client, args=(t,))
                for t in range(MESH_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out["wall_serve_s"] = time.perf_counter() - t0
            # the compactor folds the writer's four deltas on its own
            t1 = time.monotonic()
            while (not pipe.stats.compactions
                   and time.monotonic() - t1 < MESH_TIMEOUT_S):
                time.sleep(0.05)
            sess.flush_ingest()
            out["new_rows"] = [sess.submit(Query(*q)).result()
                               for q in serve_in["new_queries"]]
            out.update(rows=rows, errors=errors, writer_s=writer_s["wall"],
                       lat_ms=np.concatenate([np.asarray(x)
                                              for x in lats]) * 1e3,
                       batches=svc.stats.n_batches,
                       occupancy=svc.stats.mean_occupancy,
                       ingest=dataclasses.asdict(pipe.stats),
                       live=dataclasses.asdict(svc.lockstep_stats))
    finally:
        sess.close()
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t_serve
    out["launches"] = {n: fn.launches for n, fn in kernels.items()}
    out["collectives"] = dict(compat.stats)
    compat.stats = None
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def served_checked(dev, cfg, outs, serve_in, resident, card):
    """15c's checks in the parent, after the ranks exited: rank 0's rows
    against phase 6's, the new documents' rows against a single-device
    session over the same store, every rank's batches and launches.
    Returns B1's and B2's launches on the ranks."""
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore
    lead = outs[0]["serve"]
    if not lead["leader"] or any(o["serve"]["leader"] for o in outs[1:]):
        fail("mesh 15c: rank 0 is not the only leader")
    if lead["errors"]:
        fail(f"mesh 15c: serving under writes: {lead['errors'][:3]}")
    at = 0
    for l, res in enumerate(resident):
        for r in range(len(res.doc_ids)):
            if not same_row(lead["packed_rows"][at], res, r):
                fail(f"mesh 15c gpu_packed: row {r} of request L={l + 1} "
                     "differs from phase 6's")
            at += 1
    for j, (row, (d, sc)) in enumerate(zip(lead["rows"], serve_in["top1"])):
        if int(row.doc_ids[0]) != int(d) or (
                np.float32(row.scores[0]).view(np.uint32)
                != np.float32(sc).view(np.uint32)):
            fail(f"mesh 15c: served self-query {j} (doc {int(d)}) gave "
                 f"{int(row.doc_ids[0])} at {row.scores[0]!r}, resident "
                 f"{sc!r}")
    ing = lead["ingest"]
    if ing["seals"] < MESH_APPENDS // MESH_SEAL_DOCS or ing["compactions"] < 1:
        fail(f"mesh 15c: {ing['seals']} seals and {ing['compactions']} "
             "folds under writes")
    sess = FlashSearchSession(FlashStore.open(str(MESH_ROOT / "store")), cfg,
                              dev, "gpu")
    try:
        for j, (q, row) in enumerate(zip(serve_in["new_queries"],
                                         lead["new_rows"])):
            want = sess.search(Query(q[0][None], q[1][None]))
            if not same_row(row, want, 0):
                fail(f"mesh 15c: new document query {j} differs from a "
                     "single-device session over the same store")
            if int(row.doc_ids[0]) < N_DOCS:
                fail(f"mesh 15c: new document query {j} ranked doc "
                     f"{int(row.doc_ids[0])} first")
    finally:
        sess.close()
    launches = {}
    for r, o in enumerate(outs):
        sv = o["serve"]
        for part in ("packed", "live"):
            if sv[part]["batches"] != lead[part]["batches"] or sv[part][
                    "failed"]:
                fail(f"mesh 15c rank {r} {part}: {sv[part]} against the "
                     f"leader's {lead[part]}")
        if min(sv["launches"].values()) <= 0:
            fail(f"mesh 15c rank {r}: launches {sv['launches']}")
        for name, n in sv["launches"].items():
            launches[name] = launches.get(name, 0) + n
        st, col = sv["live"], sv["collectives"]
        say(f"mesh 15c rank {r} ({'leads' if r == 0 else 'follows'}): "
            f"launches {sv['launches']}; batches gpu_packed "
            f"{sv['packed']['batches']}, gpu {st['batches']}; records "
            f"{st['records']}, broadcast {st['broadcast_s'] * 1e3:.1f} ms in "
            f"all ({st['broadcast_s'] * 1e3 / max(st['records'], 1):.3f} ms "
            f"a record{', waits for the leader included' if r else ''}), "
            f"end-of-batch reductions {st['agree_s'] * 1e3:.1f} ms; engine "
            f"collectives {col.get('calls', 0)} calls, "
            f"{col.get('seconds', 0.0):.2f} s = "
            f"{col.get('seconds', 0.0) / sv['serve_s']:.3f} of the gpu "
            f"service's {sv['serve_s']:.2f} s; 15c-2 wall {sv['wall_s']:.1f}"
            f" s; {card}")
    lat = lead["lat_ms"]
    n = len(lead["rows"])
    say(f"mesh 15c-2 (2 x 2 over gloo, rank 0 leads): {n} L=1 "
        f"self-queries from {MESH_CLIENTS} clients in "
        f"{lead['wall_serve_s']:.2f} s -> {n / lead['wall_serve_s']:.1f} QPS; "
        f"latency p50 {np.percentile(lat, 50):.1f} ms p99 "
        f"{np.percentile(lat, 99):.1f} ms; {lead['batches']} batches, mean "
        f"occupancy {lead['occupancy']:.2f}; writer {MESH_APPENDS} appends in "
        f"{lead['writer_s']:.2f} s; {ing['seals']} seals, "
        f"{ing['compactions']} folds; every top-1 its own document at the "
        f"resident score bit for bit; the 2 new documents equal a "
        f"single-device session; gpu_packed's rows equal phase 6's; store "
        f"copied in {serve_in['copy_s']:.1f} s; {card}")
    return launches


def stage_summary(obs) -> str:
    """The session's ``stage_ms`` histograms: the registry's median (its
    bucket-interpolated p50), the mean and the count, in ms."""
    parts = []
    for stage in STAGES:
        h = obs.registry.histogram("stage_ms", stage=stage).summary()
        parts.append(f"{stage} p50 {h['p50']} mean {h['mean']} "
                     f"(n={h['count']})")
    return "; ".join(parts)


def store_phase(torch, dev, cfg, corpus, requests, resident, kernels,
                query):
    """Phase 6b: the 2^20 documents as a FlashStore of 16 segments,
    streamed cold and warm through one FlashSearchSession a backend, all
    sharing one slab cache; approx; AutoTiling's tiles; B1-B3 against
    their plain versions at the store's new shapes. Returns the launches
    the store's requests (cold, warm, approx) made."""
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.core.engine import PatternSearchEngine
    from repro_torch.kernels import fused
    from repro_torch.kernels.sparse_match import (sparse_match,
                                                  sparse_match_plain)
    from repro_torch.kernels.sparse_match_packed import (
        pack, sparse_match_packed, sparse_match_packed_plain)
    from repro_torch.kernels.tiling import AutoTiling
    from repro_torch.obs import Obs
    from repro_torch.serve import Query, QueryOptions
    from repro_torch.storage import FlashSearchSession, FlashStore, SlabCache

    # -- build the store ---------------------------------------------------
    t_phase = time.perf_counter()
    root = STORE_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    store = FlashStore.create(str(root), vocab_size=cfg.vocab_size,
                              docs_per_segment=STORE_SEGMENT_DOCS)
    store.append_corpus(corpus)
    info = store.stats()
    say(f"store: {info.n_docs} docs in {info.n_segments} segments of "
        f"{STORE_SEGMENT_DOCS}, built in {time.perf_counter() - t0:.1f} s, "
        f"{info.n_bytes / 1e6:.1f} MB on disk, filter {info.filter_kind}")
    n_seg = info.n_segments
    if info.n_docs != N_DOCS or n_seg != N_DOCS // STORE_SEGMENT_DOCS:
        fail(f"store holds {info.n_docs} docs in {n_seg} segments")

    # -- cold, then warm, all backends on one slab cache -------------------
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated(dev)
    cache = SlabCache(STORE_CACHE_BYTES)
    sessions = {}
    for backend in ("gpu", "gpu_packed", "gpu_fused"):
        cold_obs, warm_obs = Obs(), Obs()
        cold = FlashSearchSession(store, cfg, dev, backend, slab_cache=cache,
                                  obs=cold_obs)
        idx, qi, qv = requests[-1]
        t0 = time.perf_counter()
        r = cold.search(Query(qi, qv))
        cold_ms = (time.perf_counter() - t0) * 1e3
        st = cold.last_stats
        if (st.cache_misses, st.docs_scored) != (n_seg, N_DOCS):
            fail(f"store {backend} cold: {st}")
        if not same(r, resident[-1]):
            fail(f"store {backend}: the cold L=8 request differs from the "
                 "resident result")
        say(f"store {backend} cold L=8: {cold_ms:.1f} ms, "
            f"{st.cache_misses} misses, segments_skipped "
            f"{st.segments_skipped}, docs_scored {st.docs_scored}; "
            f"stage_ms {stage_summary(cold_obs)}; prefetch_wait is the "
            "consumer's wait for the loader thread")
        # a second session on the same cache: its requests are all hits
        warm = FlashSearchSession(store, cfg, dev, backend, slab_cache=cache,
                                  obs=warm_obs)
        warm_ms = []
        for l, (idx, qi, qv) in enumerate(requests):
            t0 = time.perf_counter()
            r = warm.search(Query(qi, qv))
            warm_ms.append((time.perf_counter() - t0) * 1e3)
            st = warm.last_stats
            if (st.cache_hits, st.docs_scored) != (n_seg, N_DOCS):
                fail(f"store {backend} warm L={l + 1}: {st}")
            if not same(r, resident[l]):
                fail(f"store {backend}: warm request L={l + 1} differs from "
                     "the resident result")
            if not np.array_equal(r.doc_ids[:, 0], idx):
                fail(f"store {backend}: a self-query did not rank itself "
                     "first")
        say(f"store {backend} warm (L=1..8, {n_seg} hits each): ms "
            f"{', '.join(f'{t:.1f}' for t in warm_ms)}; stage_ms "
            f"{stage_summary(warm_obs)}")
        sessions[backend] = (cold, warm)
    torch.cuda.synchronize()
    say(f"store: the three backends' cold and warm results equal the "
        f"resident ones bit for bit; segments_skipped is 0 because the "
        f"synthesized documents draw words from the whole vocabulary, so "
        f"every segment's filter holds some of each query's words; slab "
        f"cache {len(cache)} slabs, {cache.nbytes} device bytes, "
        f"torch.cuda.memory_allocated grew by "
        f"{torch.cuda.memory_allocated(dev) - alloc0}")

    # -- approx: sessions without a cache (a hit would skip the pool) -----
    opts = QueryOptions(mode="approx", candidates=APPROX_CANDIDATES)
    idx, qi, qv = requests[-1]
    approx = {}
    for backend in ("gpu", "gpu_packed", "gpu_fused", "torch"):
        sess = FlashSearchSession(store, cfg, dev, backend, cache_bytes=0)
        t0 = time.perf_counter()
        approx[backend] = sess.search(Query(qi, qv), options=opts)
        ms = (time.perf_counter() - t0) * 1e3
        st = sess.last_stats
        sess.close()
        say(f"store approx {backend} L=8 candidates={APPROX_CANDIDATES}: "
            f"{ms:.1f} ms, docs_scored {st.docs_scored} of {N_DOCS}, "
            f"approx_segments {st.approx_segments}")
        if st.approx_segments != n_seg or st.docs_scored * 16 > N_DOCS:
            fail(f"store approx {backend}: {st}")
        if not np.array_equal(approx[backend].doc_ids[:, 0], idx):
            fail(f"store approx {backend}: a self-query did not rank itself "
                 "first")
        if not same(approx[backend], approx["gpu"]):
            fail(f"store approx: {backend} differs from gpu")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    say(f"store launches (cold, warm, approx): {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched by the store's requests")
    for pair in sessions.values():
        for sess in pair:
            sess.close()
    if len(cache):
        fail(f"{len(cache)} slabs left in the cache after the sessions closed")
    del cache, sessions, approx

    # -- AutoTiling's tiles are staged in shared memory --------------------
    picks = {}
    for nnz_pad in STORE_NNZ_PADS:
        for block_docs in (fused.MAX_TILE_ROWS, cfg.block_docs):
            tiling = AutoTiling(block_docs, cfg.block_query)
            bd = tiling.doc_tile(nnz_pad=nnz_pad, n_docs=N_DOCS)
            picks[nnz_pad, block_docs] = bd
            for Lp in (1, 2, 4, 8):
                for Qm in (Lp * tiling.query_tile(Lp), 8192):
                    n = fused.stages(dev, bd * (1 + nnz_pad), bd, Qm, Lp)
                    if n != 1:
                        fail(f"AutoTiling's tile {bd} x (1 + {nnz_pad}) at "
                             f"L={Lp}, Qm={Qm}: {n} stages, want 1")
    say(f"AutoTiling doc tiles (nnz_pad, block_docs cap) -> rows: {picks}; "
        "each staged whole in shared memory (fused_match_topk_stages 1) at "
        "L buckets 1-8, Qm up to 8192")
    cfg512 = dataclasses.replace(cfg, nnz_pad=512)
    c512 = corpus_lib.synthesize(STORE_SEGMENT_DOCS, cfg.vocab_size,
                                 cfg.avg_nnz_per_doc, 512, seed=SEED)
    auto = PatternSearchEngine(c512, cfg512, dev, "gpu_fused",
                               tiling=AutoTiling(cfg.block_docs,
                                                 cfg.block_query))
    fixed = PatternSearchEngine(c512, cfg512, dev, "gpu_fused")
    rng = np.random.default_rng(SEED)
    for L in (1, 8):
        idx = rng.integers(0, STORE_SEGMENT_DOCS, L)
        qs = [corpus_lib.make_query(c512, int(i), cfg.max_query_nnz)
              for i in idx]
        q = Query(np.stack([x[0] for x in qs]), np.stack([x[1] for x in qs]))
        a, b = auto.search(q), fixed.search(q)
        if not same(a, b) or not np.array_equal(a.doc_ids[:, 0], idx):
            fail(f"AutoTiling ({auto._block_docs} rows) and FixedTiling "
                 f"({fixed._block_docs}) differ at nnz_pad 512, L={L}")
    say(f"AutoTiling at nnz_pad 512, {STORE_SEGMENT_DOCS} docs: tiles of "
        f"{auto._block_docs} rows (kp {min(cfg.top_k, auto._block_docs)}) "
        f"match FixedTiling's {fixed._block_docs} bit for bit at L=1 and 8")
    del auto, fixed, c512

    # -- B1-B3 against their plain versions at the store's new shapes ------
    q_ids, q_vals, q_norms = query
    rng = np.random.default_rng(SEED + 1)
    checked = []
    for D in NEW_SHAPE_DOCS:
        lo = int(rng.integers(0, N_DOCS - D))
        rows = corpus.slice_rows(lo, lo + D)
        ids = torch.from_numpy(rows.ids).to(dev)
        vals = torch.from_numpy(rows.vals).to(dev)
        words = torch.from_numpy(pack(rows.ids, rows.vals).view(np.int32)
                                 ).to(dev)
        pairs = [("B1", sparse_match(ids, vals, q_ids, q_vals),
                  sparse_match_plain(ids, vals, q_ids, q_vals)),
                 ("B2", sparse_match_packed(words, q_ids, q_vals),
                  sparse_match_packed_plain(words, q_ids, q_vals))]
        stream = fused.corpus_to_stream(rows)
        for bd in NEW_SHAPE_BLOCK_DOCS + (cfg.block_docs,):
            tiles, _, _ = fused.tile_stream(stream, block_docs=bd,
                                            nnz_pad=cfg.nnz_pad,
                                            pad_docs_to=D)
            tiles = torch.from_numpy(tiles.view(np.int32)).to(dev)
            kp = min(cfg.top_k, bd)
            got = fused.fused_match_topk(tiles, q_ids, q_vals, q_norms,
                                         block_docs=bd, kp=kp)
            want = fused.fused_match_topk_plain(tiles, q_ids, q_vals,
                                                q_norms, block_docs=bd, kp=kp)
            if not torch.equal(got[1], want[1]):
                fail(f"B3 at D={D}, block_docs={bd}: candidate ids differ "
                     "from the plain version")
            pairs.append((f"B3 bd={bd}", got[0], want[0]))
        for name, got, want in pairs:
            if not torch.equal(got, want):
                fail(f"{name} at D={D} differs from its plain version")
            checked.append(f"{name} D={D}")
    torch.cuda.synchronize()
    say(f"kernels vs plain at the store's shapes (query: the L=8 request): "
        f"{', '.join(checked)} agree bit for bit")
    say(f"store phase: {time.perf_counter() - t_phase:.1f} s wall")
    return launches


def ell_docs(c, rows):
    """``(doc_id, [(word, count), ...])`` of corpus rows, for appends."""
    out = []
    for r in rows:
        keep = c.ids[r] >= 0
        out.append((int(c.doc_ids[r]), list(zip(
            c.ids[r][keep].tolist(), c.vals[r][keep].astype(int).tolist()))))
    return out


def score_spans(traces):
    """(memtable, segment) score-span ms of exported traces: a query's
    memtable span holds its upload and its launch."""
    mem, seg = [], []

    def walk(node):
        for ch in node["children"]:
            if ch["name"] == "score":
                (mem if ch["attrs"].get("segment") == "memtable"
                 else seg).append(ch["dur_ms"])
            walk(ch)
    for t in traces:
        walk(t["root"])
    return mem, seg


def trace_parts(trace):
    """One exported query trace in parts, ms: the whole, the plan, the
    memtable's score span, the segments' score spans, the loads from disk
    (their count and decode + upload), the prefetch wait and the merge."""
    parts = {"query": trace["root"]["dur_ms"], "plan": 0.0, "memtable": 0.0,
             "segments": 0.0, "disk_loads": 0, "disk_ms": 0.0,
             "prefetch_wait": trace["root"]["attrs"].get("prefetch_wait_ms",
                                                         0.0),
             "merge": 0.0}
    for ch in trace["root"]["children"]:
        a = ch["attrs"]
        if ch["name"] in ("plan", "merge"):
            parts[ch["name"]] += ch["dur_ms"]
        elif ch["name"] == "score":
            parts["memtable" if a.get("segment") == "memtable"
                  else "segments"] += ch["dur_ms"]
        elif ch["name"] == "load" and a.get("source") == "disk":
            parts["disk_loads"] += 1
            parts["disk_ms"] += a.get("decode_ms", 0.0) + a.get("upload_ms",
                                                                0.0)
    return {k: round(v, 3) for k, v in parts.items()}


def profile_summary(answer) -> str:
    """Check phase 6c's /debug/profile answer: 200, and a trace that
    names B1's kernel and holds CPU ops of a thread other than the HTTP
    one that captured it. Returns what the trace holds."""
    if answer is None:
        fail("live profile: the capture never ran")
    code, body, ms = answer
    if code != 200:
        fail(f"live profile: /debug/profile answered {code}:\n{body}")
    ans = json.loads(body)
    events = json.load(open(ans["file"]))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    b1 = sum(all(p in k for p in B1_TRACE_NAME) for k in kernels)
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops[e.get("tid")] = ops.get(e.get("tid"), 0) + 1
    others = {t: n for t, n in ops.items() if t != ans["thread"]}
    if not b1 or not others:
        fail(f"live profile: {b1} launches of B1's kernel and CPU ops of "
             f"{len(others)} threads other than the HTTP one in "
             f"{ans['file']}")
    return (f"/debug/profile?ms={ans['captured_ms']} answered 200 in "
            f"{ms:.0f} ms; {ans['file']} {os.path.getsize(ans['file'])} "
            f"bytes, {len(kernels)} kernel launches ({b1} of B1), CPU ops "
            f"of {len(ops)} threads (HTTP thread {ans['thread']}: "
            f"{ops.get(ans['thread'], 0)}; the others "
            f"{sorted(others.values(), reverse=True)})")


def med(xs):
    return f"{statistics.median(xs):.3f}" if xs else "none"


def hist_line(obs, name, **labels):
    h = obs.registry.histogram(name, **labels).summary()
    return f"p50 {h['p50']} mean {h['mean']} (n={h['count']})"


def live_phase(torch, dev, cfg, corpus, resident, kernels):
    """Phase 6c: phase 6b's store served through the coalescing
    SearchService while a writer appends, seals and the compactor folds,
    scraped and profiled through the live telemetry plane; batched
    against serial on four backends; WAL replay; the launcher. Returns
    the launches the phase made."""
    import threading
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.launch import search_serve
    from repro_torch.obs import Obs
    from repro_torch.obs.slo import SLOMonitor, default_slos
    from repro_torch.serve import Query
    from repro_torch.storage import FlashSearchSession, FlashStore, SlabCache

    t_phase = time.perf_counter()
    n_serve = LIVE_CLIENTS * LIVE_REQUESTS
    rng = np.random.default_rng(SEED + 2)
    idx = rng.integers(0, N_DOCS, n_serve)
    queries = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
               for i in idx]
    # the resident engine's top-1 of each self-query (phase 6's engine),
    # before the counters are set to 0
    top1 = []
    for lo in range(0, n_serve, 8):
        q = queries[lo:lo + 8]
        r = resident.search(Query(np.stack([x[0] for x in q]),
                                  np.stack([x[1] for x in q])))
        top1 += list(zip(r.doc_ids[:, 0], r.scores[:, 0]))
    if [int(d) for d, _ in top1] != [int(i) for i in idx]:
        fail("live: a resident self-query did not rank itself first")
    n_new = LIVE_APPENDS + 2 + LIVE_REPLAY
    new = corpus_lib.synthesize(n_new, cfg.vocab_size, cfg.avg_nnz_per_doc,
                                cfg.nnz_pad, seed=SEED + 3)
    new.doc_ids[:] += N_DOCS
    new_docs = ell_docs(new, range(n_new))

    for fn in kernels.values():
        fn.launches = 0
    store = FlashStore.open(str(STORE_ROOT))
    cache = SlabCache(STORE_CACHE_BYTES)
    obs = Obs(trace_sample=1, keep_traces=4096)
    sess = FlashSearchSession(store, cfg, dev, "gpu", slab_cache=cache,
                              obs=obs)
    pipe = sess.enable_ingest(seal_docs=LIVE_SEAL_DOCS)
    t0 = time.perf_counter()
    sess.search(Query(np.stack([x[0] for x in queries[:8]]),
                      np.stack([x[1] for x in queries[:8]])))
    say(f"live: store reopened, {store.n_segments} segments; first (cold) "
        f"L=8 request {(time.perf_counter() - t0) * 1e3:.1f} ms")
    # the telemetry plane, built on this thread: the profiler's first
    # session runs here (and loads CUPTI), so a capture from the HTTP
    # thread covers every thread
    t0 = time.perf_counter()
    srv = sess.start_telemetry(
        slo_monitor=SLOMonitor(obs, default_slos("store", latency_ms=250.0)),
        profile_dir=str(PROFILE_ROOT))
    say(f"live telemetry: {srv.url('/')} up in "
        f"{time.perf_counter() - t0:.2f} s (the profiler's first session "
        f"on the thread that built it)")

    # -- 2. serve under writes ----------------------------------------------
    svc = sess.service(max_batch=8, max_delay_ms=2.0)
    lats = [[] for _ in range(LIVE_CLIENTS)]
    rows = [None] * n_serve
    errors = []
    writer_s = {}
    capture = {}
    load_done = threading.Event()

    def profile():
        # once the load is under way: a /debug/profile over its middle
        while sum(map(len, lats)) < 64 and not load_done.is_set():
            load_done.wait(0.01)
        capture["answer"] = http_get(
            srv.url(f"/debug/profile?ms={PROFILE_MS}"))

    def client(t):
        try:
            for j in range(t * LIVE_REQUESTS, (t + 1) * LIVE_REQUESTS):
                t1 = time.perf_counter()
                rows[j] = sess.submit(Query(*queries[j])).result()
                lats[t].append(time.perf_counter() - t1)
        except Exception as e:
            errors.append(e)

    def writer():
        t1 = time.perf_counter()
        try:
            for d, p in new_docs[:LIVE_APPENDS]:
                sess.append(d, p)
        except Exception as e:
            errors.append(e)
        writer_s["wall"] = time.perf_counter() - t1

    threads = [threading.Thread(target=writer, name="live-writer")] + [
        threading.Thread(target=client, args=(t,))
        for t in range(LIVE_CLIENTS)]
    profiler = threading.Thread(target=profile, name="live-profile")
    scraper = Scraper(srv).start()
    profiler.start()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    load_done.set()
    profiler.join()
    scraper.stop("live telemetry")
    if errors:
        fail(f"live: serving under writes: {errors[:3]}")
    for j, (row, (d, sc)) in enumerate(zip(rows, top1)):
        if int(row.doc_ids[0]) != int(d) or (
                np.float32(row.scores[0]).view(np.uint32)
                != np.float32(sc).view(np.uint32)):
            fail(f"live: served self-query {j} (doc {int(d)}) gave "
                 f"{int(row.doc_ids[0])} at {row.scores[0]!r}, resident "
                 f"{sc!r}")
    lat = np.concatenate([np.asarray(x) for x in lats]) * 1e3
    st = svc.stats
    seals, folds = pipe.stats.seals, pipe.stats.compactions
    if seals < LIVE_APPENDS // LIVE_SEAL_DOCS or folds < 1:
        fail(f"live: {seals} seals and {folds} folds under writes")
    traces = obs.tracer.export()
    mem, seg = score_spans(traces)
    batch_ms = [t["root"]["dur_ms"] for t in traces[1:]]
    say(f"live serve under writes: {n_serve} L=1 self-queries from "
        f"{LIVE_CLIENTS} clients in {wall:.2f} s -> {n_serve / wall:.1f} QPS;"
        f" latency p50 {np.percentile(lat, 50):.1f} ms p99 "
        f"{np.percentile(lat, 99):.1f} ms; batches {st.n_batches}, mean "
        f"occupancy {st.mean_occupancy:.2f}, flushes {st.flushes}; writer "
        f"{LIVE_APPENDS} appends in {writer_s['wall']:.2f} s -> "
        f"{LIVE_APPENDS / writer_s['wall']:.0f} appends/s under load; "
        f"{seals} seals, {folds} folds ({pipe.stats.segments_folded} "
        f"segments folded); every result ranks its document first at its "
        f"resident score bit for bit")
    say(f"live stage_ms: seal {hist_line(obs, 'ingest_seal_ms')}; fold "
        f"{hist_line(obs, 'ingest_fold_ms')}; queue wait "
        f"{hist_line(obs, 'serve_queue_wait_ms')}; {stage_summary(obs)}; "
        f"score spans: memtable median {med(mem)} ms (n={len(mem)}), a "
        f"segment's {med(seg)} ms (n={len(seg)})")
    say(f"live batch search ms (traces): p50 "
        f"{np.percentile(batch_ms, 50):.1f} p99 "
        f"{np.percentile(batch_ms, 99):.1f} max {max(batch_ms):.1f}; the "
        f"slowest three in parts: "
        + "; ".join(str(trace_parts(t)) for t in sorted(
            traces[1:], key=lambda t: -t["root"]["dur_ms"])[:3]))
    say(f"live telemetry (the QPS and p50/p99 above are under it): "
        f"{scraper.summary()}")
    say(f"live profile: {profile_summary(capture.get('answer'))}")
    say("live slo: " + "; ".join(
        f"{st.name} {st.state} burn {st.burn_rate:.3f} window_events "
        f"{st.window_events} good {st.good_fraction}"
        for st in srv.slo_monitor.evaluate()))

    # -- 3. batched against serial on four backends --------------------------
    sess.flush_ingest()
    for d, p in new_docs[LIVE_APPENDS:LIVE_APPENDS + 2]:
        sess.append(d, p)
    snap = pipe.capture()
    mem_corpus, _ = snap.memtable_corpus(cfg.nnz_pad)
    t0 = time.perf_counter()
    mem_corpus.pad_docs_to(store.max_segment_docs)
    say(f"live memtable: {mem_corpus.n_docs} documents padded on the host "
        f"to the {store.max_segment_docs}-row launch shape in "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms a query (outside the "
        f"score span)")
    snap.close()
    picks = [(corpus, int(i)) for i in idx[:3]] + [
        (new, r) for r in (0, LIVE_APPENDS // 2, LIVE_APPENDS - 1,
                           LIVE_APPENDS, LIVE_APPENDS + 1)]
    q8 = [corpus_lib.make_query(c, r, cfg.max_query_nnz) for c, r in picks]
    want_ids = [int(c.doc_ids[r]) for c, r in picks]
    batch = Query(np.stack([x[0] for x in q8]), np.stack([x[1] for x in q8]))
    first = None
    for backend in ("gpu", "torch", "gpu_packed", "gpu_fused"):
        if backend != "gpu":
            # hand the write path on: the next session replays the WAL's
            # two memtable documents; the shared cache keeps the ELL slabs
            nxt = FlashSearchSession(store, cfg, dev, backend,
                                     slab_cache=cache, obs=Obs())
            sess.close()
            sess = nxt
            if sess.enable_ingest(seal_docs=LIVE_SEAL_DOCS).stats.replayed != 2:
                fail(f"live {backend}: the WAL did not replay 2 documents")
        t0 = time.perf_counter()
        futs = [sess.submit(Query(*q)) for q in q8]
        served = [f.result() for f in futs]
        b_ms = (time.perf_counter() - t0) * 1e3
        before = {n: fn.launches for n, fn in kernels.items()}
        t0 = time.perf_counter()
        serial = sess.search(batch)
        s_ms = (time.perf_counter() - t0) * 1e3
        sst = sess.last_stats
        torch.cuda.synchronize()
        delta = {n: fn.launches - before[n] for n, fn in kernels.items()}
        for l, row in enumerate(served):
            if not (np.array_equal(row.doc_ids, serial.doc_ids[l])
                    and np.array_equal(row.scores.view(np.uint32),
                                       serial.scores[l].view(np.uint32))):
                fail(f"live {backend}: batched row {l} differs from serial")
        if list(serial.doc_ids[:, 0]) != want_ids:
            fail(f"live {backend}: a self-query did not rank itself first: "
                 f"{list(serial.doc_ids[:, 0])}")
        if first is None:
            first = serial
        elif not same(serial, first):
            fail(f"live {backend}: differs from gpu")
        if sst.memtable_docs != 2:
            fail(f"live {backend}: memtable_docs {sst.memtable_docs}")
        launched = sum(delta.values())
        if backend != "torch" and launched != sst.segments_scored + 1:
            fail(f"live {backend}: {launched} launches for "
                 f"{sst.segments_scored} segments and the memtable")
        say(f"live {backend}: 8 self-queries (3 base, 3 sealed, 2 in the "
            f"memtable) through submit in {b_ms:.1f} ms equal the serial "
            f"search ({s_ms:.1f} ms, {sst.segments_scored} segments + "
            f"memtable, {sst.cache_hits} cache hits; launches {delta})")
    say("live: batched equals serial and the four backends agree bit for "
        "bit; the memtable branch launched on gpu, gpu_packed and gpu_fused")

    # -- 4. WAL replay --------------------------------------------------------
    sess.flush_ingest()
    for d, p in new_docs[LIVE_APPENDS + 2:]:
        sess.append(d, p)
    sess.close()                      # unsealed: the WAL holds the 100
    store = FlashStore.open(str(STORE_ROOT))
    sess = FlashSearchSession(store, cfg, dev, "gpu_fused", cache_bytes=0)
    t0 = time.perf_counter()
    replayed = sess.enable_ingest(seal_docs=LIVE_SEAL_DOCS).stats.replayed
    replay_s = time.perf_counter() - t0
    last = corpus_lib.make_query(new, n_new - 1, cfg.max_query_nnz)
    r = sess.search(Query(last[0][None], last[1][None]))
    say(f"live replay: {replayed} documents replayed from the WAL in "
        f"{replay_s:.4f} s; the last appended document ranks "
        f"{'itself' if int(r.doc_ids[0, 0]) == int(new.doc_ids[-1]) else 'NOT'}"
        f" first ({int(r.doc_ids[0, 0])}, memtable_docs "
        f"{sess.last_stats.memtable_docs})")
    if replayed != LIVE_REPLAY or int(r.doc_ids[0, 0]) != int(new.doc_ids[-1]):
        fail("live: WAL replay")
    sess.flush_ingest()
    sess.close()

    # -- 5. the launcher -------------------------------------------------------
    t0 = time.perf_counter()
    out = search_serve.main([
        "--store", str(STORE_ROOT), "--ingest", str(LIVE_APPENDS),
        "--seal-docs", "384", "--backend", "gpu",
        "--vocab", str(cfg.vocab_size), "--avg-nnz", str(cfg.avg_nnz_per_doc),
        "--nnz-pad", str(cfg.nnz_pad), "--top-k", str(cfg.top_k),
        "--query-nnz", str(cfg.nnz_pad), "--cache-mb", str(LIVE_CACHE_MB),
        "--clients", str(LIVE_CLIENTS), "--requests", str(LIVE_REQUESTS),
        "--trace-sample", "1", "--seed", str(SEED),
        "--telemetry-port", "0", "--slo-ms", "250",
        "--profile-dir", str(PROFILE_ROOT)])
    mem, seg = score_spans(out["obs"].tracer.export())
    say(f"live search_serve: {time.perf_counter() - t0:.1f} s; "
        f"{out['qps']:.1f} QPS, p50 {out['p50_ms']:.1f} ms, p99 "
        f"{out['p99_ms']:.1f} ms, batches {out['batches']}, occupancy "
        f"{out['mean_occupancy']:.2f}, flushes {out['flushes']}, "
        f"{out['appends_per_s']:.0f} appends/s, {out['seals']} seals, "
        f"{out['folds']} folds; stage_ms {stage_summary(out['obs'])}; score "
        f"spans of the last {len(out['obs'].tracer.recent)} traces: memtable "
        f"median {med(mem)} ms (n={len(mem)}), a segment's {med(seg)} ms "
        f"(n={len(seg)})")
    say(f"live search_serve telemetry {out['telemetry_url']}: " + "; ".join(
        f"{name} {d['state']} burn {d['burn_rate']} window_events "
        f"{d['window_events']}" for name, d in out["slo"].items()))
    if out["queries"] != n_serve or out["seals"] < 1 or not mem or sorted(
            out["slo"]) != ["store-availability", "store-latency"]:
        fail(f"live search_serve: {out}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    say(f"live launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched in the live phase")
    say(f"live phase: {time.perf_counter() - t_phase:.1f} s wall on "
        f"{nvidia_smi_line()}")
    return launches


class _Replica:
    """Stands in for one shard replica's session in phase 6d: it raises
    (a dead replica), or its searches wait for ``gate`` (a straggler) and
    set ``done`` when they end."""

    def __init__(self, inner, *, gate=None, dead=False):
        import threading
        self.inner = inner
        self.gate = gate
        self.dead = dead
        self.done = threading.Event()

    def search(self, *args, **kwargs):
        if self.dead:
            raise OSError("replica storage gone")
        try:
            if self.gate is not None:
                self.gate.wait()
            return self.inner.search(*args, **kwargs)
        finally:
            self.done.set()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def cluster_phase(torch, dev, cfg, corpus, requests, resident, engine,
                  kernels):
    """Phase 6d: the 2^20 documents as a 4-shard x 2-replica ShardedStore,
    served through FlashClusterSession on gpu, gpu_packed and gpu_fused,
    by 16 concurrent clients, through failover, a hedge and a partial
    gather, under live writes, and by ``search_serve --cluster``. Returns
    the launches the phase made."""
    import threading
    from repro_torch.cluster import FlashClusterSession, build_sharded_store
    from repro_torch.core import corpus as corpus_lib
    from repro_torch.core.engine import _merge_results
    from repro_torch.launch import search_serve
    from repro_torch.obs import Obs
    from repro_torch.serve import HedgePolicy, Query, QueryOptions

    t_phase = time.perf_counter()
    n_serve = CLUSTER_CLIENTS * CLUSTER_REQUESTS
    rng = np.random.default_rng(SEED + 4)
    idx = rng.integers(0, N_DOCS, n_serve)
    queries = [corpus_lib.make_query(corpus, int(i), cfg.max_query_nnz)
               for i in idx]
    # the resident engine's top-1 of each self-query (phase 6's engine),
    # before the counters are set to 0
    top1 = []
    for lo in range(0, n_serve, 8):
        q = queries[lo:lo + 8]
        r = engine.search(Query(np.stack([x[0] for x in q]),
                                np.stack([x[1] for x in q])))
        top1 += list(zip(r.doc_ids[:, 0], r.scores[:, 0]))
    if [int(d) for d, _ in top1] != [int(i) for i in idx]:
        fail("cluster: a resident self-query did not rank itself first")
    new = corpus_lib.synthesize(CLUSTER_APPENDS, cfg.vocab_size,
                                cfg.avg_nnz_per_doc, cfg.nnz_pad,
                                seed=SEED + 5)
    new.doc_ids[:] += N_DOCS
    new_docs = ell_docs(new, range(CLUSTER_APPENDS))
    by_backend = {"gpu": "sparse_match", "gpu_packed": "sparse_match_packed",
                  "gpu_fused": "fused_match_topk"}

    for fn in kernels.values():
        fn.launches = 0

    def counts():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in kernels.items()}

    def scored(obs):
        """Slabs scored by any replica attempt under ``obs``: one
        ``stage_ms{score}`` observation, and one kernel launch, each."""
        return obs.registry.histogram("stage_ms", stage="score").count

    def reported(obs):
        """Scored segments summed over the cluster queries' ClusterStats."""
        return obs.registry.counter("segments_scored_total",
                                    surface="cluster").value

    def check(step, backend, before, obs, s0, r0, exact):
        """The step's launches: one a slab any attempt scored and, where
        no hedge loser or straggler ran (``exact``), the ClusterStats
        sum."""
        now = counts()
        delta = {n: now[n] - before[n] for n in now}
        n_scored, n_reported = scored(obs) - s0, reported(obs) - r0
        want = dict.fromkeys(delta, 0)
        want[by_backend[backend]] = n_scored
        if delta != want or (exact and n_scored != n_reported):
            fail(f"cluster {step}: launches {delta}, slabs scored "
                 f"{n_scored}, ClusterStats segments {n_reported}")
        return (f"launches {delta[by_backend[backend]]} = slabs scored; "
                f"ClusterStats segments {n_reported}")

    # -- 2. build --------------------------------------------------------------
    root = CLUSTER_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cl = build_sharded_store(str(root), corpus=corpus,
                             n_shards=CLUSTER_SHARDS,
                             replicas=CLUSTER_REPLICAS, policy="hash",
                             vocab_size=cfg.vocab_size,
                             docs_per_segment=STORE_SEGMENT_DOCS)
    build_s = time.perf_counter() - t0
    per = [[cl.store(s, r).stats() for r in range(CLUSTER_REPLICAS)]
           for s in range(CLUSTER_SHARDS)]
    n_seg = sum(reps[0].n_segments for reps in per)
    mb = [sum(reps[r].n_bytes for reps in per) / 1e6
          for r in range(CLUSTER_REPLICAS)]
    say(f"cluster: {N_DOCS} docs as {CLUSTER_SHARDS} shards x "
        f"{CLUSTER_REPLICAS} replicas (hash) built in {build_s:.1f} s, "
        f"{' + '.join(f'{m:.1f}' for m in mb)} MB on disk; docs a shard "
        f"{[reps[0].n_docs for reps in per]}, segments a shard "
        f"{[reps[0].n_segments for reps in per]} of <= "
        f"{STORE_SEGMENT_DOCS}, filter {per[0][0].filter_kind}")
    if cl.n_docs != N_DOCS or any(
            [dataclasses.asdict(x) for x in reps] != [dataclasses.asdict(
                reps[0])] * CLUSTER_REPLICAS for reps in per):
        fail(f"cluster: {cl.n_docs} docs, replicas differ: {per}")
    cl.close()

    # -- 3-4. cold and warm on gpu, gpu_packed and gpu_fused -------------------
    def serve_requests(sess, obs, backend):
        before, s0, r0 = counts(), scored(obs), reported(obs)
        idx8, qi, qv = requests[-1]
        t1 = time.perf_counter()
        r = sess.search_typed(Query(qi, qv))
        cold_ms = (time.perf_counter() - t1) * 1e3
        st = sess.last_stats
        # a shard's last segment may hold a few hundred documents, which
        # the vocab filter may skip for a query: every other segment and
        # document is scored
        if (st.segments_total, st.cache_misses) != (
                n_seg, st.segments_scored) or st.segments_skipped > 2 or \
                not same(r, resident[-1]):
            fail(f"cluster {backend} cold L=8: {st}, or differs from the "
                 "resident result")
        n_cold = st.cache_misses
        warm_ms, skipped, hits = [], [], []
        for l, (idx_l, qi, qv) in enumerate(requests):
            t1 = time.perf_counter()
            r = sess.search_typed(Query(qi, qv))
            warm_ms.append((time.perf_counter() - t1) * 1e3)
            st = sess.last_stats
            if (st.segments_total, st.cache_hits) != (
                    n_seg, st.segments_scored) or st.segments_skipped > 2:
                fail(f"cluster {backend} warm L={l + 1}: {st}")
            skipped.append(st.segments_skipped)
            hits.append(st.cache_hits)
            if not same(r, resident[l]) or not np.array_equal(
                    r.doc_ids[:, 0], idx_l):
                fail(f"cluster {backend}: warm request L={l + 1} differs "
                     "from the resident result")
        line = check(f"{backend} requests", backend, before, obs, s0, r0,
                     exact=True)
        say(f"cluster {backend}: cold L=8 {cold_ms:.1f} ms ({n_seg} "
            f"segments, {n_cold} misses); warm L=1..8 ms "
            f"{', '.join(f'{t:.1f}' for t in warm_ms)} (cache hits "
            f"{hits}, skip rate {st.skip_rate:.2f}, segments skipped "
            f"{skipped}); router workers {sess.router._pool._max_workers}; "
            f"launch keys {sess.compile_stats}; {line}; stage_ms "
            f"{stage_summary(obs)}")
        return warm_ms

    obs = Obs()
    sess = FlashClusterSession(str(root), cfg, device=dev, backend="gpu",
                               cache_bytes=STORE_CACHE_BYTES, obs=obs)
    warm_ms = serve_requests(sess, obs, "gpu")
    for backend in ("gpu_packed", "gpu_fused"):
        o = Obs()
        with FlashClusterSession(str(root), cfg, device=dev, backend=backend,
                                 cache_bytes=STORE_CACHE_BYTES,
                                 obs=o) as other:
            serve_requests(other, o, backend)
    say("cluster: gpu, gpu_packed and gpu_fused cold and warm results "
        "equal the resident ones bit for bit")

    # -- 5. 16 clients through submit, scraped -------------------------------
    srv = sess.start_telemetry()

    def healthz():
        code, body, _ = http_get(srv.url("/healthz"))
        if code != 200:
            fail(f"cluster /healthz answered {code}:\n{body}")
        router = json.loads(body)["components"]["router"]
        return json.loads(body)["status"], router["replicas_down"]

    before, s0, r0 = counts(), scored(obs), reported(obs)
    svc = sess.service(max_batch=8, max_delay_ms=2.0)
    lats = [[] for _ in range(CLUSTER_CLIENTS)]
    rows = [None] * n_serve
    errors = []

    def client(t):
        try:
            for j in range(t * CLUSTER_REQUESTS, (t + 1) * CLUSTER_REQUESTS):
                t1 = time.perf_counter()
                rows[j] = sess.submit(Query(*queries[j])).result()
                lats[t].append(time.perf_counter() - t1)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(CLUSTER_CLIENTS)]
    scraper = Scraper(srv).start()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    scraper.stop("cluster telemetry")
    if errors:
        fail(f"cluster clients: {errors[:3]}")
    for j, (row, (d, sc)) in enumerate(zip(rows, top1)):
        if int(row.doc_ids[0]) != int(d) or (
                np.float32(row.scores[0]).view(np.uint32)
                != np.float32(sc).view(np.uint32)):
            fail(f"cluster: served self-query {j} (doc {int(d)}) gave "
                 f"{int(row.doc_ids[0])} at {row.scores[0]!r}, resident "
                 f"{sc!r}")
    lat = np.concatenate([np.asarray(x) for x in lats]) * 1e3
    st = svc.stats
    line = check("clients", "gpu", before, obs, s0, r0, exact=True)
    say(f"cluster clients: {n_serve} L=1 self-queries from "
        f"{CLUSTER_CLIENTS} clients in {wall:.2f} s -> {n_serve / wall:.1f} "
        f"QPS; latency p50 {np.percentile(lat, 50):.1f} ms p99 "
        f"{np.percentile(lat, 99):.1f} ms; batches {st.n_batches}, mean "
        f"occupancy {st.mean_occupancy:.2f}, flushes {st.flushes}; every "
        f"result ranks its document first at its resident score bit for "
        f"bit; {line}")
    say(f"cluster telemetry (the QPS and p50/p99 above are under it): "
        f"{scraper.summary()}")

    # -- 6. failover -------------------------------------------------------------
    router = sess.router
    idx8, qi, qv = requests[-1]
    q = Query(qi, qv)
    before, s0, r0 = counts(), scored(obs), reported(obs)
    flips = [healthz()]
    primary = router._session(0, 0)
    router._sessions[0][0] = _Replica(primary, dead=True)
    t0 = time.perf_counter()
    r = sess.search_typed(q)
    fo_ms = (time.perf_counter() - t0) * 1e3
    st = sess.last_stats
    if not same(r, resident[-1]) or st.failovers != 1 or \
            router.health()[0] != [False, True]:
        fail(f"cluster failover: failovers {st.failovers}, health "
             f"{router.health()}, or the result changed")
    line = check("failover", "gpu", before, obs, s0, r0, exact=True)
    flips.append(healthz())
    router._sessions[0][0] = primary
    router.reset_health()
    flips.append(healthz())
    if flips != [("ok", 0), ("degraded", 1), ("ok", 0)]:
        fail(f"cluster /healthz (status, replicas_down) around the "
             f"failover: {flips}")
    say(f"cluster /healthz around the failover, all 200: "
        f"{' -> '.join(f'{h} (replicas_down {n})' for h, n in flips)}")
    say(f"cluster failover: shard 0's primary raises; the L=8 request "
        f"served by its replica 1 (cold) in {fo_ms:.1f} ms, equal to the "
        f"resident result; failovers {st.failovers}, replica marked down, "
        f"then health reset; {line}")

    # -- 7. a hedge ----------------------------------------------------------------
    before, s0, r0 = counts(), scored(obs), reported(obs)
    primary = router._session(1, 0)
    gate = threading.Event()
    router._sessions[1][0] = _Replica(primary, gate=gate)
    router.hedge_policy = HedgePolicy(fallback_ms=1.0, min_ms=0.0)
    try:
        t0 = time.perf_counter()
        r = sess.search_typed(q)
        hedge_ms = (time.perf_counter() - t0) * 1e3
        st = sess.last_stats
        health = router.health()
    finally:
        gate.set()
    router._hedge_executor().shutdown(wait=True)
    router.hedge_policy = None
    router._sessions[1][0] = primary
    if not same(r, resident[-1]) or st.hedges < 1 or st.hedge_wins < 1 \
            or health[1] != [True, True] or st.partial:
        fail(f"cluster hedge: {st}, health {health}")
    line = check("hedge", "gpu", before, obs, s0, r0, exact=False)
    say(f"cluster hedge: shard 1's primary held until the call returned; "
        f"the L=8 request in {hedge_ms:.1f} ms, equal to the resident "
        f"result; hedges {st.hedges}, won {st.hedge_wins}, nothing marked "
        f"down; {line} (the winners'; the rest are hedge losers')")

    # -- 8. the partial gather -------------------------------------------------
    # the budget: 50 ms, or 4x the slowest warm request if that is longer,
    # so that the three shards that are not held answer inside it
    deadline = max(50.0, 4 * max(warm_ms))
    before, s0, r0 = counts(), scored(obs), reported(obs)
    gate = threading.Event()
    held = _Replica(primary, gate=gate)
    router._sessions[1][0] = held
    try:
        t0 = time.perf_counter()
        resp = sess.search(q, options=QueryOptions(deadline_ms=deadline,
                                                   allow_partial=True))
        part_ms = (time.perf_counter() - t0) * 1e3
        st = sess.last_stats
    finally:
        gate.set()
    if not held.done.wait(timeout=300):
        fail("cluster partial: the released straggler did not finish")
    router._sessions[1][0] = primary
    want = None
    for s in (0, 2, 3):
        part = router._session(s, 0).search_typed(q)
        want = part if want is None else _merge_results(want, part,
                                                        cfg.top_k)
    if not (resp.stats.partial and resp.stats.shards_missing == (1,)
            and st.shards_missing == (1,) and same(resp.results, want)):
        fail(f"cluster partial: {resp.stats}, {st}")
    line = check("partial", "gpu", before, obs, s0, r0, exact=False)
    say(f"cluster partial: shard 1 held; deadline {deadline:.1f} ms with "
        f"allow_partial: answered in {part_ms:.1f} ms, partial, "
        f"shards_missing {resp.stats.shards_missing}, equal to the merge of "
        f"shards 0, 2 and 3; {line} (the straggler's and the three "
        f"reference searches' too)")

    # -- 9. live writes ------------------------------------------------------------
    before, s0, r0 = counts(), scored(obs), reported(obs)
    sess.enable_ingest(seal_docs=CLUSTER_SEAL_DOCS)
    t0 = time.perf_counter()
    owners = [sess.append(d, p) for d, p in new_docs]
    append_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sealed = sess.flush_ingest()
    flush_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for lo in range(0, CLUSTER_APPENDS, 8):
        qs = [corpus_lib.make_query(new, r, cfg.max_query_nnz)
              for r in range(lo, lo + 8)]
        r = sess.search_typed(Query(np.stack([x[0] for x in qs]),
                                    np.stack([x[1] for x in qs])))
        if not np.array_equal(r.doc_ids[:, 0], new.doc_ids[lo:lo + 8]):
            fail(f"cluster live: appended documents {lo}..{lo + 7} did not "
                 f"rank themselves first: {r.doc_ids[:, 0]}")
    query_s = time.perf_counter() - t0
    st = sess.last_stats
    line = check("live", "gpu", before, obs, s0, r0, exact=True)
    say(f"cluster live: {CLUSTER_APPENDS} appends to both replicas of "
        f"their owner shards ({np.bincount(owners, minlength=4).tolist()} "
        f"a shard) in {append_s:.2f} s -> {CLUSTER_APPENDS / append_s:.0f} "
        f"appends/s; the flush sealed {sealed} documents (both replicas) "
        f"in {flush_ms:.1f} ms; {CLUSTER_APPENDS // 8} L=8 self-queries in "
        f"{query_s:.2f} s ({st.segments_scored} segments a query), each "
        f"ranking its document first; {line}")
    sess.close()

    # -- 10. the launcher --------------------------------------------------------
    before = counts()
    t0 = time.perf_counter()
    out = search_serve.main([
        "--cluster", str(root), "--hedge-percentile", "0.95",
        "--allow-partial", "--backend", "gpu",
        "--vocab", str(cfg.vocab_size), "--avg-nnz", str(cfg.avg_nnz_per_doc),
        "--nnz-pad", str(cfg.nnz_pad), "--top-k", str(cfg.top_k),
        "--query-nnz", str(cfg.nnz_pad), "--cache-mb", str(LIVE_CACHE_MB),
        "--clients", str(CLUSTER_CLIENTS),
        "--requests", str(CLUSTER_REQUESTS), "--seed", str(SEED)])
    ss_s = time.perf_counter() - t0
    line = check("search_serve", "gpu", before, out["obs"], 0, 0,
                 exact=out["hedges"] == 0)
    say(f"cluster search_serve: {ss_s:.1f} s; {out['qps']:.1f} QPS, p50 "
        f"{out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms, batches "
        f"{out['batches']}, occupancy {out['mean_occupancy']:.2f}; hedges "
        f"fired {out['hedges']}, won {out['hedge_wins']}; partial "
        f"{out['partial']}, failovers {out['failovers']}; {line}; stage_ms "
        f"{stage_summary(out['obs'])}; cluster_shard_ms "
        f"{hist_line(out['obs'], 'cluster_shard_ms')}")
    if out["queries"] != n_serve or out["target"] != "cluster":
        fail(f"cluster search_serve: {out}")

    # -- 11. launches ---------------------------------------------------------------
    launches = counts()
    say(f"cluster launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched in the cluster phase")
    say(f"cluster phase: {time.perf_counter() - t_phase:.1f} s wall on "
        f"{nvidia_smi_line()}")
    return launches


def attention_inputs(torch, dev, B, S, H, KV, hd, dtype, seed=SEED):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, S, h, hd), generator=gen, device=dev).to(dtype)
            for h in (H, KV, KV)]


def cross_kv(torch, dev, B, Sk, KV, hd, dtype):
    """Cross-attention's k and v, [B, Sk, KV, hd] each, drawn apart from
    ``attention_inputs``' q."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    return [torch.randn((B, Sk, KV, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2)]


def greedy_with_margins(torch, step, params, cfg, prompt, max_new,
                        extra=None):
    """``generate``'s greedy loop, also returning each step's top-2 logit
    margin [B, max_new] and the last-position prefill logits. ``extra``
    joins the prefill batch (the VLM's ``image_embeds``)."""
    B, S = prompt.shape
    logits, kv = step.make_prefill(cfg)(params,
                                        {"tokens": prompt, **(extra or {})})
    first = logits[:, 0].clone()
    cache = step.decode_cache(cfg, kv, B, S, S + max_new, prompt.device)
    decode = step.make_decode_step(cfg)
    toks, margins = [], []
    for i in range(max_new):
        top2 = logits[:, 0].float().topk(2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        toks.append(step.sample(logits))
        if i < max_new - 1:
            logits, cache = decode(params, {"tokens": toks[-1]}, cache, S + i)
    return torch.cat(toks, 1), torch.stack(margins, 1), first


def lm_check(torch, step, layers, fa, params, cfg, prompt, label,
             extra=None):
    """Phase 10 (10b) in ``cfg.dtype``: the model with kernel B4 against
    the same model with its plain version. Returns the kernel run's B4
    launches, ``{"launches", "windowed", "cross"}`` (the f32 rows',
    ``f32_row``).

    With experts, the plain run replays the kernel run's routing
    (``moe_apply.replay``): a one-ulp attention difference can flip a
    near-tie routing choice, and a flipped expert changes a token's FFN
    wholly, so the two runs are held to one routing and then differ by
    attention alone, under the dense rule (``lm_atol`` on the logits,
    greedy tokens equal up to a plain top-2 margin below it). Where the
    plain run's own router chose another expert set (a flip), its routing
    margin, the router-logit gap between its k-th and (k+1)-th expert,
    must be below the same limit: the router reads the same RMS-normed
    hidden state as the unembedding, at the same scale (both give
    ~N(0, 1) logits at this init), so attention's differences move the
    two alike, while a wrong tile or mask moves them by O(1). Flips are
    counted up to the first step whose greedy tokens differ.

    For the hybrid (whose bf16 logits at
    full depth tell a planted fault from rounding only faintly,
    ZAMBA_ULPS), each B4 call of the kernel run is also held against the
    plain version on the model's own q, k and v (``site_checked``), under
    phase 8's limits. ``extra`` joins each prefill batch (the VLM's
    image embeddings); the plain run then takes cross-attention's plain
    version too."""
    from repro_torch.models import moe
    by = fa.flash_attention_gqa.launches_by_design
    before = dict(by)
    before_w = fa.flash_attention_gqa.launches_windowed
    before_x = fa.flash_attention_gqa.launches_cross
    moe_run = cfg.n_experts > 0
    moe.moe_apply.record = [] if moe_run else None
    kernel_attn = layers.flash_attention_gqa
    sites = [] if cfg.family == "hybrid" else None
    if sites is not None:
        layers.flash_attention_gqa = site_checked(torch, fa, sites)
    try:
        tok_k, _, logit_k = greedy_with_margins(torch, step, params, cfg,
                                                prompt, LM_NEW, extra)
        routing = moe.moe_apply.record
    finally:
        moe.moe_apply.record = None
        layers.flash_attention_gqa = kernel_attn
    if sites is not None:
        sites_held(sites, cfg.dtype, label)
    which = fa.design(getattr(torch, cfg.dtype), cfg.head_dim)
    if by[which] - before[which] != b4_per_generate(cfg):
        fail(f"LM check {label}: the greedy run did not run B4's {which} "
             f"instance {b4_per_generate(cfg)} times")
    counts = {
        "launches": by[which] - before[which],
        "windowed": fa.flash_attention_gqa.launches_windowed - before_w,
        "cross": fa.flash_attention_gqa.launches_cross - before_x}
    layers.flash_attention_gqa = fa.flash_attention_gqa_plain
    if moe_run:
        moe.moe_apply.replay = [r["expert_id"] for r in routing]
        moe.moe_apply.record = []
    try:
        tok_p, margin_p, logit_p = greedy_with_margins(
            torch, step, params, cfg, prompt, LM_NEW, extra)
        replayed = moe.moe_apply.record
    finally:
        layers.flash_attention_gqa = kernel_attn
        moe.moe_apply.replay = moe.moe_apply.record = None
    torch.cuda.synchronize()
    atol = lm_atol(cfg.dtype, logit_p,
                   ZAMBA_ULPS if cfg.family == "hybrid" else LM_ULPS)
    err = float((logit_k.float() - logit_p.float()).abs().max())
    say(f"LM check {label} ({which}): last-position prefill logits max "
        f"|kernel - plain| {err:.3e} (tolerance {atol}; max |logit| "
        f"{float(logit_p.float().abs().max()):.3f})")
    if not (err <= atol and torch.isfinite(logit_k).all()):
        fail(f"{label} prefill logits differ by {err} > {atol}")
    diff = (tok_k != tok_p).nonzero()
    first = int(diff[:, 1].min()) if len(diff) else LM_NEW
    if len(diff):
        rows_t = diff[diff[:, 1] == first][:, 0].tolist()
        margins = [float(margin_p[r, first]) for r in rows_t]
        say(f"LM check {label}: greedy tokens first differ at step {first} "
            f"in rows {rows_t}; plain top-2 margins there {margins}")
        if max(margins) >= atol:
            fail("greedy tokens differ where the margin exceeds tolerance")
    else:
        say(f"LM check {label}: the {tok_k.shape[0]} x {LM_NEW} greedy "
            f"tokens agree; smallest plain top-2 margin "
            f"{float(margin_p.min()):.3e}")
    if moe_run:
        route_flips(torch, cfg, replayed, first, label, atol)
    return counts


def lm_atol(dtype, logits, ulps=LM_ULPS) -> float:
    """LM_ATOL[dtype], or in bf16 ``ulps`` ulps of bf16 at the largest
    |logit| where that is more."""
    if dtype != "bfloat16":
        return LM_ATOL[dtype]
    top = max(float(logits.float().abs().max()), 2.0 ** -126)
    return max(LM_ATOL[dtype], ulps * 2.0 ** (np.floor(np.log2(top)) - 7))


def site_checked(torch, fa, records):
    """B4 as the model calls it, each call also run through the plain
    version on the same inputs; the model gets the kernel's result.
    Appends (max |kernel - plain|, row-scaled error, within ATTN_TOL) a
    call to ``records``."""
    def attn(q, k, v, **kw):
        got = fa.flash_attention_gqa(q, k, v, **kw)
        want = fa.flash_attention_gqa_plain(q, k, v, **kw)
        tol = ATTN_TOL[str(q.dtype).split(".")[1]]
        records.append((float((got.float() - want.float()).abs().max()),
                        row_scaled_err(got, want),
                        bool(torch.allclose(got.float(), want.float(),
                                            rtol=tol, atol=tol))))
        return got
    return attn


def sites_held(records, dtype, label):
    """``site_checked``'s records against phase 8's limits."""
    errs = ", ".join(f"{e:.3e}/{r:.3e}" for e, r, _ in records)
    say(f"LM check {label}: B4 at each of {len(records)} sites against its "
        f"plain version on the model's own q, k, v (max_abs_err/row-scaled):"
        f" {errs} (tolerance {ATTN_TOL[dtype]}"
        + (f", row-scaled {ATTN_ROW_TOL})" if dtype == "bfloat16" else ")"))
    for e, r, ok in records:
        if not ok or (dtype == "bfloat16" and r > ATTN_ROW_TOL):
            fail(f"LM check {label}: B4 at a site differs from plain by "
                 f"{e} (row-scaled {r})")


def route_flips(torch, cfg, records, first_diff, label, limit):
    """Phase 10b's routing rule over the plain run's records (a prefill
    call an MoE layer, then a call an MoE layer for each decode step;
    decode step i feeds greedy token i, so steps from ``first_diff`` on
    are not compared): every flip's routing margin below ``limit``."""
    n = cfg.n_layers - cfg.first_k_dense
    calls = records[:n * (1 + min(first_diff, LM_NEW - 1))]
    flips = {"prefill": [0] * n, "decode": [0] * n}
    margins, checked = [], 0
    for c, r in enumerate(calls):
        own = r["own_id"].sort(dim=-1).values
        forced = r["expert_id"].sort(dim=-1).values
        flip = (own != forced).any(-1)
        checked += flip.numel()
        flips["prefill" if c < n else "decode"][c % n] += int(flip.sum())
        margins.extend(r["margin"][flip].float().tolist())
    say(f"LM check {label}: routing of the plain run against the kernel "
        f"run's over {checked} (token, layer) choices: expert sets differ "
        f"in {len(margins)} (prefill by layer {flips['prefill']}, decode "
        f"{flips['decode']}); their routing margins "
        f"{sorted(margins)[-8:] if margins else []} (largest last; "
        f"limit {limit}); smallest margin of all "
        f"{min(float(r['margin'].min()) for r in calls):.3e}")
    if margins and max(margins) >= limit:
        fail(f"{label}: a routing choice flipped at margin {max(margins)} "
             f">= {limit}")


def b4_cases(torch, dev, fa, B, S, H, KV, hd, window=0):
    """Phase 8 (8b): B4 against its plain version at a prefill shape, in
    bf16 and f32, non-causal, at an S that no tile divides and through
    the [BH, S, hd] entry; with ``window`` (8c), bf16 and f32 causal,
    global and windowed. Returns each case's max error."""
    if window:
        cases = [("prefill bf16 causal", B, S, "bfloat16", True, 0),
                 ("prefill f32 causal", B, S, "float32", True, 0),
                 (f"prefill bf16 causal window {window}", B, S, "bfloat16",
                  True, window),
                 (f"prefill f32 causal window {window}", B, S, "float32",
                  True, window)]
    else:
        cases = [("prefill bf16 causal", B, S, "bfloat16", True, 0),
                 ("prefill f32 causal", B, S, "float32", True, 0),
                 ("prefill bf16 non-causal", B, S, "bfloat16", False, 0),
                 ("bf16 causal S=1000 (no 64-tile divides)", 2, 1000,
                  "bfloat16", True, 0)]
    attn_err = {}
    for name, b, s_len, dtype, causal, w in cases:
        q, k, v = attention_inputs(torch, dev, b, s_len, H, KV, hd,
                                   getattr(torch, dtype))
        attn_err[name] = b4_held(torch, fa, name, q, k, v, causal=causal,
                                 window=w)
        del q, k, v
    bh = attention_inputs(torch, dev, B * H, S, 1, 1, hd, torch.bfloat16)
    got = fa.flash_attention(*(t[:, :, 0] for t in bh), window=window)
    want = fa.flash_attention_plain(*(t[:, :, 0] for t in bh), window=window)
    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    row_err = row_scaled_err(got, want)
    say(f"B4 vs plain, [BH, S, hd] entry [{B * H}, {S}, {hd}] bf16"
        + (f" window {window}" if window else "") + ": "
        f"max_abs_err {float((got.float() - want.float()).abs().max()):.3e}"
        f", row-scaled {row_err:.3e}")
    if row_err > ATTN_ROW_TOL:
        fail(f"B4 [BH, S, hd] entry: row-scaled error {row_err} > "
             f"{ATTN_ROW_TOL}")
    return attn_err


def b4_held(torch, fa, name, q, k, v, **kw) -> float:
    """One B4 call against its plain version on the same inputs: counted
    once under the instance ``design`` names, within ATTN_TOL (atol and
    rtol) and, in bf16, ATTN_ROW_TOL row by row. Returns the max error."""
    by = fa.flash_attention_gqa.launches_by_design
    which = fa.design(q.dtype, q.shape[-1])
    before = by[which]
    got = fa.flash_attention_gqa(q, k, v, **kw)
    want = fa.flash_attention_gqa_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if by[which] != before + 1:
        fail(f"B4 {name}: not counted under its {which} instance")
    err = float((got.float() - want.float()).abs().max())
    row_err = row_scaled_err(got, want)
    dtype = str(q.dtype).split(".")[1]
    tol = ATTN_TOL[dtype]
    B, S, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    say(f"B4 ({which}) vs plain, {name} [{B}, {S}, {H}/{KV}, {hd}]"
        + (f" Sk {Sk}" if Sk != S else "") + f": max_abs_err {err:.3e} "
        f"(tolerance {tol}, rtol {tol}); row-scaled {row_err:.3e}"
        + (f" (tolerance {ATTN_ROW_TOL})" if dtype == "bfloat16" else ""))
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if dtype == "bfloat16" and row_err > ATTN_ROW_TOL:
        fail(f"B4 {name}: row-scaled error {row_err} > {ATTN_ROW_TOL}")
    return err


def b4_cross_cases(torch, dev, fa, B, S, Sk, H, KV, hd):
    """Phase 8e: B4 at keys of their own length (cross-attention,
    non-causal) against its plain version: the VLM's prefill shape in
    bf16 (wgmma) and f32 (simt), one query over the Sk keys (a decode
    step) in both, and NONDIVIDING_SK keys. Returns each case's max
    error."""
    cases = [("cross bf16", B, S, Sk, torch.bfloat16),
             ("cross f32", B, S, Sk, torch.float32),
             ("cross bf16 Sq=1", B, 1, Sk, torch.bfloat16),
             ("cross f32 Sq=1", B, 1, Sk, torch.float32),
             (f"cross bf16 Sk={NONDIVIDING_SK} (no 64-tile divides)", 2, S,
              NONDIVIDING_SK, torch.bfloat16)]
    errs = {}
    for name, b, s_len, sk_len, dtype in cases:
        q = attention_inputs(torch, dev, b, s_len, H, KV, hd, dtype)[0]
        k, v = cross_kv(torch, dev, b, sk_len, KV, hd, dtype)
        errs[name] = b4_held(torch, fa, name, q, k, v, causal=False)
        del q, k, v
    return errs


def b4_per_prefill(cfg) -> int:
    """B4's launches in one prefill: one a layer (transformers; the VLM's
    cross layers too), one a shared-attention site (hybrid), none
    (ssm)."""
    from repro_torch.models import hybrid, transformer
    if cfg.family == "ssm":
        return 0
    return hybrid.n_attn_sites(cfg) if cfg.family == "hybrid" \
        else cfg.n_layers + transformer.n_superblocks(cfg)


def b4_per_generate(cfg, new=LM_NEW) -> int:
    """B4's launches in one ``generate`` of ``new`` tokens: the
    prefill's, and for the VLM one a cross layer in each of the ``new -
    1`` decode steps (decode self-attention is plain PyTorch)."""
    from repro_torch.models import transformer
    return b4_per_prefill(cfg) + (new - 1) * transformer.n_superblocks(cfg)


def serve_counted(torch, fa, cfg, call):
    """Phase 9 (9b-9e): ``call()`` (one serving run) with every launch
    count set to 0 just before it and read just after; B4 must have
    launched ``b4_per_generate`` times, all on its wgmma instance, and
    ``n_superblocks * LM_NEW`` of them at Sk != S (the VLM's
    cross-attention; none elsewhere). Returns (what ``call`` returns, the
    launch counts, B4's cross-attention ones as
    ``flash_attention_cross``)."""
    from repro_torch.models import transformer
    counted = _launch_counters()
    for fn in counted.values():
        fn.launches = 0
    by = fa.flash_attention_gqa.launches_by_design
    for name in by:
        by[name] = 0
    fa.flash_attention_gqa.launches_cross = 0
    out = call()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    launches["flash_attention_cross"] = fa.flash_attention_gqa.launches_cross
    by_design = dict(by)
    say(f"LM main path ({cfg.name}) launches: {launches}; B4 by instance "
        f"{by_design}")
    want = b4_per_generate(cfg)
    if launches["flash_attention"] != want:
        fail(f"B4 launched {launches['flash_attention']} times in one "
             f"serving run, want {want}")
    if by_design["wgmma"] != want:
        fail(f"{by_design['wgmma']} of B4's {want} launches ran the wgmma "
             "instance, want all")
    want_cross = transformer.n_superblocks(cfg) * LM_NEW
    if launches["flash_attention_cross"] != want_cross:
        fail(f"{launches['flash_attention_cross']} of B4's launches in one "
             f"serving run were cross-attention (Sk != S), want "
             f"{want_cross}")
    return out, launches


def serve_checked(torch, step, fa, dev, cfg, run, B, S, **gen_kw):
    """Phase 9 (9b) after the counted run: in-vocab tokens of the right
    shape, the model's size, then three warm calls that must give the
    same greedy tokens; prints and returns the median prefill and decode
    ms. ``gen_kw`` goes to ``generate`` (the VLM's ``image_embeds``)."""
    tokens = run.tokens
    if tuple(tokens.shape) != (B, LM_NEW) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        fail(f"LM tokens: shape {tuple(tokens.shape)}, range "
             f"[{int(tokens.min())}, {int(tokens.max())}]")
    n_params = sum(t.numel() for t in _leaves(run.params))
    say(f"LM model: {cfg.name}, {cfg.n_layers} layers x d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} params "
        f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
        f"{run.stats['init_s']:.1f} s; first call: prefill "
        f"{run.stats['prefill_s'] * 1e3:.1f} ms, decode "
        f"{run.stats['decode_s'] * 1e3:.1f} ms")
    warm = []
    for _ in range(3):
        stats = {}
        fa.flash_attention_gqa.launches = 0
        again = step.generate(run.params, cfg, run.prompt, max_new=LM_NEW,
                              max_len=S + LM_NEW, device=dev, stats=stats,
                              **gen_kw)
        if fa.flash_attention_gqa.launches != b4_per_generate(cfg):
            fail("B4 launch count differs on the warm call")
        if not torch.equal(again, tokens):
            fail("the warm call's greedy tokens differ from the first's")
        warm.append(stats)
    pre = statistics.median(w["prefill_s"] for w in warm) * 1e3
    dec = statistics.median(w["decode_s"] for w in warm) * 1e3
    total_s = (pre + dec) / 1e3
    say(f"LM warm ({cfg.name}, median of 3): prefill + first token "
        f"{pre:.2f} ms ({B * S / (pre / 1e3):.0f} prompt tok/s), decode "
        f"{dec / (LM_NEW - 1):.3f} ms/step of {B} tokens "
        f"({B * (LM_NEW - 1) / (dec / 1e3):.1f} tok/s); "
        f"{B * LM_NEW / total_s:.1f} generated tok/s end to end")
    return pre, dec / (LM_NEW - 1)


def sdpa_backend(torch, q, k, v, **kw) -> str:
    """The backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(q, k, v, dropout_p=0.0,
                                              scale=None, **kw)).name


def b4_times(torch, dev, fa, B, S, H, KV, hd, window=0, Sk=None,
             dtype=None, lse=False, reps=20, plain_reps=3):
    """Phase 11 (11b-11e): B4, its plain version and the library
    yardstick at a prefill shape in ``dtype`` (default bf16; f32 runs
    the simt instance), causal and with ``window``, or with ``Sk`` keys
    non-causal (cross-attention), with ``lse`` writing the rows'
    log-sum-exp, beside the bound at the dtype's peak. Returns the
    row's numbers."""
    dtype = dtype or torch.bfloat16
    q, k, v = attention_inputs(torch, dev, B, S, H, KV, hd, dtype)
    causal = Sk is None
    if not causal:
        k, v = cross_kv(torch, dev, B, Sk, KV, hd, dtype)
    which = fa.design(q.dtype, hd)
    kern = lambda: fa.flash_attention_gqa(q, k, v, causal=causal,  # noqa
                                          window=window, return_lse=lse)
    # device times from CUDA-graph replays: the wrapper's host work is
    # longer than the kernel, so one eager call would time the host
    eager_ms = cuda_ms(torch, kern, reps)
    ms = graph_ms(torch, kern, reps)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_gqa_plain(
        q, k, v, causal=causal, window=window, return_lse=lse), plain_reps)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window:
        # the band as a boolean mask (True: attend): causal and dq - dk <
        # window; no fused SDPA takes a window of its own
        d = (torch.arange(S, device=dev)[:, None]
             - torch.arange(S, device=dev)[None, :])
        kw = {"attn_mask": (d >= 0) & (d < window), "is_causal": False,
              "enable_gqa": True}
    else:
        kw = {"attn_mask": None, "is_causal": causal, "enable_gqa": True}
    backend = sdpa_backend(torch, qt, kt, vt, **kw)
    lib = lambda: sdpa(qt, kt, vt, **kw)  # noqa: E731
    lib_eager_ms = cuda_ms(torch, lib, reps)
    lib_ms = graph_ms(torch, lib, reps)
    got = kern()
    lib_err = float((lib().transpose(1, 2).float()
                     - (got[0] if lse else got).float()).abs().max())
    # operations: q·kᵀ and p·v, 2·hd each a kept (query, key) pair a head
    # (fa.attention_flops): causal S(S+1)/2 pairs, a window only its
    # band's, cross-attention all S·Sk; bytes: q, k, v and o (and the lse)
    flops = fa.attention_flops(B, S, Sk or S, H, hd, causal=causal,
                               window=window)
    n_bytes = nbytes(q, k, v) + nbytes(q) + (B * H * S * 4 if lse else 0)
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else F32_OPS_PER_S)
    shape = f"[{B}, {S}, {H}/{KV}, {hd}]" + ("" if causal else f" Sk {Sk}")
    mask = (f"causal{f' window {window}' if window else ''}" if causal
            else "non-causal") + (" with the lse" if lse else "")
    say(f"time flash_attention ({which}) {shape} "
        f"{str(dtype).split('.')[-1]} {mask}: {ms:.4f} ms a "
        f"launch in a CUDA graph, {eager_ms:.4f} ms an eager call (plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}: "
        f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB; library "
        f"scaled_dot_product_attention ({backend}"
        f"{', boolean band mask' if window else ''}"
        + (f", allow_tf32 {torch.backends.cuda.matmul.allow_tf32}"
           if dtype == torch.float32 else "") + ") "
        f"{lib_ms:.4f} ms in a "
        f"graph, {lib_eager_ms:.4f} ms eager, max |diff| "
        f"{lib_err:.3e}); kernel / library {ms / lib_ms:.2f}x, kernel / "
        f"bound {ms / b_ms:.1f}x")
    return {"design": which, "head_dim": hd, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def b4_row(name, launches, max_abs_err, times):
    return {"name": name, "route": "cuda", "design": times["design"],
            "head_dim": times["head_dim"],
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:29",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
            "library_ms": times["library_ms"]}


# the simt instance's f32 rows of the kernels line, one a timed shape,
# added by phases 11-11e (main joins them to the line)
F32_ROWS = []


def f32_row(torch, dev, fa, name, launches, err, *shape, **kw):
    """The simt instance at an f32 shape (11-11e): ``b4_times`` in f32,
    5 replays and one plain call (each phase's f32 shapes take ~1-3 s),
    SDPA in f32 beside it; ``launches`` are the phase's f32 whole-model
    check's (``lm_check``'s), ``err`` its phase 8 case's."""
    times = b4_times(torch, dev, fa, *shape, dtype=torch.float32, reps=5,
                     plain_reps=1, **kw)
    F32_ROWS.append(b4_row(name, launches, err, times))


def lm_phases(torch, dev):
    """Phases 8-11: kernel B4 and the LM serving path. Returns B4's row
    of the kernels line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import layers, model as M
    from repro_torch.serve import step

    cfg = get_config(LM_ARCH)
    B, S, H, KV, hd = (LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)

    # -- 8. B4 against its plain version -----------------------------------
    attn_err = b4_cases(torch, dev, fa, B, S, H, KV, hd)

    # -- 9. LM main path ---------------------------------------------------
    argv = ["--arch", LM_ARCH, "--batch", str(B), "--prompt-len", str(S),
            "--max-new", str(LM_NEW), "--seed", str(SEED)]
    run, launches = serve_counted(torch, fa, cfg,
                                  lambda: serve_launcher.main(argv))
    serve_checked(torch, step, fa, dev, cfg, run, B, S)

    # -- 10. whole model: kernel against plain attention, bf16 then f32 ------
    lm_check(torch, step, layers, fa, run.params, cfg,
             torch.as_tensor(run.prompt, device=dev), "bf16")
    del run
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = M.init(cfg32, seed=SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=dev)
    f32_launches = lm_check(torch, step, layers, fa, params32, cfg32,
                            prompt, "f32")["launches"]
    del params32
    torch.cuda.empty_cache()

    # -- 11. B4 times --------------------------------------------------------
    times = b4_times(torch, dev, fa, B, S, H, KV, hd)
    f32_row(torch, dev, fa, "flash_attention_f32_hd64", f32_launches,
            attn_err["prefill f32 causal"], B, S, H, KV, hd)
    return b4_row("flash_attention", launches["flash_attention"],
                  attn_err["prefill bf16 causal"], times)


def moe_served(torch, dev, fa, cfg, B, S):
    """Phase 9b (9c): an MoE model cut in depth served through ``M.init``
    and ``step.generate`` (what ``serve.main`` calls), counted as
    ``serve_counted`` counts; prints the tokens each MoE layer dropped by
    capacity in prefill and decode. Returns (the run, the counts)."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import model as M, moe
    from repro_torch.serve import step

    def serve():
        stats = {}
        t0 = time.perf_counter()
        params = M.init(cfg, seed=SEED, device=dev)
        stats["init_s"] = time.perf_counter() - t0
        prompt = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        moe.moe_apply.record = []
        try:
            tokens = step.generate(params, cfg, prompt, max_new=LM_NEW,
                                   max_len=S + LM_NEW, device=dev,
                                   stats=stats)
            records = moe.moe_apply.record
        finally:
            moe.moe_apply.record = None
        return serve_launcher.ServeRun(tokens, prompt, params, stats), \
            records

    (run, records), launches = serve_counted(torch, fa, cfg, serve)
    n = cfg.n_layers - cfg.first_k_dense
    pre_drop = [r["dropped"] for r in records[:n]]
    dec_drop = [sum(r["dropped"] for r in records[n + i::n])
                for i in range(n)]
    _, cap_pre = moe.capacities(B * S, cfg)
    _, cap_dec = moe.capacities(B, cfg)
    say(f"MoE drops by capacity, by MoE layer: prefill {pre_drop} of "
        f"{B * S * cfg.top_k} assignments a layer (cap_exp {cap_pre}); "
        f"decode {dec_drop} of {(LM_NEW - 1) * B * cfg.top_k} over "
        f"{LM_NEW - 1} steps (cap_exp {cap_dec}: "
        f"{sum(dec_drop) / (n * (LM_NEW - 1)):.2f} a layer a step)")
    return run, launches


def lm128_phases(torch, dev):
    """Phases 8b-11b: B4 at head dim 128 and the three archs it serves.
    Returns B4's hd-128 row of the kernels line, its launches the sum
    of the three serving runs' (``main`` adds kimi-k2's, phase 9c)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import layers, model as M
    from repro_torch.serve import step

    lead = get_config(LM128_ARCHS[0])
    B, S, H, KV, hd = (LM_BATCH, LM_PROMPT, lead.n_heads, lead.n_kv_heads,
                       lead.head_dim)

    # -- 8b. B4 at hd 128 against its plain version --------------------------
    t_phase = time.perf_counter()
    attn_err = b4_cases(torch, dev, fa, B, S, H, KV, hd)
    say(f"phase 8b (B4 at hd {hd}): {time.perf_counter() - t_phase:.1f} s")

    # -- 9b/10b. serving at full width, then kernel against plain ------------
    served = 0
    for arch in LM128_ARCHS:
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(S),
                "--max-new", str(LM_NEW), "--seed", str(SEED)]
        run, launches = serve_counted(torch, fa, cfg,
                                      lambda: serve_launcher.main(argv))
        served += launches["flash_attention"]
        serve_checked(torch, step, fa, dev, cfg, run, B, S)
        lm_check(torch, step, layers, fa, run.params, cfg,
                 torch.as_tensor(run.prompt, device=dev), f"{arch} bf16")
        del run
        torch.cuda.empty_cache()
        say(f"phase 9b/10b ({arch}): {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    say(f"LM cut: {MOE_ARCH} at {MOE_LAYERS} of its {full.n_layers} layers "
        f"(~470 GB of bf16 weights at full depth, ~42 GB at "
        f"{MOE_LAYERS}); width, experts, top-k and capacity as published")
    run, launches = moe_served(torch, dev, fa, cfg, B, S)
    served += launches["flash_attention"]
    serve_checked(torch, step, fa, dev, cfg, run, B, S)
    lm_check(torch, step, layers, fa, run.params, cfg,
             torch.as_tensor(run.prompt, device=dev), f"{MOE_ARCH} bf16")
    del run
    torch.cuda.empty_cache()
    say(f"phase 9b/10b ({MOE_ARCH}): {time.perf_counter() - t_phase:.1f} s")

    # -- 10b. f32 at a depth the card holds ---------------------------------
    t_phase = time.perf_counter()
    f32_launches = 0
    for arch, depth in LM128_F32_LAYERS.items():
        cfg32 = dataclasses.replace(get_config(arch), dtype="float32",
                                    n_layers=depth)
        params32 = M.init(cfg32, seed=SEED, device=dev)
        prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg32.vocab_size, (B, S)).astype(np.int32), device=dev)
        f32_launches += lm_check(torch, step, layers, fa, params32, cfg32,
                                 prompt, f"{arch} f32 at {depth} layers"
                                 )["launches"]
        del params32
        torch.cuda.empty_cache()
    say(f"phase 10b (f32): {time.perf_counter() - t_phase:.1f} s")

    # -- 11b. B4 times at hd 128 ----------------------------------------------
    t_phase = time.perf_counter()
    times = b4_times(torch, dev, fa, B, S, H, KV, hd)
    # f32 with the lse: the training forward's (phase 13)
    f32_row(torch, dev, fa, "flash_attention_f32_hd128", f32_launches,
            attn_err["prefill f32 causal"], B, S, H, KV, hd, lse=True)
    say(f"phase 11b: {time.perf_counter() - t_phase:.1f} s")
    return b4_row("flash_attention_hd128", served,
                  attn_err["prefill bf16 causal"], times)


def lm256_phases(torch, dev):
    """Phases 8c-11c: B4 at head dim 256 with gemma3's sliding window,
    gemma3-4b at full width and depth, and kimi-k2 at full width cut to
    its dense lead and one MoE layer. Returns the two hd-256 rows of the
    kernels line and kimi-k2's B4 launches (hd 128, which join that
    row's)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import layers, model as M, transformer
    from repro_torch.serve import step

    cfg = get_config(GEMMA_ARCH)
    B, S, H, KV, hd = (LM_BATCH, GEMMA_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    window = cfg.sliding_window
    windows = transformer.window_schedule(cfg, cfg.n_layers)
    say(f"{GEMMA_ARCH}: {windows.count(window)} local layers (window "
        f"{window}) and {windows.count(0)} global, prompts of {S} tokens")

    # -- 8c. B4 at hd 256, global and windowed, against its plain version ---
    t_phase = time.perf_counter()
    attn_err = b4_cases(torch, dev, fa, B, S, H, KV, hd, window=window)
    say(f"phase 8c (B4 at hd {hd}): {time.perf_counter() - t_phase:.1f} s")

    # -- 9c/10c. gemma3-4b through serve.main, then kernel against plain ----
    t_phase = time.perf_counter()
    argv = ["--arch", GEMMA_ARCH, "--batch", str(B), "--prompt-len", str(S),
            "--max-new", str(LM_NEW), "--seed", str(SEED)]
    fa.flash_attention_gqa.launches_windowed = 0
    run, launches = serve_counted(torch, fa, cfg,
                                  lambda: serve_launcher.main(argv))
    n_windowed = fa.flash_attention_gqa.launches_windowed
    say(f"LM main path ({GEMMA_ARCH}): {n_windowed} of B4's "
        f"{launches['flash_attention']} launches windowed")
    if n_windowed != windows.count(window):
        fail(f"{GEMMA_ARCH}: {n_windowed} windowed B4 launches in one "
             f"prefill, want {windows.count(window)} (one a local layer)")
    serve_checked(torch, step, fa, dev, cfg, run, B, S)
    lm_check(torch, step, layers, fa, run.params, cfg,
             torch.as_tensor(run.prompt, device=dev), f"{GEMMA_ARCH} bf16")
    del run
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=GEMMA_F32_LAYERS)
    params32 = M.init(cfg32, seed=SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg32.vocab_size, (B, S)).astype(np.int32), device=dev)
    f32_counts = lm_check(
        torch, step, layers, fa, params32, cfg32, prompt,
        f"{GEMMA_ARCH} f32 at {GEMMA_F32_LAYERS} layers (windows "
        f"{transformer.window_schedule(cfg32, GEMMA_F32_LAYERS)})")
    del params32, prompt
    torch.cuda.empty_cache()
    say(f"phase 9c/10c ({GEMMA_ARCH}): {time.perf_counter() - t_phase:.1f} s")

    # -- 9c/10c. kimi-k2 at its dense lead and one MoE layer -----------------
    t_phase = time.perf_counter()
    full = get_config(KIMI_ARCH)
    kcfg = dataclasses.replace(full, n_layers=KIMI_LAYERS)
    kS = LM_PROMPT
    say(f"LM cut: {KIMI_ARCH} at {KIMI_LAYERS} of its {full.n_layers} layers"
        f" ({full.first_k_dense} dense, d_ff {full.d_ff_dense}, then "
        f"{KIMI_LAYERS - full.first_k_dense} MoE of {full.n_experts} experts"
        f" top-{full.top_k} and {full.n_shared_experts} shared; ~2 TB of "
        f"bf16 weights at full depth, ~40 GB at {KIMI_LAYERS}); width, "
        "experts, top-k and capacity as published")
    run, k_launches = moe_served(torch, dev, fa, kcfg, B, kS)
    serve_checked(torch, step, fa, dev, kcfg, run, B, kS)
    lm_check(torch, step, layers, fa, run.params, kcfg,
             torch.as_tensor(run.prompt, device=dev), f"{KIMI_ARCH} bf16")
    del run
    torch.cuda.empty_cache()
    say(f"LM check {KIMI_ARCH}: no f32 run (its MoE layer alone is ~68 GB "
        "in f32, beside the card's 80 GB); the f32 path of a dense lead "
        "and an MoE layer is held on the CPU (tests/test_torch_lm.py)")
    say(f"phase 9c/10c ({KIMI_ARCH}): {time.perf_counter() - t_phase:.1f} s")

    # -- 11c. B4 times at hd 256, global and windowed ------------------------
    t_phase = time.perf_counter()
    rows = []
    for name, w, n in (("flash_attention_hd256", 0,
                        launches["flash_attention"] - n_windowed),
                       ("flash_attention_hd256_window", window, n_windowed)):
        times = b4_times(torch, dev, fa, B, S, H, KV, hd, window=w)
        err = attn_err["prefill bf16 causal" + (f" window {w}" if w else "")]
        rows.append(b4_row(name, n, err, times))
        f32_n = f32_counts["windowed"] if w else (
            f32_counts["launches"] - f32_counts["windowed"])
        f32_row(torch, dev, fa, name.replace("attention_", "attention_f32_"),
                f32_n, attn_err["prefill f32 causal" + (f" window {w}" if w
                                                        else "")],
                B, S, H, KV, hd, window=w)
    say(f"phase 11c: {time.perf_counter() - t_phase:.1f} s")
    return rows, k_launches["flash_attention"]


def idle_share(torch, fn):
    """``fn`` once under torch.profiler: (wall ms, device busy ms, the
    card's idle share of the wall). One stream, so the device events'
    self times sum to the time the card was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type != DeviceType.CPU) / 1e3
    if busy <= 0:
        fail("the profiler recorded no device time")
    return wall, busy, 1.0 - busy / wall


def served_idle(torch, step, dev, cfg, params, prompt):
    """Phase 9d: one prefill, then IDLE_DECODE_STEPS decode steps, each
    under torch.profiler; prints wall and busy ms and the idle share."""
    prefill, decode = step.make_prefill(cfg), step.make_decode_step(cfg)
    B, S = prompt.shape
    out = {}
    pre = idle_share(torch, lambda: out.update(
        kv=prefill(params, {"tokens": prompt})))
    logits, kv = out.pop("kv")
    cache = step.decode_cache(cfg, kv, B, S, S + LM_NEW, dev)
    del kv

    def decode_steps():
        tok = step.sample(logits)
        for i in range(IDLE_DECODE_STEPS):
            lg, _ = decode(params, {"tokens": tok}, cache, S + i)
            tok = step.sample(lg)
    dec = idle_share(torch, decode_steps)
    n = IDLE_DECODE_STEPS
    say(f"LM profiled ({cfg.name}): prefill wall {pre[0]:.3f} ms, device "
        f"busy {pre[1]:.3f} ms, idle share {pre[2]:.3f}; decode wall "
        f"{dec[0] / n:.3f} ms/step, busy {dec[1] / n:.3f} ms/step, idle "
        f"share {dec[2]:.3f} (profiler on)")


def recurrent_rule(torch, step, params, cfg, tokens, label, ulps=0):
    """Phase 10d: ``tests/test_recurrent_consistency.py``'s rule on the
    card. tokens [B, S+1]: the last logits of a prefill over all S+1
    must equal those of a prefill over S followed by one decode step,
    within RULE_TOL, or with ``ulps`` within ``lm_atol`` (bf16 at full
    depth, where that test's limits for 2 layers do not hold: roundings
    compound over the layers). The port splits a prompt into chunks that
    divide it and never pads, so an S+1 past 64 that 64 does not divide
    is prefilled in chunks of RULE_CHUNK."""
    from repro_torch.models import hybrid, model as M, rwkv6
    B, S1 = tokens.shape
    S = S1 - 1
    mod = rwkv6 if cfg.family == "ssm" else hybrid
    chunk = 64 if S1 <= 64 or S1 % 64 == 0 else RULE_CHUNK
    full, _, _ = mod.forward(params, cfg, {"tokens": tokens}, chunk=chunk,
                             last_only=True)
    _, _, kv = M.apply_prefill(params, cfg, {"tokens": tokens[:, :S]},
                               last_only=True)
    cache = step.decode_cache(cfg, kv, B, S, S1, tokens.device)
    got, _, _ = M.apply_decode(params, cfg, {"tokens": tokens[:, S:]}, cache,
                               S)
    got, want = got[:, 0].float(), full[:, -1].float()
    rtol, atol = (0.0, lm_atol(cfg.dtype, want, ulps)) if ulps \
        else RULE_TOL[cfg.dtype]
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    say(f"recurrent rule {label}: prefill over {S1} (chunks of "
        f"{min(chunk, S1)}) against prefill over {S} (chunks of "
        f"{min(64, S)}) + one decode step: last logits max |diff| "
        f"{err:.3e}, {excess:.3f} of the limit (rtol {rtol}, atol {atol}; "
        f"max |logit| {float(want.abs().max()):.3f})")
    if not (excess <= 1.0 and torch.isfinite(got).all()):
        fail(f"recurrent rule {label}: decode parts from prefill by {err}")


def recurrent_phases(torch, dev):
    """Phases 8d-11d: B4 at zamba2's shape (G = 1), rwkv6-7b and
    zamba2-1.2b at full width and depth through ``serve.main`` with their
    checks, and B4's times there. Returns B4's row at zamba2's shape."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import hybrid, layers, model as M, rwkv6
    from repro_torch.serve import step

    zcfg = get_config(ZAMBA_ARCH)
    B, S, H, KV, hd = (LM_BATCH, LM_PROMPT, zcfg.n_heads, zcfg.n_kv_heads,
                       zcfg.head_dim)
    say(f"{ZAMBA_ARCH}: {zcfg.n_layers} Mamba-2 layers, segments "
        f"{hybrid.segments(zcfg)}, {hybrid.n_attn_sites(zcfg)} shared-"
        f"attention sites ({H} heads over {KV}, hd {hd})")

    # -- 8d. B4 at G = 1 against its plain version ---------------------------
    t_phase = time.perf_counter()
    attn_err = b4_cases(torch, dev, fa, B, S, H, KV, hd)
    say(f"phase 8d (B4 at G = {H // KV}, hd {hd}): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- 9d/10d. serving at full width and depth, then the checks -----------
    served = 0
    for arch in (RWKV_ARCH, ZAMBA_ARCH):
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(S),
                "--max-new", str(LM_NEW), "--seed", str(SEED)]
        run, launches = serve_counted(torch, fa, cfg,
                                      lambda: serve_launcher.main(argv))
        served += launches["flash_attention"]
        serve_checked(torch, step, fa, dev, cfg, run, B, S)
        prompt = torch.as_tensor(run.prompt, device=dev)
        served_idle(torch, step, dev, cfg, run.params, prompt)
        if cfg.family == "hybrid":
            lm_check(torch, step, layers, fa, run.params, cfg, prompt,
                     f"{arch} bf16")
        recurrent_rule(torch, step, run.params, cfg,
                       prompt[:, :RULE_BF16_PROMPT + 1], f"{arch} bf16",
                       ulps=LM_ULPS)
        del run, prompt
        torch.cuda.empty_cache()
        say(f"phase 9d/10d ({arch}): {time.perf_counter() - t_phase:.1f} s")

    # -- 10d. f32: zamba2 against plain attention; the recurrent rule in f32
    # at full depth (S 63) and at 4 layers (S 1024), in bf16 at 4 layers
    # (S 63); rwkv6's chunk-size invariance ------------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cfg32 = dataclasses.replace(zcfg, dtype="float32",
                                n_layers=ZAMBA_F32_LAYERS)
    params32 = M.init(cfg32, seed=SEED, device=dev)
    prompt = torch.as_tensor(rng.integers(0, zcfg.vocab_size, (B, S))
                             .astype(np.int32), device=dev)
    lm_check(torch, step, layers, fa, params32, cfg32, prompt,
             f"{ZAMBA_ARCH} f32 at {ZAMBA_F32_LAYERS} layers")
    del params32
    torch.cuda.empty_cache()
    for arch in (RWKV_ARCH, ZAMBA_ARCH):
        for dtype, depth in (("float32", 0), ("bfloat16", RULE_F32_LAYERS)):
            cfg_r = dataclasses.replace(get_config(arch), dtype=dtype)
            cfg_r = dataclasses.replace(cfg_r,
                                        n_layers=depth or cfg_r.n_layers)
            params_r = M.init(cfg_r, seed=SEED, device=dev)
            tokens = torch.as_tensor(rng.integers(
                0, cfg_r.vocab_size, (B, RULE_BF16_PROMPT + 1)).astype(
                    np.int32), device=dev)
            recurrent_rule(torch, step, params_r, cfg_r, tokens,
                           f"{arch} {dtype} at {cfg_r.n_layers} layers")
            del params_r, tokens
            torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(get_config(arch), dtype="float32",
                                    n_layers=RULE_F32_LAYERS)
        params32 = M.init(cfg32, seed=SEED, device=dev)
        tokens = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (B, S + 1))
                                 .astype(np.int32), device=dev)
        recurrent_rule(torch, step, params32, cfg32, tokens,
                       f"{arch} f32 at {RULE_F32_LAYERS} layers")
        if cfg32.family == "ssm":
            outs = [rwkv6.forward(params32, cfg32, {"tokens": tokens[:, :S]},
                                  chunk=c) for c in CHUNKS]
            err = float((outs[0][0] - outs[1][0]).abs().max())
            s_err = float((outs[0][2]["wkv"] - outs[1][2]["wkv"]).abs().max())
            say(f"chunk size ({arch} f32 at {RULE_F32_LAYERS} layers, S "
                f"{S}): logits with chunks of {CHUNKS[0]} against "
                f"{CHUNKS[1]} max |diff| {err:.3e}, final WKV state "
                f"{s_err:.3e} (tolerance {LM_ATOL['float32']})")
            if not err <= LM_ATOL["float32"]:
                fail(f"{arch}: the logits depend on the chunk size ({err})")
            del outs
        del params32, tokens
        torch.cuda.empty_cache()
    say(f"phase 10d (f32 and the rule): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- 11d. B4 times at zamba2's shape --------------------------------------
    t_phase = time.perf_counter()
    times = b4_times(torch, dev, fa, B, S, H, KV, hd)
    say(f"phase 11d: {time.perf_counter() - t_phase:.1f} s")
    return b4_row("flash_attention_g1", served,
                  attn_err["prefill bf16 causal"], times)


def embeds_served(torch, step, fa, dev, cfg, params, B, S, layers):
    """Phase 9e: the audio stub's own path, seeded frame embeddings
    (normal x 0.02, as tests/test_arch_smoke.py draws them): a prefill on
    ``embeds`` [B, S, d] and EMBEDS_DECODE_STEPS decode steps on [B, 1, d]
    through ``make_prefill`` and ``make_decode_step``, counted (B4 once a
    layer in the prefill, never in decode), finite logits of the right
    shape, and the prefill's logits against the same prefill with plain
    attention within ``lm_atol``. Prints the prefill and decode ms."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    frames = (torch.randn((B, S + EMBEDS_DECODE_STEPS, cfg.d_model),
                          generator=gen, device=dev) * 0.02).to(
        getattr(torch, cfg.dtype))
    prefill, decode = step.make_prefill(cfg), step.make_decode_step(cfg)
    fa.flash_attention_gqa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv = prefill(params, {"embeds": frames[:, :S]})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    n_pre = fa.flash_attention_gqa.launches
    cache = step.decode_cache(cfg, kv, B, S, S + EMBEDS_DECODE_STEPS, dev)
    del kv
    t0 = time.perf_counter()
    for i in range(EMBEDS_DECODE_STEPS):
        lg, cache = decode(params, {"embeds": frames[:, S + i:S + i + 1]},
                           cache, S + i)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / EMBEDS_DECODE_STEPS
    n_dec = fa.flash_attention_gqa.launches - n_pre
    kernel_attn = layers.flash_attention_gqa
    layers.flash_attention_gqa = fa.flash_attention_gqa_plain
    try:
        plain, _ = prefill(params, {"embeds": frames[:, :S]})
    finally:
        layers.flash_attention_gqa = kernel_attn
    atol = lm_atol(cfg.dtype, plain,
                   ZAMBA_ULPS if cfg.family == "hybrid" else LM_ULPS)
    err = float((logits.float() - plain.float()).abs().max())
    say(f"LM embeds ({cfg.name}): prefill on frame embeddings [{B}, {S}, "
        f"{cfg.d_model}] {pre_ms:.2f} ms with {n_pre} B4 launches, then "
        f"{EMBEDS_DECODE_STEPS} decode steps on [{B}, 1, {cfg.d_model}] "
        f"{dec_ms:.3f} ms/step with {n_dec}; last-position logits "
        f"{tuple(lg.shape)}, prefill's max |kernel - plain attention| "
        f"{err:.3e} (tolerance {atol})")
    if n_pre != b4_per_prefill(cfg) or n_dec:
        fail(f"{cfg.name} embeds: B4 launched {n_pre} times in the prefill "
             f"and {n_dec} in decode, want {b4_per_prefill(cfg)} and 0")
    if tuple(lg.shape) != (B, 1, cfg.vocab_size) or not (
            torch.isfinite(lg).all() and torch.isfinite(logits).all()):
        fail(f"{cfg.name} embeds: logits {tuple(lg.shape)} or not finite")
    if not err <= atol:
        fail(f"{cfg.name} embeds: prefill logits differ from plain "
             f"attention's by {err} > {atol}")


def multimodal_phases(torch, dev):
    """Phases 8e-11e: B4 at musicgen's shape (G = 1, hd 64) and at the
    VLM's cross shape (Sk != S); musicgen-medium at full width and depth
    on tokens and on frame embeddings; llama-3.2-vision-90b at full width
    cut to VLM_SUPERBLOCKS superblocks with image embeddings; B4's times
    at both shapes. Returns (B4's two rows, the VLM's self-attention B4
    launches, which join the hd-128 row's)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import layers, model as M, transformer
    from repro_torch.serve import step

    mcfg = get_config(MUSICGEN_ARCH)
    vfull = get_config(VLM_ARCH)
    per = vfull.cross_attn_every
    vcfg = dataclasses.replace(vfull, n_layers=VLM_SUPERBLOCKS * per)
    B, S, n_img = LM_BATCH, LM_PROMPT, vfull.n_image_tokens

    # -- 8e. B4 at musicgen's shape and at the cross shape ---------------------
    t_phase = time.perf_counter()
    m_err = b4_cases(torch, dev, fa, B, S, mcfg.n_heads, mcfg.n_kv_heads,
                     mcfg.head_dim)
    x_err = b4_cross_cases(torch, dev, fa, B, S, n_img, vfull.n_heads,
                           vfull.n_kv_heads, vfull.head_dim)
    say(f"phase 8e (B4 at G = 1 and at Sk {n_img}): "
        f"{time.perf_counter() - t_phase:.1f} s")

    def served(cfg, **gen_kw):
        """``M.init`` and ``step.generate``, what ``serve.main`` calls for
        the archs it serves (it refuses these two)."""
        def serve():
            stats = {}
            t0 = time.perf_counter()
            params = M.init(cfg, seed=SEED, device=dev)
            stats["init_s"] = time.perf_counter() - t0
            prompt = np.random.default_rng(SEED).integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)
            tokens = step.generate(params, cfg, prompt, max_new=LM_NEW,
                                   max_len=S + LM_NEW, device=dev,
                                   stats=stats, **gen_kw)
            return serve_launcher.ServeRun(tokens, prompt, params, stats)
        return serve_counted(torch, fa, cfg, serve)

    # -- 9e/10e. musicgen-medium: tokens, frame embeddings, kernel vs plain --
    t_phase = time.perf_counter()
    run, m_launches = served(mcfg)
    serve_checked(torch, step, fa, dev, mcfg, run, B, S)
    lm_check(torch, step, layers, fa, run.params, mcfg,
             torch.as_tensor(run.prompt, device=dev), f"{MUSICGEN_ARCH} bf16")
    embeds_served(torch, step, fa, dev, mcfg, run.params, B, S, layers)
    del run
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(mcfg, dtype="float32",
                                n_layers=MUSICGEN_F32_LAYERS)
    params32 = M.init(cfg32, seed=SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg32.vocab_size, (B, S)).astype(np.int32), device=dev)
    lm_check(torch, step, layers, fa, params32, cfg32, prompt,
             f"{MUSICGEN_ARCH} f32 at {MUSICGEN_F32_LAYERS} layers")
    del params32, prompt
    torch.cuda.empty_cache()
    say(f"phase 9e/10e ({MUSICGEN_ARCH}): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- 9e/10e. llama-3.2-vision-90b at VLM_SUPERBLOCKS superblocks ---------
    t_phase = time.perf_counter()
    n_sb = transformer.n_superblocks(vcfg)
    say(f"LM cut: {VLM_ARCH} at {n_sb} of its "
        f"{transformer.n_superblocks(vfull)} superblocks ({vcfg.n_layers} "
        f"self-attention and {n_sb} cross-attention layers of "
        f"{vfull.n_layers} and {transformer.n_superblocks(vfull)}; ~175 GB "
        f"of bf16 weights at full depth, ~38 GB at {n_sb}); width, heads, "
        f"d_ff, vocab and the {n_img} image tokens as published")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    img = (torch.randn((B, n_img, vfull.d_model), generator=gen, device=dev)
           * 0.02).to(torch.bfloat16)
    run, v_launches = served(vcfg, image_embeds=img)
    n_cross = v_launches["flash_attention_cross"]
    n_self = v_launches["flash_attention"] - n_cross
    say(f"LM main path ({VLM_ARCH}): B4 {n_self} self-attention and "
        f"{n_cross} cross-attention launches (Sk {n_img}) in one "
        f"generate: {n_sb} cross in the prefill and {n_sb} in each of the "
        f"{LM_NEW - 1} decode steps (Sq 1)")
    serve_checked(torch, step, fa, dev, vcfg, run, B, S, image_embeds=img)
    lm_check(torch, step, layers, fa, run.params, vcfg,
             torch.as_tensor(run.prompt, device=dev), f"{VLM_ARCH} bf16",
             extra={"image_embeds": img})
    prompt = torch.as_tensor(run.prompt, device=dev)
    del run
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(vfull, dtype="float32",
                                n_layers=VLM_F32_SUPERBLOCKS * per)
    params32 = M.init(cfg32, seed=SEED, device=dev)
    f32_cross = lm_check(torch, step, layers, fa, params32, cfg32, prompt,
                         f"{VLM_ARCH} f32 at {VLM_F32_SUPERBLOCKS} "
                         "superblock", extra={"image_embeds": img.float()}
                         )["cross"]
    del params32, prompt, img
    torch.cuda.empty_cache()
    say(f"phase 9e/10e ({VLM_ARCH}): {time.perf_counter() - t_phase:.1f} s")

    # -- 11e. B4 times at musicgen's shape and at the cross shape ------------
    t_phase = time.perf_counter()
    m_times = b4_times(torch, dev, fa, B, S, mcfg.n_heads, mcfg.n_kv_heads,
                       mcfg.head_dim)
    x_times = b4_times(torch, dev, fa, B, S, vfull.n_heads, vfull.n_kv_heads,
                       vfull.head_dim, Sk=n_img)
    f32_row(torch, dev, fa, "flash_attention_f32_cross", f32_cross,
            x_err["cross f32"], B, S, vfull.n_heads, vfull.n_kv_heads,
            vfull.head_dim, Sk=n_img)
    say(f"phase 11e: {time.perf_counter() - t_phase:.1f} s")
    rows = [b4_row("flash_attention_musicgen", m_launches["flash_attention"],
                   m_err["prefill bf16 causal"], m_times),
            b4_row("flash_attention_cross", n_cross, x_err["cross bf16"],
                   x_times)]
    return rows, n_self


def graph_phase(torch, dev):
    """Phase 12: GraphBLAS's PageRank and BFS on the card at 2^20
    vertices, against the same PageRank call on the CPU and a numpy BFS.

    The edge factor of 16 (2^24 edges) is the Graph500 / PageRank
    Pipeline Benchmark's (Kepner et al., arXiv:1603.01876). Its Kronecker
    generator is not used: its skewed in-degree would make the ELL's row
    width (the largest in-degree) tens of thousands; uniform
    in-neighbours give ~40-48."""
    from repro_torch.core import graphblas as gb

    t_phase = time.perf_counter()
    n, m = GRAPH_VERTICES, GRAPH_EDGES
    rng = np.random.default_rng(SEED)
    src = rng.integers(0, n, m)                 # edge src -> dst
    dst = rng.integers(0, n, m)
    # the incoming-edges ELL, built on the card: row v lists the sources
    # of v's edges in edge order, -1 padded to the largest in-degree K
    s_t, d_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    order = torch.argsort(d_t, stable=True)
    indeg = torch.bincount(d_t, minlength=n)
    K = int(indeg.max())
    rows = d_t[order]
    slot = torch.arange(m, device=dev) - (torch.cumsum(indeg, 0) - indeg)[rows]
    ids = torch.full((n, K), -1, dtype=torch.int32, device=dev)
    ids[rows, slot] = s_t[order].to(torch.int32)
    vals = (ids >= 0).to(torch.float32)
    out_deg = torch.bincount(s_t, minlength=n)
    del s_t, d_t, order, rows, slot
    torch.cuda.synchronize()
    say(f"graph: {n} vertices, {m} edges (in-neighbours uniform from seed "
        f"{SEED}) as an incoming-edges ELL [{n}, {K}] on the card "
        f"({nbytes(ids, vals) / 1e9:.3f} GB of ids and values), built in "
        f"{time.perf_counter() - t_phase:.1f} s; {int((out_deg == 0).sum())}"
        f" vertices without an out-edge")

    run = lambda: gb.pagerank(ids, vals, out_deg, damping=0.85,  # noqa: E731
                              iters=GRAPH_PR_ITERS)
    pr = run()
    total = float(pr.sum())
    t0 = time.perf_counter()
    on_cpu = gb.pagerank(ids.cpu(), vals.cpu(), out_deg.cpu(), damping=0.85,
                         iters=GRAPH_PR_ITERS)
    cpu_s = time.perf_counter() - t0
    rel = float(((pr.cpu() - on_cpu).abs() / on_cpu.abs()).max())
    if abs(total - 1.0) > 1e-3 or rel > 1e-5:
        fail(f"graph pagerank: sums to {total!r}; max relative difference "
             f"to the CPU run {rel:.3e} (limit 1e-5)")
    it_ms = cuda_ms(torch, run, 3) / GRAPH_PR_ITERS
    # an iteration reads the ids, the values and the gathered x once
    b_ms, b_by = bound(3 * ids.numel() * 4, 2 * ids.numel())
    say(f"graph pagerank ({GRAPH_PR_ITERS} iterations, damping 0.85): sums "
        f"to {total:.7f}; max relative difference to the same call on the "
        f"CPU {rel:.3e} (rtol 1e-5; sums in another order; the CPU run "
        f"{cpu_s:.1f} s); {it_ms:.4f} ms an iteration on the card, bound "
        f"{b_ms:.4f} ms by {b_by} ({3 * ids.numel() * 4 / 1e9:.3f} GB), "
        f"{it_ms / b_ms:.1f}x; top vertex {int(pr.argmax())} at "
        f"{float(pr.max()):.3e}")

    t0 = time.perf_counter()
    levels = gb.bfs_levels(ids, 0, max_iters=GRAPH_BFS_ITERS).cpu().numpy()
    bfs_ms = (time.perf_counter() - t0) * 1e3
    want = np.full(n, np.inf, np.float32)
    want[0] = 0
    frontier = np.zeros(n, bool)
    frontier[0] = True
    for d in range(1, GRAPH_BFS_ITERS + 1):
        nxt = np.zeros(n, bool)
        nxt[dst[frontier[src]]] = True
        nxt &= np.isinf(want)
        want[nxt] = d
        frontier = nxt
    if not np.array_equal(levels, want):
        fail(f"graph bfs: {int((levels != want).sum())} levels differ from "
             "the numpy BFS")
    reached = np.isfinite(want)
    say(f"graph bfs from vertex 0 ({GRAPH_BFS_ITERS} iterations): "
        f"{bfs_ms:.1f} ms on the card, equal to a numpy BFS; "
        f"{int(reached.sum())} vertices reached, deepest level "
        f"{int(want[reached].max())}")
    say(f"graph phase: {time.perf_counter() - t_phase:.1f} s wall on "
        f"{nvidia_smi_line()}")
    del ids, vals, out_deg, pr
    torch.cuda.empty_cache()


def b4_lse_held(torch, fa, name, q, k, v, **kw):
    """Phase 13: one B4 call with its lse against the plain version's
    (within LSE_TOL), counted once as an lse launch, its output equal bit
    for bit to the call without the lse and held to phase 8's limits.
    Returns (max_abs_err of the output, of the lse)."""
    before = fa.flash_attention_gqa.launches_lse
    out, lse = fa.flash_attention_gqa(q, k, v, return_lse=True, **kw)
    null = fa.flash_attention_gqa(q, k, v, **kw)
    want, want_lse = fa.flash_attention_gqa_plain(q, k, v, return_lse=True,
                                                  **kw)
    torch.cuda.synchronize()
    if fa.flash_attention_gqa.launches_lse != before + 1:
        fail(f"B4 lse {name}: not counted as one lse launch")
    if not torch.equal(out, null):
        fail(f"B4 lse {name}: the output differs from the null-lse call's")
    lse_err = float((lse - want_lse).abs().max())
    if not (lse_err <= LSE_TOL and torch.isfinite(lse).all()):
        fail(f"B4 lse {name}: max |lse - plain| {lse_err} > {LSE_TOL}")
    err = b4_held(torch, fa, name, q, k, v, **kw)
    B, S, H, hd = q.shape
    say(f"B4 lse ({fa.design(q.dtype, hd)}) vs plain, {name} [{B}, {S}, "
        f"{H}/{k.shape[2]}, {hd}]: max |lse - plain| {lse_err:.3e} "
        f"(tolerance {LSE_TOL}); output equal to the null-lse call's")
    return err, lse_err


def dense_attention(torch, q, k, v, drop_tile=False):
    """Causal attention in f32 as one softmax over [S, S] scores
    (autograd's reference): (out [B, S, H, hd], lse [B, H, S]). With
    ``drop_tile``, query rows from FAULT_ROW on miss the 64-key tile
    FAULT_TILE: the planted fault of the gradient check."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    i = torch.arange(S, device=q.device)
    keep = i[:, None] >= i[None, :]
    if drop_tile:
        tile = (i >= 64 * FAULT_TILE) & (i < 64 * (FAULT_TILE + 1))
        keep &= ~((i[:, None] >= FAULT_ROW) & tile[None, :])
    s = s.masked_fill(~keep, -1e30)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    return out, torch.logsumexp(s, -1)


def rel_norm_err(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def function_grads_held(torch, layers, dev, dtype, B, S, H, KV, hd):
    """Phase 13: the training attention (``layers.blockwise_attention``'s
    autograd Function: B4 with its lse forward, the plain backward) at a
    layer's shape against autograd through ``dense_attention`` in f32 on
    the same inputs: dq, dk, dv within GRAD_TOL[dtype] (relative
    Frobenius norm). In bf16, a planted fault (``dense_attention``'s
    dropped tile in place of B4) must break the limit."""
    q, k, v = attention_inputs(torch, dev, B, S, H, KV, hd, dtype)
    dout = attention_inputs(torch, dev, B, S, H, KV, hd, dtype, SEED + 7)[0]
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    dense_attention(torch, *ref)[0].backward(dout.float())
    want = [t.grad for t in ref]
    del ref

    def grads():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        layers.blockwise_attention(*leaves).backward(dout)
        return [rel_norm_err(t.grad, w) for t, w in zip(leaves, want)]

    tol = GRAD_TOL[str(dtype).split(".")[1]]
    errs = grads()
    say(f"attention gradients ({str(dtype).split('.')[1]}, [{B}, {S}, "
        f"{H}/{KV}, {hd}]): B4 with lse + the plain backward against "
        f"autograd through f32 softmax attention, relative error of dq, "
        f"dk, dv {', '.join(f'{e:.3e}' for e in errs)} (limit {tol})")
    if not max(errs) <= tol:
        fail(f"attention gradients: {errs} beyond {tol}")
    if dtype == torch.bfloat16:
        kernel_attn = layers.flash_attention_gqa

        def dropped(q, k, v, causal=True, window=0, return_lse=True):
            out, lse = dense_attention(torch, q.float(), k.float(),
                                       v.float(), drop_tile=True)
            return out.to(q.dtype), lse
        layers.flash_attention_gqa = dropped
        try:
            faulty = grads()
        finally:
            layers.flash_attention_gqa = kernel_attn
        say(f"attention gradients with a planted fault (key tile "
            f"{FAULT_TILE} dropped for query rows from {FAULT_ROW}): "
            f"{', '.join(f'{e:.3e}' for e in faulty)}; the limit {tol} "
            "catches it")
        if max(faulty) <= tol:
            fail("attention gradients: the planted fault passes the limit")
    torch.cuda.empty_cache()
    return errs


def b4_lse_times(torch, dev, fa, B, S, H, KV, hd, Sk=None, dtype=None):
    """Phase 13: B4 with and without its lse (CUDA-graph replays), the
    plain version with the lse, and SDPA's forward (causal, GQA; with
    ``Sk`` keys non-causal, cross-attention), in ``dtype`` (default
    bf16) at the training shape, beside the bound (q, k, v, o and the
    lse's bytes; causal FLOPs, or all S·Sk pairs', at the dtype's peak).
    Returns the row's numbers."""
    dtype = dtype or torch.bfloat16
    q, k, v = attention_inputs(torch, dev, B, S, H, KV, hd, dtype)
    causal = Sk is None
    if not causal:
        k, v = cross_kv(torch, dev, B, Sk, KV, hd, dtype)
    which = fa.design(dtype, hd)
    ms = graph_ms(torch, lambda: fa.flash_attention_gqa(
        q, k, v, causal=causal, return_lse=True), 20)
    null_ms = graph_ms(torch, lambda: fa.flash_attention_gqa(
        q, k, v, causal=causal), 20)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_gqa_plain(
        q, k, v, causal=causal, return_lse=True), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    backend = sdpa_backend(torch, qt, kt, vt, attn_mask=None,
                           is_causal=causal, enable_gqa=True)
    lib_ms = graph_ms(torch, lambda: torch.nn.functional.
                      scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal,
                                                   enable_gqa=True), 20)
    flops = fa.attention_flops(B, S, Sk or S, H, hd, causal=causal)
    n_bytes = nbytes(q, k, v) + nbytes(q) + B * H * S * 4
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S
                       if dtype == torch.bfloat16 else F32_OPS_PER_S)
    mask = "causal" if causal else f"non-causal Sk {Sk}"
    say(f"time flash_attention with lse ({which}) [{B}, {S}, {H}/{KV}, "
        f"{hd}] {str(dtype).split('.')[-1]} {mask}: {ms:.4f} ms a launch in "
        f"a CUDA graph; {null_ms:.4f} "
        f"ms with a null lse ({ms / null_ms:.3f}x); plain {plain_ms:.3f} ms;"
        f" bound {b_ms:.4f} ms by {b_by}; library scaled_dot_product_"
        f"attention forward ({backend}) {lib_ms:.4f} ms; kernel / library "
        f"{ms / lib_ms:.2f}x")
    return {"design": which, "head_dim": hd, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "null_ms": null_ms}


def train_phases(torch, dev):
    """Phase 13: training on the card. B4's lse and the training
    attention's gradients at qwen3-4b's layer shape; qwen3-4b at full
    width and depth for TRAIN_STEPS steps through ``launch.train.main``
    (launch counts set to 0 before and read after: 2 B4 launches a layer
    a step, forward and remat recompute, all wgmma with the lse); its
    first step again with plain attention; a restart check. Returns B4's
    training row of the kernels line."""
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMData, to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, model as M
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    B, S, H, KV, hd = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)

    # -- 13a. B4's lse against the plain version's -------------------------
    errs = {}
    for name, s_len, dtype in (("train bf16 causal", S, torch.bfloat16),
                               ("train f32 causal", S, torch.float32),
                               ("bf16 causal S=1000", 1000, torch.bfloat16)):
        q, k, v = attention_inputs(torch, dev, 2 if s_len != S else B,
                                   s_len, H, KV, hd, dtype)
        errs[name] = b4_lse_held(torch, fa, name, q, k, v)
        del q, k, v

    # -- 13b. the training attention's gradients ------------------------
    for dtype in (torch.float32, torch.bfloat16):
        function_grads_held(torch, layers, dev, dtype, B, S, H, KV, hd)
    say(f"phase 13a-b (lse, gradients): {time.perf_counter() - t_phase:.1f}"
        " s")

    # -- 13c. qwen3-4b trains at full width and depth ------------------------
    t0 = time.perf_counter()
    trainer, _, launches, by, with_lse, peak = train_run(torch, dev,
                                                         TRAIN_ARCH)
    want = 2 * cfg.n_layers * TRAIN_STEPS
    c13 = {"history": [(r["loss"], r["grad_norm"]) for r in trainer.history],
           "sums": leaf_sums(trainer)}
    if not (launches["flash_attention"] == by["wgmma"] == with_lse == want):
        fail(f"B4 launched {launches['flash_attention']} times in "
             f"{TRAIN_STEPS} train steps ({by['wgmma']} wgmma, "
             f"{with_lse} with lse), want {want} of each")
    n_params = sum(p.numel() for _, p in opt.flatten(trainer.params))
    tokens = B * S
    attn_flops = 2 * B * H * S * S * hd * cfg.n_layers
    train_report(trainer, cfg, "fp32", peak,
                 6 * n_params * tokens + 3 * attn_flops,
                 f"6 N T {6 * n_params * tokens:.4e} + 3 x causal attention "
                 f"forward {3 * attn_flops:.4e}")
    first = trainer.history[0]
    del trainer
    torch.cuda.empty_cache()
    say(f"phase 13c (train): {time.perf_counter() - t0:.1f} s")

    # -- 13d. the first step's loss and gradients with plain attention ----
    t0 = time.perf_counter()
    params = M.init(cfg, seed=SEED, device=dev)
    leaves = [p.requires_grad_(True) for _, p in opt.flatten(params)]
    batch = to_device(SyntheticLMData(cfg, B, S, seed=SEED).batch_at(0), dev)
    kernel_attn = layers.flash_attention_gqa
    layers.flash_attention_gqa = fa.flash_attention_gqa_plain
    try:
        logits, aux, _ = M.apply_train(params, cfg, batch)
        labels = batch["tokens"][:, 1:]
        loss = layers.softmax_cross_entropy(
            logits[:, :-1], labels, torch.ones(labels.shape, device=dev)) \
            + 0.01 * aux
        atol = lm_atol("bfloat16", logits.detach())
        grads = torch.autograd.grad(loss, leaves)
    finally:
        layers.flash_attention_gqa = kernel_attn
    gnorm = float(opt.global_norm(list(grads)))
    loss = float(loss.detach())
    loss_err = abs(loss - first["loss"])
    g_rel = abs(gnorm - first["grad_norm"]) / gnorm
    say(f"train check ({TRAIN_ARCH} step 0, kernel against plain "
        f"attention): loss {first['loss']:.5f} vs {loss:.5f}, "
        f"|diff| {loss_err:.3e} (limit {atol}, lm_atol of the plain run's "
        f"logits); grad norm {first['grad_norm']:.5f} vs {gnorm:.5f}, "
        f"relative {g_rel:.3e} (limit {GNORM_RTOL})")
    if not (loss_err <= atol and g_rel <= GNORM_RTOL):
        fail("train: the kernel run's first step differs from plain "
             "attention's")
    del params, leaves, logits, loss, grads, batch
    torch.cuda.empty_cache()
    say(f"phase 13d (plain-attention step): {time.perf_counter() - t0:.1f} s")

    # -- 13e. restart: 4 straight steps against 2 + restore + 2 ----------
    t0 = time.perf_counter()
    full = get_config(RESTART_ARCH)
    rcfg = dataclasses.replace(full, n_layers=RESTART_LAYERS)

    def tc(name, every):
        return TrainConfig(
            model=rcfg, opt=OptimizerConfig(lr=3e-4, warmup_steps=1,
                                            total_steps=4, int8_states=True),
            seq_len=S, global_batch=B, checkpoint_every=every,
            checkpoint_dir=str(TRAIN_ROOT / name), keep_checkpoints=2)

    quiet = lambda s: None  # noqa: E731
    straight = Trainer(tc("straight", 100), dev, log_fn=quiet)
    straight.run(4)
    straight.close()
    first_half = Trainer(tc("restart", 2), dev, log_fn=quiet)
    first_half.run(2)
    first_half.close()
    del first_half
    resumed = Trainer(tc("restart", 2), dev, log_fn=quiet)
    if resumed.start_step != 2:
        fail(f"restart: resumed at {resumed.start_step}, want 2")
    resumed.run(2)
    resumed.close()
    diff = 0.0
    for key in ("params", "m", "v"):
        a = straight.params if key == "params" else straight.opt_state[key]
        b = resumed.params if key == "params" else resumed.opt_state[key]
        for (_, x), (_, y) in zip(opt.flatten(a), opt.flatten(b)):
            pairs = [(x.q, y.q), (x.scale, y.scale)] \
                if isinstance(x, opt.QTensor) else [(x, y)]
            for u, w in pairs:
                diff = max(diff, float((u.detach().float()
                                        - w.detach().float()).abs().max()))
    losses = ([r["loss"] for r in straight.history[2:]],
              [r["loss"] for r in resumed.history])
    say(f"restart ({RESTART_ARCH} at {RESTART_LAYERS} of {full.n_layers} "
        f"layers, full width, int8 states, batch {B} x {S}): 4 straight "
        f"steps against 2 + restore + 2: losses {losses[0]} vs {losses[1]};"
        f" params and states max |diff| {diff} (limit 0: bit for bit)")
    if diff != 0.0 or losses[0] != losses[1]:
        fail("restart: the restored run differs from the straight one")
    del straight, resumed
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"phase 13e (restart): {time.perf_counter() - t0:.1f} s")

    # -- 13f. B4 times with the lse ---------------------------------------------
    times = b4_lse_times(torch, dev, fa, B, S, H, KV, hd)
    say(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    row = b4_row("flash_attention_train", launches["flash_attention"],
                 errs["train bf16 causal"][0], times)
    row["lse_max_abs_err"] = errs["train bf16 causal"][1]
    return row, c13


def wkv_backward_held(torch, dev, cfg):
    """Phase 14b: rwkv6's WKV backward at one rwkv6-7b layer's time-mix at
    full width (B 4, T 1024, 64 heads of 64), its r, k, v, lw and u from
    the layer's own params on seeded tokens: ``WKVChunked``'s gradients
    against ``wkv_chunked_plain``'s (plain autograd a chunk at a time),
    each backward's peak memory, and the Function's backward twice for
    the same bits. Returns the printed numbers."""
    from repro_torch.data.pipeline import SyntheticLMData, to_device
    from repro_torch.models import layers, rwkv6

    B, S = TRAIN_BATCH, TRAIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(SEED)
    embed = layers.embed_init(gen, cfg)
    pb = rwkv6._layer_init(gen, cfg)
    tokens = to_device(SyntheticLMData(cfg, B, S, seed=SEED).batch_at(0),
                       dev)["tokens"]
    x = layers.rms_norm(layers.embed_apply(embed, tokens), pb["ln1"],
                        cfg.norm_eps)
    state = {k: t[0] for k, t in rwkv6.init_state(cfg, B, x.dtype,
                                                  dev).items()}
    grabbed = []
    real = rwkv6._wkv_chunked
    rwkv6._wkv_chunked = lambda *a: grabbed.append(a) or real(*a)
    try:
        with torch.no_grad():
            rwkv6._time_mix(pb["tm"], x, cfg, state)
    finally:
        rwkv6._wkv_chunked = real
    r, k, v, lw, u, s0, chunk = grabbed[0]
    del embed, x, grabbed
    gen.manual_seed(SEED + 3)
    dout = torch.randn(r.shape, generator=gen, device=dev).to(r.dtype)
    d_state = torch.randn(s0.shape, generator=gen, device=dev)
    torch.cuda.empty_cache()

    def run(fn):
        """Gradients of (r, k, v, lw, u) and the peak memory of the
        forward and backward over what was allocated before them."""
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (r, k, v, lw, u)]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*leaves, s0, chunk)
        saved = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(out, leaves, (dout, d_state))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        return grads, saved, peak

    got, f_saved, f_peak = run(rwkv6._wkv_chunked)
    again, _, _ = run(rwkv6._wkv_chunked)
    want, p_saved, p_peak = run(rwkv6.wkv_chunked_plain)
    errs = [rel_norm_err(a, b.float()) for a, b in zip(got, want)]
    limits = [WKV_GRAD_TOL[str(a.dtype).split(".")[1]] for a in got]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    d_bytes = rwkv6.D_BYTES
    say(f"WKV backward (rwkv6-7b time-mix, r, k, v {str(r.dtype)[6:]} "
        f"[{B}, {S}, {r.shape[2]}, {r.shape[3]}], chunks of {chunk}, "
        f"groups of {rwkv6._group(B, r.shape[2], chunk, r.shape[3])}): "
        f"WKVChunked against the plain per-chunk autograd, relative error "
        f"of dr, dk, dv, dlw, du {', '.join(f'{e:.3e}' for e in errs)} "
        f"(limits {', '.join(str(x) for x in limits)}); backward twice "
        f"bit for bit: {same}")
    say(f"WKV memory over the forward and backward: WKVChunked holds "
        f"{f_saved / 1e9:.3f} GB after its forward and peaks at "
        f"{f_peak / 1e9:.3f} GB ({f_peak / d_bytes:.2f} x D_BYTES); the "
        f"plain version {p_saved / 1e9:.3f} GB and {p_peak / 1e9:.3f} GB "
        f"(limit for the Function: {WKV_PEAK_D} x D_BYTES + what it "
        "saves)")
    if not all(e <= t for e, t in zip(errs, limits)):
        fail(f"WKV backward: {errs} beyond {limits}")
    if not same:
        fail("WKV backward: two runs differ")
    if not f_peak <= WKV_PEAK_D * d_bytes + f_saved:
        fail(f"WKV backward: peak {f_peak} past {WKV_PEAK_D} x D_BYTES + "
             f"{f_saved}")
    del got, again, want, r, k, v, lw, u, s0, dout, d_state, pb
    torch.cuda.empty_cache()
    return {"errs": errs, "peak": f_peak, "plain_peak": p_peak}


def train_run(torch, dev, arch, flags=()):
    """Phases 13c, 14c-d: ``arch`` at full width and depth for
    TRAIN_STEPS steps at TRAIN_BATCH x TRAIN_SEQ through
    ``launch.train.main``, checkpoints off, with the launch counts set to
    0 before and read after; finite losses. Returns (the trainer, its
    config, the launch counts, B4's by instance and with the lse, the
    peak memory)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher

    cfg = get_config(arch)
    ckpt_dir = TRAIN_ROOT / arch
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--seq-len",
            str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--ckpt-every",
            str(10 * TRAIN_STEPS), "--ckpt-dir", str(ckpt_dir), *flags]
    counted = _launch_counters()
    for fn in counted.values():
        fn.launches = 0
    b4 = fa.flash_attention_gqa
    for name in b4.launches_by_design:
        b4.launches_by_design[name] = 0
    for name in ("launches_lse", "launches_windowed", "launches_cross"):
        setattr(b4, name, 0)
    torch.cuda.reset_peak_memory_stats()
    trainer = train_launcher.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in counted.items()}
    by = dict(b4.launches_by_design)
    say(f"train main path ({arch}) launches: {launches}; B4 by instance "
        f"{by}, with lse {b4.launches_lse}, windowed "
        f"{b4.launches_windowed}, cross {b4.launches_cross}")
    hist = trainer.history
    if len(hist) != TRAIN_STEPS or not all(
            np.isfinite([r["loss"], r["grad_norm"]]).all() for r in hist):
        fail(f"train {arch}: history {hist}")
    if any(ckpt_dir.glob("step_*")):
        fail(f"train {arch}: a checkpoint was written before --ckpt-every")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return trainer, cfg, launches, by, b4.launches_lse, peak


def train_report(trainer, cfg, states, peak, flops, flop_note):
    """Phases 13c, 14c-d: each step's loss, grad norm and ms, the median
    step of steps 2-3, tokens/s and MFU against BF16_OPS_PER_S at
    ``flops`` a step."""
    from repro_torch.train import optimizer as opt
    hist = trainer.history
    n_params = sum(p.numel() for _, p in opt.flatten(trainer.params))
    step_s = statistics.median(r["seconds"] for r in hist[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for r in hist:
        say(f"train {cfg.name} step {r['step']}: loss {r['loss']:.5f}, grad "
            f"norm {r['grad_norm']:.5f}, lr {r['lr']:.3e}, "
            f"{r['seconds'] * 1e3:.1f} ms")
    say(f"train ({cfg.name}, {cfg.n_layers} layers, {n_params} params, "
        f"bf16, {states} AdamW states, remat minimal, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}): step {step_s * 1e3:.1f} ms (median of steps "
        f"2-{TRAIN_STEPS}), {tokens / step_s:.0f} tokens/s, MFU "
        f"{flops / step_s / BF16_OPS_PER_S:.4f} of "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s ({flops:.4e} FLOP a step: "
        f"{flop_note}); max_memory_allocated "
        f"{peak / 1e9:.2f} GB; {nvidia_smi_line()}")
    return step_s


def train_recurrent_phases(torch, dev):
    """Phase 14: the recurrent archs train on the card. B4 with its lse
    and the training attention's gradients at zamba2's shape (G = 1);
    the WKV backward at one rwkv6-7b layer; rwkv6-7b (int8 states) and
    zamba2-1.2b (f32 states) at full width and depth for TRAIN_STEPS
    steps through ``launch.train.main``; zamba2's first step again with
    plain attention. Returns B4's G = 1 training row of the kernels
    line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMData, to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import hybrid, layers, model as M
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    zcfg = get_config("zamba2-1.2b")
    B, S, H, KV, hd = (TRAIN_BATCH, TRAIN_SEQ, zcfg.n_heads,
                       zcfg.n_kv_heads, zcfg.head_dim)

    # -- 14a. B4 at zamba2's training shape -------------------------------
    errs = {}
    for name, dtype in (("zamba2 train bf16", torch.bfloat16),
                        ("zamba2 train f32", torch.float32)):
        q, k, v = attention_inputs(torch, dev, B, S, H, KV, hd, dtype)
        errs[name] = b4_lse_held(torch, fa, name, q, k, v)
        del q, k, v
    for dtype in (torch.float32, torch.bfloat16):
        function_grads_held(torch, layers, dev, dtype, B, S, H, KV, hd)
    say(f"phase 14a (B4 at G = 1, lse, gradients): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # -- 14b. the WKV backward at one rwkv6-7b layer -------------------------
    t0 = time.perf_counter()
    wcfg = get_config("rwkv6-7b")
    wkv_backward_held(torch, dev, wcfg)
    say(f"phase 14b (WKV backward): {time.perf_counter() - t0:.1f} s")

    # -- 14c. rwkv6-7b at full width and depth, int8 states ---------------
    t0 = time.perf_counter()
    trainer, cfg, launches, by, with_lse, peak = train_run(
        torch, dev, "rwkv6-7b", ["--int8-opt"])
    if launches["flash_attention"] or with_lse or any(by.values()):
        fail(f"rwkv6-7b launched B4 ({launches['flash_attention']}, {by}): "
             "the arch is attention-free")
    n_params = sum(p.numel() for _, p in opt.flatten(trainer.params))
    train_report(trainer, cfg, "int8", peak, 6 * n_params * B * S,
                 "6 N T; the WKV scan's own FLOPs are not counted")
    del trainer
    torch.cuda.empty_cache()
    say(f"phase 14c (rwkv6-7b train): {time.perf_counter() - t0:.1f} s")

    # -- 14d. zamba2-1.2b at full width and depth, f32 states -------------
    t0 = time.perf_counter()
    trainer, cfg, launches, by, with_lse, peak = train_run(
        torch, dev, "zamba2-1.2b")
    sites = hybrid.n_attn_sites(cfg)
    want = sites * TRAIN_STEPS
    if not (launches["flash_attention"] == by["wgmma"] == with_lse
            == want):
        fail(f"B4 launched {launches['flash_attention']} times in "
             f"{TRAIN_STEPS} zamba2 train steps ({by['wgmma']} wgmma, "
             f"{with_lse} with lse), want {want} of each")
    n_params = sum(p.numel() for _, p in opt.flatten(trainer.params))
    n_shared = sum(p.numel() for _, p in opt.flatten(
        trainer.params["shared_attn"]))
    n_flop = n_params + (sites - 1) * n_shared
    train_report(
        trainer, cfg, "fp32", peak, 6 * n_flop * B * S,
        f"6 N T at N {n_flop}, the shared block's {n_shared} params once a "
        f"site, {sites} sites; the SSD scan's own FLOPs and attention's are "
        "not counted")
    first = trainer.history[0]
    zamba_launches = launches["flash_attention"]
    del trainer
    torch.cuda.empty_cache()
    params = M.init(cfg, seed=SEED, device=dev)
    leaves = [p.requires_grad_(True) for _, p in opt.flatten(params)]
    batch = to_device(SyntheticLMData(cfg, B, S, seed=SEED).batch_at(0), dev)
    kernel_attn = layers.flash_attention_gqa
    layers.flash_attention_gqa = fa.flash_attention_gqa_plain
    try:
        logits, aux, _ = M.apply_train(params, cfg, batch)
        labels = batch["tokens"][:, 1:]
        loss = layers.softmax_cross_entropy(
            logits[:, :-1], labels, torch.ones(labels.shape, device=dev)) \
            + 0.01 * aux
        atol = lm_atol("bfloat16", logits.detach(), ZAMBA_ULPS)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        layers.flash_attention_gqa = kernel_attn
    gnorm = float(opt.global_norm(list(grads)))
    loss = float(loss.detach())
    loss_err = abs(loss - first["loss"])
    g_rel = abs(gnorm - first["grad_norm"]) / gnorm
    say(f"train check ({cfg.name} step 0, kernel against plain attention): "
        f"loss {first['loss']:.5f} vs {loss:.5f}, |diff| {loss_err:.3e} "
        f"(limit {atol}, lm_atol of the plain run's logits at "
        f"{ZAMBA_ULPS} ulps); grad norm {first['grad_norm']:.5f} vs "
        f"{gnorm:.5f}, relative {g_rel:.3e} (limit {GNORM_RTOL})")
    if not (loss_err <= atol and g_rel <= GNORM_RTOL):
        fail("train: zamba2's first step differs from plain attention's")
    del params, leaves, logits, loss, grads, batch
    torch.cuda.empty_cache()
    say(f"phase 14d (zamba2-1.2b train): {time.perf_counter() - t0:.1f} s")

    # -- 14e. B4's times at zamba2's training shape ---------------------------
    times = b4_lse_times(torch, dev, fa, B, S, H, KV, hd)
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    say(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    row = b4_row("flash_attention_train_g1", zamba_launches,
                 errs["zamba2 train bf16"][0], times)
    row["lse_max_abs_err"] = errs["zamba2 train bf16"][1]
    return row


def lm_mesh_phase(torch, dev):
    """Phase 16: LM serving on a mesh. 16c first, in this process: a
    world of one rank over NCCL (a 1 x 1 DeviceMesh), qwen3-4b through
    the mesh code bit for bit the one-device run. 16a: qwen3-4b at full
    size on a 2 x 2 mesh, 16b: qwen3-moe at MESH_MOE_LAYERS layers on a 1 x 4
    mesh, four ranks each (``lm_mesh_rank``) on this one card over gloo.
    16d: the ssm, hybrid, audio and vlm families (``families_phase``).
    Returns B4's launches in the phase's serving runs (every rank's), by
    the kernels line's row."""
    import dataclasses
    import datetime
    import pickle
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build, flash_attention as fa
    from repro_torch.models import model as M, moe, perfcfg
    from repro_torch.serve import step

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    MESH_ROOT.mkdir(parents=True)
    cfg = get_config(MESH_LM_ARCH)
    B, S, new = LM_BATCH, LM_PROMPT, MESH_LM_NEW
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    # -- one device: the weights of seed SEED, the steps' logits -------------
    params = M.init(cfg, seed=SEED, device=dev)
    one, one_stats = [], {}
    one_toks = step.generate(params, cfg, prompt, max_new=new,
                             max_len=S + new, device=dev, logits=one,
                             stats=one_stats)
    del params
    torch.cuda.empty_cache()
    say(f"mesh 16 one device ({cfg.name}, {B} x {S}, {new} greedy tokens): "
        f"prefill {one_stats['prefill_s'] * 1e3:.1f} ms, decode "
        f"{one_stats['decode_s'] * 1e3 / (new - 1):.2f} ms a step")

    # -- 16c: 1 x 1 through NCCL, served by the launcher ---------------------
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=MESH_TIMEOUT_S)
    counted = 0
    fa.flash_attention_gqa.launches = 0
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(MESH_ROOT / "nccl"), 1), rank=0,
        world_size=1, timeout=timeout, device_id=dev)
    try:
        got = []
        run = mesh_served("1,1", "nccl", got)
        stats = run.stats
        torch.cuda.synchronize()
        counted += fa.flash_attention_gqa.launches
        if fa.flash_attention_gqa.launches <= 0:
            fail("mesh 16c: B4 did not launch")
        if tuple(run.ctx.shape.values()) != (1, 1) or run.ctx.device != dev:
            fail(f"mesh 16c: the launcher's ctx is {run.ctx.shape} on "
                 f"{run.ctx.device}")
        for t, (a, b) in enumerate(zip(got, one)):
            if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                fail(f"mesh 16c: step {t}'s logits differ from the one-device "
                     "run's bits")
        if len(got) != new or not torch.equal(run.tokens, one_toks):
            fail("mesh 16c: tokens differ from the one-device run")
        del run, got
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    say(f"mesh 16c (1 x 1, one rank over NCCL, through launch.serve.main "
        f"--mesh 1,1): {new} steps' logits bit for bit the one-device run's; "
        f"prefill {stats['prefill_s'] * 1e3:.1f} ms, decode "
        f"{stats['decode_s'] * 1e3 / (new - 1):.2f} ms a step; B4 launches "
        f"{fa.flash_attention_gqa.launches}; {card}")

    # -- 16a: qwen3-4b at MESH_LM_LAYERS on 2 x 2, four ranks on this card
    # over gloo, against one device at that depth -------------------------
    cut = dataclasses.replace(cfg, n_layers=MESH_LM_LAYERS)
    params = M.init(cut, seed=SEED, device=dev)
    one = []
    one_toks = step.generate(params, cut, prompt, max_new=new,
                             max_len=S + new, device=dev, logits=one)
    del params
    torch.cuda.empty_cache()
    _build.build(["flash_attention"])          # the ranks load, never build
    one_np = torch.stack(one).float().cpu().numpy()    # [new, B, 1, V]
    outs = lm_mesh_ranks(mp, "dense", MESH_LM_SHAPE)
    atol = lm_atol("bfloat16", torch.from_numpy(one_np))
    want_toks = one_toks.cpu().numpy()
    first = next((t for t in range(new)
                  if not np.array_equal(outs[0]["tokens"][:, t],
                                        want_toks[:, t])), new)
    for t in range(first):
        err = float(np.abs(outs[0]["steps"][t] - one_np[t]).max())
        if err > atol:
            fail(f"mesh 16a: step {t}'s logits {err} from one device's "
                 f"(limit {atol})")
    if first < new:
        top2 = np.sort(one_np[first][:, 0], axis=-1)[:, -2:]
        rows = np.nonzero(outs[0]["tokens"][:, first]
                          != want_toks[:, first])[0]
        if ((top2[rows, 1] - top2[rows, 0]) >= atol).any():
            fail(f"mesh 16a: tokens part at step {first} above the top-2 "
                 f"margin limit {atol}")
    err0 = float(np.abs(outs[0]["steps"][0] - one_np[0]).max())
    for o in outs:
        if not np.array_equal(o["tokens"], outs[0]["tokens"]):
            fail(f"mesh 16a rank {o['rank']}: tokens differ from rank 0's")
        counted += lm_mesh_rank_line("16a", o, card)
    say(f"mesh 16a ({cfg.name} at full width, {MESH_LM_LAYERS} of "
        f"{cfg.n_layers} layers, on 2 x 2, 4 ranks on one card over gloo, "
        f"born sharded from seed {SEED}): the first step's logits "
        f"{err0:.4f} from the one-device run's (limit {atol:.4f}, lm_atol), "
        f"tokens equal for {first} of {new} steps (they may part only below "
        "the top-2 margin limit)")

    # -- 16b: qwen3-moe at MESH_MOE_LAYERS layers on 1 x 4 -------------------
    full = get_config(MOE_ARCH)
    mcfg = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS)
    nd_cfg = dataclasses.replace(mcfg, capacity_factor=NO_DROP_CF)
    params = M.init(mcfg, seed=SEED, device=dev)
    moe.moe_apply.record = []
    try:
        nd_one, _, _ = M.apply_prefill(
            params, nd_cfg, {"tokens": torch.as_tensor(prompt, device=dev)},
            last_only=True)
        routing = moe.moe_apply.record
    finally:
        moe.moe_apply.record = None
    dropped = sum(r["dropped"] for r in routing)
    if dropped:
        fail(f"mesh 16b: one device dropped {dropped} assignments at "
             f"capacity factor {NO_DROP_CF}")
    # the ranks replay this routing: a one-ulp difference flips near-ties
    # among 128 experts (phase 9b's lm_check replays for the same reason);
    # each flip's margin is held below nd_atol in the ranks
    torch.save([r["expert_id"].cpu() for r in routing],
               MESH_ROOT / "moe_routing.pt")
    # 18c's yardstick on one device: the same pass under the a2aint8
    # variant, this routing replayed (the wire's int8 rows alone move it)
    perfcfg.set_variant("a2aint8")
    moe.moe_apply.replay = [r["expert_id"] for r in routing]
    try:
        nd_a2a, _, _ = M.apply_prefill(
            params, nd_cfg, {"tokens": torch.as_tensor(prompt, device=dev)},
            last_only=True)
    finally:
        perfcfg.reset()
        moe.moe_apply.replay = None
    nd_a2a = nd_a2a.float().cpu().numpy()
    ids0 = routing[0]["expert_id"]
    del routing
    nd_one = nd_one.float().cpu().numpy()
    nd_atol = lm_atol("bfloat16", torch.from_numpy(nd_one))
    with open(MESH_ROOT / "moe_limit.json", "w") as f:
        json.dump({"flip_margin": nd_atol}, f)
    layer0 = params["blocks"][0]["moe"]
    del params
    torch.cuda.empty_cache()
    outs = lm_mesh_ranks(mp, "moe", MESH_MOE_SHAPE)
    x = torch.load(MESH_ROOT / "moe_x.pt").to(dev)
    y_sim, _ = moe.dispatch_simulated(layer0, x, mcfg, dp=1,
                                      M=MESH_MOE_SHAPE[1])
    tol = 2 * 2.0 ** (np.floor(np.log2(float(y_sim.float().abs().max()))) - 7)
    a2a_first = a2a_first_held(torch, moe, perfcfg, layer0, x, mcfg, dev)
    del x
    x_nd = torch.load(MESH_ROOT / "moe_nd_x.pt").to(dev)
    y_plain = moe_plain(torch, layer0, x_nd.reshape(-1, mcfg.d_model), ids0)
    plain_tol = MOE_PLAIN_ULPS * 2.0 ** (
        np.floor(np.log2(float(y_plain.abs().max()))) - 7)
    for o in outs:
        y = torch.load(MESH_ROOT / f"moe_y{o['rank']}.pt").to(dev)
        err = float((y.float() - y_sim.float()).abs().max())
        if err > tol:
            fail(f"mesh 16b rank {o['rank']}: the first MoE block {err} from "
                 f"dispatch_simulated (limit {tol}, two bf16 ulps of its max)")
        o["moe_err"] = err
        y = torch.load(MESH_ROOT / f"moe_nd_y{o['rank']}.pt").to(dev)
        o["plain_err"] = float((y.float().reshape(y_plain.shape)
                                - y_plain).abs().max())
        if o["plain_err"] > plain_tol:
            fail(f"mesh 16b rank {o['rank']}: the no-drop pass's first MoE "
                 f"block {o['plain_err']} from moe_plain (limit {plain_tol}, "
                 f"{MOE_PLAIN_ULPS} bf16 ulps of its max)")
        nd_err = float(np.abs(o["no_drop"] - nd_one).max())
        if nd_err > nd_atol:
            fail(f"mesh 16b rank {o['rank']}: logits at capacity factor "
                 f"{NO_DROP_CF} {nd_err} from one device's (limit {nd_atol})")
        o["no_drop_err"] = nd_err
        if o["flip_margin"] >= nd_atol:
            fail(f"mesh 16b rank {o['rank']}: the mesh's router chose another "
                 f"expert set at a routing margin {o['flip_margin']} >= "
                 f"{nd_atol}")
        counted += lm_mesh_rank_line("16b", o, card)
    del layer0, y_sim, x_nd, y_plain, ids0
    torch.cuda.empty_cache()
    # 18c: the mesh's a2a_int8 pass with one device's routing replayed
    # against one device's; and the reference test's rule, mean |diff| /
    # mean |base| against the flag off, read for the router's own
    # choices, the replayed mesh and one device
    got = outs[0]["a2a_replayed"]
    c = PHASE18["18c"] = {
        "first": a2a_first,
        "quantized": [o["a2a_quantized"] for o in outs],
        "seconds": max(o["a2a_s"] for o in outs),
        "mesh_err": float(np.abs(got - nd_a2a).max()),
        "differs": not np.array_equal(got, outs[0]["no_drop"])}
    for name, a, base in (("own", outs[0]["a2a_own"], outs[0]["steps"][0]),
                          ("replayed", got, outs[0]["no_drop"]),
                          ("one", nd_a2a, nd_one),
                          ("mesh_vs_one", got, nd_a2a)):
        c[name] = float(np.abs(a - base).mean() / (np.abs(base).mean()
                                                   + 1e-6))
    say(f"mesh 16b ({MOE_ARCH} at {MESH_MOE_LAYERS} of {full.n_layers} layers on "
        f"1 x 4: {full.n_experts // MESH_MOE_SHAPE[1]} experts a rank, the "
        "all_to_all over 4 ranks on one card over gloo): each rank's first "
        "MoE block equals dispatch_simulated within two bf16 ulps; at "
        f"capacity factor {NO_DROP_CF} nothing drops, the first MoE block is "
        f"within {MOE_PLAIN_ULPS} bf16 ulps of moe_plain ({plain_tol:.4f}), "
        "and, one device's routing replayed, the last position's logits are "
        f"within lm_atol {nd_atol:.4f} of one device's, every flip of the "
        f"mesh's own router at a margin below it; at {full.capacity_factor} "
        "the drops are per shard (ROADMAP C26)")

    # -- 16d: the ssm, hybrid, audio and vlm families ------------------------
    launches = families_phase(torch, dev, card)
    launches["flash_attention_hd128"] = launches.get(
        "flash_attention_hd128", 0) + counted
    shutil.rmtree(MESH_ROOT, ignore_errors=True)
    say(f"phase 16: {time.perf_counter() - t_phase:.1f} s wall; {card}")
    return launches


def families_phase(torch, dev, card):
    """Phase 16d: the ssm, hybrid, audio and vlm families on a mesh, each
    run of MESH_FAMILY_RUNS at full width and its depth. First in this
    process: each run on one device (the one-device route: ``M.init``, or
    the launcher without ``--mesh``), each step's logits kept; then each
    on a world of one rank over NCCL (a 1 x 1 DeviceMesh, the weights
    born sharded, or ``launch.serve.main --mesh 1,1``), every step's
    logits bit for bit the one-device run's. Then four ranks
    (``lm_family_rank``) on this card over gloo serve them all: logits
    within lm_atol of the one-device run's (zamba2 at ZAMBA_ULPS), tokens
    equal wherever its top-2 margin exceeds that limit, every rank's
    tokens equal, B4's launches ``b4_per_generate`` at the run's depth on
    every rank (none for rwkv6) and B4 at each rank's first site and
    first cross site against its plain version. Returns B4's launches of
    the NCCL and four-rank runs by the kernels line's row."""
    import datetime
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build, flash_attention as fa
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    new = MESH_FAMILY_NEW
    one = {}
    for label, arch, mesh, layers, route, dtype in MESH_FAMILY_RUNS:
        cfg, steps = family_cfg(arch, layers, dtype), []
        if route == "launcher":
            run = mesh_served(None, None, steps, arch=arch, new=new,
                              layers=layers)
            toks, stats = run.tokens, run.stats
            del run
        else:
            params = M.init(cfg, seed=SEED, device=dev)
            toks, stats = family_served(torch, cfg, route, params, None, dev,
                                        steps)
            del params
        torch.cuda.empty_cache()
        one[label] = (toks, steps)
        say(f"mesh 16d-{label} one device ({cfg.name} {dtype}, "
            f"{cfg.n_layers} of "
            f"{family_cfg(arch, None).n_layers} layers, {LM_BATCH} x "
            f"{LM_PROMPT}, {new} greedy tokens, route {route}): prefill "
            f"{stats['prefill_s'] * 1e3:.1f} ms, decode "
            f"{stats['decode_s'] * 1e3 / (new - 1):.2f} ms a step")

    # -- 16d over NCCL: a world of one rank, a 1 x 1 mesh --------------------
    launches = {}

    def add(label, cfg, n, n_cross):
        """The main path's launches (bf16) by row; the f32 checks' not."""
        if cfg.dtype != "bfloat16":
            return
        row = {"hybrid": "flash_attention_g1",
               "audio": "flash_attention_musicgen"}.get(
            label, "flash_attention_hd128")
        if label != "ssm":
            launches[row] = launches.get(row, 0) + n - n_cross
        if n_cross:
            launches["flash_attention_cross"] = launches.get(
                "flash_attention_cross", 0) + n_cross
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(MESH_ROOT / "nccl-families"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S), device_id=dev)
    try:
        for label, arch, mesh, layers, route, dtype in MESH_FAMILY_RUNS:
            cfg, got = family_cfg(arch, layers, dtype), []
            fa.flash_attention_gqa.launches = 0
            fa.flash_attention_gqa.launches_cross = 0
            if route == "launcher":
                run = mesh_served("1,1", "nccl", got, arch=arch, new=new,
                                  layers=layers)
                toks = run.tokens
                del run
            else:
                ctx = serve_launcher.mesh_ctx((1, 1), "nccl", "cuda")
                params = sharding.sharded_init(cfg, ctx, seed=SEED)
                toks, _ = family_served(torch, cfg, route, params, ctx, dev,
                                        got)
                del params
            torch.cuda.synchronize()
            n = fa.flash_attention_gqa.launches
            if n != b4_per_generate(cfg, new):
                fail(f"mesh 16d-{label} 1 x 1: B4 launched {n} times, want "
                     f"{b4_per_generate(cfg, new)}")
            add(label, cfg, n, fa.flash_attention_gqa.launches_cross)
            for t, (a, b) in enumerate(zip(got, one[label][1])):
                if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                    fail(f"mesh 16d-{label} 1 x 1: step {t}'s logits differ "
                         "from the one-device run's bits")
            if len(got) != new or not torch.equal(toks, one[label][0]):
                fail(f"mesh 16d-{label} 1 x 1: tokens differ from the "
                     "one-device run")
            del got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    say(f"mesh 16d (1 x 1, one rank over NCCL): every run's {new} steps' "
        f"logits bit for bit the one-device run's; {card}")

    # -- 16d: four ranks on this card over gloo ------------------------------
    _build.build(["flash_attention"])          # the ranks load, never build
    outs = lm_mesh_ranks(mp, "families", None, rank_fn=lm_family_rank,
                         world=4)
    faults = []                 # every run is reported before one fails
    for label, arch, mesh, layers, route, dtype in MESH_FAMILY_RUNS:
        cfg = family_cfg(arch, layers, dtype)
        toks_one, steps_one = one[label]
        one_np = torch.stack(steps_one).float().cpu().numpy()
        atol = lm_atol(dtype, torch.from_numpy(one_np),
                       MESH_FAMILY_ULPS.get(cfg.family, LM_ULPS))
        ranks_ = [o[label] for o in outs]
        got, want_toks = ranks_[0], toks_one.cpu().numpy()
        first = next((t for t in range(new)
                      if not np.array_equal(got["tokens"][:, t],
                                            want_toks[:, t])), new)
        # a step's logits follow from the tokens before it: those of the
        # step where the tokens first part are comparable too
        errs = [float(np.abs(got["steps"][t] - one_np[t]).max())
                for t in range(min(first + 1, new))]
        if errs and max(errs) > atol:
            faults.append(f"16d-{label}: logits {max(errs)} from one "
                          f"device's (limit {atol})")
        if first < new:
            top2 = np.sort(one_np[first][:, 0], axis=-1)[:, -2:]
            rows = np.nonzero(got["tokens"][:, first]
                              != want_toks[:, first])[0]
            if ((top2[rows, 1] - top2[rows, 0]) >= atol).any():
                faults.append(f"16d-{label}: tokens part at step {first} "
                              f"above the top-2 margin limit {atol}")
        for o in ranks_:
            if not np.array_equal(o["tokens"], got["tokens"]):
                faults.append(f"16d-{label} rank {o['rank']}: tokens differ "
                              "from rank 0's")
            try:
                lm_mesh_rank_line(f"16d-{label}", o, card,
                                  want=b4_per_generate(cfg, new))
            except SystemExit as e:
                faults.append(str(e))
            add(label, cfg, o["launches"], o["launches_cross"])
        say(f"mesh 16d-{label} ({cfg.name} at full width, {cfg.n_layers} of "
            f"{family_cfg(arch, None).n_layers} layers, on "
            f"{mesh[0]} x {mesh[1]}, 4 ranks on one card over gloo, route "
            f"{route}, {dtype}): the steps' logits "
            f"{max(errs, default=0.0):.4f} at most from the one-device "
            f"run's (limit {atol:.4f}, lm_atol"
            + (f" at {MESH_FAMILY_ULPS.get(cfg.family, LM_ULPS)} ulps"
               if dtype == "bfloat16" else "") + "), tokens "
            f"equal for {first} of {new} steps (they may part only below "
            "the top-2 margin limit)")
    if faults:
        fail("; ".join(faults))
    say(f"phase 16d: {time.perf_counter() - t_phase:.1f} s wall; {card}")
    return launches


def moe_plain(torch, p, x, ids):
    """One MoE layer's routed output without capacity, written plainly
    for 16b's check and sharing no code with ``models/moe.py``: x [T, d]
    in the model's dtype, ``ids`` [T, k] the experts each token uses.
    Gate weights are the router's softmax (the router rounded to x's
    dtype, the products summed in f32) at ``ids``, renormalised; each
    expert's SwiGLU runs on its tokens in x's dtype, and the weighted
    outputs are summed in f32: [T, d] f32 (before the shared expert)."""
    probs = torch.softmax(x.float() @ p["router"].to(x.dtype).float(), -1)
    gate = probs.gather(1, ids)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in ids.unique().tolist():
        t, j = (ids == e).nonzero(as_tuple=True)
        xe = x[t]
        h = torch.nn.functional.silu(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])
        y.index_add_(0, t, (h @ p["w_down"][e]).float()
                     * gate[t, j][:, None])
    return y


def mesh_served(mesh, backend, logits, arch=MESH_LM_ARCH, new=MESH_LM_NEW,
                layers=None):
    """``repro_torch.launch.serve.main`` on a world that is up: ``arch``
    at full size (16a: MESH_LM_ARCH), LM_BATCH prompts of LM_PROMPT from
    seed SEED, ``new`` greedy tokens, on a ``mesh`` ("D,M") over
    ``backend`` (``mesh`` None: one device, no world), ``layers`` deep
    (None: all); each step's logits (whole, gathered) are appended to
    ``logits``. Returns the launcher's ``ServeRun``."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serve import step

    def generate(*args, **kw):
        return step.generate(*args, logits=logits, **kw)
    serve_launcher.generate = generate
    on = [] if mesh is None else ["--mesh", mesh, "--dist-backend", backend]
    if layers is not None:
        on += ["--layers", str(layers)]
    try:
        return serve_launcher.main([
            "--arch", arch, *on, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--max-new", str(new), "--seed", str(SEED)])
    finally:
        serve_launcher.generate = step.generate


def lm_mesh_ranks(mp, job, shape, rank_fn=None, world=None, root=MESH_ROOT):
    """Run ``rank_fn`` (default ``lm_mesh_rank``) on the ranks of a
    ``shape`` mesh (or a world of ``world``), its files under ``root``;
    their results, by rank."""
    import pickle
    world = world or int(np.prod(shape))
    t0 = time.perf_counter()
    mp.start_processes(rank_fn or lm_mesh_rank,
                       args=(world, str(root), job, shape),
                       nprocs=world, join=True, start_method="spawn")
    say(f"mesh {job} ranks ran {time.perf_counter() - t0:.1f} s")
    outs = []
    for rank in range(world):
        with open(root / f"{job}{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def lm_mesh_rank_line(label, o, card, want=None) -> int:
    """Print one rank's numbers; check its B4 launches (``want`` of them,
    or, where None, some) and its site checks. Returns its B4
    launches."""
    if (o["launches"] <= 0) if want is None else (o["launches"] != want):
        fail(f"mesh {label} rank {o['rank']}: B4 launched {o['launches']} "
             f"times, want {'some' if want is None else want}")
    for name in ("site", "cross"):
        if not o.get(f"{name}_ok", True):
            fail(f"mesh {label} rank {o['rank']}: B4 on the rank's own q, k, "
                 f"v at its first {name} differs from its plain version "
                 f"({o[name + '_err']})")
    c = o["collectives"]
    sites = "".join(
        f", B4 on the rank's first {'cross ' if n == 'cross' else ''}site "
        f"{o[n + '_shape']} vs plain max_abs_err {o[n + '_err']:.3e} "
        f"(row-scaled {o[n + '_row']:.3e})"
        for n in ("site", "cross") if n + "_err" in o)
    say(f"mesh {label} rank {o['rank']} (data {o['coord'][0]}, model "
        f"{o['coord'][1]}): {o['param_gb']:.2f} GB of weight blocks drawn in "
        f"{o['init_s']:.1f} s; prefill {o['prefill_ms']:.1f} ms, decode "
        f"{o['decode_ms']:.1f} ms a step; collectives: prefill "
        f"{c['prefill_ms']:.1f} ms ({c['prefill_ms'] / o['prefill_ms']:.2f} "
        f"of it), {c['prefill_bytes'] / 1e9:.3f} GB in "
        f"{c['prefill_calls']} calls, decode {c['decode_ms']:.1f} ms "
        f"({c['decode_ms'] / o['decode_ms']:.2f}), "
        f"{c['decode_bytes'] / 1e9:.3f} GB a step; B4 launches "
        f"{o['launches']} ({o['launches_cross']} at Sk != S){sites}"
        + (f"; first MoE block vs dispatch_simulated {o['moe_err']:.3e}, "
           f"prefill drops at cf 1.25 {o['drops']}; at cf {NO_DROP_CF} the "
           f"first MoE block vs moe_plain {o['plain_err']:.3e} and the "
           f"logits {o['no_drop_err']:.4f} from one device with its "
           f"routing replayed (the mesh's own router picks another set of "
           f"experts for {o['flips']} of the "
           f"{LM_BATCH * LM_PROMPT * MESH_MOE_LAYERS} token-layers, at routing "
           f"margins up to {o['flip_margin']:.4f})"
           if "moe_err" in o else "") + f"; {card}")
    return o["launches"]


def lm_mesh_rank(rank, world, root, job, shape):
    """One rank of phase 16a (``job`` "dense") or 16b ("moe"): a process
    of its own on the card, in a gloo world through a FileStore under
    ``root``, with LOCAL_RANK set as ``torch.distributed.run`` sets it.
    16a serves through ``launch.serve.main --mesh`` (``mesh_served``);
    16b draws its weight blocks born sharded (one rank at a time) and
    serves through ``step.generate``. Either way MESH_LM_NEW greedy
    tokens, with B4's count set to 0 before and read after, the
    collectives counted (``compat.stats``, split at the prefill's end),
    and B4 on the first site's own q, k, v against the plain version.
    16b also keeps its first MoE block's input and output and runs a
    prefill at NO_DROP_CF with one device's routing replayed, keeping
    that pass's first MoE block and the largest routing margin at which
    its own router chose another expert set. Pickles what it found to
    ``root/<job><rank>.pkl``."""
    import dataclasses
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import compat
    from repro_torch.distributed.meshctx import MeshCtx
    from repro_torch.models import model as M, moe
    from repro_torch.serve import step

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(2)
    root = Path(root)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / f"gloo-{job}"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        cfg = get_config(MESH_LM_ARCH if job == "dense" else MOE_ARCH)
        B, S, new = LM_BATCH, LM_PROMPT, MESH_LM_NEW
        out = {"rank": rank}
        steps = []
        if job == "moe":
            cfg = dataclasses.replace(cfg, n_layers=MESH_MOE_LAYERS)
            ctx = MeshCtx(init_device_mesh("cpu", shape,
                                           mesh_dim_names=("data", "model")),
                          device="cuda:0")
            params, init_s = drawn_in_turn(torch, cfg, ctx, rank, world)
            prompt = np.random.default_rng(SEED).integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)

            def serve():
                stats = {"init_s": init_s}
                toks = step.generate(params, cfg, prompt, max_new=new,
                                     max_len=S + new, ctx=ctx, stats=stats,
                                     logits=steps)
                return toks, stats
        else:
            def serve():
                run = mesh_served(",".join(map(str, shape)), "gloo", steps,
                                  layers=MESH_LM_LAYERS)
                return run.tokens, run.stats, run.ctx, run.params

        # the main path: B4 counted, the collectives measured
        served, counts, sites, total, record = rank_counted(
            torch, serve, record_moe=job == "moe")
        out.update(counts)
        toks, stats = served[:2]
        if job == "dense":
            ctx, params = served[2:]
        out["coord"] = (ctx.coord("data"), ctx.coord("model"))
        rank_report(out, stats, total, params, steps, new,
                    f"{job} rank {rank}")
        out["tokens"] = toks.cpu().numpy()
        if rank == 0:
            out["steps"] = torch.stack(steps).float().cpu().numpy()
        del steps
        # B4 on the first site's own q, k, v against its plain version
        out.update(site_held(torch, sites["first"]))
        del sites

        if job == "moe":
            first = record[0]
            if rank == 0:
                torch.save(first["x"].cpu(), root / "moe_x.pt")
            torch.save(first["y"].cpu(), root / f"moe_y{rank}.pt")
            out["drops"] = sum(r["dropped"]
                               for r in record[:MESH_MOE_LAYERS])
            del record, first
            out.update(a2a_prefill(torch, params, cfg, prompt, ctx, rank,
                                   root))
            nd_cfg = dataclasses.replace(cfg, capacity_factor=NO_DROP_CF)
            moe.moe_apply.record = []
            moe.moe_apply.replay = torch.load(root / "moe_routing.pt")
            try:
                batch = {"tokens": torch.as_tensor(prompt, device=ctx.device)}
                logits, _, _ = M.apply_prefill(params, nd_cfg, batch,
                                               last_only=True, ctx=ctx)
                rec = moe.moe_apply.record
            finally:
                moe.moe_apply.record = moe.moe_apply.replay = None
            if rank == 0:
                torch.save(rec[0]["x"].cpu(), root / "moe_nd_x.pt")
            torch.save(rec[0]["y"].cpu(), root / f"moe_nd_y{rank}.pt")
            flipped = [(r["own_id"].sort(-1).values
                        != r["expert_id"].sort(-1).values).any(-1)
                       for r in rec]
            margin = max((float(r["margin"][f].max()) if bool(f.any())
                          else 0.0) for r, f in zip(rec, flipped))
            counts = compat.all_reduce_axis(torch.tensor([
                sum(r["dropped"] for r in rec),
                sum(int(f.sum()) for f in flipped)]), ctx, ctx.tp_axis)
            out["flip_margin"] = float(compat.all_reduce_axis(
                torch.tensor([margin]), ctx, ctx.tp_axis, op="max")[0])
            nd_drops, out["flips"] = int(counts[0]), int(counts[1])
            if nd_drops:
                fail(f"mesh moe rank {rank}: {nd_drops} assignments dropped "
                     f"at capacity factor {NO_DROP_CF}")
            out["no_drop"] = compat.all_gather_axis(
                logits, ctx, ctx.tp_axis, dim=-1).float().cpu().numpy()
    finally:
        dist.destroy_process_group()
    with open(root / f"{job}{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def a2a_first_held(torch, moe, perfcfg, layer0, x, cfg, dev):
    """18c's gate: each rank's first MoE block under ``a2a_int8`` (its
    rows of it: the ``a2aint8`` variant keeps the residual as the rank's
    rows) against ``moe.dispatch_simulated`` under the flag on 16b's
    whole input ``x``, whose rows the rank's input must equal bit for
    bit: within two bf16 ulps of its max, 16b's limit for the flag off.
    Returns (the largest error, the limit)."""
    M = MESH_MOE_SHAPE[1]
    perfcfg.set_flags(a2a_int8=True)
    try:
        y_sim, _ = moe.dispatch_simulated(layer0, x, cfg, dp=1, M=M)
    finally:
        perfcfg.reset()
    tol = 2 * 2.0 ** (np.floor(np.log2(float(y_sim.float().abs().max()))) - 7)
    n = x.shape[1] // M
    err = 0.0
    for r in range(M):
        x_r, y_r = torch.load(MESH_ROOT / f"moe_a2a{r}.pt")
        rows = slice(r * n, (r + 1) * n)
        if not torch.equal(x_r.to(dev), x[:, rows]):
            fail(f"18c rank {r}: the first MoE block's input rows differ "
                 "from 16b's")
        err = max(err, float((y_r.to(dev).float()
                              - y_sim[:, rows].float()).abs().max()))
    if err > tol:
        fail(f"18c: the first MoE block under a2a_int8 {err} from "
             f"dispatch_simulated's (limit {tol}, two bf16 ulps of its max)")
    return err, tol


def a2a_prefill(torch, params, cfg, prompt, ctx, rank, root):
    """Phase 18c on a rank of 16b's world: prefills of 16b's prompt on
    its weights under the reference's ``a2aint8`` variant (``a2a_int8``
    with ``sp_residual``), the MoE's rows quantized to int8 on the wire:
    with the router's own choices (``"own"``; its first MoE block's
    input and output rows saved to ``root/moe_a2a<rank>.pt``), and at
    NO_DROP_CF with one device's routing replayed (``"replayed"``, as
    16b's no-drop pass runs). The last position's logits gathered whole
    (rank 0 keeps them), the quantizations a rank made, the seconds it
    took."""
    from repro_torch.distributed import compat
    from repro_torch.models import model as M, moe, perfcfg
    t0 = time.perf_counter()
    made = []
    quantize = moe.quantize_rows

    def counted(t):
        made.append(tuple(t.shape))
        return quantize(t)
    runs = {"own": (cfg, None),
            "replayed": (dataclasses.replace(cfg, capacity_factor=NO_DROP_CF),
                         root / "moe_routing.pt")}
    out = {}
    perfcfg.set_variant("a2aint8")
    moe.quantize_rows = counted
    try:
        for name, (run_cfg, routing) in runs.items():
            moe.moe_apply.replay = None if routing is None \
                else torch.load(routing)
            moe.moe_apply.record = [] if routing is None else None
            with torch.no_grad():
                logits, _, _ = M.apply_prefill(
                    params, run_cfg, {"tokens": torch.as_tensor(
                        prompt, device=ctx.device)}, last_only=True,
                    ctx=ctx)
                logits = compat.all_gather_axis(logits, ctx, ctx.tp_axis,
                                                dim=-1)
            if rank == 0:
                out[f"a2a_{name}"] = logits.float().cpu().numpy()
            if routing is None:     # the first MoE block's rows, in and out
                first = moe.moe_apply.record[0]
                torch.save((first["x"].cpu(), first["y"].cpu()),
                           root / f"moe_a2a{rank}.pt")
                del first
        torch.cuda.synchronize()
    finally:
        perfcfg.reset()
        moe.quantize_rows = quantize
        moe.moe_apply.replay = moe.moe_apply.record = None
    out.update(a2a_s=time.perf_counter() - t0, a2a_quantized=len(made))
    return out


def drawn_in_turn(torch, cfg, ctx, rank, world):
    """(this rank's weight blocks born sharded, ``sharding.sharded_init``
    from seed SEED, and the seconds its draw took), one rank drawing at a
    time: a draw holds a whole leaf in f32 and its cast (4.8 GB for
    qwen3-moe's experts) besides the blocks."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    for r in range(world):
        dist.barrier()
        if r == rank:
            t0 = time.perf_counter()
            params = sharding.sharded_init(cfg, ctx, seed=SEED)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
    dist.barrier()
    return params, init_s


def rank_counted(torch, serve, record_moe=False):
    """``serve()``, one rank's run of the main path, with B4's counts set
    to 0 just before it and read just after, the collectives counted
    (``compat.stats``) and B4's first call and first call at Sk != S
    kept (q, k, v and the keywords). Returns (what ``serve`` returns,
    {"launches", "launches_cross"}, the kept calls by "first" and
    "cross", the collectives' totals, the MoE record or None)."""
    from repro_torch.distributed import compat
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, moe
    sites = {}
    kernel = layers.flash_attention_gqa

    def kept(q, k, v, **kw):
        cross = k.shape[1] != q.shape[1]
        for name, hit in (("first", True), ("cross", cross)):
            if hit and name not in sites:
                sites[name] = (q.clone(), k.clone(), v.clone(), kw)
        return kernel(q, k, v, **kw)
    fa.flash_attention_gqa.launches = 0
    fa.flash_attention_gqa.launches_cross = 0
    compat.stats = {}
    layers.flash_attention_gqa = kept
    moe.moe_apply.record = [] if record_moe else None
    try:
        served = serve()
        torch.cuda.synchronize()
        counts = {"launches": fa.flash_attention_gqa.launches,
                  "launches_cross": fa.flash_attention_gqa.launches_cross}
        record, total = moe.moe_apply.record, dict(compat.stats)
    finally:
        layers.flash_attention_gqa = kernel
        moe.moe_apply.record = compat.stats = None
    return served, counts, sites, total, record


def rank_report(out, stats, total, params, steps, new, label):
    """One rank's numbers of a counted run into ``out``: the draw's
    seconds and the weight blocks' GB, prefill ms and decode ms a step,
    the collectives' ms, bytes and calls in the prefill and a decode
    step; every one of the ``new`` steps' logits kept and finite."""
    pre = stats["collectives_prefill"]
    out["init_s"] = stats["init_s"]
    out["param_gb"] = sum(t.numel() * t.element_size()
                          for t in _leaves(params)) / 1e9
    out["prefill_ms"] = stats["prefill_s"] * 1e3
    out["decode_ms"] = stats["decode_s"] * 1e3 / (new - 1)
    out["collectives"] = {
        "prefill_ms": pre["seconds"] * 1e3,
        "prefill_bytes": pre["bytes"], "prefill_calls": pre["calls"],
        "decode_ms": (total["seconds"] - pre["seconds"]) * 1e3 / (new - 1),
        "decode_bytes": (total["bytes"] - pre["bytes"]) / (new - 1)}
    if len(steps) != new:
        fail(f"mesh {label}: {len(steps)} steps' logits kept")
    if not all(bool(s.isfinite().all()) for s in steps):
        fail(f"mesh {label}: non-finite logits")


def site_held(torch, site, name="site"):
    """B4 on a kept call's own q, k, v (``rank_counted``) against its
    plain version: ``<name>_err``, ``_row`` (row-scaled), ``_ok`` (phase
    8's limits for q's dtype) and ``_shape``."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, kw = site
    got = fa.flash_attention_gqa(q, k, v, **kw)
    want = fa.flash_attention_gqa_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    row = row_scaled_err(got, want)
    tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                             atol=tol)) and row <= ATTN_ROW_TOL
    return {f"{name}_err": err, f"{name}_row": row, f"{name}_ok": ok,
            f"{name}_shape": (tuple(q.shape), tuple(k.shape))}


def family_cfg(arch, layers, dtype="bfloat16"):
    """16d's config of ``arch``: full width, ``layers`` deep (None: all),
    in ``dtype``."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                               dtype=dtype)


def family_served(torch, cfg, route, params, ctx, dev, steps):
    """One 16d run of MESH_FAMILY_NEW greedy tokens on LM_BATCH prompts of
    LM_PROMPT from seed SEED (``ctx`` None: one device): ``"generate"``
    through ``step.generate`` (the VLM with seeded bf16 image embeddings,
    as phase 9e draws them); ``"embeds"`` through ``make_prefill`` and
    ``make_decode_step`` on seeded frame embeddings, as ``embeds_served``
    draws them (a step's token is its argmax; the frames feed the next
    step). Each step's whole logits are appended to ``steps``. Returns
    (tokens [B, new], stats as ``generate``'s)."""
    from repro_torch.distributed import compat
    from repro_torch.serve import step
    B, S, new = LM_BATCH, LM_PROMPT, MESH_FAMILY_NEW
    dt = getattr(torch, cfg.dtype)
    stats = {}
    if route == "generate":
        kw = {}
        if cfg.family == "vlm":
            gen = torch.Generator(device=dev).manual_seed(SEED + 3)
            kw["image_embeds"] = (torch.randn(
                (B, cfg.n_image_tokens, cfg.d_model), generator=gen,
                device=dev) * 0.02).to(dt)
        prompt = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        toks = step.generate(params, cfg, prompt, max_new=new,
                             max_len=S + new, device=dev, ctx=ctx,
                             stats=stats, logits=steps, **kw)
        return toks, stats
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    frames = (torch.randn((B, S + new, cfg.d_model), generator=gen,
                          device=dev) * 0.02).to(dt)
    prefill = step.make_prefill(cfg, ctx)
    decode = step.make_decode_step(cfg, ctx)

    def whole(lg):
        if ctx is None:
            return lg
        lg = compat.all_gather_axis(lg, ctx, ctx.tp_axis, dim=-1)
        for axis in reversed(ctx.dp_axes):
            lg = compat.all_gather_axis(lg, ctx, axis, dim=0)
        return lg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, kv = prefill(params, {"embeds": frames[:, :S]})
    cache = step.decode_cache(cfg, kv, B, S, S + new, dev, ctx=ctx)
    del kv
    steps.append(whole(lg))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if compat.stats is not None:
        stats["collectives_prefill"] = dict(compat.stats)
    for i in range(1, new):
        lg, cache = decode(params, {"embeds": frames[:, S + i - 1:S + i]},
                           cache, S + i - 1)
        steps.append(whole(lg))
    torch.cuda.synchronize()
    stats["prefill_s"], stats["decode_s"] = t1 - t0, time.perf_counter() - t1
    return torch.cat([torch.argmax(t, dim=-1) for t in steps], dim=1), stats


def lm_family_rank(rank, world, root, job, shape):
    """One rank of phase 16d: a process of its own on the card, in a gloo
    world of four through a FileStore under ``root``, LOCAL_RANK set. It
    builds a DeviceMesh for each mesh shape of MESH_FAMILY_RUNS over the
    same world and serves each run in turn (``job`` and ``shape`` are
    ``lm_mesh_ranks``' and unused): "launcher" through
    ``launch.serve.main --mesh`` (``mesh_served``), which draws its
    blocks; the others from blocks born sharded one rank at a time
    (``drawn_in_turn``) through ``family_served``. Each run is counted
    (``rank_counted``), its numbers kept (``rank_report``) and B4 held
    on the run's first site and first cross site (Sk != S). Pickles {run
    label: what it found} to ``root/families<rank>.pkl``."""
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.distributed.meshctx import MeshCtx

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(2)
    root = Path(root)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / "gloo-families"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    outs = {}
    try:
        ctxs = {m: MeshCtx(init_device_mesh(
            "cpu", m, mesh_dim_names=("data", "model")), device="cuda:0")
            for m in dict.fromkeys(run[2] for run in MESH_FAMILY_RUNS)}
        for label, arch, mesh, layers, route, dtype in MESH_FAMILY_RUNS:
            cfg, ctx = family_cfg(arch, layers, dtype), ctxs[mesh]
            steps = []
            if route == "launcher":
                def serve():
                    run = mesh_served(",".join(map(str, mesh)), "gloo", steps,
                                      arch=arch, new=MESH_FAMILY_NEW,
                                      layers=layers)
                    return run.tokens, run.stats, run.params
            else:
                params, init_s = drawn_in_turn(torch, cfg, ctx, rank, world)

                def serve():
                    toks, stats = family_served(torch, cfg, route, params,
                                                ctx, ctx.device, steps)
                    stats["init_s"] = init_s
                    return toks, stats, params
            served, counts, sites, total, _ = rank_counted(torch, serve)
            toks, stats, params = served
            out = {"rank": rank, "coord": (ctx.coord("data"),
                                           ctx.coord("model")), **counts}
            rank_report(out, stats, total, params, steps, MESH_FAMILY_NEW,
                        f"16d-{label} rank {rank}")
            out["tokens"] = toks.cpu().numpy()
            if rank == 0:
                out["steps"] = torch.stack(steps).float().cpu().numpy()
            if "first" in sites:
                out.update(site_held(torch, sites["first"]))
            if "cross" in sites:
                out.update(site_held(torch, sites["cross"], "cross"))
            del served, params, steps, sites, toks
            torch.cuda.empty_cache()
            outs[label] = out
    finally:
        dist.destroy_process_group()
    with open(root / f"families{rank}.pkl", "wb") as f:
        pickle.dump(outs, f)


def leaf_sums(trainer):
    """Each param leaf's f64 sum, in ``flatten``'s order."""
    from repro_torch.train import optimizer as opt
    return [float(p.detach().double().sum()) for _, p in
            opt.flatten(trainer.params)]


def train_argv(layers, steps, every, ckpt_dir, *flags, arch=TRAIN_ARCH,
               batch=TRAIN_BATCH):
    """``launch.train.main``'s arguments for ``arch`` at full width,
    ``layers`` deep (None: all), ``batch`` x TRAIN_SEQ."""
    return ["--arch", arch, *(["--layers", str(layers)] if layers else []),
            "--steps", str(steps), "--seq-len", str(TRAIN_SEQ), "--batch",
            str(batch), "--ckpt-every", str(every), "--ckpt-dir",
            str(ckpt_dir), *flags]


def family_train_b4(arch, layers, flags, steps):
    """(B4's launches a rank in ``steps`` steps of a 17d run, those at
    Sk != S, the launches by instance): two a layer a step (the forward
    and the remat recompute), the VLM's cross layers too; once a site a
    step for zamba2's shared block, which is not rematerialized; none for
    rwkv6. A bf16 model runs the wgmma instance but at the VLM's cross
    layers: ``SyntheticLMData``'s image embeddings are f32, as the
    reference's, and the image k and v promote to f32 as its jnp ``@``
    does, so the cross attention is f32, on the simt instance."""
    from repro_torch.models import hybrid, transformer
    cfg = family_cfg(arch, layers, family_dtype(flags))
    design = "wgmma" if cfg.dtype == "bfloat16" else "simt"
    if cfg.family == "ssm":
        return 0, 0, {}
    if cfg.family == "hybrid":
        n = hybrid.n_attn_sites(cfg) * steps
        return n, 0, {design: n}
    cross = 2 * transformer.n_superblocks(cfg) * steps
    n = 2 * len(transformer.layer_kinds(cfg)) * steps
    by = {design: n}
    if cross:
        by["simt"] = by.get("simt", 0) + cross
    return n + cross, cross, by


def family_dtype(flags):
    """A 17d run's dtype: the configs' bf16, or ``--dtype``'s."""
    flags = list(flags)
    return flags[flags.index("--dtype") + 1] if "--dtype" in flags \
        else "bfloat16"


def mesh_train_phase(torch, dev, card, c13):
    """Phase 17: training on a mesh. 17c: a world of one rank over NCCL,
    qwen3-4b at full width and depth through ``launch.train.main --mesh
    1,1``: its losses, grad norms and final params' f64 leaf sums bit for
    bit 13c's. 17a: qwen3-4b at MESH_TRAIN_LAYERS layers, one device
    first, then four ranks of a 2 x 2 mesh on this card over gloo
    (``mesh_train_rank``), each step's loss and grad norm within
    MESH_TRAIN_RTOL of one device's, B4 2 x layers x steps times on each
    rank (wgmma, with the lse), its first site against the plain version,
    the
    optimizer-state blocks as ``opt_state_specs`` lays them out, and the
    checkpoint saved after its last step restored on one device, whose
    next step meets the same limits against one device's straight run.
    17b: COMP_TRAIN_LAYERS layers on (pod, data, model) =
    COMP_TRAIN_SHAPE with ``--grad-compression``: each step's compressed
    mean within the quantization bound of the exact f32 pod mean, the
    error feedback g + err - dequant(quant(g + err)). 17d: the runs of
    FAMILY_TRAIN_RUNS, each on one device first (``family_train_one``),
    then on the ranks, held to one device's (``family_train_checked``).
    17a, 17b and 17d run in one spawn of four ranks. Returns (B4's
    launches by the kernels line's row, of 17c for 13c's row and of
    zamba2's and musicgen's ranks for the G = 1 training row; the rows of
    B4 with its lse at a rank's shape, with 17a's, 17b's and the VLM's
    self layers' launches, and at the VLM's cross shape on a rank)."""
    import datetime
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import PrefetchingLoader
    from repro_torch.kernels import _build, flash_attention as fa
    from repro_torch.launch import train as train_launcher

    t_phase = time.perf_counter()
    shutil.rmtree(MESH_TRAIN_ROOT, ignore_errors=True)
    MESH_TRAIN_ROOT.mkdir(parents=True)
    launches = {}

    # -- 17c: 1 x 1 over NCCL, bit for bit 13c --------------------------------
    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(MESH_TRAIN_ROOT / "nccl"), 1),
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S), device_id=dev)
    try:
        trainer, _, counts, by, with_lse, _ = train_run(
            torch, dev, TRAIN_ARCH, ("--mesh", "1,1", "--dist-backend",
                                     "nccl"))
        hist = [(r["loss"], r["grad_norm"]) for r in trainer.history]
        sums = leaf_sums(trainer)
        shape = tuple(trainer.ctx.shape.values())
        del trainer
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    want = 2 * get_config(TRAIN_ARCH).n_layers * TRAIN_STEPS
    if not (counts["flash_attention"] == by["wgmma"] == with_lse == want):
        fail(f"mesh 17c: B4 launched {counts['flash_attention']} times "
             f"({by['wgmma']} wgmma, {with_lse} with lse), want {want}")
    if shape != (1, 1):
        fail(f"mesh 17c: the launcher's mesh is {shape}")
    if hist != c13["history"] or sums != c13["sums"]:
        fail(f"mesh 17c: losses and grad norms {hist} (13c: "
             f"{c13['history']}), or the final params' leaf sums, differ "
             "from 13c's bits")
    launches["flash_attention_train"] = counts["flash_attention"]
    say(f"mesh 17c (1 x 1, one rank over NCCL, through launch.train.main "
        f"--mesh 1,1, {TRAIN_ARCH} at full size, {TRAIN_STEPS} steps): "
        f"losses and grad norms {hist} and the {len(sums)} leaves' f64 "
        f"sums bit for bit 13c's; B4 launches {want}; "
        f"{time.perf_counter() - t0:.1f} s; {card}")

    # -- 17a: one device, MESH_TRAIN_STEPS steps and one more -------------
    t0 = time.perf_counter()
    one = train_launcher.main(train_argv(
        MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, 100, MESH_TRAIN_ROOT / "one"))
    # one step past the launcher's run, on the same schedule: the step a
    # restored checkpoint of the mesh takes next
    one.loader = PrefetchingLoader(one.data, one.device)
    one.loader.seek(MESH_TRAIN_STEPS)
    one.start_step = MESH_TRAIN_STEPS
    one.run(1)
    one.close()
    one_hist = [(r["loss"], r["grad_norm"], r["seconds"])
                for r in one.history]
    del one
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t0
    fam_one = family_train_one(torch)

    # -- 17a, 17b and 17d: one spawn of four ranks, in turn ------------------
    _build.build(["flash_attention"])          # the ranks load, never build
    outs = lm_mesh_ranks(mp, "17", MESH_TRAIN_SHAPE, mesh_train_rank,
                         root=MESH_TRAIN_ROOT)
    per = 2 * MESH_TRAIN_LAYERS * MESH_TRAIN_STEPS
    gap = 0.0                       # the largest relative gap read
    for o in (o["17a"] for o in outs):
        mesh_train_rank_line("17a", o, card, per)
        for step, (r, (l1, g1, _)) in enumerate(zip(o["history"], one_hist)):
            for name, got, ref in (("loss", r["loss"], l1),
                                   ("grad norm", r["grad_norm"], g1)):
                gap = max(gap, abs(got - ref) / abs(ref))
                if abs(got - ref) > MESH_TRAIN_RTOL * abs(ref):
                    fail(f"mesh 17a rank {o['rank']} step {step}: {name} "
                         f"{got} against one device's {ref} (limit "
                         f"{MESH_TRAIN_RTOL} relative)")
        if [r["loss"] for r in o["history"]] != \
                [r["loss"] for r in outs[0]["17a"]["history"]]:
            fail(f"mesh 17a rank {o['rank']}: losses differ from rank 0's")
    # the mesh's checkpoint after its last step, restored on one device:
    # its next step against the one-device run's
    t1 = time.perf_counter()
    restored = train_launcher.main(train_argv(
        MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, 100, MESH_TRAIN_ROOT / "17a"))
    got, (l1, g1, _) = restored.history[0], one_hist[MESH_TRAIN_STEPS]
    if restored.start_step != MESH_TRAIN_STEPS or \
            got["step"] != MESH_TRAIN_STEPS:
        fail(f"mesh 17a: the one-device restore resumed at "
             f"{restored.start_step}, want {MESH_TRAIN_STEPS}")
    restored_gap = 0.0
    for name, ref in (("loss", l1), ("grad_norm", g1)):
        restored_gap = max(restored_gap, abs(got[name] - ref) / abs(ref))
        if abs(got[name] - ref) > MESH_TRAIN_RTOL * abs(ref):
            fail(f"mesh 17a: the restored step's {name} {got[name]} against "
                 f"one device's {ref}")
    del restored
    torch.cuda.empty_cache()
    PHASE18["17a"] = [{k: o["17a"][k] for k in ("rank", "coord", "steps",
                                                 "param_bytes", "peak_gb")}
                       for o in outs]
    PHASE18["18b"] = [o["18b"] for o in outs]
    h = outs[0]["17a"]["history"]
    say(f"mesh 17a ({TRAIN_ARCH} at full width, {MESH_TRAIN_LAYERS} of 36 "
        f"layers, 2 x 2, 4 ranks on one card over gloo, born sharded from "
        f"seed {SEED}, f32 AdamW states, remat, {MESH_TRAIN_STEPS} steps): "
        f"losses {[round(r['loss'], 5) for r in h]} and grad norms "
        f"{[round(r['grad_norm'], 5) for r in h]} against one device's "
        f"{[(round(a, 5), round(b, 5)) for a, b, _ in one_hist]}, the "
        f"largest relative gap {gap:.3e} (limit {MESH_TRAIN_RTOL}: bf16 "
        "partials rounded before their f32 sums and GEMMs on other row "
        "counts, carried through the forward and backward); one device's "
        f"step ms {[round(s * 1e3, 1) for _, _, s in one_hist]} "
        f"({t_one:.1f} s with its draw); the mesh's checkpoint after step "
        f"{MESH_TRAIN_STEPS} restored on one device: step "
        f"{MESH_TRAIN_STEPS + 1} loss {got['loss']:.5f}, grad norm "
        f"{got['grad_norm']:.5f} against one device's {l1:.5f}, {g1:.5f}, "
        f"relative {restored_gap:.3e} (restore and step "
        f"{time.perf_counter() - t1:.1f} s); {card}")

    # -- 17b: the compressed pod reduction on COMP_TRAIN_SHAPE -----------
    per = 2 * COMP_TRAIN_LAYERS * COMP_TRAIN_STEPS
    for o in (o["17b"] for o in outs):
        mesh_train_rank_line("17b", o, card, per)
        if not o["compressed"]["ok"]:
            fail(f"mesh 17b rank {o['rank']}: {o['compressed']['why']}")
    checked = [o["17b"]["compressed"] for o in outs
               if o["17b"]["compressed"]["mean_err"] is not None]
    c = checked[0]
    say(f"mesh 17b ({TRAIN_ARCH} at full width, {COMP_TRAIN_LAYERS} of 36 "
        f"layers, (pod, data, model) = "
        f"{' x '.join(map(str, COMP_TRAIN_SHAPE))}, --grad-compression, "
        f"{COMP_TRAIN_STEPS} steps): every step's compressed mean within the "
        f"quantization bound of the exact f32 pod mean of g + err on pod "
        f"0's {len(checked)} ranks (largest |diff| / bound "
        f"{max(x['ratio'] for x in checked):.4f}, mean |diff| "
        f"{c['mean_err']:.3e}); the error feedback equal to g + err - "
        f"dequant(quant(g + err)) bit for bit on every rank; the pod "
        f"reduction's wire {c['wire_bytes'] / 1e9:.4f} GB a step a rank "
        f"against {c['f32_bytes'] / 1e9:.4f} GB in f32 "
        f"({c['f32_bytes'] / c['wire_bytes']:.2f}x fewer); {card}")
    launches["flash_attention_train_rank"] = sum(
        o[r]["launches"] for o in outs for r in ("17a", "17b"))
    site_err = max(o[r]["site_err"] for o in outs for r in ("17a", "17b"))

    # -- 17d: the four families against one device -----------------------
    fam_launches, fam_errs = family_train_checked(outs, fam_one, card)
    for name, n in fam_launches.items():
        launches[name] = launches.get(name, 0) + n
    site_err = max(site_err, fam_errs.get("flash_attention_train_rank", 0.0))

    # -- B4 with its lse at a rank's shape, and at the VLM's cross shape --
    cfg_h = (2, TRAIN_SEQ, 16, 4, 128)         # 32 / 2 q heads, 8 / 2 kv
    times = b4_lse_times(torch, dev, fa, *cfg_h)
    vlm = next(r for r in FAMILY_TRAIN_RUNS if r[1] == VLM_ARCH)
    vcfg = family_cfg(VLM_ARCH, vlm[3])
    ranks_ = vlm[2][1]
    # f32: the batch's image embeddings are, and k and v promote (above)
    cross_times = b4_lse_times(
        torch, dev, fa, vlm[4], TRAIN_SEQ, vcfg.n_heads // ranks_,
        vcfg.n_kv_heads // ranks_, vcfg.head_dim, Sk=vcfg.n_image_tokens,
        dtype=torch.float32)
    shutil.rmtree(MESH_TRAIN_ROOT, ignore_errors=True)
    say(f"phase 17: {time.perf_counter() - t_phase:.1f} s wall; {card}")
    rows = [b4_row("flash_attention_train_rank",
                   launches.pop("flash_attention_train_rank"), site_err,
                   times),
            b4_row("flash_attention_train_cross_rank",
                   launches.pop("flash_attention_train_cross_rank"),
                   fam_errs["flash_attention_train_cross_rank"],
                   cross_times)]
    return launches, rows


def family_train_one(torch):
    """17d on one device: each run of FAMILY_TRAIN_RUNS through
    ``launch.train.main`` without ``--mesh``, at the same depth, width
    and batch, the card freed after each. Returns {label: [(loss, grad
    norm) a step]}."""
    from repro_torch.launch import train as train_launcher
    one = {}
    for label, arch, mesh, layers, batch, steps, flags in FAMILY_TRAIN_RUNS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        t = train_launcher.main(train_argv(
            layers, steps, 100, MESH_TRAIN_ROOT / f"one-{label}", *flags,
            arch=arch, batch=batch))
        peak = torch.cuda.max_memory_allocated()
        one[label] = [(r["loss"], r["grad_norm"]) for r in t.history]
        steps_ms = [round(r["seconds"] * 1e3, 1) for r in t.history]
        say(f"mesh {label} one device ({arch}, {layers} layers, batch "
            f"{batch} x {TRAIN_SEQ}, {' '.join(flags) or 'f32 states'}): "
            f"losses and grad norms {one[label]}, step ms {steps_ms}, "
            f"{time.perf_counter() - t0:.1f} s with its draw, "
            f"max_memory_allocated {peak / 1e9:.2f} GB")
        del t
        gc.collect()
        torch.cuda.empty_cache()
    return one


def family_train_checked(outs, one, card):
    """17d's checks, each run reported before one fails: every rank's loss
    and grad norm at each step within FAMILY_TRAIN_RTOL (MESH_TRAIN_RTOL
    where it names none) of one device's, the ranks' losses equal, and
    per rank (``mesh_train_rank_line``) B4's launches (``family_train_b4``),
    its first sites against the plain version, the state blocks. Returns
    (B4's launches of the bf16 runs by the kernels line's row: zamba2's
    and musicgen's G = 1, the VLM's self layers at hd 128 and its cross
    layer at Sk != S; the largest site error by row)."""
    faults, launches, errs = [], {}, {}
    for label, arch, mesh, layers, batch, steps, flags in FAMILY_TRAIN_RUNS:
        want, cross, by = family_train_b4(arch, layers, flags, steps)
        limit = FAMILY_TRAIN_RTOL.get(label, MESH_TRAIN_RTOL)
        ranks_ = [o[label] for o in outs]
        gap = 0.0
        for o in ranks_:
            try:
                mesh_train_rank_line(label, o, card, want, cross, by)
            except SystemExit as e:
                faults.append(str(e))
            for step, (r, (l1, g1)) in enumerate(zip(o["history"],
                                                     one[label])):
                for name, got, ref in (("loss", r["loss"], l1),
                                       ("grad norm", r["grad_norm"], g1)):
                    gap = max(gap, abs(got - ref) / abs(ref))
                    if not abs(got - ref) <= limit * abs(ref):
                        faults.append(
                            f"mesh {label} rank {o['rank']} step {step}: "
                            f"{name} {got} against one device's {ref} "
                            f"(limit {limit} relative)")
            if [r["loss"] for r in o["history"]] != \
                    [r["loss"] for r in ranks_[0]["history"]]:
                faults.append(f"mesh {label} rank {o['rank']}: losses "
                              "differ from rank 0's")
        if family_dtype(flags) == "bfloat16":   # the main path's runs
            n = sum(o["launches"] for o in ranks_)
            n_cross = sum(o["launches_cross"] for o in ranks_)
            row = "flash_attention_train_g1" if arch in (
                ZAMBA_ARCH, MUSICGEN_ARCH) else "flash_attention_train_rank"
            for name, k, err in ((row, n - n_cross, "site_err"), (
                    "flash_attention_train_cross_rank", n_cross,
                    "cross_err")):
                launches[name] = launches.get(name, 0) + k
                errs[name] = max([errs.get(name, 0.0)]
                                 + [o[err] for o in ranks_ if err in o])
        h = ranks_[0]["history"]
        say(f"mesh {label} ({arch} at full width, {layers} layers, "
            f"{' x '.join(map(str, mesh))}, 4 ranks on one card over gloo, "
            f"batch {batch} x {TRAIN_SEQ}, {family_dtype(flags)}, "
            f"{'int8' if '--int8-opt' in flags else 'f32'} AdamW states, "
            f"remat, {steps} steps): losses "
            f"{[round(r['loss'], 5) for r in h]} and grad norms "
            f"{[round(r['grad_norm'], 5) for r in h]} against one device's "
            f"{[(round(a, 5), round(b, 5)) for a, b in one[label]]}, the "
            f"largest relative gap {gap:.3e} (limit {limit}); B4 {want} "
            f"launches a rank ({cross} at Sk != S); {card}")
    if faults:
        fail("; ".join(faults))
    launches.setdefault("flash_attention_train_cross_rank", 0)
    errs.setdefault("flash_attention_train_cross_rank", 0.0)
    return launches, errs


def mesh_train_rank_line(label, o, card, want, cross=0, by=None):
    """Print one rank's numbers; check its B4 launches (``want``, every
    one with the lse, ``cross`` of them at Sk != S, by instance ``by``:
    all wgmma where None), its first sites and its state blocks."""
    by = {"wgmma": want} if by is None else by
    got_by = {k: n for k, n in o["by"].items() if n}
    if not (o["launches"] == o["lse"] == want and got_by == {
            k: n for k, n in by.items() if n}
            and o["launches_cross"] == cross):
        fail(f"mesh {label} rank {o['rank']}: B4 launched {o['launches']} "
             f"times ({o['by']}, {o['lse']} with lse, "
             f"{o['launches_cross']} at Sk != S), want {want} ({by}, "
             f"{cross} at Sk != S)")
    if not o["shapes_ok"]:
        fail(f"mesh {label} rank {o['rank']}: optimizer-state blocks differ "
             "from opt_state_specs'")
    steps = o["steps"]
    parts = "; ".join(
        f"step {i}: {s['s'] * 1e3:.1f} ms, collectives {s['seconds'] * 1e3:.1f}"
        f" ms ({s['seconds'] / s['s']:.2f}), {s['bytes'] / 1e9:.3f} GB in "
        f"{s['calls']} calls ({s['backward_calls']} in the backward, "
        f"{s['backward_bytes'] / 1e9:.3f} GB in "
        f"{s['backward_seconds'] * 1e3:.1f} ms)" for i, s in enumerate(steps))
    sites = "".join(
        f", the rank's {what} site {o[name + '_shape']} vs plain max_abs_err "
        f"{o[name + '_err']:.3e}, lse {o[name + '_lse_err']:.3e}"
        for name, what in (("site", "first"), ("cross", "first Sk != S"))
        if name + "_err" in o)
    say(f"mesh {label} rank {o['rank']} ({o['coord']}): {o['param_gb']:.2f} "
        f"GB of weight blocks, max_memory_allocated {o['peak_gb']:.2f} GB; run {o['run_s']:.1f} s; {parts}; checkpoint "
        f"gathered in "
        f"{o.get('save_s', 0.0):.1f} s; B4 launches {o['launches']} "
        f"({got_by}, with the lse){sites}; state blocks as "
        f"opt_state_specs'; {card}")


def state_blocks_held(torch, trainer) -> bool:
    """Whether every optimizer-state block has the shape that
    ``opt_state_specs`` gives the whole state's leaf on this rank."""
    from repro_torch.distributed import sharding
    from repro_torch.train import optimizer as opt
    ctx, specs = trainer.ctx, trainer.specs
    meta = opt.tree_map(lambda p, s: torch.zeros(
        sharding.whole_shape(p.shape, s, ctx), device="meta"),
        trainer.params, specs)
    whole = opt.init_state(trainer.tc.opt, meta)
    wspecs = sharding.opt_state_specs(whole, specs, ctx)
    for key in ("m", "v"):
        for (_, w), (_, sp), (_, got) in zip(
                opt.flatten(whole[key]), opt.flatten(wspecs[key]),
                opt.flatten(trainer.opt_state[key])):
            pairs = [(w.q, sp.q, got.q), (w.scale, sp.scale, got.scale)] \
                if isinstance(w, opt.QTensor) else [(w, sp, got)]
            for wt, e, g in pairs:
                e = tuple(e) + (None,) * (wt.dim() - len(e))
                want = tuple(len(range(*ctx.block(n, a).indices(n)))
                             for n, a in zip(wt.shape, e))
                if tuple(g.shape) != want:
                    return False
    return True


def compressed_held(torch, trainer, record, steps):
    """17b: each step's compressed mean (``compression.
    compressed_mean_tree.record``: a leaf's g + err, its quantization and
    the f32 mean) within the quantization bound of the exact f32 mean of
    the pods' g + err (the pods' half-quanta summed over n, plus f32's
    rounding of the sum), checked on pod 0's ranks (the pods' blocks
    gathered there); the error feedback after the last step g + err -
    dequant(quant(g + err)) bit for bit on every rank; the wire bytes a
    step."""
    from repro_torch.distributed import compat
    from repro_torch.train import optimizer as opt
    ctx = trainer.ctx
    n = ctx.shape["pod"]
    leaves = len(opt.flatten(trainer.params))
    if len(record) != leaves * steps:
        return {"ok": False, "why": f"{len(record)} records for {leaves} "
                f"leaves x {steps} steps"}
    ratio, errs, wire, f32 = 0.0, [], 0, 0
    for gf, qt, mean in record:
        pods = compat.gather_first(gf[None], ctx, "pod", 0)
        scales = compat.gather_first(qt.scale[None], ctx, "pod", 0)
        wire += qt.q.numel() + qt.scale.numel() * 4
        f32 += gf.numel() * 4
        if pods is None:        # pod 0's ranks check their blocks
            continue
        exact = pods.to(gf.device).sum(0) / n
        half = sum(opt._quantum_floor(opt.QTensor(
            q=qt.q, scale=sc.to(gf.device), shape=qt.shape, last=qt.last))
            for sc in scales) / n
        diff = (mean - exact).abs()
        slack = 1e-6 * exact.abs() + 1e-30        # f32's sums
        if not bool((diff <= half + slack).all()):
            return {"ok": False, "why": "a compressed mean outside the "
                    "quantization bound"}
        ratio = max(ratio, float((diff / (half + slack)).max()))
        errs.append(float(diff.mean()))
    last = record[-leaves:]
    for (_, e), (gf, qt, _) in zip(opt.flatten(trainer.err), last):
        if not torch.equal(e, gf - opt.dequantize_block(qt)):
            return {"ok": False, "why": "the error feedback is not g + err "
                    "- dequant(quant(g + err))"}
    return {"ok": True, "ratio": ratio,
            "mean_err": float(np.mean(errs)) if errs else None,
            "wire_bytes": wire // steps, "f32_bytes": f32 // steps}


MESH_TRAIN_RUNS = (  # (label, arch, mesh, layers, steps, batch, flags)
    ("17a", TRAIN_ARCH, MESH_TRAIN_SHAPE, MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS,
     TRAIN_BATCH, ()),
    ("17b", TRAIN_ARCH, COMP_TRAIN_SHAPE, COMP_TRAIN_LAYERS, COMP_TRAIN_STEPS,
     TRAIN_BATCH, ("--grad-compression",)),
) + tuple((label, arch, mesh, layers, steps, batch, flags)
          for label, arch, mesh, layers, batch, steps, flags
          in FAMILY_TRAIN_RUNS)


def mesh_train_rank(rank, world, root, job, shape):
    """One rank of phase 17: a process of its own on the card, in a gloo
    world of four through a FileStore under ``root``, LOCAL_RANK set as
    ``torch.distributed.run`` sets it, training MESH_TRAIN_RUNS in turn
    through ``launch.train.main --mesh`` (``mesh_train_run``). Pickles
    what it found to ``root/<job><rank>.pkl``."""
    import datetime
    import pickle
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(2)
    root = Path(root)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(root / f"gloo-{job}"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    out = {"rank": rank}
    try:
        for label, *run in MESH_TRAIN_RUNS:
            out[label] = mesh_train_run(torch, rank, root, label, *run)
        out["18b"] = seq_mesh_run(torch, rank, root)
    finally:
        dist.destroy_process_group()
    with open(root / f"{job}{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def mesh_train_run(torch, rank, root, label, arch, mesh, layers, steps,
                   batch, flags):
    """One rank's phase-17 run of ``arch`` through ``launch.train.main
    --mesh``: B4's counts set to 0 before and read after, the collectives
    counted a step (``compat.stats``), the checkpoint's save timed (17a
    saves after its last step), B4's first site, and its first site at
    Sk != S, against its plain version with the lse, the state blocks
    against ``opt_state_specs``; with ``--grad-compression`` the
    compressed reduction (``compressed_held``)."""
    from repro_torch.distributed import compat, compression
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.train import loop

    comp = "--grad-compression" in flags
    argv = train_argv(layers, steps, steps if label == "17a" else 100,
                      root / label, "--mesh", ",".join(map(str, mesh)),
                      "--dist-backend", "gloo", *flags, arch=arch,
                      batch=batch)
    # each step's collectives, and the checkpoint's save, timed
    per_step, saves = [], []
    made, save = loop.make_train_step, loop.CheckpointManager.save_async
    keys = ("calls", "bytes", "seconds", "backward_calls", "backward_bytes",
            "backward_seconds")

    def counted_steps(*a, **kw):
        fn = made(*a, **kw)

        def step(*args):
            before = dict(compat.stats)
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            after = compat.stats
            per_step.append(dict(s=time.perf_counter() - t0, **{
                k: after.get(k, 0) - before.get(k, 0) for k in keys}))
            return out
        return step

    def timed_save(self, *a, **kw):
        t0 = time.perf_counter()
        save(self, *a, **kw)
        saves.append(time.perf_counter() - t0)
    loop.make_train_step = counted_steps
    loop.CheckpointManager.save_async = timed_save
    b4 = fa.flash_attention_gqa
    for name in b4.launches_by_design:
        b4.launches_by_design[name] = 0
    b4.launches_lse = 0
    compression.compressed_mean_tree.record = [] if comp else None
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    try:
        trainer, counts, sites, _, _ = rank_counted(
            torch, lambda: train_launcher.main(argv))
        peak = torch.cuda.max_memory_allocated()
        record = compression.compressed_mean_tree.record
        compression.compressed_mean_tree.record = None
        out = {"rank": rank, "run_s": time.perf_counter() - t_run,
               "coord": {a: trainer.ctx.coord(a) for a in trainer.ctx.shape},
               "history": trainer.history, "by": dict(b4.launches_by_design),
               "lse": b4.launches_lse, "steps": per_step,
               "save_s": sum(saves), "peak_gb": peak / 1e9,
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in _leaves(trainer.params)),
               **counts}
        out["param_gb"] = out["param_bytes"] / 1e9
        out["shapes_ok"] = state_blocks_held(torch, trainer)
        for name, what in (("site", "first"), ("cross", "cross")):
            if what not in sites:
                continue
            q, k, v, kw = sites.pop(what)
            kw = {key: val for key, val in kw.items() if key != "return_lse"}
            out[f"{name}_shape"] = (tuple(q.shape), tuple(k.shape))
            out[f"{name}_err"], out[f"{name}_lse_err"] = b4_lse_held(
                torch, fa, f"{label} rank {rank}'s {what} site", q, k, v,
                **kw)
            del q, k, v
        del sites
        if comp:
            out["compressed"] = compressed_held(torch, trainer, record, steps)
        del record, trainer
    finally:
        loop.make_train_step, loop.CheckpointManager.save_async = made, save
        compression.compressed_mean_tree.record = None
    gc.collect()                # the trainer's cycles, before the next run
    torch.cuda.empty_cache()
    return out


def seq_rank_cases(torch, dev, fa):
    """Phase 18a: B4 at a rank's sequence rows (``seq_shard_attn``): each
    of SEQ_RANKS ranks' block of qwen2-0.5b's query rows over the keys up
    to its last row, at ``q_offset`` r·S/SEQ_RANKS, in bf16 (wgmma) and
    f32 (simt), with and without the lse, equal bit for bit to the full
    causal call's rows and within phase 8's limits of the plain version;
    then gemma3's hd-256 windowed instance at an offset alike. Returns
    the largest error against the plain version."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(LM_ARCH)
    gem = get_config(GEMMA_ARCH)
    shapes = [(LM_BATCH, SEQ_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
               0, SEQ_RANKS, dt) for dt in (torch.bfloat16, torch.float32)]
    shapes.append((1, GEMMA_PROMPT, gem.n_heads, gem.n_kv_heads,
                   gem.head_dim, gem.sliding_window, 2, torch.bfloat16))
    err = 0.0
    for B, S, H, KV, hd, window, ranks, dtype in shapes:
        q, k, v = attention_inputs(torch, dev, B, S, H, KV, hd, dtype)
        full, full_lse = fa.flash_attention_gqa(q, k, v, window=window,
                                                return_lse=True)
        n = S // ranks
        for r in range(ranks):
            a, b = r * n, (r + 1) * n
            qr, kr, vr = q[:, a:b], k[:, :b], v[:, :b]
            before = fa.flash_attention_gqa.launches_offset
            out = fa.flash_attention_gqa(qr, kr, vr, window=window,
                                         q_offset=a)
            out_l, lse = fa.flash_attention_gqa(qr, kr, vr, window=window,
                                                q_offset=a, return_lse=True)
            torch.cuda.synchronize()
            if fa.flash_attention_gqa.launches_offset != before + 2 * (a > 0):
                fail(f"B4 seq rank {r}: offset launches not counted")
            if not (torch.equal(out, full[:, a:b]) and torch.equal(
                    out_l, full[:, a:b]) and torch.equal(
                        lse, full_lse[..., a:b])):
                fail(f"B4 seq rank {r} [{B}, {n}, {H}/{KV}, {hd}] "
                     f"{dtype} window {window}: its rows differ from the "
                     "full causal call's")
            name = (f"rank {r} of {ranks}, q_offset {a}"
                    + (f", window {window}" if window else ""))
            e, _ = b4_lse_held(torch, fa, name, qr, kr, vr, window=window,
                               q_offset=a)
            err = max(err, e)
        say(f"B4 ({fa.design(dtype, hd)}) at a rank's rows: [{B}, {S}, "
            f"{H}/{KV}, {hd}] {str(dtype).split('.')[-1]}"
            + (f" window {window}" if window else "") + f" over {ranks} "
            f"ranks of {n} rows: each rank's output and lse equal bit for "
            "bit to the full causal call's rows, with and without the lse")
        del q, k, v, full, full_lse
    return err


def seq_rank_times(torch, dev, fa):
    """Phase 18a: B4 at the last rank's rows of qwen2-0.5b's prefill
    (the most keys), bf16, beside its plain version, the bound
    (``fa.attention_flops``) and SDPA with the equivalent boolean mask
    (True: key <= q_offset + row)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(LM_ARCH)
    B, H, KV, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n = SEQ_S // SEQ_RANKS
    off = SEQ_S - n
    q, k, v = attention_inputs(torch, dev, B, SEQ_S, H, KV, hd,
                               torch.bfloat16)
    q = q[:, off:].contiguous()
    kern = lambda: fa.flash_attention_gqa(q, k, v, q_offset=off)  # noqa
    ms = graph_ms(torch, kern, 20)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_gqa_plain(
        q, k, v, q_offset=off), 3)
    mask = (torch.arange(SEQ_S, device=dev)[None, :]
            <= off + torch.arange(n, device=dev)[:, None])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = {"attn_mask": mask, "enable_gqa": True}
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
        qt, kt, vt, **kw)
    backend = sdpa_backend(torch, qt, kt, vt, is_causal=False, **kw)
    lib_ms = graph_ms(torch, lib, 20)
    lib_err = float((lib().transpose(1, 2).float() - kern().float())
                    .abs().max())
    flops = fa.attention_flops(B, n, SEQ_S, H, hd, q_offset=off)
    n_bytes = nbytes(q, k, v) + nbytes(q)
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    say(f"time flash_attention at a rank's rows (wgmma) [{B}, {n}, "
        f"{H}/{KV}, {hd}] over {SEQ_S} keys, q_offset {off}, bf16: "
        f"{ms:.4f} ms a launch in a CUDA graph (plain {plain_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}: {flops / 1e9:.3f} GFLOP, "
        f"{n_bytes / 1e6:.1f} MB; library scaled_dot_product_attention "
        f"({backend}, boolean mask) {lib_ms:.4f} ms, max |diff| "
        f"{lib_err:.3e}); kernel / bound {ms / b_ms:.1f}x")
    return {"design": "wgmma", "head_dim": hd, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def seq_mesh_run(torch, rank, root):
    """Phase 18b on one rank of phase 17's world: qwen2-0.5b at full
    width and SEQ_LAYERS layers on a SEQ_SHAPE mesh (its 14 q heads do
    not divide 4), born sharded from seed SEED. Served through
    ``step.generate`` (SEQ_NEW greedy tokens of LM_BATCH x SEQ_S) with
    the flags off, then with SEQ_FLAGS (``seq_shard_attn``: B4 at the
    rank's rows, a query offset; ``sp_residual``), and trained one step
    each way through ``launch.train.main --mesh``: B4's launches and
    its offset launches set to 0 before each run and read after, the
    collectives counted (``compat.stats``), the logits (rank 0), the
    losses and grad norms."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import compat, sharding
    from repro_torch.distributed.meshctx import MeshCtx
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import perfcfg
    from repro_torch.serve import step

    t_run = time.perf_counter()
    b4 = fa.flash_attention_gqa
    cfg = family_cfg(LM_ARCH, SEQ_LAYERS)
    ctx = MeshCtx(init_device_mesh("cpu", SEQ_SHAPE,
                                   mesh_dim_names=("data", "model")),
                  device="cuda:0")
    params = sharding.sharded_init(cfg, ctx, seed=SEED)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, SEQ_S)).astype(np.int32)
    out = {"rank": rank, "coord": ctx.coord("model")}
    for name, flags in (("off", {}), ("on", SEQ_FLAGS)):
        steps = []
        perfcfg.set_flags(**flags)
        b4.launches = b4.launches_offset = 0
        compat.stats = {}
        try:
            t0 = time.perf_counter()
            toks = step.generate(params, cfg, prompt, max_new=SEQ_NEW,
                                 max_len=SEQ_S + SEQ_NEW, ctx=ctx,
                                 logits=steps)
            torch.cuda.synchronize()
            run = {"s": time.perf_counter() - t0, "launches": b4.launches,
                   "offset": b4.launches_offset,
                   "bytes": compat.stats.get("bytes", 0),
                   "calls": compat.stats.get("calls", 0),
                   "by": compat.stats.get("by", {}),
                   "tokens": toks.cpu().numpy()}
        finally:
            compat.stats = None
            perfcfg.reset()
        if rank == 0:
            run["steps"] = torch.stack(steps).float().cpu().numpy()
        out[name] = run
    del params
    for name, flags in (("train_off", {}), ("train_on", SEQ_FLAGS)):
        perfcfg.set_flags(**flags)
        b4.launches = b4.launches_offset = 0
        try:
            trainer = train_launcher.main(train_argv(
                SEQ_LAYERS, 1, 100, root / f"18b-{name}", "--mesh",
                ",".join(map(str, SEQ_SHAPE)), "--dist-backend", "gloo",
                arch=LM_ARCH))
            torch.cuda.synchronize()
            out[name] = {"history": trainer.history,
                         "launches": b4.launches,
                         "offset": b4.launches_offset}
            del trainer
        finally:
            perfcfg.reset()
        gc.collect()
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_run
    return out


def seq_mesh_checked(torch, dev, card):
    """Phase 18b's checks in the parent, on the ranks' runs (PHASE18):
    one device's logits at SEQ_LAYERS first; each step's logits with the
    flags off and on within lm_atol of one device's and of each other
    (tokens equal where the top-2 margin exceeds it); B4's offset
    launches SEQ_LAYERS a prefill on every rank but model rank 0 (whose
    rows start at 0) with the flags on and none with them off, and
    2 x SEQ_LAYERS in a training step (the forward and its recompute);
    the training step's loss and grad norm with the flags on within
    MESH_TRAIN_RTOL of the flags off. Returns the offset launches of the
    runs with the flags on, every rank's."""
    from repro_torch.models import model as M
    from repro_torch.serve import step
    outs = PHASE18["18b"]
    cfg = family_cfg(LM_ARCH, SEQ_LAYERS)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, SEQ_S)).astype(np.int32)
    params = M.init(cfg, seed=SEED, device=dev)
    one = []
    step.generate(params, cfg, prompt, max_new=SEQ_NEW,
                  max_len=SEQ_S + SEQ_NEW, device=dev, logits=one)
    one = torch.stack(one).float().cpu().numpy()
    del params
    torch.cuda.empty_cache()
    atol = lm_atol("bfloat16", torch.from_numpy(one))
    off, on = outs[0]["off"]["steps"], outs[0]["on"]["steps"]
    errs = {}
    for name, a, b in (("flags on vs one device", on, one),
                       ("flags off vs one device", off, one),
                       ("flags on vs off", on, off)):
        errs[name] = float(np.abs(a - b).max())
        if errs[name] > atol:
            fail(f"18b: {name}: logits {errs[name]} apart (limit {atol})")
    toks_on, toks_off = outs[0]["on"]["tokens"], outs[0]["off"]["tokens"]
    for t in range(SEQ_NEW):
        rows = np.nonzero(toks_on[:, t] != toks_off[:, t])[0]
        top2 = np.sort(off[t][:, 0], axis=-1)[:, -2:]
        if ((top2[rows, 1] - top2[rows, 0]) >= atol).any():
            fail(f"18b: tokens part at step {t} above the top-2 margin "
                 f"limit {atol}")
    launched = 0
    for o in outs:
        want = 0 if o["coord"] == 0 else SEQ_LAYERS
        if not (o["on"]["offset"] == want and o["off"]["offset"] == 0
                and o["train_on"]["offset"] == 2 * want
                and o["train_off"]["offset"] == 0):
            fail(f"18b rank {o['rank']}: B4 offset launches "
                 f"{o['on']['offset']} serving, {o['train_on']['offset']} "
                 f"training with the flags on ({o['off']['offset']}, "
                 f"{o['train_off']['offset']} off), want {want}, {2 * want}")
        (l0, g0), (l1, g1) = ((o[k]["history"][0]["loss"],
                               o[k]["history"][0]["grad_norm"])
                              for k in ("train_off", "train_on"))
        gap = max(abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0))
        if gap > MESH_TRAIN_RTOL:
            fail(f"18b rank {o['rank']}: the training step with the flags "
                 f"on (loss {l1}, grad norm {g1}) against off ({l0}, {g0}): "
                 f"{gap} relative (limit {MESH_TRAIN_RTOL})")
        launched += o["on"]["offset"] + o["train_on"]["offset"]
        by_on, by_off = o["on"]["by"], o["off"]["by"]
        say(f"18b rank {o['rank']} (model {o['coord']}): B4 launches "
            f"{o['on']['launches']} serving with the flags on, "
            f"{o['on']['offset']} of them at a query offset "
            f"({o['off']['launches']} and 0 off), "
            f"{o['train_on']['offset']} offset launches in the training "
            f"step; collectives of the served run with the flags on "
            f"{o['on']['bytes'] / 1e9:.4f} GB in {o['on']['calls']} calls "
            f"({', '.join(f'{k} {v['bytes'] / 1e6:.1f} MB' for k, v in sorted(by_on.items()))}) "
            f"against {o['off']['bytes'] / 1e9:.4f} GB in "
            f"{o['off']['calls']} off "
            f"({', '.join(f'{k} {v['bytes'] / 1e6:.1f} MB' for k, v in sorted(by_off.items()))}); "
            f"served {o['on']['s']:.1f} s on, {o['off']['s']:.1f} s off; "
            f"training step loss {l1:.5f} on, {l0:.5f} off, grad norm "
            f"{g1:.5f}, {g0:.5f} (gap {gap:.2e}); rank {o['s']:.1f} s; "
            f"{card}")
    say(f"18b ({LM_ARCH} at full width, {SEQ_LAYERS} of 24 layers, "
        f"{' x '.join(map(str, SEQ_SHAPE))}, 4 ranks on one card over gloo, "
        f"flags {sorted(SEQ_FLAGS)}): logits apart by "
        + ", ".join(f"{k} {v:.4f}" for k, v in errs.items())
        + f" (limit lm_atol {atol:.4f}); {launched} B4 launches at a "
        "query offset in the runs with the flags on")
    return launched


def dry_child(path):
    """Phase 18d's dry run, in a process of its own beside the phases on
    the card (it needs no card and runs on the meta device): 17a's
    configuration on each of its four ranks (``dryrun.dry_rank``), then
    DRY_CELLS (``dryrun.run_cell``), each timed; written to ``path`` as
    JSON."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    cfg = family_cfg(TRAIN_ARCH, MESH_TRAIN_LAYERS)
    shape = ShapeSpec("17a", "train", TRAIN_SEQ, TRAIN_BATCH)
    out = {"17a": [], "cells": []}
    for d in range(MESH_TRAIN_SHAPE[0]):
        for m in range(MESH_TRAIN_SHAPE[1]):
            t0 = time.perf_counter()
            r = dryrun.dry_rank(cfg, shape, MESH_TRAIN_SHAPE,
                                ("data", "model"), (d, m))
            r["seconds"] = time.perf_counter() - t0
            out["17a"].append(r)
    for arch, shape_name, multi in DRY_CELLS:
        out["cells"].append(dryrun.run_cell(arch, shape_name, multi,
                                            str(DRY_ROOT)))
    with open(path, "w") as f:
        json.dump(out, f)


def dry_started():
    """Start ``dry_child`` in a process of its own, at low priority and
    with no card visible; (the process, its result's path)."""
    shutil.rmtree(DRY_ROOT, ignore_errors=True)
    DRY_ROOT.mkdir(parents=True)
    path = DRY_ROOT / "dry.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dry-child",
         str(path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(10))
    return proc, path


def dry_checked(torch, proc, path, card):
    """Phase 18d: the dry run's process (``dry_started``) waited for and
    read. 17a's ranks on the meta device against 17a's ranks on the
    card: each rank's collective bytes and calls a step equal, exactly,
    to every step 17a's rank counted, its weight blocks' bytes equal to
    17a's, its peak of live bytes printed beside 17a's
    max_memory_allocated as a ratio (no gate); then DRY_CELLS' records,
    with the seconds each took."""
    try:
        log, _ = proc.communicate(timeout=DRY_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"18d: the dry run did not end within {DRY_WAIT_S} s")
    if proc.returncode != 0:
        fail(f"18d: the dry run failed ({proc.returncode}): {log[-3000:]}")
    with open(path) as f:
        dry = json.load(f)
    memory = torch.cuda.get_device_properties(0).total_memory
    for o in PHASE18["17a"]:
        d = next(r for r in dry["17a"]
                 if (r["coords"]["data"], r["coords"]["model"])
                 == (o["coord"]["data"], o["coord"]["model"]))
        c = d["collectives"]
        for i, st in enumerate(o["steps"]):
            if (st["bytes"], st["calls"]) != (c["bytes"], c["calls"]):
                fail(f"18d rank {o['rank']}: the dry run counts "
                     f"{c['bytes']} bytes in {c['calls']} collectives a "
                     f"step, 17a's step {i} {st['bytes']} in "
                     f"{st['calls']}")
        if d["argument_bytes"]["params"] != o["param_bytes"]:
            fail(f"18d rank {o['rank']}: weight blocks of "
                 f"{d['argument_bytes']['params']} bytes on the meta device, "
                 f"{o['param_bytes']} in 17a")
        say(f"18d rank {o['rank']} ({o['coord']}): on the meta device "
            f"{c['bytes']} bytes in {c['calls']} collectives a step "
            f"({c['backward_bytes']} in the backward), equal to each of "
            f"17a's steps; weight blocks {o['param_bytes']} bytes, equal; "
            f"peak of live bytes {d['peak_bytes'] / 1e9:.3f} GB against "
            f"17a's max_memory_allocated {o['peak_gb']:.3f} GB (ratio "
            f"{d['peak_bytes'] / 1e9 / o['peak_gb']:.3f}); "
            f"{d['flops']:.4e} FLOP ({d['flops_b4']:.4e} B4's); "
            f"{d['seconds']:.1f} s")
    for rec in dry["cells"]:
        if rec["status"] != "ok":
            fail(f"18d: the dry run of {rec['arch']} {rec['shape']} "
                 f"{rec['mesh']}: {rec.get('error', rec['status'])}")
        a = rec["argument_bytes"]
        say(f"18d {rec['arch']} {rec['shape']} on the {rec['mesh']} "
            f"production mesh ({rec['n_chips']} ranks), rank "
            f"{rec['coords']} on the meta device: arguments "
            + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in a.items())
            + f"; peak {rec['peak_bytes'] / 1e9:.2f} GB, "
            f"{'fits' if rec['fits'] else 'does not fit'} "
            f"{rec['card_bytes'] / 1e9:.2f} GB (this card's total_memory "
            f"{memory}); {rec['flops']:.4e} FLOP; collectives "
            f"{rec['collectives']['bytes'] / 1e9:.2f} GB in "
            f"{rec['collectives']['calls']} calls; {rec['seconds']:.1f} s "
            f"on the host; {card}")


def perf_phase(torch, dev, card, dry):
    """Phase 18: the reference's perf flags and the dry run. 18a: B4 at a
    rank's rows (``seq_rank_cases``, ``seq_rank_times``); 18b: qwen2-0.5b
    on 1 x 4 with ``seq_shard_attn`` and ``sp_residual``, run on phase
    17's ranks (``seq_mesh_run``), checked here; 18c: ``a2a_int8`` on
    16b's ranks (``a2a_prefill``), checked here; 18d: the dry run
    (``dry_checked``). Returns the kernels line's row of B4 at a rank's
    rows."""
    from repro_torch.kernels import flash_attention as fa
    t_phase = time.perf_counter()
    err = seq_rank_cases(torch, dev, fa)
    times = seq_rank_times(torch, dev, fa)
    launched = seq_mesh_checked(torch, dev, card)
    c = PHASE18["18c"]
    n_moe = MESH_MOE_LAYERS
    if not (c["differs"] and all(n == 4 * n_moe for n in c["quantized"])):
        fail(f"18c: a2a_int8's logits equal the flag off's "
             f"({not c['differs']}), or the ranks quantized "
             f"{c['quantized']} times (want {4 * n_moe} a rank)")
    say(f"18c ({MOE_ARCH} at {n_moe} layers on "
        f"{' x '.join(map(str, MESH_MOE_SHAPE))}, 16b's weights and prompt, "
        f"the a2aint8 variant): each rank's first MoE block (its rows, "
        f"input bit for bit 16b's) within {c['first'][0]:.3e} of "
        f"dispatch_simulated under the flag (limit {c['first'][1]:.4f}, "
        f"16b's two bf16 ulps); each rank quantized its rows "
        f"{c['quantized'][0]} times (out and back, {n_moe} MoE layers, two "
        f"prefills). The reference test's rule, mean |diff| / mean |base| "
        f"< {A2A_RULE}, read, not gated (ROADMAP C30: it holds at the smoke "
        f"configs' width, not at 128 experts of 4096, where the reference's "
        f"own a2aint8 reads 0.15-0.17 on the CPU, and int8 levels turn the "
        f"two sides' one-ulp bf16 differences into level flips): against "
        f"the flag off with the router's own choices {c['own']:.4f}, with "
        f"one device's routing replayed {c['replayed']:.4f} (one device "
        f"{c['one']:.4f}); the replayed mesh against one device's a2a_int8 "
        f"pass {c['mesh_vs_one']:.4f}, max |diff| {c['mesh_err']:.4f}; "
        f"{c['seconds']:.1f} s on the ranks; {card}")
    dry_checked(torch, *dry, card)
    say(f"phase 18: {time.perf_counter() - t_phase:.1f} s wall here, 18b's "
        f"ranks {max(o['s'] for o in PHASE18['18b']):.1f} s in phase 17's "
        f"spawn, 18c's {c['seconds']:.1f} s in 16b's; {card}")
    return b4_row("flash_attention_seq_rank", launched, err, times)


def _launch_counters():
    from repro_torch.kernels import flash_attention as fa, fused
    from repro_torch.kernels.sparse_match import sparse_match
    from repro_torch.kernels.sparse_match_packed import sparse_match_packed
    return {"sparse_match": sparse_match,
            "sparse_match_packed": sparse_match_packed,
            "fused_match_topk": fused.fused_match_topk,
            "flash_attention": fa.flash_attention_gqa}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dry-child"]:
        dry_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
