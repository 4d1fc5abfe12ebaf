#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (``python3 chip_smoke.py``).

Phases — each raises on failure, so any failure exits non-zero:

1. Print the card (``nvidia-smi`` name and power limit) and build every
   CUDA kernel of the port from ``src/repro_torch`` with ``nvcc`` (one
   process per source, all four in parallel), printing the build time
   and ptxas's register / shared-memory report.
2. Hold each kernel against its plain PyTorch version on the card: the
   paged decode (B1) and the fused paged prefill (B2), at the serving
   path's shapes (TinyLlama: Hkv=4, G=8, D=64, page 16) and over a sweep
   of shapes, page sizes 8-64, starts that are not multiples of the
   64-key tile, padded/length-0 rows, a prefix ending mid-page, shared
   prefix pages and the copy-on-write boundary page; fp32 at 2e-5 and
   bf16 at 2e-2.  B1's cases include contexts on, one before and one
   past its split boundaries at spans 64, 128 and 256, ctx = 1 and the
   table's full width, G = 1, 3 and 8, D = 128 with pages 8 and 64,
   B = 1 at ctx 2048, Llama-3-8B's heads at ctx 2048, a stale row
   (zeroed table, ctx 10,000), rows sharing prefix pages, and a repeated
   call that must give the same bits (nothing persists between calls).
   Every kernel picks its variant by dtype (B1: bf16 the tensor-core
   ``split_mma`` kernel, fp32 the CUDA-core ``split_simt``; B2 and B3:
   bf16 ``wgmma``, fp32 ``mma_3xtf32``, the 3xTF32 tensor-core
   kernel): every case checks that exactly one
   launch of its dtype's variant was made.  The
   prefill must leave every pool byte outside its written slots as it
   was, bit for bit, in both dtypes, and write zeros for padded rows.
3. Serve full-width TinyLlama-1.1B (22 layers, random weights from a
   seed) in fp32 through ``repro_torch.serving.Engine`` on the paged
   plane: the shared-prefix workload of
   ``repro_torch.launch.serve.smoke_server``, with prefix-registry hits
   and recompute preemptions.  Every request's tokens must equal
   ``generate_reference``, and the kernels' launch counts, zeroed just
   before the run, must equal layers x prefill rounds (B2, every one
   through ``mma_3xtf32``) and layers x decode steps (B1, every one
   through ``split_simt``).
4. Serve the same workload in bf16 and report tokens/s; B2's launches,
   zeroed just before, must all be ``wgmma`` ones, layers x prefill
   rounds, and B1's all ``split_mma`` ones, layers x decode steps.  Time
   both variants of B1 and of B2 at the serving path's shapes, and B1
   at two long shapes (B=1, ctx 2048 with TinyLlama's heads; B=8, ctx
   2048 with Llama-3-8B's: H=32, Hkv=8, D=128), with CUDA events (L2
   flushed before each launch, as the serving loop finds it), beside
   their plain versions, ``scaled_dot_product_attention`` on
   pre-gathered dense K/V (a yardstick only: the port never calls it;
   fp32 with TF32 off; for fp32 B2 and B3 pinned with
   ``torch.nn.attention.sdpa_kernel`` to the backend the dispatcher
   takes, named in the row) and the least time the card could take (bytes
   over 3.35 TB/s or operations over the peak rate of the inputs' type,
   whichever is larger; K/V bytes count each distinct pool slot read
   once, however many rows map its page).  fp32 B2 and B3 do each
   product as three TF32 products (3xTF32), so their bound is the work as
   they do it, 3 x operations over the TF32 rate (494.7 TFLOP/s), with
   the fp32 CUDA cores' bound (operations over 67 TFLOP/s) beside it.
5. Hold the full-sequence flash-attention kernel (B3) against its plain
   version in both dtypes: the sweep of ``tests/test_kernels.py`` (fp32
   at 2e-5, bf16 at 2e-2), ragged S (100, 37, 200), D=128, S=2048,
   windows 16, 64, 100 and 130, prefixes of 32-200 tokens,
   ``causal=False`` on a ragged S, and both models' full widths
   (TinyLlama H=32/Hkv=4, SmolLM H=15/Hkv=5) at S=512; each case through
   its dtype's variant.
6. Full prefill at full width: TinyLlama-1.1B in fp32 (random weights
   from seed 0), ``prefill(impl="flash")`` against ``impl="reference"``
   at B=2, S=512 (logits and cache), and ``generate_reference`` tokens
   of both impls for a few prompts; B3's launch count, zeroed just
   before, must equal layers x prefill calls, all ``mma_3xtf32``
   launches.
   Then the same weights in bf16: ``prefill(impl="flash")`` must launch
   the ``wgmma`` kernel once per layer, and its logits and cache may be
   at most ``BF16_PREFILL_RATIO`` times as far (relative L2) from the
   fp32 reference on the same weights as the bf16 reference's are.
7. The trainer at full width (SmolLM-360M): bf16 steps through
   ``repro_torch.launch.train``'s own loop with fp32 AdamW state (loss
   and grad norm finite at every step, the loss falling); one fp32 step
   with 2 microbatches reporting the loss of 1; ``train_loss`` on the
   flash kernel (no grad) equal to the reference attention's.
8. Time both B3 variants at the full prefill's shapes (bf16 and fp32,
   B=2, S=512), and the bf16 one at S=2048 and at SmolLM's heads, beside
   its plain version, ``scaled_dot_product_
   attention`` (a yardstick only) and its bound (bytes over 3.35 TB/s or
   the operations of the visible (query, key) pairs over the peak rate,
   whichever is larger); and the train step's tokens/s.
9. Hold the WKV6 kernel (B4) against both its plain versions (the closed
   chunked form at ``pick_chunk``'s chunk, and the per-token oracle) in
   fp32: the sweep of ``tests/test_kernels.py`` and its decay extremes
   (w = 0.01 and 0.999, at 1e-4; 3e-5 elsewhere), a random nonzero initial
   state, S in {37, 200, 448, 127}, the engine round at full width (B=8
   and B=4, S=64, H=64, D=64), and both sides of every edge of the
   kernel's grid rule (``WKV_EDGES``: tile length and columns per CTA for
   D=64, the one split of D=32 and D=8; S off the tile); padded steps
   (w=1, k=0) must leave the state bit for bit as it was, a call split in
   two with the state carried across and a repeated call must give the
   same bits, every row of a B=8 call must equal that row called alone
   (the two calls split the state differently), and calls on two streams
   at once must each match.
10. Serve full-width RWKV6-7B (random weights from a seed) in fp32, cut
   to its first 4 layers, through the engine's slot-resident plane: the
   workload of
   ``repro_torch.launch.serve.rwkv_smoke_server`` (8 requests, prompts
   of 60-300 tokens, one of prime length, 32 output tokens, 4 slots,
   chunk 64, recompute preemptions).  Every request's tokens must equal
   ``generate_reference`` (whose prefill runs on B4 too), or diverge only
   where the reference's top-2 logit gap is below 1e-4 (a tie that the
   GEMMs' shape-dependent summation order may flip); B4's launches,
   zeroed just before, must equal layers x prefill rounds in the engine
   and layers x prompts in the reference.  The depth is cut because the
   random-weight model amplifies fp32 rounding about twofold per layer:
   the logits of one prompt run as 1 row and as 4 identical rows differ
   by 6e-5 at 4 layers and by 0.15 at 32, where greedy tokens flip
   without any fault (``scripts/rwkv_sensitivity.py``).
11. The same workload in bf16 at full depth: tokens/s, B4 launches and
   the wall of a decode step.
12. Time B4 at its three shapes (``WKV_SHAPES``: the engine round from a
   state at the smoke engine's 4 slots and at EngineConfig's default 8,
   and the full prefill of one 512-token prompt from a zero state) beside
   its plain chunked version and its bound (bytes over 3.35 TB/s, s0
   counted only when given, or its ~4 D^2 fp32 operations per token and
   head over 67 TFLOP/s, whichever is larger); no single PyTorch call
   computes WKV6, so its library time is null.

13. The swap data plane's transfers against the compute stream (run
   after phase 2), fp32 and bf16: a 304-token run of TinyLlama pool pages
   is gathered and its copy to pinned host memory started on the
   engine's copy stream; before the drain the pages are freed, handed to
   another request and overwritten on the compute stream, and buffers of
   the snapshot's size are allocated and filled.  The drained bytes must
   equal the pre-overwrite ones bit for bit, and writing them into other
   page ids must give the same bits.  The same for one full-width RWKV6-7B
   slot (``index``, ``S``, ``x_tm``, ``x_cm``; 34.1 MB in bf16), the slot
   overwritten by the slot plane's ``_merge`` before the drain.
14. TinyLlama-1.1B at full width under swap (``launch.serve.
   smoke_swap_server``: 32 requests on 8 Zipf-hot prompt templates, 256
   prompt and 48 output tokens, Sarathi-CS with page-level partial
   preemption in swap mode, break-even replacement with the host demotion
   tier, the h100 cost model), run after phases 3 and 4 on their weights.
   fp32: every request's tokens equal ``generate_reference``; swap-outs
   equal swap-ins and are > 0, and partial preemptions, demotions and
   promotions are > 0; the store and the pending set are empty at the
   end; B1 and B2 launches, zeroed just before, equal layers x decode
   steps and layers x prefill rounds through the fp32 variants.  bf16:
   tokens/s, the swap counters and their host walls (``wall_out_s``,
   ``wall_in_s``, ``wall_demote_s``, ``wall_promote_s``) and
   ``drains_on_swapin``, B1/B2 through the bf16 variants; and beside it,
   in the same process, the same workload under recompute with no
   demotion (a reading, not a target); the host clock's time in the step
   transaction's ``_begin_txn`` and ``_commit`` per step, and each
   batch's measured wall over its priced dt (how many batches a
   ``straggler_factor`` of 3.0 would flag: printed, not a gate).
15. RWKV6-7B under swap (``rwkv_smoke_server(preempt_mode="swap")``, run
   after phases 10 and 11 on their weights): the workload's preemptions
   become swaps of a whole slot.  fp32 at 4 layers: tokens against
   ``generate_reference`` under phase 10's top-2 tie rule, B4 launches =
   layers x prefill rounds; bf16 at full depth: tokens/s and the swap
   walls.
16. The host link (after phase 12): for a slot (RWKV6-7B bf16, 34.1 MB), a
   page run (TinyLlama bf16, 304 tokens: 6.8 MB) and one page (16
   tokens: 360,448 B), the bytes, ms per transfer and GB/s each way (CUDA
   events on the copy stream device to host, on the compute stream host
   to device; and the host clock across the drain), beside the 64 GB/s
   that ``get_hardware("h100").host_bw`` prices and
   ``cost_model.swap_time(n)`` for the tokens n of that transfer.
17. Rollback bytes (after phase 13), fp32 and bf16, no weights: on the
   full-width TinyLlama pools a suspended request's page run (drained on
   swap-in), a shed tail, a promoted host-tier page and a copy-on-write
   copy, and on the full-width RWKV6-7B slots a slot swap-in and a fresh
   claim's reset, each staged into a page or slot that a victim swapped
   out earlier in the same attempt held at batch start, with snapshots
   in flight on the copy stream.  The attempt's last allocation faults:
   ``Engine.step`` rolls it back, and every page and slot live at batch
   start must hold its batch-start bytes bit for bit; the retry commits
   and must end bit-equal to a twin engine's fault-free step (and hold
   the restored and promoted bytes); the in-flight copies must drain
   their pre-step bytes.
18. Phase 14's workload under ``tests/test_chaos.py``'s MIXED fault
   schedule (seed 1: allocation faults, transient and permanent store
   failures, corrupt snapshots, failed demotions and promotions).  fp32:
   32/32 requests token-identical to phase 14's outputs and to the
   references they were held against; rollbacks, integrity failures and
   degraded recomputes all > 0; the store and the pending set empty; B1
   and B2 launches = layers x decode steps and layers x prefill rounds
   through the fp32 variants.  bf16: tokens/s and the recovery counts
   (``wall_aborted_s``, ``backoff_s``) beside phase 14's bf16 reading.
19. RWKV6-7B fp32 at 4 layers under swap with the same fault schedule:
   tokens against ``generate_reference`` under phase 10's tie rule, B4
   launches = layers x prefill rounds, the recovery counts printed.
20. The step graphs (``repro_torch.serving.step_graphs``).  Every serving
   phase above (3, 4, 10, 11, 14, 15, 18, 19) serves through them: its
   engine's ``warmup()`` captures one CUDA graph per prefill shape (row
   rung and bucket on the pooled plane, bucket on a slot plane) and one
   decode graph, and each run must replay them for every prefill round
   and decode step, build no graph and run no step eagerly (``num_graphs
   == len(rungs) * len(buckets) + 1`` before and after, ``num_compiles``
   0); the kernels' launch counters add each graph's launches at every
   replay, so the launch checks hold unchanged.  Then, for TinyLlama-1.1B
   in fp32 and bf16 (8 slots, ``cache_len`` 512, chunk 128, page 16) and
   RWKV6-7B in bf16 at full depth (4 slots, chunk 64): a fresh server's
   capture seconds; each prefill shape's replay and the decode replay
   against an eager call of the same plane function on cloned pools or
   cache from random state (ids, the decode graph's advanced cohort and
   every pool or cache byte: bit-equal, or the largest difference printed
   and held within ``TOL``, as cuBLAS may pick another algorithm under
   capture); then the smoke workload served through the graphs (fp32
   tokens equal to phase 3's, bf16 ones counted against phases 4 and 11)
   and the wall of a decode-only batch.
21. The other data planes (``repro_torch.launch.serve.smoke_plane_server``:
   phase 3's engine settings and workload).  First B1 through
   ``kernels.paged_attention.ops.decode_attention_dense`` (the smoke
   engine's 8 x 512-token slot cache viewed as 64-token pages, identity
   tables, contexts 260-295) in fp32 and bf16: one launch of the dtype's
   variant, against its plain version (``TOL``) and plain attention over
   the dense cache.  Then TinyLlama-1.1B at full width on phase 3/4's
   weights on ``plane="batched"`` with ``impl="paged"`` (its replays first
   held against eager calls on cloned random state, as in phase 20), on
   ``batched`` with ``decode_append="deferred"`` and on
   ``plane="legacy"``: B1 launches = layers x decode steps through
   ``split_simt`` (fp32) or ``split_mma`` (bf16) on the ``impl="paged"``
   run and 0 on the others, B2 none; ``num_graphs == len(buckets) + 1``
   before and after with replays = rounds + steps (legacy: the decode
   graph alone, replayed once per decode step, its prefill eager).  fp32:
   16/16 requests equal to phase 3's references (and so to its paged
   outputs); bf16: tokens/s, the wall of a decode-only batch and the
   requests equal to phase 4's outputs (printed, not a gate).  RWKV6-7B
   fp32 at 4 layers on ``legacy`` and ``batched`` with
   ``decode_append="deferred"``: tokens against phase 10's references
   under its tie rule, B4 launches = layers x prefill rounds (the legacy
   plane's rounds are its exact-shape chunk calls).  B1 on the dense
   view is timed with the kernels (phase 4's method).  Here and in phases
   22-23, every bf16 request whose tokens leave the other run's gets its
   margin printed (``bf16_margins``): the fp32 logit gap between the two
   tokens at the first differing position beside the 99th percentile of
   bf16's error on the top-2 logits where the runs agree, a near-tie
   when within it (a measurement, not a gate).
22. The mixture-of-experts family (``models.moe``'s dense dispatch,
   the engine's default), on ``smoke_server``'s engine and workload
   (paged plane, page 16, 8 slots, ``cache_len`` 512, chunk 128, M=2048,
   vLLM with SRF; 16 shared-prefix requests of 256 prompt and 48 output
   tokens, ids over the model's vocabulary), after every earlier phase's
   engines and weights are freed: qwen2-moe-a2.7b at full width (d=2048,
   16 q / 16 kv heads of 128, 60 routed experts padded to 64 with top-4,
   4 shared experts, ``moe_d_ff`` 1408, vocab 151936; random weights from
   seed 0) in fp32 at ``MOE_FP32_LAYERS`` of its 24 layers (the fp32
   weights at full depth are 60.6 GB) and in bf16 at full depth, and
   qwen3-moe-30b-a3b at full widths (128 experts, top-8, 32 q over 4 kv
   heads, qk-norm) at ``MOE3_LAYERS`` of 48 layers in fp32, then in the
   grouped dispatch (``moe_impl="grouped"``: the Triton kernels of
   ``kernels/moe_grouped``, as the benchmark serves the model) in fp32 on
   the same weights and in bf16.  Each engine's replays must be bit-equal
   to eager calls on cloned random state (phase 20's method); each run
   must replay its graphs alone and launch B1 and B2 once per layer of
   every decode step and prefill round through its dtype's variants, and
   the grouped kernels once per layer of each under ``"grouped"`` and
   never otherwise (their counter zeroed just before the run); fp32
   tokens must equal ``generate_reference`` (dense dispatch) for every
   request (under ``"grouped"``, or part only where the reference's
   top-2 gap is below 1e-4, phase 10's tie rule), bf16 ones are
   counted.  Printed, not
   gated: tokens/s, the wall of a decode-only batch, the decode graph's
   replay time against the weight-read bound (the params' own bytes but
   the embedding table's, over 3.35 TB/s; the dense dispatch reads all 64
   experts), a full prefill round (T = 1024 rows) replayed and eagerly in
   the dense and the sparse dispatch, and the phase's peak device memory.
   Phase 2 also holds B1 and B2 at both models' serving shapes (q (8, 16,
   128) against pools (P, 16, 16, 128); q (8, 128, 16, 128); and qwen3's
   32 over 4 heads) against their plain versions, and phase 4 times them.
23. The hybrid family, hymba-1.5b at its published widths (32 layers,
   d=1600, 25 q / 5 kv heads of 64 over a 2048-token sliding window, the
   selective SSM's d_inner 3200 x N 16, d_ff 5504, vocab 32001; random
   weights from seed 0), after every earlier phase's engines and weights
   are freed.  (a) B1 through the dense view of the ring, q (4, 25, 64)
   over (4, 2048, 5, 64) (G = 5) at contexts 1, 63, 64, 65, 2047, 2048
   and a mix, and B3 causal with the 2048-token window at hymba's heads
   over S = 3100 and 2048, in both dtypes, each one launch of its
   dtype's variant within ``TOL`` of the plain version.  (b) Both timed
   with phase 4's method (B1 at the full ring, B3 at S = 3100 and 2048)
   beside the plain version, SDPA (given the window's mask) and the
   bound.  (c) ``hybrid_smoke_server`` (4 slots, ``cache_len`` 2048 =
   the ring, chunk 128, M=4096, vLLM with SRF; 8 requests of 48 output
   tokens, prompts 127-3100: 2030-2048 wrap the ring while decoding,
   2049 and 3100 while prefilling, both checked) in fp32 at full depth
   on ``batched`` with ``impl="paged"`` (B1 launches = layers x decode
   steps), with the reference decode, with ``decode_append="deferred"``,
   on ``legacy`` and under ``preempt_mode="swap"``: every run at least
   2 preemptions (3 on this schedule) and its graphs alone, every request's tokens
   equal to ``generate_reference(impl="flash")`` (B3 with the window on
   its prefill, layers x requests launches) under phase 10's tie rule.
   (d) The same workload in bf16 at full depth with ``impl="paged"``:
   replays bit-equal to eager calls on cloned random state, B1 launches
   = layers x decode steps through ``split_mma``; printed, not gated:
   the requests equal to the bf16 reference, tokens/s, the wall of a
   decode-only batch, the decode graph's replay time against the step's
   byte bound, and the phase's peak device memory.

24. The VLM and audio families at their published widths and depths
   (random weights from seed 0), after every earlier phase's engines and
   weights are freed.  (a) B1, B2 and B3 at head dim 256 with
   PaliGemma-3B's 8 query heads over 1 (fp32 2e-5, bf16 2e-2 against
   the plain versions, each case one launch of its dtype's variant): B1
   at the serving shapes (shared prefix pages, a repeated call bit-equal),
   on, before and past its split edges with ctx = 1, and at ctx 2048; B2
   at the serving shapes and ``PREFILL_256`` (pages 8 and 64, starts off
   the 64-key tile, padded and length-0 rows, the pool bytes outside the
   written slots bit for bit); B3 over ``FLASH_256`` (S ragged,
   ``prefix_len`` 0, 100 and 256); and B1/B2 at MusicGen-medium's serving
   shapes (24 over 24 heads of 64).  (b) Each timed with phase 4's method
   beside its plain version, SDPA and its bound.  (c) PaliGemma-3B (18
   layers, d=2048, 8 / 1 heads x 256, d_ff 16384, vocab 257216) on
   ``smoke_server``'s engine and workload (text-only requests over its
   vocabulary) in fp32 (every request's tokens equal to
   ``generate_reference``, B1 / B2 = layers x decode steps / prefill
   rounds through the fp32 variants), again on ``batched`` with
   ``impl="paged"`` (B1 on the dense view at D = 256; replays within
   ``TOL`` of eager calls), and in bf16 (replays bit-equal, tokens/s, the
   decode graph's device time against its byte bound).  (d) Its
   image-prefix prefill, B = 2 rows of 256 patch embeddings + 256 text
   tokens, ``prefill(impl="flash")`` (B3 with ``prefix_len`` 256, one
   launch per layer) against ``impl="reference"``: fp32 within
   ``PREFILL_TOL``, bf16 within ``BF16_PREFILL_RATIO`` of the bf16
   reference's distance from fp32.  (e) MusicGen-medium (48 layers,
   d=1536, 24 / 24 heads x 64, vocab 2048) on ``audio_smoke_server`` (8
   prompts of 500-1500 codec tokens, 128 outputs, 2 recompute
   preemptions) in fp32 (tokens equal to ``generate_reference`` under
   phase 10's tie rule) and bf16 (as (c)).  (f) ``launch/train.py``'s
   loop for 8 bf16 steps on PaliGemma-3B (8 of 18 layers: AdamW's state,
   old and new, would be 85 GB at full depth; B = 4, 256 patches + 256
   text) and MusicGen-medium (48 layers, B = 4, S = 512): loss and grad
   norm finite, the loss falling, the patch embeddings reaching
   ``train_loss`` as float32.

25. The MoE, hybrid and RWKV6 families train (after phase 24; the card's
   name and power limit head the phase's lines).  (a) ``train_loss``'s
   fp32 loss and gradients on the card against the port's on the CPU
   (which the tests hold against JAX) for the reduced qwen2-moe and
   qwen3-moe (the sparse and the dense dispatch each), hymba and RWKV6,
   B = 2, S = 16: every gradient element within ``GRAD_TOL`` (the tests'
   fp32 tolerance), the worst leaf printed; B4 never launched.  (b) The
   hybrid scan's autograd function (``models.ssm.ChunkScan``) alone at
   hymba's full width, (B, Q, d_inner, N) = ``SCAN_FULL`` in fp32: its
   values and both gradients on the card against the CPU, and its
   forward + backward timed.  (c) ``launch/train.py``'s loop for 8 bf16
   steps at full width (fp32 AdamW, B = 4, S = 512) on ``FAMILY_TRAIN``:
   qwen2-moe at 2 of 24 layers, qwen3-moe at 2 of 48, hymba at all 32 and
   RWKV6 at 6 of 32 (about 2 B parameters each: AdamW's state, old and
   new, at ~28 B a parameter); loss and grad norm finite, the loss
   falling; tokens/s per step and ``torch.cuda.max_memory_allocated``
   printed.  (d) B4 launched 0 times by the RWKV6 training steps and once
   a layer by a no-grad prefill at the same depth.

26. The distributed layer (``repro_torch.distributed``, ``launch.mesh``)
   on ``DIST_RANKS`` = 4 ranks that share the one card, spawned by
   ``launch.mesh.run_ranks``: ``gloo`` over CUDA tensors (NCCL refuses
   two ranks on one device), with DTensor's all-gathers staged through
   pinned host memory (``gloo``'s functional all-gather crashes on CUDA
   tensors) and counted.  (a) ``make_seqsharded_decode_attn`` and its
   partials variant on (1, 4) at TinyLlama's heads (32 / 4, D = 64), B =
   8, S = 32768 (``decode_32k``'s length), ragged lengths around the
   shard edges, in fp32 and bf16: against ``decode_attn_reference`` and
   B1 on the whole cache at ``TOL``, the partials' max and sum-exp
   against the single-device ones.  (b) Full-width TinyLlama
   ``decode_step`` and ``decode_step_deferred`` with ``impl=
   "seqsharded"`` for 16 greedy fp32 steps, the cache placed by
   ``batch_pspecs``: tokens equal to ``impl="reference"``.  (c)
   ``apply_moe_ep`` at full width, one layer of qwen2-moe (16 of 64
   experts a rank) and of qwen3-moe (32 of 128), fp32, capacity 8.0, B =
   2, S = 512: within 2e-4 of the dense dispatch, gradients finite.  (d)
   ``make_train_step`` on full-width SmolLM-360M's DTensor params on (2,
   2), fp32, B = 4, S = 512, two steps against the one-rank step: the
   first step's gradients, every leaf within ``GRAD_TOL``; each step's
   grad norm within rtol 1e-4; the loss within rtol 1e-5, every leaf
   after the last step within rtol 1e-4 / atol 1e-5
   (``DIST_TRAIN_EPS``).  (e) ``compressed_psum`` over ``data`` against
   the arithmetic on the ranks' own gradients, then ``elastic_remesh``
   from 4 ranks to 3 survivors with ``model_parallel=2`` ((1, 2)),
   ``reshard`` and a finite ``train_loss``.  One JSON line per check
   (its wall time, the card's name and power limit, the backend) and a
   summary line with the host-staged collectives; these are times of
   ranks sharing one card, not multi-card times.
27. The serving engine over a mesh (``serving.spmd``), on
   ``DIST_RANKS`` = 4 ranks that share the card (``gloo``, every step
   eager): (a) full-width TinyLlama-1.1B at ``SPMD_LAYERS`` of its 22
   layers in fp32 on the ``batched`` plane with ``impl="seqsharded"``
   (the slot cache's sequence sharded over the 4 ranks) serving
   ``smoke_server``'s 16 shared-prefix requests: every rank's tokens and
   ``BatchLog`` schedule equal rank 0's and a one-rank fp32 ``batched``
   engine's (phase 21's settings) at the same depth; (b) qwen2-moe
   at phase 22's 4 fp32 layers on the paged plane with ``moe_impl=
   "ep"`` (16 of 64 experts a rank, capacity ``SPMD_EP_CAPACITY``, at
   which no token overflows): tokens equal phase 22's one-rank fp32
   engine's.  The engines check every step's tokens equal across the
   ranks.  One JSON line per check: its wall, tokens/s, staged
   all-gathers per step, the card's name and power limit, and the note
   that 4 ranks share one card.
28. The port's analyser (``repro_torch.analysis``): its static pass over
   ``src/repro_torch`` against the committed baseline (0 blocking), then
   ``artifact.audit_artifacts(device="cuda")``: a tiny reduced TinyLlama
   engine per plane (``batched``, ``paged``, ``legacy``) on JAX's audit
   workload, its graph count held to ``graph_budget.json``, and every
   step graph it built captured again with CUDA's debug print on, read
   node by node: no memcpy to or from host memory, no host node, and the
   hand-written kernels each plane's graphs launch equal to the budget's
   list (B1 and B2 on ``paged``, none on the slot planes).  Prints the
   graph counts, each graph's node counts by type and its hand-written
   kernels; any finding fails the run.

29. Every variant of B1-B4 launched again and again on one set of
   inputs (``phase_stress``): at the kernel table's serving shapes (B1's
   step and dense view; B2's round at TinyLlama's, qwen3-moe's and
   PaliGemma's heads; B3's full prefill; B4's round at B 4 and 8 and its
   512-token prefill, so 32 and 64 columns a CTA), 200 times, and B3 at
   the two shapes where an fp32 check once failed (``RUN5``), 1,000
   times; then as many times again while a second stream runs a 4096^3
   bf16 product before every launch.  Every output must be bit-equal to
   the first launch's, and that one within ``TOL`` of the plain version;
   prints the launches and the differing ones per variant.
30. The grouped MoE kernels (``kernels/moe_grouped``, Triton: route,
   layout, the gate/up and down products, combine) at Qwen3-30B-A3B's
   widths (d 2048, 128 experts of 768, top-8; random weights from a
   seed), after phase 22: in fp32 and bf16, a 4,096-token call with 30 %
   of its tokens inert against the plain version (``ref``): each live
   token's largest error within ``GROUPED_TOL`` of the plain output's
   largest value (fp32 1e-5, bf16 2e-2), but for at most one token in
   512 whose K-th and (K+1)-th router logits lie within a step of the
   dtype (``GROUPED_TIE``), and the inert tokens' output exactly zero;
   its first 128 tokens called alone must pass the same check and be
   bit-equal to the same rows of the whole call.  Timed with phase 4's
   method at 128 tokens (the benchmark cell's decode step) in both
   dtypes and at 1,024 and 4,096 in bf16, every token live: beside the
   plain version, ``torch._grouped_mm`` for the same products given the
   layout (a yardstick; none in fp32, which it refuses), the dense
   dispatch, each kernel's device time (``torch.profiler``) and the
   bound (the router and every reached expert's weights read once, x
   and the output, over 3.35 TB/s; or the operations over the dtype's
   peak, fp32's as 3xTF32 products, phase 4's rule for B2 and B3).

Each phase prints the seconds since the start when it is done; phase
20's three engines run after phase 18's fp32 and bf16 serves and phase
15's bf16 one, on their weights; phase 21's TinyLlama runs after phase
20's fp32 and bf16 engines, its RWKV6-7B runs after phase 19; phase 23
runs after phase 22 and phase 30, then phase 24, phase 25, phase 26,
phase 27, phase 28 and phase 29 last.

The last two lines of standard output are the kernels' JSON line (one
entry per kernel and variant: ``paged_decode`` is B1's bf16
``split_mma`` kernel, ``paged_prefill`` and ``flash_attention`` the bf16
``wgmma`` kernels, ``paged_decode_simt`` B1's fp32 CUDA-core kernel,
``paged_prefill_3xtf32`` / ``flash_attention_3xtf32`` B2 / B3's fp32
3xTF32 tensor-core kernels (each of the others with the same suffixes),
``paged_decode_dense`` B1 on the dense view of the slot cache,
``paged_decode_moe`` / ``paged_prefill_moe`` B1 / B2 at qwen2-moe's
serving shapes, ``paged_decode_hymba`` / ``flash_attention_hymba`` B1 on
hymba's ring and B3 with its window, ``..._d256`` B1-B3 at PaliGemma's
head dim 256, ``..._musicgen`` B1 / B2 at MusicGen's shapes, ``wkv6``
B4's column-split ``colsplit`` kernel, ``moe_grouped`` /
``moe_grouped_fp32`` the grouped MoE layer's Triton kernels in bf16 /
fp32 at the benchmark's decode step, launched by phase 22's grouped
serves) and ``{"ok": true, "device": {...}}``.
``--report PATH`` also writes every measurement as JSON.  Without a CUDA
device, or outside a checkout of the repository, the script exits with
code 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12,      # fp32 outside the tensor cores
            "tf32": 494.7e12}      # dense tensor-core tf32
#: TF32 products per fp32 product in fp32 B2 and B3 (3xTF32)
TF32_PRODUCTS = 3
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

#: phases 18-19's fault schedule: ``tests/test_chaos.py``'s MIXED spec
MIXED = dict(seed=1, p_alloc=0.05, p_store_transient=0.3,
             p_store_permanent=0.15, p_corrupt=0.2, p_demote_fail=0.3,
             p_promote_fail=0.3)

#: name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "paged_decode": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_decode.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:231"),
    "paged_prefill": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_prefill.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:168"),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:87"),
    "wkv6": (
        "src/repro_torch/kernels/rwkv_scan/csrc/wkv6.cu",
        "src/repro/kernels/rwkv_scan/rwkv_scan.py:75"),
    # Triton; the JAX package computes its MoE layer with XLA's products
    "moe_grouped": (
        "src/repro_torch/kernels/moe_grouped/moe_grouped.py", "none"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# --------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------- #

class Inputs:
    """Seeded random tensors on the card."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.gen = torch.Generator(device=DEVICE)
        self.gen.manual_seed(seed)

    def randn(self, *shape, dtype):
        t = self.torch.randn(shape, generator=self.gen, device=DEVICE)
        return t.to(getattr(self.torch, dtype))

    def perm(self, n):
        return self.torch.randperm(n, generator=self.gen, device=DEVICE)


def tables(torch, inp: Inputs, need, maxp: int, P: int, shared=()):
    """(B, maxp) int32 block tables: row b owns need[b] distinct pages of
    the P-page pool (unused entries 0, as the engine leaves them);
    ``shared`` = [(rows, npages)] makes those rows map the SAME first
    npages (a prefix-registry attach)."""
    pool = inp.perm(P).tolist()
    bt = torch.zeros((len(need), maxp), dtype=torch.int32)
    for rows, n in shared:
        pages = [pool.pop() for _ in range(n)]
        for b in rows:
            bt[b, :n] = torch.tensor(pages)
    shared_rows = {b: n for rows, n in shared for b in rows}
    for b, nb in enumerate(need):
        for j in range(shared_rows.get(b, 0), nb):
            bt[b, j] = pool.pop()
    return bt.to(DEVICE)


def decode_case(torch, inp, B, H, Hkv, D, page, npages, dtype, ctx,
                P=None, shared=()):
    P = P or B * npages + 3
    q = inp.randn(B, H, D, dtype=dtype)
    kp = inp.randn(P, page, Hkv, D, dtype=dtype)
    vp = inp.randn(P, page, Hkv, D, dtype=dtype)
    need = [min(npages, -(-c // page)) for c in ctx]
    bt = tables(torch, inp, need, npages, P, shared)
    cl = torch.tensor(ctx, dtype=torch.int32, device=DEVICE)
    return q, kp, vp, bt, cl


def prefill_case(torch, inp, B, c, H, Hkv, D, page, maxp, dtype, starts,
                 lengths, P=None, shared=()):
    """``shared`` rows map the same first pages; where their start lies
    mid-page, each row's boundary page is a copy of the first row's (the
    engine's copy-on-write guard makes the page a row writes into private
    first)."""
    P = P or B * maxp + 3
    q = inp.randn(B, c, H, D, dtype=dtype)
    k = inp.randn(B, c, Hkv, D, dtype=dtype)
    v = inp.randn(B, c, Hkv, D, dtype=dtype)
    kp = inp.randn(P, page, Hkv, D, dtype=dtype)
    vp = inp.randn(P, page, Hkv, D, dtype=dtype)
    need = [max(1, -(-(s + ln) // page)) for s, ln in zip(starts, lengths)]
    bt = tables(torch, inp, need, maxp, P, shared)
    for rows, n in shared:
        if starts[rows[0]] % page:
            for b in rows[1:]:
                dst, src = int(bt[b, n]), int(bt[rows[0], n])
                kp[dst] = kp[src]
                vp[dst] = vp[src]
    st = torch.tensor(starts, dtype=torch.int32, device=DEVICE)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    return q, k, v, kp, vp, bt, st, ln


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #

#: the kernel each dtype selects in B2 and B3 (the C entries' choice)
VARIANT = {"float32": "mma_3xtf32", "bfloat16": "wgmma"}
#: the dtype's short name in report keys
TAG = {"float32": "fp32", "bfloat16": "bf16"}
#: ... and in B1
DECODE_VARIANT = {"float32": "split_simt", "bfloat16": "split_mma"}
#: report-key suffix of each dtype's kernel: B1's (``split_simt`` in
#: fp32), B2's and B3's (``mma_3xtf32`` in fp32)
DECODE_SFX = {"bfloat16": "", "float32": "_simt"}
ATTN_SFX = {"bfloat16": "", "float32": "_3xtf32"}


def one_launch_of(fn, before, dtype, what, variants=VARIANT) -> None:
    """``fn`` launched once since ``before`` (its ``launches_by_variant``
    then), through the variant ``dtype`` selects."""
    after = fn.launches_by_variant
    want = {k: n + (k == variants[dtype]) for k, n in before.items()}
    check(after == want, f"{what}: launches by variant {before} -> {after},"
          f" expected one {variants[dtype]}")


def zero_counts(*fns) -> None:
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)


def compare(torch, got, want, dtype, what) -> float:
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite")
    check(not bool(bad.any()), f"{what}: max abs err {err.max().item():.3g}"
          f" beyond rtol=atol={tol['atol']}")
    return err.max().item()


def check_decode(torch, pa, ref, case, dtype, what, repeat=False) -> float:
    before = dict(pa.paged_decode_cuda.launches_by_variant)
    got = pa.paged_decode_cuda(*case)
    one_launch_of(pa.paged_decode_cuda, before, dtype, what, DECODE_VARIANT)
    want = ref.paged_decode_reference(*case)
    torch.cuda.synchronize()
    if repeat:      # nothing persists between calls: the same bits
        for _ in range(3):
            check(torch.equal(pa.paged_decode_cuda(*case), got),
                  f"{what}: a repeated call gave other bits")
    return compare(torch, got, want, dtype, what)


def split_edges(pa, B, Hkv, width):
    """B contexts on, one before and one past B1's split boundaries (the
    span its C entry picks for these shapes), ctx = 1 and the table's
    full width."""
    span = pa.decode_span(B, Hkv, width)
    edges = [1, span - 1, span, span + 1, 2 * span - 1, 2 * span,
             2 * span + 1, 3 * span, width - 1, width]
    edges = sorted({min(max(c, 1), width) for c in edges})
    return [edges[b % len(edges)] for b in range(B)], span


#: B1 at long contexts: (B, H, Hkv, D, page, npages, ctx) -- TinyLlama's
#: heads at B=1, and Llama-3-8B's (32 query heads over 8, D=128) at B=8
DECODE_LONG = {"B1_ctx2048_tinyllama": (1, 32, 4, 64, 16, 128, [2048]),
               "B8_ctx2048_llama3_8b": (8, 32, 8, 128, 16, 128, [2048] * 8)}


def check_prefill(torch, pa, ref, case, dtype, what) -> float:
    q, k, v, kp, vp, bt, st, ln = case
    kp0, vp0 = kp.clone(), vp.clone()
    kp2, vp2 = kp.clone(), vp.clone()
    before = dict(pa.paged_prefill_cuda.launches_by_variant)
    got = pa.paged_prefill_cuda(q, k, v, kp, vp, bt, st, ln)
    one_launch_of(pa.paged_prefill_cuda, before, dtype, what)
    want = ref.paged_prefill_reference(q, k, v, kp2, vp2, bt, st, ln)
    torch.cuda.synchronize()
    c = q.shape[1]
    valid = torch.arange(c, device=DEVICE)[None] < ln[:, None]
    err = compare(torch, got[valid], want[valid], dtype, what)
    check(not bool(got[~valid].float().abs().any()),
          f"{what}: padded rows are not zero")
    check(torch.equal(kp, kp2) and torch.equal(vp, vp2),
          f"{what}: pools differ from the plain version's")
    # every byte outside the written slots is the input's, bit for bit
    P, page = kp.shape[:2]
    written = torch.zeros(P * page, dtype=torch.bool, device=DEVICE)
    pos = st[:, None].long() + torch.arange(c, device=DEVICE)[None]
    slot = torch.clamp(pos // page, 0, bt.shape[1] - 1)
    dest = torch.gather(bt.long(), 1, slot) * page + pos % page
    written[dest[valid]] = True
    keep = ~written.view(P, page)
    check(torch.equal(kp[keep], kp0[keep]) and torch.equal(vp[keep], vp0[keep]),
          f"{what}: pool bytes outside the written slots changed")
    return err


#: (H, Hkv, D) of the smoke models: TinyLlama-1.1B, the MoE family's
#: qwen2-moe (G = 1) and qwen3-moe (G = 8), both at head dim 128,
#: PaliGemma-3B's Gemma backbone (G = 8 at head dim 256) and
#: MusicGen-medium (G = 1 at 64)
HEADS = {"tinyllama": (32, 4, 64), "qwen2_moe": (16, 16, 128),
         "qwen3_moe": (32, 4, 128), "paligemma": (8, 1, 256),
         "musicgen": (24, 24, 64)}


def main_path_decode(torch, inp, dtype, P, ecfg, heads=HEADS["tinyllama"]):
    """Decode at the serving shapes: 8 rows mid-generation (context ~270
    of a 512-token budget), two prompt groups sharing 12 prefix pages;
    ``heads`` (H, Hkv, D) of the served model."""
    ns, page = ecfg.nslots, ecfg.page_size
    ctx = [260 + 5 * b for b in range(ns)]
    return decode_case(torch, inp, ns, *heads, page,
                       ecfg.cache_len // page, dtype, ctx, P=P,
                       shared=[((0, 2, 4, 6), 12), ((1, 3, 5, 7), 12)])


def main_path_prefill(torch, inp, dtype, P, ecfg, heads=HEADS["tinyllama"]):
    """Prefill at the serving shapes: a 128-row bucket over 8 rows —
    first and second chunks of 256-token prompts, and two rows resuming
    after a 192-token attached prefix."""
    starts = [0, 128, 0, 128, 192, 192, 0, 128]
    lengths = [128, 128, 128, 128, 64, 64, 128, 128]
    page = ecfg.page_size
    return prefill_case(torch, inp, ecfg.nslots, ecfg.chunk, *heads, page,
                        ecfg.cache_len // page, dtype, starts, lengths, P=P,
                        shared=[((4, 5), 12)])


def phase_kernels(torch, pa, ref, P_main, ecfg):
    inp = Inputs(torch, 1)
    errs = {"paged_decode": {}, "paged_prefill": {}}
    for dtype in ("float32", "bfloat16"):
        e = errs["paged_decode"]
        e[f"main_{dtype}"] = check_decode(
            torch, pa, ref, main_path_decode(torch, inp, dtype, P_main, ecfg),
            dtype, f"decode main path {dtype}", repeat=True)
        # split edges: spans 64 (G = 8, 3, 1; D = 128, pages 8 and 64),
        # 128 and 256 (two and four chunks per warp)
        for B, H, Hkv, D, page, npages in [(10, 8, 1, 64, 16, 16),
                                           (10, 3, 1, 64, 16, 16),
                                           (10, 2, 2, 64, 16, 16),
                                           (10, 16, 2, 128, 8, 40),
                                           (10, 8, 4, 128, 64, 6),
                                           (16, 16, 8, 64, 16, 64),
                                           (32, 16, 8, 64, 16, 64)]:
            ctx, span = split_edges(pa, B, Hkv, page * npages)
            name = (f"decode edges span{span} B{B} H{H} Hkv{Hkv} D{D} "
                    f"page{page} {dtype}")
            e[name] = check_decode(
                torch, pa, ref, decode_case(torch, inp, B, H, Hkv, D, page,
                                            npages, dtype, ctx), dtype, name)
        for what, (B, H, Hkv, D, page, npages, ctx) in DECODE_LONG.items():
            e[f"{what}_{dtype}"] = check_decode(
                torch, pa, ref, decode_case(torch, inp, B, H, Hkv, D, page,
                                            npages, dtype, ctx), dtype,
                f"decode {what} {dtype}")
        for B, H, Hkv, D, page, npages in [(2, 8, 2, 64, 16, 4),
                                           (4, 4, 4, 64, 32, 2),
                                           (1, 8, 1, 128, 64, 3),
                                           (3, 24, 4, 128, 8, 9),
                                           (5, 7, 7, 64, 16, 3)]:
            ctx = [1 + (b * 37) % (page * npages) for b in range(B)]
            ctx[0] = page * npages              # a full table
            name = f"decode B{B} H{H} Hkv{Hkv} D{D} page{page} {dtype}"
            e[name] = check_decode(
                torch, pa, ref, decode_case(torch, inp, B, H, Hkv, D, page,
                                            npages, dtype, ctx), dtype, name)
        # inactive engine rows: a zeroed table row with a stale context
        # beyond the table's width reads page 0 only, never past the row
        q, kp, vp, bt, cl = decode_case(torch, inp, 4, 16, 2, 64, 16, 4,
                                        dtype, [10, 64, 30, 5])
        bt[1] = 0
        cl[1] = 10_000
        e[f"stale_row_{dtype}"] = check_decode(
            torch, pa, ref, (q, kp, vp, bt, cl), dtype, "decode stale row")
        # two rows that map the same prefix pages, across split boundaries
        e[f"shared_prefix_{dtype}"] = check_decode(
            torch, pa, ref, decode_case(torch, inp, 4, 16, 2, 64, 16, 12,
                                        dtype, [150, 190, 64, 129],
                                        shared=[((0, 1), 6)]), dtype,
            "decode shared prefix pages")

        e = errs["paged_prefill"]
        e[f"main_{dtype}"] = check_prefill(
            torch, pa, ref, main_path_prefill(torch, inp, dtype, P_main, ecfg),
            dtype, f"prefill main path {dtype}")
        sweep = [
            # (B, c, H, Hkv, D, page, maxp, starts, lengths, shared)
            (2, 8, 4, 2, 64, 8, 3, [8, 0], [8, 8], ()),
            (1, 16, 2, 2, 64, 8, 5, [8], [16], ()),
            (2, 8, 4, 1, 128, 16, 2, [16, 0], [8, 8], ()),
            (3, 8, 4, 2, 64, 8, 3, [0, 4, 0], [8, 3, 0], ()),   # padded
            (2, 8, 4, 2, 64, 8, 3, [8, 8], [8, 8], [((0, 1), 1)]),
            (1, 8, 4, 2, 64, 8, 2, [5], [3], ()),               # mid-page
            (2, 32, 24, 4, 128, 32, 4, [64, 3], [32, 29], ()),
            # page sizes 8 / 16 / 32 / 64 with starts that are not
            # multiples of the 64-key tile
            (2, 32, 16, 2, 64, 8, 20, [37, 100], [32, 20], ()),
            (2, 32, 16, 2, 64, 16, 10, [70, 3], [25, 32], ()),
            (2, 64, 8, 1, 64, 32, 6, [90, 0], [64, 40], ()),
            (2, 64, 8, 1, 128, 64, 4, [130, 65], [50, 64], ()),
            # a prefix ending mid-page, a padded row and a length-0 row
            (3, 16, 24, 4, 128, 16, 6, [40, 41, 0], [16, 9, 0], ()),
            # the copy-on-write boundary page: rows sharing two full pages
            # resume mid-page, each in its own copy of the third
            (2, 16, 8, 1, 64, 16, 6, [40, 40], [16, 12], [((0, 1), 2)]),
            (4, 16, 32, 4, 64, 16, 6, [45, 45, 45, 8], [16, 7, 0, 16],
             [((0, 1, 2), 2)]),
        ] + [(2, c, 8, 2, 64, 16, -(-c // 16) + 1, [0, 16], [ln, max(1, ln - 1)],
              ()) for c in (8, 16, 64, 128) for ln in (1, c - 1, c)
             if ln >= 1]
        for B, c, H, Hkv, D, page, maxp, st, ln, sh in sweep:
            name = (f"prefill B{B} c{c} H{H} Hkv{Hkv} D{D} page{page} "
                    f"starts{st} lengths{ln} shared{list(sh)} {dtype}")
            e[name] = check_prefill(
                torch, pa, ref,
                prefill_case(torch, inp, B, c, H, Hkv, D, page, maxp, dtype,
                             st, ln, shared=sh), dtype, name)
    for k, e in errs.items():
        print(f"{k}: {len(e)} comparisons with the plain version pass "
              f"(rtol=atol 2e-5 fp32, 2e-2 bf16); main path max abs err "
              f"fp32 {e['main_float32']:.3g}, bf16 {e['main_bfloat16']:.3g}")
    return errs


# --------------------------------------------------------------------- #
# phases 3-4: serving
# --------------------------------------------------------------------- #

def swap_summary(res):
    """The swap counters of a run, measured wall keys aside."""
    m = res.metrics
    return dict({k: v for k, v in res.swap_stats.items()
                 if v and not k.startswith("wall_")},
                preemptions=m.num_preemptions,
                partial=m.num_partial_preempts, swaps=m.num_swaps)


def check_swapped(eng, res, what, partial=True, demotion=True):
    """Swaps, tail sheds, demotions and promotions all happened, and
    nothing is left in the store or in flight."""
    st = res.swap_stats
    check(st["swap_outs"] == st["swap_ins"] > 0,
          f"{what}: swap-outs {st['swap_outs']}, swap-ins {st['swap_ins']}")
    check(not partial or res.metrics.num_partial_preempts > 0,
          f"{what}: no partial preemption")
    check(not demotion or st["demotions"] > 0 and st["promotions"] > 0,
          f"{what}: demotions {st['demotions']}, promotions "
          f"{st['promotions']}")
    check(len(eng.swap_store) == 0 and not eng._pending_swaps
          and not eng._pending_runs and not eng._pending_demotes,
          f"{what}: the store or the pending set is not empty at the end")


def check_drained(eng, what):
    check(len(eng.swap_store) == 0 and not eng._pending_swaps
          and not eng._pending_runs and not eng._pending_demotes,
          f"{what}: the store or the pending set is not empty at the end")


def check_recovered(res, what):
    """Phases 18-19: the fault schedule made the step transactions roll
    back, fail a seal and degrade a request."""
    rec = res.recovery_stats
    check(rec["rollbacks"] > 0 and rec["integrity_failures"] > 0
          and rec["degraded_recomputes"] > 0,
          f"{what}: recovery counts {rec}: a rollback, an integrity failure "
          "and a degraded recompute were expected")


def recovery_summary(res):
    return dict({k: v for k, v in res.recovery_stats.items() if v},
                backoff_s=res.swap_stats["backoff_s"],
                transient_retries=res.swap_stats["transient_retries"],
                permanent_store_failures=res.swap_stats[
                    "permanent_store_failures"],
                demote_drops=res.swap_stats["demote_drops"],
                prefix_integrity=res.swap_stats["prefix_integrity"])


def phase_serve_fp32(torch, pa, cfg, params, swap=False, faults=None,
                     clean=None):
    """Phase 3 (``smoke_server``), phase 14's fp32 run under swap
    (``smoke_swap_server``), or phase 18's under ``faults``: its tokens
    are held against phase 14's (``clean``: outputs and the references
    they were held against) instead of new references."""
    from repro_torch.launch.serve import (SMOKE_ENGINE, smoke_server,
                                          smoke_swap_server)
    from repro_torch.serving import generate_reference
    if faults is not None:
        eng, reqs = smoke_swap_server(cfg, params, device=DEVICE,
                                      faults=faults)
    else:
        eng, reqs = (smoke_swap_server if swap else smoke_server)(
            cfg, params, device=DEVICE)
    label = ("fp32 faulted swap serve" if faults is not None
             else "fp32 swap serve" if swap else "fp32 serve")
    torch.cuda.synchronize()
    zero_counts(pa.paged_decode_cuda, pa.paged_prefill_cuda)
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_graph_run(eng, before, label)
    launches = {"paged_decode": pa.paged_decode_cuda.launches,
                "paged_prefill": pa.paged_prefill_cuda.launches}
    variants = dict(pa.paged_prefill_cuda.launches_by_variant)
    dvariants = dict(pa.paged_decode_cuda.launches_by_variant)
    L = cfg.num_layers
    print(f"{label}: {len(reqs)} requests, "
          f"{sum(len(o) for o in res.outputs.values())} tokens in "
          f"{wall:.3f} s; {eng.prefill_rounds} prefill rounds, "
          f"{eng.decode_steps} decode steps, {len(res.metrics.batches)} "
          f"batches, preemptions {res.metrics.num_preemptions}, "
          f"prefix hits {res.swap_stats['trie_hits']}; launches {launches}"
          + (f"; swap counts {swap_summary(res)}" if swap else ""))
    check(launches["paged_prefill"] == L * eng.prefill_rounds > 0,
          f"paged_prefill launched {launches['paged_prefill']} times, "
          f"expected {L} x {eng.prefill_rounds}")
    check(launches["paged_decode"] == L * eng.decode_steps > 0,
          f"paged_decode launched {launches['paged_decode']} times, "
          f"expected {L} x {eng.decode_steps}")
    check(variants == {"wgmma": 0, "mma_3xtf32": launches["paged_prefill"]},
          f"fp32 paged_prefill launches by variant {variants}: every one "
          "should be the 3xTF32 kernel")
    check(dvariants == {"split_mma": 0,
                        "split_simt": launches["paged_decode"]},
          f"fp32 paged_decode launches by variant {dvariants}: every one "
          "should be the CUDA-core kernel")
    check(res.metrics.num_preemptions >= 1, "no preemption")
    check(res.swap_stats["trie_hits"] > 0, "no prefix-registry hit")
    check(all(r.finished for r in reqs), "unfinished requests")
    if faults is not None:
        print(f"  {label}: recovery {recovery_summary(res)}")
        check_recovered(res, label)
        check_drained(eng, label)
        same = sum(res.outputs[r.rid] == clean["outputs"][r.rid]
                   for r in reqs)
        print(f"  {label}: {same}/{len(reqs)} requests token-identical to "
              "phase 14's fault-free run")
        check(same == len(reqs), "tokens differ from the fault-free run")
    elif swap:
        check_swapped(eng, res, label)
    t0 = time.perf_counter()
    mismatched, refs = [], {}
    for r in reqs:
        want = refs[r.rid] = (
            clean["references"][r.rid] if faults is not None else
            generate_reference(cfg, params, r.prompt, r.output_len,
                               cache_len=SMOKE_ENGINE.cache_len,
                               device=DEVICE))
        got = res.outputs[r.rid]
        if got != want:
            first = next(i for i, (a, b) in enumerate(zip(got, want))
                         if a != b)
            mismatched.append((r.rid, first))
    print(f"{label} reference: {len(reqs) - len(mismatched)}/{len(reqs)} "
          f"requests token-identical ({time.perf_counter() - t0:.1f} s)")
    check(not mismatched, f"tokens differ from generate_reference "
          f"(rid, first position): {mismatched}")
    return {"wall_s": wall, "launches": launches, "graphs": graphs,
            "prefill_variants": variants, "decode_variants": dvariants,
            "prefill_rounds": eng.prefill_rounds,
            "decode_steps": eng.decode_steps,
            "preemptions": res.metrics.num_preemptions,
            "trie_hits": res.swap_stats["trie_hits"],
            "tokens": sum(len(o) for o in res.outputs.values()),
            "swap_stats": res.swap_stats,
            "recovery_stats": res.recovery_stats,
            "partial_preempts": res.metrics.num_partial_preempts,
            "swaps": res.metrics.num_swaps,
            "outputs": res.outputs, "references": refs}


def timed_txn(eng):
    """Wrap the engine's ``_begin_txn`` and ``_commit`` with the host
    clock: seconds per call, for the transaction's host cost per step."""
    spent = {"_begin_txn": [], "_commit": []}
    for name in spent:
        def wrapped(*a, fn=getattr(eng, name), out=spent[name]):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                out.append(time.perf_counter() - t0)
        setattr(eng, name, wrapped)
    return spent


def quantiles(xs, qs=(0.0, 0.5, 0.9, 1.0)):
    xs = sorted(xs)
    return [xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))] for q in qs]


def straggler_ratios(res, factor=3.0):
    """Each batch's measured wall over its priced dt (``t_end - t_start``,
    the h100 cost model), and how many a ``StragglerMonitor`` of
    ``factor`` would flag (it also floors the deadline at 1e-4 s)."""
    ratios = [b.wall_s / (b.t_end - b.t_start) for b in res.metrics.batches
              if b.t_end > b.t_start]
    flagged = sum(b.wall_s > max(factor * (b.t_end - b.t_start), 1e-4)
                  for b in res.metrics.batches)
    return {"batches": len(res.metrics.batches), "min_p50_p90_max":
            quantiles(ratios), "flagged_at_3": flagged}


def phase_serve_bf16(torch, pa, cfg, params, swap=False, faults=None,
                     clean=None):
    """Phase 4 (``smoke_server``), phase 14's bf16 run under swap (with
    the same workload under recompute and no demotion beside it, the step
    transaction's host cost and the straggler ratio), or phase 18's under
    ``faults`` beside phase 14's reading (``clean``)."""
    from repro_torch.launch.serve import smoke_server, smoke_swap_server
    if faults is not None:
        eng, reqs = smoke_swap_server(cfg, params, device=DEVICE,
                                      faults=faults)
    else:
        eng, reqs = (smoke_swap_server if swap else smoke_server)(
            cfg, params, device=DEVICE)
    label = ("bf16 faulted swap serve" if faults is not None
             else "bf16 swap serve" if swap else "bf16 serve")
    spent = timed_txn(eng) if swap and faults is None else None
    torch.cuda.synchronize()
    zero_counts(pa.paged_decode_cuda, pa.paged_prefill_cuda)
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_graph_run(eng, before, label)
    launches = {"paged_decode": pa.paged_decode_cuda.launches,
                "paged_prefill": pa.paged_prefill_cuda.launches}
    variants = dict(pa.paged_prefill_cuda.launches_by_variant)
    dvariants = dict(pa.paged_decode_cuda.launches_by_variant)
    L = cfg.num_layers
    tokens = sum(len(o) for o in res.outputs.values())
    print(f"{label}: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tok/s (phases {res.phase_stats}); "
          f"{eng.prefill_rounds} prefill rounds, {eng.decode_steps} decode "
          f"steps; launches {launches}, paged_prefill by variant {variants},"
          f" paged_decode by variant {dvariants}")
    check(variants == {"wgmma": L * eng.prefill_rounds, "mma_3xtf32": 0}
          and eng.prefill_rounds > 0,
          f"bf16 paged_prefill launches by variant {variants}, expected "
          f"{L} x {eng.prefill_rounds} through wgmma and none other")
    check(launches["paged_decode"] == L * eng.decode_steps > 0,
          f"paged_decode launched {launches['paged_decode']} times, "
          f"expected {L} x {eng.decode_steps}")
    check(dvariants == {"split_mma": launches["paged_decode"],
                        "split_simt": 0},
          f"bf16 paged_decode launches by variant {dvariants}: every one "
          "should be the tensor-core kernel")
    check(all(r.finished for r in reqs), "unfinished requests")
    out = {"wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
           "graphs": graphs, "decode_step_ms": decode_step_ms(res),
           "outputs": res.outputs,
           "phase_stats": res.phase_stats, "pool_pages":
           int(eng.k_pools.shape[1]), "launches": launches,
           "prefill_variants": variants, "decode_variants": dvariants,
           "prefill_rounds": eng.prefill_rounds,
           "decode_steps": eng.decode_steps}
    if faults is not None:
        check_drained(eng, label)
        rec = recovery_summary(res)
        print(f"  {label}: {tokens / wall:.1f} tok/s beside phase 14's "
              f"fault-free {clean['tok_per_s']:.1f}; recovery {rec}; "
              f"swap counts {swap_summary(res)}")
        out.update(recovery=rec, counts=swap_summary(res),
                   clean_tok_per_s=clean["tok_per_s"])
        return out
    if swap:
        check_swapped(eng, res, label)
        steps = len(spent["_begin_txn"])
        txn = {k: {"calls": len(v), "total_s": sum(v),
                   "us_per_step": 1e6 * sum(v) / max(1, steps),
                   "us_p50": 1e6 * quantiles(v, (0.5,))[0]}
               for k, v in spent.items()}
        strag = straggler_ratios(res)
        print(f"  {label}: {tokens / wall:.1f} tok/s; step transaction "
              f"on the host clock: "
              + "; ".join(f"{k} {v['us_per_step']:.1f} us per step "
                          f"(median {v['us_p50']:.1f} us, {v['calls']} "
                          f"calls, {v['total_s']:.4f} s)"
                          for k, v in txn.items())
              + f" of {wall:.3f} s; wall / priced dt per batch "
              f"(min, p50, p90, max) {strag['min_p50_p90_max']}: "
              f"straggler_factor 3.0 would flag {strag['flagged_at_3']} of "
              f"{strag['batches']} batches")
        out.update(txn_host=txn, straggler=strag)
        walls = {k: v for k, v in res.swap_stats.items()
                 if k.startswith("wall_")}
        print(f"  {label}: swap counts {swap_summary(res)}; host walls "
              f"{walls}; drains on swap-in "
              f"{res.swap_stats['drains_on_swapin']}")
        out.update(swap_stats=res.swap_stats, counts=swap_summary(res))
        # the same workload under recompute, with no host tier: a reading
        # beside it, not a target
        eng2, reqs2 = smoke_swap_server(cfg, params, device=DEVICE,
                                        preempt_mode="recompute",
                                        demotion=False)
        torch.cuda.synchronize()
        before = graph_counts(eng2)
        t0 = time.perf_counter()
        res2 = eng2.run(reqs2)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        check_graph_run(eng2, before, "bf16 recompute serve")
        tokens2 = sum(len(o) for o in res2.outputs.values())
        check(all(r.finished for r in reqs2), "unfinished requests")
        print(f"  the same workload under recompute, no demotion: {tokens2} "
              f"tokens in {wall2:.3f} s = {tokens2 / wall2:.1f} tok/s; "
              f"counts {swap_summary(res2)}; {eng2.prefill_rounds} prefill "
              f"rounds, {eng2.decode_steps} decode steps")
        out["recompute"] = {"wall_s": wall2, "tokens": tokens2,
                            "tok_per_s": tokens2 / wall2,
                            "counts": swap_summary(res2),
                            "prefill_rounds": eng2.prefill_rounds,
                            "decode_steps": eng2.decode_steps}
    return out


# --------------------------------------------------------------------- #
# phase 4: timing at the serving shapes
# --------------------------------------------------------------------- #

#: MB that ``time_ms`` writes before each timed call to flush the L2
FLUSH_MB = 256


def time_ms(torch, fn, iters=30, warm=3) -> float:
    """Mean device time of ``fn`` from CUDA events around each call,
    with the 50 MB L2 flushed (a 256 MB write) before each."""
    flush = torch.empty(FLUSH_MB * 256 * 1024, dtype=torch.float32,
                        device=DEVICE)
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def bound(nbytes: float, ops: float, dtype: str):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def attention_bound(nbytes: float, ops: float, dtype: str) -> dict:
    """B2's, B3's and the grouped MoE kernels' bound: in bf16 ``bound``;
    in fp32 the work as their 3xTF32 kernels do it (``TF32_PRODUCTS`` TF32 products for each
    product, at the TF32 rate), with the fp32 CUDA cores' bound beside
    it as ``bound_ms_fp32_cores``."""
    if dtype != "float32":
        b_ms, b_by = bound(nbytes, ops, dtype)
        return dict(bound_ms=b_ms, bound_by=b_by)
    b_ms, b_by = bound(nbytes, TF32_PRODUCTS * ops, "tf32")
    return dict(bound_ms=b_ms, bound_by=b_by,
                bound_ms_fp32_cores=bound(nbytes, ops, "float32")[0])


#: the SDPA backends in the order tried for the fp32 yardstick
SDPA_ORDER = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
              "MATH")


def sdpa_yardstick(torch, dtype: str, *args, **kw) -> dict:
    """``scaled_dot_product_attention(*args, **kw)`` timed as a yardstick
    (the port never calls it).  In fp32 it is pinned with
    ``torch.nn.attention.sdpa_kernel`` to the first backend of
    ``SDPA_ORDER`` that takes these inputs, and timed unpinned beside it
    (``library_ms_unpinned``); bf16 runs unpinned, as before."""
    import torch.nn.functional as F
    call = lambda: F.scaled_dot_product_attention(*args, **kw)  # noqa: E731
    if dtype != "float32":
        return dict(library_ms=time_ms(torch, call))
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for name in SDPA_ORDER:
        backend = getattr(SDPBackend, name)
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")   # why a backend declines
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        with sdpa_kernel([backend]):   # entered once, outside the events
            pinned = time_ms(torch, call)
        return dict(library_ms=pinned, sdpa_backend=name,
                    library_ms_unpinned=time_ms(torch, call))
    raise RuntimeError("no SDPA backend takes these inputs")


def pool_slots_read(bt, lens, page: int) -> int:
    """Distinct pool slots (page id, in-page offset) below each row's
    length: the K/V positions the function must read.  Prefix pages that
    several rows map (registry attaches) count once."""
    slots = set()
    for row, n in zip(bt.tolist(), lens):
        for pos in range(min(n, len(row) * page)):
            slots.add((row[pos // page], pos % page))
    return len(slots)


def time_decode(torch, pa, ref, case, dtype):
    import torch.nn.functional as F
    q, kp, vp, bt, cl = case
    B, H, D = q.shape
    P, page, Hkv, _ = kp.shape
    G = H // Hkv
    es = kp.element_size()
    ctx = cl.tolist()
    nbytes = (2 * q.numel() * es + bt.numel() * 4 + cl.numel() * 4
              + pool_slots_read(bt, ctx, page) * Hkv * D * 2 * es)
    ops = sum(ctx) * Hkv * G * D * 4
    b_ms, b_by = bound(nbytes, ops, dtype)
    ms = time_ms(torch, lambda: pa.paged_decode_cuda(*case))
    plain = time_ms(torch, lambda: ref.paged_decode_reference(*case))
    # library yardstick: SDPA over K/V gathered dense beforehand
    S = -(-max(ctx) // page) * page
    kd = kp[bt.long()].reshape(B, -1, Hkv, D)[:, :S].transpose(1, 2)
    vd = vp[bt.long()].reshape(B, -1, Hkv, D)[:, :S].transpose(1, 2)
    kd, vd = kd.contiguous(), vd.contiguous()
    mask = (torch.arange(S, device=DEVICE)[None] < cl[:, None])[:, None, None]
    qd = q[:, :, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qd, kd, vd, attn_mask=mask, enable_gqa=True)
    lib_ms = time_ms(torch, lib)
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, bytes=nbytes, ops=ops, dtype=dtype,
                shape=list(q.shape), kv_heads=Hkv)


def time_prefill(torch, pa, ref, case, dtype):
    q, k, v, kp, vp, bt, st, ln = case
    B, c, H, D = q.shape
    P, page, Hkv, _ = kp.shape
    G = H // Hkv
    es = kp.element_size()
    starts, lengths = st.tolist(), ln.tolist()
    kv_rows = pool_slots_read(bt, starts, page) + sum(lengths)
    nbytes = (2 * q.numel() * es + 2 * k.numel() * es
              + kv_rows * Hkv * D * 2 * es + (bt.numel() + 2 * B) * 4)
    ops = sum(sum(s + r + 1 for r in range(n)) for s, n in
              zip(starts, lengths)) * Hkv * G * D * 4
    ms = time_ms(torch, lambda: pa.paged_prefill_cuda(*case))
    plain = time_ms(torch, lambda: ref.paged_prefill_reference(*case))
    # library yardstick: SDPA over [prefix pages ++ chunk] gathered dense
    S = max(s + c for s in starts)
    kg = kp[bt.long()].reshape(B, -1, Hkv, D).clone()
    vg = vp[bt.long()].reshape(B, -1, Hkv, D).clone()
    for b in range(B):
        kg[b, starts[b]:starts[b] + c] = k[b]
        vg[b, starts[b]:starts[b] + c] = v[b]
    kd = kg[:, :S].transpose(1, 2).contiguous()
    vd = vg[:, :S].transpose(1, 2).contiguous()
    qd = q.transpose(1, 2).contiguous()
    qpos = st[:, None] + torch.arange(c, device=DEVICE)[None]
    mask = (torch.arange(S, device=DEVICE)[None, None] <= qpos[:, :, None])
    mask = mask[:, None]
    lib = sdpa_yardstick(torch, dtype, qd, kd, vd, attn_mask=mask,
                         enable_gqa=True)
    return dict(ms=ms, plain_ms=plain, **attention_bound(nbytes, ops, dtype),
                **lib, bytes=nbytes, ops=ops, dtype=dtype)


# --------------------------------------------------------------------- #
# phase 5: the flash-attention kernel against its plain version
# --------------------------------------------------------------------- #

def flash_case(inp, B, S, H, Hkv, D, dtype):
    return (inp.randn(B, S, H, D, dtype=dtype),
            inp.randn(B, S, Hkv, D, dtype=dtype),
            inp.randn(B, S, Hkv, D, dtype=dtype))


def check_flash(torch, fa, fref, case, dtype, what, **kw) -> float:
    before = dict(fa.flash_attention_cuda.launches_by_variant)
    got = fa.flash_attention_cuda(*case, **kw)
    one_launch_of(fa.flash_attention_cuda, before, dtype, what)
    want = fref.attention_reference(*case, **kw)
    torch.cuda.synchronize()
    check(got.dtype == case[0].dtype and got.shape == case[0].shape,
          f"{what}: output {got.dtype} {tuple(got.shape)}")
    return compare(torch, got, want, dtype, what)


#: (B, S, H, Hkv, D) of the full prefill: TinyLlama-1.1B at S=512
FLASH_MAIN = (2, 512, 32, 4, 64)
#: the same heads at S=2048
FLASH_LONG = (1, 2048, 32, 4, 64)


def phase_flash_kernel(torch, fa, fref):
    inp = Inputs(torch, 3)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for shape in [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64),
                      (1, 128, 8, 1, 128), (2, 100, 4, 2, 64),
                      (1, 512, 2, 2, 128), FLASH_MAIN,
                      (2, 512, 15, 5, 64),        # SmolLM-360M, G = 3
                      (1, 37, 6, 2, 128), (2, 37, 15, 5, 64),   # ragged S
                      (1, 200, 6, 3, 128), FLASH_LONG]:
            name = "flash B{} S{} H{} Hkv{} D{} {}".format(*shape, dtype)
            errs[name] = check_flash(torch, fa, fref,
                                     flash_case(inp, *shape, dtype), dtype,
                                     name)
        for S, kw in [(256, dict(window=16)), (256, dict(window=64)),
                      (128, dict(prefix_len=32)),
                      (256, dict(prefix_len=200)),    # above the diagonal
                      (256, dict(window=16, prefix_len=48)),
                      (100, dict(causal=False)),
                      (700, dict(window=100)),        # whole tiles skipped
                      (500, dict(window=130, prefix_len=70)),
                      (37, dict(causal=False)), (37, {})]:
            name = f"flash S{S} {kw} {dtype}"
            errs[name] = check_flash(torch, fa, fref,
                                     flash_case(inp, 1, S, 4, 2, 64, dtype),
                                     dtype, name, **kw)
    main = "flash B{} S{} H{} Hkv{} D{}".format(*FLASH_MAIN)
    errs["main_float32"] = errs[main + " float32"]
    errs["main_bfloat16"] = errs[main + " bfloat16"]
    print(f"flash_attention: {len(errs) - 2} comparisons with the plain "
          f"version pass (rtol=atol 2e-5 fp32, 2e-2 bf16); full-prefill "
          f"shapes max abs err fp32 {errs['main_float32']:.3g}, bf16 "
          f"{errs['main_bfloat16']:.3g}")
    return errs


# --------------------------------------------------------------------- #
# phase 6: full prefill at full width
# --------------------------------------------------------------------- #

#: fp32 logits and cache of the 22-layer model, flash against reference:
#: the two sum each softmax in another order, and the difference grows
#: through the layers; 1e-3 is ~100x what a layer contributes
PREFILL_TOL = dict(rtol=1e-3, atol=1e-3)


def phase_full_prefill(torch, fa, M, cfg, params):
    from repro_torch.serving import generate_reference
    B, S = FLASH_MAIN[:2]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEVICE)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=DEVICE).tolist() for n in (37, 200, 448)]
    new_tokens, cache_len = 16, 512
    torch.cuda.synchronize()
    zero_counts(fa.flash_attention_cuda)
    t0 = time.perf_counter()
    fl_logits, fl_cache = M.prefill(cfg, params, {"tokens": toks},
                                    cache_len=cache_len, impl="flash")
    flash_tokens = [generate_reference(cfg, params, p, new_tokens,
                                       cache_len=cache_len, impl="flash",
                                       device=DEVICE) for p in prompts]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    variants = dict(fa.flash_attention_cuda.launches_by_variant)
    prefill_calls = 1 + len(prompts)
    L = cfg.num_layers
    check(launches == L * prefill_calls,
          f"flash_attention launched {launches} times, expected {L} x "
          f"{prefill_calls}")
    check(variants == {"wgmma": 0, "mma_3xtf32": launches},
          f"fp32 flash_attention launches by variant {variants}: every one "
          "should be the 3xTF32 kernel")
    ref_logits, ref_cache = M.prefill(cfg, params, {"tokens": toks},
                                      cache_len=cache_len)
    ref_tokens = [generate_reference(cfg, params, p, new_tokens,
                                     cache_len=cache_len, device=DEVICE)
                  for p in prompts]
    err = {}
    for name, got, want in [("logits", fl_logits, ref_logits),
                            ("k", fl_cache["k"], ref_cache["k"]),
                            ("v", fl_cache["v"], ref_cache["v"])]:
        d = (got - want).abs()
        bad = d > PREFILL_TOL["atol"] + PREFILL_TOL["rtol"] * want.abs()
        check(bool(torch.isfinite(got).all()), f"prefill {name} non-finite")
        check(not bool(bad.any()), f"prefill {name}: flash vs reference max "
              f"abs err {d.max().item():.3g}")
        err[name] = d.max().item()
    check(torch.equal(fl_cache["index"], ref_cache["index"]), "cache index")
    same = torch.equal(torch.argmax(fl_logits, -1), torch.argmax(ref_logits,
                                                                 -1))
    check(same, "prefill argmax differs between flash and reference")
    check(flash_tokens == ref_tokens, "generate_reference tokens differ: "
          f"flash {flash_tokens} reference {ref_tokens}")
    print(f"full prefill (TinyLlama-1.1B fp32, B={B}, S={S}): flash vs "
          f"reference max abs err logits {err['logits']:.3g}, k "
          f"{err['k']:.3g}, v {err['v']:.3g} (rtol=atol 1e-3); "
          f"generate_reference tokens identical for prompts of "
          f"{[len(p) for p in prompts]} tokens ({new_tokens} new each); "
          f"flash_attention launches {launches} = {L} x {prefill_calls}; "
          f"{wall:.2f} s")
    return {"max_abs_err": err, "launches": launches,
            "variants": variants, "prefill_calls": prefill_calls,
            "wall_s": wall, "tokens": flash_tokens}


def rel_l2(torch, got, want) -> float:
    return (torch.linalg.vector_norm((got - want).float())
            / torch.linalg.vector_norm(want.float())).item()


#: bf16 full prefill: flash's logits and cache may be at most this many
#: times further from the fp32 truth (the reference attention in fp32 on the
#: same bf16 weights) than the bf16 reference attention's are.  Both bf16
#: runs round the same activations and weights to bf16 and differ only in
#: where the attention rounds (the kernel rounds unnormalised P, the
#: reference the normalised weights), which are errors of one size; a
#: fault in the kernel (a wrong mask, tile or row) moves the logits by
#: far more than bf16's own noise.
BF16_PREFILL_RATIO = 2.0


def phase_full_prefill_bf16(torch, fa, M, cfg16, params16):
    """TinyLlama-1.1B in bf16 at B=2, S=512: ``prefill(impl="flash")``
    against ``impl="reference"``, both held against the reference in fp32
    on the same weights."""
    B, S = FLASH_MAIN[:2]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)
    toks = torch.randint(0, cfg16.vocab_size, (B, S), generator=gen,
                         device=DEVICE)
    torch.cuda.synchronize()
    zero_counts(fa.flash_attention_cuda)
    t0 = time.perf_counter()
    fl, fl_cache = M.prefill(cfg16, params16, {"tokens": toks}, cache_len=S,
                             impl="flash")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    variants = dict(fa.flash_attention_cuda.launches_by_variant)
    L = cfg16.num_layers
    check(variants == {"wgmma": L, "mma_3xtf32": 0} and launches == L,
          f"bf16 full prefill: flash_attention launches by variant "
          f"{variants}, expected {L} through wgmma")
    ref16, ref_cache = M.prefill(cfg16, params16, {"tokens": toks},
                                 cache_len=S)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    truth, truth_cache = M.prefill(cfg32, _tree_to(params16, torch.float32),
                                   {"tokens": toks}, cache_len=S)
    for name, t in (("flash", fl), ("reference", ref16)):
        check(bool(torch.isfinite(t.float()).all()), f"bf16 prefill {name}: "
              "non-finite logits")
        check(t.shape == truth.shape and t.dtype == ref16.dtype,
              f"bf16 prefill {name}: {t.dtype} {tuple(t.shape)}")
    err = {}          # rel L2 to the fp32 truth: (flash, bf16 reference)
    for name in ("logits", "k", "v"):
        got, want, tr = ((fl, ref16, truth) if name == "logits" else
                         (fl_cache[name], ref_cache[name], truth_cache[name]))
        err[name] = (rel_l2(torch, got, tr), rel_l2(torch, want, tr))
    e_pair = rel_l2(torch, fl, ref16)
    agree = (torch.argmax(fl.float(), -1) == torch.argmax(ref16.float(), -1)
             ).float().mean().item()
    print(f"full prefill (TinyLlama-1.1B bf16, B={B}, S={S}): rel L2 to the "
          f"fp32 reference, flash / bf16 reference: "
          + ", ".join(f"{n} {a:.4g} / {b:.4g}" for n, (a, b) in err.items())
          + f" (flash may be {BF16_PREFILL_RATIO}x); logits flash vs bf16 "
          f"reference rel L2 {e_pair:.4g}, max abs "
          f"{(fl.float() - ref16.float()).abs().max().item():.3g}, argmax "
          f"agreement {agree:.3f}; flash_attention launches {variants} "
          f"({wall:.2f} s)")
    for name, (a, b) in err.items():
        check(a <= BF16_PREFILL_RATIO * b,
              f"bf16 prefill {name}: flash {a:.4g} from the fp32 reference, "
              f"beyond {BF16_PREFILL_RATIO} x the bf16 reference's {b:.4g}")
    return {"rel_l2_to_fp32": err, "rel_l2_flash_vs_reference": e_pair,
            "argmax_agreement": agree, "launches": launches,
            "variants": variants, "wall_s": wall}


# --------------------------------------------------------------------- #
# phase 7: the trainer at full width
# --------------------------------------------------------------------- #

def phase_train(torch):
    import logging
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, init_adamw,
                                      make_train_step)
    logging.getLogger("repro_torch.train").setLevel(logging.WARNING)
    args = T.parse_args(T.SMOKE_ARGS + ["--device", DEVICE])
    hist = T.train(args)
    losses = [h["loss"] for h in hist]
    for h in hist:
        check(all(math.isfinite(h[k]) for k in ("loss", "grad_norm")),
              f"non-finite training step: {h}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    steady = sorted(h["seconds"] for h in hist[1:])
    step_s = steady[len(steady) // 2]
    tok_s = args.batch * args.seq / step_s
    print(f"train (SmolLM-360M bf16, fp32 AdamW, B={args.batch}, "
          f"S={args.seq}): losses {[round(x, 4) for x in losses]}, grad "
          f"norms {[round(h['grad_norm'], 3) for h in hist]}; median "
          f"step {step_s:.3f} s after the first = {tok_s:.0f} tokens/s")

    cfg = dataclasses.replace(get_config("smollm-360m"), dtype="float32")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    batch = {k: torch.from_numpy(v).to(DEVICE, torch.long)
             for k, v in batch_for_step(dc, 0).items()}
    opt = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    mb_loss = {}
    for mb in (1, 2):
        _, _, m = make_train_step(cfg, opt, microbatches=mb)(
            params, init_adamw(params), batch)
        mb_loss[mb] = float(m["loss"])
    check(abs(mb_loss[2] - mb_loss[1]) <= 1e-4 * abs(mb_loss[1]),
          f"microbatch losses differ: {mb_loss}")
    with torch.no_grad():
        two = {k: v[:2] for k, v in
               batch_for_step(DataConfig(cfg.vocab_size, 512, 2), 1).items()}
        two = {k: torch.from_numpy(v).to(DEVICE, torch.long)
               for k, v in two.items()}
        fl = float(M.train_loss(cfg, params, two, impl="flash"))
        ref = float(M.train_loss(cfg, params, two))
    check(abs(fl - ref) <= 1e-4 * abs(ref),
          f"train_loss flash {fl} vs reference {ref}")
    print(f"train fp32: loss with 1 / 2 microbatches {mb_loss[1]:.7f} / "
          f"{mb_loss[2]:.7f} (rtol 1e-4); train_loss flash {fl:.7f} vs "
          f"reference {ref:.7f} (rtol 1e-4)")
    return {"losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
            "step_s": [h["seconds"] for h in hist], "tok_per_s": tok_s,
            "microbatch_loss": mb_loss, "train_loss_flash": fl,
            "train_loss_reference": ref}


# --------------------------------------------------------------------- #
# phase 8: timing the flash-attention kernel
# --------------------------------------------------------------------- #

def time_flash(torch, fa, fref, case, dtype, window=0, prefix_len=0):
    """B3 on ``case``, causal (with a sliding ``window`` or a
    bidirectional ``prefix_len``, SDPA given the boolean mask), beside its
    plain version, SDPA and its bound (the pairs the mask keeps)."""
    q, k, v = case
    B, S, H, D = q.shape
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es
    opt = dict(window=window, prefix_len=prefix_len)
    mask = fref.visible(S, device=DEVICE, **opt)
    ops = 4 * D * int(mask.sum()) * B * H
    ms = time_ms(torch, lambda: fa.flash_attention_cuda(*case, **opt))
    plain = time_ms(torch, lambda: fref.attention_reference(*case, **opt))
    qt, kt, vt = (t.transpose(1, 2) for t in case)      # views, no copy
    kw = (dict(attn_mask=mask) if window or prefix_len
          else dict(is_causal=True))
    lib = sdpa_yardstick(torch, dtype, qt, kt, vt, enable_gqa=True, **kw)
    return dict(ms=ms, plain_ms=plain, **attention_bound(nbytes, ops, dtype),
                **lib, bytes=nbytes, ops=ops, shape=list(q.shape),
                kv_heads=k.shape[2], dtype=dtype, window=window,
                prefix_len=prefix_len)


# --------------------------------------------------------------------- #
# phase 9: the WKV6 kernel against its plain versions
# --------------------------------------------------------------------- #

#: tests/test_kernels.py's WKV6 tolerances (rtol = atol)
WKV_TOL, WKV_TOL_EXTREME = 3e-5, 1e-4
#: (S, H, D) of an engine prefill round of RWKV6-7B (chunk 64, 64 heads
#: of 64); its B is the engine's slot count: 4 in the smoke engine, 8 in
#: EngineConfig's default
WKV_ROUND = (64, 64, 64)
#: the shapes B4 is timed at, (B, S, H, D, s0): the engine round from a
#: state at both slot counts, and the full prefill of one 512-token prompt
WKV_SHAPES = {"round_B4": (4, *WKV_ROUND, True),
              "round_B8": (8, *WKV_ROUND, True),
              "prefill_B1_S512": (1, 512, 64, 64, False)}
#: (B, S, H, D) on each side of B4's grid rule (``rwkv_scan.columns``):
#: D = 64 moves from 16-step to 8-step tiles past 66 heads and from 32 to
#: 64 columns per CTA past 264; D = 32 and D = 8 have one split each; S is
#: off the tile (tests/test_torch_cuda_kernels.py's WKV_EDGES)
WKV_EDGES = [(1, 37, 66, 64), (1, 37, 67, 64), (4, 21, 66, 64),
             (5, 21, 53, 64), (1, 5, 265, 64), (8, 1, 64, 64),
             (2, 37, 4, 32), (3, 13, 5, 8)]


def wkv_case(torch, inp, B, S, H, D, wval=None, s0=False):
    """tests/test_kernels.py's distributions: r, k, v ~ 0.3 N(0, 1), w in
    (0.45, 0.95), u ~ 0.1 N(0, 1); ``wval`` a constant decay (u = 0)."""
    r, k, v = (0.3 * inp.randn(B, S, H, D, dtype="float32")
               for _ in range(3))
    if wval is None:
        w = torch.sigmoid(inp.randn(B, S, H, D, dtype="float32")) * 0.5 \
            + 0.45
        u = 0.1 * inp.randn(H, D, dtype="float32")
    else:
        w = torch.full((B, S, H, D), wval, device=DEVICE)
        u = torch.zeros((H, D), device=DEVICE)
    st = inp.randn(B, H, D, D, dtype="float32") if s0 else None
    return r, k, v, w, u, st


def check_wkv(torch, wkv, wref, case, chunk, tol, what) -> float:
    r, k, v, w, u, s0 = case
    y, s = wkv.wkv6_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    worst = 0.0
    for form, (wy, ws) in (
            ("chunked", wref.wkv6_chunked_ref(r, k, v, w, u, s0, chunk)),
            ("per-token", wref.wkv6_reference(r, k, v, w, u, s0))):
        for name, got, want in (("y", y, wy), ("S_last", s, ws)):
            err = (got - want).abs()
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
            bad = err > tol + tol * want.abs()
            check(not bool(bad.any()), f"{what}: {name} vs the {form} form: "
                  f"max abs err {err.max().item():.3g} beyond rtol=atol={tol}")
            worst = max(worst, err.max().item())
    return worst


def phase_wkv_kernel(torch, wkv, wref, pick_chunk, nslots):
    inp = Inputs(torch, 5)
    errs = {}
    for B, S, H, D, chunk in [(1, 64, 2, 32, 16), (2, 128, 4, 32, 64),
                              (1, 96, 2, 64, 32), (2, 64, 2, 32, 64)]:
        name = f"wkv6 B{B} S{S} H{H} D{D} chunk{chunk}"
        errs[name] = check_wkv(torch, wkv, wref,
                               wkv_case(torch, inp, B, S, H, D), chunk,
                               WKV_TOL, name)
    for wval in (0.01, 0.999):
        name = f"wkv6 w={wval}"
        errs[name] = check_wkv(torch, wkv, wref,
                               wkv_case(torch, inp, 1, 64, 2, 32, wval=wval),
                               16, WKV_TOL_EXTREME, name)
    for S in (37, 200, 448, 127):
        name = f"wkv6 S{S} chunk{pick_chunk(S, 64)} s0"
        errs[name] = check_wkv(torch, wkv, wref,
                               wkv_case(torch, inp, 2, S, 4, 64, s0=True),
                               pick_chunk(S, 64), WKV_TOL, name)
    for B in (8, nslots):
        name = "wkv6 B{} S{} H{} D{} s0".format(B, *WKV_ROUND)
        errs[name] = check_wkv(torch, wkv, wref,
                               wkv_case(torch, inp, B, *WKV_ROUND, s0=True),
                               64, WKV_TOL, name)
    errs["main_float32"] = errs[name]
    for B, S, H, D in WKV_EDGES:
        name = f"wkv6 B{B} S{S} H{H} D{D} columns{wkv.columns(B, H, D)} s0"
        errs[name] = check_wkv(torch, wkv, wref,
                               wkv_case(torch, inp, B, S, H, D, s0=True),
                               pick_chunk(S, 64), WKV_TOL, name)
    # padded steps (w = 1, k = 0) leave the state bit for bit as it was;
    # a call split in two with the state carried over, and a repeated
    # call, give the same bits
    r, k, v, w, u, s0 = wkv_case(torch, inp, 4, 40, 64, 64, s0=True)
    y, s = wkv.wkv6_cuda(r, k, v, w, u, s0)
    pad = lambda t, val: torch.cat(  # noqa: E731
        [t, torch.full_like(t[:, :24], val)], dim=1)
    _, sp = wkv.wkv6_cuda(pad(r, 0.5), pad(k, 0.0), pad(v, 0.7), pad(w, 1.0),
                          u, s0)
    part = lambda t, a, b: t[:, a:b].contiguous()  # noqa: E731
    y1, s1 = wkv.wkv6_cuda(*(part(t, 0, 13) for t in (r, k, v, w)), u, s0)
    y2, s2 = wkv.wkv6_cuda(*(part(t, 13, 40) for t in (r, k, v, w)), u, s1)
    y3, s3 = wkv.wkv6_cuda(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    check(torch.equal(sp, s), "wkv6: padded steps changed the state")
    check(torch.equal(torch.cat([y1, y2], dim=1), y) and torch.equal(s2, s),
          "wkv6: a call split in two differs from one call")
    check(torch.equal(y3, y) and torch.equal(s3, s),
          "wkv6: a repeated call differs")
    # every row of a batched call equals that row called alone, though the
    # two calls split the state differently
    r, k, v, w, u, s0 = wkv_case(torch, inp, 8, *WKV_ROUND, s0=True)
    check(wkv.columns(8, 64, 64) != wkv.columns(1, 64, 64),
          "wkv6: the batch test no longer crosses a split edge")
    y, s = wkv.wkv6_cuda(r, k, v, w, u, s0)
    for b in range(8):
        yb, sb = wkv.wkv6_cuda(*(t[b:b + 1].contiguous()
                                 for t in (r, k, v, w)), u,
                               s0[b:b + 1].contiguous())
        check(torch.equal(yb, y[b:b + 1]) and torch.equal(sb, s[b:b + 1]),
              f"wkv6: row {b} of a B=8 call differs from the row alone")
    # two streams at once, neither waiting for the other
    cases = [wkv_case(torch, inp, 4, *WKV_ROUND, s0=True),
             wkv_case(torch, inp, 1, 200, 64, 64)]
    streams = [torch.cuda.Stream() for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        for st, case in zip(streams, cases):
            with torch.cuda.stream(st):
                outs.append(wkv.wkv6_cuda(*case))
    torch.cuda.synchronize()
    for i, (yi, si) in enumerate(outs):
        wy, ws = wref.wkv6_reference(*cases[i % 2])
        for got, want in ((yi, wy), (si, ws)):
            check(bool(((got - want).abs() <= WKV_TOL + WKV_TOL * want.abs())
                       .all()), "wkv6: a call on a second stream disagrees")
        check(torch.equal(yi, outs[i % 2][0]), "wkv6: two-stream repeats "
              "differ")
    print(f"wkv6: {len(errs) - 1} comparisons with both plain versions pass "
          f"(rtol=atol {WKV_TOL}, {WKV_TOL_EXTREME} at the decay extremes); "
          f"engine-round shape max abs err {errs['main_float32']:.3g}; "
          f"padded steps, a split call and a repeat bit-equal; 8 batched "
          f"rows bit-equal to single rows; two streams at once agree")
    return errs


# --------------------------------------------------------------------- #
# phases 10-11: serving RWKV6-7B on the slot plane
# --------------------------------------------------------------------- #

#: a reference top-2 logit gap below which a flipped greedy token is a tie
TIE_GAP = 1e-4
#: depth of the fp32 token check (full width): the random-weight model's
#: own rounding noise in the logits is 6e-5 at 4 layers, 0.15 at 32
RWKV_FP32_LAYERS = 4


def reference_top2_gap(torch, M, cfg, params, prompt, tokens, pos,
                       cache_len=0, impl="reference") -> float:
    """The reference's top-2 logit gap at output position ``pos``, on the
    path ``generate_reference(cache_len=..., impl=...)`` takes (prefill,
    then decode steps fed the reference's own tokens)."""
    toks = torch.tensor([list(prompt)], dtype=torch.long, device=DEVICE)
    logits, cache = M.prefill(cfg, params, {"tokens": toks},
                              cache_len=cache_len, impl=impl)
    for t in tokens[:pos]:
        logits, cache = M.decode_step(
            cfg, params, torch.tensor([t], device=DEVICE), cache, impl=impl)
    top = torch.topk(logits[0, :cfg.vocab_size].float(), 2).values
    return (top[0] - top[1]).item()


def divergences(torch, M, cfg, params, reqs, outputs, refs, **gap_kw):
    """{rid: (first output position where ``outputs`` leaves ``refs``,
    the reference's top-2 logit gap there)} of the requests that differ;
    every request must have the reference's token count."""
    out = {}
    for r in reqs:
        got, want = outputs[r.rid], refs[r.rid]
        check(len(got) == len(want), f"rid {r.rid}: {len(got)} tokens")
        if got != want:
            pos = next(i for i, (a, b) in enumerate(zip(got, want))
                       if a != b)
            out[r.rid] = (pos, reference_top2_gap(
                torch, M, cfg, params, r.prompt, want, pos, **gap_kw))
    return out


def phase_rwkv_serve_fp32(torch, wkv, M, cfg, params, preempt_mode="recompute",
                          faults=None):
    """Phase 10, phase 15's fp32 run with ``preempt_mode="swap"``, or
    phase 19's with ``faults`` too."""
    from repro_torch.launch.serve import rwkv_smoke_server
    from repro_torch.serving import generate_reference
    eng, reqs = rwkv_smoke_server(cfg, params, device=DEVICE,
                                  preempt_mode=preempt_mode, faults=faults)
    check(eng.cache is not None and eng.k_pools is None,
          "the RWKV engine is not on the slot plane")
    L = cfg.num_layers
    torch.cuda.synchronize()
    wkv.wkv6_cuda.launches = 0
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wkv.wkv6_cuda.launches
    graphs = check_graph_run(eng, before, f"RWKV6-7B fp32 {preempt_mode}")
    tokens = sum(len(o) for o in res.outputs.values())
    print(f"RWKV6-7B fp32 serve ({L} layers, d={cfg.d_model}, "
          f"{cfg.ssm_heads} heads x {cfg.ssm_state}): {len(reqs)} requests "
          f"(prompts {[r.input_len for r in reqs]}), {tokens} tokens in "
          f"{wall:.3f} s; {eng.prefill_rounds} prefill rounds, "
          f"{eng.decode_steps} decode steps, preemptions "
          f"{res.metrics.num_preemptions} ({preempt_mode}); wkv6 launches "
          f"{launches}; swap counts {swap_summary(res)}")
    check(launches == L * eng.prefill_rounds > 0,
          f"wkv6 launched {launches} times, expected {L} x "
          f"{eng.prefill_rounds} prefill rounds")
    check(res.metrics.num_preemptions >= 1, "no preemption")
    if faults is not None:
        print(f"  RWKV6-7B fp32 faulted swap serve: recovery "
              f"{recovery_summary(res)}")
        check_drained(eng, "RWKV6-7B fp32 faulted swap serve")
    elif preempt_mode == "swap":
        check_swapped(eng, res, "RWKV6-7B fp32 swap serve", partial=False,
                      demotion=False)
    check(all(r.finished for r in reqs), "unfinished requests")
    t0 = time.perf_counter()
    wkv.wkv6_cuda.launches = 0
    refs = {r.rid: generate_reference(cfg, params, r.prompt, r.output_len,
                                      cache_len=0, device=DEVICE)
            for r in reqs}
    ref_launches = wkv.wkv6_cuda.launches
    check(ref_launches == L * len(reqs),
          f"wkv6 launched {ref_launches} times in generate_reference, "
          f"expected {L} x {len(reqs)} prefills")
    diverged = divergences(torch, M, cfg, params, reqs, res.outputs, refs)
    for rid, (pos, gap) in diverged.items():
        print(f"  rid {rid}: first diverging position {pos}, "
              f"reference top-2 logit gap there {gap:.3g}")
    print(f"fp32 reference: {len(reqs) - len(diverged)}/{len(reqs)} "
          f"requests token-identical; wkv6 launches in generate_reference "
          f"{ref_launches} = {L} x {len(reqs)} ({time.perf_counter() - t0:.1f}"
          f" s)")
    check(all(gap < TIE_GAP for _, gap in diverged.values()),
          f"tokens differ from generate_reference beyond a tie: {diverged}")
    return {"layers": L, "wall_s": wall, "tokens": tokens, "graphs": graphs,
            "launches": launches, "reference_launches": ref_launches,
            "prefill_rounds": eng.prefill_rounds,
            "decode_steps": eng.decode_steps,
            "preemptions": res.metrics.num_preemptions,
            "diverged": diverged, "counts": swap_summary(res),
            "recovery": recovery_summary(res), "outputs": res.outputs,
            "references": refs}


def phase_rwkv_serve_bf16(torch, wkv, cfg, params, preempt_mode="recompute"):
    """Phase 11, or phase 15's bf16 run with ``preempt_mode="swap"``."""
    from repro_torch.launch.serve import rwkv_smoke_server
    eng, reqs = rwkv_smoke_server(cfg, params, device=DEVICE,
                                  preempt_mode=preempt_mode)
    torch.cuda.synchronize()
    wkv.wkv6_cuda.launches = 0
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wkv.wkv6_cuda.launches
    graphs = check_graph_run(eng, before, f"RWKV6-7B bf16 {preempt_mode}")
    check(launches == cfg.num_layers * eng.prefill_rounds > 0,
          f"wkv6 launched {launches} times, expected {cfg.num_layers} x "
          f"{eng.prefill_rounds}")
    tokens = sum(len(o) for o in res.outputs.values())
    decode_walls = [b.wall_s for b in res.metrics.batches
                    if b.num_decode and not b.num_prefill]
    step_ms = decode_step_ms(res)
    print(f"RWKV6-7B bf16 serve ({cfg.num_layers} layers): {tokens} tokens "
          f"in {wall:.3f} s = {tokens / wall:.1f} tok/s; wkv6 launches "
          f"{launches} = {cfg.num_layers} x {eng.prefill_rounds} prefill "
          f"rounds; {eng.decode_steps} decode steps, mean wall of a "
          f"decode-only batch {step_ms:.2f} ms over {len(decode_walls)}; "
          f"phases {res.phase_stats}; {preempt_mode}: swap counts "
          f"{swap_summary(res)}, host walls "
          + str({k: v for k, v in res.swap_stats.items()
                 if k.startswith("wall_")}))
    if preempt_mode == "swap":
        check_swapped(eng, res, "RWKV6-7B bf16 swap serve", partial=False,
                      demotion=False)
    return {"wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
            "launches": launches, "prefill_rounds": eng.prefill_rounds,
            "graphs": graphs, "outputs": res.outputs,
            "decode_steps": eng.decode_steps, "decode_step_ms": step_ms,
            "phase_stats": res.phase_stats, "swap_stats": res.swap_stats,
            "counts": swap_summary(res)}


# --------------------------------------------------------------------- #
# phase 12: timing the WKV6 kernel
# --------------------------------------------------------------------- #

def time_wkv(torch, wkv, wref, case):
    r, k, v, w, u, s0 = case
    B, S, H, D = r.shape
    states = 1 if s0 is None else 2          # s_last, and s0 when given
    nbytes = (5 * r.numel() + u.numel() + states * B * H * D * D) * 4
    ops = 4 * D * D * B * S * H
    b_ms, b_by = bound(nbytes, ops, "float32")
    ms = time_ms(torch, lambda: wkv.wkv6_cuda(*case))
    plain = time_ms(torch, lambda: wref.wkv6_chunked_ref(*case, 64))
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, bytes=nbytes, ops=ops, shape=list(r.shape),
                dtype="float32")


# --------------------------------------------------------------------- #
# phase 13: the swap data plane's transfers against the compute stream
# --------------------------------------------------------------------- #

def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def host_tensor(torch, arr, dtype):
    """A drained host leaf as a tensor of ``dtype`` (bf16 travels as its
    int16 bits)."""
    t = torch.from_numpy(arr)
    return t if t.dtype == dtype else t.view(dtype)


def junk_like(torch, specs, rounds=4):
    """Buffers of the gathered snapshots' sizes, filled on the compute
    stream: if a gathered buffer were released before its copy ended,
    the caching allocator would hand its block to one of these."""
    return [torch.full(shape, 5, dtype=dtype, device=DEVICE)
            for _ in range(rounds) for shape, dtype in specs]


def race_pages(torch, M, cfg, gen):
    """Gather a 304-token run of pool pages and start its copy; before the
    drain, free the pages, give them to another request and overwrite
    them on the compute stream, and fill fresh buffers of the snapshot's
    size.  The drained bytes must be the pre-overwrite ones, and writing
    them into other page ids must give the same bits."""
    from repro_torch.core import make_scheduler
    from repro_torch.launch.serve import SMOKE_ENGINE, SMOKE_M
    from repro_torch.serving import Engine
    eng = Engine(cfg, None, make_scheduler("vllm", SMOKE_M, S=512),
                 SMOKE_ENGINE, device=DEVICE)
    for p in (eng.k_pools, eng.v_pools):
        p.copy_(torch.randn(p.shape, generator=gen, device=DEVICE).to(
            p.dtype))
    pages = eng.allocator.allocate(0, 304)
    want = {"k": eng.k_pools[:, pages].cpu(), "v": eng.v_pools[:, pages].cpu()}
    kv, xfer = eng._gather_pages_device(pages)
    specs = [(t.shape, t.dtype) for t in kv.values()]
    del kv
    eng.allocator.free(0)
    again = eng.allocator.allocate(1, 304)
    ids = eng._link.ids(pages)
    eng.k_pools.index_fill_(1, ids, 3.0)
    eng.v_pools.index_fill_(1, ids, -3.0)
    junk = junk_like(torch, specs)
    host = eng._link.finish(xfer)
    ms = xfer.copy_ms()
    del junk
    dtype = eng.k_pools.dtype
    for k in ("k", "v"):
        check(same_bits(torch, host_tensor(torch, host[k], dtype), want[k]),
              f"pages {cfg.dtype}: drained {k} bytes differ from the "
              "pre-overwrite ones")
    other = eng.allocator.allocate(2, 304)
    eng._restore_pages(other, host)
    torch.cuda.synchronize()
    for k, pool in (("k", eng.k_pools), ("v", eng.v_pools)):
        check(same_bits(torch, pool[:, other].cpu(), want[k]),
              f"pages {cfg.dtype}: restored {k} bits differ")
    return {"bytes": xfer.nbytes, "copy_ms": ms,
            "pages_reused": sorted(again) == sorted(pages)}


def race_slot(torch, M, cfg, gen):
    """The same for one RWKV6 slot (every leaf): gather slot 1 and start
    its copy; before the drain, merge new state into the slot (the slot
    plane's ``_merge``, which writes the leaves in place) and fill fresh
    buffers of the snapshot's size; then restore the drained bytes into
    slot 3."""
    from repro_torch.core import make_scheduler
    from repro_torch.launch.serve import SMOKE_RWKV_ENGINE, SMOKE_RWKV_M
    from repro_torch.serving import Engine
    from repro_torch.serving.host_copy import gather_slot, restore_slot
    eng = Engine(cfg, None, make_scheduler("vllm", SMOKE_RWKV_M, S=512),
                 SMOKE_RWKV_ENGINE, device=DEVICE)
    for k, leaf in eng.cache.items():
        leaf.copy_(torch.arange(leaf.numel(), device=DEVICE).view(
            leaf.shape) * 1000 + 7 if k == "index" else torch.randn(
                leaf.shape, generator=gen, device=DEVICE).to(leaf.dtype))
    ax = {k: 0 if v.dim() == 1 else 1 for k, v in eng.cache.items()}
    want = {k: v.select(ax[k], 1).cpu() for k, v in eng.cache.items()}
    snap = gather_slot(eng.cache, eng._link.ids([1]))
    specs = [(t.shape, t.dtype) for t in snap.values()]
    xfer = eng._link.start(snap)
    del snap
    active = torch.zeros(SMOKE_RWKV_ENGINE.nslots, dtype=torch.bool,
                         device=DEVICE)
    active[1] = True
    eng._merge(active, {k: torch.full_like(v, 9) for k, v in
                        eng.cache.items()})
    junk = junk_like(torch, specs)
    host = eng._link.finish(xfer)
    ms = xfer.copy_ms()
    del junk
    for k, leaf in eng.cache.items():
        got = host_tensor(torch, host[k], leaf.dtype).select(ax[k], 0)
        check(same_bits(torch, got, want[k]), f"slot {cfg.dtype}: drained "
              f"{k} bytes differ from the pre-merge ones")
        check(not same_bits(torch, leaf.select(ax[k], 1).cpu(), want[k]),
              f"slot {cfg.dtype}: the merge did not overwrite {k}")
    restore_slot(eng.cache, eng._link.ids([3]),
                 {k: eng._link.to_device(v, eng.cache[k])
                  for k, v in host.items()})
    torch.cuda.synchronize()
    for k, leaf in eng.cache.items():
        check(same_bits(torch, leaf.select(ax[k], 3).cpu(), want[k]),
              f"slot {cfg.dtype}: restored {k} bits differ")
    return {"bytes": xfer.nbytes, "copy_ms": ms}


def phase_transfer_race(torch, M, get_config):
    from repro_torch.launch.serve import SMOKE_ARCH, SMOKE_RWKV_ARCH
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[f"pages_{dtype}"] = race_pages(torch, M, dataclasses.replace(
            get_config(SMOKE_ARCH), dtype=dtype), gen)
        out[f"slot_{dtype}"] = race_slot(torch, M, dataclasses.replace(
            get_config(SMOKE_RWKV_ARCH), dtype=dtype), gen)
    print("transfer race: page runs (TinyLlama pools, 304 tokens) and one "
          "RWKV6 slot (every leaf), fp32 and bf16: drained bytes equal the "
          "pre-overwrite ones and restore bit for bit; "
          + ", ".join(f"{k} {v['bytes']} B in {v['copy_ms']:.3f} ms"
                      for k, v in out.items()))
    return out


# --------------------------------------------------------------------- #
# phase 16: the host link
# --------------------------------------------------------------------- #

#: (kind, tokens priced by cost_model.swap_time, repetitions)
LINK_KINDS = [("slot RWKV6-7B", 304, 10), ("page run TinyLlama", 304, 20),
              ("one page TinyLlama", 16, 50)]


def time_link(torch, link, leaves, restore, reps):
    """Device-to-host: CUDA events on the copy stream around each copy,
    and the host clock from the gather to the end of the drain.
    Host-to-device: CUDA events on the compute stream around the
    non-blocking copies of ``restore``, and the host clock to their end."""
    out_ms, out_wall, in_ms, in_wall = [], [], [], []
    for i in range(reps + 2):                  # 2 warm-up rounds
        t0 = time.perf_counter()
        xfer = link.start(leaves())
        host = link.finish(xfer)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1 = time.perf_counter()
        e0.record()
        restore(host)
        e1.record()
        e1.synchronize()
        wall_in = time.perf_counter() - t1
        link.release()              # as the engine's step-end drain does
        if i >= 2:
            out_ms.append(xfer.copy_ms())
            out_wall.append(1e3 * wall)
            in_ms.append(e0.elapsed_time(e1))
            in_wall.append(1e3 * wall_in)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return xfer.nbytes, mean(out_ms), mean(out_wall), mean(in_ms), \
        mean(in_wall)


def time_pinned_alloc(torch, specs, n):
    """Host ms to allocate a snapshot's pinned buffers: while every
    earlier one is still held (each a fresh pinned allocation, as entries
    that stay in the store need), and when each is freed before the next
    (the host allocator's cache hands the block back)."""
    held = []
    t0 = time.perf_counter()
    for _ in range(n):
        held.append([torch.empty(shape, dtype=dtype, pin_memory=True)
                     for shape, dtype in specs])
    fresh = 1e3 * (time.perf_counter() - t0) / n
    del held
    t0 = time.perf_counter()
    for _ in range(n):
        bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                for shape, dtype in specs]
        del bufs
    return fresh, 1e3 * (time.perf_counter() - t0) / n


def phase_host_link(torch, M, get_config):
    from repro_torch.core import TheoreticalCostModel, get_hardware
    from repro_torch.launch.serve import SMOKE_ARCH, SMOKE_RWKV_ARCH
    from repro_torch.serving.host_copy import (HostLink, gather_pages,
                                               gather_slot)
    from repro_torch.serving.paged_plane import init_pools
    hw = get_hardware("h100")
    link = HostLink(DEVICE)
    cfg = dataclasses.replace(get_config(SMOKE_ARCH), dtype="bfloat16")
    rcfg = dataclasses.replace(get_config(SMOKE_RWKV_ARCH), dtype="bfloat16")
    kp, vp = init_pools(cfg, 128, 16, device=DEVICE)
    kp.normal_()
    vp.normal_()
    cache = M.init_cache(rcfg, 4, 0, device=DEVICE)
    for leaf in cache.values():
        leaf.copy_(torch.randn(leaf.shape, device=DEVICE).to(leaf.dtype))
    run, page = link.ids(list(range(3, 22))), link.ids([40])
    slot = link.ids([1])

    def to_pages(ids):
        def restore(host):
            for k, pool in (("k", kp), ("v", vp)):
                link.to_device(host[k], pool)
        return restore

    def to_slot(host):
        for k, leaf in cache.items():
            link.to_device(host[k], leaf)

    cases = {"slot RWKV6-7B": (lambda: gather_slot(cache, slot), to_slot,
                               TheoreticalCostModel(rcfg, hw)),
             "page run TinyLlama": (lambda: gather_pages(kp, vp, run),
                                    to_pages(run),
                                    TheoreticalCostModel(cfg, hw)),
             "one page TinyLlama": (lambda: gather_pages(kp, vp, page),
                                    to_pages(page),
                                    TheoreticalCostModel(cfg, hw))}
    out = {}
    for kind, n, reps in LINK_KINDS:
        leaves, restore, cm = cases[kind]
        nbytes, o_ms, o_wall, i_ms, i_wall = time_link(torch, link, leaves,
                                                       restore, reps)
        fresh, cached = time_pinned_alloc(
            torch, [(t.shape, t.dtype) for t in leaves().values()], reps)
        priced = 1e3 * cm.swap_time(n)
        out[kind] = {"bytes": nbytes, "out_ms": o_ms, "out_host_ms": o_wall,
                     "in_ms": i_ms, "in_host_ms": i_wall,
                     "out_gb_s": nbytes / o_ms / 1e6,
                     "in_gb_s": nbytes / i_ms / 1e6,
                     "priced_gb_s": hw.host_bw / 1e9,
                     "swap_time_tokens": n, "swap_time_ms": priced,
                     "pinned_alloc_fresh_ms": fresh,
                     "pinned_alloc_cached_ms": cached}
        print(f"host link, {kind}: {nbytes} B; device to host {o_ms:.4f} ms"
              f" = {nbytes / o_ms / 1e6:.2f} GB/s (copy-stream events), "
              f"{o_wall:.4f} ms on the host clock across the drain; host "
              f"to device {i_ms:.4f} ms = {nbytes / i_ms / 1e6:.2f} GB/s "
              f"(events), {i_wall:.4f} ms host; priced "
              f"{hw.host_bw / 1e9:.0f} GB/s, cost_model.swap_time({n}) = "
              f"{priced:.4f} ms; its pinned buffers take {fresh:.4f} ms "
              f"to allocate fresh, {cached:.4f} ms from the cache")
    return out


# --------------------------------------------------------------------- #
# phase 17: a rolled-back step leaves every live page and slot as it was
# --------------------------------------------------------------------- #
#
# Each case builds an engine (no weights: nothing is computed) in a
# batch-start state, then drives ONE ``Engine.step`` whose attempt is the
# case's script: it stages every kind of device write the plane has, each
# into a page or slot that was live at batch start (a victim's, freed
# earlier in the same attempt), with snapshots on the copy stream, and
# its last allocation faults.  ``step`` rolls the attempt back and runs
# it again; the retry first checks that every live page (or slot) holds
# its batch-start bytes, then commits.  A twin engine runs the same step
# with no fault, and the two must end bit-equal.  The functions take the
# config and device, so ``tests/test_torch_txn.py`` runs them on the CPU
# at reduced size.

def _fill(torch, tensors, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for t in tensors:
        t.copy_(torch.randn(t.shape, generator=gen, device=device).to(
            t.dtype))


def _case_request(eng, rid, n, Request):
    toks = [(7 * rid + i) % eng.cfg.vocab_size for i in range(n)]
    r = Request(rid=rid, input_len=n, output_len=4, arrival=0.0,
                prompt=toks)
    r.m, r.running = n, True
    eng.token_ids[rid] = list(toks)
    eng.allocator.allocate(rid, n)
    eng.sched.running.append(r)
    return r


def _faulted_step(torch, eng, script, fault: bool, check_rollback):
    """Drive one ``eng.step()`` whose attempt is ``script(eng)``; with
    ``fault``, the attempt's last allocation raises ``FaultError`` the
    first time, and ``check_rollback()`` runs at the start of the retry."""
    from repro_torch.serving.faults import FaultError
    armed, calls = [False], []

    def hook(need):
        if armed[0]:
            armed[0] = False
            raise FaultError("injected at the attempt's last allocation")

    def attempt():
        calls.append(len(calls))
        if len(calls) == 2:
            check_rollback()
        last = script(eng)
        armed[0] = fault and len(calls) == 1
        last()
        eng._commit()
        return 1

    eng.allocator.fault_hook = hook
    eng._step_attempt = attempt
    eng.step()
    del eng._step_attempt
    check(len(calls) == 1 + fault
          and eng.recovery_stats["alloc_faults"] == int(fault),
          f"attempts {calls}, recovery {eng.recovery_stats}")


def rollback_pooled(torch, cfg, ecfg, M_kv, device, seed=17):
    """Pooled plane: a full page-run restore (a suspended request whose
    snapshot is drained on swap-in), a tail restore, a promotion and a
    copy-on-write copy, all into pages a victim freed in the attempt."""
    from repro_torch.core import Request, make_scheduler
    from repro_torch.core.kvcache import chain_keys
    from repro_torch.serving import Engine
    pg = ecfg.page_size

    def build():
        eng = Engine(cfg, None, make_scheduler(
            "sarathi_cs", M_kv, S=ecfg.cache_len, preempt_mode="swap",
            partial_preempt=True), ecfg, device=device)
        r = {rid: _case_request(eng, rid, n * pg, Request)
             for rid, n in ((0, 6), (1, 10), (2, 3), (3, 4))}
        _fill(torch, (eng.k_pools, eng.v_pools), seed, device)
        toks = r[0].prompt
        eng.allocator.register_prefix(       # rid 0's first two pages
            0, chain_keys(toks, pg)[:2],
            [tuple(toks[i * pg:(i + 1) * pg]) for i in range(2)])
        want2 = {k: v.clone() for k, v in eng._gather_pages_device(
            eng.allocator.table(2).pages)[0].items()}
        eng.sched.running.remove(r[2])       # suspended whole, in flight
        r[2].preempt(mode="swap")
        eng.sched.waiting.append(r[2])
        check(eng._swap_out_paged(r[2]), "swap-out of rid 2")
        r[3].partial_preempt(2 * pg, mode="swap")    # its tail, in flight
        check(eng._shed_tail(r[3], 2, 2 * pg, "swap"), "tail shed")
        shape = (cfg.num_layers, 1, pg, cfg.num_kv_heads, cfg.head_dim_)
        page = {k: torch.empty(shape, dtype=eng.k_pools.dtype,
                               device=device) for k in ("k", "v")}
        _fill(torch, page.values(), seed + 1, device)
        host = eng._link.finish(eng._link.start(page))   # a host-tier page
        return eng, r, want2, page, host

    def script(r, host):
        def run(eng):
            eng.sched._preempt(r[1])         # the victim: 10 pages freed
            eng._handle_preempted(r[1])
            eng._swap_in_paged(r[2])         # run_restore
            eng._swap_in_tail(r[3])          # tail_restore
            page = eng.allocator.allocate(4, pg)
            eng._promote_restore(page[0], host)          # promotion
            eng._cow_guard(0, pg + pg // 2)  # cow_copy of a pinned page
            kinds = sorted({i[0] for i in eng._intents})
            check(kinds == ["cow_copy", "promotion", "run_restore",
                            "tail_restore"], f"staged {kinds}")
            return lambda: eng.allocator.allocate(0, pg)   # the last one
        return run

    eng, r, want2, page, host = build()
    twin, tr, _, _, thost = build()
    a = eng.allocator
    live = sorted({p for t in a._tables.values() for p in t.pages}
                  | set(a._pinned))
    ids = eng._link.ids(live)
    before = {"k": eng.k_pools.index_select(1, ids),
              "v": eng.v_pools.index_select(1, ids)}
    held = set(a.table(1).pages)
    inflight = eng._gather_pages_device(live)[1]   # on the copy stream
    staged = []

    def check_rollback():
        for k, pool in (("k", eng.k_pools), ("v", eng.v_pools)):
            check(same_bits(torch, pool.index_select(1, ids), before[k]),
                  f"pooled {cfg.dtype}: live {k} pages changed by the "
                  "rolled-back attempt")
        check(r[2].suspended and eng.swap_store.has_runs(2)
              and set(a.table(1).pages) == held,
              "pooled: the books did not roll back")
        staged.append(len(held))

    t0 = time.perf_counter()
    _faulted_step(torch, eng, script(r, host), True, check_rollback)
    _faulted_step(torch, twin, script(tr, thost), False, None)
    got = eng._link.finish(inflight)
    if device != "cpu":
        torch.cuda.synchronize()
    for k in ("k", "v"):
        check(same_bits(torch, host_tensor(torch, got[k], before[k].dtype),
                        before[k].cpu()),
              f"pooled {cfg.dtype}: the in-flight snapshot's {k} bytes")
        check(same_bits(torch, getattr(eng, f"{k}_pools"),
                        getattr(twin, f"{k}_pools")),
              f"pooled {cfg.dtype}: {k} pools differ from the fault-free "
              "step's")
        p2 = eng._link.ids(eng.allocator.table(2).pages)
        check(same_bits(torch, getattr(eng, f"{k}_pools").index_select(
            1, p2), want2[k]), f"pooled {cfg.dtype}: rid 2's restored {k}")
        p4 = eng.allocator.table(4).pages[0]
        check(same_bits(torch, getattr(eng, f"{k}_pools")[:, p4],
                        page[k][:, 0]), f"pooled {cfg.dtype}: promoted {k}")
    check(set(eng.allocator.table(2).pages) <= held and staged,
          "pooled: the restore did not land in the victim's pages")
    return {"live_pages": len(live), "victim_pages": len(held),
            "bytes_checked": 2 * before["k"].numel()
            * before["k"].element_size(),
            "seconds": time.perf_counter() - t0}


def rollback_slot(torch, cfg, ecfg, M_kv, device, seed=19):
    """Slot plane: a slot swap-in (a suspended request) and a fresh
    claim's reset, into the slots of two victims swapped out earlier in
    the same attempt."""
    from repro_torch.core import Request, make_scheduler
    from repro_torch.serving import Engine
    n = 3 * ecfg.page_size

    def build():
        eng = Engine(cfg, None, make_scheduler(
            "vllm", M_kv, S=ecfg.cache_len, preempt_mode="swap"), ecfg,
            device=device)
        r = {}
        for rid in range(4):
            r[rid] = _case_request(eng, rid, n + rid, Request)
            eng._claim_slot(rid)
        _fill(torch, [v for k, v in eng.cache.items() if k != "index"],
              seed, device)
        for rid, q in r.items():
            eng.cache["index"][eng.slot_of[rid]] = q.m
        want2 = {k: v.select(0 if v.dim() == 1 else 1,
                             eng.slot_of[2]).clone()
                 for k, v in eng.cache.items()}
        eng.sched.running.remove(r[2])       # suspended, in flight
        r[2].preempt(mode="swap")
        eng.sched.waiting.append(r[2])
        check(eng._swap_out(r[2]), "swap-out of rid 2")
        return eng, r, want2

    def script(r):
        def run(eng):
            for v in (r[3], r[1]):           # two victims, swapped out
                eng.sched._preempt(v)
                eng._handle_preempted(v)
            eng._swap_in(r[2])               # slot_swap_in
            eng._claim_slot(5)               # slot_reset
            kinds = sorted(i[0] for i in eng._intents)
            check(kinds == ["slot_reset", "slot_swap_in"], f"staged {kinds}")
            return lambda: eng.allocator.allocate(5, n)
        return run

    eng, r, want2 = build()
    twin, tr, _ = build()
    live = sorted(eng.slot_of.values())
    victims = {eng.slot_of[1], eng.slot_of[3]}
    before = {k: v.clone() for k, v in eng.cache.items()}
    inflight = eng._link.start(
        {k: v.clone() for k, v in eng.cache.items()})

    def check_rollback():
        for k, v in eng.cache.items():
            ax = 0 if v.dim() == 1 else 1
            for s in live:
                check(same_bits(torch, v.select(ax, s),
                                before[k].select(ax, s)),
                      f"slot {cfg.dtype}: live slot {s} leaf {k} changed "
                      "by the rolled-back attempt")
        check(r[2].suspended and eng.swap_store.peek(2) is not None
              and sorted(eng.slot_of.values()) == live,
              "slot: the books did not roll back")

    t0 = time.perf_counter()
    _faulted_step(torch, eng, script(r), True, check_rollback)
    _faulted_step(torch, twin, script(tr), False, None)
    host = eng._link.finish(inflight)
    if device != "cpu":
        torch.cuda.synchronize()
    for k, v in eng.cache.items():
        ax = 0 if v.dim() == 1 else 1
        check(same_bits(torch, host_tensor(torch, host[k], v.dtype),
                        before[k].cpu()),
              f"slot {cfg.dtype}: the in-flight copy's {k} bytes")
        check(same_bits(torch, v, twin.cache[k]),
              f"slot {cfg.dtype}: leaf {k} differs from the fault-free "
              "step's")
        check(same_bits(torch, v.select(ax, eng.slot_of[2]), want2[k]),
              f"slot {cfg.dtype}: rid 2's restored {k}")
        check(not v.select(ax, eng.slot_of[5]).any(),
              f"slot {cfg.dtype}: the claimed slot's {k} is not zero")
    check({eng.slot_of[2], eng.slot_of[5]} == victims,
          "slot: the writes did not land in the victims' slots")
    return {"live_slots": len(live), "bytes_checked": sum(
        v.numel() * v.element_size() for v in before.values()),
        "seconds": time.perf_counter() - t0}


def phase_rollback(torch, get_config):
    from repro_torch.launch.serve import (SMOKE_ARCH, SMOKE_ENGINE, SMOKE_M,
                                          SMOKE_RWKV_ARCH, SMOKE_RWKV_ENGINE,
                                          SMOKE_RWKV_M)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[f"pooled_{dtype}"] = rollback_pooled(
            torch, dataclasses.replace(get_config(SMOKE_ARCH), dtype=dtype),
            SMOKE_ENGINE, SMOKE_M, DEVICE)
        out[f"slot_{dtype}"] = rollback_slot(
            torch, dataclasses.replace(get_config(SMOKE_RWKV_ARCH),
                                       dtype=dtype),
            SMOKE_RWKV_ENGINE, SMOKE_RWKV_M, DEVICE)
        torch.cuda.empty_cache()
    print("rollback bytes: run restore, tail restore, promotion and CoW "
          "copy (TinyLlama pools), slot swap-in and slot reset (RWKV6-7B "
          "slots), each into a victim's page or slot, snapshots in flight, "
          "the last allocation faulted: every live page and slot bit-equal "
          "after the rollback, the retry bit-equal to a fault-free step; "
          + ", ".join(f"{k} {v['bytes_checked']} B in {v['seconds']:.2f} s"
                      for k, v in out.items()))
    return out


# --------------------------------------------------------------------- #
# phase 20: the step graphs at full width
# --------------------------------------------------------------------- #
#
# A warmed engine holds one CUDA graph per prefill shape (row rung and
# ladder bucket on the pooled plane, bucket on a slot plane) and one decode
# graph (``serving.step_graphs``), and every serving phase checks that its
# run replayed them and nothing else (``check_graph_run``).
# ``replay_vs_eager`` sets random state and step inputs, runs the same
# plane function eagerly on clones of the pools (or the cache), then the
# graph on the engine's own state, and compares the ids, the decode
# graph's advanced cohort and every pool or cache byte.  It takes the
# device, so ``tests/test_torch_graphs.py`` runs it on the CPU (where the
# graph call is the eager function) and ``tests/test_torch_cuda_graphs.
# py`` on a card, both at reduced size.

def graph_counts(eng):
    """(graphs built, replays, eager calls) of an engine's step graphs."""
    g = eng.graphs
    return len(g), g.replays, g.eager_calls


def expected_graphs(eng):
    """The step graphs ``warmup()`` captures outside the legacy plane: one
    per (row rung, bucket), plus the decode graph."""
    return len(eng.rungs) * len(eng.buckets) + 1


def check_graph_run(eng, before, label):
    """After ``warmup()``: every prefill round and decode step of the run
    was one replay, no graph was built and no step ran eagerly."""
    n0, r0, e0 = before
    n1, r1, e1 = graph_counts(eng)
    steps = eng.prefill_rounds + eng.decode_steps
    check(n0 == n1 == expected_graphs(eng),
          f"{label}: {n0} step graphs before the run, {n1} after; "
          f"expected {len(eng.rungs)} rungs x {len(eng.buckets)} buckets "
          "+ 1 decode")
    check(r1 - r0 == steps and e1 == e0,
          f"{label}: {r1 - r0} replays and {e1 - e0} eager calls for "
          f"{eng.prefill_rounds} prefill rounds + {eng.decode_steps} decode "
          "steps")
    check(eng.num_compiles == 0, f"{label}: num_compiles moved")
    return {"graphs": n1, "replays": r1 - r0,
            "capture_s": eng.graphs.capture_s}


def decode_step_ms(res):
    """Mean measured wall of the run's decode-only batches, in ms."""
    walls = [b.wall_s for b in res.metrics.batches
             if b.num_decode and not b.num_prefill]
    return 1e3 * sum(walls) / max(1, len(walls))


def _compare_state(torch, got, want, dtype):
    """Ids first, then every tensor of state: the ids equal, every tensor
    bit-equal, the largest difference of the float ones, and whether
    those are within ``TOL``."""
    floats = [(a.float(), b.float()) for a, b in zip(got, want)
              if a.is_floating_point()]
    return {"ids_equal": torch.equal(got[0], want[0]),
            "bit_equal": all(same_bits(torch, a, b)
                             for a, b in zip(got, want)),
            "max_abs": max(((a - b).abs().max().item() for a, b in floats),
                           default=0.0),
            "close": all(torch.allclose(a, b, **TOL[dtype])
                         for a, b in floats)}


def replay_vs_eager(torch, eng, seed, device=DEVICE):
    """Each step graph of a warmed engine against an eager call of the same
    plane function on cloned state ({graph: ``_compare_state``}).  The
    engine's pools or cache are overwritten with random state; on the
    pooled plane each slot owns distinct pages for every position a step
    may write, so the comparison does not depend on write order, and each
    packed grid holds distinct random slots (some rows of length 0), the
    eager call their rows of the block tables."""
    from repro_torch.serving.engine import merge_rows
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ns, vocab, dtype = eng.ecfg.nslots, eng.cfg.vocab_size, eng.cfg.dtype

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def greedy(logits):
        return torch.argmax(logits[:, :vocab], dim=-1).to(torch.int32)

    if eng._pooled:
        state = (eng.k_pools, eng.v_pools)
        _fill(torch, state, seed, device)
        per = min(eng.max_pages, eng.allocator.num_pages // ns)
        pages = torch.randperm(eng.allocator.num_pages, generator=gen,
                               device=device)[:ns * per]
        eng._bt_dev.zero_()
        eng._bt_dev[:, :per] = pages.view(ns, per).to(torch.int32)
        cap = per * eng.ecfg.page_size     # positions with private pages
    else:
        state = tuple(eng.cache.values())
        _fill(torch, [t for t in state if t.is_floating_point()], seed,
              device)
        eng.cache["index"].copy_(ints(0, 1000, ns))
    out = {}
    with torch.no_grad():
        for rows, b in [(r, b) for r in eng.rungs for b in eng.buckets]:
            g = eng._prefill_graph(b, rows)
            lens = ints(0, b + 1, rows)
            lens[0] = b
            toks = ints(0, vocab, rows, b)
            if eng._pooled:
                starts = ints(0, cap - b + 1, rows)
                slots = torch.randperm(ns, generator=gen, device=device)[
                    :rows].to(torch.int32)
                g.inputs[0].copy_(torch.cat([toks, lens[:, None],
                                             starts[:, None],
                                             slots[:, None]], 1))
                kc, vc = (t.clone() for t in state)
                want = (eng._paged_prefill(
                    eng.params, kc, vc, toks, starts, lens,
                    eng._bt_dev.index_select(0, slots)), kc, vc)
            else:
                g.inputs[0].copy_(torch.cat([toks, lens[:, None]], 1))
                clone = {k: v.clone() for k, v in eng.cache.items()}
                logits, new = eng._chunk_fn(eng.params, toks, clone, lens)
                merge_rows(clone, lens > 0, new)
                want = (greedy(logits), *clone.values())
            out[g.name] = _compare_state(torch, (g(), *state), want, dtype)
        g = eng._decode_graph()
        toks, active = ints(0, vocab, ns), ints(0, 2, ns)
        active[0] = 1
        if eng._pooled:
            ctx = ints(0, cap, ns)
            g.inputs[0].copy_(torch.stack([toks, ctx, active]))
            kc, vc = (t.clone() for t in state)
            ids = eng._paged_decode(eng.params, kc, vc, toks, ctx,
                                    eng._bt_dev, active.bool())
            want = (ids, torch.stack([ids, ctx + active, active]), kc, vc)
            got = (g(), g.inputs[0], *state)
        else:
            g.inputs[0].copy_(torch.stack([toks, active]))
            clone = {k: v.clone() for k, v in eng.cache.items()}
            logits, new = eng._decode_fn(eng.params, toks, clone)
            merge_rows(clone, active.bool(), new)
            want = (greedy(logits), *clone.values())
            got = (g(), *state)
        out["decode"] = _compare_state(torch, got, want, dtype)
    # the buffers hold test inputs now: the next step uploads afresh
    eng._bt_cache = eng._decode_state = None
    return out


def phase_graphs(torch, label, server, cfg, params, want, seed=23):
    """Phase 20 for one engine: the graphs ``warmup()`` captured (count and
    host seconds), each replay against the eager call on cloned state, then
    the served run through them: its tokens against ``want`` (an earlier
    phase's outputs of the same workload: required equal in fp32, counted
    in bf16) and the wall of a decode step."""
    t0 = time.perf_counter()
    eng, reqs = server(cfg, params, device=DEVICE)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    check(eng.num_graphs == expected_graphs(eng),
          f"{label}: {eng.num_graphs} step graphs after warmup, expected "
          f"{len(eng.rungs)} rungs x {len(eng.buckets)} buckets + 1 decode")
    cmp = replay_vs_eager(torch, eng, seed)
    for what, c in cmp.items():
        print(f"  {label} {what}: replay "
              + ("bit-equal to the eager call" if c["bit_equal"] else
                 f"differs from the eager call by {c['max_abs']:.3g} at "
                 f"most (ids equal: {c['ids_equal']}); cuBLAS may pick "
                 "another algorithm under capture, and the serving "
                 "phases' token checks stand"))
        check(c["close"], f"{label} {what}: replay and eager call differ "
              f"beyond {TOL[cfg.dtype]}: {c}")
    torch.cuda.synchronize()
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_graph_run(eng, before, label)
    tokens = sum(len(o) for o in res.outputs.values())
    same = sum(res.outputs[r.rid] == want[r.rid] for r in reqs)
    check(same == len(reqs) or cfg.dtype != "float32",
          f"{label}: {same}/{len(reqs)} requests token-identical to the "
          "earlier phase's run")
    step_ms = decode_step_ms(res)
    print(f"{label}: {graphs['graphs']} graphs captured in "
          f"{graphs['capture_s']:.3f} s (engine built and warmed in "
          f"{built_s:.3f} s); served {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tok/s through {graphs['replays']} replays "
          f"({eng.prefill_rounds} prefill rounds + {eng.decode_steps} decode "
          f"steps); wall of a decode-only batch {step_ms:.3f} ms; "
          f"{same}/{len(reqs)} requests token-identical to the earlier "
          "phase's run")
    return dict(graphs, built_s=built_s, wall_s=wall, tokens=tokens,
                tok_per_s=tokens / wall, decode_step_ms=step_ms,
                replay_vs_eager=cmp, same_tokens=same)


# --------------------------------------------------------------------- #
# phase 21: the dense slot-resident planes and the legacy plane
# --------------------------------------------------------------------- #

#: phase 21's TinyLlama runs: name -> ``smoke_plane_server`` settings
PLANE_RUNS = {"batched": dict(plane="batched", impl="paged"),
              "deferred": dict(plane="batched", decode_append="deferred"),
              "legacy": dict(plane="legacy")}
#: ... and RWKV6-7B's (``rwkv_smoke_server`` settings)
RWKV_PLANE_RUNS = {"legacy": dict(plane="legacy"),
                   "deferred": dict(decode_append="deferred")}
#: B1 on the dense view: the smoke engine's slot cache (B, H, Hkv, D,
#: cache_len) as 64-token pages, contexts 260-295 as in phase 4
DENSE_VIEW = (8, 32, 4, 64, 512)
DENSE_PAGE = 64


def dense_view_case(torch, inp, dtype, view=DENSE_VIEW, ctx=None):
    """(q, k pool, v pool, identity tables, ctx): a random dense slot
    cache of ``view`` = (B, H, Hkv, D, S) viewed as B1's pools, as
    ``decode_attention_dense`` views it, with row b's context ``ctx[b]``
    (default 260 + 5 b); also the dense (B, S, Hkv, D) K/V it views."""
    B, H, Hkv, D, S = view
    q = inp.randn(B, H, D, dtype=dtype)
    k, v = (inp.randn(B, S, Hkv, D, dtype=dtype) for _ in range(2))
    n = S // DENSE_PAGE
    bt = (torch.arange(B * n, device=DEVICE, dtype=torch.int32)
          .view(B, n))
    ctx = torch.tensor(ctx or [260 + 5 * b for b in range(B)],
                       dtype=torch.int32, device=DEVICE)
    pool = (k.view(B * n, DENSE_PAGE, Hkv, D), v.view(B * n, DENSE_PAGE, Hkv,
                                                      D))
    return (q, *pool, bt, ctx), (k, v)


def check_dense_view(torch, pa, ref, pa_ops, case, dense, dtype,
                     what) -> float:
    """B1 through ``decode_attention_dense`` on one ``dense_view_case``:
    one launch of the dtype's variant, against the plain version on the
    same view (``TOL``) and against plain attention over the first ctx
    keys of the dense cache (or ring: attention is order-free)."""
    q, kp, vp, bt, ctx = case
    k, v = dense
    before = dict(pa.paged_decode_cuda.launches_by_variant)
    got = pa_ops.decode_attention_dense(q, k, v, ctx, page_size=DENSE_PAGE)
    one_launch_of(pa.paged_decode_cuda, before, dtype, what, DECODE_VARIANT)
    err = compare(torch, got, ref.paged_decode_reference(q, kp, vp, bt, ctx),
                  dtype, what)
    S, Hkv = k.shape[1], k.shape[2]
    keep = torch.arange(S, device=DEVICE)[None] < ctx[:, None]
    qg = q.float().view(q.shape[0], Hkv, -1, q.shape[2])
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / math.sqrt(
        q.shape[2])
    w = torch.softmax(s.masked_fill(~keep[:, None, None], -1e30), -1)
    plain = torch.einsum("bhgk,bkhd->bhgd", w, v.float()).view(q.shape)
    compare(torch, got, plain, dtype, what + " vs dense attention")
    return err


def phase_dense_view(torch, pa, ref, pa_ops):
    """B1 through ``decode_attention_dense`` at the dense view's shapes
    (``check_dense_view``)."""
    inp = Inputs(torch, 21)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        case, dense = dense_view_case(torch, inp, dtype)
        errs[dtype] = check_dense_view(torch, pa, ref, pa_ops, case, dense,
                                       dtype,
                                       f"decode_attention_dense {dtype}")
    print(f"decode_attention_dense (B1 on the dense view, "
          f"{DENSE_VIEW[0]} x {DENSE_VIEW[4]} tokens, page {DENSE_PAGE}): "
          f"max abs err {errs}")
    return errs


def check_plane_graphs(eng, before, label):
    """``check_graph_run``; on the legacy plane: the decode graph alone,
    replayed once per decode step, no prefill graph, no eager step."""
    if eng.ecfg.plane != "legacy":
        return check_graph_run(eng, before, label)
    n0, r0, e0 = before
    n1, r1, e1 = graph_counts(eng)
    check(n0 == n1 == 1, f"{label}: {n0} step graphs before the run, {n1} "
          "after; expected the decode graph alone")
    check(r1 - r0 == eng.decode_steps and e1 == e0,
          f"{label}: {r1 - r0} replays and {e1 - e0} eager graph calls for "
          f"{eng.decode_steps} decode steps")
    check(eng.num_compiles == 0, f"{label}: num_compiles moved")
    return {"graphs": n1, "replays": r1 - r0,
            "capture_s": eng.graphs.capture_s}


def serve_plane(torch, counters, server, cfg, params, label, replay=False,
                **kw):
    """A warmed slot-plane engine's run of its smoke workload, the
    ``counters`` zeroed just before it: (engine, requests, result, wall s,
    graph counts, replay-vs-eager comparison or None)."""
    eng, reqs = server(cfg, params, device=DEVICE, **kw)
    check(eng.cache is not None and eng.k_pools is None,
          f"{label}: not on the slot-resident plane")
    cmp = replay_vs_eager(torch, eng, seed=29) if replay else None
    for what, c in (cmp or {}).items():
        check(c["close"], f"{label} {what}: replay and eager call differ "
              f"beyond {TOL[cfg.dtype]}: {c}")
    torch.cuda.synchronize()
    zero_counts(*counters)
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_plane_graphs(eng, before, label)
    check(all(r.finished for r in reqs), f"{label}: unfinished requests")
    return eng, reqs, res, wall, graphs, cmp


def phase_planes(torch, pa, cfg, params, want):
    """Phase 21 for TinyLlama-1.1B at full width: ``smoke_plane_server``
    on each of ``PLANE_RUNS``.  B1 launches = layers x decode steps through
    the dtype's variant on the ``impl="paged"`` run and 0 on the others,
    B2 none; the graph counts of ``check_plane_graphs``; the batched run's
    replays against eager calls on cloned state first.  fp32: every
    request's tokens equal ``want`` (phase 3's references, which phase 3's
    outputs equal); bf16: the requests equal to ``want`` (phase 4's
    outputs) counted, tokens/s and the wall of a decode-only batch."""
    from repro_torch.launch.serve import smoke_plane_server
    fp32 = cfg.dtype == "float32"
    tag = "fp32" if fp32 else "bf16"
    variant, L = DECODE_VARIANT[cfg.dtype], cfg.num_layers
    out = {}
    for name, kw in PLANE_RUNS.items():
        label = f"{tag} {name} plane serve ({kw})"
        eng, reqs, res, wall, graphs, cmp = serve_plane(
            torch, (pa.paged_decode_cuda, pa.paged_prefill_cuda),
            smoke_plane_server, cfg, params, label,
            replay=name == "batched", **kw)
        b1 = dict(pa.paged_decode_cuda.launches_by_variant)
        b1_want = L * eng.decode_steps if kw.get("impl") == "paged" else 0
        check(b1 == {**dict.fromkeys(b1, 0), variant: b1_want}
              and eng.decode_steps > 0,
              f"{label}: paged_decode launches by variant {b1}, expected "
              f"{b1_want} through {variant}")
        check(pa.paged_prefill_cuda.launches == 0,
              f"{label}: paged_prefill launched on the slot plane")
        tokens = sum(len(o) for o in res.outputs.values())
        same = sum(res.outputs[r.rid] == want[r.rid] for r in reqs)
        # the first position where each differing request leaves ``want``
        first = sorted(next(i for i, (a, b) in enumerate(
            zip(res.outputs[r.rid], want[r.rid])) if a != b)
            for r in reqs if res.outputs[r.rid] != want[r.rid])
        step_ms = decode_step_ms(res)
        print(f"{label}: {tokens} tokens in {wall:.3f} s = "
              f"{tokens / wall:.1f} tok/s; {eng.prefill_rounds} prefill "
              f"rounds, {eng.decode_steps} decode steps, {graphs['replays']}"
              f" replays of {graphs['graphs']} graphs; wall of a "
              f"decode-only batch {step_ms:.3f} ms; preemptions "
              f"{res.metrics.num_preemptions}; paged_decode {b1}; "
              f"{same}/{len(reqs)} requests token-identical to phase "
              f"{3 if fp32 else 4}"
              + (f" (the others first differ at output positions {first})"
                 if first else "")
              + ("" if cmp is None else "; replays vs eager: " + ", ".join(
                  f"{w} {'bit-equal' if c['bit_equal'] else c['max_abs']}"
                  for w, c in cmp.items())))
        check(same == len(reqs) or not fp32,
              f"{label}: {same}/{len(reqs)} requests equal to "
              "generate_reference")
        margins = None if fp32 else bf16_margins(
            torch, cfg, params, reqs, res.outputs, want, label)
        out[name] = {"margins": margins, "wall_s": wall, "tokens": tokens,
                     "tok_per_s": tokens / wall, "decode_step_ms": step_ms,
                     "prefill_rounds": eng.prefill_rounds,
                     "decode_steps": eng.decode_steps,
                     "decode_variants": b1, "graphs": graphs,
                     "preemptions": res.metrics.num_preemptions,
                     "same_tokens": same, "first_differences": first,
                     "phase_stats": res.phase_stats,
                     "replay_vs_eager": cmp, "outputs": res.outputs,
                     "schedule": schedule(res)}
    return out


def schedule(res):
    """A run's ``BatchLog``s as dicts, without the measured ``wall_s``:
    what two engines on one workload must agree on."""
    out = []
    for b in res.metrics.batches:
        d = dataclasses.asdict(b)
        d.pop("wall_s")
        out.append(d)
    return out


def bf16_margins(torch, cfg, params, reqs, got, want, label,
                 moe_impl="dense"):
    """Where a bf16 run's tokens (``got``) leave another bf16 run's
    (``want``): ``launch.margins.divergence_margins`` over each request
    that parts, printed (a measurement, not a gate): the fp32 gap of the
    two tokens at the first differing position beside the 99th
    percentile of bf16's error on the fp32 top-2 logits where the runs
    agree, and each divergence a near-tie or a fault."""
    from repro_torch.launch.margins import divergence_margins
    t0 = time.perf_counter()
    m = divergence_margins(cfg, params, {r.rid: r.prompt for r in reqs},
                           got, want, moe_impl=moe_impl, device=DEVICE)
    m["seconds"] = time.perf_counter() - t0
    fmt = lambda x: "none" if x is None else f"{x:.4g}"   # noqa: E731
    print(f"  {label} margins: {len(m['requests'])} of {len(reqs)} requests"
          f" part; bf16 |error| on the fp32 top-2 logits where they agree: "
          f"p99 {fmt(m['err_p99'])}, max {fmt(m['err_max'])} over "
          f"{m['n_err']}; near-ties {m['near_ties']}, faults {m['faults']} "
          f"({m['seconds']:.1f} s)")
    for rid, r in sorted(m["requests"].items()):
        print(f"    rid {rid}: position {r['pos']}, token {r['tokens'][0]} "
              f"here / {r['tokens'][1]} there, fp32 gap {r['gap_fp32']:+.4g}"
              f" = {abs(r['gap_fp32']) / r['ulp_bf16']:.2f} bf16 steps of "
              f"the logit (fp32 top-2 {r['top2_fp32']}): {r['kind']}")
    return m


def phase_rwkv_planes(torch, wkv, M, cfg, params, refs):
    """Phase 21 for RWKV6-7B in fp32 at ``RWKV_FP32_LAYERS``: the smoke
    workload on each of ``RWKV_PLANE_RUNS``; tokens against phase 10's
    ``generate_reference`` tokens (``refs``) under its top-2 tie rule; B4
    launches = layers x prefill rounds (the legacy plane's rounds are its
    exact-shape chunk calls)."""
    from repro_torch.launch.serve import rwkv_smoke_server
    L, out = cfg.num_layers, {}
    for name, kw in RWKV_PLANE_RUNS.items():
        label = f"RWKV6-7B fp32 {name} plane serve ({kw})"
        eng, reqs, res, wall, graphs, _ = serve_plane(
            torch, (wkv.wkv6_cuda,), rwkv_smoke_server, cfg, params, label,
            **kw)
        launches = wkv.wkv6_cuda.launches
        check(launches == L * eng.prefill_rounds > 0,
              f"{label}: wkv6 launched {launches} times, expected {L} x "
              f"{eng.prefill_rounds} prefill rounds")
        diverged = divergences(torch, M, cfg, params, reqs, res.outputs,
                               refs)
        print(f"{label}: {sum(len(o) for o in res.outputs.values())} tokens "
              f"in {wall:.3f} s; {eng.prefill_rounds} prefill rounds, "
              f"{eng.decode_steps} decode steps, {graphs['replays']} "
              f"replays; wkv6 launches {launches} = {L} x "
              f"{eng.prefill_rounds}; {len(reqs) - len(diverged)}/"
              f"{len(reqs)} requests token-identical to generate_reference"
              + (f", divergences (position, reference top-2 gap) {diverged}"
                 if diverged else ""))
        check(all(gap < TIE_GAP for _, gap in diverged.values()),
              f"{label}: tokens differ from generate_reference beyond a "
              f"tie: {diverged}")
        out[name] = {"wall_s": wall, "launches": launches,
                     "prefill_rounds": eng.prefill_rounds,
                     "decode_steps": eng.decode_steps, "graphs": graphs,
                     "diverged": diverged}
    return out


# --------------------------------------------------------------------- #

# --------------------------------------------------------------------- #
# phase 22: the mixture-of-experts family at full width
# --------------------------------------------------------------------- #

#: depth of the fp32 token checks at full width: qwen2-moe's fp32 weights
#: at all 24 layers are 60.6 GB; qwen3-moe runs 4 of its 48 layers
MOE_FP32_LAYERS = 4
MOE3_LAYERS = 4


def phase_moe_kernels(torch, pa, ref, P_main, ecfg):
    """Phase 2 at the MoE serving shapes: B1 and B2 against their plain
    versions with qwen2-moe's heads and qwen3-moe's, in both dtypes, on
    the smoke engine's pages (B1 also repeated: the same bits)."""
    inp = Inputs(torch, 5)
    errs = {"paged_decode": {}, "paged_prefill": {}}
    for dtype in ("float32", "bfloat16"):
        for arch in ("qwen2_moe", "qwen3_moe"):
            h = HEADS[arch]
            errs["paged_decode"][f"{arch}_{dtype}"] = check_decode(
                torch, pa, ref, main_path_decode(torch, inp, dtype, P_main,
                                                 ecfg, h),
                dtype, f"decode {arch} H{h[0]} Hkv{h[1]} D{h[2]} {dtype}",
                repeat=True)
            errs["paged_prefill"][f"{arch}_{dtype}"] = check_prefill(
                torch, pa, ref, main_path_prefill(torch, inp, dtype, P_main,
                                                  ecfg, h),
                dtype, f"prefill {arch} H{h[0]} Hkv{h[1]} D{h[2]} {dtype}")
    for k, e in errs.items():
        print(f"{k} at the MoE serving shapes: max abs err "
              + ", ".join(f"{w} {v:.3g}" for w, v in e.items()))
    return errs


def param_bytes(params, skip=("embed",)) -> int:
    """Bytes of every leaf but ``skip``'s: what a decode step reads (the
    embedding table gives it 8 rows)."""
    out = 0
    for k, v in params.items():
        if k in skip:
            continue
        out += param_bytes(v, ()) if isinstance(v, dict) \
            else v.numel() * v.element_size()
    return out


def event_ms(torch, fn, iters=10, warm=2) -> float:
    """Mean device time of ``fn`` from CUDA events, no flush (a call that
    reads gigabytes of weights is not helped by a 50 MB L2)."""
    for _ in range(warm):
        fn()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def moe_round_times(torch, eng, cfg, params):
    """A full prefill round (every slot 128 tokens: T = 1024 rows through
    every expert) timed as the captured graph and eagerly in the dense
    and the sparse dispatch, and the decode graph's replay; after the
    run, on its pools (the writes land in pages nobody reads again)."""
    from repro_torch.serving.paged_plane import build_paged_fns
    b = eng.buckets[-1]
    ns = eng.ecfg.nslots
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (ns, b), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    lens = torch.full((ns,), b, dtype=torch.int32, device=DEVICE)
    starts = torch.zeros((ns,), dtype=torch.int32, device=DEVICE)
    slots = torch.arange(ns, dtype=torch.int32, device=DEVICE)
    g = eng._prefill_graph(b, ns)
    g.inputs[0].copy_(torch.cat([toks, lens[:, None], starts[:, None],
                                 slots[:, None]], 1))
    out = {"prefill_graph_ms": event_ms(torch, g)}
    for impl in ("dense", "sparse"):
        pf, _ = build_paged_fns(cfg, moe_impl=impl)
        out[f"prefill_eager_{impl}_ms"] = event_ms(
            torch, lambda: pf(params, eng.k_pools, eng.v_pools, toks, starts,
                              lens, eng._bt_dev), iters=3, warm=1)
    out["decode_graph_ms"] = event_ms(torch, eng._decode_graph())
    return out


def moe_serve(torch, pa, cfg, params, label, replays=True, refs=None,
              moe_impl="dense"):
    """One MoE serve of ``smoke_server``'s engine and workload in the
    ``moe_impl`` dispatch: replays bit-equal to eager calls on cloned
    random state (``replays``), then the run through the graphs with B1
    and B2 launched once per layer of every decode step and prefill round
    through the dtype's variants, the grouped MoE kernels once per layer
    of each under ``"grouped"`` and never otherwise, and the tokens
    against ``generate_reference`` (dense dispatch; required equal in
    fp32, counted in bf16; under ``"grouped"`` an fp32 request may part
    only where the reference's top-2 logit gap is below ``TIE_GAP``)."""
    from repro_torch.kernels.moe_grouped.moe_grouped import moe_grouped_cuda
    from repro_torch.launch.serve import SMOKE_ENGINE, smoke_server
    from repro_torch.models import model as M
    from repro_torch.serving import generate_reference
    dtype = cfg.dtype
    t0 = time.perf_counter()
    eng, reqs = smoke_server(cfg, params, device=DEVICE, moe_impl=moe_impl)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    cmp = {}
    if replays:
        cmp = replay_vs_eager(torch, eng, seed=29, device=DEVICE)
        for what, c in cmp.items():
            check(c["bit_equal"], f"{label} {what}: the replay differs from "
                  f"the eager call on cloned state: {c}")
        print(f"  {label}: {len(cmp)} replays bit-equal to their eager "
              "calls on cloned random state")
    torch.cuda.synchronize()
    zero_counts(pa.paged_decode_cuda, pa.paged_prefill_cuda,
                moe_grouped_cuda)
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_graph_run(eng, before, label)
    L = cfg.num_layers
    launches = {"paged_decode": pa.paged_decode_cuda.launches,
                "paged_prefill": pa.paged_prefill_cuda.launches,
                "moe_grouped": moe_grouped_cuda.launches}
    want_grouped = (L * (eng.prefill_rounds + eng.decode_steps)
                    if moe_impl == "grouped" else 0)
    check(launches["moe_grouped"] == want_grouped,
          f"{label}: moe_grouped launched {launches['moe_grouped']} times, "
          f"expected {want_grouped} ({moe_impl} dispatch, {L} layers x "
          f"{eng.prefill_rounds} prefill rounds + {eng.decode_steps} decode "
          "steps)")
    variants = dict(pa.paged_prefill_cuda.launches_by_variant)
    dvariants = dict(pa.paged_decode_cuda.launches_by_variant)
    check(launches["paged_prefill"] == L * eng.prefill_rounds > 0,
          f"{label}: paged_prefill launched {launches['paged_prefill']} "
          f"times, expected {L} x {eng.prefill_rounds}")
    check(launches["paged_decode"] == L * eng.decode_steps > 0,
          f"{label}: paged_decode launched {launches['paged_decode']} "
          f"times, expected {L} x {eng.decode_steps}")
    check(variants[VARIANT[dtype]] == launches["paged_prefill"]
          and dvariants[DECODE_VARIANT[dtype]] == launches["paged_decode"],
          f"{label}: launches by variant {variants} / {dvariants}: every "
          f"one should be {VARIANT[dtype]} / {DECODE_VARIANT[dtype]}")
    check(all(r.finished for r in reqs), f"{label}: unfinished requests")
    tokens = sum(len(o) for o in res.outputs.values())
    out = {"wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
           "built_s": built_s, "graphs": graphs, "replay_vs_eager": cmp,
           "moe_impl": moe_impl, "launches": launches,
           "prefill_variants": variants,
           "decode_variants": dvariants,
           "prefill_rounds": eng.prefill_rounds,
           "decode_steps": eng.decode_steps,
           "preemptions": res.metrics.num_preemptions,
           "trie_hits": res.swap_stats["trie_hits"],
           "decode_step_ms": decode_step_ms(res), "outputs": res.outputs,
           "param_bytes": param_bytes(params)}
    out.update(moe_round_times(torch, eng, cfg, params))
    out["decode_bound_ms"] = out["param_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"{label}: {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
          f"tok/s; {eng.prefill_rounds} prefill rounds, {eng.decode_steps} "
          f"decode steps, preemptions {res.metrics.num_preemptions}, prefix "
          f"hits {res.swap_stats['trie_hits']}; launches {launches}; wall "
          f"of a decode-only batch {out['decode_step_ms']:.3f} ms; decode "
          f"graph replay {out['decode_graph_ms']:.3f} ms of device time "
          f"against the weight-read bound {out['decode_bound_ms']:.3f} ms "
          f"({out['param_bytes'] / 1e9:.2f} GB at 3.35 TB/s); a full "
          f"prefill round (T = 1024) {out['prefill_graph_ms']:.2f} ms "
          f"replayed, eager {out['prefill_eager_dense_ms']:.2f} ms dense / "
          f"{out['prefill_eager_sparse_ms']:.2f} ms sparse dispatch")
    del eng
    t0 = time.perf_counter()
    refs = dict(refs or {})
    same, first = 0, {}
    for r in reqs:
        want = refs.get(r.rid)
        if want is None:
            want = refs[r.rid] = generate_reference(
                cfg, params, r.prompt, r.output_len,
                cache_len=SMOKE_ENGINE.cache_len, moe_impl="dense",
                device=DEVICE)
        got = res.outputs[r.rid]
        if got == want:
            same += 1
        else:
            first[r.rid] = next(i for i, (a, b) in enumerate(zip(got, want))
                                if a != b)
    print(f"{label} reference: {same}/{len(reqs)} requests token-identical "
          f"({time.perf_counter() - t0:.1f} s)"
          + (f"; first differences (rid: position) {first}" if first else ""))
    ties = {}
    if first and dtype == "float32" and moe_impl == "grouped":
        # the grouped and the dense dispatch sum each product in another
        # order: a greedy token may flip where the top two logits tie
        ties = divergences(torch, M, cfg, params, reqs, res.outputs, refs,
                           cache_len=SMOKE_ENGINE.cache_len)
        print(f"  {label}: (position, reference top-2 gap) where requests "
              f"part: {ties}")
        check(all(g < TIE_GAP for _, g in ties.values()),
              f"{label}: tokens leave generate_reference away from a "
              f"top-2 tie (gap >= {TIE_GAP}): {ties}")
    else:
        check(same == len(reqs) or dtype != "float32",
              f"{label}: tokens differ from generate_reference: {first}")
    out.update(same_tokens=same, first_diffs=first, tie_gaps=ties,
               references=refs)
    if dtype == "bfloat16":
        out["margins"] = bf16_margins(torch, cfg, params, reqs, res.outputs,
                                      refs, label + " vs its reference")
    return out


def phase_moe(torch, pa, M, get_config):
    """Phase 22: qwen2-moe at full width on ``smoke_server``'s engine and
    workload, fp32 at ``MOE_FP32_LAYERS`` layers and bf16 at full depth,
    and qwen3-moe at full widths and ``MOE3_LAYERS`` layers in fp32 in the
    dense dispatch, then in the grouped one in fp32 (on the same weights,
    against the same references) and in bf16; every earlier phase's
    engines and weights are gone by now."""
    import gc
    from repro_torch.launch.serve import SMOKE_MOE3_ARCH, SMOKE_MOE_ARCH
    gc.collect()          # engines live in reference cycles: free them
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    base = get_config(SMOKE_MOE_ARCH)
    qwen3 = get_config(SMOKE_MOE3_ARCH)
    for key, cfg, impls in (
            ("qwen2_fp32", dataclasses.replace(
                base, dtype="float32", num_layers=MOE_FP32_LAYERS),
             ("dense",)),
            ("qwen3_fp32", dataclasses.replace(
                qwen3, dtype="float32", num_layers=MOE3_LAYERS),
             ("dense", "grouped")),
            ("qwen3_bf16", dataclasses.replace(
                qwen3, dtype="bfloat16", num_layers=MOE3_LAYERS),
             ("grouped",)),
            ("qwen2_bf16", dataclasses.replace(base, dtype="bfloat16"),
             ("dense",))):
        params = M.init_params(cfg, seed=0, device=DEVICE)
        refs = None
        for impl in impls:
            label = (f"MoE {cfg.name} {cfg.dtype} at {cfg.num_layers} "
                     f"layers, {impl} dispatch")
            tag = key if impl == "dense" else key.replace("_", "_grouped_")
            out[tag] = moe_serve(torch, pa, cfg, params, label, refs=refs,
                                 moe_impl=impl)
            refs = out[tag].pop("references")
        del params, refs
        gc.collect()
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"phase 22 peak device memory allocated: "
          f"{out['max_memory_allocated'] / 2**30:.2f} GiB")
    return out


# --------------------------------------------------------------------- #
# phase 30: the grouped MoE kernels (kernels/moe_grouped) at full width
# --------------------------------------------------------------------- #

#: Qwen3-30B-A3B's expert layer, as the benchmark serves it: d, an
#: expert's width f, experts E, experts a token K
GROUPED_WIDTHS = (2048, 768, 128, 8)
#: tokens a call: the benchmark cell's decode step (128 slots), a
#: 1,024-row prefill round and the scheduler's 4,096-token round
GROUPED_TOKENS = (128, 1024, 4096)
#: share of the checked calls' tokens marked inert (a packed grid's
#: padding)
GROUPED_INERT = 0.3
#: a token is off where its largest error exceeds this share of the plain
#: output's largest value: fp32, 3xTF32 sums over d and f against float32
#: ones in another order; bf16, g, silu(g), h and the output each rounded
#: to the dtype
GROUPED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: a token's routing is a near-tie where its K-th and (K+1)-th router
#: logits lie within this share of the K-th (of 1 where it is smaller):
#: one bf16 step, or the fp32 sums' order; a logit rounded the other way
#: there sends the token to another expert
GROUPED_TIE = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def grouped_case(torch, T, dtype, seed, widths=GROUPED_WIDTHS,
                 inert=GROUPED_INERT, device=DEVICE):
    """One grouped MoE call's inputs: x (T, d), the router (d, E) and the
    stacked experts (E, d, f) / (E, f, d) as fan-in scaled normals from
    ``seed``, and ``valid`` with a share ``inert`` of the tokens off."""
    d, f, E, K = widths
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape, fan):
        return (torch.randn(shape, generator=gen, device=device)
                * fan ** -0.5).to(getattr(torch, dtype))
    w = (normal(d, E, fan=d), normal(E, d, f, fan=d),
         normal(E, d, f, fan=d), normal(E, f, d, fan=f))
    x = torch.randn((T, d), generator=gen, device=device).to(
        getattr(torch, dtype))
    valid = torch.rand((T,), generator=gen, device=device) >= inert
    return {"x": x, "w": w, "valid": valid, "K": K, "E": E,
            "dtype": dtype}


def check_grouped(torch, fn, gref, case, what) -> dict:
    """``fn`` (``moe_grouped_cuda``'s signature) on ``case`` against the
    plain version (``gref.moe_grouped_reference``): every live token
    within ``GROUPED_TOL`` but for near-ties of its routing
    (``GROUPED_TIE``), at most ``max(1, T // 512)`` of those, and every
    inert token's output exactly zero."""
    x, w, valid, K, E = (case[k] for k in ("x", "w", "valid", "K", "E"))
    dtype, T = case["dtype"], x.shape[0]
    kw = dict(top_k=K, num_experts=E, valid=valid)
    got = fn(x, *w, **kw)
    want = gref.moe_grouped_reference(x, *w, **kw)
    scale = float(want.float().abs().max())
    err = (got.float() - want.float()).abs().amax(-1)
    off = (err > GROUPED_TOL[dtype] * scale) & valid
    top = gref.rowwise_mm(x, w[0]).to(x.dtype).float().topk(K + 1).values
    tie = (top[:, K - 1] - top[:, K]) \
        <= GROUPED_TIE[dtype] * top[:, K - 1].abs().clamp(min=1.0)
    n_off, n_far = int(off.sum()), int((off & ~tie).sum())
    inside = valid & ~off
    live_err = float(err[inside].max()) if bool(inside.any()) else 0.0
    inert_zero = bool((got[~valid] == 0).all())
    print(f"  moe_grouped {what}: max abs err {live_err:.3g} of {scale:.3g} "
          f"over the live tokens in tolerance; {n_off} of {T} off, {n_far} "
          f"of them away from a near-tie of their routing "
          f"({int(tie.sum())} near-ties); inert tokens zero: {inert_zero}")
    check(n_far == 0 and n_off <= max(1, T // 512) and inert_zero,
          f"moe_grouped {what}: {n_off} tokens off ({n_far} away from a "
          f"near-tie), inert tokens zero: {inert_zero}")
    return {"max_abs_err": live_err, "scale": scale, "tokens_off": n_off,
            "near_ties": int(tie.sum()), "output": got}


def grouped_bound(case, reached: int) -> dict:
    """The least time of one call at the card's peaks: operations (the
    router's 2 d E a token, 2 x 3 d f a routed row; in fp32 as 3xTF32
    products, ``attention_bound``) and bytes (the router, every reached
    expert's weights once, x and the output once)."""
    x, wg = case["x"], case["w"][1]
    T, d = x.shape
    E, _, f = wg.shape
    ops = 2.0 * d * E * T + 2.0 * 3 * d * f * T * case["K"]
    nbytes = x.element_size() * (d * E + 3.0 * d * f * reached + 2.0 * T * d)
    return {**attention_bound(nbytes, ops, case["dtype"]), "bytes": nbytes,
            "ops": ops}


def kernel_device_ms(torch, fn, prefix: str, iters: int = 10) -> dict:
    """Device ms a call of each kernel whose name starts with ``prefix``,
    from ``torch.profiler`` over ``iters`` calls of ``fn`` (no flush);
    {} where the profiler sees no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0.0)
        if e.key.startswith(prefix) and t:
            out[e.key] = t / 1e3 / iters
    return out


def grouped_mm_call(torch, case, ids):
    """The layer's products through ``torch._grouped_mm`` over the rows
    laid out by expert (the layout made outside the call), SiLU-gated,
    scattered back and summed over each token's K rows."""
    x, (_, wg, wu, wo), K = case["x"], case["w"], case["K"]
    T, d = x.shape
    flat = ids.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    offs = torch.cumsum(torch.bincount(flat, minlength=wg.shape[0]),
                        0).to(torch.int32)
    xs = x[order // K].contiguous()

    def call():
        g = torch._grouped_mm(xs, wg, offs=offs)
        u = torch._grouped_mm(xs, wu, offs=offs)
        o = torch._grouped_mm(torch.nn.functional.silu(g) * u, wo, offs=offs)
        y = torch.empty_like(o)
        y[order] = o
        return y.view(T, K, d).sum(1)
    return call


def time_grouped(torch, mg, gref, case, dense_cfg) -> dict:
    """One call, every token live, timed (phase 4's method: CUDA events,
    L2 flushed before each) beside its plain version,
    ``torch._grouped_mm`` for its products (``library_ms``: a yardstick;
    None where the call refuses the dtype), the dense dispatch
    (``models.moe.apply_moe``: every expert on every token) and its bound;
    and each of its kernels' device time."""
    from repro_torch.models import moe
    x, w, K, E = case["x"], case["w"], case["K"], case["E"]
    T = x.shape[0]
    ids, _ = gref.route_reference(x, w[0], K, E)
    reached = int((torch.bincount(ids.reshape(-1).long(), minlength=E)
                   > 0).sum())
    kw = dict(top_k=K, num_experts=E)
    call = lambda: mg.moe_grouped_cuda(x, *w, **kw)  # noqa: E731
    t = {"dtype": case["dtype"], "tokens": T, "experts_reached": reached,
         "ms": time_ms(torch, call, iters=20),
         "plain_ms": time_ms(torch, lambda: gref.moe_grouped_reference(
             x, *w, **kw), iters=2, warm=1),
         **grouped_bound(case, reached)}
    t["kernel_ms"] = kernel_device_ms(torch, call, "moe_grouped_")
    t["library_ms"] = None
    try:
        t["library_ms"] = time_ms(torch, grouped_mm_call(torch, case, ids),
                                  iters=20)
    except (RuntimeError, TypeError, AttributeError) as e:
        t["library_error"] = str(e).splitlines()[0][:200]
    lp = dict(zip(("router", "wi_gate", "wi_up", "wo"), w))
    t["dense_ms"] = time_ms(torch, lambda: moe.apply_moe(lp, dense_cfg,
                                                         x[None]), iters=5)
    return t


def phase_moe_grouped(torch, get_config):
    """Phase 30: the grouped MoE kernels at Qwen3-30B-A3B's widths
    (``GROUPED_WIDTHS``), after phase 22: in fp32 and bf16, a call of
    ``GROUPED_TOKENS[-1]`` tokens with inert ones among them against its
    plain version (``check_grouped``), and its first
    ``GROUPED_TOKENS[0]`` tokens called alone, checked too and bit-equal
    to the same rows of the whole call; then each dtype timed at
    ``GROUPED_TOKENS[0]`` tokens and bf16 at every size
    (``time_grouped``)."""
    import gc
    from repro_torch.kernels.moe_grouped import moe_grouped as mg
    from repro_torch.kernels.moe_grouped import ref as gref
    from repro_torch.launch.serve import SMOKE_MOE3_ARCH
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(SMOKE_MOE3_ARCH)
    check((full.d_model, full.moe_d_ff, full.num_experts,
           full.experts_per_token) == GROUPED_WIDTHS,
          f"{SMOKE_MOE3_ARCH}'s expert layer is not GROUPED_WIDTHS")
    errs, times = {}, {}
    small, big = GROUPED_TOKENS[0], GROUPED_TOKENS[-1]
    for dtype in ("float32", "bfloat16"):
        case = grouped_case(torch, big, dtype, seed=37)
        errs[f"{dtype}_T{big}"] = check_grouped(
            torch, mg.moe_grouped_cuda, gref, case, f"{dtype} T{big}")
        whole = errs[f"{dtype}_T{big}"].pop("output")
        part = {**case, "x": case["x"][:small].contiguous(),
                "valid": case["valid"][:small].contiguous()}
        errs[f"{dtype}_T{small}"] = check_grouped(
            torch, mg.moe_grouped_cuda, gref, part, f"{dtype} T{small}")
        alone = errs[f"{dtype}_T{small}"].pop("output")
        check(torch.equal(alone, whole[:small]),
              f"moe_grouped {dtype}: the first {small} rows called alone "
              f"differ from the same rows of the {big}-token call")
        print(f"  moe_grouped {dtype}: the first {small} rows alone are "
              f"bit-equal to the same rows of the {big}-token call")
        del whole, alone
        dense_cfg = dataclasses.replace(full, dtype=dtype, num_layers=1)
        for T in (GROUPED_TOKENS if dtype == "bfloat16" else (small,)):
            times[f"{dtype}_T{T}"] = time_grouped(
                torch, mg, gref, {**case, "x": case["x"][:T].contiguous()},
                dense_cfg)
        del case
        gc.collect()
        torch.cuda.empty_cache()
    for what, t in times.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        print(f"moe_grouped ({what}, d {GROUPED_WIDTHS[0]}, f "
              f"{GROUPED_WIDTHS[1]}, E {GROUPED_WIDTHS[2]}, K "
              f"{GROUPED_WIDTHS[3]}, {t['experts_reached']} experts "
              f"reached): {t['ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
              f"library (torch._grouped_mm) {lib}; dense dispatch "
              f"{t['dense_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['bytes']:.3g} B, {t['ops']:.3g} ops)"
              f"{cores_note(t)}; by kernel "
              + ", ".join(f"{k} {v:.4f}" for k, v in t["kernel_ms"].items()))
    return {"errors": errs, "times": times}


# --------------------------------------------------------------------- #
# phase 23: the hybrid family (hymba-1.5b) at full width
# --------------------------------------------------------------------- #

#: B1 on hymba's ring: the hybrid smoke engine's slot cache (B, H, Hkv, D,
#: window) viewed as 64-token pages, each case with every row at one
#: context: a fresh ring, both sides of a page edge, a ring one short of
#: full and the full (wrapped) ring; then the rows at four of them
HYMBA_RING = (4, 25, 5, 64, 2048)
HYMBA_CTX = ([1] * 4, [63] * 4, [64] * 4, [65] * 4, [2047] * 4, [2048] * 4,
             [1, 65, 2047, 2048])
#: B3 at hymba's heads, causal with its 2048-token window: the smoke
#: workload's longest prompt (the window slides over 1052 queries) and a
#: prompt exactly as long as the window
HYMBA_FLASH = {"S3100": (1, 3100, 25, 5, 64), "S2048": (1, 2048, 25, 5, 64)}
#: the fp32 serves of the hybrid smoke workload: name ->
#: ``hybrid_smoke_server`` settings (B1 on the ring with impl="paged")
HYBRID_RUNS = {"batched_paged": dict(impl="paged"),
               "batched": {},
               "deferred": dict(decode_append="deferred"),
               "legacy": dict(plane="legacy"),
               "swap": dict(preempt_mode="swap")}


def phase_hybrid_kernels(torch, pa, fa, fref, ref, pa_ops, cfg):
    """Phase 23 (a): B1 on the ring at ``HYMBA_CTX`` and B3 with the window
    at ``HYMBA_FLASH``, in both dtypes, each case one launch of its dtype's
    variant held against its plain version (``TOL``)."""
    B, H, Hkv, D, S = HYMBA_RING
    check((H, Hkv, D, S) == (cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim_, cfg.window),
          f"HYMBA_RING {HYMBA_RING} is not {cfg.name}'s")
    inp = Inputs(torch, 37)
    errs = {"paged_decode": {}, "flash_attention": {}}
    for dtype in ("float32", "bfloat16"):
        for ctx in HYMBA_CTX:
            case, dense = dense_view_case(torch, inp, dtype, HYMBA_RING, ctx)
            what = f"B1 hymba ring ctx {ctx} {dtype}"
            errs["paged_decode"][f"ctx{ctx}_{dtype}"] = check_dense_view(
                torch, pa, ref, pa_ops, case, dense, dtype, what)
        for name, shape in HYMBA_FLASH.items():
            what = f"B3 hymba {name} window {cfg.window} {dtype}"
            errs["flash_attention"][f"{name}_{dtype}"] = check_flash(
                torch, fa, fref, flash_case(inp, *shape, dtype), dtype, what,
                window=cfg.window)
    errs["paged_decode"].update(
        main_float32=errs["paged_decode"][f"ctx{[S] * B}_float32"],
        main_bfloat16=errs["paged_decode"][f"ctx{[S] * B}_bfloat16"])
    errs["flash_attention"].update(
        main_float32=errs["flash_attention"]["S3100_float32"],
        main_bfloat16=errs["flash_attention"]["S3100_bfloat16"])
    print(f"hymba kernels: B1 on the {S}-slot ring (G = {H // Hkv}) at "
          f"{len(HYMBA_CTX)} contexts and B3 with window {cfg.window} at S "
          f"{[s[1] for s in HYMBA_FLASH.values()]}, fp32 and bf16, each one "
          f"launch of its variant, within tolerance of the plain versions: "
          f"max abs err {errs}")
    return errs


def hybrid_references(torch, fa, cfg, params, reqs):
    """``generate_reference(impl="flash")`` of every request (B3 with the
    window on its prefill, one launch per layer) and B3's launches."""
    from repro_torch.launch.serve import SMOKE_HYBRID_ENGINE
    from repro_torch.serving import generate_reference
    zero_counts(fa.flash_attention_cuda)
    t0 = time.perf_counter()
    refs = {r.rid: generate_reference(
        cfg, params, r.prompt, r.output_len,
        cache_len=SMOKE_HYBRID_ENGINE.cache_len, impl="flash",
        device=DEVICE) for r in reqs}
    torch.cuda.synchronize()
    launches = dict(fa.flash_attention_cuda.launches_by_variant)
    want = cfg.num_layers * len(reqs)
    check(launches == {**dict.fromkeys(launches, 0),
                       VARIANT[cfg.dtype]: want},
          f"hymba {cfg.dtype} generate_reference: flash_attention launches "
          f"by variant {launches}, expected {want} {VARIANT[cfg.dtype]}")
    return refs, launches[VARIANT[cfg.dtype]], time.perf_counter() - t0


def ring_wraps(reqs, window):
    """(requests whose prompt wraps the ring during prefill, requests whose
    decode wraps it): a prompt longer than the window, a prompt within it
    whose context outgrows it."""
    pre = [r.rid for r in reqs if r.input_len > window]
    dec = [r.rid for r in reqs
           if r.input_len <= window < r.input_len + r.output_len - 1]
    return pre, dec


def hybrid_serve_fp32(torch, pa, M, cfg, params, refs):
    """Phase 23 (c): the hybrid smoke workload on each of ``HYBRID_RUNS``
    in fp32, every request's tokens against ``refs``
    (``generate_reference(impl="flash")``) under phase 10's top-2 tie rule;
    B1 launches = layers x decode steps through ``split_simt`` on the
    ``impl="paged"`` run and none on the others; the graph counts of
    ``check_plane_graphs``; at least 2 preemptions, swapped on the swap
    run (every snapshot restored, nothing left in flight)."""
    from repro_torch.launch.serve import (SMOKE_HYBRID_ENGINE,
                                          hybrid_smoke_server)
    L, out = cfg.num_layers, {}
    for name, kw in HYBRID_RUNS.items():
        label = f"hymba fp32 {name} serve ({kw})"
        eng, reqs, res, wall, graphs, _ = serve_plane(
            torch, (pa.paged_decode_cuda, pa.paged_prefill_cuda),
            hybrid_smoke_server, cfg, params, label, **kw)
        leaves = {k: (tuple(v.shape), v.dtype) for k, v in eng.cache.items()}
        check(leaves["k"][0][2] == cfg.window
              and leaves["h"][1] == torch.float32,
              f"{label}: not a {cfg.window}-slot ring beside an fp32 SSM "
              f"state: {leaves}")
        b1 = dict(pa.paged_decode_cuda.launches_by_variant)
        b1_want = L * eng.decode_steps if kw.get("impl") == "paged" else 0
        check(b1 == {**dict.fromkeys(b1, 0), "split_simt": b1_want}
              and eng.decode_steps > 0,
              f"{label}: paged_decode launches by variant {b1}, expected "
              f"{b1_want} split_simt")
        check(pa.paged_prefill_cuda.launches == 0,
              f"{label}: paged_prefill launched on the slot plane")
        check(res.metrics.num_preemptions >= 2,
              f"{label}: {res.metrics.num_preemptions} preemptions")
        if kw.get("preempt_mode") == "swap":
            check_swapped(eng, res, label, partial=False, demotion=False)
        diverged = divergences(torch, M, cfg, params, reqs, res.outputs,
                               refs, cache_len=SMOKE_HYBRID_ENGINE.cache_len,
                               impl="flash")
        tokens = sum(len(o) for o in res.outputs.values())
        print(f"{label}: {tokens} tokens in {wall:.3f} s; "
              f"{eng.prefill_rounds} prefill rounds, {eng.decode_steps} "
              f"decode steps, {graphs['replays']} replays of "
              f"{graphs['graphs']} graphs; preemptions "
              f"{res.metrics.num_preemptions}, swap counts "
              f"{swap_summary(res)}; paged_decode {b1}; "
              f"{len(reqs) - len(diverged)}/{len(reqs)} requests "
              "token-identical to generate_reference(impl=\"flash\")"
              + (f", divergences (position, reference top-2 gap) {diverged}"
                 if diverged else ""))
        check(all(gap < TIE_GAP for _, gap in diverged.values()),
              f"{label}: tokens differ from generate_reference beyond a "
              f"tie: {diverged}")
        out[name] = {"wall_s": wall, "tokens": tokens,
                     "prefill_rounds": eng.prefill_rounds,
                     "decode_steps": eng.decode_steps,
                     "decode_variants": b1, "graphs": graphs,
                     "preemptions": res.metrics.num_preemptions,
                     "counts": swap_summary(res), "diverged": diverged,
                     "decode_step_ms": decode_step_ms(res)}
        del eng
    return out


def hybrid_serve_bf16(torch, pa, cfg, params, refs):
    """Phase 23 (d): the hybrid smoke workload in bf16 with B1 on the ring
    (``impl="paged"``): every replay bit-equal to its eager call on cloned
    random state, then the run through the graphs (``check_graph_run``),
    B1 launches = layers x decode steps through ``split_mma``, and the
    requests equal to ``refs`` counted (not a gate); tokens/s, the wall of
    a decode-only batch and the decode graph's replay time (device time,
    CUDA events) beside the step's byte bound."""
    from repro_torch.launch.serve import hybrid_smoke_server
    label = f"hymba bf16 batched serve (impl paged, {cfg.num_layers} layers)"
    eng, reqs = hybrid_smoke_server(cfg, params, device=DEVICE, impl="paged")
    cmp = replay_vs_eager(torch, eng, seed=41)
    for what, c in cmp.items():
        check(c["bit_equal"], f"{label} {what}: the replay differs from "
              f"the eager call on cloned state: {c}")
    print(f"  {label}: {len(cmp)} replays bit-equal to their eager calls "
          "on cloned random state")
    torch.cuda.synchronize()
    zero_counts(pa.paged_decode_cuda, pa.paged_prefill_cuda)
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_graph_run(eng, before, label)
    L = cfg.num_layers
    b1 = dict(pa.paged_decode_cuda.launches_by_variant)
    check(b1 == {**dict.fromkeys(b1, 0), "split_mma": L * eng.decode_steps}
          and eng.decode_steps > 0 and pa.paged_prefill_cuda.launches == 0,
          f"{label}: paged_decode launches by variant {b1}, expected "
          f"{L} x {eng.decode_steps} split_mma")
    check(all(r.finished for r in reqs), f"{label}: unfinished requests")
    tokens = sum(len(o) for o in res.outputs.values())
    same = sum(res.outputs[r.rid] == refs[r.rid] for r in reqs)
    decode_only = sum(1 for b in res.metrics.batches
                      if b.num_decode and not b.num_prefill)
    step_ms = decode_step_ms(res)
    graph_ms = event_ms(torch, eng._decode_graph())
    # the decode step's bytes: every parameter but the embedding table,
    # the full rings' K/V and the SSM state (read and written)
    ring = sum(eng.cache[k].numel() * eng.cache[k].element_size()
               for k in ("k", "v"))
    state = sum(2 * eng.cache[k].numel() * eng.cache[k].element_size()
                for k in ("h", "conv"))
    bound_ms = (param_bytes(params) + ring + state) / HBM_BYTES_PER_S * 1e3
    print(f"{label}: {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
          f"tok/s; {eng.prefill_rounds} prefill rounds, {eng.decode_steps} "
          f"decode steps ({decode_only} decode-only batches, wall "
          f"{step_ms:.3f} ms each), {graphs['replays']} replays; "
          f"preemptions {res.metrics.num_preemptions}; paged_decode {b1}; "
          f"decode graph replay {graph_ms:.3f} ms of device time against "
          f"the byte bound {bound_ms:.3f} ms (weights "
          f"{param_bytes(params) / 1e9:.2f} GB, rings {ring / 1e9:.3f} GB, "
          f"SSM state read and written {state / 1e9:.3f} GB at 3.35 TB/s); "
          f"{same}/{len(reqs)} requests token-identical to the bf16 "
          "generate_reference(impl=\"flash\") (counted, not a gate)")
    margins = bf16_margins(torch, cfg, params, reqs, res.outputs, refs,
                           label + " vs its reference")
    return {"margins": margins, "wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
            "prefill_rounds": eng.prefill_rounds,
            "decode_steps": eng.decode_steps, "decode_only": decode_only,
            "decode_step_ms": step_ms, "decode_graph_ms": graph_ms,
            "decode_bound_ms": bound_ms, "decode_variants": b1,
            "graphs": graphs, "replay_vs_eager": cmp, "same_tokens": same,
            "preemptions": res.metrics.num_preemptions}


def phase_hybrid(torch, pa, fa, fref, ref, pa_ops, M, get_config):
    """Phase 23: hymba-1.5b at full width, after every earlier phase's
    engines and weights are freed: the kernels at its shapes (a), the
    fp32 serves at full depth (c) and the bf16 one (d); (b), the kernels'
    times, runs with phase 4's."""
    import gc
    from repro_torch.launch.serve import (SMOKE_HYBRID_ARCH,
                                          hybrid_smoke_requests)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(SMOKE_HYBRID_ARCH)
    out = {"errors": phase_hybrid_kernels(torch, pa, fa, fref, ref, pa_ops,
                                          base)}
    pre, dec = ring_wraps(hybrid_smoke_requests(base.vocab_size),
                          base.window)
    check(pre and dec, f"no ring wrap in prefill ({pre}) or decode ({dec})")
    print(f"hymba smoke workload: requests {pre} wrap the {base.window}-slot "
          f"ring while prefilling, {dec} while decoding")
    # (b) B1 on the full ring and B3 over the longest prompt, timed
    inp, times = Inputs(torch, 43), {}
    for dtype in ("bfloat16", "float32"):
        sfx = ATTN_SFX[dtype]
        times["paged_decode_hymba" + DECODE_SFX[dtype]] = time_decode(
            torch, pa, ref, dense_view_case(
                torch, inp, dtype, HYMBA_RING,
                [HYMBA_RING[4]] * HYMBA_RING[0])[0], dtype)
        for name, shape in HYMBA_FLASH.items():
            times[f"flash_attention_hymba_{name}" + sfx] = time_flash(
                torch, fa, fref, flash_case(inp, *shape, dtype), dtype,
                window=base.window)
        times["flash_attention_hymba" + sfx] = \
            times["flash_attention_hymba_S3100" + sfx]
    del inp
    out["times"] = times
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = M.init_params(cfg, seed=0, device=DEVICE)
        reqs = hybrid_smoke_requests(cfg.vocab_size)
        refs, b3, secs = hybrid_references(torch, fa, cfg, params, reqs)
        print(f"hymba {dtype} generate_reference(impl=\"flash\") of "
              f"{len(reqs)} requests at {cfg.num_layers} layers: "
              f"flash_attention launches {b3} = {cfg.num_layers} x "
              f"{len(reqs)} ({secs:.1f} s)")
        key = "fp32" if dtype == "float32" else "bf16"
        out[f"reference_launches_{key}"] = b3
        if dtype == "float32":
            out["fp32"] = hybrid_serve_fp32(torch, pa, M, cfg, params, refs)
        else:
            out["bf16"] = hybrid_serve_bf16(torch, pa, cfg, params, refs)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"phase 23 peak device memory allocated: "
          f"{out['max_memory_allocated'] / 2**30:.2f} GiB")
    return out


# --------------------------------------------------------------------- #
# phase 24: the VLM and audio families (paligemma-3b, musicgen-medium)
# --------------------------------------------------------------------- #

#: B2 at D = 256 beyond the serving shapes: (B, c, page, maxp, starts,
#: lengths) -- page 8 with starts off the 64-key tile, a padded row and a
#: length-0 row; page 64 with a start one past a page
PREFILL_256 = {"page8": (4, 96, 8, 40, [0, 37, 100, 200], [96, 50, 0, 80]),
               "page64": (3, 128, 64, 5, [0, 70, 129], [128, 3, 100])}
#: B3 at PaliGemma's heads: (B, S, prefix_len) -- the image-prefix
#: prefill (256 patches + 256 text tokens), a ragged S with a prefix
#: inside one 64-row tile pair, and two without a prefix
FLASH_256 = {"S512_prefix256": (2, 512, 256), "S197_prefix100": (2, 197, 100),
             "S300": (1, 300, 0), "S77": (1, 77, 0)}


def audio_decode_case(torch, inp, dtype):
    """B1 at the audio smoke engine's shapes: its 8 slots mid-generation
    (each prompt + 64 tokens, 564-1564), pages of 16 under 2048-token
    tables, MusicGen's 24 over 24 heads of 64."""
    from repro_torch.launch.serve import (SMOKE_AUDIO_ENGINE as E,
                                          SMOKE_AUDIO_SECONDS)
    ctx = [round(sec * 200) + 64 for sec in SMOKE_AUDIO_SECONDS]
    return decode_case(torch, inp, E.nslots, *HEADS["musicgen"],
                       E.page_size, E.cache_len // E.page_size, dtype, ctx)


def audio_prefill_case(torch, inp, dtype):
    """B2 at a full prefill round of the audio smoke engine: 8 rows of
    256-token chunks at starts 0-1280 (the longest prompts' later
    chunks)."""
    from repro_torch.launch.serve import SMOKE_AUDIO_ENGINE as E
    starts = [0, 256, 512, 768, 1024, 1280, 0, 256]
    return prefill_case(torch, inp, E.nslots, E.chunk, *HEADS["musicgen"],
                        E.page_size, E.cache_len // E.page_size, dtype,
                        starts, [E.chunk] * E.nslots)


def phase_frontend_kernels(torch, pa, ref, fa, fref, P_main, ecfg):
    """Phase 24 (a): B1, B2 and B3 at head dim 256 (PaliGemma's 8 over 1
    heads) against their plain versions in both dtypes, each case one
    launch of its dtype's variant within ``TOL``: B1 at the serving
    shapes (shared prefix pages, repeated bit for bit), on, before and
    past its split edges with ctx = 1, and at ctx 2048; B2 at the serving
    shapes and ``PREFILL_256`` (pool bytes outside the written slots kept
    bit for bit, padded rows zero); B3 over ``FLASH_256``.  Then B1 and B2
    at MusicGen's serving shapes (``audio_decode_case``,
    ``audio_prefill_case``: 24 over 24 heads of 64)."""
    inp = Inputs(torch, 47)
    H, Hkv, D = HEADS["paligemma"]
    errs = {"paged_decode": {}, "paged_prefill": {}, "flash_attention": {}}
    page, npages = ecfg.page_size, ecfg.cache_len // ecfg.page_size
    for dtype in ("float32", "bfloat16"):
        e = errs["paged_decode"]
        e[f"main_{dtype}"] = check_decode(
            torch, pa, ref, main_path_decode(torch, inp, dtype, P_main, ecfg,
                                             HEADS["paligemma"]),
            dtype, f"B1 D256 serving shapes {dtype}", repeat=True)
        width = page * npages
        ctx, span = split_edges(pa, 10, Hkv, width)
        ctx = sorted(set(ctx) | {1, span - 1, span, span + 1, width})
        e[f"edges_{dtype}"] = check_decode(
            torch, pa, ref, decode_case(torch, inp, len(ctx), H, Hkv, D,
                                        page, npages, dtype, ctx),
            dtype, f"B1 D256 span {span} ctx {ctx} {dtype}")
        e[f"ctx2048_{dtype}"] = check_decode(
            torch, pa, ref, decode_case(torch, inp, 1, H, Hkv, D, page, 128,
                                        dtype, [2048]),
            dtype, f"B1 D256 ctx 2048 {dtype}")
        e = errs["paged_prefill"]
        e[f"main_{dtype}"] = check_prefill(
            torch, pa, ref, main_path_prefill(torch, inp, dtype, P_main,
                                              ecfg, HEADS["paligemma"]),
            dtype, f"B2 D256 serving shapes {dtype}")
        for name, (B, c, pg, maxp, st, ln) in PREFILL_256.items():
            e[f"{name}_{dtype}"] = check_prefill(
                torch, pa, ref, prefill_case(torch, inp, B, c, H, Hkv, D, pg,
                                             maxp, dtype, st, ln),
                dtype, f"B2 D256 {name} starts {st} lengths {ln} {dtype}")
        for name, (B, S, pre) in FLASH_256.items():
            errs["flash_attention"][f"{name}_{dtype}"] = check_flash(
                torch, fa, fref, flash_case(inp, B, S, H, Hkv, D, dtype),
                dtype, f"B3 D256 {name} {dtype}", prefix_len=pre)
        errs["flash_attention"][f"main_{dtype}"] = \
            errs["flash_attention"][f"S512_prefix256_{dtype}"]
        errs["paged_decode"][f"musicgen_{dtype}"] = check_decode(
            torch, pa, ref, audio_decode_case(torch, inp, dtype),
            dtype, f"B1 musicgen serving shapes {dtype}")
        errs["paged_prefill"][f"musicgen_{dtype}"] = check_prefill(
            torch, pa, ref, audio_prefill_case(torch, inp, dtype),
            dtype, f"B2 musicgen serving shapes {dtype}")
    print(f"head dim 256 kernels (PaliGemma H{H} Hkv{Hkv}) and MusicGen's "
          f"heads, fp32 and bf16, each one launch of its variant, within "
          f"tolerance of the plain versions: max abs err {errs}")
    return errs


def time_frontend_kernels(torch, pa, ref, fa, fref, P_main, ecfg):
    """Phase 24 (b): B1 and B2 at PaliGemma's serving shapes and B3 at its
    image-prefix prefill (B = 2, 256 patches + 256 text, ``prefix_len``
    256), and B1 and B2 at MusicGen's, both variants, with phase 4's
    method (``time_decode``, ``time_prefill``, ``time_flash``)."""
    inp, times = Inputs(torch, 53), {}
    B, S, pre = FLASH_256["S512_prefix256"]
    for dtype in ("bfloat16", "float32"):
        sfx, dsfx = ATTN_SFX[dtype], DECODE_SFX[dtype]
        times["paged_decode_d256" + dsfx] = time_decode(
            torch, pa, ref, main_path_decode(torch, inp, dtype, P_main, ecfg,
                                             HEADS["paligemma"]), dtype)
        times["paged_prefill_d256" + sfx] = time_prefill(
            torch, pa, ref, main_path_prefill(torch, inp, dtype, P_main,
                                              ecfg, HEADS["paligemma"]),
            dtype)
        times["flash_attention_d256" + sfx] = time_flash(
            torch, fa, fref, flash_case(inp, B, S, *HEADS["paligemma"],
                                        dtype), dtype, prefix_len=pre)
        times["paged_decode_musicgen" + dsfx] = time_decode(
            torch, pa, ref, audio_decode_case(torch, inp, dtype), dtype)
        times["paged_prefill_musicgen" + sfx] = time_prefill(
            torch, pa, ref, audio_prefill_case(torch, inp, dtype), dtype)
    return times


def decode_graph_time(torch, eng, cfg, params, ctx):
    """The decode graph's replay (device time, CUDA events) with every
    slot active at contexts ``ctx``, beside the step's byte bound: the
    params but the embedding table, and the K/V of those contexts, over
    3.35 TB/s.  After the run: the tables name freed pages, which are
    read, and the replays advance ``ctx`` by 12 and write into them."""
    g = eng._decode_graph()
    cohort = g.inputs[0]
    cohort.copy_(torch.tensor([[0] * len(ctx), ctx, [1] * len(ctx)],
                              dtype=torch.int32, device=DEVICE))
    ms = event_ms(torch, g)
    kv = (sum(ctx) * cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim_
          * eng.k_pools.element_size())
    wb = param_bytes(params)
    return {"decode_graph_ms": ms, "weight_bytes": wb, "kv_bytes": kv,
            "decode_bound_ms": (wb + kv) / HBM_BYTES_PER_S * 1e3,
            "ctx": list(ctx)}


def frontend_serve(torch, pa, M, cfg, params, label, server, refs,
                   replays=False, ctx=None, **kw):
    """Phase 24 (c)/(e): one serve of ``server``'s workload through the
    step graphs (``check_graph_run``; with ``replays``, every replay first
    held bit-equal to its eager call on cloned random state), the kernel
    counters zeroed just before it: on the pooled plane B2 = layers x
    prefill rounds and B1 = layers x decode steps, on ``batched`` with
    ``impl="paged"`` B1 = layers x decode steps and no B2, all through
    the dtype's variants.  With ``refs`` (fp32), every request's tokens
    must equal them (``generate_reference``, filled in where missing),
    but for a token flipped at a reference top-2 gap below ``TIE_GAP``,
    which is reported.  With ``ctx``, the decode graph's device time
    against its byte bound (``decode_graph_time``).  Replays on the slot
    plane are held within ``TOL`` (cuBLAS may pick another algorithm
    under capture, as in phase 21), on the pooled plane bit for bit."""
    dtype, L = cfg.dtype, cfg.num_layers
    eng, reqs = server(cfg, params, device=DEVICE, **kw)
    pooled = eng.k_pools is not None
    cmp = replay_vs_eager(torch, eng, seed=59, device=DEVICE) \
        if replays else {}
    for what, c in cmp.items():
        check(c["bit_equal"] if pooled else c["close"],
              f"{label} {what}: the replay differs from the eager call on "
              f"cloned state: {c}")
    torch.cuda.synchronize()
    zero_counts(pa.paged_decode_cuda, pa.paged_prefill_cuda)
    before = graph_counts(eng)
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    graphs = check_graph_run(eng, before, label)
    b1 = dict(pa.paged_decode_cuda.launches_by_variant)
    b2 = dict(pa.paged_prefill_cuda.launches_by_variant)
    want1 = L * eng.decode_steps
    want2 = L * eng.prefill_rounds if pooled else 0
    check(b1 == {**dict.fromkeys(b1, 0), DECODE_VARIANT[dtype]: want1}
          and b2 == {**dict.fromkeys(b2, 0), VARIANT[dtype]: want2}
          and want1 > 0 and (want2 > 0 or not pooled),
          f"{label}: launches by variant B1 {b1}, B2 {b2}; expected "
          f"{L} x {eng.decode_steps} {DECODE_VARIANT[dtype]} and {want2} "
          f"{VARIANT[dtype]}")
    check(all(r.finished for r in reqs), f"{label}: unfinished requests")
    tokens = sum(len(o) for o in res.outputs.values())
    out = {"wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
           "prefill_rounds": eng.prefill_rounds,
           "decode_steps": eng.decode_steps, "graphs": graphs,
           "replay_vs_eager": cmp, "decode_variants": b1,
           "prefill_variants": b2,
           "preemptions": res.metrics.num_preemptions,
           "trie_hits": res.swap_stats["trie_hits"],
           "decode_step_ms": decode_step_ms(res),
           "outputs": res.outputs}
    if ctx is not None:
        out.update(decode_graph_time(torch, eng, cfg, params, ctx))
    cache_len = eng.ecfg.cache_len
    del eng
    same, diverged = None, {}
    if refs is not None:
        from repro_torch.serving import generate_reference
        for r in reqs:
            if r.rid not in refs:
                refs[r.rid] = generate_reference(
                    cfg, params, r.prompt, r.output_len,
                    cache_len=cache_len, device=DEVICE)
        same = sum(res.outputs[r.rid] == refs[r.rid] for r in reqs)
        diverged = divergences(torch, M, cfg, params, reqs, res.outputs,
                               refs, cache_len=cache_len)
        check(all(gap < TIE_GAP for _, gap in diverged.values()),
              f"{label}: tokens differ from generate_reference beyond a "
              f"tie: {diverged}")
    out.update(same_tokens=same, diverged=diverged)
    print(f"{label}: {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
          f"tok/s; {out['prefill_rounds']} prefill rounds, "
          f"{out['decode_steps']} decode steps, "
          f"{graphs['replays']} replays of {graphs['graphs']} graphs, "
          f"preemptions {out['preemptions']}, prefix hits "
          f"{out['trie_hits']}; wall of a decode-only batch "
          f"{out['decode_step_ms']:.3f} ms; launches B1 {b1}, B2 {b2}"
          + ("" if same is None else
             f"; {same}/{len(reqs)} requests token-identical to "
             "generate_reference")
          + (f" (divergences (position, reference top-2 gap) {diverged})"
             if diverged else "")
          + (f"; {len(cmp)} replays "
             f"{'bit-equal to' if pooled else 'within TOL of'} their eager "
             "calls on cloned random state" if cmp else "")
          + (f"; decode graph replay {out['decode_graph_ms']:.3f} ms of "
             f"device time against the byte bound "
             f"{out['decode_bound_ms']:.3f} ms (weights "
             f"{out['weight_bytes'] / 1e9:.2f} GB, K/V "
             f"{out['kv_bytes'] / 1e9:.3f} GB at contexts {ctx})"
             if ctx is not None else ""))
    return out


def vlm_prefill_batch(torch, cfg):
    """PaliGemma's image-prefix prefill input: B = 2 rows of
    ``num_patches`` (256) precomputed patch embeddings (fp32, N(0, 1) as
    ``data.batch_with_frontend`` makes them) and 256 text tokens."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(61)
    B, S = 2, 256
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=DEVICE),
            "patch_embeds": torch.randn((B, cfg.num_patches, cfg.d_model),
                                        generator=gen, device=DEVICE)}


def vlm_prefill(torch, fa, M, cfg, params):
    """Phase 24 (d): ``prefill(impl="flash")`` with the image prefix on
    B3 (``prefix_len`` = 256, one launch per layer through the dtype's
    variant).  fp32: logits and cache within ``PREFILL_TOL`` of
    ``impl="reference"``, the index 512; bf16: flash's and the bf16
    reference's relative L2 from the fp32 reference on the same weights,
    flash at most ``BF16_PREFILL_RATIO`` times the bf16 reference's."""
    batch = vlm_prefill_batch(torch, cfg)
    B, S = batch["tokens"].shape
    Sx = S + cfg.num_patches
    torch.cuda.synchronize()
    zero_counts(fa.flash_attention_cuda)
    t0 = time.perf_counter()
    fl, fl_cache = M.prefill(cfg, params, batch, cache_len=Sx, impl="flash")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    variants = dict(fa.flash_attention_cuda.launches_by_variant)
    L = cfg.num_layers
    check(variants == {**dict.fromkeys(variants, 0), VARIANT[cfg.dtype]: L},
          f"VLM prefill {cfg.dtype}: flash_attention launches by variant "
          f"{variants}, expected {L} {VARIANT[cfg.dtype]}")
    check(fl_cache["index"].tolist() == [Sx] * B,
          f"VLM prefill: cache index {fl_cache['index'].tolist()}")
    rf, rf_cache = M.prefill(cfg, params, batch, cache_len=Sx)
    out = {"launches": L, "variants": variants, "wall_s": wall,
           "shape": [B, cfg.num_patches, S]}
    if cfg.dtype == "float32":
        err = {}
        for name, got, want in [("logits", fl, rf),
                                ("k", fl_cache["k"], rf_cache["k"]),
                                ("v", fl_cache["v"], rf_cache["v"])]:
            d = (got - want).abs()
            bad = d > PREFILL_TOL["atol"] + PREFILL_TOL["rtol"] * want.abs()
            check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
                  f"VLM prefill {name}: flash vs reference max abs err "
                  f"{d.max().item():.3g}")
            err[name] = d.max().item()
        check(torch.equal(torch.argmax(fl, -1), torch.argmax(rf, -1)),
              "VLM prefill argmax differs between flash and reference")
        out["max_abs_err"] = err
        print(f"VLM prefill (PaliGemma-3B fp32, B={B}, {cfg.num_patches} "
              f"patches + {S} text tokens, prefix_len {cfg.num_patches}): "
              f"flash vs reference max abs err "
              + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
              + f" (rtol=atol 1e-3); flash_attention {variants}; "
              f"{wall:.2f} s")
        return out
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    truth, truth_cache = M.prefill(cfg32, _tree_to(params, torch.float32),
                                   batch, cache_len=Sx)
    err = {}
    for name in ("logits", "k", "v"):
        got, want, tr = ((fl, rf, truth) if name == "logits" else
                         (fl_cache[name], rf_cache[name], truth_cache[name]))
        check(bool(torch.isfinite(got.float()).all()),
              f"bf16 VLM prefill {name}: non-finite")
        err[name] = (rel_l2(torch, got, tr), rel_l2(torch, want, tr))
    print(f"VLM prefill (PaliGemma-3B bf16, B={B}, {cfg.num_patches} "
          f"patches + {S} text tokens): rel L2 to the fp32 reference, "
          f"flash / bf16 reference: "
          + ", ".join(f"{n} {a:.4g} / {b:.4g}" for n, (a, b) in err.items())
          + f" (flash may be {BF16_PREFILL_RATIO}x); flash_attention "
          f"{variants}; {wall:.2f} s")
    for name, (a, b) in err.items():
        check(a <= BF16_PREFILL_RATIO * b,
              f"bf16 VLM prefill {name}: flash {a:.4g} from the fp32 "
              f"reference, beyond {BF16_PREFILL_RATIO} x the bf16 "
              f"reference's {b:.4g}")
    out["rel_l2_to_fp32"] = err
    return out


#: the trainer's runs: arch -> ``launch/train.py`` arguments; PaliGemma
#: at 8 of its 18 layers (AdamW's fp32 master weights and moments, old
#: and new while a step runs, are 14 B a parameter twice: 85 GB at full
#: depth), 256 patch embeddings in front of 256 text tokens.  Adam's
#: first steps move every weight by about lr, which a layer of fan-in n
#: adds up to ~lr * n in its output: SmolLM's 1e-3 (d_ff 2560) made these
#: losses climb (d_ff 16384 and 6144), so the rates are lower
TRAIN_STEPS = 8
FRONTEND_TRAIN = {
    "paligemma-3b": ["--layers", "8", "--batch", "4", "--seq", "256",
                     "--lr", "3e-5"],
    "musicgen-medium": ["--batch", "4", "--seq", "512", "--lr", "5e-5"]}


def trainer_runs(torch, runs, phase: str):
    """``launch/train.py``'s own loop for ``TRAIN_STEPS`` bf16 steps on
    each of ``runs`` (arch -> extra arguments) at full width (fp32 AdamW
    state): loss and grad norm finite at every step, the loss falling;
    the batch reaches ``train_loss`` as ``batch_with_frontend`` made it
    (tokens int64, a patch model's embeddings float32).  Returns, per
    arch, the losses, grad norms, step seconds, tokens/s, peak memory
    and B4's launches over the steps."""
    import gc
    import logging
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_with_frontend
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.launch import train as T
    logging.getLogger("repro_torch.train").setLevel(logging.WARNING)
    out = {}
    for arch, extra in runs.items():
        args = T.parse_args(["--full", "--arch", arch, "--steps",
                             str(TRAIN_STEPS), "--device", DEVICE] + extra)
        cfg = get_config(arch)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
        dev = T.batch_at(cfg, dcfg, 0, DEVICE)
        for k, v in batch_with_frontend(cfg, dcfg, 0).items():
            want = torch.from_numpy(v).to(DEVICE)
            check(dev[k].dtype == (torch.long if k != "patch_embeds"
                                   else torch.float32)
                  and torch.equal(dev[k], want.to(dev[k].dtype)),
                  f"{arch}: batch_at's {k} is {dev[k].dtype}, not "
                  "batch_with_frontend's")
        torch.cuda.reset_peak_memory_stats()
        wkv.wkv6_cuda.launches = 0
        with torch.enable_grad():
            hist = T.train(args)
        peak = torch.cuda.max_memory_allocated()
        b4 = wkv.wkv6_cuda.launches
        losses = [h["loss"] for h in hist]
        for h in hist:
            check(all(math.isfinite(h[k]) for k in ("loss", "grad_norm")),
                  f"{arch}: non-finite training step: {h}")
        check(losses[-1] < losses[0], f"{arch}: loss did not fall: {losses}")
        steady = sorted(h["seconds"] for h in hist[1:])
        step_s = steady[len(steady) // 2]
        tok_s = args.batch * args.seq / step_s
        layers = args.layers or cfg.num_layers
        print(f"{phase} train ({arch} bf16 at {layers} of {cfg.num_layers} "
              f"layers, fp32 AdamW, lr {args.lr:g}, B={args.batch}, "
              f"S={args.seq}"
              + (f" + {cfg.num_patches} patches" if cfg.num_patches else "")
              + f"): losses {[round(x, 4) for x in losses]}, grad norms "
              f"{[round(h['grad_norm'], 3) for h in hist]}; step seconds "
              f"{[round(h['seconds'], 3) for h in hist]}; median step "
              f"{step_s:.3f} s after the first = {tok_s:.0f} text tokens/s; "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; B4 launches "
              f"{b4}")
        out[arch] = {"layers": layers, "losses": losses,
                     "grad_norms": [h["grad_norm"] for h in hist],
                     "step_s": [h["seconds"] for h in hist],
                     "tok_per_s": tok_s, "max_memory_allocated": peak,
                     "wkv6_launches": b4}
        del dev
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_frontends(torch, pa, ref, fa, fref, M, get_config, P_main, ecfg):
    """Phase 24: the VLM and audio families at full width, after every
    earlier phase's engines and weights are freed.  (a) B1-B3 at head dim
    256 and B1/B2 at MusicGen's shapes against their plain versions; (b)
    their times; (c) PaliGemma-3B (18 layers) on ``smoke_server``'s
    engine and workload in fp32 (and on ``batched`` with
    ``impl="paged"``) and bf16; (d) its image-prefix prefill on B3 in
    fp32 and bf16; (e) MusicGen-medium (48 layers) on
    ``audio_smoke_server`` in fp32 and bf16; (f) both trainers."""
    import gc
    from repro_torch.launch.serve import (SMOKE_AUDIO_ARCH,
                                          SMOKE_AUDIO_SECONDS,
                                          SMOKE_VLM_ARCH, SMOKE_WORKLOAD,
                                          audio_smoke_server,
                                          smoke_plane_server, smoke_server)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"errors": phase_frontend_kernels(torch, pa, ref, fa, fref, P_main,
                                            ecfg),
           "times": time_frontend_kernels(torch, pa, ref, fa, fref, P_main,
                                          ecfg)}
    # mid-decode contexts of the two workloads, for the decode bound
    vlm_ctx = [SMOKE_WORKLOAD["input_len"] + 24] * ecfg.nslots
    audio_ctx = [round(sec * 200) + 64 for sec in SMOKE_AUDIO_SECONDS]
    for arch, runs in (
            (SMOKE_VLM_ARCH, [("paged", smoke_server, {}, vlm_ctx),
                              ("batched_paged", smoke_plane_server,
                               dict(plane="batched", impl="paged"), None)]),
            (SMOKE_AUDIO_ARCH, [("paged", audio_smoke_server, {},
                                 audio_ctx)])):
        key = "vlm" if arch == SMOKE_VLM_ARCH else "audio"
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        params = M.init_params(cfg, seed=0, device=DEVICE)
        refs = {}
        for name, server, kw, ctx in runs:
            label = f"{arch} fp32 {name} serve ({cfg.num_layers} layers)"
            out[f"{key}_fp32_{name}"] = frontend_serve(
                torch, pa, M, cfg, params, label, server, refs,
                replays=name != "paged", **kw)
        if key == "vlm":
            out["vlm_prefill_fp32"] = vlm_prefill(torch, fa, M, cfg, params)
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        params16 = _tree_to(params, torch.bfloat16)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if key == "vlm":
            out["vlm_prefill_bf16"] = vlm_prefill(torch, fa, M, cfg16,
                                                  params16)
        name, server, kw, ctx = runs[0]
        out[f"{key}_bf16_{name}"] = frontend_serve(
            torch, pa, M, cfg16, params16,
            f"{arch} bf16 {name} serve ({cfg.num_layers} layers)", server,
            None, replays=True, ctx=ctx, **kw)
        del params16
        gc.collect()
        torch.cuda.empty_cache()
    out["serve_max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["train"] = trainer_runs(torch, FRONTEND_TRAIN, "phase 24")
    print(f"phase 24 peak device memory allocated: serves "
          f"{out['serve_max_memory_allocated'] / 2**30:.2f} GiB, trainers "
          + ", ".join(f"{a} {t['max_memory_allocated'] / 2**30:.2f} GiB"
                      for a, t in out["train"].items()))
    return out


# --------------------------------------------------------------------- #
# phase 25: every served family trains (MoE, hybrid, RWKV6)
# --------------------------------------------------------------------- #

#: the fp32 gradient tolerance of ``tests/test_torch_train_families.py``
#: (there the CPU is held against JAX; here the card against the CPU)
GRAD_TOL = dict(rtol=5e-4, atol=5e-6)
#: (a): (arch, moe_impl), each reduced in fp32, weights from seed 0
GRAD_CASES = [("qwen2-moe-a2.7b", "sparse"), ("qwen2-moe-a2.7b", "dense"),
              ("qwen3-moe-30b-a3b", "sparse"), ("qwen3-moe-30b-a3b", "dense"),
              ("hymba-1.5b", "sparse"), ("rwkv6-7b", "sparse")]
#: (b): one SSM chunk of hymba-1.5b at full width, (B, Q, d_inner, N)
SCAN_FULL = (2, 128, 3200, 16)
#: (c): full width at the depths whose ~2 B parameters fit AdamW's fp32
#: state, old and new (~28 B a parameter), on one 80 GB card: qwen2-moe
#: 2 of 24 layers (1.83 B), qwen3-moe 2 of 48 (1.87 B), hymba all 32
#: (1.97 B), RWKV6 6 of 32 (1.85 B); the rates scaled down with the
#: widest fan-in, as phase 24's
FAMILY_TRAIN = {
    "qwen2-moe-a2.7b": ["--layers", "2", "--batch", "4", "--seq", "512",
                        "--lr", "1e-4"],
    "qwen3-moe-30b-a3b": ["--layers", "2", "--batch", "4", "--seq", "512",
                          "--lr", "1e-4"],
    "hymba-1.5b": ["--batch", "4", "--seq", "512", "--lr", "5e-5"],
    "rwkv6-7b": ["--layers", "6", "--batch", "4", "--seq", "512",
                 "--lr", "3e-5"]}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + k + "/")
        else:
            yield prefix + k, tree[k]


def family_grads_vs_cpu(torch, cases=GRAD_CASES):
    """Phase 25 (a): ``train_loss``'s fp32 loss and gradients on the card
    against the port's on the CPU (which the tests hold against JAX), for
    each of ``cases`` (B = 2, S = 16, remat): every gradient element
    within ``GRAD_TOL``, the loss within 1e-5; B4 never launched."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.models import model as M
    from repro_torch.training import make_loss_fn, value_and_grad
    out = {}
    for arch, moe_impl in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        params = M.init_params(cfg, seed=0, device="cpu")
        toks = torch.randint(cfg.vocab_size, (2, 17),
                             generator=torch.Generator().manual_seed(3))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        fn = value_and_grad(make_loss_fn(cfg, moe_impl=moe_impl))
        loss_c, grads_c = fn(params, batch)
        wkv.wkv6_cuda.launches = 0
        loss_d, grads_d = fn(_tree_to(params, DEVICE),
                             {k: v.to(DEVICE) for k, v in batch.items()})
        check(wkv.wkv6_cuda.launches == 0,
              f"{arch}: train_loss launched B4 {wkv.wkv6_cuda.launches} times")
        worst = (0.0, "", 0.0)
        dev = dict(_leaves(grads_d))
        for name, gc_ in _leaves(grads_c):
            gd = dev[name].cpu()
            diff = (gd - gc_).abs()
            ratio = float((diff / (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                                   * gc_.abs())).max())
            rel = float(diff.max() / gc_.abs().max().clamp_min(1e-30))
            if ratio >= worst[0]:
                worst = (ratio, name, rel)
        dloss = abs(float(loss_d) - float(loss_c))
        label = f"{arch} {moe_impl}" if cfg.num_experts else arch
        print(f"phase 25 (a) {label} reduced fp32 grads, card against CPU: "
              f"loss {float(loss_d):.6f} (|diff| {dloss:.2e}); worst leaf "
              f"{worst[1]}: {worst[0]:.3f} of GRAD_TOL, max |diff| / max "
              f"|grad| {worst[2]:.2e}")
        check(math.isfinite(float(loss_d))
              and dloss <= 1e-5 * abs(float(loss_c)),
              f"{label}: loss {float(loss_d)} on the card, {float(loss_c)} "
              "on the CPU")
        check(worst[0] <= 1.0, f"{label}: gradient {worst[1]} outside "
              f"GRAD_TOL ({worst[0]:.3f} of it)")
        out[label] = {"loss": float(loss_d), "loss_diff": dloss,
                      "worst_leaf": worst[1], "worst_of_tol": worst[0],
                      "worst_rel": worst[2]}
    return out


def scan_full_width(torch):
    """Phase 25 (b): ``ssm.ChunkScan`` alone at hymba's full width
    (``SCAN_FULL``, fp32): h, dL/da and dL/db on the card against the CPU
    within ``TOL["float32"]``, and its forward + backward timed."""
    from repro_torch.models import ssm
    B, Q, di, N = SCAN_FULL
    g = torch.Generator().manual_seed(25)
    # a = exp(dt * A): decays from ~1 down to e^-4, as dt * A spans
    a = torch.exp(-4.0 * torch.rand((B, Q, di, N), generator=g))
    b = torch.randn((B, Q, di, N), generator=g)
    w = torch.randn((B, Q, di, N), generator=g)

    def run(a, b, w):
        a, b = a.requires_grad_(True), b.requires_grad_(True)
        with torch.enable_grad():
            h = ssm.chunk_scan(a, b)
            da, db = torch.autograd.grad(h, (a, b), grad_outputs=w)
        return h.detach(), da, db

    want = run(a, b, w)
    on_card = [t.to(DEVICE) for t in (a, b, w)]
    errs = {}
    for what, x, y in zip(("h", "da", "db"), run(*on_card), want):
        errs[what] = compare(torch, x, y.to(DEVICE), "float32",
                             f"ChunkScan {what} at {SCAN_FULL}")
    ms = event_ms(torch, lambda: run(*on_card), iters=5, warm=1)
    nbytes = 4 * B * Q * di * N
    print(f"phase 25 (b) ChunkScan (B, Q, d_inner, N) = {SCAN_FULL} fp32, "
          f"card against CPU: max abs err h {errs['h']:.2e}, da "
          f"{errs['da']:.2e}, db {errs['db']:.2e}; forward + backward "
          f"{ms:.3f} ms; saved for the backward: a and h, "
          f"{2 * nbytes / 1e6:.0f} MB")
    return {"max_abs_err": errs, "fwd_bwd_ms": ms,
            "saved_bytes": 2 * nbytes}


def rwkv_serve_launches(torch, layers: int) -> int:
    """Phase 25 (d): a no-grad prefill of RWKV6-7B at ``layers`` layers
    (bf16, one row of 64 tokens) still runs B4, once a layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=layers,
                              dtype="bfloat16")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    toks = torch.randint(cfg.vocab_size, (1, 64), device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(4))
    wkv.wkv6_cuda.launches = 0
    with torch.no_grad():
        logits, _ = M.prefill(cfg, params, {"tokens": toks}, 64)
    n = wkv.wkv6_cuda.launches
    check(bool(torch.isfinite(logits.float()).all()),
          "RWKV6 prefill: non-finite logits")
    check(n == layers, f"RWKV6 prefill launched B4 {n} times, not {layers}")
    return n


def phase_train_families(torch, card: str):
    """Phase 25: the MoE, hybrid and RWKV6 families train.  (a) reduced
    fp32 gradients on the card against the CPU; (b) the hybrid scan's
    autograd function at full width; (c) ``launch/train.py``'s loop for
    ``TRAIN_STEPS`` bf16 steps on each of ``FAMILY_TRAIN``; (d) B4 never
    launched by the RWKV6 training steps, and still once a layer by a
    prefill."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 25 on {card}")
    out = {"grads": family_grads_vs_cpu(torch),
           "scan": scan_full_width(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = trainer_runs(torch, FAMILY_TRAIN, "phase 25 (c)")
    rwkv = out["train"]["rwkv6-7b"]
    check(rwkv["wkv6_launches"] == 0,
          f"RWKV6 training launched B4 {rwkv['wkv6_launches']} times")
    out["rwkv_prefill_wkv6_launches"] = rwkv_serve_launches(
        torch, rwkv["layers"])
    print(f"phase 25 (d) B4 launches: {rwkv['wkv6_launches']} over "
          f"{TRAIN_STEPS} RWKV6 training steps, "
          f"{out['rwkv_prefill_wkv6_launches']} in a {rwkv['layers']}-layer "
          f"prefill; peak memory "
          + ", ".join(f"{a} {t['max_memory_allocated'] / 2**30:.2f} GiB"
                      for a, t in out["train"].items()))
    return out


# --------------------------------------------------------------------- #
# phase 26: the distributed layer on ranks that share the card
# --------------------------------------------------------------------- #

#: ranks of phase 26, all on the one card (``gloo``: NCCL refuses two
#: ranks on one device); a time here is not a multi-card time
DIST_RANKS = 4
#: (a) TinyLlama's heads at ``SHAPES["decode_32k"]``'s length: K/V 268 MB
#: in bf16, split four ways; ragged lengths on and around the shard
#: edges (8192 per rank)
DIST_DECODE = dict(B=8, S=32768, H=32, Hkv=4, D=64)
DIST_LENGTHS = [1, 100, 8191, 8192, 8193, 16385, 30000, 32768]
#: (b) full-width TinyLlama greedy decode, fp32
DIST_GREEDY = dict(B=2, prompt=64, cache_len=256, steps=16)
#: (c) one full-width MoE layer per arch, fp32
DIST_MOE = dict(archs=("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"), B=2, S=512,
                capacity_factor=8.0, tol=2e-4)
#: (d) full-width SmolLM-360M, fp32, two AdamW steps on a (2, 2) mesh
DIST_TRAIN = dict(arch="smollm-360m", layers=32, B=4, S=512, steps=2)
#: the tolerances of ``tests/test_distributed.py``'s sharded train step
DIST_TRAIN_TOL = dict(loss_rtol=1e-5, rtol=1e-4, atol=1e-5)
#: (d)'s AdamW eps.  At the default 1e-8 an element whose gradient is
#: itself ~1e-8 has an update ``lr * g / (|g| + eps)`` that fp32
#: reordering of ``g`` (data-parallel sums) moves by up to ~lr: 4,580 of
#: 361.8 M elements were past the tolerance after two steps, worst
#: 2.9e-4; at 1e-6, 1e-5 and 1e-4 none was (H100, 700 W, torch 2.11).
#: At 1e-6 the update is Lipschitz in ``g`` (constant ``lr / eps``).
DIST_TRAIN_EPS = 1e-6


def _full(x):
    """A DTensor's global value (gathered through the staged all-gather
    on a ``gloo`` card); a plain tensor as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _allclose_err(torch, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    return err, ok


def dist_decode(torch, rank):
    """(a): the sequence-sharded decode and its partials on (1, 4), both
    dtypes, against ``decode_attn_reference`` and B1 on the whole cache;
    the partials' max and sum-exp against the single-device ones."""
    from repro_torch.distributed.collectives import (
        decode_attn_partials, decode_attn_reference,
        make_seqsharded_decode_attn, make_seqsharded_decode_attn_partials)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, DIST_RANKS, device=DEVICE)
    B, S, H, Hkv, D = (DIST_DECODE[k] for k in ("B", "S", "H", "Hkv", "D"))
    lens = torch.tensor(DIST_LENGTHS, dtype=torch.int32, device=DEVICE)
    out = {}
    for dtype in ("float32", "bfloat16"):
        inp = Inputs(torch, seed=26)          # the same draws on every rank
        q = inp.randn(B, H, D, dtype=dtype)
        k = inp.randn(B, S, Hkv, D, dtype=dtype)
        v = inp.randn(B, S, Hkv, D, dtype=dtype)
        got = _full(make_seqsharded_decode_attn(mesh)(q, k, v, lens))
        o2, m2, l2 = (_full(t) for t in
                      make_seqsharded_decode_attn_partials(mesh)(q, k, v,
                                                                 lens))
        ref = decode_attn_reference(q, k, v, lens)
        b1 = pa_ops.decode_attention_dense(q, k, v, lens)
        valid = torch.arange(S, device=DEVICE)[None, :] < lens[:, None]
        _, m1, l1 = decode_attn_partials(q, k, v, valid)
        tol = TOL[dtype]
        res = {"vs_reference": _allclose_err(torch, got, ref, **tol),
               "vs_b1": _allclose_err(torch, got, b1, **tol),
               "partials_vs_reference": _allclose_err(torch, o2, ref, **tol),
               "m_vs_single": _allclose_err(torch, m2, m1, **tol),
               "l_vs_single": _allclose_err(torch, l2, l1, **tol)}
        for what, (err, ok) in res.items():
            check(ok, f"phase 26 (a) {dtype} {what}: max abs err {err:.3g}")
        out[dtype] = {what: err for what, (err, _) in res.items()}
        del q, k, v
    return out


def dist_greedy(torch, rank):
    """(b): full-width TinyLlama, fp32: ``decode_step`` and
    ``decode_step_deferred`` with ``impl="seqsharded"`` on (1, 4), the
    cache placed by ``batch_pspecs``, for ``steps`` greedy steps; tokens
    equal to ``impl="reference"`` on one rank."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.context import set_mesh
    from repro_torch.distributed.fault_tolerance import reshard
    from repro_torch.distributed.sharding import batch_pspecs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    mesh = make_test_mesh(1, DIST_RANKS, device=DEVICE)
    set_mesh(mesh)
    g = DIST_GREEDY
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), dtype="float32")
    params = M.init_params(cfg, seed=0, device=DEVICE)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(26)
    prompt = torch.randint(0, cfg.vocab_size, (g["B"], g["prompt"]),
                           generator=gen, device=DEVICE)
    specs = batch_pspecs(cfg, ShapeConfig("greedy", g["cache_len"], g["B"],
                                          "decode"), mesh)["cache"]
    out = {}
    with torch.no_grad():
        logits0, cache0 = M.prefill(cfg, params, {"tokens": prompt},
                                    cache_len=g["cache_len"])
        for fn in (M.decode_step, M.decode_step_deferred):
            runs = {}
            for impl in ("reference", "seqsharded"):
                cache = dict(cache0)
                if impl == "seqsharded":
                    cache.update(reshard({k: cache0[k] for k in ("k", "v")},
                                         mesh, {k: specs[k]
                                                for k in ("k", "v")}))
                logits, toks = logits0, []
                for _ in range(g["steps"]):
                    nxt = _full(logits).argmax(-1)
                    toks.append(nxt.tolist())
                    logits, cache = fn(cfg, params, nxt, cache, impl=impl)
                runs[impl] = (toks, _full(logits))
            same = runs["reference"][0] == runs["seqsharded"][0]
            err = float((runs["reference"][1]
                         - runs["seqsharded"][1]).abs().max())
            check(same, f"phase 26 (b) {fn.__name__}: seqsharded tokens "
                  f"differ from the reference")
            out[fn.__name__] = {"tokens_equal": same,
                                "last_logits_max_abs_err": err}
    set_mesh(None)
    return out


def dist_moe(torch, rank):
    """(c): ``apply_moe_ep`` on (1, 4) at full width, one layer per arch,
    fp32, against ``apply_moe``'s dense dispatch; gradients finite."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import set_mesh, spmd_scope
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as moe_mod
    mesh = make_test_mesh(1, DIST_RANKS, device=DEVICE)
    set_mesh(mesh)
    c = DIST_MOE
    out = {}
    for arch in c["archs"]:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(0)
        lp = moe_mod.init_moe(gen, cfg, torch.float32)
        x = torch.randn((c["B"], c["S"], cfg.d_model), generator=gen,
                        device=DEVICE) * 0.5
        with torch.no_grad():
            y = _full(moe_mod.apply_moe_ep(lp, cfg, x, c["capacity_factor"]))
            yd = moe_mod.apply_moe(lp, cfg, x)
        err, ok = _allclose_err(torch, y, yd, rtol=c["tol"], atol=c["tol"])
        check(ok, f"phase 26 (c) {arch}: EP against dense {err:.3g}")
        leaves = {k: v.requires_grad_(True) for k, v in lp.items()
                  if not isinstance(v, dict)}
        with spmd_scope():
            loss = (moe_mod.apply_moe_ep(lp, cfg, x, c["capacity_factor"])
                    ** 2).sum()
            grads = torch.autograd.grad(_full(loss), list(leaves.values()))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        check(finite, f"phase 26 (c) {arch}: a gradient is not finite")
        out[arch] = {"experts_per_rank": cfg.padded_experts // DIST_RANKS,
                     "max_abs_err": err, "grads_finite": finite}
        del lp, x, grads
    set_mesh(None)
    return out


def _worst_grad(torch, got, want):
    """(ratio to ``GRAD_TOL``, leaf, max |diff| / max |grad|) of the leaf
    farthest outside ``GRAD_TOL``, ``got`` on the card, ``want`` on the
    host."""
    worst = (0.0, "", 0.0)
    for name, w in want.items():
        w = w.to(got[name].device)
        diff = (got[name] - w).abs()
        ratio = float((diff / (GRAD_TOL["atol"] + GRAD_TOL["rtol"]
                               * w.abs())).max())
        rel = float(diff.max() / w.abs().max().clamp_min(1e-30))
        if ratio >= worst[0]:
            worst = (ratio, name, rel)
    return worst


def dist_train(torch, rank):
    """(d): ``make_train_step`` on full-width SmolLM-360M's DTensor params
    (``param_pspecs(fsdp=False)``) on (2, 2), the batch sharded on
    ``data``, ``steps`` fp32 steps against the one-rank step: the first
    step's gradients leaf by leaf within ``GRAD_TOL``, every step's grad
    norm within rtol 1e-4 (``tests/test_torch_train_families.py``), the
    loss and the params after the last step within ``DIST_TRAIN_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.fault_tolerance import reshard
    from repro_torch.distributed.sharding import (batch_pspecs, fit_specs,
                                                  param_pspecs)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, init_adamw, make_loss_fn,
                                      make_train_step, value_and_grad)
    import torch.distributed as dist
    t = DIST_TRAIN
    cfg = dataclasses.replace(get_config(t["arch"]), dtype="float32",
                              num_layers=t["layers"])
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1,
                          eps=DIST_TRAIN_EPS)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (t["B"], t["S"]), generator=gen,
                         device=DEVICE)
    batch = {"tokens": toks, "labels": toks}
    step = make_train_step(cfg, opt_cfg)
    grad_fn = value_and_grad(make_loss_fn(cfg))
    want = None
    if rank == 0:                        # the one-rank step
        p = M.init_params(cfg, seed=0, device=DEVICE)
        s = init_adamw(p)
        grads = {k: v.cpu() for k, v in _leaves(grad_fn(p, batch)[1])}
        norms = []
        for _ in range(t["steps"]):
            p, s, m = step(p, s, batch)
            norms.append(float(m["grad_norm"]))
        want = ({k: v.cpu() for k, v in _leaves(p)}, float(m["loss"]),
                grads, norms)
        del p, s
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_test_mesh(2, 2, device=DEVICE)
    params = M.init_params(cfg, seed=0, device=DEVICE)
    params = reshard(params, mesh, fit_specs(param_pspecs(cfg, params),
                                             params, mesh))
    bspec = batch_pspecs(cfg, ShapeConfig("train", t["S"], t["B"], "train"),
                         mesh)
    sbatch = reshard(batch, mesh, bspec)
    # gathers are collectives: every rank takes part
    grads = {k: _full(v) for k, v in _leaves(grad_fn(params, sbatch)[1])}
    worst_g = _worst_grad(torch, grads, want[2]) if rank == 0 else None
    del grads
    s, norms = init_adamw(params), []
    for _ in range(t["steps"]):
        params, s, m = step(params, s, sbatch)
        norms.append(float(_full(m["grad_norm"])))
    loss = float(_full(m["loss"]))
    got = {k: _full(v) for k, v in _leaves(params)}
    if rank != 0:
        return {}
    tol = DIST_TRAIN_TOL
    check(worst_g[0] <= 1.0, f"phase 26 (d) first-step gradient "
          f"{worst_g[1]} outside GRAD_TOL ({worst_g[0]:.3f} of it)")
    check(all(math.isclose(a, b, rel_tol=1e-4)
              for a, b in zip(norms, want[3])),
          f"phase 26 (d) grad norms {norms} against the one-rank "
          f"{want[3]}")
    check(math.isclose(loss, want[1], rel_tol=tol["loss_rtol"]),
          f"phase 26 (d) loss {loss} against the one-rank {want[1]}")
    worst = max((_allclose_err(torch, got[k].cpu(), w, rtol=tol["rtol"],
                               atol=tol["atol"]) + (k,)
                 for k, w in want[0].items()), key=lambda e: (not e[1], e[0]))
    check(worst[1], f"phase 26 (d) leaf {worst[2]} off by {worst[0]:.3g}")
    return {"layers": t["layers"],
            "of_layers": get_config(t["arch"]).num_layers,
            "adamw_eps": DIST_TRAIN_EPS, "loss": loss,
            "one_rank_loss": want[1], "grad_norms": norms,
            "one_rank_grad_norms": want[3],
            "grad_worst_leaf": worst_g[1], "grad_worst_of_tol": worst_g[0],
            "grad_worst_rel": worst_g[2],
            "worst_leaf": worst[2], "worst_leaf_max_abs_err": worst[0]}


def dist_compress_remesh(torch, rank):
    """(e): ``compressed_psum`` over ``data`` on (2, 2) against JAX's
    arithmetic on the ranks' own gradients; then ``elastic_remesh`` from
    4 ranks to 3 survivors with ``model_parallel=2`` ((1, 2): ranks 2 and
    3 wait at the barrier), ``reshard`` and a finite ``train_loss``."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed.context import axis_index, set_mesh
    from repro_torch.distributed.fault_tolerance import (elastic_remesh,
                                                         reshard)
    from repro_torch.distributed.sharding import fit_specs, param_pspecs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    mesh = make_test_mesh(2, 2, device=DEVICE)
    set_mesh(mesh)

    def grads_of(d):
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(100 + d)
        return {"w": torch.randn((1024, 960), generator=gen, device=DEVICE),
                "b": torch.randn((960,), generator=gen, device=DEVICE) * 1e-3}
    me = axis_index("data")
    g = grads_of(me)
    red, err = comp.compressed_psum(g, comp.init_error_state(g), "data")
    n = mesh.size(0)
    out = {}
    for name in g:
        qs = [comp._quantize(grads_of(d)[name]) for d in range(n)]
        want = sum(q.to(torch.int32) * s for q, s in qs) / n
        e = float((red[name] - want).abs().max())
        check(torch.allclose(red[name], want, rtol=1e-6, atol=1e-7),
              f"phase 26 (e) compressed_psum {name}: {e:.3g}")
        fb = float((g[name] - (comp._dequantize(*qs[me]) + err[name])
                    ).abs().max())
        check(fb < 1e-6, f"phase 26 (e) error feedback {name}: {fb:.3g}")
        out[f"psum_{name}_max_abs_err"] = e
    set_mesh(None)
    mesh2 = elastic_remesh(list(range(DIST_RANKS - 1)),
                           model_parallel=2, device=DEVICE)
    out["remesh"] = None if mesh2 is None else dict(
        zip(mesh2.mesh_dim_names, mesh2.shape))
    if mesh2 is None:
        return out
    check(out["remesh"] == {"data": 1, "model": 2},
          f"phase 26 (e) remesh gave {out['remesh']}")
    t = DIST_TRAIN
    cfg = dataclasses.replace(get_config(t["arch"]), dtype="float32",
                              num_layers=t["layers"])
    params = M.init_params(cfg, seed=0, device=DEVICE)
    params = reshard(params, mesh2, fit_specs(param_pspecs(cfg, params),
                                              params, mesh2))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(27)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                         device=DEVICE)
    with torch.no_grad():
        loss = float(_full(M.train_loss(cfg, params, {"tokens": toks,
                                                      "labels": toks})))
    check(math.isfinite(loss), f"phase 26 (e) loss {loss} after remesh")
    out["loss_after_remesh"] = loss
    dist.barrier()                     # release the ranks left out
    return out


#: phase 26's checks in order; (e) last, since it leaves ranks out
DIST_CHECKS = (("a", dist_decode), ("b", dist_greedy), ("c", dist_moe),
               ("d", dist_train), ("e", dist_compress_remesh))


def dist_rank(rank: int, world: int):
    """One rank of phase 26: every check in turn, each between barriers
    and timed by the wall clock; returns the results, the backend and
    this rank's host-staged collective counts."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": dist.get_backend(), "checks": {}}
    for name, fn in DIST_CHECKS:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn(torch, rank)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        out["checks"][name] = res
        gc.collect()
        torch.cuda.empty_cache()
    out["host_staged"] = dict(context.HOST_STAGED)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


#: phase 26's limit on its ranks, and on each collective (~75-85 s in all)
DIST_TIMEOUT_S = 300.0


def phase_distributed(torch, card: str):
    """Phase 26: ``DIST_RANKS`` ranks on the one card run ``DIST_CHECKS``
    (``dist_rank``); one JSON line per check, with its wall time and the
    card's name and power limit beside it."""
    import gc
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank, DIST_RANKS, device=DEVICE,
                      timeout_s=DIST_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    staged = {k: sum(r["host_staged"].get(k, 0) for r in ranks)
              for k in sorted({k for r in ranks for k in r["host_staged"]})}
    for name, _ in DIST_CHECKS:
        print(json.dumps({"phase": 26, "check": name, "ranks": DIST_RANKS,
                          "card": card, "backend": r0["backend"],
                          "shared_card": True, **r0["checks"][name]},
                         default=float))
    print(json.dumps({"phase": 26, "backend": r0["backend"],
                      "host_staged_collectives": staged,
                      "peak_gib_per_rank": [r["peak_gib"] for r in ranks],
                      "wall_s": wall, "card": card,
                      "note": f"{DIST_RANKS} ranks share one card: "
                              "not a multi-card time"}))
    return {"ranks": ranks, "wall_s": wall, "host_staged": staged}


# --------------------------------------------------------------------- #
# phase 27: the engine over a mesh of ranks that share the card
# --------------------------------------------------------------------- #

#: phase 27 (b)'s expert-parallel capacity factor: the least at which no
#: token overflows on 4 ranks of 64 experts, top 4 (factor >= ranks, and
#: factor ** 2 >= ranks x experts a rank / top-k = 16, for a dispatch whose
#: tokens are sharded or replicated over the ranks), so the tokens can be
#: held equal to the one-rank dense dispatch's; at the model functions'
#: 1.25 GShard's drops change them by design (the ranks still agree)
SPMD_EP_CAPACITY = 4.0


def spmd_serve(torch, eng, reqs):
    """One engine run on this rank: its outputs, schedule, wall and the
    host-staged all-gathers and collectives it issued."""
    from repro_torch.distributed import context
    staged = context.HOST_STAGED["all_gather"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(res.metrics.batches)
    tokens = sum(len(o) for o in res.outputs.values())
    return {"outputs": res.outputs, "schedule": schedule(res),
            "wall_s": wall, "tokens": tokens, "tok_per_s": tokens / wall,
            "steps": steps, "prefill_rounds": eng.prefill_rounds,
            "decode_steps": eng.decode_steps,
            "num_graphs": eng.num_graphs,
            "preemptions": res.metrics.num_preemptions,
            "staged_all_gathers": context.HOST_STAGED["all_gather"] - staged,
            "staged_all_gathers_per_step":
                (context.HOST_STAGED["all_gather"] - staged) / steps,
            "finished": all(r.finished for r in reqs)}


#: phase 27 (a)'s depth: TinyLlama's width at this many of its 22 layers
#: (every rank's step is eager and host-bound, so its wall follows depth)
SPMD_LAYERS = 4


def spmd_reference(torch):
    """Phase 27 (a)'s yardstick: phase 21's one-rank fp32 ``batched``
    engine (``PLANE_RUNS["batched"]``) at ``SPMD_LAYERS`` layers, on the
    same weights and workload as the ranks'."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import SMOKE_ARCH, smoke_plane_server
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(SMOKE_ARCH), dtype="float32",
                              num_layers=SPMD_LAYERS)
    params = M.init_params(cfg, seed=0, device=DEVICE)
    eng, reqs = smoke_plane_server(cfg, params, device=DEVICE,
                                   **PLANE_RUNS["batched"])
    with torch.no_grad():
        res = eng.run(reqs)
    out = {"outputs": res.outputs, "schedule": schedule(res)}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def spmd_rank(rank: int, world: int):
    """One rank of phase 27 on a (1, ``DIST_RANKS``) mesh: (a) full-width
    TinyLlama at ``SPMD_LAYERS`` layers in fp32 on the ``batched`` plane
    with ``impl="seqsharded"``
    (the cache's sequence over the 4 ranks) serving ``smoke_server``'s
    workload; (b) qwen2-moe at ``MOE_FP32_LAYERS`` layers in fp32 on the
    paged plane with ``moe_impl="ep"`` (16 of 64 experts a rank) at
    ``SPMD_EP_CAPACITY``.  The engines check every step's tokens equal
    across the ranks (``check_invariants``)."""
    import functools
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import set_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import (SMOKE_ARCH, SMOKE_MOE_ARCH,
                                          smoke_plane_server, smoke_server)
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_mesh(make_test_mesh(1, DIST_RANKS, device=DEVICE))
    out = {}
    cfg = dataclasses.replace(get_config(SMOKE_ARCH), dtype="float32",
                              num_layers=SPMD_LAYERS)
    params = M.init_params(cfg, seed=0, device=DEVICE)
    eng, reqs = smoke_plane_server(cfg, params, device=DEVICE,
                                   plane="batched", impl="seqsharded")
    out["a"] = spmd_serve(torch, eng, reqs)
    out["a"]["cache_leaves"] = sorted({type(v).__name__
                                       for v in eng.cache.values()})
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    moe_mod.DISPATCH["ep"] = functools.partial(
        moe_mod.apply_moe_ep, capacity_factor=SPMD_EP_CAPACITY)
    cfg = dataclasses.replace(get_config(SMOKE_MOE_ARCH), dtype="float32",
                              num_layers=MOE_FP32_LAYERS)
    params = M.init_params(cfg, seed=0, device=DEVICE)
    eng, reqs = smoke_server(cfg, params, device=DEVICE, moe_impl="ep")
    out["b"] = spmd_serve(torch, eng, reqs)
    out["b"]["experts"] = sorted({type(v).__name__ for v in
                                  eng.params["layers"]["moe"].values()
                                  if not isinstance(v, dict)})
    del eng, params
    set_mesh(None)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


#: phase 27's limit on its ranks, and on each collective
SPMD_TIMEOUT_S = 400.0


def phase_spmd_engine(torch, card: str, moe32):
    """Phase 27: ``spmd_rank`` on ``DIST_RANKS`` ranks of the one card.
    Every rank's tokens and schedule equal rank 0's; (a)'s tokens and
    schedule equal ``spmd_reference``'s (a one-rank fp32 ``batched``
    engine at the same depth, on the same weights and workload), (b)'s
    tokens phase 22's one-rank fp32 qwen2-moe engine's (the dense
    dispatch).  One JSON line per check."""
    import gc
    from repro_torch.launch.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    planes32 = spmd_reference(torch)
    ref_s = time.perf_counter() - t0
    print(f"phase 27 (a)'s one-rank reference at {SPMD_LAYERS} layers in "
          f"{ref_s:.1f} s")
    t0 = time.perf_counter()
    ranks = run_ranks(spmd_rank, DIST_RANKS, device=DEVICE,
                      timeout_s=SPMD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    wants = {"a": (planes32["outputs"], planes32["schedule"]),
             "b": (moe32["outputs"], None)}
    out = {"wall_s": wall, "reference_s": ref_s,
           "peak_gib_per_rank": [r["peak_gib"]
                                                 for r in ranks]}
    for name, (want, want_schedule) in wants.items():
        r0 = ranks[0][name]
        for r in ranks[1:]:
            check(r[name]["outputs"] == r0["outputs"]
                  and r[name]["schedule"] == r0["schedule"],
                  f"phase 27 ({name}): the ranks' tokens or schedules "
                  "differ")
        check(r0["finished"] and r0["num_graphs"] == 0,
              f"phase 27 ({name}): unfinished requests or step graphs "
              f"({r0['num_graphs']}) over the mesh")
        same = sum(r0["outputs"][rid] == toks for rid, toks in want.items())
        check(same == len(want) == len(r0["outputs"]),
              f"phase 27 ({name}): {same}/{len(want)} requests' tokens "
              "equal the one-rank engine's")
        if want_schedule is not None:
            check(r0["schedule"] == want_schedule,
                  f"phase 27 ({name}): the schedule differs from the "
                  "one-rank engine's")
        line = {k: v for k, v in r0.items()
                if k not in ("outputs", "schedule")}
        line.update(same_tokens=f"{same}/{len(want)}",
                    schedule_equal=want_schedule is None
                    or r0["schedule"] == want_schedule,
                    wall_s_by_rank=[r[name]["wall_s"] for r in ranks])
        print(json.dumps({"phase": 27, "check": name, "ranks": DIST_RANKS,
                          "card": card, "shared_card": True,
                          "note": f"{DIST_RANKS} ranks share one card: not "
                                  "a multi-card time", **line},
                         default=float))
        out[name] = line
    print(json.dumps({"phase": 27, "wall_s": wall, "card": card,
                      "peak_gib_per_rank": out["peak_gib_per_rank"]}))
    return out


# --------------------------------------------------------------------- #
# phase 28: the port's analyser, static and on the card's step graphs
# --------------------------------------------------------------------- #

def phase_analysis(card: str):
    """The static pass (0 blocking) and the step-graph audit (no finding)
    of ``repro_torch.analysis``."""
    from repro_torch.analysis.artifact import audit_artifacts, render
    from repro_torch.analysis.runner import run_paths
    t0 = time.perf_counter()
    found = run_paths([str(ROOT / "src" / "repro_torch")],
                      baseline=str(ROOT / "src" / "repro_torch" / "analysis"
                                   / "baseline.json"))
    static_s = time.perf_counter() - t0
    blocking = [f for f in found if f.blocking]
    print(f"phase 28 static pass over src/repro_torch: {len(found)} "
          f"findings, {len(blocking)} blocking, in {static_s:.1f} s")
    for f in blocking:
        print(f"  {f.render()}")
    check(not blocking, "phase 28: the static pass has blocking findings")
    t1 = time.perf_counter()
    report = {}
    audit = audit_artifacts(device="cuda", report=report)
    audit_s = time.perf_counter() - t1
    print(render(report))
    for f in audit:
        print(f"  {f.render()}")
    check(not audit, "phase 28: the step-graph audit has findings")
    out = {"phase": 28, "card": card, "static_s": static_s,
           "static_findings": len(found), "audit_s": audit_s,
           "num_graphs": {p: e["num_graphs"] for p, e in report.items()},
           "kernels": {p: e["kernels"] for p, e in report.items()},
           "nodes": {f"{p}:{k}": g["nodes"] for p, e in report.items()
                     for k, g in e["graphs"].items()}}
    print(json.dumps(out))
    return out


# --------------------------------------------------------------------- #
# phase 29: every kernel variant launched again and again on the same
# inputs, alone and beside a busy stream
# --------------------------------------------------------------------- #

class KernelCase:
    """One kernel variant at one shape.  ``build(torch, inp)`` makes the
    call's inputs by name from seeded ``Inputs``; ``call_case`` launches
    the wrapper on them (B2's pools copied fresh for every call, since it
    writes them) and ``plain_case`` runs the plain version.  ``kernel``
    is paged_decode, paged_prefill, flash_attention or wkv6; ``variant``
    the wrapper's ``launches_by_variant`` key (B4's: ``colsplit`` and the
    columns a CTA that ``rwkv_scan.columns`` picks); ``kw`` B3's masks;
    ``dense`` runs B1 through ``ops.decode_attention_dense``.  (A plain
    class: the tests load this file without registering it as a module,
    where a dataclass cannot be made.)"""

    def __init__(self, kernel: str, variant: str, shape: str,
                 build: Callable, kw: dict = None, dense: bool = False):
        self.kernel, self.variant, self.shape = kernel, variant, shape
        self.build, self.kw, self.dense = build, kw or {}, dense

    @property
    def name(self) -> str:
        return f"{self.kernel} {self.variant} {self.shape}"


#: the dtype each variant of B1-B3 runs in
VARIANT_DTYPE = {v: d for m in (VARIANT, DECODE_VARIANT)
                 for d, v in m.items()}


def kernel_modules():
    """The port's kernel wrappers and plain versions, as the cases use
    them (``src`` on the path)."""
    import types
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.rwkv_scan import ref as wref
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    return types.SimpleNamespace(pa=pa, ref=ref, pa_ops=pa_ops, fa=fa,
                                 fref=fref, wkv=wkv, wref=wref)


def decode_inputs(case):
    return dict(zip(("q", "kp", "vp", "bt", "ctx"), case))


def dense_inputs(case_and_dense):
    case, (k, v) = case_and_dense
    return {**decode_inputs(case), "k": k, "v": v}


def prefill_inputs(case):
    return dict(zip(("q", "k", "v", "kp", "vp", "bt", "st", "ln"), case))


def flash_inputs(case):
    return dict(zip(("q", "k", "v"), case))


def wkv_inputs(case):
    return {n: t for n, t in zip(("r", "k", "v", "w", "u", "s0"), case)
            if t is not None}


def case_tol(case) -> dict:
    if case.kernel == "wkv6":
        return dict(rtol=WKV_TOL, atol=WKV_TOL)
    return TOL[VARIANT_DTYPE[case.variant]]


def case_wrapper(mods, case):
    return {"paged_decode": mods.pa.paged_decode_cuda,
            "paged_prefill": mods.pa.paged_prefill_cuda,
            "flash_attention": mods.fa.flash_attention_cuda,
            "wkv6": mods.wkv.wkv6_cuda}[case.kernel]


def call_case(mods, case, t, fresh=True):
    """The wrapper's outputs on inputs ``t`` (B2: its output and the two
    pools it wrote into: copies of ``t``'s, or with ``fresh`` False
    ``t``'s own)."""
    if case.kernel == "paged_decode":
        if case.dense:
            return (mods.pa_ops.decode_attention_dense(
                t["q"], t["k"], t["v"], t["ctx"], page_size=DENSE_PAGE),)
        return (mods.pa.paged_decode_cuda(t["q"], t["kp"], t["vp"], t["bt"],
                                          t["ctx"]),)
    if case.kernel == "paged_prefill":
        kp, vp = (t["kp"].clone(), t["vp"].clone()) if fresh else \
            (t["kp"], t["vp"])
        out = mods.pa.paged_prefill_cuda(t["q"], t["k"], t["v"], kp, vp,
                                         t["bt"], t["st"], t["ln"])
        return out, kp, vp
    if case.kernel == "flash_attention":
        return (mods.fa.flash_attention_cuda(t["q"], t["k"], t["v"],
                                             **case.kw),)
    return mods.wkv.wkv6_cuda(t["r"], t["k"], t["v"], t["w"], t["u"],
                              t.get("s0"))


def plain_case(torch, mods, case, t):
    """The plain version's outputs, as ``call_case`` returns the
    kernel's (B2's padded rows zero, as the kernel writes them)."""
    if case.kernel == "paged_decode":
        return (mods.ref.paged_decode_reference(t["q"], t["kp"], t["vp"],
                                                t["bt"], t["ctx"]),)
    if case.kernel == "paged_prefill":
        kp, vp = t["kp"].clone(), t["vp"].clone()
        out = mods.ref.paged_prefill_reference(t["q"], t["k"], t["v"], kp,
                                               vp, t["bt"], t["st"], t["ln"])
        valid = (torch.arange(out.shape[1], device=out.device)[None]
                 < t["ln"][:, None])
        return out * valid[:, :, None, None].to(out.dtype), kp, vp
    if case.kernel == "flash_attention":
        return (mods.fref.attention_reference(t["q"], t["k"], t["v"],
                                              **case.kw),)
    return mods.wref.wkv6_reference(t["r"], t["k"], t["v"], t["w"], t["u"],
                                    t.get("s0"))


def launch_case(mods, case, t, fresh=True):
    """``call_case``, checking that it made one launch of its variant."""
    fn = case_wrapper(mods, case)
    n0 = fn.launches
    before = dict(getattr(fn, "launches_by_variant", {}))
    outs = call_case(mods, case, t, fresh)
    check(fn.launches == n0 + 1, f"{case.name}: {fn.launches - n0} launches")
    if case.kernel == "wkv6":
        B, _, H, D = t["r"].shape
        cols = mods.wkv.columns(B, H, D)
        check(case.variant == f"colsplit{cols}",
              f"{case.name}: the kernel picks {cols} columns a CTA")
    else:
        want = {k: n + (k == case.variant) for k, n in before.items()}
        check(fn.launches_by_variant == want,
              f"{case.name}: launches by variant {before} -> "
              f"{fn.launches_by_variant}")
    return outs


def compare_case(torch, case, got, want) -> float:
    """The largest error of each output against the plain version's,
    checked at the case's tolerance (``case_tol``)."""
    tol, worst = case_tol(case), 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{case.name}: output {i} "
              f"{tuple(g.shape)}, plain {tuple(w.shape)}")
        check(bool(torch.isfinite(g.float()).all()),
              f"{case.name}: output {i} not finite")
        err = (g.float() - w.float()).abs()
        bad = err > tol["atol"] + tol["rtol"] * w.float().abs()
        check(not bool(bad.any()), f"{case.name}: output {i} max abs err "
              f"{err.max().item():.3g} beyond {tol}")
        worst = max(worst, err.max().item())
    return worst


def bits(torch, x):
    """``x``'s bits as integers: compares NaN payloads and -0 too."""
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def differs(torch, outs, first):
    """A device flag: does any output differ from ``first`` in a bit?"""
    return torch.stack([(bits(torch, a) != bits(torch, b)).any()
                        for a, b in zip(outs, first)]).any()


#: B3 at the shapes of the two fp32 kernel checks that failed once and
#: never again: (B, S, H, Hkv, D) and the masks -- two warps a 16-row
#: group at D = 128 and 256, the most key tiles those head dims are
#: tested at
RUN5 = {"run5_S512_D128": ((2, 512, 32, 4, 128), {}),
        "run5_S512_D256_prefix256": ((2, 512, 8, 1, 256),
                                     {"prefix_len": 256})}
#: launches of each phase-29 case on the same inputs, in each pass
STRESS_N, STRESS_N_RUN5 = 200, 1000
#: the busy stream's product: (n, n) x (n, n) in bf16 before each launch
STRESS_GEMM = 4096


def stress_cases(P_main, ecfg):
    """Phase 29's cases: every variant of B1-B4 at the kernel table's
    serving shapes (B1 and B2 TinyLlama's step and round, B1 on the dense
    view, B2 at qwen3-moe's and PaliGemma's heads, where two warps share
    each 16 rows in fp32; B3 TinyLlama's full prefill; B4 the engine
    round at B 4 and 8 and the 512-token prefill, so 32 and 64 columns a
    CTA), and B3 at ``RUN5``'s shapes."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        dv, v = DECODE_VARIANT[dtype], VARIANT[dtype]
        cases += [
            KernelCase("paged_decode", dv, "serving step", lambda torch, inp,
                       d=dtype: decode_inputs(main_path_decode(
                           torch, inp, d, P_main, ecfg))),
            KernelCase("paged_decode", dv, "dense view", lambda torch, inp,
                       d=dtype: dense_inputs(dense_view_case(torch, inp, d)),
                       dense=True)]
        for arch in ("tinyllama", "qwen3_moe", "paligemma"):
            cases.append(KernelCase(
                "paged_prefill", v, f"serving round {arch}",
                lambda torch, inp, d=dtype, h=HEADS[arch]: prefill_inputs(
                    main_path_prefill(torch, inp, d, P_main, ecfg, h))))
        cases.append(KernelCase(
            "flash_attention", v, "full prefill B2 S512 H32 Hkv4 D64",
            lambda torch, inp, d=dtype: flash_inputs(
                flash_case(inp, *FLASH_MAIN, d))))
        for what, (shape, kw) in RUN5.items():
            cases.append(KernelCase(
                "flash_attention", v, what, lambda torch, inp, d=dtype,
                s=shape: flash_inputs(flash_case(inp, *s, d)), kw=kw))
    for what, (B, S, H, D, s0) in WKV_SHAPES.items():
        cases.append(KernelCase(
            "wkv6", "colsplit64" if what == "round_B8" else "colsplit32",
            what, lambda torch, inp, s=(B, S, H, D, s0): wkv_inputs(
                wkv_case(torch, inp, *s[:4], s0=s[4]))))
    return cases


def stress(torch, mods, case, t, n, first=None, side=None, gemm=None):
    """``n`` launches of ``case`` on ``t``; with ``side``, each launch
    after a product ``gemm`` enqueued on that stream, which then stays
    busy throughout.  Returns (the first launch's outputs, or ``first``;
    how many launches differ from them in any bit)."""
    flags = []
    for _ in range(n):
        if side is not None:
            with torch.cuda.stream(side):
                torch.mm(gemm[0], gemm[1], out=gemm[2])
        outs = launch_case(mods, case, t)
        if first is None:
            first = outs
        else:
            flags.append(differs(torch, outs, first))
    torch.cuda.synchronize()
    return first, int(torch.stack(flags).sum()) if flags else 0


def phase_stress(torch, mods, P_main, ecfg):
    """Phase 29: each of ``stress_cases`` launched ``STRESS_N`` times
    (``STRESS_N_RUN5`` at ``RUN5``'s shapes) on one set of inputs, then as
    many times again while a second stream runs a bf16 product before
    every launch (it moves which CTAs run where and when): every output
    bit-equal to the first launch's, which is within ``case_tol`` of the
    plain version."""
    t0 = time.perf_counter()
    n = STRESS_GEMM
    g = torch.Generator(device=DEVICE)
    g.manual_seed(29)
    gemm = [torch.randn((n, n), generator=g, device=DEVICE).to(
        torch.bfloat16) for _ in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    out = {}
    for i, case in enumerate(stress_cases(P_main, ecfg)):
        reps = STRESS_N_RUN5 if case.shape in RUN5 else STRESS_N
        t = case.build(torch, Inputs(torch, 290 + i))
        first, quiet = stress(torch, mods, case, t, reps)
        err = compare_case(torch, case, first,
                           plain_case(torch, mods, case, t))
        _, busy = stress(torch, mods, case, t, reps, first=first,
                         side=side, gemm=gemm)
        out[case.name] = {"launches": 2 * reps, "differing_quiet": quiet,
                          "differing_busy": busy, "max_abs_err": err}
        print(f"phase 29 {case.name}: {reps} launches alone, {reps} beside "
              f"a busy stream; differing from the first {quiet} / {busy}; "
              f"first vs plain max abs err {err:.3g}")
        check(quiet == busy == 0, f"phase 29 {case.name}: {quiet} / {busy} "
              "launches differ from the first")
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 29: {len(out) - 1} cases, "
          f"{sum(c['launches'] for c in out.values() if isinstance(c, dict))}"
          f" launches, none differing, in {out['seconds']:.1f} s")
    return out


def ptxas_report(log: str):
    """(kernel, "N registers, S bytes spill stores, ...") per entry
    function of an ``nvcc -Xptxas -v`` log; the kernel named by its
    mangled name's identifier and template arguments."""
    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN\d+\w+?\d+(\w+?)I(\w+?)EE",
                      line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and fn:
            out.append((fn, f"{line.split(':', 1)[1].strip()}; {spill}"))
            fn = None
    return out


def sdpa_note(t: dict) -> str:
    """The pinned SDPA backend of a timing, and its unpinned time."""
    if "sdpa_backend" not in t:
        return ""
    return (f" ({t['sdpa_backend']}; unpinned "
            f"{t['library_ms_unpinned']:.4f} ms)")


def cores_note(t: dict) -> str:
    """The fp32 CUDA cores' bound beside a 3xTF32 kernel's."""
    if "bound_ms_fp32_cores" not in t:
        return ""
    return f"; fp32 CUDA cores' bound {t['bound_ms_fp32_cores']:.4f} ms"


def _tree_to(tree, dtype):
    return {k: _tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", help="also write every measurement here")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a card")
    if not (ROOT / "src" / "repro_torch" / "serving").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it "
             "from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.kernels.rwkv_scan import ref as wref
    from repro_torch.kernels.rwkv_scan import rwkv_scan as wkv
    from repro_torch.launch.serve import (SMOKE_ARCH, SMOKE_ENGINE, SMOKE_M,
                                          SMOKE_RWKV_ARCH, SMOKE_RWKV_ENGINE,
                                          rwkv_smoke_server, smoke_server)
    from repro_torch.models import model as M
    from repro_torch.models.ssm import pick_chunk
    from repro_torch.serving.faults import FaultSpec

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{count} device(s)")

    def lap(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    t0 = time.perf_counter()
    cuda_build.build([pa.DECODE_SRC, pa.PREFILL_SRC, fa.SRC, wkv.SRC])
    pa.build_all()
    fa.build_all()
    wkv.build_all()
    build_s = time.perf_counter() - t0
    print(f"nvcc build of {len(cuda_build.BUILD_REPORT)} sources in "
          f"parallel: {build_s:.1f} s wall")
    for stem, (secs, log) in sorted(cuda_build.BUILD_REPORT.items()):
        print(f"  {stem}: {secs:.1f} s")
        for fn, report in ptxas_report(log):
            print(f"    {fn}: {report}")

    report = {"card": card, "kind": kind, "torch": torch.__version__,
              "build_s": build_s}
    ecfg = SMOKE_ENGINE
    P_main = -(-SMOKE_M // ecfg.page_size) + 1   # allocator pages + sentinel
    with torch.no_grad():
        errs = phase_kernels(torch, pa, ref, P_main, ecfg)
        errs["flash_attention"] = phase_flash_kernel(torch, fa, fref)
        errs["wkv6"] = phase_wkv_kernel(torch, wkv, wref, pick_chunk,
                                        SMOKE_RWKV_ENGINE.nslots)
        errs["paged_decode_dense"] = phase_dense_view(torch, pa, ref, pa_ops)
        errs["moe"] = phase_moe_kernels(torch, pa, ref, P_main, ecfg)
        lap("kernel checks")
        race = phase_transfer_race(torch, M, get_config)
        torch.cuda.empty_cache()
        lap("transfer race")
        rollback = phase_rollback(torch, get_config)
        lap("rollback bytes")

        cfg = dataclasses.replace(get_config(SMOKE_ARCH), dtype="float32")
        params = M.init_params(cfg, seed=0, device=DEVICE)
        fp32 = phase_serve_fp32(torch, pa, cfg, params)
        lap("fp32 serve")
        swap32 = phase_serve_fp32(torch, pa, cfg, params, swap=True)
        lap("fp32 swap serve")
        faulted32 = phase_serve_fp32(torch, pa, cfg, params,
                                     faults=FaultSpec(**MIXED), clean=swap32)
        lap("fp32 faulted swap serve")
        graphs = {"float32": phase_graphs(torch, "fp32 graphs", smoke_server,
                                          cfg, params, fp32["outputs"])}
        lap("fp32 graphs")
        planes32 = phase_planes(torch, pa, cfg, params, fp32["references"])
        lap("fp32 planes")
        prefill = phase_full_prefill(torch, fa, M, cfg, params)
        lap("full prefill")

        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        params16 = _tree_to(params, torch.bfloat16)
        del params
        prefill16 = phase_full_prefill_bf16(torch, fa, M, cfg16, params16)
        lap("bf16 full prefill")
        bf16 = phase_serve_bf16(torch, pa, cfg16, params16)
        check(bf16["pool_pages"] == P_main, "pool size changed")
        lap("bf16 serve")
        swap16 = phase_serve_bf16(torch, pa, cfg16, params16, swap=True)
        lap("bf16 swap serve")
        faulted16 = phase_serve_bf16(torch, pa, cfg16, params16,
                                     faults=FaultSpec(**MIXED), clean=swap16)
        lap("bf16 faulted swap serve")
        graphs["bfloat16"] = phase_graphs(torch, "bf16 graphs", smoke_server,
                                          cfg16, params16, bf16["outputs"])
        lap("bf16 graphs")
        planes16 = phase_planes(torch, pa, cfg16, params16, bf16["outputs"])
        del params16
        lap("bf16 planes")

    train = phase_train(torch)
    torch.cuda.empty_cache()
    lap("train")

    with torch.no_grad():
        inp = Inputs(torch, 2)
        times = {}
        decode_more, prefill_more = {}, {}
        # "paged_decode" / "paged_prefill" / "flash_attention" the bf16
        # (tensor-core) kernels, "paged_decode_simt" B1's fp32 (CUDA-core)
        # one, "..._3xtf32" B2's and B3's fp32 (3xTF32 tensor-core) ones
        for dtype in ("bfloat16", "float32"):
            sfx, dsfx = ATTN_SFX[dtype], DECODE_SFX[dtype]
            times["paged_decode" + dsfx] = time_decode(
                torch, pa, ref, main_path_decode(torch, inp, dtype, P_main,
                                                 ecfg), dtype)
            for what, (B, H, Hkv, D, page, npages, ctx) in \
                    DECODE_LONG.items():
                t = decode_more[f"{what}_{dtype}"] = time_decode(
                    torch, pa, ref, decode_case(torch, inp, B, H, Hkv, D,
                                                page, npages, dtype, ctx),
                    dtype)
                t["span"] = pa.decode_span(B, Hkv, page * npages)
            times["paged_prefill" + sfx] = time_prefill(
                torch, pa, ref, main_path_prefill(torch, inp, dtype, P_main,
                                                  ecfg), dtype)
            times["flash_attention" + sfx] = time_flash(
                torch, fa, fref, flash_case(inp, *FLASH_MAIN, dtype), dtype)
            times["paged_decode_dense" + dsfx] = time_decode(
                torch, pa, ref, dense_view_case(torch, inp, dtype)[0], dtype)
            # phase 4 at the MoE serving shapes (qwen2-moe's heads in the
            # kernels' line; qwen3-moe's beside them)
            for arch, key in (("qwen2_moe", "moe"), ("qwen3_moe", "moe3")):
                h = HEADS[arch]
                t = decode_more[f"{key}_{dtype}"] = time_decode(
                    torch, pa, ref, main_path_decode(torch, inp, dtype,
                                                     P_main, ecfg, h), dtype)
                t["span"] = pa.decode_span(ecfg.nslots, h[1],
                                           ecfg.cache_len)
                prefill_more[f"{key}_{dtype}"] = time_prefill(
                    torch, pa, ref, main_path_prefill(torch, inp, dtype,
                                                      P_main, ecfg, h), dtype)
            times["paged_decode_moe" + dsfx] = decode_more[f"moe_{dtype}"]
            times["paged_prefill_moe" + sfx] = prefill_more[f"moe_{dtype}"]
        flash_more = {
            "bfloat16_S2048": time_flash(
                torch, fa, fref, flash_case(inp, *FLASH_LONG, "bfloat16"),
                "bfloat16"),
            "bfloat16_smollm": time_flash(
                torch, fa, fref, flash_case(inp, 2, 512, 15, 5, 64,
                                            "bfloat16"), "bfloat16")}
        lap("timing")

        rcfg = dataclasses.replace(get_config(SMOKE_RWKV_ARCH),
                                   dtype="float32",
                                   num_layers=RWKV_FP32_LAYERS)
        rparams = M.init_params(rcfg, seed=0, device=DEVICE)
        rwkv32 = phase_rwkv_serve_fp32(torch, wkv, M, rcfg, rparams)
        lap("RWKV6-7B fp32 serve")
        rwkv32_swap = phase_rwkv_serve_fp32(torch, wkv, M, rcfg, rparams,
                                            preempt_mode="swap")
        lap("RWKV6-7B fp32 swap serve")
        rwkv32_faulted = phase_rwkv_serve_fp32(
            torch, wkv, M, rcfg, rparams, preempt_mode="swap",
            faults=FaultSpec(**MIXED))
        lap("RWKV6-7B fp32 faulted swap serve")
        rwkv_planes = phase_rwkv_planes(torch, wkv, M, rcfg, rparams,
                                        rwkv32["references"])
        del rparams
        torch.cuda.empty_cache()
        lap("RWKV6-7B fp32 planes")
        rcfg16 = dataclasses.replace(get_config(SMOKE_RWKV_ARCH),
                                     dtype="bfloat16")
        rparams16 = M.init_params(rcfg16, seed=0, device=DEVICE)
        rwkv16 = phase_rwkv_serve_bf16(torch, wkv, rcfg16, rparams16)
        lap("RWKV6-7B bf16 serve")
        rwkv16_swap = phase_rwkv_serve_bf16(torch, wkv, rcfg16, rparams16,
                                            preempt_mode="swap")
        lap("RWKV6-7B bf16 swap serve")
        graphs["rwkv6_bfloat16"] = phase_graphs(
            torch, "RWKV6-7B bf16 graphs", rwkv_smoke_server, rcfg16,
            rparams16, rwkv16["outputs"])
        del rparams16
        torch.cuda.empty_cache()
        lap("RWKV6-7B bf16 graphs")

        wkv_more = {what: time_wkv(torch, wkv, wref, wkv_case(
            torch, inp, B, S, H, D, s0=s0))
            for what, (B, S, H, D, s0) in WKV_SHAPES.items()}
        check(WKV_SHAPES["round_B4"][0] == SMOKE_RWKV_ENGINE.nslots,
              "the timed round is not the smoke engine's")
        times["wkv6"] = wkv_more["round_B4"]
        lap("wkv6 timing")
        link = phase_host_link(torch, M, get_config)
        lap("host link")
        del inp
        moe = phase_moe(torch, pa, M, get_config)
        lap("MoE serve")
        grouped = phase_moe_grouped(torch, get_config)
        errs["moe_grouped"] = grouped["errors"]
        times["moe_grouped"] = grouped["times"]["bfloat16_T128"]
        times["moe_grouped_fp32"] = grouped["times"]["float32_T128"]
        lap("grouped MoE kernels at full width")
        hybrid = phase_hybrid(torch, pa, fa, fref, ref, pa_ops, M,
                              get_config)
        times.update({k: v for k, v in hybrid["times"].items()
                      if "_S" not in k})
        flash_more.update({k: v for k, v in hybrid["times"].items()
                           if "_S2048" in k})
        lap("hymba kernels and serve")
        fe = phase_frontends(torch, pa, ref, fa, fref, M, get_config, P_main,
                             ecfg)
        times.update(fe["times"])
        lap("VLM and audio kernels, serves, prefill and trainers")
        families = phase_train_families(torch, card)
        lap("MoE, hybrid and RWKV6 trainers")
    distributed = phase_distributed(torch, card)
    lap(f"distributed layer on {DIST_RANKS} ranks")
    spmd = phase_spmd_engine(torch, card, moe["qwen2_fp32"])
    lap(f"the engine over a mesh of {DIST_RANKS} ranks")
    analysis = phase_analysis(card)
    lap("the analyser's static pass and step-graph audit")
    with torch.no_grad():
        repeats = phase_stress(torch, kernel_modules(), P_main, ecfg)
    lap("every kernel variant repeated, alone and beside a busy stream")
    # each entry: its launches on its main path (counts zeroed just before
    # that run), its comparison with the plain version at the main shapes,
    # and its times at those shapes
    entries = [
        # (entry, kernel, variant, dtype, launches, max abs err, shapes)
        ("paged_decode", "paged_decode", "split_mma", "bfloat16",
         bf16["decode_variants"]["split_mma"],
         errs["paged_decode"]["main_bfloat16"], "serving shapes"),
        ("paged_decode_simt", "paged_decode", "split_simt", "float32",
         fp32["decode_variants"]["split_simt"],
         errs["paged_decode"]["main_float32"], "serving shapes"),
        ("paged_prefill", "paged_prefill", "wgmma", "bfloat16",
         bf16["prefill_variants"]["wgmma"],
         errs["paged_prefill"]["main_bfloat16"], "serving shapes"),
        ("paged_prefill_3xtf32", "paged_prefill", "mma_3xtf32", "float32",
         fp32["prefill_variants"]["mma_3xtf32"],
         errs["paged_prefill"]["main_float32"], "serving shapes"),
        ("flash_attention", "flash_attention", "wgmma", "bfloat16",
         prefill16["variants"]["wgmma"],
         errs["flash_attention"]["main_bfloat16"],
         "full-prefill shapes B2 S512 H32 Hkv4"),
        ("flash_attention_3xtf32", "flash_attention", "mma_3xtf32",
         "float32", prefill["variants"]["mma_3xtf32"],
         errs["flash_attention"]["main_float32"],
         "full-prefill shapes B2 S512 H32 Hkv4"),
        ("paged_decode_dense", "paged_decode", "split_mma", "bfloat16",
         planes16["batched"]["decode_variants"]["split_mma"],
         errs["paged_decode_dense"]["bfloat16"],
         "dense view of the slot cache, page 64"),
        ("paged_decode_dense_simt", "paged_decode", "split_simt", "float32",
         planes32["batched"]["decode_variants"]["split_simt"],
         errs["paged_decode_dense"]["float32"],
         "dense view of the slot cache, page 64"),
        ("wkv6", "wkv6", "colsplit", "float32", rwkv32["launches"],
         errs["wkv6"]["main_float32"], "engine round B{} S{} H{} D{}".format(
             SMOKE_RWKV_ENGINE.nslots, *WKV_ROUND)),
        # B1 and B2 at qwen2-moe's serving shapes (phase 22)
        ("paged_decode_moe", "paged_decode", "split_mma", "bfloat16",
         moe["qwen2_bf16"]["decode_variants"]["split_mma"],
         errs["moe"]["paged_decode"]["qwen2_moe_bfloat16"],
         "qwen2-moe serving shapes H16 Hkv16 D128"),
        ("paged_decode_moe_simt", "paged_decode", "split_simt", "float32",
         moe["qwen2_fp32"]["decode_variants"]["split_simt"],
         errs["moe"]["paged_decode"]["qwen2_moe_float32"],
         "qwen2-moe serving shapes H16 Hkv16 D128"),
        ("paged_prefill_moe", "paged_prefill", "wgmma", "bfloat16",
         moe["qwen2_bf16"]["prefill_variants"]["wgmma"],
         errs["moe"]["paged_prefill"]["qwen2_moe_bfloat16"],
         "qwen2-moe serving shapes H16 Hkv16 D128"),
        ("paged_prefill_moe_3xtf32", "paged_prefill", "mma_3xtf32",
         "float32", moe["qwen2_fp32"]["prefill_variants"]["mma_3xtf32"],
         errs["moe"]["paged_prefill"]["qwen2_moe_float32"],
         "qwen2-moe serving shapes H16 Hkv16 D128"),
        # B1 on hymba's ring and B3 with its window (phase 23): B1's
        # launches from the serves with impl="paged", B3's from
        # generate_reference(impl="flash")
        ("paged_decode_hymba", "paged_decode", "split_mma", "bfloat16",
         hybrid["bf16"]["decode_variants"]["split_mma"],
         hybrid["errors"]["paged_decode"]["main_bfloat16"],
         "hymba ring 4 x 2048 H25 Hkv5 D64"),
        ("paged_decode_hymba_simt", "paged_decode", "split_simt", "float32",
         hybrid["fp32"]["batched_paged"]["decode_variants"]["split_simt"],
         hybrid["errors"]["paged_decode"]["main_float32"],
         "hymba ring 4 x 2048 H25 Hkv5 D64"),
        ("flash_attention_hymba", "flash_attention", "wgmma", "bfloat16",
         hybrid["reference_launches_bf16"],
         hybrid["errors"]["flash_attention"]["main_bfloat16"],
         "hymba prefill S3100 H25 Hkv5 window 2048"),
        ("flash_attention_hymba_3xtf32", "flash_attention", "mma_3xtf32",
         "float32",
         hybrid["reference_launches_fp32"],
         hybrid["errors"]["flash_attention"]["main_float32"],
         "hymba prefill S3100 H25 Hkv5 window 2048"),
        # the grouped MoE layer (phases 22 and 30): launches from
        # qwen3-moe's grouped serves, errors at T 128 beside T 4096's
        ("moe_grouped", "moe_grouped", "triton", "bfloat16",
         moe["qwen3_grouped_bf16"]["launches"]["moe_grouped"],
         max(errs["moe_grouped"][f"bfloat16_T{t}"]["max_abs_err"]
             for t in (GROUPED_TOKENS[0], GROUPED_TOKENS[-1])),
         "qwen3-moe-30b decode step T128 d2048 f768 E128 K8"),
        ("moe_grouped_fp32", "moe_grouped", "triton", "float32",
         moe["qwen3_grouped_fp32"]["launches"]["moe_grouped"],
         max(errs["moe_grouped"][f"float32_T{t}"]["max_abs_err"]
             for t in (GROUPED_TOKENS[0], GROUPED_TOKENS[-1])),
         "qwen3-moe-30b decode step T128 d2048 f768 E128 K8"),
    ]
    # B1-B3 at head dim 256 (PaliGemma) and B1/B2 at MusicGen's shapes
    # (phase 24): B1/B2's launches from the paged serves, B3's from the
    # image-prefix prefill
    for dtype in ("bfloat16", "float32"):
        sfx, dsfx = ATTN_SFX[dtype], DECODE_SFX[dtype]
        tag, dv, pv = TAG[dtype], DECODE_VARIANT[dtype], VARIANT[dtype]
        vlm, audio = fe[f"vlm_{tag}_paged"], fe[f"audio_{tag}_paged"]
        e = fe["errors"]
        entries += [
            ("paged_decode_d256" + dsfx, "paged_decode", dv, dtype,
             vlm["decode_variants"][dv], e["paged_decode"][f"main_{dtype}"],
             "PaliGemma serving shapes H8 Hkv1 D256"),
            ("paged_prefill_d256" + sfx, "paged_prefill", pv, dtype,
             vlm["prefill_variants"][pv],
             e["paged_prefill"][f"main_{dtype}"],
             "PaliGemma serving shapes H8 Hkv1 D256"),
            ("flash_attention_d256" + sfx, "flash_attention", pv, dtype,
             fe[f"vlm_prefill_{tag}"]["launches"],
             e["flash_attention"][f"main_{dtype}"],
             "PaliGemma image-prefix prefill B2 S512 H8 Hkv1 D256 prefix "
             "256"),
            ("paged_decode_musicgen" + dsfx, "paged_decode", dv, dtype,
             audio["decode_variants"][dv],
             e["paged_decode"][f"musicgen_{dtype}"],
             "MusicGen serving shapes H24 Hkv24 D64, ctx 564-1564"),
            ("paged_prefill_musicgen" + sfx, "paged_prefill", pv, dtype,
             audio["prefill_variants"][pv],
             e["paged_prefill"][f"musicgen_{dtype}"],
             "MusicGen prefill round 8 x 256 H24 Hkv24 D64")]
    kernels = []
    for entry, name, var, dtype, launches, err, shape in entries:
        t = times[entry]
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        print(f"{entry} ({var}, {dtype}, {shape}): {t['ms']:.4f} ms; plain "
              f"{t['plain_ms']:.4f} ms; library {lib}{sdpa_note(t)}; "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['bytes']:.3g} B, {t['ops']:.3g} ops){cores_note(t)}; "
              f"launches {launches}")
        check(launches > 0, f"{entry}: no launch on its main path")
        kernels.append({"name": entry, "route": "cuda",
                        "source": KERNELS[name][0],
                        "replaces": KERNELS[name][1],
                        "variant": var, "dtype": dtype,
                        "launches": launches, "max_abs_err": err,
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        **{k: t[k] for k in ("bound_ms_fp32_cores",
                                             "sdpa_backend") if k in t}})
    for what, t in decode_more.items():
        print(f"paged_decode ({t['dtype']}, {what}, q {t['shape']}, Hkv "
              f"{t['kv_heads']}, span {t['span']}): {t['ms']:.4f} ms; plain "
              f"{t['plain_ms']:.4f} ms; sdpa {t['library_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']:.3g} B, "
              f"{t['ops']:.3g} ops)")
    for what, t in prefill_more.items():
        print(f"paged_prefill ({what}): {t['ms']:.4f} ms; plain "
              f"{t['plain_ms']:.4f} ms; sdpa {t['library_ms']:.4f} ms"
              f"{sdpa_note(t)}; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['bytes']:.3g} B, {t['ops']:.3g} ops)"
              f"{cores_note(t)}")
    for what, t in flash_more.items():
        print(f"flash_attention ({t['dtype']}, shape {t['shape']}, Hkv "
              f"{t['kv_heads']}, window {t['window']}): {t['ms']:.4f} ms; "
              f"plain {t['plain_ms']:.4f} ms; sdpa {t['library_ms']:.4f} ms"
              f"{sdpa_note(t)}; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}: {t['bytes']:.3g} B, {t['ops']:.3g} ops)"
              f"{cores_note(t)}")
    for what, t in wkv_more.items():
        print(f"wkv6 (fp32, {what}, B{t['shape'][0]} S{t['shape'][1]} "
              f"H{t['shape'][2]} D{t['shape'][3]}): {t['ms']:.4f} ms; plain "
              f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}: {t['bytes']:.3g} B, {t['ops']:.3g} ops)")
    times["moe_grouped_more"] = grouped["times"]
    times["flash_attention_more"] = flash_more
    times["wkv6_more"] = wkv_more
    times["paged_decode_more"] = decode_more
    times["paged_prefill_more"] = prefill_more
    report.update(errors=errs, serve_fp32=fp32, serve_bf16=bf16,
                  full_prefill=prefill, full_prefill_bf16=prefill16,
                  train=train, timings=times,
                  rwkv_serve_fp32=rwkv32, rwkv_serve_bf16=rwkv16,
                  transfer_race=race, swap_serve_fp32=swap32,
                  swap_serve_bf16=swap16, rwkv_swap_serve_fp32=rwkv32_swap,
                  rwkv_swap_serve_bf16=rwkv16_swap, host_link=link,
                  rollback=rollback, faulted_serve_fp32=faulted32,
                  faulted_serve_bf16=faulted16,
                  rwkv_faulted_serve_fp32=rwkv32_faulted, graphs=graphs,
                  planes_fp32=planes32, planes_bf16=planes16,
                  rwkv_planes_fp32=rwkv_planes, moe=moe, hybrid=hybrid,
                  frontends=fe, train_families=families,
                  distributed=distributed, spmd_engine=spmd,
                  analysis=analysis, repeats=repeats,
                  seconds=time.perf_counter() - t_start)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1,
                                                default=float))
    print(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
