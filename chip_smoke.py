"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repository root on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py [--layers N] [--seed S]
                          [--only 1,21[,22][,23][,24][,25][,26][,27]]

``--only 1,21`` runs the build and phase 21 alone, ``--only 1,22`` phase
22 alone, ``--only 1,23`` phase 23 alone, ``--only 1,24`` phase 24 alone,
``--only 1,25`` phase 25 alone, ``--only 1,26`` phase 26 alone, ``--only
1,27`` phase 20 with phase 27 on its state (on card 0): on a host
with four or more cards,
``python3 chip_smoke.py --only 1,21`` serves qwen3-8b at full depth on four
NCCL ranks, ``--only 1,22`` moonshot-v1-16b-a3b and llama4-scout-17b-a16e
at full depth, ``--only 1,23`` trains qwen3-8b at all 36 layers, ``--only
1,24`` moonshot-v1-16b-a3b at 24 of its 48 layers, ``--only 1,25``
recurrentgemma-2b and gemma2-9b at full depth, xlstm-350m at 4 of 24, and
``--only 1,26`` trains whisper-base and runs the prefill and decode step
factories for whisper-base, qwen3-8b and recurrentgemma-2b at full depth.

Phases, each failing loudly (non-zero exit, no result line):
  1. the card's name and power limit; the five CUDA kernels built with
     nvcc for sm_90a from ``src/repro_torch/csrc``, all started together;
  2. the ECF8 decode kernel against its plain PyTorch version at the
     qwen3-8b embed / wi_gate / wq shapes: fp8 bits bit-exact, and its
     bf16, fp16 and f32 instances (the decode writing the weight's dtype
     itself) bit-identical to plain decode + cast; the same on a
     one-symbol and a near-uniform codebook and a container holding all
     256 fp8 codes (NaNs compared by isnan); timed on the card (CUDA
     events): the bf16 instance beside the fp8-bits instance followed by
     ``.to(bf16)``; and at one layer's expert container of
     moonshot-v1-16b-a3b, (64, 2048, 1408), gemma2-9b's wi_gate and
     embedding (3584 x 14336, 256000 x 3584), recurrentgemma-2b's RG-LRU
     w_a (2560 x 2560), xlstm-350m's sLSTM r (4 x 256 x 1024), one
     layer's expert container of llama4-scout-17b-a16e (16, 5120, 8192)
     and whisper-base's unembedding (512 x 51865);
     at qwen3-8b's wq, wi_gate and embedding, the ECF8-FR container
     (``core/fixedrate.py``, encoded on the card) decoded by its plain
     PyTorch decode on the card: fp8 bits equal to the kernel's output
     and to the host oracle ``decode_ref``, its bf16 output equal to the
     kernel's, timed beside the kernel with its transient device memory;
  3. the flash-attention kernel (bf16 and fp16 on the tensor cores)
     against its plain version in bf16 (B=1, Hq=32, Hkv=8, D=128, causal,
     T in {13, 451, 512, 2048}) and fp16 (T=2048), with the time of
     ``F.scaled_dot_product_attention`` as a yardstick (TFLOP/s and the
     factor against it printed; timed after L2 flushes); at moonshot's
     heads (Hq = Hkv = 16, group size 1, T in {451, 2048}); and at
     gemma2-9b's (Hq/Hkv 16/8, D = 256, softcap 50): bf16 at T in {13,
     451, 4096, 6000} within 2e-2, f32 at T in {13, 451} within 1e-5; and
     at recurrentgemma-2b's (multi-query 10 / 1, D = 256, no softcap):
     bf16 at T in {13, 451, 2048} within 2e-2, beside SDPA with
     ``enable_gqa``; and at llama4-scout's (40 / 8 heads of 128, no
     softcap, a group of 5): bf16 at T in {451, 2048, 8192} within 2e-2,
     beside SDPA with ``enable_gqa``; and non-causal at whisper-base's
     (B = 4, 8 / 8 heads of 64, 1500 keys): the encoder's 1500 queries and
     the prefill cross attention's 224, bf16 within 2e-2, beside SDPA at
     ``is_causal=False``;
  3b. the KV page-decode kernel against its plain version, bit-exact:
     252 bf16 pages at the qwen3-8b page shape (8 x 16 x 128, the default
     cold pool of the serve shape), the 48 bf16 pages of phase 7's cold
     pool (``SWAP_N_COLD_SLOTS``, the launch a decode step makes there),
     f32 and fp8 pages, a batch of edge pages (one symbol, all 256
     exponents, mixed strides zero-padded to one, never-written slots),
     and 8 bf16 pages of 128 positions (8 x 128 x 128, the kernel's
     streamed instance: too large to stage in shared memory), and 48
     bf16 pages at moonshot's page shape (16 x 16 x 128) and at gemma2's
     (8 x 16 x 256), with the instance the wrapper picks for each, timed
     on the card;
  3c. the fused decode + matrix product kernel through its op
     (``ops.fused_decode_matmul``; no serve path calls it) at qwen3-8b's
     wq / wi_gate / wo_mlp shapes in the tiled ECF8 layout, M = 4 and 512,
     and M = 600 at wq (the op's row blocks, two launches):
     within 1e-4 of its plain version relative to the output's magnitude,
     two launches bit-equal, and bit-exact on the weight (one-hot rows);
     timed beside what the serve path pays for the same product (the
     weight decode writing bf16, as ``store.materialize`` asks it, then
     torch.matmul), the decode alone and torch.matmul alone;
  3d. training's attention kernels: the flash forward with its row
     statistics (B4, ``stats=True``) and the flash backward (B5,
     ``csrc/flash_bwd.cu``) against their plain versions at qwen3-8b's
     heads (B 2, 32 / 8 of 128, causal, T 2048), gemma2-9b's (16 / 8 of
     256, softcap 50, T 2048) and whisper-base's non-causal (B 4, 8 / 8
     of 64, 1500 queries over 1500 keys): bf16, o bit-identical with and
     without the statistics, m and l within 1e-5 (relative to their
     largest magnitude), dq / dk / dv within 2e-2 x the plain gradient's
     largest magnitude; f32 at T 451 within 1e-5; timed on the card beside
     the backward alone of ``F.scaled_dot_product_attention`` at the same
     shape (no softcap), a yardstick, each timing with the registers and
     spill bytes a thread of B5's two kernels (``flash_bwd.attributes``);
  4. a small f32 model whose prefill logits on the card (both kernels)
     agree with the CPU run (plain versions), whose paged-compressed
     decode-step logits, with cold pages, agree too, and whose chunked-
     prefill logits agree with the CPU and with its own whole-prompt
     prefill; served by the engine on the card, its greedy tokens are the
     same over the monolithic cache as over the paged one, with a draft
     model (k = 1 and 4) as without, and with a draft under page pressure
     (preempting, swapping) as without pressure; moonshot's smoke variant
     at capacity factor 1.25 (tokens dropped): prefill and paged-
     compressed decode logits on the card against the CPU, and its MoE
     layer bit-equal over two card runs (f32 and bf16); the smoke
     variants of granite-20b (GELU, one KV head) and nemotron-4-15b
     (squared ReLU): prefill logits on the card against the CPU;
     gemma2-9b's (heads of 64, window 32): prefill at 37 tokens
     (local_attention, rolled rings) and paged-compressed decode steps
     past the rings' wrap, the card against the CPU; recurrentgemma-2b's
     smoke stack at 8 layers (2 units + 2 tail RG-LRU layers) and
     xlstm-350m's at 5 (a tail sLSTM), every recurrent matrix ECF8:
     prefill and 6 decode steps, the card against the CPU;
     llama4-scout's (8 layers: two ("local", "local", "local", "nope")
     units, window 32, 8 experts top-1 + 1 shared, heads of 64): prefill
     at 37 tokens and paged-compressed decode steps past the rings' wrap,
     the card against the CPU, from an ECF8-TPU tree and from an ECF8-FR
     tree (no kernel decode launched for the latter); whisper-base's
     (2 + 2 layers, heads of 64, 64 frames, every matrix ECF8): the
     encoder output, prefill logits and 6 decode steps over the cached
     cross K/V, the card against the CPU;
  5. qwen3-8b at full width, ``QWEN_LAYERS`` of its 36 layers
     (``--layers``), ECF8-compressed and served by the paged engine (8 requests of 64-512
     prompt tokens, max_batch 4, 32 new tokens, max_len 1024); both
     kernels' launch counts must be non-zero over that run, and every
     weight decode must write bf16 itself (launches counted by output
     dtype; a decode to fp8 bits would need a cast kernel after it; held
     over phases 5-8);
  6. the same prompts on the fp8 baseline: greedy tokens must be identical;
  7. the same prompts served again with ``--cache paged-compressed``, an
     undersized raw pool and cold pool (``SWAP_N_PAGES``,
     ``SWAP_N_COLD_SLOTS``) and an unbounded host swap store: the run must
     preempt and resume, drain its swap store, give tokens identical to
     phase 5's, and launch the page-decode kernel from both the decode
     step's cold-page gather and the swap tier's fault;
  8. the same prompts with chunked, decode-interleaved prefill (chunk and
     budget ``CHUNK``): 8a on the plain paged cache (steps must interleave
     prefill with decode; its tokens are compared with phase 5's, which
     attend through another kernel, and printed, not gated), 8b with phase
     7's pools and swap store (tokens IDENTICAL to 8a's, preemption and
     resume, a drained store, the page-decode kernel launched from gather
     and fault);
  9. the same prompts over the monolithic cache: tokens IDENTICAL to
     phase 5's (the same decode attention over the same values), the
     weight decode and flash prefill launched, every decode writing bf16;
  10. speculative decoding (k = ``SPEC_K``) on the paged target, the same
     prompts: 10a self-draft (the target's own ECF8 tree as the draft;
     verify attends in chunk mode, so its agreement with phase 5's tokens
     is counted, not gated); 10b a 2-layer draft at qwen3-8b's widths
     (seed + 1, ECF8): some proposals rejected and rolled back, tokens
     IDENTICAL to the same run on the fp8 baseline trees (the lossless
     claim under speculation); 10c 10b under phase 7's pools and swap:
     a speculating request preempted with its draft row stashed and
     reinstalled, the store drained, the page-decode kernel launched from
     the verify over cold history (tokens compared with 10b's, counted);
     10d a recurrent draft (one ("rglru", "rglru", "local") unit and two
     tail RG-LRU layers at recurrentgemma-2b's widths, qwen3's vocabulary,
     window 64, seed + 2, ECF8): rejected steps undone in its rings and
     RG-LRU states (at least one rollback with the rings wrapped), tokens
     IDENTICAL to 10b's;
  11. cross-request prefix sharing with the serving telemetry on a chat
     stream (``chat_stream``: two 256-token system prompts A and B from
     ``--seed``, 32-192-token suffixes, in the order A x 4, B x 4, A x 4;
     chunk and budget ``CHUNK``, 32 new tokens): 11a on the plain paged
     cache, sharing off and on (telemetry on in both, tracer included),
     and sharing on with telemetry off: tokens IDENTICAL across the three,
     prefix hits, prompt tokens saved equal to the matched tokens, pages
     shared while two A requests are live, no copy-on-write split, the
     exported Chrome trace valid; TTFT, queue wait and decode-step
     percentiles printed, and the decode step with telemetry on beside
     off; 11b the stream under phase 7's pools and swap store, sharing
     on: tokens IDENTICAL to 11a's, a prefix retired to swap and faulted
     back through the page-decode kernel, preemptions resumed, the pools
     drained to the prefix index's pages.
  12. moonshot-v1-16b-a3b (64 experts top-6, 2 shared) at full width,
     ``MOE_LAYERS`` of its 48 layers, its trees streamed a layer at a
     time by ``launch/serve.py::build_params``, phase 5's prompt rule:
     12a the ECF8 tree alone on the card, paged (the weight decode and
     flash prefill launched, every decode writing bf16); 12c the same
     tree under phase 7's pools and swap store (preempting and resuming,
     the page-decode kernel launched from gather and fault, tokens
     IDENTICAL to 12a's); 12b the fp8 baseline tree alone on the card
     (tokens IDENTICAL to 12a's); weights, step, tok/s, prefill and the
     peak device memory with each tree resident printed.
  13. gemma2-9b at full width and ``GEMMA_LAYERS`` of its 42 layers
     (("local", "attn") units,
     window 4096, head_dim 256, softcaps, post-norms), 4 requests of
     ``GEMMA_PROMPTS`` tokens, max_len 8192, page 16, 32 new tokens:
     13a the ECF8 tree alone, paged (B1 at 7 x 22 + 2 launches a pass, B4
     at D = 256 in every layer of a prompt the window covers and in the
     global ones past it); 13c 13a on a raw pool of
     ``GEMMA_SWAP_N_PAGES`` pages without a cold pool, swap on: a slot
     whose rings have wrapped is preempted, resumes with its rings
     reinstalled and its pages faulted back through B3; 13d the
     monolithic cache; 13b the fp8 tree alone: tokens of 13b-d IDENTICAL
     to 13a's; weights, step, tok/s, prefill, peak device memory and
     launches printed.
  14. recurrentgemma-2b at full width and depth (26 layers = 8 ("rglru",
     "rglru", "local") units + 2 tail RG-LRU layers, d_model 2560, 10 / 1
     heads of 256, GeGLU 7680, vocab 256,000 tied, window 2048), 4
     requests of ``RG_PROMPTS`` tokens, max_len 4096, 32 new tokens, the
     cache resolved to the monolithic one: 14a the ECF8 tree alone (B1 at
     9 a RG-LRU layer, 7 a local layer and 2 launches a pass, every one
     bf16; B4 in every local layer of a prompt the window covers), 14b the
     fp8 tree alone (tokens IDENTICAL to 14a's); one RG-LRU layer's prefill
     timed alone at the longest prompt;
  15. xlstm-350m at full width and depth (12 sLSTM + 12 mLSTM layers,
     d_model 1024, 4 heads, vocab 50,304 untied, no MLP), 4 requests of
     ``XLSTM_PROMPTS`` tokens, max_len 1024, 32 new tokens: 15a ECF8 (B1
     at 6 an mLSTM layer, 2 bf16 and 1 f32 (``r``) an sLSTM layer and 2
     launches a pass), 15b fp8 (tokens IDENTICAL to 15a's); one sLSTM
     layer's prefill (the loop over T) timed alone at 512 tokens.
  16. qwen3-8b at phase 5's depth, prompts and engine settings, served
     from ECF8-FR weights (``fmt="fixedrate"``, decoded on the card by
     plain PyTorch): tokens IDENTICAL to phases 5 (ECF8-TPU) and 6 (fp8),
     no ECF8 decode kernel launched; weights (FR, TPU, fp8), step, tok/s,
     prefill and peak device memory printed; and the container report,
     the paper's Table 1 at qwen3-8b's full width on layer 0's seven
     matrices and the embedding: bytes an element for ECF8-TPU and
     ECF8-FR, for the paper's own container (``core/paper_format.py``,
     host numpy) on the four attention matrices, each decoded back
     bit-exactly by its block-parallel oracle; the exponent entropy H(E),
     the fitted alpha and the limit of ``core/theory.py`` per matrix.
  17. llama4-scout-17b-a16e at full width (d_model 5120, 40 / 8 heads of
     128, qk-norm, 16 experts top-1 of width 8192 + 1 shared, vocab
     202,048 tied, window 8192), ``LLAMA_LAYERS`` of its 48 layers, 4
     requests of ``LLAMA_PROMPTS`` tokens, max_len 8704, page 16, 32 new
     tokens: 17a the ECF8 tree alone, paged (B1 at 11 a layer and 2
     launches a pass, every one bf16; B4 in every layer of a prompt the
     window covers and in the NoPE layers alone past it); 17d the
     monolithic cache; 17b the fp8 tree alone (tokens of 17b and 17d
     IDENTICAL to 17a's); weights, step, tok/s, prefill, peak device
     memory and launches printed.
  18. whisper-base, the encoder-decoder, at full width and depth (6 + 6
     layers, d_model 512, 8 heads of 64, GELU 2048, vocab 51,865 untied,
     1500 frames), its ECF8 and fp8 trees built from ``--seed``, frames
     (4, 1500, 512) drawn from it: for prompts of each of
     ``WHISPER_PROMPTS`` tokens (4 rows), ``prefill(frames=...)`` then
     ``WHISPER_NEW`` greedy decode steps on the contiguous cache at
     max_len 448: 18a from ECF8, 18b from fp8, tokens IDENTICAL; B1 and
     B4 launches equal to what a CPU rehearsal counts (B1 99 a prefill and
     50 a step, all bf16, 0 from fp8; B4 18 a prefill: 6 non-causal
     encoder, 6 causal self, 6 non-causal cross); weights, the encoder's
     ms, prefill s, step ms, tok/s, the cross cache and peak device memory
     printed.
  19. the async front end and router (``launch/load_replay.py``): the
     reference's seeded bursty trace (24 requests, a burst over ticks
     8-12, token ids below the smoke vocabulary) replayed through
     ``AsyncServingFrontend`` over two engine replicas of phase 5's model
     sharing its ECF8 tree and one ``Telemetry`` (max_batch 3, max_len 64,
     chunk 8, prefix sharing, max_pending 6, ``reject``); each completed
     stream IDENTICAL to a synchronous single-engine run of the accepted
     set; two replays with the same placements and shed set, equal to the
     same replay on the CPU at smoke size (placement reads loads and
     prefix indices, never weights); TTFT p50 / p95, tok/s, shed rate,
     prefix hits and the placements printed.  It runs after phase 11, on
     phase 11's tree.
  20. training qwen3-8b at full width (d 4096, 32 / 8 heads of 128, d_ff
     12288, vocab 151,936, untied as the published model), ``TRAIN_LAYERS``
     of its 36 layers, bf16 weights, f32 AdamW moments: the reference's
     synthetic stream at batch 4 x seq 2048, ``grad_accum`` 2, remat, lr
     3e-4, ``TRAIN_STEPS`` steps of ``runtime.steps.make_train_step``
     (B4 with statistics forward, again in the remat recompute, B5
     backward); every loss and gradient norm finite; step 0 repeated from
     the same weights and a fresh optimizer state with the attention
     patched by this script to the plain versions: loss within 5e-3 and
     gradient norm within 2e-2 (relative), and unit 0's wq / wk / wv
     gradients on micro-batch 0 within ``TRAIN_GRAD_TOL`` of their
     largest magnitude (so that B5's dq, dk and dv each reach a weight the
     gate reads); launches equal to what a CPU
     rehearsal counts (a step: B4 2 x layers x grad_accum, B5 layers x
     grad_accum, B1 / B2 / B3 none); step ms, tokens/s, the share of the
     card's 989 TFLOP/s the step's model FLOPs reach, peak device memory;
     one step traced with ``torch.profiler`` (B4's, B5's and the
     backward's share of the device time, the idle share);
  20b. the checkpoint drill at full width and ``CKPT_LAYERS`` layers: the
     free disk printed first (too little fails); 3 steps, ``save_async`` +
     ``wait`` after step 2, restore into a fresh tree on the card (every
     leaf bit-identical to the live state, CRCs verified), step 3 from
     the restored and from the live state (losses within 1e-3 relative,
     bitwise equality printed); the model's fp8 serving tree saved with
     ``compress="ecf8"`` and restored onto the card through B1 (launches
     counted): bits identical, bytes against raw fp8 printed; save and
     restore seconds printed.
  21. serving on a mesh of ranks (``launch/mesh.py``: one process a
     rank, ``torch.distributed``): two ranks sharing the one visible card
     over gloo at ``QWEN_LAYERS`` with phase 5's 8 requests at max_batch 4,
     or, with four or more cards, four NCCL ranks (one a card) at
     ``MESH_LAYERS`` (36) with 16 requests at max_batch 8, 32 new tokens,
     greedy; before the ranks start, B4 with ``q_base`` (a model rank's
     rows of a sharded prefill) against its plain version and, four
     256-row shards, bit for bit against the unsharded launch; which bf16
     products keep a row's bits at 2 rows and at max_batch rows.  Each rank
     builds the ECF8 and fp8 trees on its card from the seed (checksums
     compared) and serves: 21a ``--mesh D`` (D the rank count) on the
     paged-compressed cache with ``MESH_SHARD_PAGES`` raw pages and
     ``MESH_SHARD_COLD`` cold slots a batch shard and swap unbounded, a
     quarter of the requests arriving 8 steps in at priority 1 (they
     preempt); 21b ``--mesh (D/2)x2`` paged (the model axis: the decode
     step's page split and stat merge, the prefill's rows over B4 with
     ``q_base``); 21c ``--mesh D`` with chunk 128; 21d 21a on the fp8
     tree; rank 0 also serves 21a's requests alone.  Gates: every rank's
     tokens, free lists and drained pools alike; 21a's tokens IDENTICAL to
     21d's (the lossless claim on the mesh); B1 and B3 (the sharded cold
     decode) launched on every rank in 21a, B4 with ``q_base`` in 21b; the
     cold pool and the swap tier used; phase 4's small f32 model on
     ``--mesh D`` under page pressure IDENTICAL to one rank (``(D/2)x2``
     reported); ``decode_pages_sharded`` on each rank's share of a 48-page
     cold pool, gathered, bit-exact against the whole pool's decode; 21e
     ``compressed_all_gather`` of qwen3-8b's wi_gate (4096 x 12288 fp8)
     over the ranks bit-exact, its wire bytes and ms beside a raw fp8
     gather (``all_gather_into_tensor`` on NCCL).  Per rank: step ms,
     token-gather ms, launches a step, peak memory, per-shard peak pages
     and swap bytes; aggregate tok/s; the stat merge's ms; tokens against
     rank 0 alone, counted (bf16: reported, not gated).
  22. the mixture-of-experts and recurrent stacks on a mesh of ranks:
     before the ranks start, the ECF8 decode kernel at the expert
     container a rank decodes on the model axis (and, with four cards,
     llama4-scout's) and the flash kernel at the largest model's heads
     against their plain versions.  Each rank builds its trees on its
     card from the seed, on a model axis its share of every expert leaf
     alone (``runtime.sharding.expert_cut``: each layer drawn whole, its
     slice cast and compressed as a container of its own), and serves
     them.  On one card two gloo ranks share it: moonshot-v1-16b-a3b at
     ``MOE_MESH_LAYERS`` of its 48 layers with phase 5's 8 requests at
     max_batch 4 on ``1x2`` (32 experts a rank, the MoE layers' two
     ``all_to_all`` over ``model``) and on ``--mesh 2`` paged-compressed
     (the whole batch routed at once, each rank's routing weights
     gathered over ``data``; B3 on each rank's cold slots), and
     recurrentgemma-2b at ``RG_MESH_LAYERS`` layers on ``--mesh 2`` with
     phase 14's prompts (the monolithic cache split over the data groups:
     each rank holds ``max_batch / 2`` rows).
     With four cards, four NCCL ranks: moonshot at all 48 layers on
     ``1x4``, ``2x2`` and ``--mesh 4`` (paged-compressed) with 16
     requests at max_batch 8, and llama4-scout at all 48 layers on
     ``1x4`` with phase 17's prompts at max_len 8704, its ECF8 and fp8
     trees built and served in turn (both would not fit a card beside the
     cache).  Gates: every rank's tokens alike; ECF8 tokens IDENTICAL to
     the fp8 tree's on every mesh; B1 launched on every rank from ECF8
     (all bf16) and never from fp8, B4 launched, B2 never, B3 on the
     sharded path on every rank of a paged-compressed ``--mesh D`` run;
     ``all_to_all`` on every rank on a model axis and never without one;
     each rank's expert containers of ``E / M`` experts; the cache paged
     for a MoE stack and monolithic for a recurrent one.  Per rank: build
     s, resident and peak GiB, step ms, token-gather ms, launches a step,
     the experts it holds; per mesh: aggregate tok/s, one ``all_to_all``
     (model axis) or routing-weight gather (data axis) at the decode
     shape, timed; tokens against rank 0 alone on ``--mesh D`` (reported,
     not gated).
  23. training on a mesh of ranks (``runtime.steps.make_train_step(mesh=)``:
     the state placed by the rule table, each leaf gathered whole in the
     unit that uses it and its gradient summed into the rank's shard, the
     sequence split over ``model``): before the ranks start, B5 with
     ``q_base`` (and B4 with statistics and ``q_base``) against its plain
     version at qwen3's heads on rows [512, 1024) and [768, 1024) of T =
     1024, at gemma2's (D = 256, softcap 50) and at the micro-batch shape of
     model rank 1, timed beside SDPA's backward with the causal mask as a
     boolean mask; four 256-row shards of T = 1024: each shard's statistics
     and dq bit for bit the unsharded launch's rows, their dk / dv summed
     within 2e-2 of the unsharded.  On one card two gloo ranks share it:
     qwen3-8b untied at full width and ``MESH_TRAIN_LAYERS`` layers, global
     batch 4 x seq 512, grad_accum 2, remat, bf16 weights and f32 moments,
     one step on ``--mesh 2`` and on ``1x2``; with four cards four NCCL
     ranks at all 36 layers (more than one card holds), batch 8 x 2048,
     ``TRAIN_STEPS`` steps on ``--mesh 4`` and ``2x2``.  Gates: every loss
     and gradient norm finite and the ranks' losses equal; step 0 within
     5e-3 (loss) and 2e-2 (gradient norm) of one rank's unsharded step on
     the card from the same seed (one card), of the other mesh's (four
     cards); phase 4's small f32 model on ``(D/2)x2`` within 2e-4 of one
     rank's updated parameters; B4 with statistics (twice a layer a
     micro-batch, remat) and B5 launched on every rank, with ``q_base``
     exactly on the model ranks past the first, no other kernel; each
     rank's resident state (parameters and moments) at most 0.55 (one
     card) or 0.3 (four) of the whole tree's bytes.  Per rank: step ms,
     the collectives' ms a step (a further step with each collective
     synchronised and timed), resident and peak GiB, build s; per mesh:
     aggregate tokens/s and the model-FLOP share of the ranks' 989 TFLOP/s.
  24. training the mixture-of-experts stack on a mesh of ranks (the MoE
     layers route each data group's rows; on a model axis their two
     ``all_to_all`` over ``model`` and the backward of each, under the
     sequence split over the group's positions gathered over ``model``;
     without one the routing weights gathered over ``data``; each rank
     trains its ``E / M`` experts): before the ranks start, B5 and B4 with
     statistics and ``q_base`` against their plain versions at moonshot's
     heads on the last model rank's micro-batch.  moonshot's smoke stack in
     f32, one step (remat, grad_accum 2) on ``1xN`` against one rank's step
     on the card (parameters and first moments within 2e-4, the moments
     of their largest magnitude), and on the model axis with the
     sequence split against the stream whole over ``model`` (the same
     routing: first moments within 2e-4; an ``M``-fold expert gradient
     shows there).  On one card two gloo ranks share it: moonshot at full
     width and ``MOE_TRAIN_LAYERS`` layers, global batch 4 x 512, one
     step on ``1x2`` and ``--mesh 2``; with four cards four NCCL ranks at
     ``MOE_TRAIN_FULL_LAYERS`` layers (more than one card holds), batch 8
     x 2048, grad_accum 2, remat, ``MOE_TRAIN_STEPS`` steps on ``1x4``,
     ``2x2`` and ``--mesh 4``.  Gates: every loss and gradient norm finite
     and the ranks' losses equal; step 0 of ``1xN`` within 5e-3 (loss) and
     2e-2 (gradient norm) of ``--mesh N``'s (both route as one device
     does); B4 with statistics (twice a layer a micro-batch) and B5
     launched on every rank, with ``q_base`` exactly on the model ranks
     past the first, no other kernel; six ``all_to_all`` a MoE layer a
     micro-batch on every rank of a model axis, none without one; each
     rank's resident state at most 0.55 (one card) or 0.3 (four) of the
     whole tree's bytes.  Per rank: step ms, the ``all_to_all`` ms and calls
     a step, the other collectives' ms (a further step with each collective
     synchronised and timed), resident and peak GiB; per mesh: tokens/s and
     the model-FLOP share of the ranks' 989 TFLOP/s (the active parameters:
     the attention, the shared SwiGLU, the gate and ``top_k`` experts).
  25. training the recurrent and sliding-window stacks on a mesh of ranks
     (under the sequence split each RG-LRU, sLSTM and mLSTM mixer runs on
     its normed input gathered over ``model`` and keeps the rank's
     positions; each local layer past its window gathers its k / v over
     ``model`` and runs ``local_attention`` with ``q_base``): before the
     ranks start, B5 and B4 with statistics and ``q_base`` against their
     plain versions at gemma2-9b's heads (16 / 8 of 256, softcap 50) on the
     last model rank's micro-batch of seq 8192.  The smoke stacks of
     recurrentgemma-2b, xlstm-350m and gemma2-9b (heads of 64) in f32, seq
     64 (past their window of 32), one step (remat, grad_accum 2) on
     ``1x2`` (one card) or ``2x2`` (four) against one rank's step on the
     card: loss and updated parameters within 2e-4.  At full width, bf16
     weights and f32 moments, grad_accum 2, remat (``REC_TRAIN_FULL``): on
     four NCCL ranks recurrentgemma-2b at 26 layers, batch 4 x 4096 (past
     its window of 2048), xlstm-350m at 4, batch 8 x 1024, gemma2-9b at
     42, batch 4 x 8192 (past its window of 4096; more state than a card
     holds), ``REC_TRAIN_STEPS`` steps on ``1x4`` and ``2x2``; on one card
     two gloo ranks on ``1x2``, one step each (``REC_TRAIN_ONE_CARD``:
     recurrentgemma at 3 layers, batch 2 x 4096, xlstm at 2, batch 4 x
     512).  Gates: every loss and gradient norm finite and the ranks'
     losses equal; step 0 within 5e-3 (loss) and 2e-2 (gradient norm) of
     one rank's unsharded step on card 0 from the same seed (recurrentgemma,
     in micro-batches of one row, and xlstm), of the other mesh's
     (gemma2); B4 with statistics (twice a global layer a micro-batch) and
     B5 launched on gemma2's global layers alone, with ``q_base`` exactly
     on the model ranks past the first, and no kernel for recurrentgemma
     (every local layer past its window) and xlstm; each rank's resident
     state at most 0.55 (one card) or 0.3 (four) of the whole tree's
     bytes.  Per rank: step ms, the collectives' ms a step and the
     mixers' forward ms by kind, to their issue's end and to the card's
     (a further step with each synchronised and timed), resident and peak
     GiB; per mesh: tokens/s and the model-FLOP share of the ranks' 989
     TFLOP/s; the one-rank step's ms, its mixers' and its peak GiB.
  26. the prefill and decode step factories on a mesh of ranks
     (``runtime.steps.make_prefill_step(mesh=)`` / ``make_decode_step(
     mesh=)``: each rank its batch shard's rows; the prefill's
     self-attention query rows split over ``model``, B4 with ``q_base``;
     the rank's cache, each self-attention row that the model axis divides
     cut to the rank's positions and decoded through the owner's write and
     the stat merge, every other row, the cross K/V and the recurrent
     states whole) and whisper-base trained on a mesh (the encoder whole on
     every model rank, its leaves gathered, the cross attention's queries
     the rank's decoder positions).  Before the ranks start, B5 and B4
     with statistics against their plain versions at whisper's cross
     attention on a rank of ``1x4`` (a micro-batch's 4 rows, 112 decoder
     rows over 1500 frames, non-causal), timed beside SDPA's backward; one
     rank's unsharded whisper step on the card, the oracle.  On one card
     two gloo ranks share it: whisper-base at full width and depth trained
     one step (batch 4 x 448, 1500 frames, grad_accum 2, remat, bf16
     weights, f32 moments) on ``1x2`` and ``--mesh 2``; the factories'
     prefill (4 rows of ``STEPS_WHISPER_PROMPT`` tokens, max_len 448) and
     ``STEPS_NEW`` greedy decode steps on both meshes from the ECF8 and
     the fp8 tree; qwen3-8b at ``QWEN_LAYERS`` through the factories on
     ``1x2`` (4 rows of ``STEPS_QWEN_PROMPT``, max_len 2048), both trees.
     With four cards, four NCCL ranks: whisper trained
     ``STEPS_TRAIN_STEPS`` steps on ``1x4`` and ``2x2`` (batch 8 x 448)
     and its factories there (8 rows); qwen3-8b at all 36 layers through
     the factories on ``1x4`` and ``2x2`` (8 rows of 452 tokens, max_len
     2048); recurrentgemma-2b at 26 layers on ``2x2`` (4 rows of
     ``STEPS_RG_PROMPT`` tokens, past its 2048 window, max_len 4096).
     Gates: whisper's losses finite and equal on every rank, step 0 within
     5e-3 (loss) and 2e-2 (gradient norm) of one rank's; its B4 (the
     encoder once, each decoder layer's self and cross attention twice
     with remat, a micro-batch) and B5 launches a step exact, ``q_base``
     only on the decoder's self attention of the model ranks past the
     first, no other kernel; each factory prefill's B4 launches exact (the
     flash layers' self attention, an encoder's and cross attention's),
     ``q_base`` on the self attention of the model ranks past the first
     alone, none in a decode step; B1 on every rank from ECF8 and never
     from fp8, B2, B3 and B5 never; each rank's cache leaves of the shapes
     above; every rank's tokens alike within its data group; ECF8 tokens
     IDENTICAL to the fp8 tree's on every mesh.  Per rank: step ms, the
     stat merge's ms a step (a few more steps with its gathers
     synchronised and timed), prefill s, the cache's GiB, peak GiB; per
     mesh: tokens/s; against card 0 alone on the whole batch from the fp8
     tree: its step ms and cache GiB, and the rows whose tokens match
     (bf16 merges round apart: reported, not gated).
  27. the dry run against the card (``launch/dryrun.py``'s building
     blocks, ``analysis/op_cost.py``, ``analysis/roofline.py``), on phase
     20's trained state (no second build): the train step of phase 20's
     configuration traced on fake ``cuda`` tensors of the state's shapes
     and dtypes (``dryrun.fake_like``, ``dryrun.trace``: shape-only, the
     kernels counted from their shapes), then the same step run on the
     card under the same ``op_cost`` counter, then once without it.
     Gates: the traced FLOPs equal the card step's within 0.1 %; the
     predicted parameter and AdamW bytes equal the rise in
     ``torch.cuda.memory_allocated()`` they caused within 1 %; the card
     step's B4 (with statistics) and B5 launches exact (2 x layers x
     grad_accum and layers x grad_accum), no other kernel, and the same
     two kernels counted by the trace.  Reported, not gated: the predicted
     peak above the arguments against ``max_memory_allocated``, the
     traced-FLOP and model-FLOP (``roofline.model_flops``, 6ND) shares of
     989 TFLOP/s at phase 20's median step, the useful share, the dry
     run's bounding term against the measured step, the counter's host
     cost, the card's name and power limit.
Each phase logs the time since the start when it is done.  Phases 5-13,
16, 17 and 19 run at a cut depth so that the whole script stays well
inside its time limit on a slow host (14, 15 and 18 at full depth), 20
and 20b at a depth whose parameters, gradients and moments fit the card;
every gate is depth-independent.
No serve phase may launch the fused kernel.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16, SXM data sheet
H100_F32_FLOPS = 67e12              # f32 outside the tensor cores, SXM
FLASH_TOL = 2e-2
# B4 non-causal at whisper's shapes: unit-normal q / k / v over 1500 keys
# average ~550 keys each, so outputs have an RMS near 0.043 and FLASH_TOL
# would sit at half a typical value; measured 9.8e-4 on the H100 (about one
# bf16 ulp of the largest output)
WHISPER_FLASH_TOL = 4e-3
FUSED_TOL = 1e-4        # relative to max |plain|: f32 sums in another order
# phase 7's undersized pools: raw pages (id 0 is the garbage page) and cold
# slots, against a worst case of 1 + 4 * 1024 / 16 = 257 pages
SWAP_N_PAGES, SWAP_N_COLD_SLOTS = 40, 48
CHUNK = 128             # phase 8's prefill chunk and per-step token budget
SPEC_K = 4              # phase 10's drafted tokens a round
SYSTEM_TOKENS = 256     # phase 11's shared system prompts
B2_ROWS = 600           # phase 3c's M above the kernel's row block (512)
MOE_ARCH = "moonshot-v1-16b-a3b"    # phase 12's model
QWEN_LAYERS = 2         # phases 5-11's depth (qwen3-8b has 36)
MOE_LAYERS = 8          # phase 12's depth (moonshot-v1-16b-a3b has 48)
GEMMA_ARCH = "gemma2-9b"            # phase 13's model
GEMMA_LAYERS = 8        # phase 13's depth: 4 of its 21 units
# phase 13's prompts: longer than the local window (4096) at prefill
# (local_attention, a rolled ring), one that wraps its ring in decode, one
# that never does; submitted in this order
GEMMA_PROMPTS = (6000, 5000, 4080, 1024)
GEMMA_MAX_LEN = 8192
# 13c's raw pool (id 0 is the garbage page), from a 1-layer CPU rehearsal:
# the first three prompts' pages and nothing more, so that the first page
# one of them needs in decode preempts a slot whose ring has wrapped
GEMMA_SWAP_N_PAGES = 946
RG_ARCH = "recurrentgemma-2b"       # phase 14's model
# phase 14's prompts: past the window (2048) at prefill (local_attention, a
# rolled ring), one that wraps its ring in decode, two that never do
RG_PROMPTS = (3000, 2030, 1024, 451)
RG_MAX_LEN = 4096
XLSTM_ARCH = "xlstm-350m"           # phase 15's model
# phase 15's prompts: lengths the mLSTM's whole-prompt prefill takes (at
# most 128 tokens, or a multiple of 128)
XLSTM_PROMPTS = (512, 384, 128, 77)
XLSTM_MAX_LEN = 1024
LLAMA_ARCH = "llama4-scout-17b-a16e"    # phase 17's model
LLAMA_LAYERS = 8        # phase 17's depth: 2 of its 12 units (48 layers)
# phase 17's prompts: past the window (8192) at prefill (local_attention,
# a rolled ring; B4 in the NoPE layers only), one that wraps its rings in
# decode, two that never do; submitted in this order
LLAMA_PROMPTS = (8500, 8180, 2048, 451)
LLAMA_MAX_LEN = 8704
WHISPER_ARCH = "whisper-base"       # phase 18's model
WHISPER_BATCH = 4
# phase 18's prompts: the start-of-transcript prefix (4 tokens) and the
# prompt-conditioning limit (224); max_len is whisper's n_text_ctx
WHISPER_PROMPTS = (4, 224)
WHISPER_MAX_LEN = 448
WHISPER_NEW = 64        # decode steps after each prefill
# phase 20: bf16 weights, their f32 gradient sums and AdamW moments take
# ~12 bytes a parameter; qwen3-8b's 36 layers would need ~98 GB
TRAIN_LAYERS = 8
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_LR = 4, 2048, 2, 3e-4
CKPT_LAYERS = 1         # phase 20b: ~14 GB of bf16 weights + f32 moments
# phase 20: unit 0's wq / wk / wv gradients against the plain attention's,
# relative to their largest magnitude
TRAIN_GRAD_TOL = 1e-2
FLASH_STATS_TOL = 1e-5  # m and l, relative to their largest magnitude
# phase 21 on four or more cards: qwen3-8b at full depth, 16 requests at
# max_batch 8 (two slots a batch shard); on one card two ranks share it at
# QWEN_LAYERS with phase 5's 8 requests at max_batch 4
MESH_LAYERS, MESH_REQUESTS, MESH_BATCH = 36, 16, 8
# --only's names: the build, the mesh phases and phase 27 (with phase 20,
# whose trained state it reads)
MESH_PHASES = ("1", "21", "22", "23", "24", "25", "26", "27")
# phase 22 on one card: moonshot at 2 of its 48 layers on two gloo ranks
# (its trees built four times, whole and halved, beside phase 21's
# leftovers) and recurrentgemma-2b at one unit and its two tail layers; on
# four cards moonshot and llama4-scout at full depth
MOE_MESH_LAYERS, RG_MESH_LAYERS, MOE_LAYERS_FULL = 2, 5, 48
MESH_SHARD_PAGES, MESH_SHARD_COLD = 32, 2   # 21a's pools a batch shard
# phase 23 on one card: qwen3-8b (untied) at 1 of its 36 layers on two gloo
# ranks, global batch 4 x 512; on four cards all 36 layers (~12 bytes a
# parameter, more than one card holds), batch 8 x 2048; grad_accum 2
MESH_TRAIN_LAYERS, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH = 1, 512, 4
MESH_TRAIN_FULL_SEQ, MESH_TRAIN_FULL_BATCH = 2048, 8
MESH_TRAIN_ACCUM = 2
# phase 24: moonshot-v1-16b-a3b at full width, phase 23's batches; on one
# card 1 of its 48 layers on two gloo ranks, on four cards 24 (the depth
# phase 12 serves at: ~14.4 B parameters at ~10 bytes each, ~36 GB a rank)
MOE_TRAIN_LAYERS, MOE_TRAIN_FULL_LAYERS, MOE_TRAIN_STEPS = 1, 24, 4
# phase 25: the recurrent and sliding-window stacks at full width, each
# sequence past its local window, trained on a mesh: (arch, layers, seq,
# global batch) on four cards and, two gloo ranks sharing one card, the
# one-card cut; gemma2-9b (more state than a card holds) on four only
# (xlstm at 4 of its 24 layers: its sLSTM loop issues ~20 kernels a
# position a layer from the host, ~1.3-2.1 ms a position with autograd on
# one card, so 24 layers would take minutes a step)
REC_TRAIN_FULL = ((RG_ARCH, 26, 4096, 4), (XLSTM_ARCH, 4, 1024, 8),
                  (GEMMA_ARCH, 42, 8192, 4))
REC_TRAIN_ONE_CARD = ((RG_ARCH, 3, 4096, 2), (XLSTM_ARCH, 2, 512, 4))
REC_TRAIN_STEPS = 3
# the one-rank reference of recurrentgemma-2b on one card runs
# micro-batches of one row (the same mean gradient as the mesh's
# grad_accum 2): at full width its f32 logits of 256,000 entries a position
# then sit beside ~46 GB of state
REC_ONE_ROW = (RG_ARCH,)
# phase 26: the prefill and decode step factories on a mesh and whisper-base
# trained there.  The factories take a rectangular batch: qwen3-8b's rows
# share one prompt length, phase 21's longest (451) rounded up to a
# multiple of 4 so that the prefill's query rows split over every model
# axis; recurrentgemma's pass its 2048-position window
STEPS_NEW = 32                      # greedy decode steps after a prefill
STEPS_QWEN_PROMPT, STEPS_QWEN_MAX_LEN = 452, 2048
STEPS_RG_PROMPT, STEPS_RG_MAX_LEN = 2400, RG_MAX_LEN
STEPS_WHISPER_PROMPT = 224          # phase 18's longer prompt
STEPS_WHISPER_SEQ = 448             # whisper's n_text_ctx, trained at it
STEPS_TRAIN_STEPS = 3               # on four cards (one on one card)
STEPS_TIMED = 4                     # decode steps with the merge timed


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi exit {out.returncode}: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, flush=None) -> float:
    """Device time of one call of ``fn``, CUDA events: a window of ``reps``
    calls issued back to back, less the same window of L2 flushes alone
    when ``flush`` is given (the cache is overwritten before each call);
    the median of three windows.  A flush takes the card longer than the
    host takes to issue a call, so the host runs ahead and the window holds
    no idle gap; events around a single call would count the host's issue
    time whenever the call is shorter than it."""
    fn()                                     # warm-up (and lazy loads)

    def window(body):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            body()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def flushed():
        flush.zero_()
        fn()

    times = []
    for _ in range(3):
        if flush is None:
            times.append(window(fn) / reps)
        else:
            times.append((window(flushed) - window(flush.zero_)) / reps)
    return statistics.median(times)


_INT_VIEW = {"bfloat16": "int16", "float16": "int16", "float32": "int32"}


def same_values(torch, got, want) -> bool:
    """Bit-equal, NaNs (whose payload a cast may set differently) by
    ``isnan``."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.uint8:
        return torch.equal(got, want)
    bits = getattr(torch, _INT_VIEW[str(got.dtype).split(".")[-1]])
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(bits), want[~nan].view(bits)))


def check_decode(torch, ecf8_decode, fp8, tpu_format, name, bits, flush,
                 reps, fixedrate=None):
    """Kernel 1 vs its plain version on one container: fp8 bits bit-exact
    and lossless; the bf16, fp16 and f32 instances bit-identical to plain
    decode + cast; the time of the bf16 instance beside the fp8-bits
    instance followed by a cast -> result dict of the serve path's instance
    (bf16).  With ``fixedrate`` (the module), the same weight's ECF8-FR
    container is held against the kernel's output (:func:`check_fixedrate`)
    and its result is the dict's ``"fixedrate"`` entry.
    ``launch/bench_decode.py`` times the decode path of another checkout
    against this one."""
    t0 = time.perf_counter()
    c = tpu_format.encode(bits.reshape(-1).contiguous())
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    args = (c.payload, c.signmant, c.lj_limit, c.first_lj, c.offset, c.perm)
    kw = dict(sym_per_lane=c.sym_per_lane, n_elem=c.n_elem)
    got = ecf8_decode.run(*args, **kw)
    want = ecf8_decode.plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"ecf8_decode {name}: kernel differs from the plain version at "
             f"{int((got != want).sum())} of {c.n_elem} bytes")
    if not torch.equal(got, bits.reshape(-1)):
        fail(f"ecf8_decode {name}: decode is not lossless")
    fr = (check_fixedrate(torch, fixedrate, fp8, name, bits, got, flush,
                          reps) if fixedrate is not None else None)
    del got
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        out = ecf8_decode.run(*args, **kw, out_dtype=dt)
        if not same_values(torch, out, want.view(fp8.FP8_DTYPE).to(dt)):
            fail(f"ecf8_decode {name}: the {dt} instance differs from plain "
                 f"decode + cast")
        del out
    del want
    bf16 = torch.bfloat16
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    ms = cuda_ms(torch, lambda: ecf8_decode.run(*args, **kw, out_dtype=bf16),
                 reps, flush)
    fp8_ms = cuda_ms(torch, lambda: ecf8_decode.run(*args, **kw), reps, flush)
    old_ms = cuda_ms(torch, lambda: ecf8_decode.run(*args, **kw).view(
        fp8.FP8_DTYPE).to(bf16), reps, flush)
    plain_ms = cuda_ms(torch, lambda: ecf8_decode.plain(
        *args, **kw, out_dtype=bf16), 2, flush)
    bound_ms = (in_bytes + 2 * c.n_elem) / H100_BYTES_PER_S * 1e3
    bound_fp8 = (in_bytes + c.n_elem) / H100_BYTES_PER_S * 1e3
    log(f"ecf8_decode {name} {tuple(bits.shape)}: fp8 bits bit-exact, bf16 /"
        f" fp16 / f32 instances bit-identical to plain decode + cast, "
        f"S={c.sym_per_lane} stride={c.stride} encode {enc_s:.2f}s; bf16 "
        f"out: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({(in_bytes + 2 * c.n_elem) / 1e6:.1f} MB, "
        f"{100 * bound_ms / ms:.1f} % of it), plain + cast "
        f"{plain_ms:.2f} ms; the fp8-bits instance + .to(bf16) (the serve "
        f"path's shape before the decode wrote bf16) {old_ms:.4f} ms "
        f"({old_ms / ms:.2f}x the bf16 instance), fp8 bits alone "
        f"{fp8_ms:.4f} ms (bound {bound_fp8:.4f} ms)")
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by="bytes", library_ms=None,
               old_ms=old_ms, fp8_ms=fp8_ms,
               bytes_per_elem=in_bytes / c.n_elem)
    if fr is not None:
        fr["b1_ms"] = ms
        fr["fr_over_b1"] = fr["ms"] / ms
        log(f"fixedrate {name}: plain decode to bf16 {fr['ms']:.4f} ms "
            f"against the ECF8 decode kernel's {ms:.4f} ms "
            f"({fr['fr_over_b1']:.2f}x); {fr['bytes_per_elem']:.4f} against "
            f"{out['bytes_per_elem']:.4f} bytes an element")
        out["fixedrate"] = fr
    return out


def check_fixedrate(torch, fixedrate, fp8, name, bits, b1_bits, flush, reps):
    """The ECF8-FR container of ``bits``, encoded on the card, decoded by
    its plain PyTorch decode on the card: fp8 bits equal to kernel 1's
    output ``b1_bits`` and to the host oracle ``decode_ref``, the bf16
    output equal to plain decode + cast; timed (bf16 out) with the device
    memory its slices take beyond their output -> result dict."""
    flat = bits.reshape(-1)
    t0 = time.perf_counter()
    c = fixedrate.encode(flat)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    args = (c.codes, c.escapes, c.table, c.signmant)
    got = fixedrate.decode_plain(*args, n_elem=c.n_elem)
    if got.device.type != "cuda" or not torch.equal(got, b1_bits):
        fail(f"fixedrate {name}: the decode on the card differs from the "
             f"ECF8 decode kernel's bits")
    t0 = time.perf_counter()
    host = fixedrate.decode_ref(c)
    host_s = time.perf_counter() - t0
    if not torch.equal(host.reshape(-1), got.cpu()):
        fail(f"fixedrate {name}: the decode on the card differs from the "
             f"host oracle")
    del got, host
    bf16 = torch.bfloat16
    out = fixedrate.decode_plain(*args, n_elem=c.n_elem, out_dtype=bf16)
    if not same_values(torch, out, flat.view(fp8.FP8_DTYPE).to(bf16)):
        fail(f"fixedrate {name}: the bf16 output differs from plain decode "
             f"+ cast")
    del out
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fixedrate.decode_plain(*args, n_elem=c.n_elem, out_dtype=bf16)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before - 2 * c.n_elem
    del out
    ms = cuda_ms(torch, lambda: fixedrate.decode_plain(
        *args, n_elem=c.n_elem, out_dtype=bf16), reps, flush)
    in_bytes = sum(t.numel() for t in args)
    bound_ms = (in_bytes + 2 * c.n_elem) / H100_BYTES_PER_S * 1e3
    log(f"fixedrate {name} {tuple(bits.shape)}: fp8 bits on the card equal "
        f"to the ECF8 decode kernel's and to the host oracle ({host_s:.2f}s "
        f"on the host), bf16 equal to plain decode + cast; table "
        f"{c.table.tolist()}, {c.esc_count} escapes "
        f"({100 * c.esc_count / c.n_elem:.4f} %), {c.ratio:.4f} bytes an "
        f"element, encode on the card "
        f"{enc_s:.2f}s; decode to bf16 {ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({100 * bound_ms / ms:.1f} % of it), transient device memory "
        f"{transient / 1e6:.1f} MB beyond its {2 * c.n_elem / 1e6:.1f} MB "
        f"output")
    return dict(ms=ms, bound_ms=bound_ms, bytes_per_elem=c.ratio,
                esc_count=c.esc_count, transient_bytes=transient,
                encode_s=enc_s, host_oracle_s=host_s)


def check_decode_codes(torch, ecf8_decode, fp8, tpu_format, name, bits,
                       spl):
    """Kernel 1 on a small container, every output type, against plain
    decode (+ cast)."""
    c = tpu_format.encode(bits, sym_per_lane=spl)
    a = (c.payload, c.signmant, c.lj_limit, c.first_lj, c.offset, c.perm)
    kw = dict(sym_per_lane=c.sym_per_lane, n_elem=c.n_elem)
    want = ecf8_decode.plain(*a, **kw)
    if not torch.equal(want, bits):
        fail(f"ecf8_decode {name}: the plain decode is not lossless")
    for dt in (None, torch.bfloat16, torch.float16, torch.float32):
        ref = want if dt is None else want.view(fp8.FP8_DTYPE).to(dt)
        got = ecf8_decode.run(*a, **kw, out_dtype=dt)
        if not same_values(torch, got, ref):
            fail(f"ecf8_decode {name}: out_dtype {dt} differs from plain "
                 f"decode + cast")
    log(f"ecf8_decode {name}: fp8 bits, bf16, fp16 and f32 bit-identical to "
        f"plain decode + cast (NaNs by isnan)")


def check_flash(torch, flash_fwd, T, gen, flush, dtype=None, heads=(32, 8),
                D=128, softcap=0.0, tol=FLASH_TOL, gqa=False, causal=True,
                B=1, Tk=None, q_base=0):
    """Kernel 4 vs its plain version (bf16 unless ``dtype``, causal unless
    ``causal`` is False, ``B`` rows of ``T`` queries over ``Tk`` keys (T by
    default), ``heads`` = (Hq, Hkv) of ``D``, qwen3-8b's by default, tanh
    ``softcap``; ``q_base`` the global position of query row 0, a model
    rank's rows of a sharded prefill, where SDPA takes the causal mask
    as an explicit boolean mask), every output element within ``tol`` ->
    result dict.
    Timed after L2 flushes: a window of back-to-back calls alone would time
    the host's issue of each call (~20 us) wherever the kernel is shorter.
    SDPA, the yardstick, has no softcap: it is timed without one, on K/V
    repeated to the query heads, or with ``gqa`` on the KV heads
    (``enable_gqa``)."""
    Hq, Hkv = heads
    Tk = Tk or T
    dev = "cuda"
    dtype = dtype or torch.bfloat16

    def rnd(h, n):
        return torch.randn((B, h, n, D), generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q, k, v = rnd(Hq, T), rnd(Hkv, Tk), rnd(Hkv, Tk)
    got = flash_fwd.run(q, k, v, causal=causal, softcap=softcap,
                        q_base=q_base)
    want = flash_fwd.plain(q, k, v, causal, softcap, q_base=q_base)
    torch.cuda.synchronize()
    what = (f"T={T}{'' if Tk == T else f' Tk={Tk}'}"
            f"{f' q_base={q_base}' if q_base else ''} D={D}")
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"flash_fwd {what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if err > tol:
        fail(f"flash_fwd {what} {dtype}: max |kernel - plain| = {err} "
             f"> {tol}")
    ms = cuda_ms(torch, lambda: flash_fwd.run(q, k, v, causal=causal,
                                              softcap=softcap,
                                              q_base=q_base), 20, flush)
    plain_ms = cuda_ms(torch, lambda: flash_fwd.plain(
        q, k, v, causal, softcap, q_base=q_base), 5, flush)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if q_base:
        mask = (torch.arange(Tk, device=dev)[None, :]
                <= q_base + torch.arange(T, device=dev)[:, None])
        k_rep = k.repeat_interleave(Hq // Hkv, dim=1)
        v_rep = v.repeat_interleave(Hq // Hkv, dim=1)
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k_rep, v_rep,
                                             attn_mask=mask), 20, flush)
    elif gqa:
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                             enable_gqa=True), 20, flush)
    else:
        k_rep = k.repeat_interleave(Hq // Hkv, dim=1)
        v_rep = v.repeat_interleave(Hq // Hkv, dim=1)
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k_rep, v_rep,
                                             is_causal=causal), 20, flush)
    pairs = (sum(min(Tk, q_base + r + 1) for r in range(T)) if causal
             else T * Tk)
    flops = 4 * B * Hq * D * pairs
    moved = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    bound_ops = flops / peak * 1e3
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    log(f"flash_fwd B={B} {what} Hq={Hq} Hkv={Hkv} softcap {softcap:g} "
        f"{'causal' if causal else 'non-causal'} "
        f"{str(dtype).split('.')[-1]}: max_abs_err "
        f"{err:.3e} (tol {tol}), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, sdpa{' (enable_gqa)' if gqa else ''} "
        f"{lib_ms:.4f} ms (kernel / sdpa "
        f"{ms / lib_ms:.2f}), bound {bound_ms:.4f} ms "
        f"({'operations' if bound_ops >= bound_bytes else 'bytes'}; "
        f"{100 * bound_ms / ms:.1f} % of it), "
        f"{flops / ms / 1e9:.2f} TFLOP/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                library_ms=lib_ms)


def check_flash_bwd(torch, flash_fwd, flash_bwd, gen, flush, T, heads, D,
                    softcap=0.0, causal=True, B=1, Tk=None, dtype=None,
                    tol=FLASH_TOL, q_base=0):
    """Phase 3d at one shape (module docstring) -> result dict.  B4 with
    its row statistics against B4 without them (o bit-identical) and
    against its plain version (m, l); B5 against its plain version on the
    same residuals, every gradient element within ``tol`` x the plain
    gradient's largest magnitude.  Timed after L2 flushes, beside the
    backward alone of SDPA (no softcap: SDPA has none) on the same
    inputs.  ``q_base`` (phase 23): the ``T`` rows are positions
    ``[q_base, q_base + T)`` of ``Tk`` keys (a model rank's rows), SDPA
    given the causal mask as a boolean mask."""
    Hq, Hkv = heads
    Tk = Tk or T
    dtype = dtype or torch.bfloat16

    def rnd(h, n):
        return torch.randn((B, h, n, D), generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    q, k, v, do = rnd(Hq, T), rnd(Hkv, Tk), rnd(Hkv, Tk), rnd(Hq, T)
    what = (f"B={B} T={T}{'' if Tk == T else f' Tk={Tk}'} Hq={Hq} Hkv={Hkv} "
            f"D={D} softcap {softcap:g} "
            f"{'causal' if causal else 'non-causal'} "
            f"{str(dtype).split('.')[-1]}"
            f"{f' q_base {q_base}' if q_base else ''}")
    qb = dict(q_base=q_base)
    o0 = flash_fwd.run(q, k, v, causal=causal, softcap=softcap, **qb)
    o, m, l = flash_fwd.run(q, k, v, causal=causal, softcap=softcap,
                            stats=True, **qb)
    _, m_p, l_p = flash_fwd.plain_stats(q, k, v, causal, softcap, **qb)
    torch.cuda.synchronize()
    if not torch.equal(o.view(torch.uint8), o0.view(torch.uint8)):
        fail(f"flash_fwd {what}: o with statistics differs from o without")
    stats_err = max(float((got - want).abs().max()) / float(want.abs().max())
                    for got, want in ((m, m_p), (l, l_p)))
    if not stats_err <= FLASH_STATS_TOL:
        fail(f"flash_fwd {what}: m / l off their plain version by "
             f"{stats_err} (relative) > {FLASH_STATS_TOL}")
    grads = flash_bwd.run(q, k, v, o, m, l, do, causal=causal,
                          softcap=softcap, **qb)
    want = flash_bwd.plain(q, k, v, o, m, l, do, causal, softcap, **qb)
    torch.cuda.synchronize()
    err = rel = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        if not bool(torch.isfinite(g.float()).all()):
            fail(f"flash_bwd {what}: non-finite {name}")
        e = float((g.float() - w.float()).abs().max())
        r = e / float(w.float().abs().max())
        if not r <= tol:
            fail(f"flash_bwd {what}: max |{name} kernel - plain| = {e}, "
                 f"{r} of its largest magnitude > {tol}")
        err, rel = max(err, e), max(rel, r)
    ms = cuda_ms(torch, lambda: flash_bwd.run(
        q, k, v, o, m, l, do, causal=causal, softcap=softcap, **qb), 10,
        flush)
    plain_ms = cuda_ms(torch, lambda: flash_bwd.plain(
        q, k, v, o, m, l, do, causal, softcap, **qb), 2, flush)
    fwd_ms = cuda_ms(torch, lambda: flash_fwd.run(
        q, k, v, causal=causal, softcap=softcap, **qb), 10, flush)
    stats_ms = cuda_ms(torch, lambda: flash_fwd.run(
        q, k, v, causal=causal, softcap=softcap, stats=True, **qb), 10,
        flush)
    if q_base:      # the mask explicit, K / V repeated to the heads
        rows = q_base + torch.arange(T, device="cuda")
        mask = torch.arange(Tk, device="cuda")[None, :] <= rows[:, None]
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            q, k.repeat_interleave(Hq // Hkv, dim=1),
            v.repeat_interleave(Hq // Hkv, dim=1))]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask)
    else:
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=causal, enable_gqa=Hq != Hkv)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10, flush)
    del out, leaves
    # the (q, k) pairs the causal mask leaves visible
    pairs = (sum(min(Tk, q_base + r + 1) for r in range(T)) if causal
             else T * Tk)
    flops = 10 * B * Hq * D * pairs          # five products, 2.5x forward
    moved = sum(t.numel() * t.element_size()
                for t in (q, k, v, o, m, l, do, *grads))
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    bound_ops = flops / peak * 1e3
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    regs = flash_bwd.attributes(D, dtype)   # (registers, spill bytes)
    log(f"flash_bwd {what}: o with stats bit-identical, m / l within "
        f"{stats_err:.2e} (tol {FLASH_STATS_TOL}); dq / dk / dv max_abs_err "
        f"{err:.3e} ({rel:.2e} of the largest, tol {tol}); kernel {ms:.4f}"
        f" ms, plain {plain_ms:.3f} ms, sdpa backward {lib_ms:.4f} ms "
        f"(kernel / sdpa {ms / lib_ms:.2f}), bound {bound_ms:.4f} ms "
        f"({'operations' if bound_ops >= bound_bytes else 'bytes'}; "
        f"{100 * bound_ms / ms:.1f} % of it), {flops / ms / 1e9:.2f} "
        f"TFLOP/s; registers / spill bytes a thread: dq {regs['dq']}, "
        f"dk / dv {regs['dkv']}; B4 forward {fwd_ms:.4f} ms, with stats "
        f"{stats_ms:.4f} ms")
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                library_ms=lib_ms, stats_err=stats_err, fwd_ms=fwd_ms,
                fwd_stats_ms=stats_ms, registers=regs)


def _profile_step(torch, run_step, wall_s):
    """Device time of one training step traced by ``torch.profiler`` ->
    busy, B4, B5 and backward ms, the kernel count, the idle share of the
    untraced step's ``wall_s`` and the eight costliest kernels: the
    backward is every kernel under the autograd engine's top-level
    ``evaluate_function`` events (the remat recompute included)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    busy = b4 = b5 = bwd = 0.0
    n = 0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            n += 1
            b4 += us if "flash_fwd" in e.name else 0.0
            b5 += us if "flash_bwd" in e.name else 0.0
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
        elif (e.name.startswith("autograd::engine::evaluate_function")
              and e.cpu_parent is None):
            bwd += float(e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(busy_ms=busy / 1e3, b4_ms=b4 / 1e3, b5_ms=b5 / 1e3,
                backward_ms=bwd / 1e3, kernels=n,
                idle_share=max(0.0, 1.0 - busy / 1e3 / (wall_s * 1e3)),
                top_kernels_ms={k: v / 1e3 for k, v in top})


def train_phase(torch, M, kernels, cfg, seed, probe=None):
    """Phase 20 (module docstring) on ``cfg`` -> (measurements, launches).
    ``kernels`` maps name -> wrapper (``run``) whose launch counts the
    phase reads; the flash wrappers are patched to their plain versions,
    and put back, for the reference step.  ``probe(params, opt, step_fn,
    data, state_bytes, step_s)`` (phase 27) runs on the trained state after
    the traced step: ``state_bytes`` is what the parameters and the AdamW
    state raised ``torch.cuda.memory_allocated()`` by."""
    from repro_torch.core.store import torch_dtype
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_bwd, flash_fwd
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         iter_leaves, map_tree)
    from repro_torch.runtime.steps import make_train_step
    gib = 2 ** 30
    L, A = cfg.n_layers, TRAIN_ACCUM
    want = {"ecf8_decode": 0, "fused_decode_matmul": 0, "kv_page_decode": 0,
            "flash_fwd": 2 * L * A, "flash_bwd": L * A}
    log(f"phase 20: training {cfg.name} at full width (d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.dtype}), "
        f"{L} layers; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, grad_accum {A},"
        f" remat, lr {TRAIN_LR}, {TRAIN_STEPS} steps; launches a step "
        f"expected {want}")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = M.init_params(cfg, seed, device="cuda",
                           dtype=torch_dtype(cfg.dtype))
    state_bytes = torch.cuda.memory_allocated() - base_mem
    n_params = sum(p.numel() for _, p in iter_leaves(params))
    p0 = map_tree(torch.clone, params)       # step 0's weights, kept
    before_opt = torch.cuda.memory_allocated()
    opt = adamw_init(params)
    state_bytes += torch.cuda.memory_allocated() - before_opt
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH, seed))
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR),
                              grad_accum=A, remat=True, warmup_steps=1,
                              total_steps=TRAIN_STEPS)
    for run in kernels.values():
        run.launches = 0
    steps, secs = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, i)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        steps.append({k: float(v) for k, v in m.items()})
        log(f"train step {i}: loss {steps[-1]['loss']:.5f} grad_norm "
            f"{steps[-1]['grad_norm']:.4f} lr {steps[-1]['lr']:.3e} "
            f"{secs[-1] * 1e3:.1f} ms")
    launches = {name: run.launches for name, run in kernels.items()}
    per_step = {name: n / TRAIN_STEPS for name, n in launches.items()}
    if per_step != want:
        fail(f"phase 20 launches a step {per_step}, expected {want}")
    bad = [s for s in steps
           if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    if bad:
        fail(f"phase 20: non-finite loss or gradient norm {bad}")
    peak = (torch.cuda.max_memory_allocated() - base_mem) / gib
    step_s = statistics.median(secs[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else cfg.vocab_size * cfg.d_model)
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    model_flops = (6 * n_matmul * tokens
                   + 12 * TRAIN_BATCH * cfg.n_heads * cfg.hd * pairs * L)
    share = model_flops / step_s / H100_BF16_FLOPS
    # one more step traced (its launches outside the counts above)
    batch = data.batch(TRAIN_STEPS, "cuda")
    t0 = time.perf_counter()
    state = {}

    def traced():
        state["out"] = step_fn(params, opt, batch, TRAIN_STEPS)

    torch.cuda.synchronize()
    trace = _profile_step(torch, traced, step_s)
    params, opt, _ = state.pop("out")
    log(f"phase 20 traced step ({time.perf_counter() - t0:.1f} s under the "
        f"profiler): {trace}")
    if not (trace["b4_ms"] > 0 and trace["b5_ms"] > 0):
        fail(f"phase 20 traced step: no B4 / B5 time among the traced "
             f"kernels ({trace['b4_ms']} / {trace['b5_ms']} ms)")
    if probe is not None:
        params, opt = probe(params, opt, step_fn, data, state_bytes, step_s)
    del params, opt, batch
    # the reference: the attention patched to the plain versions, for unit
    # 0's attention gradients on micro-batch 0 and for step 0 from the same
    # weights and a fresh optimizer state
    runs = flash_fwd.run, flash_bwd.run

    def plain_fwd(q, k, v, causal=True, softcap=0.0, stats=False,
                  q_base=0):
        f = flash_fwd.plain_stats if stats else flash_fwd.plain
        return f(q, k, v, causal, softcap, q_base=q_base)

    def plain_bwd(q, k, v, o, m, l, do, causal=True, softcap=0.0,
                  q_base=0):
        return flash_bwd.plain(q, k, v, o, m, l, do, causal, softcap,
                               q_base=q_base)

    batch0 = data.batch(0, "cuda")
    attn = p0["units"]["pos0"]["attn"]
    names = ("wq", "wk", "wv")

    def attn_grads():       # unit 0's, on micro-batch 0, f32
        rows = slice(0, TRAIN_BATCH // A)
        for n in names:
            attn[n].requires_grad_(True)
        loss, _ = M.loss_fn(p0, cfg, batch0["tokens"][rows],
                            batch0["labels"][rows], remat=True)
        grads = torch.autograd.grad(loss, [attn[n] for n in names])
        return {n: g[0].float() for n, g in zip(names, grads)}

    g_kern = attn_grads()
    flash_fwd.run, flash_bwd.run = plain_fwd, plain_bwd
    try:
        g_plain = attn_grads()
        t0 = time.perf_counter()
        _, _, m_ref = step_fn(p0, adamw_init(p0), data.batch(0, "cuda"), 0)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    finally:
        flash_fwd.run, flash_bwd.run = runs
    del p0
    gaps = {k: abs(steps[0][k] - float(m_ref[k])) / abs(float(m_ref[k]))
            for k in ("loss", "grad_norm")}
    grad_gaps = {n: float((g_kern[n] - g_plain[n]).abs().max()
                          / g_plain[n].abs().max()) for n in names}
    del g_kern, g_plain
    log(f"phase 20 unit 0's attention gradients on micro-batch 0 against "
        f"the plain attention: max |diff| / max |plain| "
        f"{ {n: f'{v:.2e}' for n, v in grad_gaps.items()} } (tol "
        f"{TRAIN_GRAD_TOL})")
    if not all(v <= TRAIN_GRAD_TOL for v in grad_gaps.values()):
        fail(f"phase 20: unit 0's attention gradients off the plain "
             f"attention's: {grad_gaps}")
    log(f"phase 20 step 0 against the plain attention: loss "
        f"{steps[0]['loss']:.6f} vs {float(m_ref['loss']):.6f} (gap "
        f"{gaps['loss']:.2e}, tol 5e-3), grad_norm "
        f"{steps[0]['grad_norm']:.5f} vs "
        f"{float(m_ref['grad_norm']):.5f} (gap {gaps['grad_norm']:.2e}, tol "
        f"2e-2); the plain step took {ref_s:.1f} s")
    if not (gaps["loss"] <= 5e-3 and gaps["grad_norm"] <= 2e-2):
        fail(f"phase 20: step 0 off the plain attention's: {gaps}")
    out = dict(layers=L, params_b=n_params / 1e9, steps=steps,
               step_ms=[s * 1e3 for s in secs], median_step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s, model_tflop=model_flops / 1e12,
               flop_share=share, peak_gib=peak, gaps=gaps,
               attn_grad_gaps=grad_gaps,
               launches_per_step=per_step, trace=trace)
    log(f"phase 20: {n_params / 1e9:.3f} B parameters; step (median of steps"
        f" 1-{TRAIN_STEPS - 1}) {step_s * 1e3:.1f} ms, {tokens / step_s:.0f} "
        f"tokens/s, model FLOPs {model_flops / 1e12:.1f} T a step = "
        f"{100 * share:.1f} % of 989 TFLOP/s; peak device memory {peak:.2f} "
        f"GiB; launches {launches}")
    return out, launches


def dryrun_phase(torch, cfg, kernels, params, opt, step_fn, data,
                 state_bytes: int, step_s: float) -> tuple:
    """Phase 27 (module docstring) on phase 20's state -> (measurements,
    the updated params, opt).  ``kernels`` as :func:`train_phase` takes
    them; ``step_s`` is phase 20's median step."""
    from repro_torch.analysis import op_cost, roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import iter_leaves
    L, A = cfg.n_layers, TRAIN_ACCUM
    want = {"ecf8_decode": 0, "fused_decode_matmul": 0, "kv_page_decode": 0,
            "flash_fwd": 2 * L * A, "flash_bwd": L * A}
    i = TRAIN_STEPS + 1
    batch = data.batch(i, "cuda")
    t0 = time.perf_counter()
    with dryrun.fake_mode():
        fake = dryrun.fake_like((params, opt, batch))
        cost, mem, _ = dryrun.trace(step_fn, (*fake, i))
    trace_s = time.perf_counter() - t0
    pred_state = sum(x.numel() * x.element_size() for tree in fake[:2]
                     for _, x in iter_leaves(tree))
    del fake
    # the same step on the card under the same counter, then once without
    before = {name: run.launches for name, run in kernels.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with op_cost.OpCost() as counter:
        params, opt, _ = step_fn(params, opt, batch, i)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - alloc0
    launched = {name: run.launches - before[name]
                for name, run in kernels.items()}
    card = counter.result()
    batch = data.batch(i + 1, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, _ = step_fn(params, opt, batch, i + 1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del batch
    shape = ShapeConfig("phase20", "train", TRAIN_SEQ, TRAIN_BATCH)
    cost_d = {"flops": cost["flops"], "bytes accessed": cost["bytes"]}
    roof = roofline.roofline_terms(cost_d, cost["coll"], 1, cfg, shape)
    flop_gap = abs(card["flops"] - cost["flops"]) / cost["flops"]
    state_gap = abs(pred_state - state_bytes) / state_bytes
    out = dict(
        gpu=gpu_line(), trace_s=trace_s, traced_flops=cost["flops"],
        card_flops=card["flops"], flop_gap=flop_gap,
        traced_bytes=cost["bytes"], card_bytes=card["bytes"],
        kernels_traced=cost["kernels"], launches=launched,
        predicted_state_bytes=pred_state, state_bytes=state_bytes,
        state_gap=state_gap,
        predicted_peak_bytes=mem["peak_bytes"] - mem[
            "argument_size_in_bytes"], card_peak_bytes=peak,
        argument_bytes=mem["argument_size_in_bytes"],
        step_ms=step_s * 1e3, counted_step_ms=counted_s * 1e3,
        uncounted_step_ms=plain_s * 1e3,
        counter_cost=(counted_s - plain_s) / plain_s,
        traced_flop_share=cost["flops"] / step_s / H100_BF16_FLOPS,
        model_flops=roof["model_flops"],
        model_flop_share=roof["model_flops"] / step_s / H100_BF16_FLOPS,
        useful_flops_ratio=roof["useful_flops_ratio"],
        bound_ms=roof["step_time_bound"] * 1e3, bound_by=roof["dominant"],
        bound_over_step=roof["step_time_bound"] / step_s)
    log(f"phase 27 ({out['gpu']}): the dry run's trace of phase 20's step "
        f"({trace_s:.1f} s on fake tensors) against the step on the card "
        f"under the same counter: FLOPs {cost['flops']:.6e} vs "
        f"{card['flops']:.6e} (gap {flop_gap:.2e}, tol 1e-3); parameters + "
        f"AdamW state predicted {pred_state} B vs the rise in "
        f"memory_allocated {state_bytes} B (gap {state_gap:.2e}, tol "
        f"1e-2); the step's peak above its arguments predicted "
        f"{out['predicted_peak_bytes'] / 2 ** 30:.2f} GiB vs "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; launches "
        f"{launched} (expected {want})")
    log(f"phase 27: step {step_s * 1e3:.1f} ms (phase 20's median), "
        f"{counted_s * 1e3:.1f} ms under the counter vs {plain_s * 1e3:.1f}"
        f" ms without (host cost {100 * out['counter_cost']:.1f} %); traced"
        f" FLOPs {100 * out['traced_flop_share']:.1f} % and model FLOPs "
        f"(6ND, roofline.model_flops) {100 * out['model_flop_share']:.1f} %"
        f" of 989 TFLOP/s, useful share {roof['useful_flops_ratio']:.3f}; "
        f"the dry run's bound {roof['step_time_bound'] * 1e3:.1f} ms "
        f"({roof['dominant']}) = {100 * out['bound_over_step']:.1f} % of "
        f"the measured step")
    problems = []
    if flop_gap > 1e-3:
        problems.append(f"traced FLOPs off the card step's by {flop_gap:.2e}")
    if state_gap > 1e-2:
        problems.append(f"predicted state bytes off by {state_gap:.2e}")
    if launched != want:
        problems.append(f"launches {launched}, expected {want}")
    if cost["kernels"] != {"flash_fwd": want["flash_fwd"],
                           "flash_bwd": want["flash_bwd"]}:
        problems.append(f"the trace counted kernels {cost['kernels']}")
    if problems:
        fail("phase 27: " + "; ".join(problems))
    return out, params, opt


def cfg_train(cfg_full, layers: int):
    """qwen3-8b at ``layers`` layers as phases 20 and 20b train it: the
    published Qwen3-8B unembeds with its own matrix (tie_word_embeddings
    false); the registry's serving config ties."""
    return dataclasses.replace(cfg_full, n_layers=layers,
                               tie_embeddings=False)


def train_and_dryrun(torch, M, runs, cfg, seed) -> tuple:
    """Phase 20 on ``cfg`` with phase 27 on its trained state -> (phase 20's
    measurements, its launches, phase 27's measurements)."""
    dry = {}

    def probe(params, opt, step_fn, data, state_bytes, step_s):
        t0 = time.perf_counter()
        out, params, opt = dryrun_phase(torch, cfg, runs, params, opt,
                                        step_fn, data, state_bytes, step_s)
        dry.update(out, seconds=time.perf_counter() - t0)
        log(f"phase 27 took {dry['seconds']:.1f} s")
        return params, opt

    out, launches = train_phase(torch, M, runs, cfg, seed, probe=probe)
    return out, launches, dry


def ckpt_phase(torch, M, serve, kernels, cfg, seed):
    """Phase 20b (module docstring) on ``cfg`` -> (measurements, B1
    launches of the ECF8 restore)."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager, restore_tree
    from repro_torch.checkpoint import save_tree
    from repro_torch.core import fp8 as fp8_mod
    from repro_torch.core.store import torch_dtype
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves
    from repro_torch.runtime.steps import make_train_step
    b1 = kernels["ecf8_decode"]
    root = ROOT / "build" / "ckpt_drill"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    params = M.init_params(cfg, seed, device="cuda",
                           dtype=torch_dtype(cfg.dtype))
    n_params = sum(p.numel() for _, p in iter_leaves(params))
    need = n_params * (2 + 4 + 4) + n_params       # state + fp8 tree
    free = shutil.disk_usage(root).free
    log(f"phase 20b: {cfg.name} at {cfg.n_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters; free disk under {root}: "
        f"{free / 1e9:.1f} GB, the drill writes up to {need / 1e9:.1f} GB")
    if free < 1.1 * need:
        fail(f"phase 20b: {free / 1e9:.1f} GB free under {root}, the "
             f"checkpoints need {need / 1e9:.1f} GB")
    opt = adamw_init(params)
    data = SyntheticLMData(DataConfig(cfg.vocab_size, TRAIN_SEQ,
                                      TRAIN_BATCH, seed))
    step_fn = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR),
                              grad_accum=TRAIN_ACCUM, remat=True,
                              warmup_steps=1, total_steps=4)
    for i in range(3):
        params, opt, m = step_fn(params, opt, data.batch(i, "cuda"), i)
    live = {"params": params, "opt": opt,
            "step": torch.tensor(2, dtype=torch.int32)}
    mgr = CheckpointManager(str(root / "train"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save_async(2, live)
    snap_s = time.perf_counter() - t0
    mgr.wait()
    save_s = time.perf_counter() - t0
    mgr.close()
    disk = sum(f.stat().st_size for f in (root / "train").rglob("*")
               if f.is_file())
    t0 = time.perf_counter()
    restored, at = restore_tree(str(root / "train"), live, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if at != 2:
        fail(f"phase 20b: restored step {at}, expected 2")
    flat_live, flat_got = dict(iter_leaves(live)), dict(iter_leaves(restored))
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    for path, want in flat_live.items():
        got = flat_got[path]
        if (got.dtype != want.dtype or got.shape != want.shape
                or not torch.equal(got.cpu().view(ints[got.element_size()]),
                                   want.cpu().view(
                                       ints[want.element_size()]))):
            fail(f"phase 20b: restored leaf {'/'.join(path)} differs")
    batch = data.batch(3, "cuda")
    _, _, m_live = step_fn(params, opt, batch, 3)
    _, _, m_back = step_fn(restored["params"], restored["opt"], batch, 3)
    l_live, l_back = float(m_live["loss"]), float(m_back["loss"])
    gap = abs(l_back - l_live) / abs(l_live)
    bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        iter_leaves(params), iter_leaves(restored["params"])))
    log(f"phase 20b: {len(flat_live)} leaves restored bit-identical (CRCs "
        f"verified); step 3 loss live {l_live:.6f}, restored {l_back:.6f} "
        f"(gap {gap:.2e}, tol 1e-3); weights after step 3 bitwise equal: "
        f"{bitwise}; save {save_s:.1f} s (snapshot {snap_s:.1f} s), "
        f"{disk / 1e9:.2f} GB on disk, restore {restore_s:.1f} s")
    if not gap <= 1e-3:
        fail(f"phase 20b: step 3 from the restored state off by {gap}")
    del params, opt, live, restored, flat_live, flat_got, m_live, m_back
    # the fp8 serving tree, ECF8 on disk, restored through B1
    _, base, _, _ = serve.build_params(cfg, seed, "none", device="cuda")
    fp8_leaves = [t for _, t in iter_leaves(base)
                  if t.dtype == fp8_mod.FP8_DTYPE]
    fp8_bytes = sum(t.numel() for t in fp8_leaves)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_tree(base, str(root / "ecf8"), 0, compress="ecf8")
    ecf8_save_s = time.perf_counter() - t0
    ecf8_disk = sum(f.stat().st_size for f in (root / "ecf8").rglob(
        "ecf8_*.npz"))
    b1.launches = 0
    t0 = time.perf_counter()
    back, _ = restore_tree(str(root / "ecf8"), base, device="cuda")
    torch.cuda.synchronize()
    ecf8_restore_s = time.perf_counter() - t0
    launches_b1 = b1.launches
    if launches_b1 != len(fp8_leaves):
        fail(f"phase 20b: {launches_b1} B1 launches restoring "
             f"{len(fp8_leaves)} ECF8 leaves")
    for (path, want), (_, got) in zip(iter_leaves(base), iter_leaves(back)):
        same = got.dtype == want.dtype and torch.equal(
            got.view(torch.uint8), want.view(torch.uint8)) \
            if want.dtype == fp8_mod.FP8_DTYPE else torch.equal(got, want)
        if not same:
            fail(f"phase 20b: ECF8-restored leaf {'/'.join(path)} differs")
    log(f"phase 20b: fp8 tree ({len(fp8_leaves)} fp8 leaves, "
        f"{fp8_bytes / 1e9:.3f} GB) saved ECF8 in {ecf8_save_s:.1f} s: "
        f"{ecf8_disk / 1e9:.3f} GB of containers "
        f"({100 * ecf8_disk / fp8_bytes:.2f} % of raw fp8), restored "
        f"through B1 ({launches_b1} launches) in {ecf8_restore_s:.1f} s, "
        f"bits identical")
    del base, back
    shutil.rmtree(root, ignore_errors=True)
    return dict(params_b=n_params / 1e9, free_gb=free / 1e9,
                save_s=save_s, snapshot_s=snap_s, restore_s=restore_s,
                disk_gb=disk / 1e9, loss_gap=gap, bitwise_step3=bitwise,
                ecf8_save_s=ecf8_save_s, ecf8_restore_s=ecf8_restore_s,
                ecf8_gb=ecf8_disk / 1e9, fp8_gb=fp8_bytes / 1e9,
                ecf8_pct_of_fp8=100 * ecf8_disk / fp8_bytes), launches_b1


def check_kv_pages(torch, ops, kv, codec, name, pages, stride, flush, reps,
                   n_empty=0):
    """The page-decode kernel vs its plain version on host-coded pages
    (payloads zero-padded to ``stride``, ``n_empty`` never-written slots
    appended) -> result dict."""
    import numpy as np
    dt_name = codec.dtype_name(pages[0].dtype)
    bits_t = codec.TORCH_BITS[dt_name]
    n = pages[0].numel()
    t0 = time.perf_counter()
    cps = [codec.encode_page(p) for p in pages]
    enc_s = time.perf_counter() - t0
    stride = max([stride] + [c.stride for c in cps])
    N = len(cps) + n_empty
    pay = np.zeros((N, stride, codec.LANES), np.uint8)
    sm = np.zeros((N, cps[0].signmant.size), np.uint8)
    tab = np.zeros((N,) + cps[0].tables().shape, np.int32)
    perm = np.zeros((N, cps[0].perm.size), np.int32)
    for i, c in enumerate(cps):
        pay[i, : c.stride], sm[i], tab[i], perm[i] = (
            c.payload, c.signmant, c.tables(), c.perm)
    args = [torch.from_numpy(a).cuda() for a in (pay, sm, tab, perm)]
    kw = dict(n_elem=n, dtype_name=dt_name)
    got = ops.decode_pages(*args, **kw)
    want = kv.plain(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got.view(bits_t), want.view(bits_t)):
        bad = int((got.view(bits_t) != want.view(bits_t)).sum())
        fail(f"kv_page_decode {name}: kernel differs from the plain version "
             f"at {bad} of {got.numel()} elements")
    for i, p in enumerate(pages):
        if not torch.equal(got[i].view(bits_t), p.reshape(-1).view(bits_t)):
            fail(f"kv_page_decode {name}: page {i} is not lossless")
    moved = sum(t.numel() * t.element_size() for t in args + [got])
    ms = cuda_ms(torch, lambda: kv.run(*args, **kw), reps, flush)
    plain_ms = cuda_ms(torch, lambda: kv.plain(*args, **kw), 2, flush)
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    ratio = sum(c.ratio() for c in cps) / len(cps)
    log(f"kv_page_decode {name}: {N} pages x {n} {dt_name} (stride {stride},"
        f" {n_empty} empty), bit-exact, coded/raw {ratio:.3f}, host encode "
        f"{enc_s:.2f}s, kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
        f"{bound_ms:.4f} ms ({moved / 1e6:.2f} MB), "
        f"{moved / ms / 1e6:.1f} GB/s")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None)


def check_fused(torch, fused, run, ecf8_decode, fp8, name, bits, tiled,
                container, M, flush, gen):
    """Kernel 2 through its op ``run`` (``ops.fused_decode_matmul``: one
    launch a row block of at most 512) vs its plain version at one weight
    and M -> result dict, with the yardsticks: what the serve path pays
    for the same product (``ecf8_decode`` writing bf16, as
    ``store.materialize`` asks it, then torch.matmul), that decode alone,
    and torch.matmul alone on the materialised bf16 weight."""
    K, N = tiled.k, tiled.n
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    got = run(x, tiled)
    want = fused.plain(x, tiled)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail(f"fused_decode_matmul {name} M={M}: non-finite output")
    err = float((got - want).abs().max() / want.abs().max())
    if err > FUSED_TOL:
        fail(f"fused_decode_matmul {name} M={M}: max |kernel - plain| / max "
             f"|plain| = {err} > {FUSED_TOL}")
    if not torch.equal(run(x, tiled), got):
        fail(f"fused_decode_matmul {name} M={M}: two launches differ")
    c = container
    args = (c.payload, c.signmant, c.lj_limit, c.first_lj, c.offset, c.perm)
    kw = dict(sym_per_lane=c.sym_per_lane, n_elem=c.n_elem)
    w_bf16 = bits.view(fp8.FP8_DTYPE).to(torch.bfloat16)

    def decode():
        return ecf8_decode.run(*args, **kw, out_dtype=torch.bfloat16)

    def serve_path():
        return x @ decode().reshape(K, N)

    ms = cuda_ms(torch, lambda: run(x, tiled), 10, flush)
    plain_ms = cuda_ms(torch, lambda: fused.plain(x, tiled), 1, flush)
    serve_ms = cuda_ms(torch, serve_path, 10, flush)
    decode_ms = cuda_ms(torch, decode, 10, flush)
    lib_ms = cuda_ms(torch, lambda: x @ w_bf16, 10, flush)
    moved = (tiled.nbytes + x.numel() * x.element_size() + M * N * 4)
    flops = 2 * M * K * N
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    by = "operations" if bound_ops >= bound_bytes else "bytes"
    log(f"fused_decode_matmul {name} ({K}x{N}) M={M}: max |kernel - plain| / "
        f"max |plain| {err:.2e} (tol {FUSED_TOL:g}), two launches equal, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} "
        f"ms ({by}; {moved / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), serve "
        f"path ecf8_decode (bf16) + matmul {serve_ms:.4f} ms (kernel / "
        f"serve path {ms / serve_ms:.2f}), ecf8_decode (bf16) alone "
        f"{decode_ms:.4f} ms, torch.matmul on bf16 W {lib_ms:.4f} ms; "
        f"{moved / ms / 1e6:.1f} GB/s, {flops / ms / 1e9:.2f} TFLOP/s")
    return dict(max_abs_err=float((got - want).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                library_ms=lib_ms, serve_path_ms=serve_ms,
                decode_bf16_ms=decode_ms)


def check_small_chunked(torch, M, paged, small, p_cpu, p_gpu, toks, whole):
    """Chunked prefill of one prompt of the small f32 model, pages going
    cold between chunks, on the card and the CPU -> (max |dlogit| card vs
    CPU, max |dlogit| card chunked vs the card's whole-prompt prefill)."""
    C = 16
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        pc = paged.PagedKVCache(small, 1, 64, dtype=torch.float32,
                                device=dev, page_size=4, compress_cold=True)
        cache = pc.admit_slot(pc.init_cache(), 0, pc.pages_for_prefix(C))
        prompt = toks[0].tolist()
        for lo in range(0, len(prompt), C):
            part = prompt[lo:lo + C]
            cache = pc.ensure(cache, 0, lo + len(part) - 1)
            chunk = torch.tensor([part + [0] * (C - len(part))], device=dev)
            logits, _ = M.prefill_chunk(params, small, chunk, cache, 0,
                                        len(part))
            cache = pc.compress_cold_pages(cache, 0, lo + len(part))
        if not pc.n_compressed:
            fail("small chunked prefill: no page went cold")
        out[dev] = logits.cpu()
    return (float((out["cuda"] - out["cpu"]).abs().max()),
            float((out["cuda"] - whole.cpu()).abs().max()))


def first_divergence(a, b):
    """(tokens equal, [(request, first differing index)]) of two runs."""
    same = sum(x == y for r, q in zip(a, b)
               for x, y in zip(r.out_tokens, q.out_tokens))
    bad = [(i, next(j for j, (x, y) in enumerate(
                zip(r.out_tokens, q.out_tokens)) if x != y))
           for i, (r, q) in enumerate(zip(a, b))
           if r.out_tokens != q.out_tokens]
    return same, bad


def check_small_paged(torch, M, paged, small, p_cpu, p_gpu, seed,
                      steps=6):
    """``steps`` paged-compressed decode steps of the small model on the
    card vs the CPU, with cold pages decoded in the step -> max |dlogit|."""
    gen = torch.Generator().manual_seed(seed)
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        pc = paged.PagedKVCache(small, 2, 64, dtype=torch.float32,
                                device=dev, page_size=4, compress_cold=True)
        cache = pc.init_cache()
        lens = [23, 9]
        for slot, T in enumerate(lens):
            toks = torch.arange(1, T + 1)[None] * (slot + 3) % 500
            _, frag = M.prefill(params, small, toks.to(dev), max_len=64)
            cache = pc.admit(cache, slot, frag, T)
            cache = pc.compress_cold_pages(cache, slot, T)
        out = []
        tok = torch.tensor([[5], [7]], device=dev)
        for _ in range(steps):
            for slot in range(2):
                cache = pc.ensure(cache, slot, lens[slot])
            logits, cache = M.decode_step(params, small, tok, cache)
            out.append(logits.cpu())
            for slot in range(2):
                lens[slot] += 1
                cache = pc.compress_cold_pages(cache, slot, lens[slot])
            tok = (tok * 13 + 1) % small.vocab_size
        runs[dev] = (out, pc)
    if not runs["cuda"][1].n_compressed or not runs["cpu"][1].has_cold:
        fail("small paged-compressed run: no page went cold")
    return max(float((a - b).abs().max())
               for a, b in zip(runs["cpu"][0], runs["cuda"][0]))


def small_serving(torch, serving, small, params, dparams):
    """The small f32 model served by the engine on the card over the
    monolithic and the paged cache, with a draft (k = 1 and 4) and, k = 4,
    under page pressure (a 10-page pool, the swap tier, one forced
    preemption) -> (tokens of each run by name, the pressure run's
    engine).  The workload is tests/test_speculative.py's."""
    runs = {}

    def run(name, **kw):
        eng = serving.GenerationEngine(params, small, config=serving
                                       .EngineConfig(max_batch=2, max_len=64,
                                                     page_size=4, **kw))
        reqs = [serving.Request(prompt=[i + 1] * (6 + 3 * i),
                                max_new_tokens=10 + i, priority=i % 2,
                                id=41_000 + i) for i in range(6)]
        for r in reqs:
            eng.submit(r)
        if kw.get("swap_bytes"):
            for _ in range(4):
                eng.step()
            busy = [s for s in range(2) if eng.slots[s] is not None]
            if not busy or not eng._preempt(busy[0]):
                fail("small pressure run: the forced preemption failed")
        eng.run()
        if not all(r.done for r in reqs):
            fail(f"small {name} run: unfinished requests")
        runs[name] = [r.out_tokens for r in reqs]
        return eng

    spec = dict(draft_cfg=small, draft_params=dparams)
    run("paged")
    run("monolithic", cache_mode="monolithic")
    run("spec k=1", spec_k=1, **spec)
    run("spec k=4", spec_k=4, **spec)
    eng = run("spec k=4, pressure", spec_k=4, n_pages=10, swap_bytes=-1,
              **spec)
    return runs, eng


def small_moe_checks(torch, M, moe, paged, store, smoke_variant, get, seed,
                     ecf8_decode):
    """Phase 4's MoE, MLP-type, gemma2 and llama4 models (ECF8 at the
    smoke threshold, f32): the card's logits against the CPU's, the MoE
    layer bit-equal over two runs on the card, and gemma2's and llama4's
    local rings (window 32) at a prompt longer than the window and over
    decode steps past their wrap; then llama4's from an ECF8-FR tree, with
    no launch of the ECF8 decode kernel."""
    toks = torch.randint(0, 512, (2, 37), generator=torch.Generator()
                         .manual_seed(seed))

    def small(arch, **kw):
        # the smoke variant with heads of 64 (the flash kernel's smallest)
        return dataclasses.replace(smoke_variant(get(arch)), head_dim=64,
                                   **kw)

    for arch, cfg in ((MOE_ARCH, small(MOE_ARCH, capacity_factor=1.25)),
                      ("granite-20b", small("granite-20b")),
                      ("nemotron-4-15b", small("nemotron-4-15b")),
                      (GEMMA_ARCH, small(GEMMA_ARCH)),
                      (LLAMA_ARCH, small(LLAMA_ARCH))):
        p_cpu, _ = store.compress_tree(M.init_params(cfg, seed, "cpu"),
                                       min_elems=4096, out_dtype="float32")
        p_gpu = to_device(p_cpu, "cuda", store)
        l_cpu, _ = M.prefill(p_cpu, cfg, toks, max_len=64)
        l_gpu, _ = M.prefill(p_gpu, cfg, toks.cuda(), max_len=64)
        err = float((l_gpu.cpu() - l_cpu).abs().max())
        if not bool(torch.isfinite(l_gpu).all()) or err > 1e-4:
            fail(f"small f32 {arch}: prefill card vs CPU max |dlogit| = "
                 f"{err}")
        traits = f"{cfg.mlp_type}, {cfg.n_kv_heads} KV heads"
        if cfg.n_experts:
            traits += (f", {cfg.n_experts} experts top-{cfg.top_k}, "
                       f"capacity factor {cfg.capacity_factor}")
        if "local" in cfg.pattern:
            traits += (f", pattern {cfg.pattern}, window {cfg.local_window}"
                       f" < prompt {toks.shape[1]}")
        line = (f"small f32 {arch} ({traits}): prefill logits card vs CPU "
                f"max |diff| {err:.2e}")
        if "local" in cfg.pattern:
            # prompts of 23 and 9 tokens, 16 steps: the 23-token slot's
            # rings wrap at position 32
            err = check_small_paged(torch, M, paged, cfg, p_cpu, p_gpu, seed,
                                    steps=16)
            if err > 1e-4:
                fail(f"small f32 {arch}: paged-compressed decode past the "
                     f"ring's wrap, card vs CPU max |dlogit| = {err}")
            line += f", paged-compressed decode past the ring's wrap {err:.2e}"
        if cfg.n_experts:
            err = check_small_paged(torch, M, paged, cfg, p_cpu, p_gpu, seed)
            if err > 1e-4:
                fail(f"small f32 {arch}: paged-compressed decode card vs "
                     f"CPU max |dlogit| = {err}")
            line += f", paged-compressed decode {err:.2e}"
            T = toks.numel()
            cap = max(8, int(T * cfg.top_k * cfg.capacity_factor
                             / cfg.n_experts + 0.999))
            x = torch.randn((2, 37, cfg.d_model), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed))
            layer = M._layer(p_gpu["units"]["pos0"], 0)["moe"]
            for dt in (torch.float32, torch.bfloat16):
                y1, _ = moe.moe_apply(layer, x.to(dt), cfg, dtype=dt)
                y2, _ = moe.moe_apply(layer, x.to(dt), cfg, dtype=dt)
                if not torch.equal(y1, y2):
                    fail(f"small {arch}: two MoE layer runs on the card "
                         f"differ in {dt}")
            line += (f"; the MoE layer (B*T = {T}, capacity {cap}) "
                     f"bit-equal over two card runs in f32 and bf16")
        log(line + " (tol 1e-4)")
    # llama4's stack from ECF8-FR weights: decoded on the card by plain
    # PyTorch, so the ECF8 decode kernel must not launch
    cfg = small(LLAMA_ARCH)
    p_cpu, _ = store.compress_tree(M.init_params(cfg, seed, "cpu"),
                                   fmt="fixedrate", min_elems=4096,
                                   out_dtype="float32")
    p_gpu = to_device(p_cpu, "cuda", store)
    before = ecf8_decode.run.launches
    l_cpu, _ = M.prefill(p_cpu, cfg, toks, max_len=64)
    l_gpu, _ = M.prefill(p_gpu, cfg, toks.cuda(), max_len=64)
    err = float((l_gpu.cpu() - l_cpu).abs().max())
    err_d = check_small_paged(torch, M, paged, cfg, p_cpu, p_gpu, seed,
                              steps=16)
    if (not bool(torch.isfinite(l_gpu).all()) or max(err, err_d) > 1e-4
            or ecf8_decode.run.launches != before):
        fail(f"small f32 {LLAMA_ARCH} from ECF8-FR: prefill card vs CPU max "
             f"|dlogit| = {err}, decode past the wrap {err_d}, ECF8 decode "
             f"launches {ecf8_decode.run.launches - before}")
    log(f"small f32 {LLAMA_ARCH} from ECF8-FR weights: prefill logits card "
        f"vs CPU max |diff| {err:.2e}, paged-compressed decode past the "
        f"ring's wrap {err_d:.2e} (tol 1e-4), 0 ECF8 decode launches")


def small_recurrent_checks(torch, M, store, smoke_variant, get, seed):
    """Phase 4's recurrent models, f32, every recurrent matrix compressed
    (``min_elems`` 256, so B1 decodes them): recurrentgemma's smoke stack at
    8 layers (2 units + 2 tail RG-LRU layers; heads of 64, B4's smallest)
    at prompts of 20 tokens (B4 in the local layers) and 45 (past the
    window of 32: local_attention, a rolled ring), xlstm's at 5 layers (a
    tail sLSTM) at 64 tokens (one mLSTM chunk): prefill logits and 6 decode
    steps, the card against the CPU within 1e-4."""
    for arch, n, lens in ((RG_ARCH, 8, (20, 45)), (XLSTM_ARCH, 5, (64,))):
        cfg = dataclasses.replace(smoke_variant(get(arch)), n_layers=n,
                                  head_dim=64 if arch == RG_ARCH else 0)
        p_cpu, _ = store.compress_tree(M.init_params(cfg, seed, "cpu"),
                                       min_elems=256, out_dtype="float32")
        p_gpu = to_device(p_cpu, "cuda", store)
        errs = []
        for T in lens:
            toks = torch.randint(0, cfg.vocab_size, (2, T),
                                 generator=torch.Generator().manual_seed(T))
            l_cpu, c_cpu = M.prefill(p_cpu, cfg, toks, max_len=64)
            l_gpu, c_gpu = M.prefill(p_gpu, cfg, toks.cuda(), max_len=64)
            err = float((l_gpu.cpu() - l_cpu).abs().max())
            for _ in range(6):
                tok = l_cpu[:, -1].argmax(-1, keepdim=True)
                l_cpu, c_cpu = M.decode_step(p_cpu, cfg, tok, c_cpu)
                l_gpu, c_gpu = M.decode_step(p_gpu, cfg, tok.cuda(), c_gpu)
                err = max(err, float((l_gpu.cpu() - l_cpu).abs().max()))
            if not bool(torch.isfinite(l_gpu).all()) or err > 1e-4:
                fail(f"small f32 {arch}, T={T}: card vs CPU max |dlogit| = "
                     f"{err}")
            errs.append(err)
        log(f"small f32 {arch} (pattern {cfg.pattern}, {cfg.n_layers} layers"
            f" with a tail of {cfg.n_layers % cfg.unit}): prefill at "
            f"{lens} tokens and 6 decode steps, card vs CPU max |dlogit| "
            f"{max(errs):.2e} (tol 1e-4)")


def small_whisper_check(torch, M, store, smoke_variant, get, seed):
    """Phase 4's encoder-decoder: whisper's smoke variant with heads of 64
    (B4's smallest) and 64 frames, f32, every matrix compressed
    (``min_elems`` 256): the encoder output, the prefill logits (B4
    non-causal in the encoder and the cross attention, causal in the
    decoder) and 6 decode steps over the cached cross K/V, the card against
    the CPU within 1e-4."""
    cfg = dataclasses.replace(smoke_variant(get(WHISPER_ARCH)), head_dim=64,
                              encoder_frames=64)
    p_cpu, _ = store.compress_tree(M.init_params(cfg, seed, "cpu"),
                                   min_elems=256, out_dtype="float32")
    p_gpu = to_device(p_cpu, "cuda", store)
    gen = torch.Generator().manual_seed(seed)
    frames = torch.randn((2, cfg.encoder_frames, cfg.d_model), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    e_cpu = M.encode_frames(p_cpu, cfg, frames, torch.float32)
    e_gpu = M.encode_frames(p_gpu, cfg, frames.cuda(), torch.float32)
    err_enc = float((e_gpu.cpu() - e_cpu).abs().max())
    l_cpu, c_cpu = M.prefill(p_cpu, cfg, toks, max_len=32, frames=frames)
    l_gpu, c_gpu = M.prefill(p_gpu, cfg, toks.cuda(), max_len=32,
                             frames=frames.cuda())
    err = float((l_gpu.cpu() - l_cpu).abs().max())
    for _ in range(6):
        tok = l_cpu[:, -1].argmax(-1, keepdim=True)
        l_cpu, c_cpu = M.decode_step(p_cpu, cfg, tok, c_cpu)
        l_gpu, c_gpu = M.decode_step(p_gpu, cfg, tok.cuda(), c_gpu)
        err = max(err, float((l_gpu.cpu() - l_cpu).abs().max()))
    if not bool(torch.isfinite(l_gpu).all()) or max(err, err_enc) > 1e-4:
        fail(f"small f32 {WHISPER_ARCH}: card vs CPU max |d encoder| = "
             f"{err_enc}, max |dlogit| = {err}")
    log(f"small f32 {WHISPER_ARCH} ({cfg.n_encoder_layers} + {cfg.n_layers}"
        f" layers, {cfg.n_heads} heads of {cfg.hd}, {cfg.encoder_frames} "
        f"frames): encoder output card vs CPU max |diff| {err_enc:.2e}, "
        f"prefill logits and 6 decode steps max |dlogit| {err:.2e} (tol "
        f"1e-4)")


def whisper_phase(torch, np, serve, M, kernels, cfg, seed):
    """Phase 18 (module docstring) on ``cfg`` -> (measurements, launches
    by run).  ``kernels`` maps name -> wrapper (``run``) whose launch
    counts the phase reads."""
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    gib = 2 ** 30
    # B1 from ECF8 weights (every matrix is compressed at serve.MIN_ELEMS):
    # a prefill decodes pos_embed, the encoder layers' six matrices, the
    # decoder layers' self attention (4), cross attention (4: the K/V
    # projections once, for the layer and the cache) and MLP (2), the
    # embedding and the unembedding; a decode step uses no encoder weight
    # and no cross wk / wv
    b1_prefill = 1 + 6 * cfg.n_encoder_layers + 10 * cfg.n_layers + 2
    b1_step = 8 * cfg.n_layers + 2
    # B4 a prefill: each encoder layer (non-causal), each decoder layer's
    # self attention (causal) and cross attention (non-causal); none a step
    b4_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    log(f"phase 18: {cfg.name} at full width ({cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.hd}, {cfg.mlp_type} d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, untied, {cfg.encoder_frames} "
        f"frames, {cfg.dtype}); batch {WHISPER_BATCH}, prompts "
        f"{WHISPER_PROMPTS}, max_len {WHISPER_MAX_LEN}, {WHISPER_NEW} "
        f"decode steps; B1 {b1_prefill} a prefill and {b1_step} a step, B4 "
        f"{b4_prefill} a prefill")
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params_c, params_fp8, report, enc_s = serve.build_params(cfg, seed, "tpu",
                                                             device="cuda")
    fp8_b, ecf8_b = report["fp8_bytes"], report["compressed_bytes"]
    built = dict(encode_s=enc_s, fp8_mb=fp8_b / 1e6, ecf8_mb=ecf8_b / 1e6,
                 saved_pct=100 * (1 - ecf8_b / fp8_b),
                 n_compressed=report["n_compressed"],
                 params_m=report["raw_bytes"] / 4e6,
                 resident_gib=(torch.cuda.memory_allocated() - base_mem)
                 / gib)
    log(f"phase 18 weights: {built['params_m']:.1f} M parameters, "
        f"{report['n_compressed']} tensors, fp8 {built['fp8_mb']:.1f} MB -> "
        f"ECF8 {built['ecf8_mb']:.1f} MB ({built['saved_pct']:.2f}% saved), "
        f"built and encoded in {enc_s:.1f}s; both trees resident "
        f"{built['resident_gib']:.3f} GiB")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randn((WHISPER_BATCH, cfg.encoder_frames, cfg.d_model),
                         generator=gen, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = {T: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WHISPER_BATCH, T))).cuda()
        for T in WHISPER_PROMPTS}
    dtype = getattr(torch, cfg.dtype)

    # the encoder alone, timed (its launches are outside the counted runs)
    def encode(params):
        return M.encode_frames(params, cfg, frames, dtype)

    enc_ms = {}
    for tag, params in (("ecf8", params_c), ("fp8", params_fp8)):
        encode(params)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            encode(params)
        b.record()
        b.synchronize()
        enc_ms[tag] = a.elapsed_time(b) / 3

    def run(tag, params, T, compressed):
        torch.cuda.reset_peak_memory_stats()
        b1.launches = b3.launches = b2.launches = b4.launches = 0
        b1.launches_by_dtype.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cfg, prompts[T],
                                  max_len=WHISPER_MAX_LEN, frames=frames)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(WHISPER_NEW):
            logits, cache = M.decode_step(params, cfg, tok, cache)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        toks = torch.cat(out, 1).cpu()
        cross_b = sum(x.numel() * x.element_size()
                      for x in cache["units"]["cross"].values())
        launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                    "kv_page_decode": b3.launches,
                    "fused_decode_matmul": b2.launches,
                    "ecf8_decode_by_dtype": {str(k): v for k, v in
                                             b1.launches_by_dtype.items()}}
        want_b1 = (b1_prefill + WHISPER_NEW * b1_step) if compressed else 0
        if (b1.launches != want_b1 or b4.launches != b4_prefill
                or b2.launches or b3.launches
                or set(b1.launches_by_dtype) - {torch.bfloat16}):
            fail(f"phase {tag}: launches {launches}, expected ecf8_decode "
                 f"{want_b1} (all bf16) and flash_fwd {b4_prefill}")
        if (int(cache["cur_len"]) != T + WHISPER_NEW
                or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
            fail(f"phase {tag}: cur_len {int(cache['cur_len'])} or "
                 f"out-of-vocab tokens")
        n = toks.numel()
        m = dict(prefill_s=t1 - t0, step_ms=(t2 - t1) / WHISPER_NEW * 1e3,
                 tok_s=n / (t2 - t0), cross_cache_mb=cross_b / 1e6,
                 peak_gib=torch.cuda.max_memory_allocated() / gib)
        log(f"phase {tag}, T={T}: prefill (encoder included) "
            f"{m['prefill_s']:.3f}s, {WHISPER_NEW} decode steps at "
            f"{m['step_ms']:.2f} ms/step, {m['tok_s']:.1f} tok/s; cross "
            f"cache {m['cross_cache_mb']:.1f} MB; peak device memory "
            f"{m['peak_gib']:.3f} GiB; launches {launches}")
        return toks, m, launches

    out, launches = {"built": built, "encoder_ms": enc_ms}, {}
    for T in WHISPER_PROMPTS:
        toks = {}
        for tag, params, compressed in (("18a", params_c, True),
                                        ("18b", params_fp8, False)):
            key = f"{tag}_T{T}"
            toks[tag], out[key], launches[key] = run(
                f"{tag} ({'ECF8' if compressed else 'fp8'})", params, T,
                compressed)
        if not torch.equal(toks["18a"], toks["18b"]):
            bad = (toks["18a"] != toks["18b"]).nonzero()[0].tolist()
            fail(f"phase 18, T={T}: ECF8 tokens differ from the fp8 tree's "
                 f"(row, token) {bad}")
        log(f"lossless: whisper ECF8 greedy tokens IDENTICAL to the fp8 "
            f"tree's at T={T} ({toks['18a'].numel()} tokens)")
    log(f"phase 18: encoder {enc_ms['ecf8']:.2f} ms from ECF8 against "
        f"{enc_ms['fp8']:.2f} ms from fp8 (batch {WHISPER_BATCH}, "
        f"{cfg.encoder_frames} frames)")
    del params_c, params_fp8, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def frontend_phase(torch, serve, load_replay, smoke_variant, get, kernels,
                   cfg, params, seed):
    """Phase 19 (module docstring): the reference's load replay over two
    engine replicas of ``cfg`` sharing ``params`` on the card, replayed
    twice, and once at smoke size on the CPU -> (measurements, launches of
    the first card replay)."""
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    # the CPU run: the smoke model's fp8 tree (placement reads loads and
    # prefix indices, never weights)
    t0 = time.perf_counter()
    small = smoke_variant(get(cfg.name))
    p_small, _, _, _ = serve.build_params(small, seed, "none", device="cpu")
    cpu = load_replay.run(device="cpu", smoke=True, seed=seed,
                          params=p_small)
    load_replay.check_streams(cpu)
    cpu_s = time.perf_counter() - t0
    # the counts cover the first card replay alone: the synchronous engine
    # that checks its streams runs after they are read
    b1.launches = b3.launches = b2.launches = b4.launches = 0
    card = load_replay.run(device="cuda", arch=cfg.name,
                           layers=cfg.n_layers, seed=seed, params=params)
    launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                "kv_page_decode": b3.launches,
                "fused_decode_matmul": b2.launches}
    load_replay.check_streams(card)
    again = load_replay.run(device="cuda", arch=cfg.name,
                            layers=cfg.n_layers, seed=seed, params=params)
    load_replay.check_streams(again)
    for tag, r in (("card", card), ("replay 2", again), ("CPU", cpu)):
        log(f"phase 19 {tag} ({r['arch']}, {r['n_layers']} layers, "
            f"{r['device']}): {r['n_completed']}/{r['n_requests']} completed,"
            f" {r['n_shed']} shed ({100 * r['shed_rate']:.1f} %), "
            f"{r['n_tokens']} tokens in {r['wall_s']:.2f}s, "
            f"{r['tok_per_s']:.1f} tok/s streamed, TTFT p50 / p95 "
            f"{r['ttft_p50_s'] * 1e3:.1f} / {r['ttft_p95_s'] * 1e3:.1f} ms, "
            f"{r['prefix_hits']} prefix hits; streams identical to the "
            f"synchronous engine")
    log(f"phase 19 placements (request, replica, reason): "
        f"{json.dumps(card['placements'])}; shed trace indices "
        f"{card['shed']}; launches {launches}")
    if (card["placements"], card["shed"]) != (again["placements"],
                                              again["shed"]):
        fail("phase 19: two replays of the same seed placed or shed apart")
    if (card["placements"], card["shed"]) != (cpu["placements"],
                                              cpu["shed"]):
        fail(f"phase 19: the card's placements / sheds differ from the CPU "
             f"smoke run's: {cpu['placements']}, {cpu['shed']}")
    if not (launches["ecf8_decode"] and not launches["fused_decode_matmul"]
            and not launches["kv_page_decode"]):
        fail(f"phase 19: launches {launches}")
    if not (card["n_shed"] and card["prefix_hits"]
            and {r for _, _, r in card["placements"]}
            == {"least-loaded", "prefix-affinity"}):
        fail("phase 19: the burst shed nothing, or no placement followed "
             "a prefix")
    keep = ("n_completed", "n_shed", "shed_rate", "n_tokens", "wall_s",
            "tok_per_s", "ttft_p50_s", "ttft_p95_s", "prefix_hits")
    return (dict(card={k: card[k] for k in keep},
                 replay2={k: again[k] for k in keep},
                 cpu={k: cpu[k] for k in keep}, cpu_s=cpu_s,
                 placements=card["placements"], shed=card["shed"]),
            launches)


def to_device(tree, dev, store):
    """A parameter tree (tensors and CompressedTensors) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev, store) for k, v in tree.items()}
    if store.is_compressed(tree):
        return store.CompressedTensor(
            {k: a.to(dev) for k, a in tree.arrays.items()}, tree.meta)
    return tree.to(dev)


def chat_stream(np, vocab: int, seed: int):
    """Phase 11's traffic: two ``SYSTEM_TOKENS``-token system prompts A and
    B and 32-192-token user suffixes, drawn from ``seed``, in the order
    A x 4, B x 4, A x 4 -> (prompts, system-prompt labels)."""
    rng = np.random.default_rng(seed)
    system = {k: rng.integers(1, vocab, size=SYSTEM_TOKENS).tolist()
              for k in "AB"}
    labels = list("A" * 4 + "B" * 4 + "A" * 4)
    return [system[k] + rng.integers(0, vocab, size=rng.integers(
        32, 193)).tolist() for k in labels], labels


def prefix_phase(torch, np, serve, EngineConfig, telemetry, trace_export,
                 kernels, cfg, params_c, seed):
    """Phase 11 (module docstring) -> (measurements, B1 and B3 launches of
    11a's sharing-on run and of 11b).  ``kernels`` maps name -> wrapper
    (``run``) whose launch counts the phase reads."""
    import tempfile
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    prompts, labels = chat_stream(np, cfg.vocab_size, seed)
    base = dict(max_batch=4, max_len=1024, page_size=16, prefill_chunk=CHUNK,
                prefill_budget=CHUNK)
    log(f"phase 11: {len(prompts)} chat requests (system prompts "
        f"{SYSTEM_TOKENS} tokens, {'/'.join(labels)}), prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
        f"{sum(map(len, prompts))} in all; chunk / budget {CHUNK}, page 16, "
        f"max_batch 4, 32 new tokens, {cfg.n_layers} layers")

    def reset():
        b1.launches = b3.launches = b2.launches = b4.launches = 0
        b3.launches_by_path.clear()

    def run(tag, tel=None, time_telemetry=False, **extra):
        shared_peak = [0]
        tel_seconds = {}

        def on_step(i):
            live_a = sum(1 for r in eng_box[0].slots
                         if r is not None and labels[reqs.index(r)] == "A")
            if live_a >= 2 and eng_box[0].paged.prefix is not None:
                shared_peak[0] = max(shared_peak[0],
                                     eng_box[0].paged.n_shared_pages())

        eng_box, reqs = [], []
        torch.cuda.reset_peak_memory_stats()
        reset()
        ecfg = EngineConfig(**base, telemetry=tel, **extra)
        eng = serve.GenerationEngine(params_c, cfg, config=ecfg,
                                     device="cuda")
        eng_box.append(eng)
        if time_telemetry:
            # host seconds in the engine's per-step telemetry methods
            # (shadowed on this instance by timed wrappers)
            for name in ("_observe_decode", "_record_monitor",
                         "_sample_gauges"):
                def timed(*a, _f=getattr(eng, name), _n=name):
                    t = time.perf_counter()
                    _f(*a)
                    tel_seconds[_n] = tel_seconds.get(_n, 0.0) + (
                        time.perf_counter() - t)
                setattr(eng, name, timed)
        reqs.extend(serve.Request(prompt=p, max_new_tokens=32)
                    for p in prompts)
        for r in reqs:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run(on_step=on_step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(r.done and len(r.out_tokens) == 32 for r in reqs) or any(
                not 0 <= x < cfg.vocab_size for r in reqs
                for x in r.out_tokens):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
        launches = {"ecf8_decode": b1.launches, "kv_page_decode": b3.launches,
                    "fused_decode_matmul": b2.launches,
                    "flash_fwd": b4.launches,
                    "kv_page_decode_by_path": dict(b3.launches_by_path)}
        n = sum(len(r.out_tokens) for r in reqs)
        log(f"phase {tag}: {n} tokens in {dt:.2f}s, {n / dt:.1f} tok/s, "
            f"{eng.steps} steps at {eng.decode_seconds / eng.steps * 1e3:.1f}"
            f" ms/step, prefill phases {eng.prefill_seconds:.2f}s "
            f"({eng.n_chunks} chunks, {eng.n_chunk_tokens} prompt tokens), "
            f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} "
            f"GiB; launches {launches}")
        return reqs, eng, launches, shared_peak[0], tel_seconds

    def pct(reg, name):
        h = reg.get(name)
        return (f"p50 {h.percentile(0.5) * 1e3:.1f} / p99 "
                f"{h.percentile(0.99) * 1e3:.1f} ms (n={h.count})")

    def exact_ttft(tracer):
        """Each request's TTFT from its state spans (start of its first
        'decoding' span less the start of its 'queued' one), sorted: the
        registry's histogram resolves only its ~20 % buckets."""
        first = {}
        for ph, _, name, track, ts, _, _ in tracer.events:
            if ph == "X" and track.startswith("req:"):
                first.setdefault((track, name), ts)
        return sorted(first[(t, "decoding")] - first[(t, "queued")]
                      for t, n in first if n == "queued")

    out = {}
    tel_off = telemetry.Telemetry()
    t_off, e_off, l_off, _, _ = run("11a (sharing off, telemetry on)",
                                    tel_off)
    tel_on = telemetry.Telemetry()
    t_on, e_on, l_on, peak, tel_s = run("11a (sharing on, telemetry on)",
                                        tel_on, time_telemetry=True,
                                        prefix_sharing=True)
    t_bare, e_bare, _, _, _ = run("11a (sharing on, telemetry off)",
                                  prefix_sharing=True)
    reg, reg_off = tel_on.registry, tel_off.registry
    hits, matched = (reg.value("prefix_hit_total"),
                     reg.value("prefix_match_tokens_total"))
    saved = e_off.n_chunk_tokens - e_on.n_chunk_tokens
    log(f"phase 11a: {hits} prefix hits / {reg.value('prefix_miss_total')} "
        f"misses, {matched} matched tokens, {saved} prompt tokens not "
        f"prefilled; peak shared pages while two A requests are live {peak};"
        f" {e_on.paged.n_cow_splits} CoW splits; {serve.prefix_report(e_on)}")
    bad = first_divergence(t_off, t_on)[1] + first_divergence(t_on, t_bare)[1]
    if bad:
        fail(f"phase 11a: tokens differ between sharing off / on / on "
             f"without telemetry (request, first token index): {bad}")
    if not hits or saved != matched or peak <= 0 or e_on.paged.n_cow_splits:
        fail(f"phase 11a: hits {hits}, saved {saved} vs matched {matched}, "
             f"shared peak {peak}, CoW splits {e_on.paged.n_cow_splits}")
    if not l_on["ecf8_decode"] or l_on["fused_decode_matmul"] or \
            l_off["fused_decode_matmul"]:
        fail(f"phase 11a: launches {l_on}")
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/trace.json"
        trace = trace_export.export_chrome_trace(tel_on.tracer, path, reg)
        loaded = json.loads(Path(path).read_text())
    errors = trace_export.validate_chrome_trace(loaded)
    if errors or loaded != trace:
        fail(f"phase 11a: the exported trace is invalid: {errors[:5]}")
    ttft = {}
    for tag, t, r in (("off", tel_off, reg_off), ("on", tel_on, reg)):
        ttft[tag] = exact_ttft(t.tracer)
        log(f"phase 11a sharing {tag}: TTFT {pct(r, 'serving_ttft_seconds')}"
            f" (from the state spans: median "
            f"{statistics.median(ttft[tag]) * 1e3:.1f}, max "
            f"{ttft[tag][-1] * 1e3:.1f} ms), queue wait "
            f"{pct(r, 'serving_queue_wait_seconds')}, decode step "
            f"{pct(r, 'serving_decode_step_seconds')}, request latency "
            f"{pct(r, 'serving_request_latency_seconds')}")
    step_on = e_on.decode_seconds / e_on.steps * 1e3
    step_bare = e_bare.decode_seconds / e_bare.steps * 1e3
    tel_us = sum(tel_s.values()) / e_on.steps * 1e6
    log(f"phase 11a: decode step with telemetry on {step_on:.2f} ms "
        f"({e_on.steps} steps) against off {step_bare:.2f} ms "
        f"({e_bare.steps} steps); the per-step telemetry methods took "
        f"{tel_us:.1f} us of host time a step ("
        f"{', '.join(f'{k} {v / e_on.steps * 1e6:.1f}' for k, v in tel_s.items())}"
        f"); prefill phases sharing on {e_on.prefill_seconds:.2f}s against "
        f"off {e_off.prefill_seconds:.2f}s; trace "
        f"{len(trace['traceEvents'])} events ({tel_on.tracer.n_dropped} "
        f"dropped), valid")
    out["11a"] = dict(
        ttft_p50_on=reg.get("serving_ttft_seconds").percentile(0.5),
        ttft_p99_on=reg.get("serving_ttft_seconds").percentile(0.99),
        ttft_p50_off=reg_off.get("serving_ttft_seconds").percentile(0.5),
        ttft_p99_off=reg_off.get("serving_ttft_seconds").percentile(0.99),
        ttft_exact_on=ttft["on"], ttft_exact_off=ttft["off"],
        prefill_s_on=e_on.prefill_seconds, prefill_s_off=e_off.prefill_seconds,
        step_ms_tel_on=step_on, step_ms_tel_off=step_bare,
        telemetry_us_a_step=tel_us, hits=hits, matched=matched)

    tel_b = telemetry.Telemetry()
    t_b, e_b, l_b, _, _ = run("11b (sharing on, phase 7's pools + swap)",
                              tel_b, prefix_sharing=True, compress_cold=True,
                              n_pages=SWAP_N_PAGES,
                              n_cold_slots=SWAP_N_COLD_SLOTS, swap_bytes=-1)
    pc, sched = e_b.paged, e_b.scheduler
    st = pc.stats()
    spans = [ev[5] for ev in tel_b.tracer.events
             if ev[0] == "X" and ev[2] == "prefix_fault"]
    fault_l = l_b["kv_page_decode_by_path"].get("fault", 0)
    for line in serve.cache_report(e_b):
        log(f"  {line}")
    log(f"phase 11b: {serve.prefix_report(e_b)}; {len(spans)} prefix faults"
        f" (host {', '.join(f'{x * 1e3:.2f}' for x in spans)} ms), "
        f"kv_page_decode from fault {fault_l}, retirement encode "
        f"{pc.retire_seconds:.2f}s of {pc.encode_seconds:.2f}s encode_page; "
        f"{sched.n_preempted} preemptions, {sched.n_resumed} resumes")
    _, bad = first_divergence(t_on, t_b)
    if bad:
        fail(f"phase 11b tokens differ from 11a's (request, first token "
             f"index): {bad}")
    if not (st["prefix_retired_total"] > 0 and spans
            and fault_l >= len(spans)):
        fail(f"phase 11b: no prefix retired and faulted back through "
             f"kv_page_decode: retired {st['prefix_retired_total']}, "
             f"prefix faults {len(spans)}, fault launches {fault_l}")
    if not (sched.n_preempted > 0 and sched.n_resumed == sched.n_preempted):
        fail(f"phase 11b did not preempt and resume: {sched.counters()}")
    sw = pc.swap.stats()
    if (pc._slot_pages or pc._cold_bytes
            or sw["swap_pages"] != sw["swap_prefix_pages"]
            or any(v != 1 for v in pc._ref.values())
            or pc.free_pages + st["prefix_resident_blocks"] != pc.n_pages - 1
            or l_b["fused_decode_matmul"]):
        fail(f"phase 11b did not drain to the prefix index: {st}")
    log("lossless: prefix-shared greedy tokens IDENTICAL with sharing off, "
        "with telemetry off, and under phase 7's pools and swap (11b)")
    out["11b"] = dict(prefix_faults=len(spans),
                      prefix_fault_ms=[x * 1e3 for x in spans],
                      retire_s=pc.retire_seconds, encode_s=pc.encode_seconds)
    return out, {"11a": l_on, "11b": l_b}


def moe_phase(torch, serve, EngineConfig, kernels, cfg, seed):
    """Phase 12 (module docstring) on ``cfg`` -> (measurements, launches of
    12a, 12b and 12c).  ``kernels`` maps name -> wrapper (``run``) whose
    launch counts the phase reads."""
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    gib = 2 ** 30
    log(f"phase 12: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, {cfg.n_experts} "
        f"experts top-{cfg.top_k} of width {cfg.moe_d_ff}, "
        f"{cfg.n_shared_experts} shared, capacity factor "
        f"{cfg.capacity_factor}, vocab {cfg.vocab_size}, tied embeddings "
        f"{cfg.tie_embeddings}, {cfg.dtype}), {cfg.n_layers} layers")
    prompts = serve.make_prompts(cfg, 8, seed, lo=64, hi=513)
    base_mem = torch.cuda.memory_allocated()

    def reset():
        b1.launches = b3.launches = b2.launches = b4.launches = 0
        b1.launches_by_dtype.clear()
        b3.launches_by_path.clear()

    def run(tag, params, **extra):
        torch.cuda.reset_peak_memory_stats()
        reset()
        done, eng, dt = serve.serve(params, cfg, EngineConfig(
            max_batch=4, max_len=1024, **extra), prompts, 32)
        if not all(r.done and len(r.out_tokens) == 32 for r in done) or any(
                not 0 <= x < cfg.vocab_size for r in done
                for x in r.out_tokens):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
        launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                    "kv_page_decode": b3.launches,
                    "fused_decode_matmul": b2.launches,
                    "kv_page_decode_by_path": dict(b3.launches_by_path),
                    "ecf8_decode_by_dtype": {str(k): v for k, v in
                                             b1.launches_by_dtype.items()}}
        n = sum(len(r.out_tokens) for r in done)
        m = dict(step_ms=eng.decode_seconds / eng.steps * 1e3,
                 steps=eng.steps, tok_s=n / dt, wall_s=dt,
                 prefill_s=eng.prefill_seconds,
                 peak_gib=torch.cuda.max_memory_allocated() / gib)
        log(f"phase {tag}: {n} tokens in {dt:.2f}s, {m['tok_s']:.1f} tok/s, "
            f"{eng.steps} decode steps at {m['step_ms']:.1f} ms/step, "
            f"prefill {eng.prefill_seconds:.2f}s, peak device memory "
            f"{m['peak_gib']:.2f} GiB; launches {launches}")
        if launches["fused_decode_matmul"]:
            fail(f"phase {tag} launched fused_decode_matmul: {launches}")
        if set(b1.launches_by_dtype) - {torch.bfloat16}:
            fail(f"phase {tag}: a weight was decoded to another dtype than "
                 f"bf16: {launches}")
        return done, eng, m, launches

    # 12a: the ECF8 tree alone on the card, built layer by layer
    torch.cuda.reset_peak_memory_stats()
    params_c, _, report, enc_s = serve.build_params(
        cfg, seed, "tpu", device="cuda", baseline=False)
    fp8_b, ecf8_b = report["fp8_bytes"], report["compressed_bytes"]
    saved = 100 * (1 - ecf8_b / fp8_b)
    built = dict(encode_s=enc_s, fp8_mb=fp8_b / 1e6, ecf8_mb=ecf8_b / 1e6,
                 saved_pct=saved,
                 build_peak_gib=torch.cuda.max_memory_allocated() / gib,
                 ecf8_resident_gib=(torch.cuda.memory_allocated()
                                    - base_mem) / gib)
    log(f"phase 12 weights: {report['n_compressed']} tensors, fp8 "
        f"{fp8_b / 1e6:.1f} MB -> ECF8 {ecf8_b / 1e6:.1f} MB ({saved:.2f}% "
        f"saved), streamed build and encode {enc_s:.1f}s, build peak "
        f"{built['build_peak_gib']:.2f} GiB, ECF8 tree resident "
        f"{built['ecf8_resident_gib']:.2f} GiB (device memory before the "
        f"phase {base_mem / gib:.2f} GiB)")
    d12a, e12a, m12a, l12a = run("12a (ECF8, paged)", params_c)
    per_pass = 11 * cfg.n_layers + 2
    if not (l12a["ecf8_decode"] and l12a["flash_fwd"]):
        fail(f"phase 12a: a kernel of the MoE path never launched: {l12a}")
    log(f"phase 12a: ecf8_decode {per_pass} launches a pass (11 x "
        f"{cfg.n_layers} + 2: 4 attention, router, 3 expert and 3 shared "
        f"weights a layer, the tied embedding twice), flash_fwd "
        f"{cfg.n_layers} a whole-prompt prefill")

    # 12c: undersized pools and the swap tier, the same ECF8 tree
    d12c, e12c, m12c, l12c = run(
        "12c (ECF8, paged-compressed, phase 7's pools + swap)", params_c,
        compress_cold=True, n_pages=SWAP_N_PAGES,
        n_cold_slots=SWAP_N_COLD_SLOTS, swap_bytes=-1)
    pc, sched = e12c.paged, e12c.scheduler
    st = pc.swap.stats()
    for line in serve.cache_report(e12c):
        log(f"  {line}")
    by_path = l12c["kv_page_decode_by_path"]
    if by_path.get("gather", 0) <= 0 or by_path.get("fault", 0) <= 0:
        fail(f"phase 12c: kv_page_decode did not launch from both gather "
             f"and fault: {by_path}")
    if not (sched.n_preempted > 0 and sched.n_resumed > 0):
        fail(f"phase 12c did not preempt and resume: {sched.counters()}")
    if (st["swap_in_bytes_total"] != st["swap_out_bytes_total"]
            or len(pc.swap) or pc._slot_pages
            or pc.free_pages != pc.n_pages - 1 or pc._cold_bytes):
        fail(f"phase 12c did not drain: {pc.stats()}")
    _, bad = first_divergence(d12a, d12c)
    if bad:
        fail(f"phase 12c tokens differ from 12a's (request, first token "
             f"index): {bad}")
    m12c.update(preempted=sched.n_preempted, resumed=sched.n_resumed,
                encode_page_s=pc.encode_seconds)
    log(f"lossless: 12c greedy tokens IDENTICAL to 12a's under phase 7's "
        f"pools and swap ({sched.n_preempted} preemptions, "
        f"{sched.n_resumed} resumes)")
    del params_c, e12a, e12c, pc
    torch.cuda.empty_cache()

    # 12b: the fp8 baseline tree alone on the card
    torch.cuda.reset_peak_memory_stats()
    params_fp8, _, _, fp8_s = serve.build_params(cfg, seed, "none",
                                                 device="cuda")
    built["fp8_resident_gib"] = (torch.cuda.memory_allocated()
                                 - base_mem) / gib
    log(f"phase 12b: fp8 baseline tree built in {fp8_s:.1f}s, resident "
        f"{built['fp8_resident_gib']:.2f} GiB")
    d12b, e12b, m12b, l12b = run("12b (fp8 baseline, paged)", params_fp8)
    _, bad = first_divergence(d12a, d12b)
    if bad:
        fail(f"phase 12b: ECF8 tokens differ from the fp8 baseline's "
             f"(request, first token index): {bad}")
    log(f"lossless: moonshot ECF8 greedy tokens IDENTICAL to the fp8 "
        f"baseline's; decode step {m12a['step_ms']:.1f} ms (ECF8) against "
        f"{m12b['step_ms']:.1f} ms (fp8), peak device memory "
        f"{m12a['peak_gib']:.2f} GiB with the ECF8 tree resident against "
        f"{m12b['peak_gib']:.2f} GiB with the fp8 tree")
    del params_fp8, e12b
    torch.cuda.empty_cache()
    return (dict(built=built, **{"12a": m12a, "12b": m12b, "12c": m12c}),
            {"12a": l12a, "12b": l12b, "12c": l12c})


def gemma_phase(torch, np, serve, EngineConfig, kernels, cfg, seed):
    """Phase 13 (module docstring) on ``cfg`` -> (measurements, launches of
    13a-d).  ``kernels`` maps name -> wrapper (``run``) whose launch counts
    the phase reads."""
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    gib = 2 ** 30
    W = min(cfg.local_window, GEMMA_MAX_LEN)
    per_pass = 7 * cfg.n_layers + 2
    # flash in every layer of a prompt the window covers, in the global
    # layers alone (local_attention in the local ones) past it
    want_b4 = sum(cfg.n_layers if n <= cfg.local_window
                  else cfg.n_layers // cfg.unit for n in GEMMA_PROMPTS)
    log(f"phase 13: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, pattern "
        f"{cfg.pattern}, window {cfg.local_window}, {cfg.mlp_type} d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, softcaps {cfg.attn_softcap:g}"
        f" / {cfg.logit_softcap:g}, post-norms {cfg.post_norms}, "
        f"{cfg.dtype}), {cfg.n_layers} layers; prompts {GEMMA_PROMPTS}, "
        f"max_batch 4, max_len {GEMMA_MAX_LEN}, page 16, 32 new tokens")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in GEMMA_PROMPTS]
    base_mem = torch.cuda.memory_allocated()

    def reset():
        b1.launches = b3.launches = b2.launches = b4.launches = 0
        b1.launches_by_dtype.clear()
        b3.launches_by_path.clear()

    def run(tag, params, **extra):
        torch.cuda.reset_peak_memory_stats()
        reset()
        eng = serve.GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=4, max_len=GEMMA_MAX_LEN, page_size=16, **extra),
            device="cuda")
        preempted_at = []           # host lengths of the slots preempted
        preempt = eng._preempt

        def spy(slot):
            preempted_at.append(eng._host_len[slot])
            return preempt(slot)

        eng._preempt = spy
        done = [serve.Request(prompt=p, max_new_tokens=32) for p in prompts]
        for r in done:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(r.done and len(r.out_tokens) == 32 for r in done) or any(
                not 0 <= x < cfg.vocab_size for r in done
                for x in r.out_tokens):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
        launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                    "kv_page_decode": b3.launches,
                    "fused_decode_matmul": b2.launches,
                    "kv_page_decode_by_path": dict(b3.launches_by_path),
                    "ecf8_decode_by_dtype": {str(k): v for k, v in
                                             b1.launches_by_dtype.items()}}
        n = sum(len(r.out_tokens) for r in done)
        m = dict(step_ms=eng.decode_seconds / eng.steps * 1e3,
                 steps=eng.steps, tok_s=n / dt, wall_s=dt,
                 prefill_s=eng.prefill_seconds,
                 peak_gib=torch.cuda.max_memory_allocated() / gib,
                 preempted_at=preempted_at)
        log(f"phase {tag}: {n} tokens in {dt:.2f}s, {m['tok_s']:.1f} tok/s, "
            f"{eng.steps} decode steps at {m['step_ms']:.1f} ms/step, "
            f"prefill {eng.prefill_seconds:.2f}s, peak device memory "
            f"{m['peak_gib']:.2f} GiB; launches {launches}")
        if launches["fused_decode_matmul"]:
            fail(f"phase {tag} launched fused_decode_matmul: {launches}")
        if b1.launches and set(b1.launches_by_dtype) - {torch.bfloat16}:
            fail(f"phase {tag}: a weight was decoded to another dtype than "
                 f"bf16: {launches}")
        if b4.launches != want_b4:
            fail(f"phase {tag}: flash_fwd launched {b4.launches} times, "
                 f"expected {want_b4}")
        return done, eng, m, launches

    # 13a: the ECF8 tree alone on the card, built a unit at a time
    torch.cuda.reset_peak_memory_stats()
    params_c, _, report, enc_s = serve.build_params(
        cfg, seed, "tpu", device="cuda", baseline=False)
    fp8_b, ecf8_b = report["fp8_bytes"], report["compressed_bytes"]
    saved = 100 * (1 - ecf8_b / fp8_b)
    built = dict(encode_s=enc_s, fp8_mb=fp8_b / 1e6, ecf8_mb=ecf8_b / 1e6,
                 saved_pct=saved,
                 build_peak_gib=torch.cuda.max_memory_allocated() / gib,
                 ecf8_resident_gib=(torch.cuda.memory_allocated()
                                    - base_mem) / gib)
    log(f"phase 13 weights: {report['n_compressed']} tensors, fp8 "
        f"{fp8_b / 1e6:.1f} MB -> ECF8 {ecf8_b / 1e6:.1f} MB ({saved:.2f}% "
        f"saved), streamed build and encode {enc_s:.1f}s, build peak "
        f"{built['build_peak_gib']:.2f} GiB, ECF8 tree resident "
        f"{built['ecf8_resident_gib']:.2f} GiB (device memory before the "
        f"phase {base_mem / gib:.2f} GiB)")
    d13a, e13a, m13a, l13a = run("13a (ECF8, paged)", params_c)
    passes = len(prompts) + e13a.steps
    if l13a["ecf8_decode"] != per_pass * passes:
        fail(f"phase 13a: ecf8_decode launched {l13a['ecf8_decode']} times, "
             f"expected {per_pass} x {passes} passes")
    log(f"phase 13a: ecf8_decode {per_pass} launches a pass (7 x "
        f"{cfg.n_layers} + 2, the tied embedding twice) x {passes} passes; "
        f"flash_fwd {want_b4} (head_dim {cfg.hd}: {cfg.n_layers} a prompt "
        f"the window covers, {cfg.n_layers // cfg.unit} past it); rings of "
        f"{W} positions")

    # 13c: a raw pool too small for all four slots, no cold pool, swap
    d13c, e13c, m13c, l13c = run(
        "13c (ECF8, paged, undersized raw pool + swap)", params_c,
        n_pages=GEMMA_SWAP_N_PAGES, swap_bytes=-1)
    pc, sched = e13c.paged, e13c.scheduler
    st = pc.swap.stats()
    for line in serve.cache_report(e13c):
        log(f"  {line}")
    by_path = l13c["kv_page_decode_by_path"]
    if by_path.get("fault", 0) <= 0:
        fail(f"phase 13c: kv_page_decode did not launch from fault: "
             f"{by_path}")
    if not (sched.n_preempted > 0 and sched.n_resumed == sched.n_preempted
            and max(m13c["preempted_at"], default=0) > W):
        fail(f"phase 13c did not preempt and resume a slot whose ring had "
             f"wrapped: {sched.counters()}, preempted at host lengths "
             f"{m13c['preempted_at']} (window {W})")
    if (st["swap_in_bytes_total"] != st["swap_out_bytes_total"]
            or len(pc.swap) or pc._slot_pages
            or pc.free_pages != pc.n_pages - 1):
        fail(f"phase 13c did not drain: {pc.stats()}")
    _, bad = first_divergence(d13a, d13c)
    if bad:
        fail(f"phase 13c tokens differ from 13a's (request, first token "
             f"index): {bad}")
    m13c.update(preempted=sched.n_preempted, resumed=sched.n_resumed,
                encode_page_s=pc.encode_seconds,
                swap_out_mb=st["swap_out_bytes_total"] / 1e6)
    log(f"lossless: 13c greedy tokens IDENTICAL to 13a's ({sched.n_preempted}"
        f" preemptions at host lengths {m13c['preempted_at']} past the "
        f"window {W}, {sched.n_resumed} resumes with the rings reinstalled;"
        f" encode_page {pc.encode_seconds:.2f}s on the host, kv_page_decode "
        f"{by_path.get('fault', 0)} launches from fault)")
    del e13c, pc

    # 13d: the monolithic cache, the same tree
    d13d, e13d, m13d, l13d = run("13d (ECF8, monolithic)", params_c,
                                 cache_mode="monolithic")
    _, bad = first_divergence(d13a, d13d)
    if bad:
        fail(f"phase 13d tokens differ from 13a's (request, first token "
             f"index): {bad}")
    log("lossless: 13d monolithic greedy tokens IDENTICAL to 13a's")
    del params_c, e13a, e13d
    gc.collect()
    torch.cuda.empty_cache()

    # 13b: the fp8 baseline tree alone on the card
    torch.cuda.reset_peak_memory_stats()
    params_fp8, _, _, fp8_s = serve.build_params(cfg, seed, "none",
                                                 device="cuda")
    built["fp8_resident_gib"] = (torch.cuda.memory_allocated()
                                 - base_mem) / gib
    log(f"phase 13b: fp8 baseline tree built in {fp8_s:.1f}s, resident "
        f"{built['fp8_resident_gib']:.2f} GiB")
    d13b, e13b, m13b, l13b = run("13b (fp8 baseline, paged)", params_fp8)
    _, bad = first_divergence(d13a, d13b)
    if bad:
        fail(f"phase 13b: ECF8 tokens differ from the fp8 baseline's "
             f"(request, first token index): {bad}")
    log(f"lossless: gemma2 ECF8 greedy tokens IDENTICAL to the fp8 "
        f"baseline's; decode step {m13a['step_ms']:.1f} ms (ECF8) against "
        f"{m13b['step_ms']:.1f} ms (fp8), peak device memory "
        f"{m13a['peak_gib']:.2f} GiB with the ECF8 tree resident against "
        f"{m13b['peak_gib']:.2f} GiB with the fp8 tree")
    del params_fp8, e13b
    gc.collect()
    torch.cuda.empty_cache()
    return (dict(built=built, **{"13a": m13a, "13b": m13b, "13c": m13c,
                                 "13d": m13d}),
            {"13a": l13a, "13b": l13b, "13c": l13c, "13d": l13d})


def recurrent_phase(torch, np, serve, EngineConfig, kernels, cfg, seed,
                    tag, prompt_lens, max_len, want, probe):
    """Phase 14 or 15 (module docstring) on ``cfg`` -> (measurements,
    launches of ``<tag>a`` and ``<tag>b``).  ``want``: B1 launches a pass
    by output dtype and B4's launches over a run; ``probe``: (layer kind,
    T) of the mixer timed alone on the ECF8 tree after the runs."""
    from repro_torch.models import model as M, recurrent
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    gib = 2 ** 30
    log(f"phase {tag}: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, pattern "
        f"{cfg.pattern}, {cfg.n_layers} layers = {cfg.n_layers // cfg.unit}"
        f" units + {cfg.n_layers % cfg.unit} tail, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, window "
        f"{cfg.local_window}, {cfg.dtype}); prompts {prompt_lens}, "
        f"max_batch 4, max_len {max_len}, 32 new tokens")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]
    base_mem = torch.cuda.memory_allocated()

    def run(sub, params, compressed):
        torch.cuda.reset_peak_memory_stats()
        b1.launches = b3.launches = b2.launches = b4.launches = 0
        b1.launches_by_dtype.clear()
        eng = serve.GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=4, max_len=max_len), device="cuda")
        if eng.cache_mode != "monolithic":
            fail(f"phase {tag}{sub}: the cache resolved to "
                 f"{eng.cache_mode}, not the monolithic one")
        done = [serve.Request(prompt=p, max_new_tokens=32) for p in prompts]
        for r in done:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(r.done and len(r.out_tokens) == 32 for r in done) or any(
                not 0 <= x < cfg.vocab_size for r in done
                for x in r.out_tokens):
            fail(f"phase {tag}{sub}: unfinished requests or out-of-vocab "
                 f"tokens")
        by_dtype = {str(k).split(".")[-1]: v
                    for k, v in b1.launches_by_dtype.items()}
        launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                    "kv_page_decode": b3.launches,
                    "fused_decode_matmul": b2.launches,
                    "ecf8_decode_by_dtype": by_dtype}
        n = sum(len(r.out_tokens) for r in done)
        passes = len(prompts) + eng.steps
        m = dict(step_ms=eng.decode_seconds / eng.steps * 1e3,
                 steps=eng.steps, passes=passes, tok_s=n / dt, wall_s=dt,
                 prefill_s=eng.prefill_seconds,
                 resident_gib=(torch.cuda.memory_allocated() - base_mem)
                 / gib, peak_gib=torch.cuda.max_memory_allocated() / gib)
        log(f"phase {tag}{sub}: {n} tokens in {dt:.2f}s, {m['tok_s']:.1f} "
            f"tok/s, {eng.steps} decode steps at {m['step_ms']:.1f} ms/step,"
            f" prefill {eng.prefill_seconds:.2f}s, peak device memory "
            f"{m['peak_gib']:.2f} GiB; launches {launches}")
        for line in serve.cache_report(eng):
            log(f"  {line}")
        want_b1 = ({k: v * passes for k, v in want["b1"].items()}
                   if compressed else {})
        if by_dtype != want_b1:
            fail(f"phase {tag}{sub}: ecf8_decode launches by dtype "
                 f"{by_dtype}, expected {want_b1} ({want['b1']} a pass x "
                 f"{passes} passes)")
        if b4.launches != want["b4"] or b2.launches or b3.launches:
            fail(f"phase {tag}{sub}: launches {launches}, expected "
                 f"flash_fwd {want['b4']} and no other kernel than B1")
        return done, eng, m, launches

    # a: the ECF8 tree alone on the card
    torch.cuda.reset_peak_memory_stats()
    params_c, _, report, enc_s = serve.build_params(
        cfg, seed, "tpu", device="cuda", baseline=False)
    fp8_b, ecf8_b = report["fp8_bytes"], report["compressed_bytes"]
    built = dict(encode_s=enc_s, fp8_mb=fp8_b / 1e6, ecf8_mb=ecf8_b / 1e6,
                 saved_pct=100 * (1 - ecf8_b / fp8_b),
                 n_compressed=report["n_compressed"],
                 build_peak_gib=torch.cuda.max_memory_allocated() / gib,
                 ecf8_resident_gib=(torch.cuda.memory_allocated()
                                    - base_mem) / gib)
    log(f"phase {tag} weights: {report['n_compressed']} tensors, fp8 "
        f"{built['fp8_mb']:.1f} MB -> ECF8 {built['ecf8_mb']:.1f} MB "
        f"({built['saved_pct']:.2f}% saved), streamed build and encode "
        f"{enc_s:.1f}s, build peak {built['build_peak_gib']:.2f} GiB, ECF8 "
        f"tree resident {built['ecf8_resident_gib']:.2f} GiB")
    d_a, e_a, m_a, l_a = run("a (ECF8)", params_c, True)
    log(f"phase {tag}a: ecf8_decode {want['b1']} a pass x {m_a['passes']} "
        f"passes, flash_fwd {want['b4']}, as counted")
    # the mixer alone on the card at the longest prompt, on the ECF8 tree
    # (its weight decodes included), outside the counted run
    kind, T = probe
    j = cfg.pattern.index(kind)
    layer = M._layer(params_c["units"][f"pos{j}"], 0)
    x = torch.randn((1, T, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed)).to(torch.bfloat16)
    fn = {"rglru": lambda: recurrent.rglru_apply(
              layer["rglru"], x, dtype=torch.bfloat16),
          "slstm": lambda: recurrent.slstm_apply(
              layer["cell"], x, cfg.n_heads, dtype=torch.bfloat16)}[kind]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    n_kind = sum(cfg.layer_kind(i) == kind for i in range(cfg.n_layers))
    m_a["probe"] = dict(kind=kind, T=T, layer_s=statistics.median(times),
                        n_layers=n_kind)
    log(f"phase {tag}a: one {kind} layer's prefill at T={T} on the card "
        f"(host clock, median of 3, weight decodes included): "
        f"{m_a['probe']['layer_s'] * 1e3:.1f} ms; x {n_kind} layers = "
        f"{m_a['probe']['layer_s'] * n_kind:.2f} s")
    del params_c, e_a, layer, x
    gc.collect()
    torch.cuda.empty_cache()

    # b: the fp8 baseline tree alone on the card
    torch.cuda.reset_peak_memory_stats()
    params_fp8, _, _, fp8_s = serve.build_params(cfg, seed, "none",
                                                 device="cuda")
    built["fp8_resident_gib"] = (torch.cuda.memory_allocated()
                                 - base_mem) / gib
    log(f"phase {tag}b: fp8 baseline tree built in {fp8_s:.1f}s, resident "
        f"{built['fp8_resident_gib']:.2f} GiB")
    d_b, e_b, m_b, l_b = run("b (fp8 baseline)", params_fp8, False)
    _, bad = first_divergence(d_a, d_b)
    if bad:
        fail(f"phase {tag}b: ECF8 tokens differ from the fp8 baseline's "
             f"(request, first token index): {bad}")
    log(f"lossless: {cfg.name} ECF8 greedy tokens IDENTICAL to the fp8 "
        f"baseline's; decode step {m_a['step_ms']:.1f} ms (ECF8) against "
        f"{m_b['step_ms']:.1f} ms (fp8), prefill {m_a['prefill_s']:.2f} "
        f"against {m_b['prefill_s']:.2f} s, peak device memory "
        f"{m_a['peak_gib']:.2f} GiB with the ECF8 tree resident against "
        f"{m_b['peak_gib']:.2f} GiB with the fp8 tree")
    del params_fp8, e_b
    gc.collect()
    torch.cuda.empty_cache()
    return (dict(built=built, **{f"{tag}a": m_a, f"{tag}b": m_b}),
            {f"{tag}a": l_a, f"{tag}b": l_b})


def container_report(torch, np, fixedrate, tpu_format, paper_format, stats,
                     theory, params_fr):
    """Phase 16's container report (the paper's Table 1 at full width) on
    layer 0's seven matrices and the embedding of an ECF8-FR tree -> rows.
    Each matrix's fp8 bits are its FR leaf decoded on the card; bytes an
    element of the ECF8-TPU container (encoded on the card) and of the FR
    one (each matrix encoded alone: no stack padding), of the paper's
    container (host numpy) on the four attention matrices alone, each
    decoded back by its block-parallel oracle; H(E), the fitted alpha and
    ``theory.compression_limit_bits`` per matrix, with the paper's one
    mantissa bit (its FP4.67 form) and with e4m3's three."""
    layer = params_fr["units"]["pos0"]
    leaves = [(f"attn.{k}", layer["attn"][k].layer(0))
              for k in ("wq", "wk", "wv", "wo")]
    leaves += [(f"mlp.{k}", layer["mlp"][k].layer(0))
               for k in ("wi_gate", "wi_up", "wo")]
    leaves.append(("embed", params_fr["embed"]))
    rows = []
    for name, ct in leaves:
        a, m = ct.arrays, ct.meta
        bits = fixedrate.decode_plain(a["codes"], a["escapes"], a["table"],
                                      a["signmant"], n_elem=m.n_elem)
        tpu = tpu_format.encode(bits)
        tpu_b = sum(t.numel() * t.element_size() for t in (
            tpu.payload, tpu.signmant, tpu.lj_limit, tpu.first_lj,
            tpu.offset, tpu.perm))
        fr = fixedrate.encode(bits)
        if not torch.equal(fr.codes, a["codes"][:fr.codes.numel()]):
            fail(f"phase 16: {name}'s FR container is not re-encoded alike")
        del tpu
        host = bits.cpu().numpy()
        hist = stats.exponent_histogram(host)
        alpha = theory.geometric_fit_alpha(hist)
        row = dict(name=name, shape=list(m.shape), n=m.n_elem,
                   tpu=tpu_b / m.n_elem,
                   fixedrate=fr.ratio, esc_count=fr.esc_count,
                   entropy_bits=stats.shannon_entropy(hist), alpha=alpha,
                   limit_bits=theory.compression_limit_bits(alpha),
                   limit_bits_e4m3=theory.compression_limit_bits(alpha, 3),
                   paper=None, paper_encode_s=None, paper_decode_s=None)
        if name.startswith("attn."):
            t0 = time.perf_counter()
            c = paper_format.encode(host)
            row["paper_encode_s"] = time.perf_counter() - t0
            row["paper"] = c.ratio
            t0 = time.perf_counter()
            back = paper_format.decode_blockparallel(c)
            row["paper_decode_s"] = time.perf_counter() - t0
            if not np.array_equal(back.reshape(-1), host):
                fail(f"phase 16: the paper container of {name} does not "
                     f"decode back bit-exactly")
        rows.append(row)
        del bits, host, fr
    return rows


def fixedrate_phase(torch, serve, EngineConfig, kernels, cfg, seed, prompts,
                    want_tokens, sizes):
    """Phase 16's serve run (module docstring) on ``cfg`` with phase 5's
    ``prompts``: ``want_tokens`` are phases 5's and 6's token lists (by
    name), ``sizes`` their trees' megabytes -> (measurements, launches,
    the FR tree)."""
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    gib = 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params_fr, _, report, enc_s = serve.build_params(
        cfg, seed, "fixedrate", device="cuda", baseline=False)
    fp8_b, fr_b = report["fp8_bytes"], report["compressed_bytes"]
    built = dict(encode_s=enc_s, fr_mb=fr_b / 1e6, fp8_mb=fp8_b / 1e6,
                 saved_pct=100 * (1 - fr_b / fp8_b),
                 build_peak_gib=torch.cuda.max_memory_allocated() / gib,
                 fr_resident_gib=(torch.cuda.memory_allocated() - base_mem)
                 / gib, tpu_mb=sizes["tpu_mb"])
    if fp8_b / 1e6 != sizes["fp8_mb"]:
        fail(f"phase 16: the FR tree's fp8 bytes {fp8_b} are not phase 5's "
             f"({sizes['fp8_mb']} MB): other weights")
    log(f"phase 16 weights: {report['n_compressed']} tensors, fp8 "
        f"{fp8_b / 1e6:.1f} MB -> ECF8-FR {fr_b / 1e6:.1f} MB "
        f"({built['saved_pct']:.2f}% saved; ECF8-TPU {sizes['tpu_mb']:.1f} "
        f"MB, {100 * (1 - sizes['tpu_mb'] / sizes['fp8_mb']):.2f}% saved), "
        f"streamed build and encode {enc_s:.1f}s, FR tree resident "
        f"{built['fr_resident_gib']:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    b1.launches = b3.launches = b2.launches = b4.launches = 0
    b1.launches_by_dtype.clear()
    done, eng, dt = serve.serve(params_fr, cfg, EngineConfig(
        max_batch=4, max_len=1024), prompts, 32)
    launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                "kv_page_decode": b3.launches,
                "fused_decode_matmul": b2.launches}
    n = sum(len(r.out_tokens) for r in done)
    m = dict(step_ms=eng.decode_seconds / eng.steps * 1e3, steps=eng.steps,
             tok_s=n / dt, wall_s=dt, prefill_s=eng.prefill_seconds,
             peak_gib=torch.cuda.max_memory_allocated() / gib)
    log(f"phase 16 (ECF8-FR, paged): {n} tokens in {dt:.2f}s, "
        f"{m['tok_s']:.1f} tok/s, {eng.steps} decode steps at "
        f"{m['step_ms']:.1f} ms/step, prefill {eng.prefill_seconds:.2f}s, "
        f"peak device memory {m['peak_gib']:.2f} GiB; launches {launches}")
    if not all(r.done and len(r.out_tokens) == 32 for r in done):
        fail("phase 16: unfinished requests")
    if b1.launches or b2.launches or b3.launches or not b4.launches:
        fail(f"phase 16: launches {launches}; expected flash_fwd alone (an "
             f"ECF8-FR weight decodes without a kernel)")
    got = [r.out_tokens for r in done]
    for tag, want in want_tokens.items():
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if bad:
            fail(f"phase 16: ECF8-FR tokens differ from {tag}'s in requests "
                 f"{bad}")
    log(f"lossless: ECF8-FR greedy tokens IDENTICAL to "
        f"{' and '.join(want_tokens)}; decode step {m['step_ms']:.1f} ms")
    del eng
    return dict(built=built, **{"16": m}), launches, params_fr


def llama_phase(torch, np, serve, EngineConfig, kernels, cfg, seed):
    """Phase 17 (module docstring) on ``cfg`` -> (measurements, launches
    of 17a, 17b and 17d).  ``kernels`` maps name -> wrapper (``run``)
    whose launch counts the phase reads."""
    b1, b3, b2, b4 = (kernels[k] for k in (
        "ecf8_decode", "kv_page_decode", "fused_decode_matmul", "flash_fwd"))
    gib = 2 ** 30
    n_nope = sum(cfg.layer_kind(i) == "nope" for i in range(cfg.n_layers))
    # 4 attention, the router, 3 expert and 3 shared-expert weights a
    # layer, the tied embedding twice
    per_pass = 11 * cfg.n_layers + 2
    # flash in every layer of a prompt the window covers, in the NoPE
    # layers alone (local_attention in the local ones) past it
    want_b4 = sum(cfg.n_layers if n <= cfg.local_window else n_nope
                  for n in LLAMA_PROMPTS)
    log(f"phase 17: {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, qk-norm "
        f"{cfg.qk_norm}, pattern {cfg.pattern}, window {cfg.local_window}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of width {cfg.moe_d_ff} + "
        f"{cfg.n_shared_experts} shared, capacity factor "
        f"{cfg.capacity_factor}, vocab {cfg.vocab_size}, tied "
        f"{cfg.tie_embeddings}, {cfg.dtype}), {cfg.n_layers} layers "
        f"({n_nope} NoPE); prompts {LLAMA_PROMPTS}, max_batch 4, max_len "
        f"{LLAMA_MAX_LEN}, page 16, 32 new tokens")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in LLAMA_PROMPTS]
    base_mem = torch.cuda.memory_allocated()

    def run(tag, params, compressed, **extra):
        torch.cuda.reset_peak_memory_stats()
        b1.launches = b3.launches = b2.launches = b4.launches = 0
        b1.launches_by_dtype.clear()
        b3.launches_by_path.clear()
        eng = serve.GenerationEngine(params, cfg, config=EngineConfig(
            max_batch=4, max_len=LLAMA_MAX_LEN, page_size=16, **extra),
            device="cuda")
        done = [serve.Request(prompt=p, max_new_tokens=32) for p in prompts]
        for r in done:
            eng.submit(r)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(r.done and len(r.out_tokens) == 32 for r in done) or any(
                not 0 <= x < cfg.vocab_size for r in done
                for x in r.out_tokens):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
        launches = {"ecf8_decode": b1.launches, "flash_fwd": b4.launches,
                    "kv_page_decode": b3.launches,
                    "fused_decode_matmul": b2.launches,
                    "ecf8_decode_by_dtype": {str(k): v for k, v in
                                             b1.launches_by_dtype.items()}}
        n = sum(len(r.out_tokens) for r in done)
        passes = len(prompts) + eng.steps
        m = dict(step_ms=eng.decode_seconds / eng.steps * 1e3,
                 steps=eng.steps, passes=passes, tok_s=n / dt, wall_s=dt,
                 prefill_s=eng.prefill_seconds, cache_mode=eng.cache_mode,
                 resident_gib=(torch.cuda.memory_allocated() - base_mem)
                 / gib, peak_gib=torch.cuda.max_memory_allocated() / gib)
        log(f"phase {tag}: {n} tokens in {dt:.2f}s, {m['tok_s']:.1f} tok/s, "
            f"{eng.steps} decode steps at {m['step_ms']:.1f} ms/step, "
            f"prefill {eng.prefill_seconds:.2f}s, peak device memory "
            f"{m['peak_gib']:.2f} GiB; launches {launches}")
        for line in serve.cache_report(eng):
            log(f"  {line}")
        want_b1 = per_pass * passes if compressed else 0
        if (b1.launches != want_b1 or b4.launches != want_b4
                or b2.launches or b3.launches
                or set(b1.launches_by_dtype) - {torch.bfloat16}):
            fail(f"phase {tag}: launches {launches}, expected ecf8_decode "
                 f"{want_b1} (all bf16) and flash_fwd {want_b4}")
        return done, eng, m, launches

    # 17a: the ECF8 tree alone on the card, built a unit at a time
    torch.cuda.reset_peak_memory_stats()
    params_c, _, report, enc_s = serve.build_params(
        cfg, seed, "tpu", device="cuda", baseline=False)
    fp8_b, ecf8_b = report["fp8_bytes"], report["compressed_bytes"]
    built = dict(encode_s=enc_s, fp8_mb=fp8_b / 1e6, ecf8_mb=ecf8_b / 1e6,
                 saved_pct=100 * (1 - ecf8_b / fp8_b),
                 n_compressed=report["n_compressed"],
                 build_peak_gib=torch.cuda.max_memory_allocated() / gib,
                 ecf8_resident_gib=(torch.cuda.memory_allocated()
                                    - base_mem) / gib)
    log(f"phase 17 weights: {report['n_compressed']} tensors, fp8 "
        f"{built['fp8_mb']:.1f} MB -> ECF8 {built['ecf8_mb']:.1f} MB "
        f"({built['saved_pct']:.2f}% saved), streamed build and encode "
        f"{enc_s:.1f}s, build peak {built['build_peak_gib']:.2f} GiB, ECF8 "
        f"tree resident {built['ecf8_resident_gib']:.2f} GiB")
    d17a, e17a, m17a, l17a = run("17a (ECF8, paged)", params_c, True)
    if e17a.cache_mode != "paged":
        fail(f"phase 17a: the cache resolved to {e17a.cache_mode}")
    log(f"phase 17a: ecf8_decode {per_pass} launches a pass (11 x "
        f"{cfg.n_layers} + 2) x {m17a['passes']} passes; flash_fwd "
        f"{want_b4} ({cfg.n_layers} a prompt the window covers, {n_nope} "
        f"past it)")
    del e17a

    # 17d: the monolithic cache, the same tree
    d17d, e17d, m17d, l17d = run("17d (ECF8, monolithic)", params_c, True,
                                 cache_mode="monolithic")
    _, bad = first_divergence(d17a, d17d)
    if bad:
        fail(f"phase 17d tokens differ from 17a's (request, first token "
             f"index): {bad}")
    log("lossless: 17d monolithic greedy tokens IDENTICAL to 17a's")
    del params_c, e17d
    gc.collect()
    torch.cuda.empty_cache()

    # 17b: the fp8 baseline tree alone on the card
    torch.cuda.reset_peak_memory_stats()
    params_fp8, _, _, fp8_s = serve.build_params(cfg, seed, "none",
                                                 device="cuda")
    built["fp8_resident_gib"] = (torch.cuda.memory_allocated()
                                 - base_mem) / gib
    log(f"phase 17b: fp8 baseline tree built in {fp8_s:.1f}s, resident "
        f"{built['fp8_resident_gib']:.2f} GiB")
    d17b, e17b, m17b, l17b = run("17b (fp8 baseline, paged)", params_fp8,
                                 False)
    _, bad = first_divergence(d17a, d17b)
    if bad:
        fail(f"phase 17b: ECF8 tokens differ from the fp8 baseline's "
             f"(request, first token index): {bad}")
    log(f"lossless: llama4 ECF8 greedy tokens IDENTICAL to the fp8 "
        f"baseline's; decode step {m17a['step_ms']:.1f} ms (ECF8) against "
        f"{m17b['step_ms']:.1f} ms (fp8), prefill {m17a['prefill_s']:.2f} "
        f"against {m17b['prefill_s']:.2f} s, peak device memory "
        f"{m17a['peak_gib']:.2f} GiB with the ECF8 tree resident against "
        f"{m17b['peak_gib']:.2f} GiB with the fp8 tree")
    del params_fp8, e17b
    gc.collect()
    torch.cuda.empty_cache()
    return (dict(built=built, **{"17a": m17a, "17b": m17b, "17d": m17d}),
            {"17a": l17a, "17b": l17b, "17d": l17d})


# --------------------------------------------------------------------------
# 21. serving on a mesh of ranks
# --------------------------------------------------------------------------

def _counts(ecf8_decode, flash_fwd, kv_page):
    """This process's launch counters of B1, B3 (by path) and B4 (with its
    q_base launches)."""
    return dict(ecf8_decode=ecf8_decode.run.launches,
                flash_fwd=flash_fwd.run.launches,
                flash_fwd_q_base=flash_fwd.run.launches_q_base,
                kv_page_decode=kv_page.run.launches,
                kv_page_decode_by_path=dict(kv_page.run.launches_by_path))


def _zero(ecf8_decode, flash_fwd, kv_page):
    ecf8_decode.run.launches = flash_fwd.run.launches = 0
    flash_fwd.run.launches_q_base = kv_page.run.launches = 0
    kv_page.run.launches_by_path.clear()


def serve_late(serving, params, cfg, ecfg, prompts, new: int, dev,
               late: int, after: int):
    """Serve ``prompts`` greedily as ``serve.serve`` does, but submit the
    last ``late`` of them ``after`` engine steps into the run at priority 1
    (the rest at 0): their admission preempts a running request when its
    shard's pages cannot hold them (the reference scheduler's priority
    preemption) -> (requests in prompt order, engine, seconds)."""
    import torch
    eng = serving.GenerationEngine(params, cfg, config=ecfg, device=dev)
    reqs = [serving.Request(prompt=p, max_new_tokens=new,
                            priority=int(i >= len(prompts) - late))
            for i, p in enumerate(prompts)]
    for r in reqs[:len(reqs) - late]:
        eng.submit(r)
    t0 = time.perf_counter()
    for _ in range(after):
        eng.step()
    for r in reqs[len(reqs) - late:]:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize(dev)
    return reqs, eng, time.perf_counter() - t0


def mesh_rank(rank, world, dev, spec):
    """One rank of phase 21 (a process of its own, started by
    ``launch.mesh.spawn``): qwen3-8b's ECF8 and fp8 trees built on this
    rank's card from the seed, served on the mesh runs of ``spec["runs"]``
    with every rank's counts and timings, rank 0 also alone; the small
    f32 model on ``--mesh D`` and alone; B3 on this rank's share of a cold
    pool; the compressed all-gather of qwen3's wi_gate beside a raw fp8
    gather; the stat merge timed -> a dict of plain values."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.core import fp8, store
    from repro_torch.kernels import ecf8_decode, flash_fwd
    from repro_torch.kvcache import codec
    from repro_torch.kvcache import kernels as kv_page
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import serve
    from repro_torch.models import decode_sharded as DS
    from repro_torch.models import model as M
    from repro_torch.runtime import collectives
    from repro_torch import serving
    from repro_torch.runtime.monitor import KVCacheMonitor
    from repro_torch.serving import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = dist.get_backend() == "nccl"
    dtype_mesh = "cuda" if nccl else "cpu"
    # every rank makes the meshes in the same order (each is a collective)
    meshes = {dims: MESH.make_mesh(*dims, dtype_mesh)
              for dims in sorted({tuple(r["mesh"]) for r in spec["runs"]}
                                 | {(world, 1), (world // 2, 2)})}

    def sync():
        torch.cuda.synchronize(dev)

    out = dict(rank=rank, device=torch.cuda.get_device_name(dev),
               backend=dist.get_backend(), runs={})
    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=spec["layers"])
    torch.cuda.reset_peak_memory_stats(dev)
    trees = {}
    trees["ecf8"], trees["fp8"], report, enc_s = serve.build_params(
        cfg, spec["seed"], "tpu", device=dev)
    out["encode_s"] = enc_s
    out["tree_mb"] = dict(ecf8=report["compressed_bytes"] / 1e6,
                          fp8=report["fp8_bytes"] / 1e6)
    prompts = spec["prompts"]
    base = dict(max_batch=spec["max_batch"], max_len=spec["max_len"])
    for tag, run in [(r["tag"], r) for r in spec["runs"]]:
        mesh = meshes[tuple(run["mesh"])]
        mon = KVCacheMonitor()
        ecfg = EngineConfig(**base, **run["engine"], mesh=mesh,
                            kv_monitor=mon)
        _zero(ecf8_decode, flash_fwd, kv_page)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        if run.get("late"):
            done, eng, dt = serve_late(serving, trees[run["tree"]], cfg,
                                       ecfg, prompts, spec["new"], dev,
                                       *run["late"])
        else:
            done, eng, dt = serve.serve(trees[run["tree"]], cfg, ecfg,
                                        prompts, spec["new"], device=dev)
        dist.barrier()
        pc = eng.paged
        sw = pc.swap.stats() if pc is not None and pc.swap is not None \
            else {}
        out["runs"][tag] = dict(
            tokens=[r.out_tokens for r in done], wall_s=dt,
            steps=eng.steps, decode_s=eng.decode_seconds,
            prefill_s=eng.prefill_seconds, gather_s=eng.gather_seconds,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            launches=_counts(ecf8_decode, flash_fwd, kv_page),
            checksum=list(eng.weights_checksum),
            preempted=eng.scheduler.n_preempted,
            resumed=eng.scheduler.n_resumed,
            cold_compressed=pc.n_compressed if pc is not None else 0,
            peak_pages_per_shard=mon.peak_per_shard(),
            peak_swap_bytes_per_shard=mon.peak_per_shard(
                "swap_bytes_per_shard"),
            swap_out_bytes=sw.get("swap_out_bytes_total", 0),
            pages_per_shard=pc.pages_per_shard if pc is not None else None,
            cold_per_shard=pc.cold_per_shard if pc is not None else None,
            n_chunks=eng.n_chunks, free_lists=(pc._free if pc else None),
            drained=(pc is None or (not pc._slot_pages
                                    and not pc._cold_bytes
                                    and (pc.swap is None
                                         or not len(pc.swap)))))
        if rank == 0:
            log(f"rank 0: {tag} served in {dt:.1f}s ({eng.steps} steps)")
        del eng, done
        torch.cuda.empty_cache()
    # the one-rank run of 21a's requests (rank 0 alone), the comparison
    solo = spec["solo"]
    if rank == 0:
        ecfg = EngineConfig(**base, **solo["engine"])
        done, eng, dt = serve_late(serving, trees["ecf8"], cfg, ecfg,
                                   prompts, spec["new"], dev, *solo["late"])
        out["solo"] = dict(tokens=[r.out_tokens for r in done], wall_s=dt,
                           steps=eng.steps, decode_s=eng.decode_seconds)
        del eng, done
    dist.barrier()
    del trees
    torch.cuda.empty_cache()

    # the small f32 model: --mesh D (paged-compressed under pressure) and
    # the same requests on one rank; and --mesh 1x2
    small = dataclasses.replace(
        get("qwen3-8b"), name="qwen3-small", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype="float32")
    p_small, _ = store.compress_tree(
        M.init_params(small, spec["seed"], "cpu"), min_elems=4096,
        out_dtype="float32")
    p_small = to_device(p_small, dev, store)
    sp = serve.make_prompts(small, 8, spec["seed"], lo=4, hi=40)
    # two slots a batch shard on 8 raw pages (shard 0's 7 hold the longest
    # request) and 2 cold slots: the runs preempt and go cold
    skw = dict(max_batch=2 * world, max_len=64, page_size=8,
               compress_cold=True, n_pages=8 * world, n_cold_slots=2 * world,
               swap_bytes=-1)
    small_runs = {}
    for dims in ((world, 1), (world // 2, 2)):
        done, eng, _ = serve.serve(p_small, small, EngineConfig(
            **skw, mesh=meshes[dims]), sp, 12, device=dev)
        small_runs[f"{dims[0]}x{dims[1]}"] = dict(
            tokens=[r.out_tokens for r in done],
            preempted=eng.scheduler.n_preempted,
            cold=eng.paged.n_compressed)
    if rank == 0:
        done, eng, _ = serve.serve(p_small, small, EngineConfig(**skw), sp,
                                   12, device=dev)
        small_runs["one"] = dict(tokens=[r.out_tokens for r in done],
                                 preempted=eng.scheduler.n_preempted,
                                 cold=eng.paged.n_compressed)
    out["small_f32"] = small_runs
    dist.barrier()

    # B3 on this rank's share of a cold pool: 48 bf16 pages at qwen3-8b's
    # page shape, split over the ranks, each decoded where it lies
    gen = torch.Generator().manual_seed(spec["seed"] + 5)
    n_elem = cfg.n_kv_heads * 16 * cfg.hd
    n_pages = 48 // world * world
    pages = [(torch.randn(n_elem, generator=gen) * float(10 ** (i % 5 - 2)))
             .to(torch.bfloat16) for i in range(n_pages)]
    cps = [codec.encode_page(p) for p in pages]
    stride = -(-codec.sym_per_lane(n_elem) * codec.plane_spec(
        "bfloat16")[0] // 8)
    pay = torch.zeros((n_pages, stride, codec.LANES), dtype=torch.uint8)
    for i, c in enumerate(cps):
        pay[i, : c.stride] = torch.from_numpy(c.payload)
    whole = [t.to(dev) for t in (
        pay, torch.from_numpy(np.stack([c.signmant for c in cps])),
        torch.from_numpy(np.stack([c.tables() for c in cps])),
        torch.from_numpy(np.stack([c.perm for c in cps])))]
    per = n_pages // world
    mine = [t[rank * per:(rank + 1) * per].contiguous() for t in whole]
    before = kv_page.run.launches_by_path["sharded"]
    got = kv_page.decode_pages_sharded(*mine, meshes[(world, 1)],
                                       n_elem=n_elem, dtype_name="bfloat16")
    rows = collectives.gather_rows(got.view(torch.uint8),
                                   meshes[(world, 1)], "data")
    want = kv_page.run(*whole, n_elem=n_elem, dtype_name="bfloat16")
    sync()
    out["b3_sharded"] = dict(
        bit_exact=bool(torch.equal(rows.reshape(n_pages, -1),
                                   want.view(torch.uint8))),
        launches=kv_page.run.launches_by_path["sharded"] - before,
        pages_a_rank=per,
        ms=cuda_ms(torch, lambda: kv_page.decode_pages_sharded(
            *mine, None, n_elem=n_elem, dtype_name="bfloat16"), 20),
        plain_ms=cuda_ms(torch, lambda: kv_page.plain(
            *mine, n_elem=n_elem, dtype_name="bfloat16"), 3),
        bound_ms=(sum(t.numel() * t.element_size() for t in mine)
                  + got.numel() * 2) / H100_BYTES_PER_S * 1e3)

    # the stat merge of one decode layer at a data group's rows, timed on
    # the model axis of the largest mesh that has one
    mm = [dims for dims in meshes if dims[1] > 1]
    if mm:
        mesh = meshes[max(mm)]
        b_loc = spec["max_batch"] // mesh.mesh.shape[0]
        acc = torch.randn((b_loc, cfg.n_heads, 1, cfg.hd), device=dev)
        m = torch.randn((b_loc, cfg.n_heads, 1), device=dev)
        l = torch.rand((b_loc, cfg.n_heads, 1), device=dev) + 1
        DS._merge_stats(acc, m, l, mesh)
        sync()
        t0 = time.perf_counter()
        for _ in range(20):
            DS._merge_stats(acc, m, l, mesh)
        sync()
        out["stat_merge_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        out["stat_merge_mesh"] = list(mesh.mesh.shape)

    # the ECF8-FR compressed all-gather of qwen3-8b's wi_gate (4096 x
    # 12288 fp8) over the ranks, beside a raw fp8 gather of the same rows
    mesh = meshes[(world, 1)]
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 7)
    w = torch.randn((cfg.d_model, cfg.d_ff), generator=g, device=dev)
    bits = fp8.cast_to_fp8_bits(w.mul_(cfg.d_model ** -0.5))
    del w
    table, cap = collectives.calibrate(bits, margin=1.3)
    cap_shard = max(2, math.ceil(cap / world * 1.5))
    cap_shard += cap_shard % 2
    rows_a = bits.shape[0] // world
    local = bits[rank * rows_a:(rank + 1) * rows_a].contiguous()
    gather = collectives.compressed_all_gather(mesh, "data")
    full, overflow = gather(local, table, cap_shard)
    sync()
    exact = bool(torch.equal(full, bits)) and not overflow

    def timed(fn, reps=5):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    fr_ms = timed(lambda: gather(local, table, cap_shard))
    raw_out = [torch.empty_like(local) for _ in range(world)]
    group = mesh.get_group("data")
    if nccl:
        raw_buf = torch.empty_like(bits)
        raw_ms = timed(lambda: dist.all_gather_into_tensor(raw_buf, local,
                                                           group=group))
    else:
        raw_ms = timed(lambda: collectives.gather_rows(local, mesh, "data"))
    esc = int((~torch.isin(fp8.exponent_field(local).to(torch.int64),
                           table.to(torch.int64))).sum())
    n_loc = local.numel()
    wire = (n_loc // 4 + cap_shard // 2 + n_loc // 2) / n_loc
    out["fr_gather"] = dict(
        bit_exact=exact, overflow=overflow, shape=list(bits.shape),
        escape_share=esc / n_loc, cap_shard=cap_shard,
        wire_bytes_per_elem=wire,
        analytic_bytes_per_elem=collectives.wire_bytes_per_elem(
            esc / n_loc), raw_bytes_per_elem=1.0, fr_ms=fr_ms,
        raw_ms=raw_ms, raw_call=("all_gather_into_tensor" if nccl
                                 else "all_gather over gloo"))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del raw_out
    return out


def mesh_phase(torch, np, MESH, serve, get, n_ranks: int, layers: int,
               seed: int, flash_fwd, gen, flush):
    """Phase 21 on ``n_ranks`` ranks (NCCL, one a card, or gloo ranks
    sharing one card) -> (measurements, per-rank launches of the mesh
    runs).  Fails on any gate."""
    nccl = torch.cuda.device_count() >= n_ranks and n_ranks > 1 \
        and torch.cuda.device_count() > 1
    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=layers)
    n_req = MESH_REQUESTS if nccl else 8
    max_batch = MESH_BATCH if nccl else 4
    prompts = serve.make_prompts(cfg, n_req, seed, lo=64, hi=513)
    # a shard's two slots on 32 raw pages (shard 0's 31 hold the longest
    # request, 31 pages) and 2 cold slots: two long requests preempt
    pools = dict(compress_cold=True, n_pages=MESH_SHARD_PAGES * n_ranks,
                 n_cold_slots=MESH_SHARD_COLD * n_ranks, swap_bytes=-1)
    d_model = (n_ranks // 2, 2)
    # 21a / 21d: a quarter of the requests arrive 8 steps in at priority 1
    late = (n_req // 4, 8)
    runs = [dict(tag="21a", mesh=(n_ranks, 1), tree="ecf8", engine=pools,
                 late=late),
            dict(tag="21b", mesh=d_model, tree="ecf8", engine={}),
            dict(tag="21c", mesh=(n_ranks, 1), tree="ecf8",
                 engine=dict(prefill_chunk=CHUNK, prefill_budget=CHUNK)),
            dict(tag="21d", mesh=(n_ranks, 1), tree="fp8", engine=pools,
                 late=late)]
    spec = dict(layers=layers, seed=seed, prompts=prompts,
                max_batch=max_batch, max_len=1024, new=32, runs=runs,
                solo=dict(engine=pools, late=late))
    log(f"phase 21: {n_ranks} ranks over "
        f"{'NCCL, one card each' if nccl else 'gloo on one card'}; "
        f"qwen3-8b at full width, {layers} layers, {n_req} requests "
        f"(prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
        f"tokens), max_batch {max_batch}, 32 new tokens; runs "
        f"{[(r['tag'], r['mesh'], r['tree'], r['engine']) for r in runs]}")

    # B4 with q_base: one model rank's rows of a sharded prefill at
    # qwen3-8b's heads (rows [T/2, T) and [3T/4, T) over T keys), against
    # the plain version and, bit for bit, against the same rows of the
    # unsharded launch
    qb = {}
    for T, part in ((1024, 2), (1024, 4), (452, 2)):
        base = T - T // part
        qb[f"T{T}_base{base}"] = check_flash(
            torch, flash_fwd, T // part, gen, flush, q_base=base, Tk=T)
    q = torch.randn((1, 32, 1024, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    k = torch.randn((1, 8, 1024, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((1, 8, 1024, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    full = flash_fwd.run(q, k, v)
    shards = torch.cat([flash_fwd.run(q[:, :, i:i + 256].contiguous(), k, v,
                                      q_base=i) for i in range(0, 1024, 256)],
                       dim=2)
    if not torch.equal(full, shards):
        fail("flash_fwd: four q_base shards differ from the unsharded "
             "launch")
    log("flash_fwd q_base: the four 256-row shards of T = 1024 (q_base 0, "
        "256, 512, 768) concatenate to the unsharded output bit for bit")
    del q, k, v, full, shards
    gc.collect()
    torch.cuda.empty_cache()

    # which products give a row other bits at 2 rows than at max_batch
    # rows (a data group's batch against one card's): the weight products
    # at qwen3-8b's shapes and the decode attention over a slot's gathered
    # history (max_len 1024 positions, 300-1000 of them live)
    from repro_torch.models.layers import decode_attention
    split = {}
    x = torch.randn((max_batch, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    for name, (K, N) in (("wq", (cfg.d_model, cfg.n_heads * cfg.hd)),
                         ("wk", (cfg.d_model, cfg.n_kv_heads * cfg.hd)),
                         ("wi_gate", (cfg.d_model, cfg.d_ff)),
                         ("unembed", (cfg.d_model, cfg.vocab_size))):
        w = (torch.randn((K, N), generator=gen, device="cuda")
             * K ** -0.5).to(torch.bfloat16)
        split[name] = bool(torch.equal((x @ w)[:2], x[:2] @ w))
    wo = (torch.randn((cfg.d_ff, cfg.d_model), generator=gen, device="cuda")
          * cfg.d_ff ** -0.5).to(torch.bfloat16)
    h = torch.randn((max_batch, 1, cfg.d_ff), generator=gen,
                    device="cuda").to(torch.bfloat16)
    split["wo_mlp"] = bool(torch.equal((h @ wo)[:2], h[:2] @ wo))
    q = torch.randn((max_batch, cfg.n_heads, 1, cfg.hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    kv = torch.randn((max_batch, cfg.n_kv_heads, 1024, cfg.hd),
                     generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.arange(max_batch, device="cuda") * 97 % 700 + 300
    split["decode_attention"] = bool(torch.equal(
        decode_attention(q, kv, kv, kv_len=lens)[:2],
        decode_attention(q[:2], kv[:2], kv[:2], kv_len=lens[:2])))
    log(f"bf16 products whose first 2 rows keep their bits at {max_batch} "
        f"rows (True) or not: {split}")
    del x, w, wo, h, q, kv
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = MESH.spawn(mesh_rank, n_ranks, spec, device="cuda",
                     backend="nccl" if nccl else "gloo", timeout=900)
    wall = time.perf_counter() - t0
    r0 = res[0]
    log(f"phase 21 ranks: {n_ranks} x {r0['device']} over "
        f"{r0['backend']}, spawn + build + runs {wall:.1f}s; trees ECF8 "
        f"{r0['tree_mb']['ecf8']:.1f} MB, fp8 {r0['tree_mb']['fp8']:.1f} MB "
        f"a rank, encoded in {r0['encode_s']:.1f}s")
    sums = {tuple(r["runs"]["21a"]["checksum"]) for r in res}
    if len(sums) != 1:
        fail(f"phase 21: the ranks' ECF8 trees differ: {sums}")
    log(f"every rank's ECF8 tree checksum equal: {sums.pop()}")
    for tag in ("21a", "21b", "21c", "21d"):
        toks = [r["runs"][tag]["tokens"] for r in res]
        if any(t != toks[0] for t in toks):
            fail(f"phase {tag}: the ranks' tokens differ")
        if any(r["runs"][tag]["free_lists"] != res[0]["runs"][tag][
                "free_lists"] for r in res):
            fail(f"phase {tag}: the ranks' free lists differ")
        if not all(r["runs"][tag]["drained"] for r in res):
            fail(f"phase {tag}: a rank's pools or swap did not drain")
        if not all(len(t) == 32 and all(0 <= x < cfg.vocab_size for x in t)
                   for t in toks[0]):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
    runs_out = {}
    for tag in ("21a", "21b", "21c", "21d"):
        per = [r["runs"][tag] for r in res]
        steps = per[0]["steps"]
        n_tok = sum(len(t) for t in per[0]["tokens"])
        runs_out[tag] = dict(
            mesh=[r for r in runs if r["tag"] == tag][0]["mesh"],
            steps=steps, tok_s=n_tok / per[0]["wall_s"],
            step_ms=[p["decode_s"] / max(steps, 1) * 1e3 for p in per],
            token_gather_ms=[p["gather_s"] / max(steps, 1) * 1e3
                             for p in per],
            prefill_s=[p["prefill_s"] for p in per],
            peak_gib=[p["peak_gib"] for p in per],
            launches_a_step={k: [p["launches"][k] / max(steps, 1)
                                 for p in per]
                             for k in ("ecf8_decode", "flash_fwd",
                                       "kv_page_decode")},
            launches=[p["launches"] for p in per],
            preempted=per[0]["preempted"], resumed=per[0]["resumed"],
            cold_compressed=per[0]["cold_compressed"],
            peak_pages_per_shard=per[0]["peak_pages_per_shard"],
            peak_swap_bytes_per_shard=per[0]["peak_swap_bytes_per_shard"],
            swap_out_bytes=per[0]["swap_out_bytes"],
            pages_per_shard=per[0]["pages_per_shard"],
            cold_per_shard=per[0]["cold_per_shard"],
            n_chunks=per[0]["n_chunks"])
        log(f"{tag} mesh {runs_out[tag]['mesh']}: "
            f"{json.dumps(runs_out[tag])}")
    a = runs_out["21a"]
    if res[0]["runs"]["21a"]["tokens"] != res[0]["runs"]["21d"]["tokens"]:
        fail("phase 21: ECF8 tokens differ from the fp8 tree's on the mesh")
    log("lossless on the mesh: 21a's ECF8 greedy tokens IDENTICAL to 21d's "
        "(fp8 tree, same mesh and pools)")
    b3 = [p["launches"]["kv_page_decode_by_path"].get("sharded", 0)
          for p in (r["runs"]["21a"] for r in res)]
    if not all(b3):
        fail(f"phase 21a: B3 not launched on the sharded path on every "
             f"rank: {b3}")
    if not all(x for x in a["launches_a_step"]["ecf8_decode"]):
        fail("phase 21a: B1 not launched on every rank")
    q_base = [p["launches"]["flash_fwd_q_base"]
              for p in (r["runs"]["21b"] for r in res)]
    if not any(q_base):
        fail(f"phase 21b: no B4 launch with q_base != 0: {q_base}")
    if not (a["cold_compressed"] and (a["preempted"] or a["swap_out_bytes"])):
        fail(f"phase 21a: the cold pool or the swap tier went unused: {a}")
    solo = r0["solo"]["tokens"]
    same = {tag: sum(x == y for x, y in zip(res[0]["runs"][tag]["tokens"],
                                            solo))
            for tag in ("21a", "21b", "21c")}
    one_ms = r0["solo"]["decode_s"] / max(r0["solo"]["steps"], 1) * 1e3
    log(f"tokens on the mesh against rank 0 alone (same requests and "
        f"pools, bf16; reported, not gated): requests identical {same} of "
        f"{len(solo)}; one rank {one_ms:.1f} ms/step at batch {max_batch}")
    sm = r0["small_f32"]
    key, key_m = f"{n_ranks}x1", f"{n_ranks // 2}x2"
    if sm[key]["tokens"] != sm["one"]["tokens"]:
        fail(f"small f32 model on --mesh {n_ranks}: tokens differ from one "
             f"rank's")
    if not (sm[key]["preempted"] and sm[key]["cold"]):
        fail(f"small f32 mesh run did not preempt or go cold: {sm[key]}")
    same_m = sm[key_m]["tokens"] == sm["one"]["tokens"]
    log(f"small f32 model (2 layers, d 256) on --mesh {n_ranks}, "
        f"paged-compressed under pressure ({sm[key]['preempted']} "
        f"preemptions, {sm[key]['cold']} pages cold): tokens IDENTICAL to "
        f"one rank's; --mesh {key_m} "
        f"{'IDENTICAL' if same_m else 'differs (reported, not gated)'}")
    b3s = [r["b3_sharded"] for r in res]
    if not all(b["bit_exact"] and b["launches"] for b in b3s):
        fail(f"decode_pages_sharded: {b3s}")
    log(f"decode_pages_sharded: {b3s[0]['pages_a_rank']} pages a rank, "
        f"gathered rows bit-exact against the whole pool's decode; "
        f"{json.dumps(b3s[0])}")
    fr = [r["fr_gather"] for r in res]
    if not all(f["bit_exact"] for f in fr):
        fail(f"compressed_all_gather not bit-exact: {fr}")
    log(f"21e compressed_all_gather of wi_gate {fr[0]['shape']} over "
        f"{n_ranks} ranks: bit-exact, escape share "
        f"{fr[0]['escape_share']:.4f}, wire {fr[0]['wire_bytes_per_elem']:.4f}"
        f" bytes an element (analytic {fr[0]['analytic_bytes_per_elem']:.4f};"
        f" raw fp8 1.0), {fr[0]['fr_ms']:.3f} ms (encode + gather + decode) "
        f"vs raw {fr[0]['raw_call']} {fr[0]['raw_ms']:.3f} ms")
    if "stat_merge_ms" in r0:
        log(f"stat merge (one decode layer, mesh {r0['stat_merge_mesh']}): "
            f"{r0['stat_merge_ms']:.3f} ms a call")
    out = dict(ranks=n_ranks, backend=r0["backend"], layers=layers,
               runs=runs_out, same_as_one_rank=same,
               one_rank_step_ms=one_ms,
               b3_sharded=b3s[0], fr_gather=fr[0],
               stat_merge_ms=r0.get("stat_merge_ms"),
               q_base_checks=qb, rows_keep_bits=split,
               peak_gib=[r["peak_gib"] for r in res],
               wall_s=wall)
    return out


# --------------------------------------------------------------------------
# 22. the mixture-of-experts and recurrent stacks on a mesh of ranks
# --------------------------------------------------------------------------

def moe_mesh_rank(rank, world, dev, spec):
    """One rank of phase 22 (a process of its own, started by
    ``launch.mesh.spawn``): for each group of ``spec["groups"]`` the
    model's trees built on this rank's card from the seed, placed for the
    group's mesh (on a model axis this rank's experts alone), served on
    that mesh run by run with this rank's counts and timings, rank 0 also
    alone where the tree is whole; then the group's exchange timed at its
    decode shape: the two ``all_to_all`` of a MoE layer on a model axis,
    the routing weights' gather over ``data`` without one -> a dict of
    plain values."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import ecf8_decode, flash_fwd
    from repro_torch.kernels import fused_decode_matmul as fused
    from repro_torch.kvcache import kernels as kv_page
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import serve
    from repro_torch.runtime import collectives
    from repro_torch.runtime.sharding import expert_rows
    from repro_torch.serving import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = dist.get_backend() == "nccl"
    meshes = {dims: MESH.make_mesh(*dims, "cuda" if nccl else "cpu")
              for dims in sorted({tuple(g["mesh"]) for g in spec["groups"]})}
    # the MoE layers reach the exchange through the module attribute
    a2a = {"calls": 0}
    exchange = collectives.all_to_all

    def counted(x, mesh, axis="model"):
        a2a["calls"] += 1
        return exchange(x, mesh, axis)

    collectives.all_to_all = counted
    gib = 2 ** 30

    def sync():
        torch.cuda.synchronize(dev)

    def timed(fn, reps=20):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3

    out = dict(rank=rank, device=torch.cuda.get_device_name(dev),
               backend=dist.get_backend(), groups={})
    for g in spec["groups"]:
        cfg = dataclasses.replace(get(g["arch"]), n_layers=g["layers"])
        dims = tuple(g["mesh"])
        mesh = meshes[dims]
        n_model = dims[1]
        res = dict(builds=[], runs={})
        for build in g["builds"]:
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
            fmt = "tpu" if "ecf8" in build else "none"
            served, base, report, build_s = serve.build_params(
                cfg, spec["seed"], fmt, device=dev,
                baseline="fp8" in build, mesh=mesh)
            trees = {"ecf8": served if fmt == "tpu" else None, "fp8": base}
            # one layer's expert leaf (a stacked tensor leads with layers)
            wi = (served if fmt == "tpu" else base)["units"]["pos0"]
            wi = tuple(wi["moe"]["wi_gate"].shape)[-3:] if "moe" in wi \
                else None
            res["builds"].append(dict(
                trees=build, build_s=build_s,
                resident_gib=(torch.cuda.memory_allocated(dev) - before)
                / gib,
                build_peak_gib=torch.cuda.max_memory_allocated(dev) / gib,
                fp8_mb=(report or {}).get("fp8_bytes", 0) / 1e6,
                ecf8_mb=(report or {}).get("compressed_bytes", 0) / 1e6,
                expert_shape=list(wi) if wi is not None else None))
            for run in g["runs"]:
                if run["tree"] not in build:
                    continue
                tree = trees[run["tree"]]
                ecfg = EngineConfig(max_batch=g["max_batch"],
                                    max_len=g["max_len"], mesh=mesh,
                                    **run["engine"])
                _zero(ecf8_decode, flash_fwd, kv_page)
                ecf8_decode.run.launches_by_dtype.clear()
                fused.run.launches = 0
                a2a["calls"] = 0
                torch.cuda.reset_peak_memory_stats(dev)
                dist.barrier()
                done, eng, dt = serve.serve(tree, cfg, ecfg, g["prompts"],
                                            g["new"], device=dev)
                dist.barrier()
                launches = _counts(ecf8_decode, flash_fwd, kv_page)
                launches["fused_decode_matmul"] = fused.run.launches
                launches["ecf8_decode_by_dtype"] = {
                    str(k): v for k, v in
                    ecf8_decode.run.launches_by_dtype.items()}
                res["runs"][run["tag"]] = dict(
                    tokens=[r.out_tokens for r in done], wall_s=dt,
                    steps=eng.steps, decode_s=eng.decode_seconds,
                    prefill_s=eng.prefill_seconds,
                    gather_s=eng.gather_seconds, cache_mode=eng.cache_mode,
                    peak_gib=torch.cuda.max_memory_allocated(dev) / gib,
                    launches=launches, all_to_all=a2a["calls"],
                    resident=[list(b) for b in eng.resident_bytes],
                    checksum=list(eng.weights_checksum),
                    cold_compressed=(eng.paged.n_compressed
                                     if eng.paged is not None else 0),
                    cache_rows=eng.cache["cur_len"].shape[0])
                if rank == 0:
                    log(f"rank 0: {run['tag']} served in {dt:.1f}s "
                        f"({eng.steps} steps)")
                del eng, done
                if run.get("solo"):
                    # rank 0 alone on the same (whole) tree, the comparison
                    if rank == 0:
                        ecfg = EngineConfig(max_batch=g["max_batch"],
                                            max_len=g["max_len"],
                                            **run["engine"])
                        done, eng, dt = serve.serve(tree, cfg, ecfg,
                                                    g["prompts"], g["new"],
                                                    device=dev)
                        res["solo"] = dict(
                            tokens=[r.out_tokens for r in done], wall_s=dt,
                            steps=eng.steps, decode_s=eng.decode_seconds)
                        del eng, done
                    dist.barrier()
                # the next build (the other tree alone) must not find
                # this one alive
                del tree
            del trees, served, base
        gc.collect()
        torch.cuda.empty_cache()
        # the exchange of one MoE layer of a decode step, at its shape
        if cfg.n_experts:
            b_loc = g["max_batch"] // dims[0]
            if n_model > 1:
                e_loc = cfg.n_experts // n_model
                lo, hi = expert_rows(cfg.n_experts, mesh)
                x = torch.randn((n_model, 1, e_loc, 8, cfg.d_model),
                                device=dev).to(torch.bfloat16)
                res["all_to_all_ms"] = timed(lambda: exchange(x, mesh))
                res["all_to_all_bytes"] = x.numel() * 2
                res["experts"] = [lo, hi]
            elif dims[0] > 1:
                w = torch.rand((b_loc, 2 * cfg.n_experts), device=dev)
                res["route_gather_ms"] = timed(
                    lambda: collectives.gather_rows(w, mesh, "data"))
                res["route_gather_bytes"] = w.numel() * 4
        out["groups"][g["tag"]] = res
        dist.barrier()
    return out


def moe_mesh_phase(torch, np, MESH, serve, get, n_ranks: int, seed: int,
                   ecf8_decode, fp8, tpu_format, flash_fwd, gen, flush):
    """Phase 22 on ``n_ranks`` ranks (four NCCL ranks, one a card, or two
    gloo ranks sharing one card) -> (measurements, the kernels' checks at
    the ranks' shapes, per-run launches of every rank).  Fails on any
    gate."""
    nccl = torch.cuda.device_count() >= n_ranks > 1 and \
        torch.cuda.device_count() > 1
    moe = get(MOE_ARCH)
    if nccl:
        moe_layers, n_req, max_batch = MOE_LAYERS_FULL, MESH_REQUESTS, \
            MESH_BATCH
        moe_meshes = ((1, n_ranks), (n_ranks // 2, 2), (n_ranks, 1))
    else:
        moe_layers, n_req, max_batch = MOE_MESH_LAYERS, 8, 4
        moe_meshes = ((1, n_ranks), (n_ranks, 1))
    cfg = dataclasses.replace(moe, n_layers=moe_layers)
    prompts = serve.make_prompts(cfg, n_req, seed, lo=64, hi=513)
    groups = []
    for dims in moe_meshes:
        data_only = dims[1] == 1
        # one card: --mesh 2 on the cold pool (B3 on each rank's cold
        # slots); four cards paged (phase 21 runs the cold pool there, and
        # its host page encoder at 48 layers would double the phase)
        eng = dict(compress_cold=True) if data_only and not nccl else {}
        tag = f"moe_{dims[0]}x{dims[1]}"
        groups.append(dict(
            tag=tag, arch=MOE_ARCH, layers=moe_layers, mesh=dims,
            prompts=prompts, max_batch=max_batch, max_len=1024, new=32,
            builds=[["ecf8", "fp8"]],
            runs=[dict(tag=f"{tag}_ecf8", tree="ecf8", engine=eng,
                       solo=data_only),
                  dict(tag=f"{tag}_fp8", tree="fp8", engine=eng)]))
    if nccl:
        ll = get(LLAMA_ARCH)
        rng = np.random.default_rng(seed)
        lp = [rng.integers(0, ll.vocab_size, n).tolist()
              for n in LLAMA_PROMPTS]
        tag = f"llama4_1x{n_ranks}"
        # each tree alone beside the cache: both would not fit a card
        groups.insert(0, dict(
            tag=tag, arch=LLAMA_ARCH, layers=ll.n_layers, mesh=(1, n_ranks),
            prompts=lp, max_batch=4, max_len=LLAMA_MAX_LEN, new=32,
            builds=[["ecf8"], ["fp8"]],
            runs=[dict(tag=f"{tag}_ecf8", tree="ecf8", engine={}),
                  dict(tag=f"{tag}_fp8", tree="fp8", engine={})]))
    else:
        rg = dataclasses.replace(get(RG_ARCH), n_layers=RG_MESH_LAYERS)
        rng = np.random.default_rng(seed)
        rp = [rng.integers(0, rg.vocab_size, n).tolist() for n in RG_PROMPTS]
        tag = f"rg_{n_ranks}x1"
        groups.append(dict(
            tag=tag, arch=RG_ARCH, layers=RG_MESH_LAYERS, mesh=(n_ranks, 1),
            prompts=rp, max_batch=4, max_len=RG_MAX_LEN, new=32,
            builds=[["ecf8", "fp8"]],
            runs=[dict(tag=f"{tag}_ecf8", tree="ecf8", engine={}),
                  dict(tag=f"{tag}_fp8", tree="fp8", engine={})]))
    log(f"phase 22: {n_ranks} ranks over "
        f"{'NCCL, one card each' if nccl else 'gloo on one card'}; "
        + "; ".join(f"{g['tag']}: {g['arch']} at {g['layers']} layers on "
                    f"mesh {g['mesh']}, {len(g['prompts'])} requests "
                    f"({min(map(len, g['prompts']))}-"
                    f"{max(map(len, g['prompts']))} tokens), max_batch "
                    f"{g['max_batch']}, max_len {g['max_len']}, trees "
                    f"{g['builds']}" for g in groups))

    # B1 at the expert containers a rank decodes on the model axis, and B4
    # at the heads of the phase's largest model, against their plain
    # versions
    checks = {}
    for name, c in (("moe", cfg), ("llama4", get(LLAMA_ARCH) if nccl
                                   else None)):
        if c is None:
            continue
        e_loc = c.n_experts // n_ranks
        w = torch.randn((e_loc, c.d_model, c.moe_d_ff), generator=gen,
                        device="cuda").mul_(c.d_model ** -0.5)
        bits = fp8.cast_to_fp8_bits(w)
        del w
        checks[f"b1_{name}_expert_1x{n_ranks}"] = check_decode(
            torch, ecf8_decode, fp8, tpu_format,
            f"{name} expert container on 1x{n_ranks}", bits, flush, 10)
        del bits
        torch.cuda.empty_cache()
    hc = get(LLAMA_ARCH) if nccl else cfg
    checks["b4"] = check_flash(torch, flash_fwd, 2048, gen, flush,
                               heads=(hc.n_heads, hc.n_kv_heads), D=hc.hd,
                               gqa=True)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    res = MESH.spawn(moe_mesh_rank, n_ranks, dict(seed=seed, groups=groups),
                     device="cuda", backend="nccl" if nccl else "gloo",
                     timeout=1100)
    wall = time.perf_counter() - t0
    r0 = res[0]
    log(f"phase 22 ranks: {n_ranks} x {r0['device']} over {r0['backend']},"
        f" spawn + builds + runs {wall:.1f}s")
    out = dict(ranks=n_ranks, backend=r0["backend"], wall_s=wall,
               checks=checks, groups={})
    launches = {}
    # every gate is read and every group logged before the phase fails
    problems = []
    for g in groups:
        tag, dims = g["tag"], tuple(g["mesh"])
        c = dataclasses.replace(get(g["arch"]), n_layers=g["layers"])
        per = [r["groups"][tag] for r in res]
        go = dict(arch=g["arch"], layers=g["layers"], mesh=list(dims),
                  builds=[p["builds"] for p in per], runs={})
        for run in g["runs"]:
            rt = run["tag"]
            pr = [p["runs"][rt] for p in per]
            toks = [p["tokens"] for p in pr]
            ln = [p["launches"] for p in pr]
            a2a = [p["all_to_all"] for p in pr]
            launches[rt] = ln
            ecf8 = run["tree"] == "ecf8"
            want_mode = "monolithic" if g["arch"] == RG_ARCH else "paged"
            for bad, what in (
                    (any(t != toks[0] for t in toks),
                     "the ranks' tokens differ"),
                    (not all(len(t) == g["new"] and all(
                        0 <= x < c.vocab_size for x in t) for t in toks[0]),
                     "unfinished requests or out-of-vocab tokens"),
                    (any(p["cache_mode"] != want_mode for p in pr),
                     f"the cache resolved to {pr[0]['cache_mode']}, not "
                     f"{want_mode}"),
                    (ecf8 and not all(x["ecf8_decode"] for x in ln),
                     f"B1 not launched on every rank: {ln}"),
                    (not ecf8 and any(x["ecf8_decode"] for x in ln),
                     f"B1 launched from the fp8 tree: {ln}"),
                    (any(set(x["ecf8_decode_by_dtype"])
                         - {str(torch.bfloat16)} for x in ln),
                     f"a weight decoded to another dtype than bf16: {ln}"),
                    (not any(x["flash_fwd"] for x in ln),
                     "B4 never launched"),
                    (any(x["fused_decode_matmul"] for x in ln),
                     "B2 launched on a serve path"),
                    (run["engine"].get("compress_cold") and not all(
                        x["kv_page_decode_by_path"].get("sharded", 0)
                        for x in ln),
                     f"B3 not launched on the sharded path on every rank: "
                     f"{ln}"),
                    (c.n_experts and dims[1] > 1 and not all(a2a),
                     f"a rank made no all_to_all: {a2a}"),
                    (dims[1] == 1 and any(a2a),
                     "all_to_all without a model axis"),
                    (want_mode == "monolithic" and any(
                        p["cache_rows"] != g["max_batch"] // dims[0]
                        for p in pr),
                     f"the monolithic cache holds "
                     f"{[p['cache_rows'] for p in pr]} rows a rank, not "
                     f"max_batch / {dims[0]}")):
                if bad:
                    problems.append(f"phase 22 {rt}: {what}")
            steps = pr[0]["steps"]
            n_tok = sum(len(t) for t in toks[0])
            go["runs"][rt] = dict(
                steps=steps, tok_s=n_tok / pr[0]["wall_s"],
                wall_s=[p["wall_s"] for p in pr],
                step_ms=[p["decode_s"] / max(steps, 1) * 1e3 for p in pr],
                token_gather_ms=[p["gather_s"] / max(steps, 1) * 1e3
                                 for p in pr],
                prefill_s=[p["prefill_s"] for p in pr],
                peak_gib=[p["peak_gib"] for p in pr],
                resident_gib=[[b / 2 ** 30 for b in rb]
                              for rb in pr[0]["resident"]],
                all_to_all_a_rank=a2a,
                launches_a_step={k: [x[k] / max(steps, 1) for x in ln]
                                 for k in ("ecf8_decode", "flash_fwd",
                                           "kv_page_decode")},
                launches=ln, cold_compressed=pr[0]["cold_compressed"],
                cache_rows=[p["cache_rows"] for p in pr])
            log(f"phase 22 {rt} (mesh {list(dims)}): "
                f"{json.dumps(go['runs'][rt])}")
        # experts placed: each rank's share of every expert leaf (the
        # engine compared the model peers' checksums)
        if c.n_experts:
            shapes = {tuple(b["expert_shape"]) for p in per
                      for b in p["builds"]}
            want = c.n_experts // dims[1]
            if any(s[0] != want for s in shapes):
                problems.append(f"phase 22 {tag}: expert containers of "
                                f"{shapes}, not {want} experts a rank")
            go["expert_shape_a_rank"] = sorted(shapes)
            go["experts"] = [p.get("experts") for p in per]
            go["all_to_all_ms"] = [p.get("all_to_all_ms") for p in per]
            go["all_to_all_bytes"] = per[0].get("all_to_all_bytes")
            go["route_gather_ms"] = [p.get("route_gather_ms") for p in per]
            go["route_gather_bytes"] = per[0].get("route_gather_bytes")
        ecf8_t = per[0]["runs"][f"{tag}_ecf8"]["tokens"]
        fp8_t = per[0]["runs"][f"{tag}_fp8"]["tokens"]
        bad = [i for i, (a, b) in enumerate(zip(ecf8_t, fp8_t)) if a != b]
        go["lossless"] = not bad
        if bad:
            problems.append(f"phase 22 {tag}: ECF8 tokens differ from the "
                            f"fp8 tree's on the mesh (requests {bad})")
        else:
            log(f"lossless on mesh {list(dims)}: {g['arch']} ECF8 greedy "
                f"tokens IDENTICAL to the fp8 tree's ({len(ecf8_t)} "
                f"requests)")
        if "solo" in per[0]:
            solo = per[0]["solo"]
            same = sum(a == b for a, b in zip(ecf8_t, solo["tokens"]))
            go["same_as_one_rank"] = same
            go["one_rank_step_ms"] = solo["decode_s"] / max(
                solo["steps"], 1) * 1e3
            log(f"phase 22 {tag}: requests identical to rank 0 alone "
                f"(reported, not gated): {same} of {len(solo['tokens'])}; "
                f"one rank {go['one_rank_step_ms']:.1f} ms a step")
        for p in per:
            for b in p["builds"]:
                log(f"phase 22 {tag} rank {per.index(p)} build "
                    f"{b['trees']}: {b['build_s']:.1f}s, resident "
                    f"{b['resident_gib']:.2f} GiB (build peak "
                    f"{b['build_peak_gib']:.2f}), fp8 {b['fp8_mb']:.0f} MB "
                    f"-> ECF8 {b['ecf8_mb']:.0f} MB, experts a rank "
                    f"{b['expert_shape']}")
        if c.n_experts:
            log(f"phase 22 {tag}: experts a rank {go['experts']}, "
                f"all_to_all ms {go['all_to_all_ms']} "
                f"({go['all_to_all_bytes']} B), routing-weight gather ms "
                f"{go['route_gather_ms']} ({go['route_gather_bytes']} B)")
        out["groups"][tag] = go
    if problems:
        log(f"phase 22 measurements: {json.dumps(out)}")
        fail("; ".join(problems))
    return out, launches


def train_mesh_rank(rank, world, dev, spec):
    """One rank of phase 23 (a process of its own, started by
    ``launch.mesh.spawn``): phase 4's small f32 qwen3 stack trained one
    step on ``spec["small_mesh"]`` (its parameters gathered whole on rank
    0), then qwen3-8b (untied, ``spec["layers"]`` layers) on each mesh of
    ``spec["runs"]``: this rank's shards of the state drawn from the seed
    (``runtime.steps.init_sharded``), ``spec["steps"]`` steps on its rows
    (``sharded_batch``) with the kernels' launches counted, then one more
    step with every collective timed (synchronised host clock around it;
    over gloo, which stages every collective through the host and so
    waits for it anyway, the counted steps themselves are timed instead)
    -> a dict of plain values."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves
    from repro_torch.runtime import collectives
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import steps as S

    meshes, timer, zero, counts = _train_rank_setup(
        torch, [r["mesh"] for r in spec["runs"]] + [spec["small_mesh"]])

    # phase 4's small f32 model, one step on the small mesh
    cfg_s = dataclasses.replace(get("qwen3-8b"), **spec["small"])
    mesh_s = meshes[tuple(spec["small_mesh"])]
    p_s, specs_s = S.init_sharded(cfg_s, spec["seed"], mesh_s, device=dev)
    data_s = SyntheticLMData(DataConfig(cfg_s.vocab_size, 64, 4,
                                        spec["seed"]))
    p_s, _, m_s = S.make_train_step(
        cfg_s, AdamWConfig(lr=1e-3), mesh=mesh_s, remat=True,
        grad_accum=2)(p_s, adamw_init(p_s), data_s.sharded_batch(
            0, mesh_s, SH.batch_axes(mesh_s), dev), 0)
    flat_s = dict(iter_leaves(specs_s))
    small = {"/".join(k): collectives.gather_leaf(v, flat_s[k], mesh_s)
             .cpu().numpy() for k, v in iter_leaves(p_s)}
    small = dict(loss=float(m_s["loss"]), grad_norm=float(m_s["grad_norm"]),
                 params=small if rank == 0 else None)
    del p_s

    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=spec["layers"],
                              tie_embeddings=False)
    out, n_params = _train_runs(torch, dev, cfg, spec, meshes, timer, zero,
                                counts)
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(),
                small=small, runs=out, n_params=n_params)


def _train_rank_setup(torch, mesh_dims):
    """What a rank of phases 23-24 sets up first: the meshes of
    ``mesh_dims`` (every rank makes them in the same order: each is a
    collective), the collectives ``_sum_over`` / ``_cat_over`` timed on a
    synchronised host clock while ``timer["on"]``, and the kernels' launch
    counters -> (meshes, timer, zero(), counts())."""
    import torch.distributed as dist
    from repro_torch.kernels import ecf8_decode, flash_bwd, flash_fwd
    from repro_torch.kernels import fused_decode_matmul as fused
    from repro_torch.kvcache import kernels as kv_page
    from repro_torch.launch import mesh as MESH
    from repro_torch.runtime import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = dist.get_backend() == "nccl"
    meshes = {dims: MESH.make_mesh(*dims, "cuda" if nccl else "cpu")
              for dims in sorted({tuple(d) for d in mesh_dims})}
    timer = {"on": False, "s": 0.0, "n": 0}

    def timed(fn):
        def wrapper(*a, **kw):
            if not timer["on"]:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timer["s"] += time.perf_counter() - t0
            timer["n"] += 1
            return out
        return wrapper

    collectives._sum_over = timed(collectives._sum_over)
    collectives._cat_over = timed(collectives._cat_over)
    runs = {"ecf8_decode": ecf8_decode.run, "flash_fwd": flash_fwd.run,
            "kv_page_decode": kv_page.run, "fused_decode_matmul": fused.run,
            "flash_bwd": flash_bwd.run}

    def zero():
        for r in runs.values():
            r.launches = 0
        flash_fwd.run.launches_q_base = flash_bwd.run.launches_q_base = 0

    def counts():
        out = {n: r.launches for n, r in runs.items()}
        out["flash_fwd_q_base"] = flash_fwd.run.launches_q_base
        out["flash_bwd_q_base"] = flash_bwd.run.launches_q_base
        return out

    return meshes, timer, zero, counts


def _train_runs(torch, dev, cfg, spec, meshes, timer, zero, counts,
                exchange=None, mixer=None, frames=None):
    """The full-width runs of phases 23 and 24 on this rank: for each run
    of ``spec["runs"]`` this rank's shards of ``cfg``'s state drawn from
    the seed (``runtime.steps.init_sharded``), ``spec["steps"]`` steps on
    its rows with the kernels' launches counted (``zero`` / ``counts``),
    then under NCCL one more step with every collective synchronised and
    timed into ``timer`` (over gloo, which stages every collective through
    the host and so waits for it anyway, the counted steps are timed
    instead).  ``exchange`` (phase 24): the MoE layers' ``all_to_all``
    counts ``{"calls", "s", "on"}``, timed where ``timer`` is on and
    reported apart; ``mixer`` (phase 25): the recurrent mixers' forward
    timings ``{"on", "by_kind"}`` (:func:`_mixer_probe`), taken where
    ``timer`` is on; ``frames`` (phase 26): ``frames(step, mesh)``, the
    rank's rows of an encoder-decoder's frames for the step's batch ->
    ({tag: the run's figures}, the tree's parameters)."""
    import torch.distributed as dist
    from repro_torch.core.store import torch_dtype
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import steps as S

    nccl = dist.get_backend() == "nccl"
    gib = 2 ** 30

    def nbytes(*trees):
        return sum(t.numel() * t.element_size() for tree in trees
                   for _, t in iter_leaves(tree))

    shapes = M.init_params(cfg, device="meta", dtype=torch_dtype(cfg.dtype))
    n_params = sum(x.numel() for _, x in iter_leaves(shapes))
    whole = n_params * (2 + 8)      # bf16 weights, two f32 moments
    data = SyntheticLMData(DataConfig(cfg.vocab_size, spec["seq"],
                                      spec["batch"], spec["seed"]))
    a2a = exchange if exchange is not None else {}
    mix = mixer if mixer is not None else {}
    out = {}
    for run in spec["runs"]:
        mesh = meshes[tuple(run["mesh"])]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, _ = S.init_sharded(cfg, spec["seed"], mesh, device=dev)
        opt = adamw_init(params)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        resident = nbytes(params, opt["mu"], opt["nu"])
        step_fn = S.make_train_step(
            cfg, AdamWConfig(lr=TRAIN_LR), mesh=mesh, remat=True,
            grad_accum=MESH_TRAIN_ACCUM, warmup_steps=1,
            total_steps=spec["steps"])
        steps, secs = [], []
        zero()
        timer.update(on=not nccl, s=0.0, n=0)
        a2a.update(calls=0, s=0.0, on=not nccl)
        mix.update(on=not nccl, by_kind={})
        for i in range(spec["steps"]):
            batch = data.sharded_batch(i, mesh, SH.batch_axes(mesh), dev)
            if frames is not None:
                batch["frames"] = frames(i, mesh)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch, i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            steps.append({k: float(v) for k, v in m.items()})
        launches = counts()
        a2a_calls = a2a.get("calls", 0)
        if nccl:    # one more step, each collective timed (not counted)
            batch = data.sharded_batch(spec["steps"], mesh,
                                       SH.batch_axes(mesh), dev)
            if frames is not None:
                batch["frames"] = frames(spec["steps"], mesh)
            dist.barrier()
            timer.update(on=True, s=0.0, n=0)
            a2a.update(calls=0, s=0.0, on=True)
            mix.update(on=True, by_kind={})
            t0 = time.perf_counter()
            params, opt, _ = step_fn(params, opt, batch, spec["steps"])
            torch.cuda.synchronize()
            timed_s = time.perf_counter() - t0
            n_timed = 1
        else:
            timed_s, n_timed = sum(secs), len(secs)
        timer["on"] = a2a["on"] = mix["on"] = False
        out[run["tag"]] = dict(
            mesh=list(run["mesh"]), steps=steps,
            step_ms=[x * 1e3 for x in secs], launches=launches,
            collectives_ms=timer["s"] * 1e3 / n_timed,
            collectives=timer["n"] // n_timed,
            timed_step_ms=timed_s * 1e3 / n_timed, build_s=build_s,
            resident_gib=resident / gib, whole_gib=whole / gib,
            resident_share=resident / whole,
            peak_gib=(torch.cuda.max_memory_allocated() - base) / gib)
        if exchange is not None:
            out[run["tag"]].update(
                all_to_all_calls=a2a_calls / spec["steps"],
                all_to_all_ms=a2a["s"] * 1e3 / n_timed)
        if mixer is not None:
            out[run["tag"]]["mixer_ms"] = _mixer_ms(mix, n_timed)
        del params, opt, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out, n_params


def train_mesh_phase(torch, np, MESH, get, n_ranks: int, seed: int,
                     flash_fwd, flash_bwd, gen, flush):
    """Phase 23 on ``n_ranks`` ranks (four NCCL ranks, one a card, or two
    gloo ranks sharing one card) -> (measurements, per-rank launches of the
    mesh runs, B4's and B5's results at the sharded shape).  Fails on any
    gate."""
    from repro_torch.core.store import torch_dtype
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         iter_leaves)
    from repro_torch.runtime.steps import make_train_step
    full = n_ranks >= 4
    nccl = full and torch.cuda.device_count() >= n_ranks
    layers, seq, batch = ((36, MESH_TRAIN_FULL_SEQ, MESH_TRAIN_FULL_BATCH)
                          if full else (MESH_TRAIN_LAYERS, MESH_TRAIN_SEQ,
                                        MESH_TRAIN_BATCH))
    steps = TRAIN_STEPS if full else 1
    runs = [dict(tag=f"{n_ranks}", mesh=(n_ranks, 1)),
            dict(tag=f"{n_ranks // 2}x2", mesh=(n_ranks // 2, 2))]
    A = MESH_TRAIN_ACCUM
    log(f"phase 23: training on {n_ranks} ranks over "
        f"{'NCCL, one card each' if nccl else 'gloo on one card'}; "
        f"qwen3-8b untied at full width, {layers} layers, global batch "
        f"{batch} x seq {seq}, grad_accum {A}, remat, bf16 weights and f32 "
        f"moments, {steps} step(s) a mesh; meshes "
        f"{[r['mesh'] for r in runs]} (the sequence split over model)")

    # B5 (and B4 with statistics) with q_base against the plain versions:
    # a model rank's rows at qwen3's and gemma2's heads, and at the shape
    # of a micro-batch on model rank 1 of the (D)x2 mesh
    b_mb = batch // (n_ranks // 2) // A
    qb = {}
    for name, T, part, heads, D, cap, B in (
            ("T1024_base512", 1024, 2, (32, 8), 128, 0.0, 1),
            ("T1024_base768", 1024, 4, (32, 8), 128, 0.0, 1),
            ("gemma2_T1024_base512", 1024, 2, (16, 8), 256, 50.0, 1),
            (f"train_B{b_mb}_T{seq}_base{seq // 2}", seq, 2, (32, 8), 128,
             0.0, b_mb)):
        base = T - T // part
        qb[name] = check_flash_bwd(torch, flash_fwd, flash_bwd, gen, flush,
                                   T // part, heads, D, softcap=cap, Tk=T,
                                   B=B, q_base=base)
    train_shape = f"train_B{b_mb}_T{seq}_base{seq // 2}"
    b4 = check_flash(torch, flash_fwd, seq // 2, gen, flush, B=b_mb,
                     q_base=seq // 2, Tk=seq)
    # four 256-row shards of T = 1024: dq bit for bit the unsharded rows,
    # dk / dv summed within FLASH_TOL of the largest magnitude
    shards = {}
    for heads, D, cap in (((32, 8), 128, 0.0), ((16, 8), 256, 50.0)):
        def rnd(h):
            return torch.randn((1, h, 1024, D), generator=gen,
                               device="cuda").to(torch.bfloat16)

        q, k, v, do = rnd(heads[0]), rnd(heads[1]), rnd(heads[1]), \
            rnd(heads[0])
        o, m, l = flash_fwd.run(q, k, v, softcap=cap, stats=True)
        dq, dk, dv = flash_bwd.run(q, k, v, o, m, l, do, softcap=cap)
        sk = sv = 0
        for lo in range(0, 1024, 256):
            rows = slice(lo, lo + 256)
            qs, dos = q[:, :, rows].contiguous(), do[:, :, rows].contiguous()
            os_, ms, ls = flash_fwd.run(qs, k, v, softcap=cap, stats=True,
                                        q_base=lo)
            g = flash_bwd.run(qs, k, v, os_, ms, ls, dos, softcap=cap,
                              q_base=lo)
            same = all(torch.equal(a, b[:, :, rows]) for a, b in
                       ((os_, o), (ms, m), (ls, l), (g[0], dq)))
            if not same:
                fail(f"flash_bwd q_base {lo} (D {D}): the shard's "
                     f"statistics or dq differ from the unsharded rows")
            sk, sv = sk + g[1].float(), sv + g[2].float()
        rel = max(float((got - want.float()).abs().max())
                  / float(want.float().abs().max())
                  for got, want in ((sk, dk), (sv, dv)))
        if not rel <= FLASH_TOL:
            fail(f"flash_bwd: four q_base shards' dk / dv off the unsharded "
                 f"by {rel} of the largest magnitude > {FLASH_TOL}")
        shards[f"D{D}"] = rel
        del q, k, v, do, o, m, l, dq, dk, dv, sk, sv
    log(f"flash_bwd q_base: four 256-row shards of T = 1024: statistics "
        f"and dq bit for bit the unsharded rows, dk / dv summed within "
        f"{ {k: f'{v:.2e}' for k, v in shards.items()} } of the largest "
        f"magnitude (tol {FLASH_TOL})")
    gc.collect()
    torch.cuda.empty_cache()

    # the one-rank references on this card: the small f32 model's step and
    # (one card) qwen3-8b's step 0 unsharded
    small_cfg = dict(name="qwen3-small", n_layers=2, d_model=256, n_heads=4,
                     n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
                     dtype="float32")
    cfg_s = dataclasses.replace(get("qwen3-8b"), **small_cfg)
    p_s = M.init_params(cfg_s, seed, device="cuda")
    p_s, _, m_small = make_train_step(cfg_s, AdamWConfig(lr=1e-3),
                                      remat=True, grad_accum=2)(
        p_s, adamw_init(p_s), SyntheticLMData(DataConfig(
            cfg_s.vocab_size, 64, 4, seed)).batch(0, "cuda"), 0)
    small_want = {"/".join(k): v.detach().cpu().numpy()
                  for k, v in iter_leaves(p_s)}
    del p_s
    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=layers,
                              tie_embeddings=False)
    one = None
    if not full:
        t0 = time.perf_counter()
        p1 = M.init_params(cfg, seed, device="cuda",
                           dtype=torch_dtype(cfg.dtype))
        data = SyntheticLMData(DataConfig(cfg.vocab_size, seq, batch, seed))
        _, _, m1 = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR), remat=True,
                                   grad_accum=A, warmup_steps=1,
                                   total_steps=steps)(
            p1, adamw_init(p1), data.batch(0, "cuda"), 0)
        one = {k: float(v) for k, v in m1.items()}
        del p1, m1
        log(f"phase 23 one rank unsharded, step 0: loss {one['loss']:.6f} "
            f"grad_norm {one['grad_norm']:.5f} "
            f"({time.perf_counter() - t0:.1f} s with the build)")
    gc.collect()
    torch.cuda.empty_cache()

    spec = dict(seed=seed, layers=layers, seq=seq, batch=batch,
                steps=steps, runs=runs, small=small_cfg,
                small_mesh=(n_ranks // 2, 2))
    t0 = time.perf_counter()
    res = MESH.spawn(train_mesh_rank, n_ranks, spec, device="cuda",
                     backend="nccl" if nccl else "gloo", timeout=1500)
    wall = time.perf_counter() - t0
    r0 = res[0]
    log(f"phase 23 ranks: {n_ranks} x {r0['device']} over {r0['backend']}, "
        f"spawn + builds + steps {wall:.1f}s; {r0['n_params'] / 1e9:.3f} B "
        f"parameters")
    problems = []
    # phase 4's small model on the mesh against one rank's
    errs = [abs(r["small"]["loss"] - m_small["loss"].item())
            / abs(m_small["loss"].item()) for r in res]
    p_err = max(float(np.abs(r0["small"]["params"][k] - w).max())
                for k, w in small_want.items())
    log(f"phase 23 small f32 model on {list(spec['small_mesh'])}: loss gap "
        f"{max(errs):.2e}, parameters within {p_err:.2e} of one rank's "
        f"(tol 2e-4)")
    if not (max(errs) <= 2e-4 and p_err <= 2e-4):
        problems.append(f"small model off one rank's: loss {errs}, "
                        f"parameters {p_err}")
    share_max = 0.3 if full else 0.55
    n_matmul = r0["n_params"] - cfg.vocab_size * cfg.d_model
    pairs = seq * (seq + 1) // 2
    model_flops = (6 * n_matmul * batch * seq
                   + 12 * batch * cfg.n_heads * cfg.hd * pairs * layers)
    per_step = {"flash_fwd": 2 * layers * A, "flash_bwd": layers * A}
    out = dict(ranks=n_ranks, backend=r0["backend"], layers=layers, seq=seq,
               batch=batch, grad_accum=A, steps=steps, one_rank=one,
               small_loss_gap=max(errs), small_param_err=p_err,
               q_base_checks=qb, shard_sums=shards, runs={})
    launches = {}
    for run in runs:
        tag = run["tag"]
        per = [r["runs"][tag] for r in res]
        n_model = run["mesh"][1]
        for rank, p in enumerate(per):
            bad = [s for s in p["steps"] if not (math.isfinite(s["loss"])
                                                 and math.isfinite(
                                                     s["grad_norm"]))]
            if bad:
                problems.append(f"{tag} rank {rank}: non-finite {bad}")
            if p["resident_share"] > share_max:
                problems.append(f"{tag} rank {rank}: resident state "
                                f"{p['resident_share']:.3f} of the tree > "
                                f"{share_max}")
            ln = p["launches"]
            want = {k: v * steps for k, v in per_step.items()}
            if {k: ln[k] for k in want} != want or ln["ecf8_decode"] or \
                    ln["kv_page_decode"] or ln["fused_decode_matmul"]:
                problems.append(f"{tag} rank {rank}: launches {ln}, "
                                f"expected {want} and no other kernel")
            q_rank = rank % n_model != 0
            if (ln["flash_fwd_q_base"], ln["flash_bwd_q_base"]) != (
                    (want["flash_fwd"], want["flash_bwd"]) if q_rank
                    else (0, 0)):
                problems.append(f"{tag} rank {rank}: launches with q_base "
                                f"{ln}")
        losses = {s["loss"] for p in per for s in p["steps"][:1]}
        if len(losses) != 1:
            problems.append(f"{tag}: the ranks' step 0 losses differ "
                            f"{losses}")
        step_s = statistics.median([x for p in per
                                    for x in p["step_ms"][1:]
                                    or p["step_ms"]]) / 1e3
        tok_s = batch * seq / step_s
        share = model_flops / step_s / (n_ranks * H100_BF16_FLOPS)
        out["runs"][tag] = dict(
            mesh=run["mesh"], loss=[s["loss"] for s in per[0]["steps"]],
            grad_norm=[s["grad_norm"] for s in per[0]["steps"]],
            step_ms=[p["step_ms"] for p in per], median_step_ms=step_s * 1e3,
            tokens_per_s=tok_s, flop_share=share,
            collectives_ms=[p["collectives_ms"] for p in per],
            collectives=per[0]["collectives"],
            timed_step_ms=[p["timed_step_ms"] for p in per],
            resident_gib=[p["resident_gib"] for p in per],
            resident_share=[p["resident_share"] for p in per],
            whole_gib=per[0]["whole_gib"],
            peak_gib=[p["peak_gib"] for p in per],
            build_s=[p["build_s"] for p in per],
            launches=[p["launches"] for p in per])
        launches[f"train_{tag}"] = [p["launches"] for p in per]
        log(f"phase 23 {tag} (mesh {list(run['mesh'])}): losses "
            f"{[round(x, 5) for x in out['runs'][tag]['loss']]} grad_norm "
            f"{[round(x, 4) for x in out['runs'][tag]['grad_norm']]}; a rank"
            f"'s step {[[round(x, 1) for x in p['step_ms']] for p in per]} "
            f"ms (median {step_s * 1e3:.1f}), collectives "
            f"{[round(p['collectives_ms'], 1) for p in per]} ms in "
            f"{per[0]['collectives']} calls (a synchronised step of "
            f"{[round(p['timed_step_ms'], 1) for p in per]} ms); resident "
            f"{[round(p['resident_gib'], 3) for p in per]} GiB of "
            f"{per[0]['whole_gib']:.3f} "
            f"({max(p['resident_share'] for p in per):.3f}), peak "
            f"{[round(p['peak_gib'], 2) for p in per]} GiB; build "
            f"{[round(p['build_s'], 1) for p in per]} s; {tok_s:.0f} "
            f"tokens/s, model FLOPs {model_flops / 1e12:.1f} T a step = "
            f"{100 * share:.1f} % of {n_ranks} x 989 TFLOP/s; launches "
            f"{per[0]['launches']} (rank 0), {per[-1]['launches']} (rank "
            f"{n_ranks - 1})")
    first = [out["runs"][r["tag"]]["loss"][0] for r in runs]
    norms = [out["runs"][r["tag"]]["grad_norm"][0] for r in runs]
    if one is not None:
        out["gaps_to_one_rank"] = [dict(
            loss=abs(x - one["loss"]) / abs(one["loss"]),
            grad_norm=abs(g - one["grad_norm"]) / abs(one["grad_norm"]))
            for x, g in zip(first, norms)]
        log(f"phase 23 step 0 against one rank unsharded: "
            f"{out['gaps_to_one_rank']} (tol loss 5e-3, grad_norm 2e-2)")
        if not all(d["loss"] <= 5e-3 and d["grad_norm"] <= 2e-2
                   for d in out["gaps_to_one_rank"]):
            problems.append(f"step 0 off one rank's: "
                            f"{out['gaps_to_one_rank']}")
    gap = abs(first[0] - first[1]) / abs(first[0])
    out["loss_gap_between_meshes"] = gap
    log(f"phase 23 step 0 loss {first[0]:.6f} on {runs[0]['tag']} vs "
        f"{first[1]:.6f} on {runs[1]['tag']} (gap {gap:.2e}, tol 5e-3)")
    if gap > 5e-3:
        problems.append(f"step 0 losses of the meshes {first} differ by "
                        f"{gap}")
    if problems:
        fail("phase 23: " + "; ".join(problems))
    return out, launches, dict(b5=qb[train_shape], b4=b4)


def train_moe_mesh_rank(rank, world, dev, spec):
    """One rank of phase 24 (a process of its own, started by
    ``launch.mesh.spawn``): :func:`moe_smoke`'s f32 stack trained one step
    on each mesh of ``spec["smoke_runs"]`` ({tag: (mesh, rule)}), its
    parameters and first moments gathered whole on rank 0; then
    moonshot-v1-16b-a3b at full width and ``spec["layers"]`` layers on
    each mesh of ``spec["runs"]`` as phase 23's runs (:func:`_train_runs`),
    the MoE layers' ``all_to_all`` counted and, where the collectives are,
    timed -> a dict of plain values."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get, smoke_variant
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves
    from repro_torch.runtime import collectives
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import steps as S

    meshes, timer, zero, counts = _train_rank_setup(
        torch, [r["mesh"] for r in spec["runs"]]
        + [m for m, _ in spec["smoke_runs"].values()])
    # the MoE layers reach the exchange through the module attribute
    a2a = {"calls": 0, "s": 0.0, "on": False}
    exchange = collectives.all_to_all

    def counted(x, mesh, axis="model"):
        a2a["calls"] += 1
        if not a2a["on"]:
            return exchange(x, mesh, axis)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(x, mesh, axis)
        torch.cuda.synchronize()
        a2a["s"] += time.perf_counter() - t0
        return out

    collectives.all_to_all = counted

    cfg_s = moe_smoke(get, smoke_variant)
    data_s = SyntheticLMData(DataConfig(cfg_s.vocab_size, 64, 4,
                                        spec["seed"]))
    smoke = {}
    for tag, (dims, rule) in spec["smoke_runs"].items():
        mesh = meshes[tuple(dims)]
        rules = SH.ShardingRules(activation_partitioning=rule)
        p, specs = S.init_sharded(cfg_s, spec["seed"], mesh, rules,
                                  device=dev)
        p, o, m = S.make_train_step(
            cfg_s, AdamWConfig(lr=1e-3), mesh=mesh, rules=rules, remat=True,
            grad_accum=2)(p, adamw_init(p), data_s.sharded_batch(
                0, mesh, SH.batch_axes(mesh), dev), 0)
        flat = dict(iter_leaves(specs))
        trees = {name: {"/".join(k): collectives.gather_leaf(
            v, flat[k], mesh).cpu().numpy() for k, v in iter_leaves(tree)}
            for name, tree in (("params", p), ("mu", o["mu"]))}
        smoke[tag] = dict(metrics={k: float(v) for k, v in m.items()},
                          **(trees if rank == 0 else {}))
        del p, o
    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=spec["layers"])
    out, n_params = _train_runs(torch, dev, cfg, spec, meshes, timer, zero,
                                counts, exchange=a2a)
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(),
                smoke=smoke, runs=out, n_params=n_params)


def moe_smoke(get, smoke_variant):
    """Phase 24's small f32 stack: moonshot's smoke variant (8 experts
    top-2, a shared expert) with heads of 64, the narrowest B4 takes."""
    return dataclasses.replace(smoke_variant(get(MOE_ARCH)), head_dim=64)


def _active_params(cfg) -> int:
    """The parameters a token's products use in one layer of a MoE stack:
    the attention's four projections, the shared SwiGLU, the gate and
    ``top_k`` of the experts."""
    attn = 4 * cfg.d_model * cfg.n_heads * cfg.hd
    shared = 3 * cfg.d_model * cfg.moe_d_ff * cfg.n_shared_experts
    return (attn + shared + cfg.d_model * cfg.n_experts
            + cfg.top_k * 3 * cfg.d_model * cfg.moe_d_ff)


def _trees_close(np, got, want, scaled: bool) -> float:
    """The largest |got - want| over two {name: array} trees, over the
    largest |want| where ``scaled``."""
    err = max(float(np.abs(got[k] - w).max()) for k, w in want.items())
    if scaled:
        err /= max(float(np.abs(w).max()) for w in want.values())
    return err


def train_moe_mesh_phase(torch, np, MESH, get, smoke_variant, n_ranks: int,
                         seed: int, flash_fwd, flash_bwd, gen, flush):
    """Phase 24 on ``n_ranks`` ranks (four NCCL ranks, one a card, or two
    gloo ranks sharing one card) -> (measurements, per-rank launches of the
    full-width runs, B4's and B5's results at a model rank's micro-batch).
    Fails on any gate."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         iter_leaves)
    from repro_torch.runtime.steps import make_train_step
    full = n_ranks >= 4
    nccl = full and torch.cuda.device_count() >= n_ranks
    layers, seq, batch = ((MOE_TRAIN_FULL_LAYERS, MESH_TRAIN_FULL_SEQ,
                           MESH_TRAIN_FULL_BATCH) if full
                          else (MOE_TRAIN_LAYERS, MESH_TRAIN_SEQ,
                                MESH_TRAIN_BATCH))
    steps = MOE_TRAIN_STEPS if full else 1
    A = MESH_TRAIN_ACCUM
    n = n_ranks
    runs = [dict(tag=f"1x{n}", mesh=(1, n))]
    if full:
        runs.append(dict(tag="2x2", mesh=(2, 2)))
    runs.append(dict(tag=f"{n}", mesh=(n, 1)))
    # the smoke gate: 1xN against one rank; a model axis's two rules
    # (the same routing) against each other
    pair = (2, 2) if full else (1, n)
    pair_tag = f"{pair[0]}x{pair[1]}"
    smoke_runs = {f"1x{n}": ((1, n), "seq"), f"{pair_tag}/seq": (pair, "seq"),
                  f"{pair_tag}/none": (pair, "none")}
    if not full:
        del smoke_runs[f"1x{n}"]
    one_tag = f"1x{n}" if full else f"{pair_tag}/seq"
    cfg = dataclasses.replace(get(MOE_ARCH), n_layers=layers)
    log(f"phase 24: training {MOE_ARCH} on {n} ranks over "
        f"{'NCCL, one card each' if nccl else 'gloo on one card'}; full "
        f"width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
        f"of {cfg.hd}, {cfg.n_experts} experts of {cfg.moe_d_ff} top-"
        f"{cfg.top_k}, shared SwiGLU of {cfg.moe_d_ff * cfg.n_shared_experts}"
        f", "
        f"vocab {cfg.vocab_size}, tied), {layers} of 48 layers, global "
        f"batch {batch} x seq {seq}, grad_accum {A}, remat, bf16 weights and "
        f"f32 moments, {steps} step(s) a mesh; meshes "
        f"{[r['mesh'] for r in runs]} (the sequence split over model)")

    # B4 with statistics and B5 at the micro-batch of the last model rank
    # of 1xN (moonshot's heads: 16 / 16 of 128)
    b_mb = batch // A
    t_loc = seq // n
    heads = (cfg.n_heads, cfg.n_kv_heads)
    b5 = check_flash_bwd(torch, flash_fwd, flash_bwd, gen, flush, t_loc,
                         heads, cfg.hd, Tk=seq, B=b_mb, q_base=seq - t_loc)
    b4 = check_flash(torch, flash_fwd, t_loc, gen, flush, heads=heads,
                     D=cfg.hd, B=b_mb, q_base=seq - t_loc, Tk=seq)
    gc.collect()
    torch.cuda.empty_cache()

    # the one-rank reference of the smoke gate, on this card
    cfg_s = moe_smoke(get, smoke_variant)
    from repro_torch.data import DataConfig, SyntheticLMData
    p_s = M.init_params(cfg_s, seed, device="cuda")
    p_s, o_s, m_s = make_train_step(cfg_s, AdamWConfig(lr=1e-3), remat=True,
                                    grad_accum=2)(
        p_s, adamw_init(p_s), SyntheticLMData(DataConfig(
            cfg_s.vocab_size, 64, 4, seed)).batch(0, "cuda"), 0)
    one = {name: {"/".join(k): v.detach().cpu().numpy()
                  for k, v in iter_leaves(tree)}
           for name, tree in (("params", p_s), ("mu", o_s["mu"]))}
    del p_s, o_s

    spec = dict(seed=seed, layers=layers, seq=seq, batch=batch, steps=steps,
                runs=runs, smoke_runs=smoke_runs)
    t0 = time.perf_counter()
    res = MESH.spawn(train_moe_mesh_rank, n, spec, device="cuda",
                     backend="nccl" if nccl else "gloo", timeout=1500)
    wall = time.perf_counter() - t0
    r0 = res[0]
    log(f"phase 24 ranks: {n} x {r0['device']} over {r0['backend']}, spawn "
        f"+ steps {wall:.1f}s; {r0['n_params'] / 1e9:.3f} B parameters")
    problems = []

    # the smoke stack (f32): 1xN against one rank; seq against none
    sm = r0["smoke"]
    gaps = dict(
        params=_trees_close(np, sm[one_tag]["params"], one["params"], False),
        mu=_trees_close(np, sm[one_tag]["mu"], one["mu"], True),
        seq_none_mu=_trees_close(np, sm[f"{pair_tag}/seq"]["mu"],
                                 sm[f"{pair_tag}/none"]["mu"], True))
    log(f"phase 24 smoke stack (f32): {one_tag} against one rank: "
        f"parameters within {gaps['params']:.2e}, first moments within "
        f"{gaps['mu']:.2e} of their largest; {pair_tag} 'seq' against "
        f"'none' first moments within {gaps['seq_none_mu']:.2e} (tol 2e-4 "
        f"each); losses "
        f"{[round(v['metrics']['loss'], 6) for v in sm.values()]}")
    if not max(gaps.values()) <= 2e-4:
        problems.append(f"smoke stack off: {gaps}")
    for tag in smoke_runs:
        ls = {r["smoke"][tag]["metrics"]["loss"] for r in res}
        if len(ls) != 1:
            problems.append(f"smoke {tag}: the ranks' losses differ {ls}")

    share_max = 0.3 if full else 0.55
    active = layers * _active_params(cfg) + cfg.vocab_size * cfg.d_model
    pairs = seq * (seq + 1) // 2
    model_flops = (6 * active * batch * seq
                   + 12 * batch * cfg.n_heads * cfg.hd * pairs * layers)
    per_step = {"flash_fwd": 2 * layers * A, "flash_bwd": layers * A}
    out = dict(ranks=n, backend=r0["backend"], layers=layers, seq=seq,
               batch=batch, grad_accum=A, steps=steps, smoke_gaps=gaps,
               active_params=active, model_flops_a_step=model_flops,
               flops_formula="6 x (layers x (4 d H hd + 3 d moe_d_ff "
               "n_shared + d E + top_k x 3 d moe_d_ff) + V d) x tokens + 12 "
               "x B x H x hd x T(T+1)/2 x layers; each expert rank computes "
               "M copies of its rows (not counted)", runs={})
    launches = {}
    for run in runs:
        tag = run["tag"]
        per = [r["runs"][tag] for r in res]
        n_model = run["mesh"][1]
        for rank, p in enumerate(per):
            bad = [s for s in p["steps"] if not (math.isfinite(s["loss"])
                                                 and math.isfinite(
                                                     s["grad_norm"]))]
            if bad:
                problems.append(f"{tag} rank {rank}: non-finite {bad}")
            if p["resident_share"] > share_max:
                problems.append(f"{tag} rank {rank}: resident state "
                                f"{p['resident_share']:.3f} of the tree > "
                                f"{share_max}")
            ln = p["launches"]
            want = {k: v * steps for k, v in per_step.items()}
            if {k: ln[k] for k in want} != want or ln["ecf8_decode"] or \
                    ln["kv_page_decode"] or ln["fused_decode_matmul"]:
                problems.append(f"{tag} rank {rank}: launches {ln}, "
                                f"expected {want} and no other kernel")
            q_rank = rank % n_model != 0
            if (ln["flash_fwd_q_base"], ln["flash_bwd_q_base"]) != (
                    (want["flash_fwd"], want["flash_bwd"]) if q_rank
                    else (0, 0)):
                problems.append(f"{tag} rank {rank}: launches with q_base "
                                f"{ln}")
            # two exchanges a MoE layer a micro-batch, again in the
            # recompute, and their backward
            a2a_want = 6 * layers * A if n_model > 1 else 0
            if p["all_to_all_calls"] != a2a_want:
                problems.append(f"{tag} rank {rank}: {p['all_to_all_calls']}"
                                f" all_to_all a step, expected {a2a_want}")
        for i in range(steps):
            ls = {p["steps"][i]["loss"] for p in per}
            if len(ls) != 1:
                problems.append(f"{tag} step {i}: the ranks' losses differ "
                                f"{ls}")
        step_s = statistics.median([x for p in per
                                    for x in p["step_ms"][1:]
                                    or p["step_ms"]]) / 1e3
        tok_s = batch * seq / step_s
        share = model_flops / step_s / (n * H100_BF16_FLOPS)
        out["runs"][tag] = dict(
            mesh=run["mesh"], loss=[s["loss"] for s in per[0]["steps"]],
            aux=[s["aux"] for s in per[0]["steps"]],
            grad_norm=[s["grad_norm"] for s in per[0]["steps"]],
            step_ms=[p["step_ms"] for p in per], median_step_ms=step_s * 1e3,
            tokens_per_s=tok_s, flop_share=share,
            all_to_all_ms=[p["all_to_all_ms"] for p in per],
            all_to_all_calls=[p["all_to_all_calls"] for p in per],
            collectives_ms=[p["collectives_ms"] for p in per],
            collectives=per[0]["collectives"],
            timed_step_ms=[p["timed_step_ms"] for p in per],
            resident_gib=[p["resident_gib"] for p in per],
            resident_share=[p["resident_share"] for p in per],
            whole_gib=per[0]["whole_gib"],
            peak_gib=[p["peak_gib"] for p in per],
            build_s=[p["build_s"] for p in per],
            launches=[p["launches"] for p in per])
        launches[f"train_moe_{tag}"] = [p["launches"] for p in per]
        log(f"phase 24 {tag} (mesh {list(run['mesh'])}): losses "
            f"{[round(x, 5) for x in out['runs'][tag]['loss']]} aux "
            f"{[round(x, 4) for x in out['runs'][tag]['aux']]} grad_norm "
            f"{[round(x, 4) for x in out['runs'][tag]['grad_norm']]}; a rank"
            f"'s step {[[round(x, 1) for x in p['step_ms']] for p in per]} "
            f"ms (median {step_s * 1e3:.1f}); all_to_all "
            f"{[round(p['all_to_all_calls']) for p in per]} calls a step, "
            f"{[round(p['all_to_all_ms'], 1) for p in per]} ms, the other "
            f"collectives {[round(p['collectives_ms'], 1) for p in per]} ms "
            f"in {per[0]['collectives']} calls (a synchronised step of "
            f"{[round(p['timed_step_ms'], 1) for p in per]} ms); resident "
            f"{[round(p['resident_gib'], 3) for p in per]} GiB of "
            f"{per[0]['whole_gib']:.3f} "
            f"({max(p['resident_share'] for p in per):.3f}), peak "
            f"{[round(p['peak_gib'], 2) for p in per]} GiB; build "
            f"{[round(p['build_s'], 1) for p in per]} s; {tok_s:.0f} "
            f"tokens/s, model FLOPs {model_flops / 1e12:.1f} T a step "
            f"({active / 1e9:.3f} B active parameters a token) = "
            f"{100 * share:.2f} % of {n} x 989 TFLOP/s; launches "
            f"{per[0]['launches']} (rank 0), {per[-1]['launches']} (rank "
            f"{n - 1})")
    # 1xN and N route as one device does: step 0 alike
    first, last = out["runs"][runs[0]["tag"]], out["runs"][runs[-1]["tag"]]
    gap = dict(loss=abs(first["loss"][0] - last["loss"][0])
               / abs(last["loss"][0]),
               grad_norm=abs(first["grad_norm"][0] - last["grad_norm"][0])
               / abs(last["grad_norm"][0]))
    out["step0_gap"] = gap
    log(f"phase 24 step 0 on {runs[0]['tag']} against {runs[-1]['tag']}: "
        f"{gap} (tol loss 5e-3, grad_norm 2e-2)")
    if not (gap["loss"] <= 5e-3 and gap["grad_norm"] <= 2e-2):
        problems.append(f"step 0 of {runs[0]['tag']} off {runs[-1]['tag']}'s:"
                        f" {gap}")
    if problems:
        fail("phase 24: " + "; ".join(problems))
    return out, launches, dict(b5=b5, b4=b4)


def _mixer_probe(torch, M):
    """Wrap ``models.model._mixer_full`` (a recurrent layer's mixer over
    the whole sequence) so that, while the returned dict's ``"on"``, each
    call is timed on the host clock from a synchronised start: to its
    return (the host's issue of the mixer's kernels) and to the card's
    end of them, summed by kind into ``"by_kind"`` -> the dict, whose
    ``"restore"`` puts the mixer back."""
    probe = {"on": False, "by_kind": {}}
    mixer = M._mixer_full

    def timed(p, h, cfg, kind, dtype):
        if not probe["on"]:
            return mixer(p, h, cfg, kind, dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mixer(p, h, cfg, kind, dtype)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k = probe["by_kind"].setdefault(kind, [0.0, 0.0, 0])
        k[0] += t1 - t0
        k[1] += t2 - t0
        k[2] += 1
        return out

    def restore():
        M._mixer_full = mixer

    M._mixer_full = timed
    probe["restore"] = restore
    return probe


def _mixer_ms(probe, n: int) -> dict:
    """{kind: {"issue_ms", "ms", "calls"}} a step of ``n`` timed steps."""
    return {kind: dict(issue_ms=v[0] * 1e3 / n, ms=v[1] * 1e3 / n,
                       calls=v[2] / n)
            for kind, v in probe["by_kind"].items()}


def train_rec_mesh_rank(rank, world, dev, spec):
    """One rank of phase 25 (a process of its own, started by
    ``launch.mesh.spawn``): each small f32 stack of ``spec["small"]``
    ({arch: config overrides of its smoke variant}) trained one step on
    ``spec["small_mesh"]`` under the sequence split, its parameters
    gathered whole on rank 0; then each full-width stack of
    ``spec["stacks"]`` on each mesh of ``spec["runs"]`` as phase 23's runs
    (:func:`_train_runs`), the recurrent mixers' forward timed where the
    collectives are -> a dict of plain values."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get, smoke_variant
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, iter_leaves
    from repro_torch.runtime import collectives
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import steps as S

    meshes, timer, zero, counts = _train_rank_setup(
        torch, [r["mesh"] for r in spec["runs"]] + [spec["small_mesh"]])
    probe = _mixer_probe(torch, M)
    mesh_s = meshes[tuple(spec["small_mesh"])]
    small = {}
    for arch, over in spec["small"].items():
        cfg_s = dataclasses.replace(smoke_variant(get(arch)), **over)
        p, specs = S.init_sharded(cfg_s, spec["seed"], mesh_s, device=dev)
        data_s = SyntheticLMData(DataConfig(cfg_s.vocab_size, 64, 4,
                                            spec["seed"]))
        p, _, m = S.make_train_step(
            cfg_s, AdamWConfig(lr=1e-3), mesh=mesh_s, remat=True,
            grad_accum=2)(p, adamw_init(p), data_s.sharded_batch(
                0, mesh_s, SH.batch_axes(mesh_s), dev), 0)
        flat = dict(iter_leaves(specs))
        params = {"/".join(k): collectives.gather_leaf(v, flat[k], mesh_s)
                  .cpu().numpy() for k, v in iter_leaves(p)}
        small[arch] = dict(loss=float(m["loss"]),
                           grad_norm=float(m["grad_norm"]),
                           params=params if rank == 0 else None)
        del p
    full = {}
    for arch, layers, seq, batch in spec["stacks"]:
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        out, n_params = _train_runs(
            torch, dev, cfg, dict(spec, seq=seq, batch=batch), meshes, timer,
            zero, counts, mixer=probe)
        full[arch] = dict(runs=out, n_params=n_params)
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(),
                small=small, full=full)


def _rec_model_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """A step's model FLOPs: 6 x the parameters a token's products use
    (the tied embedding is the unembedding's) x tokens, and the attention's
    12 x B x H x hd x visible pairs a layer (a local layer's within its
    window); the recurrent mixers' elementwise work and each model rank's
    repeat of the whole sequence's mixer are not counted."""
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else cfg.vocab_size * cfg.d_model)
    W = min(cfg.local_window, seq)
    pairs = {"attn": seq * (seq + 1) // 2, "nope": seq * (seq + 1) // 2,
             "local": seq * W - W * (W - 1) // 2}
    kinds = [cfg.pattern[i % cfg.unit] for i in range(
        cfg.n_layers - cfg.n_layers % cfg.unit)]
    attn = sum(pairs.get(k, 0) for k in kinds)
    return 6 * n_matmul * batch * seq + 12 * batch * cfg.n_heads * cfg.hd \
        * attn


def train_rec_mesh_phase(torch, np, MESH, get, smoke_variant, n_ranks: int,
                         seed: int, flash_fwd, flash_bwd, gen, flush):
    """Phase 25 on ``n_ranks`` ranks (four NCCL ranks, one a card, or two
    gloo ranks sharing one card) -> (measurements, per-rank launches of the
    full-width runs, B4's and B5's results at gemma2's shard shape).  Fails
    on any gate."""
    from repro_torch.core.store import torch_dtype
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         iter_leaves)
    from repro_torch.runtime.steps import make_train_step
    full = n_ranks >= 4
    nccl = full and torch.cuda.device_count() >= n_ranks
    stacks = REC_TRAIN_FULL if full else REC_TRAIN_ONE_CARD
    steps = REC_TRAIN_STEPS if full else 1
    A = MESH_TRAIN_ACCUM
    runs = ([dict(tag=f"1x{n_ranks}", mesh=(1, n_ranks)),
             dict(tag="2x2", mesh=(2, 2))] if full
            else [dict(tag=f"1x{n_ranks}", mesh=(1, n_ranks))])
    small_mesh = (2, 2) if full else (1, n_ranks)
    log(f"phase 25: training the recurrent and sliding-window stacks on "
        f"{n_ranks} ranks over "
        f"{'NCCL, one card each' if nccl else 'gloo on one card'}; full "
        f"width, bf16 weights and f32 moments, grad_accum {A}, remat, "
        f"{steps} step(s) a mesh on {[r['mesh'] for r in runs]} (the "
        f"sequence split over model): "
        + "; ".join(f"{a} {n} layers, batch {b} x seq {t}"
                    for a, n, t, b in stacks))

    # B4 with statistics and B5 at gemma2's shard shape: a micro-batch of
    # the last model rank of 1x4 at seq 8192 (rows [6144, 8192))
    g2 = get(GEMMA_ARCH)
    _, _, seq_g2, batch_g2 = REC_TRAIN_FULL[2]
    b_mb, t_loc = batch_g2 // A, seq_g2 // 4
    heads = (g2.n_heads, g2.n_kv_heads)
    b5 = check_flash_bwd(torch, flash_fwd, flash_bwd, gen, flush, t_loc,
                         heads, g2.hd, softcap=g2.attn_softcap, Tk=seq_g2,
                         B=b_mb, q_base=seq_g2 - t_loc)
    b4 = check_flash(torch, flash_fwd, t_loc, gen, flush, heads=heads,
                     D=g2.hd, softcap=g2.attn_softcap, B=b_mb,
                     q_base=seq_g2 - t_loc, Tk=seq_g2)
    gc.collect()
    torch.cuda.empty_cache()

    # the one-rank references on this card: each small f32 stack's step
    # and, for the stacks a card holds, step 0 unsharded at full width
    # gemma2's global layers launch B4 / B5, whose narrowest head is 64
    small = {RG_ARCH: {}, XLSTM_ARCH: {}, GEMMA_ARCH: dict(head_dim=64)}
    small_want = {}
    for arch, over in small.items():
        cfg_s = dataclasses.replace(smoke_variant(get(arch)), **over)
        p_s = M.init_params(cfg_s, seed, device="cuda")
        p_s, _, m_s = make_train_step(cfg_s, AdamWConfig(lr=1e-3),
                                      remat=True, grad_accum=2)(
            p_s, adamw_init(p_s), SyntheticLMData(DataConfig(
                cfg_s.vocab_size, 64, 4, seed)).batch(0, "cuda"), 0)
        small_want[arch] = dict(loss=float(m_s["loss"]), params={
            "/".join(k): v.detach().cpu().numpy()
            for k, v in iter_leaves(p_s)})
        del p_s
    probe = _mixer_probe(torch, M)
    one = {}
    for arch, layers, seq, batch in stacks:
        if arch == GEMMA_ARCH:
            continue            # more state than one card holds
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        accum = batch if arch in REC_ONE_ROW else A
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p1 = M.init_params(cfg, seed, device="cuda",
                           dtype=torch_dtype(cfg.dtype))
        data = SyntheticLMData(DataConfig(cfg.vocab_size, seq, batch, seed))
        probe.update(on=True, by_kind={})
        t1 = time.perf_counter()
        _, _, m1 = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR),
                                   remat=True, grad_accum=accum,
                                   warmup_steps=1, total_steps=steps)(
            p1, adamw_init(p1), data.batch(0, "cuda"), 0)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        probe["on"] = False
        one[arch] = dict({k: float(v) for k, v in m1.items()},
                         grad_accum=accum, step_ms=step_s * 1e3,
                         mixer_ms=_mixer_ms(probe, 1),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del p1, m1
        log(f"phase 25 {arch} one rank unsharded at {layers} layers, step "
            f"0: loss {one[arch]['loss']:.6f} grad_norm "
            f"{one[arch]['grad_norm']:.5f}, grad_accum {accum}, "
            f"{step_s * 1e3:.1f} ms (the mixers' forward "
            + ", ".join(f"{k} {v['ms']:.1f}" for k, v in
                        one[arch]["mixer_ms"].items())
            + f" ms), peak {one[arch]['peak_gib']:.2f} GiB "
            f"({time.perf_counter() - t0:.1f} s with the build)")
    probe["restore"]()
    gc.collect()
    torch.cuda.empty_cache()

    spec = dict(seed=seed, steps=steps, runs=runs, stacks=stacks,
                small=small, small_mesh=small_mesh)
    t0 = time.perf_counter()
    res = MESH.spawn(train_rec_mesh_rank, n_ranks, spec, device="cuda",
                     backend="nccl" if nccl else "gloo", timeout=1500)
    wall = time.perf_counter() - t0
    r0 = res[0]
    log(f"phase 25 ranks: {n_ranks} x {r0['device']} over {r0['backend']}, "
        f"spawn + builds + steps {wall:.1f}s")
    problems = []
    small_gaps = {}
    for arch, want in small_want.items():
        errs = [abs(r["small"][arch]["loss"] - want["loss"])
                / abs(want["loss"]) for r in res]
        p_err = _trees_close(np, r0["small"][arch]["params"],
                             want["params"], False)
        small_gaps[arch] = dict(loss=max(errs), params=p_err)
        if not (max(errs) <= 2e-4 and p_err <= 2e-4):
            problems.append(f"small {arch} off one rank's: loss {errs}, "
                            f"parameters {p_err}")
    log(f"phase 25 small f32 stacks on {list(small_mesh)} against one rank "
        f"(loss gap, largest parameter gap; tol 2e-4): "
        + ", ".join(f"{a} {g['loss']:.2e} / {g['params']:.2e}"
                    for a, g in small_gaps.items()))
    share_max = 0.3 if full else 0.55
    out = dict(ranks=n_ranks, backend=r0["backend"], grad_accum=A,
               steps=steps, small_gaps=small_gaps, one_rank=one, stacks={},
               flops_formula="6 x parameters (the tied embedding once) x "
               "tokens + 12 x B x H x hd x visible pairs (a local layer's "
               "within its window) a layer")
    launches = {}
    for arch, layers, seq, batch in stacks:
        cfg = dataclasses.replace(get(arch), n_layers=layers)
        n_global = (layers // cfg.unit) * cfg.pattern.count("attn")
        per_step = {"flash_fwd": 2 * n_global * A, "flash_bwd": n_global * A}
        n_params = r0["full"][arch]["n_params"]
        model_flops = _rec_model_flops(cfg, n_params, batch, seq)
        st = out["stacks"][arch] = dict(layers=layers, seq=seq, batch=batch,
                                        n_params=n_params,
                                        model_flops_a_step=model_flops,
                                        runs={})
        for run in runs:
            tag = run["tag"]
            per = [r["full"][arch]["runs"][tag] for r in res]
            n_model = run["mesh"][1]
            for rank, p in enumerate(per):
                bad = [s for s in p["steps"]
                       if not (math.isfinite(s["loss"])
                               and math.isfinite(s["grad_norm"]))]
                if bad:
                    problems.append(f"{arch} {tag} rank {rank}: non-finite "
                                    f"{bad}")
                if p["resident_share"] > share_max:
                    problems.append(f"{arch} {tag} rank {rank}: resident "
                                    f"state {p['resident_share']:.3f} of the "
                                    f"tree > {share_max}")
                ln = p["launches"]
                want = {k: v * steps for k, v in per_step.items()}
                if {k: ln[k] for k in want} != want or ln["ecf8_decode"] or \
                        ln["kv_page_decode"] or ln["fused_decode_matmul"]:
                    problems.append(f"{arch} {tag} rank {rank}: launches "
                                    f"{ln}, expected {want} and no other "
                                    f"kernel")
                q_rank = rank % n_model != 0
                if (ln["flash_fwd_q_base"], ln["flash_bwd_q_base"]) != (
                        (want["flash_fwd"], want["flash_bwd"]) if q_rank
                        else (0, 0)):
                    problems.append(f"{arch} {tag} rank {rank}: launches "
                                    f"with q_base {ln}")
            for i in range(steps):
                ls = {p["steps"][i]["loss"] for p in per}
                if len(ls) != 1:
                    problems.append(f"{arch} {tag} step {i}: the ranks' "
                                    f"losses differ {ls}")
            step_s = statistics.median([x for p in per
                                        for x in p["step_ms"][1:]
                                        or p["step_ms"]]) / 1e3
            tok_s = batch * seq / step_s
            share = model_flops / step_s / (n_ranks * H100_BF16_FLOPS)
            st["runs"][tag] = dict(
                mesh=run["mesh"], loss=[s["loss"] for s in per[0]["steps"]],
                grad_norm=[s["grad_norm"] for s in per[0]["steps"]],
                step_ms=[p["step_ms"] for p in per],
                median_step_ms=step_s * 1e3, tokens_per_s=tok_s,
                flop_share=share,
                collectives_ms=[p["collectives_ms"] for p in per],
                collectives=per[0]["collectives"],
                timed_step_ms=[p["timed_step_ms"] for p in per],
                mixer_ms=[p["mixer_ms"] for p in per],
                resident_gib=[p["resident_gib"] for p in per],
                resident_share=[p["resident_share"] for p in per],
                whole_gib=per[0]["whole_gib"],
                peak_gib=[p["peak_gib"] for p in per],
                build_s=[p["build_s"] for p in per],
                launches=[p["launches"] for p in per])
            launches[f"train_rec_{arch}_{tag}"] = [p["launches"]
                                                   for p in per]
            mixers = {k: (round(v["issue_ms"], 1), round(v["ms"], 1))
                      for k, v in per[0]["mixer_ms"].items()}
            log(f"phase 25 {arch} {tag} (mesh {list(run['mesh'])}, "
                f"{n_params / 1e9:.3f} B parameters): losses "
                f"{[round(x, 5) for x in st['runs'][tag]['loss']]} grad_norm "
                f"{[round(x, 4) for x in st['runs'][tag]['grad_norm']]}; a "
                f"rank's step "
                f"{[[round(x, 1) for x in p['step_ms']] for p in per]} ms "
                f"(median {step_s * 1e3:.1f}), collectives "
                f"{[round(p['collectives_ms'], 1) for p in per]} ms in "
                f"{per[0]['collectives']} calls (a synchronised step of "
                f"{[round(p['timed_step_ms'], 1) for p in per]} ms), the "
                f"mixers' forward (issue, end) ms {mixers} (rank 0); "
                f"resident {[round(p['resident_gib'], 3) for p in per]} GiB "
                f"of {per[0]['whole_gib']:.3f} "
                f"({max(p['resident_share'] for p in per):.3f}), peak "
                f"{[round(p['peak_gib'], 2) for p in per]} GiB; build "
                f"{[round(p['build_s'], 1) for p in per]} s; {tok_s:.0f} "
                f"tokens/s, model FLOPs {model_flops / 1e12:.1f} T a step = "
                f"{100 * share:.2f} % of {n_ranks} x 989 TFLOP/s; launches "
                f"{per[0]['launches']} (rank 0), {per[-1]['launches']} (rank "
                f"{n_ranks - 1})")
        # step 0 against one rank unsharded, or (gemma2) the other mesh's
        if arch in one:
            against = "one rank"
            w_loss, w_norm = one[arch]["loss"], one[arch]["grad_norm"]
            tags = [r["tag"] for r in runs]
        else:
            against = runs[1]["tag"]
            w_loss = st["runs"][against]["loss"][0]
            w_norm = st["runs"][against]["grad_norm"][0]
            tags = [runs[0]["tag"]]
        gaps = {t: dict(loss=abs(st["runs"][t]["loss"][0] - w_loss)
                        / abs(w_loss),
                        grad_norm=abs(st["runs"][t]["grad_norm"][0] - w_norm)
                        / abs(w_norm)) for t in tags}
        st["step0_gaps"] = dict(against=against, gaps=gaps)
        log(f"phase 25 {arch} step 0 against {against}: {gaps} (tol loss "
            f"5e-3, grad_norm 2e-2)")
        if not all(g["loss"] <= 5e-3 and g["grad_norm"] <= 2e-2
                   for g in gaps.values()):
            problems.append(f"{arch} step 0 off {against}'s: {gaps}")
    if problems:
        fail("phase 25: " + "; ".join(problems))
    return out, launches, dict(b5=b5, b4=b4)


def _steps_frames(torch, cfg, batch: int, step: int, seed: int, dev):
    """Global batch ``step``'s encoder frames (batch, F, d) in the config's
    dtype, drawn from the seed on ``dev`` (every rank draws the same)."""
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + step + 1)
    return torch.randn((batch, cfg.encoder_frames, cfg.d_model), generator=g,
                       device=dev).to(getattr(torch, cfg.dtype))


def _rank_rows(mesh, x):
    """This rank's rows of a global batch (all of them without a mesh)."""
    from repro_torch.runtime import sharding as SH
    if mesh is None:
        return x
    per = x.shape[0] // SH.n_batch_shards(mesh)
    lo = SH.batch_index(mesh) * per
    return x[lo:lo + per]


def _factory_run(torch, dev, cfg, tree, mesh, toks, frames, max_len: int,
                 zero, counts):
    """Phase 26's serve run on this rank: ``make_prefill_step(mesh=)`` on
    its rows of ``toks`` (and ``frames``), ``STEPS_NEW`` greedy
    ``make_decode_step`` calls, each timed on a synchronised host clock,
    then ``STEPS_TIMED`` more with every stat-merge gather synchronised and
    timed (without a mesh: the same on the whole batch) -> a dict of plain
    values."""
    import torch.distributed as dist
    from repro_torch.models import decode_sharded as DS
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime import steps as S

    gib = 2 ** 30
    batch = {"tokens": _rank_rows(mesh, toks)}
    if frames is not None:
        batch["frames"] = _rank_rows(mesh, frames)
    prefill = S.make_prefill_step(cfg, mesh=mesh, max_len=max_len)
    decode = S.make_decode_step(cfg, mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    zero()
    if mesh is not None:
        dist.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(tree, batch)
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    l_prefill = counts()
    zero()
    leaves = SH.flatten(cache)
    cache_b = sum(x.numel() * x.element_size() for x in leaves.values()
                  if x.device.type == "cuda")
    shapes = {"/".join(k): list(x.shape) for k, x in leaves.items()}
    out_toks, secs = [], []
    tok = logits[:, -1].argmax(-1)[:, None]
    for _ in range(STEPS_NEW):
        out_toks.append(tok[:, 0])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = decode(tree, {"token": tok}, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
    l_steps = counts()
    # the stat merge's gathers, synchronised and timed over a few more steps
    merge = {"s": 0.0, "n": 0}
    gather = DS.gather_rows

    def timed_gather(*a, **kw):
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        got = gather(*a, **kw)
        torch.cuda.synchronize(dev)
        merge["s"] += time.perf_counter() - t1
        merge["n"] += 1
        return got

    DS.gather_rows = timed_gather
    try:
        for _ in range(STEPS_TIMED):
            logits, cache = decode(tree, {"token": tok}, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
    finally:
        DS.gather_rows = gather
    torch.cuda.synchronize(dev)
    out = dict(tokens=torch.stack(out_toks, 1).cpu().tolist(),
               prefill_s=prefill_s, step_ms=[x * 1e3 for x in secs],
               launches_prefill=l_prefill, launches_steps=l_steps,
               cache_gib=cache_b / gib, shapes=shapes,
               peak_gib=(torch.cuda.max_memory_allocated(dev) - base) / gib,
               merge_ms=merge["s"] * 1e3 / STEPS_TIMED,
               merge_gathers=merge["n"] // STEPS_TIMED)
    del cache, logits
    return out


def steps_mesh_rank(rank, world, dev, spec):
    """One rank of phase 26 (a process of its own, started by
    ``launch.mesh.spawn``): whisper-base trained on each mesh of
    ``spec["train"]["runs"]`` as phase 23's runs (:func:`_train_runs`, the
    rank's rows of the frames in each batch), then each group of
    ``spec["groups"]``: the model's ECF8 and fp8 trees built on this rank's
    card from the seed and run through the step factories on each mesh
    (:func:`_factory_run`), rank 0 also alone on the whole batch from the
    fp8 tree -> a dict of plain values."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.launch import serve

    dims_all = ([r["mesh"] for r in spec["train"]["runs"]]
                + [m for g in spec["groups"] for m in g["meshes"]])
    meshes, timer, zero, counts = _train_rank_setup(torch, dims_all)
    gib = 2 ** 30
    out = dict(rank=rank, device=torch.cuda.get_device_name(dev),
               backend=dist.get_backend(), train={}, groups={})
    tr = spec["train"]
    wh = get(WHISPER_ARCH)

    def frames(i, mesh):
        return _rank_rows(mesh, _steps_frames(torch, wh, tr["batch"], i,
                                              spec["seed"], dev))

    out["train"], out["train_params"] = _train_runs(
        torch, dev, wh, dict(spec, runs=tr["runs"], seq=tr["seq"],
                             batch=tr["batch"], steps=tr["steps"]),
        meshes, timer, zero, counts, frames=frames)
    for g in spec["groups"]:
        cfg = dataclasses.replace(get(g["arch"]), n_layers=g["layers"])
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        dist.barrier()
        served, base, report, build_s = serve.build_params(
            cfg, spec["seed"], "tpu", device=dev, baseline=True)
        trees = {"ecf8": served, "fp8": base}
        res = dict(build_s=build_s,
                   resident_gib=(torch.cuda.memory_allocated(dev) - before)
                   / gib,
                   fp8_mb=report["fp8_bytes"] / 1e6,
                   ecf8_mb=report["compressed_bytes"] / 1e6, runs={})
        rng = np.random.default_rng(spec["seed"])
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (g["batch"], g["prompt"]))).to(dev)
        fr = (_steps_frames(torch, cfg, g["batch"], 0, spec["seed"], dev)
              if cfg.encoder_decoder else None)
        for dims in g["meshes"]:
            mesh = meshes[tuple(dims)]
            for name in ("ecf8", "fp8"):
                tag = f"{g['tag']}_{dims[0]}x{dims[1]}_{name}"
                res["runs"][tag] = _factory_run(
                    torch, dev, cfg, trees[name], mesh, toks, fr,
                    g["max_len"], zero, counts)
                if rank == 0:
                    log(f"rank 0: {tag} done")
        if rank == 0:       # the fp8 tree on card 0 alone, the whole batch
            res["alone"] = _factory_run(torch, dev, cfg, base, None, toks,
                                        fr, g["max_len"], zero, counts)
        dist.barrier()
        del trees, served, base, toks, fr
        out["groups"][g["tag"]] = res
    return out


def steps_mesh_phase(torch, np, MESH, get, n_ranks: int, seed: int,
                     flash_fwd, flash_bwd, gen, flush):
    """Phase 26 on ``n_ranks`` ranks (four NCCL ranks, one a card, or two
    gloo ranks sharing one card) -> (measurements, per-run launches of
    every rank, B4's and B5's results at whisper's cross-attention shape).
    Fails on any gate."""
    from repro_torch.core.store import torch_dtype
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    full = n_ranks >= 4
    nccl = full and torch.cuda.device_count() >= n_ranks
    A = MESH_TRAIN_ACCUM
    wh = get(WHISPER_ARCH)
    qw = get("qwen3-8b")
    if full:
        meshes = [(1, n_ranks), (2, n_ranks // 2)]
        batch, train_steps, q_layers = 2 * WHISPER_BATCH, STEPS_TRAIN_STEPS, \
            qw.n_layers
    else:
        meshes = [(1, n_ranks), (n_ranks, 1)]
        batch, train_steps, q_layers = WHISPER_BATCH, 1, QWEN_LAYERS
    runs = [dict(tag=f"whisper_{d}x{m}", mesh=(d, m)) for d, m in meshes]
    groups = [dict(tag="whisper", arch=WHISPER_ARCH,
                   layers=wh.n_layers, meshes=meshes, batch=batch,
                   prompt=STEPS_WHISPER_PROMPT, max_len=WHISPER_MAX_LEN),
              dict(tag="qwen3", arch="qwen3-8b", layers=q_layers,
                   meshes=meshes if full else [(1, n_ranks)], batch=batch,
                   prompt=STEPS_QWEN_PROMPT, max_len=STEPS_QWEN_MAX_LEN)]
    if full:
        groups.append(dict(tag="rg", arch=RG_ARCH, layers=get(RG_ARCH)
                           .n_layers, meshes=[(2, n_ranks // 2)],
                           batch=WHISPER_BATCH, prompt=STEPS_RG_PROMPT,
                           max_len=STEPS_RG_MAX_LEN))
    log(f"phase 26: the prefill and decode step factories on a mesh and "
        f"whisper-base trained there; {n_ranks} ranks over "
        f"{'NCCL, one card each' if nccl else 'gloo on one card'}; "
        f"whisper trained {train_steps} step(s) a mesh on {meshes} (batch "
        f"{batch} x {STEPS_WHISPER_SEQ}, {wh.encoder_frames} frames, "
        f"grad_accum {A}, remat, bf16 weights, f32 moments); factories: "
        + "; ".join(f"{g['arch']} at {g['layers']} layers on {g['meshes']},"
                    f" batch {g['batch']} x {g['prompt']}, max_len "
                    f"{g['max_len']}, {STEPS_NEW} greedy steps, ECF8 and "
                    f"fp8" for g in groups))

    # B5 and B4 with statistics at whisper's cross attention on a rank of
    # 1x4: a micro-batch's 4 rows, the rank's 112 decoder rows over 1500
    # frames, non-causal (no q_base)
    t_loc = STEPS_WHISPER_SEQ // 4
    b5 = check_flash_bwd(torch, flash_fwd, flash_bwd, gen, flush, t_loc,
                         (wh.n_heads, wh.n_kv_heads), wh.hd, causal=False,
                         B=WHISPER_BATCH, Tk=wh.encoder_frames)
    b4 = check_flash(torch, flash_fwd, t_loc, gen, flush,
                     heads=(wh.n_heads, wh.n_kv_heads), D=wh.hd,
                     causal=False, B=WHISPER_BATCH, Tk=wh.encoder_frames)
    gc.collect()
    torch.cuda.empty_cache()

    # one rank's unsharded step 0 on this card, the training gate's oracle
    torch.cuda.reset_peak_memory_stats()
    p1 = M.init_params(wh, seed, device="cuda", dtype=torch_dtype(wh.dtype))
    b0 = SyntheticLMData(DataConfig(wh.vocab_size, STEPS_WHISPER_SEQ, batch,
                                    seed)).batch(0, "cuda")
    b0["frames"] = _steps_frames(torch, wh, batch, 0, seed, "cuda")
    t0 = time.perf_counter()
    _, _, m1 = make_train_step(wh, AdamWConfig(lr=TRAIN_LR), remat=True,
                               grad_accum=A, warmup_steps=1,
                               total_steps=train_steps)(
        p1, adamw_init(p1), b0, 0)
    torch.cuda.synchronize()
    one = dict({k: float(v) for k, v in m1.items()},
               step_ms=(time.perf_counter() - t0) * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del p1, m1, b0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 26 whisper one rank unsharded, step 0: loss "
        f"{one['loss']:.6f} grad_norm {one['grad_norm']:.5f}, "
        f"{one['step_ms']:.1f} ms with the build, peak "
        f"{one['peak_gib']:.2f} GiB")

    spec = dict(seed=seed, groups=groups,
                train=dict(runs=runs, seq=STEPS_WHISPER_SEQ, batch=batch,
                           steps=train_steps))
    t0 = time.perf_counter()
    res = MESH.spawn(steps_mesh_rank, n_ranks, spec, device="cuda",
                     backend="nccl" if nccl else "gloo", timeout=1500)
    wall = time.perf_counter() - t0
    r0 = res[0]
    log(f"phase 26 ranks: {n_ranks} x {r0['device']} over {r0['backend']}, "
        f"spawn + builds + runs {wall:.1f}s")
    problems = []
    launches = {}
    out = dict(ranks=n_ranks, backend=r0["backend"], wall_s=wall,
               one_rank=one, train={}, groups={})
    none = ("ecf8_decode", "kv_page_decode", "fused_decode_matmul")

    # -- training: whisper's launches a step a rank, B4 with statistics
    # (the encoder's layers once, each decoder layer's self and cross
    # attention twice with remat) and B5, q_base on the decoder's self
    # attention of the model ranks past the first alone
    n_enc, n_dec = wh.n_encoder_layers, wh.n_layers
    per_step = {"flash_fwd": A * (n_enc + 2 * 2 * n_dec),
                "flash_bwd": A * (n_enc + 2 * n_dec)}
    q_step = {"flash_fwd_q_base": A * 2 * n_dec, "flash_bwd_q_base": A * n_dec}
    for run in runs:
        tag, (d, m) = run["tag"], run["mesh"]
        per = [r["train"][tag] for r in res]
        for rank, p in enumerate(per):
            bad = [s for s in p["steps"] if not (
                math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
            if bad:
                problems.append(f"{tag} rank {rank}: non-finite {bad}")
            ln = p["launches"]
            want = {k: v * train_steps for k, v in per_step.items()}
            want.update({k: (v * train_steps if rank % m else 0)
                         for k, v in q_step.items()})
            if {k: ln[k] for k in want} != want or any(ln[k] for k in none):
                problems.append(f"{tag} rank {rank}: launches {ln}, "
                                f"expected {want} and no other kernel")
        for i in range(train_steps):
            if len({p["steps"][i]["loss"] for p in per}) != 1:
                problems.append(f"{tag} step {i}: the ranks' losses differ")
        s0 = per[0]["steps"][0]
        gaps = dict(loss=abs(s0["loss"] - one["loss"]) / abs(one["loss"]),
                    grad_norm=abs(s0["grad_norm"] - one["grad_norm"])
                    / abs(one["grad_norm"]))
        if not (gaps["loss"] <= 5e-3 and gaps["grad_norm"] <= 2e-2):
            problems.append(f"{tag} step 0 off one rank's: {gaps}")
        step_s = statistics.median([x for p in per for x in
                                    p["step_ms"][1:] or p["step_ms"]]) / 1e3
        launches[f"train_{tag}"] = [p["launches"] for p in per]
        out["train"][tag] = dict(
            mesh=[d, m], loss=[s["loss"] for s in per[0]["steps"]],
            grad_norm=[s["grad_norm"] for s in per[0]["steps"]],
            step0_gaps=gaps, step_ms=[p["step_ms"] for p in per],
            median_step_ms=step_s * 1e3,
            tokens_per_s=batch * STEPS_WHISPER_SEQ / step_s,
            collectives_ms=[p["collectives_ms"] for p in per],
            collectives=per[0]["collectives"],
            timed_step_ms=[p["timed_step_ms"] for p in per],
            resident_gib=[p["resident_gib"] for p in per],
            whole_gib=per[0]["whole_gib"],
            peak_gib=[p["peak_gib"] for p in per],
            launches=[p["launches"] for p in per])
        log(f"phase 26 whisper trained on {tag}: losses "
            f"{[round(x, 5) for x in out['train'][tag]['loss']]}, step 0 "
            f"against one rank {gaps} (tol 5e-3 / 2e-2); a rank's step "
            f"{[[round(x, 1) for x in p['step_ms']] for p in per]} ms "
            f"(median {step_s * 1e3:.1f}), collectives "
            f"{[round(p['collectives_ms'], 1) for p in per]} ms in "
            f"{per[0]['collectives']} calls, resident "
            f"{[round(p['resident_gib'], 3) for p in per]} of "
            f"{per[0]['whole_gib']:.3f} GiB, peak "
            f"{[round(p['peak_gib'], 2) for p in per]} GiB; "
            f"{batch * STEPS_WHISPER_SEQ / step_s:.0f} tokens/s; launches "
            f"{per[0]['launches']} (rank 0), {per[-1]['launches']} (rank "
            f"{n_ranks - 1})")

    # -- the factories
    for g in groups:
        cfg = dataclasses.replace(get(g["arch"]), n_layers=g["layers"])
        per_g = [r["groups"][g["tag"]] for r in res]
        go = dict(arch=g["arch"], layers=g["layers"], batch=g["batch"],
                  prompt=g["prompt"], max_len=g["max_len"],
                  build_s=[p["build_s"] for p in per_g],
                  resident_gib=[p["resident_gib"] for p in per_g],
                  fp8_mb=per_g[0]["fp8_mb"], ecf8_mb=per_g[0]["ecf8_mb"],
                  runs={})
        kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
        # B4 a prefill: every layer whose self attention runs the flash
        # kernel (a global one, a local one whose window covers the
        # prompt), an encoder-decoder's encoder and cross attention
        n_self = sum(k in ("attn", "nope") or (
            k == "local" and cfg.local_window >= g["prompt"]) for k in kinds)
        n_other = (cfg.n_encoder_layers + cfg.n_layers
                   if cfg.encoder_decoder else 0)
        whole_b = None
        for dims in g["meshes"]:
            d, m = dims
            b_loc = g["batch"] // d
            for name in ("ecf8", "fp8"):
                tag = f"{g['tag']}_{d}x{m}_{name}"
                pr = [p["runs"][tag] for p in per_g]
                launches[tag] = [dict(p["launches_prefill"], **{
                    f"{k}_steps": v for k, v in p["launches_steps"].items()})
                    for p in pr]
                for rank, p in enumerate(pr):
                    lp, ls = p["launches_prefill"], p["launches_steps"]
                    split_q = m > 1 and g["prompt"] % m == 0
                    want_q = n_self if split_q and rank % m else 0
                    if (lp["flash_fwd"], lp["flash_fwd_q_base"]) != (
                            n_self + n_other, want_q):
                        problems.append(f"{tag} rank {rank}: B4 {lp}, "
                                        f"expected {n_self + n_other} with "
                                        f"{want_q} q_base")
                    if ls["flash_fwd"] or any(x[k] for x in (lp, ls)
                                              for k in ("kv_page_decode",
                                                        "fused_decode_matmul",
                                                        "flash_bwd")):
                        problems.append(f"{tag} rank {rank}: launches "
                                        f"{lp} / {ls}")
                    b1 = lp["ecf8_decode"] and ls["ecf8_decode"]
                    if (name == "ecf8") != bool(b1) or (
                            name == "fp8" and (lp["ecf8_decode"]
                                               or ls["ecf8_decode"])):
                        problems.append(f"{tag} rank {rank}: B1 {lp} / {ls}")
                    # the rank cache: its rows, each self-attention row cut
                    # where the model axis divides its length, the rest whole
                    sh = p["shapes"]
                    for key, kind in (("pos0", cfg.pattern[0]),
                                      ("pos2", "local")):
                        if f"units/{key}/k" not in sh or kind not in (
                                "attn", "local"):
                            continue
                        S = (min(cfg.local_window, g["max_len"])
                             if kind == "local" else g["max_len"])
                        want_s = [cfg.n_layers // cfg.unit, b_loc,
                                  cfg.n_kv_heads, S // m if S % m == 0
                                  else S, cfg.hd]
                        if sh[f"units/{key}/k"] != want_s:
                            problems.append(f"{tag} rank {rank}: units/{key}"
                                            f"/k {sh[f'units/{key}/k']}, not "
                                            f"{want_s}")
                    if cfg.encoder_decoder and sh["units/cross/k"] != [
                            cfg.n_layers, b_loc, cfg.n_kv_heads,
                            cfg.encoder_frames, cfg.hd]:
                        problems.append(f"{tag}: cross K/V "
                                        f"{sh['units/cross/k']}, not whole")
                    for key, x in sh.items():
                        if key.endswith("/h") and x[-1] != cfg.d_model:
                            problems.append(f"{tag}: state {key} {x}, not "
                                            f"whole over model")
                toks = [p["tokens"] for p in pr]
                for rank in range(n_ranks):
                    if toks[rank] != toks[rank - rank % m]:
                        problems.append(f"{tag}: rank {rank}'s tokens differ "
                                        f"from its data group's")
                steps_s = [statistics.median(p["step_ms"]) / 1e3 for p in pr]
                go["runs"][tag] = dict(
                    mesh=[d, m], prefill_s=[p["prefill_s"] for p in pr],
                    step_ms=[statistics.median(p["step_ms"]) for p in pr],
                    tokens_per_s=g["batch"] / max(steps_s),
                    cache_gib=[p["cache_gib"] for p in pr],
                    peak_gib=[p["peak_gib"] for p in pr],
                    merge_ms=[p["merge_ms"] for p in pr],
                    merge_gathers=pr[0]["merge_gathers"],
                    cache_k=pr[0]["shapes"].get("units/pos0/k"),
                    launches_prefill=[p["launches_prefill"] for p in pr],
                    launches_a_step={k: [p["launches_steps"][k] / STEPS_NEW
                                         for p in pr]
                                     for k in ("ecf8_decode", "flash_fwd")})
                log(f"phase 26 {tag} (mesh {[d, m]}): "
                    f"{json.dumps(go['runs'][tag])}")
            # the lossless gate: ECF8 tokens identical to fp8's, every rank
            t8 = f"{g['tag']}_{d}x{m}"
            same = [per_g[r]["runs"][f"{t8}_ecf8"]["tokens"]
                    == per_g[r]["runs"][f"{t8}_fp8"]["tokens"]
                    for r in range(n_ranks)]
            go["runs"][f"{t8}_fp8"]["lossless"] = all(same)
            if not all(same):
                problems.append(f"{t8}: ECF8 tokens differ from the fp8 "
                                f"tree's on ranks "
                                f"{[r for r, x in enumerate(same) if not x]}")
            else:
                log(f"lossless on mesh {[d, m]}: {g['arch']} ECF8 greedy "
                    f"tokens IDENTICAL to the fp8 tree's through the step "
                    f"factories (every rank)")
            # against card 0 alone (bf16 merges round apart: reported)
            alone = per_g[0]["alone"]
            rows = [alone["tokens"][i] for i in range(g["batch"])]
            got = []
            for r in range(0, n_ranks, m):
                got += per_g[r]["runs"][f"{t8}_fp8"]["tokens"]
            go["runs"][f"{t8}_fp8"]["same_rows_as_one_card"] = sum(
                a == b for a, b in zip(got, rows))
            whole_b = alone["cache_gib"]
        go["alone"] = dict(step_ms=statistics.median(
            per_g[0]["alone"]["step_ms"]), cache_gib=whole_b,
            prefill_s=per_g[0]["alone"]["prefill_s"])
        out["groups"][g["tag"]] = go
        log(f"phase 26 {g['tag']}: trees built in "
            f"{[round(x, 1) for x in go['build_s']]} s, resident "
            f"{[round(x, 2) for x in go['resident_gib']]} GiB (fp8 "
            f"{go['fp8_mb']:.0f} MB, ECF8 {go['ecf8_mb']:.0f} MB); card 0 "
            f"alone: step {go['alone']['step_ms']:.1f} ms, cache "
            f"{whole_b:.3f} GiB; rows identical to card 0 alone (bf16, "
            f"reported): "
            + ", ".join(f"{t}: {r['same_rows_as_one_card']} of "
                        f"{g['batch']}" for t, r in go["runs"].items()
                        if "same_rows_as_one_card" in r))
    if problems:
        log(f"phase 26 measurements: {json.dumps(out)}")
        fail("phase 26: " + "; ".join(problems))
    return out, launches, dict(b5=b5, b4=b4)


def only_phases(torch, np, MESH, serve, get, smoke_variant, flash_fwd,
                flash_bwd, kv_page, ecf8_decode, fp8, tpu_format, only: set,
                seed: int, t_start: float):
    """``--only 1,21`` / ``1,22`` / ``1,23`` / ``1,24`` / ``1,25`` /
    ``1,26`` / ``1,27`` / any of them together: after the build, the
    phases named (the mesh phases on four NCCL ranks when four cards are
    visible: phase 21 at ``MESH_LAYERS``, phases 22, 23, 25 and 26 at full
    depth, 24 at ``MOE_TRAIN_FULL_LAYERS``; else two gloo ranks on one
    card; 27 with phase 20 on card 0), then the kernels line of what ran
    (a kernel no phase of the run timed has null time keys) and the last
    line."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n_ranks = 4 if torch.cuda.device_count() >= 4 else 2
    out = moe_out = t23 = t24 = t25 = t26 = None
    launches, launches27 = {}, {}
    if "27" in only:
        from repro_torch.configs import get as get_cfg
        from repro_torch.kernels import fused_decode_matmul as fused
        from repro_torch.models import model as M
        runs = {"ecf8_decode": ecf8_decode.run, "flash_fwd": flash_fwd.run,
                "kv_page_decode": kv_page.run,
                "fused_decode_matmul": fused.run, "flash_bwd": flash_bwd.run}
        train_out, launches27, dry_out = train_and_dryrun(
            torch, M, runs, cfg_train(get_cfg("qwen3-8b"), TRAIN_LAYERS),
            seed)
        log(f"phase 20 measurements: {json.dumps(train_out)}")
        log(f"phase 27 measurements: {json.dumps(dry_out)}")
        log(f"phases 20 and 27 done at {time.perf_counter() - t_start:.1f}s")
        gc.collect()
        torch.cuda.empty_cache()
    if "21" in only:
        out = mesh_phase(torch, np, MESH, serve, get, n_ranks,
                         MESH_LAYERS if n_ranks == 4 else QWEN_LAYERS, seed,
                         flash_fwd, gen, flush)
        log(f"phase 21 measurements: {json.dumps(out)}")
        log(f"phase 21 done at {time.perf_counter() - t_start:.1f}s")
        launches.update({tag: run["launches"]
                         for tag, run in out["runs"].items()})
    if "22" in only:
        gc.collect()
        torch.cuda.empty_cache()
        moe_out, l22 = moe_mesh_phase(torch, np, MESH, serve, get, n_ranks,
                                      seed, ecf8_decode, fp8, tpu_format,
                                      flash_fwd, gen, flush)
        log(f"phase 22 measurements: {json.dumps(moe_out)}")
        log(f"phase 22 done at {time.perf_counter() - t_start:.1f}s")
        launches.update(l22)
    if "23" in only:
        gc.collect()
        torch.cuda.empty_cache()
        train_out, l23, t23 = train_mesh_phase(
            torch, np, MESH, get, n_ranks, seed, flash_fwd, flash_bwd, gen,
            flush)
        log(f"phase 23 measurements: {json.dumps(train_out)}")
        log(f"phase 23 done at {time.perf_counter() - t_start:.1f}s")
        launches.update(l23)
    if "24" in only:
        gc.collect()
        torch.cuda.empty_cache()
        moe_train_out, l24, t24 = train_moe_mesh_phase(
            torch, np, MESH, get, smoke_variant, n_ranks, seed, flash_fwd,
            flash_bwd, gen, flush)
        log(f"phase 24 measurements: {json.dumps(moe_train_out)}")
        log(f"phase 24 done at {time.perf_counter() - t_start:.1f}s")
        launches.update(l24)
    if "25" in only:
        gc.collect()
        torch.cuda.empty_cache()
        rec_train_out, l25, t25 = train_rec_mesh_phase(
            torch, np, MESH, get, smoke_variant, n_ranks, seed, flash_fwd,
            flash_bwd, gen, flush)
        log(f"phase 25 measurements: {json.dumps(rec_train_out)}")
        log(f"phase 25 done at {time.perf_counter() - t_start:.1f}s")
        launches.update(l25)
    if "26" in only:
        gc.collect()
        torch.cuda.empty_cache()
        steps_out, l26, t26 = steps_mesh_phase(
            torch, np, MESH, get, n_ranks, seed, flash_fwd, flash_bwd, gen,
            flush)
        log(f"phase 26 measurements: {json.dumps(steps_out)}")
        log(f"phase 26 done at {time.perf_counter() - t_start:.1f}s")
        launches.update(l26)
    del flush

    def mesh_l(name):
        # phase 26 keeps a factory run's decode steps under <name>_steps
        return {tag: [ln.get(name, 0) + ln.get(f"{name}_steps", 0)
                      for ln in runs] for tag, runs in launches.items()}

    def main_path(name):
        """The kernel's launches on every rank over the phases' runs (and
        phase 20's, under ``--only 1,27``)."""
        return sum(sum(v) for v in mesh_l(name).values()) + \
            launches27.get(name, 0)

    untimed = dict(max_abs_err=None, ms=None, plain_ms=None, bound_ms=None,
                   bound_by=None, library_ms=None)
    checks = moe_out["checks"] if moe_out is not None else {}
    b1 = next((v for k, v in checks.items() if k.startswith("b1_")),
              untimed)
    b1 = {k: b1[k] for k in untimed}
    if out is not None:
        b4 = out["q_base_checks"]["T1024_base512"]
    elif moe_out is not None:
        b4 = checks["b4"]
    else:
        b4 = (t23 or t24 or t25 or t26 or {}).get("b4", untimed)
    b5 = (t23 or t24 or t25 or t26 or {}).get("b5", untimed)
    b3 = out["b3_sharded"] if out is not None else None
    kernels = [
        dict(name="ecf8_decode", route="cuda",
             source="src/repro_torch/csrc/ecf8_decode.cu",
             replaces="src/repro/kernels/ecf8_decode.py:36",
             launches=main_path("ecf8_decode"),
             launches_mesh=mesh_l("ecf8_decode"),
             at_expert_shape_a_rank={k: v for k, v in checks.items()
                                     if k.startswith("b1_")}, **b1),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_fwd.py:37",
             launches=main_path("flash_fwd"),
             launches_mesh=mesh_l("flash_fwd"),
             launches_mesh_q_base=mesh_l("flash_fwd_q_base"),
             q_base_at_shard_shape=(out["q_base_checks"] if out is not None
                                    else None), **b4),
        dict(name="kv_page_decode", route="cuda",
             source="src/repro_torch/csrc/kv_page_decode.cu",
             replaces="src/repro/kvcache/kernels.py:34",
             launches=main_path("kv_page_decode"),
             launches_mesh=mesh_l("kv_page_decode"),
             **(untimed if b3 is None else dict(
                 max_abs_err=0.0 if b3["bit_exact"] else None, ms=b3["ms"],
                 plain_ms=b3["plain_ms"], bound_ms=b3["bound_ms"],
                 bound_by="bytes", library_ms=None))),
        dict(name="fused_decode_matmul", route="cuda",
             source="src/repro_torch/csrc/fused_decode_matmul.cu",
             replaces="src/repro/kernels/fused_decode_matmul.py:80",
             launches=0, **untimed),
        dict(name="flash_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/models/flash_attention.py:142",
             launches=main_path("flash_bwd"),
             launches_mesh=mesh_l("flash_bwd"),
             launches_mesh_q_base=mesh_l("flash_bwd_q_base"),
             **{k: b5[k] for k in untimed})]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=QWEN_LAYERS,
                    help="qwen3-8b depth served in phases 5-11 (36 = full)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None, metavar="PHASES",
                    help="run only these phases, e.g. '1,21' (the build and "
                         "the mesh; on four cards the 4-rank run): "
                         f"{', '.join(MESH_PHASES)}")
    args = ap.parse_args(argv)
    only = None
    if args.only is not None:
        only = set(args.only.split(","))
        if not only <= set(MESH_PHASES) or "1" not in only or len(only) < 2:
            ap.error(f"--only {args.only}: phase 1 (the build) and any of "
                     f"{', '.join(MESH_PHASES[1:])}")

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs on the card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT}/src/repro_torch not found: run from a repository "
             f"checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get, smoke_variant
    from repro_torch.core import fixedrate, fp8, paper_format, stats, store
    from repro_torch.core import theory, tpu_format
    from repro_torch.kernels import build, ecf8_decode, flash_bwd, flash_fwd
    from repro_torch.kernels import ops
    from repro_torch.kernels import fused_decode_matmul as fused
    from repro_torch.kvcache import codec, paged
    from repro_torch.kvcache import kernels as kv_page
    from repro_torch.launch import load_replay, serve
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch import serving
    from repro_torch.serving import EngineConfig
    from repro_torch.serving import telemetry
    from repro_torch.runtime import trace_export
    import numpy as np

    # float32 products in full f32, as XLA computes them in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):
        log(f"{what} done at {time.perf_counter() - t_start:.1f}s")

    card = gpu_line()
    log(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    for name, (sec, report) in built.items():
        log(f"built {name}.cu with nvcc {' '.join(build.NVCC_FLAGS[:2])} in "
            f"{sec:.1f}s -> {build.library_path(name).name}")
        for line in report.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build phase {time.perf_counter() - t0:.1f}s "
        f"({len(built)} of {len(build.SOURCES)} sources compiled)")
    if only is not None:
        return only_phases(torch, np, MESH, serve, get, smoke_variant,
                           flash_fwd, flash_bwd, kv_page, ecf8_decode, fp8,
                           tpu_format, only, args.seed, t_start)

    # -- 2. kernel 1: ECF8 decode -------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cfg_full = get("qwen3-8b")
    d, V, ff = cfg_full.d_model, cfg_full.vocab_size, cfg_full.d_ff
    results = {}
    moe_full = get(MOE_ARCH)
    expert = (moe_full.n_experts, moe_full.d_model, moe_full.moe_d_ff)
    g2 = get(GEMMA_ARCH)
    rg, xl = get(RG_ARCH), get(XLSTM_ARCH)
    ll = get(LLAMA_ARCH)
    wh = get(WHISPER_ARCH)
    for name, shape, fan_in in [("wq", (d, cfg_full.n_heads * cfg_full.hd), d),
                                ("wi_gate", (d, ff), d),
                                ("embed", (V, d), d),
                                ("moe_wi_gate", expert, moe_full.d_model),
                                ("g2_wi_gate", (g2.d_model, g2.d_ff),
                                 g2.d_model),
                                ("g2_embed", (g2.vocab_size, g2.d_model),
                                 g2.d_model),
                                ("rg_w_a", (rg.d_model, rg.d_model),
                                 rg.d_model),
                                ("xl_slstm_r", (xl.n_heads, xl.d_model
                                                // xl.n_heads,
                                                4 * xl.d_model
                                                // xl.n_heads),
                                 xl.d_model),
                                ("llama4_expert", (ll.n_experts, ll.d_model,
                                                   ll.moe_d_ff),
                                 ll.d_model),
                                ("whisper_unembed", (wh.d_model,
                                                     wh.vocab_size),
                                 wh.d_model)]:
        w = torch.randn(shape, generator=gen, device="cuda").mul_(
            fan_in ** -0.5)
        bits = fp8.cast_to_fp8_bits(w)
        del w
        # the ECF8-FR container beside the kernel at qwen3-8b's weights
        results[name] = check_decode(
            torch, ecf8_decode, fp8, tpu_format, name, bits, flush, reps=20,
            fixedrate=fixedrate if name in ("wq", "wi_gate", "embed")
            else None)
        del bits
    fr_results = {name: results[name].pop("fixedrate")
                  for name in ("wq", "wi_gate", "embed")}
    for name, bits in [
            ("one-symbol codebook", torch.full(
                (128 * 64,), 0b0_0111_010, dtype=torch.uint8, device="cuda")),
            ("near-uniform codebook", (torch.arange(128 * 64, device="cuda")
                                       * 11 % 256).to(torch.uint8)),
            ("all 256 codes", (torch.arange(128 * 32 * 5 + 3, device="cuda")
                               * 37 % 256).to(torch.uint8))]:
        check_decode_codes(torch, ecf8_decode, fp8, tpu_format, name, bits,
                           32)

    # -- 3. kernel 4: flash-attention forward -------------------------------
    for T in (13, 451, 512, 2048):
        results[f"flash_T{T}"] = check_flash(torch, flash_fwd, T, gen, flush)
    check_flash(torch, flash_fwd, 2048, gen, flush, torch.float16)
    for T in (451, 2048):             # moonshot's heads: group size 1
        results[f"flash_moe_T{T}"] = check_flash(
            torch, flash_fwd, T, gen, flush,
            heads=(moe_full.n_heads, moe_full.n_kv_heads))
    # gemma2-9b's heads: 16 / 8 of 256 (two warpgroups split O), softcap 50;
    # 4096 is a local layer's longest flash prefill, 6000 a global one's
    g2_heads = dict(heads=(g2.n_heads, g2.n_kv_heads), D=g2.hd,
                    softcap=g2.attn_softcap)
    for T in (13, 451, 4096, 6000):
        results[f"flash_g2_T{T}"] = check_flash(torch, flash_fwd, T, gen,
                                                flush, **g2_heads)
    for T in (13, 451):
        results[f"flash_g2_f32_T{T}"] = check_flash(
            torch, flash_fwd, T, gen, flush, torch.float32, tol=1e-5,
            **g2_heads)
    # recurrentgemma-2b's local layers: multi-query 10 / 1 of 256, no
    # softcap; 2048 fills the window, 451 is phase 14's shortest prompt
    for T in (13, 451, 2048):
        results[f"flash_rg_T{T}"] = check_flash(
            torch, flash_fwd, T, gen, flush, heads=(rg.n_heads,
                                                    rg.n_kv_heads),
            D=rg.hd, gqa=True)
    # llama4-scout's heads: 40 / 8 of 128 (a group of 5), no softcap; 451
    # and 2048 are phase 17's short prompts, 8192 its longest flash
    # prefill in a local layer
    for T in (451, 2048, 8192):
        results[f"flash_llama_T{T}"] = check_flash(
            torch, flash_fwd, T, gen, flush, heads=(ll.n_heads,
                                                    ll.n_kv_heads),
            D=ll.hd, gqa=True)
    # whisper-base's non-causal attention (8 / 8 heads of 64) at phase 18's
    # batch: the encoder's (1500 frames over 1500) and the prefill's cross
    # attention at its longest prompt (224 queries over the 1500 frames)
    for tag, Tq in (("enc", wh.encoder_frames), ("cross", WHISPER_PROMPTS[1])):
        results[f"flash_whisper_{tag}"] = check_flash(
            torch, flash_fwd, Tq, gen, flush, heads=(wh.n_heads,
                                                     wh.n_kv_heads),
            D=wh.hd, causal=False, B=WHISPER_BATCH, Tk=wh.encoder_frames,
            tol=WHISPER_FLASH_TOL)

    # -- 3b. kernel 3: KV page decode ----------------------------------------
    n_elem = cfg_full.n_kv_heads * 16 * cfg_full.hd     # one page, one layer
    scales = torch.logspace(-2, 1, 252)

    def kv_like(n_pages, dtype, n=n_elem):
        return [(torch.randn(n, generator=gen, device="cuda")
                 * float(scales[i % 252])).to(dtype) for i in range(n_pages)]

    for name, pages, n_empty in [
            ("bf16", kv_like(252, torch.bfloat16), 0),
            ("bf16_48", kv_like(SWAP_N_COLD_SLOTS, torch.bfloat16), 0),
            ("f32", kv_like(16, torch.float32), 0),
            ("fp8", kv_like(16, torch.float8_e4m3fn), 0)]:
        # a cold slot's stride budget: the raw exponent plane
        exp_bits = codec.plane_spec(codec.dtype_name(pages[0].dtype))[0]
        results[f"kv_{name}"] = check_kv_pages(
            torch, ops, kv_page, codec, name, pages,
            -(-codec.sym_per_lane(n_elem) * exp_bits // 8), flush, 20,
            n_empty)
    edge = kv_like(6, torch.bfloat16)
    edge.append(torch.full((n_elem,), 0.75, device="cuda",
                           dtype=torch.bfloat16))            # one symbol
    edge.append(torch.randint(-(1 << 15), 1 << 15, (n_elem,), generator=gen,
                              device="cuda").to(torch.int16)
                .view(torch.bfloat16))                       # 256 exponents
    check_kv_pages(torch, ops, kv_page, codec, "edge", edge, 4, flush, 5,
                   n_empty=3)
    # moonshot's page (16 KV heads x 16 positions x 128, twice qwen3-8b's)
    # in phase 12c's cold pool
    n_moe = moe_full.n_kv_heads * 16 * moe_full.hd
    moe_stride = -(-codec.sym_per_lane(n_moe)
                   * codec.plane_spec("bfloat16")[0] // 8)
    moe_inst = kv_page.instance(moe_stride, codec.sm_bytes("bfloat16", n_moe))
    before = kv_page.run.launches_by_instance[moe_inst]
    results["kv_moe_bf16_48"] = check_kv_pages(
        torch, ops, kv_page, codec, "moonshot bf16_48",
        kv_like(SWAP_N_COLD_SLOTS, torch.bfloat16, n_moe), moe_stride,
        flush, 20)
    if kv_page.run.launches_by_instance[moe_inst] <= before:
        fail(f"kv_page_decode moonshot: the {moe_inst} instance never ran")
    log(f"kv_page_decode moonshot page ({n_moe} elements): the {moe_inst} "
        f"instance ({kv_page._smem_bytes(moe_stride, codec.sm_bytes('bfloat16', n_moe))}"
        f" bytes of shared memory against {kv_page._MAX_SMEM})")
    # gemma2's page (8 KV heads x 16 positions x 256), one layer's pages of
    # a 48-page fault
    n_g2 = g2.n_kv_heads * 16 * g2.hd
    g2_stride = -(-codec.sym_per_lane(n_g2)
                  * codec.plane_spec("bfloat16")[0] // 8)
    g2_inst = kv_page.instance(g2_stride, codec.sm_bytes("bfloat16", n_g2))
    before = kv_page.run.launches_by_instance[g2_inst]
    results["kv_g2_bf16_48"] = check_kv_pages(
        torch, ops, kv_page, codec, "gemma2 bf16_48",
        kv_like(SWAP_N_COLD_SLOTS, torch.bfloat16, n_g2), g2_stride, flush,
        20)
    if kv_page.run.launches_by_instance[g2_inst] <= before:
        fail(f"kv_page_decode gemma2: the {g2_inst} instance never ran")
    # pages of 128 positions (--page-size 128): too large to stage, so the
    # wrapper picks the streamed instance by shape
    n_big = cfg_full.n_kv_heads * 128 * cfg_full.hd
    big_stride = -(-codec.sym_per_lane(n_big)
                   * codec.plane_spec("bfloat16")[0] // 8)
    inst = kv_page.instance(big_stride, codec.sm_bytes("bfloat16", n_big))
    before = kv_page.run.launches_by_instance["streamed"]
    results["kv_bf16_p128"] = check_kv_pages(
        torch, ops, kv_page, codec, "bf16_p128",
        kv_like(8, torch.bfloat16, n_big), big_stride, flush, 20)
    if inst != "streamed" or kv_page.run.launches_by_instance[
            "streamed"] <= before:
        fail(f"kv_page_decode bf16_p128: instance {inst}, streamed launches "
             f"{dict(kv_page.run.launches_by_instance)}")
    log(f"kv_page_decode bf16_p128: the {inst} instance (staged would need "
        f"{kv_page._smem_bytes(big_stride, codec.sm_bytes('bfloat16', n_big))}"
        f" bytes of shared memory, above {kv_page._MAX_SMEM})")

    # -- 3c. kernel 2: fused decode + matrix product ------------------------
    # the op's own path (ops.fused_decode_matmul; no serve path calls it),
    # driven once at each weight shape and M with the counts at 0; the
    # comparisons and timings below call the wrapper outside that count
    weights = {}
    for name, K, N in [("wq", d, cfg_full.n_heads * cfg_full.hd),
                       ("wi_gate", d, ff), ("wo_mlp", ff, d)]:
        w = torch.randn((K, N), generator=gen, device="cuda").mul_(K ** -0.5)
        bits = fp8.cast_to_fp8_bits(w)
        del w
        weights[name] = (bits, fused.encode_tiled(bits, sym_per_lane=256),
                         tpu_format.encode(bits.reshape(-1)))
    op_shapes = [(name, M_rows) for name in weights
                 for M_rows in (4, fused.MAX_ROWS)] + [("wq", B2_ROWS)]
    fused.run.launches = 0
    for name, M_rows in op_shapes:
        tiled = weights[name][1]
        x = torch.randn((M_rows, tiled.k), generator=gen, device="cuda")
        y = ops.fused_decode_matmul(x.to(torch.bfloat16), tiled)
        if y.shape != (M_rows, tiled.n) or not bool(torch.isfinite(y).all()):
            fail(f"fused_decode_matmul op {name} M={M_rows}: bad output")
    launches_b2 = fused.run.launches
    want_b2 = sum(-(-M_rows // fused.MAX_ROWS) for _, M_rows in op_shapes)
    if launches_b2 != want_b2:
        fail(f"fused_decode_matmul op: {launches_b2} launches, expected "
             f"{want_b2}")
    for name, M_rows in op_shapes:
        bits, tiled, c = weights[name]
        results[f"b2_{name}_M{M_rows}"] = check_fused(
            torch, fused, ops.fused_decode_matmul, ecf8_decode, fp8, name,
            bits, tiled, c, M_rows, flush, gen)
    # the weight path is bit-exact: 8 launches of 512 one-hot rows read
    # back all 4096 rows of decode(wq)
    bits, tiled, _ = weights["wq"]
    eye = torch.eye(tiled.k, device="cuda", dtype=torch.bfloat16)
    rows = torch.cat([fused.run(eye[i:i + fused.MAX_ROWS], tiled)
                      for i in range(0, tiled.k, fused.MAX_ROWS)])
    if not torch.equal(rows, bits.view(fp8.FP8_DTYPE).to(torch.bfloat16)
                       .float()):
        fail("fused_decode_matmul wq: one-hot rows do not read back "
             "decode(W) bit for bit")
    log(f"fused_decode_matmul wq: {-(-tiled.k // fused.MAX_ROWS)} launches of "
        f"{fused.MAX_ROWS} one-hot rows read back decode(W) bit for bit; "
        f"the op's path launched the kernel {launches_b2} times")
    del weights, eye, rows

    # -- 3d. training's attention: B4 with its statistics, B5 ----------------
    # qwen3-8b's heads at phase 20's micro-batch and length, gemma2-9b's
    # (D = 256, softcap), whisper-base's encoder (non-causal, D = 64); f32
    # at T 451 with each
    bwd_shapes = {
        "qwen3": dict(heads=(cfg_full.n_heads, cfg_full.n_kv_heads),
                      D=cfg_full.hd, B=TRAIN_BATCH // TRAIN_ACCUM),
        "gemma2": dict(heads=(g2.n_heads, g2.n_kv_heads), D=g2.hd,
                       softcap=g2.attn_softcap, B=TRAIN_BATCH // TRAIN_ACCUM),
        "whisper": dict(heads=(wh.n_heads, wh.n_kv_heads), D=wh.hd,
                        causal=False, B=WHISPER_BATCH)}
    bwd_T = {"qwen3": TRAIN_SEQ, "gemma2": TRAIN_SEQ,
             "whisper": wh.encoder_frames}
    for tag, kw in bwd_shapes.items():
        results[f"bwd_{tag}"] = check_flash_bwd(
            torch, flash_fwd, flash_bwd, gen, flush, bwd_T[tag], **kw)
        results[f"bwd_{tag}_f32"] = check_flash_bwd(
            torch, flash_fwd, flash_bwd, gen, flush, 451,
            dtype=torch.float32, tol=1e-5, **kw)
    del flush
    flash_bwd.run.launches = 0     # no serve phase below may launch B5

    # -- 4. small input: the card agrees with the CPU (plain versions) -------
    small = dataclasses.replace(
        get("qwen3-8b"), name="qwen3-small", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype="float32")
    p_cpu, _ = store.compress_tree(M.init_params(small, args.seed, "cpu"),
                                   min_elems=4096, out_dtype="float32")
    toks = torch.randint(0, small.vocab_size, (2, 37), generator=torch
                         .Generator().manual_seed(args.seed))
    l_cpu, _ = M.prefill(p_cpu, small, toks, max_len=64)
    l_gpu, _ = M.prefill(to_device(p_cpu, "cuda", store), small,
                         toks.cuda(), max_len=64)
    err = float((l_gpu.cpu() - l_cpu).abs().max())
    if not bool(torch.isfinite(l_gpu).all()) or err > 1e-4:
        fail(f"small f32 prefill: card vs CPU max |dlogit| = {err}")
    log(f"small f32 model (2 layers, d=256): prefill logits on the card vs "
        f"CPU max |diff| {err:.2e} (tol 1e-4)")
    err = check_small_paged(torch, M, paged, small, p_cpu,
                            to_device(p_cpu, "cuda", store), args.seed)
    if err > 1e-4:
        fail(f"small f32 paged-compressed decode: card vs CPU max |dlogit| "
             f"= {err}")
    log(f"small f32 model: paged-compressed decode-step logits (cold pages "
        f"decoded in the step) on the card vs CPU max |diff| {err:.2e} "
        f"(tol 1e-4)")
    err, err_whole = check_small_chunked(
        torch, M, paged, small, p_cpu, to_device(p_cpu, "cuda", store),
        toks[:1], l_gpu[:1])
    if err > 1e-4 or err_whole > 1e-4:
        fail(f"small f32 chunked prefill: card vs CPU max |dlogit| = {err}, "
             f"vs the card's whole-prompt prefill {err_whole}")
    log(f"small f32 model: chunked prefill (16-token chunks, pages going "
        f"cold between chunks) logits on the card vs CPU max |diff| "
        f"{err:.2e}, vs its own whole-prompt prefill {err_whole:.2e} "
        f"(tol 1e-4)")
    d_small, _ = store.compress_tree(M.init_params(small, args.seed + 1,
                                                   "cpu"),
                                     min_elems=4096, out_dtype="float32")
    runs, eng_p = small_serving(torch, serving, small,
                                to_device(p_cpu, "cuda", store),
                                to_device(d_small, "cuda", store))
    bad = [name for name, toks in runs.items() if toks != runs["paged"]]
    if bad:
        fail(f"small f32 engine runs whose greedy tokens differ from the "
             f"paged run's: {bad}")
    if not (eng_p.scheduler.n_preempted and eng_p.n_draft_restores):
        fail(f"small spec pressure run: {eng_p.scheduler.counters()}, "
             f"{eng_p.n_draft_restores} draft rows reinstalled")
    log(f"small f32 engine on the card: greedy tokens of the monolithic, "
        f"speculative (k = 1, 4) and speculative-under-pressure runs "
        f"IDENTICAL to the paged run's ({sum(map(len, runs['paged']))} "
        f"tokens; pressure run {eng_p.scheduler.n_preempted} preemptions, "
        f"{eng_p.n_draft_restores} draft rows reinstalled, "
        f"{eng_p.spec_counters()})")

    # the MoE family and the other dense MLPs at smoke size: moonshot's
    # smoke variant at capacity factor 1.25 (tokens dropped), granite's
    # GELU with one KV head, nemotron's squared ReLU
    small_moe_checks(torch, M, moe, paged, store, smoke_variant, get,
                     args.seed, ecf8_decode)
    # the recurrent families at smoke size, ECF8 through B1
    small_recurrent_checks(torch, M, store, smoke_variant, get, args.seed)
    # the encoder-decoder at smoke size: B4 non-causal, the cross cache
    small_whisper_check(torch, M, store, smoke_variant, get, args.seed)
    log(f"phases 1-4 done at {time.perf_counter() - t_start:.1f}s")

    # -- 5. serve qwen3-8b at full width -----------------------------------
    cfg = dataclasses.replace(cfg_full, n_layers=args.layers)
    log(f"serving {cfg.name} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), N = "
        f"{cfg.n_layers} layers (depth cut {cfg_full.n_layers} -> "
        f"{cfg.n_layers})")
    torch.cuda.reset_peak_memory_stats()
    params_c, params_fp8, report, enc_s = serve.build_params(
        cfg, args.seed, "tpu", device="cuda")
    fp8_b = report["fp8_bytes"]
    qwen_sizes = dict(tpu_mb=report["compressed_bytes"] / 1e6,
                      fp8_mb=fp8_b / 1e6)
    log(f"ECF8 encode {enc_s:.1f}s: {report['n_compressed']} tensors, fp8 "
        f"{fp8_b / 1e6:.1f} MB -> {report['compressed_bytes'] / 1e6:.1f} MB "
        f"({100 * (1 - report['compressed_bytes'] / fp8_b):.2f}% saved)")
    prompts = serve.make_prompts(cfg, 8, args.seed, lo=64, hi=513)
    ecfg = EngineConfig(max_batch=4, max_len=1024)
    ecf8_decode.run.launches = flash_fwd.run.launches = 0
    ecf8_decode.run.launches_by_dtype.clear()
    fused.run.launches = 0
    done, eng, dt = serve.serve(params_c, cfg, ecfg, prompts, 32)
    launches = {"ecf8_decode": ecf8_decode.run.launches,
                "flash_fwd": flash_fwd.run.launches}
    by_dtype = dict(ecf8_decode.run.launches_by_dtype)
    log(f"ecf8_decode launches by output dtype: {by_dtype}")
    if set(by_dtype) != {torch.bfloat16}:
        fail(f"a compressed weight was decoded to another dtype than the "
             f"model's bf16, which a cast kernel must follow: {by_dtype}")
    serve_b2 = fused.run.launches
    n_tok = sum(len(r.out_tokens) for r in done)
    log(f"served {len(done)} requests (prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens), {n_tok} tokens in {dt:.2f}s: "
        f"{n_tok / dt:.1f} tok/s, {eng.steps} decode steps at "
        f"{eng.decode_seconds / eng.steps * 1e3:.1f} ms/step, prefill "
        f"{eng.prefill_seconds:.2f}s total, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    log(f"launches over the serve run: {launches} (per decode step "
        f"ecf8_decode = 7 x {cfg.n_layers} + 2 = {7 * cfg.n_layers + 2})")
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    if not all(r.done and len(r.out_tokens) == 32 for r in done) or any(
            not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        fail("serve run: unfinished requests or out-of-vocab tokens")

    # -- 6. lossless: the fp8 baseline gives the same tokens ----------------
    done2, eng2, dt2 = serve.serve(params_fp8, cfg, ecfg, prompts, 32)
    if not serve.same_tokens(done, done2):
        fail("ECF8 tokens differ from the fp8 baseline")
    log(f"lossless: ECF8 greedy tokens IDENTICAL to the fp8 baseline "
        f"({dt2:.2f}s, {eng2.decode_seconds / eng2.steps * 1e3:.1f} "
        f"ms/step on fp8 weights)")
    mark("phases 5-6")

    # -- 7. paged-compressed cache + swap tier, preempting -----------------
    ecfg_c = EngineConfig(max_batch=4, max_len=1024, compress_cold=True,
                          n_pages=SWAP_N_PAGES,
                          n_cold_slots=SWAP_N_COLD_SLOTS, swap_bytes=-1)
    log(f"serving again with the compressed cold pool and the swap tier: "
        f"n_pages {SWAP_N_PAGES}, n_cold_slots {SWAP_N_COLD_SLOTS} (the "
        f"worst case is {1 + 4 * 1024 // 16} pages), swap unbounded, "
        f"{cfg.n_layers} layers")
    torch.cuda.reset_peak_memory_stats()
    ecf8_decode.run.launches = flash_fwd.run.launches = 0
    kv_page.run.launches = 0
    kv_page.run.launches_by_path.clear()
    done3, eng3, dt3 = serve.serve(params_c, cfg, ecfg_c, prompts, 32)
    serve_b2 += fused.run.launches
    launches3 = {"ecf8_decode": ecf8_decode.run.launches,
                 "flash_fwd": flash_fwd.run.launches,
                 "kv_page_decode": kv_page.run.launches}
    pc, sched = eng3.paged, eng3.scheduler
    gather_l = kv_page.run.launches_by_path["gather"]
    fault_l = kv_page.run.launches_by_path["fault"]
    st = pc.swap.stats()
    log(f"served {len(done3)} requests in {dt3:.2f}s, {eng3.steps} decode "
        f"steps at {eng3.decode_seconds / eng3.steps * 1e3:.1f} ms/step "
        f"(phase 5: {eng.decode_seconds / eng.steps * 1e3:.1f}), peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    for line in serve.cache_report(eng3):
        log(line)
    log(f"launches over the swap run: {launches3}; kv_page_decode from the "
        f"decode step's cold gather {gather_l} (2 x {cfg.n_layers} a step "
        f"with a cold page), from fault {fault_l}")
    if not all(launches3.values()) or gather_l <= 0 or fault_l <= 0:
        fail(f"a kernel of the swap path never launched: {launches3}, "
             f"gather {gather_l}, fault {fault_l}")
    if not (sched.n_preempted > 0 and sched.n_resumed > 0):
        fail(f"swap run did not preempt and resume: {sched.counters()}")
    if (st["swap_in_bytes_total"] != st["swap_out_bytes_total"]
            or len(pc.swap) or pc._slot_pages
            or pc.free_pages != pc.n_pages - 1 or pc._cold_bytes):
        fail(f"swap run did not drain: {pc.stats()}")
    if not all(r.done and len(r.out_tokens) == 32 for r in done3):
        fail("swap run: unfinished requests")
    _, bad = first_divergence(done, done3)
    if bad:
        fail(f"swap run tokens differ from phase 5 (request, first token "
             f"index): {bad}")
    log("lossless: paged-compressed + swap greedy tokens IDENTICAL to "
        "phase 5's paged run")
    mark("phase 7")

    # -- 8. chunked, decode-interleaved prefill at full depth --------------
    chunked = dict(max_batch=4, max_len=1024, prefill_chunk=CHUNK,
                   prefill_budget=CHUNK)
    runs = {}
    for tag, extra in (("8a", {}),
                       ("8b", dict(compress_cold=True, n_pages=SWAP_N_PAGES,
                                   n_cold_slots=SWAP_N_COLD_SLOTS,
                                   swap_bytes=-1))):
        torch.cuda.reset_peak_memory_stats()
        ecf8_decode.run.launches = flash_fwd.run.launches = 0
        kv_page.run.launches = 0
        kv_page.run.launches_by_path.clear()
        fused.run.launches = 0
        d8, e8, t8 = serve.serve(params_c, cfg,
                                 EngineConfig(**chunked, **extra), prompts,
                                 32)
        serve_b2 += fused.run.launches
        l8 = {"ecf8_decode": ecf8_decode.run.launches,
              "flash_fwd": flash_fwd.run.launches,
              "kv_page_decode": kv_page.run.launches}
        runs[tag] = (d8, e8, dict(kv_page.run.launches_by_path))
        n8 = sum(len(r.out_tokens) for r in d8)
        log(f"phase {tag}: {cfg.n_layers} layers, chunk {CHUNK}, budget "
            f"{CHUNK}{', compressed cold pool + swap' if extra else ''}: "
            f"{n8} tokens in {t8:.2f}s, {n8 / t8:.1f} tok/s, {e8.steps} "
            f"decode steps at {e8.decode_seconds / e8.steps * 1e3:.1f} "
            f"ms/step, prefill phases {e8.prefill_seconds:.2f}s, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        log(f"  {serve.chunk_report(e8)}; launches {l8}, kv_page_decode "
            f"by path {dict(kv_page.run.launches_by_path)}")
        for line in serve.cache_report(e8):
            log(f"  {line}")
        if not all(r.done and len(r.out_tokens) == 32 for r in d8) or any(
                not 0 <= t < cfg.vocab_size for r in d8
                for t in r.out_tokens):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
        if (e8.n_interleaved_steps <= 0
                or e8.n_chunk_tokens != sum(map(len, prompts))):
            fail(f"phase {tag}: no step interleaved prefill with decode "
                 f"({serve.chunk_report(e8)})")
        if l8["ecf8_decode"] <= 0:
            fail(f"phase {tag}: the weight decode never launched: {l8}")
    d8a = runs["8a"][0]
    same, bad = first_divergence(done, d8a)
    log(f"phase 8a vs phase 5 (whole-prompt prefill through flash_fwd; "
        f"chunks attend through blockwise_attention, so bf16 rounding "
        f"differs; not a gate): {same} of {len(done) * 32} tokens equal, "
        f"first divergence (request, token) {bad}")
    d8b, e8b, by_path = runs["8b"]
    pc, sched = e8b.paged, e8b.scheduler
    st = pc.swap.stats()
    if by_path.get("gather", 0) <= 0 or by_path.get("fault", 0) <= 0:
        fail(f"phase 8b: kv_page_decode did not launch from both gather "
             f"and fault: {by_path}")
    if not (sched.n_preempted > 0 and sched.n_resumed > 0):
        fail(f"phase 8b did not preempt and resume: {sched.counters()}")
    if (st["swap_in_bytes_total"] != st["swap_out_bytes_total"]
            or len(pc.swap) or pc._slot_pages
            or pc.free_pages != pc.n_pages - 1 or pc._cold_bytes):
        fail(f"phase 8b did not drain: {pc.stats()}")
    _, bad = first_divergence(d8a, d8b)
    if bad:
        fail(f"phase 8b tokens differ from phase 8a's (request, first token "
             f"index): {bad}")
    log(f"lossless: chunked paged-compressed + swap greedy tokens IDENTICAL "
        f"to phase 8a's ({e8b.n_midprefill_preempted} of "
        f"{sched.n_preempted} preemptions mid-prefill)")
    mark("phase 8")

    def reset_counts():
        ecf8_decode.run.launches = flash_fwd.run.launches = 0
        kv_page.run.launches = fused.run.launches = 0
        kv_page.run.launches_by_path.clear()

    def counts():
        return {"ecf8_decode": ecf8_decode.run.launches,
                "flash_fwd": flash_fwd.run.launches,
                "kv_page_decode": kv_page.run.launches}

    def served(tag, d, e, t):
        n = sum(len(r.out_tokens) for r in d)
        if not all(r.done and len(r.out_tokens) == 32 for r in d) or any(
                not 0 <= x < cfg.vocab_size for r in d for x in r.out_tokens):
            fail(f"phase {tag}: unfinished requests or out-of-vocab tokens")
        return (f"{n} tokens in {t:.2f}s, {n / t:.1f} tok/s, {e.steps} "
                f"steps at {e.decode_seconds / e.steps * 1e3:.1f} ms/step, "
                f"prefill {e.prefill_seconds:.2f}s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")

    # -- 9. the monolithic cache at full depth -----------------------------
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    d9, e9, t9 = serve.serve(params_c, cfg, EngineConfig(
        max_batch=4, max_len=1024, cache_mode="monolithic"), prompts, 32)
    serve_b2 += fused.run.launches
    l9 = counts()
    log(f"phase 9: monolithic cache, {cfg.n_layers} layers: "
        f"{served('9', d9, e9, t9)}; launches {l9}")
    if not (l9["ecf8_decode"] and l9["flash_fwd"]) or e9.paged is not None:
        fail(f"phase 9: a kernel of the monolithic path never launched: "
             f"{l9}")
    same, bad = first_divergence(done, d9)
    if bad:
        r, i = bad[0]
        fail(f"phase 9 tokens differ from phase 5's (request, first token "
             f"index) {bad}: request {r} token {i} is "
             f"{d9[r].out_tokens[i]} against {done[r].out_tokens[i]}")
    log("lossless: monolithic greedy tokens IDENTICAL to phase 5's paged "
        "run")
    mark("phase 9")

    # -- 10. speculative decoding at full depth ----------------------------
    spec = dict(max_batch=4, max_len=1024, spec_k=SPEC_K)

    def spec_line(e, d):
        sc = e.spec_counters()
        n = sum(len(r.out_tokens) for r in d)
        return (f"{sc['spec_rounds']} verify windows in {e.steps} rounds, "
                f"accept rate {sc['spec_accept_rate']:.3f} "
                f"({sc['spec_accepted']}/{sc['spec_drafted']} drafted), "
                f"{n / max(sc['spec_rounds'], 1):.2f} tokens a window, "
                f"{e.n_spec_rollbacks} rollbacks")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    d10a, e10a, t10a = serve.serve(params_c, cfg, EngineConfig(
        **spec, draft_cfg=cfg, draft_params=params_c), prompts, 32)
    serve_b2 += fused.run.launches
    l10a = counts()
    same, bad = first_divergence(done, d10a)
    log(f"phase 10a: self-draft (the target's ECF8 tree), k={SPEC_K}: "
        f"{served('10a', d10a, e10a, t10a)}; {spec_line(e10a, d10a)}; "
        f"launches {l10a}; {same} of {len(done) * 32} tokens equal phase "
        f"5's (verify attends in chunk mode; counted, not gated), first "
        f"divergence (request, token) {bad}")
    if not (l10a["ecf8_decode"] and l10a["flash_fwd"]):
        fail(f"phase 10a: a kernel of the speculative path never launched: "
             f"{l10a}")

    dcfg = dataclasses.replace(cfg_full, name="qwen3-8b-draft2", n_layers=2)
    d_c, d_fp8, d_report, d_enc = serve.build_params(
        dcfg, args.seed + 1, "tpu", device="cuda")
    log(f"draft: {dcfg.n_layers} layers at qwen3-8b's widths, seed "
        f"{args.seed + 1}, ECF8 {d_report['compressed_bytes'] / 1e6:.1f} MB "
        f"(fp8 {d_report['fp8_bytes'] / 1e6:.1f} MB), encode {d_enc:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    d10b, e10b, t10b = serve.serve(params_c, cfg, EngineConfig(
        **spec, draft_cfg=dcfg, draft_params=d_c), prompts, 32)
    serve_b2 += fused.run.launches
    l10b = counts()
    sc = e10b.spec_counters()
    log(f"phase 10b: 2-layer draft, k={SPEC_K}: "
        f"{served('10b', d10b, e10b, t10b)}; {spec_line(e10b, d10b)}; "
        f"launches {l10b}")
    if not (l10b["ecf8_decode"] and l10b["flash_fwd"]):
        fail(f"phase 10b: a kernel of the speculative path never launched: "
             f"{l10b}")
    if sc["spec_drafted"] <= sc["spec_accepted"] or not e10b.n_spec_rollbacks:
        fail(f"phase 10b: no proposal was rejected and rolled back: {sc}")
    d10f, e10f, t10f = serve.serve(params_fp8, cfg, EngineConfig(
        **spec, draft_cfg=dcfg, draft_params=d_fp8), prompts, 32)
    _, bad = first_divergence(d10b, d10f)
    if bad:
        fail(f"phase 10b: ECF8 tokens differ from the fp8 baseline's "
             f"(request, first token index): {bad}")
    log(f"lossless: speculative ECF8 greedy tokens IDENTICAL to the fp8 "
        f"baseline trees' ({t10f:.2f}s, "
        f"{e10f.decode_seconds / e10f.steps * 1e3:.1f} ms/round on fp8 "
        f"weights; {e10f.spec_counters()})")
    del params_fp8, d_fp8

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    d10c, e10c, t10c = serve.serve(params_c, cfg, EngineConfig(
        **spec, draft_cfg=dcfg, draft_params=d_c, compress_cold=True,
        n_pages=SWAP_N_PAGES, n_cold_slots=SWAP_N_COLD_SLOTS,
        swap_bytes=-1), prompts, 32)
    serve_b2 += fused.run.launches
    l10c = counts()
    by_path = dict(kv_page.run.launches_by_path)
    pc, sched = e10c.paged, e10c.scheduler
    st = pc.swap.stats()
    log(f"phase 10c: 10b with phase 7's pools and swap: "
        f"{served('10c', d10c, e10c, t10c)}; {spec_line(e10c, d10c)}; "
        f"launches {l10c}, kv_page_decode by path {by_path}; "
        f"{e10c.n_draft_restores} draft rows reinstalled")
    for line in serve.cache_report(e10c):
        log(f"  {line}")
    if not (sched.n_preempted and sched.n_resumed and e10c.n_draft_restores):
        fail(f"phase 10c did not preempt and resume a speculating request "
             f"with its draft row: {sched.counters()}, "
             f"{e10c.n_draft_restores} draft rows reinstalled")
    if by_path.get("verify", 0) <= 0 or not l10c["ecf8_decode"]:
        fail(f"phase 10c: kv_page_decode did not launch from a verify over "
             f"cold history: {by_path}")
    if (st["swap_in_bytes_total"] != st["swap_out_bytes_total"]
            or len(pc.swap) or pc._slot_pages
            or pc.free_pages != pc.n_pages - 1 or pc._cold_bytes):
        fail(f"phase 10c did not drain: {pc.stats()}")
    same, bad = first_divergence(d10b, d10c)
    log(f"phase 10c vs 10b: {same} of {len(done) * 32} tokens equal (page "
        f"pressure shrinks verify windows; counted, not gated), first "
        f"divergence (request, token) {bad}")

    # 10d: a recurrent draft, one ("rglru", "rglru", "local") unit and two
    # tail RG-LRU layers at recurrentgemma-2b's widths with the target's
    # vocabulary and a window of 64, so that its rings wrap within a round
    rdcfg = dataclasses.replace(rg, name="recurrentgemma-draft", n_layers=5,
                                vocab_size=cfg.vocab_size, local_window=64)
    rd_c, _, rd_report, rd_enc = serve.build_params(
        rdcfg, args.seed + 2, "tpu", device="cuda", baseline=False)
    log(f"recurrent draft: {rdcfg.n_layers} layers {rdcfg.pattern} + tail "
        f"at d_model {rdcfg.d_model}, window {rdcfg.local_window}, vocab "
        f"{rdcfg.vocab_size}, seed {args.seed + 2}, ECF8 "
        f"{rd_report['compressed_bytes'] / 1e6:.1f} MB (fp8 "
        f"{rd_report['fp8_bytes'] / 1e6:.1f} MB), encode {rd_enc:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    d10d, e10d, t10d = serve.serve(params_c, cfg, EngineConfig(
        **spec, draft_cfg=rdcfg, draft_params=rd_c), prompts, 32)
    serve_b2 += fused.run.launches
    l10d = counts()
    log(f"phase 10d: recurrent draft, k={SPEC_K}: "
        f"{served('10d', d10d, e10d, t10d)}; {spec_line(e10d, d10d)}; "
        f"{e10d.n_draft_state_rollbacks} rollbacks restored draft rings "
        f"and RG-LRU states ({e10d.n_draft_ring_wraps} with rings wrapped "
        f"past the window); launches {l10d}")
    if not (l10d["ecf8_decode"] and l10d["flash_fwd"]):
        fail(f"phase 10d: a kernel of the speculative path never launched: "
             f"{l10d}")
    if not (e10d.n_draft_state_rollbacks and e10d.n_draft_ring_wraps):
        fail(f"phase 10d: no rollback restored a recurrent state and a "
             f"wrapped ring: {e10d.n_draft_state_rollbacks} restores, "
             f"{e10d.n_draft_ring_wraps} wrapped")
    _, bad = first_divergence(d10b, d10d)
    if bad:
        fail(f"phase 10d tokens differ from 10b's (request, first token "
             f"index): {bad}")
    log("lossless: 10d greedy tokens IDENTICAL to 10b's (speculation "
        "emits the target's tokens whatever the draft)")
    del rd_c, e10d
    mark("phase 10")

    # -- 11. prefix sharing and the serving telemetry at full depth --------
    kernel_runs = {"ecf8_decode": ecf8_decode.run,
                   "kv_page_decode": kv_page.run,
                   "fused_decode_matmul": fused.run,
                   "flash_fwd": flash_fwd.run}
    prefix_out, prefix_launches = prefix_phase(
        torch, np, serve, EngineConfig, telemetry, trace_export,
        kernel_runs, cfg, params_c, args.seed)
    log(f"phase 11 measurements: {json.dumps(prefix_out)}")
    mark("phase 11")

    if serve_b2:
        fail(f"a serve path launched fused_decode_matmul {serve_b2} times")
    by_dtype = dict(ecf8_decode.run.launches_by_dtype)
    if set(by_dtype) != {torch.bfloat16}:
        fail(f"phases 5-11 decoded a compressed weight to another dtype "
             f"than bf16: {by_dtype}")
    log(f"ecf8_decode over phases 5, 7, 8a, 8b, 9, 10a-c, 11: "
        f"{by_dtype[torch.bfloat16]} launches, all writing bf16 (no cast "
        f"kernel after a decode)")
    log("fused_decode_matmul: 0 launches on every serve path (phases 5, 7, "
        "8a, 8b, 9, 10a-c, 11a-b), as in the reference")

    # -- 19. the async front end and router over two replicas --------------
    # phase 5's model and ECF8 tree, shared by the replicas
    frontend_out, frontend_launches = frontend_phase(
        torch, serve, load_replay, smoke_variant, get, kernel_runs, cfg,
        params_c, args.seed)
    log(f"phase 19 measurements: {json.dumps(frontend_out)}")
    mark("phase 19")

    # -- 12. moonshot-v1-16b-a3b at full width from ECF8 weights ----------
    # the qwen3-8b trees and the engines holding their caches go first
    del (params_c, d_c, eng, eng2, eng3, runs, e8, e8b, e9, e10a, e10b,
         e10f, e10c, pc)
    gc.collect()
    torch.cuda.empty_cache()
    moe_out, moe_launches = moe_phase(
        torch, serve, EngineConfig, kernel_runs,
        dataclasses.replace(moe_full, n_layers=MOE_LAYERS), args.seed)
    log(f"phase 12 measurements: {json.dumps(moe_out)}")
    mark("phase 12")

    # -- 13. gemma2-9b at full width from ECF8 weights ---------------------
    gemma_out, gemma_launches = gemma_phase(
        torch, np, serve, EngineConfig, kernel_runs,
        dataclasses.replace(g2, n_layers=GEMMA_LAYERS), args.seed)
    log(f"phase 13 measurements: {json.dumps(gemma_out)}")
    mark("phase 13")

    # -- 14. recurrentgemma-2b at full width and depth from ECF8 weights ---
    # B1 a pass: 9 a RG-LRU layer (w_in, w_gate_in, conv_w, w_a, w_x, w_out
    # and the GeGLU's three), 7 a local layer, the tied embedding twice
    n_rg = sum(rg.layer_kind(i) == "rglru" for i in range(rg.n_layers))
    n_loc = rg.n_layers - n_rg
    rg_out, rg_launches = recurrent_phase(
        torch, np, serve, EngineConfig, kernel_runs, rg, args.seed, "14",
        RG_PROMPTS, RG_MAX_LEN,
        want=dict(b1={"bfloat16": 9 * n_rg + 7 * n_loc + 2},
                  b4=n_loc * sum(n <= rg.local_window for n in RG_PROMPTS)),
        probe=("rglru", RG_PROMPTS[0]))
    log(f"phase 14 measurements: {json.dumps(rg_out)}")
    mark("phase 14")

    # -- 15. xlstm-350m at full width and depth from ECF8 weights ----------
    # B1 a pass: 6 an mLSTM layer (w_up, w_q, w_k, w_v, w_if, w_down), an
    # sLSTM layer's w and w_out in bf16 and its r in f32 (the cell's
    # recurrence runs in f32), the embedding and unembedding
    n_sl = sum(xl.layer_kind(i) == "slstm" for i in range(xl.n_layers))
    xl_out, xl_launches = recurrent_phase(
        torch, np, serve, EngineConfig, kernel_runs, xl, args.seed, "15",
        XLSTM_PROMPTS, XLSTM_MAX_LEN,
        want=dict(b1={"bfloat16": 6 * (xl.n_layers - n_sl) + 2 * n_sl + 2,
                      "float32": n_sl}, b4=0),
        probe=("slstm", XLSTM_PROMPTS[0]))
    log(f"phase 15 measurements: {json.dumps(xl_out)}")
    mark("phase 15")

    # -- 16. qwen3-8b from ECF8-FR weights, and the container report ------
    fr_out, fr_launches, params_fr = fixedrate_phase(
        torch, serve, EngineConfig, kernel_runs, cfg, args.seed, prompts,
        {"phase 5 (ECF8-TPU)": [r.out_tokens for r in done],
         "phase 6 (fp8)": [r.out_tokens for r in done2]}, qwen_sizes)
    t0 = time.perf_counter()
    rows = container_report(torch, np, fixedrate, tpu_format, paper_format,
                            stats, theory, params_fr)
    fr_out["containers"] = rows
    fr_out["report_s"] = time.perf_counter() - t0
    del params_fr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16 container report (bytes an element; the paper's "
        f"container on the four attention matrices alone, "
        f"{sum(r['n'] for r in rows if r['paper'])} elements, each decoded "
        f"back bit-exactly by decode_blockparallel; "
        f"{fr_out['report_s']:.1f}s):")
    for r in rows:
        paper = (f"{r['paper']:.4f} (host encode {r['paper_encode_s']:.1f}s,"
                 f" decode {r['paper_decode_s']:.1f}s)" if r["paper"]
                 else "not run")
        log(f"  {r['name']:12s} {tuple(r['shape'])}: ECF8-TPU "
            f"{r['tpu']:.4f}, ECF8-FR {r['fixedrate']:.4f}, paper {paper}; "
            f"H(E) {r['entropy_bits']:.4f} bits -> (4 + H) / 8 = "
            f"{(4 + r['entropy_bits']) / 8:.4f}; alpha {r['alpha']:.3f}, "
            f"limit (1 mantissa bit) {r['limit_bits']:.3f} bits, (e4m3's 3) "
            f"{r['limit_bits_e4m3']:.3f} bits = "
            f"{r['limit_bits_e4m3'] / 8:.4f} bytes")
    log(f"phase 16 measurements: {json.dumps(fr_out)}")
    mark("phase 16")

    # -- 17. llama4-scout-17b-a16e at full width from ECF8 weights --------
    llama_out, llama_launches = llama_phase(
        torch, np, serve, EngineConfig, kernel_runs,
        dataclasses.replace(ll, n_layers=LLAMA_LAYERS), args.seed)
    log(f"phase 17 measurements: {json.dumps(llama_out)}")
    mark("phase 17")

    # -- 18. whisper-base, the encoder-decoder, at full width -------------
    whisper_out, wh_launches = whisper_phase(torch, np, serve, M,
                                             kernel_runs, wh, args.seed)
    log(f"phase 18 measurements: {json.dumps(whisper_out)}")
    mark("phase 18")

    # -- 20. training qwen3-8b at full width ------------------------------
    if flash_bwd.run.launches:
        fail(f"a serve phase launched B5 {flash_bwd.run.launches} times")
    train_runs = {**kernel_runs, "flash_bwd": flash_bwd.run}
    train_out, train_launches, dry_out = train_and_dryrun(
        torch, M, train_runs, cfg_train(cfg_full, TRAIN_LAYERS), args.seed)
    log(f"phase 20 measurements: {json.dumps(train_out)}")
    log(f"phase 27 measurements: {json.dumps(dry_out)}")
    mark("phases 20 and 27")

    # -- 20b. the checkpoint drill -----------------------------------------
    ckpt_out, ckpt_b1 = ckpt_phase(
        torch, M, serve, train_runs,
        cfg_train(cfg_full, CKPT_LAYERS), args.seed)
    log(f"phase 20b measurements: {json.dumps(ckpt_out)}")
    mark("phase 20b")

    # -- 21. serving on a mesh of ranks ------------------------------------
    # one visible card: two ranks share it over gloo at QWEN_LAYERS; four or
    # more: four NCCL ranks at MESH_LAYERS
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    n_ranks = 4 if torch.cuda.device_count() >= 4 else 2
    mesh_out = mesh_phase(torch, np, MESH, serve, get, n_ranks,
                          MESH_LAYERS if n_ranks == 4 else args.layers,
                          args.seed, flash_fwd, gen, flush)
    log(f"phase 21 measurements: {json.dumps(mesh_out)}")
    mark("phase 21")

    # -- 22. the mixture-of-experts and recurrent stacks on a mesh ---------
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh_out, moe_mesh_launches = moe_mesh_phase(
        torch, np, MESH, serve, get, n_ranks, args.seed, ecf8_decode, fp8,
        tpu_format, flash_fwd, gen, flush)
    log(f"phase 22 measurements: {json.dumps(moe_mesh_out)}")
    mark("phase 22")

    # -- 23. training on a mesh of ranks -----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    train_mesh_out, train_mesh_launches, t23 = train_mesh_phase(
        torch, np, MESH, get, n_ranks, args.seed, flash_fwd, flash_bwd, gen,
        flush)
    log(f"phase 23 measurements: {json.dumps(train_mesh_out)}")
    mark("phase 23")

    # -- 24. training the mixture-of-experts stack on a mesh ---------------
    gc.collect()
    torch.cuda.empty_cache()
    moe_train_out, moe_train_launches, t24 = train_moe_mesh_phase(
        torch, np, MESH, get, smoke_variant, n_ranks, args.seed, flash_fwd,
        flash_bwd, gen, flush)
    log(f"phase 24 measurements: {json.dumps(moe_train_out)}")
    mark("phase 24")

    # -- 25. training the recurrent and sliding-window stacks on a mesh ----
    gc.collect()
    torch.cuda.empty_cache()
    rec_train_out, rec_train_launches, t25 = train_rec_mesh_phase(
        torch, np, MESH, get, smoke_variant, n_ranks, args.seed, flash_fwd,
        flash_bwd, gen, flush)
    log(f"phase 25 measurements: {json.dumps(rec_train_out)}")
    mark("phase 25")

    # -- 26. the prefill and decode step factories on a mesh, whisper-base
    # trained there
    gc.collect()
    torch.cuda.empty_cache()
    steps_out, steps_launches, t26 = steps_mesh_phase(
        torch, np, MESH, get, n_ranks, args.seed, flash_fwd, flash_bwd, gen,
        flush)
    del flush
    log(f"phase 26 measurements: {json.dumps(steps_out)}")
    mark("phase 26")

    def on_train_mesh(name):
        """Each rank's launches in each phase-23, 24 and 25 run."""
        return {tag: [ln[name] for ln in runs]
                for tag, runs in {**train_mesh_launches,
                                  **moe_train_launches,
                                  **rec_train_launches}.items()}

    def on_steps_mesh(name):
        """Each rank's launches in each phase-26 run (a factory run's
        prefill under the kernel's name, its decode steps under
        ``<name>_steps``)."""
        return {tag: [ln.get(name, 0) + ln.get(f"{name}_steps", 0)
                      for ln in runs]
                for tag, runs in steps_launches.items()}

    def on_frontend_and_whisper(name):
        return dict(launches_whisper={t: wh_launches[t][name]
                                      for t in wh_launches},
                    launches_frontend=frontend_launches[name])

    def on_prefix_path(name):
        return {tag: prefix_launches[tag][name] for tag in ("11a", "11b")}

    def on_moe_path(name):
        return {tag: moe_launches[tag][name] for tag in ("12a", "12b", "12c")}

    def on_gemma_path(name):
        return {tag: gemma_launches[tag][name]
                for tag in ("13a", "13b", "13c", "13d")}

    def on_llama_paths(name):
        return dict(launches_llama4={t: llama_launches[t][name]
                                     for t in ("17a", "17b", "17d")},
                    launches_fixedrate=fr_launches[name])

    def on_mesh(name):
        """Each rank's launches in each phase-21 run."""
        return {tag: [ln[name] for ln in run["launches"]]
                for tag, run in mesh_out["runs"].items()}

    def on_moe_mesh(name):
        """Each rank's launches in each phase-22 run."""
        return {tag: [ln[name] for ln in runs]
                for tag, runs in moe_mesh_launches.items()}

    def on_recurrent_paths(name):
        return dict(
            launches_recurrentgemma={t: rg_launches[t][name]
                                     for t in ("14a", "14b")},
            launches_xlstm={t: xl_launches[t][name] for t in ("15a", "15b")},
            launches_recurrent_draft=l10d.get(name, 0))

    kernels = [
        dict(name="ecf8_decode", route="cuda",
             source="src/repro_torch/csrc/ecf8_decode.cu",
             replaces="src/repro/kernels/ecf8_decode.py:36",
             launches=launches["ecf8_decode"], redesigned="slice 4",
             launches_prefix_sharing=on_prefix_path("ecf8_decode"),
             launches_moe=on_moe_path("ecf8_decode"),
             launches_gemma2=on_gemma_path("ecf8_decode"),
             **on_recurrent_paths("ecf8_decode"),
             **on_llama_paths("ecf8_decode"),
             at_moe_shape=results["moe_wi_gate"],
             at_gemma2_shape=results["g2_embed"],
             at_recurrentgemma_shape=results["rg_w_a"],
             at_xlstm_shape=results["xl_slstm_r"],
             at_llama4_shape=results["llama4_expert"],
             **on_frontend_and_whisper("ecf8_decode"),
             at_whisper_shape=results["whisper_unembed"],
             launches_train=train_launches["ecf8_decode"],
             launches_ckpt_restore=ckpt_b1,
             launches_mesh=on_mesh("ecf8_decode"),
             launches_mesh_moe=on_moe_mesh("ecf8_decode"),
             launches_mesh_steps=on_steps_mesh("ecf8_decode"),
             at_expert_shape_a_rank={
                 k: v for k, v in moe_mesh_out["checks"].items()
                 if k.startswith("b1_")},
             fixedrate_decode=fr_results, **results["wi_gate"]),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_fwd.py:37",
             launches=launches["flash_fwd"], redesigned="slice 4",
             launches_prefix_sharing=on_prefix_path("flash_fwd"),
             launches_moe=on_moe_path("flash_fwd"),
             launches_gemma2=on_gemma_path("flash_fwd"),
             **on_recurrent_paths("flash_fwd"),
             **on_llama_paths("flash_fwd"),
             at_moe_shape=results["flash_moe_T2048"],
             at_gemma2_shape=results["flash_g2_T4096"],
             at_recurrentgemma_shape=results["flash_rg_T2048"],
             at_llama4_shape=results["flash_llama_T8192"],
             **on_frontend_and_whisper("flash_fwd"),
             at_whisper_shape=results["flash_whisper_enc"],
             at_whisper_cross_shape=results["flash_whisper_cross"],
             launches_train=train_launches["flash_fwd"],
             launches_mesh=on_mesh("flash_fwd"),
             launches_mesh_q_base=on_mesh("flash_fwd_q_base"),
             launches_mesh_moe=on_moe_mesh("flash_fwd"),
             q_base_at_shard_shape=mesh_out["q_base_checks"],
             launches_mesh_train=on_train_mesh("flash_fwd"),
             launches_mesh_train_q_base=on_train_mesh("flash_fwd_q_base"),
             with_stats_q_base_at_train_shape=t23["b4"],
             with_stats_q_base_at_moe_train_shape=t24["b4"],
             with_stats_q_base_at_gemma2_train_shape=t25["b4"],
             launches_mesh_steps=on_steps_mesh("flash_fwd"),
             launches_mesh_steps_q_base=on_steps_mesh("flash_fwd_q_base"),
             at_whisper_cross_train_shape=t26["b4"],
             with_stats_at_train_shape={
                 k: results["bwd_qwen3"][k]
                 for k in ("fwd_ms", "fwd_stats_ms", "stats_err")},
             **results["flash_T512"]),
        dict(name="kv_page_decode", route="cuda",
             source="src/repro_torch/csrc/kv_page_decode.cu",
             replaces="src/repro/kvcache/kernels.py:34",
             launches=launches3["kv_page_decode"], redesigned="slice 5",
             launches_prefix_sharing=on_prefix_path("kv_page_decode"),
             launches_moe=on_moe_path("kv_page_decode"),
             launches_gemma2=on_gemma_path("kv_page_decode"),
             **on_recurrent_paths("kv_page_decode"),
             **on_llama_paths("kv_page_decode"), at_llama4_shape=None,
             **on_frontend_and_whisper("kv_page_decode"),
             at_whisper_shape=None,
             launches_train=train_launches["kv_page_decode"],
             launches_mesh=on_mesh("kv_page_decode"),
             launches_mesh_moe=on_moe_mesh("kv_page_decode"),
             launches_mesh_steps=on_steps_mesh("kv_page_decode"),
             launches_mesh_sharded={
                 tag: [ln["kv_page_decode_by_path"].get("sharded", 0)
                       for ln in run["launches"]]
                 for tag, run in mesh_out["runs"].items()},
             sharded_at_mesh_shape=mesh_out["b3_sharded"],
             at_moe_shape=results["kv_moe_bf16_48"],
             at_gemma2_shape=results["kv_g2_bf16_48"], **results["kv_bf16"]),
        dict(name="fused_decode_matmul", route="cuda",
             source="src/repro_torch/csrc/fused_decode_matmul.cu",
             replaces="src/repro/kernels/fused_decode_matmul.py:80",
             launches=launches_b2, redesigned="slice 5",
             launches_prefix_sharing=on_prefix_path("fused_decode_matmul"),
             launches_moe=on_moe_path("fused_decode_matmul"),
             launches_gemma2=on_gemma_path("fused_decode_matmul"),
             **on_recurrent_paths("fused_decode_matmul"),
             **on_llama_paths("fused_decode_matmul"), at_llama4_shape=None,
             **on_frontend_and_whisper("fused_decode_matmul"),
             at_whisper_shape=None,
             launches_train=train_launches["fused_decode_matmul"],
             **results["b2_wi_gate_M4"]),
        dict(name="flash_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/models/flash_attention.py:142",
             replaces_note="the port's counterpart of the reference's jnp "
                           "backward _flash_bwd, not a TPU kernel",
             launches=train_launches["flash_bwd"],
             launches_per_train_step=train_out["launches_per_step"][
                 "flash_bwd"],
             launches_mesh_train=on_train_mesh("flash_bwd"),
             launches_mesh_train_q_base=on_train_mesh("flash_bwd_q_base"),
             q_base_at_shard_shape=train_mesh_out["q_base_checks"],
             q_base_at_moe_train_shape=t24["b5"],
             q_base_at_gemma2_train_shape=t25["b5"],
             launches_mesh_steps=on_steps_mesh("flash_bwd"),
             launches_mesh_steps_q_base=on_steps_mesh("flash_bwd_q_base"),
             at_whisper_cross_train_shape=t26["b5"],
             library="scaled_dot_product_attention backward, no softcap",
             at_gemma2_shape=results["bwd_gemma2"],
             at_whisper_shape=results["bwd_whisper"],
             f32_at_T451={tag: results[f"bwd_{tag}_f32"]
                          for tag in bwd_shapes},
             **results["bwd_qwen3"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
