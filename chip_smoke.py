"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repository root on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py [--layers N] [--seed S]

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
     shape (no softcap), a yardstick;
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
  13. gemma2-9b at full width and depth (42 layers, ("local", "attn"),
     window 4096, head_dim 256, softcaps, post-norms), 4 requests of
     ``GEMMA_PROMPTS`` tokens, max_len 8192, page 16, 32 new tokens:
     13a the ECF8 tree alone, paged (B1 at 7 x 42 + 2 launches a pass, B4
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
Each phase logs the time since the start when it is done.  Phases 5-12,
16, 17 and 19 run at a cut depth so that the whole script stays near half
its time limit (13-15 and 18 at full depth), 20 and 20b at a depth whose
parameters, gradients and moments fit the card; every gate is
depth-independent.
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
QWEN_LAYERS = 12        # phases 5-11's depth (qwen3-8b has 36)
MOE_LAYERS = 24         # phase 12's depth (moonshot-v1-16b-a3b has 48)
GEMMA_ARCH = "gemma2-9b"            # phase 13's model
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
CKPT_LAYERS = 2         # phase 20b: ~16 GB of bf16 weights + f32 moments
# phase 20: unit 0's wq / wk / wv gradients against the plain attention's,
# relative to their largest magnitude
TRAIN_GRAD_TOL = 1e-2
FLASH_STATS_TOL = 1e-5  # m and l, relative to their largest magnitude


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
                B=1, Tk=None):
    """Kernel 4 vs its plain version (bf16 unless ``dtype``, causal unless
    ``causal`` is False, ``B`` rows of ``T`` queries over ``Tk`` keys (T by
    default), ``heads`` = (Hq, Hkv) of ``D``, qwen3-8b's by default, tanh
    ``softcap``), every output element within ``tol`` -> result dict.
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
    got = flash_fwd.run(q, k, v, causal=causal, softcap=softcap)
    want = flash_fwd.plain(q, k, v, causal, softcap)
    torch.cuda.synchronize()
    what = f"T={T}{'' if Tk == T else f' Tk={Tk}'} D={D}"
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"flash_fwd {what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if err > tol:
        fail(f"flash_fwd {what} {dtype}: max |kernel - plain| = {err} "
             f"> {tol}")
    ms = cuda_ms(torch, lambda: flash_fwd.run(q, k, v, causal=causal,
                                              softcap=softcap), 20, flush)
    plain_ms = cuda_ms(torch, lambda: flash_fwd.plain(q, k, v, causal,
                                                      softcap), 5, flush)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if gqa:
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=causal,
                                             enable_gqa=True), 20, flush)
    else:
        k_rep = k.repeat_interleave(Hq // Hkv, dim=1)
        v_rep = v.repeat_interleave(Hq // Hkv, dim=1)
        lib_ms = cuda_ms(torch, lambda: sdpa(q, k_rep, v_rep,
                                             is_causal=causal), 20, flush)
    pairs = T * (T + 1) // 2 if causal else T * Tk
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
                    tol=FLASH_TOL):
    """Phase 3d at one shape (module docstring) -> result dict.  B4 with
    its row statistics against B4 without them (o bit-identical) and
    against its plain version (m, l); B5 against its plain version on the
    same residuals, every gradient element within ``tol`` x the plain
    gradient's largest magnitude.  Timed after L2 flushes, beside the
    backward alone of SDPA (no softcap: SDPA has none) on the same
    inputs."""
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
            f"{str(dtype).split('.')[-1]}")
    o0 = flash_fwd.run(q, k, v, causal=causal, softcap=softcap)
    o, m, l = flash_fwd.run(q, k, v, causal=causal, softcap=softcap,
                            stats=True)
    _, m_p, l_p = flash_fwd.plain_stats(q, k, v, causal, softcap)
    torch.cuda.synchronize()
    if not torch.equal(o.view(torch.uint8), o0.view(torch.uint8)):
        fail(f"flash_fwd {what}: o with statistics differs from o without")
    stats_err = max(float((got - want).abs().max()) / float(want.abs().max())
                    for got, want in ((m, m_p), (l, l_p)))
    if not stats_err <= FLASH_STATS_TOL:
        fail(f"flash_fwd {what}: m / l off their plain version by "
             f"{stats_err} (relative) > {FLASH_STATS_TOL}")
    grads = flash_bwd.run(q, k, v, o, m, l, do, causal=causal,
                          softcap=softcap)
    want = flash_bwd.plain(q, k, v, o, m, l, do, causal, softcap)
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
        q, k, v, o, m, l, do, causal=causal, softcap=softcap), 10, flush)
    plain_ms = cuda_ms(torch, lambda: flash_bwd.plain(
        q, k, v, o, m, l, do, causal, softcap), 2, flush)
    fwd_ms = cuda_ms(torch, lambda: flash_fwd.run(
        q, k, v, causal=causal, softcap=softcap), 10, flush)
    stats_ms = cuda_ms(torch, lambda: flash_fwd.run(
        q, k, v, causal=causal, softcap=softcap, stats=True), 10, flush)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal, enable_gqa=Hq != Hkv)
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), 10, flush)
    del out, leaves
    pairs = T * (T + 1) // 2 if causal else T * Tk
    flops = 10 * B * Hq * D * pairs          # five products, 2.5x forward
    moved = sum(t.numel() * t.element_size()
                for t in (q, k, v, o, m, l, do, *grads))
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    bound_ops = flops / peak * 1e3
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    log(f"flash_bwd {what}: o with stats bit-identical, m / l within "
        f"{stats_err:.2e} (tol {FLASH_STATS_TOL}); dq / dk / dv max_abs_err "
        f"{err:.3e} ({rel:.2e} of the largest, tol {tol}); kernel {ms:.4f}"
        f" ms, plain {plain_ms:.3f} ms, sdpa backward {lib_ms:.4f} ms "
        f"(kernel / sdpa {ms / lib_ms:.2f}), bound {bound_ms:.4f} ms "
        f"({'operations' if bound_ops >= bound_bytes else 'bytes'}; "
        f"{100 * bound_ms / ms:.1f} % of it), {flops / ms / 1e9:.2f} "
        f"TFLOP/s; B4 forward {fwd_ms:.4f} ms, with stats {stats_ms:.4f} ms")
    return dict(max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                library_ms=lib_ms, stats_err=stats_err, fwd_ms=fwd_ms,
                fwd_stats_ms=stats_ms)


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


def train_phase(torch, M, kernels, cfg, seed):
    """Phase 20 (module docstring) on ``cfg`` -> (measurements, launches).
    ``kernels`` maps name -> wrapper (``run``) whose launch counts the
    phase reads; the flash wrappers are patched to their plain versions,
    and put back, for the reference step."""
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
    n_params = sum(p.numel() for _, p in iter_leaves(params))
    p0 = map_tree(torch.clone, params)       # step 0's weights, kept
    opt = adamw_init(params)
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
    del params, opt, batch
    # the reference: the attention patched to the plain versions, for unit
    # 0's attention gradients on micro-batch 0 and for step 0 from the same
    # weights and a fresh optimizer state
    runs = flash_fwd.run, flash_bwd.run

    def plain_fwd(q, k, v, causal=True, softcap=0.0, stats=False):
        f = flash_fwd.plain_stats if stats else flash_fwd.plain
        return f(q, k, v, causal, softcap)

    def plain_bwd(q, k, v, o, m, l, do, causal=True, softcap=0.0):
        return flash_bwd.plain(q, k, v, o, m, l, do, causal, softcap)

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=QWEN_LAYERS,
                    help="qwen3-8b depth served in phases 5-11 (36 = full)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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

    # -- 13. gemma2-9b at full width and depth from ECF8 weights -----------
    gemma_out, gemma_launches = gemma_phase(
        torch, np, serve, EngineConfig, kernel_runs, g2, args.seed)
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
    def cfg_train(layers):
        # the published Qwen3-8B unembeds with its own matrix
        # (tie_word_embeddings false); the registry's serving config ties
        return dataclasses.replace(cfg_full, n_layers=layers,
                                   tie_embeddings=False)

    if flash_bwd.run.launches:
        fail(f"a serve phase launched B5 {flash_bwd.run.launches} times")
    train_runs = {**kernel_runs, "flash_bwd": flash_bwd.run}
    train_out, train_launches = train_phase(
        torch, M, train_runs,
        cfg_train(TRAIN_LAYERS), args.seed)
    log(f"phase 20 measurements: {json.dumps(train_out)}")
    mark("phase 20")

    # -- 20b. the checkpoint drill -----------------------------------------
    ckpt_out, ckpt_b1 = ckpt_phase(
        torch, M, serve, train_runs,
        cfg_train(CKPT_LAYERS), args.seed)
    log(f"phase 20b measurements: {json.dumps(ckpt_out)}")
    mark("phase 20b")

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
