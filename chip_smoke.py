"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the repository root on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py [--layers N] [--seed S]

Phases, each failing loudly (non-zero exit, no result line):
  1. the card's name and power limit; the four CUDA kernels built with
     nvcc for sm_90a from ``src/repro_torch/csrc``, all started together;
  2. the ECF8 decode kernel against its plain PyTorch version at the
     qwen3-8b embed / wi_gate / wq shapes: fp8 bits bit-exact, and its
     bf16, fp16 and f32 instances (the decode writing the weight's dtype
     itself) bit-identical to plain decode + cast; the same on a
     one-symbol and a near-uniform codebook and a container holding all
     256 fp8 codes (NaNs compared by isnan); timed on the card (CUDA
     events): the bf16 instance beside the fp8-bits instance followed by
     ``.to(bf16)``;
  3. the flash-attention kernel (bf16 and fp16 on the tensor cores)
     against its plain version in bf16 (B=1, Hq=32, Hkv=8, D=128, causal,
     T in {13, 451, 512, 2048}) and fp16 (T=2048), with the time of
     ``F.scaled_dot_product_attention`` as a yardstick (TFLOP/s and the
     factor against it printed; timed after L2 flushes);
  3b. the KV page-decode kernel against its plain version, bit-exact:
     252 bf16 pages at the qwen3-8b page shape (8 x 16 x 128, the default
     cold pool of the serve shape), the 48 bf16 pages of phase 7's cold
     pool (``SWAP_N_COLD_SLOTS``, the launch a decode step makes there),
     f32 and fp8 pages, a batch of edge pages (one symbol, all 256
     exponents, mixed strides zero-padded to one, never-written slots),
     and 8 bf16 pages of 128 positions (8 x 128 x 128, the kernel's
     streamed instance: too large to stage in shared memory), timed on
     the card;
  3c. the fused decode + matrix product kernel through its op
     (``ops.fused_decode_matmul``; no serve path calls it) at qwen3-8b's
     wq / wi_gate / wo_mlp shapes in the tiled ECF8 layout, M = 4 and 512,
     and M = 600 at wq (the op's row blocks, two launches):
     within 1e-4 of its plain version relative to the output's magnitude,
     two launches bit-equal, and bit-exact on the weight (one-hot rows);
     timed beside what the serve path pays for the same product (the
     weight decode writing bf16, as ``store.materialize`` asks it, then
     torch.matmul), the decode alone and torch.matmul alone;
  4. a small f32 model whose prefill logits on the card (both kernels)
     agree with the CPU run (plain versions), whose paged-compressed
     decode-step logits, with cold pages, agree too, and whose chunked-
     prefill logits agree with the CPU and with its own whole-prompt
     prefill; served by the engine on the card, its greedy tokens are the
     same over the monolithic cache as over the paged one, with a draft
     model (k = 1 and 4) as without, and with a draft under page pressure
     (preempting, swapping) as without pressure;
  5. qwen3-8b at full width and depth (``--layers`` cuts it), ECF8-
     compressed and served by the paged engine (8 requests of 64-512
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
     the verify over cold history (tokens compared with 10b's, counted).
No serve phase may launch the fused kernel.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12            # dense tensor-core bf16, SXM data sheet
FLASH_TOL = 2e-2
FUSED_TOL = 1e-4        # relative to max |plain|: f32 sums in another order
# phase 7's undersized pools: raw pages (id 0 is the garbage page) and cold
# slots, against a worst case of 1 + 4 * 1024 / 16 = 257 pages
SWAP_N_PAGES, SWAP_N_COLD_SLOTS = 40, 48
CHUNK = 128             # phase 8's prefill chunk and per-step token budget
SPEC_K = 4              # phase 10's drafted tokens a round
B2_ROWS = 600           # phase 3c's M above the kernel's row block (512)


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
                 reps):
    """Kernel 1 vs its plain version on one container: fp8 bits bit-exact
    and lossless; the bf16, fp16 and f32 instances bit-identical to plain
    decode + cast; the time of the bf16 instance beside the fp8-bits
    instance followed by a cast -> result dict of the serve path's instance
    (bf16).  ``launch/bench_decode.py`` times the decode path of another
    checkout against this one."""
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
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                old_ms=old_ms, fp8_ms=fp8_ms)


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


def check_flash(torch, flash_fwd, T, gen, flush, dtype=None):
    """Kernel 4 vs its plain version (bf16 unless ``dtype``, causal) ->
    result dict.  Timed after L2 flushes: a window of back-to-back calls
    alone would time the host's issue of each call (~20 us) wherever the
    kernel is shorter."""
    B, Hq, Hkv, D = 1, 32, 8, 128
    dev = "cuda"
    dtype = dtype or torch.bfloat16

    def rnd(h):
        return torch.randn((B, h, T, D), generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    got = flash_fwd.run(q, k, v, causal=True)
    want = flash_fwd.plain(q, k, v, True, 0.0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"flash_fwd T={T}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    if err > FLASH_TOL:
        fail(f"flash_fwd T={T} {dtype}: max |kernel - plain| = {err} > "
             f"{FLASH_TOL}")
    ms = cuda_ms(torch, lambda: flash_fwd.run(q, k, v, causal=True), 20,
                 flush)
    plain_ms = cuda_ms(torch, lambda: flash_fwd.plain(q, k, v, True, 0.0), 5,
                       flush)
    k_rep = k.repeat_interleave(Hq // Hkv, dim=1)
    v_rep = v.repeat_interleave(Hq // Hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(torch, lambda: sdpa(q, k_rep, v_rep, is_causal=True), 20,
                     flush)
    pairs = T * (T + 1) // 2
    flops = 4 * B * Hq * D * pairs
    moved = sum(t.numel() * t.element_size() for t in (q, k, v, got))
    bound_ops = flops / H100_BF16_FLOPS * 1e3
    bound_bytes = moved / H100_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops, bound_bytes)
    log(f"flash_fwd T={T} {str(dtype).split('.')[-1]}: max_abs_err "
        f"{err:.3e} (tol {FLASH_TOL}), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms (kernel / sdpa "
        f"{ms / lib_ms:.2f}), bound {bound_ms:.4f} ms "
        f"({'operations' if bound_ops >= bound_bytes else 'bytes'}; "
        f"{100 * bound_ms / ms:.1f} % of it), "
        f"{flops / ms / 1e9:.2f} TFLOP/s")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                library_ms=lib_ms)


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


def check_small_paged(torch, M, paged, small, p_cpu, p_gpu, seed):
    """Paged-compressed decode steps of the small model on the card vs the
    CPU, with cold pages decoded in the step -> max |dlogit|."""
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
        for _ in range(6):
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


def to_device(tree, dev, store):
    """A parameter tree (tensors and CompressedTensors) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev, store) for k, v in tree.items()}
    if store.is_compressed(tree):
        return store.CompressedTensor(
            {k: a.to(dev) for k, a in tree.arrays.items()}, tree.meta)
    return tree.to(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=36,
                    help="qwen3-8b depth served in phases 5-8 (36 = full)")
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
    from repro_torch.configs import get
    from repro_torch.core import fp8, store, tpu_format
    from repro_torch.kernels import build, ecf8_decode, flash_fwd, ops
    from repro_torch.kernels import fused_decode_matmul as fused
    from repro_torch.kvcache import codec, paged
    from repro_torch.kvcache import kernels as kv_page
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch import serving
    from repro_torch.serving import EngineConfig

    # float32 products in full f32, as XLA computes them in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
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
    for name, shape, fan_in in [("wq", (d, cfg_full.n_heads * cfg_full.hd), d),
                                ("wi_gate", (d, ff), d),
                                ("embed", (V, d), d)]:
        w = torch.randn(shape, generator=gen, device="cuda").mul_(
            fan_in ** -0.5)
        bits = fp8.cast_to_fp8_bits(w)
        del w
        results[name] = check_decode(torch, ecf8_decode, fp8, tpu_format,
                                     name, bits, flush, reps=20)
        del bits
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
    del weights, eye, rows, flush

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

    if serve_b2:
        fail(f"a serve path launched fused_decode_matmul {serve_b2} times")
    by_dtype = dict(ecf8_decode.run.launches_by_dtype)
    if set(by_dtype) != {torch.bfloat16}:
        fail(f"phases 5-10 decoded a compressed weight to another dtype "
             f"than bf16: {by_dtype}")
    log(f"ecf8_decode over phases 5, 7, 8a, 8b, 9, 10a-c: "
        f"{by_dtype[torch.bfloat16]} launches, all writing bf16 (no cast "
        f"kernel after a decode)")
    log("fused_decode_matmul: 0 launches on every serve path (phases 5, 7, "
        "8a, 8b, 9, 10a-c), as in the reference")

    kernels = [
        dict(name="ecf8_decode", route="cuda",
             source="src/repro_torch/csrc/ecf8_decode.cu",
             replaces="src/repro/kernels/ecf8_decode.py:36",
             launches=launches["ecf8_decode"], redesigned="slice 4",
             **results["wi_gate"]),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_fwd.py:37",
             launches=launches["flash_fwd"], redesigned="slice 4",
             **results["flash_T512"]),
        dict(name="kv_page_decode", route="cuda",
             source="src/repro_torch/csrc/kv_page_decode.cu",
             replaces="src/repro/kvcache/kernels.py:34",
             launches=launches3["kv_page_decode"], redesigned="slice 5",
             **results["kv_bf16"]),
        dict(name="fused_decode_matmul", route="cuda",
             source="src/repro_torch/csrc/fused_decode_matmul.cu",
             replaces="src/repro/kernels/fused_decode_matmul.py:80",
             launches=launches_b2, redesigned="slice 5",
             **results["b2_wi_gate_M4"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
