"""Time the page decode (B3, ``ops.decode_pages``), the fused decode +
matrix product (B2, ``ops.fused_decode_matmul``) and the flash backward
(B5, ``flash_bwd.run``) on the card, at the shapes ``chip_smoke.py``
phases 3b, 3c, 3d and 23 use.

Run it as a file so that it times the ``repro_torch`` found on
``PYTHONPATH``; pointing that at two checkouts in one call compares their
kernels on one card (the kernels are built from each checkout):

    PYTHONPATH=src python src/repro_torch/launch/bench_kernels.py [--seed S]

B3: bf16 pages of the qwen3-8b page shape (8 x 16 x 128) at a cold slot's
stride budget, 252 (the default cold pool) and 48 (a decode step's launch
with ``chip_smoke.SWAP_N_COLD_SLOTS`` cold slots), 16 f32 and 16 fp8 pages.
B2: qwen3-8b's wq, wi_gate and wo_mlp at M = 4 and 512.  B5 in bf16 at
qwen3-8b's heads (B 2, 32 / 8 of 128, T 2048, causal), gemma2-9b's (B 2,
16 / 8 of 256, T 2048, softcap 50), whisper-base's encoder (B 4, 8 / 8 of
64, 1500 frames, non-causal) and the micro-batch of a model rank past
the first in the four-card training mesh (qwen3's heads, B 2, rows [1024,
2048) of 2048, ``q_base`` 1024), beside SDPA's backward alone on the same
inputs (no softcap: SDPA has none; under ``q_base`` the causal mask as a
boolean mask, K / V repeated to the heads), its bound (five products of
``2 * D`` flops a visible pair at 989 TFLOP/s) and, where the package has
:func:`flash_bwd.attributes`, each kernel's registers and spill bytes.
Every output is checked (pages lossless, products within 1e-4 of the
plain version relative to its magnitude, gradients within 2e-2 of the
plain gradient's largest magnitude) before it is timed: CUDA events
around 20 back-to-back calls, each after a 256 MB L2 flush, less the
flushes alone, median of three windows.  Prints the card's name and
power limit, one line a case and a last line of JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

import repro_torch
from repro_torch.configs import get
from repro_torch.core import fp8
from repro_torch.kernels import flash_bwd, flash_fwd
from repro_torch.kernels import fused_decode_matmul as fused
from repro_torch.kernels import ops
from repro_torch.kvcache import codec


def _ms(fn, flush, reps: int = 20) -> float:
    fn()

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

    return statistics.median(
        (window(flushed) - window(flush.zero_)) / reps for _ in range(3))


def _pages(gen, n_pages, dtype, n):
    """Coded cache-like pages at a cold slot's stride budget -> (the four
    decode inputs on the card, the pages)."""
    import numpy as np
    name = codec.dtype_name(dtype)
    pages = [(torch.randn(n, generator=gen, device="cuda")
              * 10 ** (-2 + 3 * i / max(n_pages - 1, 1))).to(dtype)
             for i in range(n_pages)]
    cps = [codec.encode_page(p) for p in pages]
    exp_bits = codec.plane_spec(name)[0]
    stride = max([-(-codec.sym_per_lane(n) * exp_bits // 8)]
                 + [c.stride for c in cps])
    pay = np.zeros((n_pages, stride, codec.LANES), np.uint8)
    for i, c in enumerate(cps):
        pay[i, : c.stride] = c.payload
    arrays = (pay, np.stack([c.signmant for c in cps]),
              np.stack([c.tables() for c in cps]),
              np.stack([c.perm for c in cps]))
    return [torch.from_numpy(a).cuda() for a in arrays], pages


# B5's shapes: (B, Hq, Hkv, D, rows, keys, causal, softcap, q_base)
BWD_SHAPES = {
    "qwen3": (2, 32, 8, 128, 2048, 2048, True, 0.0, 0),
    "gemma2": (2, 16, 8, 256, 2048, 2048, True, 50.0, 0),
    "whisper": (4, 8, 8, 64, 1500, 1500, False, 0.0, 0),
    "mesh_rank1": (2, 32, 8, 128, 1024, 2048, True, 0.0, 1024),
}
BF16_FLOPS = 989e12     # dense tensor-core bf16, H100 SXM data sheet


def _bwd(gen, flush, name, B, Hq, Hkv, D, T, Tk, causal, cap, base):
    """B5 at one shape: checked, then timed beside SDPA's backward ->
    {ms, bound_ms, sdpa_ms, tflops, max_rel_err[, regs]}."""
    def rnd(h, n):
        return torch.randn((B, h, n, D), generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(Hq, T), rnd(Hkv, Tk), rnd(Hkv, Tk), rnd(Hq, T)
    kw = dict(causal=causal, softcap=cap, q_base=base)
    o, m, l = flash_fwd.run(q, k, v, stats=True, **kw)
    got = flash_bwd.run(q, k, v, o, m, l, do, **kw)
    want = flash_bwd.plain(q, k, v, o, m, l, do, causal, cap, q_base=base)
    rel = max(float((g.float() - w.float()).abs().max())
              / float(w.float().abs().max()) for g, w in zip(got, want))
    if not rel <= 2e-2:
        raise SystemExit(f"bench_kernels flash_bwd {name}: relative error "
                         f"{rel}")
    del got, want
    ms = _ms(lambda: flash_bwd.run(q, k, v, o, m, l, do, **kw), flush)
    if base:        # the mask explicit, K / V repeated to the heads
        rows = base + torch.arange(T, device="cuda")
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
    sdpa_ms = _ms(lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True), flush)
    pairs = (sum(min(Tk, base + r + 1) for r in range(T)) if causal
             else T * Tk)
    flops = 10 * B * Hq * D * pairs
    res = dict(ms=ms, bound_ms=flops / BF16_FLOPS * 1e3, sdpa_ms=sdpa_ms,
               tflops=flops / ms / 1e9, max_rel_err=rel)
    if hasattr(flash_bwd, "attributes"):
        res["regs"] = flash_bwd.attributes(D, torch.bfloat16)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[bench_kernels] {card}; repro_torch from "
          f"{repro_torch.__path__[0]}", flush=True)
    cfg = get("qwen3-8b")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    n = cfg.n_kv_heads * 16 * cfg.hd
    out = {"card": card, "kv_page_decode": {}, "fused_decode_matmul": {},
           "flash_bwd": {}}
    for name, n_pages, dtype in [("bf16", 252, torch.bfloat16),
                                 ("bf16_48", 48, torch.bfloat16),
                                 ("f32", 16, torch.float32),
                                 ("fp8", 16, torch.float8_e4m3fn)]:
        a, pages = _pages(gen, n_pages, dtype, n)
        dn = codec.dtype_name(dtype)
        bits = codec.TORCH_BITS[dn]
        got = ops.decode_pages(*a, n_elem=n, dtype_name=dn)
        if not all(torch.equal(got[i].view(bits), p.reshape(-1).view(bits))
                   for i, p in enumerate(pages)):
            raise SystemExit(f"bench_kernels {name}: not lossless")
        ms = _ms(lambda: ops.decode_pages(*a, n_elem=n, dtype_name=dn), flush)
        out["kv_page_decode"][name] = ms
        print(f"[bench_kernels] kv_page_decode {name}: {n_pages} pages, "
              f"stride {a[0].shape[1]}: {ms:.4f} ms", flush=True)
    d, ff = cfg.d_model, cfg.d_ff
    for name, K, N in [("wq", d, cfg.n_heads * cfg.hd), ("wi_gate", d, ff),
                       ("wo_mlp", ff, d)]:
        w = torch.randn((K, N), generator=gen, device="cuda").mul_(K ** -0.5)
        tiled = fused.encode_tiled(fp8.cast_to_fp8_bits(w), sym_per_lane=256)
        del w
        for M in (4, fused.MAX_ROWS):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = ops.fused_decode_matmul(x, tiled)
            want = fused.plain(x, tiled)
            err = float((got - want).abs().max() / want.abs().max())
            if err > 1e-4:
                raise SystemExit(f"bench_kernels {name} M={M}: relative "
                                 f"error {err}")
            ms = _ms(lambda: ops.fused_decode_matmul(x, tiled), flush)
            out["fused_decode_matmul"][f"{name}_M{M}"] = ms
            print(f"[bench_kernels] fused_decode_matmul {name} ({K}x{N}) "
                  f"M={M}: {ms:.4f} ms (relative error {err:.1e})",
                  flush=True)
    for name, shape in BWD_SHAPES.items():
        r = _bwd(gen, flush, name, *shape)
        out["flash_bwd"][name] = r
        print(f"[bench_kernels] flash_bwd {name} {shape}: {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s), bound {r['bound_ms']:.4f} ms, "
              f"sdpa backward {r['sdpa_ms']:.4f} ms (kernel / sdpa "
              f"{r['ms'] / r['sdpa_ms']:.2f}), registers / spill bytes "
              f"{r.get('regs', 'not read')}, relative error "
              f"{r['max_rel_err']:.1e}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
