"""Time the page decode (B3, ``ops.decode_pages``) and the fused decode +
matrix product (B2, ``ops.fused_decode_matmul``) on the card, at the shapes
``chip_smoke.py`` phases 3b and 3c use.

Run it as a file so that it times the ``repro_torch`` found on
``PYTHONPATH``; pointing that at two checkouts in one call compares their
kernels on one card (the kernels are built from each checkout):

    PYTHONPATH=src python src/repro_torch/launch/bench_kernels.py [--seed S]

B3: bf16 pages of the qwen3-8b page shape (8 x 16 x 128) at a cold slot's
stride budget, 252 (the default cold pool) and 48 (a decode step's launch
with ``chip_smoke.SWAP_N_COLD_SLOTS`` cold slots), 16 f32 and 16 fp8 pages.
B2: qwen3-8b's wq, wi_gate and wo_mlp at M = 4 and 512.  Every
output is checked (pages lossless, products within 1e-4 of the plain
version relative to its magnitude) before it is timed: CUDA events around
20 back-to-back calls, each after a 256 MB L2 flush, less the flushes
alone, median of three windows.  Prints the card's name and power limit,
one line a case and a last line of JSON.
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
    out = {"card": card, "kv_page_decode": {}, "fused_decode_matmul": {}}
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
