"""Batched serving entry point: the paper's RQ2 experiment shape, on the card.

Synthesizes weights from ``--seed`` (no checkpoint is read), casts the
large ones to fp8 (the baseline the paper compresses), compresses them to
ECF8, and serves a batch of requests through the continuous-batching
engine; ``--check-lossless`` replays the prompts on the fp8 baseline and
exits 1 unless every greedy token is identical.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --compress tpu --cache paged --check-lossless
  # on a machine without a card, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The helpers below are the same steps for a caller that brings its own
``ArchConfig`` or prompts (``chip_smoke.py`` serves a depth-cut qwen3-8b).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get, smoke_variant
from ..core.store import compress_tree, fp8_cast_tree
from ..device import resolve
from ..models import model as M
from ..serving import EngineConfig, EngineConfigError, GenerationEngine, \
    Request

# the reference's leaf-selection threshold for serving (launch/serve.py)
MIN_ELEMS = 4096


def build_params(cfg, seed: int, fmt: str = "tpu", device="cuda"):
    """Synthesize weights and prepare both trees a serve run uses.

    Returns ``(served, baseline, report, encode_seconds)``: ``baseline`` is
    the fp8 cast of the large weights, ``served`` their ECF8 compression
    (``fmt="tpu"``) or the baseline itself (``fmt="none"``)."""
    params = M.init_params(cfg, seed, device=device)
    t0 = time.perf_counter()
    report = None
    if fmt != "none":
        served, report = compress_tree(params, fmt=fmt, min_elems=MIN_ELEMS,
                                       out_dtype=cfg.dtype)
    baseline = fp8_cast_tree(params, min_elems=MIN_ELEMS)
    if fmt == "none":
        served = baseline
    if resolve(device).type == "cuda":
        torch.cuda.synchronize()
    return served, baseline, report, time.perf_counter() - t0


def make_prompts(cfg, n: int, seed: int, lo: int = 4, hi: int = 12):
    """``n`` prompts of ``lo <= len < hi`` tokens drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size,
                         size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def serve(params, cfg, ecfg: EngineConfig, prompts, max_new: int,
          device="cuda"):
    """Serve ``prompts`` greedily -> (finished requests, engine, seconds)."""
    eng = GenerationEngine(params, cfg, config=ecfg, device=device)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, eng, time.perf_counter() - t0


def same_tokens(a, b) -> bool:
    return all(x.out_tokens == y.out_tokens for x, y in zip(a, b))


def main(argv=None, cfg=None):
    """CLI entry point; ``cfg`` overrides ``--arch``/``--smoke``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--compress", default="tpu", choices=["none", "tpu"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--check-lossless", action="store_true",
                    help="compare tokens vs the uncompressed fp8 baseline")
    ap.add_argument("--cache", default="paged", choices=["paged"],
                    help="KV-cache layout (the paged cache; the other "
                         "layouts are not yet ported)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None,
                    help="raw page-pool size (default: worst case)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
    try:
        ecfg = EngineConfig.from_args(args, cfg)
    except EngineConfigError as e:
        ap.error(str(e))

    params_c, params_fp8, report, enc_s = build_params(
        cfg, args.seed, args.compress, device=args.device)
    if report is not None:
        fp8_b = max(report["fp8_bytes"], 1)
        print(f"[serve] ECF8({args.compress}) encode {enc_s:.1f}s: "
              f"{report['n_compressed']} tensors, fp8 {fp8_b / 1e6:.2f}MB ->"
              f" {report['compressed_bytes'] / 1e6:.2f}MB "
              f"({100 * (1 - report['compressed_bytes'] / fp8_b):.1f}% "
              f"saved)")
    prompts = make_prompts(cfg, args.requests, args.seed)
    done, eng, dt = serve(params_c, cfg, ecfg, prompts, args.max_new,
                          device=args.device)
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s host wall-clock, "
          f"{eng.steps} decode steps, batch occupancy "
          f"{n_tok / max(eng.steps, 1):.2f})")
    if args.check_lossless and args.compress != "none":
        done2, _, _ = serve(params_fp8, cfg, ecfg, prompts, args.max_new,
                            device=args.device)
        same = same_tokens(done, done2)
        print(f"[serve] lossless check vs fp8 baseline: "
              f"{'IDENTICAL' if same else 'MISMATCH'}")
        if not same:
            raise SystemExit(1)
    return done


if __name__ == "__main__":
    main()
