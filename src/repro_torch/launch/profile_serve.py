"""Where the time of one prefill and of the decode steps goes, on the card.

Serves ``--batch`` requests of ``--prompt`` tokens through the engine on
qwen3-8b cut to ``--layers`` layers (full width), warms up, then traces one
more prefill and ``--steps`` batched decode steps with ``torch.profiler``
and prints, for each window: wall time, device busy time (the sum of kernel
times; one stream, so kernels do not overlap), the idle share, and device
time by kernel.  With ``--cache paged-compressed`` the prompts' full pages
are entropy-coded into the cold pool (host work, outside the traced
windows) and every traced decode step decodes the cold pool.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 36
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get
from ..serving import EngineConfig, GenerationEngine, Request
from .serve import build_params


def _kernel_times(prof) -> dict:
    """Device microseconds by kernel name."""
    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out[e.name] = out.get(e.name, 0.0) + e.device_time_total
    return out


def _report(title: str, prof, wall_s: float, top: int = 12):
    times = _kernel_times(prof)
    busy = sum(times.values()) / 1e6
    if not times:
        print(f"[profile] {title}: wall {wall_s * 1e3:.2f} ms; the profiler "
              f"recorded no device time")
        return
    print(f"[profile] {title}: wall {wall_s * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.2f} ms, idle share {1 - busy / wall_s:.3f}")
    for name, us in sorted(times.items(), key=lambda kv: -kv[1])[:top]:
        print(f"[profile]   {us / 1e3:9.3f} ms {us / 1e6 / busy:6.1%}  "
              f"{name[:110]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--compress", default="tpu", choices=["none", "tpu"])
    ap.add_argument("--cache", default="paged",
                    choices=["paged", "paged-compressed"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=args.layers)
    served, baseline, _, _ = build_params(cfg, args.seed, args.compress)
    del baseline
    eng = GenerationEngine(served, cfg, EngineConfig(
        max_batch=args.batch, max_len=1024,
        compress_cold=args.cache == "paged-compressed"))
    rng = np.random.default_rng(args.seed)

    def request():
        return Request(prompt=rng.integers(0, cfg.vocab_size,
                                           args.prompt).tolist(),
                       max_new_tokens=args.steps + 5)

    for _ in range(args.batch - 1):
        eng.submit(request())
    eng.step()                          # prefill batch-1 requests, warm up
    eng.step()
    eng.submit(request())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._admit()                    # one whole-prompt prefill
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"prefill of {args.prompt} tokens ({cfg.n_layers} layers, "
            f"{args.compress})", prof, wall)
    eng.step()                          # the new request's pages go cold
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"{args.steps} decode steps at batch {args.batch} ({args.cache}"
            f", {len(eng.paged._cold_bytes)} cold pages)", prof, wall)


if __name__ == "__main__":
    main()
