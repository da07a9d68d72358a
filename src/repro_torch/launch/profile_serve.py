"""Where the time of one prefill and of the decode steps goes, on the card.

Serves ``--batch`` requests of ``--prompt`` tokens through the engine on
``--arch`` (qwen3-8b by default; full width, ``--layers`` cuts the depth),
warms up, then traces one
more prefill and ``--steps`` batched decode steps with ``torch.profiler``
and prints, for each window: wall time, device busy time (the sum of kernel
times; one stream, so kernels do not overlap), the idle share, and device
time by kernel.  With ``--cache paged-compressed`` the prompts' full pages
are entropy-coded into the cold pool (host work, outside the traced
windows) and every traced decode step decodes the cold pool.  A stack
without paged layers (recurrentgemma, xlstm) is served from the monolithic
cache.  The recurrent mixers (``models.recurrent``'s ``*_apply`` and
``*_step``, their weight decodes included) run inside profiler ranges, and
their device time and share of the busy time are printed for each window.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 36
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch moonshot-v1-16b-a3b
    # gemma2-9b at chip_smoke.py phase 13's max_len: prompts past the
    # local window (local_attention at prefill, rings of 4096 in decode)
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch gemma2-9b --max-len 8192 --prompt 4500
    # recurrentgemma-2b at chip_smoke.py phase 14's max_len, a prompt past
    # the window of 2048 (the RG-LRU scan and local_attention at prefill)
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch recurrentgemma-2b --max-len 4096 --prompt 3000
    # qwen3-8b at chip_smoke.py phase 16's depth from ECF8-FR weights
    # (every weight decoded by plain PyTorch on the card)
    PYTHONPATH=src python -m repro_torch.launch.profile_serve --layers 12 \
        --compress fixedrate
    # llama4-scout at phase 17's depth and max_len, a prompt the window
    # (8192) covers
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch llama4-scout-17b-a16e --layers 8 --max-len 8704 --prompt 8180
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import get
from ..models import recurrent
from ..serving import EngineConfig, GenerationEngine, Request
from .serve import build_params

_MIXERS = ("rglru_apply", "rglru_step", "mlstm_apply", "mlstm_step",
           "slstm_apply", "slstm_step")


def _trace_mixers():
    """Run each recurrent mixer inside a profiler range named
    ``recurrent.<fn>`` (``models.model`` looks them up on the module at
    every call)."""
    def ranged(name, fn):
        def call(*a, **kw):
            with torch.profiler.record_function(f"recurrent.{name}"):
                return fn(*a, **kw)
        return call

    for name in _MIXERS:
        setattr(recurrent, name, ranged(name, getattr(recurrent, name)))


def _kernel_times(prof) -> dict:
    """Device microseconds by kernel name (the device-side copies of the
    ``recurrent.*`` ranges are spans, not kernels, and are left out)."""
    out: dict = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith("recurrent.")):
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
    mixers: dict = {}       # the host-side ranges: their kernels' time
    for e in prof.events():
        if (e.name.startswith("recurrent.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            mixers[e.name] = mixers.get(e.name, 0.0) + e.device_time_total
    if mixers:
        total = sum(mixers.values()) / 1e6
        parts = ", ".join(f"{k[len('recurrent.'):]} {us / 1e3:.3f} ms"
                          for k, us in sorted(mixers.items()))
        print(f"[profile]   recurrent mixers: {total * 1e3:.3f} ms, "
              f"{total / busy:.1%} of busy ({parts})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the architecture's own)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--compress", default="tpu",
                    choices=["none", "tpu", "fixedrate"])
    ap.add_argument("--cache", default="paged",
                    choices=["paged", "paged-compressed"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    _trace_mixers()
    cfg = get(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    served, _, _, _ = build_params(cfg, args.seed, args.compress,
                                   baseline=False)
    eng = GenerationEngine(served, cfg, EngineConfig(
        max_batch=args.batch, max_len=args.max_len,
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
    cold = (f", {len(eng.paged._cold_bytes)} cold pages"
            if eng.paged is not None else "")
    _report(f"{args.steps} decode steps at batch {args.batch} "
            f"({eng.cache_mode if eng.paged is None else args.cache}{cold})",
            prof, wall)


if __name__ == "__main__":
    main()
