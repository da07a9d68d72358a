"""Time the serve path's weight decode, ``store.materialize(w, "bfloat16")``,
on the card at qwen3-8b's wq, wi_gate and embed shapes, and list the device
kernels one call launches.

Run it as a file so that it times the ``repro_torch`` found on
``PYTHONPATH``; pointing that at two checkouts in one call compares their
decode paths on one card (the kernels are built from each checkout):

    PYTHONPATH=src python src/repro_torch/launch/bench_decode.py [--seed S]

Prints the card's name and power limit, then one line a shape (CUDA events
around 20 back-to-back calls, each after a 256 MB L2 flush, less the
flushes alone; median of three windows; kernel names from
``torch.profiler``) and a last line of JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch.configs import get
from repro_torch.core import fp8, store


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


def _kernels(fn) -> list:
    """Names of the device kernels that three calls of ``fn`` launch."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "memset" not in e.name.lower()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[bench_decode] {card}; repro_torch from "
          f"{repro_torch.__path__[0]}", flush=True)
    cfg = get("qwen3-8b")
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, shape in [("wq", (d, cfg.n_heads * cfg.hd)),
                        ("wi_gate", (d, cfg.d_ff)),
                        ("embed", (cfg.vocab_size, d))]:
        w = torch.randn(shape, generator=gen, device="cuda").mul_(d ** -0.5)
        ct = store.compress_array(fp8.cast_to_fp8_bits(w))
        want = fp8.cast_to_fp8(w).to(torch.bfloat16)
        del w
        got = store.materialize(ct, "bfloat16")
        if not torch.equal(got, want):
            raise SystemExit(f"bench_decode {name}: decode is not lossless")
        del got, want
        ms = _ms(lambda: store.materialize(ct, "bfloat16"), flush)
        names = _kernels(lambda: store.materialize(ct, "bfloat16"))
        out[name] = {"ms": ms, "kernels": names}
        print(f"[bench_decode] {name} {shape}: {ms:.4f} ms, kernels "
              f"{names}", flush=True)
    print(json.dumps({"card": card, "materialize_bf16": out}), flush=True)


if __name__ == "__main__":
    main()
