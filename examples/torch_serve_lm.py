"""Serving demo of the PyTorch port: paged, ECF8-compressed KV cache under
mixed-length load, on the card.

Weights are entropy-coded fp8, decoded on use by the hand-written ECF8
decode kernel (``csrc/ecf8_decode.cu``); the KV cache is **paged**
(``repro_torch.kvcache``): short requests hold only the pages they wrote,
and pages that fill up go cold and live entropy-coded, decoded where a
step reads them by the page-decode kernel (``csrc/kv_page_decode.cu``).

The demo queues a mixed-length request stream through a small batch of
qwen3-8b's smoke stack, proves the paged + compressed path emits the exact
tokens of the monolithic baseline, and prints raw-vs-compressed cache bytes
and throughput (the ``KVCacheMonitor`` summary).  The stack's heads are
64 wide, the narrowest the flash kernel takes (the reference's example
keeps the smoke stack's 16).

Usage:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

On the CPU the kernels' plain PyTorch versions run.  Exits 1 when the
token streams differ.
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get, smoke_variant
from repro_torch.core.store import compress_tree
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.runtime.monitor import KVCacheMonitor
from repro_torch.serving import EngineConfig, GenerationEngine, Request

MAX_BATCH, MAX_LEN, PAGE = 4, 96, 16


def make_requests(vocab_size: int, seed: int = 0):
    """A mixed-length stream: chatty short prompts next to long ones (the
    reference example's draws, numpy seed 0)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(10):
        plen = int(rng.integers(2, 40))
        new = int(rng.integers(4, 40))
        prompt = rng.integers(0, vocab_size, size=plen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=new))
    return reqs


def serve_stream(params, cfg, reqs, dev, **cache_kw):
    """``reqs`` through one engine on ``dev`` -> (token lists, engine,
    monitor, tokens, host seconds)."""
    mon = KVCacheMonitor()
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=MAX_BATCH, max_len=MAX_LEN, kv_monitor=mon, **cache_kw),
        device=dev)
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in reqs)
    return [r.out_tokens for r in reqs], eng, mon, n_tok, dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine serves (the card by default)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = dataclasses.replace(smoke_variant(get("qwen3-8b")), head_dim=64)
    params = M.init_params(cfg, 0, device=dev)
    # the paper's weight story rides along: fp8 weights, entropy-coded,
    # decoded on use inside the step (both streams serve them)
    params_c, rep = compress_tree(params, fmt="tpu", min_elems=4096,
                                  out_dtype="float32")
    print(f"== {cfg.name} on {dev}: ECF8 weights "
          f"{rep['fp8_bytes'] / 1e6:.2f}MB fp8 -> "
          f"{rep['compressed_bytes'] / 1e6:.2f}MB | "
          f"{len(make_requests(cfg.vocab_size))} mixed-length requests, "
          f"batch {MAX_BATCH}, window {MAX_LEN}, page {PAGE}")

    base, _, _, _, _ = serve_stream(params_c, cfg,
                                    make_requests(cfg.vocab_size), dev,
                                    cache_mode="monolithic")
    toks, eng, mon, n_tok, dt = serve_stream(
        params_c, cfg, make_requests(cfg.vocab_size), dev,
        cache_mode="paged", page_size=PAGE, compress_cold=True)

    lossless = toks == base
    print(f"paged+compressed vs monolithic tokens: "
          f"{'IDENTICAL' if lossless else 'MISMATCH'}")

    s = mon.summary()
    print(f"{n_tok} tokens in {dt:.1f}s ({n_tok / max(dt, 1e-9):.1f} tok/s "
          f"host wall-clock, {eng.steps} decode steps, occupancy "
          f"{n_tok / max(eng.steps, 1):.2f})")
    print(f"cache bytes: monolithic {s['monolithic_bytes'] / 1e6:.3f}MB | "
          f"paged peak {s['peak_paged_bytes'] / 1e6:.3f}MB "
          f"({100 * (1 - s['paged_vs_monolithic']):.1f}% saved) | "
          f"peak pages in use {s['peak_pages_in_use']}")
    print(f"cold pages: raw-equivalent peak "
          f"{s['peak_raw_equiv_bytes'] / 1e6:.3f}MB, entropy-coded at "
          f"{s['cold_compression_ratio']:.3f}x raw bytes")
    if not lossless:
        raise SystemExit(1)
    return dict(tokens=toks, n_tokens=n_tok, seconds=dt, summary=s)


if __name__ == "__main__":
    main()
