"""Trace-replay load generator for the async serving front end.

The port's counterpart of the reference's ``benchmarks/load_replay.py``:
replays a **seeded bursty arrival trace** (Poisson background traffic
with a spike window, a long / short prompt mix, three priority classes
and a shared system prompt in half the requests) through
``AsyncServingFrontend`` + ``Router`` over ``GenerationEngine`` replicas
that share one ECF8 weight tree, and reports *streamed* TTFT percentiles
(submit to the first token on the stream), throughput, the shed rate under
the burst and the placements.

Replay is **tick-based**: requests whose arrival tick has come are
submitted, then the front end pumps exactly one ``step()``.  Everything
the front end decides (admission order, replica placement, shedding) is a
function of tick state, so a given ``seed`` reproduces the same
placements and the same shed set, at any model width (the trace's token
ids are drawn below the smoke vocabulary, valid at every width).  The
completed requests' streams are held identical to a synchronous
single-engine run of the same accepted set.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.load_replay   # on the card
  PYTHONPATH=src python -m repro_torch.launch.load_replay --smoke \\
      --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import time

import numpy as np

# the reference's workload shape: one tick = one engine step, and a
# request costs ~8 steps (chunked prefill + decode) on 6 slots, so the
# background rate sits under capacity and the spike overruns it ~3x: the
# bounded admission queue sheds a stable handful inside the burst
N_REQUESTS = 24
SPIKE = (8, 12)          # tick window of the burst
BASE_RATE = 0.3          # requests/tick outside the spike
SPIKE_RATE = 3.0         # requests/tick inside it
SYSTEM_TOKENS = 16       # shared system prompt (page-aligned at chunk 8)


def build_trace(seed: int = 0, n_requests: int = N_REQUESTS,
                vocab: int = 64) -> list[dict]:
    """The seeded arrival trace: a list of request specs sorted by arrival
    tick, the reference's numpy stream draw for draw."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, vocab, size=SYSTEM_TOKENS).tolist()
    trace, tick = [], 0
    while len(trace) < n_requests:
        rate = SPIKE_RATE if SPIKE[0] <= tick < SPIKE[1] else BASE_RATE
        for _ in range(min(rng.poisson(rate), n_requests - len(trace))):
            long = rng.random() < 0.3
            n_prompt = int(rng.integers(20, 29) if long
                           else rng.integers(4, 9))
            prompt = rng.integers(1, vocab, size=n_prompt).tolist()
            if rng.random() < 0.5:          # chat-style shared prefix
                prompt = system + prompt
            trace.append({
                "tick": tick,
                "prompt": prompt,
                "max_new_tokens": int(rng.integers(4, 8)),
                "priority": int(rng.choice([0, 0, 0, 0, 1, 1, 2])),
            })
        tick += 1
    return trace


async def replay(frontend, trace, *, id_base: int = 9_000):
    """Tick-by-tick replay of ``trace`` through ``frontend``; returns
    ``(streams, requests)`` aligned with the trace (a request the full
    queue rejected has stream None)."""
    from ..serving import Request
    from ..serving.async_engine import FrontendOverloaded
    streams, reqs = [], []
    it = iter(enumerate(trace))
    nxt = next(it, None)
    tick = 0
    while True:
        while nxt is not None and nxt[1]["tick"] <= tick:
            i, item = nxt
            req = Request(prompt=item["prompt"],
                          max_new_tokens=item["max_new_tokens"],
                          priority=item["priority"], id=id_base + i)
            reqs.append(req)
            try:
                streams.append(frontend.submit_nowait(req))
            except FrontendOverloaded:
                streams.append(None)
            nxt = next(it, None)
        busy = await frontend.step()
        tick += 1
        if nxt is None and not busy:
            break
    await frontend.drain()
    return streams, reqs


def engine_config():
    """The reference's replica configuration (``load_replay.run``)."""
    from ..serving import EngineConfig
    return EngineConfig(max_batch=3, max_len=64, prefill_chunk=8,
                        prefix_sharing=True)


def run(device="cuda", arch: str = "qwen3-8b", smoke: bool = False,
        layers: int | None = None, seed: int = 0, n_replicas: int = 2,
        params=None) -> dict:
    """Build the replica fleet over one ECF8 tree (``params``, or built
    from ``seed`` at ``arch``'s widths, ``layers`` deep, the smoke variant
    with ``smoke``), replay the trace and return the measurements, with
    the tree, the config and the completed ``(request, stream)`` pairs
    under ``params``, ``cfg`` and ``completed`` for ``check_streams``.

    Raises RuntimeError unless every completed stream equals its request's
    tokens."""
    import torch

    from ..configs import get, smoke_variant
    from ..serving import (AsyncServingFrontend, GenerationEngine, Router,
                           Telemetry)
    from .serve import build_params

    cfg = smoke_variant(get(arch)) if smoke else get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if params is None:
        params, _, _, _ = build_params(cfg, seed, "tpu", device=device,
                                       baseline=False)
    trace = build_trace(seed=seed,
                        vocab=smoke_variant(get(arch)).vocab_size)
    ecfg = engine_config()
    # every replica shares one rng_seed and publishes into one registry
    tel = Telemetry(trace=False)
    router = Router([GenerationEngine(
        params, cfg, config=dataclasses.replace(ecfg, telemetry=tel),
        device=device) for _ in range(n_replicas)], telemetry=tel)
    frontend = AsyncServingFrontend(router, max_pending=6,
                                    shed_policy="reject", telemetry=tel)
    t0 = time.perf_counter()
    streams, reqs = asyncio.run(replay(frontend, trace))
    if router.replicas[0].device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    done = [(r, s) for r, s in zip(reqs, streams) if s is not None]
    shed = [i for i, s in enumerate(streams) if s is None]
    n_tok = sum(len(s.tokens) for _, s in done)
    if not all(r.done and s.tokens == r.out_tokens for r, s in done):
        raise RuntimeError("a completed stream differs from its request's "
                           "tokens")
    ttft = tel.registry.get("frontend_stream_ttft_seconds")
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "device": str(router.replicas[0].device),
        "n_requests": len(trace),
        "n_replicas": n_replicas,
        "n_completed": len(done),
        "n_shed": len(shed),
        "shed": shed,
        "shed_rate": len(shed) / len(trace),
        "n_tokens": n_tok,
        "wall_s": wall_s,
        "tok_per_s": n_tok / max(wall_s, 1e-9),
        "ttft_p50_s": ttft.percentile(0.50),
        "ttft_p95_s": ttft.percentile(0.95),
        "prefix_hits": int(tel.registry.value("prefix_hit_total")),
        "placements": [list(p) for p in router.placements],
        "params": params, "cfg": cfg, "completed": done,
    }


def check_streams(out: dict) -> None:
    """Replay the accepted set of ``run``'s result through one synchronous
    engine (same ids, so the same sampling keys) on the same device.

    Raises RuntimeError unless it emits the front end's streams."""
    from ..serving import GenerationEngine, Request

    eng = GenerationEngine(out["params"], out["cfg"], config=engine_config(),
                           device=out["device"])
    ref = {}
    for r, _ in out["completed"]:
        ref[r.id] = Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                            priority=r.priority, id=r.id)
        eng.submit(ref[r.id])
    eng.run()
    if not all(s.tokens == ref[r.id].out_tokens
               for r, s in out["completed"]):
        raise RuntimeError("async streams diverged from the synchronous "
                           "engine")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the config's)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    out = run(device=args.device, arch=args.arch, smoke=args.smoke,
              layers=args.layers, seed=args.seed, n_replicas=args.replicas)
    check_streams(out)
    print(f"[load-replay] {out['arch']} ({out['n_layers']} layers, "
          f"{out['device']}): {out['n_completed']}/{out['n_requests']} "
          f"requests completed, {out['n_shed']} shed "
          f"({out['shed_rate']:.0%}) on {out['n_replicas']} replicas, "
          f"{out['tok_per_s']:.1f} tok/s streamed, TTFT p50/p95 "
          f"{out['ttft_p50_s'] * 1e3:.0f}/{out['ttft_p95_s'] * 1e3:.0f} ms, "
          f"{out['prefix_hits']} prefix hits; streams identical to the "
          f"synchronous engine")
    print(f"[load-replay] placements (request, replica, reason): "
          f"{json.dumps(out['placements'])}; shed trace indices "
          f"{out['shed']}")


if __name__ == "__main__":
    main()
