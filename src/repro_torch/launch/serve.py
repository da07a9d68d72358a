"""Batched serving entry point: the paper's RQ2 experiment shape, on the card.

Synthesizes weights from ``--seed`` (no checkpoint is read), casts the
large ones to fp8 (the baseline the paper compresses), compresses them to
ECF8, and serves a batch of requests through the continuous-batching
engine; ``--check-lossless`` replays the prompts on the fp8 baseline and
exits 1 unless every greedy token is identical.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --compress tpu --cache paged --check-lossless
  # full KV pages entropy-coded in place, an undersized raw pool and a host
  # swap tier that preempts whole requests when the pool runs dry
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --cache paged-compressed --n-pages 40 --swap-bytes -1
  # chunked, decode-interleaved prefill: 128-token chunks, one chunk of
  # prompt tokens per engine step
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --prefill-chunk 128 --prefill-budget 128
  # the monolithic cache (one contiguous max_len row a slot)
  PYTHONPATH=src python -m repro_torch.launch.serve --cache monolithic
  # speculative decoding: a draft proposes 4 tokens a round, the target
  # verifies them in one forward
  PYTHONPATH=src python -m repro_torch.launch.serve --draft qwen3-8b \\
      --spec-k 4
  # on a machine without a card, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The helpers below are the same steps for a caller that brings its own
``ArchConfig`` or prompts (``chip_smoke.py`` serves a depth-cut qwen3-8b).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

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


def cache_report(eng) -> list:
    """Lines on the coded tiers of a finished run: pages compressed, their
    ragged coded bytes and the bytes they take in cold slots against the
    same pages raw, the cold pool's device memory, host seconds in the page
    encoder, preemptions and swap traffic (none for the monolithic
    cache)."""
    pc = eng.paged
    lines = []
    if pc is None:
        return lines
    if pc.compress:
        n, coded = pc.n_compressed, pc.compressed_bytes
        page_b, slot_b = pc.stats()["page_bytes"], pc.cold_slot_bytes
        raw = n * page_b

        def vs_raw(b, r):
            return f"{100 * (b / max(r, 1) - 1):+.1f}% vs raw"

        lines.append(
            f"cold pool: {n} pages compressed, {raw / 1e6:.2f} MB raw -> "
            f"{coded / 1e6:.2f} MB coded ({vs_raw(coded, raw)}), "
            f"{n * slot_b / 1e6:.2f} MB in cold slots at the stride budget "
            f"({vs_raw(n * slot_b, raw)}); {pc.n_cold} cold slots allocate "
            f"{pc.n_cold * slot_b / 1e6:.2f} MB on the device "
            f"({vs_raw(slot_b, page_b)} a page); encode_page "
            f"{pc.encode_seconds:.2f}s on the host")
    if pc.swap is not None:
        st = pc.swap.stats()
        lines.append(
            f"swap tier: {eng.scheduler.n_preempted} preemptions, "
            f"{eng.scheduler.n_resumed} resumes, {st['n_swap_out']} pages "
            f"out ({st['swap_out_bytes_total'] / 1e6:.2f} MB), "
            f"{st['n_swap_in']} in ({st['swap_in_bytes_total'] / 1e6:.2f} "
            f"MB), {pc.n_fault_decodes} fault decodes")
    return lines


def chunk_report(eng) -> str:
    """The chunked-prefill line of a finished run."""
    return (f"chunked prefill (chunk={eng.prefill_chunk}, budget="
            f"{eng.prefill_budget}/step): {eng.n_chunks} chunks / "
            f"{eng.n_chunk_tokens} prompt tokens, {eng.n_interleaved_steps} "
            f"interleaved steps, {eng.n_midprefill_preempted} mid-prefill "
            f"preemptions")


def spec_report(eng, n_tok: int) -> str:
    """The speculative-decoding line of a finished run."""
    sc = eng.spec_counters()
    return (f"speculative: {sc['spec_rounds']} verify rounds, accept rate "
            f"{sc['spec_accept_rate']:.3f} ({sc['spec_accepted']}/"
            f"{sc['spec_drafted']} drafted), "
            f"{n_tok / max(eng.steps, 1):.2f} tokens/step")


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
    ap.add_argument("--cache", default="paged",
                    choices=["paged", "paged-compressed", "monolithic"],
                    help="KV-cache layout (paged-compressed entropy-codes "
                         "full pages in place and decodes them where the "
                         "decode step uses them; monolithic keeps one "
                         "contiguous max_len row a slot)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None,
                    help="raw page-pool size (default: worst case).  Set "
                         "it below the worst case to oversubscribe the "
                         "pool; with --swap-bytes the engine then swaps/"
                         "preempts instead of failing with OutOfPages.")
    ap.add_argument("--swap-bytes", type=int, default=0,
                    help="host swap-tier capacity in bytes for entropy-"
                         "coded evicted pages (-1 = unbounded, 0 = "
                         "disabled)")
    ap.add_argument("--preemption", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="allow whole-request preemption (swap out a "
                         "victim, requeue, resume later); needs "
                         "--swap-bytes")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked, decode-interleaved prefill: split each "
                         "prompt into fixed N-token chunks and interleave "
                         "them with decode steps.  0 = whole-prompt "
                         "prefill.  Needs the paged cache and an "
                         "all-attention architecture.")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="prompt tokens spent on prefill per engine step "
                         "(bounds decode latency under long prompts); "
                         "default: one chunk.")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="speculative decoding: the draft model's "
                         "architecture (--smoke applies to it too), "
                         "compressed as --compress says.  It proposes "
                         "--spec-k tokens a round and the target verifies "
                         "all k+1 positions in one forward with exact "
                         "rejection sampling: tokens identical to target-"
                         "only decoding under greedy.  Needs --cache paged/"
                         "paged-compressed and whole-prompt prefill.")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="drafted tokens per speculative round (default 4; "
                         "an error without --draft)")
    ap.add_argument("--draft-seed", type=int, default=None,
                    help="seed of the synthesized draft weights (default "
                         "1; an error without --draft)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
    dcfg = None
    if args.draft:
        dcfg = smoke_variant(get(args.draft)) if args.smoke \
            else get(args.draft)
    try:
        ecfg = EngineConfig.from_args(args, cfg, draft_cfg=dcfg)
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
    ecfg_fp8 = ecfg
    if dcfg is not None:
        draft_seed = 1 if args.draft_seed is None else args.draft_seed
        dparams_c, dparams_fp8, _, _ = build_params(
            dcfg, draft_seed, args.compress, device=args.device)
        ecfg = replace(ecfg, draft_params=dparams_c)
        ecfg_fp8 = replace(ecfg, draft_params=dparams_fp8)
        print(f"[serve] speculative: draft {dcfg.name} ({dcfg.n_layers} "
              f"layers, seed {draft_seed}), k={ecfg.spec_k}")
    prompts = make_prompts(cfg, args.requests, args.seed)
    done, eng, dt = serve(params_c, cfg, ecfg, prompts, args.max_new,
                          device=args.device)
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s host wall-clock, "
          f"{eng.steps} decode steps, batch occupancy "
          f"{n_tok / max(eng.steps, 1):.2f})")
    if eng.spec_on:
        print(f"[serve] {spec_report(eng, n_tok)}")
    for line in cache_report(eng):
        print(f"[serve] {line}")
    if eng.prefill_chunk:
        print(f"[serve] {chunk_report(eng)}")
    if args.check_lossless and args.compress != "none":
        done2, _, _ = serve(params_fp8, cfg, ecfg_fp8, prompts, args.max_new,
                            device=args.device)
        same = same_tokens(done, done2)
        print(f"[serve] lossless check vs fp8 baseline: "
              f"{'IDENTICAL' if same else 'MISMATCH'}")
        if not same:
            raise SystemExit(1)
    return done


if __name__ == "__main__":
    main()
