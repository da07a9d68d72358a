"""Batched serving entry point: the paper's RQ2 experiment shape, on the card.

Synthesizes weights from ``--seed`` (no checkpoint is read), casts the
large ones to fp8 (the baseline the paper compresses), compresses them to
ECF8 (``--compress tpu``, the Huffman container, or ``fixedrate``,
ECF8-FR's 2-bit codes with escapes), and serves a batch of requests
through the continuous-batching engine; ``--check-lossless`` replays the
prompts on the fp8 baseline and exits 1 unless every greedy token is
identical.

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
  # cross-request prefix sharing over a 256-token shared system prompt,
  # with a Chrome trace of the run and a stats line every 16 steps
  PYTHONPATH=src python -m repro_torch.launch.serve --prefill-chunk 128 \\
      --prefix-sharing --shared-prefix 256 --trace-out trace.json \\
      --metrics-interval 16
  # the mixture-of-experts model (64 experts top-6, 2 shared), its weight
  # trees built a layer at a time
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --check-lossless
  # weights in ECF8-FR (decoded by plain PyTorch on the card)
  PYTHONPATH=src python -m repro_torch.launch.serve --compress fixedrate \
      --check-lossless
  # llama4-scout's stack: three local layers, then a global one without
  # RoPE ('nope'), 16 experts top-1 + a shared expert
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --check-lossless
  # the recurrent families (RG-LRU + local attention; sLSTM + mLSTM): no
  # layer pages, so the cache resolves to the monolithic one
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-2b --check-lossless
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
      --check-lossless
  # on a mesh of ranks, one process a card (NCCL): the paged cache split
  # over the data axis (2 or 4 batch shards), a model axis splitting the
  # decode step's pages and the prefill's query rows; --max-batch must
  # divide by D.  Started alone it spawns D x M ranks; under torchrun it
  # joins the group torchrun set up
  PYTHONPATH=src python -m repro_torch.launch.serve --mesh 4 \
      --max-batch 8 --cache paged-compressed --swap-bytes -1
  PYTHONPATH=src python -m repro_torch.launch.serve --mesh 2x2
  # the mixture-of-experts stacks on a mesh: a model axis splits the
  # experts (each rank builds and holds its share), the MoE layers
  # exchange rows over it; the recurrent stacks on the monolithic cache
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      moonshot-v1-16b-a3b --mesh 1x4 --max-batch 8 --check-lossless
  # on a machine without a card, at smoke size (a mesh as gloo ranks):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --mesh 2x2 --compress tpu --cache paged-compressed --swap-bytes -1 \
      --check-lossless
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      moonshot-v1-16b-a3b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      moonshot-v1-16b-a3b --smoke --device cpu --mesh 2x2 --check-lossless
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      recurrentgemma-2b --smoke --device cpu --mesh 2 --check-lossless
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      recurrentgemma-2b --smoke --device cpu --check-lossless
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --compress fixedrate --check-lossless
  PYTHONPATH=src python -m repro_torch.launch.serve --arch \
      llama4-scout-17b-a16e --smoke --device cpu --check-lossless

The helpers below are the same steps for a caller that brings its own
``ArchConfig`` or prompts (``chip_smoke.py`` serves a depth-cut qwen3-8b).
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ..configs import get, smoke_variant
from ..core.store import build_trees
from ..device import resolve
from ..models import model as M
from ..runtime.sharding import MeshShape, expert_cut, expert_rows
from ..runtime.trace_export import export_chrome_trace
from ..runtime.tracing import TorchProfilerHook
from ..serving import EngineConfig, EngineConfigError, GenerationEngine, \
    Request
from ..serving.telemetry import Telemetry, serving_report_line
from . import mesh as MESH

# the reference's leaf-selection threshold for serving (launch/serve.py)
MIN_ELEMS = 4096


def build_params(cfg, seed: int, fmt: str = "tpu", device="cuda",
                 baseline: bool = True, mesh=None):
    """Synthesize weights and prepare both trees a serve run uses.

    Returns ``(served, baseline, report, encode_seconds)``: ``baseline`` is
    the fp8 cast of the large weights (None unless ``baseline``),
    ``served`` their ECF8 compression (``fmt="tpu"`` or ``"fixedrate"``)
    or the baseline itself (``fmt="none"``).  The trees are streamed from
    the draws of ``models.model.init_params`` one layer at a time
    (``core.store.build_trees``): no f32 master of a stacked leaf is ever
    whole, and the weights are those of ``init_params(cfg, seed)``.  On a
    ``mesh`` with a model axis each expert leaf keeps this rank's experts
    (``runtime.sharding.expert_cut``), its own container a layer, and the
    report counts this rank's bytes."""
    t0 = time.perf_counter()
    place = (None if mesh is None else
             lambda path, shape: expert_cut(path, shape, mesh))
    served, base, report = build_trees(
        lambda leaf: M.init_params(cfg, seed, device=device, leaf=leaf),
        fmt=fmt, min_elems=MIN_ELEMS, out_dtype=cfg.dtype,
        baseline=baseline or fmt == "none", place=place)
    if fmt == "none":
        served = base
    if resolve(device).type == "cuda":
        torch.cuda.synchronize()
    return served, base, report, time.perf_counter() - t0


def make_prompts(cfg, n: int, seed: int, lo: int = 4, hi: int = 12,
                 shared_prefix: int = 0):
    """``n`` prompts of ``lo <= len < hi`` tokens drawn from ``seed``, each
    after the same ``shared_prefix``-token system prompt (drawn first, as
    the reference's ``--shared-prefix`` draws it)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, size=shared_prefix).tolist()
    return [system + rng.integers(0, cfg.vocab_size,
                                  size=rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def serve(params, cfg, ecfg: EngineConfig, prompts, max_new: int,
          device="cuda", on_step=None):
    """Serve ``prompts`` greedily -> (finished requests, engine, seconds);
    ``on_step`` is ``GenerationEngine.run``'s.  On a mesh (``ecfg.mesh``)
    every rank calls it with the same arguments."""
    eng = GenerationEngine(params, cfg, config=ecfg, device=device)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run(on_step=on_step)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, eng, time.perf_counter() - t0


def mesh_report(eng) -> str:
    """The mesh line of a run: its axes, the batch shards and each one's
    pages and cold slots, then each rank's resident weights (and, for a
    mixture-of-experts stack, the experts it holds)."""
    pc = eng.paged
    layout = ("monolithic cache, replicated" if pc is None else
              f"{pc.pages_per_shard} pages a shard, {pc.cold_per_shard} "
              f"cold slots a shard")
    ranks = []
    for r, (exp_b, other_b) in enumerate(eng.resident_bytes):
        line = f"rank {r}: "
        if eng.cfg.n_experts:
            coords = MeshShape(("data", "model"), (eng.config.n_shards(),
                                                   eng.n_model),
                               (r // eng.n_model, r % eng.n_model))
            lo, hi = expert_rows(eng.cfg.n_experts, coords)
            line += (f"experts [{lo}, {hi}) {exp_b / 2 ** 30:.3f} GiB + "
                     f"the rest {other_b / 2 ** 30:.3f} GiB = ")
        ranks.append(f"{line}{(exp_b + other_b) / 2 ** 30:.3f} GiB")
    return (f"mesh {{data: {eng.config.n_shards()}, model: {eng.n_model}}},"
            f" n_shards {eng.config.n_shards()}, {layout}; resident "
            f"weights {'; '.join(ranks)}")


def cache_report(eng) -> list:
    """Lines on the cache of a finished run: the per-slot state beside the
    KV rows or pages (recurrent states and local rings, where the stack has
    them), then the coded tiers: pages compressed, their ragged coded bytes
    and the bytes they take in cold slots against the same pages raw, the
    cold pool's device memory, host seconds in the page encoder,
    preemptions and swap traffic (none for the monolithic cache)."""
    pc = eng.paged
    lines = []
    held = {"recurrent": 0, "local": 0}
    for section, key, kind in M.cache_groups(eng.cfg):
        if kind in M.REC_KINDS or kind == "local":
            held["local" if kind == "local" else "recurrent"] += sum(
                x.numel() * x.element_size()
                for x in eng.cache[section][key].values())
    if any(held.values()):
        # the slots this rank holds: a monolithic cache split over the data
        # groups holds its group's rows alone
        n_slots = eng.cache["cur_len"].shape[0]
        lines.append(
            f"per-slot state ({n_slots} slots, {eng.cache_mode} "
            f"cache): recurrent states {held['recurrent'] / 1e6:.3f} MB, "
            f"local rings {held['local'] / 1e6:.3f} MB")
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
            f"({vs_raw(n * slot_b, raw)}); {pc.cold_rows} cold slots "
            f"allocate {pc.cold_rows * slot_b / 1e6:.2f} MB on the device "
            f"({vs_raw(slot_b, page_b)} a page); encode_page "
            f"{pc.encode_seconds:.2f}s on the host")
    if pc.swap is not None:
        st = pc.swap.stats()
        mon = eng.kv_monitor.summary() if eng.kv_monitor is not None else {}
        peak = (f"peak host-resident {mon['peak_swap_bytes'] / 1e6:.3f} MB, "
                if "peak_swap_bytes" in mon else "")
        lines.append(
            f"swap tier: {peak}{eng.scheduler.n_preempted} preemptions, "
            f"{eng.scheduler.n_resumed} resumes, {st['n_swap_out']} pages "
            f"out ({st['swap_out_bytes_total'] / 1e6:.2f} MB), "
            f"{st['n_swap_in']} in ({st['swap_in_bytes_total'] / 1e6:.2f} "
            f"MB), {pc.n_fault_decodes} fault decodes")
    return lines


def kv_report(eng, cache_name: str) -> str | None:
    """The kv-cache line of a finished paged run with a monitor: peak paged
    bytes against the monolithic cache, the cold-page compression ratio."""
    mon = eng.kv_monitor
    if eng.cache_mode != "paged" or mon is None or not mon.n_samples:
        return None
    s = mon.summary()
    ratio = s["cold_compression_ratio"]
    cold = (f"cold-page compression {ratio:.3f}x raw"
            if ratio == ratio else "no page went cold")
    line = (f"kv-cache ({cache_name}, page={eng.paged.page_size}): peak "
            f"{s['peak_paged_bytes'] / 1e6:.3f}MB vs monolithic "
            f"{s['monolithic_bytes'] / 1e6:.3f}MB "
            f"({100 * (1 - s['paged_vs_monolithic']):.1f}% saved), {cold}")
    if eng.paged.n_shards > 1:
        line += (f"\n[serve] pages-per-shard peak {mon.peak_per_shard()} "
                 f"(free now {eng.paged.free_pages_per_shard})")
    return line


def prefix_report(eng) -> str:
    """The prefix-sharing line of a finished run: hits and misses from the
    telemetry registry (as the reference reads them), the index's blocks,
    retirements to swap and copy-on-write splits."""
    sp = eng.paged.stats()
    reg = eng.tel.registry if eng.tel is not None else None
    hits = int(reg.value("prefix_hit_total")) if reg is not None else 0
    miss = int(reg.value("prefix_miss_total")) if reg is not None else 0
    return (f"prefix sharing: {hits} hits / {miss} misses, index "
            f"{sp['prefix_index_blocks']} blocks "
            f"({sp['prefix_resident_blocks']} resident), "
            f"{sp['prefix_retired_total']} retired to swap, "
            f"{sp['prefix_cow_splits_total']} CoW splits")


def latency_report(registry) -> str | None:
    """TTFT and request-latency percentiles from the registry."""
    ttft = registry.get("serving_ttft_seconds")
    lat = registry.get("serving_request_latency_seconds")
    if ttft is None or not ttft.count:
        return None
    return (f"ttft p50/p95/p99 {ttft.percentile(0.5) * 1e3:.0f}/"
            f"{ttft.percentile(0.95) * 1e3:.0f}/"
            f"{ttft.percentile(0.99) * 1e3:.0f}ms, request latency p50 "
            f"{lat.percentile(0.5):.2f}s p99 {lat.percentile(0.99):.2f}s")


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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--compress", default="tpu",
                    choices=["none", "tpu", "fixedrate"])
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
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="cross-request prefix sharing: requests with a "
                         "common page-aligned prompt prefix reference one "
                         "physical copy of its KV pages (copy-on-write) "
                         "and skip recomputing the matched positions.  "
                         "Needs --prefill-chunk.")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                         "request (chat-style workload; makes "
                         "--prefix-sharing hits visible in the report)")
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
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Chrome-trace/Perfetto JSON of the run "
                         "(per-request lifecycle spans, engine-phase spans, "
                         "counter tracks; open in ui.perfetto.dev)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    metavar="STEPS",
                    help="print a one-line stats report every N engine "
                         "steps (tokens, queue depth, step/TTFT "
                         "percentiles)")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (host and card) "
                         "into DIR over the --profile-steps window")
    ap.add_argument("--profile-steps", default="0:1", metavar="A:B",
                    help="engine-step window for --torch-profile "
                         "(default 0:1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "PyTorch versions")
    ap.add_argument("--mesh", default=None, metavar="D[xM]",
                    help="serve on a (data=D[, model=M]) mesh of D x M "
                         "ranks, e.g. '2' or '2x2': one process a card "
                         "over NCCL (D x M cards must be visible), gloo "
                         "ranks with --device cpu.  --max-batch must be "
                         "divisible by D or the engine falls back to the "
                         "monolithic cache.  Spawns the ranks, or joins "
                         "the group when started under torchrun.")
    return ap


def _configs(ap, args, cfg, mesh=None):
    """(model config, draft config, EngineConfig) of the CLI's arguments,
    resolved strictly (an incompatible request exits with the reason)."""
    if cfg is None:
        cfg = get(args.arch)
        if args.smoke:
            cfg = smoke_variant(cfg)
    dcfg = None
    if args.draft:
        dcfg = smoke_variant(get(args.draft)) if args.smoke \
            else get(args.draft)
    try:
        ecfg = EngineConfig.from_args(args, cfg, draft_cfg=dcfg, mesh=mesh)
    except EngineConfigError as e:
        ap.error(str(e))
    return cfg, dcfg, ecfg


def main(argv=None, cfg=None):
    """CLI entry point; ``cfg`` overrides ``--arch``/``--smoke``.  With
    ``--mesh`` the ranks are spawned here (or joined under torchrun) and
    each serves the same requests; rank 0 prints the report.  Returns the
    finished requests (rank 0's); exits 1 when ``--check-lossless`` finds
    a token that differs from the fp8 baseline's."""
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.mesh:
        done, same = _serve_cli(ap, args, cfg, args.device)
    else:
        try:
            data, model = MESH.parse_mesh(args.mesh)
        except ValueError as e:
            raise SystemExit(str(e))
        n = data * model
        if torch.device(args.device).type == "cuda":
            visible = torch.cuda.device_count()
            if n > visible:
                raise SystemExit(
                    f"--mesh {args.mesh} needs {n} devices, {visible} "
                    f"visible (one rank a card; --device cpu runs the "
                    f"ranks on the CPU)")
        # the configs are checked here, before any rank starts
        _configs(ap, args, cfg, MeshShape(MESH.AXES, (data, model)))
        argv = sys.argv[1:] if argv is None else list(argv)
        if MESH.under_torchrun():
            done, same = MESH.join(_serve_rank, argv, cfg, data, model,
                                   device=args.device)
        else:
            done, same = MESH.spawn(_serve_rank, n, argv, cfg, data, model,
                                    device=args.device)[0]
    if same is False:
        raise SystemExit(1)
    return done


def _serve_rank(rank, world, device, argv, cfg, data, model):
    """One rank of ``main --mesh``: the CLI's run on this rank's device
    with the mesh -> (finished requests, the lossless verdict or None)."""
    backend = torch.distributed.get_backend()
    mesh = MESH.make_mesh(data, model,
                          "cuda" if backend == "nccl" else "cpu")
    ap = _parser()
    return _serve_cli(ap, ap.parse_args(argv), cfg, device, mesh, rank)


def _serve_cli(ap, args, cfg, device, mesh=None, rank: int = 0):
    """The CLI's serve run on ``device`` (with a mesh, this rank's share;
    only rank 0 prints) -> (finished requests, the lossless verdict or
    None without a check)."""
    def write(line):
        if rank == 0:
            print(line, flush=True)

    cfg, dcfg, ecfg = _configs(ap, args, cfg, mesh)
    params_c, params_fp8, report, enc_s = build_params(
        cfg, args.seed, args.compress, device=device, mesh=mesh)
    if report is not None:
        fp8_b = max(report["fp8_bytes"], 1)
        write(f"[serve] ECF8({args.compress}) encode {enc_s:.1f}s: "
              f"{report['n_compressed']} tensors, fp8 {fp8_b / 1e6:.2f}MB ->"
              f" {report['compressed_bytes'] / 1e6:.2f}MB "
              f"({100 * (1 - report['compressed_bytes'] / fp8_b):.1f}% "
              f"saved)")
    ecfg_fp8 = ecfg
    if dcfg is not None:
        draft_seed = 1 if args.draft_seed is None else args.draft_seed
        dparams_c, dparams_fp8, _, _ = build_params(
            dcfg, draft_seed, args.compress, device=device)
        ecfg = replace(ecfg, draft_params=dparams_c)
        ecfg_fp8 = replace(ecfg, draft_params=dparams_fp8)
        write(f"[serve] speculative: draft {dcfg.name} ({dcfg.n_layers} "
              f"layers, seed {draft_seed}), k={ecfg.spec_k}")
    prompts = make_prompts(cfg, args.requests, args.seed,
                           shared_prefix=args.shared_prefix)
    profiler = None
    if args.torch_profile:
        try:
            a, b = (int(x) for x in args.profile_steps.split(":"))
        except ValueError:
            raise SystemExit(f"--profile-steps {args.profile_steps!r}: "
                             f"expected 'A:B' (engine-step window)")
        profiler = TorchProfilerHook(args.torch_profile, a, b)
    # the engine's KV-cache monitor publishes into this registry too
    tel = Telemetry(trace=args.trace_out is not None)

    def on_step(i):
        if profiler is not None:
            profiler.on_step(i)
        if args.metrics_interval and (i + 1) % args.metrics_interval == 0:
            write(f"[serve] step {i + 1}: "
                  f"{serving_report_line(tel.registry)}")

    done, eng, dt = serve(params_c, cfg,
                          replace(ecfg, telemetry=tel),
                          prompts, args.max_new, device=device,
                          on_step=on_step)
    if profiler is not None:
        profiler.close()
        write(f"[serve] torch.profiler trace in {profiler.trace_path}")
    if args.trace_out:
        trace = export_chrome_trace(tel.tracer, args.trace_out,
                                    registry=tel.registry)
        write(f"[serve] wrote {args.trace_out}: "
              f"{len(trace['traceEvents'])} trace events "
              f"({tel.tracer.n_dropped} dropped) — open in "
              f"ui.perfetto.dev")
    n_tok = sum(len(r.out_tokens) for r in done)
    write(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s host wall-clock, "
          f"{eng.steps} decode steps, batch occupancy "
          f"{n_tok / max(eng.steps, 1):.2f})")
    if eng.spec_on:
        write(f"[serve] {spec_report(eng, n_tok)}")
    for line in (latency_report(tel.registry), kv_report(eng, args.cache)):
        if line is not None:
            write(f"[serve] {line}")
    for line in cache_report(eng):
        write(f"[serve] {line}")
    if eng.mesh is not None:
        write(f"[serve] {mesh_report(eng)}")
    if eng.prefill_chunk:
        write(f"[serve] {chunk_report(eng)}")
    if eng.prefix_sharing:
        write(f"[serve] {prefix_report(eng)}")
    if args.check_lossless and args.compress != "none":
        done2, _, _ = serve(params_fp8, cfg, ecfg_fp8, prompts, args.max_new,
                            device=device)
        same = same_tokens(done, done2)
        write(f"[serve] lossless check vs fp8 baseline: "
              f"{'IDENTICAL' if same else 'MISMATCH'}")
        return done, same
    return done, None


if __name__ == "__main__":
    main()
