"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_collectives.py``).

Each function runs in a process of its own, started by
``repro_torch.launch.mesh.spawn`` as one gloo rank on the CPU, and returns
plain values (lists, numpy arrays) to the test process, which holds them
against the reference.  This module imports no JAX: the ranks run the port
alone, on weights the test converted from the reference's.
"""
import torch

from repro_torch import convert
from repro_torch.configs import get, smoke_variant
from repro_torch.core import store
from repro_torch.kvcache import PagedKVCache
from repro_torch.kvcache import kernels as kv_kernels
from repro_torch.kvcache import paged as paged_kv
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as SH
from repro_torch.serving import EngineConfig, GenerationEngine, Request
from repro_torch.serving.engine import splice_fragment

# tests/test_kvcache.py:262's requests, tests/test_serving.py:181's
# oversubscribed workload
PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [5, 6, 7], [9, 10] * 4,
           [11, 12, 13], [2] * 7, [40, 41]]
NEWS = [18, 12, 10, 8, 9, 6]
OVERSUB = ([[i + 1] * (7 + 3 * (i % 3)) for i in range(6)],
           [14, 10, 16, 9, 12, 11], [0, 1, 0, 2, 1, 0])


# speculative decoding with the seed-1 weights drafting for the seed-0 ones
SPEC_KW = dict(max_batch=4, max_len=64, page_size=16, spec_k=2)


def smoke(arch):
    return smoke_variant(get(arch))


def serve_tokens(params, cfg, config, stream):
    """Serve ``stream`` (a list of (prompt, max_new, priority)) -> (tokens,
    engine)."""
    eng = GenerationEngine(params, cfg, config=config, device="cpu")
    reqs = [Request(prompt=list(p), max_new_tokens=n, priority=pr,
                    id=9_000 + i) for i, (p, n, pr) in enumerate(stream)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def engine_state(eng) -> dict:
    """The host state every rank must hold alike after a run."""
    pc = eng.paged
    out = dict(cur_len=eng.cache["cur_len"].tolist(), steps=eng.steps,
               sched=eng.scheduler.counters())
    if pc is not None:
        out.update(free=[list(f) for f in pc._free],
                   cold_free=[list(f) for f in pc._cold_free],
                   page_table=eng.cache["page_table"].tolist(),
                   cold_bytes=dict(pc._cold_bytes), ref=dict(pc._ref))
        if pc.swap is not None:
            out["swap"] = pc.swap.stats()
    return out


def oversub_stream():
    return list(zip(*OVERSUB))


def engine_runs(mesh, params, cfg, g2_params, g2_cfg) -> dict:
    """The engine on ``mesh``: the paged-compressed cache on tests/
    test_kvcache.py:262's requests (qwen3's and gemma2's smoke stacks),
    the oversubscribed workload with and without chunked prefill
    (tests/test_serving.py:495, :548), gemma2's under it too -> {name:
    (tokens, state, preemptions, pages coded cold, chunks, pages faulted
    into another shard)}."""
    stream = [(p, n, 0) for p, n in zip(PROMPTS, NEWS)]
    pc_kw = dict(max_batch=4, max_len=64, page_size=16, compress_cold=True)
    over_kw = dict(max_batch=4, max_len=48, page_size=8, n_pages=8,
                   compress_cold=True, n_cold_slots=2, swap_bytes=1 << 28)
    runs = {"paged_compressed": (params, cfg, pc_kw, stream),
            "paged": (params, cfg, dict(max_batch=4, max_len=64,
                                        page_size=16), stream)}
    if g2_params is not None:
        runs["gemma2"] = (g2_params, g2_cfg, pc_kw, stream)
        runs["oversub"] = (params, cfg, over_kw, oversub_stream())
        runs["chunked"] = (params, cfg, dict(over_kw, prefill_chunk=4),
                           oversub_stream())
        runs["gemma2_oversub"] = (g2_params, g2_cfg, over_kw,
                                  oversub_stream())
    out = {}
    for name, (p, c, kw, st) in runs.items():
        toks, eng = serve_tokens(p, c, EngineConfig(**kw, mesh=mesh), st)
        out[name] = (toks, engine_state(eng), eng.scheduler.n_preempted,
                     eng.paged.n_compressed, eng.n_chunks,
                     eng.paged.n_moved_pages)
    return out


# the slots' prompt lengths and first decode tokens (tests/test_kvcache.py
# :314's two, then two more)
LENS, TOK0 = [11, 6, 9, 14], [17, 29, 5, 40]


def decode_logits(mesh, params, cfg, B: int, steps: int = 12):
    """tests/test_kvcache.py:314 on this rank: ``B`` slots prefilled into a
    paged cache of ``n_shards`` batch shards (cold pages coded after every
    step), ``steps`` decode steps on ``mesh`` -> this rank's logits rows
    of each step (a list of (rows, V) arrays) and whether a page went
    cold."""
    n_data = mesh.mesh.shape[0]
    max_len, ps = 32, 8
    pkv = PagedKVCache(cfg, B, max_len, dtype=torch.float32, device="cpu",
                       page_size=ps, compress_cold=True, n_shards=n_data,
                       shard=mesh.get_local_rank("data"))
    cache = pkv.init_cache()
    lens = LENS[:B]
    for slot, T in enumerate(lens):
        toks = torch.arange(1, T + 1)[None] + 3 * slot
        frag = None
        if pkv.holds(slot):
            _, frag = M.prefill(params, cfg, toks, max_len=max_len)
        cache = pkv.admit(cache, slot, frag, T)
    tok = torch.tensor(TOK0[:B])[:, None]
    out = []
    for _ in range(steps):
        for slot in range(B):
            cache = pkv.ensure(cache, slot, lens[slot])
        step_cache = cache if pkv.has_cold else paged_kv.without_cold(cache)
        logits, _ = M.decode_step(params, cfg, tok, step_cache, mesh=mesh)
        cache["cur_len"] = step_cache["cur_len"]
        out.append(logits[:, 0].numpy().copy())
        for slot in range(B):
            lens[slot] += 1
            cache = pkv.compress_cold_pages(cache, slot, lens[slot])
        tok = (tok + 7) % cfg.vocab_size
    return out, bool(pkv._cold_bytes)


def one_device_logits(params, cfg, slots, steps: int = 12):
    """The same steps of ``slots`` (global slot indices) on a one-device
    monolithic cache of those slots alone -> (len(slots), V) each."""
    max_len = 32
    cache = M.init_cache(cfg, len(slots), max_len, torch.float32, "cpu",
                         per_slot=True)
    for row, slot in enumerate(slots):
        toks = torch.arange(1, LENS[slot] + 1)[None] + 3 * slot
        _, frag = M.prefill(params, cfg, toks, max_len=max_len)
        cache = splice_fragment(cache, frag, row)
    tok = torch.tensor([TOK0[s] for s in slots])[:, None]
    out = []
    for _ in range(steps):
        logits, cache = M.decode_step(params, cfg, tok, cache)
        out.append(logits[:, 0].numpy().copy())
        tok = (tok + 7) % cfg.vocab_size
    return out


def prefill_rows(mesh, params, cfg):
    """``prefill`` on ``mesh`` at T = 10 and T = 9 (divisible and not by a
    model axis of 2) -> {T: (last logits, layer 0's K)}."""
    out = {}
    for T in (10, 9):
        toks = torch.arange(3, 3 + T)[None]
        logits, cache = M.prefill(params, cfg, toks, max_len=16, mesh=mesh)
        out[T] = (logits.numpy().copy(),
                  cache["units"]["pos0"]["k"][0].numpy().copy())
    return out


def shared_timeline_decode(mesh, params, cfg, steps: int = 6):
    """A prefill's contiguous cache (one shared timeline) decoded on a model
    axis, each rank holding its sequence slice of every K/V
    (``runtime.sharding.cache_pspecs`` / ``local_shard``) -> each step's
    logits; and the same steps on the whole cache without a mesh."""
    from repro_torch.runtime import sharding as SH

    def shard(tree, specs):
        if isinstance(tree, dict):
            return {k: shard(v, specs[k]) for k, v in tree.items()}
        return SH.local_shard(tree, specs, mesh)

    toks = torch.arange(3, 11)[None].repeat(2, 1)
    out = []
    for use_mesh in (True, False):
        _, cache = M.prefill(params, cfg, toks, max_len=16)
        if use_mesh:
            cache = shard(cache, SH.cache_pspecs(cfg, cache, mesh))
            # a rank's row cannot tell by its shape that it was cut
            cache["max_len"] = torch.tensor(16)
        tok = torch.tensor([[5], [9]])
        got = []
        for _ in range(steps):
            logits, cache = M.decode_step(params, cfg, tok, cache,
                                          mesh=mesh if use_mesh else None)
            got.append(logits[:, 0].numpy().copy())
            tok = (tok + 3) % cfg.vocab_size
        out.append(got)
    return out


def pages_sharded(mesh, pages):
    """``decode_pages_sharded`` of this rank's rows of ``pages`` (the four
    container arrays of a whole cold pool, numpy) -> the gathered rows."""
    n = pages[0].shape[0]
    world = mesh.mesh.shape[0]
    d = mesh.get_local_rank("data")
    per = n // world
    mine = [torch.from_numpy(a[d * per:(d + 1) * per].copy()) for a in pages]
    got = kv_kernels.decode_pages_sharded(*mine, mesh, n_elem=2048,
                                          dtype_name="bfloat16")
    rows = collectives.gather_rows(got.view(torch.uint8), mesh, "data")
    return rows.reshape(n, -1).numpy()


def world_main(rank, world, device, spec):
    """Everything a test module needs from ``world`` ranks, in one spawn."""
    torch.manual_seed(0)
    cfg = smoke("qwen3-8b")
    params = convert.params_from_numpy(spec["params"], cfg, "cpu")
    g2_cfg = smoke("gemma2-9b")
    g2 = (convert.params_from_numpy(spec["g2_params"], g2_cfg, "cpu")
          if spec.get("g2_params") is not None else None)
    out = {}
    data = MESH.make_mesh(world, 1)
    out["weights_checksum"] = collectives.tree_checksum(params)
    out["engine"] = engine_runs(data, params, cfg, g2, g2_cfg)
    if spec.get("compressed"):
        pc, _ = store.compress_tree(params, min_elems=4096,
                                    out_dtype="float32")
        toks, eng = serve_tokens(pc, cfg, EngineConfig(
            max_batch=4, max_len=64, page_size=16, compress_cold=True,
            mesh=data), [(p, n, 0) for p, n in zip(PROMPTS, NEWS)])
        out["ecf8"] = toks
    model = MESH.make_mesh(world // 2, 2)
    out["model_axis"] = engine_runs(model, params, cfg, None, None)
    if world != 2:
        return out
    # tests/test_kvcache.py:314 / :363 at two slots: one a rank
    p1 = convert.params_from_numpy(spec["params1"], cfg, "cpu")
    out["spec"] = serve_tokens(params, cfg, EngineConfig(
        **SPEC_KW, draft_cfg=cfg, draft_params=p1, mesh=data),
        [(p, n, 0) for p, n in zip(PROMPTS, NEWS)])[0]
    out["logits_data"] = {B: decode_logits(data, p1, cfg, B) for B in (2, 4)}
    out["logits_model"] = decode_logits(model, p1, cfg, 2)
    out["prefill_model"] = prefill_rows(model, p1, cfg)
    out["shared_decode"] = shared_timeline_decode(model, p1, cfg)
    out["pages_sharded"] = pages_sharded(data, spec["pages"])
    if rank == 0:
        out["one_device_logits"] = {
            slots: one_device_logits(p1, cfg, list(slots))
            for slots in ((0, 1), (0, 1, 2, 3), (0,), (1,), (2, 3))}
        out["one_device_prefill"] = prefill_rows(None, p1, cfg)
    return out


def gather_main(rank, world, device, spec):
    """``compressed_all_gather`` of ``spec["bits"]`` (uint8, numpy) over the
    ranks' data axis, each rank encoding its rows with ``spec["table"]`` and
    the capacity ``spec["cap"]`` -> (the gathered bits, the overflow flag,
    this rank's (codes, packed escapes, packed sign/mantissa))."""
    from repro_torch.core import fixedrate, fp8
    mesh = MESH.make_mesh(world, 1)
    bits = torch.from_numpy(spec["bits"])
    rows = bits.shape[0] // world
    local = bits[rank * rows:(rank + 1) * rows].contiguous()
    table = torch.from_numpy(spec["table"])
    out = {}
    for name, cap in spec["caps"].items():
        full, over = collectives.compressed_all_gather(mesh, "data")(
            local, table, cap)
        codes, esc, sm, _ = fixedrate.encode_plain(local.reshape(-1), table,
                                                   cap)
        out[name] = (full.numpy(), over,
                     (codes.numpy(), fp8.pack_nibbles(esc).numpy(),
                      fp8.pack_nibbles(sm).numpy()))
    return out


# -- the mixture-of-experts and recurrent stacks on a mesh ------------------
# (tests/test_torch_moe_mesh.py)

MOE_ENGINE_KW = dict(max_batch=4, max_len=64, page_size=16)
# PROMPTS with fewer new tokens (request 0 still fills a page: it goes
# cold with compress_cold)
MOE_NEWS = [12, 8, 6, 6, 5, 4]


def _placed_layer(tree, mesh, names=("moe",)):
    """A bare MoE layer's numpy leaves -> tensors, each expert leaf cut to
    this rank's experts (``runtime.sharding.expert_cut`` at the layer's
    path under ``moe``)."""
    from repro_torch.runtime.sharding import expert_cut
    if isinstance(tree, dict):
        return {k: _placed_layer(v, mesh, names + (k,))
                for k, v in tree.items()}
    x = torch.from_numpy(tree.copy())
    cut = expert_cut(names, x.shape, mesh)
    return x if cut is None else x.narrow(cut[0], cut[1], cut[2] - cut[1])


def moe_layer_outputs(mesh, layers, x, cfg):
    """``moe_apply`` of each layer of ``layers`` (numpy MoE subtrees) on
    ``mesh``, the experts placed: ``rows="all"`` on the whole ``x`` and
    ``rows="shard"`` on this rank's data group's rows of it -> {name:
    (all (B, T, d), shard rows, aux of "all")}."""
    from repro_torch.models import moe
    n_data = mesh.mesh.shape[0]
    d = mesh.get_local_rank("data")
    xt = torch.from_numpy(x)
    b = xt.shape[0] // n_data
    out = {}
    for name, tree in layers.items():
        p = _placed_layer(tree, mesh)
        y_all, aux = moe.moe_apply(p, xt, cfg, mesh=mesh, rows="all",
                                   dtype=torch.float32)
        y_shard, _ = moe.moe_apply(p, xt[d * b:(d + 1) * b], cfg, mesh=mesh,
                                   rows="shard", dtype=torch.float32)
        out[name] = (y_all.numpy(), y_shard.numpy(), float(aux))
    return out


def moe_engine_runs(mesh, runs, cfgs, params) -> dict:
    """The engine on ``mesh`` for each run of ``runs`` (name -> (arch,
    cache kwargs, ECF8 or not)), the weights converted from the
    reference's (``params``: arch -> numpy tree) and placed -> {name:
    (tokens, cache mode, every rank's resident bytes (experts, the rest),
    this rank's weights checksum, the slot rows this rank's cache leaves
    hold: one count a distinct batch dim)}."""
    stream = [(p, n, 0) for p, n in zip(PROMPTS, MOE_NEWS)]
    out = {}
    for name, (arch, kw, ecf8) in runs.items():
        cfg = cfgs[arch]
        tree = convert.params_from_numpy(params[arch], cfg, "cpu", mesh=mesh)
        if ecf8:
            tree, _ = store.compress_tree(tree, min_elems=4096,
                                          out_dtype="float32")
        toks, eng = serve_tokens(tree, cfg, EngineConfig(
            **MOE_ENGINE_KW, **kw, mesh=mesh), stream)
        rows = sorted({leaf.shape[1 if names[0] == "units" else 0]
                       for names, leaf in SH.flatten(eng.cache).items()
                       if leaf.ndim and names[0] in ("units", "tail",
                                                     "cur_len")})
        out[name] = (toks, eng.cache_mode, eng.resident_bytes,
                     list(eng.weights_checksum), rows)
    return out


def moe_world_main(rank, world, device, spec):
    """Everything tests/test_torch_moe_mesh.py needs from ``world`` ranks,
    in one spawn: the MoE layer on each mesh of ``spec["layer_meshes"]``
    (capacity factor 1.0), the engine runs of ``spec["engines"]`` (mesh
    dims -> runs), and on 2x2 a prefill's logits and the replication
    check's refusals."""
    import dataclasses
    torch.manual_seed(0)
    cfgs = {a: smoke(a) for a in spec["params"]}
    meshes = {dims: MESH.make_mesh(*dims)
              for dims in sorted(set(spec["layer_meshes"])
                                 | set(spec["engines"]))}
    out = {"layer": {}, "engine": {}}
    tight = dataclasses.replace(cfgs["moonshot-v1-16b-a3b"],
                                capacity_factor=1.0)
    for dims in spec["layer_meshes"]:
        out["layer"][dims] = moe_layer_outputs(meshes[dims], spec["layers"],
                                               spec["x"], tight)
    for dims, runs in spec["engines"].items():
        out["engine"][dims] = moe_engine_runs(meshes[dims], runs, cfgs,
                                              spec["params"])
    if (2, 2) in meshes:
        mesh = meshes[(2, 2)]
        params = convert.params_from_numpy(
            spec["params"]["moonshot-v1-16b-a3b"], tight, "cpu", mesh=mesh)
        logits, _ = M.prefill(params, tight,
                              torch.from_numpy(spec["prefill_tokens"]),
                              max_len=96, mesh=mesh)
        out["prefill_2x2"] = logits.numpy()
        out["refused"] = refusals(mesh, params, tight)
    return out


def _with_layer(tree, moe):
    """``tree`` with unit 0's MoE leaves replaced by ``moe`` (the rest
    shared, not copied)."""
    units = dict(tree["units"])
    units["pos0"] = {**units["pos0"], "moe": moe}
    return {**tree, "units": units}


def refusals(mesh, params, cfg) -> dict:
    """``check_replicated`` on trees a serving mesh must not hold -> {case:
    the error text each raised, or None}: one rank's experts perturbed
    (rank 2: data 1, model 0), and every rank holding all the experts on
    the model axis."""
    moe = params["units"]["pos0"]["moe"]
    wo = moe["wo"].clone()
    if torch.distributed.get_rank() == 2:
        wo[0, 0, 0, 0] += 1.0
    whole = {k: (torch.cat([v] * mesh.mesh.shape[1], dim=1)
                 if k in ("wi_gate", "wi_up", "wo") else v)
             for k, v in moe.items()}
    out = {}
    for case, tree in (("perturbed", _with_layer(params, {**moe, "wo": wo})),
                       ("unplaced", _with_layer(params, whole))):
        try:
            collectives.check_replicated(tree, mesh, n_experts=cfg.n_experts)
            out[case] = None
        except RuntimeError as e:
            out[case] = str(e)
    return out
