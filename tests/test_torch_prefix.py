"""The port's cross-request prefix sharing against the JAX package's: the
refcounted allocator and its prefix index driven through the same seeded
operation sequence on both sides (page tables, reference counts, free lists,
index entries, swap keys and pool bits identical after every operation, the
reference's audit invariants holding on the port), greedy tokens with
sharing on identical to sharing off and to the reference engine's (a chat
workload, a prefix retired to swap and faulted back, a run that preempts),
one physical copy of a shared prefix, a forced copy-on-write split, and the
swap store's unpinned LRU pages.  The workloads are
``tests/test_prefix_sharing.py``'s (f32 smoke model, page size 8)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.kvcache import paged as ref_paged  # noqa: E402
from repro.kvcache import swap as ref_swap  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serving import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving import GenerationEngine as RefEngine  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.kvcache import OutOfPages, paged, swap  # noqa: E402
from repro_torch.serving import EngineConfig, GenerationEngine, \
    Request  # noqa: E402

try:
    from hypothesis import given, strategies as st
except ImportError:          # tier-1 may run without hypothesis
    given = None


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference's swap faults decode through its Pallas page kernel,
    which writes with ``pl.store`` (dropped by newer JAX releases);
    assigning through the ref is the same write."""
    if not hasattr(pl, "store"):
        def store(ref, idx, val):
            ref[idx] = val
        monkeypatch.setattr(pl, "store", store, raising=False)


@pytest.fixture(scope="module")
def raw_weights():
    """The reference's f32 smoke weights and their conversion."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return cfg, ref_cfg, ref_params, params


# --------------------------------------------------------------------------
# the refcounted allocator, operation for operation
# --------------------------------------------------------------------------

_PREFIX_POOL = [tuple(range(1, 10)), tuple(range(1, 18)),
                tuple(range(1, 26)), tuple([5] * 17),
                tuple(range(100, 121))]


def _check_invariants(pkv):
    """tests/test_prefix_sharing.py's audit invariants, on the one shard's
    free list."""
    cap = pkv.shard_capacity(0)
    free = list(pkv._free[0])
    assert len(free) == len(set(free)), "free list has duplicates"
    assert not (set(free) & set(pkv._ref)), "freed page still referenced"
    assert len(free) + len(pkv._ref) == cap, (len(free), len(pkv._ref))
    holders = {}
    for pages in pkv._slot_pages.values():
        for e in pages:
            if 0 < e < pkv.n_pages:
                holders[e] = holders.get(e, 0) + 1
    if pkv.prefix is not None:
        for e in pkv.prefix.entries():
            if e > 0:
                holders[e] = holders.get(e, 0) + 1
    assert holders == pkv._ref, (holders, pkv._ref)


def _pair(cfg, ref_cfg, seed):
    """The port's and the reference's allocator (4 slots of 32 positions,
    10 raw pages, prefix sharing, a 16 MiB swap store) with the same random
    K/V in their pools."""
    ref = ref_paged.PagedKVCache(ref_cfg, 4, 32, dtype=jnp.float32,
                                 page_size=8, n_pages=10)
    ref.enable_prefix_sharing()
    ref.attach_swap(ref_swap.SwapStore(capacity_bytes=1 << 24))
    pkv = paged.PagedKVCache(cfg, 4, 32, dtype=torch.float32, device="cpu",
                             page_size=8, n_pages=10)
    pkv.enable_prefix_sharing()
    pkv.attach_swap(swap.SwapStore(capacity_bytes=1 << 24))
    ref_cache, cache = ref.init_cache(), pkv.init_cache()
    rng = np.random.default_rng(seed + 1000)
    pools = ref_cache["units"]["pos0"]
    for kn in ("k_pool", "v_pool"):
        vals = rng.standard_normal(pools[kn].shape).astype(np.float32)
        ref_cache["units"] = {"pos0": {**ref_cache["units"]["pos0"],
                                       kn: jnp.asarray(vals)}}
        cache["units"]["pos0"][kn].copy_(torch.from_numpy(vals))
    return ref, ref_cache, pkv, cache


def _assert_same_state(ref, ref_cache, pkv, cache):
    assert pkv._free == ref._free
    assert pkv._ref == ref._ref
    assert pkv._slot_pages == ref._slot_pages
    assert list(pkv.prefix._entries.items()) == \
        list(ref.prefix._entries.items())        # entries and LRU order
    assert list(pkv.swap._pages) == list(ref.swap._pages)
    assert list(pkv.swap._unpinned) == list(ref.swap._unpinned)
    assert (pkv.n_cow_splits, pkv.n_prefix_retired, pkv.n_prefix_dropped) \
        == (ref.n_cow_splits, ref.n_prefix_retired, ref.n_prefix_dropped)
    for name in ("page_table", "cur_len"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(ref_cache[name]))
    for kn in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(
            cache["units"]["pos0"][kn].numpy().view(np.uint32),
            np.asarray(ref_cache["units"]["pos0"][kn]).view(np.uint32))
    _check_invariants(pkv)


def _walk(cfg, ref_cfg, seed, with_ref=True):
    """tests/test_prefix_sharing.py's random admit_shared / register / CoW
    / evict / fault / release / reclaim walk on the port's allocator, each
    operation applied to the reference's too (``with_ref``: then the two
    states are compared after every operation), then drained."""
    rng = np.random.default_rng(seed)
    ref, ref_cache, pkv, cache = _pair(cfg, ref_cfg, seed)
    sides = {"port": [pkv, cache]}
    if with_ref:
        sides["ref"] = [ref, ref_cache]
    live = {}

    def pick(xs):
        return xs[int(rng.integers(len(xs)))]

    def apply(method, *args, shard=False):
        """Call ``method`` on every side (the reference's takes a shard
        where ``shard``); returns whether it raised OutOfPages, which the
        sides must agree on."""
        raised = set()
        for name, side in sides.items():
            alloc, c = side
            a = (0,) + args if shard and name == "ref" else args
            try:
                out = getattr(alloc, method)(c, *a)
                side[1] = out[0] if isinstance(out, tuple) else out
                raised.add(False)
            except (OutOfPages, ref_paged.OutOfPages):
                raised.add(True)
        assert len(raised) == 1, (method, args)
        return raised.pop()

    for _ in range(int(rng.integers(8, 25))):
        ops = ["admit", "reclaim"]
        if live:
            ops += ["register", "cow", "evict", "fault", "release"]
        op = pick(ops)
        if op == "admit":
            free_slots = [s for s in range(4) if s not in live]
            if not free_slots:
                continue
            slot = pick(free_slots)
            prompt = list(pick(_PREFIX_POOL))
            if not apply("admit_shared", slot, prompt, 2):
                live[slot] = prompt
        elif op == "register":
            slot = pick(sorted(live))
            n = int(rng.integers(len(live[slot]) + 1))
            for alloc, _ in sides.values():
                alloc.register_prefix(slot, live[slot], n)
        elif op == "cow":
            slot = pick(sorted(live))
            hi = len(pkv._slot_pages[slot]) * pkv.page_size - 1
            apply("make_writable", slot, 0, hi)
        elif op in ("evict", "fault", "release"):
            slot = pick(sorted(live))
            apply(op, slot)
            if op == "release":
                del live[slot]
        else:
            apply("_reclaim_prefix", int(rng.integers(1, 5)), shard=True)
        if with_ref:
            _assert_same_state(ref, sides["ref"][1], pkv, sides["port"][1])
        _check_invariants(pkv)
    for slot in sorted(live):
        apply("release", slot)
    apply("_reclaim_prefix", pkv.n_pages, shard=True)
    if with_ref:
        _assert_same_state(ref, sides["ref"][1], pkv, sides["port"][1])
    _check_invariants(pkv)
    # draining the index returns every raw page to the free list
    assert not any(e > 0 for e in pkv.prefix.entries())
    assert pkv.free_pages == pkv.n_pages - 1


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_allocator_walk_matches_reference(raw_weights, seed, pallas_store):
    """The reference's fixed-seed walks: after every operation the port's
    page tables, reference counts, free list, index entries (in LRU order),
    swap keys and pool bits equal the reference's, and the reference's
    audit invariants hold on the port."""
    cfg, ref_cfg, _, _ = raw_weights
    _walk(cfg, ref_cfg, seed)


if given is not None:
    @given(st.integers(0, 2**31 - 1))
    def test_allocator_walk_invariants_random_ops(seed):
        cfg = smoke_variant(get("qwen3-8b"))
        ref_cfg = ref_smoke(ref_get("qwen3-8b"))
        _walk(cfg, ref_cfg, seed, with_ref=False)


def test_forced_cow_split_copies_every_layer(raw_weights):
    """A write window over a shared page splits it: the new page equals the
    source in every layer's K and V, the source's other holders (the index
    and the other slot) keep it, ``n_cow_splits == 1``, and the reference's
    allocator makes the same decisions."""
    cfg, ref_cfg, _, _ = raw_weights
    ref, ref_cache, pkv, cache = _pair(cfg, ref_cfg, 3)
    prompt = list(range(1, 18))                 # two full blocks + 1
    for s, extra in ((0, 3), (1, 1)):
        ref_cache, _ = ref.admit_shared(ref_cache, s, prompt, extra)
        cache, matched = pkv.admit_shared(cache, s, prompt, extra)
        ref.register_prefix(s, prompt, 16)
        pkv.register_prefix(s, prompt, 16)
    assert matched == 16
    src = pkv._slot_pages[1][1]
    assert pkv._slot_pages[0][1] == src and pkv._ref[src] == 3
    ref_cache = ref.make_writable(ref_cache, 1, 10, 12)
    cache = pkv.make_writable(cache, 1, 10, 12)
    new = pkv._slot_pages[1][1]
    assert new != src and pkv.n_cow_splits == 1
    assert pkv._slot_pages[0][1] == src and pkv._ref[src] == 2
    assert pkv._ref[new] == 1 and pkv._slot_pages[1][0] == \
        pkv._slot_pages[0][0]                   # block 0 stays shared
    assert int(cache["page_table"][1, 1]) == new
    pools = cache["units"]["pos0"]
    for kn in ("k_pool", "v_pool"):
        assert torch.equal(pools[kn][:, new], pools[kn][:, src])
    _assert_same_state(ref, ref_cache, pkv, cache)
    # a second window over the now-private page splits nothing
    cache = pkv.make_writable(cache, 1, 8, 15)
    assert pkv.n_cow_splits == 1


def test_swap_store_unpinned_lru_matches_reference():
    """One put / pop / discard sequence under a capacity: the same keys,
    the same unpinned pages evicted least recently stored first, the same
    refusals, and the same stats."""
    def run(mod):
        store = mod.SwapStore(capacity_bytes=1000)
        put = ((lambda p, pinned: store.put(p, 0, pinned=pinned))
               if mod is ref_swap else
               (lambda p, pinned: store.put(p, pinned=pinned)))
        log = []
        for nbytes, pinned in [(300, False), (300, False), (200, True),
                               (300, False), (400, True), (700, False),
                               (250, True)]:
            try:
                log.append(("put", put(mod.SwappedPage(nbytes=nbytes),
                                       pinned)))
            except mod.SwapExhausted:
                log.append(("exhausted", nbytes))
            log.append(sorted(store._pages))
        log.append([store.contains(k) for k in range(8)])
        for k in list(store._pages)[:2]:
            log.append(("pop", k, store.pop(k).nbytes))
        store.discard(max(store._pages))
        try:
            put(mod.SwappedPage(nbytes=1100), True)
        except mod.SwapExhausted:
            log.append("exhausted")
        stats = store.stats()
        stats.pop("swap_bytes_per_shard", None)
        return log, stats, store.n_prefix_evicted

    got, want = run(swap), run(ref_swap)
    assert got == want
    assert got[2] > 0                           # unpinned pages were evicted
    assert "exhausted" in got[0]


# --------------------------------------------------------------------------
# the engine: tokens with sharing on, off, and the reference's
# --------------------------------------------------------------------------

def _chat(Req):
    prefix = list(range(1, 17))                 # 16 tokens = 2 pages
    suffixes = [[40 + i, 50 + i, 60 + i] for i in range(4)] + [[70]]
    return [Req(prompt=prefix + s, max_new_tokens=6, id=20_000 + i)
            for i, s in enumerate(suffixes)], False


def _retire(Req):
    prefix = list(range(1, 17))
    return [Req(prompt=prefix + [40], max_new_tokens=4, id=22_000),
            Req(prompt=[90 + i for i in range(30)], max_new_tokens=8,
                id=22_001),
            Req(prompt=prefix + [41], max_new_tokens=4, id=22_002)], True


def _preempt(Req):
    prefix = list(range(1, 9))                  # one full page of 8
    wl = [(3, 12, 1), (8, 10, 2), (1, 12, 0), (6, 8, 0)]
    rng = np.random.default_rng(3)
    sfx = [rng.integers(1, 512, size=n).tolist() for n, _, _ in wl]
    return [Req(prompt=prefix + sfx[i], max_new_tokens=mn, priority=pr,
                id=23_000 + i) for i, (_, mn, pr) in enumerate(wl)], False


# name -> (workload, engine settings) of tests/test_prefix_sharing.py
_WORKLOADS = {
    "chat": (_chat, dict(max_batch=3, max_len=64, page_size=8,
                         prefill_chunk=8)),
    "retire-and-fault": (_retire, dict(max_batch=2, max_len=64, page_size=8,
                                       n_pages=7, prefill_chunk=8,
                                       swap_bytes=1 << 28)),
    "preemption": (_preempt, dict(max_batch=2, max_len=64, page_size=8,
                                  n_pages=5, compress_cold=True,
                                  n_cold_slots=1, swap_bytes=1 << 28,
                                  prefill_chunk=4)),
}


def _serve(make, Eng, Cfg, Req, params, cfg, kw, **extra):
    """Serve a workload -> (tokens, engine); a serialized workload admits
    each request only once the previous one finished."""
    reqs, serial = make(Req)
    eng_kw = {"device": "cpu"} if Eng is GenerationEngine else {}
    eng = Eng(params, cfg, config=Cfg(**kw, **extra), **eng_kw)
    for r in reqs:
        eng.submit(r)
        if serial:
            eng.run()
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


@pytest.mark.parametrize("workload", list(_WORKLOADS))
def test_shared_tokens_match_unshared_and_reference(raw_weights, workload,
                                                    pallas_store):
    cfg, ref_cfg, ref_params, params = raw_weights
    make, kw = _WORKLOADS[workload]
    off, e_off = _serve(make, GenerationEngine, EngineConfig, Request,
                        params, cfg, kw)
    on, e_on = _serve(make, GenerationEngine, EngineConfig, Request,
                      params, cfg, kw, prefix_sharing=True)
    ref, e_ref = _serve(make, RefEngine, RefEngineConfig, RefRequest,
                        ref_params, ref_cfg, kw, prefix_sharing=True)
    assert on == off == ref
    assert e_on.prefix_sharing and not e_off.prefix_sharing
    # the same scheduling: prefill work, steps, preemptions, retirements
    for name in ("n_chunks", "n_chunk_tokens", "n_interleaved_steps",
                 "steps"):
        assert getattr(e_on, name) == getattr(e_ref, name), name
    assert e_on.scheduler.counters() == e_ref.scheduler.counters()
    got, want = e_on.paged.stats(), e_ref.paged.stats()
    for k in want:
        if k.startswith(("prefix_", "swap_prefix_")) or k in (
                "pages_in_use", "cold_pages_in_use", "swapped_pages"):
            assert got[k] == want[k], k
    assert got["prefix_cow_splits_total"] == 0
    assert e_on.n_chunk_tokens < e_off.n_chunk_tokens
    if workload == "retire-and-fault":
        assert e_on.paged.n_prefix_retired > 0
        assert e_on.paged.n_fault_decodes > 0       # the prefix came back
        assert e_on.paged.stats()["prefix_resident_blocks"] >= 1
    if workload == "preemption":
        assert e_on.scheduler.n_preempted > 0


def test_prefix_sharing_one_physical_copy(raw_weights):
    """While three common-prefix requests are in flight their page tables
    point at the same physical pages, whose refcount equals the holder
    count (three slots and the index), and the pages are counted once."""
    cfg, ref_cfg, ref_params, params = raw_weights
    prefix = list(range(1, 17))
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_batch=4, max_len=64, page_size=8, prefill_chunk=32,
        prefix_sharing=True), device="cpu")
    eng.submit(Request(prompt=prefix + [99], max_new_tokens=2, id=21_000))
    eng.run()
    assert len(eng.paged.prefix) == 2
    # the router's advisory signal: the match, capped so the last prompt
    # token is prefilled
    assert [eng.prefix_match_tokens(prefix + t) for t in ([], [7], [7] * 9)] \
        == [8, 16, 16]
    base = eng.paged.stats()["pages_in_use"]
    reqs = [Request(prompt=prefix + [50 + i], max_new_tokens=8,
                    id=21_001 + i) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    slots = [eng.slots.index(r) for r in reqs]
    rows = [eng.paged._slot_pages[s][:2] for s in slots]
    assert rows[0] == rows[1] == rows[2]
    table = eng.cache["page_table"]
    for s in slots:
        assert table[s, :2].tolist() == rows[0]
    for pid in rows[0]:
        assert eng.paged._ref[pid] == 4
    assert eng.paged.n_shared_pages() == 2
    assert eng.paged.stats()["pages_in_use"] <= base + 3 + 1
    eng.run()
    ref = RefEngine(ref_params, ref_cfg, config=RefEngineConfig(
        max_batch=4, max_len=64, cache_mode="monolithic"))
    ref_reqs = [RefRequest(prompt=r.prompt, max_new_tokens=8) for r in reqs]
    for r in ref_reqs:
        ref.submit(r)
    ref.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]


def test_admission_counts_the_pages_a_match_takes(raw_weights):
    """A prefix-shared admission adopts index-only pages (no longer
    reclaimable) and faults retired ones into fresh pages.  The reference's
    fit test counts both as headroom, so it admits a request that
    ``admit_shared`` then cannot place; the port's counts them
    (``match_page_cost``), waits, and admits once pages free."""
    from repro.serving.scheduler import Scheduler as RefScheduler
    from repro_torch.serving.scheduler import Scheduler
    cfg, ref_cfg, _, _ = raw_weights
    prefix = list(range(1, 17))
    sides = []
    for alloc, mk in (
            (ref_paged.PagedKVCache(ref_cfg, 3, 64, dtype=jnp.float32,
                                    page_size=8, n_pages=8), RefScheduler),
            (paged.PagedKVCache(cfg, 3, 64, dtype=torch.float32,
                                device="cpu", page_size=8, n_pages=8),
             Scheduler)):
        alloc.enable_prefix_sharing()
        cache = alloc.init_cache()
        cache, _ = alloc.admit_shared(cache, 0, prefix + [1], 3)
        alloc.register_prefix(0, prefix + [1], 16)
        cache, _ = alloc.admit_shared(cache, 1, list(range(50, 74)), 3)
        cache = alloc.release(cache, 0)       # the prefix is index-only now
        sides.append((alloc, cache, mk(paged=alloc, preemption=False,
                                       chunk_tokens=8)))
    (ref, ref_cache, ref_sched), (pkv, cache, sched) = sides
    assert pkv.free_pages == 2 and pkv.reclaimable_pages() == 2
    req = Request(prompt=prefix + list(range(80, 100)), max_new_tokens=4)
    assert sched.admission_grant(req) == 3
    assert pkv.match_page_cost(req.prompt) == 2
    assert ref_sched._fits(req, 0) and not sched._fits(req, 0)
    with pytest.raises(ref_paged.OutOfPages):
        ref.admit_shared(ref_cache, 2, req.prompt, 3)
    cache = pkv.release(cache, 1)
    assert sched._fits(req, 0)
    cache, matched = pkv.admit_shared(cache, 2, req.prompt,
                                      sched.admission_grant(req))
    assert matched == 16 and pkv._slot_pages[2][:2] == \
        [pid for pid in pkv.prefix.entries()]
