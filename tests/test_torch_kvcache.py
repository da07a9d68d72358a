"""The port's KV-cache codec, cold pool and swap tier against the JAX
package: the host page encoder byte-identical to the reference's, the plain
page decode bit-exact against the reference's in-graph twin and its Pallas
kernel (interpret mode), the allocator's cold-pool state identical after
the same operation sequence, decode-step logits with cold pages within the
model tolerance of the reference (and bit-identical to the port's own
uncompressed cache), and an evict/fault round trip that restores the pool
bit-exactly with the reference's swap accounting."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.configs import get as ref_get, smoke_variant as ref_smoke  # noqa: E402
from repro.core import theory  # noqa: E402
from repro.kvcache import codec as ref_codec  # noqa: E402
from repro.kvcache import kernels as ref_kernels  # noqa: E402
from repro.kvcache import paged as ref_paged  # noqa: E402
from repro.kvcache.swap import SwapStore as RefSwapStore  # noqa: E402
from repro.models import model as RM  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get, smoke_variant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kvcache import codec, paged  # noqa: E402
from repro_torch.kvcache import kernels as kv_kernels  # noqa: E402
from repro_torch.kvcache.swap import SwapStore  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

LOGIT_ATOL = 1e-4       # tests/test_torch_model.py's: f32, another order

# dtype name -> (numpy bit view, jax view, torch bit view)
_VIEW = {"float8_e4m3fn": (np.uint8, jnp.float8_e4m3fn, torch.uint8),
         "bfloat16": (np.uint16, jnp.bfloat16, torch.int16),
         "float32": (np.uint32, np.float32, torch.int32)}


# The reference's Pallas kernels write their output rows with ``pl.store``,
# which newer JAX releases dropped; assigning through the ref is the same
# write.  Installed when this module is imported, so it holds for the whole
# test process: the reference package's own tests (its page fault, its
# prefix-sharing allocator walks) reach the same kernel, and a jitted trace
# taken under a per-test patch would otherwise leak into them or not
# depending on which tests a worker happened to run first.
if not hasattr(pl, "store"):
    def _pallas_store(ref, idx, val):
        ref[idx] = val
    pl.store = _pallas_store


def _rand_bits(rng, n, name):
    """Any bit content, NaNs and infinities included."""
    if name == "float8_e4m3fn":
        return rng.integers(0, 256, n).astype(np.uint8)
    if name == "bfloat16":
        return rng.integers(0, 1 << 16, n).astype(np.uint16)
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _normal_bits(rng, n, name, scale):
    """Cache-like values (normal, one scale) as the page type's bits."""
    v = jnp.asarray(rng.standard_normal(n) * scale, jnp.float32)
    return np.asarray(v.astype(_VIEW[name][1])).view(_VIEW[name][0])


def _torch_page(bits, name):
    """The port's view of a page given as unsigned bits."""
    uint, _, tbits = _VIEW[name]
    signed = bits.view(np.dtype(uint).str.replace("u", "i"))
    return torch.from_numpy(signed.copy()).view(tbits).view(
        codec.TORCH_DTYPES[name])


def _stack(cps):
    """Coded pages -> the four decode inputs, payloads zero-padded to the
    largest stride (numpy)."""
    stride = max(c.stride for c in cps)
    pay = np.zeros((len(cps), stride, codec.LANES), np.uint8)
    for i, c in enumerate(cps):
        pay[i, : c.stride] = c.payload
    return (pay, np.stack([c.signmant for c in cps]),
            np.stack([c.tables() for c in cps]),
            np.stack([c.perm for c in cps]))


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------

_ENCODE_CASES = [(name, n, "random") for name in _VIEW
                 for n in (1, 127, 128, 1000, 4096)] + [
    ("bfloat16", 16384, f"alpha-stable {a}") for a in (1.9, 1.7, 1.5)]


@pytest.mark.parametrize("name,n,kind", _ENCODE_CASES)
def test_encode_page_byte_identical_to_reference(name, n, kind):
    if kind == "random":
        bits = _rand_bits(np.random.default_rng(n), n, name)
    else:
        alpha = float(kind.split()[1])
        v = theory.sample_alpha_stable((n,), alpha=alpha, seed=int(alpha * 10))
        bits = np.asarray(jnp.asarray(v * 0.15, jnp.bfloat16)).view(np.uint16)
    want = ref_codec.encode_page(bits.view(_VIEW[name][1]))
    got = codec.encode_page(_torch_page(bits, name))
    for f in ("payload", "signmant", "lj_limit", "first_lj", "offset",
              "perm"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert (got.nbytes(), got.ratio(), got.n_active, got.stride) == (
        want.nbytes(), want.ratio(), want.n_active, want.stride)
    np.testing.assert_array_equal(got.tables(), want.tables())
    exp, sm = codec.split_planes(bits, name)
    np.testing.assert_array_equal(
        codec.assemble_planes(exp, sm, name, n), bits)
    dec = ops.decode_pages(*map(torch.from_numpy, _stack([got])), n_elem=n,
                           dtype_name=name)
    assert torch.equal(dec[0].view(_VIEW[name][2]),
                       _torch_page(bits, name).view(_VIEW[name][2]))


@pytest.mark.parametrize("name", list(_VIEW))
def test_plain_page_decode_matches_jnp_twin_and_pallas(name):
    """Pages with different codebooks (one a single symbol, one using the
    widest codes), zero-padded to one stride, plus a never-written
    (all-zero) cold slot: bit-exact against ``decode_pages_jnp`` on every
    page and against the Pallas kernel on the written ones (the two
    reference paths differ on the empty slot; no caller reads it)."""
    rng = np.random.default_rng(11)
    n = 1000
    pages = [_normal_bits(rng, n, name, s) for s in (0.05, 1.0, 300.0)]
    pages.append(np.full(n, pages[0][0]))                   # one symbol
    pages.append(_rand_bits(rng, n, name))                  # widest codes
    cps = [codec.encode_page(_torch_page(b, name)) for b in pages]
    pay, sm, tab, perm = _stack(cps)
    zero = [np.zeros_like(a[:1]) for a in (pay, sm, tab, perm)]
    args = [np.concatenate([a, z]) for a, z in zip((pay, sm, tab, perm),
                                                   zero)]
    got = kv_kernels.plain(*map(torch.from_numpy, args), n_elem=n,
                           dtype_name=name).view(_VIEW[name][2]).numpy()
    twin = np.asarray(ref_codec.decode_pages_jnp(
        *map(jnp.asarray, args), n_elem=n, dtype_name=name))
    np.testing.assert_array_equal(got.view(_VIEW[name][0]),
                                  twin.view(_VIEW[name][0]))
    pallas = np.asarray(ref_kernels.decode_pages(
        *map(jnp.asarray, (pay, sm, tab, perm)), n_elem=n, dtype_name=name,
        interpret=True))
    for i, bits in enumerate(pages):
        np.testing.assert_array_equal(pallas[i].view(_VIEW[name][0]), bits)
        np.testing.assert_array_equal(got[i].view(_VIEW[name][0]), bits)


def _table_sets(name):
    """(tables, perm) of a random, a single-symbol, a widest-code (every
    exponent) and a never-written (all-zero) page."""
    rng = np.random.default_rng(17)
    n = 1000
    cps = [codec.encode_page(_torch_page(b, name)) for b in (
        _normal_bits(rng, n, name, 1.0),
        np.full(n, _normal_bits(rng, 1, name, 1.0)[0]),
        _rand_bits(rng, n, name))]
    tab = np.stack([c.tables() for c in cps])
    perm = np.stack([c.perm for c in cps])
    return (np.concatenate([tab, np.zeros_like(tab[:1])]),
            np.concatenate([perm, np.zeros_like(perm[:1])]))


# the symbol's bits in a value whose sign/mantissa plane is zero
_SYM_FIELD = {"float8_e4m3fn": (3, 0xF), "bfloat16": (7, 0x1FF),
              "float32": (23, 0x1FF)}


@pytest.mark.parametrize("name", list(_VIEW))
def test_decode_table_matches_plain_rule_for_every_peek(name):
    """``codec.decode_table`` (the page kernel's lookup table) gives, for
    every peek, the symbol that ``decode_pages_plain`` decodes from a lane
    whose stream starts with that peek, on random, single-symbol,
    every-exponent and all-zero tables."""
    _, L, _ = codec.plane_spec(name)
    tab, perm = _table_sets(name)
    table = codec.decode_table(torch.from_numpy(tab), torch.from_numpy(perm),
                               dtype_name=name).numpy()
    assert table.shape == (len(tab), 1 << L)
    assert ((table & 0x1F) >= 1).all() and ((table & 0x1F) <= L).all()
    n_pages = (1 << L) // codec.LANES
    peek = np.arange(1 << L).reshape(n_pages, codec.LANES)
    pay = np.zeros((n_pages, 4, codec.LANES), np.uint8)
    head = peek << (16 - L)                 # the peek, left-justified
    pay[:, 0], pay[:, 1] = head >> 8, head & 0xFF
    shift, mask = _SYM_FIELD[name]
    for i in range(len(tab)):
        got = kv_kernels.plain(
            torch.from_numpy(pay),
            torch.zeros((n_pages, codec.sm_bytes(name, codec.LANES)),
                        dtype=torch.uint8),
            torch.from_numpy(np.repeat(tab[i:i + 1], n_pages, 0)),
            torch.from_numpy(np.repeat(perm[i:i + 1], n_pages, 0)),
            n_elem=codec.LANES, dtype_name=name)
        bits = got.view(_VIEW[name][2]).numpy().view(_VIEW[name][0])
        sym = (bits.astype(np.int64) >> shift) & mask
        np.testing.assert_array_equal(sym.reshape(-1),
                                      (table[i] >> 5) & mask, err_msg=str(i))


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn"])
def test_decode_table_interval_fill_matches_rule(name):
    """The page kernel fills its table one interval of peeks at a time (the
    peeks whose first limit above them is limit j lie in [max of the limits
    before j, limit j); above every limit, length 1): on tables of any
    content, ordered or not, that fill gives ``codec.decode_table``."""
    _, L, _ = codec.plane_spec(name)
    n_sym = 1 << codec.plane_spec(name)[0]
    rng = np.random.default_rng(L)
    tabs, perms = _table_sets(name)
    for trial in range(12):
        if trial < len(tabs):
            tab, perm = tabs[trial].astype(np.int64), perms[trial]
        else:
            big = trial % 2
            hi = (1 << 31) - 1 if big else (1 << L) + 64
            tab = rng.integers(-hi - 1 if big else -64, hi, (3, L))
            if trial % 3 == 0:
                tab[0] = np.sort(tab[0])
            perm = rng.integers(-(1 << 31), (1 << 31) - 1, n_sym)
        tab32, perm32 = tab.astype(np.int32), perm.astype(np.int32)
        want = codec.decode_table(torch.from_numpy(tab32[None]),
                                  torch.from_numpy(perm32[None]),
                                  dtype_name=name).numpy()[0]
        lim, first, off = tab32.astype(np.int64)
        got = np.zeros(1 << L, np.int64)
        lo = 0
        for j in range(L + 1):
            hi_p = min(max(lo, lim[j]), 1 << L) if j < L else 1 << L
            length = j + 1 if j < L else 1
            p = np.arange(lo, max(lo, hi_p))
            idx = np.clip(off[length - 1] + ((p - first[length - 1])
                                             >> (L - length)), 0, n_sym - 1)
            got[p] = ((perm32[idx].astype(np.int64) & 0x1FF) << 5) | length
            lo = max(lo, hi_p)
        np.testing.assert_array_equal(got, want, err_msg=str(trial))


def _table_word_decode(pay, tab, perm, sm, n_elem, name):
    """The page kernel's loop in numpy: the payload as big-endian 32-bit
    words of one lane (one more word of the clamped last byte), a 64-bit
    window refilled 32 bits at a time every two symbols when 32 or fewer
    bits are left, one table read a symbol."""
    _, L, _ = codec.plane_spec(name)
    table = codec.decode_table(torch.from_numpy(tab), torch.from_numpy(perm),
                               dtype_name=name).numpy().astype(np.uint64)
    N, stride, lanes = pay.shape
    W = -(-stride // 4) + 1
    k = np.minimum(np.arange(4 * W), stride - 1)
    b = pay[:, k, :].astype(np.uint64).reshape(N, W, 4, lanes)
    words = (b[:, :, 0] << 24) | (b[:, :, 1] << 16) | (b[:, :, 2] << 8) \
        | b[:, :, 3]                                    # (N, W, lanes)
    S = codec.sym_per_lane(n_elem)
    rows = np.arange(N)[:, None]
    win = (words[:, 0] << np.uint64(32)) | words[:, 1]
    nxt = np.full((N, lanes), 2)
    valid = np.full((N, lanes), 64)
    syms = np.zeros((N, S + 1, lanes), np.int64)
    for s0 in range(0, S, 2):
        low = valid <= 32
        w = words[rows, np.minimum(nxt, W - 1), np.arange(lanes)]
        win = np.where(low, win | (w << (32 - valid).clip(0).astype(
            np.uint64)), win)
        nxt, valid = nxt + low, valid + 32 * low
        for j in range(2):
            ent = table[rows, (win >> np.uint64(64 - L)).astype(np.int64)]
            syms[:, s0 + j] = (ent >> np.uint64(5)).astype(np.int64)
            win = win << (ent & np.uint64(0x1F))
            valid = valid - (ent & np.uint64(0x1F)).astype(np.int64)
    flat = syms[:, :S].reshape(N, -1)[:, :n_elem]
    return codec.assemble_pages(torch.from_numpy(flat), torch.from_numpy(sm),
                                n_elem=n_elem, dtype_name=name)


@pytest.mark.parametrize("name", list(_VIEW))
@pytest.mark.parametrize("n", [1000, 4096])
def test_table_driven_word_refill_decode_matches_plain(name, n):
    """The kernel's design (table lookups, 32-bit word refills of a 64-bit
    window, the clamp to byte stride - 1 written into the words) decodes
    what ``decode_pages_plain`` decodes: on coded pages zero-padded to a
    wider stride beside a never-written slot, and on random payload bytes
    under every table set (streams that run past the stride)."""
    rng = np.random.default_rng(n)
    pages = [_normal_bits(rng, n, name, s) for s in (0.05, 300.0)]
    pages.append(_rand_bits(rng, n, name))
    pay, sm, tab, perm = _stack([codec.encode_page(_torch_page(b, name))
                                 for b in pages])
    pay = np.concatenate([pay, np.zeros_like(pay[:, :7])], axis=1)
    cases = [[np.concatenate([a, np.zeros_like(a[:1])])
              for a in (pay, sm, tab, perm)]]
    rtab, rperm = _table_sets(name)
    cases.append([rng.integers(0, 256, (len(rtab), 9, codec.LANES),
                               dtype=np.uint8),
                  rng.integers(0, 256, (len(rtab), sm.shape[1]),
                               dtype=np.uint8), rtab, rperm])
    for pay_, sm_, tab_, perm_ in cases:
        want = kv_kernels.plain(*map(torch.from_numpy,
                                     (pay_, sm_, tab_, perm_)),
                                n_elem=n, dtype_name=name)
        got = _table_word_decode(pay_, tab_, perm_, sm_, n, name)
        tb = _VIEW[name][2]
        assert torch.equal(got.view(tb), want.view(tb))


# --------------------------------------------------------------------------
# allocator: cold pool and swap tier
# --------------------------------------------------------------------------

def _pair(n_cold, max_batch):
    """The reference's and the port's cold-pool allocators, f32 pages of
    4 positions, max_len 32."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    kw = dict(page_size=4, compress_cold=True, n_cold_slots=n_cold)
    ref_pc = ref_paged.PagedKVCache(ref_cfg, max_batch, 32,
                                    dtype=jnp.float32, **kw)
    pc = paged.PagedKVCache(cfg, max_batch, 32, dtype=torch.float32,
                            device="cpu", **kw)
    return cfg, ref_cfg, ref_pc, pc


def _frags(cfg, max_len, seed):
    """A prefill fragment with random K/V, for both packages."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, max_len, cfg.hd)
    kv = {kn: (rng.standard_normal(shape) * 0.5).astype(np.float32)
          for kn in ("k", "v")}
    ref = {"units": {"pos0": {kn: jnp.asarray(a) for kn, a in kv.items()}}}
    got = {"units": {"pos0": {kn: torch.from_numpy(a.copy())
                              for kn, a in kv.items()}}}
    return ref, got


def _assert_same_state(ref_pc, pc, ref_cache, cache, what):
    assert pc._free == ref_pc._free, what
    assert pc._cold_free == ref_pc._cold_free, what
    assert pc._slot_pages == ref_pc._slot_pages, what
    assert pc._skip == ref_pc._skip, what
    assert pc._cold_bytes == ref_pc._cold_bytes, what
    np.testing.assert_array_equal(cache["page_table"].numpy(),
                                  np.asarray(ref_cache["page_table"]),
                                  err_msg=what)
    ours, theirs = cache["units"]["pos0"], ref_cache["units"]["pos0"]
    for leaf in ("k_cpl", "k_csm", "k_ctab", "k_cperm", "v_cpl", "v_csm",
                 "v_ctab", "v_cperm"):
        np.testing.assert_array_equal(ours[leaf].numpy(),
                                      np.asarray(theirs[leaf]),
                                      err_msg=f"{what}: {leaf}")
    a, b = pc.stats(), ref_pc.stats()
    for k in sorted(a.keys() & b.keys()):
        assert a[k] == b[k], (what, k)


def test_cold_pool_allocator_matches_reference():
    cfg, ref_cfg, ref_pc, pc = _pair(n_cold=5, max_batch=3)
    ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
    ops_ = [("admit", 0, 13), ("admit", 1, 6), ("compress", 0, 13),
            ("ensure", 1, 9), ("compress", 1, 10), ("admit", 2, 20),
            ("release", 0, 0), ("compress", 2, 20), ("ensure", 2, 24),
            ("compress", 2, 25), ("release", 1, 0), ("admit", 0, 9),
            ("compress", 0, 9), ("release", 2, 0)]
    for i, (op, slot, n) in enumerate(ops_):
        if op == "admit":
            rf, gf = _frags(cfg, 32, seed=i)
            ref_cache = ref_pc.admit(ref_cache, slot, rf, n)
            cache = pc.admit(cache, slot, gf, n)
        elif op == "ensure":
            ref_cache = ref_pc.ensure(ref_cache, slot, n)
            cache = pc.ensure(cache, slot, n)
        elif op == "compress":
            ref_cache = ref_pc.compress_cold_pages(ref_cache, slot, n)
            cache = pc.compress_cold_pages(cache, slot, n)
        else:
            ref_cache = ref_pc.release(ref_cache, slot)
            cache = pc.release(cache, slot)
        _assert_same_state(ref_pc, pc, ref_cache, cache, (op, slot, n))
    assert pc.n_compressed >= 5


def test_evict_fault_round_trip_matches_reference():
    """Cold-first eviction, then a fault that reinstalls one cold page
    into the cold pool and decodes the rest (one decode call) into raw
    pages: the slot's gathered history is bit-identical before and after,
    and allocator state and swap accounting equal the reference's."""
    cfg, ref_cfg, ref_pc, pc = _pair(n_cold=3, max_batch=2)
    ref_pc.attach_swap(RefSwapStore(capacity_bytes=1 << 24))
    pc.attach_swap(SwapStore(capacity_bytes=1 << 24))
    ref_cache, cache = ref_pc.init_cache(), pc.init_cache()
    for slot, n in ((0, 14), (1, 9)):
        rf, gf = _frags(cfg, 32, seed=slot)
        ref_cache = ref_pc.admit(ref_cache, slot, rf, n)
        cache = pc.admit(cache, slot, gf, n)
        ref_cache = ref_pc.compress_cold_pages(ref_cache, slot, n)
        cache = pc.compress_cold_pages(cache, slot, n)
    assert pc._cold_bytes and not pc._cold_free[0]  # slot 1 kept raw pages

    def history(slot):
        pools = cache["units"]["pos0"]
        return [paged.page_gather(pools[f"{kn}_pool"][u],
                                  cache["page_table"][slot:slot + 1],
                                  paged.cold_leaves(pools, kn, u))
                for kn in ("k", "v") for u in range(cfg.n_layers)]

    before = history(0)
    ref_cache = ref_pc.evict(ref_cache, 0)
    cache = pc.evict(cache, 0)
    assert pc.has_swapped(0) and pc.n_swapped(0) == 4
    assert pc.resident_raw_pages(0) == 0
    _assert_same_state(ref_pc, pc, ref_cache, cache, "evict")
    # slot 1's two full pages take two of the three freed cold slots,
    # leaving one for the fault
    ref_cache = ref_pc.compress_cold_pages(ref_cache, 1, 9)
    cache = pc.compress_cold_pages(cache, 1, 9)
    assert len(pc._cold_free[0]) == 1
    ref_cache = ref_pc.fault(ref_cache, 0)
    cache = pc.fault(cache, 0)
    assert pc.n_fault_decodes == 1 and not pc.has_swapped(0)
    assert any(e >= pc.n_pages for e in pc._slot_pages[0])   # back to cold
    _assert_same_state(ref_pc, pc, ref_cache, cache, "fault")
    for a, b in zip(before, history(0)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    st = pc.swap.stats()
    assert st["swap_in_bytes_total"] == st["swap_out_bytes_total"] > 0
    assert len(pc.swap) == 0


def test_page_decode_calls_name_their_path(monkeypatch):
    """The decode step's cold gather and the swap fault each tag their
    page-decode call, which the kernel's per-path launch counts read."""
    cfg, _, _, pc = _pair(n_cold=3, max_batch=2)
    pc.attach_swap(SwapStore(capacity_bytes=1 << 24))
    _, gf = _frags(cfg, 32, seed=0)
    cache = pc.admit(pc.init_cache(), 0, gf, 14)
    cache = pc.compress_cold_pages(cache, 0, 14)    # 3 cold, 1 raw tail
    seen, real = [], ops.decode_pages

    def spy(*args, path="other", **kw):
        seen.append(path)
        return real(*args, path=path, **kw)

    monkeypatch.setattr(ops, "decode_pages", spy)
    pools = cache["units"]["pos0"]
    paged.page_gather(pools["k_pool"][0], cache["page_table"][:1],
                      paged.cold_leaves(pools, "k", 0))
    cache = pc.fault(pc.evict(cache, 0), 0)
    assert seen == ["gather", "fault"]


def test_sentinel_row_write_leaves_live_pages_unchanged():
    """A vacated, swapped-out slot's row holds negative swap sentinels; the
    batched decode step still writes that row.  The write is dropped: every
    live page keeps its contents except the active slot's own new K/V."""
    cfg = smoke_variant(get("qwen3-8b"))
    params = M.init_params(cfg, 0, device="cpu")
    pc = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                            page_size=4, n_pages=5)
    pc.attach_swap(SwapStore())
    cache = pc.init_cache()
    _, f1 = _frags(cfg, 32, seed=1)
    cache = pc.admit(cache, 1, f1, 5)          # pages 1, 2
    cache = pc.evict(cache, 1)                 # row 1 -> [-1, -2, 0, ...]
    _, f0 = _frags(cfg, 32, seed=0)
    cache = pc.admit(cache, 0, f0, 13)         # reuses 2, 1, then 3, 4
    assert pc._slot_pages[0] == [2, 1, 3, 4]
    assert cache["page_table"][1, :2].tolist() == [-1, -2]
    pools = cache["units"]["pos0"]
    before = {kn: pools[f"{kn}_pool"].clone() for kn in ("k", "v")}
    _, cache = M.decode_step(params, cfg, torch.tensor([[3], [4]]), cache)
    for kn in ("k", "v"):
        now = pools[f"{kn}_pool"]
        for pid in (1, 2, 3):
            assert torch.equal(now[:, pid], before[kn][:, pid]), (kn, pid)
        # page 4 changed only at slot 0's write position 13 (offset 1)
        keep = [o for o in range(4) if o != 1]
        assert torch.equal(now[:, 4, :, keep], before[kn][:, 4, :, keep])
        assert not torch.equal(now[:, 4, :, 1], before[kn][:, 4, :, 1])


# --------------------------------------------------------------------------
# decode step with cold pages
# --------------------------------------------------------------------------

def test_decode_step_with_cold_pages_matches_reference():
    """tests/test_kvcache.py:171's setup on both packages: the port's
    logits with cold pages decoded in the step are within the model
    tolerance of the reference's, and bit-identical to the port's own
    uncompressed paged cache."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    B, max_len, ps = 2, 32, 8
    ref_pc = ref_paged.PagedKVCache(ref_cfg, B, max_len, dtype=jnp.float32,
                                    page_size=ps, compress_cold=True)
    pcs = [paged.PagedKVCache(cfg, B, max_len, dtype=torch.float32,
                              device="cpu", page_size=ps,
                              compress_cold=c) for c in (True, False)]
    ref_cache = ref_pc.init_cache()
    caches = [pc.init_cache() for pc in pcs]
    lens = [11, 6]
    for slot, T in enumerate(lens):
        toks = np.arange(1, T + 1, dtype=np.int32)[None] + 3 * slot
        _, frag = RM.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                             max_len=max_len)
        ref_cache = ref_pc.admit(ref_cache, slot, frag, T)
        _, frag_t = M.prefill(params, cfg, torch.from_numpy(toks).long(),
                              max_len=max_len)
        caches = [pc.admit(c, slot, frag_t, T) for pc, c in zip(pcs, caches)]
    tok = np.asarray([[17], [29]], np.int32)
    n_cold_steps = 0
    for step in range(12):
        for slot in range(B):
            ref_cache = ref_pc.ensure(ref_cache, slot, lens[slot])
            caches = [pc.ensure(c, slot, lens[slot])
                      for pc, c in zip(pcs, caches)]
        want, ref_cache = RM.decode_step(ref_params, ref_cfg,
                                         jnp.asarray(tok), ref_cache)
        n_cold_steps += pcs[0].has_cold
        got = []
        for i, c in enumerate(caches):
            logits, caches[i] = M.decode_step(
                params, cfg, torch.from_numpy(tok).long(), c)
            got.append(logits)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        assert torch.equal(got[0], got[1]), step
        for slot in range(B):
            lens[slot] += 1
            ref_cache = ref_pc.compress_cold_pages(ref_cache, slot,
                                                   lens[slot])
            caches[0] = pcs[0].compress_cold_pages(caches[0], slot,
                                                   lens[slot])
        np.testing.assert_array_equal(caches[0]["page_table"].numpy(),
                                      np.asarray(ref_cache["page_table"]))
        tok = (tok + 7) % cfg.vocab_size
    assert n_cold_steps >= 6, "too few steps with a cold page"


def test_page_decode_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back to the plain version: the
    dispatcher picks the plain path for CPU tensors, the wrapper raises."""
    cp = codec.encode_page(torch.randn(1000))
    args = [torch.from_numpy(a) for a in _stack([cp])]
    before = kv_kernels.run.launches
    with pytest.raises(ValueError, match="CUDA"):
        kv_kernels.run(*args, n_elem=1000, dtype_name="float32")
    assert kv_kernels.run.launches == before
    got = ops.decode_pages(*args, n_elem=1000, dtype_name="float32",
                           path="gather")
    assert kv_kernels.run.launches == before and got.shape == (1, 1000)


# --------------------------------------------------------------------------
# chunked prefill
# --------------------------------------------------------------------------

def test_prefill_chunk_matches_reference():
    """One slot's prompt of 15 tokens in chunks of 6 on both packages
    (pages of 4): a first chunk, a second resuming at start 6 that
    straddles a page boundary and gathers a cold page, and a padded last
    chunk (3 of 6 valid).  Logits and the slot's gathered history are
    within the model tolerance of the reference's, the page table and
    timeline equal; the port's last-chunk logits are within the same
    tolerance of its own whole-prompt prefill."""
    cfg = smoke_variant(get("qwen3-8b"))
    ref_cfg = ref_smoke(ref_get("qwen3-8b"))
    ref_params = RM.init_params(jax.random.PRNGKey(2), ref_cfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    kw = dict(page_size=4, compress_cold=True)
    ref_pc = ref_paged.PagedKVCache(ref_cfg, 2, 32, dtype=jnp.float32, **kw)
    pc = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device="cpu",
                            **kw)
    C, slot = 6, 1
    prompt = np.random.default_rng(3).integers(
        1, cfg.vocab_size, 15).tolist()
    ref_cache = ref_pc.admit_slot(ref_pc.init_cache(), slot,
                                  ref_pc.pages_for_prefix(C))
    cache = pc.admit_slot(pc.init_cache(), slot, pc.pages_for_prefix(C))
    for lo in range(0, len(prompt), C):
        part = prompt[lo:lo + C]
        n = len(part)
        toks = np.asarray([part + [0] * (C - n)], np.int32)
        ref_cache = ref_pc.ensure(ref_cache, slot, lo + n - 1)
        cache = pc.ensure(cache, slot, lo + n - 1)
        had_cold = pc.has_cold
        want, ref_cache = RM.prefill_chunk(ref_params, ref_cfg,
                                           jnp.asarray(toks), ref_cache,
                                           slot, n)
        got, _ = M.prefill_chunk(params, cfg, torch.from_numpy(toks).long(),
                                 pc_cache_in(pc, cache), slot, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"chunk at {lo}")
        np.testing.assert_array_equal(cache["page_table"].numpy(),
                                      np.asarray(ref_cache["page_table"]))
        np.testing.assert_array_equal(cache["cur_len"].numpy(),
                                      np.asarray(ref_cache["cur_len"]))
        pools, ref_pools = cache["units"]["pos0"], ref_cache["units"]["pos0"]
        for kn in ("k", "v"):
            for u in range(cfg.n_layers):
                mine = paged.page_gather(
                    pools[f"{kn}_pool"][u], cache["page_table"][slot:slot + 1],
                    paged.cold_leaves(pools, kn, u) if pc.has_cold else None)
                theirs = ref_paged.page_gather(
                    ref_pools[f"{kn}_pool"][u],
                    ref_cache["page_table"][slot:slot + 1],
                    tuple(ref_pools[f"{kn}_{c}"][u]
                          for c in ("cpl", "csm", "ctab", "cperm")))
                L = lo + n
                np.testing.assert_allclose(mine[:, :, :L].numpy(),
                                           np.asarray(theirs)[:, :, :L],
                                           atol=LOGIT_ATOL)
        if lo == C:
            assert had_cold        # the second chunk gathered a cold page
        ref_cache = ref_pc.compress_cold_pages(ref_cache, slot, lo + n)
        cache = pc.compress_cold_pages(cache, slot, lo + n)
    whole, _ = M.prefill(params, cfg, torch.tensor([prompt]), max_len=32)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=LOGIT_ATOL)


def pc_cache_in(pc, cache):
    """The cache a chunk reads: without the cold leaves while nothing is
    cold, as the engine passes it."""
    if pc.has_cold:
        return cache
    pools = cache["units"]["pos0"]
    return {**cache, "units": {"pos0": {
        kn: pools[kn] for kn in ("k_pool", "v_pool")}}}


def test_chunk_write_drops_sentinels_cold_ids_and_padding():
    """A chunk whose row holds a swap sentinel and a cold id, and whose
    last two positions are padding: only the positions on live raw pages
    land (as the reference writes them), every other page keeps its bits,
    the garbage page included."""
    rng = np.random.default_rng(4)
    n_pool, ps, C = 5, 4, 12
    pool = rng.normal(size=(n_pool, 2, ps, 8)).astype(np.float32)
    row = np.array([3, -1, 7, 0], np.int32)     # raw, sentinel, cold, empty
    kv = rng.normal(size=(1, 2, C, 8)).astype(np.float32)
    positions = np.arange(C, dtype=np.int32)
    got = paged.page_write_chunk(torch.from_numpy(pool.copy()),
                                 torch.from_numpy(row),
                                 torch.from_numpy(positions),
                                 torch.from_numpy(kv), 10).numpy()
    want = np.asarray(ref_paged.page_write_chunk(
        jnp.asarray(pool), jnp.maximum(jnp.asarray(row), 0),
        jnp.asarray(positions), jnp.asarray(kv), 10))
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_array_equal(got[3], kv[0, :, :4])
    for pid in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[pid], pool[pid])


# the instance each page shape of qwen3-8b (8 KV heads, head_dim 128) gets
# at a cold slot's stride budget: staged while the payload words and plane
# fit the shared memory, streamed above (a bf16 page of 128 positions, an
# f32 page of 64 or more)
_INSTANCE = {("bfloat16", 16): "staged", ("bfloat16", 64): "staged",
             ("bfloat16", 128): "streamed", ("float32", 16): "staged",
             ("float32", 64): "streamed", ("float32", 128): "streamed",
             ("float8_e4m3fn", 16): "staged", ("float8_e4m3fn", 64): "staged",
             ("float8_e4m3fn", 128): "staged"}


@pytest.mark.parametrize("name,page_size", sorted(_INSTANCE))
def test_page_decode_instance_chosen_by_shared_memory(name, page_size):
    """The wrapper picks the kernel instance from the page's shape through
    ``_smem_bytes``: no page size that ``PagedKVCache`` accepts is refused
    (the reference serves them all through its in-graph twin)."""
    cfg = get("qwen3-8b")
    pc = paged.PagedKVCache(cfg, 4, 1024, dtype=codec.TORCH_DTYPES[name],
                            device="meta", page_size=page_size,
                            compress_cold=True, n_cold_slots=1)
    smem = kv_kernels._smem_bytes(pc.stride_budget, pc.sm_nbytes)
    inst = kv_kernels.instance(pc.stride_budget, pc.sm_nbytes)
    assert inst == _INSTANCE[(name, page_size)]
    assert (inst == "staged") == (smem <= kv_kernels._MAX_SMEM)
    if (name, page_size) in (("bfloat16", 128), ("float32", 64)):
        assert smem == 262_672          # the refusal the streamed one lifts
