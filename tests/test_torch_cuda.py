"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit (the kernels
are built with nvcc at first use); elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They import no JAX: the CPU parity tests (tests/test_torch_*.py) hold the
plain versions against the JAX package, and these hold the kernels against
the plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fp8, tpu_format  # noqa: E402
from repro_torch.kernels import ecf8_decode, flash_fwd, ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,spl", [((4096,), 32), ((300, 517), 256),
                                       ((64, 4096), 64), ((5,), 256)])
def test_decode_kernel_bit_exact(card, shape, spl):
    w = torch.randn(shape, generator=card, device="cuda") * 0.02
    bits = fp8.cast_to_fp8_bits(w)
    c = tpu_format.encode(bits, sym_per_lane=spl)
    args = (c.payload, c.signmant, c.lj_limit, c.first_lj, c.offset, c.perm)
    kw = dict(sym_per_lane=c.sym_per_lane, n_elem=c.n_elem)
    before = ecf8_decode.run.launches
    got = ops.decode_ecf8(*args, **kw)
    assert ecf8_decode.run.launches == before + 1
    assert torch.equal(got, ecf8_decode.plain(*args, **kw))
    assert torch.equal(got, bits.reshape(-1))


def test_decode_kernel_on_padded_stacked_layers(card):
    from repro_torch.core import store
    w = torch.stack([torch.randn((64, 512), generator=card, device="cuda")
                     * s for s in (1e-3, 0.05, 3.0)])
    bits = fp8.cast_to_fp8_bits(w)
    ct = store.compress_stacked(bits)
    for i in range(3):
        a = ct.layer(i).arrays
        args = (a["payload"], a["signmant"], a["lj_limit"], a["first_lj"],
                a["offset"], a["perm"])
        kw = dict(sym_per_lane=ct.meta.sym_per_lane, n_elem=ct.meta.n_elem)
        got = ecf8_decode.run(*args, **kw)
        assert torch.equal(got, ecf8_decode.plain(*args, **kw))
        assert torch.equal(got, bits[i].reshape(-1))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Hq,Hkv,Tq,Tk,D,causal", [
    (4, 4, 48, 48, 64, True), (8, 2, 37, 37, 128, True),
    (32, 8, 130, 130, 128, True), (4, 2, 37, 53, 64, False)])
@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_flash_kernel_matches_plain(card, dtype, tol, Hq, Hkv, Tq, Tk, D,
                                    causal, cap):
    def rnd(h, t):
        return torch.randn((2, h, t, D), generator=card,
                           device="cuda").to(dtype)

    q, k, v = rnd(Hq, Tq), rnd(Hkv, Tk), rnd(Hkv, Tk)
    got = ops.flash_attention(q, k, v, causal, cap)
    want = flash_fwd.plain(q, k, v, causal, cap)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


_BITS = {torch.uint8: torch.uint8, torch.bfloat16: torch.int16,
         torch.float16: torch.int16, torch.float32: torch.int32}


def _same_values(got, want):
    """Bit-equal, NaNs (whose payload the casts may set differently) by
    ``isnan``."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.uint8:
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(_BITS[got.dtype]), want[~nan].view(_BITS[got.dtype])))


def _decode_args(c):
    return ((c.payload, c.signmant, c.lj_limit, c.first_lj, c.offset,
             c.perm), dict(sym_per_lane=c.sym_per_lane, n_elem=c.n_elem))


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16, torch.float16,
                                       torch.float32])
@pytest.mark.parametrize("shape,spl", [((3, 1001), 32), ((5,), 256),
                                       ((300, 517), 256), ((37, 4099), 64),
                                       ((7, 129), 6)])
def test_decode_kernel_out_dtypes_bit_exact(card, out_dtype, shape, spl):
    w = torch.randn(shape, generator=card, device="cuda") * 0.05
    bits = fp8.cast_to_fp8_bits(w)
    args, kw = _decode_args(tpu_format.encode(bits, sym_per_lane=spl))
    before = ecf8_decode.run.launches_by_dtype[out_dtype or torch.uint8]
    got = ecf8_decode.run(*args, **kw, out_dtype=out_dtype)
    assert ecf8_decode.run.launches_by_dtype[
        out_dtype or torch.uint8] == before + 1
    want = ecf8_decode.plain(*args, **kw, out_dtype=out_dtype)
    assert _same_values(got, want)
    if out_dtype is not None:
        assert torch.equal(got, bits.reshape(-1).view(fp8.FP8_DTYPE)
                           .to(out_dtype))


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16, torch.float16,
                                       torch.float32])
def test_decode_kernel_all_256_codes(card, out_dtype):
    bits = (torch.arange(128 * 64 * 3 + 7, device="cuda") * 37 % 256).to(
        torch.uint8)
    args, kw = _decode_args(tpu_format.encode(bits, sym_per_lane=64))
    got = ops.decode_ecf8(*args, **kw, out_dtype=out_dtype)
    want = ecf8_decode.plain(*args, **kw, out_dtype=out_dtype)
    assert _same_values(got, want)
    if out_dtype is not None:
        assert int(torch.isnan(got).sum()) == int(
            ((bits & 0x7F) == 0x7F).sum())
        neg0 = got[bits == 0x80]
        assert bool((neg0 == 0).all()) and bool(torch.signbit(neg0).all())


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16, torch.float32])
def test_decode_kernel_misaligned_stacked_layers(card, out_dtype):
    """A layer slice of a stacked container starts its nibbles at
    ``i * ceil(n / 2)`` bytes, here not 16-byte aligned."""
    from repro_torch.core import store
    w = torch.stack([torch.randn((3, 1001), generator=card, device="cuda")
                     * s for s in (1e-3, 0.05, 3.0)])
    bits = fp8.cast_to_fp8_bits(w)
    ct = store.compress_stacked(bits, sym_per_lane=8)
    offsets = [ct.layer(i).arrays["signmant"].data_ptr() % 16
               for i in range(3)]
    assert any(offsets), offsets
    for i in range(3):
        a = ct.layer(i).arrays
        args = (a["payload"], a["signmant"], a["lj_limit"], a["first_lj"],
                a["offset"], a["perm"])
        kw = dict(sym_per_lane=ct.meta.sym_per_lane, n_elem=ct.meta.n_elem)
        got = ecf8_decode.run(*args, **kw, out_dtype=out_dtype)
        assert _same_values(got, ecf8_decode.plain(
            *args, **kw, out_dtype=out_dtype))
        w8 = bits[i].reshape(-1)
        assert _same_values(got, w8 if out_dtype is None else
                            w8.view(fp8.FP8_DTYPE).to(out_dtype))


def test_materialize_decodes_into_the_weight_dtype(card):
    """store.materialize on the card: one B1 launch that writes bf16, no
    fp8-bits launch (so no cast kernel follows it)."""
    from repro_torch.core import store
    w = torch.randn((256, 384), generator=card, device="cuda") * 0.05
    ct = store.compress_array(fp8.cast_to_fp8_bits(w))
    before = dict(ecf8_decode.run.launches_by_dtype)
    got = store.materialize(ct, "bfloat16")
    after = ecf8_decode.run.launches_by_dtype
    assert after[torch.bfloat16] == before.get(torch.bfloat16, 0) + 1
    assert after[torch.uint8] == before.get(torch.uint8, 0)
    assert got.dtype == torch.bfloat16 and got.shape == (256, 384)
    assert torch.equal(got, fp8.cast_to_fp8(w).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Tq", [1, 13, 65, 127, 451])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_flash_tensor_core_ragged(card, dtype, Tq, D, group, cap):
    Hkv = 2

    def rnd(h):
        return torch.randn((2, h, Tq, D), generator=card,
                           device="cuda").to(dtype)

    q, k, v = rnd(Hkv * group), rnd(Hkv), rnd(Hkv)
    got = ops.flash_attention(q, k, v, True, cap)
    want = flash_fwd.plain(q, k, v, True, cap)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Tq,Tk", [(13, 451), (130, 65), (64, 1)])
def test_flash_tensor_core_not_causal(card, dtype, Tq, Tk):
    def rnd(h, t):
        return torch.randn((1, h, t, 128), generator=card,
                           device="cuda").to(dtype)

    q, k, v = rnd(8, Tq), rnd(2, Tk), rnd(2, Tk)
    got = ops.flash_attention(q, k, v, False, 0.0)
    want = flash_fwd.plain(q, k, v, False, 0.0)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


# --------------------------------------------------------------------------
# the KV page decode (csrc/kv_page_decode.cu)
# --------------------------------------------------------------------------

def _coded_pages(pages, stride=None):
    """Host-coded pages -> the four decode inputs on the card, payloads
    zero-padded to one stride."""
    from repro_torch.kvcache import codec
    cps = [codec.encode_page(p) for p in pages]
    stride = stride or max(c.stride for c in cps)
    pay = torch.zeros((len(cps), stride, codec.LANES), dtype=torch.uint8)
    for i, c in enumerate(cps):
        pay[i, : c.stride] = torch.from_numpy(c.payload)
    rest = [torch.from_numpy(np.stack(a)) for a in (
        [c.signmant for c in cps], [c.tables() for c in cps],
        [c.perm for c in cps])]
    return [t.cuda() for t in [pay] + rest]


@pytest.mark.parametrize("dtype,n", [
    (torch.bfloat16, 8 * 16 * 128), (torch.float32, 1000),
    (torch.float8_e4m3fn, 4096), (torch.bfloat16, 129)])
def test_kv_page_decode_bit_exact(card, dtype, n):
    from repro_torch.kvcache import codec, kernels as kv
    name = codec.dtype_name(dtype)
    bits_t = codec.TORCH_BITS[name]
    pages = [(torch.randn(n, generator=card, device="cuda") * s).to(dtype)
             for s in (0.05, 1.0, 300.0)]
    pages.append(torch.full((n,), 0.75, device="cuda").to(dtype))  # 1 symbol
    raw = torch.randint(-(1 << 15), 1 << 15, (n,), generator=card,
                        device="cuda")                          # all codes
    pages.append(raw.to(bits_t).view(dtype) if name != "float32" else
                 torch.randint(-(1 << 31), (1 << 31) - 1, (n,),
                               generator=card, device="cuda",
                               dtype=torch.int32).view(torch.float32))
    args = _coded_pages(pages)
    # a never-written cold slot (all-zero leaves): decoded in bounds
    args = [torch.cat([a, torch.zeros_like(a[:1])]) for a in args]
    before = kv.run.launches, kv.run.launches_by_path["fault"]
    got = ops.decode_pages(*args, n_elem=n, dtype_name=name, path="fault")
    assert (kv.run.launches, kv.run.launches_by_path["fault"]) == (
        before[0] + 1, before[1] + 1)
    want = kv.plain(*args, n_elem=n, dtype_name=name)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (len(pages) + 1, n)
    assert torch.equal(got.view(bits_t), want.view(bits_t))
    for i, p in enumerate(pages):
        assert torch.equal(got[i].view(bits_t), p.reshape(-1).view(bits_t))


def test_kv_page_decode_wide_stride_and_refusals(card):
    from repro_torch.kvcache import codec, kernels as kv
    n = 8 * 16 * 128
    raw = torch.randint(-(1 << 15), 1 << 15, (n,), generator=card,
                        device="cuda").to(torch.int16).view(torch.bfloat16)
    args = _coded_pages([raw], stride=256)       # > 48 KB of shared memory
    got = kv.run(*args, n_elem=n, dtype_name="bfloat16")
    assert torch.equal(got[0].view(torch.int16), raw.view(torch.int16))
    # a stride above what the staged instance can hold goes to the
    # streamed one (it used to be refused)
    wide = _coded_pages([raw], stride=4096)
    assert kv.instance(4096, wide[1].shape[1]) == "streamed"
    before = kv.run.launches_by_instance["streamed"]
    got = kv.run(*wide, n_elem=n, dtype_name="bfloat16")
    assert kv.run.launches_by_instance["streamed"] == before + 1
    assert torch.equal(got[0].view(torch.int16), raw.view(torch.int16))
    with pytest.raises(ValueError, match="CUDA"):
        kv.run(*[a.cpu() for a in args], n_elem=n, dtype_name="bfloat16")
    with pytest.raises(ValueError, match="shapes"):
        kv.run(*args, n_elem=n, dtype_name="float32")


@pytest.mark.parametrize("dtype,page_size", [
    (torch.bfloat16, 128), (torch.float32, 64), (torch.float32, 128),
    (torch.bfloat16, 64)])
def test_kv_page_decode_large_pages(card, dtype, page_size):
    """qwen3-8b pages of 64 or 128 positions at a cold slot's stride
    budget, never-written slots among them: the streamed instance where
    the staged one cannot hold the page (bf16 at 128, f32 at 64 and 128),
    bit-exact against the plain version and lossless."""
    from repro_torch.kvcache import codec, kernels as kv
    name = codec.dtype_name(dtype)
    bits_t = codec.TORCH_BITS[name]
    n = 8 * page_size * 128
    budget = -(-codec.sym_per_lane(n) * codec.plane_spec(name)[0] // 8)
    pages = [(torch.randn(n, generator=card, device="cuda") * s).to(dtype)
             for s in (1e-3, 1.0, 300.0)]
    live = _coded_pages(pages, stride=budget)
    args = [torch.cat([a[:1], torch.zeros_like(a[:1]), a[1:]]) for a in live]
    inst = kv.instance(budget, live[1].shape[1])
    assert inst == ("staged" if (name, page_size) == ("bfloat16", 64)
                    else "streamed")
    before = kv.run.launches_by_instance[inst]
    got = ops.decode_pages(*args, n_elem=n, dtype_name=name)
    assert kv.run.launches_by_instance[inst] == before + 1
    want = kv.plain(*args, n_elem=n, dtype_name=name)
    torch.cuda.synchronize()
    assert torch.equal(got.view(bits_t), want.view(bits_t))
    for i, p in zip((0, 2, 3), pages):
        assert torch.equal(got[i].view(bits_t), p.reshape(-1).view(bits_t))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("n", [8 * 16 * 128, 1000])
def test_kv_page_decode_cold_slot_budget_and_empty_slots(card, dtype, n):
    """Pages padded to a cold slot's exact stride budget (the raw exponent
    plane), never-written slots interleaved among the live ones, and
    ``n_elem`` a multiple of 128 or not: bit-exact against the plain
    version, every live page lossless."""
    from repro_torch.kvcache import codec, kernels as kv
    name = codec.dtype_name(dtype)
    bits_t = codec.TORCH_BITS[name]
    exp_bits = codec.plane_spec(name)[0]
    budget = -(-codec.sym_per_lane(n) * exp_bits // 8)
    pages = [(torch.randn(n, generator=card, device="cuda") * s).to(dtype)
             for s in (1e-3, 0.05, 1.0, 300.0)]
    live = _coded_pages(pages, stride=budget)
    assert live[0].shape[1] == budget
    empty = [torch.zeros_like(a[:1]) for a in live]
    order = [None, 0, None, 1, 2, None, 3, None]       # None: never written
    args = [torch.cat([e if i is None else a[i:i + 1] for i in order])
            for a, e in zip(live, empty)]
    got = ops.decode_pages(*args, n_elem=n, dtype_name=name)
    want = kv.plain(*args, n_elem=n, dtype_name=name)
    torch.cuda.synchronize()
    assert torch.equal(got.view(bits_t), want.view(bits_t))
    for row, i in enumerate(order):
        if i is not None:
            assert torch.equal(got[row].view(bits_t),
                               pages[i].reshape(-1).view(bits_t))


# --------------------------------------------------------------------------
# the fused decode + matrix product (csrc/fused_decode_matmul.cu)
# --------------------------------------------------------------------------

def _tiled_weight(card, K, N, S):
    from repro_torch.kernels import fused_decode_matmul as fused
    w = torch.randn((K, N), generator=card, device="cuda") * K ** -0.5
    bits = fp8.cast_to_fp8_bits(w)
    return bits, fused.encode_tiled(bits, sym_per_lane=S)


@pytest.mark.parametrize("M,K,N,S", [(4, 512, 384, 256), (37, 256, 640, 32),
                                     (130, 1024, 256, 256)])
def test_fused_matmul_matches_plain(card, M, K, N, S):
    from repro_torch.kernels import fused_decode_matmul as fused
    _, tiled = _tiled_weight(card, K, N, S)
    x = torch.randn((M, K), generator=card, device="cuda")
    before = fused.run.launches
    got = ops.fused_decode_matmul(x, tiled)
    assert fused.run.launches == before + 1
    want = fused.plain(x, tiled)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == torch.float32
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-4, rel
    # no float atomics: a second launch gives the same bits
    assert torch.equal(ops.fused_decode_matmul(x, tiled), got)
    half = ops.fused_decode_matmul(x, tiled, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(half,
                                                        got.to(half.dtype))


def test_fused_matmul_weight_path_bit_exact(card):
    from repro_torch.kernels import fused_decode_matmul as fused
    K, N = 512, 256
    bits, tiled = _tiled_weight(card, K, N, 256)
    got = fused.run(torch.eye(K, device="cuda"), tiled)
    want = bits.view(fp8.FP8_DTYPE).to(torch.bfloat16).float()
    assert torch.equal(got, want)


def test_fused_matmul_refusals(card):
    from repro_torch.kernels import fused_decode_matmul as fused
    _, tiled = _tiled_weight(card, 256, 128, 32)
    with pytest.raises(ValueError, match="rows"):
        fused.run(torch.zeros((513, 256), device="cuda"), tiled)
    with pytest.raises(ValueError, match="rows"):
        fused.run(torch.zeros((4, 128), device="cuda"), tiled)
    with pytest.raises(ValueError, match="CUDA"):
        fused.run(torch.zeros((4, 256)), tiled)
    with pytest.raises(ValueError, match="shared memory"):
        big = fused.TiledECF8Weight(
            torch.zeros((1, 1, 1024, 128), dtype=torch.uint8, device="cuda"),
            torch.zeros((1, 1, 1024 * 64), dtype=torch.uint8, device="cuda"),
            *tiled_tables(tiled), k=1024, n=128, sym_per_lane=1024)
        fused.run(torch.zeros((4, 1024), device="cuda"), big)


def tiled_tables(tiled):
    return tiled.lj_limit, tiled.first_lj, tiled.offset, tiled.perm


@pytest.mark.parametrize("S", [32, 256])
@pytest.mark.parametrize("M", [1, 7, 8, 63, 64, 65, 255, 256, 257, 512])
def test_fused_matmul_row_blocks(card, M, S):
    """Every row block of the kernel's plan (8, 32, 128 and 256 rows, one
    or two warpgroups, partial blocks) and both sub-tile depths: within
    1e-4 of the plain version relative to its magnitude, two launches
    bit-equal, and one-hot rows reading decode(W) back bit for bit."""
    from repro_torch.kernels import fused_decode_matmul as fused
    K, N = 512, 256
    bits, tiled = _tiled_weight(card, K, N, S)
    x = torch.randn((M, K), generator=card, device="cuda")
    got = ops.fused_decode_matmul(x, tiled)
    want = fused.plain(x, tiled)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-4, rel
    assert torch.equal(ops.fused_decode_matmul(x, tiled), got)
    rows = torch.randperm(K, generator=torch.Generator().manual_seed(M))[:M]
    eye = torch.eye(K, device="cuda")[rows.cuda()]
    w = bits.view(fp8.FP8_DTYPE).to(torch.bfloat16).float()
    assert torch.equal(ops.fused_decode_matmul(eye, tiled), w[rows.cuda()])


@pytest.mark.parametrize("M,K,N,S", [
    (600, 512, 256, 256), (1100, 256, 128, 32), (8, 48, 128, 24),
    (37, 40, 256, 8), (130, 120, 128, 20), (300, 72, 384, 72)])
def test_fused_matmul_op_beyond_kernel_regime(card, M, K, N, S):
    """What the reference's op computes beyond the kernel's first contract:
    M above ``MAX_ROWS`` through the op's row blocks (one launch each), and
    tile depths S that are not a multiple of 16 (zero-padded in shared
    memory; S % 8 != 0 reads x element by element): within 1e-4 of the
    plain version relative to its magnitude, two calls bit-equal, and
    one-hot rows reading decode(W) back bit for bit."""
    from repro_torch.kernels import fused_decode_matmul as fused
    bits, tiled = _tiled_weight(card, K, N, S)
    x = torch.randn((M, K), generator=card, device="cuda")
    before = fused.run.launches
    got = ops.fused_decode_matmul(x, tiled)
    assert fused.run.launches == before + -(-M // fused.MAX_ROWS)
    want = fused.plain(x, tiled)
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-4, rel
    assert torch.equal(ops.fused_decode_matmul(x, tiled), got)
    eye = ops.fused_decode_matmul(torch.eye(K, device="cuda"), tiled)
    assert torch.equal(eye, bits.view(fp8.FP8_DTYPE).to(torch.bfloat16)
                       .float())


# --------------------------------------------------------------------------
# the monolithic decode step and the speculative verify, card vs CPU
# --------------------------------------------------------------------------

def _small_model():
    """A small f32 qwen3 (2 layers, d 256) with ECF8 weights: the CPU tree
    (plain versions) and its copy on the card (the kernels)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.core import store
    from repro_torch.models import model as M
    small = dataclasses.replace(
        get("qwen3-8b"), name="qwen3-small", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        dtype="float32")
    p_cpu, _ = store.compress_tree(M.init_params(small, 0, "cpu"),
                                   min_elems=4096, out_dtype="float32")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if store.is_compressed(tree):
            return store.CompressedTensor(
                {k: a.to(dev) for k, a in tree.arrays.items()}, tree.meta)
        return tree.to(dev)

    return small, p_cpu, to(p_cpu, "cuda")


def test_monolithic_decode_step_card_vs_cpu(card):
    """Decode steps over the per-slot contiguous cache, one slot stepping
    past the end of its row (the clamped write): logits on the card within
    1e-4 of the CPU's, B1 launched."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import splice_fragment
    small, p_cpu, p_gpu = _small_model()
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = M.init_cache(small, 3, 32, torch.float32, dev, per_slot=True)
        for slot, n in ((0, 29), (2, 9)):
            toks = (torch.arange(1, n + 1)[None] * (slot + 3)) % 500
            _, frag = M.prefill(params, small, toks.to(dev), max_len=32)
            cache = splice_fragment(cache, frag, slot)
        tok = torch.tensor([[5], [7], [9]], device=dev)
        logits = []
        for _ in range(6):
            lg, cache = M.decode_step(params, small, tok, cache)
            logits.append(lg.cpu())
            tok = (tok * 13 + 1) % small.vocab_size
        out[dev] = (torch.stack(logits), cache["cur_len"].cpu())
    assert out["cuda"][1].tolist() == [35, 6, 15]
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    assert err <= 1e-4, err


def test_verify_chunk_card_vs_cpu(card):
    """A verify window over a slot whose history has cold pages: logits of
    every row on the card within 1e-4 of the CPU's, the page-decode kernel
    launched from the verify, and the rollback leaving both allocators
    alike."""
    from repro_torch.kvcache import kernels as kv
    from repro_torch.kvcache import paged
    from repro_torch.models import model as M
    small, p_cpu, p_gpu = _small_model()
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        pc = paged.PagedKVCache(small, 2, 64, dtype=torch.float32,
                                device=dev, page_size=4, compress_cold=True)
        toks = torch.arange(1, 24)[None] % 500
        _, frag = M.prefill(params, small, toks.to(dev), max_len=64)
        cache = pc.admit(pc.init_cache(), 1, frag, 23)
        cache = pc.compress_cold_pages(cache, 1, 23)
        assert pc.has_cold
        cache = pc.ensure(cache, 1, 27)
        before = kv.run.launches_by_path["verify"]
        window = torch.tensor([[5, 17, 3, 250, 81]], device=dev)
        lg, cache = M.verify_chunk(params, small, window, cache, 1, 5)
        if dev == "cuda":
            assert kv.run.launches_by_path["verify"] > before
        cache = pc.rollback(cache, 1, 25)
        out[dev] = (lg.cpu(), cache["cur_len"].cpu(),
                    cache["page_table"].cpu(), list(pc._free))
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    assert err <= 1e-4, err
    for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
