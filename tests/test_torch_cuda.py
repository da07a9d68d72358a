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


# --------------------------------------------------------------------------
# prefix sharing on the card
# --------------------------------------------------------------------------

def _serve_stream(params, cfg, dev, reqs, serial=False, **extra):
    """Serve a stream with prefix sharing (``serial``: each request is
    admitted once the previous one finished) -> (tokens, engine)."""
    from repro_torch.serving import EngineConfig, GenerationEngine
    eng = GenerationEngine(params, cfg, config=EngineConfig(
        max_len=64, page_size=8, prefill_chunk=8, prefix_sharing=True,
        **extra), device=dev)
    for r in reqs:
        eng.submit(r)
        if serial:
            eng.run()
    eng.run()
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def _chat(Request):
    prefix = list(range(1, 33))                 # 32 tokens = 4 pages of 8
    return [Request(prompt=prefix + [40 + i] * (1 + i % 3),
                    max_new_tokens=4, id=31_000 + i) for i in range(4)]


def _retire(Request):
    """tests/test_prefix_sharing.py's retire-and-fault stream: the idle
    prefix retires to swap for the long prompt and faults back for the
    third request."""
    prefix = list(range(1, 17))
    return [Request(prompt=prefix + [40], max_new_tokens=4, id=32_000),
            Request(prompt=[90 + i for i in range(30)], max_new_tokens=8,
                    id=32_001),
            Request(prompt=prefix + [41], max_new_tokens=4, id=32_002)]


def test_prefix_sharing_card_vs_cpu(card):
    """The small f32 model serving a shared-prefix stream: greedy tokens on
    the card identical to the CPU's, with prefix hits and no CoW split;
    and a prefix retired to swap under a small raw pool, faulted back
    through the page-decode kernel, with the same tokens as the CPU's."""
    from repro_torch.kvcache import kernels as kv
    from repro_torch.serving import Request
    small, p_cpu, p_gpu = _small_model()
    runs = {dev: _serve_stream(p, small, dev, _chat(Request), max_batch=3)
            for dev, p in (("cpu", p_cpu), ("cuda", p_gpu))}
    (cpu, e_cpu), (gpu, e_gpu) = runs["cpu"], runs["cuda"]
    assert gpu == cpu
    assert e_gpu.n_chunk_tokens == e_cpu.n_chunk_tokens < sum(
        len(r.prompt) for r in _chat(Request))
    assert e_gpu.paged.n_cow_splits == 0 and len(e_gpu.paged.prefix) >= 4
    before = kv.run.launches_by_path["fault"]
    tight = dict(max_batch=2, n_pages=7, swap_bytes=-1)
    g2, e2 = _serve_stream(p_gpu, small, "cuda", _retire(Request), True,
                           **tight)
    c2, _ = _serve_stream(p_cpu, small, "cpu", _retire(Request), True,
                          **tight)
    assert g2 == c2
    assert e2.paged.n_prefix_retired > 0
    assert kv.run.launches_by_path["fault"] > before


def _shared_pair(dev):
    """A card-or-CPU allocator with a 17-token prompt admitted to slots 0
    and 1 (blocks 0-1 shared through the index), random K/V in the pools."""
    from repro_torch.configs import get, smoke_variant
    from repro_torch.kvcache import SwapStore, paged
    cfg = smoke_variant(get("qwen3-8b"))
    pkv = paged.PagedKVCache(cfg, 2, 32, dtype=torch.float32, device=dev,
                             page_size=8, n_pages=10)
    pkv.enable_prefix_sharing()
    pkv.attach_swap(SwapStore())
    cache = pkv.init_cache()
    gen = torch.Generator().manual_seed(5)
    for kn in ("k_pool", "v_pool"):
        pool = cache["units"]["pos0"][kn]
        pool.copy_(torch.randn(pool.shape, generator=gen).to(dev))
    prompt = list(range(1, 18))
    for s, extra in ((0, 3), (1, 1)):
        cache, _ = pkv.admit_shared(cache, s, prompt, extra)
        pkv.register_prefix(s, prompt, 16)
    return pkv, cache, prompt


def test_cow_split_on_card(card):
    """A write window over a shared page splits it on the card: the new
    page equals the source in every layer's K and V, a chunk-like write
    into the new page leaves the source (still gathered by slot 0)
    untouched, and the allocator state equals the CPU's."""
    from repro_torch.kvcache import paged
    out = {}
    for dev in ("cpu", "cuda"):
        pkv, cache, _ = _shared_pair(dev)
        src = pkv._slot_pages[1][1]
        cache = pkv.make_writable(cache, 1, 10, 12)
        new = pkv._slot_pages[1][1]
        pools = cache["units"]["pos0"]
        for kn in ("k_pool", "v_pool"):
            assert torch.equal(pools[kn][:, new], pools[kn][:, src])
        before = pools["k_pool"][:, src].clone()
        kv = torch.full((1, pools["k_pool"].shape[2], 3,
                         pools["k_pool"].shape[4]), 7.0, device=dev)
        for u in range(pools["k_pool"].shape[0]):
            paged.page_write_chunk(pools["k_pool"][u],
                                   cache["page_table"][1],
                                   torch.arange(10, 13, device=dev), kv, 3)
        assert torch.equal(pools["k_pool"][:, src], before)
        assert bool((pools["k_pool"][:, new, :, 2:5] == 7.0).all())
        assert pkv.n_cow_splits == 1 and pkv._ref[src] == 2
        out[dev] = (pkv._slot_pages, dict(pkv._ref), list(pkv._free),
                    cache["page_table"].cpu(),
                    {kn: pools[kn].cpu() for kn in ("k_pool", "v_pool")})
    for a, b in zip(out["cuda"], out["cpu"]):
        if isinstance(a, dict) and isinstance(next(iter(a.values())),
                                              torch.Tensor):
            assert all(torch.equal(a[k], b[k]) for k in a)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_prefix_fault_through_page_decode_bit_exact(card):
    """An index-only prefix page retired to swap (host encode) and faulted
    back on a later match decodes through the page-decode kernel on the
    fault path into a page bit-identical to the one retired, in every
    layer's K and V."""
    from repro_torch.kvcache import kernels as kv
    pkv, cache, prompt = _shared_pair("cuda")
    pools = cache["units"]["pos0"]
    pids = pkv._slot_pages[0][:2]
    kept = {kn: pools[kn][:, pids].clone() for kn in ("k_pool", "v_pool")}
    for s in (0, 1):
        cache = pkv.release(cache, s)
    cache = pkv._reclaim_prefix(cache, pkv.n_pages)
    assert pkv.n_prefix_retired == 2 and pkv.free_pages == pkv.n_pages - 1
    for kn in ("k_pool", "v_pool"):           # the old pages are scribbled
        pools[kn][:, pids] = -1.0
    before = kv.run.launches_by_path["fault"]
    cache, matched = pkv.admit_shared(cache, 0, prompt, 1)
    torch.cuda.synchronize()
    assert matched == 16
    assert kv.run.launches_by_path["fault"] == before + 1
    back = pkv._slot_pages[0][:2]
    for kn in ("k_pool", "v_pool"):
        got = pools[kn][:, back].view(torch.int32)
        assert torch.equal(got, kept[kn].view(torch.int32)), kn


# --------------------------------------------------------------------------
# the mixture-of-experts family (moonshot-v1-16b-a3b's shapes)
# --------------------------------------------------------------------------

def test_decode_kernel_on_3d_expert_container(card):
    """B1 on one layer's expert leaf (E, d, ff) compressed as one container:
    fp8 bits bit-exact, and ``materialize`` writes the bf16 expert stack in
    its shape."""
    from repro_torch.core import store
    w = torch.randn((64, 256, 176), generator=card, device="cuda") * 0.06
    bits = fp8.cast_to_fp8_bits(w)
    ct = store.compress_stacked(bits[None])           # one layer
    a = ct.layer(0).arrays
    args = (a["payload"], a["signmant"], a["lj_limit"], a["first_lj"],
            a["offset"], a["perm"])
    kw = dict(sym_per_lane=ct.meta.sym_per_lane, n_elem=ct.meta.n_elem)
    got = ops.decode_ecf8(*args, **kw)
    assert torch.equal(got, ecf8_decode.plain(*args, **kw))
    assert torch.equal(got, bits.reshape(-1))
    m = store.materialize(ct.layer(0), "bfloat16")
    assert m.shape == (64, 256, 176) and m.dtype == torch.bfloat16
    assert torch.equal(m, bits.view(fp8.FP8_DTYPE).to(torch.bfloat16))


@pytest.mark.parametrize("T", [13, 451])
def test_flash_kernel_group_size_one(card, T):
    """B4 at moonshot's heads: 16 query and 16 KV heads of 128."""
    def rnd():
        return torch.randn((1, 16, T, 128), generator=card,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(), rnd(), rnd()
    got = ops.flash_attention(q, k, v, True, 0.0)
    want = flash_fwd.plain(q, k, v, True, 0.0)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


def test_kv_page_decode_moonshot_page(card):
    """B3 at moonshot's page (16 KV heads x 16 positions x 128, bf16) and
    its cold-slot stride budget: bit-exact, by the instance the wrapper
    picks for that shape."""
    from repro_torch.kvcache import codec, kernels as kv
    n = 16 * 16 * 128
    pages = [(torch.randn(n, generator=card, device="cuda") * s)
             .to(torch.bfloat16) for s in (0.02, 1.0, 40.0)]
    stride = -(-codec.sym_per_lane(n) * codec.plane_spec("bfloat16")[0]
               // 8)
    inst = kv.instance(stride, codec.sm_bytes("bfloat16", n))
    args = _coded_pages(pages, stride)
    before = kv.run.launches_by_instance[inst]
    got = ops.decode_pages(*args, n_elem=n, dtype_name="bfloat16")
    assert kv.run.launches_by_instance[inst] == before + 1
    for i, p in enumerate(pages):
        assert torch.equal(got[i].view(torch.int16),
                           p.view(torch.int16))


def test_moe_layer_card_vs_cpu_and_repeatable(card):
    """The MoE layer at capacity factor 1.25 (tokens dropped) on ECF8
    weights: f32 on the card within 1e-5 of the CPU, and bf16 bit-equal
    over two runs on the card (the combine adds without atomics)."""
    import dataclasses
    from repro_torch.configs import get, smoke_variant
    from repro_torch.core import store
    from repro_torch.models import model as M, moe
    cfg = dataclasses.replace(smoke_variant(get("moonshot-v1-16b-a3b")),
                              capacity_factor=1.25)
    p_cpu, _ = store.compress_tree(M.init_params(cfg, 0, "cpu"),
                                   min_elems=4096, out_dtype="float32")
    layer = M._layer(p_cpu["units"]["pos0"], 0)["moe"]

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if store.is_compressed(tree):
            return store.CompressedTensor(
                {k: a.cuda() for k, a in tree.arrays.items()}, tree.meta)
        return tree.cuda()

    x = torch.randn((3, 29, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, _ = moe.moe_apply(layer, x, cfg, dtype=torch.float32)
    got, _ = moe.moe_apply(to(layer), x.cuda(), cfg, dtype=torch.float32)
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    xb = x.cuda().to(torch.bfloat16)
    a, _ = moe.moe_apply(to(layer), xb, cfg, dtype=torch.bfloat16)
    b, _ = moe.moe_apply(to(layer), xb, cfg, dtype=torch.bfloat16)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("Tq,Tk,causal", [(13, 13, True), (130, 130, True),
                                          (451, 451, True), (37, 53, False),
                                          (130, 65, False)])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_flash_kernel_head_dim_256(card, dtype, tol, Tq, Tk, causal, cap):
    """B4 at gemma2-9b's heads: 16 query and 8 KV heads of 256, every
    output element against the plain version (a wrong swizzle offset of
    the 512-byte rows gives wrong numbers, not a fault)."""
    def rnd(h, t):
        return torch.randn((1, h, t, 256), generator=card,
                           device="cuda").to(dtype)

    q, k, v = rnd(16, Tq), rnd(8, Tk), rnd(8, Tk)
    before = flash_fwd.run.launches
    got = ops.flash_attention(q, k, v, causal, cap)
    assert flash_fwd.run.launches == before + 1
    want = flash_fwd.plain(q, k, v, causal, cap)
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_kv_page_decode_gemma2_page(card):
    """B3 at gemma2-9b's page (8 KV heads x 16 positions x 256, bf16) and
    its cold-slot stride budget: bit-exact, by the instance the wrapper
    picks for that shape."""
    from repro_torch.kvcache import codec, kernels as kv
    n = 8 * 16 * 256
    pages = [(torch.randn(n, generator=card, device="cuda") * s)
             .to(torch.bfloat16) for s in (0.02, 1.0, 40.0)]
    stride = -(-codec.sym_per_lane(n) * codec.plane_spec("bfloat16")[0]
               // 8)
    inst = kv.instance(stride, codec.sm_bytes("bfloat16", n))
    args = _coded_pages(pages, stride)
    before = kv.run.launches_by_instance[inst]
    got = ops.decode_pages(*args, n_elem=n, dtype_name="bfloat16")
    want = kv.plain(*args, n_elem=n, dtype_name="bfloat16")
    assert kv.run.launches_by_instance[inst] == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    for i, p in enumerate(pages):
        assert torch.equal(got[i].view(torch.int16), p.view(torch.int16))


# --------------------------------------------------------------------------
# the recurrent families (recurrentgemma-2b's and xlstm-350m's shapes)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T", [13, 451, 2048])
def test_flash_kernel_multi_query_head_dim_256(card, T):
    """B4 at recurrentgemma-2b's local layers: 10 query heads on one KV
    head of 256, no softcap, bf16; T = 2048 is a prompt that fills the
    window."""
    def rnd(h):
        return torch.randn((1, h, T, 256), generator=card,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(10), rnd(1), rnd(1)
    before = flash_fwd.run.launches
    got = ops.flash_attention(q, k, v, True, 0.0)
    assert flash_fwd.run.launches == before + 1
    want = flash_fwd.plain(q, k, v, True, 0.0)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("shape", [(4, 2560), (4, 256, 1024)])
def test_decode_kernel_on_recurrent_leaves(card, shape):
    """B1 on RG-LRU's ``conv_w`` (4, 2560) and sLSTM's 3-D ``r`` (heads,
    dh, 4 dh), each one layer of a stacked container: fp8 bits bit-exact,
    and ``materialize`` writes bf16 and f32 (the sLSTM cell's ``r``) in the
    leaf's shape."""
    from repro_torch.core import store
    w = torch.randn(shape, generator=card, device="cuda") * 0.1
    bits = fp8.cast_to_fp8_bits(w)
    ct = store.compress_stacked(bits[None])
    a = ct.layer(0).arrays
    args = (a["payload"], a["signmant"], a["lj_limit"], a["first_lj"],
            a["offset"], a["perm"])
    kw = dict(sym_per_lane=ct.meta.sym_per_lane, n_elem=ct.meta.n_elem)
    got = ops.decode_ecf8(*args, **kw)
    assert torch.equal(got, ecf8_decode.plain(*args, **kw))
    assert torch.equal(got, bits.reshape(-1))
    for dt in ("bfloat16", "float32"):
        m = store.materialize(ct.layer(0), dt)
        assert m.shape == shape
        assert torch.equal(m, bits.view(fp8.FP8_DTYPE).to(m.dtype))


def test_recurrentgemma_two_units_ecf8_tokens_equal_fp8(card):
    """recurrentgemma-2b at full width over 2 units (6 layers, ring of
    2048): the engine's greedy tokens from the ECF8 tree equal the fp8
    tree's, through B1 (every weight use) and B4 (the local layers'
    prefill of a prompt the window covers)."""
    import dataclasses
    from repro_torch.configs import get
    from repro_torch.launch import serve
    from repro_torch.serving import EngineConfig
    cfg = dataclasses.replace(get("recurrentgemma-2b"), n_layers=6)
    prompts = serve.make_prompts(cfg, 3, 0, lo=300, hi=700)
    runs = []
    for fmt in ("tpu", "none"):
        params, _, _, _ = serve.build_params(cfg, 0, fmt, baseline=False)
        b1, b4 = ecf8_decode.run.launches, flash_fwd.run.launches
        done, eng, _ = serve.serve(params, cfg, EngineConfig(
            max_batch=2, max_len=1024), prompts, 8)
        assert eng.cache_mode == "monolithic"
        assert flash_fwd.run.launches - b4 == 2 * len(prompts)
        assert (ecf8_decode.run.launches > b1) == (fmt == "tpu")
        runs.append([r.out_tokens for r in done])
        del params, eng
    assert runs[0] == runs[1]


@pytest.mark.parametrize("shape,scale", [((4096,), 0.02), ((300, 517), 1.0),
                                         ((64, 4096), 4096 ** -0.5),
                                         ((5,), 0.3)])
def test_fixedrate_decode_on_card_equals_cpu(card, shape, scale,
                                             monkeypatch):
    """An ECF8-FR container encoded on the card is byte-equal to the CPU's,
    and its plain decode on the card (slices carrying the escape count;
    no kernel, no host copy) gives the CPU's bits and bf16 values."""
    from repro_torch.core import fixedrate, store
    w = torch.randn(shape, generator=card, device="cuda") * scale
    bits = fp8.cast_to_fp8_bits(w)
    c = fixedrate.encode(bits)
    h = fixedrate.encode(bits.cpu())
    for f in ("codes", "escapes", "table", "signmant"):
        assert getattr(c, f).is_cuda
        assert torch.equal(getattr(c, f).cpu(), getattr(h, f)), f
    before = ecf8_decode.run.launches
    for slice_elems in (fixedrate.SLICE_ELEMS, 1000):
        monkeypatch.setattr(fixedrate, "SLICE_ELEMS", slice_elems)
        got = fixedrate.decode_plain(c.codes, c.escapes, c.table, c.signmant,
                                     n_elem=c.n_elem)
        assert got.is_cuda and torch.equal(got, bits.reshape(-1))
    ct = store.compress_array(bits, fmt="fixedrate")
    m = store.materialize(ct, "bfloat16")
    assert m.is_cuda and m.shape == shape
    assert torch.equal(m.cpu(), store.materialize(
        store.CompressedTensor({k: a.cpu() for k, a in ct.arrays.items()},
                               ct.meta), "bfloat16"))
    assert ecf8_decode.run.launches == before


@pytest.mark.parametrize("T", [13, 451, 2048])
def test_flash_kernel_llama4_heads(card, T):
    """B4 at llama4-scout's heads: 40 query heads on 8 KV heads of 128 (a
    group of 5), causal, no softcap, bf16."""
    def rnd(h):
        return torch.randn((1, h, T, 128), generator=card,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(40), rnd(8), rnd(8)
    before = flash_fwd.run.launches
    got = ops.flash_attention(q, k, v, True, 0.0)
    assert flash_fwd.run.launches == before + 1
    want = flash_fwd.plain(q, k, v, True, 0.0)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("fmt", ["tpu", "fixedrate"])
def test_llama4_smoke_card_vs_cpu(card, fmt):
    """llama4-scout's smoke stack (two ("local", "local", "local", "nope")
    units, window 32, heads of 64 for B4) from an ECF8-TPU or ECF8-FR tree:
    prefill at 37 tokens and 12 decode steps past the rings' wrap, the
    card's logits within 1e-4 of the CPU's; B1 launched for the TPU tree
    alone, B4 in the prefill."""
    import dataclasses
    from repro_torch.configs import get, smoke_variant
    from repro_torch.core import store
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_variant(get("llama4-scout-17b-a16e")),
                              head_dim=64)
    p_cpu, _ = store.compress_tree(M.init_params(cfg, 0, "cpu"), fmt=fmt,
                                   min_elems=4096, out_dtype="float32")

    def to_card(t):
        if isinstance(t, dict):
            return {k: to_card(v) for k, v in t.items()}
        if store.is_compressed(t):
            return store.CompressedTensor(
                {k: a.cuda() for k, a in t.arrays.items()}, t.meta)
        return t.cuda()

    p_gpu = to_card(p_cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(0))
    b1, b4 = ecf8_decode.run.launches, flash_fwd.run.launches
    l_cpu, c_cpu = M.prefill(p_cpu, cfg, toks, max_len=64)
    l_gpu, c_gpu = M.prefill(p_gpu, cfg, toks.cuda(), max_len=64)
    assert flash_fwd.run.launches - b4 == cfg.n_layers // cfg.unit
    err = float((l_gpu.cpu() - l_cpu).abs().max())
    for _ in range(12):
        tok = l_cpu[:, -1].argmax(-1, keepdim=True)
        l_cpu, c_cpu = M.decode_step(p_cpu, cfg, tok, c_cpu)
        l_gpu, c_gpu = M.decode_step(p_gpu, cfg, tok.cuda(), c_gpu)
        err = max(err, float((l_gpu.cpu() - l_cpu).abs().max()))
    assert err <= 1e-4
    assert (ecf8_decode.run.launches > b1) == (fmt == "tpu")


@pytest.mark.parametrize("Tq", [1500, 224])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 4e-3)])
def test_flash_kernel_non_causal_at_whisper_shapes(card, Tq, dtype, tol):
    """whisper-base's non-causal attention, 8 / 8 heads of 64 over 1500
    keys (a ragged last tile of 28): the encoder's 1500 queries and the
    prefill cross attention's 224.  The outputs average ~550 keys each
    (RMS ~0.043), so the bf16 bar is set from the measured 9.8e-4 (about
    one ulp of the largest output), not from the 2e-2 of the other shapes."""
    def rnd(t):
        return torch.randn((1, 8, t, 64), generator=card,
                           device="cuda").to(dtype)

    q, k, v = rnd(Tq), rnd(1500), rnd(1500)
    before = flash_fwd.run.launches
    got = ops.flash_attention(q, k, v, False, 0.0)
    assert flash_fwd.run.launches == before + 1
    want = flash_fwd.plain(q, k, v, False, 0.0)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_whisper_smoke_card_vs_cpu(card):
    """whisper's smoke encoder-decoder (2 + 2 layers, heads of 64 for B4,
    64 frames), f32, every matrix ECF8: the encoder output, the prefill
    logits and 8 decode steps over the cached cross K/V, the card within
    1e-4 of the CPU; B4 launched 6 times a prefill (2 encoder, 2 self, 2
    cross) and none a step."""
    import dataclasses
    from repro_torch.configs import get, smoke_variant
    from repro_torch.core import store
    from repro_torch.models import model as M
    cfg = dataclasses.replace(smoke_variant(get("whisper-base")),
                              head_dim=64, encoder_frames=64)
    p_cpu, _ = store.compress_tree(M.init_params(cfg, 0, "cpu"),
                                   min_elems=256, out_dtype="float32")

    def to_card(t):
        if isinstance(t, dict):
            return {k: to_card(v) for k, v in t.items()}
        if store.is_compressed(t):
            return store.CompressedTensor(
                {k: a.cuda() for k, a in t.arrays.items()}, t.meta)
        return t.cuda()

    p_gpu = to_card(p_cpu)
    gen = torch.Generator().manual_seed(0)
    frames = torch.randn((2, 64, cfg.d_model), generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=gen)
    e_cpu = M.encode_frames(p_cpu, cfg, frames, torch.float32)
    e_gpu = M.encode_frames(p_gpu, cfg, frames.cuda(), torch.float32)
    assert float((e_gpu.cpu() - e_cpu).abs().max()) <= 1e-4
    b1, b4 = ecf8_decode.run.launches, flash_fwd.run.launches
    l_cpu, c_cpu = M.prefill(p_cpu, cfg, toks, max_len=32, frames=frames)
    l_gpu, c_gpu = M.prefill(p_gpu, cfg, toks.cuda(), max_len=32,
                             frames=frames.cuda())
    assert flash_fwd.run.launches - b4 == 6
    err = float((l_gpu.cpu() - l_cpu).abs().max())
    for _ in range(8):
        tok = l_cpu[:, -1].argmax(-1, keepdim=True)
        l_cpu, c_cpu = M.decode_step(p_cpu, cfg, tok, c_cpu)
        l_gpu, c_gpu = M.decode_step(p_gpu, cfg, tok.cuda(), c_gpu)
        err = max(err, float((l_gpu.cpu() - l_cpu).abs().max()))
    assert err <= 1e-4
    assert flash_fwd.run.launches - b4 == 6
    assert ecf8_decode.run.launches > b1


# -- training: B4 with its row statistics, B5 (the flash backward) ----------

def _attn_inputs(card, B, Hq, Hkv, Tq, Tk, D, dtype):
    def rnd(h, t):
        return torch.randn((B, h, t, D), generator=card,
                           device="cuda").to(dtype)

    return rnd(Hq, Tq), rnd(Hkv, Tk), rnd(Hkv, Tk), rnd(Hq, Tq)


_TRAIN_SHAPES = [(4, 4, 48, 48, 64, True), (8, 2, 37, 37, 128, True),
                 (4, 2, 37, 53, 64, False), (16, 8, 130, 130, 256, True),
                 (32, 8, 200, 200, 128, True), (8, 8, 97, 300, 64, False),
                 (10, 1, 65, 65, 256, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Tq,Tk,D,causal", _TRAIN_SHAPES)
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_flash_fwd_stats_match_plain(card, dtype, Hq, Hkv, Tq, Tk, D,
                                     causal, cap):
    """o with the statistics is the same bits as o without them; m and l
    within 1e-5 of the plain version's, relative to their largest
    magnitude (f32 sums in another order)."""
    q, k, v, _ = _attn_inputs(card, 2, Hq, Hkv, Tq, Tk, D, dtype)
    o0 = flash_fwd.run(q, k, v, causal=causal, softcap=cap)
    o, m, l = flash_fwd.run(q, k, v, causal=causal, softcap=cap, stats=True)
    assert torch.equal(o.view(torch.uint8), o0.view(torch.uint8))
    _, m_p, l_p = flash_fwd.plain_stats(q, k, v, causal, cap)
    for got, want in ((m, m_p), (l, l_p)):
        assert got.dtype == torch.float32 and got.shape == (2, Hq, Tq)
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Hq,Hkv,Tq,Tk,D,causal", _TRAIN_SHAPES)
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_flash_bwd_matches_plain(card, dtype, tol, Hq, Hkv, Tq, Tk, D,
                                 causal, cap):
    """B5 against its plain version on the same residuals: dq, dk, dv
    within ``tol`` x the plain gradient's largest magnitude (f32 sums in
    another order; bf16 also rounds p and ds at the same points, from
    scores summed in another order)."""
    from repro_torch.kernels import flash_bwd
    q, k, v, do = _attn_inputs(card, 2, Hq, Hkv, Tq, Tk, D, dtype)
    o, m, l = flash_fwd.run(q, k, v, causal=causal, softcap=cap, stats=True)
    before = flash_bwd.run.launches
    got = flash_bwd.run(q, k, v, o, m, l, do, causal=causal, softcap=cap)
    assert flash_bwd.run.launches == before + 1
    want = flash_bwd.plain(q, k, v, o, m, l, do, causal, cap)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)


def test_flash_autograd_on_card_matches_cpu(card):
    """``ops.flash_attention`` under autograd: one B4 launch with stats and
    one B5 launch on the card, the gradients within 1e-5 (relative) of the
    CPU's plain path at f32; without gradients one B4 launch and no B5."""
    from repro_torch.kernels import flash_bwd
    q, k, v, do = _attn_inputs(card, 2, 8, 2, 77, 77, 64, torch.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
        b4, b5 = flash_fwd.run.launches, flash_bwd.run.launches
        o = ops.flash_attention(*leaves, True, 20.0)
        (o * do.to(dev)).sum().backward()
        if dev == "cuda":
            assert (flash_fwd.run.launches - b4,
                    flash_bwd.run.launches - b5) == (1, 1)
        grads.append([t.grad.cpu() for t in leaves])
    for g, w in zip(*grads):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    b4, b5 = flash_fwd.run.launches, flash_bwd.run.launches
    ops.flash_attention(q, k, v, True, 20.0)
    assert (flash_fwd.run.launches - b4, flash_bwd.run.launches - b5) == (1, 0)
