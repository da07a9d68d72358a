"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and the CUDA toolkit (the kernels
are built with nvcc at first use); elsewhere they skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

They import no JAX: the CPU parity tests (tests/test_torch_*.py) hold the
plain versions against the JAX package, and these hold the kernels against
the plain versions.
"""
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
