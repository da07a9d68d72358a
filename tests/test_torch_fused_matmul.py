"""The port's fused ECF8 decode + matrix product (kernel B2's op) against the
JAX package: ``encode_tiled`` byte-identical to the reference's, the plain
version against the reference's Pallas kernel in interpret mode (the same
bf16 products in f32, summed in another order) and against the reference's
oracle at its own tolerance, and the weight path bit-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.core import stats  # noqa: E402
from repro.kernels import fused_decode_matmul as ref_fused  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402

from repro_torch.kernels import fused_decode_matmul as fused  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def pallas_store(monkeypatch):
    """The reference kernel writes its decoded rows with ``pl.store``,
    which newer JAX releases dropped; assigning through the ref is the same
    write."""
    if not hasattr(pl, "store"):
        def store(ref_, idx, val):
            ref_[idx] = val
        monkeypatch.setattr(pl, "store", store, raising=False)


def _tiled(K, N, S, seed, alpha=1.9):
    bits = stats.synthesize_fp8_weights((K, N), alpha=alpha, seed=seed)
    return bits, ref_fused.encode_tiled(bits, sym_per_lane=S), \
        fused.encode_tiled(torch.from_numpy(bits.copy()), sym_per_lane=S)


@pytest.mark.parametrize("K,N,S", [(64, 128, 32), (128, 256, 32),
                                   (512, 384, 256), (512, 384, 32)])
def test_encode_tiled_byte_identical_to_reference(K, N, S):
    _, want, got = _tiled(K, N, S, seed=K + N)
    for f in ("payload", "signmant", "lj_limit", "first_lj", "offset",
              "perm"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert (got.k, got.n, got.sym_per_lane, got.nbytes) == (
        want.k, want.n, want.sym_per_lane, want.nbytes)


@pytest.mark.parametrize("M,K,N", [(8, 64, 128), (16, 128, 256)])
def test_plain_matches_reference_pallas_kernel(M, K, N, pallas_store):
    bits, want_w, got_w = _tiled(K, N, 32, seed=K + N)
    x = np.random.default_rng(0).normal(size=(M, K)).astype(np.float32) * 0.1
    want = np.asarray(ref_fused.matmul_pallas(jnp.asarray(x), want_w,
                                              interpret=True))
    got = ops.fused_decode_matmul(torch.from_numpy(x), got_w)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # and the reference's oracle at the reference test's tolerance, through
    # the reference's copy and the port's
    oracle = np.asarray(ref_oracles.fused_decode_matmul_ref(x, bits))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(ref.fused_decode_matmul_ref(x, bits).numpy(),
                               oracle, rtol=1e-5, atol=1e-6)


def test_weight_path_bit_exact():
    """An identity input reads the decoded weight back exactly."""
    K, N, S = 64, 128, 32
    bits, _, tiled = _tiled(K, N, S, seed=5)
    got = ops.fused_decode_matmul(torch.eye(K), tiled)
    want = np.asarray(jnp.asarray(bits).view(jnp.float8_e4m3fn)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.fused_decode_matmul(
        torch.eye(K), tiled, out_dtype=torch.bfloat16).dtype == torch.bfloat16


def test_wrapper_refuses_cpu_tensors_and_plans_splits():
    """The kernel wrapper never falls back to the plain version; its launch
    plan takes a row block of 8, 32, 128 or 256 rows (so a tile is decoded
    at most ceil(M / 256) times a call), keeps every K split non-empty and
    fills at least one wave of the card's 132 SMs where the K tiles allow
    it."""
    _, _, tiled = _tiled(64, 128, 32, seed=1)
    before = fused.run.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused.run(torch.zeros(4, 64), tiled)
    assert fused.run.launches == before
    # qwen3-8b's wq / wi_gate / wo_mlp at S = 256, M = 4 and 512
    for M, TK, TN in [(4, 16, 32), (4, 16, 96), (4, 48, 32), (512, 16, 32),
                      (512, 16, 96), (512, 48, 32), (1, 2, 2), (65, 16, 2),
                      (200, 1, 1), (257, 16, 32)]:
        mb, split, per, pbufs = fused._plan(M, TK, TN, 256, 51)
        assert pbufs in (1, 2)
        assert mb in (8, 32, 128, 256) and mb >= min(M, 256)
        assert -(-M // mb) <= -(-M // 256)
        assert (split - 1) * per < TK <= split * per
        assert TN * -(-M // mb) * split >= min(132, TN * -(-M // mb) * TK)


@pytest.mark.parametrize("M,K,N,S", [(600, 64, 128, 32), (8, 48, 128, 24),
                                     (5, 40, 256, 8), (3, 60, 128, 20)])
def test_op_contract_matches_reference(M, K, N, S, pallas_store):
    """The inputs the reference's op computes and the kernel's first
    design refused: M above ``MAX_ROWS`` (cut into row blocks of at most
    512, one kernel launch each on the card) and tile depths S that are
    not a multiple of 16 (zero-padded in the kernel's shared memory).  The
    op on the CPU agrees with the reference's Pallas kernel in interpret
    mode (the same bf16 products in f32, summed in another order)."""
    bits, want_w, got_w = _tiled(K, N, S, seed=M + S)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    want = np.asarray(ref_fused.matmul_pallas(jnp.asarray(x), want_w,
                                              interpret=True))
    got = ops.fused_decode_matmul(torch.from_numpy(x), got_w)
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_op_cuts_rows_into_kernel_blocks(monkeypatch):
    """The op calls its kernel (here the plain version, on the CPU) on row
    blocks of at most ``MAX_ROWS``, and the blocks' rows equal one call
    over all rows."""
    _, _, tiled = _tiled(64, 128, 32, seed=2)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1100, 64)).astype(np.float32))
    whole = fused.plain(x, tiled)
    seen = []
    plain = fused.plain

    def spy(xb, t, out_dtype=torch.float32):
        seen.append(xb.shape[0])
        return plain(xb, t, out_dtype)

    monkeypatch.setattr(fused, "plain", spy)
    got = ops.fused_decode_matmul(x, tiled)
    assert seen == [512, 512, 76]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
