"""The plain flash-attention forward and the blockwise / decode attention of
the port against the JAX package (f32, tolerance 1e-5: the same math,
summed in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.kernels.flash_fwd import flash_fwd_pallas  # noqa: E402
from repro.models import flash_attention as ref_fa  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import flash_attention as fa  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ATOL = 1e-5


def _qkv(B, Hq, Hkv, Tq, Tk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Hq, Tq, D)) * 0.4).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, Tk, D)) * 0.4).astype(np.float32)
    v = (rng.normal(size=(B, Hkv, Tk, D)) * 0.4).astype(np.float32)
    return q, k, v


@pytest.fixture
def pallas_load(monkeypatch):
    """The reference Pallas kernel reads its K/V slices with ``pl.load``,
    which newer JAX releases dropped; indexing the ref is the same read."""
    if not hasattr(pl, "load"):
        monkeypatch.setattr(pl, "load", lambda ref, idx: ref[idx],
                            raising=False)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# tests/test_flash_attention.py:22's sweep, plus ragged lengths
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [0.0, 20.0])
@pytest.mark.parametrize("T", [48, 37])
def test_flash_forward_matches_reference_and_pallas(Hq, Hkv, causal, cap, T,
                                                   pallas_load):
    q, k, v = _qkv(2, Hq, Hkv, T, T, 16)
    got = fa.flash_attention(*_t(q, k, v), causal, cap, 16, 16).numpy()
    want = np.asarray(ref_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, cap, 16, 16))
    np.testing.assert_allclose(got, want, atol=ATOL)
    pallas = np.asarray(flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=cap, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_allclose(
        ops.flash_attention(*_t(q, k, v), causal, cap).numpy(), pallas,
        atol=ATOL)


def test_flash_forward_uneven_q_and_kv_lengths():
    q, k, v = _qkv(1, 4, 2, 37, 53, 8, seed=5)
    got = fa.flash_attention(*_t(q, k, v), False, 0.0, 16, 16).numpy()
    want = np.asarray(ref_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, 0.0, 16, 16))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_reference(causal):
    q, k, v = _qkv(2, 8, 2, 40, 40, 16, seed=1)
    got = layers.blockwise_attention(*_t(q, k, v), causal=causal, q_chunk=16,
                                     kv_chunk=16).numpy()
    want = np.asarray(ref_layers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=16, kv_chunk=16))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_decode_attention_per_slot_lengths_matches_reference():
    q, k, v = _qkv(3, 4, 2, 1, 64, 16, seed=2)
    kv_len = np.array([1, 17, 64], np.int32)
    got = layers.decode_attention(*_t(q, k, v),
                                  kv_len=torch.from_numpy(kv_len)).numpy()
    want = np.asarray(ref_layers.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rope_and_rms_norm_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) + 5
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)[None,
                                                                      None])
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=ATOL)


def test_scale_in_dtype_rounds_the_scalar_first():
    """bf16: the scalar is rounded to bf16 before the product, as JAX
    treats a weak-typed Python scalar."""
    x = torch.tensor([1.0, 3.0, -7.5], dtype=torch.bfloat16)
    got = fa.scale_in_dtype(x, 128 ** -0.5)
    want = jnp.asarray(np.array([1.0, 3.0, -7.5]), jnp.bfloat16) * (
        128 ** -0.5)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
