"""The plain flash-attention backward of the port, and the CPU path of its
autograd Function, against ``jax.grad`` of the reference's flash attention
(its custom VJP), at ``tests/test_flash_attention.py``'s cases.

f32; every gradient within 1e-5 x the reference gradient's largest
magnitude (the same math summed in another order; the reference's own bar
against its autodiff oracle is 3e-5 absolute).  The row statistics m and
l of the forward are held within 1e-5 of the reference's likewise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import flash_attention as ref_fa  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import flash_attention as fa  # noqa: E402

RTOL = 1e-5


def _qkv(B, Hq, Hkv, Tq, Tk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, Hq, Tq, D)) * 0.4).astype(np.float32)
    k = (rng.normal(size=(B, Hkv, Tk, D)) * 0.4).astype(np.float32)
    v = (rng.normal(size=(B, Hkv, Tk, D)) * 0.4).astype(np.float32)
    w = rng.normal(size=(B, Hq, Tq, D)).astype(np.float32)
    return q, k, v, w


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= RTOL * float(np.abs(want).max()), (what, err)


def _ref_grads(q, k, v, w, causal, cap, chunk):
    def loss(q, k, v):
        return (ref_fa.flash_attention(q, k, v, causal, cap, chunk, chunk)
                * w).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))


CASES = [(Hq, Hkv, causal, cap, 40, 40) for Hq, Hkv in ((4, 4), (6, 2))
         for causal in (True, False) for cap in (0.0, 15.0)] + [
    (4, 2, False, 0.0, 37, 53), (4, 2, False, 15.0, 37, 53)]


@pytest.mark.parametrize("Hq,Hkv,causal,cap,Tq,Tk", CASES)
def test_plain_backward_matches_reference_grad(Hq, Hkv, causal, cap, Tq, Tk):
    """``flash_attention_fwd_stats`` (o, m, l) and ``flash_attention_bwd``
    against the reference's ``_flash_fwd_impl`` and ``jax.grad``, chunks
    of 16 (several q and kv blocks, ragged edges)."""
    q, k, v, w = _qkv(2, Hq, Hkv, Tq, Tk, 8, seed=3)
    o, m, l = fa.flash_attention_fwd_stats(
        *map(torch.from_numpy, (q, k, v)), causal, cap, 16, 16)
    ro, rm, rl = ref_fa._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, cap, 16, 16,
                                        0.0)
    for got, want, what in ((o, ro, "o"), (m, rm, "m"), (l, rl, "l")):
        _close(got.numpy(), want, what)
    grads = fa.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), o, m, l, torch.from_numpy(w),
        causal, cap, 16, 16)
    for got, want, what in zip(grads, _ref_grads(q, k, v, w, causal, cap, 16),
                               ("dq", "dk", "dv")):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, what)


@pytest.mark.parametrize("Hq,Hkv,causal,cap,Tq,Tk", CASES)
def test_autograd_function_on_cpu_matches_reference_grad(Hq, Hkv, causal,
                                                         cap, Tq, Tk):
    """``ops.flash_attention`` on inputs that require gradients goes
    through ``FlashAttention``: its CPU forward and backward (the plain
    versions at the default chunks) give the reference's gradients."""
    q, k, v, w = _qkv(2, Hq, Hkv, Tq, Tk, 8, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal, cap)
    assert o.grad_fn is not None and "FlashAttention" in type(
        o.grad_fn).__name__
    (o * torch.from_numpy(w)).sum().backward()
    want = _ref_grads(q, k, v, w, causal, cap, 512)
    for leaf, ref, what in zip(leaves, want, ("dq", "dk", "dv")):
        _close(leaf.grad.numpy(), ref, what)


def test_no_grad_inputs_take_the_forward_alone():
    """Without an input that requires a gradient (every serve path), the
    dispatcher returns the plain forward's output and builds no graph."""
    q, k, v, _ = _qkv(1, 4, 2, 19, 19, 8)
    o = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), True, 0.0)
    assert o.grad_fn is None
    with torch.no_grad():
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        assert ops.flash_attention(*leaves, True, 0.0).grad_fn is None


def test_no_probability_residuals_saved():
    """The reference's ``test_no_probability_residuals_saved``: what the
    Function saves for the backward is O(B * H * T * (D + 2)), no (T, T)
    tensor."""
    B, H, T, D = 1, 2, 256, 16
    q, k, v, _ = _qkv(B, H, H, T, T, D)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = ops.flash_attention(*leaves, True, 0.0)
    assert len(sizes) == 6                      # q, k, v, o, m, l
    assert max(sizes) <= B * H * T * D, sizes   # no (T, T) tensor saved
    o.sum().backward()
    assert all(t.grad is not None for t in leaves)


def test_kernel_wrapper_refuses_tensors_off_the_card():
    """``flash_bwd.run`` launches the kernel or raises: CPU tensors are
    refused before any build, with no fallback to the plain version."""
    from repro_torch.kernels import flash_bwd
    q, k, v, do = map(torch.from_numpy, _qkv(1, 4, 2, 19, 19, 64))
    o, m, l = fa.flash_attention_fwd_stats(q, k, v, True)
    before = flash_bwd.run.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd.run(q, k, v, o, m, l, do)
    assert flash_bwd.run.launches == before


@pytest.mark.parametrize("D,dtype", [(96, torch.bfloat16),
                                     (128, torch.float64)])
def test_kernel_attributes_refuse_missing_instances(D, dtype):
    """``flash_bwd.attributes`` names only the instances the source has
    (D 64 / 128 / 256 in f32, bf16, fp16)."""
    from repro_torch.kernels import flash_bwd
    with pytest.raises(ValueError, match="no instance"):
        flash_bwd.attributes(D, dtype)
