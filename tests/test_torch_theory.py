"""The paper's §2 in the port (``core/stats.py``, ``core/theory.py``)
against the JAX package: every function equal to the reference's on the
same inputs, and the same random streams from the same seeds (exactly, or
within 1e-12 where a float result is compared)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import stats as ref_stats, theory as ref_theory  # noqa: E402

from repro_torch.core import fp8, stats, theory  # noqa: E402

ALPHAS = [0.5, 1.0, 1.2, 1.476, 1.5, 1.9, 2.0]


@pytest.mark.parametrize("alpha", ALPHAS)
def test_theory_closed_forms_match_reference(alpha):
    ks = np.arange(-60, 61)
    np.testing.assert_array_equal(theory.two_sided_geometric_pmf(ks, alpha),
                                  ref_theory.two_sided_geometric_pmf(ks,
                                                                     alpha))
    assert theory.exponent_entropy_exact(alpha) == \
        ref_theory.exponent_entropy_exact(alpha)
    assert theory.exponent_entropy_bounds(alpha) == \
        ref_theory.exponent_entropy_bounds(alpha)
    for m in (0, 1, 3):
        assert theory.compression_limit_bits(alpha, m) == \
            ref_theory.compression_limit_bits(alpha, m)


@pytest.mark.parametrize("alpha", [0.8, 1.0, 1.5, 1.9, 2.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_alpha_stable_samples_and_fits_match_reference(alpha, seed):
    x = theory.sample_alpha_stable((4000,), alpha=alpha, scale=0.7,
                                   seed=seed)
    want = ref_theory.sample_alpha_stable((4000,), alpha=alpha, scale=0.7,
                                          seed=seed)
    np.testing.assert_array_equal(x, want)
    np.testing.assert_allclose(stats.alpha_fit_from_values(x),
                               ref_stats.alpha_fit_from_values(want),
                               rtol=0, atol=1e-12)
    hist = np.bincount(np.abs(np.floor(np.log2(np.abs(x[x != 0])))
                              .astype(np.int64)))
    for fit in ("geometric_fit_alpha", "geometric_fit_alpha_onesided"):
        np.testing.assert_allclose(getattr(theory, fit)(hist),
                                   getattr(ref_theory, fit)(hist),
                                   rtol=0, atol=1e-12)


def test_fits_on_degenerate_histograms_match_reference():
    for h in (np.zeros(16), np.eye(16)[3] * 9, np.asarray([4, 0, 0, 1]),
              np.asarray([1, 2, 4, 8, 16])):
        for fit in ("geometric_fit_alpha", "geometric_fit_alpha_onesided"):
            a, b = getattr(theory, fit)(h), getattr(ref_theory, fit)(h)
            assert (a == b) or (np.isnan(a) and np.isnan(b)), (fit, h)
    assert np.isnan(stats.alpha_fit_from_values(np.ones(8)))


@pytest.mark.parametrize("shape,alpha,std,seed", [
    ((512, 512), 1.9, 0.15, 1), ((40_000,), 1.2, 0.15, 2),
    ((3, 1000), 1.6, 0.02, 5), ((7,), 2.0, 1.0, 0), ((4096,), 1.0, 40.0, 9)])
def test_synthesized_weights_equal_reference(shape, alpha, std, seed):
    """The same fp8 bits from the same seed (heavy tails clipped to +-448,
    cast through f32 as the reference's ``jnp`` cast)."""
    got = stats.synthesize_fp8_weights(shape, alpha=alpha, std=std,
                                       seed=seed)
    want = ref_stats.synthesize_fp8_weights(shape, alpha=alpha, std=std,
                                            seed=seed)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_histograms_entropy_and_summary_match_reference(seed):
    bits = ref_stats.synthesize_fp8_weights((64, 300), alpha=1.5 + seed / 10,
                                            seed=seed)
    np.testing.assert_array_equal(stats.exponent_histogram(bits),
                                  ref_stats.exponent_histogram(bits))
    hist = stats.exponent_histogram(bits)
    assert stats.shannon_entropy(hist) == ref_stats.shannon_entropy(hist)
    assert stats.shannon_entropy(np.zeros(16)) == 0.0
    want_h = ref_stats.tensor_exponent_entropy(bits)
    bits = bits.copy()
    for w in (bits, torch.from_numpy(bits), torch.from_numpy(bits).view(
            fp8.FP8_DTYPE), bits.view(np.uint8)):
        assert stats.tensor_exponent_entropy(w) == want_h
    got, want = (stats.summarize_tensor(bits),
                 ref_stats.summarize_tensor(bits))
    assert got.keys() == want.keys() and got["hist"] == want["hist"]
    for k in ("n", "entropy_bits", "alpha_hat", "bound_lo", "bound_hi"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


# -- the reference's own claims (tests/test_theory.py), held on the port -----

def test_fp467_limit():
    lo, hi = theory.exponent_entropy_bounds(2.0)
    assert abs(lo - 1.6) < 0.01 and abs(hi - 8.0 / 3.0) < 0.01
    assert abs(theory.compression_limit_bits(2.0) - 4.67) < 0.01


def test_entropy_decreases_with_alpha():
    hs = [theory.exponent_entropy_exact(a) for a in (0.25, 0.5, 1.0, 1.5,
                                                      2.0)]
    assert all(a > b for a, b in zip(hs, hs[1:]))


def test_synthesized_weights_match_paper_band():
    bits = stats.synthesize_fp8_weights((512, 512), alpha=1.9, seed=1)
    assert 1.5 < stats.tensor_exponent_entropy(bits) < 3.5
