"""Theory of exponent concentration (paper §2.2, Theorem 2.1 / Corollary 2.2).

If a weight ``X`` follows a symmetric alpha-stable law, its floating-point
exponent ``E = floor(log2 |X|)`` follows a discrete two-sided geometric
distribution with ratio ``q = 2**-alpha``:

    P(E = k) = (1 - q) / (1 + q) * q**|k|,   k in Z

whose Shannon entropy is bounded by

    alpha / (1 + 2**-alpha)  <=  H(E)  <=  alpha / (1 - 2**-alpha).

For alpha = 2 (the Gaussian-like case) the upper bound is 8/3 ~ 2.67 bits,
which with 1 sign bit and ~1 mantissa bit yields the paper's "FP4.67" limit.

Host numpy, a copy of the reference package's module: the same functions
and the same random streams from the same seeds.
"""
from __future__ import annotations

import math

import numpy as np


def two_sided_geometric_pmf(k: np.ndarray, alpha: float) -> np.ndarray:
    """P(E = k) for the two-sided geometric law of Theorem 2.1."""
    q = 2.0 ** (-alpha)
    k = np.asarray(k)
    return (1.0 - q) / (1.0 + q) * q ** np.abs(k)


def exponent_entropy_exact(alpha: float) -> float:
    """Exact Shannon entropy (bits) of the two-sided geometric exponent law.

    Closed form: with ``q = 2^-alpha`` and ``p0 = (1-q)/(1+q)``,
    ``H(E) = -log2(p0) + (2q / (1+q)) * |log2 q| / (1-q)``.
    """
    q = 2.0 ** (-alpha)
    p0 = (1.0 - q) / (1.0 + q)
    return -math.log2(p0) + (2.0 * q / (1.0 + q)) * (alpha / (1.0 - q))


def exponent_entropy_bounds(alpha: float) -> tuple[float, float]:
    """(lower, upper) entropy bounds of Theorem 2.1, in bits."""
    q = 2.0 ** (-alpha)
    return alpha / (1.0 + q), alpha / (1.0 - q)


def compression_limit_bits(alpha: float, mantissa_bits: int = 1) -> float:
    """Corollary 2.2: minimal average bits for a lossless float of alpha-stable
    weights = H(E) upper bound + sign + mantissa.  alpha=2, m=1 -> ~4.67."""
    return exponent_entropy_bounds(alpha)[1] + 1.0 + float(mantissa_bits)


def sample_alpha_stable(
    shape, alpha: float, scale: float = 1.0, seed: int = 0
) -> np.ndarray:
    """Sample a symmetric alpha-stable S_alpha(beta=0, gamma=scale, delta=0)
    via the Chambers–Mallows–Stuck construction (numpy, offline use)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-np.pi / 2, np.pi / 2, size=shape)
    w = rng.exponential(1.0, size=shape)
    if abs(alpha - 1.0) < 1e-9:
        x = np.tan(u)
    else:
        x = (
            np.sin(alpha * u)
            / np.cos(u) ** (1.0 / alpha)
            * (np.cos(u - alpha * u) / w) ** ((1.0 - alpha) / alpha)
        )
    return (scale * x).astype(np.float64)


def geometric_fit_alpha_onesided(abs_counts: np.ndarray) -> float:
    """Fit alpha from counts of |E - mode| (k = 0, 1, 2, ...): weighted
    least-squares on log2 P ~ -alpha * k."""
    counts = np.asarray(abs_counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return float("nan")
    p = counts / total
    ks = np.asarray([k for k, pk in enumerate(p) if pk > 0 and k > 0],
                    dtype=np.float64)
    if ks.size < 2:
        return float("inf")
    ys = np.log2(p[ks.astype(int)])
    w = p[ks.astype(int)]
    A = np.stack([ks, np.ones_like(ks)], axis=1)
    coef, *_ = np.linalg.lstsq(A * w[:, None], ys * w, rcond=None)
    return float(-coef[0])


def geometric_fit_alpha(exp_counts: np.ndarray) -> float:
    """Estimate alpha from an empirical exponent histogram by fitting the
    geometric decay rate ``q = 2^-alpha`` of the tail around the mode.

    Robust least-squares fit of log2 P(E=k) ~ -alpha * |k - mode| + c over
    bins with nonzero mass."""
    counts = np.asarray(exp_counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return float("nan")
    p = counts / total
    mode = int(np.argmax(p))
    ks, ys = [], []
    for k, pk in enumerate(p):
        if pk > 0 and k != mode:
            ks.append(abs(k - mode))
            ys.append(np.log2(pk))
    if len(ks) < 2:
        return float("inf")
    ks = np.asarray(ks, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    # weighted by probability mass so the dense bins dominate
    w = 2.0 ** ys
    A = np.stack([ks, np.ones_like(ks)], axis=1)
    Aw = A * w[:, None]
    coef, *_ = np.linalg.lstsq(Aw, ys * w, rcond=None)
    return float(-coef[0])
