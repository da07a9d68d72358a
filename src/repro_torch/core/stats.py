"""Empirical exponent statistics (paper §2.1, Figure 1).

Utilities to measure exponent histograms / Shannon entropy of fp8 weight
tensors and to synthesize "trained-like" weights from the paper's own
statistical model (alpha-stable).  Host numpy, as the reference package's
module: the same functions, and the same weights from the same seeds.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fp8, theory

N_EXP_SYMBOLS = 16  # the 4-bit exponent field of e4m3fn


def _bits_np(x) -> np.ndarray:
    """The uint8 bit view of an fp8 tensor or array (numpy, on the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x if x.dtype == torch.uint8 else x.view(torch.uint8)).numpy()
    x = np.asarray(x)
    return x if x.dtype == np.uint8 else x.view(np.uint8)


def exponent_histogram(bits) -> np.ndarray:
    """Histogram (length 16) of the 4-bit exponent field of fp8 bit view."""
    exps = (_bits_np(bits).reshape(-1) >> 3) & 0x0F
    return np.bincount(exps, minlength=N_EXP_SYMBOLS).astype(np.int64)


def shannon_entropy(counts: np.ndarray) -> float:
    """Shannon entropy (bits/symbol) of an empirical histogram."""
    counts = np.asarray(counts, dtype=np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log2(p)).sum())


def tensor_exponent_entropy(w) -> float:
    """Exponent-field entropy (bits/weight) of an fp8 tensor (or its uint8
    bit view)."""
    return shannon_entropy(exponent_histogram(w))


def synthesize_fp8_weights(shape, alpha: float = 1.9, std: float = 0.15,
                           seed: int = 0) -> np.ndarray:
    """Synthesize fp8 weights following the paper's statistical law.

    Samples symmetric alpha-stable values (the paper's model of SGD-trained
    weights, §2.2.1), scales them to a typical trained-weight magnitude, and
    rounds to fp8 e4m3fn (through float32, as the reference's cast).
    Returns the raw uint8 bit view.
    """
    x = theory.sample_alpha_stable(shape, alpha=alpha, seed=seed)
    # scale so the central mass lands at |w| ~ std, like trained weights
    x = x * std
    # fp8 e4m3fn saturates at +-448; heavy tails would otherwise overflow
    x = np.clip(x, -448.0, 448.0)
    return fp8.cast_to_fp8_bits(torch.from_numpy(
        np.ascontiguousarray(x, dtype=np.float32))).numpy()


def alpha_fit_from_values(x: np.ndarray) -> float:
    """Estimate alpha from real-valued samples via the unclipped exponent law
    E = floor(log2|x|) (avoids fp8 subnormal-clipping bias)."""
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    x = x[np.isfinite(x) & (x != 0)]
    if x.size < 16:
        return float("nan")
    E = np.floor(np.log2(np.abs(x))).astype(np.int64)
    E -= int(np.bincount(E - E.min()).argmax()) + E.min()  # center at mode
    counts = np.bincount(np.abs(E))
    return theory.geometric_fit_alpha_onesided(counts)


def summarize_tensor(bits) -> dict:
    """Entropy / fitted-alpha / theory-bound summary for one tensor."""
    hist = exponent_histogram(bits)
    H = shannon_entropy(hist)
    alpha_hat = theory.geometric_fit_alpha(hist)
    lo, hi = (theory.exponent_entropy_bounds(alpha_hat)
              if np.isfinite(alpha_hat) else (float("nan"), float("nan")))
    return {
        "n": int(hist.sum()),
        "entropy_bits": H,
        "alpha_hat": alpha_hat,
        "bound_lo": lo,
        "bound_hi": hi,
        "hist": hist.tolist(),
    }
