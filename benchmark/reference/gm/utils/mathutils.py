# Frozen copy of glimmer_mg_torch/utils/mathutils.py at commit ab5a5d3.
"""Numeric utilities mirroring reference src/Common/kelley.cc.

kernel_smooth (kelley.cc:107), log_add (145), coeff_log_add (157),
gamma_ml (178), geom_ml (200), normalize / log_normalize (217-243).
All computed in float64 like the C doubles; float32 call sites cast at the
boundaries (see io/features_file.py).
"""

from __future__ import annotations

import math

import numpy as np


def kernel_smooth(counts: np.ndarray, sigma: float, max_count: int = 0) -> np.ndarray:
    """Gaussian kernel smoothing, windowed exactly like the C loop."""
    counts = np.asarray(counts, dtype=np.float64)
    sigma2 = np.float32(sigma) ** 2  # C: pow(float sigma, 2) -> float
    band = int(4 * np.float32(sigma))
    n = len(counts)
    if max_count == 0:
        max_count = n
    gauss = np.exp(-(np.arange(band + 1, dtype=np.float64) ** 2) / (2 * float(sigma2)))
    out = counts.copy()
    for l in range(max_count):
        lk_start = max(0, l - band)
        lk_end = min(max_count, l + band)  # EXCLUSIVE (C loop `lk < lk_end`)
        ks = np.arange(lk_start, lk_end)
        g = gauss[np.abs(ks - l)]
        num = float(np.add.reduce(counts[lk_start:lk_end] * g))
        den = float(np.add.reduce(g))
        out[l] = num / den
    return out


def kernel_smooth_f32(counts: np.ndarray, sigma: float) -> np.ndarray:
    """float overload (kelley.cc:89): double smoothing, float store."""
    sm = kernel_smooth(np.asarray(counts, dtype=np.float64), sigma)
    return sm.astype(np.float32)


def log_add(l1: float, l2: float) -> float:
    if l1 == -math.inf and l2 == -math.inf:
        return l1
    if l1 > l2:
        return l1 + math.log(1.0 + math.exp(l2 - l1))
    return l2 + math.log(1.0 + math.exp(l1 - l2))


def coeff_log_add(l1: float, l2: float, coeff: float) -> float:
    # Reference compares against numeric_limits<double>::min() (tiny positive)
    if l1 < 2.2250738585072014e-308 and l2 < 2.2250738585072014e-308:
        return l1
    if l1 > l2:
        return l1 + math.log(coeff + (1.0 - coeff) * math.exp(l2 - l1))
    return l2 + math.log(1.0 - coeff + coeff * math.exp(l1 - l2))


def gamma_ml(dist: np.ndarray) -> tuple[float, float]:
    """ML Gamma fit (kelley.cc:178). Returns (k, theta)."""
    n_tot = 0.0
    sum_x = 0.0
    sum_lnx = 0.0
    for l in range(1, len(dist)):
        n_tot += dist[l]
        sum_x += l * dist[l]
        sum_lnx += math.log(float(l)) * dist[l]
    s = math.log(sum_x / n_tot) - sum_lnx / n_tot
    k = (3.0 - s + math.sqrt((s - 3) * (s - 3) + 24 * s)) / (12 * s)
    theta = sum_x / (n_tot * k)
    return k, theta


def geom_ml(dist: np.ndarray) -> float:
    n_tot = 0.0
    sum_x = 0.0
    for l in range(2, len(dist)):
        n_tot += dist[l]
        sum_x += l * dist[l]
    return n_tot / (sum_x + n_tot)


def normalize(dist: np.ndarray, min_l: int) -> None:
    s = 0.0
    for l in range(min_l, len(dist)):
        s += dist[l]
    dist[min_l:] /= s


def log_normalize(dist: np.ndarray, min_l: int) -> None:
    s = 0.0
    for l in range(min_l, len(dist)):
        s += math.exp(dist[l])
    dist[min_l:] -= math.log(s)


def f32_sequential_sum(values: np.ndarray) -> np.float32:
    """Strict left-to-right float32 accumulation (C `float sum += x` loops).
    np.cumsum is sequential by definition, so its last element matches."""
    v = np.asarray(values, dtype=np.float32)
    if len(v) == 0:
        return np.float32(0.0)
    return np.cumsum(v, dtype=np.float32)[-1]
