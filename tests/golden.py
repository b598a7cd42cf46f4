"""Sequential float64 golden implementations for parity testing.

Straightforward per-sample numpy re-derivations of the textbook algorithms
(DF2T biquads, BS.1770 K-weighting, libebur128 polyphase true peak, trailing
window means) used to validate the batched formulations.
"""

from __future__ import annotations

import numpy as np

from openmeters_tpu.ops.truepeak import TRUE_PEAK_TAPS, polyphase_taps
from openmeters_tpu.utils.weighting import k_weighting_ba


def biquad_df2t(x: np.ndarray, coeffs, finite_reset: bool = True) -> np.ndarray:
    """Sequential DF2T biquad, float64 state."""
    b0, b1, b2, a1, a2 = [float(c) for c in coeffs]
    z0 = z1 = 0.0
    out = np.empty_like(x, dtype=np.float64)
    for i, xv in enumerate(np.asarray(x, np.float64)):
        y = b0 * xv + z0
        z0 = b1 * xv - a1 * y + z1
        z1 = b2 * xv - a2 * y
        if finite_reset and not np.isfinite(y):
            y, z0, z1 = 0.0, 0.0, 0.0
        out[i] = y
    return out


def k_weight(x: np.ndarray, sample_rate: float) -> np.ndarray:
    """5-tap K-weighting, float64 (BS.1770 pre-filter) via scipy lfilter —
    identical recurrence to the reference's ``k_weighted`` DF2T."""
    import scipy.signal

    b, a = k_weighting_ba(sample_rate)
    return scipy.signal.lfilter(b, a, np.asarray(x, np.float64))


def trailing_means(x: np.ndarray, windows, positions) -> np.ndarray:
    """Mean of x over trailing window W at each position p (samples seen = p)."""
    c = np.concatenate([[0.0], np.cumsum(np.asarray(x, np.float64))])
    out = np.zeros((len(windows), len(positions)))
    for wi, w in enumerate(windows):
        for pi, p in enumerate(positions):
            n = min(p, w)
            out[wi, pi] = (c[p] - c[p - n]) / max(n, 1)
    return out


def true_peak(x: np.ndarray, sample_rate: float) -> float:
    """Sequential polyphase true peak over the whole signal."""
    x = np.asarray(x, np.float32)
    peak = float(np.max(np.abs(x))) if len(x) else 0.0
    if sample_rate >= 192_000.0:
        return peak
    import scipy.signal

    factor = 4 if sample_rate < 96_000.0 else 2
    taps = polyphase_taps(factor)
    for p in range(taps.shape[1]):
        # y[n] = sum_i taps[i] * x[n-i] == FIR lfilter
        y = scipy.signal.lfilter(taps[:, p].astype(np.float64), [1.0], x)
        peak = max(peak, float(np.max(np.abs(y))))
    return peak


def lufs(mean_square: float, floor: float = -99.9) -> float:
    """BS.1770: -0.691 + 10*log10(sum of weighted mean squares)."""
    if mean_square <= 0.0:
        return floor
    return max(-0.691 + 10.0 * np.log10(mean_square), floor)


def stft_frames(x: np.ndarray, read_len: int, hop: int) -> list[np.ndarray]:
    """All full windows of ``read_len`` advancing by ``hop`` from sample 0."""
    out = []
    start = 0
    while start + read_len <= len(x):
        out.append(np.asarray(x[start : start + read_len], np.float64))
        start += hop
    return out
