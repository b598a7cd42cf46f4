"""Per-column reassigned spectrogram against an f64 numpy reassignment.

The per-column path (``SpectrogramAnalyzer._reassigned``) serves the
configurations the sliding path refuses (zero padding beyond 2, hops over
a quarter window).  The reference here is a direct f64 transcription of
the reassignment (spectrogram/processor.rs:439-608): FFT Hilbert over the
doubled window, centre crop, three windowed transforms (h, dh/dt, (t-c)h),
frequency correction ``-Im(D conj B)/|B|^2`` and time correction
``Re(T conj B)/|B|^2`` in hops minus the Hilbert latency.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from openmeters_tpu.analyzers.spectrogram import (
    SpectrogramAnalyzer,
    SpectrogramConfig,
    derivative_window,
    time_weighted_window,
)
from openmeters_tpu.utils.windows import fft_bin_normalization, window_coefficients

RATE = 48_000.0


def reassign_f64(frame, n, pfft, hop, window):
    h = frame.size
    spec = np.fft.fft(frame.astype(np.float64))
    keep = np.zeros(h)
    keep[1 : h // 2 + 1] = 1.0  # DC and negative bins dropped, no doubling
    analytic = np.fft.ifft(spec * keep)
    center = (h - n) // 2
    a = analytic[center : center + n]
    w = window_coefficients(window, n).astype(np.float64)
    dw = derivative_window(window_coefficients(window, n)).astype(np.float64)
    tw = time_weighted_window(window_coefficients(window, n)).astype(np.float64)
    bins = pfft // 2 + 1
    b = np.fft.fft(a * w, pfft)[:bins]
    d = np.fft.fft(a * dw, pfft)[:bins]
    t = np.fft.fft(a * tw, pfft)[:bins]
    pow_raw = np.abs(b) ** 2
    inv = 1.0 / np.maximum(pow_raw, 1e-300)
    freq = np.arange(bins) * RATE / pfft - np.imag(d * np.conj(b)) * inv * RATE / (
        2 * np.pi
    )
    time = np.real(t * np.conj(b)) * inv / hop - center / hop
    power = pow_raw * fft_bin_normalization(w.astype(np.float32), pfft)
    return freq, time, power


@pytest.mark.parametrize(
    "n,hop,zpf",
    [
        (512, 64, 4),  # zero padding beyond 2: the padded-transform branch
        (512, 256, 1),  # low overlap: the frequency-domain stencil branch
    ],
)
def test_per_column_reassignment_matches_f64(n, hop, zpf):
    cfg = SpectrogramConfig(
        fft_size=n, hop_size=hop, use_reassignment=True,
        zero_padding_factor=zpf, block_frames=256,
    )
    ana = SpectrogramAnalyzer(cfg)
    assert not ana.use_sliding_reassigned  # served by the per-column path
    h = ana.read_len
    rng = np.random.default_rng(n + hop + zpf)
    t = np.arange(h) / RATE
    frames = np.stack([
        0.5 * np.sin(2 * np.pi * f * t + ph) + 0.002 * rng.standard_normal(h)
        for f, ph in zip(rng.uniform(300, 12_000, 4), rng.uniform(0, 6, 4))
    ]).astype(np.float32)[:, None, :]
    out = ana._reassigned(jnp.asarray(frames), jnp.ones((4, 1), bool))
    for i in range(4):
        freq, time, power = reassign_f64(
            frames[i, 0], n, n * zpf, hop, cfg.window
        )
        sig = power > power.max() * 1e-5  # within 50 dB of the peak
        got_f = np.asarray(out.freq_hz)[i, 0]
        got_t = np.asarray(out.time_offset)[i, 0]
        got_p = np.asarray(out.power)[i, 0]
        assert np.abs(got_f - freq)[sig].max() < 0.5  # Hz
        assert np.abs(got_t - time)[sig].max() < 1e-2  # hops
        rel = np.abs(got_p - power) / power.max()
        assert rel.max() < 1e-5
