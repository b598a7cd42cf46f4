"""Sliding-analytic reassigned spectrogram (ops/sliding_reassigned.py).

The stock 2048/64 reassigned default rides this path; physics bars are the
reference's (spectrogram/processor.rs:828-908) and cross-checks anchor it to
the exact per-column Hilbert path (analyzers/spectrogram.py::_reassigned).
"""

import os

import numpy as np
import pytest

from conftest import sine_wave
from openmeters_tpu.analyzers.spectrogram import (
    SpectrogramAnalyzer,
    SpectrogramConfig,
)
from openmeters_tpu.utils.windows import WindowKind


def stock(block_frames=256, **kw):
    cfg = SpectrogramConfig(
        fft_size=2048, hop_size=64, use_reassignment=True,
        block_frames=block_frames, **kw,
    )
    ana = SpectrogramAnalyzer(cfg)
    assert ana.use_sliding_reassigned  # the path under test
    return ana


def run(analyzer, signal, n_streams=1, reset_at=None):
    import jax

    b = analyzer.config.block_frames
    n = len(signal) // b * b
    carry = analyzer.init(n_streams)
    step = jax.jit(analyzer.step)
    cols = []
    for i in range(n // b):
        blk = np.tile(signal[i * b : (i + 1) * b][None, :], (n_streams, 1))
        reset = None
        if reset_at is not None and i == reset_at:
            reset = np.ones((n_streams,), bool)
        carry, out = step(carry, blk, reset)
        valid = np.asarray(out.valid)
        for k in range(valid.shape[1]):
            if valid[0, k]:
                cols.append(
                    {
                        f: np.asarray(getattr(out, f))[:, k]
                        for f in out._fields
                        if f != "valid"
                    }
                )
    return cols


def test_stock_config_uses_sliding_path():
    ana = stock()
    carry = ana.init(1)
    assert "srs" in carry
    # kill switch falls back to the per-column path
    os.environ["OPENMETERS_SLIDING_REASSIGNED"] = "0"
    try:
        assert not SpectrogramAnalyzer(
            SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=True)
        ).use_sliding_reassigned
    finally:
        del os.environ["OPENMETERS_SLIDING_REASSIGNED"]


def test_places_peak_frequency_time_power_at_stock_config():
    """Reference physics bars (processor.rs:828-860) on the sliding path:
    fractional-bin sines recover frequency <2 Hz, the time correction equals
    the Hilbert latency, and total power is conserved within 1%."""
    ana = stock()
    cfg = ana.config
    latency = cfg.fft_size // 2
    expected_time = -latency / cfg.hop_size

    for bin_f in [10.25, 200.75, 800.4]:
        freq = bin_f * cfg.sample_rate / cfg.fft_size
        cols = run(ana, sine_wave(freq, cfg.sample_rate, 8192))
        col = cols[-1]
        pv = col["point_valid"][0]
        powers = np.where(pv, col["power"][0], 0.0)
        peak = int(np.argmax(powers))
        assert pv[peak]
        assert abs(col["freq_hz"][0][peak] - freq) < 2.0, (
            bin_f, col["freq_hz"][0][peak],
        )
        assert abs(col["time_offset"][0][peak] - expected_time) < 0.05
        total_power = float(np.sum(powers)) * ana.power_scale
        assert abs(total_power - 1.0) < 0.01, (bin_f, total_power)


def test_matches_exact_hilbert_path_closely():
    """Column-for-column agreement with the per-column Hilbert path on the
    peak neighborhood: both approximate the same ideal analytic signal, so
    freq within 0.01 Hz, power within 0.1%, time within 1e-3 hops."""
    freq = 430.7
    sig = sine_wave(freq, 48_000.0, 16_384, 0.4)

    ana_slide = stock()
    cols_slide = run(ana_slide, sig)

    os.environ["OPENMETERS_SLIDING_REASSIGNED"] = "0"
    try:
        ana_exact = SpectrogramAnalyzer(
            SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=True)
        )
        assert not ana_exact.use_sliding_reassigned
        cols_exact = run(ana_exact, sig)
    finally:
        del os.environ["OPENMETERS_SLIDING_REASSIGNED"]

    a, b = cols_slide[-1], cols_exact[-1]
    k = int(np.argmax(np.where(b["point_valid"][0], b["power"][0], 0.0)))
    for kk in (k - 1, k, k + 1):
        assert abs(a["freq_hz"][0][kk] - b["freq_hz"][0][kk]) < 0.01
        assert abs(a["time_offset"][0][kk] - b["time_offset"][0][kk]) < 1e-3
        ratio = a["power"][0][kk] / b["power"][0][kk]
        assert abs(ratio - 1.0) < 1e-3


def test_block_size_consistency():
    """Different engine block sizes (the block size is fixed per config, so
    producer-side chunking can never vary it — this compares 256 vs 512)
    agree at energy-carrying bins.  Exact equality is not expected: the
    overlap-save Hilbert's segment boundaries move with the block size, so
    low-power bins differ at the approximation floor (both paths approximate
    the same ideal analytic signal)."""
    sig = (
        sine_wave(1000.0, 48_000.0, 12_288, 0.4)
        + sine_wave(3333.3, 48_000.0, 12_288, 0.2)
    ).astype(np.float32)
    cols_a = run(stock(block_frames=256), sig)
    cols_b = run(stock(block_frames=512), sig)
    assert len(cols_a) > 8 and len(cols_b) > 8
    m = min(len(cols_a), len(cols_b))
    a, b = cols_a[len(cols_a) - m :], cols_b[len(cols_b) - m :]
    for ca, cb in zip(a[-4:], b[-4:]):
        pb = cb["power"][0]
        sel = pb > pb.max() * 1e-4  # within 40 dB of the column peak
        assert sel.sum() > 4
        np.testing.assert_allclose(
            ca["freq_hz"][0][sel], cb["freq_hz"][0][sel], rtol=0, atol=0.5
        )
        np.testing.assert_allclose(
            ca["power"][0][sel], cb["power"][0][sel], rtol=5e-3, atol=1e-12
        )


def test_reset_masks_until_clean_refill():
    """After a mid-stream reset, no column is valid until the whole window
    provenance (h + hx tail) is post-reset, then columns return."""
    import jax

    ana = stock()
    cfg = ana.config
    sig = sine_wave(997.0, cfg.sample_rate, 24_576, 0.4)
    b = cfg.block_frames
    carry = ana.init(1)
    step = jax.jit(ana.step)
    saw_invalid_after_reset = False
    valid_again = False
    reset_step = 40
    for i in range(len(sig) // b):
        reset = np.ones((1,), bool) if i == reset_step else None
        carry, out = step(carry, sig[i * b : (i + 1) * b][None, :], reset)
        v = np.asarray(out.valid)
        if i == reset_step:
            assert not v.any()  # the reset hop itself can't emit
        if reset_step < i < reset_step + 20 and not v.any():
            saw_invalid_after_reset = True
        if i > reset_step + 20 and v.any():
            valid_again = True
            # post-refill columns are clean tone again
            col = np.asarray(out.power)[0, np.nonzero(v[0])[0][-1]]
            k = int(np.argmax(col))
            assert abs(
                np.asarray(out.freq_hz)[0, np.nonzero(v[0])[0][-1], k] - 997.0
            ) < 2.0
    assert saw_invalid_after_reset and valid_again


def test_silence_emits_no_points():
    """DC / silence produce no valid points (processor.rs:877-888)."""
    cols = run(stock(), np.zeros(16_384, np.float32))
    for col in cols:
        assert not np.any(col["point_valid"][0])


def test_long_stream_drift_bounded(rng):
    """Anchored sliding must not drift over thousands of hops: after ~18 s
    of noisy multitone audio, the last column still matches the exact
    Hilbert path."""
    import jax

    n_samples = 1 << 18  # ~5.5 s
    sig = (
        sine_wave(997.0, 48_000.0, n_samples, 0.3)
        + sine_wave(7311.0, 48_000.0, n_samples, 0.1)
        + rng.normal(0, 0.01, n_samples)
    ).astype(np.float32)

    ana = stock()
    carry = ana.init(1)
    step = jax.jit(ana.step)
    b = ana.config.block_frames
    for i in range(n_samples // b):
        carry, out = step(carry, sig[i * b : (i + 1) * b][None, :], None)

    os.environ["OPENMETERS_SLIDING_REASSIGNED"] = "0"
    try:
        ana_exact = SpectrogramAnalyzer(
            SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=True)
        )
        carry_e = ana_exact.init(1)
        step_e = jax.jit(ana_exact.step)
        for i in range(n_samples // b):
            carry_e, out_e = step_e(carry_e, sig[i * b : (i + 1) * b][None, :], None)
    finally:
        del os.environ["OPENMETERS_SLIDING_REASSIGNED"]

    k_last = int(np.asarray(out.valid)[0].nonzero()[0][-1])
    p = np.asarray(out.power)[0, k_last]
    pe = np.asarray(out_e.power)[0, k_last]
    peak = int(np.argmax(pe))
    # sliding-state error is relative to the spectrum peak (the same
    # property the classic sliding path has), so the drift bound applies to
    # bins within 40 dB of the peak — measured 0.006 dB / 0.05 Hz there
    sel = pe > pe[peak] * 1e-4
    db_err = np.abs(
        10 * np.log10(np.maximum(p[sel], 1e-30))
        - 10 * np.log10(np.maximum(pe[sel], 1e-30))
    )
    assert float(np.max(db_err)) < 0.05, float(np.max(db_err))
    f = np.asarray(out.freq_hz)[0, k_last]
    fe = np.asarray(out_e.freq_hz)[0, k_last]
    assert float(np.max(np.abs(f[sel] - fe[sel]))) < 0.2


def test_other_windows_supported():
    """Blackman-Harris has stencil radius 3: exercises the extended-edge
    reflection logic."""
    cfg = SpectrogramConfig(
        fft_size=2048, hop_size=64, use_reassignment=True,
        window=WindowKind.BLACKMAN_HARRIS,
    )
    ana = SpectrogramAnalyzer(cfg)
    assert ana.use_sliding_reassigned
    freq = 100.25 * cfg.sample_rate / cfg.fft_size
    cols = run(ana, sine_wave(freq, cfg.sample_rate, 8192))
    col = cols[-1]
    pv = col["point_valid"][0]
    powers = np.where(pv, col["power"][0], 0.0)
    peak = int(np.argmax(powers))
    assert abs(col["freq_hz"][0][peak] - freq) < 2.0
    total_power = float(np.sum(powers)) * ana.power_scale
    assert abs(total_power - 1.0) < 0.01


def test_unsupported_configs_fall_back():
    # low overlap -> per-column path
    assert not SpectrogramAnalyzer(
        SpectrogramConfig(fft_size=2048, hop_size=512, use_reassignment=True)
    ).use_sliding_reassigned
    # zero padding x2 now RIDES the sliding path (r5: padded-stencil slide)
    assert SpectrogramAnalyzer(
        SpectrogramConfig(
            fft_size=2048, hop_size=64, use_reassignment=True,
            zero_padding_factor=2,
        )
    ).use_sliding_reassigned
    # zero padding x4 falls back (kernel/stencil support is zpf <= 2)
    assert not SpectrogramAnalyzer(
        SpectrogramConfig(
            fft_size=2048, hop_size=64, use_reassignment=True,
            zero_padding_factor=4,
        )
    ).use_sliding_reassigned
    # tiny fft -> per-column path
    assert not SpectrogramAnalyzer(
        SpectrogramConfig(fft_size=256, hop_size=32, use_reassignment=True)
    ).use_sliding_reassigned


def test_zero_padding_2_physics_on_sliding_path():
    """zpf=2 rides the sliding path (reference stock setting,
    processor.rs:45-56): reference physics bars hold on padded transforms —
    frequency <2 Hz, time == Hilbert latency, power conserved within 1%."""
    ana = stock(zero_padding_factor=2)
    cfg = ana.config
    assert ana._sliding_reassigned.zpf == 2  # noqa: SLF001
    latency = cfg.fft_size // 2
    expected_time = -latency / cfg.hop_size

    for bin_f in [10.25, 200.75, 800.4]:
        freq = bin_f * cfg.sample_rate / cfg.fft_size
        cols = run(ana, sine_wave(freq, cfg.sample_rate, 8192))
        col = cols[-1]
        pv = col["point_valid"][0]
        powers = np.where(pv, col["power"][0], 0.0)
        peak = int(np.argmax(powers))
        assert pv[peak]
        assert abs(col["freq_hz"][0][peak] - freq) < 2.0, (
            bin_f, col["freq_hz"][0][peak],
        )
        assert abs(col["time_offset"][0][peak] - expected_time) < 0.05
        total_power = float(np.sum(powers)) * ana.power_scale
        assert abs(total_power - 1.0) < 0.01, (bin_f, total_power)


def test_zero_padding_2_matches_per_column_path():
    """Column-for-column parity of the padded sliding path against the
    per-column Hilbert+padded-FFT fallback at the peak neighborhood."""
    freq = 430.7
    sig = sine_wave(freq, 48_000.0, 16_384, 0.4)

    cols_slide = run(stock(zero_padding_factor=2), sig)

    os.environ["OPENMETERS_SLIDING_REASSIGNED"] = "0"
    try:
        ana_exact = SpectrogramAnalyzer(
            SpectrogramConfig(
                fft_size=2048, hop_size=64, use_reassignment=True,
                zero_padding_factor=2,
            )
        )
        assert not ana_exact.use_sliding_reassigned
        cols_exact = run(ana_exact, sig)
    finally:
        del os.environ["OPENMETERS_SLIDING_REASSIGNED"]

    a, b = cols_slide[-1], cols_exact[-1]
    k = int(np.argmax(np.where(b["point_valid"][0], b["power"][0], 0.0)))
    for kk in (k - 1, k, k + 1):
        assert abs(a["freq_hz"][0][kk] - b["freq_hz"][0][kk]) < 0.01
        assert abs(a["time_offset"][0][kk] - b["time_offset"][0][kk]) < 1e-3
        ratio = a["power"][0][kk] / b["power"][0][kk]
        assert abs(ratio - 1.0) < 1e-3
