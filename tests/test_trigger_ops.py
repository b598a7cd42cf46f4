"""The oscilloscope trigger's batched building blocks against numpy.

``window_rows`` (per-row windows as one gather), ``jnp.cumsum`` (which
replaced a cumsum-as-matmul), and the search's ``correlation_dots`` /
``window_sums`` — each against a plain numpy reference.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from openmeters_tpu.analyzers.oscilloscope import (
    correlation_dots,
    window_rows,
    window_sums,
)


def _ref_rows(x, starts, length):
    starts = np.clip(starts, 0, x.shape[-1] - length)
    return np.stack([x[i, s : s + length] for i, s in enumerate(starts)])


def test_window_rows_matches_dynamic_slice():
    rng = np.random.default_rng(3)
    for s, n, length in [(16, 1024, 512), (8, 9603, 7200), (3, 257, 100)]:
        x = rng.standard_normal((s, n)).astype(np.float32)
        starts = rng.integers(0, n - length, s).astype(np.int32)
        got = np.asarray(window_rows(jnp.asarray(x), jnp.asarray(starts), length))
        np.testing.assert_array_equal(got, _ref_rows(x, starts, length))


def test_window_rows_clips_starts_like_dynamic_slice():
    x = np.arange(40, dtype=np.float32).reshape(2, 20)
    starts = np.asarray([-5, 30], np.int32)  # before the row, past its end
    got = np.asarray(window_rows(jnp.asarray(x), jnp.asarray(starts), 6))
    np.testing.assert_array_equal(got, np.stack([x[0, :6], x[1, 14:]]))


def test_window_rows_multi_window():
    rng = np.random.default_rng(4)
    s, n, length, w = 8, 2048, 300, 3
    x = rng.standard_normal((s, n)).astype(np.float32)
    starts = rng.integers(0, n - length, (s, w)).astype(np.int32)
    got = np.asarray(window_rows(jnp.asarray(x), jnp.asarray(starts), length))
    assert got.shape == (s, w, length)
    for k in range(w):
        np.testing.assert_array_equal(got[:, k], _ref_rows(x, starts[:, k], length))


def test_cumsum_matches_block_triangular_matmul_definition():
    """``jnp.cumsum`` gives what the removed matmul form defined: per
    128-sample block a lower-triangular 0/1 product, plus the exclusive
    prefix of the block totals (evaluated here in f64)."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((5, 7200)).astype(np.float32) ** 2
    blk = 128
    nb = -(-v.shape[1] // blk)
    vp = np.pad(v.astype(np.float64), ((0, 0), (0, nb * blk - v.shape[1])))
    intra = vp.reshape(5, nb, blk) @ np.triu(np.ones((blk, blk)))
    carry = np.cumsum(intra[..., -1], axis=-1) - intra[..., -1]
    want = (intra + carry[..., None]).reshape(5, -1)[:, : v.shape[1]]
    got = np.asarray(jnp.cumsum(jnp.asarray(v), axis=-1))
    np.testing.assert_allclose(got, want, rtol=2e-6)


def _ref_dots(work, template, anchor, n_offsets):
    s, k = template.shape
    out = np.zeros((s, n_offsets))
    w = work.astype(np.float64)
    for i in range(s):
        for o in range(n_offsets):
            lo = o + anchor[i]
            seg = np.zeros(k)
            src = w[i, max(lo, 0) : lo + k]
            seg[max(-lo, 0) : max(-lo, 0) + src.size] = src
            out[i, o] = seg @ template[i].astype(np.float64)
    return out


@pytest.mark.parametrize("s", [1, 3, 8])  # odd and single-stream batches
def test_correlation_dots_match_direct_sums(s):
    rng = np.random.default_rng(6 + s)
    wcap, kcap, n_off, nfft = 600, 256, 200, 1024
    work = rng.standard_normal((s, wcap)).astype(np.float32)
    template = rng.standard_normal((s, kcap)).astype(np.float32)
    anchor = rng.integers(-40, 40, s).astype(np.int32)
    got = np.asarray(
        correlation_dots(jnp.asarray(work), jnp.asarray(template),
                         jnp.asarray(anchor), nfft, n_off)
    )
    want = _ref_dots(work, template, anchor, n_off)
    # in-range offsets only: negative shifts read wrapped (masked) lags
    ok = np.arange(n_off)[None, :] + anchor[:, None] >= 0
    scale = np.abs(want).max()
    assert np.abs(got - want)[ok].max() < 1e-5 * scale


def test_correlation_dots_delta_template_extracts_windows():
    """A unit impulse at tap t turns the dots into a shifted copy of the
    work window: the search reads exactly the samples it should."""
    rng = np.random.default_rng(9)
    s, wcap, kcap, n_off = 4, 512, 128, 100
    work = rng.standard_normal((s, wcap)).astype(np.float32)
    taps = np.asarray([0, 5, 17, 127])
    template = np.zeros((s, kcap), np.float32)
    template[np.arange(s), taps] = 1.0
    got = np.asarray(
        correlation_dots(jnp.asarray(work), jnp.asarray(template),
                         jnp.zeros((s,), jnp.int32), 1024, n_off)
    )
    for i, t in enumerate(taps):
        np.testing.assert_allclose(got[i], work[i, t : t + n_off], atol=2e-5)


def test_window_sums_match_numpy():
    rng = np.random.default_rng(10)
    s, wcap, n_off = 5, 700, 300
    work = rng.standard_normal((s, wcap)).astype(np.float32)
    klen = rng.integers(50, 400, s).astype(np.int32)
    wlen = klen + rng.integers(0, 300, s).astype(np.int32)
    sx, sxx, wmean = (
        np.asarray(a) for a in window_sums(
            jnp.asarray(work), jnp.asarray(klen), jnp.asarray(wlen), n_off
        )
    )
    w = work.astype(np.float64)
    for i in range(s):
        for o in range(n_off):
            hi = min(o + klen[i], wcap)  # window_rows clips like the engine
            lo = min(o, wcap)
            np.testing.assert_allclose(sx[i, o], w[i, lo:hi].sum(), atol=2e-3)
            np.testing.assert_allclose(sxx[i, o], (w[i, lo:hi] ** 2).sum(),
                                       rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(wmean[i], w[i, : wlen[i]].mean(), atol=1e-5)
