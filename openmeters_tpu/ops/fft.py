"""FFTs as batched matmuls: six-step Cooley–Tukey.

A length-``N = N1*N2`` DFT decomposes into dense ``[N1, N1]`` / ``[N2, N2]``
DFT matmuls plus a twiddle — ~N(N1+N2) complex MACs instead of N log N:

    X[k1*N2 + k2] = sum_{n1} W_N1^{n1 k1} * [ W_N^{n1 k2} *
                    sum_{n2} x[n1 + N1*n2] * W_N2^{n2 k2} ]

All factor matrices/twiddles are host-precomputed float32 constants; the
matmuls run at ``Precision.HIGHEST`` (full f32, never TF32) — spectral
parity tests hold the result to ~1e-6 of numpy's f64 FFT.  Whether this
route or ``jnp.fft`` (cuFFT on the GPU) is faster on a given device is a
measurement, recorded in PERF.md; the callers use this one route.

Used by the spectrogram/spectrum analyzers for rFFT, complex FFT (Hilbert)
and inverse FFT.  Shapes are static per config; radix split is chosen
automatically (balanced halves).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

@functools.lru_cache(maxsize=None)
def _factors(n: int) -> tuple[int, int]:
    """Balanced power-of-two split n = n1 * n2 (n1 >= n2)."""
    assert n & (n - 1) == 0 and n >= 4, f"fft size must be a power of two >= 4: {n}"
    lg = n.bit_length() - 1
    n1 = 1 << ((lg + 1) // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int):
    """(cos, -sin) [n, n] float32 so that F = cos + i*(-sin) is the DFT."""
    k = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n: int):
    """W_N^{n1 k2} as (re, im) [n1, n2] float32."""
    n1, n2 = _factors(n)
    ang = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _mm(x, mat):
    # full f32: a TF32 transform would floor the spectra near -66 dB
    return jnp.einsum(
        "...n,nk->...k", x, mat, precision=jax.lax.Precision.HIGHEST
    )


def _stage(re, im, mat_re, mat_im):
    """Complex matmul (re + i*im) @ (mat_re + i*mat_im) over the last axis."""
    rr = _mm(re, mat_re)
    ri = _mm(re, mat_im)
    if im is None:
        return rr, ri
    ir = _mm(im, mat_re)
    ii = _mm(im, mat_im)
    return rr - ii, ri + ir


def _fft_core(x_re, x_im, n: int, in_len=None, out_len=None):
    """Six-step DFT over the last axis.  Returns (re, im).

    ``in_len``: inputs beyond this index are known zero (zero-padded
    frames) — the first stage contracts only the ``ceil(in_len/n1)``
    non-zero n2 rows.  ``out_len``: only outputs ``[0, out_len)`` are
    needed — the second stage computes only ``ceil(out_len/n2)`` k1
    columns (the outputs are k1-major), cutting the dominant matmul.
    Returns length ``out_len`` when given, else ``n``.
    """
    n1, n2 = _factors(n)
    batch = x_re.shape[:-1]
    n2_cap = n2
    if in_len is not None and in_len < n:
        n2_cap = -(-int(in_len) // n1)
        x_re = x_re[..., : n2_cap * n1]
        x_im = None if x_im is None else x_im[..., : n2_cap * n1]
    # x[n1 + N1*n2] -> A[n1, n2]
    a_re = jnp.swapaxes(x_re.reshape(*batch, n2_cap, n1), -1, -2)
    a_im = (
        None
        if x_im is None
        else jnp.swapaxes(x_im.reshape(*batch, n2_cap, n1), -1, -2)
    )

    f2_re, f2_im = _dft_mats(n2)
    f1_re, f1_im = _dft_mats(n1)
    if n2_cap < n2:
        f2_re, f2_im = f2_re[:n2_cap], f2_im[:n2_cap]
    b_re, b_im = _stage(a_re, a_im, f2_re, f2_im)  # [.., n1, n2(k2)]

    tw_re, tw_im = _twiddle(n)
    c_re = b_re * tw_re - b_im * tw_im
    c_im = b_re * tw_im + b_im * tw_re

    k1_cap = n1
    if out_len is not None and out_len < n:
        k1_cap = -(-int(out_len) // n2)
        f1_re, f1_im = f1_re[:, :k1_cap], f1_im[:, :k1_cap]

    # D[k2, k1] = sum_n1 C[n1, k2] F1[n1, k1]
    c_re = jnp.swapaxes(c_re, -1, -2)  # [.., k2, n1]
    c_im = jnp.swapaxes(c_im, -1, -2)
    d_re, d_im = _stage(c_re, c_im, f1_re, f1_im)  # [.., k2, k1]

    # X[k1*N2 + k2] <- D[k2, k1]
    x_re_out = jnp.swapaxes(d_re, -1, -2).reshape(*batch, k1_cap * n2)
    x_im_out = jnp.swapaxes(d_im, -1, -2).reshape(*batch, k1_cap * n2)
    if out_len is not None and out_len < k1_cap * n2:
        x_re_out = x_re_out[..., :out_len]
        x_im_out = x_im_out[..., :out_len]
    return x_re_out, x_im_out


def _is_pow2(n: int) -> bool:
    return n >= 4 and (n & (n - 1)) == 0


@functools.lru_cache(maxsize=None)
def _half_twiddle(n: int):
    """``e^{-2πik/n}`` over k = 0..n//2 as (cos, -sin) float32 rows."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * k / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def rfft_mxu(x, n: int | None = None, in_len=None):
    """Real-input FFT -> complex one-sided spectrum ``[..., n//2+1]``.

    Pads/truncates the last axis to ``n`` like ``jnp.fft.rfft(x, n)``.
    Non-power-of-two sizes fall back to XLA's fft.

    ``in_len``: promise that inputs beyond this index are zero (zero-padded
    frames) — skips the corresponding first-stage matmul rows.

    Each real row SELF-PACKS into a half-size complex transform
    (z[m] = x[2m] + i·x[2m+1]; the DIT unpack recovers the one-sided
    spectrum): ~1.5x fewer MACs than pairing two rows into a full-size
    transform, no cross-row pack/unpack reshapes, and the hermitian
    bookkeeping shrinks to the half spectrum.
    """
    n = n or x.shape[-1]
    if not _is_pow2(n) or n < 8:
        return jnp.fft.rfft(x.astype(jnp.float32), n=n, axis=-1)
    if in_len is None and x.shape[-1] < n:
        in_len = x.shape[-1]  # zero-padded frame: stage 1 skips the pad rows
    if in_len is not None:
        in_len = min(max(int(in_len), 1), n)
        if x.shape[-1] > in_len:
            x = x[..., :in_len]  # declared zero beyond in_len
    x = _pad_last(x.astype(jnp.float32), n)
    batch_shape = x.shape[:-1]
    h = n // 2

    # z[m] = x[2m] + i·x[2m+1]
    pairs = x.reshape(*batch_shape, h, 2)
    ze, zo = pairs[..., 0], pairs[..., 1]
    h_in = None if in_len is None else -(-int(in_len) // 2)
    zr, zi = _fft_core(ze, zo, h, in_len=h_in)  # Z = FFT_h(z)

    # E[k] = (Z[k] + conj(Z[h-k]))/2 (FFT of evens), O[k] likewise for odds;
    # S[k] = E[k] + W_n^k·O[k] over k = 0..h (Z[h] := Z[0])
    zr_k = jnp.concatenate([zr, zr[..., :1]], axis=-1)
    zi_k = jnp.concatenate([zi, zi[..., :1]], axis=-1)
    zr_m = jnp.concatenate([zr[..., :1], zr[..., 1:][..., ::-1], zr[..., :1]], axis=-1)
    zi_m = jnp.concatenate([zi[..., :1], zi[..., 1:][..., ::-1], zi[..., :1]], axis=-1)
    e_re = 0.5 * (zr_k + zr_m)
    e_im = 0.5 * (zi_k - zi_m)
    o_re = 0.5 * (zi_k + zi_m)  # O = (Z - conj(Zm))/(2i)
    o_im = 0.5 * (zr_m - zr_k)
    wc, ws = _half_twiddle(n)
    s_re = e_re + wc * o_re - ws * o_im
    s_im = e_im + wc * o_im + ws * o_re
    return jax.lax.complex(s_re, s_im)


def fft_mxu(re, im, n: int | None = None):
    """Complex FFT over the last axis; takes/returns (re, im) float32 pairs."""
    n = n or re.shape[-1]
    if not _is_pow2(n):
        z = _pad_last(re.astype(jnp.float32), n) + (
            1j * _pad_last(im.astype(jnp.float32), n) if im is not None else 0.0
        )
        out = jnp.fft.fft(z, n=n, axis=-1)
        return jnp.real(out), jnp.imag(out)
    re = _pad_last(re.astype(jnp.float32), n)
    im = _pad_last(im.astype(jnp.float32), n) if im is not None else None
    return _fft_core(re, im, n)


def ifft_mxu(re, im, n: int | None = None, out_len=None):
    """Normalized inverse complex FFT via conjugation: ifft(z) = conj(fft(conj(z)))/n.

    ``out_len``: only outputs ``[0, out_len)`` are needed — skips the
    corresponding second-stage matmul columns (the dominant cost)."""
    n = n or re.shape[-1]
    if not _is_pow2(n):
        out = jnp.fft.ifft(_pad_last(re, n) + 1j * _pad_last(im, n), n=n, axis=-1)
        if out_len is not None:
            out = out[..., :out_len]
        return jnp.real(out), jnp.imag(out)
    fr, fi = _fft_core(
        _pad_last(re, n), -_pad_last(im, n), n, out_len=out_len
    )
    inv = 1.0 / n
    return fr * inv, -fi * inv


def irfft_mxu(spec_re, spec_im, n: int, out_len=None):
    """Inverse of :func:`rfft_mxu`: one-sided ``[..., n//2+1]`` (re, im) ->
    real ``[..., n]`` (or ``[..., out_len]``).

    Each row SELF-PACKS into a half-size complex inverse (the DIT unpack run
    backwards: Z[k] = E[k] + i·W_n^{-k}·(S[k]-conj(S[h-k]))/2, w = IFFT_h(Z),
    y[2m] = Re w[m], y[2m+1] = Im w[m]) — ~1.5x fewer MACs than the
    full-size mirror + cross-row pairing, and no full-spectrum reverse.
    ``out_len`` skips second-stage matmul columns for callers that only read
    a prefix (autocorrelation lags, search offsets).
    """
    if not _is_pow2(n) or n < 8:
        out = jnp.fft.irfft(spec_re + 1j * spec_im, n=n, axis=-1)
        if out_len is not None:
            out = out[..., :out_len]
        return out.astype(jnp.float32)
    h = n // 2  # spec has h+1 one-sided bins
    out_n = n if out_len is None else min(int(out_len), n)
    h_out = -(-out_n // 2)

    # E[k] = (S[k] + conj(S[h-k]))/2, O[k] = W_n^{+k}·(S[k] - conj(S[h-k]))/2
    # over k = 0..h-1; Z = E + i·O inverts the forward DIT pack.
    sr, si = spec_re[..., :h], spec_im[..., :h]
    mr = spec_re[..., 1:][..., ::-1]  # S[h-k].re, k = 0..h-1
    mi = spec_im[..., 1:][..., ::-1]
    e_re = 0.5 * (sr + mr)
    e_im = 0.5 * (si - mi)
    d_re = 0.5 * (sr - mr)  # D = (S - conj(Sm))/2
    d_im = 0.5 * (si + mi)
    wc, ws = _half_twiddle(n)  # e^{-2πik/n}; W^{+k} = (wc, -ws)
    wc, ws = wc[:h], ws[:h]
    o_re = d_re * wc + d_im * ws  # D · e^{+2πik/n}
    o_im = d_im * wc - d_re * ws
    z_re = e_re - o_im  # Z = E + i·O
    z_im = e_im + o_re
    wr, wi = ifft_mxu(z_re, z_im, h, out_len=h_out)
    out = jnp.stack([wr, wi], axis=-1).reshape(*z_re.shape[:-1], 2 * h_out)
    return out[..., :out_n] if out_n < 2 * h_out else out


def _pad_last(x, n: int):
    if x.shape[-1] == n:
        return x
    if x.shape[-1] > n:
        return x[..., :n]
    pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
    return jnp.pad(x, pad)
