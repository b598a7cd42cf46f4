"""Recursive (IIR) filters as time scans over batched lanes.

Reference parity: ``Biquad``/``Cascade``/``ThreeBand`` in ``src/dsp.rs:373-504``
and the 5-tap K-weighting direct-form-II-transposed filter in
``src/visuals/loudness/processor.rs:153-162``.

Batched formulation: recursion runs as one ``lax.scan`` over the time axis
whose body evaluates *all* sections on ``[lanes...]`` vectors — sequential
in time, fully vectorized across streams/channels; precision matches the sequential reference (no associative-scan reordering).

Coefficients are host-side numpy float64 cast at trace time; they are static
per (sample_rate, config) bucket, exactly like the reference's rebuilt-on-
rate-change filter plans.
"""

from __future__ import annotations

import enum
import functools
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


class FilterKind(enum.Enum):
    LOW_PASS = "low_pass"
    HIGH_PASS = "high_pass"


def biquad_rbj(kind: FilterKind, sample_rate: float, frequency: float) -> np.ndarray:
    """RBJ biquad (Q = 1/sqrt(2)) as ``[b0, b1, b2, a1, a2]`` float64.

    Matches reference ``Biquad::new`` (dsp.rs:402-420): frequency ratio
    clamped to [1e-6, 0.49].
    """
    ratio = min(max(frequency / sample_rate, 1.0e-6), 0.49)
    w = 2.0 * math.pi * ratio
    sin, cos = math.sin(w), math.cos(w)
    alpha = sin / math.sqrt(2.0)
    if kind is FilterKind.LOW_PASS:
        gain, sign = 1.0 - cos, 1.0
    else:
        gain, sign = 1.0 + cos, -1.0
    inv_a0 = 1.0 / (1.0 + alpha)
    return np.array(
        [
            gain * 0.5 * inv_a0,
            gain * inv_a0 * sign,
            gain * 0.5 * inv_a0,
            -2.0 * cos * inv_a0,
            (1.0 - alpha) * inv_a0,
        ],
        np.float64,
    )


def _biquad_step(coeffs, x, z0, z1, finite_reset):
    """One DF2T biquad sample: returns (y, z0', z1').

    Non-finite outputs reset state and emit 0, matching ``Biquad::process``
    (dsp.rs:422-432); the K-weighting path disables this (the reference's
    ``k_weighted`` has no per-sample check).
    """
    b0, b1, b2, a1, a2 = coeffs
    y = b0 * x + z0
    nz0 = b1 * x - a1 * y + z1
    nz1 = b2 * x - a2 * y
    if finite_reset:
        ok = jnp.isfinite(y)
        zero = jnp.zeros_like(y)
        y = jnp.where(ok, y, zero)
        nz0 = jnp.where(ok, nz0, zero)
        nz1 = jnp.where(ok, nz1, zero)
    return y, nz0, nz1


@partial(jax.jit, static_argnames=("coeffs", "finite_reset", "unroll"))
def biquad_cascade_scan(x, state, coeffs, finite_reset: bool = True, unroll: int = 8):
    """Run a cascade of biquads over time-major input.

    Args:
      x: ``[T, lanes...]`` input samples.
      state: ``[n_sections, 2, lanes...]`` DF2T states.
      coeffs: tuple of ``n_sections`` tuples ``(b0, b1, b2, a1, a2)`` (python
        floats; hashable so they become compile-time constants).
      finite_reset: per-sample non-finite state reset (dsp.rs:426-431).

    Returns ``(y [T, lanes...], new_state)``.
    """

    def step(z, xt):
        y = xt
        outs = []
        for i, c in enumerate(coeffs):
            y, nz0, nz1 = _biquad_step(c, y, z[i, 0], z[i, 1], finite_reset)
            outs.append(jnp.stack([nz0, nz1]))
        return jnp.stack(outs), y

    state, ys = jax.lax.scan(step, state, x, unroll=unroll)
    return ys, state


@partial(jax.jit, static_argnames=("b", "a", "unroll"))
def iir_df2t_scan(x, state, b, a, unroll: int = 8):
    """Generic order-N direct-form-II-transposed IIR over time-major input.

    ``b``: tuple of N+1 numerator taps; ``a``: tuple of N feedback taps
    (a1..aN, a0 normalized to 1); ``state``: ``[N, lanes...]``.  Identical
    recurrence to the reference's ``k_weighted`` (loudness/processor.rs:153-162).
    """
    n = len(a)
    assert len(b) == n + 1

    def step(z, xt):
        y = b[0] * xt + z[0]
        nz = [
            b[i + 1] * xt - a[i] * y + (z[i + 1] if i + 1 < n else 0.0)
            for i in range(n)
        ]
        return jnp.stack(nz), y

    state, ys = jax.lax.scan(step, state, x, unroll=unroll)
    return ys, state


def _crossover_coeffs(sample_rate: float, splits, cascade_n: int):
    """The 4 crossover filters of a ThreeBand (dsp.rs:477-487): LP@low,
    HP@low, LP@high, HP@high, each a cascade of ``cascade_n`` identical
    biquads (LR4 when ``cascade_n == 2``)."""
    low, high = splits
    kinds = [
        (FilterKind.LOW_PASS, low),
        (FilterKind.HIGH_PASS, low),
        (FilterKind.LOW_PASS, high),
        (FilterKind.HIGH_PASS, high),
    ]
    return tuple(
        tuple(tuple(biquad_rbj(kind, sample_rate, freq).tolist()) for _ in range(cascade_n))
        for kind, freq in kinds
    )


def three_band_init(lane_shape, cascade_n: int, dtype=jnp.float32):
    """Zero state for :func:`three_band_scan`: ``[4, cascade_n, 2, lanes...]``."""
    return jnp.zeros((4, cascade_n, 2, *lane_shape), dtype)


@partial(jax.jit, static_argnames=("sample_rate", "splits", "cascade_n", "cascade_high", "unroll"))
def three_band_scan(
    x,
    state,
    sample_rate: float,
    splits=(200.0, 2000.0),
    cascade_n: int = 1,
    cascade_high: bool = False,
    unroll: int = 8,
):
    """Three-way crossover over time-major input (dsp.rs:473-504).

    ``low = LP_lo(x)``; ``al = HP_lo(x)``; ``mid = LP_hi(al)``;
    ``high = HP_hi(al if cascade_high else x)``.

    Returns ``(bands [T, 3, lanes...], new_state)``.  ``cascade_n=2`` with
    ``cascade_high=True`` is the stereometer's LR4 splitter
    (stereometer/processor.rs:32); ``cascade_n=1, cascade_high=False`` is the
    waveform band filter (waveform/processor.rs:84).
    """
    filters = _crossover_coeffs(sample_rate, splits, cascade_n)

    def run_filter(idx, z, xin):
        y = xin
        outs = []
        for j, c in enumerate(filters[idx]):
            y, nz0, nz1 = _biquad_step(c, y, z[j, 0], z[j, 1], True)
            outs.append(jnp.stack([nz0, nz1]))
        return y, jnp.stack(outs)

    def step(z, xt):
        low, z0 = run_filter(0, z[0], xt)
        al, z1 = run_filter(1, z[1], xt)
        mid, z2 = run_filter(2, z[2], al)
        high, z3 = run_filter(3, z[3], al if cascade_high else xt)
        return jnp.stack([z0, z1, z2, z3]), jnp.stack([low, mid, high])

    state, bands = jax.lax.scan(step, state, x, unroll=unroll)
    return bands, state


@functools.lru_cache(maxsize=None)
def _three_band_state_space(sample_rate: float, splits, cascade_n: int,
                            cascade_high: bool):
    """The ThreeBand crossover (dsp.rs:473-504) as ONE MIMO state-space
    system: 1 input, 3 outputs (low/mid/high), state = the concatenated
    DF2T states of the four cascades in ``three_band_init`` order
    ``[LP_lo, HP_lo, LP_hi, HP_hi] x [section] x [z0, z1]``.

    Returns float64 ``(A [n,n], B [n], C [3,n], D [3])``.
    """
    f = _crossover_coeffs(sample_rate, splits, cascade_n)
    (a1, b1, c1, d1) = _sos_state_space(f[0])  # LP_lo(x) -> low
    (a2, b2, c2, d2) = _sos_state_space(f[1])  # HP_lo(x) -> al
    (a3, b3, c3, d3) = _sos_state_space(f[2])  # LP_hi(al) -> mid
    (a4, b4, c4, d4) = _sos_state_space(f[3])  # HP_hi(al or x) -> high
    ns = [a.shape[0] for a in (a1, a2, a3, a4)]
    n = sum(ns)
    o = np.cumsum([0, *ns])
    a = np.zeros((n, n))
    b = np.zeros((n,))
    for i, (ai, bi) in enumerate(((a1, b1), (a2, b2), (a3, b3), (a4, b4))):
        a[o[i]:o[i + 1], o[i]:o[i + 1]] = ai
    b[o[0]:o[1]] = b1
    b[o[1]:o[2]] = b2
    # LP_hi is driven by al = C2 s2 + d2 x
    a[o[2]:o[3], o[1]:o[2]] = np.outer(b3, c2)
    b[o[2]:o[3]] = b3 * d2
    if cascade_high:
        a[o[3]:o[4], o[1]:o[2]] = np.outer(b4, c2)
        b[o[3]:o[4]] = b4 * d2
    else:
        b[o[3]:o[4]] = b4
    c = np.zeros((3, n))
    d = np.zeros((3,))
    c[0, o[0]:o[1]] = c1
    d[0] = d1
    c[1, o[2]:o[3]] = c3
    c[1, o[1]:o[2]] = d3 * c2
    d[1] = d3 * d2
    c[2, o[3]:o[4]] = c4
    if cascade_high:
        c[2, o[1]:o[2]] = d4 * c2
        d[2] = d4 * d2
    else:
        d[2] = d4
    return a, b, c, d


@functools.lru_cache(maxsize=None)
def _three_band_lifted_mats(sample_rate: float, splits, cascade_n: int,
                            cascade_high: bool, lift: int):
    a, b, c, d = _three_band_state_space(
        sample_rate, splits, cascade_n, cascade_high
    )
    n = a.shape[0]
    powers = [np.eye(n)]
    for _ in range(lift):
        powers.append(a @ powers[-1])
    f = powers[lift]
    k = np.stack([powers[lift - 1 - i] @ b for i in range(lift)], axis=1)  # [n, L]
    g = np.stack([c @ powers[j] for j in range(lift)], axis=0)  # [L, 3, n]
    h = np.zeros((lift, 3, lift))
    for j in range(lift):
        h[j, :, j] = d
        for i in range(j):
            h[j, :, i] = c @ powers[j - 1 - i] @ b
    return tuple(m.astype(np.float32) for m in (f, k, g, h))


@partial(jax.jit, static_argnames=(
    "sample_rate", "splits", "cascade_n", "cascade_high", "lift"))
def three_band_lifted(x, state, sample_rate: float, splits=(200.0, 2000.0),
                      cascade_n: int = 1, cascade_high: bool = False,
                      lift: int = 32):
    """:func:`three_band_scan` via L-sample lifted blocks (matmuls).

    Identical LTI response to the sequential scan (f32 rounding), with the
    256-step serial recurrence collapsed to ``T/L`` block steps.  The
    analyzers use :func:`three_band_scan`; which of the two is faster on
    the GPU is not measured yet (ROADMAP G3).  Semantics deviation: the
    per-sample non-finite OUTPUT state reset (dsp.rs:426-431) is replaced
    by non-finite INPUT sanitization to 0 plus a post-block state flush —
    the transport already NaN-sanitizes the production path, so the two
    differ only for hand-fed non-finite samples, where both emit finite
    output.

    ``state``: the ``three_band_init`` layout ``[4, cascade_n, 2, lanes...]``.
    Returns ``(bands [T, 3, lanes...], new_state)``.
    """
    t = x.shape[0]
    lift = min(lift, t)
    rem = t % lift
    if rem:
        y0, state = three_band_lifted(
            x[: t - rem], state, sample_rate, splits, cascade_n,
            cascade_high, lift,
        )
        y1, state = three_band_lifted(
            x[t - rem:], state, sample_rate, splits, cascade_n,
            cascade_high, rem,
        )
        return jnp.concatenate([y0, y1], axis=0), state
    lanes = x.shape[1:]
    m = int(np.prod(lanes)) if lanes else 1
    f, k, g, h = _three_band_lifted_mats(
        float(sample_rate), tuple(splits), cascade_n, bool(cascade_high), lift
    )
    prec = jax.lax.Precision.HIGHEST
    x = jnp.where(jnp.isfinite(x), x, 0.0)
    xb = x.reshape(t // lift, lift, m)

    def step(s, x_blk):
        y = jnp.einsum("lpn,nm->lpm", g, s, precision=prec) + jnp.einsum(
            "lpj,jm->lpm", h, x_blk, precision=prec
        )
        s_next = jnp.einsum("nk,km->nm", f, s, precision=prec) + jnp.einsum(
            "nl,lm->nm", k, x_blk, precision=prec
        )
        return s_next, y

    n = f.shape[0]
    s0 = state.reshape(n, m)
    s0 = jnp.where(jnp.isfinite(s0), s0, 0.0)
    s_final, ys = jax.lax.scan(step, s0, xb)
    return (
        ys.reshape(t, 3, *lanes),
        s_final.reshape(state.shape),
    )


def flush_denormal_state(state, threshold: float = 1.0e-20):
    """Per-block denormal flush of recursive state (dsp.rs:391-393)."""
    return jnp.where(jnp.abs(state) < threshold, jnp.zeros_like(state), state)


# -- lifted (block state-space) IIR ------------------------------------------
#
# A DF2T biquad is the 2-state system  s' = A s + B x,  y = C s + D x  with
#   A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1 b0, b2 - a2 b0],  C = [1, 0],
#   D = b0.
# Cascading sections block-concatenates the state; lifting L samples turns
# the per-sample recurrence into one affine map per L-block:
#   Y_blk = G s + H X_blk        (G [L, n],  H [L, L] lower-triangular)
#   s'    = F s + K X_blk        (F = A^L,   K = [A^(L-1) B ... B])
# computed as matmuls.  All matrices are built host-side in float64, so the
# lifted path matches the sequential scan to f32 rounding while cutting the
# scan length (and its per-step dispatch overhead) by L.


def _sos_state_space(sections):
    """Cascade state-space (A, B, C, D) in float64 for DF2T sections."""
    a_c = None
    for b0, b1, b2, a1, a2 in sections:
        a = np.array([[-a1, 1.0], [-a2, 0.0]])
        b = np.array([b1 - a1 * b0, b2 - a2 * b0])
        c = np.array([1.0, 0.0])
        d = b0
        if a_c is None:
            a_c, b_c, c_c, d_c = a, b, c, d
        else:
            n = a_c.shape[0]
            a_new = np.zeros((n + 2, n + 2))
            a_new[:n, :n] = a_c
            a_new[n:, :n] = np.outer(b, c_c)
            a_new[n:, n:] = a
            b_new = np.concatenate([b_c, b * d_c])
            c_new = np.concatenate([d * c_c, c])
            d_new = d * d_c
            a_c, b_c, c_c, d_c = a_new, b_new, c_new, d_new
    return a_c, b_c, c_c, d_c


@functools.lru_cache(maxsize=None)
def _lifted_mats(sections, lift: int):
    a, b, c, d = _sos_state_space(sections)
    n = a.shape[0]
    powers = [np.eye(n)]
    for _ in range(lift):
        powers.append(a @ powers[-1])
    f = powers[lift]
    k = np.stack([powers[lift - 1 - i] @ b for i in range(lift)], axis=1)  # [n, L]
    g = np.stack([c @ powers[j] for j in range(lift)], axis=0)  # [L, n]
    h = np.zeros((lift, lift))
    for j in range(lift):
        h[j, j] = d
        for i in range(j):
            h[j, i] = c @ powers[j - 1 - i] @ b
    # cache plain numpy: jnp conversion inside a trace would leak tracers
    return tuple(m.astype(np.float32) for m in (f, k, g, h))


@functools.partial(jax.jit, static_argnames=("sections", "lift"))
def lifted_iir_scan(x, state, sections, lift: int = 32):
    """Cascade IIR over ``[T, lanes...]`` input via L-sample lifted blocks.

    ``state``: ``[n_state, lanes...]`` (2 per section, cascade-ordered; the
    values are exactly the DF2T (z0, z1) states of :func:`biquad_cascade_scan`).
    Returns ``(y [T, lanes...], new_state)``.  A trailing partial block is
    handled with a remainder-lift call.
    """
    t = x.shape[0]
    lift = min(lift, t)
    rem = t % lift
    if rem:
        y0, state = lifted_iir_scan(x[: t - rem], state, sections, lift)
        y1, state = lifted_iir_scan(x[t - rem :], state, sections, rem)
        return jnp.concatenate([y0, y1], axis=0), state
    lanes = x.shape[1:]
    m = int(np.prod(lanes)) if lanes else 1
    f, k, g, h = _lifted_mats(tuple(tuple(float(v) for v in s) for s in sections), lift)
    prec = jax.lax.Precision.HIGHEST

    xb = x.reshape(t // lift, lift, m)

    def step(s, x_blk):
        y = jnp.einsum("ln,nm->lm", g, s, precision=prec) + jnp.einsum(
            "lj,jm->lm", h, x_blk, precision=prec
        )
        s_next = jnp.einsum("nk,km->nm", f, s, precision=prec) + jnp.einsum(
            "nl,lm->nm", k, x_blk, precision=prec
        )
        return s_next, y

    s0 = state.reshape(state.shape[0], m)
    s_final, ys = jax.lax.scan(step, s0, xb)
    return ys.reshape(t, *lanes), s_final.reshape(state.shape)
