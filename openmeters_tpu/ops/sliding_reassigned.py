"""Sliding-analytic reassigned spectrogram for high-overlap hops.

The reference's reassigned transform (spectrogram/processor.rs:439-608) per
column: Hilbert over ``h = 2n`` raw samples, crop the center ``n``, three
windowed FFTs (h, dh/dt, (t-c)h), per-bin corrections.  The per-column path
(``SpectrogramAnalyzer._reassigned``) computes exactly that chain per
column; at hop 64 consecutive columns share 97% of their windows and the
per-column FFT chain recomputes all of it.

This module restructures the computation around streaming state, the same
move that made the classic path fast (ops/sliding_stft.py):

1. **The analytic signal becomes a stream.**  The ideal Hilbert transform
   is time-invariant, so instead of one circular ``2n``-Hilbert per column,
   an overlap-save FFT step produces ``block`` new imaginary-part samples
   ``hx`` per engine hop into a ring aligned with the raw ring (margins
   ``>= n/2`` on both sides — the same protection the reference gets from
   cropping the center of its doubled window).
2. **The per-column spectra slide.**  For the window of analytic samples
   ``a = x + i*hx``, the unwindowed spectra

       U[k] = sum_m a[s+m] e^{-i2pi k m / n}
       V[k] = sum_m (m - c) a[s+m] e^{-i2pi k m / n}      (c = (n-1)/2)

   advance by one hop with delta matmuls and a phasor rotation:

       U' = rot * (U + sum_j (a_new[j] - a_old[j]) E[j])
       V' = rot * (V - hop * U
                   + sum_j ((c + hop - j) a_old[j]
                            + (n + j - hop - c) a_new[j]) E[j])

   with ``E[j,k] = e^{-i 2 pi k j / n}`` — O(hop * bins) per column instead
   of O(n log n) FFT chains.  Since ``x`` and ``hx`` are real, both states
   split into one-sided hermitian halves (``U = Ux + i*Uhx``), so all
   state lives in ``[S, n/2+1]`` arrays.
3. **Windowing stays in the frequency domain** (cosine-sum stencils over
   U; the derivative window's exact stencil DW[+-j] = +-i*pi*j*c_j), and
   the corrections are the reference's ratios.

Exact FFT re-anchoring every ``refresh_steps`` engine steps bounds f32
drift exactly like the classic sliding path.

Differences vs the reference's per-column circular Hilbert (both are
approximations of the ideal analytic signal): boundary effects enter
through the overlap-save margins (>= n/2 samples, error ~1/(pi*margin))
instead of through circular wrap at the same distance; and the h-window's
circular DC/Nyquist bins are not zeroed (affects only bins within the
stencil radius of 0 and n/2).  Both effects are orders of magnitude below
the physics tolerances (2 Hz frequency, 1e-4 hop time, 1% power).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.ops.fft import rfft_mxu
from openmeters_tpu.ops.framing import FrameBuffer
from openmeters_tpu.utils.windows import WindowKind

_STATE_KEYS = ("uxr", "uxi", "uhr", "uhi", "vxr", "vxi", "vhr", "vhi")


@dataclasses.dataclass(frozen=True)
class SlidingReassigned:
    fft_size: int  # n
    hop: int
    block: int
    window: WindowKind
    sample_rate: float
    # zero-padding factor: transforms run at length n*zpf with window
    # support n (reference SpectrogramConfig.zero_padding_factor,
    # processor.rs:45-56).  The slide algebra generalizes: exponent bases
    # move to 1/(n*zpf), the new-sample delta rows pick up the extra
    # omega^(k*n) phase, and the cosine-sum window stencils land at
    # +-(zpf*j) bins — cos(2*pi*j*m/n) == cos(2*pi*(zpf*j)*m/(n*zpf)) on
    # the window support, so the frequency-domain windowing stays EXACT
    # under padding.
    zpf: int = 1
    # exact re-anchor cadence: f32 slide drift is ~1e-6 relative per 8
    # hops — at 32 it stays ~4e-6, orders below the physics bars (2 Hz /
    # 1e-4 hop / 1%), and the amortized exact-FFT cond cost drops 4x
    refresh_steps: int = 32

    @property
    def n(self) -> int:
        return self.fft_size

    @property
    def pfft(self) -> int:
        """Padded transform length (n * zero_padding_factor)."""
        return self.n * self.zpf

    @property
    def bins(self) -> int:
        return self.pfft // 2 + 1

    @property
    def h(self) -> int:
        """Hilbert segment length == the reference's hilbert_len (2n)."""
        return 2 * self.n

    @property
    def center(self) -> int:
        return self.n // 2

    @property
    def margin(self) -> int:
        """Lag of the hx stream behind the raw stream.  Must equal
        ``center`` so the newest column's crop is exactly covered, and must
        be block-aligned so ring writes never wrap mid-block."""
        return self.center

    @property
    def supported(self) -> bool:
        n, b = self.n, self.block
        return (
            n >= 512
            and (n & (n - 1)) == 0
            and self.zpf in (1, 2)
            and self.hop * 4 <= n  # high overlap: where sliding wins
            and self.margin % b == 0  # block-aligned hx ring writes
            and n >= 2 * b  # overlap-save margins stay >= n/2
        )

    @property
    def frames(self) -> FrameBuffer:
        return FrameBuffer(self.h, self.hop, self.block)

    @property
    def extra_fresh(self) -> int:
        """Post-reset guard beyond the h-window: the oldest hx sample a
        column reads was synthesized from raw samples up to
        ``seg - margin - block`` behind it, which reaches ``n - block``
        samples past the h-window start."""
        return self.h - self.margin - self.block - self.center

    @property
    def cols_cap(self) -> int:
        return self.frames.cols_cap

    # -- host constants ------------------------------------------------------

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _consts(self):
        n, hop, bins, pfft = self.n, self.hop, self.bins, self.pfft
        k = np.arange(bins)
        rot = np.exp(2j * np.pi * k * hop / pfft)
        j = np.arange(hop)
        # entering samples sit at window positions n..n+hop-1, leaving at
        # 0..hop-1; with padding (pfft > n) omega^(k*n) != 1, so the two
        # delta exponent sets differ by that phase
        e_old = np.exp(-2j * np.pi * np.outer(j, k) / pfft)  # [hop, bins]
        e_new = np.exp(-2j * np.pi * np.outer(n + j, k) / pfft)
        c = (n - 1) * 0.5
        w_old = (c + hop - j)[:, None]
        w_new = (n + j - hop - c)[:, None]
        # fused delta matrix for one real input stream: rows [new; old],
        # columns [U_re | U_im | V_re | V_im]
        upd = np.concatenate(
            [
                np.concatenate(
                    [e_new.real, e_new.imag, w_new * e_new.real, w_new * e_new.imag], 1
                ),
                np.concatenate(
                    [-e_old.real, -e_old.imag, w_old * e_old.real, w_old * e_old.imag], 1
                ),
            ],
            axis=0,
        ).astype(np.float32)  # [2*hop, 4*bins]
        ramp = (np.arange(n) - c).astype(np.float32)
        return (
            rot.real.astype(np.float32),
            rot.imag.astype(np.float32),
            upd,
            ramp,
        )

    def _stencil_coeffs(self):
        return tuple(float(a) for a in self.window.cosine_coefficients)

    # -- state ---------------------------------------------------------------

    def init(self, lanes: int) -> dict:
        fbcap = self.frames.ring_len
        state = {
            k: jnp.zeros((lanes, self.bins), jnp.float32) for k in _STATE_KEYS
        }
        state["hx"] = jnp.zeros((lanes, fbcap), jnp.float32)
        state["count"] = jnp.zeros((), jnp.int32)
        state["anchored"] = jnp.zeros((), bool)
        state["hx_avail"] = jnp.zeros((), jnp.int32)
        return state

    def pspecs(self, axis):
        from jax.sharding import PartitionSpec as P

        out = {k: P(axis, None) for k in _STATE_KEYS}
        out["hx"] = P(axis, None)
        out["count"] = P()
        out["anchored"] = P()
        out["hx_avail"] = P()
        return out

    # -- hilbert stream ------------------------------------------------------

    @property
    def fir_half(self) -> int:
        """Half-length of the windowed Hilbert FIR == the margin, so the
        boundary protection matches the reference's n/2 crop margin."""
        return self.margin

    @functools.lru_cache(maxsize=None)  # noqa: B019 (frozen dataclass)
    def _hilbert_matrix(self):
        """Toeplitz matrix turning the newest ``block + 2*K`` raw samples
        into ``block`` Hilbert-transform samples lagging ``margin`` behind:
        one matmul replaces the overlap-save FFT/IFFT chain (same
        approximation class: the ideal Hilbert kernel 2/(pi t) truncated at
        +-K with a Blackman taper ~ the FFT method's segment-boundary
        error at the same distance)."""
        k_half = self.fir_half
        b = self.block
        t = np.arange(-k_half, k_half + 1, dtype=np.float64)
        ker = np.zeros_like(t)
        odd = (np.abs(t) % 2) == 1
        ker[odd] = 2.0 / (np.pi * t[odd])
        # Blackman taper over the full support
        m = t / k_half  # [-1, 1]
        taper = 0.42 + 0.5 * np.cos(np.pi * m) + 0.08 * np.cos(2 * np.pi * m)
        ker *= taper
        win = b + 2 * k_half
        i = np.arange(win)[:, None]
        j = np.arange(b)[None, :]
        idx = k_half + j + k_half - i  # ker index of x[start+i] for out j
        m2 = np.where((idx >= 0) & (idx <= 2 * k_half), idx, 0)
        mat = ker[m2] * ((idx >= 0) & (idx <= 2 * k_half))
        return mat.astype(np.float32)  # [win, b]

    def _hilbert_step(self, state: dict, info: dict):
        """Produce ``block`` new hx samples (one Toeplitz matmul) and write
        them into the hx ring at the slots of their raw counterparts."""
        fb = self.frames
        b, cap = self.block, fb.cap
        k_half = self.fir_half
        win = b + 2 * k_half
        buf = info["buf"]
        # raw window covering the emission span's +-K neighborhoods; the
        # newest needed sample IS the newest sample (emission lags margin
        # == K).  Clipped reads during warmup produce garbage that hx_avail
        # gating keeps out of valid columns.
        seg_start = jnp.clip(
            (info["origin_next"] - win) % cap, 0, fb.ring_len - win
        )
        x_win = jax.lax.dynamic_slice(
            buf, (jnp.int32(0), seg_start), (buf.shape[0], win)
        )
        # full f32: TF32 rounding (~2^-11) would sit at the same order as
        # the FIR approximation's own truncation error (~1/(pi*margin))
        emit = jnp.einsum(
            "sw,wb->sb", x_win, jnp.asarray(self._hilbert_matrix()),
            precision=jax.lax.Precision.HIGHEST,
        )
        e0 = (info["origin_next"] - self.margin - b) % cap
        hx = jax.lax.dynamic_update_slice(state["hx"], emit, (jnp.int32(0), e0))
        hx = jax.lax.dynamic_update_slice(hx, emit, (jnp.int32(0), e0 + cap))
        hx_avail = jnp.where(
            info["avail"] >= win,
            jnp.minimum(state["hx_avail"] + b, cap),
            0,
        )
        return hx, hx_avail

    def _hx_slice(self, hx, info, offset, length: int):
        # modulo, not clip: offsets may go negative for sliding reads of
        # samples just left of the window (see FrameBuffer.slice)
        start = (info["base"] + offset) % self.frames.cap
        return jax.lax.dynamic_slice(
            hx, (jnp.int32(0), start), (hx.shape[0], length)
        )

    # -- spectra helpers -----------------------------------------------------

    def _exact_states(self, info, hx, ramp):
        """Exact one-sided spectra of the oldest ready window's crop (the
        re-anchor target, mirroring sliding_stft's exact_col0)."""
        fb = self.frames
        n, c0 = self.n, self.center
        x_crop = fb.slice(info, c0, n)
        hx_crop = self._hx_slice(hx, info, c0, n)
        # one batched pair-packed transform for all four real inputs
        stacked = jnp.stack(
            [x_crop, hx_crop, x_crop * ramp, hx_crop * ramp], axis=1
        )  # [S, 4, n]
        spec = rfft_mxu(stacked, self.pfft, in_len=n)
        ux, uh, vx, vh = (spec[:, i] for i in range(4))
        return {
            "uxr": jnp.real(ux), "uxi": jnp.imag(ux),
            "uhr": jnp.real(uh), "uhi": jnp.imag(uh),
            "vxr": jnp.real(vx), "vxi": jnp.imag(vx),
            "vhr": jnp.real(vh), "vhi": jnp.imag(vh),
        }

    def _slide(self, st: dict, info, hx, k: int, rot_r, rot_i, upd):
        """Advance all 8 state arrays by one hop to column k's window."""
        fb = self.frames
        hop, n, c0 = self.hop, self.n, self.center
        prev = c0 + (k - 1) * hop
        prec = jax.lax.Precision.HIGHEST

        def deltas(new, old):
            d = jnp.concatenate([new, old], axis=-1)  # [S, 2*hop]
            out = jnp.einsum("sj,jb->sb", d, upd, precision=prec)
            b = self.bins
            return out[:, :b], out[:, b : 2 * b], out[:, 2 * b : 3 * b], out[:, 3 * b :]

        dxr, dxi, dvxr, dvxi = deltas(
            fb.slice(info, prev + n, hop), fb.slice(info, prev, hop)
        )
        dhr, dhi, dvhr, dvhi = deltas(
            self._hx_slice(hx, info, prev + n, hop),
            self._hx_slice(hx, info, prev, hop),
        )

        def rotate(re, im):
            return re * rot_r - im * rot_i, re * rot_i + im * rot_r

        out = {}
        out["uxr"], out["uxi"] = rotate(st["uxr"] + dxr, st["uxi"] + dxi)
        out["uhr"], out["uhi"] = rotate(st["uhr"] + dhr, st["uhi"] + dhi)
        out["vxr"], out["vxi"] = rotate(
            st["vxr"] - hop * st["uxr"] + dvxr, st["vxi"] - hop * st["uxi"] + dvxi
        )
        out["vhr"], out["vhi"] = rotate(
            st["vhr"] - hop * st["uhr"] + dvhr, st["vhi"] - hop * st["uhi"] + dvhi
        )
        return out

    # -- stencils over the complex analytic spectra --------------------------

    def _extend(self, st, which: str, jm: int):
        """Complex U (or V) on bins [-jm, n/2 + jm] from the one-sided real
        halves.  U[k] = X[k] + i*HX[k]; for k outside [0, n/2] both halves
        reflect hermitian (X[-m] = conj(X[m]), X[n/2+m] = conj(X[n/2-m])),
        so the combine flips sign on the imaginary parts."""
        xr = st[f"{which}xr"]
        xi = st[f"{which}xi"]
        hr = st[f"{which}hr"]
        hi = st[f"{which}hi"]
        er_core = xr - hi
        ei_core = xi + hr
        if jm == 0:
            return er_core, ei_core
        # positions -jm..-1: mirror index m = jm..1
        left_r = (xr[:, 1 : jm + 1] + hi[:, 1 : jm + 1])[:, ::-1]
        left_i = (hr[:, 1 : jm + 1] - xi[:, 1 : jm + 1])[:, ::-1]
        # positions n/2+1..n/2+jm: mirror index m = n/2-1..n/2-jm
        b = self.bins
        right_r = (xr[:, b - jm - 1 : b - 1] + hi[:, b - jm - 1 : b - 1])[:, ::-1]
        right_i = (hr[:, b - jm - 1 : b - 1] - xi[:, b - jm - 1 : b - 1])[:, ::-1]
        return (
            jnp.concatenate([left_r, er_core, right_r], axis=-1),
            jnp.concatenate([left_i, ei_core, right_i], axis=-1),
        )

    def _column(self, st: dict, consts):
        """B/D/T stencils + reassignment corrections for the current window.

        Returns (freq_hz, time_offset_hops, scaled_power) each [S, bins].
        """
        coeffs = self._stencil_coeffs()
        z = self.zpf
        jm = z * (len(coeffs) - 1)  # stencil offsets scale with padding
        n = self.n
        bins = self.bins
        norm = consts["norm"]

        ur, ui = self._extend(st, "u", jm)
        vr, vi = self._extend(st, "v", jm)

        def sl(x, off):
            return x[:, jm + off : jm + off + bins]

        a0 = coeffs[0]
        br, bi = a0 * sl(ur, 0), a0 * sl(ui, 0)
        tr, ti = a0 * sl(vr, 0), a0 * sl(vi, 0)
        dr = jnp.zeros_like(br)
        di = jnp.zeros_like(bi)
        for j in range(1, len(coeffs)):
            half = 0.5 * coeffs[j]
            jz = z * j
            br = br + half * (sl(ur, -jz) + sl(ur, jz))
            bi = bi + half * (sl(ui, -jz) + sl(ui, jz))
            tr = tr + half * (sl(vr, -jz) + sl(vr, jz))
            ti = ti + half * (sl(vi, -jz) + sl(vi, jz))
            g = np.pi * j * coeffs[j] / n  # D += i*g*(U[k-jz] - U[k+jz])
            dr = dr - g * (sl(ui, -jz) - sl(ui, jz))
            di = di + g * (sl(ur, -jz) - sl(ur, jz))

        pow_raw = br * br + bi * bi
        inv_pow = 1.0 / jnp.maximum(pow_raw, 1e-38)
        d_omega = -(di * br - dr * bi) * inv_pow
        freq_hz = consts["freq_base"] + d_omega * consts["inv_2pi"]
        time_offset = (tr * br + ti * bi) * inv_pow * consts["inv_hop"] - consts[
            "latency_hops"
        ]
        # 0.25: the reference's analytic signal is half-amplitude (one-sided
        # selection without doubling, processor.rs:546-557); ours is
        # full-amplitude, so |B|^2 carries a 4x to cancel before the same
        # one-sided bin normalization applies
        scaled_power = pow_raw * (0.25 * norm)
        return freq_hz, time_offset, scaled_power

    # -- the hop step --------------------------------------------------------

    def step(self, state: dict, info: dict):
        """One engine hop: returns ``(new_state, (freq, time, power, valid))``
        with per-column arrays ``[S, cols_cap, bins]`` and the stricter
        validity mask (h-window + hx-provenance post-reset)."""
        from openmeters_tpu.utils.windows import (
            fft_bin_normalization,
            window_coefficients,
        )

        fb = self.frames
        n = self.n
        rot_r, rot_i, upd, ramp = self._consts()
        rot_r = jnp.asarray(rot_r)
        rot_i = jnp.asarray(rot_i)
        upd = jnp.asarray(upd)

        w = window_coefficients(self.window, n)
        consts = {
            "norm": jnp.asarray(fft_bin_normalization(w, self.pfft)),
            "freq_base": jnp.asarray(
                np.arange(self.bins, dtype=np.float32)
                * (self.sample_rate / self.pfft)
            ),
            "inv_2pi": self.sample_rate / (2.0 * np.pi),
            "inv_hop": 1.0 / self.hop,
            "latency_hops": self.center / self.hop,
        }

        hx, hx_avail = self._hilbert_step(state, info)

        ready = info["ready"]
        count = state["count"]
        warm = hx_avail >= fb.cap - self.margin - self.center
        refresh = (
            ((count % self.refresh_steps == 0) | ~state["anchored"])
            & (ready > 0)
            & warm
        )

        st = {k: state[k] for k in _STATE_KEYS}
        # column 0: exact re-anchor under a scalar cond, else slide
        slid0 = self._slide(st, info, hx, 0, rot_r, rot_i, upd)
        exact0 = jax.lax.cond(
            refresh,
            lambda: self._exact_states(info, hx, jnp.asarray(ramp)),
            lambda: slid0,
        )

        freqs, times, powers = [], [], []
        cur = st
        for k in range(fb.cols_cap):
            nxt = exact0 if k == 0 else self._slide(cur, info, hx, k, rot_r, rot_i, upd)
            emit = jnp.int32(k) < ready
            cur = {
                key: jnp.where(emit, nxt[key], cur[key]) for key in _STATE_KEYS
            }
            f, t, p = self._column(cur, consts)
            freqs.append(f)
            times.append(t)
            powers.append(p)

        new_state = dict(cur)
        new_state["hx"] = hx
        new_state["count"] = count + 1
        new_state["anchored"] = (state["anchored"] | refresh) & warm
        new_state["hx_avail"] = hx_avail

        # stricter validity: whole h-window AND the hx provenance tail must
        # be post-reset (framing.py valid plus extra_fresh), plus hx warmup
        k = jnp.arange(fb.cols_cap, dtype=jnp.int32)
        tail = jnp.maximum((ready - 1 - k) * self.hop, 0)
        need = self.h + self.extra_fresh + tail
        valid = (
            (k[None, :] < ready)
            & (info["fresh"][:, None] >= need[None, :])
            & warm
            & new_state["anchored"]
        )
        out = (
            jnp.stack(freqs, axis=1),
            jnp.stack(times, axis=1),
            jnp.stack(powers, axis=1),
            valid,
        )
        return new_state, out
