"""Spectrogram: classic STFT and Auger–Flandrin time-frequency reassignment.

Reference parity: ``src/visuals/spectrogram/processor.rs``.  Two modes:

- **Classic**: DC-removed, windowed, zero-padded rFFT per hop; per-bin power
  packed to u16 over the fixed [-144, +12] dB domain (processor.rs:63-68,
  349-380).
- **Reassigned**: analytic signal via an FFT Hilbert transform over
  ``hilbert_len = next_pow2(2 * window)`` samples, three FFTs of the centered
  analytic frame windowed by h, dh/dt (spectral-derivative window) and
  (t - center) * h, then per-bin frequency correction
  ``-Im(D conj(B)) / |B|^2`` and time correction ``Re(T conj(B)) / |B|^2``
  in hops minus the Hilbert latency (processor.rs:439-488).  References:
  Auger & Flandrin 1995; Fulop & Fitz 2006.

Batched formulation: hops become fixed-capacity column batches from
:class:`~openmeters_tpu.ops.framing.FrameBuffer`; the reference's
variable-length culled point lists (bins below 1e-14 scaled power omitted)
become full ``[bins]`` arrays plus a ``point_valid`` mask — static shapes for
XLA, same information.  Silent windows need no special-casing: zero frames
produce floor columns / empty masks by arithmetic.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.ops.fft import fft_mxu, ifft_mxu, rfft_mxu
from openmeters_tpu.ops.framing import FrameBuffer
from openmeters_tpu.utils.level import DB_FLOOR, power_to_db
from openmeters_tpu.utils.windows import (
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

DEFAULT_FFT_SIZE = 2048  # reference processor.rs:58
DEFAULT_HOP_SIZE = 64  # reference processor.rs:59
MAX_HISTORY_COLUMNS = 8192  # reference processor.rs:60
HISTORY_BYTE_BUDGET = 128 * 1024 * 1024  # reference processor.rs:61

# Fixed u16 dB storage domain (reference processor.rs:63-68).
CLASSIC_DB_STORE_LO = -144.0
CLASSIC_DB_STORE_HI = 12.0
CLASSIC_DB_STORE_RANGE = CLASSIC_DB_STORE_HI - CLASSIC_DB_STORE_LO
ANALYSIS_FLOOR_POWER = 1e-14  # reference processor.rs:69


def pack_classic_db(db):
    """dB -> u16 code over the fixed store domain (processor.rs:103-108)."""
    scale = 65535.0 / CLASSIC_DB_STORE_RANGE
    code = jnp.round((db - CLASSIC_DB_STORE_LO) * scale)
    return jnp.clip(code, 0.0, 65535.0).astype(jnp.uint16)


def unpack_classic_db(codes):
    return codes.astype(jnp.float32) * (CLASSIC_DB_STORE_RANGE / 65535.0) + CLASSIC_DB_STORE_LO


def hilbert_len_for(window_size: int) -> int:
    """(2 * window).next_power_of_two() (reference processor.rs:225-227)."""
    n = max(window_size * 2, 2)
    return 1 << (n - 1).bit_length()


def derivative_window(window: np.ndarray) -> np.ndarray:
    """Spectral-derivative window dh/dn via FFT (processor.rs:569-599)."""
    n = len(window)
    if n <= 1:
        return np.zeros(n, np.float32)
    spec = np.fft.fft(window.astype(np.float64))
    k = np.arange(n)
    omega = (2.0 * np.pi / n) * np.where(k > n // 2, k - n, k).astype(np.float64)
    omega[0] = 0.0
    if n % 2 == 0:
        omega[n // 2] = 0.0
    dspec = 1j * omega * spec
    dspec[0] = 0.0
    if n % 2 == 0:
        dspec[n // 2] = 0.0
    return np.real(np.fft.ifft(dspec)).astype(np.float32)


def time_weighted_window(window: np.ndarray) -> np.ndarray:
    """(i - center) * w[i], center = (len-1)/2 (processor.rs:601-608)."""
    center = (len(window) - 1) * 0.5
    return ((np.arange(len(window)) - center) * window.astype(np.float64)).astype(
        np.float32
    )


def reassigned_power_scale(window: np.ndarray, fft_size: int) -> float:
    """Coherent-gain/ENBW correction for splat accumulation
    (processor.rs:111-117): ``sum(w)^2 / (fft_size * sum(w^2))``."""
    w = window.astype(np.float64)
    s, ss = np.sum(w), np.sum(w * w)
    return float(s * s / (fft_size * ss))


def history_columns(reassigned: bool, points: int, requested: int) -> int:
    """GPU-history retention budget (processor.rs:144-158): classic columns
    pack two u16 codes per u32; reassigned points are 12-byte splats with a
    doubled budget."""
    stride = points * 12 if reassigned else ((points + 1) // 2) * 4
    budget = HISTORY_BYTE_BUDGET * (2 if reassigned else 1)
    cap = max(budget // max(stride, 1), 1)
    return min(max(requested, 1), MAX_HISTORY_COLUMNS, cap)


class ClassicColumns(NamedTuple):
    codes: jnp.ndarray  # [S, cols_cap, bins] uint16 packed dB
    valid: jnp.ndarray  # [S, cols_cap] bool


class ReassignedColumns(NamedTuple):
    freq_hz: jnp.ndarray  # [S, cols_cap, bins]
    time_offset: jnp.ndarray  # [S, cols_cap, bins] in hops
    power: jnp.ndarray  # [S, cols_cap, bins] scaled power
    point_valid: jnp.ndarray  # [S, cols_cap, bins] bool (culling mask)
    valid: jnp.ndarray  # [S, cols_cap] bool


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    sample_rate: float = 48_000.0
    fft_size: int = DEFAULT_FFT_SIZE  # analysis window length
    hop_size: int = DEFAULT_HOP_SIZE
    window: WindowKind = WindowKind.HANN
    use_reassignment: bool = True
    zero_padding_factor: int = 1
    block_frames: int = 256

    def normalized(self) -> "SpectrogramConfig":
        # reference normalize() (processor.rs:71-82)
        from openmeters_tpu.utils.level import sanitize_sample_rate

        fft = self.fft_size or DEFAULT_FFT_SIZE
        hop = self.hop_size or max(min(DEFAULT_HOP_SIZE, fft), 1)
        return dataclasses.replace(
            self,
            sample_rate=sanitize_sample_rate(self.sample_rate),
            fft_size=fft,
            hop_size=hop,
            zero_padding_factor=max(self.zero_padding_factor, 1),
        )


@dataclasses.dataclass(frozen=True)
class SpectrogramAnalyzer:
    config: SpectrogramConfig = SpectrogramConfig()

    @property
    def padded_fft(self) -> int:
        return self.config.fft_size * self.config.zero_padding_factor

    @property
    def bins(self) -> int:
        return self.padded_fft // 2 + 1

    @property
    def read_len(self) -> int:
        cfg = self.config
        return hilbert_len_for(cfg.fft_size) if cfg.use_reassignment else cfg.fft_size

    @property
    def _frames(self) -> FrameBuffer:
        return FrameBuffer(self.read_len, self.config.hop_size, self.config.block_frames)

    @property
    def cols_cap(self) -> int:
        return self._frames.cols_cap

    @property
    def power_scale(self) -> float:
        """Reassigned splat power correction, exposed like
        ``SpectrogramUpdate::reassigned_power_scale``."""
        w = window_coefficients(self.config.window, self.config.fft_size)
        return reassigned_power_scale(w, self.padded_fft)

    @property
    def _sliding(self):
        from openmeters_tpu.ops.sliding_stft import SlidingSTFT

        cfg = self.config
        return SlidingSTFT(cfg.fft_size, cfg.hop_size, cfg.block_frames, cfg.window)

    @property
    def use_sliding(self) -> bool:
        """Sliding-DFT classic path (ops/sliding_stft.py): unpadded
        power-of-two FFTs with hop <= fft/2 — every stock classic config."""
        cfg = self.config
        return (
            not cfg.use_reassignment
            and cfg.zero_padding_factor == 1
            and self._sliding.supported
        )

    @property
    def use_sliding_kernel(self) -> bool:
        """The fused sliding hop (ops/sliding_kernel.py): on GPUs, for the
        shapes it supports; the XLA slide serves everything else."""
        return (
            self.use_sliding
            and jax.default_backend() == "gpu"
            and self._sliding.fused_supported
        )

    @property
    def _sliding_reassigned(self):
        from openmeters_tpu.ops.sliding_reassigned import SlidingReassigned

        cfg = self.config
        return SlidingReassigned(
            cfg.fft_size, cfg.hop_size, cfg.block_frames, cfg.window,
            cfg.sample_rate, zpf=cfg.zero_padding_factor,
        )

    @property
    def use_sliding_reassigned(self) -> bool:
        """Streaming-analytic reassigned path (ops/sliding_reassigned.py):
        at high overlap (the stock 2048/64 default) the per-column Hilbert +
        FFT chain is replaced by an overlap-save analytic stream plus
        sliding U/V spectra — the reassigned analogue of the classic
        sliding-DFT path."""
        import os

        cfg = self.config
        if os.environ.get("OPENMETERS_SLIDING_REASSIGNED", "1") == "0":
            return False
        return (
            cfg.use_reassignment
            and cfg.hop_size <= cfg.block_frames
            and self._sliding_reassigned.supported  # zpf in (1, 2) included
        )

    def init(self, n_streams: int) -> dict:
        carry = {"fb": self._frames.init(n_streams)}
        if self.use_sliding:
            carry["sdft"] = self._sliding.init(n_streams)
        if self.use_sliding_reassigned:
            carry["srs"] = self._sliding_reassigned.init(n_streams)
        return carry

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, reset_mask=None):
        """One hop of ``[S, B]`` mono (mid-projected) samples.

        Returns ``(carry, ClassicColumns | ReassignedColumns)``.
        """
        fb = self._frames
        fb_carry, info = fb.advance(carry["fb"], block, reset_mask)
        new_carry = {"fb": fb_carry}
        if self.use_sliding_reassigned:
            new_carry["srs"], out = self._reassigned_sliding(carry["srs"], info)
        elif self.config.use_reassignment:
            out = self._gated(info, self._reassigned)
        elif self.use_sliding:
            new_carry["sdft"], out = self._classic_sliding(carry["sdft"], info)
        else:
            out = self._gated(info, self._classic)
        return new_carry, out

    def _gated(self, info, compute):
        """Skip the whole column pipeline on hops where no window is ready
        (hop > block configs emit columns only every ``ceil(hop/block)``
        steps; the spectrum analyzer gates the same way).  ``ready`` is a
        global scalar — resets realign to the hop grid — so this is one
        scalar ``lax.cond``."""
        fb = self._frames
        if self.config.hop_size <= self.config.block_frames:
            return compute(fb.extract(info), info["valid"])
        lanes = info["valid"].shape[0]
        cap, bins = self.cols_cap, self.bins
        if self.config.use_reassignment:
            empty = ReassignedColumns(
                freq_hz=jnp.zeros((lanes, cap, bins), jnp.float32),
                time_offset=jnp.zeros((lanes, cap, bins), jnp.float32),
                power=jnp.zeros((lanes, cap, bins), jnp.float32),
                point_valid=jnp.zeros((lanes, cap, bins), bool),
                valid=jnp.zeros((lanes, cap), bool),
            )
        else:
            empty = ClassicColumns(
                codes=jnp.zeros((lanes, cap, bins), jnp.uint16),
                valid=jnp.zeros((lanes, cap), bool),
            )
        return jax.lax.cond(
            info["ready"] > 0,
            lambda: compute(fb.extract(info), info["valid"]),
            lambda: empty,
        )

    # -- sliding classic ----------------------------------------------------

    def _classic_sliding(self, sdft, info):
        cfg = self.config
        w = window_coefficients(cfg.window, cfg.fft_size)
        norm = fft_bin_normalization(w, cfg.fft_size)
        if self.use_sliding_kernel:
            # fused GPU hop: slide + window + dB + u16 pack in one kernel
            new_sdft, codes = self._sliding.step_fused(sdft, info, norm, DB_FLOOR)
            return new_sdft, ClassicColumns(codes=codes, valid=info["valid"])
        new_sdft, power = self._sliding.step(sdft, info)
        db = power_to_db(power * norm, DB_FLOOR)
        return new_sdft, ClassicColumns(codes=pack_classic_db(db), valid=info["valid"])

    # -- classic ----------------------------------------------------------

    def _classic(self, frames, valid) -> ClassicColumns:
        cfg = self.config
        w = window_coefficients(cfg.window, cfg.fft_size)
        norm = fft_bin_normalization(w, self.padded_fft)

        mean = jnp.mean(frames, axis=-1, keepdims=True)
        x = (frames - mean) * w
        spec = rfft_mxu(x, self.padded_fft)
        power = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) * norm
        db = power_to_db(power, DB_FLOOR)
        return ClassicColumns(codes=pack_classic_db(db), valid=valid)

    # -- reassigned (sliding-analytic) ------------------------------------

    def _reassigned_sliding(self, srs_carry, info):
        cfg = self.config
        srs = self._sliding_reassigned
        new_carry, (freq_hz, time_offset, scaled_power, valid) = srs.step(
            srs_carry, info
        )
        max_hz = cfg.sample_rate * 0.5
        point_valid = (
            (scaled_power >= ANALYSIS_FLOOR_POWER)
            & (freq_hz > 0.0)
            & (max_hz - freq_hz > 0.0)
            & valid[..., None]
        )
        return new_carry, ReassignedColumns(
            freq_hz=freq_hz,
            time_offset=time_offset,
            power=scaled_power,
            point_valid=point_valid,
            valid=valid,
        )

    # -- reassigned -------------------------------------------------------

    def _reassigned(self, frames, valid) -> ReassignedColumns:
        cfg = self.config
        n = cfg.fft_size
        h = self.read_len  # hilbert length
        center = (h - n) // 2
        pfft = self.padded_fft
        bins = self.bins

        w = window_coefficients(cfg.window, n)
        norm = fft_bin_normalization(w, pfft)

        # Analytic signal: zero DC and strictly-negative-frequency bins of the
        # raw (NOT windowed) frame; positive bins are *not* doubled — the 4x
        # one-sided bin normalization accounts for it (processor.rs:546-557).
        # The kept bins 1..h/2 are exactly the one-sided rFFT output, so the
        # forward transform rides the pair-packed real FFT (half the work of
        # a complex transform); the upper half is zero by construction.
        spec = rfft_mxu(frames, h)
        keep = (np.arange(h // 2 + 1) >= 1).astype(np.float32)
        zeros_hi = jnp.zeros((*spec.shape[:-1], h - (h // 2 + 1)), jnp.float32)
        ar, ai = ifft_mxu(
            jnp.concatenate([jnp.real(spec) * keep, zeros_hi], axis=-1),
            jnp.concatenate([jnp.imag(spec) * keep, zeros_hi], axis=-1),
            h,
        )
        ar = ar[..., center : center + n]
        ai = ai[..., center : center + n]

        if pfft == n:
            # Windowing in the frequency domain: a cosine-sum window is a
            # short circular stencil over the unwindowed spectrum U; the
            # spectral-derivative window dh/dt has DFT support only on the
            # window's cosine bins (DW[±j] = ±i·pi·j·c_j), and (t-c)·h is the
            # same window stencil over V = FFT((t-c)·a).  Two complex FFTs +
            # stencils replace the three windowed transforms.
            ur, ui = fft_mxu(ar, ai, n)
            ramp = (np.arange(n) - (n - 1) * 0.5).astype(np.float32)
            vr, vi = fft_mxu(ar * ramp, ai * ramp, n)
            c = cfg.window.cosine_coefficients

            def stencil(xr, xi):
                out_r, out_i = float(c[0]) * xr, float(c[0]) * xi
                for j in range(1, len(c)):
                    half = 0.5 * float(c[j])
                    out_r = out_r + half * (jnp.roll(xr, j, -1) + jnp.roll(xr, -j, -1))
                    out_i = out_i + half * (jnp.roll(xi, j, -1) + jnp.roll(xi, -j, -1))
                return out_r, out_i

            br, bi = stencil(ur, ui)
            tr, ti = stencil(vr, vi)
            dr = jnp.zeros_like(ur)
            di = jnp.zeros_like(ui)
            for j in range(1, len(c)):
                g = np.pi * j * float(c[j]) / n  # i·g·(U[k-j] - U[k+j])
                er = jnp.roll(ur, j, -1) - jnp.roll(ur, -j, -1)
                ei = jnp.roll(ui, j, -1) - jnp.roll(ui, -j, -1)
                dr = dr - g * ei
                di = di + g * er
            br, bi = br[..., :bins], bi[..., :bins]
            dr, di = dr[..., :bins], di[..., :bins]
            tr, ti = tr[..., :bins], ti[..., :bins]
        else:
            # zero-padded transforms: the stencil identity needs the window
            # periodic in the transform length, so pad and FFT the three
            # windowed frames, stacked into one batched transform
            dw = derivative_window(w)
            tw = time_weighted_window(w)
            wins = np.stack([w, dw, tw])[:, None, None, :]  # [3, 1, 1, n]
            fr, fi = fft_mxu(ar[None] * wins, ai[None] * wins, pfft)
            fr, fi = fr[..., :bins], fi[..., :bins]
            br, bi = fr[0], fi[0]
            dr, di = fr[1], fi[1]
            tr, ti = fr[2], fi[2]

        pow_raw = br * br + bi * bi
        scaled_power = pow_raw * norm
        inv_pow = 1.0 / jnp.maximum(pow_raw, 1e-38)

        bin_hz = cfg.sample_rate / pfft
        max_hz = cfg.sample_rate * 0.5
        inv_2pi = cfg.sample_rate / (2.0 * np.pi)
        inv_hop = 1.0 / cfg.hop_size
        latency_hops = center * inv_hop

        d_omega = -(di * br - dr * bi) * inv_pow
        freq_hz = np.arange(bins, dtype=np.float32) * bin_hz + d_omega * inv_2pi
        time_offset = (tr * br + ti * bi) * inv_pow * inv_hop - latency_hops

        point_valid = (
            (scaled_power >= ANALYSIS_FLOOR_POWER)
            & (freq_hz > 0.0)
            & (max_hz - freq_hz > 0.0)
            & valid[..., None]
        )
        return ReassignedColumns(
            freq_hz=freq_hz,
            time_offset=time_offset,
            power=scaled_power,
            point_valid=point_valid,
            valid=valid,
        )
