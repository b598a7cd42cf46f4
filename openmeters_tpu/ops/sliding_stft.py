"""Sliding-DFT STFT power columns for high-overlap hop configurations.

For hop << fft (the stock spectrogram 2048/64 and spectrum 16384/1024
configs), recomputing a full FFT per column wastes >90% of the work: the
unwindowed DFT advances by one hop with a single ``[hop, bins]`` delta matmul
plus a phasor rotation:

    F_{t+1}[k] = e^{+i 2 pi k h / N} (F_t[k] + sum_j (x_new[j] - x_old[j])
                                       e^{-i 2 pi k j / N})

Windowing happens *in the frequency domain*: a cosine-sum window w[m] =
sum_j a_j cos(2 pi j m / N) is the stencil  a_0 F[k] + sum_j a_j/2
(F[k-j] + F[k+j])  with hermitian edge reflection (real input), and DC
removal subtracts mean * W[k] at the stencil bins only.  Slides are exact
relative updates; an exact FFT re-anchor every ``refresh_steps`` engine
steps bounds f32 drift far below the spectrogram's 0.0024 dB u16 code step.

Shared by the classic spectrogram and the spectrum analyzer.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.ops.fft import rfft_mxu
from openmeters_tpu.ops.framing import FrameBuffer
from openmeters_tpu.utils.windows import WindowKind


@dataclasses.dataclass(frozen=True)
class SlidingSTFT:
    fft_size: int
    hop: int
    block: int
    window: WindowKind
    # 32-hop exact re-anchor: drift ~4e-6 relative stays far under the
    # u16 dB code step; 4x cheaper amortized re-anchor cond
    refresh_steps: int = 32

    @property
    def bins(self) -> int:
        return self.fft_size // 2 + 1

    @property
    def supported(self) -> bool:
        n = self.fft_size
        return n >= 64 and (n & (n - 1)) == 0 and self.hop * 2 <= n

    @property
    def fused_supported(self) -> bool:
        """Shapes the fused GPU hop (ops/sliding_kernel.py) handles."""
        from openmeters_tpu.ops.sliding_kernel import kernel_supported

        return self.supported and kernel_supported(
            self.hop, self.bins, len(self._stencil())
        )

    @property
    def frames(self) -> FrameBuffer:
        return FrameBuffer(self.fft_size, self.hop, self.block)

    def init(self, lanes: int) -> dict:
        return {
            "re": jnp.zeros((lanes, self.bins), jnp.float32),
            "im": jnp.zeros((lanes, self.bins), jnp.float32),
            "count": jnp.zeros((), jnp.int32),
            "anchored": jnp.zeros((), bool),
        }

    def _consts(self):
        n, h, bins = self.fft_size, self.hop, self.bins
        k = np.arange(bins)
        rot = np.exp(2j * np.pi * k * h / n)
        j = np.arange(h)
        upd = np.exp(-2j * np.pi * np.outer(j, k) / n)
        return (
            rot.real.astype(np.float32), rot.imag.astype(np.float32),
            upd.real.astype(np.float32), upd.imag.astype(np.float32),
        )

    def _stencil(self):
        return np.asarray(self.window.cosine_coefficients, np.float64)

    def _apply_window_freq(self, fr, fi):
        coeffs = self._stencil()
        bins = self.bins
        out_r = float(coeffs[0]) * fr
        out_i = float(coeffs[0]) * fi
        for j, a in enumerate(coeffs[1:], start=1):
            half = 0.5 * float(a)
            lo_r = jnp.concatenate([fr[..., 1 : j + 1][..., ::-1], fr[..., : bins - j]], axis=-1)
            lo_i = jnp.concatenate([-fi[..., 1 : j + 1][..., ::-1], fi[..., : bins - j]], axis=-1)
            hi_r = jnp.concatenate([fr[..., j:], fr[..., bins - j - 1 : bins - 1][..., ::-1]], axis=-1)
            hi_i = jnp.concatenate([fi[..., j:], -fi[..., bins - j - 1 : bins - 1][..., ::-1]], axis=-1)
            out_r = out_r + half * (lo_r + hi_r)
            out_i = out_i + half * (lo_i + hi_i)
        return out_r, out_i

    def _dc_corr_vector(self) -> np.ndarray:
        n = self.fft_size
        coeffs = self._stencil()
        corr = np.zeros((self.bins,), np.float32)
        corr[0] = float(coeffs[0]) * n
        for j, a in enumerate(coeffs[1:], start=1):
            if j < self.bins:
                corr[j] = 0.5 * float(a) * n
        return corr

    def step_fused(self, sdft: dict, info: dict, norm, floor_db: float,
                   interpret: bool = False):
        """Fused GPU hop (ops/sliding_kernel.py): slide + window + power +
        dB/u16 pack in one kernel.  Returns ``(new_sdft, codes)``.

        The periodic exact re-anchor happens *before* the kernel as an
        algebraic carry substitution: the kernel's col-0 slide is affine
        (``F0 = rot * (f + d0)``), so substituting
        ``f' = conj(rot) * F0_exact - d0`` makes the kernel land exactly on
        the freshly computed spectrum — the kernel stays branch-free.
        """
        from openmeters_tpu.ops.sliding_kernel import sliding_hop

        fb = self.frames
        n, h = self.fft_size, self.hop
        rot_r, rot_i, upd_r, upd_i = self._consts()
        prec = jax.lax.Precision.HIGHEST

        ready = info["ready"]
        count = sdft["count"]
        refresh = ((count % self.refresh_steps == 0) | ~sdft["anchored"]) & (
            ready > 0
        )

        deltas = jnp.stack(
            [
                fb.slice(info, (k - 1) * h + n, h) - fb.slice(info, (k - 1) * h, h)
                for k in range(fb.cols_cap)
            ],
            axis=1,
        )  # [S, cols, h]
        # every column's delta spectrum in one batched dot (full f32)
        dr = jnp.einsum("sch,hb->scb", deltas, upd_r, precision=prec)
        di = jnp.einsum("sch,hb->scb", deltas, upd_i, precision=prec)

        def reanchor(_):
            spec = rfft_mxu(fb.slice(info, 0, n), n)
            sr, si = jnp.real(spec), jnp.imag(spec)
            tr = sr * rot_r + si * rot_i  # F0 * conj(rot)
            ti = si * rot_r - sr * rot_i
            return tr - dr[:, 0], ti - di[:, 0]

        fr, fi = jax.lax.cond(
            refresh, reanchor, lambda _: (sdft["re"], sdft["im"]), None
        )
        fr2, fi2, codes = sliding_hop(
            ready, fr, fi, dr, di,
            jnp.asarray(rot_r), jnp.asarray(rot_i),
            jnp.asarray(self._dc_corr_vector()),
            jnp.asarray(norm, jnp.float32).reshape(-1),
            n=n, coeffs=tuple(float(a) for a in self._stencil()),
            floor_db=float(floor_db), interpret=interpret,
        )
        new_sdft = {
            "re": fr2,
            "im": fi2,
            "count": count + 1,
            "anchored": sdft["anchored"] | refresh,
        }
        return new_sdft, codes

    def step(self, sdft: dict, info: dict):
        """Produce windowed, DC-removed power columns for this engine hop.

        ``info`` comes from ``self.frames.advance``.  Returns
        ``(new_sdft, power [lanes, cols_cap, bins])``; caller applies bin
        normalization and masks with ``info['valid']``.
        """
        fb = self.frames
        n, h = self.fft_size, self.hop
        rot_r, rot_i, upd_r, upd_i = self._consts()
        dc_corr = self._dc_corr_vector()
        prec = jax.lax.Precision.HIGHEST

        ready = info["ready"]
        count = sdft["count"]
        refresh = ((count % self.refresh_steps == 0) | ~sdft["anchored"]) & (ready > 0)

        def slide(fr, fi, k):
            prev = (k - 1) * h
            d = fb.slice(info, prev + n, h) - fb.slice(info, prev, h)
            dr = jnp.einsum("sh,hb->sb", d, upd_r, precision=prec)
            di = jnp.einsum("sh,hb->sb", d, upd_i, precision=prec)
            tr = fr + dr
            ti = fi + di
            return tr * rot_r - ti * rot_i, tr * rot_i + ti * rot_r

        def exact_col0(_):
            spec = rfft_mxu(fb.slice(info, 0, n), n)
            return jnp.real(spec), jnp.imag(spec)

        fr, fi = sdft["re"], sdft["im"]
        f0 = slide(fr, fi, 0)
        f0r, f0i = jax.lax.cond(refresh, exact_col0, lambda _: f0, None)

        cols = []
        cur_r, cur_i = fr, fi
        for k in range(fb.cols_cap):
            nxt_r, nxt_i = (f0r, f0i) if k == 0 else slide(cur_r, cur_i, k)
            emit = jnp.int32(k) < ready
            cur_r = jnp.where(emit, nxt_r, cur_r)
            cur_i = jnp.where(emit, nxt_i, cur_i)
            wr, wi = self._apply_window_freq(cur_r, cur_i)
            mean = cur_r[..., 0:1] / n
            wr = wr - mean * dc_corr
            cols.append(wr * wr + wi * wi)

        new_sdft = {
            "re": cur_r,
            "im": cur_i,
            "count": count + 1,
            "anchored": sdft["anchored"] | refresh,
        }
        return new_sdft, jnp.stack(cols, axis=1)
