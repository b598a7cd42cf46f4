"""True-peak metering via libebur128-compatible polyphase interpolation.

Reference parity: ``TruePeakMeter`` in ``src/visuals/loudness/processor.rs:74-151``.
The 49-tap Hann-windowed sinc interpolator has zero-valued endpoints leaving
48 effective taps; 4x oversampling below 96 kHz (12-tap x 3 phases), 2x below
192 kHz (24-tap x 1 phase), sample-peak passthrough above.  Integer phases
are covered by the plain sample peak.

Batched formulation: the per-sample circular delay line becomes a small carry of
the last ``D-1`` samples; each block evaluates the FIR as ``D`` shifted
multiply-adds over ``[T, lanes...]`` (XLA fuses these into a handful of
elementwise passes), then reduces the block peak.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

TRUE_PEAK_TAPS = 48  # reference loudness/processor.rs:75


def _coefficient(j: int, factor: int) -> float:
    # reference true_peak_coefficient (loudness/processor.rs:79-84)
    offset = j - TRUE_PEAK_TAPS * 0.5
    window = 0.5 * (1.0 - math.cos(2.0 * math.pi * j / TRUE_PEAK_TAPS))
    x = offset * math.pi / factor
    return float(np.float32(window * math.sin(x) / x))


def polyphase_taps(factor: int) -> np.ndarray:
    """``[delay, phases]`` float32 tap matrix for the fractional phases.

    4x: ``taps[i, p] = h[4 i + p + 1]``, i<12, p<3 (processor.rs:90-97).
    2x: ``taps[i, 0] = h[2 i + 1]``, i<24.
    """
    if factor == 4:
        return np.array(
            [[_coefficient(i * 4 + p + 1, 4) for p in range(3)] for p_i in [0] for i in range(12)],
            np.float32,
        )
    if factor == 2:
        return np.array([[_coefficient(i * 2 + 1, 2)] for i in range(24)], np.float32)
    raise ValueError(factor)


def oversample_factor(sample_rate: float) -> int:
    """4x < 96 kHz, 2x < 192 kHz, else passthrough (processor.rs:107-115)."""
    if sample_rate < 96_000.0:
        return 4
    if sample_rate < 192_000.0:
        return 2
    return 1


@dataclasses.dataclass(frozen=True)
class TruePeakKernel:
    sample_rate: float

    @property
    def factor(self) -> int:
        return oversample_factor(self.sample_rate)

    @property
    def delay(self) -> int:
        return {4: 12, 2: 24, 1: 0}[self.factor]

    def init(self, lane_shape: tuple[int, ...]):
        return jnp.zeros((max(self.delay - 1, 0), *lane_shape), jnp.float32)

    def process_block(self, carry, x, reset_mask=None):
        """Peak of ``|x|`` and the interpolated phases over one block.

        Args:
          carry: ``[D-1, lanes...]`` delay history.
          x: ``[T, lanes...]`` block samples.
          reset_mask: optional ``[lanes...]`` bool; zeroes those lanes' history.

        Returns ``(new_carry, peak [lanes...])`` — the per-block peak, which
        the caller squares into dBTP (reference takes/resets the running peak
        every ``process_block``, processor.rs:301-302).
        """
        t = x.shape[0]
        sample_peak = jnp.max(jnp.abs(x), axis=0)
        if self.factor == 1:
            return carry, sample_peak

        if reset_mask is not None:
            carry = jnp.where(reset_mask, 0.0, carry)
        d = self.delay

        taps = polyphase_taps(self.factor)
        xx = jnp.concatenate([carry, x], axis=0)  # [T + D - 1, lanes...]
        # y_p[n] = sum_i x[n - i] * taps[i, p]; x[n - i] == xx[D - 1 + n - i].
        interp_peak = jnp.zeros_like(sample_peak)
        for p in range(taps.shape[1]):
            y = jnp.zeros_like(x)
            for i in range(d):
                y = y + taps[i, p] * jax_slice(xx, d - 1 - i, t)
            interp_peak = jnp.maximum(interp_peak, jnp.max(jnp.abs(y), axis=0))
        return xx[t:], jnp.maximum(sample_peak, interp_peak)


def jax_slice(xx, start: int, length: int):
    return xx[start : start + length]
