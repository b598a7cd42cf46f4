"""Stereometer: Lissajous point clouds + per-band stereo correlation.

Reference parity: ``src/visuals/stereometer/processor.rs`` — full-band L/R
history plus an optional 3-band LR4 split
(``ThreeBand<[Cascade<Biquad,2>;2], true>``, processor.rs:32); a ``Correlator``
of EMA moments (cross, L^2, R^2) with ``alpha = 1 - exp(-1/(rate*window))``
and a Pearson-style value clamped to [-1, 1] (processor.rs:38-61); snapshots
decimate the last ``segment_duration`` seconds to ``target_sample_count``
(x, y) points, band points scaled by 0.8 (processor.rs:142-181).

Batched formulation: the per-sample EMA collapses into a closed-form block
update — ``m' = (1-a)^B m + a * sum_i (1-a)^(B-1-i) v_i`` — one dot product
with a precomputed decay vector per block; the LR4 splitter is a shared
``three_band_scan``; histories are right-aligned shift rings with *static*
decimation gathers (segment length and target count are config).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.ops.iir import three_band_init, three_band_scan
from openmeters_tpu.utils.level import flush_denormal

BAND_DISPLAY_GAIN = 0.8  # reference processor.rs:8
BAND_COUNT = 3
FULL_BAND = 0  # snapshot slot order: [full, low, mid, high]


def ema_alpha(sample_rate: float, window: float) -> float:
    """reference processor.rs:210-212."""
    return 1.0 - math.exp(-1.0 / max(sample_rate * window, 1.0))


class StereometerSnapshot(NamedTuple):
    points: jnp.ndarray  # [S, 4, target, 2] (full + 3 bands; bands zero unless emitted)
    correlations: jnp.ndarray  # [S, 4]
    points_valid: jnp.ndarray  # [S] — enough history for a snapshot


@dataclasses.dataclass(frozen=True)
class StereometerConfig:
    sample_rate: float = 48_000.0
    segment_duration: float = 0.02
    target_sample_count: int = 2_000
    correlation_window: float = 0.05
    analyze_bands: bool = False
    emit_band_points: bool = False
    block_frames: int = 256

    def resolved(self) -> "StereometerConfig":
        # emit_band_points implies analyze_bands (processor.rs:76)
        if self.emit_band_points and not self.analyze_bands:
            return dataclasses.replace(self, analyze_bands=True)
        return self


@dataclasses.dataclass(frozen=True)
class StereometerAnalyzer:
    config: StereometerConfig = StereometerConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolved())

    @property
    def segment_frames(self) -> int:
        return max(int(round(self.config.sample_rate * self.config.segment_duration)), 1)

    @property
    def target(self) -> int:
        return min(max(self.config.target_sample_count, 1), self.segment_frames)

    @property
    def _n_histories(self) -> int:
        return 4 if self.config.emit_band_points else 1

    def init(self, n_streams: int) -> dict:
        f = self.segment_frames
        carry = {
            "moments": jnp.zeros((4, 3, n_streams), jnp.float32),
            "ring": jnp.zeros((n_streams, self._n_histories, f, 2), jnp.float32),
            "count": jnp.zeros((n_streams,), jnp.int32),
        }
        if self.config.analyze_bands:
            carry["tb"] = three_band_init((n_streams, 2), 2)
        return carry

    def _corr_update(self, moments, l, r, reset=None):
        """Closed-form EMA block update for one band.

        ``moments``: [3, S]; ``l, r``: [B, S].  Returns updated moments.
        """
        cfg = self.config
        b = l.shape[0]
        alpha = ema_alpha(cfg.sample_rate, cfg.correlation_window)
        decay = np.power(1.0 - alpha, np.arange(b - 1, -1, -1, dtype=np.float64))
        total = float((1.0 - alpha) ** b)
        dvec = (alpha * decay).astype(np.float32)

        v = jnp.stack([l * r, l * l, r * r])  # [3, B, S]
        upd = jnp.einsum("vbs,b->vs", v, dvec, precision=jax.lax.Precision.HIGHEST)
        new = moments * total + upd
        if reset is not None:
            new = jnp.where(reset[None, :], upd, new)
        return flush_denormal(new)

    @staticmethod
    def _corr_value(moments):
        """Pearson-style value (processor.rs:48-56).

        ``moments``: [..., 3, S] with components (cross, L^2, R^2) on axis -2.
        """
        cross, lp, rp = moments[..., 0, :], moments[..., 1, :], moments[..., 2, :]
        denom = jnp.sqrt(lp * rp)
        val = jnp.where(denom > 1e-12, cross / jnp.maximum(denom, 1e-30), 0.0)
        return jnp.clip(jnp.where(jnp.isfinite(val), val, 0.0), -1.0, 1.0)

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, reset_mask=None):
        """One hop of ``[S, B, 2]`` folded stereo.

        Returns ``(carry, StereometerSnapshot)``.
        """
        cfg = self.config
        s, b, _ = block.shape
        f = self.segment_frames
        x = jnp.transpose(block, (1, 0, 2)).astype(jnp.float32)  # [B, S, 2]

        moments = carry["moments"]
        count = carry["count"]
        if reset_mask is not None:
            moments = jnp.where(reset_mask[None, None, :], 0.0, moments)
            count = jnp.where(reset_mask, 0, count)

        new_carry = {}
        l, r = x[..., 0], x[..., 1]
        bands = None
        if cfg.analyze_bands:
            tb = carry["tb"]
            if reset_mask is not None:
                tb = jnp.where(reset_mask[None, None, None, :, None], 0.0, tb)
            bands, tb = three_band_scan(
                x, tb, cfg.sample_rate, cascade_n=2, cascade_high=True
            )  # [B, 3, S, 2]
            new_carry["tb"] = tb

        upd = [self._corr_update(moments[0], l, r, reset_mask)]
        for band in range(BAND_COUNT):
            if cfg.analyze_bands:
                bl, br = bands[:, band, :, 0], bands[:, band, :, 1]
                upd.append(self._corr_update(moments[band + 1], bl, br, reset_mask))
            else:
                upd.append(moments[band + 1])
        moments = jnp.stack(upd)

        # histories: right-aligned shift rings of the last `f` samples
        ring = carry["ring"]
        if reset_mask is not None:
            ring = jnp.where(reset_mask[:, None, None, None], 0.0, ring)
        streams = [jnp.stack([l, r], axis=-1)]  # [B, S, 2]
        if cfg.emit_band_points:
            for band in range(BAND_COUNT):
                streams.append(bands[:, band])
        newest = jnp.stack(streams, axis=1)  # [B, H, S, 2]
        newest = jnp.transpose(newest, (2, 1, 0, 3))  # [S, H, B, 2]
        if b >= f:
            ring = newest[:, :, b - f :, :]
        else:
            ring = jnp.concatenate([ring[:, :, b:, :], newest], axis=2)

        count = jnp.minimum(count + b, jnp.int32(2**30))

        # decimated snapshot points (static gather: i * frames // target)
        idx = (np.arange(self.target) * f // self.target).astype(np.int32)
        pts = ring[:, :, idx, :]  # [S, H, target, 2]
        gains = np.ones((self._n_histories,), np.float32)
        gains[1:] = BAND_DISPLAY_GAIN
        pts = pts * gains[None, :, None, None]
        if self._n_histories < 4:
            pts = jnp.concatenate(
                [pts, jnp.zeros((s, 4 - self._n_histories, self.target, 2), jnp.float32)],
                axis=1,
            )

        corr = self._corr_value(moments).T  # [S, 4]
        if not cfg.analyze_bands:
            corr = corr.at[:, 1:].set(0.0)

        new_carry.update({"moments": moments, "ring": ring, "count": count})
        return new_carry, StereometerSnapshot(
            points=pts, correlations=corr, points_valid=count >= f
        )

    def migrate_from(self, old: "StereometerAnalyzer", carry: dict, n_streams: int):
        """Reference ``update_config`` (processor.rs:183-198): a sample-rate
        change rebuilds everything; a correlation_window change only swaps
        the EMA alpha (state continues); a band-analysis toggle rebuilds the
        band splitter (fresh ``tb``) but keeps the moments/ring."""
        import dataclasses as _dc

        a, b = old.config, self.config
        a, b = a.resolved(), b.resolved()
        if a == b:
            return carry
        if (a.sample_rate, a.block_frames, a.segment_duration,
                a.target_sample_count) != (
            b.sample_rate, b.block_frames, b.segment_duration,
            b.target_sample_count,
        ):
            return None
        if _dc.replace(
            a, correlation_window=b.correlation_window,
            analyze_bands=b.analyze_bands, emit_band_points=b.emit_band_points,
        ) != b:
            return None
        from openmeters_tpu.utils.migrate import merge_carry

        out = merge_carry(self.init(n_streams), carry)
        if a.analyze_bands != b.analyze_bands and "tb" in out:
            out["tb"] = self.init(n_streams)["tb"]  # fresh band splitter state
        return out

    def pspecs(self, axis: str):
        from jax.sharding import PartitionSpec as P

        specs = {
            "moments": P(None, None, axis),
            "ring": P(axis, None, None, None),
            "count": P(axis),
        }
        if self.config.analyze_bands:
            specs["tb"] = P(None, None, None, axis, None)
        return specs
