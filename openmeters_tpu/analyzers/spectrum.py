"""Spectrum analyzer: dual-trace FFT with power-domain averaging.

Reference parity: ``src/visuals/spectrum/processor.rs`` — two traces
(primary/secondary source in {L, R, Mid, Side, None}), each rFFT'd per hop;
averaging None / Exponential / PeakHold applied in the *power* domain with a
state floor lifted by the maximum positive A-weighting so weighting cannot
resurrect sub-floor bins (processor.rs:325-403); outputs both A-weighted and
raw dB arrays per trace.

Batched formulation: the ACTIVE traces of all streams run as one
``[S * trace_count]``-lane framing + batched rFFT, where ``trace_count``
(1 or 2) statically skips ``Channel.NONE`` and duplicate secondaries
(reference ``active_traces``, processor.rs:174-177) — the default config
(secondary=NONE) compiles half the 16384-pt sliding-DFT lanes.  Per-stream
trace projections are data (``[S, trace_count, 2]`` stereo-projection
vectors), so mixed *projections* batch into one compiled step; changing
which traces are active is a config (recompile) boundary, as in the
reference.  Averaging state is a carry; multiple ready columns per step
apply sequentially (a tiny static Python loop over ``cols_cap``).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.ops.fft import rfft_mxu
from openmeters_tpu.ops.framing import FrameBuffer
from openmeters_tpu.utils.channels import Channel, projection_vector
from openmeters_tpu.utils.level import DB_FLOOR, LN_TO_DB, db_to_power_host
from openmeters_tpu.utils.weighting import a_weight_db
from openmeters_tpu.utils.windows import (
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

DEFAULT_FFT_SIZE = 16_384  # reference processor.rs:25
DEFAULT_HOP_DIVISOR = 16  # reference processor.rs:24
DEFAULT_DB_FLOOR = -100.0  # reference processor.rs:22
MAX_EXP_FACTOR = 0.95  # reference processor.rs:17
MAX_PEAK_DECAY = 120.0  # reference processor.rs:19
MAX_TRACES = 2  # primary + secondary (processor.rs:24-51)


class AveragingMode(enum.Enum):
    """Structural averaging mode (reference processor.rs:64-70); the factor /
    decay parameter rides in :class:`SpectrumConfig`."""

    NONE = "none"
    EXPONENTIAL = "exponential"
    PEAK_HOLD = "peak_hold"


class SpectrumSnapshot(NamedTuple):
    weighted_db: jnp.ndarray  # [S, trace_count, bins] A-weighted dB
    raw_db: jnp.ndarray  # [S, trace_count, bins]
    updated: jnp.ndarray  # [S] bool — any column produced this step


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    sample_rate: float = 48_000.0
    fft_size: int = DEFAULT_FFT_SIZE
    hop_size: int = DEFAULT_FFT_SIZE // DEFAULT_HOP_DIVISOR
    window: WindowKind = WindowKind.HANN
    averaging: AveragingMode = AveragingMode.NONE
    exp_factor: float = 0.5  # reference DEFAULT_SPECTRUM_EXP_FACTOR
    peak_decay_db_per_s: float = 12.0  # reference DEFAULT_SPECTRUM_PEAK_DECAY
    source: Channel = Channel.MID
    secondary_source: Channel = Channel.NONE
    floor_db: float = DEFAULT_DB_FLOOR
    block_frames: int = 256

    def normalized(self) -> "SpectrumConfig":
        from openmeters_tpu.utils.level import sanitize_negative_db, sanitize_sample_rate

        fft = max(self.fft_size, 1)
        hop = self.hop_size or max(fft // DEFAULT_HOP_DIVISOR, 1)
        return dataclasses.replace(
            self,
            sample_rate=sanitize_sample_rate(self.sample_rate),
            fft_size=fft,
            hop_size=hop,
            floor_db=sanitize_negative_db(self.floor_db, DEFAULT_DB_FLOOR),
        )

    @property
    def active_sources(self) -> tuple[Channel, ...]:
        """The traces that actually run (reference ``active_traces``,
        processor.rs:174-177): ``Channel.NONE`` and a duplicate secondary are
        skipped *statically*, so the default config (secondary=NONE) compiles
        half the sliding-DFT/smoothing lanes.  Degenerate all-NONE configs
        keep one silent lane so snapshot shapes stay well-formed."""
        out = []
        for ch in (self.source, self.secondary_source):
            if ch is not Channel.NONE and ch not in out:
                out.append(ch)
        return tuple(out) or (Channel.NONE,)

    @property
    def trace_count(self) -> int:
        return len(self.active_sources)

    def default_projections(self) -> np.ndarray:
        """``[trace_count, 2]`` stereo projections for the active traces."""
        return np.stack([projection_vector(ch) for ch in self.active_sources])


@dataclasses.dataclass(frozen=True)
class SpectrumAnalyzer:
    config: SpectrumConfig = SpectrumConfig()

    @property
    def bins(self) -> int:
        return self.config.fft_size // 2 + 1

    @property
    def _frames(self) -> FrameBuffer:
        return FrameBuffer(
            self.config.fft_size, self.config.hop_size, self.config.block_frames
        )

    @property
    def frequency_bins(self) -> np.ndarray:
        """Bin center frequencies (reference ``SpectrumSnapshot::frequency_bins``)."""
        bin_hz = self.config.sample_rate / self.config.fft_size
        return (np.arange(self.bins) * bin_hz).astype(np.float32)

    @property
    def a_weighting(self) -> np.ndarray:
        return a_weight_db(self.frequency_bins)

    @property
    def state_floor(self) -> float:
        """Power floor for averaging state: positive weighting headroom keeps
        sub-floor bins dark (reference smoothing_state_floor,
        processor.rs:332-336)."""
        headroom = float(np.maximum(np.max(self.a_weighting), 0.0))
        return max(
            db_to_power_host(self.config.floor_db - headroom),
            float(np.finfo(np.float32).tiny),
        )

    @property
    def _sliding(self):
        from openmeters_tpu.ops.sliding_stft import SlidingSTFT

        cfg = self.config
        return SlidingSTFT(cfg.fft_size, cfg.hop_size, cfg.block_frames, cfg.window)

    @property
    def use_sliding(self) -> bool:
        """Sliding DFT vs direct windowed rFFT, by hop density.

        The slide pays a ``[hop, bins]`` delta matmul per hop, so it only
        wins when many hops share one window: the stock spectrum shape
        (hop = fft/16, cadenced to hop == block) takes the direct transform,
        while the spectrogram's hop-64 shapes (fft/hop >= 32) slide.  The cond-held hop > block path keeps
        the slide regardless: the direct branch would transform every
        engine hop only to mask the result invalid.
        """
        cfg = self.config
        if not self._sliding.supported:
            return False
        if cfg.hop_size > cfg.block_frames:
            return True
        return cfg.fft_size // cfg.hop_size > 16

    def init(self, n_streams: int) -> dict:
        floor = self.config.floor_db
        tc = self.config.trace_count
        carry = {
            "fb": self._frames.init(n_streams * tc),
            "smoothed": jnp.zeros((n_streams, tc, self.bins), jnp.float32),
        }
        if self.use_sliding and self.config.hop_size > self.config.block_frames:
            # held dB outputs: recomputed only on hops that emit a column
            # (the log/A-weight passes over [S, 2, bins] dominate idle hops)
            carry["raw_db"] = jnp.full(
                (n_streams, tc, self.bins), floor, jnp.float32
            )
            carry["weighted_db"] = jnp.full(
                (n_streams, tc, self.bins), floor, jnp.float32
            )
        if self.use_sliding:
            carry["sdft"] = self._sliding.init(n_streams * tc)
        return carry

    def migrate_from(self, old: "SpectrumAnalyzer", carry: dict, n_streams: int):
        """Field-level carry retention across a config change (reference
        ``update_config``, processor.rs:300-326):

        - fft_size / window / block change: full re-init (``None``).
        - sample_rate / hop / source / secondary change: ``reset_buffers`` —
          fresh PCM and level state.
        - averaging MODE or floor change: ``reset_level_buffers`` — the
          framing + sliding PCM state is KEPT (the next hop emits a column
          from the existing audio), only the smoothing state resets.
        - factor change within the same mode (exp_factor, peak_decay):
          nothing resets; the carry continues under the new constants.
        """
        a, b = old.config, self.config
        if a == b:
            return carry
        if (a.fft_size, a.window, a.block_frames) != (
            b.fft_size, b.window, b.block_frames
        ):
            return None
        fresh = self.init(n_streams)
        if (a.sample_rate, a.hop_size, a.source, a.secondary_source) != (
            b.sample_rate, b.hop_size, b.source, b.secondary_source
        ):
            return fresh
        if (a.averaging is not b.averaging) or (a.floor_db != b.floor_db):
            out = dict(fresh)
            out["fb"] = carry["fb"]
            if "sdft" in carry and "sdft" in fresh:
                out["sdft"] = carry["sdft"]
            return out
        return carry

    def _to_db(self, out_power):
        """Power -> (raw_db, weighted_db) with the weighted state floor
        (reference processor.rs:325-403)."""
        state_floor = self.state_floor
        floor = self.config.floor_db
        weighting = jnp.asarray(self.a_weighting)
        db = jnp.log(jnp.maximum(out_power, 1e-45)) * LN_TO_DB
        below = out_power < state_floor
        raw_db = jnp.where(below, floor, jnp.maximum(db, floor))
        weighted_db = jnp.where(below, floor, jnp.maximum(db + weighting, floor))
        return raw_db, weighted_db

    @functools.partial(jax.jit, static_argnums=0)
    def emit(self, carry: dict) -> SpectrumSnapshot:
        """Snapshot of the carry's current averaging state WITHOUT advancing.

        Used to re-prime a serving loop's held spectrum snapshot after a
        checkpoint restore (the held device snapshot otherwise reports the
        discarded run's spectrum until the next spectrum hop).  ``updated``
        is all-False: no new column was produced.
        """
        if self.use_sliding and self.config.hop_size > self.config.block_frames:
            raw_db, weighted_db = carry["raw_db"], carry["weighted_db"]
        else:
            raw_db, weighted_db = self._to_db(carry["smoothed"])
        s = raw_db.shape[0]
        return SpectrumSnapshot(
            weighted_db=weighted_db,
            raw_db=raw_db,
            updated=jnp.zeros((s,), bool),
        )

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, projections=None, reset_mask=None):
        """One hop of ``[S, B, 2]`` folded stereo samples.

        Args:
          projections: ``[S, 2, 2]`` per-stream trace projection vectors
            (defaults to the config's source/secondary).
          reset_mask: ``[S]`` bool stream restarts.

        Returns ``(carry, SpectrumSnapshot)``.  Between updates the previous
        dB outputs would be held by the caller; ``updated`` flags new data.
        """
        cfg = self.config
        s, b, _ = block.shape
        tc = cfg.trace_count
        if projections is None:
            projections = jnp.broadcast_to(
                jnp.asarray(cfg.default_projections()), (s, tc, 2)
            )
        traces = jnp.einsum(
            "sbc,stc->stb", block, projections, precision=jax.lax.Precision.HIGHEST
        )  # [S, 2, B]

        lane_reset = None
        if reset_mask is not None:
            lane_reset = jnp.repeat(reset_mask, tc)
        fb = self._frames
        fb_carry, info = fb.advance(
            carry["fb"], traces.reshape(s * tc, b), lane_reset
        )
        valid = info["valid"].reshape(s, tc, fb.cols_cap)

        w = window_coefficients(cfg.window, cfg.fft_size)
        norm = fft_bin_normalization(w, cfg.fft_size)
        state_floor = self.state_floor
        dt = cfg.hop_size / cfg.sample_rate

        def smooth_cols(smoothed, power):
            for col in range(fb.cols_cap):
                p = power[:, :, col]
                v = valid[:, :, col][..., None]
                if cfg.averaging is AveragingMode.NONE:
                    # 'smoothed' doubles as last-raw-power retention so
                    # snapshots hold between hops (the reference keeps
                    # outputs in self.snapshot across process_block calls).
                    smoothed = jnp.where(v, p, smoothed)
                elif cfg.averaging is AveragingMode.EXPONENTIAL:
                    alpha = min(max(cfg.exp_factor, 0.0), 0.9999)
                    nxt = jnp.where(
                        smoothed <= 0.0, p, smoothed * alpha + p * (1 - alpha)
                    )
                    nxt = jnp.where(nxt < state_floor, 0.0, nxt)
                    smoothed = jnp.where(v, nxt, smoothed)
                else:  # PEAK_HOLD
                    decay = db_to_power_host(
                        -max(cfg.peak_decay_db_per_s, 0.0) * dt
                    )
                    nxt = jnp.maximum(smoothed * decay, p)
                    nxt = jnp.where(nxt < state_floor, 0.0, nxt)
                    smoothed = jnp.where(v, nxt, smoothed)
            return smoothed

        to_db = self._to_db

        new_carry = {"fb": fb_carry}
        if self.use_sliding:
            # hop-rate sliding DFT columns (ops/sliding_stft.py).  With
            # hop > block most engine steps emit no column — the slide,
            # smoothing, and the log/A-weight output passes all skip under
            # one scalar cond (ready is global: resets re-align to the hop
            # grid), holding the previous dB outputs in the carry.
            def slide(sdft):
                sdft2, p = self._sliding.step(sdft, info)
                return sdft2, p * norm

            smoothed0 = carry["smoothed"]
            if reset_mask is not None:
                smoothed0 = jnp.where(reset_mask[:, None, None], 0.0, smoothed0)

            if cfg.hop_size > cfg.block_frames:
                any_reset = (
                    jnp.any(reset_mask)
                    if reset_mask is not None
                    else jnp.bool_(False)
                )

                def advance(op):
                    sdft, smoothed, _, _ = op
                    sdft2, power = slide(sdft)
                    power = power.reshape(s, tc, fb.cols_cap, self.bins)
                    sm = smooth_cols(smoothed, power)
                    raw_db, weighted_db = to_db(sm)
                    return sdft2, sm, raw_db, weighted_db

                op = (
                    carry["sdft"], smoothed0,
                    carry["raw_db"], carry["weighted_db"],
                )
                new_sdft, smoothed, raw_db, weighted_db = jax.lax.cond(
                    (info["ready"] > 0) | any_reset, advance, lambda op: op, op
                )
                new_carry["raw_db"] = raw_db
                new_carry["weighted_db"] = weighted_db
            else:
                new_sdft, power = slide(carry["sdft"])
                power = power.reshape(s, tc, fb.cols_cap, self.bins)
                smoothed = smooth_cols(smoothed0, power)
                raw_db, weighted_db = to_db(smoothed)
            new_carry["sdft"] = new_sdft
        else:
            frames = fb.extract(info).reshape(
                s, tc, fb.cols_cap, cfg.fft_size
            )
            mean = jnp.mean(frames, axis=-1, keepdims=True)
            spec = rfft_mxu((frames - mean) * w, cfg.fft_size)
            power = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2) * norm
            smoothed = carry["smoothed"]
            if reset_mask is not None:
                smoothed = jnp.where(reset_mask[:, None, None], 0.0, smoothed)
            smoothed = smooth_cols(smoothed, power)
            raw_db, weighted_db = to_db(smoothed)

        new_carry["smoothed"] = smoothed
        return new_carry, SpectrumSnapshot(
            weighted_db=weighted_db,
            raw_db=raw_db,
            updated=jnp.any(valid, axis=(1, 2)),
        )
