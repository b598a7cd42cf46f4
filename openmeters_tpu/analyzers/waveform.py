"""Waveform: min/max column reduction + 3-band color / RMS history.

Reference parity: ``src/visuals/waveform/processor.rs`` — four derived lanes
(L, R, Mid, Side) reduced to min/max columns at fractional cadence
``scroll_speed / sample_rate`` with last-sample carry-over for visual
continuity (processor.rs:119-289); optional per-lane 3-band color analysis
(single-biquad ``ThreeBand`` on L/R only, Mid/Side derived as (L±R)/2 —
equivalence proven by reference test processor.rs:411-436) through trailing
windows of 2048/16384 samples @44.1k scaled by rate with gains
[1.0, 0.7, 2.0]; optional RMS fast/slow dB history per band
(processor.rs:199-222); non-finite samples are sanitized for the filters and
break min/max continuity (processor.rs:264-289).

Batched formulation:

- The fractional column phase is *exact integer arithmetic*: the cadence is
  the rational ``p/q`` with ``p = round(scroll*256)``, ``q = round(rate*256)``
  and the carry is one int32 residue per stream — no float drift (the
  reference carries an f64 phase for the same reason; its test demands
  <1e-8 drift over 10k samples, which integers satisfy exactly).
- Column membership per sample is ``(r + n*p) // q``; per-step emissions are
  bounded by the static capacity, so columns are fixed ``[S, cap, ...]``
  masked reductions.
- Band means at emission positions are exact trailing-window sums assembled
  from a **block-granular circular ring** (the ``ops/windowed.py`` trick
  extended to arbitrary in-block read positions): per hop we keep per-block
  sums of |band| and band² plus the raw band samples, and a window ending at
  in-block position ``pos`` decomposes into (new-block prefix sum) + (whole
  ring-block totals) + (a suffix of the two blocks aged ~W samples).  All
  reads are O(block) per hop instead of the naive O(W) cumsum over
  ``[S, W+B, 12]`` (W is 17.8k samples for the slow RMS window @48 kHz), the
  ring write is an O(block) ``dynamic_update_slice`` instead of an O(W)
  concatenate-roll, and every sum is recomputed fresh from stored block sums
  so there is zero accumulation drift.  Resets are free: ring slots older
  than the per-stream sample counter are masked out instead of zeroed.
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
from openmeters_tpu.utils.level import DB_FLOOR, power_to_db

NUM_BANDS = 3
DERIVED_CHANNELS = 4  # L, R, Mid, Side (processor.rs:16-18)
REFERENCE_SAMPLE_RATE = 44_100.0
BAND_COLOR_WINDOW_AT_44K1 = 2048  # processor.rs:20
BAND_SLOW_WINDOW_AT_44K1 = 16_384  # processor.rs:21
BAND_COLOR_GAINS = np.array([1.0, 0.7, 2.0], np.float32)  # processor.rs:22
MAX_TRACKER_SAMPLE_RATE = 1_000_000.0  # processor.rs:24
PHASE_SCALE = 256  # rational cadence denominator scale

# [2, 4] projection: stereo -> (L, R, M, S)
DERIVED_PROJ = np.array([[1.0, 0.0, 0.5, 0.5], [0.0, 1.0, 0.5, -0.5]], np.float32)
_BIG = np.float32(3.4e38)


def window_len(samples_at_reference_rate: int, sample_rate: float) -> int:
    """reference processor.rs:76-80."""
    rate = min(sample_rate, MAX_TRACKER_SAMPLE_RATE)
    return max(int(round(samples_at_reference_rate * rate / REFERENCE_SAMPLE_RATE)), 1)


class WaveformSnapshot(NamedTuple):
    """Emitted columns + pending-column preview (processor.rs:52-74)."""

    col_min: jnp.ndarray  # [S, cap, 4]
    col_max: jnp.ndarray  # [S, cap, 4]
    col_color: jnp.ndarray  # [S, cap, 4, 3]
    col_rms_db: jnp.ndarray  # [S, cap, 2, 4, 3] (fast/slow, channel, band)
    col_valid: jnp.ndarray  # [S, cap]
    preview_min: jnp.ndarray  # [S, 4]
    preview_max: jnp.ndarray  # [S, 4]
    preview_color: jnp.ndarray  # [S, 4, 3]
    preview_rms_db: jnp.ndarray  # [S, 2, 4, 3]
    progress: jnp.ndarray  # [S] pending column phase in [0, 1)


@dataclasses.dataclass(frozen=True)
class WaveformConfig:
    sample_rate: float = 48_000.0
    scroll_speed: float = 300.0  # columns per second (processor.rs:13)
    analyze_bands: bool = True
    track_history: bool = False
    block_frames: int = 256

    def resolved(self) -> "WaveformConfig":
        speed = self.scroll_speed
        if not (isinstance(speed, (int, float)) and math.isfinite(speed) and speed > 0):
            speed = 300.0
        speed = max(speed, 1.0)  # MIN_RUNTIME_SCROLL_SPEED (processor.rs:15)
        return dataclasses.replace(
            self,
            scroll_speed=float(speed),
            track_history=self.track_history and self.analyze_bands,
        )


@dataclasses.dataclass(frozen=True)
class WaveformAnalyzer:
    config: WaveformConfig = WaveformConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolved())

    @property
    def _pq(self) -> tuple[int, int]:
        cfg = self.config
        q = max(int(round(cfg.sample_rate * PHASE_SCALE)), 1)
        p = max(int(round(cfg.scroll_speed * PHASE_SCALE)), 1)
        return min(p, q), q  # step clamped to <= 1 column/sample

    @property
    def cols_cap(self) -> int:
        p, q = self._pq
        return (self.config.block_frames * p + q - 1) // q + 2

    @property
    def color_window(self) -> int:
        return window_len(BAND_COLOR_WINDOW_AT_44K1, self.config.sample_rate)

    @property
    def slow_window(self) -> int:
        return window_len(BAND_SLOW_WINDOW_AT_44K1, self.config.sample_rate)

    def _block_age(self, window: int) -> int:
        """Oldest whole-block age below the suffix pair for ``window``."""
        b = self.config.block_frames
        return max((window - b - 1) // b, 0)

    @property
    def ring_blocks(self) -> int:
        """Circular-ring capacity: a window read touches block ages up to
        ``_block_age(w) + 1``."""
        w = self.slow_window if self.config.track_history else self.color_window
        return self._block_age(w) + 2

    def init(self, n_streams: int) -> dict:
        s = n_streams
        b = self.config.block_frames
        carry = {
            "phase_r": jnp.zeros((s,), jnp.int32),
            "cur_min": jnp.zeros((s, DERIVED_CHANNELS), jnp.float32),
            "cur_max": jnp.zeros((s, DERIVED_CHANNELS), jnp.float32),
            "cur_has": jnp.zeros((s, DERIVED_CHANNELS), bool),
            "last_val": jnp.zeros((s, DERIVED_CHANNELS), jnp.float32),
            "last_ok": jnp.zeros((s, DERIVED_CHANNELS), bool),
        }
        if self.config.analyze_bands:
            k, lanes = self.ring_blocks, DERIVED_CHANNELS * NUM_BANDS
            carry["tb"] = three_band_init((s, 2), 1)
            carry["count"] = jnp.zeros((s,), jnp.int32)
            carry["ring_head"] = jnp.zeros((), jnp.int32)
            carry["raw_ring"] = jnp.zeros((s, k, b, lanes), jnp.float32)
            carry["color_tot"] = jnp.zeros((s, k, lanes), jnp.float32)
            if self.config.track_history:
                carry["power_tot"] = jnp.zeros((s, k, lanes), jnp.float32)
        return carry

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, reset_mask=None):
        """One hop of ``[S, B, 2]`` folded stereo. Returns (carry, snapshot)."""
        cfg = self.config
        s, b, _ = block.shape
        p, q = self._pq
        cap = self.cols_cap

        derived = jnp.einsum(
            "sbc,cd->sbd", block.astype(jnp.float32), DERIVED_PROJ, precision=jax.lax.Precision.HIGHEST
        )
        fin = jnp.isfinite(derived)  # [S, B, 4]

        phase_r = carry["phase_r"]
        cur_min, cur_max, cur_has = carry["cur_min"], carry["cur_max"], carry["cur_has"]
        last_val, last_ok = carry["last_val"], carry["last_ok"]
        if reset_mask is not None:
            phase_r = jnp.where(reset_mask, 0, phase_r)
            cur_has = jnp.where(reset_mask[:, None], False, cur_has)
            last_ok = jnp.where(reset_mask[:, None], False, last_ok)

        # -- exact integer column cadence (int32 is safe: r < q <= 2e8 and
        # B*p <= 1.1e9 for B<=4096, scroll<=1000, rate<=768k) -------------------
        n = np.arange(b, dtype=np.int32)
        r64 = phase_r.astype(jnp.int32)[:, None]
        col = (r64 + n[None, :] * p) // q  # [S, B]
        e_tot = (r64[:, 0] + b * p) // q  # [S] emissions
        new_phase_r = (r64[:, 0] + b * p) % q

        ks = np.arange(cap, dtype=np.int32)
        is_col = col[:, :, None] == ks[None, None, :]  # [S, B, cap]
        col_next = jnp.concatenate(
            [col[:, 1:], jnp.full((s, 1), 2**30, jnp.int32)], axis=1
        )
        closes = (col_next > col)[:, :, None]  # sample is last of its column
        cont = (col[:, :, None] == (ks[None, None, :] - 1)) & closes
        memb = (is_col | cont)[:, :, :, None] & fin[:, :, None, :]  # [S,B,cap,4]

        vals = derived[:, :, None, :]
        col_min = jnp.min(jnp.where(memb, vals, _BIG), axis=1)  # [S, cap, 4]
        col_max = jnp.max(jnp.where(memb, vals, -_BIG), axis=1)
        col_any = jnp.any(memb, axis=1)

        # merge carried pending stats + carried continuity sample into column 0
        m0 = jnp.minimum(
            jnp.where(cur_has, cur_min, _BIG), jnp.where(last_ok, last_val, _BIG)
        )
        x0 = jnp.maximum(
            jnp.where(cur_has, cur_max, -_BIG), jnp.where(last_ok, last_val, -_BIG)
        )
        col_min = col_min.at[:, 0].min(m0)
        col_max = col_max.at[:, 0].max(x0)
        col_any = col_any.at[:, 0].set(col_any[:, 0] | cur_has | last_ok)

        col_min = jnp.where(col_any, col_min, 0.0)
        col_max = jnp.where(col_any, col_max, 0.0)
        col_valid = ks[None, :] < e_tot[:, None]

        # pending (preview) column lives at per-stream slot e_tot; one-hot
        # selections run in full f32 so the selected value stays exact
        pend_slot = jnp.minimum(e_tot, cap - 1)
        slot_oh = (ks[None, :] == pend_slot[:, None]).astype(jnp.float32)
        pv_min = jnp.einsum("sk,skd->sd", slot_oh, col_min, precision=jax.lax.Precision.HIGHEST)
        pv_max = jnp.einsum("sk,skd->sd", slot_oh, col_max, precision=jax.lax.Precision.HIGHEST)

        # -- carries: pending min/max and continuity sample --------------------
        in_pend = (col == e_tot[:, None])[:, :, None] & fin  # [S, B, 4]
        pend_min = jnp.min(jnp.where(in_pend, derived, _BIG), axis=1)
        pend_max = jnp.max(jnp.where(in_pend, derived, -_BIG), axis=1)
        pend_has = jnp.any(in_pend, axis=1)
        emitted = (e_tot > 0)[:, None]
        new_cur_has = jnp.where(emitted, pend_has, cur_has | pend_has)
        new_cur_min = jnp.where(
            emitted,
            pend_min,
            jnp.minimum(jnp.where(cur_has, cur_min, _BIG), pend_min),
        )
        new_cur_max = jnp.where(
            emitted,
            pend_max,
            jnp.maximum(jnp.where(cur_has, cur_max, -_BIG), pend_max),
        )
        new_cur_min = jnp.where(new_cur_has, new_cur_min, 0.0)
        new_cur_max = jnp.where(new_cur_has, new_cur_max, 0.0)

        # continuity value: final sample of the last emitted column, if finite
        # and no non-finite sample arrived after it (processor.rs:270-289)
        bnd = (e_tot * q - r64[:, 0] + p - 1) // p - 1
        bnd = jnp.clip(bnd, 0, b - 1)  # [S]
        bnd_oh = (n[None, :] == bnd[:, None]).astype(jnp.float32)
        bval = jnp.einsum("sb,sbd->sd", bnd_oh, derived, precision=jax.lax.Precision.HIGHEST)  # [S, 4]
        bfin = jnp.einsum(
            "sb,sbd->sd", bnd_oh, fin.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST
        ) > 0.5
        after = n[None, :] > bnd[:, None]  # [S, B]
        bad_after = jnp.any(after[:, :, None] & ~fin, axis=1)
        bad_any = jnp.any(~fin, axis=1)
        new_last_val = jnp.where(emitted, bval, last_val)
        new_last_ok = jnp.where(emitted, bfin & ~bad_after, last_ok & ~bad_any)

        new_carry = {
            "phase_r": new_phase_r,
            "cur_min": new_cur_min,
            "cur_max": new_cur_max,
            "cur_has": new_cur_has,
            "last_val": new_last_val,
            "last_ok": new_last_ok,
        }

        # -- band analysis ------------------------------------------------------
        col_color = jnp.zeros((s, cap, DERIVED_CHANNELS, NUM_BANDS), jnp.float32)
        col_rms = jnp.full((s, cap, 2, DERIVED_CHANNELS, NUM_BANDS), DB_FLOOR, jnp.float32)
        pv_color = jnp.zeros((s, DERIVED_CHANNELS, NUM_BANDS), jnp.float32)
        pv_rms = jnp.full((s, 2, DERIVED_CHANNELS, NUM_BANDS), DB_FLOOR, jnp.float32)

        if cfg.analyze_bands:
            assert b == cfg.block_frames, "band ring cadence requires fixed blocks"
            lanes = DERIVED_CHANNELS * NUM_BANDS
            k = self.ring_blocks
            tb, count = carry["tb"], carry["count"]
            if reset_mask is not None:
                tb = jnp.where(reset_mask[None, None, None, :, None], 0.0, tb)
                count = jnp.where(reset_mask, 0, count)

            lr = jnp.transpose(block.astype(jnp.float32), (1, 0, 2))  # [B, S, 2]
            lr = jnp.where(jnp.transpose(fin[..., :2], (1, 0, 2)), lr, 0.0)
            fbands, tb = three_band_scan(
                lr, tb, cfg.sample_rate, cascade_n=1, cascade_high=False
            )  # [B, 3, S, 2]
            fl, fr = fbands[..., 0], fbands[..., 1]
            dbands = jnp.stack([fl, fr, (fl + fr) * 0.5, (fl - fr) * 0.5], axis=-1)
            dbands = jnp.transpose(dbands, (2, 0, 3, 1))  # [S, B, 4, 3]
            dbands = jnp.where(fin[:, :, :, None], dbands, 0.0)
            dbands = jnp.where(jnp.isfinite(dbands), dbands, 0.0)
            flat = dbands.reshape(s, b, lanes)  # [S, B, 12]
            gains12 = np.tile(BAND_COLOR_GAINS, DERIVED_CHANNELS)

            head = carry["ring_head"]
            raw = carry["raw_ring"]
            blocks_cnt = count // b  # whole blocks since reset
            ages = (head - 1 - jnp.arange(k, dtype=jnp.int32)) % k  # [K] slot ages

            # positions: last sample of column k = ceil(((k+1) q - r) / p) - 1;
            # final slot doubles as the preview position (block end).
            kq = (ks[None, :] + 1) * q
            pos = (kq - r64 + p - 1) // p - 1
            pos = jnp.clip(pos, 0, b - 1)  # [S, cap]
            pos_all = jnp.concatenate(
                [pos, jnp.full((s, 1), b - 1, jnp.int32)], axis=1
            )  # [S, cap+1]

            def read_pair(a0: int):
                """[S, 2B, lanes] raw samples of block ages a0+1 (older half)
                and a0, zeroed where the block predates the stream's reset."""
                s_old = (head - 2 - a0) % k
                s_new = (head - 1 - a0) % k
                older = jax.lax.dynamic_slice(raw, (0, s_old, 0, 0), (s, 1, b, lanes))
                newer = jax.lax.dynamic_slice(raw, (0, s_new, 0, 0), (s, 1, b, lanes))
                pair = jnp.concatenate([older[:, 0], newer[:, 0]], axis=1)
                valid = jnp.concatenate(
                    [
                        jnp.broadcast_to((blocks_cnt > a0 + 1)[:, None], (s, b)),
                        jnp.broadcast_to((blocks_cnt > a0)[:, None], (s, b)),
                    ],
                    axis=1,
                )
                return jnp.where(valid[:, :, None], pair, 0.0)

            def base_total(tot_ring, a0: int):
                """Sum of whole-block totals at ages 0..a0-1 (post-reset only)."""
                mask = (ages[None, :] < a0) & (ages[None, :] < blocks_cnt[:, None])
                return jnp.sum(jnp.where(mask[:, :, None], tot_ring, 0.0), axis=1)

            def window_means(new_vals, pair_vals, base_tot, window: int):
                """Trailing mean over `window` samples ending at pos_all
                (inclusive): new-block prefix + whole-block totals + a suffix
                of the two ~window-aged ring blocks.  The prefix/suffix sums
                at the few emission positions run as masked batched matmuls
                in full f32."""
                a0 = self._block_age(window)
                m = window - 1 - pos_all  # [S, cap+1] history samples needed
                idx = jnp.clip(m - a0 * b, 0, 2 * b)
                bidx = np.arange(b, dtype=np.int32)
                new_mask = (
                    bidx[None, None, :] <= pos_all[:, :, None]
                ).astype(jnp.float32)
                newsum = jnp.einsum("spb,sbl->spl", new_mask, new_vals, precision=jax.lax.Precision.HIGHEST)
                pidx = np.arange(2 * b, dtype=np.int32)
                pair_mask = (
                    pidx[None, None, :] >= (2 * b - idx)[:, :, None]
                ).astype(jnp.float32)
                hist = jnp.einsum("spb,sbl->spl", pair_mask, pair_vals, precision=jax.lax.Precision.HIGHEST)
                total = newsum + hist + base_tot[:, None, :]  # [S, cap+1, lanes]
                n_at = jnp.minimum(
                    (count[:, None] + pos_all + 1).astype(jnp.float32), float(window)
                )
                return (total / n_at[..., None]).reshape(
                    s, -1, DERIVED_CHANNELS, NUM_BANDS
                )

            a0_color = self._block_age(self.color_window)
            pair_color_raw = read_pair(a0_color)
            color_tot = carry["color_tot"]
            cm = window_means(
                jnp.abs(flat) * gains12,
                jnp.abs(pair_color_raw) * gains12,
                base_total(color_tot, a0_color),
                self.color_window,
            )
            col_color = jnp.maximum(cm[:, :cap], 0.0)
            pv_color = jnp.maximum(cm[:, cap], 0.0)

            slot = head % k
            new_carry["tb"] = tb
            new_carry["count"] = jnp.minimum(count + b, jnp.int32(2**30))
            new_carry["ring_head"] = (head + 1) % k
            new_carry["raw_ring"] = jax.lax.dynamic_update_slice(
                raw, flat[:, None], (0, slot, 0, 0)
            )
            new_carry["color_tot"] = jax.lax.dynamic_update_slice(
                color_tot,
                jnp.sum(jnp.abs(flat) * gains12, axis=1)[:, None],
                (0, slot, 0),
            )

            if cfg.track_history:
                power_tot = carry["power_tot"]
                powers = flat * flat
                fast = window_means(
                    powers,
                    pair_color_raw * pair_color_raw,
                    base_total(power_tot, a0_color),
                    self.color_window,
                )
                a0_slow = self._block_age(self.slow_window)
                pair_slow_raw = read_pair(a0_slow)
                slow = window_means(
                    powers,
                    pair_slow_raw * pair_slow_raw,
                    base_total(power_tot, a0_slow),
                    self.slow_window,
                )
                rms = jnp.stack(
                    [
                        power_to_db(jnp.maximum(fast, 0.0), DB_FLOOR),
                        power_to_db(jnp.maximum(slow, 0.0), DB_FLOOR),
                    ],
                    axis=2,
                )  # [S, cap+1, 2, 4, 3]
                col_rms = rms[:, :cap]
                pv_rms = rms[:, cap]
                new_carry["power_tot"] = jax.lax.dynamic_update_slice(
                    power_tot, jnp.sum(powers, axis=1)[:, None], (0, slot, 0)
                )

        progress = new_phase_r.astype(jnp.float32) / float(q)
        return new_carry, WaveformSnapshot(
            col_min=col_min,
            col_max=col_max,
            col_color=col_color,
            col_rms_db=col_rms,
            col_valid=col_valid,
            preview_min=pv_min,
            preview_max=pv_max,
            preview_color=pv_color,
            preview_rms_db=pv_rms,
            progress=progress,
        )

    def migrate_from(self, old: "WaveformAnalyzer", carry: dict, n_streams: int):
        """Reference ``update_config`` (processor.rs:336-351): a sample-rate
        change rebuilds; analyze_bands/track_history toggles reset the band
        trackers but keep the min/max column state; a scroll_speed change
        keeps everything (the column phase carries over under the new
        cadence constants)."""
        a, b = old.config.resolved(), self.config.resolved()
        if a == b:
            return carry
        if (a.sample_rate, a.block_frames) != (b.sample_rate, b.block_frames):
            return None
        from openmeters_tpu.utils.migrate import merge_carry

        out = merge_carry(self.init(n_streams), carry)
        if (a.analyze_bands, a.track_history) != (b.analyze_bands, b.track_history):
            fresh = self.init(n_streams)
            for k in ("tb", "count", "ring_head", "raw_ring", "color_tot", "power_tot"):
                if k in fresh:
                    out[k] = fresh[k]  # reset_trackers
        return out

    def pspecs(self, axis: str):
        from jax.sharding import PartitionSpec as P

        specs = {
            "phase_r": P(axis),
            "cur_min": P(axis, None),
            "cur_max": P(axis, None),
            "cur_has": P(axis, None),
            "last_val": P(axis, None),
            "last_ok": P(axis, None),
        }
        if self.config.analyze_bands:
            specs["tb"] = P(None, None, None, axis, None)
            specs["count"] = P(axis)
            specs["ring_head"] = P()
            specs["raw_ring"] = P(axis, None, None, None)
            specs["color_tot"] = P(axis, None, None)
            if self.config.track_history:
                specs["power_tot"] = P(axis, None, None)
        return specs
