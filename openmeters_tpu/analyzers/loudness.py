"""BS.1770-5 loudness suite, batched over streams.

Reference parity: ``src/visuals/loudness/processor.rs`` — K-weighted
short-term (3.0 s) and momentary (0.4 s) LUFS with surround channel weights,
per-channel RMS fast (0.3 s) / slow (1.0 s), and libebur128-compatible
4x/2x-oversampled true peak.

Batched formulation:

- K-weighting runs as the cascade of the two BS.1770 second-order sections,
  lifted to one block state-space map per hop (numerically gentler in f32
  than the reference's convolved 5-tap f64 form, identical in exact
  arithmetic).
- The four trailing windows are drift-free block-sum rings
  (:class:`~openmeters_tpu.ops.windowed.BlockWindowedMeans`) queried once per
  hop — the batched equivalent of ``WindowedMeans<1,4>`` per channel.
- The reference's lazy per-channel activation (processor.rs:166-171,264-279)
  is *provably* equivalent to eager processing: zero samples leave the filter
  state, window sums and peak at zero while the frame counter advances, which
  is exactly what ``with_leading_zeros`` seeds.  The batched path is eager.

Inputs are ``[n_streams, hop, channels]`` raw (un-folded) channel samples
plus per-stream BS.1770 channel weights; padded channels carry zeros and
weight is irrelevant (zero mean-square).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from openmeters_tpu.ops.iir import flush_denormal_state, lifted_iir_scan
from openmeters_tpu.ops.truepeak import TruePeakKernel
from openmeters_tpu.ops.windowed import BlockWindowedMeans
from openmeters_tpu.utils.channels import MAX_AUDIO_CHANNELS
from openmeters_tpu.utils.level import power_to_db
from openmeters_tpu.utils.weighting import k_weighting_sos

LOUDNESS_OFFSET = -0.691  # BS.1770 constant (reference processor.rs:10)
DEFAULT_FLOOR_DB = -99.9  # reference processor.rs:11
# short-term, momentary, RMS-fast, RMS-slow (reference processor.rs:13)
DEFAULT_WINDOWS_SECONDS = (3.0, 0.4, 0.3, 1.0)


def window_length(sample_rate: float, seconds: float) -> int:
    """Truncating window sizing (reference processor.rs:68-71)."""
    n = sample_rate * seconds
    return 1 if n < 1.0 else int(n)


class LoudnessSnapshot(NamedTuple):
    """Batched analogue of ``LoudnessSnapshot`` (processor.rs:185-194), plus
    gated integration (BS.1770-5 §3 / EBU R128 — absent from the reference,
    demanded by BASELINE.json's north star)."""

    short_term_lufs: jnp.ndarray  # [S]
    momentary_lufs: jnp.ndarray  # [S]
    rms_fast_db: jnp.ndarray  # [S, C]
    rms_slow_db: jnp.ndarray  # [S, C]
    true_peak_db: jnp.ndarray  # [S, C]
    integrated_lufs: jnp.ndarray  # [S] gated (−70 abs, −10 rel)
    lra_lu: jnp.ndarray  # [S] EBU Tech 3342 loudness range


@dataclasses.dataclass(frozen=True)
class LoudnessConfig:
    sample_rate: float = 48_000.0
    floor_db: float = DEFAULT_FLOOR_DB
    block_frames: int = 256
    channels: int = MAX_AUDIO_CHANNELS
    gating: bool = True  # integrated loudness + LRA state


@dataclasses.dataclass(frozen=True)
class LoudnessAnalyzer:
    config: LoudnessConfig = LoudnessConfig()

    @property
    def _windows(self) -> BlockWindowedMeans:
        cfg = self.config
        lengths = tuple(
            window_length(cfg.sample_rate, s) for s in DEFAULT_WINDOWS_SECONDS
        )
        return BlockWindowedMeans(cfg.block_frames, lengths)

    @property
    def _kw_coeffs(self):
        sos = k_weighting_sos(self.config.sample_rate)
        return tuple(
            (float(s[0]), float(s[1]), float(s[2]), float(s[4]), float(s[5]))
            for s in sos
        )

    @property
    def _truepeak(self) -> TruePeakKernel:
        return TruePeakKernel(self.config.sample_rate)

    @property
    def _gate(self):
        from openmeters_tpu.ops.gating import GatedLoudness

        cfg = self.config
        return GatedLoudness(
            sample_rate=cfg.sample_rate,
            block_frames=cfg.block_frames,
            floor_db=cfg.floor_db,
        )

    def init(self, n_streams: int) -> dict:
        c = self.config.channels
        out = {
            "kw": jnp.zeros((4, n_streams, c), jnp.float32),
            "wm": self._windows.init((n_streams, c)),
            "tp": self._truepeak.init((n_streams, c)),
        }
        if self.config.gating:
            out["gate"] = self._gate.init(n_streams)
        return out

    def migrate_from(self, old: "LoudnessAnalyzer", carry: dict, n_streams: int):
        """Field-level carry retention: a floor change keeps the full 3 s
        window state (floor only gates dB conversion); a gating toggle keeps
        the filter/window/true-peak state and re-inits only the gate
        histograms.  Rate/block/channel changes re-init (``None``)."""
        import dataclasses as _dc

        a, b = old.config, self.config
        if a == b:
            return carry
        if (a.sample_rate, a.block_frames, a.channels) != (
            b.sample_rate, b.block_frames, b.channels
        ):
            return None
        if _dc.replace(a, floor_db=b.floor_db, gating=b.gating) != b:
            return None
        out = {k: carry[k] for k in ("kw", "wm", "tp")}
        if b.gating:
            out["gate"] = (
                carry["gate"] if a.gating else self._gate.init(n_streams)
            )
        return out

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, channel_weights, reset_mask=None):
        """One hop.

        Args:
          carry: from :meth:`init`.
          block: ``[S, B, C]`` raw channel samples.
          channel_weights: ``[S, C]`` BS.1770 weights (LFE 0, surround 1.41).
          reset_mask: optional ``[S]`` bool; restarts those streams.

        Returns ``(carry, LoudnessSnapshot)``.
        """
        cfg = self.config
        s, b, c = block.shape
        assert b == cfg.block_frames and c == cfg.channels
        floor = cfg.floor_db

        lane_reset = None
        if reset_mask is not None:
            lane_reset = jnp.broadcast_to(reset_mask[:, None], (s, c))

        x = jnp.transpose(block, (1, 0, 2)).astype(jnp.float32)  # [B, S, C]
        kw_state = carry["kw"]
        if lane_reset is not None:
            kw_state = jnp.where(lane_reset, 0.0, kw_state)
        # K-weighting as one lifted block map per hop: a [B, B]
        # lower-triangular affine map over the two cascaded sections
        # (measured faster on the GPU than the 256-step sequential scan at
        # 2048 and at 32768 lanes, PERF.md)
        filtered, kw_state = lifted_iir_scan(x, kw_state, self._kw_coeffs, lift=b)
        # per-block denormal flush of recursive state (processor.rs:281-285)
        kw_state = flush_denormal_state(kw_state)

        wm = self._windows
        wm_carry = wm.push_block(carry["wm"], filtered * filtered, lane_reset)
        means = wm.means(wm_carry)  # [4, S, C] mean squares

        tp_carry, peak = self._truepeak.process_block(carry["tp"], x, lane_reset)

        weighted = means[:2] * channel_weights[None]  # ST, M
        lufs_in = jnp.sum(weighted, axis=-1)  # [2, S]
        lufs = jnp.where(
            lufs_in > 0.0,
            jnp.maximum(
                LOUDNESS_OFFSET
                + 10.0 * jnp.log(jnp.maximum(lufs_in, 1e-45)) / jnp.log(10.0),
                floor,
            ),
            floor,
        )

        new_carry = {"kw": kw_state, "wm": wm_carry, "tp": tp_carry}
        if cfg.gating:
            # weighted K-squared samples summed over channels: [S, B]
            wk2 = jnp.einsum(
                "bsc,sc->sb", filtered * filtered,
                channel_weights.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST,
            )
            gate_carry = self._gate.push_block(carry["gate"], wk2, reset_mask)
            new_carry["gate"] = gate_carry
            integrated = gate_carry["integrated"]
            lra = gate_carry["lra"]
        else:
            integrated = jnp.full((s,), floor, jnp.float32)
            lra = jnp.zeros((s,), jnp.float32)

        snapshot = LoudnessSnapshot(
            short_term_lufs=lufs[0],
            momentary_lufs=lufs[1],
            rms_fast_db=power_to_db(means[2], floor),
            rms_slow_db=power_to_db(means[3], floor),
            true_peak_db=power_to_db(peak * peak, floor),
            integrated_lufs=integrated,
            lra_lu=lra,
        )
        return new_carry, snapshot
