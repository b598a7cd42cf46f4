"""The batched meter engine: one jitted step over all streams and analyzers.

Reference parity: ``VisualManager::ingest_samples`` (registry.rs:396-419)
builds one ``AudioBlock`` per ingest and fans out to enabled analyzer
modules; format-generation changes reset all processors (registry.rs:400-406).
Here the ``AudioBlock`` becomes a ``[n_streams, block_frames, channels]``
batch plus per-stream fold/weight matrices (the layout semantics of
``src/dsp.rs`` as data), and resets are a per-stream mask derived from
format-generation changes upstream.

The engine's cadence mirrors ``DspBatcher`` (meter.rs:15-80): fixed
``block_frames`` per step (256 @ 48 kHz scaled by rate), assembled host-side
by the ingest layer.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.analyzers.loudness import LoudnessAnalyzer, LoudnessConfig
from openmeters_tpu.analyzers.spectrogram import SpectrogramAnalyzer, SpectrogramConfig
from openmeters_tpu.analyzers.spectrum import SpectrumAnalyzer, SpectrumConfig
from openmeters_tpu.utils.channels import (
    MAX_AUDIO_CHANNELS,
    channel_fallback,
    channel_weights,
    stereo_matrix,
)

DSP_BATCH_FRAMES_AT_48K = 256  # reference meter.rs:16


def scaled_block_frames(sample_rate: float) -> int:
    """Rate-scaled DSP batch (reference meter.rs:20-25)."""
    return max(int(round(DSP_BATCH_FRAMES_AT_48K * sample_rate / 48_000.0)), 1)


def _default_analyzer(name: str):
    """Default config for a lazily-imported analyzer (default-factory so the
    import cost lands only when an EngineConfig is actually built)."""
    if name == "oscilloscope":
        from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig

        return OscilloscopeConfig()
    if name == "stereometer":
        from openmeters_tpu.analyzers.stereometer import StereometerConfig

        return StereometerConfig()
    from openmeters_tpu.analyzers.waveform import WaveformConfig

    return WaveformConfig()


class StreamMeta(NamedTuple):
    """Per-stream layout data (built host-side from ``AudioFormat``)."""

    fold: jnp.ndarray  # [S, C, 2] stereo fold matrices (dsp.rs:135-176)
    weights: jnp.ndarray  # [S, C] BS.1770 channel weights

    @staticmethod
    def default(
        n_streams: int, channels: int = 2, pad_channels: int = MAX_AUDIO_CHANNELS
    ) -> "StreamMeta":
        positions = channel_fallback(channels)
        return StreamMeta(
            fold=jnp.tile(
                jnp.asarray(stereo_matrix(channels, positions))[None, :pad_channels],
                (n_streams, 1, 1),
            ),
            weights=jnp.tile(
                jnp.asarray(channel_weights(positions))[None, :pad_channels],
                (n_streams, 1),
            ),
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    sample_rate: float = 48_000.0
    block_frames: int = DSP_BATCH_FRAMES_AT_48K
    channels: int = MAX_AUDIO_CHANNELS
    loudness: LoudnessConfig | None = LoudnessConfig()
    spectrogram: SpectrogramConfig | None = SpectrogramConfig()
    spectrum: SpectrumConfig | None = SpectrumConfig()
    # all six analyzers are on by default, matching the reference registry
    # (registry.rs:37-240 instantiates every visual); pass None to disable.
    # Field types stay loose so the engine module imports lazily.
    oscilloscope: Any = dataclasses.field(
        default_factory=lambda: _default_analyzer("oscilloscope")
    )
    stereometer: Any = dataclasses.field(
        default_factory=lambda: _default_analyzer("stereometer")
    )
    waveform: Any = dataclasses.field(
        default_factory=lambda: _default_analyzer("waveform")
    )

    @staticmethod
    def at_rate(sample_rate: float, **kw) -> "EngineConfig":
        """Config bucketed for a sample rate: the DSP batch scales like the
        reference's DspBatcher (256 frames @48k, meter.rs:20-25).  Streams of
        different rates run in separate engine instances (the reference keys
        its FFT plans by rate the same way)."""
        return EngineConfig(
            sample_rate=sample_rate,
            block_frames=scaled_block_frames(sample_rate),
            **kw,
        )

    def resolve(self) -> "EngineConfig":
        """Propagate engine-level rate/block into analyzer configs."""
        kw = dict(sample_rate=self.sample_rate, block_frames=self.block_frames)

        def fix(cfg):
            return dataclasses.replace(cfg, **kw) if cfg is not None else None

        return dataclasses.replace(
            self,
            loudness=(
                dataclasses.replace(
                    self.loudness, channels=self.channels, **kw
                )
                if self.loudness
                else None
            ),
            spectrogram=fix(self.spectrogram),
            spectrum=fix(self.spectrum),
            oscilloscope=fix(self.oscilloscope),
            stereometer=fix(self.stereometer),
            waveform=fix(self.waveform),
        )


@dataclasses.dataclass(frozen=True)
class MeterEngine:
    config: EngineConfig = EngineConfig()

    def __post_init__(self):
        object.__setattr__(self, "config", self.config.resolve())

    @property
    def spectrum_cadence(self) -> int:
        """Engine hops per spectrum hop (R).

        The reference's processors each consume at their own hop from the
        stream buffer (``DspBatcher`` per visual, meter.rs:15-80); the stock
        spectrum hop (1024) is 4 engine blocks.  When the spectrum hop is a
        whole multiple of the engine block, the spectrum runs at ITS cadence
        (:meth:`spectrum_step` every R engine hops) instead of per-hop
        ``lax.cond`` gating — idle engine hops then touch none of the
        spectrum state, so the ~270 MB of sliding-spectra + held-dB carry
        moves zero bytes on 3 of 4 hops (a ``cond`` identity branch copies
        its whole payload).
        """
        sp = self.config.spectrum
        if not sp:
            return 1
        b = self.config.block_frames
        if sp.hop_size > b and sp.hop_size % b == 0:
            return sp.hop_size // b
        return 1

    @property
    def analyzers(self) -> dict:
        cfg = self.config
        out = {}
        if cfg.loudness:
            out["loudness"] = LoudnessAnalyzer(cfg.loudness)
        if cfg.spectrogram:
            out["spectrogram"] = SpectrogramAnalyzer(cfg.spectrogram)
        if cfg.spectrum:
            sp = cfg.spectrum
            if self.spectrum_cadence > 1:
                # cadenced: the analyzer ingests one full spectrum hop per
                # call (block == hop), so every call slides exactly once —
                # no idle-hop cond, no held-output carry
                sp = dataclasses.replace(sp, block_frames=sp.hop_size)
            out["spectrum"] = SpectrumAnalyzer(sp)
        if cfg.oscilloscope:
            from openmeters_tpu.analyzers.oscilloscope import OscilloscopeAnalyzer

            oc = cfg.oscilloscope
            if getattr(oc, "snapshot_every", 0) != 0:
                # the engine runs the oscilloscope in EXTERNAL-capture mode:
                # the hop step maintains capture metadata only and consumers
                # read trace windows at their display cadence via
                # extract_oscilloscope (the reference UI samples captures at
                # the frame clock, frame_clock.rs:102-118) — no per-hop
                # extraction cond or held-snapshot carry
                oc = dataclasses.replace(oc, snapshot_every=0)
            out["oscilloscope"] = OscilloscopeAnalyzer(oc)
        if cfg.stereometer:
            from openmeters_tpu.analyzers.stereometer import StereometerAnalyzer

            out["stereometer"] = StereometerAnalyzer(cfg.stereometer)
        if cfg.waveform:
            from openmeters_tpu.analyzers.waveform import WaveformAnalyzer

            out["waveform"] = WaveformAnalyzer(cfg.waveform)
        return out

    def init(self, n_streams: int) -> dict:
        return {name: a.init(n_streams) for name, a in self.analyzers.items()}

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, meta: StreamMeta, reset_mask=None):
        """One engine hop.

        Args:
          carry: engine state from :meth:`init`.
          block: ``[S, B, C]`` interleaved-deinterleaved channel samples.
          meta: per-stream fold/weights.
          reset_mask: ``[S]`` bool — format-generation change resets
            (registry.rs:400-406 semantics).

        Returns ``(carry, {name: snapshot})``.
        """
        block = block.astype(jnp.float32)
        # every dot on metered audio runs in full f32 (HIGHEST): a platform
        # default may be TF32, which keeps ~10 mantissa bits
        stereo = jnp.einsum(
            "sbc,sct->sbt", block, meta.fold, precision=jax.lax.Precision.HIGHEST
        )  # [S, B, 2]
        mid = 0.5 * (stereo[..., 0] + stereo[..., 1])  # [S, B]

        new_carry, snaps = {}, {}
        analyzers = self.analyzers
        if "loudness" in analyzers:
            new_carry["loudness"], snaps["loudness"] = analyzers["loudness"].step(
                carry["loudness"], block, meta.weights, reset_mask
            )
        if "spectrogram" in analyzers:
            new_carry["spectrogram"], snaps["spectrogram"] = analyzers[
                "spectrogram"
            ].step(carry["spectrogram"], mid, reset_mask)
        if "spectrum" in analyzers:
            if self.spectrum_cadence > 1:
                # cadenced: stepped by spectrum_step every R hops; the carry
                # passes through untouched (donated serving loops alias it
                # in place — zero copies on idle hops)
                new_carry["spectrum"] = carry["spectrum"]
            else:
                new_carry["spectrum"], snaps["spectrum"] = analyzers[
                    "spectrum"
                ].step(carry["spectrum"], stereo, reset_mask=reset_mask)
        for name in ("oscilloscope", "stereometer", "waveform"):
            if name in analyzers:
                new_carry[name], snaps[name] = analyzers[name].step(
                    carry[name], stereo, reset_mask=reset_mask
                )
        return new_carry, snaps

    @functools.partial(jax.jit, static_argnums=0)
    def spectrum_step(self, spectrum_carry, blocks, meta: StreamMeta, reset_mask=None):
        """One SPECTRUM hop: ``R = spectrum_cadence`` engine blocks at once.

        Args:
          spectrum_carry: the ``carry["spectrum"]`` subtree.
          blocks: ``[R, S, B, C]`` — the R engine blocks of this spectrum
            hop, oldest first.
          reset_mask: ``[R, S]`` bool per-engine-hop reset masks, or ``[S]``
            bool (the OR).  With per-hop masks, blocks *before* a stream's
            last reset are zeroed device-side so no pre-reset (old
            generation) audio enters the spectrum buffer: the first
            post-reset window may contain up to R-1 leading zero blocks in
            place of samples the per-hop path would still mark stale — a
            sub-spectrum-hop timing shift, never stale audio.  With only the
            OR'd ``[S]`` mask the pre-reset blocks of this spectrum hop are
            admitted as-is (permissive by up to R-1 blocks) — callers that
            can keep per-hop masks should.

        Returns ``(spectrum_carry, SpectrumSnapshot)``.
        """
        analyzer = self.analyzers["spectrum"]
        r, s, b, _ = blocks.shape
        assert r == self.spectrum_cadence, (r, self.spectrum_cadence)
        blocks = blocks.astype(jnp.float32)
        if reset_mask is not None and reset_mask.ndim == 2:
            hop_i = jnp.arange(r, dtype=jnp.int32)[:, None]  # [R, 1]
            last = jnp.max(
                jnp.where(reset_mask, hop_i, jnp.int32(-1)), axis=0
            )  # [S]: last reset hop, -1 if none
            keep = hop_i >= last[None, :]  # the reset hop carries new audio
            blocks = jnp.where(keep[..., None, None], blocks, 0.0)
            reset_mask = jnp.any(reset_mask, axis=0)
        stereo = jnp.einsum(
            "rsbc,sct->srbt", blocks, meta.fold, precision=jax.lax.Precision.HIGHEST
        ).reshape(s, r * b, 2)
        return analyzer.step(spectrum_carry, stereo, reset_mask=reset_mask)

    def super_step(self, carry: dict, blocks, meta: StreamMeta, resets=None,
                   fold_snaps=None):
        """One full cadence super-period: R engine hops + the spectrum hop.

        Args:
          blocks: ``[R, S, B, C]`` engine blocks, oldest first.
          resets: ``[R, S]`` bool per-hop reset masks (or None).
          fold_snaps: optional per-hop reducer applied to each fast hop's
            snapshots *inside* the scan body.  Without it the fast snapshot
            leaves come back stacked ``[R, ...]`` — which materializes
            R copies of every bulk leaf (trace windows, spectrogram columns)
            through the scan output; throughput harnesses that only need to
            consume the snapshots should fold them to something small
            per hop instead.

        Returns ``(carry, snaps)`` where the fast analyzers' snapshots are
        stacked (or folded) per engine hop and ``snaps["spectrum"]`` is the
        single spectrum-hop snapshot.  With ``spectrum_cadence == 1`` this
        is just R scanned engine steps.
        """
        r = blocks.shape[0]

        def body(c, xr):
            blk, rst = xr
            c, snaps = self.step(c, blk, meta, rst)
            return c, fold_snaps(snaps) if fold_snaps is not None else snaps

        if resets is None:
            resets = jnp.zeros((r, blocks.shape[1]), bool)
        carry, fast_snaps = jax.lax.scan(body, carry, (blocks, resets))
        if self.spectrum_cadence > 1:
            assert r == self.spectrum_cadence, (r, self.spectrum_cadence)
            sp_carry, sp_snap = self.spectrum_step(
                carry["spectrum"], blocks, meta, resets
            )
            carry = dict(carry, spectrum=sp_carry)
            if fold_snaps is not None:
                return carry, (fast_snaps, sp_snap)
            fast_snaps["spectrum"] = sp_snap
        return carry, fast_snaps

    def extract_oscilloscope(self, carry: dict):
        """Display-rate oscilloscope capture extraction from the live carry
        (the engine's oscilloscope runs in external-capture mode)."""
        return self.analyzers["oscilloscope"].extract(carry["oscilloscope"])

    # -- reconfiguration -----------------------------------------------------

    def migrate_carry(self, old_engine: "MeterEngine", carry: dict, n_streams: int) -> dict:
        """Carry migration across a config change, at the reference's
        ``update_config`` granularity.

        Analyzers whose configs are unchanged keep their carries.  Changed
        analyzers are asked to migrate field-by-field via their
        ``migrate_from(old_analyzer, carry, n_streams)`` (e.g. the spectrum
        keeps its framing + sliding PCM state across an averaging/floor
        change, processor.rs:300-326; the oscilloscope keeps its trigger
        lock across cadence changes); analyzers without a ``migrate_from``,
        or whose migration returns ``None``, re-init.
        """
        old = old_engine.analyzers
        out = {}
        for name, analyzer in self.analyzers.items():
            migrated = None
            if name in old and name in carry:
                if old[name].config == analyzer.config:
                    migrated = carry[name]
                elif hasattr(analyzer, "migrate_from"):
                    migrated = analyzer.migrate_from(
                        old[name], carry[name], n_streams
                    )
            out[name] = (
                migrated if migrated is not None else analyzer.init(n_streams)
            )
        return out

    # -- sharding specs -----------------------------------------------------

    def carry_pspecs(self, axis: str):
        """PartitionSpec pytree matching :meth:`init` with the stream axis
        sharded; used by :func:`openmeters_tpu.engine.sharding.sharded_step`."""
        from jax.sharding import PartitionSpec as P

        def loudness_specs():
            analyzer = self.analyzers["loudness"]
            out = {
                "kw": P(None, axis, None),
                "wm": {
                    "totals": P(None, axis, None),
                    "suffix": P(None, None, axis, None),  # [slot, window, S, C]
                    "sums": P(None, axis, None),
                    "comp": P(None, axis, None),
                    "head": P(),
                    "blocks": P(axis, None),
                },
                "tp": P(None, axis, None),
            }
            if analyzer.config.gating:
                out["gate"] = analyzer._gate.pspecs(axis)  # noqa: SLF001
            return out

        def fb_specs():
            return {
                "buf": P(axis, None),
                "origin": P(),
                "avail": P(),
                "fresh": P(axis),
            }

        def sdft_specs():
            return {
                "re": P(axis, None),
                "im": P(axis, None),
                "count": P(),
                "anchored": P(),
            }

        out = {}
        if "loudness" in self.analyzers:
            out["loudness"] = loudness_specs()
        if "spectrogram" in self.analyzers:
            sg = self.analyzers["spectrogram"]
            out["spectrogram"] = {"fb": fb_specs()}
            if sg.use_sliding:
                out["spectrogram"]["sdft"] = sdft_specs()
            if sg.use_sliding_reassigned:
                out["spectrogram"]["srs"] = sg._sliding_reassigned.pspecs(axis)  # noqa: SLF001
        if "spectrum" in self.analyzers:
            sa = self.analyzers["spectrum"]
            out["spectrum"] = {"fb": fb_specs(), "smoothed": P(axis, None, None)}
            if sa.use_sliding:
                out["spectrum"]["sdft"] = sdft_specs()
                if sa.config.hop_size > sa.config.block_frames:
                    out["spectrum"]["raw_db"] = P(axis, None, None)
                    out["spectrum"]["weighted_db"] = P(axis, None, None)
        for name in ("oscilloscope", "stereometer", "waveform"):
            if name in self.analyzers:
                out[name] = self.analyzers[name].pspecs(axis)
        return out
