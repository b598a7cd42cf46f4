"""Oscilloscope: NSDF pitch detection + waveform-stable trigger.

Reference parity: ``src/visuals/oscilloscope/processor.rs`` (the reference's
largest processor):

- ``PeriodEstimator``: McLeod-style NSDF via FFT autocorrelation with
  prefix-energy normalization; peak picking takes the *earliest* candidate
  within 0.93x of the global best, parabolic refinement; range 20 Hz..8 kHz,
  0.1 s probe, confidence = clamped NSDF peak (processor.rs:85-181).
- ``StableTrigger``: a retunable waveform reference template (resampled on
  >1 semitone pitch change), candidate = Gaussian-edged slope template +
  reference, normalized-correlation search over ~1.5 periods, template reset
  when match < 0.3, EMA smoothing of period (0.35) and reference (0.5), lock
  lost after 4 missed periods (processor.rs:184-528).
- Zero-crossing mode: rising-edge search at both ends (processor.rs:530-551,
  769-786).
- Snapshot: traces linearly resampled with fractional start offset
  (processor.rs:725-803).

Batched formulation: everything is sized to the *static* worst case (period <=
rate/20 Hz) with dynamic lengths expressed as masks; the reference's
coarse-to-fine CPU correlation search (processor.rs:441-475) becomes one
dense FFT cross-correlation — an exact superset of the strided search.  All
data-dependent control flow (lock/unlock, template reset) is masked
``jnp.where`` state in the carry.  The reference's template retune-resample
(processor.rs:249-263) is replaced by a CENTER-ALIGNED template store —
length changes become mask changes and big pitch jumps drop the template
(see the centered-store comment in ``_locate``).  Batched over
``[n_streams]``.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openmeters_tpu.utils.channels import Channel, projection_vector

TRACE_COUNT = 2
OUTPUT_POINTS = 4096  # reference snapshot budget (processor.rs:726)

# PeriodEstimator constants (processor.rs:86-92)
MIN_HZ = 20.0
MAX_HZ = 8000.0
PROBE_SECONDS = 0.1
MIN_SIGNAL_PEAK = 0.001
MIN_PERIODICITY = 0.5
PEAK_CUTOFF = 0.93

# Sliding probe-spectrum exact re-anchor cadence (hops).  f32 slide drift over 32 hops stays ~1e-5 relative — far below the NSDF
# decision thresholds (clarity/periodicity cuts at 0.5-0.93) — and the
# amortized 8192-pt exact rfft cost drops 4x vs the original cadence of 8.
PROBE_REFRESH = 32

# StableTrigger constants (processor.rs:285-297)
WINDOW_SECONDS = 0.04
MIN_CYCLES = 2.0
SEARCH_PERIODS = 1.5
NORMALIZE_FLOOR = 0.01
MEAN_RESPONSIVENESS = 0.25
EDGE_STRENGTH = 1.0
BUFFER_RESPONSIVENESS = 0.5
BUFFER_FALLOFF_PERIODS = 0.5
BUFFER_RETUNE_SEMITONES = 1.0
SLOPE_WIDTH_PERIODS = 0.25
RESET_BELOW_MATCH = 0.3
MAX_MISSED_PERIODS = 4


class TriggerMode(enum.Enum):
    ZERO_CROSSING = "zero_crossing"
    STABLE = "stable"


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


@dataclasses.dataclass(frozen=True)
class OscilloscopeConfig:
    sample_rate: float = 48_000.0
    segment_duration: float = 0.02
    trigger_mode: TriggerMode = TriggerMode.STABLE
    num_cycles: int = 2
    trigger_source: Channel = Channel.MID
    channel_1: Channel = Channel.MID
    channel_2: Channel = Channel.NONE
    block_frames: int = 256
    # Trigger cadence in hops: 1 = every ingest hop — the reference's
    # per-processed-block evaluation (processor.rs:93-181); 3 ~= display
    # rate, a coarser compromise.
    trigger_every: int = 1
    # Capture-window EXTRACTION cadence in hops.  The reference evaluates
    # its trigger per block but the UI samples the capture at the frame
    # clock (~60 Hz, ui/widgets/frame_clock.rs:102-118) — 187.5 hops/s at
    # 48k/256 makes 3 hops ≈ 62 fps.  Trigger state (lock, period, capture
    # position) still updates every trigger_every hops; only the [S, 2,
    # window_cap] trace window read is display-rate.  Set to 1 to extract
    # every trigger evaluation.
    snapshot_every: int = 3


class OscilloscopeSnapshot(NamedTuple):
    """Per-trace capture metadata: with a linked trigger (matching trace or
    separate source) every trace shares one capture; with no trigger source
    each active trace carries its own (processor.rs:684-700)."""

    samples: jnp.ndarray  # [S, 2, window_cap] raw capture windows
    trace_valid: jnp.ndarray  # [S, 2]
    span: jnp.ndarray  # [S, 2] capture span in samples
    start: jnp.ndarray  # [S, 2] capture start index within the history window
    frac: jnp.ndarray  # [S, 2] fractional start offset
    period: jnp.ndarray  # [S, 2] locked period (samples), 0 when unlocked
    locked: jnp.ndarray  # [S, 2] bool — stable trigger lock


@dataclasses.dataclass(frozen=True)
class OscilloscopeAnalyzer:
    config: OscilloscopeConfig = OscilloscopeConfig()

    # -- static sizing ------------------------------------------------------

    @property
    def base_frames(self) -> int:
        cfg = self.config
        return max(int(round(cfg.sample_rate * cfg.segment_duration)), 1)

    @property
    def max_period(self) -> int:
        return int(math.ceil(self.config.sample_rate / MIN_HZ))

    @property
    def min_period(self) -> int:
        return max(int(round(self.config.sample_rate / MAX_HZ)), 2)

    @property
    def probe_frames(self) -> int:
        return max(
            int(round(self.config.sample_rate * PROBE_SECONDS)), self.max_period * 2
        )

    @property
    def kernel_cap(self) -> int:
        """trigger_kernel_len at max period (processor.rs:184-189)."""
        return max(
            int(round(max(self.config.sample_rate * WINDOW_SECONDS,
                          self.max_period * MIN_CYCLES))),
            2,
        )

    @property
    def search_cap(self) -> int:
        # the runtime search length is clipped to klen // 2 <= kernel_cap // 2
        # (processor.rs caps the search at half the trigger kernel), so the
        # static capacity never needs to exceed that.
        return max(
            min(int(math.ceil(self.max_period * SEARCH_PERIODS)), self.kernel_cap // 2),
            1,
        )

    @property
    def work_cap(self) -> int:
        return self.search_cap + self.kernel_cap

    @property
    def _kernel_min(self) -> int:
        """Smallest runtime trigger-kernel length (klen >= rate * WINDOW_SECONDS)."""
        return min(
            self.kernel_cap,
            max(int(round(self.config.sample_rate * WINDOW_SECONDS)), 2),
        )

    @property
    def history_frames(self) -> int:
        cfg = self.config
        if cfg.trigger_mode is TriggerMode.ZERO_CROSSING:
            trigger = self.base_frames + self.max_period
        else:
            # stable_history_frames (processor.rs:761-767)
            max_tail = max(
                self.max_period * max(cfg.num_cycles, 1) + 1,
                -(-self.kernel_cap // 2),
            )
            trigger = self.kernel_cap // 2 + max_tail + self.search_cap + 2
        return max(self.probe_frames, self.base_frames, trigger)

    @property
    def window_cap(self) -> int:
        """Static capture-window capacity: max span over the trigger mode."""
        if self.config.trigger_mode is TriggerMode.ZERO_CROSSING:
            cap = self.base_frames + 2
        else:
            cap = max(
                int(math.ceil(self.max_period * max(self.config.num_cycles, 1))) + 2,
                self.base_frames + 2,
            )
        return min(cap, self.history_frames)

    @property
    def nsdf_fft(self) -> int:
        return _next_pow2(self.probe_frames + self.max_period)

    @property
    def slides_probe(self) -> bool:
        """Per-hop triggering keeps the NSDF probe spectrum as sliding
        carry state (one ``[2B, bins]`` delta matmul + rotation per hop,
        exact re-anchor every ``PROBE_REFRESH`` hops and on any reset)
        instead of a fresh ``rfft(probe)`` per hop.  Only pays when the
        trigger actually runs every hop; the mean subtraction moves to the
        frequency domain (``C = X - mean·D`` with D the window support's
        Dirichlet vector — exact, not an approximation)."""
        if _osc_no_slide():
            return False
        cfg = self.config
        return (
            max(int(cfg.trigger_every), 1) == 1
            and cfg.trigger_mode is TriggerMode.STABLE
            and self.history_frames >= self.probe_frames + cfg.block_frames
        )

    @property
    def snap_cadence(self) -> int:
        """Hops between capture-window extractions (frame-clock analogue)."""
        return max(int(self.config.snapshot_every), 1)

    @property
    def external_capture(self) -> bool:
        """``snapshot_every == 0``: the hop step maintains capture METADATA
        only (position/span/validity, aged per hop exactly like the
        reference's Capture) and the trace-window READ happens in
        :meth:`extract`, called by the consumer at its display cadence
        (frame_clock.rs:102-118).  Removes the per-hop extraction cond and
        the held-snapshot carry from the hop step entirely — the serving
        engine runs this mode."""
        return int(self.config.snapshot_every) == 0

    @property
    def holds_snap(self) -> bool:
        """Whether the carry holds the last extracted snapshot (any cadence
        coarser than the hop — trigger or extraction)."""
        return not self.external_capture and (
            max(int(self.config.trigger_every), 1) > 1 or self.snap_cadence > 1
        )

    @property
    def corr_fft(self) -> int:
        # Circular FFT cross-correlation is exact (no wraparound) at offset j
        # when j + k < nfft for every template tap k < klen: valid offsets
        # reach j = base + search <= work_cap - klen, so nfft >= work_cap
        # suffices for the *valid* scores.  The dense score slice additionally
        # reads (masked, discarded) lags up to base_max + search_cap where
        # base_max = work_cap - 1 - klen_min; covering those keeps the
        # dynamic slice from clip-shifting.  This halves the transform vs the
        # naive linear-correlation bound work_cap + kernel_cap.
        max_read = self.work_cap - self._kernel_min + self.search_cap
        return _next_pow2(max(self.work_cap, max_read))

    # -- trace wiring (static) ----------------------------------------------

    @property
    def trace_channels(self):
        return (self.config.channel_1, self.config.channel_2)

    @property
    def active_traces(self):
        return tuple(ch is not Channel.NONE for ch in self.trace_channels)

    @property
    def trigger_slot(self) -> int:
        """Index in the history ring driving the trigger: a matching trace,
        or slot 2 (separate source projection)."""
        src = self.config.trigger_source
        for i, ch in enumerate(self.trace_channels):
            if ch is src and self.active_traces[i]:
                return i
        return 2

    @property
    def needs_source_ring(self) -> bool:
        return (
            self.trigger_slot == 2 and self.config.trigger_source is not Channel.NONE
        )

    @property
    def independent_triggers(self) -> bool:
        """reference processor.rs:684-700: with no trigger source each active
        trace runs its *own* trigger state; a matching trace or separate
        source yields one linked capture shared by all traces."""
        return self.config.trigger_source is Channel.NONE and any(self.active_traces)

    @property
    def trigger_lane_slots(self) -> tuple[int, ...]:
        """History-ring slots feeding the trigger lanes (1 linked lane, or
        one lane per active trace when independent)."""
        if self.independent_triggers:
            return tuple(t for t in range(TRACE_COUNT) if self.active_traces[t])
        return (self.trigger_slot if self.trigger_slot < 2 else 2,)

    @property
    def n_trig(self) -> int:
        return len(self.trigger_lane_slots)

    # -- state ----------------------------------------------------------------

    @property
    def ring_cap(self) -> int:
        """Rotating-ring capacity: history rounded up to whole blocks so
        the write origin never wraps mid-block; stored mirrored (2x)."""
        b = max(int(self.config.block_frames), 1)
        return -(-self.history_frames // b) * b

    def init(self, n_streams: int) -> dict:
        s = n_streams
        k = self.kernel_cap
        lanes = s * self.n_trig  # stream-major flattening: lane = s*n + i
        carry = {
            # one ring per projection lane (ch1, ch2, trigger): separate
            # arrays keep the single-lane trigger path a zero-copy view
            # (slicing a [S, 3, L] middle axis materialized an ~80 MB copy
            # per step at S=1024)
            "hist": tuple(
                jnp.zeros((s, 2 * self.ring_cap), jnp.float32) for _ in range(3)
            ),
            "origin": jnp.zeros((), jnp.int32),
            "fresh": jnp.zeros((s,), jnp.int32),
            "tick": jnp.zeros((), jnp.int32),
            # stable-trigger state: 1 linked lane, or 1 per active trace
            "period": jnp.zeros((lanes,), jnp.float32),
            "has_period": jnp.zeros((lanes,), bool),
            "missed": jnp.zeros((lanes,), jnp.int32),
            "mean": jnp.zeros((lanes,), jnp.float32),
            "reference": jnp.zeros((lanes, k), jnp.float32),
            "ref_period": jnp.zeros((lanes,), jnp.float32),
        }
        if self.slides_probe:
            bins = self.nsdf_fft // 2 + 1
            carry["pspec_re"] = jnp.zeros((lanes, bins), jnp.float32)
            carry["pspec_im"] = jnp.zeros((lanes, bins), jnp.float32)
            carry["panchored"] = jnp.zeros((), bool)
        if self.external_capture:
            carry["cap"] = {
                "valid": jnp.zeros((s, self.n_trig), bool),
                "span": jnp.zeros((s, self.n_trig), jnp.float32),
                "start": jnp.zeros((s, self.n_trig), jnp.int32),
                "frac": jnp.zeros((s, self.n_trig), jnp.float32),
            }
        if self.holds_snap:
            carry["snap"] = {
                "samples": jnp.zeros((s, TRACE_COUNT, self.window_cap), jnp.float32),
                "trace_valid": jnp.zeros((s, TRACE_COUNT), bool),
                "span": jnp.zeros((s, TRACE_COUNT), jnp.float32),
                "start": jnp.zeros((s, TRACE_COUNT), jnp.int32),
                "frac": jnp.zeros((s, TRACE_COUNT), jnp.float32),
            }
        return carry

    def migrate_from(self, old: "OscilloscopeAnalyzer", carry: dict, n_streams: int):
        """The reference rebuilds the whole processor on ANY config change
        (processor.rs:752-758); we retain state across *cadence-only*
        changes (trigger_every / snapshot_every) since the history ring,
        trigger lock and reference template stay dimensionally and
        semantically identical — a display-rate tweak should not drop a
        locked trigger.  Anything else re-inits (``None``)."""
        import dataclasses as _dc

        a, b = old.config, self.config
        if a == b:
            return carry
        if _dc.replace(
            a, trigger_every=b.trigger_every, snapshot_every=b.snapshot_every
        ) != b:
            return None
        from openmeters_tpu.utils.migrate import merge_carry

        return merge_carry(self.init(n_streams), carry)

    def pspecs(self, axis: str):
        from jax.sharding import PartitionSpec as P

        specs = {
            "hist": (P(axis, None),) * 3,
            "origin": P(),
            "fresh": P(axis),
            "tick": P(),
            "period": P(axis),
            "has_period": P(axis),
            "missed": P(axis),
            "mean": P(axis),
            "reference": P(axis, None),
            "ref_period": P(axis),
        }
        if self.slides_probe:
            specs["pspec_re"] = P(axis, None)
            specs["pspec_im"] = P(axis, None)
            specs["panchored"] = P()
        if self.external_capture:
            specs["cap"] = {
                "valid": P(axis, None),
                "span": P(axis, None),
                "start": P(axis, None),
                "frac": P(axis, None),
            }
        if self.holds_snap:
            specs["snap"] = {
                "samples": P(axis, None, None),
                "trace_valid": P(axis, None),
                "span": P(axis, None),
                "start": P(axis, None),
                "frac": P(axis, None),
            }
        return specs

    # -- external capture (display-rate extraction) ---------------------------

    def _per_trace_meta(self, cap2: dict, s: int) -> dict:
        """Map per-lane capture metadata [S, n_trig] to per-trace [S, 2]
        snapshot fields (linked trigger shares one capture,
        processor.rs:684-700)."""
        lane_slots = self.trigger_lane_slots

        def trace_cap(key, t):
            if self.independent_triggers:
                return cap2[key][:, lane_slots.index(t)]
            return cap2[key][:, 0]

        zeros = {
            "valid": jnp.zeros((s,), bool),
            "span": jnp.zeros((s,), jnp.float32),
            "start": jnp.zeros((s,), jnp.int32),
            "frac": jnp.zeros((s,), jnp.float32),
        }
        out = {}
        for field, key in (
            ("trace_valid", "valid"), ("span", "span"),
            ("start", "start"), ("frac", "frac"),
        ):
            out[field] = jnp.stack(
                [
                    trace_cap(key, t) if self.active_traces[t] else zeros[key]
                    for t in range(TRACE_COUNT)
                ],
                axis=1,
            )
        return out

    def _lock_fields(self, state: dict, s: int):
        """Per-trace (locked, period) from the trigger lane state."""
        if self.config.trigger_mode is not TriggerMode.STABLE:
            return (
                jnp.zeros((s, TRACE_COUNT), bool),
                jnp.zeros((s, TRACE_COUNT), jnp.float32),
            )
        n_trig = self.n_trig
        lane_slots = self.trigger_lane_slots
        lock2 = state["has_period"].reshape(s, n_trig)
        per2 = state["period"].reshape(s, n_trig)
        locked_t, period_t = [], []
        for t in range(TRACE_COUNT):
            if not self.active_traces[t]:
                locked_t.append(jnp.zeros((s,), bool))
                period_t.append(jnp.zeros((s,), jnp.float32))
            else:
                i = lane_slots.index(t) if self.independent_triggers else 0
                locked_t.append(lock2[:, i])
                period_t.append(per2[:, i])
        return jnp.stack(locked_t, axis=1), jnp.stack(period_t, axis=1)

    @functools.partial(jax.jit, static_argnums=0)
    def extract(self, carry: dict) -> OscilloscopeSnapshot:
        """Display-rate capture extraction (external_capture mode): read the
        [S, 2, window_cap] trace windows anchored by the carry's capture
        metadata — one batched row-window read per active trace.  Call at
        the consumer's frame cadence (the reference UI samples captures at
        ~60 Hz, frame_clock.rs:102-118); the hop step never touches bulk
        trace data in this mode."""
        assert self.external_capture
        cap2 = carry["cap"]
        s = carry["fresh"].shape[0]
        # logical index 0 of the right-aligned history window lives at
        # physical shift in the mirrored ring (carry["origin"] is the NEXT
        # write slot, i.e. one past the newest sample)
        shift = (carry["origin"] - self.history_frames) % self.ring_cap
        lane_slots = self.trigger_lane_slots

        def trace_cap(key, t):
            if self.independent_triggers:
                return cap2[key][:, lane_slots.index(t)]
            return cap2[key][:, 0]

        samples = []
        for t in range(TRACE_COUNT):
            if not self.active_traces[t]:
                samples.append(jnp.zeros((s, self.window_cap), jnp.float32))
            else:
                samples.append(
                    window_rows(
                        carry["hist"][t], trace_cap("start", t) + shift,
                        self.window_cap,
                    )
                )
        meta = self._per_trace_meta(cap2, s)
        locked, period = self._lock_fields(carry, s)
        return OscilloscopeSnapshot(
            samples=jnp.stack(samples, axis=1),
            trace_valid=meta["trace_valid"],
            span=meta["span"],
            start=meta["start"],
            frac=meta["frac"],
            period=jnp.where(locked, period, 0.0),
            locked=locked,
        )

    # -- NSDF period estimation (processor.rs:93-181) -------------------------

    def _estimate_period(self, probe, pspec=None):
        """``probe``: [S, P] most-recent samples.  Returns dict of [S] arrays:
        period, confidence, detected, last_peak.  ``pspec``: optional sliding
        spectrum of the raw probe window (see :attr:`slides_probe`) —
        replaces the per-hop ``rfft``; the DC removal happens in frequency
        domain (``C = X - mean·D``, exact for the zero-padded window)."""
        p = probe.shape[-1]
        mean = jnp.mean(probe, axis=-1, keepdims=True)
        c = probe - mean

        max_lag = min(self.max_period, p // 2)
        nfft = self.nsdf_fft

        e = jnp.cumsum(c * c, axis=-1)
        e = jnp.concatenate([jnp.zeros_like(e[..., :1]), e], axis=-1)  # [S, P+1]
        total = e[..., -1]
        # e[p - tau] = reversed slice, e[tau] = prefix
        left = jnp.flip(e[..., p - max_lag : p + 1], axis=-1)  # e[p - tau]
        right = total[..., None] - e[..., : max_lag + 1]

        last_peak = jnp.max(jnp.abs(c), axis=-1)
        from openmeters_tpu.ops.fft import irfft_mxu, rfft_mxu

        # full f32 (HIGHEST): a TF32 transform leaves ~2^-11 relative error
        # on the spectral products, which the inverse's cancellation
        # amplifies into the NSDF peak the lock decisions threshold
        if pspec is not None:
            _, _, _, _, d_re, d_im = _probe_slide_consts(
                p, self.config.block_frames, nfft
            )
            c_re = pspec[0] - mean * d_re
            c_im = pspec[1] - mean * d_im
            power = c_re * c_re + c_im * c_im
        else:
            spec = rfft_mxu(c, nfft)
            power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
        ac = irfft_mxu(power, jnp.zeros_like(power), nfft, out_len=max_lag + 1)

        taus = np.arange(max_lag + 1)
        denom = left + right
        nsdf = jnp.where(denom > 1e-7, 2.0 * ac / jnp.maximum(denom, 1e-30), 0.0)

        # first zero crossing tau >= 1
        nonpos = nsdf[:, 1:] <= 0.0
        has_zc = jnp.any(nonpos, axis=-1)
        zc = jnp.argmax(nonpos, axis=-1) + 1
        first_tau = jnp.maximum(self.min_period, zc)

        tau_idx = np.arange(max_lag + 1)
        prev = jnp.concatenate([nsdf[:, :1], nsdf[:, :-1]], axis=-1)
        nxt = jnp.concatenate([nsdf[:, 1:], nsdf[:, -1:]], axis=-1)
        in_range = (tau_idx[None, :] >= first_tau[:, None]) & (
            tau_idx[None, :] < max_lag
        )
        cand = (
            in_range
            & (nsdf >= MIN_PERIODICITY)
            & (nsdf >= prev)
            & (nsdf >= nxt)
        )
        any_cand = jnp.any(cand, axis=-1)
        best_val = jnp.max(jnp.where(cand, nsdf, -jnp.inf), axis=-1)
        best_idx = jnp.argmax(jnp.where(cand, nsdf, -jnp.inf), axis=-1)
        cutoff = best_val * PEAK_CUTOFF
        early = cand & (nsdf >= cutoff[:, None]) & (tau_idx[None, :] <= best_idx[:, None])
        peak = jnp.argmax(early, axis=-1)  # first True
        peak = jnp.where(jnp.any(early, axis=-1), peak, best_idx)

        # neighbor reads as fused one-hot reductions (these three fuse into
        # one pass).  Edge clamping is
        # unnecessary: whenever `detected` holds, first_tau <= peak < max_lag
        # keeps peak±1 in range, and undetected lanes discard the values.
        y0, y1, y2 = _onehot_neighbors(nsdf, peak)
        period = _parabolic_refine(y0, y1, y2, peak)
        confidence = jnp.clip(y1, 0.0, 1.0)

        detected = (
            (last_peak >= MIN_SIGNAL_PEAK)
            & (max_lag > self.min_period + 1)
            & has_zc
            & (first_tau < max_lag)
            & any_cand
            & (total > 1e-7)
        )
        return {
            "period": period,
            "confidence": confidence,
            "detected": detected,
            "last_peak": last_peak,
        }

    # -- stable trigger (processor.rs:273-528) --------------------------------

    def _stable_capture(self, state, trace, fresh_ok, shift=None, pspec=None):
        """Batched StableTrigger::capture.  ``trace``: [S, HIST] right-aligned,
        or [S, 2*ring] rotated with scalar ``shift`` mapping logical index 0
        to physical ``shift`` (double-write ring: any logical window is
        contiguous).  Returns (new_state, capture dict with logical
        span/start/frac [S]).
        """
        cfg = self.config
        s = trace.shape[0]
        hist = self.history_frames
        rate = cfg.sample_rate
        cycles = max(cfg.num_cycles, 1)
        kcap, scap, wcap = self.kernel_cap, self.search_cap, self.work_cap
        assert trace.shape[1] == 2 * self.ring_cap, (
            "stable capture requires the mirrored double-write ring"
        )
        if shift is None:
            shift = jnp.int32(0)

        probe = jax.lax.dynamic_slice(
            trace, (jnp.int32(0), shift + hist - self.probe_frames),
            (s, self.probe_frames),
        )
        est = self._estimate_period(probe, pspec=pspec)

        # silence unlocks (processor.rs:322-325)
        silent = est["last_peak"] < MIN_SIGNAL_PEAK
        has_period = jnp.where(silent, False, state["has_period"])
        missed = jnp.where(silent, 0, state["missed"])
        mean_state = jnp.where(silent, 0.0, state["mean"])
        reference = jnp.where(silent[:, None], 0.0, state["reference"])
        ref_period = jnp.where(silent, 0.0, state["ref_period"])
        prev_period = jnp.where(silent, 0.0, state["period"])

        # stabilize (processor.rs:336-356)
        detected = est["detected"] & fresh_ok
        est_p = est["period"]
        ratio_ok = has_period & (est_p / jnp.maximum(prev_period, 1e-6) >= 0.9) & (
            est_p / jnp.maximum(prev_period, 1e-6) <= 1.1
        )
        smoothed = jnp.where(ratio_ok, prev_period + 0.35 * (est_p - prev_period), est_p)
        # on miss: hold previous period (confidence 0) until MAX_MISSED
        missed_next = jnp.where(detected, 0, missed + 1)
        hold = ~detected & has_period & (missed_next <= MAX_MISSED_PERIODS)
        unlock = ~detected & (~has_period | (missed_next > MAX_MISSED_PERIODS))
        period = jnp.where(detected, smoothed, jnp.where(hold, prev_period, 0.0))
        confidence = jnp.where(detected, est["confidence"], 0.0)
        has_period = detected | hold
        missed = jnp.where(detected, 0, jnp.where(hold, missed_next, 0))
        # full unlock clears the template too (processor.rs:298-304)
        reference = jnp.where(unlock[:, None], 0.0, reference)
        ref_period = jnp.where(unlock, 0.0, ref_period)
        mean_state = jnp.where(unlock, 0.0, mean_state)

        locked = has_period

        # locate (processor.rs:358-411) — all dynamic lengths masked
        p = jnp.maximum(period, 1.0)
        span = p * cycles
        frames = jnp.ceil(span).astype(jnp.int32) + 1
        klen = jnp.clip(
            jnp.round(jnp.maximum(rate * WINDOW_SECONDS, p * MIN_CYCLES)), 2, kcap
        ).astype(jnp.int32)
        before = klen // 2
        after = klen - before
        right = hist - jnp.maximum(frames, after)
        can_locate = locked & (right >= before)
        search = jnp.clip(
            jnp.round(p * SEARCH_PERIODS).astype(jnp.int32), 1, klen // 2
        )
        search = jnp.minimum(search, jnp.maximum(right - before, 1))
        left = right - search

        # work = trace[left-before : left-before+wcap], START-aligned: the
        # searched region begins at work index 0, so one of the two
        # sliding-sum prefix reads becomes a STATIC slice and the score
        # anchor reduces to the centered-store offset.  Samples beyond
        # search+klen are garbage (mirror/stale ring data) that every
        # consumer masks away; the double-write mirror guarantees any
        # start in [0, cap) reads a contiguous window.
        ring_cap = trace.shape[1] // 2
        w_start = (shift + jnp.maximum(left - before, 0)) % ring_cap

        # The search consumes the RAW window: normalized correlation is
        # exactly shift-invariant (dot - sx*st/n centers both operands), and
        # the candidate centering telescopes — (seg - m) - (cmean - m) ==
        # seg - cmean for any per-stream constant m — so the reference's
        # running-mean subtraction of the work region (processor.rs:381-399)
        # cannot change a single output; only the mean_state EMA itself is
        # kept (fed from the region mean computed below).

        # Centered template store — the batched replacement for the
        # reference's retune resample (processor.rs:249-263,486-498).  The
        # reference lerp-resamples its template whenever its length changes
        # or pitch moves >1 semitone, a per-row arbitrary gather.  Instead
        # the template lives CENTER-ALIGNED in the [S, kcap]
        # buffer: a klen change is then a pure mask change (the centers the
        # reference's resample preserves already coincide), the per-stream
        # store offset folds into the correlation's phase-shift base, and a
        # >1-semitone jump drops the template outright — the match<0.3
        # reset machinery (processor.rs:509-527) rebuilds it from the next
        # candidate at BUFFER_RESPONSIVENESS=0.5 within ~2 hops, which is
        # also where the reference's resampled template converges.
        ref_empty = ~jnp.any(jnp.abs(reference) > 1.0e-3, axis=-1)
        semis = jnp.abs(jnp.log2(jnp.maximum(p, 1e-6) / jnp.maximum(ref_period, 1e-6))) * 12.0
        jump = can_locate & ~ref_empty & (semis >= BUFFER_RETUNE_SEMITONES)
        reference = jnp.where(jump[:, None], 0.0, reference)
        ref_period = jnp.where(
            can_locate & (ref_empty | jump), p, ref_period
        )

        # the template was only zeroed via `jump` since the ref_empty scan:
        # derive liveness instead of re-scanning the [lanes, kcap] store
        # (the second any(|ref|>1e-3) reduction measured ~0.09 ms/hop at
        # S=1024)
        use_reference = ~ref_empty & ~jump

        kidx = np.arange(kcap)
        off = (kcap - klen) // 2  # [S] centered-store offset
        kmask = (kidx[None, :] >= off[:, None]) & (
            kidx[None, :] < (off + klen)[:, None]
        )

        # Forward transform: one batched call covers the work window and the
        # blended template; sliding dots land on a static slice via the
        # phase-shift theorem.  Precision stays HIGHEST: reduced-precision
        # dots leave relative error on the spectral products that the
        # inverse DFT's cancellation amplifies into the correlation peak —
        # enough to jitter the argmax and swamp the parabolic refinement
        # for low-f0 streams.
        nfft = self.corr_fft
        edges = jnp.where(kmask, _edge_template(klen, p, kcap, off), 0.0)
        template = jnp.where(
            use_reference[:, None] & kmask, edges + reference, edges
        )
        work = window_rows(trace, w_start, wcap)
        dots_m = correlation_dots(work, template, -off, nfft, scap + 1)
        sx, sxx, wmean = window_sums(work, klen, search + klen, scap + 1)

        mean_state = jnp.where(
            can_locate,
            mean_state + MEAN_RESPONSIVENESS * (wmean - mean_state),
            mean_state,
        )

        n1 = jnp.maximum(klen.astype(jnp.float32), 1.0)[:, None]
        ex = jnp.maximum(sxx - sx * sx / n1, 0.0)

        def scores_of(dots, tmpl):
            st = jnp.sum(tmpl, axis=-1, keepdims=True)
            stt = jnp.sum(tmpl * tmpl, axis=-1, keepdims=True)
            dot = dots - sx * st / n1
            ey = jnp.maximum(stt - st * st / n1, 0.0)
            denom = jnp.sqrt(ex * ey)
            return jnp.where(
                denom > 1e-7, jnp.clip(dot / jnp.maximum(denom, 1e-30), -1, 1), 0.0
            )

        def cmean_at(offset):
            oh = (
                jnp.arange(scap + 1, dtype=jnp.int32)[None, :] == offset[:, None]
            ).astype(jnp.float32)
            return jnp.sum(sx * oh, axis=-1) / jnp.maximum(
                klen.astype(jnp.float32), 1.0
            )

        def pick(scores):
            oidx = np.arange(scap + 1)
            ovalid = oidx[None, :] <= search[:, None]
            best = jnp.argmax(jnp.where(ovalid, scores, -jnp.inf), axis=-1)
            b0, b1, b2 = _onehot_neighbors(scores, best)
            interior = (best > 0) & (best < search)
            frac = jnp.where(
                interior,
                jnp.clip(_parabolic_refine(b0, b1, b2, best) - best, -0.5, 0.5),
                0.0,
            )
            return best.astype(jnp.int32), frac

        best, frac = pick(scores_of(dots_m, template))
        cmean_b = cmean_at(best)

        # candidate write + reference reset check (processor.rs:381-399,509-527)
        # The centered capacity read [offset - off, offset - off + kcap)
        # may start BEFORE the work window (off can exceed offset; klen >=
        # 1920 bounds off <= 1440) — in ring coordinates the mirrored
        # double-write makes any modulo start contiguous, so the read comes
        # straight off the ring (the same ring span as the work window)
        def candidate_at(offset, cmean):
            # centered extraction: store index off+u holds work[offset+u]
            seg = window_rows(
                trace, (w_start + offset - off) % ring_cap, kcap
            )
            seg = jnp.where(kmask, seg, 0.0)
            # cmean = window mean over the klen samples at `offset`
            cand = jnp.where(kmask, seg - cmean[:, None], 0.0)
            peakv = jnp.max(jnp.abs(cand), axis=-1)
            cand = cand / jnp.maximum(peakv, NORMALIZE_FLOOR)[:, None]
            std = jnp.maximum(p * BUFFER_FALLOFF_PERIODS, 1.0)
            g = _gaussian_sym(klen, std, kcap, off)
            return cand * g

        confident = confidence >= MIN_PERIODICITY
        cand = candidate_at(best, cmean_b)
        match = _norm_corr_single(reference, cand, kmask)
        do_reset = can_locate & confident & use_reference & (match < RESET_BELOW_MATCH)

        # DEFERRED reset (one-hop): clear the reference now and suppress its
        # rebuild; the NEXT hop's search runs with the pure edge template
        # (use_reference is False) and re-seeds the reference from that
        # candidate — the reference's same-hop re-search
        # (processor.rs:509-527) delayed by one 5.3 ms hop.  The original
        # same-hop redo lived under a lax.cond as a "rare event", but at
        # S=1024 streams SOME stream resets nearly every hop, so the
        # whole-batch redo (a second fused search kernel + re-pick)
        # amortized to ~0.6 ms/hop; the display samples captures at ~60 Hz,
        # so the one stale alignment is typically never rendered.
        reference = jnp.where(do_reset[:, None], 0.0, reference)

        # reference update (processor.rs:500-507)
        upd = can_locate & confident & ~do_reset
        refpeak = jnp.max(jnp.abs(reference), axis=-1)
        ref_norm = reference / jnp.maximum(refpeak, NORMALIZE_FLOOR)[:, None]
        new_ref = ref_norm + BUFFER_RESPONSIVENESS * (cand - ref_norm)
        reference = jnp.where(upd[:, None], jnp.where(kmask, new_ref, 0.0), reference)
        ref_period = jnp.where(upd, ref_period + BUFFER_RESPONSIVENESS * (p - ref_period), ref_period)

        # capture output (processor.rs:401-411)
        start = left + best
        borrow = (frac < 0.0) & (start > 0)
        start = jnp.where(borrow, start - 1, start)
        frac = jnp.where(borrow, frac + 1.0, frac)

        fb_span = jnp.float32(max(self.base_frames - 1, 1))
        fb_start = jnp.int32(hist - self.base_frames)
        cap = {
            "span": jnp.where(can_locate, span, fb_span),
            "start": jnp.where(can_locate, start, fb_start).astype(jnp.int32),
            "frac": jnp.where(can_locate, frac, 0.0),
            "valid": fresh_ok,
        }
        new_state = {
            "period": jnp.where(has_period, period, 0.0),
            "has_period": has_period,
            "missed": missed,
            "mean": mean_state,
            "reference": reference,
            "ref_period": ref_period,
        }
        return new_state, cap

    # -- zero-crossing capture (processor.rs:769-786) --------------------------

    def _zero_crossing_capture(self, trace, fresh_ok):
        s, hist = trace.shape
        frames = min(self.base_frames, hist)
        rng = self.max_period
        prev = jnp.concatenate([trace[:, :1], trace[:, :-1]], axis=-1)
        rising = (trace > 0.0) & (prev <= 0.0)
        idx = np.arange(hist)

        end = hist - 1
        right_lo = max(end - rng, 0)
        in_right = (idx >= right_lo) & (idx <= end)
        has_r = jnp.any(rising & in_right, axis=-1)
        right = jnp.where(
            has_r,
            jnp.max(jnp.where(rising & in_right, idx, -1), axis=-1),
            end,
        ).astype(jnp.int32)

        left_lo = jnp.maximum(right - frames, 0)
        left_hi = jnp.minimum(left_lo + rng, jnp.maximum(right - 2, 0))
        in_left = (idx[None, :] >= left_lo[:, None]) & (idx[None, :] <= left_hi[:, None])
        lmask = rising & in_left
        has_l = jnp.any(lmask, axis=-1)
        left = jnp.where(
            has_l,
            jnp.argmax(lmask, axis=-1),  # first rising edge ascending
            left_lo,
        ).astype(jnp.int32)

        return {
            "span": jnp.maximum(right - left, 1).astype(jnp.float32),
            "start": left,
            "frac": jnp.zeros((s,), jnp.float32),
            "valid": fresh_ok & (frames > 0),
        }

    # -- step -------------------------------------------------------------------

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, carry: dict, block, reset_mask=None):
        """One hop of ``[S, B, 2]`` folded stereo. Returns (carry, snapshot)."""
        cfg = self.config
        s, b, _ = block.shape
        hist_len = self.history_frames

        n_trig = self.n_trig
        lane_slots = self.trigger_lane_slots

        fresh = carry["fresh"]
        state = {k: carry[k] for k in
                 ("period", "has_period", "missed", "mean", "reference", "ref_period")}
        hist = carry["hist"]
        if reset_mask is not None:
            rm = reset_mask
            fresh = jnp.where(rm, 0, fresh)
            hist = tuple(jnp.where(rm[:, None], 0.0, h) for h in hist)
            rml = jnp.repeat(rm, n_trig)  # stream-major trigger lanes
            for k in state:
                z = jnp.zeros_like(state[k])
                state[k] = jnp.where(
                    rml[:, None] if state[k].ndim == 2 else rml, z, state[k]
                )
            if self.external_capture:
                # a capture anchored before the reset must not survive it
                carry = dict(carry)
                carry["cap"] = {
                    k: jnp.where(rm[:, None], jnp.zeros_like(v), v)
                    for k, v in carry["cap"].items()
                }
            if self.holds_snap:
                # a held capture from before the reset must not survive it
                carry = dict(carry)
                carry["snap"] = {
                    k: jnp.where(
                        rm.reshape((-1,) + (1,) * (v.ndim - 1)),
                        jnp.zeros_like(v), v,
                    )
                    for k, v in carry["snap"].items()
                }
        fresh = jnp.minimum(fresh + b, jnp.int32(2**30))

        # project and append to the rotated double-write history ring:
        # O(B) stores per step (aliased in-place in the scan carry) instead
        # of the O(hist) shift-left concat (~118 MB/step at S=1024).  The
        # mirror write keeps every logical window contiguous.
        projs = [
            projection_vector(cfg.channel_1),
            projection_vector(cfg.channel_2),
            projection_vector(cfg.trigger_source),
        ]
        proj = np.stack(projs, axis=1)  # [2, 3]
        newest = jnp.einsum(
            "sbc,ch->shb", block.astype(jnp.float32), proj,
            precision=jax.lax.Precision.HIGHEST,
        )  # [S, 3, B]
        origin = carry["origin"]
        cap = self.ring_cap
        z = jnp.int32(0)
        hist = tuple(
            jax.lax.dynamic_update_slice(
                jax.lax.dynamic_update_slice(h, newest[:, t], (z, origin)),
                newest[:, t],
                (z, origin + cap),
            )
            for t, h in enumerate(hist)
        )
        origin_next = (origin + b) % cap
        # logical right-aligned index L in [0, hist_len) lives at physical
        # shift + L; the mirror guarantees contiguity for length <= cap
        shift = (origin + b - hist_len) % cap

        fresh_ok = fresh >= jnp.int32(min(self.base_frames, hist_len))
        # trigger inputs: [S * n_trig, 2*cap], stream-major lanes.  The
        # single-lane case (linked trigger) passes its ring as-is — per-ring
        # carries make that a zero-copy view
        if n_trig == 1:
            trig_flat = hist[lane_slots[0]]
        else:
            trig_flat = jnp.stack(
                [hist[slot] for slot in lane_slots], axis=1
            ).reshape(s * n_trig, 2 * cap)
        fresh_lane = jnp.repeat(fresh_ok, n_trig)

        pspec = None
        new_pspec = {}
        if self.slides_probe:
            # sliding NSDF probe spectrum: one [2B, bins] delta matmul +
            # phasor rotation per hop replaces rfft(probe); exact re-anchor
            # every PROBE_REFRESH hops, on the first hop, and on any reset
            from openmeters_tpu.ops.fft import rfft_mxu

            nfft = self.nsdf_fft
            p = self.probe_frames
            mat_re, mat_im, rot_r, rot_i, _, _ = _probe_slide_consts(
                p, b, nfft
            )
            lanes_n = s * n_trig
            refresh = (carry["tick"] % PROBE_REFRESH == 0) | ~carry["panchored"]
            if reset_mask is not None:
                refresh = refresh | jnp.any(reset_mask)

            def exact(_):
                probe = jax.lax.dynamic_slice(
                    trig_flat, (z, shift + hist_len - p), (lanes_n, p)
                )
                spec = rfft_mxu(probe, nfft)
                return jnp.real(spec), jnp.imag(spec)

            def slide(_):
                leave = jax.lax.dynamic_slice(
                    trig_flat, (z, shift + hist_len - p - b), (lanes_n, b)
                )
                nb = jax.lax.dynamic_slice(
                    trig_flat, (z, shift + hist_len - b), (lanes_n, b)
                )
                delta = jnp.concatenate([leave, nb], axis=-1)
                # full f32 like the exact transform it stands in for (see
                # _estimate_period); drift is bounded by the exact
                # re-anchor every PROBE_REFRESH hops.  One lane-packed dot
                # ([re | im] columns) instead of two half-dots.
                prec = jax.lax.Precision.HIGHEST
                packed = jnp.einsum(
                    "sb,bk->sk",
                    delta,
                    jnp.concatenate(
                        [jnp.asarray(mat_re), jnp.asarray(mat_im)], axis=1
                    ),
                    precision=prec,
                )
                bins = mat_re.shape[1]
                dr, di = packed[:, :bins], packed[:, bins:]
                xr, xi = carry["pspec_re"], carry["pspec_im"]
                return (
                    xr * rot_r - xi * rot_i + dr,
                    xr * rot_i + xi * rot_r + di,
                )

            pre, pim = jax.lax.cond(refresh, exact, slide, None)
            pspec = (pre, pim)
            new_pspec = {
                "pspec_re": pre,
                "pspec_im": pim,
                "panchored": jnp.ones((), bool),
            }

        def run_trigger_state(state):
            if cfg.trigger_mode is TriggerMode.ZERO_CROSSING:
                # positional-mask scan needs the right-aligned view
                view = jax.lax.dynamic_slice(
                    trig_flat, (z, shift), (s * n_trig, hist_len)
                )
                capture = self._zero_crossing_capture(view, fresh_lane)
                new_state = state
            else:
                new_state, capture = self._stable_capture(
                    state, trig_flat, fresh_lane, shift, pspec=pspec
                )
            return new_state, {
                k: v.reshape(s, n_trig) for k, v in capture.items()
            }

        def extract_snap(cap2):
            def trace_cap(key, t):
                """Per-trace capture: its own lane when independent, else the
                single linked lane (processor.rs:684-700)."""
                if self.independent_triggers:
                    return cap2[key][:, lane_slots.index(t)]
                return cap2[key][:, 0]

            # capture windows: raw contiguous samples per trace (the
            # reference's linear downsample to <=4096 points happens
            # render-side, views.resample_trace — raw samples carry strictly
            # more information).  One batched row-window extraction over
            # the active traces.
            active = [t for t in range(TRACE_COUNT) if self.active_traces[t]]
            # per-trace ring extraction: one window_rows per active trace on
            # its own ring (no [S*traces, 2*cap] stack copy)
            extracted = {
                t: window_rows(
                    hist[t], trace_cap("start", t) + shift, self.window_cap
                )
                for t in active
            }
            samples = []
            valids = []
            spans, starts_o, fracs = [], [], []
            for t in range(TRACE_COUNT):
                if not self.active_traces[t]:
                    samples.append(jnp.zeros((s, self.window_cap), jnp.float32))
                    valids.append(jnp.zeros((s,), bool))
                    spans.append(jnp.zeros((s,), jnp.float32))
                    starts_o.append(jnp.zeros((s,), jnp.int32))
                    fracs.append(jnp.zeros((s,), jnp.float32))
                    continue
                samples.append(extracted[t])
                valids.append(trace_cap("valid", t))
                spans.append(trace_cap("span", t))
                starts_o.append(trace_cap("start", t))
                fracs.append(trace_cap("frac", t))
            return {
                "samples": jnp.stack(samples, axis=1),
                "trace_valid": jnp.stack(valids, axis=1),
                "span": jnp.stack(spans, axis=1),
                "start": jnp.stack(starts_o, axis=1),
                "frac": jnp.stack(fracs, axis=1),
            }

        tick = carry["tick"]
        every = max(int(cfg.trigger_every), 1)
        snap_every = self.snap_cadence

        def hold_snap(_):
            # the history window slid by one block since extraction: age the
            # positional metadata so start/frac keep meaning "where in the
            # CURRENT window the capture began"
            held = dict(carry["snap"])
            held["start"] = held["start"] - jnp.int32(b)
            return held

        if self.external_capture:
            # external capture: trigger state + capture METADATA update per
            # cadence; the [S, 2, window_cap] trace read happens in
            # :meth:`extract` at the consumer's display cadence — no cond,
            # no held-snapshot carry, nothing bulk in the hop step
            if every == 1:
                new_state, cap2 = run_trigger_state(state)
            else:
                def age_cap(st):
                    aged = dict(carry["cap"])
                    aged["start"] = aged["start"] - jnp.int32(b)
                    return st, aged

                new_state, cap2 = jax.lax.cond(
                    tick % every == 0, run_trigger_state, age_cap, state
                )
            snap = self._per_trace_meta(cap2, s)
            snap["samples"] = jnp.zeros((s, TRACE_COUNT, 0), jnp.float32)
        elif every == 1:
            new_state, cap2 = run_trigger_state(state)
            if snap_every == 1:
                snap = extract_snap(cap2)
            else:
                # trigger state updates every hop (processor.rs per-block
                # evaluation); the trace-window READ happens at the frame
                # clock's cadence (frame_clock.rs:102-118, ~60 Hz)
                snap = jax.lax.cond(
                    tick % snap_every == 0, extract_snap, hold_snap, cap2
                )
        else:
            # trigger cadence decoupled from the ingest hop (the reference
            # evaluates per UI frame ~60 Hz, below the 187 Hz hop rate)
            def run_full(st):
                ns, cap2 = run_trigger_state(st)
                return ns, extract_snap(cap2)

            new_state, snap = jax.lax.cond(
                tick % every == 0,
                run_full,
                lambda st: (st, hold_snap(None)),  # hold the previous capture
                state,
            )

        locked, period = self._lock_fields(new_state, s)

        new_carry = {
            "hist": hist,
            "origin": origin_next,
            "fresh": fresh,
            "tick": tick + 1,
            **new_pspec,
            **new_state,
        }
        if self.external_capture:
            new_carry["cap"] = cap2
        if self.holds_snap:
            new_carry["snap"] = snap
        return new_carry, OscilloscopeSnapshot(
            samples=snap["samples"],
            trace_valid=snap["trace_valid"],
            span=snap["span"],
            start=snap["start"],
            frac=snap["frac"],
            period=jnp.where(locked, period, 0.0),
            locked=locked,
        )


# -- helpers -------------------------------------------------------------------


def _osc_no_slide() -> bool:
    """Process-level snapshot of ``OPENMETERS_OSC_NO_SLIDE`` (read once:
    ``slides_probe`` gates the carry pytree structure, so every call site
    must agree for the life of the process)."""
    from openmeters_tpu.utils.envflags import snapshot_flag

    return snapshot_flag("OPENMETERS_OSC_NO_SLIDE")


@functools.lru_cache(maxsize=8)
def _probe_slide_consts(p: int, b: int, nfft: int):
    """Constants for the sliding NSDF probe spectrum.

    ``X' = rot·X + delta @ M`` advances the zero-padded window transform
    (window length ``p`` inside an ``nfft`` transform) by ``b`` samples:
    ``delta = [leaving block, entering block]`` and ``M``'s rows carry
    ``-e^{-2πik(m-b)/nfft}`` / ``e^{-2πik(p-b+j)/nfft}``.  ``D`` is the
    window support's Dirichlet vector (the DFT of 1 over [0, p)), so the
    mean-subtracted spectrum is exactly ``C = X - mean·D``."""
    bins = nfft // 2 + 1
    k = np.arange(bins, dtype=np.float64)
    rot = np.exp(2j * np.pi * k * b / nfft)
    m = np.arange(b, dtype=np.float64)
    leave = -np.exp(-2j * np.pi * np.outer(m - b, k) / nfft)
    enter = np.exp(-2j * np.pi * np.outer(p - b + m, k) / nfft)
    mat = np.concatenate([leave, enter], axis=0)
    theta = 2.0 * np.pi * k / nfft
    num = 1.0 - np.exp(-1j * theta * p)
    den = 1.0 - np.exp(-1j * theta)
    dirich = np.where(np.abs(den) > 1e-12, num / np.where(den == 0, 1, den), p)
    return (
        mat.real.astype(np.float32), mat.imag.astype(np.float32),
        rot.real.astype(np.float32), rot.imag.astype(np.float32),
        dirich.real.astype(np.float32), dirich.imag.astype(np.float32),
    )


def window_rows(x, starts, length: int):
    """Per-row contiguous windows ``out[s] = x[s, start[s] : start[s] +
    length]`` — one gather.  ``starts`` (``[S]``, or ``[S, W]`` for W
    windows per row) are clipped to ``[0, N - length]`` like
    ``dynamic_slice``.  Returns ``[S, length]`` or ``[S, W, length]``."""
    s, n = x.shape
    assert length <= n, (length, n)
    squeeze = starts.ndim == 1
    st = starts[:, None] if squeeze else starts
    st = jnp.clip(st.astype(jnp.int32), 0, n - length)
    out = jax.vmap(
        lambda row, ss: jax.vmap(
            lambda s0: jax.lax.dynamic_slice(row, (s0,), (length,))
        )(ss)
    )(x, st)
    return out[:, 0] if squeeze else out


def correlation_dots(work, template, anchor, nfft: int, n_offsets: int):
    """Sliding dot products ``dots[s, o] = sum_k work[s, o + anchor[s] + k]
    * template[s, k]`` for offsets ``o < n_offsets``, by one batched FFT of
    ``[work; template]``, a conjugate product and a one-sided inverse.  The
    per-stream ``anchor`` shift is a phase ramp (time-shift theorem), so
    the inverse lands every stream on the same static slice.  ``nfft``
    must cover ``work`` without wraparound at the offsets read."""
    from openmeters_tpu.ops.fft import irfft_mxu, rfft_mxu

    s, wcap = work.shape
    tmpl = jnp.pad(template, ((0, 0), (0, wcap - template.shape[1])))
    sf = rfft_mxu(jnp.concatenate([work, tmpl], axis=0), nfft)
    wf, tf = sf[:s], sf[s:]
    wf_re, wf_im = jnp.real(wf), jnp.imag(wf)
    t_re, t_im = jnp.real(tf), jnp.imag(tf)
    c_re = wf_re * t_re + wf_im * t_im  # wf · conj(tf)
    c_im = wf_im * t_re - wf_re * t_im
    ph_re, ph_im = _shift_phase(anchor, nfft)
    d_re, d_im = _cmul(c_re, c_im, ph_re, ph_im)
    return irfft_mxu(d_re, d_im, nfft, out_len=n_offsets)


def window_sums(work, klen, wlen, n_offsets: int):
    """Sliding sums of ``work`` and ``work²`` over ``klen[s]`` samples at
    offsets ``o < n_offsets`` (``sx[s, o] = sum work[s, o : o + klen[s]]``),
    plus the mean of ``work[s, :wlen[s]]``, from one cumsum over
    ``[work; work²]``."""
    s, wcap = work.shape
    cs2 = jnp.cumsum(jnp.concatenate([work, work * work], axis=0), axis=-1)
    cs2 = jnp.concatenate([jnp.zeros_like(cs2[:, :1]), cs2], axis=-1)
    hi2 = window_rows(cs2, jnp.tile(klen, 2), n_offsets)
    lo2 = cs2[:, :n_offsets]
    sx = hi2[:s] - lo2[:s]
    sxx = hi2[s:] - lo2[s:]
    # a one-hot prefix read of the cumsum at wlen
    oh_w = (
        jnp.arange(wcap + 1, dtype=jnp.int32)[None, :] == wlen[:, None]
    ).astype(jnp.float32)
    wmean = jnp.sum(cs2[:s] * oh_w, axis=-1) / jnp.maximum(
        wlen.astype(jnp.float32), 1.0
    )
    return sx, sxx, wmean


def _parabolic_refine(y0, y1, y2, tau):
    """reference processor.rs:14-19."""
    denom = y0 - 2.0 * y1 + y2
    delta = jnp.where(
        jnp.abs(denom) < 1e-7, 0.0, 0.5 * (y0 - y2) / jnp.where(jnp.abs(denom) < 1e-7, 1.0, denom)
    )
    return jnp.maximum(tau.astype(jnp.float32) + jnp.clip(delta, -1.0, 1.0), 1.0)


def _gaussian_sym(length, std, cap: int, off=None):
    """gaussian(len, i, std) over a capacity buffer (processor.rs:199-204).

    ``off`` ([S] int32) places the length-``length`` window at capacity
    index ``off`` (the centered template store); ``None`` means 0."""
    i = np.arange(cap, dtype=np.float32)
    rel = i[None, :] if off is None else i[None, :] - off.astype(jnp.float32)[:, None]
    center = (length.astype(jnp.float32) - 1.0) * 0.5
    x = (rel - center[:, None]) / jnp.maximum(std, 1e-6)[:, None]
    g = jnp.exp(-0.5 * x * x)
    ok = (length > 1)[:, None] & (rel >= 0.0) & (rel < length[:, None])
    return jnp.where(ok, g, 0.0)


def _edge_template(length, period, cap: int, off=None):
    """Gaussian-edged slope template (processor.rs:422-439): -w on the left
    half, +w on the right, center positive.  ``off`` as in
    :func:`_gaussian_sym`."""
    max_width = jnp.maximum(jnp.maximum(length // 2, 1).astype(jnp.float32) / 3.0, 1.0)
    width = jnp.clip(period * SLOPE_WIDTH_PERIODS, 1.0, max_width)
    g = _gaussian_sym(length, width, cap, off)
    i = np.arange(cap, dtype=np.int32)
    rel = i[None, :] if off is None else i[None, :] - off[:, None]
    sign = jnp.where(2 * rel >= (length - 1)[:, None], 1.0, -1.0)
    return EDGE_STRENGTH * g * sign


def _norm_corr_single(x, y, mask):
    """Normalized correlation of two masked buffers (processor.rs:210-236)."""
    n = jnp.maximum(jnp.sum(mask, axis=-1).astype(jnp.float32), 1.0)
    xm = jnp.where(mask, x, 0.0)
    ym = jnp.where(mask, y, 0.0)
    sx = jnp.sum(xm, axis=-1)
    sy = jnp.sum(ym, axis=-1)
    sxx = jnp.sum(xm * xm, axis=-1)
    syy = jnp.sum(ym * ym, axis=-1)
    sxy = jnp.sum(xm * ym, axis=-1)
    dot = sxy - sx * sy / n
    ex = jnp.maximum(sxx - sx * sx / n, 0.0)
    ey = jnp.maximum(syy - sy * sy / n, 0.0)
    denom = jnp.sqrt(ex * ey)
    return jnp.where(denom > 1e-7, jnp.clip(dot / jnp.maximum(denom, 1e-30), -1, 1), 0.0)


def _onehot_neighbors(values, idx):
    """``values [S, N]``, ``idx [S]`` → ``(values[idx-1], values[idx],
    values[idx+1])`` as fused one-hot reductions (out-of-range neighbors read
    as 0), fused into one vectorized pass."""
    n = values.shape[-1]
    oh = (jnp.arange(n, dtype=jnp.int32)[None, :] == idx[:, None]).astype(
        values.dtype
    )
    y1 = jnp.sum(values * oh, axis=-1)
    y0 = jnp.sum(values[:, :-1] * oh[:, 1:], axis=-1)
    y2 = jnp.sum(values[:, 1:] * oh[:, :-1], axis=-1)
    return y0, y1, y2


def _cmul(a_re, a_im, b_re, b_im):
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def _shift_phase(shift, nfft: int):
    """``e^{+2πi·j·shift/nfft}`` over one-sided bins: multiplying a spectrum
    by this advances its inverse transform by ``shift`` samples (time-shift
    theorem), turning dynamic per-stream window reads into static slices
    after the irfft.  The angle is reduced mod nfft in exact int32 before the
    float trig so large shifts lose no precision."""
    bins = nfft // 2 + 1
    j = jnp.arange(bins, dtype=jnp.int32)[None, :]
    m = (j * shift.astype(jnp.int32)[:, None]) % nfft
    ang = (2.0 * np.pi / nfft) * m.astype(jnp.float32)
    return jnp.cos(ang), jnp.sin(ang)








