"""Production serving loop: transport -> device -> snapshot drain.

Reference parity: the L3.5/L6 cadence — ``MeterEngine::advance``
(src/meter.rs:82-143) pulls capture spans, re-chunks them into DSP batches
with backlog coalescing (meter.rs:15-80), gates on pause (meter.rs:126-142),
and synthesizes bounded silence for stalled streams (meter.rs:145-166,
transport.rs:32-37,506-528).  Batched formulation:

- the C++ transport assembles fixed ``[S, B, C]`` batches (idle watchdog,
  activity epochs and generation resets live there, hop-cadence clocked);
- the loop alternates two host buffer sets so the async ``device_put`` of
  hop N overlaps assembly of hop N+1 (double buffering), and the engine
  carry is donated so the step updates state in place;
- snapshots drain with a bounded in-flight queue (depth 2 by default):
  dispatch never blocks on fetch, and hop->result latency (including H2D)
  is measured per drained hop;
- backlog coalescing runs up to ``coalesce_blocks`` extra hops per advance
  when the transport reports buffered blocks (the 1024-frame analogue);
- ``set_paused`` stops consuming entirely (pause gates at the producer too,
  via ``Transport.set_active`` per stream).

``EngineStats`` (tracing.py) is wired here: hops, resets, underruns,
realtime factor, plus latency percentiles.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta
from openmeters_tpu.ingest import Transport
from openmeters_tpu.tracing import EngineStats


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_streams: int = 64
    channels: int = 2
    engine: EngineConfig | None = None
    realtime: bool = True  # pace to the hop cadence vs flat out
    coalesce_blocks: int = 4  # meter.rs: 1024 frames / 256-frame batches
    drain_depth: int = 0  # in-flight fetches before a forced drain
    fetch: str = "meters"  # meters | full | none
    fetch_every: int = 6  # hops between host fetches (~30 Hz display rate,
    # the frame-clock cadence; undrained hops stay on device)
    scan_hops: int = 1  # >1: one device-side lax.scan over K hops per
    # dispatch — amortizes per-dispatch overhead; intermediate snapshots
    # are DCE'd and only the newest is fetched, exactly the frame-clock
    # consumption model
    assembler_shards: int = 1  # host assembler threads
    ring_seconds: float = 4.0 / 3.0
    max_backlog_seconds: float = 1.0
    max_silence_seconds: float = 2.0


def _meter_leaf_mask(snaps, n_streams: int):
    """Which snapshot leaves are per-stream scalar-ish meters (<=16 values
    per stream — LUFS, peaks, correlations, trigger state) vs bulk arrays
    (spectrogram columns, traces) that a display-rate consumer reads
    separately, exactly like the reference GUI reading snapshots at frame
    rate, not hop rate."""
    import jax

    return [
        int(np.prod(leaf.shape)) <= 16 * n_streams
        for leaf in jax.tree.leaves(snaps)
    ]


def _make_packer(mask):
    """``(pick, pack)``: ``pick`` selects the meter leaves (plain reference
    picking — holding them does NOT retain the bulk snapshot leaves in
    device memory), ``pack`` is one jitted concat of those leaves into a
    single f32 vector — the host fetch is then ONE transfer instead of one
    round-trip per leaf."""
    import jax
    import jax.numpy as jnp

    def pick(snaps):
        return [l for l, m in zip(jax.tree.leaves(snaps), mask) if m]

    @jax.jit
    def pack(picked):
        return jnp.concatenate([l.astype(jnp.float32).ravel() for l in picked])

    return pick, pack


@dataclasses.dataclass
class _Pipeline:
    """One engine configuration's compiled, warmed dispatch set.

    Built WITHOUT touching the server (everything below runs on locals), so
    a background thread can prepare a new configuration's pipeline while the
    serving thread keeps dispatching the old one (``apply_settings_async``).
    """

    engine: MeterEngine
    cadence: int
    place: object
    step: object
    spectrum_step: object | None
    meter_mask: list
    pick: object
    pack_leaves: object
    packed_layout: list


def _compile_pipeline(engine, config: ServeConfig, mesh, meta) -> _Pipeline:
    """Compile + warm the dispatch functions for ``engine``: the fast step,
    and the separate spectrum-hop dispatch when the spectrum runs at its own
    cadence (its own DspBatcher cadence, meter.rs:15-80; scan mode folds it
    into the scan).

    Warming runs two chained steps so the second compiles against a
    step-output carry (donated layouts) — otherwise the first real hop
    recompiles mid-serve — and derives the meter mask / packers from the
    warm snapshot structure.  A cold first hop would stall past the backlog
    cap and fault every stream, which is also why ``apply_settings_async``
    runs this whole function off-thread: the reference applies settings
    synchronously because its ``update_config`` is cheap, but here a
    configuration swap costs a compile and must not stall the hop cadence.
    """
    import jax

    ecfg = engine.config
    cadence = engine.spectrum_cadence
    if config.scan_hops > 1 and cadence > 1 and (config.scan_hops % cadence):
        raise ValueError(
            f"scan_hops ({config.scan_hops}) must be a multiple of the "
            f"spectrum cadence ({cadence})"
        )
    spectrum_step = None
    if mesh is not None:
        from openmeters_tpu.engine import sharded_step
        from openmeters_tpu.engine.sharding import (
            sharded_scan_step,
            sharded_spectrum_step,
        )

        if config.scan_hops > 1:
            step, place = sharded_scan_step(
                engine, mesh, config.scan_hops, donate_carry=True
            )
        else:
            step, place = sharded_step(engine, mesh, donate_carry=True)
            if cadence > 1:
                spectrum_step = sharded_spectrum_step(
                    engine, mesh, donate_carry=True
                )
    else:
        place = lambda c: c  # noqa: E731
        if config.scan_hops > 1:
            from openmeters_tpu.engine.sharding import scan_last_snapshot_fn

            step = jax.jit(scan_last_snapshot_fn(engine), donate_argnums=0)
        else:
            step = jax.jit(
                lambda c, b, m, r: engine.step(c, b, m, r), donate_argnums=0
            )
            if cadence > 1:
                spectrum_step = jax.jit(
                    lambda c, blocks, m, r: engine.spectrum_step(
                        c, blocks, m, r
                    ),
                    donate_argnums=0,
                )

    lead = (config.scan_hops,) if config.scan_hops > 1 else ()
    zeros = jax.device_put(
        np.zeros(
            (*lead, config.n_streams, ecfg.block_frames, config.channels),
            np.float32,
        )
    )
    no_reset = jax.device_put(np.zeros((*lead, config.n_streams), bool))
    warm_carry = place(engine.init(config.n_streams))
    warm_carry, warm_snaps = step(warm_carry, zeros, meta, no_reset)
    warm_carry, warm_snaps = step(warm_carry, zeros, meta, no_reset)
    if spectrum_step is not None:
        # warm the cadenced spectrum dispatch too (donated layouts)
        sp_zeros = jax.device_put(
            np.zeros(
                (cadence, config.n_streams, ecfg.block_frames, config.channels),
                np.float32,
            )
        )
        sp_reset = jax.device_put(np.zeros((cadence, config.n_streams), bool))
        sp_carry, sp_snap = spectrum_step(
            warm_carry["spectrum"], sp_zeros, meta, sp_reset
        )
        sp_carry, sp_snap = spectrum_step(sp_carry, sp_zeros, meta, sp_reset)
        warm_carry = dict(warm_carry, spectrum=sp_carry)
        warm_snaps = dict(warm_snaps, spectrum=sp_snap)
    meter_mask = _meter_leaf_mask(warm_snaps, config.n_streams)
    picked = (
        [True] * len(meter_mask) if config.fetch == "full" else meter_mask
    )
    pick, pack_leaves = _make_packer(picked)
    # names/shapes of the packed leaves so consumers can unpack the fetched
    # vector back into labeled meters (last_meters())
    paths, _ = jax.tree_util.tree_flatten_with_path(warm_snaps)
    packed_layout = [
        (jax.tree_util.keystr(path), leaf.shape)
        for (path, leaf), m in zip(paths, picked)
        if m
    ]
    jax.block_until_ready(pack_leaves(pick(warm_snaps)))
    del warm_carry  # donated input is gone
    return _Pipeline(
        engine, cadence, place, step, spectrum_step,
        meter_mask, pick, pack_leaves, packed_layout,
    )


class MeterServer:
    """Owns transport + engine + the serving loop."""

    def __init__(self, config: ServeConfig, mesh=None):
        import jax

        self.config = config
        engine_cfg = config.engine or EngineConfig()
        if engine_cfg.channels != config.channels:
            # serve at the transport's channel count (engine configs default
            # to 8-channel padding)
            engine_cfg = dataclasses.replace(engine_cfg, channels=config.channels)
        self.engine = MeterEngine(engine_cfg)
        ecfg = self.engine.config
        self.transport = Transport(
            n_streams=config.n_streams,
            channels=config.channels,
            block_frames=ecfg.block_frames,
            sample_rate=ecfg.sample_rate,
            ring_seconds=config.ring_seconds,
            max_backlog_seconds=config.max_backlog_seconds,
            max_silence_seconds=config.max_silence_seconds,
        )
        self.meta = StreamMeta.default(
            config.n_streams, channels=config.channels, pad_channels=config.channels
        )
        # per-stream layout rows (reference AudioFormat.positions ->
        # fold/weights, dsp.rs:79-176): producers renegotiate positions via
        # the ingest protocol; set_stream_layout updates the host rows and
        # the device meta is re-put on the next advance
        import threading

        self._meta_lock = threading.Lock()
        self._meta_fold = np.asarray(self.meta.fold).copy()
        self._meta_weights = np.asarray(self.meta.weights).copy()
        self._meta_dirty = False
        self._mesh = mesh
        k, s, b = config.scan_hops, config.n_streams, ecfg.block_frames
        if k > 1:
            self._buffers = [
                (
                    np.zeros((k, s, b, config.channels), np.float32),
                    np.zeros((k, s), np.uint8),
                    np.zeros((k, s), np.uint8),
                )
                for _ in range(2)
            ]
        else:
            self._buffers = [self.transport.make_buffers() for _ in range(2)]
        self._buf_dev = [None, None]  # each buffer set's last device copy
        self._pool = (
            ThreadPoolExecutor(config.assembler_shards)
            if config.assembler_shards > 1
            else None
        )
        self.paused = False
        self._stop = False
        self._resume_mask = None  # set by restore(): streams whose next
        # generation reset is the resumption itself (suppressed once)
        self.stats = EngineStats()
        self.latencies_ms: list[float] = []
        self.last_snapshot = None
        self.on_drain = None  # optional display-rate callback (fires per drained fetch)
        self.on_tick = None  # optional per-loop-iteration callback (fires
        # even while paused — the control-input hook: a paused server stops
        # draining, so pause/quit keys must not ride on_drain)
        self._inflight: list[tuple[float, object]] = []
        self._buf_i = 0
        self._view_histories: dict = {}  # declare_view retention rings
        self._view_stream = 0
        self._swap_thread = None  # apply_settings_async compile worker
        self._pending_swap = None  # (engine_cfg, _Pipeline) staged for adopt
        self._swap_error = None
        self._adopt_pipeline(
            _compile_pipeline(self.engine, config, mesh, self.meta),
            self.engine.init(config.n_streams),
            engine_cfg,
        )

    def _adopt_pipeline(self, pipe: _Pipeline, carry, engine_cfg) -> None:
        """Swap the live dispatch set + carry (the hop-boundary handoff).

        In-flight fetches drain first — they were packed under the OLD
        layout and must be unpacked with it.  The caller supplies the carry
        (fresh at startup; ``migrate_carry`` output for a reconfiguration).
        """
        while self._inflight:
            self._drain_one()
        self.engine = pipe.engine
        self.config = dataclasses.replace(self.config, engine=engine_cfg)
        self._cadence = pipe.cadence
        self._place = pipe.place
        self._step = pipe.step
        self._spectrum_step = pipe.spectrum_step
        self._meter_mask = pipe.meter_mask
        self._pick = pipe.pick
        self._pack_leaves = pipe.pack_leaves
        self._packed_layout = pipe.packed_layout
        self.carry = self._place(carry)
        self._dev_meters = None  # repopulated by the next advance
        if self._spectrum_step is not None:
            # the new spectrum cadence restarts on a hop boundary; hold a
            # true current-state snapshot (never a warmup dispatch's
            # zeros-input one) so fetches before the first spectrum hop
            # report the carried averaging state.  Per-engine-hop reset
            # rows: spectrum_step zeroes pre-reset blocks device-side so
            # stale audio never enters the window.
            self._spec_pending: list = []
            self._spec_resets = np.zeros(
                (self._cadence, self.config.n_streams), bool
            )
            self._dev_spectrum_snap = self.engine.analyzers["spectrum"].emit(
                self.carry["spectrum"]
            )
        else:
            # fused (cadence-1) or disabled spectrum: no held snapshot —
            # fetch_spectrum re-emits from the live carry instead
            self._dev_spectrum_snap = None
        self._revalidate_view_histories()

    def _revalidate_view_histories(self) -> None:
        """Re-fit declare_view retention rings after a reconfiguration: a
        changed FFT geometry changes the spectrogram column width; a removed
        analyzer orphans its ring."""
        hist = self._view_histories.get("spectrogram")
        if hist is None:
            return
        sg = self.engine.analyzers.get("spectrogram")
        if sg is None:
            del self._view_histories["spectrogram"]
            return
        bins = sg.padded_fft // 2 + 1
        if bins != hist.bins:
            from openmeters_tpu.analyzers.spectrogram import history_columns
            from openmeters_tpu.views import SpectrogramHistory

            self._view_histories["spectrogram"] = SpectrogramHistory(
                bins,
                history_columns(sg.config.use_reassignment, bins, hist.columns),
            )
    # -- control ------------------------------------------------------------

    def apply_settings(self, engine_cfg: EngineConfig) -> None:
        """Reconfigure the RUNNING server: swap the compiled step for the new
        engine config and migrate the live carry at the reference's
        ``update_config`` granularity (``MeterEngine.migrate_carry``) — e.g.
        a spectrum floor change keeps the 3 s loudness window, the trigger
        lock, and the spectrum's 16384-sample PCM window.

        The transport's geometry is fixed at construction: ``sample_rate``,
        ``block_frames`` and ``channels`` must be unchanged (a rate change
        needs a new server, exactly as the reference rebuilds per-rate
        processors).  Any partially-accumulated spectrum hop is dropped (the
        new spectrum cadence restarts on a hop boundary).
        """
        engine_cfg, new_engine = self._validated_engine(engine_cfg)
        pipe = _compile_pipeline(new_engine, self.config, self._mesh, self.meta)
        # migrate the live state BEFORE swapping (field-level retention)
        carry = new_engine.migrate_carry(
            self.engine, self.carry, self.config.n_streams
        )
        self._adopt_pipeline(pipe, carry, engine_cfg)

    def apply_settings_async(self, engine_cfg: EngineConfig):
        """Reconfigure WITHOUT stalling the hop cadence.

        :meth:`apply_settings` compiles synchronously — seconds of compile,
        enough to blow the transport's 1 s backlog cap and fault every
        stream mid-serve.  This variant compiles + warms the new
        configuration's pipeline on a background thread while the server
        keeps serving the old one, then the serving loop adopts it at the
        next hop boundary (``advance``): carry migration at the reference's
        ``update_config`` granularity, a sub-hop handoff instead of a
        multi-second stall.  The reference can apply settings synchronously
        only because its ``update_config`` is allocation-cheap
        (spectrum/processor.rs:300-326); a compiled-graph runtime needs this
        split.

        Validation errors (rate/block geometry, scan/cadence mismatch)
        raise here synchronously; a compile failure surfaces from the next
        ``advance()``.  Returns the compile thread — ``join()`` to block
        until the swap is staged (tests; production just keeps serving).
        """
        import threading

        engine_cfg, new_engine = self._validated_engine(engine_cfg)
        if self.reconfig_pending:
            raise RuntimeError(
                "a reconfiguration is already in flight; wait for it to "
                "be adopted before applying another"
            )
        cfg, mesh, meta = self.config, self._mesh, self.meta

        def work():
            try:
                pipe = _compile_pipeline(new_engine, cfg, mesh, meta)
                self._pending_swap = (engine_cfg, pipe)
            except BaseException as exc:  # surfaced from the serving loop
                self._swap_error = exc
            finally:
                self._swap_thread = None

        t = threading.Thread(
            target=work, name="openmeters-reconfig", daemon=True
        )
        self._swap_thread = t
        t.start()
        return t

    @property
    def reconfig_pending(self) -> bool:
        """True while an async reconfiguration is compiling or staged."""
        return self._swap_thread is not None or self._pending_swap is not None

    def _maybe_adopt_pending(self) -> None:
        """Hop-boundary handoff for :meth:`apply_settings_async`."""
        err = self._swap_error
        if err is not None:
            self._swap_error = None
            raise RuntimeError(
                "background reconfiguration failed to compile"
            ) from err
        pending = self._pending_swap
        if pending is None:
            return
        self._pending_swap = None
        engine_cfg, pipe = pending
        carry = pipe.engine.migrate_carry(
            self.engine, self.carry, self.config.n_streams
        )
        self._adopt_pipeline(pipe, carry, engine_cfg)

    def _validated_engine(self, engine_cfg: EngineConfig):
        """Clamp ``channels`` to the transport's and reject geometry the
        transport owns (``sample_rate``/``block_frames``: a rate change
        needs a new server, exactly as the reference rebuilds per-rate
        processors)."""
        if engine_cfg.channels != self.config.channels:
            engine_cfg = dataclasses.replace(
                engine_cfg, channels=self.config.channels
            )
        new_engine = MeterEngine(engine_cfg)
        ecfg, old_ecfg = new_engine.config, self.engine.config
        if (ecfg.sample_rate, ecfg.block_frames) != (
            old_ecfg.sample_rate, old_ecfg.block_frames
        ):
            raise ValueError(
                "apply_settings cannot change sample_rate/block_frames of a "
                "running server (the transport owns them) — build a new "
                f"MeterServer: {(ecfg.sample_rate, ecfg.block_frames)} != "
                f"{(old_ecfg.sample_rate, old_ecfg.block_frames)}"
            )
        if self.config.scan_hops > 1 and new_engine.spectrum_cadence > 1 and (
            self.config.scan_hops % new_engine.spectrum_cadence
        ):
            raise ValueError(
                f"scan_hops ({self.config.scan_hops}) must be a multiple of "
                f"the new spectrum cadence ({new_engine.spectrum_cadence})"
            )
        return engine_cfg, new_engine

    def set_paused(self, paused: bool) -> None:
        """Global pause: stop consuming (meter.rs:126-142)."""
        self.paused = paused

    def stop(self) -> None:
        """Ask a running :meth:`run` loop to return after the current hop
        (the quit shortcut's target; safe from drain callbacks)."""
        self._stop = True

    # -- checkpoint/restore ---------------------------------------------------

    def checkpoint(self, path: str) -> None:
        """Snapshot the live engine carry (filter states, loudness windows,
        rings, trigger locks) to ``path``.  The serving-path analogue of the
        reference's flush-on-exit (main.rs:59, persistence/store.rs:142-181)
        — except the reference persists only settings; this preserves the
        DSP state itself so a restarted server resumes mid-window (no 3 s
        loudness warmup, no trigger re-lock)."""
        from openmeters_tpu.checkpoint import save_state

        save_state(path, self.engine, self.carry)

    def restore(self, path: str) -> None:
        """Load a carry checkpoint into the live server (engine config must
        fingerprint-match; stream count must equal the serving config)."""
        from openmeters_tpu.checkpoint import _infer_streams, load_state

        carry = load_state(path, self.engine)
        import jax

        n = _infer_streams(self.engine, jax.tree.leaves(carry))
        if n != self.config.n_streams:
            raise ValueError(
                f"checkpoint holds {n} streams; server is configured for "
                f"{self.config.n_streams}"
            )
        self.carry = self._place(carry)
        if self._spectrum_step is not None:
            # drop any partially-accumulated spectrum hop; the restored
            # carry resumes on a fresh spectrum-hop boundary
            self._spec_pending.clear()
            self._spec_resets[:] = False
            # re-prime the held device snapshot from the restored averaging
            # state — otherwise fetches report the discarded run's spectrum
            # for up to R-1 advances after a restore
            self._dev_spectrum_snap = self.engine.analyzers["spectrum"].emit(
                self.carry["spectrum"]
            )
        # a restarted transport flags each stream's first data as a
        # generation reset; that reset is the resumption itself — consume
        # the first one per stream so it cannot wipe the restored carry
        self._resume_mask = np.ones((self.config.n_streams,), bool)

    def set_active(self, stream: int, active: bool) -> None:
        self.transport.set_active(stream, active)

    def declare_view(
        self,
        stream: int = 0,
        spectrogram_columns: int | None = None,
        waveform_columns: int | None = None,
    ) -> dict:
        """pre_ingest retention feedback (reference registry.rs:181-209):
        a consumer declares, BEFORE ingest, how much history it can display;
        the session sizes its retention to that — clamped through the
        reference's budget math (``history_columns``: 128 MiB / 8192-column
        cap; waveform ``MAX_COLUMN_CAPACITY``).  A narrow consumer therefore
        bounds history memory; a greedy one cannot exceed the budget.

        Bulk history here is HOST-side by design (the device holds only the
        newest snapshot; the display-rate drain fetches bulk leaves in
        ``fetch='full'`` mode), so the bound applies to the host rings the
        drain feeds.  Returns the granted retention.
        """
        from openmeters_tpu.views import SpectrogramHistory, WaveformHistory

        granted = {}
        sg = self.engine.analyzers.get("spectrogram")
        if spectrogram_columns is not None and sg is not None:
            from openmeters_tpu.analyzers.spectrogram import history_columns

            bins = sg.padded_fft // 2 + 1
            cols = history_columns(
                sg.config.use_reassignment, bins, spectrogram_columns
            )
            hist = self._view_histories.get("spectrogram")
            if hist is None or hist.bins != bins:
                self._view_histories["spectrogram"] = SpectrogramHistory(
                    bins, cols
                )
            else:
                hist.resize(cols)
            granted["spectrogram_columns"] = cols
        wf = self.engine.analyzers.get("waveform")
        if waveform_columns is not None and wf is not None:
            hist = self._view_histories.get("waveform")
            if hist is None:
                self._view_histories["waveform"] = WaveformHistory(
                    max_columns=waveform_columns
                )
            else:
                hist.resize(waveform_columns)
            granted["waveform_columns"] = self._view_histories[
                "waveform"
            ].max_columns
        self._view_stream = stream
        return granted

    def _feed_histories(self) -> None:
        """Push the drained bulk leaves into the declared view rings
        (display-rate, ``fetch='full'`` only — meter mode fetches no bulk)."""
        if not self._view_histories:
            return
        meters = self.last_meters()
        if not meters:
            return
        st = self._view_stream
        sg_hist = self._view_histories.get("spectrogram")
        if sg_hist is not None:
            codes_key = next(
                (k for k in meters if "spectrogram" in k and "codes" in k), None
            )
            valid_key = next(
                (k for k in meters if "spectrogram" in k and "valid" in k), None
            )
            if codes_key and valid_key:
                codes = np.asarray(meters[codes_key])[st]
                valid = np.asarray(meters[valid_key])[st].astype(bool)
                if valid.any():
                    sg_hist.push(codes[valid].astype(np.uint16))
        wf_hist = self._view_histories.get("waveform")
        if wf_hist is not None:
            from openmeters_tpu.views import waveform_columns_from_meters

            cols = waveform_columns_from_meters(meters, st)
            if cols:
                wf_hist.push_columns(cols)

    def set_stream_layout(self, stream: int, channels: int, positions=None) -> None:
        """Apply a producer's (re)negotiated channel layout to this stream:
        rebuild its stereo fold row (dsp.rs:135-176) and BS.1770 weight row
        (LFE x0, surround x1.41, loudness/processor.rs:174-183).  Thread-safe
        (called from ingest pump threads); takes effect on the next hop."""
        from openmeters_tpu.utils.channels import (
            channel_fallback,
            channel_weights,
            normalize_positions,
            stereo_matrix,
        )

        pad = self.config.channels
        channels = min(max(int(channels), 1), pad)
        positions = (
            normalize_positions(channels, positions)
            if positions
            else channel_fallback(channels)
        )
        fold = stereo_matrix(channels, positions)[:pad]
        weights = channel_weights(positions)[:pad].copy()
        weights[channels:] = 0.0  # frames beyond the producer width are mute
        with self._meta_lock:
            self._meta_fold[stream] = fold
            self._meta_weights[stream] = weights
            self._meta_dirty = True

    # -- the loop -----------------------------------------------------------

    def _advance_one(self) -> None:
        import jax
        import jax.numpy as jnp

        cfg = self.config
        ecfg = self.engine.config
        k = cfg.scan_hops
        buf_i = self._buf_i
        batch, reset, underrun = self._buffers[buf_i]
        self._buf_i ^= 1
        # the work that read this buffer set two hops ago must be done
        # before it is reassembled: a device_put returns before its
        # transfer, and on the CPU the device array aliases the buffer
        jax.block_until_ready(self._buf_dev[buf_i])
        if self._meta_dirty:
            # a producer renegotiated its channel layout: swap in the
            # rebuilt fold/weight rows (takes effect this hop, alongside
            # the generation reset the renegotiation produced)
            with self._meta_lock:
                new_meta = StreamMeta(
                    fold=jax.device_put(self._meta_fold.copy()),
                    weights=jax.device_put(self._meta_weights.copy()),
                )
                self._meta_dirty = False
            self.meta = new_meta
        t0 = time.perf_counter()
        if k > 1:
            n_resets = n_under = 0
            for j in range(k):
                _, rst, und, _ = self.transport.assemble(
                    pool=self._pool, shards=cfg.assembler_shards,
                    out=(batch[j], reset[j], underrun[j]),
                )
                n_resets += int(rst.sum())
                n_under += int(und.sum())
            reset_b = reset.astype(bool)
            if self._resume_mask is not None:
                for j in range(k):
                    consumed = reset_b[j] & self._resume_mask
                    reset_b[j] &= ~self._resume_mask
                    self._resume_mask &= ~consumed
                    n_resets -= int(consumed.sum())
                if not self._resume_mask.any():
                    self._resume_mask = None
            dev_reset = jax.device_put(reset_b)
            for _ in range(k):
                self.stats.record(
                    cfg.n_streams, ecfg.block_frames, ecfg.sample_rate,
                )
            self.stats.resets += n_resets
            self.stats.underruns += n_under
        else:
            _, rst, und, _ = self.transport.assemble(
                pool=self._pool, shards=cfg.assembler_shards,
                out=(batch, reset, underrun), buf_id=buf_i,
            )
            rst = np.asarray(rst).astype(bool)
            if self._resume_mask is not None:
                consumed = rst & self._resume_mask
                rst = rst & ~self._resume_mask
                self._resume_mask &= ~consumed
                if not self._resume_mask.any():
                    self._resume_mask = None
            dev_reset = jax.device_put(rst)
            self.stats.record(
                cfg.n_streams, ecfg.block_frames, ecfg.sample_rate,
                resets=int(rst.sum()), underruns=int(und.sum()),
            )
        dev_batch = jax.device_put(batch)
        self.carry, snaps = self._step(self.carry, dev_batch, self.meta, dev_reset)
        readers = [snaps]
        if self._spectrum_step is not None:
            # accumulate this spectrum hop's engine blocks; dispatch the
            # spectrum's own hop every R-th advance (meter.rs per-visual
            # cadence).  A device copy of the batch: the host buffer set is
            # reassembled two hops from now, before the spectrum hop reads it.
            pending = jnp.copy(dev_batch)
            readers.append(pending)
            self._spec_pending.append(pending)
            self._spec_resets[len(self._spec_pending) - 1] = rst  # k == 1 path
            if len(self._spec_pending) == self._cadence:
                sp_carry, sp_snap = self._spectrum_step(
                    self.carry["spectrum"],
                    jnp.stack(self._spec_pending),
                    self.meta,
                    jax.device_put(self._spec_resets.copy()),
                )
                self.carry = dict(self.carry, spectrum=sp_carry)
                self._dev_spectrum_snap = sp_snap
                self._spec_pending.clear()
                self._spec_resets[:] = False
            snaps = dict(snaps, spectrum=self._dev_spectrum_snap)
        self._buf_dev[buf_i] = readers
        # retain only the small meter leaves for fetch_meters_now — keeping
        # the whole snapshot pytree would pin the bulk leaves (spectrogram
        # codes, trace buffers: ~100s of MB at high stream counts) in device
        # memory between steps
        self._dev_meters = self._pick(snaps)
        # display-rate drain: pack+fetch every fetch_every-th hop (one
        # transfer); other hops stay on device (their state lives on in the
        # carry; the snapshot handle is simply dropped)
        fetch_now = (
            cfg.fetch != "none"
            and (self.stats.hops // k) % max(cfg.fetch_every // k, 1) == 0
        )
        if fetch_now:
            self._inflight.append((t0, self._pack_leaves(self._dev_meters)))
        while len(self._inflight) > cfg.drain_depth:
            self._drain_one()

    def _drain_one(self) -> None:
        if not self._inflight:
            return
        t0, packed = self._inflight.pop(0)
        self.last_snapshot = np.asarray(packed)
        # the layout the snapshot was packed under — survives a pipeline
        # swap so last_meters() never unpacks old bytes with a new layout
        self._last_layout = self._packed_layout
        self.latencies_ms.append((time.perf_counter() - t0) * 1e3)
        self._feed_histories()
        if self.on_drain is not None:
            self.on_drain(self)  # display-rate consumer (e.g. the TUI)

    def advance(self) -> None:
        """One engine advance: a hop plus backlog catch-up (coalescing)."""
        self._maybe_adopt_pending()  # staged async reconfiguration, if any
        if self.paused:
            return
        self._advance_one()
        if self.config.scan_hops == 1:
            extra = min(
                self.transport.backlog_blocks(), self.config.coalesce_blocks - 1
            )
            for _ in range(extra):
                self._advance_one()

    def run(self, duration_s: float) -> dict:
        """Serve for ``duration_s`` wall seconds; returns the stats report."""
        ecfg = self.engine.config
        advance_s = (
            ecfg.block_frames * self.config.scan_hops / ecfg.sample_rate
        )
        t_start = time.perf_counter()
        deadline = t_start + advance_s
        end = t_start + duration_s
        self._stop = False
        while time.perf_counter() < end and not self._stop:
            if self.config.realtime:
                # wait for the window's audio to arrive, then drain it
                now = time.perf_counter()
                if now < deadline:
                    time.sleep(deadline - now)
                deadline += advance_s
                if deadline < now:  # fell behind: drop missed ticks
                    deadline = now + advance_s
            if self.on_tick is not None:
                self.on_tick(self)
            self.advance()
        while self._inflight:
            self._drain_one()
        self.stats.wall_seconds = time.perf_counter() - t_start
        return self.report()

    def fetch_meters_now(self) -> dict[str, np.ndarray] | None:
        """Synchronously fetch the newest on-device snapshot's meter leaves
        (bypasses the display-rate drain cadence — for tests/controllers)."""
        picked = getattr(self, "_dev_meters", None)
        if picked is None:
            return None
        self.last_snapshot = np.asarray(self._pack_leaves(picked))
        self._last_layout = self._packed_layout
        return self.last_meters()

    def fetch_osc_traces(self, as_numpy: bool = True):
        """Display-rate oscilloscope trace fetch: extract the capture
        windows from the live carry (the engine's oscilloscope runs
        external-capture mode — the hop step never reads bulk trace data;
        this is the frame-clock read, frame_clock.rs:102-118).  Returns an
        OscilloscopeSnapshot or None when the oscilloscope is disabled."""
        if "oscilloscope" not in self.engine.analyzers:
            return None
        snap = self.engine.extract_oscilloscope(self.carry)
        if as_numpy:
            import jax

            return jax.tree.map(np.asarray, snap)
        return snap

    def fetch_spectrum(self, as_numpy: bool = True):
        """Display-rate spectrum fetch (frame_clock.rs:102-118 semantics):
        the hop loop never ships the bulk [S, 2, bins] dB arrays to the host
        — a display consumer reads the newest held spectrum snapshot at its
        own clock, one transfer per call.  Cadenced spectra return the
        snapshot held from the last spectrum hop; fused (cadence-1) spectra
        re-emit from the live carry (``SpectrumAnalyzer.emit`` reads the
        held dB state — no FFT work).  Returns a SpectrumSnapshot or None
        when the spectrum analyzer is disabled."""
        if "spectrum" not in self.engine.analyzers:
            return None
        snap = self._dev_spectrum_snap
        if snap is None:
            snap = self.engine.analyzers["spectrum"].emit(self.carry["spectrum"])
        if as_numpy:
            import jax

            return jax.tree.map(np.asarray, snap)
        return snap

    def last_meters(self) -> dict[str, np.ndarray] | None:
        """The most recently drained fetch, unpacked into named per-leaf
        arrays (key = snapshot pytree path, e.g.
        ``['loudness'].momentary_lufs``)."""
        if self.last_snapshot is None:
            return None
        out = {}
        off = 0
        for name, shape in getattr(self, "_last_layout", self._packed_layout):
            size = int(np.prod(shape))
            out[name] = self.last_snapshot[off : off + size].reshape(shape)
            off += size
        return out

    def report(self) -> dict:
        lat = np.asarray(self.latencies_ms, np.float64)
        ecfg = self.engine.config
        hop_s = ecfg.block_frames / ecfg.sample_rate
        realtime_streams = (
            self.config.n_streams
            * (self.stats.hops * hop_s)
            / max(self.stats.wall_seconds, 1e-9)
        )
        return {
            "streams": self.config.n_streams,
            "hops": self.stats.hops,
            "resets": self.stats.resets,
            "underruns": self.stats.underruns,
            "audio_seconds": round(self.stats.audio_seconds, 3),
            "wall_seconds": round(self.stats.wall_seconds, 3),
            "realtime_factor": round(self.stats.realtime_factor, 2),
            "realtime_streams": int(realtime_streams),
            "latency_ms_p50": round(float(np.percentile(lat, 50)), 3) if lat.size else None,
            "latency_ms_p95": round(float(np.percentile(lat, 95)), 3) if lat.size else None,
            "latency_ms_max": round(float(lat.max()), 3) if lat.size else None,
        }

    def close(self) -> None:
        while self._inflight:
            self._drain_one()
        if self._pool:
            self._pool.shutdown()


class MultiRateMeterServer:
    """Serve streams of several sample rates concurrently.

    Reference parity: ``DspBatcher`` scales its batch frames by rate and the
    processors are rebuilt per rate (meter.rs:20-25) — there is exactly one
    engine *per rate*.  Batched equivalent: one :class:`MeterServer` (engine
    + transport + compiled step) per rate bucket, plus one
    :class:`~openmeters_tpu.ingest.runtime.SessionRuntime` routing producers
    into their rate's transport by HELLO/FORMAT negotiation.

    Rate-scaled blocks hold equal wall time (256@48k = 5.333 ms ≈ 235@44.1k),
    so one clock advances every bucket.
    """

    def __init__(
        self,
        config: ServeConfig,
        rates: tuple[float, ...] = (48_000.0,),
        socket_path: str | None = None,
        mesh=None,
    ):
        from openmeters_tpu.engine import scaled_block_frames

        self.servers: dict[float, MeterServer] = {}
        for r in sorted(float(r) for r in rates):
            base = config.engine or EngineConfig()
            ecfg = dataclasses.replace(
                base, sample_rate=r, block_frames=scaled_block_frames(r)
            )
            self.servers[r] = MeterServer(
                dataclasses.replace(config, engine=ecfg), mesh=mesh
            )
        self.runtime = None
        if socket_path is not None:
            from openmeters_tpu.ingest.runtime import SessionRuntime

            def on_layout(rate, slot, channels, positions):
                # thread per-stream positions into the rate bucket's engine
                # meta (reference AudioFormat -> fold/weights propagation)
                self.servers[rate].set_stream_layout(slot, channels, positions)

            self.runtime = SessionRuntime(
                {r: s.transport for r, s in self.servers.items()},
                socket_path,
                max_channels=config.channels,
                on_layout=on_layout,
            )

    def advance(self) -> None:
        for s in self.servers.values():
            s.advance()

    def apply_settings(self, engine_cfg: EngineConfig) -> None:
        """Apply one settings configuration across every rate bucket — the
        reference rebuilds processors per rate on a settings change
        (meter.rs:20-25); each bucket keeps its own transport-owned
        ``sample_rate``/``block_frames``."""
        for t in self.apply_settings_async(engine_cfg):
            t.join()
        for s in self.servers.values():
            s._maybe_adopt_pending()  # noqa: SLF001

    def apply_settings_async(self, engine_cfg: EngineConfig) -> list:
        """Per-bucket :meth:`MeterServer.apply_settings_async`; the buckets
        adopt independently at their next hop boundaries.  Returns the
        compile threads."""
        from openmeters_tpu.engine import scaled_block_frames

        threads = []
        for r, s in self.servers.items():
            threads.append(
                s.apply_settings_async(
                    dataclasses.replace(
                        engine_cfg,
                        sample_rate=r,
                        block_frames=scaled_block_frames(r),
                    )
                )
            )
        return threads

    def run(self, duration_s: float) -> dict:
        cadence = min(
            s.engine.config.block_frames
            * s.config.scan_hops
            / s.engine.config.sample_rate
            for s in self.servers.values()
        )
        t_start = time.perf_counter()
        deadline = t_start + cadence
        end = t_start + duration_s
        while time.perf_counter() < end:
            if self.config.realtime:
                now = time.perf_counter()
                if now < deadline:
                    time.sleep(deadline - now)
                deadline += cadence
                if deadline < now:
                    deadline = now + cadence
            self.advance()
        wall = time.perf_counter() - t_start
        for s in self.servers.values():
            while s._inflight:  # noqa: SLF001
                s._drain_one()  # noqa: SLF001
            s.stats.wall_seconds = wall
        return self.report()

    @property
    def config(self) -> ServeConfig:
        return next(iter(self.servers.values())).config

    def report(self) -> dict:
        return {rate: s.report() for rate, s in self.servers.items()}

    def close(self) -> None:
        if self.runtime is not None:
            self.runtime.shutdown()
        for s in self.servers.values():
            s.close()


def attach_settings_watcher(
    server: MeterServer, path: str, min_interval: float = 0.5
):
    """Hot-reload a running server from its settings file: the headless
    analogue of the reference's config page — there the GUI edits settings
    and ``VisualManager::apply_module_settings`` applies them live
    (registry.rs:345); here an operator (or another process) edits the
    persisted settings JSON and the serving loop picks the change up.

    Piggybacks on the display-rate drain callback (``on_drain``, composing
    with any existing consumer such as the TUI): at most every
    ``min_interval`` seconds it stats the file, and on an mtime/size change
    loads the lossy-schema settings and stages them via
    :meth:`MeterServer.apply_settings_async` — the old configuration keeps
    serving through the compile.  Transport-owned geometry
    (``sample_rate``/``block_frames``) is pinned to the live server's, so a
    rate edit in the file is ignored rather than fatal; a malformed file
    logs and keeps the old configuration (the reference's lossy-load
    semantics, persistence/store.rs).
    """
    import logging
    import os

    from openmeters_tpu.persistence import SettingsHandle

    log = logging.getLogger("openmeters.serve")

    def _sig():
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)

    state = {"sig": _sig() if os.path.exists(path) else None, "next": 0.0}
    prev = server.on_drain

    def on_drain(s):
        if prev is not None:
            prev(s)
        now = time.monotonic()
        if now < state["next"] or s.reconfig_pending:
            return
        state["next"] = now + min_interval
        try:
            sig = _sig()
        except OSError:
            return  # mid-rename (the saver writes tmp+rename) or deleted
        if sig == state["sig"]:
            return
        state["sig"] = sig
        try:
            cfg = SettingsHandle.load_or_default(path)
            ecfg = s.engine.config
            cfg = dataclasses.replace(
                cfg,
                sample_rate=ecfg.sample_rate,
                block_frames=ecfg.block_frames,
            )
            s.apply_settings_async(cfg)
            log.info("settings change detected (%s): recompiling", path)
        except (ValueError, RuntimeError) as exc:
            log.warning("settings change rejected: %s", exc)

    server.on_drain = on_drain
    return on_drain


def ingest_benchmark(
    n_streams: int, duration_s: float = 3.0, block_frames: int = 256,
    channels: int = 2, sample_rate: float = 48_000.0, feeder_threads: int = 4,
    assembler_shards: int = 1, realtime: bool = False,
) -> dict:
    """Host-only ingest throughput: native feeders push flat out (with
    backpressure) while the assembler drains — measures the C++ path's
    sustainable streams without any device work."""
    from openmeters_tpu.ingest import Feeder

    tp = Transport(
        n_streams=n_streams, channels=channels, block_frames=block_frames,
        sample_rate=sample_rate, ring_seconds=4.0 / 3.0,
    )
    ring_frames = int(4.0 / 3.0 * sample_rate)
    feeder = Feeder(
        tp, realtime=realtime, n_threads=feeder_threads,
        max_buffered_frames=0 if realtime else ring_frames // 2,
    )
    pool = ThreadPoolExecutor(assembler_shards) if assembler_shards > 1 else None
    bufs = tp.make_buffers()
    t0 = time.perf_counter()
    hops = 0
    frames_out = 0
    live_total = 0
    while time.perf_counter() - t0 < duration_s:
        _, _, _, live = tp.assemble(pool=pool, shards=assembler_shards, out=bufs)
        hops += 1
        live_total += live
        frames_out += block_frames * live
    wall = time.perf_counter() - t0
    ok, failed = feeder.stop()
    if pool:
        pool.shutdown()
    audio_s = frames_out / sample_rate
    return {
        "streams": n_streams,
        "hops": hops,
        "pushes_ok": ok,
        "pushes_failed": failed,
        "push_rate_per_s": int(ok / wall),
        "assembled_audio_seconds": round(audio_s, 2),
        "ingest_realtime_streams": int(audio_s / wall),
        "wall_seconds": round(wall, 3),
        "faults": sum(tp.fault_count(s) for s in range(min(n_streams, 64))),
    }
