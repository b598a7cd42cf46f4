"""Headline benchmark: concurrent realtime 48 kHz stereo streams per card.

BASELINE config 1: 2048-pt Hann classic STFT spectrogram (hop 64) + the full
BS.1770 loudness suite (short-term/momentary LUFS, RMS fast/slow, 4x true
peak), one fused jitted step per 256-frame hop, batched over streams.

A stream is "realtime" when the engine keeps up with its sample rate: with
block B at rate R, wall time per step must stay under B/R (5.33 ms).  We
measure steady-state step time at increasing batch sizes and report the
largest S whose measured throughput sustains realtime, i.e.
``streams_realtime = S * (B/R) / step_seconds`` at the best S.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card"} where vs_baseline is the ratio against the 10,000-streams north
star (BASELINE.md) — the reference itself publishes no throughput numbers.
Runs on a GPU only; every line names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

NORTH_STAR_STREAMS = 10_000.0
CARD = ""  # nvidia-smi's "name, power limit", set by main()


def build_engine():
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    cfg = EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False),
        spectrum=None,
        channels=2,
        oscilloscope=None, stereometer=None, waveform=None,
    )
    return MeterEngine(cfg)


def measure(engine, n_streams: int, iters: int = 128) -> dict:
    """Sustained per-step device time via a K-step on-device scan.

    One dispatch runs ``iters`` chained engine steps (distinct audio blocks)
    and the result is fetched, so the measurement is device throughput —
    what a pipelined production host achieves; ``iters`` amortizes the
    per-dispatch fixed cost.
    """
    import jax
    import jax.numpy as jnp

    from openmeters_tpu.engine import StreamMeta

    cfg = engine.config
    b = cfg.block_frames
    rng = np.random.default_rng(0)
    n_blocks = 8
    blocks = (rng.standard_normal((n_blocks, n_streams, b, cfg.channels)) * 0.25).astype(
        np.float32
    )
    meta = StreamMeta.default(n_streams, channels=2, pad_channels=cfg.channels)
    reset = np.zeros((n_streams,), bool)

    def consume(snaps):
        # consume EVERY snapshot leaf (full reductions) so XLA cannot
        # dead-code-eliminate or narrow any analyzer's output computation
        probe = jnp.float32(0)
        for leaf in jax.tree.leaves(snaps):
            if jnp.issubdtype(leaf.dtype, jnp.floating):
                probe += jnp.sum(leaf)
            else:
                probe += jnp.sum(leaf.astype(jnp.int32)).astype(jnp.float32)
        return probe

    osc_ext = (
        "oscilloscope" in engine.analyzers
        and engine.analyzers["oscilloscope"].external_capture
    )

    def consume_capture(c, i):
        """Display-cadence oscilloscope capture extraction (the engine runs
        external-capture mode; the reference UI reads traces at ~60 Hz =
        every 3 hops).  Scalar cond output: the identity branch copies one
        float, not the trace arrays."""
        if not osc_ext:
            return jnp.float32(0)
        return jax.lax.cond(
            i % 3 == 0,
            lambda: consume(engine.extract_oscilloscope(c)),
            lambda: jnp.float32(0),
        )

    r = engine.spectrum_cadence
    if r > 1:
        # cadenced spectrum: TWO sibling scans — the fast analyzers per
        # engine hop, the spectrum at its own hop over the same blocks —
        # exactly the serving loop's dispatch structure (the two state
        # machines share only the input audio).  Nesting them (a
        # super-period scan with an inner fast scan) measured ~0.5 ms/hop
        # of pure structure tax at S=1024; fully unrolling the inner scan
        # was worse still (inter-body carry copies).
        assert iters % r == 0 and n_blocks % r == 0, (iters, n_blocks, r)

        @jax.jit
        def run_k(carry, blocks_in):
            def body(c, i):
                c, snaps = engine.step(c, blocks_in[i], meta, reset)
                return c, consume(snaps) + consume_capture(c, i)

            idx = jnp.arange(iters, dtype=jnp.int32) % n_blocks
            carry, probes = jax.lax.scan(body, carry, idx)

            groups = blocks_in.reshape(
                n_blocks // r, r, n_streams, b, cfg.channels
            )

            def sp_body(c, i):
                c, snap = engine.spectrum_step(c, groups[i], meta, reset)
                return c, consume(snap)

            sp_idx = jnp.arange(iters // r, dtype=jnp.int32) % (n_blocks // r)
            sp, sp_probes = jax.lax.scan(
                sp_body, carry["spectrum"], sp_idx
            )
            return dict(carry, spectrum=sp), probes.sum() + sp_probes.sum()
    else:

        @jax.jit
        def run_k(carry, blocks_in):
            def body(c, i):
                c, snaps = engine.step(c, blocks_in[i], meta, reset)
                return c, consume(snaps) + consume_capture(c, i)

            idx = jnp.arange(iters, dtype=jnp.int32) % n_blocks
            return jax.lax.scan(body, carry, idx)

    blocks_dev = jax.device_put(blocks)
    carry = engine.init(n_streams)
    # compile + WARMUP: the timed runs start from the warmed carry so they
    # measure steady state, not the fill-in transient.  This matters: a
    # fresh carry's analysis windows are empty, and ready-gated consumers
    # (the 16384-pt spectrum needs 64 hops of history before its first
    # column) would otherwise never execute their compute inside the timed
    # window — a warmup-state number would overstate realtime capacity.
    warm, probes = run_k(carry, blocks_dev)
    jax.block_until_ready(probes)
    warm, probes = run_k(warm, blocks_dev)  # 2*iters hops of history
    jax.block_until_ready(probes)

    # best-of-3 from the same warmed carry: one timed dispatch is
    # ~iters*step_ms; repeating guards against one-off host scheduling noise
    dt = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        c2, probes = run_k(warm, blocks_dev)
        jax.block_until_ready(probes)
        dt = min(dt, (time.perf_counter() - t0) / iters)

    audio_seconds = n_streams * b / cfg.sample_rate
    return {
        "n_streams": n_streams,
        "step_ms": dt * 1e3,
        "hop_ms": b / cfg.sample_rate * 1e3,
        "streams_realtime": audio_seconds / dt,
        "realtime": dt <= b / cfg.sample_rate,
    }


def build_full_engine(n_streams_hint: int = 1024):
    """Config-5 style: all six analyzers on one batched graph."""
    from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.analyzers.spectrum import SpectrumConfig
    from openmeters_tpu.analyzers.stereometer import StereometerConfig
    from openmeters_tpu.analyzers.waveform import WaveformConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    cfg = EngineConfig(
        channels=2,
        spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False),
        spectrum=SpectrumConfig(),
        oscilloscope=OscilloscopeConfig(trigger_every=3),
        stereometer=StereometerConfig(analyze_bands=True),
        waveform=WaveformConfig(analyze_bands=True),
    )
    return MeterEngine(cfg)


def build_config5_engine(trigger_every: int = 3):
    """BASELINE configs[4]: oscilloscope stable trigger + stereometer
    Lissajous/band correlation + waveform band history, one batched graph.
    ``trigger_every=1`` re-evaluates the trigger on every ingest hop (the
    reference's per-processed-block behavior); 3 is display-rate cadence."""
    from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig
    from openmeters_tpu.analyzers.stereometer import StereometerConfig
    from openmeters_tpu.analyzers.waveform import WaveformConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    return MeterEngine(
        EngineConfig(
            channels=2,
            loudness=None,
            spectrogram=None,
            spectrum=None,
            oscilloscope=OscilloscopeConfig(trigger_every=trigger_every),
            stereometer=StereometerConfig(analyze_bands=True),
            waveform=WaveformConfig(analyze_bands=True, track_history=True),
        )
    )


def build_default_engine():
    """The literal ``EngineConfig()`` reference default at stereo transport
    width: ALL SIX analyzers, spectrogram reassignment ON
    (processor.rs:45-56), the 16384/1024 spectrum, and the per-hop trigger
    cadence — exactly what the reference registry instantiates by default
    (registry.rs:37-240)."""
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    return MeterEngine(EngineConfig(channels=2))


def measure_latency(engine, n_streams: int, n_dispatch: int = 100) -> dict:
    """Single-dispatch hop→meters latency: H2D of one ``[S, B, C]`` block +
    one engine step + the packed-meter fetch (serve.py's ``_make_packer``
    path — ONE device→host transfer), timed per dispatch.  This is the
    serving loop's per-hop critical path (meter.rs:82-143 cadence); the
    north star asks p50 < 10 ms.  Host clock, one dispatch at a time."""
    import jax

    from openmeters_tpu.engine import StreamMeta
    from openmeters_tpu.serve import _make_packer, _meter_leaf_mask

    cfg = engine.config
    b = cfg.block_frames
    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal((4, n_streams, b, cfg.channels)) * 0.25).astype(
        np.float32
    )
    meta = StreamMeta.default(n_streams, channels=2, pad_channels=cfg.channels)
    reset = jax.device_put(np.zeros((n_streams,), bool))

    step = jax.jit(
        lambda c, x, m, r: engine.step(c, x, m, r), donate_argnums=0
    )
    carry = engine.init(n_streams)
    carry, snaps = step(carry, jax.device_put(blocks[0]), meta, reset)
    pick, pack = _make_packer(_meter_leaf_mask(snaps, n_streams))
    np.asarray(pack(pick(snaps)))  # compile
    carry, snaps = step(carry, jax.device_put(blocks[1]), meta, reset)
    np.asarray(pack(pick(snaps)))  # donated-layout recompile

    lat = np.empty((n_dispatch,), np.float64)
    for i in range(n_dispatch):
        t0 = time.perf_counter()
        dev = jax.device_put(blocks[i % 4])
        carry, snaps = step(carry, dev, meta, reset)
        np.asarray(pack(pick(snaps)))
        lat[i] = (time.perf_counter() - t0) * 1e3
    return {
        "n_streams": n_streams,
        "p50": float(np.percentile(lat, 50)),
        "p95": float(np.percentile(lat, 95)),
        "max": float(lat.max()),
    }


def build_reassigned_engine(zero_padding_factor: int = 1):
    """The reference's DEFAULT spectrogram config: reassignment on, 2048/64
    (processor.rs:58-59) — the sliding-analytic path."""
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    return MeterEngine(
        EngineConfig(
            channels=2,
            loudness=None,
            spectrogram=SpectrogramConfig(
                fft_size=2048, hop_size=64, use_reassignment=True,
                zero_padding_factor=zero_padding_factor,
            ),
            spectrum=None,
            oscilloscope=None, stereometer=None, waveform=None,
        )
    )


def _report(tag: str, r: dict) -> None:
    print(
        f"# {tag} S={r['n_streams']}: {r['step_ms']:.4f} ms/step, "
        f"{r['streams_realtime']:.0f} streams realtime"
        f" ({'REALTIME' if r['realtime'] else 'below realtime'}) [{CARD}]",
        file=sys.stderr,
    )


def main():
    global CARD
    from openmeters_tpu.runtime_env import card_line, require_gpu, setup_compile_cache

    setup_compile_cache()
    device = require_gpu()
    CARD = card_line()
    # The headline sweep runs FIRST so the JSON line is on stdout even if a
    # time budget truncates the run; the remaining BASELINE configs
    # (reference-default reassigned spectrogram, all-six, config 5 at both
    # trigger cadences) print after it on stderr.
    engine = build_engine()
    best = None
    for n in (8192, 16384, 20480):
        try:
            r = measure(engine, n)
        except Exception as e:  # OOM etc.
            print(f"# S={n}: {type(e).__name__}: {e}", file=sys.stderr)
            break
        _report("headline", r)
        if best is None or r["streams_realtime"] > best["streams_realtime"]:
            best = r
        # stop scaling once step time far exceeds the realtime budget
        if r["step_ms"] > 4 * r["hop_ms"]:
            break

    if best is None:
        print(
            json.dumps(
                {
                    "metric": "concurrent realtime 48kHz stereo streams/card",
                    "value": 0,
                    "unit": "streams",
                    "vs_baseline": 0.0,
                    "device": device,
                    "card": CARD,
                }
            )
        )
        return

    value = round(best["streams_realtime"])
    print(
        json.dumps(
            {
                "metric": "concurrent realtime 48kHz stereo streams/card "
                "(2048-pt Hann spectrogram + BS.1770 loudness)",
                "value": value,
                "unit": "streams",
                "vs_baseline": round(value / NORTH_STAR_STREAMS, 3),
                "device": device,
                "card": CARD,
            }
        ),
        flush=True,
    )

    if os.environ.get("OPENMETERS_BENCH_HEADLINE_ONLY"):
        return
    # single-dispatch hop->meters latency (north star: <10 ms p50)
    lat = measure_latency(build_engine(), 4096)
    print(
        f"# latency S={lat['n_streams']}: p50 {lat['p50']:.3f} ms, "
        f"p95 {lat['p95']:.3f} ms, max {lat['max']:.3f} ms hop->meters "
        f"(H2D + step + packed-meter fetch, one dispatch at a time) [{CARD}]",
        file=sys.stderr,
    )
    # ordered by artifact importance in case a driver time budget truncates
    eng5e1 = build_config5_engine(trigger_every=1)
    r = measure(eng5e1, 1024)
    _report("config5 trigger_every=1 (per-hop trigger)", r)
    eng_r = build_reassigned_engine()
    for n in (4096, 6144, 8192):
        r = measure(eng_r, n)
        _report("reassigned-2048/64", r)
        if not r["realtime"]:
            break
    # zero-padded reassignment (stock reference setting,
    # processor.rs:45-56) on the padded-stencil sliding path
    eng_z = build_reassigned_engine(zero_padding_factor=2)
    for n in (2048, 4096):
        r = measure(eng_z, n)
        _report("reassigned-2048/64 zpf2", r)
        if not r["realtime"]:
            break
    # the literal EngineConfig() reference default (all six, reassignment ON,
    # 16384-pt spectrum, per-hop trigger)
    eng_d = build_default_engine()
    r = measure(eng_d, 1024, iters=512)
    _report("default EngineConfig() (all six, reassigned, 16384-pt spectrum)", r)
    eng = build_full_engine()
    r = measure(eng, 1024)
    _report("all-six", r)
    eng5 = build_config5_engine()
    r = measure(eng5, 1024)
    _report("config5 (osc+stereo+waveform)", r)


if __name__ == "__main__":
    main()
