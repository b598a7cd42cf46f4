"""Capture and summarize a device trace of one engine configuration.

Usage:
    python tools/profile_step.py headline [S] [iters] [trace_dir]
    python tools/profile_step.py reassigned64 4096
    python tools/profile_step.py osc 1024

Runs the bench-style K-step scan (full-leaf probes), captures a
``jax.profiler`` trace around the timed dispatch into ``trace_dir``
(default ``chiprun_out/trace``), and prints per-op aggregate device time
via ``jax.profiler.ProfileData``.  GPU only.
"""

from __future__ import annotations

import collections
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build(name: str):
    from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.analyzers.spectrum import SpectrumConfig
    from openmeters_tpu.analyzers.stereometer import StereometerConfig
    from openmeters_tpu.analyzers.waveform import WaveformConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    spec = SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False)
    cfgs = {
        "headline": EngineConfig(channels=2, spectrogram=spec, spectrum=None, oscilloscope=None, stereometer=None, waveform=None),
        "loudness": EngineConfig(channels=2, spectrogram=None, spectrum=None, oscilloscope=None, stereometer=None, waveform=None),
        "spectro": EngineConfig(channels=2, loudness=None, spectrogram=spec, spectrum=None, oscilloscope=None, stereometer=None, waveform=None),
        "reassigned64": EngineConfig(
            channels=2, loudness=None, spectrum=None,
            spectrogram=SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=True),
            oscilloscope=None, stereometer=None, waveform=None,
        ),
        "reassigned512": EngineConfig(
            channels=2, loudness=None, spectrum=None,
            spectrogram=SpectrogramConfig(fft_size=2048, hop_size=512, use_reassignment=True),
            oscilloscope=None, stereometer=None, waveform=None,
        ),
        "spectrum": EngineConfig(
            channels=2, loudness=None, spectrogram=None, spectrum=SpectrumConfig(),
            oscilloscope=None, stereometer=None, waveform=None,
        ),
        "osc": EngineConfig(
            channels=2, loudness=None, spectrogram=None, spectrum=None,
            oscilloscope=OscilloscopeConfig(trigger_every=1),
            stereometer=None, waveform=None,
        ),
        "config5": EngineConfig(
            channels=2, loudness=None, spectrogram=None, spectrum=None,
            oscilloscope=OscilloscopeConfig(trigger_every=3),
            stereometer=StereometerConfig(analyze_bands=True),
            waveform=WaveformConfig(analyze_bands=True, track_history=True),
        ),
        "config5e1": EngineConfig(
            channels=2, loudness=None, spectrogram=None, spectrum=None,
            oscilloscope=OscilloscopeConfig(trigger_every=1),
            stereometer=StereometerConfig(analyze_bands=True),
            waveform=WaveformConfig(analyze_bands=True, track_history=True),
        ),
        # the literal reference default: all six analyzers, reassignment ON,
        # 16384-pt spectrum, per-hop trigger (registry.rs:37-240)
        "default": EngineConfig(channels=2),
    }
    return MeterEngine(cfgs[name])


def main(argv=None):
    import jax
    import jax.numpy as jnp

    from openmeters_tpu.engine import StreamMeta
    from openmeters_tpu.runtime_env import card_line, require_gpu, setup_compile_cache

    setup_compile_cache()
    print(require_gpu(), card_line())
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if len(argv) > 0 else "headline"
    n_streams = int(argv[1]) if len(argv) > 1 else 4096
    iters = int(argv[2]) if len(argv) > 2 else 24
    tdir = argv[3] if len(argv) > 3 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "trace",
    )

    engine = build(name)
    cfg = engine.config
    b = cfg.block_frames
    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal((8, n_streams, b, cfg.channels)) * 0.25).astype(
        np.float32
    )
    meta = StreamMeta.default(n_streams, channels=2, pad_channels=cfg.channels)
    reset = np.zeros((n_streams,), bool)

    def consume(snaps):
        probe = jnp.float32(0)
        for leaf in jax.tree.leaves(snaps):
            probe += jnp.sum(leaf.astype(jnp.float32))
        return probe

    osc_ext = (
        "oscilloscope" in engine.analyzers
        and engine.analyzers["oscilloscope"].external_capture
    )

    def consume_capture(c, i):
        # display-cadence capture extraction, scalar cond (see bench.py)
        if not osc_ext:
            return jnp.float32(0)
        return jax.lax.cond(
            i % 3 == 0,
            lambda: consume(engine.extract_oscilloscope(c)),
            lambda: jnp.float32(0),
        )

    r = engine.spectrum_cadence
    if r > 1:
        # two sibling scans, matching bench.py::measure and the serving
        # loop's dispatch structure (see bench.py for the structure-tax
        # measurements that ruled out nesting/unrolling)
        assert iters % r == 0, (iters, r)
        assert 8 % r == 0, (
            f"spectrum cadence {r} must divide the 8-block host window; "
            f"pick a hop that is a power-of-two multiple of the block"
        )

        @jax.jit
        def run_k(carry, blocks_in):
            def body(c, i):
                c, snaps = engine.step(c, blocks_in[i], meta, reset)
                return c, consume(snaps) + consume_capture(c, i)

            idx = jnp.arange(iters, dtype=jnp.int32) % 8
            carry, probes = jax.lax.scan(body, carry, idx)
            groups = blocks_in.reshape(8 // r, r, n_streams, b, cfg.channels)

            def sp_body(c, i):
                c, snap = engine.spectrum_step(c, groups[i], meta, reset)
                return c, consume(snap)

            sp_idx = jnp.arange(iters // r, dtype=jnp.int32) % (8 // r)
            sp, sp_probes = jax.lax.scan(sp_body, carry["spectrum"], sp_idx)
            return dict(carry, spectrum=sp), probes.sum() + sp_probes.sum()
    else:

        @jax.jit
        def run_k(carry, blocks_in):
            def body(c, i):
                c, snaps = engine.step(c, blocks_in[i], meta, reset)
                return c, consume(snaps) + consume_capture(c, i)

            idx = jnp.arange(iters, dtype=jnp.int32) % 8
            return jax.lax.scan(body, carry, idx)

    blocks_dev = jax.device_put(blocks)
    carry = engine.init(n_streams)
    # compile + warm the carry to steady state (ready-gated consumers like
    # the 16384-pt spectrum only start computing once their window fills —
    # timing from a fresh carry would profile the warmup transient)
    warm, probes = run_k(carry, blocks_dev)
    jax.block_until_ready(probes)
    for _ in range(max(64 // iters, 1)):
        warm, probes = run_k(warm, blocks_dev)
        jax.block_until_ready(probes)

    t0 = time.perf_counter()
    c2, probes = run_k(warm, blocks_dev)
    jax.block_until_ready(probes)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name} S={n_streams}: {dt * 1e3:.2f} ms/step")

    with jax.profiler.trace(tdir):
        c3, probes = run_k(warm, blocks_dev)
        jax.block_until_ready(probes)

    paths = glob.glob(f"{tdir}/**/*.xplane.pb", recursive=True)
    if not paths:
        print("no xplane captured", file=sys.stderr)
        return
    pd = jax.profiler.ProfileData.from_serialized_xspace(
        open(sorted(paths)[-1], "rb").read()
    )
    agg = collections.Counter()
    total = 0.0
    for plane in pd.planes:
        if "GPU" not in plane.name and "Device" not in plane.name:
            continue
        for line in plane.lines:
            if line.name not in ("XLA Ops", "XLA TraceMe", "Steps") and not line.name.startswith("XLA Ops"):
                # keep only the op-level line when present; fall back to all
                pass
            for ev in line.events:
                dur = ev.duration_ns
                nm = ev.name
                agg[(line.name, nm)] += dur
                total += dur
    by_line = collections.Counter()
    for (ln, nm), d in agg.items():
        by_line[ln] += d
    if not by_line:
        print("no device events")
        return
    for ln, d in by_line.most_common():
        print(f"== line '{ln}': {d / 1e6:.2f} ms total, {d / iters / 1e6:.2f} ms/step")
    want = [ln for ln in by_line if ln == "XLA Ops"] or [max(by_line, key=by_line.get)]
    for busiest in want:
        ops = collections.Counter()
        for (ln, nm), d in agg.items():
            if ln == busiest:
                ops[nm] += d
        # bucket by op category, excluding the outer measurement-scan while
        # envelope (its duration IS the step; children are counted separately)
        envelope = max(
            (d for nm, d in ops.items() if nm.lstrip("%").startswith("while")),
            default=0,
        )
        cats = collections.Counter()
        for nm, d in ops.items():
            base = nm.lstrip("%").split(" = ")[0].rstrip("0123456789.")
            if nm.lstrip("%").startswith("while") and d == envelope:
                base = "(scan envelope)"
            elif any(
                k in base
                for k in ("copy", "reshape", "pad", "transpose", "bitcast", "rev")
            ):
                base = "layout (copy/pad/reshape/rev)"
            elif "custom-call" in nm or "triton" in base:
                base = "custom-call (kernel)"
            elif base.startswith(("conditional", "cond")):
                base = "conditional"
            elif "fusion" in base:
                base = "fusion"
            cats[base] += d
        print(f"-- categories in '{busiest}' (ms/step)")
        for nm, d in cats.most_common(20):
            print(f"{d / iters / 1e6:9.3f}  {nm}")
        print(f"-- top ops in '{busiest}' (us/step)")
        for nm, d in ops.most_common(60):
            print(f"{d / iters / 1e3:9.1f}  {nm[:130]}")


if __name__ == "__main__":
    main()
