"""openmeters_tpu — a batched streaming audio-analysis framework on GPUs.

A ground-up JAX/XLA rebuild of the analysis core of OpenMeters (v1.12.1,
Rust).  Where the reference analyzes one desktop audio stream on a CPU, this
framework analyzes a *batch* of thousands of concurrent streams on one or
more GPUs: every analyzer is a pure function ``(carry, block) -> (carry,
snapshot)`` over ``[n_streams, ...]`` arrays, the engine scans it over hops,
and streams shard data-parallel over a device mesh.

Subsystem map (reference parity noted per module):

- ``utils``      — windows, dB/power, A/K-weighting, channel layouts
                   (reference ``src/util/audio/*``, ``src/dsp.rs``)
- ``ops``        — batched DSP primitives: biquad scans, windowed means,
                   polyphase FIR true peak, STFT/reassignment, NSDF
- ``analyzers``  — loudness, spectrogram, spectrum, oscilloscope,
                   stereometer, waveform (reference ``src/visuals/*/processor.rs``)
- ``engine``     — hop scheduler, stream carries, shard_map scale-out
                   (reference ``src/meter.rs``, ``src/visuals/registry.rs``)
- ``ingest``     — host-side transport: span timeline, batcher, ring buffers
                   (reference ``src/infra/pipewire/transport.rs``)
"""

__version__ = "0.1.0"

# Lazy re-exports (PEP 562): importing the package must not pull in JAX —
# host-side processes (ingest producers, the session runtime, CLI --help)
# only need numpy + sockets and start ~2.5 s faster without it.
_EXPORTS = {
    "DB_FLOOR": ("openmeters_tpu.utils.level", "DB_FLOOR"),
    "db_to_power": ("openmeters_tpu.utils.level", "db_to_power"),
    "power_to_db": ("openmeters_tpu.utils.level", "power_to_db"),
    "WindowKind": ("openmeters_tpu.utils.windows", "WindowKind"),
    "Channel": ("openmeters_tpu.utils.channels", "Channel"),
    "ChannelPosition": ("openmeters_tpu.utils.channels", "ChannelPosition"),
}


def __getattr__(name):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'openmeters_tpu' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), attr)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
