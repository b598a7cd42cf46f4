"""Smoke test of the serving path on one GPU (or, with ``--cards 4``, four).

Run from the repository root on a machine with a GPU:

    python chip_smoke.py             # one card
    python chip_smoke.py --cards 4   # the sharded serve config on four cards

One card, one process.  Phases, each timed and reported:

- ``serve``: ``MeterServer`` with the native transport in the CLI's
  ``serve --config serve`` configuration (the 2048/64 Hann classic
  spectrogram, the BS.1770 loudness suite, oscilloscope, stereometer and
  waveform; no spectrum), stereo 48 kHz, 16384 streams.  Seeded PCM
  (3.84 s per stream, so the 3 s short-term window wraps) goes in through
  ``Transport.push_pcm``; the server assembles, steps and drains meters
  (``fetch="meters"``).  Loudness meters are checked against the f64
  references in ``tests/`` and the sliding spectrogram state against an
  f64 numpy FFT of the same frames.
- ``default``: the same with the stock ``EngineConfig()`` (all six
  analyzers, reassignment on, 16384-pt spectrum, per-hop trigger) at 1024
  streams, long enough for the ready-gated spectrum to emit; the trigger
  jitter on the sine streams is checked.
- ``kernel``: the fused sliding hop as compiled for the card and the XLA
  slide at 16384 streams, both against f64 reference codes at every bin:
  the kernel may be off by at most one code step more than the XLA slide.
- ``gpu-tests``: the ``gpu``-marked tests, called in-process.

``--cards 4`` runs only the serve config through ``sharded_step`` over a
4-card mesh at 4 x 16384 streams, the same streams stepped on one card
(one 16384-stream slice at a time), a leaf-by-leaf comparison, and a
check that the compiled step holds no collectives.

Every parity line prints the measured error beside its limit.  The last
line of standard output is ``{"ok": true, "device": {...}}``; the script
exits non-zero, and prints no such line, when JAX finds no GPU or any
phase fails.  ``--rehearse`` runs the same phases on the CPU at a tiny
size (kernels in interpret mode) and always exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

RATE = 48_000.0
BLOCK = 256
N_SIGNALS = 32  # distinct seeded signals; stream i plays signal i % N_SIGNALS
N_CHECKED = 8  # streams compared against the f64 references per phase
HOPS = 720  # 3.84 s per stream: the 3 s short-term window wraps, and the
# integrated gate sees several 400 ms blocks
CHUNK = 48  # hops pushed per stream at a time (the backlog cap is 1 s)
FFT_LIMIT_DB = -100.0
LU_LIMIT = 0.01
JITTER_LIMIT = 3.0


def signal_bank(frames: int, seed: int) -> np.ndarray:
    """``[N_SIGNALS, frames, 2]`` f32: even rows are pure sines (trigger
    material), odd rows two tones plus noise, with a stereo offset."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / RATE
    out = np.empty((N_SIGNALS, frames, 2), np.float32)
    for i in range(N_SIGNALS):
        if i % 2 == 0:
            f = rng.uniform(110.0, 880.0)
            mono = 0.5 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
            out[i] = np.stack([mono, mono], -1)
        else:
            f1, f2 = rng.uniform(40.0, 16_000.0, 2)
            base = 0.4 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t)
            for c in range(2):
                out[i, :, c] = base + 0.02 * rng.standard_normal(frames) * (c + 1)
    return out


def stream_pcm(bank, gains, i: int) -> np.ndarray:
    return bank[i % N_SIGNALS] * gains[i]


def checked_streams(n_streams: int) -> list[int]:
    """Streams compared against the references: both signal kinds, spread
    over the batch (first, last, and across stream tiles)."""
    picks = {0, 1, n_streams - 1, n_streams - 2}
    picks |= {int(x) for x in np.linspace(0, n_streams - 1, N_CHECKED - 4)}
    return sorted(picks)[:N_CHECKED]


def report(name: str, err: float, limit: float, unit: str, precision: str):
    ok = err <= limit
    print(
        f"parity {name}: {err:.6g} {unit} (limit {limit:g} {unit}, "
        f"{precision}) {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError(f"{name}: {err} {unit} over the limit {limit}")


# -- references ----------------------------------------------------------------


def loudness_reference(x: np.ndarray) -> dict:
    """f64 momentary/short-term/integrated LUFS and last-block true peak
    (dBTP per channel) of ``[n, 2]`` audio, from ``tests/ebur_ref.py`` and
    the polyphase taps of ``tests/golden.py``."""
    import scipy.signal

    import ebur_ref
    import golden

    kx = ebur_ref.k_weight(x)
    sq = np.sum(kx * kx, axis=1)  # stereo weights 1, 1

    def trailing(seconds):
        # mean over the window, or over all samples while it is filling
        tail = sq[-int(RATE * seconds):]
        return ebur_ref.OFFSET + 10 * np.log10(np.mean(tail))

    taps = golden.polyphase_taps(4)
    peaks = []
    for c in range(2):
        xc = x[:, c].astype(np.float32).astype(np.float64)
        p = np.max(np.abs(xc[-BLOCK:]))
        for ph in range(taps.shape[1]):
            y = scipy.signal.lfilter(taps[:, ph].astype(np.float64), [1.0], xc)
            p = max(p, np.max(np.abs(y[-BLOCK:])))
        peaks.append(20 * np.log10(p))
    return {
        "momentary_lufs": trailing(0.4),
        "short_term_lufs": trailing(3.0),
        "integrated_lufs": ebur_ref.integrated_lufs(x),
        "true_peak_db": np.asarray(peaks),
    }


def windowed_reference(frame: np.ndarray) -> np.ndarray:
    """f64 DC-removed Hann-windowed one-sided spectrum of one frame."""
    from openmeters_tpu.utils.windows import WindowKind, window_coefficients

    n = frame.size
    w = np.asarray(window_coefficients(WindowKind.HANN, n), np.float64)
    f = frame.astype(np.float64)
    return np.fft.rfft((f - f.mean()) * w)


def windowed_from_state(re: np.ndarray, im: np.ndarray, n: int) -> np.ndarray:
    """The engine's frequency-domain Hann window + DC removal applied in f64
    to the f32 sliding state (the stencil is exact linear algebra)."""
    f = re.astype(np.float64) + 1j * im.astype(np.float64)
    ext = np.concatenate([np.conj(f[1:2]), f, np.conj(f[-2:-1])])
    w = 0.5 * f - 0.25 * (ext[:-2] + ext[2:])
    mean = f[0].real / n
    w[0] -= mean * 0.5 * n
    w[1] -= mean * -0.25 * n
    return w


def amplitude_error_db(ours: np.ndarray, ref: np.ndarray) -> float:
    """The spectral-parity metric of ``tests/test_fft.py``: max amplitude
    difference over the peak amplitude, in dB."""
    err = np.max(np.abs(ours - ref)) / np.max(np.abs(ref))
    return float(20 * np.log10(max(err, 1e-30)))


# -- phases --------------------------------------------------------------------


def serve_config(name: str):
    from openmeters_tpu.__main__ import _serving_engine_config

    return _serving_engine_config(argparse.Namespace(config=name, settings=None))


def run_server(config_name: str, n_streams: int, hops: int, seed: int,
               track: tuple = ()):
    """Push ``hops`` blocks of seeded PCM per stream, ``CHUNK`` hops at a
    time (inside the transport's backlog cap), serving until each chunk is
    consumed.  Returns ``(server, pcm_of, last, tracked)``: ``last`` is the
    final drained meters, ``tracked`` lists ``(hops, {key: value})`` of the
    meter keys ``track`` at every drained fetch."""
    from openmeters_tpu.serve import MeterServer, ServeConfig

    bank = signal_bank(hops * BLOCK, seed)
    gains = np.random.default_rng(seed + 1).uniform(0.3, 1.0, n_streams)
    gains = gains.astype(np.float32)
    server = MeterServer(
        ServeConfig(
            n_streams=n_streams, channels=2, engine=serve_config(config_name),
            realtime=False, fetch="meters",
        )
    )
    last, tracked = {}, []

    def on_drain(s):
        meters = s.last_meters()
        last.clear()
        last.update({k: np.array(v) for k, v in meters.items()})
        tracked.append((s.stats.hops, {k: np.array(meters[k]) for k in track}))

    server.on_drain = on_drain
    for lo in range(0, hops, CHUNK):
        hi = min(lo + CHUNK, hops)
        stamp = round(lo * BLOCK * 1e9 / RATE)  # one continuous timeline
        for i in range(n_streams):
            pcm = bank[i % N_SIGNALS, lo * BLOCK:hi * BLOCK] * gains[i]
            server.transport.push_pcm(i, pcm, stamp)
        while server.stats.hops < hi:
            server.advance()
    server.close()
    assert server.stats.hops == hops, server.stats.hops
    assert server.stats.underruns == 0, server.stats.underruns
    assert tracked and tracked[-1][0] == hops, "no drain at the last hop"
    return server, (lambda i: stream_pcm(bank, gains, i)), last, tracked


def served(server) -> dict:
    rep = server.report()
    return {k: rep[k] for k in ("streams", "hops", "resets", "underruns",
                                "latency_ms_p50", "latency_ms_p95")}


def meter(meters: dict, analyzer: str, field: str) -> np.ndarray:
    key = f"['{analyzer}'].{field}"
    assert key in meters, sorted(meters)
    return np.asarray(meters[key])


def check_meters_finite(meters: dict, n_streams: int):
    assert meters, "no meters drained"
    for key, v in meters.items():
        assert v.shape[0] == n_streams, (key, v.shape)
        assert np.all(np.isfinite(v)), key


def check_loudness(meters: dict, pcm_of, n_streams: int, tag: str):
    errs = {"momentary_lufs": 0.0, "short_term_lufs": 0.0,
            "integrated_lufs": 0.0, "true_peak_db": 0.0}
    for i in checked_streams(n_streams):
        ref = loudness_reference(pcm_of(i))
        for k in errs:
            got = meter(meters, "loudness", k)[i]
            errs[k] = max(errs[k], float(np.max(np.abs(got - ref[k]))))
    for k, e in errs.items():
        unit = "dB" if k == "true_peak_db" else "LU"
        report(f"{tag}.loudness.{k}", e, LU_LIMIT, unit, "f32, HIGHEST dots")


def phase_serve(n_streams: int, hops: int):
    server, pcm_of, meters, _ = run_server("serve", n_streams, hops, seed=11)
    check_meters_finite(meters, n_streams)
    check_loudness(meters, pcm_of, n_streams, "serve")

    # sliding spectrogram state == DFT of the newest window: after T
    # samples the last ready 2048-sample window is [T - 2048, T)
    sdft = server.carry["spectrogram"]["sdft"]
    rows = checked_streams(n_streams)
    re = np.asarray(sdft["re"])[rows]
    im = np.asarray(sdft["im"])[rows]
    n = server.engine.config.spectrogram.fft_size
    worst = -np.inf
    for r, i in enumerate(rows):
        frame = pcm_of(i)[-n:].astype(np.float64).mean(axis=1)
        worst = max(worst, amplitude_error_db(
            windowed_from_state(re[r], im[r], n), windowed_reference(frame)
        ))
    path = "fused kernel" if server.engine.analyzers[
        "spectrogram"].use_sliding_kernel else "XLA slide"
    report("serve.spectrogram.state_vs_f64", worst, FFT_LIMIT_DB, "dB",
           f"{path}, HIGHEST re-anchor FFT")
    return served(server)


OSC_KEYS = tuple(f"['oscilloscope'].{f}" for f in ("locked", "start", "frac"))


def phase_default(n_streams: int, hops: int):
    server, pcm_of, meters, drained = run_server(
        "default", n_streams, hops, seed=23, track=OSC_KEYS
    )
    check_meters_finite(meters, n_streams)
    check_loudness(meters, pcm_of, n_streams, "default")
    updated = meter(meters, "spectrum", "updated")
    assert updated.all(), "the 16384-pt spectrum did not emit"

    osc = server.engine.analyzers["oscilloscope"]
    hist = osc.history_frames
    sine_streams = [i for i in checked_streams(n_streams) if i % 2 == 0]
    jitter = 0.0
    for i in sine_streams:
        bank_row = pcm_of(i)[:, 0]
        # the sine's period from its zero crossings (the reference knows f)
        zc = np.nonzero((bank_row[:-1] < 0) & (bank_row[1:] >= 0))[0]
        period = float(np.mean(np.diff(zc)))
        first = None
        for h, m in drained:
            if h < 48 or not meter(m, "oscilloscope", "locked")[i, 0]:
                continue
            pos = (h * BLOCK - hist + float(meter(m, "oscilloscope", "start")[i, 0])
                   + float(meter(m, "oscilloscope", "frac")[i, 0]))
            first = pos if first is None else first
            delta = (pos - first + period * 0.5) % period - period * 0.5
            jitter = max(jitter, abs(delta))
        assert first is not None, f"trigger never locked on stream {i}"
    report("default.oscilloscope.jitter", jitter, JITTER_LIMIT - 1e-9, "samples",
           "HIGHEST correlation FFTs")
    return served(server)


def phase_kernel(n_streams: int, interpret: bool):
    from test_sliding_kernel import _hops, codes_error, state_error

    from openmeters_tpu.ops.sliding_stft import SlidingSTFT
    from openmeters_tpu.utils.windows import WindowKind

    sl = SlidingSTFT(2048, 64, BLOCK, WindowKind.HANN, refresh_steps=8)
    out = _hops(sl, n_streams, n_hops=16, seed=5, interpret=interpret,
                n_ref=N_CHECKED)
    xla = codes_error(sl, out, "codes_xla")
    print(f"info xla_slide.codes_vs_f64 (every bin): {xla} u16 steps", flush=True)
    report("kernel.codes_vs_f64 (every bin; limit = the XLA slide's own + 1)",
           codes_error(sl, out, "codes_fused"), xla + 1, "u16 steps",
           "fused kernel, HIGHEST delta dots")
    state = max(state_error(h.state_fused, h.state_xla) for h in out)
    report("kernel.state_vs_xla", state, 1e-5, "of row peak",
           "fused kernel vs XLA slide, same HIGHEST delta dots")
    return {"streams": n_streams}


def phase_gpu_tests(rehearse: bool):
    import test_gpu_precision
    import test_sliding_kernel

    ran = []
    for mod in (test_sliding_kernel, test_gpu_precision):
        for name in sorted(dir(mod)):
            fn = getattr(mod, name)
            marks = [m.name for m in getattr(fn, "pytestmark", [])]
            if name.startswith("test_") and "gpu" in marks:
                if not rehearse:
                    fn(gpu=None)
                ran.append(f"{mod.__name__}.{name}")
    assert ran, "no gpu-marked tests found"
    return {"tests": ran}


def phase_sharded(n_per_card: int, hops: int, n_cards: int):
    """The serve config through ``sharded_step`` over ``n_cards`` cards, and
    the same streams stepped on one card, one card-sized slice at a time
    (the whole batch's carry would not fit one card beside its shard)."""
    import jax

    from openmeters_tpu.engine import MeterEngine, StreamMeta, make_mesh, sharded_step

    engine = MeterEngine(serve_config("serve"))
    s = n_cards * n_per_card
    mesh = make_mesh(n_cards)
    step, place = sharded_step(engine, mesh)
    bank = signal_bank(hops * BLOCK, seed=31)
    gains = np.random.default_rng(32).uniform(0.3, 1.0, s).astype(np.float32)
    reset = np.zeros((s,), bool)

    def block(h, rows):
        sl = bank[rows % N_SIGNALS, h * BLOCK:(h + 1) * BLOCK]
        return sl * gains[rows, None, None]

    everyone = np.arange(s)
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    carry_sh = place(engine.init(s))
    hlo = step.lower(carry_sh, block(0, everyone), meta, reset).compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute", "all-to-all",
               "reduce-scatter"):
        assert op not in hlo, f"collective in the sharded step: {op}"
    print("sharded step: no collectives in the compiled HLO", flush=True)
    for h in range(hops):
        carry_sh, snaps_sh = step(carry_sh, block(h, everyone), meta, reset)
    snaps_sh = jax.tree.map(np.asarray, snaps_sh)
    del carry_sh

    one = jax.devices()[0]
    single = jax.jit(engine.step)
    meta_1 = jax.device_put(StreamMeta.default(n_per_card, channels=2,
                                               pad_channels=2), one)
    reset_1 = jax.device_put(np.zeros((n_per_card,), bool), one)
    slices = []
    for lo in range(0, s, n_per_card):
        rows = everyone[lo:lo + n_per_card]
        carry_1 = jax.device_put(engine.init(n_per_card), one)
        for h in range(hops):
            blk = jax.device_put(block(h, rows), one)
            carry_1, snaps_1 = single(carry_1, blk, meta_1, reset_1)
        slices.append(jax.tree.map(np.asarray, snaps_1))
        del carry_1
    snaps_1 = jax.tree.map(lambda *x: np.concatenate(x), *slices)

    paths, _ = jax.tree_util.tree_flatten_with_path(snaps_1)
    for (path, a), b in zip(paths, jax.tree.leaves(snaps_sh)):
        key = jax.tree_util.keystr(path)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=key)
        elif "codes" in key:
            valid = snaps_1["spectrogram"].valid
            d = np.abs(a.astype(int) - b.astype(int))
            worst = int(np.max(np.where(valid[..., None], d, 0), initial=0))
            report(f"sharded_vs_one_card{key} (every bin)", worst, 1,
                   "u16 steps", "same program per shard")
        else:
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            report(f"sharded_vs_one_card{key}", float(d.max(initial=0.0)),
                   5e-3, "dB/LU", "same program per shard")
    return {"streams": s, "cards": n_cards, "hops": hops}


# -- driver --------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4))
    p.add_argument("--rehearse", action="store_true",
                   help="CPU dry run at a tiny size; always exits non-zero")
    args = p.parse_args(argv)

    import jax

    from openmeters_tpu.runtime_env import (
        card_line,
        device_summary,
        require_gpu,
        setup_compile_cache,
    )

    setup_compile_cache()
    dev = device_summary() if args.rehearse else require_gpu()
    print(f"device: {dev}", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}", flush=True)
    print(f"jax {jax.__version__}", flush=True)

    small = args.rehearse
    if args.cards == 4:
        phases = [("sharded", lambda: phase_sharded(
            32 if small else 16384, 4 if small else 8, 4))]
    else:
        phases = [
            ("serve", lambda: phase_serve(64 if small else 16384, HOPS)),
            ("default", lambda: phase_default(32 if small else 1024, HOPS)),
            ("kernel", lambda: phase_kernel(20 if small else 16384, small)),
            ("gpu-tests", lambda: phase_gpu_tests(small)),
        ]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            out = fn()
            status = "ok"
        except Exception:  # reported, and the run exits non-zero
            traceback.print_exc()
            out, status = None, "FAILED"
            failed.append(name)
        print(f"phase {name}: {status} ({time.perf_counter() - t0:.1f} s) {out}",
              flush=True)
    if failed:
        print(f"failed phases: {failed}", flush=True)
        return 1
    if args.rehearse:
        print("rehearsal complete (CPU): no result line", flush=True)
        return 3
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
