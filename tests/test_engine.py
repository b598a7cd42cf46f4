"""Engine fan-out and multi-device sharding tests."""

import numpy as np
import pytest

from conftest import sine_wave
from openmeters_tpu.engine import (
    EngineConfig,
    MeterEngine,
    StreamMeta,
    make_mesh,
    make_multihost_mesh,
    sharded_step,
)


def test_engine_fans_out_to_all_analyzers():
    eng = MeterEngine(EngineConfig())
    s, b = 2, 256
    # the stock 16384/1024 spectrum runs at its own hop cadence: 4 engine
    # blocks per spectrum hop (meter.rs per-visual DspBatcher cadence)
    r = eng.spectrum_cadence
    assert r == 4
    carry = eng.init(s)
    meta = StreamMeta.default(s)
    blocks = np.zeros((r, s, b, 8), np.float32)
    sig = sine_wave(1000.0, 48_000.0, r * b, 0.5)
    for j in range(r):
        blocks[j, 0, :, 0] = blocks[j, 0, :, 1] = sig[j * b : (j + 1) * b]
    # one super-period emits all six analyzers, matching the reference
    # registry (registry.rs:37-240); fast snapshots stack per engine hop
    carry, snaps = eng.super_step(carry, blocks, meta)
    assert set(snaps) == {
        "loudness",
        "spectrogram",
        "spectrum",
        "oscilloscope",
        "stereometer",
        "waveform",
    }
    # the per-hop step alone fans out to the five hop-cadence analyzers
    carry, fast = eng.step(carry, blocks[0], meta)
    assert set(fast) == set(snaps) - {"spectrum"}
    # loudness momentary reacts immediately; silent stream stays at floor
    m = np.asarray(snaps["loudness"].momentary_lufs)  # [r, s] stacked
    assert float(m[-1, 0]) > -30
    assert float(m[-1, 1]) == pytest.approx(-99.9, abs=1e-3)


def test_engine_fold_applies_stereo_matrix():
    """An FC-only signal folds into both stereo sides at 1/sqrt(2)."""
    eng = MeterEngine(EngineConfig(spectrogram=None, spectrum=None))
    s, b = 1, 256
    meta = StreamMeta.default(s, channels=6)
    block = np.zeros((s, b, 8), np.float32)
    block[0, :, 2] = sine_wave(1000.0, 48_000.0, b, 0.5)  # FrontCenter
    carry = eng.init(s)
    carry, snaps = eng.step(carry, block, meta)
    # center channel has BS.1770 weight 1.0; per-channel RMS sees channel 2
    rms = np.asarray(snaps["loudness"].rms_fast_db[0])
    assert rms[2] > -30 and rms[0] == pytest.approx(-99.9, abs=1e-3)


def test_engine_reset_mask_is_per_stream():
    eng = MeterEngine(EngineConfig(spectrogram=None, spectrum=None))
    s, b = 2, 256
    meta = StreamMeta.default(s)
    sig = sine_wave(1000.0, 48_000.0, b * 8, 0.5)
    carry = eng.init(s)
    for i in range(8):
        block = np.zeros((s, b, 8), np.float32)
        for st in range(s):
            block[st, :, 0] = block[st, :, 1] = sig[i * b : (i + 1) * b]
        carry, snaps = eng.step(carry, block, meta)
    silent = np.zeros((s, b, 8), np.float32)
    carry, snaps = eng.step(
        carry, silent, meta, reset_mask=np.array([True, False])
    )
    m = np.asarray(snaps["loudness"].momentary_lufs)
    assert m[0] == pytest.approx(-99.9, abs=1e-3)  # reset stream: empty windows
    assert m[1] > -30  # un-reset stream still averages the tone


def test_sharded_step_on_virtual_mesh():
    """Full engine step jitted over the 8-device CPU mesh with real stream
    shardings — the multi-chip path the driver dry-runs."""
    import jax

    mesh = make_mesh()
    assert len(mesh.devices) == 8
    eng = MeterEngine(EngineConfig())
    s, b = 16, 256
    step, place = sharded_step(eng, mesh)
    carry = place(eng.init(s))
    meta = StreamMeta.default(s)
    block = np.zeros((s, b, 8), np.float32)
    for st in range(s):
        block[st, :, 0] = block[st, :, 1] = sine_wave(100.0 * (st + 1), 48_000.0, b, 0.3)
    reset = np.zeros((s,), bool)
    carry, snaps = step(carry, block, meta, reset)
    lufs = np.asarray(snaps["loudness"].momentary_lufs)
    assert lufs.shape == (s,)
    assert np.all(np.isfinite(lufs))
    # sharded result == single-device result
    eng2 = MeterEngine(EngineConfig())
    c2 = eng2.init(s)
    c2, snaps2 = eng2.step(c2, block, meta, reset)
    # sharded compilation may reorder f32 reductions; parity well below 0.01 LU
    np.testing.assert_allclose(
        lufs, np.asarray(snaps2["loudness"].momentary_lufs), atol=5e-3
    )
    codes_sh = np.asarray(snaps["spectrogram"].point_valid)
    codes_1d = np.asarray(snaps2["spectrogram"].point_valid)
    np.testing.assert_array_equal(codes_sh, codes_1d)


def test_multihost_mesh_shards_without_collectives():
    """The multi-host story (SURVEY §5.8): a 2x4 (hosts, cards) mesh with stream
    arrays sharded over BOTH axes.  Pure DP over independent streams means
    the compiled step must contain no collective on either fabric — asserted
    on the optimized HLO, not just claimed."""
    mesh = make_multihost_mesh(2, 4)
    assert mesh.devices.shape == (2, 4)
    eng = MeterEngine(EngineConfig())
    s, b = 16, 256
    step, place = sharded_step(eng, mesh, axis=("hosts", "cards"))
    carry = place(eng.init(s))
    meta = StreamMeta.default(s)
    block = np.zeros((s, b, 8), np.float32)
    for st in range(s):
        block[st, :, 0] = block[st, :, 1] = sine_wave(
            100.0 * (st + 1), 48_000.0, b, 0.3
        )
    reset = np.zeros((s,), bool)

    compiled = step.lower(carry, block, meta, reset).compile()
    hlo = compiled.as_text()
    for op in ("all-reduce", "all-gather", "collective-permute", "all-to-all",
               "reduce-scatter"):
        assert op not in hlo, f"unexpected collective in multihost step: {op}"

    carry, snaps = step(carry, block, meta, reset)
    lufs = np.asarray(snaps["loudness"].momentary_lufs)

    eng2 = MeterEngine(EngineConfig())
    c2 = eng2.init(s)
    c2, snaps2 = eng2.step(c2, block, meta, reset)
    np.testing.assert_allclose(
        lufs, np.asarray(snaps2["loudness"].momentary_lufs), atol=5e-3
    )


def test_cadenced_spectrum_matches_per_hop_path(rng):
    """The cadenced spectrum (hop = R engine blocks stepped once per R hops
    via ``spectrum_step``) matches the per-hop cond-held path (hop > block
    inside one analyzer) on the same audio at every spectrum hop boundary.
    The two paths use different exact formulations (direct windowed rFFT vs
    sliding DFT — see SpectrumAnalyzer.use_sliding), so parity is to f32
    roundoff, orders below the 0.02 dB golden-test bar."""
    from openmeters_tpu.analyzers.spectrum import SpectrumAnalyzer, SpectrumConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta

    s, b, hops = 2, 256, 24
    cfg = SpectrumConfig(fft_size=2048, hop_size=1024)
    eng = MeterEngine(
        EngineConfig(
            channels=2, spectrum=cfg, loudness=None, spectrogram=None,
            oscilloscope=None, stereometer=None, waveform=None,
        )
    )
    r = eng.spectrum_cadence
    assert r == 4
    x = (rng.standard_normal((s, hops * b, 2)) * 0.3).astype(np.float32)
    meta = StreamMeta.default(s, channels=2, pad_channels=2)

    carry = eng.init(s)
    cadenced = []
    for k in range(hops // r):
        blocks = np.stack(
            [x[:, (k * r + j) * b : (k * r + j + 1) * b] for j in range(r)]
        )
        carry, snaps = eng.super_step(carry, blocks, meta)
        cadenced.append(np.asarray(snaps["spectrum"].raw_db))

    # per-hop reference: the analyzer's own hop>block path at block=256
    ana = SpectrumAnalyzer(
        dataclasses_replace(cfg, block_frames=b, sample_rate=48_000.0)
    )
    c = ana.init(s)
    for i in range(hops):
        c, snap = ana.step(c, x[:, i * b : (i + 1) * b])
        if i % r == r - 1:
            np.testing.assert_allclose(
                np.asarray(snap.raw_db), cadenced[i // r], atol=1e-3
            )


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_cadenced_spectrum_reset_aligned_matches_per_hop_path(rng):
    """A reset on a spectrum-hop boundary: the cadenced path matches the
    per-hop path through the reset (both freshness counters restart at the
    same sample; values equal to f32 roundoff across the two exact
    formulations)."""
    from openmeters_tpu.analyzers.spectrum import SpectrumAnalyzer, SpectrumConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta

    s, b, hops = 2, 256, 24
    cfg = SpectrumConfig(fft_size=2048, hop_size=1024)
    eng = MeterEngine(
        EngineConfig(
            channels=2, spectrum=cfg, loudness=None, spectrogram=None,
            oscilloscope=None, stereometer=None, waveform=None,
        )
    )
    r = eng.spectrum_cadence
    x = (rng.standard_normal((s, hops * b, 2)) * 0.3).astype(np.float32)
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    reset_hop = 8  # engine hop index, aligned: 8 % r == 0

    carry = eng.init(s)
    cadenced = []
    for k in range(hops // r):
        blocks = np.stack(
            [x[:, (k * r + j) * b : (k * r + j + 1) * b] for j in range(r)]
        )
        resets = np.zeros((r, s), bool)
        if k * r <= reset_hop < (k + 1) * r:
            resets[reset_hop - k * r, 0] = True
        carry, snaps = eng.super_step(carry, blocks, meta, resets=resets)
        cadenced.append(np.asarray(snaps["spectrum"].raw_db))

    ana = SpectrumAnalyzer(
        dataclasses_replace(cfg, block_frames=b, sample_rate=48_000.0)
    )
    c = ana.init(s)
    for i in range(hops):
        rst = np.zeros((s,), bool)
        rst[0] = i == reset_hop
        c, snap = ana.step(c, x[:, i * b : (i + 1) * b], reset_mask=rst)
        if i % r == r - 1:
            np.testing.assert_allclose(
                np.asarray(snap.raw_db), cadenced[i // r], atol=1e-3
            )


def test_cadenced_spectrum_reset_admits_no_stale_audio():
    """A mid-spectrum-hop generation reset followed by silence: the first
    valid post-reset column must sit at the floor.  spectrum_step zeroes the
    pre-reset blocks device-side (engine.py), so the old generation's tone
    cannot leak into the post-reset window (the advisor-flagged stale-sample
    admission of the OR'd-mask formulation)."""
    from openmeters_tpu.analyzers.spectrum import SpectrumConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta

    s, b = 2, 256
    cfg = SpectrumConfig(fft_size=2048, hop_size=1024)
    eng = MeterEngine(
        EngineConfig(
            channels=2, spectrum=cfg, loudness=None, spectrogram=None,
            oscilloscope=None, stereometer=None, waveform=None,
        )
    )
    r = eng.spectrum_cadence
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    t = np.arange(b, dtype=np.float64) / 48_000.0
    tone_block = np.broadcast_to(
        (0.8 * np.sin(2 * np.pi * 3000.0 * np.arange(b) / 48_000.0))
        .astype(np.float32)[None, :, None],
        (s, b, 2),
    )
    del t
    silence = np.zeros((s, b, 2), np.float32)
    floor = cfg.floor_db

    carry = eng.init(s)
    # spectrum hops 0-1: loud tone, no resets (fills the window)
    for _ in range(2):
        blocks = np.stack([tone_block] * r)
        carry, snaps = eng.super_step(carry, blocks, meta)
    assert np.asarray(snaps["spectrum"].raw_db)[0].max() > floor + 20.0

    # spectrum hop 2: reset stream 0 at engine hop j=2; blocks before it are
    # old-generation tone, blocks at/after it are the new generation (silence)
    blocks = np.stack([tone_block, tone_block, silence, silence])
    resets = np.zeros((r, s), bool)
    resets[2, 0] = True
    carry, snaps = eng.super_step(carry, blocks, meta, resets=resets)

    # silence thereafter; once post-reset columns are valid they are floor
    for _ in range(3):
        blocks = np.stack([silence] * r)
        carry, snaps = eng.super_step(carry, blocks, meta)
    raw = np.asarray(snaps["spectrum"].raw_db)
    assert bool(np.asarray(snaps["spectrum"].updated)[0])
    np.testing.assert_array_equal(raw[0], np.full_like(raw[0], floor))
