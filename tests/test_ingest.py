"""Host ingest transport tests (reference transport.rs:706-823 fake-backend
pattern: drive both ends on one thread with injected timestamps)."""

import numpy as np
import pytest

from openmeters_tpu.ingest import Transport

RATE = 48_000.0
NS = 1_000_000_000


def ns_of(frames):
    return int(frames * NS / RATE)


@pytest.fixture
def tp():
    return Transport(n_streams=2, channels=2, block_frames=256, sample_rate=RATE)


def frames_of(n, value=0.5):
    return np.full((n, 2), value, np.float32)


def test_pcm_roundtrip(tp):
    x = np.arange(512 * 2, dtype=np.float32).reshape(512, 2) / 1024.0
    assert tp.push_pcm(0, x, 0) == 0
    batch, reset, underrun, live = tp.assemble()
    assert live == 1
    np.testing.assert_allclose(batch[0], x[:256])
    # first span discovers generation 1 -> initial format reset
    # (registry.rs:400-406: the manager resets on its first generation watch)
    assert reset[0] and not underrun[0]
    assert underrun[1]  # stream 1 got nothing
    batch, reset, *_ = tp.assemble()
    np.testing.assert_allclose(batch[0], x[256:])
    assert not reset[0]


def test_gap_becomes_silence(tp):
    tp.push_pcm(0, frames_of(256), 0)
    # skip 256 frames of time, then more PCM
    tp.push_pcm(0, frames_of(256, 0.25), ns_of(512))
    b1, *_ = tp.assemble()
    assert np.all(b1[0] == 0.5)
    b2, reset, underrun, _ = tp.assemble()
    assert np.all(b2[0] == 0.0) and not reset[0] and not underrun[0]
    b3, *_ = tp.assemble()
    assert np.all(b3[0] == 0.25)


def test_timestamp_regression_faults(tp):
    tp.push_pcm(0, frames_of(256), 0)
    tp.push_pcm(0, frames_of(256), ns_of(64))  # overlaps previous packet
    assert tp.fault_count(0) == 1
    batch, reset, _, _ = tp.assemble()
    assert reset[0]
    assert np.all(batch[0] == 0.0)  # backlog dropped, no replay


def test_overflow_faults_and_resets(tp):
    # ring holds ~4/3 s; push 2 s without draining
    for i in range(int(2.0 * RATE) // 4096):
        tp.push_pcm(0, frames_of(4096), ns_of(i * 4096))
    assert tp.fault_count(0) >= 1
    _, reset, _, _ = tp.assemble()
    assert reset[0]


def test_nan_sanitized(tp):
    x = frames_of(256)
    x[10, 0] = np.nan
    x[20, 1] = np.inf
    tp.push_pcm(0, x, 0)
    batch, *_ = tp.assemble()
    assert np.isfinite(batch[0]).all()
    assert batch[0][10, 0] == 0.0 and batch[0][20, 1] == 0.0


def test_long_silence_resets(tp):
    tp.push_pcm(0, frames_of(256), 0)
    tp.push_silence(0, int(3 * RATE), ns_of(256))  # > 2 s silence
    tp.assemble()
    _, reset, _, _ = tp.assemble()
    assert reset[0]


def test_generation_change_resets(tp):
    tp.push_pcm(0, frames_of(256), 0)
    batch, reset, _, _ = tp.assemble()
    assert reset[0]  # first span carries generation 1 vs seen 0 -> reset
    tp.push_pcm(0, frames_of(256), ns_of(256))
    _, reset, _, _ = tp.assemble()
    assert not reset[0]
    tp.set_generation(0, 2)
    tp.push_pcm(0, frames_of(256), ns_of(512))
    _, reset, _, _ = tp.assemble()
    assert reset[0]


def test_backlog_cap_resets_instead_of_replaying(tp):
    # 1.2 s of audio buffered (> 1 s backlog cap, < ring capacity)
    n = int(1.2 * RATE)
    for i in range(n // 4096):
        tp.push_pcm(0, frames_of(4096), ns_of(i * 4096))
    _, reset, _, _ = tp.assemble()
    assert reset[0]


def test_streams_are_independent(tp):
    tp.push_pcm(0, frames_of(256, 0.5), 0)
    tp.push_pcm(1, frames_of(256, -0.5), 0)
    batch, *_ = tp.assemble()
    assert np.all(batch[0] == 0.5) and np.all(batch[1] == -0.5)


def test_feeds_engine_end_to_end():
    """Ingest -> engine: one full hop through the real pipeline."""
    from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig

    tp = Transport(n_streams=2, channels=2, block_frames=256)
    eng = MeterEngine(
        EngineConfig(
            channels=2,
            spectrogram=SpectrogramConfig(fft_size=256, hop_size=64),
            spectrum=None,
            oscilloscope=None, stereometer=None, waveform=None,
        )
    )
    carry = eng.init(2)
    meta = StreamMeta.default(2, channels=2, pad_channels=2)
    t = np.arange(1024) / RATE
    tone = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    tp.push_pcm(0, np.stack([tone, tone], -1)[:1024], 0)
    snaps = None
    for _ in range(4):
        batch, reset, underrun, _ = tp.assemble()
        carry, snaps = eng.step(carry, batch, meta, reset_mask=reset)
    assert float(snaps["loudness"].momentary_lufs[0]) > -30
    assert float(snaps["loudness"].momentary_lufs[1]) < -90


def test_pause_resume_activity_epoch(tp):
    """transport.rs:668-704 / meter.rs:126-142: pause gates at the producer;
    resume discards stale backlog and emits exactly one reset."""
    tp.push_pcm(0, frames_of(256), 0)
    tp.assemble()  # consume initial generation reset
    tp.set_active(0, False)
    assert not tp.is_active(0)
    assert tp.push_pcm(0, frames_of(256, 0.9), ns_of(256)) == 1  # dropped
    batch, reset, underrun, _ = tp.assemble()
    assert underrun[0] and np.all(batch[0] == 0.0)
    tp.set_active(0, True)
    tp.push_pcm(0, frames_of(256, 0.25), ns_of(512))
    batch, reset, _, _ = tp.assemble()
    assert reset[0]  # one reset on resume
    assert np.all(batch[0] == 0.25)  # fresh PCM, stale 0.9 never delivered
    _, reset, _, _ = tp.assemble()
    assert not reset[0]


def test_generation_change_mid_block_is_boundary_clean(tp):
    """A format change splits the hop: no old-generation PCM is ever
    delivered after its reset (reference resets exactly at the boundary)."""
    tp.push_pcm(0, frames_of(128, 0.5), 0)
    tp.set_generation(0, 2)
    tp.push_pcm(0, frames_of(256, 0.25), ns_of(128))
    b1, r1, u1, _ = tp.assemble()
    assert r1[0]  # initial generation-1 reset
    np.testing.assert_allclose(b1[0, :128], 0.5)
    np.testing.assert_allclose(b1[0, 128:], 0.0)  # boundary pad, not gen-2 PCM
    assert not u1[0]
    b2, r2, _, _ = tp.assemble()
    assert r2[0]  # generation-2 reset lands on its own clean hop
    np.testing.assert_allclose(b2[0], 0.25)


def test_idle_watchdog_resets_once():
    """Hop-cadence idle watchdog: a stalled stream synthesizes silence and
    resets exactly once after max_silence (transport.rs:32-37,506-528 +
    meter.rs:145-166), then stays dormant until data returns."""
    tp = Transport(
        n_streams=1, channels=2, block_frames=256, sample_rate=RATE,
        max_silence_seconds=0.02,  # 960 frames -> ~4 idle hops
    )
    tp.push_pcm(0, frames_of(256), 0)
    tp.assemble()
    resets = []
    for _ in range(12):
        _, reset, underrun, _ = tp.assemble()
        assert underrun[0]
        resets.append(bool(reset[0]))
    assert sum(resets) == 1  # exactly one watchdog reset
    # data returning clears dormancy (timestamp far ahead: gap is clamped)
    tp.push_pcm(0, frames_of(256, 0.7), ns_of(10_000))
    seen = False
    for _ in range(8):  # drain the clamped silence gap, then the PCM
        batch, _, _, live = tp.assemble()
        if live and np.all(batch[0] == 0.7):
            seen = True
            break
    assert seen


def test_sharded_assemble_matches_single():
    from concurrent.futures import ThreadPoolExecutor

    n = 8
    tp = Transport(n_streams=n, channels=2, block_frames=256, sample_rate=RATE)
    for s in range(n):
        tp.push_pcm(s, frames_of(512, (s + 1) / 10), 0)
    with ThreadPoolExecutor(4) as pool:
        batch, reset, underrun, live = tp.assemble(pool=pool, shards=4)
    assert live == n
    for s in range(n):
        assert np.all(batch[s] == (s + 1) / 10)
    assert tp.backlog_blocks() == 1  # 256 frames left per stream


def test_threaded_producers_and_assembler():
    """Genuinely concurrent SPSC use: one producer thread per stream pushing
    timed PCM while the main thread assembles — no locks, no losses, no
    faults (the reference validates transport under a live daemon;
    transport.cpp's atomics make this portable)."""
    import threading

    n_streams, blocks, b = 4, 40, 256
    tp = Transport(n_streams=n_streams, channels=2, block_frames=b)
    stop = threading.Event()

    def producer(stream):
        for i in range(blocks):
            x = np.full((b, 2), float(stream + 1) / 10, np.float32)
            while tp.push_pcm(stream, x, ns_of(i * b)) != 0 and not stop.is_set():
                pass

    threads = [threading.Thread(target=producer, args=(s,)) for s in range(n_streams)]
    for t in threads:
        t.start()

    import time

    got = np.zeros(n_streams, np.int64)
    deadline = time.monotonic() + 30.0
    while got.min() < blocks * b and time.monotonic() < deadline:
        # assemble on the hop cadence of real data: a hop with nothing
        # buffered is an underrun, and its synthesized silence would move
        # the stream's timeline past the producers' next timestamps
        if min(tp.buffered_frames(s) for s in range(n_streams)) < b:
            time.sleep(0.0005)
            continue
        batch, reset, underrun, live = tp.assemble()
        for s in range(n_streams):
            filled = np.count_nonzero(batch[s, :, 0] == (s + 1) / 10)
            got[s] += filled
    stop.set()
    for t in threads:
        t.join()
    assert got.min() == blocks * b, got
    assert all(tp.fault_count(s) == 0 for s in range(n_streams))
