"""Multi-rate co-residency: do a 44.1 kHz and a 48 kHz engine bucket hold
realtime TOGETHER on one card at realistic shapes?

``MultiRateMeterServer`` runs one engine per rate (meter.rs:20-25) with
serialized dispatches on the same card.  This measures that contract at
production scale: both buckets' steps run inside ONE jitted function (XLA
schedules them on the card exactly as the serving loop's back-to-back
dispatches do, minus per-dispatch overhead), chained over a K-step scan
with full-leaf probes (the bench.py methodology).  GPU only.

Realtime bound: the CADENCE is one 48k-hop (5.333 ms); the 44.1k bucket's
235-frame block spans the same wall time, so the combined step must finish
under 5.333 ms for both buckets to hold realtime.

Usage: python tools/bench_multirate.py [S_per_bucket=2048] [iters=32]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta
    from openmeters_tpu.runtime_env import card_line, require_gpu, setup_compile_cache

    setup_compile_cache()
    require_gpu()

    s = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 32

    def engine_at(rate: float) -> MeterEngine:
        return MeterEngine(
            EngineConfig.at_rate(
                rate,
                channels=2,
                spectrogram=SpectrogramConfig(
                    fft_size=2048, hop_size=64, use_reassignment=False
                ),
                spectrum=None,
                oscilloscope=None, stereometer=None, waveform=None,
            )
        )

    engines = {r: engine_at(r) for r in (44_100.0, 48_000.0)}
    rng = np.random.default_rng(0)
    blocks, metas, resets, carries = {}, {}, {}, {}
    for r, eng in engines.items():
        b = eng.config.block_frames
        blocks[r] = jnp.asarray(
            (rng.standard_normal((4, s, b, 2)) * 0.25).astype(np.float32)
        )
        metas[r] = StreamMeta.default(s, channels=2, pad_channels=2)
        resets[r] = np.zeros((s,), bool)
        carries[r] = eng.init(s)

    rates = sorted(engines)

    @jax.jit
    def run_k(c44, c48, b44, b48):
        def body(cs, i):
            c44, c48 = cs
            probe = jnp.float32(0)
            c44, sn44 = engines[rates[0]].step(
                c44, b44[i % 4], metas[rates[0]], resets[rates[0]]
            )
            c48, sn48 = engines[rates[1]].step(
                c48, b48[i % 4], metas[rates[1]], resets[rates[1]]
            )
            for sn in (sn44, sn48):
                for leaf in jax.tree.leaves(sn):
                    probe += jnp.sum(leaf.astype(jnp.float32))
            return (c44, c48), probe

        return jax.lax.scan(body, (c44, c48), jnp.arange(iters))

    cs, probes = run_k(
        carries[rates[0]], carries[rates[1]], blocks[rates[0]], blocks[rates[1]]
    )
    jax.block_until_ready(probes)
    dt = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        cs, probes = run_k(
            carries[rates[0]], carries[rates[1]],
            blocks[rates[0]], blocks[rates[1]],
        )
        jax.block_until_ready(probes)
        dt = min(dt, (time.perf_counter() - t0) / iters)

    hop_s = 256 / 48_000.0  # the shared cadence (one 48k hop of wall time)
    verdict = "REALTIME" if dt <= hop_s else "below realtime"
    total = 2 * s
    print(
        f"# multirate 44.1k+48k {s}+{s} streams: {dt * 1e3:.2f} ms per "
        f"{hop_s * 1e3:.2f} ms cadence -> {total * hop_s / dt:.0f} combined "
        f"realtime streams ({verdict}) [{card_line()}]"
    )


if __name__ == "__main__":
    main()
