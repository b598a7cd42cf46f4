"""Timings on the card that decide which implementation each job keeps.

Usage (one process, one GPU):

    python tools/chip_measure.py [--out chiprun_out/chip_measure.json]

Measures, each with the card's name and power limit printed beside it:

1. ``hop``: the engine step (``bench.measure``: a jitted scan of engine
   hops with every snapshot leaf consumed) with the fused sliding-hop
   kernel and with the XLA slide, in the headline config at S = 8192,
   16384 and 20480 and in the stock-default config at S = 1024, in the
   order XLA, kernel, kernel, XLA.
2. ``fft``: ``rfft_mxu`` against ``jnp.fft.rfft`` at n = 2048 (the
   headline re-anchor, [16384, 2048]) and n = 16384 (the stock spectrum,
   [1024, 16384]).
3. ``gather``: ``window_rows`` at [1024, 9603] -> 7200.
4. ``trace``: a device trace of the headline step at S = 16384 with the
   XLA slide and with the fused kernel (``tools/profile_step.py``), each
   op's device time per step printed, traces under ``chiprun_out/``.

Step times come from the host clock around work that ends in a device
sync; each is the best of three.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def best_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """Best-of-``rounds`` mean wall time of ``fn()`` (which must return a
    device value), in ms, after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    best = np.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def force_xla_slide(on: bool):
    """Pin the classic spectrogram to the XLA slide (``on``) or let the
    platform choose (the fused kernel on a GPU) — measurement only."""
    from openmeters_tpu.analyzers import spectrogram

    cls = spectrogram.SpectrogramAnalyzer
    if not hasattr(cls, "_platform_choice"):
        cls._platform_choice = cls.use_sliding_kernel
    cls.use_sliding_kernel = property(lambda self: False) if on else cls._platform_choice


def measure_hop(results: dict):
    import jax

    import bench
    from openmeters_tpu.engine import EngineConfig, MeterEngine

    rows = []
    cases = [("headline", bench.build_engine, s) for s in (8192, 16384, 20480)]
    cases.append(("default", lambda: MeterEngine(EngineConfig(channels=2)), 1024))
    for name, build, s in cases:
        for variant in ("xla", "kernel", "kernel", "xla"):
            force_xla_slide(variant == "xla")
            jax.clear_caches()
            engine = build()
            sg = engine.analyzers.get("spectrogram")
            uses = bool(sg is not None and sg.use_sliding_kernel)
            try:
                r = bench.measure(engine, s, iters=512 if name == "default" else 128)
                row = {"config": name, "streams": s, "variant": variant,
                       "kernel_on_path": uses, "step_ms": r["step_ms"]}
            except Exception as exc:  # recorded; the other cells still run
                row = {"config": name, "streams": s, "variant": variant,
                       "error": f"{type(exc).__name__}: {exc}"[:300]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    force_xla_slide(False)
    results["hop"] = rows


def measure_fft(results: dict):
    import jax
    import jax.numpy as jnp

    from openmeters_tpu.ops.fft import rfft_mxu

    rows = []
    for n, batch in ((2048, 16384), (16384, 1024)):
        x = jnp.asarray(
            np.random.default_rng(n).standard_normal((batch, n)), jnp.float32
        )
        mm = jax.jit(lambda v: rfft_mxu(v, n))
        cu = jax.jit(lambda v: jnp.fft.rfft(v, n))
        ref = np.fft.rfft(np.asarray(x, np.float64)[:4])
        for name, fn in (("rfft_mxu", mm), ("jnp.fft.rfft", cu),
                         ("jnp.fft.rfft", cu), ("rfft_mxu", mm)):
            got = np.asarray(fn(x)[:4])
            err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
            row = {"n": n, "batch": batch, "impl": name,
                   "ms": best_ms(lambda: fn(x)),
                   "amp_err_db": 20 * np.log10(max(err, 1e-30))}
            print(json.dumps(row), flush=True)
            rows.append(row)
    results["fft"] = rows


def measure_gather(results: dict):
    import jax
    import jax.numpy as jnp

    from openmeters_tpu.analyzers.oscilloscope import window_rows

    x = jnp.asarray(np.random.default_rng(0).standard_normal((1024, 9603)),
                    jnp.float32)
    starts = jnp.asarray(np.random.default_rng(1).integers(0, 2403, 1024),
                         jnp.int32)
    fn = jax.jit(lambda a, b: window_rows(a, b, 7200))
    row = {"shape": [1024, 9603], "length": 7200,
           "ms": best_ms(lambda: fn(x, starts))}
    print(json.dumps(row), flush=True)
    results["gather"] = row


def measure_trace(results: dict):
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_step

    for variant in ("xla", "kernel"):
        force_xla_slide(variant == "xla")
        jax.clear_caches()
        print(f"## trace {variant}", flush=True)
        profile_step.main(["headline", "16384", "32",
                           os.path.join(ROOT, "chiprun_out", f"trace_{variant}")])
    force_xla_slide(False)
    results["trace"] = "printed"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "chip_measure.json"))
    p.add_argument("--only", default="hop,fft,gather,trace")
    args = p.parse_args(argv)

    from openmeters_tpu.runtime_env import card_line, require_gpu, setup_compile_cache

    setup_compile_cache()
    results = {"device": require_gpu(), "card": card_line(),
               "xla_flags": os.environ.get("XLA_FLAGS", "")}
    print(json.dumps(results), flush=True)
    steps = {"hop": measure_hop, "fft": measure_fft, "gather": measure_gather,
             "trace": measure_trace}
    for name in args.only.split(","):
        t0 = time.perf_counter()
        try:
            steps[name](results)
        except Exception as exc:  # recorded; the other measurements run
            results[name] = {"error": f"{type(exc).__name__}: {exc}"[:500]}
            print(json.dumps({name: results[name]}), flush=True)
        print(f"# {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
