"""CLI: headless analysis and diagnostics.

The reference has no CLI (config lives in the GUI + JSON settings); the
headless rebuild exposes one:

    python -m openmeters_tpu analyze tone.wav [--settings settings.json]
    python -m openmeters_tpu render tone.wav out_dir/ [--settings ...]
    python -m openmeters_tpu settings --init settings.json
    python -m openmeters_tpu selftest
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _jax_setup(log_device: bool = False) -> None:
    """Compile-cache placement for commands that compile (see
    ``runtime_env``); ``log_device`` logs the platform and device kind."""
    from openmeters_tpu.runtime_env import device_summary, setup_compile_cache

    setup_compile_cache()
    if log_device:
        import logging

        dev = device_summary()
        logging.getLogger("openmeters.serve").info(
            "serving on %s (%s) x%d", dev["platform"], dev["kind"], dev["count"]
        )


def cmd_analyze(args) -> int:
    _jax_setup()
    from openmeters_tpu.api import analyze_wav
    from openmeters_tpu.engine import EngineConfig
    from openmeters_tpu.persistence import SettingsHandle

    cfg = (
        SettingsHandle.load_or_default(args.settings)
        if args.settings
        else EngineConfig()
    )
    snaps = analyze_wav(args.wav, cfg)
    if not snaps:
        print("no complete hops in input", file=sys.stderr)
        return 1
    last = snaps[-1]
    out = {}
    if "loudness" in last:
        l = last["loudness"]
        out["loudness"] = {
            "short_term_lufs": float(l.short_term_lufs[0]),
            "momentary_lufs": float(l.momentary_lufs[0]),
            "true_peak_db": float(np.max(np.asarray(l.true_peak_db[0]))),
        }
    if "spectrum" in last:
        sp = last["spectrum"]
        raw = np.asarray(sp.raw_db)[0, 0]
        out["spectrum"] = {"peak_bin_db": float(np.max(raw))}
    if "spectrogram" in last:
        sg = last["spectrogram"]
        if hasattr(sg, "codes"):
            from openmeters_tpu.analyzers.spectrogram import unpack_classic_db

            codes = np.asarray(sg.codes)[0]
            valid = np.asarray(sg.valid)[0]
            if valid.any():
                col = codes[np.nonzero(valid)[0][-1]]
                out["spectrogram"] = {
                    "peak_db": float(np.max(np.asarray(unpack_classic_db(col))))
                }
    if "oscilloscope" in last:
        osc = last["oscilloscope"]
        out["oscilloscope"] = {
            "locked": bool(np.asarray(osc.locked)[0].any()),
            "period_samples": float(np.asarray(osc.period)[0].max()),
        }
    if "stereometer" in last:
        st = last["stereometer"]
        out["stereometer"] = {
            "correlation": float(st.correlations[0, 0]),
        }
    out["hops"] = len(snaps)
    print(json.dumps(out, indent=None if args.compact else 2))
    return 0


def _serving_engine_config(args):
    """Resolve the engine config a serving-family command runs.

    Precedence: ``--settings`` (any persisted configuration, lossy JSON
    schema) > ``--config default`` (the stock ``EngineConfig()``: all six
    analyzers, reassignment on, 16384-pt spectrum) > ``--config serve``
    (the lean classic-spectrogram throughput config).
    """
    import dataclasses

    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.engine import EngineConfig
    from openmeters_tpu.persistence import SettingsHandle

    if getattr(args, "settings", None):
        cfg = SettingsHandle.load_or_default(args.settings)
        return dataclasses.replace(cfg, channels=2)
    if getattr(args, "config", "serve") == "default":
        return EngineConfig(channels=2)
    return EngineConfig(
        channels=2,
        spectrogram=SpectrogramConfig(
            fft_size=2048, hop_size=64, use_reassignment=False
        ),
        spectrum=None,
    )


def cmd_serve(args) -> int:
    """Run the production serving loop with native synthetic producers.

    Real deployments push PCM via the Transport API (or a custom producer
    adapter); this command stands in a native tone feeder so the full
    transport -> device -> drain path is exercised end-to-end, and doubles
    as the serving/ingest benchmark.  ``--settings``/``--config`` pick the
    engine configuration (any persisted config serves, not just the lean
    throughput one).
    """
    from openmeters_tpu.ingest import Feeder
    from openmeters_tpu.serve import MeterServer, ServeConfig, ingest_benchmark

    if args.ingest_only:
        report = ingest_benchmark(
            n_streams=args.streams,
            duration_s=args.duration,
            feeder_threads=args.feeder_threads,
            assembler_shards=args.assembler_shards,
            realtime=not args.flat_out,
        )
        print(json.dumps(report))
        return 0

    _jax_setup(log_device=True)
    engine_cfg = _serving_engine_config(args)
    serve_cfg = ServeConfig(
        n_streams=args.streams,
        channels=2,
        engine=engine_cfg,
        realtime=not args.flat_out,
        fetch=args.fetch,
        assembler_shards=args.assembler_shards,
        scan_hops=args.scan_hops,
    )

    if args.socket:
        # session mode: external producers connect over the unix socket
        # (HELLO/FORMAT negotiation, identity routing, per-rate engine
        # buckets — meter.rs:20-25 semantics)
        from openmeters_tpu.serve import MultiRateMeterServer

        rates = tuple(float(r) for r in args.rates.split(","))
        server = MultiRateMeterServer(serve_cfg, rates, socket_path=args.socket)
        if args.watch_settings:
            if not args.settings:
                print("--watch-settings requires --settings", file=sys.stderr)
                server.close()
                return 2
            # per rate bucket: each watcher pins its bucket's transport-owned
            # rate/block geometry and hot-reloads the rest
            from openmeters_tpu.serve import attach_settings_watcher

            for bucket in server.servers.values():
                attach_settings_watcher(bucket, args.settings)
        try:
            report = server.run(args.duration)
            view = server.runtime.view() if server.runtime else {}
        finally:
            server.close()
        report["links"] = view.get("links", {})
        print(json.dumps(report, default=str))
        return 0

    server = MeterServer(serve_cfg)
    if args.checkpoint:
        # resume the DSP state across restarts (flush-on-exit analogue:
        # reference main.rs:59); SIGTERM also snapshots before exiting
        import os
        import signal

        if os.path.exists(args.checkpoint):
            server.restore(args.checkpoint)
            print(f"# restored carry from {args.checkpoint}", file=sys.stderr)

        def _on_term(signum, frame):  # noqa: ARG001
            server.checkpoint(args.checkpoint)
            raise SystemExit(128 + signum)

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    restore_term = None
    if args.tui:
        from openmeters_tpu.tui import serve_tui_callback

        server.on_drain = serve_tui_callback(stream=args.tui_stream)
        if sys.stdin.isatty():
            # keyboard shortcuts (reference message.rs:59-83 + the config
            # page's visual toggles, ui/config.rs): p/space toggles pause,
            # q quits, 1-6 toggle analyzers live, s/S cycles the displayed
            # stream; cbreak so keys arrive unbuffered
            import termios
            import tty

            from openmeters_tpu.tui import attach_key_controls

            fd = sys.stdin.fileno()
            saved = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            restore_term = lambda: termios.tcsetattr(  # noqa: E731
                fd, termios.TCSADRAIN, saved
            )
            attach_key_controls(server, view=server.on_drain.view)
    if args.watch_settings:
        # the headless config page: edit the settings JSON while serving
        # and the loop hot-reloads it (background compile, hop-boundary
        # swap with field-level state retention)
        if not args.settings:
            print("--watch-settings requires --settings", file=sys.stderr)
            return 2
        from openmeters_tpu.serve import attach_settings_watcher

        attach_settings_watcher(server, args.settings)
    if args.render_dir:
        # the headless render loop: rasterize every active visual to PNGs
        # at display rate (frame_clock.rs -> visuals/*/render.rs analogue);
        # bulk panes (classic spectrogram / waveform / Lissajous) need
        # --fetch full
        from openmeters_tpu.render_live import attach_render_consumer

        attach_render_consumer(
            server, args.render_dir, stream=args.tui_stream,
            every=args.render_every,
            theme=_resolve_theme(args.theme, args.themes_dir, args.settings),
        )
    feeder = Feeder(
        server.transport, n_threads=args.feeder_threads, frames_per_push=1024
    )
    try:
        report = server.run(args.duration)
    finally:
        if restore_term is not None:
            restore_term()
        ok, failed = feeder.stop()
        if args.checkpoint:
            server.checkpoint(args.checkpoint)
        server.close()
    report["feeder_pushes_ok"] = ok
    report["feeder_pushes_failed"] = failed
    server.stats.log_summary()
    print(json.dumps(report))
    return 0


def cmd_render(args) -> int:
    """Analyze a WAV and rasterize the final snapshot of every active
    visual to PNG files (the headless render pipeline, render.py)."""
    import dataclasses

    _jax_setup()
    from openmeters_tpu.api import analyze
    from openmeters_tpu.engine import EngineConfig
    from openmeters_tpu.io.wav import read_wav
    from openmeters_tpu.persistence import SettingsHandle
    from openmeters_tpu.render import render_series

    cfg = (
        SettingsHandle.load_or_default(args.settings)
        if args.settings
        else EngineConfig()
    )
    samples, rate = read_wav(args.wav)
    # the engine analyzes at the WAV's native rate (api.analyze re-rates the
    # config the same way); the renderer must map bins->Hz with that rate too
    cfg = dataclasses.replace(cfg, sample_rate=rate)
    snaps = analyze(samples, rate, cfg)
    if not snaps:
        print("no complete hops in input", file=sys.stderr)
        return 1
    written = render_series(
        snaps, cfg, args.out, width=args.width, height=args.height
    )
    for path in written:
        print(path)
    return 0


def cmd_precompile(args) -> int:
    """Populate the persistent compilation cache for a serving config.

    Running this once at deploy time (same config, same JAX version) lets
    the actual `serve` process start against a warm cache.  The cache keys
    on the HLO + compile flags, which are stable across processes; it lives
    where JAX_COMPILATION_CACHE_DIR points, else in ``<repo>/.jax_cache``.
    """
    import time

    from openmeters_tpu.runtime_env import setup_compile_cache
    from openmeters_tpu.serve import MeterServer, ServeConfig

    cache_dir = setup_compile_cache()

    engine_cfg = _serving_engine_config(args)
    t0 = time.perf_counter()
    server = MeterServer(
        ServeConfig(
            n_streams=args.streams, channels=2, engine=engine_cfg,
            scan_hops=args.scan_hops,
        )
    )
    dt = time.perf_counter() - t0
    server.close()
    print(json.dumps({
        "compile_s": round(dt, 2),
        "cache_dir": cache_dir,
        "config": args.config,
        "streams": args.streams,
        "scan_hops": args.scan_hops,
    }))
    return 0


def cmd_settings(args) -> int:
    from openmeters_tpu.engine import EngineConfig
    from openmeters_tpu.persistence import (
        UiSettings,
        encode_settings,
        encode_ui,
        write_json_atomic,
    )

    doc = encode_settings(EngineConfig())
    doc["ui"] = encode_ui(UiSettings())
    write_json_atomic(args.init, doc)
    print(f"wrote default settings to {args.init}")
    return 0


def _resolve_theme(name, themes_dir, settings_path):
    """Pick the live theme: explicit --theme wins, else the persisted
    ui.theme from --settings, else the builtin default."""
    from openmeters_tpu.persistence import SettingsHandle
    from openmeters_tpu.themes import BUILTIN_THEMES, ThemeStore

    if name is None and settings_path:
        name = SettingsHandle.load_ui_or_default(settings_path).theme
    if name is None or name == "default":
        return BUILTIN_THEMES["default"]
    return ThemeStore(themes_dir).load(name)


def cmd_themes(args) -> int:
    """Theme store operations: the headless palette editor
    (ui/palette_editor.rs drives the same stop edits through a GUI)."""
    from openmeters_tpu.themes import BUILTIN_THEMES, Theme, ThemeStore

    store = ThemeStore(args.dir)
    if args.action in ("show", "set-stop", "delete") and not args.name:
        print(f"themes {args.action} needs a theme name")
        return 1
    if args.action == "set-stop":
        from openmeters_tpu.themes import VISUALS

        if args.visual not in VISUALS:
            print(f"set-stop needs a visual out of {', '.join(VISUALS)}")
            return 1
    if args.action == "list":
        for name in store.list_themes():
            mark = " (builtin)" if name in BUILTIN_THEMES else ""
            print(f"{name}{mark}")
        return 0
    if args.action == "show":
        theme = store.load(args.name)
        doc = {
            v: {
                "stops": p.colors.tolist(),
                "positions": p.positions.tolist(),
                "spreads": p.spreads.tolist(),
            }
            for v, p in sorted(theme.palettes.items())
        }
        print(json.dumps({"name": theme.name, "palettes": doc}, indent=2))
        return 0
    if args.action == "delete":
        ok = store.delete(args.name)
        print(f"{'deleted' if ok else 'cannot delete'} {args.name}")
        return 0 if ok else 1
    if args.action == "create":
        base = store.load(args.base)
        saved = store.save(Theme(args.name or base.name, palettes=dict(base.palettes)),
                           name=args.name)
        print(f"saved theme {saved}")
        return 0
    if args.action == "set-stop":
        import numpy as np

        from openmeters_tpu.views import GradientPalette

        theme = store.load(args.name)
        palette = theme.palette(args.visual)
        colors = np.array(palette.colors, np.float32)
        positions = np.array(palette.positions, np.float32)
        spreads = np.array(palette.spreads, np.float32)
        i = args.stop
        if not 0 <= i < len(colors):
            print(f"stop {i} out of range (palette has {len(colors)} stops)")
            return 1
        if args.color:
            rgba = [float(x) for x in args.color.split(",")]
            if len(rgba) == 3:
                rgba.append(1.0)
            colors[i] = rgba
        if args.position is not None and 0 < i < len(colors) - 1:
            positions[i] = args.position
        if args.spread is not None:
            spreads[i] = args.spread
        palettes = dict(theme.palettes)
        palettes[args.visual] = GradientPalette.make(colors, positions, spreads)
        saved = store.save(Theme(args.name, palettes=palettes), name=args.name)
        print(f"saved theme {saved}")
        return 0
    raise AssertionError(args.action)


def cmd_selftest(args) -> int:
    """Tiny end-to-end smoke: tone in, sane meters out."""
    _jax_setup()
    from openmeters_tpu.api import analyze
    from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
    from openmeters_tpu.engine import EngineConfig

    rate = 48_000.0
    t = np.arange(int(rate * 0.5)) / rate
    tone = (0.5 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    audio = np.stack([tone, tone], -1)
    cfg = EngineConfig(
        spectrogram=SpectrogramConfig(fft_size=1024, hop_size=256, use_reassignment=False),
        spectrum=None,
        # smoke test stays small: the full six-analyzer default belongs to
        # `analyze`/`serve`, not this compile-bound sanity check
        oscilloscope=None,
        stereometer=None,
        waveform=None,
    )
    snaps = analyze(audio, rate, cfg)
    lufs = float(snaps[-1]["loudness"].momentary_lufs[0])
    ok = abs(lufs + 6.0) < 0.5
    print(f"momentary LUFS of -6 dBFS stereo 997 Hz tone: {lufs:.2f} ({'OK' if ok else 'FAIL'})")
    return 0 if ok else 1


def main(argv=None) -> int:
    from openmeters_tpu.tracing import init_tracing

    init_tracing()
    p = argparse.ArgumentParser(prog="openmeters_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("analyze", help="analyze a WAV file")
    pa.add_argument("wav")
    pa.add_argument("--settings", help="settings JSON (lossy schema)")
    pa.add_argument("--compact", action="store_true")
    pa.set_defaults(fn=cmd_analyze)

    pr = sub.add_parser("render", help="render a WAV's final meters to PNGs")
    pr.add_argument("wav")
    pr.add_argument("out", help="output directory for PNG frames")
    pr.add_argument("--settings", help="settings JSON (lossy schema)")
    pr.add_argument("--width", type=int, default=960)
    pr.add_argument("--height", type=int, default=540)
    pr.set_defaults(fn=cmd_render)

    pv = sub.add_parser("serve", help="run the serving loop (synthetic feed)")
    pv.add_argument("--settings", help="serve a persisted settings JSON "
                    "(lossy schema) instead of a named --config")
    pv.add_argument("--config", choices=["serve", "default"], default="serve",
                    help="'serve': lean classic-spectrogram throughput "
                    "config; 'default': the stock EngineConfig() (all six "
                    "analyzers, reassignment on)")
    pv.add_argument("--watch-settings", action="store_true",
                    help="hot-reload --settings while serving: edits to the "
                    "file recompile in the background and swap at a hop "
                    "boundary with state retention (single-rate mode)")
    pv.add_argument("--streams", type=int, default=256)
    pv.add_argument("--duration", type=float, default=5.0)
    pv.add_argument("--fetch", choices=["meters", "full", "none"], default="meters")
    pv.add_argument("--feeder-threads", type=int, default=4)
    pv.add_argument("--assembler-shards", type=int, default=1)
    pv.add_argument("--flat-out", action="store_true",
                    help="no pacing: measure max throughput")
    pv.add_argument("--scan-hops", type=int, default=1,
                    help="device-side hops per dispatch (amortizes dispatch overhead)")
    pv.add_argument("--socket", help="unix socket path: serve external "
                    "producers (identity routing, per-rate buckets) instead "
                    "of the synthetic feeder")
    pv.add_argument("--rates", default="48000",
                    help="comma-separated sample-rate buckets for --socket")
    pv.add_argument("--tui", action="store_true",
                    help="live terminal meters at display rate (stderr)")
    pv.add_argument("--tui-stream", type=int, default=0,
                    help="stream index shown by --tui")
    pv.add_argument("--render-dir",
                    help="rasterize every active visual to PNGs in this "
                    "directory at display rate (the headless render loop; "
                    "bulk panes need --fetch full)")
    pv.add_argument("--render-every", type=float, default=0.5,
                    help="seconds between rendered frames for --render-dir")
    pv.add_argument("--theme",
                    help="theme for --render-dir (default: the persisted "
                    "ui.theme from --settings, else builtin default)")
    pv.add_argument("--themes-dir", default="themes",
                    help="theme store directory (default: themes/)")
    pv.add_argument("--ingest-only", action="store_true",
                    help="host-only ingest benchmark (no device work)")
    pv.add_argument("--checkpoint",
                    help="carry checkpoint path: restore on start if it "
                    "exists; save on exit and on SIGTERM/SIGINT")
    pv.set_defaults(fn=cmd_serve)

    pp = sub.add_parser(
        "precompile",
        help="trace+compile the engine step into the persistent JAX "
        "compilation cache, so a production `serve` starts warm",
    )
    pp.add_argument("--streams", type=int, default=256)
    pp.add_argument("--scan-hops", type=int, default=1)
    pp.add_argument("--settings", help="precompile a persisted settings JSON")
    pp.add_argument("--config", choices=["serve", "default"], default="serve",
                    help="'serve': the serve command's engine config; "
                    "'default': the stock EngineConfig() (all six analyzers, "
                    "reassignment on)")
    pp.set_defaults(fn=cmd_precompile)

    ps = sub.add_parser("settings", help="settings utilities")
    ps.add_argument("--init", required=True, help="write default settings JSON")
    ps.set_defaults(fn=cmd_settings)

    pth = sub.add_parser(
        "themes",
        help="theme store: list/show/create/edit palettes (headless "
        "palette editor)",
    )
    pth.add_argument("action",
                     choices=["list", "show", "create", "set-stop", "delete"])
    pth.add_argument("name", nargs="?", help="theme name")
    pth.add_argument("visual", nargs="?",
                     help="visual whose palette to edit (set-stop)")
    pth.add_argument("--dir", default="themes",
                     help="theme store directory (default: themes/)")
    pth.add_argument("--base", default="default",
                     help="base theme for create (default: default)")
    pth.add_argument("--stop", type=int, default=0,
                     help="stop index for set-stop")
    pth.add_argument("--color", help="R,G,B[,A] floats in [0,1] for set-stop")
    pth.add_argument("--position", type=float,
                     help="interior stop position in (0,1) for set-stop")
    pth.add_argument("--spread", type=float, help="stop spread for set-stop")
    pth.set_defaults(fn=cmd_themes)

    pt = sub.add_parser("selftest", help="end-to-end smoke test")
    pt.set_defaults(fn=cmd_selftest)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
