"""Process setup shared by every entry point: compile cache and device.

- :func:`setup_compile_cache` places JAX's persistent compilation cache.
  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and nothing else is set;
  otherwise the cache lives at a fixed path inside the checkout
  (``<repo>/.jax_cache``, git-ignored).  The path never depends on a temp
  name, a pid or the time, because it is part of the cache's key.
- :func:`require_gpu` refuses to measure anywhere but a GPU, and
  :func:`device_summary` / :func:`card_line` name the device a number was
  taken on (JAX's view, and ``nvidia-smi``'s name and power limit).
"""

from __future__ import annotations

import os
import pathlib
import subprocess

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def cache_dir() -> str:
    """The compile-cache directory this process should use."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.
    Call before the first compilation.  Returns the directory."""
    import jax

    path = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu() -> dict:
    """The device summary, or ``SystemExit`` when JAX found no GPU: a
    measurement never falls back to the CPU."""
    dev = device_summary()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {dev['platform']!r}; "
            "measurements run on the card only"
        )
    return dev


def card_line() -> str:
    """``nvidia-smi``'s ``name, power.limit`` for each card (one line per
    card joined by ``; ``), or a note saying why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
