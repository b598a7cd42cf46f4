"""Process-snapshot environment flags.

Flags that influence *traced* code (anything read inside a jitted step, or
anything that gates a carry pytree's structure) must be read exactly once
per process: jit caches compiled programs by static arguments only, so a
mid-process env change would apply to some cached traces and not others.
This module is the one sanctioned way to read such a flag — an
``lru_cache``'d snapshot, with a test-only reset hook.

Flags that are read host-side at *config/build* time (e.g. the sliding
reassigned path switch, consulted when an analyzer object is constructed)
may stay dynamic so tests can exercise both paths in one process; they are
listed in README.md alongside the snapshot flags.  No flag selects a
kernel or a precision: those follow from the platform and the shapes.
"""

from __future__ import annotations

import functools
import os

_FALSY = ("", "0", "false", "no", "off")


@functools.lru_cache(maxsize=None)
def snapshot_flag(name: str, default: str = "") -> bool:
    """True iff env var ``name`` is set to a truthy value, snapshotted at
    first read for the life of the process."""
    return os.environ.get(name, default).strip().lower() not in _FALSY


@functools.lru_cache(maxsize=None)
def snapshot_value(name: str, default: str = "") -> str:
    """Raw env value, snapshotted at first read."""
    return os.environ.get(name, default)


def _reset_for_tests() -> None:
    """Clear the snapshots (tests only — production code must never call
    this after any jit trace has happened)."""
    snapshot_flag.cache_clear()
    snapshot_value.cache_clear()
