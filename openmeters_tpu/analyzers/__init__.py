"""L3 analyzers: the six OpenMeters meters as batched pure step functions.

Each analyzer is a frozen config dataclass exposing:

- ``init(n_streams) -> carry``  — zeroed per-stream state pytree
- ``step(carry, block, ...) -> (carry, snapshot)`` — pure, jit-safe, batched
  over ``[n_streams, ...]``; ``block`` is one engine hop of audio

mirroring the reference's ``Processor::new / process_block / reset_audio``
surface (``src/visuals/*/processor.rs``) with resets expressed as per-stream
masks.  Dynamic-length reference outputs (columns, point lists) become
fixed-capacity arrays plus validity masks — static shapes for XLA.
"""

from openmeters_tpu.analyzers.loudness import LoudnessAnalyzer, LoudnessConfig  # noqa: F401
from openmeters_tpu.analyzers.spectrogram import (  # noqa: F401
    SpectrogramAnalyzer,
    SpectrogramConfig,
)
from openmeters_tpu.analyzers.spectrum import (  # noqa: F401
    AveragingMode,
    SpectrumAnalyzer,
    SpectrumConfig,
)
