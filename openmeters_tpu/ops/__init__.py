"""L1 batched DSP primitives.

Every op here is a pure jit-safe function over ``[time, lanes...]`` or
``[streams, ...]`` arrays with explicit carry state, replacing the reference's
per-sample stateful Rust structs (``src/dsp.rs``) with batched
formulations:

- ``iir``       — biquads / cascades / three-band crossovers as ``lax.scan``
- ``windowed``  — trailing-window running means as drift-free block-sum rings
- ``truepeak``  — libebur128-compatible polyphase interpolating FIR peaks
- ``framing``   — streaming hop/window extraction from right-aligned rings
- ``nsdf``      — normalized autocorrelation (McLeod) period detection
"""

from openmeters_tpu.ops.iir import (  # noqa: F401
    FilterKind,
    biquad_rbj,
    biquad_cascade_scan,
    iir_df2t_scan,
    three_band_scan,
    three_band_init,
    flush_denormal_state,
)
from openmeters_tpu.ops.windowed import BlockWindowedMeans  # noqa: F401
from openmeters_tpu.ops.truepeak import TruePeakKernel  # noqa: F401
from openmeters_tpu.ops.framing import FrameBuffer  # noqa: F401
from openmeters_tpu.ops.fft import fft_mxu, ifft_mxu, irfft_mxu, rfft_mxu  # noqa: F401
