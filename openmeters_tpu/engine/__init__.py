"""L4 engine: hop scheduler, stream carries, device-mesh scale-out.

Reference parity: ``src/meter.rs`` (``MeterEngine``/``DspBatcher`` cadence)
and ``src/visuals/registry.rs`` (``VisualManager`` fan-out + format-generation
resets), re-shaped for SPMD: one jitted step consumes a fixed
``[n_streams, block, channels]`` batch and fans out to every enabled
analyzer; streams shard data-parallel over a ``jax.sharding.Mesh`` with zero
collectives in the hot loop.
"""

from openmeters_tpu.engine.engine import (  # noqa: F401
    EngineConfig,
    MeterEngine,
    StreamMeta,
    scaled_block_frames,
)
from openmeters_tpu.engine.sharding import (  # noqa: F401
    STREAM_AXIS,
    make_mesh,
    make_multihost_mesh,
    sharded_step,
)
