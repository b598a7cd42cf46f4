"""Stream-parallel scale-out over a device mesh.

The reference's "distributed layer" is intra-process lock-free rings between
a PipeWire thread and the GUI thread (SURVEY §2.9).  The batched analogue:
streams are embarrassingly parallel, so the whole engine step runs SPMD over
a 1-D ``Mesh`` with every stream-indexed array sharded on that axis — XLA
inserts **zero collectives** in the hot loop; the links between cards are
used only if a future analyzer wants cross-stream reductions.  Multi-host
deployments add more streams with no cross-host traffic (pure DP).

Works identically on N GPUs and on
``--xla_force_host_platform_device_count=N`` virtual CPU devices (tests).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STREAM_AXIS = "streams"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D stream-parallel mesh over ``n_devices`` (default: all available).

    Raises when fewer than ``n_devices`` devices exist — silently truncating
    would make an "8-way" run a 1-way run without anyone noticing.
    """
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} device(s) are available "
                f"(platform={devices[0].platform}); for a virtual mesh set "
                "XLA_FLAGS=--xla_force_host_platform_device_count=N and "
                "JAX_PLATFORMS=cpu before JAX initializes"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (STREAM_AXIS,))


def make_multihost_mesh(n_hosts: int, per_host: int) -> Mesh:
    """2-D ``(hosts, cards)`` mesh: hosts on the outer axis, each host's
    cards on the inner axis.

    Streams are embarrassingly parallel, so every stream-indexed array
    shards its leading dim over *both* axes (``P(("hosts", "cards"), ...)`` via
    ``sharded_step(..., axis=("hosts", "cards"))``) — pure DP means XLA
    inserts no collective on either axis; the network carries only each
    host's own feed (SURVEY §5.8).
    """
    devices = jax.devices()
    need = n_hosts * per_host
    if len(devices) < need:
        raise ValueError(
            f"requested a {n_hosts}x{per_host} mesh but only "
            f"{len(devices)} device(s) are available"
        )
    grid = np.asarray(devices[:need]).reshape(n_hosts, per_host)
    return Mesh(grid, ("hosts", "cards"))


def _trace_args(engine, s, lead=()):
    """ShapeDtypeStructs for one engine step at ``s`` streams: ``(carry,
    block[*lead, s, b, c], meta, reset[*lead, s])``."""
    from openmeters_tpu.engine.engine import StreamMeta

    b = engine.config.block_frames
    c = engine.config.channels
    carry = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), engine.init(s)
    )
    block = jax.ShapeDtypeStruct((*lead, s, b, c), jnp.float32)
    meta = StreamMeta(
        fold=jax.ShapeDtypeStruct((s, c, 2), jnp.float32),
        weights=jax.ShapeDtypeStruct((s, c), jnp.float32),
    )
    reset = jax.ShapeDtypeStruct((*lead, s), jnp.bool_)
    return carry, block, meta, reset


def _derive_pspecs(axis, shapes_fn):
    """PartitionSpecs derived mechanically: evaluate ``shapes_fn`` (a pytree
    of ShapeDtypeStructs as a function of the stream count) at three stream
    counts and mark the dims that scale with ``n_streams`` as the stream
    dims (covers lane-flattened layouts like the oscilloscope's
    ``[S * n_trig]`` without per-analyzer annotations).

    Three trace points (8, 16, 24) + an exact cross-multiplied
    proportionality check reject dims that merely *correlate* with the
    stream count — an affine ``k*S + c`` or nonlinear dim would concatenate
    to the wrong global shape under ``shard_map``'s local->global shape rule,
    so it must fail loudly at trace time, not silently at reassembly."""
    s1, s2, s3 = 8, 16, 24
    snaps1, snaps2, snaps3 = shapes_fn(s1), shapes_fn(s2), shapes_fn(s3)

    def derive(l1, l2, l3):
        dims = []
        for d1, d2, d3 in zip(l1.shape, l2.shape, l3.shape):
            if d1 == d2 == d3:
                dims.append(None)
                continue
            # exact proportionality through the origin: d(s) = k*s for one
            # rational k (integer cross-multiplication — no float tolerance)
            if not (d1 * s2 == d2 * s1 and d1 * s3 == d3 * s1):
                raise ValueError(
                    f"snapshot leaf dim scales with n_streams but not "
                    f"proportionally ({d1}@S={s1}, {d2}@S={s2}, {d3}@S={s3}; "
                    f"shapes {l1.shape}/{l2.shape}/{l3.shape}); shard_map "
                    f"would reassemble it to the wrong global shape — give "
                    f"this leaf an explicit PartitionSpec"
                )
            dims.append(axis)
        n_stream_dims = sum(d is not None for d in dims)
        assert n_stream_dims <= 1, (
            f"snapshot leaf {l1.shape}->{l2.shape} scales with n_streams in "
            f"{n_stream_dims} dims; cannot infer a stream sharding"
        )
        return P(*dims)

    return jax.tree.map(derive, snaps1, snaps2, snaps3)


def _snapshot_pspecs(engine, axis):
    """Engine-step snapshot PartitionSpecs (see :func:`_derive_pspecs`)."""

    def shapes(s):
        _, snaps = jax.eval_shape(engine.step, *_trace_args(engine, s))
        return snaps

    return _derive_pspecs(axis, shapes)


def _spectrum_snap_pspecs(engine, axis):
    """Cadenced-spectrum-step snapshot PartitionSpecs."""
    r = engine.spectrum_cadence

    def shapes(s):
        carry, block, meta, reset = _trace_args(engine, s)
        blocks = jax.ShapeDtypeStruct((r, *block.shape), block.dtype)
        _, snap = jax.eval_shape(
            engine.spectrum_step, carry["spectrum"], blocks, meta, reset
        )
        return snap

    return _derive_pspecs(axis, shapes)


def sharded_step(engine, mesh: Mesh, donate_carry: bool = False, axis=STREAM_AXIS):
    """Jit the engine step SPMD over ``mesh`` via ``shard_map``.

    Each device runs the full step on its local stream shard, so cross-device
    traffic is impossible by construction — under plain ``jit`` +
    ``NamedSharding`` XLA's sharding propagation inserted real collectives
    (all-to-alls from the rFFT pair-packing reshape coupling adjacent
    streams across shard boundaries, collective-permutes of the paired
    spectra, an all-reduce for ``any(reset)``); ``shard_map`` removes them
    all (asserted on the compiled HLO in ``tests/test_engine.py``).  Scalar
    re-anchor decisions (``any(reset_mask)`` refresh gates) become
    shard-local, which only narrows their blast radius.

    Returns ``(step_fn, place_carry)``: ``step_fn(carry, block, meta, reset)``
    with all stream-indexed leaves sharded on ``axis`` (an axis name, or a
    tuple of mesh axes — e.g. ``("hosts", "cards")`` for a multi-host mesh);
    ``place_carry`` shards an engine carry pytree onto the mesh.
    ``donate_carry`` donates the carry buffers (serving loops update state
    in place).  Sharded dims must divide evenly by the mesh size.
    """
    carry_specs = engine.carry_pspecs(axis)
    snap_specs = _snapshot_pspecs(engine, axis)

    from openmeters_tpu.engine.engine import StreamMeta

    meta_specs = StreamMeta(fold=P(axis, None, None), weights=P(axis, None))
    block_spec = P(axis, None, None)
    reset_spec = P(axis)

    mapped = jax.shard_map(
        lambda carry, block, meta, reset: engine.step(carry, block, meta, reset),
        mesh=mesh,
        in_specs=(carry_specs, block_spec, meta_specs, reset_spec),
        out_specs=(carry_specs, snap_specs),
        check_vma=True,  # varying-mesh-axes tracking statically proves the
        # replicated scalar carries (tick/origin) stay replicated and that
        # no per-stream value leaks into a P() output
    )
    step = jax.jit(mapped, donate_argnums=(0,) if donate_carry else ())
    return step, _placer(mesh, carry_specs)


def sharded_spectrum_step(engine, mesh: Mesh, donate_carry: bool = False,
                          axis=STREAM_AXIS):
    """The cadenced spectrum hop (``engine.spectrum_step``) over ``mesh``,
    with the same shard_map zero-collective guarantee as
    :func:`sharded_step`.  Returns ``fn(spectrum_carry, blocks[R, S, B, C],
    meta, reset)``."""
    from openmeters_tpu.engine.engine import StreamMeta

    sp_specs = engine.carry_pspecs(axis)["spectrum"]
    snap_specs = _spectrum_snap_pspecs(engine, axis)
    meta_specs = StreamMeta(fold=P(axis, None, None), weights=P(axis, None))

    mapped = jax.shard_map(
        lambda c, blocks, meta, reset: engine.spectrum_step(
            c, blocks, meta, reset
        ),
        mesh=mesh,
        in_specs=(sp_specs, P(None, axis, None, None), meta_specs, P(None, axis)),
        out_specs=(sp_specs, snap_specs),
        check_vma=True,
    )
    return jax.jit(mapped, donate_argnums=(0,) if donate_carry else ())


def scan_last_snapshot_fn(engine):
    """``fn(carry, blocks[K, S, B, C], meta, resets[K, S])``: K engine hops
    in one on-device scan — the first K-1 snapshots are discarded (XLA
    dead-code-eliminates their compute), the final hop's snapshot is
    returned.  With a cadenced spectrum, K must be a multiple of the cadence
    and the snapshot gains the final spectrum hop's output.  Shared by
    ``serve.py``'s unsharded ``--scan-hops`` mode and
    :func:`sharded_scan_step`."""
    r = engine.spectrum_cadence

    def scan_fn(carry, blocks, meta, resets):
        k = blocks.shape[0]

        def body(c, xr):
            blk, rst = xr
            c, _ = engine.step(c, blk, meta, rst)
            return c, None

        carry, _ = jax.lax.scan(body, carry, (blocks[:-1], resets[:-1]))
        carry, snaps = engine.step(carry, blocks[-1], meta, resets[-1])
        if r > 1:
            if k % r:
                raise ValueError(
                    f"scan_hops ({k}) must be a multiple of the spectrum "
                    f"cadence ({r})"
                )
            groups = blocks.reshape(k // r, r, *blocks.shape[1:])
            # per-hop [r, S] reset groups: spectrum_step zeroes pre-reset
            # blocks so no old-generation audio enters the window
            rgroups = resets.reshape(k // r, r, resets.shape[1])
            sp = carry["spectrum"]
            if k // r > 1:

                def sp_body(c, xr):
                    blkg, rstg = xr
                    c, _ = engine.spectrum_step(c, blkg, meta, rstg)
                    return c, None

                sp, _ = jax.lax.scan(
                    sp_body, sp, (groups[:-1], rgroups[:-1])
                )
            sp, sp_snap = engine.spectrum_step(sp, groups[-1], meta, rgroups[-1])
            carry = dict(carry, spectrum=sp)
            snaps = dict(snaps, spectrum=sp_snap)
        return carry, snaps

    return scan_fn


def sharded_scan_step(engine, mesh: Mesh, scan_hops: int,
                      donate_carry: bool = False, axis=STREAM_AXIS):
    """:func:`scan_last_snapshot_fn` over the mesh — ``serve.py``'s
    ``--scan-hops`` dispatch-amortization mode with the same shard_map
    zero-collective guarantee as :func:`sharded_step`."""
    carry_specs = engine.carry_pspecs(axis)
    inner = scan_last_snapshot_fn(engine)

    def snap_shapes(s):
        args = _trace_args(engine, s, lead=(scan_hops,))
        _, snaps = jax.eval_shape(inner, *args)
        return snaps

    snap_specs = _derive_pspecs(axis, snap_shapes)

    from openmeters_tpu.engine.engine import StreamMeta

    meta_specs = StreamMeta(fold=P(axis, None, None), weights=P(axis, None))
    blocks_spec = P(None, axis, None, None)
    resets_spec = P(None, axis)

    def scan_fn(carry, blocks, meta, resets):
        assert blocks.shape[0] == scan_hops, (blocks.shape, scan_hops)
        return inner(carry, blocks, meta, resets)

    mapped = jax.shard_map(
        scan_fn,
        mesh=mesh,
        in_specs=(carry_specs, blocks_spec, meta_specs, resets_spec),
        out_specs=(carry_specs, snap_specs),
        check_vma=True,
    )
    step = jax.jit(mapped, donate_argnums=(0,) if donate_carry else ())
    return step, _placer(mesh, carry_specs)


def _placer(mesh: Mesh, carry_specs):
    def shard(spec):
        return NamedSharding(mesh, spec)

    carry_sh = jax.tree.map(shard, carry_specs, is_leaf=lambda x: isinstance(x, P))

    def place_carry(carry):
        return jax.device_put(carry, carry_sh)

    return place_carry
