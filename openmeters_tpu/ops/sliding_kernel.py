"""Fused classic sliding-DFT hop for NVIDIA GPUs (Pallas, Triton route).

The XLA sliding path (``SlidingSTFT.step``) runs each of the hop's
``cols`` columns as two cuBLAS delta dots plus elementwise fusions, and
every column re-reads and re-writes the ``[S, bins]`` re/im state through
device memory.  Here the delta spectra of all columns come from one
batched cuBLAS dot (``[S, cols, hop] x [hop, bins]``, full f32), and this
kernel does the rest of the hop: one block owns a ``[TS streams, BB bins]``
tile, keeps its state in registers across all columns (one read and one
write of the state), and writes the u16 dB codes straight out.

The frequency-domain window stencil reads neighbouring bins ``k +- j``.
Triton has no lane shift, so each block slides ``2J + 1`` copies of its
state, one per stencil offset, each loaded at its shifted bins with the
delta spectra and rotations of those bins (the slide is independent per
bin, so a shifted copy slides exactly like the bins it was read from; the
shifted loads hit the cache lines of the neighbouring lanes).  The
hermitian edges fold in through the load indices: bin ``-m`` reads bin
``m`` and bin ``bins - 1 + m`` reads ``bins - 1 - m``, with the imaginary
part negated.  The periodic exact re-anchor stays outside the kernel as a
carry substitution (``SlidingSTFT.step_fused``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from openmeters_tpu.utils.level import LN_TO_DB

STORE_LO = -144.0  # spectrogram u16 code domain (processor.rs:63-68)
STORE_SCALE = 65535.0 / 156.0

# block shape and launch parameters (powers of two, as Triton requires);
# the fastest of six shapes timed on the card (PERF.md)
ROW_TILE = 16
BIN_TILE = 128
NUM_WARPS = 4


def kernel_supported(hop: int, bins: int, n_coeffs: int) -> bool:
    """Shapes the kernel handles: a stencil no wider than the bin tile and
    hops short enough that sliding beats a per-column transform."""
    return 1 <= n_coeffs <= 4 and bins >= 2 * n_coeffs and hop <= 256


def _reflect(idx, bins: int):
    """Hermitian fold of a bin index: ``(source bin, imag sign)``."""
    r = jnp.abs(idx)
    r = jnp.where(r > bins - 1, 2 * (bins - 1) - r, r)
    r = jnp.clip(r, 0, bins - 1)  # lanes past the last tile: masked later
    folded = (idx < 0) | (idx > bins - 1)
    return r, jnp.where(folded, -1.0, 1.0).astype(jnp.float32)


def _build(*, cols, bins, n, coeffs, floor_db, ts, bb):
    a0 = float(coeffs[0])
    halves = [0.5 * float(a) for a in coeffs[1:]]
    reach = len(halves)
    offsets = list(range(-reach, reach + 1))

    def kern(ready_ref, fr_ref, fi_ref, dr_ref, di_ref, rr_ref, ri_ref,
             dc_ref, nm_ref, ofr_ref, ofi_ref, out_ref):
        s_total = fr_ref.shape[0]
        r0 = pl.program_id(0) * ts
        l0 = pl.program_id(1) * bb
        rows = r0 + jnp.arange(ts)
        row_ok = rows < s_total
        rows = jnp.minimum(rows, s_total - 1)  # loads only; stores mask
        lanes = l0 + jnp.arange(bb)
        lane_ok = lanes < bins
        ready = plgpu.load(ready_ref.at[0])

        # one (re, im) state copy per stencil offset, at its shifted bins
        src, sgn, fr, fi, rr, ri = {}, {}, {}, {}, {}, {}
        for j in offsets:
            src[j], sgn[j] = _reflect(lanes + j, bins)
            at = (rows[:, None], src[j][None, :])
            fr[j] = plgpu.load(fr_ref.at[at])
            fi[j] = plgpu.load(fi_ref.at[at])
            rr[j] = plgpu.load(rr_ref.at[src[j]])[None, :]
            ri[j] = plgpu.load(ri_ref.at[src[j]])[None, :]
        dc = plgpu.load(dc_ref.at[jnp.minimum(lanes, bins - 1)])[None, :]
        nm = plgpu.load(nm_ref.at[jnp.minimum(lanes, bins - 1)])[None, :]
        first = (lanes == 0)[None, :]
        out_mask = row_ok[:, None] & lane_ok[None, :]

        for k in range(cols):
            emit = k < ready
            for j in offsets:
                at = (rows[:, None], k, src[j][None, :])
                tr = fr[j] + plgpu.load(dr_ref.at[at])
                ti = fi[j] + plgpu.load(di_ref.at[at])
                fr[j] = jnp.where(emit, tr * rr[j] - ti * ri[j], fr[j])
                fi[j] = jnp.where(emit, tr * ri[j] + ti * rr[j], fi[j])

            wr = a0 * fr[0]
            wi = a0 * fi[0]
            for j, half in enumerate(halves, start=1):
                wr = wr + half * (fr[-j] + fr[j])
                wi = wi + half * (sgn[-j] * fi[-j] + sgn[j] * fi[j])
            # DC removal: the mean is bin 0 / n; dc is non-zero only in the
            # first bin tile, whose lane 0 is bin 0
            mean = jnp.sum(jnp.where(first, fr[0], 0.0), axis=1) * (1.0 / n)
            wr = wr - mean[:, None] * dc
            p = (wr * wr + wi * wi) * nm
            db = jnp.maximum(jnp.log(jnp.maximum(p, 1e-45)) * LN_TO_DB, floor_db)
            code = jnp.floor((db - STORE_LO) * STORE_SCALE + 0.5)
            code = jnp.clip(code, 0.0, 65535.0).astype(jnp.uint16)
            plgpu.store(
                out_ref.at[pl.ds(r0, ts), k, pl.ds(l0, bb)], code, mask=out_mask
            )

        tile = (pl.ds(r0, ts), pl.ds(l0, bb))
        plgpu.store(ofr_ref.at[tile], fr[0], mask=out_mask)
        plgpu.store(ofi_ref.at[tile], fi[0], mask=out_mask)

    return kern


@functools.partial(
    jax.jit,
    static_argnames=("n", "coeffs", "floor_db", "interpret"),
)
def sliding_hop(
    ready, fr, fi, dr, di, rot_r, rot_i, dc_corr, norm, *,
    n: int, coeffs: tuple, floor_db: float, interpret: bool = False,
):
    """One fused hop.

    Args:
      ready: int32 scalar, columns to emit this hop.
      fr, fi: ``[S, bins]`` sliding spectrum state.
      dr, di: ``[S, cols, bins]`` per-column delta spectra.
      rot_r, rot_i, dc_corr, norm: ``[bins]`` rows.

    Returns ``(fr2, fi2, codes)``: the new state and ``[S, cols, bins]``
    u16 dB codes.
    """
    s, bins = fr.shape
    cols = dr.shape[1]
    kern = _build(
        cols=cols, bins=bins, n=n, coeffs=coeffs, floor_db=float(floor_db),
        ts=ROW_TILE, bb=BIN_TILE,
    )
    grid = (pl.cdiv(s, ROW_TILE), pl.cdiv(bins, BIN_TILE))
    # under shard_map the outputs vary over the stream axes like the state
    vma = jax.typeof(fr).vma
    return pl.pallas_call(
        kern,
        grid=grid,
        out_shape=[
            jax.ShapeDtypeStruct((s, bins), jnp.float32, vma=vma),
            jax.ShapeDtypeStruct((s, bins), jnp.float32, vma=vma),
            jax.ShapeDtypeStruct((s, cols, bins), jnp.uint16, vma=vma),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="sliding_hop",
    )(*[
        _vary(jnp.asarray(x, dtype), vma)
        for x, dtype in (
            (jnp.reshape(ready, (1,)), jnp.int32), (fr, jnp.float32),
            (fi, jnp.float32), (dr, jnp.float32), (di, jnp.float32),
            (rot_r, jnp.float32), (rot_i, jnp.float32),
            (dc_corr, jnp.float32), (norm, jnp.float32),
        )
    ])


def _vary(x, vma):
    """Mark ``x`` as varying over the manual mesh axes ``vma`` (shard_map's
    type check wants every kernel operand on the same axes)."""
    missing = tuple(sorted(set(vma) - set(jax.typeof(x).vma)))
    return jax.lax.pcast(x, missing, to="varying") if missing else x
