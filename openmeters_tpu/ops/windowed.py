"""Trailing-window running means over streaming blocks, drift-free.

Reference parity: ``WindowedMeans`` / ``CompensatedPair`` in
``src/dsp.rs:264-371`` — Kahan-Babuska-Neumaier compensated running means over
multiple window lengths sharing one sample ring.

Batched formulation: the reference pushes per-sample into f64 compensated sums
and periodically refreshes dual accumulators to kill drift.  Here samples
arrive in fixed ``block_frames`` blocks and means are only read at block
boundaries (exactly how the loudness processor consumes them), so we keep a
ring of **per-block sums** plus, per window, a ring of **suffix sums of the
last ``W mod B`` samples** of each block.  A trailing window of ``W`` samples
ending on a block boundary is then ``q = W // B`` whole-block sums plus one
stored suffix — recomputed fresh from the ring on every query, so there is
*zero* accumulation drift (stronger than Kahan), in float32, at a few hundred
FLOPs per lane.

Warmup and the reference's lazy-silence seeding (``with_leading_zeros``,
dsp.rs:359-365) reduce to a per-lane ``blocks`` counter: the mean divisor is
``clamp(blocks * B, 1, W)`` and ring slots older than the counter are masked
out, which also makes per-lane resets free (no ring zeroing).

The whole-block part of each window is additionally tracked as an
**incremental running sum** (add the entering block, subtract the block
whose age just reached ``q = W // B``, both single ring rows) so queries
never re-reduce the ring (the 3 s window ring is 563 blocks — ~500 MB of
masked reads per step at 16k streams).  An exact masked re-reduction runs
every ``refresh_steps`` pushes under one scalar ``lax.cond``, bounding f32
accumulation drift to ~1e-6 relative — two orders below the 0.001 LU bar.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class BlockWindowedMeans:
    """Static config: query means of pushed values over trailing windows.

    Args:
      block_frames: samples per pushed block (engine hop), ``B``.
      window_lengths: trailing window sizes in samples, one per window.
    """

    block_frames: int
    window_lengths: tuple[int, ...]
    dtype: object = jnp.float32
    refresh_steps: int = 32  # exact re-reduction cadence (drift bound)

    def __post_init__(self):
        # the ~1e-6 incremental-drift bound in the soak test is tied to this
        # cadence; 0 would divide by zero at trace time, and raising it
        # weakens the bound — revalidate test_ops soak if changed
        if self.refresh_steps < 1:
            raise ValueError(f"refresh_steps must be >= 1, got {self.refresh_steps}")

    @property
    def _qr(self):
        b = self.block_frames
        return tuple((max(w, 1) // b, max(w, 1) % b) for w in self.window_lengths)

    @property
    def ring_blocks(self) -> int:
        return max(q + 1 for q, _ in self._qr)

    def init(self, lane_shape: tuple[int, ...]) -> dict:
        k = self.ring_blocks
        nw = len(self.window_lengths)
        return {
            "totals": jnp.zeros((k, *lane_shape), self.dtype),
            "suffix": jnp.zeros((k, nw, *lane_shape), self.dtype),  # slot-major
            "sums": jnp.zeros((nw, *lane_shape), self.dtype),
            "comp": jnp.zeros((nw, *lane_shape), self.dtype),
            "head": jnp.zeros((), jnp.int32),
            "blocks": jnp.zeros(lane_shape, jnp.int32),
        }

    def _exact_sums(self, totals, head, blocks):
        """Masked re-reduction of the whole-block window sums (exact)."""
        k = self.ring_blocks
        lane_nd = blocks.ndim
        ages = (head - 1 - jnp.arange(k, dtype=jnp.int32)) % k
        ages = ages.reshape((k,) + (1,) * lane_nd)
        blk = blocks[None]
        out = []
        for q, _ in self._qr:
            full = (ages < q) & (ages < blk)
            out.append(jnp.sum(jnp.where(full, totals, 0.0), axis=0))
        return jnp.stack(out)

    def push_block(self, carry: dict, values, reset_mask=None) -> dict:
        """Push one ``[B, lanes...]`` block of values.

        Non-finite values are sanitized to 0 (reference dsp.rs:324-333).
        ``reset_mask`` (``[lanes...]`` bool) restarts those lanes' windows as
        if freshly constructed.
        """
        b = self.block_frames
        k = self.ring_blocks
        assert values.shape[0] == b
        values = jnp.where(jnp.isfinite(values), values, 0.0).astype(self.dtype)

        blocks = carry["blocks"]
        sums = carry["sums"]
        comp = carry["comp"]
        if reset_mask is not None:
            blocks = jnp.where(reset_mask, 0, blocks)
            sums = jnp.where(reset_mask[None], 0.0, sums)
            comp = jnp.where(reset_mask[None], 0.0, comp)

        head = carry["head"]
        slot = head % k
        total = jnp.sum(values, axis=0)
        suffixes = jnp.stack(
            [
                jnp.sum(values[b - r :], axis=0) if r > 0 else jnp.zeros_like(total)
                for _, r in self._qr
            ]
        )

        def kbn(s, c, v):
            """Kahan-Babuska-Neumaier compensated add (dsp.rs:305-316)."""
            t = s + v
            c = c + jnp.where(
                jnp.abs(s) >= jnp.abs(v), (s - t) + v, (v - t) + s
            )
            return t, c

        # incremental whole-block sums: - the block whose age reaches q
        # after this push, + the entering block (subtract FIRST so an
        # expiring large value cancels against itself before small adds;
        # KBN compensation holds what f32 absorption would drop — the
        # reference's Kahan pattern, dsp.rs:264-371).  Masked so blocks
        # from before a lane's reset — never added — are never subtracted.
        blocks_after = jnp.minimum(blocks + 1, jnp.int32(2**30))
        # update the ring FIRST so XLA aliases the .at[].set in place; the
        # leaving rows (slot (head - q) % k, q in [1, k-1]) are untouched by
        # the write, so reading them from the updated ring is equivalent
        totals = carry["totals"].at[slot].set(total)
        new_sums, new_comp = [], []
        for w_idx, (q, _) in enumerate(self._qr):
            s, c = sums[w_idx], comp[w_idx]
            if q > 0:
                leave = jax.lax.dynamic_index_in_dim(
                    totals, (head - q) % k, axis=0, keepdims=False
                )
                s, c = kbn(s, c, -jnp.where(blocks_after > q, leave, 0.0))
                s, c = kbn(s, c, total)
            new_sums.append(s)
            new_comp.append(c)
        sums = jnp.stack(new_sums)
        comp = jnp.stack(new_comp)

        head_next = head + 1

        # periodic exact refresh under one scalar cond kills residual drift
        sums, comp = jax.lax.cond(
            head_next % self.refresh_steps == 0,
            lambda: (
                self._exact_sums(totals, head_next, blocks_after),
                jnp.zeros_like(comp),
            ),
            lambda: (sums, comp),
        )

        return {
            "totals": totals,
            # slot-major: a leading-dim row update XLA aliases in place
            "suffix": carry["suffix"].at[slot].set(suffixes),
            "sums": sums,
            "comp": comp,
            "head": head_next,
            "blocks": blocks_after,
        }

    def means(self, carry: dict):
        """Current trailing means, ``[n_windows, lanes...]``.

        Divisor is ``max(1, min(samples_pushed, W))`` matching reference
        ``WindowedMeans::mean`` (dsp.rs:367-371).
        """
        k = self.ring_blocks
        b = self.block_frames
        head = carry["head"]
        blocks = carry["blocks"]

        out = []
        for w_idx, (q, r) in enumerate(self._qr):
            total = carry["sums"][w_idx] + carry["comp"][w_idx]
            if r > 0:
                # the stored suffix of the block at age q (one ring row)
                pick = jax.lax.dynamic_index_in_dim(
                    carry["suffix"], (head - 1 - q) % k, axis=0,
                    keepdims=False,
                )[w_idx]
                total = total + jnp.where(blocks > q, pick, 0.0)
            count = jnp.clip(
                blocks.astype(self.dtype) * b,
                1.0,
                float(max(self.window_lengths[w_idx], 1)),
            )
            out.append(total / count)
        return jnp.stack(out)
