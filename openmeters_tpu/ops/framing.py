"""Streaming hop/window frame extraction with fixed-capacity outputs.

Reference parity: the deque-buffer + hop bookkeeping shared by the
spectrogram and spectrum processors (``spectrogram/processor.rs:281-437``,
``spectrum/processor.rs:179-298``): a window of ``read_len`` samples is ready
whenever the buffer holds at least that many; each emitted window advances
the timeline by ``hop`` samples; hops larger than the buffer produce a
pending-skip debt (``pending_skip_samples``) so output is block-partition
independent.

Batched formulation: a **double-written rotating ring** ``[lanes, 2 * cap]``
with a *global* scalar write origin shared by all lanes.  Every ingested
block is written twice — at ``origin`` and ``origin + cap`` — so any
window of length <= cap is contiguous somewhere in the buffer and every
read stays one cheap scalar-offset ``lax.dynamic_slice`` (contiguous)
instead of a per-lane gather.  Writing 2*B samples per step
replaces the previous shift-left ring's O(cap) read+write of the whole
buffer (~150 MB/step at 16k streams) with O(B) stores that XLA aliases
in-place in the scan carry.

Per-lane resets are expressed as a post-reset sample counter: a window is
valid for a lane only when every sample in it is post-reset, which
reproduces the reference's ``reset_audio``-then-refill values exactly; the
only deviation is that a reset lane's first column lands on the global hop
grid rather than exactly ``read_len`` samples after the reset (a sub-hop
timing shift, values identical).  Since each step ingests a fixed ``B``
frames, at most ``cols_cap = (B-1)//hop + 1`` windows become ready per
step: outputs are a fixed ``[lanes, cols_cap, read_len]`` batch plus a
validity mask.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class FrameBuffer:
    read_len: int  # samples per analysis window (fft or hilbert length)
    hop: int
    block: int  # engine ingest frames per step (B)

    @property
    def cols_cap(self) -> int:
        return (self.block - 1) // self.hop + 1

    @property
    def cap(self) -> int:
        """Logical ring capacity: one extra hop of history so sliding-DFT
        consumers can read the samples that just left the oldest ready
        window; rounded up to a whole number of blocks so the rotating
        write origin never wraps mid-block."""
        need = self.read_len + self.block + self.hop
        return -(-need // self.block) * self.block

    @property
    def ring_len(self) -> int:
        """Physical buffer length (mirrored halves)."""
        return 2 * self.cap

    def init(self, lanes: int) -> dict:
        return {
            "buf": jnp.zeros((lanes, self.ring_len), jnp.float32),
            "origin": jnp.zeros((), jnp.int32),  # next write slot in [0, cap)
            "avail": jnp.zeros((), jnp.int32),  # global hop phase
            "fresh": jnp.zeros((lanes,), jnp.int32),  # post-reset samples
        }

    def advance(self, carry: dict, block, reset_mask=None):
        """Ingest ``[lanes, B]`` samples; compute hop bookkeeping only.

        Returns ``(new_carry, info)`` where info holds the buffer, the
        scalar window ``base`` index / ``ready`` count and the per-lane
        ``valid [lanes, cols_cap]`` mask.  Frame extraction is separate
        (:meth:`extract`) so cheap consumers (sliding DFT) can slice less.
        """
        b = self.block
        cap = self.cap
        assert block.shape[-1] == b
        fresh = carry["fresh"]
        if reset_mask is not None:
            fresh = jnp.where(reset_mask, 0, fresh)
        fresh = jnp.minimum(fresh + b, jnp.int32(2**30))

        origin = carry["origin"]
        block = block.astype(jnp.float32)
        buf = jax.lax.dynamic_update_slice(
            carry["buf"], block, (jnp.int32(0), origin)
        )
        buf = jax.lax.dynamic_update_slice(
            buf, block, (jnp.int32(0), origin + cap)
        )
        end = origin + b  # one past the newest sample (in [b, cap])
        avail_p = jnp.minimum(carry["avail"] + b, cap)

        ready = jnp.where(
            avail_p >= self.read_len,
            (avail_p - self.read_len) // self.hop + 1,
            0,
        )
        ready = jnp.clip(ready, 0, self.cols_cap)  # scalar

        # lane validity: the window must be entirely post-reset.  Window k
        # ends (ready - 1 - k) * hop samples before the newest sample.
        k = jnp.arange(self.cols_cap, dtype=jnp.int32)
        tail = (ready - 1 - k) * self.hop  # [cap]
        valid = (k[None, :] < ready) & (
            fresh[:, None] >= self.read_len + jnp.maximum(tail, 0)[None, :]
        )

        new_carry = {
            "buf": buf,
            "origin": (origin + b) % cap,
            "avail": avail_p - ready * self.hop,
            "fresh": fresh,
        }
        info = {
            "buf": buf,
            # window k starts at buffer index base + k*hop, spans read_len;
            # base points into the mirrored buffer so any read of length
            # <= cap from base + offset is contiguous
            "base": (end - avail_p) % cap,
            "ready": ready,
            "valid": valid,
            # extras for consumers with their own window bookkeeping (the
            # sliding-reassigned path): the newest sample is at base + avail
            # and valid masks can be rebuilt with stricter freshness rules
            "avail": avail_p,
            "fresh": fresh,
            "origin_next": (origin + b) % cap,
        }
        return new_carry, info

    def extract(self, info):
        """Materialize all ready windows: ``[lanes, cols_cap, read_len]``."""
        buf, base, ready = info["buf"], info["base"], info["ready"]
        frames = []
        for k in range(self.cols_cap):
            k_eff = jnp.minimum(jnp.int32(k), jnp.maximum(ready - 1, 0))
            start = jnp.clip(
                base + k_eff * self.hop, 0, self.ring_len - self.read_len
            )
            frames.append(
                jax.lax.dynamic_slice(
                    buf, (jnp.int32(0), start), (buf.shape[0], self.read_len)
                )
            )
        return jnp.stack(frames, axis=1)

    def slice(self, info, offset, length: int):
        """Contiguous ``[lanes, length]`` slice at ``base + offset`` (scalar).

        ``offset`` may be negative (sliding-DFT consumers read the ``hop``
        samples that just left the window at offset ``-hop``): the mirrored
        double-write makes any logical start position correct via modulo —
        clipping at 0 instead silently read the *window head* whenever
        ``base + offset`` went negative (base wraps through 0 every
        ``cap/block`` steps), corrupting 1-in-``cap/block`` slides."""
        assert length <= self.cap, (length, self.cap)
        buf = info["buf"]
        start = (info["base"] + offset) % self.cap
        return jax.lax.dynamic_slice(
            buf, (jnp.int32(0), start), (buf.shape[0], length)
        )

    def push(self, carry: dict, block, reset_mask=None):
        """advance + extract (back-compat): returns (carry, frames, valid)."""
        new_carry, info = self.advance(carry, block, reset_mask)
        return new_carry, self.extract(info), info["valid"]
