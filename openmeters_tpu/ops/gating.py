"""Gated integrated loudness (BS.1770-5) + loudness range (EBU Tech 3342),
streaming, batched over streams.

The reference omits gating entirely (no gate in
``src/visuals/loudness/processor.rs``); BASELINE.json's north star demands
it.  The formulation is libebur128-style streaming histograms, reshaped for
fixed-shape device carries:

- The gating cadence is 100 ms chunks (``0.1 * rate`` frames — exactly
  ``18.75`` engine hops at any rate, since hops scale with rate too).  A hop
  crosses at most one chunk boundary; the in-hop split is taken from a
  cumulative sum at the exact boundary offset, so gating blocks land on the
  spec's sample boundaries with **zero jitter** regardless of hop size.
- One 30-slot ring of closed chunk energies serves both block sizes:
  a momentary gating block (400 ms) is the last 4 chunks, a short-term
  block (3 s, for LRA) is the last 30.
- Closed blocks scatter (count, exact energy sum) into per-stream
  histograms over [-70, +10) LUFS at 0.1 LU — counts pick the relative
  gate's block subset (quantizing only the threshold, not the energies, so
  integrated loudness keeps full f32 accuracy), and per-bin energy sums let
  LRA percentiles read back each bin's true mean loudness instead of its
  center.
- Everything below fires inside one scalar ``lax.cond`` per hop (the chunk
  boundary is global across streams), so 18 of every 19 hops touch none of
  the [S, NBINS] state.

Gates per BS.1770-5: absolute −70 LUFS, relative −10 LU (integrated);
EBU 3342: absolute −70 LUFS, relative −20 LU, LRA = p95 − p10 of the gated
short-term distribution.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

OFFSET = -0.691  # BS.1770 constant
ABS_GATE_LUFS = -70.0
REL_GATE_LU = 10.0
LRA_REL_GATE_LU = 20.0
NBINS = 800  # [-70, +10) at 0.1 LU
BIN_LO = -70.0
BIN_WIDTH = 0.1
MOMENTARY_CHUNKS = 4  # 400 ms
SHORT_TERM_CHUNKS = 30  # 3 s


def _loudness(z):
    """z = weighted mean square -> LUFS (no floor)."""
    return OFFSET + 10.0 * jnp.log(jnp.maximum(z, 1e-38)) / jnp.log(10.0)


@dataclasses.dataclass(frozen=True)
class GatedLoudness:
    """Streaming gated-integration state machine.

    ``push_block`` consumes the per-hop K-weighted, channel-weighted squared
    samples ``wk2 [S, B]`` (already summed over channels) and returns the
    updated carry; ``integrated``/``lra`` read the cached results.
    """

    sample_rate: float = 48_000.0
    block_frames: int = 256
    floor_db: float = -99.9

    @property
    def chunk_len(self) -> int:
        return max(int(round(0.1 * self.sample_rate)), 1)

    def init(self, n_streams: int) -> dict:
        s = n_streams
        return {
            "chunk_pos": jnp.zeros((), jnp.int32),  # global cadence
            "ring_idx": jnp.zeros((), jnp.int32),
            "chunk_e": jnp.zeros((s,), jnp.float32),
            "ring": jnp.zeros((s, SHORT_TERM_CHUNKS), jnp.float32),
            "fs": jnp.zeros((s,), jnp.int32),  # frames since reset
            "pending_reset": jnp.ones((s,), bool),  # clear hists on first use
            "hist_m_n": jnp.zeros((s, NBINS), jnp.float32),
            "hist_m_e": jnp.zeros((s, NBINS), jnp.float32),
            "hist_s_n": jnp.zeros((s, NBINS), jnp.float32),
            "hist_s_e": jnp.zeros((s, NBINS), jnp.float32),
            "integrated": jnp.full((s,), self.floor_db, jnp.float32),
            "lra": jnp.zeros((s,), jnp.float32),
        }

    def pspecs(self, axis: str):
        from jax.sharding import PartitionSpec as P

        per_stream = P(axis)
        return {
            "chunk_pos": P(),
            "ring_idx": P(),
            "chunk_e": per_stream,
            "ring": P(axis, None),
            "fs": per_stream,
            "pending_reset": per_stream,
            "hist_m_n": P(axis, None),
            "hist_m_e": P(axis, None),
            "hist_s_n": P(axis, None),
            "hist_s_e": P(axis, None),
            "integrated": per_stream,
            "lra": per_stream,
        }

    def push_block(self, carry: dict, wk2, reset_mask=None) -> dict:
        """One hop.  ``wk2``: ``[S, B]`` weighted K-squared samples."""
        cl = jnp.int32(self.chunk_len)
        b = wk2.shape[1]

        fs = carry["fs"]
        chunk_e = carry["chunk_e"]
        ring = carry["ring"]
        pending = carry["pending_reset"]
        integrated = carry["integrated"]
        lra = carry["lra"]
        if reset_mask is not None:
            fs = jnp.where(reset_mask, 0, fs)
            chunk_e = jnp.where(reset_mask, 0.0, chunk_e)
            ring = jnp.where(reset_mask[:, None], 0.0, ring)
            pending = pending | reset_mask
            integrated = jnp.where(reset_mask, self.floor_db, integrated)
            lra = jnp.where(reset_mask, 0.0, lra)

        total = jnp.sum(wk2, axis=1)
        pos = carry["chunk_pos"]
        crossing = pos + b >= cl  # scalar: global cadence

        def on_cross(op):
            (chunk_e, ring, ring_idx, pending, integrated, lra,
             hm_n, hm_e, hs_n, hs_e) = op
            off = cl - pos  # frames of this hop belonging to the old chunk
            # partial sum at the boundary as one masked reduction (a cumsum
            # here would lower to a pad-chain and run on EVERY hop; this
            # only executes on the 1-in-19 crossing hops inside the cond)
            idx = jnp.arange(b, dtype=jnp.int32)[None, :]
            before = jnp.sum(jnp.where(idx < off, wk2, 0.0), axis=1)
            closed = chunk_e + before  # exact chunk energy at the boundary
            new_chunk = total - before

            # blocks ending at this exact boundary
            idx = ring_idx
            def ring_at(k):  # k chunks back (1 = most recent closed)
                return ring[:, (idx - k) % SHORT_TERM_CHUNKS]

            m_energy = closed + ring_at(1) + ring_at(2) + ring_at(3)
            s_energy = closed + jnp.sum(ring, axis=1) - ring[:, idx % SHORT_TERM_CHUNKS]
            fs_close = fs + off  # frames since reset at the boundary instant
            z_m = m_energy / jnp.float32(MOMENTARY_CHUNKS * self.chunk_len)
            z_s = s_energy / jnp.float32(SHORT_TERM_CHUNKS * self.chunk_len)
            l_m = _loudness(z_m)
            l_s = _loudness(z_s)
            ok_m = (fs_close >= MOMENTARY_CHUNKS * cl) & (l_m > ABS_GATE_LUFS)
            ok_s = (fs_close >= SHORT_TERM_CHUNKS * cl) & (l_s > ABS_GATE_LUFS)

            # lazily apply stream resets to the histograms
            keep = jnp.where(pending[:, None], 0.0, 1.0)
            hm_n, hm_e = hm_n * keep, hm_e * keep
            hs_n, hs_e = hs_n * keep, hs_e * keep

            bins = jnp.arange(NBINS, dtype=jnp.int32)[None, :]
            def scatter(hn, he, l, z, ok):
                idx = jnp.clip(
                    jnp.floor((l - BIN_LO) / BIN_WIDTH).astype(jnp.int32),
                    0, NBINS - 1,
                )
                hot = jnp.where((bins == idx[:, None]) & ok[:, None], 1.0, 0.0)
                return hn + hot, he + hot * z[:, None]

            hm_n, hm_e = scatter(hm_n, hm_e, l_m, z_m, ok_m)
            hs_n, hs_e = scatter(hs_n, hs_e, l_s, z_s, ok_s)

            centers = (
                BIN_LO + (jnp.arange(NBINS, dtype=jnp.float32) + 0.5) * BIN_WIDTH
            )[None, :]

            # integrated: relative gate −10 LU below the abs-gated mean
            n_tot = jnp.sum(hm_n, axis=1)
            e_tot = jnp.sum(hm_e, axis=1)
            gamma_r = _loudness(e_tot / jnp.maximum(n_tot, 1.0)) - REL_GATE_LU
            incl = jnp.where(centers > gamma_r[:, None], 1.0, 0.0)
            gi_n = jnp.sum(hm_n * incl, axis=1)
            gi_e = jnp.sum(hm_e * incl, axis=1)
            integrated2 = jnp.where(
                gi_n > 0.0,
                jnp.maximum(_loudness(gi_e / jnp.maximum(gi_n, 1.0)), self.floor_db),
                self.floor_db,
            )

            # LRA: relative gate −20 LU, p95 − p10 of the gated ST counts,
            # each percentile read back as its bin's true mean loudness
            sn_tot = jnp.sum(hs_n, axis=1)
            se_tot = jnp.sum(hs_e, axis=1)
            gate_s = _loudness(se_tot / jnp.maximum(sn_tot, 1.0)) - LRA_REL_GATE_LU
            incl_s = jnp.where(centers > gate_s[:, None], 1.0, 0.0)
            cnt = hs_n * incl_s
            tot = jnp.sum(cnt, axis=1, keepdims=True)
            cumc = jnp.cumsum(cnt, axis=1)
            bin_l = jnp.where(
                hs_n > 0.0, _loudness(hs_e / jnp.maximum(hs_n, 1e-9)), centers
            )
            def percentile(q):
                hit = cumc >= q * tot
                first = jnp.argmax(hit, axis=1)
                return jnp.take_along_axis(bin_l, first[:, None], axis=1)[:, 0]
            lra2 = jnp.where(
                tot[:, 0] > 0.0,
                jnp.maximum(percentile(0.95) - percentile(0.10), 0.0),
                0.0,
            )

            ring2 = ring.at[:, idx % SHORT_TERM_CHUNKS].set(closed)
            return (
                new_chunk, ring2, (idx + 1) % SHORT_TERM_CHUNKS,
                jnp.zeros_like(pending), integrated2, lra2,
                hm_n, hm_e, hs_n, hs_e,
            )

        def no_cross(op):
            (chunk_e, ring, ring_idx, pending, integrated, lra,
             hm_n, hm_e, hs_n, hs_e) = op
            return (
                chunk_e + total, ring, ring_idx, pending, integrated, lra,
                hm_n, hm_e, hs_n, hs_e,
            )

        op = (
            chunk_e, ring, carry["ring_idx"], pending, integrated, lra,
            carry["hist_m_n"], carry["hist_m_e"],
            carry["hist_s_n"], carry["hist_s_e"],
        )
        (chunk_e, ring, ring_idx, pending, integrated, lra,
         hm_n, hm_e, hs_n, hs_e) = jax.lax.cond(crossing, on_cross, no_cross, op)

        return {
            "chunk_pos": jnp.where(crossing, pos + b - cl, pos + b),
            "ring_idx": ring_idx,
            "chunk_e": chunk_e,
            "ring": ring,
            "fs": jnp.minimum(fs + b, jnp.int32(1 << 30)),
            "pending_reset": pending,
            "hist_m_n": hm_n,
            "hist_m_e": hm_e,
            "hist_s_n": hs_n,
            "hist_s_e": hs_e,
            "integrated": integrated,
            "lra": lra,
        }
