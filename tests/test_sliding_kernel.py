"""Fused GPU sliding-DFT hop (ops/sliding_kernel.py) without a card.

The kernel runs here through the Pallas interpreter against the XLA slide
(``SlidingSTFT.step``), at shapes that cover a partial stream tile, a
partial last bin tile, odd ``bins`` and every stencil width; its Triton
lowering is checked by lowering it for CUDA, which needs no device.  The
compiled kernel itself is compared on the card by the ``gpu``-marked test
at the bottom (run by ``chip_smoke.py``).
"""

from typing import NamedTuple

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from openmeters_tpu.analyzers.spectrogram import (
    CLASSIC_DB_STORE_LO,
    CLASSIC_DB_STORE_RANGE,
    DB_FLOOR,
    SpectrogramAnalyzer,
    SpectrogramConfig,
    pack_classic_db,
)
from openmeters_tpu.ops.sliding_kernel import kernel_supported, sliding_hop
from openmeters_tpu.ops.sliding_stft import SlidingSTFT
from openmeters_tpu.utils.level import power_to_db
from openmeters_tpu.utils.windows import (
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)


class Hop(NamedTuple):
    codes_fused: np.ndarray  # [S, cols, bins] u16
    codes_xla: np.ndarray
    state_fused: dict
    state_xla: dict
    valid: np.ndarray  # [S, cols]
    frames: np.ndarray  # [n_ref, cols, fft] the windows of the first rows


def _hops(sl: SlidingSTFT, s: int, n_hops: int, seed: int, interpret=True,
          n_ref=None):
    """Run ``n_hops`` through the fused and the XLA hop from one stream of
    framing states; also returns the analysis windows of the first
    ``n_ref`` rows (all rows by default) for the f64 reference."""
    rng = np.random.default_rng(seed)
    fb = sl.frames
    w = window_coefficients(sl.window, sl.fft_size)
    norm = fft_bin_normalization(w, sl.fft_size)
    fb_carry = fb.init(s)
    a = b = sl.init(s)
    t = np.arange(sl.block * n_hops) / 48_000.0
    freqs = rng.uniform(50.0, 20_000.0, (s, 1))
    audio = (0.5 * np.sin(2 * np.pi * freqs * t)
             + 0.05 * rng.standard_normal((s, t.size))).astype(np.float32)
    n_ref = s if n_ref is None else n_ref
    out = []
    for h in range(n_hops):
        block = jnp.asarray(audio[:, h * sl.block:(h + 1) * sl.block])
        fb_carry, info = fb.advance(fb_carry, block)
        a, codes_a = sl.step_fused(a, info, norm, DB_FLOOR, interpret=interpret)
        b, power = sl.step(b, info)
        codes_b = pack_classic_db(power_to_db(power * norm, DB_FLOOR))
        out.append(Hop(np.asarray(codes_a), np.asarray(codes_b), a, b,
                       np.asarray(info["valid"]),
                       np.asarray(fb.extract(info)[:n_ref])))
    return out


def reference_codes(sl: SlidingSTFT, frames: np.ndarray) -> np.ndarray:
    """u16 dB codes of ``frames [..., fft]`` computed in f64 with numpy:
    DC removal, the window, rFFT, bin normalization, dB floor, packing."""
    n = sl.fft_size
    w = np.asarray(window_coefficients(sl.window, n), np.float64)
    f = frames.astype(np.float64)
    spec = np.fft.rfft((f - f.mean(axis=-1, keepdims=True)) * w, axis=-1)
    p = np.abs(spec) ** 2 * fft_bin_normalization(w, n).astype(np.float64)
    db = np.maximum(10 * np.log10(np.maximum(p, 1e-300)), DB_FLOOR)
    scale = 65535.0 / CLASSIC_DB_STORE_RANGE
    return np.clip(np.round((db - CLASSIC_DB_STORE_LO) * scale), 0, 65535)


def codes_error(sl: SlidingSTFT, out, which: str) -> int:
    """Largest code difference, at every bin of every valid column of the
    reference rows, between ``which`` (``codes_fused`` / ``codes_xla``)
    and the f64 reference codes."""
    worst = 0
    for hop in out:
        rows = hop.frames.shape[0]
        d = np.abs(getattr(hop, which)[:rows].astype(np.int64)
                   - reference_codes(sl, hop.frames))
        worst = max(worst, int(np.max(np.where(hop.valid[:rows, :, None], d, 0),
                                      initial=0)))
    return worst


def state_error(a, b) -> float:
    """Largest state difference relative to its row's peak magnitude."""
    fa = np.asarray(a["re"]) + 1j * np.asarray(a["im"])
    fb = np.asarray(b["re"]) + 1j * np.asarray(b["im"])
    peak = np.abs(fb).max(axis=1, keepdims=True) + 1e-30
    return float((np.abs(fa - fb) / peak).max())


def _check(sl, out, state_tol=1e-5):
    """The fused hop's codes are no further from the f64 reference than the
    XLA slide's own (f32 rounding below a bin's resolution) plus one code
    step, at every bin; the state matches the XLA slide's."""
    assert codes_error(sl, out, "codes_fused") <= codes_error(sl, out, "codes_xla") + 1
    for hop in out:
        assert state_error(hop.state_fused, hop.state_xla) <= state_tol
        assert int(hop.state_fused["count"]) == int(hop.state_xla["count"])
        assert bool(hop.state_fused["anchored"]) == bool(hop.state_xla["anchored"])


@pytest.mark.parametrize(
    "fft,hop,block,s,window",
    [
        # bins 129 = one full tile + a 1-bin tile; 20 streams = partial tile
        (256, 64, 256, 20, WindowKind.HANN),
        # 4-term stencil reaches 3 bins into both hermitian edges
        (256, 32, 64, 16, WindowKind.BLACKMAN_HARRIS),
        # ready < cols on some hops (hop does not divide the block)
        (128, 16, 40, 3, WindowKind.BLACKMAN),
    ],
)
def test_fused_hop_matches_xla_slide(fft, hop, block, s, window):
    sl = SlidingSTFT(fft, hop, block, window, refresh_steps=4)
    assert sl.fused_supported
    out = _hops(sl, s, n_hops=10, seed=fft + hop)
    assert any(h.valid.any() for h in out)
    _check(sl, out)


def test_fused_hop_rectangular_window_has_no_stencil():
    sl = SlidingSTFT(128, 32, 64, WindowKind.RECTANGULAR)
    _check(sl, _hops(sl, 5, n_hops=6, seed=1))


def test_fused_hop_holds_state_when_nothing_is_ready():
    """ready = 0 (window not yet full): state passes through unchanged."""
    sl = SlidingSTFT(256, 64, 64, WindowKind.HANN)
    rng = np.random.default_rng(2)
    fr = rng.standard_normal((16, sl.bins)).astype(np.float32)
    fi = rng.standard_normal((16, sl.bins)).astype(np.float32)
    rot_r, rot_i, _, _ = sl._consts()
    ones = jnp.ones((16, 1, sl.bins), jnp.float32)
    fr2, fi2, codes = sliding_hop(
        jnp.int32(0), fr, fi, ones, ones, rot_r, rot_i, sl._dc_corr_vector(),
        np.ones(sl.bins, np.float32),
        n=256, coeffs=(0.5, -0.5), floor_db=-140.0, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(fr2), fr)
    np.testing.assert_array_equal(np.asarray(fi2), fi)
    assert codes.shape == (16, 1, sl.bins) and codes.dtype == jnp.uint16


@pytest.mark.parametrize(
    "hop,bins,n_coeffs,ok",
    [
        (64, 1025, 2, True),  # the stock 2048/64 Hann spectrogram
        (64, 1025, 4, True),
        (48, 1025, 2, True),
        (1024, 8193, 2, False),  # the 16384/1024 spectrum: hop too wide
        (64, 1025, 5, False),  # stencil wider than the kernel's reach
        (8, 5, 3, False),  # fewer bins than the stencil spans
    ],
)
def test_kernel_supported_shapes(hop, bins, n_coeffs, ok):
    assert kernel_supported(hop, bins, n_coeffs) is ok


def test_kernel_is_chosen_by_platform_only():
    """On this CPU backend the classic spectrogram takes the XLA slide, and
    no user setting can select the kernel."""
    ana = SpectrogramAnalyzer(
        SpectrogramConfig(fft_size=2048, hop_size=64, use_reassignment=False)
    )
    assert ana.use_sliding and ana._sliding.fused_supported
    assert jax.default_backend() == "cpu"
    assert not ana.use_sliding_kernel


def test_kernel_lowers_for_cuda_at_headline_width():
    """The Triton lowering accepts every primitive the kernel uses, at the
    stock 2048/64 shape (lowering needs no device; compiling does)."""
    sl = SlidingSTFT(2048, 64, 256, WindowKind.HANN)
    s, bins, cols = 64, sl.bins, sl.frames.cols_cap
    f = jax.ShapeDtypeStruct((s, bins), jnp.float32)
    d = jax.ShapeDtypeStruct((s, cols, bins), jnp.float32)
    row = jax.ShapeDtypeStruct((bins,), jnp.float32)
    lowered = jax.jit(
        lambda *a: sliding_hop(*a, n=2048, coeffs=(0.5, -0.5), floor_db=-140.0)
    ).trace(
        jax.ShapeDtypeStruct((), jnp.int32), f, f, d, d, row, row, row, row,
    ).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in lowered.as_text()


def test_kernel_lowers_for_cuda_under_shard_map():
    """The sharded engine step runs the kernel per device under
    ``shard_map`` with its varying-axes check on."""
    from jax.sharding import PartitionSpec as P

    from openmeters_tpu.engine import make_mesh

    sl = SlidingSTFT(256, 64, 256, WindowKind.HANN)
    rot_r, rot_i, _, _ = sl._consts()
    row, cube = P("streams", None), P("streams", None, None)

    def hop(fr, fi, dr, di):
        return sliding_hop(
            jnp.int32(4), fr, fi, dr, di, rot_r, rot_i,
            sl._dc_corr_vector(), np.ones(sl.bins, np.float32),
            n=256, coeffs=(0.5, -0.5), floor_db=-140.0,
        )

    mapped = jax.shard_map(
        hop, mesh=make_mesh(4), in_specs=(row, row, cube, cube),
        out_specs=(row, row, cube), check_vma=True,
    )
    f = jax.ShapeDtypeStruct((64, sl.bins), jnp.float32)
    d = jax.ShapeDtypeStruct((64, 4, sl.bins), jnp.float32)
    lowered = jax.jit(mapped).trace(f, f, d, d).lower(
        lowering_platforms=("cuda",)
    )
    assert "xla.gpu.triton" in lowered.as_text()


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_slide_on_card(gpu):
    """The compiled kernel against the XLA slide and an f64 reference at
    the stock 2048/64 Hann shape (see ``_check``)."""
    sl = SlidingSTFT(2048, 64, 256, WindowKind.HANN, refresh_steps=8)
    _check(sl, _hops(sl, 512, n_hops=24, seed=3, interpret=False, n_ref=32))
