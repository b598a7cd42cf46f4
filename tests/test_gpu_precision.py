"""Every f32 dot on metered audio names its precision.

On a GPU an f32 dot with the platform's default precision may run in TF32
(about 10 mantissa bits), which would put the spectral floor near -66 dB
and round one-hot selections.  The CPU tests walk the traced engine step
and assert every floating-point ``dot_general`` asks for full f32
(``HIGHEST``) or a named algorithm; the ``gpu``-marked test checks on the
card that ``HIGHEST`` really is f32 there.
"""

import argparse

import numpy as np
import pytest

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp

from openmeters_tpu.analyzers.oscilloscope import OscilloscopeConfig
from openmeters_tpu.analyzers.spectrogram import SpectrogramConfig
from openmeters_tpu.analyzers.spectrum import SpectrumConfig
from openmeters_tpu.analyzers.stereometer import StereometerConfig
from openmeters_tpu.analyzers.waveform import WaveformConfig
from openmeters_tpu.engine import EngineConfig, MeterEngine, StreamMeta


def _sub_jaxprs(value):
    if isinstance(value, jex_core.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex_core.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def float_dots(jaxpr):
    """``(precision, shapes)`` of every floating-point dot_general in
    ``jaxpr`` and its sub-jaxprs (scan/cond/pjit bodies)."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            lhs = eqn.invars[0].aval
            if jnp.issubdtype(lhs.dtype, jnp.floating):
                yield eqn.params["precision"], (
                    lhs.shape, eqn.invars[1].aval.shape
                )
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from float_dots(sub)


def _full_precision(p) -> bool:
    if isinstance(p, jax.lax.DotAlgorithmPreset):
        return p != jax.lax.DotAlgorithmPreset.DEFAULT
    return p is not None and all(
        q == jax.lax.Precision.HIGHEST for q in p
    )


def _cli_config(name: str) -> EngineConfig:
    """The engine config ``serve --config <name>`` runs."""
    from openmeters_tpu.__main__ import _serving_engine_config

    return _serving_engine_config(argparse.Namespace(config=name, settings=None))


CONFIGS = {
    "serve": _cli_config("serve"),
    "default": _cli_config("default"),
    "all_six_banded": EngineConfig(
        channels=8,
        spectrogram=SpectrogramConfig(fft_size=512, hop_size=64),
        spectrum=SpectrumConfig(fft_size=4096, hop_size=256),
        oscilloscope=OscilloscopeConfig(trigger_every=3),
        stereometer=StereometerConfig(analyze_bands=True),
        waveform=WaveformConfig(analyze_bands=True, track_history=True),
    ),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_engine_dot_runs_full_f32(name):
    engine = MeterEngine(CONFIGS[name])
    s, cfg = 4, engine.config
    carry = engine.init(s)
    block = jnp.zeros((s, cfg.block_frames, cfg.channels), jnp.float32)
    meta = StreamMeta.default(s, channels=2, pad_channels=cfg.channels)
    reset = jnp.zeros((s,), bool)
    jaxprs = [jax.make_jaxpr(engine.step)(carry, block, meta, reset)]
    if engine.spectrum_cadence > 1:
        blocks = jnp.zeros((engine.spectrum_cadence, *block.shape), jnp.float32)
        jaxprs.append(
            jax.make_jaxpr(engine.spectrum_step)(
                carry["spectrum"], blocks, meta, reset
            )
        )
    dots = [d for j in jaxprs for d in float_dots(j.jaxpr)]
    assert dots, "no dots traced"
    loose = [(p, shapes) for p, shapes in dots if not _full_precision(p)]
    assert not loose, f"{len(loose)} of {len(dots)} dots without full f32: {loose[:5]}"


def test_float_dot_walker_sees_default_precision():
    """The walker flags a dot that relies on the platform default, inside a
    scan body too."""

    def f(x, m):
        def body(c, _):
            return jnp.einsum("ij,jk->ik", c, m), None

        return jax.lax.scan(body, x, None, length=2)[0]

    x = jnp.ones((4, 4), jnp.float32)
    precs = [p for p, _ in float_dots(jax.make_jaxpr(f)(x, x).jaxpr)]
    assert precs and not any(_full_precision(p) for p in precs)


@pytest.mark.gpu
def test_highest_dots_are_full_f32_on_card(gpu):
    """On the card, a ``HIGHEST`` dot matches f64 to f32 rounding, unlike
    TF32 (relative error ~1e-3 on these operands)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 1025)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(
        jnp.einsum("ik,kj->ij", a, b, precision=jax.lax.Precision.HIGHEST)
    )
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel
