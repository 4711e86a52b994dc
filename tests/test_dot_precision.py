"""Every matrix product on the engines' device paths names its precision.

A float32 product left at DEFAULT (or HIGH) precision may run as a single
TF32 pass on the GPU — an arithmetic floor far above the FFT engine's
-100 dB design stopband and the FIR engine's alias rejection — while the
CPU suite, which computes float32 exactly, stays green.  So these tests
read the traced programs: the FFT projector GEMM carries
``FFT_DOT_ALGORITHM`` on the GPU, every other product
``Precision.HIGHEST``.
"""

import jax
import jax.numpy as jnp
import pytest

from resampler_tpu.engine import fft as fft_engine
from resampler_tpu.engine import fir as fe
from resampler_tpu.types import Attenuation, reduce_ratio

PRODUCTS = ("dot_general", "conv_general_dilated")
HIGHEST = jax.lax.Precision.HIGHEST


def _products(closed_jaxpr):
    """(primitive name, precision param) of every product in the program,
    sub-programs (scan/cond/pjit bodies) included."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in PRODUCTS:
                found.append((eqn.primitive.name, eqn.params["precision"]))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed_jaxpr.jaxpr)
    return found


def _precisions(p):
    """A product's precision as a set: one algorithm, or the per-operand
    pair of ``Precision`` values."""
    if isinstance(p, (tuple, list)):
        return set(p)
    return {p}


def _fft_case(kind, backend):
    cfg = fft_engine.FftConfig(
        channels=2, fft_size_input=1176, fft_size_output=1280
    )
    if kind == "step":
        step = fft_engine.make_fft_step(cfg, backend=backend)
        state = fft_engine.fft_init(cfg, backend)
        x = jnp.zeros((2, 1176), jnp.float32)
    else:
        step = fft_engine.make_fft_fleet_step(cfg, 3, backend=backend)
        state = fft_engine.fft_fleet_init(cfg, 3, backend)
        x = jnp.zeros((3, 2, 1176), jnp.float32)
    return jax.make_jaxpr(step)(state, x)


GPU_AND_OTHERS = {fft_engine.FFT_DOT_ALGORITHM, HIGHEST}


@pytest.mark.parametrize(
    "kind,backend,expected",
    [
        ("step", "matmul", GPU_AND_OTHERS),
        ("fleet", "matmul", GPU_AND_OTHERS),
        ("step", "conv", {HIGHEST}),
        ("fleet", "conv", {HIGHEST}),
        ("step", "rfft", {HIGHEST}),
    ],
    ids=["step_matmul", "fleet_matmul", "step_conv", "fleet_conv",
         "step_rfft"],
)
def test_fft_products_carry_explicit_algorithm(kind, backend, expected):
    """The projector GEMM is staged once per platform class —
    ``FFT_DOT_ALGORITHM`` for the GPU, HIGHEST elsewhere — and every other
    FFT product runs at HIGHEST."""
    prods = _products(_fft_case(kind, backend))
    assert prods, "no product traced"
    seen = set()
    for name, p in prods:
        assert len(_precisions(p)) == 1, (name, p)
        seen |= _precisions(p)
    assert seen == expected, seen


def _fir_setup(in_hz, out_hz, taps=32, channels=2):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fe.FirConfig(channels=channels, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    return cfg, fe.fir_coefficients(taps, Attenuation.Db90, cutoff)


def _fir_case(kind, in_hz, out_hz, path="auto"):
    cfg, coeffs = _fir_setup(in_hz, out_hz)
    B, n = 2, 256
    if kind == "per_stream":
        step = fe.make_fir_step(cfg, coeffs, path=path)
        args = (fe.fir_init(cfg), jnp.zeros((n, 2), jnp.float32),
                jnp.int32(n), jnp.int32(cfg.out_capacity))
    elif kind == "sync_tm":
        step = fe.make_fir_fleet_step_sync_tm(
            cfg, coeffs, B, max_chunk=n, path=path
        )
        args = (fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n),
                jnp.zeros((n, 2 * B), jnp.float32), jnp.int32(n))
    elif kind == "async_tm":
        step = fe.make_fir_fleet_step_async_tm(cfg, coeffs, B, max_chunk=n)
        args = (fe.fir_fleet_init_async_tm(cfg, B, max_chunk=n),
                jnp.zeros((n, 2 * B), jnp.float32), jnp.int32(n))
    else:  # end-aligned slide sync fleet
        step = fe.make_fir_fleet_step_sync(cfg, coeffs, B)
        args = (fe.fir_fleet_init_sync(cfg, B),
                jnp.zeros((B, n, 2), jnp.float32), jnp.int32(n))
    return jax.make_jaxpr(step)(*args)


@pytest.mark.parametrize(
    "kind,in_hz,out_hz,path",
    [
        ("per_stream", 44100, 48000, "auto"),
        ("per_stream", 44100, 44101, "farrow"),
        ("per_stream", 44100, 44101, "lerp"),
        ("per_stream", 44100, 44101, "gather"),
        ("sync_tm", 44100, 48000, "auto"),
        ("sync_tm", 44100, 44101, "farrow"),
        ("sync_tm", 44100, 44101, "lerp"),
        ("sync_tm", 600011, 600013, "auto"),
        ("async_tm", 44100, 44101, "auto"),
        ("async_tm", 600011, 600013, "auto"),
        ("slide", 44100, 48000, "auto"),
    ],
    ids=["step_periodic", "step_farrow", "step_lerp", "step_gather",
         "sync_tm_periodic", "sync_tm_farrow", "sync_tm_lerp",
         "sync_tm_wide", "async_tm", "async_tm_wide", "slide"],
)
def test_fir_products_run_at_highest(kind, in_hz, out_hz, path):
    prods = _products(_fir_case(kind, in_hz, out_hz, path))
    assert prods, "no product traced"
    for name, p in prods:
        # XLA keeps a product out of TF32 when any operand asks for
        # HIGHEST; the gather path's patch extraction is the one product
        # whose other operand (an identity filter) stays DEFAULT — exact
        # in any precision
        assert HIGHEST in _precisions(p), (name, p)
        assert _precisions(p) <= {HIGHEST, jax.lax.Precision.DEFAULT}



def test_tf32_split_is_exact():
    """``hi + lo == a`` bit for bit, ``hi`` has no mantissa bits below
    TF32's ten, and ``lo`` is below one TF32 unit of ``a``."""
    import numpy as np

    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
    a = np.concatenate([a, [0.0, -0.0, 1.0, -1.5]]).astype(np.float32)
    hi, lo = (np.asarray(v) for v in fft_engine.tf32_split(a))
    np.testing.assert_array_equal(hi + lo, a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(lo) <= np.abs(a) * 2.0 ** -10).all()


def _tf32_pass(a, b):
    """One TF32 tensor-core pass emulated on the CPU: both operands
    truncated to TF32's 10-bit mantissa, products summed in float32."""
    return jnp.dot(
        fft_engine.tf32_split(a)[0], fft_engine.tf32_split(b)[0],
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )


@pytest.mark.parametrize("three_passes", [True, False],
                         ids=["tf32x3", "one_tf32_pass"])
def test_projector_floor_with_emulated_tf32(three_passes):
    """The GPU's projector arithmetic, emulated: ``tf32x3`` clears the
    99 dB floor gate against the float64 projector, one TF32 pass (what
    DEFAULT and HIGH run on the GPU) does not."""
    import numpy as np

    from resampler_tpu.tools.attest import fft_floor_db

    n_in, n_out, B, C = 1176, 1280, 4, 2
    proj, p_hi, p_lo = fft_engine.projector_operands(
        fft_engine.get_projection_matrix(n_in, n_out)
    )
    rng = np.random.default_rng(5)
    chunks, outs, overlap = [], [], 0.0
    for _ in range(3):
        ch = rng.standard_normal((B, C, n_in)).astype(np.float32)
        x = ch.reshape(B * C, n_in)
        if three_passes:
            full = fft_engine.tf32x3(x, p_hi, p_lo, dot=_tf32_pass)
        else:
            full = _tf32_pass(x, proj)
        full = np.asarray(full).reshape(B, C, 2 * n_out)
        chunks.append(ch)
        outs.append(full[..., :n_out] + overlap)
        overlap = full[..., n_out:]
    floor = fft_floor_db(chunks, outs, n_in, n_out)
    assert (floor >= 99.0) == three_passes, floor
