"""FFT engine tests: matmul-projector vs jnp.fft cross-check, signal
quality gates mirroring the reference
(reference: src/resampler_fft.rs:427-567)."""

import numpy as np
import pytest

from resampler_tpu import ResamplerFft, SampleRate
from resampler_tpu.engine.fft import (
    FftConfig,
    fft_init,
    make_fft_step,
    spectral_projection_matrix,
)
from resampler_tpu.types import InvalidInputBufferSize, InvalidOutputBufferSize

EPSILON = 0.02

RATE_PAIRS = [
    (SampleRate.Hz48000, SampleRate.Hz44100),
    (SampleRate.Hz44100, SampleRate.Hz48000),
    (SampleRate.Hz48000, SampleRate.Hz32000),
    (SampleRate.Hz32000, SampleRate.Hz48000),
    (SampleRate.Hz96000, SampleRate.Hz48000),
    (SampleRate.Hz48000, SampleRate.Hz96000),
]


@pytest.mark.parametrize("in_rate,out_rate", RATE_PAIRS)
def test_dc_amplitude_preservation(in_rate, out_rate):
    # (reference: src/resampler_fft.rs:440-474)
    r = ResamplerFft(1, in_rate, out_rate)
    dc = 0.5
    x = np.full(r.chunk_size_input(), dc, np.float32)
    out = np.zeros(r.chunk_size_output(), np.float32)
    for _ in range(5):
        r.resample(x, out)
    lo = min(r.delay(), out.size // 4)
    hi = out.size * 3 // 4
    np.testing.assert_allclose(out[lo:hi], dc, atol=EPSILON)


@pytest.mark.parametrize(
    "in_rate,out_rate",
    [
        (SampleRate.Hz48000, SampleRate.Hz44100),
        (SampleRate.Hz44100, SampleRate.Hz48000),
        (SampleRate.Hz48000, SampleRate.Hz32000),
    ],
)
def test_sine_amplitude_preservation(in_rate, out_rate):
    # (reference: src/resampler_fft.rs:476-524)
    r = ResamplerFft(1, in_rate, out_rate)
    amp, freq = 0.5, 1000.0
    n = r.chunk_size_input()
    phase = 2 * np.pi * freq / int(in_rate) * np.arange(n)
    x = (amp * np.sin(phase)).astype(np.float32)
    out = np.zeros(r.chunk_size_output(), np.float32)
    for _ in range(5):
        r.resample(x, out)
    lo = min(r.delay(), out.size // 4)
    hi = out.size * 3 // 4
    peak = np.abs(out[lo:hi]).max()
    assert abs(peak - amp) < EPSILON


def test_stereo_dc_preservation():
    # (reference: src/resampler_fft.rs:526-566)
    r = ResamplerFft(2, SampleRate.Hz48000, SampleRate.Hz44100)
    x = np.empty(r.chunk_size_input(), np.float32)
    x[0::2], x[1::2] = 0.3, 0.6
    out = np.zeros(r.chunk_size_output(), np.float32)
    for _ in range(5):
        r.resample(x, out)
    lo = min(r.delay(), out.size // 8) * 2
    hi = out.size * 3 // 4
    frames = out[lo : hi - hi % 2].reshape(-1, 2)
    np.testing.assert_allclose(frames[:, 0], 0.3, atol=EPSILON)
    np.testing.assert_allclose(frames[:, 1], 0.6, atol=EPSILON)


@pytest.mark.parametrize("in_rate,out_rate", RATE_PAIRS[:3])
def test_matmul_matches_fft_backend(in_rate, out_rate):
    """The fused projector matmul equals the op-for-op jnp.fft dataflow."""
    rng = np.random.default_rng(7)
    a = ResamplerFft(1, in_rate, out_rate, backend="matmul")
    b = ResamplerFft(1, in_rate, out_rate, backend="fft")
    out_a = np.zeros(a.chunk_size_output(), np.float32)
    out_b = np.zeros(b.chunk_size_output(), np.float32)
    for _ in range(3):
        x = rng.standard_normal(a.chunk_size_input()).astype(np.float32)
        a.resample(x, out_a)
        b.resample(x, out_b)
        np.testing.assert_allclose(out_a, out_b, atol=2e-4)


def test_projection_matrix_identity_impulse():
    """Same-rate conversion: a unit impulse comes back delayed by exactly
    N/2 with peak equal to the filter's passband gain (the Kaiser cutoff,
    since the lowpass removes the 1-cutoff band edge)."""
    from resampler_tpu.dsp.window import calculate_cutoff_kaiser

    r = ResamplerFft(1, SampleRate.Hz48000, SampleRate.Hz48000)
    n = r.chunk_size_input()
    x = np.zeros(n, np.float32)
    x[n // 3] = 1.0
    out = np.zeros(r.chunk_size_output(), np.float32)
    r.resample(x, out)
    first = out.copy()
    r.resample(np.zeros_like(x), out)
    total = np.concatenate([first, out])
    peak_idx = int(np.argmax(np.abs(total)))
    assert peak_idx == n // 3 + r.delay()
    expected_peak = calculate_cutoff_kaiser(n, 10.0)
    assert abs(total[peak_idx] - expected_peak) < 1e-3
    # energy concentrated at the peak (sinc sidelobes below 0.05)
    assert np.sum(np.abs(total) > 0.05) <= 3


def test_stopband_attenuation_fft():
    """Impulse response stopband >= 99 dB (reference README claims
    ~-100 dB for Kaiser beta=10, reference: README.md:84)."""
    in_rate, out_rate = SampleRate.Hz22050, SampleRate.Hz48000
    r = ResamplerFft(1, in_rate, out_rate)
    ci = r.chunk_size_input()
    x = np.zeros(20 * ci, np.float32)
    x[len(x) // 2] = 1.0
    y = r.process(x)

    peak = int(np.argmax(np.abs(y)))
    window = int(int(out_rate) * 0.1)
    start = max(peak - window // 2, 0)
    ir = y[start : start + window]
    spec = np.fft.rfft(ir, 1 << 17)
    mag_db = 20 * np.log10(np.maximum(np.abs(spec), 1e-12))
    out_hz = int(out_rate)
    fft_size = 1 << 17

    def bin_of(freq):
        return round(freq / out_hz * fft_size)

    nyq_in = int(in_rate) / 2
    passband = mag_db[bin_of(20.0) : bin_of(nyq_in * 0.9) + 1]
    stopband = mag_db[bin_of(nyq_in * 1.1) : bin_of(out_hz / 2 * 0.95) + 1]
    atten = passband.max() - stopband.max()
    assert atten >= 99.0, f"FFT stopband attenuation too low: {atten:.2f} dB"


def test_chunk_sizes_and_delay():
    r = ResamplerFft(2, SampleRate.Hz44100, SampleRate.Hz48000)
    assert r.chunk_size_input() == 1176 * 2
    assert r.chunk_size_output() == 1280 * 2
    assert r.delay() == 1176 // 2
    r = ResamplerFft(1, SampleRate.Hz48000, SampleRate.Hz96000)
    assert (r.chunk_size_input(), r.chunk_size_output()) == (512, 1024)


def test_invalid_buffers():
    r = ResamplerFft(2, SampleRate.Hz48000, SampleRate.Hz44100)
    out = np.zeros(r.chunk_size_output(), np.float32)
    with pytest.raises(InvalidInputBufferSize):
        r.resample(np.zeros(r.chunk_size_input() - 1, np.float32), out)
    with pytest.raises(InvalidOutputBufferSize):
        r.resample(
            np.zeros(r.chunk_size_input(), np.float32),
            np.zeros(r.chunk_size_output() - 1, np.float32),
        )


def test_process_length():
    """Batch helper output length: ceil(in_len * co / ci)
    (reference: resample/src/main.rs:307-310)."""
    r = ResamplerFft(2, SampleRate.Hz44100, SampleRate.Hz48000)
    x = np.zeros(10_000, np.float32)
    y = r.process(x)
    expected = -(-x.size * r.chunk_size_output() // r.chunk_size_input())
    assert y.size == expected


def test_projection_matrix_is_cached():
    from resampler_tpu.engine.fft import get_projection_matrix

    a = get_projection_matrix(1176, 1280)
    b = get_projection_matrix(1176, 1280)
    assert a is b
    assert a.shape == (1176, 2 * 1280)
    assert a.dtype == np.float32


def test_overlap_state_checkpoint():
    rng = np.random.default_rng(5)
    a = ResamplerFft(1, SampleRate.Hz48000, SampleRate.Hz44100)
    x1 = rng.standard_normal(a.chunk_size_input()).astype(np.float32)
    x2 = rng.standard_normal(a.chunk_size_input()).astype(np.float32)
    out = np.zeros(a.chunk_size_output(), np.float32)
    a.resample(x1, out)
    saved = {k: np.asarray(v).copy() for k, v in a.state.items()}
    a.resample(x2, out)
    ref = out.copy()

    import jax.numpy as jnp

    b = ResamplerFft(1, SampleRate.Hz48000, SampleRate.Hz44100)
    b.state = {k: jnp.asarray(v) for k, v in saved.items()}
    out2 = np.zeros(b.chunk_size_output(), np.float32)
    b.resample(x2, out2)
    np.testing.assert_array_equal(ref, out2)


def test_fleet_step_matches_vmapped():
    """The fleet-flattened projection step equals vmapping the per-stream
    step (bit-exact: same matmul rows, same order)."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine.fft import (
        fft_fleet_init,
        fft_init,
        make_fft_fleet_step,
    )

    B, C = 3, 2
    cfg = FftConfig(channels=C, fft_size_input=588, fft_size_output=1280)
    s1 = jax.jit(jax.vmap(make_fft_step(cfg)))
    s2 = jax.jit(make_fft_fleet_step(cfg, B))
    st1 = jax.vmap(lambda _: fft_init(cfg))(jnp.arange(B))
    st2 = fft_fleet_init(cfg, B)
    rng = np.random.default_rng(8)
    for _ in range(3):
        x = jnp.asarray(rng.standard_normal((B, C, 588)), jnp.float32)
        st1, o1 = s1(st1, x)
        st2, o2 = s2(st2, x)
        np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), atol=1e-6)


@pytest.mark.parametrize(
    "in_rate,out_rate",
    [
        (SampleRate.Hz44100, SampleRate.Hz48000),
        (SampleRate.Hz48000, SampleRate.Hz44100),
        (SampleRate.Hz96000, SampleRate.Hz88200),
    ],
)
def test_conv_backend_matches_matmul(in_rate, out_rate):
    """The channelized banded-conv form (the FLOP-reduced production
    backend) equals the dense projector across chunks, including the
    prev-chunk carry (= overlap-add) semantics."""
    rng = np.random.default_rng(13)
    a = ResamplerFft(2, in_rate, out_rate, backend="matmul")
    b = ResamplerFft(2, in_rate, out_rate, backend="conv")
    out_a = np.zeros(a.chunk_size_output(), np.float32)
    out_b = np.zeros(b.chunk_size_output(), np.float32)
    for _ in range(4):
        x = rng.standard_normal(a.chunk_size_input()).astype(np.float32)
        a.resample(x, out_a)
        b.resample(x, out_b)
        # band truncation keeps entries >= ~1.2e-7 of max; remaining
        # difference is f32 summation order
        np.testing.assert_allclose(out_a, out_b, atol=2e-5)


def test_conv_backend_auto_selection():
    """The conv form is well-shaped exactly when the period gives the
    product width (L', M' >= 64 channels) and the band cuts FLOPs
    (g >= 2)."""
    from resampler_tpu.engine.fft import conv_backend_viable

    assert conv_backend_viable(1176, 1280)      # 44.1<->48 family
    assert conv_backend_viable(588, 1280)       # 22.05 -> 48
    assert not conv_backend_viable(512, 1024)   # same-family 2x: L'=1
    assert not conv_backend_viable(64, 192)     # L'=1: no channels
    assert not conv_backend_viable(147, 160)    # g=1: no FLOP cut


def test_conv_fleet_matches_matmul_fleet():
    from resampler_tpu.engine import fft as fft_engine

    cfg = fft_engine.FftConfig(
        channels=2, fft_size_input=588, fft_size_output=640
    )
    B = 3
    fm = fft_engine.make_fft_fleet_step(cfg, B)
    fc = fft_engine.make_fft_fleet_step(cfg, B, backend="conv")
    sm = fft_engine.fft_fleet_init(cfg, B)
    sc = fft_engine.fft_fleet_init(cfg, B, "conv")
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.standard_normal((B, 2, 588)).astype(np.float32)
        sm, a = fm(sm, x)
        sc, b = fc(sc, x)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


def test_conv_backend_stopband():
    """Quality gate directly on the conv backend (not only equivalence)."""
    r = ResamplerFft(1, SampleRate.Hz22050, SampleRate.Hz48000, backend="conv")
    ci = r.chunk_size_input()
    x = np.zeros(20 * ci, np.float32)
    x[len(x) // 2] = 1.0
    y = r.process(x)
    peak = int(np.argmax(np.abs(y)))
    window = int(48000 * 0.1)
    start = max(peak - window // 2, 0)
    spec = np.fft.rfft(y[start : start + window], 1 << 17)
    mag_db = 20 * np.log10(np.maximum(np.abs(spec), 1e-12))

    def bin_of(freq):
        return round(freq / 48000 * (1 << 17))

    nyq_in = 22050 / 2
    atten = (
        mag_db[bin_of(20.0) : bin_of(nyq_in * 0.9) + 1].max()
        - mag_db[bin_of(nyq_in * 1.1) : bin_of(48000 / 2 * 0.95) + 1].max()
    )
    assert atten >= 99.0, f"conv backend stopband {atten:.2f} dB"


def test_fft_process_scanned_fast_path_matches_loop():
    """ResamplerFft.process batches the bulk into scanned multi-chunk
    dispatches; bit-exact vs the per-chunk loop,
    including the loop-handled tail."""
    import resampler_tpu as rt

    rng = np.random.default_rng(2)
    x = (rng.standard_normal(2 * 80_000) * 0.5).astype(np.float32)
    fast = rt.ResamplerFft(2, rt.SampleRate.Hz44100, rt.SampleRate.Hz48000)
    slow = rt.ResamplerFft(2, rt.SampleRate.Hz44100, rt.SampleRate.Hz48000)
    slow._MANY_T = 1 << 30  # force the per-chunk loop
    ya = fast.process(x)
    yb = slow.process(x)
    assert ya.size == yb.size
    np.testing.assert_array_equal(ya, yb)


def test_auto_backend_is_the_dense_projector():
    """``backend="auto"`` resolves to the XLA matmul form on every
    platform: the {'overlap'} carry, and a traced step whose only
    product is the projector dot."""
    import jax

    from resampler_tpu.engine import fft as fft_engine

    cfg = FftConfig(channels=2, fft_size_input=1176, fft_size_output=1280)
    assert fft_engine._resolve_backend("auto") == "matmul"
    assert set(fft_init(cfg)) == {"overlap"}
    assert set(fft_engine.fft_fleet_init(cfg, 2)) == {"overlap"}
    jaxpr = jax.make_jaxpr(make_fft_step(cfg))(
        fft_init(cfg), np.zeros((2, 1176), np.float32)
    )
    prims = set()

    def walk(j):
        for e in j.eqns:
            prims.add(e.primitive.name)
            for sub in jax.core.jaxprs_in_params(e.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    assert "dot_general" in prims and "pallas_call" not in prims


def _removed_fft_backend():
    ResamplerFft(2, SampleRate.Hz44100, SampleRate.Hz48000, backend="magsplit")


def _removed_fleet_backend():
    from resampler_tpu import BatchedResamplerFft

    BatchedResamplerFft(
        4, 2, SampleRate.Hz44100, SampleRate.Hz48000, backend="magsplit"
    )


def _removed_fleet_init_backend():
    from resampler_tpu.engine.fft import fft_fleet_init

    fft_fleet_init(
        FftConfig(channels=2, fft_size_input=588, fft_size_output=1280), 4,
        backend="magsplit",
    )


def _fir_fleet_kwarg(builder, **kw):
    from resampler_tpu import Attenuation
    from resampler_tpu.engine import fir as fe

    cfg = fe.FirConfig(channels=2, taps=32, ratio_num=147, ratio_den=160)
    coeffs = fe.fir_coefficients(
        32, Attenuation.Db90, fe.fir_cutoff(32, Attenuation.Db90, 147 / 160)
    )
    getattr(fe, builder)(cfg, coeffs, 64, max_chunk=512, **kw)


@pytest.mark.parametrize(
    "call,error,match",
    [
        (_removed_fft_backend, ValueError, "magsplit"),
        (_removed_fleet_backend, ValueError, "magsplit"),
        (_removed_fleet_init_backend, ValueError, "magsplit"),
        (lambda: make_fft_step(
            FftConfig(channels=1, fft_size_input=588, fft_size_output=1280),
            backend="pool"), ValueError, "unknown FFT backend"),
        (lambda: _fir_fleet_kwarg(
            "make_fir_fleet_step_sync_tm", contraction="dma"),
         TypeError, "contraction"),
        (lambda: _fir_fleet_kwarg(
            "make_fir_fleet_step_sync_tm", precision="bf16x4"),
         TypeError, "precision"),
        (lambda: _fir_fleet_kwarg(
            "make_fir_fleet_step_async_tm", kernel="pallas"),
         TypeError, "kernel"),
    ],
    ids=["resampler_magsplit", "fleet_magsplit", "fleet_init_magsplit",
         "unknown_backend", "sync_tm_contraction", "sync_tm_bf16x4",
         "async_kernel"],
)
def test_removed_kernel_options_raise(call, error, match):
    """The options that selected the removed Pallas kernels fail loudly:
    a removed value of a kept parameter with ValueError, a removed
    keyword with Python's TypeError naming it — never a silent fallback."""
    with pytest.raises(error, match=match):
        call()


@pytest.mark.parametrize(
    "in_rate,out_rate",
    [
        (SampleRate.Hz44100, SampleRate.Hz48000),
        (SampleRate.Hz48000, SampleRate.Hz96000),
        (SampleRate.Hz22050, SampleRate.Hz48000),
        (SampleRate.Hz48000, SampleRate.Hz44100),
    ],
)
def test_fleet_floor_vs_f64_projector(in_rate, out_rate):
    """The four reference pairs' fleet steps stay >= 99 dB above the
    float64 projector applied on the host (the pair-floor gate
    chip_smoke.py and bench.py apply on the device)."""
    from resampler_tpu import BatchedResamplerFft
    from resampler_tpu.tools.attest import fft_floor_db

    fleet = BatchedResamplerFft(4, 2, in_rate, out_rate)
    n_in = fleet.config.fft_size_input
    n_out = fleet.config.fft_size_output
    rng = np.random.default_rng(17)
    chunks = [
        rng.standard_normal((4, 2, n_in)).astype(np.float32)
        for _ in range(3)
    ]
    outs = [np.asarray(fleet.resample(c)) for c in chunks]
    assert fft_floor_db(chunks, outs, n_in, n_out) >= 99.0


@pytest.mark.parametrize(
    "saved_backend,restore_backend",
    [("conv", "matmul"), ("matmul", "matmul"), ("conv", "conv")],
    ids=["prev_to_overlap", "overlap_identity", "prev_identity"],
)
def test_convert_fft_state_round_trip(saved_backend, restore_backend):
    """A carry checkpointed mid-stream restores into a resampler of the
    given backend through ``convert_fft_state`` (the state setter), and
    the continuation equals the uninterrupted stream's."""
    rng = np.random.default_rng(6)
    a = ResamplerFft(
        2, SampleRate.Hz22050, SampleRate.Hz48000, backend=saved_backend
    )
    x1 = rng.standard_normal(a.chunk_size_input()).astype(np.float32)
    x2 = rng.standard_normal(a.chunk_size_input()).astype(np.float32)
    out = np.zeros(a.chunk_size_output(), np.float32)
    a.resample(x1, out)
    saved = {k: np.asarray(v).copy() for k, v in a.state.items()}
    a.resample(x2, out)

    b = ResamplerFft(
        2, SampleRate.Hz22050, SampleRate.Hz48000, backend=restore_backend
    )
    b.state = saved
    assert set(b.state) == ({"prev"} if restore_backend == "conv"
                            else {"overlap"})
    out2 = np.zeros(b.chunk_size_output(), np.float32)
    b.resample(x2, out2)
    np.testing.assert_allclose(out2, out, atol=2e-5)


def test_convert_fft_state_rejects_overlap_to_prev():
    """The projection is not invertible: an {'overlap'} carry cannot
    become the conv form's {'prev'} state."""
    from resampler_tpu.engine.fft import convert_fft_state

    cfg = FftConfig(channels=2, fft_size_input=588, fft_size_output=1280)
    with pytest.raises(ValueError, match="not invertible"):
        convert_fft_state(
            {"overlap": np.zeros((2, 1280), np.float32)}, cfg, "conv"
        )
