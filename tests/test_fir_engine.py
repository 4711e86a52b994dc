"""FIR engine tests: differential vs scalar model, signal quality, API
semantics (reference test strategy: src/resampler_fir.rs:645-863)."""

import numpy as np
import pytest

from resampler_tpu import Attenuation, Latency, ResamplerFir, SampleRate
from resampler_tpu.types import InvalidInputBufferSize, InvalidOutputBufferSize

from reference_models import ScalarFir, ScalarFirF64


def run_stream(resampler, x, chunk=512):
    out_buf = np.zeros(resampler.buffer_size_output(), np.float32)
    pieces = []
    offset = 0
    while offset < x.size:
        end = min(offset + chunk, x.size)
        consumed, produced = resampler.resample(x[offset:end], out_buf)
        pieces.append(out_buf[:produced].copy())
        offset += consumed
        if consumed == 0 and produced == 0:
            break
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


@pytest.mark.parametrize(
    "in_hz,out_hz,latency",
    [
        (48000, 44100, Latency.Sample64),
        (44100, 48000, Latency.Sample64),
        (22050, 48000, Latency.Sample16),
        (48000, 16000, Latency.Sample32),
        (16000, 192000, Latency.Sample8),
        (24000, 16000, Latency.Sample32),
        (44100, 44100, Latency.Sample64),
        # coprime pair: huge reduced denominator -> exercises the general
        # gather path (the others use the periodic banded-matmul path)
        (44100, 44101, Latency.Sample16),
    ],
)
def test_differential_vs_scalar_model(in_hz, out_hz, latency):
    """Device path matches an independent f64 scalar implementation of the
    streaming semantics on random noise, including consumed/produced
    bookkeeping across many arbitrary-size chunks."""
    rng = np.random.default_rng(42)
    C = 2
    x = rng.standard_normal(2 * 9000).astype(np.float32) * 0.5

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    # The scalar model implements the reference's table-LERP semantics;
    # for non-periodic ratios force the lerp-exact gather path (the
    # default farrow path evaluates the continuous kernel — its own
    # differential lives in tests/test_farrow.py)
    _, M = reduce_ratio(in_hz, out_hz)
    path = "gather" if M > fe.MAX_PERIOD else "auto"
    ours = ResamplerFir(C, in_hz, out_hz, latency, Attenuation.Db90, path=path)
    theirs = ScalarFir(C, in_hz, out_hz, latency.taps, 10.0)

    out_buf = np.zeros(ours.buffer_size_output(), np.float32)
    # Arbitrary sizes within two padding buckets (keeps compile count low
    # while still exercising ragged chunk boundaries).
    chunk_sizes = np.concatenate(
        [rng.integers(1, 64, size=50), rng.integers(450, 512, size=30)]
    ) * C
    offset_a = offset_b = 0
    got_a, got_b = [], []
    for cs in chunk_sizes:
        end_a = min(offset_a + int(cs), x.size)
        ca, pa = ours.resample(x[offset_a:end_a], out_buf)
        got_a.append(out_buf[:pa].copy())
        offset_a += ca

        end_b = min(offset_b + int(cs), x.size)
        cb, yb = theirs.resample(
            x[offset_b:end_b], out_capacity_frames=out_buf.size // C
        )
        got_b.append(yb)
        offset_b += cb

        assert ca == cb
        assert pa == yb.size

    ya = np.concatenate(got_a)
    yb = np.concatenate(got_b)
    assert ya.size == yb.size
    np.testing.assert_allclose(ya, yb, atol=2e-5, rtol=1e-4)


def test_f64_accumulator_divergence():
    """Quantifies exactly where the engine's exact rational accumulator
    diverges from the reference's f64 ``position += ratio`` semantics
    (reference: src/resampler_fir.rs:191-194, 589) — the honest-parity
    statement cited from PARITY.md §2.3.

    For 44.1->48 kHz (L/M = 147/160) the exact position is an integer every
    160th output.  f64 rounding can land ~1 ulp below such an integer,
    making the reference pick the clamped phase pair (1023, 1023) at offset
    k where the exact schedule picks phase 0 at offset k+1.  The blended
    row is continuous in phase everywhere EXCEPT across that clamp, so:

    - lanes with i % 160 != 0 must agree to f64 noise (<1e-6), and
    - boundary lanes differ by at most the one-phase-step wobble (<2e-3
      at unit signal amplitude).
    """
    in_hz, out_hz, taps = 44100, 48000, 64
    M = 160  # reduced output rate for this pair
    rng = np.random.default_rng(11)
    x = rng.standard_normal(2 * 40000).astype(np.float32) * 0.5

    exact = ScalarFir(1, in_hz, out_hz, taps, 10.0)
    f64 = ScalarFirF64(1, in_hz, out_hz, taps, 10.0)

    def run(model):
        pieces, offset = [], 0
        mono = x[::2].copy()
        while offset < mono.size:
            end = min(offset + 512, mono.size)
            c, y = model.resample(mono[offset:end], out_capacity_frames=4096)
            pieces.append(y)
            offset += c
            if c == 0 and y.size == 0:
                break
        return np.concatenate(pieces)

    ya, yb = run(exact), run(f64)
    n = min(ya.size, yb.size)
    assert abs(ya.size - yb.size) <= 1  # counts drift by at most one output
    diff = np.abs(ya[:n] - yb[:n])

    lanes = np.arange(n)
    boundary = lanes % M == 0
    # everywhere off the exact-integer-position lanes the two accumulators
    # are numerically identical
    assert diff[~boundary].max() < 1e-6
    # at the boundary lanes the divergence is bounded by the one-phase-step
    # wobble of the clamped pair (~1e-3 relative at 0.5 amplitude)
    assert diff[boundary].max() < 2e-3


def test_stream_invariance():
    """Output is independent of how the input is chunked."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2 * 6000).astype(np.float32)
    outs = []
    for chunk in (64, 512, 4096):
        r = ResamplerFir(2, 48000, 44100, Latency.Sample32, Attenuation.Db90)
        outs.append(run_stream(r, x, chunk))
    for y in outs[1:]:
        n = min(y.size, outs[0].size)
        assert n > 0
        # different chunk sizes compile different programs; XLA may order
        # the conv accumulation differently (~1 ulp)
        np.testing.assert_allclose(y[:n], outs[0][:n], atol=2e-6)


def test_periodic_and_gather_paths_agree():
    """The banded-matmul fast path and the general gather path compute the
    same convolution (up to f32 summation order)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(2 * 5000).astype(np.float32)
    a = ResamplerFir(2, 44100, 48000, Latency.Sample64, path="periodic")
    b = ResamplerFir(2, 44100, 48000, Latency.Sample64, path="gather")
    ya = run_stream(a, x)
    yb = run_stream(b, x)
    assert ya.size == yb.size
    np.testing.assert_allclose(ya, yb, atol=1e-5)


def _measure_stopband_attenuation(in_rate, out_rate):
    """Impulse → resample → 8192-pt FFT → passband max − stopband max,
    mirroring the reference quality gate
    (reference: src/resampler_fir.rs:688-801)."""
    in_hz, out_hz = int(in_rate), int(out_rate)
    n = int(in_hz * 2.0)
    x = np.zeros(n, np.float32)
    x[n // 2] = 1.0

    r = ResamplerFir(1, in_rate, out_rate, Latency.Sample64, Attenuation.Db90)
    y = run_stream(r, x, chunk=2048)

    peak = int(np.argmax(np.abs(y)))
    window = int(out_hz * 0.1)
    start = max(peak - window // 2, 0)
    ir = y[start : start + window]

    fft_size = 8192
    spec = np.fft.rfft(ir, fft_size)
    mag_db = 20 * np.log10(np.maximum(np.abs(spec), 1e-10))

    def bin_of(freq):
        return round(freq / out_hz * fft_size)

    nyq_in = in_hz / 2
    passband = mag_db[bin_of(20.0) : bin_of(nyq_in * 0.9) + 1]
    stop_end = min(len(mag_db) - 10, bin_of(out_hz / 2 * 0.95))
    stopband = mag_db[bin_of(nyq_in * 1.1) : stop_end + 1]
    return passband.max() - stopband.max()


@pytest.mark.parametrize(
    "in_rate,out_rate",
    [
        (SampleRate.Hz22050, SampleRate.Hz44100),
        (SampleRate.Hz22050, SampleRate.Hz48000),
        # coprime pair (reduced M = 88201 > MAX_PERIOD): exercises the
        # general GATHER path's quality, not just its bookkeeping
        (44100, 88201),
    ],
)
def test_stopband_attenuation(in_rate, out_rate):
    attenuation = _measure_stopband_attenuation(in_rate, out_rate)
    assert attenuation >= 90.0, f"stopband attenuation too low: {attenuation:.2f} dB"


def test_dc_preservation():
    r = ResamplerFir(2, 48000, 44100, Latency.Sample64, Attenuation.Db120)
    x = np.empty(2 * 8000, np.float32)
    x[0::2] = 0.3
    x[1::2] = 0.6
    y = run_stream(r, x)
    frames = y.reshape(-1, 2)
    steady = frames[200:-200]
    np.testing.assert_allclose(steady[:, 0], 0.3, atol=0.01)
    np.testing.assert_allclose(steady[:, 1], 0.6, atol=0.01)


def test_new_from_hz_matches_new():
    # (reference: src/resampler_fir.rs:818-839)
    a = ResamplerFir(1, SampleRate.Hz48000, SampleRate.Hz44100,
                     Latency.Sample64, Attenuation.Db90)
    b = ResamplerFir.new_from_hz(1, 48000, 44100, Latency.Sample64, Attenuation.Db90)
    x = np.full(512, 0.5, np.float32)
    oa = np.zeros(a.buffer_size_output(), np.float32)
    ob = np.zeros(b.buffer_size_output(), np.float32)
    ca, pa = a.resample(x, oa)
    cb, pb = b.resample(x, ob)
    assert (ca, pa) == (cb, pb)
    np.testing.assert_array_equal(oa[:pa], ob[:pb])


def test_arbitrary_rates():
    r = ResamplerFir.new_from_hz(1, 24000, 16000, Latency.Sample32, Attenuation.Db60)
    out = np.zeros(r.buffer_size_output(), np.float32)
    consumed, produced = r.resample(np.zeros(256, np.float32), out)
    assert consumed == 256


def test_zero_rate_raises():
    with pytest.raises(ValueError, match="input sample rate"):
        ResamplerFir.new_from_hz(1, 0, 44100)
    with pytest.raises(ValueError, match="output sample rate"):
        ResamplerFir.new_from_hz(1, 44100, 0)


def test_invalid_buffer_sizes():
    r = ResamplerFir(2, 48000, 44100)
    out = np.zeros(r.buffer_size_output(), np.float32)
    with pytest.raises(InvalidInputBufferSize):
        r.resample(np.zeros(33, np.float32), out)
    with pytest.raises(InvalidOutputBufferSize):
        r.resample(np.zeros(32, np.float32), np.zeros(7, np.float32))


def test_reset():
    r = ResamplerFir(1, 48000, 44100)
    out = np.zeros(r.buffer_size_output(), np.float32)
    r.resample(np.ones(512, np.float32), out)
    r.reset()
    state = r.state
    assert int(state["available_frames"]) == 0
    assert int(state["pos_num"]) == 0
    assert float(np.abs(np.asarray(state["buffer"])).max()) == 0.0


def test_delay():
    assert ResamplerFir(1, 48000, 44100, Latency.Sample8).delay() == 8
    assert ResamplerFir(1, 48000, 44100, Latency.Sample64).delay() == 64


def test_state_checkpoint_resume():
    """Stream state is an explicit pytree: save/restore mid-stream and the
    continuation is bit-identical (capability beyond the reference)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(6000).astype(np.float32)
    a = ResamplerFir(1, 48000, 44100)
    out = np.zeros(a.buffer_size_output(), np.float32)
    a.resample(x[:3000], out)
    saved = {k: np.asarray(v).copy() for k, v in a.state.items()}

    y1 = run_stream(a, x[3000:])

    b = ResamplerFir(1, 48000, 44100)
    import jax.numpy as jnp

    b.state = {k: jnp.asarray(v) for k, v in saved.items()}
    y2 = run_stream(b, x[3000:])
    np.testing.assert_array_equal(y1, y2)


def test_sync_fleet_channel_major_matches_frames_major():
    """channel_major=True input layout computes the same stream outputs."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C = 3, 2
    L, M = reduce_ratio(44100, 48000)
    cfg = fe.FirConfig(channels=C, taps=32, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, 44100 / 48000)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    step_fm = jax.jit(fe.make_fir_fleet_step_sync(cfg, coeffs, B))
    step_cm = jax.jit(
        fe.make_fir_fleet_step_sync(cfg, coeffs, B, channel_major=True)
    )
    st_a = fe.fir_fleet_init_sync(cfg, B)
    st_b = fe.fir_fleet_init_sync(cfg, B)
    rng = np.random.default_rng(2)
    for _ in range(3):
        chunks = rng.standard_normal((B, 400, C)).astype(np.float32)
        st_a, out_a, ca, pa = step_fm(st_a, jnp.asarray(chunks), 400)
        st_b, out_b, cb, pb = step_cm(
            st_b, jnp.asarray(chunks.transpose(0, 2, 1)), 400
        )
        assert int(ca) == int(cb) and int(pa) == int(pb)
        np.testing.assert_array_equal(np.asarray(out_a), np.asarray(out_b))


def test_sync_tm_matches_sync_slide():
    """The time-major ring sync step (the fastest serving path) is
    bit-compatible with the end-aligned slide sync step across 30+ steps
    including several ring compactions."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 3, 2, 300
    L, M = reduce_ratio(44100, 48000)
    cfg = fe.FirConfig(channels=C, taps=32, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, 44100 / 48000)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    slide = jax.jit(fe.make_fir_fleet_step_sync(cfg, coeffs, B, channel_major=True))
    tm = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=n_in, horizon=3)
    )

    rng = np.random.default_rng(5)
    sa = fe.fir_fleet_init_sync(cfg, B)
    sb = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
    for _ in range(32):
        ch = rng.standard_normal((B, C, n_in)).astype(np.float32)
        nv = jnp.int32(int(rng.integers(0, n_in + 1)))
        sa, oa, ca, pa = slide(sa, jnp.asarray(ch), nv)
        ch_tm = jnp.asarray(np.ascontiguousarray(ch.reshape(B * C, n_in).T))
        sb, ob, cb, pb = tm(sb, ch_tm, nv)
        assert int(ca) == int(cb) and int(pa) == int(pb)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ob), atol=2e-6)


@pytest.mark.parametrize(
    "in_hz,out_hz",
    [(48000, 96000), (96000, 48000), (44100, 176400), (44100, 44100)],
)
def test_sync_tm_small_m_grouped_atlas(in_hz, out_hz):
    """Small-M families (unity/x2/x4; reduced M in {1, 2, 4}) run the
    GROUPED periodic atlas in the tm fleet (one >=128-row dot per
    contraction instead of M-row slivers — _periodic_group_factor); the
    grouped schedule must match the ungrouped slide variant across
    ragged feeds and ring compactions."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 2, 2, 300
    L, M = reduce_ratio(in_hz, out_hz)
    assert fe._periodic_group_factor(L, M) > 1
    cfg = fe.FirConfig(channels=C, taps=32, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    slide = jax.jit(
        fe.make_fir_fleet_step_sync(cfg, coeffs, B, channel_major=True)
    )
    tm = jax.jit(
        fe.make_fir_fleet_step_sync_tm(
            cfg, coeffs, B, max_chunk=n_in, horizon=3
        )
    )
    rng = np.random.default_rng(9)
    sa = fe.fir_fleet_init_sync(cfg, B)
    sb = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
    for _ in range(24):
        ch = rng.standard_normal((B, C, n_in)).astype(np.float32)
        nv = jnp.int32(int(rng.integers(0, n_in + 1)))
        sa, oa, ca, pa = slide(sa, jnp.asarray(ch), nv)
        ch_tm = jnp.asarray(np.ascontiguousarray(ch.reshape(B * C, n_in).T))
        sb, ob, cb, pb = tm(sb, ch_tm, nv)
        assert int(ca) == int(cb) and int(pa) == int(pb)
        p = int(pa)
        np.testing.assert_allclose(
            np.asarray(oa)[:, :p], np.asarray(ob)[:, :p], atol=2e-6
        )


def test_sync_tm_out_layout_tm():
    """out_layout='tm' returns the raw time-major [out_cap, B*C] block
    (the fleet-chaining form, no batch-major relayout); it must be the
    exact transpose of the default 'bm' output at every step, including
    across ring compactions and a ragged-feed catch-up."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 3, 2, 300
    L, M = reduce_ratio(44100, 48000)
    cfg = fe.FirConfig(channels=C, taps=32, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, 44100 / 48000)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    bm = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=n_in, horizon=3)
    )
    tm = jax.jit(
        fe.make_fir_fleet_step_sync_tm(
            cfg, coeffs, B, max_chunk=n_in, horizon=3, out_layout="tm"
        )
    )

    rng = np.random.default_rng(7)
    sa = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
    sb = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
    for _ in range(32):
        ch_tm = jnp.asarray(
            rng.standard_normal((n_in, B * C)).astype(np.float32)
        )
        nv = jnp.int32(int(rng.integers(0, n_in + 1)))
        sa, oa, ca, pa = bm(sa, ch_tm, nv)  # [B, out_cap, C]
        sb, ob, cb, pb = tm(sb, ch_tm, nv)  # [out_cap, B*C]
        assert int(ca) == int(cb) and int(pa) == int(pb)
        out_cap = ob.shape[0]
        ob_bm = jnp.transpose(ob.reshape(out_cap, B, C), (1, 0, 2))
        np.testing.assert_array_equal(np.asarray(oa), np.asarray(ob_bm))

    with pytest.raises(ValueError, match="out_layout"):
        fe.make_fir_fleet_step_sync_tm(
            cfg, coeffs, B, max_chunk=n_in, out_layout="cm"
        )


def test_sync_tm_conv_fallback_ratio():
    """Time-major step at an L >> taps ratio (the config where the slide
    variant would pick lax.conv): im2col-always must stay correct."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 2, 1, 700
    L, M = reduce_ratio(48000, 22050)  # 320/147: span < 2L
    cfg = fe.FirConfig(channels=C, taps=16, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(16, Attenuation.Db90, 48000 / 22050)
    coeffs = fe.fir_coefficients(16, Attenuation.Db90, cutoff)
    slide = jax.jit(fe.make_fir_fleet_step_sync(cfg, coeffs, B, channel_major=True))
    tm = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=n_in, horizon=2)
    )
    rng = np.random.default_rng(6)
    sa = fe.fir_fleet_init_sync(cfg, B)
    sb = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=2)
    for _ in range(20):
        ch = rng.standard_normal((B, C, n_in)).astype(np.float32)
        nv = jnp.int32(int(rng.integers(0, n_in + 1)))
        sa, oa, ca, pa = slide(sa, jnp.asarray(ch), nv)
        ch_tm = jnp.asarray(np.ascontiguousarray(ch.reshape(B * C, n_in).T))
        sb, ob, cb, pb = tm(sb, ch_tm, nv)
        assert int(ca) == int(cb) and int(pa) == int(pb)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ob), atol=2e-6)


def test_slew_drift_compensation():
    """slew() shifts the sampling phase with 1/M-sample resolution: a
    steady per-chunk slew changes the effective resampling ratio (the
    drift-compensation primitive), and slew(0.5) delays a tone by half
    an input sample."""
    import numpy as np

    fs_in, fs_out = 48000, 48000  # unity nominal ratio, pure drift
    rng = np.random.default_rng(0)

    # steady drift: skip `d` samples of input per chunk of n frames
    # -> output length shrinks by ~d per chunk
    r = ResamplerFir(1, fs_in, fs_out, Latency.Sample16, Attenuation.Db90)
    n, d, chunks = 2048, 2.0, 8
    out = np.zeros(r.buffer_size_output(), np.float32)
    total_out = 0
    total_in = 0
    for _ in range(chunks):
        x = rng.standard_normal(n).astype(np.float32)
        off = 0
        while off < n:
            c, p = r.resample(x[off:], out)
            if c == 0 and p == 0:
                break
            off += c
            total_out += p
        total_in += n
        applied = r.slew(d)
        assert applied == d
    # drift of d per n input frames -> out/in ratio ~= 1 - d/n
    expected = total_in * (1 - d / n)
    assert abs(total_out - expected) < r.taps + 4, (total_out, expected)

    # fractional slew needs a fine phase grid (resolution is 1/M input
    # samples): use 44.1->48 kHz (M = 160).  slew(+0.5) samples the input
    # 0.5 samples later, so it must equal resampling an analytically
    # advanced tone (agreement bounded by the Db90 filter accuracy).
    f0 = 997.0
    k = np.arange(3 * 4096)
    fsa = 44100
    tone = np.sin(2 * np.pi * f0 * k / fsa).astype(np.float32)
    tone_adv = np.sin(2 * np.pi * f0 * (k + 0.5) / fsa).astype(np.float32)
    ra = ResamplerFir(1, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    rb = ResamplerFir(1, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    applied = rb.slew(0.5)
    assert applied == 0.5
    ya = ra.process(tone_adv)
    yb = rb.process(tone)
    m = min(len(ya), len(yb)) - 400
    np.testing.assert_allclose(yb[400:m], ya[400:m], atol=2e-3)
    # and they genuinely differ from the unslewed output
    rc = ResamplerFir(1, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    yc = rc.process(tone)
    assert np.abs(yb[400:m] - yc[400:m]).max() > 1e-2

    # negative slew clamps at the oldest buffered frame
    rc = ResamplerFir(1, fs_in, fs_out)
    assert rc.slew(-5.0) == 0.0  # pos_num is 0 at start


def test_slew_tracks_clock_drift_end_to_end():
    """Serving scenario: a source ADC clock 100 ppm fast makes a true
    1000 Hz tone appear at 1000/(1+1e-4) Hz; slewing +100 ppm of samples
    per chunk restores exact pitch (measured to 0.02 Hz), while the
    uncompensated stream stays ~0.11 Hz low."""
    import numpy as np

    fs, drift = 44100, 100e-6
    k = np.arange(10 * 2048)
    x = np.sin(2 * np.pi * 1000.0 * k / (fs * (1 + drift))).astype(np.float32)

    def tone_hz(y):
        seg = y[2000:-2000]
        zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        return (len(zc) - 1) / ((zc[-1] - zc[0]) / 48000)

    r = ResamplerFir(1, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    out = np.zeros(r.buffer_size_output(), np.float32)
    ys, off = [], 0
    while off < len(x):
        end = min(off + 2048, len(x))
        c, p = r.resample(x[off:end], out)
        ys.append(out[:p].copy())
        off += c
        r.slew(2048 * drift)
    assert abs(tone_hz(np.concatenate(ys)) - 1000.0) < 0.02

    r2 = ResamplerFir(1, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    assert abs(tone_hz(r2.process(x)) - 1000.0 / (1 + drift)) < 0.02


def test_process_scanned_fast_path_matches_loop():
    """process() on file-length inputs runs one scanned dispatch per 32
    chunks; outputs equal the per-call resample loop
    — bit-exact on the periodic path, f32-floor on farrow (the chunking
    regroups the block einsum's accumulation)."""
    import resampler_tpu as rt

    rng = np.random.default_rng(9)
    for in_hz, out_hz, exact in [
        (44100, 48000, True),
        (44100, 44101, False),
    ]:
        x = (rng.standard_normal(2 * 17011) * 0.5).astype(np.float32)
        fast = rt.ResamplerFir(
            2, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90
        )
        slow = rt.ResamplerFir(
            2, in_hz, out_hz, rt.Latency.Sample64, rt.Attenuation.Db90
        )
        y_fast = fast.process(x)
        out_buf = np.zeros(slow.buffer_size_output(), np.float32)
        pieces, offset = [], 0
        while offset < x.size:
            c, p = slow.resample(x[offset : offset + 2 * 997], out_buf)
            pieces.append(out_buf[:p].copy())
            offset += c
            if c == 0 and p == 0:
                break
        y_loop = np.concatenate(pieces)
        assert y_fast.size == y_loop.size
        if exact:
            np.testing.assert_array_equal(y_fast, y_loop)
        else:
            np.testing.assert_allclose(y_fast, y_loop, atol=5e-6)


def test_process_fast_path_preserves_streaming_state():
    """A process() call between resample() calls keeps the stream state
    consistent (the fast path donates/restores state correctly)."""
    import resampler_tpu as rt

    rng = np.random.default_rng(4)
    x1 = (rng.standard_normal(2 * 5000) * 0.5).astype(np.float32)
    x2 = (rng.standard_normal(2 * 9000) * 0.5).astype(np.float32)
    a = rt.ResamplerFir(2, 44100, 48000)
    b = rt.ResamplerFir(2, 44100, 48000)
    ya = np.concatenate([a.process(x1), a.process(x2)])
    yb = b.process(np.concatenate([x1, x2]))
    n = min(ya.size, yb.size)
    np.testing.assert_array_equal(ya[:n], yb[:n])
