"""Device-numerics tests: the CPU suite's key differentials and quality
gates, executed on the GPU.

Each test mirrors a tests/ counterpart (cited inline) with few, small jit
shapes."""

import numpy as np
import pytest

from resampler_tpu import (
    Attenuation,
    Latency,
    ResamplerFft,
    ResamplerFir,
    SampleRate,
)

from reference_models import ScalarFir

pytestmark = pytest.mark.gpu


def run_stream(resampler, x, chunk):
    out_buf = np.zeros(resampler.buffer_size_output(), np.float32)
    pieces, offset = [], 0
    while offset < x.size:
        end = min(offset + chunk, x.size)
        consumed, produced = resampler.resample(x[offset:end], out_buf)
        pieces.append(out_buf[:produced].copy())
        offset += consumed
        if consumed == 0 and produced == 0:
            break
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


def test_fir_differential_vs_scalar_model_on_device():
    """tests/test_fir_engine.py::test_differential_vs_scalar_model, one
    rate pair, fixed chunk size (one compiled shape)."""
    rng = np.random.default_rng(42)
    C = 2
    x = (rng.standard_normal(2 * 6000) * 0.5).astype(np.float32)

    ours = ResamplerFir(C, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    theirs = ScalarFir(C, 44100, 48000, Latency.Sample64.taps, 10.0)

    ya = run_stream(ours, x, chunk=2 * 2048)
    pieces, offset = [], 0
    while offset < x.size:
        end = min(offset + 2 * 2048, x.size)
        cb, yb = theirs.resample(x[offset:end], out_capacity_frames=1 << 16)
        pieces.append(yb)
        offset += cb
        if cb == 0 and yb.size == 0:
            break
    yb = np.concatenate(pieces)
    assert ya.size == yb.size
    # device accumulation order differs from the f64 scalar model;
    # Precision.HIGHEST keeps this at f32-noise level
    np.testing.assert_allclose(ya, yb, atol=2e-5, rtol=1e-4)


def test_fir_stopband_on_device():
    """tests/test_fir_engine.py::test_stopband_attenuation — the alias
    rejection that silently drops by tens of dB if any product loses its
    explicit precision= (a single bf16 or TF32 pass)."""
    in_hz, out_hz = 22050, 48000
    n = 30000
    x = np.zeros(n, np.float32)
    x[n // 2] = 1.0
    r = ResamplerFir(1, in_hz, out_hz, Latency.Sample64, Attenuation.Db90)
    y = run_stream(r, x, chunk=2048)

    peak = int(np.argmax(np.abs(y)))
    w = int(out_hz * 0.1)
    s = max(peak - w // 2, 0)
    spec = np.fft.rfft(y[s : s + w], 8192)
    mag = 20 * np.log10(np.maximum(np.abs(spec), 1e-10))

    def b(f):
        return round(f / out_hz * 8192)

    nyq = in_hz / 2
    att = (
        mag[b(20.0) : b(nyq * 0.9) + 1].max()
        - mag[b(nyq * 1.1) : b(out_hz / 2 * 0.95) + 1].max()
    )
    assert att >= 90.0, f"on-device stopband {att:.1f} dB"


def test_fft_stopband_on_device():
    """tests/test_fft_engine.py stopband gate on the matmul backend (the
    production path, three explicit TF32 passes)."""
    rf = ResamplerFft(2, SampleRate.Hz22050, SampleRate.Hz48000)
    x = np.zeros(8 * rf.chunk_size_input(), np.float32)
    x[len(x) // 2 - (len(x) // 2) % 2] = 1.0
    y = rf.process(x)[0::2]
    peak = int(np.argmax(np.abs(y)))
    w = int(48000 * 0.1)
    s = max(peak - w // 2, 0)
    spec = np.fft.rfft(y[s : s + w], 1 << 17)
    mag = 20 * np.log10(np.maximum(np.abs(spec), 1e-12))

    def b(f):
        return round(f / 48000 * (1 << 17))

    nyq = 22050 / 2
    att = (
        mag[b(20.0) : b(nyq * 0.9) + 1].max()
        - mag[b(nyq * 1.1) : b(48000 / 2 * 0.95) + 1].max()
    )
    assert att >= 99.0, f"on-device FFT stopband {att:.1f} dB"


def test_fft_matmul_matches_host_reference_on_device():
    """One chunk through the device projector equals the f64 host
    pipeline (mirrors tests/test_fft_engine.py backend cross-check, but
    against numpy so no complex dtypes touch the device)."""
    import jax.numpy as jnp

    from resampler_tpu.engine import fft as fft_engine

    cfg = fft_engine.FftConfig(
        channels=2, fft_size_input=1176, fft_size_output=1280
    )
    step = fft_engine.make_fft_step(cfg, backend="matmul")
    state = fft_engine.fft_init(cfg, "matmul")
    rng = np.random.default_rng(5)
    chunk = rng.standard_normal((2, 1176)).astype(np.float32)

    _, out = step(state, jnp.asarray(chunk))

    proj = fft_engine.get_projection_matrix(1176, 1280).astype(np.float64)
    expected = (chunk.astype(np.float64) @ proj)[:, :1280]
    # a -100 dB arithmetic floor on unit-variance input is ~1e-5 rms;
    # 3e-4 bounds the max over 2x1280 outputs with margin, while a
    # single TF32 pass (~-70 dB) would exceed it
    np.testing.assert_allclose(np.asarray(out), expected, atol=3e-4)


def test_rfft_backend_runs_on_device():
    """The real-valued mixed-radix FFT backend (dsp/rfft.py, no complex
    dtypes) runs on the device.  Two chunks, checked against the
    projector backend."""
    import jax.numpy as jnp

    from resampler_tpu.engine import fft as fft_engine

    cfg = fft_engine.FftConfig(
        channels=2, fft_size_input=588, fft_size_output=640
    )
    sm = fft_engine.make_fft_step(cfg, backend="matmul")
    sr = fft_engine.make_fft_step(cfg, backend="rfft")
    stm = fft_engine.fft_init(cfg, "matmul")
    str_ = fft_engine.fft_init(cfg, "rfft")
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = jnp.asarray(rng.standard_normal((2, 588)), jnp.float32)
        stm, a = sm(stm, x)
        str_, b = sr(str_, x)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)


def test_sync_tm_matches_slide_on_device():
    """The time-major ring sync step (the bench headline path) equals the
    end-aligned slide sync step on the GPU, across compactions."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 8, 2, 512
    L, M = reduce_ratio(44100, 48000)
    cfg = fe.FirConfig(channels=C, taps=64, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(64, Attenuation.Db90, 44100 / 48000)
    coeffs = fe.fir_coefficients(64, Attenuation.Db90, cutoff)
    slide = jax.jit(
        fe.make_fir_fleet_step_sync(cfg, coeffs, B, channel_major=True)
    )
    tm = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=n_in, horizon=3)
    )
    rng = np.random.default_rng(2)
    sa = fe.fir_fleet_init_sync(cfg, B)
    sb = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
    for _ in range(24):  # crosses several ring compactions
        ch = rng.standard_normal((B, C, n_in)).astype(np.float32)
        nv = jnp.int32(int(rng.integers(1, n_in + 1)))
        sa, oa, ca, pa = slide(sa, jnp.asarray(ch), nv)
        ch_tm = jnp.asarray(np.ascontiguousarray(ch.reshape(B * C, n_in).T))
        sb, ob, cb, pb = tm(sb, ch_tm, nv)
        assert int(ca) == int(cb) and int(pa) == int(pb)
        np.testing.assert_allclose(np.asarray(oa), np.asarray(ob), atol=2e-6)


def test_arbitrary_rate_paths_device_vs_cpu():
    """Both arbitrary-ratio convolve paths (farrow = production,
    gather = table-lerp-exact) compute the same answers on the
    accelerator as on CPU.  Regression for the silent low-precision trap
    inside conv_general_dilated_patches: the one-hot patch extraction is
    a product, and at DEFAULT precision it rounds every window — gates
    any future precision loss in either path's device lowering."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    L, M = reduce_ratio(44100, 44101)
    cfg = fe.FirConfig(channels=2, taps=64, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(64, Attenuation.Db90, 44100 / 44101)
    coeffs = fe.fir_coefficients(64, Attenuation.Db90, cutoff)
    rng = np.random.default_rng(0)
    buf = np.zeros((2, cfg.buffer_alloc), np.float32)
    avail = 3000
    buf[:, cfg.input_capacity - avail : cfg.input_capacity] = (
        rng.standard_normal((2, avail)).astype(np.float32)
    )
    rp = jnp.int32(cfg.input_capacity - avail)
    pos = jnp.int32(12345)
    bud = jnp.int32(cfg.out_capacity)
    n_valid = (avail - cfg.taps + 1) * M // L
    cpu = jax.devices("cpu")[0]
    for path, builder in [
        ("farrow", fe._convolve_farrow), ("gather", fe._convolve_gather)
    ]:
        conv = builder(cfg, coeffs)
        dev = np.asarray(jax.jit(conv)(jnp.asarray(buf), rp, pos, bud))
        with jax.default_device(cpu):
            ref = np.asarray(jax.jit(conv)(jnp.asarray(buf), rp, pos, bud))
        d = np.abs(dev[:n_valid] - ref[:n_valid]).max()
        assert d < 5e-5, f"{path}: device-vs-cpu {d:.2e}"


def test_farrow_sync_fleet_device_vs_cpu():
    """The synchronized Farrow tm fleet (the arbitrary-ratio path)
    computes the same answers on the GPU as on CPU — guarding the
    silent low-precision class for BOTH of its einsums."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 2, 2, 1024
    L, M = reduce_ratio(44100, 44101)
    cfg = fe.FirConfig(channels=C, taps=64, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(64, Attenuation.Db90, 44100 / 44101)
    coeffs = fe.fir_coefficients(64, Attenuation.Db90, cutoff)
    step = fe.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=n_in, horizon=2
    )
    rng = np.random.default_rng(6)
    feeds = [
        rng.standard_normal((n_in, B * C)).astype(np.float32)
        for _ in range(3)
    ]

    def run():
        st = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=2)
        stepped = jax.jit(step)
        outs = []
        for f in feeds:
            st, out, _, p = stepped(st, jnp.asarray(f), jnp.int32(n_in))
            outs.append(np.asarray(out)[:, : int(p)])
        return outs

    dev = run()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run()
    for d, c in zip(dev, cpu):
        assert d.shape == c.shape
        np.testing.assert_allclose(d, c, atol=5e-5)


def test_wide_schedule_on_device():
    """The WIDE (two-word uint32) schedule streams identically on the
    GPU and against the exact-integer oracle — uint32 wraparound
    carries are the device-specific risk here."""
    import jax
    import jax.numpy as jnp

    from reference_models import ScalarFir
    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    in_hz, out_hz = 600011, 600013
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fe.FirConfig(channels=1, taps=32, ratio_num=L, ratio_den=M)
    assert cfg.wide
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    step = jax.jit(fe.make_fir_step(cfg, coeffs))
    st = fe.fir_init(cfg)
    oracle = ScalarFir(1, in_hz, out_hz, 32, Attenuation.Db90.kaiser_beta)
    rng = np.random.default_rng(7)
    produced = 0
    for _ in range(3):
        x = rng.standard_normal(1024).astype(np.float32)
        st, out, c, p = step(
            st, jnp.asarray(x[:, None]), jnp.int32(1024),
            jnp.int32(cfg.out_capacity),
        )
        oc, oy = oracle.resample(x, cfg.out_capacity)
        assert int(c) == oc and int(p) == len(oy)
        if int(p):
            produced += int(p)
            d = np.abs(np.asarray(out)[: int(p), 0] - oy)
            assert np.median(d) < 5e-5
            assert d.max() < 5e-2  # clamp bins
    assert produced > 1500


def test_lerp_sync_tm_fleet_device_vs_cpu():
    """The lerp-basis tm fleet (exact table-lerp semantics riding the
    shared positioning matmul, fir_fleets._farrow_tm_plan(basis="lerp"))
    computes the same answers on the accelerator as on CPU — mirrors
    tests/test_farrow.py::test_lerp_sync_tm_fleet_matches_per_stream's
    CPU differential, here gating the device lowering of the U-row takes
    and the lerped combine)."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C, n_in = 64, 2, 512
    L, M = reduce_ratio(44100, 44101)
    cfg = fe.FirConfig(channels=C, taps=64, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(64, Attenuation.Db90, 44100 / 44101)
    coeffs = fe.fir_coefficients(64, Attenuation.Db90, cutoff)
    step = fe.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=n_in, horizon=3, path="lerp",
    )
    s_dev = jax.jit(step)
    cpu = jax.devices("cpu")[0]
    st_dev = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
    st_cpu = jax.device_put(st_dev, cpu)
    rng = np.random.default_rng(13)
    checked = 0
    for _ in range(6):
        ch = rng.standard_normal((n_in, B * C)).astype(np.float32)
        nv = int(rng.integers(1, n_in + 1))
        st_dev, od, cd, pd = s_dev(st_dev, jnp.asarray(ch), jnp.int32(nv))
        with jax.default_device(cpu):
            st_cpu, oc, cc, pc = jax.jit(step)(
                st_cpu, jax.device_put(ch, cpu), jnp.int32(nv)
            )
        assert int(cd) == int(cc) and int(pd) == int(pc)
        p = int(pd)
        if p:
            checked += 1
            d = np.abs(np.asarray(od)[:, :p] - np.asarray(oc)[:, :p]).max()
            assert d < 5e-5, f"device-vs-cpu {d:.2e}"
    assert checked >= 4


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,n_in",
    [
        (44100, 48000, 64, 512),      # periodic banded atlas
        (44100, 44101, 64, 512),      # coprime Farrow
        (367500, 1601, 32, 2048),     # heavy coprime downsample, q=1
        (600011, 600013, 32, 1024),   # wide (two-word uint32) schedule
    ],
    ids=["periodic", "farrow", "heavy_downsample", "wide"],
)
def test_sync_tm_fleet_device_vs_cpu(in_hz, out_hz, taps, n_in):
    """The synchronized tm fleet at a 128-lane fleet (B=64 stereo) equals
    the same step on the CPU device across ragged feeds and ring
    compactions, for each contraction structure."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fe
    from resampler_tpu.types import reduce_ratio

    B, C = 64, 2
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    step = fe.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=n_in, horizon=3
    )
    rng = np.random.default_rng(5)
    feeds = [
        (rng.standard_normal((n_in, B * C)).astype(np.float32),
         int(rng.integers(n_in // 2, n_in + 1)))
        for _ in range(8)
    ]

    def run():
        st = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=n_in, horizon=3)
        stepped = jax.jit(step)
        outs = []
        for f, nv in feeds:
            st, out, c, p = stepped(st, jnp.asarray(f), jnp.int32(nv))
            outs.append((np.asarray(out)[:, : int(p)], int(c)))
        return outs

    dev = run()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run()
    produced = 0
    for (d, dc), (c, cc) in zip(dev, cpu):
        assert d.shape == c.shape and dc == cc
        np.testing.assert_allclose(d, c, atol=5e-5)
        produced += d.shape[1]
    assert produced > 0
