"""Farrow polynomial path — the production arbitrary-ratio FIR path.

The Farrow path evaluates the CONTINUOUS coefficient kernel (degree-7
Chebyshev per tap, see fe.FARROW_DEGREE); the gather path reproduces the reference's
1024-phase table LERP.  They agree to the lerp's own interpolation error
(~1e-6 relative) everywhere except the reference's phase-1023 clamp bin
(src/resampler_fir.rs quirk: p2 = min(p1+1, 1023) holds the last 1/1024
of the phase turn constant, ~3e-3 from the true kernel) — the tests are
clamp-aware.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from resampler_tpu.engine import fir as fe
from resampler_tpu.types import Attenuation, Latency, reduce_ratio


def _build(in_hz, out_hz, taps=64):
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fe.FirConfig(channels=2, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    return cfg, coeffs


def test_farrow_matrix_residual():
    _, coeffs = _build(44100, 44101)
    A, resid = fe.farrow_matrix(coeffs)
    assert A.shape == (fe.FARROW_DEGREE + 1, 64)
    # grid residual: ~8.7e-7 at degree 7 — below the 1024-phase table
    # lerp's own ~1.2e-6 interpolation error
    assert resid < 1.2e-6, resid


def test_auto_path_is_farrow_for_coprime():
    cfg, _ = _build(44100, 44101)
    assert fe.resolve_convolve_path(cfg) == "farrow"
    cfg2, _ = _build(44100, 48000)
    assert fe.resolve_convolve_path(cfg2) == "periodic"


@pytest.mark.parametrize("pos", [0, 12345, 44100])
def test_farrow_vs_gather_clamp_aware(pos):
    """Single-convolve differential with the clamp bins separated."""
    cfg, coeffs = _build(44100, 44101)
    conv_f = fe._convolve_farrow(cfg, coeffs)
    conv_g = fe._convolve_gather(cfg, coeffs)
    rng = np.random.default_rng(0)
    buf = np.zeros((2, cfg.buffer_alloc), np.float32)
    avail = 3000
    buf[:, cfg.input_capacity - avail : cfg.input_capacity] = (
        rng.standard_normal((2, avail)).astype(np.float32)
    )
    rp = jnp.int32(cfg.input_capacity - avail)
    of = np.asarray(
        jax.jit(conv_f)(jnp.asarray(buf), rp, jnp.int32(pos),
                        jnp.int32(cfg.out_capacity))
    )
    og = np.asarray(
        jax.jit(conv_g)(jnp.asarray(buf), rp, jnp.int32(pos),
                        jnp.int32(cfg.out_capacity))
    )
    n_valid = (avail - cfg.taps + 1) * cfg.ratio_den // cfg.ratio_num

    # recompute each output's phase index independently (numpy, exact)
    M_, phases = cfg.ratio_den, cfg.phases
    i = np.arange(n_valid, dtype=np.int64)
    num = (pos % M_) + (i * cfg.ratio_num) % M_
    rem = num % M_
    p1 = (rem * phases) // M_
    clamp = p1 >= phases - 1  # the reference clamp bin

    diff = np.abs(of[:n_valid] - og[:n_valid]).max(axis=1)
    if (~clamp).any():
        assert diff[~clamp].max() < 5e-5, diff[~clamp].max()
    if clamp.any():
        assert diff[clamp].max() < 2e-2, diff[clamp].max()


def test_farrow_streaming_matches_gather():
    """Full streaming step: identical consumed/produced bookkeeping, and
    outputs agree to the lerp floor at the 99th percentile (clamp bins
    are ~1/1024 of outputs)."""
    cfg, coeffs = _build(44100, 88201, taps=32)
    step_f = jax.jit(fe.make_fir_step(cfg, coeffs, path="farrow"))
    step_g = jax.jit(fe.make_fir_step(cfg, coeffs, path="gather"))
    sf = fe.fir_init(cfg)
    sg = fe.fir_init(cfg)
    rng = np.random.default_rng(1)
    L_, M_, phases = cfg.ratio_num, cfg.ratio_den, cfg.phases
    diffs, clamps = [], []
    for _ in range(6):
        n = 512
        chunk = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
        nv = jnp.int32(int(rng.integers(1, n + 1)))
        bud = jnp.int32(cfg.out_capacity)
        pos0 = int(sg["pos_num"])  # exact schedule shared by both paths
        sf, outf, cf, pf = step_f(sf, chunk, nv, bud)
        sg, outg, cg, pg = step_g(sg, chunk, nv, bud)
        assert int(cf) == int(cg) and int(pf) == int(pg)
        p = int(pf)
        if p:
            diffs.append(
                np.abs(np.asarray(outf)[:p] - np.asarray(outg)[:p]).max(axis=1)
            )
            i = np.arange(p, dtype=np.int64)
            rem = (pos0 + i * L_) % M_
            clamps.append((rem * phases) // M_ >= phases - 1)
    d = np.concatenate(diffs)
    clamp = np.concatenate(clamps)
    assert d.max() < 2e-2
    if (~clamp).any():
        assert d[~clamp].max() < 5e-5, d[~clamp].max()


def test_farrow_stopband():
    """Alias rejection through the public wrapper on a coprime pair with
    the default (farrow) path — same procedure as
    test_fir_engine.test_stopband_attenuation."""
    from resampler_tpu import ResamplerFir

    in_hz, out_hz = 44100, 88201
    n = 30000
    x = np.zeros(n, np.float32)
    x[n // 2] = 1.0
    r = ResamplerFir(1, in_hz, out_hz, Latency.Sample64, Attenuation.Db90)
    out_buf = np.zeros(r.buffer_size_output(), np.float32)
    pieces, offset = [], 0
    while offset < n:
        end = min(offset + 2048, n)
        consumed, produced = r.resample(x[offset:end], out_buf)
        pieces.append(out_buf[:produced].copy())
        offset += consumed
        if consumed == 0 and produced == 0:
            break
    y = np.concatenate(pieces)

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
    assert att >= 90.0, f"farrow stopband {att:.1f} dB"


@pytest.mark.parametrize("seed", [0, 1])
def test_farrow_random_ratio_properties(seed):
    """Property fuzz over random coprime ratios: the farrow path must
    keep exact consumed/produced bookkeeping vs the gather path (shared
    schedule), produce finite outputs, and agree off-clamp — across
    geometries the SampleRate matrix never exercises (tiny and large
    L/M, upsampling and downsampling)."""
    rng = np.random.default_rng(100 + seed)
    pairs = []
    while len(pairs) < 4:
        in_hz = int(rng.integers(8000, 200000))
        out_hz = int(rng.integers(8000, 200000))
        L, M = reduce_ratio(in_hz, out_hz)
        if M > fe.MAX_PERIOD and L <= (1 << 31) // (4096 + 2):
            pairs.append((in_hz, out_hz))
    for in_hz, out_hz in pairs:
        L, M = reduce_ratio(in_hz, out_hz)
        cfg = fe.FirConfig(channels=1, taps=32, ratio_num=L, ratio_den=M)
        cutoff = fe.fir_cutoff(32, Attenuation.Db90, in_hz / out_hz)
        coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
        step_f = jax.jit(fe.make_fir_step(cfg, coeffs, path="farrow"))
        step_g = jax.jit(fe.make_fir_step(cfg, coeffs, path="gather"))
        sf, sg = fe.fir_init(cfg), fe.fir_init(cfg)
        total_in = total_out = 0
        for _ in range(3):
            n = 512
            chunk = jnp.asarray(rng.standard_normal((n, 1)), jnp.float32)
            nv = jnp.int32(int(rng.integers(1, n + 1)))
            sf, outf, cf, pf = step_f(sf, chunk, nv, jnp.int32(cfg.out_capacity))
            sg, outg, cg, pg = step_g(sg, chunk, nv, jnp.int32(cfg.out_capacity))
            assert int(cf) == int(cg) and int(pf) == int(pg), (in_hz, out_hz)
            p = int(pf)
            total_in += int(cf)
            total_out += p
            if not p:
                continue
            of = np.asarray(outf)[:p]
            assert np.isfinite(of).all(), (in_hz, out_hz)
            d = np.abs(of - np.asarray(outg)[:p])
            # off-clamp must agree to the lerp floor; clamp bins (~1/1024
            # of outputs) may deviate by the reference-clamp quirk
            assert np.median(d) < 5e-5, (in_hz, out_hz, np.median(d))
            assert d.max() < 5e-2, (in_hz, out_hz, d.max())
        # long-run rate conservation: outputs ~= inputs * M / L
        if total_in:
            expect = total_in * M / L
            assert abs(total_out - expect) <= cfg.taps * M / L + 2, (
                in_hz, out_hz, total_out, expect
            )


@pytest.mark.parametrize(
    "in_hz,out_hz",
    [(48000, 44101), (44100, 96001), (96001, 44100)],
)
def test_farrow_taps128_geometry(in_hz, out_hz):
    """Regression: at the default taps=128 geometry, block_base.max() +
    w_max could fall SHORT of p_len (the widest local span landing in the
    last block), producing a negative jnp.pad width that crashed the
    first step of many auto-selected ratios (48000->44101 and ~13% of
    swept coprime pairs).  The taps=32 fuzz above never hits this; these
    pairs do.  Gates both trace-time success and the gather differential."""
    cfg, coeffs = _build(in_hz, out_hz, taps=128)
    assert fe.resolve_convolve_path(cfg) == "farrow"
    step_f = jax.jit(fe.make_fir_step(cfg, coeffs, path="farrow"))
    step_g = jax.jit(fe.make_fir_step(cfg, coeffs, path="gather"))
    sf, sg = fe.fir_init(cfg), fe.fir_init(cfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        chunk = jnp.asarray(rng.standard_normal((1024, 2)), jnp.float32)
        sf, outf, cf, pf = step_f(
            sf, chunk, jnp.int32(1024), jnp.int32(cfg.out_capacity)
        )
        sg, outg, cg, pg = step_g(
            sg, chunk, jnp.int32(1024), jnp.int32(cfg.out_capacity)
        )
        assert int(cf) == int(cg) and int(pf) == int(pg)
        p = int(pf)
        if p:
            of = np.asarray(outf)[:p]
            assert np.isfinite(of).all()
            d = np.abs(of - np.asarray(outg)[:p])
            assert np.median(d) < 5e-5, np.median(d)
            assert d.max() < 5e-2, d.max()


@pytest.mark.parametrize(
    "in_hz,out_hz,taps",
    [(44100, 44101, 64), (48000, 44101, 128), (367500, 1601, 32)],
)
def test_farrow_sync_tm_fleet_matches_per_stream(in_hz, out_hz, taps):
    """The synchronized time-major Farrow fleet (shared positioning
    matmul + blocked fleet-wide contraction) matches the per-stream
    farrow engine across steps and ring compactions — the production
    arbitrary-ratio serving path."""
    L, M = reduce_ratio(in_hz, out_hz)
    B, C = 3, 2
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    assert fe.resolve_convolve_path(cfg) == "farrow"
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    tm_step = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=1024,
                                       horizon=3)
    )
    ps_step = jax.jit(fe.make_fir_step(cfg, coeffs, path="farrow"))
    tm_state = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=1024, horizon=3)
    ps_states = [fe.fir_init(cfg) for _ in range(B)]
    rng = np.random.default_rng(0)
    produced_steps = 0
    for _ in range(10):
        chunk = rng.standard_normal((B, 1024, C)).astype(np.float32)
        tm_feed = jnp.asarray(
            np.transpose(chunk, (1, 0, 2)).reshape(1024, B * C)
        )
        tm_state, out_tm, c_tm, p_tm = tm_step(
            tm_state, tm_feed, jnp.int32(1024)
        )
        for b in range(B):
            ps_states[b], out_ps, c_ps, p_ps = ps_step(
                ps_states[b], jnp.asarray(chunk[b]), jnp.int32(1024),
                jnp.int32(cfg.out_capacity),
            )
            assert int(c_tm) == int(c_ps) and int(p_tm) == int(p_ps)
            p = int(p_tm)
            if p:
                produced_steps += 1
                np.testing.assert_allclose(
                    np.asarray(out_tm)[b, :p], np.asarray(out_ps)[:p],
                    atol=1e-5,
                )
    assert produced_steps >= 10


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,chunk,meshed",
    [
        (44100, 48000, 64, 512, False),   # periodic banded atlas
        (44100, 44101, 64, 512, False),   # Farrow, q % 8 == 0 blocks
        (367500, 1601, 32, 2048, False),  # heavy downsample, q = 1
        (48000, 1601, 32, 2048, False),   # q = 2
        (48000, 3001, 32, 2048, False),   # q = 4
        (44100, 48000, 32, 512, True),    # periodic, 8-device mesh
    ],
    ids=["periodic", "farrow", "q1", "q2", "q4", "periodic_mesh"],
)
def test_sync_tm_fleet_block_geometries_match_per_stream(
    in_hz, out_hz, taps, chunk, meshed
):
    """The XLA sync tm step against the per-stream engine at each block
    geometry of its contraction (periodic atlas; Farrow block heights
    q = 1, 2, 4 and q % 8 == 0), under a ragged shared feed across ring
    compactions — and lane-sharded over the 8-device mesh."""
    from resampler_tpu.parallel.sharding import shard_lanes, stream_mesh

    L, M = reduce_ratio(in_hz, out_hz)
    B, C = 8 if meshed else 2, 2
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    tm_step = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=chunk,
                                       horizon=3)
    )
    ps_step = jax.jit(fe.make_fir_step(cfg, coeffs))
    tm_state = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=chunk, horizon=3)
    if meshed:
        tm_state = shard_lanes(tm_state, stream_mesh())
    ps_states = [fe.fir_init(cfg) for _ in range(B)]
    rng = np.random.default_rng(7)
    produced_steps = 0
    for nv in [chunk, chunk // 2, 0, chunk, 17, chunk]:
        data = rng.standard_normal((B, chunk, C)).astype(np.float32)
        feed = np.transpose(data, (1, 0, 2)).reshape(chunk, B * C)
        tm_state, out_tm, c_tm, p_tm = tm_step(
            tm_state, jnp.asarray(feed), jnp.int32(nv)
        )
        for b in range(B):
            ps_states[b], out_ps, c_ps, p_ps = ps_step(
                ps_states[b], jnp.asarray(data[b]), jnp.int32(nv),
                jnp.int32(cfg.out_capacity),
            )
            assert int(c_tm) == int(c_ps) and int(p_tm) == int(p_ps)
            p = int(p_tm)
            if p:
                produced_steps += 1
                np.testing.assert_allclose(
                    np.asarray(out_tm)[b, :p], np.asarray(out_ps)[:p],
                    atol=1e-5,
                )
    assert produced_steps >= 3 * B


@pytest.mark.parametrize(
    "in_hz,out_hz,taps",
    [(44100, 44101, 64), (48000, 44101, 128), (367500, 1601, 32)],
)
def test_lerp_sync_tm_fleet_matches_per_stream(in_hz, out_hz, taps):
    """``path="lerp"`` on the synchronized tm fleet (the SVD table basis
    riding the shared positioning matmul) matches the per-stream lerp
    engine — i.e. the fleet serves the reference's EXACT table-lerp
    interpolation semantics (incl. the p2 = min(p1+1, 1023) clamp,
    src/resampler_fir.rs:556-565), not the Farrow approximation."""
    L, M = reduce_ratio(in_hz, out_hz)
    B, C = 3, 2
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    tm_step = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=1024,
                                       horizon=3, path="lerp")
    )
    ps_step = jax.jit(fe.make_fir_step(cfg, coeffs, path="lerp"))
    tm_state = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=1024, horizon=3)
    ps_states = [fe.fir_init(cfg) for _ in range(B)]
    rng = np.random.default_rng(11)
    produced_steps = 0
    for _ in range(10):
        chunk = rng.standard_normal((B, 1024, C)).astype(np.float32)
        tm_feed = jnp.asarray(
            np.transpose(chunk, (1, 0, 2)).reshape(1024, B * C)
        )
        tm_state, out_tm, c_tm, p_tm = tm_step(
            tm_state, tm_feed, jnp.int32(1024)
        )
        for b in range(B):
            ps_states[b], out_ps, c_ps, p_ps = ps_step(
                ps_states[b], jnp.asarray(chunk[b]), jnp.int32(1024),
                jnp.int32(cfg.out_capacity),
            )
            assert int(c_tm) == int(c_ps) and int(p_tm) == int(p_ps)
            p = int(p_tm)
            if p:
                produced_steps += 1
                np.testing.assert_allclose(
                    np.asarray(out_tm)[b, :p], np.asarray(out_ps)[:p],
                    atol=1e-5,
                )
    assert produced_steps >= 10


@pytest.mark.parametrize(
    "in_hz,out_hz",
    [(600011, 600013), (4000000000, 4000000001), (1000003, 999983)],
)
def test_wide_sync_tm_fleet_matches_per_stream(in_hz, out_hz):
    """WIDE pairs (beyond the int32 schedule envelope) on the
    synchronized time-major fleet: the shared (pos_hi, pos_lo) uint32
    schedule + emission-mask accounting must match the per-stream wide
    step exactly in bookkeeping and to float tolerance in samples."""
    L, M = reduce_ratio(in_hz, out_hz)
    B, C = 3, 2
    taps = 32
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    assert cfg.wide
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    tm_step = jax.jit(
        fe.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=1024,
                                       horizon=3)
    )
    ps_step = jax.jit(fe.make_fir_step(cfg, coeffs))
    tm_state = fe.fir_fleet_init_sync_tm(cfg, B, max_chunk=1024, horizon=3)
    ps_states = [fe.fir_init(cfg) for _ in range(B)]
    rng = np.random.default_rng(3)
    produced_steps = 0
    for _ in range(8):
        chunk = rng.standard_normal((B, 1024, C)).astype(np.float32)
        tm_feed = jnp.asarray(
            np.transpose(chunk, (1, 0, 2)).reshape(1024, B * C)
        )
        tm_state, out_tm, c_tm, p_tm = tm_step(
            tm_state, tm_feed, jnp.int32(1024)
        )
        for b in range(B):
            ps_states[b], out_ps, c_ps, p_ps = ps_step(
                ps_states[b], jnp.asarray(chunk[b]), jnp.int32(1024),
                jnp.int32(cfg.out_capacity),
            )
            assert int(c_tm) == int(c_ps) and int(p_tm) == int(p_ps)
            p = int(p_tm)
            if p:
                produced_steps += 1
                np.testing.assert_allclose(
                    np.asarray(out_tm)[b, :p], np.asarray(out_ps)[:p],
                    atol=1e-5,
                )
    assert produced_steps >= 8
    # shared wide phase words advanced identically to the per-stream state
    assert int(tm_state["pos_hi"]) == int(ps_states[0]["pos_hi"])
    assert int(tm_state["pos_lo"]) == int(ps_states[0]["pos_lo"])


def test_heavy_downsample_stays_on_farrow():
    """Heavy coprime downsampling (large L/M) must stay on the farrow
    production structure: the block size adapts (q shrinks toward 1) so
    the per-block span stays bounded, instead of auto-falling back to
    the slow gather path as an earlier design did."""
    L, M = reduce_ratio(367500, 1601)  # L/M ~ 230, coprime
    cfg = fe.FirConfig(channels=1, taps=32, ratio_num=L, ratio_den=M)
    assert fe.resolve_convolve_path(cfg) == "farrow"
    assert fe.farrow_block_size(L, M) == 1
    # and a moderate coprime downsample stays farrow with a larger block
    L2, M2 = reduce_ratio(88200, 44101)
    cfg2 = fe.FirConfig(channels=1, taps=32, ratio_num=L2, ratio_den=M2)
    assert fe.resolve_convolve_path(cfg2) == "farrow"
    assert fe.farrow_block_size(L2, M2) == 32


@pytest.mark.parametrize(
    "in_hz,out_hz", [(367500, 1601), (192000, 4801), (44100, 443101)]
)
def test_farrow_extreme_ratio_differential(in_hz, out_hz):
    """Extreme coprime ratios (heavy downsample L/M ~ 230 and ~40, and a
    large-M upsample) stream correctly on the adaptive-block farrow path:
    bookkeeping matches the table-lerp gather path exactly and outputs
    agree off-clamp.  (Pairs beyond the int32 envelope are covered by
    the wide-schedule oracle tests below.)"""
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fe.FirConfig(channels=1, taps=32, ratio_num=L, ratio_den=M)
    assert fe.resolve_convolve_path(cfg) == "farrow"
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    step_f = jax.jit(fe.make_fir_step(cfg, coeffs, path="farrow"))
    step_g = jax.jit(fe.make_fir_step(cfg, coeffs, path="gather"))
    sf, sg = fe.fir_init(cfg), fe.fir_init(cfg)
    rng = np.random.default_rng(5)
    got_any = False
    for _ in range(4):
        chunk = jnp.asarray(rng.standard_normal((2048, 1)), jnp.float32)
        sf, outf, cf, pf = step_f(
            sf, chunk, jnp.int32(2048), jnp.int32(cfg.out_capacity)
        )
        sg, outg, cg, pg = step_g(
            sg, chunk, jnp.int32(2048), jnp.int32(cfg.out_capacity)
        )
        assert int(cf) == int(cg) and int(pf) == int(pg)
        p = int(pf)
        if p:
            got_any = True
            of = np.asarray(outf)[:p]
            assert np.isfinite(of).all()
            d = np.abs(of - np.asarray(outg)[:p])
            assert np.median(d) < 5e-5, np.median(d)
            assert d.max() < 5e-2, d.max()
    assert got_any


# ---------------------------------------------------------------------------
# Wide schedule: any nonzero u32 rate pair (reference parity,
# src/resampler_fir.rs:295-330 + CHANGELOG #36)
# ---------------------------------------------------------------------------


def _clamp_bins(pos0, L, M, n, phases=1024):
    """Exact host computation of which outputs fall in the reference's
    phase-1023 clamp bin (where the continuous farrow kernel deviates)."""
    i = np.arange(n, dtype=object)
    rem = [(pos0 + int(ii) * L) % M for ii in i]
    return np.array([(r * phases) // M >= phases - 1 for r in rem])


@pytest.mark.parametrize(
    "in_hz,out_hz",
    [
        (600011, 600013),          # near-unity coprime beyond int32
        (44100, 1000003),          # large-M upsample
        (4000000000, 4000000001),  # near-u32-max pair
        (3999999999, 7),           # downsample by ~571M: skip-mode strides
    ],
)
def test_wide_schedule_matches_scalar_oracle(in_hz, out_hz):
    """Beyond the int32 envelope the engine carries position as two u32
    words; bookkeeping must match the exact-integer scalar oracle EXACTLY
    and outputs agree off-clamp — for any nonzero u32 pair."""
    from reference_models import ScalarFir

    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fe.FirConfig(channels=1, taps=32, ratio_num=L, ratio_den=M)
    assert cfg.wide
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    step = jax.jit(fe.make_fir_step(cfg, coeffs))
    st = fe.fir_init(cfg)
    oracle = ScalarFir(1, in_hz, out_hz, 32, Attenuation.Db90.kaiser_beta)
    rng = np.random.default_rng(2)
    produced_any = False
    for _ in range(4):
        n = 1024
        x = rng.standard_normal(n).astype(np.float32)
        pos0 = oracle.pos_num
        st, out, c, p = step(
            st, jnp.asarray(x[:, None]), jnp.int32(n),
            jnp.int32(cfg.out_capacity),
        )
        oc, oy = oracle.resample(x, cfg.out_capacity)
        assert int(c) == oc and int(p) == len(oy)
        p = int(p)
        if p:
            produced_any = True
            d = np.abs(np.asarray(out)[:p, 0] - oy)
            clamp = _clamp_bins(pos0, L, M, p)
            if (~clamp).any():
                assert d[~clamp].max() < 5e-5, d[~clamp].max()
            assert d.max() < 5e-2
    assert produced_any


def test_wide_wrapper_end_to_end():
    """Public wrapper on a u32-scale coprime pair: a tone keeps its
    frequency and amplitude, the length ratio tracks the rate ratio, and
    slew still works (wide state carries pos as two u32 words)."""
    from resampler_tpu import Attenuation as Att, Latency as Lat, ResamplerFir

    in_hz, out_hz = 600011, 600013
    n = 30000
    t = np.arange(n) / in_hz
    x = (0.5 * np.sin(2 * np.pi * 10007.0 * t)).astype(np.float32)
    r = ResamplerFir.new_from_hz(1, in_hz, out_hz, Lat.Sample32, Att.Db90)
    y = r.process(x)
    assert abs(len(y) / n - out_hz / in_hz) < 0.01
    seg = y[2000:-2000]
    zc = np.sum(np.diff(np.signbit(seg)) != 0)
    freq = zc / 2 / (seg.size / out_hz)
    assert abs(freq - 10007.0) < 5.0, freq
    assert abs(np.abs(seg).max() - 0.5) < 0.01

    applied = r.slew(1.25)
    assert abs(applied - 1.25) < 1.0 / 600013
    assert r.slew(-1e12) <= 0.0  # clamped at buffered history


@pytest.mark.parametrize("seed", [0, 1])
def test_wide_random_u32_ratio_fuzz(seed):
    """Property fuzz over random u32-range coprime pairs: construct,
    stream, exact bookkeeping vs the oracle, finite outputs: any
    nonzero u32 pair constructs and streams correctly."""
    from reference_models import ScalarFir

    rng = np.random.default_rng(2000 + seed)
    pairs = []
    while len(pairs) < 3:
        in_hz = int(rng.integers(1, 1 << 32))
        out_hz = int(rng.integers(1, 1 << 32))
        L, M = reduce_ratio(in_hz, out_hz)
        cfg = fe.FirConfig(channels=1, taps=16, ratio_num=L, ratio_den=M)
        # keep the fuzz fast: skip extreme-upsample geometries whose
        # out_capacity would dominate CPU compile time (covered by the
        # dedicated large-M case above)
        if cfg.wide and cfg.out_capacity <= 20000:
            pairs.append((in_hz, out_hz))
    for in_hz, out_hz in pairs:
        L, M = reduce_ratio(in_hz, out_hz)
        cfg = fe.FirConfig(channels=1, taps=16, ratio_num=L, ratio_den=M)
        cutoff = fe.fir_cutoff(16, Attenuation.Db90, in_hz / out_hz)
        coeffs = fe.fir_coefficients(16, Attenuation.Db90, cutoff)
        step = jax.jit(fe.make_fir_step(cfg, coeffs))
        st = fe.fir_init(cfg)
        oracle = ScalarFir(1, in_hz, out_hz, 16, Attenuation.Db90.kaiser_beta)
        for _ in range(3):
            x = rng.standard_normal(512).astype(np.float32)
            st, out, c, p = step(
                st, jnp.asarray(x[:, None]), jnp.int32(512),
                jnp.int32(cfg.out_capacity),
            )
            oc, oy = oracle.resample(x, cfg.out_capacity)
            assert int(c) == oc and int(p) == len(oy), (in_hz, out_hz)
            if int(p):
                of = np.asarray(out)[: int(p), 0]
                assert np.isfinite(of).all()
                assert np.median(np.abs(of - oy)) < 5e-5, (in_hz, out_hz)


def test_lerp_path_matches_gather_everywhere():
    """The SVD-factorized lerp path computes the gather oracle's exact
    table-lerp semantics INCLUDING the phase-1023 clamp bins (unlike
    farrow, which evaluates the continuous kernel there) — agreement to
    the factorization floor on every output lane."""
    cfg, coeffs = _build(44100, 88201, taps=32)
    step_l = jax.jit(fe.make_fir_step(cfg, coeffs, path="lerp"))
    step_g = jax.jit(fe.make_fir_step(cfg, coeffs, path="gather"))
    sl = fe.fir_init(cfg)
    sg = fe.fir_init(cfg)
    rng = np.random.default_rng(2)
    worst = 0.0
    total = 0
    for _ in range(6):
        n = 512
        chunk = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
        nv = jnp.int32(int(rng.integers(1, n + 1)))
        bud = jnp.int32(cfg.out_capacity)
        sl, outl, cl, pl_ = step_l(sl, chunk, nv, bud)
        sg, outg, cg, pg = step_g(sg, chunk, nv, bud)
        assert int(cl) == int(cg) and int(pl_) == int(pg)
        p = int(pl_)
        if p:
            worst = max(
                worst,
                float(
                    np.abs(np.asarray(outl)[:p] - np.asarray(outg)[:p]).max()
                ),
            )
            total += p
    assert total > 1000
    assert worst < 5e-6, worst  # SVD tol 1e-7 + f32 conv noise


@pytest.mark.parametrize("in_hz,out_hz,taps", [
    (44100, 44101, 64), (367500, 1601, 32), (48000, 44101, 128),
])
def test_lerp_path_ratio_sweep(in_hz, out_hz, taps):
    cfg, coeffs = _build(in_hz, out_hz, taps=taps)
    step_l = jax.jit(fe.make_fir_step(cfg, coeffs, path="lerp"))
    step_g = jax.jit(fe.make_fir_step(cfg, coeffs, path="gather"))
    sl, sg = fe.fir_init(cfg), fe.fir_init(cfg)
    rng = np.random.default_rng(3)
    got = 0
    for _ in range(4):
        chunk = jnp.asarray(rng.standard_normal((1024, 2)), jnp.float32)
        bud = jnp.int32(cfg.out_capacity)
        sl, outl, cl, pl_ = step_l(sl, chunk, jnp.int32(1024), bud)
        sg, outg, cg, pg = step_g(sg, chunk, jnp.int32(1024), bud)
        assert int(cl) == int(cg) and int(pl_) == int(pg)
        p = int(pl_)
        if p:
            np.testing.assert_allclose(
                np.asarray(outl)[:p], np.asarray(outg)[:p], atol=1e-5
            )
            got += p
    assert got > 0


def test_lerp_rank_is_small():
    """The phase table's f32-accuracy numerical rank stays small (a cheap basis matmul)."""
    for taps in (32, 64, 128):
        _, coeffs = _build(44100, 44101, taps=taps)
        U, A = fe._table_svd_basis(coeffs)
        assert A.shape[0] <= 40, (taps, A.shape)
        T = np.asarray(coeffs, np.float64)
        err = np.abs(U.astype(np.float64) @ A.astype(np.float64) - T).max()
        assert err < 2e-6  # f32 storage of the f64 factors


def test_lerp_path_rejects_wide():
    cfg = fe.FirConfig(
        channels=1, taps=16, ratio_num=600011, ratio_den=600013
    )
    coeffs = fe.fir_coefficients(16, Attenuation.Db90, 0.9)
    with pytest.raises(ValueError, match="wide|farrow"):
        fe.make_fir_step(cfg, coeffs, path="lerp")
