"""Opt-in reference-schedule parity mode
(``ResamplerFir(..., schedule="reference")``).

Three claims under test:
1. the vectorized host engine is SCHEDULE-IDENTICAL to the sequential
   scalar-loop oracle (tests/reference_models.py::ScalarFirF64) — the
   ``np.add.accumulate`` position sequence reproduces the reference's
   one-IEEE-add-per-output semantics exactly;
2. against the production exact-rational engine it shows exactly the
   documented divergence structure (PARITY.md §2.3): f32-noise
   agreement off phase boundaries, bounded one-phase-step wobble on
   every M-th output;
3. the public surface (resample/process/reset/slew) behaves like the
   default engine's.
(reference: src/resampler_fir.rs:191-196, 542-615)
"""

import numpy as np
import pytest

from resampler_tpu import Attenuation, Latency
from resampler_tpu.engine.fir import ResamplerFir
from resampler_tpu.engine.reference_schedule import ReferenceScheduleFir

from reference_models import ScalarFirF64


def _stream(model_resample, x, chunk, out_cap):
    """Drive an interleaved resample(input, output) loop."""
    out = np.zeros(out_cap, np.float32)
    pieces, offset = [], 0
    while offset < x.size:
        consumed, produced = model_resample(
            x[offset : offset + chunk], out
        )
        pieces.append(out[:produced].copy())
        offset += consumed
        if consumed == 0 and produced == 0:
            break
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


@pytest.mark.parametrize("in_hz,out_hz", [(44100, 48000), (48000, 44100),
                                          (44100, 44101)])
def test_vectorized_matches_scalar_loop(in_hz, out_hz):
    """Claim 1: same coeff table in, schedule-identical streams out."""
    taps = 32
    r = ResamplerFir(
        1, in_hz, out_hz, Latency.Sample16, Attenuation.Db90,
        schedule="reference",
    )
    eng = r._reference
    oracle = ScalarFirF64(1, in_hz, out_hz, taps, 10.0)
    # make the oracle use the PACKAGE's table so only the loop shape
    # differs (beta/cutoff construction is covered elsewhere)
    oracle.coeffs = eng.coeffs.copy()
    assert oracle.taps == eng.taps == taps

    rng = np.random.default_rng(5)
    x = rng.standard_normal(30011).astype(np.float32) * 0.7

    ya = _stream(r.resample, x, 1000, r.buffer_size_output())

    pieces, offset = [], 0
    while offset < x.size:
        c, y = oracle.resample(x[offset : offset + 1000],
                               out_capacity_frames=1 << 16)
        pieces.append(np.asarray(y, np.float32))
        offset += c
        if c == 0 and y.size == 0:
            break
    yb = np.concatenate(pieces)

    n = min(ya.size, yb.size)
    assert n > 20000
    assert abs(ya.size - yb.size) <= 1
    # identical f64 schedule + identical f64 blend; only the dot's
    # association order differs (einsum vs @) -> f64 noise
    np.testing.assert_allclose(ya[:n], yb[:n], atol=1e-6, rtol=0)
    assert np.abs(ya[:n] - yb[:n]).max() < 1e-6


def test_reference_mode_divergence_structure_vs_exact():
    """Claim 2: off-boundary lanes agree to f32 conv noise; boundary
    lanes (every M-th output) carry the documented <=2e-3 wobble."""
    in_hz, out_hz, M = 44100, 48000, 160
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(40000) * 0.5).astype(np.float32)

    exact = ResamplerFir(1, in_hz, out_hz, Latency.Sample64,
                         Attenuation.Db90)
    ref = ResamplerFir(1, in_hz, out_hz, Latency.Sample64,
                       Attenuation.Db90, schedule="reference")
    ya = _stream(exact.resample, x, 512, exact.buffer_size_output())
    yb = _stream(ref.resample, x, 512, exact.buffer_size_output())
    n = min(ya.size, yb.size)
    assert abs(ya.size - yb.size) <= 1
    diff = np.abs(ya[:n].astype(np.float64) - yb[:n].astype(np.float64))
    lanes = np.arange(n)
    boundary = lanes % M == 0
    assert diff[~boundary].max() < 2e-5  # f32 device conv vs f64 host
    # one-phase-step wobble (~2e-3 for this draw) + device f32 conv noise
    assert diff[boundary].max() < 3e-3
    # and the wobble REALLY exists (this mode isn't the exact engine)
    assert diff[boundary].max() > 10 * diff[~boundary].max()


def test_reference_mode_public_surface():
    """Claim 3: process()/reset()/slew()/chunked streaming behave."""
    r = ResamplerFir(2, 48000, 44100, Latency.Sample32, Attenuation.Db90,
                     schedule="reference")
    t = np.arange(24000) / 48000
    tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    x = np.repeat(tone, 2)
    y = r.process(x)
    assert y.size > 0 and y.size % 2 == 0
    yl = y[0::2]
    zc = np.where(np.diff(np.sign(yl)) > 0)[0]
    f = 44100 * (len(zc) - 1) / (zc[-1] - zc[0])
    assert abs(f - 440.0) < 1.5
    assert abs(np.abs(yl[2000:]).max() - 0.5) < 0.01

    # chunked ~ one-shot: the f64 schedule is only wobble-invariant to
    # chunking — `position -= consumed` happens at chunk-dependent
    # times, so `+= ratio` rounds differently near phase boundaries
    # (the reference behaves identically; the exact engine is the one
    # that's bit-invariant to chunking, tests/test_fir_engine.py::
    # test_stream_invariance)
    r.reset()
    y2 = _stream(r.resample, x, 702, r.buffer_size_output())
    n = min(y.size, y2.size)
    diff = np.abs(y[:n] - y2[:n])
    assert diff.max() < 2e-3  # boundary wobble class
    assert np.median(diff) < 1e-6  # off-boundary lanes identical

    # slew skips signal time (positive => output advances)
    r.reset()
    applied = r.slew(10.25)
    assert applied == 10.25
    y3 = r.process(x)
    assert y3.size < y.size  # skipped history produces fewer samples

    with pytest.raises(ValueError, match="schedule"):
        ResamplerFir(1, 48000, 44100, schedule="f64")


def test_reference_mode_wide_rates():
    """The f64 schedule takes arbitrary u32 pairs naturally (same as the
    reference); sanity at a wide coprime pair."""
    r = ResamplerFir(1, 600011, 600013, Latency.Sample16,
                     Attenuation.Db90, schedule="reference")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(20000).astype(np.float32)
    y = _stream(r.resample, x, 1024, r.buffer_size_output())
    assert y.size > 15000
    assert np.isfinite(y).all()


def test_reference_schedule_budget_and_starvation():
    """Output budget caps production; zero-feed steps produce nothing
    once the buffer is drained below taps."""
    eng = ReferenceScheduleFir(
        1, Latency.Sample16.taps,
        ResamplerFir(1, 48000, 48000, Latency.Sample16,
                     Attenuation.Db90)._coeffs,
        48000, 48000,
    )
    x = np.ones((100, 1), np.float32)
    consumed, out = eng.resample_frames(x, 10)
    assert consumed == 100 and len(out) == 10
    consumed, out = eng.resample_frames(np.zeros((0, 1), np.float32), 1000)
    assert consumed == 0 and 0 < len(out) <= 100
    consumed, out = eng.resample_frames(np.zeros((0, 1), np.float32), 1000)
    assert len(out) == 0
