"""On-device differentials for the ASYNC time-major FIR fleet.

This tier runs the same step on the GPU and on CPU and compares — the
class of bug it guards (a silent lowering divergence such as a product
rounded to low precision) is invisible to CPU-green suites.  Pattern:
``test_farrow_sync_fleet_device_vs_cpu``; reference per-kernel rule:
every native kernel gets a differential
(reference: src/fft/butterflies/mod.rs:129-290).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from resampler_tpu.engine import fir as fe
from resampler_tpu.types import Attenuation, reduce_ratio

pytestmark = pytest.mark.gpu


def _run_async(in_hz, out_hz, taps, phases, feeds, horizon=2,
               skew_periods=1, **step_kw):
    """One async-fleet run over ``feeds`` [(n_valid, data), ...]; returns
    the per-step outputs truncated to the produced count."""
    L, M = reduce_ratio(in_hz, out_hz)
    B, C = len(phases), 2
    chunk = feeds[0][1].shape[0]
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    step = jax.jit(
        fe.make_fir_fleet_step_async_tm(
            cfg, coeffs, B, max_chunk=chunk, horizon=horizon,
            skew_periods=skew_periods, **step_kw,
        )
    )
    st = fe.fir_fleet_init_async_tm(
        cfg, B, max_chunk=chunk, horizon=horizon,
        pos_num=np.asarray(phases, object), skew_periods=skew_periods,
    )
    outs = []
    for nv, data in feeds:
        st, out, c, p = step(st, jnp.asarray(data), jnp.int32(nv))
        outs.append(np.asarray(out)[:, : int(p)])
    return outs


def _device_vs_cpu(in_hz, out_hz, taps, phases, feed_valid,
                   chunk=512, **kw):
    rng = np.random.default_rng(11)
    B, C = len(phases), 2
    feeds = []
    for nv in feed_valid:
        data = rng.standard_normal((chunk, B * C)).astype(np.float32)
        data[nv:] = 0.0
        feeds.append((nv, data))

    dev = _run_async(in_hz, out_hz, taps, phases, feeds, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = _run_async(in_hz, out_hz, taps, phases, feeds, **kw)

    total = 0
    for d, c in zip(dev, cpu):
        assert d.shape == c.shape
        np.testing.assert_allclose(d, c, atol=5e-5)
        total += d.shape[1]
    assert total > 1000  # the run actually produced output


def test_async_fleet_device_vs_cpu_narrow():
    """Narrow (int32-schedule) branch at the bench's coprime pair:
    independent phases, ragged feed incl. a starved step, horizon=2 so
    the ring compacts mid-run (slot wraparound)."""
    M = reduce_ratio(44100, 44101)[1]
    _device_vs_cpu(
        44100, 44101, 64,
        phases=[0, M // 3, M - 1, 12345],
        feed_valid=[512, 0, 300, 512, 17, 512, 512, 512, 400, 512],
    )


def test_async_fleet_device_vs_cpu_downsample_wrap():
    """Coprime downsampling: wrap bits fire on most lanes and the
    fleet-min schedule runs on the laggard stream."""
    _device_vs_cpu(
        48000, 44101, 32,
        phases=[0, 999, 44000],
        feed_valid=[512] * 8,
    )


def test_async_fleet_device_vs_cpu_upsample_skew2():
    """Upsampling with skew_periods=2: the region read widens and the
    per-stream base_rel select walks beyond one period."""
    M = reduce_ratio(44100, 48000)[1]
    _device_vs_cpu(
        44100, 48000, 16,
        phases=[0, M, 2 * M - 1],
        feed_valid=[512] * 8,
        skew_periods=2,
    )


def test_async_fleet_device_vs_cpu_wide():
    """WIDE (u32 two-word) branch: positions as (pos_hi, pos_lo),
    emission mask from the lexicographic laggard."""
    L, M = reduce_ratio(600_011, 600_013)
    assert fe.FirConfig(
        channels=2, taps=32, ratio_num=L, ratio_den=M
    ).wide
    _device_vs_cpu(
        600_011, 600_013, 32,
        phases=[0, M // 2, M - 7],
        feed_valid=[512, 512, 0, 512, 512, 256, 512, 512],
    )


def test_async_fleet_device_vs_cpu_max_out():
    """max_out-bounded schedule (the serving configuration the bench
    uses): production defers under the static lane cap."""
    _device_vs_cpu(
        44100, 44101, 64,
        phases=[0, 5, 44100 // 2],
        feed_valid=[512] * 10,
        max_out=512 + 64,
    )


def test_async_fleet_device_vs_cpu_fleet_width():
    """A 128-lane fleet (B=64 stereo) at independent seeded phases,
    ragged feeds incl. a starved step, across ring compactions."""
    rng = np.random.default_rng(13)
    M = reduce_ratio(44100, 44101)[1]
    _device_vs_cpu(
        44100, 44101, 64,
        phases=[int(p) for p in rng.integers(0, M, size=64)],
        feed_valid=[512, 0, 300, 512, 17, 512, 512, 400],
    )


def test_async_wrapper_slew_device_vs_cpu():
    """Per-stream slew through the batched wrapper: device and CPU agree
    after mid-run phase nudges (state edit + continued streaming)."""
    from resampler_tpu.engine.batched import BatchedResamplerFir

    rng = np.random.default_rng(3)
    B, C, chunk = 3, 2, 512
    chunks = [
        rng.standard_normal((B, chunk, C)).astype(np.float32)
        for _ in range(6)
    ]

    def run():
        eng = BatchedResamplerFir(
            B, C, 44100, 44101, synchronized=True,
            sync_variant="async_tm", max_chunk=chunk,
            initial_positions=[0, 100, 200],
        )
        outs = []
        for k, ch in enumerate(chunks):
            if k == 3:
                eng.slew(np.asarray([0.25, -0.1, 0.0]))
            out, consumed, produced, _ = eng.resample(ch)
            outs.append(np.asarray(out)[:, : int(np.min(produced))])
        return outs

    dev = run()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = run()
    for d, c in zip(dev, cpu):
        assert d.shape == c.shape
        np.testing.assert_allclose(d, c, atol=5e-5)
