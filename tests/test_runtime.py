"""Fleet serving runtime integration: staging pool -> batched device step
(BASELINE.md config 5: concurrent multi-channel streams with arbitrary
input sizes)."""

import numpy as np
import pytest

from resampler_tpu import Attenuation, Latency, ResamplerFir
from resampler_tpu.runtime import StreamingFleet


def test_fleet_matches_single_streams():
    """Each fleet stream's output equals a standalone ResamplerFir fed the
    same audio, for ragged per-stream input sizes."""
    B, C = 6, 2
    rng = np.random.default_rng(0)
    fleet = StreamingFleet(
        B, C, 48000, 44100, Latency.Sample32, Attenuation.Db90,
        chunk_frames=512,
    )
    lengths = [100, 4096, 7777, 0, 1, 9000]
    inputs = [
        (rng.standard_normal(2 * n) * 0.5).astype(np.float32) for n in lengths
    ]
    for s, x in enumerate(inputs):
        accepted = fleet.push(s, x)
        assert accepted == x.size

    fleet_out = fleet.drain()

    for s, x in enumerate(inputs):
        single = ResamplerFir(C, 48000, 44100, Latency.Sample32, Attenuation.Db90)
        expected = single.process(x)
        assert fleet_out[s].size == expected.size, f"stream {s}"
        np.testing.assert_allclose(fleet_out[s], expected, atol=2e-6)


def test_fleet_incremental_pushes():
    """Interleaved push/step cycles preserve stream continuity."""
    B, C = 3, 1
    fleet = StreamingFleet(B, C, 44100, 48000, Latency.Sample16,
                           chunk_frames=256)
    t = np.arange(20000) / 44100
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)

    rng = np.random.default_rng(1)
    outs = []
    offset = 0
    while offset < x.size or fleet.pending(0):
        if offset < x.size:
            end = min(offset + int(rng.integers(1, 700)), x.size)
            fleet.push(0, x[offset:end])
            offset = end
        step_out = fleet.step()
        outs.append(step_out[0])
        if offset >= x.size and not step_out[0].size:
            break
    y = np.concatenate(outs)

    single = ResamplerFir(C, 44100, 48000, Latency.Sample16)
    expected = single.process(x)
    assert y.size == expected.size
    np.testing.assert_allclose(y, expected, atol=2e-6)
    # signal sanity: 440 Hz tone preserved
    seg = y[2000:-2000]
    zc = np.sum(np.diff(np.signbit(seg)) != 0)
    assert zc / 2 / (seg.size / 48000) == pytest.approx(440, abs=2)


def test_fleet_carry_on_device_backpressure():
    """Pushing more than the device buffer accepts in one step keeps the
    tail in carry and drains it across steps."""
    fleet = StreamingFleet(1, 1, 48000, 48000, Latency.Sample8,
                           chunk_frames=4096, queue_capacity_frames=1 << 15)
    x = np.arange(3 * 4096, dtype=np.float32)
    fleet.push(0, x)
    total_in_flight = fleet.pending(0)
    assert total_in_flight == x.size
    y = np.concatenate([o for o in (fleet.step()[0] for _ in range(6))])
    assert fleet.pending(0) == 0
    # identity-rate FIR reproduces the ramp (minus taps tail), delayed
    assert y.size >= x.size - fleet.engine.config.taps - 1


def test_checkpoint_roundtrip(tmp_path):
    """Save mid-stream, restore in a fresh resampler, continuation is
    bit-identical (SURVEY.md §5 checkpoint/resume)."""
    from resampler_tpu.utils.checkpoint import load_state, save_state

    rng = np.random.default_rng(4)
    x = rng.standard_normal(8000).astype(np.float32)
    a = ResamplerFir(1, 48000, 44100)
    out = np.zeros(a.buffer_size_output(), np.float32)
    a.resample(x[:4000], out)
    save_state(tmp_path / "state.npz", a.state)

    y_cont = a.process(x[4000:])

    b = ResamplerFir(1, 48000, 44100)
    b.state = load_state(tmp_path / "state.npz")
    y_restored = b.process(x[4000:])
    np.testing.assert_array_equal(y_cont, y_restored)


def _host_staging_calls(B, C=2, chunk=1024):
    """Python function calls made by one ``StreamingFleet.step()`` at
    fleet size ``B``, with the staging pool and the device engine
    stubbed out so only the host carry handling runs."""
    import sys

    fleet = StreamingFleet(B, C, 44100, 48000, Latency.Sample16,
                           chunk_frames=chunk)
    out_cap = fleet.engine.config.out_capacity
    rng = np.random.default_rng(B)

    class _Pool:
        def fill(self, n):
            n_valid = rng.integers(0, n + 1, size=B).astype(np.int32)
            return np.zeros((B, n, C), np.float32), n_valid

    class _Engine:
        config = fleet.engine.config

        def resample(self, batch, n_valid):
            # partial acceptance keeps a ragged carry between steps
            consumed = np.minimum(n_valid, rng.integers(0, chunk, size=B))
            produced = np.full(B, 7)
            return np.zeros((B, out_cap, C), np.float32), consumed, produced, 0.0

    fleet.pool, fleet.engine = _Pool(), _Engine()
    fleet.step()  # leaves a non-empty ragged carry
    calls = 0

    def count(frame, event, arg):
        nonlocal calls
        calls += event == "call"

    sys.setprofile(count)
    try:
        fleet.step()
    finally:
        sys.setprofile(None)
    return calls


def test_fleet_host_staging_scales_to_large_fleets():
    """B=512 staging sanity: the vectorized host carry path stays
    correct at large fleet sizes, and its per-step host work is a
    constant number of whole-batch operations — counted as Python
    function calls per ``step()``, which must not grow with the fleet
    (a per-stream python loop would add one or more calls per stream)."""
    B, C = 512, 2
    fleet = StreamingFleet(B, C, 44100, 48000, Latency.Sample16,
                           chunk_frames=1024)
    rng = np.random.default_rng(7)
    xs = [
        (rng.standard_normal(2 * int(n)) * 0.5).astype(np.float32)
        for n in rng.integers(500, 3000, size=B)
    ]
    for s, x in enumerate(xs):
        assert fleet.push(s, x) == x.size

    outs = fleet.drain()
    for s in (0, 17, 311, 511):
        single = ResamplerFir(C, 44100, 48000, Latency.Sample16)
        np.testing.assert_allclose(
            outs[s], single.process(xs[s]), atol=2e-6
        )

    small, large = _host_staging_calls(16), _host_staging_calls(B)
    assert small > 0
    assert large == small, (small, large)


def test_fleet_synchronized_matches_single_streams():
    """StreamingFleet(synchronized=True) — the serving runtime on the
    time-major ring fast path — produces the same per-stream outputs as
    standalone resamplers under uniform feeds, including a coprime
    (Farrow-path) ratio."""
    for in_hz, out_hz in [(44100, 48000), (44100, 44101)]:
        B, C = 4, 2
        rng = np.random.default_rng(11)
        fleet = StreamingFleet(
            B, C, in_hz, out_hz, Latency.Sample32, Attenuation.Db90,
            chunk_frames=512, synchronized=True,
        )
        n = 6 * 512
        inputs = [
            (rng.standard_normal(C * n) * 0.5).astype(np.float32)
            for _ in range(B)
        ]
        for s, x in enumerate(inputs):
            assert fleet.push(s, x) == x.size
        fleet_out = fleet.drain()
        for s, x in enumerate(inputs):
            single = ResamplerFir(
                C, in_hz, out_hz, Latency.Sample32, Attenuation.Db90
            )
            expected = single.process(x)
            assert fleet_out[s].size == expected.size, f"stream {s}"
            np.testing.assert_allclose(fleet_out[s], expected, atol=1e-5)


def test_fleet_synchronized_ragged_feed_carries():
    """With non-uniform pushes the synchronized fleet advances at the
    min-over-streams rate and keeps the excess in the host carry —
    nothing is lost once feeds equalize."""
    B, C = 2, 1
    fleet = StreamingFleet(
        B, C, 48000, 44100, Latency.Sample16, Attenuation.Db90,
        chunk_frames=256, synchronized=True,
    )
    rng = np.random.default_rng(3)
    xs = [
        (rng.standard_normal(4000) * 0.5).astype(np.float32) for _ in range(B)
    ]
    # stream 1 gets its audio late
    fleet.push(0, xs[0])
    fleet.push(1, xs[1][:1000])
    early = [fleet.step() for _ in range(3)]
    fleet.push(1, xs[1][1000:])
    late = fleet.drain()
    outs = [
        np.concatenate([e[s] for e in early] + [late[s]]) for s in range(B)
    ]
    for s in range(B):
        single = ResamplerFir(
            C, 48000, 44100, Latency.Sample16, Attenuation.Db90
        )
        expected = single.process(xs[s])
        assert outs[s].size == expected.size
        np.testing.assert_allclose(outs[s], expected, atol=1e-5)
