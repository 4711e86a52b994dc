"""End-to-end serving demo: a fleet of live audio streams resampled
44.1 kHz -> 48 kHz with checkpoint/restore mid-stream.

Run:  python examples/serving_demo.py        (CPU or GPU)

Shows the four serving tiers:
1. `StreamingFleet` — ragged producers push interleaved audio into a
   thread-safe staging pool; each `step()` drains one batch through the
   vmapped device engine (arbitrary per-stream sizes).
2. The functional time-major sync step — the fast path
   for phase-locked fleets (equal frames per stream per step), embedded
   in a caller's own jit program.
3. Checkpoint/resume of explicit stream state (SURVEY.md §5 analog).
4. FFT fleet with the auto backend (the dense projector GEMM) via
   `BatchedResamplerFft`.
5. Synchronized serving of an ARBITRARY coprime ratio with per-stream
   clock-drift slewing: `StreamingFleet(synchronized=True)` drives the
   time-major ring step whose Farrow contraction has no
   periodic structure to exploit — plus `slew()` tracking a drifting
   producer clock.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from resampler_tpu import Attenuation, Latency
from resampler_tpu.engine import fir as fir_engine
from resampler_tpu.runtime import StreamingFleet
from resampler_tpu.types import reduce_ratio
from resampler_tpu.utils.checkpoint import load_state, save_state


def tier1_streaming_fleet():
    print("== tier 1: StreamingFleet (ragged producers) ==")
    B, C = 8, 2
    fleet = StreamingFleet(B, C, 44100, 48000, Latency.Sample64,
                           Attenuation.Db90, chunk_frames=1024)
    rng = np.random.default_rng(0)
    t = np.arange(20000) / 44100
    for s in range(B):
        tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * s) * t)
        x = np.stack([tone, tone * 0.5], 1).reshape(-1).astype(np.float32)
        # ragged pushes, like live producers
        off = 0
        while off < x.size:
            end = min(off + int(rng.integers(500, 4000)), x.size)
            fleet.push(s, x[off:end])
            off = end
    outs = fleet.drain()
    for s in (0, B - 1):
        y = outs[s].reshape(-1, C)
        zc = np.sum(np.diff(np.signbit(y[1000:-1000, 0])) != 0)
        f = zc / 2 / ((y.shape[0] - 2000) / 48000)
        print(f"  stream {s}: {y.shape[0]} frames out, tone {f:.1f} Hz "
              f"(expected {200 + 50 * s})")


def tier2_time_major_sync():
    print("== tier 2: time-major sync fleet (phase-locked fast path) ==")
    B, C, CHUNK = 16, 2, 1024
    L, M = reduce_ratio(44100, 48000)
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(cfg.taps, Attenuation.Db90, 44100 / 48000)
    coeffs = fir_engine.fir_coefficients(cfg.taps, Attenuation.Db90, cutoff)
    step = jax.jit(
        fir_engine.make_fir_fleet_step_sync_tm(cfg, coeffs, B, max_chunk=CHUNK)
    )
    state = fir_engine.fir_fleet_init_sync_tm(cfg, B, max_chunk=CHUNK)
    rng = np.random.default_rng(1)
    total = 0
    for _ in range(12):
        chunks_tm = jnp.asarray(
            rng.standard_normal((CHUNK, B * C)) * 0.25, jnp.float32
        )
        state, out, consumed, produced = step(state, chunks_tm, jnp.int32(CHUNK))
        total += int(produced)
    print(f"  {B} streams x 12 steps: {total} frames/stream produced "
          f"(ratio {total / (12 * CHUNK):.5f}, expected ~{48000 / 44100:.5f})")


def tier3_checkpoint(tmp="/tmp/fleet_state.npz"):
    print("== tier 3: checkpoint / resume ==")
    from resampler_tpu import ResamplerFir

    rng = np.random.default_rng(2)
    x = rng.standard_normal(2 * 12000).astype(np.float32)
    a = ResamplerFir(2, 44100, 48000)
    out = np.zeros(a.buffer_size_output(), np.float32)
    a.resample(x[: 2 * 6000], out)
    save_state(tmp, a.state)

    cont = a.process(x[2 * 6000 :])
    b = ResamplerFir(2, 44100, 48000)
    b.state = load_state(tmp)
    restored = b.process(x[2 * 6000 :])
    print(f"  resume bit-identical: {np.array_equal(cont, restored)} "
          f"({cont.size} samples)")


def tier4_fft_fleet():
    print("== tier 4: FFT fleet (auto backend: dense projector GEMM) ==")
    from resampler_tpu.engine.batched import BatchedResamplerFft

    B, C = 8, 2
    fleet = BatchedResamplerFft(B, C, 22050, 48000)
    N = fleet.config.fft_size_input
    n_chunks = 8
    t = np.arange(n_chunks * N) / 22050
    tones = np.stack(
        [
            np.stack([0.4 * np.sin(2 * np.pi * (300 + 40 * s) * t)] * C)
            for s in range(B)
        ]
    ).astype(np.float32)  # [B, C, n_chunks*N]
    outs = []
    for k in range(n_chunks):
        outs.append(np.asarray(fleet.resample(tones[:, :, k * N : (k + 1) * N])))
    y = np.concatenate(outs, axis=2)[0, 0]
    seg = y[3000:-3000]
    zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
    f = (len(zc) - 1) / ((zc[-1] - zc[0]) / 48000)
    print(f"  {B} streams x {n_chunks} chunks: stream 0 tone {f:.2f} Hz "
          f"(expected 300), peak {np.abs(y).max():.3f}")


def tier5_sync_arbitrary_ratio_with_slew():
    print("== tier 5: synchronized fleet, arbitrary ratio + drift slew ==")
    from resampler_tpu.engine.batched import BatchedResamplerFir

    B, C, n = 4, 1, 2048
    drift = 200e-6  # stream 0's producer clock runs 200 ppm fast
    fleet = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample64, Attenuation.Db90
    )
    k = np.arange(10 * n)
    xs = np.stack(
        [np.sin(2 * np.pi * 1000.0 * k / (44100 * (1 + (drift if b == 0 else 0))))
         for b in range(B)]
    ).astype(np.float32)[:, :, None]
    ys = [[] for _ in range(B)]
    residual = np.zeros(B)
    for i in range(10):
        out, cons, prod, _ = fleet.resample(xs[:, i * n : (i + 1) * n])
        for b in range(B):
            ys[b].append(np.asarray(out)[b, : int(prod[b]), 0])
        want = np.array([n * drift, 0, 0, 0]) + residual
        applied = fleet.slew(want)
        residual = want - applied

    def hz(y):
        seg = y[2000:-2000]
        zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        return (len(zc) - 1) / ((zc[-1] - zc[0]) / 44101)

    y0, y1 = np.concatenate(ys[0]), np.concatenate(ys[1])
    print(f"  coprime 44100->44101 sync fleet; stream 0 (drifting, slewed): "
          f"{hz(y0):.3f} Hz, stream 1 (clean): {hz(y1):.3f} Hz "
          f"(both expected 1000.000)")


def tier6_async_fleet_independent_phases():
    print("== tier 6: ASYNC fleet — independent per-stream phases ==")
    from resampler_tpu.engine.batched import BatchedResamplerFir

    # Multi-tenant case: streams join mid-broadcast at arbitrary offsets
    # (phases in 1/M input frames); one device step serves them all.
    B, C, n = 4, 1, 2048
    M = 44101
    phases = np.array([0, M // 4, M // 2, 3 * M // 4])
    fleet = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample64, Attenuation.Db90,
        synchronized=True, sync_variant="async_tm", max_chunk=n,
        initial_positions=phases,
    )
    k = np.arange(8 * n)
    x = np.sin(2 * np.pi * 1000.0 * k / 44100).astype(np.float32)
    xs = np.broadcast_to(x, (B, len(k))).copy()[:, :, None]
    ys = [[] for _ in range(B)]
    for i in range(8):
        out, cons, prod, _ = fleet.resample(xs[:, i * n : (i + 1) * n])
        for b in range(B):
            ys[b].append(np.asarray(out)[b, : int(prod[b]), 0])
    # per-stream drift correction works per stream on the async fleet
    applied = fleet.slew(np.array([0.5, 0.0, 0.0, 0.0]))
    y0, y2 = np.concatenate(ys[0]), np.concatenate(ys[2])
    # distinct initial phases -> time-shifted but equally clean tones
    def hz(y):
        seg = y[2000:-2000]
        zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        return (len(zc) - 1) / ((zc[-1] - zc[0]) / 44101)
    print(f"  4 tenants at offsets {phases.tolist()} (subframes): "
          f"stream 0 {hz(y0):.3f} Hz, stream 2 {hz(y2):.3f} Hz "
          f"(expected 1000.000); per-stream slew applied {applied[0]:.3f}")


if __name__ == "__main__":
    tier1_streaming_fleet()
    tier2_time_major_sync()
    tier3_checkpoint()
    tier4_fft_fleet()
    tier5_sync_arbitrary_ratio_with_slew()
    tier6_async_fleet_independent_phases()
