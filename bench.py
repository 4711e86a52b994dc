"""Throughput benchmark: batched stereo 44.1 kHz -> 48 kHz on one GPU.

Mirrors the reference criterion benches, which measure f32 *output*
throughput for stereo interleaved audio
(reference: benches/benchmark_resampler_fir.rs:23-93,
benches/benchmark_resampler_fft.rs:23-87; FIR config Latency::Sample64 +
Db90).  Reference numbers (BASELINE.md, AMD Ryzen 9 9950X3D):
FIR ~137 Msamples/s, FFT ~258 Msamples/s (midpoints of published ranges).

Throughput comes from batching independent streams; per-stream
semantics are identical to the single-stream engines (tested in tests/).
Each timed dispatch scans SCAN_LEN chunks inside one jit program so
host->device dispatch latency is amortized the way a production pipeline
would.  Fails without a GPU (no CPU fallback); prints the card's name and
power limit, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "device", "details"}.
"""

import json
import time

import numpy as np

from resampler_tpu.tools.attest import single_stream_quality

FIR_BASELINE_MSPS = 137.0  # CHANGELOG.md:77 midpoint (503-540 MiB/s)
FFT_BASELINE_MSPS = 258.0  # CHANGELOG.md:75-76 midpoint (780-1192 MiB/s)

SCAN_LEN = 40  # chunks per dispatch
# Distinct preloaded chunks rotated through the scan.  Feeding ONE chunk
# for all scan iterations lets XLA hoist the input relayout/split out of
# the loop (LICM), which would flatter the FFT rows against an
# engine-style varying feed.  Rotating NBUF
# distinct buffers via an in-scan dynamic index keeps the feed varying
# (criterion parity: benches/benchmark_resampler_fir.rs:59-93 times
# fresh input per iteration) at NBUF x chunk memory.
NBUF = 8


def _rotating_indices():
    import jax.numpy as jnp

    return jnp.arange(SCAN_LEN, dtype=jnp.int32) % NBUF


def bench_fir(
    dispatches=5, warmup=2, n_streams=1024, chunk_frames=4096,
    synchronized=True, in_hz=44100, out_hz=48000, path="auto",
):
    """Batched FIR throughput.  ``synchronized=True`` benches the
    phase-locked fleet — the TIME-MAJOR ring step (one in-place KV-cache
    append + one fat fleet-wide matmul per step, the production
    serving path; for coprime pairs beyond the periodic envelope it runs
    the Farrow positioning-matmul contraction); ``False`` benches the
    general vmapped fleet with independent per-stream state.  ``path``
    selects the convolve basis on the synchronized fleet (``"lerp"``
    benches the reference's exact table-lerp interpolation semantics
    riding the same shared positioning matmul)."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, Latency, reduce_ratio

    C = 2
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, in_hz / out_hz
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )

    if synchronized:
        step = fir_engine.make_fir_fleet_step_sync_tm(
            cfg, coeffs, n_streams, max_chunk=chunk_frames, horizon=16,
            path=path,
        )
        state = fir_engine.fir_fleet_init_sync_tm(
            cfg, n_streams, max_chunk=chunk_frames, horizon=16
        )

        def fleet(state, chunks):
            def body(st, idx):
                st, out, consumed, produced = step(
                    st, chunks[idx], jnp.int32(chunk_frames)
                )
                return st, (produced * n_streams, jnp.max(jnp.abs(out)))

            state, (produced, peaks) = jax.lax.scan(
                body, state, _rotating_indices()
            )
            return state, jnp.sum(produced), jnp.max(peaks)

    else:
        step = fir_engine.make_fir_step(cfg, coeffs)
        n_valid = jnp.full((n_streams,), chunk_frames, jnp.int32)
        budget = jnp.full((n_streams,), cfg.out_capacity, jnp.int32)
        state = jax.vmap(lambda _: fir_engine.fir_init(cfg))(
            jnp.arange(n_streams)
        )

        def fleet(state, chunks):
            def body(st, idx):
                st, out, consumed, produced = jax.vmap(
                    step, in_axes=(0, 0, 0, 0)
                )(st, chunks[idx], n_valid, budget)
                # Reduce over outputs so XLA cannot dead-code-eliminate the
                # convolution (produced alone only depends on the schedule).
                return st, (jnp.sum(produced), jnp.max(jnp.abs(out)))

            state, (produced, peaks) = jax.lax.scan(
                body, state, _rotating_indices()
            )
            return state, jnp.sum(produced), jnp.max(peaks)

    fleet = jax.jit(fleet, donate_argnums=0)

    rng = np.random.default_rng(0)
    shape = (
        (NBUF, chunk_frames, n_streams * C)  # time-major fleet feed
        if synchronized
        else (NBUF, n_streams, chunk_frames, C)
    )
    chunks = jnp.asarray(rng.standard_normal(shape), jnp.float32)

    for _ in range(warmup):
        state, produced, peak = fleet(state, chunks)
    jax.block_until_ready(peak)
    produced_parts = []  # keep on device: a sync per dispatch would
    t0 = time.perf_counter()  # serialize on the host<->device round-trip
    for _ in range(dispatches):
        state, produced, peak = fleet(state, chunks)
        produced_parts.append(produced)
    jax.block_until_ready(peak)
    dt = time.perf_counter() - t0
    produced_total = sum(int(p) for p in produced_parts)
    return produced_total * C / dt / 1e6


def bench_fir_arbitrary(
    path, dispatches=5, warmup=2, n_streams=256, chunk_frames=2048
):
    """Arbitrary-ratio paths (coprime pair 44100->44101: M = 44101 >
    MAX_PERIOD so no banded atlas exists).  ``path="farrow"`` is the
    production default (polynomial-in-phase, no windows/gathers);
    ``path="gather"`` is the table-lerp-exact fallback.  Both recorded so
    every selectable path has a number; quality gates in
    tests/test_farrow.py and tests/test_fir_engine.py."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, Latency, reduce_ratio

    C = 2
    L, M = reduce_ratio(44100, 44101)
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, 44100 / 44101
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )
    step = fir_engine.make_fir_step(cfg, coeffs, path=path)
    n_valid = jnp.full((n_streams,), chunk_frames, jnp.int32)
    budget = jnp.full((n_streams,), cfg.out_capacity, jnp.int32)
    state = jax.vmap(lambda _: fir_engine.fir_init(cfg))(jnp.arange(n_streams))

    def fleet(state, chunks):
        def body(st, idx):
            st, out, consumed, produced = jax.vmap(step)(
                st, chunks[idx], n_valid, budget
            )
            return st, (jnp.sum(produced), jnp.max(jnp.abs(out)))

        state, (produced, peaks) = jax.lax.scan(
            body, state, _rotating_indices()
        )
        return state, jnp.sum(produced), jnp.max(peaks)

    fleet = jax.jit(fleet, donate_argnums=0)
    rng = np.random.default_rng(0)
    chunks = jnp.asarray(
        rng.standard_normal((NBUF, n_streams, chunk_frames, C)), jnp.float32
    )
    for _ in range(warmup):
        state, produced, peak = fleet(state, chunks)
    jax.block_until_ready(peak)
    produced_parts = []
    import time as _t
    t0 = _t.perf_counter()
    for _ in range(dispatches):
        state, produced, peak = fleet(state, chunks)
        produced_parts.append(produced)
    jax.block_until_ready(peak)
    dt = _t.perf_counter() - t0
    return sum(int(p) for p in produced_parts) * C / dt / 1e6


def bench_fir_arbitrary_async(
    dispatches=5, warmup=2, n_streams=256, chunk_frames=2048,
    in_hz=44100, out_hz=44101,
):
    """ASYNC tm fleet at the arbitrary coprime pair: every stream keeps an
    INDEPENDENT exact-rational position on a shared time-major ring (the
    realistic multi-tenant serving case).  One
    banded-atlas basis contraction + static shift-takes serve the whole
    fleet; ``max_out`` sizes the static schedule to the steady-state
    per-chunk output instead of the capacity worst case."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, Latency, reduce_ratio

    C = 2
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, in_hz / out_hz
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )
    max_out = (chunk_frames * M) // L + 128  # steady state + slack
    step = fir_engine.make_fir_fleet_step_async_tm(
        cfg, coeffs, n_streams, max_chunk=chunk_frames, horizon=16,
        out_layout="tm", max_out=max_out,
    )
    rng = np.random.default_rng(0)
    phases = rng.integers(0, M, size=n_streams)
    state = fir_engine.fir_fleet_init_async_tm(
        cfg, n_streams, max_chunk=chunk_frames, horizon=16, pos_num=phases
    )

    def fleet(state, chunks):
        def body(st, idx):
            st, out, consumed, produced = step(
                st, chunks[idx], jnp.int32(chunk_frames)
            )
            return st, (produced * n_streams, jnp.max(jnp.abs(out)))

        state, (produced, peaks) = jax.lax.scan(
            body, state, _rotating_indices()
        )
        return state, jnp.sum(produced), jnp.max(peaks)

    fleet = jax.jit(fleet, donate_argnums=0)
    chunks = jnp.asarray(
        rng.standard_normal((NBUF, chunk_frames, n_streams * C)), jnp.float32
    )
    for _ in range(warmup):
        state, produced, peak = fleet(state, chunks)
    jax.block_until_ready(peak)
    produced_parts = []
    t0 = time.perf_counter()
    for _ in range(dispatches):
        state, produced, peak = fleet(state, chunks)
        produced_parts.append(produced)
    jax.block_until_ready(peak)
    dt = time.perf_counter() - t0
    return sum(int(p) for p in produced_parts) * C / dt / 1e6


def bench_fir_ragged_async(
    dispatches=5, warmup=2, n_streams=256, chunk_frames=2048,
    in_hz=44100, out_hz=44101, min_frac=0.5,
):
    """RAGGED divergent feeds on the async tm fleet.  Producers with
    per-stream valid counts ride the shared ring
    at the FLEET-MIN cadence: the host staging pool (StreamingFleet)
    repacks each stream's excess into its carry, so the device step sees
    one shared n_valid = min over streams — here drawn per step from the
    ragged distribution (uniform [min_frac, 1] x chunk).  Throughput is
    actual produced samples (i.e., the utilization cost of the min
    cadence is PAID in this number, not hidden).  Correctness of the
    repack + fleet-min path: tests/test_async_fleet.py ragged cases and
    test_streaming_fleet_async_mode."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, Latency, reduce_ratio

    C = 2
    L, M = reduce_ratio(in_hz, out_hz)
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, in_hz / out_hz
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )
    max_out = (chunk_frames * M) // L + 128
    step = fir_engine.make_fir_fleet_step_async_tm(
        cfg, coeffs, n_streams, max_chunk=chunk_frames, horizon=16,
        out_layout="tm", max_out=max_out,
    )
    rng = np.random.default_rng(1)
    phases = rng.integers(0, M, size=n_streams)
    state = fir_engine.fir_fleet_init_async_tm(
        cfg, n_streams, max_chunk=chunk_frames, horizon=16, pos_num=phases
    )
    # fleet-min cadence: min over per-stream uniform draws, per scan step
    draws = rng.integers(
        int(min_frac * chunk_frames), chunk_frames + 1,
        size=(SCAN_LEN, n_streams),
    )
    n_valid = jnp.asarray(draws.min(axis=1).astype(np.int32))

    def fleet(state, chunks):
        def body(st, x):
            idx, nv = x
            st, out, consumed, produced = step(st, chunks[idx], nv)
            return st, (produced * n_streams, jnp.max(jnp.abs(out)))

        state, (produced, peaks) = jax.lax.scan(
            body, state, (_rotating_indices(), n_valid)
        )
        return state, jnp.sum(produced), jnp.max(peaks)

    fleet = jax.jit(fleet, donate_argnums=0)
    chunks = jnp.asarray(
        rng.standard_normal((NBUF, chunk_frames, n_streams * C)), jnp.float32
    )
    for _ in range(warmup):
        state, produced, peak = fleet(state, chunks)
    jax.block_until_ready(peak)
    produced_parts = []
    t0 = time.perf_counter()
    for _ in range(dispatches):
        state, produced, peak = fleet(state, chunks)
        produced_parts.append(produced)
    jax.block_until_ready(peak)
    dt = time.perf_counter() - t0
    return sum(int(p) for p in produced_parts) * C / dt / 1e6


def bench_fft(
    dispatches=5, warmup=2, n_streams=8192,
    fft_size_input=1176, fft_size_output=1280,
):
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fft as fft_engine

    C = 2
    cfg = fft_engine.FftConfig(
        channels=C,
        fft_size_input=fft_size_input,
        fft_size_output=fft_size_output,
    )
    # backend="auto" = the dense projector (three TF32 passes); the
    # pair-floor attestation in main() runs the same step, so the
    # throughput claimed here is quality-gated.
    step = fft_engine.make_fft_fleet_step(cfg, n_streams)

    def fleet(state, chunks):
        def body(st, idx):
            st, out = step(st, chunks[idx])
            return st, jnp.max(jnp.abs(out))
        state, peaks = jax.lax.scan(body, state, _rotating_indices())
        return state, jnp.max(peaks)

    fleet = jax.jit(fleet, donate_argnums=0)

    state = fft_engine.fft_fleet_init(cfg, n_streams)
    rng = np.random.default_rng(0)
    chunks = jnp.asarray(
        rng.standard_normal((NBUF, n_streams, C, cfg.fft_size_input)),
        jnp.float32,
    )

    for _ in range(warmup):
        state, peak = fleet(state, chunks)
    jax.block_until_ready(peak)
    t0 = time.perf_counter()
    for _ in range(dispatches):
        state, peak = fleet(state, chunks)
    jax.block_until_ready(peak)
    dt = time.perf_counter() - t0
    samples = dispatches * SCAN_LEN * n_streams * C * cfg.fft_size_output
    return samples / dt / 1e6


def fft_bench_pair_attestation(n_in=1176, n_out=1280, B=8):
    """Noise floor of the benched pair's fleet step vs the float64
    projector on the host, measured in-run (the stopband attestation
    exercises a different plan, the 588->1280 pair)."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fft as fft_engine
    from resampler_tpu.tools.attest import fft_floor_db

    cfg = fft_engine.FftConfig(
        channels=2, fft_size_input=n_in, fft_size_output=n_out
    )
    step = jax.jit(fft_engine.make_fft_fleet_step(cfg, B), donate_argnums=0)
    state = fft_engine.fft_fleet_init(cfg, B)
    rng = np.random.default_rng(11)
    chunks, outs = [], []
    for _ in range(2):
        ch = rng.standard_normal((B, 2, n_in)).astype(np.float32)
        state, out = step(state, jnp.asarray(ch))
        chunks.append(ch)
        outs.append(np.asarray(out))
    return fft_floor_db(chunks, outs, n_in, n_out)


def farrow_device_attestation():
    """The benched arbitrary-ratio path must compute the same answers on
    the bench device as on CPU (where its stopband is gated by
    tests/test_farrow.py) — the trap class this guards against is a
    product silently lowered at reduced precision (one bf16 or TF32
    pass).  Returns the max |device - cpu| over one convolve."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, reduce_ratio

    L, M = reduce_ratio(44100, 44101)
    cfg = fir_engine.FirConfig(channels=2, taps=64, ratio_num=L, ratio_den=M)
    cutoff = fir_engine.fir_cutoff(64, Attenuation.Db90, 44100 / 44101)
    coeffs = fir_engine.fir_coefficients(64, Attenuation.Db90, cutoff)
    conv = fir_engine._convolve_farrow(cfg, coeffs)
    rng = np.random.default_rng(0)
    buf = np.zeros((2, cfg.buffer_alloc), np.float32)
    avail = 2000
    buf[:, cfg.input_capacity - avail : cfg.input_capacity] = (
        rng.standard_normal((2, avail)).astype(np.float32)
    )
    args = (
        jnp.asarray(buf), jnp.int32(cfg.input_capacity - avail),
        jnp.int32(12345), jnp.int32(cfg.out_capacity),
    )
    dev = np.asarray(jax.jit(conv)(*args))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(jax.jit(conv)(*args))
    n_valid = (avail - cfg.taps + 1) * M // L
    return float(np.abs(dev[:n_valid] - ref[:n_valid]).max())


def farrow_sync_device_attestation():
    """Device-vs-CPU check for the synchronized Farrow tm fleet (B=2; the
    128-lane fleet is covered by
    tests_gpu::test_sync_tm_fleet_device_vs_cpu).  Returns max
    |device - cpu| over produced lanes of two steps at the bench pair."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, Latency, reduce_ratio

    L, M = reduce_ratio(44100, 44101)
    B, C = 2, 2
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, 44100 / 44101
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )
    step = fir_engine.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=2048, horizon=2
    )
    rng = np.random.default_rng(3)
    feeds = [
        jnp.asarray(rng.standard_normal((2048, B * C)), jnp.float32)
        for _ in range(2)
    ]

    def run():
        st = fir_engine.fir_fleet_init_sync_tm(
            cfg, B, max_chunk=2048, horizon=2
        )
        stepped = jax.jit(step)
        outs = []
        for f in feeds:
            st, out, _, p = stepped(st, f, jnp.int32(2048))
            outs.append(np.asarray(out)[:, : int(p)])
        return outs

    dev = run()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = run()
    return max(
        float(np.abs(d - r).max()) for d, r in zip(dev, ref)
    )


def wide_sync_device_attestation():
    """Device-vs-CPU check for the WIDE (two-word uint32 schedule)
    synchronized tm fleet at the benched wide pair — uint32 wraparound
    carries and the shared emission-mask schedule are the device-specific
    risks.  Returns max |device - cpu| over produced lanes of two
    steps."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.types import Attenuation, Latency, reduce_ratio

    L, M = reduce_ratio(600011, 600013)
    B, C = 2, 2
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    assert cfg.wide
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, 600011 / 600013
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )
    step = fir_engine.make_fir_fleet_step_sync_tm(
        cfg, coeffs, B, max_chunk=2048, horizon=2
    )
    rng = np.random.default_rng(5)
    feeds = [
        jnp.asarray(rng.standard_normal((2048, B * C)), jnp.float32)
        for _ in range(2)
    ]

    def run():
        st = fir_engine.fir_fleet_init_sync_tm(
            cfg, B, max_chunk=2048, horizon=2
        )
        stepped = jax.jit(step)
        outs = []
        for f in feeds:
            st, out, _, p = stepped(st, f, jnp.int32(2048))
            outs.append(np.asarray(out)[:, : int(p)])
        return outs

    dev = run()
    with jax.default_device(jax.devices("cpu")[0]):
        ref = run()
    return max(
        float(np.abs(d - r).max()) for d, r in zip(dev, ref)
    )


def bench_latency(n_iters=60, chunk_frames=1024, n_streams_fleet=256):
    """Latency + B=1 tier at the reference's own unit of comparison: ONE
    stream fed 1024-frame chunks (criterion times each resample() call;
    reference: benches/benchmark_resampler_fir.rs:23-93).

    Reports per-call wall time (p50/p99) for the B=1 public wrapper and
    for a 256-stream synchronized fleet at the same chunk size — each
    call BLOCKING, so host dispatch is included: this is the latency a
    real-time caller sees.  Also
    returns B=1 scan-amortized throughput (the device-only rate for a
    single stream, no fleet batching)."""
    import jax
    import jax.numpy as jnp

    from resampler_tpu import (
        Attenuation, Latency, ResamplerFir,
    )
    from resampler_tpu.engine import fir as fir_engine
    from resampler_tpu.engine.batched import BatchedResamplerFir
    from resampler_tpu.types import reduce_ratio

    rng = np.random.default_rng(0)
    C = 2

    # --- B=1 per-call latency through the public wrapper ---
    r = ResamplerFir(C, 44100, 48000, Latency.Sample64, Attenuation.Db90)
    x = rng.standard_normal(chunk_frames * C).astype(np.float32)
    out = np.zeros(r.buffer_size_output(), np.float32)
    for _ in range(8):
        r.resample(x, out)
    t_b1 = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        r.resample(x, out)
        t_b1.append((time.perf_counter() - t0) * 1e3)

    # --- fleet per-call latency (256 streams, same chunk) ---
    eng = BatchedResamplerFir(
        n_streams_fleet, C, 44100, 48000,
        latency=Latency.Sample64, attenuation=Attenuation.Db90,
        synchronized=True, sync_variant="tm", max_chunk=chunk_frames,
    )
    chunks = rng.standard_normal(
        (n_streams_fleet, chunk_frames, C)
    ).astype(np.float32)
    for _ in range(4):
        o, cns, prd, pk = eng.resample(chunks)
        jax.block_until_ready(pk)
    t_fleet = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        o, cns, prd, pk = eng.resample(chunks)
        jax.block_until_ready(pk)
        t_fleet.append((time.perf_counter() - t0) * 1e3)

    # --- B=1 scan-amortized throughput (single stream, no batching) ---
    L, M = reduce_ratio(44100, 48000)
    cfg = fir_engine.FirConfig(
        channels=C, taps=Latency.Sample64.taps, ratio_num=L, ratio_den=M
    )
    cutoff = fir_engine.fir_cutoff(
        Latency.Sample64.taps, Attenuation.Db90, 44100 / 48000
    )
    coeffs = fir_engine.fir_coefficients(
        Latency.Sample64.taps, Attenuation.Db90, cutoff
    )
    step = fir_engine.make_fir_step(cfg, coeffs)
    budget = jnp.int32(cfg.out_capacity)
    dev_chunks = jnp.asarray(
        rng.standard_normal((NBUF, chunk_frames, C)), jnp.float32
    )

    def run(state, chs):
        def body(st, idx):
            st, o, cns, prd = step(
                st, chs[idx], jnp.int32(chunk_frames), budget
            )
            return st, (prd, jnp.max(jnp.abs(o)))

        st, (prod, peaks) = jax.lax.scan(body, state, _rotating_indices())
        return st, jnp.sum(prod), jnp.max(peaks)

    run = jax.jit(run, donate_argnums=0)
    state = fir_engine.fir_init(cfg)
    for _ in range(2):
        state, produced, peak = run(state, dev_chunks)
    jax.block_until_ready(peak)
    parts = []
    t0 = time.perf_counter()
    for _ in range(5):
        state, produced, peak = run(state, dev_chunks)
        parts.append(produced)
    jax.block_until_ready(peak)
    dt = time.perf_counter() - t0
    b1_msps = sum(int(p) for p in parts) * C / dt / 1e6

    pct = lambda t, q: float(np.percentile(np.asarray(t), q))
    return {
        "fir_b1_step_ms_p50": round(pct(t_b1, 50), 3),
        "fir_b1_step_ms_p99": round(pct(t_b1, 99), 3),
        "fir_fleet256_step_ms_p50": round(pct(t_fleet, 50), 3),
        "fir_fleet256_step_ms_p99": round(pct(t_fleet, 99), 3),
        "fir_b1_msamples_per_s": round(b1_msps, 1),
        "fir_b1_vs_reference": round(b1_msps / FIR_BASELINE_MSPS, 2),
        "latency_note": (
            "per blocking resample() call, 1024-frame stereo chunks "
            "(criterion's unit); includes host dispatch"
        ),
    }


def device_identity():
    """Fail unless JAX's default device is a GPU; returns the device
    record the result line carries.  The card's name and power limit
    are printed first, read before JAX opens the card."""
    import jax

    from resampler_tpu.utils.compile_cache import enable_compile_cache
    from resampler_tpu.utils.profiling import card_identity

    smi = card_identity()
    print(f"nvidia-smi: {smi}", flush=True)

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's default device is "
            f"{dev.platform!r} (no CPU fallback)"
        )
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi,
    }


def main():
    device = device_identity()
    fir_msps = bench_fir()
    # Async (multi-tenant) rows run early, in a device state comparable
    # to the headline's (in-process ordering can drift later timings).
    fir_arb_async_msps = bench_fir_arbitrary_async()
    fir_wide_async_msps = bench_fir_arbitrary_async(
        in_hz=4000000000, out_hz=4000000001
    )
    fir_ragged_msps = bench_fir_ragged_async()
    fft_msps = bench_fft()
    # The reference criterion benches measure FOUR rate pairs
    # (benches/benchmark_resampler_fft.rs:23-87, *_fir.rs:23-93):
    # 48->96, 22.05->48, 44.1->48, 48->44.1 — all stereo.  The headline
    # above is 44.1->48; the other three are recorded here so the
    # vs-reference claim covers the reference's own workload set.
    fir_pairs = {}
    fft_pairs = {}
    for in_hz, out_hz, n_in, n_out in (
        (48000, 96000, 512, 1024),
        (22050, 48000, 588, 1280),
        (48000, 44100, 1280, 1176),
    ):
        key = f"{in_hz}_{out_hz}"
        fir_pairs[key] = bench_fir(dispatches=3, in_hz=in_hz, out_hz=out_hz)
        fft_pairs[key] = bench_fft(
            dispatches=3, fft_size_input=n_in, fft_size_output=n_out
        )
    # Arbitrary-ratio production serving path: the synchronized tm fleet's
    # Farrow contraction (shared positioning matmul across the fleet).
    fir_arb_sync_msps = bench_fir(in_hz=44100, out_hz=44101)
    # Heavy coprime downsample (L/M ~ 230): stays on the farrow structure
    # (adaptive block size) instead of the old gather fallback.  Output
    # samples are intrinsically scarce at this ratio, so the input-side
    # rate is recorded alongside.
    fir_heavy_msps = bench_fir(in_hz=367500, out_hz=1601)
    # WIDE pair (beyond the int32 schedule envelope, coprime u32 rates):
    # the same synchronized tm Farrow fleet under the two-word uint32
    # schedule — reference-parity capability at fleet throughput.
    fir_wide_msps = bench_fir(in_hz=600011, out_hz=600013)
    # Exact table-lerp INTERPOLATION semantics (incl. the phase-1023
    # clamp, reference src/resampler_fir.rs:556-565) as a fleet serving
    # tier: the SVD table basis rides the SAME shared positioning matmul
    # as farrow (fir_fleets._farrow_tm_plan(basis="lerp")), so the
    # [1024, r] U-row takes are paid ONCE per step for the whole fleet
    # instead of per stream.
    fir_lerp_sync_msps = bench_fir(in_hz=44100, out_hz=44101, path="lerp")
    fir_arb_msps = bench_fir_arbitrary("farrow")
    # per-stream lerp (vmapped, independent state): the takes are paid
    # per stream — kept as the general-fleet semantics tier; use the
    # synchronized lerp fleet above for speed.  The gather path below is
    # the slow by-construction ORACLE for the same semantics and is
    # excluded from vs-reference claims
    fir_lerp_msps = bench_fir_arbitrary("lerp")
    fir_gather_msps = bench_fir_arbitrary("gather", n_streams=64)
    latency_tier = bench_latency()
    fir_alias_db, fft_stopband_db = single_stream_quality()
    farrow_dev_err = farrow_device_attestation()
    farrow_sync_dev_err = farrow_sync_device_attestation()
    wide_sync_dev_err = wide_sync_device_attestation()
    fft_pair_floor_db = fft_bench_pair_attestation()
    result = {
        "metric": "Msamples/sec/chip stereo 44.1->48k FIR (Sample64, Db90, batched streams)",
        "value": round(fir_msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(fir_msps / FIR_BASELINE_MSPS, 2),
        "device": device,
        "details": {
            "fir_msamples_per_s": round(fir_msps, 1),
            "fir_vs_reference": round(fir_msps / FIR_BASELINE_MSPS, 2),
            "fft_msamples_per_s": round(fft_msps, 1),
            "fft_vs_reference": round(fft_msps / FFT_BASELINE_MSPS, 2),
            "fir_arbitrary_sync_msamples_per_s": round(fir_arb_sync_msps, 1),
            "fir_arbitrary_sync_vs_reference": round(
                fir_arb_sync_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_wide_sync_msamples_per_s": round(fir_wide_msps, 1),
            "fir_wide_sync_vs_reference": round(
                fir_wide_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_arbitrary_async_msamples_per_s": round(fir_arb_async_msps, 1),
            "fir_arbitrary_async_vs_reference": round(
                fir_arb_async_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_wide_async_msamples_per_s": round(fir_wide_async_msps, 1),
            "fir_wide_async_vs_reference": round(
                fir_wide_async_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_arbitrary_msamples_per_s": round(fir_arb_msps, 1),
            "fir_arbitrary_vs_reference": round(
                fir_arb_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_lerp_sync_msamples_per_s": round(fir_lerp_sync_msps, 1),
            "fir_lerp_sync_vs_reference": round(
                fir_lerp_sync_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_lerp_msamples_per_s": round(fir_lerp_msps, 1),
            "fir_lerp_vs_reference": round(
                fir_lerp_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_gather_msamples_per_s": round(fir_gather_msps, 1),
            "fir_gather_note": (
                "semantics oracle (table-lerp exact by construction), "
                "not a serving path; fir_lerp_sync serves the same "
                "table-lerp semantics at fleet speed (U-row takes paid "
                "once per step, not per stream); fir_lerp is the "
                "per-stream form where the takes dominate"
            ),
            "fir_heavy_downsample_msamples_per_s": round(fir_heavy_msps, 1),
            "fir_heavy_downsample_input_msamples_per_s": round(
                fir_heavy_msps * 367500 / 1601, 1
            ),
            # At L/M ~ 230 outputs are intrinsically scarce: the reference
            # must copy ~230 input samples per output, so ITS output rate
            # at this ratio is copy-bound at ~11 Msps — input-side Gsps is
            # the honest decimator throughput measure.
            "fir_heavy_downsample_note": (
                "decimation: input-side rate is the capacity measure; "
                "reference output rate at this ratio is copy-bound ~11 Msps"
            ),
            "fir_pair_msamples_per_s": {
                k: round(v, 1) for k, v in fir_pairs.items()
            },
            "fir_pair_vs_reference": {
                k: round(v / FIR_BASELINE_MSPS, 2) for k, v in fir_pairs.items()
            },
            "fft_pair_msamples_per_s": {
                k: round(v, 1) for k, v in fft_pairs.items()
            },
            "fft_pair_vs_reference": {
                k: round(v / FFT_BASELINE_MSPS, 2) for k, v in fft_pairs.items()
            },
            "fir_ragged_async_msamples_per_s": round(fir_ragged_msps, 1),
            "fir_ragged_async_vs_reference": round(
                fir_ragged_msps / FIR_BASELINE_MSPS, 2
            ),
            "fir_ragged_note": (
                "divergent per-stream feeds at the fleet-min cadence "
                "(host repack); actual produced samples, utilization "
                "cost included"
            ),
            **latency_tier,
            "feed": "varying (NBUF=%d rotating chunks per scan)" % NBUF,
            "fir_alias_rejection_db": round(fir_alias_db, 1),
            "fft_stopband_db": round(fft_stopband_db, 1),
            "farrow_device_err": float(f"{farrow_dev_err:.2e}"),
            "farrow_sync_device_err": float(f"{farrow_sync_dev_err:.2e}"),
            "wide_sync_device_err": float(f"{wide_sync_dev_err:.2e}"),
            "fft_bench_pair_floor_db": round(fft_pair_floor_db, 1),
            "quality_ok": bool(
                fir_alias_db >= 100.0
                and fft_stopband_db >= 99.0
                and farrow_dev_err < 5e-5
                and farrow_sync_dev_err < 5e-5
                and wide_sync_dev_err < 5e-5
                and fft_pair_floor_db >= 99.0
            ),
            "reference": "hasenbanck/resampler on AMD Ryzen 9 9950X3D (BASELINE.md)",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
