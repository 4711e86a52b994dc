"""Bring-up check: the resampler's main paths on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py          # one GPU: phases 1-6 below
    python chip_smoke.py --four   # four GPUs: the meshed fleets only

Every phase runs the public entry points at the sizes users run and
compares with a plain reference on the CPU device or in float64 numpy;
no comparison relies on a default matmul precision.

1. Single-stream API (``ResamplerFir``/``ResamplerFft.process``): FIR
   alias rejection >= 100 dB, FFT stopband >= 99 dB.
2. Synchronized time-major FIR fleets at bench width (1024 stereo
   streams, 4096-frame chunks) at 44100->48000, the coprime Farrow pair
   44100->44101 and the wide pair 600011->600013: 8 streams against the
   per-stream engine, max abs error < 5e-5.
3. FFT fleet at bench width (8192 stereo streams) at the four reference
   pairs against the float64 projector on the host: floor >= 99 dB.
4. Async FIR fleet (256 stereo streams, 44100->44101, seeded phases):
   8 streams against the per-stream engine, < 5e-5.
5. ``StreamingFleet`` (64 streams x 8 channels, 44100->48000) fed seeded
   arbitrary-size pushes: every stream against the per-stream engine,
   < 5e-5.
6. The GPU device test tier (``tests_gpu/``), in this process.

``--four`` runs the sync tm fleet (4096 streams), the async fleet (1024)
and the FFT fleet (32768) over a flat 4-device stream mesh, each against
the same fleet on one card, and the fleet peak against the per-card
maxima.

Earlier lines report the card (``nvidia-smi`` name and power limit), the
device kind, compile seconds and memory analysis of each fleet step, the
host staging path and the compile cache.  The last line is one JSON
object.  Exits non-zero, printing no JSON, when JAX finds no GPU or any
phase fails; all work runs in this one process.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
TOL = 5e-5  # device vs reference, max abs error on unit-variance audio
FIR_ALIAS_DB = 100.0
FFT_FLOOR_DB = 99.0
SEED = 20261016
FFT_PAIRS = ((44100, 48000), (48000, 96000), (22050, 48000), (48000, 44100))


def report_compile(name: str, jitted, *args):
    """Compile ``jitted`` for ``args``; print seconds and memory."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    if ma is None:
        mem = "not reported"
    else:
        mem = ", ".join(
            f"{k}={getattr(ma, k + '_in_bytes') / 2**20:.1f} MiB"
            for k in ("argument_size", "output_size", "temp_size",
                      "alias_size", "generated_code_size")
        )
    print(f"[compile] {name}: {dt:.2f} s; memory: {mem}", flush=True)
    return compiled


def _fir_fleet(n_streams, in_hz, out_hz, chunk, **kw):
    from resampler_tpu import Attenuation, BatchedResamplerFir, Latency

    return BatchedResamplerFir(
        n_streams, 2, in_hz, out_hz, Latency.Sample64, Attenuation.Db90,
        synchronized=True, max_chunk=chunk, **kw,
    )


def _per_stream(channels, in_hz, out_hz, latency=None, attenuation=None):
    from resampler_tpu import Attenuation, Latency, ResamplerFir

    return ResamplerFir(
        channels, in_hz, out_hz,
        latency or Latency.Sample64, attenuation or Attenuation.Db90,
    )


def _run_fir_fleet(name, eng, feeds):
    """Step ``eng`` over ``feeds`` [B, n, C]; returns per-step
    ``(out [B, out_cap, C], consumed, produced, peak)`` on the host."""
    report_compile(
        name, eng._step, eng.state, feeds[0], np.int32(feeds[0].shape[1])
    )
    steps = []
    for f in feeds:
        out, consumed, produced, peak = eng.resample(f)
        steps.append((
            np.asarray(out), int(np.asarray(consumed)[0]),
            int(np.asarray(produced)[0]), float(peak),
        ))
    return steps


def phase_single_stream():
    from resampler_tpu.tools.attest import single_stream_quality

    alias_db, stop_db = single_stream_quality()
    print(f"  FIR alias rejection {alias_db:.2f} dB (gate {FIR_ALIAS_DB}); "
          f"FFT stopband {stop_db:.2f} dB (gate {FFT_FLOOR_DB})")
    assert alias_db >= FIR_ALIAS_DB and stop_db >= FFT_FLOOR_DB


def phase_fir_sync(cpu, n_streams=1024, chunk=4096, n_steps=3, n_check=8,
                   pairs=((44100, 48000), (44100, 44101), (600011, 600013))):
    import jax

    for in_hz, out_hz in pairs:
        rng = np.random.default_rng([SEED, in_hz, out_hz])
        feeds = [
            rng.standard_normal((n_streams, chunk, 2), np.float32)
            for _ in range(n_steps)
        ]
        eng = _fir_fleet(n_streams, in_hz, out_hz, chunk, sync_variant="tm")
        steps = _run_fir_fleet(
            f"sync tm {in_hz}->{out_hz} B={n_streams}", eng, feeds
        )
        check = np.linspace(0, n_streams - 1, n_check).astype(int)
        err, produced = 0.0, 0
        with jax.default_device(cpu):
            ref = _per_stream(2, in_hz, out_hz)
            for b in check:
                ref.reset()
                buf = np.zeros(ref.buffer_size_output(), np.float32)
                for f, (out, c, p, _) in zip(feeds, steps):
                    rc, rp = ref.resample(f[b].reshape(-1), buf)
                    assert (rc, rp) == (2 * c, 2 * p), (b, rc, rp, c, p)
                    d = np.abs(buf[:rp] - out[b, :p].reshape(-1))
                    err = max(err, float(d.max(initial=0.0)))
                    produced += p
        print(f"  sync tm {in_hz}->{out_hz}: {n_check} streams, "
              f"{produced} frames checked, max abs err {err:.3e}")
        assert produced > 0 and err < TOL
        del eng


def phase_fft(n_streams=8192, n_steps=3, n_check=256, pairs=FFT_PAIRS):
    from resampler_tpu import BatchedResamplerFft
    from resampler_tpu.tools.attest import fft_floor_db

    for in_hz, out_hz in pairs:
        eng = BatchedResamplerFft(n_streams, 2, in_hz, out_hz)
        n_in = eng.config.fft_size_input
        n_out = eng.config.fft_size_output
        rng = np.random.default_rng([SEED, in_hz, out_hz])
        feeds = [
            rng.standard_normal((n_streams, 2, n_in), np.float32)
            for _ in range(n_steps)
        ]
        report_compile(
            f"fft {in_hz}->{out_hz} B={n_streams} ({n_in}->{n_out})",
            eng._step, eng.state, feeds[0],
        )
        outs = [np.asarray(eng.resample(f)[:n_check]) for f in feeds]
        floor = fft_floor_db([f[:n_check] for f in feeds], outs, n_in, n_out)
        print(f"  fft {in_hz}->{out_hz}: floor vs f64 projector "
              f"{floor:.2f} dB over {n_check} streams x {n_steps} steps")
        assert floor >= FFT_FLOOR_DB
        del eng


def phase_async(cpu, n_streams=256, chunk=2048, n_steps=4, n_check=8,
                in_hz=44100, out_hz=44101):
    import jax
    import jax.numpy as jnp

    from resampler_tpu.types import reduce_ratio

    M = reduce_ratio(in_hz, out_hz)[1]
    rng = np.random.default_rng([SEED, 4])
    phases = rng.integers(0, M, size=n_streams)
    feeds = [
        rng.standard_normal((n_streams, chunk, 2), np.float32)
        for _ in range(n_steps)
    ]
    eng = _fir_fleet(
        n_streams, in_hz, out_hz, chunk, sync_variant="async_tm",
        initial_positions=phases,
    )
    steps = _run_fir_fleet(
        f"async tm {in_hz}->{out_hz} B={n_streams}", eng, feeds
    )
    check = np.linspace(0, n_streams - 1, n_check).astype(int)
    err, produced = 0.0, 0
    with jax.default_device(cpu):
        ref = _per_stream(2, in_hz, out_hz)
        for b in check:
            ref.reset()
            ref.state = dict(ref.state, pos_num=jnp.int32(phases[b]))
            buf = np.zeros(ref.buffer_size_output(), np.float32)
            want = []
            for f in feeds:
                _, rp = ref.resample(f[b].reshape(-1), buf)
                want.append(buf[:rp].copy())
            want = np.concatenate(want)
            got = np.concatenate([out[b, :p].reshape(-1)
                                  for out, _, p, _ in steps])
            # the fleet emits the fleet-min count per step, so its
            # sequence is a prefix of the per-stream engine's
            assert 0 < got.size <= want.size, (b, got.size, want.size)
            err = max(err, float(np.abs(got - want[: got.size]).max()))
            produced += got.size // 2
    print(f"  async tm {in_hz}->{out_hz}: {n_check} streams, {produced} "
          f"frames checked, max abs err {err:.3e}")
    assert err < TOL


def phase_streaming(cpu, n_streams=64, channels=8, rounds=4,
                    in_hz=44100, out_hz=48000):
    import jax

    from resampler_tpu import Attenuation, Latency
    from resampler_tpu.runtime import StreamingFleet

    quality = (Latency.Sample64, Attenuation.Db120)  # the fleet's defaults
    fleet = StreamingFleet(n_streams, channels, in_hz, out_hz, *quality)
    staging = "native" if fleet.pool._pool is not None else "numpy"
    print(f"  StreamingFleet host staging: {staging}")
    eng = fleet.engine
    C, n = channels, fleet.chunk_frames
    report_compile(
        f"StreamingFleet step B={n_streams} C={C}", eng._step, eng.state,
        np.zeros((n_streams, n, C), np.float32),
        np.zeros(n_streams, np.int32),
        np.full(n_streams, eng.config.out_capacity, np.int32),
    )
    rng = np.random.default_rng([SEED, 5])
    inputs = [[] for _ in range(n_streams)]
    got = [[] for _ in range(n_streams)]
    for _ in range(rounds):
        for s in range(n_streams):
            x = (0.5 * rng.standard_normal(
                int(rng.integers(1, 3000)) * C)).astype(np.float32)
            assert fleet.push(s, x) == x.size
            inputs[s].append(x)
        for s, y in enumerate(fleet.step()):
            got[s].append(y)
    for s, y in enumerate(fleet.drain()):
        got[s].append(y)
    err, frames = 0.0, 0
    with jax.default_device(cpu):
        ref = _per_stream(C, in_hz, out_hz, *quality)
        for s in range(n_streams):
            ref.reset()
            want = ref.process(np.concatenate(inputs[s]))
            y = np.concatenate(got[s])
            assert y.size == want.size, (s, y.size, want.size)
            err = max(err, float(np.abs(y - want).max(initial=0.0)))
            frames += y.size // C
    print(f"  StreamingFleet {n_streams}x{C}ch: {frames} frames, "
          f"max abs err {err:.3e}")
    assert frames > 0 and err < TOL


def phase_device_tests():
    import pytest

    rc = pytest.main(
        [str(REPO / "tests_gpu"), "-q", "-p", "no:cacheprovider"]
    )
    assert rc == 0, f"tests_gpu exit code {int(rc)}"


def phase_four(devices, n_sync=4096, n_async=1024, n_fft=32768,
               chunk=4096, async_chunk=2048, n_steps=3):
    from resampler_tpu import BatchedResamplerFft
    from resampler_tpu.parallel.sharding import stream_mesh
    from resampler_tpu.tools.attest import fft_floor_db
    from resampler_tpu.types import reduce_ratio

    mesh = stream_mesh(devices)
    print(f"  mesh: {mesh.shape} over {[d.id for d in devices]}")
    rng = np.random.default_rng([SEED, 4, 4])

    def check_fir(name, make, n_streams, n):
        feeds = [
            rng.standard_normal((n_streams, n, 2), np.float32)
            for _ in range(n_steps)
        ]
        meshed, single = make(mesh), make(None)
        report_compile(f"{name} meshed", meshed._step, meshed.state,
                       feeds[0], np.int32(n))
        err, produced = 0.0, 0
        for f in feeds:
            om, cm, pm, peak = meshed.resample(f)
            o1, c1, p1, peak1 = single.resample(f)
            assert int(cm[0]) == int(c1[0]) and int(pm[0]) == int(p1[0])
            p = int(pm[0])
            per_card = [
                float(np.abs(np.asarray(s.data)).max())
                for s in om.addressable_shards
            ]
            assert len({s.device for s in om.addressable_shards}) == 4
            om, o1 = np.asarray(om)[:, :p], np.asarray(o1)[:, :p]
            err = max(err, float(np.abs(om - o1).max(initial=0.0)))
            assert float(peak) == max(per_card), (float(peak), per_card)
            assert abs(float(peak) - float(peak1)) < TOL
            produced += p
        print(f"  {name}: {produced} frames/stream over {n_steps} steps, "
              f"mesh vs one card max abs err {err:.3e}; fleet peak equals "
              f"the max of the 4 per-card maxima")
        assert produced > 0 and err < TOL

    check_fir(
        f"sync tm 44100->48000 B={n_sync}",
        lambda m: _fir_fleet(n_sync, 44100, 48000, chunk, sync_variant="tm",
                             mesh=m),
        n_sync, chunk,
    )
    M = reduce_ratio(44100, 44101)[1]
    phases = rng.integers(0, M, size=n_async)
    check_fir(
        f"async tm 44100->44101 B={n_async}",
        lambda m: _fir_fleet(n_async, 44100, 44101, async_chunk,
                             sync_variant="async_tm",
                             initial_positions=phases, mesh=m),
        n_async, async_chunk,
    )

    meshed = BatchedResamplerFft(n_fft, 2, 44100, 48000, mesh=mesh)
    single = BatchedResamplerFft(n_fft, 2, 44100, 48000)
    n_in = single.config.fft_size_input
    n_out = single.config.fft_size_output
    feeds = [
        rng.standard_normal((n_fft, 2, n_in), np.float32)
        for _ in range(n_steps)
    ]
    report_compile(f"fft 44100->48000 B={n_fft} meshed", meshed._step,
                   meshed.state, feeds[0])
    outs_m, outs_1 = [], []
    for f in feeds:
        om = meshed.resample(f)
        assert len({s.device for s in om.addressable_shards}) == 4
        outs_m.append(np.asarray(om))
        outs_1.append(np.asarray(single.resample(f)))
    # the f64 floor is the accuracy gate; the loose agreement bound only
    # catches a meshed program that lost the projector's three passes
    # (one TF32 pass differs by ~3e-3)
    err = max(float(np.abs(a - b).max()) for a, b in zip(outs_m, outs_1))
    sub = slice(0, 256)
    floor_m = fft_floor_db([f[sub] for f in feeds],
                           [o[sub] for o in outs_m], n_in, n_out)
    print(f"  fft 44100->48000 B={n_fft}: mesh vs one card max abs diff "
          f"{err:.3e}; meshed floor vs f64 projector {floor_m:.2f} dB")
    assert floor_m >= FFT_FLOOR_DB and err < 1e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU meshed fleets")
    args = ap.parse_args(argv)

    # the references run on JAX's CPU device beside the GPU (set before
    # JAX is imported, which reads it)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    from resampler_tpu.utils import native
    from resampler_tpu.utils.compile_cache import enable_compile_cache
    from resampler_tpu.utils.profiling import card_identity

    print(f"nvidia-smi: {card_identity()}", flush=True)

    cache_dir = enable_compile_cache()
    cache = {"hits": 0, "misses": 0}

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            cache["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            cache["misses"] += 1

    jax.monitoring.register_event_listener(on_event)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r}); "
              "this check does not fall back to the CPU", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    print(f"jax {jax.__version__}; device_kind: {dev.device_kind}; "
          f"{len(devices)} device(s); XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}; compile cache: {cache_dir}",
          flush=True)
    cpu = jax.devices("cpu")[0]

    if args.four:
        phases = [("four-GPU meshed fleets",
                   lambda: phase_four(devices[:4]))]
    else:
        t0 = time.perf_counter()
        built = native.build()
        print(f"native host library (make -C csrc): "
              f"{'built' if built else 'not built'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        phases = [
            ("1 single-stream API", phase_single_stream),
            ("2 FIR sync tm fleets", lambda: phase_fir_sync(cpu)),
            ("3 FFT fleets", phase_fft),
            ("4 async FIR fleet", lambda: phase_async(cpu)),
            ("5 StreamingFleet", lambda: phase_streaming(cpu)),
            ("6 GPU device tier", phase_device_tests),
        ]

    failed = []
    for name, fn in phases:
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            status = "FAILED"
        else:
            status = "ok"
        print(f"== phase {name}: {status} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"compile cache {cache_dir}: {cache['hits']} hits, "
          f"{cache['misses']} misses", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
