"""Batched multi-stream engines + mesh sharding tests (runs on the
8-device virtual CPU mesh from conftest)."""

import numpy as np
import pytest

import jax

from resampler_tpu import (
    Attenuation,
    BatchedResamplerFft,
    BatchedResamplerFir,
    Latency,
    ResamplerFir,
    ResamplerFft,
    SampleRate,
)
from resampler_tpu.parallel.sharding import stream_mesh


def test_batched_fir_matches_single_stream():
    """Each stream of the batch behaves exactly like a standalone
    ResamplerFir fed the same chunks."""
    B, C = 4, 2
    rng = np.random.default_rng(1)
    chunks = rng.standard_normal((B, 512, C)).astype(np.float32)

    fleet = BatchedResamplerFir(
        B, C, 44100, 48000, Latency.Sample32, Attenuation.Db90
    )
    out, consumed, produced, peak = fleet.resample(chunks)
    out = np.asarray(out)

    for b in range(B):
        single = ResamplerFir(
            C, 44100, 48000, Latency.Sample32, Attenuation.Db90
        )
        buf = np.zeros(single.buffer_size_output(), np.float32)
        c, p = single.resample(chunks[b].reshape(-1), buf)
        assert c == int(consumed[b]) * C
        assert p == int(produced[b]) * C
        # vmapped and single-stream programs compile separately; the conv
        # accumulation order may differ by ~1 ulp
        np.testing.assert_allclose(
            buf[:p], out[b, : int(produced[b])].reshape(-1), atol=2e-6
        )
    assert float(peak) == pytest.approx(float(np.abs(out).max()))


def test_batched_fir_sharded_over_mesh():
    """Batch axis sharded over the 8-device mesh produces identical
    results to the unsharded fleet."""
    B, C = 8, 2
    rng = np.random.default_rng(2)
    chunks = rng.standard_normal((B, 256, C)).astype(np.float32)

    plain = BatchedResamplerFir(B, C, 48000, 44100)
    sharded = BatchedResamplerFir(B, C, 48000, 44100, mesh=stream_mesh())

    out_a = np.asarray(plain.resample(chunks)[0])
    out_b = np.asarray(sharded.resample(chunks)[0])
    # sharded compilation may fuse/reduce in a different order: ~1 ulp
    np.testing.assert_allclose(out_a, out_b, atol=1e-5)

    # state really is distributed across 8 devices
    buf = sharded.state["buffer"]
    assert len(buf.sharding.device_set) == 8


def test_batched_fft_matches_single_stream():
    B, C = 3, 2
    rng = np.random.default_rng(3)
    fleet = BatchedResamplerFft(B, C, SampleRate.Hz44100, SampleRate.Hz48000)
    n_in = fleet.config.fft_size_input
    chunks = rng.standard_normal((B, C, n_in)).astype(np.float32)

    out = np.asarray(fleet.resample(chunks))
    for b in range(B):
        single = ResamplerFft(C, SampleRate.Hz44100, SampleRate.Hz48000)
        x = chunks[b].T.reshape(-1)  # interleave
        y = np.zeros(single.chunk_size_output(), np.float32)
        single.resample(x, y)
        np.testing.assert_array_equal(y, out[b].T.reshape(-1))


def test_batched_fft_sharded_over_mesh():
    B, C = 8, 1
    rng = np.random.default_rng(4)
    plain = BatchedResamplerFft(B, C, SampleRate.Hz48000, SampleRate.Hz96000)
    sharded = BatchedResamplerFft(
        B, C, SampleRate.Hz48000, SampleRate.Hz96000, mesh=stream_mesh()
    )
    n_in = plain.config.fft_size_input
    chunks = rng.standard_normal((B, C, n_in)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(plain.resample(chunks)),
        np.asarray(sharded.resample(chunks)),
        atol=1e-5,
    )


def test_batched_fft_state_setter_converts_backends():
    """A fleet checkpoint saved under the conv {'prev'} carry
    schema restores into a matmul-backend fleet: the setter must apply
    convert_fft_state (broadcasting over the [B] leading dims) exactly
    like the single-stream ResamplerFft does — a raw assignment would
    KeyError inside the jitted fleet step."""
    B, C = 2, 2
    rng = np.random.default_rng(9)
    a = BatchedResamplerFft(
        B, C, SampleRate.Hz22050, SampleRate.Hz48000, backend="conv"
    )
    b = BatchedResamplerFft(
        B, C, SampleRate.Hz22050, SampleRate.Hz48000, backend="matmul"
    )
    n_in = a.config.fft_size_input
    chunks = rng.standard_normal((B, C, n_in)).astype(np.float32)
    out_a = np.asarray(a.resample(chunks))

    # restore the conv-schema checkpoint into the matmul fleet mid-stream
    b.state = jax.tree.map(np.asarray, a.state)
    chunks2 = rng.standard_normal((B, C, n_in)).astype(np.float32)
    out_a2 = np.asarray(a.resample(chunks2))
    out_b2 = np.asarray(b.resample(chunks2))
    np.testing.assert_allclose(out_a2, out_b2, atol=1e-4)
    del out_a

    # the reverse direction is not invertible and must raise clearly
    with pytest.raises(ValueError, match="not\\s+invertible|overlap"):
        a.state = b.state


def test_graft_entry_points():
    """The driver-facing entry points compile and run on this mesh."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)

    mod.dryrun_multichip(8)


def test_batched_fir_sync_sharded_over_mesh():
    """The synchronized (fastest-serving) fleet shards through the public
    wrapper: mixed-rank state ([B,...] buffers + shared schedule scalars)
    is placed rank-aware by shard_batch, and results match the unsharded
    sync fleet exactly across steps."""
    B, C = 8, 2
    rng = np.random.default_rng(7)
    plain = BatchedResamplerFir(
        B, C, 44100, 48000, Latency.Sample32, Attenuation.Db90,
        synchronized=True,
    )
    sharded = BatchedResamplerFir(
        B, C, 44100, 48000, Latency.Sample32, Attenuation.Db90,
        synchronized=True, mesh=stream_mesh(),
    )

    for _ in range(3):
        chunks = rng.standard_normal((B, 256, C)).astype(np.float32)
        out_a, cons_a, prod_a, _ = plain.resample(chunks)
        out_b, cons_b, prod_b, _ = sharded.resample(chunks)
        np.testing.assert_array_equal(np.asarray(cons_a), np.asarray(cons_b))
        np.testing.assert_array_equal(np.asarray(prod_a), np.asarray(prod_b))
        np.testing.assert_allclose(
            np.asarray(out_a), np.asarray(out_b), atol=1e-5
        )

    # the tm ring buffer [ring, B*C] is distributed across its LANE axis
    # (streams), not its time axis; the shared schedule scalars replicate
    buf = sharded.state["buffer"]
    assert len(buf.sharding.device_set) == 8
    spec = buf.sharding.spec
    assert spec[-1] == "stream" and spec[0] is None, spec
    assert sharded.state["pos_num"].sharding.is_fully_replicated


def test_sync_slide_variant_still_selectable():
    """sync_variant="slide" keeps the end-aligned sync step available and
    equal to the tm default."""
    B, C = 4, 2
    rng = np.random.default_rng(8)
    tm = BatchedResamplerFir(B, C, 44100, 48000, Latency.Sample32,
                             Attenuation.Db90, synchronized=True)
    slide = BatchedResamplerFir(B, C, 44100, 48000, Latency.Sample32,
                                Attenuation.Db90, synchronized=True,
                                sync_variant="slide")
    for _ in range(3):
        chunks = rng.standard_normal((B, 320, C)).astype(np.float32)
        out_a, cons_a, prod_a, _ = tm.resample(chunks)
        out_b, cons_b, prod_b, _ = slide.resample(chunks)
        np.testing.assert_array_equal(np.asarray(cons_a), np.asarray(cons_b))
        np.testing.assert_array_equal(np.asarray(prod_a), np.asarray(prod_b))
        np.testing.assert_allclose(
            np.asarray(out_a), np.asarray(out_b), atol=2e-6
        )


def test_synchronized_fleet_matches_vmapped():
    """Phase-locked fleet (one fleet-wide matmul) equals the general
    vmapped fleet when every stream gets the same chunk sizes."""
    B, C = 4, 2
    rng = np.random.default_rng(6)
    plain = BatchedResamplerFir(B, C, 44100, 48000, Latency.Sample32,
                                Attenuation.Db90)
    sync = BatchedResamplerFir(B, C, 44100, 48000, Latency.Sample32,
                               Attenuation.Db90, synchronized=True)
    for _ in range(3):
        chunks = rng.standard_normal((B, 300, C)).astype(np.float32)
        out_a, cons_a, prod_a, _ = plain.resample(chunks)
        out_b, cons_b, prod_b, _ = sync.resample(chunks)
        np.testing.assert_array_equal(np.asarray(cons_a), np.asarray(cons_b))
        np.testing.assert_array_equal(np.asarray(prod_a), np.asarray(prod_b))
        np.testing.assert_allclose(
            np.asarray(out_a), np.asarray(out_b), atol=2e-6
        )


def test_wide_pair_synchronized_fleet_and_slew():
    """u32 pairs beyond the int32 envelope run on BOTH fleet tiers — the
    general vmapped fleet and the synchronized tm fleet — with matching
    bookkeeping/outputs, and slew operates on the wide (hi, lo) uint32
    position at both tiers."""
    B, C = 2, 1
    rng = np.random.default_rng(9)
    plain = BatchedResamplerFir(B, C, 600011, 600013, Latency.Sample32,
                                Attenuation.Db90)
    sync = BatchedResamplerFir(B, C, 600011, 600013, Latency.Sample32,
                               Attenuation.Db90, synchronized=True)
    assert plain.config.wide and sync.config.wide
    for _ in range(3):
        chunks = rng.standard_normal((B, 512, C)).astype(np.float32)
        out_a, cons_a, prod_a, _ = plain.resample(chunks)
        out_b, cons_b, prod_b, _ = sync.resample(chunks)
        np.testing.assert_array_equal(np.asarray(cons_a), np.asarray(cons_b))
        np.testing.assert_array_equal(np.asarray(prod_a), np.asarray(prod_b))
        np.testing.assert_allclose(
            np.asarray(out_a), np.asarray(out_b), atol=1e-5
        )
    # wide slew: per-stream vector on the vmapped fleet...
    applied = plain.slew(np.array([0.25, -0.25]))
    assert applied.shape == (2,)
    assert abs(applied[0] - 0.25) < 2e-6
    assert -0.2500001 <= applied[1] <= 0.0  # negative bounded by history
    # ...scalar on the synchronized fleet
    assert abs(float(sync.slew(0.5)) - 0.5) < 2e-6


def test_fleet_slew_tracks_per_stream_clock_drift():
    """Per-stream slew on the vmapped fleet: each stream's producer
    drifts by a different ppm; slewing each stream by its own drift
    restores exact pitch per stream (the serving-tier version of
    test_slew_tracks_clock_drift_end_to_end)."""
    B, C = 3, 1
    fs = 44100
    drifts = np.array([150e-6, 0.0, -120e-6])
    k = np.arange(10 * 2048)
    xs = np.stack([
        np.sin(2 * np.pi * 1000.0 * k / (fs * (1 + d))) for d in drifts
    ]).astype(np.float32)[:, :, None]  # [B, n, 1]

    fleet = BatchedResamplerFir(
        B, C, 44100, 48000, Latency.Sample64, Attenuation.Db90
    )
    ys = [[] for _ in range(B)]
    # Negative slew is bounded by the buffered history (pos_num ends each
    # step in [0, M), i.e. <1 input sample of rewind), so a steady
    # negative drift is tracked by carrying the unapplied residual into
    # the next chunk's request — the documented serving pattern.
    residual = np.zeros(B)
    for i in range(10):
        chunk = xs[:, i * 2048 : (i + 1) * 2048]
        out, cons, prod, _ = fleet.resample(chunk)
        # uniform feed + same ratio -> equal produced counts per stream
        for b in range(B):
            ys[b].append(np.asarray(out)[b, : int(prod[b]), 0])
        want = 2048 * drifts + residual
        applied = fleet.slew(want)
        residual = want - applied
        assert np.abs(residual).max() < 1.0  # deficit never accumulates far

    def tone_hz(y):
        seg = y[2000:-2000]
        zc = np.where((seg[:-1] < 0) & (seg[1:] >= 0))[0]
        return (len(zc) - 1) / ((zc[-1] - zc[0]) / 48000)

    for b in range(B):
        y = np.concatenate(ys[b])
        assert abs(tone_hz(y) - 1000.0) < 0.03, (b, tone_hz(y))

    # scalar slew on a synchronized fleet applies fleet-wide; vector raises
    sync = BatchedResamplerFir(
        2, 1, 44100, 48000, Latency.Sample32, synchronized=True
    )
    sync.resample(np.zeros((2, 256, 1), np.float32))
    assert sync.slew(0.5) == 0.5
    with pytest.raises(ValueError, match="synchronized"):
        sync.slew(np.array([0.1, 0.2]))


def test_slew_zero_is_identity_when_pos_beyond_capacity():
    """Wide/heavy-downsample states routinely carry
    pos far beyond input_capacity*M (consumption is capped at avail), so
    the old ceiling clamp `clip(delta, -pos, ceiling - pos)` went
    NEGATIVE and slew(0.0) silently applied a multi-million-sample
    backwards phase jump.  slew must never move the position opposite
    to (or beyond) the request."""
    B, C = 2, 1
    rng = np.random.default_rng(3)
    # wide heavy-downsample pair: pos accumulates far beyond capacity*M
    fleet = BatchedResamplerFir(B, C, 10_000_000, 3, Latency.Sample32,
                                Attenuation.Db90)
    assert fleet.config.wide
    for _ in range(4):
        fleet.resample(rng.standard_normal((B, 4096, C)).astype(np.float32))
    before = {k: np.asarray(v).copy() for k, v in fleet.state.items()}
    applied = fleet.slew(0.0)
    assert np.all(np.asarray(applied) == 0.0), applied
    after = fleet.state
    for k, v in before.items():
        np.testing.assert_array_equal(v, np.asarray(after[k]), err_msg=k)
    # a small positive request is applied exactly, never inverted
    applied = fleet.slew(1.0)
    assert np.all(np.abs(np.asarray(applied) - 1.0) < 2e-6), applied

    # single-engine path takes the same clamp (engine/fir.py slew)
    from resampler_tpu import ResamplerFir

    eng = ResamplerFir.new_from_hz(1, 10_000_000, 3, Latency.Sample32,
                                   Attenuation.Db90)
    out = np.zeros(eng.buffer_size_output(), np.float32)
    for _ in range(4):
        x = rng.standard_normal(4096).astype(np.float32)
        off = 0
        while off < len(x):
            c, p = eng.resample(x[off:], out)
            if c == 0 and p == 0:
                break
            off += c
    assert eng.slew(0.0) == 0.0
    assert abs(eng.slew(1.0) - 1.0) < 2e-6


def test_shard_lanes_gates_on_stream_axis_extent():
    """On a multi-axis mesh the divisibility gate must
    use the STREAM axis extent (what the NamedSharding actually splits
    over), not mesh.size — otherwise a lane count divisible by the
    stream axis but not by mesh.size is silently replicated while the
    fleet step still sizes its per-shard contraction for a shard."""
    from jax.sharding import Mesh
    from resampler_tpu.parallel.sharding import STREAM_AXIS, shard_lanes

    devs = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devs, (STREAM_AXIS, "aux"))
    x = np.zeros((16, 6), np.float32)  # 6 % 2 == 0, 6 % 8 != 0
    placed = shard_lanes({"x": x}, mesh)["x"]
    spec = placed.sharding.spec
    assert tuple(spec) == (None, STREAM_AXIS), spec


def test_batched_fft_resample_many_matches_loop():
    """The one-dispatch multi-chunk tier must be stream-equivalent to a
    loop of single resample() calls on both fleet forms: the dense
    projector (matmul, {'overlap'} carry) and the banded conv form
    ({'prev'} carry).  Also checks interop: a single-step call after
    resample_many carries the right state."""
    B, C, T = 4, 2, 5
    rng = np.random.default_rng(11)
    for backend in ("matmul", "conv"):
        a = BatchedResamplerFft(
            B, C, SampleRate.Hz44100, SampleRate.Hz48000, backend=backend
        )
        b = BatchedResamplerFft(
            B, C, SampleRate.Hz44100, SampleRate.Hz48000, backend=backend
        )
        n_in = a.config.fft_size_input
        chunks = rng.standard_normal((T, B, C, n_in)).astype(np.float32)

        out_many = np.asarray(a.resample_many(chunks))
        out_loop = np.stack(
            [np.asarray(b.resample(chunks[t])) for t in range(T)]
        )
        np.testing.assert_array_equal(out_many, out_loop)

        # interop: the carried state after the batch is chunk T-1
        tail = rng.standard_normal((B, C, n_in)).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(a.resample(tail)), np.asarray(b.resample(tail))
        )


def test_batched_fft_resample_many_sharded_over_mesh():
    B, C, T = 8, 1, 3
    rng = np.random.default_rng(12)
    plain = BatchedResamplerFft(B, C, SampleRate.Hz48000, SampleRate.Hz96000)
    sharded = BatchedResamplerFft(
        B, C, SampleRate.Hz48000, SampleRate.Hz96000, mesh=stream_mesh()
    )
    n_in = plain.config.fft_size_input
    chunks = rng.standard_normal((T, B, C, n_in)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(plain.resample_many(chunks)),
        np.asarray(sharded.resample_many(chunks)),
        atol=1e-5,
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(synchronized=True, sync_variant="tm"),
        dict(synchronized=True, sync_variant="async_tm",
             initial_positions=[0, 7, 100, 159]),
        dict(synchronized=False),
    ],
    ids=["sync_tm", "async_tm", "vmapped"],
)
def test_batched_fir_resample_many_matches_loop(kwargs):
    """resample_many (one scanned dispatch over T chunks) is bit-exact
    vs T calls of resample — the FIR multi-chunk product surface
    (reference analog: the CLI batch loop,
    resample/src/main.rs:226-254)."""
    from resampler_tpu.engine.batched import BatchedResamplerFir

    B, C, n, T = 4, 2, 256, 5
    rng = np.random.default_rng(3)
    chunks = rng.standard_normal((T, B, n, C)).astype(np.float32)
    nv = np.asarray([256, 0, 130, 256, 17], np.int32)

    mk = lambda: BatchedResamplerFir(
        B, C, 44100, 48000, max_chunk=n, **kwargs
    )
    loop = mk()
    outs, cs, ps = [], [], []
    for t in range(T):
        if kwargs.get("synchronized"):
            o, c, p, _ = loop.resample(chunks[t], np.full((B,), nv[t]))
        else:
            o, c, p, _ = loop.resample(chunks[t], np.full((B,), nv[t]))
        outs.append(np.asarray(o)); cs.append(np.asarray(c)); ps.append(np.asarray(p))

    many = mk()
    o4, c4, p4, peak = many.resample_many(chunks, nv)
    o4, c4, p4 = np.asarray(o4), np.asarray(c4), np.asarray(p4)
    for t in range(T):
        if c4.ndim == 1:
            assert int(c4[t]) == int(cs[t][0]) and int(p4[t]) == int(ps[t][0])
            p_t = int(p4[t])
        else:
            np.testing.assert_array_equal(c4[t], cs[t])
            np.testing.assert_array_equal(p4[t], ps[t])
            p_t = int(p4[t].max())
        np.testing.assert_array_equal(o4[t][:, :p_t], outs[t][:, :p_t])


def test_batched_fir_resample_many_sharded_over_mesh():
    """FIR resample_many under an 8-device mesh matches the unmeshed
    engine (chunks placed on the stream axis, state stream-sharded)."""
    from resampler_tpu.engine.batched import BatchedResamplerFir

    B, C, n, T = 8, 2, 256, 4
    rng = np.random.default_rng(15)
    chunks = rng.standard_normal((T, B, n, C)).astype(np.float32)
    nv = np.asarray([256, 0, 130, 256], np.int32)

    plain = BatchedResamplerFir(
        B, C, 44100, 48000, synchronized=True, sync_variant="tm",
        max_chunk=n,
    )
    sharded = BatchedResamplerFir(
        B, C, 44100, 48000, synchronized=True, sync_variant="tm",
        max_chunk=n, mesh=stream_mesh(),
    )
    oa, ca, pa, _ = plain.resample_many(chunks, nv)
    ob, cb, pb, _ = sharded.resample_many(chunks, nv)
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    np.testing.assert_allclose(np.asarray(oa), np.asarray(ob), atol=1e-5)


def test_batched_fir_lerp_sync_tm_via_wrapper():
    """``BatchedResamplerFir(sync_variant="tm", path="lerp")`` plumbs the
    lerp basis into the tm fleet step: matches the per-stream lerp
    engine (exact table-lerp semantics at fleet speed) and differs from
    the farrow fleet beyond ~1e-4 (i.e. the kwarg is not dropped)."""
    B, C = 3, 2
    rng = np.random.default_rng(21)
    chunks = rng.standard_normal((B, 512, C)).astype(np.float32)

    lerp_fleet = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="tm", max_chunk=512, path="lerp",
    )
    out_l, _, produced, _ = lerp_fleet.resample(chunks)
    farrow_fleet = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="tm", max_chunk=512,
    )
    out_f, _, produced_f, _ = farrow_fleet.resample(chunks)
    p = int(np.asarray(produced)[0])
    assert p and p == int(np.asarray(produced_f)[0])

    for b in range(B):
        single = ResamplerFir(
            C, 44100, 44101, Latency.Sample32, Attenuation.Db90, path="lerp"
        )
        buf = np.zeros(single.buffer_size_output(), np.float32)
        c, pp = single.resample(chunks[b].reshape(-1), buf)
        assert pp == p * C
        np.testing.assert_allclose(
            buf[:pp], np.asarray(out_l)[b, :p].reshape(-1), atol=1e-5
        )
    # farrow evaluates the continuous kernel, lerp the 1024-phase table:
    # the two fleets must NOT be identical (kwarg actually honored)
    assert np.abs(np.asarray(out_l)[:, :p] - np.asarray(out_f)[:, :p]).max() > 1e-6


def test_batched_fir_path_rejected_on_unsupported_variants():
    """path= on a fleet variant that picks its own convolve structure
    must raise instead of silently serving different semantics."""
    for variant in ("async_tm", "slide"):
        with pytest.raises(ValueError, match="path="):
            BatchedResamplerFir(
                4, 2, 44100, 44101, synchronized=True, sync_variant=variant,
                max_chunk=512, path="lerp",
            )


def test_new_from_hz_forwards_path_and_schedule():
    """ResamplerFir.new_from_hz must forward path=/schedule= (previously
    silently dropped)."""
    r = ResamplerFir.new_from_hz(1, 44100, 44101, path="lerp")
    assert r._path == "lerp"
    r = ResamplerFir.new_from_hz(1, 44100, 48000, schedule="reference")
    assert r._schedule == "reference"


def test_batched_fir_lerp_sync_tm_sharded_over_mesh():
    """The lerp-basis tm fleet under an 8-device mesh matches the
    unmeshed fleet (the lerped U-row takes compute from replicated
    schedule scalars + the replicated [1024, r] table, so GSPMD
    partitions the step exactly like the farrow basis)."""
    B, C = 8, 2
    rng = np.random.default_rng(23)
    plain = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="tm", max_chunk=256, path="lerp",
    )
    sharded = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="tm", max_chunk=256, path="lerp",
        mesh=stream_mesh(),
    )
    for _ in range(3):
        chunks = rng.standard_normal((B, 256, C)).astype(np.float32)
        out_a, cons_a, prod_a, _ = plain.resample(chunks)
        out_b, cons_b, prod_b, _ = sharded.resample(chunks)
        np.testing.assert_array_equal(np.asarray(cons_a), np.asarray(cons_b))
        np.testing.assert_array_equal(np.asarray(prod_a), np.asarray(prod_b))
        np.testing.assert_allclose(
            np.asarray(out_a), np.asarray(out_b), atol=1e-5
        )


@pytest.mark.parametrize("variant", ["tm", "async_tm"])
def test_meshed_fleet_state_keeps_its_placement(variant):
    """A meshed time-major fleet returns its ring state with the
    placement it was given (lanes sharded over the stream axis), and the
    compiled step aliases the donated state instead of copying it."""
    mesh = stream_mesh(jax.devices()[:4])
    eng = BatchedResamplerFir(
        8, 2, 44100, 44101, synchronized=True, sync_variant=variant,
        max_chunk=256, mesh=mesh,
    )
    chunks = np.zeros((8, 256, 2), np.float32)
    ma = eng._step.lower(eng.state, chunks, np.int32(256)).compile()
    assert ma.memory_analysis().alias_size_in_bytes > 0
    before = jax.tree.leaves(eng.state)
    eng.resample(chunks)
    for old, new in zip(before, jax.tree.leaves(eng.state)):
        assert new.sharding.is_equivalent_to(old.sharding, new.ndim), (
            old.sharding, new.sharding)
