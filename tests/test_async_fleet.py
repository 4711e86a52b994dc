"""Asynchronous time-major fleet: independent per-stream positions on a
shared ring buffer (``make_fir_fleet_step_async_tm``).

The fleet's outputs must equal the per-stream farrow engine's output
SEQUENCE for every stream (same basis polynomial, same exact rational
schedule), across initial phase spreads, ring compactions, and
starvation.  The fleet produces the fleet-min count per step, so its
per-stream sequence is a (growing) prefix of the per-stream engine's —
compare concatenated sequences.
(reference per-stream generality: src/resampler_fir.rs:542-590)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from resampler_tpu.engine import fir as fe
from resampler_tpu.types import Attenuation, reduce_ratio


def _run_pair(in_hz, out_hz, taps, phases, n_steps=10, chunk=512,
              horizon=3, feed_valid=None, out_layout="bm", skew_periods=1,
              max_out=None):
    """Run fleet + per-stream engines on the same feed; return
    (per-stream fleet sequences, per-stream engine sequences)."""
    L, M = reduce_ratio(in_hz, out_hz)
    B, C = len(phases), 2
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, in_hz / out_hz)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    a_step = jax.jit(
        fe.make_fir_fleet_step_async_tm(
            cfg, coeffs, B, max_chunk=chunk, horizon=horizon,
            out_layout=out_layout, skew_periods=skew_periods,
            max_out=max_out,
        )
    )
    ps_step = jax.jit(fe.make_fir_step(cfg, coeffs, path="farrow"))
    a_state = fe.fir_fleet_init_async_tm(
        cfg, B, max_chunk=chunk, horizon=horizon,
        pos_num=np.asarray(phases, object), skew_periods=skew_periods,
    )
    ps_states = []
    for ph in phases:
        st = fe.fir_init(cfg)
        if cfg.wide:
            st["pos_hi"] = jnp.uint32(int(ph) // M)
            st["pos_lo"] = jnp.uint32(int(ph) % M)
        else:
            st["pos_num"] = jnp.int32(ph)
        ps_states.append(st)
    rng = np.random.default_rng(7)
    fleet_seq = [[] for _ in range(B)]
    ps_seq = [[] for _ in range(B)]
    for k in range(n_steps):
        nv = chunk if feed_valid is None else feed_valid[k]
        data = rng.standard_normal((chunk, B * C)).astype(np.float32)
        data[nv:] = 0.0
        a_state, out, c, p = a_step(a_state, jnp.asarray(data), jnp.int32(nv))
        p = int(p)
        out = np.asarray(out)
        if out_layout == "tm":
            out = np.transpose(
                out.reshape(-1, B, C), (1, 0, 2)
            )
        for b in range(B):
            if p:
                fleet_seq[b].append(out[b, :p])
            ps_chunk = data.reshape(chunk, B, C)[:, b, :]
            ps_states[b], out_ps, c_ps, p_ps = ps_step(
                ps_states[b], jnp.asarray(ps_chunk), jnp.int32(nv),
                jnp.int32(cfg.out_capacity),
            )
            if int(p_ps):
                ps_seq[b].append(np.asarray(out_ps)[: int(p_ps)])
    fleet_cat = [
        np.concatenate(s) if s else np.zeros((0, C), np.float32)
        for s in fleet_seq
    ]
    ps_cat = [
        np.concatenate(s) if s else np.zeros((0, C), np.float32)
        for s in ps_seq
    ]
    return fleet_cat, ps_cat


@pytest.mark.parametrize(
    "in_hz,out_hz,taps",
    [(44100, 44101, 64), (48000, 44101, 32), (44100, 48000, 16)],
)
def test_async_fleet_matches_per_stream_zero_phase(in_hz, out_hz, taps):
    fleet, ps = _run_pair(in_hz, out_hz, taps, phases=[0, 0, 0])
    for f, r in zip(fleet, ps):
        assert len(f) > 1000
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


@pytest.mark.parametrize(
    "in_hz,out_hz,taps,phases,skew,max_out",
    [
        # upsampling by one part in 44100: j increments 0/1 per lane
        (44100, 44101, 64, [0, 14700, 44100], 1, None),
        # coprime downsampling: wrap bits on most lanes
        (48000, 44101, 32, [0, 999, 44000], 1, None),
        # heavier upsampling with a two-period skew window
        (22050, 96000, 16, [0, 100, 300], 2, None),
        # wide (u32 two-word) pair under the serving max_out bound
        (4_000_000_000, 4_000_000_001, 64, [0, 7, 1_000_000], 1, 512 + 64),
        # wide pair near the top of the phase range
        (600_011, 600_013, 32, [0, 300_006, 600_006], 1, None),
        # periodic ratio on the async fleet, max_out-deferred
        (44100, 48000, 64, [0, 5, 159], 1, 512 + 64),
    ],
    ids=["shift", "dual", "shift_skew2", "wide_max_out", "wide",
         "periodic_max_out"],
)
def test_async_fleet_ratio_shapes_match_per_stream(
    in_hz, out_hz, taps, phases, skew, max_out
):
    """The XLA async step against the per-stream farrow engine across
    the ratio geometries the step's combine distinguishes, under a
    ragged feed with a starved step and ring compactions."""
    feed = [512, 0, 300, 512, 17, 512, 512, 400]
    fleet, ps = _run_pair(
        in_hz, out_hz, taps, phases, n_steps=len(feed), feed_valid=feed,
        horizon=2, skew_periods=skew, max_out=max_out,
    )
    for f, r in zip(fleet, ps):
        assert len(f) > 1000
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_independent_phases():
    """Streams at different initial phases produce each its OWN exact
    schedule's outputs — the property the sync fleet cannot express."""
    L, M = reduce_ratio(44100, 44101)
    phases = [0, M // 3, M - 1]
    fleet, ps = _run_pair(44100, 44101, 64, phases=phases)
    # distinct phases => distinct sequences
    assert not np.allclose(fleet[0][:200], fleet[1][:200], atol=1e-4)
    for f, r in zip(fleet, ps):
        assert len(f) > 1000
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_compaction_and_ragged_feed():
    """Small horizon forces ring compactions; ragged n_valid exercises
    catch-up including zero-feed (starved) steps."""
    feed = [512, 0, 300, 512, 17, 512, 0, 512, 512, 512, 400, 512]
    phases = [5, 999, 44100 // 2]
    fleet, ps = _run_pair(
        44100, 44101, 64, phases=phases, n_steps=len(feed),
        feed_valid=feed, horizon=2,
    )
    for f, r in zip(fleet, ps):
        assert len(f) > 1500
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_tm_out_layout():
    fleet_tm, ps = _run_pair(
        44100, 44101, 32, phases=[0, 12345], out_layout="tm"
    )
    for f, r in zip(fleet_tm, ps):
        assert len(f) > 1000
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_heavy_downsample():
    """Heavy coprime downsample keeps exact bookkeeping (outputs scarce,
    consumption capped at avail on some steps)."""
    # positions are subframes (1/M input frame); spread < M spans every
    # distinct output-grid phase — larger offsets are whole-frame time
    # shifts, not new phases
    fleet, ps = _run_pair(367500, 1601, 32, phases=[0, 533, 1600])
    for f, r in zip(fleet, ps):
        assert len(f) >= 8
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_init_validation():
    cfg = fe.FirConfig(channels=1, taps=16, ratio_num=147, ratio_den=160)
    with pytest.raises(ValueError, match="skew invariant"):
        fe.fir_fleet_init_async_tm(
            cfg, 2, max_chunk=256, pos_num=np.asarray([0, 161])
        )
    with pytest.raises(ValueError, match="shape"):
        fe.fir_fleet_init_async_tm(
            cfg, 2, max_chunk=256, pos_num=np.asarray([0, 1, 2])
        )
    with pytest.raises(ValueError, match="non-negative"):
        fe.fir_fleet_init_async_tm(
            cfg, 2, max_chunk=256, pos_num=np.asarray([-1, 0])
        )


def test_async_fleet_wide_pair_matches_per_stream():
    """WIDE (u32 two-word schedule) pairs run on the async fleet with
    per-stream positions; outputs equal the per-stream wide engine's
    sequences at distinct initial phases."""
    M = 600013  # reduced den > MAX_REDUCED_RATE -> wide
    phases = [0, M // 2, M - 7]
    fleet, ps = _run_pair(600011, 600013, 32, phases=phases)
    assert not np.allclose(fleet[0][:200], fleet[1][:200], atol=1e-4)
    for f, r in zip(fleet, ps):
        assert len(f) > 1000
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_wide_ragged_feed_and_compaction():
    feed = [512, 0, 300, 512, 17, 512, 0, 512, 512, 512, 400, 512]
    M = 600013
    phases = [5, M // 3, M - 1]
    fleet, ps = _run_pair(
        600011, 600013, 32, phases=phases, n_steps=len(feed),
        feed_valid=feed, horizon=2,
    )
    for f, r in zip(fleet, ps):
        assert len(f) > 1500
        np.testing.assert_allclose(f, r[: len(f)], atol=2e-5)


def test_async_fleet_max_out_defers():
    """``max_out`` bounds the static per-step output lanes; production
    beyond it backpressures (deferred to later steps) and the per-stream
    sequences stay exactly the per-stream engine's."""
    L, M = reduce_ratio(44100, 44101)
    B, C, taps, chunk = 2, 2, 32, 512
    cfg = fe.FirConfig(channels=C, taps=taps, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(taps, Attenuation.Db90, 44100 / 44101)
    coeffs = fe.fir_coefficients(taps, Attenuation.Db90, cutoff)
    # max_out well below the per-chunk steady state (~512) forces
    # deferral on every step
    step = jax.jit(
        fe.make_fir_fleet_step_async_tm(
            cfg, coeffs, B, max_chunk=chunk, horizon=3, max_out=200
        )
    )
    full = jax.jit(
        fe.make_fir_fleet_step_async_tm(
            cfg, coeffs, B, max_chunk=chunk, horizon=3
        )
    )
    phases = [0, 7777]
    sa = fe.fir_fleet_init_async_tm(
        cfg, B, max_chunk=chunk, horizon=3, pos_num=np.asarray(phases)
    )
    sb = fe.fir_fleet_init_async_tm(
        cfg, B, max_chunk=chunk, horizon=3, pos_num=np.asarray(phases)
    )
    rng = np.random.default_rng(3)
    seq_a = [[] for _ in range(B)]
    seq_b = [[] for _ in range(B)]
    for k in range(8):
        # starve the capped fleet after step 3 so it can drain its backlog
        nv = chunk if k < 4 else 0
        data = rng.standard_normal((chunk, B * C)).astype(np.float32)
        data[nv:] = 0.0
        sa, oa, _, pa = step(sa, jnp.asarray(data), jnp.int32(nv))
        sb, ob, _, pb = full(sb, jnp.asarray(data), jnp.int32(nv))
        assert int(pa) <= 200
        for b in range(B):
            seq_a[b].append(np.asarray(oa)[b, : int(pa)])
            seq_b[b].append(np.asarray(ob)[b, : int(pb)])
    for b in range(B):
        a = np.concatenate(seq_a[b])
        fb = np.concatenate(seq_b[b])
        assert len(a) > 1000  # backlog drained across steps
        np.testing.assert_allclose(a, fb[: len(a)], atol=2e-5)


def test_batched_wrapper_async_tm():
    """BatchedResamplerFir(sync_variant='async_tm') matches the general
    vmapped wrapper stream-for-stream at an arbitrary coprime ratio with
    distinct initial phases."""
    from resampler_tpu.engine.batched import BatchedResamplerFir
    from resampler_tpu.types import Latency

    B, C, chunk = 3, 2, 512
    phases = np.asarray([0, 11111, 44100 // 2])
    eng = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="async_tm", max_chunk=chunk,
        initial_positions=phases,
    )
    ref = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        path="farrow",
    )
    ref.state = dict(
        ref.state, pos_num=jnp.asarray(phases.astype(np.int32))
    )
    rng = np.random.default_rng(9)
    got = [[] for _ in range(B)]
    want = [[] for _ in range(B)]
    for _ in range(6):
        chunks = rng.standard_normal((B, chunk, C)).astype(np.float32)
        out, c, p, _ = eng.resample(chunks)
        out = np.asarray(out)
        for b in range(B):
            got[b].append(out[b, : int(np.asarray(p)[b])])
        out, c, p, _ = ref.resample(chunks)
        out = np.asarray(out)
        for b in range(B):
            want[b].append(out[b, : int(np.asarray(p)[b])])
    for b in range(B):
        g = np.concatenate(got[b])
        w = np.concatenate(want[b])
        assert len(g) > 1500
        np.testing.assert_allclose(g, w[: len(g)], atol=2e-5)


def test_batched_wrapper_async_slew():
    """Per-stream slew works on the async fleet (meaningless on sync);
    violating the skew invariant raises instead of corrupting."""
    from resampler_tpu.engine.batched import BatchedResamplerFir
    from resampler_tpu.types import Latency

    B, C = 2, 1
    eng = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="async_tm", max_chunk=256,
    )
    applied = eng.slew(np.asarray([0.25, -0.0]))
    assert applied.shape == (B,)
    assert abs(applied[0] - 0.25) < 1e-4 and applied[1] == 0.0
    with pytest.raises(ValueError, match="spread"):
        eng.slew(np.asarray([10.0, -10.0]))  # spread 20 frames > M/M


def test_batched_wrapper_async_wide():
    """The async wrapper serves WIDE pairs: per-stream join phases and
    per-stream slew on the two-word u32 schedule."""
    from resampler_tpu.engine.batched import BatchedResamplerFir
    from resampler_tpu.types import Latency

    B, C, chunk = 2, 2, 512
    M = 600013
    phases = np.asarray([0, M // 2], object)
    eng = BatchedResamplerFir(
        B, C, 600011, 600013, Latency.Sample32, Attenuation.Db90,
        synchronized=True, sync_variant="async_tm", max_chunk=chunk,
        initial_positions=phases,
    )
    ref = BatchedResamplerFir(
        B, C, 600011, 600013, Latency.Sample32, Attenuation.Db90,
        path="farrow",
    )
    ref.state = dict(
        ref.state,
        pos_hi=jnp.asarray([int(p) // M for p in phases], jnp.uint32),
        pos_lo=jnp.asarray([int(p) % M for p in phases], jnp.uint32),
    )
    rng = np.random.default_rng(11)
    got = [[] for _ in range(B)]
    want = [[] for _ in range(B)]
    for _ in range(5):
        chunks = rng.standard_normal((B, chunk, C)).astype(np.float32)
        out, c, p, _ = eng.resample(chunks)
        out = np.asarray(out)
        for b in range(B):
            got[b].append(out[b, : int(np.asarray(p)[b])])
        out, c, p, _ = ref.resample(chunks)
        out = np.asarray(out)
        for b in range(B):
            want[b].append(np.asarray(out)[b, : int(np.asarray(p)[b])])
    for b in range(B):
        g = np.concatenate(got[b])
        w = np.concatenate(want[b])
        assert len(g) > 1500
        np.testing.assert_allclose(g, w[: len(g)], atol=2e-5)
    # per-stream slew applies on the wide two-word state
    applied = eng.slew(np.asarray([0.25, 0.0]))
    assert abs(applied[0] - 0.25) < 1e-4 and applied[1] == 0.0


def test_streaming_fleet_async_mode():
    """StreamingFleet(synchronized='async') end-to-end: independent join
    phases through the host staging pool."""
    import resampler_tpu as rt

    B, C = 2, 2
    fleet = rt.StreamingFleet(
        B, C, 44100, 44101, rt.Latency.Sample32, rt.Attenuation.Db90,
        chunk_frames=256, synchronized="async",
        initial_positions=np.asarray([0, 9999]),
    )
    rng = np.random.default_rng(2)
    tot = [0, 0]
    for _ in range(4):
        for b in range(B):
            fleet.push(b, rng.standard_normal(256 * C).astype(np.float32))
        outs = fleet.step()
        for b in range(B):
            assert np.isfinite(outs[b]).all()
            tot[b] += len(outs[b])
    # 4*256 frames in minus taps lookahead -> ~990 out frames per stream
    assert min(tot) > 900 * C


def test_async_fleet_masked_lanes_zero():
    """Lanes beyond the produced count are exactly zero in both layouts."""
    L, M = reduce_ratio(44100, 44101)
    cfg = fe.FirConfig(channels=2, taps=32, ratio_num=L, ratio_den=M)
    cutoff = fe.fir_cutoff(32, Attenuation.Db90, 44100 / 44101)
    coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
    step = jax.jit(
        fe.make_fir_fleet_step_async_tm(cfg, coeffs, 2, max_chunk=256)
    )
    state = fe.fir_fleet_init_async_tm(cfg, 2, max_chunk=256)
    rng = np.random.default_rng(0)
    state, out, c, p = step(
        state, jnp.asarray(rng.standard_normal((256, 4)), jnp.float32),
        jnp.int32(256),
    )
    p = int(p)
    assert 0 < p < cfg.out_capacity
    assert np.all(np.asarray(out)[:, p:, :] == 0.0)


def test_async_fleet_sharded_over_mesh():
    """The async step is pure XLA, so a mesh-sharded fleet (shard_lanes
    placement: ring lanes + per-stream positions over the stream axis)
    must match the unmeshed fleet through GSPMD auto-partitioning —
    including across compactions and the wide branch."""
    from resampler_tpu.parallel.sharding import shard_lanes, stream_mesh

    mesh = stream_mesh()
    B, C, CH = 16, 2, 256
    for in_hz, out_hz in ((44100, 44101), (4000000000, 4000000001)):
        L, M = reduce_ratio(in_hz, out_hz)
        cfg = fe.FirConfig(channels=C, taps=32, ratio_num=L, ratio_den=M)
        cutoff = fe.fir_cutoff(32, Attenuation.Db90, in_hz / out_hz)
        coeffs = fe.fir_coefficients(32, Attenuation.Db90, cutoff)
        step = jax.jit(
            fe.make_fir_fleet_step_async_tm(
                cfg, coeffs, B, max_chunk=CH, horizon=8, max_out=CH + 64
            )
        )
        rng = np.random.default_rng(7)
        phases = rng.integers(0, min(M, 1 << 20), size=B)
        plain = fe.fir_fleet_init_async_tm(
            cfg, B, max_chunk=CH, horizon=8, pos_num=phases
        )
        meshed = shard_lanes(jax.tree.map(np.asarray, plain), mesh)
        assert len(meshed["buffer"].sharding.device_set) == 8
        for _ in range(30):  # enough steps to cross a compaction
            chunk = jnp.asarray(
                rng.standard_normal((CH, B * C)), jnp.float32
            )
            plain, o_p, c_p, n_p = step(plain, chunk, jnp.int32(CH))
            meshed, o_m, c_m, n_m = step(meshed, chunk, jnp.int32(CH))
            assert int(n_p) == int(n_m) and int(c_p) == int(c_m)
            np.testing.assert_allclose(
                np.asarray(o_p), np.asarray(o_m), atol=2e-5
            )
        # the state stays sharded across steps (GSPMD propagated it)
        assert len(meshed["buffer"].sharding.device_set) == 8


def test_batched_wrapper_async_mesh():
    """The async wrapper takes a mesh: outputs match the unmeshed
    wrapper and the state lands distributed."""
    from resampler_tpu.engine.batched import BatchedResamplerFir
    from resampler_tpu.parallel.sharding import stream_mesh
    from resampler_tpu.types import Latency

    B, C, chunk = 8, 2, 256
    phases = np.arange(B) * 100
    kw = dict(
        synchronized=True, sync_variant="async_tm", max_chunk=chunk,
        initial_positions=phases,
    )
    plain = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90, **kw
    )
    meshed = BatchedResamplerFir(
        B, C, 44100, 44101, Latency.Sample32, Attenuation.Db90,
        mesh=stream_mesh(), **kw
    )
    assert len(meshed.state["buffer"].sharding.device_set) == 8
    rng = np.random.default_rng(13)
    for _ in range(4):
        chunks = rng.standard_normal((B, chunk, C)).astype(np.float32)
        o_p, c_p, p_p, _ = plain.resample(chunks)
        o_m, c_m, p_m, _ = meshed.resample(chunks)
        np.testing.assert_allclose(
            np.asarray(o_p), np.asarray(o_m), atol=2e-5
        )
    # per-stream slew still works on the meshed fleet
    applied = meshed.slew(np.asarray([0.25] + [0.0] * (B - 1)))
    assert abs(applied[0] - 0.25) < 1e-4
