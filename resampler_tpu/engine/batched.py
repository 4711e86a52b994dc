"""Batched multi-stream resampler engines.

Throughput comes from batching many independent audio streams
(streams × channels) into one device program (SURVEY.md §2.9: the
reference's "instance parallelism by construction" becomes a vmapped batch
axis).  Both engines expose:

- a functional ``init(batch) -> state`` / ``step(state, chunks, ...)``
  pair whose leading axis is the stream batch, jit/pjit-ready;
- a stateful wrapper with numpy I/O;
- optional mesh sharding of the batch axis across devices
  (resampler_tpu/parallel/sharding.py).

Telemetry: ``step`` also returns the per-call peak magnitude across the
fleet — a cross-stream reduction XLA lowers to one all-reduce across the
mesh when sharded, demonstrating (and testing) the collective path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.sharding import shard_batch, shard_lanes, stream_mesh
from ..types import Attenuation, Latency, reduce_ratio
from . import fft as fft_engine
from . import fir as fir_engine

__all__ = ["BatchedResamplerFir", "BatchedResamplerFft"]


class BatchedResamplerFir:
    """``n_streams`` independent FIR resamplers stepped as one program.

    All streams share one configuration (rates/taps/attenuation) — the
    common fleet-serving case (e.g. 64 concurrent 8-channel streams,
    BASELINE.md config 5).  Per-stream state (buffer fill, phase) is
    independent; chunks may have per-stream valid lengths.
    """

    def __init__(
        self,
        n_streams: int,
        channels: int,
        input_rate,
        output_rate,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        mesh=None,
        path: str = "auto",
        synchronized: bool = False,
        sync_variant: str = "tm",
        max_chunk: int = 2048,
        horizon: int = 16,
        max_out: int | None = None,
        initial_positions=None,
        skew_periods: int = 1,
    ) -> None:
        L, M = reduce_ratio(int(input_rate), int(output_rate))
        self._config = fir_engine.FirConfig(
            channels=channels, taps=latency.taps, ratio_num=L, ratio_den=M
        )
        self.n_streams = n_streams
        self.synchronized = synchronized
        self.max_chunk = max_chunk
        cutoff = fir_engine.fir_cutoff(
            latency.taps, attenuation, int(input_rate) / int(output_rate)
        )
        coeffs = fir_engine.fir_coefficients(latency.taps, attenuation, cutoff)
        self._mesh = mesh
        # The tm fleet keeps streams on the LANE axis of its ring buffer;
        # everything else batches on the leading axis.
        self._tm = synchronized and sync_variant in ("tm", "async_tm")
        self._async = synchronized and sync_variant == "async_tm"
        self._skew_periods = skew_periods
        self._place = shard_lanes if self._tm else shard_batch
        if path != "auto" and synchronized and sync_variant != "tm":
            # only the tm fleet step takes a convolve-path selector; a
            # silent drop would serve farrow/atlas semantics under a
            # lerp label with no error
            raise ValueError(
                "path= requires the vmapped fleet (synchronized=False) or "
                "the synchronized tm fleet (sync_variant='tm'); the "
                f"{sync_variant!r} variant picks its own convolve structure"
            )
        if initial_positions is not None and not self._async:
            # only the async tm fleet honors per-stream start phases; a
            # silent drop would give every stream phase 0 with no error
            raise ValueError(
                "initial_positions requires the async fleet "
                "(synchronized=True, sync_variant='async_tm'); the "
                f"{'synchronized' if synchronized else 'vmapped'} variant "
                "shares one schedule or starts at phase 0 — use slew() to "
                "set per-stream phases on the vmapped engine"
            )

        if self._async:
            # ASYNC time-major fleet: shared chunk cadence (one scalar
            # n_valid per step, like the sync tm fleet) but fully
            # INDEPENDENT per-stream positions on the shared ring — the
            # multi-tenant serving case where streams join at arbitrary
            # phase and drift-slew individually (reference equivalent:
            # one resampler instance per stream,
            # reference: src/resampler_fir.rs:542-590).  One
            # banded-atlas basis contraction serves the whole fleet.
            # Under a mesh GSPMD partitions the step from the
            # shard_lanes placement: ring lanes + per-stream positions
            # sharded over streams, and the three fleet-min/max schedule
            # reductions lower to scalar all-reduces
            # (differentially tested on the 8-device CPU mesh).
            tm_step = fir_engine.make_fir_fleet_step_async_tm(
                self._config, coeffs, n_streams,
                max_chunk=max_chunk, horizon=horizon, max_out=max_out,
                skew_periods=skew_periods,
            )
            B, C = n_streams, channels

            def batched_step(state, chunks, n_valid):
                n = chunks.shape[1]
                tm = jnp.transpose(chunks, (1, 0, 2)).reshape(n, B * C)
                new_state, out, consumed, produced = tm_step(
                    state, tm, n_valid
                )
                peak = jnp.max(jnp.abs(out))
                return new_state, out, consumed, produced, peak

            self._step_fn = batched_step
            self._step = jax.jit(batched_step, donate_argnums=0)
            state = fir_engine.fir_fleet_init_async_tm(
                self._config, n_streams, max_chunk=max_chunk,
                horizon=horizon, pos_num=initial_positions,
                skew_periods=skew_periods,
            )
        elif synchronized and sync_variant == "tm":
            # Phase-locked fleet on the TIME-MAJOR ring step — the
            # headline serving path (one in-place KV-cache append + one
            # fat fleet-wide matmul per step).  Chunks arrive batch-major
            # [B, n, C] and are
            # relaid to the [n, B*C] time-major feed inside the jitted
            # step (lane index b*C + c, so a stream-sharded batch axis
            # maps to contiguous lane blocks — no cross-device traffic).
            tm_step = fir_engine.make_fir_fleet_step_sync_tm(
                self._config, coeffs, n_streams,
                max_chunk=max_chunk, horizon=horizon,
                # path="lerp" serves the reference's exact table-lerp
                # interpolation semantics at fleet speed (the SVD table
                # basis rides the shared positioning matmul).
                path=path,
            )
            B, C = n_streams, channels

            def batched_step(state, chunks, n_valid):
                n = chunks.shape[1]
                tm = jnp.transpose(chunks, (1, 0, 2)).reshape(n, B * C)
                new_state, out, consumed, produced = tm_step(
                    state, tm, n_valid
                )
                peak = jnp.max(jnp.abs(out))
                return new_state, out, consumed, produced, peak

            self._step_fn = batched_step
            self._step = jax.jit(batched_step, donate_argnums=0)
            state = fir_engine.fir_fleet_init_sync_tm(
                self._config, n_streams, max_chunk=max_chunk, horizon=horizon
            )
        elif synchronized:
            # End-aligned slide variant (kept selectable; the tm ring
            # step above is the production form).
            sync_step = fir_engine.make_fir_fleet_step_sync(
                self._config, coeffs, n_streams
            )

            def batched_step(state, chunks, n_valid):
                new_state, out, consumed, produced = sync_step(
                    state, chunks, n_valid
                )
                peak = jnp.max(jnp.abs(out))
                return new_state, out, consumed, produced, peak

            self._step_fn = batched_step
            self._step = jax.jit(batched_step, donate_argnums=0)
            state = fir_engine.fir_fleet_init_sync(self._config, n_streams)
        else:
            step = fir_engine.make_fir_step(self._config, coeffs, path=path)

            def batched_step(state, chunks, n_valid, out_budget):
                new_state, out, consumed, produced = jax.vmap(
                    step, in_axes=(0, 0, 0, 0)
                )(state, chunks, n_valid, out_budget)
                peak = jnp.max(jnp.abs(out))  # fleet telemetry (one psum)
                return new_state, out, consumed, produced, peak

            self._step_fn = batched_step
            self._step = jax.jit(batched_step, donate_argnums=0)
            state = jax.vmap(lambda _: fir_engine.fir_init(self._config))(
                jnp.arange(n_streams)
            )
        self._state = self._place(state, mesh) if mesh is not None else state
        if mesh is not None:
            # Pin the carried state to its placement: left to sharding
            # propagation, the GPU compile of the time-major steps returns
            # the ring replicated on every device (no donation, a full
            # ring per card each step).
            shardings = jax.tree.map(lambda x: x.sharding, self._state)
            unpinned = self._step_fn

            def pinned_step(state, *args):
                new_state, *rest = unpinned(state, *args)
                new_state = jax.lax.with_sharding_constraint(
                    new_state, shardings
                )
                return (new_state, *rest)

            self._step_fn = pinned_step
            self._step = jax.jit(pinned_step, donate_argnums=0)
        self._many_cache: dict = {}

    @property
    def config(self):
        return self._config

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        self._state = (
            self._place(value, self._mesh)
            if self._mesh is not None
            else value
        )

    def buffer_size_output(self) -> int:
        return self._config.out_capacity * self._config.channels

    def slew(self, samples):
        """Shift sampling phase by ``samples`` input samples (fractional
        OK) — clock-drift compensation at the serving tier, where remote
        producers actually drift.

        In the general (vmapped) fleet each stream has its own exact
        rational position, so ``samples`` may be a scalar or a
        per-stream ``[n_streams]`` vector: a serving loop can slew each
        stream a few ppm per chunk to track ITS producer's clock.  The
        synchronized fleet shares one schedule, so only a scalar
        (fleet-wide) slew is meaningful there.  Semantics per stream
        match ``ResamplerFir.slew``: resolution 1/M input samples,
        clamped to the buffered history (carry the unapplied residual
        into the next request to track steady negative drift); returns
        the applied slew in input samples (scalar or ``[n_streams]``)."""
        M = self._config.ratio_den
        wide = self._config.wide
        if self.synchronized and not self._async:
            if np.ndim(samples) != 0:
                raise ValueError(
                    "synchronized fleets share one phase; per-stream slew "
                    "needs the async tm fleet (sync_variant='async_tm') "
                    "or the general (vmapped) fleet"
                )
        else:
            samples = np.broadcast_to(
                np.asarray(samples, np.float64), (self.n_streams,)
            )
        if wide:
            # wide schedules carry position as (hi, lo) uint32 words whose
            # combined value exceeds int64 for extreme ratios — do the
            # bookkeeping in exact Python ints (host control plane)
            hi = np.atleast_1d(np.asarray(self._state["pos_hi"], np.uint32))
            lo = np.atleast_1d(np.asarray(self._state["pos_lo"], np.uint32))
            pos = np.asarray(
                [int(h) * M + int(l) for h, l in zip(hi, lo)], object
            )
            if self.synchronized and not self._async:
                pos = pos.reshape(())
        else:
            pos = np.asarray(self._state["pos_num"], np.int64)
        delta_f = np.round(np.asarray(samples, np.float64) * M)
        delta = (
            np.asarray([int(d) for d in np.atleast_1d(delta_f)], object)
            .reshape(delta_f.shape)
            if wide
            else delta_f.astype(np.int64)
        )
        if wide:
            # wide schedules have no int32 envelope; heavy-downsample
            # states also carry pos beyond capacity*M (consumption is
            # capped at avail) — only the history clamp applies, the
            # ceiling must never push the position backwards on its own
            applied = np.maximum(delta, -pos)
        else:
            ceiling = self._config.input_capacity * M
            applied = np.clip(delta, -pos, np.maximum(0, ceiling - pos))
        if self._async:
            # The async tm fleet's shared schedule covers a bounded
            # per-stream position spread (skew_periods * M, checked at
            # init); an unbounded per-stream slew could silently break
            # that invariant, so refuse instead of corrupting outputs.
            spread = int((pos + applied).max() - (pos + applied).min())
            limit = self._skew_periods * self._config.ratio_den
            if spread >= limit:
                raise ValueError(
                    f"per-stream slew would widen the fleet position "
                    f"spread to {spread} (>= skew_periods*M = {limit}); "
                    "the async tm fleet only tracks bounded drift — widen "
                    "skew_periods or use the general (vmapped) fleet for "
                    "unbounded per-stream skews"
                )
        if np.any(applied != 0):
            new_pos = pos + applied
            if wide:
                flat = np.atleast_1d(new_pos)
                nh = jnp.asarray(
                    np.asarray([n // M for n in flat], np.uint32)
                )
                nl = jnp.asarray(
                    np.asarray([n % M for n in flat], np.uint32)
                )
                if np.ndim(new_pos) == 0:
                    nh, nl = nh.reshape(()), nl.reshape(())
                state = dict(self._state, pos_hi=nh, pos_lo=nl)
            else:
                np32 = jnp.asarray(new_pos.astype(np.int32))
                if np.ndim(pos) == 0:
                    np32 = np32.reshape(())
                state = dict(self._state, pos_num=np32)
            self._state = (
                self._place(state, self._mesh)
                if self._mesh is not None
                else state
            )
        return (
            np.asarray(applied / M, np.float64) if wide else applied / M
        )

    def resample(self, chunks: np.ndarray, n_valid=None):
        """Step all streams.

        - ``chunks``: ``[n_streams, frames, channels]`` f32
        - ``n_valid``: optional ``[n_streams]`` int32 valid frame counts
          (defaults to full chunks)

        Returns ``(out [n_streams, out_cap, channels], consumed[B],
        produced[B], fleet_peak)`` with frames counted per channel.
        """
        chunks = np.asarray(chunks, np.float32)
        B, n, C = chunks.shape
        assert B == self.n_streams and C == self._config.channels
        if self._mesh is not None:
            chunks = shard_batch(chunks, self._mesh)
        if self.synchronized:
            if self._tm and n > self.max_chunk:
                raise ValueError(
                    f"chunk of {n} frames exceeds max_chunk={self.max_chunk} "
                    "(set max_chunk at construction for larger feeds)"
                )
            nv = n if n_valid is None else int(np.min(n_valid))
            self._state, out, consumed, produced, peak = self._step(
                self._state, chunks, np.int32(nv)
            )
            consumed = jnp.full((B,), consumed)
            produced = jnp.full((B,), produced)
            return out, consumed, produced, peak
        if n_valid is None:
            n_valid = np.full((B,), n, np.int32)
        budget = np.full((B,), self._config.out_capacity, np.int32)
        self._state, out, consumed, produced, peak = self._step(
            self._state, chunks, np.asarray(n_valid, np.int32), budget
        )
        return out, consumed, produced, peak

    def resample_many(self, chunks: np.ndarray, n_valid=None):
        """Step ``T`` consecutive chunks per stream in ONE device
        dispatch: ``chunks [T, B, n, C]`` -> ``(out [T, B, out_cap, C],
        consumed, produced, peak)`` — the FIR analog of
        ``BatchedResamplerFft.resample_many`` (a ``lax.scan`` over the
        fleet step, so file-length and bursty workloads pay ONE host
        dispatch per batch instead of one per 2048-frame chunk;
        reference analog: the CLI batch loop,
        resample/src/main.rs:226-254).

        ``n_valid``: optional per-chunk valid frame counts — ``[T]`` for
        synchronized fleets (shared cadence), ``[T, B]`` for the vmapped
        engine ([T] broadcasts).  Zero-valid chunks are no-ops, so a
        fixed ``T`` bucket can be padded with empty chunks to keep one
        compiled program.  ``consumed``/``produced`` come back per step:
        ``[T]`` for synchronized fleets, ``[T, B]`` for the vmapped
        engine.  The jitted program is cached per ``(T, n)``.

        Loop-equivalence (bit-exactness vs T calls of ``resample``) is
        tested in tests/test_batched.py.
        """
        chunks = np.asarray(chunks, np.float32)
        T, B, n, C = chunks.shape
        assert B == self.n_streams and C == self._config.channels
        if self.synchronized:
            if self._tm and n > self.max_chunk:
                raise ValueError(
                    f"chunk of {n} frames exceeds max_chunk="
                    f"{self.max_chunk} (set max_chunk at construction "
                    "for larger feeds)"
                )
            if n_valid is None:
                nv = np.full((T,), n, np.int32)
            else:
                nv = np.asarray(n_valid, np.int32)
                if nv.ndim == 2:
                    nv = nv.min(axis=1)
                assert nv.shape == (T,)
        else:
            if n_valid is None:
                nv = np.full((T, B), n, np.int32)
            else:
                nv = np.asarray(n_valid, np.int32)
                if nv.ndim == 1:
                    nv = np.broadcast_to(nv[:, None], (T, B)).copy()
                assert nv.shape == (T, B)
        many = self._many_cache.get((T, n))
        if many is None:
            many = self._build_many()
            self._many_cache[(T, n)] = many
        if self._mesh is not None:
            # stream axis is axis 1 of the [T, B, n, C] stack — shard it
            # to match the stream-sharded state (leading-axis placement
            # would split time and force a reshard per call)
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.sharding import STREAM_AXIS

            n_dev = self._mesh.shape[STREAM_AXIS]
            spec = P(None, STREAM_AXIS) if B % n_dev == 0 else P()
            chunks = jax.device_put(
                chunks, NamedSharding(self._mesh, spec)
            )
        self._state, out, consumed, produced, peaks = many(
            self._state, chunks, jnp.asarray(nv)
        )
        return out, consumed, produced, jnp.max(peaks)

    def _build_many(self):
        step_fn = self._step_fn
        if self.synchronized:

            def many(state, chunks4, nv):
                def body(st, x):
                    ch, v = x
                    st, out, c, p, peak = step_fn(st, ch, v)
                    return st, (out, c, p, peak)

                state, (outs, cs, ps, peaks) = jax.lax.scan(
                    body, state, (chunks4, nv)
                )
                return state, outs, cs, ps, peaks

        else:
            budget = jnp.full(
                (self.n_streams,), self._config.out_capacity, jnp.int32
            )

            def many(state, chunks4, nv):
                def body(st, x):
                    ch, v = x
                    st, out, c, p, peak = step_fn(st, ch, v, budget)
                    return st, (out, c, p, peak)

                state, (outs, cs, ps, peaks) = jax.lax.scan(
                    body, state, (chunks4, nv)
                )
                return state, outs, cs, ps, peaks

        return jax.jit(many, donate_argnums=0)


class BatchedResamplerFft:
    """``n_streams`` independent FFT resamplers stepped as one program.

    The chunk operator is linear and identical for every (stream, channel),
    so the batched step folds ``streams × channels`` into one big matmul
    against the shared spectral projection matrix.
    """

    def __init__(
        self,
        n_streams: int,
        channels: int,
        sample_rate_input,
        sample_rate_output,
        *,
        mesh=None,
        backend: str = "auto",
    ) -> None:
        from ..dsp.planner import plan_conversion
        from ..types import SampleRate

        cfg = plan_conversion(
            SampleRate(sample_rate_input), SampleRate(sample_rate_output)
        ).scale_for_throughput()
        self._config = fft_engine.FftConfig(
            channels=channels,
            fft_size_input=cfg.fft_size_input,
            fft_size_output=cfg.fft_size_output,
        )
        self.n_streams = n_streams
        self._mesh = mesh
        self._backend = backend
        # The fleet step folds streams x channels into the row dimension of
        # ONE projector matmul instead of vmapping n_streams per-stream
        # ops; under a mesh GSPMD partitions the rows.
        step = fft_engine.make_fft_fleet_step(
            self._config, n_streams, backend=backend
        )
        self._step_fn = step
        self._step = jax.jit(step, donate_argnums=0)
        self._many_cache: dict = {}
        state = fft_engine.fft_fleet_init(self._config, n_streams, backend)
        self._state = shard_batch(state, mesh) if mesh is not None else state

    @property
    def config(self):
        return self._config

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        # a fleet checkpoint written under another backend's schema (conv
        # {'prev'}) is converted like ResamplerFft does —
        # convert_fft_state broadcasts over the leading [B] dims.
        value = fft_engine.convert_fft_state(
            value, self._config, self._backend
        )
        self._state = (
            shard_batch(value, self._mesh) if self._mesh is not None else value
        )

    def chunk_size_input(self) -> int:
        return self._config.fft_size_input * self._config.channels

    def chunk_size_output(self) -> int:
        return self._config.fft_size_output * self._config.channels

    def resample(self, chunks: np.ndarray) -> np.ndarray:
        """Step all streams: ``chunks [B, C, N] -> out [B, C, M]``."""
        chunks = np.asarray(chunks, np.float32)
        B, C, N = chunks.shape
        assert B == self.n_streams and C == self._config.channels
        assert N == self._config.fft_size_input
        if self._mesh is not None:
            chunks = shard_batch(chunks, self._mesh)
        self._state, out = self._step(self._state, chunks)
        return out

    def resample_many(self, chunks: np.ndarray) -> np.ndarray:
        """Step ``T`` consecutive chunks per stream in ONE device
        dispatch: ``chunks [T, B, C, N] -> out [T, B, C, M]``.

        A ``lax.scan`` of the fleet step: one dispatch for the whole
        batch.  The jitted program is cached per ``T``; feed a fixed batch
        depth (or a small set of depths) to avoid recompiles, exactly
        like the chunk-size bucketing everywhere else.
        """
        chunks = np.asarray(chunks, np.float32)
        T, B, C, N = chunks.shape
        assert B == self.n_streams and C == self._config.channels
        assert N == self._config.fft_size_input
        many = self._many_cache.get(T)
        if many is None:
            many = self._build_many(T)
            self._many_cache[T] = many
        if self._mesh is not None:
            # the chunk stack is [T, B, C, N] with the STREAM axis second;
            # shard axis 1 to match the stream-sharded state (a leading-
            # axis shard_batch here would split the time axis and force a
            # GSPMD reshard on every call)
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.sharding import STREAM_AXIS

            n_dev = self._mesh.shape[STREAM_AXIS]
            spec = (
                P(None, STREAM_AXIS) if B % n_dev == 0 else P()
            )
            chunks = jax.device_put(
                chunks, NamedSharding(self._mesh, spec)
            )
        self._state, out = many(self._state, chunks)
        return out

    def _build_many(self, T: int):
        step = self._step_fn

        def many(state, chunks4):
            return jax.lax.scan(step, state, chunks4)

        return jax.jit(many, donate_argnums=0)
