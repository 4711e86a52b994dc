"""Stateful FIR wrapper — the reference-parity public API.

``ResamplerFir`` mirrors the reference object surface (interleaved f32
buffers, ``(consumed, produced)`` returns, ``buffer_size_output`` /
``delay`` / ``reset``; reference: src/resampler_fir.rs:168-643) on top
of the functional core in ``engine/fir.py``.  Split out of that module;
remains importable from ``engine.fir``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import (
    Attenuation,
    InvalidInputBufferSize,
    InvalidOutputBufferSize,
    Latency,
    reduce_ratio,
)
from .fir import (
    MAX_CHUNK,
    FirConfig,
    FirState,
    fir_coefficients,
    fir_cutoff,
    fir_init,
    make_fir_step,
)

__all__ = ["ResamplerFir"]


#: Padded input bucket sizes (frames).  A small fixed set keeps the number
#: of compiled step variants warm and bounded (SURVEY.md §5 long-context
#: note: bucketed padding avoids recompiles for arbitrary input sizes).
_BUCKETS = tuple(32 * (2**k) for k in range(8))  # 32 .. 4096


def _bucket_for(n_frames: int) -> int:
    n = min(n_frames, MAX_CHUNK)
    for b in _BUCKETS:
        if n <= b:
            return b
    return MAX_CHUNK


class ResamplerFir:
    """High-quality polyphase FIR audio resampler with a streaming API.

    Mirrors the reference public surface
    (reference: src/resampler_fir.rs:168-643): interleaved f32 buffers,
    arbitrary input sizes, ``resample() -> (consumed, produced)`` counted in
    total f32 values, ``buffer_size_output()``, ``delay()``, ``reset()``.

    Example::

        r = ResamplerFir(2, SampleRate.Hz48000, SampleRate.Hz44100,
                         Latency.Sample64, Attenuation.Db90)
        out = np.zeros(r.buffer_size_output(), np.float32)
        consumed, produced = r.resample(input_interleaved, out)
    """

    def __init__(
        self,
        channels: int,
        input_rate,
        output_rate,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        path: str = "auto",
        schedule: str = "exact",
    ) -> None:
        input_hz = int(input_rate)
        output_hz = int(output_rate)
        L, M = reduce_ratio(input_hz, output_hz)
        self._config = FirConfig(
            channels=channels, taps=latency.taps, ratio_num=L, ratio_den=M
        )
        self._latency = latency
        self._attenuation = attenuation
        self._input_hz = input_hz
        self._output_hz = output_hz
        ratio = input_hz / output_hz
        cutoff = fir_cutoff(latency.taps, attenuation, ratio)
        self._coeffs = fir_coefficients(latency.taps, attenuation, cutoff)
        # schedule="reference" is the opt-in BIT-PARITY mode: the
        # reference's f64 position accumulator semantics, run on the
        # host (engine/reference_schedule.py) — a verification surface
        # for users cross-checking against the reference binary, not a
        # serving path.  The default exact rational schedule has zero
        # drift and deviates from it only at exact phase boundaries
        # (<=2e-3 wobble on every M-th output; PARITY.md §2.3).
        if schedule not in ("exact", "reference"):
            raise ValueError(
                f"schedule must be 'exact' or 'reference', not {schedule!r}"
            )
        self._path = path
        self._schedule = schedule
        self._reference = None
        if schedule == "reference":
            from .reference_schedule import ReferenceScheduleFir

            self._reference = ReferenceScheduleFir(
                channels, latency.taps, self._coeffs, input_hz, output_hz,
                input_capacity=self._config.input_capacity,
            )
            self._step = None
            self._state = None
            return
        self._step_fn = make_fir_step(self._config, self._coeffs, path=path)
        self._step = jax.jit(self._step_fn, donate_argnums=0)
        self._state = fir_init(self._config)
        self._many = None  # scanned fast path for process(), built lazily

    # -- constructors -----------------------------------------------------

    @classmethod
    def new_from_hz(
        cls,
        channels: int,
        input_rate_hz: int,
        output_rate_hz: int,
        latency: Latency = Latency.Sample64,
        attenuation: Attenuation = Attenuation.Db120,
        *,
        path: str = "auto",
        schedule: str = "exact",
    ) -> "ResamplerFir":
        """Construct from arbitrary integer sample rates
        (reference: src/resampler_fir.rs:295-404)."""
        return cls(
            channels, input_rate_hz, output_rate_hz, latency, attenuation,
            path=path, schedule=schedule,
        )

    # -- introspection ----------------------------------------------------

    @property
    def channels(self) -> int:
        return self._config.channels

    @property
    def taps(self) -> int:
        return self._config.taps

    @property
    def ratio(self) -> float:
        return self._input_hz / self._output_hz

    def buffer_size_output(self) -> int:
        """Maximum output buffer size (total f32 values) one call can fill
        (reference: src/resampler_fir.rs:455-465)."""
        return self._config.out_capacity * self._config.channels

    def delay(self) -> int:
        """Algorithmic delay in input samples (= taps/2)."""
        return self._config.delay

    def reset(self) -> None:
        """Clear all stream state (reference: src/resampler_fir.rs:638-642)."""
        if self._reference is not None:
            self._reference.reset()
            return
        self._state = fir_init(self._config)

    def slew(self, samples: float) -> float:
        """Shift the stream's sampling phase by ``samples`` input samples
        (fractional OK) — the clock-drift-compensation primitive.

        The exact rational position makes this a pure state adjustment:
        ``pos_num += round(samples * M)`` with 1/M-input-sample
        resolution (``M = ratio_den``; a unity 48k->48k stream can only
        slew whole samples — construct near-unity pairs via
        ``new_from_hz`` for a fine phase grid) and no recompilation, so a
        serving loop can slew a few ppm per chunk to track a remote
        clock.  Positive slew skips ahead (drops signal time); negative
        slew re-reads buffered history and is clamped so the position
        never precedes the oldest buffered frame — consumption is eager
        (reference-parity bookkeeping), so less than one input sample of
        rewind is available per step.  Returns the slew actually
        applied, in input samples; to track a steady NEGATIVE drift,
        carry the unapplied residual into the next request
        (``want += requested - applied``), as
        tests/test_batched.py::test_fleet_slew_tracks_per_stream_clock_drift
        demonstrates.

        The reference has no equivalent (its f64 ``position`` could be
        nudged, but is not exposed; reference:
        src/resampler_fir.rs:189-196) — this is a capability the exact
        integer schedule adds for free.
        """
        if self._reference is not None:
            # f64 schedule: the position nudges directly (no 1/M grid)
            return self._reference.slew(float(samples))
        M = self._config.ratio_den
        delta = int(round(float(samples) * M))
        wide = self._config.wide
        if wide:
            pos = int(self._state["pos_hi"]) * M + int(self._state["pos_lo"])
        else:
            pos = int(self._state["pos_num"])
        # clamp: never before the oldest buffered frame, and keep the
        # numerator inside the int32 overflow envelope of _compute_n_out
        # (pos_num + i*L < (capacity+1)*M).  Wide schedules have no
        # int32 envelope, and heavy-downsample states routinely carry
        # pos beyond capacity*M (consumption is capped at avail) — the
        # ceiling clamp must only ever RESTRICT a forward request,
        # never push the position backwards on its own.
        if wide:
            applied = max(delta, -pos)
        else:
            ceiling = self._config.input_capacity * M
            applied = min(max(delta, -pos), max(0, ceiling - pos))
        if applied:
            new_pos = pos + applied
            if wide:
                self._state = dict(
                    self._state,
                    pos_hi=jnp.uint32(new_pos // M),
                    pos_lo=jnp.uint32(new_pos % M),
                )
            else:
                self._state = dict(self._state, pos_num=jnp.int32(new_pos))
        return applied / M

    @property
    def state(self) -> FirState:
        """Explicit stream-state pytree (checkpointable)."""
        return self._state

    @state.setter
    def state(self, value: FirState) -> None:
        self._state = value

    # -- processing --------------------------------------------------------

    def resample(self, input, output) -> tuple[int, int]:
        """Consume interleaved ``input`` and write resampled frames into
        interleaved ``output``; returns ``(consumed, produced)`` in total
        f32 values (reference: src/resampler_fir.rs:509-621)."""
        if self._reference is not None:
            return self._reference.resample(input, output)
        C = self._config.channels
        input = np.asarray(input, dtype=np.float32)
        if input.ndim != 1 or input.size % C:
            raise InvalidInputBufferSize(
                f"input length {input.size} is not a multiple of channels {C}"
            )
        if not isinstance(output, np.ndarray) or output.ndim != 1 or output.size % C:
            raise InvalidOutputBufferSize(
                "output must be a 1-D numpy array with length a multiple of "
                f"channels {C}"
            )

        n_frames = input.size // C
        out_budget = min(output.size // C, self._config.out_capacity)

        bucket = _bucket_for(n_frames)
        chunk = np.zeros((bucket, C), np.float32)
        n_feed = min(n_frames, bucket)
        if n_feed:
            chunk[:n_feed] = input[: n_feed * C].reshape(n_feed, C)

        self._state, out, consumed, produced = self._step(
            self._state, chunk, np.int32(n_feed), np.int32(out_budget)
        )
        consumed = int(consumed)
        produced = int(produced)
        if produced:
            output[: produced * C] = np.asarray(out[:produced]).reshape(-1)
        return consumed * C, produced * C

    #: Fast-path geometry: chunks per scanned dispatch and frames per
    #: chunk.  Half the input capacity guarantees full chunk acceptance
    #: in steady state (avail stays ~taps between steps), so the scan
    #: never drops frames for ordinary ratios; the post-scan consumption
    #: check catches the exceptions (extreme-upsampling backpressure)
    #: and falls back to the per-call loop.
    _MANY_T = 32
    _MANY_CHUNK = MAX_CHUNK // 2

    def process(self, input) -> np.ndarray:
        """Convenience batch helper: feed ``input`` in chunks until fully
        consumed, returning the concatenated output (mirrors the reference
        CLI loop, reference: resample/src/main.rs:226-254).

        File-length inputs run as SCANNED multi-chunk device programs —
        one dispatch per ``_MANY_T`` chunks instead of one per chunk
        (the host dispatch per 2048 frames dominated CLI wall-clock for
        long files) — with a bit-exact fallback to
        the per-call loop when the device cannot accept a chunk in full
        (buffer backpressure from extreme upsampling ratios)."""
        input = np.asarray(input, dtype=np.float32)
        C = self._config.channels
        n_frames = input.size // C
        use_many = (
            self._reference is None
            and input.ndim == 1
            and input.size % C == 0
            and n_frames >= 2 * self._MANY_CHUNK
            # extreme ratios blow up the [T, out_cap, C] stack or
            # backpressure the feed — keep them on the loop
            and self._config.out_capacity * C * self._MANY_T * 4
            <= (1 << 28)
        )
        if use_many:
            out, ok = self._process_many(input, n_frames)
            if ok:
                return out
        out_buf = np.zeros(self.buffer_size_output(), np.float32)
        pieces = []
        offset = 0
        while offset < input.size:
            consumed, produced = self.resample(input[offset:], out_buf)
            pieces.append(out_buf[:produced].copy())
            offset += consumed
            if consumed == 0 and produced == 0:
                break
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

    def _process_many(self, input, n_frames):
        """Scanned fast path for ``process``: returns ``(output, True)``
        or ``(None, False)`` after restoring the pre-call state when any
        chunk was not accepted in full (the loop re-runs it correctly)."""
        C = self._config.channels
        n = self._MANY_CHUNK
        if self._many is None:
            step = self._step_fn
            budget = jnp.int32(self._config.out_capacity)

            def many(state, chunks, nv):
                def body(st, x):
                    ch, v = x
                    st, out, consumed, produced = step(st, ch, v, budget)
                    return st, (out, consumed, produced)

                state, (outs, cs, ps) = jax.lax.scan(
                    body, state, (chunks, nv)
                )
                return state, outs, cs, ps

            self._many = jax.jit(many, donate_argnums=0)

        # snapshot for the fallback (donation consumes the live state)
        saved = jax.tree.map(np.asarray, self._state)
        frames = input.reshape(n_frames, C)
        pieces = []
        offset = 0
        ok = True
        while offset < n_frames and ok:
            t_full = min(self._MANY_T, -(-(n_frames - offset) // n))
            block = frames[offset : offset + t_full * n]
            chunks = np.zeros((self._MANY_T, n, C), np.float32)
            chunks.reshape(-1, C)[: block.shape[0]] = block
            nv = np.zeros((self._MANY_T,), np.int32)
            full, rem = divmod(block.shape[0], n)
            nv[:full] = n
            if rem:
                nv[full] = rem
            self._state, outs, cs, ps = self._many(
                self._state, jnp.asarray(chunks), jnp.asarray(nv)
            )
            cs = np.asarray(cs)
            ps = np.asarray(ps)
            if not np.array_equal(cs, nv):
                ok = False
                break
            outs = np.asarray(outs)
            for t in range(self._MANY_T):
                if ps[t]:
                    pieces.append(outs[t, : ps[t]].reshape(-1))
            offset += int(cs.sum())
        if not ok:
            self._state = jax.tree.map(jnp.asarray, saved)
            return None, False
        return (
            np.concatenate(pieces) if pieces else np.zeros(0, np.float32),
            True,
        )

    def __repr__(self) -> str:
        return (
            f"ResamplerFir(channels={self.channels}, "
            f"{self._input_hz}->{self._output_hz} Hz, taps={self.taps}, "
            f"phases={self._config.phases})"
        )
