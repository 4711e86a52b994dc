"""FFT overlap-add resampler engine.

Re-design of the reference FFT resampler
(reference: src/resampler_fft.rs:38-425) around one idea:

**The whole spectral pipeline is one linear operator.**  Per chunk the
reference runs: zero-pad N→2N → forward real FFT → multiply by a
precomputed Kaiser filter spectrum → truncate/zero-pad bins to the output
size → inverse real FFT at 2M → overlap-add.  Every step is linear in the
input, and chunk sizes are small and fixed (N ≤ 4096, from the planner
table), so the composition is precomputed once in float64 on the host
(the reference computes f32 FFTs at runtime; designing the operator in
f64 and casting once is strictly more accurate), cached process-wide like
the reference's FFT_CACHE, and applied as one matrix product.  There is
no FFT butterfly code on the hot path at all (the reference spends ~8.4k
LoC of SIMD on that — SURVEY.md §2.5).

The production form is ``backend="matmul"``: the dense ``[N, 2M]``
projector, run on the GPU as three TF32 passes (``tf32x3``), each at the
explicit dot algorithm ``FFT_DOT_ALGORITHM``.
Cross-check / escape-hatch backends: ``"conv"`` (banded channelized
form), ``"rfft"`` (real-valued runtime FFT for outsized custom pairs),
``"fft"`` (``jnp.fft`` op-for-op mirror of the reference dataflow).

The carry is explicit pytree state (``overlap [C, M]`` for the spectral
forms; the previous chunk for the input-domain conv form), so the engine
jits, vmaps (multi-stream), and shards like the FIR engine.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.planner import plan_conversion
from ..dsp.window import WindowType, calculate_cutoff_kaiser, make_sincs_for_kaiser
from ..types import (
    InvalidInputBufferSize,
    InvalidOutputBufferSize,
    SampleRate,
)

__all__ = [
    "KAISER_BETA",
    "FftConfig",
    "FftState",
    "fft_init",
    "make_fft_step",
    "make_fft_fleet_step",
    "fft_fleet_init",
    "FFT_BACKENDS",
    "FFT_DOT_ALGORITHM",
    "tf32_split",
    "tf32x3",
    "projector_operands",
    "spectral_projection_matrix",
    "input_domain_conv_operator",
    "conv_backend_viable",
    "fft_filter_spectrum",
    "ResamplerFft",
]

#: Kaiser window beta for ~-100 dB stopband
#: (reference: src/resampler_fft.rs:16).
KAISER_BETA = 10.0

#: Selectable FFT engine forms (``"auto"`` resolves to ``"matmul"``).
FFT_BACKENDS = ("matmul", "conv", "rfft", "fft")

#: Dot algorithm of each pass of the projector GEMM on the GPU.  A float32
#: product at DEFAULT or HIGH precision runs there as one TF32 pass, whose
#: ~-70 dB arithmetic floor is far above the Kaiser beta=10 filter's
#: -100 dB design stopband, so the projector runs as three TF32 passes
#: over a hi/lo split of its operands (``_project``) — of the forms that
#: clear the 99 dB gates the fastest on the H100 (PERF.md).  Platforms
#: without TF32 (the CPU) run the product at ``Precision.HIGHEST``, exact
#: float32 there.
FFT_DOT_ALGORITHM = jax.lax.DotAlgorithmPreset.TF32_TF32_F32

#: Float32 bits below TF32's 10-bit mantissa.
_TF32_LOW_BITS = 0x1FFF


@dataclasses.dataclass(frozen=True)
class FftConfig:
    """Static FFT engine configuration for one rate pair."""

    channels: int
    fft_size_input: int   # N: input samples per chunk per channel
    fft_size_output: int  # M: output samples per chunk per channel

    @property
    def delay(self) -> int:
        """Algorithmic latency in input samples = N/2
        (reference: src/resampler_fft.rs:147-153)."""
        return self.fft_size_input // 2


#: Carry pytree: ``{"overlap": f32[C, M]}`` for the matmul/fft backends,
#: ``{"prev": f32[C, N]}`` (the previous chunk) for the conv backend —
#: mathematically the same information (`overlap = prev @ T[:, M:]`).
FftState = dict


def fft_init(config: FftConfig, backend: str = "auto") -> FftState:
    if _resolve_backend(backend) == "conv":
        return {
            "prev": jnp.zeros(
                (config.channels, config.fft_size_input), jnp.float32
            )
        }
    return {
        "overlap": jnp.zeros(
            (config.channels, config.fft_size_output), jnp.float32
        )
    }


def convert_fft_state(state: FftState, config: FftConfig, backend: str) -> FftState:
    """Convert a carry pytree to the schema ``backend`` expects.

    A checkpoint written by the conv backend (``{"prev"}``) may be
    restored into a matmul resampler (``{"overlap"}``).  ``prev ->
    overlap`` is exact (``overlap = prev @ T[:, M:]``, computed at
    HIGHEST); the reverse is not invertible — construct the resampler
    with an explicit ``backend`` matching the checkpoint instead.  Leading
    batch dims (a fleet's ``[B]``) broadcast."""
    backend = _resolve_backend(backend)
    want_prev = backend == "conv"
    if ("prev" in state) == want_prev:
        return state
    if "prev" in state and not want_prev:
        proj = jnp.asarray(
            get_projection_matrix(
                config.fft_size_input, config.fft_size_output
            )[:, config.fft_size_output :]
        )
        overlap = jnp.dot(
            jnp.asarray(state["prev"], jnp.float32),
            proj,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return {"overlap": overlap}
    raise ValueError(
        "cannot convert an {'overlap'} carry to the input-domain "
        f"{backend!r} backend's {{'prev'}} state (the projection is not "
        "invertible); construct the resampler with backend='matmul' to "
        "restore this checkpoint"
    )


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        return "matmul"
    if backend not in FFT_BACKENDS:
        raise ValueError(
            f"unknown FFT backend {backend!r}; choose 'auto' or one of "
            f"{', '.join(repr(b) for b in FFT_BACKENDS)}"
        )
    return backend


# --------------------------------------------------------------------------
# Filter + projection-matrix design (host, float64, cached)
# --------------------------------------------------------------------------


def fft_filter_spectrum(n_in: int, n_out: int) -> np.ndarray:
    """Kaiser filter spectrum of the overlap-add filter, float64.

    Matches the reference design (reference: src/resampler_fft.rs:338-383):
    cutoff from Kaiser theory at size ``min(n_in, n_out)``, scaled by
    ``n_out/n_in`` when downsampling; periodic window; time-domain filter
    normalized by ``1/(2*n_in)`` (folding the unnormalized-FFT round-trip
    scale into the filter); spectrum = rFFT of the zero-padded filter.
    Returns ``[n_in + 1]`` complex128 bins.
    """
    if n_in > n_out:
        scale = n_out / n_in
        cutoff = calculate_cutoff_kaiser(n_out, KAISER_BETA) * scale
    else:
        cutoff = calculate_cutoff_kaiser(n_in, KAISER_BETA)

    sincs = make_sincs_for_kaiser(
        n_in, 1, float(np.float32(cutoff)), KAISER_BETA, WindowType.PERIODIC
    ).astype(np.float64)[0]
    filter_time = np.zeros(2 * n_in, np.float64)
    filter_time[:n_in] = sincs / (2 * n_in)
    return np.fft.rfft(filter_time)


def spectral_projection_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The fused ``[n_in, 2*n_out]`` float32 chunk operator ``T``.

    ``chunk_out_full = chunk_in @ T`` equals the reference per-chunk
    pipeline (reference: src/resampler_fft.rs:385-415): zero-pad to 2N,
    unnormalized rFFT, multiply the first ``new_length`` bins by the filter
    spectrum, copy them into a ``n_out+1``-bin spectrum (rest zero),
    unnormalized inverse rFFT at 2M.  Built column-exactly by pushing the
    identity basis through the (linear) pipeline with f64 numpy FFTs.
    """
    filt = fft_filter_spectrum(n_in, n_out)
    new_length = n_in + 1 if n_in < n_out else n_out

    basis = np.zeros((n_in, 2 * n_in), np.float64)
    basis[:, :n_in] = np.eye(n_in)
    spectrum = np.fft.rfft(basis, axis=1)  # unnormalized forward
    spectrum = spectrum[:, :new_length] * filt[:new_length]

    out_spec = np.zeros((n_in, n_out + 1), np.complex128)
    out_spec[:, :new_length] = spectrum
    # numpy irfft normalizes by 1/(2M); the reference inverse FFT is
    # unnormalized, so scale back by 2M.
    time = np.fft.irfft(out_spec, n=2 * n_out, axis=1) * (2 * n_out)
    return np.ascontiguousarray(time, dtype=np.float32)


def input_domain_conv_operator(n_in: int, n_out: int) -> np.ndarray:
    """The projector refactored as a **channelized strided convolution** —
    the FLOP-reduced form.

    Write the chunk pipeline in the input domain:
    ``out_t = x_t @ A + x_{t-1} @ B`` with ``A = T[:, :M]``, ``B = T[:, M:]``
    (the overlap-add carry is just the previous chunk), i.e.
    ``out_t = [x_{t-1}; x_t] @ T2`` with ``T2 = [B; A]`` of shape ``[2N, M]``.
    Because the underlying kernel is time-invariant and the planner
    guarantees ``N/M = L'/M'`` with ``N = g*L'``, T2 has the exact shift
    structure ``T2[i + L', j + M'] = T2[i, j]`` (verified to ~1e-11) and
    each column's support spans < ``(g+1)*L'`` rows (entries beyond are
    < 1.2e-7 of max — below the f32 design floor).  So the matmul is a
    banded Toeplitz operator, which maps onto a stride-1 conv
    by *channelizing at the period*: view ``[x_{t-1}; x_t]`` as ``2g``
    blocks of ``L'`` channels, and convolve with the ``[g+1, L', M']``
    filter ``W = T2[:(g+1)*L', :M']`` (a pure reshape of T2):

        out[c, k, j] = sum_{b, l} blocks[c, k+b, l] * W[b, l, j]

    FLOPs drop to ``(g+1)/(2g)`` of the dense projector (0.5625x for
    44.1<->48 kHz) and HBM writes halve (no separate overlap tail).
    Outputs match the dense projector to 2.4e-6.

    Whether the FLOP cut survives XLA's conv lowering on the GPU is not
    measured, so ``backend="auto"`` keeps the dense matmul and this form
    stays explicitly selectable (it documents the banded structure).
    (reference chunk pipeline: src/resampler_fft.rs:385-424)
    """
    T = spectral_projection_matrix(n_in, n_out).astype(np.float64)
    T2 = np.vstack([T[:, n_out:], T[:, :n_out]])  # [2N, M] = [B; A]
    g = math.gcd(n_in, n_out)
    lp, mp = n_in // g, n_out // g
    span = (g + 1) * lp
    return np.ascontiguousarray(
        T2[:span, :mp].reshape(g + 1, lp, mp), dtype=np.float32
    )


def conv_backend_viable(n_in: int, n_out: int) -> bool:
    """Whether the channelized conv form is well-shaped: the period must
    give the product real width (L', M' >= 64 channels) and the band must cut
    FLOPs (g >= 2).  Well-shaped does not mean faster — see the note in
    ``input_domain_conv_operator``."""
    g = math.gcd(n_in, n_out)
    return g >= 2 and n_in // g >= 64 and n_out // g >= 64


_PROJ_CACHE: dict[tuple[int, int], np.ndarray] = {}
_PROJ_LOCK = threading.Lock()


def get_projection_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Process-wide cache of projection matrices, the analog of the
    reference's global FFT_CACHE (reference: src/resampler_fft.rs:34-36,
    305-335)."""
    key = (n_in, n_out)
    with _PROJ_LOCK:
        mat = _PROJ_CACHE.get(key)
        if mat is None:
            mat = spectral_projection_matrix(n_in, n_out)
            _PROJ_CACHE[key] = mat
    return mat


# --------------------------------------------------------------------------
# Functional step
# --------------------------------------------------------------------------


def tf32_split(a):
    """``a = hi + lo`` exactly, with ``hi`` representable in TF32 (the
    float32 mantissa bits below TF32's cleared)."""
    a = jnp.asarray(a, jnp.float32)
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        bits & jnp.uint32(0xFFFFFFFF ^ _TF32_LOW_BITS), jnp.float32
    )
    return hi, a - hi


def projector_operands(proj):
    """``(proj, proj_hi, proj_lo)``: the projector and its TF32 split,
    made once when a step is built, for ``_project``."""
    return (jnp.asarray(proj), *tf32_split(proj))


def _tf32_dot(a, b):
    return jnp.dot(
        a, b, preferred_element_type=jnp.float32, precision=FFT_DOT_ALGORITHM
    )


def tf32x3(x, p_hi, p_lo, dot=_tf32_dot):
    """``x @ (p_hi + p_lo)`` as three TF32 passes,
    ``x_hi@p_hi + (x_lo@p_hi + x_hi@p_lo)``; the dropped ``lo@lo`` term is
    below float32's own rounding.  ``dot`` is one pass (a test passes an
    emulation of the GPU's TF32 product)."""
    x_hi, x_lo = tf32_split(x)
    return dot(x_hi, p_hi) + (dot(x_lo, p_hi) + dot(x_hi, p_lo))


def _project(x, ops):
    """``x [R, N] @ proj [N, K]`` with ``ops = projector_operands(proj)``:
    ``tf32x3`` on the GPU, ``Precision.HIGHEST`` elsewhere; the choice is
    made when the program is lowered for its platform.

    The split is written out because XLA's own ``TF32_TF32_F32_X3``
    preset is an attribute of the dot that the sharding partitioner drops
    from meshed programs, which then run one TF32 pass (PERF.md).  A pass
    of ``tf32x3`` that loses its attribute runs at DEFAULT, which is one
    TF32 pass on the GPU: the same arithmetic."""
    proj, p_hi, p_lo = ops
    return jax.lax.platform_dependent(
        x,
        cuda=lambda x: tf32x3(x, p_hi, p_lo),
        default=lambda x: jnp.dot(
            x, proj, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ),
    )


def _conv_project(blocks, w):
    """Channelized banded form: ``blocks [R, 2g, L'] (*) w [g+1, L', M']
    -> [R, g, M']``, at ``Precision.HIGHEST`` (the GPU's conv lowering
    does not honor a dot algorithm preset)."""
    return jax.lax.conv_general_dilated(
        blocks,
        w,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def make_fft_step(config: FftConfig, *, backend: str = "auto"):
    """Build the pure chunk-step:

    ``step(state, chunk [C, N] f32) -> (state', out [C, M] f32)``

    ``backend="matmul"`` (what ``"auto"`` resolves to) applies the fused
    projection matrix; ``backend="conv"`` applies the channelized banded
    convolution (see ``input_domain_conv_operator``); ``backend="rfft"``
    runs the real-valued mixed-radix FFT; ``backend="fft"`` mirrors the
    reference dataflow with ``jnp.fft`` (cross-check / very large custom
    sizes).
    """
    n_in = config.fft_size_input
    n_out = config.fft_size_output
    backend = _resolve_backend(backend)

    if backend == "conv":
        g = math.gcd(n_in, n_out)
        lp = n_in // g
        w = jnp.asarray(input_domain_conv_operator(n_in, n_out))
        C = config.channels

        def step(state: FftState, chunk):
            chunk = chunk.astype(jnp.float32)
            x2 = jnp.concatenate([state["prev"], chunk], axis=1)  # [C, 2N]
            out = _conv_project(x2.reshape(C, 2 * g, lp), w)  # [C, g, mp]
            return {"prev": chunk}, out.reshape(C, n_out)

        return step

    if backend == "matmul":
        ops = projector_operands(get_projection_matrix(n_in, n_out))

        def chunk_op(x):  # [C, N] -> [C, 2M]
            return _project(x, ops)

    elif backend == "rfft":
        # Runtime-FFT backend for sizes where a dense projector would be
        # too large: the real-valued mixed-radix FFT (dsp/rfft.py, no
        # complex dtypes).  Mirrors the reference chunk dataflow
        # (reference: src/resampler_fft.rs:385-424) with unnormalized
        # FFTs and the normalization folded into the filter.
        from ..dsp.rfft import irfft_pair, rfft_pair

        filt_np = fft_filter_spectrum(n_in, n_out)
        new_length = n_in + 1 if n_in < n_out else n_out
        fr = jnp.asarray(filt_np[:new_length].real, jnp.float32)
        fi = jnp.asarray(filt_np[:new_length].imag, jnp.float32)
        pad = n_out + 1 - new_length

        def chunk_op(x):  # [C, N] -> [C, 2M]
            xp = jnp.pad(x, ((0, 0), (0, n_in)))
            re, im = rfft_pair(xp, 2 * n_in)
            re, im = re[:, :new_length], im[:, :new_length]
            sre = re * fr - im * fi
            sim = re * fi + im * fr
            sre = jnp.pad(sre, ((0, 0), (0, pad)))
            sim = jnp.pad(sim, ((0, 0), (0, pad)))
            return irfft_pair(sre, sim, 2 * n_out)

    else:  # "fft"
        # Cross-checking backend mirroring the reference dataflow; the
        # filter stays a host-side numpy constant so tracing never
        # round-trips a complex array through the device.
        filt_np = fft_filter_spectrum(n_in, n_out)
        new_length = n_in + 1 if n_in < n_out else n_out
        filt = np.asarray(filt_np[:new_length], np.complex64)

        def chunk_op(x):  # [C, N] -> [C, 2M]
            spec = jnp.fft.rfft(x, n=2 * n_in, axis=1)
            spec = spec[:, :new_length] * filt
            pad = n_out + 1 - new_length
            spec = jnp.pad(spec, ((0, 0), (0, pad)))
            return jnp.fft.irfft(spec, n=2 * n_out, axis=1) * (2 * n_out)

    def step(state: FftState, chunk):
        full = chunk_op(chunk.astype(jnp.float32))
        out = full[:, :n_out] + state["overlap"]
        return {"overlap": full[:, n_out:]}, out

    return step


def make_fft_fleet_step(
    config: FftConfig, n_streams: int, *, backend: str = "auto"
):
    """Fleet-wide FFT step: ``streams x channels`` folded into the row
    dimension of ONE device op.

    A vmap of the per-stream step would batch ``n_streams`` tiny
    per-stream products; folding the fleet into the rows gives one large
    GEMM.  ``step(state, chunks [B, C, N]) -> (state, out [B, C, M])``;
    state is ``{"overlap": [B, C, M]}`` for the matmul backend,
    ``{"prev": [B, C, N]}`` for the conv backend.  Only these two forms
    have a fleet step.  Under a mesh, place state and chunks with
    ``shard_batch`` and GSPMD partitions the rows.
    """
    n_in = config.fft_size_input
    n_out = config.fft_size_output
    C = config.channels
    B = n_streams
    backend = _resolve_backend(backend)

    if backend == "conv":
        g = math.gcd(n_in, n_out)
        lp = n_in // g
        w = jnp.asarray(input_domain_conv_operator(n_in, n_out))

        def step(state: FftState, chunks):
            chunks = chunks.astype(jnp.float32)
            x2 = jnp.concatenate(
                [state["prev"], chunks], axis=2
            ).reshape(B * C, 2 * g, lp)
            out = _conv_project(x2, w)  # [B*C, g, mp]
            return {"prev": chunks}, out.reshape(B, C, n_out)

        return step

    if backend != "matmul":
        raise ValueError(
            f"the fleet step supports the 'matmul' and 'conv' backends, "
            f"not {backend!r}"
        )
    ops = projector_operands(get_projection_matrix(n_in, n_out))

    def step(state: FftState, chunks):
        x = chunks.astype(jnp.float32).reshape(B * C, n_in)
        full = _project(x, ops).reshape(B, C, 2 * n_out)
        out = full[:, :, :n_out] + state["overlap"]
        return {"overlap": full[:, :, n_out:]}, out

    return step


def fft_fleet_init(
    config: FftConfig, n_streams: int, backend: str = "auto"
) -> FftState:
    if _resolve_backend(backend) == "conv":
        return {
            "prev": jnp.zeros(
                (n_streams, config.channels, config.fft_size_input),
                jnp.float32,
            )
        }
    return {
        "overlap": jnp.zeros(
            (n_streams, config.channels, config.fft_size_output), jnp.float32
        )
    }


# --------------------------------------------------------------------------
# Stateful wrapper — reference-parity public API
# --------------------------------------------------------------------------


class ResamplerFft:
    """FFT overlap-add resampler with a fixed chunk-size API
    (reference: src/resampler_fft.rs:43-240).

    Interleaved f32 buffers; exactly one chunk per ``resample()`` call::

        r = ResamplerFft(2, SampleRate.Hz44100, SampleRate.Hz48000)
        input = np.zeros(r.chunk_size_input(), np.float32)
        output = np.zeros(r.chunk_size_output(), np.float32)
        r.resample(input, output)
    """

    def __init__(
        self,
        channels: int,
        sample_rate_input: SampleRate,
        sample_rate_output: SampleRate,
        *,
        backend: str = "auto",
    ) -> None:
        sample_rate_input = SampleRate(sample_rate_input)
        sample_rate_output = SampleRate(sample_rate_output)
        cfg = plan_conversion(
            sample_rate_input, sample_rate_output
        ).scale_for_throughput()
        self._config = FftConfig(
            channels=channels,
            fft_size_input=cfg.fft_size_input,
            fft_size_output=cfg.fft_size_output,
        )
        self._input_rate = sample_rate_input
        self._output_rate = sample_rate_output
        self._backend = backend
        self._step_fn = make_fft_step(self._config, backend=backend)
        self._step = jax.jit(self._step_fn, donate_argnums=0)
        self._state = fft_init(self._config, backend)
        self._many = None  # scanned fast path for process(), built lazily

    @property
    def channels(self) -> int:
        return self._config.channels

    @property
    def fft_size_input(self) -> int:
        return self._config.fft_size_input

    @property
    def fft_size_output(self) -> int:
        return self._config.fft_size_output

    def chunk_size_input(self) -> int:
        """Required input size in total f32 values, all channels
        (reference: src/resampler_fft.rs:131-137)."""
        return self._config.fft_size_input * self._config.channels

    def chunk_size_output(self) -> int:
        """Produced output size in total f32 values, all channels
        (reference: src/resampler_fft.rs:139-145)."""
        return self._config.fft_size_output * self._config.channels

    def delay(self) -> int:
        return self._config.delay

    def reset(self) -> None:
        self._state = fft_init(self._config, self._backend)

    @property
    def state(self) -> FftState:
        return self._state

    @state.setter
    def state(self, value: FftState) -> None:
        # Accept carries checkpointed under a different backend (the
        # conv form's {"prev"} schema restores into matmul's {"overlap"}).
        self._state = convert_fft_state(value, self._config, self._backend)

    def resample(self, input, output) -> None:
        """Resample exactly one interleaved chunk
        (reference: src/resampler_fft.rs:155-240)."""
        C = self._config.channels
        input = np.asarray(input, dtype=np.float32)
        if input.ndim != 1 or input.size < self.chunk_size_input():
            raise InvalidInputBufferSize(
                f"input must hold at least {self.chunk_size_input()} values"
            )
        if (
            not isinstance(output, np.ndarray)
            or output.ndim != 1
            or output.size < self.chunk_size_output()
        ):
            raise InvalidOutputBufferSize(
                f"output must hold at least {self.chunk_size_output()} values"
            )

        n_in = self._config.fft_size_input
        chunk = input[: n_in * C].reshape(n_in, C).T  # deinterleave
        self._state, out = self._step(self._state, chunk)
        output[: self.chunk_size_output()] = np.asarray(out.T).reshape(-1)

    #: Chunks per scanned dispatch in the ``process`` fast path.
    _MANY_T = 32

    def process(self, input) -> np.ndarray:
        """Batch helper: pad to whole chunks, resample, truncate to the
        expected length (mirrors the reference CLI batch loop,
        reference: resample/src/main.rs:256-313).

        File-length inputs run as SCANNED multi-chunk device programs —
        one dispatch per ``_MANY_T`` chunks for the bulk, the per-chunk
        loop for the tail — instead of one host dispatch per 512-4096
        frames (the CLI tier's wall-clock bound).
        State advances identically to the loop (tested bit-exact)."""
        input = np.asarray(input, dtype=np.float32)
        ci, co = self.chunk_size_input(), self.chunk_size_output()
        n_chunks = -(-input.size // ci) if input.size else 0
        out = np.zeros(n_chunks * co, np.float32)
        C = self._config.channels
        n_in = self._config.fft_size_input
        T = self._MANY_T
        k = 0
        if n_chunks >= 2 * T:
            if self._many is None:
                step = self._step_fn

                def many(state, chunks):
                    def body(st, ch):
                        st, o = step(st, ch)
                        return st, o

                    return jax.lax.scan(body, state, chunks)

                self._many = jax.jit(many, donate_argnums=0)
            while n_chunks - k >= T:
                # T full chunks by construction; deinterleave to [T, C, n]
                block = np.transpose(
                    input[k * ci : (k + T) * ci].reshape(T, n_in, C),
                    (0, 2, 1),
                )
                self._state, outs = self._many(
                    self._state, jnp.asarray(block)
                )
                out[k * co : (k + T) * co] = (
                    np.transpose(np.asarray(outs), (0, 2, 1)).reshape(-1)
                )
                k += T
        buf_in = np.zeros(ci, np.float32)
        for kk in range(k, n_chunks):
            piece = input[kk * ci : (kk + 1) * ci]
            buf_in[: piece.size] = piece
            buf_in[piece.size :] = 0.0
            self.resample(buf_in, out[kk * co : (kk + 1) * co])
        expected = -(-input.size * co // ci)
        return out[:expected]

    def __repr__(self) -> str:
        return (
            f"ResamplerFft(channels={self.channels}, "
            f"{int(self._input_rate)}->{int(self._output_rate)} Hz, "
            f"N={self.fft_size_input}, M={self.fft_size_output})"
        )
