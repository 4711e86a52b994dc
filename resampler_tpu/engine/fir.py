"""Polyphase FIR resampler engine.

Re-design of the reference streaming polyphase resampler
(reference: src/resampler_fir.rs:168-643) around three data-parallel
ideas:

1. **Exact integer phase accumulator.**  The reference advances an f64
   ``position`` by ``ratio = in_rate/out_rate`` once per output sample — a
   sequential scalar loop.  Here the position is the exact rational
   ``pos_num / M`` where ``L/M = in_rate/out_rate`` in lowest terms, carried
   as an int32 numerator.  Output ``i`` of a chunk then has numerator
   ``pos_num + i*L``, so the entire per-chunk schedule
   ``(input_offset, phase1, phase2, frac)`` is an elementwise int32
   computation over ``i = 0..out_cap`` — fully parallel, and
   *exact* (no f64 drift over arbitrarily long streams).

2. **The coefficient table becomes structure, not lookups.**  Per output
   sample the reference gathers two phase rows from the 1024-phase table
   and runs a dual-accumulator SIMD dot (reference: src/fir/avx.rs:14-61).
   Here the table is consumed at build time instead: for on-chip periods
   the blended rows band into a static kernel atlas and the chunk is one
   strided matmul (``_convolve_periodic``); for arbitrary coprime
   ratios the table is refit as per-tap Chebyshev polynomials and the
   chunk becomes a basis-response convolution plus blocked contractions
   (``_convolve_farrow``) — no runtime gathers on either production path.
   A table-lerp-exact general path (``_convolve_gather``) is kept for
   reference semantics.

3. **Static shapes under jit.**  ``(consumed, produced)`` vary per call, so
   outputs use a fixed capacity (``buffer_size_output``) plus a valid count,
   with masked tails — no dynamic shapes, no recompiles.  Input chunks are
   bucketed to a small set of padded sizes by the stateful wrapper.

State is an explicit pytree, so streams checkpoint/restore and ``vmap``
trivially (the batched multi-stream engine wraps this same core).
"""

from __future__ import annotations

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..dsp.window import WindowType, calculate_cutoff_kaiser, make_sincs_for_kaiser
from ..types import (
    Attenuation,
    InvalidInputBufferSize,
    InvalidOutputBufferSize,
    Latency,
    reduce_ratio,
)

__all__ = [
    "PHASES",
    "INPUT_CAPACITY",
    "BUFFER_SIZE",
    "FirConfig",
    "FirState",
    "fir_init",
    "make_fir_step",
    "fir_coefficients",
    "ResamplerFir",
]

#: Polyphase branch count (reference: src/resampler_fir.rs:17).
PHASES = 1024
#: Maximum buffered input frames (reference: src/resampler_fir.rs:18).
INPUT_CAPACITY = 4096
#: Reference analog kept for parity accounting; this engine uses an
#: end-aligned layout instead of a double-sized ring
#: (reference: src/resampler_fir.rs:19).
BUFFER_SIZE = INPUT_CAPACITY * 2
#: Largest padded input bucket accepted by one ``step`` call (frames).
MAX_CHUNK = INPUT_CAPACITY
#: End of the valid region in the end-aligned buffer: the newest frame
#: always sits at column VALID_END-1, so appending is a STATIC-seam concat
#: + one contiguous dynamic slice (a write at a per-stream dynamic offset
#: would lower to a batched scatter under vmap).
VALID_END = INPUT_CAPACITY
#: Fallback slack after VALID_END (non-periodic paths; the gather path
#: reads with clipped indices so it needs none — kept small for safety).
MIN_READ_SLACK = 128
#: Reduced output-rate denominator limit keeping every scheduled int32
#: quantity below 2^31 (see overflow analysis in ``_compute_n_out``).
#: Beyond it (or the matching numerator bound) the engine switches to the
#: WIDE schedule: position carried as (frames uint32, subframe-numerator
#: uint32) with emission masks and static split tables, supporting any
#: nonzero u32 rate pair like the reference's f64 position does
#: (reference: src/resampler_fir.rs:311-313; v0.5.1 overflow fix #36) —
#: but exactly, with no f64 drift.
MAX_REDUCED_RATE = 500_000
#: Static output-lane cap: extreme upsampling ratios (reduced M >> L)
#: would otherwise explode the per-call output buffer (1 Hz -> 96 kHz is
#: ~392M frames per full input buffer).  The reference bounds per-call
#: output by the CALLER's buffer (src/resampler_fir.rs:522-556); here the
#: static out array is capped and the stateful wrapper's budget loop
#: feeds/produces incrementally, so streams progress regardless.
OUT_CAP_MAX = 1 << 20


@dataclasses.dataclass(frozen=True)
class FirConfig:
    """Static (hashable) FIR engine configuration."""

    channels: int
    taps: int
    ratio_num: int  # L: reduced input rate
    ratio_den: int  # M: reduced output rate
    phases: int = PHASES
    input_capacity: int = INPUT_CAPACITY

    def __post_init__(self) -> None:
        if self.channels < 1:
            raise ValueError("channel count must be at least 1")
        if not (1 <= self.ratio_num < (1 << 32)) or not (
            1 <= self.ratio_den < (1 << 32)
        ):
            raise ValueError(
                "sample rates must reduce to nonzero u32 values "
                f"(reference parity): {self.ratio_num}/{self.ratio_den}"
            )

    @property
    def wide(self) -> bool:
        """True when the reduced ratio exceeds the int32 schedule envelope
        and the engine must carry position as (uint32 frames, uint32
        subframe numerator) — see ``_wide_schedule``."""
        return self.ratio_den > MAX_REDUCED_RATE or self.ratio_num > (
            1 << 31
        ) // (self.input_capacity + 2)

    @property
    def read_slack(self) -> int:
        """Slack after VALID_END so no convolve path's static-size region
        read ever clamps (a clamped dynamic_slice shifts the window,
        corrupting valid lanes).

        Periodic bound: the read starts at ``VALID_END - avail + d_min``
        with ``d_min <= avail - taps + 1 + ceil(L/M)`` (capped-consumption
        worst case), so region_cols + L//M + margin covers every state.
        Gather bound: the read starts at ``read_pos + base <= VALID_END``
        and spans ``j_max + 2 + taps`` rows.  Both paths may be forced via
        ``path=``, so take the max."""
        L, taps = self.ratio_num, self.taps
        j_max = ((self.out_capacity - 1) * L) // self.ratio_den
        if self.wide:
            # wide schedules clamp their static row offsets at the buffer
            # edge (lanes beyond can never be emitted) — see _wide_schedule
            j_max = min(j_max, self.input_capacity + 2)
        gather_need = j_max + 2 + taps + MIN_READ_SLACK
        if resolve_convolve_path(self) != "periodic":
            slack = gather_need
        else:
            span = L + taps + 1
            K = -(-self.out_capacity // self.ratio_den)
            n_blk = 1 + -(-(span - L) // L)
            # cover BOTH periodic region forms: the frames-minor step
            # picks im2col vs conv by _use_im2col, but the time-major
            # fleet step uses im2col unconditionally — its (K + n_blk)*L
            # read must never clamp-shift near the compaction threshold
            region_cols = max((K + n_blk) * L, (K - 1) * L + span)
            # ... and the GROUPED form the tm fleet uses for small-M
            # families (see _periodic_group_factor): same leading K*L
            # term, slightly wider block tail
            g = _periodic_group_factor(L, self.ratio_den)
            if g > 1:
                Lg, Mg = L * g, self.ratio_den * g
                span_g = Lg + taps + 1
                K_g = -(-self.out_capacity // Mg)
                n_blk_g = 1 + -(-(span_g - Lg) // Lg)
                region_cols = max(
                    region_cols,
                    (K_g + n_blk_g) * Lg,
                    (K_g - 1) * Lg + span_g,
                )
            slack = max(
                region_cols + L // self.ratio_den + MIN_READ_SLACK,
                gather_need,
            )
        return -(-slack // 256) * 256  # round up for tidy layouts

    @property
    def buffer_alloc(self) -> int:
        # End-aligned layout: valid data occupies the last
        # ``available_frames`` columns of [0, VALID_END); the slack tail
        # stays zero so static-size span reads never clamp.
        return self.input_capacity + self.read_slack

    @property
    def out_capacity(self) -> int:
        """Maximum output frames a single call can produce, capped at
        ``OUT_CAP_MAX`` static lanes for extreme upsampling ratios (the
        stateful wrapper's budget loop produces the rest incrementally;
        reference: src/resampler_fir.rs:455-465)."""
        max_usable = self.input_capacity - self.taps
        exact = (max_usable * self.ratio_den) // self.ratio_num + (
            1 if (max_usable * self.ratio_den) % self.ratio_num else 0
        ) + 2
        return min(exact, OUT_CAP_MAX)

    @property
    def delay(self) -> int:
        """Algorithmic latency in input samples
        (reference: src/resampler_fir.rs:623-632)."""
        return self.taps // 2


#: Streaming state pytree: ``buffer [C, buffer_alloc] f32`` (end-aligned:
#: the valid ``available_frames`` columns end at VALID_END),
#: ``available_frames`` and ``pos_num`` (int32 scalars).  A plain dict, so
#: stream state is trivially serializable (checkpoint/resume) and
#: vmappable — a capability the reference only implies (SURVEY.md §5).
FirState = dict


def fir_init(config: FirConfig) -> FirState:
    if config.wide:
        # Wide schedule: exact position = (pos_hi + pos_lo/M) input
        # frames, both uint32 (JAX's x64 mode must not be required of
        # library users, so 64-bit integers are unavailable on device;
        # two u32 words cover any u32 rate pair exactly).
        return FirState(
            buffer=jnp.zeros(
                (config.channels, config.buffer_alloc), jnp.float32
            ),
            available_frames=jnp.zeros((), jnp.int32),
            pos_hi=jnp.zeros((), jnp.uint32),
            pos_lo=jnp.zeros((), jnp.uint32),
        )
    return FirState(
        buffer=jnp.zeros((config.channels, config.buffer_alloc), jnp.float32),
        available_frames=jnp.zeros((), jnp.int32),
        pos_num=jnp.zeros((), jnp.int32),
    )


# --------------------------------------------------------------------------
# Coefficient table + process-wide cache (reference: src/resampler_fir.rs:89-95,
# 164-166, 406-443).
# --------------------------------------------------------------------------

_COEFF_CACHE: dict[tuple, np.ndarray] = {}
_COEFF_LOCK = threading.Lock()


def fir_cutoff(taps: int, attenuation: Attenuation, ratio: float) -> float:
    """Normalized cutoff: Kaiser-theory cutoff for ``taps``, scaled to the
    output Nyquist when downsampling (reference: src/resampler_fir.rs:316-324)."""
    base = calculate_cutoff_kaiser(taps, attenuation.kaiser_beta)
    if ratio > 1.0:  # downsampling: anti-aliasing at output Nyquist
        return base / ratio
    return base


def fir_coefficients(
    taps: int, attenuation: Attenuation, cutoff: float
) -> np.ndarray:
    """``[PHASES, taps]`` float32 polyphase table, cached process-wide by
    ``(cutoff bits, taps, attenuation)``."""
    key = (np.float32(cutoff).tobytes(), taps, attenuation)
    with _COEFF_LOCK:
        table = _COEFF_CACHE.get(key)
        if table is None:
            table = make_sincs_for_kaiser(
                taps,
                PHASES,
                float(np.float32(cutoff)),
                attenuation.kaiser_beta,
                WindowType.SYMMETRIC,
            )
            _COEFF_CACHE[key] = table
    return table


# --------------------------------------------------------------------------
# Functional step
# --------------------------------------------------------------------------


def _compute_n_out(config: FirConfig, pos_num, avail, out_budget):
    """Number of output frames producible this call: the largest ``n`` with
    ``pos_num + (n-1)*L < (avail - taps + 1) * M``, capped by the caller's
    output budget (reference loop guard: src/resampler_fir.rs:544-554).

    Overflow analysis (all int32): with ``M = ratio_den <= 500_000`` and
    ``L = ratio_num <= 2^31/(capacity+2)``:
    ``(avail - taps + 1) * M <= (capacity+1) * M < 2^31``; every scheduled
    numerator ``pos_num + i*L`` for emitted lanes stays below the same
    bound; ``rem * phases <= (M-1) * 1024 < 2^31``.
    """
    L = jnp.int32(config.ratio_num)
    M = jnp.int32(config.ratio_den)
    limit = (avail - config.taps + 1) * M - pos_num
    n_from_input = jnp.where(limit > 0, (limit + L - 1) // L, 0)
    return jnp.clip(n_from_input, 0, out_budget).astype(jnp.int32)


def _phase_blend(table, rem, M):
    """Blend the two neighboring phase rows for residues ``rem`` (in units
    of 1/M): ``phase_f = rem*PHASES/M``, rows ``floor(phase_f)`` and
    ``min(floor+1, PHASES-1)``, lerp by the fractional part — the same
    arithmetic as the reference kernels
    (reference: src/resampler_fir.rs:557-565, src/fir/mod.rs:18-45)."""
    phases = table.shape[0]
    pf = rem * phases
    p1 = pf // M
    p2 = jnp.minimum(p1 + 1, phases - 1)
    frac = (pf - p1 * M).astype(jnp.float32) / jnp.float32(M)
    return (1.0 - frac)[:, None] * table[p1] + frac[:, None] * table[p2]


def _convolve_gather(config: FirConfig, coeffs):
    """General-rate path — GATHER-FREE.  Correct for any reduced ratio.

    Gathers with per-stream traced indices lower to element-granularity
    loads under vmap.  This path removes every traced-index gather using
    the carry
    decomposition of the exact rational schedule: with ``pos = base*M + r``
    (``base``, ``r`` per-stream scalars) and the STATIC per-lane splits
    ``i*L = j_i*M + s_i``,

        offset_i = base + j_i + wrap_i,         wrap_i  = [r + s_i >= M]
        p1_i     = (rp + a_i + c_i) mod 1024,   rp = (r*1024)//M
        frac_i   = (rq + b_i - M*c_i)/M,        rq = (r*1024) mod M
                                                c_i = [rq + b_i >= M]

    where ``j_i, s_i, a_i = (s_i*1024)//M, b_i = (s_i*1024) mod M`` are
    trace-time constants.  So the dynamic structure is one scalar-offset
    contiguous ``dynamic_slice`` (the window region at
    ``read_pos + base``), flat row-takes from a 3x-tiled phase table,
    STATIC row-takes of the im2col windows, and elementwise carry
    selects.  Identical arithmetic to the naive form (differentially
    tested).

    This path exists for table-lerp-exact reference semantics; the
    Farrow path (``_convolve_farrow``) is the arbitrary-ratio production
    path, and rates with a reduced denominator <= 2048 — every standard
    audio pair — use the periodic path.
    """
    L_ = config.ratio_num
    M_ = config.ratio_den
    taps = config.taps
    C = config.channels
    phases = config.phases
    N = config.out_capacity
    valid_end = config.input_capacity

    i = np.arange(N, dtype=np.int64)
    j_np = ((i * L_) // M_).astype(np.int32)          # static row offsets
    s_np = ((i * L_) % M_).astype(np.int64)
    a_np = ((s_np * phases) // M_).astype(np.int32)   # static phase offsets
    b_np = ((s_np * phases) % M_).astype(np.int32)
    j_max = int(j_np[-1])
    region_len = j_max + 2 + taps

    table = np.asarray(coeffs, np.float32)
    tiled = np.concatenate([table, table, table[:4]], axis=0)  # [2052, taps]

    j_c = jnp.asarray(j_np)
    a_c = jnp.asarray(a_np)
    b_c = jnp.asarray(b_np)
    tiled_c = jnp.asarray(tiled)
    L = jnp.int32(L_)
    M = jnp.int32(M_)

    def convolve(buffer, read_pos, pos_num, n_out):
        base = pos_num // M
        r = pos_num - base * M
        # clamp: base beyond the valid data means n_out == 0 anyway, but
        # an unclamped dynamic_slice would CLAMP-SHIFT the window and
        # corrupt nothing-to-produce steps' masked lanes harmlessly —
        # keep the start within the buffer for defined behavior
        avail = valid_end - read_pos
        base = jnp.minimum(base, avail)

        # ---- blended phase rows, gather-free ----
        rp = (r * phases) // M
        rq = (r * phases) - rp * M
        c = (rq + b_c >= M).astype(jnp.int32)            # [N]
        frac = (rq + b_c - M * c).astype(jnp.float32) / jnp.float32(M_)
        # flat row-takes instead of a per-stream dynamic_slice of the
        # tiled table (a vmapped dynamic_slice lowers to a batched
        # gather)
        row1 = jnp.take(tiled_c, rp + a_c + c, axis=0)
        row2 = jnp.take(tiled_c, rp + a_c + c + 1, axis=0)
        # reference clamps p2 = min(p1+1, 1023): where p1 == 1023 the
        # second row is row1 itself, not phase 0
        p1_mod = (rp + a_c + c) % phases
        row2 = jnp.where((p1_mod == phases - 1)[:, None], row1, row2)
        w = (1.0 - frac)[:, None] * row1 + frac[:, None] * row2  # [N, taps]

        # ---- windows, gather-free ----
        wrap = (r + jnp.asarray(s_np.astype(np.int32)) >= M).astype(jnp.int32)
        region = jax.lax.dynamic_slice(
            buffer, (0, read_pos + base), (C, region_len)
        )
        # native im2col: a stack of shifted slices materializes 128
        # size-1-minor intermediates; conv_general_dilated_patches
        # extracts the same patches through
        # the conv machinery with sane layouts.  Channels are packed into
        # the LANES of each im2col row so the (per-row-cost) gather
        # fetches one [C*taps] row per output, and the wrap carry is
        # folded into the take index — ONE take for all window data.
        patches = jax.lax.conv_general_dilated_patches(
            region[:, None, :],          # [C, 1, region_len] (NCW)
            filter_shape=(taps,),
            window_strides=(1,),
            padding="VALID",
            # The patch extraction is a one-hot conv, i.e. a product: at
            # DEFAULT precision a device may round every window to a
            # low-precision pass (bf16/TF32) inside what is meant as a
            # copy.  HIGHEST keeps the identity exact.
            precision=jax.lax.Precision.HIGHEST,
        )  # [C, taps, j_max+3]
        x_im2col = jnp.transpose(patches, (0, 2, 1))  # [C, j_max+3, taps]
        x1 = jnp.take(x_im2col, j_c, axis=1)          # [C, N, taps]
        x2 = jnp.take(x_im2col, j_c + 1, axis=1)
        # carry-select AFTER the contraction (selecting between the two
        # [C, N, taps] tensors would materialize both); the contraction
        # is a per-lane elementwise mul+sum — exact f32, and no
        # batched-matvec einsum lowering
        o1 = jnp.sum(x1 * w[None, :, :], axis=2)  # [C, N]
        o2 = jnp.sum(x2 * w[None, :, :], axis=2)
        return jnp.where(wrap[None, :] == 1, o2, o1).T

    return convolve


#: Farrow path: polynomial degree and outputs-per-block for the blocked
#: one-hot contraction.  Degree 7 keeps the grid residual (8.7e-7) below
#: the table-lerp's own 1.2e-6; the block size is not yet tuned on the
#: GPU.
FARROW_DEGREE = 7
FARROW_BLOCK = 64
#: Upper block-size cap: bounds the [K, q, d1] / blocked-contraction
#: shapes and keeps the static per-block slice count K small even for
#: extreme upsampling (where out_capacity reaches OUT_CAP_MAX lanes).
FARROW_BLOCK_MAX = 4096


def farrow_block_size(L: int, M: int, block: int = FARROW_BLOCK) -> int:
    """Outputs per block, adapted to the ratio so the per-block input span
    stays ~``FARROW_BLOCK`` frames.

    A block of ``q`` outputs spans ``~q*L/M`` input frames; heavy coprime
    DOWNSAMPLING (large L/M) with a fixed ``q`` would inflate both the
    blocked intermediates and the per-output work (an earlier design
    fell back to the slow gather path beyond L/M ~ 16).  Holding
    ``q*L/M ~ FARROW_BLOCK`` instead keeps the local span bounded for
    any ratio — at the extreme ``q=1`` each "block" is one output whose
    span is just ``taps+2``, i.e. the minimal per-output work the
    reference CPU does (reference: src/resampler_fir.rs:542-590).
    UPSAMPLING scales ``q`` up the same way (many outputs share each
    input frame), bounding the number of static region blocks ``K`` for
    high-ratio pairs whose out_capacity reaches OUT_CAP_MAX lanes."""
    return max(1, min(FARROW_BLOCK_MAX, (block * M) // max(L, 1)))


def farrow_matrix(coeffs, degree: int = FARROW_DEGREE):
    """``[degree+1, taps]`` Chebyshev-basis coefficients fit to the phase
    table: ``c_t(phi) ~= sum_k A[k, t] T_k(2 phi - 1)``.

    The 1024-phase table is itself a sampling of the smooth continuous
    coefficient function (one tap advances by one sample across
    ``phi in [0, 1)``, so its bandwidth is ~1 cycle); a degree-9 fit
    reproduces the grid to ~3e-8 — below the table-LERP's own ~1.2e-6
    interpolation error.  Returns ``(A f32, max grid residual)``."""
    table = np.asarray(coeffs, np.float64)  # [P, taps]
    P = table.shape[0]
    u = 2 * (np.arange(P) / P) - 1
    V = np.polynomial.chebyshev.chebvander(u, degree)
    A, *_ = np.linalg.lstsq(V, table, rcond=None)
    resid = float(np.abs(V @ A - table).max())
    return A.astype(np.float32), resid


def _convolve_farrow(config: FirConfig, coeffs):
    """General-rate path — FARROW STRUCTURE (the production arbitrary-
    ratio path).

    The gather path's wall is window-copy bytes: it materializes
    ``[N, taps]`` windows twice.  The Farrow restructuring never builds
    windows: per chunk,

        Y = conv(region, A)          # [C, d+1, P] basis responses
        out_i = sum_k T_k(u_i) * Y[k, off_i]

    with ``A = farrow_matrix(coeffs)`` (polynomial-in-phase form of the
    coefficient function), evaluated as ``N/Q`` blocked contractions
    ``G = V_blk @ Y_blk`` whose per-output offset selection is a one-hot
    mask FUSED into the reduction — no dynamic gathers anywhere; the
    only traced-offset op is the same single contiguous region
    ``dynamic_slice`` the gather path uses.

    Numerics: evaluates the CONTINUOUS kernel — deviation from the
    table-lerp semantics is the lerp's own ~1.2e-6 error except in the
    reference's phase-1023 clamp bin (reference quirk:
    src/resampler_fir.rs:560-563, p2 = min(p1+1, 1023) holds the last
    1/1024 of each phase turn constant, ~3e-3 from the true kernel).
    ``path="gather"`` remains selectable for table-lerp-exact outputs.
    (reference arbitrary-rate support: src/resampler_fir.rs:295-404.)
    """
    L_ = config.ratio_num
    M_ = config.ratio_den
    taps = config.taps
    C = config.channels
    N = config.out_capacity
    valid_end = config.input_capacity
    degree = FARROW_DEGREE
    q = farrow_block_size(L_, M_)
    d1 = degree + 1
    wide = config.wide

    i = np.arange(N, dtype=np.int64)
    j_i64 = (i * L_) // M_
    s_i64 = (i * L_) % M_
    if wide:
        # lanes whose static row offset exceeds the buffer can never be
        # emitted (offset + taps <= avail <= capacity fails); clamping
        # keeps the region geometry bounded for any u32 ratio while the
        # masked lanes read harmless garbage
        j_i64 = np.minimum(j_i64, valid_end + 2)
    j_np = j_i64.astype(np.int64)
    s_np = s_i64
    j_max = int(j_np[-1])
    region_len = j_max + 2 + taps
    p_len = j_max + 3  # VALID conv positions: region_len - taps + 1

    K = -(-N // q)
    n_pad = K * q
    j_pad = np.concatenate([j_np, np.full(n_pad - N, j_np[-1], np.int64)])
    s_pad = np.concatenate([s_np, np.zeros(n_pad - N, np.int64)])
    block_base = j_pad.reshape(K, q)[:, 0]               # [K] static
    j_loc = (j_pad.reshape(K, q) - block_base[:, None]).astype(np.int32)
    w_max = int(j_loc.max()) + 2                         # +1 wrap, +1 j+1
    # The last block's local span can reach past p_len-1 (its lanes are
    # padded repeats of the final output), and conversely block_base.max()
    # + w_max can fall SHORT of p_len when the widest local span occurs in
    # the last block — a negative pad width crashes at trace time
    # (observed for 48000->44101 and ~13% of coprime pairs at taps=128).
    y_pad_len = max(int(block_base.max()) + w_max, p_len)

    A, _ = farrow_matrix(coeffs, degree)
    filt = jnp.asarray(A[:, None, :])  # [d1, 1, taps] (OIH)

    j_loc_c = jnp.asarray(j_loc)
    if wide:
        s_c = jnp.asarray(s_pad.reshape(K, q).astype(np.uint32))
        M_u = jnp.uint32(M_)
    else:
        s_c = jnp.asarray(s_pad.reshape(K, q).astype(np.int32))
        M = jnp.int32(M_)

    def convolve(buffer, read_pos, pos, n_out):
        avail = valid_end - read_pos
        if wide:
            # pos = (pos_hi frames, pos_lo subframe numerator), both u32.
            # All residue arithmetic is exact mod-2^32: true values stay
            # below M < 2^32, and the single possible overflow in
            # pos_lo + s is detected by the wrapped result comparing
            # smaller (t < pos_lo).
            pos_hi, pos_lo = pos
            base = jnp.minimum(
                pos_hi, jnp.asarray(avail, jnp.uint32)
            ).astype(jnp.int32)
            t = pos_lo + s_c                              # [K, q] u32
            wrap_b = (t < pos_lo) | (t >= M_u)
            rem = jnp.where(wrap_b, t - M_u, t)
            wrap = wrap_b.astype(jnp.int32)
            frac = rem.astype(jnp.float32) / np.float32(M_)
        else:
            pos_num = pos
            base = pos_num // M
            r = pos_num - base * M
            base = jnp.minimum(base, avail)
            wrap = (r + s_c >= M).astype(jnp.int32)       # [K, q]
            frac = (r + s_c - M * wrap).astype(jnp.float32) / jnp.float32(M_)

        region = jax.lax.dynamic_slice(
            buffer, (0, read_pos + base), (C, region_len)
        )
        y = jax.lax.conv_general_dilated(
            region[:, None, :], filt, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [C, d1, p_len]
        y = jnp.pad(y, ((0, 0), (0, 0), (0, y_pad_len - p_len)))
        y_blk = jnp.stack(
            [
                jax.lax.slice_in_dim(y, int(b), int(b) + w_max, axis=2)
                for b in block_base
            ],
            axis=0,
        )  # [K, C, d1, w_max] — static slices, no gather

        u = 2.0 * frac - 1.0
        ts = [jnp.ones_like(u), u]
        for _ in range(d1 - 2):
            ts.append(2.0 * u * ts[-1] - ts[-2])
        v = jnp.stack(ts, axis=-1)                       # [K, q, d1]

        g = jnp.einsum(
            "kqd,kcdw->kcqw", v, y_blk,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        jl = j_loc_c + wrap
        mask = (
            jl[:, None, :, None]
            == jnp.arange(w_max, dtype=jnp.int32)[None, None, None, :]
        )
        out = jnp.sum(jnp.where(mask, g, 0.0), axis=3)   # [K, C, q]
        return jnp.transpose(out, (0, 2, 1)).reshape(K * q, C)[:N]

    return convolve


def _table_svd_basis(coeffs, tol: float = 1e-7):
    """Rank-r factorization of the phase table ``T ~= U @ A`` with
    ``max|T - U@A| < tol`` (f64 SVD; singular values folded into U so
    the basis filter rows A are orthonormal).  The table rows are
    samples of a smooth kernel, so the numerical rank at f32 accuracy
    is small (~16-24 for taps=64-128) — the factorization turns exact
    table-LERP into ``r`` basis responses + per-output 2-row takes of
    the tiny ``[1024, r]`` U."""
    T = np.asarray(coeffs, np.float64)
    Uf, s, Vt = np.linalg.svd(T, full_matrices=False)
    r = len(s)
    for cand in range(1, len(s) + 1):
        err = np.abs((Uf[:, :cand] * s[:cand]) @ Vt[:cand] - T).max()
        if err < tol:
            r = cand
            break
    return (Uf[:, :r] * s[:r]).astype(np.float32), Vt[:r].astype(np.float32)


def _convolve_lerp(config: FirConfig, coeffs):
    """General-rate path — TABLE-LERP SEMANTICS AT FARROW SPEED.

    The gather path (``_convolve_gather``) is the table-lerp ORACLE but
    materializes one input window per output (the slowest general path
    in bench.py, ``fir_gather``).  This
    path computes the same lerp semantics through the Farrow structure:
    factor the phase table ``T ~= U @ A`` (``_table_svd_basis``, max
    reconstruction error < 1e-7 — below the f32 convolution noise), and
    since the lerp commutes with both the window dot and the
    factorization,

        lerp(T[p1], T[p2], f) . win  =  (lerp(U[p1], U[p2], f) @ A) . win
                                     =  v_i . y[:, off_i]

    the per-output work is identical in shape to ``_convolve_farrow``
    (basis-response conv + blocked contraction + fused one-hot offset
    select) with ``r ~ 2x`` the Farrow d1 and the per-output combine
    coefficients read as TWO row-takes of the tiny ``[1024, r]`` U table
    (elementwise-cheap) instead of a Chebyshev recurrence.  Includes the
    reference's ``p2 = min(p1+1, 1023)`` clamp bin quirk — this is the
    fast path for users who want the reference's exact interpolation
    behavior, not the continuous kernel (reference semantics:
    src/resampler_fir.rs:556-565).  Not auto-chosen; int32-envelope
    ratios only (wide pairs use farrow)."""
    if config.wide:
        raise ValueError(
            "the lerp path supports int32-envelope ratios; wide u32 "
            "pairs use the farrow path"
        )
    L_ = config.ratio_num
    M_ = config.ratio_den
    taps = config.taps
    C = config.channels
    N = config.out_capacity
    valid_end = config.input_capacity
    q = farrow_block_size(L_, M_)
    P = config.phases

    i = np.arange(N, dtype=np.int64)
    j_np = ((i * L_) // M_).astype(np.int64)
    s_np = ((i * L_) % M_).astype(np.int64)
    j_max = int(j_np[-1])
    region_len = j_max + 2 + taps
    p_len = j_max + 3

    K = -(-N // q)
    n_pad = K * q
    j_pad = np.concatenate([j_np, np.full(n_pad - N, j_np[-1], np.int64)])
    s_pad = np.concatenate([s_np, np.zeros(n_pad - N, np.int64)])
    block_base = j_pad.reshape(K, q)[:, 0]
    j_loc = (j_pad.reshape(K, q) - block_base[:, None]).astype(np.int32)
    w_max = int(j_loc.max()) + 2
    y_pad_len = max(int(block_base.max()) + w_max, p_len)

    U, A = _table_svd_basis(coeffs)
    r_dim = A.shape[0]
    filt = jnp.asarray(A[:, None, :])  # [r, 1, taps] (OIH)
    U_c = jnp.asarray(U)               # [P, r]

    j_loc_c = jnp.asarray(j_loc)
    s_c = jnp.asarray(s_pad.reshape(K, q).astype(np.int32))
    M = jnp.int32(M_)

    def convolve(buffer, read_pos, pos_num, n_out):
        avail = valid_end - read_pos
        base = pos_num // M
        r = pos_num - base * M
        base = jnp.minimum(base, avail)
        wrap = (r + s_c >= M).astype(jnp.int32)           # [K, q]
        rem = r + s_c - M * wrap                          # [K, q] in [0, M)

        region = jax.lax.dynamic_slice(
            buffer, (0, read_pos + base), (C, region_len)
        )
        y = jax.lax.conv_general_dilated(
            region[:, None, :], filt, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [C, r, p_len]
        y = jnp.pad(y, ((0, 0), (0, 0), (0, y_pad_len - p_len)))
        y_blk = jnp.stack(
            [
                jax.lax.slice_in_dim(y, int(b), int(b) + w_max, axis=2)
                for b in block_base
            ],
            axis=0,
        )  # [K, C, r, w_max] — static slices, no gather

        # exact table-lerp combine: pf = rem * P in [0, M*P); the int32
        # envelope guarantees rem * 1024 < 2^31 (M <= MAX_REDUCED_RATE)
        pf = rem * jnp.int32(P)
        p1 = pf // M                                      # [K, q]
        p2 = jnp.minimum(p1 + 1, jnp.int32(P - 1))        # reference clamp
        fp = (pf - p1 * M).astype(jnp.float32) / jnp.float32(M_)
        u1 = jnp.take(U_c, p1, axis=0)                    # [K, q, r]
        u2 = jnp.take(U_c, p2, axis=0)
        v = u1 + fp[:, :, None] * (u2 - u1)               # [K, q, r]

        g = jnp.einsum(
            "kqd,kcdw->kcqw", v, y_blk,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        jl = j_loc_c + wrap
        mask = (
            jl[:, None, :, None]
            == jnp.arange(w_max, dtype=jnp.int32)[None, None, None, :]
        )
        out = jnp.sum(jnp.where(mask, g, 0.0), axis=3)   # [K, C, q]
        return jnp.transpose(out, (0, 2, 1)).reshape(K * q, C)[:N]

    return convolve


#: Periodic-path limits: the banded kernel atlas is [2M, 2L + taps + 1]
#: and the contiguous span read must fit the buffer slack.  All
#: SampleRate-enum pairs reduce to M <= 640, L <= 640 (atlas <= ~3 MB).
MAX_PERIOD = 2048
MAX_PERIOD_L = 4000
MAX_ATLAS_BYTES = 32 << 20


def _use_im2col(L: int, taps: int) -> bool:
    """im2col pads the contraction to n_blk*L columns; worth it unless the
    padding exceeds ~50% extra FLOPs over the exact span (L >> taps)."""
    span = L + taps + 1
    n_blk = 1 + -(-(span - L) // L)
    return n_blk * L <= 1.5 * span and n_blk <= 256


def _convolve_periodic(config: FirConfig, coeffs):
    """Small-denominator fast path: **resampling as a strided convolution
    with a precomputed banded kernel atlas** — zero dynamic gathers.

    For ratio ``L/M`` in lowest terms the polyphase schedule is periodic
    with period ``M`` outputs per ``L`` inputs.  Writing output index
    ``i = k*M + j`` with chunk residue ``r = pos_num mod M``:
    ``offset_i = d_min + k*L + d_j`` where ``d_j = (r + j*L)//M <= L``, so
    every period-``k`` block reads a contiguous input segment and

        out[k*M + j, c] = sum_s A(r)[j, s] * region[c, k*L + s]

    — a stride-``L`` cross-correlation (one ``lax.conv``) with the
    banded kernel matrix ``A(r)[j, s] = W[rem_j][s - d_j]``, ``W[rho]``
    being the blended phase row for residue ``rho`` (identical arithmetic
    to the reference kernels, reference: src/resampler_fir.rs:542-590,
    src/fir/avx.rs:14-61).

    The crucial trick: because ``gcd(L, M) = 1``, residue ``r`` equals the
    canonical phase ``i0 = r * L^{-1} mod M`` of the infinite periodic
    schedule, so ``A(r)`` is a CONTIGUOUS ``[M, span]`` window — rows
    ``i0..i0+M``, columns ``(i0*L)//M..+span`` — of one static doubled
    master matrix ``A2[i, s] = W[(i*L)%M][s - (i*L)//M]`` of shape
    ``[2M, 2L+taps+1]`` precomputed at trace time.  Per chunk the banding
    is ONE ``dynamic_slice`` (a dynamic-index gather would run at
    element granularity).
    """
    L = config.ratio_num
    M = config.ratio_den
    taps = config.taps
    C = config.channels
    span = L + taps + 1
    K = -(-config.out_capacity // M)  # period blocks per call

    # --- static banded kernel atlas (numpy, trace time) ---
    table = np.asarray(coeffs, np.float32)
    rho = np.arange(M, dtype=np.int64)
    pf = rho * config.phases
    p1 = pf // M
    p2 = np.minimum(p1 + 1, config.phases - 1)
    frac = ((pf - p1 * M) / M).astype(np.float32)[:, None]
    w_resid = (1.0 - frac) * table[p1] + frac * table[p2]  # [M, taps]

    i = np.arange(2 * M, dtype=np.int64)
    row_resid = (i * L) % M
    row_off = (i * L) // M  # in [0, 2L)
    a2 = np.zeros((2 * M, 2 * L + taps + 1), np.float32)
    for ii in range(2 * M):
        a2[ii, row_off[ii] : row_off[ii] + taps] = w_resid[row_resid[ii]]
    a2 = jnp.asarray(a2)
    l_inv = pow(L, -1, M) if M > 1 else 0

    def convolve(buffer, read_pos, pos_num, n_out):
        d_min = pos_num // jnp.int32(M)
        r = pos_num - d_min * jnp.int32(M)
        i0 = (r * jnp.int32(l_inv)) % jnp.int32(M)
        c0 = (i0 * jnp.int32(L)) // jnp.int32(M)
        a = jax.lax.dynamic_slice(a2, (i0, c0), (M, span))  # banded kernels

        base = read_pos + d_min

        # ONE contiguous dynamic slice for the whole span (per-block
        # dynamic slices would lower to an element-granularity gather),
        # then the block structure
        #   out[k*M + j, c] = sum_s A[j, s] * region[c, k*L + s]
        # runs either as an explicit im2col matmul — the
        # overlapping stride-L windows decompose into n_blk shifted views
        # of the NON-overlapping [K, L] block reshape (pure relayout, no
        # gather) — or, when the L-block padding would waste FLOPs
        # (L >> taps), as a stride-L lax.conv.
        if _use_im2col(L, taps):
            n_blk = 1 + -(-(span - L) // L)
            s_len = n_blk * L
            region = jax.lax.dynamic_slice(
                buffer, (0, base), (C, (K + n_blk) * L)
            )
            blocks = region.reshape(C, K + n_blk, L)
            segs = jnp.concatenate(
                [blocks[:, b : b + K, :] for b in range(n_blk)], axis=2
            )  # [C, K, n_blk*L]
            a_pad = jnp.pad(a, ((0, 0), (0, s_len - span)))
            out = jnp.einsum(
                "js,cks->kjc", a_pad, segs, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST
            )  # [K, M, C]
        else:
            region = jax.lax.dynamic_slice(
                buffer, (0, base), (C, (K - 1) * L + span)
            )
            out = jax.lax.conv_general_dilated(
                region[:, None, :],        # [C, 1, total]   (N, C_in, W)
                a[:, None, :],             # [M, 1, span]    (O, I, W)
                window_strides=(L,),
                padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"),
                preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
            )  # [C, M, K]
            out = jnp.transpose(out, (2, 1, 0))  # [K, M, C]
        return out.reshape(K * M, C)[: config.out_capacity]

    return convolve


def resolve_convolve_path(config: FirConfig, path: str = "auto") -> str:
    """Pick the convolution strategy: the periodic banded matmul whenever
    the schedule period fits on chip; the Farrow polynomial path for
    every other ratio (its block size adapts to the ratio, see
    ``farrow_block_size``, so heavy coprime downsampling stays on the
    production structure).  ``path="gather"`` selects the
    table-lerp-exact general path explicitly — it is never auto-chosen."""
    if path != "auto":
        return path
    atlas_bytes = 8 * config.ratio_den * (2 * config.ratio_num + config.taps + 1)
    if (
        config.ratio_den <= MAX_PERIOD
        and config.ratio_num <= MAX_PERIOD_L
        and atlas_bytes <= MAX_ATLAS_BYTES
    ):
        return "periodic"
    return "farrow"


def _make_wide_step(config: FirConfig, _convolve):
    """Chunk step for ratios beyond the int32 envelope: any nonzero u32
    rate pair (reference: src/resampler_fir.rs:295-330 accepts any pair
    via an f64 position; v0.5.1 CHANGELOG #36 fixed exactly this overflow
    class).  Here the position stays EXACT: ``pos = pos_hi + pos_lo/M``
    input frames with both words uint32 (device int64 would require
    forcing jax_enable_x64 on library users).

    The closed-form ``_compute_n_out`` would overflow, so emission is a
    per-lane mask from static int64 split tables: lane ``i`` emits iff
    ``pos_hi + j_i + wrap_i + taps <= avail`` with ``j_i = (i*L)//M``
    clamped at the buffer edge (an unemittable lane's clamp is
    unobservable).  Consumption looks up the stride ``n_out*L`` in static
    ``(hi, lo)`` tables.  Single documented inexactness: for reduced
    ratios in the band ``L//M > 2^32 - 8195`` (downsampling by over
    ~4.29 billion with M small) the saturating uint32 add may under-skip
    by <= 8194 frames per output — ~2 ppm of such a stride; every other
    u32 pair is scheduled exactly, which the reference's f64 position
    cannot claim (it rounds once ``pos`` exceeds 2^53/M)."""
    L, M = config.ratio_num, config.ratio_den
    C = config.channels
    cap = config.input_capacity
    taps = config.taps
    N = config.out_capacity
    valid_end = config.input_capacity

    i = np.arange(N, dtype=np.int64)
    j_lane = np.minimum((i * L) // M, cap + 2).astype(np.uint32)
    s_lane = ((i * L) % M).astype(np.uint32)
    n = np.arange(N + 1, dtype=np.int64)
    nl_hi = np.minimum((n * L) // M, (1 << 32) - 1).astype(np.uint32)
    nl_lo = ((n * L) % M).astype(np.uint32)

    j_lane_c = jnp.asarray(j_lane)
    s_lane_c = jnp.asarray(s_lane)
    nl_hi_c = jnp.asarray(nl_hi)
    nl_lo_c = jnp.asarray(nl_lo)
    M_u = jnp.uint32(M)
    taps_u = jnp.uint32(taps)
    u32_max = jnp.uint32((1 << 32) - 1)

    def step(state: FirState, chunk, n_valid, out_budget):
        chunk = chunk.astype(jnp.float32)
        n_in = chunk.shape[0]
        assert n_in <= config.input_capacity and chunk.shape[1] == C
        n_valid = jnp.minimum(jnp.asarray(n_valid, jnp.int32), n_in)
        out_budget = jnp.asarray(out_budget, jnp.int32)

        buffer = state["buffer"]
        avail = state["available_frames"]
        pos_hi = state["pos_hi"]
        pos_lo = state["pos_lo"]

        # ---- copy-in (same end-aligned layout as the narrow step) ----
        to_copy = jnp.minimum(n_valid, valid_end - avail)
        mask = jnp.arange(n_in, dtype=jnp.int32) < to_copy
        chunk_masked = jnp.where(mask[None, :], chunk.T, 0.0)
        conc = jnp.concatenate([buffer[:, :valid_end], chunk_masked], axis=1)
        valid_part = jax.lax.dynamic_slice(
            conc, (0, to_copy), (C, valid_end)
        )
        buffer = jnp.concatenate(
            [valid_part, jnp.zeros((C, config.read_slack), jnp.float32)],
            axis=1,
        )
        avail = avail + to_copy

        # ---- emission-mask schedule ----
        avail_u = jnp.asarray(avail, jnp.uint32)
        t = pos_lo + s_lane_c
        wrap = ((t < pos_lo) | (t >= M_u)).astype(jnp.uint32)
        o1 = pos_hi + j_lane_c
        o2 = o1 + wrap + taps_u
        emit = (o1 >= pos_hi) & (o2 >= o1) & (o2 <= avail_u)
        n_out = jnp.minimum(
            jnp.sum(emit.astype(jnp.int32)), out_budget
        ).astype(jnp.int32)

        # ---- convolution (wide farrow) ----
        read_pos = jnp.int32(valid_end) - avail
        out = _convolve(buffer, read_pos, (pos_hi, pos_lo), n_out)
        lane = jnp.arange(config.out_capacity, dtype=jnp.int32)
        out = jnp.where((lane < n_out)[:, None], out, 0.0)

        # ---- consume via static stride tables ----
        d_hi = jnp.take(nl_hi_c, n_out)
        d_lo = jnp.take(nl_lo_c, n_out)
        t2 = pos_lo + d_lo
        carry = (t2 < pos_lo) | (t2 >= M_u)
        lo_after = jnp.where(carry, t2 - M_u, t2)
        hi_raw = pos_hi + d_hi + carry.astype(jnp.uint32)
        hi_after = jnp.where(hi_raw < pos_hi, u32_max, hi_raw)  # saturate
        consumed_u = jnp.minimum(hi_after, avail_u)
        consumed = consumed_u.astype(jnp.int32)
        avail = avail - consumed
        pos_hi_new = hi_after - consumed_u

        new_state = FirState(
            buffer=buffer,
            available_frames=avail,
            pos_hi=pos_hi_new,
            pos_lo=lo_after,
        )
        return new_state, out, to_copy, n_out

    return step


def make_fir_step(config: FirConfig, coeffs: np.ndarray, *, path: str = "auto"):
    """Build the pure chunk-step function for ``config``.

    ``step(state, chunk_frames [n, C] f32, n_valid, out_budget) ->
    (state', out_frames [out_capacity, C] f32, consumed, produced)``
    with frames counted per channel.  Jit-compatible; shapes static per
    input bucket.  ``path``: "auto" | "periodic" | "farrow" | "lerp" |
    "gather" — "auto" resolves to farrow (continuous-kernel semantics)
    for most coprime ratios; "lerp" runs the reference's table-lerp
    interpolation semantics through the farrow structure (SVD-factorized
    table — a semantics tier, the per-output U-row
    takes are gathers the table-exact contract cannot avoid); "gather"
    is the table-lerp oracle (slow, exact by construction); see
    ``resolve_convolve_path``.
    """
    coeffs = jnp.asarray(coeffs, jnp.float32)
    assert coeffs.shape == (config.phases, config.taps)
    C = config.channels

    valid_end = config.input_capacity
    path = resolve_convolve_path(config, path)
    if config.wide and path != "farrow":
        raise ValueError(
            f"ratios beyond the int32 schedule envelope use the farrow "
            f"path (wide uint32 scheduling), not {path!r}"
        )
    if path == "periodic":
        _convolve = _convolve_periodic(config, coeffs)
    elif path == "farrow":
        _convolve = _convolve_farrow(config, coeffs)
    elif path == "lerp":
        _convolve = _convolve_lerp(config, coeffs)
    elif path == "gather":
        _convolve = _convolve_gather(config, coeffs)
    else:
        raise ValueError(f"unknown convolve path {path!r}")
    if config.wide:
        return _make_wide_step(config, _convolve)

    def step(state: FirState, chunk, n_valid, out_budget):
        chunk = chunk.astype(jnp.float32)
        n_in = chunk.shape[0]
        assert n_in <= config.input_capacity and chunk.shape[1] == C
        n_valid = jnp.minimum(jnp.asarray(n_valid, jnp.int32), n_in)
        out_budget = jnp.asarray(out_budget, jnp.int32)

        buffer = state["buffer"]
        avail = state["available_frames"]
        pos_num = state["pos_num"]

        # ---- copy-in (reference: src/resampler_fir.rs:524-538) ----
        # End-aligned layout: valid data always ends at column VALID_END,
        # so appending = mask the chunk, concat at the STATIC seam, and
        # take one contiguous window ending at the new valid end.  This
        # replaces a per-stream dynamic-offset write (a batched scatter
        # under vmap) AND the reference's compaction memmove: consuming
        # oldest frames just shrinks the valid region from the left.
        to_copy = jnp.minimum(n_valid, valid_end - avail)
        mask = jnp.arange(n_in, dtype=jnp.int32) < to_copy
        chunk_masked = jnp.where(mask[None, :], chunk.T, 0.0)
        # slide only the valid window; the slack tail is constant zeros, so
        # it is appended statically instead of being concatenated and then
        # re-sliced (saves ~1/3 of the per-step copy traffic)
        conc = jnp.concatenate([buffer[:, :valid_end], chunk_masked], axis=1)
        valid_part = jax.lax.dynamic_slice(
            conc, (0, to_copy), (C, valid_end)
        )
        buffer = jnp.concatenate(
            [valid_part, jnp.zeros((C, config.read_slack), jnp.float32)],
            axis=1,
        )
        avail = avail + to_copy

        # ---- schedule (reference hot loop: src/resampler_fir.rs:542-565) ----
        n_out = _compute_n_out(config, pos_num, avail, out_budget)

        # ---- polyphase convolution ----
        read_pos = jnp.int32(valid_end) - avail  # start of valid region
        out = _convolve(buffer, read_pos, pos_num, n_out)  # [out_capacity, C]
        lane = jnp.arange(config.out_capacity, dtype=jnp.int32)
        out = jnp.where((lane < n_out)[:, None], out, 0.0)

        # ---- consume (reference: src/resampler_fir.rs:592-615; here
        # consumption shrinks the valid region in place, no memmove) ----
        pos_after = pos_num + n_out * jnp.int32(config.ratio_num)
        consumed = jnp.minimum(pos_after // jnp.int32(config.ratio_den), avail)
        avail = avail - consumed
        pos_num = pos_after - consumed * jnp.int32(config.ratio_den)

        new_state = FirState(
            buffer=buffer,
            available_frames=avail,
            pos_num=pos_num,
        )
        return new_state, out, to_copy, n_out

    return step


def _periodic_group_factor(L: int, M: int) -> int:
    """Group ``g`` schedule periods of the banded atlas into one
    UNREDUCED ``(gL, gM)`` atlas so the periodic contraction's fat dot
    has >= 128 output rows.

    For small-M families (unity / x2 / x4: reduced M in {1, 2, 4, ...})
    the per-period atlas matmul has only M output rows — a sliver no
    matrix unit fills.  Grouping is free at the schedule
    level: ``(i*gL) // (gM) == (i*L) // M`` exactly, and the f64 phase
    values ``(g*r)/(g*M)`` round identically to ``r/M``, so the grouped
    atlas rows are bit-identical to the reduced ones.  ``g`` also rounds
    up so ``g*L % 8 == 0`` (an 8-row-aligned block stride)."""
    if M >= 128:
        return 1
    g = -(-128 // M)
    align = 8 // math.gcd(L, 8)
    return -(-g // align) * align


# --------------------------------------------------------------------------
# Module split (round 5): the fleet step builders live in fir_fleets.py and
# the stateful wrapper in fir_wrapper.py.  Every name remains importable
# from this module; the indirection is lazy (PEP 562) so importing either
# submodule first cannot trip a circular import.
# --------------------------------------------------------------------------

_SPLIT_EXPORTS = {
    "make_fir_fleet_step_sync": "fir_fleets",
    "fir_fleet_init_sync": "fir_fleets",
    "_sync_atlas": "fir_fleets",
    "_farrow_tm_plan": "fir_fleets",
    "make_fir_fleet_step_sync_tm": "fir_fleets",
    "fir_fleet_init_sync_tm": "fir_fleets",
    "make_fir_fleet_step_async_tm": "fir_fleets",
    "fir_fleet_init_async_tm": "fir_fleets",
    "ResamplerFir": "fir_wrapper",
    "_BUCKETS": "fir_wrapper",
    "_bucket_for": "fir_wrapper",
}


def __getattr__(name: str):
    modname = _SPLIT_EXPORTS.get(name)
    if modname is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(
        importlib.import_module(f".{modname}", __package__), name
    )
