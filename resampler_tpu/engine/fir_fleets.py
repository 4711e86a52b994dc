"""Fleet (multi-stream) FIR step builders.

Three fleet shapes, all serving many streams from ONE device program
(SURVEY.md §2.9: the reference's "instance parallelism by construction"
— one resampler object per thread — becomes a batch axis here;
reference: src/resampler_fir.rs:509-621):

- ``make_fir_fleet_step_sync``: phase-locked fleet on the end-aligned
  slide buffer (``[B, C, alloc]``).
- ``make_fir_fleet_step_sync_tm``: phase-locked fleet on the TIME-MAJOR
  ring (``[ring, B*C]``) — the production phase-locked serving path (one
  KV-cache append + one fat fleet-wide contraction per step).
- ``make_fir_fleet_step_async_tm``: shared cadence, fully INDEPENDENT
  per-stream positions (the multi-tenant case) on the same ring.

Split out of ``engine/fir.py`` (which keeps the single-stream core:
config, coefficient tables, convolve paths, ``make_fir_step``); every
name here remains importable from ``engine.fir``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .fir import (
    FARROW_DEGREE,
    FirConfig,
    FirState,
    _compute_n_out,
    _periodic_group_factor,
    _table_svd_basis,
    _use_im2col,
    farrow_block_size,
    farrow_matrix,
    resolve_convolve_path,
)

__all__ = [
    "make_fir_fleet_step_sync",
    "fir_fleet_init_sync",
    "make_fir_fleet_step_sync_tm",
    "fir_fleet_init_sync_tm",
    "make_fir_fleet_step_async_tm",
    "fir_fleet_init_async_tm",
]

def make_fir_fleet_step_sync(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    channel_major: bool = False,
):
    """Synchronized-fleet step: ``n_streams`` streams in phase lockstep.

    Fleet serving commonly feeds every stream the same number of frames
    per step, so all streams share one phase state — the schedule scalars
    (``avail``, ``pos_num``, ``to_copy``, ``n_out``) become scalars for
    the whole fleet and every per-stream dynamic offset disappears.  The
    convolution then folds into ONE matmul over all streams and
    channels (``[M, s_len] @ [s_len, B*K*C]``), and the end-aligned
    re-window is one shared-offset dynamic slice over ``[B*C, ...]``.

    ``step(state, chunks [B, n, C], n_valid scalar) ->
    (state', out [B, out_cap, C], consumed, produced)``; state is
    ``{"buffer": [B, C, alloc], "available_frames": (), "pos_num": ()}``.

    Per-stream semantics are identical to ``make_fir_step`` (tested);
    streams with genuinely divergent feeds need the vmapped general step.
    """
    if resolve_convolve_path(config) != "periodic":
        raise ValueError(
            "synchronized fleet step requires the periodic convolve path"
        )
    L = config.ratio_num
    M = config.ratio_den
    taps = config.taps
    C = config.channels
    B = n_streams
    valid_end = config.input_capacity
    span = L + taps + 1
    K = -(-config.out_capacity // M)
    alloc = config.buffer_alloc
    out_cap = config.out_capacity

    # shared static atlas (same construction as _convolve_periodic)
    table = np.asarray(coeffs, np.float32)
    rho = np.arange(M, dtype=np.int64)
    pf = rho * config.phases
    p1 = pf // M
    p2 = np.minimum(p1 + 1, config.phases - 1)
    frac = ((pf - p1 * M) / M).astype(np.float32)[:, None]
    w_resid = (1.0 - frac) * table[p1] + frac * table[p2]
    i = np.arange(2 * M, dtype=np.int64)
    a2_np = np.zeros((2 * M, 2 * L + taps + 1), np.float32)
    for ii in range(2 * M):
        off = int((i[ii] * L) // M)
        a2_np[ii, off : off + taps] = w_resid[int((i[ii] * L) % M)]
    a2 = jnp.asarray(a2_np)
    l_inv = pow(L, -1, M) if M > 1 else 0

    use_im2col = _use_im2col(L, taps)
    if use_im2col:
        n_blk = 1 + -(-(span - L) // L)
        s_len = n_blk * L

    def step(state: FirState, chunks, n_valid):
        # channel_major=True takes [B, C, n] and skips the frames-major
        # transpose (a full-chunk relayout per step); frames-major
        # [B, n, C] matches the interleaved-audio convention.
        chunks = chunks.astype(jnp.float32)
        if channel_major:
            _, _, n_in = chunks.shape
            assert chunks.shape == (B, C, n_in)
        else:
            _, n_in, _ = chunks.shape
            assert chunks.shape == (B, n_in, C)
        assert n_in <= config.input_capacity
        n_valid = jnp.minimum(jnp.asarray(n_valid, jnp.int32), n_in)

        buffer = state["buffer"].reshape(B * C, alloc)
        avail = state["available_frames"]
        pos_num = state["pos_num"]

        # ---- copy-in, shared offset ----
        to_copy = jnp.minimum(n_valid, valid_end - avail)
        mask = jnp.arange(n_in, dtype=jnp.int32) < to_copy
        if channel_major:
            flat = chunks.reshape(B * C, n_in)
        else:
            flat = jnp.transpose(chunks, (0, 2, 1)).reshape(B * C, n_in)
        chunk_bc = jnp.where(mask[None, :], flat, 0.0)
        # see make_fir_step: slide only the valid window, static zero slack
        conc = jnp.concatenate([buffer[:, :valid_end], chunk_bc], axis=1)
        valid_part = jax.lax.dynamic_slice(
            conc, (0, to_copy), (B * C, valid_end)
        )
        buffer = jnp.concatenate(
            [valid_part, jnp.zeros((B * C, config.read_slack), jnp.float32)],
            axis=1,
        )
        avail = avail + to_copy

        # ---- shared schedule ----
        n_out = _compute_n_out(
            config, pos_num, avail, jnp.int32(config.out_capacity)
        )

        # ---- shared atlas window + ONE fleet-wide matmul ----
        d_min = pos_num // jnp.int32(M)
        r = pos_num - d_min * jnp.int32(M)
        i0 = (r * jnp.int32(l_inv)) % jnp.int32(M)
        c0 = (i0 * jnp.int32(L)) // jnp.int32(M)
        a = jax.lax.dynamic_slice(a2, (i0, c0), (M, span))

        read_pos = jnp.int32(valid_end) - avail
        base = read_pos + d_min
        if use_im2col:
            region = jax.lax.dynamic_slice(
                buffer, (0, base), (B * C, (K + n_blk) * L)
            )
            blocks = region.reshape(B * C, K + n_blk, L)
            segs = jnp.concatenate(
                [blocks[:, bb : bb + K, :] for bb in range(n_blk)], axis=2
            )  # [B*C, K, s_len]
            a_pad = jnp.pad(a, ((0, 0), (0, s_len - span)))
            out = jnp.einsum(
                "js,gks->gkj",
                a_pad,
                segs,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )  # [B*C, K, M]
        else:
            region = jax.lax.dynamic_slice(
                buffer, (0, base), (B * C, (K - 1) * L + span)
            )
            out = jax.lax.conv_general_dilated(
                region[:, None, :],
                a[:, None, :],
                window_strides=(L,),
                padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )  # [B*C, M, K]
            out = jnp.transpose(out, (0, 2, 1))  # [B*C, K, M]

        out = out.reshape(B, C, K * M)[:, :, :out_cap]
        out = jnp.transpose(out, (0, 2, 1))  # [B, out_cap, C]
        lane = jnp.arange(out_cap, dtype=jnp.int32)
        out = jnp.where((lane < n_out)[None, :, None], out, 0.0)

        # ---- shared consume ----
        pos_after = pos_num + n_out * jnp.int32(L)
        consumed = jnp.minimum(pos_after // jnp.int32(M), avail)
        avail = avail - consumed
        pos_num = pos_after - consumed * jnp.int32(M)

        new_state = FirState(
            buffer=buffer.reshape(B, C, alloc),
            available_frames=avail,
            pos_num=pos_num,
        )
        return new_state, out, to_copy, n_out

    return step


def fir_fleet_init_sync(config: FirConfig, n_streams: int) -> FirState:
    return FirState(
        buffer=jnp.zeros(
            (n_streams, config.channels, config.buffer_alloc), jnp.float32
        ),
        available_frames=jnp.zeros((), jnp.int32),
        pos_num=jnp.zeros((), jnp.int32),
    )

def _sync_atlas(config: FirConfig, coeffs) -> np.ndarray:
    """Doubled banded-kernel atlas shared by the sync step variants
    (same construction as ``_convolve_periodic``)."""
    L, M, taps = config.ratio_num, config.ratio_den, config.taps
    table = np.asarray(coeffs, np.float32)
    rho = np.arange(M, dtype=np.int64)
    pf = rho * config.phases
    p1 = pf // M
    p2 = np.minimum(p1 + 1, config.phases - 1)
    frac = ((pf - p1 * M) / M).astype(np.float32)[:, None]
    w_resid = (1.0 - frac) * table[p1] + frac * table[p2]
    i = np.arange(2 * M, dtype=np.int64)
    a2 = np.zeros((2 * M, 2 * L + taps + 1), np.float32)
    for ii in range(2 * M):
        off = int((i[ii] * L) // M)
        a2[ii, off : off + taps] = w_resid[int((i[ii] * L) % M)]
    return a2


def _farrow_tm_plan(config: FirConfig, coeffs, basis: str = "cheb"):
    """Static precompute for the synchronized-fleet Farrow contraction
    (see ``make_fir_fleet_step_sync_tm``): per-lane schedule splits,
    block geometry, and the positioning atlas ``Ashift2``.

    ``basis`` selects the per-output combine basis:

    - ``"cheb"`` (default): ``farrow_matrix`` Chebyshev rows — the
      continuous-kernel Farrow path.
    - ``"lerp"``: the SVD factorization ``T ~= U @ A`` of the 1024-phase
      table (``_table_svd_basis``, reconstruction < 1e-7), whose combine
      coefficients are the exact table-LERP of ``U`` rows — the
      reference's interpolation semantics at fleet speed.  The rest of
      the structure (positioning matmul, blocked contraction) is
      basis-agnostic and unchanged (reference semantics:
      src/resampler_fir.rs:556-565).

    The formulation: with the fleet-shared residue ``r`` known only at
    runtime, output ``i = k*q + l`` needs the blended tap row evaluated
    at its phase ``u_i`` and placed at its local offset ``jl_i``.  Both
    fold into ONE shared matmul:

        Ablk[i, s] = sum_{d, j} P[i, (d, j)] * Ashift2[(d, j), s],
        P[i, (d, j)] = T_d(u_i) * [jl_i == j],
        Ashift2[(d, j), s] = A[d, s - j]     (static),

    i.e. the per-output banded weight rows are built by one
    ``[N, d1*n_jl] @ [d1*n_jl, w_blk]`` matmul SHARED across every
    stream and channel — the per-stream Farrow path pays its basis conv
    per stream; here the whole fleet pays the weights once, then one
    blocked contraction ``[K](q, w_blk) x (w_blk, B*C)`` does the minimal
    ``~taps`` MACs per output sample."""
    L_, M_, taps = config.ratio_num, config.ratio_den, config.taps
    N = config.out_capacity
    if basis == "lerp":
        U, A = _table_svd_basis(coeffs)  # [P, r], [r, taps]
        d1 = A.shape[0]
    else:
        U = None
        A, _ = farrow_matrix(coeffs, FARROW_DEGREE)  # [d1, taps]
        d1 = FARROW_DEGREE + 1
    q = farrow_block_size(L_, M_)
    K = -(-N // q)
    n_pad = K * q

    i = np.arange(N, dtype=np.int64)
    j_np = ((i * L_) // M_).astype(np.int64)
    s_np = ((i * L_) % M_).astype(np.int64)
    if config.wide:
        # same clamp as _convolve_farrow: lanes whose static row offset
        # exceeds the buffer can never be emitted (offset + taps <= avail
        # fails), so clamping keeps the region geometry bounded for any
        # u32 ratio while the masked lanes read harmless garbage
        j_np = np.minimum(j_np, config.input_capacity + 2)
    j_pad = np.concatenate([j_np, np.full(n_pad - N, j_np[-1], np.int64)])
    s_pad = np.concatenate([s_np, np.zeros(n_pad - N, np.int64)])
    block_base = j_pad.reshape(K, q)[:, 0]
    j_loc = (j_pad.reshape(K, q) - block_base[:, None]).astype(np.int32)
    n_jl = int(j_loc.max()) + 2  # +1 wrap carry
    w_blk = n_jl - 1 + taps

    ashift2 = np.zeros((d1 * n_jl, w_blk), np.float32)
    for d in range(d1):
        for j in range(n_jl):
            ashift2[d * n_jl + j, j : j + taps] = A[d]
    region_rows = int(block_base.max()) + w_blk
    return dict(
        q=q, K=K, n_pad=n_pad, d1=d1, n_jl=n_jl, w_blk=w_blk,
        block_base=block_base.astype(np.int64),
        j_loc=j_loc, s_pad=s_pad.reshape(K, q),
        ashift2=ashift2, region_rows=region_rows, U=U,
    )


def make_fir_fleet_step_sync_tm(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    path: str = "auto",
    out_layout: str = "bm",
):
    """TIME-MAJOR synchronized-fleet step — the production phase-locked
    serving path.

    Layout is the whole trick: the stream buffer is ``[ring, B*C]`` with
    frames on the MAJOR axis and (stream, channel) on lanes.  Then:

    - append = ONE shared-offset ``dynamic_update_slice`` at a MAJOR-axis
      offset — the KV-cache pattern XLA updates in place (the same DUS
      on a frames-minor layout would copy the whole buffer per step).
    - consume = advance a ``start`` scalar; a ``lax.cond`` compacts the
      window to the front every ~``horizon`` steps (one contiguous copy,
      amortized; cond executes one branch at top level).
    - the convolution is fleet-wide: for periodic ratios the banded-atlas
      contraction is ONE fat matmul ``[M, s_len] x [s_len, K*B*C]``; for
      arbitrary coprime ratios the Farrow positioning matmul builds the
      per-output banded weights once for the whole fleet, then a blocked
      batched matmul does ``~taps`` MACs per output (``_farrow_tm_plan``).
      ``path="lerp"`` runs the SAME structure with the SVD table basis —
      the reference's exact table-lerp interpolation semantics (incl. the
      phase-1023 clamp) at fleet speed: only the combine-basis rows
      change (lerped ``U`` rows instead of a Chebyshev recurrence), so
      the contraction cost is identical when the SVD rank equals the
      Farrow degree+1 (it does at taps<=128, tol 1e-7).

    Every product runs at ``Precision.HIGHEST`` (full float32, never a
    single TF32 pass).  Under a mesh, place the state with
    ``shard_lanes`` and GSPMD partitions the lane-parallel step.

    ``step(state, chunks_tm [n<=max_chunk, B*C], n_valid) ->
    (state', out [B, out_cap, C], consumed, produced)``.  Feed layout is
    time-major (frame-synchronous interleaved fleets produce this
    naturally); per-stream semantics equal ``make_fir_step`` — the
    equivalence test runs 30+ steps across compactions bit-exact
    (periodic) / to the polynomial-evaluation floor (farrow).

    Stale data beyond ``fill`` is harmless: region reads overlapping it
    are multiplied by structural zeros of the banded atlas for active
    lanes, and inactive lanes are masked after the matmul.

    ``out_layout``: "bm" (default) returns ``[B, out_cap, C]``;
    "tm" skips the final batch-major relayout and returns the raw
    time-major ``[out_cap, B*C]`` block — for consumers that are
    themselves time-major (a chained fleet stage, a mixer bus) the
    transpose is a pure memory pass they never needed.
    """
    path = resolve_convolve_path(config, path)
    if path not in ("periodic", "farrow", "lerp"):
        raise ValueError(
            f"synchronized tm fleet step supports the periodic, farrow "
            f"and lerp convolve paths, not {path!r}"
        )
    wide = config.wide
    if wide and path != "farrow":
        raise ValueError(
            f"ratios beyond the int32 schedule envelope use the farrow "
            f"path (wide uint32 scheduling), not {path!r}"
        )
    if out_layout not in ("bm", "tm"):
        raise ValueError(
            f"out_layout must be 'bm' ([B, out_cap, C]) or 'tm' "
            f"(time-major [out_cap, B*C]), not {out_layout!r}"
        )
    L = config.ratio_num
    M = config.ratio_den
    taps = config.taps
    C = config.channels
    B = n_streams
    R = B * C
    cap = config.input_capacity
    out_cap = config.out_capacity
    slack = config.read_slack
    ring = -(-(cap + slack + horizon * max_chunk) // 256) * 256

    if path == "periodic":
        # Small-M families (unity/x2/x4) group g periods into one
        # unreduced (gL, gM) atlas so the fat dot has >= 128 output
        # rows — bit-identical schedule/atlas, see _periodic_group_factor.
        g = _periodic_group_factor(L, M)
        Lg, Mg = L * g, M * g
        span = Lg + taps + 1
        K = -(-config.out_capacity // Mg)
        # im2col unconditionally: in time-major the block decomposition is
        # a major-axis reshape + concat (cheap); the L >> taps padding
        # waste the frames-minor path avoids via lax.conv is bounded by
        # n_blk*L/span
        n_blk = 1 + -(-(span - Lg) // Lg)
        s_len = n_blk * Lg
        region_rows = (K + n_blk) * Lg
        a2 = jnp.asarray(
            _sync_atlas(
                dataclasses.replace(config, ratio_num=Lg, ratio_den=Mg),
                coeffs,
            )
            if g > 1
            else _sync_atlas(config, coeffs)
        )
        l_inv = pow(L, -1, M) if M > 1 else 0
    else:
        fp = _farrow_tm_plan(
            config, coeffs, basis="lerp" if path == "lerp" else "cheb"
        )
        U_c = jnp.asarray(fp["U"]) if path == "lerp" else None  # [P, r]
        region_rows = fp["region_rows"]
        j_loc_c = jnp.asarray(fp["j_loc"])  # [K, q]
        s_c = jnp.asarray(
            fp["s_pad"].astype(np.uint32 if wide else np.int32)
        )  # [K, q]
        ashift2_c = jnp.asarray(fp["ashift2"])  # [d1*n_jl, w_blk]
    assert region_rows <= slack, (region_rows, slack)

    if wide:
        # WIDE schedule (any nonzero u32 rate pair): the shared position
        # is (pos_hi frames, pos_lo subframe numerator), both uint32 —
        # same bookkeeping as _make_wide_step, shared fleet-wide.
        i_l = np.arange(out_cap, dtype=np.int64)
        j_lane_c = jnp.asarray(
            np.minimum((i_l * L) // M, cap + 2).astype(np.uint32)
        )
        s_lane_c = jnp.asarray(((i_l * L) % M).astype(np.uint32))
        n_l = np.arange(out_cap + 1, dtype=np.int64)
        nl_hi_c = jnp.asarray(
            np.minimum((n_l * L) // M, (1 << 32) - 1).astype(np.uint32)
        )
        nl_lo_c = jnp.asarray(((n_l * L) % M).astype(np.uint32))
        M_u = jnp.uint32(M)
        taps_u = jnp.uint32(taps)
        u32_max = jnp.uint32((1 << 32) - 1)

    def _contract_periodic(buffer, start, pos_num, avail):
        d_min = pos_num // jnp.int32(M)
        r = pos_num - d_min * jnp.int32(M)
        i0 = (r * jnp.int32(l_inv)) % jnp.int32(M)
        c0 = (i0 * jnp.int32(L)) // jnp.int32(M)
        a = jax.lax.dynamic_slice(a2, (i0, c0), (Mg, span))
        base = start + d_min
        a_pad = jnp.pad(a, ((0, 0), (0, s_len - span)))

        # ---- ONE fat fleet-wide matmul ----
        region = jax.lax.dynamic_slice(buffer, (base, 0), (region_rows, R))
        blocks = region.reshape(K + n_blk, Lg, R)  # major-axis split
        segs = jnp.concatenate(
            [blocks[bb : bb + K] for bb in range(n_blk)], axis=1
        )  # [K, s_len, R]
        out = jnp.einsum(
            "js,ksr->kjr",
            a_pad,
            segs,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [K, Mg, R]
        return out.reshape(K * Mg, R)[:out_cap]

    def _contract_farrow(buffer, start, pos, avail):
        q, Kf, n_pad_f = fp["q"], fp["K"], fp["n_pad"]
        n_jl, w_blk, d1 = fp["n_jl"], fp["w_blk"], fp["d1"]

        # shared schedule residues -> Chebyshev basis + local offsets
        if wide:
            # pos = (pos_hi frames, pos_lo subframe numerator), both u32;
            # residue arithmetic exact mod 2^32 (see _convolve_farrow)
            pos_hi, pos_lo = pos
            base = jnp.minimum(
                pos_hi, jnp.asarray(avail, jnp.uint32)
            ).astype(jnp.int32)
            t = pos_lo + s_c                              # [K, q] u32
            wrap_b = (t < pos_lo) | (t >= M_u)
            rem = jnp.where(wrap_b, t - M_u, t)
            wrap = wrap_b.astype(jnp.int32)
            frac = rem.astype(jnp.float32) / np.float32(M)
        else:
            Mi = jnp.int32(M)
            base = pos // Mi
            r = pos - base * Mi
            wrap = (r + s_c >= Mi).astype(jnp.int32)      # [K, q]
            rem_i = r + s_c - Mi * wrap                   # [K, q] in [0, M)
            frac = rem_i.astype(jnp.float32) / jnp.float32(M)
        if path == "lerp":
            # exact table-lerp combine basis: v = lerp(U[p1], U[p2], f),
            # incl. the reference's p2 = min(p1+1, 1023) clamp quirk
            # (src/resampler_fir.rs:556-565).  rem * P stays inside int32
            # (wide pairs are rejected above).  The U takes are [K*q]
            # rows of a tiny [1024, r] table, paid ONCE for the whole
            # fleet (the per-stream lerp path pays them per stream).
            pf = rem_i * jnp.int32(config.phases)
            p1 = pf // jnp.int32(M)
            p2 = jnp.minimum(p1 + 1, jnp.int32(config.phases - 1))
            fph = (pf - p1 * jnp.int32(M)).astype(jnp.float32) / jnp.float32(
                M
            )
            u1 = jnp.take(U_c, p1, axis=0)                # [K, q, d1]
            u2 = jnp.take(U_c, p2, axis=0)
            t_cheb = u1 + fph[:, :, None] * (u2 - u1)     # [K, q, d1]
        else:
            u = 2.0 * frac - 1.0
            ts = [jnp.ones_like(u), u]
            for _ in range(d1 - 2):
                ts.append(2.0 * u * ts[-1] - ts[-2])
            t_cheb = jnp.stack(ts, axis=-1)               # [K, q, d1]
        jl = j_loc_c + wrap                               # [K, q] in [0, n_jl)
        onehot = (
            jl[:, :, None] == jnp.arange(n_jl, dtype=jnp.int32)[None, None, :]
        ).astype(jnp.float32)                             # [K, q, n_jl]
        p_mat = (t_cheb[:, :, :, None] * onehot[:, :, None, :]).reshape(
            n_pad_f, d1 * n_jl
        )

        # ONE shared positioning matmul builds every output's banded
        # weight row, then a blocked batched matmul does ~taps MACs per
        # output sample across the whole fleet.
        a_blk = jnp.einsum(
            "np,pw->nw", p_mat, ashift2_c,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(Kf, q, w_blk)

        region = jax.lax.dynamic_slice(
            buffer, (start + base, 0), (region_rows, R)
        )
        region_blk = jnp.stack(
            [
                jax.lax.slice_in_dim(region, int(b), int(b) + w_blk, axis=0)
                for b in fp["block_base"]
            ],
            axis=0,
        )  # [K, w_blk, R] — static slices, no gather
        out = jnp.einsum(
            "kqw,kwr->kqr", a_blk, region_blk,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )  # [K, q, R]
        return out.reshape(n_pad_f, R)[:out_cap]

    _contract = _contract_periodic if path == "periodic" else _contract_farrow

    def step(state: FirState, chunks_tm, n_valid):
        chunks_tm = chunks_tm.astype(jnp.float32)
        n_in, _ = chunks_tm.shape
        assert chunks_tm.shape == (n_in, R) and n_in <= max_chunk
        n_valid = jnp.minimum(jnp.asarray(n_valid, jnp.int32), n_in)

        buffer = state["buffer"]
        start = state["start"]
        fill = state["fill"]
        pos = (
            (state["pos_hi"], state["pos_lo"]) if wide else state["pos_num"]
        )
        avail = fill - start

        # ---- append (in-place KV-cache DUS) ----
        to_copy = jnp.minimum(n_valid, cap - avail)
        mask = jnp.arange(n_in, dtype=jnp.int32) < to_copy
        chunk_masked = jnp.where(mask[:, None], chunks_tm, 0.0)
        buffer = jax.lax.dynamic_update_slice(
            buffer, chunk_masked, (fill, 0)
        )
        fill = fill + to_copy
        avail = avail + to_copy

        # ---- shared schedule ----
        if wide:
            # emission mask from static split tables (see _make_wide_step)
            pos_hi, pos_lo = pos
            avail_u = jnp.asarray(avail, jnp.uint32)
            t = pos_lo + s_lane_c
            wrap_l = ((t < pos_lo) | (t >= M_u)).astype(jnp.uint32)
            o1 = pos_hi + j_lane_c
            o2 = o1 + wrap_l + taps_u
            emit = (o1 >= pos_hi) & (o2 >= o1) & (o2 <= avail_u)
            n_out = jnp.minimum(
                jnp.sum(emit.astype(jnp.int32)), jnp.int32(out_cap)
            ).astype(jnp.int32)
        else:
            n_out = _compute_n_out(config, pos, avail, jnp.int32(out_cap))

        # ---- fleet-wide contraction ----
        out = _contract(buffer, start, pos, avail)  # [out_cap, R]
        lane = jnp.arange(out_cap, dtype=jnp.int32)
        out = jnp.where((lane < n_out)[:, None], out, 0.0)
        if out_layout == "bm":
            out = jnp.transpose(out.reshape(out_cap, B, C), (1, 0, 2))
        # out_layout == "tm": stay [out_cap, B*C] — the relayout to
        # batch-major is a real HBM pass at fleet scale, and a consumer
        # that is itself time-major (the next fleet stage, a mixer bus)
        # never needs it

        # ---- consume: advance start, no data movement ----
        if wide:
            # static (hi, lo) stride tables with wraparound-aware carries
            d_hi = jnp.take(nl_hi_c, n_out)
            d_lo = jnp.take(nl_lo_c, n_out)
            t2 = pos_lo + d_lo
            carry = (t2 < pos_lo) | (t2 >= M_u)
            lo_after = jnp.where(carry, t2 - M_u, t2)
            hi_raw = pos_hi + d_hi + carry.astype(jnp.uint32)
            hi_after = jnp.where(hi_raw < pos_hi, u32_max, hi_raw)  # sat
            consumed = jnp.minimum(
                hi_after, jnp.asarray(avail, jnp.uint32)
            ).astype(jnp.int32)
            start = start + consumed
            pos_state = dict(
                pos_hi=hi_after - jnp.asarray(consumed, jnp.uint32),
                pos_lo=lo_after,
            )
        else:
            pos_after = pos + n_out * jnp.int32(L)
            consumed = jnp.minimum(pos_after // jnp.int32(M), avail)
            start = start + consumed
            pos_state = dict(pos_num=pos_after - consumed * jnp.int32(M))

        # ---- amortized compaction ----
        def compact(args):
            buf, s, f = args
            ws = jnp.minimum(s, jnp.int32(ring - cap))
            win = jax.lax.dynamic_slice(buf, (ws, 0), (cap, R))
            buf2 = jnp.concatenate(
                [win, jnp.zeros((ring - cap, R), jnp.float32)], axis=0
            )
            return buf2, s - ws, f - ws

        buffer, start, fill = jax.lax.cond(
            fill + jnp.int32(max_chunk + slack) > jnp.int32(ring),
            compact,
            lambda args: args,
            (buffer, start, fill),
        )

        new_state = FirState(
            buffer=buffer, start=start, fill=fill, **pos_state
        )
        return new_state, out, to_copy, n_out

    return step


def fir_fleet_init_sync_tm(
    config: FirConfig, n_streams: int, *, max_chunk: int, horizon: int = 16
) -> FirState:
    ring = -(
        -(config.input_capacity + config.read_slack + horizon * max_chunk)
        // 256
    ) * 256
    state = FirState(
        buffer=jnp.zeros(
            (ring, n_streams * config.channels), jnp.float32
        ),
        start=jnp.zeros((), jnp.int32),
        fill=jnp.zeros((), jnp.int32),
    )
    if config.wide:
        state["pos_hi"] = jnp.zeros((), jnp.uint32)
        state["pos_lo"] = jnp.zeros((), jnp.uint32)
    else:
        state["pos_num"] = jnp.zeros((), jnp.int32)
    return state


def make_fir_fleet_step_async_tm(
    config: FirConfig,
    coeffs: np.ndarray,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    skew_periods: int = 1,
    out_layout: str = "bm",
    max_out: int | None = None,
):
    """TIME-MAJOR **asynchronous**-fleet step: streams share the rate pair
    and the chunk cadence but keep fully INDEPENDENT positions (per-stream
    start phases, drift/slew histories) — the multi-tenant serving shape
    between the phase-locked sync fleet and the general vmapped engine.

    Why it beats ``vmap(make_fir_step)`` (one program per stream): per
    stream, only two scalars diverge — the frame skew ``base_b`` and the
    subframe residue ``r_b``.  The step therefore

    1. keeps ONE shared ``[ring, B*C]`` buffer (same KV-cache append and
       scalar consume as the sync tm fleet — per-stream consumption is
       decomposed into a shared scalar plus a bounded per-stream residual
       folded back into ``pos``),
    2. runs ONE fleet-wide Farrow basis-response convolution
       ``y[p, d, lane] = (A_d \\* buffer)[p]``, evaluated as a banded-
       atlas einsum over static block slices — the same one-fat-matmul
       structure as the periodic contraction (the banded form trades
       ~2x FLOPs for large dense dots),
    3. resolves the per-stream schedule WITHOUT gathers: output ``i`` of
       stream ``b`` needs ``sum_d T_d(u_i^b) * y[j_i + shift_i^b, d]``
       where ``j_i`` is the STATIC shared offset table and
       ``shift_i^b = base_b + wrap_i^b``.  The per-stream frame skew
       ``base_b`` is rolled into the REGION read (a ``skew_periods +
       1``-way select over the small ``[region_rows, R]`` slice — cheap),
       so the combine selects on the single wrap bit only: TWO static
       row-takes of ``y`` fused with the Chebyshev combine in one
       expression, no materialized per-shift candidates.

    ``max_out`` (optional) bounds the static output lanes per step below
    ``config.out_capacity``: a serving loop feeding ``chunk`` frames per
    step never produces more than ``~chunk * M/L + 1`` frames per step in
    steady state, so sizing the schedule tables to that (instead of the
    full input-capacity worst case) cuts every per-lane intermediate
    proportionally.  Production beyond ``max_out`` is deferred, never
    dropped (the buffer backpressures exactly like a small feed).

    Positions are exact int32 rationals as everywhere else; outputs equal
    the per-stream farrow engine's to the polynomial-evaluation floor
    (differentially tested across compactions).

    **Skew invariant**: ``max(pos) - min(pos) < skew_periods * M`` must
    hold at every step (positions are in subframe units of ``1/M``; one
    period = one input frame).  ``fir_fleet_init_async_tm`` enforces it at
    init; feeding is shared, and the step preserves the spread exactly, so
    only external position edits (slew) can widen it.  Streams needing
    larger mutual skew belong on the vmapped engine.

    Unequal RATE PAIRS cannot share a schedule at all — serve those as one
    fleet per reduced ratio (the planner analog of bucketing by shape);
    each fleet step is one dispatch, so a handful of ratio groups costs a
    handful of dispatches, not a per-stream loop.

    MULTI-DEVICE: the step is pure XLA (the contraction is an einsum), so
    it needs no mesh parameter — place the state with ``shard_lanes``
    (ring lanes + per-stream positions sharded over the stream axis) and
    GSPMD partitions everything; the fleet-min/max schedule reductions
    (``max(pos)``/``min(pos)``/``min(pos_after)``) lower to scalar
    all-reduces.  Every product runs at ``Precision.HIGHEST``.
    Differentially tested vs the unmeshed step on the 8-device CPU mesh
    (test_async_fleet.py).

    WIDE pairs (beyond the int32 schedule envelope) are supported with the
    same structure: per-stream positions carried as ``(pos_hi, pos_lo)``
    uint32 pairs (exact frames + subframe numerator, as in
    ``_make_wide_step``), residue arithmetic exact mod 2^32, and the
    fleet-min emission count taken from the lexicographic-laggard stream's
    static emission mask.

    ``step(state, chunks_tm [n<=max_chunk, B*C], n_valid) ->
    (state', out, consumed, produced)``; ``out`` is ``[B, out_cap, C]``
    ("bm", default) or time-major ``[out_cap, B*C]`` ("tm").  All streams
    produce the same ``produced`` count per step (the fleet-min schedule);
    a stream ahead of the pack defers — never drops — outputs, bounded by
    the skew invariant.  (reference per-stream generality:
    src/resampler_fir.rs:542-590.)
    """
    if out_layout not in ("bm", "tm"):
        raise ValueError(
            f"out_layout must be 'bm' ([B, out_cap, C]) or 'tm' "
            f"(time-major [out_cap, B*C]), not {out_layout!r}"
        )
    if skew_periods < 1:
        raise ValueError("skew_periods must be >= 1")
    L_, M_ = config.ratio_num, config.ratio_den
    taps = config.taps
    C = config.channels
    B = n_streams
    R = B * C
    cap = config.input_capacity
    out_cap = config.out_capacity
    if max_out is not None:
        out_cap = min(out_cap, max(int(max_out), 1))
    slack = config.read_slack
    ring = -(-(cap + slack + horizon * max_chunk) // 256) * 256
    degree = FARROW_DEGREE
    d1 = degree + 1
    wide = config.wide

    i = np.arange(out_cap, dtype=np.int64)
    j_i64 = (i * L_) // M_
    if wide:
        # lanes whose static row offset exceeds the buffer can never be
        # emitted (the emission mask caps n_out first); clamping keeps the
        # take/region geometry bounded for any u32 ratio while the masked
        # lanes read harmless rows (see _convolve_farrow's wide clamp)
        j_i64 = np.minimum(j_i64, cap + 2)
    j_np = j_i64.astype(np.int32)
    s_np = ((i * L_) % M_).astype(np.uint32 if wide else np.int32)
    j_max = int(j_np[-1])
    p_len = j_max + 2  # takes reach j_max + 1 (the wrap row)

    # Banded basis atlas: y[k*Lb + p, d, r] = sum_t A[d, t] * region[
    # k*Lb + p + t, r] as ONE einsum [Lb*d1, s_len] x [Kc, s_len, R].
    Lb = 64
    Kc = -(-p_len // Lb)
    p_pad = Kc * Lb
    s_len_c = Lb + taps - 1
    region_rows = p_pad + taps - 1
    # the region read is widened by skew_periods rows so the per-stream
    # frame skew can be rolled into it (same total reach as the old
    # p_len = j_max + skew_periods + 2 take geometry)
    assert region_rows + skew_periods <= slack, (region_rows, slack)

    A, _ = farrow_matrix(coeffs, degree)
    ab = np.zeros((Lb * d1, s_len_c), np.float32)
    for p in range(Lb):
        ab[p * d1 : (p + 1) * d1, p : p + taps] = A
    ab_c = jnp.asarray(ab)
    j_c = jnp.asarray(j_np)
    s_c = jnp.asarray(s_np)

    if wide:
        # WIDE emission/consume tables — same bookkeeping as the sync tm
        # fleet's wide branch, but evaluated at the lexicographic-laggard
        # stream (fleet-min schedule) and with per-stream carries.
        j_lane_c = jnp.asarray(
            np.minimum(j_i64, cap + 2).astype(np.uint32)
        )
        n_l = np.arange(out_cap + 1, dtype=np.int64)
        nl_hi_c = jnp.asarray(
            np.minimum((n_l * L_) // M_, (1 << 32) - 1).astype(np.uint32)
        )
        nl_lo_c = jnp.asarray(((n_l * L_) % M_).astype(np.uint32))
        M_u = jnp.uint32(M_)
        taps_u = jnp.uint32(taps)
        u32_max = jnp.uint32((1 << 32) - 1)
    else:
        L = jnp.int32(L_)
        M = jnp.int32(M_)

    def step(state: FirState, chunks_tm, n_valid):
        chunks_tm = chunks_tm.astype(jnp.float32)
        n_in, _ = chunks_tm.shape
        assert chunks_tm.shape == (n_in, R) and n_in <= max_chunk
        n_valid = jnp.minimum(jnp.asarray(n_valid, jnp.int32), n_in)

        buffer = state["buffer"]
        start = state["start"]
        fill = state["fill"]
        if wide:
            pos_hi = state["pos_hi"]  # [B] uint32 frames, per-stream
            pos_lo = state["pos_lo"]  # [B] uint32 subframe numerator
        else:
            pos = state["pos_num"]  # [B] int32, per-stream
        avail = fill - start

        # ---- append (in-place KV-cache DUS, same as the sync fleet) ----
        to_copy = jnp.minimum(n_valid, cap - avail)
        mask = jnp.arange(n_in, dtype=jnp.int32) < to_copy
        chunk_masked = jnp.where(mask[:, None], chunks_tm, 0.0)
        buffer = jax.lax.dynamic_update_slice(buffer, chunk_masked, (fill, 0))
        fill = fill + to_copy
        avail = avail + to_copy

        if wide:
            # ---- fleet-min schedule: lexicographic-laggard emission ----
            avail_u = jnp.asarray(avail, jnp.uint32)
            mx_hi = jnp.max(pos_hi)
            mx_lo = jnp.max(jnp.where(pos_hi == mx_hi, pos_lo, 0))
            t_l = mx_lo + s_c                       # [N] u32
            wrap_l = ((t_l < mx_lo) | (t_l >= M_u)).astype(jnp.uint32)
            o1 = mx_hi + j_lane_c
            o2 = o1 + wrap_l + taps_u
            emit = (o1 >= mx_hi) & (o2 >= o1) & (o2 <= avail_u)
            n_out = jnp.minimum(
                jnp.sum(emit.astype(jnp.int32)), jnp.int32(out_cap)
            ).astype(jnp.int32)

            # ---- per-stream residues, exact mod-2^32 (no gathers) ----
            b0_u = jnp.minimum(jnp.min(pos_hi), avail_u)
            b0 = b0_u.astype(jnp.int32)             # shared frame skew
            base_rel = (pos_hi - b0_u).astype(jnp.int32)  # [B]
            t = pos_lo[:, None] + s_c[None, :]      # [B, N] u32
            wrap_b = (t < pos_lo[:, None]) | (t >= M_u)
            rem = jnp.where(wrap_b, t - M_u, t)
            frac = rem.astype(jnp.float32) / np.float32(M_)
        else:
            # ---- fleet-min schedule: the laggard (max pos) bounds ----
            n_out = _compute_n_out(
                config, jnp.max(pos), avail, jnp.int32(out_cap)
            )

            # ---- per-stream schedule residues (no gathers anywhere) ----
            b0 = jnp.minimum(jnp.min(pos) // M, avail)  # shared frame skew
            rel = pos - b0 * M
            base_rel = rel // M                     # [B], in [0, skew]
            r = rel - base_rel * M                  # [B], in [0, M)
            wrap_b = r[:, None] + s_c[None, :] >= M  # [B, N] bool
            frac = (
                r[:, None] + s_c[None, :]
                - M * wrap_b.astype(jnp.int32)
            ).astype(jnp.float32) / jnp.float32(M_)
        u = 2.0 * frac - 1.0
        ts = [jnp.ones_like(u), u]
        for _ in range(d1 - 2):
            ts.append(2.0 * u * ts[-1] - ts[-2])
        v = jnp.stack(ts, axis=-1)                  # [B, N, d1]

        # ---- region read with the per-stream frame skew rolled in --
        # base_rel is a per-STREAM constant (the step advances every
        # position by the same n_out*L), so it is absorbed here as a
        # (skew_periods+1)-way select over the SMALL region slice
        # instead of over the [N, d1, R] basis responses; when
        # starved states push base_rel past skew_periods the
        # fall-through rows are harmless — the laggard's n_out is 0
        # and every lane is masked
        reg = jax.lax.dynamic_slice(
            buffer, (start + b0, 0), (region_rows + skew_periods, R)
        )
        base_lane = jnp.repeat(base_rel, C)              # [R]
        region = jax.lax.slice_in_dim(reg, 0, region_rows, axis=0)
        for sk in range(1, skew_periods + 1):
            region = jnp.where(
                base_lane[None, :] == sk,
                jax.lax.slice_in_dim(
                    reg, sk, sk + region_rows, axis=0
                ),
                region,
            )

        # ---- ONE fleet-wide basis-response contraction (banded) ----
        segs = jnp.stack(
            [
                jax.lax.slice_in_dim(
                    region, k * Lb, k * Lb + s_len_c, axis=0
                )
                for k in range(Kc)
            ],
            axis=0,
        )  # [Kc, s_len_c, R] — static slices, no gather
        y = jnp.einsum(
            "qs,ksr->kqr", ab_c, segs,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(p_pad, d1, R)

        # ---- wrap-only takes + Chebyshev combine, one fused expr ----
        vs = jnp.transpose(v, (1, 2, 0))[:, :, :, None]  # [N, d1, B, 1]
        wrap_t = jnp.transpose(wrap_b)[:, None, :, None]  # [N, 1, B, 1]
        y0 = jnp.take(y, j_c, axis=0).reshape(out_cap, d1, B, C)
        y1 = jnp.take(y, j_c + 1, axis=0).reshape(out_cap, d1, B, C)
        out = jnp.sum(jnp.where(wrap_t, y1, y0) * vs, axis=1)
        out = out.reshape(out_cap, R)
        lane = jnp.arange(out_cap, dtype=jnp.int32)
        out = jnp.where((lane < n_out)[:, None], out, 0.0)
        if out_layout == "bm":
            out = jnp.transpose(out.reshape(out_cap, B, C), (1, 0, 2))

        # ---- consume: shared scalar + per-stream residual into pos ----
        if wide:
            # static (hi, lo) stride at n_out + per-stream carry; exact
            # mod-2^32 with saturation (see the sync tm wide consume)
            d_hi = jnp.take(nl_hi_c, n_out)
            d_lo = jnp.take(nl_lo_c, n_out)
            t2 = pos_lo + d_lo                           # [B] u32
            carry = (t2 < pos_lo) | (t2 >= M_u)
            lo_after = jnp.where(carry, t2 - M_u, t2)
            hi_raw = pos_hi + d_hi + carry.astype(jnp.uint32)
            hi_after = jnp.where(hi_raw < pos_hi, u32_max, hi_raw)
            consumed = jnp.minimum(
                jnp.min(hi_after), jnp.asarray(avail, jnp.uint32)
            ).astype(jnp.int32)
            start = start + consumed
            pos_state = dict(
                pos_hi=hi_after - jnp.asarray(consumed, jnp.uint32),
                pos_lo=lo_after,
            )
        else:
            pos_after = pos + n_out * L                  # [B]
            consumed = jnp.minimum(jnp.min(pos_after) // M, avail)
            start = start + consumed
            pos_state = dict(pos_num=pos_after - consumed * M)

        # ---- amortized compaction (same as the sync fleet) ----
        def compact(args):
            buf, s_, f_ = args
            ws = jnp.minimum(s_, jnp.int32(ring - cap))
            win = jax.lax.dynamic_slice(buf, (ws, 0), (cap, R))
            buf2 = jnp.concatenate(
                [win, jnp.zeros((ring - cap, R), jnp.float32)], axis=0
            )
            return buf2, s_ - ws, f_ - ws

        buffer, start, fill = jax.lax.cond(
            fill + jnp.int32(max_chunk + slack) > jnp.int32(ring),
            compact,
            lambda args: args,
            (buffer, start, fill),
        )

        new_state = FirState(
            buffer=buffer, start=start, fill=fill, **pos_state
        )
        return new_state, out, to_copy, n_out

    return step


def fir_fleet_init_async_tm(
    config: FirConfig,
    n_streams: int,
    *,
    max_chunk: int,
    horizon: int = 16,
    pos_num=None,
    skew_periods: int = 1,
) -> FirState:
    """Initial state for ``make_fir_fleet_step_async_tm``.  ``pos_num``
    (optional ``[n_streams]`` integer array) sets per-stream initial
    subframe positions (units of 1/M input frames; exact Python ints OK
    for wide pairs); the skew invariant ``max - min < skew_periods * M``
    is checked here (the step preserves the spread exactly)."""
    ring = -(
        -(config.input_capacity + config.read_slack + horizon * max_chunk)
        // 256
    ) * 256
    M_ = config.ratio_den
    if pos_num is None:
        pos = np.zeros(n_streams, object)
    else:
        pos = np.asarray(
            [int(p) for p in np.asarray(pos_num).reshape(-1)], object
        )
        if pos.shape != (n_streams,):
            raise ValueError(
                f"pos_num must have shape ({n_streams},), got {pos.shape}"
            )
        if min(pos) < 0:
            raise ValueError("initial positions must be non-negative")
        if int(max(pos) - min(pos)) >= skew_periods * M_:
            raise ValueError(
                f"position spread {int(max(pos) - min(pos))} violates the "
                f"skew invariant (< skew_periods*M = "
                f"{skew_periods * M_}); widen skew_periods or "
                "use the vmapped engine"
            )
    state = FirState(
        buffer=jnp.zeros(
            (ring, n_streams * config.channels), jnp.float32
        ),
        start=jnp.zeros((), jnp.int32),
        fill=jnp.zeros((), jnp.int32),
    )
    if config.wide:
        state["pos_hi"] = jnp.asarray(
            np.asarray([int(p) // M_ for p in pos], np.uint32)
        )
        state["pos_lo"] = jnp.asarray(
            np.asarray([int(p) % M_ for p in pos], np.uint32)
        )
    else:
        state["pos_num"] = jnp.asarray(
            np.asarray([int(p) for p in pos], np.int32)
        )
    return state
