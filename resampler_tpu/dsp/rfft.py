"""Real-valued mixed-radix FFT — device-runnable for arbitrary even sizes.

The device analog of the reference's FFT engine core
(reference: src/fft/radix_fft.rs:105-712, src/fft/stockham_autosort.rs):
a mixed-radix Cooley-Tukey FFT over factors {2,3,4,5,7,8} with the same
N/2 real-FFT optimization (pack N reals into N/2 complex, post/pre-process
with expansion twiddles — reference: src/fft/radix_fft.rs:470-670).

Differences from the reference:

- **No complex dtype anywhere.**  Complex values are explicit
  ``(re, im)`` real-array
  pairs, so every op is plain f32 arithmetic XLA can fuse (the reference
  reaches the same layout via ``Complex32`` reinterpret casts,
  reference: src/fft/mod.rs:10-69).
- **Decimation by reshape/transpose + per-radix DFT contraction** instead
  of a butterfly ISA layer: each stage splits the length axis with a
  reshape, applies the static ``[r, r]`` DFT matrix as an einsum
  and the stage twiddles as an elementwise multiply.  The recursion is
  unrolled at trace time — static shapes, jit/vmap-friendly.
- Twiddles and DFT matrices are designed in float64 on the host and cast
  once, like the reference's f64 twiddle precompute
  (reference: src/fft/radix_fft.rs:250-362).

This is the production escape hatch for chunk sizes where the dense
[N, 2M] spectral projector would be too large (the planner-table sizes
all use the projector; see engine/fft.py) — and it gives ``backend="fft"``
a device-runnable real-valued equivalent.

Unnormalized like the reference: ``irfft(rfft(x)) == N * x``
(reference: src/fft/radix_fft.rs:58-71).
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fft_factors", "rfft_pair", "irfft_pair", "RealFft"]

_RADICES = (8, 7, 5, 4, 3, 2)


def fft_factors(n: int) -> tuple[int, ...]:
    """Factor ``n`` into supported radices, largest-first with the
    reference optimizer's preference for radix 8 over 4*2/2*2*2
    (reference: src/fft/optimizer.rs:6-64).  Raises if ``n`` has a prime
    factor outside {2, 3, 5, 7}."""
    factors = []
    rest = n
    for r in _RADICES:
        while rest % r == 0:
            factors.append(r)
            rest //= r
    if rest != 1:
        raise ValueError(
            f"size {n} has prime factors outside the radix set 2/3/5/7"
        )
    return tuple(factors)


@lru_cache(maxsize=None)
def _dft_matrix(r: int) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(r)
    w = np.exp(-2j * np.pi * np.outer(k, k) / r)
    return (
        np.ascontiguousarray(w.real, np.float32),
        np.ascontiguousarray(w.imag, np.float32),
    )


@lru_cache(maxsize=None)
def _stage_twiddles(n: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Twiddles e^{-2pi i j1 k / n} for combining ``r`` interleaved
    sub-FFTs of length ``m = n // r``: shape [r, m]."""
    m = n // r
    j1 = np.arange(r)[:, None]
    k = np.arange(m)[None, :]
    w = np.exp(-2j * np.pi * j1 * k / n)
    return (
        np.ascontiguousarray(w.real, np.float32),
        np.ascontiguousarray(w.imag, np.float32),
    )


def _cfft(re, im, n: int, factors):
    """Complex FFT over the trailing axis as (re, im) pairs.

    Decimation in time: x[j1::r] sub-sequences are transformed
    recursively, twiddled, and combined with the [r, r] DFT contraction.
    Unrolled at trace time (depth = len(factors))."""
    if not factors:
        return re, im
    r = factors[0]
    m = n // r
    # [..., n] -> [..., m, r] -> [..., r, m]: sub-sequence j1 = x[j1::r]
    re = jnp.swapaxes(re.reshape(*re.shape[:-1], m, r), -1, -2)
    im = jnp.swapaxes(im.reshape(*im.shape[:-1], m, r), -1, -2)
    re, im = _cfft(re, im, m, factors[1:])  # [..., r, m]

    twr, twi = (jnp.asarray(t) for t in _stage_twiddles(n, r))
    tre = re * twr - im * twi
    tim = re * twi + im * twr

    dr, di = (jnp.asarray(d) for d in _dft_matrix(r))

    # X[s*m + k] = sum_j1 DFT[s, j1] * t[j1, k].  A default-precision
    # product may run as one bf16 or TF32 pass (~2^-9 to 2^-11 relative
    # per stage, compounding across the factor stages) — these DFT
    # contractions are over <= 8 elements, so HIGHEST costs nothing.
    def cdot(a, b):
        return jnp.einsum(
            "sj,...jk->...sk", a, b,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    out_re = cdot(dr, tre) - cdot(di, tim)
    out_im = cdot(dr, tim) + cdot(di, tre)
    return (
        out_re.reshape(*out_re.shape[:-2], n),
        out_im.reshape(*out_im.shape[:-2], n),
    )


@lru_cache(maxsize=None)
def _expansion_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """e^{-2pi i k / n} for k = 0..n/2 (the real<->complex post/pre-process
    twiddles, reference: src/fft/radix_fft.rs:373-399)."""
    k = np.arange(n // 2 + 1)
    w = np.exp(-2j * np.pi * k / n)
    return (
        np.ascontiguousarray(w.real, np.float32),
        np.ascontiguousarray(w.imag, np.float32),
    )


@partial(jax.jit, static_argnames=("n",))
def rfft_pair(x, n: int):
    """Unnormalized real FFT of the trailing axis: ``[..., n]`` f32 ->
    ``([..., n/2+1], [..., n/2+1])`` (re, im).  ``n`` must be even with
    prime factors in {2, 3, 5, 7}."""
    if n % 2:
        raise ValueError("rfft_pair requires even n")
    m = n // 2
    factors = fft_factors(m)
    x = x.astype(jnp.float32)
    # N/2 trick: z[k] = x[2k] + i x[2k+1]
    ze = x.reshape(*x.shape[:-1], m, 2)
    zr, zi = _cfft(ze[..., 0], ze[..., 1], m, factors)

    # postprocess: X[k] = (Z[k] + conj(Z[m-k]))/2
    #                    - i/2 * e^{-2pi i k/n} (Z[k] - conj(Z[m-k]))
    idx = (-jnp.arange(m + 1)) % m
    zr_k = jnp.concatenate([zr, zr[..., :1]], axis=-1)
    zi_k = jnp.concatenate([zi, zi[..., :1]], axis=-1)
    zr_c = jnp.take(zr, idx, axis=-1)
    zi_c = -jnp.take(zi, idx, axis=-1)

    ar = 0.5 * (zr_k + zr_c)
    ai = 0.5 * (zi_k + zi_c)
    br = 0.5 * (zi_k - zi_c)          # -i/2 * (Z - conj) = (im, -re)/2
    bi = -0.5 * (zr_k - zr_c)
    twr, twi = (jnp.asarray(t) for t in _expansion_twiddles(n))
    out_re = ar + br * twr - bi * twi
    out_im = ai + br * twi + bi * twr
    return out_re, out_im


@partial(jax.jit, static_argnames=("n",))
def irfft_pair(re, im, n: int):
    """Unnormalized inverse real FFT: ``([..., n/2+1], [..., n/2+1])`` ->
    ``[..., n]`` f32, scaled by n/2 relative to numpy's irfft (i.e.
    ``irfft_pair(rfft_pair(x, n), n) == n * x``, matching the reference's
    unnormalized round-trip, reference: src/fft/radix_fft.rs:58-71)."""
    if n % 2:
        raise ValueError("irfft_pair requires even n")
    m = n // 2
    factors = fft_factors(m)
    # preprocess (inverse of rfft postprocess):
    # Z[k] = A[k] + i * e^{+2pi i k/n} * B[k],
    #   A = (X[k] + conj(X[m-k]))/1, B = (X[k] - conj(X[m-k])) ... derived:
    # Z[k] = (X[k] + conj(X[m-k])) + i e^{2pi i k/n} (X[k] - conj(X[m-k]))
    xr_k, xi_k = re[..., :m], im[..., :m]
    xr_c = jnp.take(re[..., : m + 1], (m - jnp.arange(m)), axis=-1)
    xi_c = -jnp.take(im[..., : m + 1], (m - jnp.arange(m)), axis=-1)

    ar = xr_k + xr_c
    ai = xi_k + xi_c
    dr = xr_k - xr_c
    di = xi_k - xi_c
    twr, twi = (jnp.asarray(t) for t in _expansion_twiddles(n))
    twr, twi = twr[:m], -twi[:m]      # conj: e^{+2pi i k/n}
    # i * tw * d = i*(twr+i twi)*(dr+i di)
    br = -(twi * dr + twr * di)
    bi = twr * dr - twi * di
    zr = ar + br
    zi = ai + bi

    # inverse complex FFT via conj(fft(conj(z))); the preprocess above
    # carries 2x (A/D not halved), conj-fft carries m = n/2: net n * x
    yr, yi = _cfft(zr, -zi, m, factors)
    yi = -yi
    return jnp.stack([yr, yi], axis=-1).reshape(*yr.shape[:-1], n)


class RealFft:
    """OO wrapper mirroring ``RadixFFT``'s surface
    (reference: src/fft/radix_fft.rs:105-712): ``process`` for forward
    (real -> half-complex pair) and ``process_inverse`` for the
    unnormalized inverse."""

    def __init__(self, n: int):
        if n % 2:
            raise ValueError("RealFft requires even n")
        fft_factors(n // 2)  # validates factorization early
        self.n = n

    def process(self, x):
        return rfft_pair(x, self.n)

    def process_inverse(self, re, im):
        return irfft_pair(re, im, self.n)

    def __repr__(self) -> str:
        return f"RealFft(n={self.n}, factors={fft_factors(self.n // 2)})"
