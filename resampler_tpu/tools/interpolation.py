"""Baseline interpolation resamplers (comparators for the quality harness).

Vectorized counterparts of the reference CLI's 2-point linear and 4-point
3rd-order Hermite comparators
(reference: resample/src/interpolation_resampler.rs:41-127; the Hermite
x-form follows Niemitalo, "Polynomial Interpolators for High-Quality
Resampling of Oversampled Audio", p. 43).  Unlike the reference's scalar
per-sample loops, both are fully vectorized: the output position grid is
one arange, neighbor gathers are fancy-indexed, and the polynomial
evaluates elementwise — the same code would jit via jnp, but these are
comparators, so plain numpy keeps them dependency-light.
"""

from __future__ import annotations

import enum
import math

import numpy as np

__all__ = ["InterpolationMode", "InterpolationResampler"]


class InterpolationMode(enum.Enum):
    LINEAR = "linear"
    HERMITE = "hermite"


class InterpolationResampler:
    """One-shot batch resampler by polynomial interpolation."""

    def __init__(self, channels: int, input_rate, output_rate,
                 mode: InterpolationMode) -> None:
        self.channels = channels
        self.input_rate = float(int(input_rate))
        self.output_rate = float(int(output_rate))
        self.mode = mode

    def resample(self, input_interleaved: np.ndarray) -> np.ndarray:
        x = np.asarray(input_interleaved, np.float32)
        C = self.channels
        frames = x.reshape(-1, C).astype(np.float64)
        n_in = len(frames)
        ratio = self.output_rate / self.input_rate
        n_out = math.ceil(n_in * ratio)

        # Output i samples input position i/ratio (reference:
        # resample/src/interpolation_resampler.rs:48-50, 91-93).
        pos = np.arange(n_out, dtype=np.float64) / ratio
        idx = np.floor(pos).astype(np.int64)
        frac = (pos - idx)[:, None]

        if self.mode is InterpolationMode.LINEAR:
            i0 = np.minimum(idx, n_in - 1)
            i1 = np.minimum(idx + 1, n_in - 1)
            out = frames[i0] * (1.0 - frac) + frames[i1] * frac
            # last-sample hold at the boundary (reference :52-59)
            hold = idx >= n_in - 1
            out[hold] = frames[n_in - 1]
        else:
            ip = np.maximum(idx - 1, 0)
            i0 = np.minimum(idx, n_in - 1)
            i1 = np.minimum(idx + 1, n_in - 1)
            i2 = np.minimum(idx + 2, n_in - 1)
            prev, cur, nxt1, nxt2 = frames[ip], frames[i0], frames[i1], frames[i2]
            c0 = cur
            c1 = 0.5 * (nxt1 - prev)
            c2 = prev - 2.5 * cur + 2.0 * nxt1 - 0.5 * nxt2
            c3 = 0.5 * (nxt2 - prev) + 1.5 * (cur - nxt1)
            out = ((c3 * frac + c2) * frac + c1) * frac + c0

        return out.astype(np.float32).reshape(-1)
