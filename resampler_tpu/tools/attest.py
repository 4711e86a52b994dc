"""Signal-quality attestations run on the device under test.

Shared by ``bench.py`` and ``chip_smoke.py`` so that a speed number and a
bring-up check are gated by the same measurements:

- ``single_stream_quality``: FIR alias rejection and FFT stopband through
  the public single-stream API (gates: >= 100 dB and >= 99 dB).
- ``fft_floor_db``: arithmetic noise floor of FFT fleet outputs against
  the float64 projector applied on the host (gate: >= 99 dB).
"""

from __future__ import annotations

import numpy as np

__all__ = ["single_stream_quality", "fft_floor_db"]


def single_stream_quality() -> tuple[float, float]:
    """``(fir_alias_db, fft_stopband_db)`` measured on the default device.

    A product that silently lost its explicit precision shows up here:
    a single bf16 or TF32 pass costs tens of dB of alias rejection."""
    from .. import (
        Attenuation,
        Latency,
        ResamplerFft,
        ResamplerFir,
        SampleRate,
    )

    # Stereo so the products have the fleet's row structure (a 1-channel
    # chunk is a vector-matrix product a compiler may lower differently).
    C = 2
    r = ResamplerFir(C, 48000, 44100, Latency.Sample64, Attenuation.Db90)
    t = np.arange(48000) / 48000
    tone = (0.5 * np.sin(2 * np.pi * 23000 * t)).astype(np.float32)
    x = np.repeat(tone, C)
    seg = r.process(x)[2000 * C : -2000 * C : C]
    fir_alias_db = float(-20 * np.log10(np.abs(seg).max() / 0.5 + 1e-12))

    rf = ResamplerFft(C, SampleRate.Hz22050, SampleRate.Hz48000)
    x = np.zeros(10 * rf.chunk_size_input(), np.float32)
    x[len(x) // 2 - (len(x) // 2) % C] = 1.0  # impulse on channel 0
    y = rf.process(x)[0::C]
    peak = int(np.argmax(np.abs(y)))
    w = int(48000 * 0.1)
    s = max(peak - w // 2, 0)
    spec = np.fft.rfft(y[s : s + w], 1 << 17)
    mag = 20 * np.log10(np.maximum(np.abs(spec), 1e-12))

    def b(f):
        return round(f / 48000 * (1 << 17))

    nyq = 22050 / 2
    pb = mag[b(20.0) : b(nyq * 0.9) + 1]
    sb = mag[b(nyq * 1.1) : b(48000 / 2 * 0.95) + 1]
    fft_stopband_db = float(pb.max() - sb.max())
    return fir_alias_db, fft_stopband_db


def fft_floor_db(chunks, outs, n_in: int, n_out: int) -> float:
    """Worst per-step noise floor of an FFT fleet run from silence.

    ``chunks``: the ``[B, C, N]`` inputs of consecutive fleet steps;
    ``outs``: the matching ``[B, C, M]`` outputs.  The reference applies
    the float64 projector on the host with its own overlap carry, so no
    device matmul precision enters the comparison."""
    from ..engine.fft import get_projection_matrix

    proj = get_projection_matrix(n_in, n_out).astype(np.float64)
    overlap = 0.0
    floor = np.inf
    for ch, out in zip(chunks, outs):
        full = np.asarray(ch, np.float64) @ proj
        ref = full[..., :n_out] + overlap
        overlap = full[..., n_out:]
        err = np.asarray(out, np.float64) - ref
        floor = min(
            floor,
            float(-20 * np.log10(
                np.sqrt((err**2).mean() / (ref**2).mean() + 1e-300)
            )),
        )
    return floor
