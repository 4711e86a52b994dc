"""``resample`` CLI: WAV -> WAV sample-rate conversion.

Mirror of the reference CLI (reference: resample/src/main.rs:10-313):

    python -m resampler_tpu.tools.cli --filter {linear,hermite,fir,fft}
        --sample-rate RATE [--latency {8,16,32,64}]
        [--attenuation {60,90,120}] input.wav output.wav

Behavior parity: int WAVs normalized by 2^(bits-1); mono duplicated to
stereo; output is stereo float32 WAV; FFT path pads the last chunk and
truncates to ceil(in_len * co / ci); FIR path streams 512-sample chunks
through the (consumed, produced) loop; reports wall time and MiB/s of f32
output.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="resample", description="Resample WAV files to different sample rates"
    )
    p.add_argument("--filter", required=True,
                   choices=["linear", "hermite", "fir", "fft"])
    p.add_argument("--sample-rate", required=True, type=int, metavar="RATE")
    p.add_argument("--latency", type=int, default=64, metavar="SAMPLES")
    p.add_argument("--attenuation", type=int, default=90, metavar="DB")
    p.add_argument("input")
    p.add_argument("output")
    return p


def main(argv=None) -> int:
    from .. import (
        Attenuation,
        Latency,
        ResamplerFft,
        ResamplerFir,
        SampleRate,
    )
    from ..utils.compile_cache import enable_compile_cache
    from ..utils.wav import read_wav, write_wav
    from .interpolation import InterpolationMode, InterpolationResampler

    args = build_parser().parse_args(argv)
    enable_compile_cache()

    try:
        latency = Latency.from_delay(args.latency)
        attenuation = Attenuation.from_db(args.attenuation)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    try:
        samples, info = read_wav(args.input)
    except (OSError, ValueError) as e:
        print(f"Error reading {args.input}: {e}", file=sys.stderr)
        return 1

    print(
        f"Input: {info.sample_rate} Hz, {info.channels} channels, "
        f"{info.bits_per_sample} bits"
    )
    print(f"Output: {args.sample_rate} Hz")
    method = {
        "linear": "Linear interpolation",
        "hermite": "Hermite interpolation",
        "fir": f"FIR polyphase resampling (latency: {latency.name}, "
               f"attenuation: {attenuation.name})",
        "fft": "FFT resampling",
    }[args.filter]
    print(f"Method: {method}")

    supported = sorted(int(r) for r in SampleRate)
    try:
        input_rate = SampleRate.from_hz(info.sample_rate)
        output_rate = SampleRate.from_hz(args.sample_rate)
    except ValueError:
        print(
            f"Unsupported sample rate. Supported rates: {supported}",
            file=sys.stderr,
        )
        return 1

    # mono -> stereo duplication; >2 channels unsupported
    # (reference: resample/src/main.rs:139-156)
    if info.channels == 1:
        stereo = np.repeat(samples, 2)
    elif info.channels == 2:
        stereo = samples
    else:
        print(f"Unsupported channel count: {info.channels}", file=sys.stderr)
        return 1

    print(f"Input frames: {stereo.size // 2}")

    start = time.perf_counter()
    if args.filter == "fir":
        r = ResamplerFir(2, input_rate, output_rate, latency, attenuation)
        # process() batches file-length inputs into scanned multi-chunk
        # device dispatches (one per 32 chunks) — the per-512-sample
        # streaming loop (_stream_fir, kept for the reference-parity
        # consumed/produced surface) pays one host dispatch per chunk
        resampled = r.process(stereo)
    elif args.filter == "fft":
        r = ResamplerFft(2, input_rate, output_rate)
        resampled = r.process(stereo)
    else:
        mode = (
            InterpolationMode.LINEAR
            if args.filter == "linear"
            else InterpolationMode.HERMITE
        )
        resampled = InterpolationResampler(
            2, input_rate, output_rate, mode
        ).resample(stereo)
    elapsed = time.perf_counter() - start

    print(f"Output frames: {resampled.size // 2}")
    mib = resampled.size * 4 / (1024 * 1024)
    print(
        f"Resampling took {elapsed * 1000:.3f} ms ({mib / elapsed:.2f} MiB/s)"
    )

    write_wav(args.output, resampled, args.sample_rate, 2)
    print(f"Done! Written to {args.output}")
    return 0


def _stream_fir(resampler, samples: np.ndarray) -> np.ndarray:
    """512-sample consumed/produced streaming loop
    (reference: resample/src/main.rs:226-254)."""
    chunk = 512
    out_buf = np.zeros(resampler.buffer_size_output(), np.float32)
    pieces = []
    offset = 0
    while offset < samples.size:
        end = min(offset + chunk, samples.size)
        consumed, produced = resampler.resample(samples[offset:end], out_buf)
        pieces.append(out_buf[:produced].copy())
        offset += consumed
        if consumed == 0:
            break
    return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)


if __name__ == "__main__":
    sys.exit(main())
