"""resampler_tpu — audio sample-rate conversion in JAX for accelerator fleets.

A from-scratch re-design of the capabilities of the `resampler` Rust crate
as data-parallel JAX programs (run on NVIDIA GPUs; tested on the CPU):

- :class:`ResamplerFft` — FFT overlap-add resampler (Kaiser β=10, ~-100 dB
  stopband, fixed chunk-size API).  The whole spectral pipeline
  (zero-pad → rFFT → spectral filter → bin resize → irFFT) is compiled at
  construction time into a single dense projection matrix applied as one
  matrix product.
- :class:`ResamplerFir` — 1024-phase polyphase windowed-sinc FIR resampler
  with inter-phase linear interpolation, 16-128 taps, streaming API with
  arbitrary input sizes returning ``(consumed, produced)``.  The phase
  accumulator runs in exact int32 rational arithmetic (no sequential f64
  loop), so the whole per-chunk schedule vectorizes.

Both engines expose a pure functional core (``init`` / ``step`` over
explicit pytree state) suitable for ``jit`` / ``vmap`` / ``pjit``, plus the
stateful wrapper API mirroring the reference crate, plus batched
multi-stream variants that shard across device meshes.
"""

from .types import (
    Attenuation,
    InvalidInputBufferSize,
    InvalidOutputBufferSize,
    Latency,
    ResampleError,
    SampleRate,
    SampleRateFamily,
)

__version__ = "0.1.0"

__all__ = [
    "Attenuation",
    "InvalidInputBufferSize",
    "InvalidOutputBufferSize",
    "Latency",
    "ResampleError",
    "SampleRate",
    "SampleRateFamily",
    "ResamplerFft",
    "ResamplerFir",
    "BatchedResamplerFir",
    "BatchedResamplerFft",
    "StreamingFleet",
    "__version__",
]


def __getattr__(name):  # lazy imports keep `import resampler_tpu` light
    if name == "StreamingFleet":
        from .runtime import StreamingFleet

        return StreamingFleet
    if name in __all__:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module 'resampler_tpu' has no attribute {name!r}")
