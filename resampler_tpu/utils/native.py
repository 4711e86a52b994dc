"""ctypes bindings for the native host runtime (csrc/resampler_host.cpp).

The device executes the compute path; this library accelerates the host side:
WAV decode/encode, interleave layout conversion, and the multi-stream
staging pool that feeds batched device steps.  Everything degrades
gracefully: if the shared library hasn't been built (``make -C csrc``),
callers fall back to the pure-numpy implementations.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

__all__ = [
    "is_available",
    "build",
    "load",
    "wav_read_native",
    "wav_write_native",
    "deinterleave",
    "interleave",
    "HostStreamPool",
]

_LIB_PATH = (
    pathlib.Path(__file__).resolve().parent.parent.parent
    / "csrc"
    / "build"
    / "libresampler_host.so"
)

_lib = None
_lock = threading.Lock()


def build(quiet: bool = True) -> bool:
    """Build the native library in-tree.  Returns True on success."""
    csrc = _LIB_PATH.parent.parent
    try:
        proc = subprocess.run(
            ["make", "-C", str(csrc)],
            capture_output=quiet,
            timeout=120,
        )
        return proc.returncode == 0 and _LIB_PATH.exists()
    except (OSError, subprocess.TimeoutExpired):
        return False


def load():
    """Load (once) and return the ctypes library handle, or None."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _LIB_PATH.exists():
            if os.environ.get("RESAMPLER_TPU_BUILD_NATIVE") == "1":
                if not build():
                    return None
            else:
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None

        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)

        lib.rtpu_abi_version.restype = ctypes.c_uint32
        lib.rtpu_free.argtypes = [ctypes.c_void_p]
        lib.rtpu_wav_read.restype = ctypes.c_int
        lib.rtpu_wav_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(f32p), u64p, u32p, u16p, u16p,
            u16p,
        ]
        lib.rtpu_wav_write.restype = ctypes.c_int
        lib.rtpu_wav_write.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint16,
        ]
        lib.rtpu_deinterleave.argtypes = [
            f32p, f32p, ctypes.c_uint64, ctypes.c_uint32,
        ]
        lib.rtpu_interleave.argtypes = [
            f32p, f32p, ctypes.c_uint64, ctypes.c_uint32,
        ]
        lib.rtpu_pool_create.restype = ctypes.c_void_p
        lib.rtpu_pool_create.argtypes = [
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ]
        lib.rtpu_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.rtpu_pool_push.restype = ctypes.c_int64
        lib.rtpu_pool_push.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, f32p, ctypes.c_uint64,
        ]
        lib.rtpu_pool_pending.restype = ctypes.c_uint64
        lib.rtpu_pool_pending.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rtpu_pool_fill.argtypes = [
            ctypes.c_void_p, f32p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint32,
        ]
        if lib.rtpu_abi_version() != 1:
            return None
        _lib = lib
        return _lib


def is_available() -> bool:
    return load() is not None


def _f32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_read_native(path) -> tuple[np.ndarray, int, int, int, str]:
    """Native WAV read -> (samples f32, rate, channels, bits, format)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library not available")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_uint64()
    rate = ctypes.c_uint32()
    channels = ctypes.c_uint16()
    bits = ctypes.c_uint16()
    fmt = ctypes.c_uint16()
    rc = lib.rtpu_wav_read(
        str(path).encode(), ctypes.byref(out), ctypes.byref(n),
        ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(bits),
        ctypes.byref(fmt),
    )
    if rc != 0:
        raise ValueError(f"{path}: native WAV read failed (code {rc})")
    try:
        samples = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.rtpu_free(out)
    sample_format = "float" if fmt.value == 3 else "int"
    return samples, rate.value, channels.value, bits.value, sample_format


def wav_write_native(path, samples: np.ndarray, rate: int, channels: int):
    lib = load()
    if lib is None:
        raise RuntimeError("native library not available")
    samples = np.ascontiguousarray(samples, np.float32)
    rc = lib.rtpu_wav_write(
        str(path).encode(), _f32p(samples), samples.size, rate, channels
    )
    if rc != 0:
        raise OSError(f"{path}: native WAV write failed (code {rc})")


def deinterleave(samples: np.ndarray, channels: int) -> np.ndarray:
    """[frames*C] interleaved -> [C, frames] planar (native or numpy)."""
    samples = np.ascontiguousarray(samples, np.float32)
    frames = samples.size // channels
    lib = load()
    if lib is None:
        return samples[: frames * channels].reshape(frames, channels).T.copy()
    out = np.empty((channels, frames), np.float32)
    lib.rtpu_deinterleave(_f32p(samples), _f32p(out), frames, channels)
    return out


def interleave(planar: np.ndarray) -> np.ndarray:
    """[C, frames] planar -> [frames*C] interleaved (native or numpy)."""
    planar = np.ascontiguousarray(planar, np.float32)
    channels, frames = planar.shape
    lib = load()
    if lib is None:
        return planar.T.reshape(-1).copy()
    out = np.empty(frames * channels, np.float32)
    lib.rtpu_interleave(_f32p(planar), _f32p(out), frames, channels)
    return out


class HostStreamPool:
    """Ragged per-stream FIFO queues drained into fixed-shape batches.

    The host-side data loader for fleet serving: producers push interleaved
    audio per stream (thread-safe in the native implementation); the
    consumer calls :meth:`fill` to get the ``[n_streams, chunk_frames,
    channels]`` zero-padded batch plus per-stream valid counts expected by
    the batched device step.  Pure-python fallback when the native library
    isn't built.
    """

    def __init__(self, n_streams: int, channels: int, capacity_frames: int = 1 << 16):
        self.n_streams = n_streams
        self.channels = channels
        self.capacity_frames = capacity_frames
        self._lib = load()
        if self._lib is not None:
            self._pool = self._lib.rtpu_pool_create(
                n_streams, channels, capacity_frames
            )
            if not self._pool:
                raise MemoryError("rtpu_pool_create failed")
        else:
            self._pool = None
            self._queues = [np.zeros(0, np.float32) for _ in range(n_streams)]
            self._lock = threading.Lock()

    def push(self, stream: int, values: np.ndarray) -> int:
        """Queue interleaved values; returns the number accepted."""
        values = np.ascontiguousarray(values, np.float32)
        if self._pool is not None:
            return int(
                self._lib.rtpu_pool_push(
                    self._pool, stream, _f32p(values), values.size
                )
            )
        with self._lock:
            q = self._queues[stream]
            room = self.capacity_frames * self.channels - q.size
            take = min(values.size - values.size % self.channels, max(room, 0))
            take -= take % self.channels
            self._queues[stream] = np.concatenate([q, values[:take]])
            return int(take)

    def pending(self, stream: int) -> int:
        if self._pool is not None:
            return int(self._lib.rtpu_pool_pending(self._pool, stream))
        with self._lock:
            return int(self._queues[stream].size)

    def fill(self, chunk_frames: int) -> tuple[np.ndarray, np.ndarray]:
        """Drain into ``(batch [B, chunk_frames, C], n_valid [B])``."""
        B, C = self.n_streams, self.channels
        batch = np.zeros((B, chunk_frames, C), np.float32)
        n_valid = np.zeros(B, np.int32)
        if self._pool is not None:
            self._lib.rtpu_pool_fill(
                self._pool,
                _f32p(batch),
                n_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                chunk_frames,
            )
            return batch, n_valid
        with self._lock:
            for s in range(B):
                q = self._queues[s]
                frames = min(q.size // C, chunk_frames)
                batch[s, :frames] = q[: frames * C].reshape(frames, C)
                self._queues[s] = q[frames * C :]
                n_valid[s] = frames
        return batch, n_valid

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool:
            self._lib.rtpu_pool_destroy(pool)
            self._pool = None
