"""Profiling hooks (SURVEY.md §5: the reference has only the CLI's
wall-clock print; here the JAX profiler is wired in).

Usage::

    from resampler_tpu.utils.profiling import trace, timed

    with trace("/tmp/tb"):             # TensorBoard/XProf trace of a region
        fleet.resample(chunks)

    with timed("fir step") as t:       # wall-clock with device sync
        out = step(state, chunk, n)
    print(t.seconds)
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["card_identity", "trace", "timed", "Timer"]


def card_identity() -> str:
    """``name, power.limit`` of each GPU as ``nvidia-smi`` reports them.

    A card below its maximum power limit runs slower under load, so every
    measurement is printed beside this; it reads the cards without JAX."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (proc.stdout.strip() or proc.stderr.strip()).replace("\n", "; ")


@contextlib.contextmanager
def trace(log_dir: str):
    """JAX profiler trace of the enclosed region (view with TensorBoard's
    profile plugin / XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    seconds: float = 0.0

    def mibps(self, n_bytes: int) -> float:
        """Throughput in MiB/s for ``n_bytes`` moved during the region
        (the reference CLI's reporting unit, resample/src/main.rs:190-196)."""
        return n_bytes / self.seconds / (1 << 20)


@contextlib.contextmanager
def timed(label: str = "", *, sync: bool = True):
    """Wall-clock a region; blocks on all device work at exit so the
    measurement includes asynchronously dispatched computation."""
    import jax

    t = Timer()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        if sync:
            try:
                jax.effects_barrier()
            except Exception:
                pass
        t.seconds = time.perf_counter() - t0
