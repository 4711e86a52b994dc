"""Multi-device scaling: shard the stream-batch axis over a device mesh.

The reference is single-core; its scaling story is "run many independent
resampler instances on many threads" (SURVEY.md §2.9).  The equivalent
here is a leading ``stream`` batch axis sharded across devices with
``jax.sharding`` over a flat 1-D mesh — embarrassingly parallel, so no
collective traffic crosses the interconnect except optional fleet
telemetry reductions (peak meters), which XLA lowers to one all-reduce.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "stream_mesh",
    "stream_sharding",
    "shard_batch",
    "shard_lanes",
    "replicate",
]

#: Mesh axis name for the independent-streams batch dimension.
STREAM_AXIS = "stream"


def stream_mesh(devices=None) -> Mesh:
    """1-D device mesh over the independent-streams axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (STREAM_AXIS,))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (stream) axis, replicate the rest."""
    return NamedSharding(mesh, P(STREAM_AXIS))


def shard_batch(tree, mesh: Mesh):
    """Place every array in ``tree`` with its leading axis sharded over the
    stream axis of ``mesh``.

    Rank-aware: leaves that cannot carry a stream axis — scalars/0-d
    arrays (e.g. the synchronized fleet's shared ``available_frames`` /
    ``pos_num`` schedule scalars) and leaves whose leading dim does not
    divide over the mesh — are fully replicated instead.  Without this the
    sync-fleet state (mixed ``[B, ...]`` buffers and shared scalars) could
    not be mesh-sharded through the public wrappers.
    """
    sharded = stream_sharding(mesh)
    replicated = NamedSharding(mesh, P())
    # divisibility must be gated on the STREAM axis extent, not the total
    # mesh size: on a multi-axis mesh the NamedSharding only splits over
    # STREAM_AXIS, and the fleet steps gate on the same extent
    n = mesh.shape[STREAM_AXIS]

    def place(x):
        ndim = getattr(x, "ndim", None)
        if ndim is None:
            ndim = np.ndim(x)
        shape = getattr(x, "shape", ())
        if ndim == 0 or (len(shape) > 0 and shape[0] % n != 0):
            return jax.device_put(x, replicated)
        return jax.device_put(x, sharded)

    return jax.tree.map(place, tree)


def shard_lanes(tree, mesh: Mesh):
    """Place every array in ``tree`` with its LAST axis sharded over the
    stream axis of ``mesh``.

    The time-major synchronized fleet keeps its ring buffer ``[ring,
    B*C]`` with streams on the minor (lane) axis — sharding the leading
    axis there would split the ring's TIME dimension across chips.  Lane
    index is ``b*C + c``, so a stream-axis shard of the lane dimension
    keeps whole streams per device (``B`` divisible by the mesh keeps
    ``B*C`` divisible).  Rank-aware like ``shard_batch``: scalars and
    non-dividing leaves are replicated."""
    sharded_last = {
        nd: NamedSharding(mesh, P(*([None] * (nd - 1) + [STREAM_AXIS])))
        for nd in (1, 2, 3, 4)
    }
    replicated = NamedSharding(mesh, P())
    # gate on the stream-axis extent (not mesh.size): the spec shards over
    # STREAM_AXIS only — gating on mesh.size would silently replicate
    # lanes a multi-axis mesh could shard
    n = mesh.shape[STREAM_AXIS]

    def place(x):
        ndim = getattr(x, "ndim", None)
        if ndim is None:
            ndim = np.ndim(x)
        shape = getattr(x, "shape", ())
        if ndim == 0 or ndim > 4 or shape[-1] % n != 0:
            return jax.device_put(x, replicated)
        return jax.device_put(x, sharded_last[ndim])

    return jax.tree.map(place, tree)


def replicate(tree, mesh: Mesh):
    """Fully replicate every array in ``tree`` across ``mesh``."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
