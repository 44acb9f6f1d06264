"""Device mesh construction.

Replacement for the reference's device model: a per-array integer
device tag + global cudaSetDevice (/root/reference/src/ndarray.h:73,
numpower.c:615-635) becomes a named `jax.sharding.Mesh` with axes

    data  — MPC scenarios (DP; SURVEY.md §2.5 table)
    model — QP / condensed-matrix blocks (TP)

Placement is expressed per-array as NamedSharding(mesh, PartitionSpec(...)),
and XLA inserts collectives where shardings meet (NCCL between GPUs) —
no hand-written communication layer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from numpower_tpu.utils.config import config


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Optional[Tuple[str, str]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    shape=None puts all devices on the data axis (scenario parallelism is
    the dominant axis for MPC sweeps — BASELINE configs #4/#5).
    """
    devices = list(devices) if devices is not None else jax.devices()
    axis_names = axis_names or (config.data_axis, config.model_axis)
    if shape is None:
        shape = config.mesh_shape or (len(devices), 1)
    n_needed = shape[0] * shape[1]
    if n_needed > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n_needed} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n_needed]).reshape(shape)
    return Mesh(dev_array, axis_names)


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Scenario-batched arrays: leading axis over the data mesh axis."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def model_sharding(mesh: Mesh, axis: int = 0) -> NamedSharding:
    """Block matrices: given axis over the model mesh axis."""
    spec = [None] * (axis + 1)
    spec[axis] = mesh.axis_names[1]
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a scenario batch onto the mesh's data axis — the
    equivalent of the reference's explicit $x->gpu() transfer
    (numpower.c:512 -> ndarray.c:1038)."""
    return jax.device_put(x, data_sharding(mesh))
