"""Device-mesh helpers.

The reference is single-GPU (CUDA streams only, SURVEY §2.7); multi-chip
scaling is new capability mandated by the north star: block-rows sharded
with jax.sharding, collectives inserted by XLA or explicit in
shard_map.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def make_mesh_2d(shape: tuple[int, int], axes=("dp", "tp")) -> Mesh:
    devs = jax.devices()
    n = shape[0] * shape[1]
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]).reshape(shape), axes)


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
