"""Device-side containers for blocked-sparse matrices.

Host formats (sparta_tpu.formats) hold numpy; these hold jnp arrays laid out
for the device paths: values as [nbr, max_nb, bh, bw] tiles, indices int32.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..definitions import to_device
from ..formats.bell import BELL


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BellDevice:
    """Blocked-ELL on device.  A pytree: jittable as an argument."""

    cols_idx: jax.Array  # int32 [nbr, max_nb], -1 padded
    nb_row: jax.Array    # int32 [nbr]
    vals: jax.Array      # [nbr, max_nb, bh, bw]

    @property
    def n_block_rows(self) -> int:
        return self.cols_idx.shape[0]

    @property
    def max_nb(self) -> int:
        return self.cols_idx.shape[1]

    @property
    def block_row_size(self) -> int:
        return self.vals.shape[2]

    @property
    def block_col_size(self) -> int:
        return self.vals.shape[3]

    @property
    def out_rows(self) -> int:
        return self.n_block_rows * self.block_row_size

    def tree_flatten(self):
        return (self.cols_idx, self.nb_row, self.vals), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_host(cls, bell: BELL, dtype=jnp.float32) -> "BellDevice":
        return cls(
            cols_idx=jnp.asarray(bell.cols_idx, dtype=jnp.int32),
            nb_row=jnp.asarray(bell.nb_row, dtype=jnp.int32),
            vals=to_device(bell.vals, dtype),
        )


def pad_b_for_bell(B: np.ndarray | jax.Array, bell: BELL) -> jax.Array:
    """Zero-pad the dense operand's rows up to the blocked K."""
    K = bell.shape[1]
    B = jnp.asarray(B)
    if B.shape[0] < K:
        B = jnp.pad(B, ((0, K - B.shape[0]), (0, 0)))
    return B
