"""Halo exchange for spatially-sharded windowed filtering.

Each shard owns a contiguous block of image rows. Before running the local
windowed graph it needs ``margin`` rows from each neighbor; at the global
top/bottom it needs edge replication instead — exactly reproducing the
single-device padded-canvas semantics, so spatially-sharded output is
bit-identical to single-device output.

The exchange is a pair of ``lax.ppermute`` shifts, which XLA hands to the
collective library (NCCL on GPUs — SURVEY.md §5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def halo_pad_local(
    x_local: jnp.ndarray, margin: int, axis_name: str
) -> jnp.ndarray:
    """(..., Hl, W) local rows -> (..., Hl + 2*margin, W) with neighbor halos.

    Must be called inside shard_map/pmap over ``axis_name``. Global edges get
    edge-replication of the shard's own boundary row.
    """
    n = lax.axis_size(axis_name)

    # Global boundaries: replicate our own edge row, matching jnp.pad('edge').
    first_row = lax.slice_in_dim(x_local, 0, 1, axis=-2)
    last_row = lax.slice_in_dim(x_local, x_local.shape[-2] - 1,
                                x_local.shape[-2], axis=-2)
    reps = [1] * x_local.ndim
    reps[-2] = margin

    if n == 1:  # single shard: no neighbors, no collectives — pure replicate
        return jnp.concatenate(
            [jnp.tile(first_row, reps), x_local, jnp.tile(last_row, reps)],
            axis=-2,
        )

    idx = lax.axis_index(axis_name)
    bottom_rows = lax.slice_in_dim(x_local, x_local.shape[-2] - margin,
                                   x_local.shape[-2], axis=-2)
    top_rows = lax.slice_in_dim(x_local, 0, margin, axis=-2)

    # halo from previous shard (its bottom rows arrive at our top)
    from_prev = lax.ppermute(
        bottom_rows, axis_name, [((i - 1) % n, i) for i in range(n)]
    )
    # halo from next shard (its top rows arrive at our bottom)
    from_next = lax.ppermute(
        top_rows, axis_name, [((i + 1) % n, i) for i in range(n)]
    )

    top = jnp.where(idx == 0, jnp.tile(first_row, reps), from_prev)
    bottom = jnp.where(idx == n - 1, jnp.tile(last_row, reps), from_next)

    return jnp.concatenate([top, x_local, bottom], axis=-2)
