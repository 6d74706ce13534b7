"""Multi-host execution (SURVEY.md §5 "distributed communication backend"):
``jax.distributed`` for process coordination, XLA collectives for data
(NCCL between GPUs). There is no custom transport layer.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-process runtime. Pass every argument explicitly
    (``coordinator_address`` as ``host:port``) unless a cluster manager
    that JAX detects provides them."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_batch_from_local(
    mesh, local_batch: np.ndarray, spec: P = P("data")
) -> jax.Array:
    """Assemble a globally-sharded array from each process's local shard
    (the standard per-host data-loading pattern: every host loads only its
    own slice of the batch)."""
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), np.asarray(local_batch)
    )
