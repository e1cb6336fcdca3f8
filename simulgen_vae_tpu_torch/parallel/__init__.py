"""The multi-device layer: a ``('data', 'model')`` mesh of ranks over
``torch.distributed``, JAX's sharding rules, and the collectives that GSPMD
inserts by itself in the JAX package, written out."""

from simulgen_vae_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    is_primary,
    make_mesh,
    mesh_grid,
    sync_processes,
)
from simulgen_vae_tpu_torch.parallel.sharding import (  # noqa: F401
    Layout,
    batch_parts,
    gather_payload,
    node_leaves,
    node_parts,
    shard_batch,
    shard_state,
)
