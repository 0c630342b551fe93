"""Meshes, logical-axis sharding and the gang's process group: the JAX
package's spmd layer over torch.distributed (DeviceMesh, DTensor
placements, explicit collectives)."""

from .distributed import (
    initialize_from_current,
    initialize_from_env,
    process_info,
)
from .mesh import (
    AXIS_ORDER,
    Mesh,
    MeshSpec,
    batch_sharding,
    create_hybrid_mesh,
    create_mesh,
    data_axes,
    mesh_axis_size,
)
from .sharding import (
    NamedSharding,
    constrain,
    rules_for_mesh,
    shard_tree,
    spec_for,
    tree_shardings,
    tree_specs,
)

__all__ = [
    "AXIS_ORDER",
    "Mesh",
    "MeshSpec",
    "NamedSharding",
    "batch_sharding",
    "constrain",
    "create_hybrid_mesh",
    "create_mesh",
    "data_axes",
    "initialize_from_current",
    "initialize_from_env",
    "mesh_axis_size",
    "process_info",
    "rules_for_mesh",
    "shard_tree",
    "spec_for",
    "tree_shardings",
    "tree_specs",
]
