"""Sharding rules and the mesh context of the port (counterpart of
``repro.distributed``)."""

from .sharding import (
    LOGICAL_AXES,
    AxisRules,
    MeshContext,
    build_shardings,
    current_mesh_context,
    default_rules,
    gather_rows,
    is_spec_leaf,
    local_rows,
    logical_sharding,
    mesh_context,
    shard,
    split_rows,
    unit_rules,
)

__all__ = [
    "LOGICAL_AXES",
    "AxisRules",
    "default_rules",
    "unit_rules",
    "MeshContext",
    "current_mesh_context",
    "mesh_context",
    "logical_sharding",
    "is_spec_leaf",
    "build_shardings",
    "shard",
    "split_rows",
    "local_rows",
    "gather_rows",
]
