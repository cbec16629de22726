"""Sharding rules and the mesh context of the port (counterpart of
``repro.distributed``)."""

from .sharding import (
    LOGICAL_AXES,
    AxisRules,
    MeshContext,
    build_shardings,
    current_mesh_context,
    default_rules,
    is_spec_leaf,
    logical_sharding,
    mesh_context,
    shard,
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
]
