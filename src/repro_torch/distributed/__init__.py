"""Mesh context of the port (counterpart of ``repro.distributed``)."""

from .sharding import MeshContext, current_mesh_context, mesh_context

__all__ = ["MeshContext", "current_mesh_context", "mesh_context"]
