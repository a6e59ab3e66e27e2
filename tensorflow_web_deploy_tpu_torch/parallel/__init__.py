"""Meshes, the multi-process bootstrap and the collectives of the
sharded train step (counterpart of the JAX package's ``parallel/``)."""

from .mesh import RankMesh, batch_multiple, build_mesh, cpu_mesh, mesh_for, shard_params_tp, \
    train_mesh

__all__ = ["RankMesh", "batch_multiple", "build_mesh", "cpu_mesh", "mesh_for",
           "shard_params_tp", "train_mesh"]
