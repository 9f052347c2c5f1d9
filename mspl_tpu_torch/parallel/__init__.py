"""Ranks, the (model, data) mesh and its collectives (port of
mspl_tpu/parallel/)."""

from mspl_tpu_torch.parallel.mesh import (Mesh, barrier, broadcast_object,
                                          gather_rows, init_distributed,
                                          make_mesh, make_mesh_for_batch,
                                          maybe_init_distributed, psum,
                                          replicate, shard_batch,
                                          share_with_outside)

__all__ = ["Mesh", "barrier", "broadcast_object", "gather_rows",
           "init_distributed", "make_mesh", "make_mesh_for_batch",
           "maybe_init_distributed", "psum", "replicate", "shard_batch",
           "share_with_outside"]
