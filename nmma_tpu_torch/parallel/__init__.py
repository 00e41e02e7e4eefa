from .mesh import (BatchMesh, initialize_distributed, make_mesh, shard_logl,
                   shard_state)

__all__ = ["BatchMesh", "make_mesh", "shard_logl", "shard_state",
           "initialize_distributed"]
