from .multidevice import MESH_AXIS, make_mesh, shard_pairs

__all__ = ["MESH_AXIS", "make_mesh", "shard_pairs"]
