from .mesh import make_mesh, sharded_fused_aji, sharded_fused_sn

__all__ = ["make_mesh", "sharded_fused_aji", "sharded_fused_sn"]
