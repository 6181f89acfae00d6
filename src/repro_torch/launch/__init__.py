from .mesh import make_debug_mesh, make_production_mesh

__all__ = ["make_debug_mesh", "make_production_mesh"]
