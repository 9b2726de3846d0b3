"""3D export: plane meshes, textured .obj writing, articulation sweeps."""

from .mesh import (TexturedMesh, binary_mask_to_polygon,  # noqa: F401
                   get_single_image_mesh_arti, ico_sphere, triangulate)
from .obj_writer import save_obj  # noqa: F401
from .save_model import save_obj_model  # noqa: F401
