"""3D export: plane meshes, textured .obj writing, articulation sweeps,
mesh primitives and world/local transforms."""

from .mesh import (TexturedMesh, binary_mask_to_polygon,
                   get_single_image_mesh_arti, get_single_image_mesh_plane,
                   ico_sphere, triangulate)
from .obj_writer import save_obj
from .primitives import (create_arrow_mesh, create_color_palette,
                         create_cylinder_mesh, get_camera_meshes, write_obj,
                         write_ply)
from .save_model import save_obj_model
from .transforms import (get_plane_params_in_global, get_plane_params_in_local,
                         quat_to_rotmat, rotate_mesh_for_webview,
                         transform_meshes, transform_verts)

__all__ = [
    "TexturedMesh", "binary_mask_to_polygon", "triangulate", "ico_sphere",
    "get_single_image_mesh_arti", "get_single_image_mesh_plane", "save_obj",
    "save_obj_model", "create_cylinder_mesh", "create_arrow_mesh",
    "get_camera_meshes", "create_color_palette", "write_ply", "write_obj",
    "quat_to_rotmat", "transform_meshes", "transform_verts",
    "rotate_mesh_for_webview", "get_plane_params_in_global",
    "get_plane_params_in_local",
]
