"""Textured multi-mesh .obj/.mtl writer (reference `utils/mesh_utils.py:126-266`).

A copy of `articulation3d_tpu/export/obj_writer.py`.

Format parity with the reference `save_obj`/`_save`: one obj + one mtl, a
`uv_maps/` directory of rectified textures, global 1-based vertex indices,
double-sided faces (each face written twice, reversed), `%.<d>f` float
formatting, `usemtl <map basename>` per mesh, and optional solid-color
camera/axis meshes via `_get_mtl_rgb` materials.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import cv2
import numpy as np

from .mesh import TexturedMesh


def _get_mtl_map(material_name: str, map_kd: str) -> str:
    return f"""newmtl {material_name}
map_Kd {map_kd}
# Test colors
Ka 1.000 1.000 1.000  # white
Kd 1.000 1.000 1.000  # white
Ks 0.000 0.000 0.000  # black
Ns 10.0\n"""


def _get_mtl_rgb(material_idx: int, rgb: Sequence[float]) -> str:
    return f"""newmtl color_{material_idx}
Kd {rgb[0]} {rgb[1]} {rgb[2]}
Ka 0.000 0.000 0.000\n"""


def _save(f, verts: np.ndarray, faces: np.ndarray, vert_offset: int,
          verts_uv: Optional[np.ndarray] = None,
          uv_offset: int = 0, map_file: Optional[str] = None,
          rgb: Optional[Sequence[float]] = None, idx: Optional[int] = None,
          double_sided: bool = True,
          decimal_places: Optional[int] = None) -> None:
    float_str = "%f" if decimal_places is None else f"%.{decimal_places}f"
    lines = ""
    for v in verts:
        lines += "v %s\n" % " ".join(float_str % x for x in v)
    if verts_uv is not None:
        for uv in verts_uv:
            lines += "vt %s\n" % " ".join(float_str % x for x in uv)
    if map_file is not None:
        lines += f"usemtl {os.path.basename(map_file).split('.')[0]}\n"
    elif rgb is not None:
        lines += f"usemtl color_{idx}\n"
    for face in faces:
        if verts_uv is not None:
            fwd = ["%d/%d" % (i + 1 + vert_offset, i + 1 + uv_offset)
                   for i in face]
        else:
            fwd = ["%d" % (i + 1 + vert_offset) for i in face]
        lines += "f %s\n" % " ".join(fwd)
        if double_sided:
            lines += "f %s\n" % " ".join(reversed(fwd))
    f.write(lines)


def save_obj(folder: str, prefix: str, meshes: Sequence[TexturedMesh],
             cam_meshes: Optional[Sequence] = None,
             decimal_places: Optional[int] = None,
             uv_maps: Optional[Sequence[np.ndarray]] = None) -> str:
    """Write meshes (+ uv maps) as <prefix>.obj/.mtl under `folder`."""
    os.makedirs(folder, exist_ok=True)
    if uv_maps is None:
        uv_maps = [m.uv_map for m in meshes]

    uv_dir = os.path.join(folder, "uv_maps")
    os.makedirs(uv_dir, exist_ok=True)
    map_files = []
    for map_id, uv_map in enumerate(uv_maps):
        uv_path = os.path.join(uv_dir, f"{prefix}_uv_plane_{map_id}.png")
        if uv_map is not None:
            img = np.asarray(uv_map)
            cv2.imwrite(uv_path, img[:, :, ::-1] if img.ndim == 3 else img)
        else:
            cv2.imwrite(uv_path, np.zeros((8, 8, 3), np.uint8))
        map_files.append(uv_path)

    obj_path = os.path.join(folder, prefix + ".obj")
    with open(os.path.join(folder, prefix + ".mtl"), "w") as f_mtl, \
            open(obj_path, "w") as f:
        seen = set()
        for map_file in map_files:
            if map_file in seen:
                continue
            seen.add(map_file)
            f_mtl.write(_get_mtl_map(
                os.path.basename(map_file).split(".")[0],
                os.path.join("uv_maps", os.path.basename(map_file))))

        f.write(f"mtllib {prefix}.mtl\n\n")
        vert_offset = 0
        uv_offset = 0
        for idx, (mesh, map_file) in enumerate(zip(meshes, map_files)):
            f.write(f"# mesh {idx}\n")
            uvs = mesh.verts_uvs
            if uvs is not None:
                uvs = uvs[:len(mesh.verts)]
            _save(f, mesh.verts, mesh.faces, vert_offset, verts_uv=uvs,
                  uv_offset=uv_offset, map_file=map_file,
                  decimal_places=decimal_places)
            vert_offset += len(mesh.verts)
            uv_offset += 0 if uvs is None else len(uvs)

        if cam_meshes:
            for idx, (mesh, rgb) in enumerate(cam_meshes):
                f.write(f"# camera {idx}\n")
                f_mtl.write(_get_mtl_rgb(idx, rgb))
                _save(f, mesh.verts, mesh.faces, vert_offset, rgb=rgb,
                      idx=idx, decimal_places=decimal_places)
                vert_offset += len(mesh.verts)
    return obj_path
