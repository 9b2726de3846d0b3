"""Per-frame articulated .obj export (reference `tools/inference.py:44-168`).

For the most confident detection of a frame: build its textured plane mesh
and a background mesh (inverted mask), sweep the plane mesh through 5
rotation angles about the predicted 3D axis (range -1.8..0 rad, the
reference's 'l' direction), add icosphere markers at the axis endpoints,
blend uv textures toward the reference's highlight colors, and write one
multi-mesh obj/mtl via `save_obj`.

Counterpart of `articulation3d_tpu/export/save_model.py`.  As there, the
sweep's rotation matrix is built in float32 (JAX runs without x64) and
applied to the float64 vertices.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from ..data.axis_codec import angle_offset_to_axis
from ..temporal.kernels import rodrigues
from ..utils.camera import get_pcd
from ..utils.coords import plane_to_camera
from .mesh import WEBVIS_MATRIX, TexturedMesh, get_single_image_mesh_arti, ico_sphere
from .obj_writer import save_obj

SWEEP_COLOR = np.array([[[252 / 255, 116 / 255, 81 / 255]]])
AXIS_COLOR = np.array([[[56 / 255, 207 / 255, 252 / 255]]])


def _blend(uv_map: np.ndarray, color: np.ndarray) -> np.ndarray:
    return ((uv_map / 255.0 + color) / 2 * 255.0).astype(np.uint8)


def save_obj_model(preds: Sequence, frames: Sequence[np.ndarray],
                   frame_id: int, output: str, axis_dir: str = "l",
                   webvis: bool = False, height: int = 480,
                   width: int = 640) -> None:
    p = preds[frame_id]
    if len(p) == 0:
        print("no prediction!")
        return
    box_id = int(np.argmax(p.scores))
    im = np.asarray(frames[frame_id])

    # axis geometry through the predicted plane (OPT intrinsics f=517.97)
    plane_cam = plane_to_camera(p.planes[box_id].astype(np.float64))
    offset = np.linalg.norm(plane_cam)
    normal = plane_cam / max(offset, 1e-12)
    pts = angle_offset_to_axis(p.rot_axis, p.box_centers, H=height, W=width)
    verts_axis = pts[box_id].reshape(2, 2).astype(np.float64)
    verts_axis_3d = np.asarray(get_pcd(verts_axis, normal, offset,
                                       h=height, w=width))
    if webvis:
        verts_axis_3d = (WEBVIS_MATRIX @ verts_axis_3d.T).T
    dir_vec = verts_axis_3d[1] - verts_axis_3d[0]
    dir_vec = dir_vec / np.linalg.norm(dir_vec)

    # plane + background meshes (EVAL focal, reference default)
    seg = np.asarray(p.masks[box_id])[None]
    plane_param = p.planes[box_id][None]
    mesh_bkgd, uv_maps_bkgd = get_single_image_mesh_arti(
        plane_param, 1 - seg, img=im, height=height, width=width,
        webvis=webvis)
    mesh_list, uv_maps = get_single_image_mesh_arti(
        plane_param, seg, img=im, height=height, width=width, webvis=webvis)
    if not mesh_list:
        print("empty mesh!")
        return
    mesh = mesh_list[0]

    # rotation sweep of the mesh about the axis (5 angles)
    if axis_dir == "l":
        angles = np.arange(-1.8, 0.1, 1.8 / 4)
    elif axis_dir == "r":
        angles = np.arange(0.0, 1.8, 1.8 / 4)
    else:
        raise NotImplementedError(axis_dir)

    meshes: List[TexturedMesh] = [mesh]
    uv_maps_list = [uv_maps[0]]
    p0 = verts_axis_3d[0]
    for angle in angles:
        r = rodrigues(torch.from_numpy(dir_vec.astype(np.float32)),
                      torch.tensor(angle, dtype=torch.float32)).numpy()
        swept = mesh.transformed(lambda v: (v - p0) @ r + p0)
        meshes.append(swept)
        uv_maps_list.append(uv_maps[0])

    # axis endpoint markers
    for endpoint in verts_axis_3d:
        marker = ico_sphere(0, scale=0.1)
        marker.verts = (marker.verts + endpoint).astype(np.float32)
        marker.verts_uvs = np.ones((len(marker.verts), 2), np.float32)
        meshes.append(marker)
        uv_maps_list.append(uv_maps[0])

    # texture blending (reference `tools/inference.py:148-158`)
    for i in range(min(5, len(uv_maps_list))):
        color = SWEEP_COLOR * (i / 10 + 1 / 2)
        uv_maps_list[i] = _blend(uv_maps_list[i], color)
    uv_maps_list[-1] = _blend(uv_maps_list[-1], AXIS_COLOR)
    uv_maps_list[-2] = _blend(uv_maps_list[-2], AXIS_COLOR)

    meshes = meshes + mesh_bkgd
    uv_maps_list = uv_maps_list + uv_maps_bkgd

    output_dir = os.path.join(output, "frame_{:0>4}".format(frame_id))
    os.makedirs(output_dir, exist_ok=True)
    save_obj(output_dir, "arti_pred", meshes, decimal_places=10,
             uv_maps=uv_maps_list)
