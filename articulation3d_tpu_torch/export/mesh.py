"""Plane -> textured 3D mesh (host-side, numpy and OpenCV, no pytorch3d).

Counterpart of `articulation3d_tpu/export/mesh.py`, the reference mesh
path (`utils/vis.py:122-393`):

  * binary mask -> polygon rings (cv2 contours replace skimage's
    find_contours, same marching-squares family);
  * ear-clipping triangulation (the port's own build of the C++
    `arti3d_earcut`, `native.py`; mapbox_earcut in the reference) with the
    reference's CW->CCW face swap;
  * vertices lifted through the plane (EVAL focal 571.623718 by default,
    matching `utils/vis.py:256`);
  * texture rectification: pick two in-plane directions, build a
    2D homography to a 300x300 uv map (`cv2.getPerspectiveTransform` +
    `warpPerspective`), uvs in [0, 1] with y flipped;
  * optional `webvis` coordinate flip (diag(-1,1,-1) @ diag(-1,-1,1)).

Meshes are plain numpy containers (`TexturedMesh`), not pytorch3d
structures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import cv2
import numpy as np

from ..native import earcut
from ..utils.rle import rle_decode
from ..utils.camera import get_pcd, project2D

TARGET_UV_SIZE = 300
WEBVIS_MATRIX = (np.diag([-1.0, 1.0, -1.0]) @ np.diag([-1.0, -1.0, 1.0]))


@dataclass
class TexturedMesh:
    """verts (V, 3), faces (F, 3) int, verts_uvs (V, 2), uv_map uint8."""

    verts: np.ndarray
    faces: np.ndarray
    verts_uvs: Optional[np.ndarray] = None
    uv_map: Optional[np.ndarray] = None

    def copy(self) -> "TexturedMesh":
        return TexturedMesh(self.verts.copy(), self.faces.copy(),
                            None if self.verts_uvs is None else self.verts_uvs.copy(),
                            self.uv_map)

    def transformed(self, fn) -> "TexturedMesh":
        m = self.copy()
        m.verts = np.asarray(fn(m.verts))
        return m


def binary_mask_to_polygon(mask: np.ndarray, tolerance: float = 2.0
                           ) -> List[List[float]]:
    """Binary mask -> COCO-style polygon list [[x1,y1,x2,y2,...], ...].

    cv2.findContours + approxPolyDP stands in for the reference's
    skimage find_contours + approximate_polygon
    (`utils/pycococreatortools.py:32-56`).
    """
    mask = np.ascontiguousarray((np.asarray(mask) > 0.5).astype(np.uint8))
    contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polygons = []
    for c in contours:
        c = cv2.approxPolyDP(c, tolerance, True)
        if len(c) < 3:
            continue
        polygons.append(c.reshape(-1, 2).astype(np.float64).ravel().tolist())
    return polygons


def triangulate(verts: np.ndarray) -> np.ndarray:
    """(N, 2) simple polygon -> (M, 3) triangles (native C++ ear clipping)."""
    return earcut(verts)


def _rectify_texture(tmp_verts: np.ndarray, normal: np.ndarray,
                     offset: float, img: np.ndarray, focal_length: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """In-plane homography to a square uv map (reference
    `utils/vis.py:160-200`).  Returns (H_use, warped 300x300 image)."""
    tmp_pcd = np.asarray(get_pcd(tmp_verts, normal, offset,
                                 focal_length=focal_length))
    point0 = tmp_pcd[0]
    d0 = np.sum((tmp_pcd - point0) ** 2, axis=1)
    point1 = tmp_pcd[np.argmax(d0)]
    dir1 = point1 - point0
    dir1 = dir1 / np.linalg.norm(dir1)
    dir2 = np.cross(dir1, normal)
    control3d = np.stack([point0, point0 + dir1, point0 + dir2,
                          point0 + dir1 + dir2])
    proj = np.asarray(project2D(control3d, focal_length=focal_length),
                      np.float32)
    t = TARGET_UV_SIZE
    fake = np.array([[0, 0], [0, t], [t, 0], [t, t]], np.float32)
    h = cv2.getPerspectiveTransform(proj, fake)
    p = cv2.perspectiveTransform(
        tmp_verts.astype(np.float32).reshape(1, -1, 2), h)[0]
    x_t, y_t = p[:, 0].min(), p[:, 1].min()
    max_scale = max(p[:, 0].max() - p[:, 0].min(),
                    p[:, 1].max() - p[:, 1].min())
    max_scale = max(max_scale, 1e-6)
    shuffle = np.array([[t / max_scale, 0, -x_t * t / max_scale],
                        [0, t / max_scale, -y_t * t / max_scale],
                        [0, 0, 1]])
    h_use = shuffle @ h
    warped = cv2.warpPerspective(np.asarray(img), h_use, (t, t))
    return h_use, warped


def get_single_image_mesh_arti(plane_params: np.ndarray,
                               segmentations: np.ndarray,
                               img: np.ndarray, height: int = 480,
                               width: int = 640,
                               focal_length: float = 571.623718,
                               webvis: bool = False
                               ) -> Tuple[List[TexturedMesh], List[np.ndarray]]:
    """(N, 3) stored planes + (N, H, W) binary masks -> textured meshes.

    Port of `utils/vis.py:256-393` (the `_plane` variant at 134-253 differs
    only in taking polygons/RLE input: `get_single_image_mesh_plane`).
    """
    plane_params = np.array(plane_params, np.float64).reshape(-1, 3)
    # stored -> camera swap (in place in the reference)
    plane_params = np.stack([plane_params[:, 0], -plane_params[:, 2],
                             plane_params[:, 1]], axis=1)
    offsets = np.linalg.norm(plane_params, axis=1)
    norms = plane_params / np.maximum(offsets, 1e-12)[:, None]

    poly_segs = [binary_mask_to_polygon(np.asarray(m)) for m in segmentations]
    return _build_meshes(poly_segs, norms, offsets, img, height, width,
                         focal_length, webvis)


def get_single_image_mesh_plane(plane_params, segmentations, img,
                                height: int = 480, width: int = 640,
                                focal_length: float = 571.623718,
                                webvis: bool = False
                                ) -> Tuple[List[TexturedMesh], List[np.ndarray]]:
    """Polygon / RLE segmentation variant (`utils/vis.py:134-253`): each
    segmentation is a list of (N, 2) rings or a COCO RLE dict, decoded with
    `utils.rle.rle_decode`."""
    plane_params = np.array(plane_params, np.float64).reshape(-1, 3)
    plane_params = np.stack([plane_params[:, 0], -plane_params[:, 2],
                             plane_params[:, 1]], axis=1)
    offsets = np.linalg.norm(plane_params, axis=1)
    norms = plane_params / np.maximum(offsets, 1e-12)[:, None]
    if segmentations and isinstance(segmentations[0], dict):
        segmentations = [binary_mask_to_polygon(rle_decode(s)) for s in segmentations]
    return _build_meshes(segmentations, norms, offsets, img, height, width,
                         focal_length, webvis)


def _build_meshes(poly_segs, norms, offsets, img, height, width,
                  focal_length, webvis):
    meshes: List[TexturedMesh] = []
    uv_maps: List[np.ndarray] = []
    for segm, normal, offset in zip(poly_segs, norms, offsets):
        if len(segm) == 0:
            continue
        tmp_verts = np.concatenate(
            [np.asarray(s, np.float64).reshape(-1, 2) for s in segm])
        h_use, warped = _rectify_texture(tmp_verts, normal, offset, img,
                                         focal_length)
        uv_maps.append(warped)

        verts_3d: List[np.ndarray] = []
        faces: List[np.ndarray] = []
        uvs: List[np.ndarray] = []
        for ring in segm:
            verts = np.asarray(ring, np.float64).reshape(-1, 2)
            pcd = np.asarray(get_pcd(verts, normal, offset,
                                     focal_length=focal_length))
            if webvis:
                pcd = (WEBVIS_MATRIX @ pcd.T).T
            uvs_rect = cv2.perspectiveTransform(
                verts.astype(np.float32).reshape(1, -1, 2), h_use)[0]
            uvs_rect = np.array([0, 1]) + np.array([1, -1]) * uvs_rect / \
                np.array([TARGET_UV_SIZE, TARGET_UV_SIZE])
            tris = triangulate(verts)
            if tris.shape[0] == 0:
                continue
            tris = tris + sum(len(v) for v in verts_3d)
            tris[:, [0, 2]] = tris[:, [2, 0]]  # reference CW->CCW swap
            verts_3d.append(pcd)
            faces.append(tris)
            uvs.append(uvs_rect)
        if not verts_3d:
            uv_maps.pop()
            continue
        meshes.append(TexturedMesh(
            verts=np.concatenate(verts_3d).astype(np.float32),
            faces=np.concatenate(faces).astype(np.int64),
            verts_uvs=np.concatenate(uvs).astype(np.float32),
            uv_map=warped))
    return meshes, uv_maps


# --------------------------------------------------------------------------- #
# primitive meshes (reference pytorch3d ico_sphere + utils/camera.py)
# --------------------------------------------------------------------------- #

def ico_sphere(level: int = 0, scale: float = 1.0) -> TexturedMesh:
    """Icosphere (level 0 = icosahedron), replacing pytorch3d's ico_sphere
    used for axis endpoint markers (`tools/inference.py:78-90`)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(level):
        verts, faces = _subdivide(verts, faces)
    return TexturedMesh(verts=(verts * scale).astype(np.float32), faces=faces)


def _subdivide(verts, faces):
    edge_mid = {}
    verts = list(verts)

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            m = (np.asarray(verts[a]) + verts[b]) / 2
            m = m / np.linalg.norm(m)
            verts.append(m)
            edge_mid[key] = len(verts) - 1
        return edge_mid[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(new_faces, np.int64)
