"""Quaternion world/local mesh + plane-parameter transforms (host numpy).

Counterpart of `articulation3d_tpu/export/transforms.py`, the reference's
numpy-quaternion utilities (`utils/mesh_utils.py:34-125`): camera pose
dicts carry a `position` (3,) translation and a `rotation` quaternion;
meshes and planes move between the local (SunCG) camera frame and the
global (habitat) world frame with the SunCG<->habitat axis flip
`[1, -1, -1]` applied at the boundary.

Quaternions are plain numpy `[w, x, y, z]` arrays (the reference's
`numpy-quaternion` C extension is not a dependency; `quat_to_rotmat`
matches `quaternion.as_rotation_matrix`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from .mesh import TexturedMesh

SUNCG2HABITAT = np.array([1.0, -1.0, -1.0], np.float32)

Quaternion = Union[np.ndarray, Sequence[float]]


def quat_to_rotmat(q: Quaternion) -> np.ndarray:
    """[w, x, y, z] quaternion -> (3, 3) rotation matrix
    (`quaternion.as_rotation_matrix` convention; normalizes first)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def quat_inverse(q: Quaternion) -> np.ndarray:
    """Unit-quaternion inverse (conjugate)."""
    q = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([q[0], -q[1], -q[2], -q[3]], np.float64)


def _pose(camera_info: Dict) -> tuple:
    tran = np.asarray(camera_info["position"], np.float32)
    rot = camera_info["rotation"]
    return tran, rot


def transform_verts(verts: np.ndarray, camera_info: Dict) -> np.ndarray:
    """Local (SunCG camera) -> global (habitat world) vertices
    (reference `transform_verts_list`, `mesh_utils.py:69-87`)."""
    tran, rot = _pose(camera_info)
    v = np.asarray(verts, np.float32) * SUNCG2HABITAT    # suncg2habitat
    return (quat_to_rotmat(rot) @ v.T).T + tran          # cam2world


def transform_meshes(meshes: Sequence[TexturedMesh], camera_info: Dict
                     ) -> List[TexturedMesh]:
    """Local-frame meshes -> global frame (reference `transform_meshes`,
    `mesh_utils.py:34-51`); faces/uv textures untouched."""
    return [m.transformed(lambda v: transform_verts(v, camera_info))
            for m in meshes]


def rotate_mesh_for_webview(meshes: Sequence[TexturedMesh]
                            ) -> List[TexturedMesh]:
    """Rotate global-frame meshes ~ -11 deg about x so the floor reads
    horizontal in web viewers (reference `mesh_utils.py:53-66`)."""
    tilt = np.array([[1, 0, 0],
                     [0, 0.9816272, -0.1908090],
                     [0, 0.1908090, 0.9816272]], np.float64)
    rot = np.linalg.inv(tilt).astype(np.float32)
    return [m.transformed(lambda v: (rot @ np.asarray(v, np.float32).T).T)
            for m in meshes]


def get_plane_params_in_global(planes: np.ndarray, camera_info: Dict
                               ) -> np.ndarray:
    """Camera-frame plane params (normal * offset) -> world frame
    (reference `mesh_utils.py:90-106`): rotate the plane point to world,
    then re-project the camera position onto the plane normal so the
    result is again `normal * offset` about the world origin."""
    tran, rot = _pose(camera_info)
    planes = np.asarray(planes, np.float32).reshape(-1, 3)
    start = np.ones((len(planes), 3), np.float32) * tran
    end = planes * SUNCG2HABITAT                         # suncg2habitat
    end = (quat_to_rotmat(rot) @ end.T).T + tran         # cam2world
    a, b = end, end - start
    scale = (a * b).sum(axis=1) / np.maximum(
        np.linalg.norm(b, axis=1) ** 2, 1e-12)
    return scale.reshape(-1, 1) * b


def get_plane_params_in_local(planes: np.ndarray, camera_info: Dict
                              ) -> np.ndarray:
    """World-frame plane params -> camera frame (reference
    `mesh_utils.py:109-125`), inverse of `get_plane_params_in_global`."""
    tran, rot = _pose(camera_info)
    b = np.asarray(planes, np.float32).reshape(-1, 3)
    a = np.ones((len(b), 3), np.float32) * tran
    scale = (a * b).sum(axis=1) / np.maximum(
        np.linalg.norm(b, axis=1) ** 2, 1e-12)
    planes_world = a + b - scale.reshape(-1, 1) * b
    end = (quat_to_rotmat(quat_inverse(rot)) @ (planes_world - tran).T).T
    return end * SUNCG2HABITAT                           # habitat2suncg
