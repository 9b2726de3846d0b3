"""Low-level mesh primitives: cylinders, arrows, camera frusta, writers.

Counterpart of `articulation3d_tpu/export/primitives.py`, a numpy
re-implementation of the reference's `utils/camera.py:9-373` surface:
cylinder/arrow meshes between two 3D points (stacks x slices rings + caps),
camera frustum edges as thin cylinders, the ScanNet color palette, and
plain .ply/.obj point/tri writers.  Vectorized ring generation instead of
the reference's per-vertex Python loops; identical topology.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .mesh import TexturedMesh


def create_color_palette() -> List[Tuple[int, int, int]]:
    """ScanNet NYU-40 color palette (reference `utils/camera.py:9-49`)."""
    return [
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (178, 76, 76), (247, 182, 210), (66, 188, 102), (219, 219, 141),
        (140, 57, 197), (202, 185, 52), (51, 176, 203), (200, 54, 131),
        (92, 193, 61), (78, 71, 183), (172, 114, 82), (255, 127, 14),
        (91, 163, 138), (153, 98, 156), (140, 153, 101), (158, 218, 229),
        (100, 125, 154), (178, 127, 135), (120, 185, 128), (146, 111, 194),
        (44, 160, 44), (112, 128, 144), (96, 207, 209), (227, 119, 194),
        (213, 92, 176), (94, 106, 211), (82, 84, 163), (100, 85, 144),
    ]


def _frame_for_direction(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors orthogonal to d."""
    d = d / max(np.linalg.norm(d), 1e-12)
    helper = np.array([1.0, 0, 0]) if abs(d[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(d, helper)
    u /= max(np.linalg.norm(u), 1e-12)
    v = np.cross(d, u)
    return u, v


def create_cylinder_mesh(radius: float, p0: Sequence[float],
                         p1: Sequence[float], stacks: int = 10,
                         slices: int = 10
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Cylinder from p0 to p1 -> (verts (V, 3), faces (F, 3))."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    if length < 1e-12:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    u, v = _frame_for_direction(axis)
    theta = 2 * np.pi * np.arange(slices) / slices
    ring = radius * (np.outer(np.cos(theta), u) + np.outer(np.sin(theta), v))
    ts = np.linspace(0.0, 1.0, stacks + 1)
    verts = (p0[None, None] + ts[:, None, None] * axis[None, None]
             + ring[None]).reshape(-1, 3)
    faces = []
    for s in range(stacks):
        for i in range(slices):
            a = s * slices + i
            b = s * slices + (i + 1) % slices
            c = (s + 1) * slices + i
            d = (s + 1) * slices + (i + 1) % slices
            faces += [[a, b, c], [b, d, c]]
    # end caps
    base = len(verts)
    verts = np.concatenate([verts, p0[None], p1[None]])
    for i in range(slices):
        faces.append([i, (i + 1) % slices, base])
        top = stacks * slices
        faces.append([top + (i + 1) % slices, top + i, base + 1])
    return verts, np.asarray(faces, np.int64)


def create_arrow_mesh(radius: float, p0: Sequence[float], p1: Sequence[float],
                      stacks: int = 10, slices: int = 10,
                      arrow_height: float = 0.15
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Cylinder shaft + cone head from p0 to p1."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    if length < 1e-12:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    head = min(arrow_height if arrow_height > 0 else 0.15 * length,
               0.5 * length)
    shaft_end = p1 - axis / length * head
    verts, faces = create_cylinder_mesh(radius, p0, shaft_end, stacks, slices)
    u, v = _frame_for_direction(axis)
    theta = 2 * np.pi * np.arange(slices) / slices
    ring = 2 * radius * (np.outer(np.cos(theta), u) + np.outer(np.sin(theta), v))
    base = len(verts)
    cone_verts = np.concatenate([shaft_end[None] + ring, p1[None]])
    cone_faces = [[base + i, base + (i + 1) % slices, base + slices]
                  for i in range(slices)]
    return (np.concatenate([verts, cone_verts]),
            np.concatenate([faces, np.asarray(cone_faces, np.int64)]))


def get_axis_mesh(radius: float, p0, p1) -> TexturedMesh:
    """Arrow as a TexturedMesh (reference `mesh_utils.get_axis_mesh`)."""
    verts, faces = create_arrow_mesh(radius, p0, p1)
    return TexturedMesh(verts=verts.astype(np.float32), faces=faces)


def get_cone_edges(position, lookat, vertical,
                   fov: float = 0.9, depth: float = 0.3
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Camera frustum edges (position + 4 image-corner rays)."""
    position = np.asarray(position, np.float64)
    lookat = np.asarray(lookat, np.float64)
    vertical = np.asarray(vertical, np.float64)
    d = lookat / max(np.linalg.norm(lookat), 1e-12)
    up = vertical / max(np.linalg.norm(vertical), 1e-12)
    right = np.cross(d, up)
    half = math.tan(fov / 2) * depth
    corners = [position + depth * d + sx * half * right + sy * half * up
               for sx in (-1, 1) for sy in (-1, 1)]
    edges = [(position, c) for c in corners]
    ring = [corners[0], corners[1], corners[3], corners[2]]
    edges += [(ring[i], ring[(i + 1) % 4]) for i in range(4)]
    return edges


def get_camera_meshes(camera_list: Sequence[dict], radius: float = 0.02
                      ) -> List[Tuple[TexturedMesh, Tuple[float, ...]]]:
    """Frusta as cylinder meshes, one (mesh, rgb) per camera
    (reference `mesh_utils.get_camera_meshes`)."""
    out = []
    palette = create_color_palette()
    for idx, cam in enumerate(camera_list):
        verts_all, faces_all = [], []
        offset = 0
        for p0, p1 in get_cone_edges(cam["position"], cam["lookat"],
                                     cam["vertical"]):
            v, f = create_cylinder_mesh(radius, p0, p1, stacks=2, slices=6)
            verts_all.append(v)
            faces_all.append(f + offset)
            offset += len(v)
        mesh = TexturedMesh(verts=np.concatenate(verts_all).astype(np.float32),
                            faces=np.concatenate(faces_all))
        rgb = tuple(c / 255 for c in palette[idx % len(palette)])
        out.append((mesh, rgb))
    return out


def write_ply(verts: np.ndarray, colors: Optional[np.ndarray],
              indices: Optional[np.ndarray], output_file: str) -> None:
    """ASCII ply writer (reference `utils/camera.py:193-216`)."""
    verts = np.asarray(verts)
    with open(output_file, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        n_face = 0 if indices is None else len(indices)
        f.write(f"element face {n_face}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        if indices is not None:
            for face in indices:
                f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def write_obj(verts: np.ndarray, colors: Optional[np.ndarray],
              indices: Optional[np.ndarray], output_file: str,
              mtl_filename: Optional[str] = None) -> None:
    """Plain obj writer (reference `utils/camera.py:254-285`)."""
    with open(output_file, "w") as f:
        if mtl_filename:
            f.write(f"mtllib {mtl_filename}\n")
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if indices is not None:
            for face in indices:
                f.write("f " + " ".join(str(int(i) + 1) for i in face) + "\n")
