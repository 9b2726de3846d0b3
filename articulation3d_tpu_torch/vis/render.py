"""Debug mesh renderer: z-buffer rasterizer + Phong shading (host numpy).

Counterpart of `articulation3d_tpu/vis/render.py`, which replaces the
reference's pytorch3d `render_img` debug path (`utils/arti_vis.py:410-465`:
FoV perspective camera from `look_at_view_transform(2.7, 0, 0)`, one face
per pixel, `SoftPhongShader` with a single point light at (0, 0, -3), PNGs
written as `render_i.png`).  Mesh rasterization is a debug aid off the
main path, so this is a per-face numpy rasterizer with pytorch3d-style
conventions (+X left, +Y up, +Z into the screen; NDC square), equal pixel
for pixel to the JAX package's, not to pytorch3d; it never runs on the
device.

Meshes are `export.TexturedMesh` (uv-textured) or plain (verts, faces)
pairs; untextured faces shade with a neutral albedo.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

from ..export.mesh import TexturedMesh


def look_at_view_transform(dist: float = 2.7, elev: float = 0.0,
                           azim: float = 0.0,
                           at: Sequence[float] = (0.0, 0.0, 0.0)
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Camera rotation/translation looking at `at` from spherical coords
    (pytorch3d convention: angles in degrees, camera +Z faces the scene)."""
    elev_r, azim_r = np.deg2rad(elev), np.deg2rad(azim)
    # camera position on the sphere around `at`
    x = dist * np.cos(elev_r) * np.sin(azim_r)
    y = dist * np.sin(elev_r)
    z = -dist * np.cos(elev_r) * np.cos(azim_r)
    eye = np.asarray(at, np.float64) + np.array([x, y, z])
    at = np.asarray(at, np.float64)

    z_axis = at - eye
    z_axis = z_axis / np.linalg.norm(z_axis)
    up = np.array([0.0, 1.0, 0.0])
    x_axis = np.cross(up, z_axis)
    n = np.linalg.norm(x_axis)
    if n < 1e-8:                                     # looking straight up/down
        x_axis = np.array([1.0, 0.0, 0.0])
    else:
        x_axis = x_axis / n
    y_axis = np.cross(z_axis, x_axis)
    R = np.stack([x_axis, y_axis, z_axis], axis=1)   # world -> cam columns
    T = -R.T @ eye
    return R.astype(np.float32), T.astype(np.float32)


def _phong(points: np.ndarray, normals: np.ndarray, albedo: np.ndarray,
           light_pos: np.ndarray, camera_pos: np.ndarray) -> np.ndarray:
    """Per-pixel Phong: ambient 0.5 + diffuse 0.3 + specular 0.2 * albedo
    (pytorch3d PointLights/Materials defaults, shininess 64)."""
    to_light = light_pos - points
    to_light = to_light / np.maximum(
        np.linalg.norm(to_light, axis=-1, keepdims=True), 1e-8)
    to_cam = camera_pos - points
    to_cam = to_cam / np.maximum(
        np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-8)
    # flip normals toward the camera (double-sided plane meshes)
    sign = np.sign(np.sum(normals * to_cam, axis=-1, keepdims=True))
    normals = normals * np.where(sign == 0, 1.0, sign)
    diff = np.clip(np.sum(normals * to_light, axis=-1, keepdims=True), 0, 1)
    refl = 2 * diff * normals - to_light
    spec = np.clip(np.sum(refl * to_cam, axis=-1, keepdims=True), 0, 1) ** 64
    return np.clip(albedo * (0.5 + 0.3 * diff) + 0.2 * spec, 0.0, 1.0)


def render_meshes(meshes: Sequence[TexturedMesh],
                  image_size: Tuple[int, int] = (480, 640),
                  dist: float = 2.7, elev: float = 0.0, azim: float = 0.0,
                  fov: float = 60.0,
                  light_location: Sequence[float] = (0.0, 0.0, -3.0),
                  background: float = 1.0) -> np.ndarray:
    """Rasterize + Phong-shade meshes -> (H, W, 3) float image in [0, 1]."""
    hgt, wdt = image_size
    R, T = look_at_view_transform(dist, elev, azim)
    cam_pos = (-R @ T).astype(np.float64)            # camera center in world
    focal = 1.0 / np.tan(np.deg2rad(fov) / 2.0)

    img = np.full((hgt, wdt, 3), background, np.float64)
    zbuf = np.full((hgt, wdt), np.inf)

    for mesh in meshes:
        verts = np.asarray(mesh.verts, np.float64)
        faces = np.asarray(mesh.faces, np.int64)
        cam_v = verts @ R + T                        # world -> camera
        # perspective NDC (pytorch3d: +X left, +Y up -> screen x flips)
        z = np.maximum(cam_v[:, 2], 1e-6)
        ndc_x = focal * cam_v[:, 0] / z
        ndc_y = focal * cam_v[:, 1] / z
        # NDC -> pixels (square NDC spans the short image side)
        half = min(hgt, wdt) / 2.0
        px = wdt / 2.0 - ndc_x * half
        py = hgt / 2.0 - ndc_y * half

        uvs = None if mesh.verts_uvs is None else np.asarray(mesh.verts_uvs)
        tex = None if mesh.uv_map is None else np.asarray(mesh.uv_map)

        for f in faces:
            if np.any(cam_v[f, 2] <= 1e-6):
                continue                             # behind the camera
            xs, ys, zs = px[f], py[f], z[f]
            x0, x1 = int(max(np.floor(xs.min()), 0)), int(
                min(np.ceil(xs.max()), wdt - 1))
            y0, y1 = int(max(np.floor(ys.min()), 0)), int(
                min(np.ceil(ys.max()), hgt - 1))
            if x1 < x0 or y1 < y0:
                continue
            gx, gy = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                                 np.arange(y0, y1 + 1) + 0.5)
            d = ((ys[1] - ys[2]) * (xs[0] - xs[2])
                 + (xs[2] - xs[1]) * (ys[0] - ys[2]))
            if abs(d) < 1e-12:
                continue
            w0 = ((ys[1] - ys[2]) * (gx - xs[2])
                  + (xs[2] - xs[1]) * (gy - ys[2])) / d
            w1 = ((ys[2] - ys[0]) * (gx - xs[2])
                  + (xs[0] - xs[2]) * (gy - ys[2])) / d
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            if not inside.any():
                continue
            # perspective-correct interpolation in 1/z
            inv_z = w0 / zs[0] + w1 / zs[1] + w2 / zs[2]
            pz = 1.0 / np.maximum(inv_z, 1e-12)
            yy, xx = np.nonzero(inside)
            ty, tx = yy + y0, xx + x0
            closer = pz[yy, xx] < zbuf[ty, tx]
            yy, xx, ty, tx = yy[closer], xx[closer], ty[closer], tx[closer]
            if len(yy) == 0:
                continue
            bw = np.stack([w0[yy, xx], w1[yy, xx], w2[yy, xx]], -1)
            bw_pc = (bw / zs[None, :]) * pz[yy, xx][:, None]

            pts = bw_pc @ verts[f]
            fn = np.cross(verts[f[1]] - verts[f[0]], verts[f[2]] - verts[f[0]])
            nrm = np.linalg.norm(fn)
            fn = fn / (nrm if nrm > 1e-12 else 1.0)
            if uvs is not None and tex is not None:
                uv = bw_pc @ uvs[f]
                th, tw = tex.shape[:2]
                ui = np.clip((uv[:, 0] * (tw - 1)).astype(int), 0, tw - 1)
                vi = np.clip(((1 - uv[:, 1]) * (th - 1)).astype(int), 0,
                             th - 1)
                albedo = tex[vi, ui, :3].astype(np.float64) / 255.0
            else:
                albedo = np.full((len(yy), 3), 0.7)
            color = _phong(pts, np.broadcast_to(fn, pts.shape), albedo,
                           np.asarray(light_location, np.float64), cam_pos)
            zbuf[ty, tx] = pz[yy, xx]
            img[ty, tx] = color
    return img.astype(np.float32)


def render_img(output_dir: str, meshes: Sequence[TexturedMesh],
               uv_maps: Optional[Sequence[np.ndarray]] = None,
               image_size: Tuple[int, int] = (480, 640)) -> np.ndarray:
    """Reference-CLI-compatible entry (`arti_vis.py:410-465`): render the
    scene and write `render_0.png` into output_dir; returns the image."""
    if uv_maps is not None:
        meshes = list(meshes)
        for i, (m, uv) in enumerate(zip(meshes, uv_maps)):
            if m.uv_map is None and uv is not None:
                meshes[i] = TexturedMesh(m.verts, m.faces, m.verts_uvs, uv)
    img = render_meshes(meshes, image_size=image_size)
    out = (img * 255.0).astype(np.uint8)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        cv2.imwrite(os.path.join(output_dir, "render_0.png"),
                    out[:, :, ::-1])
    return out
