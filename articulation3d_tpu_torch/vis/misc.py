"""Misc visualization: normal-sphere plots, affinity heatmaps, match drawing.

Counterpart of `articulation3d_tpu/vis/misc.py`, which re-implements the
reference's `visualization/` package (`visualization/unit_vector_plot.py:8-61`,
`visualization/visualization.py:55-334`) without its heavy dependencies:

  * the qutip Bloch sphere becomes a 3D unit sphere with the same view
    and the same output contract (uint8 canvas, the plot centered on
    white);
  * the seaborn affinity heatmap becomes a colormapped grid with text
    annotations, the same vmin/vmax and the '*' that marks the matching;
  * match and box drawing (PIL) keeps the reference's colors, dot styles,
    double-stroke lines and vertical/horizontal concatenation.

The JAX package draws the first two with matplotlib, which the machines
that run this port on the card do not have: here OpenCV draws them through
matplotlib's own projection and axes geometry, equal to JAX's images
within a stated geometric tolerance, not pixel for pixel (ROADMAP.md
section 3; `tests/test_torch_misc_vis.py`).  `fig2data` still renders a
matplotlib figure it is given.  PIL is imported where it is used, as in
the JAX package.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import cv2
import numpy as np

# the reference's category colormap + purple dot palette
# (visualization.py:17-50)
CMAP = [
    [255, 192, 0], [112, 48, 160], [0, 176, 80], [255, 0, 0],
    [91, 155, 213], [237, 125, 49], [197, 90, 17], [255, 255, 0],
    [112, 173, 71], [37, 94, 145], [155, 194, 230], [169, 209, 142],
    [84, 130, 53], [237, 125, 49], [247, 150, 70], [226, 107, 10],
]
PURPLES = [[204, 192, 218], [176, 163, 190], [148, 134, 163],
           [120, 106, 135], [64, 49, 80]]


def fig2data(fig) -> np.ndarray:
    """Matplotlib figure -> (H, W, 4) RGBA uint8 (reference
    `unit_vector_plot.py:8-24`)."""
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.asarray(fig.canvas.buffer_rgba(), dtype=np.uint8)
    return buf.reshape(h, w, 4)


# mplot3d's projection of `articulation3d_tpu.vis.misc.get_normal_figure`'s
# figure (5x5 in at 100 dpi, view elev 30 azim -200, box aspect 1, axes
# off) with the axes limits +-1.1458333 on x, y and z: world (x, y, z, 1) ->
# homogeneous display pixels (x right, y up) of the 500x500 canvas.
_SPHERE_CANVAS = 500
_SPHERE_VIEW = np.array([
    [-2.3957577598483994e+01, -9.7607204083887197e+01, -6.2763003265742228e+00,
     2.6145270270270271e+02],
    [5.6817977694737735e+01, -2.0680052652085550e+01, 8.0462453829588668e+01,
     2.5270270270270262e+02],
    [3.9071224740991152e-02, -1.4220762822045988e-02, -2.4005490330352368e-02,
     1.0]])
# without a scatter mplot3d gives z no 5 % margin: limits +-1.0416667, so the
# z column scales by 1.1458333 / 1.0416667
_Z_WITHOUT_SCATTER = 1.1


def _sphere_pixels(points: np.ndarray, z_scale: float) -> np.ndarray:
    """(N, 3) world points -> (N, 2) cv2 pixel coordinates (x, row) of the
    500x500 canvas (cv2 puts pixel centers on integers, the display grid
    on pixel edges)."""
    view = _SPHERE_VIEW.copy()
    view[:, 2] *= z_scale
    h = view @ np.concatenate([points, np.ones((len(points), 1))], 1).T
    x, y = h[0] / h[2], h[1] / h[2]
    return np.stack([x - 0.5, _SPHERE_CANVAS - y - 0.5], 1)


def _polyline(img, pts, color, thickness):
    fixed = np.round(np.asarray(pts) * 16).astype(np.int32)       # 4 fractional bits
    cv2.polylines(img, [fixed], False, color, thickness, cv2.LINE_AA, shift=4)


def _arrow_heads(n: np.ndarray) -> np.ndarray:
    """mplot3d quiver's two head directions for a shaft direction n: n
    turned by +-15 degrees about the horizontal axis perpendicular to it."""
    norm = np.linalg.norm(n[:2])
    xp, yp = (n[1] / norm, -n[0] / norm) if norm != 0 else (0.0, 1.0)
    c, s = np.cos(np.radians(15)), np.sin(np.radians(15))
    rpos = np.array([[c + xp ** 2 * (1 - c), xp * yp * (1 - c), yp * s],
                     [xp * yp * (1 - c), c + yp ** 2 * (1 - c), -xp * s],
                     [-yp * s, xp * s, c]])
    rneg = rpos.copy()
    rneg[[0, 1, 2, 2], [2, 2, 0, 1]] *= -1
    return np.stack([rpos @ n, rneg @ n])


def get_normal_figure(normal, history_normals: Sequence = (),
                      output_size=(480, 640)) -> np.ndarray:
    """Unit-sphere plot of plane normals (reference `get_normal_figure`,
    `unit_vector_plot.py:26-61`), drawn with OpenCV: the JAX package's
    matplotlib 3D sphere (view [-200, 30]) through the same projection
    (`_SPHERE_VIEW`): the light-gray 25x25 wireframe, one green arrow per
    normal (head 0.15 of its length at +-15 degrees), blue dots for the
    history; a 500x500 canvas resized to fit and centered on white."""
    canvas = np.full((_SPHERE_CANVAS, _SPHERE_CANVAS, 3), 255, np.uint8)
    history = [np.asarray(hn, np.float64).reshape(-1, 3) for hn in history_normals]
    history = [hn for hn in history if len(hn)]
    z_scale = 1.0 if history else _Z_WITHOUT_SCATTER
    u = np.linspace(0, 2 * np.pi, 25)
    v = np.linspace(0, np.pi, 25)
    grid = np.stack([np.outer(np.cos(u), np.sin(v)), np.outer(np.sin(u), np.sin(v)),
                     np.outer(np.ones_like(u), np.cos(v))], -1)          # (25, 25, 3)
    # a 0.3 pt light-gray (211) line covers about 0.42 px of its pixels
    wire = (237, 237, 237)
    for line in list(grid) + list(grid.transpose(1, 0, 2)):
        _polyline(canvas, _sphere_pixels(line, z_scale), wire, 1)
    normal = np.asarray(normal, np.float64)
    green = (0, 128, 0)
    for n in (normal.reshape(-1, 3) if normal.size else np.zeros((0, 3))):
        tip = n
        _polyline(canvas, _sphere_pixels(np.stack([tip, np.zeros(3)]), z_scale), green, 2)
        for head in _arrow_heads(n):
            _polyline(canvas, _sphere_pixels(np.stack([tip, tip - 0.15 * head]), z_scale),
                      green, 2)
    for hn in history:
        for x, y in _sphere_pixels(hn, z_scale):
            cv2.circle(canvas, (int(round(x * 16)), int(round(y * 16))), 38, (0, 0, 255),
                       -1, cv2.LINE_AA, shift=4)         # s=12 pt^2: 2.4 px radius

    ht, wd = canvas.shape[:2]
    resize_side = min(output_size[0], output_size[1], ht, wd)
    img = cv2.resize(canvas, (resize_side, resize_side))
    result = np.full((output_size[0], output_size[1], 3), 255, np.uint8)
    xx = (output_size[1] - resize_side) // 2
    yy = (output_size[0] - resize_side) // 2
    result[yy:yy + resize_side, xx:xx + resize_side] = img
    return result


def _heatmap_box(rows: int, cols: int, width: int = 640, height: int = 480):
    """matplotlib's axes box for `imshow` of a rows x cols image in a
    default figure: the subplot (left 0.125, bottom 0.11, width 0.775,
    height 0.77) shrunk to the image's aspect, centered.  Returns
    (x0, y0, x1, y1) in pixel-edge coordinates, y from the top."""
    bw, bh = 0.775 * width, 0.77 * height
    x0, y0 = 0.125 * width, (1 - 0.11 - 0.77) * height
    if cols / rows < bw / bh:
        w = bh * cols / rows
        return x0 + (bw - w) / 2, y0, x0 + (bw + w) / 2, y0 + bh
    h = bw * rows / cols
    return x0, y0 + (bh - h) / 2, x0 + bw, y0 + (bh + h) / 2


def _put_centered(img, text, center, scale, color, thickness=1):
    (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
    org = (int(round(center[0] - tw / 2)), int(round(center[1] + th / 2)))
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness,
                cv2.LINE_AA)


def save_affinity_after_stitch(affinity_pred: np.ndarray, sz_i: int,
                               sz_j: int, matching: Sequence[int],
                               mesh_dir: str) -> str:
    """Annotated affinity heatmap ('*' marks the match, value in each cell),
    reference `save_affinity_after_stitch` (visualization.py:55-79), drawn
    with OpenCV: the JAX package's 640x480 matplotlib figure with the
    cells in the same axes box, colored by the same magma colormap
    (vmin 0, vmax 1; seaborn's "rocket" is not a dependency), a black
    frame, a tick and label at each cell center, and the white annotations."""
    max_sz = max(sz_i, sz_j)
    max_sz = 5 if max_sz < 5 else (10 if max_sz < 10 else max_sz)
    affinity_vis = np.asarray(affinity_pred, np.float64)[:max_sz, :max_sz]
    rows, cols = affinity_vis.shape
    img = np.full((480, 640, 3), 255, np.uint8)
    x0, y0, x1, y1 = _heatmap_box(rows, cols)
    cw, ch = (x1 - x0) / cols, (y1 - y0) / rows
    # matplotlib's Colormap lookup: index floor(v * 256), clipped to 255
    idx = np.clip((np.clip(affinity_vis, 0.0, 1.0) * 256).astype(int), 0, 255)
    colors = cv2.applyColorMap(idx.astype(np.uint8), cv2.COLORMAP_MAGMA)   # BGR
    for i in range(rows):
        for j in range(cols):
            r0, r1 = int(round(y0 + i * ch)), int(round(y0 + (i + 1) * ch))
            c0, c1 = int(round(x0 + j * cw)), int(round(x0 + (j + 1) * cw))
            img[r0:r1, c0:c1] = colors[i, j]
    frame = (int(round(x0)), int(round(y0)), int(round(x1)) - 1, int(round(y1)) - 1)
    cv2.rectangle(img, frame[:2], frame[2:], (0, 0, 0), 1)
    for j in range(cols):
        cx = x0 + (j + 0.5) * cw
        cv2.line(img, (int(round(cx)), frame[3]), (int(round(cx)), frame[3] + 5), (0, 0, 0), 1)
        _put_centered(img, str(j), (cx, frame[3] + 16), 0.45, (0, 0, 0))
    for i in range(rows):
        cy = y0 + (i + 0.5) * ch
        cv2.line(img, (frame[0] - 5, int(round(cy))), (frame[0], int(round(cy))), (0, 0, 0), 1)
        _put_centered(img, str(i), (frame[0] - 14, cy), 0.45, (0, 0, 0))
    for i in range(min(sz_i, max_sz)):
        for j in range(min(sz_j, max_sz)):
            cx, cy = x0 + (j + 0.5) * cw, y0 + (i + 0.5) * ch
            value = f"{affinity_pred[i][j]:.2f}"
            if i < len(matching) and matching[i] == j:
                _put_centered(img, "*", (cx, cy - 7), 0.3, (255, 255, 255))
                _put_centered(img, value, (cx, cy + 5), 0.3, (255, 255, 255))
            else:
                _put_centered(img, value, (cx, cy), 0.3, (255, 255, 255))
    out = os.path.join(mesh_dir, "affinity_pred.png")
    cv2.imwrite(out, img)
    return out


def get_loc_white(bbox):
    x1, y1, x2, y2 = bbox
    return [x1 + 4, y1 + 4, x2 - 4, y2 - 4]


def get_concat_v(im1, im2, distance: int = 50, vertical: bool = True):
    """Stack two PIL images with a gap (visualization.py:120-128)."""
    from PIL import Image
    if vertical:
        dst = Image.new("RGBA", (im1.width, im1.height + distance + im2.height),
                        (255, 0, 0, 0))
        dst.paste(im2, (0, distance + im1.height))
    else:
        dst = Image.new("RGBA", (im1.width + distance + im2.width, im1.height),
                        (255, 0, 0, 0))
        dst.paste(im2, (distance + im1.width, 0))
    dst.paste(im1, (0, 0))
    return dst


def draw_dot(d, center, color, factor, dotsize: int = 20):
    """Two-ring dot marker (visualization.py:151-157)."""
    oo = int(dotsize * factor)
    io = int(dotsize / 20 * 16 * factor)
    d.ellipse((center[0] - oo, center[1] - oo, center[0] + oo, center[1] + oo),
              fill=tuple(color), outline=tuple(color),
              width=int(dotsize / 20 * 5 * factor))
    d.ellipse((center[0] - io, center[1] - io, center[0] + io, center[1] + io),
              fill=None, outline=(255, 255, 255),
              width=int(dotsize / 20 * 4 * factor))


def draw_bbox(img1, img2, bbox1, bbox2, matching_proposals):
    """Paired-box drawing across two images (visualization.py:96-117)."""
    from PIL import ImageDraw
    d1 = ImageDraw.Draw(img1)
    d2 = ImageDraw.Draw(img2)
    cmap_idx = 0
    for idx1, idx2 in enumerate(matching_proposals):
        if idx2 == -1:
            d1.rectangle(list(bbox1[idx1]), fill=None, outline=(0, 0, 0),
                         width=5)
        else:
            c = tuple(CMAP[cmap_idx % len(CMAP)])
            d1.rectangle(list(bbox1[idx1]), fill=None, outline=c, width=10)
            d1.rectangle(get_loc_white(bbox1[idx1]), fill=None,
                         outline=(255, 255, 255), width=2)
            d2.rectangle(list(bbox2[idx2]), fill=None, outline=c, width=10)
            d2.rectangle(get_loc_white(bbox2[idx2]), fill=None,
                         outline=(255, 255, 255), width=2)
            cmap_idx += 1
    for idx, box in enumerate(bbox2):
        if idx not in matching_proposals:
            d2.rectangle(list(box), fill=None, outline=(0, 0, 0), width=5)
    return img1, img2


def draw_match(img1, img2, centers1, centers2, matching_proposals,
               correct_list, distance: int = 45, factor: int = 4,
               vertical: bool = True, dotsize: int = 20,
               outlier_color=None):
    """Cross-image correspondence drawing (visualization.py:160-250):
    black dots for unmatched, double-stroke colored lines (blue = correct,
    red = outlier) and purple dots for matches.

    img1/img2: paths or HxWx3 arrays; centers1/2: (N, 2) pixel centers;
    matching_proposals: (M, 2) index pairs; correct_list: (M,) 1/0.
    """
    from PIL import Image, ImageDraw

    def load(im):
        return Image.open(im) if isinstance(im, str) else Image.fromarray(im)

    img1, img2 = load(img1), load(img2)
    img1 = img1.resize((img1.width * factor, img1.height * factor))
    img2 = img2.resize((img2.width * factor, img2.height * factor))
    centers1 = [np.floor(np.asarray(c) * factor).astype(np.int32)
                for c in np.asarray(centers1)]
    centers2 = [np.floor(np.asarray(c) * factor).astype(np.int32)
                for c in np.asarray(centers2)]
    distance *= factor
    matching_proposals = np.asarray(matching_proposals).reshape(-1, 2)

    concat = get_concat_v(img1, img2, distance, vertical)
    d = ImageDraw.Draw(concat)
    offset = distance + (img1.height if vertical else img1.width)
    shift = np.array([0, offset]) if vertical else np.array([offset, 0])

    matched1 = set(matching_proposals[:, 0].tolist()) if len(matching_proposals) else set()
    matched2 = set(matching_proposals[:, 1].tolist()) if len(matching_proposals) else set()
    for i, c in enumerate(centers1):
        if i not in matched1:
            draw_dot(d, c, (0, 0, 0), factor, dotsize=dotsize)
    for j, c in enumerate(centers2):
        if j not in matched2:
            draw_dot(d, c + shift, (0, 0, 0), factor, dotsize=dotsize)

    for (i, j), ok in zip(matching_proposals, correct_list):
        color = [26, 133, 255] if ok == 1 else (
            outlier_color if outlier_color is not None else [212, 17, 89])
        c2 = centers2[j] + shift
        line = (int(centers1[i][0]), int(centers1[i][1]),
                int(c2[0]), int(c2[1]))
        d.line(line, fill=tuple(color), width=7 * factor)
        d.line(line, fill=(255, 255, 255), width=2 * factor)

    for i, j in matching_proposals:
        draw_dot(d, centers1[i], PURPLES[-1], factor, dotsize=dotsize)
        draw_dot(d, list(centers2[j] + shift), PURPLES[-1], factor,
                 dotsize=dotsize)
    return concat


def get_labeled_seg(p, score_threshold: float, vis,
                    assigned_colors: Optional[List] = None,
                    paper_img: bool = False) -> np.ndarray:
    """Indexed-score instance overlay (visualization.py:276-306) on our
    ArtiVisualizer: labels are 'idx: score'."""
    keep = np.nonzero(p.scores > score_threshold)[0]
    labels = [f"{idx}: {p.scores[i]:.2f}" for idx, i in enumerate(keep)]
    boxes = p.boxes[keep]
    masks = p.masks[keep] if p.masks is not None else None
    if paper_img:
        boxes, labels = None, None
    vis.overlay_instances(boxes=boxes, labels=labels, masks=masks,
                          assigned_colors=assigned_colors, alpha=0.5)
    return vis.output.get_image()


def get_gt_labeled_seg(dic, vis, assigned_colors: Optional[List] = None,
                       paper_img: bool = False) -> np.ndarray:
    """GT overlay from a dataset dict (visualization.py:309-334)."""
    annos = dic.get("annotations", None)
    if annos:
        from ..data.mapper import BOXMODE_XYWH_ABS
        boxes = []
        for x in annos:
            b = np.asarray(x["bbox"], np.float64)
            if int(x.get("bbox_mode", 0)) == BOXMODE_XYWH_ABS:
                b = np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]])
            boxes.append(b)
        labels = [f"{idx}: gt" for idx in range(len(annos))]
        if paper_img:
            labels, boxes = None, None
        vis.overlay_instances(labels=labels,
                              boxes=np.asarray(boxes) if boxes else None,
                              assigned_colors=assigned_colors)
    return vis.output.get_image()
