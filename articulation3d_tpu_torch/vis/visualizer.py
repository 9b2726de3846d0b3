"""2D visualization: instance overlays + articulation axis arrows (cv2).

Counterpart of `articulation3d_tpu/vis/visualizer.py`, which re-implements the reference's matplotlib/detectron2 visualization stack
(`utils/visualizer.py:8-31` ArtiVisualizer.draw_arrow, `utils/arti_vis.py:
196-405` draw_pred/draw_gt/get_pred_labeled/get_normal_map) on plain OpenCV:
no GUI dependencies, identical geometry — axis segments are decoded inside
each box's local frame (center (w/2, h/2), bounds H=h_box, W=w_box) then
shifted by the box origin, exactly as the reference does.

Images flow as RGB uint8 (the reference's d2 Visualizer convention).
"""

from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

from ..data.axis_codec import angle_offset_to_axis
from ..data.catalog import DatasetMetadata
from ..structures import FramePrediction


def random_colors(n: int, bright: bool = True) -> List:
    """HSV-spread distinct colors (reference `utils/vis.py:24-34`)."""
    brightness = 1.0 if bright else 0.7
    hsv = [(i / n, 1, brightness) for i in range(n)]
    colors = [colorsys.hsv_to_rgb(*c) for c in hsv]
    np.random.shuffle(colors)
    return colors


class VisImage:
    def __init__(self, img: np.ndarray):
        self.img = img

    def get_image(self) -> np.ndarray:
        return self.img


class ArtiVisualizer:
    """cv2-based stand-in for d2 Visualizer + draw_arrow."""

    def __init__(self, img_rgb: np.ndarray, scale: float = 1.0):
        # always COPY: d2's Visualizer never mutates the input image, and
        # np.asarray aliases an already-uint8 array (drawing would corrupt
        # the caller's frame)
        self.output = VisImage(np.array(img_rgb, np.uint8, copy=True,
                                        order="C"))
        self.scale = scale
        h, w = self.output.img.shape[:2]
        self._default_font_size = max(np.sqrt(h * w) // 90, 10)

    @staticmethod
    def _c255(color) -> tuple:
        c = np.asarray(color, np.float64)
        if c.max() <= 1.0:
            c = c * 255
        return tuple(int(v) for v in c[:3])

    def draw_arrow(self, x_data, y_data, color, linestyle="-",
                   linewidth: Optional[float] = None) -> VisImage:
        if linewidth is None:
            linewidth = self._default_font_size / 3
        linewidth = max(int(linewidth), 1)
        p0 = (int(x_data[0]), int(y_data[0]))
        p1 = (int(x_data[1]), int(y_data[1]))
        cv2.arrowedLine(self.output.img, p0, p1, self._c255(color),
                        thickness=max(1, linewidth // 2), tipLength=0.08)
        return self.output

    def overlay_instances(self, boxes=None, labels=None, masks=None,
                          assigned_colors=None, alpha: float = 0.5) -> VisImage:
        img = self.output.img
        n = 0
        for coll in (boxes, labels, masks):
            if coll is not None:
                n = max(n, len(coll))
        if assigned_colors is None:
            assigned_colors = random_colors(max(n, 1))
        if masks is not None:
            overlay = img.astype(np.float32)
            for i, m in enumerate(masks):
                m = np.asarray(m) > 0.5
                color = np.asarray(self._c255(assigned_colors[i]), np.float32)
                overlay[m] = overlay[m] * (1 - alpha) + color * alpha
            img[:] = overlay.astype(np.uint8)
        if boxes is not None:
            for i, b in enumerate(boxes):
                b = np.asarray(b, np.float64)
                cv2.rectangle(img, (int(b[0]), int(b[1])),
                              (int(b[2]), int(b[3])),
                              self._c255(assigned_colors[i]), 2)
                if labels is not None and i < len(labels) and labels[i]:
                    cv2.putText(img, str(labels[i]),
                                (int(b[0]), max(int(b[1]) - 4, 10)),
                                cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                                self._c255(assigned_colors[i]), 1,
                                cv2.LINE_AA)
        return self.output


def _axis_segment_in_box(params3: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Decode (sin, cos, offset) inside the box's local frame, then shift
    (reference `arti_vis.py:368-388`)."""
    w_box = float(box[2] - box[0])
    h_box = float(box[3] - box[1])
    pts = angle_offset_to_axis(np.asarray(params3, np.float64)[None],
                               np.array([[w_box / 2, h_box / 2]]),
                               H=h_box, W=w_box).astype(np.float64)[0]
    pts[[0, 2]] += box[0]
    pts[[1, 3]] += box[1]
    return pts


def draw_pred(vis: ArtiVisualizer, p: FramePrediction,
              metadata: DatasetMetadata, cls_name_map: Sequence[str],
              conf_threshold: float = 0.7) -> np.ndarray:
    """Draw predictions + axis arrows (reference `draw_pred`,
    `arti_vis.py:364-405`)."""
    assigned_colors = []
    for i in range(len(p)):
        cls = int(p.classes[i])
        color = tuple(c / 255 for c in metadata.thing_colors[cls])
        assigned_colors.append(color)
        if metadata.thing_classes[cls] == "arti_rot":
            params = p.rot_axis[i]
        elif metadata.thing_classes[cls] == "arti_tran":
            params = np.concatenate([p.tran_axis[i], [0.0]])
        else:
            raise NotImplementedError(metadata.thing_classes[cls])
        pt = _axis_segment_in_box(params, p.boxes[i])
        vis.draw_arrow(x_data=[pt[0], pt[2]], y_data=[pt[1], pt[3]],
                       color=color)

    keep = p.scores > conf_threshold
    labels = [f"{idx}: {s:.2f}" for idx, s in enumerate(p.scores[keep])]
    vis.overlay_instances(boxes=p.boxes[keep], labels=labels,
                          assigned_colors=[c for c, k in
                                           zip(assigned_colors, keep) if k])
    return vis.output.get_image()


def draw_gt(vis: ArtiVisualizer, d: Dict, metadata: DatasetMetadata,
            cls_name_map: Sequence[str]) -> np.ndarray:
    """Draw GT boxes/axes (reference `draw_gt`, `arti_vis.py:289-361`)."""
    from ..data.axis_codec import axis_to_angle_offset
    from ..data.mapper import convert_box
    annos = d.get("annotations", [])
    if not annos:
        return vis.output.get_image()
    assigned_colors, boxes, labels = [], [], []
    h_img, w_img = d["height"], d["width"]
    for anno in annos:
        box = convert_box(anno["bbox"], int(anno["bbox_mode"]))
        cls = int(anno["category_id"])
        color = tuple(c / 255 for c in metadata.thing_colors[cls])
        assigned_colors.append(color)
        boxes.append(box)
        labels.append(f"{cls_name_map[cls]}: gt")
        axis = (anno.get("rot_axis")
                if metadata.thing_classes[cls] == "arti_rot"
                else anno.get("tran_axis"))
        if axis is not None:
            center = (box[:2] + box[2:]) / 2
            enc = axis_to_angle_offset(np.asarray(axis, np.float64)[None],
                                       center[None])[0][:3]
            # enlarged box for a longer arrow (border_size 20, clipped)
            big = np.array([max(box[0] - 20, 0), max(box[1] - 20, 0),
                            min(box[2] + 20, w_img), min(box[3] + 20, h_img)])
            pt = _axis_segment_in_box(enc, big)
            vis.draw_arrow(x_data=[pt[0], pt[2]], y_data=[pt[1], pt[3]],
                           color=color)
    vis.overlay_instances(boxes=boxes, labels=labels,
                          assigned_colors=assigned_colors)
    return vis.output.get_image()


def vis_surface_normal(normal: np.ndarray) -> np.ndarray:
    """[-1, 1] normal map -> uint8 RGB (reference `arti_vis.py:196-199`)."""
    return ((np.asarray(normal) + 1.0) / 2.0 * 255.0).astype(np.uint8)


def get_normal_map(planes: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """(N, 3) planes + (N, H, W) masks -> (H, W, 3) normal visualization
    (reference `get_normal_map`, `arti_vis.py:202-213`)."""
    planes = np.asarray(planes, np.float64).reshape(-1, 3)
    masks = (np.asarray(masks) > 0.5).astype(np.float64)
    n = planes / np.maximum(np.linalg.norm(planes, axis=1, keepdims=True),
                            1e-12)
    normal_map = np.einsum("nhw,nc->hwc", masks, n)
    return vis_surface_normal(normal_map)
