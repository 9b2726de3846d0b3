"""Visualization: instance and axis overlays, normal maps (cv2)."""

from .visualizer import (ArtiVisualizer, draw_gt, draw_pred, get_normal_map,  # noqa: F401
                         random_colors, vis_surface_normal)
