"""Visualization: instance and axis overlays, normal maps (cv2), the debug
mesh renderer and the reference's misc plots."""

from .misc import (draw_bbox, draw_dot, draw_match, fig2data, get_concat_v,
                   get_gt_labeled_seg, get_labeled_seg, get_loc_white,
                   get_normal_figure, save_affinity_after_stitch)
from .render import look_at_view_transform, render_img, render_meshes
from .visualizer import (ArtiVisualizer, draw_gt, draw_pred, get_normal_map,
                         random_colors, vis_surface_normal)

__all__ = ["ArtiVisualizer", "draw_pred", "draw_gt", "get_normal_map",
           "vis_surface_normal", "random_colors", "render_img", "render_meshes",
           "look_at_view_transform", "fig2data", "get_normal_figure",
           "save_affinity_after_stitch", "get_loc_white", "get_concat_v",
           "draw_dot", "draw_bbox", "draw_match", "get_labeled_seg",
           "get_gt_labeled_seg"]
