"""Temporal articulation pipeline: tracker, RANSAC optimizer, device sweeps."""

from .kernels import iou_matrix, rotation_sweep, transform_normals, translation_sweep  # noqa: F401
from .optimizer import (check_axis, check_monotonic, fit_plane_from_normals,  # noqa: F401
                        optimize_planes, optimize_planes_3d_trans, optimize_planes_3dc,
                        optimize_planes_average)
from .tracker import track_planes  # noqa: F401
