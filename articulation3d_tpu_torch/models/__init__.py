"""PlaneRCNN and its parts, with detectron2 state-dict names."""

from .planercnn import PlaneRCNN, build_model  # noqa: F401
