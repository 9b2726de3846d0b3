"""Evaluation suite: articulation APs, ScanNet plane APs, COCO conversion."""

from .arti_evaluation import (ArtiEvaluator, evaluate_for_arti_axis,  # noqa: F401
                              evaluate_for_recognition, roc_auc)
from .coco_index import CocoIndex  # noqa: F401
from .detectron2coco import convert_to_coco_dict  # noqa: F401
from .scannet_evaluation import (ScannetEvaluator, evaluate_for_planes,  # noqa: F401
                                 get_depth_err)

__all__ = [
    "ArtiEvaluator", "ScannetEvaluator", "CocoIndex", "convert_to_coco_dict",
    "evaluate_for_arti_axis", "evaluate_for_recognition", "roc_auc",
    "evaluate_for_planes", "get_depth_err",
]
