"""Plane-benchmark evaluator on ScanNet (counterpart of
`articulation3d_tpu/evaluation/scannet_evaluation.py`, the reference's
`evaluation/scannet_evaluation.py:33-450`).

Per category: box AP, mask AP (COCO-RLE mask IoU), and plane AP (TP = label
match, normal error < 30 deg, offset error < 0.3), plus normal/offset error
statistics and a masked depth-L1 metric.  `override_depth` re-estimates each
detection's plane offset from the predicted depth inside its mask using the
EVAL intrinsics (f = 571.623718, principal (319.5, 239.5)), keeping the
reference's double ScanNet<->SunCG swap sequence verbatim
(`scannet_evaluation.py:140-163`).  With `distributed=True` every process
feeds its own share of the images; `evaluate` gathers the predictions in
rank order and the main process computes the results, the others return
an empty dict.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..data.catalog import get_metadata
from ..parallel.dist import gather_predictions, is_main_process
from ..utils.camera import get_k_inv_dot_xy_1_eval
from ..utils.metrics import compare_planes
from ..utils.rle import mask_iou, rle_decode, rle_encode
from ..utils.vocap import compute_ap
from .arti_evaluation import _pairwise_iou, _xywh_to_xyxy
from .coco_index import CocoIndex
from .detectron2coco import convert_to_coco_dict

logger = logging.getLogger(__name__)


def l1_loss_mask(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    return float(np.sum(np.abs(pred - gt) * mask) / max(mask.sum(), 1.0))


def get_depth_err(pred_depth: np.ndarray, gt_depth: np.ndarray) -> float:
    return l1_loss_mask(pred_depth, gt_depth, (gt_depth > 1e-4).astype(np.float64))


def _gt_rle(ann: Dict, height: int, width: int) -> Dict:
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return seg
    from ..data.mapper import polygons_to_bitmask
    return rle_encode(polygons_to_bitmask(seg, height, width))


def evaluate_for_planes(predictions: Sequence[Dict], dataset: CocoIndex,
                        metadata, filter_iou: float, iou_thresh: float = 0.5,
                        normal_threshold: float = 30.0,
                        offset_threshold: float = 0.3) -> Dict[str, float]:
    cat_ids = sorted(dataset.getCatIds())
    reverse = {v: k for k, v in metadata.thing_dataset_id_to_contiguous_id.items()}

    box_s = {c: [] for c in cat_ids}
    box_l = {c: [] for c in cat_ids}
    mask_s = {c: [] for c in cat_ids}
    mask_l = {c: [] for c in cat_ids}
    plane_s = {c: [] for c in cat_ids}
    plane_l = {c: [] for c in cat_ids}
    plane_offset_errs, plane_normal_errs = [], []
    npos = {c: 0.0 for c in cat_ids}
    for gt_ann in dataset.dataset["annotations"]:
        npos[gt_ann["category_id"]] += 1.0

    for prediction in predictions:
        original_id = prediction["image_id"]
        img = dataset.loadImgs([original_id])[0]
        instances = prediction.get("instances", [])
        if len(instances) == 0:
            continue

        scores = np.array([ins["score"] for ins in instances])
        boxes = _xywh_to_xyxy([ins["bbox"] for ins in instances])
        labels = [ins["category_id"] for ins in instances]
        masks_rles = [ins["segmentation"] for ins in instances]
        planes = np.asarray(prediction["pred_plane"], np.float64)

        gt_anns = dataset.loadAnns(dataset.getAnnIds(imgIds=[original_id]))
        if len(gt_anns) == 0:
            continue
        gt_boxes = _xywh_to_xyxy([a["bbox"] for a in gt_anns])
        gt_labels = [a["category_id"] for a in gt_anns]
        gt_mask_rles = [_gt_rle(a, img["height"], img["width"]) for a in gt_anns]
        gt_planes = [a["plane"] for a in gt_anns]

        boxiou = _pairwise_iou(boxes, gt_boxes)
        miou = mask_iou(masks_rles, gt_mask_rles, iscrowd=[0] * len(gt_mask_rles))
        plane_metrics = compare_planes(planes, gt_planes)

        idx_sorted = np.argsort(-scores, kind="stable")
        box_covered: List[int] = []
        mask_covered: List[int] = []
        plane_covered: List[int] = []

        for rank in range(len(scores)):
            i = idx_sorted[rank]
            gt_id = int(np.argmax(boxiou[i]))
            gt_label = gt_labels[gt_id]
            pred_label = reverse[labels[i]]
            pred_miou = miou[i, gt_id]
            pred_biou = boxiou[i, gt_id]
            pred_score = scores[i]

            normal = float(plane_metrics["norm"][i, gt_id])
            offset = float(plane_metrics["offset"][i, gt_id])
            plane_offset_errs.append(offset)
            plane_normal_errs.append(normal)

            tp = (pred_label == gt_label and pred_miou > iou_thresh
                  and gt_id not in mask_covered)
            if tp:
                mask_covered.append(gt_id)
            mask_s[pred_label].append(pred_score)
            mask_l[pred_label].append(1 if tp else 0)

            tp = (pred_label == gt_label and pred_biou > iou_thresh
                  and gt_id not in box_covered)
            if tp:
                box_covered.append(gt_id)
            box_s[pred_label].append(pred_score)
            box_l[pred_label].append(1 if tp else 0)

            tp = (pred_label == gt_label and normal < normal_threshold
                  and offset < offset_threshold and gt_id not in plane_covered)
            if tp:
                plane_covered.append(gt_id)
            plane_s[pred_label].append(pred_score)
            plane_l[pred_label].append(1 if tp else 0)

    detection_metrics = {}
    boxap = maskap = planeap = 0.0
    valid = 0.0
    plane_key = "plane_ap@iou%.1fnormal%.1foffset%.1f" % (
        iou_thresh, normal_threshold, offset_threshold)
    for cat_id in cat_ids:
        if npos[cat_id] == 0:
            continue
        valid += 1
        cat_name = dataset.loadCats([cat_id])[0]["name"]
        ap = compute_ap(np.asarray(box_s[cat_id]), np.asarray(box_l[cat_id]),
                        npos[cat_id])
        boxap += ap
        detection_metrics["box_ap@%.1f - %s" % (iou_thresh, cat_name)] = ap
        ap = compute_ap(np.asarray(mask_s[cat_id]), np.asarray(mask_l[cat_id]),
                        npos[cat_id])
        maskap += ap
        detection_metrics["mask_ap@%.1f - %s" % (iou_thresh, cat_name)] = ap
        ap = compute_ap(np.asarray(plane_s[cat_id]), np.asarray(plane_l[cat_id]),
                        npos[cat_id])
        planeap += ap
        detection_metrics[f"{plane_key} - {cat_name}"] = ap
    detection_metrics["box_ap@%.1f" % iou_thresh] = boxap / valid
    detection_metrics["mask_ap@%.1f" % iou_thresh] = maskap / valid
    detection_metrics[plane_key] = planeap / valid

    plane_stats = {}
    ne = np.array(plane_normal_errs)
    oe = np.array(plane_offset_errs)
    if len(ne):
        plane_stats["%normal<10"] = float((ne < 10).sum() / len(ne) * 100)
        plane_stats["%normal<30"] = float((ne < 30).sum() / len(ne) * 100)
        plane_stats["%offset<0.5"] = float((oe < 0.5).sum() / len(oe) * 100)
        plane_stats["%offset<0.3"] = float((oe < 0.3).sum() / len(oe) * 100)
        plane_stats["mean_normal"] = float(ne.mean())
        plane_stats["median_normal"] = float(np.median(ne))
        plane_stats["mean_offset"] = float(oe.mean())
        plane_stats["median_offset"] = float(np.median(oe))
    logger.info("Plane metrics: %s", plane_stats)
    plane_stats.update(detection_metrics)
    return plane_stats


class ScannetEvaluator:
    """reset/process/evaluate evaluator for the ScanNet plane benchmark."""

    def __init__(self, dataset_name: str, cfg: Optional[Config] = None,
                 distributed: bool = False, output_dir: Optional[str] = None):
        self.cfg = cfg
        self._distributed = distributed
        self._output_dir = output_dir
        self._metadata = get_metadata(dataset_name)
        self._filter_iou = 0.7
        self._refine_on = bool(cfg and cfg.model.refine_on)
        import json
        with open(self._metadata.json_file) as f:
            d2_data = json.load(f)
        self._coco_api = CocoIndex(convert_to_coco_dict(d2_data["data"],
                                                        self._metadata))
        self._k_inv_dot_xy_1 = get_k_inv_dot_xy_1_eval().reshape(3, 480, 640)
        self._predictions: List[Dict] = []

    def reset(self):
        self._predictions = []

    def depth2XYZ(self, depth: np.ndarray) -> np.ndarray:
        """(480, 640) depth -> (3, 480, 640) camera XYZ (EVAL intrinsics)."""
        return self._k_inv_dot_xy_1 * depth

    def override_depth(self, xyz: np.ndarray, instance: Dict) -> Dict:
        """Re-estimate plane offsets from predicted depth inside each mask
        (`scannet_evaluation.py:140-163`) — including the reference's
        asymmetric inverse swap (negating index 2, not 1)."""
        pred_masks = [p["segmentation"] for p in instance["instances"]]
        plane_params = np.asarray(instance["pred_plane"], np.float64).copy()
        # scannet -> suncg
        plane_params = np.stack([plane_params[:, 0], -plane_params[:, 2],
                                 plane_params[:, 1]], axis=1)
        override = []
        for mask, plane in zip(pred_masks, plane_params):
            bimask = rle_decode(mask).astype(bool)
            if bimask.sum() == 0:
                override.append(plane)
                continue
            pts = xyz[:, bimask]
            offset = np.linalg.norm(plane)
            normal = plane / max(offset, 1e-8)
            offset_new = (normal @ pts).mean()
            override.append(normal * offset_new)
        if override:
            ov = np.stack(override)
            ov = np.stack([ov[:, 0], ov[:, 2], ov[:, 1]], axis=1)
            ov[:, 2] = -ov[:, 2]
            instance["pred_plane"] = ov
        return instance

    def process(self, inputs: Sequence[Dict], outputs: Sequence[Dict]):
        for inp, out in zip(inputs, outputs):
            prediction = {"image_id": inp["image_id"],
                          "file_name": inp.get("file_name")}
            if "instances" in out:
                prediction["instances"] = out["instances"]
                if out.get("pred_plane") is not None:
                    prediction["pred_plane"] = out["pred_plane"]
            if out.get("depth") is not None and not self._refine_on:
                depth = np.asarray(out["depth"])
                prediction["pred_depth"] = depth
                prediction = self.override_depth(self.depth2XYZ(depth),
                                                 prediction)
                if inp.get("depth") is not None:
                    prediction["depth_l1_dist"] = get_depth_err(
                        depth, np.asarray(inp["depth"]))
            self._predictions.append(prediction)

    def evaluate(self) -> "OrderedDict[str, float]":
        predictions = self._predictions
        if self._distributed:
            predictions = gather_predictions(predictions)
            if not is_main_process():
                return OrderedDict()
        if len(predictions) == 0:
            logger.warning("ScannetEvaluator received no predictions")
            return OrderedDict()

        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            import torch
            torch.save(predictions, os.path.join(self._output_dir,
                                                 "instances_predictions.pth"))

        results = OrderedDict()
        if "instances" in predictions[0]:
            results.update(evaluate_for_planes(
                predictions, self._coco_api, self._metadata, self._filter_iou))
        if "depth_l1_dist" in predictions[0]:
            results["depth_l1_dist"] = float(np.mean(
                [p["depth_l1_dist"] for p in predictions]))
        if results:
            from ..utils.tables import create_small_table
            finite = {k: v for k, v in results.items()
                      if isinstance(v, (int, float))}
            logger.info("ScannetEvaluator results:\n%s",
                        create_small_table(finite))
        return results
