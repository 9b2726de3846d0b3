"""Articulation detection evaluator (counterpart of
`articulation3d_tpu/evaluation/arti_evaluation.py`, the reference's
`evaluation/arti_evaluation.py`).

Computes, per category (arti_rot / arti_tran), four VOC-style APs —
``bbox``, ``bbox+axis`` (EA > 0.5), ``bbox+normal`` (< 30 deg),
``bbox+normal+axis`` — plus recognition AUROC/accuracy, with the reference's
exact matching protocol (`arti_evaluation.py:262-665`):

  * only predictions whose best GT box IoU exceeds ``filter_iou`` (0.7) are
    scored at all (no FP entries for non-overlapping predictions);
  * predictions are visited in descending score order; each is assigned its
    argmax-IoU GT; a GT can be covered once per metric;
  * axis EA uses boundary-decoded segments about box centers; invalid GT
    axes force EA = 0; degenerate predicted segments score 0 — including
    the reference's quirk where a degenerate TRANSLATION segment zeroes the
    ROTATION EA matrix entry (`arti_evaluation.py:422-425`);
  * predicted normals go through the ScanNet->SunCG swap; GT normals get
    y negated; missing GT normals ((-1,-1,-1)) force error 180 deg.

Reference quirks preserved by default (``legacy_quirks=True``), per SURVEY
§7.4 (parity-affecting quirks are preserved, not fixed):

  * the per-prediction pre-filter `if valid_pred_ids[idx] == 0`
    (`arti_evaluation.py:434-441`) evaluates a (G,)-element bool row, which
    torch only accepts in `if` for G == 1 — so the IoU > filter_iou
    pre-filter is active ONLY on single-GT images; multi-GT images score
    every prediction (low-IoU ones become FPs via the biou > iou_thresh
    term);
  * `pred_normals[pred_id]` (`arti_evaluation.py:485`) indexes normals by
    the score-sorted RANK, not the original prediction index (a no-op when
    detections arrive score-sorted, which the detector guarantees).

``legacy_quirks=False`` opts into the well-defined rule: a uniform
`max IoU > filter_iou` pre-filter for any G, normals by prediction index.

pycocotools COCO is replaced by `CocoIndex` over the identical JSON format.
Predictions of several processes are not gathered yet: `distributed=True`
raises.
"""

from __future__ import annotations

import logging
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..data.axis_codec import angle_offset_to_axis, axis_to_angle_offset
from ..data.catalog import get_metadata
from ..utils.metrics import EA_metric, Line
from ..utils.vocap import compute_ap
from .coco_index import CocoIndex
from .detectron2coco import convert_to_coco_dict

logger = logging.getLogger(__name__)

AP_METRICS = ("bbox", "bbox+axis", "bbox+normal", "bbox+normal+axis")


def _xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4).copy()
    boxes[:, 2] += boxes[:, 0]
    boxes[:, 3] += boxes[:, 1]
    return boxes


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(P, 4) x (G, 4) XYXY -> (P, G) IoU."""
    ix = np.maximum(0.0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    iy = np.maximum(0.0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = ix * iy
    area_a = np.maximum(0.0, a[:, 2] - a[:, 0]) * np.maximum(0.0, a[:, 3] - a[:, 1])
    area_b = np.maximum(0.0, b[:, 2] - b[:, 0]) * np.maximum(0.0, b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _centers(boxes_xyxy: np.ndarray) -> np.ndarray:
    return (boxes_xyxy[:, :2] + boxes_xyxy[:, 2:]) / 2.0


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUROC with tie averaging (sklearn-compatible)."""
    labels = np.asarray(labels, bool)
    scores = np.asarray(scores, np.float64)
    n_pos = labels.sum()
    n_neg = (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes")
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _ea_matrix_from_segments(pred_coord: np.ndarray, gt_coord: np.ndarray,
                             rot_matrix_for_quirk: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """EA over decoded segments; degenerate pred segment -> 0.

    When `rot_matrix_for_quirk` is given (the translation pass), a
    degenerate pred segment also zeroes the SAME (p, g) entry of the
    rotation matrix — preserving `arti_evaluation.py:422-425` verbatim.
    """
    out = np.zeros((len(pred_coord), len(gt_coord)))
    for p in range(len(pred_coord)):
        pc = pred_coord[p].tolist()
        degenerate = pc[0] == pc[2] and pc[1] == pc[3]
        for g in range(len(gt_coord)):
            if degenerate:
                if rot_matrix_for_quirk is not None:
                    rot_matrix_for_quirk[p][g] = 0
                continue
            l_pred = Line([pc[1], pc[0], pc[3], pc[2]])
            gc = gt_coord[g].tolist()
            l_gt = Line([gc[1], gc[0], gc[3], gc[2]])
            out[p][g] = EA_metric(l_pred, l_gt)
    return out


def _gt_axis_coords(gt_anns: List[Dict], gt_centers: np.ndarray, key: str,
                    zero_offset: bool):
    segs, valid = [], []
    for ann in gt_anns:
        a = ann.get(key)
        if a is None:
            segs.append([0, 0, 1, 1])
            valid.append(False)
        else:
            segs.append(a)
            valid.append(True)
    ao = axis_to_angle_offset(np.asarray(segs, np.float64),
                              gt_centers, valid=np.asarray(valid))
    params = ao[:, :3].astype(np.float64)
    if zero_offset:
        params[:, 2] = 0.0
    coord = angle_offset_to_axis(params, gt_centers)
    return coord, ao[:, 3] >= 0.5


def evaluate_for_arti_axis(predictions: Sequence[Dict], dataset: CocoIndex,
                           metadata, filter_iou: float, iou_thresh: float = 0.5,
                           normal_threshold: float = 30.0,
                           legacy_quirks: bool = True) -> Dict[str, float]:
    cat_ids = sorted(dataset.getCatIds())
    reverse = {v: k for k, v in metadata.thing_dataset_id_to_contiguous_id.items()}
    contiguous = metadata.thing_dataset_id_to_contiguous_id

    ap_scores = {m: {c: [] for c in cat_ids} for m in AP_METRICS}
    ap_labels = {m: {c: [] for c in cat_ids} for m in AP_METRICS}
    npos = {c: 0.0 for c in cat_ids}
    for gt_ann in dataset.dataset["annotations"]:
        npos[gt_ann["category_id"]] += 1.0

    for prediction in predictions:
        original_id = prediction["image_id"]
        instances = prediction.get("instances", [])
        if len(instances) == 0:
            continue

        scores = np.array([ins["score"] for ins in instances])
        boxes = _xywh_to_xyxy([ins["bbox"] for ins in instances])
        labels = [ins["category_id"] for ins in instances]
        axis_rot = np.asarray(prediction["pred_rot_axis"], np.float64)
        axis_tran = np.asarray(prediction["pred_tran_axis"], np.float64)
        if "pred_plane" in prediction and prediction["pred_plane"] is not None:
            pred_normals = _normalize_rows(
                np.asarray(prediction["pred_plane"], np.float64))
        else:
            pred_normals = _normalize_rows(np.ones((len(scores), 3)))
        # ScanNet -> SunCG swap (`arti_evaluation.py:339-341`)
        pred_normals = np.stack([pred_normals[:, 0], -pred_normals[:, 2],
                                 pred_normals[:, 1]], axis=1)

        gt_anns = dataset.loadAnns(dataset.getAnnIds(imgIds=[original_id]))
        if len(gt_anns) == 0:
            continue
        gt_boxes = _xywh_to_xyxy([a["bbox"] for a in gt_anns])
        gt_labels = [a["category_id"] for a in gt_anns]
        gt_normals = np.array(
            [a["normal"] if a.get("normal") is not None else [-1, -1, -1]
             for a in gt_anns], np.float64)
        gt_normals[:, 1] = -gt_normals[:, 1]

        gt_centers = _centers(gt_boxes)
        gt_rot_coord, valid_gt_rot = _gt_axis_coords(
            gt_anns, gt_centers, "rot_axis", zero_offset=False)
        gt_tran_coord, valid_gt_tran = _gt_axis_coords(
            gt_anns, gt_centers, "tran_axis", zero_offset=True)

        pred_centers = _centers(boxes)
        pred_rot_coord = angle_offset_to_axis(axis_rot, pred_centers)
        tran_params = np.concatenate(
            [axis_tran, np.zeros((len(axis_tran), 1))], axis=1)
        pred_tran_coord = angle_offset_to_axis(tran_params, pred_centers)

        axis_rot_metrics = _ea_matrix_from_segments(pred_rot_coord, gt_rot_coord)
        axis_tran_metrics = _ea_matrix_from_segments(
            pred_tran_coord, gt_tran_coord,
            rot_matrix_for_quirk=axis_rot_metrics)

        boxiou = _pairwise_iou(boxes, gt_boxes)
        idx_sorted = np.argsort(-scores, kind="stable")
        box_covered = {m: [] for m in AP_METRICS}

        for rank in range(len(scores)):
            i = idx_sorted[rank]
            if legacy_quirks:
                # reference pre-filter is only defined (torch scalar-bool)
                # when the image has a single GT — multi-GT images score
                # every prediction (`arti_evaluation.py:434-441`)
                if len(gt_anns) == 1 and boxiou[i, 0] <= filter_iou:
                    continue
            elif boxiou[i].max() <= filter_iou:
                continue
            gt_id = int(np.argmax(boxiou[i]))
            gt_label = gt_labels[gt_id]
            pred_label = reverse[labels[i]]
            pred_biou = boxiou[i, gt_id]
            pred_score = scores[i]

            gt_class_name = metadata.thing_classes[contiguous[gt_label]]
            if "rot" in gt_class_name:
                pred_ea = axis_rot_metrics[i, gt_id] if valid_gt_rot[gt_id] else 0
            elif "tran" in gt_class_name:
                pred_ea = axis_tran_metrics[i, gt_id] if valid_gt_tran[gt_id] else 0
            else:
                raise NotImplementedError(gt_class_name)

            # reference indexes normals by sorted RANK (`:485`), not by the
            # original prediction index — a no-op for score-sorted inputs
            normal_idx = rank if legacy_quirks else i
            dot = float(np.dot(pred_normals[normal_idx], gt_normals[gt_id]))
            normal_error = np.arccos(np.clip(dot, -1.0, 1.0)) / np.pi * 180.0
            if np.linalg.norm(gt_normals[gt_id]) > 1.1:  # invalid gt normal
                normal_error = 180.0

            for metric in AP_METRICS:
                is_tp = (pred_label == gt_label and pred_biou > iou_thresh
                         and gt_id not in box_covered[metric])
                if metric == "bbox+axis":
                    is_tp = is_tp and pred_ea > iou_thresh
                elif metric == "bbox+normal":
                    is_tp = is_tp and normal_error < normal_threshold
                elif metric == "bbox+normal+axis":
                    is_tp = is_tp and (pred_ea > iou_thresh
                                       and normal_error < normal_threshold)
                if is_tp:
                    box_covered[metric].append(gt_id)
                ap_scores[metric][pred_label].append(pred_score)
                ap_labels[metric][pred_label].append(1 if is_tp else 0)

    detection_metrics = {}
    for cat_id in cat_ids:
        if npos[cat_id] == 0:
            continue
        cat_name = dataset.loadCats([cat_id])[0]["name"]
        for metric in AP_METRICS:
            detection_metrics[f"{metric} - {cat_name}"] = compute_ap(
                np.asarray(ap_scores[metric][cat_id]),
                np.asarray(ap_labels[metric][cat_id]), npos[cat_id])
    logger.info("Detection metrics: %s", detection_metrics)
    return detection_metrics


def evaluate_for_recognition(predictions: Sequence[Dict], dataset: CocoIndex,
                             metadata, filter_iou: float) -> Dict[str, float]:
    """Per-image max score vs has-any-GT (`arti_evaluation.py:669-757`)."""
    preds, gts = [], []
    for prediction in predictions:
        original_id = prediction["image_id"]
        scores = [ins["score"] for ins in prediction.get("instances", [])]
        gt_ann_ids = dataset.getAnnIds(imgIds=[original_id])
        preds.append(max(scores) if scores else 0.0)
        gts.append(len(gt_ann_ids) > 0)
    preds = np.array(preds)
    gts = np.array(gts)
    recog = {}
    try:
        recog["auroc"] = roc_auc(gts, preds)
        recog["accuracy"] = float(((preds > 0.95) == gts).sum() / len(preds))
    except Exception:
        recog["auroc"] = -1
        recog["accuracy"] = -1
    logger.info("Recognition results: %s", recog)
    return recog


class ArtiEvaluator:
    """Drop-in evaluator with the reference's reset/process/evaluate API.

    Accumulates per-image prediction dicts (same schema as the reference's
    `instances_predictions.pth` entries) and computes recognition + the four
    articulation APs.  `_predictions` may be assigned directly (the
    `tools/opt_arti.py:347-351` offline pattern).
    """

    def __init__(self, dataset_name: str, cfg: Optional[Config] = None,
                 distributed: bool = False, output_dir: Optional[str] = None,
                 legacy_quirks: bool = True):
        if distributed:
            raise NotImplementedError("gathering predictions across processes is not "
                                      "ported yet; pass distributed=False")
        self.cfg = cfg
        self._output_dir = output_dir
        self._metadata = get_metadata(dataset_name)
        self._filter_iou = 0.7
        self._legacy_quirks = legacy_quirks
        self._coco_api = CocoIndex(self._to_coco(self._metadata.json_file))
        self._predictions: List[Dict] = []

    def _to_coco(self, d2json: str) -> Dict:
        """Convert the cached d2 JSON to COCO (disk cache like the
        reference's `_to_coco`, `arti_evaluation.py:134-151`)."""
        import json
        if self._output_dir:
            save_json = os.path.join(
                self._output_dir, "arti_coco_" + d2json.replace("/", "_"))
            os.makedirs(os.path.dirname(save_json) or ".", exist_ok=True)
            if os.path.exists(save_json):
                with open(save_json) as f:
                    return json.load(f)
        with open(d2json) as f:
            d2_data = json.load(f)
        coco_data = convert_to_coco_dict(d2_data["data"], self._metadata)
        if self._output_dir:
            tmp = save_json + ".tmp"
            with open(tmp, "w") as f:
                json.dump(coco_data, f)
            os.replace(tmp, save_json)  # atomic: multi-rank safe
        return coco_data

    def reset(self):
        self._predictions = []

    def process(self, inputs: Sequence[Dict], outputs: Sequence[Dict]):
        """inputs: [{image_id, file_name, ...}]; outputs: [{instances:
        coco-json list, pred_rot_axis, pred_tran_axis, pred_plane,
        depth}]."""
        for inp, out in zip(inputs, outputs):
            prediction = {"image_id": inp["image_id"],
                          "file_name": inp.get("file_name")}
            for k in ("instances", "pred_rot_axis", "pred_tran_axis",
                      "pred_plane"):
                if k in out and out[k] is not None:
                    prediction[k] = out[k]
            if out.get("depth") is not None:
                prediction["pred_depth"] = out["depth"]
            self._predictions.append(prediction)

    def evaluate(self) -> "OrderedDict[str, float]":
        predictions = self._predictions
        if len(predictions) == 0:
            logger.warning("ArtiEvaluator received no predictions")
            return OrderedDict()

        if self._output_dir:
            import torch
            os.makedirs(self._output_dir, exist_ok=True)
            torch.save(predictions, os.path.join(self._output_dir,
                                                 "instances_predictions.pth"))

        results = OrderedDict()
        if "instances" in predictions[0]:
            # standard COCO bbox/segm mAP alongside the arti APs (reference
            # `_eval_predictions`, arti_evaluation.py:226-229)
            from .coco_eval import evaluate_coco_map
            try:
                results.update(evaluate_coco_map(predictions, self._coco_api,
                                                 metadata=self._metadata))
            except Exception as e:  # mAP must not kill the arti metrics
                logger.warning("coco mAP failed: %s", e)
            results.update(evaluate_for_recognition(
                predictions, self._coco_api, self._metadata, self._filter_iou))
            if any(k in predictions[0] for k in
                   ("axis", "pred_rot_axis", "pred_tran_axis")):
                results.update(evaluate_for_arti_axis(
                    predictions, self._coco_api, self._metadata,
                    self._filter_iou, legacy_quirks=self._legacy_quirks))
        if results:
            from ..utils.tables import create_small_table
            finite = {k: v for k, v in results.items()
                      if isinstance(v, (int, float))}
            logger.info("ArtiEvaluator results:\n%s",
                        create_small_table(finite))
        return results
