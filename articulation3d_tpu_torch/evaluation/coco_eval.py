"""COCO-protocol mAP (bbox + segm) without pycocotools.

Counterpart of `articulation3d_tpu/evaluation/coco_eval.py`.  The
reference's ArtiEvaluator also reports COCO AP through detectron2's
`_eval_predictions` (pycocotools COCOeval, reference
`evaluation/arti_evaluation.py:226-229`); this module implements the
COCOeval protocol directly:

  * IoU thresholds 0.50:0.05:0.95, 101-point interpolated precision;
  * greedy score-ordered matching, each GT used once per threshold, a
    detection may match an *ignored* GT only if no real GT fits
    (pycocotools cocoeval.py `evaluateImg` semantics);
  * area ranges all / small(<32^2) / medium / large(>96^2), maxDets=100;
  * AP averaged over thresholds and categories (NaN-safe);
  * outputs the detectron2 `_derive_coco_results` key set: AP, AP50, AP75,
    APs, APm, APl, AP-<category>.

Mask IoU decodes through the port's RLE codec (`utils/rle.py`, `csrc/rle.cc`).
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.rle import mask_iou, rle_area
from .coco_index import CocoIndex

IOU_THRESHS = np.round(np.arange(0.5, 1.0, 0.05), 2)      # 10 thresholds
RECALL_THRESHS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _xywh_to_xyxy(b):
    b = np.asarray(b, np.float64)
    return np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]])


def _bbox_iou(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) XYWH -> (D, G) IoU."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    d = np.stack([_xywh_to_xyxy(b) for b in dt])
    g = np.stack([_xywh_to_xyxy(b) for b in gt])
    lt = np.maximum(d[:, None, :2], g[None, :, :2])
    rb = np.minimum(d[:, None, 2:], g[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = dt[:, 2] * dt[:, 3]
    area_g = gt[:, 2] * gt[:, 3]
    return inter / np.clip(area_d[:, None] + area_g[None] - inter, 1e-9, None)


def _match_image(dt_scores: np.ndarray, iou: np.ndarray,
                 gt_ignore: np.ndarray):
    """Per-image matching for all IoU thresholds.

    Returns (dt_matched (T, D) gt index or -1, dt_ignored (T, D) bool).
    dts are assumed already sorted by descending score; gts sorted so that
    non-ignored come first (pycocotools order).
    """
    t, d, g = len(IOU_THRESHS), iou.shape[0], iou.shape[1]
    dt_m = -np.ones((t, d), int)
    dt_ig = np.zeros((t, d), bool)
    gt_m = -np.ones((t, g), int)
    for ti, thr in enumerate(IOU_THRESHS):
        for di in range(d):
            best, m = min(thr, 1 - 1e-10), -1
            for gi in range(g):
                if gt_m[ti, gi] >= 0:
                    continue
                # stop at ignored gts once a real match exists
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if iou[di, gi] < best:
                    continue
                best, m = iou[di, gi], gi
            if m == -1:
                continue
            dt_m[ti, di] = m
            dt_ig[ti, di] = gt_ignore[m]
            gt_m[ti, m] = di
    return dt_m, dt_ig


class CocoAPEvaluator:
    """COCO mAP over a CocoIndex GT + coco-json detection list."""

    def __init__(self, coco_gt: CocoIndex, iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm")
        self.gt = coco_gt
        self.iou_type = iou_type
        self.cat_ids = sorted(coco_gt.getCatIds())
        self.cat_names = {c["id"]: c["name"]
                          for c in coco_gt.loadCats(self.cat_ids)}

    def _gt_for(self, img_id, cat_id) -> List[Dict]:
        anns = self.gt.loadAnns(self.gt.getAnnIds([img_id]))
        return [a for a in anns if a["category_id"] == cat_id]

    def _seg_to_rle(self, seg, img_id) -> Dict:
        """COCO segmentation (RLE dict or polygon list) -> RLE dict."""
        if isinstance(seg, dict):
            return seg
        import cv2

        from ..utils.rle import rle_encode
        img = self.gt.loadImgs([img_id])[0]
        h, w = img["height"], img["width"]
        mask = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return rle_encode(mask)

    def _iou(self, dts: List[Dict], gts: List[Dict]) -> np.ndarray:
        if self.iou_type == "bbox":
            dt_b = np.asarray([d["bbox"] for d in dts],
                              np.float64).reshape(-1, 4)
            gt_b = np.asarray([g["bbox"] for g in gts],
                              np.float64).reshape(-1, 4)
            return _bbox_iou(dt_b, gt_b)
        dt_rle = [self._seg_to_rle(d["segmentation"], d["image_id"])
                  for d in dts]
        gt_rle = [self._seg_to_rle(g["segmentation"], g["image_id"])
                  for g in gts]
        return mask_iou(dt_rle, gt_rle)

    def evaluate(self, detections: Sequence[Dict]) -> Dict[str, float]:
        """detections: coco-json dicts {image_id, category_id, bbox xywh,
        score[, segmentation rle]}.  Returns the d2-style result keys."""
        by_img_cat = defaultdict(list)
        for det in detections:
            by_img_cat[(det["image_id"], det["category_id"])].append(det)

        img_ids = self.gt.getImgIds()
        # precision[T, R, K, A]
        shape = (len(IOU_THRESHS), len(RECALL_THRESHS), len(self.cat_ids),
                 len(AREA_RANGES))
        precision = -np.ones(shape)

        per_cat_area = {}
        for ki, cat_id in enumerate(self.cat_ids):
            # gather per-image matches once (area filtering applied per range)
            img_evals = []
            for img_id in img_ids:
                gts = self._gt_for(img_id, cat_id)
                dts = sorted(by_img_cat.get((img_id, cat_id), []),
                             key=lambda d: -d["score"])[:MAX_DETS]
                img_evals.append((img_id, gts, dts))

            for ai, (aname, (amin, amax)) in enumerate(AREA_RANGES.items()):
                tps, igs, scores, n_gt = [], [], [], 0
                for img_id, gts, dts in img_evals:
                    if not gts and not dts:
                        continue
                    g_area = [self._ann_area(g) for g in gts]
                    g_ignore = np.array(
                        [bool(g.get("iscrowd", 0))
                         or not (amin <= a < amax)
                         for g, a in zip(gts, g_area)], bool)
                    order = np.argsort(g_ignore, kind="stable")
                    gts_s = [gts[i] for i in order]
                    g_ignore = g_ignore[order]
                    n_gt += int((~g_ignore).sum())
                    if not dts:
                        continue
                    iou = self._iou(dts, gts_s) if gts_s else \
                        np.zeros((len(dts), 0))
                    dt_scores = np.array([d["score"] for d in dts])
                    dt_m, dt_ig = _match_image(dt_scores, iou, g_ignore)
                    # unmatched dts outside the area range are ignored
                    d_area = np.array([self._det_area(d) for d in dts])
                    d_out = ~((amin <= d_area) & (d_area < amax))
                    dt_ig = dt_ig | ((dt_m == -1) & d_out[None, :])
                    tps.append(dt_m >= 0)
                    igs.append(dt_ig)
                    scores.append(dt_scores)
                per_cat_area[(ki, ai)] = n_gt
                if n_gt == 0:
                    continue  # no GT in range: category excluded (NaN-safe)
                if not scores:
                    # GT present but zero detections: AP contribution is 0
                    precision[:, :, ki, ai] = 0.0
                    continue
                scores = np.concatenate(scores)
                tps = np.concatenate(tps, axis=1)
                igs = np.concatenate(igs, axis=1)
                order = np.argsort(-scores, kind="mergesort")
                tps, igs = tps[:, order], igs[:, order]
                for ti in range(len(IOU_THRESHS)):
                    keep = ~igs[ti]
                    tp = np.cumsum(tps[ti][keep])
                    fp = np.cumsum(~tps[ti][keep])
                    rc = tp / n_gt
                    pr = tp / np.maximum(tp + fp, 1e-12)
                    # monotone precision envelope
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    idx = np.searchsorted(rc, RECALL_THRESHS, side="left")
                    q = np.zeros(len(RECALL_THRESHS))
                    valid = idx < len(pr)
                    q[valid] = pr[idx[valid]]
                    precision[ti, :, ki, ai] = q

        def ap(t_slice=slice(None), a_name="all", k=None):
            ai = list(AREA_RANGES).index(a_name)
            p = precision[t_slice, :, :, ai]
            if k is not None:
                p = p[..., k:k + 1]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else float("nan")

        t50 = [int(np.where(IOU_THRESHS == 0.5)[0][0])]
        t75 = [int(np.where(IOU_THRESHS == 0.75)[0][0])]
        results = OrderedDict([
            ("AP", 100 * ap()),
            ("AP50", 100 * ap(t50)),
            ("AP75", 100 * ap(t75)),
            ("APs", 100 * ap(a_name="small")),
            ("APm", 100 * ap(a_name="medium")),
            ("APl", 100 * ap(a_name="large")),
        ])
        for ki, cat_id in enumerate(self.cat_ids):
            results[f"AP-{self.cat_names[cat_id]}"] = 100 * ap(k=ki)
        return results

    def _ann_area(self, ann: Dict) -> float:
        if "area" in ann:
            return float(ann["area"])
        if self.iou_type == "segm" and "segmentation" in ann:
            return float(rle_area(ann["segmentation"]))
        b = ann["bbox"]
        return float(b[2] * b[3])

    def _det_area(self, det: Dict) -> float:
        if self.iou_type == "segm" and "segmentation" in det:
            return float(rle_area(det["segmentation"]))
        b = det["bbox"]
        return float(b[2] * b[3])


def evaluate_coco_map(predictions: Sequence[Dict], coco_gt: CocoIndex,
                      tasks: Sequence[str] = ("bbox", "segm"),
                      metadata=None) -> "OrderedDict[str, float]":
    """d2 `_eval_predictions` equivalent: flat {task/metric: value} dict.

    Detections carry CONTIGUOUS class ids (0..C-1); like d2's
    `reverse_id_mapping` they are remapped to dataset category ids via
    `metadata.thing_dataset_id_to_contiguous_id` when provided.
    """
    reverse = {}
    if metadata is not None and metadata.thing_dataset_id_to_contiguous_id:
        reverse = {v: k for k, v in
                   metadata.thing_dataset_id_to_contiguous_id.items()}
    dets = []
    for pred in predictions:
        for d in pred.get("instances", []):
            if reverse:
                d = dict(d, category_id=reverse.get(d["category_id"],
                                                    d["category_id"]))
            dets.append(d)
    out: "OrderedDict[str, float]" = OrderedDict()
    for task in tasks:
        if task == "segm" and not any("segmentation" in d for d in dets):
            continue
        ev = CocoAPEvaluator(coco_gt, iou_type=task)
        task_dets = dets
        if task == "segm":
            task_dets = [d for d in dets if "segmentation" in d]
        for k, v in ev.evaluate(task_dets).items():
            out[f"{task}/{k}"] = v
    return out
