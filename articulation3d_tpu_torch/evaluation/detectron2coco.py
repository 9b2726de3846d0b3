"""Dataset dicts -> COCO json, preserving the articulation extra keys.

Counterpart of `articulation3d_tpu/evaluation/detectron2coco.py`, the
reference's `evaluation/detectron2coco.py:7-148`: XYWH boxes
rounded to 3 decimals, shoelace polygon areas (d2 PolygonMasks.area), ids
starting at 1, and the pass-through of
`plane/axis/rot_axis/tran_axis/normal/normal_posx/normal_posy`
(`detectron2coco.py:115-117`).
"""

from __future__ import annotations

import datetime
from typing import Dict, List

import numpy as np

from ..data.catalog import DatasetMetadata
from ..data.mapper import BOXMODE_XYXY_ABS, BOXMODE_XYWH_ABS
from ..utils.rle import rle_area

_EXTRA_KEYS = ("plane", "axis", "rot_axis", "tran_axis", "normal",
               "normal_posx", "normal_posy")


def _polygon_area(polygons: List) -> float:
    """Sum of shoelace areas over a COCO polygon list (d2 PolygonMasks.area)."""
    total = 0.0
    for p in polygons:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        x, y = p[:, 0], p[:, 1]
        total += 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
    return total


def _to_xywh(bbox, mode: int) -> List[float]:
    b = np.asarray(bbox, np.float64)
    if mode == BOXMODE_XYWH_ABS:
        return b.tolist()
    if mode == BOXMODE_XYXY_ABS:
        return [b[0], b[1], b[2] - b[0], b[3] - b[1]]
    raise ValueError(f"unsupported bbox_mode {mode}")


def convert_to_coco_dict(dataset_dicts: List[Dict],
                         metadata: DatasetMetadata) -> Dict:
    reverse = {v: k for k, v in metadata.thing_dataset_id_to_contiguous_id.items()}
    mapper = (lambda cid: reverse[cid]) if reverse else (lambda cid: cid)

    categories = [{"id": mapper(i), "name": name}
                  for i, name in enumerate(metadata.thing_classes)]

    coco_images, coco_annotations = [], []
    for image_id, image_dict in enumerate(dataset_dicts):
        coco_image = {
            "id": image_dict.get("image_id", image_id),
            "width": image_dict["width"],
            "height": image_dict["height"],
            "file_name": image_dict["file_name"],
        }
        coco_images.append(coco_image)

        for annotation in image_dict.get("annotations", []):
            bbox = _to_xywh(annotation["bbox"], int(annotation["bbox_mode"]))
            if "segmentation" in annotation:
                seg = annotation["segmentation"]
                if isinstance(seg, list):
                    area = _polygon_area(seg)
                elif isinstance(seg, dict):
                    area = float(rle_area(seg))
                else:
                    raise TypeError(f"unknown segmentation type {type(seg)}")
            else:
                area = float(bbox[2] * bbox[3])

            coco_annotation = {
                "id": len(coco_annotations) + 1,
                "image_id": coco_image["id"],
                "bbox": [round(float(x), 3) for x in bbox],
                "area": float(area),
                "iscrowd": annotation.get("iscrowd", 0),
                "category_id": mapper(annotation["category_id"]),
            }
            if "segmentation" in annotation:
                coco_annotation["segmentation"] = annotation["segmentation"]
                if isinstance(coco_annotation["segmentation"], dict):
                    counts = coco_annotation["segmentation"]["counts"]
                    if isinstance(counts, bytes):
                        coco_annotation["segmentation"]["counts"] = counts.decode("ascii")
            for k in _EXTRA_KEYS:
                if k in annotation:
                    coco_annotation[k] = annotation[k]
            coco_annotations.append(coco_annotation)

    return {
        "info": {
            "date_created": str(datetime.datetime.now()),
            "description": "Automatically generated COCO json file.",
        },
        "images": coco_images,
        "annotations": coco_annotations,
        "categories": categories,
        "licenses": None,
    }
