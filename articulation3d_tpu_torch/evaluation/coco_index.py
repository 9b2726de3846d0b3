"""Minimal COCO-format annotation index (pycocotools.COCO's query surface).

Counterpart of `articulation3d_tpu/evaluation/coco_index.py`: the
evaluators need only category ids, per-image annotation lookup and
image/category records (the reference's `evaluation/arti_evaluation.py:
267,345-347,590`).  The JSON format is COCO's, so files interoperate.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Union


class CocoIndex:
    """Index over a COCO dict {images, annotations, categories, ...}."""

    def __init__(self, annotation_source: Union[str, Dict]):
        if isinstance(annotation_source, str):
            with open(annotation_source) as f:
                self.dataset = json.load(f)
        else:
            self.dataset = annotation_source
        self._imgs = {img["id"]: img for img in self.dataset.get("images", [])}
        self._cats = {c["id"]: c for c in self.dataset.get("categories", [])}
        self._anns = {a["id"]: a for a in self.dataset.get("annotations", [])}
        self._img_to_anns = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            self._img_to_anns[a["image_id"]].append(a["id"])

    def getCatIds(self) -> List:
        return list(self._cats.keys())

    def getImgIds(self) -> List:
        return list(self._imgs.keys())

    def getAnnIds(self, imgIds: Optional[Sequence] = None) -> List:
        if imgIds is None:
            return list(self._anns.keys())
        out = []
        for i in imgIds:
            out.extend(self._img_to_anns[i])
        return out

    def loadAnns(self, ids: Sequence) -> List[Dict]:
        return [self._anns[i] for i in ids]

    def loadImgs(self, ids: Sequence) -> List[Dict]:
        return [self._imgs[i] for i in ids]

    def loadCats(self, ids: Sequence) -> List[Dict]:
        return [self._cats[i] for i in ids]
