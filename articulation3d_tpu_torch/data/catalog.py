"""Dataset metadata: class names and colours of the `arti_*` splits.

Counterpart of the metadata half of `articulation3d_tpu/data/catalog.py`
(the reference's `data/datasets/builtin.py`); the visualisation reads the
class names and colours.  The dataset registry and its JSON loaders come
with the data path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class DatasetMetadata:
    name: str
    json_file: str
    image_root: str
    evaluator_type: str
    thing_classes: List[str] = field(default_factory=list)
    thing_colors: List[List[int]] = field(default_factory=list)
    thing_dataset_id_to_contiguous_id: Dict[int, int] = field(default_factory=dict)


ARTI_CLASSES = [
    {"name": "arti_rot", "color": [0, 130, 200], "id": 1},
    {"name": "arti_tran", "color": [230, 25, 75], "id": 2},
]
ARTI_SPLITS = {
    "arti_val": ("arti", "articulation/cached_set_val.json"),
    "arti_test": ("arti", "articulation/cached_set_test.json"),
    "arti_train": ("arti", "articulation/cached_set_train.json"),
}


def get_metadata(name: str) -> DatasetMetadata:
    """Metadata of one `arti_*` split."""
    if name not in ARTI_SPLITS:
        raise KeyError(f"no metadata for {name!r}; have {sorted(ARTI_SPLITS)}")
    image_root, json_rel = ARTI_SPLITS[name]
    return DatasetMetadata(
        name=name,
        json_file=os.path.join("datasets", json_rel),
        image_root=os.path.join("datasets", image_root),
        evaluator_type="arti",
        thing_classes=[c["name"] for c in ARTI_CLASSES],
        thing_colors=[list(c["color"]) for c in ARTI_CLASSES],
        thing_dataset_id_to_contiguous_id={c["id"]: i for i, c in enumerate(ARTI_CLASSES)},
    )
