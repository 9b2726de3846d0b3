"""Dataset catalog: named datasets and their metadata, registered at import.

Counterpart of `articulation3d_tpu/data/catalog.py`, which replaces
detectron2's DatasetCatalog/MetadataCatalog pair (the reference's
`data/datasets/builtin.py:17-88`) with two plain dicts.  The same split
names, category metadata, JSON paths and evaluator types are registered,
so evaluators and CLIs resolve datasets by the same names:
`arti_{train,val,test}` (evaluator "arti") and
`scannet[_surreal]_{train,val}` (evaluator "mp3d").
`register_builtin_datasets(root)` registers them again under another data
root.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class DatasetMetadata:
    name: str
    json_file: str
    image_root: str
    evaluator_type: str
    thing_classes: List[str] = field(default_factory=list)
    thing_colors: List[List[int]] = field(default_factory=list)
    thing_dataset_id_to_contiguous_id: Dict[int, int] = field(default_factory=dict)


_LOADERS: Dict[str, Callable[[], List[dict]]] = {}
_METADATA: Dict[str, DatasetMetadata] = {}


def register_dataset(name: str, loader: Callable[[], List[dict]],
                     metadata: DatasetMetadata) -> None:
    _LOADERS[name] = loader
    _METADATA[name] = metadata


def get_dataset_dicts(name: str) -> List[dict]:
    if name not in _LOADERS:
        raise KeyError(f"dataset {name!r} not registered; have {sorted(_LOADERS)}")
    return _LOADERS[name]()


def get_metadata(name: str) -> DatasetMetadata:
    if name not in _METADATA:
        raise KeyError(f"no metadata for {name!r}; have {sorted(_METADATA)}")
    return _METADATA[name]


def list_datasets() -> List[str]:
    return sorted(_LOADERS)


# --------------------------------------------------------------------------- #
# JSON loaders (reference `data/datasets/arti.py:15-39`, `scannet.py:18-42`)
# --------------------------------------------------------------------------- #

def load_arti_json(json_file: str, dataset_name: Optional[str] = None) -> List[dict]:
    """cached_set_*.json: {info, categories, data: [record]} -> data list.
    The registered metadata's `thing_classes` become the JSON's category
    names, ordered by id."""
    with open(json_file) as f:
        summary = json.load(f)
    if dataset_name is not None and dataset_name in _METADATA:
        cats = summary.get("categories", [])
        _METADATA[dataset_name].thing_classes = [
            c["name"] for c in sorted(cats, key=lambda x: x["id"])]
    return summary["data"]


load_scannet_json = load_arti_json  # the same format (reference scannet.py)


# --------------------------------------------------------------------------- #
# builtin registration (reference `data/datasets/builtin.py`)
# --------------------------------------------------------------------------- #

ARTI_CLASSES = [
    {"name": "arti_rot", "color": [0, 130, 200], "id": 1},
    {"name": "arti_tran", "color": [230, 25, 75], "id": 2},
]
SCANNET_CLASSES = [
    {"name": "plane", "color": [230, 25, 75], "id": 1},
    {"name": "plane2", "color": [230, 25, 75], "id": 2},
]

ARTI_SPLITS = {
    "arti_val": ("arti", "articulation/cached_set_val.json"),
    "arti_test": ("arti", "articulation/cached_set_test.json"),
    "arti_train": ("arti", "articulation/cached_set_train.json"),
}
SCANNET_SPLITS = {
    "scannet_surreal_val": ("scannet_surreal", "scannet_surreal/cached_set_val.json"),
    "scannet_surreal_train": ("scannet_surreal", "scannet_surreal/cached_set_train.json"),
    "scannet_val": ("scannet", "scannet/cached_set_val.json"),
    "scannet_train": ("scannet", "scannet/cached_set_train.json"),
}


def _register_builtin(name: str, image_root: str, json_rel: str,
                      classes: List[dict], evaluator_type: str,
                      root: str = "datasets") -> None:
    json_file = os.path.join(root, json_rel)
    meta = DatasetMetadata(
        name=name,
        json_file=json_file,
        image_root=os.path.join(root, image_root),
        evaluator_type=evaluator_type,
        thing_classes=[c["name"] for c in classes],
        thing_colors=[list(c["color"]) for c in classes],
        thing_dataset_id_to_contiguous_id={c["id"]: i for i, c in enumerate(classes)},
    )
    register_dataset(name, lambda jf=json_file, n=name: load_arti_json(jf, n), meta)


def register_builtin_datasets(root: str = "datasets") -> None:
    for key, (image_root, anno) in ARTI_SPLITS.items():
        _register_builtin(key, image_root, anno, ARTI_CLASSES, "arti", root)
    for key, (image_root, anno) in SCANNET_SPLITS.items():
        _register_builtin(key, image_root, anno, SCANNET_CLASSES, "mp3d", root)


register_builtin_datasets()
