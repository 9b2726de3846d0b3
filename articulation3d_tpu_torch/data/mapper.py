"""Dataset mapper: JSON records -> fixed-shape padded numpy batches.

Counterpart of `articulation3d_tpu/data/mapper.py`, which re-implements the
reference `PlaneRCNNMapper` (`data/planercnn_transforms.py:253-376`): every
record maps to arrays padded to `max_instances` rows with a validity mask,
so batches stack into fixed shapes (the `train/train_step.py` contract).

  * the image read in BGR and resized to the record's (width, height), as
    raw uint8 (normalised on the device); a missing file falls back to
    `.jpg -> .png`, then `frames_hq -> frames_hq_neg`, then zeros
    (`planercnn_transforms.py:309-322`);
  * boxes converted to XYXY and clipped, empty boxes dropped, at most
    `max_instances` kept (`annotations_to_instances`, 180-251);
  * polygon (cv2.fillPoly), RLE or ndarray masks; in training bit-packed
    along W (`gt_masks_packed`), in evaluation as uint8 (`gt_masks`);
  * axis segments encoded about box centres (243-249);
  * depth read with cv2 IMREAD_UNCHANGED: in evaluation float metres
    (`gt_depth`, the file / 1000, `depthShift`); in training always u16
    millimetres (`gt_depth_mm`).

One departure from the JAX mapper, which picks the training depth key per
file: a missing depth file there, or one that is not u16, gives `gt_depth`
while the others give `gt_depth_mm`, and `collate` of such a batch fails.
Here every training record carries `gt_depth_mm`: zeros for a missing file,
a non-u16 file's metres rounded to millimetres (ROADMAP.md section 3).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

from ..config import Config
from ..utils.rle import rle_decode
from .axis_codec import axis_to_angle_offset

BOXMODE_XYXY_ABS = 0
BOXMODE_XYWH_ABS = 1


def convert_box(box: Sequence[float], mode: int) -> np.ndarray:
    box = np.asarray(box, np.float64)
    if mode == BOXMODE_XYXY_ABS:
        return box
    if mode == BOXMODE_XYWH_ABS:
        return np.array([box[0], box[1], box[0] + box[2], box[1] + box[3]])
    raise ValueError(f"unsupported bbox_mode {mode}")


def polygons_to_bitmask(polygons: List[Sequence[float]], height: int,
                        width: int) -> np.ndarray:
    """Rasterize COCO-style polygon lists to a binary (H, W) uint8 mask."""
    mask = np.zeros((height, width), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def read_image_bgr(path: str, height: int, width: int) -> np.ndarray:
    """Read and resize one frame with the reference's fallback chain; raw
    uint8 BGR, zeros when no file is found."""
    if not os.path.exists(path):
        path = path.replace(".jpg", ".png")
    if not os.path.exists(path):
        path = path.replace("frames_hq", "frames_hq_neg")
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return np.zeros((height, width, 3), np.uint8)
    return cv2.resize(img, (width, height))


def depth_to_mm(depth: np.ndarray, depth_shift: float = 1000.0) -> np.ndarray:
    """A depth map read from disk -> u16 millimetres: u16 files as they
    are, others as their metres (file / depth_shift) rounded to mm."""
    if depth.dtype == np.uint16:
        return depth
    metres = depth.astype(np.float64) / depth_shift
    return np.clip(np.round(metres * 1000.0), 0, 65535).astype(np.uint16)


class PlaneRCNNMapper:
    """record dict -> dict of fixed-shape numpy arrays (one image)."""

    def __init__(self, cfg: Config, is_train: bool = True,
                 max_instances: int = 20, image_root: Optional[str] = None):
        self.cfg = cfg
        self.is_train = is_train
        self.max_instances = max_instances
        self.image_root = image_root
        self.depth_shift = 1000.0

    def __call__(self, record: Dict) -> Dict[str, np.ndarray]:
        h = int(record["height"])
        w = int(record["width"])
        file_name = record["file_name"]
        if self.image_root is not None and not os.path.isabs(file_name):
            file_name = os.path.join(self.image_root, file_name)
        out: Dict[str, np.ndarray] = {
            "images": read_image_bgr(file_name, h, w),
            "image_id": record.get("image_id", record.get("file_name", "")),
            "file_name": record["file_name"],
            "height": h,
            "width": w,
        }
        mcfg = self.cfg.model
        if (mcfg.depth_on and "depth_head" not in mcfg.freeze
                and "depth_path" in record):
            depth = cv2.imread(record["depth_path"], cv2.IMREAD_UNCHANGED)
            if self.is_train:
                out["gt_depth_mm"] = (np.zeros((h, w), np.uint16) if depth is None
                                      else depth_to_mm(depth, self.depth_shift))
            else:
                if depth is None:
                    depth = np.zeros((h, w), np.float32)
                out["gt_depth"] = depth.astype(np.float32) / self.depth_shift
        annos = [a for a in record.get("annotations", []) if a.get("iscrowd", 0) == 0]
        out.update(self._instances(annos, h, w))
        return out

    def _instances(self, annos: List[Dict], h: int, w: int) -> Dict[str, np.ndarray]:
        g = self.max_instances
        mcfg = self.cfg.model
        # a detector-only stage neither rasterises nor ships masks it never reads
        with_masks = mcfg.mask_on or mcfg.refine_on
        boxes = np.zeros((g, 4), np.float32)
        classes = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        masks = np.zeros((g, h, w), np.uint8) if with_masks else None
        planes = np.zeros((g, 3), np.float32)
        rot_axis = np.tile(np.asarray([0, 0, 1, 0], np.float32), (g, 1))
        tran_axis = np.tile(np.asarray([0, 0, 1, 0], np.float32), (g, 1))

        kept = 0
        for a in annos:
            if kept >= g:
                break
            box = convert_box(a["bbox"], int(a.get("bbox_mode", BOXMODE_XYWH_ABS)))
            box = np.clip(box, [0, 0, 0, 0], [w, h, w, h])
            if box[2] <= box[0] or box[3] <= box[1]:  # d2 nonempty() drop
                continue
            i = kept
            boxes[i] = box
            classes[i] = int(a["category_id"])
            valid[i] = True
            if with_masks and "segmentation" in a:
                seg = a["segmentation"]
                if isinstance(seg, list):
                    masks[i] = polygons_to_bitmask(seg, h, w)
                elif isinstance(seg, dict):
                    masks[i] = rle_decode(seg)
                elif isinstance(seg, np.ndarray):
                    masks[i] = seg
            if "plane" in a and a["plane"] is not None:
                planes[i] = np.asarray(a["plane"], np.float32)
            center = (box[:2] + box[2:]) / 2.0
            if a.get("rot_axis") is not None:
                rot_axis[i] = axis_to_angle_offset(
                    np.asarray(a["rot_axis"], np.float32)[None], center[None])[0]
            if a.get("tran_axis") is not None:
                tran_axis[i] = axis_to_angle_offset(
                    np.asarray(a["tran_axis"], np.float32)[None], center[None])[0]
            kept += 1

        out = {"gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid}
        if with_masks:
            if self.is_train:
                # (g, h, ceil(w / 8)) uint8, unpacked on the device by
                # train_step.unpack_bitmasks
                out["gt_masks_packed"] = np.packbits(masks, axis=-1)
            else:
                out["gt_masks"] = masks
        if mcfg.plane_on:
            out["gt_planes"] = planes
        if mcfg.axis_on:
            out["gt_rot_axis"] = rot_axis
            out["gt_tran_axis"] = tran_axis
        return out


def collate(samples: List[Dict[str, np.ndarray]],
            keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Stack per-image arrays into a batch; non-array fields become lists."""
    if not samples:
        return {}
    if keys is None:
        keys = samples[0].keys()
    batch = {}
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals, axis=0)
        else:
            batch[k] = vals
    return batch


class DetectionLoader:
    """Epoch-shuffled batches over a list of records.

    Training (`shuffle`): an endless iterator, epoch e in the order of
    `np.random.RandomState(seed + e).shuffle`, the last partial batch
    dropped.  Evaluation: one ordered pass, the last batch possibly short.

    `batch_size` is the global batch.  With `world_size` W > 1 (training
    only) rank r maps and yields the r-th contiguous 1/W of every global
    batch, in the same order on every rank.
    """

    def __init__(self, records: List[Dict], mapper: PlaneRCNNMapper,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        if world_size > 1 and (not shuffle or batch_size % world_size):
            raise ValueError(f"a training batch of {batch_size} does not split over "
                             f"{world_size} processes")
        self.records = records
        self.mapper = mapper
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __len__(self):
        return (len(self.records) + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch_idx: int = 0):
        order = np.arange(len(self.records))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch_idx).shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.shuffle and len(idx) < self.batch_size:
                continue  # drop the last partial batch in training
            per = len(idx) // self.world_size
            idx = idx[self.rank * per:(self.rank + 1) * per]
            yield collate([self.mapper(self.records[i]) for i in idx])

    def __iter__(self):
        e = 0
        while True:
            yield from self.epoch(e)
            if not self.shuffle:
                return
            e += 1


class PrefetchLoader:
    """Runs any batch iterable on one daemon thread, `depth` batches ahead,
    so the mapper's cv2 and numpy work (which release the GIL) overlaps
    the device step.  An exception in the thread is raised to the
    consumer; a consumer that stops early (`close()` on the iterator)
    stops the thread and waits for it, at most the batch it is mapping."""

    def __init__(self, loader, depth: int = 3):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # raised on the consumer side
                put(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
