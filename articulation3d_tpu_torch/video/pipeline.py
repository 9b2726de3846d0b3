"""Batched video inference: frames are the batch axis.

Counterpart of `articulation3d_tpu/video/pipeline.py`:

    uint8 BGR frames -> preprocess -> PlaneRCNN.inference ->
    paste masks at image resolution -> depth-based plane-offset override

(with the refine head on, its full-image masks take the place of the
pasted ones), all on the device; only the detections, packed masks and u16-millimetre
depth come back to the host, where confidence trimming picks each frame's
detections and only their masks are unpacked, into the `FramePrediction`s.
The depth override reproduces the reference's
`PlaneRCNN_Branch.process`: EVAL-intrinsics rays (f = 571.623718), offset =
mean of n . xyz inside each pasted mask; empty masks keep their plane.

Under a process group (JAX `use_mesh`, which shards the frames over the
device mesh) each rank runs a contiguous share of the frames and the
predictions and depths are all-gathered, in frame order, to every rank.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..config import Config
from ..models.planercnn import PlaneRCNN
from ..ops.mask_paste import paste_masks
from ..ops.preprocess import preprocess_images
from ..parallel.dist import gather_predictions, process_count, process_index
from ..structures import FramePrediction, resolve_device
from ..utils.camera import get_k_inv_dot_xy_1_eval
from ..utils.coords import camera_to_plane, plane_to_camera


def pack_masks_bits(masks: torch.Tensor) -> torch.Tensor:
    """Bool masks (..., W) -> uint8 bitmaps (..., ceil(W / 8)), big-endian
    bit order (host side: `np.unpackbits(arr, axis=-1, count=W)`)."""
    w = masks.shape[-1]
    pad = (-w) % 8
    if pad:
        masks = torch.nn.functional.pad(masks, (0, pad))
    grouped = masks.reshape(*masks.shape[:-1], (w + pad) // 8, 8).to(torch.uint8)
    with tracing.sync("pack", masks):
        bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                            device=masks.device)
    return (grouped * bits).sum(dim=-1, dtype=torch.uint8)


def override_plane_offsets(planes: torch.Tensor, full_masks: torch.Tensor,
                           depth: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Depth-based plane offset re-estimation for one image.

    planes (D, 3) stored convention; full_masks (D, H, W) bool; depth
    (H, W); rays (3, H, W) EVAL-intrinsics back-projection.
    """
    xyz = rays * depth[None]
    cam = plane_to_camera(planes)
    offset = torch.linalg.norm(cam, dim=1)
    normal = cam / offset.clamp(min=1e-8)[:, None]
    m = full_masks.to(torch.float32)
    count = m.sum(dim=(1, 2))
    ndotxyz = torch.einsum("dc,chw->dhw", normal, xyz)
    offset_new = (ndotxyz * m).sum(dim=(1, 2)) / count.clamp(min=1.0)
    new_planes = camera_to_plane(normal * offset_new[:, None])
    return torch.where((count > 0)[:, None], new_planes, planes)


def make_inference_step(config: Config, model: PlaneRCNN,
                        output_height: Optional[int] = None,
                        output_width: Optional[int] = None
                        ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The batched step: (B, H, W, 3) uint8 BGR frames on the model's device
    -> dict of device tensors (boxes, scores, classes, valid, planes,
    rot_axis, tran_axis, full_masks_packed, depth_mm, pool_valid_*).

    `output_height/width` rescale detections to another output resolution
    (d2 `detector_postprocess`): boxes scale and clip to the output size and
    masks paste at output resolution.  Default: the model resolution.
    """
    h, w = config.input.height, config.input.width
    out_h = output_height or h
    out_w = output_width or w
    mcfg = config.model
    dev = next(model.parameters()).device
    rays = torch.from_numpy(get_k_inv_dot_xy_1_eval(out_h, out_w).reshape(
        3, out_h, out_w).astype(np.float32)).to(dev)

    @torch.no_grad()
    def step(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        with tracing.span("step.preprocess"):
            images = preprocess_images(frames, config.input.pixel_mean,
                                       config.input.pixel_std, height=h, width=w,
                                       size_divisibility=config.input.size_divisibility)
        with tracing.span("step.model"):
            out = model.inference(images)
        det = out["detections"]
        boxes = det.boxes
        if (out_h, out_w) != (h, w):
            sx, sy = out_w / w, out_h / h
            scale = torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype, device=dev)
            limit = torch.tensor([out_w, out_h, out_w, out_h], dtype=boxes.dtype,
                                 device=dev)
            boxes = torch.minimum((boxes * scale).clamp(min=0.0), limit)
        result = {"boxes": boxes, "scores": det.scores, "classes": det.classes,
                  "valid": det.valid}
        for k, v in out["pool_valid"].items():
            result[f"pool_valid_{k}"] = v
        if det.planes is not None:
            result["planes"] = det.planes
        if det.rot_axis is not None:
            result["rot_axis"] = det.rot_axis
            result["tran_axis"] = det.tran_axis
        full = None
        if "full_masks" in out:
            # the refine head's masks, already at image resolution
            full = out["full_masks"] >= 0.5
        elif det.masks is not None:
            with tracing.span("step.paste"):
                full = torch.stack([
                    paste_masks(det.masks[i], boxes[i], det.valid[i], out_h, out_w,
                                threshold=mcfg.mask_head.mask_threshold,
                                nms=mcfg.mask_head.nms)
                    for i in range(boxes.shape[0])])
        depth = out.get("depth")
        if (depth is not None and det.planes is not None and full is not None
                and tuple(depth.shape[1:]) == (out_h, out_w)):
            with tracing.span("step.override"):
                result["planes"] = torch.stack([
                    override_plane_offsets(result["planes"][i], full[i], depth[i], rays)
                    for i in range(boxes.shape[0])])
        with tracing.span("step.pack"):
            if full is not None:
                result["full_masks_packed"] = pack_masks_bits(full)
            if depth is not None:
                # u16 millimetres on the wire (the source data's own depth
                # resolution); float->int truncates as the JAX uint16 cast does
                result["depth_mm"] = (depth * 1000.0).clamp(0.0, 65535.0).to(torch.int32)
        return result

    return step


class VideoPipeline:
    """Host wrapper: list of frames -> per-frame `FramePrediction`s.

    `distributed` (default: under a process group of more than one rank)
    splits each `run` over the ranks (module docstring); every rank must
    call `run` with the same frames."""

    def __init__(self, config: Config, model: PlaneRCNN, batch_size: int = 8,
                 conf_threshold: float = 0.7, output_height: Optional[int] = None,
                 output_width: Optional[int] = None, device=None,
                 distributed: Optional[bool] = None):
        self.device = resolve_device(device)
        self.distributed = process_count() > 1 if distributed is None else distributed
        self.config = config
        self.model = model.to(self.device).eval()
        self.conf_threshold = conf_threshold
        self.batch_size = batch_size
        self.output_height = output_height or config.input.height
        self.output_width = output_width or config.input.width
        self.step = make_inference_step(config, self.model, output_height,
                                        output_width)
        self.depths: List[Optional[np.ndarray]] = []
        self.chunk_walls: List[float] = []
        self.pool_valid: Dict[str, int] = {}

    def run(self, frames: Sequence[np.ndarray],
            verbose: bool = False) -> List[FramePrediction]:
        """frames: (H, W, 3) uint8 BGR arrays -> trimmed FramePredictions,
        and `self.depths`, one per frame.  Short last chunks are padded with
        repeats of their last frame.  verbose: per-chunk wall time on
        stderr (the first includes the kernel build and cuDNN autotuning).
        `chunk_walls` and `pool_valid` describe this rank's share."""
        with tracing.span("pipeline.run", call=True):
            if not self.distributed:
                return self._run(frames, verbose)
            per = -(-len(frames) // process_count())
            lo = process_index() * per
            mine = self._run(frames[lo:lo + per], verbose)
            shares = gather_predictions([(mine, self.depths)])
            self.depths = [d for _, depths in shares for d in depths]
            return [p for preds, _ in shares for p in preds]

    def _run(self, frames: Sequence[np.ndarray],
             verbose: bool) -> List[FramePrediction]:
        preds: List[FramePrediction] = []
        depths: List[Optional[np.ndarray]] = []
        self.chunk_walls = []
        self.pool_valid = {}
        bs = self.batch_size
        for start in range(0, len(frames), bs):
            with tracing.span("pipeline.upload", timed=True) as upload:
                chunk = list(frames[start:start + bs])
                n_real = len(chunk)
                chunk += [chunk[-1]] * (bs - n_real)
                batch = torch.from_numpy(np.stack(chunk))
                with tracing.sync("upload", self.device):
                    batch = batch.to(self.device)
            with tracing.span("pipeline.step"):
                dev_out = self.step(batch)
            with tracing.span("pipeline.readback", timed=True) as readback:
                out = {}
                for k, v in dev_out.items():
                    with tracing.sync("readback", v):
                        out[k] = v.cpu().numpy()
                    tracing.count("readback.bytes", out[k].nbytes)
            del dev_out
            # step and readback: from the upload's start to the readback's end
            self.chunk_walls.append((readback.end_ns - upload.start_ns) * 1e-9)
            if verbose:
                print(f"#   chunk {len(self.chunk_walls)}: "
                      f"{self.chunk_walls[-1]:.3f}s ({n_real} frames)",
                      file=sys.stderr, flush=True)
            for k in [k for k in out if k.startswith("pool_valid_")]:
                name = k[len("pool_valid_"):]
                self.pool_valid[name] = self.pool_valid.get(name, 0) + int(out.pop(k).sum())
            with tracing.span("pipeline.unpack"):
                # trim first, then unpack only the kept rows: each frame's
                # masks are written once, into the array it keeps
                packed = out.pop("full_masks_packed", None)
                kept = []
                for i in range(n_real):
                    idx = np.nonzero(out["valid"][i]
                                     & (out["scores"][i] > self.conf_threshold))[0]
                    masks = None
                    if packed is not None:
                        masks = np.unpackbits(packed[i][idx], axis=-1,
                                              count=self.output_width).view(bool)
                        tracing.count("unpack.rows", len(idx))
                        tracing.count("unpack.slots", packed.shape[1])
                    kept.append((idx, masks))
                if "depth_mm" in out:
                    out["depth"] = (out.pop("depth_mm").astype(np.uint16)
                                    .astype(np.float32) / 1000.0)
            with tracing.span("pipeline.frame_predictions"):
                for i, (idx, masks) in enumerate(kept):
                    preds.append(self._to_frame_prediction(out, i, idx, masks))
                    depths.append(out["depth"][i] if "depth" in out else None)
        if verbose and len(self.chunk_walls) > 1:
            steady = sum(self.chunk_walls[1:]) / (len(self.chunk_walls) - 1)
            print(f"#   steady-state: {steady:.3f}s/chunk ({bs / steady:.1f} "
                  f"frames/s); first chunk {self.chunk_walls[0]:.3f}s",
                  file=sys.stderr, flush=True)
        self.depths = depths
        return preds

    def _to_frame_prediction(self, out: Dict[str, np.ndarray], i: int,
                             idx: np.ndarray, masks: Optional[np.ndarray]
                             ) -> FramePrediction:
        """Frame `i`'s detections at the kept slots `idx`; `masks`: their
        unpacked masks (None: the step sent none, zeros)."""
        zeros = lambda *s: np.zeros(s, np.float32)
        return FramePrediction(
            boxes=out["boxes"][i][idx],
            scores=out["scores"][i][idx],
            classes=out["classes"][i][idx],
            masks=(masks if masks is not None
                   else zeros(len(idx), self.output_height, self.output_width)),
            planes=(out["planes"][i][idx] if "planes" in out else zeros(len(idx), 3)),
            rot_axis=(out["rot_axis"][i][idx] if "rot_axis" in out
                      else zeros(len(idx), 3)),
            tran_axis=(out["tran_axis"][i][idx] if "tran_axis" in out
                       else zeros(len(idx), 2)),
        )
