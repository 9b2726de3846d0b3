"""Host-side video IO (counterpart of `articulation3d_tpu/video/io.py`): an
mp4 (or a single png/jpg) in, (H, W, 3) BGR uint8 frames out; the
side-by-side visualisation mp4 out."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import cv2
import numpy as np


def read_frames(path: str, height: int = 480, width: int = 640
                ) -> Tuple[List[np.ndarray], Optional[float]]:
    """Decode a video or a single image to (H, W, 3) BGR uint8 frames.

    Returns (frames, fps); fps is None for still images.  Videos go through
    imageio/ffmpeg where installed, else OpenCV.
    """
    if path.endswith(".png") or path.endswith(".jpg"):
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return [cv2.resize(img, (width, height))], None

    try:
        import imageio
        reader = imageio.get_reader(path)
    except ImportError:
        reader = None
    except ValueError as e:
        # imageio reports a missing backend plugin as ValueError; other
        # decode errors propagate
        if "backend" not in str(e).lower() and "ffmpeg" not in str(e).lower():
            raise
        reader = None
    if reader is not None:
        fps = reader.get_meta_data().get("fps", 30.0)
        frames = []
        for im in reader:                              # imageio yields RGB
            frames.append(cv2.resize(im, (width, height))[:, :, ::-1].copy())
        reader.close()
        return frames, float(fps)

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, im = cap.read()                            # OpenCV yields BGR
        if not ok:
            break
        frames.append(cv2.resize(im, (width, height)))
    cap.release()
    return frames, float(fps)


def write_video(path: str, frames: List[np.ndarray], fps: float = 30.0,
                bgr: bool = True) -> None:
    """Write (H, W, 3) uint8 frames to an mp4 (imageio/ffmpeg, cv2 fallback)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio
        writer = imageio.get_writer(path, fps=fps)
    except ImportError:
        writer = None                      # no imageio/ffmpeg: use OpenCV
    except ValueError as e:
        # same contract as read_frames: only a missing backend plugin
        # ("Could not find a backend to write ...") reroutes to cv2;
        # genuine encode errors (bad codec args, unwritable path) propagate
        if "backend" not in str(e).lower() and "ffmpeg" not in str(e).lower():
            raise
        writer = None
    if writer is not None:
        for f in frames:
            writer.append_data(f[:, :, ::-1] if bgr else f)
        writer.close()
        return
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f if bgr else f[:, :, ::-1]))
    vw.release()
