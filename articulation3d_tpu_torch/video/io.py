"""Host-side video decoding (counterpart of `articulation3d_tpu/video/io.py`):
an mp4 (or a single png/jpg) in, (H, W, 3) BGR uint8 frames out."""

from __future__ import annotations

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
