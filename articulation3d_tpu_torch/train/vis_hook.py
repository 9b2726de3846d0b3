"""Training-iteration visualization hook (the reference's VIS_PERIOD).

Counterpart of `articulation3d_tpu/train/vis_hook.py`.  The reference dumps
minibatch visualizations during training (`modeling/meta_arch/
planercnn.py:41`, `modeling/roi_heads/roi_heads.py:30-33`, cadence
`VIS_PERIOD`, `config/config.yaml:367`); here the trainer renders, every
`test.vis_period` steps, the first image of its first training dataset
twice, GT boxes and axes beside the current model's predictions, into
`output_dir/vis/iter_XXXXXXX.png`.
"""

from __future__ import annotations

import os

import numpy as np


def save_train_vis(trainer, iteration: int) -> str:
    """Render the GT | current-prediction panels for one train image and
    return the file's path.  One batch-1 `VideoPipeline` over the trainer's
    live model is built on the first call and kept; the model is handed
    back in train mode."""
    import cv2

    from ..data.catalog import get_dataset_dicts, get_metadata
    from ..data.mapper import PlaneRCNNMapper
    from ..vis.visualizer import ArtiVisualizer, draw_gt, draw_pred

    cfg = trainer.cfg
    name = cfg.datasets_train[0]
    metadata = get_metadata(name)

    sample = getattr(trainer, "_vis_sample", None)
    if sample is None:
        record = get_dataset_dicts(name)[0]
        sample = (record, PlaneRCNNMapper(cfg, is_train=False)(record))
        trainer._vis_sample = sample
    record, mapped = sample

    try:
        pipeline = getattr(trainer, "_vis_pipeline", None)
        if pipeline is None:
            from ..video.pipeline import VideoPipeline
            pipeline = VideoPipeline(cfg, trainer.model, batch_size=1, conf_threshold=0.0,
                                     device=trainer.device, distributed=False)
            trainer._vis_pipeline = pipeline
        else:
            trainer.model.eval()
        img_bgr = mapped["images"].astype(np.uint8)
        pred = pipeline.run([img_bgr])[0]
    finally:
        trainer.model.train()

    img_rgb = img_bgr[..., ::-1]
    gt_panel = draw_gt(ArtiVisualizer(img_rgb), record, metadata, metadata.thing_classes)
    # conf 0.3: early-training scores rarely clear the reference's 0.7 vis
    # threshold, and a panel that is always empty shows nothing
    pred_panel = draw_pred(ArtiVisualizer(img_rgb), pred, metadata,
                           metadata.thing_classes, conf_threshold=0.3)
    panel = np.concatenate([gt_panel, pred_panel], axis=1)

    out_dir = os.path.join(cfg.output_dir, "vis")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"iter_{iteration:07d}.png")
    cv2.imwrite(out, panel[..., ::-1])
    return out
