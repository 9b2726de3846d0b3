"""Inputs from the seed: the same seed gives the same frames and weights,
another seed other ones, every seed the same shapes."""

import numpy as np
import torch

from portbench import spec
from portbench import weights as pbweights
from portbench.traffic import frames

PARAMS = {"height": 24, "width": 32, "batch": 2, "pool": 5, "calibration": 2}


def test_frames_follow_the_seed():
    a = frames.make_pool(PARAMS, 2 ** 31 + 11, "cpu")
    b = frames.make_pool(PARAMS, 2 ** 31 + 11, "cpu")
    c = frames.make_pool(PARAMS, 2 ** 31 + 12, "cpu")
    assert a.shape == c.shape == (5, 24, 32, 3) and a.dtype == torch.uint8
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_batches_cycle_the_pool():
    pool = np.arange(5)[:, None, None, None] * np.ones((5, 2, 2, 3), np.uint8)
    it = frames.batches(pool, 2)
    got = [next(it)[:2] for _ in range(4)]
    assert got == [(0, [0, 1]), (1, [2, 3]), (2, [4, 0]), (3, [1, 2])]


def test_weights_follow_the_seed():
    conf = spec.config_file("planercnn_r50fpn_infer")
    a = pbweights.draw_for(conf, 2 ** 31 + 5, "cpu")
    b = pbweights.draw_for(conf, 2 ** 31 + 5, "cpu")
    k = "roi_heads.box_head.fc1.weight"
    assert all(torch.equal(a[n], b[n]) for n in a)
    c = pbweights.draw_for(conf, 7, "cpu")
    assert not torch.equal(a[k], c[k])
    assert {n: tuple(v.shape) for n, v in a.items()} == pbweights.key_shapes()
    assert float(a["proposal_generator.rpn_head.objectness_logits.bias"].mean()) > 3.5
    # the shapes agree with the program's own schema
    from articulation3d_tpu_torch.weights import d2_key_shapes
    prog = {n: s for n, s in d2_key_shapes().items() if "anchor_generator" not in n}
    assert prog == pbweights.key_shapes()
