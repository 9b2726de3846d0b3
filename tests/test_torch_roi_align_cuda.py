"""The ROIAlign CUDA kernel against its plain torch version, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit (from the repository root):

    python -m pytest tests/test_torch_roi_align_cuda.py --noconftest -m cuda -q

Elsewhere each test skips itself.  Tolerances: float32 1e-5 x max |out|
(the same float32 sums in another order); bfloat16 1e-2 x max |out| (the
stated bf16 budget; kernel and plain version read the same bf16 features
with float32 weights).  Invalid ROIs must give exact zeros.
"""

import numpy as np
import pytest
import torch

from articulation3d_tpu_torch.ops import roi_align_cuda as rac

STRIDES = (4, 8, 16, 32)
POOLS = [(7, 0, True), (14, 2, False), (14, 0, False)]   # box, mask, plane


def _boxes(rs, n):
    sizes = rs.uniform(20, 480, (1, n, 1))
    x1 = rs.uniform(0, 600, (1, n, 1))
    y1 = rs.uniform(0, 440, (1, n, 1))
    boxes = np.concatenate([x1, y1, np.minimum(x1 + sizes, 640),
                            np.minimum(y1 + sizes * 0.7, 480)], 2)
    nine = [[[10.0, 200.0, 344.0, 237.0], [200.0, 10.0, 237.0, 444.0]]]
    return np.concatenate([boxes, nine], 1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("p,sr,aligned", POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(p, sr, aligned, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = [torch.randn((1, h, w, 256), generator=gen, device="cuda").to(dtype)
             for h, w in ((120, 160), (60, 80), (30, 40), (15, 20))]
    boxes = torch.from_numpy(_boxes(np.random.RandomState(0), 64)).cuda()
    valid = torch.rand(boxes.shape[:2], generator=gen, device="cuda") > 0.2
    kw = dict(strides=STRIDES, output_size=p, sampling_ratio=sr, aligned=aligned,
              valid=valid)
    before = rac.multilevel_roi_align_cuda.launches
    got = rac.multilevel_roi_align_cuda(feats, boxes, **kw)
    assert rac.multilevel_roi_align_cuda.launches == before + 1
    want = rac.multilevel_roi_align_separable(feats, boxes, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert bool((got[~valid] == 0).all())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    feats = [torch.zeros((1, h, w, 8), device="cuda", dtype=torch.float16)
             for h, w in ((64, 80), (32, 40), (16, 20), (8, 10))]
    boxes = torch.zeros((1, 2, 4), device="cuda")
    with pytest.raises(TypeError):
        rac.multilevel_roi_align_cuda(feats, boxes, strides=STRIDES, output_size=7,
                                      sampling_ratio=0, aligned=True)
    with pytest.raises(ValueError):
        rac.multilevel_roi_align_cuda([f.float() for f in feats], boxes,
                                      strides=STRIDES, output_size=20,
                                      sampling_ratio=0, aligned=True)
