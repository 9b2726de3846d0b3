"""Multilevel ROIAlign forward and its adjoint as hand-written CUDA kernels
for Hopper, and the training pooler built from the two.

Counterpart of `articulation3d_tpu/ops/roi_align_pallas.py`, computing what
the reference computes: every ROI is pooled from the level detectron2
assigns it (`assign_boxes_to_levels`), as `ops/roi_align.py::
multilevel_roi_align` does.  It holds:

  * the torch prologue (`_prepare`), which folds the sampling of each ROI
    into separable weights: V1/V2 offsets, the adaptive sample count,
    bilinear corners, zeros outside the map and 1/n averaging give Ry
    (P, ny) and Rx (P, nx) over the ny x nx cells the ROI's samples touch
    on its level, from (y0, x0).  It feeds the plain versions;
  * `_roi_record`, the per-ROI integers (level, y0, x0, ny, nx) as the
    kernels' own prologue (`csrc/roi_align_prologue.cuh`) computes them,
    for the tests;
  * K1, the forward: the wrapper `multilevel_roi_align_cuda`, which
    launches `csrc/roi_align_fwd.cu` (prologue fused in: boxes in, pooled
    features and the int32 record out) for CUDA tensors, and its plain
    version `multilevel_roi_align_separable`;
  * K2, the adjoint with respect to the features: the wrapper
    `multilevel_roi_align_adjoint_cuda`, which launches
    `csrc/roi_align_adj.cu` from the boxes and K1's record, and its plain
    version `multilevel_roi_align_adjoint_separable`;
  * K3, `multilevel_roi_align_train`: a `torch.autograd.Function` whose
    forward is K1 and whose backward is K2 (the JAX `_train_pool`
    custom VJP), or the gather formulation under torch autograd.

Each wrapper takes its plain version for CPU tensors only; the tests and
`chip_smoke.py` hold the kernels against the plain versions.

Every function takes `adaptive_cap`: with sampling ratio 0 an ROI takes
ceil(bin) samples per bin and axis, uncapped as torchvision does (None,
the default), or at most `adaptive_cap` (the JAX package's Pallas prologue
caps at 4, so its parity tests pass 4).  The kernels take the cap as a
run-time option (0: uncapped).

Layout: features are channels-last (B, H_l, W_l, C), as in the JAX package.
The output is (B, N, P, P, C) float32 in [row, col, C] order.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import tracing
from . import cuda_build
from .roi_align import _sample_coords, assign_boxes_to_levels, multilevel_roi_align

MAX_P = 16    # output sizes the kernels' shared-memory arrays hold
RECORD = ("levels", "y0", "x0", "ny", "nx")   # the (T, 5) record's columns
# cells per chunk of the plain versions (times C float32 values)
_CHUNK_CELLS = 1 << 16


def _cells(lo: torch.Tensor, hi: torch.Tensor, size: torch.Tensor):
    """First cell and cell count (int64) between the bilinear corners of an
    axis's lowest and highest sample coordinate, clipped to [0, size)."""
    last = (size - 1).to(torch.float32)
    first = torch.floor(torch.minimum(lo.clamp(min=0.0), last))
    end = torch.minimum(torch.floor(torch.minimum(hi.clamp(min=0.0), last)) + 1.0, last)
    return first.to(torch.int64), (end - first).to(torch.int64) + 1


def _separable_weights(coord, mask, n_s, size, origin, span):
    """Fold sampling, bilinear corners and averaging into (N, P, span)
    weights relative to `origin`.

    coord (N, P, S) absolute sample coordinates on the ROI's level; mask
    (N, P, S) adaptive-sample mask; n_s (N,) sample counts; size (N,) real
    level extent; origin (N,) the ROI's first cell (`_cells`), so every
    corner of a sample lands in [0, span).
    """
    h = size[:, None, None].to(torch.float32)
    hi = size[:, None, None]
    oor = (coord < -1.0) | (coord > h)
    y = coord.clamp(min=0.0)
    y_low = torch.minimum(y.to(torch.int64), hi - 1)
    y_high = torch.minimum(y_low + 1, hi - 1)
    y = torch.where(y.to(torch.int64) >= hi - 1, y_low.to(y.dtype), y)
    ly = y - y_low.to(y.dtype)
    hy = 1.0 - ly
    zero = torch.zeros_like(ly)
    w_lo = torch.where(oor, zero, hy) * mask
    w_hi = torch.where(oor, zero, ly) * mask
    # samples beyond an ROI's own count carry no weight and may lie past
    # its last cell: park them on cell 0
    used = mask > 0
    rel_lo = torch.where(used, y_low - origin[:, None, None], 0)
    rel_hi = torch.where(used, y_high - origin[:, None, None], 0)
    w = torch.zeros((*coord.shape[:2], span), dtype=torch.float32, device=coord.device)
    w.scatter_add_(2, rel_lo, w_lo)
    w.scatter_add_(2, rel_hi, w_hi)
    return w / n_s.clamp(min=1)[:, None, None].to(torch.float32)


def _prepare(level_shapes: Sequence[Sequence[int]], boxes: torch.Tensor, *,
             strides: Sequence[int], output_size: int, sampling_ratio: int,
             aligned: bool, min_level: int = 2,
             valid: Optional[torch.Tensor] = None,
             adaptive_cap: Optional[int] = None) -> dict:
    """Per-ROI prologue of the plain versions (the counterpart of the
    Pallas prologue, roi_align_pallas.py:273-375), at detectron2's level.

    level_shapes: per level (B, H_l, W_l, C); boxes (B, N, 4).  Returns
    levels, batch_ids, y0, x0, ny, nx as (T,) int32 (T = B*N; the record's
    integers, ny = 0 for an invalid ROI) and the weights ry (T, P, NY) and
    rx (T, P, NX) float32 from (y0, x0), NY and NX the largest ny and nx
    (zero beyond an ROI's own).
    """
    bsz, n = boxes.shape[:2]
    p = output_size
    dev = boxes.device
    flat_boxes = boxes.reshape(bsz * n, 4).to(torch.float32)
    total = bsz * n
    levels = assign_boxes_to_levels(flat_boxes, min_level=min_level,
                                    max_level=min_level + len(level_shapes) - 1) - min_level
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    heights = as_t([int(s[1]) for s in level_shapes])[levels]
    widths = as_t([int(s[2]) for s in level_shapes])[levels]
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)[levels]

    ys, xs, y_mask, x_mask = _sample_coords(flat_boxes, scales, p,
                                            sampling_ratio, aligned, adaptive_cap)
    if sampling_ratio > 0:
        n_sh = torch.full((total,), sampling_ratio, dtype=torch.int64, device=dev)
        n_sw = n_sh
    else:
        n_sh = y_mask[:, 0, :].sum(dim=1).to(torch.int64)
        n_sw = x_mask[:, 0, :].sum(dim=1).to(torch.int64)

    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    y0, ny = _cells(torch.where(y_mask > 0, ys, big).amin(dim=(1, 2)),
                    torch.where(y_mask > 0, ys, -big).amax(dim=(1, 2)), heights)
    x0, nx = _cells(torch.where(x_mask > 0, xs, big).amin(dim=(1, 2)),
                    torch.where(x_mask > 0, xs, -big).amax(dim=(1, 2)), widths)
    span_y = int(ny.max()) if total else 1
    span_x = int(nx.max()) if total else 1
    ry = _separable_weights(ys, y_mask, n_sh, heights, y0, span_y)
    rx = _separable_weights(xs, x_mask, n_sw, widths, x0, span_x)
    if valid is not None:
        ny = torch.where(valid.reshape(total), ny, torch.zeros_like(ny))
    batch_ids = torch.arange(bsz, dtype=torch.int64, device=dev).repeat_interleave(n)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return dict(levels=i32(levels), batch_ids=i32(batch_ids), y0=i32(y0), x0=i32(x0),
                ny=i32(ny), nx=i32(nx), ry=ry.contiguous(), rx=rx.contiguous())


def multilevel_roi_align_separable(features: Sequence[torch.Tensor],
                                   boxes: torch.Tensor, *,
                                   strides: Sequence[int], output_size: int,
                                   sampling_ratio: int, aligned: bool,
                                   min_level: int = 2,
                                   valid: Optional[torch.Tensor] = None,
                                   adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """The plain torch version of K1.

    Per ROI: out[p, q, c] = sum_y sum_x Ry[p, y] Rx[q, x] F[y0 + y, x0 + x, c]
    over the ny x nx cells at (y0, x0) of its detectron2 level; invalid
    ROIs give zeros.  The same linear map as the gather
    `ops/roi_align.py::multilevel_roi_align`, summed in another order.
    Weights stay float32 for bf16 features; the sum is float32.
    """
    bsz, n = boxes.shape[:2]
    pr = _prepare([f.shape for f in features], boxes, strides=strides,
                  output_size=output_size, sampling_ratio=sampling_ratio,
                  aligned=aligned, min_level=min_level, valid=valid,
                  adaptive_cap=adaptive_cap)
    out = _separable_forward(features, pr, output_size)
    return out.reshape(bsz, n, output_size, output_size, -1)


def _roi_chunks(pr: dict, lvl: int, p: int):
    """The valid ROIs of one level in chunks of like-sized cell blocks, as
    (rois, NY, NX): NY x NX holds every chunk ROI's ny x nx, and a chunk's
    k * max(NY, P) * max(NX, P) cells (its blocks, and the products with
    one axis contracted) stay within `_CHUNK_CELLS`, unless one ROI alone
    exceeds it."""
    ny, nx = pr["ny"].long(), pr["nx"].long()
    sel = torch.nonzero((pr["levels"] == lvl) & (ny > 0)).flatten()
    if not sel.numel():
        return
    sel = sel[torch.argsort(ny[sel] * nx[sel], stable=True)]
    sizes = torch.stack([ny[sel], nx[sel]], 1).tolist()
    lo = 0
    while lo < len(sizes):
        hi, my, mx = lo, 1, 1
        while hi < len(sizes):
            my2, mx2 = max(my, sizes[hi][0]), max(mx, sizes[hi][1])
            if hi > lo and (hi + 1 - lo) * max(my2, p) * max(mx2, p) > _CHUNK_CELLS:
                break
            my, mx, hi = my2, mx2, hi + 1
        yield sel[lo:hi], my, mx
        lo = hi


def _cell_index(pr: dict, r: torch.Tensor, my: int, mx: int, shape) -> torch.Tensor:
    """Flat row index (k, my, mx) of the ROIs' cells in a (B, H, W, C)
    level; cells beyond an ROI's ny x nx point at row B*H*W."""
    bsz, h, w = (int(v) for v in shape[:3])
    dev = r.device
    ky = torch.arange(my, device=dev)
    kx = torch.arange(mx, device=dev)
    y0, x0 = pr["y0"].long()[r], pr["x0"].long()[r]
    rows = pr["batch_ids"].long()[r] * h + y0
    idx = (rows[:, None, None] + ky[:, None]) * w + x0[:, None, None] + kx
    inside = ((ky < pr["ny"].long()[r, None])[:, :, None]
              & (kx < pr["nx"].long()[r, None])[:, None, :])
    return torch.where(inside, idx, bsz * h * w)


def _separable_forward(features: Sequence[torch.Tensor], pr: dict, p: int) -> torch.Tensor:
    """The plain forward from a `_prepare` result: (T, P, P, C) float32."""
    c = features[0].shape[-1]
    dev = pr["ry"].device
    out = torch.zeros((pr["levels"].numel(), p, p, c), dtype=torch.float32, device=dev)
    for lvl, f in enumerate(features):
        flat = torch.cat([f.reshape(-1, c), f.new_zeros((1, c))])
        for r, my, mx in _roi_chunks(pr, lvl, p):
            cells = flat[_cell_index(pr, r, my, mx, f.shape)].to(torch.float32)
            out[r] = torch.einsum("kpy,kyxc,kqx->kpqc", pr["ry"][r, :, :my], cells,
                                  pr["rx"][r, :, :mx])
    return out


def multilevel_roi_align_adjoint_separable(g: torch.Tensor,
                                           feat_shapes: Sequence[Sequence[int]],
                                           pr: dict) -> List[torch.Tensor]:
    """The plain torch version of K2: the gradient of the plain forward
    with respect to the features.

    g: (T, P, P, C) or (B, N, P, P, C) pooled cotangent; feat_shapes: per
    level (B, H_l, W_l, C); pr: the `_prepare` result of the forward.  Per
    valid ROI the cotangent of its cells, dwin[y, x, c] = sum_p sum_q
    Ry[p, y] Rx[q, x] g[p, q, c], is added into its level at (y0, x0).
    Returns float32 (B, H_l, W_l, C) gradients.
    """
    p = g.shape[-2]
    c = g.shape[-1]
    gf = g.reshape(-1, p, p, c).to(torch.float32)
    grads = []
    for lvl, shape in enumerate(feat_shapes):
        bsz, h, w = (int(v) for v in shape[:3])
        acc = torch.zeros((bsz * h * w + 1, c), dtype=torch.float32, device=gf.device)
        for r, my, mx in _roi_chunks(pr, lvl, p):
            # transpose of the forward's products, Rx first as in the kernel
            t = torch.einsum("kpqc,kqx->kpxc", gf[r], pr["rx"][r, :, :mx])
            dwin = torch.einsum("kpy,kpxc->kyxc", pr["ry"][r, :, :my], t)
            # index_add_ sums in index order on the CPU (index_put_'s
            # accumulate may not), so the plain version is deterministic there
            acc.index_add_(0, _cell_index(pr, r, my, mx, shape).reshape(-1),
                           dwin.reshape(-1, c))
        grads.append(acc[:-1].reshape(bsz, h, w, c))
    return grads


def _record_of(pr: dict) -> torch.Tensor:
    """The (T, 5) int32 record (level, y0, x0, ny, nx) of a `_prepare`
    result."""
    return torch.stack([pr[k] for k in RECORD], dim=1).to(torch.int32)


def _roi_record(level_shapes: Sequence[Sequence[int]], boxes: torch.Tensor, *,
                strides: Sequence[int], output_size: int, sampling_ratio: int,
                aligned: bool, min_level: int = 2,
                valid: Optional[torch.Tensor] = None,
                adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """The per-ROI record (level, y0, x0, ny, nx) as K1's fused prologue
    (`csrc/roi_align_prologue.cuh`) computes it: (T, 5) int32.

    The torch twin of the device code, operation for operation: it works
    per ROI from the sample start, bin size and sample count, takes an
    axis's extreme samples in closed form (the first and last sample,
    swapped for a negative bin) instead of reducing (T, P, S) coordinates,
    and divides by a constant as torch's CUDA `div` does for a Python
    scalar, by multiplying with its float32 reciprocal.  `_prepare` gives
    the same integers; the tests and `chip_smoke.py` hold the three
    (`_prepare`, this, the kernel) against each other.
    """
    p = output_size
    dev = boxes.device
    fb = boxes.reshape(-1, 4).to(torch.float32)
    n_levels = len(level_shapes)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32).to(dev)

    def recip(d):
        return (torch.tensor(1.0, dtype=torch.float32)
                / torch.tensor(float(d), dtype=torch.float32)).to(dev)

    # detectron2's level (`assign_boxes_to_levels`)
    area = (fb[:, 2] - fb[:, 0]).clamp(min=0) * (fb[:, 3] - fb[:, 1]).clamp(min=0)
    t = torch.sqrt(area) * recip(224.0) + f32(1e-8)
    levels = (torch.floor(f32(4.0) + torch.log2(t))
              .clamp(min_level, min_level + n_levels - 1).to(torch.int64) - min_level)

    scale = f32([1.0 / s for s in strides])[levels]
    off = f32(0.5 if aligned else 0.0)
    inv_p = recip(p)

    def extent(lo, hi):
        start = lo * scale - off
        length = (hi * scale - off) - start
        if not aligned:
            length = length.clamp(min=1.0)
        bin_sz = length * inv_p
        if sampling_ratio > 0:
            n = torch.full_like(start, float(sampling_ratio))
        else:
            n = torch.ceil(bin_sz).to(torch.int32).clamp(1, adaptive_cap).to(torch.float32)
        first = start + (f32(0.0) + f32(0.5) / n) * bin_sz
        last = start + (f32(float(p - 1)) + ((n - 1.0) + f32(0.5)) / n) * bin_sz
        pos = bin_sz >= 0
        return torch.where(pos, first, last), torch.where(pos, last, first)

    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    y0, ny = _cells(*extent(fb[:, 1], fb[:, 3]),
                    as_t([int(s[1]) for s in level_shapes])[levels])
    x0, nx = _cells(*extent(fb[:, 0], fb[:, 2]),
                    as_t([int(s[2]) for s in level_shapes])[levels])
    if valid is not None:
        ny = torch.where(valid.reshape(-1), ny, torch.zeros_like(ny))
    return torch.stack([levels, y0, x0, ny, nx], dim=1).to(torch.int32)


# --------------------------------------------------------------------------- #
# the kernels: bind (`cuda_build.py` builds them), launch
# --------------------------------------------------------------------------- #

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_OPTS = [_F, _F, _F, _F,                                  # 1/stride per level
         _I, _I, _I, _I, _I, _I]                          # C, P, ratio, aligned,
                                                          # min_level, cap (0: none)
_ARGTYPES = {
    "roi_align_fwd": [_VP, _VP, _VP, _VP, _I,             # f2..f5, dtype
                      _I, _I, _I, _I, _I, _I, _I, _I,     # h2, w2 .. h5, w5
                      *_OPTS,
                      _VP, _VP, _I,                       # boxes, valid, N
                      _VP, _VP, _I, _VP],                 # record, out, T, stream
    "roi_align_adj": [_VP, _VP, _VP, _VP,                 # d2..d5 (float32)
                      _I, _I, _I, _I, _I, _I, _I, _I,     # h2, w2 .. h5, w5
                      *_OPTS,
                      _VP, _VP, _I,                       # boxes, record, N
                      _VP, _I, _VP],                      # g, T, stream
}


def _load(name: str = "roi_align_fwd"):
    return cuda_build.load(name, _ARGTYPES[name])


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels per 16-byte load


def _hw(shapes: Sequence[Sequence[int]]) -> List[int]:
    hw = []
    for s in shapes:
        hw += [int(s[1]), int(s[2])]
    return hw


def _opt_args(opts: dict, c: int) -> list:
    """The kernels' option arguments: 1/stride per level as float32 (the
    values of the prologue's scale table), C, P, the ratio, aligned, the
    min level and the adaptive cap (0: uncapped)."""
    scales = torch.tensor([1.0 / s for s in opts["strides"]], dtype=torch.float32).tolist()
    cap = opts.get("adaptive_cap")
    if cap is not None and int(cap) < 1:
        raise ValueError(f"adaptive_cap must be None or at least 1, got {cap}")
    return [*scales, int(c), int(opts["output_size"]), int(opts["sampling_ratio"]),
            int(bool(opts["aligned"])), int(opts.get("min_level", 2)), int(cap or 0)]


def _launch(features: Sequence[torch.Tensor], boxes: torch.Tensor,
            valid: Optional[torch.Tensor], opts: dict, record: torch.Tensor,
            out: torch.Tensor) -> None:
    """K1 on checked inputs: boxes (B, N, 4) float32, valid (B, N) bool or
    None; writes record (T, 5) int32 and out (T, P, P, C) float32."""
    lib = _load("roi_align_fwd")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.roi_align_fwd(
        *[f.data_ptr() for f in features], _DTYPES[features[0].dtype],
        *_hw([f.shape for f in features]), *_opt_args(opts, features[0].shape[-1]),
        boxes.data_ptr(), None if valid is None else valid.data_ptr(),
        int(boxes.shape[1]), record.data_ptr(), out.data_ptr(), int(record.shape[0]),
        stream)
    if err != 0:
        raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {err}")


def _launch_adj(g: torch.Tensor, boxes: torch.Tensor, record: torch.Tensor,
                opts: dict, grads: Sequence[torch.Tensor]) -> None:
    """K2 on checked inputs: adds into the zeroed float32 level gradients."""
    lib = _load("roi_align_adj")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = lib.roi_align_adj(
        *[d.data_ptr() for d in grads], *_hw([d.shape for d in grads]),
        *_opt_args(opts, g.shape[-1]), boxes.data_ptr(), record.data_ptr(),
        int(boxes.shape[1]), g.data_ptr(), int(record.shape[0]), stream)
    if err != 0:
        raise RuntimeError(f"roi_align_adj launch failed: CUDA error {err}")


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _kernel_boxes(boxes: torch.Tensor, valid: Optional[torch.Tensor],
                  output_size: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Boxes as the kernels read them, float32 and contiguous (no copy when
    they already are), and `valid` contiguous."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError("boxes must be (B, N, 4)")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != boxes.shape[:2]
                              or valid.device != boxes.device):
        raise TypeError("valid must be a bool (B, N) tensor on the boxes' device")
    if not 1 <= output_size <= MAX_P:
        raise ValueError(f"output_size must be in [1, {MAX_P}]")
    return (boxes.to(torch.float32).contiguous(),
            None if valid is None else valid.contiguous())


def _check_features(features: Sequence[torch.Tensor], boxes: torch.Tensor) -> None:
    if len(features) != 4:
        raise ValueError("the kernel pools exactly four levels (p2..p5)")
    dtype = features[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in features):
        raise TypeError(f"features must all be float32 or bfloat16, got "
                        f"{[f.dtype for f in features]}")
    c = features[0].shape[-1]
    for f in features:
        if (f.device != boxes.device or f.dim() != 4 or f.shape[-1] != c
                or f.shape[0] != boxes.shape[0] or not f.is_contiguous()
                or not _aligned16(f)):
            raise ValueError("features must be contiguous, 16-byte aligned "
                             "(B, H, W, C) tensors on the boxes' device")
    if c % _VEC[dtype] != 0:
        raise ValueError(f"C must be a multiple of {_VEC[dtype]} for {dtype}, got {c}")


def _forward_kernel(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                    valid: Optional[torch.Tensor],
                    opts: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, prologue fused in: ((T, P, P, C) float32, (T, 5) int32 record);
    counts the launch."""
    _check_features(features, boxes)
    boxes, valid = _kernel_boxes(boxes, valid, opts["output_size"])
    total, p = boxes.shape[0] * boxes.shape[1], opts["output_size"]
    out = torch.empty((total, p, p, features[0].shape[-1]), dtype=torch.float32,
                      device=boxes.device)
    record = torch.empty((total, len(RECORD)), dtype=torch.int32, device=boxes.device)
    if total:
        _launch(features, boxes, valid, opts, record, out)
        tracing.count("k1.launches")
        tracing.count("k1.roi_slots", total)
    return out, record


def multilevel_roi_align_cuda(features: Sequence[torch.Tensor],
                              boxes: torch.Tensor, *,
                              strides: Sequence[int], output_size: int,
                              sampling_ratio: int, aligned: bool,
                              min_level: int = 2,
                              valid: Optional[torch.Tensor] = None,
                              adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """Batched FPN ROIAlign: features (B, H_l, W_l, C) x 4 (float32 or
    bfloat16, channels-last, C a multiple of 4 or 8), boxes (B, N, 4)
    float32, valid (B, N) bool -> (B, N, P, P, C) float32.  Invalid ROIs
    give zeros and cost no reads.

    CUDA tensors launch K1 (one launch, no torch prologue); CPU tensors
    take the plain version.
    """
    kw = dict(strides=strides, output_size=output_size, sampling_ratio=sampling_ratio,
              aligned=aligned, min_level=min_level, adaptive_cap=adaptive_cap)
    if boxes.device.type == "cpu":
        return multilevel_roi_align_separable(features, boxes, valid=valid, **kw)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    bsz, n = boxes.shape[:2]
    out, _ = _forward_kernel(features, boxes, valid, kw)
    return out.reshape(bsz, n, output_size, output_size, -1)


def multilevel_roi_align_adjoint_cuda(g: torch.Tensor,
                                      feat_shapes: Sequence[Sequence[int]],
                                      boxes: torch.Tensor, record: torch.Tensor, *,
                                      strides: Sequence[int], output_size: int,
                                      sampling_ratio: int, aligned: bool,
                                      min_level: int = 2,
                                      adaptive_cap: Optional[int] = None
                                      ) -> List[torch.Tensor]:
    """K2: the gradient of K1 with respect to the features.

    g: (T, P, P, C) or (B, N, P, P, C) float32 pooled cotangent;
    feat_shapes: per level (B, H_l, W_l, C); boxes (B, N, 4) and record
    (T, 5) int32: the forward's boxes and K1's record (ny = 0 marks an
    invalid ROI, whose cotangent rows are never read); the options are the
    forward's.  Returns float32 (B, H_l, W_l, C) gradients.  CUDA tensors
    launch `csrc/roi_align_adj.cu`, which rebuilds K1's weights from the
    boxes bit for bit (float32 atomics: the sum order varies between
    runs); CPU tensors take `multilevel_roi_align_adjoint_separable` on the
    `_prepare` of the same boxes.
    """
    kw = dict(strides=strides, output_size=output_size, sampling_ratio=sampling_ratio,
              aligned=aligned, min_level=min_level, adaptive_cap=adaptive_cap)
    if g.device.type == "cpu":
        pr = _prepare(feat_shapes, boxes, valid=record[:, 3] > 0, **kw)
        return multilevel_roi_align_adjoint_separable(g, feat_shapes, pr)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if len(feat_shapes) != 4:
        raise ValueError("the kernel scatters into exactly four levels (p2..p5)")
    p, c = int(g.shape[-2]), int(g.shape[-1])
    if (g.dtype != torch.float32 or not g.is_contiguous() or g.shape[-3] != p
            or not _aligned16(g)):
        raise TypeError("g must be a contiguous, 16-byte aligned float32 (..., P, P, C) tensor")
    boxes, _ = _kernel_boxes(boxes, None, output_size)
    total = boxes.shape[0] * boxes.shape[1]
    if p != output_size or c % 4 != 0 or g.numel() != total * p * p * c:
        raise ValueError("g must be (T, P, P, C) for the boxes, with C a multiple of 4")
    if (record.dtype != torch.int32 or tuple(record.shape) != (total, len(RECORD))
            or not record.is_contiguous() or record.device != g.device
            or boxes.device != g.device):
        raise TypeError("record must be K1's contiguous int32 (T, 5) record on g's device")
    if any(int(s[-1]) != c or int(s[0]) != boxes.shape[0] for s in feat_shapes):
        raise ValueError("feat_shapes do not match g's channels or the boxes' batch")
    grads = [torch.zeros((int(s[0]), int(s[1]), int(s[2]), c), dtype=torch.float32,
                         device=g.device) for s in feat_shapes]
    if total:
        _launch_adj(g, boxes, record, kw, grads)
        tracing.count("k2.launches")
        tracing.count("k2.roi_slots", total)
    return grads


# --------------------------------------------------------------------------- #
# K3: the training pooler
# --------------------------------------------------------------------------- #

class _TrainPool(torch.autograd.Function):
    """Forward K1 (plain version on the CPU), backward K2; the counterpart
    of JAX `_train_pool` with `use_pallas=True`.  The forward saves the
    boxes, `valid` and the (T, 5) int32 record, and the backward rebuilds
    the weights from them (JAX rebuilds the whole prologue, the same math).
    Boxes get a zero cotangent and `valid` none (roi_align_pallas.py:837-843).
    """

    @staticmethod
    def forward(ctx, boxes, valid, opts, *features):
        p = opts["output_size"]
        with torch.autocast(boxes.device.type, enabled=False):
            if boxes.device.type == "cuda":
                out, record = _forward_kernel(features, boxes, valid, opts)
            else:
                pr = _prepare([f.shape for f in features], boxes, valid=valid, **opts)
                out = _separable_forward(features, pr, p)
                record = _record_of(pr)
        ctx.save_for_backward(boxes, valid, record)
        ctx.opts = opts
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.dtypes = [f.dtype for f in features]
        # invalid ROIs (ny = 0) pool to exact zeros in both versions
        return out.reshape(*boxes.shape[:2], p, p, -1)

    @staticmethod
    def backward(ctx, g):
        boxes, valid, record = ctx.saved_tensors
        g = g.to(torch.float32)
        if g.device.type == "cpu" and valid is not None:
            g = torch.where(valid[..., None, None, None], g, torch.zeros_like(g))
        # on the card K2 skips the invalid rows (ny = 0): g goes in as it is
        dfeats = multilevel_roi_align_adjoint_cuda(g.contiguous(), ctx.shapes, boxes,
                                                   record, **ctx.opts)
        return (torch.zeros_like(boxes), None, None,
                *[d.to(t) for d, t in zip(dfeats, ctx.dtypes)])


def multilevel_roi_align_train(features: Sequence[torch.Tensor],
                               boxes: torch.Tensor, *,
                               strides: Sequence[int], output_size: int,
                               sampling_ratio: int, aligned: bool,
                               impl: str, valid: Optional[torch.Tensor] = None,
                               min_level: int = 2,
                               adaptive_cap: Optional[int] = None) -> torch.Tensor:
    """Batched FPN ROIAlign for training (JAX `multilevel_roi_align_train`):
    features (B, H_l, W_l, C) x 4, boxes (B, N, 4), valid (B, N) bool ->
    (B, N, P, P, C) float32; invalid ROIs pool to zeros and send no
    gradient to the features.

    impl "cuda": `_TrainPool`, K1 forward and K2 backward (their plain
    versions for CPU tensors); the boxes get a zero gradient.  impl
    "torch": the gather formulation `ops/roi_align.py::multilevel_roi_align`
    at detectron2's levels under torch autograd, the counterpart of JAX
    `use_pallas=False`; the boxes are detached.  The model resolves its
    "auto" setting before calling (`PlaneRCNN._pooler_impl`).
    """
    kw = dict(strides=tuple(strides), output_size=int(output_size),
              sampling_ratio=int(sampling_ratio), aligned=bool(aligned),
              min_level=int(min_level), adaptive_cap=adaptive_cap)
    if impl == "cuda":
        return _TrainPool.apply(boxes, valid, kw, *features)
    if impl != "torch":
        raise ValueError(f"unknown pooler impl {impl!r}")
    boxes = boxes.detach()
    out = torch.stack([multilevel_roi_align([f[i] for f in features], boxes[i],
                                            chunk=32, **kw).to(torch.float32)
                       for i in range(boxes.shape[0])])
    if valid is not None:
        out = torch.where(valid[..., None, None, None], out, torch.zeros_like(out))
    return out
