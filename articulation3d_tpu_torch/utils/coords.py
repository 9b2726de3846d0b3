"""The stored <-> camera plane-coordinate convention.

Stored (SunCG-style) plane params (a, b, c) are camera-space (a, -c, b);
the inverse is (a, b, c) -> (a, c, -b) (counterpart of
`articulation3d_tpu/utils/coords.py`).  Works on (..., 3) numpy arrays and
torch tensors alike: the column gather makes a copy in both, which is then
negated in place.
"""

from __future__ import annotations

from .. import tracing


def _swap_yz(x):
    """(a, b, c) -> (a, c, b), a copy.  On the card the list index is
    uploaded first: one host wait."""
    with tracing.sync("coords", x):
        return x[..., [0, 2, 1]]


def plane_to_camera(plane):
    """Stored plane params -> camera space: (a, b, c) -> (a, -c, b)."""
    out = _swap_yz(plane)
    out[..., 1] = -out[..., 1]
    return out


def camera_to_plane(n):
    """Camera-space normal -> stored convention: (a, b, c) -> (a, c, -b)."""
    out = _swap_yz(n)
    out[..., 2] = -out[..., 2]
    return out
