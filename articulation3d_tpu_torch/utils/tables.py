"""Small metric tables for log output (counterpart of
`articulation3d_tpu/utils/tables.py`): fvcore's `create_small_table`, which
the reference's evaluators print through, without the dependency."""

from __future__ import annotations

from typing import Mapping


def create_small_table(small_dict: Mapping[str, float]) -> str:
    """Two-row table: header = keys, body = values (fvcore semantics)."""
    keys = [str(k) for k in small_dict.keys()]
    vals = []
    for v in small_dict.values():
        try:
            vals.append(f"{float(v):.3f}")
        except (TypeError, ValueError):
            vals.append(str(v))
    widths = [max(len(k), len(v)) for k, v in zip(keys, vals)]
    sep = "+".join("-" * (w + 2) for w in widths)
    head = "|".join(f" {k:^{w}} " for k, w in zip(keys, widths))
    body = "|".join(f" {v:^{w}} " for v, w in zip(vals, widths))
    return f"{sep}\n{head}\n{sep}\n{body}\n{sep}"
