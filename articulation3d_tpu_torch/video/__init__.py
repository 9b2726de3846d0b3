"""Batched video inference pipeline and frame decoding."""

from .pipeline import VideoPipeline, make_inference_step, override_plane_offsets  # noqa: F401
