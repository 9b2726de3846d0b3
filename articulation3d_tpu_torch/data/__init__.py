"""Axis codec and dataset metadata (the parts the inference CLI uses)."""
