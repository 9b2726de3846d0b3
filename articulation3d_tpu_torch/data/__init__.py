"""Data layer: catalog, JSON loaders, axis codec, fixed-shape mapper."""
