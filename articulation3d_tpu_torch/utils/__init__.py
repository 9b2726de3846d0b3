"""Host utilities: camera constants and the plane-coordinate convention."""
