"""Device ops: preprocessing, box geometry, NMS, ROIAlign, mask pasting."""
