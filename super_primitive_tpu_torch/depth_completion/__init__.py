"""Segment-based depth completion and the VOID metrics (port of
super_primitive_tpu/depth_completion)."""
