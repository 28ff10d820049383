"""ANCSH model: pointwise layers, PointNet++ backbone, heads."""
