"""Per-layer metric readers, one file each, found by metric name."""
