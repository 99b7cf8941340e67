"""Per-voxel distribution decode ops in plain torch."""
