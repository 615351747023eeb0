"""Voxel downsampling and the global map pool."""
