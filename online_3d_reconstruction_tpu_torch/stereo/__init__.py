"""Stereo rectification, census cost, SGM disparity and its CUDA kernels."""
