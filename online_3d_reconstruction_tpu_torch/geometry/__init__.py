"""SE(3) utilities and disparity backprojection."""
