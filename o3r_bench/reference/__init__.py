"""The plain reference that decides ``correct``: frozen copies of the
port's plain PyTorch and numpy versions of each stage (rectification and
calibration, census, SGM aggregation with its storage roundings, the
speckle filter, FAST/BRIEF, matching, RANSAC and Gauss-Newton tracking,
backprojection, the device window BA, voxel downsampling), with the
hand-written kernels' plain forms in their place. No module here imports
the port, the JAX package or JAX; ``frame.py`` drives them."""
