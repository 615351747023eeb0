"""Build and load the CUDA kernels, stage timing, trajectory metrics and
host-side imaging helpers."""

from online_3d_reconstruction_tpu_torch.utils.imaging import bilinear_sample_np  # noqa: F401
