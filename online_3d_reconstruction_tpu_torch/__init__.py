"""online_3d_reconstruction_tpu_torch — the PyTorch/CUDA port of
``online_3d_reconstruction_tpu`` for one NVIDIA H100.

Each subpackage mirrors the JAX package's module of the same name; the JAX
package is the reference the port is tested against. The port imports
``torch`` and never ``jax``, and nothing of the JAX package: it stands
alone, with its own ``config``, ``io`` (calibration, synthetic scene, frame
sources, writers, viewer, native image loader) and ``utils.metrics``, numpy
modules under the reference's names. Every Pallas
kernel of the reference is a hand-written CUDA kernel (``csrc/``, bound in
``stereo.sgm_cuda``), built with nvcc at first use: the two of the
disparity stage and the single-direction scan pair that the profiler
(``tools.profile_stages``) runs. Window bundle adjustment (``ba/``) runs on
every keyframe, as in the reference.
"""

__version__ = "0.1.0"

from online_3d_reconstruction_tpu_torch.config import (  # noqa: F401
    PipelineConfig,
    StereoConfig,
    FeatureConfig,
    MatchConfig,
    OdometryConfig,
    BAConfig,
    MappingConfig,
    RuntimeConfig,
    load_config,
)

_PKG = "online_3d_reconstruction_tpu_torch"
# the reference's lazy top-level names, and where the port keeps them
_LAZY = {
    "reconstruct": "runtime.pipeline",
    "OnlineReconstructor": "runtime.pipeline",
    "reconstruct_distributed": "runtime.distributed",
    "sgm_disparity": "stereo.sgm",
    "detect_and_describe": "features.brief",
    "match_descriptors": "features.match",
    "odometry_step": "odometry.frontend",
    "solve_ba": "ba.schur",
    "voxel_downsample": "mapping.voxel",
    "make_mesh": "parallel.mesh",
}


def __getattr__(name):
    """Lazy top-level API: ``import online_3d_reconstruction_tpu_torch``
    alone imports the numpy configuration classes and not ``torch``."""
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{_PKG}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
