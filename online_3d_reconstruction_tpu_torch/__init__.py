"""online_3d_reconstruction_tpu_torch — the PyTorch/CUDA port of
``online_3d_reconstruction_tpu`` for one NVIDIA H100.

Each subpackage mirrors the JAX package's module of the same name; the JAX
package is the reference the port is tested against. The port imports
``torch`` and never ``jax``. It reuses the JAX package's jax-free modules
(``config``, ``io.calibration``, ``io.synthetic``, ``io.dataset``'s frame
sources, ``utils.metrics``) through its own ``config``, ``io`` and
``utils.metrics``, the only modules that name the JAX package. The two
Pallas kernels of the disparity stage are hand-written CUDA kernels
(``csrc/``, bound in ``stereo.sgm_cuda``), built with nvcc at first use.
"""

__version__ = "0.1.0"

from online_3d_reconstruction_tpu_torch.runtime.pipeline import (  # noqa: F401
    OnlineReconstructor,
    ReconstructionResult,
    reconstruct,
)
