"""Per-frame metrics and trajectory error: the reference package's jax-free
numpy module, used as it is."""

from online_3d_reconstruction_tpu.utils.metrics import (  # noqa: F401
    MetricsLogger,
    StageTimer,
    ate_rmse,
)
