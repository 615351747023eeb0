"""The pipeline's configuration: the reference package's jax-free ``config``
module, used as it is, so the port and the reference read the same
dataclasses. The port ignores two TPU knobs of ``StereoConfig``
(``use_pallas``, ``cost_dtype``; see ``stereo.sgm``)."""

from online_3d_reconstruction_tpu.config import (  # noqa: F401
    BAConfig,
    FeatureConfig,
    MappingConfig,
    MatchConfig,
    OdometryConfig,
    PipelineConfig,
    RuntimeConfig,
    StereoConfig,
    load_config,
)
