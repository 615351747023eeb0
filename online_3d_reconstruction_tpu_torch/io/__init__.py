"""Calibration, frame sources, the synthetic scene and the viewer: the
reference package's jax-free numpy modules, used as they are, beside the
port's ``io.dataset`` (``flight_log_poses``, ``ImageFolderSequence``) and
``io.export`` (``load_trajectory_tum``), whose reference versions import jax."""

from online_3d_reconstruction_tpu.io.calibration import (  # noqa: F401
    CameraIntrinsics,
    RectifiedRig,
    StereoCalibration,
    identity_rig,
    load_calibration_json,
    stereo_rectify,
)
from online_3d_reconstruction_tpu.io.synthetic import (  # noqa: F401
    Plateau,
    SyntheticScene,
    make_survey_trajectory,
    nadir_pose,
)
from online_3d_reconstruction_tpu.io.viewer import export_html  # noqa: F401
from online_3d_reconstruction_tpu_torch.io.dataset import (  # noqa: F401
    FrameData,
    ImageFolderSequence,
    SyntheticSequence,
)
