"""Calibration, frame sources and the synthetic scene: the reference
package's jax-free numpy modules, used as they are. ``io.dataset``'s
``flight_log_poses`` (and so ``ImageFolderSequence``) and ``io.export``
import jax inside their bodies, so the port does not offer them."""

from online_3d_reconstruction_tpu.io.calibration import (  # noqa: F401
    CameraIntrinsics,
    RectifiedRig,
    StereoCalibration,
    identity_rig,
    stereo_rectify,
)
from online_3d_reconstruction_tpu.io.dataset import FrameData, SyntheticSequence  # noqa: F401
from online_3d_reconstruction_tpu.io.synthetic import (  # noqa: F401
    Plateau,
    SyntheticScene,
    make_survey_trajectory,
)
