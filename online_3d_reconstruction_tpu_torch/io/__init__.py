"""Calibration, frame sources, the synthetic scene and the viewer (numpy, on
the host), beside ``io.dataset`` (frames, flight logs, disk folders),
``io.export`` (PLY/PCD/TUM) and ``io.native_loader`` (the C++ image reader)."""

from online_3d_reconstruction_tpu_torch.io.calibration import (  # noqa: F401
    CameraIntrinsics,
    RectifiedRig,
    StereoCalibration,
    identity_rig,
    load_calibration_json,
    stereo_rectify,
)
from online_3d_reconstruction_tpu_torch.io.synthetic import (  # noqa: F401
    Plateau,
    SyntheticScene,
    make_survey_trajectory,
    nadir_pose,
)
from online_3d_reconstruction_tpu_torch.io.viewer import export_html  # noqa: F401
from online_3d_reconstruction_tpu_torch.io.dataset import (  # noqa: F401
    FrameData,
    ImageFolderSequence,
    SyntheticSequence,
)
