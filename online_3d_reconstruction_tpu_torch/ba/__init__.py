"""Window bundle adjustment: problem, dense-block Schur solver, on-device
keyframe window and the host track table."""
