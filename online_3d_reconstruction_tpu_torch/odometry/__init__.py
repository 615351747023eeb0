"""Visual odometry: rigid 3D-3D fits and the tracking front end."""
