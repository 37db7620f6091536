"""Monocular visual odometry on the device (the Adam path)."""
