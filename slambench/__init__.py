"""slambench: the benchmark of hierslam_torch (see README.md)."""
