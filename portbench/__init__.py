"""The benchmark of matchinglib_poselib_torch (see README.md)."""
