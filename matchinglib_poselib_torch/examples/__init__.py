"""Library usage examples of the port (``python -m
matchinglib_poselib_torch.examples.match_and_pose <image_dir>``)."""
