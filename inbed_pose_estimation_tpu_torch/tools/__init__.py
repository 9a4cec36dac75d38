"""Command-line tools of the port, run as `python -m inbed_pose_estimation_tpu_torch.tools.<name>`."""
