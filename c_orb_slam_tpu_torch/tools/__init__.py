"""Tools of the port (run as modules, e.g. ``python3 -m
c_orb_slam_tpu_torch.tools.eval_cli_kitti``)."""
