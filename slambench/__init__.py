"""The benchmark of c_orb_slam_tpu_torch: ``python3 slambench/run.py``."""
