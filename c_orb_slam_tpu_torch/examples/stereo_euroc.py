"""Stereo EuRoC driver with online rectification (reference:
Examples/Stereo/stereo_euroc.cc: LEFT.*/RIGHT.* K, D, R, P from the YAML,
initUndistortRectifyMap + per-frame remap :72-137); the remap runs on the
driver's device.

Usage: python3 -m c_orb_slam_tpu_torch.examples.stereo_euroc <settings.yaml> <mav0_dir>
"""

import numpy as np

from c_orb_slam_tpu_torch.config import Sensor, load_yaml, load_yaml_raw
from c_orb_slam_tpu_torch.datasets import load_euroc
from c_orb_slam_tpu_torch.examples.common import pick_device, run_sequence, standard_parser
from c_orb_slam_tpu_torch.frontend.rectify import StereoRectifier


def _side(kv, prefix):
    return {
        "K": np.asarray(kv[f"{prefix}.K"]),
        "D": np.asarray(kv[f"{prefix}.D"]).ravel(),
        "R": np.asarray(kv[f"{prefix}.R"]),
        "P": np.asarray(kv[f"{prefix}.P"]),
    }


def main(argv=None):
    args = standard_parser(__doc__).parse_args(argv)
    cfg = load_yaml(args.settings, Sensor.STEREO)
    kv = load_yaml_raw(args.settings)
    size = (int(kv["LEFT.width"]), int(kv["LEFT.height"]))
    rectifier = StereoRectifier(
        _side(kv, "LEFT"), _side(kv, "RIGHT"), size, pick_device(args.device)
    )
    stamps, left, right = load_euroc(args.sequence, stereo=True)
    return run_sequence(cfg, stamps, left, right_paths=right, rectifier=rectifier, args=args)


if __name__ == "__main__":
    main()
