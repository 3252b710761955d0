"""Stereo KITTI driver (reference: Examples/Stereo/stereo_kitti.cc).

Usage: python3 -m c_orb_slam_tpu_torch.examples.stereo_kitti <settings.yaml> <sequence_dir>
"""

from c_orb_slam_tpu_torch.config import Sensor, load_yaml
from c_orb_slam_tpu_torch.datasets import load_kitti
from c_orb_slam_tpu_torch.examples.common import run_sequence, standard_parser


def main(argv=None):
    args = standard_parser(__doc__).parse_args(argv)
    cfg = load_yaml(args.settings, Sensor.STEREO)
    stamps, left, right = load_kitti(args.sequence, stereo=True)
    return run_sequence(cfg, stamps, left, right_paths=right, args=args, kitti_format=True)


if __name__ == "__main__":
    main()
