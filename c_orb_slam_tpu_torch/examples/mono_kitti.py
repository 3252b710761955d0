"""Monocular KITTI driver (reference: Examples/Monocular/mono_kitti.cc).

Usage: python3 -m c_orb_slam_tpu_torch.examples.mono_kitti <settings.yaml> <sequence_dir>
"""

from c_orb_slam_tpu_torch.config import Sensor, load_yaml
from c_orb_slam_tpu_torch.datasets import load_kitti
from c_orb_slam_tpu_torch.examples.common import run_sequence, standard_parser


def main(argv=None):
    args = standard_parser(__doc__).parse_args(argv)
    cfg = load_yaml(args.settings, Sensor.MONOCULAR)
    stamps, left, _ = load_kitti(args.sequence, stereo=False)
    return run_sequence(cfg, stamps, left, args=args, kitti_format=True)


if __name__ == "__main__":
    main()
