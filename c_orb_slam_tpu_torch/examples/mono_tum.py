"""Monocular TUM driver (reference: Examples/Monocular/mono_tum.cc).

Usage: python3 -m c_orb_slam_tpu_torch.examples.mono_tum <settings.yaml> <sequence_dir>
"""

from c_orb_slam_tpu_torch.config import Sensor, load_yaml
from c_orb_slam_tpu_torch.datasets import load_tum_rgb
from c_orb_slam_tpu_torch.examples.common import run_sequence, standard_parser


def main(argv=None):
    args = standard_parser(__doc__).parse_args(argv)
    cfg = load_yaml(args.settings, Sensor.MONOCULAR)
    stamps, paths = load_tum_rgb(args.sequence)
    return run_sequence(cfg, stamps, paths, args=args)


if __name__ == "__main__":
    main()
