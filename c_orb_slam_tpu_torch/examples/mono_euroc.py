"""Monocular EuRoC driver (reference: Examples/Monocular/mono_euroc.cc).

Usage: python3 -m c_orb_slam_tpu_torch.examples.mono_euroc <settings.yaml> <mav0_dir>
"""

from c_orb_slam_tpu_torch.config import Sensor, load_yaml
from c_orb_slam_tpu_torch.datasets import load_euroc
from c_orb_slam_tpu_torch.examples.common import run_sequence, standard_parser


def main(argv=None):
    args = standard_parser(__doc__).parse_args(argv)
    cfg = load_yaml(args.settings, Sensor.MONOCULAR)
    stamps, left, _ = load_euroc(args.sequence, stereo=False)
    return run_sequence(cfg, stamps, left, args=args)


if __name__ == "__main__":
    main()
